from .state import (  # noqa: F401
    WindowState,
    TangentLayout,
    retract_window,
    window_boxminus,
)
