from . import lie  # noqa: F401
