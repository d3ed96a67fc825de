from .cameras import (CataCamera, EquidistantCamera,  # noqa: F401
                      PinholeCamera, PinholeFullCamera, ScaramuzzaCamera,
                      load_camera_yaml, make_camera)
