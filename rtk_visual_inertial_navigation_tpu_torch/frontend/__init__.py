from .triangulation import triangulate_dlt, triangulate_landmarks  # noqa: F401
from .features import FeatureTable  # noqa: F401
