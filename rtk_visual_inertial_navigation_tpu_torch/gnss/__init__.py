from .preprocess import (  # noqa: F401
    GnssEpoch,
    GnssPreprocessor,
    PhaseBiasTable,
)
