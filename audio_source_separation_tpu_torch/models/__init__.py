from .ilrma import (  # noqa: F401
    TILRMA,
    ConsistentGaussILRMA,
    GaussILRMA,
    GGDILRMA,
    KLILRMA,
    RegularizedILRMA,
    tILRMA,
)
from .iva import (  # noqa: F401
    AuxGaussIVA,
    AuxLaplaceIVA,
    GradLaplaceIVA,
    NaturalGradLaplaceIVA,
    OverAuxLaplaceIVA,
    SparseAuxIVA,
)

__all__ = [
    "GradLaplaceIVA",
    "NaturalGradLaplaceIVA",
    "AuxLaplaceIVA",
    "AuxGaussIVA",
    "SparseAuxIVA",
    "OverAuxLaplaceIVA",
    "GaussILRMA",
    "TILRMA",
    "tILRMA",
    "ConsistentGaussILRMA",
    "GGDILRMA",
    "KLILRMA",
    "RegularizedILRMA",
]
