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
]
