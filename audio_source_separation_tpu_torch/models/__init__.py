from .iva import AuxLaplaceIVA  # noqa: F401
