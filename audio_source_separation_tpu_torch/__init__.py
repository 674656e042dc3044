"""audio_source_separation_tpu_torch -- the PyTorch/CUDA port.

A port of ``audio_source_separation_tpu`` (the JAX package, kept beside it
as the reference) to PyTorch, with every Pallas kernel rewritten as a CUDA
kernel for Hopper (``csrc/``).  This package imports neither JAX nor the
JAX package.

Ported so far: the main path -- ``stft`` ->
``AuxLaplaceIVA(algorithm_spatial="IP")`` -> projection-back -> ``istft``
-- and the rest of the IVA family (``models/iva.py``): ``AuxLaplaceIVA`` and
``AuxGaussIVA`` with IP, ISS and IP2, ``GradLaplaceIVA``,
``NaturalGradLaplaceIVA``, ``OverAuxLaplaceIVA`` (with ``transform.pca``)
and the ``SparseAuxIVA`` stub -- and the ILRMA family (``models/ilrma.py``):
``GaussILRMA`` (IP, ISS, IP2, partitioning, ``power`` and
``projection-back`` normalisation), ``TILRMA`` (alias ``tILRMA``),
``ConsistentGaussILRMA`` and the ``GGDILRMA``, ``KLILRMA`` and
``RegularizedILRMA`` stubs.

Entry points run on the CUDA card unless the caller passes
``device="cpu"``; without a card they raise rather than fall back.

Layouts match the JAX package: ``input (n_channels, n_bins, n_frames)``
complex, demixing filters ``(n_bins, n_sources, n_channels)``, output
``(n_sources, n_bins, n_frames)``.
"""

__version__ = "0.1.0"

from .algorithm import apply_projection_back, projection_back  # noqa: F401
from .models import (  # noqa: F401
    TILRMA,
    AuxGaussIVA,
    AuxLaplaceIVA,
    ConsistentGaussILRMA,
    GaussILRMA,
    GGDILRMA,
    GradLaplaceIVA,
    KLILRMA,
    NaturalGradLaplaceIVA,
    OverAuxLaplaceIVA,
    RegularizedILRMA,
    SparseAuxIVA,
    tILRMA,
)
from .runtime import resolve_device  # noqa: F401
from .transform import build_optimal_window, build_window, istft, pca, stft  # noqa: F401
from .utils import state_from_jax  # noqa: F401
