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
``RegularizedILRMA`` stubs -- and the single-channel factorisation models
(``models/nmf.py``, ``models/ntf.py``): ``EUCNMF``, ``KLNMF``, ``ISNMF``,
``TNMF`` (alias ``tNMF``), ``CauchyNMF``, ``ComplexEUCNMF``, the
covariance-domain ``CovarianceISNMF`` and ``EUCNTF``, with the divergences
(``criterion``) and ``solve_riccati`` -- and slice 5 with IDLMA:
``GradLaplaceFDICA`` and ``NaturalGradLaplaceFDICA`` with the permutation
alignment (``algorithm/permutation.py``, C through ``runtime/native.py``),
the beamformers (``DelaySumBeamformer``, ``MVDRBeamformer``,
``MaxSNRBeamformer`` and their functions), ``PDSBSSBase``,
``ProxLaplaceIVA`` and the ``SparseProxIVA`` stub, ``GaussIDLMA`` with its
variance network in the loop on the device (``torch_dnn``), ``whitening``,
``minimum_distortion_principle``, ``FixedPointICA`` and the
``utils/linalg.py`` helpers -- and the MNMF family (``models/mnmf.py``):
``MultichannelISNMF`` (the Sawada and Ozerov solvers), ``FastMultichannelISNMF``
with its diagonaliser covariances through K1 per bin, and the
``MultichanneltNMF`` stub -- and the block-PSD models (``models/ipsdta.py``,
``models/psdtf.py``): ``GaussIPSDTA`` (Kondo's MM and VCD, with the VCD
covariances through K1 per bin; Ikeshita's EM and fixed point), ``TIPSDTA``
(alias ``tIPSDTA``) and ``LDPSDTF``, on the padded block layout
``ops.BlockLayout`` -- and the harness (``utils``: SI-SDR, PIT and BSS
Eval at float64 on the input's device, the callbacks, the mixture
synthesis, WAV I/O) with the example scripts (``examples``, run with
``python -m audio_source_separation_tpu_torch.examples.<name>``), and
``parallel``: ``batch_separate`` and the AuxIVA-IP steps of
``parallel.sharded`` -- and the mesh on ``torch.distributed``, one rank per
device (``IterativeSolver.use_mesh`` for the IVA, ILRMA and IPSDTA
families, ``parallel.make_mesh``, ``make_mesh_2d``,
``make_sharded_train_step``, ``batch_separate(mesh=...)``) and the
profiling tools of ``runtime`` (``benchmark_solver``, ``trace``, ...).

Entry points run on the CUDA card unless the caller passes
``device="cpu"``; without a card they raise rather than fall back.

Layouts match the JAX package: ``input (n_channels, n_bins, n_frames)``
complex, demixing filters ``(n_bins, n_sources, n_channels)``, output
``(n_sources, n_bins, n_frames)``.
"""

__version__ = "0.1.0"

from .algorithm import minimum_distortion_principle, projection_back, solve_riccati  # noqa: F401
from .algorithm.projection_back import apply_projection_back  # noqa: F401
from .models import (  # noqa: F401
    EUCNMF,
    EUCNTF,
    ISNMF,
    KLNMF,
    TILRMA,
    TIPSDTA,
    TNMF,
    AuxGaussIVA,
    AuxLaplaceIVA,
    CauchyNMF,
    ComplexEUCNMF,
    ConsistentGaussILRMA,
    CovarianceISNMF,
    DelaySumBeamformer,
    FastMultichannelISNMF,
    GaussIDLMA,
    GaussILRMA,
    GaussIPSDTA,
    GGDILRMA,
    GradLaplaceFDICA,
    GradLaplaceIVA,
    KLILRMA,
    LDPSDTF,
    MaxSNRBeamformer,
    MultichannelISNMF,
    MultichanneltNMF,
    MVDRBeamformer,
    NaturalGradLaplaceFDICA,
    NaturalGradLaplaceIVA,
    OverAuxLaplaceIVA,
    PDSBSSBase,
    ProxLaplaceIVA,
    RegularizedILRMA,
    SparseAuxIVA,
    SparseProxIVA,
    delay_sum_beamform,
    max_snr_beamform,
    ml_beamform,
    mvdr_beamform,
    tILRMA,
    tIPSDTA,
    tNMF,
    torch_dnn,
)
from . import parallel, utils  # noqa: F401
from .runtime import resolve_device  # noqa: F401
from .transform import build_optimal_window, build_window, istft, pca, stft, whitening  # noqa: F401
from .utils import state_from_jax  # noqa: F401
