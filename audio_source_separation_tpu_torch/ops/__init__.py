"""Per-bin C x C math, the padded block layout of the block-PSD models
(``blocks.py``) and the five hand-written kernels (K1 in ``cov_kernel.py``,
K2 in ``fused_ip.py``, K3 in ``eigh_kernel.py``, K4 in ``mnmf_rows.py``, K5
in ``mnmf_mu.py``; sources in ``../csrc``)."""

from . import cov_kernel, eigh_kernel, fused_ip, mnmf_mu, mnmf_rows
from .blocks import BlockLayout
from .covariance import (
    pair_products,
    spatial_covariance,
    weighted_covariance,
    weighted_covariance_auto,
    weighted_covariance_from_pairs,
)
from .eig2 import eig2x2, generalized_eig2x2_descending
from .fast_linalg import batched_det, batched_inv, batched_log_abs_det
from .ip import cond_guard, ip_update
from .ip_components import (
    auxiva_ip_step_components,
    ip_sweep_from_planes,
    pair_products_planes,
    weighted_covariance_components,
)
from .iss import iss_sweep

# the kernels' wrappers, each counting its launches in ``launches`` (K2, K1,
# K3, K4, K5), which a graph's replay adds to; and the wrapper modules that keep
# scratch per stream, which a graph takes after its capture (``take_scratch``)
COUNTED_KERNELS = (
    fused_ip.fused_auxiva_ip_iter, cov_kernel.weighted_covariance_planes, eigh_kernel.batched_eigh,
    mnmf_rows.fastmnmf_rows, mnmf_mu.fastmnmf_mu,
)
SCRATCH_OWNERS = (fused_ip, cov_kernel, mnmf_mu)

__all__ = [
    "spatial_covariance",
    "weighted_covariance",
    "weighted_covariance_auto",
    "pair_products",
    "weighted_covariance_from_pairs",
    "ip_update",
    "cond_guard",
    "ip_sweep_from_planes",
    "auxiva_ip_step_components",
    "pair_products_planes",
    "weighted_covariance_components",
    "iss_sweep",
    "eig2x2",
    "generalized_eig2x2_descending",
    "batched_det",
    "batched_inv",
    "batched_log_abs_det",
    "BlockLayout",
]
