"""Per-bin C x C math, the padded block layout of the block-PSD models
(``blocks.py``) and the two hand-written kernels (K1 in ``cov_kernel.py``,
K2 in ``fused_ip.py``; sources in ``../csrc``)."""

from .blocks import BlockLayout
from .covariance import spatial_covariance, weighted_covariance, weighted_covariance_auto
from .eig2 import eig2x2, generalized_eig2x2_descending
from .fast_linalg import batched_det, batched_inv, batched_log_abs_det
from .ip import cond_guard, ip_update
from .ip_components import ip_sweep_from_planes, pair_products_planes, weighted_covariance_components
from .iss import iss_sweep

__all__ = [
    "spatial_covariance",
    "weighted_covariance",
    "weighted_covariance_auto",
    "ip_update",
    "cond_guard",
    "ip_sweep_from_planes",
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
