from .divergence import (
    beta_divergence,
    generalized_kl_divergence,
    is_divergence,
    kl_divergence,
    logdet_divergence,
    multichannel_is_divergence,
)

__all__ = [
    "kl_divergence",
    "is_divergence",
    "generalized_kl_divergence",
    "beta_divergence",
    "multichannel_is_divergence",
    "logdet_divergence",
]
