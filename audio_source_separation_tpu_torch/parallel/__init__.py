from .batch import batch_separate
from .sharded import (
    auxiva_ip_step,
    auxiva_ip_step_binsmajor,
    auxiva_ip_step_carry,
    auxiva_ip_step_stacked,
    batched_auxiva_ip_step,
)

__all__ = [
    "batch_separate",
    "auxiva_ip_step",
    "auxiva_ip_step_carry",
    "auxiva_ip_step_binsmajor",
    "auxiva_ip_step_stacked",
    "batched_auxiva_ip_step",
]
