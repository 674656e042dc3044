from .batch import batch_separate
from .mesh import make_mesh, shard_spectrogram
from .sharded import (
    auxiva_ip_step,
    auxiva_ip_step_binsmajor,
    auxiva_ip_step_carry,
    auxiva_ip_step_stacked,
    batched_auxiva_ip_step,
    make_mesh_2d,
    make_sharded_train_step,
)

__all__ = [
    "make_mesh",
    "shard_spectrogram",
    "batch_separate",
    "make_mesh_2d",
    "make_sharded_train_step",
    "auxiva_ip_step",
    "auxiva_ip_step_carry",
    "auxiva_ip_step_binsmajor",
    "auxiva_ip_step_stacked",
    "batched_auxiva_ip_step",
]
