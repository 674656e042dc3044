from .audio import inv_mu_law_compand, mu_law_compand, read_wav, write_wav
from .callbacks import BSSEvalCallback, LossLogger, SDRImprovementCallback, StateSnapshotCallback
from .convert import state_from_jax
from .flooring import floor_below, identity_ridge
from .linalg import eye_like_filter, parallel_sort, to_hermite, to_psd
from .metrics import (
    bss_eval_improvement,
    bss_eval_sources,
    pairwise_si_sdr,
    pit_si_sdr,
    si_sdr,
    si_sdr_improvement,
)
from .synthesis import convolutive_mixture, synthetic_room_impulse_responses

__all__ = [
    "to_hermite",
    "to_psd",
    "parallel_sort",
    "eye_like_filter",
    "read_wav",
    "write_wav",
    "mu_law_compand",
    "inv_mu_law_compand",
    "floor_below",
    "identity_ridge",
    "si_sdr",
    "pairwise_si_sdr",
    "pit_si_sdr",
    "si_sdr_improvement",
    "bss_eval_sources",
    "bss_eval_improvement",
    "SDRImprovementCallback",
    "BSSEvalCallback",
    "StateSnapshotCallback",
    "LossLogger",
    "convolutive_mixture",
    "synthetic_room_impulse_responses",
    "state_from_jax",
]
