from .convert import state_from_jax  # noqa: F401
from .flooring import floor_below, identity_ridge  # noqa: F401
from .linalg import eye_like_filter, parallel_sort, to_hermite, to_psd  # noqa: F401
