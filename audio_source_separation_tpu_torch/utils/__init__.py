from .convert import state_from_jax  # noqa: F401
from .flooring import floor_below, identity_ridge  # noqa: F401
