from .device import resolve_device  # noqa: F401
from .solver import IterativeSolver  # noqa: F401
