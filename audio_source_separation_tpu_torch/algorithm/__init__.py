from .linalg import solve_riccati
from .minimum_distortion_principle import (
    generalized_minimum_distortion_principle,
    minimum_distortion_principle,
)
from .projection_back import projection_back

__all__ = [
    "projection_back",
    "minimum_distortion_principle",
    "generalized_minimum_distortion_principle",
    "solve_riccati",
]
