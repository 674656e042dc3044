from .linalg import solve_riccati  # noqa: F401
from .minimum_distortion_principle import (  # noqa: F401
    generalized_minimum_distortion_principle,
    minimum_distortion_principle,
)
from .projection_back import apply_projection_back, projection_back  # noqa: F401
