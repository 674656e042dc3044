from .linalg import solve_riccati  # noqa: F401
from .projection_back import apply_projection_back, projection_back  # noqa: F401
