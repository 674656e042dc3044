from .projection_back import apply_projection_back, projection_back  # noqa: F401
