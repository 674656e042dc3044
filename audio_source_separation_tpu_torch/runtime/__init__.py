from .device import resolve_device
from .profiling import (
    IterationTimer,
    benchmark_solver,
    measure_memory_bandwidth,
    scan_cost_analysis,
    state_payload_bytes,
    trace,
)
from .solver import IterativeSolver

__all__ = [
    "IterativeSolver",
    "trace",
    "IterationTimer",
    "benchmark_solver",
    "scan_cost_analysis",
    "state_payload_bytes",
    "measure_memory_bandwidth",
    "resolve_device",
]
