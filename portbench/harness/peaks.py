"""Published peaks of the cards the benchmark knows, by the name that
``torch.cuda.get_device_name()`` gives.

NVIDIA H100 SXM (data sheet, dense, at its 700 W limit): 3.35 TB/s of
HBM3, 67 TFLOP/s float32 outside the tensor cores.  A card set below its
power limit runs slower under load; the run prints the limit it read.
"""

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bytes_per_s": 3.35e12, "flops_per_s": 67e12},
}


def peaks(device_name):
    """``{"bytes_per_s", "flops_per_s"}`` of the card, ``None`` for a card
    not in the table."""
    return PEAKS.get(device_name)


def least_seconds(n_bytes, flops, peak):
    """The least time the card could take for the work: the larger of its
    bytes over the bandwidth and its FLOPs over the float32 rate."""
    return max(n_bytes / peak["bytes_per_s"], flops / peak["flops_per_s"])
