"""Whether the timed path's outputs are correct: the recordings drawn from
the window, compared with the configuration's plain reference.

The reference (``portbench/reference/<config>.py``) recomputes each drawn
recording from its waveform at float64 on the run's
device.  Four numbers, each the worst over the drawn recordings:

  * ``stft_err``: the program's spectrogram, max abs gap over the
    reference's max abs value;
  * ``loss_err``: the recorded loss trajectory, max abs gap over the
    reference trajectory's max abs value;
  * ``filter_err``: the final demixing filter, Frobenius norm of the gap
    over the reference's;
  * ``wave_err``: the separated waveforms, the worst source's norm of the
    gap over the reference's.

A missing or non-finite reading is infinite.  Each number's limit is in
``portbench/limits/<workload>.json``, with the readings it was set from.
"""

import math

import numpy as np
import torch

from ..reference.common import Arith

NUMBERS = ("stft_err", "loss_err", "filter_err", "wave_err")


def _finite(value):
    return value if math.isfinite(value) else math.inf


def _host(value):
    """``value`` (a tensor, an array or a list of floats) on the host at
    float64 or complex128."""
    t = value.detach() if isinstance(value, torch.Tensor) else torch.as_tensor(np.asarray(value))
    return t.to("cpu", torch.complex128 if t.is_complex() else torch.float64)


def gaps(outputs, y, ref):
    """The four numbers of one recording: the program's (or the control's)
    ``outputs`` and separated ``y`` against the reference's ``ref``."""
    spec, ref_spec = _host(outputs["spec"]), _host(ref["spec"])
    loss, ref_loss = _host(outputs["loss"]).reshape(-1), _host(ref["loss"]).reshape(-1)
    W, ref_W = _host(outputs["demix_filter"]), _host(ref["demix_filter"])
    y, ref_y = _host(y), _host(ref["output"])
    out = {}
    out["stft_err"] = float((spec - ref_spec).abs().max() / ref_spec.abs().max()) if spec.shape == ref_spec.shape else math.inf
    if loss.shape == ref_loss.shape:
        out["loss_err"] = float((loss - ref_loss).abs().max() / ref_loss.abs().max())
    else:
        out["loss_err"] = math.inf
    out["filter_err"] = float((W - ref_W).norm() / ref_W.norm()) if W.shape == ref_W.shape else math.inf
    if y.shape == ref_y.shape:
        out["wave_err"] = float(((y - ref_y).norm(dim=-1) / ref_y.norm(dim=-1)).max())
    else:
        out["wave_err"] = math.inf
    return {k: _finite(v) for k, v in out.items()}


def worst(readings):
    """The worst of each number over recordings' readings."""
    return {k: max((r[k] for r in readings), default=math.inf) for k in NUMBERS}


def compare(samples, reference, config, device, control=False):
    """The four numbers over the drawn ``samples`` (each ``{"x", "y",
    "outputs"}``): the program's outputs against the float64
    reference; with ``control``, the reference computed as the control
    (:mod:`~portbench.reference.common`, ``"tf32"``) in the program's
    place."""
    exact = Arith("float64", device)
    lower = Arith("tf32", device) if control else None
    with _no_tf32():
        readings = []
        for s in samples:
            ref = reference.run(s["x"], config, exact)
            if control:
                ctl = reference.run(s["x"], config, lower)
                readings.append(gaps(ctl, ctl["output"], ref))
            else:
                readings.append(gaps(s["outputs"], s["y"], ref))
    return worst(readings)


class _no_tf32:
    """Full-precision float32 products inside the block (the control rounds
    to TF32 itself)."""

    def __enter__(self):
        self.saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.saved
        return False


def judge(numbers, limits):
    """``(correct, {name: {"value", "limit"}})``: each number against its
    limit; a number without a limit, or a limit without a number, fails."""
    table = {}
    correct = True
    for name in NUMBERS:
        value, limit = numbers.get(name, math.inf), limits.get(name, {}).get("limit")
        ok = limit is not None and value <= limit
        correct = correct and ok
        table[name] = {"value": value if math.isfinite(value) else None, "limit": limit}
    return correct, table
