"""Where the time goes inside one launch of kernel K2, and what its resident
slab buys, on the card.

    python -m audio_source_separation_tpu_torch.tools.k2_timeline [F T ...]

For each ``(F, T)`` (default 2049 469, the main path's shape) K2 runs in
the layout of :func:`k2_launch_plan` and, where that keeps the slab
resident, also with the frame axis streamed in groups of 8 bins (the
layout the plan takes past T = 6943), on the same seeded inputs.  Each
layout prints one JSON line:

- ``ms``: device time per launch (``tools.timing.median_ms``) with X left
  in L2 by the launch before, as in the solver loop, whose launches re-read
  the same X; ``ms_after_flush``: the same after a 128 MB write;
- ``timeline_us``: from a build of ``csrc/fused_auxiva_ip.cu`` with
  ``-DK2_TIMELINE``, the median over 20 launches of each phase boundary in
  microseconds after the first block started.  Boundaries are medians over
  the blocks (of a block's last group), ``*_by`` the latest block's, and
  ``end`` the last block's.  The stamps cost a few stores, so ``end`` runs
  a little above ``ms``;
- ``bound_ms``: X read once from device memory.

A last line gives ``empty_kernel_ms``, a one-cycle kernel timed as ``ms``
is: the launch's own share.  Needs a CUDA card and ``nvcc``.
"""

import ctypes
import json
import subprocess
import sys

import numpy as np
import torch

from ..ops import _build
from ..ops.fused_ip import CONTRASTS, STREAMED_BINS, _entry, _plan, _scratch_for, k2_launch_plan
from ..utils.flooring import EPS, THRESHOLD
from .timing import l2_flusher, median_ms

N_STAMPS = 16  # per block (kStamps)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM (NVIDIA data sheet)


def build_timeline():
    """The K2 library built with -DK2_TIMELINE, its entry bound as K2's."""
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = _build.BUILD_DIR / "libfused_auxiva_ip-timeline.so"
    source = _build.CSRC_DIR / _build.SOURCES["fused_auxiva_ip"]
    subprocess.run(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, "-DK2_TIMELINE", "-o", str(path), str(source)],
        check=True,
    )
    lib = ctypes.CDLL(str(path))
    lib.fused_auxiva_ip_f32.argtypes = _entry().argtypes
    lib.fused_auxiva_ip_f32.restype = ctypes.c_int
    lib.k2_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
    return lib


def operands(F, T, seed=1):
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    X = torch.complex(randn(2, F, T), randn(2, F, T))
    eye = torch.eye(2, dtype=torch.complex64, device="cuda")[:, :, None]
    W = (eye + 0.3 * torch.complex(randn(2, 2, F), randn(2, 2, F))).contiguous()
    Y = torch.einsum("ncf,cft->nft", W, X)
    psum = torch.sum(torch.abs(Y) ** 2, dim=1).contiguous()
    return X, W, psum


def launcher(entry, X, W, psum, plan):
    """One launch of K2's C entry ``entry`` in the layout ``plan``."""
    _, F, T = X.shape
    stream = torch.cuda.current_stream().cuda_stream
    part, tickets = _scratch_for(X.device, stream, plan)
    W_new, psum_new = torch.empty_like(W), torch.empty_like(psum)
    stats = torch.empty(2, device=X.device)

    def launch():
        status = entry(
            X.data_ptr(), W.data_ptr(), psum.data_ptr(), W_new.data_ptr(), psum_new.data_ptr(),
            stats.data_ptr(), part.data_ptr(), tickets.data_ptr(), F, T, F, plan.bins,
            int(plan.resident), plan.smem_bytes, CONTRASTS.index("laplace"), EPS, THRESHOLD, stream,
        )
        _build.check(status, "k2_timeline")

    return launch


def timeline(lib, launch, blocks, launches=20):
    for _ in range(5):
        launch()
    torch.cuda.synchronize()
    stamps = np.zeros(blocks * N_STAMPS, dtype=np.uint64)
    _build.check(lib.k2_stamps(stamps.ctypes.data, stamps.size), "k2_stamps")  # clears them
    runs = []
    for _ in range(launches):
        launch()
        torch.cuda.synchronize()
        _build.check(lib.k2_stamps(stamps.ctypes.data, stamps.size), "k2_stamps")
        raw = stamps.reshape(blocks, N_STAMPS).astype(np.int64)
        raw = raw[raw[:, 0] > 0]  # the blocks of the grid
        s = (raw - raw[:, 0].min()) / 1e3  # us after the first block started
        runs.append({
            "blocks_started_by": s[:, 0].max(),
            "data_landed": float(np.median(s[:, 3])),
            "covariance_done": float(np.median(s[:, 4])),
            "ip_done": float(np.median(s[:, 5])),
            "rows_written_by": s[:, 6].max(),
            "barrier_passed": float(np.median(s[:, 7])),
            "columns_summed_by": s[:, 8].max(),  # then the NLL ticket and sum
            "end": s[raw[:, 9] > 0, 9].max(),
        })
    return {key: float(np.median([r[key] for r in runs])) for key in runs[0]}


def main(argv):
    if not torch.cuda.is_available():
        print("k2_timeline: CUDA is not available", file=sys.stderr)
        return 1
    shapes = [(int(f), int(t)) for f, t in zip(argv[::2], argv[1::2])] or [(2049, 469)]
    lib = build_timeline()
    flush = l2_flusher()
    for F, T in shapes:
        X, W, psum = operands(F, T)
        plan = k2_launch_plan(F, T)
        plans = [plan] + ([_plan(F, T, STREAMED_BINS, False)] if plan.resident else [])
        for layout in plans:
            launch = launcher(_entry(), X, W, psum, layout)
            print(json.dumps({
                "shape": [2, F, T], "plan": layout._asdict(), "default": layout == plan,
                "ms": median_ms(launch),
                "ms_after_flush": median_ms(launch, before=flush),
                "timeline_us": timeline(lib, launcher(lib.fused_auxiva_ip_f32, X, W, psum, layout),
                                        min(layout.groups, 4096)),
                "bound_ms": X.numel() * 8 / HBM_BYTES_PER_S * 1e3,
            }), flush=True)
        del X, W, psum
    print(json.dumps({"empty_kernel_ms": median_ms(lambda: torch.cuda._sleep(1))}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
