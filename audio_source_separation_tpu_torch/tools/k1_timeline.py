"""Where the time goes inside one launch of kernel K1, on the card.

    python -m audio_source_separation_tpu_torch.tools.k1_timeline [C N F T ...] [--chunk K --stages S]

For each ``(C, N, F, T)`` (default 3 3 2049 469, the C = 3 main path's
covariance) K1 runs on seeded inputs in the layout of
:func:`k1_launch_plan`, or with its chunk and stages replaced by
``--chunk`` and ``--stages`` (bins and splits as planned).  Each shape
prints one JSON line:

- ``ms``: device time per launch (``tools.timing.median_ms``), X left in
  L2 by the launch before; ``ms_after_flush``: the same after a 128 MB
  write;
- ``timeline_us``: from a build of ``csrc/weighted_covariance.cu`` with
  ``-DK1_TIMELINE``, the median over 20 launches of each phase boundary in
  microseconds after the first block started, as stamped by thread 0 of
  each block (warp 0, which takes bin 0 or the block's first unit):
  ``init`` barriers set up; ``issued`` its first chunks' copies taken;
  ``landed`` its first chunk waited for; ``contracted`` its last chunk
  done; ``reduced`` the block's sums in shared memory; ``end`` written out
  (the block that finishes a split group).  Boundaries are medians over the
  blocks, ``*_by`` the latest block's.  The stamps cost a few stores;
- ``bound_ms``: X and the weights read once, the output written once.

A last line gives ``empty_kernel_ms``, a one-cycle kernel timed as ``ms``
is: the launch's own share.  Needs a CUDA card and ``nvcc``.
"""

import argparse
import ctypes
import json
import subprocess
import sys

import numpy as np
import torch

from ..ops import _build
from ..ops.cov_kernel import _entry, _scratch_for, _stage_bytes, k1_launch_plan
from .timing import l2_flusher, median_ms

N_STAMPS = 8  # per block (kStamps)
STAMP_BLOCKS = 4096  # kStampBlocks
HBM_BYTES_PER_S = 3.35e12  # H100 SXM (NVIDIA data sheet)


def build_timeline():
    """The K1 library built with -DK1_TIMELINE, its entry bound as K1's."""
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = _build.BUILD_DIR / "libweighted_covariance-timeline.so"
    source = _build.CSRC_DIR / _build.SOURCES["weighted_covariance"]
    subprocess.run(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, "-DK1_TIMELINE", "-o", str(path), str(source)],
        check=True,
    )
    lib = ctypes.CDLL(str(path))
    lib.weighted_covariance_f32.argtypes = _entry().argtypes
    lib.weighted_covariance_f32.restype = ctypes.c_int
    lib.k1_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
    return lib


def launcher(entry, X, w, plan):
    """One launch of K1's C entry ``entry`` in the layout ``plan``."""
    C, F, T = X.shape
    N = w.shape[0]
    out = torch.empty((C * C, F, N), device=X.device)
    stream = torch.cuda.current_stream().cuda_stream
    part = tickets = None
    if plan.splits > 1:
        part, tickets = _scratch_for(X.device, stream, plan, C * C * plan.bins * N)

    def launch():
        status = entry(
            X.data_ptr(), w.data_ptr(), out.data_ptr(),
            None if part is None else part.data_ptr(), None if tickets is None else tickets.data_ptr(),
            C, N, F, T, plan.bins, plan.chunk, plan.stages, plan.splits, plan.span, plan.smem_bytes,
            int(plan.specialised), stream,
        )
        _build.check(status, "k1_timeline")

    return launch


def timeline(lib, launch, blocks, launches=20):
    for _ in range(5):
        launch()
    torch.cuda.synchronize()
    stamps = np.zeros(blocks * N_STAMPS, dtype=np.uint64)
    _build.check(lib.k1_stamps(stamps.ctypes.data, stamps.size), "k1_stamps")  # clears them
    names = ["init", "issued", "landed", "contracted", "reduced"]
    runs = []
    for _ in range(launches):
        launch()
        torch.cuda.synchronize()
        _build.check(lib.k1_stamps(stamps.ctypes.data, stamps.size), "k1_stamps")
        raw = stamps.reshape(blocks, N_STAMPS).astype(np.int64)
        raw = raw[raw[:, 0] > 0]  # the blocks of the grid
        s = (raw - raw[:, 0].min()) / 1e3  # us after the first block started
        run = {"blocks_started_by": s[:, 0].max()}
        for k, name in enumerate(names, start=1):
            run[name] = float(np.median(s[:, k]))
            run[name + "_by"] = float(s[:, k].max())
        run["end"] = float(s[raw[:, 6] > 0, 6].max())
        runs.append(run)
    return {key: float(np.median([r[key] for r in runs])) for key in runs[0]}


def main(argv):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("shape", nargs="*", type=int, help="C N F T, repeated")
    parser.add_argument("--chunk", type=int, help="frames per chunk instead of the plan's")
    parser.add_argument("--stages", type=int, help="stages instead of the plan's")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("k1_timeline: CUDA is not available", file=sys.stderr)
        return 1
    values = args.shape or [3, 3, 2049, 469]
    if len(values) % 4:
        parser.error("shapes come as C N F T")
    lib = build_timeline()
    flush = l2_flusher()
    gen = torch.Generator(device="cuda").manual_seed(1)
    for C, N, F, T in zip(*[iter(values)] * 4):
        X = torch.complex(torch.randn((C, F, T), generator=gen, device="cuda"),
                          torch.randn((C, F, T), generator=gen, device="cuda"))
        w = torch.rand((N, T), generator=gen, device="cuda") + 0.1
        plan = k1_launch_plan(C, N, F, T)
        if args.chunk or args.stages:
            chunk, stages = args.chunk or plan.chunk, args.stages or plan.stages
            sums = plan.smem_bytes - plan.stages * _stage_bytes(C, N, plan.bins, plan.chunk)
            plan = plan._replace(chunk=chunk, stages=stages,
                                 smem_bytes=stages * _stage_bytes(C, N, plan.bins, chunk) + sums)
        launch = launcher(_entry(), X, w, plan)
        print(json.dumps({
            "shape": [C, N, F, T], "plan": plan._asdict(),
            "ms": median_ms(launch),
            "ms_after_flush": median_ms(launch, before=flush),
            "timeline_us": timeline(lib, launcher(lib.weighted_covariance_f32, X, w, plan),
                                    min(plan.groups * plan.splits, STAMP_BLOCKS)),
            "bound_ms": (X.numel() * 8 + w.numel() * 4 + C * C * F * N * 4) / HBM_BYTES_PER_S * 1e3,
        }), flush=True)
        del X, w
    print(json.dumps({"empty_kernel_ms": median_ms(lambda: torch.cuda._sleep(1))}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
