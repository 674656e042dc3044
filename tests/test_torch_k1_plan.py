"""K1's launch plan (``ops/cov_kernel.py::k1_launch_plan``) and the kernel
build's source hash, on the CPU: the kernel itself runs only on a card
(``test_torch_cuda_kernels.py``)."""

import numpy as np
import pytest

from audio_source_separation_tpu_torch.ops import _build
from audio_source_separation_tpu_torch.ops.cov_kernel import (
    MAX_STAGES,
    SMEM_LIMIT,
    STATIC_SMEM,
    TARGET_BLOCKS,
    k1_launch_plan,
)


@pytest.mark.parametrize("C,N", [(1, 1), (2, 2), (3, 3), (3, 2), (4, 4), (5, 5)])
def test_k1_plan_keeps_the_frame_axis_whole_at_2049_bins(C, N):
    """At the main path's 2049 x 469 the bin groups alone fill the card:
    one split, and (C <= 3, C = 5) the whole frame axis in one stage."""
    plan = k1_launch_plan(C, N, 2049, 469)
    assert plan.splits == 1 and plan.span >= 469
    assert plan.groups * plan.splits >= TARGET_BLOCKS
    assert plan.specialised == (C <= 4 and N <= 4)
    if C != 4:
        assert (plan.stages, plan.chunk) == (1, plan.span)


@pytest.mark.parametrize(
    "C,N,F,T", [(4, 4, 65, 16_384), (3, 3, 513, 7501), (2, 2, 513, 7501), (1, 1, 33, 20_000), (5, 5, 65, 16_384)]
)
def test_k1_plan_splits_long_recordings_at_small_f(C, N, F, T):
    """Long recordings at small F split the frame axis until the grid has
    about two blocks per SM, and walk each span through a ring of stages."""
    plan = k1_launch_plan(C, N, F, T)
    assert plan.splits > 1
    assert TARGET_BLOCKS <= plan.groups * plan.splits < 2 * TARGET_BLOCKS
    assert plan.chunk <= plan.span
    assert plan.stages == (1 if plan.chunk == plan.span else MAX_STAGES)


@pytest.mark.parametrize("T", [1, 2, 7, 469, 7501, 100_000])
@pytest.mark.parametrize("C", range(1, 9))
def test_k1_plan_fits_a_hopper_block(C, T):
    """Every C up to 8 and T up to 100,000 gets a plan within a block's
    shared memory, with even chunks and spans that cover T exactly."""
    for N in sorted({1, C, 8}):
        plan = k1_launch_plan(C, N, 2049, T)
        assert plan.smem_bytes + STATIC_SMEM <= SMEM_LIMIT == 232_448
        assert plan.chunk >= 2 and plan.chunk % 2 == 0 and plan.span % 2 == 0
        assert 1 <= plan.stages <= MAX_STAGES
        assert plan.span * (plan.splits - 1) < T <= plan.span * plan.splits
        assert plan.groups == -(-2049 // plan.bins)


@pytest.mark.parametrize("C,N,F,T", [(0, 1, 9, 9), (1, 0, 9, 9), (1, 1, 0, 9), (1, 1, 9, 0), (-1, 2, 9, 9)])
def test_k1_plan_rejects_empty_sizes(C, N, F, T):
    with pytest.raises(ValueError):
        k1_launch_plan(C, N, F, T)


@pytest.mark.parametrize(
    "C,N,F,T",
    [(3, 3, 513, 7501), (4, 4, 65, 16_384), (1, 1, 33, 20_000), (5, 5, 2049, 469), (6, 9, 33, 3000),
     (2, 6, 31, 7), (3, 3, 129, 7001), (7, 9, 300, 50)],
)
def test_k1_plan_grid_covers_every_bin_and_frame_once(C, N, F, T):
    """The kernel's grid, walked as it walks it: block b takes bin group
    b // splits and span b % splits, in chunks of ``chunk`` frames."""
    plan = k1_launch_plan(C, N, F, T)
    seen = np.zeros((F, T), dtype=np.int32)
    for block in range(plan.groups * plan.splits):
        group, split = divmod(block, plan.splits)
        f0, f1 = group * plan.bins, min(F, (group + 1) * plan.bins)
        t_begin, t_end = split * plan.span, min(T, (split + 1) * plan.span)
        assert f0 < f1 and t_begin < t_end  # no block without work
        for t0 in range(t_begin, t_end, plan.chunk):
            seen[f0:f1, t0:min(t0 + plan.chunk, t_end)] += 1
    assert (seen == 1).all()


def test_library_names_hash_the_shared_headers(tmp_path, monkeypatch):
    """An edited header renames (so rebuilds) every kernel's library; an
    edited source renames only its own."""
    for path in _build.CSRC_DIR.iterdir():
        (tmp_path / path.name).write_bytes(path.read_bytes())
    headers = sorted(tmp_path.glob("*.cuh"))
    assert headers, "the kernels share a header"
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    before = {name: _build.library_path(name) for name in _build.SOURCES}
    headers[0].write_text(headers[0].read_text() + "\n// edited\n")
    after_header = {name: _build.library_path(name) for name in _build.SOURCES}
    assert all(after_header[name] != before[name] for name in _build.SOURCES)
    source = tmp_path / _build.SOURCES["weighted_covariance"]
    source.write_text(source.read_text() + "\n// edited\n")
    after_source = {name: _build.library_path(name) for name in _build.SOURCES}
    assert after_source["weighted_covariance"] != after_header["weighted_covariance"]
    assert after_source["fused_auxiva_ip"] == after_header["fused_auxiva_ip"]
