"""The ``fastmnmf_c2`` configuration's files: its plain reference against
the program at float64 on the CPU, the pipeline's seeded init, the
control, the frozen work formulas, its three readers (``cov_roofline_pct``,
``mnmf_step_roofline_pct``, ``state_copy_in_ms``) on a synthetic span log
and trace, and a whole traced run on the CPU with the captured loop
emulated."""

import json
import math
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from portbench.harness import check, program_spans
from portbench.harness.manifest import Manifest
from portbench.harness.peaks import PEAKS, least_seconds
from portbench.harness.trace import Trace
from portbench.pipelines import stft_seeded_bss_istft
from portbench.reference import common, fastmnmf_c2, room
from portbench.tests._support import REPO, make_root
from portbench.tests.test_portbench_program_spans import ITERATION, SPAN_METRICS, US, Event, Span, _counts, _recording
from portbench.work import cov_step, fastmnmf_step

CONFIG = json.loads((REPO / "portbench" / "configs" / "fastmnmf_c2.json").read_text())
CELL = "fastmnmf_c2.song_60s"
H100 = PEAKS["NVIDIA H100 80GB HBM3"]
EXACT = common.Arith("float64", "cpu")


def _small(iteration):
    """The configuration at 2 x 129 x 41 (fft 256 / hop 128), ``iteration``
    iterations: the CPU's size."""
    config = json.loads(json.dumps(CONFIG))
    config["stft"] = {"fft_size": 256, "hop_size": 128, "window": "hann"}
    config["system"]["iteration"] = iteration
    return config


@pytest.fixture(scope="module")
def mixture():
    return room.recordings(1, 2, 5000, 16000, 2**31 + 7, torch.device("cpu"))[0].astype(np.float64)


@pytest.mark.parametrize("n_bins, n_frames", [(129, 41), (2049, 470), (2049, 17)])
def test_the_seeded_init_draw(n_bins, n_frames):
    mine = stft_seeded_bss_istft.draw_init(CONFIG, n_bins, n_frames)
    assert list(mine) == ["basis", "activation"]
    assert mine["basis"].shape == (2, n_bins, 10) and mine["activation"].shape == (2, 10, n_frames)
    for field in mine:
        assert mine[field].dtype == np.float64
        assert 0 <= mine[field].min() and mine[field].max() < 1
    # the same length draws the same init; another length another
    again = stft_seeded_bss_istft.draw_init(CONFIG, n_bins, n_frames)
    assert all(np.array_equal(again[field], mine[field]) for field in mine)
    other = stft_seeded_bss_istft.draw_init(CONFIG, n_bins, n_frames + 1)
    assert not np.array_equal(other["basis"], mine["basis"])


@pytest.mark.parametrize("iteration", [1, 5])
def test_reference_agrees_with_the_program_at_float64(mixture, iteration):
    config = _small(iteration)
    ref = fastmnmf_c2.run(mixture, config, EXACT)
    y, out, _ = stft_seeded_bss_istft.Pipeline(config, "cpu").separate(mixture)
    loss = torch.tensor(out["loss"], dtype=torch.float64)
    assert ref["loss"].shape == loss.shape == (iteration + 1,)
    assert out["spec"].dtype == torch.complex128 and out["demix_filter"].shape == ref["demix_filter"].shape == (129, 2, 2)
    # the DFT as a product against the program's FFT: float64 rounding
    assert (out["spec"] - ref["spec"]).abs().max() <= 1e-12 * ref["spec"].abs().max()
    # the same updates in another association (the gains' sums, the
    # adjugate against LU, |Q x|^2 over the pair products): float64
    # rounding, read 2e-16 to 1e-15 at 5 iterations and up to 3e-11 at 50
    assert (loss - ref["loss"]).abs().max() <= 1e-10 * ref["loss"].abs().max()
    assert (out["demix_filter"] - ref["demix_filter"]).norm() <= 1e-10 * ref["demix_filter"].norm()
    y = torch.as_tensor(y)
    assert ((y - ref["output"]).norm(dim=-1) / ref["output"].norm(dim=-1)).max() <= 1e-10


def test_the_control_is_the_reference_at_lower_precision(mixture):
    config = _small(5)
    ref = fastmnmf_c2.run(mixture, config, EXACT)
    ctl = fastmnmf_c2.run(mixture, config, common.Arith("tf32", "cpu"))
    assert ctl["spec"].dtype == torch.complex64 and ctl["output"].dtype == torch.float32
    numbers = check.gaps(ctl, ctl["output"], ref)
    assert 1e-6 < numbers["stft_err"] < 1e-2
    assert all(0 < v < 1 for v in numbers.values())
    correct, _ = check.judge(numbers, Manifest(REPO).limits(CELL))
    assert correct is False


def test_the_reference_takes_only_its_configuration(mixture):
    config = _small(1)
    config["system"]["kwargs"]["guard"] = "svd"
    with pytest.raises(ValueError):
        fastmnmf_c2.run(mixture, config, EXACT)


def test_the_work_formulas_at_the_song_shape():
    n_bytes, flops = cov_step.least_work(2, 2, 2049, 469)
    assert n_bytes == 2 * 2049 * 469 * 8 + 2 * 2049 * 469 * 4 + 4 * 2049 * 2 * 4 == 23_129_112
    assert flops == 28 * 2049 * 469
    assert least_seconds(n_bytes, flops, H100) == pytest.approx(6.904e-6, rel=1e-3)  # bound by the bytes
    n_bytes, flops = fastmnmf_step.least_work(2049, 470)
    assert flops == 454 * 2049 * 470 and n_bytes == 16_008_228
    assert least_seconds(n_bytes, flops, H100) == pytest.approx(6.526e-6, rel=1e-3)  # bound by the FLOPs


def test_beside_the_program_count():
    from audio_source_separation_tpu_torch.ops.cov_kernel import k1_cost

    for t in (17, 33, 189, 470, 939):
        assert cov_step.least_work(2, 2, 2049, t) == k1_cost(2, 2, 2049, t, True, 8, 4)


# the synthetic window: recordings of 470 frames at fft 4096, each with 50
# K1 events of 10 us from 500 us on and three state copies of 10 us in
# solve.init (see test_portbench_program_spans._recording for the rest)
T_FRAMES = 470
K1_NAME = "void (anonymous namespace)::covariance_kernel<2, 2, true>(float2 const*, float const*, float*)"


def _window(n=2, k1=ITERATION, k1_counted=ITERATION, copies=3, capture=False):
    spans, events = [], []
    for r in range(n):
        t0, first = 10**9 + r * 2000 * US, 100 * r + 1
        attrs = _counts(graph_replays=ITERATION - 1, graph_cache_hits=1, host_copies=4, k1_launches=k1_counted,
                        graph_captures=int(capture))
        s, e = _recording(t0, first, solve_attrs=attrs)
        s += [Span(first + 20 + c, first + 4, "solve.state_copy_in", t0 + (110 + 20 * c) * US, t0 + (120 + 20 * c) * US, None)
              for c in range(copies)]
        e += [Event(K1_NAME, t0 + (500 + 10 * i) * US, t0 + (510 + 10 * i) * US, device=True) for i in range(k1)]
        spans += s
        events += e
    trace = Trace(events, [{"index": r, "n_frames": T_FRAMES} for r in range(n)])
    config = {"system": {"iteration": ITERATION, "kwargs": {"n_basis": 10}}, "stft": {"fft_size": 4096}}
    return SimpleNamespace(trace=trace, config=config, recordings=[], peak=H100), spans


@pytest.fixture(scope="module")
def readers():
    manifest = Manifest(REPO)
    return {m: manifest.reader(m) for m in ("cov_roofline_pct", "mnmf_step_roofline_pct", "state_copy_in_ms")}


def _read(monkeypatch, readers, **kwargs):
    run, spans = _window(**kwargs)
    monkeypatch.setattr(program_spans, "logged", lambda: list(spans))
    return run, {name: reader.read(run) for name, reader in readers.items()}


def test_the_readers_on_a_synthetic_window(monkeypatch, readers):
    run, got = _read(monkeypatch, readers)
    k1 = least_seconds(*cov_step.least_work(2, 2, 2049, T_FRAMES), H100)
    step = least_seconds(*fastmnmf_step.least_work(2049, T_FRAMES), H100)
    # 50 launches of 10 us a recording
    assert got["cov_roofline_pct"] == pytest.approx(100 * k1 / 10e-6)
    # busy inside solve (100-1100 us): 100-150, 400-420, the K1 events
    # 500-1000 (the copy 750-850 inside them): 570 us a recording
    assert got["mnmf_step_roofline_pct"] == pytest.approx(100 * ITERATION * step / 570e-6)
    assert got["state_copy_in_ms"] == pytest.approx(0.030)


@pytest.mark.parametrize(
    "case, kwargs, silent",
    [
        ("a_k1_event_missing", {"k1": ITERATION - 1}, {"cov_roofline_pct"}),
        ("the_counter_differs", {"k1_counted": ITERATION - 1}, {"cov_roofline_pct"}),
        ("no_state_copies", {"copies": 0}, {"state_copy_in_ms"}),
        ("a_capture", {"capture": True}, {"cov_roofline_pct", "mnmf_step_roofline_pct", "state_copy_in_ms"}),
    ],
    ids=lambda v: v if isinstance(v, str) else "",
)
def test_nothing_to_read_where_the_guard_fails(monkeypatch, readers, case, kwargs, silent):
    _, got = _read(monkeypatch, readers, **kwargs)
    assert {name for name, value in got.items() if value is None} == silent


def test_nothing_to_read_without_the_log_or_the_peak(monkeypatch, readers):
    run, spans = _window()
    monkeypatch.setattr(program_spans, "logged", lambda: None)
    assert all(reader.read(run) is None for reader in readers.values())
    monkeypatch.setattr(program_spans, "logged", lambda: list(spans))
    run.peak = None
    assert readers["cov_roofline_pct"].read(run) is None and readers["mnmf_step_roofline_pct"].read(run) is None
    assert readers["state_copy_in_ms"].read(run) == pytest.approx(0.030)


FIXED = "fastmnmf_c2.small_fixed"


def test_a_traced_cpu_run_of_the_configuration(tmp_path):
    """Fixed 60 s recordings, the cell's (470 frames), through the whole
    harness on the CPU, the captured loop emulated: correct, with the state
    copies read and the device's shares left out.  (Clips of a few seconds
    at float32 leave the float64 trajectory by more than the songs' limits
    allow, on the CPU as on the card: ``PERF.md`` section 7.)  The window
    profiles the first recording that starts in its second half, so it
    holds one while a recording takes under its 8 s."""
    root = make_root(tmp_path)
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": FIXED, "config": "fastmnmf_c2", "traffic": "small_fixed", "chips": 1,
                              "why": "fixed 60 s songs for the CPU tests"})
    for metric in spec["per_layer"]:
        if CELL in metric.get("workloads", []):
            metric["workloads"].append(FIXED)
    (root / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    traffic = {"loop": "closed", "clients": 1, "length_s": [60, 60], "pool": 1, "warmup_s": 60, "trace_recordings": 1,
               "check_recordings": 2, "why": "fixed 60 s songs for the CPU tests"}
    (root / "portbench" / "traffic" / "small_fixed.json").write_text(json.dumps(traffic))
    limits = root / "portbench" / "limits"
    (limits / (FIXED + ".json")).write_text((limits / (CELL + ".json")).read_text())
    cmd = [sys.executable, "-m", "portbench.tests.cpu_run_graph", "--root", str(root), "--workload", FIXED,
           "--seed", "3000000022", "--seconds", "8", "--trace", "1"]
    proc = subprocess.run(cmd, cwd=root, capture_output=True, text=True, timeout=600,
                          env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert proc.returncode == 0, proc.stderr[-4000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] >= 2
    metrics = result["metrics"]
    for name in SPAN_METRICS + ["frontend_ms", "solve_ms", "state_copy_in_ms"]:
        assert math.isfinite(metrics[name]["value"]) and metrics[name]["value"] > 0, name
    # the mixture, the two windows and the losses, and the three state copies
    assert metrics["host_copies"]["value"] == 7.0
    # no device activity and no peak on the CPU: the device's metrics are left out
    for name in ("cov_roofline_pct", "mnmf_step_roofline_pct", "device_idle_pct", "solve_idle_ms"):
        assert name not in metrics, name
