"""The ``mnmf_sawada_c3`` configuration's files: the pipeline's seeded draw
and latent mapping against the solver's own host init, its plain reference
against the program at float64 on the CPU, the control, the frozen work
formulas, its three readers (``k3_launches``, ``k3_roofline_pct``,
``sawada_step_roofline_pct``) on a synthetic span log and trace, and a
whole traced run on the CPU with the captured loop emulated."""

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
from portbench.pipelines import stft_sawada_seeded_bss_istft
from portbench.reference import common, mnmf_sawada_c3, room
from portbench.tests._support import REPO, make_root
from portbench.tests.test_portbench_program_spans import ITERATION, SPAN_METRICS, US, Event, _counts, _recording
from portbench.work import eigh_step, sawada_step

CONFIG = json.loads((REPO / "portbench" / "configs" / "mnmf_sawada_c3.json").read_text())
CELL = "mnmf_sawada_c3.song_60s_trace2"
H100 = PEAKS["NVIDIA H100 80GB HBM3"]
EXACT = common.Arith("float64", "cpu")


def _small(iteration, fft_size=128):
    """The configuration at fft ``fft_size`` / hop half of it, ``iteration``
    iterations: the CPU's size."""
    config = json.loads(json.dumps(CONFIG))
    config["stft"] = {"fft_size": fft_size, "hop_size": fft_size // 2, "window": "hann"}
    config["system"]["iteration"] = iteration
    return config


@pytest.fixture(scope="module")
def mixture():
    """3 x 65 x 40 at fft 128 / hop 64."""
    return room.recordings(1, 3, 2450, 16000, 2**31 + 7, torch.device("cpu"))[0].astype(np.float64)


@pytest.mark.parametrize("n_bins, n_frames", [(65, 40), (2049, 470), (2049, 17)])
def test_the_seeded_init_draw(n_bins, n_frames):
    mine = stft_sawada_seeded_bss_istft.draw_init(CONFIG, n_bins, n_frames)
    assert list(mine) == ["latent", "basis", "activation"]
    assert mine["latent"].shape == (3, 10) and mine["basis"].shape == (n_bins, 10)
    assert mine["activation"].shape == (10, n_frames)
    for field in mine:
        assert mine[field].dtype == np.float64
    assert 0 <= mine["basis"].min() and mine["activation"].max() < 1
    # the latent on the simplex over the sources, near 1 / S
    np.testing.assert_allclose(mine["latent"].sum(axis=0), 1.0, rtol=1e-15)
    assert np.abs(mine["latent"] - 1 / 3).max() < 1e-2
    # the same length draws the same init; another length another
    again = stft_sawada_seeded_bss_istft.draw_init(CONFIG, n_bins, n_frames)
    assert all(np.array_equal(again[field], mine[field]) for field in mine)
    other = stft_sawada_seeded_bss_istft.draw_init(CONFIG, n_bins, n_frames + 1)
    assert not np.array_equal(other["latent"], mine["latent"])


def test_the_draw_is_the_solvers_own_init_form():
    """The solver's host init (``prepare_state_kwargs``) draws latent,
    basis and activation uniform in this order from NumPy's global state
    and maps the latent: the pipeline's map of the same uniform draws gives
    the same arrays."""
    import audio_source_separation_tpu_torch as port

    S, F, K, T = 3, 65, 10, 40
    np.random.seed(2024)
    u, basis, activation = np.random.rand(S, K), np.random.rand(F, K), np.random.rand(K, T)
    solver = port.MultichannelISNMF(n_basis=K, author="Sawada", device="cpu")
    np.random.seed(2024)
    theirs = solver.prepare_state_kwargs(torch.zeros((3, F, T), dtype=torch.complex128), {})
    assert np.array_equal(theirs["latent"], stft_sawada_seeded_bss_istft.latent_from_uniform(u, solver.eps))
    assert np.array_equal(theirs["basis"], basis) and np.array_equal(theirs["activation"], activation)


@pytest.mark.parametrize("iteration", [1, 5])
def test_reference_agrees_with_the_program_at_float64(mixture, iteration):
    config = _small(iteration)
    ref = mnmf_sawada_c3.run(mixture, config, EXACT)
    y, out, _ = stft_sawada_seeded_bss_istft.Pipeline(config, "cpu").separate(mixture)
    loss = torch.tensor(out["loss"], dtype=torch.float64)
    assert ref["loss"].shape == loss.shape == (iteration + 1,)
    assert out["spec"].dtype == torch.complex128 and out["spec"].shape == (3, 65, 40)
    assert out["demix_filter"].shape == ref["demix_filter"].shape == (65, 3, 3, 3)
    # the DFT as a product against the program's FFT: float64 rounding
    assert (out["spec"] - ref["spec"]).abs().max() <= 1e-12 * ref["spec"].abs().max()
    # the updates in another association (cofactors of full matrices
    # against adjugates of compact planes, broadcast sums against the
    # planes' products): read 2e-15
    assert (out["demix_filter"] - ref["demix_filter"]).norm() <= 1e-9 * ref["demix_filter"].norm()
    y = torch.as_tensor(y)
    assert ((y - ref["output"]).norm(dim=-1) / ref["output"].norm(dim=-1)).max() <= 1e-9
    # the losses, each a sum over every (bin, frame) in another order: read
    # 9e-17 of the first
    assert (loss - ref["loss"]).abs().max() <= 1e-9 * ref["loss"][0].abs()


def test_the_control_is_the_reference_at_lower_precision(mixture):
    config = _small(5)
    ref = mnmf_sawada_c3.run(mixture, config, EXACT)
    ctl = mnmf_sawada_c3.run(mixture, config, common.Arith("tf32", "cpu"))
    assert ctl["spec"].dtype == torch.complex64 and ctl["output"].dtype == torch.float32
    numbers = check.gaps(ctl, ctl["output"], ref)
    assert 1e-6 < numbers["stft_err"] < 1e-2
    assert all(0 < v < 1 for v in numbers.values())
    correct, table = check.judge(numbers, Manifest(REPO).limits(CELL))
    assert correct is False
    # the filter or the waveform tells the control apart, not the loss alone
    assert table["filter_err"]["value"] > table["filter_err"]["limit"] or table["wave_err"]["value"] > table["wave_err"]["limit"]


def test_the_reference_takes_only_its_configuration(mixture):
    for key, value in (("author", "Ozerov"), ("normalize", False)):
        config = _small(1)
        config["system"]["kwargs"][key] = value
        with pytest.raises(ValueError):
            mnmf_sawada_c3.run(mixture, config, EXACT)
    config = _small(1)
    config["n_mics"] = 2
    with pytest.raises(ValueError):
        mnmf_sawada_c3.run(mixture[:2], config, EXACT)


def test_the_reference_loads_no_program_module():
    code = (
        "import sys, json, numpy as np\n"
        "from portbench.reference import common, mnmf_sawada_c3\n"
        "config = json.load(open('portbench/configs/mnmf_sawada_c3.json'))\n"
        "config['stft'] = {'fft_size': 64, 'hop_size': 32, 'window': 'hann'}\n"
        "config['system']['iteration'] = 1\n"
        "x = np.random.default_rng(0).standard_normal((3, 640))\n"
        "mnmf_sawada_c3.run(x, config, common.Arith('float64', 'cpu'))\n"
        "print(sorted(m for m in sys.modules if m.startswith(('audio_source_separation', 'jax'))))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().splitlines()[-1] == "[]"


def test_the_work_formulas_at_the_song_shape():
    n_bytes, flops = sawada_step.least_work(2049, 470)
    state = 2049 * 9 * 3 * 8 + 2049 * 10 * 4 + 10 * 470 * 4 + 3 * 10 * 4
    assert n_bytes == 3 * 2049 * 470 * 8 + 2 * state + 4 == 24_199_652
    assert flops == 2073 * 2049 * 470
    assert least_seconds(n_bytes, flops, H100) == pytest.approx(2.9796e-5, rel=1e-4)  # bound by the FLOPs
    n_bytes, flops = eigh_step.least_work(3, 2049 * 3)
    assert n_bytes == 6147 * (2 * 9 * 8 + 3 * 4) == 958_932
    assert flops == 9 * 27 * 4 * 6147
    assert least_seconds(n_bytes, flops, H100) == pytest.approx(2.8625e-7, rel=1e-4)  # bound by the bytes


@pytest.mark.parametrize("n, batch, itemsize", [(3, 6147, 8), (3, 4098, 16), (9, 240_128, 8), (64, 469, 4)])
def test_beside_the_program_count(n, batch, itemsize):
    from audio_source_separation_tpu_torch.ops.eigh_kernel import eigh_cost

    complex_ = itemsize != 4
    assert eigh_step.least_work(n, batch, itemsize, complex_) == eigh_cost(n, batch, complex_, True, itemsize)


# the synthetic window: recordings of 470 frames at fft 4096, each with 150
# K3 events of 2 us back to back from 500 us on (see test_portbench_program_spans._recording
# for the rest)
T_FRAMES = 470
K3_LAUNCHES = 3 * ITERATION
K3_NAME = "void eigh_kernel<(anonymous namespace)::Complex64, true>(float const*, float*, float*, int*, double*, long long, int, int, int, int)"


def _window(n=2, k3=K3_LAUNCHES, k3_counted=K3_LAUNCHES, capture=False):
    spans, events = [], []
    for r in range(n):
        t0, first = 10**9 + r * 2000 * US, 100 * r + 1
        attrs = _counts(graph_replays=ITERATION - 1, graph_cache_hits=1, host_copies=4, graph_captures=int(capture))
        if k3_counted is not None:
            attrs["k3_launches"] = k3_counted
        else:
            attrs.pop("k3_launches")
        s, e = _recording(t0, first, solve_attrs=attrs)
        if k3_counted is None:
            for span in s:
                if span is not None and span.attrs:
                    span.attrs.pop("k3_launches", None)
        e += [Event(K3_NAME, t0 + (500 + 2 * i) * US, t0 + (502 + 2 * i) * US, device=True) for i in range(k3)]
        spans += [span for span in s if span is not None]
        events += e
    trace = Trace(events, [{"index": r, "n_frames": T_FRAMES} for r in range(n)])
    config = {"system": {"iteration": ITERATION, "kwargs": {"n_basis": 10}}, "stft": {"fft_size": 4096},
              "n_mics": 3, "n_sources": 3}
    return SimpleNamespace(trace=trace, config=config, recordings=[], peak=H100), spans


READERS = ("k3_launches", "k3_roofline_pct", "sawada_step_roofline_pct")


@pytest.fixture(scope="module")
def readers():
    manifest = Manifest(REPO)
    return {m: manifest.reader(m) for m in READERS}


def _read(monkeypatch, readers, **kwargs):
    run, spans = _window(**kwargs)
    monkeypatch.setattr(program_spans, "logged", lambda: list(spans))
    return run, {name: reader.read(run) for name, reader in readers.items()}


def test_the_readers_on_a_synthetic_window(monkeypatch, readers):
    _, got = _read(monkeypatch, readers)
    assert got["k3_launches"] == float(K3_LAUNCHES)
    k3 = least_seconds(*eigh_step.least_work(3, 2049 * 3), H100)
    # 150 launches of 2 us a recording
    assert got["k3_roofline_pct"] == pytest.approx(100 * k3 / 2e-6)
    # busy inside solve (100-1100 us): 100-150, 400-420, the K3 events
    # 500-800 and the copy 750-850: 420 us a recording
    step = least_seconds(*sawada_step.least_work(2049, T_FRAMES), H100)
    assert got["sawada_step_roofline_pct"] == pytest.approx(100 * ITERATION * step / 420e-6)


@pytest.mark.parametrize(
    "case, kwargs, silent",
    [
        ("more_events_than_launches", {"k3_counted": K3_LAUNCHES - 3}, {"k3_roofline_pct"}),
        ("no_k3_events", {"k3": 0, "k3_counted": 0}, {"k3_roofline_pct"}),
        ("no_counter", {"k3_counted": None}, {"k3_launches", "k3_roofline_pct"}),
        ("a_capture", {"capture": True}, set(READERS)),
    ],
    ids=lambda v: v if isinstance(v, str) else "",
)
def test_nothing_to_read_where_the_guard_fails(monkeypatch, readers, case, kwargs, silent):
    _, got = _read(monkeypatch, readers, **kwargs)
    assert {name for name, value in got.items() if value is None} == silent


def test_k3_is_read_over_the_events_the_trace_kept(monkeypatch, readers):
    """The profiler can drop activities from a long trace: with a third of
    K3's events gone the share is the kept events' (each 2 us, so the same)."""
    _, got = _read(monkeypatch, readers, k3=K3_LAUNCHES - 50)
    k3 = least_seconds(*eigh_step.least_work(3, 2049 * 3), H100)
    assert got["k3_launches"] == float(K3_LAUNCHES)
    assert got["k3_roofline_pct"] == pytest.approx(100 * k3 / 2e-6)


def test_nothing_to_read_without_the_log_or_the_peak(monkeypatch, readers):
    run, spans = _window()
    monkeypatch.setattr(program_spans, "logged", lambda: None)
    assert all(reader.read(run) is None for reader in readers.values())
    monkeypatch.setattr(program_spans, "logged", lambda: list(spans))
    run.peak = None
    assert readers["k3_roofline_pct"].read(run) is None and readers["sawada_step_roofline_pct"].read(run) is None
    assert readers["k3_launches"].read(run) == float(K3_LAUNCHES)


FIXED = "mnmf_sawada_c3.small_fixed"


def test_a_traced_cpu_run_of_the_configuration(tmp_path):
    """Fixed 6 s recordings at the cell's STFT (3 x 2049 x 48), 10
    iterations (the CPU's eager dispatch takes about 0.15 s an iteration),
    through the whole harness on the CPU, the captured loop emulated: correct
    against the cell's limits, with the state copies read, K3 not launched
    (the CPU takes its plain route, which the counter does not count) and
    the device's shares left out."""
    root = make_root(tmp_path)
    spec = json.loads((root / "BENCHMARK.json").read_text())
    config = _small(10, fft_size=4096)
    config["name"] = "mnmf_sawada_c3_small"
    (root / "portbench" / "configs" / "mnmf_sawada_c3_small.json").write_text(json.dumps(config))
    spec["configs"].append(dict(spec["configs"][-1], name="mnmf_sawada_c3_small",
                                file="portbench/configs/mnmf_sawada_c3_small.json"))
    reference = root / "portbench" / "reference"
    (reference / "mnmf_sawada_c3_small.py").write_text((reference / "mnmf_sawada_c3.py").read_text())
    spec["workloads"].append({"name": FIXED, "config": "mnmf_sawada_c3_small", "traffic": "small_fixed", "chips": 1,
                              "why": "fixed 6 s songs for the CPU tests"})
    for metric in spec["per_layer"]:
        if CELL in metric.get("workloads", []):
            metric["workloads"].append(FIXED)
    (root / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    traffic = {"loop": "closed", "clients": 1, "length_s": [6, 6], "pool": 1, "warmup_s": 6, "trace_recordings": 1,
               "check_recordings": 2, "why": "fixed 6 s songs for the CPU tests"}
    (root / "portbench" / "traffic" / "small_fixed.json").write_text(json.dumps(traffic))
    limits = root / "portbench" / "limits"
    (limits / (FIXED + ".json")).write_text((limits / (CELL + ".json")).read_text())
    cmd = [sys.executable, "-m", "portbench.tests.cpu_run_graph", "--root", str(root), "--workload", FIXED,
           "--seed", "3260000022", "--seconds", "6", "--trace", "1"]
    proc = subprocess.run(cmd, cwd=root, capture_output=True, text=True, timeout=600,
                          env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert proc.returncode == 0, proc.stderr[-4000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] >= 2, result["checks"]
    metrics = result["metrics"]
    for name in SPAN_METRICS + ["frontend_ms", "solve_ms", "state_copy_in_ms"]:
        assert math.isfinite(metrics[name]["value"]) and metrics[name]["value"] > 0, name
    # the mixture, the two windows and the losses, and the three state copies
    assert metrics["host_copies"]["value"] == 7.0
    assert metrics["k3_launches"]["value"] == 0.0
    # no device activity and no peak on the CPU: the device's metrics are left out
    for name in ("k3_roofline_pct", "sawada_step_roofline_pct", "device_idle_pct", "solve_idle_ms"):
        assert name not in metrics, name
