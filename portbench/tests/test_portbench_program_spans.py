"""The readers of the program's spans and counters
(``portbench/harness/program_spans.py`` and its eight metrics): on a
synthetic span log and trace, the ``None`` cases among them, and a whole
traced run on the CPU with the captured loop emulated."""

import json
import math
import subprocess
import sys
from collections import namedtuple
from types import SimpleNamespace

import pytest

from portbench.harness import program_spans
from portbench.harness.manifest import Manifest
from portbench.harness.trace import Trace
from portbench.tests._support import REPO, make_root

Span = namedtuple("Span", "id parent name start_ns end_ns attrs")
ITERATION = 50
SPAN_METRICS = [
    "stft_copy_in_ms",
    "host_copies",
    "solve_init_ms",
    "solve_eager_step_ms",
    "solve_replay_ms",
    "solve_wait_ms",
    "solve_finalize_ms",
]
US = 1000


class Event:
    """A profiler event as :class:`Trace` reads one."""

    def __init__(self, name, start, end, device=False):
        self._name, self._start, self._end, self._device = name, start, end, device

    def name(self):
        return self._name

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._end - self._start

    def device_type(self):
        return "DeviceType.CUDA" if self._device else "DeviceType.CPU"


def _counts(**changed):
    counts = {"graph_captures": 0, "graph_cache_hits": 0, "graph_replays": 0, "host_copies": 0, "host_copy_bytes": 0,
              "k1_launches": 0, "k2_launches": 0, "k3_launches": 0}
    counts.update(changed)
    return counts


def _recording(t0, first_id, solve_attrs=None, capture=False):
    """The spans of one recording from ``t0`` (ns), and its profiler events:
    stft 0-100 us (copies 0-40, 50-60), solve 100-1100 (init 100-300,
    eager step 300-500 with a capture 350-450 where asked, replay 500-700,
    wait 700-900, finalize 900-1100), istft 1100-1200 (copies 1110-1120,
    1130-1140); the card busy 100-150, 400-420, 750-850 and 1150-1160."""
    i = first_id
    t = lambda us: t0 + us * US  # noqa: E731
    spans = [
        Span(i + 1, i, "stft.copy_in", t(0), t(40), None),
        Span(i + 2, i, "stft.copy_in", t(50), t(60), None),
        Span(i, None, "stft", t(0), t(100), _counts(host_copies=2, host_copy_bytes=1000)),
        Span(i + 4, i + 3, "solve.init", t(100), t(300), None),
        Span(i + 6, i + 5, "solve.capture", t(350), t(450), None) if capture else None,
        Span(i + 5, i + 3, "solve.eager_step", t(300), t(500), None),
        Span(i + 7, i + 3, "solve.replay", t(500), t(700), None),
        Span(i + 8, i + 3, "solve.wait", t(700), t(900), None),
        Span(i + 9, i + 3, "solve.finalize", t(900), t(1100), None),
        Span(i + 3, None, "solve", t(100), t(1100),
             _counts(graph_replays=ITERATION - 1, graph_cache_hits=1, host_copies=1, k2_launches=ITERATION)
             if solve_attrs is None else solve_attrs),
        Span(i + 11, i + 10, "istft.copy_in", t(1110), t(1120), None),
        Span(i + 12, i + 10, "istft.copy_in", t(1130), t(1140), None),
        Span(i + 10, None, "istft", t(1100), t(1200), _counts(host_copies=1, host_copy_bytes=100)),
    ]
    events = [
        Event("portbench.recording", t(0), t(1250)),
        Event("portbench.solve", t(100), t(1100)),
        Event("fused_ip_kernel", t(100), t(150), device=True),
        Event("fused_ip_kernel", t(400), t(420), device=True),
        Event("Memcpy DtoH", t(750), t(850), device=True),
        Event("Memcpy HtoD", t(1150), t(1160), device=True),
    ]
    return [s for s in spans if s is not None], events


def _run(n=2, monkeypatch=None, device=True, **kwargs):
    spans, events = [], []
    for r in range(n):
        s, e = _recording(10**9 + r * 2000 * US, 100 * r + 1, **kwargs)
        spans += s
        events += [ev for ev in e if device or not ev._device]
    trace = Trace(events, [{"index": r} for r in range(n)])
    run = SimpleNamespace(trace=trace, config={"system": {"iteration": ITERATION}}, recordings=[], peak=None)
    if monkeypatch is not None:
        monkeypatch.setattr(program_spans, "logged", lambda: list(spans))
    return run, spans


@pytest.fixture(scope="module")
def readers():
    manifest = Manifest(REPO)
    return {m: manifest.reader(m) for m in SPAN_METRICS + ["solve_idle_ms"]}


def test_the_readers_on_a_synthetic_window(monkeypatch, readers):
    run, _ = _run(monkeypatch=monkeypatch)
    got = {name: reader.read(run) for name, reader in readers.items()}
    assert got == {
        "stft_copy_in_ms": pytest.approx(0.050),
        "host_copies": 4.0,
        "solve_init_ms": pytest.approx(0.200),
        "solve_eager_step_ms": pytest.approx(0.200),
        "solve_replay_ms": pytest.approx(0.200),
        "solve_wait_ms": pytest.approx(0.200),
        "solve_finalize_ms": pytest.approx(0.200),
        # 1000 us of solve less 50 (from 100), 20 and 100 us busy
        "solve_idle_ms": pytest.approx(0.830),
    }


def test_the_eager_step_is_read_less_its_capture(monkeypatch):
    # a capture's span with no capture counted (a cache hit's is not
    # logged; this stands for the span's subtraction alone)
    run, _ = _run(monkeypatch=monkeypatch, capture=True)
    assert program_spans.mean_ms(run, "solve.eager_step", less="solve.capture") == pytest.approx(0.100)


def test_spans_outside_the_window_are_left_out(monkeypatch, readers):
    run, spans = _run(monkeypatch=monkeypatch)
    late, _ = _recording(10**9 + 10**8, 1000)
    monkeypatch.setattr(program_spans, "logged", lambda: spans + late)
    assert readers["solve_init_ms"].read(run) == pytest.approx(0.200)


def test_nothing_to_read_where_solves_and_recordings_differ(monkeypatch, readers):
    run, spans = _run(monkeypatch=monkeypatch)
    one_less = [s for s in spans if not (s.name == "solve" and s.id == 4)]
    monkeypatch.setattr(program_spans, "logged", lambda: one_less)
    assert all(reader.read(run) is None for reader in readers.values())


@pytest.mark.parametrize(
    "attrs",
    [
        _counts(graph_captures=1, graph_replays=ITERATION - 1, k2_launches=ITERATION),
        _counts(graph_replays=ITERATION - 2, graph_cache_hits=1, k2_launches=ITERATION - 1),
        {},
    ],
    ids=["a_capture", "fewer_replays", "no_counters"],
)
def test_nothing_to_read_off_the_steady_captured_loop(monkeypatch, readers, attrs):
    run, _ = _run(monkeypatch=monkeypatch, solve_attrs=attrs)
    assert all(reader.read(run) is None for reader in readers.values())


def test_nothing_to_read_from_a_program_without_the_log(monkeypatch, readers):
    run, _ = _run()
    monkeypatch.setattr(program_spans, "logged", lambda: None)
    assert all(reader.read(run) is None for reader in readers.values())
    run.trace = None
    assert all(reader.read(run) is None for reader in readers.values())


def test_the_program_module_without_spans_reads_none(monkeypatch):
    import audio_source_separation_tpu_torch.runtime.profiling as profiling

    monkeypatch.delattr(profiling, "spans")
    assert program_spans.logged() is None


def test_no_device_activity_no_idle(monkeypatch, readers):
    run, _ = _run(monkeypatch=monkeypatch, device=False)
    assert readers["solve_idle_ms"].read(run) is None
    assert readers["solve_init_ms"].read(run) == pytest.approx(0.200)


def test_idle_by_innermost_span(monkeypatch):
    run, spans = _run(n=1)
    idle = program_spans.idle_by_span(run.trace, spans)
    # the window is the recording's 1250 us, busy 50 + 20 + 100 + 10
    assert sum(idle.values()) == pytest.approx((1250 - 180) * 1e-6)
    assert idle["solve.init"] == pytest.approx(150e-6)
    assert idle["solve.eager_step"] == pytest.approx(180e-6)
    assert idle["solve.wait"] == pytest.approx(100e-6)
    assert idle["stft.copy_in"] == pytest.approx(50e-6)
    assert idle["stft"] == pytest.approx(50e-6)
    assert idle["istft"] == pytest.approx(70e-6)
    assert idle["outside the program: between recordings"] == pytest.approx(50e-6)


FIXED = "auxiva_ip_c2.small_fixed"


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A checkout copy with a cell of fixed 2 s recordings (the length set-up
    separates, so the window's recordings replay a cached graph)."""
    root = make_root(tmp_path_factory.mktemp("portbench_spans"))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": FIXED, "config": "auxiva_ip_c2", "traffic": "small_fixed", "chips": 1,
                              "why": "fixed 2 s clips for the CPU tests"})
    for metric in spec["per_layer"]:
        if metric["name"] in SPAN_METRICS + ["solve_idle_ms"]:
            metric["workloads"].append(FIXED)
    (root / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    traffic = {"loop": "closed", "clients": 1, "length_s": [2, 2], "pool": 2, "warmup_s": 2, "trace_recordings": 2,
               "check_recordings": 2, "why": "fixed 2 s clips for the CPU tests"}
    (root / "portbench" / "traffic" / "small_fixed.json").write_text(json.dumps(traffic))
    limits = root / "portbench" / "limits"
    (limits / (FIXED + ".json")).write_text((limits / "auxiva_ip_c2.clips_varlen.json").read_text())
    return root


def test_a_traced_cpu_run_reads_the_spans(root):
    cmd = [sys.executable, "-m", "portbench.tests.cpu_run_graph", "--root", str(root), "--workload", FIXED,
           "--seed", "2147483651", "--seconds", "3", "--trace", "1"]
    proc = subprocess.run(cmd, cwd=root, capture_output=True, text=True, timeout=300,
                          env=dict(__import__("os").environ, OMP_NUM_THREADS="2"))
    assert proc.returncode == 0, proc.stderr
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"] is True
    metrics = result["metrics"]
    for name in SPAN_METRICS:
        assert math.isfinite(metrics[name]["value"]) and metrics[name]["value"] > 0, name
    assert metrics["host_copies"]["value"] == 4.0
    # no device activity on the CPU: the device's metric is left out
    assert "solve_idle_ms" not in metrics
