"""The port's span log and counters (``runtime/spanlog.py``), on the CPU:
when the log records, how the spans of ``stft``, a solver call and
``istft`` nest, that they share the profiler's clock and stay out of its
events, the counters of host copies and of the captured loop, and the
spans in :func:`~audio_source_separation_tpu_torch.runtime.profiling.trace`'s
Chrome trace."""

import json

import numpy as np
import pytest
import torch

import audio_source_separation_tpu_torch as port
from audio_source_separation_tpu_torch.ops import fused_ip
from audio_source_separation_tpu_torch.runtime import graph, profiling, spanlog

FFT, HOP = 256, 128
ITERATION = 6
SOLVE_CHILDREN = ["solve.init", "solve.eager_step", "solve.replay", "solve.wait", "solve.finalize"]
EAGER_CHILDREN = ["solve.init", "solve.steps", "solve.wait", "solve.finalize"]


@pytest.fixture(autouse=True)
def empty_log():
    spanlog.clear()
    yield
    spanlog.clear()


def _profiler():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


def _waveform(seed=0, n=4000):
    return np.random.default_rng(seed).standard_normal((2, n)).astype(np.float32)


def _solver(emulate=True):
    solver = port.AuxLaplaceIVA(algorithm_spatial="IP", device="cpu")
    solver._emulate_graph = emulate
    return solver


def _separate(solver, x, iteration=ITERATION):
    X = port.stft(x, FFT, HOP, device="cpu")
    Y = solver(X, iteration=iteration)
    return port.istft(Y, FFT, HOP, length=x.shape[-1], device="cpu")


def _by_id():
    return {s.id: s for s in profiling.spans()}


def test_the_log_is_empty_without_a_profiler():
    _separate(_solver(), _waveform())
    assert profiling.spans() == []
    # off, a span is one shared object that does nothing
    assert spanlog.span("a") is spanlog.span("b")
    assert spanlog.begin("a") is None


def test_the_log_records_with_a_profiler():
    solver = _solver()
    with _profiler():
        _separate(solver, _waveform())
    names = [s.name for s in profiling.spans()]
    assert {"stft", "stft.copy_in", "solve", "istft", "istft.copy_in"} <= set(names)
    assert set(SOLVE_CHILDREN) <= set(names)
    # after the profiler stops, nothing more is recorded
    _separate(solver, _waveform())
    assert [s.name for s in profiling.spans()] == names


def test_the_log_stays_bounded():
    with _profiler():
        for _ in range(spanlog.CAPACITY + 10):
            with spanlog.span("x"):
                pass
    logged = profiling.spans()
    assert len(logged) == spanlog.CAPACITY
    ids = [s.id for s in logged]
    assert ids == sorted(ids) and ids[-1] - ids[0] == spanlog.CAPACITY - 1


def test_spans_nest_by_call():
    solver = _solver()
    _separate(solver, _waveform(1))  # the first call at this length captures
    with _profiler():
        _separate(solver, _waveform(2))
    spans = _by_id()
    top = sorted((s for s in spans.values() if s.parent is None), key=lambda s: s.start_ns)
    assert [s.name for s in top] == ["stft", "solve", "istft"]
    for parent in top:
        kids = sorted((s for s in spans.values() if s.parent == parent.id), key=lambda s: s.start_ns)
        for kid in kids:
            assert parent.start_ns <= kid.start_ns <= kid.end_ns <= parent.end_ns
        if parent.name == "solve":
            assert [k.name for k in kids] == SOLVE_CHILDREN
        else:
            assert [k.name for k in kids] == [parent.name + ".copy_in"] * 2
        # only a top-level span carries the counters
        assert parent.attrs is not None and all(k.attrs is None for k in kids)
    assert len(spans) == len({s.id for s in spans.values()})


def test_a_capture_nests_in_the_eager_step():
    solver = _solver()
    with _profiler():
        solver(port.stft(_waveform(), FFT, HOP, device="cpu"), iteration=ITERATION)
    spans = _by_id()
    (capture,) = [s for s in spans.values() if s.name == "solve.capture"]
    assert spans[capture.parent].name == "solve.eager_step"
    assert spans[spans[capture.parent].parent].name == "solve"


def test_the_eager_loop_has_steps_in_place_of_replays():
    with _profiler():
        _solver(emulate=False)(port.stft(_waveform(), FFT, HOP, device="cpu"), iteration=ITERATION)
    spans = _by_id()
    (solve,) = [s for s in spans.values() if s.name == "solve"]
    kids = sorted((s for s in spans.values() if s.parent == solve.id), key=lambda s: s.start_ns)
    assert [k.name for k in kids] == EAGER_CHILDREN
    assert solve.attrs["graph_replays"] == 0 and solve.attrs["graph_captures"] == 0


def test_a_raise_inside_a_span_leaves_no_span_open():
    with _profiler():
        with pytest.raises(ValueError):
            with spanlog.span("outer"):
                spanlog.begin("left open")
                raise ValueError
        with spanlog.span("next"):
            pass
    names = {s.name: s for s in profiling.spans()}
    assert "left open" not in names
    assert names["next"].parent is None


def test_spans_share_the_profilers_clock():
    """A ``record_function`` range opened inside a program span lies
    within it, and a program span opened inside one lies within that."""
    with _profiler() as prof:
        with spanlog.span("program.outer"):
            with torch.profiler.record_function("profiler.inner"):
                torch.ones(8).add_(1)
        with torch.profiler.record_function("profiler.outer"):
            port.stft(_waveform(), FFT, HOP, device="cpu")
    events = {e.name(): e for e in prof.profiler.kineto_results.events()}
    spans = {s.name: s for s in profiling.spans()}
    inner = events["profiler.inner"]
    outer = spans["program.outer"]
    assert outer.start_ns <= inner.start_ns() <= inner.start_ns() + inner.duration_ns() <= outer.end_ns
    around = events["profiler.outer"]
    stft = spans["stft"]
    assert around.start_ns() <= stft.start_ns <= stft.end_ns <= around.start_ns() + around.duration_ns()


def test_no_profiler_event_bears_a_span_name():
    solver = _solver()
    with _profiler() as prof:
        _separate(solver, _waveform())
        _separate(solver, _waveform())
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    spans = {s.name for s in profiling.spans()}
    assert spans and not names & spans


def test_stft_of_an_array_counts_two_host_copies():
    x = _waveform()
    before = dict(profiling.counters)
    port.stft(x, FFT, HOP, device="cpu")
    assert profiling.counters["host_copies"] - before["host_copies"] == 2
    assert profiling.counters["host_copy_bytes"] - before["host_copy_bytes"] == x.nbytes + FFT * 4
    # the same numbers on the span, with a profiler
    with _profiler():
        port.stft(x, FFT, HOP, device="cpu")
    (stft,) = [s for s in profiling.spans() if s.name == "stft"]
    assert stft.attrs["host_copies"] == 2 and stft.attrs["host_copy_bytes"] == x.nbytes + FFT * 4
    # a tensor already on the device is not copied
    before = profiling.counters["host_copies"]
    port.stft(torch.as_tensor(x), FFT, HOP, device="cpu")
    assert profiling.counters["host_copies"] - before == 1  # the window


def test_a_recording_counts_four_host_copies():
    """The mixture, two windows and the losses' one transfer."""
    solver = _solver()
    with _profiler():
        _separate(solver, _waveform())
    top = [s for s in profiling.spans() if s.parent is None]
    assert {s.name: s.attrs["host_copies"] for s in top} == {"stft": 2, "solve": 1, "istft": 1}
    (solve,) = [s for s in top if s.name == "solve"]
    assert solve.attrs["host_copy_bytes"] == (ITERATION + 1) * 4  # float32 losses


def test_the_captured_loop_counts_captures_hits_and_replays():
    solver = _solver()
    X = port.stft(_waveform(), FFT, HOP, device="cpu")
    with _profiler():
        solver(X, iteration=ITERATION)
        solver(X, iteration=ITERATION)
    first, second = [s.attrs for s in profiling.spans() if s.name == "solve"]
    assert (first["graph_captures"], first["graph_cache_hits"], first["graph_replays"]) == (1, 0, ITERATION - 1)
    assert (second["graph_captures"], second["graph_cache_hits"], second["graph_replays"]) == (0, 1, ITERATION - 1)
    assert {"k1_launches", "k2_launches", "k3_launches"} <= set(first)
    # the counters themselves, with no profiler
    before = dict(profiling.counters)
    solver(X, iteration=ITERATION)
    delta = {k: profiling.counters[k] - before[k] for k in ("graph_captures", "graph_cache_hits", "graph_replays")}
    assert delta == {"graph_captures": 0, "graph_cache_hits": 1, "graph_replays": ITERATION - 1}


def test_replay_adds_launches_once_a_call():
    """``replay(n)`` adds ``n`` steps' launches in one addition, through
    the kernel wrappers resolved once."""

    def step(state):
        fused_ip.fused_auxiva_ip_iter.launches += 1
        return {"x": state["x"] * 0.5}

    state = {"x": torch.ones(3)}
    g = graph.StepGraph("stub", step(state), step)
    assert g.launches == (1, 0, 0, 0, 0)
    before = fused_ip.fused_auxiva_ip_iter.launches
    replays = profiling.counters["graph_replays"]
    g.replay(7)
    assert fused_ip.fused_auxiva_ip_iter.launches - before == 7
    assert profiling.counters["graph_replays"] - replays == 7
    assert torch.equal(g.static["x"], torch.full((3,), 0.5**8))
    assert graph._counted() is graph._counted()


def test_trace_writes_the_spans_into_its_chrome_trace(tmp_path):
    solver = _solver()
    with profiling.trace(str(tmp_path)):
        with spanlog.span("program.outer"):
            with torch.profiler.record_function("profiler.inner"):
                torch.ones(8).add_(1)
        _separate(solver, _waveform())
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    ours = [e for e in events if e.get("pid") == profiling.SPANS_PID and e["ph"] == "X"]
    assert sorted(e["name"] for e in ours) == sorted(s.name for s in profiling.spans())
    solve = next(e for e in ours if e["name"] == "solve")
    assert solve["args"]["graph_captures"] == 1 and solve["args"]["graph_replays"] == ITERATION - 1
    # the spans sit on the trace's own time base
    outer = next(e for e in ours if e["name"] == "program.outer")
    inner = next(e for e in events if e.get("name") == "profiler.inner" and e.get("ph") == "X")
    assert outer["ts"] <= inner["ts"] and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]
