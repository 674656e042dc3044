"""The port's ``runtime/profiling.py`` on the CPU (the counterparts of
``tests/test_utils_harness.py``'s profiling tests) and the plain route of
``weighted_covariance_auto(..., use_pallas=False)``."""

import json
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import audio_source_separation_tpu.ops.covariance as jax_cov
import audio_source_separation_tpu.runtime as jax_runtime
import audio_source_separation_tpu_torch as port
import audio_source_separation_tpu_torch.runtime as port_runtime
from audio_source_separation_tpu_torch.ops import cov_kernel
from audio_source_separation_tpu_torch.ops import covariance as port_cov
from audio_source_separation_tpu_torch.runtime import profiling
from audio_source_separation_tpu_torch.runtime import (
    IterationTimer,
    benchmark_solver,
    measure_memory_bandwidth,
    state_payload_bytes,
    trace,
)

from conftest import make_mixture


def test_runtime_exports_hold_jax_names():
    assert set(jax_runtime.__all__) <= set(port_runtime.__all__)
    assert set(port_runtime.__all__) - set(jax_runtime.__all__) == {"resolve_device"}
    assert all(callable(getattr(port_runtime, name)) for name in port_runtime.__all__)


def _benchmark_quietly(*args, **kwargs):
    """``benchmark_solver`` with its warnings recorded, not required: whether
    the differenced window passes 10 ms depends on the machine's speed."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        result = benchmark_solver(*args, **kwargs)
    for w in caught:
        assert issubclass(w.category, RuntimeWarning) and "differenced window" in str(w.message)
    return result


def test_benchmark_solver_runs(rng):
    X = make_mixture(rng, n_channels=2, n_bins=17, n_frames=24)
    ips, compile_s = _benchmark_quietly(port.AuxLaplaceIVA(device="cpu"), X, iteration=5)
    assert ips > 0 and compile_s > 0


def test_benchmark_solver_update_fn_and_short(rng):
    """A custom ``update_fn`` runs in the loop, ``short`` and ``iteration``
    times per window; an empty difference raises."""
    X = make_mixture(rng, n_channels=2, n_bins=17, n_frames=24)
    solver = port.AuxLaplaceIVA(device="cpu")
    calls = []

    def update(state):
        calls.append(1)
        return solver.update_state(state)

    ips, compile_s = _benchmark_quietly(solver, X, iteration=4, short=2, update_fn=update)
    assert ips > 0 and compile_s > 0
    assert len(calls) == 4 + 2 + 4 * (4 + 2)  # the first call, a short one, four windows of each
    with pytest.raises(ValueError, match="short"):
        benchmark_solver(solver, X, iteration=4, short=4)


# (t_long, t_short) in seconds, exact in binary, and whether the window warns
WINDOWS = [
    (0.25 + 2.0**-7, 0.25, True),  # 7.8 ms
    (0.25 + 2.0**-12, 0.25, True),  # 0.24 ms
    (0.010, 0.0, False),  # exactly 10 ms
    (0.25 + 2.0**-6, 0.25, False),  # 15.6 ms
]


@pytest.mark.parametrize("t_long,t_short,warns", WINDOWS, ids=["7.8ms", "0.24ms", "10ms", "15.6ms"])
def test_benchmark_solver_warns_below_10_ms(rng, monkeypatch, t_long, t_short, warns):
    """The warning depends only on the differenced window: the window timer
    is stubbed to fixed times (``t_long`` first, then ``t_short``)."""
    times = iter([t_long, t_short])
    monkeypatch.setattr(profiling, "_min_seconds", lambda fn, device, windows: next(times))
    X = make_mixture(rng, n_channels=2, n_bins=5, n_frames=8)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        ips, _ = benchmark_solver(port.AuxLaplaceIVA(device="cpu"), X, iteration=5, short=1)
    messages = [str(w.message) for w in caught if issubclass(w.category, RuntimeWarning)]
    assert [("differenced window" in m) for m in messages] == ([True] if warns else [])
    assert ips == pytest.approx((5 - 1) / (t_long - t_short), rel=1e-12)


def test_iteration_timer(rng):
    X = make_mixture(rng)
    timer = IterationTimer()
    port.AuxLaplaceIVA(callbacks=timer, recordable_loss=False, device="cpu")(X, iteration=3)
    assert len(timer.durations) == 3
    assert (timer.durations >= 0).all()


def test_trace_writes_a_chrome_trace(rng, tmp_path):
    X = make_mixture(rng)
    with trace(str(tmp_path / "trace")):
        port.AuxLaplaceIVA(device="cpu")(X, iteration=2)
    events = json.loads((tmp_path / "trace" / "trace.json").read_text())["traceEvents"]
    assert events


def test_measure_memory_bandwidth_is_positive():
    assert measure_memory_bandwidth(n_elems=1 << 16, iters=8, device="cpu") > 0


@pytest.mark.parametrize(
    "make",
    [
        lambda: port.AuxLaplaceIVA(device="cpu"),
        lambda: port.AuxLaplaceIVA(guard="svd", device="cpu"),
        lambda: port.GaussILRMA(n_basis=3, device="cpu"),
    ],
    ids=["auxiva_ip_k2", "auxiva_ip_svd", "gauss_ilrma"],
)
def test_state_payload_bytes_is_the_init_state(rng, make):
    X = make_mixture(rng)
    solver = make()
    np.random.seed(111)
    ours = state_payload_bytes(solver, X)
    np.random.seed(111)
    Xt = solver._to_input(X)
    state = solver.init_state(Xt, **solver.prepare_state_kwargs(Xt, {}))
    assert ours == sum(v.numel() * v.element_size() for v in state.values())
    assert ours >= Xt.numel() * Xt.element_size()


@pytest.mark.parametrize("pairs", [False, True], ids=["direct", "pairs"])
@pytest.mark.parametrize("per_bin", [False, True], ids=["nt", "nft"])
def test_weighted_covariance_auto_false_takes_the_plain_route(per_bin, pairs, monkeypatch):
    """``use_pallas=False``: the pair-product product where ``PP`` is given,
    else the direct contraction, with no call of K1's wrapper; equal to K1's
    plain version and to the JAX function."""
    rng = np.random.RandomState(5)
    X = torch.as_tensor(make_mixture(rng, n_channels=3, n_bins=17, n_frames=21))
    w = torch.as_tensor(np.abs(rng.randn(*((2, 17, 21) if per_bin else (2, 21)))) + 0.1)
    PP = port_cov.pair_products(X) if pairs else None
    routes = []
    for name in ("weighted_covariance", "weighted_covariance_from_pairs"):
        route = getattr(port_cov, name)
        monkeypatch.setattr(port_cov, name, lambda *a, _r=route, _n=name: routes.append(_n) or _r(*a))
    monkeypatch.setattr(port_cov, "weighted_covariance_planes", lambda *a: pytest.fail("K1 was called"))
    ours = port_cov.weighted_covariance_auto(X, w, PP=PP, use_pallas=False)
    assert routes == ["weighted_covariance_from_pairs" if pairs else "weighted_covariance"]
    k1_plain = port_cov.assemble_matrices(cov_kernel.weighted_covariance_planes_plain(X, w))
    np.testing.assert_allclose(ours.numpy(), k1_plain.numpy(), atol=1e-12)
    theirs = jax_cov.weighted_covariance_auto(
        jnp.asarray(X.numpy()), jnp.asarray(w.numpy()),
        PP=None if PP is None else jax_cov.pair_products(jnp.asarray(X.numpy())), use_pallas=False,
    )  # fmt: skip
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=1e-12)
