"""The port's ``parallel`` package and the pair-product covariance against the
JAX package on the CPU at float64: ``weighted_covariance_auto`` with the
JAX keywords, ``pair_products`` / ``weighted_covariance_from_pairs``, the
five AuxIVA-IP steps of ``sharded.py`` (atol 1e-10), and ``batch_separate``
against JAX's and against the port's own per-example calls (outputs at atol
1e-8, losses at rtol 1e-10), for every family ``benchmarks/`` batches and
one solver of each other family."""

import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import audio_source_separation_tpu.models as jax_models
import audio_source_separation_tpu.ops.covariance as jax_cov
import audio_source_separation_tpu.parallel as jax_parallel
import audio_source_separation_tpu.parallel.sharded as jax_sharded
import audio_source_separation_tpu_torch as port
import audio_source_separation_tpu_torch.ops.covariance as port_cov
import audio_source_separation_tpu_torch.parallel as port_parallel
from audio_source_separation_tpu_torch.ops import cov_kernel
from audio_source_separation_tpu_torch.utils import state_from_jax

from _torch_port import assert_losses_match, to_np

# the JAX ``parallel`` names the port lacks: none since slice 10b
DEFERRED_PARALLEL = set()
# the steps of ``parallel/sharded.py`` that the JAX package does not re-export
SHARDED_STEPS = {"auxiva_ip_step_carry", "auxiva_ip_step_binsmajor", "auxiva_ip_step_stacked", "batched_auxiva_ip_step"}
ITERATIONS = 3


def _mixture(seed, C=2, F=17, T=24, batch=None):
    rng = np.random.RandomState(seed)
    shape = (C, F, T) if batch is None else (batch, C, F, T)
    return rng.randn(*shape) + 1j * rng.randn(*shape)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def test_parallel_exports_match_jax_less_slice_10b():
    assert set(port_parallel.__all__) == (set(jax_parallel.__all__) - DEFERRED_PARALLEL) | SHARDED_STEPS
    assert DEFERRED_PARALLEL <= set(jax_parallel.__all__)
    assert all(callable(getattr(jax_sharded, name)) for name in SHARDED_STEPS)
    assert all(callable(getattr(port_parallel, name)) for name in port_parallel.__all__)
    assert port.parallel is port_parallel


# --------------------------------------------------------------------------- #
# the covariance forms
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("per_bin", [False, True], ids=["nt", "nft"])
def test_pair_product_covariance_matches_jax(per_bin):
    rng = np.random.RandomState(3)
    X = _mixture(3, C=3, F=17, T=21)
    w = np.abs(rng.randn(*((2, 17, 21) if per_bin else (2, 21)))) + 0.1
    PP = port_cov.pair_products(_t(X))
    np.testing.assert_allclose(to_np(PP), np.asarray(jax_cov.pair_products(jnp.asarray(X))), atol=1e-12)
    ours = port_cov.weighted_covariance_from_pairs(PP, _t(w))
    theirs = jax_cov.weighted_covariance_from_pairs(jax_cov.pair_products(jnp.asarray(X)), jnp.asarray(w))
    np.testing.assert_allclose(to_np(ours), np.asarray(theirs), atol=1e-12)
    np.testing.assert_allclose(to_np(ours), to_np(port_cov.weighted_covariance(_t(X), _t(w))), atol=1e-12)


@pytest.mark.parametrize("use_pallas", [True, False, None])
@pytest.mark.parametrize("per_bin", [False, True], ids=["nt", "nft"])
def test_weighted_covariance_auto_takes_the_jax_keywords(per_bin, use_pallas, monkeypatch):
    """``PP`` and ``use_pallas`` are accepted.  ``None`` and ``True`` take K1
    (its plain version here), one call of its wrapper; an explicit ``False``
    takes the plain route, as the JAX function does, and calls no K1."""
    rng = np.random.RandomState(4)
    X = _mixture(4, C=2, F=17, T=24)
    w = np.abs(rng.randn(*((2, 17, 24) if per_bin else (2, 24)))) + 0.1
    theirs = jax_cov.weighted_covariance_auto(
        jnp.asarray(X), jnp.asarray(w), PP=jax_cov.pair_products(jnp.asarray(X)), use_pallas=use_pallas
    )
    calls = []
    plain = cov_kernel.weighted_covariance_planes_plain
    monkeypatch.setattr(cov_kernel, "weighted_covariance_planes_plain", lambda *a: calls.append(1) or plain(*a))
    ours = port_cov.weighted_covariance_auto(_t(X), _t(w), PP=port_cov.pair_products(_t(X)), use_pallas=use_pallas)
    assert calls == ([] if use_pallas is False else [1])
    np.testing.assert_allclose(to_np(ours), np.asarray(theirs), atol=1e-12)


# --------------------------------------------------------------------------- #
# the sharded steps
# --------------------------------------------------------------------------- #
def _filters(seed, F, C):
    rng = np.random.RandomState(seed)
    return np.tile(np.eye(C, dtype=complex), (F, 1, 1)) + 0.2 * (rng.randn(F, C, C) + 1j * rng.randn(F, C, C))


@pytest.mark.parametrize("C", [2, 3])
@pytest.mark.parametrize("route", ["einsum", "pairs", "pallas", "pallas_pairs"])
def test_auxiva_ip_step_matches_jax(route, C):
    X, W = _mixture(5, C=C), _filters(6, 17, C)
    PP = route in ("pairs", "pallas_pairs")
    use_pallas = route.startswith("pallas")
    kw = {"use_pallas": use_pallas}
    W_j, nll_j = jax.jit(functools.partial(jax_sharded.auxiva_ip_step, **kw))(
        jnp.asarray(X), jnp.asarray(W), jax_cov.pair_products(jnp.asarray(X)) if PP else None
    )
    launches = cov_kernel.weighted_covariance_planes.launches
    W_p, nll_p = port_parallel.auxiva_ip_step(_t(X), _t(W), port_cov.pair_products(_t(X)) if PP else None, **kw)
    assert cov_kernel.weighted_covariance_planes.launches == launches  # the CPU runs the plain version
    np.testing.assert_allclose(to_np(W_p), np.asarray(W_j), atol=1e-10)
    np.testing.assert_allclose(float(nll_p), float(nll_j), rtol=1e-12)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_auxiva_ip_step_carry_matches_jax(use_pallas):
    X, W = _mixture(7), _filters(8, 17, 2)
    Y = np.einsum("fnc,cft->nft", W, X)
    theirs = jax.jit(functools.partial(jax_sharded.auxiva_ip_step_carry, use_pallas=use_pallas))(
        jnp.asarray(X), jnp.asarray(W), jnp.asarray(Y)
    )
    ours = port_parallel.auxiva_ip_step_carry(_t(X), _t(W), _t(Y), use_pallas=use_pallas)
    for a, b in zip(ours, theirs):
        np.testing.assert_allclose(to_np(a), np.asarray(b), atol=1e-10, rtol=1e-12)


def test_auxiva_ip_step_binsmajor_matches_jax():
    X, W = _mixture(9), _filters(10, 17, 2)
    Xf = np.ascontiguousarray(X.transpose(1, 0, 2))
    Yf = W @ Xf
    theirs = jax.jit(jax_sharded.auxiva_ip_step_binsmajor)(
        jnp.asarray(Xf), jnp.asarray(W), jnp.asarray(Yf), jax_cov.pair_products(jnp.asarray(X))
    )
    ours = port_parallel.auxiva_ip_step_binsmajor(_t(Xf), _t(W), _t(Yf), port_cov.pair_products(_t(X)))
    for a, b in zip(ours, theirs):
        np.testing.assert_allclose(to_np(a), np.asarray(b), atol=1e-10, rtol=1e-12)


def _stacked(seed, batch=None, C=2, F=17, T=24):
    X = _mixture(seed, C=C, F=F, T=T, batch=batch)
    W = _filters(seed + 1, F, C) if batch is None else np.stack([_filters(seed + 1 + b, F, C) for b in range(batch)])
    axis = 0 if batch is None else 1
    return np.stack([X.real, X.imag], axis=axis), np.stack([W.real, W.imag], axis=axis)


def test_auxiva_ip_step_stacked_matches_jax():
    X2, W2 = _stacked(11)
    theirs = jax.jit(jax_sharded.auxiva_ip_step_stacked)(jnp.asarray(X2), jnp.asarray(W2))
    ours = port_parallel.auxiva_ip_step_stacked(_t(X2), _t(W2))
    for a, b in zip(ours, theirs):
        np.testing.assert_allclose(to_np(a), np.asarray(b), atol=1e-10, rtol=1e-12)


def test_batched_auxiva_ip_step_matches_jax_and_the_single_steps():
    X2, W2 = _stacked(12, batch=3)
    W_j, nll_j = jax.jit(jax_sharded.batched_auxiva_ip_step)(jnp.asarray(X2), jnp.asarray(W2))
    W_p, nll_p = port_parallel.batched_auxiva_ip_step(_t(X2), _t(W2))
    assert W_p.shape == (3, 2, 17, 2, 2) and nll_p.shape == (3,)
    np.testing.assert_allclose(to_np(W_p), np.asarray(W_j), atol=1e-10)
    np.testing.assert_allclose(to_np(nll_p), np.asarray(nll_j), rtol=1e-12)
    for b in range(3):
        W_b, nll_b = port_parallel.auxiva_ip_step_stacked(_t(X2[b]), _t(W2[b]))
        np.testing.assert_allclose(to_np(W_p[b]), to_np(W_b), atol=1e-10)
        np.testing.assert_allclose(float(nll_p[b]), float(nll_b), rtol=1e-12)


# --------------------------------------------------------------------------- #
# batch_separate
# --------------------------------------------------------------------------- #
def _power_targets(seed, batch=2, F=17, T=24):
    rng = np.random.RandomState(seed)
    return np.abs(rng.randn(batch, F, 3)) @ np.abs(rng.randn(batch, 3, T)) + 0.01


# name -> (JAX solver, port solver, inputs); the family of each: IVA (the
# benchmarks' AuxLaplaceIVA IP, and ISS), ILRMA (the benchmarks' GaussILRMA,
# TILRMA), MNMF (the benchmarks' FastMNMF, Sawada, Ozerov), the
# factorisation models (EUCNMF on real targets), Prox, block-PSD (Kondo)
FAMILIES = {
    "laplace_ip": (lambda: jax_models.AuxLaplaceIVA(), lambda: port.AuxLaplaceIVA(device="cpu"), None),
    "laplace_iss": (
        lambda: jax_models.AuxLaplaceIVA(algorithm_spatial="ISS"),
        lambda: port.AuxLaplaceIVA(algorithm_spatial="ISS", device="cpu"),
        None,
    ),
    "gauss_ilrma": (lambda: jax_models.GaussILRMA(n_basis=2), lambda: port.GaussILRMA(n_basis=2, device="cpu"), None),
    "t_ilrma": (lambda: jax_models.TILRMA(n_basis=2), lambda: port.TILRMA(n_basis=2, device="cpu"), None),
    "fast_mnmf": (
        lambda: jax_models.FastMultichannelISNMF(n_basis=2),
        lambda: port.FastMultichannelISNMF(n_basis=2, device="cpu"),
        None,
    ),
    "sawada": (
        lambda: jax_models.MultichannelISNMF(n_basis=2),
        lambda: port.MultichannelISNMF(n_basis=2, device="cpu"),
        None,
    ),
    "ozerov": (
        lambda: jax_models.MultichannelISNMF(n_basis=2, author="Ozerov"),
        lambda: port.MultichannelISNMF(n_basis=2, author="Ozerov", device="cpu"),
        None,
    ),
    "eucnmf": (lambda: jax_models.EUCNMF(n_basis=2), lambda: port.EUCNMF(n_basis=2, device="cpu"), _power_targets),
    "prox": (lambda: jax_models.ProxLaplaceIVA(), lambda: port.ProxLaplaceIVA(device="cpu"), None),
    "ipsdta_kondo": (
        lambda: jax_models.GaussIPSDTA(n_basis=2, n_blocks=4),
        lambda: port.GaussIPSDTA(n_basis=2, n_blocks=4, device="cpu"),
        None,
    ),
}  # fmt: skip


def _inputs(name, batch=2):
    make_inputs = FAMILIES[name][2]
    return make_inputs(20) if make_inputs else _mixture(20, F=9, T=16, batch=batch)


def _outputs_close(ours, theirs, atol=1e-8):
    if isinstance(theirs, tuple):
        assert isinstance(ours, tuple) and len(ours) == len(theirs)
        for a, b in zip(ours, theirs):
            _outputs_close(a, b, atol)
        return
    assert ours.shape == np.shape(theirs)
    np.testing.assert_allclose(to_np(ours), np.asarray(theirs), atol=atol)


def _losses_close(name, ours, theirs):
    # the JAX package's Sawada loss holds the rounding noise of a rank-1
    # log-determinant (tests/_torch_port.py::jax_sawada_losses), a constant
    # of the data at 4e-7 of the loss at C = 2: its increments are held
    first_rtol = 1e-6 if name == "sawada" else None
    for a, b in zip(ours, theirs):
        assert_losses_match(a, b, rtol=1e-10, first_rtol=first_rtol)


@functools.lru_cache(maxsize=None)
def _jax_batch(name):
    warnings.simplefilter("ignore")
    np.random.seed(111)
    return jax_parallel.batch_separate(FAMILIES[name][0](), _inputs(name), iteration=ITERATIONS)


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_batch_separate_matches_jax(name):
    outputs_j, losses_j = _jax_batch(name)
    np.random.seed(111)
    outputs, losses = port_parallel.batch_separate(FAMILIES[name][1](), _inputs(name), iteration=ITERATIONS)
    assert isinstance(losses, np.ndarray) and losses.shape == (2, ITERATIONS)
    _outputs_close(outputs, outputs_j)
    _losses_close(name, losses, losses_j)


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_batch_separate_matches_per_example_calls(name):
    """Each member equals its own call: the per-example inits come from
    one seed in example order, and the losses are the call's after the
    pre-loop one."""
    inputs = _inputs(name)
    np.random.seed(111)
    outputs, losses = port_parallel.batch_separate(FAMILIES[name][1](), inputs, iteration=ITERATIONS)
    np.random.seed(111)
    solver = FAMILIES[name][1]()
    for b in range(len(inputs)):
        solver.loss = []
        out = solver(inputs[b], iteration=ITERATIONS)
        _outputs_close(tuple(o[b] for o in outputs) if isinstance(outputs, tuple) else outputs[b],
                       tuple(map(to_np, out)) if isinstance(out, tuple) else to_np(out))
        _losses_close(name, [losses[b]], [solver.loss[-ITERATIONS:]])


@pytest.mark.parametrize("make", [port.NaturalGradLaplaceFDICA, port.GradLaplaceFDICA])
def test_batch_separate_fdica_aligns_as_its_call(make):
    """FDICA's permutation alignment runs in the port's ``finalize``, so each
    member equals its own call, and the JAX package's own call (JAX's
    batch_separate skips the alignment, ROADMAP.md section 3)."""
    inputs = _mixture(21, F=9, T=16, batch=2)
    outputs, losses = port_parallel.batch_separate(make(device="cpu"), inputs, iteration=ITERATIONS)
    reference = getattr(jax_models, make.__name__)()
    for b in range(2):
        theirs = reference(inputs[b], iteration=ITERATIONS)
        np.testing.assert_allclose(outputs[b], np.asarray(theirs), atol=1e-8)
        np.testing.assert_allclose(losses[b], reference.loss[-ITERATIONS:], rtol=1e-10)
        reference.loss = []


def test_batch_separate_idlma_reads_its_network_attribute():
    """GaussIDLMA's network is the ``dnn`` attribute its call sets."""
    inputs = _mixture(22, F=9, T=16, batch=2)

    class Oracle(torch.nn.Module):
        def forward(self, x):
            return torch.sqrt(torch.abs(x) + 1.0)

    solver = port.GaussIDLMA(device="cpu")
    solver.dnn = port.torch_dnn(Oracle())
    outputs, losses = port_parallel.batch_separate(solver, inputs, iteration=ITERATIONS)
    for b in range(2):
        single = port.GaussIDLMA(device="cpu")
        out = single(inputs[b], iteration=ITERATIONS, dnn=port.torch_dnn(Oracle()))
        np.testing.assert_allclose(outputs[b], to_np(out), atol=1e-8)
        np.testing.assert_allclose(losses[b], single.loss[-ITERATIONS:], rtol=1e-10)


def test_batch_separate_warm_starts_from_stacked_jax_states(tmp_path):
    """Warm-start kwargs with a leading batch axis: a stack of
    ``state_from_jax`` dicts of JAX checkpoints resumes each member as the
    JAX run would."""
    inputs = _mixture(23, F=9, T=16, batch=2)
    states, resumed = [], []
    for b in range(2):
        np.random.seed(111 + b)
        first = jax_models.GaussILRMA(n_basis=2)
        first(inputs[b], iteration=2)
        first.save_state(tmp_path / "ilrma_{}.npz".format(b))
        states.append(state_from_jax(tmp_path / "ilrma_{}.npz".format(b), device="cpu"))
        second = jax_models.GaussILRMA(n_basis=2)
        resumed.append((np.asarray(second(inputs[b], iteration=ITERATIONS, **second.load_state(
            tmp_path / "ilrma_{}.npz".format(b)))), second.loss[-ITERATIONS:]))
    stacked = {k: torch.stack([s[k] for s in states]) for k in states[0]}
    outputs, losses = port_parallel.batch_separate(
        port.GaussILRMA(n_basis=2, device="cpu"), inputs, iteration=ITERATIONS, state_kwargs=stacked
    )
    for b in range(2):
        np.testing.assert_allclose(outputs[b], resumed[b][0], atol=1e-8)
        np.testing.assert_allclose(losses[b], resumed[b][1], rtol=1e-10)


def test_batch_separate_device_outputs_and_no_losses():
    inputs = _mixture(24, F=9, T=16, batch=2)
    outputs, losses = port_parallel.batch_separate(
        port.AuxLaplaceIVA(recordable_loss=False, device="cpu"), torch.as_tensor(inputs), iteration=2, host=False
    )
    assert losses is None
    assert isinstance(outputs, torch.Tensor) and outputs.shape == (2, 2, 9, 16)
    assert outputs.dtype == torch.complex128 and outputs.device.type == "cpu"


def test_batch_separate_world_one_mesh_matches_unmeshed(tmp_path):
    """A world-size-1 gloo ``(1, 1)`` mesh: one member block over ``dp``,
    each member sharded over a one-rank ``tp``; the result is the unmeshed
    one."""
    import torch.distributed as dist

    inputs = _mixture(25, F=9, T=16, batch=2)
    np.random.seed(111)
    expected = port_parallel.batch_separate(port.GaussILRMA(n_basis=2, device="cpu"), inputs, iteration=ITERATIONS)
    dist.init_process_group("gloo", init_method="file://{}".format(tmp_path / "store"), rank=0, world_size=1)
    try:
        mesh = port_parallel.make_mesh_2d(device_type="cpu")
        assert mesh.mesh_dim_names == ("dp", "tp") and tuple(mesh.shape) == (1, 1)
        np.random.seed(111)
        solver = port.GaussILRMA(n_basis=2, device="cpu")
        outputs, losses = port_parallel.batch_separate(solver, inputs, iteration=ITERATIONS, mesh=mesh, host=False)
    finally:
        dist.destroy_process_group()
    assert solver._mesh is None  # the member's tp mesh is not left on the solver
    np.testing.assert_allclose(to_np(outputs), expected[0], atol=1e-12)
    np.testing.assert_allclose(to_np(losses), expected[1], rtol=1e-12)


def test_dryrun_multichip_world_two_cpu():
    """``tools/dryrun_multichip.py --world-size 2 --device cpu``: every stage
    runs on two gloo ranks and comes out finite."""
    import json
    import subprocess
    import sys

    result = subprocess.run(
        [sys.executable, "-m", "audio_source_separation_tpu_torch.tools.dryrun_multichip", "--world-size", "2",
         "--device", "cpu"],
        capture_output=True, text=True, timeout=300,
    )  # fmt: skip
    assert result.returncode == 0, result.stderr[-4000:]
    report = json.loads(result.stdout.strip().splitlines()[-1])["dryrun_multichip"]
    assert (report["dp"], report["tp"], report["backend"]) == (1, 2, "gloo")
    assert set(report["stages"]) == {
        "train_step", "gauss_ilrma_bins", "auxiva_ip_pad_bins", "gauss_ipsdta_bins", "auxiva_ip_frames",
        "batch_separate_dp_tp",
    }  # fmt: skip
    assert report["stages"]["auxiva_ip_pad_bins"]["shape"] == [2, 33, 48]
