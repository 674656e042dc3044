"""The port's mesh runtime on gloo CPU ranks, at world sizes 2, 3 and 4 (a
2 x 2 ``("dp", "tp")`` mesh), float64.

Each world size is spawned once for the module (its ranks run
``tests/_torch_mesh_worker.py``, which imports only torch, numpy and the
port, over a ``file://`` store in a fresh temporary directory) and writes
every case's results to files; the tests below hold them one by one:

  * every sharded run equals the same port call unsharded (losses rtol
    1e-10, output 1e-10 of its largest entry) on every rank, and the padded
    calls crop to the input's bins;
  * the collective pattern, from the counters: no all-gather inside the
    loop (but for the callbacks, which see the state gathered whole every
    iteration, and GaussIDLMA's variance network in bins mode, which sees
    its input gathered whole once an iteration), at least one all-reduce an
    iteration (none where nothing shards: FDICA, LDPSDTF's bins mode), and
    exactly one where an iteration is one K2 launch (AuxIVA-IP at C = 2 in
    bins mode);
  * the cases that must raise do;
  * the counterparts of ``tests/test_mesh_runtime.py``'s cases (IVA,
    ILRMA, IPSDTA and its source routes, the MNMF and NMF families,
    IDLMA, ProxLaplaceIVA, LDPSDTF) against the JAX package's
    ``use_mesh`` on as many of the 8 virtual CPU devices, at each family's
    parity tolerance, at small shapes.
"""

import os
import subprocess
import sys
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

import audio_source_separation_tpu as jax_package
import audio_source_separation_tpu.models as jax_models
import audio_source_separation_tpu_torch as port

import _torch_mesh_worker as worker

WORKER = Path(worker.__file__)
MATCH = [(name, w) for name, case in worker.CASES.items() if case["raises"] is None for w in case["worlds"]]
RAISE = [(name, w) for name, case in worker.CASES.items() if case["raises"] is not None for w in case["worlds"]]
# one K2 launch, and so one all-reduce, an iteration
K2_CASES = {"iva_ip_bins", "iva_gauss_bins", "iva_gauss_floor_bins", "iva_pad_ip", "iva_pad_warm"}
# nothing of the solver shards: no collective at all
REPLICATED = {"fdica_bins", "ldpsdtf_bins"}
# the variance network mixes the frequencies: its input is gathered whole
# along the bins once an iteration
GATHER_IN_LOOP = {"idlma_bins", "idlma_svd_bins"}
# the counterparts of tests/test_mesh_runtime.py held against JAX's use_mesh
JAX_CASES = [
    ("iva_ip_bins", 3),
    ("iva_ip_frames", 2),
    ("iva_gauss_bins", 2),
    ("iva_gauss_floor_bins", 2),
    ("ilrma_bins", 3),
    ("ilrma_frames", 2),
    ("iva_pad_ip", 2),
    ("iva_pad_ip2", 2),
    ("iva_pad_warm", 2),
    ("ilrma_pad", 2),
    ("ipsdta_kondo_bins", 2),
    ("ipsdta_kondo_frames", 2),
    ("ipsdta_ikeshita_bins", 2),
    ("fastmnmf_bins", 3),  # test_mesh_runtime.py:105
    ("sawada_bins", 3),  # :261
    ("sawada_frames", 2),
    ("ozerov_bins", 2),  # :269
    ("fastmnmf_frames", 2),  # :286
    ("ipsdta_kondo_planes_bins", 2),  # :314, with source_compact=False
    ("ipsdta_ikeshita_planes_frames", 2),
    ("ipsdta_ikeshita_frames", 2),  # :333, the compact route
    ("cov_isnmf_bins", 2),  # :362
    ("cov_isnmf_frames", 2),
    ("idlma_bins", 3),  # :411
    ("idlma_frames", 2),
    ("prox_bins", 3),  # :429
    ("prox_frames", 2),
    ("isnmf_bins", 3),  # :438
    ("isnmf_frames", 2),
    ("complex_eucnmf_bins", 3),  # :504
    ("complex_eucnmf_frames", 2),
    ("ldpsdtf_frames", 3),  # :528
]
# the losses that hold log(w + eps) of the rank-1 observed covariances'
# eigenvalues (Sawada's MNMF, CovarianceISNMF): a closed form returns the zero
# eigenvalue as rounding noise of about 1e-16 of the largest, which moves
# log(w + eps) by noise / eps.  The JAX package takes both from closed forms,
# the port CovarianceISNMF's from its own and Sawada's as exactly 0, so the
# two packages (and the JAX package's sharded frame sums of CovarianceISNMF's
# scale) leave an offset that the iterations do not change, about 1e-7 of the
# loss here (the JAX package's own mesh test holds that case at rtol 1e-6).
# These compare the trajectory less its offset at rtol 1e-9 and bound the
# offset by 1e-6 of the loss
DATA_LOGDET_OFFSET = {"sawada_bins", "sawada_frames", "cov_isnmf_bins", "cov_isnmf_frames"}


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """``spawned(world)``: the results directory of that world size's one
    spawn of ranks."""
    done = {}

    def results(world):
        if world not in done:
            out = tmp_path_factory.mktemp("mesh{}".format(world))
            command = [sys.executable, str(WORKER), "--world-size", str(world), "--store", str(out / "store")]
            env = dict(os.environ, GLOO_SOCKET_IFNAME="lo")  # the ranks meet on the loopback device
            procs = [
                subprocess.Popen(
                    command + ["--rank", str(r), "--out", str(out)],
                    stdout=subprocess.PIPE,
                    stderr=subprocess.PIPE,
                    text=True,
                    env=env,
                )
                for r in range(world)
            ]
            errors = []
            for rank, proc in enumerate(procs):
                try:
                    _, err = proc.communicate(timeout=120)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    _, err = proc.communicate()
                if proc.returncode != 0:
                    errors.append("rank {} exited {}:\n{}".format(rank, proc.returncode, err[-4000:]))
            assert not errors, "\n".join(errors)
            done[world] = out
        return done[world]

    return results


def _load(out, name, rank=0):
    with np.load(out / "{}.rank{}.npz".format(name, rank)) as data:
        return {k: data[k] for k in data.files}


def _ids(pairs):
    return ["{}-w{}".format(name, world) for name, world in pairs]


def _assert_output(ours, ref, rel=1e-10):
    np.testing.assert_allclose(ours, ref, rtol=0, atol=rel * np.abs(ref).max())


def _outputs(result, prefix="output"):
    """The output of a case (the factors of a factor model) as a list."""
    return [result["{}{}".format(prefix, i)] for i in range(int(result["n_outputs"]))]


@pytest.mark.parametrize("name,world", MATCH, ids=_ids(MATCH))
def test_sharded_matches_unsharded(spawned, name, world):
    out = spawned(world)
    result = _load(out, name)
    for ours, ref in zip(_outputs(result), _outputs(result, "single_output")):
        _assert_output(ours, ref)
    if name.startswith("ilrma_pad"):
        # padded bins add an iteration-independent log(eps) constant
        offsets = result["loss"] - result["single_loss"]
        np.testing.assert_allclose(offsets, offsets[0], rtol=0, atol=1e-10 * np.abs(result["single_loss"]).max())
    else:
        np.testing.assert_allclose(result["loss"], result["single_loss"], rtol=1e-10)
    for rank in range(1, world):
        other = _load(out, name, rank)
        for theirs, ours in zip(_outputs(other), _outputs(result)):
            np.testing.assert_array_equal(theirs, ours)
        np.testing.assert_array_equal(other["loss"], result["loss"])


@pytest.mark.parametrize("name,world", MATCH, ids=_ids(MATCH))
def test_collective_pattern(spawned, name, world):
    result = _load(spawned(world), name)
    if worker.CASES[name]["callbacks"]:  # callbacks see the state published whole every iteration
        assert result["all_gather_per_iteration"] >= 1
    elif name in GATHER_IN_LOOP:
        assert result["all_gather_per_iteration"] == 1
    else:
        assert result["all_gather_per_iteration"] == 0, "a sharded field was gathered inside the loop"
    if name in REPLICATED:
        assert result["all_reduce"] == result["all_gather"] == 0
    elif name in K2_CASES:
        assert result["all_reduce_per_iteration"] == 1
    else:
        assert result["all_reduce_per_iteration"] >= 1


@pytest.mark.parametrize("name,world", MATCH, ids=_ids(MATCH))
def test_published_geometry(spawned, name, world):
    """Output and attributes have the input's geometry, padded calls too;
    a factor model's factors have the unsharded call's shapes."""
    case, result = worker.CASES[name], _load(spawned(world), name)
    outputs = _outputs(result)
    assert [o.shape for o in outputs] == [o.shape for o in _outputs(result, "single_output")]
    assert tuple(result["estimation_shape"]) == outputs[0].shape
    if case["input"] != "mixture":
        assert tuple(result["input_shape"]) == worker.case_input(case).shape
        return
    C, F, T = case["shape"]
    N = case["solver"][1].get("n_sources", C)
    assert outputs[0].shape == (N, F, T)
    assert tuple(result["input_shape"])[1:] == (F, T)
    if result["demix_filter_shape"].size:
        assert tuple(result["demix_filter_shape"])[:2] == (F, N)


@pytest.mark.parametrize("name,world", RAISE, ids=_ids(RAISE))
def test_mesh_raises(spawned, name, world):
    kind, message = worker.CASES[name]["raises"]
    result = _load(spawned(world), name)
    assert str(result["error_type"]) == kind
    assert message in str(result["error"])


def test_shard_spectrogram_pads_and_cuts(spawned):
    """Each rank holds its zero-padded share of the bins; together they are
    the JAX function's padded array, and the true bin count comes back."""
    from audio_source_separation_tpu.parallel import shard_spectrogram

    out = spawned(2)
    shards = [_load(out, "shard_spectrogram", rank) for rank in range(2)]
    assert [tuple(r["shard"].shape) for r in shards] == [(2, 13, 18)] * 2
    assert all(int(r["n_bins"]) == 25 for r in shards)
    theirs, n_bins = shard_spectrogram(worker.mixture((2, 25, 18)), _jax_mesh(2, "bins"))
    assert n_bins == 25
    np.testing.assert_array_equal(np.concatenate([r["shard"] for r in shards], axis=1), np.asarray(theirs))
    assert "the process group has 2 ranks" in str(shards[0]["make_mesh_error"])


@pytest.mark.parametrize("name", [n for n, case in worker.CASES.items() if case["callbacks"]])
def test_callbacks_see_the_whole_state(spawned, name):
    """With callbacks every iteration publishes the state gathered whole:
    the callbacks see the input's geometry and the losses so far."""
    case, result = worker.CASES[name], _load(spawned(2), name)
    C, F, T = case["shape"]
    seen = result["seen"]
    assert len(seen) == case["iteration"] + 1  # after init and each iteration
    np.testing.assert_array_equal(seen[:, :5], np.tile([F, C, C, C, F], (len(seen), 1)))
    np.testing.assert_array_equal(seen[:, 5:], [[T, k + 1] for k in range(len(seen))])


def test_batch_separate_indivisible_batch_raises(spawned):
    result = _load(spawned(4), "batch_separate")
    assert "a batch of 3 does not divide by the 2-way 'dp' axis" in str(result["indivisible_error"])


def test_batch_separate_dp_tp_matches_unmeshed(spawned):
    out = spawned(4)
    result = _load(out, "batch_separate")
    for name, _ in worker.BATCH["solvers"]:
        _assert_output(result[name + "_output"], result[name + "_single_output"])
        np.testing.assert_allclose(result[name + "_loss"], result[name + "_single_loss"], rtol=1e-10)
        for rank in range(1, 4):
            np.testing.assert_array_equal(_load(out, "batch_separate", rank)[name + "_output"], result[name + "_output"])


def test_sharded_train_step_matches_batched_step(spawned):
    """``make_sharded_train_step`` on the 2 x 2 mesh: every rank returns the
    whole ``(W2, nll)`` of the unsharded batched step; one all-reduce of the
    frame powers and one of the NLL's sums over ``tp``, and the gathers of
    ``W`` over both dimensions and of the NLL over ``dp``."""
    out = spawned(4)
    result = _load(out, "train_step")
    _assert_output(result["W"], result["single_W"])
    np.testing.assert_allclose(result["nll"], result["single_nll"], rtol=1e-10)
    assert list(result["x_spec"]) == ["dp", "None", "None", "tp", "None"]
    assert list(result["w_spec"]) == ["dp", "None", "tp", "None", "None"]
    assert (int(result["all_reduce"]), int(result["all_gather"])) == (2, 3)
    for rank in range(1, 4):
        np.testing.assert_array_equal(_load(out, "train_step", rank)["W"], result["W"])


def test_sharded_train_step_matches_jax(spawned):
    from audio_source_separation_tpu.parallel.sharded import make_mesh_2d, make_sharded_train_step

    result = _load(spawned(4), "train_step")
    mesh = make_mesh_2d(4)
    step, x_sharding, w_sharding = make_sharded_train_step(mesh)
    X2, W2 = worker.train_step_inputs()
    W_new, nll = step(jax.device_put(X2, x_sharding), jax.device_put(W2, w_sharding))
    np.testing.assert_allclose(result["W"], np.asarray(W_new), atol=1e-10)
    np.testing.assert_allclose(result["nll"], np.asarray(nll), rtol=1e-10)


def _jax_mesh(world, axis="bins"):
    return Mesh(np.array(jax.devices()[:world]), axis_names=(axis,))


def _jax_dnn(n_bins):
    """The worker's variance network on JAX arrays (``worker.torch_dnn``)."""
    W1, W2 = (jnp.asarray(w) for w in worker.dnn_weights(n_bins))

    def dnn(amp):
        h = jnp.maximum(jnp.einsum("sft,fh->sht", amp, W1), 0.0)
        return jnp.maximum(jnp.einsum("sht,hf->sft", h, W2), 1e-3)

    return dnn


@pytest.mark.parametrize("name,world", JAX_CASES, ids=_ids(JAX_CASES))
def test_sharded_matches_jax_use_mesh(spawned, name, world):
    case, result = worker.CASES[name], _load(spawned(world), name)
    np.random.seed(worker.SEED)
    cls, kwargs = case["solver"]
    solver = worker.make_solver(jax_models, (cls, dict(kwargs, jax_dnn=True) if case["dnn"] else kwargs), case["attrs"])
    solver.use_mesh(_jax_mesh(world), mode=case["mode"], pad_bins=case["pad"])
    call = worker.call_kwargs(case, dnn=_jax_dnn(case["shape"][1]) if case["dnn"] else None)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        ref = solver(worker.case_input(case), iteration=case["iteration"], **call)
    theirs = np.asarray(solver.loss)
    if name in DATA_LOGDET_OFFSET:
        offsets = result["loss"] - theirs
        assert np.abs(offsets[0]) <= 1e-6 * np.abs(theirs).max()
        np.testing.assert_allclose(offsets, offsets[0], rtol=0, atol=1e-9 * np.abs(theirs).max())
    else:
        np.testing.assert_allclose(result["loss"], theirs, rtol=1e-9)
    refs = [np.asarray(r) for r in (ref if isinstance(ref, tuple) else (ref,))]
    assert len(refs) == int(result["n_outputs"])
    for ours, theirs in zip(_outputs(result), refs):
        if name.startswith(("ipsdta", "ldpsdtf")):
            np.testing.assert_allclose(ours, theirs, rtol=1e-9, atol=1e-12 * np.abs(theirs).max())
        else:
            np.testing.assert_allclose(ours, theirs, atol=1e-8)


def test_batch_separate_dp_tp_matches_jax(spawned):
    result = _load(spawned(4), "batch_separate")
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), axis_names=("dp", "tp"))
    for name, kwargs in worker.BATCH["solvers"]:
        np.random.seed(worker.SEED)
        outputs, losses = jax_package.parallel.batch_separate(
            worker.make_solver(jax_models, (name, kwargs)), worker.mixture(worker.BATCH["shape"]),
            iteration=worker.BATCH["iteration"], mesh=mesh,
        )  # fmt: skip
        np.testing.assert_allclose(result[name + "_output"], outputs, atol=1e-8)
        np.testing.assert_allclose(result[name + "_loss"], np.asarray(losses), rtol=1e-9)


def test_use_mesh_mode_raises():
    with pytest.raises(ValueError, match="mode"):
        port.AuxLaplaceIVA(device="cpu").use_mesh(None, mode="channels")
