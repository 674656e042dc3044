"""Rank worker of ``tests/test_torch_mesh.py``: one gloo rank on the CPU that
runs every mesh case of its world size and writes each case's results to
``<out>/<case>.rank<r>.npz``.

    python tests/_torch_mesh_worker.py --rank R --world-size N --store FILE --out DIR

World size 4 runs on a ``("dp", "tp")`` mesh of 2 x 2; the solvers shard over
``"tp"``.  Each case runs the solver sharded, at two iteration counts (the
collective counters' difference is the per-iteration pattern), and rank 0
runs it unsharded too.  A case that must raise records the exception.
Imports only torch, numpy and the port.
"""

import argparse
import sys
import traceback
import warnings
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import audio_source_separation_tpu_torch as port  # noqa: E402
from audio_source_separation_tpu_torch.parallel import mesh as port_mesh  # noqa: E402

SEED = 111
# each case: the solver (class name in both packages, keywords), the mixture
# (C, F, T), the mode, pad_bins, iterations, the world sizes it runs at, a
# warm start, and what it raises where it must
IPSDTA = {"n_basis": 2, "n_blocks": 16, "spatial_iteration": 2}
IPSDTA_B4 = {"n_basis": 2, "n_blocks": 8, "spatial_iteration": 2}
CASES = {
    "iva_ip_bins": dict(solver=("AuxLaplaceIVA", {}), mode="bins", worlds=(2, 3, 4)),
    "iva_ip_frames": dict(solver=("AuxLaplaceIVA", {}), mode="frames", worlds=(2, 3, 4)),
    # the 2 x 2 mesh sharded over its other dimension, named
    "iva_ip_frames_dp_axis": dict(solver=("AuxLaplaceIVA", {}), mode="frames", worlds=(4,), axis="dp"),
    "iva_gauss_bins": dict(solver=("AuxGaussIVA", {}), mode="bins", worlds=(2, 3)),
    "iva_gauss_frames": dict(solver=("AuxGaussIVA", {}), mode="frames", worlds=(2,)),
    # the floor of R = psum / F is active on many frames, so the weights
    # depend on F itself and not only up to a scale
    "iva_gauss_floor_bins": dict(solver=("AuxGaussIVA", {"eps": 3.0}), mode="bins", worlds=(2, 3)),
    "iva_c3_bins": dict(solver=("AuxLaplaceIVA", {}), shape=(3, 24, 18), mode="bins"),
    "iva_c3_frames": dict(solver=("AuxGaussIVA", {}), shape=(3, 24, 18), mode="frames"),
    "iva_svd_bins": dict(solver=("AuxLaplaceIVA", {"guard": "svd"}), mode="bins"),
    "iva_svd_frames": dict(solver=("AuxGaussIVA", {"guard": "svd"}), mode="frames"),
    "iva_ip2_bins": dict(solver=("AuxLaplaceIVA", {"algorithm_spatial": "IP2"}), mode="bins"),
    "iva_ip2_frames": dict(solver=("AuxLaplaceIVA", {"algorithm_spatial": "IP2"}), mode="frames"),
    "iva_iss_bins": dict(solver=("AuxLaplaceIVA", {"algorithm_spatial": "ISS"}), mode="bins"),
    "iva_iss_frames": dict(solver=("AuxGaussIVA", {"algorithm_spatial": "ISS"}), mode="frames"),
    "iva_grad_bins": dict(solver=("GradLaplaceIVA", {}), mode="bins"),
    "iva_grad_frames": dict(solver=("GradLaplaceIVA", {}), mode="frames"),
    "iva_natgrad_bins": dict(solver=("NaturalGradLaplaceIVA", {}), mode="bins"),
    "iva_natgrad_c5_frames": dict(solver=("NaturalGradLaplaceIVA", {}), shape=(5, 24, 18), mode="frames"),
    "iva_natgrad_frames": dict(solver=("NaturalGradLaplaceIVA", {}), mode="frames"),
    "iva_grad_c5_bins": dict(solver=("GradLaplaceIVA", {}), shape=(5, 24, 18), mode="bins"),
    "iva_callbacks_bins": dict(solver=("AuxLaplaceIVA", {}), mode="bins", callbacks=True),
    "iva_callbacks_frames": dict(solver=("AuxLaplaceIVA", {"algorithm_spatial": "ISS"}), mode="frames",
                                 callbacks=True),  # fmt: skip
    "iva_overaux_frames": dict(solver=("OverAuxLaplaceIVA", {"algorithm_spatial": "IP", "n_sources": 2}), shape=(3, 24, 18), mode="frames"),
    "iva_indivisible_raise": dict(solver=("AuxLaplaceIVA", {}), shape=(2, 25, 18), mode="bins",
                                  raises=("ValueError", "not divisible")),  # fmt: skip
    "iva_pad_ip": dict(solver=("AuxLaplaceIVA", {}), shape=(2, 25, 18), mode="bins", pad=True, worlds=(2, 3)),
    "iva_pad_ip2": dict(solver=("AuxLaplaceIVA", {"algorithm_spatial": "IP2"}), shape=(2, 25, 18), mode="bins",
                        pad=True),  # fmt: skip
    "iva_pad_warm": dict(solver=("AuxLaplaceIVA", {}), shape=(2, 25, 18), mode="bins", pad=True, warm=True),
    "iva_pad_raise": dict(solver=("AuxLaplaceIVA", {"algorithm_spatial": "ISS"}), shape=(2, 25, 18), mode="bins",
                          pad=True, raises=("ValueError", "does not support")),  # fmt: skip
    "fdica_bins": dict(solver=("GradLaplaceFDICA", {}), mode="bins"),
    "ilrma_bins": dict(solver=("GaussILRMA", {"n_basis": 4}), mode="bins", worlds=(2, 3)),
    "ilrma_frames": dict(solver=("GaussILRMA", {"n_basis": 4}), mode="frames", worlds=(2, 3)),
    "ilrma_pad": dict(solver=("GaussILRMA", {"n_basis": 3}), shape=(2, 25, 18), mode="bins", pad=True),
    "ilrma_ip2_frames": dict(solver=("GaussILRMA", {"n_basis": 3, "algorithm_spatial": "IP2"}), mode="frames"),
    "ilrma_ip2_bins": dict(solver=("GaussILRMA", {"n_basis": 3, "algorithm_spatial": "IP2"}), mode="bins"),
    "ilrma_iss_frames": dict(solver=("GaussILRMA", {"n_basis": 3, "algorithm_spatial": "ISS"}), mode="frames"),
    "ilrma_domain1_frames": dict(solver=("GaussILRMA", {"n_basis": 3, "domain": 1}), mode="frames"),
    "ilrma_pad_ip2": dict(solver=("GaussILRMA", {"n_basis": 3, "algorithm_spatial": "IP2"}), shape=(2, 25, 18),
                          mode="bins", pad=True),  # fmt: skip
    "ilrma_pad_partition": dict(solver=("GaussILRMA", {"n_basis": 3, "partitioning": True}), shape=(2, 25, 18),
                                mode="bins", pad=True),  # fmt: skip
    "ilrma_pb_bins": dict(solver=("GaussILRMA", {"n_basis": 3, "normalize": "projection-back"}), mode="bins"),
    "ilrma_iss_bins": dict(solver=("GaussILRMA", {"n_basis": 3, "algorithm_spatial": "ISS"}), mode="bins"),
    "ilrma_partition_bins": dict(solver=("GaussILRMA", {"n_basis": 3, "partitioning": True}), mode="bins"),
    "ilrma_partition_frames": dict(solver=("GaussILRMA", {"n_basis": 3, "partitioning": True}), mode="frames"),
    "ilrma_pb_frames": dict(solver=("GaussILRMA", {"n_basis": 3, "normalize": "projection-back"}), mode="frames"),
    "tilrma_bins": dict(solver=("TILRMA", {"n_basis": 3, "nu": 10}), mode="bins"),
    "tilrma_frames": dict(solver=("TILRMA", {"n_basis": 3, "nu": 10}), mode="frames"),
    "consistent_frames": dict(solver=("ConsistentGaussILRMA", {"n_basis": 3, "fft_size": 46}), mode="frames"),
    "consistent_bins": dict(solver=("ConsistentGaussILRMA", {"n_basis": 3, "fft_size": 46}), mode="bins"),
    "ipsdta_kondo_bins": dict(solver=("GaussIPSDTA", IPSDTA), shape=(2, 32, 16), mode="bins", iteration=2),
    "ipsdta_kondo_frames": dict(solver=("GaussIPSDTA", IPSDTA), shape=(2, 32, 16), mode="frames", iteration=2),
    "ipsdta_ikeshita_bins": dict(solver=("GaussIPSDTA", dict(IPSDTA, author="Ikeshita")), shape=(2, 32, 16),
                                 mode="bins", iteration=2),  # fmt: skip
    "ipsdta_ikeshita_frames": dict(solver=("GaussIPSDTA", dict(IPSDTA, author="Ikeshita")), shape=(2, 32, 16),
                                   mode="frames", iteration=2),  # fmt: skip
    "ipsdta_kondo_b4_bins": dict(solver=("GaussIPSDTA", IPSDTA_B4), shape=(2, 32, 16), mode="bins", iteration=2),
    "ipsdta_kondo_b4_frames": dict(solver=("GaussIPSDTA", IPSDTA_B4), shape=(2, 32, 16), mode="frames",
                                   iteration=2),  # fmt: skip
    "ipsdta_ikeshita_b4_frames": dict(solver=("GaussIPSDTA", dict(IPSDTA_B4, author="Ikeshita")),
                                      shape=(2, 32, 16), mode="frames", iteration=2),  # fmt: skip
    "ipsdta_ikeshita_b4_bins": dict(solver=("GaussIPSDTA", dict(IPSDTA_B4, author="Ikeshita")), shape=(2, 32, 16),
                                    mode="bins", iteration=2),  # fmt: skip
    "tipsdta_bins": dict(solver=("TIPSDTA", IPSDTA), shape=(2, 32, 16), mode="bins", iteration=2),
    "tipsdta_frames": dict(solver=("TIPSDTA", IPSDTA), shape=(2, 32, 16), mode="frames", iteration=2),
    "tipsdta_b4_bins": dict(solver=("TIPSDTA", IPSDTA_B4), shape=(2, 32, 16), mode="bins", iteration=2),
    "tipsdta_b4_frames": dict(solver=("TIPSDTA", IPSDTA_B4), shape=(2, 32, 16), mode="frames", iteration=2),
    "ipsdta_misaligned_raise": dict(solver=("GaussIPSDTA", IPSDTA), shape=(2, 34, 16), mode="bins", iteration=1,
                                    raises=("ValueError", "whole blocks")),  # fmt: skip
}
for _case in CASES.values():
    _case.setdefault("shape", (2, 24, 18))
    _case.setdefault("pad", False)
    _case.setdefault("iteration", 4)
    _case.setdefault("worlds", (2,))
    _case.setdefault("warm", False)
    _case.setdefault("raises", None)
    _case.setdefault("callbacks", False)
    _case.setdefault("axis", None)
# batch_separate over dp x tp: solvers, members (C, F, T), iterations
BATCH = dict(solvers=(("AuxLaplaceIVA", {}), ("GaussILRMA", {"n_basis": 2})), shape=(4, 2, 24, 18), iteration=3)


def mixture(shape, seed=7):
    """A seeded complex mixture ``(C, F, T)`` (or a stack of them) with
    frame-varying source power."""
    rng = np.random.RandomState(seed)
    C, F, T = shape[-3:]
    lead = shape[:-3]
    S = rng.randn(*lead, C, F, T) * np.abs(rng.randn(*lead, C, 1, T)) + 1j * rng.randn(*lead, C, F, T)
    A = np.eye(C) + 0.5 * rng.rand(C, C)
    return np.einsum("cn,...nft->...cft", A, S)


def warm_filter(shape, seed=3):
    """A seeded warm-start demixing filter ``(F, C, C)`` near the identity."""
    C, F, _ = shape
    rng = np.random.RandomState(seed)
    return np.tile(np.eye(C), (F, 1, 1)) + 0.1j * rng.randn(F, C, C)


def make_solver(package, spec):
    name, kwargs = spec
    kwargs = dict(kwargs)
    if package is port:
        kwargs["device"] = "cpu"
    return getattr(package, name)(**kwargs)


def call_kwargs(case):
    return {"demix_filter": warm_filter(case["shape"])} if case["warm"] else {}


def _run(case, mesh, iteration):
    np.random.seed(SEED)
    solver = make_solver(port, case["solver"])
    if case["callbacks"]:
        # what a callback sees: the published attributes' shapes, the losses so far
        solver.seen = []
        solver.callbacks = [lambda s: s.seen.append([*s.demix_filter.shape, *s.estimation.shape, len(s.loss)])]
    if mesh is not None:
        solver.use_mesh(mesh, mode=case["mode"], axis_name=case["axis"], pad_bins=case["pad"])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        out = solver(mixture(case["shape"]), iteration=iteration, **call_kwargs(case))
    return solver, out


def _shape(x):
    """The shape of a published attribute (empty where there is none)."""
    return np.asarray(() if x is None else tuple(x.shape), dtype=np.int64)


def _numpy(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def run_case(case, mesh, rank):
    if case["raises"] is not None:
        try:
            _run(case, mesh, case["iteration"])
        except Exception as exc:  # recorded for the test to hold against case["raises"]
            return {"error_type": type(exc).__name__, "error": str(exc)}
        return {"error_type": "", "error": "did not raise"}
    n = case["iteration"]
    port_mesh.reset_collective_counts()
    solver, out = _run(case, mesh, n)
    first = port_mesh.collective_counts()
    port_mesh.reset_collective_counts()
    _run(case, mesh, n + 2)
    second = port_mesh.collective_counts()
    result = {
        "output": _numpy(out),
        "loss": np.asarray(solver.loss),
        "all_reduce": first["all_reduce"],
        "all_gather": first["all_gather"],
        "all_reduce_per_iteration": (second["all_reduce"] - first["all_reduce"]) / 2,
        "all_gather_per_iteration": (second["all_gather"] - first["all_gather"]) / 2,
        "demix_filter_shape": _shape(solver.demix_filter),
        "estimation_shape": _shape(solver.estimation),
        "input_shape": _shape(solver.input),
    }
    if case["callbacks"]:
        result["seen"] = np.asarray(solver.seen)
    if rank == 0:
        single, single_out = _run(case, None, n)
        result["single_output"], result["single_loss"] = _numpy(single_out), np.asarray(single.loss)
    return result


def run_batch(mesh, rank):
    inputs = mixture(BATCH["shape"])
    result = {}
    for name, kwargs in BATCH["solvers"]:
        for meshed in (True, False):
            if not meshed and rank != 0:
                continue
            np.random.seed(SEED)
            solver = make_solver(port, (name, kwargs))
            outputs, losses = port.parallel.batch_separate(
                solver, inputs, iteration=BATCH["iteration"], mesh=mesh if meshed else None
            )
            key = name + ("" if meshed else "_single")
            result[key + "_output"], result[key + "_loss"] = outputs, losses
    try:
        port.parallel.batch_separate(make_solver(port, BATCH["solvers"][0]), inputs[:3], iteration=1, mesh=mesh)
        result["indivisible_error"] = ""
    except ValueError as exc:
        result["indivisible_error"] = str(exc)
    return result


def train_step_inputs():
    """Stacked-real ``(X2, W2)`` of the sharded train step: 4 mixtures at
    ``(2, 24, 18)``, identity filters."""
    X = mixture((4, 2, 24, 18))
    X2 = np.stack([X.real, X.imag], axis=1)
    W2 = np.zeros((4, 2, 24, 2, 2))
    W2[:, 0] = np.eye(2)
    return X2, W2


def run_train_step(mesh):
    step, x_spec, w_spec = port.parallel.make_sharded_train_step(mesh)
    X2, W2 = (torch.as_tensor(a) for a in train_step_inputs())
    port_mesh.reset_collective_counts()
    W_new, nll = step(X2, W2)
    counts = port_mesh.collective_counts()
    W_ref, nll_ref = port.parallel.batched_auxiva_ip_step(X2, W2)
    return {
        "W": W_new.numpy(), "nll": nll.numpy(), "single_W": W_ref.numpy(), "single_nll": nll_ref.numpy(),
        "x_spec": np.asarray([str(a) for a in x_spec]), "w_spec": np.asarray([str(a) for a in w_spec]),
        "all_reduce": counts["all_reduce"], "all_gather": counts["all_gather"],
    }  # fmt: skip


def run_shard_spectrogram(mesh):
    """This rank's ``shard_spectrogram`` of a 25-bin mixture and the raise of
    a ``make_mesh`` whose device count is not the world's."""
    shard, n_bins = port.parallel.shard_spectrogram(mixture((2, 25, 18)), mesh, "bins")
    try:
        port.parallel.make_mesh(n_devices=dist.get_world_size() + 1, device_type="cpu")
        error = ""
    except ValueError as exc:
        error = str(exc)
    return {"shard": shard.numpy(), "n_bins": n_bins, "make_mesh_error": error}


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--rank", type=int, required=True)
    parser.add_argument("--world-size", type=int, required=True)
    parser.add_argument("--store", required=True)
    parser.add_argument("--out", required=True)
    args = parser.parse_args()
    torch.set_num_threads(1)
    world = args.world_size
    dist.init_process_group("gloo", init_method="file://" + args.store, rank=args.rank, world_size=world)
    try:
        if world == 4:
            mesh = port.parallel.make_mesh_2d(device_type="cpu")
        else:
            mesh = port.parallel.make_mesh(axis_name="bins", device_type="cpu")
        out = Path(args.out)
        if world == 2:
            np.savez(out / "shard_spectrogram.rank{}.npz".format(args.rank), **run_shard_spectrogram(mesh))
        for name, case in CASES.items():
            if world in case["worlds"]:
                np.savez(out / "{}.rank{}.npz".format(name, args.rank), **run_case(case, mesh, args.rank))
        if world == 4:
            np.savez(out / "batch_separate.rank{}.npz".format(args.rank), **run_batch(mesh, args.rank))
            np.savez(out / "train_step.rank{}.npz".format(args.rank), **run_train_step(mesh))
    except Exception:
        traceback.print_exc()
        raise
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
