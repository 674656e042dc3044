"""A dry run of the multi-device path: one rank per device over
``torch.distributed``, each stage asserted finite.

    python -m audio_source_separation_tpu_torch.tools.dryrun_multichip --world-size N \\
        [--device cpu|cuda] [--backend gloo|nccl]

It spawns ``N`` ranks (a ``file://`` store in a fresh temporary directory,
no network) and runs the stages of the JAX package's
``__graft_entry__.py::dryrun_multichip`` at its sizes:

  * the sharded AuxIVA-IP train step on :func:`~..parallel.make_mesh_2d`;
  * ``GaussILRMA(4)`` in bins mode at 256 bins a rank;
  * ``AuxLaplaceIVA`` IP with ``pad_bins`` at ``16 N + 1`` bins (the padded
    bins cropped from the output);
  * ``GaussIPSDTA`` at ``32 N`` bins in uniform 2-bin blocks;
  * ``AuxLaplaceIVA`` in frames mode at ``16 N`` frames;
  * ``batch_separate`` of ``AuxLaplaceIVA`` and ``GaussILRMA(2)`` over the
    dp x tp mesh.

On ``cuda`` rank r takes card ``r % device_count``, so two ranks may share
one card (under gloo: NCCL refuses two ranks on one card).  Rank 0 prints
one JSON line with each stage's output shape and seconds.
"""

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

MIXING = np.array([[1.0, 0.7], [0.6, 1.0]])


def _mixture(rng, n_bins, n_frames):
    S = rng.randn(2, n_bins, n_frames) * np.abs(rng.randn(2, 1, n_frames)) + 1j * rng.randn(2, n_bins, n_frames)
    return np.einsum("cn,nft->cft", MIXING, S).astype(np.complex64)


def _finite(name, out, loss=None):
    outs = out if isinstance(out, (tuple, list)) else (out,)
    for part in outs:
        part = torch.as_tensor(part)
        if not torch.isfinite(part).all():
            raise AssertionError("{}: non-finite output".format(name))
    if loss is not None and not np.isfinite(np.asarray(loss)).all():
        raise AssertionError("{}: non-finite loss".format(name))


def stages(world, device_type):
    """Every stage on this rank; returns ``{stage: {"shape", "seconds"}}``."""
    import audio_source_separation_tpu_torch as port
    from audio_source_separation_tpu_torch.parallel import (
        batch_separate,
        make_mesh,
        make_mesh_2d,
        make_sharded_train_step,
    )
    from audio_source_separation_tpu_torch.parallel.mesh import mesh_device

    mesh = make_mesh_2d(device_type=device_type)
    tp_mesh = make_mesh(axis_name="tp", device_type=device_type)
    device = mesh_device(mesh)
    dp, tp = mesh.size(0), mesh.size(1)
    report = {}

    def stage(name, fn):
        start = time.perf_counter()
        shape = fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        report[name] = {"shape": list(shape), "seconds": time.perf_counter() - start}

    def train_step():
        batch, n_bins, n_frames = dp * 2, tp * 16, 32
        X2 = torch.as_tensor(np.random.RandomState(111).randn(batch, 2, 2, n_bins, n_frames).astype(np.float32))
        W2 = torch.zeros((batch, 2, n_bins, 2, 2))
        W2[:, 0] = torch.eye(2)
        step, _, _ = make_sharded_train_step(mesh)
        W_new, nll = step(X2.to(device), W2.to(device))
        _finite("train step", W_new, nll.cpu())
        return W_new.shape

    rng = np.random.RandomState(111)
    X = _mixture(rng, 256 * world, 48)

    def ilrma_bins():
        np.random.seed(111)
        solver = port.GaussILRMA(n_basis=4, device=device).use_mesh(tp_mesh, mode="bins")
        out = solver(X, iteration=2)
        _finite("GaussILRMA bins", out, solver.loss)
        return out.shape

    def iva_pad_bins():
        X_odd = X[:, : 16 * world + 1]
        solver = port.AuxLaplaceIVA(algorithm_spatial="IP", device=device).use_mesh(tp_mesh, "bins", pad_bins=True)
        out = solver(X_odd, iteration=2)
        if out.shape[1] != X_odd.shape[1]:
            raise AssertionError("padded bins must be cropped: {} from {}".format(out.shape[1], X_odd.shape[1]))
        _finite("AuxLaplaceIVA pad_bins", out, solver.loss)
        return out.shape

    def ipsdta_bins():
        F_blk = 32 * world
        np.random.seed(111)
        solver = port.GaussIPSDTA(n_basis=2, n_blocks=F_blk // 2, spatial_iteration=2, device=device)
        out = solver.use_mesh(tp_mesh, mode="bins")(X[:, :F_blk, :32], iteration=1)
        _finite("GaussIPSDTA bins", out, solver.loss)
        return out.shape

    def iva_frames():
        X_sp = _mixture(rng, 128, 16 * world)
        solver = port.AuxLaplaceIVA(algorithm_spatial="IP", device=device).use_mesh(tp_mesh, mode="frames")
        out = solver(X_sp, iteration=2)
        _finite("AuxLaplaceIVA frames", out, solver.loss)
        return out.shape

    def batch_dp_tp():
        rngb = np.random.RandomState(7)
        shape = (dp * 2, 2, 32 * tp, 24)
        Sb = rngb.randn(*shape) + 1j * rngb.randn(*shape)
        Xb = np.einsum("cn,bnft->bcft", MIXING, Sb).astype(np.complex64)
        outs, losses = batch_separate(port.AuxLaplaceIVA(algorithm_spatial="IP", device=device), Xb, 2, mesh=mesh)
        _finite("batch_separate AuxLaplaceIVA", outs, losses)
        np.random.seed(111)
        outs, losses = batch_separate(port.GaussILRMA(n_basis=2, device=device), Xb, 2, mesh=mesh)
        _finite("batch_separate GaussILRMA", outs, losses)
        return outs.shape

    for name, fn in (
        ("train_step", train_step),
        ("gauss_ilrma_bins", ilrma_bins),
        ("auxiva_ip_pad_bins", iva_pad_bins),
        ("gauss_ipsdta_bins", ipsdta_bins),
        ("auxiva_ip_frames", iva_frames),
        ("batch_separate_dp_tp", batch_dp_tp),
    ):
        stage(name, fn)
    return report, (dp, tp)


def _rank(rank, world, backend, device_type, store):
    if device_type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    dist.init_process_group(backend, init_method="file://" + store, rank=rank, world_size=world)
    try:
        report, (dp, tp) = stages(world, device_type)
        if rank == 0:
            print(json.dumps({"dryrun_multichip": {"world_size": world, "dp": dp, "tp": tp, "backend": backend,
                                                   "device": device_type, "stages": report}}), flush=True)  # fmt: skip
    finally:
        dist.destroy_process_group()


def run(world_size, device="cuda", backend=None):
    """Spawn ``world_size`` ranks and run every stage (raises if a rank
    fails)."""
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --device cpu to run on the host")
    backend = backend or ("nccl" if device == "cuda" and world_size <= torch.cuda.device_count() else "gloo")
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_rank, args=(world_size, backend, device, os.path.join(tmp, "store")), nprocs=world_size)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--world-size", type=int, required=True)
    parser.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    parser.add_argument("--backend", choices=("gloo", "nccl"), default=None)
    args = parser.parse_args(argv)
    run(args.world_size, device=args.device, backend=args.backend)


if __name__ == "__main__":
    sys.exit(main())
