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
# (C, F, T), the input made from it, the mode, pad_bins, iterations, the
# world sizes it runs at, a warm start, the route switches set on the
# solver, and what it raises where it must
IPSDTA = {"n_basis": 2, "n_blocks": 16, "spatial_iteration": 2}
IPSDTA_B4 = {"n_basis": 2, "n_blocks": 8, "spatial_iteration": 2}
PLANES = {"source_compact": False}
PENCIL = {"source_pencil": True}
ALL_WORLDS = (2, 3, 4)
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
    # the off-default IPSDTA source routes: planes (source_compact=False) and
    # the K = 2 pencil streams
    "ipsdta_kondo_planes_bins": dict(solver=("GaussIPSDTA", IPSDTA), shape=(2, 32, 16), mode="bins", iteration=2,
                                     attrs=PLANES, worlds=(2, 4)),  # fmt: skip
    "ipsdta_kondo_planes_frames": dict(solver=("GaussIPSDTA", IPSDTA), shape=(2, 32, 16), mode="frames",
                                       iteration=2, attrs=PLANES),  # fmt: skip
    "ipsdta_ikeshita_planes_frames": dict(solver=("GaussIPSDTA", dict(IPSDTA, author="Ikeshita")),
                                          shape=(2, 32, 16), mode="frames", iteration=2, attrs=PLANES,
                                          worlds=(2, 4)),  # fmt: skip
    "ipsdta_ikeshita_planes_bins": dict(solver=("GaussIPSDTA", dict(IPSDTA, author="Ikeshita")), shape=(2, 32, 16),
                                        mode="bins", iteration=2, attrs=PLANES),  # fmt: skip
    "tipsdta_planes_bins": dict(solver=("TIPSDTA", IPSDTA), shape=(2, 32, 16), mode="bins", iteration=2,
                                attrs=PLANES),  # fmt: skip
    "tipsdta_planes_frames": dict(solver=("TIPSDTA", IPSDTA), shape=(2, 32, 16), mode="frames", iteration=2,
                                  attrs=PLANES),  # fmt: skip
    "ipsdta_kondo_pencil_bins": dict(solver=("GaussIPSDTA", IPSDTA), shape=(2, 32, 16), mode="bins", iteration=2,
                                     attrs=PENCIL, worlds=(2, 4)),  # fmt: skip
    "ipsdta_kondo_pencil_frames": dict(solver=("GaussIPSDTA", IPSDTA), shape=(2, 32, 16), mode="frames",
                                       iteration=2, attrs=PENCIL),  # fmt: skip
    "tipsdta_pencil_bins": dict(solver=("TIPSDTA", IPSDTA), shape=(2, 32, 16), mode="bins", iteration=2,
                                attrs=PENCIL),  # fmt: skip
    "tipsdta_pencil_frames": dict(solver=("TIPSDTA", IPSDTA), shape=(2, 32, 16), mode="frames", iteration=2,
                                  attrs=PENCIL),  # fmt: skip
    # slice 10c: the MNMF family, IDLMA, the NMF family, ProxLaplaceIVA, LDPSDTF
    "fastmnmf_bins": dict(solver=("FastMultichannelISNMF", {"n_basis": 3}), mode="bins", worlds=ALL_WORLDS),
    "fastmnmf_frames": dict(solver=("FastMultichannelISNMF", {"n_basis": 3}), mode="frames", worlds=ALL_WORLDS),
    "fastmnmf_svd_frames": dict(solver=("FastMultichannelISNMF", {"n_basis": 3, "guard": "svd"}), mode="frames"),
    "fastmnmf_c3_bins": dict(solver=("FastMultichannelISNMF", {"n_basis": 2}), shape=(3, 24, 18), mode="bins"),
    "sawada_bins": dict(solver=("MultichannelISNMF", {"n_basis": 2}), mode="bins", worlds=ALL_WORLDS),
    "sawada_frames": dict(solver=("MultichannelISNMF", {"n_basis": 2}), mode="frames", worlds=ALL_WORLDS),
    "sawada_c3_frames": dict(solver=("MultichannelISNMF", {"n_basis": 2}), shape=(3, 24, 18), mode="frames"),
    "ozerov_bins": dict(solver=("MultichannelISNMF", {"n_basis": 2, "author": "Ozerov"}), mode="bins",
                        worlds=ALL_WORLDS),  # fmt: skip
    "ozerov_frames": dict(solver=("MultichannelISNMF", {"n_basis": 2, "author": "Ozerov"}), mode="frames",
                          worlds=ALL_WORLDS),  # fmt: skip
    "ozerov_anneal_frames": dict(solver=("MultichannelISNMF", {"n_basis": 2, "author": "Ozerov", "annealing": True,
                                                               "annealing_iterations": 3}), mode="frames"),  # fmt: skip
    "idlma_bins": dict(solver=("GaussIDLMA", {}), mode="bins", worlds=ALL_WORLDS, dnn=True),
    "idlma_frames": dict(solver=("GaussIDLMA", {}), mode="frames", worlds=ALL_WORLDS, dnn=True),
    "idlma_svd_frames": dict(solver=("GaussIDLMA", {"guard": "svd"}), mode="frames", dnn=True),
    "idlma_svd_bins": dict(solver=("GaussIDLMA", {"guard": "svd"}), mode="bins", dnn=True),
    "isnmf_bins": dict(solver=("ISNMF", {"n_basis": 4}), input="power", mode="bins", worlds=ALL_WORLDS),
    "isnmf_frames": dict(solver=("ISNMF", {"n_basis": 4}), input="power", mode="frames", worlds=ALL_WORLDS),
    "eucnmf_bins": dict(solver=("EUCNMF", {"n_basis": 3, "domain": 1.5}), input="power", mode="bins"),
    "klnmf_frames": dict(solver=("KLNMF", {"n_basis": 3}), input="power", mode="frames"),
    "tnmf_bins": dict(solver=("TNMF", {"n_basis": 3, "nu": 5.0}), input="power", mode="bins"),
    "cauchy_frames": dict(solver=("CauchyNMF", {"n_basis": 3}), input="power", mode="frames"),
    "cauchy_me_bins": dict(solver=("CauchyNMF", {"n_basis": 3, "algorithm": "me"}), input="power", mode="bins"),
    "cauchy_fast_frames": dict(solver=("CauchyNMF", {"n_basis": 3, "algorithm": "mm_fast"}), input="power",
                               mode="frames"),  # fmt: skip
    "complex_eucnmf_bins": dict(solver=("ComplexEUCNMF", {"n_basis": 3}), input="channel", mode="bins",
                                worlds=ALL_WORLDS),  # fmt: skip
    "complex_eucnmf_frames": dict(solver=("ComplexEUCNMF", {"n_basis": 3}), input="channel", mode="frames",
                                  worlds=ALL_WORLDS),  # fmt: skip
    "cov_isnmf_bins": dict(solver=("CovarianceISNMF", {"n_basis": 3}), input="covariance", mode="bins",
                           worlds=ALL_WORLDS),  # fmt: skip
    "cov_isnmf_frames": dict(solver=("CovarianceISNMF", {"n_basis": 3}), input="covariance", mode="frames",
                             worlds=ALL_WORLDS),  # fmt: skip
    "cov_isnmf_c3_frames": dict(solver=("CovarianceISNMF", {"n_basis": 2}), shape=(3, 24, 18), input="covariance",
                                mode="frames"),  # fmt: skip
    "prox_bins": dict(solver=("ProxLaplaceIVA", {"step": 0.5}), mode="bins", worlds=ALL_WORLDS),
    "prox_frames": dict(solver=("ProxLaplaceIVA", {"step": 0.5}), mode="frames", worlds=ALL_WORLDS),
    "prox_c3_bins": dict(solver=("ProxLaplaceIVA", {}), shape=(3, 24, 18), mode="bins"),
    "ldpsdtf_frames": dict(solver=("LDPSDTF", {"n_basis": 2}), shape=(2, 6, 18), input="gram", mode="frames",
                           worlds=ALL_WORLDS),  # fmt: skip
    "ldpsdtf_k3_frames": dict(solver=("LDPSDTF", {"n_basis": 3}), shape=(2, 6, 18), input="gram", mode="frames"),
    "ldpsdtf_bins": dict(solver=("LDPSDTF", {"n_basis": 2}), shape=(2, 6, 18), input="gram", mode="bins"),
    "isnmf_pad_raise": dict(solver=("ISNMF", {"n_basis": 2}), shape=(2, 25, 18), input="power", mode="bins",
                            pad=True, raises=("ValueError", "does not support")),  # fmt: skip
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
    _case.setdefault("input", "mixture")
    _case.setdefault("attrs", {})
    _case.setdefault("dnn", False)
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


def case_input(case):
    """The input of a case, made from its seeded mixture ``(C, F, T)``: the
    mixture, the power ``|x_0|^2 (F, T)`` of the NMF family, the channel
    ``x_0 (F, T)`` of ComplexEUCNMF, the covariances ``(F, T, C, C)`` of
    CovarianceISNMF, or LDPSDTF's ``(B, B, T)`` Gram target with ``B`` the
    mixture's bins."""
    X = mixture(case["shape"])
    kind = case["input"]
    if kind == "mixture":
        return X
    if kind == "power":
        return np.abs(X[0]) ** 2
    if kind == "channel":
        return X[0]
    if kind == "covariance":
        return np.einsum("cft,dft->ftcd", X, X.conj())
    if kind == "gram":
        rng = np.random.RandomState(5)
        B, T = X.shape[1:]
        bases = [rng.randn(B, B) for _ in range(2)]
        gram = np.einsum("kij,kt->ijt", np.stack([a @ a.T + 0.5 * np.eye(B) for a in bases]), np.abs(X[:2, 0]) + 0.2)
        return gram
    raise ValueError(kind)


def dnn_weights(n_bins, seed=9):
    """The seeded weights ``(W1 (F, 8), W2 (8, F))`` of a small
    frequency-mixing variance network (IDLMA's cases)."""
    rng = np.random.RandomState(seed)
    return rng.randn(n_bins, 8) * 0.1, rng.randn(8, n_bins) * 0.1


def torch_dnn(n_bins):
    """``max(relu(a W1) W2, 1e-3)`` over the bins of ``a (S, F, T)``."""
    W1, W2 = (torch.as_tensor(w) for w in dnn_weights(n_bins))

    def dnn(amp):
        h = torch.relu(torch.einsum("sft,fh->sht", amp, W1.to(amp.dtype)))
        return torch.clamp(torch.einsum("sht,hf->sft", h, W2.to(amp.dtype)), min=1e-3)

    return dnn


def warm_filter(shape, seed=3):
    """A seeded warm-start demixing filter ``(F, C, C)`` near the identity."""
    C, F, _ = shape
    rng = np.random.RandomState(seed)
    return np.tile(np.eye(C), (F, 1, 1)) + 0.1j * rng.randn(F, C, C)


def make_solver(package, spec, attrs=None):
    name, kwargs = spec
    kwargs = dict(kwargs)
    if package is port:
        kwargs["device"] = "cpu"
    solver = getattr(package, name)(**kwargs)
    for key, value in (attrs or {}).items():
        setattr(solver, key, value)
    return solver


def call_kwargs(case, dnn=None):
    """The call's keywords: the warm start, and the variance network (``dnn``
    as the package builds it) where the case takes one."""
    kwargs = {"demix_filter": warm_filter(case["shape"])} if case["warm"] else {}
    if case["dnn"]:
        kwargs["dnn"] = dnn if dnn is not None else torch_dnn(case["shape"][1])
    return kwargs


def _run(case, mesh, iteration):
    np.random.seed(SEED)
    solver = make_solver(port, case["solver"], case["attrs"])
    if case["callbacks"]:
        # what a callback sees: the published attributes' shapes, the losses so far
        solver.seen = []
        solver.callbacks = [lambda s: s.seen.append([*s.demix_filter.shape, *s.estimation.shape, len(s.loss)])]
    if mesh is not None:
        solver.use_mesh(mesh, mode=case["mode"], axis_name=case["axis"], pad_bins=case["pad"])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        out = solver(case_input(case), iteration=iteration, **call_kwargs(case))
    return solver, out


def _shape(x):
    """The shape of a published attribute (empty where there is none; the
    first factor's for the factor models)."""
    x = x[0] if isinstance(x, tuple) else x
    return np.asarray(() if x is None else tuple(x.shape), dtype=np.int64)


def _numpy(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _outputs(prefix, out):
    """``{prefix + "0": first piece, ...}``: the output, or each factor of a
    factor model's output."""
    pieces = out if isinstance(out, tuple) else (out,)
    return {"{}{}".format(prefix, i): _numpy(piece) for i, piece in enumerate(pieces)}


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
        **_outputs("output", out),
        "n_outputs": len(out) if isinstance(out, tuple) else 1,
        "loss": np.asarray(solver.loss),
        "all_reduce": first["all_reduce"],
        "all_gather": first["all_gather"],
        "all_reduce_per_iteration": (second["all_reduce"] - first["all_reduce"]) / 2,
        "all_gather_per_iteration": (second["all_gather"] - first["all_gather"]) / 2,
        "demix_filter_shape": _shape(getattr(solver, "demix_filter", None)),
        "estimation_shape": _shape(solver.estimation),
        "input_shape": _shape(solver.input),
    }
    if case["callbacks"]:
        result["seen"] = np.asarray(solver.seen)
    if rank == 0:
        single, single_out = _run(case, None, n)
        result.update(_outputs("single_output", single_out), single_loss=np.asarray(single.loss))
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
