"""The port's ``scan_cost_analysis`` beside the JAX package's, every family.

    python tests/check_cost_model_vs_xla.py

A reading, not a test (about a minute on the CPU, most of it JAX's
compiles).  At 2 x 65 x 40 (seed 111; C = 3 and 4 x 65 x 40 where the
family runs there), both packages at single precision (the port on the CPU
at complex64, JAX with x64 off), each family from the seed-111 init: the
port's bytes and FLOPs an iteration (``runtime/cost_model.py``'s rules),
JAX's (XLA's cost model of the compiled scan body), their ratios, and what
explains a gap:

  * ``jax_restore``: bytes and FLOPs of the JAX body's head alone,
    ``scan_restore_state`` (the derived fields recomputed every iteration,
    which the port carries instead);
  * ``port_copy_share``: the share of the port's bytes in data movement
    (copies, ``stack``, ``cat``, indexing, factories; the port's layout);
  * ``port_kernels``: the bytes K1 and K2 charge;
  * ``port_top``: the port's three ops with the most bytes.

Prints one JSON line per family, then a Markdown table of the ratios.
"""

import json
import os
import sys
import warnings
from pathlib import Path

os.environ["JAX_PLATFORMS"] = "cpu"
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", False)

import numpy as np  # noqa: E402
import torch  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import audio_source_separation_tpu.models as jax_models  # noqa: E402
import audio_source_separation_tpu_torch as port  # noqa: E402
from audio_source_separation_tpu.ops.packing import pack, unpack  # noqa: E402
from audio_source_separation_tpu.runtime import scan_cost_analysis as jax_scan_cost_analysis  # noqa: E402
from audio_source_separation_tpu_torch.runtime.cost_model import DATA_MOVEMENT  # noqa: E402
from audio_source_separation_tpu_torch.runtime.profiling import iteration_cost  # noqa: E402

SEED = 111
F, T = 65, 40


def inputs():
    rng = np.random.RandomState(SEED)

    def mixture(c):
        return (rng.randn(c, F, T) + 1j * rng.randn(c, F, T)).astype(np.complex64)

    X = mixture(2)
    taps, basis_rng = 8, np.random.RandomState(7)
    bases = np.stack([a @ a.T + 0.5 * np.eye(taps) for a in basis_rng.randn(2, taps, taps)])
    gram = np.einsum("kij,kt->ijt", bases, np.abs(basis_rng.randn(2, T)) + 0.2).astype(np.float32)
    return {
        "X": X, "X3": mixture(3), "X4": mixture(4), "power": (np.abs(X[0]) ** 2).astype(np.float32),
        "spectrogram": X[0], "power_tensor": (np.abs(X) ** 2).astype(np.float32),
        "covariance": np.einsum("cft,dft->ftcd", X, X.conj()).astype(np.complex64), "gram": gram,
    }


# key, class name (both packages), keyword arguments, input
FAMILIES = [
    ("AuxLaplaceIVA IP", "AuxLaplaceIVA", {}, "X"),
    ("AuxGaussIVA IP", "AuxGaussIVA", {}, "X"),
    ("AuxLaplaceIVA IP, C = 3", "AuxLaplaceIVA", {}, "X3"),
    ("AuxLaplaceIVA ISS", "AuxLaplaceIVA", {"algorithm_spatial": "ISS"}, "X"),
    ("AuxLaplaceIVA IP2", "AuxLaplaceIVA", {"algorithm_spatial": "IP2"}, "X"),
    ("OverAuxLaplaceIVA, 4 -> 2", "OverAuxLaplaceIVA", {"algorithm_spatial": "IP", "n_sources": 2}, "X4"),
    ("NaturalGradLaplaceIVA", "NaturalGradLaplaceIVA", {}, "X"),
    ("GradLaplaceIVA", "GradLaplaceIVA", {}, "X"),
    ("GaussILRMA(10) IP", "GaussILRMA", {"n_basis": 10}, "X"),
    ("GaussILRMA(10) ISS", "GaussILRMA", {"n_basis": 10, "algorithm_spatial": "ISS"}, "X"),
    ("TILRMA(10)", "TILRMA", {"n_basis": 10}, "X"),
    ("ConsistentGaussILRMA(10)", "ConsistentGaussILRMA", {"n_basis": 10, "fft_size": 128, "hop_size": 64}, "X"),
    ("FastMultichannelISNMF(10)", "FastMultichannelISNMF", {"n_basis": 10}, "X"),
    ("MNMF Sawada(10)", "MultichannelISNMF", {"n_basis": 10}, "X"),
    ("MNMF Ozerov(10)", "MultichannelISNMF", {"n_basis": 10, "author": "Ozerov"}, "X"),
    ("GaussIPSDTA Kondo", "GaussIPSDTA", {"n_basis": 2}, "X"),
    ("GaussIPSDTA Ikeshita", "GaussIPSDTA", {"n_basis": 2, "author": "Ikeshita"}, "X"),
    ("TIPSDTA(1000)", "TIPSDTA", {"n_basis": 2, "nu": 1000}, "X"),
    ("LDPSDTF(2)", "LDPSDTF", {"n_basis": 2}, "gram"),
    ("EUCNMF(10)", "EUCNMF", {"n_basis": 10}, "power"),
    ("KLNMF(10)", "KLNMF", {"n_basis": 10}, "power"),
    ("ISNMF(10)", "ISNMF", {"n_basis": 10}, "power"),
    ("TNMF(10)", "TNMF", {"n_basis": 10}, "power"),
    ("CauchyNMF(10)", "CauchyNMF", {"n_basis": 10}, "power"),
    ("ComplexEUCNMF(10)", "ComplexEUCNMF", {"n_basis": 10}, "spectrogram"),
    ("EUCNTF(10)", "EUCNTF", {"n_basis": 10}, "power_tensor"),
    ("CovarianceISNMF(10)", "CovarianceISNMF", {"n_basis": 10}, "covariance"),
    ("GradLaplaceFDICA", "GradLaplaceFDICA", {}, "X"),
    ("NaturalGradLaplaceFDICA", "NaturalGradLaplaceFDICA", {}, "X"),
    ("ProxLaplaceIVA", "ProxLaplaceIVA", {}, "X"),
]


def jax_restore_cost(solver, X):
    """XLA's bytes and FLOPs of ``scan_restore_state`` alone, the head of
    the JAX package's counted body (0 where nothing is derived)."""
    solver.set_shape_metadata(X)
    kwargs = pack({k: np.asarray(v) for k, v in solver.prepare_state_kwargs(X, {}).items()})
    shapes = jax.eval_shape(lambda Xp, kp: pack(solver.init_state(unpack(Xp), **unpack(kp))), pack(X), kwargs)
    derived = [k for k in solver.scan_derived_fields() if k in shapes]
    if not derived:
        return 0.0, 0.0
    carried = {k: v for k, v in shapes.items() if k not in derived}
    # what the head adds to the carry: the derived fields, or the cheaper
    # statistic a family restores in their place
    restore = jax.jit(
        lambda sp: pack({k: v for k, v in solver.scan_restore_state(unpack(sp)).items() if k not in carried})
    )
    cost = restore.lower(carried).compile().cost_analysis()
    cost = cost[0] if isinstance(cost, (list, tuple)) else cost
    return cost.get("bytes accessed", 0.0), cost.get("flops", 0.0)


def jax_solver(name, kwargs):
    if name == "MultichannelISNMF":
        return jax_models.mnmf.MultichannelISNMF(**kwargs)
    if name == "CovarianceISNMF":
        return jax_models.CovarianceISNMF(**kwargs)
    return getattr(jax_models, name)(**kwargs)


def main():
    data = inputs()
    rows = []
    warnings.simplefilter("ignore")
    for key, name, kwargs, input_key in FAMILIES:
        target = data[input_key]
        np.random.seed(SEED)
        jax_bytes, jax_flops = jax_scan_cost_analysis(jax_solver(name, kwargs), target)
        np.random.seed(SEED)
        restore = jax_restore_cost(jax_solver(name, kwargs), target)
        np.random.seed(SEED)
        counter = iteration_cost(getattr(port, name)(device="cpu", **kwargs), torch.as_tensor(target))
        copies = sum(row[1] for op, row in counter.by_op.items() if op in {str(p) for p in DATA_MOVEMENT})
        row = {
            "family": key, "shape": list(target.shape),
            "port_bytes": counter.bytes, "port_flops": counter.flops,
            "jax_bytes": jax_bytes, "jax_flops": jax_flops,
            "bytes_ratio": counter.bytes / jax_bytes, "flops_ratio": counter.flops / jax_flops,
            "jax_restore": list(restore), "port_copy_share": copies / counter.bytes,
            "port_kernels": {k: counter.by_op["kernel:" + k][1] for k in counter.charges},
            "port_top": sorted(counter.by_op, key=lambda op: -counter.by_op[op][1])[:3],
            "port_ops": sum(r[0] for r in counter.by_op.values()),
        }
        rows.append(row)
        print(json.dumps(row), flush=True)
    print("\n| Family | Port B | JAX B | Port/JAX B | Port FLOPs | JAX FLOPs | Port/JAX FLOPs | JAX restore B "
          "| Port copy share |")
    print("|---|---|---|---|---|---|---|---|---|")
    for r in rows:
        print("| {} | {:,.0f} | {:,.0f} | {:.2f} | {:,.0f} | {:,.0f} | {:.2f} | {:,.0f} | {:.2f} |".format(
            r["family"], r["port_bytes"], r["jax_bytes"], r["bytes_ratio"], r["port_flops"], r["jax_flops"],
            r["flops_ratio"], r["jax_restore"][0], r["port_copy_share"]))


if __name__ == "__main__":
    main()
