"""Where the block-PSD models' float32 runs leave float64.

    python tests/check_block_psd_float32.py          # the CPU, both packages
    python tests/check_block_psd_float32.py --card   # the card, the port
    python tests/check_block_psd_float32.py --holds  # chip_smoke's holds, the card

A one-off check, not a test (a couple of minutes).  Prints one JSON line
per reading.  On the CPU, the largest relative gap of the float32 loss
trajectory to the port's float64 one, for the port and for the JAX package
(x64 off), from the same ``np.random.seed(111)`` init:

  * ``GaussIPSDTA`` Kondo and Ikeshita and ``TIPSDTA(nu=1000)`` at
    ``n_basis=2``, 1024 blocks, 5 losses, on ``chip_smoke.py``'s seeded
    2-source mixture cut to a quarter (2 x 2049 x 118 at stft(4096, 2048));
  * ``LDPSDTF`` at K = 2 and 3, 20 losses, on ``chip_smoke.py``'s Gram
    targets (64 taps x 469 frames, the JAX benchmark's recipe).

With ``--card`` (no JAX needed): Ikeshita at ``n_basis=2`` x 30 on the card
from each of the first 8 inits drawn after ``np.random.seed(111)`` on
``chip_smoke.py``'s full mixture (2 x 2049 x 469), the index of the first
non-finite loss, and for a run that has one, the same init on the CPU at
float32 and at float64.

With ``--holds`` (no JAX needed), the readings behind ``chip_smoke.py``
phase 11's holds, at its shape (2 x 2049 x 469, seed-111 init), each a
relative gap per loss to the port's CPU float64 run:

  * Ikeshita, ``IKESHITA_LOSSES`` losses: the card at float32 twice on the
    same input (a repeat), and on ``PERTURBED`` inputs moved by about one
    float32 rounding (2^-23 times a seeded normal, relative); the card at
    complex128 (``chip_smoke.at_complex128``); the CPU at float32 on the same and on the perturbed inputs;
  * Ikeshita's steps split: from the card's float32 state after each of
    its first iterations, one update on the card, on the CPU at float32
    and on the CPU at float64, each update's NLL, and how far the card's
    and the CPU float32 update's ``demix_filter`` and ``fixed_point`` lie
    from the float64 update's (max |difference| over max |entry|);
  * Kondo, ``chip_smoke.IPSDTA_MATCH`` losses, against
    ``chip_smoke.IPSDTA_F32_RTOL``: the card as ``chip_smoke`` runs it, and
    controls of lower precision: TF32 matmuls inside the solver loop, and
    K1's VCD covariances rounded to ``CONTROL_MANTISSAS`` bits (10 is
    TF32's mantissa).
"""

import argparse
import contextlib
import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import audio_source_separation_tpu_torch as port  # noqa: E402
import chip_smoke  # noqa: E402
from audio_source_separation_tpu_torch.runtime import solver as solver_module  # noqa: E402


def gaps(jax_models, name, kwargs, X64, X32, iterations):
    """Each package's float32 loss gap to the port's float64 run."""
    losses = {}
    for key, package, X, more in (
        ("f64", port, X64, {"device": "cpu"}), ("port_f32", port, X32, {"device": "cpu"}), ("jax_f32", jax_models, X32, {}),
    ):  # fmt: skip
        np.random.seed(chip_smoke.SEED)
        model = getattr(package, name)(**kwargs, **more)
        model(X, iteration=iterations)
        losses[key] = np.asarray(model.loss)
    ref = losses.pop("f64")
    return {key: float((np.abs(loss - ref) / np.abs(ref)).max()) for key, loss in losses.items()}


def on_the_cpu():
    import jax

    jax.config.update("jax_platforms", "cpu")
    import audio_source_separation_tpu.models as jax_models

    rng = np.random.RandomState(chip_smoke.SEED)
    mixture, _ = chip_smoke.synth_mixture(rng, 2, chip_smoke.N_SAMPLES // 4)
    X64 = port.stft(mixture, fft_size=chip_smoke.FFT_SIZE, hop_size=chip_smoke.HOP_SIZE, device="cpu")
    X32 = X64.to(torch.complex64).numpy()
    for name, kwargs in (
        ("GaussIPSDTA", {"author": "Kondo"}), ("GaussIPSDTA", {"author": "Ikeshita"}), ("TIPSDTA", {"nu": 1000}),
    ):  # fmt: skip
        out = gaps(jax_models, name, dict(kwargs, n_basis=2), X64, X32, chip_smoke.IPSDTA_MATCH - 1)
        print(json.dumps({"model": name, **kwargs, "shape": list(X64.shape), **out}), flush=True)
    n_frames = -(-chip_smoke.N_SAMPLES // chip_smoke.HOP_SIZE) + 1  # chip_smoke's 469
    for n_basis in (2, 3):
        target = chip_smoke.gram_target(n_basis, n_frames)
        out = gaps(jax_models, "LDPSDTF", {"n_basis": n_basis}, target, target.astype(np.float32), chip_smoke.N_MATCH)
        print(json.dumps({"model": "LDPSDTF", "n_basis": n_basis, "shape": list(target.shape), **out}), flush=True)


def first_nonfinite(loss):
    bad = np.flatnonzero(~np.isfinite(np.asarray(loss)))
    return int(bad[0]) if bad.size else None


def on_the_card(runs=8, iterations=30):
    print("card: " + chip_smoke.card_line(), flush=True)
    rng = np.random.RandomState(chip_smoke.SEED)
    mixture, _ = chip_smoke.synth_mixture(rng, 2, chip_smoke.N_SAMPLES)
    X = port.stft(mixture.astype(np.float32), fft_size=chip_smoke.FFT_SIZE, hop_size=chip_smoke.HOP_SIZE)
    cpu = {"cpu_f32": X.cpu(), "cpu_f64": port.stft(mixture, fft_size=chip_smoke.FFT_SIZE,
                                                    hop_size=chip_smoke.HOP_SIZE, device="cpu")}  # fmt: skip
    np.random.seed(chip_smoke.SEED)
    for run in range(runs):
        solver = port.GaussIPSDTA(n_basis=2, author="Ikeshita")
        init = solver.prepare_state_kwargs(X, {})
        solver(X, iteration=iterations, **init)
        row = {"run": run, "card_first_nonfinite": first_nonfinite(solver.loss),
               "card_max_abs_loss": float(np.nanmax(np.abs(solver.loss)))}  # fmt: skip
        if row["card_first_nonfinite"] is not None:
            for key, X_ in cpu.items():
                reference = port.GaussIPSDTA(n_basis=2, author="Ikeshita", device="cpu")
                reference(X_, iteration=iterations, **init)
                row[key + "_first_nonfinite"] = first_nonfinite(reference.loss)
        print(json.dumps(row), flush=True)


IKESHITA_LOSSES, PERTURBED, CONTROL_MANTISSAS = 8, 3, (10, 16)


def perturbed(X, seed):
    """``X`` times ``1 + 2^-23 n``, ``n`` a seeded normal per entry."""
    noise = torch.as_tensor(np.random.RandomState(seed).randn(*X.shape), dtype=torch.float32, device=X.device)
    return X * (1 + 2.0**-23 * noise)


def loss_gaps(make, X, reference, iterations, **init):
    solver = make()
    solver(X, iteration=iterations, **init)
    return (np.abs(np.asarray(solver.loss) - reference) / np.abs(reference)).tolist()


def rounded(planes, bits):
    """float32 rounded to a ``bits``-bit mantissa (to nearest)."""
    drop = 23 - bits
    words = planes.contiguous().view(torch.int32)
    return ((words + (1 << (drop - 1))) & ~((1 << drop) - 1)).view(torch.float32)


@contextlib.contextmanager
def tf32_matmuls():
    torch.set_float32_matmul_precision("high")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision("highest")


def on(state, device, dtype=None):
    """``state``'s tensors on ``device``, at ``dtype``'s precision if given
    (``torch.float32`` or ``torch.float64``; complex ones to match)."""
    complex_of = {torch.float32: torch.complex64, torch.float64: torch.complex128}
    out = {}
    for key, value in state.items():
        if isinstance(value, torch.Tensor):
            value = value.to(device)
            if dtype is not None:
                value = value.to(complex_of[dtype] if value.is_complex() else dtype)
        out[key] = value
    return out


def max_rel(a, b):
    a, b = a.cpu().to(torch.complex128), b.cpu().to(torch.complex128)
    return float((a - b).abs().max() / b.abs().max())


def step_split(X, init, iterations=4):
    card = port.GaussIPSDTA(n_basis=2, author="Ikeshita")
    cpu = port.GaussIPSDTA(n_basis=2, author="Ikeshita", device="cpu")
    with torch.no_grad(), solver_module.full_f32_matmuls():
        state = card.init_state(X.contiguous(), **init)
        for k in range(iterations):
            updates = {
                "card": card.update_state(state),
                "cpu_f32": cpu.update_state(on(state, "cpu")),
                "cpu_f64": cpu.update_state(on(state, "cpu", torch.float64)),
            }
            row = {"model": "Ikeshita", "step_from_card_state": k}
            row.update({key + "_nll": float((card if key == "card" else cpu).nll(u)) for key, u in updates.items()})
            for key in ("card", "cpu_f32"):
                for field in ("demix_filter", "fixed_point"):
                    row["{}_{}_vs_cpu_f64".format(key, field)] = max_rel(updates[key][field], updates["cpu_f64"][field])
            # where the card's filter is furthest: that bin's energy over the median bin's
            worst = int((updates["card"]["demix_filter"].cpu().to(torch.complex128)
                         - updates["cpu_f64"]["demix_filter"]).abs().amax(dim=(1, 2)).argmax())  # fmt: skip
            energy = (X.abs() ** 2).sum(dim=(0, 2)).cpu()
            row.update(worst_bin=worst, worst_bin_energy_over_median=float(energy[worst] / energy.median()))
            print(json.dumps(row), flush=True)
            state = updates["card"]


def holds():
    from audio_source_separation_tpu_torch.models import ipsdta

    print("card: " + chip_smoke.card_line(), flush=True)
    rng = np.random.RandomState(chip_smoke.SEED)
    mixture, _ = chip_smoke.synth_mixture(rng, 2, chip_smoke.N_SAMPLES)
    kw = {"fft_size": chip_smoke.FFT_SIZE, "hop_size": chip_smoke.HOP_SIZE}
    X = port.stft(mixture.astype(np.float32), **kw)
    X64_cpu = port.stft(mixture, device="cpu", **kw)
    for author, n_losses in (("Ikeshita", IKESHITA_LOSSES), ("Kondo", chip_smoke.IPSDTA_MATCH)):
        np.random.seed(chip_smoke.SEED)
        init = port.GaussIPSDTA(n_basis=2, author=author, device="cpu").prepare_state_kwargs(X64_cpu, {})
        reference = port.GaussIPSDTA(n_basis=2, author=author, device="cpu")
        reference(X64_cpu, iteration=n_losses - 1, **init)
        reference = np.asarray(reference.loss)
        print(json.dumps({"model": author, "cpu_f64_losses": reference.tolist()}), flush=True)

        def card(**more):
            return port.GaussIPSDTA(n_basis=2, author=author, **more)

        def card_f64(**more):
            return chip_smoke.at_complex128(card(**more))

        def cpu(**more):
            return port.GaussIPSDTA(n_basis=2, author=author, device="cpu", **more)

        runs = {"card_f32": (card, X)}
        if author == "Ikeshita":
            runs.update(card_f32_repeat=(card, X), card_f64=(card_f64, X64_cpu.cuda()), cpu_f32=(cpu, X.cpu()))
            for k in range(PERTURBED):
                runs["card_f32_perturbed_{}".format(k)] = (card, perturbed(X, k))
                runs["cpu_f32_perturbed_{}".format(k)] = (cpu, perturbed(X.cpu(), k))
        for key, (make, X_) in runs.items():
            gaps = loss_gaps(make, X_, reference, n_losses - 1, **init)
            print(json.dumps({"model": author, "run": key, "gaps": gaps}), flush=True)
        if author == "Ikeshita":
            step_split(X, init)
        if author == "Kondo":
            plain_k1 = ipsdta.weighted_covariance_planes
            controls = {"card_f32_tf32_matmuls": (solver_module, "full_f32_matmuls", tf32_matmuls)}
            for bits in CONTROL_MANTISSAS:
                controls["card_f32_k1_rounded_to_{}_bits".format(bits)] = (
                    ipsdta, "weighted_covariance_planes", lambda *a, bits=bits: rounded(plain_k1(*a), bits))
            for key, patch in controls.items():
                original = getattr(*patch[:2])
                setattr(*patch)
                try:
                    gaps = loss_gaps(card, X, reference, n_losses - 1, **init)
                finally:
                    setattr(*patch[:2], original)
                print(json.dumps({
                    "model": author, "run": key, "gaps": gaps, "limit": chip_smoke.IPSDTA_F32_RTOL,
                    "fails_the_limit": not np.all(np.asarray(gaps) <= chip_smoke.IPSDTA_F32_RTOL),
                }), flush=True)  # fmt: skip

if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    mode = parser.add_mutually_exclusive_group()
    mode.add_argument("--card", action="store_true", help="Ikeshita's float32 runs on the card")
    mode.add_argument("--holds", action="store_true", help="the readings behind chip_smoke's block-PSD holds")
    args = parser.parse_args()
    if args.card:
        on_the_card()
    elif args.holds:
        holds()
    else:
        on_the_cpu()
