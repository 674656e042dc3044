"""Worked walkthrough: the reference notebooks' workflow as one script
(``egs/bss-example/ilrma/test_gauss-ilrma.ipynb`` cells 17-75): prepare a
convolutive 2-mic mixture on the MIRD array geometry, run GaussILRMA with
per-iteration callbacks on the card, and write

  * ``loss_curve.csv`` + ``loss_curve.png``: the NLL trajectory;
  * ``sdri_curve.csv`` + ``sdri_curve.png``: per-iteration PIT SI-SDR
    improvement (:class:`~..utils.callbacks.SDRImprovementCallback`);
  * ``state/state_*.npz``: per-iteration basis/activation snapshots
    (ILRMA);
  * ``source_*.wav`` and ``mixture_ref_mic.wav``; ``summary.json``.

PNG plots are written when matplotlib is importable (the CSVs always are).
Run:

    python -m audio_source_separation_tpu_torch.examples.walkthrough --out walkthrough_out

``--method`` picks the solver (ilrma | auxiva); the rest mirrors the
notebook (fft 2048, hop 1024, 50 iterations, seed 111).
"""

import argparse
import csv
import json
import os

import numpy as np
import torch

from .. import AuxLaplaceIVA, GaussILRMA, istft, stft
from ..runtime import resolve_device
from ..utils import SDRImprovementCallback, StateSnapshotCallback, convolutive_mixture, pit_si_sdr, write_wav
from ..utils.synthesis import mird_geometry_rirs
from .prepare_mixture import synthetic_speech


def make_mixture(sr=16000, seconds=4.0, degrees=(45, 315), mics=(3, 4), seed=111, device=None):
    """Two speech-like sources through the MIRD 8-mic array geometry (its
    synthetic RIRs, 0.1 s long), picked up at ``mics``.  Returns
    ``(mixture (n_mics, n), images at the first mic (n_sources, n), sr)``
    as float64 tensors on ``device``."""
    n = int(seconds * sr)
    sources = np.stack([synthetic_speech(i, n_samples=n, seed=seed) for i in range(len(degrees))])
    rirs = torch.stack(
        [mird_geometry_rirs(deg, samples=int(0.1 * sr), seed=seed, device=device)[:, list(mics)].T for deg in degrees]
    )  # (n_sources, n_mics, taps)
    mixture, images = convolutive_mixture(sources, rirs)
    return mixture, images[:, 0], sr


def write_curve(path, values, header):
    with open(path, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(["iteration", header])
        for i, v in enumerate(values):
            writer.writerow([i, v])


def maybe_plot(path, values, ylabel):
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return False
    fig, ax = plt.subplots(figsize=(6, 3.5))
    ax.plot(range(len(values)), values)
    ax.set_xlabel("iteration")
    ax.set_ylabel(ylabel)
    ax.grid(True, alpha=0.3)
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return True


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--method", default="ilrma", choices=["ilrma", "auxiva"])
    parser.add_argument("--iterations", type=int, default=50)
    parser.add_argument("--fft-size", type=int, default=2048)
    parser.add_argument("--n-basis", type=int, default=4)
    parser.add_argument("--seed", type=int, default=111)
    parser.add_argument("--out", default="walkthrough_out")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    hop = args.fft_size // 2
    os.makedirs(args.out, exist_ok=True)

    mixture, images, sr = make_mixture(seed=args.seed, device=device)
    X = stft(mixture, fft_size=args.fft_size, hop_size=hop, device=device)

    # per-iteration SI-SDR and state snapshots (notebook cells 66-75)
    sdri_cb = SDRImprovementCallback(targets=images, fft_size=args.fft_size, hop_size=hop, length=mixture.shape[-1])
    callbacks = [sdri_cb]
    if args.method == "ilrma":
        callbacks.append(StateSnapshotCallback(os.path.join(args.out, "state")))

    np.random.seed(args.seed)
    if args.method == "ilrma":
        solver = GaussILRMA(n_basis=args.n_basis, callbacks=callbacks, device=device)
    else:
        solver = AuxLaplaceIVA(algorithm_spatial="IP", callbacks=callbacks, device=device)
    Y = solver(X, iteration=args.iterations)
    y = istft(Y, fft_size=args.fft_size, hop_size=hop, length=mixture.shape[-1], device=device)

    # the improvement's baseline: PIT SI-SDR of the repeated reference-mic
    # mixture against the images
    before, _ = pit_si_sdr(mixture[0][None].expand(images.shape), images)
    sdri_improvement = [v - before for v in sdri_cb.history]
    write_curve(os.path.join(args.out, "loss_curve.csv"), solver.loss, "nll")
    write_curve(os.path.join(args.out, "sdri_curve.csv"), sdri_improvement, "si_sdr_improvement_db")
    plotted = maybe_plot(os.path.join(args.out, "loss_curve.png"), solver.loss, "negative log-likelihood")
    maybe_plot(os.path.join(args.out, "sdri_curve.png"), sdri_improvement, "SI-SDRi (dB)")
    for n in range(y.shape[0]):
        write_wav(os.path.join(args.out, "source_{}.wav".format(n)), y[n], sr)
    write_wav(os.path.join(args.out, "mixture_ref_mic.wav"), mixture[0], sr)

    summary = {
        "method": args.method,
        "iterations": args.iterations,
        "loss_first": float(solver.loss[0]),
        "loss_last": float(solver.loss[-1]),
        "si_sdr_improvement_db": float(sdri_improvement[-1]),
        "plots": bool(plotted),
        "out": args.out,
        "device": str(device),
    }
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
