"""Single-channel NMF decomposition script (the reference's
``egs/nmf-example`` notebooks): wav -> power spectrogram -> NMF (basis,
activation) -> per-basis Wiener-masked reconstructions, on ``--device`` (the
CUDA card by default).

Example:
    python -m audio_source_separation_tpu_torch.examples.decompose_nmf --input sample.wav \\
        --metric EUC --n-basis 6 --iterations 100 --out nmf
"""

import argparse
import json
import os

import numpy as np
import torch

from .. import EUCNMF, ISNMF, KLNMF, TNMF, CauchyNMF, istft, stft
from ..runtime import resolve_device
from ..utils import read_wav, write_wav

METRICS = {"EUC": EUCNMF, "KL": KLNMF, "IS": ISNMF, "t": TNMF, "Cauchy": CauchyNMF}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--input", required=True)
    parser.add_argument("--metric", default="EUC", choices=sorted(METRICS))
    parser.add_argument("--n-basis", type=int, default=6)
    parser.add_argument("--iterations", type=int, default=100)
    parser.add_argument("--fft-size", type=int, default=1024)
    parser.add_argument("--hop-size", type=int, default=256)
    parser.add_argument("--seed", type=int, default=111)
    parser.add_argument("--out", default="nmf")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    x, sr = read_wav(args.input)
    if x.ndim > 1:
        x = x[:, 0]
    X = stft(x, fft_size=args.fft_size, hop_size=args.hop_size, device=device)
    power = torch.abs(X) ** 2

    np.random.seed(args.seed)
    model = METRICS[args.metric](n_basis=args.n_basis, device=device)
    T, V = model(power, iteration=args.iterations)

    os.makedirs(args.out, exist_ok=True)
    np.savez(os.path.join(args.out, "factors.npz"), basis=T.cpu().numpy(), activation=V.cpu().numpy())

    # per-basis Wiener reconstruction
    T, V = T.to(power.dtype), V.to(power.dtype)
    TV = torch.clamp(T @ V, min=1e-12)
    for k in range(args.n_basis):
        mask = torch.outer(T[:, k], V[k]) / TV
        y = istft(X * mask, fft_size=args.fft_size, hop_size=args.hop_size, length=len(x), device=device)
        write_wav(os.path.join(args.out, "basis_{}.wav".format(k)), y, sr)

    summary = {
        "metric": args.metric,
        "loss_first": model.loss[0],
        "loss_last": model.loss[-1],
        "n_basis": args.n_basis,
        "device": str(device),
    }
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
