"""End-to-end separation script:

    wav -> stft -> solver(X, iteration=N) -> istft -> wavs (+ summary.json)

Examples:
    python -m audio_source_separation_tpu_torch.examples.separate --input mixture.wav \\
        --method auxiva --iterations 50
    python -m audio_source_separation_tpu_torch.examples.separate --input mixture.wav \\
        --method ilrma --n-basis 2 --fft-size 4096 --iterations 100 --out sep --device cpu
"""

import argparse
import json
import os

import numpy as np
import torch

from .. import (
    TILRMA,
    AuxGaussIVA,
    AuxLaplaceIVA,
    FastMultichannelISNMF,
    GaussIDLMA,
    GaussILRMA,
    GaussIPSDTA,
    GradLaplaceFDICA,
    MultichannelISNMF,
    NaturalGradLaplaceFDICA,
    ProxLaplaceIVA,
    istft,
    stft,
    torch_dnn,
)
from ..runtime import resolve_device
from ..utils import read_wav, write_wav

METHODS = (
    "auxiva", "auxiva-gauss", "proxiva", "fdica", "fdica-grad", "ilrma", "tilrma", "mnmf", "fastmnmf", "ipsdta",
    "idlma",
)  # fmt: skip


class IDLMAMLP(torch.nn.Module):
    """Per-source variance MLP of the reference's IDLMA example: one
    ``n_bins -> hidden -> n_bins`` network per source over frame-batched
    amplitude spectra, every layer ending in ReLU, weights ``(d_in,
    d_out)`` and biases drawn ``uniform(-1/sqrt(d_in), 1/sqrt(d_in))`` from
    ``RandomState(seed)`` in the order of the JAX package's example.  The
    reference runs it untrained, so its output is example parity, not a
    quality claim."""

    def __init__(self, n_bins, n_sources, hidden=1024, num_layers=2, seed=111):
        super().__init__()
        rng = np.random.RandomState(seed)
        dims = [n_bins] + [hidden] * (num_layers - 1) + [n_bins]
        self.layers = torch.nn.ParameterList()
        for _ in range(n_sources):
            for d_in, d_out in zip(dims[:-1], dims[1:]):
                bound = 1.0 / np.sqrt(d_in)
                self.layers.append(torch.nn.Parameter(torch.as_tensor(rng.uniform(-bound, bound, (d_in, d_out)))))
                self.layers.append(torch.nn.Parameter(torch.as_tensor(rng.uniform(-bound, bound, (d_out,)))))
        self.n_sources, self.n_layers = n_sources, len(dims) - 1

    def forward(self, amplitude):  # (n_sources, n_bins, n_frames)
        outs = []
        for s in range(self.n_sources):
            h = amplitude[s].T  # frames are the batch
            for k in range(self.n_layers):
                index = 2 * (s * self.n_layers + k)
                h = torch.relu(h @ self.layers[index] + self.layers[index + 1])
            outs.append(h.T)
        return torch.stack(outs)


def build_solver(args):
    device = args.device
    if args.method == "auxiva":
        return AuxLaplaceIVA(algorithm_spatial=args.spatial, device=device)
    if args.method == "auxiva-gauss":
        return AuxGaussIVA(algorithm_spatial=args.spatial, device=device)
    if args.method == "proxiva":
        return ProxLaplaceIVA(device=device)
    if args.method == "fdica":
        return NaturalGradLaplaceFDICA(lr=args.lr, device=device)
    if args.method == "fdica-grad":
        return GradLaplaceFDICA(lr=args.lr, device=device)
    if args.method == "ilrma":
        return GaussILRMA(n_basis=args.n_basis, algorithm_spatial=args.spatial, device=device)
    if args.method == "tilrma":
        return TILRMA(n_basis=args.n_basis, nu=args.nu, device=device)
    if args.method == "mnmf":
        return MultichannelISNMF(n_basis=args.n_basis, author="Sawada", device=device)
    if args.method == "fastmnmf":
        return FastMultichannelISNMF(n_basis=args.n_basis, device=device)
    if args.method == "ipsdta":
        return GaussIPSDTA(n_basis=args.n_basis, author="Kondo", n_blocks=args.n_blocks, device=device)
    if args.method == "idlma":
        # the variance network runs in the loop on the solver's device
        return GaussIDLMA(normalize="projection-back", device=device)
    raise ValueError("unknown method {}".format(args.method))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--input", required=True, help="multichannel WAV file")
    parser.add_argument("--method", default="auxiva", choices=METHODS)
    parser.add_argument("--spatial", default="IP", help="IP | ISS | IP2")
    parser.add_argument("--iterations", type=int, default=50)
    parser.add_argument("--fft-size", type=int, default=2048)
    parser.add_argument("--hop-size", type=int, default=None)
    parser.add_argument("--n-basis", type=int, default=10)
    parser.add_argument("--n-blocks", type=int, default=None)
    parser.add_argument("--nu", type=float, default=1000.0)
    parser.add_argument("--lr", type=float, default=0.1)
    parser.add_argument("--hidden", type=int, default=1024, help="idlma: hidden width of the per-source variance MLP")
    parser.add_argument("--seed", type=int, default=111)
    parser.add_argument("--out", default="separated")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    args.device = resolve_device(args.device)
    hop = args.hop_size or args.fft_size // 2
    if args.n_blocks is None:
        args.n_blocks = (args.fft_size // 2 + 1) // 2

    x, sr = read_wav(args.input)
    if x.ndim == 1:
        raise SystemExit("input must be multichannel")
    x = x.T  # (n_channels, n_samples)

    X = stft(x, fft_size=args.fft_size, hop_size=hop, device=args.device)
    np.random.seed(args.seed)
    solver = build_solver(args)
    call_kwargs = {}
    if args.method == "idlma":
        mlp = IDLMAMLP(n_bins=args.fft_size // 2 + 1, n_sources=x.shape[0], hidden=args.hidden, seed=args.seed)
        call_kwargs["dnn"] = torch_dnn(mlp.to(args.device, solver.input_dtype(X).to_real()))
    Y = solver(X, iteration=args.iterations, **call_kwargs)
    y = istft(Y, fft_size=args.fft_size, hop_size=hop, length=x.shape[-1], device=args.device)

    os.makedirs(args.out, exist_ok=True)
    for n in range(y.shape[0]):
        write_wav(os.path.join(args.out, "source_{}.wav".format(n)), y[n], sr)
    summary = {
        "method": args.method,
        "iterations": args.iterations,
        "loss_first": solver.loss[0] if solver.loss else None,
        "loss_last": solver.loss[-1] if solver.loss else None,
        "outputs": y.shape[0],
        "device": str(args.device),
    }
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
