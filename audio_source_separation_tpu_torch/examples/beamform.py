"""Beamforming script with geometry-derived steering vectors (the reference's
``egs/bss-example/{dsbf,mvdr}`` notebooks and ``bss/beamform.py:199-233``):
a linear microphone array, far-field steering vectors from source angles,
DSBF or MVDR on ``--device`` (the CUDA card by default).

Example (2 sources at 0 and 90 degrees, 8-mic linear array):
    python -m audio_source_separation_tpu_torch.examples.beamform --input mixture8ch.wav \\
        --method mvdr --degrees 0 90 \\
        --mic-positions -0.13 -0.10 -0.07 -0.04 0.04 0.07 0.10 0.13
"""

import argparse
import json
import os

import numpy as np

from .. import DelaySumBeamformer, MVDRBeamformer, istft, stft
from ..runtime import resolve_device
from ..utils import read_wav, write_wav

SOUND_SPEED = 340.0


def linear_array_steering(degrees, mic_positions, n_bins, sr, fft_size):
    """Far-field steering vectors ``(n_bins, n_mics, n_sources)`` complex for
    a linear array on the x-axis (``beamform.py:199-203``)."""
    degrees = np.asarray(degrees, dtype=float) / 180 * np.pi
    source_dir = np.stack([np.sin(degrees), np.cos(degrees)], axis=1)  # (S, 2)
    mic_positions = np.asarray(mic_positions, dtype=float)
    if mic_positions.ndim == 1:
        mic_positions = np.stack([mic_positions, np.zeros_like(mic_positions)], axis=1)  # (M, 2)
    frequency = np.arange(n_bins) * sr / fft_size
    delay = mic_positions @ source_dir.T / SOUND_SPEED  # (M, S) seconds
    steering = np.exp(2j * np.pi * frequency[:, None, None] * delay[None])
    return steering / np.sqrt(mic_positions.shape[0])


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--input", required=True, help="multichannel WAV")
    parser.add_argument("--method", default="mvdr", choices=["dsbf", "mvdr"])
    parser.add_argument("--degrees", type=float, nargs="+", required=True)
    parser.add_argument("--mic-positions", type=float, nargs="+", required=True,
                        help="x-coordinates (metres) of the linear array")
    parser.add_argument("--fft-size", type=int, default=2048)
    parser.add_argument("--hop-size", type=int, default=None)
    parser.add_argument("--reference-id", type=int, default=0)
    parser.add_argument("--out", default="beamformed")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    hop = args.hop_size or args.fft_size // 2

    x, sr = read_wav(args.input)
    x = x.T  # (n_mics, n_samples)
    if x.shape[0] != len(args.mic_positions):
        raise SystemExit("channel count != number of mic positions")

    X = stft(x, fft_size=args.fft_size, hop_size=hop, device=device)
    steering = linear_array_steering(args.degrees, args.mic_positions, X.shape[1], sr, args.fft_size)
    make = DelaySumBeamformer if args.method == "dsbf" else MVDRBeamformer
    beamformer = make(steering_vector=steering, reference_id=args.reference_id, device=device)
    Y = beamformer(X)
    y = istft(Y, fft_size=args.fft_size, hop_size=hop, length=x.shape[-1], device=device)

    os.makedirs(args.out, exist_ok=True)
    for n in range(y.shape[0]):
        write_wav(os.path.join(args.out, "source_{}.wav".format(n)), y[n], sr)
    summary = {"method": args.method, "outputs": int(y.shape[0]), "device": str(device)}
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
