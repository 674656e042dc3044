"""Synthesize convolutive mixtures (the reference's ``egs/*/prepare.sh`` and
``local/prepare.py`` script).

Two modes:

1. **Local-WAV mode** (``--sources``): mix user WAVs through user-supplied
   RIRs (.npy, shape (n_sources, n_mics, taps)) or deterministic synthetic
   RIRs.

2. **MIRD mode** (``--mird``): the reference's CMU-ARCTIC x MIRD pipeline --
   trim the per-speaker arctic_a000N utterances to a common length, convolve
   each with the 8-mic RIR at every degree on the MIRD grid, and write the
   reference's file layout::

       {data_root}/cmu_us_{title}_arctic/trimmed/source-16000.wav
       {data_root}/cmu_us_{title}_arctic/trimmed/convolved-16000_deg{D}-mic{M}.wav

   Measured MIRD .mat files are used when present under
   ``{data_root}/MIRD/Reverb{t60}_{intervals}/``, and local CMU-ARCTIC
   utterances where they are present; ``--download`` fetches both first.
   Without them the sources and RIRs are synthesized deterministically on
   the same array geometry (``utils.synthesis.mird_geometry_rirs``).

The convolutions run on ``--device`` (the CUDA card by default).

Examples:
    python -m audio_source_separation_tpu_torch.examples.prepare_mixture --sources a.wav b.wav \\
        --mics 2 --out mix
    python -m audio_source_separation_tpu_torch.examples.prepare_mixture --mird --data-root data \\
        --mird-degrees 0 45 315
"""

import argparse
import os

import numpy as np

from ..runtime import resolve_device
from ..utils import convolutive_mixture, read_wav, synthetic_room_impulse_responses, write_wav
from ..utils.synthesis import MIRD_DEGREES, mird_geometry_rirs

ARCTIC_URL = "http://festvox.org/cmu_arctic/packed/cmu_us_{title}_arctic.tar.bz2"
MIRD_URL = (
    "https://www.iks.rwth-aachen.de/fileadmin/user_upload/downloads/forschung/"
    "tools-downloads/Impulse_response_Acoustic_Lab_Bar-Ilan_University__"
    "Reverberation_{reverb}s__{mic_intervals}.zip"
)


def synthetic_speech(idx, n_samples=32000, sr=16000, seed=111):
    """Deterministic speech-like source (modulated noise), the offline
    stand-in for a CMU-ARCTIC utterance (the JAX package's examples draw
    the same)."""
    rng = np.random.RandomState(seed + idx)
    t = np.arange(n_samples) / sr
    env = 0.5 * (1 + np.sign(np.sin(2 * np.pi * (2.0 + 1.7 * idx) * t + idx)))
    env = np.convolve(env, np.ones(128) / 128, mode="same")
    return (env * rng.randn(n_samples) * 0.2).astype(np.float64)


def _fetch_arctic(data_root, title):
    """The reference's wget step (``prepare.sh:15-22``); True on success,
    False when the download fails."""
    import tarfile
    import urllib.request

    out_dir = os.path.join(data_root, "cmu_us_{}_arctic".format(title))
    if os.path.isdir(os.path.join(out_dir, "wav")):
        return True
    archive = os.path.join(data_root, "cmu_us_{}_arctic.tar.bz2".format(title))
    try:
        urllib.request.urlretrieve(ARCTIC_URL.format(title=title), archive)
        with tarfile.open(archive, "r:bz2") as tar:
            tar.extractall(data_root)
        return True
    except (OSError, tarfile.TarError) as exc:
        print("download failed ({}); using synthetic sources".format(exc))
        return False


def _fetch_mird(data_root, reverb=0.16, mic_intervals="3-3-3-8-3-3-3"):
    """The reference's MIRD download and unzip (``prepare.sh:23-29``); True
    when the dataset directory holds .mat files, False when the download
    fails."""
    import urllib.request
    import zipfile

    out_dir = os.path.join(data_root, "MIRD", "Reverb{:.3f}_{}".format(reverb, mic_intervals))
    if os.path.isdir(out_dir) and any(name.endswith(".mat") for name in os.listdir(out_dir)):
        return True
    os.makedirs(out_dir, exist_ok=True)
    archive = os.path.join(data_root, "MIRD", "mird.zip")
    url = MIRD_URL.format(reverb="{:.3f}".format(reverb), mic_intervals=mic_intervals)
    try:
        urllib.request.urlretrieve(url, archive)
        with zipfile.ZipFile(archive) as zf:
            zf.extractall(out_dir)
        return True
    except (OSError, zipfile.BadZipFile) as exc:
        print("MIRD download failed ({}); using synthetic RIRs".format(exc))
        return False


def _load_mird_rir(data_root, reverb, mic_intervals, distance, degree):
    """Measured MIRD RIR ``(samples, n_mics)`` when the dataset is present
    (the reference's path layout, ``local/prepare.py:60-64``), else None."""
    path = os.path.join(
        data_root,
        "MIRD/Reverb{:.3f}_{}/Impulse_response_Acoustic_Lab_Bar-Ilan_University_"
        "(Reverberation_{:.3f}s)_{}_{:.0f}m_{:03d}.mat".format(
            reverb, mic_intervals, reverb, mic_intervals, distance, degree
        ),
    )
    if not os.path.exists(path):
        return None
    from scipy.io import loadmat

    return loadmat(path)["impulse_response"]


def prepare_mird(
    data_root,
    titles=("aew", "axb", "bdl"),
    reverb=0.16,
    duration=0.5,
    mic_intervals="3-3-3-8-3-3-3",
    distance=1.0,
    degrees=None,
    sr=16000,
    download=False,
    seed=111,
    device=None,
):
    """The reference's MIRD preparation pipeline (``local/prepare.py:20-77``)
    with offline fallbacks.  Returns the list of written convolved paths."""
    device = resolve_device(device)
    degrees = list(MIRD_DEGREES if degrees is None else degrees)
    samples = int(duration * sr)
    os.makedirs(data_root, exist_ok=True)
    if download:
        _fetch_mird(data_root, reverb=reverb, mic_intervals=mic_intervals)

    raw = []
    for idx, title in enumerate(titles):
        wav = os.path.join(data_root, "cmu_us_{}_arctic/wav/arctic_a{:04d}.wav".format(title, idx + 1))
        if not os.path.exists(wav) and download:
            _fetch_arctic(data_root, title)
        if os.path.exists(wav):
            s, _ = read_wav(wav)
            if s.ndim > 1:
                s = s[:, 0]
        else:
            s = synthetic_speech(idx, seed=seed)
        raw.append(np.asarray(s, dtype=np.float64))

    # trim to the common length (``prepare.py:23-41``)
    t_min = min(len(s) for s in raw)
    written = []
    for idx, title in enumerate(titles):
        trimmed_dir = os.path.join(data_root, "cmu_us_{}_arctic/trimmed".format(title))
        os.makedirs(trimmed_dir, exist_ok=True)
        source = raw[idx][:t_min]
        write_wav(os.path.join(trimmed_dir, "source-{}.wav".format(sr)), source, sr)
        for degree in degrees:
            rir = _load_mird_rir(data_root, reverb, mic_intervals, distance, degree)
            if rir is None:
                rir = mird_geometry_rirs(
                    degree, mic_intervals=mic_intervals, distance=distance, reverb=reverb, sr=sr,
                    samples=samples, seed=seed, device=device,
                )
            rir = rir[:samples]
            # every mic's full convolution, (1, n_mics, t_min + taps - 1)
            _, convolved = convolutive_mixture(source[None], rir.T[None], n_samples=t_min + rir.shape[0] - 1, device=device)
            for mic_idx in range(convolved.shape[1]):
                path = os.path.join(trimmed_dir, "convolved-{}_deg{}-mic{}.wav".format(sr, degree, mic_idx))
                write_wav(path, convolved[0, mic_idx], sr)
                written.append(path)
    return written


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--sources", nargs="+", default=None)
    parser.add_argument("--rirs", default=None, help=".npy (n_sources, n_mics, taps)")
    parser.add_argument("--mics", type=int, default=2)
    parser.add_argument("--taps", type=int, default=64)
    parser.add_argument("--seed", type=int, default=111)
    parser.add_argument("--out", default="mixture")
    parser.add_argument("--mird", action="store_true", help="CMU-ARCTIC x MIRD pipeline")
    parser.add_argument("--data-root", default="data")
    parser.add_argument("--titles", default="aew axb bdl")
    parser.add_argument("--reverb", type=float, default=0.16)
    parser.add_argument("--duration", type=float, default=0.5)
    parser.add_argument("--mic-intervals", default="3-3-3-8-3-3-3")
    parser.add_argument("--distance", type=float, default=1.0)
    parser.add_argument("--mird-degrees", nargs="+", type=int, default=None)
    parser.add_argument("--download", action="store_true", help="attempt the reference's CMU-ARCTIC download")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    if args.mird or args.mird_degrees is not None:
        written = prepare_mird(
            args.data_root, titles=args.titles.split(), reverb=args.reverb, duration=args.duration,
            mic_intervals=args.mic_intervals, distance=args.distance, degrees=args.mird_degrees,
            download=args.download, seed=args.seed, device=device,
        )
        print("wrote {} convolved wavs under {}".format(len(written), args.data_root))
        return written
    if not args.sources:
        raise SystemExit("either --sources or --mird is required")

    signals, sr = [], None
    for path in args.sources:
        s, sr = read_wav(path)
        signals.append(s[:, 0] if s.ndim > 1 else s)
    length = min(len(s) for s in signals)
    sources = np.stack([s[:length] for s in signals])
    if args.rirs:
        rirs = np.load(args.rirs)
    else:
        rirs = synthetic_room_impulse_responses(len(sources), args.mics, taps=args.taps, seed=args.seed, device=device)
    mixture, images = convolutive_mixture(sources, rirs, device=device)
    os.makedirs(args.out, exist_ok=True)
    write_wav(os.path.join(args.out, "mixture.wav"), mixture.T, sr)
    for n in range(images.shape[0]):
        write_wav(os.path.join(args.out, "image_{}_mic0.wav".format(n)), images[n, 0], sr)
    print("wrote mixture ({} mics) and {} reference images to {}".format(mixture.shape[0], images.shape[0], args.out))
    return [args.out]


if __name__ == "__main__":
    main()
