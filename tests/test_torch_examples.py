"""The port's example scripts end to end on the CPU (``--device cpu``),
writing the artefacts that ``tests/test_examples.py`` checks for the JAX
package's scripts; ``separate`` (IVA, ILRMA and IDLMA with its per-source
MLP) and ``walkthrough`` are held to the JAX scripts' summaries and curves
on the same input, and each script defaults to the card."""

import csv
import json
import os
import runpy
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from audio_source_separation_tpu.utils import read_wav as jax_read_wav
from audio_source_separation_tpu_torch.examples import beamform, decompose_nmf, prepare_mixture, separate, walkthrough
from audio_source_separation_tpu_torch.utils import read_wav, write_wav

JAX_EXAMPLES = Path(__file__).resolve().parent.parent / "examples"


def _run_jax_example(name, argv):
    old_argv = sys.argv
    sys.argv = [name] + argv
    sys.path.insert(0, str(JAX_EXAMPLES))
    try:
        runpy.run_path(str(JAX_EXAMPLES / name), run_name="__main__")
    finally:
        sys.argv = old_argv
        sys.path.remove(str(JAX_EXAMPLES))


def _write_mixture_wav(tmp_path, n_channels=2, n_samples=6000):
    rng = np.random.RandomState(0)
    S = rng.randn(n_channels, n_samples) * 0.1
    A = np.eye(n_channels) + 0.5 * rng.rand(n_channels, n_channels)
    wav = str(tmp_path / "mix.wav")
    write_wav(wav, A @ S, 16000, channel_last=False)
    return wav


def _summary(out):
    with open(os.path.join(out, "summary.json")) as f:
        return json.load(f)


# every method of separate.py at a tiny config
SEPARATE_METHODS = [
    ("auxiva", ["--spatial", "IP"]),
    ("auxiva", ["--spatial", "ISS"]),
    ("auxiva", ["--spatial", "IP2"]),
    ("auxiva-gauss", []),
    ("proxiva", []),
    ("fdica", []),
    ("fdica-grad", []),
    ("ilrma", ["--n-basis", "2"]),
    ("tilrma", ["--n-basis", "2", "--nu", "1"]),
    ("mnmf", ["--n-basis", "2"]),
    ("fastmnmf", ["--n-basis", "2"]),
    # 64 blocks of 2-3 bins: the compact route of the JAX benchmark rows (the
    # matrix route's small complex128 eigh take 40 s on a CPU shared by the
    # suite's workers; tests/test_torch_ipsdta.py holds that route)
    ("ipsdta", ["--n-basis", "2", "--n-blocks", "64"]),
    ("idlma", ["--hidden", "32"]),
]


@pytest.mark.parametrize("method,extra", SEPARATE_METHODS, ids=lambda v: "-".join(v) if isinstance(v, list) else v)
def test_separate_every_method(tmp_path, method, extra):
    wav = _write_mixture_wav(tmp_path)
    out = str(tmp_path / "sep")
    separate.main(["--input", wav, "--method", method, "--iterations", "2", "--fft-size", "256", "--out", out,
                   "--device", "cpu"] + extra)
    summary = _summary(out)
    assert summary["method"] == method and summary["outputs"] == 2 and summary["device"] == "cpu"
    for n in range(2):
        y, _ = read_wav(os.path.join(out, "source_{}.wav".format(n)))
        assert np.all(np.isfinite(y))


@pytest.mark.parametrize("method,extra", [("auxiva", []), ("ilrma", ["--n-basis", "2"]), ("idlma", ["--hidden", "32"])])
def test_separate_matches_the_jax_example(tmp_path, method, extra):
    """The same wav through both scripts: the same losses, and the same
    written sources (int16, so up to one quantisation step)."""
    wav = _write_mixture_wav(tmp_path)
    argv = ["--input", wav, "--method", method, "--iterations", "3", "--fft-size", "256"] + extra
    _run_jax_example("separate.py", argv + ["--out", str(tmp_path / "jax")])
    separate.main(argv + ["--out", str(tmp_path / "port"), "--device", "cpu"])
    ours, theirs = _summary(tmp_path / "port"), _summary(tmp_path / "jax")
    np.testing.assert_allclose([ours["loss_first"], ours["loss_last"]], [theirs["loss_first"], theirs["loss_last"]],
                               rtol=1e-9)
    for n in range(2):
        a, _ = read_wav(str(tmp_path / "port" / "source_{}.wav".format(n)))
        b, _ = jax_read_wav(str(tmp_path / "jax" / "source_{}.wav".format(n)))
        np.testing.assert_allclose(a, b, atol=1.0 / 32768)


def _curve(path):
    with open(path) as f:
        rows = list(csv.reader(f))[1:]
    return np.array([float(v) for _, v in rows])


def test_walkthrough_produces_all_artifacts_and_matches_the_jax_example(tmp_path):
    argv = ["--iterations", "3", "--n-basis", "2"]
    out = str(tmp_path / "walkthrough")
    walkthrough.main(argv + ["--out", out, "--device", "cpu"])
    for artifact in ("loss_curve.csv", "sdri_curve.csv", "source_0.wav", "source_1.wav", "mixture_ref_mic.wav",
                     "summary.json"):
        assert os.path.exists(os.path.join(out, artifact)), artifact
    assert sorted(os.listdir(os.path.join(out, "state"))) == ["state_{}.npz".format(k) for k in range(4)]
    summary = _summary(out)
    assert np.isfinite(summary["loss_last"]) and np.isfinite(summary["si_sdr_improvement_db"])
    sdri = _curve(os.path.join(out, "sdri_curve.csv"))
    assert len(sdri) == 4  # init and each iteration

    _run_jax_example("walkthrough.py", argv + ["--out", str(tmp_path / "jax")])
    np.testing.assert_allclose(_curve(os.path.join(out, "loss_curve.csv")),
                               _curve(str(tmp_path / "jax" / "loss_curve.csv")), rtol=1e-9)
    # the init's estimate is orthogonal to a target (rounding noise in both
    # packages, see tests/test_torch_utils_harness.py): held to -20 dB
    reference = _curve(str(tmp_path / "jax" / "sdri_curve.csv"))
    degenerate = reference < -20
    assert (sdri[degenerate] < -20).all()
    np.testing.assert_allclose(sdri[~degenerate], reference[~degenerate], rtol=0, atol=1e-6)


def test_walkthrough_auxiva(tmp_path):
    out = str(tmp_path / "walkthrough")
    walkthrough.main(["--method", "auxiva", "--iterations", "2", "--out", out, "--device", "cpu"])
    assert len(_curve(os.path.join(out, "sdri_curve.csv"))) == 3
    assert not os.path.exists(os.path.join(out, "state"))


@pytest.mark.parametrize("method", ["dsbf", "mvdr"])
def test_beamform_example(tmp_path, method):
    wav = _write_mixture_wav(tmp_path)
    out = str(tmp_path / "bf")
    beamform.main(["--input", wav, "--method", method, "--degrees", "0", "90", "--mic-positions", "-0.04", "0.04",
                   "--fft-size", "256", "--out", out, "--device", "cpu"])
    for n in range(2):
        y, _ = read_wav(os.path.join(out, "source_{}.wav".format(n)))
        assert np.all(np.isfinite(y)) and np.abs(y).max() > 0


@pytest.mark.parametrize("metric", ["EUC", "KL", "IS", "t", "Cauchy"])
def test_decompose_nmf_example(tmp_path, metric):
    rng = np.random.RandomState(0)
    wav = str(tmp_path / "mono.wav")
    write_wav(wav, rng.randn(6000) * 0.1, 16000)
    out = str(tmp_path / "nmf")
    decompose_nmf.main(["--input", wav, "--metric", metric, "--n-basis", "2", "--iterations", "3", "--fft-size",
                        "256", "--hop-size", "128", "--out", out, "--device", "cpu"])
    with np.load(os.path.join(out, "factors.npz")) as factors:
        assert factors["basis"].shape[1] == 2
        assert np.all(np.isfinite(factors["basis"]))
    for k in range(2):
        assert os.path.exists(os.path.join(out, "basis_{}.wav".format(k)))


def test_prepare_mixture_local_sources(tmp_path):
    rng = np.random.RandomState(1)
    paths = []
    for n in range(2):
        paths.append(str(tmp_path / "s{}.wav".format(n)))
        write_wav(paths[-1], rng.randn(4000) * 0.1, 16000)
    out = str(tmp_path / "mix")
    prepare_mixture.main(["--sources"] + paths + ["--mics", "3", "--taps", "16", "--out", out, "--device", "cpu"])
    mixture, sr = read_wav(os.path.join(out, "mixture.wav"))
    assert sr == 16000 and mixture.shape == (4000, 3)
    for n in range(2):
        assert os.path.exists(os.path.join(out, "image_{}_mic0.wav".format(n)))


def test_prepare_mixture_mird_matches_the_jax_example(tmp_path):
    """The offline MIRD route (synthetic sources and RIRs on the array
    geometry) writes the reference's layout, with the JAX script's wavs."""
    argv = ["--mird-degrees", "0", "315", "--titles", "aew axb", "--duration", "0.05"]
    prepare_mixture.main(argv + ["--data-root", str(tmp_path / "port"), "--device", "cpu"])
    _run_jax_example("prepare_mixture.py", argv + ["--data-root", str(tmp_path / "jax")])
    for title in ("aew", "axb"):
        trimmed = Path("cmu_us_{}_arctic".format(title)) / "trimmed"
        names = sorted(os.listdir(tmp_path / "port" / trimmed))
        assert names == sorted(os.listdir(tmp_path / "jax" / trimmed)) and len(names) == 1 + 2 * 8
        for name in names:
            a, _ = read_wav(str(tmp_path / "port" / trimmed / name))
            b, _ = read_wav(str(tmp_path / "jax" / trimmed / name))
            np.testing.assert_allclose(a, b, atol=1.0 / 32768)


@pytest.mark.parametrize("script", [separate, walkthrough, beamform, decompose_nmf, prepare_mixture])
def test_examples_default_to_the_card(script, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    argv = {
        separate: ["--input", "x.wav"],
        walkthrough: ["--out", str(tmp_path)],
        beamform: ["--input", "x.wav", "--degrees", "0", "--mic-positions", "0"],
        decompose_nmf: ["--input", "x.wav"],
        prepare_mixture: ["--mird"],
    }[script]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        script.main(argv)
