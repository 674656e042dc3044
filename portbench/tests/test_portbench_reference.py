"""The plain references against scipy and against the program at float64
on the CPU (the test may import the program; the references may not)."""

import json

import numpy as np
import pytest
import scipy.signal
import torch

from portbench.reference import auxiva_ip_c2, common, room
from portbench.tests._support import REPO

CONFIG = json.loads((REPO / "portbench" / "configs" / "auxiva_ip_c2.json").read_text())
FFT, HOP = CONFIG["stft"]["fft_size"], CONFIG["stft"]["hop_size"]
EXACT = common.Arith("float64", "cpu")


@pytest.fixture(scope="module")
def mixture():
    return room.recordings(1, 2, 3 * 16000, 16000, 2**31 + 5, torch.device("cpu"))[0].astype(np.float64)


@pytest.mark.parametrize("fft_size, hop_size", [(FFT, HOP), (4096, 2048)])
def test_stft_and_istft_match_scipy(mixture, fft_size, hop_size):
    X = common.stft(mixture, fft_size, hop_size, EXACT)
    _, _, ref = scipy.signal.stft(mixture, nperseg=fft_size, noverlap=fft_size - hop_size)
    assert X.shape == ref.shape
    assert np.abs(X.numpy() - ref).max() <= 1e-12 * np.abs(ref).max()
    y = common.istft(X, fft_size, hop_size, mixture.shape[-1], EXACT)
    _, ref_y = scipy.signal.istft(ref, nperseg=fft_size, noverlap=fft_size - hop_size)
    assert np.abs(y.numpy() - ref_y[:, : mixture.shape[-1]]).max() <= 1e-12
    assert np.abs(y.numpy() - mixture).max() <= 1e-12


def test_tf32_rounding():
    x = torch.tensor([1.0, 1 + 2**-10, 1 + 2**-11, 1 + 3 * 2**-11, -1 - 2**-11 - 2**-20, 3.0e-20])
    r = common.tf32_round(x)
    assert r.tolist()[:4] == [1.0, 1 + 2**-10, 1.0, 1 + 2**-9]  # to nearest, ties to even
    assert r[4].item() == -1 - 2**-10
    assert (r.view(torch.int32) & 0x1FFF).eq(0).all()


def _port_run(x, iteration):
    import audio_source_separation_tpu_torch as port

    system = CONFIG["system"]
    X = port.stft(torch.as_tensor(x), FFT, HOP, device="cpu")
    solver = getattr(port, system["entry"])(**system["kwargs"], device="cpu")
    Y = solver(X, iteration=iteration)
    y = port.istft(Y, FFT, HOP, length=x.shape[-1], device="cpu")
    return {"spec": X, "loss": torch.tensor(solver.loss, dtype=torch.float64), "demix_filter": solver.demix_filter, "output": y}


@pytest.mark.parametrize("iteration", [1, 12])
def test_reference_agrees_with_the_program_at_float64(mixture, iteration):
    config = json.loads(json.dumps(CONFIG))
    config["system"]["iteration"] = iteration
    ref = auxiva_ip_c2.run(mixture, config, EXACT)
    got = _port_run(mixture, iteration)
    assert ref["loss"].shape == (iteration + 1,)
    assert (got["spec"] - ref["spec"]).abs().max() <= 1e-12 * ref["spec"].abs().max()
    assert (got["loss"] - ref["loss"]).abs().max() <= 1e-10 * ref["loss"].abs().max()
    assert (got["demix_filter"] - ref["demix_filter"]).norm() <= 1e-10 * ref["demix_filter"].norm()
    # the program's projection-back ridges its Gram by 1e-12 of its trace
    assert ((got["output"] - ref["output"]).norm(dim=-1) / ref["output"].norm(dim=-1)).max() <= 1e-9


def test_the_control_is_the_reference_at_lower_precision(mixture):
    config = json.loads(json.dumps(CONFIG))
    config["system"]["iteration"] = 5
    ref = auxiva_ip_c2.run(mixture, config, EXACT)
    ctl = auxiva_ip_c2.run(mixture, config, common.Arith("tf32", "cpu"))
    assert ctl["spec"].dtype == torch.complex64 and ctl["output"].dtype == torch.float32
    gap = (ctl["spec"].to(torch.complex128) - ref["spec"]).abs().max() / ref["spec"].abs().max()
    assert 1e-6 < gap < 1e-2
