"""The port's Sawada MNMF loss against a plain float64 evaluation of its
definition on the CPU, at complex64 and complex128.

The loss is the log-det divergence of the PSD projections, ``sum tr(X'
X^'^-1) - log det X' + log det X^' - C`` over every (bin, frame), with
``M' = M + (eps tr M + eps) I`` for the observed ``X = x x^H`` and the
PSD model ``X^``.  ``x x^H`` is rank 1: its eigenvalues are ``|x|^2`` and
``C - 1`` zeros, so ``det X' = (|x|^2 + r) r^(C - 1)`` with ``r = eps |x|^2
+ eps``.  A closed-form eigvalsh returns those zeros as rounding noise
(about 1e-7 of the trace at float32, 1e-8 at float64 and C = 3), far above
``eps |x|^2``; taken so, they moved the loss by a constant of the data: here
by 8% (C = 2) and 25% (C = 3) at complex64, 5e-7 and 7% at complex128.
Each loss is held against the definition on the state the callbacks saw.
"""

import numpy as np
import pytest
import torch

import audio_source_separation_tpu_torch as port

from _torch_port import SawadaStates
from conftest import make_mixture

ITERATIONS = 3


def plain_loss(X, state, eps):
    """The definition at float64 from the mixture ``X (C, F, T)`` and a
    ``(latent, spatial, basis, activation)`` state."""
    Z, H, T, V = (np.asarray(v).astype(np.complex128 if np.iscomplexobj(v) else np.float64) for v in state)
    C = X.shape[0]
    x = np.moveaxis(X.astype(np.complex128), 0, -1)  # (F, T, C)
    power = (np.abs(x) ** 2).sum(axis=-1)
    r = eps * power + eps
    Xo = x[..., :, None] * x[..., None, :].conj() + r[..., None, None] * np.eye(C)
    Xh = np.einsum("sk,fk,kt,fscd->ftcd", Z, T, V, H)
    Xh = Xh + (eps * np.trace(Xh, axis1=-2, axis2=-1).real + eps)[..., None, None] * np.eye(C)
    trace = np.trace(Xo @ np.linalg.inv(Xh), axis1=-2, axis2=-1).real
    logdet_o = np.log(power + r) + (C - 1) * np.log(r)
    logdet_h = np.linalg.slogdet(Xh)[1]
    return float((trace - logdet_o + logdet_h - C).sum())


@pytest.mark.parametrize("n_channels", [2, 3])
@pytest.mark.parametrize("dtype, rtol", [(np.complex64, 2e-6), (np.complex128, 1e-12)], ids=["complex64", "complex128"])
def test_sawada_loss_is_its_definition(n_channels, dtype, rtol):
    X = make_mixture(np.random.RandomState(111), n_channels=n_channels, n_bins=17, n_frames=24).astype(dtype)
    states = SawadaStates()
    solver = port.MultichannelISNMF(n_basis=3, author="Sawada", callbacks=states, device="cpu")
    np.random.seed(111)
    solver(torch.from_numpy(X), iteration=ITERATIONS)
    assert len(solver.loss) == len(states.states) == ITERATIONS + 1
    expected = [plain_loss(X, state, solver.eps) for state in states.states]
    np.testing.assert_allclose(solver.loss, expected, rtol=rtol)
