"""The port's factorisation models against the JAX package on the CPU at
float64.

Each case runs both packages on the same seeded target from the same
initial factors and compares the whole loss trajectory (rtol 1e-9; no entry
before the first update) and the final factors (atol 1e-8).  Init draws,
warm start, callbacks, checkpoints, the raises and the TF32 scope are in
``test_torch_nmf_state.py``; the helpers in ``test_torch_factor_ops.py``.
"""

import numpy as np
import pytest
import torch

import audio_source_separation_tpu.models as jax_models
import audio_source_separation_tpu_torch as port
import audio_source_separation_tpu_torch.models as port_models
from audio_source_separation_tpu_torch.models import mnmf as port_mnmf
from audio_source_separation_tpu_torch.models import nmf as port_nmf

from _torch_port import ITERATIONS, N_BASIS, covariance_target, factors, make_target, to_np

KIND = {"ComplexEUCNMF": "complex", "CovarianceISNMF": "covariance", "EUCNTF": "ntf"}

CASES = [
    ("EUCNMF", {}, 2),
    ("EUCNMF", {"domain": 1.5}, 2),
    ("KLNMF", {}, 2),
    ("KLNMF", {"domain": 1.2}, 2),
    ("ISNMF", {}, 2),
    ("ISNMF", {"domain": 1.5}, 2),
    ("ISNMF", {"algorithm": "me"}, 2),
    ("TNMF", {"nu": 100}, 2),
    ("CauchyNMF", {}, 2),
    ("CauchyNMF", {"algorithm": "mm"}, 2),
    ("CauchyNMF", {"algorithm": "me"}, 2),
    ("CauchyNMF", {"algorithm": "mm_fast"}, 2),
    ("ComplexEUCNMF", {"regularizer": 0.0}, 2),
    ("ComplexEUCNMF", {"regularizer": 0.1}, 2),
    ("ComplexEUCNMF", {"regularizer": 0.1, "p": 0.5}, 2),
    ("CovarianceISNMF", {}, 2),
    ("CovarianceISNMF", {"riccati_planes": False}, 2),
    ("CovarianceISNMF", {"normalize": False}, 2),
    ("CovarianceISNMF", {}, 3),
    ("EUCNTF", {}, 3),
]


def _case_id(case):
    name, kwargs, n_channels = case
    return "-".join([name] + ["{}={}".format(k, v) for k, v in kwargs.items()] + ["C{}".format(n_channels)])


def build(package, name, kwargs, **more):
    """``package``'s model ``name``; ``riccati_planes`` is a class switch,
    set on the instance."""
    kwargs = dict(kwargs)
    riccati_planes = kwargs.pop("riccati_planes", None)
    model = getattr(package, name)(n_basis=N_BASIS, **kwargs, **more)
    if riccati_planes is not None:
        model.riccati_planes = riccati_planes
    return model


@pytest.mark.parametrize("name,kwargs,n_channels", CASES, ids=[_case_id(c) for c in CASES])
def test_matches_jax_trajectory(rng, name, kwargs, n_channels):
    kind = KIND.get(name, "nmf")
    target = make_target(kind, rng, n_channels=n_channels)
    init = factors(kind, target)
    ref = build(jax_models, name, kwargs)
    out_ref = ref(target, iteration=ITERATIONS, **init)
    ours = build(port, name, kwargs, device="cpu")
    out = ours(target, iteration=ITERATIONS, **init)
    assert len(ours.loss) == len(ref.loss) == ITERATIONS
    np.testing.assert_allclose(ours.loss, ref.loss, rtol=1e-9)
    assert len(out) == len(out_ref)
    for got, want in zip(out, out_ref):
        assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
        np.testing.assert_allclose(to_np(got), np.asarray(want), atol=1e-8)


def test_covariance_isnmf_float32_dynamic_range(rng):
    """The JAX package's float32 guard (``tests/test_nmf.py``): covariances
    over 18 decades of bins with near-silent frames stay finite at complex64
    on the CPU, and the loss falls, through the equilibration, the
    scale-relative ridge and the trace floors."""
    X = covariance_target(rng, n_bins=9, n_frames=16, spread=True).astype(np.complex64)
    np.random.seed(111)
    model = port.CovarianceISNMF(n_basis=3, device="cpu")
    H, T, V = model(X, iteration=10)
    losses = np.asarray(model.loss)
    assert H.dtype == torch.complex64 and T.dtype == V.dtype == torch.float32
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    assert all(torch.isfinite(a).all() for a in (H, T, V))


def test_exports_match_jax():
    """The JAX names of slice 4: ``tNMF`` is ``TNMF``; ``CovarianceISNMF``
    is ``models.nmf.MultichannelISNMF``, and the top-level and ``models``
    ``MultichannelISNMF`` is the BSS solver, ``models.mnmf``'s, as in the
    JAX package."""
    for name in ("EUCNMF", "KLNMF", "ISNMF", "TNMF", "tNMF", "CauchyNMF", "ComplexEUCNMF", "CovarianceISNMF", "EUCNTF"):
        assert hasattr(jax_models, name) and name in port_models.__all__ and hasattr(port, name), name
    assert port.tNMF is port.TNMF
    assert port.CovarianceISNMF is port_models.CovarianceISNMF is port_nmf.MultichannelISNMF
    assert port.MultichannelISNMF is port_models.MultichannelISNMF is port_mnmf.MultichannelISNMF
    assert callable(port.solve_riccati)
