"""Single-channel nonnegative matrix factorisation family (reference
``src/algorithm/nmf.py``).

  * ``EUCNMF``: Euclidean MM updates with the fractional ``domain``,
    exponent ``d / (4 - d)``;
  * ``KLNMF``: generalized-KL MM, exponent ``d / 2``;
  * ``ISNMF``: Itakura-Saito MM (exponent ``d / (d + 2)``) and ME;
  * ``TNMF`` (alias ``tNMF``): Student-t with the harmonic weight;
  * ``CauchyNMF``: the naive-multiplicative, mm, me and mm_fast rules;
  * ``ComplexEUCNMF``: complex NMF with a phase per (bin, basis, frame);
  * ``MultichannelISNMF`` (exported as ``CovarianceISNMF``): the
    covariance-domain multichannel IS-NMF with Riccati spatial updates.

API: ``model = Cls(n_basis=K, ...); T, V = model(target, iteration=N)`` with
``target`` the power or magnitude spectrogram ``(n_bins, n_frames)``.  The
loss is recorded after every update, with no entry before the first.  The
real-target models run at float32 on CUDA and at the target's precision on
the CPU; the host-RNG inits (float64 NumPy, basis then activation) are cast
to that type after they are drawn, so seeded runs start where the JAX
package's do.  Each update is a few GEMMs and elementwise passes; no kernel
of ``csrc/`` is on this path.

Under a mesh (the JAX package's ``field_axes``) the target and the basis
shard with the bins and the activations with the frames.  In frames mode
the basis updates' sums over frames are all-reduced, in bins mode the
activation updates' sums over bins (and ComplexEUCNMF's basis normaliser);
the loss is all-reduced in either mode.  Each update's numerator and
denominator travel in one all-reduce, and each factor of the output is
gathered along its own axis.
"""

import math

import numpy as np
import torch

from ..algorithm.linalg import solve_riccati
from ..criterion.divergence import generalized_kl_divergence, is_divergence
from ..ops.fast_linalg import (
    add_diag_planes,
    compact_pair_weights,
    expand_hermitian_compact,
    expand_hermitian_compact_trailing,
    herm_planes,
    hermitian_compact_from_entries,
    hermitian_compact_from_trailing,
    hermitian_eigvalsh_planes,
    inv_hermitian_compact,
    inv_planes,
    matmul_planes,
    sandwich_hermitian_compact,
    solve_riccati_hermitian_compact,
    trace_planes,
)
from ..ops.ip_components import _plane_index
from ..runtime.solver import IterativeSolver, state_tensor
from ..utils.flooring import EPS, floor_below


# the shardable axes of the 2-D (n_bins, n_frames) target and its factors
# (the JAX package's NMFBase.field_axes)
NMF_FIELD_AXES = {
    "input": {"bins": 0, "frames": 1},
    "target": {"bins": -2, "frames": -1},
    "basis": {"bins": -2},  # (n_bins, n_basis)
    "activation": {"frames": -1},  # (n_basis, n_frames)
}


def _check_domain(domain):
    # AssertionError, as the JAX package's asserts raise, but kept under -O
    if not 1 <= domain <= 2:
        raise AssertionError("1 <= `domain` <= 2 is not satisfied.")


def _check_mm(algorithm):
    if algorithm != "mm":
        raise AssertionError("algorithm must be 'mm'.")


class NMFBase(IterativeSolver):
    """Fit protocol shared by the NMF family (``nmf.py:10-56``)."""

    state_fields = ("basis", "activation")
    record_initial_loss = False
    real_input = True

    def __init__(self, n_basis=2, eps=EPS, device=None):
        super().__init__(callbacks=None, recordable_loss=True, eps=eps, device=device)
        self.n_basis = n_basis

    def field_axes(self):
        return dict(NMF_FIELD_AXES)

    def output_axes(self):
        axes = self.field_axes()
        return axes["basis"], axes["activation"]

    def capturable(self, X):
        return True

    def prepare_state_kwargs(self, target, state_kwargs):
        n_bins, n_frames = target.shape[-2], target.shape[-1]
        if "basis" not in state_kwargs:
            state_kwargs["basis"] = np.random.rand(n_bins, self.n_basis)
        if "activation" not in state_kwargs:
            state_kwargs["activation"] = np.random.rand(self.n_basis, n_frames)
        return state_kwargs

    def init_state(self, target, basis=None, activation=None):
        return {"target": target, "basis": state_tensor(basis, target), "activation": state_tensor(activation, target)}

    def criterion(self, reconstruction, target):
        raise NotImplementedError

    def reconstruct(self, state):
        domain = getattr(self, "domain", 2)
        return (state["basis"] @ state["activation"]) ** (2 / domain)

    def nll(self, state):
        return self._shard_sum(self.criterion(self.reconstruct(state), state["target"]).sum())

    def finalize(self, state):
        return state["basis"], state["activation"]


class EUCNMF(NMFBase):
    """Euclidean NMF, MM updates with fractional ``domain`` (``nmf.py:150-207``)."""

    def __init__(self, n_basis=2, domain=2, algorithm="mm", eps=EPS, device=None):
        super().__init__(n_basis=n_basis, eps=eps, device=device)
        _check_domain(domain)
        _check_mm(algorithm)
        self.domain = domain
        self.algorithm = algorithm

    def criterion(self, reconstruction, target):
        return (target - reconstruction) ** 2

    def update_state(self, state):
        Z, T, V = state["target"], state["basis"], state["activation"]
        d, eps = self.domain, self.eps

        TV = floor_below(T @ V, eps)
        TVV, numerator = self._shard_sums([TV ** ((4 - d) / d) @ V.T, (Z * TV ** ((2 - d) / d)) @ V.T], "frames")
        T = T * (numerator / floor_below(TVV, eps)) ** (d / (4 - d))

        TV = floor_below(T @ V, eps)
        TTV, numerator = self._shard_sums([T.T @ TV ** ((4 - d) / d), T.T @ (Z * TV ** ((2 - d) / d))], "bins")
        V = V * (numerator / floor_below(TTV, eps)) ** (d / (4 - d))
        return {"target": Z, "basis": T, "activation": V}


class KLNMF(NMFBase):
    """Generalized-KL NMF, MM updates (``nmf.py:209-266``)."""

    def __init__(self, n_basis=2, domain=2, algorithm="mm", eps=EPS, device=None):
        super().__init__(n_basis=n_basis, eps=eps, device=device)
        _check_domain(domain)
        _check_mm(algorithm)
        self.domain = domain
        self.algorithm = algorithm

    def criterion(self, reconstruction, target):
        return generalized_kl_divergence(reconstruction, target, eps=self.eps)

    def update_state(self, state):
        Z, T, V = state["target"], state["basis"], state["activation"]
        d, eps = self.domain, self.eps

        TV = floor_below(T @ V, eps)
        TVV, numerator = self._shard_sums([TV ** ((2 - d) / d) @ V.T, (Z / TV) @ V.T], "frames")
        T = T * (numerator / floor_below(TVV, eps)) ** (d / 2)

        TV = floor_below(T @ V, eps)
        TTV, numerator = self._shard_sums([T.T @ TV ** ((2 - d) / d), T.T @ (Z / TV)], "bins")
        V = V * (numerator / floor_below(TTV, eps)) ** (d / 2)
        return {"target": Z, "basis": T, "activation": V}


class ISNMF(NMFBase):
    """Itakura-Saito NMF: MM (any domain) and ME (domain 2) updates
    (``nmf.py:268-356``)."""

    def __init__(self, n_basis=2, domain=2, algorithm="mm", eps=EPS, device=None):
        super().__init__(n_basis=n_basis, eps=eps, device=device)
        _check_domain(domain)
        if algorithm == "me" and domain != 2:
            raise AssertionError("Only domain = 2 is supported.")
        self.domain = domain
        self.algorithm = algorithm

    def criterion(self, reconstruction, target):
        return is_divergence(reconstruction, target, eps=self.eps)

    def update_state(self, state):
        Z, T, V = state["target"], state["basis"], state["activation"]
        d, eps = self.domain, self.eps
        exponent = d / (d + 2) if self.algorithm == "mm" else 1.0

        TV = floor_below(T @ V, eps)
        division = Z / TV ** ((d + 2) / d)
        TVV, numerator = self._shard_sums([(1 / TV) @ V.T, division @ V.T], "frames")
        T = T * (numerator / floor_below(TVV, eps)) ** exponent

        TV = floor_below(T @ V, eps)
        division = Z / TV ** ((d + 2) / d)
        TTV, numerator = self._shard_sums([T.T @ (1 / TV), T.T @ division], "bins")
        V = V * (numerator / floor_below(TTV, eps)) ** exponent
        return {"target": Z, "basis": T, "activation": V}


class TNMF(NMFBase):
    """Student-t NMF with harmonic weighting (``nmf.py:358-428``)."""

    def __init__(self, n_basis=2, nu=1e3, domain=2, algorithm="mm", eps=EPS, device=None):
        super().__init__(n_basis=n_basis, eps=eps, device=device)
        if domain != 2:
            raise AssertionError("`domain` is expected 2.")
        _check_mm(algorithm)
        self.nu = nu
        self.domain = domain
        self.algorithm = algorithm

    def criterion(self, reconstruction, target):
        eps, nu = self.eps, self.nu
        _input, _target = reconstruction + eps, target + eps
        return torch.log(_input) + (2 + nu) / 2 * torch.log(1 + (2 / nu) * (_target / _input))

    def update_state(self, state):
        Z = floor_below(state["target"], self.eps)
        T, V = state["basis"], state["activation"]
        nu, eps = self.nu, self.eps

        TV = floor_below(T @ V, eps)
        harmonic = 1 / (2 / ((2 + nu) * TV) + nu / ((2 + nu) * Z))
        TVV, numerator = self._shard_sums([(1 / TV) @ V.T, (harmonic / TV**2) @ V.T], "frames")
        T = T * torch.sqrt(numerator / floor_below(TVV, eps))

        TV = floor_below(T @ V, eps)
        harmonic = 1 / (2 / ((2 + nu) * TV) + nu / ((2 + nu) * Z))
        TTV, numerator = self._shard_sums([T.T @ (1 / TV), T.T @ (harmonic / TV**2)], "bins")
        V = V * torch.sqrt(numerator / floor_below(TTV, eps))
        return {"target": state["target"], "basis": T, "activation": V}


class CauchyNMF(NMFBase):
    """Cauchy NMF: naive-multiplicative, mm, me and mm_fast rules
    (``nmf.py:430-595``; the reference's spelling ``naive-multipricative``
    is kept)."""

    def __init__(self, n_basis=2, domain=2, algorithm="naive-multipricative", eps=EPS, device=None):
        super().__init__(n_basis=n_basis, eps=eps, device=device)
        if domain != 2:
            raise AssertionError("Only `domain` = 2 is supported.")
        if algorithm not in ("naive-multipricative", "mm", "me", "mm_fast"):
            raise ValueError("Not support {} based update.".format(algorithm))
        self.domain = domain
        self.algorithm = algorithm

    def criterion(self, reconstruction, target):
        eps = self.eps
        _input, _target = reconstruction + eps, target + eps
        numerator = 2 * _target**2 + _input**2
        denominator = 3 * _target**2
        return torch.log(_target / _input) + (3 / 2) * torch.log(numerator / denominator)

    def _basis_then_activation(self, T, V, rule):
        """``rule(TV, G)`` gives the multiplicative factor of a factor from
        ``TV`` and the contractions ``G(M, ...)`` onto it (``M @ V.T`` for
        the basis, ``T.T @ M`` for the activation), whole over the shards."""
        T = T * rule(T @ V, lambda *Ms: self._shard_sums([M @ V.T for M in Ms], "frames"))
        V = V * rule(T @ V, lambda *Ms: self._shard_sums([T.T @ M for M in Ms], "bins"))
        return T, V

    def update_state(self, state):
        Z, T, V = state["target"], state["basis"], state["activation"]
        eps = self.eps

        if self.algorithm in ("naive-multipricative", "mm"):
            ratio_pow = (lambda r: r) if self.algorithm == "naive-multipricative" else torch.sqrt

            def rule(TV, G):
                TV = floor_below(TV, eps)
                C = floor_below(2 * Z + TV**2, eps)
                numerator, denominator = G(1 / TV, TV / C)
                return ratio_pow(numerator / floor_below(3 * denominator, eps))

        elif self.algorithm == "me":

            def rule(TV, G):
                A, B = G(TV / floor_below(TV**2 + Z, eps), 1 / floor_below(TV, eps))
                A = (3 / 4) * A
                return B / floor_below(A + torch.sqrt(A**2 + 2 * B * A), eps)

        else:  # mm_fast

            def rule(TV, G):
                C = 2 * Z + TV**2
                numerator, denominator = G(Z / floor_below(C * TV, eps), TV / floor_below(C, eps))
                return torch.sqrt(numerator / floor_below(denominator, eps))

        T, V = self._basis_then_activation(T, V, rule)
        return {"target": Z, "basis": T, "activation": V}


class ComplexEUCNMF(IterativeSolver):
    """Complex NMF (Euclidean), with a phase per (bin, basis, frame) and the
    auxiliary split weights ``Beta = TV / sum_k TV`` (``nmf.py:597-676``).

    ``T, V, Phi = model(target, iteration=N)`` on a complex spectrogram.
    Documented divergence: the reference's recorded loss reconstructs with
    the raw phase angles (a bug); here the loss uses ``exp(1j Phi)``, the
    quantity the updates minimise.

    The phase lives in the state as a unit phasor in real ``(K, F, T)``
    planes (``phase_cos``, ``phase_sin``), so an update takes no
    transcendental pass over the ``(F, K, T)`` tensor; the angles come back
    once, by ``atan2`` at :meth:`finalize`.  The ``/ Beta`` quotients
    collapse algebraically (``TV / Beta = sum_k TV``) into GEMMs, so no
    ``(F, K, T)`` quotient tensor is formed; the collapse assumes the
    ``Beta >= eps`` floors are inactive (true away from exactly-zero factor
    entries), a documented divergence shared with the JAX package.
    """

    state_fields = ("basis", "activation", "phase")
    record_initial_loss = False

    def __init__(self, n_basis=2, regularizer=0.1, p=1, eps=EPS, device=None):
        super().__init__(callbacks=None, recordable_loss=True, eps=eps, device=device)
        self.n_basis = n_basis
        self.regularizer = regularizer
        self.p = p

    def field_axes(self):
        """NMFBase's axes, the ``(K, F, T)`` phasor planes sharded with the
        target, and the ``(F, K, T)`` phase warm start cut with them."""
        return dict(
            NMF_FIELD_AXES,
            phase_cos={"bins": 1, "frames": 2},
            phase_sin={"bins": 1, "frames": 2},
            phase={"bins": 0, "frames": 2},
        )

    def output_axes(self):
        axes = self.field_axes()
        return axes["basis"], axes["activation"], axes["phase"]

    def capturable(self, X):
        return True

    def prepare_state_kwargs(self, target, state_kwargs):
        n_bins, n_frames = target.shape
        if "basis" not in state_kwargs:
            state_kwargs["basis"] = np.random.rand(n_bins, self.n_basis)
        if "activation" not in state_kwargs:
            state_kwargs["activation"] = np.random.rand(self.n_basis, n_frames)
        if "phase" not in state_kwargs:
            # the reference draws a random phase, then overwrites it with the
            # target's angle: the draw is kept for the RNG stream
            np.random.rand(n_bins, self.n_basis, n_frames)
            state_kwargs["phase"] = torch.angle(target)[:, None, :].expand(n_bins, self.n_basis, n_frames)
        return state_kwargs

    def init_state(self, target, basis=None, activation=None, phase=None):
        phase_kft = state_tensor(phase, target).permute(1, 0, 2)
        return {
            "target": target,
            "basis": state_tensor(basis, target),
            "activation": state_tensor(activation, target),
            "phase_cos": torch.cos(phase_kft),
            "phase_sin": torch.sin(phase_kft),
        }

    def update_state(self, state):
        Z, T, V = state["target"], state["basis"], state["activation"]
        Ure, Uim = state["phase_cos"], state["phase_sin"]  # (K, F, T)
        regularizer, p, eps = self.regularizer, self.p, self.eps

        TVsum = floor_below(T @ V, eps)  # (F, T)
        ZXre = Z.real - torch.einsum("fk,kft->ft", T, V[:, None, :] * Ure)
        ZXim = Z.imag - torch.einsum("fk,kft->ft", T, V[:, None, :] * Uim)
        # re = Re(ZX* e^{i Phi}), the phase-dependent part of the
        # reference's Re(Z_bar* e^{i Phi}) = TV + Beta re
        re = ZXre[None] * Ure + ZXim[None] * Uim
        V_bar = floor_below(V, eps)

        # basis: (sum_t V sum_k TV + V re) / (sum_t V sum_k TV / T)
        G_T, R_V = self._shard_sums([TVsum @ V.T, torch.einsum("kt,kft->fk", V, re)], "frames")  # (F, K)
        T_new = (G_T + R_V) / floor_below(G_T / floor_below(T, eps * eps), eps)

        # activation, with the new basis as in the reference
        G_V, R_T, G3 = self._shard_sums(
            [T_new.T @ TVsum, torch.einsum("fk,kft->kt", T_new, re), (T_new**2 / floor_below(T, eps * eps)).T @ TVsum],
            "bins",
        )  # (K, T) each
        denominator = floor_below(G3 / floor_below(V, eps * eps) + regularizer * p * V_bar ** (p - 2), eps)
        V = (G_V + R_T) / denominator

        # phase: Z_bar = TV (U + ZX / sum_k TV), and the positive TV cancels
        # in Z_bar / |Z_bar|
        Zbre = Ure + (ZXre / TVsum)[None]
        Zbim = Uim + (ZXim / TVsum)[None]
        mag = torch.sqrt(Zbre**2 + Zbim**2)
        safe = mag > 0
        mag = torch.where(safe, mag, 1.0)
        Ure = torch.where(safe, Zbre / mag, 1.0)
        Uim = torch.where(safe, Zbim / mag, 0.0)

        T_new = T_new / self._bins_sum(T_new.sum(dim=0))
        return dict(state, basis=T_new, activation=V, phase_cos=Ure, phase_sin=Uim)

    def nll(self, state):
        T, V, Z = state["basis"], state["activation"], state["target"]
        recon_re = torch.einsum("fk,kft->ft", T, V[:, None, :] * state["phase_cos"])
        recon_im = torch.einsum("fk,kft->ft", T, V[:, None, :] * state["phase_sin"])
        return self._shard_sum(((recon_re - Z.real) ** 2 + (recon_im - Z.imag) ** 2).sum())

    def finalize(self, state):
        phase = torch.atan2(state["phase_sin"], state["phase_cos"])
        return state["basis"], state["activation"], phase.permute(1, 0, 2)


class MultichannelISNMF(IterativeSolver):
    """Covariance-domain multichannel IS-NMF (Sawada; ``nmf.py:678-815``).

    ``H, T, V = model(target, iteration=N)`` with ``target`` the observed
    covariances ``(n_bins, n_frames, C, C)``, C <= 3 (the closed forms; C >=
    4 raises ``ValueError`` at the first update, as in the JAX package).
    The spatial update solves ``H A H = B`` in closed form
    (:func:`~..algorithm.linalg.solve_riccati`).

    Every per-iteration statistic lives in compact Hermitian planes ``(C^2,
    F, T)`` (``ops.fast_linalg``); the MU trace ratios contract them against
    the activation or the basis as GEMMs.  Float32 on the card holds through
    three guards of the JAX package: a per-bin power equilibration of the
    target (:meth:`init_state`, undone at :meth:`finalize` and in the
    published ``basis``), a scale-relative ridge on ``X^`` before it is
    inverted (:meth:`_inv_ridge`), and ``max(., 0)`` floors on the trace
    numerators.
    """

    state_fields = ("spatial", "basis", "activation")
    record_initial_loss = False
    # the C = 2 spatial Riccati chain on compact Hermitian planes; the
    # matrix path (eigh at C = 3) otherwise
    riccati_planes = True

    def __init__(self, n_basis=10, normalize=True, eps=EPS, device=None):
        super().__init__(callbacks=None, recordable_loss=True, eps=eps, device=device)
        self.n_basis = n_basis
        self.normalize = normalize

    def capturable(self, X):
        """C = 2 (the planes Riccati) and C = 3 (the matrix Riccati on K3's
        eigensolves); C >= 4 raises at the first update."""
        return True

    def field_axes(self):
        """The JAX package's shardable axes: per-bin fields with the bins,
        the activations with the frames."""
        return {
            "input": {"bins": 0, "frames": 1},  # target (F, T, C, C)
            "target_planes": {"bins": 1, "frames": 2},  # (C^2, F, T) compact
            "bin_scale": {"bins": 0},  # (F,)
            "spatial": {"bins": 0},  # (F, K, C, C)
            "basis": {"bins": 0},  # (F, K)
            "activation": {"frames": 1},  # (K, T)
        }

    def output_axes(self):
        axes = self.field_axes()
        return axes["spatial"], axes["basis"], axes["activation"]

    def prepare_state_kwargs(self, target, state_kwargs):
        n_bins, n_frames, n_channels, _ = target.shape
        if "spatial" not in state_kwargs:
            eye = torch.eye(n_channels, dtype=target.dtype, device=target.device)
            state_kwargs["spatial"] = eye.expand(n_bins, self.n_basis, n_channels, n_channels)
        if "basis" not in state_kwargs:
            state_kwargs["basis"] = np.random.rand(n_bins, self.n_basis)
        if "activation" not in state_kwargs:
            state_kwargs["activation"] = np.random.rand(self.n_basis, n_frames)
        return state_kwargs

    def init_state(self, target, spatial=None, basis=None, activation=None):
        C = target.shape[-1]
        # compact Hermitian planes of the upper triangle: the observed
        # covariance is Hermitian by construction (a non-Hermitian target's
        # lower triangle is ignored, a documented divergence from the
        # reference)
        target_planes = hermitian_compact_from_trailing(target)  # (C^2, F, T) real
        # per-bin power equilibration: real spectrogram covariances span
        # about 24 decades across bins, past float32's range in the adjugate
        # and Riccati chains.  The MU ratios, the Riccati solution and the
        # IS divergence are invariant under (X, T) -> (X / s, T / s) per bin
        # (the eps ridge turns bin-relative, documented in the JAX package);
        # finalize restores T s
        traces = target_planes[:C].sum(dim=0)  # (F, T)
        if self._shard_group("frames") is not None:
            # the mean over the whole frames, summed as the unsharded call
            # sums it: the loss's floored log-determinants of the rank-1
            # snapshots turn a one-ulp change of the scale into a visible
            # offset (one all-gather, at init)
            from ..parallel.mesh import shard_gather

            traces = shard_gather(traces, 1, self)
        scale = traces.mean(dim=-1) / C  # (F,) trace mean
        scale = torch.clamp(scale, min=torch.finfo(scale.dtype).tiny)
        return {
            "target_planes": target_planes / scale[:, None],
            "bin_scale": scale,
            "spatial": torch.as_tensor(spatial).to(device=target.device, dtype=target.dtype),
            "basis": state_tensor(basis, target) / scale[:, None],
            "activation": state_tensor(activation, target),
        }

    def _spatial_coeffs(self, state):
        """Compact-plane coefficients ``(C^2, F, K)`` of the Hermitian spatial
        templates."""
        return hermitian_compact_from_trailing(state["spatial"])

    def _xhat_compact(self, state):
        """``X^ = sum_k H_k T_k V_k`` as compact planes ``(C^2, F, T)``: the
        H coefficients fold into T, then one real GEMM over k."""
        TH = self._spatial_coeffs(state) * state["basis"][None]
        return torch.einsum("pfk,kt->pft", TH, state["activation"])

    def _inv_ridge(self, xh):
        # a scale-relative ridge: within a bin X^ still spans the frames'
        # silence-to-loud range, and at float32 the adjugate determinant of a
        # near-rank-1 X^ cancels to <= 0 below the absolute 1e-12; 100
        # eps_machine tr / C dominates that cancellation, and at float64 it
        # is 2e-14 of the local eigenvalues
        C = math.isqrt(xh.shape[0])
        tr = xh[:C].sum(dim=0) / C  # (F, T) local scale
        return self.eps + 100.0 * torch.finfo(xh.dtype).eps * tr

    def _mu_operands(self, state):
        """``X^-1`` and ``X^-1 X X^-1`` as compact Hermitian planes."""
        xh = self._xhat_compact(state)
        inv = inv_hermitian_compact(xh, ridge=self._inv_ridge(xh))
        return inv, sandwich_hermitian_compact(inv, state["target_planes"])

    def update_state(self, state):
        # the MU trace ratios tr(X^-1 X X^-1 H_k) / tr(X^-1 H_k) contract per
        # basis against V (basis) or T (activation); both operands of each
        # trace are Hermitian, so a trace is a pair-weighted dot of compact
        # planes, and the contractions are plane-level GEMMs
        eps = self.eps
        H, T, V = state["spatial"], state["basis"], state["activation"]
        n_channels = H.shape[-1]

        # basis.  The traces of PSD x PSD products are >= 0, but at float32
        # the pair-weighted sums round slightly negative near zero: floor 0
        inv, XXX = self._mu_operands(state)
        wc = self._spatial_coeffs(state) * compact_pair_weights(n_channels, T)[:, None, None]  # (C^2, F, K)
        XXX_V, inv_V = self._shard_sums(
            [torch.einsum("pft,kt->pfk", XXX, V), torch.einsum("pft,kt->pfk", inv, V)], "frames"
        )
        num = floor_below((wc * XXX_V).sum(dim=0), 0.0)  # (F, K)
        den = (wc * inv_V).sum(dim=0)
        T = T * torch.sqrt(num / floor_below(den, eps))
        state = dict(state, basis=T)

        # activation, X^ rebuilt with the new basis
        inv, XXX = self._mu_operands(state)
        wct = wc * T[None]  # (C^2, F, K)
        num, den = self._shard_sums(
            [torch.einsum("pfk,pft->kt", wct, XXX), torch.einsum("pfk,pft->kt", wct, inv)], "bins"
        )
        V = V * torch.sqrt(floor_below(num, 0.0) / floor_below(den, eps))
        state = dict(state, activation=V)

        # spatial (Riccati): frame GEMMs against V, then the solve on the
        # small (F, K, C, C)
        inv, XXX = self._mu_operands(state)
        if self.riccati_planes and n_channels == 2:
            # the whole chain on compact planes (C^2, K, F)
            A_p, Z_p = self._shard_sums(
                [torch.einsum("kt,pft->pkf", V, inv), torch.einsum("kt,pft->pkf", V, XXX)], "frames"
            )
            H_p = hermitian_compact_from_entries(lambda c, d: H[:, :, c, d].transpose(0, 1), n_channels)
            H_p = solve_riccati_hermitian_compact(A_p, sandwich_hermitian_compact(H_p, Z_p))
            diag, off = H_p[:n_channels] + eps, H_p[n_channels:]
            if self.normalize:
                tr = diag.sum(dim=0)
                diag, off = diag / tr, off / tr
            H_new = expand_hermitian_compact(torch.cat([diag, off]))  # (C, C, K, F)
            return dict(state, spatial=H_new.permute(3, 2, 0, 1))

        small_inv, small_xxx = self._shard_sums(
            [torch.einsum("pft,kt->fkp", inv, V), torch.einsum("pft,kt->fkp", XXX, V)], "frames"
        )  # (F, K, C^2) each
        H = solve_riccati(
            expand_hermitian_compact_trailing(small_inv, n_channels),
            H @ expand_hermitian_compact_trailing(small_xxx, n_channels) @ H,
        )
        H = H + eps * torch.eye(n_channels, dtype=H.dtype, device=H.device)
        if self.normalize:
            H = H / torch.diagonal(H, dim1=-2, dim2=-1).sum(dim=-1)[..., None, None]
        return dict(state, spatial=H)

    def nll(self, state):
        """The multichannel IS divergence (``criterion.divergence``'s
        semantics) on planes, with eigvalsh-floored log-determinants per
        operand: snapshot covariances are rank 1, so ``det(X X^-1)`` rounds to
        <= 0 at float32 and its log would be NaN."""
        eps = self.eps
        target_planes = state["target_planes"]
        ridge = torch.full(target_planes.shape[1:], eps, dtype=target_planes.dtype, device=target_planes.device)
        Xp = add_diag_planes(expand_hermitian_compact(target_planes), ridge)
        xh_c = self._xhat_compact(state)
        # the model's inverse takes the scale-relative ridge too
        Xh = add_diag_planes(expand_hermitian_compact(xh_c), self._inv_ridge(xh_c))
        trace = trace_planes(matmul_planes(Xp, inv_planes(Xh)))
        wX = hermitian_eigvalsh_planes(herm_planes(Xp))
        wH = hermitian_eigvalsh_planes(herm_planes(Xh))
        logdet = (torch.log(floor_below(wX, eps)) - torch.log(floor_below(wH, eps))).sum(dim=0)
        return self._shard_sum((trace - logdet - Xp.shape[0]).sum())

    def _input_frame_basis(self, state):
        return state["basis"] * state["bin_scale"][:, None]

    def finalize(self, state):
        # leave the per-bin equilibration frame (see init_state)
        return state["spatial"], self._input_frame_basis(state), state["activation"]

    def _sync_attributes(self, state):
        # publish (and so checkpoint) the basis in the input frame:
        # init_state re-equilibrates warm-start kwargs
        super()._sync_attributes(state)
        self.basis = self._input_frame_basis(state)


tNMF = TNMF  # the reference's name
