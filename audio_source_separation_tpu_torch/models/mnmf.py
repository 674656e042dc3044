"""Multichannel NMF solver family (reference ``src/bss/mnmf.py``).

  * ``MultichannelISNMF(author="Sawada")``: full-rank spatial covariances
    ``H (F, S, C, C)`` over the observed covariances ``x x^H``, kept as
    compact Hermitian planes ``(C^2, F, T)``; MU updates of basis,
    activation and latent by the trace ratios ``tr(X^-1 X X^-1 H) / tr(X^-1
    H)``, the spatial covariances by the Riccati solve (the planes closed
    form at C = 2) with trace normalisation, and the multichannel Wiener
    filter at the reference mic;
  * ``MultichannelISNMF(author="Ozerov")``: EM over the mixing-matrix model
    ``A (F, C, S)`` with the JAX package's documented divergences from the
    reference's unfinished mode (the Gaussian likelihood, H from the new W,
    the likelihood-preserving normalisation), its optional simulated
    annealing, and its per-bin power equilibration;
  * ``FastMultichannelISNMF``: jointly diagonalisable spatial covariances, a
    diagonaliser ``Q (F, C, C)`` and gains ``g (S, F, C)``; the NMF and gain
    MU updates in the diagonalised domain ``|Q x|^2``, the IP-style row
    update of Q, the power normalisation chain and the Q-domain Wiener
    filter;
  * ``MultichanneltNMF``: the stub, which warns.

The closed forms (adjugates, eigenvalues) cover C <= 3 for both
``MultichannelISNMF`` authors, as in the JAX package.  Float32 on the card
holds through the JAX package's guards: ``max(., 0)`` on the trace
numerators, the dtype's own machine constants in every Ozerov floor, and the
Ozerov per-bin equilibration (published in the input frame).

FastMNMF's diagonaliser update takes all C weighted covariances ``(1/T)
sum_t x x^H / R[m, f, t]`` in one call of kernel K1
(:func:`~..ops.cov_kernel.weighted_covariance_planes`, per-bin ``(C, F, T)``
weights) per iteration; Sawada's frame contractions and Ozerov's EM are
batched PyTorch products, no kernel.
"""

import math
import warnings

import numpy as np
import torch

from ..algorithm.linalg import solve_riccati
from ..ops.cov_kernel import weighted_covariance_planes
from ..ops.fast_linalg import (
    _sum,
    add_diag_planes,
    batched_det,
    batched_inv,
    compact_entry,
    compact_pair_weights,
    expand_hermitian_compact,
    expand_hermitian_compact_trailing,
    hermitian_compact_from_trailing,
    inv_hermitian_compact,
    inv_planes,
    psd_parts_planes,
    sandwich_hermitian_compact,
    solve_riccati_hermitian_compact,
)
from ..ops.ip import cond_guard
from ..ops.ip_components import (
    assemble_components,
    assemble_matrices,
    det_components,
    pair_products_planes,
    quadratic_power_planes,
    solve_column_components,
)
from ..runtime.solver import IterativeSolver, real_tensor
from ..utils.flooring import EPS, THRESHOLD, floor_below

AUTHORS = ("sawada", "ozerov")
# state fields held at the input's complex type; the others are real
COMPLEX_FIELDS = ("spatial", "mix_filter", "diagonalizer")


def _state_tensors(X, kwargs):
    """Warm-start or drawn state arrays as tensors on ``X``'s device, the
    complex fields at ``X``'s type and the rest at its real type."""
    out = {}
    for k, v in kwargs.items():
        if k in COMPLEX_FIELDS:
            out[k] = torch.as_tensor(v).to(device=X.device, dtype=X.dtype).contiguous()
        else:
            out[k] = real_tensor(v, X)
    return out


class MultichannelNMFBase(IterativeSolver):
    """Shared MNMF protocol (``bss/mnmf.py:25-113``)."""

    def __init__(self, n_basis=10, n_sources=None, callbacks=None, recordable_loss=True, eps=EPS, device=None):
        super().__init__(callbacks=callbacks, recordable_loss=recordable_loss, eps=eps, device=device)
        self.n_basis = n_basis
        self.n_sources = n_sources

    def _sync_attributes(self, state):
        super()._sync_attributes(state)
        if self.callbacks is not None:
            # the state holds no estimates; the ground-truth callbacks read
            # this iteration's separated output (the JAX package publishes
            # none, so its callbacks record nothing for MNMF)
            self.estimation = self.finalize(state)


class MultichannelISNMF(MultichannelNMFBase):
    """Sawada / Ozerov multichannel IS-NMF (``bss/mnmf.py:115-617``).

    ``Y = solver(X, iteration=N)`` returns the ``(n_sources, n_bins,
    n_frames)`` source images at ``reference_id`` (Sawada: the Wiener
    filter; Ozerov: the posterior mean).  Ozerov takes the keywords
    ``annealing``, ``annealing_iterations``, ``annealing_start`` and
    ``annealing_end`` (the noise variance follows a geometric decay from
    ``start`` to ``end`` times the mean mixture power over that many
    iterations).
    """

    state_fields = ("latent", "spatial", "basis", "activation", "mix_filter", "noise_covariance")
    # the C = 2 Sawada spatial Riccati on compact Hermitian planes; the
    # matrix path otherwise
    riccati_planes = True

    def __init__(
        self,
        n_basis=10,
        n_sources=None,
        normalize=True,
        callbacks=None,
        reference_id=0,
        author="Sawada",
        recordable_loss=True,
        eps=EPS,
        device=None,
        **kwargs,
    ):
        super().__init__(
            n_basis=n_basis,
            n_sources=n_sources,
            callbacks=callbacks,
            recordable_loss=recordable_loss,
            eps=eps,
            device=device,
        )
        self.normalize = normalize
        # AssertionError, as the JAX package's assert raises, but kept under -O
        if author.lower() not in AUTHORS:
            raise AssertionError("Choose from {}".format(list(AUTHORS)))
        self.author = author
        allowed = {"reference_id"}
        if not self._sawada:
            allowed |= {"annealing", "annealing_iterations", "annealing_start", "annealing_end"}
        if set(kwargs) - allowed:
            raise ValueError("Invalid keywords.")
        self.reference_id = kwargs.get("reference_id", reference_id)
        if not self._sawada:
            # simulated annealing (Ozerov & Fevotte 2010): the noise variance
            # follows a decreasing schedule relative to the mean mixture
            # power, off by default
            self.annealing = bool(kwargs.get("annealing", False))
            self.annealing_iterations = int(kwargs.get("annealing_iterations", 50))
            self.annealing_start = float(kwargs.get("annealing_start", 1e-1))
            self.annealing_end = float(kwargs.get("annealing_end", 1e-5))
            warnings.warn("in progress", UserWarning)

    @property
    def _sawada(self):
        return self.author.lower() == "sawada"

    # init
    def prepare_state_kwargs(self, input, state_kwargs):
        """Host NumPy draws in the JAX package's order (``mnmf.py:190-249``)."""
        n_channels, n_bins, n_frames = input.shape
        n_sources = self.n_sources or n_channels
        n_basis, eps = self.n_basis, self.eps
        if self._sawada:
            if "latent" not in state_kwargs:
                Z = np.random.rand(n_sources, n_basis) * 1e-2 + 1 / n_sources
                state_kwargs["latent"] = Z / np.maximum(Z.sum(axis=0), eps)
            if "spatial" not in state_kwargs:
                eye = torch.eye(n_channels, dtype=input.dtype, device=input.device)
                state_kwargs["spatial"] = eye.expand(n_bins, n_sources, n_channels, n_channels)
            if "basis" not in state_kwargs:
                state_kwargs["basis"] = np.random.rand(n_bins, n_basis)
            if "activation" not in state_kwargs:
                state_kwargs["activation"] = np.random.rand(n_basis, n_frames)
            return state_kwargs
        # the JAX package's documented divergence: the draws keep the
        # reference's order and count, scaled to the observed power (per bin
        # for the basis), a no-op at the reference's O(1)-power operating point
        P = (torch.abs(input) ** 2).sum(dim=0).mean(dim=1).to(torch.float64).cpu().numpy()  # (F,)
        p_bar = max(float(np.mean(P)), eps)
        self._anneal_base = p_bar  # the annealing schedule's power scale
        if "mix_filter" not in state_kwargs:
            real = np.random.randn(n_bins, n_channels, n_sources)
            state_kwargs["mix_filter"] = real + 1j * np.random.randn(n_bins, n_channels, n_sources)
        if "basis" not in state_kwargs:
            shape = (np.maximum(P, eps) / p_bar)[None, :, None]
            state_kwargs["basis"] = np.random.rand(n_sources, n_bins, n_basis) * shape
        if "activation" not in state_kwargs:
            state_kwargs["activation"] = p_bar * np.random.rand(n_sources, n_basis, n_frames)
        if "noise_covariance" not in state_kwargs:
            state_kwargs["noise_covariance"] = 1e-2 * (P[:, None] + p_bar * np.random.rand(n_bins, n_channels))
        return state_kwargs

    def init_state(self, X, **kwargs):
        C = X.shape[0]
        self.n_channels = C
        if self.n_sources is None:
            self.n_sources = C
        state = {"input": X, **_state_tensors(X, kwargs)}
        if self._sawada:
            # the observed covariances x x^H as compact Hermitian planes
            state["covariance_planes"] = pair_products_planes(X)
            return state
        if self.annealing:
            state["step_count"] = torch.zeros((), dtype=torch.int32, device=X.device)
        # per-bin power equilibration: the EM iteration is exactly invariant
        # under (x, W, noise) -> (x / sqrt(s), W / s, noise / s) per bin, and
        # real spectrogram powers span decades across bins, past float32's
        # range in the determinants.  The NLL restores C log s, the output
        # sqrt(s), and the published basis and noise s
        s = torch.mean(torch.sum(torch.abs(X) ** 2, dim=0), dim=-1) / C
        s = torch.clamp(s, min=torch.finfo(s.dtype).tiny)  # (F,)
        X = X / torch.sqrt(s)[None, :, None].to(X.dtype)
        state.update(
            input=X,
            bin_scale=s,
            basis=state["basis"] / s[None, :, None],
            noise_covariance=state["noise_covariance"] / s[:, None],
            # R_xx = mean_t x x^H, a function of the mixture only
            second_moment=torch.stack(
                [torch.stack([(X[c] * X[d].conj()).mean(dim=-1) for d in range(C)], -1) for c in range(C)], -2
            ),  # (F, C, C)
        )
        return state

    # Sawada
    def _ztv(self, state):
        return torch.einsum("sk,fk,kt->sft", state["latent"], state["basis"], state["activation"])  # (S, F, T)

    def _xhat_compact(self, state):
        """``X^ = sum_s H_s ZTV_s`` as compact Hermitian planes ``(C^2, F,
        T)``: one real contraction over the sources per plane."""
        coeffs = hermitian_compact_from_trailing(state["spatial"])  # (C^2, F, S)
        return torch.einsum("pfs,sft->pft", coeffs, self._ztv(state))

    def _inv_xhat_compact(self, state):
        """Compact planes of ``(X^ + eps I)^-1`` (adjugate over the real
        Hermitian determinant)."""
        return inv_hermitian_compact(self._xhat_compact(state), ridge=self.eps)

    def _trace_terms(self, state):
        """``tr(X^-1 X X^-1 H)`` and ``tr(X^-1 H)`` per (bin, source,
        frame), ``(F, S, T)`` each: pair-weighted contractions of compact
        planes, both operands Hermitian."""
        inv = self._inv_xhat_compact(state)
        XXX = sandwich_hermitian_compact(inv, state["covariance_planes"])
        wH = hermitian_compact_from_trailing(state["spatial"])  # (C^2, F, S)
        wH = wH * compact_pair_weights(self.n_channels, inv)[:, None, None]
        return torch.einsum("pft,pfs->fst", XXX, wH), torch.einsum("pft,pfs->fst", inv, wH)

    def _update_sawada_basis(self, state):
        """Basis MU (``mnmf.py:377-398``)."""
        Z, T, V = state["latent"], state["basis"], state["activation"]
        tn, td = self._trace_terms(state)
        # floor at 0: PSD x PSD traces round slightly negative at float32
        num = torch.clamp(torch.einsum("sk,kt,fst->fk", Z, V, tn), min=0.0)
        den = floor_below(torch.einsum("sk,kt,fst->fk", Z, V, td), self.eps)
        return dict(state, basis=T * torch.sqrt(num / den))

    def _update_sawada_activation(self, state):
        """Activation MU (``mnmf.py:400-421``)."""
        Z, T, V = state["latent"], state["basis"], state["activation"]
        tn, td = self._trace_terms(state)
        num = torch.clamp(torch.einsum("sk,fk,fst->kt", Z, T, tn), min=0.0)
        den = floor_below(torch.einsum("sk,fk,fst->kt", Z, T, td), self.eps)
        return dict(state, activation=V * torch.sqrt(num / den))

    def _update_sawada_latent(self, state):
        """Latent MU and simplex renormalisation (``mnmf.py:423-447``)."""
        Z, T, V = state["latent"], state["basis"], state["activation"]
        tn, td = self._trace_terms(state)
        num = torch.clamp(torch.einsum("fk,kt,fst->sk", T, V, tn), min=0.0)
        den = floor_below(torch.einsum("fk,kt,fst->sk", T, V, td), self.eps)
        Z = Z * torch.sqrt(num / den)
        return dict(state, latent=Z / floor_below(Z.sum(dim=0), self.eps))

    def _update_sawada_spatial(self, state):
        """Spatial covariances by the Riccati solve (``mnmf.py:449-473``):
        the frame contractions ``sum_t ZTV X^-1`` and ``sum_t ZTV X^-1 X
        X^-1`` as GEMMs over compact planes, the solve on the small results."""
        eps = self.eps
        H = state["spatial"]
        C = self.n_channels
        inv = self._inv_xhat_compact(state)
        XXX = sandwich_hermitian_compact(inv, state["covariance_planes"])
        ZTV = self._ztv(state)  # (S, F, T)
        if self.riccati_planes and C == 2:
            # the whole chain on compact planes (C^2, S, F)
            A_p = torch.einsum("sft,pft->psf", ZTV, inv)
            Z_p = torch.einsum("sft,pft->psf", ZTV, XXX)
            H_p = hermitian_compact_from_trailing(H).transpose(1, 2)
            H_p = solve_riccati_hermitian_compact(A_p, sandwich_hermitian_compact(H_p, Z_p))
            diag, off = H_p[:C] + eps, H_p[C:]
            if self.normalize:
                tr = diag.sum(dim=0)
                diag, off = diag / tr, off / tr
            H_new = expand_hermitian_compact(torch.cat([diag, off]))  # (C, C, S, F)
            return dict(state, spatial=H_new.permute(3, 2, 0, 1))

        def contract_t(planes):
            small = torch.einsum("sft,pft->fsp", ZTV, planes)  # (F, S, C^2)
            return expand_hermitian_compact_trailing(small, C)

        H = solve_riccati(contract_t(inv), H @ contract_t(XXX) @ H)
        H = H + eps * torch.eye(C, dtype=H.dtype, device=H.device)
        if self.normalize:
            H = H / torch.diagonal(H, dim1=-2, dim2=-1).sum(dim=-1)[..., None, None]
        return dict(state, spatial=H)

    def _update_sawada(self, state):
        state = self._update_sawada_basis(state)
        state = self._update_sawada_activation(state)
        state = self._update_sawada_latent(state)
        return self._update_sawada_spatial(state)

    def _nll_sawada(self, state):
        """Log-det divergence between the PSD-projected observed and model
        covariances (``criterion/divergence.py:83-105`` semantics) on
        planes: one closed-form eigvalsh per operand gives the floored
        log-determinants, the trace comes from the planes product."""
        C, eps = self.n_channels, self.eps
        X_psd, wX = psd_parts_planes(expand_hermitian_compact(state["covariance_planes"]), eps=eps)
        Xh_psd, wXh = psd_parts_planes(expand_hermitian_compact(self._xhat_compact(state)), eps=eps)
        ridge = torch.full(X_psd.shape[2:], eps, dtype=wX.dtype, device=wX.device)
        X_psd = add_diag_planes(X_psd, ridge)
        inv_h = inv_planes(add_diag_planes(Xh_psd, ridge))
        trace = _sum((X_psd[c, d] * inv_h[d, c]).real for c in range(C) for d in range(C))
        logdet = torch.log(floor_below(wX + eps, eps)).sum(dim=0) - torch.log(floor_below(wXh + eps, eps)).sum(dim=0)
        return (trace - logdet - C).sum()

    def _separate_sawada(self, state):
        """Multichannel Wiener filter at the reference mic (``mnmf.py:554-583``):
        ``ZTV_s (H_s X^-1 x)[reference_id]``."""
        X, H = state["input"], state["spatial"]  # (C, F, T), (F, S, C, C)
        C, n_sources = self.n_channels, H.shape[1]
        inv = self._inv_xhat_compact(state)
        v = [_sum(compact_entry(inv, c, d) * X[d] for d in range(C)) for c in range(C)]  # X^-1 x
        Href = H[:, :, self.reference_id, :]  # (F, S, C)
        HXx = torch.stack([_sum(Href[:, s, d][:, None] * v[d] for d in range(C)) for s in range(n_sources)])
        return self._ztv(state).to(HXx.dtype) * HXx

    # Ozerov (EM); every (bin, frame) quantity is a list of (F, T) component
    # planes over the small channel and source axes
    def _sigma_components(self, state):
        """Hermitian ``Sigma_x = A diag(sigma_s) A^H + diag(sigma_b)`` as
        component planes ``Sx[c][d] (F, T)`` (real diagonal, the lower
        triangle the conjugate of the upper) and the per-source variances
        ``sigma_s (S, F, T)`` (``mnmf.py:307-330``)."""
        A = state["mix_filter"]  # (F, C, S)
        sigma_b = state["noise_covariance"]  # (F, C)
        C, S = self.n_channels, self.n_sources
        sigma_s = state["basis"] @ state["activation"]  # (S, F, T)
        sA = sigma_s.to(A.dtype)
        Sx = [[None] * C for _ in range(C)]
        for c in range(C):
            for d in range(c, C):
                acc = _sum((A[:, c, s] * A[:, d, s].conj())[:, None] * sA[s] for s in range(S))
                if c == d:
                    Sx[c][c] = acc.real + sigma_b[:, c][:, None]
                else:
                    Sx[c][d] = acc
                    Sx[d][c] = acc.conj()
        return Sx, sigma_s

    @staticmethod
    def _adjugate_components(Sx):
        """Adjugate of Hermitian component planes (closed form, C <= 3)."""
        C = len(Sx)
        if C == 1:
            return [[torch.ones_like(Sx[0][0])]]
        if C == 2:
            return [[Sx[1][1], -Sx[0][1]], [-Sx[1][0], Sx[0][0]]]
        if C == 3:
            a, b, c0 = Sx[0]
            d, e, f = Sx[1]
            g, h, i = Sx[2]
            return [
                [e * i - f * h, c0 * h - b * i, b * f - c0 * e],
                [f * g - d * i, a * i - c0 * g, c0 * d - a * f],
                [d * h - e * g, b * g - a * h, a * e - b * d],
            ]
        raise ValueError("adjugate closed forms cover C <= 3, got {}".format(C))

    @staticmethod
    def _det_components(Sx):
        """Real determinant of Hermitian component planes (C <= 3)."""
        C = len(Sx)
        if C == 1:
            return Sx[0][0]
        if C == 2:
            return Sx[0][0] * Sx[1][1] - (Sx[0][1] * Sx[1][0]).real
        if C == 3:
            return (
                Sx[0][0] * (Sx[1][1] * Sx[2][2] - (Sx[1][2] * Sx[2][1]).real)
                - (Sx[0][1] * (Sx[1][0] * Sx[2][2] - Sx[1][2] * Sx[2][0])).real
                + (Sx[0][2] * (Sx[1][0] * Sx[2][1] - Sx[1][1] * Sx[2][0])).real
            )
        raise ValueError("det closed forms cover C <= 3, got {}".format(C))

    @classmethod
    def _det_floored(cls, Sx):
        """The determinant floored at ``100 eps_machine prod_c Sx[c, c]``
        (``det <= prod diag`` for PSD): the closed form cancels to <= 0 for a
        near-singular float32 ``Sigma_x``, and 1/det would NaN the
        posteriors; at float64 it engages only beyond condition ~1e13."""
        det = cls._det_components(Sx)
        prod_diag = Sx[0][0]
        for c in range(1, len(Sx)):
            prod_diag = prod_diag * Sx[c][c]
        return torch.maximum(det, 100.0 * torch.finfo(det.dtype).eps * prod_diag)

    def _collapsed_posteriors(self, state, Sx):
        """``M2 = A^H Sigma_x^-1 A`` (Hermitian components, S x S) and ``v =
        A^H Sigma_x^-1 x (S, F, T)``, the only E-step quantities the M step
        reads; ``Sigma_x^-1`` is the adjugate over the floored determinant."""
        A, X = state["mix_filter"], state["input"]
        C, S = self.n_channels, self.n_sources
        adj = self._adjugate_components(Sx)
        inv_det = 1.0 / self._det_floored(Sx)  # (F, T)
        t = [[_sum(A[:, c, s].conj()[:, None] * adj[c][d] for c in range(C)) for d in range(C)] for s in range(S)]
        v = torch.stack([_sum(t[s][d] * X[d] for d in range(C)) * inv_det for s in range(S)])
        M2 = [[None] * S for _ in range(S)]
        for s in range(S):
            for r in range(s, S):
                M2[s][r] = _sum(t[s][d] * A[:, d, r][:, None] for d in range(C)) * inv_det
                if r != s:
                    M2[r][s] = M2[s][r].conj()
        return M2, v

    def _update_ozerov(self, state):
        """One EM iteration (``mnmf.py:307-375``, with the JAX package's
        divergences and float32 guards)."""
        X, W, H = state["input"], state["basis"], state["activation"]
        C, S = self.n_channels, self.n_sources
        Sx, sigma_s = self._sigma_components(state)
        M2, v = self._collapsed_posteriors(state, Sx)
        # the diagonal of M2 is real: its imaginary rounding is dropped, as
        # the JAX package stores it
        diag = torch.stack([M2[s][s].real for s in range(S)])  # (S, F, T)
        for s in range(S):
            M2[s][s] = diag[s].to(v.dtype)
        sA = sigma_s.to(v.dtype)
        s_post = v * sA  # posterior means (S, F, T)

        # sufficient statistics; R_xx is the invariant second moment
        R_xx = state["second_moment"]  # (F, C, C)
        R_xs = torch.stack(
            [torch.stack([(X[c] * s_post[s].conj()).mean(dim=-1) for s in range(S)], -1) for c in range(C)], -2
        )  # (F, C, S)
        R_ss = torch.stack(
            [
                torch.stack(
                    [
                        (s_post[s] * s_post[r].conj() + ((1.0 if s == r else 0.0) - sA[s] * M2[s][r]) * sA[r]).mean(
                            dim=-1
                        )
                        for r in range(S)
                    ],
                    -1,
                )
                for s in range(S)
            ],
            -2,
        )  # (F, S, S)
        R_ss = 0.5 * (R_ss + R_ss.transpose(-2, -1).conj())
        # U = sigma^2 B + sigma per component: the MU ratios below need only B
        B_post = torch.abs(v) ** 2 - diag  # (S, F, T)

        # M step: A = R_xs R_ss^-1 with a trace-relative ridge (a source dead
        # at a bin makes R_ss singular at float32), floored at sqrt(tiny)
        finfo = torch.finfo(R_ss.real.dtype)
        ridge = torch.clamp(
            100.0 * finfo.eps * torch.diagonal(R_ss, dim1=-2, dim2=-1).sum(dim=-1).real / S, min=math.sqrt(finfo.tiny)
        )
        eye = torch.eye(S, dtype=R_ss.dtype, device=R_ss.device)
        A_new = R_xs @ batched_inv(R_ss + ridge[:, None, None].to(R_ss.dtype) * eye)
        A_newh, R_xs_h = A_new.transpose(-2, -1).conj(), R_xs.transpose(-2, -1).conj()
        residual = torch.diagonal(
            R_xx - A_new @ R_xs_h - R_xs @ A_newh + A_new @ R_ss @ A_newh, dim1=-2, dim2=-1
        ).real
        # the dtype's own floor: 1e-12 is below float32 resolution in the
        # equilibrated frame, where Sigma_x would round to singular
        sigma_b = floor_below(residual, max(self.eps, 100.0 * torch.finfo(residual.dtype).eps))
        if self.annealing:
            # the schedule, defined in the input power frame, floor-maxes the
            # M-step estimate in the working frame
            frac = torch.clamp(state["step_count"].to(sigma_b.dtype) / max(self.annealing_iterations, 1), max=1.0)
            s0 = self.annealing_start * self._anneal_base
            s1 = self.annealing_end * self._anneal_base
            level = s0 * (s1 / s0) ** frac / state["bin_scale"][:, None]
            sigma_b = torch.maximum(sigma_b, level)

        # W: mean_t U / H = W + W^2 mean_t(H B) exactly; H from the new W
        n_frames, n_bins = B_post.shape[-1], W.shape[1]
        C1 = torch.einsum("skt,sft->sfk", H, B_post) / n_frames  # (S, F, K)
        W_new = W + W**2 * C1
        Wf = floor_below(W_new, self.eps)
        H_new = H**2 * (torch.einsum("sfk,sft->skt", W**2 / Wf, B_post) / n_bins) + H * (W / Wf).mean(dim=1)[:, :, None]

        if self.normalize:
            # a_s -> a_s / lambda with W -> W lambda^2 per (bin, source), then
            # the bin-sum normaliser in the input frame
            scale = torch.sqrt(torch.sum(torch.abs(A_new) ** 2, dim=1, keepdim=True))  # (F, 1, S)
            scale = torch.clamp(scale, min=math.sqrt(torch.finfo(scale.dtype).tiny))
            A_new = A_new / scale.to(A_new.dtype)
            W_new = W_new * scale.permute(2, 0, 1) ** 2
            wsum = (W_new * state["bin_scale"][None, :, None]).sum(dim=1)  # (S, K)
            W_new = W_new / wsum[:, None, :]
            H_new = H_new * wsum[:, :, None]

        out = dict(state, mix_filter=A_new, noise_covariance=sigma_b, basis=W_new, activation=H_new)
        if "step_count" in state:
            out["step_count"] = state["step_count"] + 1
        return out

    def _nll_ozerov(self, state):
        """Gaussian NLL ``x^H Sigma_x^-1 x + log det Sigma_x`` from the
        adjugate, with the equilibration's ``C log s`` restored."""
        X = state["input"]
        C = self.n_channels
        Sx, _ = self._sigma_components(state)
        adj = self._adjugate_components(Sx)
        det = self._det_floored(Sx)
        quad = _sum((X[c].conj() * _sum(adj[c][d] * X[d] for d in range(C))).real for c in range(C)) / det
        logdet = torch.log(torch.abs(det)) + C * torch.log(state["bin_scale"])[:, None]
        return (quad + logdet).sum()

    def _separate_ozerov(self, state):
        """Posterior mean of the sources (``mnmf.py:585-617``, its duplicated
        ``A sigma_s`` fixed), back in the input frame."""
        Sx, sigma_s = self._sigma_components(state)
        _, v = self._collapsed_posteriors(state, Sx)
        root = torch.sqrt(state["bin_scale"])[:, None].to(v.dtype)
        return v * sigma_s.to(v.dtype) * root

    def _sync_attributes(self, state):
        # publish (and so checkpoint) the Ozerov factors in the input frame:
        # init_state re-equilibrates warm-start kwargs
        super()._sync_attributes(state)
        if "bin_scale" in state:
            s = state["bin_scale"]
            self.basis = state["basis"] * s[None, :, None]
            self.noise_covariance = state["noise_covariance"] * s[:, None]

    def update_state(self, state):
        return self._update_sawada(state) if self._sawada else self._update_ozerov(state)

    def nll(self, state):
        return self._nll_sawada(state) if self._sawada else self._nll_ozerov(state)

    def finalize(self, state):
        return self._separate_sawada(state) if self._sawada else self._separate_ozerov(state)

    def __repr__(self):
        return "IS-MNMF(n_basis={}, normalize={}, author={})".format(self.n_basis, self.normalize, self.author)


class MultichanneltNMF(MultichannelNMFBase):
    """Stub with warning, as in the reference (``bss/mnmf.py:619-635``)."""

    def __init__(self, n_basis=10, n_sources=None, reference_id=0, **kwargs):
        warnings.warn("in progress", UserWarning)
        super().__init__(n_basis=n_basis, n_sources=n_sources, **kwargs)
        self.reference_id = reference_id

    def nll(self, state):
        raise NotImplementedError("Implement 'compute_negative_loglikelihood' method.")


class FastMultichannelISNMF(MultichannelNMFBase):
    """FastMNMF with jointly diagonalisable spatial covariances
    (``bss/mnmf.py:637-946``).

    The per-(channel, bin, frame) powers are channel-leading ``(M, F, T)``;
    ``|Q x|^2`` is carried as ``qx_power`` and refreshed once an iteration,
    from the invariant pair-product planes unless ``guard="svd"``.  The
    diagonaliser update forms all M weighted covariances in one K1 call,
    then sweeps the rows in component layout at C <= 4 with a cheap guard,
    else in matrix layout with :func:`~..ops.ip.cond_guard`.
    """

    state_fields = ("diagonalizer", "spatial_covariance", "basis", "activation", "latent")
    callback_on_init = False  # callbacks run after iterations only (``mnmf.py:713-716``)

    def __init__(
        self,
        n_basis=10,
        n_sources=None,
        partitioning=False,
        normalize="power",
        reference_id=0,
        callbacks=None,
        recordable_loss=True,
        eps=EPS,
        threshold=THRESHOLD,
        guard="one_norm",
        device=None,
    ):
        super().__init__(
            n_basis=n_basis,
            n_sources=n_sources,
            callbacks=callbacks,
            recordable_loss=recordable_loss,
            eps=eps,
            device=device,
        )
        if partitioning:
            raise ValueError("Not support partitioning function.")
        self.partitioning = partitioning
        self.normalize = normalize
        self.reference_id = reference_id
        self.threshold = threshold
        self.guard = guard

    def prepare_state_kwargs(self, input, state_kwargs):
        n_channels, n_bins, n_frames = input.shape
        n_sources = self.n_sources or n_channels
        if "diagonalizer" not in state_kwargs:
            eye = torch.eye(n_channels, dtype=input.dtype, device=input.device)
            state_kwargs["diagonalizer"] = eye.expand(n_bins, n_channels, n_channels)
        if "spatial_covariance" not in state_kwargs:
            G = np.ones((n_sources, n_bins, n_channels)) * 1e-2
            for m in range(n_channels):
                G[m % n_sources, :, m] = 1
            state_kwargs["spatial_covariance"] = G
        if "basis" not in state_kwargs:
            state_kwargs["basis"] = np.random.rand(n_sources, n_bins, self.n_basis)
        if "activation" not in state_kwargs:
            state_kwargs["activation"] = np.random.rand(n_sources, self.n_basis, n_frames)
        return state_kwargs

    def init_state(self, X, **kwargs):
        n_channels = X.shape[0]
        self.n_channels = n_channels
        if self.n_sources is None:
            self.n_sources = n_channels
        state = {"input": X, **_state_tensors(X, kwargs)}
        if self.guard != "svd":
            state["pair_products"] = pair_products_planes(X)
        state["qx_power"] = self._compute_qx_power(state)
        return state

    @staticmethod
    def _compute_qx_power(state):
        """``|sum_c Q[f, m, c] x_c|^2 (M, F, T)`` (``mnmf.py:782-783``): a
        real quadratic form over the pair-product planes where they are
        carried, else the rows formed."""
        Q = state["diagonalizer"]  # (F, M, C)
        planes = state.get("pair_products")
        if planes is not None:
            return quadratic_power_planes(Q, planes)
        X = state["input"]
        rows = []
        for m in range(X.shape[0]):
            rows.append(torch.abs(_sum(Q[:, m, c][:, None] * X[c] for c in range(X.shape[0]))) ** 2)
        return torch.stack(rows)

    def _model_power(self, state):
        """``R[m] = sum_s (W H)_s g[s, :, m] (M, F, T)`` as one GEMM, ``g``
        folded into ``W`` over the joint (source, basis) axis; contiguous, as
        K1 takes ``1 / R``."""
        W, H = state["basis"], state["activation"]
        g = state["spatial_covariance"]  # (S, F, M)
        n_sources, n_bins, n_basis = W.shape
        Wg = torch.einsum("sfk,sfm->mfsk", W, g).reshape(g.shape[-1], n_bins, n_sources * n_basis)
        return torch.matmul(Wg, H.reshape(n_sources * n_basis, -1))

    def _update_nmf(self, state):
        """MU sweeps of W then H (``mnmf.py:789-813``), the frame or bin
        contraction first, into a small ``(M, F, S, K)`` tensor."""
        eps = self.eps
        g = state["spatial_covariance"]
        W, H = state["basis"], state["activation"]
        x_tilde = state["qx_power"]  # (M, F, T)

        R = floor_below(self._model_power(state), eps)
        E_num = torch.einsum("mft,skt->mfsk", x_tilde / R**2, H)
        E_den = torch.einsum("mft,skt->mfsk", 1 / R, H)
        num = torch.einsum("sfm,mfsk->sfk", g, E_num)
        den = floor_below(torch.einsum("sfm,mfsk->sfk", g, E_den), eps)
        W = W * torch.sqrt(num / den)
        state = dict(state, basis=W)

        R = floor_below(self._model_power(state), eps)
        Wg = torch.einsum("sfk,sfm->skmf", W, g)  # (S, K, M, F)
        num = torch.einsum("mft,skmf->skt", x_tilde / R**2, Wg)
        den = floor_below(torch.einsum("mft,skmf->skt", 1 / R, Wg), eps)
        return dict(state, activation=H * torch.sqrt(num / den))

    def _update_scm(self, state):
        """Gain MU (``mnmf.py:815-827``) from the same frame contractions."""
        eps = self.eps
        g = state["spatial_covariance"]
        W, H = state["basis"], state["activation"]
        R = floor_below(self._model_power(state), eps)
        x_tilde = state["qx_power"]
        E_num = torch.einsum("mft,skt->mfsk", x_tilde / R**2, H)
        E_den = torch.einsum("mft,skt->mfsk", 1 / R, H)
        A = torch.einsum("sfk,mfsk->sfm", W, E_num)
        B = floor_below(torch.einsum("sfk,mfsk->sfm", W, E_den), eps)
        return dict(state, spatial_covariance=g * torch.sqrt(A / B))

    def _update_diagonalizer(self, state):
        """IP-style row update of Q (``mnmf.py:848-888``).  R is fixed for
        the whole sweep, so all M covariances ``U_m = (1/T) sum_t x x^H /
        R_m`` come from one call of K1 with per-bin ``(M, F, T)`` weights."""
        eps, threshold = self.eps, self.threshold
        Q = state["diagonalizer"]
        C = Q.shape[-1]
        R = floor_below(self._model_power(state), eps)  # (M, F, T)
        U_planes = weighted_covariance_planes(state["input"], 1.0 / R)  # (C^2, F, M): one K1 launch

        if self.guard in ("one_norm", "none") and C <= 4:
            U_all = assemble_components(U_planes)
            Q_rows = [[Q[:, i, c] for c in range(C)] for i in range(C)]
            for m in range(C):
                U = U_all[m]
                QV = [[_sum(Q_rows[i][c] * U[c][j] for c in range(C)) for j in range(C)] for i in range(C)]
                det = det_components(QV, C)
                q_m = solve_column_components(QV, C, m, det=det)
                ok = None
                if self.guard == "one_norm":
                    inv_cols = [solve_column_components(QV, C, j, det=det) for j in range(C)]
                    norm = torch.stack([_sum(torch.abs(QV[i][j]) for i in range(C)) for j in range(C)]).amax(dim=0)
                    inv_norm = torch.stack(
                        [_sum(torch.abs(inv_cols[j][i]) for i in range(C)) for j in range(C)]
                    ).amax(dim=0)
                    ok = norm * inv_norm < threshold
                Uq = [_sum(U[c][d] * q_m[d] for d in range(C)) for c in range(C)]
                qVq = _sum((q_m[c].conj() * Uq[c]).real for c in range(C))
                denominator = floor_below(torch.sqrt(qVq), eps)
                for c in range(C):
                    new_c = q_m[c].conj() / denominator
                    Q_rows[m][c] = new_c if ok is None else torch.where(ok, new_c, Q_rows[m][c])
            Q = torch.stack([torch.stack(row, dim=-1) for row in Q_rows], dim=1)
            return dict(state, diagonalizer=Q)

        V_all = assemble_matrices(U_planes)  # (M, F, C, C)
        for m in range(C):
            V = V_all[m]
            QV = Q @ V
            # LU, as the JAX package's jnp.linalg.inv; no invertibility check
            # (it would read the result on the host)
            QV_inv = torch.linalg.inv_ex(QV).inverse
            ok = cond_guard(QV, QV_inv, threshold=threshold, guard=self.guard)
            q_m = QV_inv[..., :, m]
            qVq = torch.einsum("fc,fcd,fd->f", q_m.conj(), V, q_m)
            denominator = floor_below(torch.sqrt(qVq).real, eps)
            row = torch.where(ok[:, None], q_m.conj() / denominator[:, None], Q[:, m, :])
            Q = torch.cat([Q[:, :m], row[:, None], Q[:, m + 1 :]], dim=1)
        return dict(state, diagonalizer=Q)

    def _normalize_state(self, state):
        """The power normalisation chain Q -> g -> W -> H (``mnmf.py:743-771``)."""
        if not self.normalize:
            return state
        if self.normalize != "power":
            raise ValueError("Not support normalization based on {}. Choose 'power'".format(self.normalize))
        eps = self.eps
        Q, g = state["diagonalizer"], state["spatial_covariance"]
        W, H = state["basis"], state["activation"]

        QQsum = floor_below((Q * Q.conj()).real.sum(dim=2).mean(dim=1), eps)  # (F,)
        Q = Q / torch.sqrt(QQsum)[:, None, None].to(Q.dtype)
        g = g / QQsum[None, :, None]

        g_sum = floor_below(g.sum(dim=2), eps)
        g = g / g_sum[:, :, None]
        W = W * g_sum[:, :, None]

        Wsum = floor_below(W.sum(dim=1), eps)
        W = W / Wsum[:, None]
        H = H * Wsum[:, :, None]
        return dict(state, diagonalizer=Q, spatial_covariance=g, basis=W, activation=H)

    def update_state(self, state):
        state = self._update_nmf(state)
        state = self._update_scm(state)
        state = self._update_diagonalizer(state)
        state = self._normalize_state(state)
        # |Q x|^2 once, after every change of Q this iteration
        return dict(state, qx_power=self._compute_qx_power(state))

    def nll(self, state):
        """``sum (x~/y~ + log y~) - T sum log|det Q Q^T|`` (``mnmf.py:890-917``)."""
        eps = self.eps
        Q = state["diagonalizer"]
        x_tilde = state["qx_power"] + eps
        y_tilde = self._model_power(state) + eps
        detQQ = torch.abs(batched_det(Q @ Q.transpose(-2, -1)))
        return torch.sum(x_tilde / y_tilde + torch.log(y_tilde)) - state["input"].shape[-1] * torch.sum(
            torch.log(detQQ)
        )

    def finalize(self, state):
        """Wiener mask in the Q domain and the ``Q^-1`` row at the reference
        mic (``mnmf.py:919-946``)."""
        X, Q = state["input"], state["diagonalizer"]
        g = state["spatial_covariance"]
        n_channels, n_sources = X.shape[0], g.shape[0]
        Lam = state["basis"] @ state["activation"]  # (S, F, T)
        LambdaG = Lam[:, None] * g.permute(0, 2, 1)[:, :, :, None]  # (S, M, F, T)
        y_tilde = floor_below(LambdaG.sum(dim=0), self.eps)  # (M, F, T)
        QX = [_sum(Q[:, m, c][:, None] * X[c] for c in range(n_channels)) for m in range(n_channels)]
        Q_inv = batched_inv(Q)  # (F, C, M)
        q_ref = [Q_inv[:, self.reference_id, m] for m in range(n_channels)]
        mask = (LambdaG / y_tilde).to(X.dtype)  # (S, M, F, T)
        return torch.stack(
            [_sum(q_ref[m][:, None] * (QX[m] * mask[s, m]) for m in range(n_channels)) for s in range(n_sources)]
        )

    def __repr__(self):
        return "FastMNMF(n_basis={}, partitioning={}, normalize={})".format(
            self.n_basis, self.partitioning, self.normalize
        )
