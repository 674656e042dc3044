"""Primal-dual splitting BSS (PDS-BSS) and ProxLaplaceIVA (reference
``bss/prox.py`` and ``bss/iva.py:831-916``).

  * ``PDSBSSBase``: primal-dual splitting over the demixing filter.  The
    reference builds a block-diagonal scipy ``bsr_matrix`` of the per-bin
    ``(n_frames, n_channels)`` data matrices and normalises it by its
    largest singular value (``prox.py:67-79``).  Here the operator and its
    adjoint are two batched matmuls over the bins, and the spectral norm is
    ``sqrt(max_f lambda_max(X_f^H X_f))`` from the Gram planes' closed-form
    eigenvalues (:func:`~..ops.fast_linalg.hermitian_eigvalsh_planes`,
    C <= 3), the same number without an SVD;
  * ``prox_logdet``: the shrinkage ``sigma <- (sigma + sqrt(sigma^2 +
    4 mu)) / 2`` of the singular values (``prox.py:151-179``), in closed
    form on the ``W^H W`` eigenpairs at C = 2, by ``torch.linalg.svd``
    above;
  * ``ProxLaplaceIVA``: the group-l2 prox over frequency (``iva.py:867-889``)
    and the penalty ``C sum sqrt(sum_f |Y|^2)`` (``iva.py:891-904``);
  * ``SparseProxIVA`` raises, as in the reference (``iva.py:906-916``).

State: ``{"input", "input_normalized" (F, C, T), "demix_filter" (F, N, C),
"dual" (F, N, T), "estimation" (N, F, T)}``.  ``dual`` warm-starts;
``estimation`` is derived from ``W`` (a passed one is ignored).  Callbacks
run after iterations only (``prox.py:95-102``).  No kernel is on this path.

Under a mesh (the JAX package's ``field_axes``) the per-bin operator shards
with the bins or the frames.  In bins mode the spectral norm is a maximum
over the shards (one all-reduce at init) and the group-l2 norms over
frequency are all-reduced; in frames mode the Grams and the adjoint's sums
over frames are.  The NLL's sums are all-reduced in either mode.
"""

import torch

from ..algorithm.projection_back import projection_back
from ..ops.fast_linalg import batched_log_abs_det, hermitian_eigvalsh_planes
from ..runtime.solver import IterativeSolver
from ..utils.flooring import EPS


class PDSBSSBase(IterativeSolver):
    """Primal-dual splitting solver base (``prox.py:13-201``)."""

    state_fields = ("demix_filter", "estimation", "dual")
    callback_on_init = False

    def __init__(
        self,
        regularizer=1,
        step_prox_logdet=1e0,
        step_prox_penalty=1e0,
        step=1e0,
        callbacks=None,
        recordable_loss=True,
        eps=EPS,
        device=None,
    ):
        super().__init__(callbacks=callbacks, recordable_loss=recordable_loss, eps=eps, device=device)
        self.regularizer = regularizer
        self.step_prox_logdet = step_prox_logdet
        self.step_prox_penalty = step_prox_penalty
        self.step = step

    def field_axes(self):
        """The JAX package's shardable axes, ``input_normalized`` in the
        port's ``(F, C, T)`` layout."""
        return {
            "input": {"bins": 1, "frames": 2},
            "input_normalized": {"bins": 0, "frames": 2},  # (F, C, T)
            "demix_filter": {"bins": 0},
            "dual": {"bins": 0, "frames": 2},  # (F, N, T)
            "estimation": {"bins": 1, "frames": 2},
        }

    @staticmethod
    def separate(input, demix_filter):
        return (demix_filter @ input.permute(1, 0, 2)).permute(1, 0, 2)

    def init_state(self, X, demix_filter=None, estimation=None, dual=None):
        n_channels, n_bins, n_frames = X.shape
        self.n_sources = self.n_channels = n_channels
        self.n_bins = self._n_bins_true if self._sharded else n_bins
        self.n_frames = self._n_frames(X)
        if demix_filter is None:
            W = torch.eye(n_channels, dtype=X.dtype, device=X.device).repeat(n_bins, 1, 1)
        else:
            W = torch.as_tensor(demix_filter).to(device=X.device, dtype=X.dtype)
        if dual is None:
            y = torch.zeros((n_bins, n_channels, n_frames), dtype=X.dtype, device=X.device)
        else:
            y = torch.as_tensor(dual).to(device=X.device, dtype=X.dtype)
        # the block-diagonal operator's largest singular value: sqrt of the
        # largest eigenvalue of any bin's C x C Gram
        G = self._frames_sum(torch.einsum("cft,dft->cdf", X.conj(), X))  # (C, C, F) Gram planes
        norm = torch.sqrt(self._shard_max(hermitian_eigvalsh_planes(G)[-1].max(), "bins"))
        return {
            "input": X,
            "input_normalized": X.permute(1, 0, 2) / norm,  # (F, C, T)
            "demix_filter": W,
            "estimation": self.separate(X, W),
            "dual": y,
        }

    def _apply_operator(self, Xn, W):
        """``(X~ w)(f, n, t) = sum_c X(f, c, t) w(f, n, c)``: (F, N, T)."""
        return W @ Xn

    def _apply_adjoint(self, Xn, y):
        """``(X~^H y)(f, n, c) = sum_t conj(X(f, c, t)) y(f, n, t)``: (F, N, C)."""
        return self._frames_sum(y @ Xn.transpose(-2, -1).conj())

    def prox_logdet(self, W, mu=1):
        """Singular-value shrinkage ``sigma <- (sigma + sqrt(sigma^2 + 4 mu))
        / 2`` (``prox.py:151-179``).

        At C = 2 (:meth:`_prox_logdet_planes_2x2`) the shrinkage only
        rescales singular values, so with ``(Lambda, V) = eig(W^H W)`` it is
        ``W V h(Lambda) V^H`` with ``h(l) = (1 + sqrt(1 + 4 mu / l)) / 2``:
        exact for invertible ``W``, in closed form.  Larger C takes the SVD.
        """
        if W.shape[-1] == W.shape[-2] == 2:
            return self._prox_logdet_planes_2x2(W, mu)
        U, sigma, Vh = torch.linalg.svd(W, full_matrices=False)
        sigma = (sigma + torch.sqrt(sigma**2 + 4 * mu)) / 2
        return (U * sigma[..., None, :].to(U.dtype)) @ Vh

    def _prox_logdet_planes_2x2(self, W, mu):
        eps = self.eps
        # the Gram G = W^H W in components: G[a][b] = sum_c conj(W[c, a]) W[c, b]
        Wc = [[W[..., c, a] for a in range(2)] for c in range(2)]
        g00 = sum((Wc[c][0].conj() * Wc[c][0]).real for c in range(2))
        g11 = sum((Wc[c][1].conj() * Wc[c][1]).real for c in range(2))
        g01 = sum(Wc[c][0].conj() * Wc[c][1] for c in range(2))
        mean = (g00 + g11) / 2
        rad = torch.sqrt(((g00 - g11) / 2) ** 2 + torch.abs(g01) ** 2)
        tiny = torch.finfo(rad.dtype).tiny
        lam1 = mean + rad  # the larger
        # lam2 = mean - rad cancels catastrophically when sigma_2 << sigma_1;
        # the product form lam1 lam2 = det G is exact to machine precision
        detG = torch.clamp(g00 * g11 - torch.abs(g01) ** 2, min=0.0)
        lam2 = detG / torch.clamp(lam1, min=tiny)

        # h(lam) sigma = (sigma + sqrt(sigma^2 + 4 mu)) / 2 is exact for any
        # lam > 0: only exact zeros need the floor, at sqrt(tiny), which keeps
        # 4 mu / lam finite (an eps-level floor would bias the shrinkage of
        # near-singular filters)
        floor = tiny**0.5

        def h(lam):
            return (1 + torch.sqrt(1 + 4 * mu / torch.clamp(lam, min=floor))) / 2

        h1, h2 = h(lam1), h(lam2)
        # lam1's eigenvector of [[g00, g01], [g01*, g11]] is [g01, lam1 - g00],
        # or a basis vector where the off-diagonal vanishes; lam2's is its
        # orthogonal complement
        degenerate = torch.abs(g01) <= eps * (torch.abs(g00) + torch.abs(g11) + eps)
        first_is_major = g00 >= g11
        one, zero = torch.ones_like(g01), torch.zeros_like(g01)
        v0 = torch.where(degenerate, torch.where(first_is_major, one, zero), g01)
        v1 = torch.where(degenerate, torch.where(first_is_major, zero, one), (lam1 - g00).to(W.dtype))
        norm = torch.clamp(torch.sqrt(torch.abs(v0) ** 2 + torch.abs(v1) ** 2), min=eps)
        v0, v1 = v0 / norm, v1 / norm
        # M = h1 v v^H + h2 (I - v v^H), a rank-1 spectral update
        h1c, h2c = h1.to(W.dtype), h2.to(W.dtype)
        M00 = h2c + (h1c - h2c) * (v0 * v0.conj())
        M11 = h2c + (h1c - h2c) * (v1 * v1.conj())
        M01 = (h1c - h2c) * (v0 * v1.conj())
        M10 = M01.conj()
        rows = [
            torch.stack([Wc[c][0] * M00 + Wc[c][1] * M10, Wc[c][0] * M01 + Wc[c][1] * M11], dim=-1)
            for c in range(2)
        ]
        return torch.stack(rows, dim=-2)

    def prox_penalty(self, z, mu=1):
        raise NotImplementedError("Implement `prox_penalty` method")

    def compute_penalty(self, state):
        raise NotImplementedError("Implement `compute_penalty` method in subclass")

    def update_state(self, state):
        mu1, mu2 = self.step_prox_logdet, self.step_prox_penalty
        alpha = self.step
        X, Xn = state["input"], state["input_normalized"]
        W, y = state["demix_filter"], state["dual"]

        W_tilde = self.prox_logdet(W - mu1 * mu2 * self._apply_adjoint(Xn, y), mu1)
        z = y + self._apply_operator(Xn, 2 * W_tilde - W)
        y_tilde = z - self.prox_penalty(z, 1 / mu2)
        y = alpha * y_tilde + (1 - alpha) * y
        W = alpha * W_tilde + (1 - alpha) * W
        return dict(state, demix_filter=W, dual=y, estimation=self.separate(X, W))

    def nll(self, state):
        return self.compute_penalty(state) - self._bins_sum(batched_log_abs_det(state["demix_filter"]).sum())

    def finalize(self, state):
        return self.separate(state["input"], state["demix_filter"])


class ProxLaplaceIVA(PDSBSSBase):
    """PDS IVA with the group-l2-over-frequency penalty (``bss/iva.py:831-904``)."""

    def __init__(
        self,
        regularizer=1,
        step_prox_logdet=1e0,
        step_prox_penalty=1e0,
        step=1e0,
        reference_id=0,
        callbacks=None,
        apply_projection_back=True,
        recordable_loss=True,
        eps=EPS,
        device=None,
    ):
        super().__init__(
            regularizer=regularizer,
            step_prox_logdet=step_prox_logdet,
            step_prox_penalty=step_prox_penalty,
            step=step,
            callbacks=callbacks,
            recordable_loss=recordable_loss,
            eps=eps,
            device=device,
        )
        self.reference_id = reference_id
        self.apply_projection_back = apply_projection_back

    def capturable(self, X):
        """Every configuration at C = 2 only: the log-determinant's prox
        takes ``torch.linalg.svd`` past C = 2 (:meth:`prox_logdet`), whose
        status is read on the host, so those calls keep the eager loop."""
        return X.shape[0] == 2

    def prox_penalty(self, z, mu=1):
        """Group-l2 shrinkage over the frequency axis of ``z (n_bins,
        n_sources, n_frames)`` (``iva.py:867-889``)."""
        denominator = torch.sqrt(self._bins_sum(torch.sum(torch.abs(z) ** 2, dim=0)))  # (n_sources, n_frames)
        denominator = torch.where(denominator <= 0, mu, denominator)
        scale = self.regularizer * torch.clamp(1 - mu / denominator, min=0)
        return scale[None].to(z.dtype) * z

    def compute_penalty(self, state):
        """``C sum_{n, t} sqrt(sum_f |Y|^2)`` (``iva.py:891-904``)."""
        return self._penalty(self._bins_sum(torch.sum(torch.abs(state["estimation"]) ** 2, dim=1)))

    def _penalty(self, power):
        """``C sum_{n, t} sqrt(power)`` of the whole ``(N, T)`` power."""
        return self.regularizer * self._frames_sum(torch.sqrt(power).sum())

    def nll(self, state):
        # the penalty's and the log-determinants' sums over bins in one all-reduce
        power, logdet = self._shard_sums(
            [torch.sum(torch.abs(state["estimation"]) ** 2, dim=1), batched_log_abs_det(state["demix_filter"]).sum()],
            "bins",
        )
        return self._penalty(power) - logdet

    def finalize(self, state):
        X = state["input"]
        Y = self.separate(X, state["demix_filter"])
        if self.apply_projection_back:
            frames_sum = self._frames_sum if self._sharded else None
            scale = projection_back(Y, reference=X[self.reference_id], frames_sum=frames_sum)
            Y = Y * scale[..., None]
        return Y

    def __repr__(self):
        return "ProxLaplaceIVA(regularizer={}, step={})".format(self.regularizer, self.step)


class SparseProxIVA(PDSBSSBase):
    """Stub, as in the reference (``bss/iva.py:906-916``)."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError("coming soon")
