"""Independent vector analysis (IVA) solver family (reference ``bss/iva.py``).

  * ``GradLaplaceIVA`` / ``NaturalGradLaplaceIVA``: gradient and natural
    gradient descent on the Laplace IVA NLL (``iva.py:196-287``);
  * ``AuxLaplaceIVA`` / ``AuxGaussIVA``: auxiliary-function IVA with the
    spatial updates IP (``iva.py:481-523``), ISS (``iva.py:525-542``) and
    IP2/pairwise (``iva.py:544-599``);
  * ``OverAuxLaplaceIVA``: PCA to ``n_sources`` channels, AuxIVA, then
    projection-back onto the unreduced mixture;
  * ``SparseAuxIVA`` raises, as in the reference; so does IPA
    (``ValueError``) and ``AuxGaussIVA`` IP2 (``NotImplementedError``).

The state of an auxiliary-function solver takes one of four forms, fixed
at init by the spatial update, the guard and the channel count C:

  * IP with guard ``one_norm`` or ``none`` at C <= 4: ``{"input",
    "demix_components" (N, C, F), "psum" (N, T)}`` with ``psum = sum_f
    |W X|^2``, all that either contrast needs of the estimates, which are
    never formed inside the loop.  At C = 2 with guard ``one_norm`` an
    iteration is one call of :func:`~..ops.fused_ip.fused_auxiva_ip_iter`
    (kernel K2 on CUDA, with the solver's contrast; its plain version on the
    CPU), whose ``psum`` is both the next weights and this loss.  Otherwise
    ``U`` comes from :func:`~..ops.covariance.weighted_covariance_auto`
    (kernel K1 on CUDA), then the component IP sweep, and the new ``psum``
    is one matmul over the invariant ``pair_products`` planes.
  * IP with guard ``svd``, or C > 4: ``{"input", "demix_filter" (F, N, C),
    "estimation" (N, F, T)}`` and the matrix sweep of :mod:`~..ops.ip`.
  * ISS: ``{"input", "estimation"}``; the estimates are the whole state and
    ``W`` is fitted by least squares only for the NLL and the callbacks.
  * IP2/pairwise: the matrix form plus ``step_count``; the pair's two
    covariances go through K1 (``(2, T)`` weights), then the planes update
    at C <= 3 with a cheap guard, else the matrix one.

Under a mesh (:meth:`~..runtime.solver.IterativeSolver.use_mesh`) every
solver here shards as the JAX package's ``IVABase.field_axes`` says.  The
frame weights' and the NLL's sums over bins are all-reduced in bins mode,
and every sum over frames (the covariances, the gradient moments, ISS's
sweep, projection-back, the NLL's contrast) in frames mode.  Bins mode at
C = 2 with guard ``one_norm`` keeps K2, one launch and one all-reduce an
iteration; frames mode never takes K2 (its covariance is a sum over frames
inside the launch) but K1 on the shard's frames.
"""

import torch

from ..algorithm.projection_back import projection_back
from ..ops.cov_kernel import weighted_covariance_planes
from ..ops.covariance import weighted_covariance_auto
from ..ops.eig2 import generalized_eig2x2_descending
from ..ops.fast_linalg import batched_log_abs_det
from ..ops.fused_ip import fused_auxiva_ip_iter
from ..ops.ip import cond_guard, ip_update, uses_component_sweep
from ..ops.ip_components import (
    _dynamic_set_row,
    _take,
    assemble_components,
    assemble_matrices,
    filter_rows,
    frame_power_sums,
    ip2_pair_update_planes,
    ip_update_components,
    log_abs_det_components,
    natural_grad_step_components,
    pair_products_planes,
    plain_grad_step_components,
    separate_components,
    stack_filter_rows,
)
from ..ops.iss import iss_sweep
from ..runtime.solver import IterativeSolver
from ..transform.pca import pca
from ..utils.flooring import EPS, THRESHOLD, floor_below

__algorithms_spatial__ = ["IP", "IVA", "ISS", "IPA", "pairwise", "IP1", "IP2"]
_IP_UPDATES = ("IP", "IP1", "IVA")
_PAIRWISE_UPDATES = ("pairwise", "IP2")
_GUARDS = ("one_norm", "none", "svd")


def _rows(Wc):
    """``(N, C, F)`` components as the nested ``rows[n][c]`` list."""
    return [[Wc[s, c] for c in range(Wc.shape[1])] for s in range(Wc.shape[0])]


def _stack_rows(rows):
    return torch.stack([torch.stack(row) for row in rows])


class IVABase(IterativeSolver):
    """Shared IVA machinery: separation, the least-squares demixing filter,
    the state of a solver that carries ``W`` (``bss/iva.py:22-128``)."""

    state_fields = ("demix_filter", "estimation")

    def __init__(self, callbacks=None, recordable_loss=True, eps=EPS, device=None):
        super().__init__(callbacks=callbacks, recordable_loss=recordable_loss, eps=eps, device=device)

    @staticmethod
    def separate(input, demix_filter):
        """``Y = W X`` per bin: ``(C, F, T) x (F, N, C) -> (N, F, T)``; as
        component sums at C <= 4, as a batched matmul above."""
        if demix_filter.shape[2] <= 4:
            return separate_components(_rows(demix_filter.permute(1, 2, 0)), input)
        return (demix_filter @ input.permute(1, 0, 2)).permute(1, 0, 2)

    @staticmethod
    def compute_demix_filter(estimation, input, solve_dtype=None, frames_sum=None):
        """Least-squares fit ``W = Y X^H (X X^H)^{-1}`` per bin
        (``bss/iva.py:119-125``); ``solve_dtype`` solves the small per-bin
        systems at another precision (the frame sums stay in the input's);
        ``frames_sum`` is a frame-sharded caller's sum over the shards."""
        X_h = input.permute(1, 2, 0).conj()  # (F, T, C)
        XXh = input.permute(1, 0, 2) @ X_h  # (F, C, C)
        YXh = estimation.permute(1, 0, 2) @ X_h  # (F, N, C)
        if frames_sum is not None:
            XXh, YXh = frames_sum(torch.cat([XXh, YXh], dim=1)).split([XXh.shape[1], YXh.shape[1]], dim=1)
        if solve_dtype is not None:
            XXh, YXh = XXh.to(solve_dtype), YXh.to(solve_dtype)
        # W = YXh inv(XXh): solve the adjoint system (XXh is Hermitian);
        # the _ex form skips the error check, which would wait on the device
        W = torch.linalg.solve_ex(XXh, YXh.transpose(-2, -1).conj()).result
        return W.transpose(-2, -1).conj_physical()

    @staticmethod
    def _component_step(W):
        """Whether a gradient step runs in component layout (square W, C <= 4)."""
        return W.shape[1] == W.shape[2] <= 4

    def field_axes(self):
        """Shardable axes of the IVA state: the JAX package's, with the
        port's own ``psum`` (sharded with the frames)."""
        return {
            "input": {"bins": 1, "frames": 2},
            "demix_filter": {"bins": 0},
            "demix_components": {"bins": 2},
            "estimation": {"bins": 1, "frames": 2},
            "pair_products": {"bins": 1, "frames": 2},
            "psum": {"frames": 1},
        }

    def pad_state_kwarg(self, field, value, pad, axis):
        """Padded bins get identity demixing rows (zeros would make their
        log-determinants -inf); everything else zero-pads."""
        if field == "demix_filter":
            value = torch.as_tensor(value)
            n, c = value.shape[-2:]
            eye = torch.eye(n, c, dtype=value.dtype, device=value.device).expand(pad, n, c)
            return torch.cat([value, eye], dim=0)
        return super().pad_state_kwarg(field, value, pad, axis)

    def _projection_back(self, Y, reference):
        """Projection-back scales of ``Y`` at ``reference``, its frame sums
        over the shards in frames mode."""
        return projection_back(Y, reference=reference, frames_sum=self._frames_sum if self._sharded else None)

    def _iss_sweep(self, Y, inv_R):
        """One ISS sweep (:func:`~..ops.iss.iss_sweep`), its frame sums over
        the shards in frames mode."""
        shard = {"frames_sum": self._frames_sum, "n_frames": self._n_frames(Y)} if self._sharded else {}
        return iss_sweep(Y, inv_R, compat=self.iss_compat, **shard)

    def _default_filter(self, X):
        n_channels, n_bins, _ = X.shape
        eye = torch.eye(n_channels, dtype=X.dtype, device=X.device)
        return eye.expand(n_bins, n_channels, n_channels)

    def init_attributes(self, X):
        n_channels = X.shape[0]
        self.n_sources = self.n_channels = n_channels
        self.n_bins = self._n_bins_true if self._sharded else X.shape[1]
        self.n_frames = self._n_frames(X)

    def _initial_filter(self, X, demix_filter):
        self.init_attributes(X)
        if demix_filter is None:
            return self._default_filter(X)
        return torch.as_tensor(demix_filter).to(device=X.device, dtype=X.dtype)

    def init_state(self, X, demix_filter=None, estimation=None):
        W = self._initial_filter(X, demix_filter)
        # a passed ``estimation`` is ignored: the estimates are re-derived
        # from W, as the reference does at reset (``bss/iva.py:59``)
        return {"input": X, "demix_filter": W, "estimation": self.separate(X, W)}

    def _ip_sweep(self, state, inv_weights, denom_floor=None):
        """Weighted covariance (K1 on CUDA, ``(N, T)`` or per-bin ``(N, F,
        T)`` weights) and the IP row sweep on the ``(F, N, C)`` filter:
        components straight from K1's compact output for a cheap guard at
        C <= 4, the matrix sweep otherwise (:func:`~..ops.ip.ip_update`)."""
        W = state["demix_filter"]
        out = self._frames_mean(weighted_covariance_planes(state["input"], inv_weights))
        kwargs = {"threshold": self.threshold, "guard": self.guard, "denom_floor": denom_floor}
        if uses_component_sweep(self.guard, W.shape[-1]):
            return stack_filter_rows(ip_update_components(filter_rows(W), assemble_components(out), **kwargs))
        return ip_update(W, assemble_matrices(out), **kwargs)

    def __repr__(self):
        return "IVA()"


class GradIVABase(IVABase):
    """Gradient-descent IVA base (``bss/iva.py:130-194``)."""

    def __init__(
        self,
        lr=1e-1,
        reference_id=0,
        callbacks=None,
        apply_projection_back=True,
        recordable_loss=True,
        eps=EPS,
        device=None,
    ):
        super().__init__(callbacks=callbacks, recordable_loss=recordable_loss, eps=eps, device=device)
        self.lr = lr
        self.reference_id = reference_id
        self.apply_projection_back = apply_projection_back

    def capturable(self, X):
        """Every configuration: a gradient step reads nothing on the host."""
        return True

    def finalize(self, state):
        X = state["input"]
        output = self.separate(X, state["demix_filter"])
        if self.apply_projection_back:
            scale = self._projection_back(output, X[self.reference_id])
            output = output * scale[..., None]
        return output

    def _score(self, Y):
        """Multivariate Laplace score ``Y / sqrt(sum_f |Y|^2)`` on ``(N, F, T)``."""
        denom = floor_below(torch.sqrt(self._bins_sum(torch.sum(torch.abs(Y) ** 2, dim=1))), self.eps)  # (N, T)
        return Y / denom[:, None, :]

    def _moment_kwargs(self, X):
        """The gradient steps' frame-shard sum and whole frame count."""
        return {"frames_sum": self._frames_sum, "n_frames": self._n_frames(X)} if self._sharded else {}

    def nll(self, state):
        Y = state["estimation"]
        P = self._bins_sum(torch.sum(torch.abs(Y) ** 2, dim=1))  # (N, T)
        contrast = self._frames_sum(torch.sqrt(P).sum(dim=0).sum()) / self._n_frames(Y)
        return 2 * contrast - 2 * self._bins_sum(batched_log_abs_det(state["demix_filter"]).sum())

    def __repr__(self):
        return "GradIVA(lr={lr})".format(lr=self.lr)


class GradLaplaceIVA(GradIVABase):
    """Plain-gradient Laplace IVA, ``dW = Phi X^H / T - W^{-H}``
    (``bss/iva.py:196-241``)."""

    def update_state(self, state):
        X, W, Y = state["input"], state["demix_filter"], state["estimation"]
        if self._component_step(W):
            rows = plain_grad_step_components(filter_rows(W), X, self._score(Y), self.lr, **self._moment_kwargs(X))
            return dict(state, demix_filter=stack_filter_rows(rows), estimation=separate_components(rows, X))
        X_h = X.permute(1, 2, 0).conj()  # (F, T, C)
        W_invH = torch.linalg.inv_ex(W).inverse.transpose(-2, -1).conj()
        Phi = self._score(Y).permute(1, 0, 2)  # (F, N, T)
        W = W - self.lr * (self._frames_sum(Phi @ X_h) / self._n_frames(X) - W_invH)
        return dict(state, demix_filter=W, estimation=self.separate(X, W))


class NaturalGradLaplaceIVA(GradIVABase):
    """Natural-gradient Laplace IVA, ``dW = (Phi Y^H / T - I) W``
    (``bss/iva.py:243-287``)."""

    def update_state(self, state):
        X, W, Y = state["input"], state["demix_filter"], state["estimation"]
        if self._component_step(W):
            rows = natural_grad_step_components(filter_rows(W), Y, self._score(Y), self.lr, **self._moment_kwargs(X))
            return dict(state, demix_filter=stack_filter_rows(rows), estimation=separate_components(rows, X))
        Yb = Y.permute(1, 0, 2)  # (F, N, T)
        eye = torch.eye(X.shape[0], dtype=X.dtype, device=X.device)
        Phi = self._score(Y).permute(1, 0, 2)
        moments = self._frames_sum(Phi @ Yb.transpose(-2, -1).conj()) / self._n_frames(X)
        W = W - self.lr * ((moments - eye) @ W)
        return dict(state, demix_filter=W, estimation=self.separate(X, W))

    def __repr__(self):
        return "NaturalGradIVA(lr={lr})".format(lr=self.lr)


def _pair_update_matrix(W, U_mn, m, n, threshold, guard):
    """IP2 update of rows ``(m, n)`` in matrix layout (``bss/iva.py:566-599``):
    ``W (F, N, C)``, ``U_mn (2, F, C, C)``, ``m``, ``n`` 0-d tensors."""
    U_m, U_n = U_mn[0], U_mn[1]
    eye = torch.eye(W.shape[-1], dtype=W.dtype, device=W.device)
    E_mn = torch.stack([_take(eye, m, 0), _take(eye, n, 0)], dim=-1)  # (C, 2)
    WU_m, WU_n = W @ U_m, W @ U_n
    WU_m_inv, WU_n_inv = torch.linalg.inv_ex(WU_m).inverse, torch.linalg.inv_ex(WU_n).inverse
    ok_m = cond_guard(WU_m, WU_m_inv, threshold=threshold, guard=guard)
    ok_n = cond_guard(WU_n, WU_n_inv, threshold=threshold, guard=guard)
    P_m, P_n = WU_m_inv @ E_mn, WU_n_inv @ E_mn  # (F, C, 2)
    V_m = P_m.transpose(-2, -1).conj() @ U_m @ P_m  # (F, 2, 2)
    V_n = P_n.transpose(-2, -1).conj() @ U_n @ P_n
    v_m, v_n = generalized_eig2x2_descending(V_m, V_n)  # (F, 2) each
    v_m = v_m / torch.sqrt(torch.einsum("fi,fij,fj->f", v_m.conj(), V_m, v_m))[:, None]
    v_n = v_n / torch.sqrt(torch.einsum("fi,fij,fj->f", v_n.conj(), V_n, v_n))[:, None]
    w_m = torch.einsum("fci,fi->fc", P_m, v_m).conj()
    w_n = torch.einsum("fci,fi->fc", P_n, v_n).conj()
    W = _dynamic_set_row(W, m, torch.where(ok_m[:, None], w_m, _take(W, m, 1)))
    return _dynamic_set_row(W, n, torch.where(ok_n[:, None], w_n, _take(W, n, 1)))


class AuxIVABase(IVABase):
    """Auxiliary-function IVA base (``bss/iva.py:289-386``).

    ``algorithm_spatial``: 'IP'/'IP1'/'IVA' (iterative projection), 'ISS'
    (rank-1 source steering, no demixing filter), 'IP2'/'pairwise'
    (pairwise joint diagonalisation); 'IPA' raises ``ValueError``, as in the
    reference (``iva.py:601-602``).  ``iss_compat`` selects the reference's
    ISS self-steering scale (see :mod:`~..ops.iss`).  Subclasses set
    ``contrast`` (K2's instance) and the contrast's weights and NLL term.
    """

    state_fields = ("demix_filter", "estimation", "step_count")
    contrast = None

    def __init__(
        self,
        algorithm_spatial="IP",
        reference_id=0,
        callbacks=None,
        apply_projection_back=True,
        recordable_loss=True,
        eps=EPS,
        threshold=THRESHOLD,
        guard="one_norm",
        iss_compat=False,
        device=None,
    ):
        super().__init__(callbacks=callbacks, recordable_loss=recordable_loss, eps=eps, device=device)
        if algorithm_spatial not in __algorithms_spatial__:
            raise ValueError("Not support {} based spatial updates.".format(algorithm_spatial))
        if guard not in _GUARDS:
            raise ValueError("guard must be one of {}, got {!r}".format(_GUARDS, guard))
        self.algorithm_spatial = algorithm_spatial
        self.reference_id = reference_id
        self.apply_projection_back = apply_projection_back
        self.threshold = threshold
        self.guard = guard
        self.iss_compat = iss_compat

    # the contrast
    def source_weights_from_power_sums(self, psum, n_bins):
        """Per-(source, frame) auxiliary variance from ``psum = sum_f |Y|^2``."""
        raise NotImplementedError

    def contrast_nll(self, psum, n_bins):
        """The NLL's contrast term from ``psum``."""
        raise NotImplementedError

    def source_weights(self, Y):
        return self.source_weights_from_power_sums(self._bins_sum(torch.sum(torch.abs(Y) ** 2, dim=1)), self._n_bins(Y))

    # the state
    def _component_mode(self, n_channels):
        return self.algorithm_spatial in _IP_UPDATES and uses_component_sweep(self.guard, n_channels)

    def _fused(self, n_channels):
        """Whether an iteration is one call of kernel K2 (with ``contrast``):
        never in frames mode, whose covariance sums over frames inside K2."""
        frames = self._sharded and self._shard_mode == "frames"
        return self._component_mode(n_channels) and n_channels == 2 and self.guard == "one_norm" and not frames

    def init_state(self, X, demix_filter=None, estimation=None, step_count=None):
        if self.algorithm_spatial == "IPA":
            raise ValueError("Not support {} based spatial updates.".format(self.algorithm_spatial))
        W = self._initial_filter(X, demix_filter)
        n_channels = X.shape[0]
        if self.algorithm_spatial == "ISS":
            # ISS carries no W (``bss/iva.py:356-360``): a passed
            # ``estimation`` is the state, else the estimates of W
            Y = self.separate(X, W) if estimation is None else torch.as_tensor(estimation).to(X)
            return {"input": X, "estimation": Y}
        if self._component_mode(n_channels):
            Wc = W.permute(1, 2, 0).contiguous()  # (N, C, F)
            Y = separate_components(_rows(Wc), X)
            state = {"input": X, "demix_components": Wc, "psum": self._bins_sum(torch.sum(torch.abs(Y) ** 2, dim=1))}
            if not self._fused(n_channels):
                state["pair_products"] = pair_products_planes(X)
            return state
        # the estimates are re-derived from W, as the reference does at reset
        state = {"input": X, "demix_filter": W, "estimation": self.separate(X, W)}
        if self.algorithm_spatial in _PAIRWISE_UPDATES:
            k = 0 if step_count is None else step_count
            state["step_count"] = torch.as_tensor(k, dtype=torch.int64, device=X.device).reshape(())
        return state

    def capturable(self, X):
        """Every spatial update but under the ``svd`` guard, whose
        ``torch.linalg.svdvals`` copies to the host inside the step (ISS
        takes no guard).  The overdetermined solver follows the same rule on
        its reduced mixture (PCA and projection-back run outside the loop)."""
        return self.algorithm_spatial == "ISS" or self.guard != "svd"

    def capturable_edges(self, X):
        """The component state: its init (the identity filter and the
        estimates' power sums), initial loss and finalize (the estimates
        and projection-back) read nothing on the host.  The overdetermined
        solver's finalize is the estimates alone (its PCA and outer
        projection-back stay outside the call)."""
        return self._component_mode(X.shape[0]) and self.capturable(X)

    # the updates
    def update_state(self, state):
        if self.algorithm_spatial in _IP_UPDATES:
            return self._update_ip(state)
        if self.algorithm_spatial == "ISS":
            return self._update_iss(state)
        return self._update_pairwise(state)

    def _update_ip(self, state):
        X = state["input"]
        if "demix_components" not in state:
            R = floor_below(self.source_weights(state["estimation"]), self.eps)
            W = self._ip_sweep(state, 1.0 / R)
            return dict(state, demix_filter=W, estimation=self.separate(X, W))
        if self._fused(X.shape[0]):
            n_bins = self._n_bins(X)
            Wc, psum, logdet, nll = fused_auxiva_ip_iter(
                X, state["demix_components"], state["psum"], eps=self.eps, threshold=self.threshold,
                contrast=self.contrast, n_bins=n_bins,
            )
            if self._sharded:
                # the shard's psum and logdet, made whole by one all-reduce;
                # the NLL by the kernel's formula from them
                whole = self._bins_sum(torch.cat([psum.reshape(-1), logdet.reshape(1)]))
                psum, logdet = whole[:-1].reshape(psum.shape), whole[-1]
                nll = self.contrast_nll(psum, n_bins) - 2 * self._n_frames(X) * logdet
            return {"input": X, "demix_components": Wc, "psum": psum, "nll_value": nll}
        rows = _rows(state["demix_components"])
        R = floor_below(self.source_weights_from_power_sums(state["psum"], self._n_bins(X)), self.eps)
        U = self._frames_mean(weighted_covariance_auto(X, 1.0 / R))  # (N, F, C, C)
        C = X.shape[0]
        U = [[[U[n, :, c, d] for d in range(C)] for c in range(C)] for n in range(U.shape[0])]
        rows = ip_update_components(rows, U, threshold=self.threshold, guard=self.guard)
        return {
            "input": X,
            "demix_components": _stack_rows(rows),
            "psum": frame_power_sums(rows, state["pair_products"], bins_sum=self._bins_sum if self._sharded else None),
            "pair_products": state["pair_products"],
        }

    def _update_iss(self, state):
        Y = state["estimation"]
        R = floor_below(self.source_weights(Y), self.eps)
        return {"input": state["input"], "estimation": self._iss_sweep(Y, 1.0 / R)}

    def _update_pairwise(self, state):
        X, W, Y = state["input"], state["demix_filter"], state["estimation"]
        n_sources, n_channels = Y.shape[0], W.shape[-1]
        k = state["step_count"]
        m, n = k % n_sources, (k + 1) % n_sources
        R_mn = floor_below(self.source_weights(Y.index_select(0, torch.stack([m, n]))), self.eps)
        U_mn = self._frames_mean(weighted_covariance_auto(X, 1.0 / R_mn))  # (2, F, C, C): K1
        if self.guard in ("one_norm", "none") and n_sources == n_channels <= 3:
            W = ip2_pair_update_planes(
                W, U_mn.permute(0, 2, 3, 1), m, n, threshold=self.threshold, guard=self.guard
            )
        else:
            W = _pair_update_matrix(W, U_mn, m, n, self.threshold, self.guard)
        return dict(state, demix_filter=W, estimation=self.separate(X, W), step_count=k + 1)

    # the loss and the output
    def _log_abs_det(self, state):
        """``log|det W_f| (F,)``.  ISS solves its least-squares ``W`` in
        float64: the NLL scales these log-determinants by ``2 T``, so a
        float32 solve's rounding would show in the loss (about 1e-4 of it
        near ``W = I``)."""
        if "demix_components" in state:
            Wc = state["demix_components"]
            return log_abs_det_components(_rows(Wc), Wc.shape[0])
        if "demix_filter" in state:
            return batched_log_abs_det(state["demix_filter"])
        X = state["input"]
        frames_sum = self._frames_sum if self._sharded else None
        W = self.compute_demix_filter(state["estimation"], X, solve_dtype=torch.complex128, frames_sum=frames_sum)
        return batched_log_abs_det(W).to(X.real.dtype)

    def nll(self, state):
        """``contrast(psum) - 2 T sum_f log|det W_f|`` (K2 returns it)."""
        if "nll_value" in state:
            return state["nll_value"]
        X = state["input"]
        if "psum" in state:
            psum = state["psum"]
        else:
            psum = self._bins_sum(torch.sum(torch.abs(state["estimation"]) ** 2, dim=1))
        contrast = self._frames_sum(self.contrast_nll(psum, self._n_bins(X)))
        return contrast - 2 * self._n_frames(X) * self._bins_sum(self._log_abs_det(state).sum())

    def _estimates(self, state):
        if "demix_components" in state:
            return separate_components(_rows(state["demix_components"]), state["input"])
        return state["estimation"]

    def finalize(self, state):
        Y = self._estimates(state)
        if self.apply_projection_back:
            Y = Y * self._projection_back(Y, state["input"][self.reference_id])[..., None]
        return Y

    def _sync_attributes(self, state):
        super()._sync_attributes(state)
        if "demix_components" in state:
            # the public attribute keeps the reference layout (F, N, C)
            self.demix_filter = state["demix_components"].permute(2, 0, 1)
            if self.callbacks is not None:
                self.estimation = separate_components(_rows(state["demix_components"]), state["input"])
        elif self.algorithm_spatial == "ISS":
            # the reference fits W for the callbacks only (``bss/iva.py:407-418``)
            fit = self.callbacks is not None
            self.demix_filter = self.compute_demix_filter(state["estimation"], state["input"]) if fit else None

    def __repr__(self):
        return "AuxIVA(algorithm_spatial={})".format(self.algorithm_spatial)


class AuxLaplaceIVA(AuxIVABase):
    """AuxIVA with the Laplace (spherical l2) contrast, ``R = sqrt(psum)``
    (``bss/iva.py:388-619``)."""

    contrast = "laplace"

    def source_weights_from_power_sums(self, psum, n_bins):
        return torch.sqrt(psum)

    def contrast_nll(self, psum, n_bins):
        return 2 * torch.sqrt(psum).sum()

    def supports_bin_padding(self):
        """Zero bins are neutral for the IP and IP2 paths: they add nothing
        to the frame weights' sums over bins, their covariances are zero so
        the guard keeps their identity rows, and ``log|det I| = 0`` leaves
        the NLL exact.  ISS has no guard (its least-squares filter is 0/0
        on an empty bin)."""
        return self.algorithm_spatial in ("IP", "IP1", "IP2", "pairwise")

    def __repr__(self):
        return "AuxLaplaceIVA(algorithm_spatial={})".format(self.algorithm_spatial)


class AuxGaussIVA(AuxIVABase):
    """AuxIVA with the time-varying Gaussian contrast, ``R = psum / F``
    (``bss/iva.py:621-802``); IP2 raises like the reference
    (``iva.py:777-781``)."""

    contrast = "gauss"

    def source_weights_from_power_sums(self, psum, n_bins):
        return psum / n_bins

    def contrast_nll(self, psum, n_bins):
        return n_bins * torch.log(floor_below(psum / n_bins, self.eps)).sum()

    def capturable(self, X):
        return self.algorithm_spatial not in _PAIRWISE_UPDATES and super().capturable(X)

    def _update_pairwise(self, state):
        raise NotImplementedError("In progress...")

    def __repr__(self):
        return "AuxGaussIVA(algorithm_spatial={})".format(self.algorithm_spatial)


class SparseAuxIVA(AuxIVABase):
    """Stub, as in the reference (``bss/iva.py:804-815``)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        raise NotImplementedError("in progress")


class OverAuxIVABase(AuxIVABase):
    """Overdetermined AuxIVA base (``bss/iva.py:817-821``): the solver runs
    on the reduced mixture and returns its estimates unscaled, since
    projection-back refers to the unreduced mixture."""

    def __init__(self, algorithm_spatial, n_sources=None, **kwargs):
        super().__init__(algorithm_spatial=algorithm_spatial, **kwargs)
        self.n_sources = n_sources

    def finalize(self, state):
        return self._estimates(state)


class OverAuxLaplaceIVA(OverAuxIVABase, AuxLaplaceIVA):
    """Overdetermined Laplace AuxIVA by per-bin PCA.

    The reference's class (``bss/iva.py:823-829``) has no update rules; its
    working overdetermined path is PCA -> AuxIVA -> projection-back onto the
    unreduced mixture (``bss/iva.py:1092-1102``), which this class runs.
    """

    def __call__(self, input, iteration=100, **kwargs):
        X = self._to_input(input)
        n_sources = self.n_sources or X.shape[0]
        reduced = pca(X, n_sources=n_sources).contiguous() if n_sources < X.shape[0] else X
        Y = super().__call__(reduced, iteration=iteration, **kwargs)
        if self.apply_projection_back:
            Y = Y * projection_back(Y, reference=X[self.reference_id])[..., None]
            self.estimation = Y
        return Y
