"""Positive-semidefinite tensor factorisation (LD-PSDTF; reference
``src/algorithm/psdtf.py:12-176``).

Log-det PSDTF of a full covariance tensor ``target (n_bins, n_bins,
n_frames)``: ``X_t ~ sum_k H[k, t] V_k`` with PSD basis matrices ``V_k``.
The MM updates take the basis through the Cholesky and matrix-square-root
chain (``psdtf.py:120-154``) and the activation by the trace ratio
(``psdtf.py:156-176``); ``algorithm="em"`` raises, as in the reference.

``V, H = model(target, iteration=N)`` with ``V (n_bins, n_bins, n_basis)``
and ``H (n_basis, n_frames)``.  A real target stays real.

As in the JAX package:

* at ``n_basis == 2`` the model ``Y_t = H_1t V_1 + H_2t V_2`` is a matrix
  pencil, and one generalised eigendecomposition ``G^H V_1 G = I, G^H V_2 G =
  diag(d)`` per iteration diagonalises every frame (``w_t = H_1t + H_2t d``);
  the ``to_psd`` ridges on ``Y`` and ``Y^-1`` become the per-frame floor ``w
  >= eps sum(w)`` in the pencil frame, and trace normalisation rescales the
  pencil exactly;
* at ``n_basis > 2`` one Hermitian ``eigh`` of ``to_psd(Y)`` gives its
  inverse and log-determinant, and it is carried in the state
  (``y_eigvals``, ``y_eigvecs``) from one iteration's loss to the next
  one's basis step;
* products of PSD factors take the ``eps trace`` ridge in place of the full
  ``to_psd`` (their eigenvalue shift is 0 up to rounding);
* each frame is scaled to unit mean trace (``frame_scale``), under which the
  updates and the divergence are invariant; :meth:`PSDTFBase.finalize` and
  the published ``activation`` undo it;
* the ridges take at least 100 machine epsilons of the type
  (:func:`_dtype_eps`), a no-op at float64.

Under a mesh the frames mode shards every per-frame field (the JAX
package's ``field_axes``): the basis step's sums over frames and the NLL
are all-reduced, in one all-reduce each, and the ``B x B`` pencil,
Cholesky and ``eigh`` run replicated.  The bins mode does not apply (the
tap axes are coupled): every field replicates and the call is the
unsharded one.
"""

import numpy as np
import torch

from ..criterion.divergence import logdet_divergence
from ..ops.eigh_kernel import batched_eigh
from ..ops.fast_linalg import batched_eigvalsh
from ..runtime.device import resolve_device
from ..runtime.solver import IterativeSolver, state_tensor
from ..utils.flooring import EPS
from ..utils.linalg import to_psd


def _sym(X):
    return (X + X.transpose(-2, -1).conj()) / 2


def _dtype_eps(eps, dtype):
    """The ridge at this type: the reference's 1e-12 is below float32's
    rounding, so at least 100 machine epsilons."""
    return max(eps, 100 * torch.finfo(dtype).eps)


def _trace(X):
    return torch.diagonal(X, dim1=-2, dim2=-1).sum(dim=-1).real


def _eye(X):
    return torch.eye(X.shape[-1], dtype=X.dtype, device=X.device)


def _ridge(X, eps):
    """``to_psd`` of a matrix PSD by construction: the Hermitian part plus the
    ``eps trace`` ridge."""
    X = _sym(X)
    return X + (_dtype_eps(eps, X.dtype) * _trace(X))[..., None, None] * _eye(X)


def _eigh_psd(Y, eps):
    """``(w, v)``: the eigenvalues of ``to_psd(Y)`` (shifted by the most
    negative one, ridged) and the eigenvectors of ``Y``'s Hermitian part, by
    K3 (the loss's ``v^H X v`` and the inverse's ``v f(w) v^H`` take no
    phase of them)."""
    Ys = _sym(Y)
    w, v = batched_eigh(Ys)
    delta = torch.clamp(w.amin(dim=-1), max=0)
    return w + (_dtype_eps(eps, Y.dtype) * _trace(Ys) - delta)[..., None], v


def _inv_from_eigh(w, v, eps):
    """``to_psd(inv(to_psd(Y)))`` from :func:`_eigh_psd`'s decomposition: the
    inverse's eigenvalues ``1/w`` plus the ``eps sum(1/w)`` ridge."""
    wi = 1 / w
    wi = wi + _dtype_eps(eps, w.dtype) * wi.sum(dim=-1, keepdim=True)
    return _sym((v * wi[..., None, :].to(v.dtype)) @ v.transpose(-2, -1).conj())


def _cholesky(A):
    """Lower Cholesky factor, without the host check on CUDA (a matrix not
    positive definite gives non-finite entries, as in the JAX package)."""
    return torch.linalg.cholesky_ex(A).L


class PSDTFBase(IterativeSolver):
    state_fields = ("basis", "activation")
    record_initial_loss = False

    def __init__(self, n_basis=2, normalize=True, eps=EPS, device=None):
        super().__init__(callbacks=None, recordable_loss=True, eps=eps, device=device)
        self.n_basis = n_basis
        self.normalize = normalize

    def field_axes(self):
        """The JAX package's shardable axes: frames only."""
        return {
            "input": {"frames": -1},  # target (B, B, T)
            "target_t": {"frames": 0},
            "target_logdet": {"frames": 0},
            "frame_scale": {"frames": 0},
            "activation": {"frames": -1},  # (K, T)
            "y_eigvals": {"frames": 0},  # (T, B)
            "y_eigvecs": {"frames": 0},  # (T, B, B)
        }

    def output_axes(self):
        return {}, {"frames": -1}

    def input_dtype(self, X):
        """A real target runs real, a complex one complex: float32 or
        complex64 on CUDA, the target's own precision on the CPU."""
        cuda = torch.complex64 if X.is_complex() else torch.float32
        return cuda if self.device.type == "cuda" else torch.promote_types(X.dtype, torch.float32)

    def prepare_state_kwargs(self, target, state_kwargs):
        n_bins = target.shape[0]
        if "basis" not in state_kwargs:
            # diagonal PSD init from uniform draws (``psdtf.py:46-52``)
            V = np.random.rand(self.n_basis, n_bins)
            V = V[:, :, None] * np.tile(np.eye(n_bins), (self.n_basis, 1, 1))
            state_kwargs["basis"] = V.transpose(1, 2, 0)
        if "activation" not in state_kwargs:
            state_kwargs["activation"] = np.random.rand(self.n_basis, target.shape[-1])
        return state_kwargs

    @staticmethod
    def _normalize(V, H):
        trace = torch.diagonal(V, dim1=0, dim2=1).sum(dim=-1).real  # (K,)
        return V / trace, H * trace[:, None]

    def _model_eigh(self, basis, activation):
        """:func:`_eigh_psd` of the model covariance ``sum_k H_k V_k``."""
        Y = torch.einsum("ijk,kt->tij", basis, activation.to(basis.dtype))
        return _eigh_psd(Y, self.eps)

    def _model_carry(self, basis, activation):
        """The carried decomposition of the model covariance (the pencil path
        carries the basis pencil instead)."""
        y_w, y_v = self._model_eigh(basis, activation)
        return {"y_eigvals": y_w, "y_eigvecs": y_v}

    def init_state(self, target, basis=None, activation=None):
        basis = torch.as_tensor(basis).to(device=target.device, dtype=target.dtype)
        activation = state_tensor(activation, target)
        if self.normalize:
            basis, activation = self._normalize(basis, activation)
        Xt = target.permute(2, 0, 1)
        # per-frame trace equilibration; the MM updates and the divergence are
        # invariant under (X_t, H_t) -> (X_t / s_t, H_t / s_t)
        n = Xt.shape[-1]
        s = _trace(Xt) / n
        s = torch.clamp(s, min=torch.finfo(s.dtype).tiny)
        Xt = Xt / s[:, None, None].to(Xt.dtype)
        activation = activation / s[None, :]
        # the target's per-frame log-determinant, floored like the loss
        eig_x = torch.clamp(batched_eigvalsh(_sym(Xt)).real, min=_dtype_eps(self.eps, Xt.dtype))
        state = {
            "target_t": Xt,
            "target_logdet": torch.log(eig_x).sum(dim=-1),
            "frame_scale": s,
            "basis": basis,
            "activation": activation,
        }
        state.update(self._model_carry(basis, activation))
        return state

    def reconstruct(self, state):
        """The model covariance ``(T, B, B)`` in the target's frame, projected."""
        V, H = state["basis"], state["activation"]
        if "frame_scale" in state:
            H = H * state["frame_scale"][None, :]
        return to_psd(torch.einsum("ijk,kt->tij", V, H.to(V.dtype)), eps=self.eps)

    def nll(self, state):
        """The log-det divergence to the target (``psdtf.py:78-85``) from the
        carried decomposition: ``tr(X Y^-1)`` as a quadratic form in its
        eigenbasis, ``log det Y`` from its eigenvalues."""
        w, v = state["y_eigvals"], state["y_eigvecs"]
        X = state["target_t"]
        n = X.shape[-1]
        quad = torch.einsum("tbi,tbi->ti", v.conj(), X.to(v.dtype) @ v).real
        trace = torch.sum(quad / w, dim=-1)
        logdet_y = torch.log(torch.clamp(w, min=_dtype_eps(self.eps, w.dtype))).sum(dim=-1)
        return self._frames_sum(torch.sum(trace - state["target_logdet"] + logdet_y - n))

    def finalize(self, state):
        return state["basis"], state["activation"] * state["frame_scale"][None, :]

    def _sync_attributes(self, state):
        # the activation is published in the target's frame: init_state
        # equilibrates warm-start kwargs again, so they must round-trip
        super()._sync_attributes(state)
        if "frame_scale" in state:
            self.activation = state["activation"] * state["frame_scale"][None, :]


class LDPSDTF(PSDTFBase):
    """Log-det PSDTF with MM updates (``psdtf.py:88-176``); the K = 2 pencil
    route at ``n_basis == 2``, the carried ``eigh`` otherwise."""

    def __init__(self, n_basis=2, algorithm="mm", normalize=True, eps=EPS, device=None):
        super().__init__(n_basis=n_basis, normalize=normalize, eps=eps, device=device)
        if algorithm == "em":
            raise NotImplementedError
        if algorithm != "mm":
            raise ValueError("Not support {} based update.".format(algorithm))
        self.algorithm = algorithm
        self.criterion = logdet_divergence

    def capturable(self, X):
        """Both routes (the K = 2 pencil, the carried eigendecomposition)
        at any shape: the ``B x B`` eigensolves run on K3."""
        return True

    # the K = 2 pencil
    @property
    def _use_pencil(self):
        return self.n_basis == 2

    def _pencil(self, basis):
        """``(G, d, log det V_1)`` with ``G^H V_1 G = I`` and ``G^H V_2 G =
        diag(d)``: whiten by V_1's Cholesky factor, then K3's ``eigh``.  The
        columns of ``G`` keep K3's phases, which nothing downstream sees
        (``G diag(1/w) G^H``, ``diag(G^H X G)``)."""
        V = basis.permute(2, 0, 1)
        A1, A2 = _sym(V[0]), _sym(V[1])
        L = _cholesky(A1)
        Z = torch.linalg.solve_triangular(L, A2, upper=False)  # L^-1 A2
        M = torch.linalg.solve_triangular(L, Z.transpose(-2, -1).conj(), upper=False)
        d, Q = batched_eigh(_sym(M))
        d = torch.clamp(d, min=0)  # A2 is PSD up to rounding
        G = torch.linalg.solve_triangular(L.transpose(-2, -1).conj(), Q, upper=True)  # L^-H Q
        return G, d, 2 * torch.log(torch.diagonal(L).real).sum()

    def _pencil_w(self, activation, d):
        """Per-frame pencil eigenvalues ``w_t = H_1t + H_2t d``, floored at
        ``eps sum(w_t)`` in place of the reference's ``to_psd`` ridge."""
        w = activation[0][:, None] + activation[1][:, None] * d[None, :]
        floor = torch.clamp(_dtype_eps(self.eps, w.dtype) * w.sum(dim=-1, keepdim=True), min=torch.finfo(w.dtype).tiny)
        return torch.maximum(w, floor)

    @staticmethod
    def _pencil_inv(G, w):
        """``Y_t^-1 = G diag(1 / w_t) G^H``, ``(T, B, B)``."""
        Gw = G[None, :, :] * (1 / w)[:, None, :].to(G.dtype)
        return _sym(Gw @ G.conj().T)

    def _basis_step(self, V, H, inv_Y, X):
        """The basis MM (``psdtf.py:120-154``) from the model's inverse:
        ``V L (L^H V P V L)^-1/2 L^H V`` with ``L`` the Cholesky factor of
        ``Q = sum_t H Y^-1 X Y^-1``, ``P = sum_t H Y^-1``."""
        eps = self.eps
        Hc = H.to(V.dtype)
        YXY = _ridge(inv_Y @ X.to(inv_Y.dtype) @ inv_Y, eps)
        P, Q = self._shard_sums(
            [torch.einsum("kt,tij->kij", Hc, inv_Y), torch.einsum("kt,tij->kij", Hc, YXY)], "frames"
        )
        P, Q = _ridge(P, eps), _ridge(Q, eps)
        L = _cholesky(Q)
        Lh = L.transpose(-2, -1).conj()
        w, u = batched_eigh(_ridge(Lh @ V @ P @ V @ L, eps))
        # the square root is PSD by construction: its to_psd is the eps sum(w)
        # ridge in the basis u (``psdtf.py:146-149``)
        w = torch.sqrt(torch.clamp(w, min=0))
        w = w + _dtype_eps(eps, w.dtype) * w.sum(dim=-1, keepdim=True)
        inv_sqrt = (u * (1 / w)[..., None, :].to(u.dtype)) @ u.transpose(-2, -1).conj()
        return _ridge(V @ L @ inv_sqrt @ Lh @ V, eps)

    def _update_state_pencil(self, state):
        eps = self.eps
        X = state["target_t"]  # (T, B, B)
        V = state["basis"].permute(2, 0, 1)  # (K, B, B)
        H = state["activation"]
        G, d = state["pencil_G"], state["pencil_d"]
        V = self._basis_step(V, H, self._pencil_inv(G, self._pencil_w(H, d)), X)
        basis = V.permute(1, 2, 0)

        # activation, diagonal in the new basis' pencil frame: with G^H V_1 G
        # = I and G^H V_2 G = D, tr(Y^-1 V_k Y^-1 X_t) needs only diag(G^H X_t
        # G), and tr(Y^-1 V_k) only sum 1/w and sum d/w
        G2, d2, ld2 = self._pencil(basis)
        w2 = self._pencil_w(H, d2)  # (T, B)
        xdiag = torch.einsum("bi,tbi->ti", G2.conj(), X.to(G2.dtype) @ G2).real
        r = (xdiag / w2) / w2  # two divisions: w^2 can underflow float32
        num = torch.clamp(torch.stack([r.sum(dim=-1), (r * d2).sum(dim=-1)]), min=0)
        den = torch.clamp(torch.stack([(1 / w2).sum(dim=-1), (d2 / w2).sum(dim=-1)]), min=eps)
        H = H * torch.sqrt(num / den)

        if self.normalize:
            # V_1 / c_1, V_2 / c_2 gives the pencil G sqrt(c_1), d c_1 / c_2
            # and log det - B log c_1 exactly
            c = _trace(V)  # (K,)
            basis = (V / c[:, None, None]).permute(1, 2, 0)
            H = H * c[:, None]
            G2, d2, ld2 = G2 * torch.sqrt(c[0]).to(G2.dtype), d2 * (c[0] / c[1]), ld2 - V.shape[-1] * torch.log(c[0])
        return dict(state, basis=basis, activation=H, pencil_G=G2, pencil_d=d2, pencil_logdet=ld2)

    def _model_carry(self, basis, activation):
        if not self._use_pencil:
            return super()._model_carry(basis, activation)
        G, d, ld = self._pencil(basis)
        return {"pencil_G": G, "pencil_d": d, "pencil_logdet": ld}

    def nll(self, state):
        if not self._use_pencil:
            return super().nll(state)
        X = state["target_t"]
        G = state["pencil_G"]
        w = self._pencil_w(state["activation"], state["pencil_d"])  # (T, B)
        # tr(X_t Y_t^-1) = sum_i (G^H X_t G)_ii / w_ti; log det Y_t = sum log w + log det V_1
        quad = torch.einsum("bi,tbi->ti", G.conj(), X.to(G.dtype) @ G).real
        logdet_y = torch.log(w).sum(dim=-1) + state["pencil_logdet"]
        return self._frames_sum(torch.sum((quad / w).sum(dim=-1) - state["target_logdet"] + logdet_y - X.shape[-1]))

    def update_state(self, state):
        if self._use_pencil:
            return self._update_state_pencil(state)
        eps = self.eps
        X = state["target_t"]
        H = state["activation"]
        # the decomposition of Y(V, H) made for the last loss
        inv_Y = _inv_from_eigh(state["y_eigvals"], state["y_eigvecs"], eps)
        V = self._basis_step(state["basis"].permute(2, 0, 1), H, inv_Y, X)

        # activation by the trace ratio (``psdtf.py:156-176``):
        # tr(Y^-1 V_k Y^-1 X_t) = sum_ij V_k[i, j] (Y^-1 X Y^-1)_t[j, i]
        inv_Y = _inv_from_eigh(*self._model_eigh(V.permute(1, 2, 0), H), eps)
        M = inv_Y @ X.to(inv_Y.dtype) @ inv_Y
        num = torch.clamp(torch.einsum("kij,tji->kt", V, M).real, min=0)
        den = torch.clamp(torch.einsum("kij,tji->kt", V, inv_Y).real, min=eps)
        H = H * torch.sqrt(num / den)

        basis = V.permute(1, 2, 0)
        if self.normalize:
            basis, H = self._normalize(basis, H)
        # one decomposition of the new model serves the next loss and the
        # next basis step (trace normalisation leaves Y as it is)
        y_w, y_v = self._model_eigh(basis, H)
        return dict(state, basis=basis, activation=H, y_eigvals=y_w, y_eigvecs=y_v)


def nonparallel_inv(X, use_cholesky=True, device=None):
    """Per-slice inverse in a loop (``psdtf.py:182-207``), to cross-check
    single slices; the solvers use batched inverses.

    ``X (..., n, n)``: a tensor stays on its device; anything else goes to
    ``device``, the CUDA card unless the caller passes ``device="cpu"``.
    Returns a tensor of ``X``'s shape and type on that device.
    """
    X = X if isinstance(X, torch.Tensor) else torch.as_tensor(np.asarray(X), device=resolve_device(device))
    n = X.shape[-1]
    flat = X.reshape(-1, n, n)
    eye = torch.eye(n, dtype=X.dtype, device=X.device)
    slices = []
    for A in flat:
        if use_cholesky:
            L_inv = torch.linalg.solve_triangular(torch.linalg.cholesky(A), eye, upper=False)
            slices.append(L_inv.mH @ L_inv)
        else:
            slices.append(torch.linalg.inv(A))
    return torch.stack(slices).reshape(X.shape)
