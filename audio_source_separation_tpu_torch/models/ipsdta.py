"""Independent positive semidefinite tensor analysis (reference ``src/bss/ipsdta.py``).

  * ``GaussIPSDTA``: a block-diagonal frequency-covariance source model.  The
    bins are cut into ``n_blocks`` blocks (:class:`~..ops.blocks.BlockLayout`,
    every block padded to ``block_size`` B), and the basis holds one PSD
    ``B x B`` matrix per (source, block, basis).  Two author modes:
    **Kondo** (the default) runs the MM source update with its
    matrix-square-root chain and the VCD spatial update (vector-wise
    coordinate descent, ``spatial_iteration`` sweeps); **Ikeshita** runs the
    EM source update and the fixed-point spatial update with its auxiliary
    ``fixed_point``.  Trace normalisation, and the NLL with block
    log-determinants.
  * ``TIPSDTA`` (alias ``tIPSDTA``): the Student-t model, Kondo only, with
    the posterior weight ``pi = (nu + 2 F) / (nu + 2 y^H R^-1 y)`` in the
    source statistics and in the VCD covariance.

Routes, as in the JAX package, chosen by three switches on the solver: at
``B <= 3`` with ``source_planes`` (the default) the source steps, the
fixed-point statistic and the Gauss NLL run on compact Hermitian planes
(``B^2`` real planes, batched over sources; ``source_compact``, the
default), or with ``source_compact=False`` on complex ``(B, B)`` entry
planes per source; with ``source_pencil`` and ``n_basis == 2`` the MM source
step runs the K = 2 pencil streams instead (Ikeshita's EM ignores the
switch).  Above ``B = 3``, or with ``source_planes=False``, the source steps
run on ``(S, T, n_blocks, B, B)`` matrices.  The VCD runs on planes at ``B
<= 3`` and ``C <= 3`` with as many sources as channels (its inverses
compact or complex as ``source_compact`` says), else on matrices.

Under a mesh, bins shards hold whole blocks (the partition must be uniform
and its blocks divide by the mesh dimension): the block statistics stay
shard-local and the activation updates' and the trace normalisation's sums
over blocks are all-reduced.  In frames mode the activations shard along
frames and every ``sum_t`` statistic (the MM and EM basis statistics, the
VCD covariances and couplings, the fixed-point ``G``) is all-reduced.  The
NLL's sums are all-reduced in either mode.

The Gauss VCD's spatial covariances ``Q[n, f] = (1/T) sum_t d[n, f, t] x
x^H``, ``d`` the real diagonal of the projected ``R_n^-1`` at bin f's slot,
are the same for every sweep; they come from one call of kernel K1
(:func:`~..ops.cov_kernel.weighted_covariance_planes`) with per-bin ``(S,
F, T)`` weights per iteration, on both VCD routes.  TIPSDTA's VCD
covariance changes inside each sweep and Ikeshita's fixed-point statistic
couples the bins of a block, so both stay batched PyTorch products.
"""

import math

import numpy as np
import torch

from ..ops.blocks import BlockLayout
from ..ops.cov_kernel import weighted_covariance_planes
from ..ops.eigh_kernel import batched_eigh
from ..ops.fast_linalg import (
    _sum,
    add_diag_hermitian_compact,
    add_diag_planes,
    batched_eigvalsh,
    batched_inv,
    batched_log_abs_det,
    compact_entry,
    expand_hermitian_compact_trailing,
    hermitian_compact_from_entries,
    inv_hermitian_compact,
    inv_planes,
    matmul_planes,
    matmul_small,
    psd_inv_hermitian_compact,
    psd_inv_planes,
    psd_parts_hermitian_compact,
    psd_parts_planes,
    square_hermitian_compact,
    trace_hermitian_compact,
)
from ..ops.ip_components import assemble_matrices, det_components, solve_column_components
from ..runtime.solver import state_tensor
from ..utils.flooring import EPS, floor_below
from .iva import IVABase

KWARGS_IKESHITA = {"n_blocks": 1024, "spatial_iteration": 1}
KWARGS_KONDO = {"n_blocks": 1024, "spatial_iteration": 10}


# The PSD chain.  The reference guards every block matrix with to_psd (the
# Hermitian part shifted by its most negative eigenvalue, plus an eps trace
# ridge) and then inverts or square-roots the same matrix; the shift is a
# multiple of the identity, so one eigendecomposition serves the chain.
def _herm(M):
    return (M + M.transpose(-2, -1).conj()) / 2


def _eye(M):
    return torch.eye(M.shape[-1], dtype=M.dtype, device=M.device)


def _trace(M):
    return torch.diagonal(M, dim1=-2, dim2=-1).sum(dim=-1).real


def _spectral(v, w):
    """``v diag(w) v^H`` for real ``w``."""
    return (v * w[..., None, :].to(v.dtype)) @ v.transpose(-2, -1).conj()


def _psd_parts(M, eps=EPS):
    """``(to_psd(M), its eigenvalues)``, the eigenvalues by the closed forms
    at ``B <= 3``, else by K3 (:func:`~..ops.fast_linalg.batched_eigvalsh`)."""
    H = _herm(M)
    w = batched_eigvalsh(H)
    shift = eps * _trace(H) - torch.clamp(w.amin(dim=-1), max=0)
    return H + shift[..., None, None] * _eye(M), w + shift[..., None]


def _psd_inv(R, eps=EPS, psd=True):
    """The adjugate inverse of a projected (so invertible) block matrix at
    ``B <= 3``; with ``psd``, the reference's trailing ``to_psd`` of the
    inverse, which is the ``eps trace`` ridge for a PSD input."""
    inv = batched_inv(R)
    if psd:
        inv = _herm(inv)
        inv = inv + (eps * _trace(inv))[..., None, None] * _eye(inv)
    return inv


def _to_psd(M, eps=EPS):
    """The reference's ``to_psd`` on trailing ``(..., n, n)`` matrices."""
    return _psd_parts(M, eps=eps)[0]


def _to_psd_planes(P, eps=EPS):
    return psd_parts_planes(P, eps=eps)[0]


def _psd_ridge(S, eps=EPS):
    """``to_psd`` of a PSD matrix: the Hermitian part plus the ``eps trace``
    ridge (the eigenvalue shift is 0)."""
    S = _herm(S)
    return S + (eps * _trace(S))[..., None, None] * _eye(S)


def _psd_sqrt_fused(M, eps=EPS):
    """``to_psd(sqrt(to_psd(M)))`` from one Hermitian eigendecomposition."""
    H = _herm(M)
    w, v = batched_eigh(H)
    shift = eps * _trace(H) - torch.clamp(w.amin(dim=-1), max=0)
    sw = torch.sqrt(torch.clamp(w + shift[..., None], min=0))
    return _psd_ridge(_spectral(v, sw), eps=eps)


def _sqrt_and_invsqrt_after_psd(C, pad_diag, eps=EPS):
    """The reference's square-root chain tail (``ipsdta.py:585-621``) from one
    eigendecomposition: for ``C`` with zero padded rows and columns,
    ``E = pad_identity(to_psd(C))``, ``sqrt_E = to_psd(E^1/2)`` and
    ``inv_sqrt_E = to_psd(sqrt_E^-1)``; returns ``(sqrt_E, inv_sqrt_E)``.
    The decomposition is of ``herm(C) + pad_diag``; the padded slots add
    eigenvalue 1 and ``n_pad`` to the trace, which the shift takes back out."""
    H = _herm(C)
    n_pad = _trace(pad_diag)
    Hp = H + pad_diag
    w, v = batched_eigh(Hp)
    shift = eps * (_trace(Hp) - n_pad) - torch.clamp(w.amin(dim=-1), max=0)
    sw = torch.sqrt(torch.clamp(w + shift[..., None], min=0))
    eye = _eye(C)
    ridge1 = eps * sw.sum(dim=-1)
    sqrt_E = _herm(_spectral(v, sw)) + ridge1[..., None, None] * eye
    iw = 1.0 / (sw + ridge1[..., None])
    inv_sqrt_E = _herm(_spectral(v, iw)) + (eps * iw.sum(dim=-1))[..., None, None] * eye
    return sqrt_E, inv_sqrt_E


def _vcd_row_update(WP, Xw, QP_j, Qinv_j, gamma, n, j, valid_j, XP_j, eps):
    """The VCD root formula (``ipsdta.py:942-973``) for row ``(n, j)`` on
    planes; writes the new row into ``WP (B, N, C, nb)`` and its projections
    into ``Xw (B, T, nb)``, both in place."""
    C = WP.shape[2]
    WQ = [[_sum(WP[j, m, c] * QP_j[c, d] for c in range(C)) for d in range(C)] for m in range(WP.shape[1])]
    zeta = solve_column_components(WQ, C, n, det=det_components(WQ, C))
    zeta_hat = [_sum(Qinv_j[c, d] * gamma[d] for d in range(C)) for c in range(C)]
    Qz = [_sum(QP_j[c, d] * zeta[d] for d in range(C)) for c in range(C)]
    Qzh = [_sum(QP_j[c, d] * zeta_hat[d] for d in range(C)) for c in range(C)]
    eta = _sum((zeta[c].conj() * Qz[c]).real for c in range(C))
    eta_hat = _sum(zeta[c].conj() * Qzh[c] for c in range(C))
    weight = _root_weight(eta, eta_hat, eps)
    w_row = [torch.where(valid_j, (weight * zeta[c] - zeta_hat[c]).conj(), WP[j, n, c]) for c in range(C)]
    WP[j, n] = torch.stack(w_row)
    Xw[j] = _sum(XP_j[c].conj() * w_row[c].conj()[None, :] for c in range(C))


def _root_weight(eta, eta_hat, eps):
    """The root of the VCD's quadratic, ``eta_hat / (2 eta) (1 - sqrt(1 + 4
    eta / |eta_hat|^2))``, or ``1 / sqrt(eta)`` where ``|eta_hat| < eps``."""
    eta = floor_below(eta, eps)
    small = torch.abs(eta_hat) < eps
    eta_hat_f = torch.where(small, eps, eta_hat)
    weight = (eta_hat_f / (2 * eta)) * (1 - torch.sqrt(1 + 4 * eta / (torch.abs(eta_hat_f) ** 2)))
    return torch.where(small, (1 / torch.sqrt(eta)).to(weight.dtype), weight)


class IPSDTABase(IVABase):
    """Shared IPSDTA machinery (``bss/ipsdta.py:22-153``)."""

    state_fields = ("demix_filter", "estimation", "basis", "activation", "fixed_point")

    def __init__(self, n_basis=10, normalize=True, callbacks=None, reference_id=0, recordable_loss=True, eps=EPS,
                 device=None):  # fmt: skip
        super().__init__(callbacks=callbacks, recordable_loss=recordable_loss, eps=eps, device=device)
        self.n_basis = n_basis
        self.normalize = normalize
        self.reference_id = reference_id
        # the JAX package's route switches: the planes source steps at
        # B <= 3, the compact Hermitian planes within them (both on by
        # default) and the K = 2 pencil streams (off)
        self.source_planes = True
        self.source_pencil = False
        self.source_compact = True


class GaussIPSDTA(IPSDTABase):
    """Gaussian IPSDTA (``bss/ipsdta.py:155-1081``).

    ``Y = solver(X, iteration=N)`` returns the ``(n_sources, n_bins,
    n_frames)`` estimates, projected back onto ``reference_id``.  The basis
    state is ``(n_sources, n_blocks, B, B, n_basis)`` complex with zeros in
    the padded rows and columns; ``activation`` is ``(n_sources, n_basis,
    n_frames)``; Ikeshita adds ``fixed_point (n_sources, n_bins)``.
    """

    def __init__(
        self,
        n_basis=10,
        spatial_iteration=None,
        normalize=True,
        callbacks=None,
        reference_id=0,
        author="Kondo",
        recordable_loss=True,
        eps=EPS,
        device=None,
        **kwargs,
    ):
        super().__init__(
            n_basis=n_basis,
            normalize=normalize,
            callbacks=callbacks,
            reference_id=reference_id,
            recordable_loss=recordable_loss,
            eps=eps,
            device=device,
        )
        self.author = author
        if author.lower() == "ikeshita":
            defaults = KWARGS_IKESHITA
            self.algorithm_source, self.algorithm_spatial = "em", "fixed-point"
        elif author.lower() == "kondo":
            defaults = KWARGS_KONDO
            self.algorithm_source, self.algorithm_spatial = "mm", "vcd"
        else:
            raise ValueError("Not support {}'s IPSDTA".format(author))
        if set(kwargs) - set(defaults):
            raise ValueError("Invalid keywords.")
        for key, value in {**defaults, **kwargs}.items():
            setattr(self, key, value)
        if spatial_iteration is not None:
            self.spatial_iteration = spatial_iteration

    def field_axes(self):
        """Shardable axes of the IPSDTA state (the JAX package's): the basis
        along its block axis, the activations along frames."""
        return {
            "input": {"bins": 1, "frames": 2},
            "demix_filter": {"bins": 0},
            "estimation": {"bins": 1, "frames": 2},
            "basis": {"bins": 1},  # (S, n_blocks, B, B, K)
            "activation": {"frames": -1},  # (S, K, T)
            "fixed_point": {"bins": -1},  # (S, n_bins)
        }

    def _validate_mesh(self, input):
        if self._shard_mode != "bins":
            return
        n_bins = input.shape[1]
        layout = BlockLayout(n_bins, min(self.n_blocks, n_bins))
        mesh = self._mesh
        n_dev = mesh.size(mesh.mesh_dim_names.index(self._shard_axis_name))
        if layout.n_remains != 0 or layout.n_blocks % n_dev != 0:
            raise ValueError(
                "use_mesh(mode='bins'): IPSDTA blocks couple bins, so bin shards must align with whole blocks -- "
                "requires a uniform block partition (n_bins % n_blocks == 0; here {} % {} = {}) and n_blocks "
                "divisible by the {}-way mesh axis (here {} % {} = {}).  Use mode='frames' or adjust n_blocks/the "
                "STFT size.".format(
                    n_bins, layout.n_blocks, layout.n_remains, n_dev, layout.n_blocks, n_dev, layout.n_blocks % n_dev
                )
            )

    # init
    def _layout(self, n_bins):
        """The block layout of ``n_bins`` bins: the whole partition, or a
        bins shard's share of its blocks.  Each layout is kept for the
        solver's life: a captured step reads its tables (``runtime/graph.py``
        caches one graph per shape)."""
        world = self._shard_world("bins")
        n_blocks = min(self.n_blocks, n_bins * world) // world
        layouts = vars(self).setdefault("_layouts", {})
        if (n_bins, n_blocks) not in layouts:
            layouts[n_bins, n_blocks] = BlockLayout(n_bins, n_blocks)
        return layouts[n_bins, n_blocks]

    def capturable(self, X):
        """Every configuration (the Kondo and Ikeshita steps, TIPSDTA, every
        source route) at any shape: the block and channel eigensolves run
        on K3."""
        return True

    def prepare_state_kwargs(self, input, state_kwargs):
        """Host NumPy draws in the JAX package's order: the diagonal basis
        blocks low then high (``ipsdta.py:275-290``), packed into the padded
        layout, then the activation."""
        n_sources, n_bins, n_frames = input.shape
        layout = self._layout(n_bins)
        K, B = self.n_basis, layout.block_size
        r, s, nb = layout.n_remains, layout.n_neighbors, layout.n_blocks
        if "basis" not in state_kwargs:
            U = np.zeros((n_sources, K, nb, B, B))
            if r > 0:
                low = np.random.rand(n_sources, K, nb - r, s)
                high = np.random.rand(n_sources, K, r, s + 1)
                for j in range(s):
                    U[:, :, : nb - r, j, j] = low[..., j]
                for j in range(s + 1):
                    U[:, :, nb - r :, j, j] = high[..., j]
            else:
                diag = np.random.rand(n_sources, K, nb, s)
                for j in range(s):
                    U[:, :, :, j, j] = diag[..., j]
            state_kwargs["basis"] = U.transpose(0, 2, 3, 4, 1)  # (S, nb, B, B, K)
        if "activation" not in state_kwargs:
            state_kwargs["activation"] = np.random.rand(n_sources, K, n_frames)
        if self.algorithm_spatial == "fixed-point" and "fixed_point" not in state_kwargs:
            state_kwargs["fixed_point"] = np.ones((n_sources, n_bins))
        return state_kwargs

    def init_state(self, X, demix_filter=None, estimation=None, basis=None, activation=None, fixed_point=None):
        state = super().init_state(X, demix_filter=demix_filter, estimation=estimation)

        def complex_tensor(value):
            return torch.as_tensor(value).to(device=X.device, dtype=X.dtype).contiguous()

        state["basis"] = complex_tensor(basis)
        state["activation"] = state_tensor(activation, X)
        if fixed_point is not None:
            state["fixed_point"] = complex_tensor(fixed_point)
        if self.normalize:
            state = self._normalize_psdtf(state)
        return state

    # shared block quantities
    def _U_kmajor(self, state):
        """The basis in compute layout ``(S, K, n_blocks, B, B)``."""
        return state["basis"].permute(0, 4, 1, 2, 3)

    def _R_blocks_parts(self, U, V, layout):
        """``R = sum_k U_k V_kt (S, T, n_blocks, B, B)``, projected on the
        identity-padded blocks, and its eigenvalues."""
        R = torch.einsum("skbij,skt->stbij", U, V.to(U.dtype))
        return _psd_parts(layout.pad_identity(R), eps=self.eps)

    def _y_blocks(self, Y, layout):
        """Estimates ``(S, F, T) -> (S, T, n_blocks, B)``, zero-padded."""
        return layout.gather(Y.permute(0, 2, 1))

    @staticmethod
    def _pad_diag(U, layout):
        """The identity of the padded slots, ``(n_blocks, B, B)``."""
        return (~layout.valid_on(U.device)).to(U.real.dtype)[..., None] * _eye(U)

    def _basis_sqrt_chain(self, U, S_k, T_k, layout):
        """The MM basis update ``U S^1/2 (S^1/2 U T U S^1/2)^-1/2 S^1/2 U``
        with the reference's guards, zero-padded (``ipsdta.py:536-623``)."""
        eps = self.eps
        sqrt_S = _psd_sqrt_fused(layout.pad_identity(S_k), eps=eps)
        _, inv_sqrt = _sqrt_and_invsqrt_after_psd(sqrt_S @ U @ T_k @ U @ sqrt_S, self._pad_diag(U, layout), eps=eps)
        U_new = _to_psd(U @ sqrt_S @ inv_sqrt @ sqrt_S @ U, eps=eps)
        return layout.zero_padding_matrix(U_new).permute(0, 2, 3, 4, 1)

    # source model on matrices: EM (Ikeshita, ``ipsdta.py:365-508``)
    def _update_source_em(self, state, layout):
        eps = self.eps
        U = self._U_kmajor(state)
        V = state["activation"]
        n_bins = self._n_bins(state["input"])
        y = self._y_blocks(state["estimation"], layout)  # (S, T, nb, B)

        # basis: U_k A_k U_k + U_k, A_k = mean_t V_kt (z z^H - R^-1), z = R^-1 y
        R, _ = self._R_blocks_parts(U, V, layout)
        inv_R = _psd_inv(R, psd=False)
        z = torch.einsum("stbij,stbj->stbi", inv_R, y)
        zz_minus = z[..., :, None] * z[..., None, :].conj() - inv_R
        A = self._frames_sum(torch.einsum("skt,stbij->skbij", V.to(zz_minus.dtype), zz_minus)) / self._n_frames(V)
        U_new = _to_psd(layout.zero_padding_matrix(U @ A @ U + U), eps=eps)
        state = dict(state, basis=layout.zero_padding_matrix(U_new).permute(0, 2, 3, 4, 1))

        # activation: [V^2 z^H U z + V n_bins - V^2 tr(R^-1 U)] / n_bins
        U = self._U_kmajor(state)
        R, _ = self._R_blocks_parts(U, V, layout)
        inv_R = _psd_inv(R, psd=False)
        z = torch.einsum("stbij,stbj->stbi", inv_R, y)
        zUz, trRU = self._shard_sums(
            [torch.einsum("stbi,skbij,stbj->skt", z.conj(), U, z).real, torch.einsum("stbij,skbji->skt", inv_R, U).real],
            "bins",
        )
        V_new = (V**2 * zUz + V * n_bins - V**2 * trRU) / n_bins
        return dict(state, activation=torch.clamp(V_new, min=0.0))

    # source model on matrices: MM (Kondo, ``ipsdta.py:510-688``)
    def _update_source_mm(self, state, layout):
        eps = self.eps
        U = self._U_kmajor(state)
        V = state["activation"]
        y = self._y_blocks(state["estimation"], layout)
        B = layout.block_size

        # basis: S_k = sum_t V (z z^H + eps R^-2), T_k = sum_t V R^-1
        R, _ = self._R_blocks_parts(U, V, layout)
        inv_R = _psd_inv(R, eps=eps, psd=True)
        z = torch.einsum("stbij,stbj->stbi", inv_R, y)
        Vc = V.to(U.dtype)
        inv2 = matmul_small(inv_R, inv_R)
        S_k = torch.einsum("skt,stbi,stbj->skbij", Vc, z, z.conj()) + eps * torch.einsum("skt,stbij->skbij", Vc, inv2)
        T_k = torch.einsum("skt,stbij->skbij", Vc, inv_R)
        S_k, T_k = self._shard_sums([S_k, T_k], "frames")
        state = dict(state, basis=self._basis_sqrt_chain(U, S_k, T_k, layout))

        # activation by the trace ratio (``ipsdta.py:625-688``): with the
        # reference's ridge chain y y^H -> y y^H + d I, the numerator
        # tr(R^-1 U R^-1 (y y^H + d I)) = z^H U z + d tr(U R^-2)
        U = self._U_kmajor(state)
        R, _ = self._R_blocks_parts(U, V, layout)
        inv_R = _psd_inv(R, eps=eps, psd=True)
        z = torch.einsum("stbij,stbj->stbi", inv_R, y)
        ynorm = torch.einsum("stbi,stbi->stb", y.conj(), y).real
        d = eps + eps * (ynorm + B * eps)
        inv2_d = d[..., None, None].to(U.dtype) * matmul_small(inv_R, inv_R)
        zUz = torch.einsum("stbi,skbij,stbj->skt", z.conj(), U, z).real
        num, den = self._shard_sums(
            [zUz + torch.einsum("skbij,stbji->skt", U, inv2_d).real, torch.einsum("stbij,skbji->skt", inv_R, U).real],
            "bins",
        )
        return dict(state, activation=V * torch.sqrt(torch.clamp(num, min=0) / floor_below(den, eps)))

    # source model on compact Hermitian planes (B <= 3): R, R^-1, R^-2 and
    # every frame statistic as B^2 real planes, batched over sources, and
    # every trace contraction one real product
    def _source_compact_basis(self, state, layout):
        """``U (S, K, nb, B, B)`` and its compact planes ``UC (S, K, B^2,
        nb)``, real."""
        U = self._U_kmajor(state)
        UP = U.permute(0, 1, 3, 4, 2)  # (S, K, B, B, nb)
        UC = hermitian_compact_from_entries(lambda c, d: UP[:, :, c, d], layout.block_size).movedim(0, 2)
        return U, UC

    def _source_compact_preamble(self, state, layout):
        """``U``, ``UC``, the estimates ``YP (B, S, T, nb)`` (complex,
        zero-padded) and the compact identity of the padded slots ``padC
        (B^2, nb)``."""
        U, UC = self._source_compact_basis(state, layout)
        B = layout.block_size
        YP = self._y_blocks(state["estimation"], layout).permute(3, 0, 1, 2)
        invf = (~layout.valid_on(U.device)).T.to(U.real.dtype)  # (B, nb)
        padC = torch.cat([invf, invf.new_zeros((B * B - B,) + invf.shape[1:])])
        return U, UC, YP, padC

    @staticmethod
    def _compact_R(UC, V, padC, eps):
        """``R = sum_k U_k V_kt`` on compact planes ``(B^2, S, T, nb)``,
        identity-padded and projected."""
        RC = torch.einsum("skpb,skt->pstb", UC, V.to(UC.dtype)) + padC[:, None, None, :]
        return psd_parts_hermitian_compact(RC, eps=eps)

    def _source_R_inv_compact(self, UC, V, padC, psd, eps):
        """The compact adjugate inverse of the projected ``R``, ``(B^2, S, T,
        nb)``."""
        return psd_inv_hermitian_compact(self._compact_R(UC, V, padC, eps)[0], eps=eps, psd=psd)

    @staticmethod
    def _solve_y_compact(IC, YP):
        """``z = R^-1 y`` as B complex planes ``(S, T, nb)``."""
        B = YP.shape[0]
        return [_sum(compact_entry(IC, i, j) * YP[j] for j in range(B)) for i in range(B)]

    @staticmethod
    def _trace_contract_compact(UC, planes, conjugate):
        """``sum_ij U_ij P_ij`` (or with ``conj(U_ij)``) for compact Hermitian
        ``U (S, K, B^2, nb)`` and ``P (B^2, S, T, nb)``, a real ``(S, K, T)``:
        one real product, the off-diagonal planes weighted by +-2."""
        # the weights in ops/ip_components.py::_plane_index's order, filled
        # on the device: B
        # diagonal planes, then a (re, im) pair for each c < d
        B = int(round(planes.shape[0] ** 0.5))
        n_pairs = B * (B - 1) // 2
        pairs = torch.stack([UC.new_full((n_pairs,), 2.0), UC.new_full((n_pairs,), 2.0 if conjugate else -2.0)], dim=1)
        wts = torch.cat([UC.new_ones((B,)), pairs.reshape(-1)])
        return torch.einsum("skpb,pstb->skt", UC * wts[None, None, :, None], planes)

    @staticmethod
    def _frame_sum_compact(V, planes, B):
        """``sum_t V[s, k, t] P[., s, t, b]`` of compact planes ``(B^2, S, T,
        nb)`` as complex ``(S, K, nb, B, B)`` matrices."""
        summed = torch.einsum("skt,pstb->skpb", V.to(planes.dtype), planes)
        return expand_hermitian_compact_trailing(summed.transpose(2, 3), B)

    def _update_source_em_compact(self, state, layout):
        """The EM step (Ikeshita) on compact planes."""
        eps = self.eps
        V = state["activation"]
        n_bins, n_frames = self._n_bins(state["input"]), self._n_frames(V)
        U, UC, YP, padC = self._source_compact_preamble(state, layout)
        B = layout.block_size

        IC = self._source_R_inv_compact(UC, V, padC, False, eps)
        Z = self._solve_y_compact(IC, YP)
        AC = hermitian_compact_from_entries(lambda c, d: Z[c] * Z[d].conj(), B) - IC
        A = self._frames_sum(self._frame_sum_compact(V, AC, B)) / n_frames
        U_new = _to_psd(layout.zero_padding_matrix(U @ A @ U + U), eps=eps)
        state = dict(state, basis=layout.zero_padding_matrix(U_new).permute(0, 2, 3, 4, 1))

        U, UC = self._source_compact_basis(state, layout)
        IC = self._source_R_inv_compact(UC, V, padC, False, eps)
        Z = self._solve_y_compact(IC, YP)
        Pz = hermitian_compact_from_entries(lambda c, d: Z[c].conj() * Z[d], B)
        zUz, trRU = self._shard_sums(
            [self._trace_contract_compact(UC, Pz, False), self._trace_contract_compact(UC, IC, True)], "bins"
        )
        V_new = (V**2 * zUz + V * n_bins - V**2 * trRU) / n_bins
        return dict(state, activation=torch.clamp(V_new, min=0.0))

    def _update_source_mm_compact(self, state, layout):
        """The MM step (Kondo) on compact planes."""
        eps = self.eps
        V = state["activation"]
        U, UC, YP, padC = self._source_compact_preamble(state, layout)
        B = layout.block_size

        IC = self._source_R_inv_compact(UC, V, padC, True, eps)
        Z = self._solve_y_compact(IC, YP)
        SC = hermitian_compact_from_entries(lambda c, d: Z[c] * Z[d].conj(), B) + eps * square_hermitian_compact(IC)
        S_k, T_k = self._shard_sums([self._frame_sum_compact(V, SC, B), self._frame_sum_compact(V, IC, B)], "frames")
        state = dict(state, basis=self._basis_sqrt_chain(U, S_k, T_k, layout))

        U, UC = self._source_compact_basis(state, layout)
        IC = self._source_R_inv_compact(UC, V, padC, True, eps)
        Z = self._solve_y_compact(IC, YP)
        ynorm = _sum((YP[i].conj() * YP[i]).real for i in range(B))
        d = eps + eps * (ynorm + B * eps)  # (S, T, nb)
        Pz = hermitian_compact_from_entries(lambda c, dd: Z[c].conj() * Z[dd], B)
        zUz = self._trace_contract_compact(UC, Pz, False)
        tr_inv2_d = self._trace_contract_compact(UC, square_hermitian_compact(IC) * d[None], True)
        num, den = self._shard_sums([zUz + tr_inv2_d, self._trace_contract_compact(UC, IC, True)], "bins")
        return dict(state, activation=V * torch.sqrt(torch.clamp(num, min=0) / floor_below(den, eps)))

    # source model on complex planes (B <= 3, source_compact=False): every
    # per-block quantity as (B, B) entry planes (T, nb), source by source
    def _source_planes_basis(self, state, layout):
        """``U (S, K, nb, B, B)``, its planes ``UP (S, K, B, B, nb)`` and the
        identity of the padded slots ``padP (B, B, nb)``."""
        U = self._U_kmajor(state)
        invf = (~layout.valid_on(U.device)).T.to(U.real.dtype)  # (B, nb)
        padP = _eye(U)[:, :, None] * invf[None]
        return U, U.permute(0, 1, 3, 4, 2), padP

    def _source_planes_preamble(self, state, layout):
        """:meth:`_source_planes_basis` and the estimates ``YP (B, S, T,
        nb)``, zero-padded."""
        U, UP, padP = self._source_planes_basis(state, layout)
        return U, UP, self._y_blocks(state["estimation"], layout).permute(3, 0, 1, 2), padP

    @staticmethod
    def _source_R_inv_planes(UP_n, V_n, padP, psd, eps):
        """One source's ``R = sum_k U_k V_kt``, identity-padded and
        projected, and its adjugate inverse, planes ``(B, B, T, nb)``."""
        RP = torch.einsum("kijb,kt->ijtb", UP_n, V_n.to(UP_n.dtype)) + padP[:, :, None, :]
        return psd_inv_planes(psd_parts_planes(RP, eps=eps)[0], eps=eps, psd=psd)

    @staticmethod
    def _solve_y_planes(IP, YP_n):
        """``z = R^-1 y`` as B planes ``(T, nb)``."""
        B = IP.shape[0]
        return [_sum(IP[i, j] * YP_n[j] for j in range(B)) for i in range(B)]

    @staticmethod
    def _frame_sum_planes(V_n, entry, B):
        """``sum_t V[k, t] entry(i, j)[t, b]``, ``(K, nb, B, B)``."""
        rows = [[entry(i, j) for j in range(B)] for i in range(B)]
        Vc = V_n.to(rows[0][0].dtype)
        return torch.stack([torch.stack([torch.einsum("kt,tb->kb", Vc, e) for e in row], -1) for row in rows], -2)

    @staticmethod
    def _trace_sum_planes(UP_n, entry, B, transpose=False):
        """``sum_ij sum_b U[k, i, j, b] entry(i, j)[t, b]`` (``U[k, j, i, b]``
        with ``transpose``), real ``(K, T)``."""
        return _sum(
            torch.einsum("kb,tb->kt", UP_n[:, j, i] if transpose else UP_n[:, i, j], entry(i, j))
            for i in range(B)
            for j in range(B)
        ).real

    def _planes_pi(self, UP, YP, V, padP, n_bins):
        """The source statistics' frame weights on the planes route: none
        for the Gaussian model (TIPSDTA's posterior ``pi``)."""
        return None

    def _update_source_em_planes(self, state, layout):
        """The EM step (Ikeshita) on complex planes."""
        eps = self.eps
        V = state["activation"]
        n_bins, n_frames = self._n_bins(state["input"]), self._n_frames(V)
        U, UP, YP, padP = self._source_planes_preamble(state, layout)
        B = layout.block_size

        A = []
        for n in range(V.shape[0]):
            IP = self._source_R_inv_planes(UP[n], V[n], padP, False, eps)
            Z = self._solve_y_planes(IP, YP[:, n])
            A.append(self._frame_sum_planes(V[n], lambda i, j: Z[i] * Z[j].conj() - IP[i, j], B))
        A = self._frames_sum(torch.stack(A)) / n_frames  # (S, K, nb, B, B)
        U_new = _to_psd(layout.zero_padding_matrix(U @ A @ U + U), eps=eps)
        state = dict(state, basis=layout.zero_padding_matrix(U_new).permute(0, 2, 3, 4, 1))

        _, UP, _ = self._source_planes_basis(state, layout)
        zUz, trRU = [], []
        for n in range(V.shape[0]):
            IP = self._source_R_inv_planes(UP[n], V[n], padP, False, eps)
            Z = self._solve_y_planes(IP, YP[:, n])
            zUz.append(self._trace_sum_planes(UP[n], lambda i, j: Z[i].conj() * Z[j], B))
            trRU.append(self._trace_sum_planes(UP[n], lambda i, j: IP[i, j], B, transpose=True))
        zUz, trRU = self._shard_sums([torch.stack(zUz), torch.stack(trRU)], "bins")
        V_new = (V**2 * zUz + V * n_bins - V**2 * trRU) / n_bins
        return dict(state, activation=torch.clamp(V_new, min=0.0))

    def _update_source_mm_planes(self, state, layout):
        """The MM step on complex planes; TIPSDTA's ``pi`` (:meth:`_planes_pi`)
        weights the data statistics and the activation's numerator, whose
        ridge is then the plain ``eps``."""
        eps = self.eps
        V = state["activation"]
        n_bins = self._n_bins(state["input"])
        U, UP, YP, padP = self._source_planes_preamble(state, layout)
        B = layout.block_size

        pi = self._planes_pi(UP, YP, V, padP, n_bins)
        S_k, T_k = [], []
        for n in range(V.shape[0]):
            IP = self._source_R_inv_planes(UP[n], V[n], padP, True, eps)
            Z = self._solve_y_planes(IP, YP[:, n])
            inv2 = matmul_planes(IP, IP)
            Vp = V[n] if pi is None else V[n] * pi[n][None, :]
            S_k.append(self._frame_sum_planes(Vp, lambda i, j: Z[i] * Z[j].conj() + eps * inv2[i, j], B))
            T_k.append(self._frame_sum_planes(V[n], lambda i, j: IP[i, j], B))
        S_k, T_k = self._shard_sums([torch.stack(S_k), torch.stack(T_k)], "frames")
        state = dict(state, basis=self._basis_sqrt_chain(U, S_k, T_k, layout))

        # activation by the trace ratio: num = z^H U z + d tr(U R^-2), den =
        # tr(R^-1 U)
        _, UP, _ = self._source_planes_basis(state, layout)
        pi2 = self._planes_pi(UP, YP, V, padP, n_bins)
        num, den = [], []
        for n in range(V.shape[0]):
            IP = self._source_R_inv_planes(UP[n], V[n], padP, True, eps)
            Z = self._solve_y_planes(IP, YP[:, n])
            if pi2 is None:
                ynorm = _sum((YP[i, n].conj() * YP[i, n]).real for i in range(B))
                d = (eps + eps * (ynorm + B * eps)).to(IP.dtype)  # (T, nb)
            else:
                d = eps
            inv2 = matmul_planes(IP, IP)
            zUz = self._trace_sum_planes(UP[n], lambda i, j: Z[i].conj() * Z[j], B)
            num.append(zUz + self._trace_sum_planes(UP[n], lambda i, j: d * inv2[j, i], B))
            den.append(self._trace_sum_planes(UP[n], lambda i, j: IP[i, j], B, transpose=True))
        num, den = self._shard_sums([torch.stack(num), torch.stack(den)], "bins")
        if pi2 is not None:
            num = pi2[:, None, :] * num
        return dict(state, activation=V * torch.sqrt(torch.clamp(num, min=0) / floor_below(den, eps)))

    # source model: the K = 2 pencil streams (MM at n_basis == 2).  Per
    # block, G^H U_1 G = I and G^H U_2 G = diag(d) diagonalise every frame's
    # R = V_1 U_1 + V_2 U_2 (w_i = V_1 + V_2 d_i); the padded slots are
    # pushed out by a kappa = 1 / eps_machine identity in U_1, and the
    # reference's per-frame to_psd floors become ``w >= eps sum(w)`` in the
    # pencil frame (the JAX package's documented divergence)
    def _pencil_blocks(self, U1, U2, layout):
        """``(G, d, diag(G^H G))`` of the per-block pencil of ``(U_1, U_2)
        (..., nb, B, B)``."""
        rdt = U1.real.dtype
        finfo = torch.finfo(rdt)
        deps = max(self.eps, 100 * finfo.eps)
        eye = _eye(U1)
        pad = (~layout.valid_on(U1.device)).to(rdt)[..., None] * eye  # (nb, B, B)
        ridge = deps * _trace(U1) + math.sqrt(finfo.tiny)
        U1h = _herm(U1) + ridge[..., None, None] * eye + (1.0 / finfo.eps) * pad
        L = torch.linalg.cholesky_ex(U1h).L
        Z = torch.linalg.solve_triangular(L, _herm(U2), upper=False)
        M = torch.linalg.solve_triangular(L, Z.transpose(-2, -1).conj(), upper=False)
        # G keeps K3's phase of each column: G^H y and G E G^H take none
        d, Q = batched_eigh(_herm(M))
        G = torch.linalg.solve_triangular(L.transpose(-2, -1).conj(), Q, upper=True)
        return G, torch.clamp(d, min=0), torch.einsum("...ji,...ji->...i", G.conj(), G).real

    def _pencil_w_planes(self, V_n, d_n):
        """The pencil eigenvalue planes ``w_i (T, nb)`` of one source,
        floored at ``eps sum_i w_i``."""
        w = [V_n[0][:, None] + V_n[1][:, None] * d_n[:, i][None, :] for i in range(d_n.shape[-1])]
        finfo = torch.finfo(w[0].dtype)
        floor = torch.clamp(max(self.eps, 100 * finfo.eps) * _sum(w), min=finfo.tiny)
        return [torch.maximum(wi, floor) for wi in w]

    @staticmethod
    def _pencil_y(Gn, YP_n):
        """The estimates in the pencil frame, ``G^H y``: B planes ``(T, nb)``."""
        B = Gn.shape[-1]
        return [_sum(Gn[:, j, i].conj() * YP_n[j] for j in range(B)) for i in range(B)]

    def _pencil_pi(self, G, d, YP, V, n_bins):
        """The source statistics' frame weights on the pencil route: none for
        the Gaussian model (TIPSDTA's posterior ``pi``)."""
        return None

    def _update_source_mm_pencil(self, state, layout):
        """The MM step on the K = 2 pencil streams; TIPSDTA's ``pi``
        (:meth:`_pencil_pi`) as on the planes route."""
        eps = self.eps
        V = state["activation"]
        n_bins = self._n_bins(state["input"])
        U, _, YP, _ = self._source_planes_preamble(state, layout)
        B = layout.block_size

        # basis statistics in the pencil frame of the current basis
        G1, d1, _ = self._pencil_blocks(U[:, 0], U[:, 1], layout)
        pi = self._pencil_pi(G1, d1, YP, V, n_bins)
        S_k, T_k = [], []
        for n in range(V.shape[0]):
            Gn = G1[n]
            yt = self._pencil_y(Gn, YP[:, n])
            w = self._pencil_w_planes(V[n], d1[n])
            q = [yt[i] / w[i] for i in range(B)]
            rinv = [1.0 / w[i] for i in range(B)]
            Vp = (V[n] if pi is None else V[n] * pi[n][None, :]).to(U.dtype)
            Mfull = torch.einsum("bji,bjk->bik", Gn.conj(), Gn)  # (nb, B, B)
            E = torch.stack(
                [
                    torch.stack(
                        [
                            torch.einsum("kt,tb->kb", Vp, q[i] * q[j].conj())
                            + (eps * Mfull[:, i, j])[None, :]
                            * torch.einsum("kt,tb->kb", Vp, (rinv[i] * rinv[j]).to(U.dtype))
                            for j in range(B)
                        ],
                        -1,
                    )
                    for i in range(B)
                ],
                -2,
            )  # (K, nb, B, B)
            Vc = V[n].to(U.dtype)
            t_diag = torch.stack([torch.einsum("kt,tb->kb", Vc, rinv[i].to(U.dtype)) for i in range(B)], -1)
            Gh = Gn.transpose(-2, -1).conj()
            S_k.append(Gn[None] @ E @ Gh[None])
            T_k.append((Gn[None] * t_diag[..., None, :]) @ Gh[None])
        S_k, T_k = self._shard_sums([torch.stack(S_k), torch.stack(T_k)], "frames")
        state = dict(state, basis=self._basis_sqrt_chain(U, S_k, T_k, layout))

        # activation: diagonal traces in the new basis' pencil frame
        U = self._U_kmajor(state)
        G2, d2, M2 = self._pencil_blocks(U[:, 0], U[:, 1], layout)
        pi2 = self._pencil_pi(G2, d2, YP, V, n_bins)
        num, den = [], []
        for n in range(V.shape[0]):
            Gn, dn, Mn = G2[n], d2[n], M2[n]
            yt = self._pencil_y(Gn, YP[:, n])
            w = self._pencil_w_planes(V[n], dn)
            if pi2 is None:
                ynorm = _sum((YP[i, n].conj() * YP[i, n]).real for i in range(B))
                ridge = eps + eps * (ynorm + B * eps)  # (T, nb)
            else:
                ridge = eps
            r = [(torch.abs(yt[i]) ** 2 + ridge * Mn[:, i][None, :]) / (w[i] * w[i]) for i in range(B)]
            # c1 = diag(G^H U_1 G): 0, not 1, on the padded directions
            c1 = torch.einsum("bji,bjk,bki->bi", Gn.conj(), U[n, 0], Gn).real  # (nb, B)
            num.append(torch.stack([_sum(r).sum(-1), _sum(r[i] * dn[:, i][None, :] for i in range(B)).sum(-1)]))
            den.append(
                torch.stack(
                    [
                        _sum(c1[:, i][None, :] / w[i] for i in range(B)).sum(-1),
                        _sum(dn[:, i][None, :] / w[i] for i in range(B)).sum(-1),
                    ]
                )
            )
        num, den = self._shard_sums([torch.stack(num), torch.stack(den)], "bins")  # (S, 2, T)
        if pi2 is not None:
            num = pi2[:, None, :] * num
        return dict(state, activation=V * torch.sqrt(torch.clamp(num, min=0) / floor_below(den, eps)))

    # spatial model: VCD (Kondo, ``ipsdta.py:820-975``)
    def _update_spatial_vcd(self, state, layout, n_spatial=1):
        """All ``n_spatial`` sweeps in one call, the sweep invariants (the
        projected ``R_n^-1``, the covariances ``Q`` and the blocked mixture)
        formed once (the reference forms them every sweep).  Planes where
        the closed forms cover the block and channel sizes, else matrices."""
        W = state["demix_filter"]
        n_sources, n_channels = W.shape[1], W.shape[2]
        if layout.block_size <= 3 and n_channels <= 3 and n_sources == n_channels:
            return self._update_spatial_vcd_planes(state, layout, n_spatial)
        return self._update_spatial_vcd_matrix(state, layout, n_spatial)

    def _vcd_data_planes(self, state, layout):
        """The blocked mixture ``XP (B, C, T, nb)``, the blocked filter ``WP
        (B, N, C, nb)`` (identity rows in the padded slots) and the validity
        plane ``(B, nb)``."""
        X, W = state["input"], state["demix_filter"]
        n_sources, n_channels = W.shape[1], W.shape[2]
        XP = layout.gather(X.permute(0, 2, 1)).permute(3, 0, 1, 2)
        WP = layout.gather(W.permute(1, 2, 0)).permute(3, 0, 1, 2)
        eye = torch.eye(n_sources, n_channels, dtype=W.dtype, device=W.device)
        validB = layout.valid_on(W.device).T
        WP = torch.where(~validB[:, None, None, :], eye[:, :, None], WP)
        return XP, WP, validB

    def _vcd_inverse_planes(self, state, layout):
        """The projected ``R^-1`` with its ridge, the VCD's per-source sweep
        invariant: its entries ``[i][j] (S, T, nb)`` and its real diagonal
        ``(B, S, T, nb)``, from compact planes or, with
        ``source_compact=False``, complex ones."""
        V = state["activation"]
        B = layout.block_size
        if self.source_compact:
            _, UC, _, padC = self._source_compact_preamble(state, layout)
            IC = self._source_R_inv_compact(UC, V, padC, True, self.eps)
            return [[compact_entry(IC, i, j) for j in range(B)] for i in range(B)], IC[:B]
        _, UP, padP = self._source_planes_basis(state, layout)
        IP = torch.stack([self._source_R_inv_planes(UP[n], V[n], padP, True, self.eps) for n in range(V.shape[0])], 2)
        return [[IP[i, j] for j in range(B)] for i in range(B)], torch.stack([IP[j, j].real for j in range(B)])

    def _vcd_covariances(self, state, layout, inv_diag):
        """``Q[n, f] = (1/T) sum_t d[n, f, t] x x^H`` for every source and
        bin in one call of K1 (per-bin ``(S, F, T)`` weights): ``inv_diag
        (S, T, nb, B)`` holds the real diagonal of the projected ``R_n^-1``
        at each block slot, scattered back to the bins.  Returns the blocked
        ``Q (S, B, C, C, nb)``, zero in the padded slots."""
        X = state["input"]
        weights = layout.scatter(inv_diag).transpose(1, 2).to(X.real.dtype).contiguous()  # (S, F, T)
        Q = assemble_matrices(self._frames_mean(weighted_covariance_planes(X, weights)))  # (S, F, C, C)
        return layout.gather(Q.permute(0, 2, 3, 1)).permute(0, 4, 1, 2, 3)

    def _update_spatial_vcd_planes(self, state, layout, n_spatial=1):
        """VCD on planes: the matrix route's update order and guards, every
        small-matrix quantity with its tiny axes leading."""
        eps = self.eps
        X = state["input"]
        n_sources, n_channels = state["demix_filter"].shape[1:]
        B, n_frames = layout.block_size, X.shape[-1]

        n_frames = self._n_frames(X)
        XP, WP, validB = self._vcd_data_planes(state, layout)
        entry, diag = self._vcd_inverse_planes(state, layout)  # (S, T, nb) each, (B, S, T, nb)
        Q = self._vcd_covariances(state, layout, diag.permute(1, 2, 3, 0))
        Q_all = [[_to_psd_planes(Q[n, j], eps=eps) for j in range(B)] for n in range(n_sources)]
        Qinv_all = [[inv_planes(Q_nj) for Q_nj in Q_n] for Q_n in Q_all]

        for _ in range(n_spatial):
            for n in range(n_sources):
                Xw = self._projections_planes(XP, WP, n)
                for j in range(B):
                    coupled = _sum(entry[i][j][n] * Xw[i] for i in range(B) if i != j) if B > 1 else 0 * Xw[j]
                    gamma = self._gamma_planes(coupled, XP[j], n_frames)
                    _vcd_row_update(WP, Xw, Q_all[n][j], Qinv_all[n][j], gamma, n, j, validB[j], XP[j], eps)
        return self._with_filter(state, layout.scatter(WP.permute(1, 2, 3, 0)).permute(2, 0, 1))

    def _gamma_planes(self, coupled, XP_j, n_frames):
        """The VCD coupling ``gamma[c] = (1/T) sum_t coupled x_c`` of one
        slot, ``(nb,)`` per channel, its frame sums whole."""
        sums = torch.stack([torch.sum(coupled * XP_j[c], dim=0) for c in range(XP_j.shape[0])])
        return list(self._frames_sum(sums) / n_frames)

    @staticmethod
    def _projections_planes(XP, WP, n):
        """``conj(w_n^H x)`` per slot, ``(B, T, nb)``: the demixed
        projections of source n, updated row by row in the sweep."""
        C = XP.shape[1]
        return torch.stack(
            [_sum(XP[i, c].conj() * WP[i, n, c].conj()[None, :] for c in range(C)) for i in range(XP.shape[0])]
        )

    def _with_filter(self, state, W_new):
        return dict(state, demix_filter=W_new, estimation=self.separate(state["input"], W_new))

    def _vcd_data_matrix(self, state, layout):
        """The blocked mixture ``Xb (T, nb, B, C)`` and filter ``Wb (nb, B,
        N, C)``, identity rows in the padded slots."""
        X, W = state["input"], state["demix_filter"]
        n_sources, n_channels = W.shape[1], W.shape[2]
        Xb = layout.gather(X.permute(0, 2, 1)).permute(1, 2, 3, 0)
        Wb = layout.gather(W.permute(1, 2, 0)).permute(2, 3, 0, 1)
        eye = torch.eye(n_sources, n_channels, dtype=W.dtype, device=W.device)
        Wb = torch.where((~layout.valid_on(W.device))[..., None, None], eye, Wb)
        return Xb, Wb

    def _source_inverse_matrix(self, state, layout):
        """The projected ``R^-1`` with its ridge, ``(S, T, nb, B, B)``."""
        R, _ = self._R_blocks_parts(self._U_kmajor(state), state["activation"], layout)
        return _psd_inv(R, eps=self.eps, psd=True)

    def _vcd_row_matrix(self, Wb, Xw_n, Q, Qinv, gamma, Xbj, valid_j, n, j):
        """The VCD root formula for row ``(n, j)`` on matrices; writes the new
        row into ``Wb`` and its projections into ``Xw_n``, in place."""
        WQ = Wb[:, j] @ Q  # (nb, N, C)
        zeta = batched_inv(WQ)[..., :, n]  # solve(WQ, e_n)
        zeta_hat = torch.einsum("bcd,bd->bc", Qinv, gamma)
        eta = torch.einsum("bc,bcd,bd->b", zeta.conj(), Q, zeta).real
        eta_hat = torch.einsum("bc,bcd,bd->b", zeta.conj(), Q, zeta_hat)
        weight = _root_weight(eta, eta_hat, self.eps)
        w_row = torch.where(valid_j[:, None], (weight[:, None] * zeta - zeta_hat).conj(), Wb[:, j, n, :])
        Wb[:, j, n, :] = w_row
        Xw_n[j] = torch.einsum("tbc,bc->bt", Xbj.conj(), w_row.conj())

    def _coupling(self, inv_Rj, Xbj, Xw_n, j, n_frames):
        """``gamma (nb, C)``: the cross-bin coupling of slot j inside its block
        through the off-diagonal of ``R^-1`` (weights ``inv_Rj (T, nb, B)``),
        its frame sums whole."""
        RXXw = self._frames_sum(torch.einsum("tbi,tbc,ibt->bic", inv_Rj, Xbj, Xw_n)) / n_frames
        off = 1 - torch.eye(inv_Rj.shape[-1], dtype=RXXw.dtype, device=RXXw.device)[j]
        return torch.einsum("i,bic->bc", off, RXXw)

    def _update_spatial_vcd_matrix(self, state, layout, n_spatial=1):
        """VCD on matrices (blocks or channels past the closed forms); the
        per-row solves by the closed-form inverses at ``C <= 3``."""
        eps = self.eps
        n_sources = state["demix_filter"].shape[1]
        n_frames = self._n_frames(state["input"])
        valid = layout.valid_on(state["input"].device)

        Xb, Wb = self._vcd_data_matrix(state, layout)
        Xbj = Xb.movedim(2, 0)  # (B, T, nb, C): slot-major copies
        inv_R = self._source_inverse_matrix(state, layout)  # (S, T, nb, B, B)
        inv_Rj_all = inv_R.movedim(4, 1)  # (S, B, T, nb, B)
        Q_blocks = self._vcd_covariances(state, layout, torch.diagonal(inv_R, dim1=-2, dim2=-1).real)
        Q_all = _to_psd(Q_blocks.permute(0, 1, 4, 2, 3), eps=eps)  # (S, B, nb, C, C)
        Qinv_all = batched_inv(Q_all)

        for _ in range(n_spatial):
            for n in range(n_sources):
                Xw_n = torch.einsum("tbic,bic->ibt", Xb.conj(), Wb[:, :, n, :].conj())  # (B, nb, T)
                for j in range(layout.block_size):
                    gamma = self._coupling(inv_Rj_all[n, j], Xbj[j], Xw_n, j, n_frames)
                    self._vcd_row_matrix(Wb, Xw_n, Q_all[n, j], Qinv_all[n, j], gamma, Xbj[j], valid[:, j], n, j)
        return self._with_filter(state, layout.scatter(Wb.permute(2, 3, 0, 1)).permute(2, 0, 1))

    # spatial model: fixed point (Ikeshita, ``ipsdta.py:690-818``)
    def _fixed_point_G(self, state, layout):
        """``G[s, b, (j, c), (k, d)] = mean_t conj(R^-1)[s, t, b, j, k] X[t, b,
        j, c] conj(X[t, b, k, d])``, ``(S, nb, B C, B C)``."""
        eps = self.eps
        X = state["input"]
        U = self._U_kmajor(state)
        V = state["activation"]
        n_sources, n_channels = V.shape[0], X.shape[0]
        n_frames = self._n_frames(X)
        B = layout.block_size

        if self.source_planes and B <= 3:
            # planes: the inverse of conj(R) + eps I, on compact planes
            # (conj(R^-1) being the sign flip of their imaginary planes for a
            # Hermitian R), or on complex ones with source_compact=False
            XP = self._vcd_data_planes(state, layout)[0]  # (B, C, T, nb)
            if self.source_compact:
                _, UC, _, padC = self._source_compact_preamble(state, layout)
                ICe = inv_hermitian_compact(self._compact_R(UC, V, padC, eps)[0], ridge=eps)
                entries = [[compact_entry(ICe, j, k).conj() for k in range(B)] for j in range(B)]  # (S, T, nb)
            else:
                _, UP, padP = self._source_planes_basis(state, layout)
                inv_c = []
                for n in range(n_sources):
                    RP = torch.einsum("kijb,kt->ijtb", UP[n], V[n].to(UP.dtype)) + padP[:, :, None, :]
                    RP = psd_parts_planes(RP, eps=eps)[0]
                    ridge = torch.full(RP.shape[2:], eps, dtype=V.dtype, device=V.device)
                    inv_c.append(inv_planes(add_diag_planes(RP.conj(), ridge)))
                entries = torch.stack(inv_c, 2)  # (B, B, S, T, nb)
            G_rows = []
            for n in range(n_sources):
                entry = [[entries[j][k][n] for k in range(B)] for j in range(B)]
                rows = [
                    [
                        torch.einsum("tb,tb->b", entry[j][k] * XP[j, c], XP[k, d].conj())
                        for k in range(B)
                        for d in range(n_channels)
                    ]
                    for j in range(B)
                    for c in range(n_channels)
                ]
                G_rows.append(torch.stack([torch.stack(r, -1) for r in rows], -2))
            return self._frames_sum(torch.stack(G_rows)) / n_frames

        R, _ = self._R_blocks_parts(U, V, layout)
        inv_Rc = batched_inv(R.conj() + eps * _eye(R))
        Xb = self._vcd_data_matrix(state, layout)[0]  # (T, nb, B, C)
        G = self._frames_sum(torch.einsum("stbjk,tbjc,tbkd->sbjckd", inv_Rc, Xb, Xb.conj())) / n_frames
        return G.reshape(n_sources, layout.n_blocks, B * n_channels, B * n_channels)

    def _update_spatial_fixed_point(self, state, layout):
        eps = self.eps
        W = state["demix_filter"]  # (F, N, C), Hermitian rows
        Lambda = state["fixed_point"]  # (S, F)
        n_sources, n_channels = W.shape[1], W.shape[2]
        B = layout.block_size
        valid = layout.valid_on(W.device)

        G = self._fixed_point_G(state, layout)
        # identity in the padded (j, c) slots keeps G invertible
        pad = (~torch.repeat_interleave(valid, n_channels, dim=-1)).to(G.real.dtype)
        G = _to_psd(G, eps=eps) + pad[..., None] * _eye(G)
        # pivoted LU, not the blockwise closed form: G spans the mixture's
        # dynamic range, where the Schur complement cancels at float32
        inv_G6 = torch.linalg.inv_ex(G).inverse.reshape(n_sources, layout.n_blocks, B, n_channels, B, n_channels)
        inv_G_H = inv_G6.conj().permute(0, 1, 4, 2, 5, 3)  # [s, b, j, k, c, d] = conj(inv_G[(k, d), (j, c)])

        A = batched_inv(W) if n_channels <= 3 else torch.linalg.inv_ex(W).inverse  # (F, C, S) mixing
        Ab = layout.gather(A.permute(2, 1, 0)).permute(0, 2, 3, 1)  # (S, nb, B, C)
        Bmat = torch.einsum("sbjc,sbjkcd,sbkd->sbjk", Ab.conj(), inv_G_H, Ab)
        denom = torch.einsum("sbkj,sbk->sbj", Bmat, layout.gather(Lambda).conj())
        denom = torch.where(torch.abs(denom) < eps, eps, denom)
        Lb_new = layout.mask_vector(1 / denom)  # (S, nb, B)

        # w[s, b, (j, c)] = sum_{k, d} inv_G[(j, c), (k, d)] Lambda_new[k] A[(k, d)]
        w = torch.einsum("sbjckd,sbk,sbkd->sbjc", inv_G6, Lb_new, Ab)
        W_new = layout.scatter(w.permute(0, 3, 1, 2)).permute(2, 0, 1).conj_physical()  # (F, S, C) Hermitian rows
        return dict(self._with_filter(state, W_new), fixed_point=layout.scatter(Lb_new))

    # normalisation, the loop, the NLL
    def _normalize_psdtf(self, state):
        """Trace normalisation over blocks (``ipsdta.py:983-1005``)."""
        U = self._U_kmajor(state)
        trace = self._bins_sum(_trace(U).sum(dim=2))  # (S, K)
        U = U / trace[:, :, None, None, None]
        return dict(state, basis=U.permute(0, 2, 3, 4, 1), activation=state["activation"] * trace[:, :, None])

    def _source_step(self, layout):
        """The source step of this block size and these switches, routed as
        the JAX package routes it (``ipsdta.py:1582-1600``)."""
        planes = self.source_planes and layout.block_size <= 3
        if self.algorithm_source == "em":
            if not planes:
                return self._update_source_em
            return self._update_source_em_compact if self.source_compact else self._update_source_em_planes
        if planes and self.source_pencil and self.n_basis == 2:
            return self._update_source_mm_pencil
        if not planes:
            return self._update_source_mm
        return self._update_source_mm_compact if self.source_compact else self._update_source_mm_planes

    def update_state(self, state):
        layout = self._layout(state["input"].shape[1])
        state = self._source_step(layout)(state, layout)
        if self.normalize:
            state = self._normalize_psdtf(state)
        if self.algorithm_spatial == "fixed-point":
            for _ in range(self.spatial_iteration):
                state = self._update_spatial_fixed_point(state, layout)
            return state
        return self._update_spatial_vcd(state, layout, n_spatial=self.spatial_iteration)

    def nll(self, state):
        """``sum (y^H R^-1 y + log det R) - 2 T sum log |det W|``, the block
        log-determinants from the projected eigenvalues floored at eps
        (``ipsdta.py:1015-1081``)."""
        eps = self.eps
        layout = self._layout(state["input"].shape[1])
        W = state["demix_filter"]
        n_frames = self._n_frames(state["input"])
        logdet_W = self._bins_sum(batched_log_abs_det(W).sum())
        V = state["activation"]
        if self.source_planes and self.source_compact and layout.block_size <= 3:
            _, UC, YP, padC = self._source_compact_preamble(state, layout)
            RC, w = self._compact_R(UC, V, padC, eps)
            Z = self._solve_y_compact(psd_inv_hermitian_compact(RC, eps=eps, psd=True), YP)
            yRy = _sum((YP[i].conj() * Z[i]).real for i in range(layout.block_size)).sum(dim=-1)  # (S, T)
            # the padded slots contribute log 1 = 0 through the injected identity
            logdet = torch.log(torch.clamp(w, min=eps)).sum(dim=(0, -1))
            return self._shard_sum(torch.sum(yRy + logdet)) - 2 * n_frames * logdet_W
        y = self._y_blocks(state["estimation"], layout)
        R, wR = self._R_blocks_parts(self._U_kmajor(state), V, layout)
        z = torch.einsum("stbij,stbj->stbi", _psd_inv(R, eps=eps, psd=True), y)
        yRy = torch.einsum("stbi,stbi->st", y.conj(), z).real
        logdet_R = torch.log(torch.clamp(wR, min=eps)).sum(dim=(-2, -1))
        return self._shard_sum(torch.sum(yRy + logdet_R)) - 2 * n_frames * logdet_W

    def finalize(self, state):
        X, Y = state["input"], state["estimation"]
        return Y * self._projection_back(Y, X[self.reference_id])[..., None]

    def __repr__(self):
        return (
            "Gauss-IPSDTA(n_basis={}, normalize={}, algorithm(source)={}, algorithm(spatial)={}, n_blocks={}, "
            "author={})".format(
                self.n_basis, self.normalize, self.algorithm_source, self.algorithm_spatial, self.n_blocks, self.author
            )
        )


class TIPSDTA(GaussIPSDTA):
    """Student-t IPSDTA (``bss/ipsdta.py:1083-1899``), Kondo's MM + VCD only.

    The posterior weight ``pi = (nu + 2 n_bins) / (nu + 2 y^H R^-1 y)``
    (``ipsdta.py:1299, 1364``) scales the frame statistics of the source MM
    and of the VCD covariance, which the sweep forms again for every row.
    """

    def __init__(
        self,
        n_basis=10,
        nu=1.0,
        spatial_iteration=None,
        normalize=True,
        callbacks=None,
        reference_id=0,
        author="Kondo",
        recordable_loss=True,
        eps=EPS,
        device=None,
        **kwargs,
    ):
        if author.lower() != "kondo":
            raise ValueError("Only Kondo's (MM + VCD) t-IPSDTA is supported.")
        super().__init__(
            n_basis=n_basis,
            spatial_iteration=spatial_iteration,
            normalize=normalize,
            callbacks=callbacks,
            reference_id=reference_id,
            author=author,
            recordable_loss=recordable_loss,
            eps=eps,
            device=device,
            **kwargs,
        )
        self.nu = nu

    def _pi(self, yRy, n_bins):
        """``pi`` from the sum over this shard's blocks ``yRy``, made whole."""
        return (self.nu + 2 * n_bins) / (self.nu + 2 * self._bins_sum(yRy))

    def _pi_weight(self, state, layout):
        """Posterior weights ``pi (S, T)`` from the unridged inverse."""
        y = self._y_blocks(state["estimation"], layout)
        R, _ = self._R_blocks_parts(self._U_kmajor(state), state["activation"], layout)
        z = torch.einsum("stbij,stbj->stbi", _psd_inv(R, psd=False), y)
        return self._pi(torch.einsum("stbi,stbi->st", y.conj(), z).real, self._n_bins(state["input"]))

    def _update_source_mm(self, state, layout):
        """The Gaussian MM on matrices with ``pi`` in the data statistics."""
        eps = self.eps
        pi = self._pi_weight(state, layout)  # (S, T)
        V = state["activation"]
        U = self._U_kmajor(state)
        y = self._y_blocks(state["estimation"], layout)

        R, _ = self._R_blocks_parts(U, V, layout)
        inv_R = _psd_inv(R, eps=eps, psd=True)
        z = torch.einsum("stbij,stbj->stbi", inv_R, y)
        Vp = (V * pi[:, None, :]).to(U.dtype)
        inv2 = matmul_small(inv_R, inv_R)
        S_k = torch.einsum("skt,stbi,stbj->skbij", Vp, z, z.conj()) + eps * torch.einsum("skt,stbij->skbij", Vp, inv2)
        T_k = torch.einsum("skt,stbij->skbij", V.to(U.dtype), inv_R)
        S_k, T_k = self._shard_sums([S_k, T_k], "frames")
        state = dict(state, basis=self._basis_sqrt_chain(U, S_k, T_k, layout))

        # activation: pi again from the new basis (``ipsdta.py:1420-1470``),
        # on the numerator only; tr(R^-1 U R^-1 (y y^H + eps I)) = z^H U z +
        # eps tr(U R^-2)
        pi2 = self._pi_weight(state, layout)
        U = self._U_kmajor(state)
        R, _ = self._R_blocks_parts(U, V, layout)
        inv_R = _psd_inv(R, eps=eps, psd=True)
        z = torch.einsum("stbij,stbj->stbi", inv_R, y)
        zUz = torch.einsum("stbi,skbij,stbj->skt", z.conj(), U, z).real
        num, den = self._shard_sums(
            [
                zUz + torch.einsum("skbij,stbji->skt", U, eps * matmul_small(inv_R, inv_R)).real,
                torch.einsum("stbij,skbji->skt", inv_R, U).real,
            ],
            "bins",
        )
        num = torch.clamp(pi2[:, None, :] * num, min=0)
        return dict(state, activation=V * torch.sqrt(num / floor_below(den, eps)))

    def _planes_pi(self, UP, YP, V, padP, n_bins):
        """``pi (S, T)`` from the planes route's unridged inverse."""
        B = UP.shape[2]
        yRy = []
        for n in range(V.shape[0]):
            Z = self._solve_y_planes(self._source_R_inv_planes(UP[n], V[n], padP, False, self.eps), YP[:, n])
            yRy.append(_sum((YP[i, n].conj() * Z[i]).real for i in range(B)).sum(dim=-1))
        return self._pi(torch.stack(yRy), n_bins)

    def _pencil_pi(self, G, d, YP, V, n_bins):
        """``pi (S, T)`` in the pencil frame: ``y^H R^-1 y = sum_blocks sum_i
        |G^H y|_i^2 / w_i``."""
        yRy = []
        for n in range(V.shape[0]):
            yt = self._pencil_y(G[n], YP[:, n])
            w = self._pencil_w_planes(V[n], d[n])
            yRy.append(_sum(torch.abs(yt[i]) ** 2 / w[i] for i in range(len(w))).sum(dim=-1))
        return self._pi(torch.stack(yRy), n_bins)

    def _pi_and_R_inv_compact(self, UC, YP, V, padC, n_bins, eps):
        """``(pi (S, T), R^-1 (B^2, S, T, nb))`` from one adjugate inverse:
        ``pi`` from the plain inverse, the MM statistics from it plus the
        ``eps trace`` ridge."""
        IC0 = inv_hermitian_compact(self._compact_R(UC, V, padC, eps)[0])
        Z0 = self._solve_y_compact(IC0, YP)
        yRy = _sum((YP[i].conj() * Z0[i]).real for i in range(YP.shape[0])).sum(dim=-1)
        return self._pi(yRy, n_bins), add_diag_hermitian_compact(IC0, eps * trace_hermitian_compact(IC0))

    def _update_source_mm_compact(self, state, layout):
        """The Gaussian compact MM with ``pi`` in the data statistics."""
        eps = self.eps
        V = state["activation"]
        n_bins = self._n_bins(state["input"])
        U, UC, YP, padC = self._source_compact_preamble(state, layout)
        B = layout.block_size

        pi, IC = self._pi_and_R_inv_compact(UC, YP, V, padC, n_bins, eps)
        Z = self._solve_y_compact(IC, YP)
        SC = hermitian_compact_from_entries(lambda c, d: Z[c] * Z[d].conj(), B) + eps * square_hermitian_compact(IC)
        S_k, T_k = self._shard_sums(
            [self._frame_sum_compact(V * pi[:, None, :], SC, B), self._frame_sum_compact(V, IC, B)], "frames"
        )
        state = dict(state, basis=self._basis_sqrt_chain(U, S_k, T_k, layout))

        U, UC = self._source_compact_basis(state, layout)
        pi2, IC = self._pi_and_R_inv_compact(UC, YP, V, padC, n_bins, eps)
        Z = self._solve_y_compact(IC, YP)
        Pz = hermitian_compact_from_entries(lambda c, dd: Z[c].conj() * Z[dd], B)
        zUz = self._trace_contract_compact(UC, Pz, False)
        tr_inv2_e = self._trace_contract_compact(UC, eps * square_hermitian_compact(IC), True)
        num, den = self._shard_sums([zUz + tr_inv2_e, self._trace_contract_compact(UC, IC, True)], "bins")
        num = torch.clamp(pi2[:, None, :] * num, min=0)
        return dict(state, activation=V * torch.sqrt(num / floor_below(den, eps)))

    def _update_spatial_vcd_planes(self, state, layout, n_spatial=1):
        """The t-VCD on planes (``ipsdta.py:1472-1660``): ``pi_n(t)`` from the
        current rows inside every (source, slot) step, folded into that
        step's ``Q`` and coupling."""
        eps = self.eps
        X = state["input"]
        n_sources, n_channels = state["demix_filter"].shape[1:]
        n_bins, n_frames = self._n_bins(X), self._n_frames(X)
        B = layout.block_size

        XP, WP, validB = self._vcd_data_planes(state, layout)
        entry, diag = self._vcd_inverse_planes(state, layout)

        for _ in range(n_spatial):
            for n in range(n_sources):
                Xw = self._projections_planes(XP, WP, n)
                for j in range(B):
                    # pi from the current rows, y = conj(Xw)
                    y = [Xw[i].conj() for i in range(B)]
                    z = [_sum(entry[i][k][n] * y[k] for k in range(B)) for i in range(B)]
                    pi_n = self._pi(_sum((y[i].conj() * z[i]).real for i in range(B)).sum(dim=1), n_bins)  # (T,)
                    wxt = pi_n[:, None] * diag[j, n]  # (T, nb)
                    Q_j = _to_psd_planes(self._frames_sum(self._q_planes(wxt, XP[j], 1)) / n_frames, eps=eps)
                    coupled = (
                        pi_n[:, None].to(XP.dtype) * _sum(entry[i][j][n] * Xw[i] for i in range(B) if i != j)
                        if B > 1
                        else 0 * Xw[j]
                    )
                    gamma = self._gamma_planes(coupled, XP[j], n_frames)
                    _vcd_row_update(WP, Xw, Q_j, inv_planes(Q_j), gamma, n, j, validB[j], XP[j], eps)
        return self._with_filter(state, layout.scatter(WP.permute(1, 2, 3, 0)).permute(2, 0, 1))

    @staticmethod
    def _q_planes(wxt, XP_j, n_frames):
        """``Q (C, C, nb)`` of one slot from real frame weights ``wxt (T,
        nb)``: the upper triangle from plane products, the lower its
        conjugate."""
        C = XP_j.shape[0]
        rows = [[None] * C for _ in range(C)]
        for c in range(C):
            for d in range(c, C):
                rows[c][d] = torch.sum(wxt * XP_j[c] * XP_j[d].conj(), dim=0) / n_frames
                if d != c:
                    rows[d][c] = rows[c][d].conj()
        return torch.stack([torch.stack(r) for r in rows])

    def _update_spatial_vcd_matrix(self, state, layout, n_spatial=1):
        """The t-VCD on matrices (blocks or channels past the closed forms)."""
        eps = self.eps
        X = state["input"]
        n_sources = state["demix_filter"].shape[1]
        n_bins, n_frames = self._n_bins(X), self._n_frames(X)
        valid = layout.valid_on(X.device)

        Xb, Wb = self._vcd_data_matrix(state, layout)
        Xbj = Xb.movedim(2, 0)  # (B, T, nb, C)
        XXj = Xbj[..., :, None] * Xbj[..., None, :].conj()  # (B, T, nb, C, C)
        inv_R = self._source_inverse_matrix(state, layout)  # (S, T, nb, B, B)
        inv_Rj_all = inv_R.movedim(4, 1)  # (S, B, T, nb, B)
        inv_R_diagj_all = torch.diagonal(inv_R, dim1=-2, dim2=-1).real.movedim(3, 1)  # (S, B, T, nb)

        for _ in range(n_spatial):
            for n in range(n_sources):
                inv_Rj = inv_Rj_all[n]
                Xw_n = torch.einsum("tbic,bic->ibt", Xb.conj(), Wb[:, :, n, :].conj())  # (B, nb, T)
                for j in range(layout.block_size):
                    # pi from the current rows
                    y_n = Xw_n.conj()
                    z = torch.einsum("jtbi,jbt->ibt", inv_Rj, y_n)
                    pi_n = self._pi(torch.einsum("ibt,ibt->t", y_n.conj(), z).real, n_bins)  # (T,)
                    Q = torch.einsum("tb,tbcd->bcd", (pi_n[:, None] * inv_R_diagj_all[n, j]).to(XXj.dtype), XXj[j])
                    Q = _to_psd(self._frames_sum(Q) / n_frames, eps=eps)
                    gamma = self._coupling(pi_n[:, None, None].to(Xb.dtype) * inv_Rj[j], Xbj[j], Xw_n, j, n_frames)
                    self._vcd_row_matrix(Wb, Xw_n, Q, batched_inv(Q), gamma, Xbj[j], valid[:, j], n, j)
        return self._with_filter(state, layout.scatter(Wb.permute(2, 3, 0, 1)).permute(2, 0, 1))

    def nll(self, state):
        """The t-NLL (``ipsdta.py:1694-1760``), on matrices at every block
        size: ``sum log det R + (nu + 2F) / 2 sum log(1 + 2 / nu y^H R^-1 y)
        - 2 T sum log |det W|``."""
        eps = self.eps
        layout = self._layout(state["input"].shape[1])
        n_bins, n_frames = self._n_bins(state["input"]), self._n_frames(state["input"])
        y = self._y_blocks(state["estimation"], layout)
        R, wR = self._R_blocks_parts(self._U_kmajor(state), state["activation"], layout)
        z = torch.einsum("stbij,stbj->stbi", _psd_inv(R, eps=eps, psd=True), y)
        yRy = self._bins_sum(torch.einsum("stbi,stbi->st", y.conj(), z).real)
        logdet_R = self._shard_sum(torch.log(torch.clamp(wR, min=eps)).sum())
        logdet_W = self._bins_sum(batched_log_abs_det(state["demix_filter"]).sum())
        nu = self.nu
        return logdet_R + (nu + 2 * n_bins) / 2 * self._frames_sum(torch.sum(torch.log(1 + (2 / nu) * yRy))) - (
            2 * n_frames * logdet_W
        )

    def __repr__(self):
        return "t-IPSDTA(n_basis={}, nu={}, n_blocks={}, author={})".format(
            self.n_basis, self.nu, self.n_blocks, self.author
        )


tIPSDTA = TIPSDTA
