"""Component-layout AuxIVA-IP math on complex tensors.

Every per-bin C x C quantity is a *component*: a Python-indexed collection
of ``(F,)`` tensors, so the IP chain is elementwise work over the bin axis
and the channel loops unroll in Python (C in {2, 3, 4}; determinants and
adjugates are Laplace expansions).

Layouts:
  * ``W_rows[n][c]`` complex ``(F,)`` -- demixing rows as components;
  * ``W (F, N, C)`` complex -- the public demixing-filter layout, taken and
    returned by the functions that bridge to it;
  * ``X (C, F, T)`` complex -- the public mixture layout;
  * ``planes (C^2, F, T)`` real -- compact Hermitian pair products
    (:func:`pair_products_planes`), contracted over frames as one real GEMM.
"""

import functools
import math

import torch

from .eig2 import generalized_eig2x2_descending_planes
from .fast_linalg import det_planes, inv_planes


def _plane_index(C):
    """Compact Hermitian plane ordering: C diagonal real planes, then
    (re, im) pairs for each off-diagonal c < d -- C^2 planes in all
    (``x_c x_d^* = conj(x_d x_c^*)`` and the diagonal is real)."""
    index = {}
    order = []
    for c in range(C):
        index[("re", c, c)] = len(order)
        order.append(("re", c, c))
    for c in range(C):
        for d in range(c + 1, C):
            index[("re", c, d)] = len(order)
            order.append(("re", c, d))
            index[("im", c, d)] = len(order)
            order.append(("im", c, d))
    return index, order


def pair_products_planes(X):
    """Compact real pair-product planes ``(C^2, F, T)`` of ``X (C, F, T)``."""
    C = X.shape[0]
    _, order = _plane_index(C)
    planes = []
    for kind, c, d in order:
        prod = X[c] * X[d].conj()
        planes.append(prod.real if kind == "re" else prod.imag)
    return torch.stack(planes)


def frame_power_sums(rows, planes, bins_sum=None):
    """``sum_f |sum_c rows[n][c] x_c|^2 -> (N, T)`` as one real GEMM over the
    pair-product planes; the complex estimates are never formed.  A
    bin-sharded caller passes its sum over the shards as ``bins_sum``.

    The quadratic expansion ``sum_c |w_c|^2 P_cc + sum_{c<d} 2(Re a Re P_cd
    - Im a Im P_cd)`` with ``a = w_c w_d^*`` is a real weight per (n, plane,
    bin), so the bin reduction is a ``(N, C^2 F) x (C^2 F, T)`` matmul.  The
    exact value is a sum of squares, but the cross terms can cancel slightly
    below zero in float32, so the result is clamped at 0.
    """
    n_channels = len(rows[0])
    wts = []
    for row in rows:
        per_plane = [torch.abs(row[c]) ** 2 for c in range(n_channels)]
        for c in range(n_channels):
            for d in range(c + 1, n_channels):
                a = row[c] * row[d].conj()
                per_plane.append(2.0 * a.real)
                per_plane.append(-2.0 * a.imag)
        wts.append(torch.stack(per_plane))
    W = torch.stack(wts).to(planes.dtype)  # (N, C^2, F)
    P, F, T = planes.shape
    out = torch.matmul(W.reshape(W.shape[0], P * F), planes.reshape(P * F, T))
    if bins_sum is not None:
        out = bins_sum(out)
    return torch.clamp(out, min=0.0)


def quadratic_power_components(rows, planes):
    """``P[n] = |sum_c rows[n][c] x_c|^2 -> (N, F, T)`` real, from the
    compact pair-product planes; the complex estimates are never formed.

    ``sum_c |w_c|^2 P_cc + sum_{c<d} 2(Re a Re P_cd - Im a Im P_cd)`` with
    ``a = w_c w_d^*``, elementwise over ``(F, T)``.  The exact value is a sum
    of squares, but the cross terms can cancel slightly below zero in
    float32, so the result is clamped at 0.
    """
    n_channels = len(rows[0])
    out = []
    for row in rows:
        acc = None
        for c in range(n_channels):
            term = (torch.abs(row[c]) ** 2)[:, None] * planes[c]
            acc = term if acc is None else acc + term
        k = n_channels
        for c in range(n_channels):
            for d in range(c + 1, n_channels):
                a = row[c] * row[d].conj()
                acc = acc + 2.0 * (a.real[:, None] * planes[k] - a.imag[:, None] * planes[k + 1])
                k += 2
        out.append(torch.clamp(acc, min=0.0))
    return torch.stack(out)


def quadratic_power_planes(W, planes):
    """:func:`quadratic_power_components` of the ``(F, N, C)`` filter ``W``:
    ``|separate(X, W)|^2 (N, F, T)``."""
    return quadratic_power_components(filter_rows(W), planes)


def gram_components(planes, frames_sum=None):
    """Frame-summed mixture Gram ``G[c][d] = sum_t x_c x_d^* (F,)`` complex,
    reassembled from the compact planes; invariant for a fixed mixture.
    ``frames_sum`` is a frame-sharded caller's sum over the shards."""
    C = math.isqrt(planes.shape[0])
    sums = planes.sum(dim=-1)  # (C^2, F)
    if frames_sum is not None:
        sums = frames_sum(sums)
    index, _ = _plane_index(C)
    G = [[None] * C for _ in range(C)]
    for c in range(C):
        G[c][c] = torch.complex(sums[index[("re", c, c)]], torch.zeros_like(sums[0]))
        for d in range(c + 1, C):
            G[c][d] = torch.complex(sums[index[("re", c, d)]], sums[index[("im", c, d)]])
            G[d][c] = G[c][d].conj_physical()
    return G


def projection_back_components(rows, G, reference_id=0, ridge_rel=1e-12):
    """Per-(source, bin) projection-back scales from the filter rows and the
    mixture Gram (:func:`gram_components`), with no ``(N, F, T)`` estimate.

    ``Y Y^H (i, j) = sum_cd w_ic w_jd^* G[c][d]`` and ``x_ref Y^H (j) =
    sum_d w_jd^* G[ref][d]`` restate the least-squares fit ``A = X Y^H (Y
    Y^H)^{-1}`` of :func:`~..algorithm.projection_back.projection_back`
    exactly.  The Gram is ridged by ``ridge_rel`` of its trace, as there, and
    solved by the adjugate.  Returns a list of ``(F,)`` complex scales, one
    per source.
    """
    n_sources = len(rows)
    n_channels = len(rows[0])
    YY = [
        [
            sum(rows[i][c] * rows[j][d].conj() * G[c][d] for c in range(n_channels) for d in range(n_channels))
            for j in range(n_sources)
        ]
        for i in range(n_sources)
    ]
    xY = [sum(rows[j][d].conj() * G[reference_id][d] for d in range(n_channels)) for j in range(n_sources)]
    trace = sum(YY[i][i].real for i in range(n_sources))
    ridge = (ridge_rel * trace + 1e-32).to(YY[0][0].dtype)
    for i in range(n_sources):
        YY[i][i] = YY[i][i] + ridge
    det = det_components(YY, n_sources)
    scales = []
    for s in range(n_sources):
        # element s of the row vector xY YY^{-1}: xY against column s of the inverse
        col = solve_column_components(YY, n_sources, s, det=det)
        scales.append(sum(xY[j] * col[j] for j in range(n_sources)))
    return scales


def _covariance_planes(planes, weights):
    """Real contraction over frames: ``(P, F, T) x (N, [F,] T) -> (P, F, N)``,
    ``out[p, f, n] = (1/T) sum_t planes[p, f, t] w[n, (f,) t]``.

    This is the plain version of the weighted-covariance kernel
    (``ops/cov_kernel.py``): for 2-D ``(N, T)`` weights one ``(P F, T) x
    (T, N)`` matmul; for 3-D ``(N, F, T)`` per-bin weights (ILRMA's
    variances) a bin-batched contraction."""
    P, F, T = planes.shape
    w = weights.to(planes.dtype)
    if w.ndim == 2:
        out = torch.matmul(planes.reshape(P * F, T), w.transpose(0, 1)) / T
        return out.reshape(P, F, -1)
    return torch.einsum("pft,nft->pfn", planes, w) / T


def _assemble_entry(out, index, c, d, n):
    """Complex ``U[c][d] (F,)`` from the compact contraction ``(P, F, N)``."""
    if c == d:
        re = out[index[("re", c, c)], :, n]
        return torch.complex(re, torch.zeros_like(re))
    if c < d:
        re = out[index[("re", c, d)], :, n]
        im = out[index[("im", c, d)], :, n]
        return torch.complex(re, im)
    re = out[index[("re", d, c)], :, n]
    im = out[index[("im", d, c)], :, n]
    return torch.complex(re, -im)


def assemble_components(out):
    """Nested ``U[n][c][d]`` complex ``(F,)`` from compact ``(C^2, F, N)``."""
    P, _, n_sources = out.shape
    C = int(round(P**0.5))
    index, _ = _plane_index(C)
    return [
        [[_assemble_entry(out, index, c, d, n) for d in range(C)] for c in range(C)]
        for n in range(n_sources)
    ]


@functools.lru_cache(maxsize=None)
def _assembly_index(C, device, dtype):
    """Plane gather of the Hermitian ``(C, C)`` assembly, row-major over
    ``(c, d)``: ``index (2 C^2,)`` holds the real part's plane of each entry,
    then its imaginary part's; ``sign (C^2, 1, 1)`` is the imaginary part's
    sign (0 on the diagonal, -1 below it)."""
    table, _ = _plane_index(C)
    re, im, sign = [], [], []
    for c in range(C):
        for d in range(C):
            lo, hi = min(c, d), max(c, d)
            re.append(table[("re", lo, hi)])
            im.append(table[("re", c, c)] if c == d else table[("im", lo, hi)])
            sign.append(0.0 if c == d else (1.0 if c < d else -1.0))
    index = torch.tensor(re + im, dtype=torch.int64, device=device)
    return index, torch.tensor(sign, dtype=dtype, device=device)[:, None, None]


def assemble_matrices(out):
    """Hermitian ``U (N, F, C, C)`` complex from compact ``(C^2, F, N)``
    (finite planes), as one gather: a strided view of a ``(C, C, F, N)``
    tensor."""
    P, F, N = out.shape
    C = math.isqrt(P)
    index, sign = _assembly_index(C, out.device, out.dtype)
    gathered = out.index_select(0, index)
    U = torch.complex(gathered[:P], gathered[P:] * sign)
    return U.reshape(C, C, F, N).permute(3, 2, 0, 1)


def filter_rows(W):
    """``(F, N, C)`` filter as the nested ``rows[n][c]`` list of ``(F,)``."""
    return [[W[:, s, c] for c in range(W.shape[2])] for s in range(W.shape[1])]


def stack_filter_rows(rows):
    """Inverse of :func:`filter_rows`: nested rows -> ``(F, N, C)``."""
    return torch.stack([torch.stack(row, dim=-1) for row in rows], dim=1)


def weighted_covariance_components(planes, weights):
    """``U[n][c][d] (F,) = (1/T) sum_t w[n, (f,) t] (x_c x_d^*)(f, t)`` from
    the planes and ``(N, T)`` or ``(N, F, T)`` weights, as a nested list of
    complex ``(F,)``."""
    return assemble_components(_covariance_planes(planes, weights))


def separate_components(W_rows, X):
    """``Y[n] = sum_c w[n][c][:, None] X[c]`` -> ``Y (N, F, T)``."""
    n_channels = X.shape[0]
    rows = []
    for w_row in W_rows:
        acc = w_row[0][:, None] * X[0]
        for c in range(1, n_channels):
            acc = acc + w_row[c][:, None] * X[c]
        rows.append(acc)
    return torch.stack(rows)


def _det_components(M, idx_rows, idx_cols):
    """Laplace-expansion determinant of ``M[idx_rows][idx_cols]``."""
    if len(idx_rows) == 1:
        return M[idx_rows[0]][idx_cols[0]]
    i = idx_rows[0]
    total = None
    for pos, j in enumerate(idx_cols):
        minor = _det_components(M, idx_rows[1:], idx_cols[:pos] + idx_cols[pos + 1 :])
        term = M[i][j] * minor
        if pos % 2 == 1:
            term = -term
        total = term if total is None else total + term
    return total


def det_components(M, n):
    """Determinant of an n x n component matrix (list of lists of (F,))."""
    return _det_components(M, tuple(range(n)), tuple(range(n)))


def solve_column_components(M, n, col, det=None):
    """Column ``col`` of ``M^{-1}`` via the adjugate (Cramer's rule):
    ``inv[i][col] = (-1)^{i+col} minor(col, i) / det``."""
    if det is None:
        det = det_components(M, n)
    rows = tuple(range(n))
    out = []
    for i in range(n):
        minor_rows = tuple(r for r in rows if r != col)
        minor_cols = tuple(c for c in rows if c != i)
        minor = (
            _det_components(M, minor_rows, minor_cols)
            if n > 1
            else torch.ones_like(det)
        )
        sign = -1 if (i + col) % 2 else 1
        out.append(sign * minor / det)
    return out


def cholesky_quadratic_components(U_n, w, tiny=1e-32):
    """``w^H U w`` for Hermitian PSD ``U`` as ``||L^H w||^2`` through a
    closed-form Cholesky factor: a sum of squares, never negative.

    The direct sum ``sum w_c^* U_cd w_d`` cancels in float32 when the weights
    span many decades (large products cancelling to an O(1) result whose
    rounding noise flips the sign and NaNs the ``sqrt``).  Factoring first
    keeps every term non-negative.  Zero pivots (clamped Schur complements of
    a numerically singular PSD matrix) zero their column, the exact
    completion for PSD inputs.
    """
    C = len(w)
    L = [[None] * C for _ in range(C)]
    for j in range(C):
        s = U_n[j][j].real - sum(torch.abs(L[j][k]) ** 2 for k in range(j))
        s = torch.clamp(s, min=0.0)
        d = torch.sqrt(s)
        L[j][j] = d
        if j + 1 < C:
            d_safe = torch.clamp(d, min=tiny)
            for i in range(j + 1, C):
                off = U_n[i][j] - sum(L[i][k] * torch.conj(L[j][k]) for k in range(j))
                L[i][j] = torch.where(s > 0, off / d_safe, torch.zeros_like(off))
    wUw = None
    for i in range(C):
        t = sum(torch.conj(L[j][i]) * w[j] for j in range(i, C))
        term = torch.abs(t) ** 2
        wUw = term if wUw is None else wUw + term
    return wUw


def ip_update_components(W_rows, U, threshold=1e12, guard="one_norm", denom_floor=None):
    """Sequential IP row sweep in component layout.

    ``W_rows[s][c]`` and ``U[n][c][d]`` are complex ``(F,)``.  For each
    source n: solve ``(W U_n) w = e_n`` by the adjugate, normalise by
    ``sqrt(w^H U_n w)`` (Cholesky form; floored at ``denom_floor`` when
    given), and keep the old row where the guard rejects the bin.
    ``guard="one_norm"`` keeps bins whose ``kappa_1(W U_n) = ||WU||_1
    ||WU^{-1}||_1`` is below ``threshold`` (a NaN kappa compares false, so
    singular bins keep their rows); ``"none"`` accepts every bin.  Returns
    the updated nested list.
    """
    if guard not in ("one_norm", "none"):
        raise ValueError("guard must be 'one_norm' or 'none', got {!r}".format(guard))
    n_sources = len(W_rows)
    n_channels = len(W_rows[0])
    W_rows = [list(row) for row in W_rows]

    for n in range(n_sources):
        U_n = U[n]
        WU = [
            [
                sum(W_rows[s][c] * U_n[c][j] for c in range(n_channels))
                for j in range(n_channels)
            ]
            for s in range(n_sources)
        ]
        det = det_components(WU, n_channels)
        w_n = solve_column_components(WU, n_channels, n, det=det)

        if guard == "none":
            ok = None
        else:
            inv_cols = [
                solve_column_components(WU, n_channels, j, det=det)
                for j in range(n_channels)
            ]
            norm = torch.stack(
                [
                    sum(torch.abs(WU[i][j]) for i in range(n_channels))
                    for j in range(n_channels)
                ]
            ).amax(dim=0)
            inv_norm = torch.stack(
                [
                    sum(torch.abs(inv_cols[j][i]) for i in range(n_channels))
                    for j in range(n_channels)
                ]
            ).amax(dim=0)
            ok = norm * inv_norm < threshold

        denom = torch.sqrt(cholesky_quadratic_components(U_n, w_n))
        if denom_floor is not None:
            denom = torch.clamp(denom, min=denom_floor)
        for c in range(n_channels):
            new_c = w_n[c].conj() / denom
            if ok is not None:
                new_c = torch.where(ok, new_c, W_rows[n][c])
            W_rows[n][c] = new_c
    return W_rows


def log_abs_det_components(W_rows, n_channels):
    """``log|det W_f| (F,)`` from component layout."""
    det = det_components(
        [[W_rows[i][j] for j in range(n_channels)] for i in range(n_channels)],
        n_channels,
    )
    return torch.log(torch.abs(det))


def weighted_covariance_planes_array(planes, weights):
    """``U (N, F, C, C)`` complex from the planes and ``(N, T)`` or ``(N, F,
    T)`` weights (for matrix-layout consumers)."""
    return assemble_matrices(_covariance_planes(planes, weights))


def weighted_covariance_planes_stack(planes, weights):
    """``U (N, C, C, F)`` complex from the planes and ``(N, T)`` or ``(N, F,
    T)`` weights: the small axes lead and the bins trail (for the IP2 planes
    update)."""
    return weighted_covariance_planes_array(planes, weights).permute(0, 2, 3, 1)


def ip_sweep_from_planes(W, planes, inv_weights, threshold=1e12, guard="one_norm", denom_floor=None):
    """Covariance from the planes and the IP sweep, in component layout.

    Args:
        W: demixing filters ``(F, N, C)``.
        planes: from :func:`pair_products_planes`.
        inv_weights: ``(N, T)`` or ``(N, F, T)`` reciprocal variances.
        denom_floor: optional floor on the ``sqrt(w^H U w)`` normaliser.
    Returns:
        the updated ``W (F, N, C)``.
    """
    U = weighted_covariance_components(planes, inv_weights)
    rows = ip_update_components(filter_rows(W), U, threshold=threshold, guard=guard, denom_floor=denom_floor)
    return stack_filter_rows(rows)


def _dynamic_set_row(W, idx, row):
    """``W[:, idx, :] = row`` out of place, with ``idx`` a 0-d tensor that
    stays on the device (a one-hot blend; no host read of the index)."""
    onehot = (torch.arange(W.shape[1], device=W.device) == idx)[None, :, None]
    return torch.where(onehot, row[:, None, :], W)


def _take(A, idx, dim):
    """``A`` indexed at the 0-d tensor ``idx`` along ``dim``, without a
    host read of the index."""
    return A.index_select(dim, idx.reshape(1)).squeeze(dim)


def ip2_pair_update_planes(W, U_mn, m, n, threshold=1e12, guard="one_norm"):
    """Pairwise (IP2) update of demixing rows ``(m, n)`` with every per-bin
    small matrix as planes and the inverses as adjugates (the math of the
    matrix path in ``models/iva.py::AuxIVABase._update_pairwise``, reference
    ``bss/iva.py:566-599``).

    Args:
        W: ``(F, N, C)`` square demixing filter, C <= 3 (the closed forms).
        U_mn: ``(2, C, C, F)`` weighted covariances of sources (m, n).
        m, n: 0-d integer tensors, the pair.
        guard: ``"one_norm"`` or ``"none"``.
    Returns:
        the updated ``W`` (same shape).
    """
    C = W.shape[-1]
    Wc = [[W[:, i, c] for c in range(C)] for i in range(C)]
    # WU[i][j][p] = sum_c W[i][c] U_p[c][j]: (C, C, 2, F), matrix axes leading
    WU = torch.stack(
        [torch.stack([sum(Wc[i][c][None] * U_mn[:, c, j] for c in range(C)) for j in range(C)]) for i in range(C)]
    )
    det = det_planes(WU)
    inv = inv_planes(WU, det=det)  # inv[i][j] = (WU^{-1})[i, j], (C, C, 2, F)

    if guard == "none":
        ok = None
    else:
        from .ip import cond_guard  # ops/ip.py imports this module

        # the matrix axes trail in the views: ok is (2, F)
        ok = cond_guard(WU.permute(2, 3, 0, 1), inv.permute(2, 3, 0, 1), threshold=threshold, guard=guard)

    # P_p = WU_p^{-1} E_mn: columns m and n of the inverse, (C, 2 cols, 2 p, F)
    P_cols = torch.stack([_take(inv, m, 1), _take(inv, n, 1)], dim=1)

    # V_p[a][b] = sum_{c,d} conj(P_p[c][a]) U_p[c][d] P_p[d][b]: 2 x 2 planes over (p, F)
    UP = [[sum(U_mn[:, c, d] * P_cols[d, b] for d in range(C)) for b in range(2)] for c in range(C)]
    V = [[sum(P_cols[c, a].conj() * UP[c][b] for c in range(C)) for b in range(2)] for a in range(2)]
    Vm = [[V[a][b][0] for b in range(2)] for a in range(2)]
    Vn = [[V[a][b][1] for b in range(2)] for a in range(2)]
    v_m, v_n = generalized_eig2x2_descending_planes(Vm, Vn)

    def normalize(v, Vp):
        vVv = sum(v[a].conj() * Vp[a][b] * v[b] for a in range(2) for b in range(2))
        scale = torch.sqrt(vVv)
        return (v[0] / scale, v[1] / scale)

    v_m = normalize(v_m, Vm)
    v_n = normalize(v_n, Vn)

    # w_p[c] = conj(sum_a P_p[c][a] v_p[a])
    w_m = torch.stack([(P_cols[c, 0, 0] * v_m[0] + P_cols[c, 1, 0] * v_m[1]).conj() for c in range(C)], dim=-1)
    w_n = torch.stack([(P_cols[c, 0, 1] * v_n[0] + P_cols[c, 1, 1] * v_n[1]).conj() for c in range(C)], dim=-1)
    if ok is not None:
        w_m = torch.where(ok[0][:, None], w_m, _take(W, m, 1))
        w_n = torch.where(ok[1][:, None], w_n, _take(W, n, 1))
    W = _dynamic_set_row(W, m, w_m)
    return _dynamic_set_row(W, n, w_n)


def natural_grad_step_components(W_rows, Y, Phi, lr, frames_sum=None, n_frames=None):
    """One natural-gradient step ``W <- W - lr ((Phi Y^H / T - I) W)`` in
    component layout: the cross-moments ``G[n][m] = mean_t Phi_n conj(Y_m)``
    are ``(F,)`` frame reductions and the update is component arithmetic.

    Args:
        W_rows: nested list ``[n][c]`` of complex ``(F,)`` demixing rows.
        Y: estimates ``(N, F, T)`` (``separate(X, W)``).
        Phi: score ``(N, F, T)``.
        lr: learning rate.
        frames_sum, n_frames: a frame-sharded caller's sum over the shards
            (applied once to the packed moments) and the whole frame count.
    Returns: the updated ``W_rows``.
    """
    n_sources = len(W_rows)
    n_channels = len(W_rows[0])
    sums = torch.stack([torch.stack([(Phi[n] * Y[m].conj()).sum(dim=-1) for m in range(n_sources)]) for n in range(n_sources)])
    if frames_sum is not None:
        sums = frames_sum(sums)
    G = sums / (Y.shape[-1] if n_frames is None else n_frames)
    new_rows = []
    for n in range(n_sources):
        row = []
        for c in range(n_channels):
            delta = None
            for m in range(n_sources):
                g = G[n][m] - 1.0 if m == n else G[n][m]
                term = g * W_rows[m][c]
                delta = term if delta is None else delta + term
            row.append(W_rows[n][c] - lr * delta)
        new_rows.append(row)
    return new_rows


def plain_grad_step_components(W_rows, X, Phi, lr, frames_sum=None, n_frames=None):
    """One plain-gradient step ``W <- W - lr (Phi X^H / T - W^{-H})`` in
    component layout, ``W^{-H}`` from the adjugate (square W, N <= 4);
    ``frames_sum`` and ``n_frames`` as in
    :func:`natural_grad_step_components`."""
    n_sources = len(W_rows)
    n_channels = len(W_rows[0])
    sums = torch.stack([torch.stack([(Phi[n] * X[c].conj()).sum(dim=-1) for c in range(n_channels)]) for n in range(n_sources)])
    if frames_sum is not None:
        sums = frames_sum(sums)
    moments = sums / (X.shape[-1] if n_frames is None else n_frames)
    det = det_components(W_rows, n_sources)
    # inv_cols[n][c] = (W^{-1})[c, n]
    inv_cols = [solve_column_components(W_rows, n_sources, n, det=det) for n in range(n_sources)]
    new_rows = []
    for n in range(n_sources):
        row = []
        for c in range(n_channels):
            row.append(W_rows[n][c] - lr * (moments[n, c] - inv_cols[n][c].conj()))
        new_rows.append(row)
    return new_rows


def auxiva_ip_step_components(X, W_rows, Y, planes, eps=1e-8, threshold=1e12):
    """One whole AuxIVA-IP iteration (Laplace contrast) in component layout:
    the frame weights ``R = max(sqrt(sum_f |Y|^2), eps)`` of the current
    estimates, the weighted covariances from the pair-product planes, the IP
    row sweep, the new estimates, and the NLL ``2 sum_{n, t} sqrt(sum_f
    |Y|^2) - 2 T sum_f log|det W_f|`` of the new filter.

    The plain PyTorch counterpart of kernel K2's iteration
    (:func:`~.fused_ip.fused_auxiva_ip_iter`), with the same NLL; no solver
    calls it.

    Args:
        X: mixture ``(C, F, T)`` complex.
        W_rows: demixing components, nested ``[n][c]`` of complex ``(F,)``.
        Y: current estimates ``(N, F, T)`` complex.
        planes: the pair-product planes of ``X``
            (:func:`pair_products_planes`).
    Returns:
        ``(W_rows_new, Y_new, nll)``.
    """
    n_channels, n_frames = X.shape[0], X.shape[-1]
    R = torch.clamp(torch.sqrt(torch.sum(torch.abs(Y) ** 2, dim=1)), min=eps)  # (N, T)
    U = weighted_covariance_components(planes, 1.0 / R)
    W_rows = ip_update_components(W_rows, U, threshold=threshold)
    Y = separate_components(W_rows, X)
    nll = (2 * torch.sqrt(frame_power_sums(W_rows, planes))).sum() - 2 * n_frames * (
        log_abs_det_components(W_rows, n_channels).sum()
    )
    return W_rows, Y, nll
