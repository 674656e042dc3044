"""Component-layout AuxIVA-IP math on complex tensors.

Every per-bin C x C quantity is a *component*: a Python-indexed collection
of ``(F,)`` tensors, so the IP chain is elementwise work over the bin axis
and the channel loops unroll in Python (C in {2, 3, 4}; determinants and
adjugates are Laplace expansions).

Layouts:
  * ``W_rows[n][c]`` complex ``(F,)`` -- demixing rows as components;
  * ``X (C, F, T)`` complex -- the public mixture layout;
  * ``planes (C^2, F, T)`` real -- compact Hermitian pair products
    (:func:`pair_products_planes`), contracted over frames as one real GEMM.
"""

import torch


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


def frame_power_sums(rows, planes):
    """``sum_f |sum_c rows[n][c] x_c|^2 -> (N, T)`` as one real GEMM over the
    pair-product planes; the complex estimates are never formed.

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
    return torch.clamp(out, min=0.0)


def _covariance_planes(planes, weights):
    """Real contraction over frames: ``(P, F, T) x (N, T) -> (P, F, N)``,
    ``out[p, f, n] = (1/T) sum_t planes[p, f, t] w[n, t]``.

    This is the plain version of the weighted-covariance kernel
    (``ops/cov_kernel.py``): one ``(P F, T) x (T, N)`` matmul."""
    P, F, T = planes.shape
    w = weights.to(planes.dtype)
    out = torch.matmul(planes.reshape(P * F, T), w.transpose(0, 1)) / T
    return out.reshape(P, F, -1)


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


def weighted_covariance_components(planes, weights):
    """``U[n][c][d] (F,) = (1/T) sum_t w[n, t] (x_c x_d^*)(f, t)`` from the
    planes and 2-D ``(N, T)`` weights, as a nested list of complex ``(F,)``."""
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


def ip_update_components(W_rows, U, threshold=1e12, guard="one_norm"):
    """Sequential IP row sweep in component layout.

    ``W_rows[s][c]`` and ``U[n][c][d]`` are complex ``(F,)``.  For each
    source n: solve ``(W U_n) w = e_n`` by the adjugate, normalise by
    ``sqrt(w^H U_n w)`` (Cholesky form), and keep the old row where the
    guard rejects the bin.  ``guard="one_norm"`` keeps bins whose
    ``kappa_1(W U_n) = ||WU||_1 ||WU^{-1}||_1`` is below ``threshold`` (a NaN
    kappa compares false, so singular bins keep their rows); ``"none"``
    accepts every bin.  Returns the updated nested list.
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
