"""Closed-form small-matrix linear algebra.

Planes layout: the matrix axes lead (``P (n, n, ...batch)``), so every slice
``P[i, j]`` is a whole plane over the batch axes (bins, in practice).
Projection-back, the IP2 planes update, the covariance-domain NMF and
IPSDTA's VCD use these.  The trailing-axes forms (``A (..., n, n)``) serve the matrix-layout
IP, IP2 and NLL paths and the divergences.  Compact Hermitian planes (the
last section) store a Hermitian field as ``n^2`` real planes.
"""

import functools
import math
import operator

import torch

from .eigh_kernel import batched_eigh


def _sum(terms):
    """The sum of tensors, without Python ``sum``'s leading ``0 +`` pass."""
    return functools.reduce(operator.add, terms)


def det_planes(P):
    """Determinant from planes ``P (n, n, ...) -> (...)``; closed form n <= 3."""
    n = P.shape[0]
    if n == 1:
        return P[0, 0]
    if n == 2:
        return P[0, 0] * P[1, 1] - P[0, 1] * P[1, 0]
    if n == 3:
        return (
            P[0, 0] * (P[1, 1] * P[2, 2] - P[1, 2] * P[2, 1])
            - P[0, 1] * (P[1, 0] * P[2, 2] - P[1, 2] * P[2, 0])
            + P[0, 2] * (P[1, 0] * P[2, 1] - P[1, 1] * P[2, 0])
        )
    raise ValueError("det_planes: closed forms cover n <= 3, got {}".format(n))


def inv_planes(P, det=None):
    """Inverse from planes ``P (n, n, ...) -> (n, n, ...)``; adjugate, n <= 3."""
    n = P.shape[0]
    if det is None:
        det = det_planes(P)
    if n == 1:
        return (1.0 / det)[None, None]
    if n == 2:
        rows = [[P[1, 1], -P[0, 1]], [-P[1, 0], P[0, 0]]]
    elif n == 3:
        a, b, c = P[0, 0], P[0, 1], P[0, 2]
        d, e, f = P[1, 0], P[1, 1], P[1, 2]
        g, h, i = P[2, 0], P[2, 1], P[2, 2]
        rows = [
            [e * i - f * h, c * h - b * i, b * f - c * e],
            [f * g - d * i, a * i - c * g, c * d - a * f],
            [d * h - e * g, b * g - a * h, a * e - b * d],
        ]
    else:
        raise ValueError("inv_planes: closed forms cover n <= 3, got {}".format(n))
    return torch.stack([torch.stack(r) for r in rows]) / det


def hermitian_eigvalsh_planes(P):
    """Eigenvalues (ascending, stacked leading) of Hermitian planes
    ``P (n, n, ...) -> (n, ...)``; closed forms for n <= 3 (at n = 3 the
    trigonometric solution of the characteristic cubic; an exactly diagonal
    matrix, ``p2 = 0``, gives the mean eigenvalue)."""
    n = P.shape[0]
    if n == 1:
        return P[0, 0].real[None]
    if n == 2:
        a, d, b = P[0, 0].real, P[1, 1].real, P[0, 1]
        mean = (a + d) / 2
        rad = torch.sqrt(((a - d) / 2) ** 2 + torch.abs(b) ** 2)
        return torch.stack([mean - rad, mean + rad])
    if n != 3:
        raise ValueError("hermitian_eigvalsh_planes: closed forms cover n <= 3, got {}".format(n))
    q = (P[0, 0].real + P[1, 1].real + P[2, 2].real) / 3
    p1 = torch.abs(P[0, 1]) ** 2 + torch.abs(P[0, 2]) ** 2 + torch.abs(P[1, 2]) ** 2
    p2 = _sum((P[i, i].real - q) ** 2 for i in range(3)) + 2 * p1
    degenerate = p2 <= 0
    p = torch.sqrt(torch.where(degenerate, 1.0, p2) / 6)
    qc = q.to(P.dtype)
    Bp = torch.stack([torch.stack([(P[i, j] - qc) / p if i == j else P[i, j] / p for j in range(3)]) for i in range(3)])
    r = torch.clamp(det_planes(Bp).real / 2, -1.0, 1.0)
    phi = torch.arccos(r) / 3
    e_hi = q + 2 * p * torch.cos(phi)
    e_lo = q + 2 * p * torch.cos(phi + 2 * math.pi / 3)
    e_mid = 3 * q - e_hi - e_lo
    return torch.where(degenerate, q, torch.stack([e_lo, e_mid, e_hi]))


def matmul_planes(A, B):
    """Matrix product from planes ``A, B (n, n, ...) -> (n, n, ...)``."""
    n = A.shape[0]
    return torch.stack([torch.stack([_sum(A[i, k] * B[k, j] for k in range(n)) for j in range(n)]) for i in range(n)])


def herm_planes(P):
    """Hermitian-symmetrize planes ``P (n, n, ...)``."""
    return (P + P.transpose(0, 1).conj()) / 2


def add_diag_planes(P, s):
    """Add the real plane ``s (...)`` to the diagonal planes of ``P (n, n, ...)``."""
    n = P.shape[0]
    eye = torch.eye(n, dtype=P.dtype, device=P.device).reshape((n, n) + (1,) * (P.ndim - 2))
    return P + eye * s[None, None].to(P.dtype)


def trace_planes(P):
    """Real trace of planes ``P (n, n, ...) -> (...)``."""
    tr = P[0, 0].real
    for i in range(1, P.shape[0]):
        tr = tr + P[i, i].real
    return tr


def psd_parts_planes(P, eps=1e-12):
    """The reference's ``to_psd`` on planes ``P (n, n, ...)``, n <= 3, and
    the eigenvalues of the result: hermitise, shift by the most negative
    eigenvalue (closed-form eigvalsh), add the ``eps trace`` ridge.  Returns
    ``(psd (n, n, ...), eigenvalues (n, ...))``."""
    H = herm_planes(P)
    w = hermitian_eigvalsh_planes(H)
    shift = eps * trace_planes(H) - torch.clamp(w.amin(dim=0), max=0.0)
    return add_diag_planes(H, shift), w + shift[None]


def psd_inv_planes(R, eps=1e-12, psd=True):
    """Adjugate inverse of planes ``R (n, n, ...)``, n <= 3, with the
    reference's trailing ``to_psd`` of the inverse where ``psd`` is set (the
    input is PSD already, so that is the ``eps trace`` ridge)."""
    inv = inv_planes(R)
    if psd:
        inv = herm_planes(inv)
        inv = add_diag_planes(inv, eps * trace_planes(inv))
    return inv


# Trailing-axes forms: the matrix axes are the last two (``A (..., n, n)``),
# as in ``torch.linalg``.  Closed forms up to 3 x 3, ``torch.linalg`` above.


def det_2x2(A):
    return A[..., 0, 0] * A[..., 1, 1] - A[..., 0, 1] * A[..., 1, 0]


def inv_2x2(A, det=None):
    if det is None:
        det = det_2x2(A)
    inv = torch.stack(
        [
            torch.stack([A[..., 1, 1], -A[..., 0, 1]], dim=-1),
            torch.stack([-A[..., 1, 0], A[..., 0, 0]], dim=-1),
        ],
        dim=-2,
    )
    return inv / det[..., None, None]


def _entries_3x3(A):
    return [[A[..., i, j] for j in range(3)] for i in range(3)]


def det_3x3(A):
    (a, b, c), (d, e, f), (g, h, i) = _entries_3x3(A)
    return a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)


def inv_3x3(A, det=None):
    (a, b, c), (d, e, f), (g, h, i) = _entries_3x3(A)
    if det is None:
        det = det_3x3(A)
    cof = torch.stack(
        [
            torch.stack([e * i - f * h, c * h - b * i, b * f - c * e], dim=-1),
            torch.stack([f * g - d * i, a * i - c * g, c * d - a * f], dim=-1),
            torch.stack([d * h - e * g, b * g - a * h, a * e - b * d], dim=-1),
        ],
        dim=-2,
    )
    return cof / det[..., None, None]


def batched_det(A):
    """Determinant of batched square matrices; closed form for n <= 3."""
    n = A.shape[-1]
    if n == 1:
        return A[..., 0, 0]
    if n == 2:
        return det_2x2(A)
    if n == 3:
        return det_3x3(A)
    return torch.linalg.det(A)


def batched_inv(A):
    """Inverse of batched square matrices; closed form for n <= 3."""
    n = A.shape[-1]
    if n == 1:
        return 1.0 / A
    if n == 2:
        return inv_2x2(A)
    if n == 3:
        return inv_3x3(A)
    # no invertibility check: it would read the result on the host, and a
    # singular matrix gives non-finite entries, as in the JAX package
    return torch.linalg.inv_ex(A).inverse


def _eigvalsh_trailing(A):
    return hermitian_eigvalsh_planes(A.movedim((-2, -1), (0, 1))).movedim(0, -1)


def hermitian_eigvalsh_2x2(A):
    """Ascending eigenvalues ``(..., 2)`` of Hermitian ``A (..., 2, 2)``."""
    return _eigvalsh_trailing(A)


def hermitian_eigvalsh_3x3(A):
    """Ascending eigenvalues ``(..., 3)`` of Hermitian ``A (..., 3, 3)``
    (:func:`hermitian_eigvalsh_planes`' closed form)."""
    return _eigvalsh_trailing(A)


def batched_eigvalsh(A):
    """Ascending eigenvalues of batched Hermitian matrices; closed forms for
    n <= 3, K3 otherwise (:func:`~.eigh_kernel.batched_eigh`: the kernel
    on the card, ``torch.linalg.eigvalsh`` at float64 arithmetic on the
    CPU)."""
    n = A.shape[-1]
    if n == 1:
        return A[..., 0].real
    if n <= 3:
        return _eigvalsh_trailing(A)
    return batched_eigh(A, vectors=False)


def batched_log_abs_det(A):
    """``log |det A|`` for batched matrices, closed form for n <= 3."""
    if A.shape[-1] <= 3:
        return torch.log(torch.abs(batched_det(A)))
    return torch.linalg.slogdet(A).logabsdet


def matmul_small(A, B):
    """Batched matmul on trailing ``n x n`` axes as unrolled products of
    entries for n <= 3; ``@`` otherwise."""
    n = A.shape[-1]
    if n > 3 or B.shape[-2] != n:
        return A @ B
    rows = [
        torch.stack([_sum(A[..., i, k] * B[..., k, j] for k in range(n)) for j in range(B.shape[-1])], dim=-1)
        for i in range(n)
    ]
    return torch.stack(rows, dim=-2)


def blockwise_inv(A):
    """Inverse of batched ``(..., n, n)`` matrices with even ``n`` and ``n / 2
    <= 3`` by the 2 x 2-block Schur complement, each half-size block by its
    closed form; ``torch.linalg.inv`` otherwise.  The leading ``n / 2``
    block must be invertible."""
    n = A.shape[-1]
    h = n // 2
    if n % 2 != 0 or h > 3:
        return torch.linalg.inv_ex(A).inverse
    A11, A12 = A[..., :h, :h], A[..., :h, h:]
    A21, A22 = A[..., h:, :h], A[..., h:, h:]
    inv11 = batched_inv(A11)
    B = inv11 @ A12  # A11^-1 A12
    invS = batched_inv(A22 - A21 @ B)  # the Schur complement's inverse
    C = A21 @ inv11  # A21 A11^-1
    top_right = -B @ invS
    bottom_left = -invS @ C
    top_left = inv11 - top_right @ C
    return torch.cat([torch.cat([top_left, top_right], dim=-1), torch.cat([bottom_left, invS], dim=-1)], dim=-2)


# Compact Hermitian planes: a Hermitian (n, n, ...) field stored as n^2 real
# planes -- the n diagonal planes, then an (re, im) pair per off-diagonal
# c < d (the ``ops.ip_components._plane_index`` order, the layout of the
# solvers' pair-product planes).  Half the memory traffic of complex
# (n, n, ...) planes for every Hermitian intermediate of the covariance-domain
# chains (X^, X^-1 and X^-1 X X^-1 in ``models/nmf.py``; IPSDTA's R, R^-1 and
# R^-2 in ``models/ipsdta.py``).


def _n_of(planes):
    return int(round(planes.shape[0] ** 0.5))


def compact_entry(planes, c, d):
    """The complex ``(c, d)`` entry of a Hermitian field stored as compact
    real planes ``(n^2, ...)``."""
    from .ip_components import _plane_index

    index, _ = _plane_index(_n_of(planes))
    if c == d:
        p = planes[index[("re", c, c)]]
        return torch.complex(p, torch.zeros_like(p))
    if c < d:
        return torch.complex(planes[index[("re", c, d)]], planes[index[("im", c, d)]])
    return torch.complex(planes[index[("re", d, c)]], -planes[index[("im", d, c)]])


def hermitian_compact_from_entries(entry, n):
    """Compact real planes from a complex entry function, evaluated once per
    entry of the upper triangle (it must describe a Hermitian field)."""
    from .ip_components import _plane_index

    _, order = _plane_index(n)
    upper = {(c, d): entry(c, d) for _, c, d in order}
    return torch.stack([upper[c, d].real if kind == "re" else upper[c, d].imag for kind, c, d in order])


def expand_hermitian_compact(planes):
    """Compact real planes ``(n^2, ...)`` -> complex planes ``(n, n, ...)``."""
    n = _n_of(planes)
    return torch.stack([torch.stack([compact_entry(planes, c, d) for d in range(n)]) for c in range(n)])


def hermitian_compact_from_planes(P):
    """Complex planes ``(n, n, ...)`` -> compact real planes ``(n^2, ...)``
    (reads the upper triangle only)."""
    return hermitian_compact_from_entries(lambda c, d: P[c, d], P.shape[0])


def _entries(planes, ridge=None):
    """All complex entries ``E[c][d]`` of a compact Hermitian field (of ``M
    + ridge I`` where ``ridge`` is given), each formed once."""
    n = _n_of(planes)
    E = [[compact_entry(planes, c, d) for d in range(n)] for c in range(n)]
    if ridge is not None:
        for c in range(n):
            E[c][c] = E[c][c] + ridge
    return E


def det_hermitian_compact(planes, ridge=None):
    """Real determinant of a compact Hermitian field (of ``M + ridge I``
    where ``ridge`` is given); closed forms for n <= 3."""
    n = _n_of(planes)
    if n == 1:
        return planes[0] if ridge is None else planes[0] + ridge
    if n == 2:
        a, dd, br, bi = planes[0], planes[1], planes[2], planes[3]
        if ridge is not None:
            a, dd = a + ridge, dd + ridge
        return a * dd - (br * br + bi * bi)
    if n == 3:
        (a, b, c), (d, e, f), (g, h, i) = _entries(planes, ridge)
        return (a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)).real
    raise ValueError("det_hermitian_compact: closed forms cover n <= 3, got {}".format(n))


def inv_hermitian_compact(planes, ridge=None, det=None):
    """Compact planes of ``(M + ridge I)^-1`` for compact Hermitian ``M``:
    the adjugate over the real determinant; n <= 3."""
    n = _n_of(planes)
    if det is None:
        det = det_hermitian_compact(planes, ridge=ridge)
    if n == 1:
        return (1.0 / det)[None]
    if n == 2:
        a, dd, br, bi = planes[0], planes[1], planes[2], planes[3]
        if ridge is not None:
            a, dd = a + ridge, dd + ridge
        return torch.stack([dd, a, -br, -bi]) / det
    if n == 3:
        (a, b, c), (d, e, f), (g, h, i) = _entries(planes, ridge)
        # the adjugate of the general 3 x 3 (``inv_planes``); Hermitian, so
        # real diagonals and the upper triangle's (re, im)
        adj00 = (e * i - f * h).real
        adj11 = (a * i - c * g).real
        adj22 = (a * e - b * d).real
        adj01 = c * h - b * i
        adj02 = b * f - c * e
        adj12 = c * d - a * f
        return (
            torch.stack([adj00, adj11, adj22, adj01.real, adj01.imag, adj02.real, adj02.imag, adj12.real, adj12.imag])
            / det
        )
    raise ValueError("inv_hermitian_compact: closed forms cover n <= 3, got {}".format(n))


def sandwich_hermitian_compact(a_planes, x_planes):
    """Compact planes of ``A X A`` for compact Hermitian ``A`` and ``X``
    (Hermitian: ``(AXA)^H = AXA``), as ``A (X A)``: n^3 + n^2 (n + 1) / 2
    complex products over the planes."""
    n = _n_of(a_planes)
    A, X = _entries(a_planes), _entries(x_planes)
    XA = [[_sum(X[a][b] * A[b][d] for b in range(n)) for d in range(n)] for a in range(n)]
    return hermitian_compact_from_entries(lambda c, d: _sum(A[c][a] * XA[a][d] for a in range(n)), n)


def power_hermitian_compact(planes, power, eps=0.0):
    """Compact planes of the spectral power ``M^power`` of a compact
    Hermitian 2 x 2 field: ``algorithm.linalg._power_2x2``'s scale-invariant
    divided differences (and its ``eps`` eigenvalue clip) as elementwise ops
    over the planes."""
    n = _n_of(planes)
    if n != 2:
        raise ValueError("power_hermitian_compact: closed form covers n == 2, got {}".format(n))
    a, d, br, bi = planes[0], planes[1], planes[2], planes[3]
    # a spectral-radius bound s factored out: f(M) = f(s (M / s)), the clip
    # carried as eps / s
    s = (torch.abs(a) + torch.abs(d)) / 2 + torch.sqrt(br * br + bi * bi)
    s = torch.clamp(s, min=torch.finfo(s.dtype).tiny)
    an, dn, brn, bin_ = a / s, d / s, br / s, bi / s
    mean = (an + dn) / 2
    det = an * dn - (brn * brn + bin_ * bin_)
    rad = torch.sqrt(torch.clamp(mean**2 - det, min=0.0))
    l1, l2 = mean + rad, mean - rad  # eigenvalues of M / s, O(1)
    ca, cb = power_coefficients_2x2(l1, l2, power, eps / s)
    # f(M) = ca (M / s) + cb I, on the compact planes
    return s**power * torch.stack([ca * an + cb, ca * dn + cb, ca * brn, ca * bin_])


def power_coefficients_2x2(l1, l2, power, floor):
    """``(ca, cb)`` with ``f(M) = ca M + cb I`` for a Hermitian 2 x 2 ``M`` of
    eigenvalues ``l1 >= l2`` and ``f(w) = max(w, floor)^power`` (0 where
    that is not positive, ``floor`` a tensor); a degenerate spectrum gives
    ``f(l1) I``."""

    def f(w):
        w = torch.maximum(w, floor)
        return torch.where(w > 0, torch.where(w > 0, w, 1.0) ** power, 0.0)

    f1, f2 = f(l1), f(l2)
    gap = l1 - l2
    scale = torch.clamp(torch.maximum(torch.abs(l1), torch.abs(l2)), min=1e-30)
    safe = gap > 1e-6 * scale
    gap_safe = torch.where(safe, gap, 1.0)
    ca = torch.where(safe, (f1 - f2) / gap_safe, 0.0)
    cb = torch.where(safe, (f2 * l1 - f1 * l2) / gap_safe, f1)
    return ca, cb


def solve_riccati_hermitian_compact(A_planes, B_planes, eps=1e-12):
    """Compact planes of the Hermitian PSD solution of ``H A H = B``, ``H =
    A^-1/2 (A^1/2 B A^1/2)^1/2 A^-1/2``, for 2 x 2 operands (the planes form
    of ``algorithm.linalg.solve_riccati``; every sandwich is Hermitian by
    construction)."""
    A_sqrt = power_hermitian_compact(A_planes, 0.5, eps=0.0)
    A_invsqrt = power_hermitian_compact(A_planes, -0.5, eps=eps)
    M = sandwich_hermitian_compact(A_sqrt, B_planes)
    M_sqrt = power_hermitian_compact(M, 0.5, eps=0.0)
    return sandwich_hermitian_compact(A_invsqrt, M_sqrt)


def hermitian_compact_from_trailing(M):
    """Compact real planes ``(n^2, ...)`` of the upper triangle of a
    Hermitian field with trailing matrix axes ``M (..., n, n)``."""
    return hermitian_compact_from_planes(M.movedim((-2, -1), (0, 1)))


def compact_pair_weights(n, like):
    """``w (n^2,)`` with ``tr(A B) = sum_p w_p A_p B_p`` for compact
    Hermitian A, B: the diagonal planes weigh 1, each off-diagonal (re, im)
    plane 2."""
    return torch.cat([like.new_ones((n,)), like.new_full((n * n - n,), 2.0)])


def expand_hermitian_compact_trailing(small, n):
    """Trailing-compact real ``(..., n^2)`` -> complex ``(..., n, n)`` (the
    small per-(bin, basis) matrices of a frame contraction)."""
    return expand_hermitian_compact(small.movedim(-1, 0)).movedim((0, 1), (-2, -1))


def trace_hermitian_compact(planes):
    """Real trace of a compact Hermitian field ``(n^2, ...) -> (...)``: the
    sum of its ``n`` diagonal planes."""
    tr = planes[0]
    for i in range(1, _n_of(planes)):
        tr = tr + planes[i]
    return tr


def eigvalsh_hermitian_compact(planes):
    """Eigenvalues (ascending, stacked leading) of a compact Hermitian field
    ``(n^2, ...) -> (n, ...)``, n <= 3: :func:`hermitian_eigvalsh_planes`'
    closed forms, ``|b|^2`` read from the (re, im) planes."""
    n = _n_of(planes)
    if n == 1:
        return planes[:1]
    if n == 2:
        a, d, br, bi = planes[0], planes[1], planes[2], planes[3]
        mean = (a + d) / 2
        rad = torch.sqrt(((a - d) / 2) ** 2 + br * br + bi * bi)
        return torch.stack([mean - rad, mean + rad])
    if n != 3:
        raise ValueError("eigvalsh_hermitian_compact: closed forms cover n <= 3, got {}".format(n))
    q = (planes[0] + planes[1] + planes[2]) / 3
    p1 = _sum(planes[i] ** 2 for i in range(3, 9))
    p2 = _sum((planes[i] - q) ** 2 for i in range(3)) + 2 * p1
    degenerate = p2 <= 0
    p = torch.sqrt(torch.where(degenerate, 1.0, p2) / 6)
    # det((M - q I) / p) = det(M - q I) / p^3, real for a Hermitian M
    r = torch.clamp(det_hermitian_compact(planes, ridge=-q) / (2 * p**3), -1.0, 1.0)
    phi = torch.arccos(r) / 3
    e_hi = q + 2 * p * torch.cos(phi)
    e_lo = q + 2 * p * torch.cos(phi + 2 * math.pi / 3)
    e_mid = 3 * q - e_hi - e_lo
    return torch.where(degenerate, q, torch.stack([e_lo, e_mid, e_hi]))


def add_diag_hermitian_compact(planes, s):
    """The real plane ``s (...)`` added to the diagonal planes of a compact
    Hermitian field ``(n^2, ...)``."""
    n = _n_of(planes)
    return torch.cat([planes[:n] + s[None], planes[n:]])


def psd_parts_hermitian_compact(planes, eps=1e-12):
    """:func:`psd_parts_planes` on a compact Hermitian field (hermitisation
    is implicit in the storage): ``(to_psd(M), eigenvalues of to_psd(M))``."""
    w = eigvalsh_hermitian_compact(planes)
    shift = eps * trace_hermitian_compact(planes) - torch.clamp(w.amin(dim=0), max=0.0)
    return add_diag_hermitian_compact(planes, shift), w + shift[None]


def psd_inv_hermitian_compact(planes, eps=1e-12, psd=True):
    """Adjugate inverse of a compact Hermitian field over its real
    determinant, with the reference's trailing ``to_psd`` of the inverse
    where ``psd`` is set (the input is PSD already, so that is the ``eps
    trace`` ridge)."""
    inv = inv_hermitian_compact(planes)
    if psd:
        inv = add_diag_hermitian_compact(inv, eps * trace_hermitian_compact(inv))
    return inv


def square_hermitian_compact(planes):
    """Compact planes of ``M M`` for a compact Hermitian ``M`` (Hermitian:
    ``(M M)^H = M M``)."""
    n = _n_of(planes)
    E = _entries(planes)
    return hermitian_compact_from_entries(lambda c, d: _sum(E[c][k] * E[k][d] for k in range(n)), n)
