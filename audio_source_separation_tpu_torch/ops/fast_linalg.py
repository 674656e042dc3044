"""Closed-form small-matrix determinant and inverse.

Planes layout: the matrix axes lead (``P (n, n, ...batch)``), so every slice
``P[i, j]`` is a whole plane over the batch axes (bins, in practice).
Projection-back and the IP2 planes update use these.  The trailing-axes
forms below (``A (..., n, n)``) serve the matrix-layout IP, IP2 and NLL
paths.
"""

import torch


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


def batched_log_abs_det(A):
    """``log |det A|`` for batched matrices, closed form for n <= 3."""
    if A.shape[-1] <= 3:
        return torch.log(torch.abs(batched_det(A)))
    return torch.linalg.slogdet(A).logabsdet
