"""Closed-form small-matrix determinant and inverse in planes layout.

The matrix axes lead (``P (n, n, ...batch)``), so every slice ``P[i, j]`` is
a whole plane over the batch axes (bins, in practice).  Projection-back uses
these for its per-bin N x N Gram solve.
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
