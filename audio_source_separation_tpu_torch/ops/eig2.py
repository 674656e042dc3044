"""Closed-form 2 x 2 eigendecompositions for the IP2 / pairwise update.

The reference's IP2 update (``bss/iva.py:578-588``) calls a general complex
``np.linalg.eig`` on the 2 x 2 matrices ``V_n^{-1} V_m``.  A 2 x 2
eigenproblem has a closed form (the characteristic polynomial and one
square root), elementwise over the bins.
"""

import torch


def eig2x2_planes(a, b, c, d):
    """Eigendecomposition of the 2 x 2 matrices ``[[a, b], [c, d]]`` given
    entry by entry as ``(...,)`` tensors.

    Returns ``((lam1, lam2), (v1, v2))``: eigenvalues in descending order of
    real part, each eigenvector a pair of ``(...,)`` tensors of unit norm.
    A diagonal matrix falls back to the basis vectors.
    """
    tr = a + d
    det = a * d - b * c
    disc = torch.sqrt((tr * tr - 4 * det).to(torch.promote_types(tr.dtype, torch.complex64)))
    lam1 = (tr + disc) / 2  # the principal root has Re >= 0: the larger real part
    lam2 = (tr - disc) / 2

    def eigvec(lam):
        # (A - lam I) v = 0: v = [b, lam - a] unless that row degenerates,
        # then v = [lam - d, c]; for a diagonal A, a basis vector
        use_row1 = torch.abs(b) + torch.abs(lam - a) > torch.abs(c) + torch.abs(lam - d)
        v0 = torch.where(use_row1, b, lam - d)
        v1 = torch.where(use_row1, lam - a, c)
        degenerate = (torch.abs(v0) + torch.abs(v1)) == 0
        near_a = torch.abs(lam - a) <= torch.abs(lam - d)
        one, zero = torch.ones_like(v0), torch.zeros_like(v0)
        v0 = torch.where(degenerate, torch.where(near_a, one, zero), v0)
        v1 = torch.where(degenerate, torch.where(near_a, zero, one), v1)
        norm = torch.sqrt(torch.abs(v0) ** 2 + torch.abs(v1) ** 2)
        return (v0 / norm, v1 / norm)

    return (lam1, lam2), (eigvec(lam1), eigvec(lam2))


def eig2x2(A):
    """Eigendecomposition of batched 2 x 2 (complex) matrices ``A (..., 2, 2)``.

    Returns ``(eigvals (..., 2), eigvecs (..., 2, 2))`` with unit
    eigenvectors in columns (the ``np.linalg.eig`` convention) and the
    eigenvalues in descending order of real part (the order IP2 consumes).
    """
    (lam1, lam2), (v1, v2) = eig2x2_planes(A[..., 0, 0], A[..., 0, 1], A[..., 1, 0], A[..., 1, 1])
    eigvals = torch.stack([lam1, lam2], dim=-1)
    eigvecs = torch.stack([torch.stack(v1, dim=-1), torch.stack(v2, dim=-1)], dim=-1)
    return eigvals, eigvecs


def generalized_eig2x2_descending_planes(Vm, Vn):
    """:func:`generalized_eig2x2_descending` with ``Vm``, ``Vn`` as nested
    lists ``[a][b]`` of ``(...,)`` tensors; returns ``(v_max, v_min)`` as
    pairs of tensors."""
    det = Vn[0][0] * Vn[1][1] - Vn[0][1] * Vn[1][0]
    inv = [[Vn[1][1] / det, -Vn[0][1] / det], [-Vn[1][0] / det, Vn[0][0] / det]]
    VV = [[inv[i][0] * Vm[0][j] + inv[i][1] * Vm[1][j] for j in range(2)] for i in range(2)]
    _, (v1, v2) = eig2x2_planes(VV[0][0], VV[0][1], VV[1][0], VV[1][1])
    return v1, v2


def generalized_eig2x2_descending(Vm, Vn):
    """Eigenvectors of ``V_n^{-1} V_m`` for batched 2 x 2 Hermitian pairs
    ``(..., 2, 2)``, by descending eigenvalue: ``(v_max (..., 2), v_min
    (..., 2))``, the rows the reference takes from ``np.linalg.eig`` and a
    sort (``bss/iva.py:578-584``)."""
    planes = [[[V[..., i, j] for j in range(2)] for i in range(2)] for V in (Vm, Vn)]
    v1, v2 = generalized_eig2x2_descending_planes(*planes)
    return torch.stack(v1, dim=-1), torch.stack(v2, dim=-1)
