"""One launch of the weighted covariance with per-bin weights (the
program's K1) on a ``(C, F, T)`` complex mixture and ``(N, F, T)`` real
weights, as FastMNMF's diagonaliser update takes it: ``U[p, f, n] = (1/T)
sum_t w[n, f, t] plane_p(f, t)`` over the ``C^2`` compact Hermitian planes
of the pair products ``x_c x_d^*``.

Least bytes: the mixture read once, the weights read once, the ``(C^2, F,
N)`` planes written once at the mixture's real type.

FLOPs per bin and frame: ``3 C^2`` for the pair-product planes (3 a
plane: a complex product, 6, gives the two planes of a pair above the
diagonal; a squared modulus, 3, a diagonal plane, counted as the others),
then ``2 C^2 N`` for the weighted sums into every plane of every weight
row.  The program's ``k1_cost`` as it stood when this was written.
"""


def least_work(C, N, F, T, x_itemsize=8, w_itemsize=4):
    """``(bytes, flops)``; ``x_itemsize`` is the complex element's size,
    ``w_itemsize`` the weights'."""
    n_bytes = C * F * T * x_itemsize + N * F * T * w_itemsize + C * C * F * N * (x_itemsize // 2)
    return n_bytes, F * T * (3 * C * C + 2 * C * C * N)
