"""One AuxIVA-IP iteration at C = N = 2 on a ``(2, F, T)`` complex
mixture: the weights from the frame power sums, both weighted
covariances, the row update, the new rows' frame power sums and the loss.

Least bytes: the mixture read once; the ``(2, 2, F)`` complex demixing
rows read and written; the ``(2, T)`` real frame power sums read and
written; the log-determinant and the loss written.

FLOPs per bin and frame: 12 for the frame's real pair products
(``|x_0|^2``, ``|x_1|^2``, ``x_0 x_1^*``), 16 for their weighted sums into
the two sources' covariances, 28 to apply the two new complex rows, 6 for
the squared moduli and 2 to sum them over bins: 64.  The per-bin row
update is ``O(F)`` and left out.
"""


def least_work(F, T, x_itemsize=8):
    """``(bytes, flops)``; ``x_itemsize`` is the complex element's size."""
    real = x_itemsize // 2
    n_bytes = 2 * F * T * x_itemsize + 2 * 4 * F * x_itemsize + 2 * 2 * T * real + 2 * real
    return n_bytes, 64 * F * T
