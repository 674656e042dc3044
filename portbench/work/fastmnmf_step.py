"""One FastMNMF iteration at C = M = S = 2 on a ``(2, F, T)`` complex
mixture, with ``K`` bases: the basis, activation and gain updates, the
diagonaliser's covariances and rows, the power normalisation, ``|Q x|^2``
afresh and the loss (the order of ``portbench/reference/fastmnmf_c2.py``).

Least bytes: the mixture read once; the state read and written once: the
basis ``(S, F, K)``, the gains ``(S, F, M)`` and the activation ``(S, K,
T)`` at the real type, the diagonaliser ``(F, M, C)`` at the complex type;
the loss written.  ``|Q x|^2``, the model and the ratios are made from them
inside the iteration, not carried.

FLOPs per bin and frame, a multiply-add 2, a division, square root or
logarithm 1:

  * the model ``y~_m = sum_s (W H)_s g_sm``: ``2 S K`` for ``lambda = W H``
    and ``2 S M`` for ``y~``, 48, three times: before the activation and
    before the gains, from the factors each update leaves, and once from
    the normalised factors, which the loss and the next iteration's basis
    update share (the first basis update takes the initial loss's model);
  * each of the basis and activation updates: ``x~ / y~^2`` and ``1 / y~``,
    3 a channel (6); both summed over channels against the gains, ``2 M``
    each a source (16); both contracted with ``H`` over frames (the basis)
    or with ``W`` over bins (the activation), ``2 K`` each a source (80):
    102 each;
  * the gains: the ratios (6) and ``sum_t lambda x~/y~^2``, ``sum_t lambda /
    y~``, ``2`` each a source and channel (16): 22;
  * the diagonaliser: ``y~`` from the new gains with ``lambda`` kept (8),
    ``1 / y~`` (2), the pair-product planes (12) and their weighted sums
    into the M covariances (16, as ``portbench/work/cov_step.py``): 38;
  * ``|Q x|^2``: two complex rows applied (28) and their squared moduli
    (6): 34;
  * the loss, on the model above: ``x~ + eps``, ``y~ + eps``, the ratio,
    the logarithm, their sum and the running sum, 6 a channel: 12.

454 in all.  The per-bin work (the 2 x 2 row solves, the guard, the
normalisation chain) and the per-frame work (the activation's scaling) are
``O(F K + K T)`` and left out.
"""

C = S = 2
FLOPS_PER_BIN_FRAME = 3 * 48 + 2 * 102 + 22 + 38 + 34 + 12


def least_work(F, T, n_basis=10, x_itemsize=8):
    """``(bytes, flops)`` of one iteration; ``x_itemsize`` is the complex
    element's size."""
    real = x_itemsize // 2
    state = S * F * n_basis * real + S * F * C * real + S * n_basis * T * real + F * C * C * x_itemsize
    n_bytes = C * F * T * x_itemsize + 2 * state + real
    return n_bytes, FLOPS_PER_BIN_FRAME * F * T
