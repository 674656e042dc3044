"""One iteration of Sawada's full-rank multichannel NMF at C = S = 3 on a
``(3, F, T)`` complex mixture, with ``K`` bases: the basis, activation and
latent updates, the spatial update and the loss (the order of
``portbench/reference/mnmf_sawada_c3.py``).

Least bytes: the mixture read once; the state read and written once: the
spatial covariances ``H (F, S, C, C)`` at the complex type, the basis ``(F,
K)``, the activation ``(K, T)`` and the latent ``(S, K)`` at the real type;
the loss written.  The observed and model covariances, their inverses and
the trace terms are made from them inside the iteration, not carried.

Every Hermitian ``C x C`` matrix counts as its ``C^2`` real numbers (the
diagonal and the real and imaginary parts above it), and the observed
covariance ``x x^H`` as rank 1.  FLOPs per bin and frame, a real
multiply-add 2, a complex one 8, a division, square root, logarithm or
trigonometric function 1:

  * a model evaluation: ``(Z T V)_s``, ``2 K`` a source (60), and ``X^ =
    sum_s H_s (ZTV)_s`` on the 9 numbers, ``2 C^2`` a source (54): 114;
  * the inverse of ``X^ + eps I`` by the adjugate: the ridge (3), three
    real diagonal cofactors (5 each) and three complex off-diagonal ones
    (10 each), the determinant (10), its reciprocal and the 9 numbers
    scaled (10): 68;
  * ``u = X^-1 x`` (9 complex multiply-adds, 72) and the 9 numbers of ``u
    u^H = X^-1 X X^-1`` (three squared moduli, 3 each, and three complex
    products, 6 each: 27): 99;
  * the trace terms ``tr(X^-1 X X^-1 H_s)`` and ``tr(X^-1 H_s)``: a weighted
    sum over the 9 numbers each, ``2 C^2`` a source each: 108;
  * so one evaluation of the trace terms 114 + 68 + 99 + 108 = 389;
  * each MU update's two sums against the other factors over the frames
    (basis, latent) or the bins (activation), ``2 S K`` each: 120;
  * the basis update: the trace terms on the model that the previous loss
    formed (the first takes the initial loss's), 389 - 114, and its sums:
    395; the activation and latent updates: 389 + 120 = 509 each;
  * the spatial update: a model evaluation, its inverse and ``u u^H``
    (114 + 68 + 99) and the frame sums ``sum_t (ZTV)_s X^-1`` and ``sum_t
    (ZTV)_s X^-1 X X^-1``, ``2 C^2`` a source each (108): 389;
  * the loss, on a model evaluation of its own (114): the closed-form
    eigenvalues of ``X^`` (60: the mean, the deviations, the cubic's
    determinant, an arccosine and two cosines), the PSD shift and ridge
    (4), the inverse (68), ``tr(X' X^'^-1)`` (18) and the three logarithms
    and the sum (7): 271.

395 + 2 * 509 + 389 + 271 = 2073 in all.  The Riccati solves are per
(bin, source), ``O(F S C^3)``, the latent's per (source, basis), and both
are left out, as is the observed covariance's log-determinant, a constant
of the data.
"""

C = S = 3
FLOPS_PER_BIN_FRAME = 395 + 2 * 509 + 389 + 271


def least_work(F, T, n_basis=10, x_itemsize=8):
    """``(bytes, flops)`` of one iteration; ``x_itemsize`` is the complex
    element's size."""
    real = x_itemsize // 2
    state = F * S * C * C * x_itemsize + F * n_basis * real + n_basis * T * real + S * n_basis * real
    n_bytes = C * F * T * x_itemsize + 2 * state + real
    return n_bytes, FLOPS_PER_BIN_FRAME * F * T
