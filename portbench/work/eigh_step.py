"""One launch of the batched Hermitian eigensolver (the program's K3) on
``batch`` matrices of order ``n``, with the eigenvectors, as Sawada's
spatial update takes it for each matrix power of its Riccati solve.

Least bytes: the matrices read once, the eigenvalues (at the real type)
and the eigenvectors written once.

FLOPs: LAPACK's dense count of an eigendecomposition with vectors, ``9
n^3`` a matrix, four times that at a complex type; whatever runs it (a
Jacobi method does more).  The program's ``eigh_cost`` as it stood when
this was written.
"""


def least_work(n, batch, itemsize=8, complex_=True):
    """``(bytes, flops)``; ``itemsize`` is the element's size (8:
    complex64)."""
    real = itemsize // 2 if complex_ else itemsize
    n_bytes = batch * (2 * n * n * itemsize + n * real)
    return n_bytes, 9 * n**3 * batch * (4 if complex_ else 1)
