"""Kernel K3: a batched Hermitian (or real symmetric) eigensolver.

``batched_eigh(H)`` is ``torch.linalg.eigh`` of ``(..., n, n)`` matrices
(complex64, complex128, float32, float64; the lower triangle is read):
the eigenvalues ascending, at the real type, and optionally the
eigenvectors, at ``H``'s type; NaN for every eigenvalue and vector of a
matrix with a non-finite entry, and on the card of one that has not
converged after ``MAX_SWEEPS`` sweeps.  It computes at float64 whatever the type:
cuSOLVER's batched single-precision Jacobi fails to converge on some of the
block-PSD models' small blocks where the double one does not.

No Pallas kernel stands behind it.  It is the port's counterpart of the
eigh that XLA compiles into the JAX package's jitted scan: on the card
``torch.linalg.eigh`` reads cuSOLVER's status on the host, so a step that
calls it cannot be captured as a CUDA graph (:mod:`~..runtime.graph`), and
this kernel reads nothing on the host.  It is CUDA C++, not Triton: its
per-matrix rotation sweeps on complex data, with each matrix held in shared
memory (or a block's workspace), are neither an elementwise pass nor a reduction.

Routes:

* a CPU tensor: :func:`batched_eigh_plain` (``torch.linalg.eigh`` at
  float64 or complex128, cast back).  A float64 or complex128 input gives
  the bits a direct ``torch.linalg.eigh`` call gives; a float32 or
  complex64 one is computed at double precision and rounded, and a matrix
  with a non-finite entry gives NaN where ``torch.linalg.eigh`` raises;
* a CUDA tensor: the hand-written kernel in ``csrc/batched_eigh.cu`` (its
  source note gives the bound and the design), one launch a call at any
  batch and any ``1 <= n <= MAX_N``, laid out by :func:`k3_launch_plan`:
  each matrix in shared memory up to ``SHARED_N`` at complex128 (further at
  the other types), past it in a device workspace.  The card never runs the
  plain version; past ``MAX_N`` the plan raises.

Eigenvector phase: LAPACK fixes none, and K3 makes each vector's entry of
largest modulus (the first such) real and positive.  Every caller in the
port uses the vectors in products that no phase changes (``V f(w) V^H``,
``diag(G^H X G)``, the pencil's ``G diag(1/w) G^H``), so the two routes
agree there wherever their eigenvalues do.
"""

import ctypes
import functools
from collections import namedtuple

import torch

from . import _build
from ..runtime.cost_model import charged
from ..runtime.spanlog import watch

# the largest n whose A and V fit a block's shared memory at complex128
# with vectors (32 m^2 bytes, m = n rounded up to even, of the 232,448 a
# block may take); past it a block keeps its matrix in a device workspace
SHARED_N = 84
# the largest n the kernel takes (one block's workspace slot at complex128
# with vectors: 32 n^2 bytes, 128 MiB)
MAX_N = 2048
# up to this n a group of at most a warp's lanes takes one matrix, several
# matrices to a block of WARP_THREADS; above it a block of BLOCK_THREADS
# takes one
WARP_N = 16
WARP_THREADS = 128
BLOCK_THREADS = 256
# the sweeps a matrix may take before it gives NaN (Jacobi converges
# quadratically: 4-10 at n = 64 on the matrices of the solvers)
MAX_SWEEPS = 30
SMEM_LIMIT = 232_448  # shared memory a Hopper block may opt into, bytes
# the workspace route: at most this many blocks (two of BLOCK_THREADS on each
# of an H100's 132 SMs) walk the batch, and their slots at most this many bytes
WORKSPACE_BLOCKS = 264
WORKSPACE_LIMIT = 1 << 28

# blocks per torch.linalg.eigh call on the plain route: cuSOLVER's batched
# solver (cusolverDnXsyevBatched under PyTorch 2.11, CUDA 12.8, on an H100)
# refuses 32,768 or more 9 x 9 blocks at its workspace query, complex64 or
# complex128, and takes 8192; the 256-block geometry's R holds 240,128
EIGH_CHUNK = 8192

# the C entry's type codes
_DTYPES = {torch.float32: 0, torch.float64: 1, torch.complex64: 2, torch.complex128: 3}


def batched_eigh_plain(H, vectors=True):
    """Plain PyTorch version of K3: ``torch.linalg.eigh`` (``eigvalsh``
    without ``vectors``) at float64 or complex128 in chunks of
    ``EIGH_CHUNK`` matrices, cast back, NaN for a matrix with a non-finite
    entry (where ``torch.linalg.eigh`` would raise)."""
    n = H.shape[-1]
    wide = torch.complex128 if H.is_complex() else torch.float64
    finite = torch.isfinite(H).all(dim=-1).all(dim=-1)
    Hd = torch.where(finite[..., None, None], H, 0).to(wide).reshape(-1, n, n)
    nan = H.new_full((), float("nan"), dtype=H.real.dtype)
    if not vectors:
        w = torch.cat([torch.linalg.eigvalsh(part) for part in Hd.split(EIGH_CHUNK)])
        return torch.where(finite[..., None], w.reshape(H.shape[:-1]).to(nan.dtype), nan)
    w, v = (torch.cat(parts) for parts in zip(*(torch.linalg.eigh(part) for part in Hd.split(EIGH_CHUNK))))
    w = torch.where(finite[..., None], w.reshape(H.shape[:-1]).to(nan.dtype), nan)
    return w, torch.where(finite[..., None, None], v.reshape(H.shape).to(H.dtype), nan)


K3Plan = namedtuple("K3Plan", "group threads per_block blocks smem_bytes workspace_bytes")
K3Plan.__doc__ = """How K3 is launched for a batch of ``n x n`` matrices.

``group`` threads take one matrix (a power of two up to 32, lanes of one
warp; or ``threads``, the whole block), ``per_block`` matrices to a block of
``threads``, ``blocks`` blocks walking the batch, ``smem_bytes`` of dynamic
shared memory a block, or (0 of them) ``workspace_bytes`` of device
workspace, one slot a block.
"""


def _next_pow2(k):
    return 1 << max(0, (k - 1).bit_length())


def group_words(n, complex_, vectors):
    """float64 words of one matrix's slot (``group_words`` of
    ``csrc/batched_eigh.cu``): A and V at float64 on ``m x m`` (``m`` = n
    rounded up to even), five words a pair, three an index, the norm, and
    the ints, two to a word, rounded up to even."""
    m = n + n % 2
    words = (2 if vectors else 1) * m * m * (2 if complex_ else 1) + 5 * (m // 2) + 3 * m + 1 + (m // 2 + 2 * m + 1) // 2
    return words + words % 2


@functools.lru_cache(maxsize=256)
def k3_launch_plan(n, batch, complex_=True, vectors=True):
    """The :class:`K3Plan` for ``batch`` matrices of order ``n``.

    ``n <= WARP_N``: a group of the fewest lanes (a power of two, at most
    32) that covers a round's ``n * m / 2`` element pairs in one pass,
    ``WARP_THREADS`` threads a block.  Above: one matrix to a block of
    ``BLOCK_THREADS``, in shared memory where its slot fits, else in a
    workspace slot of at most ``WORKSPACE_BLOCKS`` blocks that walk the
    batch.
    """
    if not 1 <= n <= MAX_N:
        raise ValueError("K3 takes 1 <= n <= {}, got n = {}".format(MAX_N, n))
    if batch < 0:
        raise ValueError("K3 needs a batch >= 0, got {}".format(batch))
    m = n + n % 2
    if n <= WARP_N:
        group = min(32, _next_pow2(n * (m // 2)))
        threads = WARP_THREADS
    else:
        group = threads = BLOCK_THREADS
    per_block = threads // group
    slot = group_words(n, complex_, vectors) * 8
    if per_block * slot <= SMEM_LIMIT:
        return K3Plan(group, threads, per_block, max(1, -(-batch // per_block)), per_block * slot, 0)
    blocks = max(1, min(batch, WORKSPACE_BLOCKS, WORKSPACE_LIMIT // slot))
    return K3Plan(group, threads, per_block, blocks, 0, blocks * slot)


def eigh_cost(n, batch, complex_, vectors, itemsize):
    """K3's compulsory ``(bytes, flops)`` for ``batch`` matrices of order
    ``n`` of ``itemsize``-byte elements: the matrices read once, the
    eigenvalues (and vectors) written once; LAPACK's dense count of an
    eigendecomposition (``runtime/cost_model.py``'s ``_linalg_eigh`` rule):
    ``9 n^3`` FLOPs a matrix with vectors, ``4/3 n^3`` without, four times
    that at a complex type.  Whatever runs it: a Jacobi method does more."""
    real_size = itemsize // 2 if complex_ else itemsize
    n_bytes = batch * (n * n * itemsize + n * real_size + (n * n * itemsize if vectors else 0))
    per = 9 * n**3 if vectors else 4 / 3 * n**3
    return n_bytes, per * batch * (4 if complex_ else 1)


def _entry():
    fn = _build.load("batched_eigh").batched_eigh
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong] + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def batched_eigh(H, vectors=True, sweeps=None):
    """K3: ``(w, V)`` (``w`` alone without ``vectors``) of Hermitian or real
    symmetric ``H (..., n, n)``.

    Args:
        H: the matrices; on CUDA any of the four types, made contiguous.
        vectors: whether to return the eigenvectors.
        sweeps: a diagnostic for the tests and ``chip_smoke.py``: on the
            card, an optional int32 tensor of one entry a matrix, which the
            kernel fills with the sweeps each took (the work the data
            needed; ``MAX_SWEEPS`` with NaN where a matrix did not converge).

    Inside a cost count (:mod:`~..runtime.cost_model`) a call is charged
    :func:`eigh_cost` on every route.
    """

    def cost():
        n = H.shape[-1]
        return eigh_cost(n, H.numel() // max(1, n * n), H.is_complex(), vectors, H.element_size())

    with charged("K3", cost):
        return _batched_eigh(H, vectors, sweeps)


def _batched_eigh(H, vectors, sweeps):
    if H.device.type == "cpu":
        return batched_eigh_plain(H, vectors)
    if H.device.type != "cuda":
        raise ValueError("batched_eigh: unsupported device {}".format(H.device))
    if H.ndim < 2 or H.shape[-1] != H.shape[-2] or H.dtype not in _DTYPES:
        raise ValueError("K3 takes (..., n, n) matrices of float32, float64, complex64 or complex128")
    n = H.shape[-1]
    H = H.contiguous()
    batch = H.numel() // max(1, n * n)
    if batch == 0:
        w = H.new_empty(H.shape[:-1], dtype=H.real.dtype)
        return (w, torch.empty_like(H)) if vectors else w
    plan = k3_launch_plan(n, batch, H.is_complex(), bool(vectors))
    w = torch.empty(H.shape[:-1], dtype=H.real.dtype, device=H.device)
    V = torch.empty_like(H) if vectors else None
    work = torch.empty(plan.workspace_bytes // 8, dtype=torch.float64, device=H.device) if plan.workspace_bytes else None
    if sweeps is not None and (sweeps.dtype != torch.int32 or sweeps.numel() != batch or sweeps.device != H.device):
        raise ValueError("K3's sweeps must be int32 with one entry a matrix on the input's device")
    status = _entry()(
        H.data_ptr(), w.data_ptr(), None if V is None else V.data_ptr(),
        None if sweeps is None else sweeps.data_ptr(), None if work is None else work.data_ptr(), batch, n,
        _DTYPES[H.dtype], int(bool(vectors)), plan.group, plan.threads, plan.blocks, MAX_SWEEPS,
        torch.cuda.current_stream(H.device).cuda_stream,
    )
    _build.check(status, "batched_eigh")
    batched_eigh.launches += 1
    return (w, V) if vectors else w


batched_eigh.launches = 0
watch("k3_launches", lambda: batched_eigh.launches)
