"""Count the bytes and FLOPs of what an eager PyTorch program dispatches.

:class:`CostCounter` is a ``TorchDispatchMode``: inside ``with counter:``
every aten op runs as usual and is charged by these rules.

* **Bytes.**  An op adds the bytes of each distinct tensor it reads, plus
  each tensor it writes.  A broadcast (stride-0) input counts at its
  distinct elements only.
* **Free ops** count nothing: views and aliases (every op whose schema
  returns an alias of an input, so ``view``, a ``reshape`` that is a view,
  ``expand``, ``transpose``, ``select``, ``slice``, ``as_strided``,
  ``_conj``, ``view_as_real``, ``alias``, ``detach``), the in-place view
  ops (``transpose_``, ``squeeze_``, ...), ``_unsafe_view``,
  ``_local_scalar_dense`` (``.item()``), ``_linalg_check_errors`` and
  ``empty`` (with ``empty_like``, ``empty_strided``, ``new_empty``).
* **Materialising ops** count in full: ``clone`` (a ``contiguous`` copy;
  the ``resolve_conj`` of a tensor with the conjugate bit set), ``copy_``
  and ``_to_copy``.  An in-place op counts its read and its write of
  ``self``; ``copy_``, ``fill_`` and ``zero_`` only write it, and an
  ``out=`` argument is only written.
* **FLOPs, the matmul family** (``mm``, ``bmm``, ``addmm``, ``baddbmm``:
  ``einsum`` and ``matmul`` lower to them): ``torch.utils.flop_counter``'s
  formulas (``2 m n k``), times 4 when the operands are complex, since a
  complex multiply-add is 8 real FLOPs.
* **FLOPs, linear algebra**: a dense count per matrix of order ``n``
  (LAPACK's operation counts, LAPACK Working Note 41; Golub and Van Loan,
  *Matrix Computations*, for ``eigh`` and ``svd``), times the batch, times 4
  at a complex type: ``linalg_lu_factor_ex``, ``_linalg_det`` and
  ``_linalg_slogdet`` ``2/3 n^3`` (an LU factorisation); ``linalg_inv_ex``
  ``2 n^3`` (LU, then the inverse from it); ``_linalg_solve_ex``
  ``2/3 n^3 + 2 n^2 k`` for ``k`` right-hand sides;
  ``linalg_cholesky_ex`` ``1/3 n^3``; ``_linalg_eigh`` ``9 n^3`` with
  eigenvectors, ``4/3 n^3`` without; ``linalg_solve_triangular``
  ``n^2 k``; ``_linalg_svd`` of an ``m x n`` matrix (``m >= n``) ``4 m n^2
  - 4/3 n^3`` for the values, ``4 m^2 n + 8 m n^2 + 9 n^3`` with full
  vectors and ``14 m n^2 + 8 n^3`` with thin ones.  Under a dispatch mode
  PyTorch takes the differentiable route of ``eigvalsh`` and ``svdvals``,
  which computes the vectors too: what runs is counted.
* **FLOPs, FFTs**: ``5 n log2 n`` a complex transform of ``n`` points
  (``_fft_c2c``), half that a real one (``_fft_r2c``, ``_fft_c2r``).
* **FLOPs, data movement** (copies, factories, fills, concatenation,
  padding, indexing): none.
* **FLOPs, every other op** (elementwise ops and reductions): 1 FLOP a real
  element, 2 a complex one, of the largest tensor it reads or writes.

A kernel launched through ``ctypes`` is invisible to the mode, so its
wrapper charges its compulsory cost once a call inside :func:`charged`,
which also stops the count of the wrapper's own ops: a call charges the
same on the CPU, where the wrapper runs the kernel's plain version, and on
the card.  Counting what is dispatched means that the count follows the
device: ``torch.linalg`` may dispatch other ops on the CPU than on CUDA,
and a solver may take another route on either.
"""

import contextlib
import math

import torch
from torch.utils._python_dispatch import TorchDispatchMode, _get_current_dispatch_mode_stack
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

aten = torch.ops.aten

FREE = frozenset((
    aten._unsafe_view, aten._local_scalar_dense, aten._linalg_check_errors,
    aten.empty, aten.empty_like, aten.empty_strided, aten.new_empty, aten.new_empty_strided,
))
# in-place ops that write ``self`` without reading it
WRITE_ONLY = frozenset((aten.copy_, aten.fill_, aten.zero_))
MATMUL = frozenset((aten.mm, aten.bmm, aten.addmm, aten.baddbmm))
DATA_MOVEMENT = frozenset((
    aten.clone, aten.copy_, aten._to_copy, aten.lift_fresh_copy, aten.cat, aten.stack,
    aten.fill_, aten.zero_, aten.zeros, aten.zeros_like, aten.ones, aten.ones_like, aten.full, aten.full_like,
    aten.new_zeros, aten.new_ones, aten.new_full, aten.scalar_tensor, aten.eye, aten.arange,
    aten.index, aten.index_select, aten.gather, aten.constant_pad_nd, aten.reflection_pad1d,
    aten.repeat, aten.flip, aten.roll, aten.tril, aten.triu, aten.diag_embed,
    aten.select_scatter, aten.slice_scatter, aten.index_put, aten.index_put_,
))


LINALG = frozenset((
    aten.linalg_lu_factor_ex, aten._linalg_det, aten._linalg_slogdet, aten.linalg_inv_ex, aten._linalg_solve_ex,
    aten.linalg_cholesky_ex, aten._linalg_eigh, aten.linalg_solve_triangular, aten._linalg_svd,
))
FFT = frozenset((aten._fft_c2c, aten._fft_r2c, aten._fft_c2r))


def _linalg_flops(packet, args, out):
    """The dense count of one op of ``LINALG`` (module docstring); whether
    vectors were computed is read from the outputs, empty where not."""
    A = args[0]
    n = A.shape[-1]
    batch = A.numel() // max(1, A.shape[-2] * n)
    if packet in (aten.linalg_lu_factor_ex, aten._linalg_det, aten._linalg_slogdet):
        per = 2 / 3 * n**3
    elif packet is aten.linalg_inv_ex:
        per = 2 * n**3
    elif packet is aten._linalg_solve_ex:
        B = args[1]
        k = 1 if B.ndim == A.ndim - 1 else B.shape[-1]
        per = 2 / 3 * n**3 + 2 * n**2 * k
    elif packet is aten.linalg_cholesky_ex:
        per = n**3 / 3
    elif packet is aten._linalg_eigh:
        vectors = out[1].numel() > 0
        per = 9 * n**3 if vectors else 4 / 3 * n**3
    elif packet is aten.linalg_solve_triangular:
        B = args[1]
        n = A.shape[-1]
        per = n**2 * B.shape[-1]
        batch = B.numel() // max(1, B.shape[-2] * B.shape[-1])
    elif packet is aten._linalg_svd:
        m, n = max(A.shape[-2:]), min(A.shape[-2:])
        U, Vh = out[0], out[2]
        if U.numel() == 0:
            per = 4 * m * n**2 - 4 / 3 * n**3
        elif max(U.shape[-1], Vh.shape[-2]) == m:  # full matrices
            per = 4 * m**2 * n + 8 * m * n**2 + 9 * n**3
        else:
            per = 14 * m * n**2 + 8 * n**3
    return per * batch * (4 if A.is_complex() else 1)


def _fft_flops(packet, args, out):
    """``5 n log2 n`` a complex transform of ``n`` points, half a real one."""
    # the real side holds the transform's length: c2r's output, else the input
    signal = out if packet is aten._fft_c2r else args[0]
    n = math.prod(signal.shape[d] for d in args[1])
    per = 5 * n * math.log2(n) if n > 1 else 0.0
    return per * (signal.numel() // max(1, n)) * (1.0 if packet is aten._fft_c2c else 0.5)


def _distinct_bytes(t):
    """Bytes of the distinct elements a read of ``t`` touches: a stride-0
    (broadcast) dimension counts once."""
    if t.numel() == 0:
        return 0
    return math.prod(s for s, st in zip(t.shape, t.stride()) if st != 0) * t.element_size()


def _key(t):
    return t.data_ptr(), t.dtype, tuple(t.shape), tuple(t.stride())


def _tensors(value):
    return [t for t in tree_flatten(value)[0] if isinstance(t, torch.Tensor)]


def _is_free(func):
    if func.overloadpacket in FREE or torch.Tag.inplace_view in func.tags:
        return True
    returns = func._schema.returns
    return bool(returns) and all(r.alias_info is not None and not r.alias_info.is_write for r in returns)


def op_cost(func, args, kwargs, out):
    """``(bytes, flops)`` of one aten op ``func(*args, **kwargs) -> out`` by
    the module's rules."""
    if _is_free(func):
        return 0, 0.0
    packet = func.overloadpacket
    reads, writes = {}, {}
    schema = func._schema.arguments
    pairs = list(zip(schema, args)) + [(a, kwargs[a.name]) for a in schema if a.name in kwargs]
    for arg, value in pairs:
        written = arg.alias_info is not None and arg.alias_info.is_write
        for t in _tensors(value):
            if written:
                writes[_key(t)] = t.numel() * t.element_size()
            if not written or not (arg.kwarg_only or packet in WRITE_ONLY):
                reads.setdefault(_key(t), _distinct_bytes(t))
    outputs = _tensors(out)
    for t in outputs:
        writes.setdefault(_key(t), t.numel() * t.element_size())
    n_bytes = sum(reads.values()) + sum(writes.values())

    if packet in DATA_MOVEMENT:
        return n_bytes, 0.0
    inputs = [t for _, value in pairs for t in _tensors(value)]
    if packet in MATMUL:
        complex_operands = any(t.is_complex() for t in inputs)
        return n_bytes, float(flop_registry[packet](*args, **kwargs, out_val=out)) * (4 if complex_operands else 1)
    if packet in LINALG:
        return n_bytes, float(_linalg_flops(packet, args, out))
    if packet in FFT:
        return n_bytes, float(_fft_flops(packet, args, out))
    return n_bytes, float(max((t.numel() * (2 if t.is_complex() else 1) for t in inputs + outputs), default=0))


class CostCounter(TorchDispatchMode):
    """Counts what runs inside ``with counter:`` by the module's rules.

    ``bytes`` and ``flops`` are the totals; ``charges`` the kernel calls
    charged by name (:func:`charged`); ``by_op`` ``[calls, bytes, flops]``
    by aten op, kernels as ``"kernel:<name>"``.
    """

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.flops = 0.0
        self.charges = {}
        self.by_op = {}
        self._paused = 0

    def _add(self, name, n_bytes, flops):
        self.bytes += n_bytes
        self.flops += flops
        row = self.by_op.setdefault(name, [0, 0, 0.0])
        row[0] += 1
        row[1] += n_bytes
        row[2] += flops

    def charge(self, kernel, n_bytes, flops):
        """Add one call of ``kernel`` at its cost."""
        self.charges[kernel] = self.charges.get(kernel, 0) + 1
        self._add("kernel:" + kernel, n_bytes, flops)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self._paused:
            self._add(str(func.overloadpacket), *op_cost(func, args, kwargs, out))
        return out


def active_counter():
    """The innermost :class:`CostCounter` in force, else ``None``."""
    for mode in reversed(_get_current_dispatch_mode_stack()):
        if isinstance(mode, CostCounter):
            return mode
    return None


@contextlib.contextmanager
def charged(kernel, cost):
    """A kernel wrapper's body: inside a count, none of its ops are
    counted, and if it returns, one call of ``kernel`` is charged at
    ``cost()``, its ``(bytes, flops)``.  Under a capture audit
    (:class:`~.graph.CaptureAudit`) its ops, which stand for one launch,
    are not audited.  Outside both it does nothing."""
    from .graph import active_audit

    counter = active_counter()
    modes = [m for m in (counter, active_audit()) if m is not None]
    for mode in modes:
        mode._paused += 1
    try:
        yield
    finally:
        for mode in modes:
            mode._paused -= 1
    if counter is not None:
        counter.charge(kernel, *cost())
