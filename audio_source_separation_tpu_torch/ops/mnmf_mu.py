"""Kernel K5: FastMNMF's multiplicative-update sweeps with the model formed
inside the contractions.

With ``x = |Q x|^2 (M, F, T)``, the basis ``W (S, F, K)``, the gains ``g
(S, F, M)`` and the activations ``H (S, K, T)``, FastMNMF's MU sweeps
(``models/mnmf.py::FastMultichannelISNMF``) all read the model

    R[m, f, t] = max(sum_{s,k} W[s, f, k] g[s, f, m] H[s, k, t], eps)

and its ratios ``x / R^2`` and ``1 / R``.  ``fastmnmf_mu(entry, x, W, g, H,
eps)`` computes one of five results from them:

* ``"weights"``: ``1 / R (M, F, T)``, K1's per-bin weights;
* ``"basis"``: the new basis ``W sqrt(sum_m g E_num / max(sum_m g E_den,
  eps))`` from the frame statistics ``E_num = sum_t x / R^2 H`` and ``E_den
  = sum_t H / R`` (``(M, F, S, K)`` each);
* ``"gains"``: the new gains ``g sqrt(sum_k W E_num / max(sum_k W E_den,
  eps))`` from the same statistics;
* ``"activation"``: the new activations ``H sqrt(num / max(den, eps))``
  from the bin statistics ``num = sum_{m,f} x / R^2 W g`` and ``den =
  sum_{m,f} W g / R`` (``(S, K, T)`` each);
* ``"fit"``: the NLL's ``sum (x + eps) / (R' + eps) + log(R' + eps)``, with
  ``R'`` the model before the floor.

Under a mesh that shards the statistics' axis (frames for the basis and
gains, bins for the activations) the caller passes ``whole``, which makes
the partial sums whole (one all-reduce); the update then follows in
PyTorch from the whole sums, on the card in the kernel's own order, so
that a mesh of one gives the unsharded call's bits.

No Pallas kernel stands behind it: XLA fuses these chains in the JAX
package's jitted step.  In PyTorch they are some thirty passes over the
``(M, F, T)`` model and its ratios an iteration, and about sixty launches.
On a CUDA tensor the wrapper launches the hand-written kernel in
``csrc/fastmnmf_mu.cu`` (its source note gives the design), one launch a
call, which forms the model in registers and writes only the result; on a
CPU tensor it runs :func:`fastmnmf_mu_plain`, the einsum code the model
ran before K5.  The kernel takes M <= 4, S <= 4 and ``S K <= 24``
(:func:`takes`); the model keeps the plain version for other shapes.
"""

import ctypes

import torch

from . import _build
from ..runtime.cost_model import charged
from ..runtime.spanlog import watch
from ..utils.flooring import floor_below

ENTRIES = ("weights", "basis", "gains", "activation", "fit")  # the C entry's code is the index
# the kernel's limits (csrc/fastmnmf_mu.cu): channels, sources, and the joint
# (source, basis) axis that the statistics keep in registers (past 24 they
# spill, and the plain version is faster)
MAX_M, MAX_S, MAX_J = 4, 4, 24
TILE = 32  # frames a block of the bin statistics
FRAME_SPAN = {4: 512, 8: 256}  # frames a block of the frame statistics, by the size of a real
ROW_THREADS = 128  # frames a block of the weights and the fit
ROW_BINS = {4: 16, 8: 8}  # bins a block of the weights and the fit, by the size of a real
# blocks the bin statistics fill at most: one wave, two for each of an
# H100's 132 SMs; and the shared memory a block of them takes at most
BIN_BLOCKS, BIN_SMEM = 264, 100 * 1024

_DTYPES = {torch.float32: 0, torch.float64: 1}


def model_power(W, g, H):
    """``R[m] = sum_s (W H)_s g[s, :, m] (M, F, T)`` as one GEMM, ``g``
    folded into ``W`` over the joint (source, basis) axis; contiguous, as
    K1 takes ``1 / R``."""
    n_sources, n_bins, n_basis = W.shape
    Wg = torch.einsum("sfk,sfm->mfsk", W, g).reshape(g.shape[-1], n_bins, n_sources * n_basis)
    return torch.matmul(Wg, H.reshape(n_sources * n_basis, -1))


def frame_statistics(x, W, g, H, eps):
    """``[sum_t x / R^2 H, sum_t H / R]``, ``(M, F, S, K)`` each."""
    R = floor_below(model_power(W, g, H), eps)
    return [torch.einsum("mft,skt->mfsk", x / R**2, H), torch.einsum("mft,skt->mfsk", 1 / R, H)]


def bin_statistics(x, W, g, H, eps):
    """``[sum_{m,f} x / R^2 W g, sum_{m,f} W g / R]``, ``(S, K, T)`` each."""
    R = floor_below(model_power(W, g, H), eps)
    Wg = torch.einsum("sfk,sfm->skmf", W, g)  # (S, K, M, F)
    return [torch.einsum("mft,skmf->skt", x / R**2, Wg), torch.einsum("mft,skmf->skt", 1 / R, Wg)]


def _basis_update(W, g, H, E_num, E_den, eps):
    num = torch.einsum("sfm,mfsk->sfk", g, E_num)
    den = floor_below(torch.einsum("sfm,mfsk->sfk", g, E_den), eps)
    return W * torch.sqrt(num / den)


def _gains_update(W, g, H, E_num, E_den, eps):
    A = torch.einsum("sfk,mfsk->sfm", W, E_num)
    B = floor_below(torch.einsum("sfk,mfsk->sfm", W, E_den), eps)
    return g * torch.sqrt(A / B)


def _activation_update(W, g, H, num, den, eps):
    return H * torch.sqrt(num / floor_below(den, eps))


# entry -> (its statistics, the update from the whole statistics)
_SWEEPS = {
    "basis": (frame_statistics, _basis_update),
    "gains": (frame_statistics, _gains_update),
    "activation": (bin_statistics, _activation_update),
}


def _ordered_update(entry, W, g, H, num, den, eps):
    """The update of ``entry`` from whole statistics, with the sums over
    channels (basis) or bases (gains) taken one term at a time, each
    product and sum rounded, in the order the kernel's fused update takes
    them: the kernel's statistics then give the fused launch's bits."""
    if entry == "activation":
        return _activation_update(W, g, H, num, den, eps)
    if entry == "basis":
        terms = [(g[:, :, m, None], num[m].permute(1, 0, 2), den[m].permute(1, 0, 2)) for m in range(g.shape[2])]
        factor = W
    else:
        num, den = num.permute(2, 1, 0, 3), den.permute(2, 1, 0, 3)  # (S, F, M, K)
        terms = [(W[:, :, None, k], num[..., k], den[..., k]) for k in range(W.shape[2])]
        factor = g
    (c, n, d), rest = terms[0], terms[1:]
    A, B = c * n, c * d
    for c, n, d in rest:
        A, B = A + c * n, B + c * d
    return factor * torch.sqrt(A / floor_below(B, eps))


def fastmnmf_mu_plain(entry, x, W, g, H, eps, whole=None):
    """Plain PyTorch version of K5's ``entry`` (the module docstring), any
    shape: the model as one GEMM and the contractions as einsums."""
    if entry == "weights":
        return 1.0 / floor_below(model_power(W, g, H), eps)
    if entry == "fit":
        y_tilde = model_power(W, g, H) + eps
        return torch.sum((x + eps) / y_tilde + torch.log(y_tilde))
    statistics, update = _SWEEPS[entry]
    sums = statistics(x, W, g, H, eps)
    if whole is not None:
        sums = whole(sums)
    return update(W, g, H, *sums, eps)


def takes(M, S, K):
    """Whether the kernel takes ``M`` channels, ``S`` sources and ``K``
    bases."""
    return 1 <= M <= MAX_M and 1 <= S <= MAX_S and K >= 1 and S * K <= MAX_J


def k5_cost(entry, M, S, K, F, T, itemsize):
    """K5's compulsory ``(bytes, flops)`` for ``entry`` at ``itemsize``-byte
    reals: ``W``, ``g`` and ``H`` read once, ``x`` too but for the weights,
    and the result written once.  FLOPs a (channel, bin, frame): ``2 S K``
    for the model, the statistics ``4 S K`` more and 3 for the ratios, the
    weights 1 and the fit 4 (the two additions, the quotient, the
    logarithm); the frame statistics' updates ``4 S K M`` a bin and the bin
    statistics' ``3 S K T``."""
    n_factors = S * F * K + S * F * M + S * K * T
    n_result = {"weights": M * F * T, "basis": S * F * K, "gains": S * F * M, "activation": S * K * T, "fit": 1}[entry]
    n_bytes = (n_factors + n_result + (0 if entry == "weights" else M * F * T)) * itemsize
    per_element = {"weights": 1, "fit": 4}.get(entry, 4 * S * K + 3)
    flops = M * F * T * (2 * S * K + per_element)
    if entry in ("basis", "gains"):
        flops += 4 * S * K * M * F
    elif entry == "activation":
        flops += 3 * S * K * T
    return n_bytes, flops


def _check(entry, x, W, g, H):
    """Raise ``ValueError`` unless the kernel takes the operands on any
    device: ``x (M, F, T)``, ``W (S, F, K)``, ``g (S, F, M)``, ``H (S, K,
    T)`` of one real type (float32 or float64) within :func:`takes`, all on
    one device; on CUDA each contiguous too."""
    if entry not in ENTRIES:
        raise ValueError("K5 entry must be one of {}, got {!r}".format(ENTRIES, entry))
    if any(t.ndim != 3 for t in (x, W, g, H)):
        raise ValueError("K5 takes x (M, F, T), W (S, F, K), g (S, F, M) and H (S, K, T)")
    M, F, T = x.shape
    S, K = W.shape[0], W.shape[2]
    if tuple(W.shape) != (S, F, K) or tuple(g.shape) != (S, F, M) or tuple(H.shape) != (S, K, T):
        raise ValueError("K5 takes x (M, F, T), W (S, F, K), g (S, F, M) and H (S, K, T)")
    if not takes(M, S, K):
        raise ValueError(
            "K5 takes M <= {}, S <= {} and S K <= {}, got M={}, S={}, K={}".format(MAX_M, MAX_S, MAX_J, M, S, K)
        )
    if x.dtype not in _DTYPES or any(t.dtype != x.dtype for t in (W, g, H)):
        raise ValueError("K5 takes float32 or float64 operands of one type")
    if any(t.device != x.device for t in (W, g, H)):
        raise ValueError("K5's operands must be on one device")
    if x.device.type == "cuda" and not all(t.is_contiguous() for t in (x, W, g, H)):
        raise ValueError("K5 takes contiguous operands on CUDA")


def fastmnmf_mu(entry, x, W, g, H, eps, whole=None):
    """K5: one of FastMNMF's MU results (the module docstring).

    Args:
        entry: ``"weights"``, ``"basis"``, ``"gains"``, ``"activation"`` or
            ``"fit"``.
        x: ``(M, F, T)`` the powers ``|Q x|^2``; W ``(S, F, K)``, g ``(S,
            F, M)``, H ``(S, K, T)``; one real type, M <= 4, S <= 4, S K <=
            24.
        eps: the floors' ``eps``.
        whole: for the basis, gains and activation, ``None`` where the
            statistics' axis is whole here, else a callable that makes the
            list of partial sums whole.
    Returns:
        The entry's result, a new tensor.

    Inside a cost count (:mod:`~..runtime.cost_model`) a call is charged
    :func:`k5_cost` on either route.
    """

    def cost():
        return k5_cost(entry, x.shape[0], W.shape[0], W.shape[2], x.shape[1], x.shape[2], x.element_size())

    _check(entry, x, W, g, H)
    fused = whole is None or entry not in _SWEEPS
    with charged("K5", cost):
        out = _fastmnmf_mu(entry, x, W, g, H, eps, fused)
    if fused:
        return out
    if x.device.type == "cuda":
        return _ordered_update(entry, W, g, H, *whole(out), eps)
    return _SWEEPS[entry][1](W, g, H, *whole(out), eps)


def _fastmnmf_mu(entry, x, W, g, H, eps, fused):
    """The entry's result where ``fused``, else its list of statistics."""
    if x.device.type == "cpu" or x.numel() == 0 or W.numel() == 0:
        if fused:
            return fastmnmf_mu_plain(entry, x, W, g, H, eps)
        return _SWEEPS[entry][0](x, W, g, H, eps)
    if x.device.type != "cuda":
        raise ValueError("fastmnmf_mu: unsupported device {}".format(x.device))
    M, F, T = x.shape
    S, K = W.shape[0], W.shape[2]
    result = {"weights": (M, F, T), "basis": (S, F, K), "gains": (S, F, M), "activation": (S, K, T), "fit": ()}
    if fused:
        outs = [torch.empty(result[entry], dtype=x.dtype, device=x.device), None]
    elif entry == "activation":
        outs = [torch.empty((S, K, T), dtype=x.dtype, device=x.device) for _ in range(2)]
    else:
        outs = [torch.empty((M, F, S, K), dtype=x.dtype, device=x.device) for _ in range(2)]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    chunk_bins, part, tickets = 0, None, None
    if entry != "weights":
        chunk_bins, n_part, n_tickets = _plan(entry, M, S, K, F, T, x.element_size())
        part, tickets = _scratch_for(x.device, stream, n_part, n_tickets)
    status = _entry()(
        ENTRIES.index(entry), int(fused), x.data_ptr(), W.data_ptr(), g.data_ptr(), H.data_ptr(),
        outs[0].data_ptr(), None if outs[1] is None else outs[1].data_ptr(),
        None if part is None else part.data_ptr(), None if tickets is None else tickets.data_ptr(),
        _DTYPES[x.dtype], M, S, K, F, T, chunk_bins, float(eps), stream,
    )
    _build.check(status, "fastmnmf_mu")
    fastmnmf_mu.launches += 1
    return outs[0] if fused else outs


def _plan(entry, M, S, K, F, T, itemsize):
    """``(bins a chunk, scratch bytes, tickets)`` of a launch: for the
    basis and gains, the frame statistics' ``(groups, spans, 2 kJ, 32)``
    partials where the frames take more than one span, and one ticket a
    group of ``32 // M`` bins; for the activation, its ``(chunks, 2, S K,
    T)`` partials and one ticket a tile of frames; for the fit, one double
    a block and one ticket."""
    if entry == "fit":
        blocks = -(-T // ROW_THREADS) * -(-F // ROW_BINS[itemsize])
        return 0, 8 * blocks, 1
    if entry in ("basis", "gains"):
        spans, groups = -(-T // FRAME_SPAN[itemsize]), -(-F // (32 // M))
        return 0, groups * spans * 2 * MAX_J * 32 * itemsize if spans > 1 else 1, groups
    # the bin statistics: as many chunks as keep one wave, and as few bins a
    # chunk as its W, g, x and Wg fit in BIN_SMEM
    per_bin = (M * MAX_J + M * TILE + S * K + S * M) * itemsize
    tiles = -(-T // TILE)
    chunks = max(-(-F // max(1, BIN_SMEM // per_bin)), min(-(-F // 8), max(1, BIN_BLOCKS // tiles)))
    chunk_bins = -(-F // chunks)
    chunks = -(-F // chunk_bins)
    return chunk_bins, chunks * 2 * S * K * T * itemsize, tiles


def _entry():
    fn = _build.load("fastmnmf_mu").fastmnmf_mu
    if fn.argtypes is None:
        fn.argtypes = (
            [ctypes.c_int] * 2 + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_double, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    return fn


# (device index, stream) -> (partials, tickets), shared by the launches of
# every entry but the weights, which run in stream order and leave the
# tickets at zero, so they are zeroed only when allocated.  A captured
# graph takes the scratch of its capture stream (:func:`take_scratch`)
_scratch = {}


def _scratch_for(device, stream, n_part, n_tickets):
    key = (device.index, stream)
    part, tickets = _scratch.get(key, (None, None))
    grow_part = part is None or part.numel() < n_part
    grow_tickets = tickets is None or tickets.numel() < n_tickets
    if (grow_part or grow_tickets) and torch.cuda.is_current_stream_capturing():
        raise RuntimeError("K5's scratch for this stream must exist before capture: launch it once eagerly there first")
    if grow_part:
        part = torch.empty((n_part,), dtype=torch.uint8, device=device)
    if grow_tickets:
        tickets = torch.zeros((n_tickets,), dtype=torch.int32, device=device)
    _scratch[key] = (part, tickets)
    return part, tickets


def take_scratch(device, stream):
    """Remove and return the scratch of ``stream`` on ``device`` (``None``
    where there is none): a captured graph keeps the scratch its launches
    were captured with, and a later capture on a stream of the pool gets
    its own."""
    return _scratch.pop((device.index, stream), None)


fastmnmf_mu.launches = 0
watch("k5_launches", lambda: fastmnmf_mu.launches)
