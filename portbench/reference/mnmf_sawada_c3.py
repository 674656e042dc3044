"""Plain reference of ``mnmf_sawada_c3``: STFT, Sawada's full-rank
multichannel NMF (H. Sawada, H. Kameoka, S. Araki and N. Ueda, IEEE TASLP
21(5), 2013; upstream ``MultichannelISNMF``, ``src/bss/mnmf.py:115-617``),
the multichannel Wiener filter, iSTFT.

From the mixture ``x (C, n_samples)`` and the configuration alone, at the
precision of :class:`~.common.Arith`.  The state: the spatial covariances
``H (F, S, C, C)`` (the identity at first), the latent ``Z (S, K)``, the
basis ``T (F, K)`` and the activation ``V (K, T)``, drawn by
:func:`draw_init` from the configuration's ``init`` as the benchmark's
pipeline draws them, the latent mapped to ``(u * 1e-2 + 1 / S) / max(sum_s,
eps)``.  With the observed covariances ``X = x x^H`` and the model ``X^ =
sum_s H_s (Z T V)_s`` at every (bin, frame), one iteration is
(``update_once_sawada``, ``mnmf.py:301``), each update from the state the
previous one left:

  * basis, activation, latent (``mnmf.py:377-447``): with ``X^-1`` the
    inverse of ``X^ + eps I``, ``a = tr(X^-1 X X^-1 H_s)`` and ``b = tr(X^-1
    H_s)``, each factor times ``sqrt(max(num, 0) / max(den, eps))``, where
    ``num`` and ``den`` are ``a`` and ``b`` summed against the other two
    factors over the axes the factor lacks; then the latent renormalised to
    the simplex over the sources;
  * spatial (``mnmf.py:449-473``): ``A_s = sum_t (ZTV)_s X^-1`` and ``B_s =
    H_s (sum_t (ZTV)_s X^-1 X X^-1) H_s``, the Hermitian PSD solution of ``H
    A H = B``, ``H = A^-1/2 (A^1/2 B A^1/2)^1/2 A^-1/2`` (eigenvalues clipped
    at 0 for the square roots and at 1e-12 for the inverse one), then ``+ eps
    I`` and the trace normalisation.

The loss before the first iteration and after each: the log-det divergence
of the PSD projections, ``sum tr(X' (X^' + eps I)^-1) - log det X' + log
det X^' - C`` over every (bin, frame), where ``M' = to_psd(M) + eps I``,
``to_psd`` shifting a Hermitian matrix by ``eps tr(M)`` less its most
negative eigenvalue, and each log-determinant the sum of the logarithms of
``max(w + eps, eps)`` over the shifted eigenvalues ``w``.  The model ``X^``
is PSD by construction (PSD ``H_s``, positive weights), so its shift is
``eps tr(X^)`` and its log-determinant that of ``X^'``; the observed ``X =
x x^H`` is rank 1, its eigenvalues ``|x|^2`` (its trace) and ``C - 1``
zeros, so its shift is ``eps tr(X)`` and its log-determinant, a constant
of the data, is computed once from its trace.  The output: per
source ``(ZTV)_s (H_s X^-1 x)`` at microphone ``reference_id``.

Where this departs from the program's arithmetic, the value is the same:
the sums over frames, over bins and the DFT, and every product that forms a
covariance, are matrix products (:meth:`~.common.Arith.mm`,
:meth:`~.common.Arith.cmm`, or for the 3 x 3 products of every (bin,
frame) broadcast sums with the same rounding); the inverses and
determinants of the full complex matrices come from their cofactors, where
the program takes adjugates of compact planes; the matrix powers of
the Riccati solve come from ``torch.linalg.eigh`` where the program
takes its kernel K3, and the model's log-determinant is that of its
determinant where the program sums the logarithms of its closed-form
eigenvalues; the upstream's own Riccati takes the eigenvectors of the ``2C
x 2C`` block matrix ``[[0, A], [B, 0]]``, which selects the same PSD
solution.
"""

import torch

from ..pipelines import stft_sawada_seeded_bss_istft as seeded
from . import common


def draw_init(config, n_bins, n_frames):
    """``{field: float64 tensor}`` of the configuration's ``init`` as the
    benchmark's pipeline draws it, the latent mapped to the upstream's init
    (:func:`~portbench.pipelines.stft_sawada_seeded_bss_istft.draw_init`)."""
    return {field: torch.from_numpy(v) for field, v in seeded.draw_init(config, n_bins, n_frames).items()}


def _herm(M):
    return (M + M.transpose(-2, -1).conj()) / 2


def _eye(n, like):
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _small_mm(a, b, arith):
    """``a @ b`` for batches of small complex matrices, ``(..., n, k)`` and
    ``(..., k, m)``, as a broadcast sum over the inner axis with the operands
    rounded as :meth:`~.common.Arith.mm` rounds them: the products of every
    (bin, frame), where a batched GEMM would launch a million 3 x 3 ones."""
    if arith.precision == "tf32":
        a, b = (torch.complex(common.tf32_round(m.real), common.tf32_round(m.imag)) for m in (a, b))
    return (a[..., :, :, None] * b[..., None, :, :]).sum(dim=-2)


def _inv_det(M):
    """``(M^-1, det M)`` of ``3 x 3`` matrices ``M (..., 3, 3)`` by the
    cofactors, elementwise over the batch."""
    (a, b, c), (d, e, f), (g, h, i) = (M[..., r, :].unbind(-1) for r in range(3))
    adj = torch.stack(
        [
            torch.stack([e * i - f * h, c * h - b * i, b * f - c * e], dim=-1),
            torch.stack([f * g - d * i, a * i - c * g, c * d - a * f], dim=-1),
            torch.stack([d * h - e * g, b * g - a * h, a * e - b * d], dim=-1),
        ],
        dim=-2,
    )
    det = a * adj[..., 0, 0] + b * adj[..., 1, 0] + c * adj[..., 2, 0]
    return adj / det[..., None, None], det


def _power(M, power, clip, arith):
    """The Hermitian matrix power ``V f(w) V^H`` of ``M (..., n, n)``,
    ``f(w) = max(w, clip)^power`` where positive, else 0."""
    w, V = torch.linalg.eigh(M)
    w = torch.clamp(w, min=clip)
    fw = torch.where(w > 0, torch.where(w > 0, w, 1.0) ** power, 0.0)
    return arith.cmm(V * fw[..., None, :].to(V.dtype), V.transpose(-2, -1).conj())


def _riccati(A, B, arith):
    """The Hermitian PSD ``H`` with ``H A H = B``."""
    A_sqrt = _power(A, 0.5, 0.0, arith)
    A_invsqrt = _power(A, -0.5, 1e-12, arith)
    M_sqrt = _power(_herm(arith.cmm(arith.cmm(A_sqrt, B), A_sqrt)), 0.5, 0.0, arith)
    return _herm(arith.cmm(arith.cmm(A_invsqrt, M_sqrt), A_invsqrt))


def run(x, config, arith):
    """``{"spec", "loss", "demix_filter", "output"}`` of the mixture ``x``."""
    stft, system = config["stft"], config["system"]
    kwargs = system["kwargs"]
    if kwargs["author"].lower() != "sawada" or not kwargs["normalize"] or system["filter"] != "spatial":
        raise ValueError("this reference is Sawada's MNMF with trace normalisation")
    if config["n_mics"] != 3:
        raise ValueError("this reference takes three microphones")
    eps, ref_mic = kwargs["eps"], kwargs["reference_id"]
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        X = common.stft(x, stft["fft_size"], stft["hop_size"], arith)
        C, F, T = X.shape
        S = config["n_sources"]
        drawn = draw_init(config, F, T)
        Z, Tb, V = (arith.tensor(drawn[k]) for k in ("latent", "basis", "activation"))
        H = _eye(C, X).expand(F, S, C, C).clone()
        x_ft = X.permute(1, 2, 0)  # (F, T, C)
        XX = _small_mm(x_ft[..., :, None], x_ft.conj()[..., None, :], arith)  # (F, T, C, C)
        I = _eye(C, XX)

        def ztv(Z, Tb, V):
            """``(Z T V)_s (S, F, T)``."""
            return arith.mm(Tb[None] * Z[:, None, :], V)

        def model(Z, Tb, V, H):
            """``X^ (F, T, C, C)``: ``sum_s H_s (ZTV)_s``."""
            G = ztv(Z, Tb, V).permute(1, 2, 0)  # (F, T, S)
            Hf = H.reshape(F, S, C * C)
            Xh = torch.complex(arith.mm(G, Hf.real), arith.mm(G, Hf.imag))
            return Xh.reshape(F, T, C, C)

        def inverse(Xh):
            return _inv_det(Xh + eps * I)[0]

        def traces(Z, Tb, V, H):
            """``tr(X^-1 X X^-1 H_s)`` and ``tr(X^-1 H_s)``, ``(S, F, T)``
            each."""
            inv = inverse(model(Z, Tb, V, H))
            XXX = _small_mm(_small_mm(inv, XX, arith), inv, arith)
            Ht = H.transpose(-2, -1).reshape(F, S, C * C).transpose(1, 2)  # (F, C^2, S): H_s[d, c] at (c, d)
            tn = arith.cmm(XXX.reshape(F, T, C * C), Ht).real
            td = arith.cmm(inv.reshape(F, T, C * C), Ht).real
            return tn.permute(2, 0, 1), td.permute(2, 0, 1)

        def ratio(num, den):
            return torch.sqrt(torch.clamp(num, min=0.0) / torch.clamp(den, min=eps))

        # the observed covariances' PSD parts, a constant of the data: x x^H
        # has the eigenvalues |x|^2 and C - 1 zeros, so its shift is eps |x|^2
        power = torch.diagonal(XX, dim1=-2, dim2=-1).real.sum(dim=-1)  # (F, T)
        ridge = eps * power + eps
        X_psd = XX + ridge[..., None, None].to(XX.dtype) * I
        logdet_X = torch.log(power + ridge) + (C - 1) * torch.log(ridge)

        def loss(Z, Tb, V, H):
            # the model is PSD by construction (PSD H_s, positive weights):
            # its shift is eps tr(X^), and its shifted eigenvalues' logarithms
            # sum to the log-determinant of X^' = X^ + (eps tr + eps) I
            Xh = _herm(model(Z, Tb, V, H))
            tr = torch.diagonal(Xh, dim1=-2, dim2=-1).real.sum(dim=-1)
            Xh_psd = Xh + (eps * tr + eps)[..., None, None].to(Xh.dtype) * I
            inv_h, det = _inv_det(Xh_psd)
            trace = (X_psd * inv_h.transpose(-2, -1)).real.sum(dim=(-2, -1))
            logdet_Xh = torch.log(det.real)
            return torch.sum(trace - logdet_X + logdet_Xh - C)

        losses = [loss(Z, Tb, V, H)]
        for _ in range(system["iteration"]):
            # basis: sum over sources and frames
            tn, td = traces(Z, Tb, V, H)
            num = (arith.mm(tn.transpose(0, 1), V.T) * Z[None]).sum(dim=1)  # (F, K)
            den = (arith.mm(td.transpose(0, 1), V.T) * Z[None]).sum(dim=1)
            Tb = Tb * ratio(num, den)
            # activation: sum over sources and bins
            tn, td = traces(Z, Tb, V, H)
            num = (arith.mm(Tb.T, tn) * Z[:, :, None]).sum(dim=0)  # (K, T)
            den = (arith.mm(Tb.T, td) * Z[:, :, None]).sum(dim=0)
            V = V * ratio(num, den)
            # latent: sum over bins and frames, then the simplex
            tn, td = traces(Z, Tb, V, H)
            frames_n, frames_d = arith.mm(tn, V.T), arith.mm(td, V.T)  # (S, F, K)
            num = arith.mm(frames_n.permute(2, 0, 1), Tb.T[:, :, None])[..., 0].T  # (S, K)
            den = arith.mm(frames_d.permute(2, 0, 1), Tb.T[:, :, None])[..., 0].T
            Z = Z * ratio(num, den)
            Z = Z / torch.clamp(Z.sum(dim=0), min=eps)
            # spatial: the frame sums, the Riccati solve, the ridge and the trace
            inv = inverse(model(Z, Tb, V, H))
            XXX = _small_mm(_small_mm(inv, XX, arith), inv, arith)
            G = ztv(Z, Tb, V).transpose(0, 1)  # (F, S, T)

            def frame_sum(M):
                M = M.reshape(F, T, C * C)
                return torch.complex(arith.mm(G, M.real), arith.mm(G, M.imag)).reshape(F, S, C, C)

            A, B = frame_sum(inv), frame_sum(XXX)
            H = _riccati(A, arith.cmm(arith.cmm(H, B), H), arith)
            H = H + eps * I
            H = H / torch.diagonal(H, dim1=-2, dim2=-1).sum(dim=-1)[..., None, None]
            losses.append(loss(Z, Tb, V, H))

        # the multichannel Wiener filter at the reference microphone
        inv = inverse(model(Z, Tb, V, H))
        v = _small_mm(inv, x_ft[..., None], arith)[..., 0]  # (F, T, C): X^-1 x
        Hx = arith.cmm(H[:, :, ref_mic, :], v.transpose(1, 2))  # (F, S, T)
        Y = ztv(Z, Tb, V) * Hx.transpose(0, 1)  # (S, F, T)
        out = common.istft(Y, stft["fft_size"], stft["hop_size"], x.shape[-1], arith)
        return {"spec": X, "loss": torch.stack(losses), "demix_filter": H, "output": out}
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
