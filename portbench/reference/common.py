"""Plain arithmetic shared by the configurations' references.

Straightforward PyTorch, written from the published algorithms and scipy's
STFT conventions, independent of the code under test: no kernel, no graph,
no compact planes.  Every sum over a long axis (the DFT, its inverse, a
covariance over frames, a projection-back over frames) is
a real matrix product through :meth:`Arith.mm`, so that the precision of
those products is one setting:

  * ``"float64"``: the reference, float64 and complex128 throughout;
  * ``"tf32"``: the control, float32 and complex64 with every matrix
    product's operands rounded to TF32 (10 mantissa bits, round to nearest
    even) before a float32 product, which is what TF32 tensor cores do to
    a float32 GEMM.  The rounding is explicit, so the control reads the
    same on the card and on the CPU.

Shapes follow the program's public layouts: a mixture ``(C, F, T)``
complex, demixing filters ``(F, N, C)``, estimates ``(N, F, T)``.
"""

import math

import torch

PRECISIONS = ("float64", "tf32")


def tf32_round(x):
    """``x`` (float32) rounded to TF32's 10 mantissa bits, to nearest even."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0xFFF + ((bits >> 13) & 1)) & -8192
    return bits.view(torch.float32)


class Arith:
    """The precision and device the reference computes at."""

    def __init__(self, precision, device):
        if precision not in PRECISIONS:
            raise ValueError("precision must be one of {}, got {!r}".format(PRECISIONS, precision))
        self.precision = precision
        self.device = torch.device(device)
        self.real = torch.float64 if precision == "float64" else torch.float32
        self.complex = torch.complex128 if precision == "float64" else torch.complex64
        self._dft = {}

    def tensor(self, value):
        return torch.as_tensor(value).to(device=self.device, dtype=self.real)

    def mm(self, a, b):
        """Real matrix product (batched as ``torch.matmul``)."""
        if self.precision == "tf32":
            a, b = tf32_round(a), tf32_round(b)
        return torch.matmul(a, b)

    def cmm(self, a, b):
        """Complex matrix product as four real ones."""
        ar, ai, br, bi = a.real, a.imag, b.real, b.imag
        return torch.complex(self.mm(ar, br) - self.mm(ai, bi), self.mm(ar, bi) + self.mm(ai, br))

    def dft(self, n):
        """``(cos, -sin)`` of ``2 pi k m / n`` for ``m < n``, ``k <= n / 2``:
        ``(n, n // 2 + 1)`` each, the angles reduced exactly first."""
        if n not in self._dft:
            m = torch.arange(n, device=self.device, dtype=torch.int64)
            k = torch.arange(n // 2 + 1, device=self.device, dtype=torch.int64)
            angle = (m[:, None] * k[None, :] % n).to(torch.float64) * (2 * math.pi / n)
            self._dft[n] = (torch.cos(angle).to(self.real), (-torch.sin(angle)).to(self.real))
        return self._dft[n]


def hann(n, arith):
    """Periodic hann window (scipy's ``get_window("hann", n)``)."""
    m = torch.arange(n, device=arith.device, dtype=torch.float64)
    return (0.5 - 0.5 * torch.cos(2 * math.pi * m / n)).to(arith.real)


def stft(x, fft_size, hop_size, arith):
    """``scipy.signal.stft(x, nperseg=fft_size, noverlap=fft_size -
    hop_size)[2]`` of ``x (C, n_samples)``: zeros of half a window on both
    ends, zeros to whole hops, hann, scaled by the window's sum; ``(C,
    fft_size // 2 + 1, n_frames)`` complex, by a DFT matrix product."""
    x = arith.tensor(x)
    half = fft_size // 2
    x = torch.nn.functional.pad(x, (half, half))
    extra = -(x.shape[-1] - fft_size) % hop_size
    x = torch.nn.functional.pad(x, (0, extra))
    n_frames = 1 + (x.shape[-1] - fft_size) // hop_size
    start = torch.arange(n_frames, device=arith.device)[:, None] * hop_size
    window = hann(fft_size, arith)
    frames = x[:, start + torch.arange(fft_size, device=arith.device)] * window  # (C, T, N)
    cos, sin = arith.dft(fft_size)
    spec = torch.complex(arith.mm(frames, cos), arith.mm(frames, sin)) / window.sum()
    return spec.transpose(1, 2)


def istft(spec, fft_size, hop_size, length, arith):
    """``scipy.signal.istft`` of ``spec (N, F, T)`` (windowed overlap-add
    over the overlap-add of the squared window, half a window trimmed from
    both ends), cut to ``length`` samples; ``fft_size`` a multiple of
    ``hop_size``."""
    if fft_size % hop_size:
        raise ValueError("the reference's overlap-add takes a hop that divides the window")
    n_sources, n_bins, n_frames = spec.shape
    cos, sin = arith.dft(fft_size)
    weight = torch.full((n_bins,), 2.0, device=arith.device, dtype=arith.real)
    weight[0] = weight[-1] = 1.0  # the DC and Nyquist bins appear once
    re = (spec.real * weight[:, None]).transpose(1, 2)
    im = (spec.imag * weight[:, None]).transpose(1, 2)
    frames = (arith.mm(re, cos.T) + arith.mm(im, sin.T)) / fft_size  # (N, T, fft)
    window = hann(fft_size, arith)
    frames = frames * window.sum() * window
    ratio = fft_size // hop_size
    n_blocks = n_frames + ratio - 1
    out = torch.zeros((n_sources, n_blocks, hop_size), device=arith.device, dtype=arith.real)
    norm = torch.zeros((n_blocks, hop_size), device=arith.device, dtype=arith.real)
    square = (window**2).reshape(ratio, hop_size)
    for i in range(ratio):
        out[:, i : i + n_frames] += frames[:, :, i * hop_size : (i + 1) * hop_size]
        norm[i : i + n_frames] += square[i]
    out, norm = out.reshape(n_sources, -1), norm.reshape(-1)
    out = out / torch.where(norm > 1e-10, norm, torch.ones_like(norm))
    half = fft_size // 2
    return out[:, half : out.shape[-1] - half][:, :length]


def separate(W, X, arith):
    """``Y = W X`` per bin: ``(F, N, C) x (C, F, T) -> (N, F, T)``."""
    return arith.cmm(W, X.transpose(0, 1)).transpose(0, 1)


def covariance(X, weights, arith):
    """``U[f] = (1/T) sum_t w[(f,) t] x_ft x_ft^H``, ``(F, C, C)``, for
    ``weights (T,)`` or ``(F, T)``."""
    Xf = X.transpose(0, 1)  # (F, C, T)
    w = weights if weights.ndim == 2 else weights[None, :]
    return arith.cmm(Xf * w[:, None, :], Xf.conj().transpose(1, 2)) / X.shape[-1]


def ip_sweep(W, X, weights, threshold, arith):
    """One sequential iterative-projection sweep (Ono 2011) of ``W (F, N,
    C)`` with ``weights[n]`` (``(T,)`` or ``(F, T)``, the inverse
    variances): for each source n, ``w = (W U_n)^{-1} e_n``, normalised by
    ``sqrt(w^H U_n w)``, and the row kept where the one-norm condition
    number ``||W U_n||_1 ||(W U_n)^{-1}||_1`` is not below ``threshold``."""
    W = W.clone()
    for n in range(W.shape[1]):
        U = covariance(X, weights[n], arith)
        WU = arith.cmm(W, U)
        inv = torch.linalg.inv(WU)
        w = inv[:, :, n]  # (F, C)
        kappa = WU.abs().sum(dim=-2).amax(dim=-1) * inv.abs().sum(dim=-2).amax(dim=-1)
        quad = torch.einsum("fc,fcd,fd->f", w.conj(), U, w).real
        row = w.conj() / torch.sqrt(quad)[:, None]
        W[:, n, :] = torch.where((kappa < threshold)[:, None], row, W[:, n, :])
    return W


def log_abs_det(W):
    """``log|det W_f|``, ``(F,)``."""
    return torch.log(torch.abs(torch.linalg.det(W)))


def projection_back(Y, reference, arith):
    """``Y`` rescaled to its image at the reference microphone: per bin the
    least-squares ``a = x_ref Y^H (Y Y^H)^{-1}``, ``Y[n] * a[n]``."""
    Yf = Y.transpose(0, 1)  # (F, N, T)
    YYh = arith.cmm(Yf, Yf.conj().transpose(1, 2))  # (F, N, N)
    xYh = arith.cmm(reference[:, None, :], Yf.conj().transpose(1, 2))  # (F, 1, N)
    a = torch.linalg.solve(YYh.transpose(1, 2), xYh.transpose(1, 2))[..., 0]  # (F, N)
    return Y * a.transpose(0, 1)[:, :, None]
