"""Plain reference of ``fastmnmf_c2``: STFT, FastMNMF (MNMF with jointly
diagonalisable spatial covariances: Sekiguchi et al., EUSIPCO 2019; Ito and
Nakatani, ICASSP 2019; upstream ``src/bss/mnmf.py:637-946``), the Q-domain
Wiener filter, iSTFT.

From the mixture ``x (C, n_samples)`` and the configuration alone, at the
precision of :class:`~.common.Arith`.  The state: the diagonaliser ``Q (F,
M, C)`` (the identity at first), the gains ``g (S, F, M)`` (1 on source
``m % S`` of channel ``m``, else 1e-2), the basis ``W (S, F, K)`` and the
activation ``H (S, K, T)``, drawn by :func:`draw_init` from the
configuration's ``init`` as the benchmark's pipeline draws them.  With
``x~ = |Q x|^2 (M, F, T)``, ``lambda = W H (S, F, T)`` and the model ``y~_m =
sum_s lambda_s g_sm``, floored at eps where it divides, one iteration is
(``mnmf.py:789-888``, ``:743-771``):

  * basis: ``W *= sqrt(sum_t (sum_m g x~/y~^2) H / max(sum_t (sum_m g / y~) H,
    eps))``;
  * activation, from the new basis: ``H *= sqrt(sum_f W (sum_m g x~/y~^2) /
    max(sum_f W (sum_m g / y~), eps))``;
  * gains, from the new activation: ``g *= sqrt(sum_t lambda x~/y~^2 /
    max(sum_t lambda / y~, eps))``;
  * diagonaliser, from the new gains: ``U_m = (1/T) sum_t x x^H / y~_m`` for
    every m first, then row by row ``q_m = (Q U_m)^-1 e_m``, ``q_m^* /
    max(sqrt(q_m^H U_m q_m), eps)``, the row kept where the one-norm
    condition number of ``Q U_m`` is not below the threshold;
  * the power normalisation chain Q -> g -> W -> H, each floor at eps;

then ``x~`` afresh.  The loss ``sum (x~ + eps) / (y~ + eps) + log(y~ + eps) -
T sum_f log|det Q_f Q_f^T|`` (the transpose, as the upstream writes it) before
the first iteration and after each.  The output: per source the mask
``lambda_s g_sm / max(y~_m, eps)`` on ``(Q x)_m``, taken back to microphone
``reference_id`` by that row of ``Q^-1``.

Where this departs from the program's arithmetic, the value is the same: the
sums over frames, over bins and the DFT are matrix products
(:meth:`~.common.Arith.mm`); the gains' numerator is ``sum_t lambda x~/y~^2``
where the program sums ``W`` against ``sum_t x~/y~^2 H``; ``(Q U_m)^-1`` comes
from ``torch.linalg.inv`` where the program takes the adjugate; ``x~`` is
``|Q x|^2`` where the program expands it over the pair products.
"""

import torch

from ..pipelines import stft_seeded_bss_istft as seeded
from . import common


def draw_init(config, n_bins, n_frames):
    """``{field: float64 tensor}`` of the configuration's ``init``, as the
    benchmark's pipeline draws it (:func:`~portbench.pipelines.stft_seeded_bss_istft.draw_init`)."""
    return {field: torch.from_numpy(v) for field, v in seeded.draw_init(config, n_bins, n_frames).items()}


def _model(W, H, g, arith):
    """``(lambda (S, F, T), y~ (M, F, T))``."""
    lam = arith.mm(W, H)
    return lam, (g.permute(2, 0, 1)[:, :, :, None] * lam[None]).sum(dim=1)


def _ratios(x_tilde, y, eps):
    y = torch.clamp(y, min=eps)
    return x_tilde / y**2, 1.0 / y


def _by_source(g, A):
    """``sum_m g[s, f, m] A[m, f, t] -> (S, F, T)``."""
    return (g.permute(0, 2, 1)[:, :, :, None] * A[None]).sum(dim=1)


def _q_power(Q, X, arith):
    """``|Q x|^2 (M, F, T)``."""
    return (arith.cmm(Q, X.transpose(0, 1)).abs() ** 2).transpose(0, 1)


def _one_norm(A):
    return A.abs().sum(dim=-2).amax(dim=-1)


def run(x, config, arith):
    """``{"spec", "loss", "demix_filter", "output"}`` of the mixture ``x``."""
    stft, system = config["stft"], config["system"]
    kwargs = system["kwargs"]
    if kwargs["normalize"] != "power" or kwargs["guard"] != "one_norm" or system["filter"] != "diagonalizer":
        raise ValueError("this reference is FastMNMF with power normalisation and the one-norm guard")
    eps, threshold = kwargs["eps"], kwargs["threshold"]
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        X = common.stft(x, stft["fft_size"], stft["hop_size"], arith)
        C, F, T = X.shape
        S = config["n_sources"]
        drawn = draw_init(config, F, T)
        W, H = arith.tensor(drawn["basis"]), arith.tensor(drawn["activation"])
        g = torch.full((S, F, C), 1e-2, dtype=arith.real, device=arith.device)
        for m in range(C):
            g[m % S, :, m] = 1.0
        Q = torch.eye(C, dtype=arith.complex, device=arith.device).expand(F, C, C).clone()
        x_tilde = _q_power(Q, X, arith)

        def loss(W, H, g, Q, x_tilde):
            _, y = _model(W, H, g, arith)
            fit = torch.sum((x_tilde + eps) / (y + eps) + torch.log(y + eps))
            det = torch.abs(torch.linalg.det(Q @ Q.transpose(-2, -1)))
            return fit - T * torch.log(det).sum()

        losses = [loss(W, H, g, Q, x_tilde)]
        for _ in range(system["iteration"]):
            # basis
            A, B = _ratios(x_tilde, _model(W, H, g, arith)[1], eps)
            Ht = H.transpose(1, 2)
            num, den = arith.mm(_by_source(g, A), Ht), arith.mm(_by_source(g, B), Ht)
            W = W * torch.sqrt(num / torch.clamp(den, min=eps))
            # activation
            A, B = _ratios(x_tilde, _model(W, H, g, arith)[1], eps)
            Wt = W.transpose(1, 2)
            num, den = arith.mm(Wt, _by_source(g, A)), arith.mm(Wt, _by_source(g, B))
            H = H * torch.sqrt(num / torch.clamp(den, min=eps))
            # gains
            lam, y = _model(W, H, g, arith)
            A, B = _ratios(x_tilde, y, eps)
            lam_f = lam.transpose(0, 1)  # (F, S, T)
            num = arith.mm(lam_f, A.permute(1, 2, 0)).transpose(0, 1)  # (S, F, M)
            den = arith.mm(lam_f, B.permute(1, 2, 0)).transpose(0, 1)
            g = g * torch.sqrt(num / torch.clamp(den, min=eps))
            # diagonaliser
            _, y = _model(W, H, g, arith)
            inv_y = 1.0 / torch.clamp(y, min=eps)
            U = [common.covariance(X, inv_y[m], arith) for m in range(C)]
            for m in range(C):
                QU = arith.cmm(Q, U[m])
                inv = torch.linalg.inv(QU)
                q = inv[:, :, m]
                ok = _one_norm(QU) * _one_norm(inv) < threshold
                quad = torch.einsum("fc,fcd,fd->f", q.conj(), U[m], q).real
                row = q.conj() / torch.clamp(torch.sqrt(quad), min=eps)[:, None]
                Q[:, m, :] = torch.where(ok[:, None], row, Q[:, m, :])
            # power normalisation, Q -> g -> W -> H
            QQsum = torch.clamp((Q.abs() ** 2).sum(dim=2).mean(dim=1), min=eps)  # (F,)
            Q = Q / torch.sqrt(QQsum)[:, None, None]
            g = g / QQsum[None, :, None]
            g_sum = torch.clamp(g.sum(dim=2), min=eps)  # (S, F)
            g = g / g_sum[:, :, None]
            W = W * g_sum[:, :, None]
            W_sum = torch.clamp(W.sum(dim=1), min=eps)  # (S, K)
            W = W / W_sum[:, None, :]
            H = H * W_sum[:, :, None]
            x_tilde = _q_power(Q, X, arith)
            losses.append(loss(W, H, g, Q, x_tilde))

        # the Q-domain Wiener filter at the reference microphone
        lam, _ = _model(W, H, g, arith)
        lam_g = lam[:, None] * g.permute(0, 2, 1)[:, :, :, None]  # (S, M, F, T)
        y = torch.clamp(lam_g.sum(dim=0), min=eps)
        QX = arith.cmm(Q, X.transpose(0, 1)).transpose(0, 1)  # (M, F, T)
        back = torch.linalg.inv(Q)[:, kwargs["reference_id"], :]  # (F, M)
        Y = ((back.T[None, :, :, None] * QX[None]) * (lam_g / y[None])).sum(dim=1)  # (S, F, T)
        out = common.istft(Y, stft["fft_size"], stft["hop_size"], x.shape[-1], arith)
        return {"spec": X, "loss": torch.stack(losses), "demix_filter": Q, "output": out}
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
