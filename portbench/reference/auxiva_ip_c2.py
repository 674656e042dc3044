"""Plain reference of ``auxiva_ip_c2``: STFT, AuxIVA with the Laplace
contrast and iterative projection (Ono 2011; upstream
``src/bss/iva.py:388-619``), projection-back, iSTFT.

From the mixture ``x (C, n_samples)`` alone (the demixing filter starts at
the identity), at the precision of :class:`~.common.Arith`.  Per iteration:
``r_nt = max(sqrt(sum_f |y_nft|^2), eps)``, then the IP sweep with weights
``1 / r_n`` and the one-norm guard; the loss ``2 sum_nt sqrt(sum_f
|y_nft|^2) - 2 T sum_f log|det W_f|`` before the first iteration and after
each.
"""

import torch

from . import common


def run(x, config, arith):
    """``{"spec", "loss", "demix_filter", "output"}`` of the mixture ``x``."""
    stft, system = config["stft"], config["system"]
    kwargs = system["kwargs"]
    if kwargs["algorithm_spatial"] != "IP" or kwargs["guard"] != "one_norm" or not kwargs["apply_projection_back"]:
        raise ValueError("this reference is AuxLaplaceIVA-IP with the one-norm guard and projection-back")
    eps, threshold = kwargs["eps"], kwargs["threshold"]
    X = common.stft(x, stft["fft_size"], stft["hop_size"], arith)
    C, F, T = X.shape
    W = torch.eye(C, dtype=arith.complex, device=arith.device).expand(F, C, C).clone()

    def loss(Y, W):
        psum = torch.sum(Y.abs() ** 2, dim=1)
        return 2 * torch.sqrt(psum).sum() - 2 * T * common.log_abs_det(W).sum()

    Y = common.separate(W, X, arith)
    losses = [loss(Y, W)]
    for _ in range(system["iteration"]):
        r = torch.clamp(torch.sqrt(torch.sum(Y.abs() ** 2, dim=1)), min=eps)  # (N, T)
        W = common.ip_sweep(W, X, 1.0 / r, threshold, arith)
        Y = common.separate(W, X, arith)
        losses.append(loss(Y, W))
    Y = common.projection_back(Y, X[kwargs["reference_id"]], arith)
    y = common.istft(Y, stft["fft_size"], stft["hop_size"], x.shape[-1], arith)
    return {"spec": X, "loss": torch.stack(losses), "demix_filter": W, "output": y}
