"""Separation-quality metrics: SI-SDR, permutation-invariant pairing and
BSS Eval in the mir_eval convention.

``bss_eval_sources`` is the filter-invariant SDR/SIR/SAR triple of BSS Eval
v3 (mir_eval): each estimate is decomposed by least-squares projection onto
``filter_length``-tap FIR filterings of the references (512 taps, as
mir_eval) -- ``s_target`` projects onto the matched reference's shifts
alone, the interference-plus-target space projects jointly onto all the
references' shifts (one block-Toeplitz normal system) -- and the
permutation maximises the mean SIR, as mir_eval selects it.

Everything runs at float64 on the input's device, whatever the input's
precision: at 60 s and 512 taps the joint system is 1024 x 1024 with a
ridge of 1e-10 of its mean diagonal, singular to float32 rounding.  A
tensor stays on its device; anything else goes to ``device``, the CUDA card
unless the caller passes ``device="cpu"``.  Only the permutation choice
reads values on the host.
"""

import itertools

import numpy as np
import torch

from ..runtime.device import float64_tensors


def si_sdr(estimate, target, eps=1e-12, device=None):
    """Scale-invariant SDR in dB (batched over leading axes; last axis
    time), a float64 tensor."""
    estimate, target = float64_tensors([estimate, target], device)
    alpha = torch.sum(estimate * target, dim=-1, keepdim=True) / (torch.sum(target**2, dim=-1, keepdim=True) + eps)
    projection = alpha * target
    noise = estimate - projection
    ratio = torch.sum(projection**2, dim=-1) / (torch.sum(noise**2, dim=-1) + eps)
    return 10 * torch.log10(ratio + eps)


def pairwise_si_sdr(estimates, targets, device=None):
    """``(n_est, n_tgt)`` SI-SDR matrix."""
    estimates, targets = float64_tensors([estimates, targets], device)
    return si_sdr(estimates[:, None, :], targets[None, :, :])


def _best_permutation(matrix, score):
    """The permutation ``perm`` of ``range(n)`` maximising the mean of
    ``score(matrix, perm, i)``, the first in ``itertools`` order on ties."""
    n = matrix.shape[0]
    best, best_perm = -np.inf, None
    for perm in itertools.permutations(range(n)):
        value = np.mean([score(matrix, perm, i) for i in range(n)])
        if value > best:
            best, best_perm = value, perm
    return best, best_perm


def pit_si_sdr(estimates, targets, device=None):
    """Permutation-invariant mean SI-SDR and the best permutation.

    Returns ``(best_mean_si_sdr, best_permutation)``: a Python float and a
    tuple, ``perm[i]`` the target matched to estimate ``i``.
    """
    matrix = pairwise_si_sdr(estimates, targets, device=device).cpu().numpy()
    best, perm = _best_permutation(matrix, lambda m, p, i: m[i, p[i]])
    return float(best), perm


def si_sdr_improvement(estimates, mixture_ref, targets, device=None):
    """Mean PIT SI-SDR of the estimates minus that of the (repeated) mixture
    reference channel, a Python float."""
    estimates, mixture_ref, targets = float64_tensors([estimates, mixture_ref, targets], device)
    after, _ = pit_si_sdr(estimates, targets)
    before, _ = pit_si_sdr(mixture_ref[None].expand(targets.shape), targets)
    return after - before


def _toeplitz_index(L, n_fft, device):
    """``(L, L)`` indices ``(a - b) mod n_fft``: element ``(a, b)`` of a
    Gram block is the circular cross-correlation at lag ``a - b`` (``L = 1``
    gives the one lag 0)."""
    a = torch.arange(L, device=device)
    return (a[:, None] - a[None, :]) % n_fft


def _fft_size(n_out):
    return 1 << int(np.ceil(np.log2(n_out)))


def _correlations(refs, L):
    """The references' spectra ``(n_refs, n_fft // 2 + 1)`` and their Gram
    blocks ``(n_refs, n_refs, L, L)``,
    ``G[j, k, a, b] = sum_u s_j[u] s_k[u + a - b]``; blocks below the
    diagonal are the transposes of those above.  ``n_fft >= n_samples + L
    - 1``, so the circular correlations do not wrap."""
    n_refs, n_samp = refs.shape
    n_fft = _fft_size(n_samp + L - 1)
    spectra = torch.fft.rfft(refs, n=n_fft, dim=1)
    cc = torch.fft.irfft(spectra.conj()[:, None] * spectra[None], n=n_fft)  # (n_refs, n_refs, n_fft)
    G = cc[:, :, _toeplitz_index(L, n_fft, refs.device)]
    upper = torch.triu(torch.ones((n_refs, n_refs), dtype=torch.bool, device=refs.device))
    G = torch.where(upper[:, :, None, None], G, G.transpose(0, 1).transpose(2, 3))
    return spectra, G, n_fft


def _project(spectra, G, est_spectrum, which, L, n_fft, n_out):
    """The least-squares projection ``(n_out,)`` of the estimate (spectrum
    ``est_spectrum``) onto the ``L`` shifts of the references ``which``."""
    which = torch.as_tensor(list(which), device=G.device)
    n_refs = which.numel()
    G = G[which][:, which].permute(0, 2, 1, 3).reshape(n_refs * L, n_refs * L)
    sub = spectra[which]
    d = torch.fft.irfft(sub.conj() * est_spectrum, n=n_fft)[:, :L].reshape(-1)
    ridge = 1e-10 * torch.clamp(torch.trace(G) / max(G.shape[0], 1), min=1e-30)
    eye = torch.eye(n_refs * L, dtype=G.dtype, device=G.device)
    h = torch.linalg.solve(G + ridge * eye, d).reshape(n_refs, L)
    return torch.fft.irfft((torch.fft.rfft(h, n=n_fft, dim=1) * sub).sum(dim=0), n=n_fft)[:n_out]


def _fir_projections(refs, est, filter_length, which):
    """Least-squares projection of ``est (n_samples,)`` onto
    ``filter_length``-tap FIR filterings of the rows ``which`` of ``refs
    (n_refs, n_samples)``, jointly, by the block-Toeplitz normal equations
    built from FFT correlations.  Returns the projection, of length
    ``n_samples + filter_length - 1`` (the BSS Eval zero-padded
    convention)."""
    refs, est = float64_tensors([refs, est])
    L = filter_length
    spectra, G, n_fft = _correlations(refs, L)
    n_out = refs.shape[1] + L - 1
    return _project(spectra, G, torch.fft.rfft(est, n=n_fft), which, L, n_fft, n_out)


def bss_eval_sources(reference_sources, estimated_sources, filter_length=512, device=None):
    """BSS Eval v3 SDR / SIR / SAR with mir_eval's permutation selection.

    The decomposition of estimate ``i`` against reference ``j``:
    ``s_target`` = projection onto ``filter_length`` shifts of reference
    ``j`` alone; ``P_all`` = joint projection onto all references' shifts;
    ``e_interf = P_all - s_target``; ``e_artif = est - P_all`` (signals
    zero-padded to ``n_samples + L - 1``, ``L = min(filter_length,
    n_samples)``).  The permutation maximises the mean SIR over sources.

    Args:
        reference_sources: ``(n_sources, n_samples)``.
        estimated_sources: ``(n_sources, n_samples)``.
        filter_length: allowed FIR distortion length (512 = mir_eval's).
    Returns:
        ``(sdr, sir, sar, perm)``: three ``(n_sources,)`` float64 tensors
        on the input's device, ordered by reference index, and ``perm`` a
        NumPy int array, ``perm[j]`` the estimate matched to reference
        ``j``.
    """
    refs, ests = float64_tensors([reference_sources, estimated_sources], device)
    n_src, n_samp = refs.shape
    L = min(filter_length, n_samp)
    n_out = n_samp + L - 1
    spectra, G, n_fft = _correlations(refs, L)

    sdr_m, sir_m, sar_m = [], [], []
    for i in range(n_src):
        est_spectrum = torch.fft.rfft(ests[i], n=n_fft)
        est_pad = torch.nn.functional.pad(ests[i], (0, L - 1))
        p_all = _project(spectra, G, est_spectrum, range(n_src), L, n_fft, n_out)
        artif_energy = torch.sum((est_pad - p_all) ** 2)
        rows = [], [], []
        for j in range(n_src):
            s_target = _project(spectra, G, est_spectrum, [j], L, n_fft, n_out)
            e_interf = p_all - s_target
            target_energy = torch.sum(s_target**2)
            interf_energy = torch.sum(e_interf**2)
            rows[0].append(10 * torch.log10(target_energy / torch.clamp(interf_energy + artif_energy, min=1e-30)))
            rows[1].append(10 * torch.log10(target_energy / torch.clamp(interf_energy, min=1e-30)))
            rows[2].append(10 * torch.log10(torch.sum((s_target + e_interf) ** 2) / torch.clamp(artif_energy, min=1e-30)))
        for out, row in zip((sdr_m, sir_m, sar_m), rows):
            out.append(torch.stack(row))
    sdr_m, sir_m, sar_m = torch.stack(sdr_m), torch.stack(sir_m), torch.stack(sar_m)

    _, best_perm = _best_permutation(sir_m.cpu().numpy(), lambda m, p, j: m[p[j], j])
    idx = np.asarray(best_perm)
    rows, cols = torch.as_tensor(idx, device=refs.device), torch.arange(n_src, device=refs.device)
    return sdr_m[rows, cols], sir_m[rows, cols], sar_m[rows, cols], idx


def bss_eval_improvement(estimates, mixture_ref, targets, filter_length=512, device=None):
    """Mean BSS Eval SDR of the estimates minus that of the (repeated)
    mixture reference channel, a Python float."""
    ests, mixture_ref, tgts = float64_tensors([estimates, mixture_ref, targets], device)
    after, _, _, _ = bss_eval_sources(tgts, ests, filter_length=filter_length)
    before, _, _, _ = bss_eval_sources(tgts, mixture_ref[None].expand(tgts.shape), filter_length=filter_length)
    return float(torch.mean(after) - torch.mean(before))
