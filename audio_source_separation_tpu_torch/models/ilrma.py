"""Independent low-rank matrix analysis (ILRMA) solver family (reference
``bss/ilrma.py``).

  * ``GaussILRMA``: IVA with a per-source NMF variance model ``R = (T V)^(2 /
    domain)``; spatial updates IP, ISS and IP2/pairwise; an optional
    shared-basis partitioning latent ``Z (n_sources, n_basis)``; ``power``
    or ``projection-back`` normalisation each iteration;
  * ``TILRMA`` (alias ``tILRMA``): the Student-t source model (harmonic MU
    update) with the posterior-weighted IP, ``Xi = (nu R + 2 P) / (nu + 2)``;
  * ``ConsistentGaussILRMA``: GaussILRMA IP with projection-back folded into
    ``W`` and the basis each iteration;
  * ``GGDILRMA``, ``KLILRMA`` and ``RegularizedILRMA`` raise, as in the
    reference.

The state takes one of two forms, fixed at init:

  * power form (IP, IP2, ``TILRMA`` and ``ConsistentGaussILRMA`` with
    ``normalize`` in (False, True, "power")): ``{"input", "demix_filter"
    (F, N, C), "pair_products" (C^2, F, T), "estimation_power" (N, F, T),
    "basis", "activation"[, "latent"][, "step_count"]}``.  Every update needs
    only ``P = |W X|^2``, restored from the invariant planes by
    :func:`~..ops.ip_components.quadratic_power_planes`; the complex
    estimates are formed only for the output and the callbacks.
  * complex form (ISS, and ``normalize="projection-back"``): ``estimation``
    (N, F, T) complex in place of the power and the planes; ISS carries no
    ``W``.

The spatial covariances take ILRMA's per-bin weights ``1/R (N, F, T)``
through kernel K1 (:func:`~..ops.cov_kernel.weighted_covariance_planes`, one
launch; IP2's two rows in one launch), then the component IP sweep at C <= 4
with a cheap guard, else the matrix one.
"""

import warnings

import numpy as np
import torch

from ..algorithm.projection_back import projection_back
from ..ops.cov_kernel import weighted_covariance_planes
from ..ops.fast_linalg import batched_log_abs_det
from ..ops.ip_components import (
    _take,
    assemble_matrices,
    filter_rows,
    gram_components,
    ip2_pair_update_planes,
    pair_products_planes,
    projection_back_components,
    quadratic_power_planes,
)
from ..ops.iss import iss_sweep
from ..utils.flooring import EPS, THRESHOLD, floor_below
from .iva import IVABase, _pair_update_matrix

__algorithms_spatial__ = ["IP", "IVA", "ISS", "IPA", "pairwise", "IP1", "IP2"]


def _real_tensor(value, X):
    return torch.as_tensor(value).to(device=X.device, dtype=X.real.dtype).contiguous()


class ILRMABase(IVABase):
    """Shared ILRMA machinery (``bss/ilrma.py:22-176``)."""

    state_fields = ("demix_filter", "estimation", "basis", "activation", "latent", "step_count")

    def __init__(
        self,
        n_basis=10,
        partitioning=False,
        normalize=True,
        algorithm_spatial="IP",
        callbacks=None,
        recordable_loss=True,
        eps=EPS,
        device=None,
    ):
        super().__init__(callbacks=callbacks, recordable_loss=recordable_loss, eps=eps, device=device)
        self.n_basis = n_basis
        self.partitioning = partitioning
        self.normalize = normalize
        # AssertionError, as the JAX package's asserts raise, but kept under -O
        if algorithm_spatial not in __algorithms_spatial__:
            raise AssertionError("Choose from {} as `algorithm_spatial`.".format(__algorithms_spatial__))
        if algorithm_spatial not in ["IP", "ISS", "pairwise", "IP1", "IP2"]:
            raise AssertionError("Not support {}-based demixing filter updates.".format(algorithm_spatial))
        self.algorithm_spatial = algorithm_spatial

    @property
    def _is_iss(self):
        return self.algorithm_spatial == "ISS"

    @property
    def _is_pairwise(self):
        return self.algorithm_spatial in ("pairwise", "IP2")

    @property
    def _power_form(self):
        """Whether the state carries ``estimation_power`` (module docstring)."""
        return False

    def prepare_state_kwargs(self, input, state_kwargs):
        """Random source-model init by the host NumPy RNG, in the reference's
        draw order (``ilrma.py:79-104``)."""
        n_channels, n_bins, n_frames = input.shape
        n_sources = n_channels
        n_basis, eps = self.n_basis, self.eps
        if self.partitioning:
            if "latent" not in state_kwargs:
                Z = np.random.rand(n_sources, n_basis) * 1e-2 + 1 / n_sources
                state_kwargs["latent"] = Z / np.maximum(Z.sum(axis=0), eps)
            if "basis" not in state_kwargs:
                state_kwargs["basis"] = np.random.rand(n_bins, n_basis)
            if "activation" not in state_kwargs:
                state_kwargs["activation"] = np.random.rand(n_basis, n_frames)
        else:
            if "basis" not in state_kwargs:
                state_kwargs["basis"] = np.random.rand(n_sources, n_bins, n_basis)
            if "activation" not in state_kwargs:
                state_kwargs["activation"] = np.random.rand(n_sources, n_basis, n_frames)
        return state_kwargs

    def init_state(
        self, X, demix_filter=None, estimation=None, basis=None, activation=None, latent=None, step_count=None
    ):
        W = self._initial_filter(X, demix_filter)
        state = {"input": X, "basis": _real_tensor(basis, X), "activation": _real_tensor(activation, X)}
        if self.partitioning:
            state["latent"] = _real_tensor(latent, X)
        if self._is_iss:
            # ISS carries no W: a passed ``estimation`` is the state
            state["estimation"] = self.separate(X, W) if estimation is None else torch.as_tensor(estimation).to(X)
            return state
        state["demix_filter"] = W
        if self._power_form:
            planes = pair_products_planes(X)
            state["pair_products"] = planes
            state["estimation_power"] = quadratic_power_planes(W, planes)
        else:
            # the estimates are re-derived from W, as the reference does at reset
            state["estimation"] = self.separate(X, W)
        if self._is_pairwise:
            k = 0 if step_count is None else step_count
            state["step_count"] = torch.as_tensor(k, dtype=torch.int64, device=X.device).reshape(())
        return state

    def source_variance(self, state):
        """``R (n_sources, n_bins, n_frames)`` from the NMF source model."""
        domain = getattr(self, "domain", 2)
        if self.partitioning:
            # contiguous: einsum may return a permuted view, and K1 takes 1/R as is
            ZTV = torch.einsum("sk,fk,kt->sft", state["latent"], state["basis"], state["activation"]).contiguous()
            return ZTV ** (2 / domain)
        return (state["basis"] @ state["activation"]) ** (2 / domain)

    def _estimation_power(self, state):
        if "estimation_power" in state:
            return state["estimation_power"]
        return torch.abs(state["estimation"]) ** 2

    def _refresh_estimation(self, state, W):
        """The estimates of a new ``W`` in the state's form."""
        if "estimation_power" in state:
            return {"estimation_power": quadratic_power_planes(W, state["pair_products"])}
        return {"estimation": self.separate(state["input"], W)}

    def _log_abs_det(self, state):
        """``log|det W_f| (F,)``; ISS fits ``W`` by least squares in float64
        (see ``AuxIVABase._log_abs_det``: the NLL scales it by ``2 T``)."""
        if "demix_filter" in state:
            return batched_log_abs_det(state["demix_filter"])
        X = state["input"]
        W = self.compute_demix_filter(state["estimation"], X, solve_dtype=torch.complex128)
        return batched_log_abs_det(W).to(X.real.dtype)

    def _estimates(self, state):
        if "estimation" in state:
            return state["estimation"]
        return self.separate(state["input"], state["demix_filter"])

    def finalize(self, state):
        # projection-back is unconditional in ILRMA (``ilrma.py:269-271``)
        Y = self._estimates(state)
        scale = projection_back(Y, reference=state["input"][self.reference_id])
        return Y * scale[..., None]

    def _sync_attributes(self, state):
        super()._sync_attributes(state)
        if self.callbacks is not None and "estimation" not in state:
            self.estimation = self._estimates(state)
        if self._is_iss:
            # the reference fits W for the callbacks only
            fit = self.callbacks is not None
            self.demix_filter = self.compute_demix_filter(state["estimation"], state["input"]) if fit else None

    def __repr__(self):
        return "ILRMA(n_basis={}, partitioning={}, normalize={})".format(
            self.n_basis, self.partitioning, self.normalize
        )


class GaussILRMA(ILRMABase):
    """Gaussian ILRMA (``bss/ilrma.py:178-677``)."""

    def __init__(
        self,
        n_basis=10,
        domain=2,
        partitioning=False,
        normalize="power",
        algorithm_spatial="IP",
        reference_id=0,
        callbacks=None,
        recordable_loss=True,
        eps=EPS,
        threshold=THRESHOLD,
        guard="one_norm",
        iss_compat=False,
        device=None,
    ):
        super().__init__(
            n_basis=n_basis,
            partitioning=partitioning,
            normalize=normalize,
            algorithm_spatial=algorithm_spatial,
            callbacks=callbacks,
            recordable_loss=recordable_loss,
            eps=eps,
            device=device,
        )
        if not 1 <= domain <= 2:
            raise AssertionError("1 <= `domain` <= 2 is not satisfied.")
        self.domain = domain
        self.reference_id = reference_id
        self.threshold = threshold
        self.guard = guard
        self.iss_compat = iss_compat
        if self.algorithm_spatial == "ISS":
            warnings.warn("in progress", UserWarning)

    @property
    def _power_form(self):
        # ISS updates the estimates in place and projection-back is a complex
        # per-bin least squares: both need Y; everything else needs P = |Y|^2
        return not self._is_iss and self.normalize in (False, True, "power")

    # the source model
    def _mu_step(self, P, T, V):
        """One MU sweep of the basis, then the activation, for ``P (.., F,
        T)``, ``T (.., F, K)`` and ``V (.., K, T)``."""
        domain, eps = self.domain, self.eps
        exponent = domain / (domain + 2)
        TV = floor_below(T @ V, eps)
        division, TV_inv = P / TV ** ((domain + 2) / domain), 1 / TV
        TVV = floor_below(TV_inv @ V.transpose(-2, -1), eps)
        T = T * (division @ V.transpose(-2, -1) / TVV) ** exponent

        TV = floor_below(T @ V, eps)
        division, TV_inv = P / TV ** ((domain + 2) / domain), 1 / TV
        TTV = floor_below(T.transpose(-2, -1) @ TV_inv, eps)
        V = V * (T.transpose(-2, -1) @ division / TTV) ** exponent
        return T, V

    def _update_source_basic(self, state):
        P = self._estimation_power(state)
        if not self.partitioning:
            T, V = self._mu_step(P, state["basis"], state["activation"])
            return dict(state, basis=T, activation=V)

        eps = self.eps
        if self.domain != 2:
            raise AssertionError("Not support domain = {}".format(self.domain))
        Z, T, V = state["latent"], state["basis"], state["activation"]

        def ztv(Z, T, V):
            return floor_below(torch.einsum("sk,fk,kt->sft", Z, T, V), eps)

        ZTV = ztv(Z, T, V)
        division, ZTV_inv = P / ZTV**2, 1 / ZTV
        num = torch.einsum("sft,fk,kt->sk", division, T, V)
        den = floor_below(torch.einsum("sft,fk,kt->sk", ZTV_inv, T, V), eps)
        Z = torch.sqrt(num / den)
        Z = Z / Z.sum(dim=0)

        ZTV = ztv(Z, T, V)
        division, ZTV_inv = P / ZTV**2, 1 / ZTV
        num = torch.einsum("sft,sk,kt->fk", division, Z, V)
        den = floor_below(torch.einsum("sft,sk,kt->fk", ZTV_inv, Z, V), eps)
        T = T * torch.sqrt(num / den)

        ZTV = ztv(Z, T, V)
        division, ZTV_inv = P / ZTV**2, 1 / ZTV
        num = torch.einsum("sft,sk,fk->kt", division, Z, T)
        den = floor_below(torch.einsum("sft,sk,fk->kt", ZTV_inv, Z, T), eps)
        V = V * torch.sqrt(num / den)
        return dict(state, latent=Z, basis=T, activation=V)

    def _update_source_pairwise(self, state, m, n):
        """MU sweeps of sources ``m`` and ``n`` only (``ilrma.py:432-481``);
        ``m``, ``n`` are 0-d tensors on the device."""
        if self.partitioning:
            raise NotImplementedError("Not support partitioning function.")
        P_all = self._estimation_power(state)
        T, V = state["basis"], state["activation"]
        for idx in (m, n):
            T_i, V_i = self._mu_step(_take(P_all, idx, 0), _take(T, idx, 0), _take(V, idx, 0))
            T = T.index_copy(0, idx.reshape(1), T_i[None])
            V = V.index_copy(0, idx.reshape(1), V_i[None])
        return dict(state, basis=T, activation=V)

    # the spatial model
    def _update_spatial_ip(self, state):
        R = floor_below(self.source_variance(state), self.eps)
        W = self._ip_sweep(state, 1.0 / R)
        return dict(state, demix_filter=W, **self._refresh_estimation(state, W))

    def _update_spatial_iss(self, state):
        R = floor_below(self.source_variance(state), self.eps)
        return dict(state, estimation=iss_sweep(state["estimation"], 1.0 / R, compat=self.iss_compat))

    def _update_spatial_pairwise(self, state, m, n):
        X, W = state["input"], state["demix_filter"]
        pair = torch.stack([m, n])
        T, V = state["basis"].index_select(0, pair), state["activation"].index_select(0, pair)
        R_mn = floor_below((T @ V) ** (2 / self.domain), self.eps)
        U_mn = assemble_matrices(weighted_covariance_planes(X, 1.0 / R_mn))  # (2, F, C, C): one K1 launch
        if self.guard in ("one_norm", "none") and W.shape[1] == W.shape[2] <= 3:
            W = ip2_pair_update_planes(W, U_mn.permute(0, 2, 3, 1), m, n, threshold=self.threshold, guard=self.guard)
        else:
            W = _pair_update_matrix(W, U_mn, m, n, self.threshold, self.guard)
        return dict(state, demix_filter=W, **self._refresh_estimation(state, W))

    # normalisation (``ilrma.py:293-338``)
    def _normalize_state(self, state):
        if not self.normalize:
            return state
        eps, domain = self.eps, self.domain
        X, T = state["input"], state["basis"]
        W = state.get("demix_filter")  # ISS carries none, and needs none here
        Y = state.get("estimation")
        if self.normalize == "power" or self.normalize is True:
            P = self._estimation_power(state)
            aux = floor_below(torch.sqrt(P.sum(dim=(1, 2)) / (P.shape[1] * P.shape[2])), eps)  # (S,)
            if W is not None:
                W = W / aux[None, :, None]
            if Y is None:
                state = dict(state, estimation_power=P / aux[:, None, None] ** 2)
            else:
                Y = Y / aux[:, None, None]
            if self.partitioning:
                Zaux = state["latent"] / aux[:, None] ** domain
                Zauxsum = Zaux.sum(dim=0)
                T = T * Zauxsum
                state = dict(state, latent=Zaux / Zauxsum)
            else:
                T = T / aux[:, None, None] ** domain
        elif self.normalize == "projection-back":
            if self.partitioning:
                raise NotImplementedError(
                    "Not support 'projection-back' based normalization for "
                    "partitioninig function. Choose 'power' based normalization."
                )
            scale = projection_back(Y, reference=X[self.reference_id])  # (S, F)
            Y = Y * scale[..., None]
            if W is not None:
                W = W * scale.transpose(0, 1)[..., None]
            T = T * torch.abs(scale[..., None]) ** domain
        else:
            raise ValueError(
                "Not support normalization based on {}. Choose 'power' or 'projection-back'".format(self.normalize)
            )
        state = dict(state, basis=T)
        if Y is not None:
            state["estimation"] = Y
        if W is not None:
            state["demix_filter"] = W
        return state

    def update_state(self, state):
        if self._is_pairwise:
            k = state["step_count"]
            n_sources = state["basis"].shape[0]
            m, n = k % n_sources, (k + 1) % n_sources
            state = self._update_source_pairwise(state, m, n)
            state = self._update_spatial_pairwise(state, m, n)
            state = dict(state, step_count=k + 1)
        else:
            state = self._update_source_basic(state)
            if self.algorithm_spatial in ("IP", "IP1"):
                state = self._update_spatial_ip(state)
            elif self._is_iss:
                state = self._update_spatial_iss(state)
        return self._normalize_state(state)

    def nll(self, state):
        """``sum (P / R + log R) - 2 T sum log|det W|`` (``ilrma.py:648-677``)."""
        P = self._estimation_power(state)
        R = floor_below(self.source_variance(state), self.eps)
        n_frames = state["input"].shape[-1]
        return torch.sum(P / R + torch.log(R)) - 2 * n_frames * self._log_abs_det(state).sum()

    def __repr__(self):
        return "Gauss-ILRMA(n_basis={}, domain={}, partitioning={}, normalize={}, algorithm_spatial={})".format(
            self.n_basis, self.domain, self.partitioning, self.normalize, self.algorithm_spatial
        )


class TILRMA(ILRMABase):
    """Student-t ILRMA (``bss/ilrma.py:713-1020``), IP only."""

    def __init__(
        self,
        n_basis=10,
        nu=1,
        domain=2,
        partitioning=False,
        normalize="power",
        algorithm_spatial="IP",
        reference_id=0,
        callbacks=None,
        recordable_loss=True,
        eps=EPS,
        threshold=THRESHOLD,
        guard="one_norm",
        device=None,
    ):
        super().__init__(
            n_basis=n_basis,
            partitioning=partitioning,
            normalize=normalize,
            algorithm_spatial=algorithm_spatial,
            callbacks=callbacks,
            recordable_loss=recordable_loss,
            eps=eps,
            device=device,
        )
        if self.algorithm_spatial != "IP":
            raise AssertionError("Supports only IP-based spatial update.")
        self.nu = nu
        self.domain = domain
        self.reference_id = reference_id
        self.threshold = threshold
        self.guard = guard

    @property
    def _power_form(self):
        return self.normalize in (False, True, "power")

    def source_variance(self, state):
        # t-ILRMA uses R = TV directly in the spatial weights (``ilrma.py:959``)
        if self.partitioning:
            return torch.einsum("sk,fk,kt->sft", state["latent"], state["basis"], state["activation"]).contiguous()
        return state["basis"] @ state["activation"]

    def _update_source(self, state):
        nu, eps = self.nu, self.eps
        if self.domain != 2:
            raise AssertionError("Only domain = 2 is supported.")
        if self.partitioning:
            raise NotImplementedError("Only support when `partitioning=False` ")
        P = self._estimation_power(state)
        T, V = state["basis"], state["activation"]

        TV = floor_below(T @ V, eps)
        harmonic = 1 / (2 / ((2 + nu) * TV) + nu / ((2 + nu) * P))
        division, TV_inv = harmonic / TV**2, 1 / TV
        TVV = floor_below(TV_inv @ V.transpose(-2, -1), eps)
        T = T * torch.sqrt(division @ V.transpose(-2, -1) / TVV)

        TV = floor_below(T @ V, eps)
        harmonic = 1 / (2 / ((2 + nu) * TV) + nu / ((2 + nu) * P))
        division, TV_inv = harmonic / TV**2, 1 / TV
        TTV = floor_below(T.transpose(-2, -1) @ TV_inv, eps)
        V = V * torch.sqrt(T.transpose(-2, -1) @ division / TTV)
        return dict(state, basis=T, activation=V)

    def _update_spatial(self, state):
        """Posterior-weighted IP, ``Xi = (nu R + 2 P) / (nu + 2)``
        (``ilrma.py:961-989``), with the reference's denominator floor on the
        guarded sweep.

        Documented divergence: the reference runs unguarded (NumPy float64).
        At float32 ``nu = 1`` spreads the weights ``1/Xi`` over about 10
        decades and ``det(W U)`` cancels (exact zeros, then inf rows, then
        NaN).  The kappa_1 guard keeps the previous row where the update is
        rounding noise; ``guard="none"`` restores the reference's behaviour.
        """
        P = self._estimation_power(state)
        R = floor_below(self.source_variance(state), self.eps)
        Xi = (self.nu * R + 2 * P) / (self.nu + 2)
        W = self._ip_sweep(state, 1.0 / Xi, denom_floor=self.eps)
        return dict(state, demix_filter=W, **self._refresh_estimation(state, W))

    def _normalize_state(self, state):
        if not self.normalize:
            return state
        if not (self.normalize == "power" or self.normalize is True):
            raise ValueError(
                "Not support normalization based on {}. Choose 'power' or 'projection-back'".format(self.normalize)
            )
        P = self._estimation_power(state)
        aux = floor_below(torch.sqrt(P.mean(dim=(1, 2))), self.eps)
        state = dict(state, demix_filter=state["demix_filter"] / aux[None, :, None])
        if "estimation" in state:
            state["estimation"] = state["estimation"] / aux[:, None, None]
        else:
            state["estimation_power"] = P / aux[:, None, None] ** 2
        T = state["basis"]
        if self.partitioning:
            Zaux = state["latent"] / aux[:, None] ** 2
            Zauxsum = Zaux.sum(dim=0)
            state["latent"] = Zaux / Zauxsum
            state["basis"] = T * Zauxsum
        else:
            state["basis"] = T / aux[:, None, None] ** 2
        return state

    def update_state(self, state):
        state = self._update_source(state)
        state = self._update_spatial(state)
        return self._normalize_state(state)

    def nll(self, state):
        """The t-NLL (``ilrma.py:993-1020``)."""
        nu = self.nu
        P = self._estimation_power(state)
        R = floor_below(self.source_variance(state), self.eps)
        n_frames = state["input"].shape[-1]
        return torch.sum((1 + nu / 2) * torch.log(1 + (2 / nu) * (P / R)) + torch.log(R)) - 2 * n_frames * (
            self._log_abs_det(state).sum()
        )

    def __repr__(self):
        return "t-ILRMA(n_basis={}, nu={}, domain={}, partitioning={}, normalize={}, algorithm_spatial={})".format(
            self.n_basis, self.nu, self.domain, self.partitioning, self.normalize, self.algorithm_spatial
        )


class ConsistentGaussILRMA(GaussILRMA):
    """Consistency-projected Gaussian ILRMA (``bss/ilrma.py:1102-1233``): IP,
    no normalisation, and projection-back folded into ``W`` and the basis at
    the end of every iteration.

    The reference starts each iteration with an ``istft -> stft`` projection
    of the estimates, then discards it: its IP source update re-separates
    ``Y = W X`` whenever a filter exists (``ilrma.py:360-364``), so the
    projection feeds no update.  The JAX package computes it and throws it
    away too.  It is not computed here; the trajectories are the same.
    """

    def __init__(
        self,
        n_basis=10,
        partitioning=False,
        algorithm_spatial="IP",
        reference_id=0,
        fft_size=None,
        hop_size=None,
        callbacks=None,
        recordable_loss=True,
        eps=EPS,
        threshold=THRESHOLD,
        guard="one_norm",
        device=None,
    ):
        super().__init__(
            n_basis=n_basis,
            partitioning=partitioning,
            normalize=False,
            algorithm_spatial=algorithm_spatial,
            reference_id=reference_id,
            callbacks=callbacks,
            recordable_loss=recordable_loss,
            eps=eps,
            threshold=threshold,
            guard=guard,
            device=device,
        )
        if fft_size is None:
            raise ValueError("Specify `fft_size`.")
        if hop_size is None:
            hop_size = fft_size // 2
        self.fft_size, self.hop_size = fft_size, hop_size
        if self.algorithm_spatial != "IP":
            raise AssertionError("Supports only IP-based spatial update.")

    def update_state(self, state):
        state = self._update_source_basic(state)
        state = self._update_spatial_ip(state)
        if self.partitioning:
            raise NotImplementedError(
                "Not support 'projection-back' based normalization for "
                "partitioninig function. Choose 'power' based normalization."
            )
        # the fold (``ilrma.py:1212-1233``), its scales from the invariant
        # frame-summed mixture Gram: no complex (N, F, T) estimate
        W, planes = state["demix_filter"], state["pair_products"]
        scale = torch.stack(
            projection_back_components(filter_rows(W), gram_components(planes), reference_id=self.reference_id)
        )  # (S, F)
        W = W * scale.transpose(0, 1)[..., None]
        T = state["basis"] * torch.abs(scale[..., None]) ** 2
        return dict(state, demix_filter=W, estimation_power=quadratic_power_planes(W, planes), basis=T)

    def __repr__(self):
        return "Consistent-GaussILRMA(n_basis={}, domain={}, partitioning={}, algorithm_spatial={})".format(
            self.n_basis, self.domain, self.partitioning, self.algorithm_spatial
        )


class GGDILRMA(ILRMABase):
    """Stub, as in the reference (``bss/ilrma.py:679-699``)."""

    def __init__(self, n_basis=10, beta=1, domain=2, **kwargs):
        super().__init__(n_basis=n_basis, **kwargs)
        self.beta = beta
        self.domain = domain
        raise NotImplementedError("Implement GGD-ILRMA")


class KLILRMA(ILRMABase):
    """Stub, as in the reference (``bss/ilrma.py:1022-1033``)."""

    def __init__(self, n_basis=10, **kwargs):
        super().__init__(n_basis=n_basis, **kwargs)
        raise NotImplementedError("Implement KL-ILRMA")


class RegularizedILRMA(ILRMABase):
    """Stub, as in the reference (``bss/ilrma.py:1084-1100``)."""

    def __init__(self, n_basis=10, **kwargs):
        super().__init__(n_basis=n_basis, **kwargs)
        raise NotImplementedError("Implement Regularized ILRMA")


tILRMA = TILRMA  # the reference's name
