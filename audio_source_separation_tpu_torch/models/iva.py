"""Independent vector analysis: the auxiliary-function Laplace IVA with the
IP spatial update (reference ``bss/iva.py:388-619``).

State: ``{"input" (C, F, T), "demix_components" (N, C, F), "psum" (N, T)}``
where ``psum = sum_f |W X|^2`` are the frame power sums of the current rows
-- all that the Laplace contrast needs of the estimates, which are never
formed inside the loop.  The update takes one of two forms:

  * C = 2 with ``guard="one_norm"`` (the default): one call per iteration to
    :func:`~..ops.fused_ip.fused_auxiva_ip_iter`, kernel K2 on CUDA and its
    plain version on the CPU.  Its ``psum`` output is both the next
    iteration's weights and this iteration's loss.
  * C in {3, 4}, or ``guard="none"``: weights ``R = max(sqrt(psum), eps)``,
    ``U`` from :func:`~..ops.covariance.weighted_covariance_auto` (kernel K1
    on CUDA), the component IP sweep, and the new ``psum`` as one matmul
    over the invariant pair-product planes.

Not ported yet (ROADMAP slice 2): ISS, IP2/pairwise, ``guard="svd"`` and
C > 4 raise ``NotImplementedError``; IPA raises ``ValueError`` as in the
reference.
"""

import torch

from ..algorithm.projection_back import projection_back
from ..ops.covariance import weighted_covariance_auto
from ..ops.fused_ip import fused_auxiva_ip_iter
from ..ops.ip_components import (
    frame_power_sums,
    ip_update_components,
    log_abs_det_components,
    pair_products_planes,
    separate_components,
)
from ..runtime.solver import IterativeSolver
from ..utils.flooring import EPS, THRESHOLD, floor_below

__algorithms_spatial__ = ["IP", "IVA", "ISS", "IPA", "pairwise", "IP1", "IP2"]
_PORTED_SPATIAL = ("IP", "IP1", "IVA")
_NOT_PORTED = "is not ported to the PyTorch package yet (ROADMAP slice 2)"


def _rows(Wc):
    """``(N, C, F)`` components as the nested ``rows[n][c]`` list."""
    return [[Wc[s, c] for c in range(Wc.shape[1])] for s in range(Wc.shape[0])]


def _stack_rows(rows):
    return torch.stack([torch.stack(row) for row in rows])


class IVABase(IterativeSolver):
    """Shared IVA machinery: separation and the default demixing filter."""

    state_fields = ("demix_filter", "estimation")

    def __init__(self, callbacks=None, recordable_loss=True, eps=EPS, device=None):
        super().__init__(callbacks=callbacks, recordable_loss=recordable_loss, eps=eps, device=device)

    @staticmethod
    def separate(input, demix_filter):
        """``Y = W X`` per bin: ``(C, F, T) x (F, N, C) -> (N, F, T)``."""
        return separate_components(_rows(demix_filter.permute(1, 2, 0)), input)

    def _default_filter(self, X):
        n_channels, n_bins, _ = X.shape
        eye = torch.eye(n_channels, dtype=X.dtype, device=X.device)
        return eye.expand(n_bins, n_channels, n_channels)

    def __repr__(self):
        return "IVA()"


class AuxIVABase(IVABase):
    """Auxiliary-function IVA base (IP spatial update only in this port)."""

    def __init__(
        self,
        algorithm_spatial="IP",
        reference_id=0,
        callbacks=None,
        apply_projection_back=True,
        recordable_loss=True,
        eps=EPS,
        threshold=THRESHOLD,
        guard="one_norm",
        device=None,
    ):
        super().__init__(callbacks=callbacks, recordable_loss=recordable_loss, eps=eps, device=device)
        if algorithm_spatial not in __algorithms_spatial__:
            raise ValueError("Not support {} based spatial updates.".format(algorithm_spatial))
        if algorithm_spatial in ("ISS", "pairwise", "IP2"):
            raise NotImplementedError("algorithm_spatial={!r} {}".format(algorithm_spatial, _NOT_PORTED))
        if guard == "svd":
            raise NotImplementedError("guard='svd' {}".format(_NOT_PORTED))
        if guard not in ("one_norm", "none"):
            raise ValueError("guard must be 'one_norm', 'none' or 'svd', got {!r}".format(guard))
        self.algorithm_spatial = algorithm_spatial
        self.reference_id = reference_id
        self.apply_projection_back = apply_projection_back
        self.threshold = threshold
        self.guard = guard

    def source_weights_from_power_sums(self, psum, n_bins):
        """Per-(source, frame) auxiliary variance from ``psum = sum_f |Y|^2``."""
        raise NotImplementedError

    def _fused(self, n_channels):
        """Whether an iteration is one call of kernel K2 (C = 2, one-norm
        guard, Laplace contrast)."""
        return False

    def init_state(self, X, demix_filter=None, estimation=None):
        if self.algorithm_spatial not in _PORTED_SPATIAL:
            # IPA: the reference raises on it too
            raise ValueError("Not support {} based spatial updates.".format(self.algorithm_spatial))
        n_channels = X.shape[0]
        if n_channels > 4:
            raise NotImplementedError("AuxIVA with C > 4 channels {}".format(_NOT_PORTED))
        self.n_sources = self.n_channels = n_channels
        self.n_bins, self.n_frames = X.shape[1], X.shape[2]
        if demix_filter is None:
            W = self._default_filter(X)
        else:
            W = torch.as_tensor(demix_filter).to(device=X.device, dtype=X.dtype)
        # a passed ``estimation`` is ignored: the IP update re-derives the
        # estimates from W, as the reference does at reset
        Wc = W.permute(1, 2, 0).contiguous()  # (N, C, F)
        Y = separate_components(_rows(Wc), X)
        state = {"input": X, "demix_components": Wc, "psum": torch.sum(torch.abs(Y) ** 2, dim=1)}
        if not self._fused(n_channels):
            state["pair_products"] = pair_products_planes(X)
        return state

    def update_state(self, state):
        """Power-only IP update (C in {2, 3, 4}, guard one_norm or none)."""
        X = state["input"]
        rows = _rows(state["demix_components"])
        R = floor_below(self.source_weights_from_power_sums(state["psum"], X.shape[1]), self.eps)
        U = weighted_covariance_auto(X, 1.0 / R)  # (N, F, C, C)
        C = X.shape[0]
        U = [[[U[n, :, c, d] for d in range(C)] for c in range(C)] for n in range(U.shape[0])]
        rows = ip_update_components(rows, U, threshold=self.threshold, guard=self.guard)
        return {
            "input": X,
            "demix_components": _stack_rows(rows),
            "psum": frame_power_sums(rows, state["pair_products"]),
            "pair_products": state["pair_products"],
        }

    def _log_abs_det(self, state):
        Wc = state["demix_components"]
        return log_abs_det_components(_rows(Wc), Wc.shape[0])

    def finalize(self, state):
        X = state["input"]
        Y = separate_components(_rows(state["demix_components"]), X)
        if self.apply_projection_back:
            scale = projection_back(Y, reference=X[self.reference_id])
            Y = Y * scale[..., None]
        return Y

    def _sync_attributes(self, state):
        super()._sync_attributes(state)
        # public attribute keeps the reference layout (F, N, C)
        self.demix_filter = state["demix_components"].permute(2, 0, 1)
        if self.callbacks is not None:
            self.estimation = separate_components(_rows(state["demix_components"]), state["input"])

    def __repr__(self):
        return "AuxIVA(algorithm_spatial={})".format(self.algorithm_spatial)


class AuxLaplaceIVA(AuxIVABase):
    """AuxIVA with the Laplace (spherical l2) contrast, ``R = sqrt(psum)``."""

    def source_weights_from_power_sums(self, psum, n_bins):
        return torch.sqrt(psum)

    def _fused(self, n_channels):
        return n_channels == 2 and self.guard == "one_norm"

    def update_state(self, state):
        X = state["input"]
        if not self._fused(X.shape[0]):
            return super().update_state(state)
        Wc, psum, _, nll = fused_auxiva_ip_iter(
            X, state["demix_components"], state["psum"], eps=self.eps, threshold=self.threshold
        )
        return {"input": X, "demix_components": Wc, "psum": psum, "nll_value": nll}

    def nll(self, state):
        """``2 sum_t sqrt(psum) - 2 T sum_f log|det W_f|`` (K2 returns it)."""
        if "nll_value" in state:
            return state["nll_value"]
        n_frames = state["input"].shape[-1]
        return 2 * torch.sqrt(state["psum"]).sum() - 2 * n_frames * self._log_abs_det(state).sum()

    def __repr__(self):
        return "AuxLaplaceIVA(algorithm_spatial={})".format(self.algorithm_spatial)
