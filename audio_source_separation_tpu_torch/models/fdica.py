"""Frequency-domain ICA (FDICA) solver family (reference ``bss/fdica.py``).

  * ``GradLaplaceFDICA``: gradient descent on the per-bin Laplace FDICA NLL
    with the score ``Phi = Y / |Y|`` (``fdica.py:203-247``);
  * ``NaturalGradLaplaceFDICA``: the natural gradient ``dW = (Phi Y^H / T
    - I) W``; ``is_holonomic=False`` raises, as in the reference
    (``fdica.py:283``).

Square W at C <= 4 steps in component layout
(:func:`~..ops.ip_components.plain_grad_step_components`,
:func:`~..ops.ip_components.natural_grad_step_components`); otherwise in
matrix layout.  No kernel is on this path.

After the loop, :meth:`GradFDICABase.finalize` aligns the bins' source
permutations (:func:`~..algorithm.permutation.solve_permutation`, the
greedy sweep of ``fdica.py:106-138`` on the host), publishes the aligned
filter as ``demix_filter`` (what ``save_state`` writes), and projects the
estimates back onto ``reference_id``.  The runtime has no separate
post-processing hook: ``finalize`` is where the JAX package's
``_run_finalize`` work happens.
"""

import torch

from ..algorithm.permutation import solve_permutation
from ..algorithm.projection_back import projection_back
from ..ops.fast_linalg import batched_log_abs_det
from ..ops.ip_components import (
    filter_rows,
    natural_grad_step_components,
    plain_grad_step_components,
    separate_components,
    stack_filter_rows,
)
from ..utils.flooring import EPS, floor_below
from .iva import IVABase


class FDICABase(IVABase):
    """Shared FDICA machinery (``bss/fdica.py:8-150``)."""

    def field_axes(self):
        """Nothing shards: the permutation alignment couples every bin, so
        under a mesh each rank runs the whole problem."""
        return {}

    state_fields = ("demix_filter", "estimation")

    def nll(self, state):
        """Per-bin Laplace NLL ``sum_f (2 sum_n mean_t |Y| - 2 log|det W_f|)``
        (``fdica.py:241-247``)."""
        loss = 2 * torch.abs(state["estimation"]).sum(dim=0).mean(dim=1) - 2 * batched_log_abs_det(
            state["demix_filter"]
        )
        return loss.sum()

    def _score(self, Y):
        """Laplace score ``Y / |Y|``, elementwise (any layout)."""
        return Y / floor_below(torch.abs(Y), self.eps)

    def __repr__(self):
        return "FDICA()"


class GradFDICABase(FDICABase):
    def __init__(self, lr=1e-1, reference_id=0, callbacks=None, recordable_loss=True, eps=EPS, device=None):
        super().__init__(callbacks=callbacks, recordable_loss=recordable_loss, eps=eps, device=device)
        self.lr = lr
        self.reference_id = reference_id

    def capturable(self, X):
        """Every configuration: the gradient step reads nothing on the host;
        the permutation alignment runs in :meth:`finalize`, after the loop."""
        return True

    def finalize(self, state):
        """Permutation alignment, then projection-back; sets the aligned
        ``demix_filter`` (``fdica.py:69-84`` of the JAX package)."""
        X = state["input"]
        W = solve_permutation(state["demix_filter"], state["estimation"], eps=self.eps)
        self.demix_filter = W
        Y = self.separate(X, W)
        scale = projection_back(Y, reference=X[self.reference_id])
        return Y * scale[..., None]

    def __repr__(self):
        return "GradFDICA(lr={})".format(self.lr)


class GradLaplaceFDICA(GradFDICABase):
    """Plain-gradient Laplace FDICA, ``dW = Phi X^H / T - W^{-H}``
    (``fdica.py:203-247``)."""

    def update_state(self, state):
        X, W, Y = state["input"], state["demix_filter"], state["estimation"]
        if self._component_step(W):
            rows = plain_grad_step_components(filter_rows(W), X, self._score(Y), self.lr)
            return dict(state, demix_filter=stack_filter_rows(rows), estimation=separate_components(rows, X))
        X_h = X.permute(1, 2, 0).conj()  # (F, T, C)
        W_invH = torch.linalg.inv_ex(W).inverse.transpose(-2, -1).conj()
        Phi = self._score(Y).permute(1, 0, 2)  # (F, N, T)
        W = W - self.lr * ((Phi @ X_h) / X.shape[-1] - W_invH)
        return dict(state, demix_filter=W, estimation=self.separate(X, W))


class NaturalGradLaplaceFDICA(GradFDICABase):
    """Natural-gradient Laplace FDICA (``fdica.py:249-301``)."""

    def __init__(self, lr=1e-1, reference_id=0, is_holonomic=True, **kwargs):
        super().__init__(lr=lr, reference_id=reference_id, **kwargs)
        self.is_holonomic = is_holonomic

    def update_state(self, state):
        if not self.is_holonomic:
            raise NotImplementedError("only suports for is_holonomic = True")
        X, W, Y = state["input"], state["demix_filter"], state["estimation"]
        if self._component_step(W):
            rows = natural_grad_step_components(filter_rows(W), Y, self._score(Y), self.lr)
            return dict(state, demix_filter=stack_filter_rows(rows), estimation=separate_components(rows, X))
        Yb = Y.permute(1, 0, 2)  # (F, N, T)
        eye = torch.eye(X.shape[0], dtype=X.dtype, device=X.device)
        Phi = self._score(Yb)
        W = W - self.lr * (((Phi @ Yb.transpose(-2, -1).conj()) / X.shape[-1] - eye) @ W)
        return dict(state, demix_filter=W, estimation=self.separate(X, W))

    def __repr__(self):
        return "NaturalGradLaplaceFDICA(lr={}, is_holonomic={})".format(self.lr, self.is_holonomic)
