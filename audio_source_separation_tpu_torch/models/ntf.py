"""Nonnegative tensor factorisation: 3-way CP with nonnegativity (reference
``src/algorithm/ntf.py``, ``EUCNTF``).

``X[c, f, t] ~ sum_k Z[c, k] T[f, k] V[k, t]`` with Euclidean multiplicative
updates; ``Z, T, V = model(target, iteration=N)`` on a nonnegative
``(n_channels, n_bins, n_frames)`` tensor.  Each factor's numerator and
denominator are batched GEMMs over the channels; no ``(C, F, K, T)``
product is formed.
"""

import numpy as np

from ..runtime.solver import IterativeSolver, state_tensor
from ..utils.flooring import EPS, floor_below


def _reconstruct(Z, T, V):
    """``sum_k Z[c, k] T[f, k] V[k, t] -> (C, F, T)``, one batched GEMM."""
    return (Z[:, None, :] * T) @ V


class NTFBase(IterativeSolver):
    state_fields = ("partitioning", "basis", "activation")
    record_initial_loss = False
    real_input = True

    def __init__(self, n_basis=2, eps=EPS, device=None):
        super().__init__(callbacks=None, recordable_loss=True, eps=eps, device=device)
        self.n_basis = n_basis

    def prepare_state_kwargs(self, target, state_kwargs):
        n_channels, n_bins, n_frames = target.shape
        if "partitioning" not in state_kwargs:
            state_kwargs["partitioning"] = np.random.rand(n_channels, self.n_basis)
        if "basis" not in state_kwargs:
            state_kwargs["basis"] = np.random.rand(n_bins, self.n_basis)
        if "activation" not in state_kwargs:
            state_kwargs["activation"] = np.random.rand(self.n_basis, n_frames)
        return state_kwargs

    def init_state(self, target, partitioning=None, basis=None, activation=None):
        return {
            "target": target,
            "partitioning": state_tensor(partitioning, target),
            "basis": state_tensor(basis, target),
            "activation": state_tensor(activation, target),
        }

    def reconstruct(self, state):
        return _reconstruct(state["partitioning"], state["basis"], state["activation"])

    def capturable(self, X):
        return True

    def finalize(self, state):
        return state["partitioning"], state["basis"], state["activation"]


class EUCNTF(NTFBase):
    """Euclidean NTF multiplicative updates (``ntf.py:50-102``)."""

    def update_state(self, state):
        eps = self.eps
        X = state["target"]
        Z, T, V = state["partitioning"], state["basis"], state["activation"]

        def step(factor, contract):
            # factor * (X . others) / (X^ . others), both floored at eps
            X_hat = _reconstruct(Z, T, V)
            return factor * (floor_below(contract(X), eps) / floor_below(contract(X_hat), eps))

        T = step(T, lambda A: ((A @ V.T) * Z[:, None, :]).sum(dim=0))  # sum_{c,t} A Z V
        V = step(V, lambda A: ((Z[:, None, :] * T).transpose(1, 2) @ A).sum(dim=0))  # sum_{c,f} A Z T
        Z = step(Z, lambda A: ((A @ V.T) * T).sum(dim=1))  # sum_{f,t} A T V
        return {"target": X, "partitioning": Z, "basis": T, "activation": V}

    def nll(self, state):
        return ((state["target"] - self.reconstruct(state)) ** 2).sum()
