"""Uniform padded block layout for block-diagonal frequency models (IPSDTA).

The reference partitions the ``n_bins`` axis into ``n_blocks`` blocks of
``n_neighbors = n_bins // n_blocks`` bins, the last ``n_remains = n_bins %
n_blocks`` blocks one bin larger, and keeps "low" and "high" code paths for
the two sizes.  Here every block is padded to ``block_size = n_neighbors
(+1 if n_remains)`` with a fixed validity mask, one representation for both.

Invariants the solvers rely on:
  * block vectors (``gather``) carry zeros in padded slots;
  * block matrices (the basis ``U``) carry zeros in padded rows and columns;
  * before an inverse, eigendecomposition or log-determinant, an identity
    goes into the padded diagonal (:meth:`BlockLayout.pad_identity`), so the
    padded dimensions decouple and contribute ``log 1 = 0`` and identity
    inverses;
  * traces and quadratic forms then need no correction (padded parts are 0).

The index and mask tables are NumPy arrays; each goes to a device the first
time an input on that device uses it, and stays cached there.
"""

import numpy as np
import torch


class BlockLayout:
    """Fixed description of the block partition of a bin axis."""

    def __init__(self, n_bins, n_blocks):
        n_neighbors = n_bins // n_blocks
        n_remains = n_bins % n_blocks
        self.n_bins = n_bins
        self.n_blocks = n_blocks
        self.n_neighbors = n_neighbors
        self.n_remains = n_remains
        self.block_size = n_neighbors + (1 if n_remains > 0 else 0)

        sizes = np.full(n_blocks, n_neighbors)
        sizes[n_blocks - n_remains :] += 1  # the trailing blocks are larger
        self.sizes = sizes
        self.starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])

        slot = np.arange(self.block_size)
        self.valid = slot[None, :] < sizes[:, None]  # (n_blocks, B)
        self.gather_index = np.where(self.valid, self.starts[:, None] + slot[None, :], 0)
        # for each valid (block, slot) in flattened order, the bin it owns
        self.scatter_src = np.nonzero(self.valid.reshape(-1))[0]
        self._tables = {}

    def tables(self, device):
        """``(gather_index, valid, scatter_src)`` as tensors on ``device``."""
        device = torch.device(device)
        key = (device.type, device.index)
        if key not in self._tables:
            self._tables[key] = tuple(
                torch.as_tensor(a, device=device) for a in (self.gather_index, self.valid, self.scatter_src)
            )
        return self._tables[key]

    def valid_on(self, device):
        """The ``(n_blocks, B)`` validity mask on ``device``."""
        return self.tables(device)[1]

    def gather(self, x):
        """Gather the last axis (bins) into ``(..., n_blocks, block_size)``,
        zeros in the padded slots."""
        index, valid, _ = self.tables(x.device)
        return torch.where(valid, x[..., index], torch.zeros((), dtype=x.dtype, device=x.device))

    def scatter(self, blocked):
        """Inverse of :meth:`gather`: ``(..., n_blocks, block_size) -> (..., n_bins)``."""
        flat = blocked.reshape(blocked.shape[:-2] + (-1,))
        return flat.index_select(-1, self.tables(blocked.device)[2])

    def pad_identity(self, M, scale=1.0):
        """``scale I`` added to the padded diagonal slots of block matrices
        ``M (..., n_blocks, B, B)``."""
        B = self.block_size
        pad_diag = (~self.valid_on(M.device)).to(M.real.dtype)  # (n_blocks, B)
        eye = torch.eye(B, dtype=M.dtype, device=M.device)
        return M + scale * pad_diag[..., None] * eye

    def zero_padding_matrix(self, M):
        """``M (..., n_blocks, B, B)`` with padded rows and columns zeroed."""
        v = self.valid_on(M.device).to(M.real.dtype)
        return M * v[..., :, None] * v[..., None, :]

    def mask_vector(self, x):
        """``x (..., n_blocks, B)`` with padded slots zeroed."""
        return torch.where(self.valid_on(x.device), x, torch.zeros((), dtype=x.dtype, device=x.device))
