"""The one traffic generator: a traffic file's parameters and a seed give
the sequence of recordings a run separates.

A traffic file (``portbench/traffic/<name>.json``) sets:

  * ``loop``: ``"closed"``, one client (the only loop this generator
    makes): the next recording starts when the last has come back;
  * ``length_s``: ``[shortest, longest]`` seconds of a recording.  Equal
    ends give a fixed length; otherwise each cycle of recordings holds
    every frame count that the range gives once, in an order drawn from the
    seed, each with a sample count drawn within that frame count, so every
    seed asks for the same work in another order;
  * ``pool``: how many recordings of the longest length are synthesised
    (:mod:`~portbench.reference.room`); recording ``i`` is cut from pool
    entry ``i % pool`` at an offset drawn from the seed;
  * ``warmup_s``: the length of the one recording separated in set-up;
  * ``trace_recordings``: how many whole recordings the traced run
    profiles;
  * ``check_recordings``: how many of the window's recordings are drawn for
    the comparison with the reference.
"""

import numpy as np


def n_frames(n_samples, hop_size):
    """Frames of scipy's STFT with half-window zero boundaries and padding
    to whole hops, for an even window."""
    return 1 + -(-n_samples // hop_size)


class Schedule:
    """Recording ``i`` of a run: its pool entry, offset and length."""

    def __init__(self, traffic, config, seed):
        if traffic["loop"] != "closed":
            raise ValueError("the generator makes closed loops only, got {!r}".format(traffic["loop"]))
        self.traffic, self.config, self.seed = traffic, config, int(seed)
        sr = config["sample_rate"]
        self.hop = config["stft"]["hop_size"]
        self.shortest, self.longest = (int(round(s * sr)) for s in traffic["length_s"])
        if not 0 < self.shortest <= self.longest:
            raise ValueError("length_s must be 0 < shortest <= longest")
        self.pool_size = traffic["pool"]
        self.frame_counts = list(range(n_frames(self.shortest, self.hop), n_frames(self.longest, self.hop) + 1))
        self._rng = np.random.default_rng([self.seed, 0])
        self._drawn = []

    def _draw_cycle(self):
        rng = self._rng
        for k in rng.permutation(self.frame_counts):
            lo = max(self.shortest, (int(k) - 2) * self.hop + 1)
            hi = min(self.longest, (int(k) - 1) * self.hop)
            length = int(rng.integers(lo, hi + 1))
            offset = int(rng.integers(0, self.longest - length + 1))
            self._drawn.append((length, offset))

    def recording(self, i):
        """``(pool entry, offset, n_samples)`` of recording ``i``."""
        if self.shortest == self.longest:
            return i % self.pool_size, 0, self.longest
        while len(self._drawn) <= i:
            self._draw_cycle()
        length, offset = self._drawn[i]
        return i % self.pool_size, offset, length

    def mixture(self, pool, i):
        """Recording ``i`` as its own contiguous ``(n_mics, n_samples)``
        float32 array, as a user holds one."""
        entry, offset, length = self.recording(i)
        x = pool[entry]
        if offset == 0 and length == x.shape[-1]:
            return x
        return np.ascontiguousarray(x[:, offset : offset + length])
