"""Per-bin C x C math and the two hand-written kernels (K1 in
``cov_kernel.py``, K2 in ``fused_ip.py``; sources in ``../csrc``)."""
