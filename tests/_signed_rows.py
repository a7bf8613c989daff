"""Rows of float32 values where orders differ between sorts: -0.0 beside
+0.0, NaN and -NaN (and +inf). The port sorts canonical keys of them, so
that the card, the CPU and ``jnp.argsort`` agree (``chip_smoke.py`` keeps a
copy of its own, as it imports no test)."""

import numpy as np


def signed_rows(rng, rows, n, high=4, inf=True):
    """(rows, n) float32 values on the integer grid [0, high): half the
    zeros -0.0, then a tenth NaN, a tenth -NaN and, with ``inf``, a
    twentieth +inf, each drawn from ``rng`` in that order."""
    a = rng.integers(0, high, (rows, n)).astype(np.float32)
    a[a == 0] = np.where(rng.random(int((a == 0).sum())) < 0.5, -0.0, 0.0)
    a[rng.random((rows, n)) < 0.1] = np.float32("nan")
    a[rng.random((rows, n)) < 0.1] = -np.float32("nan")
    if inf:
        a[rng.random((rows, n)) < 0.05] = np.inf
    return a
