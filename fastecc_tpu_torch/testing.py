"""Erasure-pattern generators: the codec's fault-injection toolkit (the
port's copy of ``testing.py``, pure numpy, the same patterns bit for bit).

The reference has no failure-handling subsystem — for an erasure code,
*erasure patterns are the failure model* (SURVEY.md §5). These generators
produce the patterns used in tests and benchmarks, and are public so
deployments can replay realistic loss scenarios against their own data.

All return sorted unique positions in [0, n) as numpy int64 arrays.
"""

from __future__ import annotations

import numpy as np


def random_erasures(n: int, e: int, seed: int = 0) -> np.ndarray:
    """e positions chosen uniformly without replacement."""
    rng = np.random.default_rng(seed)
    return np.sort(rng.choice(n, size=e, replace=False))


def burst_erasures(n: int, e: int, start: int | None = None,
                   seed: int = 0) -> np.ndarray:
    """e consecutive positions (disk/rack loss: correlated failures).

    Wraps around n. ``start`` random unless given.
    """
    assert e <= n, f"burst of {e} exceeds n={n} (positions must be unique)"
    if start is None:
        start = int(np.random.default_rng(seed).integers(0, n))
    return np.sort((start + np.arange(e)) % n)


def stride_erasures(n: int, e: int, stride: int, offset: int = 0
                    ) -> np.ndarray:
    """Every stride-th position (structured loss, e.g. one device of a
    sharded layout). Requires e * stride <= n."""
    assert stride >= 1, "stride 0 would return duplicate positions"
    assert e * stride <= n
    return np.sort((offset + np.arange(e) * stride) % n)


def all_parity_erasures(n: int, k: int) -> np.ndarray:
    """Every parity position lost (the no-op recovery sanity case:
    data survives intact)."""
    from .rs import parity_positions
    return np.sort(parity_positions(n, k))


def all_data_erasures(n: int, k: int) -> np.ndarray:
    """Every data position lost — recovery entirely from parity, the
    hardest systematic-code case at maximum tolerable loss (e = k when
    n = 2k)."""
    from .rs import data_positions
    return np.sort(data_positions(n, k))


def adversarial_suite(n: int, k: int, seed: int = 0):
    """(name, positions) pairs covering the interesting regimes, each at
    the maximum tolerable count e = n - k where applicable."""
    e = n - k
    return [
        ("random_max", random_erasures(n, e, seed)),
        ("burst_max", burst_erasures(n, e, seed=seed)),
        ("all_data", all_data_erasures(n, k)),
        ("all_parity", all_parity_erasures(n, k)),
        # stride 3: for the standard rate-1/2 shape (n = 2k) a stride of
        # 2 is exactly data_positions (offset 0) or parity_positions
        # (offset 1) — duplicates of the entries above, not a distinct
        # regime. Stride 3 hits both kinds in a structured pattern.
        ("stride", stride_erasures(n, min(e, max(1, n // 3)), 3)),
        ("single", random_erasures(n, 1, seed)),
    ]
