"""Wall-clock timing on the card (counterpart of ``utils/timer.py``)."""

from __future__ import annotations

import time

import torch


def fence(out=None):
    """Wait for the card to finish all queued work; returns ``out``.
    PyTorch launches asynchronously, so a host clock read without this
    measures the enqueue, not the work."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    return out


def time_samples(fn, *args, iters: int = 3, warmup: int = 1) -> list[float]:
    """Every wall-time sample of ``fn(*args)`` in seconds (length
    ``iters``), after ``warmup`` untimed calls; each call is fenced and
    its result dropped before the next."""
    for _ in range(warmup):
        r = fence(fn(*args))
        del r
    samples = []
    for _ in range(iters):
        fence()
        t0 = time.perf_counter()
        r = fence(fn(*args))
        samples.append(time.perf_counter() - t0)
        del r
    return samples


def median(samples) -> float:
    """Median as a plain float."""
    s = sorted(samples)
    m = len(s) // 2
    return float(s[m]) if len(s) % 2 else float((s[m - 1] + s[m]) / 2)
