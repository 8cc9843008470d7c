"""Profiling / timing utilities (port of ``fsae_mpc_tpu.utils.profiling``).

Timing of a callable by its result's device: CUDA events around the calls
when the result lives on the card (the host returns before the card has
finished, so a host clock would time the enqueue), the host's clock when
it lives on the CPU, whose work is done when the call returns.  Percentile
summaries as the reference's mean/median/max report, and a
``torch.profiler`` trace context for per-kernel inspection.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable

import numpy as np
import torch

from . import tree as tree_util


def _on_cuda(out) -> bool:
    return any(torch.is_tensor(v) and v.is_cuda
               for v in tree_util.leaves(out))


def _event():
    return torch.cuda.Event(enable_timing=True)


class Timed:
    """``fn`` that records the time of each call: ``samples`` (seconds),
    by CUDA events for a call whose result is on the card, by the host's
    clock otherwise.  Reading ``samples`` waits for the card."""

    def __init__(self, fn: Callable):
        self.fn = fn
        self._calls = []        # (start event, end event) or seconds

    def __call__(self, *args, **kwargs):
        start = _event() if torch.cuda.is_available() else None
        if start is not None:
            start.record()
        t0 = time.perf_counter()
        out = self.fn(*args, **kwargs)
        if _on_cuda(out):
            end = _event()
            end.record()
            self._calls.append((start, end))
        else:
            self._calls.append(time.perf_counter() - t0)
        return out

    @property
    def samples(self) -> list:
        out = []
        for c in self._calls:
            if isinstance(c, tuple):
                c[1].synchronize()
                c = c[0].elapsed_time(c[1]) / 1e3
            out.append(c)
        return out


def stats(samples) -> dict:
    """Mean, median, p99 and max of a list of seconds."""
    s = np.asarray(samples, dtype=np.float64)
    return {"mean": float(s.mean()), "median": float(np.median(s)),
            "p99": float(np.percentile(s, 99)), "max": float(s.max())}


def time_fn(fn: Callable, *args, warmup: int = 1, reps: int = 10) -> float:
    """Steady-state time of ``fn(*args)`` in seconds per call: CUDA events
    around ``reps`` calls if its result is on the card, else the host's
    clock."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
    if warmup and _on_cuda(out):
        start, end = _event(), _event()
        start.record()
        for _ in range(reps):
            fn(*args)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / reps
    timed = Timed(fn)
    for _ in range(reps):
        timed(*args)
    return float(np.mean(timed.samples))


def latency_stats(fn: Callable, *args, reps: int = 50) -> dict:
    """Per-call latency distribution (mean/median/p99/max seconds) of
    ``fn(*args)`` after one warm call, mirroring the reference's CPU-time
    metrics block."""
    fn(*args)
    timed = Timed(fn)
    for _ in range(reps):
        timed(*args)
    return stats(timed.samples)


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` over the block (CPU activity, and the card's
    where there is one); on exit the Chrome trace is written to
    ``log_dir/trace.json``.  Yields the profiler (``key_averages()``)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
