"""Timing and profiling (port of utils/timing.py): a named span recorder
with percentile summaries, and :func:`trace_to`, which captures a
``torch.profiler`` trace (host and, on a card, CUDA activity) around a
block and writes it as a Chrome trace (``chrome://tracing`` or Perfetto).
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict

import numpy as np

__all__ = ["SpanTimer", "trace_to"]


class SpanTimer:
    """Named span accumulator with percentile summaries and a JSON dump."""

    def __init__(self):
        self.spans: dict[str, list[float]] = defaultdict(list)

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.spans[name].append(time.perf_counter() - t0)

    def add(self, name: str, seconds: float):
        self.spans[name].append(seconds)

    def summary(self) -> dict:
        out = {}
        for name, vals in self.spans.items():
            v = np.asarray(vals)
            out[name] = {
                "n": int(len(v)),
                "mean_ms": float(v.mean() * 1e3),
                "median_ms": float(np.median(v) * 1e3),
                "p90_ms": float(np.percentile(v, 90) * 1e3),
                "total_s": float(v.sum()),
            }
        return out

    def report(self) -> str:
        rows = ["{:<14} {:>5} {:>9} {:>9} {:>9}".format("span", "n", "median", "p90", "total")]
        for name, s in sorted(self.summary().items()):
            rows.append("{:<14} {:>5d} {:>7.1f}ms {:>7.1f}ms {:>8.2f}s".format(
                name, s["n"], s["median_ms"], s["p90_ms"], s["total_s"]))
        return "\n".join(rows)

    def save(self, path: str):
        with open(path, "w") as f:
            json.dump(self.summary(), f, indent=2)


@contextlib.contextmanager
def trace_to(logdir: str | None):
    """Profile the block with ``torch.profiler`` (CPU activity, plus CUDA
    where a card is visible) and write ``<logdir>/trace.json`` as a Chrome
    trace. ``None`` profiles nothing."""
    if logdir is None:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
