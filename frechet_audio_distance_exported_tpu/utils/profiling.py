"""Tracing & profiling utilities.

The reference has no tracing/profiling at all — only tqdm bars and verbose
prints (SURVEY.md §5.1; reference: fad.py:317, 571). This module supplies
the device-aware equivalents:

- ``stage_timer`` — lightweight per-stage wall timing with a report
- ``trace`` — jax.profiler trace context (TensorBoard-viewable) gated by an
  env var or explicit path
- ``annotate`` — named TraceAnnotation around pipeline stages so device
  profiles attribute time to frontend/model/stats
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional

import jax


class StageTimer:
    """Accumulates wall time per named stage; thread-compatible enough for the
    decode pool (each `with` is independent)."""

    def __init__(self) -> None:
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        lines = ["[FAD-TPU] stage timings:"]
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            lines.append(
                f"  {name:<24} {self.totals[name]*1000:9.1f} ms  ({self.counts[name]} calls)"
            )
        return "\n".join(lines)


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None) -> Iterator[None]:
    """jax.profiler trace. Enabled when ``log_dir`` is given or FAD_TPU_TRACE
    names a directory; otherwise a no-op."""
    log_dir = log_dir or os.environ.get("FAD_TPU_TRACE")
    if not log_dir:
        yield
        return
    with jax.profiler.trace(log_dir):
        yield


def annotate(name: str):
    """Named device-trace annotation (shows up in the profiler timeline)."""
    return jax.profiler.TraceAnnotation(name)
