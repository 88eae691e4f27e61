"""Hierarchical span profiler, reference-compatible span names.

JAX counterpart of MRPT's CTimeLogger as used by the reference
(m_profiler, libstereo-odometry.h:732; spans `_stg1`..`_stg5`,
`processNewImagePair`, etc.).  Host wall-clock spans via context manager;
`device_span` additionally wraps jax.profiler.TraceAnnotation so XLA traces
carry the same names.  Summary printing mirrors the on-destruction report.
"""
from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager

import numpy as np


class SpanProfiler:
    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.times = defaultdict(list)
        self._stack = []

    @contextmanager
    def span(self, name: str):
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        self._stack.append(name)
        try:
            yield
        finally:
            self._stack.pop()
            self.times[name].append(time.perf_counter() - t0)

    @contextmanager
    def device_span(self, name: str):
        """Span that also annotates the XLA trace (jax.profiler)."""
        if not self.enabled:
            yield
            return
        import jax

        with self.span(name):
            with jax.profiler.TraceAnnotation(name):
                yield

    def enter(self, name: str):
        """MRPT-style explicit enter/leave API."""
        if self.enabled:
            self._stack.append((name, time.perf_counter()))

    def leave(self, name: str):
        if self.enabled and self._stack:
            n, t0 = self._stack.pop()
            assert n == name, f"unbalanced spans: leave({name}) inside {n}"
            self.times[name].append(time.perf_counter() - t0)

    def summary(self) -> str:
        lines = [f"{'span':<40}{'calls':>8}{'mean ms':>12}{'total s':>12}"]
        for name in sorted(self.times):
            ts = np.array(self.times[name])
            lines.append(
                f"{name:<40}{len(ts):>8}{1e3 * ts.mean():>12.3f}{ts.sum():>12.3f}")
        return "\n".join(lines)

    def report(self):
        print(self.summary())
