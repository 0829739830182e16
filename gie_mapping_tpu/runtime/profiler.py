"""Profiling hooks.

Counterpart of the reference's wall-clock brackets + explicit device syncs
("only for profiling", /root/reference/src/volumetric_mapper.cpp:153,186-203)
and its CSV log: stage timers force completion by reading back a
designated output, and full XLA traces are captured with jax.profiler for
xprof/tensorboard (runtime/trace_metrics.py reduces them).
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, List

import jax
import numpy as np


class StageTimer:
    """Accumulating per-stage wall timers with forced device sync."""

    def __init__(self):
        self.times: Dict[str, List[float]] = defaultdict(list)

    @contextlib.contextmanager
    def stage(self, name: str, sync_on=None):
        t0 = time.perf_counter()
        yield
        if sync_on is not None:
            np.asarray(jax.device_get(jax.tree_util.tree_leaves(sync_on)[0]))
        self.times[name].append((time.perf_counter() - t0) * 1e3)

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for k, v in self.times.items():
            a = np.asarray(v)
            out[k] = {
                "median_ms": float(np.median(a)),
                "p90_ms": float(np.percentile(a, 90)),
                "n": len(a),
            }
        return out


@contextlib.contextmanager
def xla_trace(log_dir: str):
    """Capture an XLA profiler trace viewable in xprof/tensorboard."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
