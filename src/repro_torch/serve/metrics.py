"""Serving health counters and latency distribution (the counterpart of
``repro/serve/metrics.py``, plain Python and numpy, the same semantics).

One lock-guarded accumulator shared by the engine loop and request
threads; ``snapshot()`` returns the plain-dict health/metrics view the
benchmark rows and the ``/health`` surface read — served/shed counts
per reason, p50/p99 latency over a bounded reservoir, sustained QPS,
and hot-swap pause stats.
"""

from __future__ import annotations

import threading
import time

import numpy as np


SHED_REASONS = ("deadline", "backpressure", "invalid", "shutdown")


class ServeMetrics:
    def __init__(self, reservoir: int = 4096):
        self._lock = threading.Lock()
        self._cap = int(reservoir)
        self._lat: list = []
        self._swap: list = []
        self.served = 0
        self.batches = 0
        self.shed = dict.fromkeys(SHED_REASONS, 0)
        self.rung_steps = dict.fromkeys((0, 1, 2), 0)
        self._t0 = time.monotonic()

    def record_batch(self, latencies, rung: int = 0) -> None:
        with self._lock:
            self.batches += 1
            self.served += len(latencies)
            self.rung_steps[int(rung)] = self.rung_steps.get(int(rung), 0) + 1
            self._lat.extend(float(x) for x in latencies)
            if len(self._lat) > self._cap:  # bounded: keep the newest
                self._lat = self._lat[-self._cap:]

    def record_shed(self, reason: str, k: int = 1) -> None:
        with self._lock:
            self.shed[reason] = self.shed.get(reason, 0) + int(k)

    def record_swap(self, pause_s: float) -> None:
        with self._lock:
            self._swap.append(float(pause_s))

    def snapshot(self) -> dict:
        with self._lock:
            lat = np.asarray(self._lat, np.float64)
            dt = max(time.monotonic() - self._t0, 1e-9)
            shed_total = sum(self.shed.values())
            out = {
                "served": self.served,
                "batches": self.batches,
                "shed": dict(self.shed),
                "shed_total": shed_total,
                "qps": self.served / dt,
                "rung_steps": dict(self.rung_steps),
                "swaps": len(self._swap),
            }
            if lat.size:
                out["p50_ms"] = float(np.percentile(lat, 50) * 1e3)
                out["p99_ms"] = float(np.percentile(lat, 99) * 1e3)
            if self._swap:
                out["swap_pause_max_s"] = float(max(self._swap))
                out["swap_pause_mean_s"] = float(np.mean(self._swap))
            return out
