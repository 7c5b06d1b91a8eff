"""Named timers with RAII tickers (reference include/SlamCore/timer.h:10-58);
the port's own copy of ``ct_icp_tpu/core/timer.py``."""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List


class Timer:
    """Accumulates named durations; mirrors slam::Timer + Ticker."""

    def __init__(self):
        self._totals: Dict[str, float] = {}
        self._counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def tick(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self._totals[name] = self._totals.get(name, 0.0) + dt
            self._counts[name] = self._counts.get(name, 0) + 1

    def cumulated_ms(self, name: str) -> float:
        return self._totals.get(name, 0.0) * 1e3

    def average_ms(self, name: str) -> float:
        c = self._counts.get(name, 0)
        return self._totals.get(name, 0.0) * 1e3 / c if c else 0.0

    def entries(self) -> List[str]:
        return list(self._totals)

    def report(self) -> str:
        lines = [f"{k}: total={self.cumulated_ms(k):.2f}ms "
                 f"avg={self.average_ms(k):.2f}ms n={self._counts[k]}"
                 for k in sorted(self._totals)]
        return "\n".join(lines)

    def clear(self):
        self._totals.clear()
        self._counts.clear()
