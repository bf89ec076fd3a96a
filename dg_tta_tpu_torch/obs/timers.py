"""Per-phase wall-clock timers (the sec/volume headline metric).

A phase that launches device work must end in `torch.cuda.synchronize()`
(or a host copy of its result) for its time to include that work; the
phases of `tta/driver.py` end in host copies.
"""

import contextlib
import time
from collections import defaultdict
from typing import Dict

import torch

class PhaseTimer:
    """Accumulates wall-clock per named phase.  Each phase is also a
    `torch.profiler.record_function` range, so a profiler trace shows the
    phases by name."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        with torch.profiler.record_function(name):
            yield
        dt = time.perf_counter() - t0
        self.totals[name] += dt
        self.counts[name] += 1

    def summary(self) -> Dict[str, dict]:
        return {
            name: {"total_s": self.totals[name], "count": self.counts[name],
                   "mean_s": self.totals[name] / max(1, self.counts[name])}
            for name in self.totals
        }

    def report(self) -> str:
        lines = []
        for name, s in sorted(self.summary().items()):
            lines.append(f"{name:>24}: {s['total_s']:8.2f}s total "
                         f"({s['count']}x, {s['mean_s']:.2f}s avg)")
        return "\n".join(lines)
