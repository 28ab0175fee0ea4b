"""Per-stage timing instrumentation (the reference's REGISTER_TIMES).

The reference compiles with REGISTER_TIMES enabled (reference include/Config.h:4)
and records per-stage means printed at shutdown (src/Tracking.cc:268
PrintTimeStats → ExecTimeMean.txt). Same taxonomy here so numbers are
comparable: per-frame stages (extraction, stereo match, pose prediction,
local-map track, new-KF decision) and mapping stages (KF insert, MP culling,
MP creation, fuse, LBA).
"""
from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager


class Timeline:
    """Cross-thread event timeline for per-frame latency attribution (the
    reference records EVERY stage of EVERY frame under REGISTER_TIMES,
    src/Tracking.cc:1878-2399 — aggregate medians hide the latency tail).
    Each event is (name, thread, t0, t1) in perf_counter seconds; bounded."""

    def __init__(self, cap: int = 200_000):
        self.events: list = []
        self.cap = cap

    def record(self, name: str, t0: float, t1: float):
        if len(self.events) < self.cap:
            import threading
            self.events.append((name, threading.current_thread().name, t0, t1))

    def overlap_by_category(self, t0: float, t1: float,
                            exclude_thread: str | None = None) -> dict:
        """Per-event-name overlap (seconds) with window [t0, t1]."""
        out: dict = {}
        for name, th, a, b in self.events:
            if th == exclude_thread or b <= t0 or a >= t1:
                continue
            out[name] = out.get(name, 0.0) + min(b, t1) - max(a, t0)
        return out


class StageTimer:
    def __init__(self):
        self.samples = defaultdict(list)
        self.enabled = True
        self.timeline: Timeline | None = None   # set to record attribution

    @contextmanager
    def stage(self, name: str):
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            t1 = time.perf_counter()
            self.samples[name].append(t1 - t0)
            if self.timeline is not None:
                self.timeline.record(name, t0, t1)

    def add(self, name: str, seconds: float):
        self.samples[name].append(seconds)

    def stats(self) -> dict:
        out = {}
        for name, xs in self.samples.items():
            n = len(xs)
            mean = sum(xs) / n
            med = sorted(xs)[n // 2]
            out[name] = {"mean_ms": mean * 1e3, "n": n,
                         "median_ms": med * 1e3,
                         "total_s": sum(xs),
                         "max_ms": max(xs) * 1e3}
        return out

    def print_stats(self, file=None):
        """Reference PrintTimeStats format: stage mean/std table."""
        import sys
        f = file or sys.stdout
        print("Stage timing (mean ms over n calls):", file=f)
        for name, s in sorted(self.stats().items()):
            print(f"  {name:<28s} {s['mean_ms']:8.2f} ms  x{s['n']:<5d} "
                  f"(max {s['max_ms']:.2f})", file=f)

    def save(self, path: str):
        """ExecTimeMean.txt equivalent."""
        with open(path, "w") as f:
            self.print_stats(file=f)


GLOBAL_TIMER = StageTimer()

# Active attribution timeline (None = off). bench.py installs one and points
# every StageTimer at it; locked_current records lock waits into it.
GLOBAL_TIMELINE: Timeline | None = None
