"""Step-time and liveness monitoring: straggler detection + heartbeats.

On a real pod, one process per host runs a :class:`Heartbeat` (a
periodically-touched file per host; the coordinator treats a stale file
as a dead host and triggers restart-from-checkpoint). In-process, the
:class:`StepMonitor` tracks per-step wall times and flags stragglers —
steps slower than ``threshold × running median`` — which is the signal
used to (a) alert, (b) exclude a host at the next elastic rescale.
"""

from __future__ import annotations

import dataclasses
import os
import statistics
import threading
import time


@dataclasses.dataclass
class StragglerEvent:
    step: int
    duration_s: float
    median_s: float


class StepMonitor:
    def __init__(self, threshold: float = 2.5, window: int = 64):
        self.threshold = threshold
        self.window = window
        self.durations: list[float] = []
        self.events: list[StragglerEvent] = []
        self._t0: float | None = None

    def start_step(self):
        self._t0 = time.monotonic()

    def end_step(self, step: int) -> StragglerEvent | None:
        assert self._t0 is not None, "end_step without start_step"
        dur = time.monotonic() - self._t0
        self._t0 = None
        hist = self.durations[-self.window :]
        self.durations.append(dur)
        if len(hist) >= 8:
            med = statistics.median(hist)
            if dur > self.threshold * med:
                ev = StragglerEvent(step, dur, med)
                self.events.append(ev)
                return ev
        return None

    def summary(self) -> dict:
        if not self.durations:
            return {"steps": 0}
        return {
            "steps": len(self.durations),
            "mean_s": statistics.fmean(self.durations),
            "median_s": statistics.median(self.durations),
            "max_s": max(self.durations),
            "stragglers": len(self.events),
        }


class Heartbeat:
    """File-touch heartbeat; ``stale_hosts`` is the coordinator view."""

    def __init__(self, dir_: str, host_id: int, interval_s: float = 1.0):
        self.dir = dir_
        self.host_id = host_id
        self.interval = interval_s
        self.path = os.path.join(dir_, f"host_{host_id}.hb")
        os.makedirs(dir_, exist_ok=True)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._beat, daemon=True)

    def start(self):
        self._thread.start()
        return self

    def _beat(self):
        while not self._stop.is_set():
            with open(self.path, "w") as f:
                f.write(str(time.time()))
            self._stop.wait(self.interval)

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=2)

    @staticmethod
    def stale_hosts(dir_: str, timeout_s: float) -> list[int]:
        now = time.time()
        stale = []
        if not os.path.isdir(dir_):
            return stale
        for f in os.listdir(dir_):
            if not f.endswith(".hb"):
                continue
            host = int(f[len("host_") : -len(".hb")])
            try:
                with open(os.path.join(dir_, f)) as fh:
                    last = float(fh.read().strip() or 0)
            except (OSError, ValueError):
                last = 0.0
            if now - last > timeout_s:
                stale.append(host)
        return sorted(stale)
