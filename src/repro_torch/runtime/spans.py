"""Named time spans of a step's phases, read after the step.

On a CUDA device a span is a pair of CUDA events recorded on the current
stream, so it measures device time between the two points without
synchronizing the host; on the CPU it is the host's monotonic clock.
:meth:`Spans.read` synchronizes once and returns the milliseconds of
every span, grouped by name, in recording order.
"""

from __future__ import annotations

import contextlib
import time

import torch


class Spans:
    def __init__(self) -> None:
        self._marks: list[tuple[str, object, object]] = []

    @contextlib.contextmanager
    def span(self, name: str, device: torch.device):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            yield
            end.record()
        else:
            start = time.perf_counter()
            yield
            end = time.perf_counter()
        self._marks.append((name, start, end))

    def read(self) -> dict[str, list[float]]:
        """{name: [ms, ...]} of every span recorded since the last read."""
        out: dict[str, list[float]] = {}
        if any(isinstance(s, torch.cuda.Event) for _, s, _ in self._marks):
            torch.cuda.synchronize()
        for name, s, e in self._marks:
            ms = s.elapsed_time(e) if isinstance(s, torch.cuda.Event) else (e - s) * 1e3
            out.setdefault(name, []).append(ms)
        self._marks.clear()
        return out


def maybe_span(spans: Spans | None, name: str, device: torch.device):
    """``spans.span(name, device)``, or a no-op when ``spans`` is None."""
    return contextlib.nullcontext() if spans is None else spans.span(name, device)
