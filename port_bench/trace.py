"""The traced run's device timeline and the harness's spans.

`Tracer` runs `torch.profiler` (CPU and CUDA activity, no shapes, no
stacks) over the measured window and keeps the events in memory; nothing
is written to disk. From them it takes the device's operations (kernels,
copies and fills: every event on the device), the harness's spans (the
`record_function` annotations named `bench.*` that the drivers put
around each call into the program) and the window's own span,
`bench.window`.

`busy_s` is the union of the device operations' intervals inside the
window, `window_s` the window span's length; the idle share is one minus
their ratio. `breakdown` gives the device operations that took most
time and the idle gaps summed by the innermost harness span that the
driving thread was in at each gap's midpoint.
"""

from __future__ import annotations

import collections
import contextlib
from typing import Dict, List, Tuple

import torch

Interval = Tuple[str, float, float]  # name, start, end in seconds
WINDOW = 'bench.window'


def _ns(event, what: str) -> float:
    getter = getattr(event, f'{what}_ns', None)
    if getter is not None:
        return float(getter())
    return float(getattr(event, f'{what}_us')()) * 1e3


def span(name: str):
    """A harness span around a call into the program (a no-op cost when
    no profiler runs)."""
    return torch.profiler.record_function(f'bench.{name}')


class Tracer:
    """With `enabled`, profiles the `window()` context and, once it has
    closed, holds `ops` (device operations) and `spans` (harness spans),
    each a list of (name, start_s, end_s) on the profiler's clock."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.ops: List[Interval] = []
        self.spans: List[Interval] = []
        self.window_span = (0.0, 0.0)

    @contextlib.contextmanager
    def window(self):
        if not self.enabled:
            yield
            return
        from torch.profiler import ProfilerActivity, profile
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        with prof:
            with span('window'):
                yield
            torch.cuda.synchronize()
        self._collect(prof)

    def _collect(self, prof) -> None:
        cuda = torch.autograd.DeviceType.CUDA
        spans, main = [], None
        for e in prof.profiler.kineto_results.events():
            start = _ns(e, 'start') * 1e-9
            end = start + _ns(e, 'duration') * 1e-9
            name = e.name()
            if e.device_type() == cuda:
                # A span's range on the device is no operation.
                annotation = getattr(e, 'is_user_annotation', None)
                if not (name.startswith('bench.') or
                        (annotation is not None and annotation())):
                    self.ops.append((name, start, end))
            elif name == WINDOW:
                self.window_span = (start, end)
                main = e.start_thread_id()
            elif name.startswith('bench.'):
                spans.append((e.start_thread_id(),
                              (name[len('bench.'):], start, end)))
        # What the host was doing is the driving thread's span; a worker's
        # (PnP's) would overlap it.
        self.spans = [iv for tid, iv in spans if tid == main]
        self.ops.sort(key=lambda iv: iv[1])

    @property
    def window_s(self) -> float:
        return self.window_span[1] - self.window_span[0]

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of the device operations' intervals, clipped to the
        window, as sorted disjoint (start, end) pairs."""
        lo, hi = self.window_span
        merged: List[List[float]] = []
        for _, s, e in self.ops:
            s, e = max(s, lo), min(e, hi)
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals())

    def op_seconds(self) -> Dict[str, float]:
        """Summed device seconds by operation name, inside the window."""
        lo, hi = self.window_span
        out: Dict[str, float] = collections.defaultdict(float)
        for name, s, e in self.ops:
            s, e = max(s, lo), min(e, hi)
            if e > s:
                out[name] += e - s
        return dict(out)

    def span_at(self, t: float) -> str:
        """The innermost harness span open at time t ('host' when none)."""
        best, best_len = 'host', float('inf')
        for name, s, e in self.spans:
            if s <= t < e and e - s < best_len:
                best, best_len = name, e - s
        return best

    def idle_gaps(self) -> Dict[str, float]:
        """Idle seconds of the device in the window, summed by the span
        the host was in at each gap's midpoint."""
        lo, hi = self.window_span
        out: Dict[str, float] = collections.defaultdict(float)
        at = lo
        for s, e in self.busy_intervals() + [(hi, hi)]:
            if s > at:
                out[self.span_at((at + s) / 2)] += s - at
            at = max(at, e)
        return dict(out)

    def breakdown(self, top: int = 10) -> Dict[str, list]:
        ops = sorted(self.op_seconds().items(), key=lambda kv: -kv[1])
        gaps = sorted(self.idle_gaps().items(), key=lambda kv: -kv[1])
        return {'device_ops': [[n[:120], s] for n, s in ops[:top]],
                'idle_gaps': [[n, s] for n, s in gaps[:top]]}
