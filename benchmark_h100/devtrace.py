"""Reading the device from torch.profiler over a slice of the window.

Frozen copies of ``chip_smoke.py``'s trace reading (``profile_device``,
``device_ms``): device milliseconds by event name and the events seen of
each, a kernel's time scaled by its launches / events seen, since the
profiler drops an event now and then. Beside them: the device's busy
time as the union of its events' intervals, and the idle gaps between
them, each named by the host operation around it.
"""

from __future__ import annotations

import time

HOST_OUTSIDE = "host outside torch ops (api, coalescer, event loop)"
# the harness's own record_function spans: kineto also draws them on the
# device's timeline, where they are no device work
SPANS = ("store.batch_query",)


def roofline(t: dict, kernel: str, names: tuple[str, ...],
             scoring: str) -> float | None:
    """A kernel's share (%) of its roofline over the profiled slice: the
    mean least time of its launches (``bounds_ms``) over its device time
    a launch. The device time sums every event whose name holds one of
    ``names``; a launch's share of it is that sum over the events seen of
    its scoring kernel ``scoring`` (one a launch): the sum scaled by
    launches / events seen, divided by the launches. Where the profiler
    merged launches into one event the share reads low, never high.
    None where nothing ran."""
    dev = t.get("device")
    bounds = (t.get("bounds_ms") or {}).get(kernel) or []
    launches = (t.get("launches") or {}).get(kernel, 0)
    if dev is None or not bounds or not launches:
        return None
    total, seen = 0.0, 0
    for name, ms in dev["ms_by_name"].items():
        if any(n in name for n in names):
            total += ms
            if scoring in name:
                seen += dev["events_by_name"][name]
    if total <= 0 or seen == 0:
        return None
    return 100.0 * (sum(bounds) / len(bounds)) / (total / seen)


def _union(intervals: list[tuple[float, float]]):
    merged: list[list[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


class Profiled:
    """torch.profiler (CPU and CUDA activity) from ``start`` to
    ``stop``; ``read`` gives the slice's device record."""

    def __init__(self) -> None:
        self._prof = None
        self.window_s = 0.0

    @staticmethod
    def warm() -> None:
        """Bring up CUPTI once at set-up, so the slice does not pay it."""
        import torch
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            torch.ones(8, device="cuda").sum().item()

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        import torch
        torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self._t0
        self._prof.__exit__(None, None, None)

    def read(self) -> dict:
        from torch.autograd import DeviceType
        ms_by_name: dict[str, float] = {}
        events_by_name: dict[str, int] = {}
        dev_iv, host_ev = [], []
        for evt in self._prof.events():
            a, b = evt.time_range.start, evt.time_range.end
            if evt.key in SPANS and evt.device_type == DeviceType.CUDA:
                continue
            if evt.device_type == DeviceType.CUDA:
                ms = evt.self_device_time_total / 1e3
                ms_by_name[evt.key] = ms_by_name.get(evt.key, 0.0) + ms
                events_by_name[evt.key] = events_by_name.get(evt.key, 0) + 1
                if b > a:
                    dev_iv.append((a, b))
            elif b > a:
                host_ev.append((a, b, evt.key))
        busy = _union(dev_iv)
        busy_s = sum(b - a for a, b in busy) / 1e6
        gaps = [(busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)
                if busy[i + 1][0] > busy[i][1]]
        return {"ms_by_name": ms_by_name, "events_by_name": events_by_name,
                "busy_s": busy_s,
                "window_s": self.window_s,
                "device_ops": top(ms_by_name, 1e-3),
                "idle_gaps": gap_labels(gaps, host_ev)}


def top(by_name: dict[str, float], scale: float, n: int = 10) -> list:
    """The n largest entries as [name (60 chars), value * scale]."""
    return [[name[:60], v * scale] for name, v in sorted(
        by_name.items(), key=lambda kv: -kv[1])[:n]]


def gap_labels(gaps: list[tuple[float, float]],
               host_ev: list[tuple[float, float, str]], n: int = 10) -> list:
    """Idle seconds by what the host was doing: each gap (us) goes to
    the innermost host event around its middle (the shortest one that
    covers it), or to ``HOST_OUTSIDE``; the n largest sums."""
    host_ev = sorted(host_ev)
    by_label: dict[str, float] = {}
    active: list[tuple[float, float, str]] = []
    nxt = 0
    for a, b in sorted(gaps):
        mid = 0.5 * (a + b)
        while nxt < len(host_ev) and host_ev[nxt][0] <= mid:
            active.append(host_ev[nxt])
            nxt += 1
        active = [ev for ev in active if ev[1] >= mid]
        label = (min(active, key=lambda ev: ev[1] - ev[0])[2] if active
                 else HOST_OUTSIDE)
        by_label[label] = by_label.get(label, 0.0) + (b - a) / 1e6
    return top(by_label, 1.0, n)
