"""Reading a ``torch.profiler`` trace: the device's busy time (the union
of its kernels' intervals), kernel time and launches by name, and the
idle gaps between kernels named by what the host was doing then."""

import bisect
import collections
import time
from typing import Dict, List, Tuple

import torch

# gaps shorter than this are launch latency, not an idle host phase
MIN_GAP_US = 10.0


def _intervals(prof) -> Tuple[List[Tuple[float, float, str]],
                              List[Tuple[float, float, str]]]:
    """(device operations, host events) as (start µs, end µs, name), from
    the profiler's raw events: device operations launched from any
    thread, host events of the profiled thread."""
    kernels, host = [], []
    for e in prof.profiler.kineto_results.events():
        lo, hi = e.start_ns() / 1e3, e.end_ns() / 1e3
        if hi <= lo or e.is_user_annotation():
            continue
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            kernels.append((lo, hi, e.name()))
        else:
            host.append((lo, hi, e.name()))
    kernels.sort()
    host.sort()
    return kernels, host


def _union(kernels):
    merged = []
    for lo, hi, _ in kernels:
        if merged and lo <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], hi)
        else:
            merged.append([lo, hi])
    return merged


def _innermost(host, starts, t: float) -> str:
    """The host event with the latest start that still covers ``t``."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(-1, i - 400), -1):
        if host[j][1] > t:
            return host[j][2]
    return "host outside any traced op (Python)"


def summarize(prof) -> Dict:
    """busy seconds, device operations (count, seconds by name), and the
    idle gaps between the first and the last kernel summed by the host's
    innermost event at each gap's middle (top 10)."""
    kernels, host = _intervals(prof)
    by_name = collections.defaultdict(float)
    for lo, hi, name in kernels:
        by_name[name] += (hi - lo) / 1e6
    merged = _union(kernels)
    busy = sum(hi - lo for lo, hi in merged) / 1e6
    starts = [h[0] for h in host]
    gaps = collections.defaultdict(float)
    for (_, end), (nxt, _) in zip(merged, merged[1:]):
        if nxt - end >= MIN_GAP_US:
            gaps[_innermost(host, starts, (end + nxt) / 2)] += (
                (nxt - end) / 1e6)
    top = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy, "kernel_s": dict(by_name),
            "device_op_count": len(kernels),
            "device_ops": [[n, s] for n, s in top(by_name)],
            "idle_gaps": [[n, s] for n, s in top(gaps)]}


def kernel_s(summary: Dict, *fragments: str) -> float:
    """Seconds of the kernels whose name holds any of ``fragments``."""
    return sum(s for n, s in summary["kernel_s"].items()
               if any(f in n for f in fragments))


class Stretch:
    """A profiled stretch of the window: ``start()`` and ``stop()`` around
    it (on the thread that launches the device work), ``read()`` after
    the window: ``summarize``'s reading with ``window_s``, the stretch's
    length on the host's clock (``stop`` waits for the device first).

    ``host=False`` records the device's activity alone, which costs the
    host little, so that busy and idle time are the untraced program's;
    ``host=True`` also records the host's operations (several times
    slower for a host-bound loop), to name what the host did in each
    idle gap."""

    def __init__(self, device: torch.device, host: bool = False):
        self.device = device
        self.host = host or device.type != "cuda"
        self.prof = None
        self.state = "waiting"

    def start(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] if self.host else []
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        # the profiler's start holds the host and the card for a while:
        # ``wall_begin`` is before it, ``wall0`` and ``t0`` after it
        self.wall_begin = time.time()
        self.prof.__enter__()
        self.state = "on"
        self.t0, self.wall0 = time.perf_counter(), time.time()

    def stop(self):
        if self.state != "on":
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self.t0
        self.prof.__exit__(None, None, None)
        # after the profiler's own processing, which holds the host
        self.wall1 = time.time()
        self.state = "done"

    def read(self):
        if self.state != "done":
            return None
        return dict(summarize(self.prof), window_s=self.window_s)


class Tracing:
    """A traced run's two stretches, one after the other, each a number of
    the driver's units (calls, steps, batches): first the device's
    activity alone for the metrics, then host and device to name the idle
    gaps of the breakdown.  The driver calls ``before(due)`` and
    ``after()`` around each unit, on the thread that launches its device
    work; the first stretch starts at the first unit where ``due``."""

    def __init__(self, device, enabled: bool, units: int, name_units: int):
        self.stretches = [Stretch(device), Stretch(device, host=True)]
        self.plan = [units, name_units] if enabled else [0, 0]
        self.at, self.count = 0 if enabled else 2, 0
        self.metric_units = []  # the driver's indices of the first's units

    def before(self, due: bool = True):
        if self.at < 2 and self.stretches[self.at].state == "waiting" and (
                due or self.at == 1):
            self.stretches[self.at].start()

    @property
    def measuring(self) -> bool:
        return self.at == 0 and self.stretches[0].state == "on"

    @property
    def on(self) -> bool:
        return self.at < 2 and self.stretches[self.at].state == "on"

    def after(self):
        if not self.on:
            return
        self.count += 1
        if self.count == self.plan[self.at]:
            self.stretches[self.at].stop()
            self.at, self.count = self.at + 1, 0

    def finish(self):
        for st in self.stretches:
            st.stop()

    def read(self):
        s = self.stretches[0].read()
        names = self.stretches[1].read()
        if s is not None and names is not None:
            s["idle_gaps"] = names["idle_gaps"]
        return s
