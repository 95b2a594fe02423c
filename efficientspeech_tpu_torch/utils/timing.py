"""Timing on the card (the counterpart of the JAX package's
``benchmarks/_chain.py``): CUDA events around a run of calls, the
device's busy time in a ``torch.profiler`` trace, and the card's name and
power limit to print beside every number."""

import subprocess
import time

import torch


def card() -> str:
    """``nvidia-smi``'s "name, power.limit" of card 0."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode == 0 and smi.stdout.strip():
        return smi.stdout.strip().splitlines()[0]
    return f"{torch.cuda.get_device_name(0)}, power limit unknown"


def time_ms(fn, iters: int):
    """(device ms, host ms) per call, after a warm-up.  The card first
    sleeps while the host queues all the calls, so the CUDA events around
    them time the device's work and not the host's launch rate; the host
    clock around the queueing gives the host's cost per call."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3 / iters
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters, host_ms


def time_ms_flushed(fn, iters: int, flush_bytes: int = 64 << 20) -> float:
    """Device ms per call with the 50 MB L2 cache flushed before each: a
    write of ``flush_bytes`` between calls, outside the timed spans (CUDA
    events around each call alone), queued while the card sleeps."""
    buf = torch.empty(flush_bytes, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    spans = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    torch.cuda._sleep(200_000_000)
    for start, end in spans:
        buf.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in spans) / iters


def busy_ms(prof) -> float:
    """The device's busy time in a ``torch.profiler`` trace: the union of
    its kernels' time intervals (kernels that overlap, as on cuDNN's side
    streams, count once)."""
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)
                   and e.time_range.end > e.time_range.start)
    busy, end = 0.0, float("-inf")
    for lo, hi in spans:
        if hi > end:
            busy += hi - max(lo, end)
            end = hi
    return busy / 1e3
