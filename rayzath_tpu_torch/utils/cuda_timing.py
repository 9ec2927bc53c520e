"""CUDA-event timings of a call on the card: with its host wrapper, and the
device's own time.

* :func:`call_ms`: the median time of one call, events recorded before
  and after it. The first event is queued before the call's Python code
  runs, so the time holds the wrapper's host work (argument checks,
  allocation, the launch itself) whenever the device waits for it: the
  time a caller sees on an idle device.
* :func:`device_ms`: the device's time per call. ``torch.cuda._sleep``
  keeps the device busy while the host queues the first event, ``launches``
  calls and the second event, so the device runs the calls back to back
  and the events hold no host time. The sleep is lengthened until it
  outlasts the host's queueing (checked by a third event before it).

Both need a card; they raise without one.
"""
from __future__ import annotations

import statistics
import time

import torch

SPIN_CYCLES = 2_000_000          # first sleep, ~1 ms at the H100's clocks
MAX_SPIN_CYCLES = 2_000_000_000


def _event():
    return torch.cuda.Event(enable_timing=True)


def call_ms(fn, runs: int) -> float:
    """Median milliseconds of ``fn()`` over ``runs`` calls, the events
    around each call (after one warm-up call)."""
    fn()
    times = []
    for _ in range(runs):
        a, b = _event(), _event()
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms(fn, launches: int = 20, repeats: int = 5) -> float:
    """Median over ``repeats`` of the device milliseconds per call of
    ``fn()``, from ``launches`` calls queued behind a sleep (after one
    warm-up call)."""
    fn()
    torch.cuda.synchronize()
    spin = SPIN_CYCLES
    times = []
    while len(times) < repeats:
        z, a, b = _event(), _event(), _event()
        z.record()
        torch.cuda._sleep(spin)
        a.record()
        t0 = time.perf_counter()
        for _ in range(launches):
            fn()
        b.record()
        host_ms = (time.perf_counter() - t0) * 1e3
        b.synchronize()
        if z.elapsed_time(a) <= 1.5 * host_ms:
            # the device finished sleeping before the host had queued the
            # calls: sleep longer and take this repeat again
            if spin >= MAX_SPIN_CYCLES:
                raise RuntimeError(f"device_ms: {host_ms:.1f} ms of host "
                                   "queueing outlasts the longest sleep")
            spin *= 4
            continue
        times.append(a.elapsed_time(b) / launches)
    return statistics.median(times)
