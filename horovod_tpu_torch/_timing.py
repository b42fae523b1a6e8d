"""Times of kernel calls with the L2 cache flushed, for ``chip_smoke.py``
and the tune scripts, so that a design comparison and a shipped figure
come from the same yardstick. Two measures:

* :func:`time_cold_ms`, the span between CUDA events around the call:
  what the call costs the device, including any wait for the host to
  queue its kernels (the ``ms`` of the chip smoke's kernels line);
* :func:`device_ms`, the summed durations of the named kernels as the
  profiler traces them: the kernels' own device time, without host gaps.

Nothing here runs at import, and nothing needs a card until called.
"""

from __future__ import annotations

import subprocess

import torch

#: Bytes zeroed before every timed call: above the H100's 50 MB L2.
FLUSH_BYTES = 96 << 20


def flush_buffer(device="cuda"):
    """The buffer :func:`time_cold_ms` zeroes to evict the L2."""
    return torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=device)


def time_cold_ms(fn, flush, iters=100, warmup=10):
    """Mean device time of ``fn`` in milliseconds, between CUDA events
    recorded around it, with ``flush`` zeroed before every call (the main
    path reads each layer's inputs cold: a step's activations and weights
    far exceed the L2). The span starts when the flush ends, so it also
    holds any time the device waits for the host to queue ``fn``'s
    kernels: a wrapper's host work beyond the flush's device time counts."""
    for _ in range(warmup):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for i in range(iters):
        flush.zero_()
        starts[i].record()
        fn()
        ends[i].record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in zip(starts, ends)) / iters


def device_ms(fn, flush, names, iters=20, warmup=3, attempts=3):
    """Mean device time of the kernels of ``fn`` whose names hold one of
    ``names``, in milliseconds, as ``torch.profiler`` traces them, with
    ``flush`` zeroed before every call. Other kernels ``fn`` launches
    (casts of its inputs, say) are not counted; nor is the time the
    device waits for the host. A trace that holds none of the kernels (it
    happens now and then on a process's many short traces) is taken
    again, up to ``attempts`` times in all."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                flush.zero_()
                fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA
                 and any(n in e.key for n in names))
        if us > 0:
            return us / iters / 1e3
    raise RuntimeError(f"device_ms: no kernel named {names} traced in "
                       f"{attempts} attempts")


def card():
    """The card's name and power limit, as ``nvidia-smi`` reports them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
