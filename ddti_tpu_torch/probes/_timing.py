"""Device time of a call on the card, for the probes."""

import time

import torch

# calls enqueued behind a device-side sleep of SLEEP_CYCLES clocks (~0.1 s
# at the H100's boost clock, longer than the host takes to enqueue them),
# or this many times as long where the host, which shares its cores, was
# slower
CALLS = 50
SLEEP_CYCLES = 200_000_000
SLEEP_SCALES = (1, 4, 16)


def queued_ms(fn, calls=CALLS):
    """Device time per call of ``fn``, in ms: CUDA events around ``calls``
    calls enqueued back to back behind a device-side sleep, so that no
    launch waits for the host. Raises where the host took longer to
    enqueue the calls than the longest sleep lasted (the time would hold
    the host's)."""
    fn()
    for scale in SLEEP_SCALES:
        torch.cuda.synchronize()
        slept, start, end = (torch.cuda.Event(enable_timing=True)
                             for _ in range(3))
        slept.record()
        torch.cuda._sleep(SLEEP_CYCLES * scale)
        start.record()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        end.record()
        end.synchronize()
        if host_ms < slept.elapsed_time(start):
            return start.elapsed_time(end) / calls
    raise RuntimeError("the device-side sleep ended before the calls were "
                       "enqueued")
