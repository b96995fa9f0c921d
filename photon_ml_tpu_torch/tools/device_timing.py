"""Kernel times on an NVIDIA card that are the device's, not the host's.

A pass's wrapper spends tens of microseconds of Python before each launch,
as long as a cell-shape pass runs on the card. Launches timed back to back
then measure the host. :func:`device_ms` first queues a sleep on the
card's stream long enough for the host to enqueue every timed call behind
it, so the card runs them back to back and the CUDA events between them
time the card alone.
"""

from __future__ import annotations

import torch

L2_BYTES = 50 * 1024 * 1024  # the H100's L2
# Cycles of sleep queued per timed call: 200 us at the H100's 2 GHz,
# more than a pass's Python wrapper or plain version takes to enqueue.
SLEEP_CYCLES_PER_CALL = 400_000


def l2_flush_buffer(device="cuda") -> torch.Tensor:
    """Twice the L2 in floats: an in-place add over it evicts the L2."""
    return torch.zeros(2 * L2_BYTES // 4, device=device)


def device_ms(fn, reps: int = 50, warmup: int = 3, flush: torch.Tensor = None) -> float:
    """CUDA-event ms per call of ``fn`` on the current stream, after
    ``warmup`` calls. Without ``flush`` the ``reps`` calls run back to back
    between two events (warm L2); with it, each call follows an in-place
    add over ``flush`` (a cold L2) and only the calls are timed, one event
    pair each."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(2 * reps)]
    torch.cuda._sleep(SLEEP_CYCLES_PER_CALL * reps)
    if flush is None:
        events[0].record()
        for _ in range(reps):
            fn()
        events[1].record()
        torch.cuda.synchronize()
        return events[0].elapsed_time(events[1]) / reps
    for i in range(reps):
        flush.add_(1.0)
        events[2 * i].record()
        fn()
        events[2 * i + 1].record()
    torch.cuda.synchronize()
    return sum(events[2 * i].elapsed_time(events[2 * i + 1]) for i in range(reps)) / reps
