"""Timing on the card: the card's name and power limit, CUDA-event times
and kernels' device times.

Used by the probes' command lines, chip_smoke.py, ab_render.py and
profile_render.py. Every time these give belongs beside the card line it
was taken on.
"""

from __future__ import annotations

import subprocess

import torch


def card_line() -> str:
    """The card's name and power limit, as
    `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def event_ms(fn, launches: int) -> float:
    """Milliseconds per call of fn() over `launches` calls in a row, by CUDA
    events around them, after one warm-up call."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(launches):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / launches


def kernel_ms(fn, launches: int, name: str) -> tuple[float, int]:
    """(device milliseconds per launch, kernels kept) of the kernels whose
    name holds `name` over `launches` calls of fn() under torch.profiler,
    after one warm-up call: their mean over the kernels the profiler kept,
    the kernels' own time on the card, without the gaps in which the device
    waits for the host's next launch (which `event_ms` counts). The
    profiler may drop a few of a run's last kernels (on the H100 it kept 13
    of 16 and 63 of 64), so the count kept goes beside each reading; raises
    if it kept fewer than half."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(launches):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and name in e.key]
    count = sum(e.count for e in rows)
    if not launches / 2 <= count <= launches:
        raise RuntimeError(f"the profiler saw {count} kernels named like {name!r} in "
                           f"{launches} calls")
    return sum(e.self_device_time_total for e in rows) / count / 1e3, count
