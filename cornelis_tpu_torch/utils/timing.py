"""Timing on the card: the card's name and power limit, and CUDA-event times.

Used by the probes' command lines, chip_smoke.py and profile_render.py.
Every time these give belongs beside the card line it was taken on.
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
