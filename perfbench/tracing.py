"""The traced run's instruments, all in the benchmark's own files: spans
around the program's entry points, installed at run time at the name the
caller looks up and taken out after, and a summary of a torch.profiler
slice.

No program file is edited. A span records (start, end) on the host's
clock and opens a `torch.profiler.record_function` range of its name, so
the profiler's idle gaps can say what the host was doing.
"""

from __future__ import annotations

import contextlib
import functools
import time
from collections import defaultdict
from typing import Dict, List, Tuple


class Spans:
    """Host-clock spans by name."""

    def __init__(self):
        self.spans: Dict[str, List[Tuple[float, float]]] = defaultdict(list)

    @contextlib.contextmanager
    def wrap(self, owner, attr: str, name: str):
        """Within the block, `owner.attr` (a module global or a class
        attribute) records a span `name` around each call."""
        import torch

        original = getattr(owner, attr)

        @functools.wraps(original)
        def wrapper(*args, **kwargs):
            start = time.perf_counter()
            try:
                with torch.profiler.record_function(name):
                    return original(*args, **kwargs)
            finally:
                self.spans[name].append((start, time.perf_counter()))

        setattr(owner, attr, wrapper)
        try:
            yield
        finally:
            setattr(owner, attr, original)

    @contextlib.contextmanager
    def span(self, name: str):
        """A span around the block."""
        import torch

        start = time.perf_counter()
        try:
            with torch.profiler.record_function(name):
                yield
        finally:
            self.spans[name].append((start, time.perf_counter()))


def _activities(device):
    import torch
    from torch.profiler import ProfilerActivity

    on_cuda = torch.device(device).type == "cuda"
    return [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_cuda else []), on_cuda


def warm_profiler(device) -> None:
    """Start and stop the profiler once, so that its first start (CUPTI's
    set-up, seconds) is paid in set-up and not in the window."""
    import torch
    from torch.profiler import profile

    activities, on_cuda = _activities(device)
    with profile(activities=activities):
        torch.zeros(1, device=device).add_(1)
        if on_cuda:
            torch.cuda.synchronize()


@contextlib.contextmanager
def profiled(out: dict, device="cuda"):
    """Profile the block (CPU and CUDA activity) and fill `out` with its
    summary: `wall_s` (host wall of the block, the card synchronised at
    its end), `busy_s` (the summed time of the device's own events, as
    profile_render.py counts it: kernels, copies and fills, no CPU op's
    device time twice), `kernels` {name: [count kept, device seconds]},
    `device_ops` (the ten largest of them, [name, seconds]) and
    `idle_gaps` (the ten longest gaps between device events, [the
    innermost host range open at the gap's midpoint, seconds]). On the CPU
    (a rehearsal) there are no device events."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import profile

    activities, on_cuda = _activities(device)
    sync = torch.cuda.synchronize if on_cuda else (lambda: None)
    sync()
    with profile(activities=activities) as prof:
        start = time.perf_counter()
        yield
        sync()
        wall = time.perf_counter() - start
    t0 = time.perf_counter()
    # The raw events, in ns: building the profiler's event tree takes a
    # minute for an inverse step's ~10^5 launches.
    device, host = [], []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                device.append((e.start_ns(), e.end_ns(), e.name()))
        else:
            host.append((e.start_ns(), e.end_ns(), e.name()))
    kernels: Dict[str, list] = {}
    for s, t, name in device:
        k = kernels.setdefault(name, [0, 0.0])
        k[0] += 1
        k[1] += (t - s) * 1e-9
    device.sort()
    gaps = []
    for (_, end, _), (nxt, _, _) in zip(device, device[1:]):
        if nxt > end:
            gaps.append((nxt - end, (end + nxt) // 2))
    gaps.sort(reverse=True)
    idle = []
    for length, mid in gaps[:10]:
        open_ranges = [(t - s, name) for s, t, name in host if s <= mid < t]
        idle.append([min(open_ranges)[1] if open_ranges else "(no host range)", length * 1e-9])
    out.update(
        wall_s=wall,
        busy_s=sum(k[1] for k in kernels.values()),
        kernels=kernels,
        device_ops=[[n, k[1]] for n, k in sorted(kernels.items(), key=lambda kv: -kv[1][1])[:10]],
        idle_gaps=idle,
        summary_s=time.perf_counter() - t0,
    )
