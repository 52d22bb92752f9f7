"""Arithmetic that several metric readers share."""

from __future__ import annotations

from typing import Optional


def megakernel_ms_per_frame(record: dict) -> Optional[float]:
    """Device ms per frame of the kernels named like "megakernel" in the
    profiled frames: their mean over the launches kept, times the launches
    per frame. The profiler drops a few of a slice's last kernels, so the
    mean is over those kept."""
    prof = record.get("profile")
    if record.get("kind") != "frame" or not prof or not prof.get("launches"):
        return None
    rows = [k for name, k in prof["kernels"].items() if "megakernel" in name]
    kept = sum(count for count, _ in rows)
    if not kept:
        return None
    per_launch = sum(seconds for _, seconds in rows) / kept
    return per_launch * prof["launches"] / prof["frames"] * 1e3


def idle_share(record: dict) -> Optional[float]:
    """1 - device busy / host wall over the profiled slice of any kind."""
    prof = record.get("profile")
    if not prof:
        return None
    return 1.0 - prof["busy_s"] / prof["wall_s"]
