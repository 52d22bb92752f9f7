"""Session logging.

Counterpart of `cornelis_tpu/utils/logging.py`: the reference's loguru
session header -- render options and scene stats at session start,
throttled percent-complete lines during the render
(src/Render.cpp:315-325,349-352) -- on Python's stdlib logging. The header
names the torch device where the JAX package names its backend.
"""

from __future__ import annotations

import logging

import torch

logger = logging.getLogger("cornelis_tpu_torch")
if not logger.handlers:
    _handler = logging.StreamHandler()
    _handler.setFormatter(logging.Formatter("%(asctime)s [%(levelname)s] %(name)s: %(message)s"))
    logger.addHandler(_handler)
    logger.setLevel(logging.INFO)


def _device_name(device) -> str:
    """'cuda:0 (NVIDIA H100 80GB HBM3)' for a CUDA device, 'cpu' for the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return str(device)
    index = device.index if device.index is not None else torch.cuda.current_device()
    return f"cuda:{index} ({torch.cuda.get_device_name(index)})"


def log_session_header(options, tables) -> None:
    """Options + scene stats at session start (Render.cpp:315-325), as one
    record: each record is a write to the stream. `tables` is the
    session's SceneTables."""
    if not logger.isEnabledFor(logging.INFO):
        return
    logger.info(
        "Starting render session.\n"
        "Render Options:\n"
        "  AA Samples %4d\n"
        "  Resolution %dx%d\n"
        "  Max depth  %4d\n"
        "  Seed       %d\n"
        "  Device     %s\n"
        "Scene information:\n"
        "  Spheres   %4d\n"
        "  Planes    %4d\n"
        "  SDFs      %4d\n"
        "  Materials %4d",
        options.samples_aa, options.width, options.height, options.max_depth, options.seed,
        _device_name(tables.materials.device), tables.spheres.shape[0], tables.planes.shape[0],
        tables.sdfs.shape[0], tables.materials.shape[0],
    )
