"""The wavefront's Threefry draws on a CUDA device: one launch a call.

The hand-written kernels of ops/csrc/draws.cu, which replace no TPU kernel:
`stream_uniforms` is `rng.stream_uniforms` with the uniform sampler and
`ray_streams` the keys and Sobol seeds of `rng.make_ray_streams`, bit for
bit. Their plain versions are those functions' torch code, which runs for
tensors on the CPU; `rng` launches these for tensors on a CUDA device.
The library is built and loaded at the first launch, so a process that
draws nothing on the card (a frame through the megakernel) never loads it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from .build import launch, load_library

# Launches made by each entry in this process.
LAUNCHES = {"stream_uniforms": 0, "ray_streams": 0}

_MASK = 0xFFFFFFFF


@functools.lru_cache(maxsize=None)
def _kernel_fns():
    lib = load_library("draws")
    p, i64 = ctypes.c_void_p, ctypes.c_longlong
    uniforms = lib.cornelis_stream_uniforms
    # keys, n, stream, num, out, cuda stream
    uniforms.argtypes = [p, i64, ctypes.c_uint32, ctypes.c_int, p, p]
    uniforms.restype = ctypes.c_int
    streams = lib.cornelis_ray_streams
    # root, pixel, sample, n, keys, pixel_seed, cuda stream
    streams.argtypes = [p, p, p, i64, p, p, p]
    streams.restype = ctypes.c_int
    return uniforms, streams


def _check(name: str, t: torch.Tensor, shape: tuple) -> None:
    if t.dtype != torch.int64:
        raise ValueError(f"{name} must be int64 words (got {t.dtype})")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape} (got {tuple(t.shape)})")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_device(device: torch.device, *tensors: torch.Tensor) -> None:
    if device.type != "cuda" or any(t.device != device for t in tensors):
        raise ValueError("the draws kernels take tensors on one CUDA device "
                         f"(got {[str(t.device) for t in tensors]})")


def stream_uniforms(keys: torch.Tensor, stream: int, num: int) -> torch.Tensor:
    """(N, num) float32 uniforms of draw group `stream` from ray keys
    (N, 2) int64 on a CUDA device: `rng.ray_uniforms(keys, stream, num)`."""
    if keys.dim() != 2:
        raise ValueError(f"keys must have shape (N, 2) (got {tuple(keys.shape)})")
    n = keys.shape[0]
    _check("keys", keys, (n, 2))
    if not 0 < num < 1 << 31:
        raise ValueError(f"num must be in [1, 2^31) (got {num})")
    _check_device(keys.device, keys)
    out = torch.empty((n, num), dtype=torch.float32, device=keys.device)
    if n:
        launch(_kernel_fns()[0], keys.device, keys.data_ptr(), n, int(stream) & _MASK, num,
               out.data_ptr())
        LAUNCHES["stream_uniforms"] += 1
    return out


def ray_streams(root: torch.Tensor, pixel_ids: torch.Tensor,
                sample_idx: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(keys (N, 2), pixel_seed (N,)), both int64, of global (pixel,
    sample) pairs (N,) int64 under the (2,) root key, all on one CUDA
    device: `make_ray_streams`'s key and pixel_seed."""
    device = root.device
    if pixel_ids.dim() != 1:
        raise ValueError(f"pixel_ids must have shape (N,) (got {tuple(pixel_ids.shape)})")
    n = pixel_ids.shape[0]
    _check("root", root, (2,))
    _check("pixel_ids", pixel_ids, (n,))
    _check("sample_idx", sample_idx, (n,))
    _check_device(device, root, pixel_ids, sample_idx)
    keys = torch.empty((n, 2), dtype=torch.int64, device=device)
    pixel_seed = torch.empty((n,), dtype=torch.int64, device=device)
    if n:
        launch(_kernel_fns()[1], device, root.data_ptr(), pixel_ids.data_ptr(),
               sample_idx.data_ptr(), n, keys.data_ptr(), pixel_seed.data_ptr())
        LAUNCHES["ray_streams"] += 1
    return keys, pixel_seed
