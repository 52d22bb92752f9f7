"""Pay the CUDA start-up costs before timed work: K2's counterpart.

Counterpart of `cornelis_tpu/ops/pallas_integrator.py::warm_pallas`, which
launched a one-block zero fill so that the TPU's first-launch
initialisation was paid before traffic. On CUDA the first launch of a
kernel carries the loading of its library and, since CUDA loads a
module's kernels lazily, of that kernel's own code. `warm_kernels` builds
and loads every library of ops/csrc/, forces each megakernel
instantiation to load, and launches the zero fill (ops/csrc/warm.cu) once.
`RenderSession` does not call it, as the JAX session did not call
`warm_pallas`; chip_smoke.py and profile_render.py call it before anything
is timed.
"""

from __future__ import annotations

import ctypes
import functools
import time

import torch

from .build import LIBRARIES, launch, load_library

# (8, 128) float32: the block the TPU kernel zero-filled.
WARM_SHAPE = (8, 128)
WARM_NUMEL = 8 * 128
_CUDA = torch.device("cuda")

# Launches of the zero-fill kernel made by `zero_block`.
LAUNCHES = 0


def zero_block_reference(device="cpu") -> torch.Tensor:
    """The plain version of the kernel."""
    return torch.zeros(WARM_SHAPE, dtype=torch.float32, device=device)


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    fn = load_library("warm").cornelis_zero_fill
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def zero_block(device="cuda") -> torch.Tensor:
    """An (8, 128) float32 block of zeros on `device`: the zero-fill kernel
    on a CUDA device, the plain version on the CPU. A failed launch
    raises. The path is kept as lean as `torch.zeros`'s: a torch.device is
    taken as given, and the launch is one ctypes call."""
    global LAUNCHES
    if not isinstance(device, torch.device):
        device = torch.device(device)
    if device != _CUDA:  # the common case skips device.type, a slow property
        if device.type == "cpu":
            return zero_block_reference(device)
        if device.type != "cuda":
            raise ValueError(f"no zero-fill kernel for device {device}")
    # Uninitialised memory: the kernel, not the allocator, writes the zeros.
    out = torch.empty(WARM_SHAPE, dtype=torch.float32, device=device)
    launch(_kernel_fn(), device, out.data_ptr(), WARM_NUMEL)
    LAUNCHES += 1
    return out


def warm_kernels(device="cuda") -> dict:
    """Build (where needed) and load every library, load each megakernel
    instantiation onto `device`, then launch the zero fill and synchronise.
    Returns {"load_s": seconds to build and load, "first_launch_s": seconds
    of the first zero fill, "zeros": its output}."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"warm_kernels needs a CUDA device, not {device}")
    with torch.cuda.device(device):
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        libs = {name: load_library(name) for name in LIBRARIES}
        for name in ("megakernel", "megakernel_nee"):
            fn = getattr(libs[name], f"cornelis_{name}_load")
            fn.argtypes = []
            fn.restype = ctypes.c_int
            err = fn()
            if err != 0:
                raise RuntimeError(f"loading the {name} kernels failed with CUDA error {err}")
        load_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        zeros = zero_block(device)
        torch.cuda.synchronize(device)
        first_launch_s = time.perf_counter() - t0
    return {"load_s": load_s, "first_launch_s": first_launch_s, "zeros": zeros}
