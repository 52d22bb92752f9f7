"""f32 against bf16 arithmetic probe on the sphere-quadratic chain.

    python -m cornelis_tpu_torch.probes.bf16

Counterpart of `benchmarks/bf16_probe.py::build` (K4): on a (2048, 128)
input, linspace(0, 4), 64 unrolled objects (c, d, k) each compute
b = x c + d, cc = x x - (c + c) x + k and disc = b b - cc in the working
type (float32 or bfloat16, each operation rounded to it), then compare
and square-root disc in float32 and accumulate the root in the working
type. The constants round from their Python floats through float32 to
the working type. ops/csrc/probes.cu holds the kernel, one template for
both types; bfloat16 runs in element pairs.

disc is negative for every finite x: as a quadratic in x its maximum is
below -0.2 for each object, far beyond either type's rounding, and NaN,
infinite or overflowing inputs make it NaN or -inf. So every root is 0 and
the output is +0 on every input; the probe measures the chain's
throughput, which the kernel spends in full (the compiler cannot know).

`special_input` holds the inputs at the chain's edges: every bfloat16 bit
pattern, or in float32 NaN, infinities, zeros, subnormals, negatives,
x on either side of where x * x and b * b overflow, x where each object's
disc peaks, and random bit patterns. `launch_shape` reports how the
kernel launches.

The command line times both types, by CUDA events over chained launches
and by the profiler's kernel time (the chained figure is bounded by the
host's launch rate where a launch takes under ~10 us), and prints their
throughput ratio with the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import functools
import sys

import numpy as np
import torch

from ..ops.build import launch, load_library
from . import linspace_f32

SHAPE = (2048, 128)  # ROWS * PASSES x LANES of the JAX probe
OBJECTS = 64
DTYPES = (torch.float32, torch.bfloat16)
REPEAT = 64
SPECIAL_SEED = 20260917

# Launches of the kernel made by `quad_probe`, by type.
LAUNCHES = {"float32": 0, "bfloat16": 0}


def consts():
    """bf16_probe.py::build's (c, d, k) of each object."""
    return [(0.1 + 0.01 * j, 0.5 - 0.003 * j, 1.0 + 0.02 * j) for j in range(OBJECTS)]


def probe_input(dtype=torch.float32, device="cpu") -> torch.Tensor:
    """The JAX probe's input: jnp.linspace(0, 4) in float32, cast."""
    return linspace_f32(4.0, SHAPE[0] * SHAPE[1], device).reshape(SHAPE).to(dtype)


def special_lanes() -> dict:
    """float32 inputs at the chain's edges, by kind: "extreme" (NaN,
    infinities, signed zeros, subnormals, the smallest normal, negatives,
    the largest finite values); "overflow" (x from 1.8e19 to 3e19, where
    x * x overflows, from 2^64, and b * b, from about 2^64 / c, with the
    floats next to 2^64, both signs); "peak" (for each object the x at
    which disc peaks, and 4 float32 steps on either side)."""
    f = np.float32
    tiny = np.finfo(f).tiny
    extreme = [np.nan, np.inf, -np.inf, 0.0, -0.0, 1e-45, -1e-45, 1e-40, -1e-40,
               np.nextafter(tiny, f(0)), tiny, -tiny, 1e-30, 1e-12, -1e-12, 0.5, -0.5, -1.0,
               -4.0, -100.0, 1e30, -1e30, np.finfo(f).max, -np.finfo(f).max]
    edge = np.float32(2.0 ** 64)
    near = [edge]
    up = down = edge
    for _ in range(8):
        up, down = np.nextafter(up, f(np.inf)), np.nextafter(down, f(0))
        near += [up, down]
    overflow = np.concatenate([np.linspace(1.8e19, 3e19, 240), near]).astype(f)
    peak = []
    for c, d, k in consts():
        c, d = float(f(c)), float(f(d))
        # disc(x) = (c c - 1) x x + 2 (c d + c) x + d d - k peaks at:
        x = f(-(c * d + c) / (c * c - 1.0))
        peak.append(x)
        up = down = x
        for _ in range(4):
            up, down = np.nextafter(up, f(np.inf)), np.nextafter(down, f(-np.inf))
            peak += [up, down]
    return {"extreme": np.asarray(extreme, f), "overflow": np.concatenate([overflow, -overflow]),
            "peak": np.asarray(peak, f)}


def special_input(dtype=torch.float32, device="cpu") -> torch.Tensor:
    """K4's special input in SHAPE: in bfloat16 every bit pattern, four
    times over; in float32 `special_lanes()`, kind after kind, then random
    bit patterns (SPECIAL_SEED)."""
    n = SHAPE[0] * SHAPE[1]
    if dtype == torch.bfloat16:
        bits = np.tile(np.arange(1 << 16, dtype=np.uint16), n >> 16).view(np.int16)
        x = torch.from_numpy(bits.copy()).view(torch.bfloat16)
    elif dtype == torch.float32:
        lanes = np.concatenate(list(special_lanes().values()))
        rng = np.random.default_rng(SPECIAL_SEED)
        noise = rng.integers(0, 1 << 32, size=n - lanes.size, dtype=np.uint32).view(np.float32)
        x = torch.from_numpy(np.concatenate([lanes, noise]))
    else:
        raise ValueError(f"the probe input must be of a type in {DTYPES}")
    return x.reshape(SHAPE).to(device)


def quad_reference(x: torch.Tensor) -> torch.Tensor:
    """The plain version: each operation in x's type, as the JAX body."""
    dtype = x.dtype

    def const(v):
        return torch.tensor(v, dtype=torch.float32, device=x.device).to(dtype)

    acc = torch.zeros_like(x)
    for c, d, k in consts():
        cj, dj, kj = const(c), const(d), const(k)
        b = x * cj + dj
        cc = x * x - (cj + cj) * x + kj
        disc = b * b - cc
        d32 = disc.to(torch.float32)
        root = torch.where(d32 > 0, torch.sqrt(torch.clamp_min(d32, 1e-12)), 0.0)
        acc = acc + root.to(dtype)
    return acc


@functools.lru_cache(maxsize=None)
def _fns():
    lib = load_library("probes")
    p, i = ctypes.c_void_p, ctypes.c_int
    fn, shape = lib.cornelis_quad_probe, lib.cornelis_quad_shape
    fn.argtypes = [i, p, p, i, p]  # bf16, x, out, n, stream
    shape.argtypes = [i, i, p]  # bf16, n, int[3]
    fn.restype = shape.restype = ctypes.c_int
    return fn, shape


def launch_shape(dtype=torch.float32, n: int = SHAPE[0] * SHAPE[1]) -> dict:
    """How the kernel launches over n elements of `dtype`: threads a block,
    blocks, elements a thread."""
    shape = (ctypes.c_int * 3)()
    _fns()[1](int(dtype == torch.bfloat16), n, shape)
    return dict(zip(("block", "blocks", "elements_per_thread"), shape))


def quad_probe(x: torch.Tensor) -> torch.Tensor:
    """K4 on x's device and in x's type (float32 or bfloat16): the kernel
    on CUDA, the plain version on the CPU."""
    if x.dtype not in DTYPES or not x.is_contiguous():
        raise ValueError(f"the probe input must be contiguous, of a type in {DTYPES}")
    if x.device.type == "cpu":
        return quad_reference(x)
    out = torch.empty_like(x)
    launch(_fns()[0], x.device, int(x.dtype == torch.bfloat16), x.data_ptr(), out.data_ptr(),
           x.numel())
    LAUNCHES[str(x.dtype).split(".")[-1]] += 1
    return out


def main() -> int:
    from ..utils.timing import card_line, event_ms, kernel_ms

    if not torch.cuda.is_available():
        print("bf16 probe: no CUDA device", file=sys.stderr)
        return 1
    print(card_line())
    tests = SHAPE[0] * SHAPE[1] * OBJECTS
    ms, device_ms = {}, {}
    for dtype in DTYPES:
        x = probe_input(dtype, "cuda")
        ms[dtype] = event_ms(lambda: quad_probe(x), REPEAT)
        device_ms[dtype], kept = kernel_ms(lambda: quad_probe(x), REPEAT, "quad_probe")
        print(f"{str(dtype).split('.')[-1]:9s}: {ms[dtype]:.4f} ms per launch (CUDA events, "
              f"{REPEAT} chained launches), {device_ms[dtype]:.4f} ms on the device (profiler, "
              f"{kept} of {REPEAT} kernels kept), "
              f"{tests / device_ms[dtype] / 1e6:.2f} G obj-tests/s")
    print(f"bf16 / f32 scan throughput: {device_ms[torch.float32] / device_ms[torch.bfloat16]:.3f}x "
          f"on the device, {ms[torch.float32] / ms[torch.bfloat16]:.3f}x chained")
    return 0


if __name__ == "__main__":
    sys.exit(main())
