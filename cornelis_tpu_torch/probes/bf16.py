"""f32 against bf16 arithmetic probe on the sphere-quadratic chain.

    python -m cornelis_tpu_torch.probes.bf16

Counterpart of `benchmarks/bf16_probe.py::build` (K4): on a (2048, 128)
input, linspace(0, 4), 64 unrolled objects (c, d, k) each compute
b = x c + d, cc = x x - (c + c) x + k and disc = b b - cc in the working
type (float32 or bfloat16, each operation rounded to it), then compare
and square-root disc in float32 and accumulate the root in the working
type. The constants round from their Python floats through float32 to
the working type. ops/csrc/probes.cu holds the kernel, one template for
both types.

The command line times both types by CUDA events over chained launches
and prints their throughput ratio with the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import functools
import sys

import torch

from ..ops.build import launch, load_library
from . import linspace_f32

SHAPE = (2048, 128)  # ROWS * PASSES x LANES of the JAX probe
OBJECTS = 64
DTYPES = (torch.float32, torch.bfloat16)
REPEAT = 64

# Launches of the kernel made by `quad_probe`, by type.
LAUNCHES = {"float32": 0, "bfloat16": 0}


def consts():
    """bf16_probe.py::build's (c, d, k) of each object."""
    return [(0.1 + 0.01 * j, 0.5 - 0.003 * j, 1.0 + 0.02 * j) for j in range(OBJECTS)]


def probe_input(dtype=torch.float32, device="cpu") -> torch.Tensor:
    """The JAX probe's input: jnp.linspace(0, 4) in float32, cast."""
    return linspace_f32(4.0, SHAPE[0] * SHAPE[1], device).reshape(SHAPE).to(dtype)


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
def _fn():
    fn = load_library("probes").cornelis_quad_probe
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [i, p, p, i, p]  # bf16, x, out, n, stream
    fn.restype = ctypes.c_int
    return fn


def quad_probe(x: torch.Tensor) -> torch.Tensor:
    """K4 on x's device and in x's type (float32 or bfloat16): the kernel
    on CUDA, the plain version on the CPU."""
    if x.dtype not in DTYPES or not x.is_contiguous():
        raise ValueError(f"the probe input must be contiguous, of a type in {DTYPES}")
    if x.device.type == "cpu":
        return quad_reference(x)
    out = torch.empty_like(x)
    launch(_fn(), x.device, int(x.dtype == torch.bfloat16), x.data_ptr(), out.data_ptr(),
           x.numel())
    LAUNCHES[str(x.dtype).split(".")[-1]] += 1
    return out


def main() -> int:
    from ..utils.timing import card_line, event_ms

    if not torch.cuda.is_available():
        print("bf16 probe: no CUDA device", file=sys.stderr)
        return 1
    print(card_line())
    tests = SHAPE[0] * SHAPE[1] * OBJECTS
    ms = {}
    for dtype in DTYPES:
        x = probe_input(dtype, "cuda")
        ms[dtype] = event_ms(lambda: quad_probe(x), REPEAT)
        print(f"{str(dtype).split('.')[-1]:9s}: {ms[dtype]:.4f} ms per launch (CUDA events, "
              f"{REPEAT} launches), {tests / ms[dtype] / 1e6:.2f} G obj-tests/s")
    print(f"bf16 / f32 scan throughput: {ms[torch.float32] / ms[torch.bfloat16]:.3f}x")
    return 0


if __name__ == "__main__":
    sys.exit(main())
