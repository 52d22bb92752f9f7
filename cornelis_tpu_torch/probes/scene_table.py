"""Sphere-scan probe of table placement: scene constants baked in against read from a table.

    python -m cornelis_tpu_torch.probes.scene_table [n_obj]   # n_obj 512 (default) or 8

Counterpart of `benchmarks/dynamic_scene_probe.py`: `build_baked` (K5)
and `build_dynamic` (K6). Both scan the same (1024, 128) float32 input,
linspace(0, 24) as origins ox with oy = 0.5 ox, oz = 0.25 ox and the
direction (0.27, 0.53, 0.80), and keep per lane the nearest first root
over n spheres (`_scan_body`). K5 takes the spheres as compile-time
constants (ops/csrc/probes.cu instantiates n = 8 and 512); K6 reads an
(n, 4) float32 table. `_consts(n)` is copied here. The two differ in one
rounding, as the JAX kernels do: K5 squares r in double before rounding
to float32 (a Python-float literal), K6 squares the float32 r.

`special_input` sets the first lanes to the cases the scan's tests meet
at their edges (NaN, infinities, zeros, huge origins, origins inside a
sphere, grazing rays); `launch_shape` reports how each kernel launches.

The command line times both kernels by CUDA events over chained launches
and prints their ratio with the card's name and power limit. On the H100
(PERF.md §6) the ratio says what reading the spheres from a table costs
against literals the compiler can fold: with the table staged in shared
memory and read once for two rays, the read itself is nearly free, and
the baked scan is faster only by the terms the compiler shares between
spheres with a coordinate in common.
"""

from __future__ import annotations

import ctypes
import functools
import math
import sys

import numpy as np
import torch

from ..ops.build import launch, load_library
from . import linspace_f32

SHAPE = (1024, 128)  # ROWS * PASSES x LANES of the JAX probe
DEFAULT_N = 512
BAKED_COUNTS = (8, 512)  # the baked instantiations of csrc/probes.cu
STAGE_TILE = 512  # spheres of one K6 tile staged in shared memory (csrc/probes.cu TILE)
D = (0.27, 0.53, 0.80)
REPEAT = 32

# Launches of each kernel made by `scan_baked` and `scan_dynamic`.
LAUNCHES = {"baked": 0, "dynamic": 0}


def consts(n: int):
    """dynamic_scene_probe.py::_consts: (cx, cy, cz, r) of sphere j."""
    return [
        (
            0.5 + 3.1 * (j % 8),
            0.5 + 3.1 * ((j // 8) % 8),
            0.5 + 3.1 * (j // 64),
            0.45 + 0.1 * (j % 3),
        )
        for j in range(n)
    ]


def table(n: int, device="cpu") -> torch.Tensor:
    """K6's (n, 4) float32 table."""
    return torch.tensor(consts(n), dtype=torch.float32, device=device).reshape(n, 4)


def probe_input(device="cpu") -> torch.Tensor:
    """The JAX probe's input: jnp.linspace(0, 24) in float32."""
    return linspace_f32(24.0, SHAPE[0] * SHAPE[1], device).reshape(SHAPE)


# Special origins beside the inside and grazing ones: NaN, infinities,
# signed zeros, subnormals, the smallest normal, and origins so large that
# b * b or the sum of squares overflows (disc is then inf - inf, NaN).
EXTREMES = (math.nan, math.inf, -math.inf, 0.0, -0.0, 1e-45, -1e-45, 1.1754944e-38, 1e-30,
            1e19, -1e19, 1e30, -1e30, 3.4028235e38, -3.4028235e38)
GRAZE_ULPS = 4


def special_lanes(n: int = DEFAULT_N) -> dict:
    """float32 origins ox on which the scan's tests meet their edge cases,
    by kind: "extreme", EXTREMES; "inside", the origin nearest the centre
    of each of the n spheres that the line of origins passes through
    (c < 0); "grazing", for each sphere that some ray touches, the two
    origins whose ray is tangent to it (disc = 0, a quadratic in ox solved
    in float64) and GRAZE_ULPS float32 steps on either side of each."""
    u, d = np.array([1.0, 0.5, 0.25]), np.array(D)
    inside, grazing = [], []
    for cx, cy, cz, r in consts(n):
        p = np.array([cx, cy, cz])
        nearest = (u @ p) / (u @ u)
        if np.linalg.norm(nearest * u - p) < r:
            inside.append(nearest)
        # disc(x) = (x u.d - p.d)^2 - |x u - p|^2 + r^2 = a x^2 + b x + c
        a = (u @ d) ** 2 - u @ u
        b = 2.0 * (u @ p - (u @ d) * (p @ d))
        c = (p @ d) ** 2 - p @ p + r * r
        if b * b - 4.0 * a * c < 0.0:
            continue
        for sign in (1.0, -1.0):
            root = np.float32((-b + sign * math.sqrt(b * b - 4.0 * a * c)) / (2.0 * a))
            grazing.append(root)
            up = down = root
            for _ in range(GRAZE_ULPS):
                up, down = np.nextafter(up, np.float32(np.inf)), np.nextafter(down, np.float32(-np.inf))
                grazing += [up, down]
    return {kind: np.asarray(lanes, np.float32)
            for kind, lanes in (("extreme", EXTREMES), ("inside", inside), ("grazing", grazing))}


def special_input(device="cpu") -> torch.Tensor:
    """The probe input with its first lanes set to `special_lanes()`, kind
    after kind in its order."""
    o = probe_input()
    lanes = torch.from_numpy(np.concatenate(list(special_lanes().values())))
    o.view(-1)[: lanes.numel()] = lanes
    return o.to(device)


def _scan_body(ox, oy, oz, cx, cy, cz, rr, best):
    """One sphere of the scan (a == 1); rr is r * r, a Python float (K5)
    or a float32 tensor (K6)."""
    rx, ry, rz = ox - cx, oy - cy, oz - cz
    b = rx * D[0] + ry * D[1] + rz * D[2]
    c = rx * rx + ry * ry + rz * rz - rr
    disc = b * b - c
    shift = torch.sqrt(torch.clamp_min(disc, 1e-12))
    t0 = -b - shift
    t = torch.where((disc >= 0.0) & (t0 > 1e-3), t0, math.inf)
    return torch.minimum(best, t)


def _origins(o):
    return o, o * 0.5, o * 0.25


def scan_baked_reference(o: torch.Tensor, n_obj: int) -> torch.Tensor:
    """The plain version of K5: the constants as Python floats."""
    ox, oy, oz = _origins(o)
    best = torch.full_like(o, math.inf)
    for cx, cy, cz, r in consts(n_obj):
        best = _scan_body(ox, oy, oz, cx, cy, cz, r * r, best)
    return best


def scan_dynamic_reference(o: torch.Tensor, tab: torch.Tensor) -> torch.Tensor:
    """The plain version of K6: the table's float32 scalars."""
    ox, oy, oz = _origins(o)
    best = torch.full_like(o, math.inf)
    for cx, cy, cz, r in tab:
        best = _scan_body(ox, oy, oz, cx, cy, cz, r * r, best)
    return best


@functools.lru_cache(maxsize=None)
def _fns():
    lib = load_library("probes")
    p, i = ctypes.c_void_p, ctypes.c_int
    baked, dynamic, shape = lib.cornelis_scan_baked, lib.cornelis_scan_dynamic, lib.cornelis_scan_shape
    baked.argtypes = [i, p, p, i, p]  # n_obj, o, out, n, stream
    dynamic.argtypes = [p, i, p, p, i, p]  # table, n_obj, o, out, n, stream
    shape.argtypes = [i, i, i, p]  # dynamic, n_obj, n, int[4]
    baked.restype = dynamic.restype = shape.restype = ctypes.c_int
    return baked, dynamic, shape


def launch_shape(kind: str, n_obj: int = DEFAULT_N, n: int = SHAPE[0] * SHAPE[1]) -> dict:
    """How K5 ("baked", n_obj spheres) or K6 ("dynamic") launches over n
    elements on the current CUDA device: threads a block, blocks (one wave,
    or fewer where the elements need fewer), rays a thread, and spheres a
    pass of its sphere loop."""
    shape = (ctypes.c_int * 4)()
    err = _fns()[2](int(kind == "dynamic"), n_obj, n, shape)
    if err != 0:
        raise RuntimeError(f"cornelis_scan_shape failed with CUDA error {err}")
    return dict(zip(("block", "blocks", "rays_per_thread", "spheres_per_pass"), shape))


def _check(o: torch.Tensor) -> None:
    if o.dtype != torch.float32 or not o.is_contiguous():
        raise ValueError("the probe input must be contiguous float32")


def scan_baked(o: torch.Tensor, n_obj: int = DEFAULT_N) -> torch.Tensor:
    """K5 on o's device: the kernel on CUDA (n_obj in BAKED_COUNTS), the
    plain version on the CPU."""
    _check(o)
    if o.device.type == "cpu":
        return scan_baked_reference(o, n_obj)
    if n_obj not in BAKED_COUNTS:
        raise ValueError(f"the baked scan is instantiated for {BAKED_COUNTS} spheres, not {n_obj}")
    out = torch.empty_like(o)
    launch(_fns()[0], o.device, n_obj, o.data_ptr(), out.data_ptr(), o.numel())
    LAUNCHES["baked"] += 1
    return out


def scan_dynamic(o: torch.Tensor, tab: torch.Tensor) -> torch.Tensor:
    """K6 on o's device against the (n, 4) table on the same device."""
    _check(o)
    if tab.dtype != torch.float32 or not tab.is_contiguous() or tab.ndim != 2 or tab.shape[1] != 4:
        raise ValueError("the table must be contiguous float32 (n, 4)")
    if tab.device != o.device:
        raise ValueError("the table and the input must share a device")
    if o.device.type == "cpu":
        return scan_dynamic_reference(o, tab)
    out = torch.empty_like(o)
    launch(_fns()[1], o.device, tab.data_ptr(), tab.shape[0], o.data_ptr(), out.data_ptr(),
           o.numel())
    LAUNCHES["dynamic"] += 1
    return out


def main(argv=None) -> int:
    from ..utils.timing import card_line, event_ms

    argv = sys.argv[1:] if argv is None else argv
    n_obj = int(argv[0]) if argv else DEFAULT_N
    if not torch.cuda.is_available():
        print("scene_table probe: no CUDA device", file=sys.stderr)
        return 1
    print(card_line())
    o = probe_input("cuda")
    tab = table(n_obj, "cuda")
    tests = o.numel() * n_obj
    ms = {
        "baked": event_ms(lambda: scan_baked(o, n_obj), REPEAT),
        "dynamic": event_ms(lambda: scan_dynamic(o, tab), REPEAT),
    }
    for name, t in ms.items():
        print(f"{name:8s} ({n_obj} obj): {t:.4f} ms per launch (CUDA events, {REPEAT} launches), "
              f"{tests / t / 1e6:.2f} G obj-tests/s")
    print(f"dynamic / baked scan throughput: {ms['baked'] / ms['dynamic']:.3f}x")
    return 0


if __name__ == "__main__":
    sys.exit(main())
