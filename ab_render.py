#!/usr/bin/env python3
"""Time this tree's megakernel, zero fill and scan probes against another
tree's, in turns, on one CUDA device.

    mkdir -p OTHER
    git archive <commit> cornelis_tpu_torch | tar -x -C OTHER
    python3 ab_render.py OTHER

Loads the other tree's `cornelis_tpu_torch` under another name (each tree
builds its kernels from its own sources into its own `_build/`), then, for
every megakernel row of chip_smoke.py's phase 5 (K1 and K3 on the Cornell
box, K1 on sdf-gallery; each mode and sampler; one 32-spp chunk at
512x512, spp_total 256, max_depth 64; K1's light table built once, as a
session builds it, K3's with every launch), times a launch by CUDA events
over several launches, in turns: other, this, this, other, twice.
It prints each row's readings, their medians, the spread of each side
(largest reading less smallest) and the share of rays on which the two
trees' outputs are bitwise equal and within 1e-4. Then the same turns for
this tree's nee rows against its nee library built without -fmad=false (an
experiment: the port builds it with the flag), and for K2's zero fill
against the other tree's and torch.zeros (200 calls a reading). Last, the
scan probes K5 (512 spheres) and K6 at their JAX shape, on the probe
input, in the same turns with 200 launches a reading, and the share of
lanes on which the two trees' outputs are bitwise equal, on the probe
input and on the special lanes.

Prints the card's name and power limit first and a JSON record last;
imports no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib
import importlib.util
import json
import os
import statistics
import subprocess
import sys

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 19791102
ROUNDS = 2
VARIANTS = (("path", "uniform"), ("path", "sobol"), ("nee", "uniform"), ("nee", "sobol"))
# (row kind, scene, K3): the rows of chip_smoke.py's phase 5.
ROWS = (("megakernel", "cornell_box", False), ("dynamic", "cornell_box", True),
        ("megakernel", "sdf_gallery", False))
MODULES = ("ops.megakernel", "ops.lights", "ops.warm", "ops.build", "scene.compile",
           "scene.library", "rng", "utils.timing", "probes.scene_table")


def load_tree(root: str, alias: str) -> dict:
    """The modules of the `cornelis_tpu_torch` under `root`, imported as
    package `alias`."""
    init = os.path.join(root, "cornelis_tpu_torch", "__init__.py")
    spec = importlib.util.spec_from_file_location(
        alias, init, submodule_search_locations=[os.path.dirname(init)])
    pkg = importlib.util.module_from_spec(spec)
    sys.modules[alias] = pkg
    spec.loader.exec_module(pkg)
    return {name: importlib.import_module(f"{alias}.{name}") for name in MODULES}


def row_runner(tree: dict, scene: str, dynamic: bool, mode: str, sampler: str):
    """A call that launches the row's kernel once on `tree`'s code."""
    m, lt = tree["ops.megakernel"], tree["ops.lights"]
    tables = tree["scene.compile"].compile_scene(getattr(tree["scene.library"], scene)(),
                                                 device="cuda")
    k0, k1, root = tree["rng"].key_row(SEED)
    bits = m.index_bits_for(256)
    fixed = lt.light_table(tables) if mode == "nee" and not dynamic else None

    def run():
        lights = lt.light_table_dyn(tables) if mode == "nee" and dynamic else fixed
        return m.render_rays(tables, k0, k1, 512, 512, 32, 0, 64, root=root, sampler=sampler,
                             mode=mode, index_bits=bits, lights=lights)

    return run


def turns(a, b, rounds: int, launches: int, event_ms) -> dict:
    """Readings of a and b in the order a, b, b, a, per round."""
    out = {"a": [], "b": []}
    for _ in range(rounds):
        for side in ("a", "b", "b", "a"):
            out[side].append(event_ms(a if side == "a" else b, launches))
    return out


def summary(readings: dict) -> dict:
    return {side: {"ms": xs, "median": statistics.median(xs), "spread": max(xs) - min(xs)}
            for side, xs in readings.items()}


def agreement(x, y) -> dict:
    import torch

    return {"bitwise": (x == y).all(1).double().mean().item(),
            "within_1e-4": torch.isclose(x, y, rtol=1e-4, atol=1e-4).all(1).double().mean().item()}


def probe_rows(other: dict, this: dict, event_ms) -> dict:
    """K5 and K6 of both trees, in turns, on this tree's inputs."""
    st = this["probes.scene_table"]
    inputs = {"probe": st.probe_input("cuda"), "special": st.special_input("cuda")}
    tab = st.table(st.DEFAULT_N, "cuda")
    rows = {}
    for kind in ("baked", "dynamic"):
        def runner(tree, o, kind=kind):
            mod = tree["probes.scene_table"]
            if kind == "baked":
                return lambda: mod.scan_baked(o, st.DEFAULT_N)
            return lambda: mod.scan_dynamic(o, tab)

        o = inputs["probe"]
        res = summary(turns(runner(other, o), runner(this, o), ROUNDS, 200, event_ms))
        res["bitwise"] = {name: (runner(other, x)() == runner(this, x)()).double().mean().item()
                          for name, x in inputs.items()}
        rows[kind] = res
        print(f"scan_{kind} ({st.DEFAULT_N} spheres): other {res['a']['median']:.4f} ms (spread "
              f"{res['a']['spread']:.4f}), this {res['b']['median']:.4f} ms (spread "
              f"{res['b']['spread']:.4f}), this/other {res['b']['median'] / res['a']['median']:.3f}; "
              f"lanes bitwise equal: probe input {res['bitwise']['probe']:.4%}, special lanes "
              f"{res['bitwise']['special']:.4%}; readings {res['a']['ms']} / {res['b']['ms']}")
    return rows


def build_nee_with_fma(build) -> ctypes.CDLL:
    """This tree's nee library built without -fmad=false, beside the others."""
    out = build.BUILD_DIR / "ab" / "libmegakernel_nee_fma.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(out),
                           str(build.CSRC / "megakernel_nee.cu")], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stderr}")
    report = [line.strip() for line in (proc.stdout + proc.stderr).splitlines()
              if "registers" in line or "spill" in line]
    print("nee library without -fmad=false, ptxas:", *report, sep="\n  ")
    return ctypes.CDLL(str(out))


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("other", help="a directory holding another tree's cornelis_tpu_torch/")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("ab_render: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    this = {name: importlib.import_module(f"cornelis_tpu_torch.{name}") for name in MODULES}
    other = load_tree(os.path.abspath(args.other), "other_cornelis_tpu_torch")
    event_ms = this["utils.timing"].event_ms
    card = this["utils.timing"].card_line()
    print(card)
    for tree in (other, this):
        tree["ops.build"].build_all()
        tree["ops.warm"].warm_kernels()
    record = {"card": card, "rounds": ROUNDS, "rows": {}, "fma": {}, "zero_fill": {}, "probes": {}}

    print("== megakernel rows: other (a) and this tree (b), ms per launch")
    runners = {}
    for kind, scene, dynamic in ROWS:
        for mode, sampler in VARIANTS:
            name = f"{kind} {mode}/{sampler}" + (" sdf" if scene == "sdf_gallery" else "")
            a = row_runner(other, scene, dynamic, mode, sampler)
            b = row_runner(this, scene, dynamic, mode, sampler)
            runners[name] = b
            launches = 4 if scene == "sdf_gallery" else 10
            res = summary(turns(a, b, ROUNDS, launches, event_ms))
            res["agreement"] = agreement(a(), b())
            record["rows"][name] = res
            print(f"{name}: other {res['a']['median']:.4f} ms (spread {res['a']['spread']:.4f}), "
                  f"this {res['b']['median']:.4f} ms (spread {res['b']['spread']:.4f}), "
                  f"this/other {res['b']['median'] / res['a']['median']:.3f}; rays bitwise equal "
                  f"{res['agreement']['bitwise']:.4%}, within 1e-4 "
                  f"{res['agreement']['within_1e-4']:.4%}; readings {res['a']['ms']} / "
                  f"{res['b']['ms']}")

    print("== nee rows: this tree (a) and its nee library without -fmad=false (b)")
    m = this["ops.megakernel"]
    fma_fn = build_nee_with_fma(this["ops.build"]).cornelis_megakernel_nee
    fma_fn.argtypes = m._kernel_fn(True).argtypes
    fma_fn.restype = ctypes.c_int
    kernel_fn = m._kernel_fn

    def with_fma(run):
        def call():
            m._kernel_fn = lambda nee: fma_fn if nee else kernel_fn(nee)
            try:
                return run()
            finally:
                m._kernel_fn = kernel_fn
        return call

    for name, run in runners.items():
        if " nee/" not in name:
            continue
        launches = 4 if name.endswith("sdf") else 10
        res = summary(turns(run, with_fma(run), ROUNDS, launches, event_ms))
        res["agreement"] = agreement(run(), with_fma(run)())
        record["fma"][name] = res
        print(f"{name}: -fmad=false {res['a']['median']:.4f} ms (spread {res['a']['spread']:.4f}), "
              f"contracted {res['b']['median']:.4f} ms (spread {res['b']['spread']:.4f}), "
              f"ratio {res['b']['median'] / res['a']['median']:.3f}; rays bitwise equal "
              f"{res['agreement']['bitwise']:.4%}, within 1e-4 {res['agreement']['within_1e-4']:.4%}")

    print("== zero fill: other (a) and this tree (b), and torch.zeros, ms per call")
    dev = torch.device("cuda")
    zero_a = lambda: other["ops.warm"].zero_block(dev)  # noqa: E731
    zero_b = lambda: this["ops.warm"].zero_block(dev)  # noqa: E731
    zeros = []
    readings = {"a": [], "b": []}
    for _ in range(ROUNDS):
        part = turns(zero_a, zero_b, 1, 200, event_ms)
        readings["a"] += part["a"]
        readings["b"] += part["b"]
        zeros.append(event_ms(lambda: torch.zeros((8, 128), device=dev), 200))
    res = summary(readings)
    res["torch.zeros"] = {"ms": zeros, "median": statistics.median(zeros),
                          "spread": max(zeros) - min(zeros)}
    record["zero_fill"] = res
    print(f"zero_fill: other {res['a']['median']:.5f} ms, this {res['b']['median']:.5f} ms, "
          f"torch.zeros {res['torch.zeros']['median']:.5f} ms; readings {res['a']['ms']} / "
          f"{res['b']['ms']} / {zeros}")

    print("== scan probes: other (a) and this tree (b), ms per launch")
    record["probes"] = probe_rows(other, this, event_ms)
    print(card)
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
