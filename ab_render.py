#!/usr/bin/env python3
"""Time this tree's megakernel, zero fill and probes against another
tree's, in turns, on one CUDA device.

    mkdir -p OTHER
    git archive <commit> cornelis_tpu_torch | tar -x -C OTHER
    python3 ab_render.py OTHER [--parts sass,rows,dynamic,fma,zero,probes,quad]

Loads the other tree's `cornelis_tpu_torch` under another name (each tree
builds its kernels from its own sources into its own `_build/`). "sass"
compares the two trees' SASS kernel by kernel (instructions, registers,
spills, and whether the instruction text is the same). "rows": for
every megakernel row of chip_smoke.py's phase 5 (K1 and K3 on the Cornell
box, K1 on sdf-gallery; each mode and sampler; one 32-spp chunk at
512x512, spp_total 256, max_depth 64; K1's light table built once, as a
session builds it, K3's in the launch itself, `lights.IN_LAUNCH`), times
a launch by CUDA events over several launches, in turns: other, this,
this, other, twice.
It prints each row's readings, their medians, the spread of each side
(largest reading less smallest) and the share of rays on which the two
trees' outputs are bitwise equal and within 1e-4. Then the same turns for
this tree's nee rows against its nee library built without -fmad=false (an
experiment: the port builds it with the flag), and for K2's zero fill
against the other tree's and torch.zeros (200 calls a reading). Last, the
scan probes K5 (512 spheres) and K6 at their JAX shape, on the probe
input, in the same turns with 200 launches a reading, and the share of
lanes on which the two trees' outputs are bitwise equal, on the probe
input and on the special lanes. "quad": K4 in both types, the same turns
by CUDA events over 200 chained launches and by the profiler's kernel
time (its launches are shorter than the host's), and the share of
elements bitwise equal on the probe and special inputs. "dynamic": the
dynamic nee render (render_chunk_dynamic over a 512x512, 256-spp frame,
8 chunks; host clock around a synchronize) and its 32-spp chunk (CUDA
events) on Cornell and sphere_grid(512), in the same turns, with the
share of pixels bitwise equal; each tree's table kernel's device time
(profiler) on both;
and this tree's dynamic nee chunk against its K1 nee instantiation fed a
table built once, in the same turns, and the same two as launches of one
ray (one block: the prologue's cost apart from the bounce loop's code),
by the profiler's device time.

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
MODULES = ("ops.megakernel", "ops.lights", "ops.warm", "ops.build", "scene.compile", "scene.library", "rng", "utils.timing", "probes.scene_table",
           "probes.bf16")
PARTS = ("sass", "rows", "dynamic", "fma", "zero", "probes", "quad")


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


def row_runner(tree: dict, scene: str, dynamic: bool, mode: str, sampler: str, tables=None):
    """A call that launches the row's kernel once on `tree`'s code."""
    m, lt = tree["ops.megakernel"], tree["ops.lights"]
    if tables is None:
        tables = tree["scene.compile"].compile_scene(getattr(tree["scene.library"], scene)(),
                                                     device="cuda")
    k0, k1, root = tree["rng"].key_row(SEED)
    bits = m.index_bits_for(256)
    lights = None
    if mode == "nee":
        lights = lt.IN_LAUNCH if dynamic else lt.light_table(tables)

    def run():
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


def sass_rows(other: dict, this: dict) -> dict:
    """Both trees' kernels, built anew: SASS instructions, registers and
    spill bytes by kernel, and whether the SASS text is the same."""
    sys.path.insert(0, REPO)
    import chip_smoke

    seen = {}
    for side, tree in (("other", other), ("this", this)):
        built = tree["ops.build"].build_all(force=True)
        listings = chip_smoke.sass_listings(built)
        report = chip_smoke.ptxas_report(tree["ops.build"].BUILD_LOGS)
        for name, (regs, _stack, spill) in report.items():
            seen.setdefault(name, {})[side] = {
                "sass": len(listings.get(name, [])), "registers": regs, "spill_bytes": spill,
                "text": [text for _addr, text in listings.get(name, [])]}
    rows = {}
    for name, sides in sorted(seen.items()):
        same = "other" in sides and "this" in sides and sides["other"]["text"] == sides["this"]["text"]
        rows[name] = {side: {k: v for k, v in info.items() if k != "text"}
                      for side, info in sides.items()}
        rows[name]["same_sass"] = same
        print(f"{name}: " + "; ".join(
            f"{side} {info['sass']} SASS, {info['registers']} registers, {info['spill_bytes']} B "
            f"spilled" for side, info in rows[name].items() if side != "same_sass")
            + f"; SASS text {'the same' if same else 'differs'}")
    return rows


def quad_rows(other: dict, this: dict, event_ms, kernel_ms) -> dict:
    """K4 of both trees in both types, in turns, on this tree's inputs."""
    import torch

    tb = this["probes.bf16"]
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        x = tb.probe_input(dtype, "cuda")
        a = lambda x=x: other["probes.bf16"].quad_probe(x)  # noqa: E731
        b = lambda x=x: this["probes.bf16"].quad_probe(x)  # noqa: E731
        kept = {"a": [], "b": []}

        def device_ms(fn, n, a=a):
            ms, count = kernel_ms(fn, n, "quad_probe")
            kept["a" if fn is a else "b"].append(count)
            return ms

        res = {"chained": summary(turns(a, b, ROUNDS, 200, event_ms)),
               "device": summary(turns(a, b, ROUNDS, 64, device_ms)),
               "device_kept": kept, "device_launches": 64}
        bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
        res["bitwise"] = {
            name: (other["probes.bf16"].quad_probe(y).view(bits)
                   == this["probes.bf16"].quad_probe(y).view(bits)).double().mean().item()
            for name, y in (("probe", x), ("special", tb.special_input(dtype, "cuda")))}
        name = str(dtype).split(".")[-1]
        rows[name] = res
        dev, chn = res["device"], res["chained"]
        print(f"quad_probe {name}: device other {dev['a']['median']:.5f} ms (spread "
              f"{dev['a']['spread']:.5f}), this {dev['b']['median']:.5f} ms (spread "
              f"{dev['b']['spread']:.5f}); chained other {chn['a']['median']:.5f} (spread "
              f"{chn['a']['spread']:.5f}), this {chn['b']['median']:.5f} (spread "
              f"{chn['b']['spread']:.5f}); elements bitwise equal: probe input "
              f"{res['bitwise']['probe']:.4%}, special input {res['bitwise']['special']:.4%}; "
              f"readings device {dev['a']['ms']} / {dev['b']['ms']} (kernels the profiler kept of "
              f"64: {kept['a']} / {kept['b']}), chained {chn['a']['ms']} / {chn['b']['ms']}")
    for side in ("a", "b"):
        f32, bf16 = (rows[t]["device"][side]["median"] for t in ("float32", "bfloat16"))
        print(f"bf16 / f32 throughput on the device, {'other' if side == 'a' else 'this'}: "
              f"{f32 / bf16:.3f}x")
    return rows


def host_ms(fn, reps: int) -> float:
    """Milliseconds per call of fn() by the host clock around `reps` calls
    and a synchronize, after one warm-up call."""
    import time

    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def dynamic_rows(other: dict, this: dict, event_ms, kernel_ms) -> dict:
    """The dynamic nee render of both trees, the other tree's table kernel,
    and this tree's in-launch table against a table built once."""
    import torch

    rows = {}
    for scene, desc in (("cornell_box", ("cornell_box",)), ("sphere_grid(512)", ("sphere_grid", 512))):
        def tables_of(tree):
            lib = tree["scene.library"]
            return tree["scene.compile"].compile_scene(getattr(lib, desc[0])(*desc[1:]), device="cuda")

        def render(tree):
            tables, key = tables_of(tree), tree["rng"].key_row(SEED)

            def run():
                return sum(tree["ops.megakernel"].render_chunk_dynamic(
                    tables, key, o, width=512, height=512, spp_chunk=32, spp_total=256,
                    max_depth=64, sampler="sobol", mode="nee") for o in range(0, 256, 32))
            return run

        a, b = render(other), render(this)
        res = {"wall": summary(turns(a, b, ROUNDS, 3, host_ms))}
        res["bitwise_pixels"] = (a() == b()).all(-1).double().mean().item()
        t_other, t_this = tables_of(other), tables_of(this)
        res["table_kernel_ms"], res["table_kernel_kept"] = {}, {}
        for side, tree, tables in (("other", other, t_other), ("this", this, t_this)):
            res["table_kernel_ms"][side], res["table_kernel_kept"][side] = kernel_ms(
                lambda tree=tree, tables=tables: tree["ops.lights"].light_table_dyn(tables), 16,
                "light_table_dyn")
        prebuilt = this["ops.lights"].light_table_dyn(t_this)
        m, k0k1r = this["ops.megakernel"], this["rng"].key_row(SEED)

        def fed_chunk():
            return m.render_rays(t_this, k0k1r[0], k0k1r[1], 512, 512, 32, 0, 64, root=k0k1r[2],
                                 sampler="sobol", mode="nee", index_bits=m.index_bits_for(256),
                                 lights=prebuilt)

        in_launch = row_runner(this, "", True, "nee", "sobol", t_this)
        launches = 10 if scene == "cornell_box" else 4
        res["chunk"] = summary(turns(row_runner(other, "", True, "nee", "sobol", t_other),
                                     in_launch, ROUNDS, launches, event_ms))
        res["prologue"] = summary(turns(fed_chunk, in_launch, ROUNDS, launches, event_ms))
        res["prologue"]["bitwise"] = agreement(fed_chunk(), in_launch())["bitwise"]

        # The prologue alone: a launch of one ray is one block, its staging
        # (and build) and one path; device time by the profiler, in turns.
        def one_ray(dynamic):
            lights = this["ops.lights"].IN_LAUNCH if dynamic else prebuilt
            return lambda: m.render_rays(t_this, k0k1r[0], k0k1r[1], 1, 1, 1, 0, 64,
                                         root=k0k1r[2], sampler="sobol", mode="nee",
                                         index_bits=m.index_bits_for(256), lights=lights)

        kept = {"a": [], "b": []}
        fed_one, built_one = one_ray(False), one_ray(True)

        def device_ms(fn, n):
            ms, count = kernel_ms(fn, n, "megakernel")
            kept["a" if fn is fed_one else "b"].append(count)
            return ms

        res["one_ray"] = summary(turns(fed_one, built_one, ROUNDS, 64, device_ms))
        res["one_ray"]["kept"] = kept
        rows[scene] = res
        w, p, c = res["wall"], res["prologue"], res["chunk"]
        print(f"dynamic nee/sobol chunk (512x512, 32 spp) on {scene}: other "
              f"{c['a']['median']:.4f} ms (spread {c['a']['spread']:.4f}), this "
              f"{c['b']['median']:.4f} ms (spread {c['b']['spread']:.4f}); readings {c['a']['ms']} / "
              f"{c['b']['ms']}")
        print(f"render_chunk_dynamic nee/sobol {scene}, 512x512, 256 spp: wall other "
              f"{w['a']['median']:.3f} ms (spread {w['a']['spread']:.3f}), this "
              f"{w['b']['median']:.3f} ms (spread {w['b']['spread']:.3f}); pixels bitwise equal "
              f"{res['bitwise_pixels']:.4%}; table kernel on the device: other "
              f"{res['table_kernel_ms']['other']:.5f} ms, this {res['table_kernel_ms']['this']:.5f} "
              f"ms (kernels the profiler kept of 16: {res['table_kernel_kept']['other']} / "
              f"{res['table_kernel_kept']['this']}); this tree's chunk fed a table built once {p['a']['median']:.4f} ms (spread "
              f"{p['a']['spread']:.4f}) against the table built in the launch "
              f"{p['b']['median']:.4f} ms (spread {p['b']['spread']:.4f}), rays bitwise equal "
              f"{p['bitwise']:.4%}; readings {w['a']['ms']} / {w['b']['ms']}; {p['a']['ms']} / "
              f"{p['b']['ms']}")
        o = res["one_ray"]
        print(f"one-ray launch (one block) on {scene}, device time: K1's nee fed the table "
              f"{o['a']['median'] * 1e3:.2f} us (spread {o['a']['spread'] * 1e3:.2f}), the table "
              f"built in the launch {o['b']['median'] * 1e3:.2f} us (spread "
              f"{o['b']['spread'] * 1e3:.2f}); kernels the profiler kept of 64: {kept['a']} / "
              f"{kept['b']}; readings {o['a']['ms']} / {o['b']['ms']}")
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
    parser.add_argument("--parts", default=",".join(PARTS),
                        help=f"comma-separated, of {','.join(PARTS)} (all by default)")
    args = parser.parse_args()
    parts = args.parts.split(",")
    if not set(parts) <= set(PARTS):
        parser.error(f"--parts takes {PARTS}")
    if not torch.cuda.is_available():
        print("ab_render: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    this = {name: importlib.import_module(f"cornelis_tpu_torch.{name}") for name in MODULES}
    other = load_tree(os.path.abspath(args.other), "other_cornelis_tpu_torch")
    timing = this["utils.timing"]
    event_ms, kernel_ms = timing.event_ms, timing.kernel_ms
    card = timing.card_line()
    print(card)
    record = {"card": card, "rounds": ROUNDS}
    if "sass" in parts:
        print("== SASS of every kernel: other and this tree")
        record["sass"] = sass_rows(other, this)
    for tree in (other, this):
        tree["ops.build"].build_all()
        tree["ops.warm"].warm_kernels()

    runners = {}
    if "rows" in parts:
        print("== megakernel rows: other (a) and this tree (b), ms per launch")
        record["rows"] = {}
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

    if "dynamic" in parts:
        print("== dynamic nee render: other (a) and this tree (b)")
        record["dynamic"] = dynamic_rows(other, this, event_ms, kernel_ms)

    if "fma" in parts and runners:
        print("== nee rows: this tree (a) and its nee library without -fmad=false (b)")
        record["fma"] = {}
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
            if " nee/" not in name or name.startswith("dynamic"):
                continue
            launches = 4 if name.endswith("sdf") else 10
            res = summary(turns(run, with_fma(run), ROUNDS, launches, event_ms))
            res["agreement"] = agreement(run(), with_fma(run)())
            record["fma"][name] = res
            print(f"{name}: -fmad=false {res['a']['median']:.4f} ms (spread {res['a']['spread']:.4f}), "
                  f"contracted {res['b']['median']:.4f} ms (spread {res['b']['spread']:.4f}), "
                  f"ratio {res['b']['median'] / res['a']['median']:.3f}; rays bitwise equal "
                  f"{res['agreement']['bitwise']:.4%}, within 1e-4 {res['agreement']['within_1e-4']:.4%}")

    if "zero" in parts:
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

    if "probes" in parts:
        print("== scan probes: other (a) and this tree (b), ms per launch")
        record["probes"] = probe_rows(other, this, event_ms)
    if "quad" in parts:
        print("== K4: other (a) and this tree (b), ms per launch")
        record["quad"] = quad_rows(other, this, event_ms, kernel_ms)
    print(card)
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
