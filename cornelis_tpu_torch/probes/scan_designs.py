"""K4's, K5's and K6's designs timed against the kernels the probes launch.

    python -m cornelis_tpu_torch.probes.scan_designs [scan|quad]   # both by default

Builds each design from ops/csrc/probes.cu (its bodies, helpers and
kernel templates, with the probes library's nvcc flags), one library a
design, all at once, and times it on the probe input in turns with the
production kernel of its kind (production, design, design, production,
twice; CUDA events over 200 launches a reading, and for K4 also the
profiler's kernel time, as K4's launches are shorter than the host's). For
each it prints the medians and spreads, its registers, spill bytes and
SASS size, its launch shape, and whether its output equals the production
kernel's on every lane of the probe input and of the special input. The
scan designs:

- K5 scanning in windows: the block's threads scan W spheres, meet at a
  barrier and go on to the next window, so that its warps fetch the same
  code together;
- K5 with R rays a thread in fewer, larger blocks;
- K5 and K6 with nvcc's sqrtf in place of sqrt_disc, and with jnp.maximum's
  and jnp.minimum's NaN tests as well (the scan body the kernels had
  before sqrt_disc and fminf);
- K6 at other block sizes, rays a thread and unrollings.

The K4 designs (`QUAD_DESIGNS`): the production body with nvcc's sqrtf;
in bfloat16, both roots of a pair taken and masked by one bf16x2 compare;
and "disc", the production source with quad_root returning its disc, so
that each object's disc, not its root, is added to acc. The probe's roots
are all 0 (probes/bf16.py), so the production output, +0 on every input,
checks nothing of the chain; "disc" is held bit for bit to
`disc_sum_reference`, the plain version's chain summing disc, and
`quad_root_difference` checks that its SASS is the production kernel's
but for the root. (Two and four lanes a thread, and the parent's body,
were measured once and are in PERF.md §6; `ab_render.py` times the parent
from its `git archive`.)

Prints the card's name and power limit first and a JSON record last.
"""

from __future__ import annotations

import ctypes
import json
import re
import statistics
import subprocess
import sys
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from ..ops import build
from . import bf16
from . import scene_table as st

ROUNDS = 2
LAUNCHES = 200
# (kind, threads a block, rays a thread, spheres a window (K5) or a pass
# of the sphere loop (K6), scan body). K5's production design is
# (128, 1, 512); K6's (512, 2, 8).
DESIGNS = (
    ("baked", 128, 1, 512, "plain"),
    ("baked", 128, 1, 32, "plain"),
    ("baked", 384, 1, 64, "plain"),
    ("baked", 512, 1, 32, "plain"),
    ("baked", 512, 1, 64, "plain"),
    ("baked", 512, 1, 512, "plain"),
    ("baked", 1024, 1, 32, "plain"),
    ("baked", 128, 2, 512, "plain"),
    ("baked", 256, 2, 512, "plain"),
    ("baked", 256, 4, 512, "plain"),
    ("baked", 128, 1, 512, "sqrtf"),
    ("baked", 512, 1, 32, "sqrtf"),
    ("baked", 128, 1, 512, "nan-tests"),
    ("dynamic", 512, 2, 8, "plain"),
    ("dynamic", 512, 2, 4, "plain"),
    ("dynamic", 256, 2, 4, "plain"),
    ("dynamic", 128, 1, 4, "plain"),
    ("dynamic", 128, 4, 4, "plain"),
    ("dynamic", 64, 4, 4, "plain"),
    ("dynamic", 512, 2, 8, "sqrtf"),
    ("dynamic", 512, 2, 8, "nan-tests"),
)

# Scan bodies as substitutions in probes.cu: "sqrtf" takes nvcc's sqrtf
# (its range check branches to a slow path); "nan-tests" also puts back
# the NaN-propagating max and min of jnp.maximum and jnp.minimum.
BODIES = {
    "plain": (),
    "sqrtf": (("sqrt_disc(fmaxf(disc, 1e-12f))", "sqrtf(fmaxf(disc, 1e-12f))"),),
    "nan-tests": (
        ("sqrt_disc(fmaxf(disc, 1e-12f))", "sqrtf((disc != disc) ? disc : fmaxf(disc, 1e-12f))"),
        ("return fminf(best, t);",
         "return (best != best) ? best : ((t != t) ? t : fminf(best, t));"),
    ),
}

DESIGN_SRC = r"""
template <int N, int W, int R, int... Ws>
__device__ __forceinline__ void baked_windows(Rays<R>& rays, std::integer_sequence<int, Ws...>) {
  ((baked_spheres<Ws * W, R>(rays, std::make_integer_sequence<int, W>{}),
    W < N ? __syncthreads() : void()),
   ...);
}

template <int N, int BLK, int R, int W>
__global__ void __launch_bounds__(BLK)
scan_baked_design(const float* __restrict__ o, float* __restrict__ out, int n) {
  for (int base = blockIdx.x * BLK * R; base < n; base += gridDim.x * BLK * R) {
    Rays<R> rays(o, base, BLK, n);
    baked_windows<N, W>(rays, std::make_integer_sequence<int, N / W>{});
    rays.store(out, base, BLK, n);
  }
}

}  // namespace

extern "C" int design(const float* table, int n_obj, const float* o, float* out, int n,
                      int* shape, void* stream) {
  const auto kernel = @KERNEL@;
  cudaError_t err = scan_shape(kernel, @BLOCK@, @RAYS@, @PASS@, n, shape);
  if (err != cudaSuccess) return (int)err;
  kernel<<<shape[1], @BLOCK@, 0, (cudaStream_t)stream>>>(@ARGS@);
  return (int)cudaGetLastError();
}
"""


# (type, body) of the K4 designs. Production: "plain".
QUAD_DESIGNS = (
    ("float32", "plain"),
    ("float32", "sqrtf"),
    ("float32", "disc"),
    ("bfloat16", "plain"),
    ("bfloat16", "sqrtf"),
    ("bfloat16", "mask"),
    ("bfloat16", "disc"),
)
QUAD_ROOT = "  return d32 > 0.0f ? sqrt_disc(clamped) : 0.0f;"
QUAD_PAIR_ACC = """    acc = __hadd2(acc, __floats2bfloat162_rn(quad_root(__low2float(disc)),
                                             quad_root(__high2float(disc))));"""
QUAD_PAIR_MASKED = """    V roots = __floats2bfloat162_rn(sqrt_disc(fmaxf(__low2float(disc), 1e-12f)),
                                    sqrt_disc(fmaxf(__high2float(disc), 1e-12f)));
    *reinterpret_cast<unsigned*>(&roots) &= __hgt2_mask(disc, splat(0));
    acc = __hadd2(acc, roots);"""
QUAD_BODIES = {
    "plain": (),
    "sqrtf": ((QUAD_ROOT, "  return d32 > 0.0f ? sqrtf(clamped) : 0.0f;"),),
    "disc": ((QUAD_ROOT, "  return d32;"),),
    # bfloat16 pairs compared in one bf16x2 instruction: both roots taken,
    # packed, and masked to +0 where disc <= 0 (the same bits).
    "mask": ((QUAD_PAIR_ACC, QUAD_PAIR_MASKED),),
}
CXX_TYPES = {"float32": "float", "bfloat16": "__nv_bfloat16"}

QUAD_ENTRY_SRC = r"""
}  // namespace

extern "C" int design(const void* x, void* out, int n, int* shape, void* stream) {
  quad_shape<@T@>(n, shape);
  return quad_launch<@T@>(x, out, n, (cudaStream_t)stream);
}
"""


def design_name(kind: str, block: int, rays: int, pass_: int, body: str) -> str:
    return f"{kind}_{block}_{rays}_{pass_}_{body}"


def design_source(kind: str, block: int, rays: int, pass_: int, body: str) -> str:
    """probes.cu up to the end of its namespace, the body's substitutions
    made, then the design's kernel and its C entry `design`."""
    src = (build.CSRC / "probes.cu").read_text()
    head = src[: src.index("}  // namespace")]
    for old, new in BODIES[body]:
        if head.count(old) != 1:
            raise ValueError(f"probes.cu no longer holds {old!r} once")
        head = head.replace(old, new)
    if kind == "baked":
        kernel = f"scan_baked_design<{st.DEFAULT_N}, {block}, {rays}, {pass_}>"
        args = "o, out, n"
    else:
        kernel = f"scan_dynamic<{block}, {rays}, {pass_}>"
        args = "table, n_obj, o, out, n"
    tail = DESIGN_SRC
    for key, value in (("KERNEL", kernel), ("BLOCK", block), ("RAYS", rays), ("PASS", pass_),
                       ("ARGS", args)):
        tail = tail.replace(f"@{key}@", str(value))
    return head + tail


def quad_design_name(dtype: str, body: str) -> str:
    return f"quad_{dtype}_{body}"


def quad_design_source(dtype: str, body: str) -> str:
    """probes.cu up to the end of its namespace, the body's substitutions
    made, then the design's C entry `design`."""
    src = (build.CSRC / "probes.cu").read_text()
    head = src[: src.index("}  // namespace")]
    for old, new in QUAD_BODIES[body]:
        if head.count(old) != 1:
            raise ValueError(f"probes.cu no longer holds {old!r} once")
        head = head.replace(old, new)
    return head + QUAD_ENTRY_SRC.replace("@T@", CXX_TYPES[dtype])


def quad_kernel(dtype: str, _body: str = "plain") -> str:
    """The part of K4's mangled name that tells its type apart."""
    return "quad_probeI" + ("f" if dtype == "float32" else "13__nv_bfloat16") + "E"


def _scan_kernel(kind: str, block: int, rays: int, pass_: int, _body: str) -> str:
    args = ((st.DEFAULT_N,) if kind == "baked" else ()) + (block, rays, pass_)
    return ("scan_baked_design" if kind == "baked" else "scan_dynamic") + "I" + "".join(
        f"Li{a}E" for a in args)


def build_design(spec) -> dict:
    """Compile one design (a scan spec of DESIGNS or a K4 spec of
    QUAD_DESIGNS) into its own library; its ptxas report and SASS size."""
    quad = spec[0] in CXX_TYPES
    name = quad_design_name(*spec) if quad else design_name(*spec)
    out_dir = build.BUILD_DIR / "designs"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu, so = out_dir / f"{name}.cu", out_dir / f"lib{name}.so"
    cu.write_text(quad_design_source(*spec) if quad else design_source(*spec))
    flags = build.NVCC_FLAGS + build.EXTRA_FLAGS["probes"] + ("-I", str(build.CSRC))
    proc = subprocess.run([build._nvcc(), *flags, "-o", str(so), str(cu)], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}:\n{proc.stderr}")
    # The design's kernel by its mangled name and template arguments.
    kernel = quad_kernel(*spec) if quad else _scan_kernel(*spec)
    entry = re.search(rf"Compiling entry function '[^']*{kernel}[^']*'(.*?)(?:Compiling entry|\Z)",
                      proc.stdout + proc.stderr, re.S).group(1)
    regs = re.search(r"Used (\d+) registers", entry)
    spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", entry)
    opcodes = sass_opcodes(so, kernel)
    return {"name": name, "so": str(so), "registers": int(regs.group(1)),
            "spill_bytes": int(spill.group(1)) + int(spill.group(2)),
            "sass": sum(opcodes.values()), "opcodes": dict(opcodes.most_common())}


def sass_opcodes(so, kernel: str) -> Counter:
    """{opcode: count} of the kernel whose mangled name holds `kernel` in
    the library `so`, by cuobjdump (empty where the toolkit lacks it)."""
    cuobjdump = Path(build._nvcc()).parent / "cuobjdump"
    opcodes, current = Counter(), False
    if cuobjdump.exists():
        out = subprocess.run([str(cuobjdump), "-sass", str(so)], capture_output=True, text=True).stdout
        for line in out.splitlines():
            if "Function : " in line:
                current = kernel in line
            elif current:
                ins = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)", line)
                if ins:
                    opcodes[ins.group(1)] += 1
    return opcodes


def quad_root_difference(production: dict, disc: dict, steps: int) -> list:
    """What sets the SASS of K4's production kernel apart from its "disc"
    design's other than quad_root, as a list of findings (empty: nothing).
    `steps` is the (element, object) steps of one thread. The chain must be
    the same: as many FADD (float32 sums), bfloat16 pair operations (every
    opcode on BF16_V2) and float32-to-bfloat16 packs (F2FP) in both. The
    root must be the whole difference in arithmetic: per step one
    MUFU.RSQ, one FMNMX and one FSETP (the compare), two FFMA and two
    FMUL (sqrt_disc's Newton step) in production, and none of the first
    four in "disc", so that no FFMA stands anywhere in the chain."""
    prod, dsc = Counter(production), Counter(disc)

    def total(c, test):
        return sum(n for op, n in c.items() if test(op))

    groups = {"FADD": lambda op: op == "FADD", "BF16_V2": lambda op: "BF16_V2" in op,
              "F2FP": lambda op: op.startswith("F2FP")}
    found = [f"{name}: production {total(prod, test)}, disc {total(dsc, test)}"
             for name, test in groups.items() if total(prod, test) != total(dsc, test)]
    root = {"MUFU.RSQ": lambda op: op == "MUFU.RSQ", "FMNMX": lambda op: op == "FMNMX",
            "FSETP": lambda op: op.startswith("FSETP"), "FFMA": lambda op: op == "FFMA"}
    for name, test in root.items():
        want = steps * (2 if name == "FFMA" else 1)
        if total(prod, test) != want or total(dsc, test) != 0:
            found.append(f"{name}: production {total(prod, test)} (want {want}), disc "
                         f"{total(dsc, test)} (want 0)")
    if prod["FMUL"] - dsc["FMUL"] != 2 * steps:
        found.append(f"FMUL: production {prod['FMUL']}, disc {dsc['FMUL']} (want {2 * steps} "
                     "more in production)")
    return found


def disc_sum_reference(x: torch.Tensor) -> torch.Tensor:
    """The plain version of K4's chain with each object's disc, not its
    root, added to acc (the "disc" design's function)."""
    const = lambda v: torch.tensor(v, dtype=torch.float32, device=x.device).to(x.dtype)  # noqa: E731
    acc = torch.zeros_like(x)
    for c, d, k in bf16.consts():
        cj, dj, kj = const(c), const(d), const(k)
        b = x * cj + dj
        acc = acc + (b * b - (x * x - (cj + cj) * x + kj))
    return acc


def quad_runner(info: dict):
    """A call of the K4 design built as `info`: x -> (out, launch shape)."""
    fn = ctypes.CDLL(info["so"]).design
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    shape = (ctypes.c_int * 3)()

    def run(x):
        out = torch.empty_like(x)
        build.launch(fn, x.device, x.data_ptr(), out.data_ptr(), x.numel(), shape)
        return out

    return run, shape


def _scan_rows(specs, built, readings_of) -> list:
    inputs = {"probe": st.probe_input("cuda"), "special": st.special_input("cuda")}
    tab = st.table(st.DEFAULT_N, "cuda")
    production = {"baked": lambda o: st.scan_baked(o, st.DEFAULT_N),
                  "dynamic": lambda o: st.scan_dynamic(o, tab)}
    p, i = ctypes.c_void_p, ctypes.c_int
    rows = []
    for spec, info in zip(specs, built):
        fn = ctypes.CDLL(info["so"]).design
        fn.argtypes = [p, i, p, p, i, p, p]
        shape = (ctypes.c_int * 4)()

        def run(o, fn=fn, shape=shape):
            out = torch.empty_like(o)
            build.launch(fn, o.device, tab.data_ptr(), tab.shape[0], o.data_ptr(), out.data_ptr(),
                         o.numel(), shape)
            return out

        o = inputs["probe"]
        row = {**info, "kind": spec[0], "block": spec[1], "rays_per_thread": spec[2],
               "spheres_per_pass": spec[3], "body": spec[4],
               **readings_of(lambda: production[spec[0]](o), lambda: run(o))}
        row["blocks"] = shape[1]
        row["bitwise"] = {name: bool(torch.equal(run(x), production[spec[0]](x)))
                          for name, x in inputs.items()}
        rows.append(row)
        print(f"{info['name']}: {row['blocks']} blocks; {info['registers']} registers, "
              f"{info['spill_bytes']} B spilled, {info['sass']} SASS instructions; design "
              f"{row['design']['median']:.4f} ms (spread {row['design']['spread']:.4f}), production "
              f"{row['production']['median']:.4f} ms (spread {row['production']['spread']:.4f}), "
              f"ratio {row['design']['median'] / row['production']['median']:.3f}; bitwise equal "
              f"to production: {row['bitwise']}", flush=True)
    return rows


def _quad_rows(specs, built, readings_of) -> list:
    from ..utils.timing import kernel_ms

    probes_so = build.build_library("probes")
    rows = []
    for spec, info in zip(specs, built):
        dtype_name, body = spec
        dtype = getattr(torch, dtype_name)
        inputs = {"probe": bf16.probe_input(dtype, "cuda"), "special": bf16.special_input(dtype, "cuda")}
        run, shape = quad_runner(info)
        x = inputs["probe"]
        row = {**info, "kind": "quad", "dtype": dtype_name, "body": body,
               **readings_of(lambda: bf16.quad_probe(x), lambda: run(x))}
        row["device_ms"], row["device_kept"] = {}, {}
        for side, fn in (("production", lambda: bf16.quad_probe(x)), ("design", lambda: run(x))):
            row["device_ms"][side], row["device_kept"][side] = kernel_ms(fn, 64, "quad_probe")
        row.update(block=shape[0], blocks=shape[1], elements_per_thread=shape[2])
        want = disc_sum_reference if body == "disc" else bf16.quad_probe
        bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
        row["bitwise"] = {name: bool(torch.equal(run(x).view(bits), want(x).view(bits)))
                          for name, x in inputs.items()}
        if body == "disc":
            row["root_difference"] = quad_root_difference(
                sass_opcodes(probes_so, quad_kernel(dtype_name)), info["opcodes"],
                bf16.OBJECTS * shape[2])
        rows.append(row)
        print(f"{info['name']}: {shape[1]} blocks of {shape[0]}, {shape[2]} elements a thread; "
              f"{info['registers']} registers, {info['spill_bytes']} B spilled, {info['sass']} SASS "
              f"instructions; device {row['device_ms']['design']:.5f} ms against production "
              f"{row['device_ms']['production']:.5f} (profiler, kernels kept of 64: "
              f"{row['device_kept']['design']} / {row['device_kept']['production']}); chained "
              f"{row['design']['median']:.5f} ms (spread {row['design']['spread']:.5f}) against "
              f"{row['production']['median']:.5f} (spread {row['production']['spread']:.5f}); "
              f"bitwise equal to {'disc_sum_reference' if body == 'disc' else 'production'}: "
              f"{row['bitwise']}"
              + (f"; SASS apart from production's but for the root: {row['root_difference'] or 'nothing'}"
                 if body == "disc" else "")
              + f"; SASS by opcode {info['opcodes']}", flush=True)
    return rows


def main(argv=None) -> int:
    from ..utils.timing import card_line, event_ms

    argv = sys.argv[1:] if argv is None else argv
    kinds = argv or ["scan", "quad"]
    if not torch.cuda.is_available():
        print("scan_designs: no CUDA device", file=sys.stderr)
        return 1
    card = card_line()
    print(card, flush=True)
    specs = {"scan": DESIGNS if "scan" in kinds else (),
             "quad": QUAD_DESIGNS if "quad" in kinds else ()}
    def try_build(spec):
        try:
            return build_design(spec)
        except RuntimeError as err:  # a design nvcc refuses is reported, not timed
            print(f"{spec}: {err}", flush=True)
            return None

    with ThreadPoolExecutor(8) as pool:
        built = {kind: list(pool.map(try_build, s)) for kind, s in specs.items()}
    specs = {kind: [spec for spec, info in zip(s, built[kind]) if info] for kind, s in specs.items()}
    built = {kind: [info for info in infos if info] for kind, infos in built.items()}

    def readings_of(production, design) -> dict:
        readings = {"production": [], "design": []}
        for _ in range(ROUNDS):
            for side in ("production", "design", "design", "production"):
                readings[side].append(event_ms(production if side == "production" else design,
                                               LAUNCHES))
        return {side: {"ms": ms, "median": statistics.median(ms), "spread": max(ms) - min(ms)}
                for side, ms in readings.items()}

    record = {"card": card, "rounds": ROUNDS, "launches": LAUNCHES,
              "designs": _scan_rows(specs["scan"], built["scan"], readings_of)
              + _quad_rows(specs["quad"], built["quad"], readings_of)}
    print(card)
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
