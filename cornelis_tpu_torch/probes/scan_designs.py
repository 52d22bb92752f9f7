"""K5's and K6's designs timed against the kernels the probe launches.

    python -m cornelis_tpu_torch.probes.scan_designs

Builds each design from ops/csrc/probes.cu (its scan body, helpers and
kernel templates, with the probes library's nvcc flags), one library a
design, all at once, and times it on the probe input in turns with the
production kernel of its kind (production, design, design, production,
twice; CUDA events over 200 launches a reading). For each it prints the
medians and spreads, its registers, spill bytes and SASS size, its launch
shape, and whether its output equals the production kernel's on every
lane of the probe input and of the special lanes. The designs:

- K5 scanning in windows: the block's threads scan W spheres, meet at a
  barrier and go on to the next window, so that its warps fetch the same
  code together;
- K5 with R rays a thread in fewer, larger blocks;
- K5 and K6 with nvcc's sqrtf in place of sqrt_disc, and with jnp.maximum's
  and jnp.minimum's NaN tests as well (the scan body the kernels had
  before sqrt_disc and fminf);
- K6 at other block sizes, rays a thread and unrollings.

Prints the card's name and power limit first and a JSON record last.
"""

from __future__ import annotations

import ctypes
import json
import re
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from ..ops import build
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
        ("sqrt_disc(fmaxf(disc, 1e-12f))", "sqrtf(jmax(disc, 1e-12f))"),
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


def build_design(spec) -> dict:
    """Compile one design into its own library; its ptxas report and SASS
    size."""
    name = design_name(*spec)
    out_dir = build.BUILD_DIR / "designs"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu, so = out_dir / f"{name}.cu", out_dir / f"lib{name}.so"
    cu.write_text(design_source(*spec))
    flags = build.NVCC_FLAGS + build.EXTRA_FLAGS["probes"]
    proc = subprocess.run([build._nvcc(), *flags, "-o", str(so), str(cu)], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}:\n{proc.stderr}")
    # The design's kernel by its mangled name and template arguments.
    kind, block, rays, pass_, _ = spec
    args = ((st.DEFAULT_N,) if kind == "baked" else ()) + (block, rays, pass_)
    kernel = ("scan_baked_design" if kind == "baked" else "scan_dynamic") + "I" + "".join(
        f"Li{a}E" for a in args)
    entry = re.search(rf"Compiling entry function '[^']*{kernel}[^']*'(.*?)(?:Compiling entry|\Z)",
                      proc.stdout + proc.stderr, re.S).group(1)
    regs = re.search(r"Used (\d+) registers", entry)
    spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", entry)
    cuobjdump = Path(build._nvcc()).parent / "cuobjdump"
    sass, current = 0, False
    if cuobjdump.exists():
        out = subprocess.run([str(cuobjdump), "-sass", str(so)], capture_output=True, text=True).stdout
        for line in out.splitlines():
            if "Function : " in line:
                current = kernel in line
            elif current and re.match(r"\s+/\*[0-9a-f]{4,}\*/", line):
                sass += 1
    return {"name": name, "so": str(so), "registers": int(regs.group(1)),
            "spill_bytes": int(spill.group(1)) + int(spill.group(2)), "sass": sass}


def main() -> int:
    from ..utils.timing import card_line, event_ms

    if not torch.cuda.is_available():
        print("scan_designs: no CUDA device", file=sys.stderr)
        return 1
    card = card_line()
    print(card, flush=True)
    with ThreadPoolExecutor(8) as pool:
        built = list(pool.map(build_design, DESIGNS))
    inputs = {"probe": st.probe_input("cuda"), "special": st.special_input("cuda")}
    tab = st.table(st.DEFAULT_N, "cuda")
    production = {"baked": lambda o: st.scan_baked(o, st.DEFAULT_N),
                  "dynamic": lambda o: st.scan_dynamic(o, tab)}
    p, i = ctypes.c_void_p, ctypes.c_int
    record = {"card": card, "rounds": ROUNDS, "launches": LAUNCHES, "designs": []}
    for spec, info in zip(DESIGNS, built):
        fn = ctypes.CDLL(info["so"]).design
        fn.argtypes = [p, i, p, p, i, p, p]
        shape = (ctypes.c_int * 4)()

        def run(o, fn=fn, shape=shape):
            out = torch.empty_like(o)
            build.launch(fn, o.device, tab.data_ptr(), tab.shape[0], o.data_ptr(), out.data_ptr(),
                         o.numel(), shape)
            return out

        o = inputs["probe"]
        readings = {"production": [], "design": []}
        for _ in range(ROUNDS):
            for side in ("production", "design", "design", "production"):
                call = (lambda: production[spec[0]](o)) if side == "production" else (lambda: run(o))
                readings[side].append(event_ms(call, LAUNCHES))
        row = {**info, "kind": spec[0], "block": spec[1], "rays_per_thread": spec[2],
               "spheres_per_pass": spec[3], "body": spec[4], "blocks": shape[1]}
        for side, ms in readings.items():
            row[side] = {"ms": ms, "median": statistics.median(ms), "spread": max(ms) - min(ms)}
        row["bitwise"] = {name: bool(torch.equal(run(x), production[spec[0]](x)))
                          for name, x in inputs.items()}
        record["designs"].append(row)
        print(f"{info['name']}: {row['blocks']} blocks; {info['registers']} registers, "
              f"{info['spill_bytes']} B spilled, {info['sass']} SASS instructions; design "
              f"{row['design']['median']:.4f} ms (spread {row['design']['spread']:.4f}), production "
              f"{row['production']['median']:.4f} ms (spread {row['production']['spread']:.4f}), "
              f"ratio {row['design']['median'] / row['production']['median']:.3f}; bitwise equal "
              f"to production: {row['bitwise']}", flush=True)
    print(card)
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
