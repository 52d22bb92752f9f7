"""Build the CUDA sources under ops/csrc/ into shared libraries at first use.

Each `.cu` file has a plain C interface and is compiled by nvcc alone (no
PyTorch headers, so a build takes seconds), then loaded with ctypes. The
library's file name carries a hash of the sources under csrc/ and the
flags, so an edited source builds anew; it is written to a temporary name and moved
into place, so a concurrent or interrupted build never leaves a partial
library behind. Without nvcc, or when nvcc fails, this raises. `launch`
is the one path from a wrapper to a C entry point.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"

# No --use_fast_math: IEEE division and sqrt and the accurate sinf/cosf are
# the nvcc defaults and the parity bar assumes them. nvcc still contracts
# a*b+c into FMA by default.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)
# Flags of one library beyond NVCC_FLAGS. The NEE instantiations and the
# probes round every product and sum on its own, as their plain torch
# versions do (the reasons are in csrc/megakernel.cu and csrc/probes.cu).
EXTRA_FLAGS = {"megakernel_nee": ("-fmad=false",), "probes": ("-fmad=false",)}
# The libraries the port's kernels live in, in csrc/<name>.cu.
LIBRARIES = ("megakernel", "megakernel_nee", "lights", "warm", "probes", "draws")

# nvcc's output (the ptxas register and spill report) of the builds made
# by this process, by source name.
BUILD_LOGS: dict = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def build_library(name: str, force: bool = False) -> Path:
    """Compile csrc/<name>.cu unless its library exists (or `force`)."""
    src = CSRC / f"{name}.cu"
    flags = NVCC_FLAGS + EXTRA_FLAGS.get(name, ())
    digest = hashlib.sha256(" ".join(flags).encode())
    for path in sorted(CSRC.iterdir()):  # a source may include another
        digest.update(path.name.encode() + path.read_bytes())
    so = BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"
    if so.exists() and not force:
        return so
    so.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=so.parent, prefix=f".{name}-", suffix=".so")
    os.close(fd)
    try:
        proc = subprocess.run(
            [_nvcc(), *flags, "-o", tmp, str(src)],
            capture_output=True,
            text=True,
        )
        BUILD_LOGS[name] = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}.cu:\n{proc.stderr}")
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return so


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    return ctypes.CDLL(str(build_library(name)))


def build_all(force: bool = False) -> dict:
    """Build every library at once, one nvcc each, in parallel; returns
    {name: (library path, seconds)}. Raises if any build fails."""
    import time
    from concurrent.futures import ThreadPoolExecutor

    def one(name):
        t0 = time.perf_counter()
        return build_library(name, force), time.perf_counter() - t0

    with ThreadPoolExecutor(len(LIBRARIES)) as pool:
        futures = {name: pool.submit(one, name) for name in LIBRARIES}
        return {name: f.result() for name, f in futures.items()}


def launch(fn, device: torch.device, *args) -> None:
    """Call the C entry `fn` with `args` and the current stream of the CUDA
    `device` (the current device where it has no index), switching the
    current device only when it is another; raise on a CUDA error. One
    ctypes call: the raw stream comes from torch without a Stream object."""
    index = device.index
    if index is None or index == torch._C._cuda_getDevice():
        err = fn(*args, torch._C._cuda_getCurrentRawStream(-1 if index is None else index))
    else:
        with torch.cuda.device(index):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    if err != 0:
        raise RuntimeError(f"{fn.__name__} failed with CUDA error {err}")
