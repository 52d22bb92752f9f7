"""Native C++ host runtime: build and ctypes bindings.

Counterpart of `cornelis_tpu/native/__init__.py`, over the port's own copy
of the C++ (cornelis_native.cpp). The reference's image-output runtime is
native (vendored stb_image_write C, src/Render.cpp:257-265); this one is
compiled with g++ at first use into `cornelis_tpu_torch/_build/` and
loaded with ctypes under an ABI version check. Everything here degrades
gracefully: without a compiler or zlib, `load()` returns None and the
callers (film.py) fall back to the pure-Python paths.

Set CORNELIS_NO_NATIVE=1 to force the pure-Python fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from typing import Optional

import numpy as np

_SRC = os.path.join(os.path.dirname(__file__), "cornelis_native.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "_build")
_ABI_VERSION = 1
# No -march=native: the library may be built on one host and loaded on
# another that shares the checkout.
_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-Wall", "-Wextra")

_lib: Optional[ctypes.CDLL] = None
_load_attempted = False


def _source_tag() -> str:
    with open(_SRC, "rb") as f:
        return hashlib.sha256(f.read() + " ".join(_FLAGS).encode()).hexdigest()[:16]


def build(verbose: bool = False) -> Optional[str]:
    """Compile the shared library if needed; returns its path or None."""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    out = os.path.join(_BUILD_DIR, f"libcornelis_native_{_source_tag()}.so")
    if os.path.exists(out):
        return out
    # A name of its own per build, moved into place: concurrent builds (test
    # workers) never read or clobber a partial library.
    fd, tmp = tempfile.mkstemp(suffix=".so.tmp", dir=_BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(["g++", *_FLAGS, _SRC, "-o", tmp, "-lz"], capture_output=True,
                              text=True, timeout=120)
        if proc.returncode != 0:
            if verbose:
                print(proc.stderr)
            return None
        os.replace(tmp, out)
    except (OSError, subprocess.TimeoutExpired):
        return None
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.cn_abi_version.argtypes = []
    lib.cn_abi_version.restype = ctypes.c_int
    lib.cn_srgb_quantize.argtypes = [f32p, u8p, ctypes.c_int64, ctypes.c_int]
    lib.cn_srgb_quantize.restype = None
    lib.cn_accumulate.argtypes = [f32p, f32p, ctypes.c_int64]
    lib.cn_accumulate.restype = None
    lib.cn_film_average.argtypes = [f32p, f32p, ctypes.c_int64, ctypes.c_double]
    lib.cn_film_average.restype = None
    lib.cn_encode_png_size.argtypes = [u8p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int]
    lib.cn_encode_png_size.restype = ctypes.c_int64
    lib.cn_encode_png.argtypes = [u8p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int, u8p,
                                  ctypes.c_int64]
    lib.cn_encode_png.restype = ctypes.c_int64
    lib.cn_write_png.argtypes = [ctypes.c_char_p, u8p, ctypes.c_int32, ctypes.c_int32,
                                 ctypes.c_int]
    lib.cn_write_png.restype = ctypes.c_int
    return lib


def load() -> Optional[ctypes.CDLL]:
    """Build (if needed) and load the native library, or None on failure."""
    global _lib, _load_attempted
    if os.environ.get("CORNELIS_NO_NATIVE"):
        return None
    if _lib is not None or _load_attempted:
        return _lib
    _load_attempted = True
    path = build()
    if path is None:
        return None
    try:
        lib = _bind(ctypes.CDLL(path))
        if lib.cn_abi_version() != _ABI_VERSION:
            return None
    except OSError:
        return None
    _lib = lib
    return _lib


def available() -> bool:
    return load() is not None


# -- numpy-facing wrappers ---------------------------------------------------


def _u8(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _f32(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _rgb8(image: np.ndarray, what: str) -> np.ndarray:
    img = np.ascontiguousarray(image, dtype=np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"{what} expects an (H, W, 3) uint8 array.")
    return img


def srgb_quantize(linear: np.ndarray, standard: bool = False) -> Optional[np.ndarray]:
    """Linear float RGB -> sRGB uint8 via the native path, or None."""
    lib = load()
    if lib is None:
        return None
    src = np.ascontiguousarray(linear, dtype=np.float32)
    out = np.empty(src.shape, np.uint8)
    lib.cn_srgb_quantize(_f32(src), _u8(out), src.size, 1 if standard else 0)
    return out


def accumulate(dst: np.ndarray, src: np.ndarray) -> bool:
    """dst += src in place (both float32, C-contiguous); False -> the
    caller falls back to numpy."""
    lib = load()
    if lib is None:
        return False
    if dst.dtype != np.float32 or not dst.flags.c_contiguous or dst.shape != src.shape:
        return False
    s = np.ascontiguousarray(src, dtype=np.float32)
    lib.cn_accumulate(_f32(dst), _f32(s), dst.size)
    return True


def encode_png(image: np.ndarray, compress_level: int = 6) -> Optional[bytes]:
    """Encode (H, W, 3) uint8 RGB to PNG bytes via the native encoder."""
    lib = load()
    if lib is None:
        return None
    img = _rgb8(image, "encode_png")
    h, w, _ = img.shape
    size = lib.cn_encode_png_size(_u8(img), w, h, compress_level)
    if size < 0:
        return None
    buf = np.empty(size, np.uint8)
    if lib.cn_encode_png(_u8(img), w, h, compress_level, _u8(buf), size) != size:
        return None
    return buf.tobytes()


def write_png(path: str, image: np.ndarray, compress_level: int = 6) -> bool:
    """Write a PNG via the native encoder; False -> the caller falls back."""
    lib = load()
    if lib is None:
        return False
    img = _rgb8(image, "write_png")
    h, w, _ = img.shape
    # A temp file in the target directory, renamed into place: a failed
    # encode never leaves a truncated PNG behind.
    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(suffix=".png.tmp", dir=d)
    os.close(fd)
    if lib.cn_write_png(tmp.encode(), _u8(img), w, h, compress_level) != 0:
        os.unlink(tmp)
        return False
    os.replace(tmp, path)
    return True
