"""Film: the accumulating framebuffer, tonemap to sRGB, PNG output and
checkpoints.

Counterpart of `cornelis_tpu/film.py` (FrameBuffer.hpp,
src/Render.cpp:257-265): linear radiance sums and a sample count on the
host; the estimate is sum / count. Checkpoints use the JAX package's npz
keys, so a checkpoint written by either package resumes in the other.

Each host step keeps the port's own implementation, numpy's accumulate,
torch's tonemap on the host and the Python PNG encoder: the native host
runtime (native/) has each step too (its tonemap within one 8-bit count,
its PNG bytes equal), and the card's host measured none of them faster
where a render repeats (`chip_smoke.py` phase 8g; PERF.md section 5 has
the runs). Its accumulate was slower in every run. Its one-thread
tonemap took 11-14 ms where torch's took 2.0-6.3 ms in five runs of six
(21.3 in the sixth); only a process's first tonemap, which pays for
torch's thread pool, went to the native one in three runs of four, by
1-21 ms against a process start of seconds. Its PNG writer (the same
zlib, so the same bytes) had medians above the Python encoder's in every
warm run, and within 3 ms of it either way cold.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from .math import color as _color
from .utils import png as _png
from .utils import trace


class Film:
    """Accumulating framebuffer: linear radiance sums + sample count."""

    def __init__(self, width: int, height: int):
        if width <= 0 or height <= 0:
            raise ValueError("Film dimensions must be positive.")
        self.width = width
        self.height = height
        self.radiance_sum = np.zeros((height, width, 3), np.float32)
        self.sample_count = 0

    @property
    def aspect(self) -> float:
        """width / height (FrameBuffer.hpp:83-86)."""
        return self.width / self.height

    def add_samples(self, chunk_sum, num_samples: int) -> None:
        """Accumulate (H, W, 3) per-pixel radiance sums over `num_samples`
        spp, from a tensor on any device or a numpy array."""
        if torch.is_tensor(chunk_sum):
            chunk_sum = chunk_sum.detach().cpu().numpy()
        self.radiance_sum += np.asarray(chunk_sum, np.float32)
        self.sample_count += num_samples

    def image(self) -> np.ndarray:
        """Current linear-RGB estimate: sum / count (Render.cpp:245-251)."""
        if self.sample_count == 0:
            return np.zeros_like(self.radiance_sum)
        return self.radiance_sum / self.sample_count

    def to_srgb8(self, standard_srgb: bool = False) -> np.ndarray:
        """Linear -> sRGB (the reference's 12.95 slope, or 12.92 with
        `standard_srgb`) -> 8-bit (Render.cpp:257-265)."""
        with trace.span("ct.film.tonemap"):
            encoded = _color.srgb_encode(torch.from_numpy(self.image()), standard=standard_srgb)
            return _color.quantize_to_8bit(encoded).numpy()

    def save_png(self, path: str, standard_srgb: bool = False) -> None:
        _png.write_png(path, self.to_srgb8(standard_srgb=standard_srgb))

    # -- checkpoint / resume ------------------------------------------------
    def save_checkpoint(self, path: str, next_sample: int = 0, seed: int = 0) -> None:
        """Persist the accumulation state; progressive renders resume from
        it. Written to a temporary file and renamed into place."""
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            np.savez(
                f,
                radiance_sum=self.radiance_sum,
                sample_count=np.int64(self.sample_count),
                next_sample=np.int64(next_sample),
                seed=np.int64(seed),
            )
        os.replace(tmp, path)

    @staticmethod
    def load_checkpoint(path: str) -> tuple["Film", int, int]:
        """Returns (film, next_sample, seed)."""
        with np.load(path) as data:
            s = data["radiance_sum"]
            film = Film(s.shape[1], s.shape[0])
            film.radiance_sum = s.astype(np.float32)
            film.sample_count = int(data["sample_count"])
            return film, int(data["next_sample"]), int(data["seed"])


def mse(a: np.ndarray, b: np.ndarray) -> float:
    """Mean squared error between two images (golden-test helper)."""
    return float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))


def load_image_linear(path: str, standard_srgb: bool = False) -> Optional[np.ndarray]:
    """Load a PNG back into linear RGB floats (inverse of save_png)."""
    srgb8 = _png.read_png(path).astype(np.float32) / 255.0
    return _color.srgb_decode(torch.from_numpy(srgb8), standard=standard_srgb).numpy()
