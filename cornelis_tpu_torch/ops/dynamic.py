"""The dynamic-scene render: one chunk with the light table built on the device.

Counterpart of `cornelis_tpu/ops/pallas_dynamic.py::render_chunk_pallas_dynamic`
(K3). On the TPU that was a second kernel: the baked megakernel took the
scene as literals, so a kernel that read the tables as operands had to be
written apart, with the NEE light table built inside it from the traced
tables. The port's megakernel already reads every table as an operand, so
K3 here is the same CUDA bounce loop (ops/csrc/megakernel.cu) fed by the
light table and clamp base that `lights.light_table_dyn` builds on the
device: every sphere and plane a row, in float32. An edit of the tables in
place (a new emission, a moved sphere) re-renders with no rebuild and no
host round trip.

Like the JAX function (pallas_dynamic.py:591-595), it takes no SDFs:
tables with SDF rows raise NotImplementedError. Render such scenes with
`render_chunk` (K1's SDF instantiations).
"""

from __future__ import annotations

import torch

from ..scene.compile import SceneTables
from . import lights as L
from .megakernel import render_chunk


def render_chunk_dynamic(
    tables: SceneTables,
    key: tuple,
    sample_offset: int,
    *,
    width: int,
    height: int,
    spp_chunk: int,
    spp_total: int,
    max_depth: int,
    sampler: str = "uniform",
    mode: str = "path",
) -> torch.Tensor:
    """(H, W, 3) radiance sums over one chunk of samples per pixel. In mode
    "nee" the light table and clamp base come from the tables on their own
    device (K3 takes no clamp override); a scene with no sphere and no
    plane then raises ValueError, and one with SDFs NotImplementedError."""
    if tables.sdfs.shape[0]:
        raise NotImplementedError(
            "the dynamic-scene render takes no SDF primitives (as "
            "cornelis_tpu's render_chunk_pallas_dynamic); use render_chunk"
        )
    return render_chunk(
        tables, key, sample_offset, width=width, height=height, spp_chunk=spp_chunk,
        spp_total=spp_total, max_depth=max_depth, sampler=sampler, mode=mode,
        lights=L.light_table_dyn(tables) if mode == "nee" else None,
    )
