"""The dynamic-scene render: one chunk with K3's light table built on the device.

Counterpart of `cornelis_tpu/ops/pallas_dynamic.py::render_chunk_pallas_dynamic`
(K3). On the TPU that was a second kernel: the baked megakernel took the
scene as literals, so a kernel that read the tables as operands had to be
written apart, with the NEE light table built inside it from the traced
tables at the top of every grid step. The port's megakernel already reads
every table as an operand, so K3 here is the same CUDA bounce loop
(ops/csrc/megakernel.cu); in mode "nee" its dynamic-table instantiations
build the light table and clamp base (every sphere and plane a row, in
float32) in each block's prologue from the tables it has just staged,
with no launch of their own. An edit of the tables in place (a new
emission, a moved sphere) re-renders with no rebuild and no host round
trip. On the CPU the plain version takes the table from
`lights.light_table_dyn_reference`.

Like the JAX function (pallas_dynamic.py:591-595), it takes no SDFs:
tables with SDF rows raise NotImplementedError. Render such scenes with
`render_chunk` (K1's SDF instantiations).
"""

from __future__ import annotations

import torch

from ..scene.compile import SceneTables
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
    "nee" the light table and clamp base are K3's, built from the tables on
    their own device (K3 takes no clamp override); a scene with no sphere
    and no plane then raises ValueError, and one with SDFs
    NotImplementedError."""
    if tables.sdfs.shape[0]:
        raise NotImplementedError(
            "the dynamic-scene render takes no SDF primitives (as "
            "cornelis_tpu's render_chunk_pallas_dynamic); use render_chunk"
        )
    return render_chunk(
        tables, key, sample_offset, width=width, height=height, spp_chunk=spp_chunk,
        spp_total=spp_total, max_depth=max_depth, sampler=sampler, mode=mode,
        dynamic_table=mode == "nee",
    )
