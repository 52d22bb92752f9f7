"""The port's mesh render in one process, and against the JAX package's.

No process group here: the ranks of a mesh are emulated by building each
rank's `parallel.render.Mesh` coordinates and shard in turn.

- Shards: for every mesh and tile size, the ranks' (pixel, sample) pairs
  cover the chunk exactly once; sizes that do not split raise ValueError
  ("divisible") before any collective.
- The mesh against the frame: each shard's rays, traced by the kernel's
  plain version through the pixel-id operand, are bitwise the whole
  chunk's rows, and the wavefront body of render_chunk_mesh gives each
  shard pixel's sums bitwise as the frame's; a (1, 1) mesh renders
  bitwise as ops/megakernel.render_chunk and integrator.render_chunk.
- Against JAX: the emulated ranks (each shard's plain version, summed over
  the sample shards, un-permuted) against render_chunk_mesh_pallas in
  interpret mode on the conftest's 8-device CPU mesh, (8, 1) and (4, 2),
  Cornell 32x32, 8 spp, max_depth 8, uniform and sobol. The draws are the
  same, so the bars are tests/test_torch_megakernel.py's: per chunk at
  least 99% of rays within rtol = atol = 1e-4, compared ray by ray (one
  call per S samples, so each value is one ray per sample rank), and the
  channel means within 1%. Knife edges are expected (ROADMAP §C): with the
  sobol sampler two of these 8192 rays are knife-edge fireflies (R ~ 87 on
  one side, 0 on the other) that the single-device kernels show alike,
  and they alone move the R mean by 3.3%; there the mesh is held instead
  to moving no mean: the port's mesh image equals the port's single-device
  image (bitwise with a tiles-only mesh, else within rtol 1e-5 / atol 1e-6),
  and the JAX mesh's JAX's single-device image (tests/test_parallel.py's
  rtol 1e-5 / atol 1e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cornelis_tpu.ops.pallas_integrator import render_chunk_pallas
from cornelis_tpu.parallel import make_mesh as jax_mesh
from cornelis_tpu.parallel import render_chunk_mesh_pallas
from cornelis_tpu.scene.compile import compile_scene as jcompile
from cornelis_tpu.scene.library import cornell_box as jcornell
from cornelis_tpu_torch import RenderOptions, RenderSession
from cornelis_tpu_torch.integrator import integrate_pixel_samples, render_chunk
from cornelis_tpu_torch.math.tiles import tile_major_order
from cornelis_tpu_torch.ops import megakernel
from cornelis_tpu_torch.parallel import make_mesh, render_chunk_mesh, render_chunk_mesh_megakernel
from cornelis_tpu_torch.parallel.mesh import Mesh
from cornelis_tpu_torch.parallel.render import shard
from cornelis_tpu_torch.rng import DEFAULT_SEED, key_row, make_key
from cornelis_tpu_torch.scene.compile import compile_scene, scene_arrays
from cornelis_tpu_torch.scene.library import cornell_box

W = H = 32
SPP = 8
DEPTH = 8
MESHES = [(8, 1), (4, 2), (2, 4), (1, 8), (2, 1)]
KEY = key_row(DEFAULT_SEED)


@pytest.fixture(autouse=True)
def _threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def tables():
    return compile_scene(cornell_box(), device="cpu")


def ranks(shape):
    """Every rank's coordinates of a (T, S) mesh, in rank order."""
    return [Mesh(tuple(shape), r // shape[1], r % shape[1]) for r in range(shape[0] * shape[1])]


def agreement(a, b):
    ok = np.isclose(a, b, rtol=1e-4, atol=1e-4).all(axis=-1)
    ma, mb = a.reshape(-1, 3).mean(0), b.reshape(-1, 3).mean(0)
    return ok.mean(), np.abs(ma - mb) / np.maximum(np.abs(mb), 1e-12)


@pytest.mark.parametrize("tile_size", [8, 12, 0])
@pytest.mark.parametrize("shape", MESHES)
def test_shards_cover_the_chunk_once(shape, tile_size):
    seen = np.zeros((W * H, SPP), np.int64)
    for mesh in ranks(shape):
        sh = shard(mesh, W, H, SPP, 5, tile_size, "cpu")
        assert sh.pixel_ids.dtype == torch.int32 and sh.spp == SPP // shape[1]
        px = sh.pixel_ids.long().numpy()
        seen[np.ix_(px, np.arange(sh.sample_start, sh.sample_start + sh.spp) - 5)] += 1
    assert (seen == 1).all()
    # Each tile rank owns a run of the tile-major order.
    if tile_size:
        first = shard(ranks(shape)[0], W, H, SPP, 0, tile_size, "cpu").pixel_ids.numpy()
        np.testing.assert_array_equal(
            first, tile_major_order(W, H, tile_size, tile_size)[: W * H // shape[0]])


def test_indivisible_raises_before_any_collective(tables):
    mesh = Mesh((8, 1))
    with pytest.raises(ValueError, match="divisible"):
        render_chunk_mesh_megakernel(tables, KEY, 0, mesh=mesh, width=30, height=30,
                                     spp_chunk=SPP, spp_total=SPP, max_depth=4)
    with pytest.raises(ValueError, match="divisible"):
        render_chunk_mesh(scene_arrays(tables), make_key(3), 0, mesh=Mesh((2, 4)), width=W,
                          height=H, spp_chunk=6, spp_total=6, max_depth=4)


def test_mesh_needs_a_process_group_beyond_one_rank():
    assert make_mesh((1, 1)) == Mesh((1, 1))
    assert make_mesh() == Mesh((1, 1))
    with pytest.raises(ValueError, match="needs 2 ranks"):
        make_mesh((2, 1))
    with pytest.raises(ValueError):
        make_mesh((0, 1))


@pytest.mark.parametrize("sampler", ["uniform", "sobol"])
@pytest.mark.parametrize("shape", [(4, 2), (2, 1)])
def test_plain_version_on_a_shard_is_the_frames_rows(tables, shape, sampler):
    bits = megakernel.index_bits_for(SPP)
    kw = dict(root=KEY[2], sampler=sampler, index_bits=bits)
    full = megakernel.render_rays(tables, KEY[0], KEY[1], W, H, SPP, 0, DEPTH, **kw)
    for mesh in ranks(shape):
        sh = shard(mesh, W, H, SPP, 0, 12, "cpu")
        rays = megakernel.render_rays(tables, KEY[0], KEY[1], W, H, sh.spp, sh.sample_start,
                                      DEPTH, pixel_ids=sh.pixel_ids, **kw)
        rows = sh.pixel_ids.long()[:, None] * SPP + sh.sample_start + torch.arange(sh.spp)
        assert torch.equal(rays, full[rows.reshape(-1)])


def test_wavefront_shard_sums_are_the_frames(tables):
    scene = scene_arrays(tables)
    key = make_key(3)
    kw = dict(width=W, height=H, spp_total=SPP, max_depth=4)
    every = torch.arange(W * H, dtype=torch.int64)
    for mesh in ranks((2, 2)):
        sh = shard(mesh, W, H, SPP, 0, 8, "cpu")
        samples = sh.sample_start + torch.arange(sh.spp, dtype=torch.int64)
        with torch.no_grad():
            part = integrate_pixel_samples(scene, key, sh.pixel_ids.long(), samples, **kw)
            frame = integrate_pixel_samples(scene, key, every, samples, **kw)
        assert torch.equal(part, frame[sh.pixel_ids.long()])


def test_one_by_one_mesh_is_the_single_render(tables):
    kw = dict(width=W, height=H, spp_chunk=SPP, spp_total=SPP, max_depth=DEPTH)
    mesh = make_mesh((1, 1))
    for mode, sampler in (("path", "uniform"), ("nee", "sobol")):
        got = render_chunk_mesh_megakernel(tables, KEY, 0, mesh=mesh, sampler=sampler,
                                           mode=mode, **kw)
        want = megakernel.render_chunk(tables, KEY, 0, sampler=sampler, mode=mode, **kw)
        assert torch.equal(got, want)
    scene = scene_arrays(tables)
    kw.update(max_depth=4)
    got = render_chunk_mesh(scene, make_key(3), 0, mesh=mesh, **kw)
    assert torch.equal(got, render_chunk(scene, make_key(3), 0, **kw))
    opts = dict(width=W, height=H, samples_aa=SPP, spp_chunk=4, max_depth=DEPTH, device="cpu",
                output=None)
    single = RenderSession(cornell_box(), RenderOptions(**opts)).render()
    meshed = RenderSession(cornell_box(), RenderOptions(**opts, mesh_shape=(1, 1))).render()
    assert meshed.chunks == single.chunks == 2
    np.testing.assert_array_equal(meshed.image, single.image)


def emulated_mesh(tables, shape, sampler, offset, spp_chunk):
    """The frame the ranks of `shape` assemble, each rank's shard traced
    by the plain version: (H, W, 3) sums over the chunk."""
    frame = torch.zeros(W * H, 3)
    for mesh in ranks(shape):
        sh = shard(mesh, W, H, spp_chunk, offset, 32, "cpu")
        rays = megakernel.render_rays(
            tables, KEY[0], KEY[1], W, H, sh.spp, sh.sample_start, DEPTH, root=KEY[2],
            sampler=sampler, index_bits=megakernel.index_bits_for(SPP), pixel_ids=sh.pixel_ids)
        frame[sh.pixel_ids.long()] += rays.view(-1, sh.spp, 3).sum(dim=1)
    return frame.view(H, W, 3).numpy()


@pytest.fixture(scope="module")
def jscene():
    return jcompile(jcornell())


@pytest.mark.parametrize("sampler", ["uniform", "sobol"])
@pytest.mark.parametrize("shape", [(8, 1), (4, 2)])
def test_mesh_matches_jax_mesh_megakernel(tables, jscene, shape, sampler):
    n_samp = shape[1]
    jmesh = jax_mesh(shape)
    key = jax.random.key(DEFAULT_SEED)
    ours, theirs = [], []
    for offset in range(0, SPP, n_samp):  # one ray per sample rank and pixel
        j = render_chunk_mesh_pallas(
            jscene, key, jnp.uint32(offset), mesh=jmesh, width=W, height=H,
            spp_chunk=n_samp, spp_total=SPP, max_depth=DEPTH, interpret=True, sampler=sampler)
        theirs.append(np.asarray(j))
        ours.append(emulated_mesh(tables, shape, sampler, offset, n_samp))
        frac, _ = agreement(ours[-1], theirs[-1])
        assert frac >= 0.99, f"offset {offset}: only {frac:.2%} of rays agree"
    ours, theirs = np.stack(ours), np.stack(theirs)
    assert np.isfinite(ours).all() and (ours.sum(-1) > 0).sum() >= 5
    _, mean_rel = agreement(ours, theirs)
    if sampler == "uniform":
        assert (mean_rel <= 1e-2).all(), f"channel means differ by {mean_rel}"
        return
    # The sobol fireflies: the mesh moves no mean on either side.
    single = megakernel.render_chunk(tables, KEY, 0, width=W, height=H, spp_chunk=SPP,
                                     spp_total=SPP, max_depth=DEPTH, sampler=sampler).numpy()
    meshed = emulated_mesh(tables, shape, sampler, 0, SPP)
    if n_samp == 1:
        np.testing.assert_array_equal(meshed, single)
    np.testing.assert_allclose(meshed, single, rtol=1e-5, atol=1e-6)
    jsingle = np.asarray(render_chunk_pallas(
        jscene, key, np.uint32(0), width=W, height=H, spp_chunk=SPP, spp_total=SPP,
        max_depth=DEPTH, interpret=True, sampler=sampler))
    np.testing.assert_allclose(theirs.sum(0), jsingle, rtol=1e-5, atol=1e-4)
