"""The CUDA kernels on the card: tests marked `cuda`, which skip where
torch sees no CUDA device.

This file imports no JAX, so that it runs on a host with a card and no
JAX. `tests/conftest.py` imports jax, so there run it without it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Bar, and why: FMA contraction (mode "path") and CUDA's sinf/cosf move ulps
against the plain version's separate torch ops, and a knife-edge path (an
RR draw or a closest-hit comparison within an ulp) then goes elsewhere.
So at least 99% of rays within rtol = atol = 1e-4 and each channel's mean
within 1%, the bar of `chip_smoke.py` and of the plain version against
the Pallas kernel in `tests/test_torch_megakernel.py`. The light-table
kernel does only float32 products and sums in the plain version's
order, so it is held to it bit for bit, on the edge tables of
tests/torch_light_tables.py too; the dynamic render's nee launch, which
builds that table in every block, launches no table kernel and gives
the rays of K1's nee instantiation fed the plain table, bit for bit. The SDF instantiations are held
to the same bar on sdf_gallery, and the sphere and plane ones on scenes
whose tables cross the kernel's shared-memory cap. The kernel's blocks take
rays in no fixed order: every ray is written, and two launches give the
same bits. The zero fill must equal torch.zeros; the
probes their plain versions, float32 within 1 ulp (they round every
operation as the plain versions do) and bfloat16 within 1 bfloat16 ulp;
the scan probes on the special lanes too, K6 at every table length
through both its staging paths (bulk copy, and the threads' own copy of
a table that is not 16-byte aligned), and both at ragged element counts;
K4 bit for bit on its probe and special inputs, and its chain, summing
disc in place of the root (probes/scan_designs.py's "disc" design, built
from probes.cu), bit for bit the plain version's.

The differentiable mode (torch ops, no kernel of its own) on the card
against the same code on the CPU: render_diff on Cornell at 16x16, 8 spp,
max_depth 4, pixels and gradients held as tests/test_torch_diff.py holds
the CPU against JAX (99% of pixels within 1e-4, 90% in mode nee; every
float field within 2% relative L2 over the pixels that agree, the light's
albedo and tint rows left out); and one InverseRenderer step on the card.

The mesh's pixel-id operand (a shard of a (2, 2) mesh): every
instantiation gives the contiguous launch's rays bit for bit, and meets
the bar above against the plain version on the same (pixel, sample)
rays; a (1, 1) mesh session renders as the single session, bitwise.
"""

import numpy as np
import pytest
import torch

from cornelis_tpu_torch import RenderOptions, RenderSession, RenderStatus
from cornelis_tpu_torch.ops import lights, megakernel, warm
from cornelis_tpu_torch.ops.dynamic import render_chunk_dynamic
from cornelis_tpu_torch.probes import bf16 as bf16_probe
from cornelis_tpu_torch.probes import scene_table
from cornelis_tpu_torch.rng import DEFAULT_SEED, key_row
from cornelis_tpu_torch.scene import library as tlib
from cornelis_tpu_torch.diff import InverseRenderer, render_diff
from cornelis_tpu_torch.math.vec import Vec3
from cornelis_tpu_torch.rng import make_key
from cornelis_tpu_torch.scene.compile import compile_scene, scene_arrays
from torch_light_tables import CASE_NAMES, table_case

pytestmark = pytest.mark.cuda

VARIANTS = [("path", "uniform"), ("path", "sobol"), ("nee", "uniform"), ("nee", "sobol")]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")


def agreement(a, b):
    """(fraction of rays within rtol = atol = 1e-4, per-channel relative
    difference of the means) of two (..., 3) radiance arrays."""
    ok = np.isclose(a, b, rtol=1e-4, atol=1e-4).all(axis=-1)
    ma, mb = a.reshape(-1, 3).mean(0), b.reshape(-1, 3).mean(0)
    return ok.mean(), np.abs(ma - mb) / np.maximum(np.abs(mb), 1e-12)


@pytest.mark.parametrize("offset", [0, 28])
def test_cuda_kernel_matches_plain_version(cuda, offset):
    tables = compile_scene(tlib.cornell_box(), device="cuda")
    before = megakernel.LAUNCHES
    k = megakernel.render_rays(tables, 0, DEFAULT_SEED, 32, 32, 4, offset, 64)
    torch.cuda.synchronize()
    assert megakernel.LAUNCHES == before + 1
    p = megakernel.render_rays_reference(tables, 0, DEFAULT_SEED, 32, 32, 4, offset, 64, "cuda")
    frac, mean_rel = agreement(k.cpu().numpy(), p.cpu().numpy())
    assert torch.isfinite(k).all()
    assert frac >= 0.99 and (mean_rel <= 1e-2).all()


@pytest.mark.parametrize("mode,sampler", VARIANTS)
@pytest.mark.parametrize("scene", ["cornell_box", "cornell_panel"])
def test_cuda_variant_matches_plain_version(cuda, scene, mode, sampler):
    tables = compile_scene(getattr(tlib, scene)(), device="cuda")
    k0, k1, root = key_row(DEFAULT_SEED)
    kw = dict(root=root, sampler=sampler, mode=mode, index_bits=megakernel.index_bits_for(16),
              lights=lights.light_table(tables) if mode == "nee" else None)
    args = (tables, k0, k1, 32, 32, 4, 12, 64)
    k = megakernel.render_rays(*args, **kw)
    torch.cuda.synchronize()
    p = megakernel.render_rays_reference(*args, "cuda", **kw)
    frac, mean_rel = agreement(k.cpu().numpy(), p.cpu().numpy())
    assert torch.isfinite(k).all()
    assert frac >= 0.99 and (mean_rel <= 1e-2).all()


@pytest.mark.parametrize("scene", CASE_NAMES)
def test_cuda_light_table_matches_plain_version(cuda, scene):
    tables = table_case(scene, "cuda")
    before = lights.LAUNCHES
    got = lights.light_table_dyn(tables)
    torch.cuda.synchronize()
    assert lights.LAUNCHES == before + 1
    want = lights.light_table_dyn_reference(tables)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert torch.equal(g.view(torch.int32), w.contiguous().view(torch.int32))


@pytest.mark.parametrize("sampler", ["uniform", "sobol"])
@pytest.mark.parametrize("scene", ["cornell_box", "sphere_grid(512)", "sphere_grid(2200)"])
def test_cuda_dynamic_nee_builds_its_table_in_the_launch(cuda, scene, sampler):
    # One launch a chunk and no table launch; the image bit for bit that of
    # K1's nee instantiation fed light_table_dyn_reference's table.
    # sphere_grid(2200)'s tables (2202 light rows, ~158 KB) go through the
    # staging kernel, whose block 0 builds the table.
    tables = table_case(scene, "cuda")
    kw = dict(width=24, height=24, spp_chunk=4, spp_total=16, max_depth=64, sampler=sampler,
              mode="nee")
    before = (megakernel.LAUNCHES, megakernel.DYNAMIC_TABLE_LAUNCHES, lights.LAUNCHES)
    got = render_chunk_dynamic(tables, key_row(5), 4, **kw)
    torch.cuda.synchronize()
    assert (megakernel.LAUNCHES, megakernel.DYNAMIC_TABLE_LAUNCHES, lights.LAUNCHES) == (
        before[0] + 1, before[1] + 1, before[2])
    want = megakernel.render_chunk(tables, key_row(5), 4,
                                   lights=lights.light_table_dyn_reference(tables), **kw)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert got.sum() > 0


@pytest.mark.parametrize("mode", ["path", "nee"])
def test_cuda_dynamic_matches_plain_version(cuda, mode):
    tables = compile_scene(tlib.cornell_box(), device="cuda")
    key = key_row(3)
    kw = dict(width=32, height=32, spp_chunk=4, spp_total=16, max_depth=64, sampler="sobol",
              mode=mode)
    k = render_chunk_dynamic(tables, key, 4, **kw)
    torch.cuda.synchronize()
    p = megakernel.render_rays_reference(
        tables, key[0], key[1], 32, 32, 4, 4, 64, "cuda", root=key[2], sampler="sobol", mode=mode,
        index_bits=4, lights=lights.light_table_dyn_reference(tables) if mode == "nee" else None,
    ).view(32 * 32, 4, 3).sum(1).view(32, 32, 3)
    frac, mean_rel = agreement(k.cpu().numpy(), p.cpu().numpy())
    assert frac >= 0.99 and (mean_rel <= 1e-2).all()


def test_cuda_dynamic_emission_doubling(cuda):
    tables = compile_scene(tlib.cornell_box(), device="cuda")
    kw = dict(width=32, height=32, spp_chunk=4, spp_total=4, max_depth=64, sampler="sobol",
              mode="nee")
    base = render_chunk_dynamic(tables, key_row(6), 0, **kw)
    tables.materials[:, 3:6] *= 2.0
    doubled = render_chunk_dynamic(tables, key_row(6), 0, **kw)
    torch.testing.assert_close(doubled, 2.0 * base, rtol=1e-5, atol=0.0)
    assert base.max() > 0


@pytest.mark.parametrize("mode,sampler", [("path", "uniform"), ("nee", "sobol")])
def test_cuda_session_launches_kernel_per_chunk(cuda, mode, sampler):
    opts = RenderOptions(width=32, height=32, samples_aa=8, spp_chunk=4, max_depth=8,
                         output=None, device="cuda", integrator=mode, sampler=sampler)
    before = megakernel.LAUNCHES
    result = RenderSession(tlib.cornell_box(), opts).render()
    assert result.status == RenderStatus.DONE
    assert megakernel.LAUNCHES == before + 2 == before + result.chunks
    assert result.image.shape == (32, 32, 3) and np.isfinite(result.image).all()
    assert result.image.sum() > 0


@pytest.mark.parametrize("mode,sampler", VARIANTS)
def test_cuda_sdf_variant_matches_plain_version(cuda, mode, sampler):
    tables = compile_scene(tlib.sdf_gallery(), device="cuda")
    k0, k1, root = key_row(DEFAULT_SEED)
    kw = dict(root=root, sampler=sampler, mode=mode, index_bits=megakernel.index_bits_for(16),
              lights=lights.light_table(tables) if mode == "nee" else None)
    args = (tables, k0, k1, 32, 32, 4, 4, 64)
    before = megakernel.SDF_LAUNCHES
    k = megakernel.render_rays(*args, **kw)
    torch.cuda.synchronize()
    assert megakernel.SDF_LAUNCHES == before + 1
    p = megakernel.render_rays_reference(*args, "cuda", **kw)
    frac, mean_rel = agreement(k.cpu().numpy(), p.cpu().numpy())
    assert torch.isfinite(k).all()
    assert frac >= 0.99 and (mean_rel <= 1e-2).all()


WORK_ORDER_CASES = [("cornell_box", "path", "uniform"), ("cornell_panel", "nee", "sobol"),
                    ("sdf_gallery", "path", "sobol"), ("sdf_gallery", "nee", "uniform")]


def _variant(scene, mode, sampler):
    tables = compile_scene(getattr(tlib, scene)(), device="cuda")
    k0, k1, root = key_row(DEFAULT_SEED)
    kw = dict(root=root, sampler=sampler, mode=mode, index_bits=megakernel.index_bits_for(64),
              lights=lights.light_table(tables) if mode == "nee" else None)
    return tables, k0, k1, kw


@pytest.mark.parametrize("scene,mode,sampler", WORK_ORDER_CASES)
def test_cuda_every_ray_is_written_under_the_dynamic_work_order(cuda, scene, mode, sampler):
    # The blocks take rays from a counter in no fixed order: launched
    # through the C entry into a NaN-filled output, a ray count that is no
    # multiple of a block's claim (37 x 23 x 3) leaves no ray unwritten.
    tables, k0, k1, kw = _variant(scene, mode, sampler)
    out = torch.full((37 * 23 * 3, 3), float("nan"), device="cuda")
    megakernel._launch_into(out, tables, k0, k1, 37, 23, 3, 5, 64, **kw)
    torch.cuda.synchronize()
    assert not torch.isnan(out).any()
    want = megakernel.render_rays_reference(tables, k0, k1, 37, 23, 3, 5, 64, "cuda", **kw)
    frac, mean_rel = agreement(out.cpu().numpy(), want.cpu().numpy())
    assert frac >= 0.99 and (mean_rel <= 1e-2).all()


@pytest.mark.parametrize("scene,mode,sampler", WORK_ORDER_CASES)
def test_cuda_launches_are_deterministic_on_one_and_two_streams(cuda, scene, mode, sampler):
    # Each launch zeroes its own ray counter: two launches give the same
    # bits back to back on one stream and side by side on two.
    tables, k0, k1, kw = _variant(scene, mode, sampler)
    args = (tables, k0, k1, 96, 96, 8, 0, 64)
    first = megakernel.render_rays(*args, **kw)
    second = megakernel.render_rays(*args, **kw)
    streams = torch.cuda.Stream(), torch.cuda.Stream()
    torch.cuda.synchronize()
    side = []
    for s in streams:
        with torch.cuda.stream(s):
            side.append(megakernel.render_rays(*args, **kw))
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    assert torch.equal(side[0], first) and torch.equal(side[1], first)


@pytest.mark.parametrize("mode,sampler", [("path", "uniform"), ("nee", "sobol")])
@pytest.mark.parametrize("n", [2200, 3000])
def test_cuda_sphere_grid_beyond_the_shared_memory_cap(cuda, n, mode, sampler):
    # The kernel stages the tables in shared memory up to 64 KB.
    # sphere_grid(2200)'s take about 56 KB (staged, above the 48 KB default
    # limit); sphere_grid(3000)'s about 77 KB, so its 3001 spheres stay in
    # device memory. Both still match the plain version.
    tables = compile_scene(tlib.sphere_grid(n), device="cuda")
    floats = 5 * tables.spheres.shape[0] + 11 * tables.materials.shape[0] + 16 * tables.planes.shape[0]
    assert (48 * 1024 < 4 * floats < 64 * 1024) == (n == 2200)
    k0, k1, root = key_row(DEFAULT_SEED)
    kw = dict(root=root, sampler=sampler, mode=mode, index_bits=megakernel.index_bits_for(4),
              lights=lights.light_table(tables) if mode == "nee" else None)
    args = (tables, k0, k1, 8, 8, 2, 0, 3)
    k = megakernel.render_rays(*args, **kw)
    torch.cuda.synchronize()
    p = megakernel.render_rays_reference(*args, "cuda", **kw)
    frac, mean_rel = agreement(k.cpu().numpy(), p.cpu().numpy())
    assert torch.isfinite(k).all() and k.sum() > 0
    assert frac >= 0.99 and (mean_rel <= 1e-2).all()


def _shard_case(scene, mode, sampler, width, spp):
    """The kernel's arguments, and rank 3's shard (tile 1, samples slice 1)
    of a (2, 2) mesh over a width x width frame with `spp` samples."""
    from cornelis_tpu_torch.parallel.mesh import Mesh
    from cornelis_tpu_torch.parallel.render import shard

    tables, k0, k1, kw = _variant(scene, mode, sampler)
    sh = shard(Mesh((2, 2), 1, 1), width, width, spp, 0, 32, "cuda")
    return tables, k0, k1, kw, sh


@pytest.mark.parametrize("scene", ["cornell_box", "sdf_gallery"])
@pytest.mark.parametrize("mode,sampler", VARIANTS)
def test_cuda_pixel_ids_give_the_contiguous_launchs_rays_bitwise(cuda, scene, mode, sampler):
    # Everything after the id read uses the frame's pixel, so a shard's
    # rays are the contiguous launch's rows bit for bit.
    tables, k0, k1, kw, sh = _shard_case(scene, mode, sampler, 64, 8)
    full = megakernel.render_rays(tables, k0, k1, 64, 64, 8, 0, 64, **kw)
    before = megakernel.LAUNCHES
    rays = megakernel.render_rays(tables, k0, k1, 64, 64, sh.spp, sh.sample_start, 64,
                                  pixel_ids=sh.pixel_ids, **kw)
    torch.cuda.synchronize()
    assert megakernel.LAUNCHES == before + 1
    rows = sh.pixel_ids.long()[:, None] * 8 + sh.sample_start + torch.arange(sh.spp, device="cuda")
    assert rays.shape == (64 * 64 // 2 * 4, 3)
    assert torch.equal(rays, full[rows.reshape(-1)])


@pytest.mark.parametrize("scene", ["cornell_box", "sdf_gallery"])
@pytest.mark.parametrize("mode,sampler", VARIANTS)
def test_cuda_pixel_ids_match_the_plain_version(cuda, scene, mode, sampler):
    tables, k0, k1, kw, sh = _shard_case(scene, mode, sampler, 32, 8)
    args = (tables, k0, k1, 32, 32, sh.spp, sh.sample_start, 64)
    k = megakernel.render_rays(*args, pixel_ids=sh.pixel_ids, **kw)
    torch.cuda.synchronize()
    pixel = sh.pixel_ids.long().repeat_interleave(sh.spp)
    sample = sh.sample_start + torch.arange(sh.spp, device="cuda").repeat(sh.pixel_ids.shape[0])
    p = megakernel.render_rays_reference(*args, "cuda", pixel=pixel, sample=sample, **kw)
    frac, mean_rel = agreement(k.cpu().numpy(), p.cpu().numpy())
    assert torch.isfinite(k).all()
    assert frac >= 0.99 and (mean_rel <= 1e-2).all()


def test_cuda_pixel_ids_are_checked(cuda):
    tables, k0, k1, kw = _variant("cornell_box", "path", "uniform")
    for ids in (torch.arange(4, dtype=torch.int64, device="cuda"),
                torch.arange(4, dtype=torch.int32),
                torch.arange(8, dtype=torch.int32, device="cuda")[::2]):
        with pytest.raises(ValueError, match="pixel_ids"):
            megakernel.render_rays(tables, k0, k1, 8, 8, 1, 0, 4, pixel_ids=ids, **kw)


def test_cuda_one_by_one_mesh_session_is_the_single_session(cuda):
    opts = dict(width=64, height=64, samples_aa=16, spp_chunk=8, max_depth=16, output=None,
                device="cuda", integrator="nee", sampler="sobol")
    single = RenderSession(tlib.cornell_box(), RenderOptions(**opts)).render()
    before = megakernel.LAUNCHES
    meshed = RenderSession(tlib.cornell_box(), RenderOptions(**opts, mesh_shape=(1, 1))).render()
    assert megakernel.LAUNCHES == before + 2 == before + meshed.chunks
    np.testing.assert_array_equal(meshed.image, single.image)


def test_cuda_sdf_session_launches_the_sdf_kernel(cuda):
    opts = RenderOptions(width=32, height=32, samples_aa=8, spp_chunk=4, max_depth=8,
                         output=None, device="cuda")
    before = megakernel.LAUNCHES, megakernel.SDF_LAUNCHES
    result = RenderSession(tlib.sdf_gallery(), opts).render()
    assert result.status == RenderStatus.DONE
    assert (megakernel.LAUNCHES, megakernel.SDF_LAUNCHES) == (before[0] + 2, before[1] + 2)
    assert np.isfinite(result.image).all() and result.image.sum() > 0


def test_cuda_dynamic_raises_on_sdf_tables(cuda):
    tables = compile_scene(tlib.sdf_gallery(), device="cuda")
    with pytest.raises(NotImplementedError):
        render_chunk_dynamic(tables, key_row(0), 0, width=8, height=8, spp_chunk=1,
                             spp_total=1, max_depth=2)


def test_cuda_warm_kernels_and_zero_fill(cuda):
    before = warm.LAUNCHES
    out = warm.warm_kernels()
    assert warm.LAUNCHES == before + 1
    assert out["load_s"] >= 0 and out["first_launch_s"] >= 0
    assert torch.equal(out["zeros"], torch.zeros((8, 128), device="cuda"))
    z = warm.zero_block("cuda")
    torch.cuda.synchronize()
    assert torch.equal(z, warm.zero_block_reference("cuda"))


@pytest.mark.parametrize("n_obj", scene_table.BAKED_COUNTS)
def test_cuda_scan_probes_match_plain_versions(cuda, n_obj):
    o = scene_table.probe_input("cuda")
    tab = scene_table.table(n_obj, "cuda")
    before = dict(scene_table.LAUNCHES)
    baked, dynamic = scene_table.scan_baked(o, n_obj), scene_table.scan_dynamic(o, tab)
    torch.cuda.synchronize()
    assert scene_table.LAUNCHES == {k: v + 1 for k, v in before.items()}
    torch.testing.assert_close(baked, scene_table.scan_baked_reference(o, n_obj),
                               rtol=2.0 ** -23, atol=0.0)
    torch.testing.assert_close(dynamic, scene_table.scan_dynamic_reference(o, tab),
                               rtol=2.0 ** -23, atol=0.0)
    with pytest.raises(ValueError):
        scene_table.scan_baked(o, n_obj + 1)


@pytest.mark.parametrize("n_obj", scene_table.BAKED_COUNTS)
def test_cuda_scan_probes_match_plain_versions_on_special_lanes(cuda, n_obj):
    o = scene_table.special_input("cuda")
    tab = scene_table.table(n_obj, "cuda")
    baked, dynamic = scene_table.scan_baked(o, n_obj), scene_table.scan_dynamic(o, tab)
    torch.cuda.synchronize()
    torch.testing.assert_close(baked, scene_table.scan_baked_reference(o, n_obj),
                               rtol=2.0 ** -23, atol=0.0)
    torch.testing.assert_close(dynamic, scene_table.scan_dynamic_reference(o, tab),
                               rtol=2.0 ** -23, atol=0.0)


# Table lengths: none, fewer than the sphere loop's unrolling, a remainder
# past it, the default table (one staged tile), one sphere past the tile
# and past two tiles (the double buffer reused).
@pytest.mark.parametrize("n_obj", [0, 1, 3, 13, 512, scene_table.STAGE_TILE + 1,
                                   2 * scene_table.STAGE_TILE + 76])
@pytest.mark.parametrize("aligned", [True, False])
def test_cuda_scan_dynamic_table_lengths(cuda, n_obj, aligned):
    o = scene_table.special_input("cuda")
    tab = scene_table.table(n_obj, "cuda")
    if not aligned:  # a contiguous view 4 bytes into a flat tensor: no bulk copy
        flat = torch.empty(4 * n_obj + 1, device="cuda")
        flat[1:] = tab.reshape(-1)
        tab = flat[1:].view(n_obj, 4)
        assert n_obj == 0 or tab.data_ptr() % 16 == 4
    got = scene_table.scan_dynamic(o, tab)
    torch.cuda.synchronize()
    want = scene_table.scan_dynamic_reference(o, tab)
    torch.testing.assert_close(got, want, rtol=2.0 ** -23, atol=0.0)
    if n_obj == 0:
        assert bool(torch.isinf(got).all())


@pytest.mark.parametrize("n", [1, 127, 131071])
def test_cuda_scan_probes_ragged_element_counts(cuda, n):
    o = scene_table.special_input("cuda").view(-1)[1:n + 1].clone()  # from the +inf lane on
    tab = scene_table.table(scene_table.DEFAULT_N, "cuda")
    for n_obj in scene_table.BAKED_COUNTS:
        torch.testing.assert_close(scene_table.scan_baked(o, n_obj),
                                   scene_table.scan_baked_reference(o, n_obj),
                                   rtol=2.0 ** -23, atol=0.0)
    torch.testing.assert_close(scene_table.scan_dynamic(o, tab),
                               scene_table.scan_dynamic_reference(o, tab), rtol=2.0 ** -23, atol=0.0)
    for kind in ("baked", "dynamic"):
        shape = scene_table.launch_shape(kind, scene_table.DEFAULT_N, n)
        per_block = shape["block"] * shape["rays_per_thread"]
        assert 1 <= shape["blocks"] <= -(-n // per_block)


@pytest.mark.parametrize("data", ["probe", "special"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_quad_probe_matches_plain_version(cuda, dtype, data):
    make = bf16_probe.probe_input if data == "probe" else bf16_probe.special_input
    x = make(dtype, "cuda")
    got = bf16_probe.quad_probe(x)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    assert torch.equal(got.view(bits), bf16_probe.quad_reference(x).view(bits))


@pytest.mark.parametrize("n", [1, 2, 3, 1001])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_quad_probe_ragged_and_offset_inputs(cuda, dtype, n):
    # Element counts that leave a pair or a lane half full, and bfloat16
    # data that starts at an address 2 bytes past a pair's.
    x = bf16_probe.special_input(dtype, "cuda").view(-1)[1:n + 1].contiguous()
    x = torch.cat([x[:1], x])[1:] if dtype == torch.bfloat16 else x
    got = bf16_probe.quad_probe(x)
    torch.cuda.synchronize()
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    assert torch.equal(got.view(bits), bf16_probe.quad_reference(x).view(bits))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_quad_chain_sums_disc_bitwise(cuda, dtype):
    from cornelis_tpu_torch.probes import scan_designs as sd

    spec = (dtype, "disc")
    run, _ = sd.quad_runner(sd.build_design(spec))
    bits = torch.int16 if dtype == "bfloat16" else torch.int32
    for make in (bf16_probe.probe_input, bf16_probe.special_input):
        x = make(getattr(torch, dtype), "cuda")
        got, want = run(x), sd.disc_sum_reference(x)
        torch.cuda.synchronize()
        same = (got.view(bits) == want.view(bits)) | (torch.isnan(got) & torch.isnan(want))
        assert bool(same.all())


DIFF_FIELDS = ("mat_albedo", "mat_emission", "mat_tint", "mat_roughness", "sphere_center",
               "sphere_radius", "plane_point")


def _diff_grads(scene, weight, mode):
    leaf = lambda t: t.detach().clone().requires_grad_(True)
    leaves = {f: Vec3(*(leaf(c) for c in v)) if isinstance(v, Vec3) else leaf(v)
              for f, v in ((f, getattr(scene, f)) for f in DIFF_FIELDS)}
    img = render_diff(scene._replace(**leaves), make_key(5, scene.device), width=16, height=16,
                      spp=8, max_depth=4, mode=mode)
    (torch.sum(img * weight[:, :, None]) / (3.0 * weight.sum())).backward()
    grads = {f: torch.cat([c.grad for c in (v if isinstance(v, Vec3) else (v,))]).cpu().numpy()
             for f, v in leaves.items()}
    return img.detach().cpu(), grads


@pytest.mark.parametrize("mode", ["path", "nee"])
def test_cuda_render_diff_gradients_match_the_cpu(cuda, mode):
    cpu = scene_arrays(compile_scene(tlib.cornell_box(), device="cpu"))
    card = scene_arrays(compile_scene(tlib.cornell_box(), device="cuda"))
    ones = torch.ones((16, 16))
    img_c, _ = _diff_grads(cpu, ones, mode)
    img_g, _ = _diff_grads(card, ones.cuda(), mode)
    agree = torch.isclose(img_g, img_c, rtol=1e-4, atol=1e-4).all(dim=-1)
    assert agree.double().mean().item() >= (0.99 if mode == "path" else 0.90)
    _, g_c = _diff_grads(cpu, agree.float(), mode)
    _, g_g = _diff_grads(card, agree.float().cuda(), mode)
    light = int(torch.argmax(cpu.mat_emission.x))
    keep = np.tile(np.arange(cpu.mat_roughness.shape[0]) != light, 3)
    for f in DIFF_FIELDS:
        sel = keep if f in ("mat_albedo", "mat_tint") else slice(None)
        got, want = g_g[f][sel], g_c[f][sel]
        assert np.isfinite(got).all(), f
        assert np.linalg.norm(got - want) <= 0.02 * np.linalg.norm(want), f


def test_cuda_inverse_renderer_step(cuda):
    scene = scene_arrays(compile_scene(tlib.sphere_on_plane(), device="cuda"))
    with torch.no_grad():
        target = render_diff(scene, make_key(9, "cuda"), width=24, height=24, spp=32, max_depth=4)
    inv = InverseRenderer(scene, target, fields=("mat_albedo", "mat_roughness"), width=24,
                          height=24, spp=8, max_depth=4)
    loss = inv.step()
    assert np.isfinite(loss) and inv.step_count == 1
    for leaf in (*inv.params["mat_albedo"], inv.params["mat_roughness"]):
        assert leaf.device.type == "cuda" and leaf.grad is not None
        assert bool(torch.isfinite(leaf.grad).all())
    assert bool((inv.params["mat_albedo"].x.grad != 0).any())


def test_cuda_a_span_holds_its_kernels_device_interval(cuda):
    """The spans' clock is the profiler's: a span around a launch and its
    synchronise holds the kernel's device interval in the profile."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from cornelis_tpu_torch.utils import trace

    x = torch.ones(1 << 24, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with trace.collect() as spans:
            with trace.span("ct.check"):
                x.mul_(2.0)
                torch.cuda.synchronize()
    kernels = [(e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA and not e.is_user_annotation()]
    (span,) = spans
    assert len(kernels) == 1
    start, end = kernels[0]
    print(f"span opens {(start - span.start_ns) / 1e3} us before the kernel starts and closes "
          f"{(span.end_ns - end) / 1e3} us after it ends ({(end - start) / 1e3} us)")
    assert span.start_ns <= start < end <= span.end_ns


def test_cuda_the_backward_recompute_hangs_under_the_step(cuda):
    """On the card autograd runs the backward on a thread of its own: the
    recomputed bounces carry the step's id under ct.inverse.backward."""
    from cornelis_tpu_torch.utils import trace

    scene = scene_arrays(compile_scene(tlib.sphere_on_plane(), device="cuda"))
    with torch.no_grad():
        target = render_diff(scene, make_key(9, "cuda"), width=8, height=8, spp=2, max_depth=2)
    inv = InverseRenderer(scene, target, fields=("mat_albedo",), width=8, height=8, spp=2,
                          max_depth=2)
    with trace.collect() as spans:
        inv.step()
    step = next(s for s in spans if s.name == "ct.inverse.step")
    backward = next(s for s in spans if s.name == "ct.inverse.backward")
    recompute = [s for s in spans if s.name == "ct.integrator.bounce" and s.parent == backward.id]
    assert len(recompute) == 4  # both bounces of the two renders (key_strategy "dual")
    assert {s.request for s in spans} == {step.request}
    print(f"recomputed bounces on threads {sorted({s.thread for s in recompute})}, the step on "
          f"{step.thread}")
