"""The frozen reference against the port's plain versions on the CPU, at
tiny sizes: rays bit for bit where the draws are shared, the wavefront's
loss and gradients, and the work count's categories against
chip_smoke.py's on one case. The reference stays fixed while the port
moves; these tests say where the two still agree."""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench.reference import compile as ref_compile
from perfbench.reference import description as ref_description
from perfbench.reference import frames as ref_frames
from perfbench.reference import inverse as ref_inverse
from perfbench.reference import lights as ref_lights
from perfbench.reference import megakernel as ref_megakernel
from perfbench.reference import rng as ref_rng
from perfbench.reference import work as ref_work
from perfbench.reference.lowp import rounded_to

ROOT = Path(__file__).resolve().parents[2]


def _scene(name):
    return json.loads((ROOT / "perfbench" / "configs" / f"{name}.json").read_text())["scene"]


def _ref_tables(name):
    desc = ref_description.SceneDescription.from_dict(_scene(name))
    return ref_compile.compile_scene(desc, device="cpu")


def _port_tables(name):
    from cornelis_tpu_torch.scene.compile import compile_scene
    from cornelis_tpu_torch.scene.description import SceneDescription

    return compile_scene(SceneDescription.from_dict(_scene(name)), device="cpu")


@pytest.mark.parametrize("name", ["cornell", "sdf-gallery"])
def test_scene_compile_matches_the_port(name):
    for ours, theirs in zip(_ref_tables(name), _port_tables(name)):
        assert torch.equal(ours, theirs)


@pytest.mark.parametrize("name, mode, sampler", [
    ("cornell", "path", "uniform"), ("cornell", "nee", "sobol"), ("sdf-gallery", "nee", "sobol"),
])
def test_rays_bit_for_bit_with_the_port(name, mode, sampler):
    from cornelis_tpu_torch.ops import lights as port_lights
    from cornelis_tpu_torch.ops import megakernel as port_megakernel
    from cornelis_tpu_torch.rng import key_row

    seed, w, h, spp, depth = 2**31 + 99, 12, 10, 4, 8
    ref_t = _ref_tables(name)
    port_t = _port_tables(name)
    k0, k1, root = key_row(seed)
    assert (k0, k1, root) == ref_rng.key_row(seed)
    ref_l = ref_lights.light_table(ref_t)
    port_l = port_lights.light_table(port_t)
    assert torch.equal(ref_l.rows, port_l.rows) and torch.equal(ref_l.clamp, port_l.clamp)
    kw = dict(root=root, sampler=sampler, mode=mode, index_bits=ref_megakernel.index_bits_for(spp))
    got = port_megakernel.render_rays(port_t, k0, k1, w, h, spp, 0, depth,
                                      lights=port_l if mode == "nee" else None, **kw)
    want = ref_megakernel.render_rays_reference(ref_t, k0, k1, w, h, spp, 0, depth, "cpu",
                                                lights=ref_l if mode == "nee" else None, **kw)
    assert torch.equal(got, want)


def test_pixel_means_are_the_sessions_image():
    from cornelis_tpu_torch import RenderOptions, render_scene
    from cornelis_tpu_torch.scene.description import SceneDescription

    seed, w, h, spp = 1234567, 10, 8, 8
    opts = RenderOptions(width=w, height=h, samples_aa=spp, max_depth=6, seed=seed, output=None,
                         device="cpu", integrator="nee", sampler="sobol")
    image = render_scene(SceneDescription.from_dict(_scene("cornell")), opts).image
    t = _ref_tables("cornell")
    pixels = torch.tensor([0, 7, 33, 79])
    got = ref_frames.pixel_means(t, ref_lights.light_table(t), seed, pixels, width=w, height=h,
                                 spp=spp, max_depth=6, integrator="nee", sampler="sobol",
                                 block_rays=16)
    np.testing.assert_allclose(got.numpy(), image.reshape(-1, 3)[pixels.numpy()], rtol=1e-6,
                               atol=1e-7)


def test_srgb8_matches_the_film():
    from cornelis_tpu_torch.film import Film

    film = Film(7, 5)
    rng = np.random.default_rng(3)
    film.add_samples(rng.random((5, 7, 3), dtype=np.float32) * 1.3, 1)
    assert np.array_equal(ref_frames.srgb8(film.image()), film.to_srgb8())


def _inverse_pair(module_scene, module_inv, vec3, target, seed=5):
    from perfbench.kinds import inverse as kind

    start = kind.start_scene(module_scene, {"albedo_scale": 0.4, "albedo_offset": 0.3,
                                            "albedo_min": 0.02, "albedo_max": 0.95,
                                            "roughness": 0.35}, vec3)
    inv = module_inv.InverseRenderer(start, target, fields=("mat_albedo", "mat_roughness"),
                                     width=12, height=10, spp=4, max_depth=4, learning_rate=5e-2,
                                     seed=seed, key_strategy="dual", mode="path")
    return kind.first_steps(inv, ("mat_albedo", "mat_roughness"), 3)


def test_wavefront_loss_and_gradients_match_the_port():
    from cornelis_tpu_torch.diff import inverse as port_inverse
    from cornelis_tpu_torch.math.vec import Vec3
    from cornelis_tpu_torch.scene.compile import scene_arrays
    from perfbench.reference.diff_render import render_diff
    from perfbench.reference.vec import Vec3 as RefVec3

    ref_scene = ref_compile.scene_arrays(_ref_tables("cornell"))
    with torch.no_grad():
        target = render_diff(ref_scene, ref_rng.make_key(9), width=12, height=10, spp=8,
                             max_depth=4)
    ours = _inverse_pair(ref_scene, ref_inverse, RefVec3, target)
    theirs = _inverse_pair(scene_arrays(_port_tables("cornell")), port_inverse, Vec3, target)
    assert ours == theirs


def test_work_counts_match_chip_smoke():
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from cornelis_tpu_torch.ops import megakernel as port_megakernel

    seed, w, h, spp, depth = 77, 8, 8, 4, 8
    t = _ref_tables("sdf-gallery")
    k0, k1, root = ref_rng.key_row(seed)
    kw = dict(root=root, sampler="sobol", mode="nee", index_bits=2)
    _, ours = ref_work.counted_work(lambda: ref_megakernel.render_rays_reference(
        t, k0, k1, w, h, spp, 0, depth, "cpu", lights=ref_lights.light_table(t), **kw))
    pt = _port_tables("sdf-gallery")
    from cornelis_tpu_torch.ops import lights as port_lights

    _, theirs = chip_smoke.counted_work(port_megakernel, lambda: port_megakernel.render_rays(
        pt, k0, k1, w, h, spp, 0, depth, lights=port_lights.light_table(pt), **kw))
    assert ours == theirs
    assert ref_work.OPS == chip_smoke.OPS
    n = w * h * spp
    ops = n * ref_work.OPS["camera"] + ref_work.traced_ops(ours, t, "nee")
    assert ops / chip_smoke.PEAK_FP32 * 1e3 == pytest.approx(
        chip_smoke.megakernel_bound_ms(theirs, n, pt, "nee"))


def test_frame_work_scales_a_fixed_subsample():
    t = _ref_tables("cornell")
    kw = dict(width=8, height=8, spp=4, max_depth=8, integrator="path", sampler="uniform")
    a = ref_work.frame_work(t, ref_lights.light_table(t), 5, sample_rays=64, **kw)
    b = ref_work.frame_work(t, ref_lights.light_table(t), 5, sample_rays=64, **kw)
    assert a == b
    assert a[1] == 8 * 8 * 4 * ref_work.BYTES_PER_RAY and a[0] > 8 * 8 * 4 * 100


def test_rounded_to_rounds_float32_results_only():
    x = torch.tensor([1.0 + 2.0**-12, 3.0])
    i = torch.tensor([2**20 + 1])
    with rounded_to(torch.bfloat16):
        y = x * 1.0
        j = i + 0
    assert y[0].item() == 1.0 and j.item() == 2**20 + 1
