"""Built-in scenes.

`cornell_box` is the reference's shipped scene, reproduced as *data* from
src/cornelis.cpp:6-74 (the hard-coded Cornell box with colored walls, an
emissive sphere light and three spheres including a low-roughness "gold"
one). `sphere_on_plane` is the first-milestone scene from BASELINE.json
config 1 (diffuse sphere + ground plane).

A copy of `cornelis_tpu/scene/library.py` (the descriptions are plain
data; see scene/description.py for why it is copied). `sdf_gallery`
renders through the SDF instantiations of the megakernel.
"""

from __future__ import annotations

from .description import (
    MaterialDescription,
    PerspectiveCameraDescription,
    PlaneDescription,
    SceneDescription,
    SDFDescription,
    SphereDescription,
)


def cornell_box() -> SceneDescription:
    """The reference's Cornell scene (src/cornelis.cpp:6-74)."""
    side = 555.0
    half = 550.0 / 2.0

    scene = SceneDescription()
    scene.set_camera(
        PerspectiveCameraDescription(
            origin=(0.0, half, -1100.0),
            look_at=(0.0, half, 0.0),
            aspect=1.0,
            horizontal_fov=0.7,
        )
    )

    red = scene.add_material(MaterialDescription(albedo=(0.65, 0.05, 0.05)))
    white = scene.add_material(MaterialDescription(albedo=(0.73, 0.73, 0.73)))
    green = scene.add_material(MaterialDescription(albedo=(0.12, 0.45, 0.15)))
    gold = scene.add_material(
        MaterialDescription(
            albedo=(0.0, 0.0, 0.0),
            emissive=(0.0, 0.0, 0.0),
            roughness=0.01,
            reflection_tint=(0.916, 0.61, 0.0),
            ior=0.470,
        )
    )
    light = scene.add_material(
        MaterialDescription(albedo=(0.0, 0.0, 0.0), emissive=(15.0, 15.0, 15.0))
    )

    scene.add_plane(
        PlaneDescription(
            normal=(1.0, 0.0, 0.0),
            point=(-half, half, 0.0),
            extents=(side, side, 0.0),
            material=green,
        )
    )
    scene.add_plane(
        PlaneDescription(
            normal=(-1.0, 0.0, 0.0),
            point=(half, half, 0.0),
            extents=(side, side, 0.0),
            material=red,
        )
    )
    scene.add_plane(
        PlaneDescription(
            normal=(0.0, -1.0, 0.0),
            point=(0.0, side, 0.0),
            extents=(side, side, 0.0),
            material=white,
        )
    )
    scene.add_plane(
        PlaneDescription(
            normal=(0.0, 1.0, 0.0),
            point=(0.0, 0.0, 0.0),
            extents=(side, side, 0.0),
            material=white,
        )
    )
    scene.add_plane(
        PlaneDescription(
            normal=(0.0, 0.0, -1.0),
            point=(0.0, half, half),
            extents=(side, side, 0.0),
            material=white,
        )
    )

    scene.add_sphere(
        SphereDescription(center=(0.0, side - 60.0, 0.0), radius=60.0, material=light)
    )
    scene.add_sphere(SphereDescription(center=(0.0, 50.0, 0.0), radius=50.0, material=red))
    scene.add_sphere(
        SphereDescription(center=(-160.0, 100.0, 0.0), radius=100.0, material=white)
    )
    scene.add_sphere(
        SphereDescription(center=(160.0, 125.0, 200.0), radius=125.0, material=gold)
    )

    return scene


def cornell_panel() -> SceneDescription:
    """The CLASSIC Cornell box: a rectangular ceiling AREA LIGHT instead of
    the reference's ceiling-tangent light sphere (src/cornelis.cpp:63-65
    approximates the panel with a sphere). Same geometry, materials, and
    camera as `cornell_box`; the emitter is a 185x185 panel dropped just
    below the ceiling with L scaled by the surface-area ratio
    (15 x 4 pi 60^2 / 185^2 ~= 19.85). The panel is TWO-SIDED (emission
    on any hit), so half its power radiates into the 1-unit panel/ceiling
    gap and is mostly reabsorbed -- the room-facing power is therefore
    approximate, not an exact match; measured room brightness lands
    within ~3% of the sphere-lit original (test_nee.py TestCornellPanel).
    Showcases the round-4 plane-emitter NEE: rectangle lights are
    area-sampled with MIS, so `--integrator nee` converges as fast here
    as the sphere-lit original."""
    scene = cornell_box()
    # Locate the light material by its emission rather than hardcoding its
    # index -- a reordering inside cornell_box would otherwise silently
    # attach the panel to the wrong material (advisor finding, round 4).
    emitters = [
        i for i, m in enumerate(scene.materials) if any(c > 0.0 for c in m.emissive)
    ]
    assert len(emitters) == 1, f"cornell_box grew {len(emitters)} emitters"
    light = emitters[0]
    # Drop the sphere light and replace the light material's power with the
    # matched-panel value.
    scene.spheres = [s for s in scene.spheres if s.material != light]
    import math

    side = 555.0
    panel = 185.0
    le = 15.0 * 4.0 * math.pi * 60.0**2 / panel**2
    scene.materials[light].emissive = (le, le, le)
    scene.add_plane(
        PlaneDescription(
            normal=(0.0, -1.0, 0.0),
            point=(0.0, side - 1.0, 0.0),
            extents=(panel, panel, 0.0),
            material=light,
        )
    )
    return scene


def sphere_on_plane() -> SceneDescription:
    """Diffuse sphere + ground plane under an emissive dome-ish light sphere
    (BASELINE.json config 1: first-milestone scene)."""
    scene = SceneDescription()
    scene.set_camera(
        PerspectiveCameraDescription(
            origin=(0.0, 2.0, -8.0),
            look_at=(0.0, 1.0, 0.0),
            aspect=1.0,
            horizontal_fov=0.7,
        )
    )
    diffuse = scene.add_material(MaterialDescription(albedo=(0.6, 0.6, 0.6)))
    ground = scene.add_material(MaterialDescription(albedo=(0.4, 0.45, 0.5)))
    light = scene.add_material(
        MaterialDescription(albedo=(0.0, 0.0, 0.0), emissive=(20.0, 20.0, 20.0))
    )

    scene.add_sphere(SphereDescription(center=(0.0, 1.0, 0.0), radius=1.0, material=diffuse))
    scene.add_sphere(SphereDescription(center=(3.0, 6.0, -2.0), radius=2.0, material=light))
    scene.add_plane(
        PlaneDescription(
            normal=(0.0, 1.0, 0.0),
            point=(0.0, 0.0, 0.0),
            extents=(40.0, 40.0, 0.0),
            material=ground,
        )
    )
    return scene


def sdf_gallery() -> SceneDescription:
    """Implicit-surface demo (BASELINE.json config 5 stand-in): a torus, a
    box, and an SDF sphere on a ground plane under an emissive sphere."""
    scene = SceneDescription()
    scene.set_camera(
        PerspectiveCameraDescription(
            origin=(0.0, 2.5, -9.0),
            look_at=(0.0, 1.0, 0.0),
            aspect=1.0,
            horizontal_fov=0.7,
        )
    )
    red = scene.add_material(MaterialDescription(albedo=(0.65, 0.08, 0.08)))
    blue = scene.add_material(MaterialDescription(albedo=(0.1, 0.2, 0.6)))
    gold = scene.add_material(
        MaterialDescription(
            albedo=(0.1, 0.08, 0.02),
            roughness=0.15,
            reflection_tint=(0.916, 0.61, 0.0),
            ior=0.47,
        )
    )
    ground = scene.add_material(MaterialDescription(albedo=(0.5, 0.5, 0.5)))
    light = scene.add_material(
        MaterialDescription(albedo=(0.0, 0.0, 0.0), emissive=(18.0, 18.0, 18.0))
    )

    scene.add_sdf(
        SDFDescription(kind="torus", center=(-2.4, 1.0, 0.0), params=(1.0, 0.4, 0.0, 0.0), material=red)
    )
    scene.add_sdf(
        SDFDescription(kind="box", center=(0.0, 0.8, 0.6), params=(0.8, 0.8, 0.8, 0.0), material=blue)
    )
    scene.add_sdf(
        SDFDescription(kind="sphere", center=(2.4, 1.0, 0.0), params=(1.0, 0.0, 0.0, 0.0), material=gold)
    )
    scene.add_sphere(SphereDescription(center=(2.0, 7.0, -3.0), radius=2.0, material=light))
    scene.add_plane(
        PlaneDescription(
            normal=(0.0, 1.0, 0.0),
            point=(0.0, 0.0, 0.0),
            extents=(50.0, 50.0, 0.0),
            material=ground,
        )
    )
    return scene


def sdf_gallery_transformed() -> SceneDescription:
    """`sdf_gallery` with its torus and box turned about their own centres
    and uniformly scaled (0.8 and 1.25): SDFs under a transform. Not a
    builtin of the JAX package; the port's tests and chip_smoke.py carry
    it to the JAX package through `to_json`."""
    import math

    import numpy as np

    def turned(center, ax, ay, scale):
        cx, sx, cy, sy = math.cos(ax), math.sin(ax), math.cos(ay), math.sin(ay)
        r = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]]) @ np.array(
            [[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
        m = np.eye(4)
        m[:3, :3] = scale * r
        m[:3, 3] = np.asarray(center) - scale * (r @ np.asarray(center))
        return m.tolist()

    scene = sdf_gallery()
    torus, box = scene.sdfs[0], scene.sdfs[1]
    torus.transform = turned(torus.center, 0.9, 0.3, 0.8)
    box.transform = turned(box.center, 0.4, 0.7, 1.25)
    return scene


def sphere_grid(n: int = 64) -> SceneDescription:
    """Procedural stress scene: an n-sphere grid over a ground plane with an
    emissive sky sphere -- n+1 spheres, 1 plane, ~n/8 materials.

    Exists to measure and test how the Pallas megakernel scales with object
    count (its object loop is baked/unrolled at compile time; the library's
    hand-built scenes top out at ~10 objects, so nothing exercised larger
    tables before -- VERDICT r2 #6). Deterministic layout: sphere k sits at
    grid position (k % side, k // side) with radius and height varied by a
    fixed integer hash, no RNG.
    """
    scene = SceneDescription()
    side = max(1, int(round(n ** 0.5)))
    scene.set_camera(
        PerspectiveCameraDescription(
            origin=(side * 1.5, side * 2.0, -side * 3.0),
            look_at=(side * 1.5, 0.5, side * 1.5),
            aspect=1.0,
            horizontal_fov=0.9,
        )
    )
    ground = scene.add_material(MaterialDescription(albedo=(0.45, 0.45, 0.45)))
    mats = [
        scene.add_material(
            MaterialDescription(
                albedo=(0.2 + 0.6 * ((m * 7) % 8) / 7.0,
                        0.2 + 0.6 * ((m * 3) % 8) / 7.0,
                        0.2 + 0.6 * ((m * 5) % 8) / 7.0),
                roughness=0.1 + 0.8 * (m % 4) / 3.0,
            )
        )
        for m in range(max(1, n // 8))
    ]
    light = scene.add_material(
        MaterialDescription(albedo=(0.0, 0.0, 0.0), emissive=(8.0, 8.0, 8.0))
    )

    for k in range(n):
        h = (k * 2654435761) & 0xFFFF  # Knuth multiplicative hash, fixed
        radius = 0.35 + 0.4 * (h % 97) / 96.0
        scene.add_sphere(
            SphereDescription(
                center=(
                    3.0 * (k % side) + 0.002 * (h % 31),
                    radius + 0.8 * ((h >> 5) % 17) / 16.0,
                    3.0 * (k // side),
                ),
                radius=radius,
                material=mats[k % len(mats)],
            )
        )
    scene.add_sphere(
        SphereDescription(
            center=(side * 1.5, side * 12.0, side * 1.5),
            radius=side * 4.0,
            material=light,
        )
    )
    scene.add_plane(
        PlaneDescription(
            normal=(0.0, 1.0, 0.0),
            point=(0.0, 0.0, 0.0),
            extents=(side * 30.0, side * 30.0, 0.0),
            material=ground,
        )
    )
    return scene


BUILTIN_SCENES = {
    "cornell": cornell_box,
    "cornell-panel": cornell_panel,
    "sphere-plane": sphere_on_plane,
    "sdf-gallery": sdf_gallery,
    "sphere-grid": sphere_grid,
}
