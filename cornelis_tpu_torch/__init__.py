"""cornelis_tpu_torch: the cornelis_tpu path tracer on PyTorch and CUDA.

A port of the JAX package `cornelis_tpu` (which stays as the reference)
to PyTorch, with the TPU's Pallas megakernel rewritten as a hand-written
CUDA kernel for Hopper (ops/csrc/megakernel.cu). This package imports
torch and numpy, never jax. It runs the path and NEE integrators with the
uniform and Sobol samplers on spheres, planes and SDF primitives, the
dynamic-scene render (ops/dynamic.py, spheres and planes), the warm-up
(ops/warm.py) and the TPU-era probes (probes/); and, on the torch-op
wavefront (integrator.py) under autograd, the differentiable mode
(diff/: render_diff and InverseRenderer); and the render and the
inverse-render step over a (tiles, samples) mesh of torch.distributed
ranks (parallel/, diff/sharded.py), each rank's share traced by the
kernel through its pixel-id operand.
"""

from .camera import Camera, generate_rays, look_at_host
from .film import Film
from .math.vec import RGB, Basis, Vec3, construct_basis, cross, dot, mag2, normalize
from .options import RenderOptions
from .parallel import (
    Mesh,
    initialize_distributed,
    make_mesh,
    render_chunk_mesh,
    render_chunk_mesh_megakernel,
)
from .render import RenderResult, RenderSession, RenderStatus
from .scene.compile import (
    SceneArrays,
    SceneTables,
    compile_scene,
    from_numpy_scene,
    scene_arrays,
    tables_from_arrays,
)
from .scene.description import (
    MaterialDescription,
    PerspectiveCameraDescription,
    PlaneDescription,
    SceneDescription,
    SDFDescription,
    SphereDescription,
)
from .scene.library import (
    BUILTIN_SCENES,
    cornell_box,
    cornell_panel,
    sdf_gallery,
    sphere_grid,
    sphere_on_plane,
)

__version__ = "0.1.0"

__all__ = [
    "BUILTIN_SCENES",
    "Basis",
    "Camera",
    "Film",
    "MaterialDescription",
    "Mesh",
    "PerspectiveCameraDescription",
    "PlaneDescription",
    "RGB",
    "RenderOptions",
    "RenderResult",
    "RenderSession",
    "RenderStatus",
    "SDFDescription",
    "SceneArrays",
    "SceneDescription",
    "SceneTables",
    "SphereDescription",
    "Vec3",
    "compile_scene",
    "construct_basis",
    "cornell_box",
    "cornell_panel",
    "cross",
    "dot",
    "from_numpy_scene",
    "generate_rays",
    "initialize_distributed",
    "look_at_host",
    "mag2",
    "make_mesh",
    "normalize",
    "render_chunk_mesh",
    "render_chunk_mesh_megakernel",
    "scene_arrays",
    "sdf_gallery",
    "sphere_grid",
    "sphere_on_plane",
    "tables_from_arrays",
]
