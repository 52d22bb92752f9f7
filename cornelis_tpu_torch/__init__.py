"""cornelis_tpu_torch: the cornelis_tpu path tracer on PyTorch and CUDA.

A port of the JAX package `cornelis_tpu` (which stays as the reference)
to PyTorch, with the TPU's Pallas megakernel rewritten as a hand-written
CUDA kernel for Hopper (ops/csrc/megakernel.cu). This package imports
torch and numpy, never jax. It runs the path and NEE integrators with the
uniform and Sobol samplers on spheres, planes and SDF primitives, the
dynamic-scene render (`ops/megakernel.py::render_chunk_dynamic`, spheres
and planes), the warm-up (ops/warm.py) and the TPU-era probes (probes/);
and, on the torch-op wavefront (integrator.py) under autograd, the
differentiable mode (diff/: render_diff and InverseRenderer); and the
render and the inverse-render step over a (tiles, samples) mesh of
torch.distributed ranks (parallel/, diff/sharded.py), each rank's share
traced by the kernel through its pixel-id operand. The render session has
progress, abort, checkpoint/resume and a time budget, agreed by every
rank under a mesh (render.py).

Exports every name of `cornelis_tpu/__init__.py`; `render_chunk` and
`trace_paths` are the torch wavefront's, as there they are the XLA one's.
"""

from .camera import (
    Camera,
    default_camera,
    generate_rays,
    horizontal_fov_35mm,
    look_at,
    look_at_host,
)
from .film import Film
from .integrator import render_chunk, trace_paths
from .math.vec import RGB, Basis, Vec3, construct_basis, cross, dot, mag2, normalize
from .options import RenderOptions
from .parallel import (
    Mesh,
    initialize_distributed,
    make_mesh,
    render_chunk_mesh,
    render_chunk_mesh_megakernel,
)
from .render import (
    ProgressCallback,
    RenderCommand,
    RenderProgress,
    RenderResult,
    RenderSession,
    RenderStatus,
    render_scene,
)
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
    "ProgressCallback",
    "RGB",
    "RenderCommand",
    "RenderOptions",
    "RenderProgress",
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
    "default_camera",
    "dot",
    "from_numpy_scene",
    "generate_rays",
    "horizontal_fov_35mm",
    "initialize_distributed",
    "look_at",
    "look_at_host",
    "mag2",
    "make_mesh",
    "normalize",
    "render_chunk",
    "render_chunk_mesh",
    "render_chunk_mesh_megakernel",
    "render_scene",
    "scene_arrays",
    "sdf_gallery",
    "sphere_grid",
    "sphere_on_plane",
    "tables_from_arrays",
    "trace_paths",
]
