from .compile import (
    SceneArrays,
    SceneTables,
    compile_scene,
    from_numpy_scene,
    scene_arrays,
    tables_from_arrays,
)
from .description import (
    MaterialDescription,
    PerspectiveCameraDescription,
    PlaneDescription,
    SceneDescription,
    SDFDescription,
    SphereDescription,
)
from .library import BUILTIN_SCENES, cornell_box, cornell_panel, sphere_grid, sphere_on_plane

__all__ = [
    "BUILTIN_SCENES",
    "MaterialDescription",
    "PerspectiveCameraDescription",
    "PlaneDescription",
    "SDFDescription",
    "SceneArrays",
    "SceneDescription",
    "SceneTables",
    "SphereDescription",
    "compile_scene",
    "cornell_box",
    "cornell_panel",
    "from_numpy_scene",
    "scene_arrays",
    "sphere_grid",
    "sphere_on_plane",
    "tables_from_arrays",
]
