"""Differentiable rendering and inverse-render optimisation on the torch
wavefront: counterpart of `cornelis_tpu/diff/`, with its sharded train
step over a mesh of ranks (sharded.py).

render_diff differentiates the detached-sampling estimator: material
gradients (albedo, roughness, emission, tint) are well behaved and checked
against finite differences and jax.grad; geometry (sphere_center,
sphere_radius, plane_point) gets interior gradients only, no silhouette
or visibility term. mode="nee" differentiates the next-event estimator;
render the target with the same mode as the optimisation."""

from .inverse import (
    OPTIMIZABLE_FIELDS,
    InverseRenderer,
    apply_params,
    extract_params,
    make_loss,
    params_from_numpy,
    params_to_numpy,
)
from .render import render_diff
from .sharded import make_sharded_train_step

__all__ = [
    "OPTIMIZABLE_FIELDS",
    "InverseRenderer",
    "apply_params",
    "extract_params",
    "make_loss",
    "make_sharded_train_step",
    "params_from_numpy",
    "params_to_numpy",
    "render_diff",
]
