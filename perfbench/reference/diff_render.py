"""Differentiable render: the wavefront under autograd.

Counterpart of `cornelis_tpu/diff/render.py`. Pixel gradients with
respect to scene parameters (material albedo, emission, tint, roughness,
sphere centres and radii, plane points) through the Monte Carlo path
tracing estimator, by torch autograd on the wavefront (integrator.py),
each bounce checkpointed.

Estimator: detached sampling (the default): sampled directions, their
densities and the Russian-roulette probabilities are detached; gradients
flow through the BSDF, emission, the cosine and, in mode "nee", the MIS
weights, and through the hit geometry (interior gradients: silhouettes
and visibility are not differentiated). detach=False differentiates the
sampler as well: higher variance, but its gradient is the derivative of
this very function, which the finite-difference tests check.
"""

from __future__ import annotations

import torch

from .integrator import integrate_pixel_samples


def render_diff(scene, root_key: torch.Tensor, *, width: int, height: int, spp: int,
                max_depth: int = 8, detach: bool = True, mode: str = "path") -> torch.Tensor:
    """(H, W, 3) radiance means over spp, differentiable in every float
    field of the SceneArrays `scene`. The draws depend on `root_key` and
    the (pixel, sample) only, so with a common key the render is a
    deterministic function of the scene: finite differences against it
    see no Monte Carlo noise. Runs on the scene's device."""
    device = scene.device
    pixel_ids = torch.arange(width * height, dtype=torch.int64, device=device)
    sample_idx = torch.arange(spp, dtype=torch.int64, device=device)
    sums = integrate_pixel_samples(
        scene, root_key.to(device), pixel_ids, sample_idx, width=width, height=height,
        spp_total=spp, max_depth=max_depth, unroll_bounces=True, detach_sampling=detach,
        mode=mode,
    )
    return sums.reshape(height, width, 3) / spp
