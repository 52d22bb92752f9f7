"""Mesh-sharded differentiable training step.

Counterpart of `cornelis_tpu/diff/sharded.py`: the inverse-render
optimisation (inverse.py) over a (tiles, samples) mesh of ranks
(parallel/). In the JAX package, reverse-mode differentiation through the
shard_map transposes the samples-axis psum and sums the replicated
parameters' cotangents across devices. Here each rank writes both out:

  * the forward is render_chunk_mesh's shard render with gradient (bounces
    unrolled, `detach` as given), its samples all-reduce an autograd
    function whose backward all-reduces the gradient over the same group;
  * each rank's loss is its tiles' share of the dual-buffer loss
    (inverse.make_loss), divided by the samples axis size S: every rank of
    a tile holds the same summed image, so without the factor the tile
    would count S times; the world's sum of the rank losses is the loss;
  * after the backward, every parameter gradient is all-reduced (summed)
    over the world, and the optimiser steps on the same gradient on every
    rank, so the parameters stay replicated.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.distributed as dist

from ..integrator import integrate_pixel_samples
from ..parallel.mesh import Mesh
from ..parallel.render import shard
from ..rng import split
from .inverse import _leaves, apply_params


class _SumOverGroup(torch.autograd.Function):
    """All-reduce (sum) over a process group, whose backward all-reduces
    the incoming gradient over the same group: every rank's loss depends on
    every rank's summand."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def make_sharded_train_step(
    base_scene,
    target: torch.Tensor,
    mesh: Mesh,
    optimizer: torch.optim.Optimizer,
    *,
    width: int,
    height: int,
    spp: int,
    max_depth: int = 8,
    mode: str = "path",
    detach: bool = True,
):
    """A step (params, key) -> loss whose renders run sharded over `mesh`.

    `params` are unconstrained leaves (inverse.extract_params) that
    `optimizer` (torch.optim.Adam, say) was built on; every rank holds the
    same. The step zeroes their gradients, renders the two buffers of the
    dual loss with the two halves of split(key) on this rank's shard,
    backpropagates, sums the gradients over the world, and steps; it
    returns the loss (the world's sum, the same on every rank). The
    gradients stay in `.grad` after it. mode="nee" shards the
    next-event estimator; detach=True the detached-sampling estimator, as
    inverse.make_loss's render_diff."""
    device = base_scene.device
    sh = shard(mesh, width, height, spp, 0, 32, device)  # render_chunk_mesh's tiles, as JAX's
    pixels = sh.pixel_ids.long()
    samples = sh.sample_start + torch.arange(sh.spp, dtype=torch.int64, device=device)
    target = torch.as_tensor(target, dtype=torch.float32, device=device)
    target = target.reshape(-1, 3).index_select(0, pixels)
    scale = 1.0 / (width * height * 3 * mesh.n_samples)

    def render(scene, key):
        part = integrate_pixel_samples(
            scene, key, pixels, samples, width=width, height=height, spp_total=spp,
            max_depth=max_depth, unroll_bounces=True, detach_sampling=detach, mode=mode,
        )
        if mesh.n_samples > 1:
            part = _SumOverGroup.apply(part, mesh.samples_group)
        return part / spp

    def train_step(params: Dict[str, Any], key: torch.Tensor) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=False)
        scene = apply_params(base_scene, params)
        ka, kb = split(key.to(device))
        loss = torch.sum((render(scene, ka) - target) * (render(scene, kb) - target)) * scale
        loss.backward()
        loss = loss.detach()
        if dist.is_initialized():
            for leaf in _leaves(params):
                if leaf.grad is None:  # a leaf the render does not reach
                    leaf.grad = torch.zeros_like(leaf)
                dist.all_reduce(leaf.grad)
            dist.all_reduce(loss)
        optimizer.step()
        return loss

    return train_step
