"""Inverse rendering: recover scene parameters from a target image.

Counterpart of `cornelis_tpu/diff/inverse.py` (BASELINE.json config 4):
Adam on the MSE between the differentiable render and a target. The
optimised fields live in unconstrained space: sigmoid for albedo and
tint (in (0, 1)), softplus for emission and roughness (> 0), identity
for positions and radii, so a step cannot leave the physical domain.
`torch.optim.Adam` with its defaults (0.9, 0.999, eps 1e-8 outside the
square root) is optax.adam's update. Keys are the JAX package's: the
step key is fold_in(root, step) (the root itself with "fixed"), and
"dual" splits it in two.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence

import torch

from .vec import Vec3, clip, maximum
from .rng import fold_in, make_key, split
from .diff_render import render_diff

# SceneArrays fields that may be optimised, by domain transform.
_UNIT_FIELDS = ("mat_albedo", "mat_tint")  # sigmoid -> (0, 1)
_POSITIVE_FIELDS = ("mat_emission", "mat_roughness")  # softplus -> (0, inf)
_FREE_FIELDS = ("sphere_center", "sphere_radius", "plane_point")  # identity

OPTIMIZABLE_FIELDS = _UNIT_FIELDS + _POSITIVE_FIELDS + _FREE_FIELDS

_EPS = 1e-6


def _map(value, fn):
    if isinstance(value, Vec3):
        return Vec3(*(fn(c) for c in value))
    return fn(value)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.softplus, logaddexp(x, 0): max(x, 0) + log1p(exp(-|x|))."""
    return maximum(x, 0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def _to_unconstrained(field: str, value):
    def fwd(x):
        if field in _UNIT_FIELDS:
            x = clip(x, _EPS, 1.0 - _EPS)
            return torch.log(x) - torch.log1p(-x)  # logit
        if field in _POSITIVE_FIELDS:
            x = maximum(x, _EPS)
            return x + torch.log(-torch.expm1(-x))  # softplus inverse
        return x

    return _map(value, fwd)


def _to_constrained(field: str, value):
    def fwd(x):
        if field in _UNIT_FIELDS:
            return torch.sigmoid(x)
        if field in _POSITIVE_FIELDS:
            return _softplus(x)
        return x

    return _map(value, fwd)


def _leaves(params: Dict[str, Any]):
    for value in params.values():
        yield from (value if isinstance(value, Vec3) else (value,))


def extract_params(scene, fields: Sequence[str]) -> Dict[str, Any]:
    """The chosen fields of a SceneArrays in unconstrained space: new leaf
    tensors (Vec3s of them for 3-vector fields) that require grad."""
    bad = set(fields) - set(OPTIMIZABLE_FIELDS)
    if bad:
        raise ValueError(f"not optimizable: {sorted(bad)}; choose from {OPTIMIZABLE_FIELDS}")
    with torch.no_grad():
        params = {f: _to_unconstrained(f, getattr(scene, f)) for f in fields}
    params = {f: _map(v, lambda t: t.detach().clone().requires_grad_(True))
              for f, v in params.items()}
    return params


def apply_params(scene, params: Dict[str, Any]):
    """Write unconstrained params back into a SceneArrays, through the
    domain transforms."""
    return scene._replace(**{f: _to_constrained(f, v) for f, v in params.items()})


def make_loss(base_scene, target: torch.Tensor, *, width: int, height: int, spp: int,
              max_depth: int = 8, key_strategy: str = "dual", weight=None,
              mode: str = "path"):
    """MSE against `target` as a function of (unconstrained params, key).

    key_strategy: "dual" (the default) renders twice with the two halves
    of split(key) and returns mean((A - t)(B - t)), an unbiased estimate
    of the MSE of the expected image (plain MSE of one noisy render also
    rewards a darker, less noisy scene); "per_step" is plain MSE on a key
    per step; "fixed" plain MSE on one key (InverseRenderer keeps it).
    mode: "path" or "nee", as render_diff; render the target with the
    same one. weight: an optional (H, W) or (H, W, 1|3) per-pixel weight,
    the loss normalised by its mean (zero-weight pixels whose target
    clipped, say)."""
    if key_strategy not in ("dual", "per_step", "fixed"):
        raise ValueError(f"unknown key_strategy {key_strategy!r}")
    device = base_scene.device
    target = torch.as_tensor(target, dtype=torch.float32, device=device)
    if weight is not None:
        weight = torch.as_tensor(weight, dtype=torch.float32, device=device)
        if weight.ndim == 2:
            weight = weight[:, :, None]
        # Mean over the weighted mass, so the scale matches the unweighted loss.
        norm = maximum(torch.mean(weight), 1e-8)

    def render(scene, key):
        return render_diff(scene, key, width=width, height=height, spp=spp,
                           max_depth=max_depth, mode=mode)

    def mse(prod):
        if weight is None:
            return torch.mean(prod)
        return torch.mean(prod * weight) / norm

    def loss_fn(params: Dict[str, Any], key: torch.Tensor) -> torch.Tensor:
        scene = apply_params(base_scene, params)
        if key_strategy == "dual":
            ka, kb = split(key)
            return mse((render(scene, ka) - target) * (render(scene, kb) - target))
        return mse((render(scene, key) - target) ** 2)

    return loss_fn


class InverseRenderer:
    """Adam-on-MSE inverse rendering on the scene's device.

    >>> inv = InverseRenderer(scene, target, fields=("mat_albedo",),
    ...                       width=64, height=64, spp=32)
    >>> losses = inv.run(100)
    >>> recovered = inv.scene()
    """

    def __init__(self, scene, target, fields: Sequence[str] = ("mat_albedo",), *, width: int,
                 height: int, spp: int, max_depth: int = 8, learning_rate: float = 5e-2,
                 seed: int = 0, key_strategy: str = "dual", weight=None, mode: str = "path"):
        self.base_scene = scene
        self.params = extract_params(scene, fields)
        self.optimizer = torch.optim.Adam(list(_leaves(self.params)), lr=learning_rate)
        self.step_count = 0
        self._root_key = make_key(seed, scene.device)
        self._fixed = key_strategy == "fixed"
        self._loss = make_loss(scene, target, width=width, height=height, spp=spp,
                               max_depth=max_depth, key_strategy=key_strategy, weight=weight,
                               mode=mode)

    def step_key(self) -> torch.Tensor:
        """The key of the next step: fold_in(root, step), or the root."""
        return self._root_key if self._fixed else fold_in(self._root_key, self.step_count)

    def _step(self) -> torch.Tensor:
        self.optimizer.zero_grad(set_to_none=True)
        loss = self._loss(self.params, self.step_key())
        loss.backward()
        self.optimizer.step()
        self.step_count += 1
        return loss.detach()

    def step(self) -> float:
        """One Adam step; the loss before it."""
        return float(self._step())

    def scene(self):
        """The scene with the current params, detached."""
        with torch.no_grad():
            return apply_params(self.base_scene, self.params)

    def run(self, steps: int) -> list:
        """`steps` Adam steps; their losses, read from the device once at
        the end."""
        losses = [self._step() for _ in range(steps)]
        return torch.stack(losses).tolist() if losses else []
