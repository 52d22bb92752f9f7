"""Path-integrator constants, Russian roulette and the NEE clamp.

Counterpart of `cornelis_tpu/integrator.py:58-65,134-163`. The bounce loop
itself lives in ops/megakernel.py: the CUDA kernel and its plain torch
version.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .math.vec import RGB, mag2

# Russian-roulette constants (Render.cpp:153-165).
RR_BASE = 0.55
RR_YOUNG_SURVIVAL = 0.99
RR_YOUNG_DEPTH = 3
RR_CLAMP_LO = 0.05 / RR_BASE
RR_CLAMP_HI = 0.99

# Bounce-origin offset (Render.cpp:207).
BOUNCE_EPSILON = 1e-4


def russian_roulette_probability(throughput: RGB, depth) -> torch.Tensor:
    """Survival probability (Render.cpp:153-165): 0.99 below depth 3, then
    RR_BASE * clip(|throughput|^2). `depth` is an int or a tensor."""
    power = torch.clamp(mag2(throughput), RR_CLAMP_LO, RR_CLAMP_HI)
    young = torch.as_tensor(depth, device=power.device) < RR_YOUNG_DEPTH
    return torch.where(young, RR_YOUNG_SURVIVAL, RR_BASE * power)


# NEE firefly clamp: per-bounce ceiling = NEE_CLAMP_FACTOR x the brightest
# emission channel (floored at 1), grown by 1/RR_BASE per bounce past the
# young depths (integrator.py:96-134 of the JAX package).
NEE_CLAMP_FACTOR = 16.0
# log(1/RR_BASE) rounded to float32, as jnp.float32(math.log(...)).
_LOG_INV_RR = float(np.float32(math.log(1.0 / RR_BASE)))


def host_nee_clamp(materials: torch.Tensor) -> float:
    """The clamp base from a material table, in float64 on the host
    (pallas_integrator.py::_host_nee_clamp): 16 x max emission channel,
    floored at 1."""
    emission = materials[:, 3:6].detach().cpu().double()
    max_e = float(emission.max()) if emission.numel() else 0.0
    return NEE_CLAMP_FACTOR * max(max_e, 1.0)


def nee_clamp_at_depth(base, depth: int) -> torch.Tensor:
    """base x (1/RR_BASE)^max(depth - 3, 0) in float32, in the exp/log form
    of the JAX package. `base` is a float or a float32 tensor."""
    excess = torch.tensor(float(max(depth - RR_YOUNG_DEPTH, 0)), dtype=torch.float32)
    growth = torch.exp(excess * _LOG_INV_RR)
    base = torch.as_tensor(base, dtype=torch.float32)
    return base * growth.to(base.device)
