"""The port's probes: the TPU-era benchmark kernels as CUDA kernels.

`scene_table` is the sphere-scan probe of table placement (K5 baked, K6
dynamic; benchmarks/dynamic_scene_probe.py), `bf16` the f32 against bf16
arithmetic probe (K4; benchmarks/bf16_probe.py). Each module holds its
kernels' wrappers, their plain torch versions and a command-line timing.
`scan_designs` times K4's, K5's and K6's other designs against the
kernels the probes launch.
"""

import numpy as np
import torch


def linspace_f32(stop: float, num: int, device="cpu") -> torch.Tensor:
    """jnp.linspace(0, stop, num, dtype=float32), value for value: jax
    lowers it to iota times the float32 step stop / (num - 1)."""
    step = float(np.float32(stop) / np.float32(num - 1))
    return torch.arange(num, dtype=torch.float32, device=device) * step
