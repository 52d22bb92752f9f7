"""The control of the comparison: the reference computed in a lower
precision than the configuration states.

Inside `rounded_to(torch.bfloat16)` every float32 tensor that a torch
function or tensor method returns is rounded to bfloat16 and back, as an
operation computed in bfloat16 rounds its result; integer tensors (the
draws' words) are left as they are. Results of in-place operations are
rounded in the value they return but not in the tensor they wrote, so
the control is, if anything, more precise than bfloat16 throughout.
"""

from __future__ import annotations

import contextlib

import torch
from torch.overrides import TorchFunctionMode


def _round(value, dtype):
    if isinstance(value, torch.Tensor) and value.dtype == torch.float32:
        return value.to(dtype).to(torch.float32)
    if isinstance(value, tuple) and not hasattr(value, "_fields"):
        return tuple(_round(v, dtype) for v in value)
    return value


class _RoundedTo(TorchFunctionMode):
    def __init__(self, dtype):
        super().__init__()
        self.dtype = dtype

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if args and out is args[0]:  # in place: leave the written tensor be
            return out
        return _round(out, self.dtype)


@contextlib.contextmanager
def rounded_to(dtype=torch.bfloat16):
    """Within the block, torch's float32 results are rounded to `dtype`."""
    with _RoundedTo(dtype):
        yield
