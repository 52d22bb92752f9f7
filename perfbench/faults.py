"""Faults planted under the timed path, to show that the comparison that
decides `correct` catches them: used by the CPU tests
(tests/test_perfbench_control.py) and, on the card, by
`calibrate.py --fault`. A benchmark run never plants one.

Each is a context manager that patches the program at the name its caller
looks up and restores it on exit:

  * "state unchanged": a frame's film never takes a chunk; an inverse
    step leaves the parameters and Adam's state as they were.
  * "half the batch": each chunk traces half its samples per pixel,
    weighted twice (the mean over the rest); the loss over the top half of
    the image only.
  * "answer altered": each chunk's sums, or each differentiable render,
    x 1.05 where it is made: an image 5% off in every pixel.

The cells run on one card, so the fault "the exchange between chips left
out" has no place here.
"""

import contextlib

import torch

FAULTS = ("state unchanged", "half the batch", "answer altered")


@contextlib.contextmanager
def _patched(owner, attr, make):
    original = getattr(owner, attr)
    setattr(owner, attr, make(original))
    try:
        yield
    finally:
        setattr(owner, attr, original)


def frame_fault(fault):
    from cornelis_tpu_torch import render
    from cornelis_tpu_torch.film import Film

    if fault == "state unchanged":  # the film never takes a chunk
        return _patched(Film, "add_samples", lambda f: lambda self, chunk, n: None)
    if fault == "half the batch":  # each chunk traces half its samples, weighted twice
        def half(f):
            def chunk(tables, key, offset, *, spp_chunk, **kw):
                return 2.0 * f(tables, key, offset, spp_chunk=max(1, spp_chunk // 2), **kw)
            return chunk
        return _patched(render, "render_chunk", half)
    if fault == "answer altered":  # each chunk's sums altered where they are made
        return _patched(render, "render_chunk",
                        lambda f: lambda *a, **kw: f(*a, **kw) * 1.05)
    raise ValueError(fault)


def inverse_fault(fault):
    from cornelis_tpu_torch.diff import inverse

    if fault == "state unchanged":  # a step that leaves the parameters and Adam as they were
        def frozen(f):
            def step(self):
                self.optimizer.zero_grad(set_to_none=True)
                loss = self._loss(self.params, self.step_key())
                self.step_count += 1
                return loss.detach()
            return step
        return _patched(inverse.InverseRenderer, "_step", frozen)
    if fault == "half the batch":  # the loss over the top half of the image only
        def half(f):
            def make_loss(scene, target, **kw):
                weight = torch.zeros(target.shape[:2], device=target.device)
                weight[: target.shape[0] // 2] = 1.0
                return f(scene, target, **{**kw, "weight": weight})
            return make_loss
        return _patched(inverse, "make_loss", half)
    if fault == "answer altered":  # every render altered where it is made
        return _patched(inverse, "render_diff", lambda f: lambda *a, **kw: f(*a, **kw) * 1.05)
    raise ValueError(fault)


def planted(kind: str, fault: str):
    """The fault `fault` for a cell of traffic kind `kind`."""
    return {"frame": frame_fault, "inverse": inverse_fault}[kind](fault)
