"""Traffic kind "inverse": one closed-loop client taking inverse-render
steps, `cornelis_tpu_torch.diff.inverse.InverseRenderer.step()` in a loop.

The traffic file gives the optimised `fields`, `learning_rate`,
`key_strategy`, `mode`, `width`, `height`, `spp` a render, `max_depth`
and the `start`: the true scene's albedos x albedo_scale + albedo_offset,
clamped to [albedo_min, albedo_max], and every roughness set to
`roughness`. The target is an input: the frozen reference renders it at
set-up from the true scene with a key from the run's seed, and hands the
same tensor to the program and to the reference's check. Its seconds are
the reference's and are left out of `setup_s` (`run.reference_s`).

Set-up builds the one InverseRenderer that the window drives, with seed =
run seed mod 2^32, and takes its first CHECK_STEPS steps through the same
`step()`, on their own step keys: the warm-up, and the readings that the
check compares (each step's loss; every leaf's first gradient as Adam got
it, exp_avg / (1 - beta1) after one step; every leaf's change after the
CHECK_STEPS steps). The window's peak memory is read after
`reset_peak_memory_stats()` at its start. Before each window step the
window keeps a copy of the leaves and Adam's state (a few small tensors),
so that the last step's start, loss and result are at hand once it has
closed. The traced run profiles steps PROFILE_FROM to PROFILE_FROM +
PROFILE_STEPS - 1 of the window.

The check builds the frozen reference's own InverseRenderer from its own
compile of the scene, the same start, target and settings, takes
CHECK_STEPS steps and compares, by the worst step or leaf: `loss_gap`,
|loss - reference| / |reference|; `grad_gap` and `change_gap`, the gap
between the program's and the reference's norm of a leaf over the larger
of the reference's norm of that leaf and of the median leaf. A leaf whose
reference gradient is under a thousandth of the median leaf's is left
out of a change (Adam moves such a leaf by round-off alone). It then
follows the window's last step from the program's own state at its start
(the leaves, Adam's state and the step count, hence the step's key): a
second reference InverseRenderer takes that one step, and
`last_loss_gap` and `last_change_gap` compare its loss and each leaf's
change as above. The reference can reach that step only from the
program's state; the start and the first steps are held by the readings
before, which take nothing from the program.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from perfbench import tracing
from perfbench.harness import Check, finite
from perfbench.reference import compile as ref_compile
from perfbench.reference import description as ref_description
from perfbench.reference import diff_render as ref_diff_render
from perfbench.reference import inverse as ref_inverse
from perfbench.reference import rng as ref_rng
from perfbench.reference.lowp import rounded_to
from perfbench.reference.vec import Vec3 as RefVec3

CHECK_STEPS = 3
PROFILE_FROM = 1
PROFILE_STEPS = 2
# fold_in constant of the target's key, so that its draws are not a step's.
TARGET_FOLD = 0x7A6E7
# Leaves whose reference first gradient is under this share of the median
# leaf's are left out of change_gap.
ROUND_OFF_LEAF = 1e-3
_MASK32 = (1 << 32) - 1


def start_scene(scene, start: dict, vec3):
    """The inverse problem's start: a SceneArrays with the albedos pulled
    toward grey and one roughness everywhere (tools/r5_inverse.py)."""
    lo, hi = start["albedo_min"], start["albedo_max"]
    albedo = vec3(*(torch.clamp(c * start["albedo_scale"] + start["albedo_offset"], lo, hi)
                    for c in scene.mat_albedo))
    return scene._replace(mat_albedo=albedo,
                          mat_roughness=torch.full_like(scene.mat_roughness, start["roughness"]))


def leaves(params: dict, fields) -> list:
    """(name, tensor) of the optimised leaves, in the optimizer's order."""
    out = []
    for f in fields:
        value = params[f]
        if isinstance(value, tuple):  # a Vec3 of leaves
            out += [(f"{f}.{c}", v) for c, v in zip("xyz", value)]
        else:
            out.append((f, value))
    return out


def first_steps(inv, fields, steps: int, step=None) -> dict:
    """Take `steps` steps of `inv` through `step` (inv.step by default) and
    read what the check compares."""
    step = step or inv.step
    named = leaves(inv.params, fields)
    before = [v.detach().clone() for _, v in named]
    beta1 = inv.optimizer.param_groups[0]["betas"][0]
    losses, grads = [], []
    for k in range(steps):
        losses.append(float(step()))
        if k == 0:  # an optimizer that holds no state for a leaf got no gradient
            grads = [float(torch.linalg.vector_norm(inv.optimizer.state[v]["exp_avg"]))
                     / (1.0 - beta1) if "exp_avg" in inv.optimizer.state.get(v, {}) else 0.0
                     for _, v in named]
    changes = [float(torch.linalg.vector_norm(v.detach() - b))
               for (_, v), b in zip(named, before)]
    return {"leaves": [n for n, _ in named], "losses": losses, "grad_norms": grads,
            "change_norms": changes}


def _reference_scene(run):
    desc = ref_description.SceneDescription.from_dict(run.cell.config["scene"])
    return ref_compile.scene_arrays(ref_compile.compile_scene(desc, device=run.device))


def _settings(t: dict) -> dict:
    return dict(width=t["width"], height=t["height"], spp=t["spp"], max_depth=t["max_depth"])


def make_target(run) -> torch.Tensor:
    """The target image, rendered by the frozen reference from the true
    scene with the key fold_in(key(seed), TARGET_FOLD); its seconds are
    added to run.reference_s."""
    t = run.cell.traffic
    t0 = time.perf_counter()
    key = ref_rng.fold_in(ref_rng.make_key(run.seed & _MASK32, run.device), TARGET_FOLD)
    with torch.no_grad():
        target = ref_diff_render.render_diff(_reference_scene(run), key, mode=t["mode"],
                                             **_settings(t)).detach()
    if torch.device(run.device).type == "cuda":
        torch.cuda.synchronize()
    run.reference_s += time.perf_counter() - t0
    return target


def _renderer(module, scene, target, run):
    t = run.cell.traffic
    return module.InverseRenderer(
        scene, target, fields=tuple(t["fields"]), learning_rate=t["learning_rate"],
        seed=run.seed & _MASK32, key_strategy=t["key_strategy"], mode=t["mode"], **_settings(t))


def setup(run) -> dict:
    import cornelis_tpu_torch as ct
    from cornelis_tpu_torch.diff import inverse as ct_inverse
    from cornelis_tpu_torch.math.vec import Vec3

    t = run.cell.traffic
    target = make_target(run)
    scene = ct.scene_arrays(ct.compile_scene(ct.SceneDescription.from_dict(run.cell.config["scene"]),
                                             device=run.device))
    inv = _renderer(ct_inverse, start_scene(scene, t["start"], Vec3), target, run)
    first = first_steps(inv, t["fields"], CHECK_STEPS)
    run.note(f"first {CHECK_STEPS} steps (set-up): {first}")
    if run.trace:
        tracing.warm_profiler(run.device)
    return {"inv": inv, "first": first, "target": target.cpu()}


def _cloned(adam: dict) -> dict:
    return {k: x.clone() if torch.is_tensor(x) else x for k, x in adam.items()}


def snapshot(inv, fields) -> dict:
    """Copies of the leaves, Adam's state of each and the step count."""
    named = leaves(inv.params, fields)
    return {"step_count": inv.step_count,
            "values": [v.detach().clone() for _, v in named],
            "adam": [_cloned(inv.optimizer.state.get(v, {})) for _, v in named]}


def window(state: dict, run) -> dict:
    inv = state["inv"]
    fields = run.cell.traffic["fields"]
    on_cuda = torch.device(run.device).type == "cuda"
    profile: dict = {}
    if on_cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    losses = []

    def step():
        nonlocal before
        before = snapshot(inv, fields)
        losses.append(inv.step())  # returns a float: the step is done

    before = None
    start = time.perf_counter()
    while True:
        if run.trace and len(losses) == PROFILE_FROM:
            with tracing.profiled(profile, run.device):
                for _ in range(PROFILE_STEPS):
                    step()
            profile["steps"] = PROFILE_STEPS
        else:
            step()
        if time.perf_counter() - start >= run.seconds:
            break
    window_s = time.perf_counter() - start
    last = {"before": before, "loss": losses[-1],
            "after": [v.detach().clone() for _, v in leaves(inv.params, fields)]}
    record = {
        "kind": "inverse",
        "attempted": len(losses),
        "failed": 0,
        "steps": len(losses),
        "window_s": window_s,
        "window_peak_bytes": torch.cuda.max_memory_allocated() if on_cuda else None,
        "first": state["first"],
        "last": last,
        "target": state["target"],
    }
    if profile:
        record["profile"] = profile
        run.note(f"profiled steps {PROFILE_FROM}-{PROFILE_FROM + PROFILE_STEPS - 1}: wall "
                 f"{profile['wall_s']!r} s, {sum(k[0] for k in profile['kernels'].values())} "
                 f"device events, summary {profile['summary_s']!r} s")
    return record


def release(state: dict) -> None:
    state.clear()
    gc.collect()


def _leaf_gap(got: list, want: list, keep=None) -> float:
    median = float(np.median(want))
    gaps = [abs(g - w) / max(w, median) for i, (g, w) in enumerate(zip(got, want))
            if keep is None or keep[i]]
    return max(gaps) if gaps else 0.0


def _keep(grad_norms: list) -> list:
    median = float(np.median(grad_norms))
    return [g >= ROUND_OFF_LEAF * median for g in grad_norms]


def _loss_gap(got: list, want: list) -> float:
    return max(abs(a - b) / abs(b) for a, b in zip(got, want))


def compare(first: dict, ref: dict) -> dict:
    """{name: reading} of the program's first steps against the reference's."""
    return {
        "loss_gap": _loss_gap(first["losses"], ref["losses"]),
        "grad_gap": _leaf_gap(first["grad_norms"], ref["grad_norms"]),
        "change_gap": _leaf_gap(first["change_norms"], ref["change_norms"],
                                _keep(ref["grad_norms"])),
    }


def _reference_renderer(run, target: torch.Tensor):
    t = run.cell.traffic
    scene = start_scene(_reference_scene(run), t["start"], RefVec3)
    return _renderer(ref_inverse, scene, target.to(run.device), run)


def _stepper(inv, lowp: bool):
    if not lowp:
        return inv.step

    def step():
        with rounded_to(torch.bfloat16):
            return inv.step()

    return step


def reference_steps(run, target: torch.Tensor, lowp: bool = False) -> dict:
    """The frozen reference's first CHECK_STEPS steps; with `lowp` computed
    in bfloat16 (the control)."""
    inv = _reference_renderer(run, target)
    return first_steps(inv, run.cell.traffic["fields"], CHECK_STEPS, _stepper(inv, lowp))


def _norms(after: list, before: list) -> list:
    return [float(torch.linalg.vector_norm(a - b)) for a, b in zip(after, before)]


def replay_last(run, target: torch.Tensor, last: dict, lowp: bool = False) -> dict:
    """The window's last step taken by the frozen reference from the
    program's state at its start: the loss, each leaf's change and each
    leaf's gradient as Adam got it (from exp_avg before and after)."""
    fields = run.cell.traffic["fields"]
    inv = _reference_renderer(run, target)
    named = leaves(inv.params, fields)
    before = last["before"]
    with torch.no_grad():
        for (_, leaf), value in zip(named, before["values"]):
            leaf.copy_(value)
    for (_, leaf), adam in zip(named, before["adam"]):
        if adam:
            inv.optimizer.state[leaf] = _cloned(adam)
    inv.step_count = before["step_count"]
    loss = float(_stepper(inv, lowp)())
    beta1 = inv.optimizer.param_groups[0]["betas"][0]
    grads = []
    for (_, leaf), adam in zip(named, before["adam"]):
        m_new = inv.optimizer.state[leaf]["exp_avg"]
        m_old = adam.get("exp_avg", torch.zeros_like(m_new))
        grads.append(float(torch.linalg.vector_norm(m_new - beta1 * m_old)) / (1.0 - beta1))
    return {"loss": loss, "after": [leaf.detach() for _, leaf in named], "grad_norms": grads}


def compare_last(got: dict, ref: dict, before: dict) -> dict:
    """{name: reading} of a last window step (its loss, and the leaves
    after it) against the reference's replay of it from `before`."""
    return {
        "last_loss_gap": _loss_gap([got["loss"]], [ref["loss"]]),
        "last_change_gap": _leaf_gap(_norms(got["after"], before["values"]),
                                     _norms(ref["after"], before["values"]),
                                     _keep(ref["grad_norms"])),
    }


def _checks(readings: dict, run) -> list:
    return [Check(name, finite(value), run.cell.limits[name]) for name, value in readings.items()]


def check(record: dict, run) -> list:
    ref = reference_steps(run, record["target"])
    run.note(f"reference's first {CHECK_STEPS} steps: {ref}")
    last = record["last"]
    replay = replay_last(run, record["target"], last)
    run.note(f"window's last step (step count {last['before']['step_count']}): loss "
             f"{last['loss']!r}; the reference's replay: loss {replay['loss']!r}, gradient "
             f"norms {replay['grad_norms']}")
    return _checks({**compare(record["first"], ref),
                    **compare_last(last, replay, last["before"])}, run)


def control(record: dict, run) -> list:
    """The numbers `check` compares, with the control in the program's
    place: the reference's steps, and its replay of the window's last
    step, computed in bfloat16."""
    ref = reference_steps(run, record["target"])
    low = reference_steps(run, record["target"], lowp=True)
    run.note(f"control's first {CHECK_STEPS} steps: {low}")
    before = record["last"]["before"]
    ref_last = replay_last(run, record["target"], record["last"])
    low_last = replay_last(run, record["target"], record["last"], lowp=True)
    return _checks({**compare(low, ref), **compare_last(low_last, ref_last, before)}, run)
