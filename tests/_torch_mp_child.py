"""One rank of a multi-process CPU run of the port, over gloo; and the
parent's launcher for tests/test_torch_multiprocess*.py.

    python _torch_mp_child.py <rank> <spec.json>

The spec names the world ("port", "world") and what every rank runs
("kind"):

  * "session": RenderSession over a mesh (RenderOptions fields in
    "options"); rank 0 saves the linear image to "out" (.npy);
  * "cli": `python -m cornelis_tpu_torch`'s main with "argv" plus the
    coordinator flags, in the rank's own directory "<cwd>/rank<r>";
  * "train": one step of diff.make_sharded_train_step on Cornell over the
    mesh "mesh" (fields, shape and key in the spec); rank 0 saves the
    loss, the gradients and the new params to "out" (.npz);
  * "agree": RenderSession over a mesh with a progress callback on rank 0
    alone, each rank checkpointing to "ck<rank>.npz" in "cwd"; "case"
    "budget" adds the time budget "budget", "abort" makes rank 0's
    callback abort after its first chunk. Each rank prints its status,
    samples and chunks as "agree <json>".

Each rank prints one line and exits 0, or raises.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Seconds a whole world may take; every rank is killed past it.
TIMEOUT = 240


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch_ranks(spec: dict, world: int, cwd) -> list:
    """Run `world` ranks of this script on `spec` (its port and world are
    filled in here) and return their outputs. Fails on the first rank that
    exits non-zero; past TIMEOUT every rank is killed."""
    spec = dict(spec, port=free_port(), world=world, cwd=str(cwd))
    path = os.path.join(str(cwd), f"spec-{spec['port']}.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    # Each rank writes to a file of its own: a full pipe would stall a
    # rank, and the collectives every other rank with it.
    logs = [os.path.join(str(cwd), f"rank{rank}-{spec['port']}.log") for rank in range(world)]
    procs = []
    for rank, log in enumerate(logs):
        with open(log, "w") as f:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), str(rank), path], env=env,
                cwd=str(cwd), stdout=f, stderr=subprocess.STDOUT))
    outputs, deadline = [], time.monotonic() + TIMEOUT
    try:
        for rank, p in enumerate(procs):
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
            with open(logs[rank]) as f:
                outputs.append(f.read())
            assert p.returncode == 0, f"rank {rank} exited {p.returncode}:\n{outputs[-1][-4000:]}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outputs


def _train_case(spec: dict, device: str = "cpu"):
    """(scene, target, params, optimizer) of a "train" spec."""
    import torch

    from cornelis_tpu_torch import compile_scene, cornell_box, scene_arrays
    from cornelis_tpu_torch.diff import extract_params, render_diff
    from cornelis_tpu_torch.diff.inverse import _leaves
    from cornelis_tpu_torch.rng import make_key

    scene = scene_arrays(compile_scene(cornell_box(), device=device))
    w, h = spec["width"], spec["height"]
    with torch.no_grad():
        target = render_diff(scene, make_key(9, device), width=w, height=h, spp=spec["spp"],
                             max_depth=spec["max_depth"], mode=spec["mode"])
    params = extract_params(scene, spec["fields"])
    optimizer = torch.optim.Adam(list(_leaves(params)), lr=spec["lr"])
    return scene, target, params, optimizer


def train_step_result(spec: dict, mesh, device: str = "cpu") -> dict:
    """One sharded step of a "train" spec on `mesh`: the loss, every
    gradient and every new param, as numpy arrays by name."""
    from cornelis_tpu_torch.diff import make_sharded_train_step
    from cornelis_tpu_torch.rng import make_key

    scene, target, params, optimizer = _train_case(spec, device)
    step = make_sharded_train_step(
        scene, target, mesh, optimizer, width=spec["width"], height=spec["height"],
        spp=spec["spp"], max_depth=spec["max_depth"], mode=spec["mode"],
    )
    loss = step(params, make_key(spec["key"], device))
    out = {"loss": loss.cpu().numpy()}
    for field, value in params.items():
        for i, leaf in enumerate(value if isinstance(value, tuple) else (value,)):
            out[f"grad {field} {i}"] = leaf.grad.cpu().numpy()
            out[f"param {field} {i}"] = leaf.detach().cpu().numpy()
    return out


def _agree_case(spec: dict, rank: int) -> None:
    """One rank of an "agree" spec: the session's branches decided on rank
    0 alone, which every rank must follow."""
    from cornelis_tpu_torch import RenderCommand, RenderOptions, RenderSession, cornell_box

    calls = []

    def on_progress(progress, status):
        calls.append(status.name)
        if spec["case"] == "abort" and progress.chunks_dispatched >= 1:
            return RenderCommand.ABORT
        return RenderCommand.CONTINUE

    opts = RenderOptions(**{**spec["options"], "mesh_shape": tuple(spec["mesh"]),
                            "checkpoint": os.path.join(spec["cwd"], f"ck{rank}.npz"),
                            "time_budget_s": spec.get("budget", 0.0)})
    result = RenderSession(cornell_box(), opts).render(on_progress if rank == 0 else None)
    record = dict(status=result.status.name, samples=result.film.sample_count,
                  chunks=result.chunks, calls=calls)
    print(f"agree {json.dumps(record)}", flush=True)


def main(rank: int, spec_path: str) -> int:
    import torch

    torch.set_num_threads(1)
    with open(spec_path) as f:
        spec = json.load(f)
    coordinator = f"127.0.0.1:{spec['port']}"
    if spec["kind"] == "cli":
        from cornelis_tpu_torch.__main__ import main as cli_main

        rank_dir = os.path.join(spec["cwd"], f"rank{rank}")
        os.makedirs(rank_dir, exist_ok=True)
        os.chdir(rank_dir)
        rc = cli_main([*spec["argv"], "--coordinator", coordinator, "--num-processes",
                       str(spec["world"]), "--process-id", str(rank), "--dist-backend", "gloo"])
        assert rc == 0, rc
        print(f"[rank {rank}] cli ok", flush=True)
        return 0

    from cornelis_tpu_torch.parallel import initialize_distributed, make_mesh

    initialize_distributed(coordinator, spec["world"], rank, backend="gloo", device="cpu")
    import torch.distributed as dist

    try:
        if spec["kind"] == "session":
            from cornelis_tpu_torch import RenderOptions, RenderSession, RenderStatus, cornell_box

            opts = RenderOptions(**{**spec["options"], "mesh_shape": tuple(spec["mesh"])})
            result = RenderSession(cornell_box(), opts).render()
            assert result.status == RenderStatus.DONE, result.status
            if rank == 0:
                np.save(spec["out"], result.image)
            print(f"[rank {rank}] session ok, {result.chunks} chunks", flush=True)
        elif spec["kind"] == "agree":
            _agree_case(spec, rank)
        elif spec["kind"] == "train":
            out = train_step_result(spec, make_mesh(spec["mesh"]))
            if rank == 0:
                np.savez(spec["out"], **out)
            print(f"[rank {rank}] train ok, loss {float(out['loss']):.8g}", flush=True)
        else:
            raise ValueError(f"unknown kind {spec['kind']!r}")
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    sys.exit(main(int(sys.argv[1]), sys.argv[2]))
