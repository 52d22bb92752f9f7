"""The port's session branches under a mesh of real processes: two gloo
ranks on the CPU, on (2, 1), through tests/_torch_mp_child.py's "agree"
mode.

Every chunk of a mesh render ends in collectives, so a rank that left the
chunk loop on its own clock or its own callback would deadlock the other
(the JAX package's tests/test_multiprocess.py
test_two_process_time_budget_and_checkpoint_do_not_deadlock). Rank 0
decides and broadcasts; a progress callback installed on rank 0 alone
must not hang rank 1; only rank 0 writes the checkpoint. Each world runs
under the launcher's timeout, past which every rank is killed.
"""

import json

import numpy as np
import pytest
import torch
from _torch_mp_child import launch_ranks

from cornelis_tpu_torch.film import Film

OPTIONS = dict(width=16, height=16, samples_aa=8, spp_chunk=2, max_depth=4, device="cpu",
               output=None)


@pytest.fixture(autouse=True)
def _threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _records(tmp_path, **spec) -> list:
    outputs = launch_ranks(dict(kind="agree", mesh=[2, 1], options=OPTIONS, **spec), 2,
                           tmp_path)
    records = []
    for out in outputs:
        lines = [ln for ln in out.splitlines() if ln.startswith("agree ")]
        assert lines, out
        records.append(json.loads(lines[-1][len("agree "):]))
    return records


def test_time_budget_and_checkpoint_do_not_deadlock(tmp_path):
    r0, r1 = _records(tmp_path, case="budget", budget=1e-3)
    # A chunk takes longer than the budget: both ranks stop after the
    # first, on rank 0's clock, and report the same film.
    assert r0["status"] == r1["status"] == "DONE"
    assert r0["samples"] == r1["samples"] == 2 and r0["chunks"] == r1["chunks"] == 1
    # The callback ran on rank 0 alone, each chunk and once at the end.
    assert r0["calls"][-1] == "DONE" and len(r0["calls"]) >= r0["chunks"] + 1
    assert r1["calls"] == []
    # Only rank 0 wrote its checkpoint, and it holds the film's samples.
    assert (tmp_path / "ck0.npz").exists() and not (tmp_path / "ck1.npz").exists()
    film, next_sample, _ = Film.load_checkpoint(str(tmp_path / "ck0.npz"))
    assert film.sample_count == next_sample == r0["samples"]
    assert np.isfinite(film.image()).all() and film.image().max() > 0


def test_rank_zeros_abort_stops_every_rank(tmp_path):
    r0, r1 = _records(tmp_path, case="abort")
    assert r0["status"] == r1["status"] == "ABORTED"
    assert r0["samples"] == r1["samples"] == 2 and r0["chunks"] == r1["chunks"] == 1
    assert r0["calls"] == ["RUNNING", "ABORTED"] and r1["calls"] == []
    assert not (tmp_path / "ck1.npz").exists()
    _, next_sample, _ = Film.load_checkpoint(str(tmp_path / "ck0.npz"))
    assert next_sample == 2
