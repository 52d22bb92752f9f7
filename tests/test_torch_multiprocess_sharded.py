"""The port's sharded inverse-render step across real processes: gloo
ranks on the CPU (tests/_torch_mp_child.py) against one process.

One step of diff.make_sharded_train_step (Cornell 32x32, 8 spp,
max_depth 4, albedo and roughness, Adam lr 0.05) on a (1, 2) mesh, whose
samples all-reduce sits inside the loss and must carry the gradient, and
on a (2, 1) mesh in mode nee, against the same step on the (1, 1) mesh in
this process. The loss and every gradient within 1e-5 relative: the ranks
add their partial sums in another float order, and a wrong factor S on
the samples axis (each tile counted S times) would double them.
"""

import numpy as np
import pytest
import torch
from _torch_mp_child import launch_ranks, train_step_result

from cornelis_tpu_torch.parallel import make_mesh

SPEC = dict(kind="train", width=32, height=32, spp=8, max_depth=4, lr=0.05, key=3,
            fields=["mat_albedo", "mat_roughness"])


@pytest.mark.parametrize("mesh,mode", [((1, 2), "path"), ((2, 1), "nee")])
def test_sharded_step_matches_one_process(tmp_path, mesh, mode):
    spec = dict(SPEC, mesh=list(mesh), mode=mode, out=str(tmp_path / "rank0.npz"))
    launch_ranks(spec, mesh[0] * mesh[1], tmp_path)
    multi = np.load(spec["out"])
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        single = train_step_result(spec, make_mesh((1, 1)))
    finally:
        torch.set_num_threads(before)
    assert sorted(multi.files) == sorted(single)
    assert float(single["loss"]) != 0.0
    for name, want in single.items():
        got = multi[name]
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=0.0, err_msg=name)
        if name.startswith("grad"):
            assert np.abs(want).max() > 0.0, f"{name} is zero"
