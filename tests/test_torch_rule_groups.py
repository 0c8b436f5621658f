"""Worker groups of the port's EASGD and GoSGD (``--group-size``:
``parallel/mesh.py::worker_groups`` and ``AxisGroups``, the reference's
``make_worker_group_mesh``), and the process groups of the exchange's
helpers (``parallel/strategies.py``: ``_hop`` with a shift over a
group, ``mean_across_ranks`` over a group), on gloo CPU ranks.

1. On 4 ranks in groups of 2: ``"data"`` is the group (ranks 0 1 | 2 3),
   ``"worker"`` the ranks at one position in every group (0 2 | 1 3); a
   hop with a shift over either reaches the right peer, and over the
   world with shift 3; a group's mean is its ranks'.
2. The reference's invariant (``tests/test_easgd_groups.py``): 4 ranks as
   2 workers of 2 equal 2 ranks as 2 single workers with the same
   per-worker batch, for EASGD (``avg_freq=1``) and GoSGD (``p_push=1``),
   2 steps of WRN-16-4 at 16x16 (BatchNorm, no dropout) with BN over the
   group's ``"data"`` axis (the default a group turns on). The group's
   gradient is the mean of two half-batch gradients and its BN
   statistics come from two halves, so the sums run in other orders:
   the losses rtol 1e-4, and each stack of the final checkpoints (each
   worker's params, velocities and BN statistics, the center) within
   1e-3 of its norm (measured: at most 8.3e-5, the velocities; a single
   small leaf such as a BN bias up to 2.8e-4). Longer runs part further:
   at 4 steps a ReLU or a small batch's BN statistic crosses over and
   the velocities part by 1e-2 (``tests/test_torch_zoo_state.py`` holds
   WRN's 3-step trajectory in relative norm 1e-1 for the same reason).
   Within a group the ranks agree bit for bit.
3. The refusals: groups that do not divide the ranks, a group across a
   slice boundary, slices that do not divide the ranks.
"""

import glob
import os

import numpy as np
import pytest

from theanompi_tpu_torch.launch.session import spawn_ranks
from theanompi_tpu_torch.parallel.mesh import worker_groups

import torch_rule_rank_fns


def test_the_worker_and_data_axes_and_their_hops(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    ranks = spawn_ranks(torch_rule_rank_fns.hop_rank, 4, (1, 2), device="cpu", timeout=120)
    for r, res in enumerate(ranks):
        g, d = divmod(r, 2)
        assert res["data_members"] == [2 * g, 2 * g + 1]
        assert res["worker_members"] == [d, d + 2]
        # shift 1 over the 2-rank worker axis: from the other group's rank at my position
        np.testing.assert_array_equal(res["worker"], [float((r + 2) % 4)] * 3)
        np.testing.assert_array_equal(res["data"], [100.0 + (2 * g + 1 - d)] * 3)
        np.testing.assert_array_equal(res["world"], [float((r - 1) % 4)] * 3)
        np.testing.assert_array_equal(res["worker_mean"], [(d + d + 2) / 2] * 3)
        np.testing.assert_array_equal(res["data_mean"], [2 * g + 0.5] * 3)
    shifted = spawn_ranks(torch_rule_rank_fns.hop_rank, 4, (3, 1), device="cpu", timeout=120)
    for r, res in enumerate(shifted):
        # one rank a group: the worker axis is the world; shift 3 = from the rank 3 behind
        assert res["worker_members"] == [0, 1, 2, 3]
        np.testing.assert_array_equal(res["worker"], [float((r - 3) % 4)] * 3)
        np.testing.assert_array_equal(res["world"], [float((r - 3) % 4)] * 3)


def test_worker_groups_refuse_what_the_reference_refuses():
    assert worker_groups(8, 2) == (4, 2) and worker_groups(8, 4, n_slices=2) == (2, 4)
    assert worker_groups(4) == (4, 1) and worker_groups(4, 1, n_slices=2) == (4, 1)
    with pytest.raises(ValueError, match="8 devices do not divide into groups of 3"):
        worker_groups(8, 3)
    with pytest.raises(ValueError, match=r"worker group 0 would span slices \[0, 1\]"):
        worker_groups(8, 4, n_slices=4)
    with pytest.raises(ValueError, match="6 devices do not divide into 4 slices"):
        worker_groups(6, 1, n_slices=4)


def test_run_training_refuses_groups_that_do_not_fit():
    from theanompi_tpu_torch.launch.worker import run_training
    from theanompi_tpu_torch.models.mlp import MLP

    with pytest.raises(ValueError, match="groups of 3"):
        run_training("easgd", MLP, 8, device="cpu", group_size=3)
    with pytest.raises(ValueError, match="would span slices"):
        run_training("gosgd", MLP, 8, device="cpu", group_size=4, n_slices=4)


PER = 8
STEPS = 2
WRN = ("theanompi_tpu_torch.models.model_zoo.wrn", "WRN_16_4")


def _runs(root, group_size):
    data = {"dataset": "synthetic",
            "dataset_kwargs": {"n_train": 2 * PER * STEPS, "n_val": 2 * PER},
            "recipe_overrides": {"batch_size": PER, "input_shape": (16, 16, 3),
                                 "sched_kwargs": {"lr": 0.05, "boundaries": [10 ** 9]}},
            "print_freq": 0, "seed": 5, "max_steps": STEPS, "group_size": group_size,
            "async_checkpoint": False}
    return [(rule, *WRN, dict(data, rule=rule, ckpt_dir=os.path.join(root, rule), **kw))
            for rule, kw in (("easgd", {"avg_freq": 1}), ("gosgd", {"p_push": 1.0}))]


@pytest.fixture(scope="module")
def layouts(tmp_path_factory):
    os.environ["OMP_NUM_THREADS"] = "1"
    out = {}
    for n, g in ((2, 1), (4, 2)):
        root = str(tmp_path_factory.mktemp(f"groups{g}"))
        out[g] = (root, spawn_ranks(torch_rule_rank_fns.training_rank, n, (_runs(root, g),),
                                    device="cpu", timeout=600)[0])
    return out


def _newest(d):
    return max(glob.glob(os.path.join(d, "ckpt_*.npz")),
               key=lambda p: int(p.rsplit("_", 1)[1][:-4]))


@pytest.mark.parametrize("rule", ["easgd", "gosgd"])
def test_groups_of_two_equal_single_workers(layouts, rule):
    (root1, single), (root2, grouped) = layouts[1], layouts[2]
    a, b = single[rule], grouped[rule]
    assert a["n_workers"] == b["n_workers"] == 2 and b["group_size"] == 2
    assert a["global_batch"] == b["global_batch"] == 2 * PER
    assert a["bn_axis_name"] is None and b["bn_axis_name"] == "data"
    assert a["comm_rounds_per_rank"] == b["comm_rounds_per_rank"][:2] == [STEPS] * 2
    np.testing.assert_allclose(b["losses"], a["losses"], rtol=1e-4)
    # within a group the ranks agree bit for bit; the two workers differ
    for key in ("worker_digest_per_rank", "model_state_digest_per_rank"):
        d = b[key]
        assert d[0] == d[1] and d[2] == d[3] and d[0] != d[2], (key, d)
    fa, fb = (np.load(_newest(os.path.join(root, rule))) for root in (root1, root2))
    keys = sorted(k for k in fa.files if not k.startswith("__"))
    assert keys == sorted(k for k in fb.files if not k.startswith("__"))
    assert any(k.startswith(".workers/.model_state/") for k in keys)
    for prefix in (".workers/.params/", ".workers/.opt_state/", ".workers/.model_state/",
                   ".center_params/", ".center_model_state/", ".alpha"):
        ks = [k for k in keys if k.startswith(prefix)]
        if not ks:
            continue
        num = sum(np.sum((fa[k].astype(np.float64) - fb[k]) ** 2) for k in ks)
        den = sum(np.sum(fa[k].astype(np.float64) ** 2) for k in ks)
        assert (num / den) ** 0.5 < 1e-3, (rule, prefix, (num / den) ** 0.5)
    np.testing.assert_array_equal(fa[".workers/.step"], fb[".workers/.step"])
