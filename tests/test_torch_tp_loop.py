"""The port's tensor-parallel training loop (``--tp`` through
``launch/worker.py``, ``cli.py`` and ``parallel/nd.py`` ``NDEngine``) on
4 gloo CPU ranks: the CLI end to end at ``--tp 2`` (data 2 x tp 2); a
group of steps (``--steps-per-dispatch``) and a resume equal the per-step
run bit for bit; the checkpoint's topology manifest carries the
reference's mesh axes and per-leaf specs (the reference's own stamp of
its engine's state, for the same mesh); the reference's
``load_checkpoint`` reads a gathered ``--tp 2`` file; a file of one mesh
restores onto another (``--tp 2`` to ``--tp 4`` and back, ``--tp 2`` to
``--sp 2`` and back) with params and Adam's state exact and the codec's
residuals reset, through ``load_resharded`` and through ``--elastic``;
and every refusal by its message. The numbers against the JAX package:
``tests/test_torch_tp.py``.
"""

import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest

from theanompi_tpu_torch import bridge
from theanompi_tpu_torch.launch.session import launch_training, spawn_ranks
from theanompi_tpu_torch.launch.worker import run_training
from theanompi_tpu_torch.models import lm as tlm
from theanompi_tpu_torch.utils.checkpoint import (
    latest_checkpoint,
    load_checkpoint,
    read_topology_manifest,
)

import torch_tp_rank_fns

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 4
TINY = dict(input_shape=(64,), num_classes=32, d_model=32, n_heads=4, n_layers=2, d_ff=64,
            batch_size=4, sched_kwargs={"lr": 1e-3}, attn="flash")
TINY_ARGS = ["--recipe-arg", "input_shape=[64]", "--recipe-arg", "num_classes=32",
             "--recipe-arg", "d_model=32", "--recipe-arg", "n_heads=4",
             "--recipe-arg", "n_layers=2", "--recipe-arg", "d_ff=64"]
CODEC = "int8:ef"


def _check_digests(s):
    """The ranks of one model index hold the same shards bit for bit;
    every rank the same replicated leaves."""
    by_t: dict = {}
    for t, d in zip(s["tp_index_per_rank"], s["replica_digest_per_rank"]):
        by_t.setdefault(t, set()).add(d)
    assert len(by_t) == s["tp"] and all(len(d) == 1 for d in by_t.values()), by_t
    assert len(set(s["replicated_digest_per_rank"])) == 1


def test_cli_trains_under_tp_on_cpu():
    cmd = [sys.executable, "-m", "theanompi_tpu_torch.cli", "BSP", "4", "transformer_lm",
           "TransformerLM_136M", "--synthetic", "--device", "cpu", "--max-steps", "2",
           "--batch-size", "4", "--print-freq", "1", "--dataset-arg", "n_train=16",
           "--dataset-arg", "n_val=8", *TINY_ARGS, "--tp", "2"]
    out = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=300,
                         env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr[-3000:]
    s = json.loads(out.stdout.strip().splitlines()[-1])
    assert s["steps"] == 2 and s["tp"] == 2 and s["dp"] == 2 and s["sp"] == 1
    assert s["mesh"] == {"shape": [2, 2], "axes": ["data", "model"]}
    assert len(s["losses"]) == 2 and all(math.isfinite(v) for v in s["losses"])
    assert s["nonfinite_steps"] == 0 and set(s["val"]) == {"loss"}
    assert s["tp_index_per_rank"] == [0, 1, 0, 1]
    _check_digests(s)
    # the CPU runs the plain versions: no kernel launched
    assert not any(v for c in s["kernel_launches_per_rank"] for v in c.values())


def _run(tmp, label, **kw):
    base = dict(device="cpu", dataset="synthetic", max_steps=4, print_freq=1,
                dataset_kwargs={"n_train": 8, "n_val": 4}, recipe_overrides=TINY, tp=2,
                wire_codec=CODEC, ckpt_dir=str(tmp / label), async_checkpoint=False)
    return launch_training("bsp", N, "transformer_lm", "TransformerLMModel", **{**base, **kw})


_LOOP: dict = {}


def _loop_runs(tmp_path_factory):
    """The per-step run at data 2 x tp 2 under int8:ef, the same in groups
    of 2, cut at 3 and resumed, and 2-step files at --tp 4 (a sharded set)
    and at --sp 2; cached for the module."""
    if not _LOOP:
        tmp = tmp_path_factory.mktemp("tp")
        _LOOP["tmp"] = tmp
        _LOOP["eager"] = _run(tmp, "eager")
        _LOOP["grouped"] = _run(tmp, "grouped", steps_per_dispatch=2)
        _run(tmp, "resumed", max_steps=3)
        _LOOP["resumed"] = _run(tmp, "resumed", resume=True)
        _run(tmp, "tp4", tp=4, max_steps=2, ckpt_sharded=True)
        _run(tmp, "sp2", tp=1, sp=2, max_steps=2, recipe_overrides=dict(TINY, attn="ring_flash"))
    return _LOOP


def test_groups_and_resume_equal_the_per_step_run(tmp_path_factory, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    runs = _loop_runs(tmp_path_factory)
    eager, grouped, resumed = runs["eager"], runs["grouped"], runs["resumed"]
    assert resumed["resumed_from_step"] == 3 and resumed["steps"] == 4
    _check_digests(eager)
    for other in (grouped, resumed):
        for key in ("replica_digest_per_rank", "replicated_digest_per_rank", "ef_digest_per_rank"):
            assert other[key] == eager[key], key
    assert grouped["losses"] == eager["losses"] and resumed["losses"] == eager["losses"][3:]


def _reference_engine(mesh_shape, names):
    import jax
    from jax.sharding import Mesh

    from theanompi_tpu.models import lm as jlm
    from theanompi_tpu.parallel.nd import NDEngine as JND

    jm = jlm.TransformerLMModel(jlm.TransformerLMModel.default_recipe().replace(**TINY))
    mesh = Mesh(np.array(jax.devices()[:N]).reshape(mesh_shape), names)
    axes = dict(dp_axis="data", tp_axis="model" if "model" in names else None,
                sp_axis="seq" if "seq" in names else None)
    eng = JND(jm, mesh, steps_per_epoch=1, donate=False, wire_codec=CODEC, **axes)
    return eng, mesh, eng.init_state(jax.random.PRNGKey(0))


def test_the_manifest_is_the_references_and_the_reference_loads_the_file(tmp_path_factory,
                                                                         monkeypatch):
    """The gathered data 2 x tp 2 file: its ``__topology__`` mesh and
    per-leaf specs are those the reference stamps on its own engine's
    state for the same mesh (a replicated leaf: None in the port, ``[]``
    or None in the reference), and the reference's ``load_checkpoint``
    reads every entry of it, bit for bit."""
    import jax

    from theanompi_tpu.parallel.mesh import mesh_topology
    from theanompi_tpu.utils.checkpoint import _topology_manifest
    from theanompi_tpu.utils.checkpoint import load_checkpoint as j_load

    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    path = latest_checkpoint(str(_loop_runs(tmp_path_factory)["tmp"] / "eager"))
    eng, mesh, jstate = _reference_engine((2, 2), ("data", "model"))
    want = _topology_manifest(jstate, {"mesh": mesh_topology(mesh)})
    got = read_topology_manifest(path)
    assert got["mesh"] == want["mesh"] == {"shape": [2, 2], "axes": ["data", "model"]}
    assert set(got["leaves"]) == set(want["leaves"])
    sharded = 0
    for k, entry in got["leaves"].items():
        ref = want["leaves"][k]["spec"]
        if entry["spec"] is None:
            assert not ref, (k, ref)
        else:
            assert entry["spec"] == ref, (k, entry["spec"], ref)
            sharded += 1
    assert sharded == 3 * (1 + 4 * 2) + 15  # params, m and v sharded, every .ef stack
    loaded, _ = j_load(path, jstate)
    flat = load_checkpoint(path)
    ref_flat = dict(bridge._paths(jax.tree_util.tree_map(np.asarray, loaded._asdict()), ""))
    for k, v in ref_flat.items():
        key = "." + k.lstrip("/")
        np.testing.assert_array_equal(np.asarray(v), flat[key], err_msg=key)


def _entries_equal(got: dict, want: dict, reset_ef: bool):
    for k, v in want.items():
        if k.startswith("__"):
            continue
        if k.startswith(".ef/"):
            continue
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    if reset_ef:
        efs = [k for k in got if k.startswith(".ef/")]
        assert efs and all(not np.any(got[k]) for k in efs)


@pytest.mark.parametrize("direction", ["tp2->tp4", "tp2->sp2", "tp4->tp2", "sp2->tp2"])
def test_a_file_of_one_mesh_restores_onto_another(tmp_path_factory, monkeypatch, direction):
    """``load_resharded`` and the engine's restore move params and Adam's
    state between meshes by their global bounds, exactly; the residual
    stacks reset (their ``elastic_spec`` policy), shaped for the new
    mesh."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    runs = _loop_runs(tmp_path_factory)
    if "reshards" not in runs:
        dirs = {"tp2": "eager", "tp4": "tp4", "sp2": "sp2"}
        meshes = {"tp2": (2, 1), "tp4": (4, 1), "sp2": (1, 2)}
        cases = []
        for d in ("tp2->tp4", "tp2->sp2", "tp4->tp2", "sp2->tp2"):
            src, dst = d.split("->")
            attn = "ring_flash" if dst == "sp2" else "flash"
            cases.append((d, latest_checkpoint(str(runs["tmp"] / dirs[src])), *meshes[dst],
                          dict(TINY, attn=attn), CODEC))
        runs["reshards"] = spawn_ranks(torch_tp_rank_fns.reshard_rank, N, (cases,),
                                       device="cpu", timeout=300)[0]
        runs["files"] = {d: c[1] for d, c in zip(
            ("tp2->tp4", "tp2->sp2", "tp4->tp2", "sp2->tp2"), cases)}
    entries, info = runs["reshards"][direction]
    assert info["resharded"] and info["reset"] and all(k.startswith(".ef/")
                                                       for k in info["reset"])
    _entries_equal(entries, load_checkpoint(runs["files"][direction]), reset_ef=True)


def test_an_elastic_resume_onto_tp4_trains_on(tmp_path_factory, monkeypatch):
    """The worker's path: a --tp 2 directory resumed with ``--elastic`` at
    --tp 4 reshards (the manifest's mesh against this one's) and trains
    on from the saved step."""
    import shutil

    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    runs = _loop_runs(tmp_path_factory)
    src = runs["tmp"] / "elastic"
    shutil.copytree(runs["tmp"] / "eager", src)
    moved = _run(runs["tmp"], "elastic", tp=4, resume=True, elastic=True, max_steps=6)
    assert moved["resumed_from_step"] == 4 and moved["steps"] == 6
    assert moved["mesh"] == {"shape": [1, 4], "axes": ["data", "model"]}
    r = moved["reshard"]
    assert r["resharded"] and r["from_mesh"] == {"shape": [2, 2], "axes": ["data", "model"]}
    assert all(math.isfinite(v) for v in moved["losses"])
    _check_digests(moved)


REFUSALS = [
    (dict(rule="easgd"), "--tp compose with the BSP rule only"),
    (dict(strategy="ring"), r"--tp use the in-step psum sync \(strategy 'psum'\)"),
    (dict(tp=2, sp=3), "4 devices do not divide --tp 2 x --sp 3"),
    (dict(tp=3), "4 devices do not divide --tp 3 x --sp 1"),
    (dict(recipe_overrides=dict(TINY, n_heads=2, d_model=32)),
     r"the 'model' axis size 4 must divide each of n_heads/d_ff/vocab \(2/64/32\)"),
    (dict(recipe_overrides=dict(TINY, d_ff=66)),
     r"the 'model' axis size 4 must divide each of n_heads/d_ff/vocab \(4/66/32\)"),
    (dict(recipe_overrides=dict(TINY, num_classes=30)),
     r"the 'model' axis size 4 must divide each of n_heads/d_ff/vocab \(4/64/30\)"),
    (dict(tp=2, sp=2, recipe_overrides=dict(TINY, attn="ulysses", n_heads=2, d_model=32)),
     r"ulysses attention needs local heads \(1\) divisible by the 'seq' axis size 2"),
    (dict(recipe_overrides=dict(TINY, loss_chunk=8)),
     "loss_chunk=8 does not compose with --tp"),
    (dict(tp=2, recipe_overrides=dict(TINY, batch_size=3)),
     r"global batch 3 not divisible by 2 \(batch-axis devices x microbatches\)"),
    (dict(fused_update=True), "--fused-update has no fused kernel for optimizer 'adam'"),
]


@pytest.mark.parametrize("kw,match", REFUSALS, ids=[m[:24] for _, m in REFUSALS])
def test_refusals_by_message(kw, match):
    """What the reference refuses under its model axis (and the pair it
    lets through silently, ``loss_chunk``): refused before any rank joins
    a process group, with the reference's words."""
    kw = dict(kw)
    rule = kw.pop("rule", "bsp")
    base = dict(device="cpu", dataset="synthetic", max_steps=1,
                dataset_kwargs={"n_train": 16, "n_val": 4}, recipe_overrides=TINY, tp=4)
    with pytest.raises(ValueError, match=match):
        run_training(rule, tlm.TransformerLMModel, N, **{**base, **kw})
