"""The port's sequence-parallel training loop (``--sp`` through
``launch/worker.py``, ``cli.py`` and ``parallel/nd.py`` ``NDEngine``) on
4 gloo CPU ranks: the CLI end to end with ``--sp 2`` (data 2 x seq 2)
and ``--sp 4``; a group of steps (``--steps-per-dispatch``) and a resume
equal the per-step run bit for bit (the same ops on the same inputs on
the same ranks), with the ``(data, seq)`` mesh stamped in the
checkpoint's topology manifest; a resume onto another mesh of the same
ranks reshards under ``--elastic`` and resets the codec's residuals;
and every refusal of the reference's ND branch by its message (the
unported ``--pp``, ``--expert`` and ``--zero`` by name, and ``--tp``
with ``loss_chunk``). The numbers against the JAX package:
``tests/test_torch_sp.py``.
"""

import json
import math
import os
import subprocess
import sys

import pytest

from theanompi_tpu_torch.launch.session import launch_training
from theanompi_tpu_torch.launch.worker import run_training
from theanompi_tpu_torch.models import lm as tlm
from theanompi_tpu_torch.parallel.nd import NDEngine
from theanompi_tpu_torch.utils.checkpoint import latest_checkpoint, read_topology_manifest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 4
TINY = dict(input_shape=(64,), num_classes=32, d_model=32, n_heads=4, n_layers=2, d_ff=64,
            batch_size=4, sched_kwargs={"lr": 1e-3})
TINY_ARGS = ["--recipe-arg", "input_shape=[64]", "--recipe-arg", "num_classes=32",
             "--recipe-arg", "d_model=32", "--recipe-arg", "n_heads=4",
             "--recipe-arg", "n_layers=2", "--recipe-arg", "d_ff=64"]


def _cli(*args, n="4"):
    cmd = [sys.executable, "-m", "theanompi_tpu_torch.cli", "BSP", n, "transformer_lm",
           "TransformerLM_136M", "--synthetic", "--device", "cpu", "--max-steps", "2",
           "--batch-size", "4", "--print-freq", "1", "--dataset-arg", "n_train=16",
           "--dataset-arg", "n_val=8", *TINY_ARGS, *args]
    out = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=300,
                         env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("sp,attn", [(2, "ring_flash"), (4, "ulysses_flash")])
def test_cli_trains_under_sp_on_cpu(sp, attn):
    s = _cli("--sp", str(sp), "--recipe-arg", f"attn={attn}")
    assert s["steps"] == 2 and s["sp"] == sp and s["dp"] == 4 // sp and s["attn"] == attn
    assert s["mesh"] == {"shape": [4 // sp, sp], "axes": ["data", "seq"]}
    assert len(s["losses"]) == 2 and all(math.isfinite(v) for v in s["losses"])
    assert s["nonfinite_steps"] == 0 and set(s["val"]) == {"loss"}
    assert len(set(s["replica_digest_per_rank"])) == 1
    # the CPU runs the plain versions: no kernel launched
    assert not any(v for c in s["kernel_launches_per_rank"] for v in c.values())


def _run(tmp, label, **kw):
    base = dict(device="cpu", dataset="synthetic", max_steps=4, print_freq=1,
                dataset_kwargs={"n_train": 8, "n_val": 4},
                recipe_overrides=dict(TINY, attn="ring_flash"), sp=2,
                ckpt_dir=str(tmp / label), async_checkpoint=False)
    return launch_training("bsp", N, "transformer_lm", "TransformerLMModel", **{**base, **kw})


def test_groups_and_resume_equal_the_per_step_run(tmp_path, monkeypatch):
    """4 steps (2 an epoch) at data 2 x seq 2: in groups of 2
    (``steps_per_dispatch``), and cut at 3 then resumed, bit for bit the
    per-step run; the checkpoint stamps the (data, seq) mesh."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    eager = _run(tmp_path, "eager")
    grouped = _run(tmp_path, "grouped", steps_per_dispatch=2)
    _run(tmp_path, "resumed", max_steps=3)
    resumed = _run(tmp_path, "resumed", resume=True)
    assert resumed["resumed_from_step"] == 3 and resumed["steps"] == 4
    digest = eager["replica_digest_per_rank"]
    assert len(set(digest)) == 1
    assert grouped["replica_digest_per_rank"] == digest
    assert resumed["replica_digest_per_rank"] == digest
    assert grouped["losses"] == eager["losses"] and resumed["losses"] == eager["losses"][3:]
    manifest = read_topology_manifest(latest_checkpoint(str(tmp_path / "eager")))
    assert manifest["mesh"] == {"shape": [2, 2], "axes": ["data", "seq"]}
    assert manifest["elastic"]["policies"] == {".ef": {"policy": "reset"}}


def test_a_resume_onto_another_mesh_reshards_and_resets_the_residuals(tmp_path, monkeypatch):
    """The reference's topology rule through the ``__topology__`` stamp: a
    checkpoint of ``--sp 4`` under ``int8:ef``, resumed with ``--elastic``
    at data 2 x seq 2 (the same 4 ranks, another mesh), is resharded: the
    params and Adam's moments carry over, the ``.ef`` stacks reset (their
    ``elastic_spec`` policy); without ``--elastic`` the same world loads it
    as it is."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    _run(tmp_path, "mesh", sp=4, max_steps=2, wire_codec="int8:ef")
    moved = _run(tmp_path, "mesh", sp=2, resume=True, elastic=True, wire_codec="int8:ef")
    assert moved["resumed_from_step"] == 2 and moved["steps"] == 4
    assert moved["mesh"] == {"shape": [2, 2], "axes": ["data", "seq"]}
    r = moved["reshard"]
    assert r["resharded"] and r["from_mesh"] == {"shape": [1, 4], "axes": ["data", "seq"]}
    assert r["reset"] and all(k.startswith(".ef/") for k in r["reset"])
    assert all(x > 0 for x in moved["ef_norm_per_rank"])  # residuals of the new mesh's steps
    assert len(set(moved["replica_digest_per_rank"])) == 1


REFUSALS = [
    (dict(rule="easgd"), "--sp compose with the BSP rule only"),
    (dict(strategy="ring"), r"--sp use the in-step psum sync \(strategy 'psum'\)"),
    (dict(n_slices=2), "--sp do not compose with --slices yet"),
    (dict(accum_steps=2), "--sp do not compose with --accum-steps yet"),
    (dict(avg_freq=2), r"--sp got unexpected options \['avg_freq'\]"),
    (dict(allreduce_buckets=25.0), "--allreduce-buckets buckets the BSP in-step gradient"),
    (dict(sp=3), "4 devices do not divide --tp 1 x --sp 3"),
    (dict(recipe_overrides=dict(TINY, input_shape=(66,))), "sequence length 66 not divisible"),
    (dict(sp=2, recipe_overrides=dict(TINY, batch_size=3)),
     r"global batch 3 not divisible by 2 \(batch-axis devices x microbatches\)"),
    (dict(recipe_overrides=dict(TINY, attn="ulysses", n_heads=2)),
     "ulysses attention needs local heads \\(2\\) divisible by the 'seq' axis size 4"),
    (dict(fused_update=True), "--fused-update has no fused kernel for optimizer 'adam'"),
]


@pytest.mark.parametrize("kw,match", REFUSALS, ids=[m[:24] for _, m in REFUSALS])
def test_refusals_by_message(kw, match):
    """What the reference refuses under its ND axes: refused before any
    rank joins a process group, with the reference's words."""
    kw = dict(kw)
    rule = kw.pop("rule", "bsp")
    base = dict(device="cpu", dataset="synthetic", max_steps=1,
                dataset_kwargs={"n_train": 16, "n_val": 4}, recipe_overrides=TINY, sp=4)
    with pytest.raises(ValueError, match=match):
        run_training(rule, tlm.TransformerLMModel, N, **{**base, **kw})


def test_a_classifier_and_attn_flash_are_refused(monkeypatch):
    from theanompi_tpu_torch.models.mlp import MLP
    from theanompi_tpu_torch.models.transformer import attention_block

    with pytest.raises(ValueError, match="--sp needs an LM model .* MLP is classifier-shaped"):
        run_training("bsp", MLP, N, device="cpu", sp=2, max_steps=1)
    with pytest.raises(ValueError, match="attn='flash' is the fused LOCAL kernel"):
        attention_block({}, None, "flash", "seq")
    # one device, no process group: the engine refuses before any collective
    model = tlm.TransformerLMModel(tlm.TransformerLMModel.default_recipe().replace(**TINY))
    with pytest.raises(RuntimeError, match="process group of 4 ranks"):
        NDEngine(model, 4, "cpu", sp=2)


@pytest.mark.parametrize("flag", ["--pp", "--expert", "--zero"])
def test_the_cli_refuses_the_unported_nd_axes_by_name(flag, capsys):
    from theanompi_tpu_torch import cli

    with pytest.raises(SystemExit):
        cli.main(["BSP", "4", "transformer_lm", "TransformerLMModel", "--synthetic", "--device",
                  "cpu", flag, "2"])
    assert f"{flag} is not ported yet: ROADMAP.md" in capsys.readouterr().err


def test_the_cli_refuses_tp_with_loss_chunk():
    """``--tp`` is ported; with ``loss_chunk`` it is refused, naming both
    (the reference ignores the chunk under its model axis)."""
    from theanompi_tpu_torch import cli

    with pytest.raises(ValueError, match="loss_chunk=8 does not compose with --tp"):
        cli.main(["BSP", "1", "transformer_lm", "TransformerLMModel", "--synthetic", "--device",
                  "cpu", "--tp", "2", "--recipe-arg", "loss_chunk=8"])
