"""Hygiene of the PyTorch port: it never imports JAX or the JAX package,
and its entry points never fall back to the CPU on their own."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "theanompi_tpu_torch"


def forbidden_import(module: str) -> bool:
    """JAX (jax, jaxlib and submodules) or the JAX package itself —
    matched exactly: ``theanompi_tpu_torch`` shares the prefix but is the
    port."""
    top = module.split(".")[0]
    return top in ("jax", "jaxlib") or top == "theanompi_tpu"


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.lineno, node.module


def test_matcher_tells_the_port_from_the_reference():
    assert forbidden_import("jax") and forbidden_import("jax.numpy")
    assert forbidden_import("jaxlib.xla_client")
    assert forbidden_import("theanompi_tpu") and forbidden_import("theanompi_tpu.ops.optimizers")
    assert not forbidden_import("theanompi_tpu_torch")
    assert not forbidden_import("theanompi_tpu_torch.ops.fused_update")
    assert not forbidden_import("jaxtyping")  # a shared prefix is not a match


def test_port_sources_import_no_jax_and_no_reference_package():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 15
    bad = [f"{f.relative_to(REPO)}:{line} imports {mod}"
           for f in files for line, mod in _imports(f) if forbidden_import(mod)]
    assert not bad, "\n".join(bad)


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys\n"
        "import theanompi_tpu_torch, theanompi_tpu_torch.cli, theanompi_tpu_torch.launch.worker\n"
        "import theanompi_tpu_torch.models.alex_net, theanompi_tpu_torch.ops.fused_update\n"
        "import theanompi_tpu_torch.bridge, theanompi_tpu_torch.train\n"
        "import theanompi_tpu_torch.ops.quant, theanompi_tpu_torch.parallel.codec\n"
        "import theanompi_tpu_torch.parallel.strategies, theanompi_tpu_torch.parallel.bsp\n"
        "import theanompi_tpu_torch.parallel.distributed, theanompi_tpu_torch.parallel.mesh\n"
        "import theanompi_tpu_torch.launch.session\n"
        "import theanompi_tpu_torch.models.lm, theanompi_tpu_torch.models.transformer\n"
        "import theanompi_tpu_torch.data.lm, theanompi_tpu_torch.ops.flash_attention\n"
        "import theanompi_tpu_torch.ops.ring_attention\n"
        "import theanompi_tpu_torch.ops.pool, theanompi_tpu_torch.models.googlenet\n"
        "import theanompi_tpu_torch.native, theanompi_tpu_torch.utils.hostaffinity\n"
        "import theanompi_tpu_torch.data.loader, theanompi_tpu_torch.data.imagenet\n"
        "import theanompi_tpu_torch.tools.profile_step\n"
        "import theanompi_tpu_torch.utils.checkpoint, theanompi_tpu_torch.utils.recorder\n"
        "import theanompi_tpu_torch.graphs, theanompi_tpu_torch.utils.flops\n"
        "import theanompi_tpu_torch.tools.bench\n"
        "import theanompi_tpu_torch.utils.faults, theanompi_tpu_torch.utils.dispatch\n"
        "import theanompi_tpu_torch.launch.supervisor\n"
        "import theanompi_tpu_torch.tools.make_shards, theanompi_tpu_torch.models.cifar10\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'theanompi_tpu'))\n"
        "print(bad)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_entry_points_raise_without_a_card_unless_cpu_is_asked_for(monkeypatch):
    """No silent CPU fallback: without CUDA, run_training(), BSPEngine,
    init_train_state, make_multi_step and the benchmark with no
    ``device`` raise before doing any work; ``device='cpu'`` is
    honoured."""
    from theanompi_tpu_torch.device import resolve_device
    from theanompi_tpu_torch.launch.worker import run_training
    from theanompi_tpu_torch.models.alex_net import AlexNet
    from theanompi_tpu_torch.parallel.bsp import BSPEngine
    from theanompi_tpu_torch.tools.bench import bench_compute
    from theanompi_tpu_torch.train import init_train_state, make_multi_step

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_training(model_cls=AlexNet, max_steps=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BSPEngine(AlexNet())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BSPEngine(AlexNet(), n_devices=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_train_state(AlexNet(), torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_multi_step(lambda *a: a, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_compute("alexnet", steps=1, trials=1)
    assert BSPEngine(AlexNet(), device="cpu").device == torch.device("cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    # the precision policy is set by every resolution: fp32 stays fp32
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_multi_device_bsp_is_refused_until_ported():
    """Multi-rank BSP runs one process per rank; an engine for n > 1 in a
    process that is no rank of an n-rank process group refuses to build
    (it would otherwise train alone and call that BSP)."""
    from theanompi_tpu_torch.models.alex_net import AlexNet
    from theanompi_tpu_torch.parallel.bsp import BSPEngine

    with pytest.raises(RuntimeError, match="process group of 2 ranks"):
        BSPEngine(AlexNet(), n_devices=2, device="cpu")


def test_rank_launcher_needs_the_cards_unless_cpu_is_asked_for(monkeypatch):
    """``BSP n`` puts rank r on card r: without CUDA, or with fewer than
    n cards, the launcher raises before spawning anything; NCCL refuses
    ranks that would share a card."""
    from theanompi_tpu_torch.launch.session import launch_training, rank_devices, spawn_ranks

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_training("bsp", 2, "alexnet", "AlexNet")
    assert rank_devices(3, "cpu") == [torch.device("cpu")] * 3
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="needs 2 cards; 1 visible"):
        rank_devices(2)
    with pytest.raises(ValueError, match="NCCL needs one card per rank"):
        spawn_ranks(print, 2, device="cuda:0", backend="nccl")


def test_lm_entry_points_raise_without_a_card_unless_cpu_is_asked_for(monkeypatch):
    """The LM slice's entry points take the same road: without CUDA the
    CLI's run, the engine and the train state raise before any work; the
    flash wrappers take their plain versions only for CPU tensors."""
    from theanompi_tpu_torch import cli
    from theanompi_tpu_torch.launch.worker import run_training
    from theanompi_tpu_torch.models.lm import TransformerLM_136M, TransformerLMModel
    from theanompi_tpu_torch.ops import flash_attention as tfa
    from theanompi_tpu_torch.parallel.bsp import BSPEngine
    from theanompi_tpu_torch.train import init_train_state

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["BSP", "1", "transformer_lm", "TransformerLM_136M", "--synthetic",
                  "--max-steps", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_training(model_cls=TransformerLM_136M, max_steps=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BSPEngine(TransformerLMModel())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_train_state(TransformerLMModel(), torch.Generator().manual_seed(0))
    assert BSPEngine(TransformerLMModel(), device="cpu").device == torch.device("cpu")
    meta = torch.empty(2, 8, 4, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_dq(meta, meta, meta, meta, meta, meta, causal=True, scale=1.0)


def test_googlenet_entry_points_raise_without_a_card_unless_cpu_is_asked_for(monkeypatch):
    """The GoogLeNet slice takes the same road: without CUDA the CLI's run
    (``--pool-kernel`` included), the engine and the train state raise
    before any work; ``device='cpu'`` is honoured. The pool wrappers take
    their plain versions only for CPU tensors: any other tensor launches
    the kernel or raises."""
    from theanompi_tpu_torch import cli
    from theanompi_tpu_torch.launch.worker import run_training
    from theanompi_tpu_torch.models.googlenet import GoogLeNet
    from theanompi_tpu_torch.ops import pool as tpool
    from theanompi_tpu_torch.parallel.bsp import BSPEngine
    from theanompi_tpu_torch.train import init_train_state

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["BSP", "1", "googlenet", "GoogLeNet", "--synthetic", "--pool-kernel",
                  "--fused-update", "--batch-size", "512", "--max-steps", "6"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_training(model_cls=GoogLeNet, pool_kernel=True, max_steps=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BSPEngine(GoogLeNet(pool_kernel=True))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_train_state(GoogLeNet(), torch.Generator().manual_seed(0))
    assert BSPEngine(GoogLeNet(pool_kernel=True), device="cpu").device == torch.device("cpu")
    meta = torch.empty(2, 8, 8, 16, device="meta")
    for fn, args in ((tpool.maxpool3x3_fwd, (meta,)), (tpool.maxpool3x3_bwd, (meta,) * 3),
                     (tpool.maxpool3x3_s1, (meta,))):
        with pytest.raises(ValueError, match="CUDA"):
            fn(*args)
    with pytest.raises(ValueError, match="NHWC"):
        tpool.maxpool3x3_fwd(torch.empty(8, 8, 16, device="meta"))
    assert tpool.MAXPOOL_FWD.launches == 0 and tpool.MAXPOOL_BWD.launches == 0


def test_new_feed_and_bench_modules_import_no_jax_no_reference_and_no_pil():
    """``tools/make_shards.py`` and the bench's e2e and scaling modes (and
    what they import when they run) import neither JAX nor the JAX
    package, and importing ``make_shards`` does not import PIL (only its
    decode worker does)."""
    new = [PORT / "tools" / "make_shards.py", PORT / "tools" / "bench.py"]
    bad = [f"{f.relative_to(REPO)}:{line} imports {mod}"
           for f in new for line, mod in _imports(f) if forbidden_import(mod)]
    assert not bad, "\n".join(bad)
    code = (
        "import sys\n"
        "import theanompi_tpu_torch.tools.make_shards, theanompi_tpu_torch.tools.bench\n"
        "import theanompi_tpu_torch.models.cifar10, theanompi_tpu_torch.launch.supervisor\n"
        "import theanompi_tpu_torch.data.imagenet, theanompi_tpu_torch.models.alex_net\n"
        "from theanompi_tpu_torch.tools.bench import bench_e2e, bench_scaling\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'theanompi_tpu', 'PIL'))\n"
        "print(bad)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_bench_modes_raise_without_a_card_unless_cpu_is_asked_for(monkeypatch):
    """The e2e and scaling modes take the entry points' road: without CUDA
    and without ``device='cpu'`` they raise before writing a shard or
    spawning a rank."""
    from theanompi_tpu_torch.tools import bench

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.bench_e2e(steps=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.bench_scaling((1,), steps=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main(["--mode", "e2e", "--steps", "1"])
