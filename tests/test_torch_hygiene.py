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
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'theanompi_tpu'))\n"
        "print(bad)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_entry_points_raise_without_a_card_unless_cpu_is_asked_for(monkeypatch):
    """No silent CPU fallback: without CUDA, run_training(), BSPEngine and
    init_train_state with no ``device`` raise before doing any work;
    ``device='cpu'`` is honoured."""
    from theanompi_tpu_torch.device import resolve_device
    from theanompi_tpu_torch.launch.worker import run_training
    from theanompi_tpu_torch.models.alex_net import AlexNet
    from theanompi_tpu_torch.parallel.bsp import BSPEngine
    from theanompi_tpu_torch.train import init_train_state

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_training(model_cls=AlexNet, max_steps=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BSPEngine(AlexNet())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_train_state(AlexNet(), torch.Generator().manual_seed(0))
    assert BSPEngine(AlexNet(), device="cpu").device == torch.device("cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    # the precision policy is set by every resolution: fp32 stays fp32
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_multi_device_bsp_is_refused_until_ported():
    from theanompi_tpu_torch.models.alex_net import AlexNet
    from theanompi_tpu_torch.parallel.bsp import BSPEngine

    with pytest.raises(NotImplementedError, match="multi-rank"):
        BSPEngine(AlexNet(), n_devices=2, device="cpu")
