"""The benchable zoo and the one eval-mode forward of a model (port of
``theanompi_tpu/models/zoo.py``).

``zoo_entry`` maps a zoo name to its model class and its one-card global
batch. Batches are the reference's: AlexNet the reference workload's
global batch (BASELINE config #2: 8 workers x 128 = 1024), GoogLeNet
512, ResNet-50 config #4's 256, VGG16 128, WRN-28-10 1024, the 136M and
350M LMs 8 windows of 1024 tokens; ``mlp`` is the cheap smoke entry. Each trains
at full width on one 80 GB H100 (``chip_smoke.py`` runs every one of
them and reads the peak memory of the batches 1024 in phase zoo-main;
PERF.md §5).
"""

from __future__ import annotations

import torch

# name -> one-card global batch; the class is MODEL_REGISTRY's, but for
# the names the registry holds otherwise or not at all
_ZOO = {"mlp": 64, "alexnet": 1024, "googlenet": 512, "resnet50": 256, "vgg16": 128,
        "wrn": 1024, "transformer_lm": 8, "transformer_lm_350m": 8}
_CLASSES = {"mlp": ("theanompi_tpu_torch.models.mlp", "MLP"),
            "transformer_lm": ("theanompi_tpu_torch.models.lm", "TransformerLM_136M"),
            "transformer_lm_350m": ("theanompi_tpu_torch.models.lm", "TransformerLM_350M")}


def zoo_entry(name: str):
    """``(model_cls, one_card_global_batch)`` for a zoo name (mlp /
    alexnet / googlenet / resnet50 / vgg16 / wrn / transformer_lm /
    transformer_lm_350m)."""
    import importlib

    from theanompi_tpu_torch.models import MODEL_REGISTRY

    if name not in _ZOO:
        raise ValueError(f"unknown bench model {name!r}; available: {sorted(_ZOO)}")
    module, cls = _CLASSES.get(name) or MODEL_REGISTRY[name]
    return getattr(importlib.import_module(module), cls), _ZOO[name]


def infer_fn(model):
    """The eval-mode forward ``(params, model_state, x) -> logits``:
    ``train=False``, no generator, no autograd graph — the one
    definition shared by validation (``train.make_eval_step``) and,
    later, serving."""

    def fwd(params, model_state, x):
        with torch.no_grad():
            logits, _ = model.apply(params, model_state, x, train=False)
        return logits

    return fwd
