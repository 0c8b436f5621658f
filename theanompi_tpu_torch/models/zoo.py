"""The one eval-mode forward of a model (port of
``theanompi_tpu/models/zoo.py::infer_fn``)."""

from __future__ import annotations

import torch


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
