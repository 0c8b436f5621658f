"""ResNet-50 — the model of BASELINE config #4.

Port of ``theanompi_tpu/models/model_zoo/resnet50.py`` block for block
(He et al. 2015): a 7x7/2 stem conv with BN and ReLU, a 3x3/2 max pool
(explicit padding 1), four stages of bottleneck blocks [3, 4, 6, 3] at
widths 256 / 512 / 1024 / 2048, post-activation BN, projection
shortcuts on stage entry, the stride on the 3x3 (v1.5), global average
pool and a linear head. Recipe: batch 256, momentum 0.9, weight decay
1e-4, LR 0.1 stepped /10 at epochs 30 / 60 / 80, 90 epochs, 224x224x3,
1000 classes, bf16 compute, fp32 params.

SAME convs with stride 2 on even sizes pad asymmetrically (the stem's
7x7/2 on 224 pads (2, 3); the 3x3/2 convs (0, 1)): ``nn.Conv`` applies
those pads with ``F.pad``, a copy, as the reference's padding does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from theanompi_tpu_torch import nn
from theanompi_tpu_torch.models.contract import Model, Recipe
from theanompi_tpu_torch.nn import init as initializers
from theanompi_tpu_torch.nn.layers import Layer

_he = initializers.he_normal()


def _conv(out_c, k, stride, name):
    return nn.Conv(out_c, k, stride=stride, padding="SAME", use_bias=False, w_init=_he,
                   name=name)


class Bottleneck(Layer):
    """1x1 -> 3x3 (stride) -> 1x1, BN after each conv, ReLU after the
    first two and after the residual add (post-activation v1 form).

    Params ``{c1, bn1, c2, bn2, c3, bn3[, proj, bnp]}`` and state ``{bn1,
    bn2, bn3[, bnp]}``, the reference's tree; each conv kernel is tagged
    ``CONV_KERNEL`` (``param_layouts``)."""

    def __init__(self, in_c, width, out_c, stride=1, bn_axis=None, name="bneck"):
        self.name = name
        self.needs_proj = stride != 1 or in_c != out_c
        self.stages = [(_conv(width, 1, 1, "c1"), nn.BatchNorm(axis_name=bn_axis)),
                       (_conv(width, 3, stride, "c2"), nn.BatchNorm(axis_name=bn_axis)),
                       (_conv(out_c, 1, 1, "c3"), nn.BatchNorm(axis_name=bn_axis))]
        self.parts = {}
        for i, (conv, bn) in enumerate(self.stages, 1):
            self.parts[f"c{i}"], self.parts[f"bn{i}"] = conv, bn
        if self.needs_proj:
            self.proj, self.bnp = _conv(out_c, 1, stride, "proj"), nn.BatchNorm(axis_name=bn_axis)
            self.parts["proj"], self.parts["bnp"] = self.proj, self.bnp

    def init(self, gen, in_shape):
        params, state = {}, {}
        shape = in_shape
        for i, (conv, bn) in enumerate(self.stages, 1):
            params[f"c{i}"], _ = conv.init(gen, shape)
            shape = conv.out_shape(shape)
            params[f"bn{i}"], state[f"bn{i}"] = bn.init(gen, shape)
        if self.needs_proj:
            params["proj"], _ = self.proj.init(gen, in_shape)
            params["bnp"], state["bnp"] = self.bnp.init(gen, self.proj.out_shape(in_shape))
        return params, state

    def apply(self, params, state, x, *, train=False, gen=None):
        new_state = dict(state)
        h = x
        for i, (conv, bn) in enumerate(self.stages, 1):
            h, _ = conv.apply(params[f"c{i}"], {}, h)
            h, new_state[f"bn{i}"] = bn.apply(params[f"bn{i}"], state[f"bn{i}"], h, train=train)
            if i < 3:
                h = F.relu(h)
        if self.needs_proj:
            sc, _ = self.proj.apply(params["proj"], {}, x)
            sc, new_state["bnp"] = self.bnp.apply(params["bnp"], state["bnp"], sc, train=train)
        else:
            sc = x
        return F.relu(h + sc), new_state

    def out_shape(self, in_shape):
        shape = in_shape
        for conv, _ in self.stages:
            shape = conv.out_shape(shape)
        return shape

    def param_layouts(self, params) -> dict:
        return {k: self.parts[k].param_layouts(params[k]) for k in params}


_STAGES = [(3, 64, 256, 1), (4, 128, 512, 2), (6, 256, 1024, 2), (3, 512, 2048, 2)]


class ResNet50(Model):
    name = "resnet50"

    @classmethod
    def default_recipe(cls) -> Recipe:
        return Recipe(
            batch_size=256,
            n_epochs=90,
            optimizer="momentum",
            opt_kwargs={"momentum": 0.9, "weight_decay": 1e-4},
            schedule="step",
            sched_kwargs={"lr": 0.1, "boundaries": [30, 60, 80], "factor": 0.1},
            lr_unit="epoch",
            input_shape=(224, 224, 3),
            num_classes=1000,
            compute_dtype=torch.bfloat16,
            dataset="imagenet",
        )

    def build(self):
        bn_axis = self.recipe.bn_axis_name
        layers: list = [
            nn.Conv(64, 7, stride=2, padding="SAME", use_bias=False, w_init=_he, name="stem"),
            nn.BatchNorm(axis_name=bn_axis, name="stem_bn"),
            nn.Activation("relu"),
            nn.Pool(3, stride=2, padding=1, mode="max"),
        ]
        in_c = 64
        for si, (reps, width, out_c, stride) in enumerate(_STAGES, 2):
            for ri in range(reps):
                layers.append(Bottleneck(in_c, width, out_c, stride=stride if ri == 0 else 1,
                                         bn_axis=bn_axis, name=f"res{si}{chr(97 + ri)}"))
                in_c = out_c
        layers += [nn.GlobalAvgPool(), nn.Dense(self.recipe.num_classes, name="fc1000")]
        return nn.Sequential(layers, name="resnet50")
