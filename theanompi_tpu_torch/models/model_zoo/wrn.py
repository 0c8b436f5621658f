"""Wide Residual Network (WRN-28-10) on CIFAR-10 — BASELINE config #1
(one BSP worker).

Port of ``theanompi_tpu/models/model_zoo/wrn.py`` block for block
(Zagoruyko & Komodakis 2016): a 3x3 stem conv of 16, three stages of
``(depth - 4) / 6`` pre-activation residual blocks at widths 16k / 32k /
64k with strides 1 / 2 / 2, then BN, ReLU, global average pool and a
linear head. Recipe: batch 128, Nesterov momentum 0.9, weight decay
5e-4, LR 0.1 stepped x0.2 at epochs 60 / 120 / 160, 200 epochs,
He-normal inits, 32x32x3, 10 classes, fp32 compute.
"""

from __future__ import annotations

import torch.nn.functional as F

from theanompi_tpu_torch import nn
from theanompi_tpu_torch.models.contract import Model, Recipe
from theanompi_tpu_torch.nn import init as initializers
from theanompi_tpu_torch.nn.layers import Layer


class PreActBlock(Layer):
    """BN-ReLU-Conv3x3-(Dropout)-BN-ReLU-Conv3x3 + shortcut. When the
    shape changes the shortcut is a 1x1 conv (VALID, the block's stride)
    of the pre-activated input, as in the WRN paper.

    Params ``{bn1, conv1, bn2, conv2[, proj]}`` and state ``{bn1, bn2}``,
    the reference's tree; each conv kernel is tagged ``CONV_KERNEL``
    (``param_layouts``)."""

    def __init__(self, in_c: int, out_c: int, stride: int = 1, dropout: float = 0.0,
                 bn_axis=None, name: str = "preact"):
        self.name = name
        he = initializers.he_normal()
        self.bn1 = nn.BatchNorm(axis_name=bn_axis)
        self.conv1 = nn.Conv(out_c, 3, stride=stride, padding="SAME", use_bias=False, w_init=he)
        self.dropout = nn.Dropout(dropout) if dropout > 0 else None
        self.bn2 = nn.BatchNorm(axis_name=bn_axis)
        self.conv2 = nn.Conv(out_c, 3, stride=1, padding="SAME", use_bias=False, w_init=he)
        self.proj = (nn.Conv(out_c, 1, stride=stride, padding="VALID", use_bias=False, w_init=he)
                     if stride != 1 or in_c != out_c else None)
        self.parts = {"bn1": self.bn1, "conv1": self.conv1, "bn2": self.bn2,
                      "conv2": self.conv2}
        if self.proj is not None:
            self.parts["proj"] = self.proj

    def init(self, gen, in_shape):
        params, state = {}, {}
        params["bn1"], state["bn1"] = self.bn1.init(gen, in_shape)
        params["conv1"], _ = self.conv1.init(gen, in_shape)
        mid = self.conv1.out_shape(in_shape)
        params["bn2"], state["bn2"] = self.bn2.init(gen, mid)
        params["conv2"], _ = self.conv2.init(gen, mid)
        if self.proj is not None:
            params["proj"], _ = self.proj.init(gen, in_shape)
        return params, state

    def apply(self, params, state, x, *, train=False, gen=None):
        new_state = dict(state)
        h, new_state["bn1"] = self.bn1.apply(params["bn1"], state["bn1"], x, train=train)
        h = F.relu(h)
        shortcut = x if self.proj is None else self.proj.apply(params["proj"], {}, h)[0]
        h, _ = self.conv1.apply(params["conv1"], {}, h)
        h, new_state["bn2"] = self.bn2.apply(params["bn2"], state["bn2"], h, train=train)
        h = F.relu(h)
        if self.dropout is not None and train:
            h, _ = self.dropout.apply({}, {}, h, train=train, gen=gen)
        h, _ = self.conv2.apply(params["conv2"], {}, h)
        return h + shortcut, new_state

    def out_shape(self, in_shape):
        return self.conv1.out_shape(in_shape)

    def param_layouts(self, params) -> dict:
        return {k: self.parts[k].param_layouts(params[k]) for k in params}


class WRN(Model):
    """Wide-ResNet; ``depth`` / ``widen`` default to the reference's 28-10."""

    name = "wrn"
    depth = 28
    widen = 10
    dropout = 0.0

    @classmethod
    def default_recipe(cls) -> Recipe:
        return Recipe(
            batch_size=128,
            n_epochs=200,
            optimizer="nesterov",
            opt_kwargs={"momentum": 0.9, "weight_decay": 5e-4},
            schedule="step",
            sched_kwargs={"lr": 0.1, "boundaries": [60, 120, 160], "factor": 0.2},
            lr_unit="epoch",
            input_shape=(32, 32, 3),
            num_classes=10,
            dataset="cifar10",
        )

    def build(self):
        if (self.depth - 4) % 6:
            raise ValueError(f"WRN depth must be 6n+4, got {self.depth}")
        n = (self.depth - 4) // 6
        k = self.widen
        bn_axis = self.recipe.bn_axis_name
        he = initializers.he_normal()
        layers: list = [nn.Conv(16, 3, padding="SAME", use_bias=False, w_init=he, name="stem")]
        in_c = 16
        for stage, (width, stride) in enumerate([(16 * k, 1), (32 * k, 2), (64 * k, 2)]):
            for block in range(n):
                layers.append(PreActBlock(in_c, width, stride=stride if block == 0 else 1,
                                          dropout=self.dropout, bn_axis=bn_axis,
                                          name=f"s{stage}b{block}"))
                in_c = width
        layers += [
            nn.BatchNorm(axis_name=bn_axis, name="final_bn"),
            nn.Activation("relu"),
            nn.GlobalAvgPool(),
            nn.Dense(self.recipe.num_classes, name="classifier"),
        ]
        return nn.Sequential(layers, name="wrn")


class WRN_16_4(WRN):
    """Smaller WRN for quick experiments and CPU tests."""

    name = "wrn_16_4"
    depth = 16
    widen = 4
