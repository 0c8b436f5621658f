"""AlexNet — the reference's primary benchmark model.

Port of ``theanompi_tpu/models/alex_net.py`` layer for layer:
Krizhevsky et al. 2012 in the one-tower grouped form (channel groups=2
on conv2/4/5, LRN after conv1/conv2, overlapping 3x3/s2 max pools,
4096-wide FC with 0.5 dropout). Recipe: batch 128, momentum 0.9, weight
decay 5e-4, LR 0.01 stepped /10 at epochs 30/50/65, gaussian inits with
constant biases (1.0 on conv2/4/5 and fc6/7). Compute in bf16, params
fp32.
"""

from __future__ import annotations

import torch

from theanompi_tpu_torch import nn
from theanompi_tpu_torch.models.contract import Model, Recipe
from theanompi_tpu_torch.nn import init as initializers


class AlexNet(Model):
    name = "alexnet"

    @classmethod
    def default_recipe(cls) -> Recipe:
        return Recipe(
            batch_size=128,
            n_epochs=70,
            optimizer="momentum",
            opt_kwargs={"momentum": 0.9, "weight_decay": 5e-4},
            schedule="step",
            sched_kwargs={"lr": 0.01, "boundaries": [30, 50, 65], "factor": 0.1},
            lr_unit="epoch",
            input_shape=(227, 227, 3),
            num_classes=1000,
            compute_dtype=torch.bfloat16,
            dataset="imagenet",
        )

    def build(self):
        g = initializers.gaussian
        one = initializers.constant(1.0)
        ncls = self.recipe.num_classes
        return nn.Sequential(
            [
                nn.Conv(96, 11, stride=4, padding="VALID", w_init=g(0.01), name="conv1"),
                nn.Activation("relu"),
                nn.LRN(n=5, alpha=1e-4, beta=0.75, k=2.0),
                nn.Pool(3, stride=2, mode="max"),
                nn.Conv(256, 5, padding=2, groups=2, w_init=g(0.01), b_init=one, name="conv2"),
                nn.Activation("relu"),
                nn.LRN(n=5, alpha=1e-4, beta=0.75, k=2.0),
                nn.Pool(3, stride=2, mode="max"),
                nn.Conv(384, 3, padding=1, w_init=g(0.01), name="conv3"),
                nn.Activation("relu"),
                nn.Conv(384, 3, padding=1, groups=2, w_init=g(0.01), b_init=one, name="conv4"),
                nn.Activation("relu"),
                nn.Conv(256, 3, padding=1, groups=2, w_init=g(0.01), b_init=one, name="conv5"),
                nn.Activation("relu"),
                nn.Pool(3, stride=2, mode="max"),
                nn.Flatten(),
                nn.Dense(4096, w_init=g(0.005), b_init=one, name="fc6"),
                nn.Activation("relu"),
                nn.Dropout(0.5),
                nn.Dense(4096, w_init=g(0.005), b_init=one, name="fc7"),
                nn.Activation("relu"),
                nn.Dropout(0.5),
                nn.Dense(ncls, w_init=g(0.01), name="fc8"),
            ],
            name="alexnet",
        )
