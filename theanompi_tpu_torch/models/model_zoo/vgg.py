"""VGG16 — the model of BASELINE config #5.

Port of ``theanompi_tpu/models/model_zoo/vgg.py`` layer for layer
(Simonyan & Zisserman 2014, configuration D): thirteen 3x3 SAME convs
with ReLU in five blocks (64 / 128 / 256 / 512 / 512), each block ending
in a 2x2/2 max pool, then dense 4096 / 4096 with dropout 0.5 and a
linear head, the dense layers drawn from ``gaussian(0.01)``. Recipe:
batch 256, momentum 0.9, weight decay 5e-4, LR 0.01 stepped /10 at
epochs 50 / 65, 74 epochs, 224x224x3, 1000 classes, bf16 compute, fp32
params.
"""

from __future__ import annotations

import torch

from theanompi_tpu_torch import nn
from theanompi_tpu_torch.models.contract import Model, Recipe
from theanompi_tpu_torch.nn import init as initializers

_BLOCKS = [(2, 64), (2, 128), (3, 256), (3, 512), (3, 512)]


class VGG16(Model):
    name = "vgg16"

    @classmethod
    def default_recipe(cls) -> Recipe:
        return Recipe(
            batch_size=256,
            n_epochs=74,
            optimizer="momentum",
            opt_kwargs={"momentum": 0.9, "weight_decay": 5e-4},
            schedule="step",
            sched_kwargs={"lr": 0.01, "boundaries": [50, 65], "factor": 0.1},
            lr_unit="epoch",
            input_shape=(224, 224, 3),
            num_classes=1000,
            compute_dtype=torch.bfloat16,
            dataset="imagenet",
        )

    def build(self):
        he = initializers.he_normal()
        g = initializers.gaussian(0.01)
        layers = []
        for bi, (reps, width) in enumerate(_BLOCKS):
            for ri in range(reps):
                layers += [nn.Conv(width, 3, padding="SAME", w_init=he,
                                   name=f"conv{bi + 1}_{ri + 1}"),
                           nn.Activation("relu")]
            layers.append(nn.Pool(2, stride=2, mode="max"))
        layers += [
            nn.Flatten(),
            nn.Dense(4096, w_init=g, name="fc6"),
            nn.Activation("relu"),
            nn.Dropout(0.5),
            nn.Dense(4096, w_init=g, name="fc7"),
            nn.Activation("relu"),
            nn.Dropout(0.5),
            nn.Dense(self.recipe.num_classes, w_init=g, name="fc8"),
        ]
        return nn.Sequential(layers, name="vgg16")
