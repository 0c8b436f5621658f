"""Tiny MLP — the smoke model of the zoo.

Port of ``theanompi_tpu/models/mlp.py``: flatten, two hidden dense
layers (128, 64) with ReLU, a linear head; momentum 0.9 at a constant
LR 0.01, batch 64, 16x16x3 inputs, 10 classes, fp32. A multi-leaf
param tree that is cheap enough for any CPU run (``mlp`` in the zoo);
it is also an ordinary model (``BSP 1 mlp MLP`` trains).
"""

from __future__ import annotations

from theanompi_tpu_torch import nn
from theanompi_tpu_torch.models.contract import Model, Recipe


class MLP(Model):
    name = "mlp"

    @classmethod
    def default_recipe(cls) -> Recipe:
        return Recipe(
            batch_size=64,
            n_epochs=5,
            optimizer="momentum",
            opt_kwargs={"momentum": 0.9},
            schedule="constant",
            sched_kwargs={"lr": 0.01},
            input_shape=(16, 16, 3),
            num_classes=10,
            dataset="synthetic",
        )

    def build(self):
        return nn.Sequential(
            [
                nn.Flatten(),
                nn.Dense(128, name="fc1"),
                nn.Activation("relu"),
                nn.Dense(64, name="fc2"),
                nn.Activation("relu"),
                nn.Dense(self.recipe.num_classes, name="out"),
            ],
            name="mlp",
        )
