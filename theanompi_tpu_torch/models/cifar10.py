"""Small CIFAR-10 CNN — the README quick-start model.

Port of ``theanompi_tpu/models/cifar10.py`` layer for layer: two
conv (5x5 SAME) + ReLU + 3x3/s2 max pool + LRN stages (64, 128 channels,
He-normal inits), two hidden dense layers (384, 192) with dropout 0.5,
a linear head. Recipe: batch 128, momentum 0.9, weight decay 1e-4, LR
0.01 stepped /10 at epochs 40 and 60, 70 epochs, 32x32x3, 10 classes,
fp32. Its dataset is ``cifar10`` (the ``cifar-10-batches-py`` files);
``--synthetic`` trains on seeded data of the same shape.
"""

from __future__ import annotations

from theanompi_tpu_torch import nn
from theanompi_tpu_torch.models.contract import Model, Recipe
from theanompi_tpu_torch.nn import init as initializers


class Cifar10_model(Model):
    name = "cifar10"

    @classmethod
    def default_recipe(cls) -> Recipe:
        return Recipe(
            batch_size=128,
            n_epochs=70,
            optimizer="momentum",
            opt_kwargs={"momentum": 0.9, "weight_decay": 1e-4},
            schedule="step",
            sched_kwargs={"lr": 0.01, "boundaries": [40, 60], "factor": 0.1},
            lr_unit="epoch",
            input_shape=(32, 32, 3),
            num_classes=10,
            dataset="cifar10",
        )

    def build(self):
        he = initializers.he_normal()
        return nn.Sequential(
            [
                nn.Conv(64, 5, padding="SAME", w_init=he, name="conv1"),
                nn.Activation("relu"),
                nn.Pool(3, stride=2, mode="max"),
                nn.LRN(),
                nn.Conv(128, 5, padding="SAME", w_init=he, name="conv2"),
                nn.Activation("relu"),
                nn.Pool(3, stride=2, mode="max"),
                nn.LRN(),
                nn.Flatten(),
                nn.Dense(384, name="fc3"),
                nn.Activation("relu"),
                nn.Dropout(0.5),
                nn.Dense(192, name="fc4"),
                nn.Activation("relu"),
                nn.Dropout(0.5),
                nn.Dense(self.recipe.num_classes, name="softmax"),
            ],
            name="cifar10_cnn",
        )
