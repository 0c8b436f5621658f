"""Datasets of the port, and the prefetch loader."""

from theanompi_tpu_torch.data.datasets import Dataset, Synthetic_data, get_dataset  # noqa: F401
from theanompi_tpu_torch.data import lm  # noqa: F401,E402  (registers lm_synthetic, lm_text)
from theanompi_tpu_torch.data import imagenet  # noqa: F401,E402  (registers imagenet, imagenet_synthetic)
