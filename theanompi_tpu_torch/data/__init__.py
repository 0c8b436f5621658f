"""Datasets of the port."""

from theanompi_tpu_torch.data.datasets import Dataset, Synthetic_data, get_dataset  # noqa: F401
