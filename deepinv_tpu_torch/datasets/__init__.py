"""Datasets of the port (deepinv_tpu/datasets/)."""

from .base import ArrayDataset, DataLoader, ImageDataset, TensorDataset, check_dataset

__all__ = ["ImageDataset", "ArrayDataset", "TensorDataset", "DataLoader", "check_dataset"]
