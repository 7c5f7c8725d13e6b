"""Datasets of the port (deepinv_tpu/datasets/)."""

from .base import ArrayDataset, DataLoader, ImageDataset, TensorDataset, check_dataset
from .phantoms import (RandomPhantomDataset, SheppLoganDataset, generate_random_phantom,
                       random_circles, random_shapes, shepp_logan)

__all__ = ["ImageDataset", "ArrayDataset", "TensorDataset", "DataLoader", "check_dataset",
           "shepp_logan", "random_circles", "random_shapes", "generate_random_phantom",
           "SheppLoganDataset", "RandomPhantomDataset"]
