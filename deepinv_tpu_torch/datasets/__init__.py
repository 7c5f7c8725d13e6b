"""Datasets of the port (deepinv_tpu/datasets/). Importing it needs none of
h5py, PIL or pydicom: each is imported where a file is written or read."""

from .base import (ArrayDataset, DataLoader, ImageDataset, PatchDataset, RandomPatchSampler,
                   TensorDataset, check_dataset, random_split)
from .datagenerator import HDF5Dataset, generate_dataset
from .fastmri import FastMRISliceDataset, MRISliceTransform, SimpleFastMRISliceDataset
from .fmd import FMD
from .folder import (BSDS500, CBSD68, DIV2K, Flickr2kHR, ImageFolder, LsdirHR, Set14HR,
                     Urban100HR, load_image)
from .kohler import Kohler
from .lidc_idri import LidcIdriSliceDataset
from .mri_slices import CMRxReconSliceDataset, SKMTEASliceDataset
from .phantoms import (RandomPhantomDataset, SheppLoganDataset, generate_random_phantom,
                       random_circles, random_shapes, shepp_logan)
from .satellite import NBUDataset

__all__ = ["ImageDataset", "ArrayDataset", "TensorDataset", "DataLoader", "PatchDataset",
           "RandomPatchSampler", "random_split", "check_dataset", "generate_dataset",
           "HDF5Dataset", "ImageFolder", "DIV2K", "Urban100HR", "Set14HR", "CBSD68", "BSDS500",
           "Flickr2kHR", "LsdirHR", "load_image", "shepp_logan", "random_circles",
           "random_shapes", "generate_random_phantom", "SheppLoganDataset",
           "RandomPhantomDataset", "FastMRISliceDataset", "SimpleFastMRISliceDataset",
           "MRISliceTransform", "CMRxReconSliceDataset", "SKMTEASliceDataset", "FMD", "Kohler",
           "LidcIdriSliceDataset", "NBUDataset", "download_archive"]


def download_archive(url, save_path, extract: bool = True):
    """Refused (deepinv_tpu/datasets/__init__.py:28): the port downloads
    nothing; place the files locally and pass the datasets their ``root``."""
    raise RuntimeError(f"downloads are not supported - cannot download {url}; provide the files "
                       "locally instead")
