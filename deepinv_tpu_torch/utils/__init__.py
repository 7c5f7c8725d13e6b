"""Utilities of the port (deepinv_tpu/utils/)."""

from .logger import AverageMeter
from .mixins import (TiledMixin2d, TimeMixin, image_to_patches, patches_to_image, patchify,
                     tiled_apply)

__all__ = ["AverageMeter", "TimeMixin", "TiledMixin2d", "tiled_apply", "image_to_patches",
           "patches_to_image", "patchify"]
