"""Utilities of the port (deepinv_tpu/utils/)."""

from .logger import AverageMeter

__all__ = ["AverageMeter"]
