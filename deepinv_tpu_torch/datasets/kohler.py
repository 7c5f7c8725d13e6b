"""The Köhler camera-shake deblurring benchmark (port of
deepinv_tpu/datasets/kohler.py).

48 real blurry shots, 4 printouts x 12 camera trajectories, each with about
199 sharp video frames as ground truth. The layout of the extracted
archives::

    root --- Image<p>/Kernel<t>/GroundTruth<p>_<t>_<f>.png   (sharp frames)
         --- Blurry<p>_<t>.png                               (blurry shots)

Items are PIL images, or what the transform makes of them; PIL is imported
where an image is read. ``download=True`` raises: place the extracted
archives under ``root``.
"""

from __future__ import annotations

import os
from typing import Callable, Union

from .base import ImageDataset

__all__ = ["Kohler"]


def _load_image(path, transform):
    from PIL import Image

    img = Image.open(path)
    if transform is not None:
        return transform(img)
    return img


class Kohler(ImageDataset):
    """The Köhler dataset, indexed by printout and trajectory (kohler.py:37).

    :param root: extracted dataset root.
    :param frames: frame selection — an index (1-based), ``"first"``,
        ``"middle"``, ``"last"``, ``"all"``, or a list of these.
    :param ordering: ``"printout_first"`` (default) or ``"trajectory_first"``.
    :param transform: applied to both sharp frames and blurry shots.
    :param download: refused: the port downloads nothing.
    """

    # the acquisitions that do not span exactly 199 frames (kohler.py:48)
    _frame_count_table = {
        (2, 11): 200,
        (1, 10): 198,
        (1, 12): 198,
        (2, 10): 198,
        (3, 7): 198,
        (3, 12): 198,
        (4, 12): 198,
    }
    _default_frame_count = 199

    def __init__(
        self,
        root: str,
        frames: Union[int, str, list] = "middle",
        ordering: str = "printout_first",
        transform: Callable = None,
        download: bool = False,
    ):
        if download:
            raise RuntimeError("Kohler: the port downloads nothing; extract the five archives of "
                               f"the ECCV 2012 benchmark under {root} (kohler.py:68).")
        if ordering not in ("printout_first", "trajectory_first"):
            raise ValueError(f"Unsupported ordering: {ordering}")
        self.root = root
        self.frames = frames
        self.ordering = ordering
        self.transform = transform

    def __len__(self) -> int:
        return 48

    def __getitem__(self, index: int):
        if self.ordering == "printout_first":
            printout_index = index // 12 + 1
            trajectory_index = index % 12 + 1
        else:
            printout_index = index % 12 + 1
            trajectory_index = index // 12 + 1
        return self.get_item(printout_index, trajectory_index, frames=self.frames)

    def get_item(self, printout_index: int, trajectory_index: int, frames=None):
        """``(sharp frame(s), blurry shot)`` by printout and trajectory index
        (kohler.py:93)."""
        blurry_shot = self.get_blurry_shot(printout_index, trajectory_index)
        if frames is None:
            frames = self.frames
        if frames == "all" or isinstance(frames, list):
            if frames == "all":
                frames = range(
                    1, self.get_frame_count(printout_index, trajectory_index) + 1
                )
            sharp = [
                self.get_sharp_frame(
                    printout_index, trajectory_index,
                    self.select_frame(printout_index, trajectory_index, f),
                )
                for f in frames
            ]
            return sharp, blurry_shot
        frame_index = self.select_frame(printout_index, trajectory_index, frames)
        return (
            self.get_sharp_frame(printout_index, trajectory_index, frame_index),
            blurry_shot,
        )

    def get_sharp_frame(self, printout_index, trajectory_index, frame_index):
        path = os.path.join(
            self.root,
            f"Image{printout_index}",
            f"Kernel{trajectory_index}",
            f"GroundTruth{printout_index}_{trajectory_index}_{frame_index}.png",
        )
        return _load_image(path, self.transform)

    def get_blurry_shot(self, printout_index, trajectory_index):
        path = os.path.join(
            self.root, f"Blurry{printout_index}_{trajectory_index}.png"
        )
        return _load_image(path, self.transform)

    @classmethod
    def select_frame(cls, printout_index, trajectory_index, frame):
        if isinstance(frame, int):
            return frame
        count = cls.get_frame_count(printout_index, trajectory_index)
        if frame == "first":
            return 1
        if frame == "middle":
            return (count + 1) // 2
        if frame == "last":
            return count
        raise ValueError(f"Unsupported frame selection: {frame}")

    @classmethod
    def get_frame_count(cls, printout_index, trajectory_index) -> int:
        return cls._frame_count_table.get(
            (printout_index, trajectory_index), cls._default_frame_count
        )
