"""Image-sequence loading (the reference's SequenceLoader,
src/SequenceLoader.cpp:30-50).

Scans a directory for images by extension, parses an integer timestamp
from each filename stem starting at ``timestamp_offset``, sorts by
timestamp, and iterates ``(timestamp, path)`` pairs.  Image decode is
grayscale uint8 (the reference reads `cv::IMREAD_GRAYSCALE`,
src/Frame.cpp:146).
"""

from __future__ import annotations

import os

import numpy as np

from irotavg_tpu.utils.png import read_gray


class SequenceLoader:
    """Sorted (timestamp, path) iteration over a directory of images."""

    def __init__(self, path: str, im_ext: str = ".png",
                 timestamp_offset: int = 0):
        frames: list[tuple[int, str]] = []
        for name in os.listdir(path):
            full = os.path.join(path, name)
            stem, ext = os.path.splitext(name)
            if not os.path.isfile(full) or ext != im_ext:
                continue
            digits = stem[timestamp_offset:]
            # std::stoi semantics: parse the leading integer run
            num = ""
            for ch in digits:
                if ch.isdigit() or (ch in "+-" and not num):
                    num += ch
                else:
                    break
            if not num or num in "+-":
                raise ValueError(
                    f"no timestamp in filename {name!r} at offset "
                    f"{timestamp_offset}"
                )
            frames.append((int(num), full))
        frames.sort()
        self._frames = frames

    def __len__(self) -> int:
        return len(self._frames)

    def __iter__(self):
        return iter(self._frames)

    def __getitem__(self, i):
        return self._frames[i]


def load_gray(path: str) -> np.ndarray:
    """Read a PNG or binary PGM file as grayscale uint8 (H, W)."""
    return read_gray(path)
