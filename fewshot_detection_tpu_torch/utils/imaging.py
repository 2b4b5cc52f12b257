"""Image IO helpers. PIL is imported inside the functions that open image
files, so the package imports (and serves in-memory data) without it."""

from __future__ import annotations

import numpy as np


def get_image_size(fname: str) -> tuple[int, int]:
    """(width, height) without decoding pixel data."""
    from PIL import Image

    with Image.open(fname) as im:
        return im.size


def load_image_resized(fname: str, width: int, height: int) -> np.ndarray:
    """float32 HWC [0,1] resized input (reference detect.py:26-27 semantics)."""
    from PIL import Image

    img = Image.open(fname).convert("RGB")
    img = img.resize((width, height))
    return np.asarray(img, np.uint8).astype(np.float32) / 255.0
