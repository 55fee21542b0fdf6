"""Host-side image loading (CLI layer; the port's own copy of
``invcompcamtrack_tpu/utils/image.py``).  PIL is imported inside the
functions, so that callers holding their images as arrays need none."""

from __future__ import annotations

import numpy as np


def load_gray(path) -> np.ndarray:
    """Grayscale float32 image, matching the reference's
    cv::imread(..., GRAYSCALE) + convertTo(CV_32F) (ITU-R 601 luma)."""
    from PIL import Image

    img = Image.open(path)
    if img.mode != "L":
        img = img.convert("L")
    return np.asarray(img, np.float32)


def save_gray(path, img: np.ndarray) -> None:
    from PIL import Image

    Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(path)
