"""Image-mask loader (counterpart of gs2pc.io.masks, which reaches JAX
through its logger)."""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

from gs2pc_torch.utils import log


def load_image_masks(directory_path: str) -> Dict[str, np.ndarray]:
    """Load all masks in a directory as {basename-sans-ext: (H, W) int32}.

    Grayscale conversion, per-file error tolerance, zero pixels = masked
    out — matching mask_dataloader.py:5-25.
    """
    from PIL import Image

    image_masks: Dict[str, np.ndarray] = {}
    for filename in os.listdir(directory_path):
        file_path = os.path.join(directory_path, filename)
        try:
            with Image.open(file_path) as img:
                arr = np.asarray(img.convert("L"), dtype=np.int32)
            key = os.path.basename(file_path).split(".")[0]
            image_masks[key] = arr
        except Exception as e:  # noqa: BLE001 — per-file tolerance
            log.warn(f"Could not load mask with name {filename}: {e}")
    return image_masks
