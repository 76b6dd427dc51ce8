"""Image IO and the texture library.

Port of ``raytracer_tpu/utils/image.py``. Decoded images are packed
offline into one compressed ``.npz`` library (the repository's own
``assets/textures.npz``), looked up by file name at scene build. Reading
the library needs only numpy; decoding or writing a PNG needs Pillow,
imported where it is used.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

_ASSETS = os.path.join(os.path.dirname(__file__), "..", "..", "assets")


def save_png(path: str, image_u8: np.ndarray) -> None:
    from PIL import Image
    Image.fromarray(image_u8).save(path)


def load_image(path: str) -> np.ndarray:
    """Decode an image file to (H, W, 3) float32 in [0, 1], with the
    reference converter's /256 normalisation
    (textures/parse_textures.py:35)."""
    from PIL import Image
    img = Image.open(path).convert("RGB")
    return (np.asarray(img, np.float32) / 256.0).astype(np.float32)


class TextureLibrary:
    """Texture lookup by file name (the reference's ``ImageTexture``,
    src/main.cu:40-91, including its file-not-found error)."""

    def __init__(self, path: str):
        self._npz = np.load(path)

    def names(self):
        return list(self._npz.files)

    def get(self, filename: str) -> np.ndarray:
        if filename not in self._npz.files:
            raise FileNotFoundError("Image file not found.")
        return self._npz[filename]


def find_texture_library(explicit: Optional[str] = None) -> Optional[str]:
    """The library to read: ``explicit``, then $RAYTRACER_TEXTURES, then
    the checkout's assets/textures.npz (the JAX package's order)."""
    for p in (explicit, os.environ.get("RAYTRACER_TEXTURES"),
              os.path.join(_ASSETS, "textures.npz")):
        if p and os.path.exists(p):
            return p
    return None
