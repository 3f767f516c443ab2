"""Image-grid utilities (Pillow-based, no matplotlib).

Functional replacement for the reference plotting helper
(src/utils/plotting.py:8 create_image_grid) and the visualization notebook
(dataset-visualize.ipynb, SURVEY.md §2.21): batches from the input pipeline
rendered as tiled grid images.  The port's own copy of
``geeco_tpu/utils/plotting.py``; Pillow is imported by the writer only.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def create_image_grid(images: Sequence[np.ndarray], cols: int = 4,
                      pad: int = 2, bg: int = 255) -> np.ndarray:
  """Tile [N] HxWx3 images (uint8 or [0,1] float) into one grid image."""
  imgs = []
  for im in images:
    im = np.asarray(im)
    if im.dtype != np.uint8:
      im = np.clip(im * 255.0, 0, 255).astype(np.uint8)
    if im.ndim == 2:
      im = np.stack([im] * 3, -1)
    imgs.append(im)
  n = len(imgs)
  rows = (n + cols - 1) // cols
  h, w = imgs[0].shape[:2]
  grid = np.full((rows * (h + pad) - pad, cols * (w + pad) - pad, 3), bg,
                 np.uint8)
  for i, im in enumerate(imgs):
    r, c = divmod(i, cols)
    grid[r * (h + pad):r * (h + pad) + h,
         c * (w + pad):c * (w + pad) + w] = im
  return grid


def save_image_grid(path: str, images: Sequence[np.ndarray], cols: int = 4):
  from PIL import Image
  Image.fromarray(create_image_grid(images, cols)).save(path)


def visualize_batch(feature: dict, out_path: str,
                    max_windows: int = 4) -> str:
  """Render the frame windows of a (feature, label) batch as a grid —
  the dataset-visualize notebook's readout (rows = windows, cols = K)."""
  rgb = np.asarray(feature['rgb'])          # [N, K, H, W, 3]
  n, k = rgb.shape[:2]
  n = min(n, max_windows)
  frames = [rgb[i, j] for i in range(n) for j in range(k)]
  save_image_grid(out_path, frames, cols=k)
  return out_path
