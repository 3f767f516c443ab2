"""Background-video cycling for domain randomisation.

Counterpart of ``geeco_tpu/data/videos.py``, carried across (host-side
numpy and Pillow).  The reference replaces the camera-facing wall's texture
with successive frames of a video each env step (its VideoCycler, applied
through a TextureModder); here the frames, downsampled to the renderer's
texel grid, override that wall's texture slot at render time
(``GeecoEnv.background_textures`` -> ``render(textures=)``).

Decoding: GIFs and directories of image frames through Pillow; other
files (mp4, avi, ...) through OpenCV, which raises a clear error where
``cv2`` is not installed.
"""

from __future__ import annotations

import os
from typing import Iterator, Optional

import numpy as np


def _cv2():
  try:
    import cv2
  except ImportError as e:
    raise ImportError(
        'decoding this video needs OpenCV (cv2), which is not installed: '
        'pass a GIF or a directory of image frames instead') from e
  return cv2


class VideoCycler:
  """Cycles the frames of a video file, GIF or directory of images.

  The reference cycler's iterator protocol: uint8 [H, W, 3] frames,
  restarting at the end.
  """

  def __init__(self, video_path: str):
    self.path = video_path
    self._frames: Optional[list] = None  # decoded frames (gif/directory)
    self._cap = None
    if os.path.isdir(video_path):
      from PIL import Image
      names = sorted(
          n for n in os.listdir(video_path)
          if n.lower().endswith(('.png', '.jpg', '.jpeg', '.bmp')))
      if not names:
        raise ValueError(f'no image frames in {video_path}')
      self._frames = [
          np.asarray(Image.open(os.path.join(video_path, n)).convert('RGB'))
          for n in names]
    elif video_path.lower().endswith('.gif'):
      from PIL import Image, ImageSequence
      img = Image.open(video_path)
      self._frames = [np.asarray(f.convert('RGB'))
                      for f in ImageSequence.Iterator(img)]
    else:
      self._cap = _cv2().VideoCapture(video_path)
      if not self._cap.isOpened():
        raise ValueError(f'cannot open video {video_path}')
    self.reset()

  def reset(self):
    if self._frames is not None:
      self._ite: Iterator = iter(self._frames)
    else:
      self._cap.set(1, 0)  # CAP_PROP_POS_FRAMES

  def __next__(self) -> np.ndarray:
    if self._frames is not None:
      try:
        return next(self._ite)
      except StopIteration:
        self.reset()
        return next(self._ite)
    ok, frame = self._cap.read()
    if not ok:
      self.reset()
      ok, frame = self._cap.read()
      if not ok:
        raise ValueError(f'video {self.path} has no frames')
    cv2 = _cv2()
    return cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)

  def __iter__(self):
    return self

  def next_texels(self, res: int) -> np.ndarray:
    """Next frame downsampled to the renderer's [res, res, 3] texel grid
    (float32 in [0, 1])."""
    return frame_to_texels(next(self), res)

  def texel_steps(self, n_steps: int, res: int) -> np.ndarray:
    """[n_steps, res, res, 3] texel grids for one episode's render calls."""
    return np.stack([self.next_texels(res) for _ in range(n_steps)])


def frame_to_texels(frame: np.ndarray, res: int) -> np.ndarray:
  """uint8 [H, W, 3] frame -> float32 [res, res, 3] texel grid."""
  from PIL import Image
  img = Image.fromarray(np.asarray(frame, np.uint8)).resize(
      (res, res), Image.BILINEAR)
  return np.asarray(img, np.float32) / 255.0
