"""Buffered video sink: device frame buffers -> host video files.

Functional replacement for the reference MjVideoRecorder
(src/mj_engine/engine/recorder.py): buffered feed/flush/finalize with
background writer threads (the reference forks fire-and-forget processes
per batch, :201-205).  The ``mp4`` backend pipes to a system ffmpeg and is
the default where one is on the PATH; otherwise an animated GIF (Pillow),
or a PNG frame sequence on request.

Batched usage: feed() accepts [H, W, 3] or [B, H, W, 3] uint8 frames —
batches are tiled into a grid image per frame (one video per batch of envs).

The port's own copy of ``geeco_tpu/render/video.py``.  Pillow and ffmpeg
are reached only by the writer, so the rest of the port needs neither.
"""

from __future__ import annotations

import math
import os
import shutil
import subprocess
import threading
from typing import List, Optional

import numpy as np

DEFAULT_FPS = 25           # recorder.py:20
DEFAULT_BUFFER = 1500      # recorder.py:21


def tile_batch(frames: np.ndarray) -> np.ndarray:
  """[B, H, W, 3] -> single grid image."""
  b, h, w, c = frames.shape
  cols = int(math.ceil(math.sqrt(b)))
  rows = int(math.ceil(b / cols))
  grid = np.zeros((rows * h, cols * w, c), frames.dtype)
  for i in range(b):
    r, cc = divmod(i, cols)
    grid[r * h:(r + 1) * h, cc * w:(cc + 1) * w] = frames[i]
  return grid


class VideoRecorder:
  """feed/flush/finalize video sink (reference MjVideoRecorder API)."""

  def __init__(self, record_name: str, record_dir: str,
               fps: int = DEFAULT_FPS, buffer_size: int = DEFAULT_BUFFER,
               backend: Optional[str] = None):
    self.record_name = record_name
    self.record_dir = record_dir
    self.fps = fps
    self.buffer_size = buffer_size
    if backend is None:
      backend = 'mp4' if shutil.which('ffmpeg') else 'gif'
    self.backend = backend
    self._frames: List[np.ndarray] = []
    self._flush_count = 0
    self._threads: List[threading.Thread] = []
    os.makedirs(record_dir, exist_ok=True)

  def feed(self, frame: np.ndarray):
    frame = np.asarray(frame)
    if frame.ndim == 4:
      frame = tile_batch(frame)
    if frame.dtype != np.uint8:
      frame = np.clip(frame * 255.0, 0, 255).astype(np.uint8)
    self._frames.append(frame)
    if len(self._frames) >= self.buffer_size:
      self.flush()

  def _write(self, frames: List[np.ndarray], path: str):
    from PIL import Image
    if self.backend == 'gif':
      imgs = [Image.fromarray(f) for f in frames]
      imgs[0].save(path, save_all=True, append_images=imgs[1:],
                   duration=int(1000 / self.fps), loop=0)
    elif self.backend == 'png':
      base = path.rsplit('.', 1)[0]
      os.makedirs(base, exist_ok=True)
      for i, f in enumerate(frames):
        Image.fromarray(f).save(os.path.join(base, f'{i:05d}.png'))
    elif self.backend == 'mp4':
      h, w = frames[0].shape[:2]
      cmd = ['ffmpeg', '-y', '-f', 'rawvideo', '-pix_fmt', 'rgb24',
             '-s', f'{w}x{h}', '-r', str(self.fps), '-i', '-',
             '-pix_fmt', 'yuv420p', path]
      proc = subprocess.Popen(cmd, stdin=subprocess.PIPE,
                              stdout=subprocess.DEVNULL,
                              stderr=subprocess.DEVNULL)
      for f in frames:
        proc.stdin.write(f.tobytes())
      proc.stdin.close()
      proc.wait()
    else:
      raise ValueError(f'unknown video backend {self.backend}')

  def flush(self) -> str:
    """Write buffered frames asynchronously; returns the output path."""
    ext = {'gif': 'gif', 'png': 'png', 'mp4': 'mp4'}[self.backend]
    path = os.path.join(
        self.record_dir,
        f'{self.record_name}_{self._flush_count:03d}.{ext}')
    frames, self._frames = self._frames, []
    self._flush_count += 1
    if not frames:
      return path
    t = threading.Thread(target=self._write, args=(frames, path),
                         daemon=True)
    t.start()
    self._threads.append(t)
    return path

  def finalize(self) -> Optional[str]:
    path = self.flush() if self._frames else None
    for t in self._threads:
      t.join()
    self._threads = []
    return path
