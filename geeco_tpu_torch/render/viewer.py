"""Host-side debug viewer: live engine frames drawn into the terminal.

The port's own copy of ``geeco_tpu/render/viewer.py`` (numpy only).  It
stands in for the reference's interactive viewer mode (a mujoco-py GLFW
window, ``rendering_mode == 'viewer'``): a GPU host usually has no display
server either, so the engine's rasterizer output is drawn into the
terminal with ANSI truecolour half-blocks: each character cell shows two
vertical pixels (upper-half glyph, foreground = top pixel, background =
bottom pixel).  This works over plain ssh, needs no GUI stack, and is a
no-op when stdout is not a TTY.

Used by:
  * ``--rendering_mode viewer`` in the sim CLIs (run/sim.py): live
    playback of collect and controller episodes;
  * ``python -m geeco_tpu_torch.run.viewer``: the interactive
    drive-the-arm debug tool (run/viewer.py).
"""

from __future__ import annotations

import os
import shutil
import sys
import time
from typing import Optional

import numpy as np

_RESET = '\x1b[0m'
_HOME = '\x1b[H'
_CLEAR = '\x1b[2J'
_ALT_ON = '\x1b[?1049h\x1b[?25l'    # alternate screen + hide cursor
_ALT_OFF = '\x1b[?25h\x1b[?1049l'


def _box_downsample(frame: np.ndarray, rows: int, cols: int) -> np.ndarray:
  """Average-pool an (H, W, 3) uint8 frame to (rows, cols, 3)."""
  h, w = frame.shape[:2]
  ys = (np.linspace(0, h, rows + 1)).astype(np.int64)
  xs = (np.linspace(0, w, cols + 1)).astype(np.int64)
  # integral image makes the box means O(rows*cols)
  ii = np.cumsum(np.cumsum(frame.astype(np.float64), axis=0), axis=1)
  ii = np.pad(ii, ((1, 0), (1, 0), (0, 0)))
  y0, y1 = ys[:-1], ys[1:]
  x0, x1 = xs[:-1], xs[1:]
  area = ((y1 - y0)[:, None] * (x1 - x0)[None, :])[..., None]
  out = (ii[y1][:, x1] - ii[y1][:, x0] - ii[y0][:, x1] + ii[y0][:, x0])
  return np.clip(out / np.maximum(area, 1), 0, 255).astype(np.uint8)


def frame_to_ansi(frame: np.ndarray, max_cols: int = 0,
                  max_rows: int = 0) -> str:
  """Render an (H, W, 3) uint8 RGB frame as ANSI truecolor half-blocks.

  Each output character encodes a 1x2 pixel column (top pixel as the
  foreground of '▀', bottom pixel as the background), so a frame of
  (2R, C) pixels becomes R text rows of C cells.
  """
  frame = np.asarray(frame)
  if frame.dtype != np.uint8:
    frame = np.clip(np.asarray(frame, np.float64) * 255.0
                    if frame.max() <= 1.0 + 1e-6 else frame,
                    0, 255).astype(np.uint8)
  if max_cols <= 0 or max_rows <= 0:
    size = shutil.get_terminal_size((80, 24))
    max_cols = max_cols if max_cols > 0 else size.columns
    max_rows = max_rows if max_rows > 0 else size.lines - 2
  h, w = frame.shape[:2]
  # fit (w, h/2 char cells) into (max_cols, max_rows), keep aspect
  scale = min(max_cols / w, (2 * max_rows) / h, 1.0)
  cols = max(2, int(w * scale))
  rows = max(2, int(h * scale)) // 2 * 2
  img = _box_downsample(frame, rows, cols)
  lines = []
  for r in range(0, rows, 2):
    top, bot = img[r], img[r + 1]
    cells = []
    prev = None
    for c in range(cols):
      cur = (int(top[c, 0]), int(top[c, 1]), int(top[c, 2]),
             int(bot[c, 0]), int(bot[c, 1]), int(bot[c, 2]))
      if cur != prev:   # only emit SGR codes on color changes
        cells.append('\x1b[38;2;%d;%d;%dm\x1b[48;2;%d;%d;%dm' % cur)
        prev = cur
      cells.append('▀')
    lines.append(''.join(cells) + _RESET)
  return '\n'.join(lines)


class TerminalViewer:
  """Live frame display with the VideoRecorder ``feed`` protocol.

  Counterpart of the reference viewer window (pickplace.py:590-591);
  plugged into the sim CLIs wherever the reference would open the GLFW
  viewer.  ``fps`` throttles playback to the reference recording rate
  (25 fps, src/mj_engine/engine/recorder.py:20).
  """

  def __init__(self, fps: float = 25.0, file=None, max_cols: int = 0,
               max_rows: int = 0):
    self._out = file if file is not None else sys.stdout
    self._tty = bool(getattr(self._out, 'isatty', lambda: False)()) \
        or file is not None
    self._fps = fps
    self._last = 0.0
    self._started = False
    self._max_cols = max_cols
    self._max_rows = max_rows
    self.frames_shown = 0

  def feed(self, frame: np.ndarray, hud: str = ''):
    self.frames_shown += 1
    if not self._tty:
      return
    if not self._started and self._out is sys.stdout:
      self._out.write(_ALT_ON + _CLEAR)
      self._started = True
    if self._fps > 0:
      wait = self._last + 1.0 / self._fps - time.time()
      if wait > 0:
        time.sleep(wait)
    self._last = time.time()
    text = frame_to_ansi(frame, self._max_cols, self._max_rows)
    self._out.write(_HOME + text + '\x1b[K\n' + hud + '\x1b[K\n')
    self._out.flush()

  def close(self):
    if self._started and self._out is sys.stdout:
      self._out.write(_ALT_OFF)
      self._out.flush()
      self._started = False

  def __enter__(self):
    return self

  def __exit__(self, *exc):
    self.close()


def read_key(timeout: float = 0.0) -> Optional[str]:
  """Read one key from a raw TTY (None on timeout / no TTY)."""
  if not sys.stdin.isatty():
    return None
  import select
  import termios
  import tty
  fd = sys.stdin.fileno()
  old = termios.tcgetattr(fd)
  try:
    tty.setcbreak(fd)
    r, _, _ = select.select([fd], [], [], timeout if timeout > 0 else None)
    if not r:
      return None
    return os.read(fd, 1).decode(errors='replace')
  finally:
    termios.tcsetattr(fd, termios.TCSADRAIN, old)
