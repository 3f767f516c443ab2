"""Dataset helpers (numpy).

The port's own copy of the part of ``geeco_tpu/data/dataset.py`` the
trainer needs; the episode pipeline itself is not ported yet.
"""

from __future__ import annotations

import numpy as np


def window_indices(T: int, window_size: int, pad_start: bool = True
                   ) -> np.ndarray:
  """Window index matrix [N, K] into a length-T episode.

  pad_start prepends K-1 windows whose indices are clamped to 0 — the
  exact first-frame padding the serving ring buffer uses for the first
  control steps (predictor.py:192-200).  The reference trains WITHOUT
  these (_window_v3, geeco_gym.py:615-631), which leaves the serving
  start state out-of-distribution: a policy that learned "static window
  => zero action" from post-completion idle tails emits ~zero on the
  static padded start window, never moves, and deadlocks at 0% success.
  Padded start windows carry the (large) initial expert actions as
  labels, so the goal-difference features disambiguate start from goal.
  """
  n_win = T - window_size + 1
  idx = np.arange(n_win)[:, None] + np.arange(window_size)[None, :]
  if pad_start:
    pad = np.maximum(
        np.arange(-(window_size - 1), 0)[:, None] +
        np.arange(window_size)[None, :], 0)
    idx = np.concatenate([pad, idx], axis=0)
  return idx
