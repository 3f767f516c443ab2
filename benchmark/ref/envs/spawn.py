"""Spawn-grid sampling and sphere-volume sampling (PyTorch).

Counterpart of ``geeco_tpu/envs/spawn.py``.  Where the JAX package splits a
PRNG key, these take an explicit ``torch.Generator`` and draw for B envs at
once, on the generator's device.  The two give different numbers from the
same seed; the distributions are the same.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def compute_grid(minmax_x: Tuple[float, float], minmax_y: Tuple[float, float],
                 tiling_xy: Tuple[int, int]) -> np.ndarray:
  """Static cell-center grid [nx*ny, 2] (x-major, matching the reference)."""
  nx, ny = tiling_xy
  cx = np.linspace(minmax_x[0], minmax_x[1], nx * 2 + 1)[1::2]
  cy = np.linspace(minmax_y[0], minmax_y[1], ny * 2 + 1)[1::2]
  centers = [(x, y) for x in cx for y in cy]
  return np.asarray(centers, np.float32)


def sample_spawn_points(generator: torch.Generator, grid: np.ndarray,
                        num_points: int, batch: int) -> torch.Tensor:
  """num_points distinct cell centers per env: [B, num_points, 2]."""
  dev = generator.device
  keys = torch.rand((batch, grid.shape[0]), generator=generator, device=dev)
  idx = torch.argsort(keys, dim=-1)[:, :num_points]     # uniform permutation
  return torch.as_tensor(grid, device=dev)[idx]


def sample_point_within_sphere(generator: torch.Generator,
                               radius: float = 1.0, batch: int = 1
                               ) -> torch.Tensor:
  """Uniform points in the ball of ``radius``: [B, 3]
  (direction uniform on the sphere, radius ~ cbrt(U))."""
  dev = generator.device
  u = torch.rand((batch, 1), generator=generator, device=dev)
  x = torch.randn((batch, 3), generator=generator, device=dev)
  x = x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                      min=1e-9)
  return x * radius * torch.pow(u, 1.0 / 3.0)
