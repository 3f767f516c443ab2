"""Block-diagonal Gauss-Jordan inverses of small SPD matrices (PyTorch).

Counterpart of ``geeco_tpu/physics/linalg.py``, the ``mass_inverse=
'blockgj'`` option.  The JAX package added it for the TPU, where XLA lowers
a Cholesky factorization to a While loop of column sweeps that cannot be
fused; an unrolled Gauss-Jordan elimination over a static size is a fixed
chain of full-width elementwise steps instead.  Here the same elimination
is a chain of batched tensor operations over the env axis B, with no
factorization library call: one alternative to ``torch.cholesky_solve``
whose cost can be measured against it.

The joint-space mass matrix is exactly block-diagonal, one block per
kinematic tree (the actuated chain, and one 6x6 block per free body: no
body depends on dofs of two trees), so the blocks are inverted alone and
equal-size blocks together.  No pivoting: every input here is SPD (the mass
matrix with its implicit-damping diagonal; the weld Schur complement
J M^-1 J^T + R), where diagonal pivots are safe, as Cholesky assumes.
"""

from __future__ import annotations

import functools
from typing import List, Tuple

import numpy as np
import torch


def dof_blocks(anc_mask: np.ndarray) -> List[np.ndarray]:
  """Partition dofs into mass-matrix diagonal blocks.

  ``anc_mask`` [nbody, nv] marks which dofs move each body.  Two dofs can
  couple in M iff some body depends on both (M = sum_b J_b^T I_b J_b), so
  the blocks are the connected components of the share-a-body relation.
  Returns a list of sorted dof-index arrays covering 0..nv-1.
  """
  nv = anc_mask.shape[1]
  parent = np.arange(nv)

  def find(i):
    while parent[i] != i:
      parent[i] = parent[parent[i]]
      i = parent[i]
    return i

  for row in np.asarray(anc_mask) != 0:
    idx = np.nonzero(row)[0]
    if len(idx) > 1:
      r = find(idx[0])
      for j in idx[1:]:
        parent[find(j)] = r
  comps: dict = {}
  for i in range(nv):
    comps.setdefault(find(i), []).append(i)
  return [np.asarray(sorted(v), np.int32) for v in
          sorted(comps.values(), key=lambda v: v[0])]


def gj_inverse(A: torch.Tensor) -> torch.Tensor:
  """Gauss-Jordan inverse of SPD ``A`` [..., n, n]: n elimination steps,
  each one batched update of the augmented [..., n, 2n] matrix, in the JAX
  package's order (pivot row scaled, every row eliminated, the scaled pivot
  row put back)."""
  n = A.shape[-1]
  eye = torch.eye(n, dtype=A.dtype, device=A.device).expand(A.shape)
  M = torch.cat([A, eye], dim=-1)                       # [..., n, 2n]
  rows = torch.arange(n, device=A.device)[:, None]
  for j in range(n):
    piv = M[..., j:j + 1, :] / M[..., j:j + 1, j:j + 1]   # [..., 1, 2n]
    col = M[..., :, j:j + 1]                              # [..., n, 1]
    M = torch.where(rows == j, piv, M - col * piv)
  return M[..., :, n:]


def spd_block_inverse(A: torch.Tensor, blocks: List[np.ndarray]
                      ) -> torch.Tensor:
  """Inverse of block-diagonal SPD ``A`` [..., nv, nv].

  ``blocks`` (from :func:`dof_blocks`) lists the dof-index sets of the
  diagonal blocks; off-block entries of A are taken as (structurally) zero
  and the result is assembled block-diagonally.  Equal-size blocks are
  stacked and inverted in one batched pass.
  """
  out = torch.zeros_like(A)
  by_size: dict = {}
  for idx in blocks:
    by_size.setdefault(len(idx), []).append(tuple(int(i) for i in idx))
  for _, group in sorted(by_size.items()):
    gi = _group_index(tuple(group), A.device)           # [k, n]
    rows, cols = gi[:, :, None], gi[:, None, :]
    out[..., rows, cols] = gj_inverse(A[..., rows, cols])
  return out


@functools.lru_cache(maxsize=64)
def _group_index(group: Tuple[Tuple[int, ...], ...], device: torch.device
                 ) -> torch.Tensor:
  """The dof indices of equal-size blocks as one tensor on ``device``, made
  once (the step calls this every substep)."""
  return torch.as_tensor(group, dtype=torch.int64, device=device)
