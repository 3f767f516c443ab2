"""What one launch of the tile rasterizer (K1) needs, from its inputs alone.

A launch takes the 13 affine-coefficient rows of every slot of every tile,
``coeffs [B, n_tiles, 13, K]`` float32 (rows 0-8: three edge functions
``a*px + b*py + c``; rows 9-11: inverse depth, the same form; row 12: the
packed colour), and writes two float32 buffers of ``tile*tile`` pixels a
tile (inverse depth and colour).  A pixel (centre px, py) lies inside a
slot when its three edge functions are >= 0 there.

The count, whatever kernel computes the launch:
  * a slot *covers* its tile when its triangle holds at least one of the
    tile's pixel centres; each covered slot's 13 coefficients are read
    once (4 bytes each), and both output buffers are written once;
  * each pair of a covered slot and a pixel of its tile costs the edge and
    depth tests: four affine forms (two multiplies and two adds each) and
    four compares (three edges, one depth), 20 operations.
Slots that cover nothing (empty slots, triangles that miss the tile) cost
nothing: a kernel need not read them.
"""

from __future__ import annotations

import torch

BYTES_PER_COEFF = 4
N_COEFF = 13
OPS_PER_PAIR = 20
OUTPUT_BUFFERS = 2


def covered_slots(coeffs: torch.Tensor, tile: int,
                  block_elems: int = 1 << 26) -> int:
  """The slots whose triangle holds at least one pixel centre of its tile,
  edge functions evaluated in float32 as ``(a*px + b*py) + c``; worked out
  in blocks of rows and slots of at most ``block_elems`` (slot, pixel)
  pairs, to bound memory."""
  B, n_tiles, n_rows, K = coeffs.shape
  if n_rows != N_COEFF:
    raise ValueError(f'coeffs must have {N_COEFF} rows, got {n_rows}')
  lin = torch.arange(tile * tile, device=coeffs.device)
  px = (lin % tile).to(torch.float32) + 0.5
  py = (lin // tile).to(torch.float32) + 0.5
  per_slot = n_tiles * tile * tile
  ks = max(1, min(K, block_elems // per_slot))
  bs = max(1, min(B, block_elems // (per_slot * ks)))
  total = 0
  for b0 in range(0, B, bs):
    for k0 in range(0, K, ks):
      c = coeffs[b0:b0 + bs, :, :9, k0:k0 + ks, None]    # [b, T, 9, k, 1]
      inside = None
      for e in range(3):
        f = (c[:, :, 3 * e] * px + c[:, :, 3 * e + 1] * py +
             c[:, :, 3 * e + 2])
        inside = f >= 0 if inside is None else inside & (f >= 0)
      total += int(inside.any(-1).sum())
  return total


def launch_work(coeffs: torch.Tensor, tile: int) -> tuple:
  """(operations, bytes) one launch on ``coeffs`` needs."""
  B, n_tiles = coeffs.shape[:2]
  covered = covered_slots(coeffs, tile)
  ops = OPS_PER_PAIR * covered * tile * tile
  nbytes = (BYTES_PER_COEFF * N_COEFF * covered +
            OUTPUT_BUFFERS * 4 * B * n_tiles * tile * tile)
  return float(ops), float(nbytes)
