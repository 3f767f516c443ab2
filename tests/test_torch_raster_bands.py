"""The raster kernel's bands (``raster_kernel.subtile_plan``) and their cull
(``raster_kernel.live_slots``), on the CPU.

The kernel (``csrc/raster_tiles.cu``) runs one warp per band of 4x2-pixel
patches and drops the slots that cannot touch the band.  Here: the plan the
wrapper hands the kernel covers every pixel of the tile exactly once with
at most 32 lanes a warp, and dropping the slots ``live_slots`` culls for a
band changes no pixel of that band in the plain twin.  ``chip_smoke.py``
holds the kernel itself against the twin on the card.
"""

import numpy as np
import pytest
import torch

from geeco_tpu_torch.render import raster_kernel as RK
from geeco_tpu_torch.render import rasterizer as TR
from tests.test_torch_render import _random_planes

torch.set_num_threads(1)


def _lane_pixels(tile, plan):
  """Pixel index of each (band, lane, patch pixel) as raster_tiles.cu
  computes it (-1 where the lane has no patch or the pixel lies past the
  tile's edge): band b starts at ((b % bands_x) * band_w,
  (b / bands_x) * band_h); lane l's patch at column l % (band_w / 4),
  row l / (band_w / 4) of 4x2 patches."""
  band_w, band_h, bands = plan
  bands_x = -(-tile // band_w)
  across = band_w // 4
  out = np.full((bands, 32, 8), -1)
  for b in range(bands):
    bx, by = (b % bands_x) * band_w, (b // bands_x) * band_h
    for lane in range(32):
      x0, y0 = bx + (lane % across) * 4, by + (lane // across) * 2
      if lane >= across * (band_h // 2) or x0 >= tile or y0 >= tile:
        continue
      for r in range(2):
        for i in range(4):
          if x0 + i < tile and y0 + r < tile:
            out[b, lane, 4 * r + i] = (y0 + r) * tile + x0 + i
  return out


def _check_plan(tile):
  band_w, band_h, bands = plan = RK.subtile_plan(tile)
  assert band_w % 4 == 0 and band_h % 2 == 0
  assert (band_w // 4) * (band_h // 2) <= 32           # one patch a lane
  assert bands == -(-tile // band_w) * -(-tile // band_h)
  px = _lane_pixels(tile, plan)
  np.testing.assert_array_equal(np.sort(px[px >= 0]),
                                np.arange(tile * tile))   # each pixel once
  rects = RK.band_rects(tile, plan)
  assert len(rects) == bands
  for b, (x0, x1, y0, y1) in enumerate(rects):
    mine = px[b][px[b] >= 0]
    assert sorted(mine) == sorted(y * tile + x for y in range(y0, y1)
                                  for x in range(x0, x1))


@pytest.mark.parametrize('tile', [1, 2, 3, 6, 10, 16, 18, 20, 32, 40])
def test_subtile_plan_covers_each_pixel_once(tile):
  _check_plan(tile)


def test_subtile_plan_covers_every_side_up_to_40():
  for tile in range(1, 41):
    _check_plan(tile)


@pytest.mark.parametrize('tile,plan', [
    (4, (4, 4, 1)), (8, (8, 8, 1)), (12, (12, 12, 1)), (16, (16, 16, 1)),
    (10, (12, 10, 1)), (20, (20, 10, 2)), (32, (16, 16, 4)),
    (40, (40, 6, 7))])
def test_subtile_plan_bands(tile, plan):
  """The patch sides are one band that fills the tile; tile 32 is four
  16x16 bands, tile 10 one band of 3x5 patches."""
  assert RK.subtile_plan(tile) == plan
  assert RK.kernel_limits(tile) == ('patch' if plan == (tile, tile, 1)
                                    else 'general')


@pytest.mark.parametrize('tile', [0, -4])
def test_subtile_plan_rejects(tile):
  with pytest.raises(ValueError, match='at least one pixel'):
    RK.subtile_plan(tile)


def _planes(tile, K=48, n_tiles=8, seed=0):
  planes = [torch.as_tensor(p.T)[None]
            for p in _random_planes(tile, 2, K, n_tiles, seed)]
  return TR._coeff_planes(planes, tile, 2)


@pytest.mark.parametrize('tile', [10, 20, 32])
def test_band_cull_drops_no_winner(tile):
  """Empty (C0 = -1e30) every slot that ``live_slots`` culls for a band,
  for that band's pixels only: the twin gives every pixel bit for bit."""
  coeffs = _planes(tile)
  plan = RK.subtile_plan(tile)
  keep = RK.live_slots(coeffs, tile, plan)
  assert keep.shape == (*coeffs.shape[:2], plan[2], coeffs.shape[3])
  assert 0.05 < float((~keep).float().mean()) < 0.95   # the cull does bite
  iz, c = RK.raster_tiles_reference(coeffs, tile, 3.0)
  iz_b, c_b = torch.full_like(iz, float('nan')), torch.full_like(c, -1.0)
  for b, (x0, x1, y0, y1) in enumerate(RK.band_rects(tile, plan)):
    culled = coeffs.clone()
    culled[:, :, 2][~keep[:, :, b]] = -1e30
    iz_c, c_c = RK.raster_tiles_reference(culled, tile, 3.0)
    pix = torch.tensor([y * tile + x for y in range(y0, y1)
                        for x in range(x0, x1)])
    iz_b[:, :, pix], c_b[:, :, pix] = iz_c[:, :, pix], c_c[:, :, pix]
  assert torch.equal(iz, iz_b) and torch.equal(c, c_b)


def test_band_cull_is_finer_than_the_tile_cull():
  """At tile 32 each 16x16 band keeps no slot the tile's corners drop, and
  fewer in all; at tile 16, one band, the cull is the tile's: edges
  negative at the pixel centres (0.5, 0.5) and (15.5, 15.5)'s corners."""
  coeffs = _planes(32, seed=1)
  whole = RK.live_slots(coeffs, 32, (32, 32, 1))[:, :, 0]
  bands = RK.live_slots(coeffs, 32, RK.subtile_plan(32))
  assert not bool((bands & ~whole[:, :, None]).any())
  assert int(bands.sum()) < 4 * int(whole.sum())
  coeffs = _planes(16, seed=2)
  missed = torch.zeros_like(coeffs[:, :, 0], dtype=torch.bool)
  for e in range(3):
    a, b, c = (coeffs[:, :, 3 * e + i] for i in range(3))
    out = [a * x + b * y + c < 0 for x in (0.5, 15.5) for y in (0.5, 15.5)]
    missed |= out[0] & out[1] & out[2] & out[3]
  one = RK.live_slots(coeffs, 16, RK.subtile_plan(16))
  assert one.shape[2] == 1 and torch.equal(one[:, :, 0], ~missed)


@pytest.mark.parametrize('tile', [10, 16, 32])
def test_loaded_chunks_hold_every_kept_slot(tile):
  """A band loads the chunks of 32 slots that hold a slot whose first edge
  reaches the band's corners (the last chunk short when K is no multiple
  of 32), and every slot its cull keeps lies in one of them; chunks of
  empty slots (C0 = -1e30, at the end of the list) are not loaded."""
  K = 70
  coeffs = _planes(tile, K=K, seed=3)
  coeffs[:, :, 2, 64:] = -1e30
  plan = RK.subtile_plan(tile)
  loaded = RK.loaded_chunks(coeffs, tile, plan)
  keep = RK.live_slots(coeffs, tile, plan)
  assert loaded.shape == (*coeffs.shape[:2], plan[2], 3)
  for b, (x0, x1, y0, y1) in enumerate(RK.band_rects(tile, plan)):
    a, bb, c = coeffs[:, :, 0], coeffs[:, :, 1], coeffs[:, :, 2]
    reach = torch.zeros_like(a, dtype=torch.bool)
    for x in (x0 + 0.5, x1 - 0.5):
      for y in (y0 + 0.5, y1 - 0.5):
        reach |= a * x + bb * y + c >= 0
    for ch in range(3):
      assert torch.equal(loaded[:, :, b, ch],
                         reach[:, :, 32 * ch:32 * ch + 32].any(-1))
  assert not bool(loaded[..., 2].any())
  assert 0 < int(loaded.sum()) < loaded.numel()   # some chunks skipped
  in_loaded = loaded.repeat_interleave(32, -1)[..., :K]
  assert not bool((keep & ~in_loaded).any())
