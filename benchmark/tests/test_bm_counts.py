"""The yardstick's counts against hand counts on small shapes."""

import ast
import inspect
import math

import pytest
import torch

from benchmark.counts import e2evmc, k1, peaks, physics


def _brute_covered(coeffs, tile):
  """Slot by slot and pixel by pixel: does some pixel centre of the tile
  lie inside all three edges (each evaluated as (a*px + b*py) + c in
  float32)?"""
  B, n_tiles, _, K = coeffs.shape
  n = 0
  for b in range(B):
    for t in range(n_tiles):
      for s in range(K):
        c = coeffs[b, t, :, s]
        hit = False
        for y in range(tile):
          for x in range(tile):
            px = torch.tensor(x + 0.5, dtype=torch.float32)
            py = torch.tensor(y + 0.5, dtype=torch.float32)
            if all(float(c[3 * e] * px + c[3 * e + 1] * py + c[3 * e + 2])
                   >= 0 for e in range(3)):
              hit = True
              break
          if hit:
            break
        n += hit
  return n


@pytest.mark.parametrize('tile,seed', [(4, 0), (5, 1), (3, 2)])
def test_k1_count_equals_a_brute_force_count(tile, seed):
  g = torch.Generator().manual_seed(seed)
  coeffs = torch.randn((2, 3, k1.N_COEFF, 7), generator=g)
  coeffs[:, :, 2] += 2.0 * torch.rand((2, 3, 7), generator=g) - 1.0
  coeffs[0, 0, 2, 0] = -1e30                 # an empty slot
  want = _brute_covered(coeffs, tile)
  assert 0 < want < 2 * 3 * 7
  assert k1.covered_slots(coeffs, tile) == want
  # blocks of one slot and one row give the same count
  assert k1.covered_slots(coeffs, tile, block_elems=1) == want
  ops, nbytes = k1.launch_work(coeffs, tile)
  assert ops == 20 * want * tile * tile
  assert nbytes == 4 * 13 * want + 2 * 4 * 2 * 3 * tile * tile


def test_k1_count_of_hand_made_slots():
  # tile 2: pixel centres (0.5, 0.5) .. (1.5, 1.5)
  coeffs = torch.zeros((1, 1, 13, 3))
  coeffs[0, 0, 2, 0] = -1e30                 # empty: covers nothing
  coeffs[0, 0, 0:3, 1] = torch.tensor([1.0, 0.0, -1.0])   # x >= 1
  coeffs[0, 0, 0:3, 2] = torch.tensor([1.0, 0.0, -2.0])   # x >= 2: none
  coeffs[0, 0, 3:9, :] = torch.tensor([0.0, 0.0, 1.0] * 2)[:, None]
  assert k1.covered_slots(coeffs, 2) == 1


def test_k1_count_takes_only_the_launch_inputs():
  params = inspect.signature(k1.launch_work).parameters
  assert list(params) == ['coeffs', 'tile']
  tree = ast.parse(inspect.getsource(k1))
  names = {n.module if isinstance(n, ast.ImportFrom) else a.name
           for n in ast.walk(tree) if isinstance(n, (ast.Import,
                                                     ast.ImportFrom))
           for a in n.names}
  assert names <= {'__future__', 'torch'}


def test_physics_count_by_hand():
  # nv=2, one contact of 1 group, no limits, one weld: nI = 1, nE = 6
  t = physics.substep_terms(nv=2, contact_rows=1, ngrp=1, joint_limits=0,
                            welds=1, iterations=1)
  assert t['mass_factor'] == 8 / 3
  assert t['delassus_solves'] == 2 * 4 * 7
  assert t['delassus_rows'] == 4 * 2 * 7
  assert t['weld_schur'] == (2 * 36 * 2 + 2 * 1 * 6 * 2 + 2 * 36 * 1 +
                             2 * 6 + 2 * 216)
  apply = 2 * 2 * 1 + 2 * 1 * 2 + 2 * 6 * 2 + 2 * 36 + 2 * 1 * 6 + 2 * 1
  assert t['iterations'] == 2 * apply + 10 * 1
  assert t['qacc'] == 2 * 2 * 7
  shapes = dict(nv=2, contact_rows=1, ngrp=1, joint_limits=0, welds=1,
                iterations=1, substeps=3)
  assert physics.control_step_flops(shapes, 5) == pytest.approx(
      sum(t.values()) * 3 * 5)


def test_physics_count_of_the_production_scene():
  # 786 inequality rows (6 x 128 + 2 x 9), 6 weld rows, nv = 39
  t = physics.substep_terms(39, 128, 6, 9, 1, 60)
  assert t['delassus_solves'] == 2 * 39 * 39 * 792
  assert sum(t.values()) == pytest.approx(19.62e6, rel=1e-3)


def test_encoder_count_by_hand():
  # side 4: layers at sides 4, 2, 1, 1, 1, 1, 1, 1
  want, c_in = 0, 3
  for (c, _), n in zip(e2evmc.ENCODER + ((5, 2),), (4, 2, 1, 1, 1, 1, 1, 1)):
    want += 2 * 9 * c_in * c * n * n
    c_in = c
  assert e2evmc.encoder_flops(4, 3, 5) == want
  assert e2evmc.encoded_side(256) == 2


def test_train_step_count_at_the_published_widths():
  cfg = dict(img_height=256, img_width=256, img_channels=3, window_size=4,
             dim_s_obs=256, dim_s_dyn=256, dim_s_diff=256, dim_h_lstm=128,
             dim_h_fc=128, dim_jnt_state=7, num_grp_states=3,
             proc_obs='dynimg', control_mode='cartesian',
             compute_dtype='bfloat16')
  assert e2evmc.encoder_flops(256, 3, 256) == pytest.approx(1.137e9,
                                                            rel=1e-3)
  flops = e2evmc.train_step_flops(cfg, 8, 99)
  assert flops['bfloat16'] == 3 * 8 * 99 * 3 * e2evmc.encoder_flops(
      256, 3, 256)
  lstm = 2 * 4 * 128 * (4 * (3 * 256 + 7) + 128)
  dyn = 2 * 256 * 256 * 3 * 6
  heads = 2 * (128 * 128 + 128 * 12)
  assert flops['float32'] == 3 * 8 * 99 * (lstm + dyn + heads)


def test_peaks():
  assert peaks.roofline_s(67e12, 0.0) == 1.0
  assert peaks.roofline_s(0.0, 3.35e12) == 1.0
  assert peaks.seconds_at_peaks({'bfloat16': 989e12, 'float32': 67e12}) == 2
  assert math.isclose(peaks.roofline_s(1.0, 3.35e12, 'bfloat16'), 1.0)
