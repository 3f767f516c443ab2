"""Port parity (render): the raster kernel's plain twin, the hierarchical
binning and full frames of geeco_tpu_torch against the JAX package's Pallas
path (``backend='pallas'``, interpret mode on the CPU), on the CPU.

The CUDA kernel itself runs only on the card:
``tests/test_torch_card_kernels.py`` holds it against
``raster_tiles_reference`` there.
"""

from tests.conftest import reference_xml
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geeco_tpu.core import mjcf as jmjcf
from geeco_tpu.core.model import make_state as jmake_state
from geeco_tpu.core.model import set_joint_qpos as jset
from geeco_tpu.physics import kinematics as JK
from geeco_tpu.render import rasterizer as JR
from geeco_tpu_torch.core import convert
from geeco_tpu_torch.render import raster_kernel as RK
from geeco_tpu_torch.render import rasterizer as TR
from geeco_tpu_torch.utils import build

# The tensors here are small: one intra-op thread is as fast, and it keeps
# the parallel test workers from oversubscribing the cores.
torch.set_num_threads(1)

# full frames: same binning, same kernel arithmetic; projections differ by
# float32 rounding, so a pixel on a triangle edge may flip
FRAME_MISMATCH_TOL = 1e-3


def _random_planes(TS, S, K, n_tiles, seed=0):
  """The random-plane case of tests/test_render.py:139-155 ([K, n_tiles])."""
  rng = np.random.RandomState(seed)
  MTS = TS * S
  coords = rng.uniform(-6.0, MTS + 6.0, size=(6, K, n_tiles)).astype(
      np.float32)
  x0, y0, x1, y1, x2, y2 = coords
  area = (x1 - x0) * (y2 - y0) - (y1 - y0) * (x2 - x0)
  bad = np.abs(area) < 1.0
  x2 = np.where(bad, x2 + 4.0, x2)
  y2 = np.where(bad, y2 + 3.0, y2)
  depth = rng.uniform(0.5, 5.0, size=(3, K, n_tiles)).astype(np.float32)
  iz0, iz1, iz2 = (1.0 / depth[i] for i in range(3))
  ok = (rng.uniform(size=(K, n_tiles)) > 0.25).astype(np.float32)
  colp = rng.randint(0, 256 ** 3, size=(K, n_tiles)).astype(np.float32)
  return [x0, y0, x1, y1, x2, y2, iz0, iz1, iz2, ok, colp]


@pytest.mark.parametrize('TS,S,K,n_tiles', [(8, 2, 16, 16), (16, 2, 64, 8),
                                             (10, 2, 16, 16), (32, 2, 32, 8)])
def test_raster_reference_matches_pallas_kernel(TS, S, K, n_tiles):
  """Twin on the port's coefficients vs the Pallas kernel (interpret mode)
  on the same random planes; the tolerances of tests/test_render.py.  Tiles
  10 and 32 are sides the CUDA kernel takes on its general path."""
  planes = _random_planes(TS, S, K, n_tiles)
  sky = 123456.0
  iz_ref, c_ref = JR._raster_pallas_call([jnp.asarray(p) for p in planes],
                                         TS, sky, mid_sub=S, interpret=True)
  iz_ref, c_ref = np.asarray(iz_ref), np.asarray(c_ref)   # [npx, n_tiles]
  coeffs = TR._coeff_planes([torch.as_tensor(p.T)[None] for p in planes],
                            TS, S)
  iz, c = RK.raster_tiles(coeffs, TS, sky)
  iz, c = iz[0].numpy().T, c[0].numpy().T
  mism = c != c_ref
  assert mism.mean() < 0.005, f'{mism.sum()} mismatched pixels'
  hit = (iz > 0) & (iz_ref > 0) & ~mism
  assert hit.any()
  np.testing.assert_allclose(iz[hit], iz_ref[hit], rtol=1e-4, atol=1e-4)


def test_coeff_planes_match_jax():
  TS, S, K, n_tiles = 16, 2, 32, 16
  planes = _random_planes(TS, S, K, n_tiles, seed=1)
  ref = JR._coeff_planes([jnp.asarray(p) for p in planes], TS, S)
  got = TR._coeff_planes([torch.as_tensor(p.T)[None] for p in planes], TS, S)
  assert got.shape == (1, n_tiles, 13, K) and got.is_contiguous()
  for i, r in enumerate(ref):
    r = np.asarray(r).T
    np.testing.assert_allclose(got[0, :, i].numpy(), r, rtol=1e-5,
                               atol=1e-4 * np.abs(r).max())


def test_raster_tiles_cpu_runs_the_twin_uncounted():
  coeffs = TR._coeff_planes(
      [torch.as_tensor(p.T)[None] for p in _random_planes(8, 2, 16, 16)],
      8, 2)
  before = RK.raster_tiles.launches
  iz, c = RK.raster_tiles(coeffs, 8, 1.0)
  iz_r, c_r = RK.raster_tiles_reference(coeffs, 8, 1.0)
  assert torch.equal(iz, iz_r) and torch.equal(c, c_r)
  assert iz.shape == (1, 16, 64)
  assert RK.raster_tiles.launches == before     # the kernel never ran


@pytest.mark.parametrize('bad,err', [
    (lambda c: c.double(), TypeError),
    (lambda c: c[:, :, :12], ValueError),
    (lambda c: c.transpose(0, 1), ValueError),
    (lambda c: c.to('meta'), ValueError),
])
def test_raster_tiles_rejects(bad, err):
  coeffs = torch.zeros((2, 4, 13, 8))
  with pytest.raises(err):
    RK.raster_tiles(bad(coeffs), 8, 1.0)


def test_kernel_build_is_lazy_and_keyed_by_source():
  path = build.library_path()
  assert path.startswith(build.BUILD_DIR) and path.endswith('.so')
  assert path == build.library_path()
  assert build.load_kernels.cache_info().currsize == 0   # nvcc never ran


@pytest.fixture(scope='module')
def frame64():
  jm, ja = jmjcf.load_model(reference_xml('geeco-pad2-cube2.xml'))
  tm = convert.model_from_reference(jm)
  st = jmake_state(jm)
  q = st.qpos
  for name, val in (('robot0:slide0', 0.405), ('robot0:slide1', 0.48),
                    ('robot0:slide2', 0.0)):
    q = jset(jm, q, name, val)
  for name, xy in (('object0:joint', (1.3, 0.6)),
                   ('object1:joint', (1.3, 0.9)),
                   ('goal0:joint', (1.45, 0.6)),
                   ('goal1:joint', (1.45, 0.9))):
    z = 0.3075 if name.startswith('object') else 0.296
    q = jset(jm, q, name, jnp.array([xy[0], xy[1], z, 1, 0, 0, 0]))
  kin = jax.jit(lambda s: JK.fk(jm, s))(st.replace(qpos=q))
  rgba = jm.geom_rgba
  rgba = rgba.at[jm.geom('object0')].set(jnp.array([1, 0, 0, 1.0]))
  rgba = rgba.at[jm.geom('goal0')].set(jnp.array([0, 0, 1, 1.0]))
  jr = JR.build_renderer(jm, ja, width=64, height=64, backend='pallas')
  tr = TR.build_renderer(tm, ja, width=64, height=64)
  # the port alone at 256x256: at 64x64 the one 64-px coarse region keeps
  # only 512 of the scene's triangles and the cubes drop out of the frame
  tr256 = TR.build_renderer(tm, ja, width=256, height=256)
  return jr, tr, kin, convert.kin_from_reference(kin), rgba, \
      torch.as_tensor(np.array(rgba))[None], tr256


def test_projected_planes_match(frame64):
  jr, tr, kin, tkin, rgba, trgba, _ = frame64
  ref = jax.jit(lambda k, c: JR._project_and_shade(jr, k, c))(kin, rgba)
  got = TR._project_and_shade(tr, tkin, trgba)
  for name, r, g in zip(ref._fields, ref, got):
    if name == 'valid':
      np.testing.assert_array_equal(g[0].numpy(), np.asarray(r))
    else:
      np.testing.assert_allclose(g[0].numpy(), np.asarray(r), rtol=1e-5,
                                 atol=1e-4, err_msg=name)
  assert int(got.valid.sum()) > 100


def test_binned_planes_match_bin_pallas(frame64):
  jr, tr, kin, tkin, rgba, trgba, _ = frame64
  ref = jax.jit(lambda k, c: JR._bin_pallas(
      jr, JR._project_and_shade(jr, k, c)))(kin, rgba)
  got = TR._bin_hierarchical(tr, TR._project_and_shade(tr, tkin, trgba))
  assert len(got) == len(ref) == 11
  for i, (r, g) in enumerate(zip(ref, got)):
    assert g.shape == (1,) + np.asarray(r).T.shape
    np.testing.assert_allclose(g[0].numpy().T, np.asarray(r), rtol=1e-5,
                               atol=1e-4, err_msg=f'plane {i}')
  assert float(got[9].sum()) > 0                   # some slots are live


def test_full_frame_matches_jax_pallas_path(frame64):
  jr, tr, kin, tkin, rgba, trgba, _ = frame64
  rgb_ref, depth_ref = jax.jit(jr.render)(kin, rgba)
  rgb, depth = tr.render(tkin, trgba)
  assert rgb.shape == (1, 64, 64, 3) and rgb.dtype == torch.uint8
  rgb_ref, depth_ref = np.asarray(rgb_ref), np.asarray(depth_ref)
  mism = (rgb[0].numpy() != rgb_ref).any(-1)
  assert mism.mean() <= FRAME_MISMATCH_TOL, f'{mism.sum()} pixels differ'
  np.testing.assert_allclose(depth[0].numpy()[~mism], depth_ref[~mism],
                             rtol=1e-4, atol=1e-4)
  assert rgb.reshape(-1, 3).float().std(0).mean() > 10   # not flat


def test_batched_frames_equal_single(frame64):
  """Two envs in one call: env 1 hides object0; each frame equals its own
  single-env render."""
  _, _, _, tkin, _, trgba, tr = frame64
  two = tkin.replace(**{k: torch.cat([getattr(tkin, k)] * 2) for k in (
      'xpos', 'xquat', 'ximat', 'xipos', 'geom_xpos', 'geom_xquat',
      'site_xpos', 'site_xmat')})
  hidden = trgba.clone()
  hidden[0, tr.model.geom('object0'), 3] = 0.0
  rgb, depth = tr.render(two, torch.cat([trgba, hidden]))
  for k, rgba in enumerate((trgba, hidden)):
    one_rgb, one_depth = tr.render(tkin, rgba)
    assert torch.equal(rgb[k], one_rgb[0])
    assert torch.equal(depth[k], one_depth[0])
  assert not torch.equal(rgb[0], rgb[1])


def test_shadows_only_darken(frame64):
  _, _, _, tkin, _, trgba, tr = frame64
  on, _ = tr.render(tkin, trgba)
  off, _ = tr.replace(shadows=False).render(tkin, trgba)
  diff = on.int() - off.int()
  assert (diff > 2).sum() == 0                    # never brighten
  assert (diff.amin(-1) < -2).sum() > 0, 'no shadow pixels'


@pytest.mark.parametrize('tile', [4, 8, 12, 16])
def test_kernel_limits_takes_patchable_tiles(tile):
  assert RK.kernel_limits(tile) == 'patch'  # one 4x2 patch per lane


@pytest.mark.parametrize('tile', [1, 2, 6, 10, 18, 20, 32])
def test_kernel_limits_general_path(tile):
  """Every other side takes the kernel's general path (the bands of
  ``subtile_plan``); the twin takes it too."""
  assert RK.kernel_limits(tile) == 'general'
  coeffs = torch.zeros((1, 2, 13, 3))
  iz, c = RK.raster_tiles(coeffs, tile, 5.0)
  assert iz.shape == (1, 2, tile * tile) and bool((c == 5.0).all())


@pytest.mark.parametrize('tile', [0, -1, -16])
def test_kernel_limits_rejects(tile):
  with pytest.raises(ValueError, match='at least one pixel'):
    RK.kernel_limits(tile)
  with pytest.raises(ValueError, match='at least one pixel'):
    RK.raster_tiles(torch.zeros((1, 2, 13, 3)), tile, 5.0)


@pytest.mark.parametrize('K', [0, 7, 50])
def test_raster_reference_any_slot_count(K):
  """The layout takes any K (the kernel reads slots 32 at a time): no slot,
  and counts that are no multiple of 4."""
  rng = np.random.RandomState(K)
  coeffs = torch.as_tensor(rng.normal(size=(2, 3, 13, K)).astype(np.float32))
  iz, c = RK.raster_tiles(coeffs, 8, 7.0)
  assert iz.shape == c.shape == (2, 3, 64)
  if K == 0:
    assert bool((iz == 0).all()) and bool((c == 7.0).all())
  assert bool(torch.isfinite(iz).all())


@pytest.mark.parametrize('TS', [8, 16])
def test_corner_cull_never_drops_a_winning_slot(TS):
  """The kernel drops a slot when one of its edge functions is negative at
  all four corner pixels of the tile.  The rounded forms are monotone in px
  and py, so such a slot covers no pixel: with those slots made empty the
  twin gives every pixel bit for bit."""
  planes = [torch.as_tensor(p.T)[None] for p in _random_planes(TS, 2, 64, 8)]
  coeffs = TR._coeff_planes(planes, TS, 2)
  lo, hi = 0.5, TS - 0.5
  missed = torch.zeros_like(coeffs[:, :, 0], dtype=torch.bool)
  for e in range(3):
    a, b, c = (coeffs[:, :, 3 * e + i] for i in range(3))
    corners = [a * x + b * y + c < 0 for x in (lo, hi) for y in (lo, hi)]
    missed |= corners[0] & corners[1] & corners[2] & corners[3]
  assert 0.05 < float(missed.float().mean()) < 0.95   # the cull does bite
  culled = coeffs.clone()
  culled[:, :, 0][missed] = 0.0
  culled[:, :, 1][missed] = 0.0
  culled[:, :, 2][missed] = -1.0                       # never inside
  iz, c = RK.raster_tiles_reference(coeffs, TS, 3.0)
  iz_c, c_c = RK.raster_tiles_reference(culled, TS, 3.0)
  assert torch.equal(iz, iz_c) and torch.equal(c, c_c)
