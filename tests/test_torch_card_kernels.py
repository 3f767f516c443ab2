"""The port's two CUDA kernels against their plain PyTorch twins, on the
card (every test skips without one).

K1, the tile rasterizer (``csrc/raster_tiles.cu``): random planes at the
production shapes (B=64, 256 tiles of 16 px, 192 slots), with no slot
valid, with every slot valid and with a slot count that is no multiple of
4; bit for bit on random planes at a side of each class of band plan
(``RANDOM_SIDES``); bit for bit on the planes pad2-cube2's reset frames
bin at tiles 16, 8, 32 and 10, and at the port's bench's binning caps.

K2, the fused PSD solve (``csrc/psd_solve.cu``): random operands at the
``PSD_BUILDS`` shapes at B=64, 3 and 1 in clusters of 1, 2 and 4 blocks an
env, with and without weld rows, and at one shape for each other way
through the kernel; the operands of a real substep of the expert's
episode, and the substep through the kernel against the substep through
the twin; at the reset substep, where the solve amplifies float32
rounding, the kernel as one more float32 summation order against the
float64 twin; the same on clutter4's and nut-cone's operands; and one
kernel a substep in the device trace of a replayed control step.

tests/conftest.py imports JAX, which the card lacks, so there the file
runs without it::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_card_kernels.py

This file imports no JAX.
"""

import contextlib
import os

import pytest
import torch
from torch.testing import assert_close

from geeco_tpu_torch.core import mjcf
from geeco_tpu_torch.envs.base import ASSET_ROOT, MODEL_XML, make_env
from geeco_tpu_torch.expert import policies as EP
from geeco_tpu_torch.physics import solver_pallas as SP
from geeco_tpu_torch.physics import substep_graph as SG
from geeco_tpu_torch.render import raster_kernel as rk
from geeco_tpu_torch.render import rasterizer as R
from geeco_tpu_torch.utils import build
from test_torch_substep_graph import _kernel_events

ENVS = 64               # the batch of the production checks
# kernel vs twin: both evaluate (a*px + b*py) + c with rounded ops and no
# FMA, so they must agree exactly; allow at most 1 pixel in 10^4 to differ
MISMATCH_TOL = 1e-4
IZ_ATOL = 1e-6          # inverse-depth agreement on matching pixels
# PSD kernel vs twin: the JAX package's pallas-vs-psd tolerances
# (tests/test_solver_pallas.py:87-91); sums run in another order
FORCE_TOL = dict(rtol=1e-2, atol=2e-3)
QVEL_TOL = dict(rtol=1e-3, atol=1e-4)
# PSD kernel at the reset substep: at most this share of envs where it is
# > 2x farther from the float64 solve than every float32 twin
WITNESS_MAX_FRAC = 0.125
# the PSD solve's shapes (nI, nv, nE, K, nlim) and the cluster sizes they
# are run in (None: the plan's own at B=3): pad2-cube2 with and without weld
# rows, then one shape for each other way through the kernel (the K=192
# one is also clutter4's at rolling=False), then nut-cone's at
# rolling=False, its K the sum of its quotas
PSD_BUILDS = (((530, 39, 6, 128, 9), (1, 2, 4)),
              ((530, 39, 0, 128, 9), (1, 2, 4)),
              ((274, 45, 6, 64, 9), (1,)),
              ((786, 63, 6, 192, 9), (None,)),
              ((1298, 87, 6, 320, 9), (None,)),
              ((914, 39, 6, 224, 9), (None,)))
# K1 held bit for bit against its twin on random planes at a side of each
# class of band plan (raster_kernel.subtile_plan): one band with masked
# pixels (1, 2, 6, 10), two to seven bands (18, 20, 24, 32, 40)
RANDOM_SIDES = (1, 2, 6, 10, 18, 20, 24, 32, 40)
RANDOM_SIDES_SHAPE = (3, 16, 192)   # B, n_tiles, K
SKY = R._pack_sky((0.45, 0.86, 0.57))


def build_kernels():
  """Every library the card tests launch, every nvcc started together."""
  build.build_all([build.raster_library()] + [
      build.psd_library(SP.build_spec(3, *shape, cluster=C))
      for shape, sizes in PSD_BUILDS for C in sizes])


@pytest.fixture(scope='module')
def card():
  if not torch.cuda.is_available():
    pytest.skip('needs a CUDA card: the card tests run only there')
  build_kernels()
  return torch.device('cuda')


def production_env(card):
  """pad2-cube2's production env, reset at B=64, and its model on the CPU
  with its assets (what ``option_renderer`` compiles a scene from)."""
  env = make_env('pad2-cube2', device=card)
  env.setup()
  es = env.reset_random(ENVS, torch.Generator(device=card).manual_seed(1))
  am = mjcf.load_model(os.path.join(ASSET_ROOT, 'envs',
                                    MODEL_XML['pad2-cube2']))
  return env, es, am


@pytest.fixture(scope='module')
def slice1(card):
  return production_env(card)


@pytest.fixture(scope='module')
def slice2(card):
  """pad2-cube2 at rolling=False, solver_method='pallas' (its solve is K2),
  reset at B=64."""
  env = make_env('pad2-cube2', device=card, rolling=False,
                 solver_method='pallas')
  env.setup()
  assert env.stepper.cs.ngrp == 4
  es = env.reset_random(ENVS, torch.Generator(device=card).manual_seed(2))
  return env, es


# ------------------------------------------------------------------ helpers

def random_planes(B, n_tiles, K, tile, gen):
  """Random vertex planes [B, n_tiles, K] as _bin_hierarchical emits them."""
  dev = gen.device
  MTS = 2 * tile
  u = lambda lo, hi: lo + (hi - lo) * torch.rand(
      (B, n_tiles, K), generator=gen, device=dev)
  x0, y0, x1, y1, x2, y2 = (u(-6.0, MTS + 6.0) for _ in range(6))
  iz0, iz1, iz2 = (1.0 / u(0.5, 5.0) for _ in range(3))
  ok = (u(0.0, 1.0) > 0.25).float()
  colp = torch.floor(u(0.0, 256.0 ** 3 - 1))
  return [x0, y0, x1, y1, x2, y2, iz0, iz1, iz2, ok, colp]


def assert_matches_twin(coeffs, tile, sky, out=None, exact=False):
  """K1's (inverse depth, colour) on ``coeffs`` (``out``: of a launch the
  caller made) against the twin's: finite, and bit-equal (``exact``) or
  differing on at most MISMATCH_TOL of the pixels."""
  iz_k, c_k = rk.raster_tiles(coeffs, tile, sky) if out is None else out
  iz_r, c_r = rk.raster_tiles_reference(coeffs, tile, sky)
  assert bool(torch.isfinite(iz_k).all() and torch.isfinite(c_k).all())
  if exact:
    n = int(((iz_k != iz_r) | (c_k != c_r)).sum())
    assert n == 0, f'{n} of {iz_k.numel()} pixels differ from the twin'
  else:
    mism = (c_k != c_r) | ((iz_k - iz_r).abs() > IZ_ATOL)
    assert float(mism.float().mean()) <= MISMATCH_TOL, \
        f'{int(mism.sum())} of {mism.numel()} pixels differ from the twin'


@contextlib.contextmanager
def wrapped_k1(on_launch):
  """Inside the block every K1 launch is made as its caller makes it, then
  handed to ``on_launch(coeffs, tile, sky, output)``: the launches, and so
  the counts, stay the path's."""
  launch = rk.raster_tiles

  def wrapped(coeffs, tile, sky):
    out = launch(coeffs, tile, sky)
    on_launch(coeffs, tile, sky, out)
    return out

  # the kernel's wrapper counts its launch under the module's name
  wrapped.launches = launch.launches
  rk.raster_tiles = wrapped
  try:
    yield
  finally:
    rk.raster_tiles = launch
    launch.launches = wrapped.launches


@contextlib.contextmanager
def launches_of_k1():
  """Yields a list that fills with every K1 launch's (coeffs, tile, sky,
  output) made inside the block."""
  seen = []
  with wrapped_k1(lambda *launch: seen.append(launch)):
    yield seen


@contextlib.contextmanager
def checked_k1(first_of_each_size=False):
  """Hold every K1 launch inside the block (or the first of each batch
  size) against the twin as it is made, on the coefficients its caller
  gave it and the output the caller goes on with; yields a list that fills
  with the frames of every launch."""
  sizes = []

  def check(coeffs, tile, sky, out):
    if not (first_of_each_size and coeffs.shape[0] in sizes):
      assert_matches_twin(coeffs, tile, sky, out)
    sizes.append(coeffs.shape[0])
  with wrapped_k1(check):
    yield sizes


def option_renderer(env, assets_model, **options):
  """A renderer of env's scene with ``options``, compiled from the model on
  the CPU, then on the card's model, as GeecoEnv builds its."""
  m, assets = assets_model
  return R.build_renderer(m, assets, **options).replace(model=env.model)


def random_psd_operands(B, K, nlim, nv, nE, gen):
  """Random well-posed operands of the fused PSD solve on gen's device."""
  dev = gen.device
  nI = 4 * K + 2 * nlim
  r = lambda *s: torch.randn(*s, generator=gen, device=dev)
  u = lambda *s: torch.rand(*s, generator=gen, device=dev)
  J = r(B, nI, nv) / nv ** 0.5
  A = r(B, nv, nv) / nv ** 0.5
  M = torch.eye(nv, device=dev) + A @ A.transpose(1, 2)
  X = torch.linalg.solve(M, J.transpose(1, 2)).contiguous()
  R_ = 0.1 + u(B, nI)
  if nE:
    JE = r(B, nE, nv) / nv ** 0.5
    XE = torch.linalg.solve(M, JE.transpose(1, 2))
    AIE = (J @ XE).contiguous()
    EEinv = torch.linalg.inv(JE @ XE + torch.diag_embed(
        0.1 + u(B, nE))).contiguous()
  else:
    AIE = J.new_zeros((B, nI, 0))
    EEinv = J.new_zeros((B, 0, 0))
  diag = (J * X.transpose(1, 2)).sum(-1) + R_
  return dict(J=J, X=X, A_IE=AIE, EEinv=EEinv, R=R_, b=r(B, nI),
              precond=1.0 / diag, f0=r(B, nI), mu_t=0.5 + 0.5 * u(B, K),
              mu_tor=0.005 + 0.01 * u(B, K),
              con_act=(u(B, K) > 0.3).float(),
              lim_act=(u(B, 2 * nlim) > 0.5).float(), K=K, nlim=nlim,
              iterations=60)


@contextlib.contextmanager
def eager_substeps():
  """Substeps run Python inside the block: no chain of CUDA graphs, whose
  replay would run the solve it captured."""
  engages = SG.engages
  SG.engages = lambda st, state, contacts: False
  try:
    yield
  finally:
    SG.engages = engages


def capture_solve(env, phys):
  """The fused-solve operands of one substep of env from phys."""
  with eager_substeps(), SP.capture() as calls:
    env.stepper.substep(phys, env.solver_iterations, 'pallas')
  assert len(calls) == 1, f'{len(calls)} fused solves in one substep'
  return calls[0]


def twin_substep(env, phys):
  """One substep of env from phys with K2's plain twin in its place."""
  real = SP.psd_solve
  SP.psd_solve = SP.psd_solve_reference
  try:
    with eager_substeps():
      return env.stepper.substep(phys, env.solver_iterations, 'pallas')
  finally:
    SP.psd_solve = real


def assert_kernel_and_substep_match_twin(env, phys):
  """K2 against its twin on one substep's operands, and the substep through
  the kernel (its chain's replay) against the substep through the twin."""
  ops = capture_solve(env, phys)
  f_k = SP.psd_solve(**ops)
  assert bool(torch.isfinite(f_k).all())
  assert_close(f_k, SP.psd_solve_reference(**ops), **FORCE_TOL)
  sub_k = env.stepper.substep(phys, env.solver_iterations, 'pallas')
  assert_close(sub_k.qvel, twin_substep(env, phys).qvel, **QVEL_TOL)


def reordered(ops, gen=None):
  """The same solve with its contacts, limit rows and dofs in a random
  order (with no `gen`, only the dofs, reversed): the same float32 math,
  its sums taken in another order.  Returns the operands and the row order
  (forces[:, rows] = solve(operands))."""
  B, nI, nv = ops['J'].shape
  K, nlim, dev = ops['K'], ops['nlim'], ops['J'].device
  if gen is None:
    pk = torch.arange(K, device=dev)
    pl = torch.arange(2 * nlim, device=dev)
    pv = torch.arange(nv - 1, -1, -1, device=dev)
  else:
    pk = torch.randperm(K, generator=gen, device=dev)
    pl = torch.randperm(2 * nlim, generator=gen, device=dev)
    pv = torch.randperm(nv, generator=gen, device=dev)
  rows = torch.cat([pk + g * K for g in range(4)] + [
      4 * K + pl, torch.arange(4 * K + 2 * nlim, nI, device=dev)])
  out = dict(ops, J=ops['J'][:, rows][:, :, pv], X=ops['X'][:, pv][:, :, rows],
             A_IE=ops['A_IE'][:, rows], mu_t=ops['mu_t'][:, pk],
             mu_tor=ops['mu_tor'][:, pk], con_act=ops['con_act'][:, pk],
             lim_act=ops['lim_act'][:, pl],
             **{k: ops[k][:, rows] for k in ('R', 'b', 'precond', 'f0')})
  return {k: v.contiguous() if isinstance(v, torch.Tensor) else v
          for k, v in out.items()}, rows


# ----------------------------------------------------------------------- K1

@pytest.mark.parametrize('case', ['production', 'none valid', 'all valid',
                                  'K=50'])
def test_k1_matches_its_twin_on_random_planes(case, card):
  gen = torch.Generator(device=card).manual_seed(0)
  if case == 'production':
    planes = random_planes(ENVS, 256, 192, 16, gen)
  else:
    planes = random_planes(3, 7, 50 if case == 'K=50' else 192, 16, gen)
    if case != 'K=50':
      planes[9] = torch.full_like(planes[9], float(case == 'all valid'))
  assert_matches_twin(R._coeff_planes(planes, 16, 2), 16, SKY)


@pytest.mark.parametrize('tile', RANDOM_SIDES)
def test_k1_is_bit_equal_to_its_twin_at_each_band_plan(tile, card):
  B, n_tiles, K = RANDOM_SIDES_SHAPE
  planes = random_planes(B, n_tiles, K, tile,
                         torch.Generator(device=card).manual_seed(tile))
  assert_matches_twin(R._coeff_planes(planes, tile, 2), tile, SKY,
                      exact=True)


# tile, frame side, renderer options
FRAME_TILES = {'tile 16': (16, 256, {}), 'tile 8': (8, 256, {}),
               'tile 32': (32, 256, {}), 'tile 10 at 320 px': (10, 320, {}),
               "the bench's caps 192/96": (16, 256, dict(coarse_k=192,
                                                         mid_k=96))}


@pytest.mark.parametrize('case', list(FRAME_TILES))
def test_k1_is_bit_equal_to_its_twin_on_frame_planes(case, slice1):
  """One render of the reset frames: the hierarchical path, one K1 launch,
  bit-equal to the twin on its coefficients, a finite frame."""
  env, es, am = slice1
  tile, res, options = FRAME_TILES[case]
  r = option_renderer(env, am, tile=tile, width=res, height=res, **options)
  rk.raster_tiles.launches = 0
  with launches_of_k1() as seen:
    rgb, depth = r.render(env.kin(es), es.rgba)
  torch.cuda.synchronize()
  assert rk.raster_tiles.launches == 1 and len(seen) == 1
  assert r.path_counts == {'hierarchical': 1}
  coeffs, t, sky, out = seen[0]
  assert t == tile
  assert_matches_twin(coeffs, t, sky, out, exact=True)
  assert rgb.shape == (ENVS, res, res, 3)
  assert bool(torch.isfinite(depth).all())


# ----------------------------------------------------------------------- K2

@pytest.mark.parametrize('nE', [6, 0])
@pytest.mark.parametrize('B', [ENVS, 3, 1])
def test_k2_matches_its_twin_on_random_operands(B, nE, card):
  """pad2-cube2's shapes (nI=530, nv=39, K=128, nlim=9), with and without
  weld rows, in the plan's cluster and in 1, 2 and 4 blocks an env:
  resident with J in registers, the wrapper's count of shared memory the
  source's, the forces within the tolerance of the twin's."""
  rnd = random_psd_operands(B, 128, 9, 39, nE,
                            torch.Generator(device=card).manual_seed(B + nE))
  ref = SP.psd_solve_reference(**rnd)
  for C in (None, 1, 2, 4):
    lay = SP.plan(B, 530, 39, nE, 128, C)
    assert lay['resident'] and lay['jreg'] > 0, lay
    lib = build.load_psd(SP.build_spec(B, 530, 39, nE, 128, 9, C))
    assert lay['smem'] == lib.psd_solve_smem_bytes(), lay
    assert_close(SP.psd_solve(**rnd, cluster=C), ref, **FORCE_TOL)


# K, nv, cluster, the plan expected: J in shared memory, one block an env
# (staged by bulk copy); a larger scene (K=192 contacts, nv=63), resident
# only split over a cluster; shapes resident in no cluster of four, J and
# X left in device memory
OTHER_SHAPES = {'K=64 nv=45': (64, 45, 1, dict(cluster=1, resident=True,
                                               jreg=0)),
                'K=192 nv=63': (192, 63, None, dict(cluster=2, resident=True,
                                                    jreg=0)),
                'K=320 nv=87': (320, 87, None, dict(cluster=1,
                                                    resident=False, jreg=0))}


@pytest.mark.parametrize('case', list(OTHER_SHAPES))
def test_k2_matches_its_twin_each_other_way_through(case, card):
  K, nv, C, want = OTHER_SHAPES[case]
  rnd = random_psd_operands(3, K, 9, nv, 6,
                            torch.Generator(device=card).manual_seed(K))
  lay = SP.plan(3, 4 * K + 18, nv, 6, K, C)
  assert all(lay[k] == v for k, v in want.items()), (lay, want)
  assert_close(SP.psd_solve(**rnd, cluster=C), SP.psd_solve_reference(**rnd),
               **FORCE_TOL)


def test_k2_matches_its_twin_on_a_real_substep(slice2):
  """A substep 5 control steps into the expert's episode."""
  env, es = slice2
  es5, _ = EP.rollout(env, es, EP.make_expert(env), length=5)
  assert_kernel_and_substep_match_twin(env, es5.phys)


def test_k2_at_the_reset_substep_is_one_more_float32_order(slice2):
  """The first substep after reset_random, where the 60-iteration solve is
  unstable to float32 rounding: every float32 solve is far from the
  float64 one.  A kernel that computes the twin's function is one more
  summation order, never far beyond all of them in most envs; a fault
  puts it last.  The kernel, the twin, and the twin with its sums in 4
  other orders (the dofs reversed, then random orders), each against the
  float64 twin, env by env."""
  env, es = slice2
  ops = capture_solve(env, es.phys)
  gen = torch.Generator(device=ops['J'].device).manual_seed(0)
  f64 = SP.psd_solve_reference(**{
      k: v.double() if isinstance(v, torch.Tensor) else v
      for k, v in ops.items()})
  f_t = SP.psd_solve_reference(**ops)
  solves = [SP.psd_solve(**ops), f_t]
  for i in range(4):
    o, rows = reordered(ops, gen if i else None)
    f = torch.empty_like(f_t)
    f[:, rows] = SP.psd_solve_reference(**o)
    solves.append(f)
  # [n_solves, B]: the largest distance from float64
  D = torch.stack([(f.double() - f64).abs().amax(1) for f in solves])
  far = int(((D[0] > 2 * D[1:].amax(0)) &
             (D[0] > FORCE_TOL['atol'])).sum())
  assert far <= ENVS * WITNESS_MAX_FRAC, (
      f'K2 is > 2x farther from the float64 solve than every float32 twin '
      f'in {far} of {ENVS} envs')


def test_a_replayed_control_step_runs_k2_once_a_substep(slice2):
  env, es = slice2
  zeros = torch.zeros(ENVS, 4, device=es.phys.qpos.device)
  es = env.step(es, zeros)                        # its chains captured
  assert _kernel_events(lambda: env.step(es, zeros), 'psd_solve_kernel',
                        env.n_substeps) == env.n_substeps


@pytest.mark.parametrize('shapes', ['pad2-cube2-clutter4', 'nut-cone'])
def test_k2_on_the_scenes_operands(shapes, card):
  """clutter4 (K=192, nv=63) and nut-cone (K the sum of its quotas, 224)
  at rolling=False, solver_method='pallas', 64 envs one control step past
  reset_random: the kernel against its twin on one substep's operands, the
  substep through each, and one kernel a substep in the device trace of a
  replayed control step."""
  env = make_env(shapes, device=card, rolling=False, solver_method='pallas',
                 settle_steps=2)
  assert env.stepper.cs.ngrp == 4
  zeros = torch.zeros(ENVS, 4, device=card)
  es = env.reset_random(ENVS, torch.Generator(device=card).manual_seed(4))
  es = env.step(es, zeros)
  assert_kernel_and_substep_match_twin(env, es.phys)
  assert _kernel_events(lambda: env.step(es, zeros), 'psd_solve_kernel',
                        env.n_substeps) == env.n_substeps
