"""Port parity (render options): every ``build_renderer`` option of
geeco_tpu_torch against the JAX package's renderer on the CPU, and the
port's depth against the MuJoCo ray-cast fixtures.

The JAX side runs as its own tests run it: ``backend='jnp'`` (flat
binning) or ``'pallas'`` (the hierarchical path, its kernel in interpret
mode).  The port's hierarchical path runs the raster kernel's plain twin on
the CPU; the CUDA kernel at every tile side is held against the twin by
``tests/test_torch_card_kernels.py`` on the card.
"""

import os

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
from geeco_tpu_torch.core import mjcf as tmjcf
from geeco_tpu_torch.core.model import make_state
from geeco_tpu_torch.physics import kinematics as TK
from geeco_tpu_torch.render import rasterizer as TR

torch.set_num_threads(1)

# full frames: same binning, same arithmetic; projections and the rect ray
# cast differ by float32 rounding, so a pixel on an edge may flip (the
# tolerance of tests/test_torch_render.py)
FRAME_MISMATCH_TOL = 1e-3
DEPTH_TOL = dict(rtol=1e-4, atol=1e-4)
FIXDIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      'fixtures')


@pytest.fixture(scope='module')
def scene():
  """pad2-cube2 with its cubes and goals placed (the frame of
  tests/test_torch_render.py) and the arm lowered, so that the gripper
  camera sees the table; random texel colours for every slot."""
  jm, ja = jmjcf.load_model(reference_xml('geeco-pad2-cube2.xml'))
  st = jmake_state(jm)
  q = st.qpos
  for name, val in (('robot0:slide0', 0.405), ('robot0:slide1', 0.48),
                    ('robot0:slide2', 0.0), ('robot0:shoulder_lift_joint',
                                             0.8)):
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
  tex = np.random.RandomState(0).uniform(size=(9, 32, 32, 3)).astype(
      np.float32)
  return dict(jm=jm, ja=ja, tm=convert.model_from_reference(jm), kin=kin,
              tkin=convert.kin_from_reference(kin), rgba=rgba,
              trgba=torch.as_tensor(np.array(rgba))[None], tex=tex)


def _render_both(s, res, jax_backend, port_backend, textures=None,
                 eager=False, **kw):
  """The JAX frame (jitted, or ``eager``) and the port's, of one env."""
  jr = JR.build_renderer(s['jm'], s['ja'], width=res, height=res,
                         backend=jax_backend, **kw)
  tr = TR.build_renderer(s['tm'], s['ja'], width=res, height=res,
                         backend=port_backend, **kw)
  tex = None if textures is None else jnp.asarray(textures)
  if eager:
    with jax.disable_jit():
      ref = jr.render(s['kin'], s['rgba'], tex)
  else:
    ref = jax.jit(jr.render)(s['kin'], s['rgba'], tex)
  got = tr.render(s['tkin'], s['trgba'],
                  None if textures is None else torch.as_tensor(textures))
  return (np.asarray(ref[0]), np.asarray(ref[1])), \
      (got[0][0].numpy(), got[1][0].numpy()), tr


def _assert_frames_match(ref, got):
  (rgb_ref, depth_ref), (rgb, depth) = ref, got
  assert rgb.shape == rgb_ref.shape and rgb.dtype == np.uint8
  mism = (rgb != rgb_ref).any(-1)
  assert mism.mean() <= FRAME_MISMATCH_TOL, f'{mism.sum()} pixels differ'
  np.testing.assert_allclose(depth[~mism], depth_ref[~mism], **DEPTH_TOL)
  assert rgb.reshape(-1, 3).astype(float).std(0).mean() > 10   # not flat


# (case, resolution, JAX backend, port backend, the path the port takes,
# options, textured).  The cell-quantized rects are held against JAX run
# eagerly: jitted, XLA turns the division by the cell count G into a
# multiply by 1/G, and a cell centre that falls exactly on a texel edge
# (G = 6 cells over 32 texels: texel 24.0) moves to the next texel; eager
# JAX evaluates (c + 0.5) / G as written, as the port does.
CASES = [
    ('flat', 64, 'jnp', 'jnp', 'flat', {}, False),
    ('analytic-cells-textured-flat-eager', 64, 'jnp', 'jnp', 'flat',
     dict(analytic_rects=True, eager=True), True),
    ('analytic-pixel-texels-textured', 64, 'pallas', 'auto', 'hierarchical',
     dict(analytic_rects=True, rect_pixel_texels=True), True),
    ('depth_gl', 64, 'pallas', 'auto', 'hierarchical', dict(depth_gl=True),
     False),
    ('external_camera_0', 64, 'pallas', 'auto', 'hierarchical',
     dict(camera='external_camera_0'), False),
    ('gripper_camera_rgb', 64, 'pallas', 'auto', 'hierarchical',
     dict(camera='gripper_camera_rgb'), False),
    ('cull0', 64, 'pallas', 'auto', 'hierarchical', dict(cull=0), False),
    ('cull+1', 64, 'pallas', 'auto', 'hierarchical', dict(cull=1), False),
    ('tile8', 64, 'pallas', 'auto', 'hierarchical', dict(tile=8), False),
    # 3x3 tiles: no multiple of 4 a side, so both engines bin flat
    ('48px-tile16', 48, 'pallas', 'auto', 'flat', {}, False),
    ('mesh_face_budget', 64, 'jnp', 'jnp', 'flat',
     dict(mesh_face_budget=100, tris_per_tile=64, chunk=16), False),
]


@pytest.mark.parametrize('case,res,jb,tb,path,kw,textured', CASES,
                         ids=[c[0] for c in CASES])
def test_options_match_jax(scene, case, res, jb, tb, path, kw, textured):
  ref, got, tr = _render_both(scene, res, jb, tb,
                              scene['tex'] if textured else None, **kw)
  assert tr.path_counts == {path: 1}
  _assert_frames_match(ref, got)
  if kw.get('depth_gl'):
    assert 0.0 <= got[1].min() and got[1].max() <= 1.0
  if kw.get('mesh_face_budget'):
    assert tr.scene.tri.shape[0] < TR.build_renderer(
        scene['tm'], scene['ja'], 64, 64).scene.tri.shape[0]


def test_options_change_the_frame(scene):
  """Each option is seen: the cameras, culling, the textures on the
  analytic rects and depth_gl each give another frame than the default."""
  tr = TR.build_renderer(scene['tm'], scene['ja'], 64, 64)
  rgb0, depth0 = tr.render(scene['tkin'], scene['trgba'])
  for kw in (dict(camera='external_camera_0'),
             dict(camera='gripper_camera_rgb'), dict(cull=1),
             dict(analytic_rects=True)):
    rgb, _ = TR.build_renderer(scene['tm'], scene['ja'], 64, 64,
                               **kw).render(scene['tkin'], scene['trgba'])
    assert (rgb != rgb0).any(-1).float().mean() > 0.01, kw
  _, dgl = TR.build_renderer(scene['tm'], scene['ja'], 64, 64,
                             depth_gl=True).render(scene['tkin'],
                                                   scene['trgba'])
  assert not torch.equal(dgl, depth0)
  ar = TR.build_renderer(scene['tm'], scene['ja'], 64, 64,
                         analytic_rects=True)
  plain, _ = ar.render(scene['tkin'], scene['trgba'])
  tex, _ = ar.render(scene['tkin'], scene['trgba'],
                     torch.as_tensor(scene['tex']))
  assert (plain != tex).any(-1).float().mean() > 0.1


def test_analytic_rects_per_env_textures_and_visibility(scene):
  """Two envs in one render: per-env texel stacks and per-env rect
  visibility, each env equal to its own single-env render."""
  tr = TR.build_renderer(scene['tm'], scene['ja'], 64, 64,
                         analytic_rects=True)
  k = scene['tkin']
  two = k.replace(**{f: torch.cat([getattr(k, f)] * 2) for f in (
      'xpos', 'xquat', 'ximat', 'xipos', 'geom_xpos', 'geom_xquat',
      'site_xpos', 'site_xmat')})
  tex = torch.as_tensor(scene['tex'])
  hidden = scene['trgba'].clone()
  hidden[0, int(tr.scene.rect_geom[0]), 3] = 0.0      # the floor, env 1
  rgb, depth = tr.render(two, torch.cat([scene['trgba'], hidden]),
                         torch.stack([tex, 1.0 - tex]))
  for e, (rgba, t) in enumerate(((scene['trgba'], tex),
                                 (hidden, 1.0 - tex))):
    one_rgb, one_depth = tr.render(k, rgba, t)
    assert torch.equal(rgb[e], one_rgb[0]) and torch.equal(depth[e],
                                                           one_depth[0])
  assert not torch.equal(rgb[0], rgb[1])


def test_analytic_rects_scene_fields_match_jax(scene):
  """The port's carried build_render_scene gives JAX's rect fields."""
  from geeco_tpu.render.scene import build_render_scene as jscene
  from geeco_tpu_torch.render.scene import build_render_scene as tscene
  js = jscene(scene['jm'], scene['ja'], analytic_rects=True)
  ts = tscene(scene['tm'], scene['ja'], analytic_rects=True)
  for name in ('rect_geom', 'rect_off', 'rect_half', 'rect_slot',
               'rect_recv', 'rect_grid', 'tri', 'tri_geom'):
    np.testing.assert_array_equal(getattr(ts, name), getattr(js, name),
                                  err_msg=name)


def test_flat_binning_and_raster_match_jax(scene):
  """The flat path's stages alone at 64x64: the top-K slot ids (JAX's
  top_k tie order) and the chunked z-min scan, on the same planes."""
  jr = JR.build_renderer(scene['jm'], scene['ja'], 64, 64, backend='jnp')
  tr = TR.build_renderer(scene['tm'], scene['ja'], 64, 64, backend='jnp')
  jtp = jax.jit(lambda k, c: JR._project_and_shade(jr, k, c))(
      scene['kin'], scene['rgba'])
  ttp = TR.TriPlanes(*(torch.as_tensor(np.asarray(p))[None] for p in jtp))
  idx_ref, ok_ref = jax.jit(lambda t: JR._bin_flat(jr, t))(jtp)
  idx, ok = TR._bin_flat(tr, ttp)
  np.testing.assert_array_equal(ok[0].numpy(), np.asarray(ok_ref))
  live = np.asarray(ok_ref)
  np.testing.assert_array_equal(idx[0].numpy()[live],
                                np.asarray(idx_ref)[live])
  # the scan on random planes (tests/test_render.py's generator)
  rng = np.random.RandomState(3)
  K, n_tiles, TS = 24, 6, 8
  xy = rng.uniform(-4.0, TS + 4.0, size=(6, n_tiles, K)).astype(np.float32)
  iz = (1.0 / rng.uniform(0.5, 5.0, size=(3, n_tiles, K))).astype(
      np.float32)
  ok = (rng.uniform(size=(n_tiles, K)) > 0.25).astype(np.float32)
  col = rng.randint(0, 256 ** 3, size=(n_tiles, K)).astype(np.float32)
  planes = [*xy, *iz, ok, col]
  r8 = tr.replace(tile=TS)
  jr8 = jr._replace(tile=TS)
  z_ref, c_ref = JR._raster_jnp(jr8, [jnp.asarray(p) for p in planes],
                                n_tiles, TS * TS)
  z, c = TR._raster_flat(r8, [torch.as_tensor(p)[None] for p in planes],
                         TS * TS)
  mism = c[0].numpy() != np.asarray(c_ref)
  assert mism.mean() < 0.005
  hit = np.isfinite(np.asarray(z_ref)) & ~mism
  assert hit.any()
  np.testing.assert_allclose(z[0].numpy()[hit], np.asarray(z_ref)[hit],
                             **DEPTH_TOL)


def test_build_renderer_rejects_bad_options(scene):
  with pytest.raises(ValueError, match='backend'):
    TR.build_renderer(scene['tm'], scene['ja'], 64, 64, backend='cuda')
  with pytest.raises(ValueError, match='whole'):
    TR.build_renderer(scene['tm'], scene['ja'], 64, 64, tile=10)
  with pytest.raises(ValueError):
    TR.build_renderer(scene['tm'], scene['ja'], 64, 64, camera='nope')


# ------------------------------------------------------------------ MuJoCo

# (fixture tag, scene xml, variants), as tests/test_render_golden.py.  On
# nut-cone's frame 1 the silhouette IoU is 0.9381, under the 0.965 bound, in
# the JAX package too (its decimated hulls against MuJoCo's meshes; its own
# slow test fails there): the port's depth equals JAX's on that frame.
GOLDEN = [
    ('pad2cube2', 'geeco-pad2-cube2.xml', ('auto', 'jnp', 'jnp-analytic')),
    pytest.param('pad2cube2clutter4', 'geeco-pad2-cube2-clutter4.xml',
                 ('jnp',), marks=pytest.mark.slow),
    pytest.param('nutcone', 'geeco-nut-cone.xml', ('jnp',),
                 marks=pytest.mark.slow),
]


def _golden_depths(tag, xml, variant):
  golden = np.load(os.path.join(FIXDIR, f'mujoco_raycast_{tag}.npz'))
  m, assets = tmjcf.load_model(reference_xml(xml))
  H, W = int(golden['height']), int(golden['width'])
  backend, _, opt = variant.partition('-')
  r = TR.build_renderer(m, assets, width=W, height=H, backend=backend,
                        analytic_rects=(opt == 'analytic'))
  n = golden['qpos'].shape[0]
  st = make_state(m, n).replace(
      qpos=torch.as_tensor(golden['qpos'], dtype=torch.float32),
      mocap_pos=torch.as_tensor(golden['mocap_pos'], dtype=torch.float32),
      mocap_quat=torch.as_tensor(golden['mocap_quat'], dtype=torch.float32))
  _, depth = r.render(TK.fk(m, st))
  return depth.numpy(), golden['depth']


@pytest.mark.parametrize('tag,xml,variants', GOLDEN)
def test_depth_matches_mujoco_raycast(tag, xml, variants):
  """JAX's bounds (tests/test_render_golden.py): no sky holes, exact
  interiors, the > 2 cm and > 10 cm areas bounded, and the foreground
  silhouette's IoU."""
  for variant in variants:
    depths, goldens = _golden_depths(tag, xml, variant)
    for k, (d, g) in enumerate(zip(depths, goldens)):
      err = np.abs(d - g)
      miss = np.mean((d > 9.9) & (g > 0))
      assert miss < 1e-3, f'{variant} frame {k}: {miss:.4f} sky holes'
      assert np.median(err) < 1e-3, \
          f'{variant} frame {k}: median {np.median(err)}'
      frac2cm = np.mean(err > 0.02)
      assert frac2cm < 0.07, f'{variant} frame {k}: frac>2cm {frac2cm:.4f}'
      frac10cm = np.mean(err > 0.10)
      assert frac10cm < 0.05, \
          f'{variant} frame {k}: frac>10cm {frac10cm:.4f}'
      ours, mjs = d < 2.0, g < 2.0
      iou = (ours & mjs).sum() / max((ours | mjs).sum(), 1)
      assert iou > 0.965, f'{variant} frame {k}: silhouette IoU {iou:.4f}'
