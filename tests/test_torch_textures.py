"""Port parity (background textures and the viewer): the textured render of
geeco_tpu_torch against the JAX package's (``backend='pallas'``, interpret
mode), ``VideoCycler`` against the JAX package's on a GIF and a directory
of frames, the terminal viewer's drawing, and a scripted drive of the
viewer CLI (``--keys``), on the CPU.

The renders are 128x128 with binning caps of 4096/1024 triangles: at the
defaults the far wall's triangles lose their slots to nearer ones below
256 px in both engines, and the background wall must be in the frame.
"""

import io
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geeco_tpu.data import videos as JV
from geeco_tpu.envs.base import make_env as jmake_env
from geeco_tpu.render import viewer as JViewer
from geeco_tpu_torch.data import videos as TV
from geeco_tpu_torch.envs.base import make_env as tmake_env
from geeco_tpu_torch.render import viewer as TViewer
from geeco_tpu_torch.run import viewer as viewer_cli

torch.set_num_threads(1)

RES = (128, 128)
CAPS = {'coarse_k': 4096, 'mid_k': 1024}
SMALL = dict(n_substeps=1, settle_steps=1)
# projections differ by float32 rounding: edge pixels may flip
FRAME_MISMATCH_TOL = 1e-3


def _gif(path, colors, size=(40, 30)):
  from PIL import Image
  frames = [Image.new('RGB', size, c) for c in colors]
  for i, f in enumerate(frames):   # a gradient, so resampling matters
    px = f.load()
    for x in range(size[0]):
      px[x, i % size[1]] = (x * 6 % 256, 255 - x * 6 % 256, 40 * i % 256)
  frames[0].save(path, save_all=True, append_images=frames[1:])
  return str(path)


@pytest.fixture(scope='module')
def envs():
  te = tmake_env('pad2-cube2', frame_res=RES, renderer_kwargs=CAPS,
                 device='cpu', **SMALL)
  je = jmake_env('pad2-cube2', frame_res=RES,
                 renderer_kwargs=dict(CAPS, backend='pallas'), **SMALL)
  phys = je.setup()
  return je, te, phys


def test_background_slot_and_stack(envs):
  je, te, _ = envs
  assert te.background_slot() == je.background_slot() is not None
  np.testing.assert_array_equal(te.renderer.scene.tex_default,
                                np.asarray(je.renderer.scene.tex_default))
  R = te.renderer.scene.tex_res
  frame = np.random.RandomState(0).rand(R, R, 3).astype(np.float32)
  np.testing.assert_array_equal(te.background_textures(frame).numpy(),
                                np.asarray(je.background_textures(frame)))
  per_env = te.background_textures(np.stack([frame, frame[::-1]]))
  assert per_env.shape == (2,) + te.renderer.scene.tex_default.shape


def test_textured_render_from_qpos_matches(envs):
  """Two envs, each with its own background frame: the port's frames
  against the JAX package's, and the wall changed from the untextured
  frame."""
  je, te, phys = envs
  R = te.renderer.scene.tex_res
  rng = np.random.RandomState(1)
  frames = rng.rand(2, R, R, 3).astype(np.float32)
  qpos = np.stack([np.asarray(phys.qpos)] * 2)
  qpos[1, :3] += 0.02                   # the second env's robot moved
  mocap = np.concatenate([np.asarray(phys.mocap_pos[0]),
                          np.asarray(phys.mocap_quat[0])])
  mocap = np.stack([mocap, mocap])
  rgba = np.stack([je.rgba0] * 2).astype(np.float32)
  tex = np.stack([np.asarray(je.background_textures(f)) for f in frames])
  ref_rgb, ref_depth = jax.jit(jax.vmap(je.render_from_qpos))(
      jnp.asarray(qpos), jnp.asarray(mocap), jnp.asarray(rgba),
      jnp.asarray(tex))
  rgb, depth = te.render_from_qpos(
      torch.as_tensor(qpos), torch.as_tensor(mocap), torch.as_tensor(rgba),
      te.background_textures(frames))
  ref_rgb, ref_depth = np.asarray(ref_rgb), np.asarray(ref_depth)
  mism = (rgb.numpy() != ref_rgb).any(-1)
  assert mism.mean() <= FRAME_MISMATCH_TOL, f'{mism.sum()} pixels differ'
  np.testing.assert_allclose(depth.numpy()[~mism], ref_depth[~mism],
                             rtol=1e-4, atol=1e-4)
  plain, _ = te.render_from_qpos(torch.as_tensor(qpos),
                                 torch.as_tensor(mocap),
                                 torch.as_tensor(rgba))
  wall = (plain != rgb).any(-1)
  assert wall.float().mean() > 0.05          # the wall is in the frame ...
  assert not wall[:, -32:].any()             # ... the table front is not


def test_video_cycler_matches_on_a_gif(tmp_path):
  path = _gif(tmp_path / 'clip.gif', [(255, 0, 0), (0, 255, 0),
                                      (0, 0, 255)])
  ref, got = JV.VideoCycler(path), TV.VideoCycler(path)
  for _ in range(7):                  # cycles the 3 frames
    np.testing.assert_array_equal(next(got), next(ref))
  np.testing.assert_array_equal(got.texel_steps(5, 16),
                                ref.texel_steps(5, 16))
  tex = TV.VideoCycler(path).texel_steps(4, 16)
  assert tex.shape == (4, 16, 16, 3) and tex.dtype == np.float32
  assert 0.0 <= tex.min() and tex.max() <= 1.0


def test_video_cycler_directory_and_missing_opencv(tmp_path, monkeypatch):
  from PIL import Image
  d = tmp_path / 'frames'
  d.mkdir()
  for i, c in enumerate([(255, 0, 0), (0, 255, 0)]):
    Image.new('RGB', (8, 6), c).save(d / f'f{i}.png')
  got = TV.VideoCycler(str(d))
  assert [next(got)[0, 0].tolist() for _ in range(3)] == [
      [255, 0, 0], [0, 255, 0], [255, 0, 0]]
  with pytest.raises(ValueError, match='no image frames'):
    TV.VideoCycler(str(tmp_path))
  # other formats decode with OpenCV, which the card does not have
  monkeypatch.setitem(sys.modules, 'cv2', None)
  with pytest.raises(ImportError, match='OpenCV'):
    TV.VideoCycler(str(tmp_path / 'clip.mp4'))


def test_viewer_draws_like_the_reference():
  rng = np.random.default_rng(0)
  frame = rng.integers(0, 256, (48, 40, 3), dtype=np.uint8)
  for size in ((40, 24), (20, 10)):
    assert TViewer.frame_to_ansi(frame, *size) == \
        JViewer.frame_to_ansi(frame, *size)
  flt = rng.random((16, 16, 3)).astype(np.float32)
  assert TViewer.frame_to_ansi(flt, 16, 8) == \
      JViewer.frame_to_ansi(flt, 16, 8)


def test_terminal_viewer_off_a_tty_and_to_a_file():
  viewer = TViewer.TerminalViewer()   # stdout under pytest is not a TTY
  viewer.feed(np.zeros((8, 8, 3), np.uint8))
  viewer.close()
  assert viewer.frames_shown == 1
  buf = io.StringIO()
  with TViewer.TerminalViewer(fps=0, file=buf, max_cols=8,
                              max_rows=4) as v:
    v.feed(np.full((8, 8, 3), 128, np.uint8), hud='t=0')
  assert '▀' in buf.getvalue() and 't=0' in buf.getvalue()


def test_viewer_cli_scripted_keys(tmp_path, capsys):
  """--keys drives the arm without a TTY: 'w', 'e', ' ' and 'g' step, 'p'
  saves a PNG, 'x' resets the step count, 'q' quits."""
  args = types.SimpleNamespace(
      shapes='pad2-cube2', frame_res=(64, 64), seed=0, move=0.5,
      keys='we gpx ddq', out_dir=str(tmp_path), n_substeps=2,
      solver_iterations=8, settle_steps=1, fps=0.0, device='cpu')
  assert viewer_cli.main(args) == 3    # ' ', 'd', 'd' after the reset
  assert os.listdir(tmp_path) == ['viewer_000.png']
  parsed, _ = viewer_cli.ARGPARSER.parse_known_args(['--keys', 'q'])
  assert parsed.keys == 'q' and parsed.device is None
