"""Port parity (core): the MJCF loader, Model/State conversion and the math
ops of geeco_tpu_torch against the JAX package, on the CPU.

Inputs are made with numpy from a fixed seed and handed to both engines.
"""

import dataclasses
import os
import re
import subprocess
import sys

from tests.conftest import REPO_ROOT, reference_xml
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geeco_tpu.core import math as jgm
from geeco_tpu.core import mjcf as jmjcf
from geeco_tpu.core import model as jmodel
from geeco_tpu_torch.core import convert
from geeco_tpu_torch.core import math as tgm
from geeco_tpu_torch.core import mjcf as tmjcf
from geeco_tpu_torch.core import model as tmodel

# The tensors here are small: one intra-op thread is as fast, and it keeps
# the parallel test workers from oversubscribing the cores.
torch.set_num_threads(1)

# float32 elementwise math evaluated in the same order: a few ulps apart
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(scope='module')
def models():
  xml = reference_xml('geeco-pad2-cube2.xml')
  jm, ja = jmjcf.load_model(xml)
  tm, ta = tmjcf.load_model(xml)
  return jm, ja, tm, ta


def _leaves(m):
  for f in dataclasses.fields(m):
    if not f.name.startswith('_') and f.name != 'opt':
      yield f.name, getattr(m, f.name)


def test_model_leaves_equal_jax_loader(models):
  jm, _, tm, _ = models
  for name, v in _leaves(tm):
    ref = getattr(jm, name)
    if isinstance(v, torch.Tensor):
      assert v.dtype == torch.float32, name
      np.testing.assert_array_equal(v.numpy(), np.asarray(ref), err_msg=name)
    else:
      assert v == ref, name
  for f in dataclasses.fields(tm.opt):
    v, ref = getattr(tm.opt, f.name), getattr(jm.opt, f.name)
    if isinstance(v, torch.Tensor):
      np.testing.assert_array_equal(v.numpy(), np.asarray(ref))
    else:
      assert v == ref


def test_assets_equal_jax_loader(models):
  _, ja, _, ta = models
  assert ta.mesh_ids == ja.mesh_ids
  assert ta.geom_material == ja.geom_material
  assert ta.material_texture == ja.material_texture
  assert set(ta.texture_images) == set(ja.texture_images)
  for k, img in ja.texture_images.items():
    np.testing.assert_array_equal(ta.texture_images[k], img)
  for k, rgb in ja.textures.items():
    np.testing.assert_allclose(ta.textures[k], rgb, rtol=0, atol=0)


def test_texture_read_failure_raises(tmp_path):
  """A texture that cannot be read is an error, not a grey stand-in."""
  with pytest.raises(OSError):
    tmjcf._texture_mean_rgb(str(tmp_path / 'missing.png'))
  with pytest.raises(OSError):
    tmjcf._texture_image(str(tmp_path / 'missing.png'))


def test_convert_model_equals_loader(models):
  jm, _, tm, _ = models
  cm = convert.model_from_reference(jm)
  for (name, a), (_, b) in zip(_leaves(cm), _leaves(tm)):
    if isinstance(a, torch.Tensor):
      assert torch.equal(a, b), name
    else:
      assert a == b, name


def test_make_state_matches(models):
  jm, _, tm, _ = models
  js = jmodel.make_state(jm)
  ts = tmodel.make_state(tm, 3)
  for f in ('qpos', 'qvel', 'ctrl', 'mocap_pos', 'mocap_quat', 'time'):
    got = getattr(ts, f)
    assert got.shape[0] == 3
    for b in range(3):
      np.testing.assert_array_equal(got[b].numpy(), np.asarray(getattr(js, f)))


def test_state_conversion_adds_env_axis(models):
  jm, _, _, _ = models
  js = jmodel.make_state(jm)
  ts = convert.state_from_reference(js)
  assert ts.qpos.shape == (1, jm.nq) and ts.mocap_pos.shape == (1, 1, 3)
  assert ts.time.shape == (1,) and ts.efc_force is None
  tb = convert.state_from_reference(
      js.replace(qpos=jnp.stack([js.qpos] * 2), time=jnp.zeros(2)))
  assert tb.qpos.shape == (2, jm.nq) and tb.time.shape == (2,)


def test_joint_qpos_helpers(models):
  jm, _, tm, _ = models
  rng = np.random.RandomState(0)
  q = rng.normal(size=(2, jm.nq)).astype(np.float32)
  for name, val in (('robot0:slide0', np.float32(0.3)),
                    ('object0:joint', rng.normal(size=7).astype(np.float32))):
    ref = np.asarray(jmodel.set_joint_qpos(jm, jnp.asarray(q), name, val))
    got = tmodel.set_joint_qpos(tm, torch.as_tensor(q), name, val).numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(
        tmodel.get_joint_qpos(tm, torch.as_tensor(q), name).numpy(),
        np.asarray(jmodel.get_joint_qpos(jm, jnp.asarray(q), name)))
  v = rng.normal(size=(2, jm.nv)).astype(np.float32)
  for name, val in (('robot0:slide2', np.float32(0.7)),
                    ('object1:joint', rng.normal(size=6).astype(np.float32))):
    ref = np.asarray(jmodel.set_joint_qvel(jm, jnp.asarray(v), name, val))
    got = tmodel.set_joint_qvel(tm, torch.as_tensor(v), name, val).numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(
        tmodel.get_joint_qvel(tm, torch.as_tensor(v), name).numpy(),
        np.asarray(jmodel.get_joint_qvel(jm, jnp.asarray(v), name)))
  # per-env values for a scalar joint
  got = tmodel.set_joint_qpos(tm, torch.as_tensor(q), 'robot0:slide1',
                              torch.tensor([0.1, 0.2]))
  lo, _ = tm.jnt_qpos_slice('robot0:slide1')
  np.testing.assert_allclose(got[:, lo].numpy(), [0.1, 0.2])


def _quat(rng, n):
  q = rng.normal(size=(n, 4)).astype(np.float32)
  return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _vec(rng, n):
  return rng.normal(size=(n, 3)).astype(np.float32)


def _mat(rng, n):
  return np.asarray(jgm.quat_to_mat(jnp.asarray(_quat(rng, n))))


# op name -> argument makers (each takes (rng, n) -> numpy array)
MATH_CASES = {
    'quat_normalize': (lambda r, n: r.normal(size=(n, 4)).astype(np.float32),),
    'quat_mul': (_quat, _quat),
    'quat_conj': (_quat,),
    'quat_inv': (_quat,),
    'quat_rotate': (_quat, _vec),
    'quat_rotate_inv': (_quat, _vec),
    'quat_to_mat': (_quat,),
    'mat_to_quat': (_mat,),
    'euler_to_quat': (_vec,),
    'quat_tangent': (_quat, _vec),
    'quat_sub': (_quat, _quat),
    'mat_to_euler': (_mat,),
    'skew': (_vec,),
    'transform_point': (_vec, _quat, _vec),
    'transform_inv_point': (_vec, _quat, _vec),
}


@pytest.mark.parametrize('op', sorted(MATH_CASES))
def test_math_op_matches_jax(op):
  rng = np.random.RandomState(sorted(MATH_CASES).index(op))
  args = [make(rng, 64) for make in MATH_CASES[op]]
  ref = np.asarray(getattr(jgm, op)(*[jnp.asarray(a) for a in args]))
  got = getattr(tgm, op)(*[torch.as_tensor(a) for a in args]).numpy()
  np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


def test_math_broadcast_and_integrate():
  rng = np.random.RandomState(1)
  q, w = _quat(rng, 12), _vec(rng, 12)
  ref = np.asarray(jgm.quat_integrate(jnp.asarray(q), jnp.asarray(w), 0.002))
  got = tgm.quat_integrate(torch.as_tensor(q).reshape(3, 4, 4),
                           torch.as_tensor(w).reshape(3, 4, 3),
                           torch.tensor(0.002)).reshape(12, 4).numpy()
  np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
  n_ref, u_ref = jgm.norm_safe(jnp.asarray(w))
  n_got, u_got = tgm.norm_safe(torch.as_tensor(w))
  np.testing.assert_allclose(n_got.numpy(), np.asarray(n_ref), rtol=RTOL)
  np.testing.assert_allclose(u_got.numpy(), np.asarray(u_ref), rtol=RTOL,
                             atol=ATOL)
  args = (_vec(rng, 5), _quat(rng, 5), _vec(rng, 5), _quat(rng, 5))
  refs = jgm.transform_compose(*[jnp.asarray(x) for x in args])
  gots = tgm.transform_compose(*[torch.as_tensor(x) for x in args])
  for got, ref in zip(gots, refs):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)


_IMPORT_RE = re.compile(
    r'^\s*(?:import|from)\s+(jax|flax|optax|geeco_tpu)\b', re.MULTILINE)


def test_port_sources_import_no_jax():
  root = os.path.join(REPO_ROOT, 'geeco_tpu_torch')
  offenders = []
  for dirpath, _, files in os.walk(root):
    for fn in files:
      if fn.endswith('.py'):
        path = os.path.join(dirpath, fn)
        with open(path) as f:
          if _IMPORT_RE.search(f.read()):
            offenders.append(os.path.relpath(path, REPO_ROOT))
  assert not offenders, offenders
  card_files = [os.path.join('tests', fn)
                for fn in sorted(os.listdir(os.path.join(REPO_ROOT, 'tests')))
                if fn.startswith('test_torch_card_') and fn.endswith('.py')]
  assert card_files
  for path in ['kernel_probe.py'] + card_files:
    with open(os.path.join(REPO_ROOT, path)) as f:
      assert not _IMPORT_RE.search(f.read()), path


def test_port_import_leaves_jax_out_of_sys_modules():
  code = ('import sys; import geeco_tpu_torch.envs.base; '
          'import geeco_tpu_torch.render.raster_kernel; '
          'import geeco_tpu_torch.utils.build; '
          'import geeco_tpu_torch.models.train; '
          'import geeco_tpu_torch.models.closed_loop; '
          'import geeco_tpu_torch.models.predictor; '
          'import geeco_tpu_torch.data.episode; '
          'import geeco_tpu_torch.run.sim; '
          'import geeco_tpu_torch.run.train_e2evmc; '
          'import geeco_tpu_torch.run.viewer; '
          'import geeco_tpu_torch.data.videos; '
          'import geeco_tpu_torch.render.viewer; '
          'bad = [m for m in sys.modules if m.split(".")[0] in '
          '("jax", "flax", "optax", "geeco_tpu")]; print(bad); '
          'sys.exit(1 if bad else 0)')
  env = dict(os.environ)
  env['PYTHONPATH'] = REPO_ROOT
  proc = subprocess.run([sys.executable, '-c', code], cwd=REPO_ROOT, env=env,
                        capture_output=True, text=True, timeout=120)
  assert proc.returncode == 0, proc.stdout + proc.stderr


def test_model_to_device_keeps_statics(models):
  _, _, tm, _ = models
  moved = tm.to('cpu')
  assert moved.col_pairs == tm.col_pairs and moved._consts == {}
  t = moved.const('x', np.arange(3, dtype=np.int32))
  assert t.dtype == torch.int64 and moved.const('x', None) is t
