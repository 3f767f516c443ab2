"""Port parity of the bench (geeco_tpu_torch/bench.py against the root
bench.py, which times the JAX package): the env's kwargs, batch sizes and
config note from the same BENCH_* variables, the trainer's batch bit for
bit, the JSON line; then the port's bench on the CPU at a small size, and
its failures.

The root bench is reached through monkeypatch (its GeecoEnv, _bench_one,
make_episode_train_fns and jax.jit), so no JAX physics or model compiles.
"""

import importlib.util
import json
import os
import signal
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geeco_tpu_torch import bench as TB

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_VARS = ('BENCH_NUM_ENVS', 'BENCH_SWEEP', 'BENCH_STEPS',
              'BENCH_SOLVER_ITERS', 'BENCH_SOLVER_METHOD', 'BENCH_SELECT_K',
              'BENCH_COLLIDE_EVERY', 'BENCH_SUBSTEP_UNROLL',
              'BENCH_MASS_INVERSE', 'BENCH_SOLVER_UNROLL', 'BENCH_RK',
              'BENCH_SCAN', 'BENCH_TRAIN', 'BENCH_TRAIN_B', 'BENCH_TRAIN_T',
              'BENCH_BUDGET_S')
JSON_KEYS = {'metric', 'value', 'unit', 'vs_baseline', 'train_steps_per_sec'}
# the one word of the metric that differs: the port ends its timed regions
# in torch.cuda.synchronize(), the JAX file in a forced host readback
JAX_TIMING = 'forced-readback timing'

# the port's bench at a small size on the CPU: 2 envs, 2 timed steps, 64x64
# frames, light physics, a narrow float32 model, one timed train step
SMALL = dict(
    frame_res=(64, 64),
    env_overrides=dict(n_substeps=2, settle_steps=1, solver_iterations=8),
    train_config=TB.bench_config(dict(
        img_height=64, img_width=64, dim_s_obs=20, dim_s_dyn=20,
        dim_s_diff=20, dim_h_lstm=16, dim_h_fc=16, compute_dtype='float32')),
    train_iters=1)
SMALL_ENV = {'BENCH_NUM_ENVS': '2', 'BENCH_STEPS': '2', 'BENCH_TRAIN_B': '2',
             'BENCH_TRAIN_T': '5'}


@pytest.fixture
def root_bench(monkeypatch):
  """The root bench.py as a fresh module, BENCH_* cleared, its signal
  handlers and alarm undone afterwards."""
  for var in BENCH_VARS:
    monkeypatch.delenv(var, raising=False)
  spec = importlib.util.spec_from_file_location(
      'root_bench', os.path.join(REPO_ROOT, 'bench.py'))
  mod = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(mod)
  handlers = {s: signal.getsignal(s) for s in (signal.SIGTERM,
                                               signal.SIGALRM)}
  yield mod
  signal.alarm(0)
  for s, h in handlers.items():
    signal.signal(s, h)


@pytest.fixture
def clean_environ(monkeypatch):
  for var in BENCH_VARS:
    monkeypatch.delenv(var, raising=False)
  return monkeypatch


@pytest.mark.parametrize('environ', [
    {},
    {'BENCH_RK': ''},
    {'BENCH_COLLIDE_EVERY': '1', 'BENCH_RK': '512,192',
     'BENCH_NUM_ENVS': '64'},
    {'BENCH_SOLVER_ITERS': '30', 'BENCH_SOLVER_METHOD': 'cg',
     'BENCH_SELECT_K': '96', 'BENCH_MASS_INVERSE': 'blockgj',
     'BENCH_SUBSTEP_UNROLL': '2', 'BENCH_SOLVER_UNROLL': '4'},
    {'BENCH_SWEEP': '64,128', 'BENCH_STEPS': '3', 'BENCH_SCAN': '1'},
], ids=['defaults', 'no-caps', 'production-b64', 'solver-knobs', 'sweep'])
def test_env_kwargs_match_root_bench(root_bench, monkeypatch, capsys,
                                     environ):
  """The root bench.main() builds its GeecoEnv with the port's kwargs, times
  the port's batch sizes and steps, and notes the port's config."""
  made, timed = [], []

  class FakeEnv:
    def __init__(self, **kwargs):
      made.append(kwargs)

    def setup(self):
      return None

  def fake_bench_one(env, num_envs, n_iters, scan=False):
    timed.append((num_envs, n_iters, scan))
    return float(num_envs)

  from geeco_tpu.envs import base as jbase
  monkeypatch.setattr(jbase, 'GeecoEnv', FakeEnv)
  monkeypatch.setattr(root_bench, '_bench_one', fake_bench_one)
  for k, v in {**environ, 'BENCH_TRAIN': '0'}.items():
    monkeypatch.setenv(k, v)
  root_bench.main()

  kwargs, sweep, n_iters, note = TB.env_kwargs(dict(os.environ))
  assert made == [kwargs]
  scan = environ.get('BENCH_SCAN') == '1'
  assert timed == [(b, n_iters, scan) for b in sweep]
  assert root_bench._CONFIG_NOTE == note
  results = TB.Results(note)
  results.rates = {b: float(b) for b in sweep}
  line = capsys.readouterr().out.strip()
  assert json.loads(results.line()) == _as_port(json.loads(line))


def _as_port(jax_line: dict) -> dict:
  return {**jax_line,
          'metric': jax_line['metric'].replace(JAX_TIMING, TB.TIMING)}


@pytest.mark.parametrize('note', ['', '; cut short by signal 15'])
@pytest.mark.parametrize('train', [0.6543219, None])
def test_json_line_matches_root_emit(root_bench, monkeypatch, capsys, note,
                                     train):
  rates = {256: 1234.56789, 64: 987.654321}
  config_note = 'ce=1 binning 512/192, fidelity-gated'
  monkeypatch.setattr(root_bench, '_RESULTS', dict(rates))
  monkeypatch.setattr(root_bench, '_TRAIN_STEPS', train)
  monkeypatch.setattr(root_bench, '_CONFIG_NOTE', config_note)
  monkeypatch.setattr(root_bench, '_EMITTED', False)
  assert root_bench._emit(note)
  jax_line = json.loads(capsys.readouterr().out)
  results = TB.Results(config_note)
  results.rates, results.train_steps = dict(rates), train
  assert results.emit(note) and results.emit(note)   # printed once only
  out = capsys.readouterr().out
  assert out.count('\n') == 1
  assert json.loads(out) == _as_port(jax_line)
  assert ('truncated' in jax_line) == bool(note)


def test_train_batch_matches_root_bench(root_bench, monkeypatch):
  """The port's train_batch is the batch the root bench's train half feeds
  its train step, bit for bit (index arrays widened to int64), from the
  same config."""
  rng = np.random.RandomState(7)
  nq, ngeom = 23, 9
  q0 = rng.randn(nq).astype(np.float32)
  mocap_pos = rng.randn(1, 3).astype(np.float32)
  mocap_quat = rng.randn(1, 4).astype(np.float32)
  rgba0 = rng.rand(ngeom, 4).astype(np.float32)
  jax_env = types.SimpleNamespace(
      rgba0=rgba0, render_from_qpos=None,
      setup=lambda: types.SimpleNamespace(
          qpos=jnp.asarray(q0), mocap_pos=jnp.asarray(mocap_pos),
          mocap_quat=jnp.asarray(mocap_quat)))
  port_env = types.SimpleNamespace(
      rgba0=rgba0,
      setup=lambda: types.SimpleNamespace(
          qpos=torch.as_tensor(q0)[None],
          mocap_pos=torch.as_tensor(mocap_pos)[None],
          mocap_quat=torch.as_tensor(mocap_quat)[None]))
  seen = {}

  def fake_fns(config, goal_conditioned, chunk_windows, render_fn, aug_pad):
    seen.update(config=config, goal=goal_conditioned, chunk=chunk_windows,
                aug_pad=aug_pad)

    def train_step(ts, batch):
      seen['batch'] = batch
      return ts, {'loss': jnp.zeros(())}
    return (lambda key, bs: None), train_step, None, None

  from geeco_tpu.models import train as JT
  monkeypatch.setattr(JT, 'make_episode_train_fns', fake_fns)
  monkeypatch.setattr(jax, 'jit', lambda f, **kw: f)
  B, T = 3, 11
  monkeypatch.setenv('BENCH_TRAIN_B', str(B))
  monkeypatch.setenv('BENCH_TRAIN_T', str(T))
  root_bench._bench_train_steps(jax_env, n_iters=1)

  config = TB.bench_config()
  assert seen['config'].asdict() == config.asdict()
  assert (seen['goal'], seen['chunk'], seen['aug_pad']) == (True, 8, 10)
  ref = seen['batch']
  got = TB.train_batch(port_env, B, T, 'cpu', config)
  assert list(got) == list(ref)
  for k, v in ref.items():
    v = np.asarray(v)
    g = got[k].numpy()
    assert g.shape == v.shape, k
    if v.dtype == np.int32:
      assert g.dtype == np.int64, k
    else:
      assert g.dtype == v.dtype, k
    np.testing.assert_array_equal(g, v, err_msg=k)


def test_bench_runs_both_halves_on_cpu(clean_environ, capsys):
  for k, v in SMALL_ENV.items():
    clean_environ.setenv(k, v)
  handlers = {s: signal.getsignal(s) for s in (signal.SIGTERM,
                                               signal.SIGALRM)}
  TB.main(['--device', 'cpu'], **SMALL)
  assert {s: signal.getsignal(s) for s in handlers} == handlers
  assert signal.alarm(0) == 0
  captured = capsys.readouterr()
  lines = captured.out.strip().splitlines()
  assert len(lines) == 1
  out = json.loads(lines[0])
  assert set(out) == JSON_KEYS
  assert out['unit'] == 'env_steps/sec/chip'
  assert out['value'] > 0 and out['train_steps_per_sec'] > 0
  assert out['vs_baseline'] == round(out['value'] / 1e6, 6)
  assert 'B=2 of [2]; 2 substeps + 64x64 render' in out['metric']
  err = captured.err.strip().splitlines()
  assert all(line.startswith('# ') for line in err), err
  assert err[0] == '# device: cpu'
  assert any('render paths {"hierarchical": 2}' in line for line in err)
  assert any(line.startswith('# train: ') and 'steps/s' in line
             for line in err)


def test_bench_scan_marks_its_metric_on_cpu(clean_environ, capsys):
  """BENCH_SCAN=1 runs the plain loop with each frame summed, and its
  metric says it is not the JAX file's scan."""
  for k, v in {**SMALL_ENV, 'BENCH_SCAN': '1', 'BENCH_TRAIN': '0'}.items():
    clean_environ.setenv(k, v)
  TB.main(['--device', 'cpu'], **SMALL)
  out = json.loads(capsys.readouterr().out)
  assert set(out) == JSON_KEYS - {'train_steps_per_sec'}
  assert out['value'] > 0
  assert f'2 substeps + 64x64 render{TB.SCAN_NOTE} per step' in out['metric']


def test_train_launches_per_step():
  """ceil(B*T/100) frame renders and one of the goal frames: 9 at the
  bench point (B=8, T=99), and a whole last chunk adds none."""
  assert TB.train_launches(8, 99) == 9
  assert TB.train_launches(2, 50) == 2
  assert TB.train_launches(2, 51) == 3


@pytest.mark.parametrize('half', ['bench_env', 'bench_train'])
def test_a_failing_half_fails_the_run(clean_environ, capsys, half):
  """No failure is swallowed: the exception ends the run, no JSON line."""
  for k, v in SMALL_ENV.items():
    clean_environ.setenv(k, v)

  def boom(*args, **kwargs):
    raise RuntimeError(f'{half} failed')

  clean_environ.setattr(TB, half, boom)
  with pytest.raises(RuntimeError, match=f'{half} failed'):
    TB.main(['--device', 'cpu'], **SMALL)
  assert '{' not in capsys.readouterr().out
  assert signal.alarm(0) == 0


_SIGNAL_CHILD = """
import os, signal, sys, time
from geeco_tpu_torch import bench as TB
from tests.test_torch_bench import SMALL
def stop(*args, **kwargs):
  os.kill(os.getpid(), signal.SIGTERM)
  time.sleep(60)
setattr(TB, sys.argv[1], stop)
TB.main(['--device', 'cpu'], **SMALL)
"""


@pytest.mark.parametrize('half', ['bench_env', 'bench_train'])
def test_sigterm_prints_the_best_so_far(half):
  """SIGTERM (or the budget's alarm) prints what was measured, marked
  truncated, and exits 0; with nothing measured it exits 124, silent."""
  env = {k: v for k, v in os.environ.items() if not k.startswith('BENCH_')}
  env.update(SMALL_ENV, PYTHONPATH=REPO_ROOT)
  proc = subprocess.run([sys.executable, '-c', _SIGNAL_CHILD, half],
                        cwd=REPO_ROOT, env=env, capture_output=True,
                        text=True, timeout=300)
  if half == 'bench_env':
    assert proc.returncode == 124, proc.stderr
    assert proc.stdout == ''
    return
  assert proc.returncode == 0, proc.stderr
  out = json.loads(proc.stdout)
  assert out['truncated'] is True and 'train_steps_per_sec' not in out
  assert out['metric'].endswith(f'; cut short by signal {signal.SIGTERM})')
  assert out['value'] > 0


def test_without_a_card_the_bench_raises():
  if torch.cuda.is_available():
    pytest.skip('this machine has a CUDA device')
  env = {k: v for k, v in os.environ.items() if not k.startswith('BENCH_')}
  env['PYTHONPATH'] = REPO_ROOT
  proc = subprocess.run([sys.executable, '-m', 'geeco_tpu_torch.bench'],
                        cwd=REPO_ROOT, env=env, capture_output=True,
                        text=True, timeout=120)
  assert proc.returncode != 0
  assert proc.stdout == ''
  assert 'CUDA is not available' in proc.stderr
