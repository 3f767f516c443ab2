"""The port's command-line workflow on the CPU (``--device cpu``), at a small
size, held against the JAX package's CLIs and loaders.

The chain: collect (frame mode and state only, from the same seed) ->
dataset_tools create_splits -> train_e2evmc 2 steps + eval -> resume 1 step
-> the predictor -> the batched controller on the test split; also the
single-env controller, replay, random and dry-run modes.  The envs are
pad2-cube2 at 64x64 with 2 substeps of 8 solver iterations and one settle
step (``GeecoEnv`` reduced through the CLIs' module attribute); the model's
config is written before the first train call (the trainer's
load-if-exists precedence), 64 px, encoders 20 wide, float32.

Checked: every file the JAX CLIs write, with their names, CSV headers and
delimiter (the triage CSV byte for byte as the JAX writer makes it from the
same rows); the state-only dataset re-rendered through
``render_from_qpos`` equals the frame-mode recording bit for bit, and the
eval step sees the same metrics on both; the resume continues step count
and Adam state; the predictor serves the trainer's weights; the JAX loaders
and the JAX trainer read a port-collected dataset, and the port's trainer
reads a dataset written by the JAX package's ``save_episode_npz``.
"""

import csv
import functools
import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from geeco_tpu.data import dataset as JD
from geeco_tpu.data import episode as JE
from geeco_tpu.models.params import create_e2evmc_config as jconfig
from geeco_tpu.models.params import save_model_config as jsave_config
from geeco_tpu.run import sim as jsim
from geeco_tpu.run import train_e2evmc as jtrain
from geeco_tpu_torch.data import dataset as TD
from geeco_tpu_torch.data import episode as TE
from geeco_tpu_torch.envs import base as EB
from geeco_tpu_torch.models import train as TT
from geeco_tpu_torch.models.params import (create_e2evmc_config,
                                           save_model_config)
from geeco_tpu_torch.models.predictor import GoalE2EVMCPredictor
from geeco_tpu_torch.run import (dataset_tools, gym_pickplace, gym_pushing,
                                 sim, train_e2evmc)

torch.set_num_threads(1)

SMALL = dict(n_substeps=2, settle_steps=1, solver_iterations=8)
RES = ['--frame_res', '64', '64']
N_EPS, N_ENVS, STEPS = 12, 4, 6
BATCH = 2                       # episodes per train batch
DEV = ['--device', 'cpu', '--seed', '0']
MODEL = dict(img_height=64, img_width=64, proc_obs='dynimg',
             proc_tgt='dyndiff', dim_s_obs=20, dim_s_dyn=20, dim_s_diff=20,
             dim_h_lstm=16, dim_h_fc=16, compute_dtype='float32',
             loss_weighting='cmd_mag', start_boost=6.0, lr=2e-4)
TRAIN = ['--split_name', 'balanced', '--goal_condition', 'target',
         '--aug_shift', '2', '--chunk_windows', '4', '--episodes_per_batch',
         str(BATCH), '--num_epochs', '1', '--max_steps_per_epoch', '2',
         '--log_steps', '1']


def _collect(wrk, fmt, extra=()):
  return gym_pickplace.main(gym_pickplace.parse(DEV + RES + [
      '--wrk_dir', wrk, '--sim_mode', 'collect', '--dataset_formats', fmt,
      '--num_envs', str(N_ENVS), '--end_idx', str(N_EPS),
      '--max_episode_steps', str(STEPS), *extra]))


def _rows(path):
  with open(path, newline='') as f:
    rows = list(csv.reader(f, delimiter=';'))
  return rows[0], rows[1:]


@pytest.fixture(scope='module')
def chain(tmp_path_factory):
  root = str(tmp_path_factory.mktemp('cli'))
  with pytest.MonkeyPatch.context() as mp:
    mp.setattr(sim, 'GeecoEnv', functools.partial(EB.GeecoEnv, **SMALL))
    mp.setattr(EB, 'make_env', functools.partial(EB.make_env, **SMALL))
    out = {'root': root}
    out['frames'] = _collect(os.path.join(root, 'frames'), 'all')
    out['states'] = _collect(os.path.join(root, 'states'), 'states',
                             ['--rendering_mode', 'none'])
    fds = os.path.join(root, 'frames', 'collect')
    sds = os.path.join(root, 'states', 'collect')
    dataset_tools.main(dataset_tools.parse(
        ['create_splits', '--dataset_dir', sds, '--split_name', 'balanced']))
    # the same split for the frame dataset (same episode names)
    shutil.copytree(os.path.join(sds, 'splits'), os.path.join(fds, 'splits'))
    model_dir = os.path.join(root, 'model')
    os.makedirs(model_dir)
    save_model_config(create_e2evmc_config(MODEL),
                      os.path.join(model_dir, 'e2evmc_config.json'))
    targs = DEV + TRAIN + ['--dataset_dir', sds, '--model_dir', model_dir]
    ts1 = train_e2evmc.main(train_e2evmc.parse(targs))
    p0 = next(ts1.model.parameters())
    out['m1'] = {k: v.clone() for k, v in ts1.optimizer.state[p0].items()}
    out['ts1_step'] = ts1.step
    out['ts2'] = train_e2evmc.main(train_e2evmc.parse(
        targs + ['--max_total_steps', '3']))
    out['rows'] = gym_pickplace.main(gym_pickplace.parse(DEV + RES + [
        '--wrk_dir', os.path.join(root, 'ctrl'), '--sim_mode', 'controller',
        '--goal_condition', 'target', '--model_dir', model_dir,
        '--dataset_dir', sds, '--split_name', 'balanced', '--num_envs',
        str(N_ENVS), '--max_episode_steps', '3']))
    # the single-env controller, conditioned on an extracted target frame
    dataset_tools.main(dataset_tools.parse(
        ['extract_keyframes', '--dataset_dir', fds]))
    with open(os.path.join(root, 'list.txt'), 'w') as f:
      f.write('replay_buffer_0001.tfrecord.zlib\n')
    out['single'] = gym_pickplace.main(gym_pickplace.parse(DEV + RES + [
        '--wrk_dir', os.path.join(root, 'single'), '--sim_mode',
        'controller', '--goal_condition', 'target', '--model_dir', model_dir,
        '--dataset_dir', fds, '--tfrecord_list',
        os.path.join(root, 'list.txt'), '--num_envs', '1', '--end_idx', '1',
        '--max_episode_steps', '2']))
    out['env'] = EB.make_env('pad2-cube2', frame_res=(64, 64),
                             device='cpu')
    out['env'].setup()
    yield out


def _ds(chain, kind):
  return os.path.join(chain['root'], kind, 'collect')


def _split(chain, mode):
  with open(os.path.join(_ds(chain, 'states'), 'splits', 'balanced',
                         f'{mode}.txt')) as f:
    return f.read().split()


def test_collect_writes_the_jax_layout(chain):
  for kind, exts in (('frames', ('.npz', '.json', '.tfrecord.zlib')),
                     ('states', ('.npz', '.json'))):
    ds = _ds(chain, kind)
    names = [f'replay_buffer_{i:04d}' for i in range(1, N_EPS + 1)]
    assert sorted(os.listdir(os.path.join(ds, 'data'))) == sorted(
        n + e for n in names for e in exts)
    pkls = sorted(f for f in os.listdir(ds) if f.endswith('.pkl'))
    assert pkls == ([n + '.pkl' for n in names] if kind == 'frames' else [])
    assert {'meta_info.json', 'meta', 'data', 'splits'} <= set(os.listdir(ds))
    assert any(f.endswith('-runcmd.json') for f in os.listdir(
        os.path.dirname(ds) + '/collect'))
    with open(os.path.join(ds, 'meta', 'meta_info.json')) as f:
      meta = json.load(f)
    assert meta['img_height'] == 64 and meta['renderer_kwargs'] == {}
    _, ctx = TE.load_episode(os.path.join(ds, 'data', names[0] + '.npz'))
    assert ctx['task_goal'] in ('goal0', 'goal1')
  assert 0.0 <= chain['frames'] <= 1.0      # the expert's success rate


def test_state_only_matches_frame_mode(chain):
  """The port's version of tests/test_episode_train.py::
  test_state_only_matches_frame_mode on collected data: the same seed gives
  the same episodes in both formats; the recorded states re-rendered equal
  the recorded frames bit for bit; the eval step sees the same metrics."""
  env = chain['env']
  for i in range(1, N_EPS + 1):
    name = f'replay_buffer_{i:04d}.npz'
    f, _ = TE.load_episode(os.path.join(_ds(chain, 'frames'), 'data', name))
    s, _ = TE.load_episode(os.path.join(_ds(chain, 'states'), 'data', name))
    for k in set(f) & set(s):
      np.testing.assert_array_equal(f[k], s[k], err_msg=f'{name} {k}')
    rgb, _ = env.render_from_qpos(
        torch.as_tensor(s['full_qpos']),
        torch.as_tensor(s['mocap_qpos-robot0:mocap']),
        torch.as_tensor(s['rgba'])[None].expand(STEPS, -1, -1))
    np.testing.assert_array_equal(rgb.numpy(), f['rgb'], err_msg=name)
  cfg = create_e2evmc_config(MODEL)
  init_fn, _, eval_f, _ = TT.make_episode_train_fns(
      cfg, True, chunk_windows=4, device='cpu')
  _, _, eval_s, _ = TT.make_episode_train_fns(
      cfg, True, chunk_windows=4, render_fn=env.render_from_qpos,
      device='cpu')
  ts = init_fn(torch.Generator().manual_seed(3), BATCH)
  kw = dict(batch_episodes=BATCH, window_size=cfg.window_size,
            fetch_target=True, shuffle=False)
  bf, bs = (next(iter(TD.episode_pipeline(_ds(chain, k), 'balanced',
                                          'train', **kw)))
            for k in ('frames', 'states'))
  mf = eval_f(ts, train_e2evmc.to_device(bf, 'cpu'))
  ms = eval_s(ts, train_e2evmc.to_device(bs, 'cpu'))
  for k in mf:
    assert float(ms[k]) == float(mf[k]), k


@pytest.mark.parametrize('kind', ['frames', 'states'])
def test_jax_loaders_read_port_dataset(chain, kind):
  ds = _ds(chain, kind)
  kw = dict(batch_episodes=BATCH, window_size=4, fetch_target=True,
            seed=1, with_depth=kind == 'frames', aug_shift=2)
  got = list(TD.episode_pipeline(ds, 'balanced', 'train', **kw))
  ref = list(JD.episode_pipeline(ds, 'balanced', 'train', **kw))
  assert len(got) == len(ref) >= 2
  for g, r in zip(got, ref):
    assert set(g) == set(r)
    for k in r:
      assert g[k].dtype == r[k].dtype, k
      np.testing.assert_array_equal(g[k], r[k], err_msg=k)
  for path in TD.list_records(ds):
    ep, ctx = JE.load_episode(path)
    assert ep['step'].dtype == np.int32 and ctx['shapes'] == 'pad2-cube2'


def test_jax_trainer_trains_on_port_dataset(chain, tmp_path):
  model_dir = str(tmp_path / 'jax_model')
  os.makedirs(model_dir)
  jsave_config(jconfig(dict(img_height=64, img_width=64, window_size=2,
                            dim_s_obs=8, dim_h_lstm=8, dim_h_fc=8,
                            compute_dtype='float32')),
               os.path.join(model_dir, 'e2evmc_config.json'))
  args = jtrain.ARGPARSER.parse_args([
      '--dataset_dir', _ds(chain, 'frames'), '--split_name', 'balanced',
      '--model_dir', model_dir, '--episodes_per_batch', str(BATCH),
      '--num_epochs', '1', '--max_steps_per_epoch', '1',
      '--log_steps', '1'])
  args._parser = jtrain.ARGPARSER
  ts = jtrain.main(args)
  assert int(ts.step) == 1
  with open(os.path.join(model_dir, 'metrics.jsonl')) as f:
    recs = [json.loads(l) for l in f]
  assert np.isfinite(recs[0]['loss'])


def test_port_trainer_reads_jax_written_dataset(chain, tmp_path):
  src, ds = _ds(chain, 'frames'), str(tmp_path / 'jax_ds')
  shutil.copytree(os.path.join(src, 'meta'), os.path.join(ds, 'meta'))
  shutil.copytree(os.path.join(src, 'splits'), os.path.join(ds, 'splits'))
  for path in TD.list_records(src):
    ep, ctx = TE.load_episode(path)
    JE.save_episode_npz(os.path.join(ds, 'data', os.path.basename(path)),
                        ep, ctx)
  model_dir = str(tmp_path / 'model')
  os.makedirs(model_dir)
  save_model_config(create_e2evmc_config(MODEL),
                    os.path.join(model_dir, 'e2evmc_config.json'))
  ts = train_e2evmc.main(train_e2evmc.parse(DEV + TRAIN + [
      '--dataset_dir', ds, '--model_dir', model_dir,
      '--max_total_steps', '1']))
  assert ts.step == 1
  assert os.path.isfile(os.path.join(model_dir, 'ckpt-00000001.pt'))


def test_window_mode_trains_on_frames(chain, tmp_path):
  model_dir = str(tmp_path / 'model')
  os.makedirs(model_dir)
  save_model_config(create_e2evmc_config(dict(MODEL, batch_size=4)),
                    os.path.join(model_dir, 'e2evmc_config.json'))
  ts = train_e2evmc.main(train_e2evmc.parse(DEV + TRAIN + [
      '--dataset_dir', _ds(chain, 'frames'), '--model_dir', model_dir,
      '--train_mode', 'window', '--max_total_steps', '2']))
  assert ts.step == 2
  with pytest.raises(SystemExit, match='episode'):
    train_e2evmc.main(train_e2evmc.parse(DEV + TRAIN + [
        '--dataset_dir', _ds(chain, 'states'), '--model_dir', model_dir,
        '--train_mode', 'window']))


def test_trainer_checkpoints_and_resume(chain):
  model_dir = os.path.join(chain['root'], 'model')
  files = set(os.listdir(model_dir))
  assert {'e2evmc_config.json', 'metrics.jsonl', 'ckpt-00000002.pt',
          'ckpt-00000003.pt', 'state-00000002.pt', 'state-00000003.pt',
          'snapshots'} <= files
  assert sum(f.endswith('-runcmd.json') for f in files) >= 1
  with open(os.path.join(model_dir, 'snapshots', 'snapshot_index.json')) as f:
    index = json.load(f)
  assert sorted(e['step'] for e in index) == [2, 3]
  for e in index:
    snap = os.path.join(model_dir, 'snapshots', f'snapshot-{e["step"]:08d}')
    assert {f'ckpt-{e["step"]:08d}.pt', 'e2evmc_config.json'} <= set(
        os.listdir(snap))
  with open(os.path.join(model_dir, 'metrics.jsonl')) as f:
    recs = [json.loads(l) for l in f]
  assert [(r['split'], r['step']) for r in recs] == [
      ('train', 1), ('train', 2), ('eval', 2), ('train', 3), ('eval', 3)]
  # the resumed run continued the step count and Adam's moments
  ts2, m1 = chain['ts2'], chain['m1']
  assert chain['ts1_step'] == 2 and ts2.step == 3
  m2 = ts2.optimizer.state[next(ts2.model.parameters())]
  assert float(m1['step']) == 2.0 and float(m2['step']) == 3.0
  g = (m2['exp_avg'] - 0.9 * m1['exp_avg']) / 0.1
  torch.testing.assert_close(m2['exp_avg_sq'],
                             0.999 * m1['exp_avg_sq'] + 0.001 * g * g,
                             rtol=1e-4, atol=1e-12)


def test_predictor_serves_the_trainer_weights(chain):
  pred = GoalE2EVMCPredictor(os.path.join(chain['root'], 'model'),
                             device='cpu')
  for (k, a), b in zip(pred.model.state_dict().items(),
                       chain['ts2'].model.state_dict().values()):
    assert torch.equal(a, b), k
  out = pred.predict(np.full((64, 64, 3), 0.5, np.float32), np.zeros(7))
  assert out['cmd_grp'][0] in (-1.0, 0.0, 1.0)


def test_controller_outputs_match_jax(chain, tmp_path):
  out_dir = os.path.join(chain['root'], 'ctrl', 'controller')
  rows = chain['rows']
  n_test = len(_split(chain, 'test'))
  assert len(rows) == n_test > 0
  header, body = _rows(os.path.join(out_dir, 'eval_results.csv'))
  assert tuple(header) == jsim.EVAL_FIELDS and len(body) == n_test
  assert [int(r[0]) for r in body] == list(range(1, n_test + 1))
  # the triage files byte for byte as the JAX writer makes them from the
  # same rows
  jsim._write_triage(str(tmp_path), rows)
  for name in ('triage_results.csv', 'triage_summary.txt'):
    with open(os.path.join(out_dir, name)) as a, \
        open(os.path.join(tmp_path, name)) as b:
      assert a.read() == b.read(), name
  with open(os.path.join(out_dir, 'final_results.txt')) as f:
    final = f.read()
  assert final == ''.join(
      f'{k}\t{np.mean([r[k] for r in rows]) * 100:.2f}\n'
      for k in ('obj_vicinity', 'grasp_success', 'task_success'))
  assert any(f.endswith('-runcmd.json') for f in os.listdir(out_dir))


def test_single_env_controller(chain):
  out_dir = os.path.join(chain['root'], 'single', 'controller')
  header, body = _rows(os.path.join(out_dir, 'eval_results.csv'))
  assert tuple(header) == jsim.EVAL_FIELDS and len(body) == 1
  assert len(chain['single']) == 1
  assert np.isfinite(chain['single'][0]['final_goal_dist'])
  assert os.path.isfile(os.path.join(out_dir, 'final_results.txt'))
  targets = os.path.join(_ds(chain, 'frames'), 'images', 'targets')
  assert sorted(os.listdir(os.path.join(targets, 'rgb')))[0] == \
      'replay_buffer_0001.png'


@pytest.mark.parametrize('ext', ['.pkl', '.npz'])
def test_replay_and_random_modes(chain, monkeypatch, tmp_path, ext):
  monkeypatch.setattr(sim, 'GeecoEnv', functools.partial(EB.GeecoEnv,
                                                         **SMALL))
  ds = _ds(chain, 'frames')
  rb = (os.path.join(ds, 'replay_buffer_0001.pkl') if ext == '.pkl'
        else os.path.join(ds, 'data', 'replay_buffer_0001.npz'))
  m = gym_pickplace.main(gym_pickplace.parse(DEV + RES + [
      '--wrk_dir', str(tmp_path), '--sim_mode', 'replay',
      '--replay_buffer', rb]))
  assert np.isfinite(m['goal_dist']).all()
  es = gym_pushing.main(gym_pushing.parse(DEV + RES + [
      '--wrk_dir', str(tmp_path), '--sim_mode', 'random',
      '--max_episode_steps', '2']))
  assert bool(torch.isfinite(es.phys.qpos).all())


def test_dry_run_writes_initial_frames(monkeypatch, tmp_path):
  monkeypatch.setattr(sim, 'GeecoEnv', functools.partial(EB.GeecoEnv,
                                                         **SMALL))
  gym_pickplace.main(gym_pickplace.parse(DEV + RES + [
      '--wrk_dir', str(tmp_path), '--sim_mode', 'collect', '--dry_run',
      '--num_envs', '2', '--end_idx', '2', '--perturb_prefix', '2',
      '--expert_noise', '0.1']))
  assert sorted(f for f in os.listdir(tmp_path / 'collect')
                if f.endswith('.png')) == ['init_0001.png', 'init_0002.png']


@pytest.mark.parametrize('flags', [
    ['--background_video', 'clip.mp4'], ['--rendering_mode', 'viewer'],
    ['--num_devices', '2']])
def test_unported_sim_options_raise(tmp_path, flags):
  with pytest.raises(NotImplementedError, match='item 1[78]'):
    gym_pickplace.main(gym_pickplace.parse(DEV + [
        '--wrk_dir', str(tmp_path)] + flags))


def test_unported_trainer_options_raise(tmp_path):
  with pytest.raises(NotImplementedError, match='item 18'):
    train_e2evmc.main(train_e2evmc.parse(DEV + [
        '--model_dir', str(tmp_path), '--num_devices', '2']))


def test_cli_entry_points_default_to_the_card(tmp_path):
  """No --device: the card, and without one the CLIs raise (never a silent
  CPU run)."""
  assert gym_pickplace.parse([]).device is None
  assert train_e2evmc.parse([]).device is None
  if torch.cuda.is_available():
    pytest.skip('a card is present: the default resolves to it')
  with pytest.raises(RuntimeError, match='CUDA'):
    gym_pickplace.main(gym_pickplace.parse([
        '--wrk_dir', str(tmp_path), '--sim_mode', 'random']))
  with pytest.raises(RuntimeError, match='CUDA'):
    train_e2evmc.main(train_e2evmc.parse([
        '--model_dir', str(tmp_path), '--dataset_dir', str(tmp_path)]))
