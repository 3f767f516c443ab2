"""The port's command-line workflow on the card through the CLIs'
``main(args)``, at full width (256x256, the flagship model at the bench
point) and small depth (every test skips without a card).

Frames: a frame-mode collect of ``CLI_FRAME_ENVS`` episodes, one K1
launch a recorded step, the npz, pickle and TFRecord of every episode.
The chain: a state-only collect of ``CLI_ENVS`` episodes (one chunk), the
balanced split, 2 train steps and an eval pass, a third step resumed from
``state-*.pt`` (the step count and Adam's moments continue), the predictor
restored from the checkpoint (weights equal bit for bit, its predictions
against the trainer model's forward), the batched controller on the test
split (the CSVs' rows).  Every CLI call holds the first K1 launch of each
batch size against the twin and runs every projected iteration in K2's
'psd' form, with the eager loop's summation orders (the CLIs build
rolling-row envs whose method is 'psd'; ``solver._solve_rows``).  The CPU's chain at a small
size is ``tests/test_torch_cli.py``.

tests/conftest.py imports JAX, which the card lacks, so there the file
runs without it::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_card_cli.py

This file imports no JAX.
"""

import csv
import os

import numpy as np
import torch

from geeco_tpu_torch.data.episode import load_episode
from geeco_tpu_torch.physics import solver_pallas as SP
from geeco_tpu_torch.render import raster_kernel as rk
from geeco_tpu_torch.utils import profiling
from test_torch_card_kernels import card, checked_k1  # noqa: F401 (fixture)
from test_torch_card_paths import BF16_REL

# frame-mode collection of CLI_FRAME_ENVS episodes; state-only collection
# of one chunk of CLI_ENVS (its balanced split, 20/9/11 from seed 0, leaves
# 2 train batches and an eval batch), CLI_STEPS recorded steps each (cut
# from 100); the trainer at the bench point on CLI_BATCH episodes a batch;
# the batched controller on the test split, CLI_CTRL_ENVS envs,
# CLI_CL_STEPS control steps (cut from 200)
CLI_FRAME_ENVS, CLI_ENVS, CLI_STEPS = 8, 40, 10
CLI_BATCH, CLI_CTRL_ENVS, CLI_CL_STEPS = 8, 16, 5


def _run(cli, argv, solves=True):
  """One CLI call on the card; (its result, its K1 launches), each batch
  size's first launch held against the twin.  Every projected iteration
  runs in K2's 'psd' form (``solver.fused_iterations`` counts them all;
  a CLI that collects or controls (``solves``) runs some), and K2's
  wrapper is only ever called in that form, with the eager loop's orders
  (never the TPU kernel's)."""
  rk.raster_tiles.launches = 0
  real, orders = SP.psd_solve, []

  def recording(*args, **kwargs):
    orders.append(kwargs.get('orders'))
    return real(*args, **kwargs)

  # the wrapper counts its calls under the module's name
  recording.launches = real.launches
  SP.psd_solve = recording
  profiling.reset()
  profiling.enable(syncs=False)
  try:
    with checked_k1(first_of_each_size=True):
      res = cli.main(cli.parse(argv + ['--device', 'cuda', '--seed', '0']))
    counters = profiling.snapshot()['counters']
  finally:
    profiling.disable()
    profiling.reset()
    SP.psd_solve = real
    real.launches = recording.launches
  torch.cuda.synchronize()
  iterations = counters.get('solver.iterations', 0)
  assert counters.get('solver.fused_iterations', 0) == iterations
  assert iterations > 0 or not solves
  assert all(o is not None for o in orders), orders
  return res, rk.raster_tiles.launches


def _rows(path):
  """(header, rows) of a ';'-delimited CSV."""
  with open(path, newline='') as f:
    rows = list(csv.reader(f, delimiter=';'))
  return rows[0], rows[1:]


def test_frame_collection(card, tmp_path):
  from geeco_tpu_torch.run import gym_pickplace
  _, launches = _run(gym_pickplace, [
      '--wrk_dir', str(tmp_path), '--sim_mode', 'collect',
      '--dataset_formats', 'all', '--num_envs', str(CLI_FRAME_ENVS),
      '--end_idx', str(CLI_FRAME_ENVS),
      '--max_episode_steps', str(CLI_STEPS)])
  assert launches == CLI_STEPS          # one a recorded step
  coll = tmp_path / 'collect'
  for i in range(1, CLI_FRAME_ENVS + 1):
    name = f'replay_buffer_{i:04d}'
    for f in (f'data/{name}.npz', f'data/{name}.json',
              f'data/{name}.tfrecord.zlib', f'{name}.pkl'):
      assert (coll / f).is_file(), f
  ep, ctx = load_episode(str(coll / 'data' / 'replay_buffer_0001.npz'))
  tf, tctx = load_episode(str(coll / 'data' /
                              'replay_buffer_0001.tfrecord.zlib'))
  assert ep['rgb'].shape == (CLI_STEPS, 256, 256, 3)
  assert ep['rgb'].dtype == np.uint8 and ep['step'].dtype == np.int32
  assert ep['depth'].dtype == np.float32
  assert all(np.array_equal(tf[k], ep[k]) for k in ('rgb', 'step', 'cmd'))
  assert ctx['renderer_kwargs'] == tctx['renderer_kwargs'] == {}
  assert ctx['shapes'] == 'pad2-cube2'


def test_the_state_only_chain(card, tmp_path, monkeypatch):
  from geeco_tpu_torch.models import closed_loop as CL
  from geeco_tpu_torch.models import snapshots
  from geeco_tpu_torch.models import train as TT
  from geeco_tpu_torch.models.params import load_model_config
  from geeco_tpu_torch.models.predictor import GoalE2EVMCPredictor
  from geeco_tpu_torch.run import (dataset_tools, gym_pickplace, sim,
                                   train_e2evmc)
  # ---- collect, state only: the training set
  _, launches = _run(gym_pickplace, [
      '--wrk_dir', str(tmp_path), '--sim_mode', 'collect',
      '--dataset_formats', 'states', '--rendering_mode', 'none',
      '--num_envs', str(CLI_ENVS), '--end_idx', str(CLI_ENVS),
      '--max_episode_steps', str(CLI_STEPS)])
  assert launches == 0, 'state-only collection rendered'
  ds = str(tmp_path / 'collect')
  ep, _ = load_episode(os.path.join(ds, 'data',
                                    f'replay_buffer_{CLI_ENVS:04d}.npz'))
  assert 'rgb' not in ep and ep['full_qpos'].shape[0] == CLI_STEPS
  assert ep['rgba'].dtype == np.float32
  # ---- split
  dataset_tools.main(dataset_tools.parse(
      ['create_splits', '--dataset_dir', ds, '--split_name', 'balanced']))
  split = {}
  for m in ('train', 'eval', 'test'):
    with open(os.path.join(ds, 'splits', 'balanced', f'{m}.txt')) as f:
      split[m] = f.read().split()
  assert len(split['train']) >= 2 * CLI_BATCH, split
  assert len(split['eval']) >= CLI_BATCH and len(split['test']) > 0, split
  # ---- train at the bench point, 2 steps and an eval pass
  model_dir = str(tmp_path / 'model')
  targs = [
      '--dataset_dir', ds, '--split_name', 'balanced', '--model_dir',
      model_dir, '--goal_condition', 'target', '--proc_obs', 'dynimg',
      '--proc_tgt', 'dyndiff', '--loss_weighting', 'cmd_mag',
      '--start_boost', '6', '--lr', '2e-4', '--aug_shift', '10',
      '--chunk_windows', '8', '--episodes_per_batch', str(CLI_BATCH),
      '--num_epochs', '1', '--max_steps_per_epoch', '2', '--log_steps', '1']
  ts1, launches = _run(train_e2evmc, targs, solves=False)
  n_eval = min(2, len(split['eval']) // CLI_BATCH)
  # one render of the B*T <= 100 frames and one of the goals, a step
  assert ts1.step == 2 and launches == 2 * (2 + n_eval)
  for f in ('e2evmc_config.json', 'metrics.jsonl', 'ckpt-00000002.pt',
            'state-00000002.pt', 'snapshots/snapshot_index.json',
            'snapshots/snapshot-00000002/ckpt-00000002.pt',
            'snapshots/snapshot-00000002/e2evmc_config.json'):
    assert os.path.isfile(os.path.join(model_dir, f)), f
  # ---- resume from state-00000002.pt for one more step
  p0 = next(ts1.model.parameters())
  m1 = {k: v.clone() for k, v in ts1.optimizer.state[p0].items()}
  cfg = load_model_config(os.path.join(model_dir, 'e2evmc_config.json'))
  saved = snapshots.restore_train_state(
      os.path.join(model_dir, 'state-00000002.pt'),
      TT.make_episode_train_fns(cfg, True, device='cuda')[0]())
  assert all(torch.equal(a, b) for a, b in zip(
      saved.model.state_dict().values(), ts1.model.state_dict().values()))
  m_saved = saved.optimizer.state[next(saved.model.parameters())]
  assert torch.equal(m_saved['exp_avg'], m1['exp_avg'])
  assert torch.equal(m_saved['exp_avg_sq'], m1['exp_avg_sq'])
  assert m_saved['exp_avg'].device == p0.device
  del saved, m_saved
  ts2, _ = _run(train_e2evmc, targs + ['--max_total_steps', '3'],
                solves=False)
  m2 = ts2.optimizer.state[next(ts2.model.parameters())]
  assert ts2.step == 3 and float(m2['step']) == 3.0
  # Adam's moments continued: m2 = b1 m1 + (1 - b1) g and
  # v2 = b2 v1 + (1 - b2) g^2 for the one gradient g of step 3
  g = (m2['exp_avg'] - 0.9 * m1['exp_avg']) / 0.1
  v_want = 0.999 * m1['exp_avg_sq'] + 0.001 * g * g
  assert float((m2['exp_avg_sq'] - v_want).norm() /
               m2['exp_avg_sq'].norm()) <= 1e-3
  # ---- restore the checkpoint into the predictor
  pred = GoalE2EVMCPredictor(model_dir, device='cuda')
  assert all(torch.equal(a, b) for a, b in zip(
      pred.model.state_dict().values(), ts2.model.state_dict().values()))
  K, S = pred.cfg.window_size, pred.cfg.img_height
  rng = np.random.RandomState(0)
  frames = rng.rand(K, S, S, 3).astype(np.float32)
  jnt = rng.randn(K, 7).astype(np.float32)
  tgt = rng.rand(S, S, 3).astype(np.float32)
  pred.set_goal(tgt)
  for k in range(K):
    res = pred.predict(frames[k], jnt[k])
  as_t = lambda a: torch.as_tensor(a, device='cuda')[None]
  with torch.no_grad():
    ref, _ = ts2.model(as_t(frames), as_t(jnt), as_t(tgt), None, True)
  for k, h in (('cmd_ee', 'pred_cmd_ee'), ('pos_ee', 'pred_aux_ee'),
               ('pos_obj', 'pred_aux_obj')):
    rel = (np.abs(res[k] - ref[h][0].float().cpu().numpy()).max() /
           max(float(ref[h].abs().max()), 1e-12))
    assert rel <= BF16_REL, (k, rel)
  del pred, ts1, ts2
  # ---- the batched controller on the test split; K1's launches before
  # its closed loop (the goal frames) read at the loop's start
  goal_launches = []
  evaluate = CL.evaluate_batched

  def evaluate_batched(*a, **k):
    goal_launches.append(rk.raster_tiles.launches)
    return evaluate(*a, **k)
  monkeypatch.setattr(CL, 'evaluate_batched', evaluate_batched)
  ctrl_dir = str(tmp_path / 'controller')
  n_test = len(split['test'])
  _, launches = _run(gym_pickplace, [
      '--wrk_dir', ctrl_dir, '--sim_mode', 'controller',
      '--goal_condition', 'target', '--model_dir', model_dir,
      '--dataset_dir', ds, '--split_name', 'balanced',
      '--num_envs', str(CLI_CTRL_ENVS), '--max_episode_steps',
      str(CLI_CL_STEPS)])
  chunks = -(-n_test // CLI_CTRL_ENVS)
  assert goal_launches[0] == -(-n_test // 64)
  assert launches - goal_launches[0] == chunks * CLI_CL_STEPS
  out_dir = os.path.join(ctrl_dir, 'controller')
  header, rows = _rows(os.path.join(out_dir, 'eval_results.csv'))
  assert tuple(header) == sim.EVAL_FIELDS and len(rows) == n_test
  header, rows = _rows(os.path.join(out_dir, 'triage_results.csv'))
  assert tuple(header) == sim.TRIAGE_FIELDS and len(rows) == n_test
  with open(os.path.join(out_dir, 'final_results.txt')) as f:
    final = f.read().split('\n')
  assert [l.split('\t')[0] for l in final if l] == \
      ['obj_vicinity', 'grasp_success', 'task_success']
  assert os.path.isfile(os.path.join(out_dir, 'triage_summary.txt'))
