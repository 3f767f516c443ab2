"""A run on the CPU at a small size (the look for a card skipped), whole
and with its timed path broken underneath: ``correct`` comes out true, and
false for each fault the cell can have."""

import json

import pytest

from benchmark import run

SMALL_ENV = {'env': {'frame_res': [32, 32], 'n_substeps': 2,
                     'solver_iterations': 4, 'settle_steps': 1}}
CELLS = {
    'pad2-cube2.collect-frames.b256': (
        SMALL_ENV, {'batch': 4, 'warmup_steps': 1}),
    'e2evmc-dyn.train-rerender.b8t99': (
        dict(SMALL_ENV, model={'img_height': 32, 'img_width': 32}),
        {'episodes': 2, 'steps': 6, 'render_chunk': 4, 'chunk_windows': 2}),
}
FAULTS = {
    'pad2-cube2.collect-frames.b256': ('frozen', 'half', 'altered'),
    'e2evmc-dyn.train-rerender.b8t99': ('frozen', 'half'),
}
KEYS = ['correct', 'attempted', 'failed', 'metrics', 'device']


def _run(workload, trace=0, fault=None, seed=2 ** 31 + 11):
  config, traffic = CELLS[workload]
  return run.main(['--workload', workload, '--seed', str(seed),
                   '--seconds', '0.2', '--trace', str(trace)],
                  device='cpu', config_overrides=config,
                  traffic_overrides=traffic, fault=fault)


@pytest.mark.parametrize('workload', sorted(CELLS))
def test_a_whole_run_is_correct_and_prints_the_contracts_line(
    workload, capsys):
  result = _run(workload)
  out = capsys.readouterr()
  line = json.loads(out.out.strip().splitlines()[-1])
  assert line == result
  assert list(line)[:5] == KEYS and list(line)[-1] == 'checks'
  assert line['correct'] and line['failed'] == 0 and line['attempted'] > 0
  manifest = run.load_manifest()
  want = {m['name'] for m in run.metrics_of(manifest, 'end_to_end',
                                            workload)}
  assert set(line['metrics']) == want
  # the numbers compared end stderr, each beside its limit
  tail = out.err.strip().splitlines()[-len(line['checks']):]
  assert [t.split(':')[0] for t in tail] == [
      f'check {n}' for n in line['checks']]


@pytest.mark.parametrize('workload', sorted(CELLS))
def test_a_traced_run_reports_per_layer_metrics_and_a_breakdown(workload):
  line = _run(workload, trace=1)
  manifest = run.load_manifest()
  per_layer = {m['name'] for m in run.metrics_of(manifest, 'per_layer',
                                                 workload)}
  assert line['metrics'] and set(line['metrics']) <= per_layer
  assert {'busy_s', 'window_s'} <= set(line['device'])
  assert set(line['breakdown']) == {'device_ops', 'idle_gaps'}
  assert line['correct']


@pytest.mark.parametrize('workload,fault', [
    (w, f) for w in sorted(FAULTS) for f in FAULTS[w]])
def test_a_broken_timed_path_is_not_correct(workload, fault):
  line = _run(workload, fault=fault)
  assert not line['correct'] and line['failed'] >= 1


def reset_gaps(env_kwargs, batch, seeds, device):
  """The stage the collect cell's comparison skips, by itself: the
  program's reset (placement, then ``settle_steps`` control steps) against
  the reference's from the same draws; a seed's per-env largest qpos gaps,
  for each seed."""
  import torch
  from benchmark.ref.envs.base import GeecoEnv as RefEnv
  from geeco_tpu_torch.envs.base import GeecoEnv
  envs = [make(**env_kwargs, device=device) for make in (GeecoEnv, RefEnv)]
  out = []
  for seed in seeds:
    prog, ref = (env.reset_random(batch, torch.Generator().manual_seed(seed))
                 for env in envs)
    assert bool((prog.rgba == ref.rgba).all())
    assert bool((prog.task_goal == ref.task_goal).all())
    assert bool((prog.task_object == ref.task_object).all())
    out.append((prog.phys.qpos - ref.phys.qpos).abs().amax(-1))
  return out


def test_the_reset_the_window_starts_from_matches_the_reference():
  workload = 'pad2-cube2.collect-frames.b256'
  _, config, traffic = run.load_cell(run.load_manifest(), workload)
  config = run._merge(config, SMALL_ENV)
  for gaps in reset_gaps(config['env'], 4, [2 ** 31 + 5], 'cpu'):
    assert float(gaps.quantile(0.75)) <= traffic['limits']['state_gap']
