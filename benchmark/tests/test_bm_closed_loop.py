"""The closed-loop cell on the CPU at a small size (the look for a card
skipped): a whole run is correct with every number at 0, a traced run
reports the cell's per-layer metrics, the policy encodes B windows a step,
and each fault of the timed path puts a number over its limit."""

import json
import os

import pytest

from benchmark import program_trace, run
from benchmark.kinds import closed_loop
from benchmark.tests.test_bm_faults import SMALL_ENV

WORKLOAD = 'e2evmc-dyn.closed-loop.b64'
B = 2
CONFIG = dict(SMALL_ENV, model={'img_height': 32, 'img_width': 32})
TRAFFIC = {'batch': B, 'warmup_steps': 1}
METRICS = ('policy_ms.loop', 'physics_ms.loop', 'mfu.loop')


def _run(trace=0, fault=None, seed=2 ** 31 + 11):
  return run.main(['--workload', WORKLOAD, '--seed', str(seed),
                   '--seconds', '0.2', '--trace', str(trace)],
                  device='cpu', config_overrides=CONFIG,
                  traffic_overrides=TRAFFIC, fault=fault)


def test_a_whole_run_is_correct_with_every_number_at_0(capsys):
  result = _run()
  out = capsys.readouterr()
  line = json.loads(out.out.strip().splitlines()[-1])
  assert line == result
  assert list(line)[:5] == ['correct', 'attempted', 'failed', 'metrics',
                            'device'] and list(line)[-1] == 'checks'
  assert line['correct'] and line['failed'] == 0
  assert line['attempted'] > 0 and line['attempted'] % B == 0
  assert set(line['metrics']) == {'env_steps_per_s', 'setup_s'}
  assert set(line['checks']) == {'cmd_gap', 'logit_gap', 'frame_mismatch',
                                 'state_gap', 'buffer_gap', 'goal_mismatch'}
  assert all(c['value'] == 0 for c in line['checks'].values())


def test_a_traced_run_reports_the_cells_per_layer_metrics():
  line = _run(trace=1)
  entries = {m['name']: m for m in run.load_manifest()['per_layer']}
  for name in METRICS:
    assert entries[name]['workloads'] == [WORKLOAD]
    assert line['metrics'][name]['value'] > 0, name
  assert line['metrics']['mfu.loop']['value'] < 100
  assert line['correct']


def test_the_policy_encodes_b_windows_a_step():
  import torch
  _, config, traffic = run.load_cell(run.load_manifest(), WORKLOAD)
  cell = closed_loop.build(run._merge(config, CONFIG),
                           run._merge(traffic, TRAFFIC), 5,
                           torch.device('cpu'), False)
  cell.setup()

  class Run:
    step_s = float('nan')       # no traced window: the log line's only

  r = Run()
  r.cell = cell
  assert program_trace.count_per_step(r, 'policy.windows') == B
  spans = r.program_trace['snapshot']['spans']
  assert spans['closed_loop.policy']['calls'] == traffic['profile_steps']
  assert spans['closed_loop.policy']['counters'] == {'policy.windows': B}


@pytest.mark.parametrize('fault', closed_loop.FAULTS)
def test_a_broken_timed_path_puts_a_number_over_its_limit(fault):
  line = _run(fault=fault)
  assert not line['correct'] and line['failed'] >= 1
  over = [n for n, c in line['checks'].items() if c['value'] > c['limit']]
  assert over == {'frozen': ['state_gap'], 'half': ['state_gap'],
                  'stale': ['buffer_gap'],
                  'lagged': ['cmd_gap', 'logit_gap'],
                  'goal': ['goal_mismatch']}[fault]


def test_the_count_takes_the_scenes_shapes_and_this_envs_steps():
  _, config, _ = run.load_cell(run.load_manifest(), WORKLOAD)
  shapes = closed_loop.control_step_shapes(config)
  assert shapes == {'nv': 39, 'contact_rows': 128, 'ngrp': 6,
                    'joint_limits': 9, 'welds': 1, 'iterations': 60,
                    'substeps': 20}
  small = run._merge(config, CONFIG)
  assert closed_loop.control_step_shapes(small)['substeps'] == 2
  with pytest.raises(ValueError):
    closed_loop.control_step_shapes(
        run._merge(config, {'env': {'contact_select_k': 64}}))


def test_the_cells_configuration_is_the_trained_model_and_the_scene():
  manifest = run.load_manifest()
  _, config, _ = run.load_cell(manifest, WORKLOAD)
  files = {c['name']: c['file'] for c in manifest['configs']}
  with open(os.path.join(run.ROOT, files['e2evmc-dyn'])) as f:
    trained = json.load(f)
  with open(os.path.join(run.ROOT, files['pad2-cube2'])) as f:
    scene = json.load(f)
  assert config['model'] == trained['model']
  assert config['env'] == scene['env']
  assert config['shapes'] == scene['shapes']
  assert config['reduced'] == []
