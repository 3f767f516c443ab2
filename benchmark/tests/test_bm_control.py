"""On the card: the control (the plain reference computed with TF32 on, in
the program's place) fails a limit of each cell on three seeds, and the
program passes them, at a size a test run holds.  Run with
``python3 -m pytest benchmark/tests -m card``."""

import pytest

from benchmark import control, run

SIZES = {
    'pad2-cube2.collect-frames.b256': ({}, {'batch': 32}),
    'e2evmc-dyn.train-rerender.b8t99': (
        {}, {'episodes': 2, 'steps': 40, 'render_chunk': 40}),
}


@pytest.mark.card
@pytest.mark.parametrize('workload', sorted(SIZES))
def test_the_control_fails_a_limit_and_the_program_passes(card, workload):
  config, traffic = SIZES[workload]
  limits = run.load_cell(run.load_manifest(), workload)[2]['limits']
  lines = control.main(['--workload', workload, '--seeds', '101,102,103',
                        '--seconds', '1', '--control'],
                       config_overrides=config, traffic_overrides=traffic)
  assert len(lines) == 3
  for line in lines:
    assert all(line['program'][k] <= lim for k, lim in limits.items()), line
    assert any(line['control'][k] > lim for k, lim in limits.items()), line


@pytest.mark.card
def test_the_reset_matches_the_reference_at_production_settings(card):
  from benchmark.tests.test_bm_faults import reset_gaps
  workload = 'pad2-cube2.collect-frames.b256'
  _, config, traffic = run.load_cell(run.load_manifest(), workload)
  for gaps in reset_gaps(config['env'], 16, (201, 202, 203), card):
    assert float(gaps.quantile(0.75)) <= traffic['limits']['state_gap']
