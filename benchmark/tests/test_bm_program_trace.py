"""The per-layer metrics that read the program's own tracer
(``program_trace.py``): a traced run on the CPU at ``test_bm_faults.py``'s
small size reports each of them on its cell, and names the device's idle
gaps by the program's spans."""

import pytest

from benchmark import program_trace, run
from benchmark.tests.test_bm_faults import CELLS, _run

PROGRAM_METRICS = {
    'pad2-cube2.collect-frames.b256': (
        'smooth_ms.env', 'collide_ms.env', 'constraints_ms.env',
        'solve_ms.env', 'syncs_per_step.env', 'active_rows.env'),
    'e2evmc-dyn.train-rerender.b8t99': (
        'rerender_ms.train', 'forward_ms.train', 'backward_ms.train',
        'update_ms.train', 'syncs_per_step.train'),
}


@pytest.mark.parametrize('workload', sorted(CELLS))
def test_a_traced_run_reports_the_programs_metrics(workload, capsys):
  line = _run(workload, trace=1)
  err = capsys.readouterr().err
  entries = {m['name']: m for m in run.load_manifest()['per_layer']}
  metrics = {k: v['value'] for k, v in line['metrics'].items()}
  for name in PROGRAM_METRICS[workload]:
    assert entries[name]['workloads'] == [workload]
    assert metrics[name] >= 0, name
  if workload.startswith('pad2-cube2'):
    assert 0 < metrics['active_rows.env'] <= 100
    assert metrics['syncs_per_step.env'] == 0      # the CPU has none
  assert line['correct']
  gaps = [l for l in err.splitlines() if l.startswith('# program gaps: ')]
  assert len(gaps) == 1
  named = gaps[0][len('# program gaps: '):].split('; idle by span: ')[0]
  assert any(name in named for name in program_trace.SPANS)


def test_idle_by_span_charges_each_gap_to_the_innermost_span():
  from benchmark.trace import Profile
  prof = Profile(launches=2, device=[('k', 0.0, 1.0), ('k', 5.0, 6.0)],
                 annotations=[('env.step', 0.5, 6.0),
                              ('physics.solve', 2.0, 4.0)],
                 window_s=7.0, steps=1)
  idle = program_trace.idle_by_span(prof)
  assert idle == pytest.approx({'env.step': 2.0, 'physics.solve': 2.0,
                                'outside any span': 1.0})


def test_a_program_without_the_tracer_gives_no_reading(monkeypatch):
  from geeco_tpu_torch.utils import profiling

  class Run:
    cell = None

  monkeypatch.delattr(profiling, 'enable')
  r = Run()
  assert program_trace.span_ms(r, 'physics.solve', 'host') is None
  assert program_trace.count_per_step(r, 'syncs') is None
  assert program_trace.ratio_pct(r, 'contact_rows.active',
                                 'contact_rows.iterated') is None
