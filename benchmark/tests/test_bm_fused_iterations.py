"""``fused_iterations.env``, the share of the contact solver's projected
iterations that the fused kernel ran (one launch a solve): a traced run of
the collect cell on the CPU at ``test_bm_faults.py``'s small size reports
it on that cell alone, and it reads 0 there, since the CPU runs the eager
loop."""

from benchmark import run
from benchmark.tests.test_bm_faults import _run

CELL = 'pad2-cube2.collect-frames.b256'


def test_a_traced_collect_run_reads_no_fused_iteration_on_the_cpu():
  line = _run(CELL, trace=1)
  entries = {m['name']: m for m in run.load_manifest()['per_layer']}
  assert entries['fused_iterations.env']['workloads'] == [CELL]
  assert line['metrics']['fused_iterations.env']['value'] == 0
  assert line['correct']
