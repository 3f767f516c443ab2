"""``graphed_substeps.env``, the share of the physics substeps that ran as
the replay of their chain of CUDA graphs: a traced run of the collect cell
on the CPU at ``test_bm_faults.py``'s small size reports it on that cell
alone, and it reads 0 there, since the CPU runs the eager substep."""

from benchmark import run
from benchmark.tests.test_bm_faults import _run

CELL = 'pad2-cube2.collect-frames.b256'


def test_a_traced_collect_run_reads_no_graphed_substep_on_the_cpu():
  line = _run(CELL, trace=1)
  entries = {m['name']: m for m in run.load_manifest()['per_layer']}
  assert entries['graphed_substeps.env']['workloads'] == [CELL]
  assert line['metrics']['graphed_substeps.env']['value'] == 0
  assert line['correct']
