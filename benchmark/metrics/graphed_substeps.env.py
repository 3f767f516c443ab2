from benchmark.program_trace import ratio_pct


def read(run):
  return ratio_pct(run, 'physics.graphed_substeps', 'physics.substeps')
