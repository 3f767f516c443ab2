from benchmark.program_trace import ratio_pct


def read(run):
  return ratio_pct(run, 'solver.graphed_iterations', 'solver.iterations')
