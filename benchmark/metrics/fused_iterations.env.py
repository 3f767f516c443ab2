from benchmark.program_trace import ratio_pct


def read(run):
  return ratio_pct(run, 'solver.fused_iterations', 'solver.iterations')
