from benchmark.program_trace import count_per_step


def read(run):
  return count_per_step(run, 'syncs')
