from benchmark.readers import launches_per_step


def read(run):
  return launches_per_step(run)
