from benchmark.readers import idle_share


def read(run):
  return idle_share(run)
