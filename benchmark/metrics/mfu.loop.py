from benchmark.readers import mfu


def read(run):
  return mfu(run)
