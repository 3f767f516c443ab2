from benchmark.readers import k1_roofline


def read(run):
  return k1_roofline(run)
