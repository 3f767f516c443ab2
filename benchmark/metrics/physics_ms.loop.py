from benchmark.readers import span_ms


def read(run):
  return span_ms(run, 'physics')
