from benchmark.program_trace import span_ms


def read(run):
  return span_ms(run, 'closed_loop.policy', 'stream')
