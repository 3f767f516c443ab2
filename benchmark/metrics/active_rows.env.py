from benchmark.program_trace import ratio_pct


def read(run):
  return ratio_pct(run, 'contact_rows.active', 'contact_rows.iterated')
