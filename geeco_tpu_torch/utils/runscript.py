"""Run-command logging for reproducibility.

Parity with the reference save_run_command (src/utils/runscript.py:13-30):
dumps parsed + unparsed argv into a timestamped ``<ts>-runcmd.json`` in the
run directory.  The port's own copy of ``geeco_tpu/utils/runscript.py``;
``argv`` names the arguments of a programmatic call (default: the command
line).
"""

from __future__ import annotations

import datetime
import json
import os
import sys


def save_run_command(argparser, run_dir: str, argv=None) -> str:
  args, unparsed = argparser.parse_known_args(argv)
  ts = datetime.datetime.now().strftime('%Y%m%d-%H%M%S')
  path = os.path.join(run_dir, f'{ts}-runcmd.json')
  os.makedirs(run_dir, exist_ok=True)
  payload = {
      'argv': sys.argv if argv is None else list(argv),
      'parsed_args': {k: _jsonable(v) for k, v in vars(args).items()},
      'unparsed_args': list(unparsed),
  }
  with open(path, 'w') as fp:
    json.dump(payload, fp, indent=2, sort_keys=True)
  return path


def _jsonable(v):
  try:
    json.dumps(v)
    return v
  except TypeError:
    return str(v)
