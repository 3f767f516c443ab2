"""Dataset split creation: task-stratified shuffle splits.

The port's own copy of ``geeco_tpu/data/splits.py`` (numpy), the CLI/library
port of the reference notebook ``dataset-create_splits.ipynb``
(SURVEY.md §2.19): records are grouped by task (goal+object string), each
group shuffle-split by the named ratio, and the result written as
  splits/<name>/{train,eval,test}.txt  (+ aligned init-*.csv when the meta
init CSV is available).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Tuple

import numpy as np

SPLIT_RATIOS = {
    'default': (0.8, 0.1, 0.1),
    'balanced': (0.5, 0.25, 0.25),
    'fasttest': (0.0, 0.0, 1.0),
    'debug': (0.34, 0.33, 0.33),
}


def record_task(dataset_dir: str, record_path: str) -> str:
  ctx_path = record_path.replace('.npz', '.json')
  with open(ctx_path) as fp:
    ctx = json.load(fp)
  return f"{ctx.get('task_goal', '?')}::{ctx.get('task_object', '?')}"


def create_split(dataset_dir: str, split_name: str = 'default',
                 ratios: Tuple[float, float, float] = None,
                 seed: int = 0) -> Dict[str, List[str]]:
  """Stratified split over task groups; writes splits/<name>/*.txt."""
  from .dataset import list_records
  ratios = ratios or SPLIT_RATIOS.get(split_name, SPLIT_RATIOS['default'])
  assert abs(sum(ratios) - 1.0) < 1e-6
  paths = list_records(dataset_dir)
  groups: Dict[str, List[str]] = {}
  for p in paths:
    groups.setdefault(record_task(dataset_dir, p), []).append(p)

  rng = np.random.RandomState(seed)
  out = {'train': [], 'eval': [], 'test': []}
  for task in sorted(groups):
    names = sorted(os.path.basename(p) for p in groups[task])
    rng.shuffle(names)
    n = len(names)
    n_train = int(round(ratios[0] * n))
    n_eval = int(round(ratios[1] * n))
    out['train'] += names[:n_train]
    out['eval'] += names[n_train:n_train + n_eval]
    out['test'] += names[n_train + n_eval:]

  split_dir = os.path.join(dataset_dir, 'splits', split_name)
  os.makedirs(split_dir, exist_ok=True)
  for mode, names in out.items():
    with open(os.path.join(split_dir, f'{mode}.txt'), 'w') as fp:
      fp.write('\n'.join(names) + ('\n' if names else ''))
  return out
