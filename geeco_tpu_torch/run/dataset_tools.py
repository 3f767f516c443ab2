"""Dataset tooling CLI: tasks / splits / keyframes / visualize.

Counterpart of ``geeco_tpu/run/dataset_tools.py``, the CLI port of the
reference's four Jupyter notebooks:

  python -m geeco_tpu_torch.run.dataset_tools create_tasks \
      --shapes pad2-cube2 --num_tasks 100 --out init-pad2-cube2.csv
  python -m geeco_tpu_torch.run.dataset_tools create_splits \
      --dataset_dir D --split_name balanced
  python -m geeco_tpu_torch.run.dataset_tools extract_keyframes \
      --dataset_dir D
  python -m geeco_tpu_torch.run.dataset_tools visualize --dataset_dir D \
      --split_name default --out batch.png
"""

from __future__ import annotations

import argparse
import time

ARGPARSER = argparse.ArgumentParser(description='GEECO dataset tools.')
ARGPARSER.add_argument('command', type=str,
                       help='create_tasks | create_splits | '
                            'extract_keyframes | visualize')
ARGPARSER.add_argument('--dataset_dir', type=str, default='')
ARGPARSER.add_argument('--shapes', type=str, default='pad2-cube2')
ARGPARSER.add_argument('--num_tasks', type=int, default=100)
ARGPARSER.add_argument('--out', type=str, default='')
ARGPARSER.add_argument('--split_name', type=str, default='default')
ARGPARSER.add_argument('--ratios', type=float, nargs=3, default=None)
ARGPARSER.add_argument('--seed', type=int, default=0)
ARGPARSER.add_argument('--batch_size', type=int, default=4)


def main(args):
  if args.command == 'create_tasks':
    from ..data.tasks import generate_tasks, write_task_csv
    header, rows = generate_tasks(args.shapes, args.num_tasks,
                                  seed=args.seed)
    out = args.out or f'init-{args.shapes}.csv'
    write_task_csv(out, header, rows)
    print(f'>>> wrote {len(rows)} task rows to {out}')
  elif args.command == 'create_splits':
    from ..data.splits import create_split
    out = create_split(args.dataset_dir, args.split_name,
                       ratios=tuple(args.ratios) if args.ratios else None,
                       seed=args.seed)
    print({k: len(v) for k, v in out.items()})
  elif args.command == 'extract_keyframes':
    from ..data.keyframes import extract_targets
    n = extract_targets(args.dataset_dir)
    print(f'>>> extracted targets/keyframes for {n} records')
  elif args.command == 'visualize':
    from ..data.dataset import input_pipeline
    from ..utils.plotting import visualize_batch
    t0 = time.time()
    batch = next(input_pipeline(args.dataset_dir, args.split_name, 'train',
                                batch_size=args.batch_size,
                                seed=args.seed))
    print('Fetched one batch of data in %.04f s' % (time.time() - t0))
    out = args.out or 'batch_visualization.png'
    visualize_batch(batch[0], out)
    print(f'>>> wrote {out}')
  else:
    raise ValueError(f'unknown command {args.command}')


def parse(argv=None) -> argparse.Namespace:
  """Parse ``argv`` (default: the command line) for ``main``."""
  return ARGPARSER.parse_known_args(argv)[0]


if __name__ == '__main__':
  main(parse())
