"""Pick-and-place CLI: collect / replay / random / controller (PyTorch).

Flag-compatible counterpart of ``geeco_tpu/run/gym_pickplace.py`` and of
the reference script (scripts/gym_pickplace.py:49-131), plus --device
(default: the card).  Usage:
  python -m geeco_tpu_torch.run.gym_pickplace --sim_mode collect \\
      --rendering_mode tfrecord --shapes pad2-cube2 --end_idx 10
"""

from . import sim

ARGPARSER = sim.make_argparser(
    'Collect data for a pick-and-place task with a Fetch robot '
    '(GEECO, PyTorch).', wrk_dir='../logs/gym_pickplace',
    shapes='pad2-cube2',
    shapes_help='pad1-cube1 | pad2-cube1 | pad1-cube2 | pad2-cube2 | '
                'pad2-cube2-clutter4 | pad2-cube2-clutter12 | ball-cup | '
                'bridge-pad | diamond-pad | nut-cone')


def parse(argv=None):
  return sim.parse(ARGPARSER, argv)


def main(args):
  return sim.main(args)


if __name__ == '__main__':
  main(parse())
