"""Pushing CLI: collect / replay / random / controller (PyTorch).

Flag-compatible counterpart of ``geeco_tpu/run/gym_pushing.py`` and of the
reference script (scripts/gym_pushing.py), plus --device (default: the
card).  Usage:
  python -m geeco_tpu_torch.run.gym_pushing --sim_mode collect \\
      --rendering_mode tfrecord --shapes push-pad2-cube2 --end_idx 10
"""

from . import sim

ARGPARSER = sim.make_argparser(
    'Collect data for a pushing task with a Fetch robot (GEECO, PyTorch).',
    wrk_dir='../logs/gym_pushing', shapes='push-pad2-cube2',
    shapes_help='push-pad1-cube1 | push-pad1-cube2 | push-pad2-cube1 | '
                'push-pad2-cube2')


def parse(argv=None):
  return sim.parse(ARGPARSER, argv)


def main(args):
  return sim.main(args)


if __name__ == '__main__':
  main(parse())
