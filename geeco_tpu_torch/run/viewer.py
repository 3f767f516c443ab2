"""Interactive debug viewer: drive the Fetch arm from the keyboard.

Counterpart of ``geeco_tpu/run/viewer.py``, standing in for the
reference's mujoco-py GLFW viewer: frames come from the engine's own
rasterizer and are drawn into the terminal as ANSI truecolour half-blocks
(render/viewer.py), so the tool works over plain ssh next to the card.

Usage:
  python -m geeco_tpu_torch.run.viewer --shapes pad2-cube2
  python -m geeco_tpu_torch.run.viewer --keys "wwee gq"   # scripted

Keys:
  w/s  +x / -x        a/d  +y / -y        r/f  +z / -z
  g    close gripper  t    open gripper   space  hold still
  e    one scripted-expert action         x      re-reset (random)
  p    save frame PNG                     q      quit
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

ARGPARSER = argparse.ArgumentParser(
    description='Interactive terminal viewer for the GEECO env.')
ARGPARSER.add_argument('--shapes', type=str, default='pad2-cube2')
ARGPARSER.add_argument('--frame_res', type=int, nargs=2, default=[256, 256])
ARGPARSER.add_argument('--seed', type=int, default=0)
ARGPARSER.add_argument('--move', type=float, default=0.5,
                       help='action magnitude per keypress (action units, '
                            'scaled by 0.05 m in the env step)')
ARGPARSER.add_argument('--keys', type=str, default='',
                       help='scripted key sequence (disables TTY input; '
                            'for tests and demos)')
ARGPARSER.add_argument('--out_dir', type=str, default='.',
                       help='directory for p-key PNG snapshots')
ARGPARSER.add_argument('--n_substeps', type=int, default=20)
ARGPARSER.add_argument('--solver_iterations', type=int, default=60)
ARGPARSER.add_argument('--settle_steps', type=int, default=10)
ARGPARSER.add_argument('--fps', type=float, default=25.0)
ARGPARSER.add_argument('--device', type=str, default=None,
                       help='torch device (default: the card, cuda)')

_KEY_ACTIONS = {
    'w': (1, 0, 0, 0), 's': (-1, 0, 0, 0),
    'a': (0, 1, 0, 0), 'd': (0, -1, 0, 0),
    'r': (0, 0, 1, 0), 'f': (0, 0, -1, 0),
    'g': (0, 0, 0, -1), 't': (0, 0, 0, 1),
    ' ': (0, 0, 0, 0),
}


def main(args) -> int:
  """Run the viewer; returns the control steps taken since the last
  reset."""
  from ..envs.base import GeecoEnv
  from ..expert.policies import init_expert_state, make_expert
  from ..render.viewer import TerminalViewer, read_key

  env = GeecoEnv(shapes=args.shapes, frame_res=tuple(args.frame_res),
                 n_substeps=args.n_substeps,
                 solver_iterations=args.solver_iterations,
                 settle_steps=getattr(args, 'settle_steps', 10),
                 device=getattr(args, 'device', None))
  env.setup()
  expert = make_expert(env)
  gen = torch.Generator().manual_seed(args.seed)
  es = env.reset_random(1, gen)
  xs = init_expert_state(1, env.device)

  scripted = list(args.keys) if args.keys else None
  viewer = TerminalViewer(fps=args.fps if scripted is None else 0.0)
  t = 0
  snaps = 0
  try:
    while True:
      rgb, _ = env.render(es)
      rgb = rgb[0].cpu().numpy()
      m = {k: float(v[0]) for k, v in env.eval_metrics(es).items()}
      hud = (f'[{args.shapes}] t={t:4d}  goal_dist={m["goal_dist"]:.4f}  '
             f'grasp={int(m["grasp_success"])}  '
             f'success={int(m["task_success"])}  '
             '(wasd/rf move, g/t grip, e expert, x reset, p png, q quit)')
      viewer.feed(rgb, hud)
      if scripted is not None:
        key = scripted.pop(0) if scripted else 'q'
      else:
        key = read_key()
        if key is None:
          key = 'q'    # no TTY: nothing to read, exit cleanly
      if key == 'q':
        break
      if key == 'x':
        es = env.reset_random(1, gen)
        xs = init_expert_state(1, env.device)
        t = 0
        continue
      if key == 'p':
        from PIL import Image
        os.makedirs(args.out_dir, exist_ok=True)
        path = os.path.join(args.out_dir, f'viewer_{snaps:03d}.png')
        Image.fromarray(rgb).save(path)
        snaps += 1
        continue
      if key == 'e':
        action, xs = expert(es, xs)
      elif key in _KEY_ACTIONS:
        a = _KEY_ACTIONS[key]
        # the gripper command channel is {-1, 0, 1}, not scaled
        action = torch.tensor([[args.move * a[0], args.move * a[1],
                                args.move * a[2], float(a[3])]],
                              device=env.device)
      else:
        continue
      es = env.step(es, action)
      t += 1
  finally:
    viewer.close()
  return t


if __name__ == '__main__':
  cli_args, _ = ARGPARSER.parse_known_args()
  sys.exit(0 if main(cli_args) >= 0 else 1)
