"""Dataset input pipeline: episode archives -> (feature, label) windows.

Behavioral parity with the reference tf.data pipeline
``pickplace_input_fn_v4`` (reference: src/data/geeco_gym.py:401-474):
  parse -> stack state vectors (_preprocess_states_v4, :317-371)
        -> roll(-1) command targets, drop last frame (_preprocess_targets_v3,
           :598-613)
        -> sliding windows of K frames (_window_v3, :615-631)
        -> (feature, label) tuples (_prepare_v4, :373-399)
        -> shuffle, batch, prefetch.

The port's own copy of ``geeco_tpu/data/dataset.py``: host-side numpy,
batches stay numpy arrays (the trainer CLI moves them to the device, with
``widx`` as int64: ``models/train.py::make_episode_train_fns``).

Expected directory layout (identical to the reference):
  <dataset_dir>/meta/meta_info.json
  <dataset_dir>/data/replay_buffer_*.npz (+ .json context sidecars)
  <dataset_dir>/splits/<split_name>/{train,eval,test}.txt
  <dataset_dir>/images/targets/{rgb/*.png, depth/*.npy}
"""

from __future__ import annotations

import json
import os
from typing import Dict, Iterator, List, Optional

import numpy as np

from .episode import _RECORD_EXTS, load_episode

ARM_JOINTS = (
    'robot0:shoulder_pan_joint', 'robot0:shoulder_lift_joint',
    'robot0:upperarm_roll_joint', 'robot0:elbow_flex_joint',
    'robot0:forearm_roll_joint', 'robot0:wrist_flex_joint',
    'robot0:wrist_roll_joint')
FINGER_JOINTS = ('robot0:l_gripper_finger_joint',
                 'robot0:r_gripper_finger_joint')


def get_meta(dataset_dir: str) -> Dict:
  with open(os.path.join(dataset_dir, 'meta', 'meta_info.json')) as fp:
    return json.load(fp)


def list_records(dataset_dir: str, split_name: Optional[str] = None,
                 mode: Optional[str] = None) -> List[str]:
  """Record paths, optionally filtered by a split file."""
  data_dir = os.path.join(dataset_dir, 'data')
  if split_name and mode:
    split_file = os.path.join(dataset_dir, 'splits', split_name,
                              f'{mode}.txt')
    with open(split_file) as fp:
      names = [l.strip() for l in fp if l.strip()]
    return [_record_path(data_dir, n) for n in names]
  paths = sorted(
      os.path.join(data_dir, f) for f in os.listdir(data_dir)
      if f.endswith('.npz'))
  if not paths:  # reference-collected dataset: .tfrecord[.zlib] only
    paths = sorted(
        os.path.join(data_dir, f) for f in os.listdir(data_dir)
        if f.endswith(('.tfrecord', '.tfrecord.zlib')))
  return paths


def _record_path(data_dir: str, record_name: str) -> str:
  """Resolve a split entry to an existing record file: npz first (the
  JAX package's storage), else the reference's .tfrecord[.zlib] format."""
  base = os.path.basename(record_name).split('.')[0]
  for ext in _RECORD_EXTS:
    p = os.path.join(data_dir, base + ext)
    if os.path.exists(p):
      return p
  return os.path.join(data_dir, base + '.npz')  # original error surface


# -------------------------------------------------------------- transforms


def preprocess_states(ep: Dict) -> Dict:
  """Stack per-joint scalars into state vectors (_preprocess_states_v4)."""
  out = {
      'step': ep['step'].astype(np.int64),
      'ts': ep['ts'].astype(np.float32),
      'cmd': ep['cmd'].astype(np.float32),
      'ctrl': ep['ctrl'].astype(np.float32),
      'ee_state': ep['mocap_qpos-robot0:mocap'].astype(np.float32),
      'goal_state': ep['goal_qpos'].astype(np.float32),
      'obj_state': ep['obj_qpos'].astype(np.float32),
  }
  if 'rgb' in ep:
    rgb = ep['rgb']
    out['rgb'] = (rgb.astype(np.float32) / 255.0
                  if rgb.dtype == np.uint8 else rgb.astype(np.float32))
    if 'depth' in ep:  # RGB-only recordings carry no depth channel
      out['depth'] = ep['depth'].astype(np.float32)[..., None] \
          if ep['depth'].ndim == 3 else ep['depth'].astype(np.float32)
  out['jnt_state'] = np.stack(
      [ep[f'joint_qpos-{j}'] for j in ARM_JOINTS], axis=1).astype(np.float32)
  out['vel_state'] = np.stack(
      [ep[f'joint_qvel-{j}'] for j in ARM_JOINTS], axis=1).astype(np.float32)
  out['grp_state'] = np.stack(
      [ep[f'joint_qpos-{j}'] for j in FINGER_JOINTS],
      axis=1).astype(np.float32)
  return out


def preprocess_targets(ex: Dict) -> Dict:
  """roll(-1) next-frame targets, drop last frame (_preprocess_targets_v3)."""
  ex = dict(ex)
  ex['vel_target'] = np.roll(ex['vel_state'], -1, axis=0)
  ex['ee_target'] = np.roll(ex['ee_state'], -1, axis=0)
  ex['grp_target'] = np.roll(ex['grp_state'], -1, axis=0)
  for k in list(ex.keys()):
    if k not in ('target_rgb', 'target_depth'):
      ex[k] = ex[k][:-1]
  return ex


def window_indices(T: int, window_size: int, pad_start: bool = True):
  """Window index matrix [N, K] into a length-T episode.

  pad_start prepends K-1 windows whose indices are clamped to 0 — the
  exact first-frame padding the serving ring buffer uses for the first
  control steps (predictor.py:192-200).  The reference trains WITHOUT
  these (_window_v3, geeco_gym.py:615-631), which leaves the serving
  start state out-of-distribution: a policy that learned "static window
  => zero action" from post-completion idle tails emits ~zero on the
  static padded start window, never moves, and deadlocks at 0% success.
  Padded start windows carry the (large) initial expert actions as
  labels, so the goal-difference features disambiguate start from goal.
  """
  n_win = T - window_size + 1
  idx = np.arange(n_win)[:, None] + np.arange(window_size)[None, :]
  if pad_start:
    pad = np.maximum(
        np.arange(-(window_size - 1), 0)[:, None] +
        np.arange(window_size)[None, :], 0)
    idx = np.concatenate([pad, idx], axis=0)
  return idx


def make_windows(ex: Dict, window_size: int = 4,
                 pad_start: bool = True) -> Dict:
  """Sliding windows (_window_v3 + start padding): [T] -> [N, K, ...]."""
  T = ex['step'].shape[0]
  idx = window_indices(T, window_size, pad_start)
  n_win = idx.shape[0]
  out = {}
  for k, v in ex.items():
    if k in ('target_rgb', 'target_depth'):
      out[k] = np.broadcast_to(v, (n_win,) + v.shape)
    else:
      out[k] = v[idx]
  return out


def prepare(win: Dict, fetch_target: bool = False):
  """(feature, label) tuples (_prepare_v4)."""
  feature_keys = ('step', 'ts', 'jnt_state', 'vel_state', 'ee_state',
                  'grp_state', 'goal_state', 'obj_state', 'cmd', 'ctrl')
  feature = {k: win[k] for k in feature_keys if k in win}
  for k in ('rgb', 'depth'):
    if k in win:
      feature[k] = win[k]
  if fetch_target:
    feature['target_rgb'] = win['target_rgb']
    if 'target_depth' in win:
      feature['target_depth'] = win['target_depth']
  label = {
      'cmd': win['cmd'][:, -1],
      'ctrl': win['ctrl'][:, -1],
      'vel_target': win['vel_target'][:, -1],
      'ee_target': win['ee_target'][:, -1],
      'grp_target': win['grp_target'][:, -1],
  }
  return feature, label


def episode_windows(path: str, window_size: int = 4,
                    fetch_target: bool = False):
  """Full per-episode transform chain -> (features, labels) window arrays."""
  ep, _ = load_episode(path)
  ex = preprocess_states(ep)
  if fetch_target:
    # target frame = last frame of the episode (_parse_v4 fetch_target)
    if 'rgb' in ex:
      ex['target_rgb'] = ex['rgb'][-1]
      if 'depth' in ex:
        ex['target_depth'] = ex['depth'][-1]
  ex = preprocess_targets(ex)
  win = make_windows(ex, window_size)
  return prepare(win, fetch_target)


# ------------------------------------------------------ episode batches


def episode_pipeline(dataset_dir: str, split_name: str, mode: str,
                     batch_episodes: int = 8, window_size: int = 4,
                     fetch_target: bool = False, num_epochs: int = 1,
                     shuffle: bool = True, seed: Optional[int] = None,
                     with_depth: bool = False,
                     pad_start: bool = True,
                     aug_shift: int = 0,
                     prefetch: bool = True) -> Iterator[Dict]:
  """Whole-episode batches for the episode-scan training path
  (models/train.py::make_episode_train_fns — see there for the layout).

  One yielded batch = ``batch_episodes`` episodes: the uint8 frame slabs
  ship once ([B, F, H, W, 3]); windows are index matrices shared across
  the batch (all episodes have the reference's fixed length,
  pickplace.py:157). Gradient steps thus average over every task phase.

  aug_shift > 0 applies a random per-episode image translation of up to
  +-aug_shift pixels (same shift for every frame of the episode AND its
  target frame, so obs/target correspondence and dynamic images stay
  consistent — it emulates camera jitter). Fresh shifts are drawn each
  epoch, breaking absolute-pixel memorization of object locations
  (the approach-direction regression overfits spatially without it).
  """
  rng = np.random.RandomState(seed)
  paths = list_records(dataset_dir, split_name, mode)
  if not paths:
    raise FileNotFoundError(
        f'no records for {dataset_dir} split={split_name} mode={mode}')
  B = batch_episodes

  def episode_order():
    for _ in range(num_epochs):
      order = rng.permutation(len(paths)) if shuffle \
          else np.arange(len(paths))
      for pi in order:
        yield paths[pi]

  def load_iter():
    for path in episode_order():
      yield _lazy_episode(path, fetch_target)

  if prefetch:
    import queue as _queue
    import threading
    q: '_queue.Queue' = _queue.Queue(maxsize=2 * B)
    _SENTINEL = object()

    def producer():
      try:
        for item in load_iter():
          q.put(item)
      finally:
        q.put(_SENTINEL)

    threading.Thread(target=producer, daemon=True).start()

    def consume():
      while True:
        item = q.get()
        if item is _SENTINEL:
          return
        yield item
    episodes = consume()
  else:
    episodes = load_iter()

  K = window_size
  group: List = []
  for item in episodes:
    group.append(item)
    if len(group) < B:
      continue
    batch = _assemble_episode_batch(group, K, fetch_target, with_depth,
                                    pad_start)
    if aug_shift > 0 and 'frames' in batch:
      _augment_shift(batch, aug_shift, rng)
    elif aug_shift > 0 and 'qpos' in batch:
      # state-only batches: the shift is applied on device after the
      # re-render (models/train.py _materialize_frames); ship offsets only
      batch['aug_shift'] = rng.randint(
          -aug_shift, aug_shift + 1,
          size=(batch['qpos'].shape[0], 2)).astype(np.int32)
    yield batch
    group = []
  # remainder dropped (fixed-shape batches, as the JAX package's)


def _shift2d(img: np.ndarray, dy: int, dx: int, s: int) -> np.ndarray:
  """Translate [..., H, W, C] by (dy, dx) with edge padding."""
  pad = [(0, 0)] * (img.ndim - 3) + [(s, s), (s, s), (0, 0)]
  padded = np.pad(img, pad, mode='edge')
  H, W = img.shape[-3:-1]
  return padded[..., s + dy:s + dy + H, s + dx:s + dx + W, :]


def _augment_shift(batch: Dict, s: int, rng) -> None:
  """Per-episode random translation of frames (+depth/target), in place."""
  B = batch['frames'].shape[0]
  for bi in range(B):
    dy, dx = rng.randint(-s, s + 1), rng.randint(-s, s + 1)
    if dy == 0 and dx == 0:
      continue
    batch['frames'][bi] = _shift2d(batch['frames'][bi], dy, dx, s)
    if 'depth' in batch:
      batch['depth'][bi] = _shift2d(batch['depth'][bi], dy, dx, s)
    if 'target_rgb' in batch:
      batch['target_rgb'][bi] = _shift2d(batch['target_rgb'][bi], dy, dx, s)
    if 'target_depth' in batch:
      batch['target_depth'][bi] = _shift2d(batch['target_depth'][bi],
                                           dy, dx, s)


def _assemble_episode_batch(group, K: int, fetch_target: bool,
                            with_depth: bool, pad_start: bool) -> Dict:
  smalls = [g[0] for g in group]
  T = smalls[0]['step'].shape[0]  # droplast length (episode_length - 1)
  assert all(s['step'].shape[0] == T for s in smalls), \
      'episode-scan batches require equal-length episodes'
  widx = window_indices(T, K, pad_start=pad_start).astype(np.int32)
  N = widx.shape[0]
  last = widx[:, -1]

  batch: Dict[str, np.ndarray] = {
      'widx': widx,
      'valid': np.ones((N,), bool),
      'jnt_state': np.stack([s['jnt_state'] for s in smalls]),
      'cmd': np.stack([s['cmd'][last] for s in smalls]),
      'vel_target': np.stack([s['vel_target'][last] for s in smalls]),
      'ee_target': np.stack([s['ee_target'][last] for s in smalls]),
      'grp_target': np.stack([s['grp_target'][last] for s in smalls]),
      'pos_ee': np.stack([s['ee_state'][last][:, :3] for s in smalls]),
      'pos_obj': np.stack([s['obj_state'][last][:, :3] for s in smalls]),
      'step': np.stack([s['step'][last] for s in smalls]).astype(np.int32),
  }
  rgb0 = group[0][1]
  if rgb0 is not None:
    # frames [B, T, H, W, 3] uint8 — windows index 0..T-1; the target
    # frame is the episode's TRUE last frame (index T of the undropped
    # buffer, _parse_v4 fetch_target semantics)
    batch['frames'] = np.stack([g[1][:T] for g in group])
    if with_depth:
      d = np.stack([np.asarray(g[2][:T], np.float32) for g in group])
      batch['depth'] = d[..., None] if d.ndim == 4 else d
    if fetch_target:
      batch['target_rgb'] = np.stack([g[1][-1] for g in group])
      if with_depth:
        td = np.stack([np.asarray(g[2][-1], np.float32) for g in group])
        batch['target_depth'] = td[..., None] if td.ndim == 3 else td
  elif group[0][3] is not None:
    # state-only episodes: ship ~tiny state trajectories; the train step
    # re-renders the frames (and the last-frame target) on device
    rs = [g[3] for g in group]
    batch['qpos'] = np.stack([r['qpos'][:T] for r in rs])
    batch['mocap'] = np.stack([r['mocap'][:T] for r in rs])
    batch['rgba'] = np.stack([r['rgba'] for r in rs])
    if fetch_target:
      batch['tgt_qpos'] = np.stack([r['qpos'][-1] for r in rs])
      batch['tgt_mocap'] = np.stack([r['mocap'][-1] for r in rs])
  return batch


# -------------------------------------------------------------- iterator


def _lazy_episode(path: str, fetch_target: bool):
  """Load an episode keeping rgb as uint8; precompute the small vectors.

  State-only episodes (collect --dataset_formats states) carry no frames;
  their full qpos/mocap trajectory + recolor table come back as the 4th
  element so the train step can re-render on device
  (models/train.py _materialize_frames)."""
  ep, _ = load_episode(path)
  rgb_u8 = ep.get('rgb')
  depth = ep.get('depth')
  rstate = None
  if rgb_u8 is None and 'full_qpos' in ep:
    rstate = {'qpos': np.asarray(ep['full_qpos'], np.float32),
              'mocap': np.asarray(ep['mocap_qpos-robot0:mocap'],
                                  np.float32),
              'rgba': np.asarray(ep['rgba'], np.float32)}
  small = preprocess_states({k: v for k, v in ep.items()
                             if k not in ('rgb', 'depth')})
  small = preprocess_targets(small)
  return small, rgb_u8, depth, rstate


def _gather_frames(rgb_u8, depth, idx):
  """Window-index into the episode frames (rgb stays uint8: 4x less
  host->device traffic; the train step normalizes on device)."""
  rgb = rgb_u8[idx]
  if depth is None:
    return rgb, None
  d = depth[idx].astype(np.float32)
  if d.ndim == 4:
    d = d[..., None]
  return rgb, d


def input_pipeline(dataset_dir: str, split_name: str, mode: str,
                   window_size: int = 4, fetch_target: bool = False,
                   batch_size: int = 32, num_epochs: int = 1,
                   shuffle: bool = True, seed: Optional[int] = None,
                   drop_remainder: bool = True,
                   prefetch: bool = True,
                   with_depth: bool = True,
                   dedup_frames: bool = True,
                   pad_start: bool = True) -> Iterator:
  """Yields (feature, label) dict batches; sequential windows within an
  episode keep their order inside a batch slot (the LSTM state-carry
  training semantics, see models/e2evmc).

  Frames stay uint8 until a batch is assembled (windows index into the
  episode rather than materializing [n_win, K, H, W, 3]); episode loading
  runs in a prefetch thread so zlib decompression overlaps device compute.
  """
  rng = np.random.RandomState(seed)
  paths = list_records(dataset_dir, split_name, mode)
  if not paths:
    raise FileNotFoundError(
        f'no records for {dataset_dir} split={split_name} mode={mode}')

  def episode_order():
    for _ in range(num_epochs):
      order = rng.permutation(len(paths)) if shuffle \
          else np.arange(len(paths))
      for pi in order:
        yield paths[pi]

  def load_iter():
    for path in episode_order():
      yield _lazy_episode(path, fetch_target)

  if prefetch:
    import queue as _queue
    import threading
    q: '_queue.Queue' = _queue.Queue(maxsize=2)
    _SENTINEL = object()

    def producer():
      try:
        for item in load_iter():
          q.put(item)
      finally:
        q.put(_SENTINEL)

    threading.Thread(target=producer, daemon=True).start()

    def consume():
      while True:
        item = q.get()
        if item is _SENTINEL:
          return
        yield item
    episodes = consume()
  else:
    episodes = load_iter()

  K = window_size
  for small, rgb_u8, depth, _rstate in episodes:
    T = small['step'].shape[0]  # already droplast (T = episode_length - 1)
    widx = window_indices(T, K, pad_start=pad_start)
    n_win = widx.shape[0]
    for s in range(0, n_win, batch_size):
      sl = widx[s:s + batch_size]
      if sl.shape[0] < batch_size and drop_remainder:
        continue
      feature = {k: small[k][sl] for k in
                 ('step', 'ts', 'jnt_state', 'vel_state', 'ee_state',
                  'grp_state', 'goal_state', 'obj_state', 'cmd', 'ctrl')}
      if rgb_u8 is not None:
        if dedup_frames and not with_depth:
          # windows are consecutive: ship the [lo, hi) unique frame slab
          # once plus window indices (consecutive windows share K-1
          # frames; dense shipping re-sends each frame ~K times)
          lo, hi = int(sl.min()), int(sl.max()) + 1
          feature['rgb_frames'] = rgb_u8[lo:hi]
          feature['rgb_idx'] = (sl - lo).astype(np.int32)
          if fetch_target:
            feature['target_rgb'] = rgb_u8[-1][None]
        else:
          rgb, d = _gather_frames(rgb_u8, depth, sl)
          feature['rgb'] = rgb
          if with_depth and d is not None:
            # rgb-only models never read depth: don't ship it
            feature['depth'] = d
          if fetch_target:
            tgt_rgb = rgb_u8[-1]
            feature['target_rgb'] = np.broadcast_to(
                tgt_rgb, (sl.shape[0],) + tgt_rgb.shape)
            if with_depth and depth is not None:
              tgt_d = depth[-1].astype(np.float32)
              if tgt_d.ndim == 2:
                tgt_d = tgt_d[..., None]
              feature['target_depth'] = np.broadcast_to(
                  tgt_d, (sl.shape[0],) + tgt_d.shape)
      last = sl[:, -1]
      label = {
          'cmd': small['cmd'][last],
          'ctrl': small['ctrl'][last],
          'vel_target': small['vel_target'][last],
          'ee_target': small['ee_target'][last],
          'grp_target': small['grp_target'][last],
      }
      yield feature, label
