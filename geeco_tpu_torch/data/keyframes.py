"""Target-frame / keyframe extraction from recorded episodes.

Library port of the reference notebook ``dataset-extract_keyframes.ipynb``
(SURVEY.md §2.20): for every record, save the LAST frame as the target image
(images/targets/{rgb/<name>.png, depth/<name>.npy}); when a
``data/key_frames_<id>.json`` annotation exists, export the listed frames to
images/keyframes/.  Every export is round-trip verified with np.allclose
(the notebook's embedded QA check).

Loading mirrors load_target_frame / load_keyframes
(reference: src/data/geeco_gym.py:165-229).  The port's own copy of
``geeco_tpu/data/keyframes.py``; Pillow is imported by the functions that
read or write images, so the rest of the port never needs it.
"""

from __future__ import annotations

import json
import os
import re
from typing import List

import numpy as np

from .dataset import list_records
from .episode import load_episode


def _save_rgb(path: str, rgb_uint8: np.ndarray):
  from PIL import Image
  os.makedirs(os.path.dirname(path), exist_ok=True)
  Image.fromarray(rgb_uint8).save(path)
  back = np.asarray(Image.open(path))
  assert np.allclose(back, rgb_uint8), f'round-trip mismatch: {path}'


def _save_depth(path: str, depth: np.ndarray):
  os.makedirs(os.path.dirname(path), exist_ok=True)
  np.save(path, depth)
  back = np.load(path)
  assert np.allclose(back, depth), f'round-trip mismatch: {path}'


def extract_targets(dataset_dir: str, keyframes: bool = True) -> int:
  """Extract target (and key-) frames for every record. Returns count."""
  n = 0
  for path in list_records(dataset_dir):
    name = os.path.basename(path).split('.')[0]
    ep, _ = load_episode(path)
    if 'rgb' not in ep:
      continue
    rgb = ep['rgb']
    if rgb.dtype != np.uint8:
      rgb = np.clip(rgb * 255.0, 0, 255).astype(np.uint8)
    depth = ep.get('depth')  # absent in the fast npz collect format
    _save_rgb(os.path.join(dataset_dir, 'images', 'targets', 'rgb',
                           f'{name}.png'), rgb[-1])
    if depth is not None:
      _save_depth(os.path.join(dataset_dir, 'images', 'targets', 'depth',
                               f'{name}.npy'), depth[-1])
    n += 1
    if keyframes:
      rid = re.search(r'\d+', name)
      kf_path = os.path.join(dataset_dir, 'data',
                             f'key_frames_{rid.group(0)}.json') if rid \
          else None
      if kf_path and os.path.exists(kf_path):
        with open(kf_path) as fp:
          frames = json.load(fp)
        for k, t in enumerate(frames):
          _save_rgb(os.path.join(dataset_dir, 'images', 'keyframes', 'rgb',
                                 f'{name}_kf{k:02d}.png'), rgb[t])
          if depth is not None:
            _save_depth(os.path.join(dataset_dir, 'images', 'keyframes',
                                     'depth', f'{name}_kf{k:02d}.npy'),
                        depth[t])
  return n


def load_target_frame(dataset_dir: str, record_name: str,
                      load_depth: bool = True) -> np.ndarray:
  from PIL import Image
  filename = os.path.basename(record_name).split('.')[0]
  rgb_path = os.path.join(dataset_dir, 'images', 'targets', 'rgb',
                          filename + '.png')
  rgb = np.array(Image.open(rgb_path), dtype=np.float32) / 255.0
  if load_depth:
    depth_path = os.path.join(dataset_dir, 'images', 'targets', 'depth',
                              filename + '.npy')
    depth = np.load(depth_path)[..., None]
    return np.concatenate([rgb, depth], axis=-1)
  return rgb


def load_keyframes(dataset_dir: str, record_name: str) -> List[np.ndarray]:
  from PIL import Image
  filename = os.path.basename(record_name).split('.')[0]
  rgb_dir = os.path.join(dataset_dir, 'images', 'keyframes', 'rgb')
  depth_dir = os.path.join(dataset_dir, 'images', 'keyframes', 'depth')
  rgb_files = sorted(f for f in os.listdir(rgb_dir)
                     if f.startswith(filename))
  out = []
  for rf in rgb_files:
    rgb = np.array(Image.open(os.path.join(rgb_dir, rf)),
                   dtype=np.float32) / 255.0
    depth = np.load(os.path.join(depth_dir, rf.replace('.png', '.npy')))
    out.append(np.concatenate([rgb, depth[..., None]], axis=-1))
  return out


def load_target_frames(dataset_dir: str, record_name: str,
                       load_depth: bool = True) -> List[np.ndarray]:
  """Keyframes when annotated, else the single target frame
  (reference: geeco_gym.py:165-177)."""
  rid = re.search(r'\d+', os.path.basename(record_name))
  if rid:
    kf = os.path.join(dataset_dir, 'data', f'key_frames_{rid.group(0)}.json')
    if os.path.exists(kf):
      return load_keyframes(dataset_dir, record_name)
  return [load_target_frame(dataset_dir, record_name, load_depth)]
