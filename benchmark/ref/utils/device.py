"""The device an entry point of the port runs on, and moving data there."""

from __future__ import annotations

import subprocess
from typing import Dict

import numpy as np
import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
  """``device``, or the card when it is None.

  Raises when a CUDA device is asked for and there is none, so that a run
  meant for the card never falls back to the CPU; the CPU is taken only when
  the caller names it.
  """
  dev = torch.device('cuda' if device is None else device)
  if dev.type == 'cuda' and not torch.cuda.is_available():
    raise RuntimeError(f'device {str(dev)!r} requested but CUDA is not '
                       "available (pass device='cpu' to run on the CPU)")
  return dev


def to_device(arrays: Dict[str, np.ndarray], device) -> Dict[str,
                                                             torch.Tensor]:
  """A numpy batch on ``device``; int32 index arrays become int64."""
  out = {}
  for k, v in arrays.items():
    t = torch.as_tensor(np.asarray(v))
    if t.dtype == torch.int32:
      t = t.long()
    out[k] = t.to(device)
  return out


def card_name(device: torch.device) -> str:
  """The card's name and power limit as nvidia-smi gives them, or 'cpu'."""
  if device.type != 'cuda':
    return 'cpu'
  smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                        '--format=csv,noheader'], capture_output=True,
                       text=True, timeout=60)
  if smi.returncode != 0:
    return f'nvidia-smi failed: {smi.stderr.strip()}'
  return smi.stdout.strip().splitlines()[0]
