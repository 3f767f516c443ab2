"""The device an entry point of the port runs on."""

from __future__ import annotations

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
