"""Carry a model and its state across from the JAX package.

The JAX package's ``Model``, ``State`` and ``EnvState`` are read field by
field: every array leaf goes through ``np.asarray`` and becomes a float32 (or
integer) tensor, and the static fields (ints, tuples, names) are taken as
they are.  Nothing here imports JAX: the caller hands over the objects, or
any object with the same field names holding numpy arrays.

The tests use this to feed both engines identical inputs.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from .model import Kin, Model, Option, State


def _tensor(x, device=None) -> torch.Tensor:
  arr = np.asarray(x)
  if arr.dtype.kind == 'f':
    arr = arr.astype(np.float32)
  elif arr.dtype.kind in 'iu':
    arr = arr.astype(np.int64)
  return torch.as_tensor(arr, device=device)


def _fields_of(cls, ref, device, skip=()):
  out = {}
  for f in dataclasses.fields(cls):
    if f.name.startswith('_') or f.name in skip:
      continue
    v = getattr(ref, f.name)
    if v is None or isinstance(v, (bool, int, float, str, tuple)):
      out[f.name] = v
    else:
      out[f.name] = _tensor(v, device)
  return out


def model_from_reference(ref: Any, device=None) -> Model:
  """The port's Model from the JAX package's Model (or its numpy leaves)."""
  opt = Option(**_fields_of(Option, ref.opt, device))
  return Model(opt=opt, **_fields_of(Model, ref, device, skip=('opt',)))


def _batched(t: torch.Tensor | None, per_env_ndim: int):
  if t is None or t.ndim > per_env_ndim:
    return t
  return t.unsqueeze(0)


def state_from_reference(ref: Any, device=None) -> State:
  """The port's State from a JAX State, per env ([nq]) or batched ([B, nq]).

  A per-env state gains a leading env axis of 1.
  """
  f = _fields_of(State, ref, device)
  return State(
      qpos=_batched(f['qpos'], 1), qvel=_batched(f['qvel'], 1),
      ctrl=_batched(f['ctrl'], 1), mocap_pos=_batched(f['mocap_pos'], 2),
      mocap_quat=_batched(f['mocap_quat'], 2), time=_batched(f['time'], 0),
      efc_force=_batched(f['efc_force'], 1))


def kin_from_reference(ref: Any, device=None) -> Kin:
  """The port's Kin from a JAX Kin, per env or batched."""
  f = _fields_of(Kin, ref, device)
  return Kin(**{k: _batched(v, 3 if k in ('ximat', 'site_xmat') else 2)
                for k, v in f.items()})


def env_state_from_reference(ref: Any, device=None):
  """The port's EnvState from a JAX EnvState, per env or batched.

  The JAX PRNG key is dropped: the port draws from an explicit
  ``torch.Generator`` handed to each call that samples.
  """
  from ..envs.base import EnvState
  phys = state_from_reference(ref.phys, device)

  def scalar(x):
    return _batched(_tensor(x, device), 0)

  return EnvState(
      phys=phys, ts=scalar(ref.ts), task_goal=scalar(ref.task_goal),
      task_object=scalar(ref.task_object),
      goal_pos=_batched(_tensor(ref.goal_pos, device), 1),
      rgba=_batched(_tensor(ref.rgba, device), 2))


def expert_state_from_reference(ref: Any, device=None):
  """The port's ExpertState from a JAX ExpertState, per env or batched."""
  from ..expert.policies import ExpertState
  return ExpertState(
      phase=_batched(_tensor(ref.phase, device), 0),
      target=_batched(_tensor(ref.target, device), 1),
      aux=_batched(_tensor(ref.aux, device), 1),
      count=_batched(_tensor(ref.count, device), 0))


# flax module name -> the port's attribute
_E2EVMC_MODULES = {'ConvEncoder': 'enc_obs', 'DynBuffEncoder': 'enc_dyn',
                   'DynDiffEncoder': 'enc_diff', 'LSTMDecoder': 'decoder'}
_LSTM_GATES = ('i', 'f', 'g', 'o')


def e2evmc_params_from_reference(params: Any) -> dict:
  """The port's E2E-VMC ``state_dict`` from a flax param tree.

  ``params`` is the tree under ``variables['params']`` as nested dicts of
  arrays.  Conv kernels [kh, kw, in, out] become weights [out, in, kh, kw]
  and Dense kernels [in, out] weights [out, in] (both engines compute a
  cross-correlation: no flip); GroupNorm ``scale`` becomes ``weight``; the
  LSTM cell's per-gate kernels ``ii/if/ig/io`` ([in, H], no bias) and
  ``hi/hf/hg/ho`` ([H, H] with bias) are stacked in gate order i, f, g, o
  into ``lstm.ih`` and ``lstm.hh``.  Every leaf lands in exactly one entry;
  a leaf this does not know raises.
  """
  t = lambda x: torch.from_numpy(np.array(x, np.float32))
  out = {}
  for mod, sub in params.items():
    prefix = _E2EVMC_MODULES[mod]
    for layer, leaves in sub.items():
      key = f'{prefix}.{layer}'
      names = set(leaves)
      if layer == 'lstm':
        out[key + '.ih.weight'] = torch.cat(
            [t(leaves['i' + g]['kernel']).T for g in _LSTM_GATES])
        out[key + '.hh.weight'] = torch.cat(
            [t(leaves['h' + g]['kernel']).T for g in _LSTM_GATES])
        out[key + '.hh.bias'] = torch.cat(
            [t(leaves['h' + g]['bias']) for g in _LSTM_GATES])
        names -= {p + g for p in 'ih' for g in _LSTM_GATES}
      elif layer.startswith('gn'):
        out[key + '.weight'] = t(leaves['scale'])
        out[key + '.bias'] = t(leaves['bias'])
        names -= {'scale', 'bias'}
      else:
        k = t(leaves['kernel'])
        out[key + '.weight'] = (k.permute(3, 2, 0, 1) if k.ndim == 4
                                else k.T).contiguous()
        out[key + '.bias'] = t(leaves['bias'])
        names -= {'kernel', 'bias'}
      if names:
        raise ValueError(f'unconverted leaves {sorted(names)} under {key}')
  return out
