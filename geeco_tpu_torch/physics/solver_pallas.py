"""Fused projected steepest-descent (PSD) contact solve: the CUDA kernel's
wrapper and its plain PyTorch twin.

Counterpart of ``geeco_tpu/physics/solver_pallas.py``.  It replaces that
module's Pallas TPU kernel ``_run_pallas`` (body ``_kernel``, math
``_psd_loop``): ``iterations`` steps of diagonally preconditioned projected
steepest descent with the exact step size, on the inequality rows of the
contact dual after the weld rows were Schur-eliminated, all in one launch.

Each iteration, for B envs at once::

    g = Aop f + b;  d = precond * g;  alpha = (g.d) / (d.Aop d)
    f <- project(f - alpha d)        (alpha = 0 unless d.Aop d > 1e-12)

with the kernel's own operator form ``Aop f = J (X f) - A_IE (EEinv (A_IEᵀ
f)) + R f``.  (The jnp psd path of ``solver.solve`` applies the weld
correction as ``A_IE EEinv J_E X_I f``; the two are equal in exact
arithmetic and round differently in float32.)

Row layout, as ``solver._row_order`` with ngrp=4: K normal rows, K rows of
each tangent, K torsion rows, then 2*nlim limit rows; rows past those are
padding and are zeroed.

Operands are env-major and contiguous float32 (the TPU kernel's lane layout
``[.., E]`` and its padding to 8 rows are not copied)::

    J [B, nI, nv]   X [B, nv, nI]   A_IE [B, nI, nE]   EEinv [B, nE, nE]
    R, b, precond, f0 [B, nI]   mu_t, mu_tor, con_act [B, K]
    lim_act [B, 2*nlim]

nE = 0 is legal: the weld term is skipped.  ``psd_solve`` launches the CUDA
kernel (``csrc/psd_solve.cu``) for tensors on the card, for every batch
size, and runs the twin ``psd_solve_reference`` for tensors on the CPU; any
other device, a non-float32 or a non-contiguous operand raises.  Nothing
falls back.
"""

from __future__ import annotations

import contextlib
import ctypes

import torch

_THREADS = 512               # the kernel's block size (csrc/psd_solve.cu)
_SMEM_MAX = 227 * 1024       # dynamic shared memory one block can have

# operands recorded by ``capture`` (None when no capture is open)
_captured: list | None = None


def project_rows(f, mu_t, mu_tor, con_act, lim_act, K: int, nlim: int):
  """Cone projection of [B, nI] rows (4 contact groups, then limit rows).

  Elliptic cone over the n/t1/t2/tor groups: fn >= 0, the tangential
  force clipped to the disk of radius mu_t*fn, torsion clipped at
  mu_tor*fn, all masked by con_act; limit rows >= 0 masked by lim_act;
  padding rows zeroed.  Counterpart of ``_project_rows``, operation for
  operation.
  """
  fn = torch.clamp(f[:, 0:K], min=0.0) * con_act
  ft1 = f[:, K:2 * K]
  ft2 = f[:, 2 * K:3 * K]
  t_norm = torch.sqrt(ft1 * ft1 + ft2 * ft2 + 1e-18)
  scale = torch.clamp(mu_t * fn / t_norm, max=1.0)
  ft1 = ft1 * scale * con_act
  ft2 = ft2 * scale * con_act
  lim = mu_tor * fn
  ftor = torch.clamp(f[:, 3 * K:4 * K], -lim, lim) * con_act
  parts = [fn, ft1, ft2, ftor]
  if nlim:
    parts.append(torch.clamp(f[:, 4 * K:4 * K + 2 * nlim], min=0.0) *
                 lim_act[:, :2 * nlim])
  rest = f[:, 4 * K + 2 * nlim:]
  if rest.shape[1]:
    parts.append(torch.zeros_like(rest))
  return torch.cat(parts, 1)


def psd_solve_reference(J, X, A_IE, EEinv, R, b, precond, f0, mu_t, mu_tor,
                        con_act, lim_act, K: int, nlim: int,
                        iterations: int):
  """Plain PyTorch twin of the kernel (``_psd_loop`` batched over envs)."""
  nE = A_IE.shape[2]

  def mv(A, v):                                    # [B, m, n] @ [B, n]
    return torch.bmm(A, v[..., None])[..., 0]

  def Aop(v):
    y = mv(J, mv(X, v))
    if nE:
      y = y - mv(A_IE, mv(EEinv, mv(A_IE.transpose(1, 2), v)))
    return y + R * v

  def project(v):
    return project_rows(v, mu_t, mu_tor, con_act, lim_act, K, nlim)

  zero = torch.zeros((), dtype=f0.dtype, device=f0.device)
  f = project(f0)
  for _ in range(iterations):
    g = Aop(f) + b
    d = precond * g
    Ad = Aop(d)
    denom = (d * Ad).sum(-1, keepdim=True)
    num = (g * d).sum(-1, keepdim=True)
    alpha = torch.where(denom > 1e-12, num / torch.clamp(denom, min=1e-12),
                        zero)
    f = project(f - alpha * d)
  return f


def _check(ops: dict, K: int, nlim: int, iterations: int):
  dev = ops['J'].device
  for name, t in ops.items():
    if t.dtype != torch.float32:
      raise TypeError(f'psd_solve: {name} must be float32, got {t.dtype}')
    if not t.is_contiguous():
      raise ValueError(f'psd_solve: {name} must be contiguous')
    if t.device != dev:
      raise ValueError(f'psd_solve: {name} is on {t.device}, J on {dev}')
  B, nI, nv = ops['J'].shape
  nE = ops['A_IE'].shape[2]
  want = {'J': (B, nI, nv), 'X': (B, nv, nI), 'A_IE': (B, nI, nE),
          'EEinv': (B, nE, nE), 'R': (B, nI), 'b': (B, nI),
          'precond': (B, nI), 'f0': (B, nI), 'mu_t': (B, K),
          'mu_tor': (B, K), 'con_act': (B, K), 'lim_act': (B, 2 * nlim)}
  for name, shape in want.items():
    if tuple(ops[name].shape) != shape:
      raise ValueError(f'psd_solve: {name} must be {shape}, got '
                       f'{tuple(ops[name].shape)}')
  if 4 * K + 2 * nlim > nI:
    raise ValueError(f'psd_solve: 4*K + 2*nlim = {4 * K + 2 * nlim} rows '
                     f'exceed nI = {nI}')
  if iterations < 0:
    raise ValueError(f'psd_solve: iterations={iterations}')


def _smem_bytes(nI: int, nv: int, nE: int) -> int:
  """Dynamic shared memory of one block: f, g, d, R, b, precond rows,
  A_IE, EEinv, u, w, z and the two reduction buffers."""
  return 4 * (6 * nI + nI * nE + nE * nE + nv + 2 * nE +
              2 * (_THREADS // 32))


def psd_solve(J, X, A_IE, EEinv, R, b, precond, f0, mu_t, mu_tor, con_act,
              lim_act, K: int, nlim: int, iterations: int) -> torch.Tensor:
  """The iterated inequality-row forces f [B, nI].

  CUDA tensors: one launch of the kernel on the current stream, counted in
  ``psd_solve.launches``.  CPU tensors: the plain twin.
  """
  ops = dict(J=J, X=X, A_IE=A_IE, EEinv=EEinv, R=R, b=b, precond=precond,
             f0=f0, mu_t=mu_t, mu_tor=mu_tor, con_act=con_act,
             lim_act=lim_act)
  _check(ops, K, nlim, iterations)
  if _captured is not None:
    _captured.append(dict(ops, K=K, nlim=nlim, iterations=iterations))
  dev = J.device
  if dev.type == 'cpu':
    return psd_solve_reference(J, X, A_IE, EEinv, R, b, precond, f0, mu_t,
                               mu_tor, con_act, lim_act, K, nlim, iterations)
  if dev.type != 'cuda':
    raise ValueError(f'psd_solve: no kernel for device {dev}')
  B, nI, nv = J.shape
  nE = A_IE.shape[2]
  if _smem_bytes(nI, nv, nE) > _SMEM_MAX:
    raise ValueError(f'psd_solve: nI={nI}, nv={nv}, nE={nE} need '
                     f'{_smem_bytes(nI, nv, nE)} bytes of shared memory, '
                     f'more than {_SMEM_MAX}')
  from ..utils import build
  lib = build.load_kernels()
  out = torch.empty((B, nI), dtype=torch.float32, device=dev)
  stream = torch.cuda.current_stream(dev).cuda_stream
  ptr = lambda t: ctypes.c_void_p(t.data_ptr())
  with torch.cuda.device(dev):
    err = lib.psd_solve_f32(
        ptr(J), ptr(X), ptr(A_IE), ptr(EEinv), ptr(R), ptr(b), ptr(precond),
        ptr(f0), ptr(mu_t), ptr(mu_tor), ptr(con_act), ptr(lim_act),
        ptr(out), B, nI, nv, nE, K, nlim, iterations,
        ctypes.c_void_p(stream))
  if err != 0:
    raise RuntimeError('psd_solve launch failed: ' +
                       lib.geeco_cuda_error_string(err).decode())
  psd_solve.launches += 1
  return out


psd_solve.launches = 0


@contextlib.contextmanager
def capture():
  """Record the operands of every ``psd_solve`` call made inside the block.

  Yields a list that fills with one dict per call (the operand tensors by
  name, plus K, nlim and iterations), so a caller can hold the kernel
  against its twin on the operands of a real substep.
  """
  global _captured
  prev, _captured = _captured, []
  try:
    yield _captured
  finally:
    _captured = prev
