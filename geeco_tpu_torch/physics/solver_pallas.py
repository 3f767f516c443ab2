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

What bounds the kernel on an H100, and its design.  The solve is a chain of
2*iterations dependent operator applications per env, each a small
matrix-vector product whose result every row needs: the instructions a warp
runs between two barriers and, for ``X v``, one SM's shared-memory
bandwidth bind, not device memory nor the arithmetic rate.  So the kernel

* is compiled per shape (``utils/build.py::load_psd``: the shapes and the
  launch plan are ``-DPSD_*`` constants; nvcc runs at a shape's first
  solve, a few seconds, and the library is kept);
* stages every operand on the SM once per launch: J's rows in registers,
  one row per thread, where nv <= 40 and the rows fit one block's threads,
  else in shared memory (by a bulk asynchronous copy where one block holds
  an env's J); X, A_IEᵀ, EEinv and the row vectors in shared memory, and
  each warp's rows of X in its registers too where the block is small
  enough to leave them;
* runs one thread per output row for ``J u - A_IE z + R v`` with explicit
  fused multiply-adds, one warp per output of ``u = X v, w = A_IEᵀ v``,
  and five barriers an iteration;
* can split one env's rows over a thread-block cluster of C in {1, 2, 4}
  blocks: each block owns a share of the contacts in all four row groups,
  so the cone projection stays local, and the partial ``u, w`` and the two
  dot products cross through distributed shared memory (``st.async``
  stores counted on the receiver's mbarrier: no fence, no cluster
  barrier).

``plan`` picks the launch from the shapes and B alone: the smallest C whose
share fits a block's 227 KB, raised to 2 while all 2*B blocks find an SM of
their own (PERF.md has the measurement); shapes that fit no cluster of four
run with J and X left in device memory (``resident=False``).  Cluster
launches need an sm_90 card: elsewhere the launch is refused and
``psd_solve`` raises.
"""

from __future__ import annotations

import contextlib
import ctypes

import torch

_SMEM_MAX = 227 * 1024       # dynamic shared memory one block can have
_MAX_THREADS = 1024          # block size: one thread per row, up to this
_REG_THREADS = 576           # ... of the instances with J in registers
_JREG = 40                   # ... which hold a row of up to 40 dofs
_CLUSTERS = (1, 2, 4)
_MAX_NE = 32                 # z = EEinv w is computed by one warp's lanes
_SMS = 132                   # an H100's multiprocessors
_REGISTERS = 65536           # ... and the registers of one
_OTHER_REGS = 56             # what the kernel uses beside the resident rows

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


def _round4(n: int) -> int:
  return (n + 3) & ~3


def _smem_bytes(nI: int, nv: int, nE: int, K: int, C: int, threads: int,
                resident: bool, jreg: int) -> int:
  """Dynamic shared memory of one block (``psd::make_plan`` of the source,
  word for word): the staging and exchange barriers; the f, g, d, R, b,
  precond rows and the row map of the block's share; mu_t, mu_tor, con_act,
  lim_act; A_IEᵀ, EEinv; the two exchange buffers, u/w and the dot-product
  partials; and, resident, X and (unless its rows are in registers) J."""
  Kl = -(-K // C)
  tl = -(-(nI - 4 * K) // C)
  nl = 4 * Kl + tl
  nlp = _round4(nl)
  NW = 0 if nE == 0 else max(8, _round4(nE))
  PW = max(_round4(nv), jreg) + NW
  words = (8 + 7 * nlp + 3 * _round4(Kl) + _round4(tl) + nE * nlp +
           nE * NW + (2 * C + 1) * PW +
           2 * _round4(C * (threads // 32)))
  if resident:
    words += nv * nlp
    if not jreg:
      words += _round4(nl * nv + 4)
  return 4 * words


def plan(B: int, nI: int, nv: int, nE: int, K: int,
         cluster: int | None = None) -> dict:
  """How one launch is laid out, from the shapes and B alone.

  Returns ``cluster`` (blocks per env), ``threads`` (per block), ``resident``
  (J and X staged on the SM), ``jreg`` (0, or the registers that hold a row
  of J per thread), ``xreg`` (each warp keeps its rows of X in registers
  too) and ``smem`` (bytes per block).  The smallest cluster whose share is
  resident is taken, raised to 2 while all 2*B blocks still find an SM of
  their own: a pair of blocks per env measured faster than one block at
  B=64 and at B=1, and a cluster of 4 no faster than the pair (PERF.md).
  A shape that is resident in no cluster runs with J and X in device
  memory.  ``cluster`` forces the cluster size.  Raises when even the row
  vectors of a share exceed a block's memory.
  """
  if cluster is not None and cluster not in _CLUSTERS:
    raise ValueError(f'psd_solve: cluster={cluster}, not one of {_CLUSTERS}')
  if nE > _MAX_NE:
    raise ValueError(f'psd_solve: nE={nE} weld rows, the kernel takes '
                     f'{_MAX_NE}')

  def layout(C, resident):
    nl = 4 * -(-K // C) + -(-(nI - 4 * K) // C)     # rows of the largest share
    jreg = _JREG if resident and nv <= _JREG and nl <= _REG_THREADS else 0
    # a thread per row, and a warp per four outputs of u = X v, w = A_IEᵀ v
    threads = min(_REG_THREADS if jreg else _MAX_THREADS,
                  max((nl + 31) // 32 * 32, -(-(nv + nE) // 4) * 32))
    smem = _smem_bytes(nI, nv, nE, K, C, threads, resident, jreg)
    # a warp's four rows of [X; A_IEᵀ] in its registers too, where the
    # block's size leaves them (registers are dealt out per 128 threads)
    row_regs = 16 * -(-(-(-nl // 4)) // 32)
    xreg = (resident and nv + nE <= 4 * (threads // 32) and
            row_regs + jreg + _OTHER_REGS <=
            min(255, _REGISTERS // (-(-threads // 128) * 128)))
    return dict(cluster=C, threads=threads, resident=resident, jreg=jreg,
                xreg=xreg, smem=smem)

  sizes = _CLUSTERS if cluster is None else (cluster,)
  for resident in (True, False):
    fits = [lay for lay in (layout(C, resident) for C in sizes)
            if lay['smem'] <= _SMEM_MAX]
    if fits:
      pair = (resident and len(fits) > 1 and fits[0]['cluster'] == 1 and
              2 * B <= _SMS)
      return fits[1] if pair else fits[0]
  raise ValueError(f'psd_solve: nI={nI}, nv={nv}, nE={nE}, K={K} fit no '
                   f'block\'s {_SMEM_MAX} bytes of shared memory, resident '
                   f'or not')


def build_spec(B: int, nI: int, nv: int, nE: int, K: int, nlim: int,
               cluster: int | None = None) -> dict:
  """What ``utils.build.load_psd`` builds the kernel from: the shapes of a
  solve and their launch plan."""
  return dict(plan(B, nI, nv, nE, K, cluster), nI=nI, nv=nv, nE=nE, K=K,
              nlim=nlim)


def psd_solve(J, X, A_IE, EEinv, R, b, precond, f0, mu_t, mu_tor, con_act,
              lim_act, K: int, nlim: int, iterations: int,
              cluster: int | None = None) -> torch.Tensor:
  """The iterated inequality-row forces f [B, nI].

  CUDA tensors: one launch of the kernel on the current stream, laid out by
  ``plan`` (``cluster`` forces its cluster size), counted in
  ``psd_solve.launches``.  The kernel is built for these shapes at their
  first solve (nvcc, a few seconds) and kept.  Shapes that are resident in
  no cluster of four blocks run with J and X in device memory.  CPU
  tensors: the plain twin.
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
  lay = build_spec(B, nI, nv, nE, K, nlim, cluster)
  from ..utils import build
  lib = build.load_psd(lay)
  out = torch.empty((B, nI), dtype=torch.float32, device=dev)
  stream = torch.cuda.current_stream(dev).cuda_stream
  ptr = lambda t: ctypes.c_void_p(t.data_ptr())
  with torch.cuda.device(dev):
    err = lib.psd_solve_f32(
        ptr(J), ptr(X), ptr(A_IE), ptr(EEinv), ptr(R), ptr(b), ptr(precond),
        ptr(f0), ptr(mu_t), ptr(mu_tor), ptr(con_act), ptr(lim_act),
        ptr(out), B, iterations, ctypes.c_void_p(stream))
  if err != 0:
    raise RuntimeError(f'psd_solve launch failed ({lay}): ' +
                       lib.psd_cuda_error_string(err).decode())
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
