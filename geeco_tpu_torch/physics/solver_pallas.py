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

in one of two forms (the kernel's ``PSD_FORM``):

* 0, the TPU kernel's: ``solver.solve``'s ``'pallas'`` method, which needs
  ngrp=4, as the JAX package's does.  ``Aop f = J (X f) - A_IE (EEinv
  (A_IEᵀ f)) + R f``, f0 projected first, the sums in the kernel's order.
* 1, ``solver.solve``'s own ``'psd'`` iteration, which ``solver.
  _solve_rows`` runs on the card (pass ``J_E``, and ``mu_roll`` with the
  rolling rows): ``Aop f = (J u + R f) - A_IE (EEinv (J_E u))`` with
  ``u = X f``, f0 as given, every operation the eager loop's and every
  sum in the order the eager loop's library calls sum it (``orders``,
  read by ``library_orders``), so that its forces are the loop's bit for
  bit.  At some steps of a production episode a control step amplifies a
  float32 rounding of the solve to 1e-4 in qpos in most envs; only the
  loop's own orders keep the eager step's state.

The two weld terms are equal in exact arithmetic and round differently in
float32; the weld block is badly conditioned, so each path keeps its own.

Row layout, as ``solver._row_order``: ngrp groups of K contact rows
(normal, two tangents, torsion, and with ngrp=6 the two rolling rows),
then 2*nlim limit rows; rows past those are padding and are zeroed.

Operands are env-major and contiguous float32 (the TPU kernel's lane layout
``[.., E]`` and its padding to 8 rows are not copied)::

    J [B, nI, nv]   X [B, nv, nI]   A_IE [B, nI, nE]   EEinv [B, nE, nE]
    R, b, precond, f0 [B, nI]   mu_t, mu_tor, con_act [B, K]
    lim_act [B, 2*nlim]   mu_roll [B, K] (ngrp=6)   J_E [B, nE, nv] ('psd')

nE = 0 is legal in form 0: the weld term is skipped.  ``psd_solve``
launches the CUDA kernel (``csrc/psd_solve.cu``) for tensors on the card,
for every batch size, and runs the twin ``psd_solve_reference`` for tensors
on the CPU; any other device, a non-float32 or a non-contiguous operand
(but J in the 'psd' form, which is copied once, transposed) raises.
Nothing falls back here: ``solver._solve_rows`` decides beforehand whether
the kernel takes a solve (``solver.fuses``, ``fused_plan``).

Form 0 on an H100, and its design.  The solve is a chain of
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
``psd_solve`` raises.  Form 1 holds one env in one block, a thread a row
(``_exact_layout``; ``fused_plan``): the chains of ``u = X v`` span every
row, so no cluster can split it.
"""

from __future__ import annotations

import contextlib
import ctypes
import math

import numpy as np
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

# form 1's summation orders (``library_orders``): (chains, chunk width) of
# u = X v, J u, w = J_E u, z = EEinv w and A_IE z, and the threads of a row
# sum (``rw``)
ORDER_KEYS = ('gu', 'wu', 'gj', 'wj', 'gw', 'ww', 'gz', 'wz', 'ga', 'wa',
              'rw')
_NO_ORDERS = dict.fromkeys(ORDER_KEYS, 0)
# the threads a row that torch's float32 row sum may take (on the H100 with
# torch 2.11: 128 below 8 rows, 64 below 16, 32 from 16 on)
_ROW_SUM_THREADS = (32, 64, 128, 256, 512)

# operands recorded by ``capture`` (None when no capture is open)
_captured: list | None = None


def project_rows(f, mu_t, mu_tor, con_act, lim_act, K: int, nlim: int,
                 mu_roll=None):
  """Cone projection of [B, nI] rows (4 contact groups, or 6 with
  ``mu_roll``, then limit rows).

  Elliptic cone over the n/t1/t2/tor groups: fn >= 0, the tangential
  force clipped to the disk of radius mu_t*fn, torsion clipped at
  mu_tor*fn, the two rolling groups at mu_roll*fn, all masked by con_act;
  limit rows >= 0 masked by lim_act; padding rows zeroed.  Counterpart of
  ``_project_rows``, operation for operation (and, on the rows it has, of
  ``solver._project``).
  """
  G = 4 if mu_roll is None else 6
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
  if mu_roll is not None:
    lim_r = mu_roll * fn
    parts += [torch.clamp(f[:, g * K:(g + 1) * K], -lim_r, lim_r) * con_act
              for g in (4, 5)]
  if nlim:
    parts.append(torch.clamp(f[:, G * K:G * K + 2 * nlim], min=0.0) *
                 lim_act[:, :2 * nlim])
  rest = f[:, G * K + 2 * nlim:]
  if rest.shape[1]:
    parts.append(torch.zeros_like(rest))
  return torch.cat(parts, 1)


def psd_solve_reference(J, X, A_IE, EEinv, R, b, precond, f0, mu_t, mu_tor,
                        con_act, lim_act, K: int, nlim: int,
                        iterations: int, mu_roll=None, J_E=None):
  """Plain PyTorch twin of the kernel: ``_psd_loop`` batched over envs, or
  with ``J_E`` ``solver.solve``'s 'psd' iteration, operation for operation
  (``solver._iterate``, ``_apply``, ``_project``)."""
  nE = A_IE.shape[2]

  def mv(A, v):                                    # [B, m, n] @ [B, n]
    return torch.bmm(A, v[..., None])[..., 0]

  def Aop(v):
    if J_E is not None:
      u = mv(X, v)
      y = mv(J, u) + R * v
      return y - mv(A_IE, mv(EEinv, mv(J_E, u))) if nE else y
    y = mv(J, mv(X, v))
    if nE:
      y = y - mv(A_IE, mv(EEinv, mv(A_IE.transpose(1, 2), v)))
    return y + R * v

  def project(v):
    return project_rows(v, mu_t, mu_tor, con_act, lim_act, K, nlim, mu_roll)

  zero = torch.zeros((), dtype=f0.dtype, device=f0.device)
  f = f0 if J_E is not None else project(f0)
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
  ops = {k: t for k, t in ops.items() if t is not None}
  for name, t in ops.items():
    if t.dtype != torch.float32:
      raise TypeError(f'psd_solve: {name} must be float32, got {t.dtype}')
    if not t.is_contiguous() and not (name == 'J' and 'J_E' in ops):
      raise ValueError(f'psd_solve: {name} must be contiguous')
    if t.device != dev:
      raise ValueError(f'psd_solve: {name} is on {t.device}, J on {dev}')
  B, nI, nv = ops['J'].shape
  nE = ops['A_IE'].shape[2]
  want = {'J': (B, nI, nv), 'X': (B, nv, nI), 'A_IE': (B, nI, nE),
          'EEinv': (B, nE, nE), 'R': (B, nI), 'b': (B, nI),
          'precond': (B, nI), 'f0': (B, nI), 'mu_t': (B, K),
          'mu_tor': (B, K), 'con_act': (B, K), 'lim_act': (B, 2 * nlim),
          'mu_roll': (B, K), 'J_E': (B, nE, nv)}
  for name, t in ops.items():
    if tuple(t.shape) != want[name]:
      raise ValueError(f'psd_solve: {name} must be {want[name]}, got '
                       f'{tuple(t.shape)}')
  G = 6 if 'mu_roll' in ops else 4
  if G * K + 2 * nlim > nI:
    raise ValueError(f'psd_solve: {G}*K + 2*nlim = {G * K + 2 * nlim} rows '
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


def _exact_layout(nI: int, nv: int, nE: int, K: int, nlim: int, gu: int,
                  rw: int) -> dict:
  """Form 1's launch (``psdx::make_plan`` of the source, word for word):
  one block an env, a thread per row (and per chain of u = X v, and per
  thread of a row sum), X, A_IE, J_E, EEinv, the row vectors and the row
  sums' partial sums in shared memory, and as many of Jᵀ's dofs as the
  rest leaves room for; the others read from device memory."""
  r4 = _round4
  nlp = r4(nI)
  words = (r4(nv * nlp) + r4(nI * nE) + 8 * nlp + r4(nE * nv) + r4(nE * nE) +
           r4(nv) + r4(gu * nv) + 2 * r4(nE) + 4 * r4(K) + r4(2 * nlim) +
           r4(2) + r4(rw))
  # the first dofs of Jᵀ in what is left
  words += min(nv, max(0, (_SMEM_MAX // 4 - words) // nlp)) * nlp
  threads = min(_MAX_THREADS, max((nI + 31) // 32 * 32,
                                  (nv * gu + 31) // 32 * 32, rw))
  return dict(cluster=1, threads=threads, resident=True, jreg=0, xreg=False,
              smem=4 * words)


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
               cluster: int | None = None, ngrp: int = 4,
               orders: dict | None = None) -> dict:
  """What ``utils.build.load_psd`` builds the kernel from: the shapes of a
  solve and their launch plan; with ``orders`` (``library_orders``) the
  'psd' form (form 1) with ``ngrp`` row groups, else the TPU kernel's
  (form 0, 4 groups)."""
  if orders is not None:
    lay = _exact_layout(nI, nv, nE, K, nlim, orders['gu'], orders['rw'])
    return dict(lay, **orders, nI=nI, nv=nv, nE=nE, K=K, nlim=nlim,
                ngrp=ngrp, form=1)
  return dict(plan(B, nI, nv, nE, K, cluster), **_NO_ORDERS, nI=nI, nv=nv,
              nE=nE, K=K, nlim=nlim, ngrp=4, form=0)


def fused_plan(B: int, nI: int, nv: int, nE: int, K: int,
               nlim: int) -> dict | None:
  """The launch of ``solver.solve``'s 'psd' iteration with the eager loop's
  summation orders (form 1) at these shapes, or None where the kernel has
  none: no weld rows, or a block's shared memory too small for X and the
  rows of one env.  ``solver._solve_rows`` then runs the eager loop."""
  if not 0 < nE <= _MAX_NE:
    return None
  lay = _exact_layout(nI, nv, nE, K, nlim, 1, _ROW_SUM_THREADS[0])
  return lay if lay['smem'] <= _SMEM_MAX else None


def _chain_family(k: int, lca0) -> tuple | None:
  """(G, W) of the family of summation orders ``psdx::ordered_dot`` sums
  in (G chains of W-term chunks, chain g over chunks g, g + G, .., the
  chain sums halved pairwise) whose subtree sizes at the pairs (0, j)
  are ``lca0[j - 1]``; None if no member has them."""
  lca0 = list(lca0)
  W = next((j for j in range(1, k) if lca0[j - 1] != j + 1), k)
  for G in (1, 2, 4, 8, 16, 32, 64):
    group = [(j // W) % G for j in range(k)]
    size = [group.count(g) for g in range(G)]
    pos = [sum(1 for i in range(j) if group[i] == group[j]) for j in range(k)]
    want = []
    for j in range(1, k):
      q = group[j]
      if q == 0:
        want.append(pos[j] + 1)
      else:
        low = q & -q
        want.append(sum(size[g] for g in range(0, G, low)))
    if want == lca0:
      return G, W
  return None


def _tree_sums(x: np.ndarray, shift: int, threads: int) -> np.ndarray:
  """The float32 sums of the rows of ``x`` [r, n], each starting ``shift``
  floats past a 16-byte boundary, summed step for step as
  ``psdx::row_sum`` sums a row with ``threads`` threads."""
  r, n = x.shape
  acc = np.zeros((r, threads, 4), np.float32)
  end, base = n, 0
  if shift:
    end, base = n + shift - 4, 4 - shift
    acc[:, shift:4, 0] = x[:, :base]
  whole = x[:, base:base + end // 4 * 4].reshape(r, end // 4, 4)
  for i in range(whole.shape[1]):
    acc[:, i % threads] += whole[:, i]
  for t in range(end % 4):
    acc[:, t, 0] += x[:, base + end // 4 * 4 + t]
  s = ((acc[..., 0] + acc[..., 1]) + acc[..., 2]) + acc[..., 3]
  off = threads // 2
  while off >= 32:
    s[:, :off] += s[:, off:2 * off]
    off //= 2
  s = s[:, :32]
  for off in (16, 8, 4, 2, 1):
    s = s + np.pad(s[:, off:], ((0, 0), (0, off)))
  return s[:, 0]


def _row_sum_threads(B: int, n: int, device) -> int | None:
  """The threads a row of torch's sum over the rows of a fresh float32
  [B, n] tensor on ``device`` (as ``solver._iterate`` sums g*d and d*Ad):
  the count of ``_ROW_SUM_THREADS`` whose ``_tree_sums`` give torch's sums
  of FPRev's rows (1s, with M and -M at the terms 0 and j) bit for bit;
  None where none does."""
  big = 2.0 ** 40
  xs, sums = [], []
  for start in range(1, n, B):
    js = np.arange(start, min(n, start + B))
    x = np.ones((B, n), np.float32)
    x[np.arange(len(js)), 0] = big
    x[np.arange(len(js)), js] = -big
    xs.append(x)
    sums.append(torch.from_numpy(x).to(device).sum(-1, keepdim=True)[:, 0])
  xs, got = np.stack(xs), torch.stack(sums).cpu().numpy()
  # rows b and b + p start at the same offset within 16 bytes
  p = 4 // math.gcd(n, 4)
  for threads in _ROW_SUM_THREADS:
    if all(np.array_equal(_tree_sums(xs[:, b::p].reshape(-1, n), b * n % 4,
                                     threads), got[:, b::p].reshape(-1))
           for b in range(min(p, B))):
      return threads
  return None


def library_orders(J, X, J_E, A_IE, EEinv) -> dict | None:
  """The summation orders in which the eager 'psd' loop's five products
  (``solver._apply``: ``torch.bmm`` of u = X v, J u, w = J_E u,
  z = EEinv w and A_IE z) and its two row sums are summed on these
  operands' device at these operands' batch, shapes, strides and offsets:
  for each product, the (G, W) of ``_chain_family``, read by FPRev (a sum
  of 1s with M and -M at the terms 0 and j counts the 1s outside the
  subtree where 0 and j meet); for the row sums, their threads a row
  (``_row_sum_threads``).  None where an order is of no family the kernel
  sums in."""
  big = 2.0 ** 40
  out = {}
  for (gk, wk), A in zip((('gu', 'wu'), ('gj', 'wj'), ('gw', 'ww'),
                          ('gz', 'wz'), ('ga', 'wa')),
                         (X, J, J_E, EEinv, A_IE)):
    B, m, k = A.shape
    if k < 2:
      out[gk], out[wk] = 1, max(k, 1)
      continue
    base = A.new_empty(A.untyped_storage().nbytes() // A.element_size())
    probe = base.as_strided(A.shape, A.stride(), A.storage_offset())
    ones = A.new_ones((B, k))
    lca0 = []
    for start in range(1, k, B * m):
      js = torch.arange(start, min(k, start + B * m), device=A.device)
      n = len(js)
      probe.fill_(1.0)
      b_, o_ = torch.arange(n, device=A.device) // m, \
          torch.arange(n, device=A.device) % m
      probe[b_, o_, 0] = big
      probe[b_, o_, js] = -big
      s_ = torch.bmm(probe, ones[..., None])[..., 0]
      lca0 += (k - s_[b_, o_].round()).long().tolist()
    fam = _chain_family(k, lca0)
    if fam is None:
      return None
    out[gk], out[wk] = fam
  out['rw'] = _row_sum_threads(J.shape[0], J.shape[1], J.device)
  return None if out['rw'] is None else out


def psd_solve(J, X, A_IE, EEinv, R, b, precond, f0, mu_t, mu_tor, con_act,
              lim_act, K: int, nlim: int, iterations: int,
              cluster: int | None = None, mu_roll=None, J_E=None,
              orders: dict | None = None) -> torch.Tensor:
  """The iterated inequality-row forces f [B, nI].

  ``mu_roll`` [B, K]: the rows hold 6 contact groups (rolling rows), else
  4.  ``J_E`` [B, nE, nv]: ``solver.solve``'s 'psd' form, else the TPU
  kernel's (the module's docstring).  On the card the 'psd' form runs
  summed in ``orders``, the eager loop's summation orders
  (``library_orders``); the TPU kernel's form has 4 row groups.
  CUDA tensors: one launch of the kernel on the current stream, laid out by
  ``plan`` (``cluster`` forces its cluster size), counted in
  ``psd_solve.launches`` (by this call: inside a CUDA graph's capture the
  launch is recorded, and the graph's replays run it uncounted; count
  those in a device trace).  The kernel is built for these shapes at their
  first solve (nvcc, a few seconds) and kept.  Shapes that are resident in
  no cluster of four blocks run with J and X in device memory.  CPU
  tensors: the plain twin.
  """
  ops = dict(J=J, X=X, A_IE=A_IE, EEinv=EEinv, R=R, b=b, precond=precond,
             f0=f0, mu_t=mu_t, mu_tor=mu_tor, con_act=con_act,
             lim_act=lim_act, mu_roll=mu_roll, J_E=J_E)
  _check(ops, K, nlim, iterations)
  if _captured is not None:
    _captured.append(dict({k: t for k, t in ops.items() if t is not None},
                          K=K, nlim=nlim, iterations=iterations,
                          **({} if orders is None else dict(orders=orders))))
  dev = J.device
  if dev.type == 'cpu':
    return psd_solve_reference(J, X, A_IE, EEinv, R, b, precond, f0, mu_t,
                               mu_tor, con_act, lim_act, K, nlim, iterations,
                               mu_roll, J_E)
  if dev.type != 'cuda':
    raise ValueError(f'psd_solve: no kernel for device {dev}')
  B, nI, nv = J.shape
  nE = A_IE.shape[2]
  if (J_E is None) != (orders is None) or (mu_roll is not None and
                                           orders is None):
    raise ValueError("psd_solve: on the card the 'psd' form (J_E) runs with "
                     'its orders, and only it takes mu_roll')
  lay = build_spec(B, nI, nv, nE, K, nlim, cluster,
                   4 if mu_roll is None else 6, orders)
  from ..utils import build
  lib = build.load_psd(lay)
  if orders is not None:        # form 1 reads J transposed: its one copy
    J = J.transpose(1, 2).contiguous()
  out = torch.empty((B, nI), dtype=torch.float32, device=dev)
  stream = torch.cuda.current_stream(dev).cuda_stream
  ptr = lambda t: ctypes.c_void_p(t.data_ptr())
  opt = lambda t: ctypes.c_void_p(None if t is None else t.data_ptr())
  with torch.cuda.device(dev):
    err = lib.psd_solve_f32(
        ptr(J), ptr(X), ptr(A_IE), ptr(EEinv), ptr(R), ptr(b), ptr(precond),
        ptr(f0), ptr(mu_t), ptr(mu_tor), ptr(con_act), ptr(lim_act),
        opt(mu_roll), opt(J_E), ptr(out), B, iterations,
        ctypes.c_void_p(stream))
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
  against its twin on the operands of a real substep.  Only the solves
  that run Python are recorded: eager substeps, and a chain's warm-up and
  capture (``physics/substep_graph.py``).  A chain's replay runs the
  kernel it captured and records nothing, so a caller that wants every
  substep's operands patches ``substep_graph.engages`` to return False.
  """
  global _captured
  prev, _captured = _captured, []
  try:
    yield _captured
  finally:
    _captured = prev
