"""The physics substep replayed as a chain of CUDA graphs.

On the card the host, not the device, bounds a substep: FK with its jvp,
the mass matrix, collide, make_constraints and the solve's set-up are
thousands of small kernels, each launched by eager PyTorch.
``Stepper._substep_c`` (``physics/step.py``) hands a substep here where
``engages`` holds: every tensor it reads on one card, none that autograd
tracks, and that card's stream not capturing already.  Everywhere else,
the CPU included, the eager substep runs.  Each key (``key``: everything
that fixes a capture) has one chain, captured at its first substep and
replayed at every later one.  The chain
runs the pieces of ``step.Substep`` in the order of its ``run``:

  segment  what                                             span
  G1       ``smooth``: FK with the jvp bias forces, the     physics.smooth
           mass matrix, the forces, M_impl and its factor
  E1       ``mass_solve``: qacc_smooth (eager)              physics.smooth
  G2       ``collide`` (where the substep collides)         physics.collide
  G3       ``constraints``                                  physics.constraints
  E2       ``minv_jt``: X = M_impl⁻¹Jᵀ (eager)              physics.solve
  G4       ``solve``: the solve, its projected iteration    physics.solve
           recorded in, the velocity update and the
           integration

E1 and E2 are the batched ``torch.cholesky_solve``, which allocates, frees
and synchronizes inside each call, so no graph can hold it; under
``mass_inverse='blockgj'`` the explicit inverse is captured in G1 and X is
a graph of its own.  A substep that reuses contacts (``collide_every`` > 1)
has no G2, and its G3 reads the contacts as inputs.  A solve with no rows
has no E2.

The graphs of a chain share one memory pool and replay in the order they
were captured, each reading its predecessors' outputs where they lie.
Only the state's fields (and reused contacts) are copied in, each eager
result into the buffer its successors read, and the new state's fields
out.  A replay runs the same kernels on the same operands as the eager
substep (buffers keep the strides and offsets of what they stand for,
``_buffer_like``), so it gives the eager substep's results bit for bit.

Counters stay true though no Python runs in a replay: the host counts and
the device tallies a capture made (``profiling.recording``) are made again
at each replay.  ``solver_pallas.psd_solve.launches`` counts the fused
solve's calls alone (its warm-up and its capture); a replay's launches
show in a device trace.  ``linalg.cholesky`` and ``linalg.inv`` or their
failures into the card's flag (``_faults``) instead of checking on the
host; ``raise_faults``, which ``Stepper.step`` and ``Stepper.substep``
call at their end, reads it and raises as the eager substep does.
``physics.substeps`` and ``physics.graphed_substeps``
(``Stepper._substep_c``) say how often a substep takes this path.

The ``MAX_CHAINS`` most recently used chains are kept: a process that
settles partial resets of many row counts captures one chain per count.
A chain keeps its graphs' pool (the intermediates of a substep) and its
static buffers: at 256 envs of pad2-cube2 (786 rows, nv=39) its capture
reserved 0.35 GB of an H100's memory, 0.12 GB of it live buffers; at one
env under 40 MB.
"""

from __future__ import annotations

import collections
import contextlib
from typing import NamedTuple

import torch

from ..utils import profiling
from . import linalg as L
from . import solver as S

MAX_CHAINS = 4

# the state's fields a substep reads, in the order of ``_inputs``
_STATE = ('qpos', 'qvel', 'ctrl', 'mocap_pos', 'mocap_quat', 'time',
          'efc_force')

# key -> _Chain, the most recently used last
_chains: 'collections.OrderedDict[tuple, _Chain]' = collections.OrderedDict()
# device -> the bool flag its chains' factorizations and inverses or their
# failures into
_faults: dict = {}
# the devices where a chain replayed since their flag was last read
_unread: set = set()


def _inputs(state, contacts) -> tuple:
  """The tensors a substep reads beside the model: the state's fields
  (None where unset) and the contacts it reuses, if any."""
  fields = tuple(getattr(state, f) for f in _STATE)
  if contacts is None:
    return fields
  return fields + (contacts.pos, contacts.normal, contacts.dist)


def engages(st, state, contacts) -> bool:
  """Whether this substep runs as its chain's replay: every tensor it
  reads on one card, none that autograd tracks, and that card's stream not
  capturing already (a caller capturing its own graph records the eager
  substep into it)."""
  tensors = [st.model.body_pos] + [t for t in _inputs(state, contacts)
                                   if t is not None]
  dev = tensors[0].device
  if dev.type != 'cuda' or any(t.device != dev or t.requires_grad
                               for t in tensors):
    return False
  return not S._capturing(dev)


def key(sub, state, contacts) -> tuple:
  """What fixes the capture of ``sub`` (a ``step.Substep``): the model and
  its constraint layout ``cs`` (by identity: the graphs hold the model's
  tensors and the layout's sizes; a chain keeps both alive), the solver's
  method and iterations, the hysteresis, the mass inverse, whether the
  substep collides, the matmul precision (TF32), and each input's device,
  dtype, sizes (B among them), strides and offset."""
  st = sub.stepper
  return (id(st.model), id(st.cs), sub.method, sub.iterations,
          float(sub.hysteresis), sub.mass_inverse, contacts is None,
          torch.backends.cuda.matmul.allow_tf32,
          tuple(None if t is None else
                (t.device, t.dtype, tuple(t.shape), t.stride(),
                 t.storage_offset())
                for t in _inputs(state, contacts)))


def _cached(k: tuple, make):
  """The chain of key ``k``, made by ``make()`` where there is none; the
  least recently used beyond ``MAX_CHAINS`` are dropped."""
  chain = _chains.get(k)
  if chain is None:
    chain = _chains[k] = make()
    while len(_chains) > MAX_CHAINS:
      _chains.popitem(last=False)
  else:
    _chains.move_to_end(k)
  return chain


def substep(sub, state, contacts):
  """The substep ``sub`` (a ``step.Substep``) as its chain's replay, the
  chain captured first where the key is new: (state, contacts), as
  ``Substep.run`` returns them.  Runs on the inputs' card, which need not
  be the current one."""
  k = key(sub, state, contacts)
  dev = state.qpos.device
  with torch.cuda.device(dev):
    chain = _cached(k, lambda: _Chain(sub, state, contacts))
    _unread.add(dev)
    return chain(state, contacts)


def raise_faults(device: torch.device) -> None:
  """Raise ``torch.linalg.LinAlgError`` where a chain on ``device`` found a
  factorization or an inverse that failed since the flag was last read:
  where the eager substep's checked ``torch.linalg`` call raises.  Reads
  the flag (one synchronize) only where a chain replayed since, and
  clears it."""
  if device not in _unread:
    return
  _unread.discard(device)
  flag = _faults[device]
  if bool(flag):
    flag.zero_()
    raise torch.linalg.LinAlgError(
        f'a substep on {device} replayed as CUDA graphs could not factor '
        'M_impl or invert the weld Schur block (it is not positive-'
        'definite)')


def _capture(fn, args, pool, stream):
  """``fn(*args)`` captured as a CUDA graph on ``stream`` into the memory
  pool ``pool`` (a new one where None): (graph, outputs, pool)."""
  graph = torch.cuda.CUDAGraph()
  with torch.cuda.graph(graph, pool=pool, stream=stream):
    out = fn(*args)
  return graph, out, graph.pool() if pool is None else pool


class _Segment(NamedTuple):
  graph: object        # torch.cuda.CUDAGraph
  counts: list         # the counts and tallies its capture made
  out: object          # its outputs, where each replay writes them

  def replay(self):
    self.graph.replay()
    for fn, name, n in self.counts:
      fn(name, n)
    return self.out


def _buffer_like(t: torch.Tensor) -> torch.Tensor:
  """An uninitialised tensor with ``t``'s sizes, strides and storage
  offset: a kernel handed it takes the path it takes on ``t`` (a matrix
  product's transposes and alignment follow the layout, and the eager
  substep's results bit for bit need them unchanged)."""
  if t.numel() == 0:
    return torch.empty_like(t)
  n = t.storage_offset() + 1 + sum((size - 1) * stride for size, stride in
                                   zip(t.shape, t.stride()))
  return t.new_empty(n).as_strided(t.shape, t.stride(), t.storage_offset())


def _static(t):
  return None if t is None else _buffer_like(t).copy_(t)


def _quiet(name):
  return contextlib.nullcontext()


class _Chain:
  """One key's graphs and the static buffers between them (the module's
  docstring).  Made on the inputs' card, which has to be current."""

  def __init__(self, sub, state, contacts):
    dev = state.qpos.device
    if dev not in _faults:
      _faults[dev] = torch.zeros((), dtype=torch.bool, device=dev)
    self.sub = sub                     # keeps the key's ids taken
    self.inputs = tuple(_static(t) for t in _inputs(state, contacts))
    self.state = state.replace(**dict(zip(_STATE, self.inputs)))
    self.contacts = None if contacts is None else contacts._replace(
        pos=self.inputs[7], normal=self.inputs[8], dist=self.inputs[9])
    self.graphs, self.buffers = [], []
    main, side = torch.cuda.current_stream(), torch.cuda.Stream()
    pool = None

    def graph(fn, *args):
      nonlocal pool
      with profiling.recording() as counts:
        g, out, pool = _capture(fn, args, pool, side)
      self.graphs.append(_Segment(g, counts, out))
      return out

    def eager(fn, *args):
      out = fn(*args)
      with torch.cuda.stream(main):    # a buffer of the replays' stream
        buf = _buffer_like(out)
      self.buffers.append(buf)
      return buf

    # the whole substep once, eagerly, on the first state: what a capture
    # cannot do (copies of constants to the card, library handles, the
    # fused solve's build) is done here; then the same sequence captured
    side.wait_stream(main)
    with torch.cuda.stream(side), profiling.recording(), \
        L.faults_into(_faults[dev]):
      sub.run(self.state, self.contacts, span=_quiet)
      sub.run(self.state, self.contacts, span=_quiet, graph=graph,
              eager=eager)
    main.wait_stream(side)

  def __call__(self, state, contacts):
    graphs, buffers = iter(self.graphs), iter(self.buffers)

    def graph(fn, *args):
      seg = next(graphs)
      if seg is self.graphs[0]:        # the state (and reused contacts) in
        for buf, t in zip(self.inputs, _inputs(state, contacts)):
          if buf is not None:
            buf.copy_(t)
      out = seg.replay()
      if seg is not self.graphs[-1]:
        return out
      return state.replace(qpos=out.qpos.clone(), qvel=out.qvel.clone(),
                           time=out.time.clone(),
                           efc_force=out.efc_force.clone())

    def eager(fn, *args):
      return next(buffers).copy_(fn(*args))

    new, c = self.sub.run(self.state, self.contacts, graph=graph,
                          eager=eager)
    return new, (c if contacts is None else contacts)
