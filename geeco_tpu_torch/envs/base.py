"""GEECO task environment over batched tensors (PyTorch).

Counterpart of ``geeco_tpu/envs/base.py``.  A ``GeecoEnv`` compiles the
static structure once, on the CPU, then moves the model to ``device`` and
exposes ``setup`` / ``reset_random`` / ``reset_to`` / ``step`` / ``observe``
/ ``eval_metrics`` / ``render`` over an ``EnvState`` whose tensors carry a
leading env axis B.  Where the JAX package vmaps per-env functions, these
take the env axis written out; where it splits a PRNG key, they take an
explicit ``torch.Generator``.

Behavioural contract (as the JAX package, after the reference gym envs):
  * action = [dx, dy, dz, cmd_grp], clipped to [-1, 1] at execution time;
    pos deltas scaled by 0.05; gripper command rint -> {-1: -0.005, 0: 0.0,
    +1: 0.05} added to the current finger qpos as servo targets; EE quat
    held at [1, 0, 1, 0]
  * ``n_substeps`` (20) physics substeps per control step
  * reset: restore the settled initial state, recolour the task objects,
    place objects (queued spec or spawn grid) and settle ``settle_steps``
    control steps
  * setup: slides (0.405, 0.48, 0); mocap to grip + (-0.498, 0.005,
    -0.431+0.2); settle ``settle_steps`` control steps

Options, as the JAX package's: ``solver_method`` (any of
``physics.solver.METHODS``; 'pallas' runs the PSD iteration as one fused
kernel launch per substep where the rows form 4 contact groups, i.e. with
``rolling=False``), ``contact_select`` ('topk' or 'quota'),
``contact_select_k`` (the top-K size; default 128 + 16 per free body past
four), ``hysteresis`` (the selection's depth bonus for rows that carried
force) and ``rolling`` ('auto', True or False).  The solver defaults are
scene-conditional, as in the JAX package: ``psd_block`` with quota
selection where a free body carries a mesh hull (ball-cup, bridge-pad,
diamond-pad, nut-cone), else ``psd`` with the global top-K.
``start_sphere_r`` (0.03) is the radius of the ball the mocap start is
drawn from by ``reset_random``.  ``renderer_kwargs`` passes any option of
``build_renderer`` (``RENDERER_OPTIONS``: camera, tile sizes, near/far,
culling, the flat or hierarchical path, analytic rects, depth_gl, ...), so
the ``renderer_kwargs`` a dataset's meta records rebuild its renderer; an
unknown key raises the ``TypeError`` of the call.  ``mass_inverse`` ('chol'
or 'blockgj') picks how the physics applies the inverse mass matrix
(``physics/dynamics.py``); ``substep_unroll`` and ``solver_unroll`` are the
JAX package's scan-unroll hints, validated as there and without effect on
the results (``physics/step.py``).  ``device`` defaults to the card:
without one, construction raises unless ``device='cpu'`` is passed.

``render`` and ``render_from_qpos`` take ``textures``, which override the
scene's textured surfaces for that render (the reference's background-video
randomisation: ``background_textures`` puts a frame on the camera-facing
wall).  ``render_from_qpos`` re-renders state-only frames (the trainer's
render_fn).
"""

from __future__ import annotations

import dataclasses
import inspect
import os
from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..core import math as gm
from ..core import mjcf
from ..core.model import (Kin, State, get_joint_qpos, make_state,
                          set_joint_qpos)
from ..physics import kinematics as K
from ..physics.solver import METHODS
from ..physics.step import Stepper, build_stepper, check_unroll
from ..render.rasterizer import Renderer, build_renderer
from ..utils.device import resolve_device
from . import spawn

# The JAX package's vendored asset tree, read by path (never imported).
ASSET_ROOT = os.environ.get(
    'GEECO_ASSET_ROOT',
    os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), 'geeco_tpu', 'assets_gym'))

MODEL_XML = {
    'pad1-cube1': 'geeco-pad1-cube1.xml',
    'pad2-cube1': 'geeco-pad2-cube1.xml',
    'pad1-cube2': 'geeco-pad1-cube2.xml',
    'pad2-cube2': 'geeco-pad2-cube2.xml',
    'pad2-cube2-clutter4': 'geeco-pad2-cube2-clutter4.xml',
    'pad2-cube2-clutter12': 'geeco-pad2-cube2-clutter12.xml',
    'ball-cup': 'geeco-ball-cup.xml',
    'bridge-pad': 'geeco-bridge-pad.xml',
    'diamond-pad': 'geeco-diamond-pad.xml',
    'nut-cone': 'geeco-nut-cone.xml',
    'push-pad1-cube1': 'geeco-push-pad1-cube1.xml',
    'push-pad1-cube2': 'geeco-push-pad1-cube2.xml',
    'push-pad2-cube1': 'geeco-push-pad2-cube1.xml',
    'push-pad2-cube2': 'geeco-push-pad2-cube2.xml',
}

# randomized spawn workspaces (pickplace.py:483-495, pushing.py:423-428)
SPAWN_DIMS = {
    'pad1-cube1': ((1.075, 1.425), (0.350, 1.150), (6, 8), 0.0),
    'pad1-cube2': ((1.075, 1.425), (0.350, 1.150), (6, 8), 0.0),
    'pad2-cube1': ((1.075, 1.425), (0.350, 1.150), (4, 7), 0.0),
    'pad2-cube2': ((1.075, 1.425), (0.350, 1.150), (4, 7), 0.0),
    'pad2-cube2-clutter4': ((1.075, 1.425), (0.350, 1.150), (4, 7), 0.0),
    'pad2-cube2-clutter12': ((1.075, 1.425), (0.350, 1.150), (4, 7), 0.0),
    'ball-cup': ((1.075, 1.425), (0.350, 1.150), (3, 6), 0.0),
    'bridge-pad': ((1.075, 1.425), (0.350, 1.150), (3, 6), 0.0),
    'diamond-pad': ((1.075, 1.425), (0.350, 1.150), (3, 6), 0.0),
    'nut-cone': ((1.075, 1.425), (0.350, 1.150), (3, 6), 0.0),
    'push-pad1-cube1': ((1.2, 1.3), (0.450, 1.050), (6, 8), 0.1),
    'push-pad1-cube2': ((1.175, 1.4), (0.5, 1.0), (2, 3), 0.125),
    'push-pad2-cube1': ((1.175, 1.4), (0.5, 1.0), (2, 3), 0.125),
    'push-pad2-cube2': ((1.175, 1.4), (0.5, 1.0), (2, 3), 0.125),
}

ROBOT_XPOS0_PICK = np.array([1.3419, 0.7491, 0.555])
ROBOT_XPOS0_PUSH = np.array([1.3419, 0.7491, 0.8])
EE_QUAT = np.array([1.0, 0.0, 1.0, 0.0]) / np.sqrt(2.0)
GRIPPER_CTRL = {-1: -0.005, 0: 0.0, 1: 0.05}
# the options of build_renderer that renderer_kwargs may carry
RENDERER_OPTIONS = tuple(
    k for k in inspect.signature(build_renderer).parameters
    if k not in ('model', 'assets', 'width', 'height'))

# deterministic reset colours (pickplace.py:386-405)
COLOR_MAP = {
    'object0': (1, 0, 0, 1), 'object1': (1, 1, 0, 1), 'object2': (1, 0, 1, 1),
    'goal0': (0, 0, 1, 1), 'goal1': (0, 1, 0, 1), 'goal2': (0, 1, 1, 1),
    'clutter0': (1, 0, 0, 1), 'clutter1': (1, 1, 0, 1),
    'clutter2': (0, 0, 1, 1), 'clutter3': (0, 1, 0, 1),
    'clutter4': (1, 0, 0, 1), 'clutter5': (1, 1, 0, 1),
    'clutter6': (0, 0, 1, 1), 'clutter7': (0, 1, 0, 1),
    'clutter8': (1, 0, 0, 1), 'clutter9': (1, 1, 0, 1),
    'clutter10': (0, 0, 1, 1), 'clutter11': (0, 1, 0, 1),
}
COLOR_POOL = np.array([
    (1, 0, 0, 1), (1, 1, 0, 1), (1, 0, 1, 1),
    (0, 0, 1, 1), (0, 1, 0, 1), (0, 1, 1, 1)], np.float32)

# eval radii (scripts/gym_pickplace.py:571-573)
OBJ_VICINITY = 0.0625
GRASP_VICINITY = 0.025
GOAL_VICINITY = 0.05

ARM_JOINTS = (
    'robot0:shoulder_pan_joint', 'robot0:shoulder_lift_joint',
    'robot0:upperarm_roll_joint', 'robot0:elbow_flex_joint',
    'robot0:forearm_roll_joint', 'robot0:wrist_flex_joint',
    'robot0:wrist_roll_joint')
FINGER_JOINTS = ('robot0:l_gripper_finger_joint',
                 'robot0:r_gripper_finger_joint')
MONITORED_JOINTS = (
    'robot0:slide0', 'robot0:slide1', 'robot0:slide2',
    'robot0:torso_lift_joint', 'robot0:head_pan_joint',
    'robot0:head_tilt_joint') + ARM_JOINTS + \
    ('robot0:r_gripper_finger_joint', 'robot0:l_gripper_finger_joint')


@dataclass
class EnvState:
  """Batched env state; every tensor has a leading env axis B."""
  phys: State
  ts: torch.Tensor           # [B] int64 control-step counter
  task_goal: torch.Tensor    # [B] int64 index into env.goal_sites
  task_object: torch.Tensor  # [B] int64 index into env.cube_sites
  goal_pos: torch.Tensor     # [B, 3] gym GoalEnv target
  rgba: torch.Tensor         # [B, ngeom, 4] per-env render colours

  def replace(self, **changes) -> 'EnvState':
    return dataclasses.replace(self, **changes)


class ResetSpec(NamedTuple):
  """Queued deterministic reset for B envs (CSV rows of the reference)."""
  obj_qpos: torch.Tensor     # [B, n_task_objs, 7] aligned with obj joints
  mocap_qpos: torch.Tensor   # [B, 7]
  task_goal: torch.Tensor    # [B] int index into env.goal_sites
  task_object: torch.Tensor  # [B] int index into env.cube_sites
  # optional [B, n_monitored] recorded arm/gripper joint positions
  arm_qpos: Optional[torch.Tensor] = None


class GeecoEnv:
  """Compiled GEECO environment over B envs on one device."""

  def __init__(self, shapes: str = 'pad2-cube2', frame_res=(256, 256),
               asset_root: str = ASSET_ROOT, n_substeps: int = 20,
               settle_steps: int = 10, solver_iterations: int = 60,
               solver_method: Optional[str] = None, hysteresis: float = 0.0,
               contact_select_k: Optional[int] = None,
               collide_every: int = 1, substep_unroll: int = 1,
               solver_unroll: int = 1, contact_select: Optional[str] = None,
               mass_inverse: str = 'chol', rolling: str | bool = 'auto',
               start_sphere_r: float = 0.03,
               renderer_kwargs: Optional[dict] = None,
               device: str | torch.device | None = None):
    if not (rolling == 'auto' or isinstance(rolling, bool)):
      # any other string would be truthy downstream: rolling='off' would
      # silently turn the rolling rows ON
      raise ValueError(f"rolling must be 'auto', True or False; "
                       f'got {rolling!r}')
    if solver_method is not None and solver_method not in METHODS:
      raise ValueError(f'unknown solver method {solver_method!r}')
    if mass_inverse not in ('chol', 'blockgj'):
      raise ValueError(f'unknown mass_inverse {mass_inverse!r}')
    for hint in (substep_unroll, solver_unroll):
      check_unroll(hint)
    self.device = resolve_device(device)
    # physics is strict float32: no TF32 in the batched matmuls
    torch.backends.cuda.matmul.allow_tf32 = False
    self.shapes = shapes
    self.task = 'pushing' if shapes.startswith('push') else 'pickplace'
    xml = os.path.join(asset_root, 'envs', MODEL_XML[shapes])
    m, self.assets = mjcf.load_model(xml)
    if contact_select_k is None:
      # the top-K active set must cover every penetrating row; clutter
      # scenes add ~2 box manifolds of resting rows per extra free body
      n_free = sum(1 for t in m.jnt_type if t == 0)  # FREE
      contact_select_k = 128 + 16 * max(0, n_free - 4)
    # scene-conditional solver defaults: mesh objects resting on the table
    # creep under the global top-K and one whole-system step size; a step
    # size per island and a per-body quota selection hold them
    free_bodies = {m.jnt_bodyid[j] for j, t in enumerate(m.jnt_type)
                   if t == 0}
    has_free_hulls = any(h >= 0 and m.geom_bodyid[g] in free_bodies
                         for g, h in enumerate(m.geom_hullid))
    if solver_method is None:
      solver_method = 'psd_block' if has_free_hulls else 'psd'
    if contact_select is None:
      contact_select = 'quota' if has_free_hulls else 'topk'
    # static structure is compiled on the CPU, then moved to the device
    stepper = build_stepper(m, contact_select_k=contact_select_k,
                            select_mode=contact_select, rolling=rolling)
    h, w = frame_res
    # kept for the dataset's meta: a state-only dataset is re-rendered at
    # train time with the renderer that collected it
    self.renderer_kwargs = dict(renderer_kwargs or {})
    renderer = build_renderer(m, self.assets, width=w, height=h,
                              **self.renderer_kwargs)
    self.model = m.to(self.device)
    self.stepper: Stepper = stepper._replace(model=self.model)
    self.renderer: Renderer = dataclasses.replace(renderer, model=self.model)
    self.solver_method = solver_method
    self.hysteresis = hysteresis
    self.collide_every = collide_every
    self.n_substeps = n_substeps
    self.start_sphere_r = start_sphere_r
    self.settle_steps = settle_steps
    self.solver_iterations = solver_iterations
    self.substep_unroll = substep_unroll
    self.solver_unroll = solver_unroll
    self.mass_inverse = mass_inverse

    # --- object / task structure from site names
    def sites_with(prefix):
      return tuple(n for n in m.site_name if n.startswith(prefix))
    self.obj_sites = tuple(n for n in m.site_name
                           if n.startswith(('object', 'goal', 'clutter')))
    self.goal_sites = sites_with('goal')
    self.cube_sites = sites_with('object')
    self.clutter_sites = sites_with('clutter')
    self.obj_joint_names = tuple(f'{n}:joint' for n in self.obj_sites)
    self.obj_site_ids = np.array([m.site(n) for n in self.obj_sites])
    self.goal_site_ids = np.array([m.site(n) for n in self.goal_sites])
    self.cube_site_ids = np.array([m.site(n) for n in self.cube_sites])
    self.grip_site = m.site('robot0:grip')
    self.gripper_body = m.body('robot0:gripper_link')
    self.mocap_id = 0

    # --- spawn grid (static)
    mmx, mmy, tiling, goal_off = SPAWN_DIMS[shapes]
    self.spawn_grid = spawn.compute_grid(mmx, mmy, tiling)
    self.goal_offset_x = goal_off
    self.spawn_z = 0.27 + (0.025 if self.task == 'pushing' else 0.037)
    self.robot_xpos0 = (ROBOT_XPOS0_PUSH if self.task == 'pushing'
                        else ROBOT_XPOS0_PICK)

    # --- recolour structure: (geom_id, colour or None->pool)
    recolor_fixed, recolor_pool = [], []
    for name in self.obj_sites:
      geoms = [g for g in range(m.ngeom) if m.geom_name[g].startswith(name)]
      if name in COLOR_MAP:
        for g in geoms:
          recolor_fixed.append((g, np.asarray(COLOR_MAP[name], np.float32)))
      else:
        recolor_pool.append(geoms)
    self.recolor_fixed = tuple(recolor_fixed)
    self.recolor_pool = tuple(tuple(g) for g in recolor_pool)

    # --- base rgba: debug visuals off
    rgba0 = m.geom_rgba.numpy().copy()
    for g in range(m.ngeom):
      if 'crosshair' in m.geom_name[g]:
        rgba0[g, 3] = 0.0
    self.rgba0 = rgba0

    self.monitored_joints = tuple(j for j in MONITORED_JOINTS
                                  if j in m.jnt_name)
    self.actuated_joints = FINGER_JOINTS
    self._initial_phys: Optional[State] = None

  def _tensor(self, x, dtype=torch.float32) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=self.device)

  def _step_phys(self, phys: State) -> State:
    return self.stepper.step(phys, self.n_substeps, self.solver_iterations,
                             collide_every=self.collide_every,
                             solver_method=self.solver_method,
                             hysteresis=self.hysteresis,
                             unroll=self.substep_unroll,
                             solver_unroll=self.solver_unroll,
                             mass_inverse=self.mass_inverse)

  def _settle(self, phys: State) -> State:
    for _ in range(self.settle_steps):
      phys = self._step_phys(phys)
    return phys

  # ------------------------------------------------------------- setup

  def setup(self) -> State:
    """Reference _env_setup: the settled initial physics state (B = 1).

    Runs eagerly on the env's device the first time, then is cached.
    """
    if self._initial_phys is not None:
      return self._initial_phys
    m = self.model
    st = self.stepper
    state = st.init_state(make_state(m, 1))
    qpos = state.qpos
    for name, val in (('robot0:slide0', 0.405), ('robot0:slide1', 0.48),
                      ('robot0:slide2', 0.0)):
      qpos = set_joint_qpos(m, qpos, name, val)
    state = state.replace(qpos=qpos)
    kin = st.fk(state)
    grip0 = kin.site_xpos[:, self.grip_site]
    target = grip0 + self._tensor([-0.498, 0.005, -0.431 + 0.2])
    state = state.replace(mocap_pos=target[:, None],
                          mocap_quat=self._tensor(EE_QUAT)[None, None],
                          ctrl=state.ctrl.new_zeros((1, m.nu)))
    state = self._settle(state)
    self._initial_phys = state
    kin = st.fk(state)
    self.initial_gripper_xpos = kin.site_xpos[0, self.grip_site].cpu().numpy()
    return state

  # ------------------------------------------------------------- reset

  def _phys_template(self, batch: int) -> State:
    """The settled initial state expanded to ``batch`` envs (views of the
    one state: clone a field before writing into it)."""
    phys0 = self.setup()
    return State(**{f.name: None if getattr(phys0, f.name) is None else
                    getattr(phys0, f.name).expand(
                        (batch,) + getattr(phys0, f.name).shape[1:])
                    for f in dataclasses.fields(State)})

  def _base_env_state(self, batch: int) -> EnvState:
    phys = self._phys_template(batch)
    phys = phys.replace(**{f.name: getattr(phys, f.name).clone()
                           for f in dataclasses.fields(State)
                           if getattr(phys, f.name) is not None})
    zeros = torch.zeros((batch,), dtype=torch.int64, device=self.device)
    return EnvState(
        phys=phys, ts=zeros, task_goal=zeros.clone(),
        task_object=zeros.clone(),
        goal_pos=torch.zeros((batch, 3), device=self.device),
        rgba=self._tensor(self.rgba0).expand(
            (batch,) + self.rgba0.shape).clone())

  def _recolor(self, batch: int,
               generator: Optional[torch.Generator]) -> torch.Tensor:
    rgba = self._tensor(self.rgba0).expand((batch,) + self.rgba0.shape)
    rgba = rgba.clone()
    for g, color in self.recolor_fixed:
      rgba[:, g] = self._tensor(color)
    for geoms in self.recolor_pool:
      if generator is None:
        raise ValueError('this scene recolours from a random pool: pass a '
                         'torch.Generator')
      pick = torch.randint(len(COLOR_POOL), (batch,), generator=generator,
                           device=generator.device).to(self.device)
      color = self._tensor(COLOR_POOL)[pick]               # [B, 4]
      for g in geoms:
        rgba[:, g] = color
    return rgba

  def reset_random(self, batch: int, generator: torch.Generator,
                   rows: Optional[slice] = None) -> EnvState:
    """Randomised reset of ``batch`` envs (reference _reset_sim).

    ``rows``: build and settle only those of the ``batch`` envs.  The
    random draws are made for all ``batch`` envs either way, so an env's
    reset does not depend on which rows are built (each rank of a
    data-parallel run takes its own)."""
    sel = slice(None) if rows is None else rows
    pts = spawn.sample_spawn_points(generator, self.spawn_grid,
                                    len(self.obj_sites), batch
                                    )[sel].to(self.device)
    start = spawn.sample_point_within_sphere(generator, self.start_sphere_r,
                                             batch)[sel].to(self.device)
    n = pts.shape[0]
    es = self._base_env_state(n)
    qpos = es.phys.qpos
    quat = self._tensor([1.0, 0, 0, 0]).expand(n, 4)
    z = torch.full((n, 1), self.spawn_z, device=self.device)
    for i, jname in enumerate(self.obj_joint_names):
      xy = pts[:, i]
      if self.goal_offset_x and self.obj_sites[i].startswith('goal'):
        xy = xy + self._tensor([self.goal_offset_x, 0.0])
      qpos = set_joint_qpos(self.model, qpos, jname,
                            torch.cat([xy, z, quat], -1))
    mocap_pos = self._tensor(self.robot_xpos0) + start
    phys = es.phys.replace(
        qpos=qpos, qvel=torch.zeros_like(es.phys.qvel),
        mocap_pos=mocap_pos[:, None],
        mocap_quat=self._tensor(EE_QUAT).expand(n, 1, 4).clone())
    phys = self._settle(phys)
    dev = generator.device
    task_goal = torch.randint(len(self.goal_sites), (batch,),
                              generator=generator, device=dev)[sel]
    task_object = torch.randint(len(self.cube_sites), (batch,),
                                generator=generator, device=dev)[sel]
    return es.replace(phys=phys, task_goal=task_goal.to(self.device),
                      task_object=task_object.to(self.device),
                      rgba=self._recolor(batch, generator)[sel])

  def reset_to(self, spec: ResetSpec,
               generator: Optional[torch.Generator] = None,
               rows: Optional[slice] = None) -> EnvState:
    """Deterministic queued reset of B = len(spec.mocap_qpos) envs;
    ``rows`` as in ``reset_random`` (the recolour draws are made for all
    B)."""
    batch = spec.mocap_qpos.shape[0]
    if rows is not None:
      spec = ResetSpec(*(None if f is None else f[rows] for f in spec))
    n = spec.mocap_qpos.shape[0]
    es = self._base_env_state(n)
    qpos = es.phys.qpos
    obj_qpos = spec.obj_qpos.to(self.device, torch.float32)
    for i, jname in enumerate(self.obj_joint_names):
      q = obj_qpos[:, i].clone()
      q[:, 2] += 0.025  # table-height adjust (pickplace.py:466)
      qpos = set_joint_qpos(self.model, qpos, jname, q)
    if spec.arm_qpos is not None:
      arm = spec.arm_qpos.to(self.device, torch.float32)
      for i, jname in enumerate(self.monitored_joints):
        qpos = set_joint_qpos(self.model, qpos, jname, arm[:, i])
    mocap = spec.mocap_qpos.to(self.device, torch.float32)
    phys = es.phys.replace(
        qpos=qpos, qvel=torch.zeros_like(es.phys.qvel),
        mocap_pos=mocap[:, None, :3],
        mocap_quat=gm.quat_normalize(mocap[:, 3:])[:, None])
    phys = self._settle(phys)
    rgba = self._recolor(batch, generator)
    return es.replace(
        phys=phys,
        task_goal=torch.as_tensor(spec.task_goal, device=self.device).long(),
        task_object=torch.as_tensor(spec.task_object,
                                    device=self.device).long(),
        rgba=rgba if rows is None else rgba[rows])

  # ------------------------------------------------------------- step

  def step(self, es: EnvState, action: torch.Tensor) -> EnvState:
    """Apply [dx, dy, dz, cmd_grp] per env ([B, 4]) and run n_substeps.

    The action is clipped to [-1, 1] at EXECUTION time (gym robotics
    RobotEnv.step clips before _set_action); the reference expert's
    P-gain relies on this saturation.
    """
    m = self.model
    action = torch.clamp(action.to(self.device, torch.float32), -1.0, 1.0)
    pos_ctrl = action[:, :3] * 0.05
    cmd_grp = torch.round(action[:, 3])        # rint: half to even
    gripper_ctrl = torch.where(
        cmd_grp < 0, GRIPPER_CTRL[-1],
        torch.where(cmd_grp > 0, GRIPPER_CTRL[1], GRIPPER_CTRL[0]))
    phys = es.phys
    # position servos target current finger qpos + delta
    qadr = m.const('act_qadr', [m.jnt_qposadr[j] for j in m.actuator_jntid])
    ctrl = phys.qpos[:, qadr] + gripper_ctrl[:, None]
    # mocap: snap to welded body pose, then displace
    kin = self.stepper.fk(phys)
    mocap_pos = kin.xpos[:, self.gripper_body] + pos_ctrl
    mocap_quat = gm.quat_normalize(
        kin.xquat[:, self.gripper_body] + self._tensor([1.0, 0, 1.0, 0]))
    phys = phys.replace(ctrl=ctrl, mocap_pos=mocap_pos[:, None],
                        mocap_quat=mocap_quat[:, None])
    phys = self._step_phys(phys)
    return es.replace(phys=phys, ts=es.ts + 1)

  # ------------------------------------------------------------- readouts

  def kin(self, es: EnvState) -> Kin:
    return self.stepper.fk(es.phys)

  def site_pos(self, kin: Kin, site_ids) -> torch.Tensor:
    """World positions of the sites ``site_ids`` [B, n, 3]."""
    ids = np.asarray(site_ids)
    return kin.site_xpos[:, self.model.const(
        f'env.sites{tuple(ids.ravel())}', ids)]

  def grip_pos(self, kin: Kin) -> torch.Tensor:
    return kin.site_xpos[:, self.grip_site]

  def _pick_site(self, kin: Kin, site_ids: np.ndarray,
                 which: torch.Tensor) -> torch.Tensor:
    sites = kin.site_xpos[:, self.model.const(
        f'env.sites{tuple(site_ids)}', site_ids)]          # [B, n, 3]
    return torch.gather(sites, 1, which[:, None, None].expand(-1, 1, 3)
                        )[:, 0]

  def task_object_pos(self, es: EnvState, kin: Kin) -> torch.Tensor:
    return self._pick_site(kin, self.cube_site_ids, es.task_object)

  def task_goal_pos(self, es: EnvState, kin: Kin) -> torch.Tensor:
    return self._pick_site(kin, self.goal_site_ids, es.task_goal)

  def proprioception(self, es: EnvState) -> torch.Tensor:
    """7-dof arm joint positions [B, 7]."""
    return torch.stack([get_joint_qpos(self.model, es.phys.qpos, j)
                        for j in ARM_JOINTS], -1)

  def _site_velp(self, es: EnvState, kin: Kin, site_id: int
                 ) -> torch.Tensor:
    info = K.dof_info(self.model, kin)
    bodyid = self.model.site_bodyid[site_id]
    jacp, _ = K.point_jacobian(self.model, kin, info,
                               kin.site_xpos[:, site_id], bodyid,
                               self.stepper.anc_mask)
    return torch.einsum('zvi,zv->zi', jacp, es.phys.qvel)

  def observe(self, es: EnvState) -> Dict[str, torch.Tensor]:
    """gym GoalEnv observation (reference _get_obs), [B, ...] each."""
    m = self.model
    kin = self.kin(es)
    dt = float(self.n_substeps) * float(m.opt.timestep)
    grip_pos = self.grip_pos(kin)
    grip_velp = self._site_velp(es, kin, self.grip_site) * dt
    robot_qpos = torch.stack([get_joint_qpos(m, es.phys.qpos, j)
                              for j in self.monitored_joints], -1)
    robot_qvel = torch.stack([
        es.phys.qvel[:, m.jnt_dofadr[m.joint(j)]]
        for j in self.monitored_joints], -1)
    obj_site = int(self.cube_site_ids[0])
    object_pos = kin.site_xpos[:, obj_site]
    object_rot = gm.mat_to_euler(kin.site_xmat[:, obj_site])
    object_velp = self._site_velp(es, kin, obj_site) * dt - grip_velp
    object_velr = torch.zeros_like(object_pos)  # unused downstream
    object_rel_pos = object_pos - grip_pos
    gripper_state = robot_qpos[:, -2:]
    gripper_vel = robot_qvel[:, -2:] * dt
    obs = torch.cat([
        grip_pos, object_pos, object_rel_pos, gripper_state, object_rot,
        object_velp, object_velr, grip_velp, gripper_vel], -1)
    return {
        'observation': obs,
        'achieved_goal': object_pos,
        'desired_goal': es.goal_pos,
    }

  def sample_goal(self, es: EnvState, goal: torch.Tensor) -> EnvState:
    return es.replace(goal_pos=torch.as_tensor(goal, dtype=torch.float32,
                                               device=self.device).expand(
                                                   es.goal_pos.shape))

  def reward(self, es: EnvState) -> torch.Tensor:
    """Sparse reward [B] (gym FetchEnv compute_reward, threshold 0.05)."""
    kin = self.kin(es)
    d = gm.norm(self.task_object_pos(es, kin) - es.goal_pos)
    return -(d > 0.05).float()

  # ------------------------------------------------------------- eval

  def eval_metrics(self, es: EnvState) -> Dict[str, torch.Tensor]:
    """obj_vicinity / grasp_success / task_success / goal_dist, [B] each
    (scripts/gym_pickplace.py:575-601)."""
    kin = self.kin(es)
    grip = self.grip_pos(kin)
    obj = self.task_object_pos(es, kin)
    goal = self.task_goal_pos(es, kin)
    d_go = gm.norm(obj - grip)
    d_og = gm.norm(goal - obj)
    return {
        'obj_vicinity': (d_go <= OBJ_VICINITY).float(),
        'grasp_success': (d_go <= GRASP_VICINITY).float(),
        'task_success': (d_og <= GOAL_VICINITY).float(),
        'goal_dist': d_og,
    }

  # ------------------------------------------------------------- render

  def background_slot(self) -> Optional[int]:
    """Texture slot of the camera-facing wall (the reference randomises
    'wall_04'), or None if the scene has no such textured wall."""
    for slot, g in enumerate(np.asarray(self.renderer.scene.tex_slot_geom)):
      if self.model.geom_name[int(g)] == 'wall_04':
        return slot
    return None

  def background_textures(self, frame) -> Optional[torch.Tensor]:
    """The whole texture-slot stack with the background wall replaced by
    ``frame``: [R, R, 3] -> [S, R, R, 3], or one frame per env [B, R, R, 3]
    -> [B, S, R, R, 3] (per-step video randomisation); None where the scene
    has no background slot."""
    slot = self.background_slot()
    if slot is None:
      return None
    frame = torch.as_tensor(frame, dtype=torch.float32, device=self.device)
    tex = self.renderer.const('tex_default')
    if frame.dim() not in (3, 4) or frame.shape[-3:] != tex.shape[1:]:
      raise ValueError(f'background textures must be a frame of '
                       f'{tuple(tex.shape[1:])} texels (or one per env), '
                       f'got {tuple(frame.shape)}')
    tex = tex.expand(frame.shape[:-3] + tex.shape).clone()
    tex[..., slot, :, :, :] = frame
    return tex

  def render(self, es: EnvState, textures=None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """RGB uint8 [B, H, W, 3] and depth f32 [B, H, W] from the renderer's
    camera (external_camera_1 by default), row 0 = top; the depth is
    metric, or OpenGL-style in [0, 1] when the renderer was built with
    ``depth_gl``.  ``textures`` ([S, R, R, 3], or one stack per env
    [B, S, R, R, 3]) overrides the textured background surfaces (table
    top, floor, walls) for this render."""
    return self.renderer.render(self.kin(es), es.rgba, textures)

  def render_from_qpos(self, qpos: torch.Tensor, mocap_qpos: torch.Tensor,
                       rgba: torch.Tensor, textures=None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Re-render n recorded frames from their stored state.

    qpos [n, nq], mocap_qpos [n, 7] (mocap position, then quaternion), rgba
    [n, ngeom, 4] -> (rgb uint8 [n, H, W, 3], depth f32 [n, H, W]), one
    render of all n; ``textures`` and the depth as in ``render``.
    State-only datasets store the full qpos + mocap pose per step and the
    episode's recolour table instead of frames; FK reads nothing else, so
    training re-synthesizes the exact pixels on the device.  The other
    fields come from the settled initial state.
    """
    n = qpos.shape[0]
    mocap = mocap_qpos.to(self.device, torch.float32)
    phys = self._phys_template(n).replace(
        qpos=qpos.to(self.device, torch.float32),
        mocap_pos=mocap[:, None, :3], mocap_quat=mocap[:, None, 3:])
    return self.renderer.render(self.stepper.fk(phys),
                                rgba.to(self.device, torch.float32),
                                textures)


def make_env(shapes: str = 'pad2-cube2', **kwargs) -> GeecoEnv:
  return GeecoEnv(shapes=shapes, **kwargs)
