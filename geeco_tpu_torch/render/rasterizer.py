"""Tiled batched triangle rasterizer producing RGB(-D) observations.

Counterpart of ``geeco_tpu/render/rasterizer.py``.  Pipeline, for B envs at
once:
  1. transform the compiled triangle soup by the geom world poses (Kin)
  2. project to screen space (MuJoCo camera: looks along -z, y up,
     vertical fov = cam_fovy) and flat-shade each triangle, with
     occlusion-tested shadows on static receivers
  3. hierarchical binning: coarse 64x64-px regions keep their top-K1
     triangles by priority, then 32x32-px mid regions keep the first K2
     coarse candidates that overlap them; each 16x16 fine tile reads its
     mid region's list
  4. per fine tile: z-buffered rasterization over its K2 slots in
     inverse-depth space — the hand-written CUDA kernel
     (``raster_kernel.raster_tiles``) on the card, its plain PyTorch twin on
     the CPU
  5. compose the tiles into the image; sky where no triangle was hit

The port has this one path on every device: the JAX package's flat binning
(``_bin_flat`` + ``_raster_jnp``) and the analytic background rects are not
ported yet.

Layout: the JAX package keeps [K, n_tiles] planes (tiles in TPU lanes);
here the binned planes are tile-major, [B, n_tiles, K], so one CUDA block
reads one tile's slot list from contiguous memory.  Tile order within the
image is the JAX package's mid-major order (tile = mid * 4 + sub).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..core import math as gm
from ..core.mjcf import Assets
from ..core.model import CAPSULE, Kin, Model
from . import raster_kernel
from .scene import RenderScene, build_render_scene

_COARSE = 4   # fine tiles per coarse-region side
_MID = 2      # fine tiles per mid-region side


@dataclass
class Renderer:
  model: Model
  scene: RenderScene
  width: int
  height: int
  cam_id: int
  tile: int
  znear: float
  zfar: float
  sky_rgb: Tuple[float, float, float]
  cull: int       # backface culling: 0 off, +1/-1 keep that area sign
  coarse_k: int   # candidate capacity per coarse (64 px) region
  mid_k: int      # candidate capacity per mid (32 px) region
  shadows: bool   # occlusion-tested shadows on static receivers
  shadow_caps: Tuple[int, ...]  # capsule occluder geom ids (arm proxies)

  def replace(self, **changes) -> 'Renderer':
    return dataclasses.replace(self, **changes)

  def render(self, kin: Kin, geom_rgba: torch.Tensor | None = None,
             textures: torch.Tensor | None = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Render B envs: (rgb uint8 [B, H, W, 3], depth f32 [B, H, W]).

    ``textures`` (f32 in [0, 1], [S, R, R, 3] for every env or
    [B, S, R, R, 3] per env) overrides the static texel colours of the
    scene's textured surfaces (``RenderScene.tri_texslot``): the
    reference's TextureModder background randomisation.  The texels only
    colour the triangles, so the raster kernel is the same.
    """
    return _render(self, kin, geom_rgba, textures)

  def const(self, name: str) -> torch.Tensor:
    """A RenderScene array as a (cached) tensor on the model's device."""
    return self.model.const('scene.' + name, getattr(self.scene, name))


def build_renderer(model: Model, assets: Assets, width: int = 256,
                   height: int = 256, coarse_k: int = 512, mid_k: int = 192,
                   shadows: bool = True, tex_grid: Optional[int] = None
                   ) -> Renderer:
  """Compile the scene (numpy, from a model on the CPU) into a Renderer.

  The JAX package's defaults throughout: camera external_camera_1, 16-px
  fine tiles, znear 0.05, zfar 10, backface culling, tessellated
  background (its ``analytic_rects=False``).  ``tex_grid``: the texel grid
  of textured surfaces (None: the scene's default; 0: flat colours).
  """
  tile = 16
  if height % (tile * _COARSE) or width % (tile * _COARSE):
    raise ValueError(f'{width}x{height} is not a multiple of the '
                     f'{tile * _COARSE}-px coarse region')
  scene_kwargs = {} if tex_grid is None else {'tex_grid': tex_grid}
  scene = build_render_scene(model, assets, analytic_rects=False,
                             **scene_kwargs)
  # sky colour: mean of the builtin gradient skybox texture
  sky = (0.45, 0.86, 0.57)
  # arm-link capsule occluders: the invisible collision proxies double as
  # shadow casters
  rgba = model.geom_rgba.cpu().numpy()
  caps = tuple(int(g) for g in range(model.ngeom)
               if model.geom_type[g] == CAPSULE and rgba[g, 3] < 0.01)
  return Renderer(model=model, scene=scene, width=width, height=height,
                  cam_id=model.cam('external_camera_1'), tile=tile,
                  znear=0.05, zfar=10.0, sky_rgb=sky, cull=-1,
                  coarse_k=min(coarse_k, scene.tri.shape[0]),
                  mid_k=min(mid_k, coarse_k), shadows=shadows,
                  shadow_caps=caps)


# ---------------------------------------------------------------------------
# stage 1+2: vertex transform, projection, shading -> per-triangle planes


class TriPlanes(NamedTuple):
  """Per-triangle screen-space scalar planes (all [B, T])."""
  x0: torch.Tensor
  y0: torch.Tensor
  x1: torch.Tensor
  y1: torch.Tensor
  x2: torch.Tensor
  y2: torch.Tensor
  iz0: torch.Tensor    # 1/depth at vertices
  iz1: torch.Tensor
  iz2: torch.Tensor
  valid: torch.Tensor  # bool
  colp: torch.Tensor   # packed shaded colour r*65536 + g*256 + b (exact f32)


def _camera(r: Renderer, kin: Kin):
  """Camera world pose: (position [B, 3], rotation [B, 3, 3], cols = axes)."""
  model = r.model
  cb = model.cam_bodyid[r.cam_id]
  cam_pos = kin.xpos[:, cb] + gm.quat_rotate(kin.xquat[:, cb],
                                             model.cam_pos[r.cam_id])
  cam_quat = gm.quat_mul(kin.xquat[:, cb], model.cam_quat[r.cam_id])
  return cam_pos, gm.quat_to_mat(cam_quat)


def _vertex_world(r: Renderer, kin: Kin) -> torch.Tensor:
  """Transform all scene vertices into world space [B, V, 3]."""
  vg = r.const('vert_geom')
  return (kin.geom_xpos[:, vg] +
          gm.quat_rotate(kin.geom_xquat[:, vg], r.const('vert')))


def _project_and_shade(r: Renderer, kin: Kin, rgba: torch.Tensor,
                       cam=None, world=None, textures=None) -> TriPlanes:
  model, scene = r.model, r.scene
  H, W = r.height, r.width
  cam_pos, Rc = _camera(r, kin) if cam is None else cam
  if world is None:
    world = _vertex_world(r, kin)                       # [B, V, 3]

  pc = torch.einsum('zvi,zij->zvj', world - cam_pos[:, None], Rc)
  depth_v = -pc[..., 2]                                 # positive in front
  f = 1.0 / torch.tan(torch.deg2rad(model.cam_fovy[r.cam_id]) * 0.5)
  safe_d = torch.clamp(depth_v, min=1e-4)
  aspect = W / H
  u = (pc[..., 0] * f / (safe_d * aspect) * 0.5 + 0.5) * W
  v = (0.5 - pc[..., 1] * f / safe_d * 0.5) * H

  tri = r.const('tri')                                  # [T, 3]
  tg = r.const('tri_geom')                              # [T]
  i0, i1, i2 = tri[:, 0], tri[:, 1], tri[:, 2]
  x0, y0 = u[:, i0], v[:, i0]
  x1, y1 = u[:, i1], v[:, i1]
  x2, y2 = u[:, i2], v[:, i2]
  d0, d1, d2 = depth_v[:, i0], depth_v[:, i1], depth_v[:, i2]
  w0, w1, w2 = world[:, i0], world[:, i1], world[:, i2]

  valid = (d0 > r.znear) & (d1 > r.znear) & (d2 > r.znear)
  valid &= rgba[:, tg, 3] > 0.5                         # per-env visibility
  area = (x1 - x0) * (y2 - y0) - (y1 - y0) * (x2 - x0)
  valid &= area.abs() > 1e-8
  if r.cull:
    valid &= (area * r.cull) > 0

  # ---- flat shading per triangle
  n_w = gm.cross(w1 - w0, w2 - w0)
  n_w = n_w / torch.clamp(gm.norm(n_w, keepdim=True), min=1e-9)
  centroid = (w0 + w1 + w2) / 3.0
  to_cam = cam_pos[:, None] - centroid
  flip = torch.sign((n_w * to_cam).sum(-1, keepdim=True) + 1e-12)
  n_w = n_w * flip                     # double-sided: face the camera
  if model.nlight:
    if model.light_directional[0]:
      l = (-model.light_dir[0]).expand(centroid.shape)
    else:
      l = model.light_pos[0] - centroid
      l = l / torch.clamp(gm.norm(l, keepdim=True), min=1e-9)
  else:
    l = centroid.new_tensor([0.0, 0.0, 1.0]).expand(centroid.shape)
  diff = torch.clamp((n_w * l).sum(-1), min=0.0)
  if (r.shadows and model.nlight and scene.shadow_recv.size and
      (scene.shadow_cast.size or r.shadow_caps)):
    # shadowed receivers lose the light's diffuse term (ambient remains)
    diff = diff * (1.0 - _shadow_occlusion(r, kin, world))
  shade = torch.clamp(0.45 + 0.6 * diff, 0.0, 1.1)
  base = rgba[:, tg, :3]                                # [B, T, 3]
  if scene.tex_default.shape[0]:
    # textured triangles read their texel from the slot's [R, R] grid;
    # ``textures`` overrides the static texels for this render
    R2 = scene.tex_res * scene.tex_res
    slot = r.const('tri_texslot')
    idx = torch.clamp(slot, min=0) * R2 + r.const('tri_texel')
    if textures is None:
      trgb = r.const('tex_default').reshape(-1, 3)[idx]       # [T, 3]
    else:
      tex = torch.as_tensor(textures, dtype=torch.float32,
                            device=base.device)
      want = tuple(scene.tex_default.shape)
      if tuple(tex.shape[-4:]) != want or tex.dim() not in (4, 5):
        raise ValueError(f'textures must be {want} or [B, *{want}], got '
                         f'{tuple(tex.shape)}')
      trgb = tex.reshape(tex.shape[:-4] + (-1, 3))[..., idx, :]
    base = torch.where((slot >= 0)[:, None], trgb, base)
  c = torch.clamp(base * shade[..., None] * 255.0, 0.0, 255.0)
  colp = (torch.floor(c[..., 0]) * 65536.0 + torch.floor(c[..., 1]) * 256.0 +
          torch.floor(c[..., 2]))              # exact in f32 (< 2^24)

  iz0 = 1.0 / torch.clamp(d0, min=1e-6)
  iz1 = 1.0 / torch.clamp(d1, min=1e-6)
  iz2 = 1.0 / torch.clamp(d2, min=1e-6)
  return TriPlanes(x0, y0, x1, y1, x2, y2, iz0, iz1, iz2, valid, colp)


def _seg_seg_dist(p1: torch.Tensor, d1: torch.Tensor, pa: torch.Tensor,
                  pb: torch.Tensor) -> torch.Tensor:
  """Min distance between segments p1->p1+d1 ([B,P,3]) and pa->pb ([B,C,3]).

  Vectorised Ericson closest points of two segments; returns [B, P, C].
  """
  d2 = pb - pa                                          # [B, C, 3]
  rv = p1[:, :, None, :] - pa[:, None, :, :]            # [B, P, C, 3]
  a = (d1 * d1).sum(-1)[:, :, None]                     # [B, P, 1]
  e = (d2 * d2).sum(-1)[:, None, :]                     # [B, 1, C]
  f = torch.einsum('zcj,zpcj->zpc', d2, rv)
  c = torch.einsum('zpj,zpcj->zpc', d1, rv)
  b = torch.einsum('zpj,zcj->zpc', d1, d2)
  denom = a * e - b * b
  big = denom > 1e-12
  zero = torch.zeros((), dtype=denom.dtype, device=denom.device)
  one = torch.ones((), dtype=denom.dtype, device=denom.device)
  s = torch.clamp(torch.where(big, b * f - c * e, zero) /
                  torch.where(big, denom, one), 0.0, 1.0)
  t = torch.clamp((b * s + f) / torch.where(e > 1e-12, e, one), 0.0, 1.0)
  s = torch.clamp((b * t - c) / torch.where(a > 1e-12, a, one), 0.0, 1.0)
  q1 = p1[:, :, None, :] + s[..., None] * d1[:, :, None, :]
  q2 = pa[:, None, :, :] + t[..., None] * d2[:, None, :, :]
  return gm.norm(q1 - q2)


# casters per chunk of the Moller-Trumbore loop: bounds the [B, Pv, CC, 3]
# intermediates
_SHADOW_CHUNK = 64


def _occlude_points(r: Renderer, kin: Kin, world: torch.Tensor,
                    P: torch.Tensor) -> torch.Tensor:
  """Light-visibility test for world points P [B, Pv, 3] -> occlusion.

  Tests against (a) free-body triangles (Moller-Trumbore, in chunks of
  casters) and (b) the arm's capsule proxies (segment-segment distance).
  """
  model, scene = r.model, r.scene
  if model.light_directional[0]:
    d = (-model.light_dir[0] * 20.0).expand(P.shape)
  else:
    d = model.light_pos[0] - P                          # [B, Pv, 3]
  eps = 1e-3
  occ = P.new_zeros(P.shape[:2])

  ct = np.asarray(scene.shadow_cast)
  if ct.size:
    CC = min(_SHADOW_CHUNK, ct.size)
    pad = (-ct.size) % CC
    # pad with copies of the first caster: occlusion is an OR
    ct = np.concatenate([ct, np.full(pad, ct[0], ct.dtype)])
    tri_c = r.model.const('scene.shadow_cast_tri', np.asarray(scene.tri)[ct])
    for c0 in range(0, ct.size, CC):
      abc = tri_c[c0:c0 + CC]
      A, Bv, Cv = world[:, abc[:, 0]], world[:, abc[:, 1]], world[:, abc[:, 2]]
      e1 = (Bv - A)[:, None]                           # [B, 1, CC, 3]
      e2 = (Cv - A)[:, None]
      pv = gm.cross(d[:, :, None, :], e2)              # [B, Pv, CC, 3]
      det = (e1 * pv).sum(-1)
      ok = det.abs() > 1e-9
      inv = 1.0 / torch.where(ok, det, torch.ones_like(det))
      tv = P[:, :, None, :] - A[:, None]
      u = (tv * pv).sum(-1) * inv
      qv = gm.cross(tv, e1)
      v = (d[:, :, None, :] * qv).sum(-1) * inv
      t = (e2 * qv).sum(-1) * inv
      hit = (ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > eps) &
             (t < 1.0 - eps))
      occ = torch.maximum(occ, hit.any(-1).to(occ.dtype))

  if r.shadow_caps:
    gids = model.const('render.shadow_caps', r.shadow_caps)
    gp = kin.geom_xpos[:, gids]                         # [B, Nc, 3]
    gq = kin.geom_xquat[:, gids]
    ax = gm.quat_rotate(gq, gp.new_tensor([0.0, 0.0, 1.0]).expand(gp.shape))
    hl = model.geom_size[gids, 1][:, None]
    rad = model.geom_size[gids, 0]
    dist = _seg_seg_dist(P, d, gp - ax * hl, gp + ax * hl)
    occ = torch.maximum(occ, (dist < rad).any(-1).to(occ.dtype))
  return occ


def _shadow_occlusion(r: Renderer, kin: Kin, world: torch.Tensor
                      ) -> torch.Tensor:
  """Per-triangle shadow fraction [B, T] in [0, 1].

  Light visibility is tested once per unique receiver vertex, then averaged
  over each receiver triangle's 3 vertices.  Non-receivers get 0.
  """
  B = world.shape[0]
  P = world[:, r.const('shadow_pts')]                   # [B, Pv, 3]
  occ = _occlude_points(r, kin, world, P)
  occ_tri = occ[:, r.const('shadow_recv_pt')].mean(-1)  # [B, Rr]
  T = r.scene.tri.shape[0]
  out = occ.new_zeros((B, T))
  out[:, r.const('shadow_recv')] = occ_tri
  return out


def _pack_sky(sky_rgb) -> float:
  s = [int(np.clip(c * 255.0, 0, 255)) for c in sky_rgb]
  return float(s[0] * 65536 + s[1] * 256 + s[2])


def _unpack_col(colp: torch.Tensor) -> torch.Tensor:
  """Packed f32 colour plane -> uint8 [..., 3]."""
  ci = colp.to(torch.int32)
  return torch.stack([(ci // 65536) % 256, (ci // 256) % 256, ci % 256],
                     -1).to(torch.uint8)


# ---------------------------------------------------------------------------
# stage 3: binning


def _bbox_planes(tp: TriPlanes):
  lox = torch.minimum(torch.minimum(tp.x0, tp.x1), tp.x2)
  hix = torch.maximum(torch.maximum(tp.x0, tp.x1), tp.x2)
  loy = torch.minimum(torch.minimum(tp.y0, tp.y1), tp.y2)
  hiy = torch.maximum(torch.maximum(tp.y0, tp.y1), tp.y2)
  return lox, loy, hix, hiy


def _bin_priority(tp: TriPlanes, tile: int) -> torch.Tensor:
  """Per-triangle binning priority: 1/z of the nearest vertex (so overflow
  drops the farthest triangles), plus a large constant for triangles whose
  screen bbox can cover a whole fine tile (big background quads)."""
  izmax = torch.maximum(torch.maximum(tp.iz0, tp.iz1), tp.iz2)
  lox, loy, hix, hiy = _bbox_planes(tp)
  big = ((hix - lox) >= tile) & ((hiy - loy) >= tile)
  return izmax + 1e4 * big.to(izmax.dtype)


def _bin_hierarchical(r: Renderer, tp: TriPlanes) -> List[torch.Tensor]:
  """Hierarchical binning (the JAX package's ``_bin_pallas``).

  Coarse 4x4-fine-tile regions keep the top-K1 triangles by priority; mid
  2x2-fine-tile regions keep, in coarse order, the first K2 of their
  parent's candidates that overlap them.  Returns 11 planes
  (x0, y0, x1, y1, x2, y2, iz0, iz1, iz2, ok, colp), each [B, n_tiles, K2]
  in mid-major tile order (tile = mid * 4 + sub), with coordinates
  relative to each mid region's origin: the JAX planes transposed.
  """
  H, W, TS = r.height, r.width, r.tile
  ty, tx = H // TS, W // TS
  CS, MS = _COARSE, _MID
  cty, ctx = ty // CS, tx // CS
  mty, mtx = ty // MS, tx // MS
  n_coarse = cty * ctx
  n_mid = mty * mtx
  K1, K2 = r.coarse_k, r.mid_k
  lox, loy, hix, hiy = _bbox_planes(tp)
  B, T = lox.shape
  dev = lox.device

  # ---- coarse overlap -> top-K1 candidate ids per coarse region.  A stable
  # descending sort keeps the lower index first among equal priorities, as
  # jax.lax.top_k does (torch.topk leaves the order of ties unspecified).
  CTS = TS * CS
  cx0 = torch.arange(ctx, device=dev) * CTS
  cy0 = torch.arange(cty, device=dev) * CTS
  ox = (lox[..., None] < cx0 + CTS) & (hix[..., None] >= cx0)   # [B, T, ctx]
  oy = (loy[..., None] < cy0 + CTS) & (hiy[..., None] >= cy0)   # [B, T, cty]
  overlap_c = oy[..., :, None] & ox[..., None, :] & tp.valid[..., None, None]
  overlap_c = overlap_c.reshape(B, T, n_coarse).transpose(1, 2)
  prio = _bin_priority(tp, TS)
  prio_c = torch.where(overlap_c, prio[:, None, :], torch.zeros_like(
      prio[:, None, :]))                                # [B, n_coarse, T]
  cprio, cidx = torch.sort(prio_c, dim=-1, descending=True, stable=True)
  cprio, cidx = cprio[..., :K1], cidx[..., :K1]         # [B, n_coarse, K1]

  # ---- coarse attribute fetch
  flat_idx = cidx.reshape(B, -1)
  cplanes = [torch.gather(p, 1, flat_idx).reshape(B, n_coarse, K1)
             for p in (tp.x0, tp.y0, tp.x1, tp.y1, tp.x2, tp.y2, tp.iz0,
                       tp.iz1, tp.iz2, tp.colp)]
  cx0p, cy0p, cx1p, cy1p, cx2p, cy2p = cplanes[:6]
  c_ok = cprio > 0
  clox = torch.minimum(torch.minimum(cx0p, cx1p), cx2p)
  chix = torch.maximum(torch.maximum(cx0p, cx1p), cx2p)
  cloy = torch.minimum(torch.minimum(cy0p, cy1p), cy2p)
  chiy = torch.maximum(torch.maximum(cy0p, cy1p), cy2p)

  # ---- mid regions: the overlapping parent candidates, in parent order
  MTS = TS * MS
  mid = torch.arange(n_mid, device=dev)
  mx0 = ((mid % mtx) * MTS).to(lox.dtype)[:, None]      # [n_mid, 1]
  my0 = ((mid // mtx) * MTS).to(lox.dtype)[:, None]
  R_ = CS // MS                                         # mids per coarse side

  def rep(p):                         # [B, n_coarse, K1] -> [B, n_mid, K1]
    x = p.reshape(B, cty, 1, ctx, 1, K1).expand(B, cty, R_, ctx, R_, K1)
    return x.reshape(B, n_mid, K1)

  ovm = ((rep(clox) < mx0 + MTS) & (rep(chix) >= mx0) &
         (rep(cloy) < my0 + MTS) & (rep(chiy) >= my0) & rep(c_ok))
  # the JAX sort key is -(K1 - k) on overlapping slots and 0 elsewhere:
  # overlapping slots first in slot order, then the rest in slot order
  order = torch.argsort((~ovm).to(torch.int8), dim=-1, stable=True)
  order = order[..., :K2]                               # [B, n_mid, K2]
  m_ok = torch.gather(ovm, -1, order).to(lox.dtype)
  mplanes = [torch.gather(rep(p), -1, order) for p in cplanes]
  for i in range(6):
    mplanes[i] = mplanes[i] - (mx0 if i % 2 == 0 else my0)
  mplanes.insert(9, m_ok)                               # x0..iz2, ok, colp

  # ---- expand to fine tiles: [B, n_mid, K2] -> [B, n_tiles, K2] mid-major
  return [p.repeat_interleave(MS * MS, dim=1) for p in mplanes]


def _coeff_planes(planes: List[torch.Tensor], tile: int, mid_sub: int
                  ) -> torch.Tensor:
  """11 vertex planes [B, n_tiles, K] -> affine coefficients
  [B, n_tiles, 13, K] (the JAX package's ``_coeff_planes``).

  Each edge function and the interpolated inverse depth are affine in the
  pixel coordinates, e_i(p) = A_i*px + B_i*py + C_i.  Folded in once: the
  area-sign normalisation (inside becomes e_i >= 0), slot validity
  (invalid slots get C0 = -1e30, never inside) and the sub-tile offset of
  each fine tile within its mid region.  Runs in PyTorch before the kernel
  launch.  Row order: A0,B0,C0, A1,B1,C1, A2,B2,C2, Az,Bz,Cz, colp.
  """
  x0, y0, x1, y1, x2, y2, iz0, iz1, iz2, ok, colp = planes
  n_tiles = x0.shape[1]
  S = mid_sub
  a0, b0 = y0 - y1, x1 - x0
  c0 = -a0 * x0 - b0 * y0
  a1, b1 = y1 - y2, x2 - x1
  c1 = -a1 * x1 - b1 * y1
  a2, b2 = y2 - y0, x0 - x2
  c2 = -a2 * x2 - b2 * y2
  area = b0 * (y2 - y0) + a0 * (x2 - x0)   # == e0(v2), signed 2*area
  s = torch.sign(area)
  a0, b0, c0 = a0 * s, b0 * s, c0 * s
  a1, b1, c1 = a1 * s, b1 * s, c1 * s
  a2, b2, c2 = a2 * s, b2 * s, c2 * s
  inv_area = 1.0 / torch.clamp(area.abs(), min=1e-9)
  az = (a1 * iz0 + a2 * iz1 + a0 * iz2) * inv_area
  bz = (b1 * iz0 + b2 * iz1 + b0 * iz2) * inv_area
  cz = (c1 * iz0 + c2 * iz1 + c0 * iz2) * inv_area
  c0 = torch.where(ok > 0.5, c0, torch.full_like(c0, -1e30))
  # mid-relative -> fine-tile-relative (tile = mid * S^2 + sy * S + sx)
  sub = torch.arange(n_tiles, device=x0.device) % (S * S)
  ox = ((sub % S) * tile).to(x0.dtype)[:, None]        # [n_tiles, 1]
  oy = ((sub // S) * tile).to(x0.dtype)[:, None]
  c0 = c0 + a0 * ox + b0 * oy
  c1 = c1 + a1 * ox + b1 * oy
  c2 = c2 + a2 * ox + b2 * oy
  cz = cz + az * ox + bz * oy
  return torch.stack([a0, b0, c0, a1, b1, c1, a2, b2, c2, az, bz, cz, colp],
                     dim=2).contiguous()


def _compose_midmajor(buf: torch.Tensor, ty: int, tx: int, TS: int,
                      MS: int) -> torch.Tensor:
  """[B, n_tiles (mid-major), npx] -> [B, H, W] image."""
  B = buf.shape[0]
  mty, mtx = ty // MS, tx // MS
  x = buf.reshape(B, mty, mtx, MS, MS, TS, TS)   # (my, mx, sy, sx, py, px)
  x = x.permute(0, 1, 3, 5, 2, 4, 6)
  return x.reshape(B, ty * TS, tx * TS)


# ---------------------------------------------------------------------------


def _render(r: Renderer, kin: Kin, geom_rgba: torch.Tensor | None,
            textures: torch.Tensor | None = None):
  H, W, TS = r.height, r.width, r.tile
  ty, tx = H // TS, W // TS
  B = kin.xpos.shape[0]

  rgba = r.model.geom_rgba.expand(B, -1, -1) if geom_rgba is None \
      else geom_rgba
  cam = _camera(r, kin)
  world = _vertex_world(r, kin)
  tp = _project_and_shade(r, kin, rgba, cam=cam, world=world,
                          textures=textures)

  planes = _bin_hierarchical(r, tp)                     # [B, n_tiles, K2]
  coeffs = _coeff_planes(planes, TS, _MID)              # [B, n_tiles, 13, K2]
  izbuf, cbuf = raster_kernel.raster_tiles(coeffs, TS, _pack_sky(r.sky_rgb))
  inf = torch.full((), float('inf'), device=izbuf.device)
  depth = _compose_midmajor(
      torch.where(izbuf > 0.0, 1.0 / torch.clamp(izbuf, min=1e-9), inf),
      ty, tx, TS, _MID)
  cimg = _compose_midmajor(cbuf, ty, tx, TS, _MID)

  # background: pixels with no triangle nearer than zfar show the sky at
  # zfar depth (the JAX package's analytic layer with no rects)
  tri_wins = depth < r.zfar
  cimg = torch.where(tri_wins, cimg, torch.full_like(cimg,
                                                     _pack_sky(r.sky_rgb)))
  depth = torch.where(tri_wins, depth, torch.full_like(depth, r.zfar))
  return _unpack_col(cimg), depth                       # uint8 [B, H, W, 3]
