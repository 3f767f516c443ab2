"""Per-tile z-buffered rasterizer: the CUDA kernel's wrapper and its twin.

Replaces the JAX package's Pallas TPU kernel
``geeco_tpu/render/rasterizer.py::_raster_pallas_call`` (kernel body
``:809-834``).  It computes the same thing: for each fine tile (any side),
a z-buffer over the tile's K binned triangle slots in inverse-depth space.  A
pixel (centre px, py) is inside slot k when all three affine edge functions
``A*px + B*py + C`` are >= 0; the slot wins the pixel when its interpolated
inverse depth is larger than the buffer's.  Colour is the packed
r*65536 + g*256 + b float, starting as sky; inverse depth starts at 0.

Input: the 13 affine-coefficient rows of ``rasterizer._coeff_planes``,
tile-major ``coeffs [B, n_tiles, 13, K]`` float32, contiguous.  The layout
is the one the port has had from the start: the kernel itself compacts the
slots and turns them slot-major while it stages them, so ``_coeff_planes``
and the twin keep it.
Output: ``izbuf, cbuf [B, n_tiles, tile*tile]`` float32 (pixel p of a tile
is row p // tile, column p % tile).

``raster_tiles`` launches the CUDA kernel (``csrc/raster_tiles.cu``) for a
tensor on the card and runs the plain twin ``raster_tiles_reference`` for a
tensor on the CPU; any other device raises.  Nothing falls back.

What bounds the kernel on an H100, and its design: tested against all K
slots a pixel costs ~35 instructions per slot and the loop is bound by
the instruction rate; but most slots of a real tile are empty or belong to
triangles that miss the tile.  The kernel runs one warp per tile (four
tiles per block, no block barrier): it reads the slots 32 at a time with
coalesced loads (the next chunk in flight while this one is rasterized),
drops every slot one of whose edge functions is negative at all four corner
pixels of the tile (then it is negative at every pixel, so the slot can win
none; empty slots, C0 = -1e30, go the same way), compacts the survivors in
slot order into shared memory, slot-major, and rasterizes them with a 4x2
patch of pixels per lane that shares the coefficient loads (four float4 per
slot) and the rounded products ``a*px`` and ``b*py``.  What is left is bound
by reading the coefficients once.  The kernel takes any K >= 0 and any
tile side (``kernel_limits``): sides of 4, 8, 12 and 16 take the patch
path above; every other side (10, 20, 32, ...) takes a general path with the
same staging and cull, eight pixels strided by 32 per lane, the tile swept
in passes of 256 pixels.  Both use 8 KB of static shared memory per block
whatever K is.

Numerics: the kernel evaluates each affine form as ``(a*px + b*py) + c``
with rounded multiplies and adds and no FMA contraction (explicit
``__fmul_rn``/``__fadd_rn``, and ``--fmad=false``), in the twin's order, and
keeps the slot order (ties go to the lower slot), so the two agree bit for
bit on the same coefficients.
"""

from __future__ import annotations

import ctypes

import torch

N_COEFF = 13
_PATCH = (4, 2)           # pixels per lane of the patch path, columns x rows
_MAX_PATCH_TILE = 16      # 32 lanes x 8 pixels


def _pixel_centres(tile: int, like: torch.Tensor):
  lin = torch.arange(tile * tile, device=like.device)
  px = (lin % tile).to(like.dtype) + 0.5
  py = (lin // tile).to(like.dtype) + 0.5
  return px, py


def raster_tiles_reference(coeffs: torch.Tensor, tile: int,
                           sky_packed: float):
  """Plain PyTorch twin of the kernel: a loop over the K slots,
  vectorised over [B, n_tiles, npx]."""
  B, n_tiles, _, K = coeffs.shape
  npx = tile * tile
  px, py = _pixel_centres(tile, coeffs)
  izbuf = coeffs.new_zeros((B, n_tiles, npx))
  cbuf = coeffs.new_full((B, n_tiles, npx), sky_packed)
  for k in range(K):
    c = coeffs[:, :, :, k, None]                        # [B, n_tiles, 13, 1]
    e0 = c[:, :, 0] * px + c[:, :, 1] * py + c[:, :, 2]
    e1 = c[:, :, 3] * px + c[:, :, 4] * py + c[:, :, 5]
    e2 = c[:, :, 6] * px + c[:, :, 7] * py + c[:, :, 8]
    izv = c[:, :, 9] * px + c[:, :, 10] * py + c[:, :, 11]
    closer = ((torch.minimum(torch.minimum(e0, e1), e2) >= 0.0) &
              (izv > izbuf))
    izbuf = torch.where(closer, izv, izbuf)
    cbuf = torch.where(closer, c[:, :, 12], cbuf)
  return izbuf, cbuf


def _check(coeffs: torch.Tensor, tile: int):
  if coeffs.dtype != torch.float32:
    raise TypeError(f'coeffs must be float32, got {coeffs.dtype}')
  if coeffs.ndim != 4 or coeffs.shape[2] != N_COEFF:
    raise ValueError(f'coeffs must be [B, n_tiles, {N_COEFF}, K], got '
                     f'{tuple(coeffs.shape)}')
  if not coeffs.is_contiguous():
    raise ValueError('coeffs must be contiguous')
  kernel_limits(tile)


def kernel_limits(tile: int) -> str:
  """The CUDA kernel's path for a tile side: 'patch' (one 4x2-pixel patch
  per lane of a warp: sides 4, 8, 12 and 16) or 'general' (every other side
  of at least one pixel); raises on a side under one pixel.  (Any slot
  count K is taken: slots are read 32 at a time.)"""
  if tile < 1:
    raise ValueError(f'raster_tiles: tile={tile}: a tile side is at least '
                     'one pixel')
  if tile % _PATCH[0] == 0 and tile <= _MAX_PATCH_TILE:
    return 'patch'
  return 'general'


def raster_tiles(coeffs: torch.Tensor, tile: int, sky_packed: float):
  """Rasterize B*n_tiles tiles: (izbuf, cbuf), each [B, n_tiles, tile^2].

  CUDA tensor: launches the kernel on the current stream and counts the
  launch in ``raster_tiles.launches``.  CPU tensor: the plain twin.
  """
  _check(coeffs, tile)
  if coeffs.device.type == 'cpu':
    return raster_tiles_reference(coeffs, tile, sky_packed)
  if coeffs.device.type != 'cuda':
    raise ValueError(f'raster_tiles: no kernel for device {coeffs.device}')
  from ..utils import build
  lib = build.load_kernels()
  B, n_tiles, _, K = coeffs.shape
  npx = tile * tile
  izbuf = torch.empty((B, n_tiles, npx), dtype=torch.float32,
                      device=coeffs.device)
  cbuf = torch.empty_like(izbuf)
  stream = torch.cuda.current_stream(coeffs.device).cuda_stream
  with torch.cuda.device(coeffs.device):
    err = lib.raster_tiles_f32(
        ctypes.c_void_p(coeffs.data_ptr()), ctypes.c_void_p(izbuf.data_ptr()),
        ctypes.c_void_p(cbuf.data_ptr()), B * n_tiles, K, tile,
        ctypes.c_float(sky_packed), ctypes.c_void_p(stream))
  if err != 0:
    raise RuntimeError('raster_tiles launch failed: ' +
                       lib.geeco_cuda_error_string(err).decode())
  raster_tiles.launches += 1
  return izbuf, cbuf


raster_tiles.launches = 0
