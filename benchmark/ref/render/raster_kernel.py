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
triangles that miss the tile.  ``subtile_plan`` cuts a tile into bands of
at most 32 patches of 4x2 pixels, and the kernel runs one warp per band
(four bands per block, no block barrier): it reads the tile's slots 32 at
a time with coalesced loads (the next chunk in flight while this one is
rasterized; a chunk none of whose slots' first edge reaches the band is
not loaded at all), drops every slot one of whose edge functions is
negative at all four corner pixels of the band (then it is negative at
every pixel of the band, so the slot can win none there; empty slots,
C0 = -1e30, go the same way), compacts the survivors in slot order into
shared memory, slot-major, and rasterizes them with a 4x2 patch of pixels
per lane that shares the coefficient loads (four float4 per slot) and the
rounded products ``a*px`` and ``b*py``.  Sides 4, 8, 12 and 16 are one
band that fills the tile (``kernel_limits``: the patch path), and at those
sides what is left is bound by reading the coefficients once.  Every other
side (``'general'``) takes the same kernel with the bands it needs: tile 32
is four bands of 16x16 pixels, each culled on its own corners; tile 10 is
one band of 3x5 patches whose pixels past the tile's edge are not stored.
``live_slots`` counts the slots each band keeps, as the kernel does, and
``loaded_chunks`` the chunks each band loads.  The kernel takes any K >= 0
and any tile side, with 8 KB of static shared memory per block whatever K
is.

Numerics: the kernel evaluates each affine form as ``(a*px + b*py) + c``
with rounded multiplies and adds and no FMA contraction (explicit
``__fmul_rn``/``__fadd_rn``, and ``--fmad=false``), in the twin's order, and
keeps the slot order (ties go to the lower slot), so the two agree bit for
bit on the same coefficients.
"""

from __future__ import annotations

import functools

import torch

N_COEFF = 13
_PATCH = (4, 2)           # pixels of a lane's patch, columns x rows
_LANES = 32               # patches a band holds at most: a warp's lanes


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


def subtile_plan(tile: int) -> tuple:
  """(band_w, band_h, bands): how the kernel cuts a tile into bands, one
  warp each.  A band is band_w x band_h pixels, band_w / 4 patches across
  and band_h / 2 down, at most 32 patches (one per lane); the bands are
  laid out row-major over the tile, ceil(tile / band_w) across, and the
  last row and column of bands may reach past the tile's edge (those pixels
  are neither culled against nor stored).  The plan takes the fewest bands,
  then the least band perimeter inside the tile (the slots that touch a
  band grow with its perimeter), then the wider band.  Raises on a side
  under one pixel."""
  kernel_limits(tile)
  return _plan(tile)


@functools.lru_cache(maxsize=None)
def _plan(tile: int) -> tuple:
  cols, rows = -(-tile // _PATCH[0]), -(-tile // _PATCH[1])
  best = None
  for across in range(1, min(cols, _LANES) + 1):
    nbx = -(-cols // across)
    nby = -(-rows // min(rows, _LANES // across))
    bw = _PATCH[0] * -(-cols // nbx)
    bh = _PATCH[1] * -(-rows // nby)
    perimeter = sum(2 * (min(bw, tile - x) + min(bh, tile - y))
                    for x in range(0, tile, bw) for y in range(0, tile, bh))
    key = (nbx * nby, perimeter, -bw)
    if best is None or key < best[0]:
      best = (key, (bw, bh, nbx * nby))
  return best[1]


def band_rects(tile: int, plan: tuple) -> list:
  """The pixels of each band of `plan` inside the tile, in the kernel's
  band order: (x_start, x_end, y_start, y_end), ends exclusive."""
  bw, bh, _ = plan
  return [(x, min(x + bw, tile), y, min(y + bh, tile))
          for y in range(0, tile, bh) for x in range(0, tile, bw)]


def _edge_misses(coeffs: torch.Tensor, rect: tuple, e: int):
  """[B, n_tiles, K] bool: edge function e of each slot is negative at all
  four corner pixel centres of the pixels ``rect`` (x_start, x_end,
  y_start, y_end; ends exclusive), evaluated as the kernel does,
  ``(a*px + b*py) + c`` in float32 (each product and sum rounded)."""
  x0, x1, y0, y1 = rect
  a, b, c = (coeffs[:, :, 3 * e + i] for i in range(3))
  out = [a * (x + 0.5) + b * (y + 0.5) + c < 0
         for x in (x0, x1 - 1) for y in (y0, y1 - 1)]
  return out[0] & out[1] & out[2] & out[3]


def live_slots(coeffs: torch.Tensor, tile: int, plan: tuple):
  """The slots each band's cull keeps, [B, n_tiles, bands, K] bool: those
  none of whose three edge functions is negative at all four corner pixel
  centres of the band.  ``.sum(-1)`` counts the slots a band
  rasterizes."""
  return torch.stack([~(_edge_misses(coeffs, r, 0) |
                        _edge_misses(coeffs, r, 1) |
                        _edge_misses(coeffs, r, 2))
                      for r in band_rects(tile, plan)], 2)


def loaded_chunks(coeffs: torch.Tensor, tile: int, plan: tuple):
  """The chunks of 32 slots (slots 32c .. 32c+31) each band loads whole,
  [B, n_tiles, bands, ceil(K / 32)] bool: those that hold a slot whose
  first edge function is not negative at all four corner pixel centres of
  the band (the cull's first term).  The kernel reads the first edge
  (rows 0-2) of every slot and all 13 rows of only these chunks; every
  slot ``live_slots`` keeps lies in one of them."""
  reach = torch.stack([~_edge_misses(coeffs, r, 0)
                       for r in band_rects(tile, plan)], 2)
  K = reach.shape[-1]
  reach = torch.nn.functional.pad(reach, (0, -K % _LANES))
  return reach.unflatten(-1, (-1, _LANES)).any(-1)


def kernel_limits(tile: int) -> str:
  """The CUDA kernel's path for a tile side: 'patch' (one band of 4x2-pixel
  patches, one per lane, that fills the tile: sides 4, 8, 12 and 16) or
  'general' (every other side of at least one pixel: the bands of
  ``subtile_plan``, each culled on its own corners, pixels past the tile's
  edge masked); raises on a side under one pixel.  (Any slot count K is
  taken: slots are read 32 at a time.)"""
  if tile < 1:
    raise ValueError(f'raster_tiles: tile={tile}: a tile side is at least '
                     'one pixel')
  if _plan(tile) == (tile, tile, 1):
    return 'patch'
  return 'general'


def raster_tiles(coeffs: torch.Tensor, tile: int, sky_packed: float):
  """Rasterize B*n_tiles tiles: (izbuf, cbuf), each [B, n_tiles, tile^2],
  by the plain twin on every device."""
  _check(coeffs, tile)
  return raster_tiles_reference(coeffs, tile, sky_packed)
