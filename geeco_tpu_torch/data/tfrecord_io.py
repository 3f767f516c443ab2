"""Reference-format TFRecord episode export (native C++ encoder).

The port's own copy of ``geeco_tpu/data/tfrecord_io.py``.  Writes
zlib-compressed TFRecord files of tf.train.SequenceExample protos with the
exact V4 schema of the reference recorder (src/data/data_recorder.py:37-156
+ src/data/geeco_gym.py:54-158), so a dataset collected here can be parsed
by the reference's ``pickplace_input_fn_v4`` unchanged, and its bytes are
those the JAX package writes.  Encoding/framing/compression run in
geeco_tpu_torch/native/tfrecord.cpp, built with g++ at first use
(``utils/build.py::load_native``) and called through ctypes; this module is
the schema layer.

Also includes a dependency-free reader (protobuf wire parser + zlib) used
for round-trip verification — the rebuild's analogue of the reference
notebook's np.allclose re-read checks.
"""

from __future__ import annotations

import ctypes
import json
import os
import struct
import zlib
from typing import Dict, List

import numpy as np

from ..utils.build import load_native

_LIB = None


def _lib():
  global _LIB
  if _LIB is None:
    _LIB = load_native('tfrecord')
    _LIB.tfr_open.restype = ctypes.c_void_p
    _LIB.tfr_open.argtypes = [ctypes.c_char_p, ctypes.c_int]
    _LIB.tfr_close.argtypes = [ctypes.c_void_p]
    _LIB.tfr_example_begin.argtypes = [ctypes.c_void_p]
    _LIB.tfr_example_end.argtypes = [ctypes.c_void_p]
    _LIB.tfr_context_floats.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int64]
    _LIB.tfr_context_ints.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int64]
    _LIB.tfr_context_bytes_list.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_void_p, ctypes.c_int64]
    _LIB.tfr_featurelist_floats.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_int64]
    _LIB.tfr_featurelist_ints.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_int64]
  return _LIB


class TfrWriter:
  """Low-level writer: one file, many SequenceExamples."""

  def __init__(self, path: str, compression: str = 'zlib'):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    self._h = _lib().tfr_open(path.encode(), 1 if compression == 'zlib'
                              else 0)
    if not self._h:
      raise IOError(f'cannot open {path}')

  def write_example(self, context: Dict, feature_lists: Dict):
    """context: key -> scalar/int/str/list[str]/float array, or a dict,
    written as its JSON text (the meta's renderer_kwargs; the JAX package's
    writer raises on it); feature_lists: key -> float/int array [T, ...]
    (flattened per frame)."""
    lib = _lib()
    lib.tfr_example_begin(self._h)
    for key, val in context.items():
      kb = key.encode()
      if isinstance(val, dict):
        self._ctx_bytes(kb, [json.dumps(val, sort_keys=True).encode()])
      elif isinstance(val, str):
        arr = [val.encode()]
        self._ctx_bytes(kb, arr)
      elif isinstance(val, (list, tuple)) and val and \
              isinstance(val[0], str):
        self._ctx_bytes(kb, [v.encode() for v in val])
      elif isinstance(val, (int, np.integer)):
        a = np.asarray([val], np.int64)
        lib.tfr_context_ints(self._h, kb, a.ctypes.data, 1)
      else:
        a = np.ascontiguousarray(np.asarray(val, np.float32).reshape(-1))
        lib.tfr_context_floats(self._h, kb, a.ctypes.data, a.size)
    for key, val in feature_lists.items():
      kb = key.encode()
      arr = np.asarray(val)
      T = arr.shape[0]
      flat = np.ascontiguousarray(arr.reshape(T, -1))
      if np.issubdtype(arr.dtype, np.integer):
        flat = flat.astype(np.int64)
        lib.tfr_featurelist_ints(self._h, kb, flat.ctypes.data, T,
                                 flat.shape[1])
      else:
        flat = flat.astype(np.float32)
        lib.tfr_featurelist_floats(self._h, kb, flat.ctypes.data, T,
                                   flat.shape[1])
    lib.tfr_example_end(self._h)

  def _ctx_bytes(self, key: bytes, values: List[bytes]):
    lib = _lib()
    arr = (ctypes.c_char_p * len(values))(*values)
    lens = np.asarray([len(v) for v in values], np.int64)
    lib.tfr_context_bytes_list(self._h, key, arr, lens.ctypes.data,
                               len(values))

  def close(self):
    if self._h:
      _lib().tfr_close(self._h)
      self._h = None

  def __enter__(self):
    return self

  def __exit__(self, *a):
    self.close()


# -------------------------------------------------------------- V4 schema


def write_episode_tfrecord(path: str, records: Dict, context: Dict,
                           compression: str = 'zlib'):
  """Episode records (stacked arrays from data/episode.py) -> one
  SequenceExample in a .tfrecord[.zlib] file, V4 schema."""
  ctx = dict(context)
  feature_lists = {}
  for key, arr in records.items():
    arr = np.asarray(arr)
    if key == 'step':
      feature_lists['step'] = arr.astype(np.int64)
    elif key == 'rgb':
      # reference stores uint8 pixel values as float lists
      # (src/data/utils/tfrecord.py:73)
      feature_lists['rgb'] = arr.astype(np.float32)
    else:
      feature_lists[key] = arr.astype(np.float32)
  with TfrWriter(path, compression) as w:
    w.write_example(ctx, feature_lists)


# -------------------------------------------------------------- reader


def _read_varint(buf: memoryview, pos: int):
  result = 0
  shift = 0
  while True:
    b = buf[pos]
    pos += 1
    result |= (b & 0x7f) << shift
    if not b & 0x80:
      return result, pos
    shift += 7


def _parse_message(data: memoryview):
  """Generic protobuf parse: field -> list of (wire_type, value)."""
  fields: Dict[int, List] = {}
  pos = 0
  n = len(data)
  while pos < n:
    tag, pos = _read_varint(data, pos)
    field, wire = tag >> 3, tag & 7
    if wire == 0:
      val, pos = _read_varint(data, pos)
    elif wire == 2:
      length, pos = _read_varint(data, pos)
      val = data[pos:pos + length]
      pos += length
    elif wire == 5:
      val = bytes(data[pos:pos + 4])
      pos += 4
    elif wire == 1:
      val = bytes(data[pos:pos + 8])
      pos += 8
    else:
      raise ValueError(f'wire type {wire}')
    fields.setdefault(field, []).append(val)
  return fields


def _parse_feature(data: memoryview):
  f = _parse_message(data)
  if 2 in f:  # float_list
    inner = _parse_message(f[2][0])
    packed = inner.get(1, [b''])[0]
    return np.frombuffer(bytes(packed), np.float32)
  if 3 in f:  # int64_list
    inner = _parse_message(f[3][0])
    packed = inner.get(1, [b''])[0]
    vals, pos = [], 0
    mv = memoryview(bytes(packed))
    while pos < len(mv):
      v, pos = _read_varint(mv, pos)
      vals.append(v)
    return np.asarray(vals, np.int64)
  if 1 in f:  # bytes_list
    inner = _parse_message(f[1][0])
    return [bytes(v) for v in inner.get(1, [])]
  return np.zeros(0)


def read_tfrecord(path: str, compression: str = 'zlib'):
  """Parse all SequenceExamples. Returns list of (context, feature_lists)."""
  with open(path, 'rb') as fp:
    raw = fp.read()
  if compression == 'zlib':
    raw = zlib.decompress(raw)
  out = []
  pos = 0
  mv = memoryview(raw)
  while pos < len(raw):
    (length,) = struct.unpack('<Q', raw[pos:pos + 8])
    pos += 12  # skip length crc
    payload = mv[pos:pos + length]
    pos += length + 4  # skip data crc
    msg = _parse_message(payload)
    context = {}
    for entry in _parse_message(msg[1][0]).get(1, []) if 1 in msg else []:
      e = _parse_message(entry)
      key = bytes(e[1][0]).decode()
      context[key] = _parse_feature(e[2][0])
    lists = {}
    for entry in _parse_message(msg[2][0]).get(1, []) if 2 in msg else []:
      e = _parse_message(entry)
      key = bytes(e[1][0]).decode()
      frames = [_parse_feature(fv)
                for fv in _parse_message(e[2][0]).get(1, [])]
      lists[key] = frames
    out.append((context, lists))
  return out
