"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
no sparsity), at its full power limit of 700 W."""

import math

FLOPS = {
    'bfloat16': 989e12,
    'float16': 989e12,
    'tf32': 495e12,
    'float32': 67e12,          # outside the tensor cores
}
HBM_BYTES_PER_S = 3.35e12


def roofline_s(flops: float, nbytes: float, dtype: str = 'float32') -> float:
  """The least time the card could take: the larger of the operations over
  the peak rate of ``dtype`` and the bytes over the memory's bandwidth."""
  return max(flops / FLOPS[dtype], nbytes / HBM_BYTES_PER_S)


def seconds_at_peaks(flops_by_dtype: dict) -> float:
  """The least time counted operations take, each precision at its own
  peak rate: ``{dtype: operations}``."""
  return math.fsum(v / FLOPS[d] for d, v in flops_by_dtype.items())
