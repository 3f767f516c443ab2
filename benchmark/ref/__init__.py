"""The plain reference that decides ``correct``: the port's plain path,
frozen into the benchmark.

Each module here is a copy of the ``geeco_tpu_torch`` module of the same
path as it stood when the benchmark was added, with its imports kept
relative, so that nothing here imports the port and a later change to the
port does not move the reference.  What differs from the copied modules:

  * ``render/raster_kernel.py``: ``raster_tiles`` runs the plain twin
    (``raster_tiles_reference``) on every device; no CUDA kernel is built.
  * ``physics/solver.py``: the fused solve (``solver_method='pallas'``, the
    CUDA kernel K2) raises; the plain ``psd`` iteration and the others stay.
  * ``models/train.py``: no data parallelism (no ``mesh``, no
    ``torch.distributed``; the sharding helpers are left out).
  * ``envs/base.py``: ``ASSET_ROOT`` points at ``geeco_tpu/assets_gym`` at
    the root of the checkout, the raw files both sides read.

The reference runs with TF32 off (``GeecoEnv`` sets it, and the check sets
it again before every comparison); its control is the same code with TF32
on.
"""
