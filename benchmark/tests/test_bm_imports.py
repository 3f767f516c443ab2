"""No module of the benchmark imports JAX or the JAX package, and the plain
reference imports nothing of the port (top-level names compared whole:
``geeco_tpu_torch`` begins with ``geeco_tpu``)."""

import ast
import os

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {'jax', 'jaxlib', 'flax', 'optax', 'geeco_tpu'}
# the parts of the yardstick that take nothing from the program
YARDSTICK = ('ref', 'counts')


def _modules():
  for dirpath, _, files in os.walk(HERE):
    for f in files:
      if f.endswith('.py'):
        yield os.path.join(dirpath, f)


def _imports(path):
  """Top-level names of the absolute imports of ``path``, and the relative
  imports resolved inside the benchmark package."""
  with open(path) as f:
    tree = ast.parse(f.read(), path)
  rel = os.path.relpath(path, os.path.dirname(HERE))
  package = os.path.dirname(rel).split(os.sep)
  out = set()
  for node in ast.walk(tree):
    if isinstance(node, ast.Import):
      out |= {a.name.split('.')[0] for a in node.names}
    elif isinstance(node, ast.ImportFrom):
      if node.level == 0:
        out.add(node.module.split('.')[0])
      else:
        base = package[:len(package) - node.level + 1]
        out.add(base[0] if base else '')
  return out


def test_the_scan_compares_whole_top_level_names(tmp_path):
  p = tmp_path / 'm.py'
  p.write_text('import geeco_tpu_torch.envs\nfrom jax import numpy\n')
  assert _imports(str(p)) == {'geeco_tpu_torch', 'jax'}
  assert 'geeco_tpu_torch' not in FORBIDDEN


@pytest.mark.parametrize('path', sorted(_modules()),
                         ids=lambda p: os.path.relpath(p, HERE))
def test_no_module_imports_jax_or_the_jax_package(path):
  assert not _imports(path) & FORBIDDEN


@pytest.mark.parametrize('part', YARDSTICK)
def test_the_yardstick_imports_nothing_of_the_port(part):
  for path in _modules():
    if os.path.relpath(path, HERE).split(os.sep)[0] == part:
      assert 'geeco_tpu_torch' not in _imports(path), path
