"""The benchmark's own tests (``pytest benchmark/tests``): CPU tests, and
tests marked ``card`` that run on the card and skip elsewhere."""

import pytest


def pytest_configure(config):
  config.addinivalue_line(
      'markers', 'card: needs a CUDA card; skips where there is none')


@pytest.fixture
def card():
  """The card, or a skip where there is none (decided when the test runs,
  never when a module is imported)."""
  import torch
  if not torch.cuda.is_available():
    pytest.skip('no CUDA card here: this test runs on the H100')
  return torch.device('cuda', 0)
