"""BENCHMARK.json against the benchmark's contract, and every name in it
found as a file by the harness."""

import json
import math
import os
import re

import pytest

from benchmark import run

ROOT = run.ROOT
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
PATH = re.compile(r'^[A-Za-z0-9_./-]{1,200}$')
KEYS = {'command', 'paths', 'run_seconds', 'configs', 'workloads',
        'end_to_end', 'per_layer'}
SOURCES = {'device_trace', 'program_span', 'program_counter', 'host_clock'}


@pytest.fixture(scope='module')
def manifest():
  return run.load_manifest()


def _line(text):
  return 1 <= len(text) <= 200 and '\n' not in text and '\t' not in text


def test_manifest_loads_with_the_contracts_keys(manifest):
  assert set(manifest) == KEYS
  assert os.path.getsize(os.path.join(ROOT, 'BENCHMARK.json')) <= 64 * 1024
  assert 1 <= len(manifest['command']) <= 32
  assert all(_line(w) for w in manifest['command'])
  assert 1 <= len(manifest['paths']) <= 16
  for p in manifest['paths']:
    assert PATH.match(p) and not p.startswith('/') and '..' not in p
    assert os.path.isdir(os.path.join(ROOT, p))
  assert isinstance(manifest['run_seconds'], int)
  assert 1 <= manifest['run_seconds'] <= 51


def test_run_seconds_fit_a_full_check_of_24_cells(manifest):
  runs = 2 + 14 * 24
  total = runs * (manifest['run_seconds'] + 60) + 24 * 2 * 90 + 1200
  assert total <= 43200


def test_entries_have_just_their_keys(manifest):
  for c in manifest['configs']:
    assert set(c) == {'name', 'source', 'file', 'reduced', 'why'}
  for w in manifest['workloads']:
    assert set(w) == {'name', 'config', 'traffic', 'chips', 'why'}
    assert w['chips'] in (1, 4)
  for m in manifest['end_to_end']:
    assert set(m) - {'workloads'} == {'name', 'unit', 'better', 'bound',
                                      'source'}
    assert m['source'] in ('host_clock', 'device_trace')
    assert 0 < m['bound'] <= 0.25
  for m in manifest['per_layer']:
    assert set(m) - {'workloads'} == {'name', 'unit', 'better', 'source',
                                      'layer', 'moves'}
    assert m['source'] in SOURCES


def test_every_name_and_unit_is_of_the_allowed_characters(manifest):
  names = ([c['name'] for c in manifest['configs']] +
           [w['name'] for w in manifest['workloads']] +
           [w['traffic'] for w in manifest['workloads']] +
           [m['name'] for k in ('end_to_end', 'per_layer')
            for m in manifest[k]] +
           [k for c in manifest['configs'] for k in c['reduced']])
  for n in names:
    assert NAME.match(n), n
  for k in ('end_to_end', 'per_layer'):
    for m in manifest[k]:
      assert UNIT.match(m['unit']), m['unit']
      assert m['better'] in ('lower', 'higher')
  for k in ('configs', 'workloads', 'end_to_end', 'per_layer'):
    got = [e['name'] for e in manifest[k]]
    assert len(got) == len(set(got))
  for w in manifest['workloads']:
    assert _line(w['why'])
  for c in manifest['configs']:
    assert _line(c['why']) and _line(c['source'])
  for m in manifest['per_layer']:
    assert _line(m['layer'])


def test_setup_s_is_an_end_to_end_metric_of_every_cell(manifest):
  setup = [m for m in manifest['end_to_end'] if m['name'] == 'setup_s']
  assert len(setup) == 1 and 'workloads' not in setup[0]
  assert setup[0]['bound'] <= 0.25


def test_every_cell_reports_an_end_to_end_and_a_per_layer_metric(manifest):
  for w in manifest['workloads']:
    e2e = run.metrics_of(manifest, 'end_to_end', w['name'])
    assert len([m for m in e2e if m['name'] != 'setup_s']) >= 1
    assert run.metrics_of(manifest, 'per_layer', w['name'])


def test_every_moves_is_reported_by_every_cell_of_its_metric(manifest):
  for m in manifest['per_layer']:
    for w in m.get('workloads', [x['name'] for x in manifest['workloads']]):
      e2e = {x['name'] for x in run.metrics_of(manifest, 'end_to_end', w)}
      assert m['moves'] in e2e, (m['name'], w)


def test_four_chip_cells_are_at_most_a_quarter(manifest):
  four = sum(w['chips'] == 4 for w in manifest['workloads'])
  assert four <= max(1, len(manifest['workloads']) // 4)


def test_every_name_is_found_as_a_file(manifest):
  files = set()
  for c in manifest['configs']:
    assert c['file'].startswith('benchmark/')
    files.add(c['file'])
    with open(os.path.join(ROOT, c['file'])) as f:
      conf = json.load(f)
    assert conf['reduced'] == c['reduced']
  assert len(files) == len(manifest['configs'])
  used = {w['config'] for w in manifest['workloads']}
  assert used == {c['name'] for c in manifest['configs']}
  for w in manifest['workloads']:
    _, config, traffic = run.load_cell(manifest, w['name'])
    assert os.path.isfile(os.path.join(run.HERE, 'kinds',
                                       traffic['kind'] + '.py'))
    assert set(traffic['limits']) and all(
        math.isfinite(v) for v in traffic['limits'].values())
  for m in manifest['per_layer']:
    assert os.path.isfile(os.path.join(run.HERE, 'metrics',
                                       m['name'] + '.py')), m['name']


def test_a_layer_has_one_spelling_for_its_metrics(manifest):
  by_module = {}
  for m in manifest['per_layer']:
    key = m['layer'].split(' (')[0]
    by_module.setdefault(key, set()).add(m['layer'])
  assert all(len(v) == 1 for v in by_module.values()), by_module


def test_a_run_without_a_card_fails_before_any_work(monkeypatch):
  import torch
  monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
  with pytest.raises(SystemExit):
    run.main(['--workload', 'pad2-cube2.collect-frames.b256', '--seed',
              '1', '--seconds', '1', '--trace', '0'])
