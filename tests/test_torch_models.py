"""Port parity (model): geeco_tpu_torch.models.e2evmc against the JAX
package's flax E2E-VMC on the CPU, from the same perturbed flax parameters
carried across by ``convert.e2evmc_params_from_reference``.

The flax heads are zero-initialised (every prediction 0 at init), so every
parameter is perturbed with seeded noise before it is converted.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geeco_tpu.models import e2evmc as JE
from geeco_tpu.models.params import create_e2evmc_config
from geeco_tpu_torch.core.convert import e2evmc_params_from_reference
from geeco_tpu_torch.models import e2evmc as TE
from geeco_tpu_torch.models import params as TP

torch.set_num_threads(1)

S = 32      # frame side: the encoders reach 1x1 maps (padding (1, 1))
N = 2
CFG = dict(img_height=S, img_width=S, window_size=4, dim_s_obs=32,
           dim_s_dyn=32, dim_s_diff=32, dim_h_lstm=16, dim_h_fc=16,
           compute_dtype='float32')
# float32: the same graph with its sums in another order
F32_TOL = dict(rtol=1e-4, atol=1e-6)
# bfloat16 convolutions (8 bits of mantissa) through 8 layers in each
# engine: the heads within 5% of their largest value, the carry within 0.05
BF16_REL = 5e-2
VARIANTS = [(False, 'sequence', 'constant'), (True, 'sequence', 'constant'),
            (True, 'sequence', 'residual'), (True, 'sequence', 'dyndiff'),
            (True, 'dynimg', 'dyndiff')]


def _cfg(**kw):
  d = dict(CFG)
  d.update(kw)
  return create_e2evmc_config(d)


def _inputs(cfg, seed=0):
  rng = np.random.RandomState(seed)
  K = cfg.window_size
  return (rng.rand(N, K, S, S, 3).astype(np.float32),
          rng.randn(N, K, 7).astype(np.float32),
          rng.rand(N, S, S, 3).astype(np.float32),
          tuple(rng.randn(N, cfg.dim_h_lstm).astype(np.float32)
                for _ in range(2)))


def _pair(cfg, goal, seed=0):
  """(flax module, perturbed flax params, port model with those params)."""
  jm = JE.make_model(cfg, goal)
  frames, jnt, tgt, _ = _inputs(cfg)
  args = (frames, jnt, tgt) if goal else (frames, jnt)
  params = jax.jit(lambda k: jm.init(k, *args, None, jnp.asarray(True)))(
      jax.random.PRNGKey(seed))['params']
  rng = np.random.RandomState(seed + 1)
  params = jax.tree.map(lambda x: (np.asarray(x) + 0.05 * rng.randn(
      *x.shape)).astype(np.float32), params)
  tm = TE.make_model(cfg, goal, device='cpu')
  tm.load_state_dict(e2evmc_params_from_reference(params))
  return jm, params, tm


def _run_both(cfg, goal, reset):
  jm, params, tm = _pair(cfg, goal)
  frames, jnt, tgt, carry = _inputs(cfg)
  args = (frames, jnt, tgt) if goal else (frames, jnt)
  ep, c = jax.jit(lambda p, c: jm.apply({'params': p}, *args, c,
                                        jnp.asarray(reset)))(params, carry)
  with torch.no_grad():
    tep, tc = tm(*(torch.as_tensor(a) for a in args),
                 tuple(torch.as_tensor(x) for x in carry), reset)
  return ep, c, tep, tc


def test_dynimg_matches_jax():
  for K in (2, 3, 4, 8):
    np.testing.assert_allclose(TE.dynimg_coefficients(K).numpy(),
                               np.asarray(JE.dynimg_coefficients(K)),
                               rtol=1e-6, atol=1e-7)
  np.testing.assert_allclose(TE.dynimg_coefficients(2).numpy(), [-0.5, 0.5],
                             atol=1e-6)
  frames = np.random.RandomState(0).rand(3, 4, 8, 8, 3).astype(np.float32)
  got = TE.dynimg(torch.as_tensor(frames)).numpy()
  np.testing.assert_allclose(got, np.asarray(JE.dynimg(jnp.asarray(frames))),
                             rtol=1e-5, atol=1e-6)
  assert got.min() >= 0.0 and got.max() <= 1.0


@pytest.mark.parametrize('goal,proc_obs,proc_tgt', VARIANTS)
def test_forward_matches_jax(goal, proc_obs, proc_tgt):
  """Heads, the carry and the dynbuff/dyndiff extras of one window, with a
  carry passed in (reset False), float32."""
  cfg = _cfg(proc_obs=proc_obs, proc_tgt=proc_tgt)
  ep, c, tep, tc = _run_both(cfg, goal, False)
  assert set(tep) == set(ep)
  for k, v in ep.items():
    assert tep[k].shape == v.shape, k
    np.testing.assert_allclose(tep[k].numpy(), np.asarray(v), err_msg=k,
                               **F32_TOL)
  for got, ref in zip(tc, c):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **F32_TOL)
  if goal and proc_tgt == 'dyndiff':
    assert tep['dyndiff'].shape == (N, S, S, 3)
  if goal and proc_obs == 'dynimg':
    assert tep['dynbuff'].shape == (N, S, S, 3)


def test_forward_bf16_matches_jax():
  """compute_dtype='bfloat16' (bf16 convolutions, float32 GroupNorm
  statistics, LSTM and heads) in both engines, the flagship variant."""
  cfg = _cfg(proc_obs='dynimg', proc_tgt='dyndiff',
             compute_dtype='bfloat16')
  ep, c, tep, tc = _run_both(cfg, True, True)
  for k in ('pred_cmd_ee', 'logits_cmd_grp', 'pred_aux_ee', 'pred_aux_obj'):
    ref = np.asarray(ep[k])
    np.testing.assert_allclose(tep[k].numpy(), ref, rtol=0,
                               atol=BF16_REL * np.abs(ref).max(), err_msg=k)
  for got, ref in zip(tc, c):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=BF16_REL)
  assert tep['pred_cmd_ee'].dtype == torch.float32


def test_lstm_reset_semantics():
  """reset=True ignores the carry passed in, reset=False uses it, and a
  per-env reset [n] mixes the two row by row."""
  cfg = _cfg()
  _, _, tm = _pair(cfg, False)
  frames, jnt, _, carry = _inputs(cfg, seed=1)
  f, j = torch.as_tensor(frames), torch.as_tensor(jnt)
  c = tuple(torch.as_tensor(x) for x in carry)
  with torch.no_grad():
    ep_zero, _ = tm(f, j, None, True)
    ep_reset, _ = tm(f, j, c, True)
    ep_cont, _ = tm(f, j, c, False)
    ep_mix, _ = tm(f, j, c, torch.tensor([True, False]))
  torch.testing.assert_close(ep_reset['pred_cmd_ee'], ep_zero['pred_cmd_ee'],
                             rtol=0, atol=1e-6)
  assert not torch.allclose(ep_cont['pred_cmd_ee'], ep_reset['pred_cmd_ee'])
  torch.testing.assert_close(ep_mix['pred_cmd_ee'][0],
                             ep_reset['pred_cmd_ee'][0], rtol=0, atol=1e-6)
  torch.testing.assert_close(ep_mix['pred_cmd_ee'][1],
                             ep_cont['pred_cmd_ee'][1], rtol=0, atol=1e-6)


def test_converter_takes_every_leaf():
  """Every flax leaf lands in one state_dict entry and back: strict load,
  equal counts, each tensor the leaf transposed as documented."""
  cfg = _cfg(proc_obs='dynimg', proc_tgt='dyndiff')
  _, params, tm = _pair(cfg, True)
  sd = e2evmc_params_from_reference(params)
  assert set(sd) == set(tm.state_dict())
  assert sum(t.numel() for t in sd.values()) == sum(
      x.size for x in jax.tree.leaves(params)) == TE.count_parameters(tm)
  enc = params['DynDiffEncoder']
  np.testing.assert_array_equal(sd['enc_diff.conv3.weight'].numpy(),
                                enc['conv3']['kernel'].transpose(3, 2, 0, 1))
  np.testing.assert_array_equal(sd['enc_diff.gn8.weight'].numpy(),
                                enc['gn8']['scale'])
  lstm = params['LSTMDecoder']['lstm']
  H = cfg.dim_h_lstm
  for i, g in enumerate('ifgo'):
    np.testing.assert_array_equal(
        sd['decoder.lstm.ih.weight'][i * H:(i + 1) * H].numpy(),
        lstm['i' + g]['kernel'].T)
    np.testing.assert_array_equal(
        sd['decoder.lstm.hh.bias'][i * H:(i + 1) * H].numpy(),
        lstm['h' + g]['bias'])
  bad = jax.tree.map(lambda x: x, params)
  bad['LSTMDecoder']['fc1']['extra'] = np.zeros(3, np.float32)
  with pytest.raises(ValueError, match='extra'):
    e2evmc_params_from_reference(bad)


def test_flagship_parameter_count():
  """The r4/r5 production model (goal, dynimg/dyndiff, 256^2): 7,560,188
  parameters in both engines, leaf shapes equal."""
  cfg = create_e2evmc_config({'proc_obs': 'dynimg', 'proc_tgt': 'dyndiff'})
  jm = JE.make_model(cfg, True)
  z = jnp.zeros
  shapes = jax.eval_shape(lambda: jm.init(
      jax.random.PRNGKey(0), z((1, 4, 256, 256, 3)), z((1, 4, 7)),
      z((1, 256, 256, 3)), None, jnp.asarray(True)))['params']
  tm = TE.make_model(cfg, True, device='cpu')
  assert TE.count_parameters(tm) == JE.count_parameters(shapes) == 7_560_188
  sd = e2evmc_params_from_reference(
      jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes))
  assert {k: tuple(v.shape) for k, v in sd.items()} == {
      k: tuple(v.shape) for k, v in tm.state_dict().items()}


def test_init_follows_flax_distributions():
  """Zero heads (every prediction exactly 0), unit GroupNorm scales, zero
  biases, orthogonal recurrent blocks, lecun-normal kernels truncated at
  two standard deviations; one generator seed, one model."""
  cfg = _cfg(proc_obs='dynimg', proc_tgt='dyndiff')
  tm = TE.make_model(cfg, True, device='cpu',
                     generator=torch.Generator().manual_seed(0))
  frames, jnt, tgt, _ = _inputs(cfg)
  with torch.no_grad():
    ep, _ = tm(torch.as_tensor(frames), torch.as_tensor(jnt),
               torch.as_tensor(tgt))
  for k in ('pred_cmd_ee', 'logits_cmd_grp', 'pred_aux_ee', 'pred_aux_obj'):
    assert bool((ep[k] == 0).all()), k
  sd = tm.state_dict()
  assert bool((sd['enc_obs.gn4.weight'] == 1).all())
  assert bool((sd['enc_obs.conv4.bias'] == 0).all())
  H = cfg.dim_h_lstm
  for block in sd['decoder.lstm.hh.weight'].split(H):
    torch.testing.assert_close(block @ block.T, torch.eye(H), rtol=0,
                               atol=1e-5)
  w = sd['enc_obs.conv6.weight']                  # fan_in 9 * 192
  std = (1.0 / (9 * 192)) ** 0.5
  assert abs(float(w.std()) / std - 1.0) < 0.05
  assert float(w.abs().max()) <= 2 * std / 0.87962566103423978 + 1e-6
  again = TE.make_model(cfg, True, device='cpu',
                        generator=torch.Generator().manual_seed(0))
  assert all(torch.equal(a, b) for a, b in zip(
      sd.values(), again.state_dict().values()))


@pytest.mark.parametrize('n', [1, 2, 3, 4, 7, 16, 31, 64, 256])
@pytest.mark.parametrize('stride', [1, 2])
def test_same_padding_is_xlas(n, stride):
  assert TE._same_pads(n, stride) == tuple(
      jax.lax.padtype_to_pads((n,), (3,), (stride,), 'SAME')[0])


def test_params_module_is_the_jax_packages():
  from geeco_tpu.models import params as JP
  assert JP.E2E_VMC_DEFAULT_PARAM_DICT == TP.E2E_VMC_DEFAULT_PARAM_DICT
  assert JP.E2EVMCConfig().asdict() == TP.E2EVMCConfig().asdict()


def test_make_model_defaults_to_the_card():
  if torch.cuda.is_available():
    pytest.skip('a CUDA device is present: the default builds there')
  with pytest.raises(RuntimeError, match="device='cpu'"):
    TE.make_model(_cfg(), True)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_conv_precision_is_scoped(dtype, monkeypatch):
  """A float32 model's convolutions run with cuDNN's TF32 off, in the
  forward pass and in the trainer's backward pass; a bf16 model's see the
  caller's setting; building and training leave the setting as it was."""
  from geeco_tpu_torch.models import train as TT
  seen = []
  conv2d = torch.nn.functional.conv2d

  def spy(*args, **kwargs):
    out = conv2d(*args, **kwargs)
    seen.append(('forward', torch.backends.cudnn.allow_tf32))
    out.register_hook(lambda g: seen.append(
        ('backward', torch.backends.cudnn.allow_tf32)))
    return out

  monkeypatch.setattr(torch.nn.functional, 'conv2d', spy)
  monkeypatch.setattr(torch.backends.cudnn, 'allow_tf32', True)
  cfg = _cfg(compute_dtype=dtype, dim_s_obs=20, dim_s_dyn=20, dim_s_diff=20)
  init_fn, train_step, _, _ = TT.make_train_fns(cfg, True, device='cpu')
  ts = init_fn(torch.Generator().manual_seed(0), N)
  assert torch.backends.cudnn.allow_tf32
  frames, jnt, tgt, _ = _inputs(cfg)
  feature = {'step': torch.ones((N, cfg.window_size), dtype=torch.int64),
             'rgb': torch.as_tensor(frames), 'jnt_state': torch.as_tensor(jnt),
             'ee_state': torch.zeros((N, cfg.window_size, 7)),
             'obj_state': torch.zeros((N, cfg.window_size, 7)),
             'target_rgb': torch.as_tensor(tgt)}
  train_step(ts, feature, {'cmd': torch.zeros((N, 4))})
  assert torch.backends.cudnn.allow_tf32
  passes = {p for p, _ in seen}
  assert passes == {'forward', 'backward'}
  assert {flag for _, flag in seen} == {dtype != 'float32'}
