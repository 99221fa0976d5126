"""Gemma training in the PyTorch port against the JAX package, on the CPU
in float32, at head_dim 256 (so the flash gate and the shapes are the
real ones): the 'debug' preset with the Gemma knobs (GeGLU, zero-centred
RMSNorm, the sqrt(dim) embedding scale, tied embeddings), 4 query heads
on 1 kv head as gemma-2b shares one, two layers. Held:

  * the plain flash backward (flash_attention_bwd_reference, what
    FlashAttention's backward runs on CPU tensors) at head_dim 256
    against jax.vjp of skypilot_tpu.ops.flash_attention.flash_attention,
    whose backward (_bwd_rule) runs the Pallas _dq_kernel and
    _dkv_kernel in interpret mode: gemma-2b's 8 query heads on 1 kv head
    and MHA as gemma-7b's (4 on 4 here), causal and not, with segment
    ids and with a sliding window;
  * the model's gradients against jax.grad of the JAX model (scanned and
    unscanned trees, remat on; and with bf16 compute on f32 masters, as
    sft trains), the zero-centred norms given values so that 1 + w is
    held; attention takes the differentiable flash path under 'auto'
    (one backward per layer, the forward twice with remat);
  * three train steps against the JAX trainer (loss, grad_norm and every
    parameter after each step);
  * the loss at gemma's vocab of 256000, the analytic FLOPs of the
    gemma-2b preset against the reference's formula, and sft.main on a
    cut gemma-2b preset.

Tolerances as tests/test_torch_flash_bwd.py (2e-5) and
tests/test_torch_train.py (GRAD_TOL, STEP_TOL): two frameworks' f32
arithmetic; bf16 compute: see test_gemma_grads_match_jax.
"""
import dataclasses

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.models import llama as jax_llama
from skypilot_tpu.ops import flash_attention as jax_flash
from skypilot_tpu.parallel import mesh as mesh_lib
from skypilot_tpu.train import trainer as jax_trainer
from skypilot_tpu_torch.models import llama, weights
from skypilot_tpu_torch.ops import flash_attention
from skypilot_tpu_torch.train import sft, trainer

TOL = dict(atol=2e-5, rtol=2e-5)
GRAD_TOL = dict(atol=1e-6, rtol=1e-4)
STEP_TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_REL_L2 = 5e-2
D = 256
B, S = 2, 16
GEMMA = dict(mlp_act='gelu_tanh', norm_zero_centered=True,
             embed_scale=True, tie_embeddings=True, head_dim_override=D,
             norm_eps=1e-6, rope_theta=10000.0, n_kv_heads=1)


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """One intra-op thread: the suite runs in parallel workers that share
    the host's cores, and these tensors are tiny."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return None if x is None else torch.from_numpy(np.ascontiguousarray(x))


# ------------------------------------------------------------- backward
def _segments(s):
    seg = np.zeros((1, s), np.int32)
    for j, (lo, hi) in enumerate(((0, 50), (50, 57), (57, 110))):
        seg[0, lo:hi] = j + 1
    return seg


@pytest.mark.parametrize('hq,hkv,causal,with_seg,window', [
    (8, 1, True, False, 0), (8, 1, False, True, 0), (8, 1, True, True, 40),
    (4, 4, True, False, 0), (4, 4, False, False, 40),
    (4, 4, True, True, 0)])
def test_plain_backward_d256_matches_pallas_interpret(hq, hkv, causal,
                                                      with_seg, window):
    """dq, dk, dv of the port's FlashAttention (its plain backward on CPU
    tensors) against jax.vjp through _bwd_rule (interpret mode), S = 128
    on 64-row blocks so the Pallas grids have several blocks."""
    rng = np.random.default_rng(hq * 100 + hkv * 10 + window + causal)
    q, do = (rng.normal(size=(1, 128, hq, D)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.normal(size=(1, 128, hkv, D)).astype(np.float32)
            for _ in range(2))
    seg = _segments(128) if with_seg else None
    jout, vjp = jax.vjp(
        lambda q_, k_, v_: jax_flash.flash_attention(
            q_, k_, v_, causal=causal,
            segment_ids=None if seg is None else jnp.asarray(seg),
            block_q=64, block_k=64, window=window),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jgrads = vjp(jnp.asarray(do))
    qt, kt, vt = (_t(x).requires_grad_() for x in (q, k, v))
    out = flash_attention.flash_attention(qt, kt, vt, causal=causal,
                                          segment_ids=_t(seg),
                                          window=window)
    out.backward(_t(do))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               **TOL)
    for name, g, jg in zip(('dq', 'dk', 'dv'), (qt.grad, kt.grad, vt.grad),
                           jgrads):
        assert g.shape == jg.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), **TOL,
                                   err_msg=name)


# ---------------------------------------------------------------- model
def _jax_cfg(scan=True, remat=True):
    return dataclasses.replace(jax_llama.CONFIGS['debug'], **GEMMA,
                               scan_layers=scan, remat=remat)


def _port_cfg():
    # attn_impl 'auto': head_dim 256 passes the _flash_ok rule, so the
    # model takes the flash path as gemma-2b does on the card.
    return dataclasses.replace(llama.CONFIGS['debug'], **GEMMA, remat=True)


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, nn.meta.unbox(tree))


def _jax_params(cfg, seed=0):
    """The JAX model and its params; the zero-centred norms (initialised
    to 0, the identity) get values so that 1 + w is held."""
    model = jax_llama.LlamaModel(cfg)
    params = jax.jit(model.init)(jax.random.PRNGKey(0),
                                 jnp.zeros((1, 8), jnp.int32))
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map_with_path(
        lambda path, x: x + rng.normal(0, 0.3, x.shape).astype(x.dtype)
        if 'norm' in jax.tree_util.keystr(path) else x,
        nn.meta.unbox(params))
    return model, params


def _port_model(jax_params, dtype='float32'):
    cfg = dataclasses.replace(_port_cfg(), dtype=dtype)
    model = llama.LlamaModel(cfg)
    model.load_state_dict(weights.params_from_jax(_numpy_tree(jax_params),
                                                  cfg))
    return model


def _batch(seed):
    toks = np.random.default_rng(seed).integers(0, 256, (B, S + 1)).astype(
        np.int32)
    return {'tokens': toks[:, :-1], 'targets': toks[:, 1:]}


def _assert_tree_close(port_sd, jax_tree, cfg, tol):
    ref = weights.params_from_jax(_numpy_tree(jax_tree), cfg)
    assert set(port_sd) == set(ref)
    for name, r in ref.items():
        np.testing.assert_allclose(port_sd[name].detach().numpy(),
                                   r.numpy(), **tol, err_msg=name)


@pytest.fixture
def flash_calls(monkeypatch):
    """Counts of the flash forward with lse and of the backward (the
    FlashAttention Function's two halves on CPU tensors)."""
    calls = {'fwd': 0, 'bwd': 0}
    for key, name in (('fwd', 'flash_attention_fwd_lse'),
                      ('bwd', 'flash_attention_bwd')):
        real = getattr(flash_attention, name)

        def counted(*a, _real=real, _key=key, **kw):
            calls[_key] += 1
            return _real(*a, **kw)
        monkeypatch.setattr(flash_attention, name, counted)
    return calls


@pytest.mark.parametrize('scan,dtype', [(True, 'float32'),
                                         (False, 'float32'),
                                         (True, 'bfloat16')])
def test_gemma_grads_match_jax(scan, dtype, flash_calls):
    """float32: every gradient within GRAD_TOL. bfloat16 compute (f32
    masters cast at use, as sft trains): the loss within 1e-3 and the
    flattened gradient within rel L2 GRAD_REL_L2 (chip_smoke.py's limit
    for the kernels against the plain attention): bf16 rounds at other
    places in the two frameworks, and the JAX model's own bf16 gradient
    lies 1.7e-2 from its f32 one here."""
    jcfg = dataclasses.replace(_jax_cfg(scan), dtype=dtype)
    jm, jp = _jax_params(jcfg)
    batch = _batch(1)

    def loss_fn(params):
        logits = jm.apply({'params': params}, jnp.asarray(batch['tokens']))
        return jax_trainer.cross_entropy_loss(
            logits, jnp.asarray(batch['targets']))[0]
    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(jp['params'])

    pm = _port_model(jp, dtype)
    assert pm.lm_head is None and pm.cfg.head_dim == D
    loss, _ = trainer.cross_entropy_loss(pm(_t(batch['tokens'])),
                                         _t(batch['targets']))
    loss.backward()
    # The differentiable flash path: each block's forward twice (remat
    # runs it again in the backward), one backward per block.
    n = pm.cfg.n_layers
    assert flash_calls == {'fwd': 2 * n, 'bwd': n}
    grads = {name: p.grad for name, p in pm.named_parameters()}
    assert {g.dtype for g in grads.values()} == {torch.float32}
    assert grads['final_norm.weight'].abs().max() > 0
    if dtype == 'float32':
        np.testing.assert_allclose(loss.item(), float(jloss), **STEP_TOL)
        _assert_tree_close(grads, {'params': jgrads}, pm.cfg, GRAD_TOL)
        return
    np.testing.assert_allclose(loss.item(), float(jloss), atol=1e-3)
    ref = weights.params_from_jax(_numpy_tree({'params': jgrads}), pm.cfg)
    num = sum(float((grads[k] - r).square().sum()) for k, r in ref.items())
    den = sum(float(r.square().sum()) for r in ref.values())
    assert (num / den) ** 0.5 <= GRAD_REL_L2


def test_gemma_train_steps_match_jax():
    jcfg = _jax_cfg()
    jm = jax_llama.LlamaModel(jcfg)
    tcfg_kw = dict(warmup_steps=1, total_steps=10)
    mesh = mesh_lib.build_mesh(mesh_lib.MeshSpec(),
                               devices=jax.devices()[:1])
    jtx = jax_trainer.make_optimizer(jax_trainer.TrainerConfig(**tcfg_kw))
    jstate, _ = jax_trainer.create_sharded_state(
        jm, jtx, mesh, jnp.zeros((B, S), jnp.int32), jax.random.PRNGKey(0))
    jstep = jax_trainer.make_train_step(jm, jtx, mesh, donate=False)

    pm = _port_model({'params': jstate.params})
    tx = trainer.make_optimizer(trainer.TrainerConfig(**tcfg_kw))
    state = trainer.create_state(pm, tx)
    step_fn = trainer.make_train_step(pm, tx)
    for i in range(3):
        batch = _batch(10 + i)
        jstate, jmet = jstep(jstate, {k: jnp.asarray(v)
                                      for k, v in batch.items()})
        state, met = step_fn(state, {k: _t(v) for k, v in batch.items()})
        for key in ('loss', 'grad_norm', 'tokens'):
            np.testing.assert_allclose(met[key].item(), float(jmet[key]),
                                       **STEP_TOL, err_msg=f'{key} {i}')
        _assert_tree_close(pm.state_dict(), {'params': jstate.params},
                           pm.cfg, STEP_TOL)
    # The zero-centred norms left 0 after the updates.
    assert pm.final_norm.weight.abs().max() > 0


# ----------------------------------------------------------------- sft
def test_cross_entropy_at_gemma_vocab():
    """The loss over 256000 classes (f32 log-softmax) against the
    reference's, with an ignored target."""
    rng = np.random.default_rng(7)
    logits = rng.normal(size=(1, 3, 256000)).astype(np.float32)
    targets = np.asarray([[5, 255999, -100]], np.int32)
    jl, jn = jax_trainer.cross_entropy_loss(jnp.asarray(logits),
                                            jnp.asarray(targets))
    tl, tn = trainer.cross_entropy_loss(_t(logits), _t(targets))
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-6)
    assert tn.item() == float(jn) == 2


def test_analytic_flops_gemma_2b_is_the_reference_formula():
    """sft.analytic_flops on the gemma-2b preset at 4 x 2048 equals the
    JAX sft's _analytic_flops: 6 * params + 12 * layers * dim * seq per
    token, params from the reference's preset (tied: the embedding
    counted once)."""
    ref_cfg = jax_llama.CONFIGS['gemma-2b']
    want = (6 * ref_cfg.num_params() +
            12 * ref_cfg.n_layers * ref_cfg.dim * 2048) * 4 * 2048
    assert sft.analytic_flops(llama.CONFIGS['gemma-2b'], 4, 2048) == want
    assert round(ref_cfg.num_params() / 1e9, 3) == 2.506


def test_sft_main_on_a_cut_gemma_2b(monkeypatch, flash_calls):
    """--model gemma-2b resolves to the preset (cut here to 2 layers,
    dim 64 and vocab 256; head_dim 256 and 1 kv head kept) and trains:
    finite losses, the flash backward once per layer and step."""
    preset = llama.CONFIGS['gemma-2b']
    cut = dataclasses.replace(preset, n_layers=2, dim=64, n_heads=4,
                              mlp_dim=128, vocab_size=256,
                              max_seq_len=64)
    monkeypatch.setitem(llama.CONFIGS, 'gemma-2b', cut)
    out = sft.main(['--device', 'cpu', '--model', 'gemma-2b', '--steps',
                    '2', '--batch', '2', '--seq', '32', '--log-every',
                    '1'])
    assert out['steps'] == 2 and all(np.isfinite(out['losses']))
    assert flash_calls == {'fwd': 2 * 2 * 2, 'bwd': 2 * 2}
    assert out['flops_per_step'] == sft.analytic_flops(cut, 2, 32)
    # Random weights predict a near-uniform distribution at first.
    assert abs(out['losses'][0] - np.log(256)) < 1.5
