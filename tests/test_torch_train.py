"""The PyTorch port's training path against the JAX package's, on the CPU
at the 'debug' preset in float32: the same weights (params_from_jax), the
same batches (made from a seed with numpy), then

  * the model's gradients against jax.grad of the JAX model (remat on
    and off, scanned and unscanned trees, with and without segment ids);
  * cross_entropy_loss, the learning-rate schedule and global-norm
    clipping against trainer.cross_entropy_loss and optax's;
  * three train steps, plain and with grad_accum=2, against
    trainer.make_train_step on a one-device mesh: loss, grad_norm and
    parameters after every step;
  * the sft data iterators against the JAX entrypoint's; attn_impl
    'xla' against the flash path; serving's bf16-resident weights.

tests/test_torch_sft.py drives sft.main, checkpoints and the SIGTERM
drill.

Tolerances: gradients rtol 1e-4 (atol 1e-6 for entries near zero), train
steps 1e-5 (atol and rtol), clipping 1e-6, the schedule 1e-5 (optax
evaluates it in f32, the port in Python floats): two frameworks' f32
arithmetic over two layers.
"""
import dataclasses

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from skypilot_tpu.models import llama as jax_llama
from skypilot_tpu.parallel import mesh as mesh_lib
from skypilot_tpu.train import sft as jax_sft
from skypilot_tpu.train import trainer as jax_trainer
from skypilot_tpu_torch.infer import server as torch_server
from skypilot_tpu_torch.models import llama, weights
from skypilot_tpu_torch.train import sft, trainer

GRAD_TOL = dict(atol=1e-6, rtol=1e-4)
STEP_TOL = dict(atol=1e-5, rtol=1e-5)
B, S = 2, 16


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """One intra-op thread: the suite runs in parallel workers that share
    the host's cores, and these tensors are tiny."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_cfg(scan=True, remat=False):
    return dataclasses.replace(jax_llama.CONFIGS['debug'],
                               scan_layers=scan, remat=remat)


def _jax_params(cfg):
    model = jax_llama.LlamaModel(cfg)
    params = jax.jit(model.init)(jax.random.PRNGKey(0),
                                 jnp.zeros((1, 8), jnp.int32))
    return model, params


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, nn.meta.unbox(tree))


def _port_model(jax_params, remat=False):
    # 'flash': the debug preset's head_dim 16 takes the reference under
    # 'auto' (the _flash_ok rule); this holds the flash path to JAX.
    cfg = dataclasses.replace(llama.CONFIGS['debug'], remat=remat,
                              attn_impl='flash')
    model = llama.LlamaModel(cfg)
    model.load_state_dict(weights.params_from_jax(_numpy_tree(jax_params),
                                                  cfg))
    return model


def _batch(seed=0, with_seg=False):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, 256, (B, S + 1)).astype(np.int32)
    batch = {'tokens': toks[:, :-1], 'targets': toks[:, 1:]}
    if with_seg:
        seg = np.zeros((B, S), np.int32)
        seg[:, :7], seg[:, 7:13] = 1, 2          # id-0 tail
        batch['segment_ids'] = seg
    return batch


def _torch_batch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


def _assert_tree_close(port_sd, jax_tree, cfg, tol):
    ref = weights.params_from_jax(_numpy_tree(jax_tree), cfg)
    assert set(port_sd) == set(ref)
    for name, r in ref.items():
        np.testing.assert_allclose(port_sd[name].detach().numpy(),
                                   r.numpy(), **tol, err_msg=name)


@pytest.mark.parametrize('scan,remat,with_seg', [
    (True, False, False), (False, False, False), (True, True, False),
    (False, True, True)])
def test_model_grads_match_jax(scan, remat, with_seg):
    jcfg = _jax_cfg(scan, remat)
    jm, jp = _jax_params(jcfg)
    batch = _batch(1, with_seg)
    seg = batch.get('segment_ids')

    def loss_fn(params):
        logits = jm.apply({'params': params}, jnp.asarray(batch['tokens']),
                          segment_ids=None if seg is None
                          else jnp.asarray(seg))
        return jax_trainer.cross_entropy_loss(
            logits, jnp.asarray(batch['targets']))[0]
    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(jp['params'])

    pm = _port_model(jp, remat=remat)
    tb = _torch_batch(batch)
    loss, _ = trainer.cross_entropy_loss(
        pm(tb['tokens'], segment_ids=tb.get('segment_ids')), tb['targets'])
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), **STEP_TOL)
    grads = {n: p.grad for n, p in pm.named_parameters()}
    _assert_tree_close(grads, {'params': jgrads}, pm.cfg, GRAD_TOL)


def test_remat_recomputes_blocks_and_keeps_the_gradients():
    """remat=True runs every block again in the backward (the forward's
    attention twice per block) and gives the same gradients."""
    _, jp = _jax_params(_jax_cfg())
    tb = _torch_batch(_batch(2))
    grads, calls = [], []
    for remat in (False, True):
        pm = _port_model(jp, remat=remat)
        n = [0]
        hooks = [blk.attn.register_forward_hook(
            lambda *a, n=n: n.__setitem__(0, n[0] + 1))
            for blk in pm.layers]
        trainer.cross_entropy_loss(pm(tb['tokens']),
                                   tb['targets'])[0].backward()
        for h in hooks:
            h.remove()
        calls.append(n[0])
        grads.append({k: p.grad.clone() for k, p in pm.named_parameters()})
    assert calls == [2, 4]
    for k in grads[0]:
        torch.testing.assert_close(grads[1][k], grads[0][k], rtol=0, atol=0)


def test_cross_entropy_ignores_targets():
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(2, 5, 11)).astype(np.float32)
    targets = rng.integers(0, 11, (2, 5)).astype(np.int32)
    targets[0, 1] = targets[1, 4] = -100
    mask = np.ones((2, 5), np.float32)
    mask[1, 0] = 0.0
    for m in (None, mask):
        jl, jn = jax_trainer.cross_entropy_loss(
            jnp.asarray(logits), jnp.asarray(targets),
            None if m is None else jnp.asarray(m))
        tl, tn = trainer.cross_entropy_loss(
            torch.from_numpy(logits), torch.from_numpy(targets),
            None if m is None else torch.from_numpy(m))
        np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-6)
        assert tn.item() == float(jn)


@pytest.mark.parametrize('warmup,total', [(1, 10), (100, 10000), (5, 3),
                                          (0, 8)])
def test_lr_schedule_matches_optax(warmup, total):
    tcfg = trainer.TrainerConfig(learning_rate=3e-4, warmup_steps=warmup,
                                 total_steps=total)
    ref = optax.warmup_cosine_decay_schedule(
        init_value=0.0, peak_value=3e-4, warmup_steps=warmup,
        decay_steps=max(total, warmup + 1), end_value=3e-5)
    sched = trainer.make_optimizer(tcfg).schedule
    assert sched(0) == 0.0 or warmup == 0
    for step in list(range(0, min(total, 40) + 3)) + [total + 100]:
        np.testing.assert_allclose(sched(step), float(ref(step)),
                                   rtol=1e-5, atol=1e-12, err_msg=str(step))


@pytest.mark.parametrize('scale', [0.01, 10.0])
def test_clip_matches_optax(scale):
    rng = np.random.default_rng(4)
    grads = [rng.normal(size=s).astype(np.float32) * scale
             for s in ((3, 4), (5,), (2, 2, 2))]
    ref, _ = optax.clip_by_global_norm(1.0).update(
        [jnp.asarray(g) for g in grads], None)
    tg = [torch.from_numpy(g.copy()) for g in grads]
    norm = trainer.clip_by_global_norm_(tg, 1.0)
    np.testing.assert_allclose(norm.item(), float(optax.global_norm(grads)),
                               rtol=1e-6)
    for g, r in zip(tg, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6,
                                   atol=1e-9)


@pytest.mark.parametrize('grad_accum,calls', [(1, 3), (2, 4)])
def test_train_steps_match_jax(grad_accum, calls):
    jcfg = _jax_cfg()
    jm, _ = _jax_params(jcfg)
    tcfg_kw = dict(warmup_steps=1, total_steps=10, grad_accum=grad_accum)
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
    for i in range(calls):
        batch = _batch(10 + i)
        jstate, jmet = jstep(jstate, {k: jnp.asarray(v)
                                      for k, v in batch.items()})
        state, met = step_fn(state, _torch_batch(batch))
        assert state.step == int(jstate.step) == i + 1
        for key in ('loss', 'grad_norm', 'tokens'):
            np.testing.assert_allclose(met[key].item(), float(jmet[key]),
                                       **STEP_TOL, err_msg=f'{key} {i}')
        _assert_tree_close(pm.state_dict(), {'params': jstate.params},
                           pm.cfg, STEP_TOL)
    assert state.updates == calls // grad_accum


def test_eval_step_matches_the_loss():
    _, jp = _jax_params(_jax_cfg())
    pm = _port_model(jp)
    tb = _torch_batch(_batch(5))
    out = trainer.make_eval_step(pm)(tb)
    ref, n = trainer.cross_entropy_loss(pm(tb['tokens']), tb['targets'])
    assert out['loss'].item() == pytest.approx(ref.item())
    assert out['tokens'].item() == n.item() == B * S
    assert not out['loss'].requires_grad


def test_batches_match_jax(tmp_path):
    ours = sft.synthetic_batches(256, 2, 8, seed=3)
    ref = jax_sft.synthetic_batches(256, 2, 8, seed=3)
    for _ in range(3):
        a, b = next(ours), next(ref)
        for k in ('tokens', 'targets'):
            np.testing.assert_array_equal(a[k], b[k])
    path = tmp_path / 'data.jsonl'
    path.write_text('{"text": "hello world"}\n\n'
                    '{"tokens": [5, 6, 7, 300]}\n'
                    '{"text": "a longer row of text, with bytes \\u00e9"}\n')
    ours = sft.jsonl_batches(str(path), 256, 2, 8)
    ref = jax_sft.jsonl_batches(str(path), 256, 2, 8)
    for _ in range(4):
        a, b = next(ours), next(ref)
        for k in ('tokens', 'targets'):
            np.testing.assert_array_equal(a[k], b[k])


def test_unported_model_knobs_raise():
    for kw in ({'remat_policy': 'dots'}, {'attn_impl': 'ring'}):
        with pytest.raises(NotImplementedError):
            llama.LlamaModel(dataclasses.replace(llama.CONFIGS['debug'],
                                                 **kw))


def test_attn_xla_takes_the_reference():
    """attn_impl='xla' differentiates the plain attention by autograd and
    gives the flash path's gradients."""
    _, jp = _jax_params(_jax_cfg())
    tb = _torch_batch(_batch(6))
    grads = []
    for impl in ('flash', 'xla'):
        pm = _port_model(jp)
        pm.cfg = dataclasses.replace(pm.cfg, attn_impl=impl)
        for blk in pm.layers:
            blk.attn.cfg = pm.cfg
        trainer.cross_entropy_loss(pm(tb['tokens']),
                                   tb['targets'])[0].backward()
        grads.append([p.grad for p in pm.parameters()])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6)


def test_build_engine_serves_from_compute_dtype_weights():
    """Serving replaces f32 masters by the compute dtype (the JAX
    build_engine's rule): the engine's weights are bf16 and remat is
    off."""
    eng = torch_server.build_engine('debug', device='cpu',
                                    dtype='bfloat16', max_seq_len=64)
    cfg = eng.model.cfg
    assert (cfg.param_dtype, cfg.dtype, cfg.remat) == ('bfloat16',
                                                      'bfloat16', False)
    assert {p.dtype for p in eng.model.parameters()} == {torch.bfloat16}
    model = llama.LlamaModel(llama.CONFIGS['llama3-1b'], device='meta')
    assert model.tok_embed.dtype == torch.float32
    assert model.layers[0].attn.wq.weight.dtype == torch.float32
