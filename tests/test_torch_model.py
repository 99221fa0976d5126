"""Parity of the PyTorch port's Llama model with the JAX package's, on the
CPU: params_from_jax on LlamaModel.init trees (scanned and unscanned),
then logits with no cache, a packed ragged prefill with segment ids,
and a paged prefill plus three decode steps (the Pallas paged kernel in
interpret mode on the JAX side), all in float32 at the 'debug' preset.

Tolerance: atol/rtol 1e-4 on logits (two frameworks' f32 matmuls over
two layers).
"""
import dataclasses

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.infer.paged_cache import PagePool as JaxPagePool
from skypilot_tpu.models import llama as jax_llama
from skypilot_tpu_torch.infer.paged_cache import PagePool
from skypilot_tpu_torch.models import llama, weights

LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """One intra-op thread: the suite runs in parallel workers that share
    the host's cores, and these tensors are tiny."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_model(scan_layers=True, tie=False):
    cfg = dataclasses.replace(jax_llama.CONFIGS['debug'],
                              scan_layers=scan_layers, tie_embeddings=tie)
    model = jax_llama.LlamaModel(cfg)
    params = jax.jit(model.init)(jax.random.PRNGKey(0),
                                 jnp.zeros((1, 8), jnp.int32))
    return model, params


def _port_model(jax_params, tie=False):
    # 'flash': the debug preset's head_dim 16 takes the reference under
    # 'auto' (the _flash_ok rule); this holds the flash path to JAX.
    cfg = dataclasses.replace(llama.CONFIGS['debug'], tie_embeddings=tie,
                              attn_impl='flash')
    tree = jax.tree_util.tree_map(np.asarray, nn.meta.unbox(jax_params))
    model = llama.LlamaModel(cfg)
    model.load_state_dict(weights.params_from_jax(tree, cfg))
    return model.eval()


@pytest.fixture(scope='module')
def models():
    jm, jp = _jax_model()
    return jm, jp, _port_model(jp)


def _close(jax_out, torch_out, tol=LOGIT_TOL):
    np.testing.assert_allclose(np.asarray(torch_out), np.asarray(jax_out),
                               **tol)


@pytest.mark.parametrize('scan_layers,tie', [(True, False), (False, False),
                                             (True, True)])
def test_params_from_jax_layouts(scan_layers, tie):
    jm, jp = _jax_model(scan_layers, tie)
    pm = _port_model(jp, tie)
    flat = nn.meta.unbox(jp)['params']
    emb = np.asarray(flat['tok_embed'])
    np.testing.assert_array_equal(pm.tok_embed.detach().numpy(), emb)
    blk = flat['layers'] if scan_layers else flat['layer_1']
    wq = np.asarray(blk['attn']['wq']['kernel'])
    wq = wq[1] if scan_layers else wq
    np.testing.assert_array_equal(
        pm.layers[1].attn.wq.weight.detach().numpy(), wq.T)
    assert (pm.lm_head is None) == tie
    tokens = np.random.default_rng(0).integers(0, 256, (2, 12))
    _close(jax.jit(jm.apply)(jp, jnp.asarray(tokens, jnp.int32)),
           pm(torch.from_numpy(tokens)).detach())


def test_logits_no_cache(models):
    jm, jp, pm = models
    tokens = np.random.default_rng(1).integers(0, 256, (2, 24))
    with torch.no_grad():
        out = pm(torch.from_numpy(tokens))
    _close(jax.jit(jm.apply)(jp, jnp.asarray(tokens, jnp.int32)), out)


def test_packed_prefill_with_segments(models):
    """The engine's ragged prefill: prompts of 5, 11 and 7 tokens packed
    at page-aligned offsets with id-0 tails, per-segment positions,
    a zeroed dense cache and logits at each prompt's last token."""
    jm, jp, pm = models
    rng = np.random.default_rng(2)
    t, page = 48, 8
    tokens = np.zeros((1, t), np.int32)
    segs = np.zeros((1, t), np.int32)
    poss = np.zeros((1, t), np.int32)
    logit_pos = np.zeros((1, 4), np.int32)
    off = 0
    for j, n in enumerate((5, 11, 7)):
        span = -(-n // page) * page
        tokens[0, off:off + n] = rng.integers(1, 256, n)
        segs[0, off:off + n] = j + 1
        poss[0, off:off + span] = np.arange(span)
        logit_pos[0, j] = off + n - 1
        off += span
    cfg = pm.cfg
    shape = (cfg.n_layers, 1, t, cfg.n_kv_heads, cfg.head_dim)
    jl, jc = jax.jit(jm.apply)(
        jp, jnp.asarray(tokens), positions=jnp.asarray(poss),
        segment_ids=jnp.asarray(segs),
        cache={'k': jnp.zeros(shape), 'v': jnp.zeros(shape)},
        logit_positions=jnp.asarray(logit_pos))
    cache = {'k': torch.zeros(shape), 'v': torch.zeros(shape)}
    with torch.no_grad():
        tl, tc = pm(torch.from_numpy(tokens).long(),
                    positions=torch.from_numpy(poss).long(),
                    segment_ids=torch.from_numpy(segs), cache=cache,
                    logit_positions=torch.from_numpy(logit_pos).long())
    _close(jl, tl)
    _close(jc['k'], tc['k'])
    _close(jc['v'], tc['v'])


def test_paged_prefill_then_three_decode_steps(models):
    """Lone-request prefill (zeroed dense cache, positions 0..S-1 in
    JAX, positions=None in the port), scatter into pages, then three
    decode steps of three slots through the paged pools — slot 2 is a
    released slot (dummy table row, stale length)."""
    jm, jp, pm = models
    apply = jax.jit(jm.apply)   # traced once a shape, not op by op
    cfg = pm.cfg
    rng = np.random.default_rng(3)
    page, n_pages, mp, bucket = 8, 10, 4, 16
    lens = [13, 6]
    shape = (cfg.n_layers, 1, bucket, cfg.n_kv_heads, cfg.head_dim)
    pool_shape = (cfg.n_layers, n_pages, cfg.n_kv_heads, page,
                  cfg.head_dim)
    j_pool = {'k': jnp.zeros(pool_shape), 'v': jnp.zeros(pool_shape)}
    t_pool = {'k': torch.zeros(pool_shape), 'v': torch.zeros(pool_shape)}
    tables = np.array([[3, 4, 0, 0], [7, 0, 0, 0], [0, 0, 0, 0]], np.int32)
    last = []
    for slot, n in enumerate(lens):
        toks = np.zeros((1, bucket), np.int32)
        toks[0, :n] = rng.integers(1, 256, n)
        lp = np.array([[n - 1]], np.int32)
        jl, jc = apply(
            jp, jnp.asarray(toks),
            positions=jnp.arange(bucket)[None, :],
            cache={'k': jnp.zeros(shape), 'v': jnp.zeros(shape)},
            logit_positions=jnp.asarray(lp))
        with torch.no_grad():
            tl, tc = pm(torch.from_numpy(toks).long(),
                        cache={'k': torch.zeros(shape),
                               'v': torch.zeros(shape)},
                        logit_positions=torch.from_numpy(lp).long())
        _close(jl, tl)
        ids = tables[slot, :-(-n // page)]
        for name in ('k', 'v'):
            j_pool[name] = JaxPagePool.insert_prompt(
                j_pool[name], jc[name], jnp.asarray(ids))
            PagePool.insert_prompt(t_pool[name], tc[name],
                                   torch.from_numpy(ids))
        last.append(int(np.argmax(np.asarray(jl)[0, 0])))
    last = np.array(last + [5], np.int32)
    positions = np.array(lens + [41], np.int32)
    for _ in range(3):
        jl, jc = apply(
            jp, jnp.asarray(last)[:, None],
            positions=jnp.asarray(positions)[:, None],
            cache={**j_pool, 'tables': jnp.asarray(tables)})
        j_pool = {'k': jc['k'], 'v': jc['v']}
        with torch.no_grad():
            tl, _ = pm(torch.from_numpy(last)[:, None].long(),
                       positions=torch.from_numpy(positions)[:, None],
                       cache={**t_pool, 'tables': torch.from_numpy(tables)})
        _close(jl, tl)
        last = np.argmax(np.asarray(jl)[:, 0], axis=-1).astype(np.int32)
        positions = positions + 1
    _close(j_pool['k'], t_pool['k'])
    _close(j_pool['v'], t_pool['v'])
