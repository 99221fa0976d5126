"""Parity of the PyTorch port's ops (skypilot_tpu_torch/ops, infer/
paged_cache.py, the engine's sampling filter) with the JAX package, on
the CPU. Inputs are made from a seed with numpy and fed to both. The
Pallas kernels run in interpret mode, as the JAX package's own tests
run them; the port runs each kernel's plain version (a CPU tensor).

Tolerances: 1e-5 (atol and rtol) for rope and norms, 2e-5 for
attention (tests/test_paged_attention.py's), all in float32.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.infer import engine as jax_engine
from skypilot_tpu.infer.paged_cache import PagePool as JaxPagePool
from skypilot_tpu.ops import attention as jax_attention
from skypilot_tpu.ops import flash_attention as jax_flash
from skypilot_tpu.ops import norms as jax_norms
from skypilot_tpu.ops import paged_attention as jax_paged
from skypilot_tpu.ops import rope as jax_rope
from skypilot_tpu_torch.infer import engine as torch_engine
from skypilot_tpu_torch.infer.paged_cache import PagePool
from skypilot_tpu_torch.ops import attention, flash_attention, norms
from skypilot_tpu_torch.ops import paged_attention, rope

OPS_TOL = dict(atol=1e-5, rtol=1e-5)
ATTN_TOL = dict(atol=2e-5, rtol=2e-5)


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """One intra-op thread: the suite runs in parallel workers that share
    the host's cores, and these tensors are tiny."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rng(seed=0):
    return np.random.default_rng(seed)


def _both(x):
    return jnp.asarray(x), torch.from_numpy(np.ascontiguousarray(x))


def _close(jax_out, torch_out, tol):
    np.testing.assert_allclose(np.asarray(torch_out), np.asarray(jax_out),
                               **tol)


@pytest.mark.parametrize('zero_centered', [False, True])
def test_rms_norm(zero_centered):
    rng = _rng()
    x = rng.normal(size=(2, 5, 64)).astype(np.float32)
    w = rng.normal(size=(64,)).astype(np.float32)
    (xj, xt), (wj, wt) = _both(x), _both(w)
    _close(jax_norms.rms_norm(xj, wj, eps=1e-5,
                              zero_centered=zero_centered),
           norms.rms_norm(xt, wt, eps=1e-5, zero_centered=zero_centered),
           OPS_TOL)


@pytest.mark.parametrize('llama31', [False, True])
def test_rope_freqs_and_apply(llama31):
    rng = _rng(1)
    pos = rng.integers(0, 9000, size=(2, 7)).astype(np.int32)
    x = rng.normal(size=(2, 7, 3, 16)).astype(np.float32)
    pj, pt = _both(pos)
    cj, sj = jax_rope.rope_freqs(pj, 16, 500000.0,
                                 use_llama31_scaling=llama31)
    ct, st = rope.rope_freqs(pt, 16, 500000.0, use_llama31_scaling=llama31)
    _close(cj, ct, OPS_TOL)
    _close(sj, st, OPS_TOL)
    xj, xt = _both(x)
    _close(jax_rope.apply_rope(xj, cj, sj), rope.apply_rope(xt, ct, st),
           OPS_TOL)


def test_positions_from_segment_ids():
    seg = np.array([[1, 1, 1, 0, 2, 2, 0, 0, 3, 3],
                    [5, 5, 5, 5, 5, 5, 5, 5, 5, 5]], np.int32)
    sj, st = _both(seg)
    np.testing.assert_array_equal(
        rope.positions_from_segment_ids(st, 2, 10).numpy(),
        np.asarray(jax_rope.positions_from_segment_ids(sj, 2, 10)))
    np.testing.assert_array_equal(
        rope.positions_from_segment_ids(None, 2, 4).numpy(),
        np.asarray(jax_rope.positions_from_segment_ids(None, 2, 4)))


def _qkv(seed, b=2, sq=24, sk=24, hq=4, hkv=2, d=16):
    rng = _rng(seed)
    q = rng.normal(size=(b, sq, hq, d)).astype(np.float32)
    k = rng.normal(size=(b, sk, hkv, d)).astype(np.float32)
    v = rng.normal(size=(b, sk, hkv, d)).astype(np.float32)
    return _both(q), _both(k), _both(v)


def _segments(b, s, seed):
    """Packed rows: a few segments with id-0 padding between and after."""
    rng = _rng(seed)
    seg = np.zeros((b, s), np.int32)
    for i in range(b):
        pos, sid = 0, 1
        while pos < s - 4:
            n = int(rng.integers(3, 9))
            seg[i, pos:pos + n] = sid
            pos += n + int(rng.integers(0, 3))   # id-0 gap
            sid += 1
    return seg


@pytest.mark.parametrize('case', ['causal', 'segments', 'q_positions',
                                  'non_causal', 'window_softcap_scale'])
def test_mha_reference(case):
    (qj, qt), (kj, kt), (vj, vt) = _qkv(2)
    kw_j, kw_t = {}, {}
    if case == 'window_softcap_scale':
        # The knobs the flash kernel does not compute: the port's public
        # attention() routes them to the reference.
        kw = dict(window=5, logit_softcap=3.0, softmax_scale=0.3)
        _close(jax_attention.mha_reference(qj, kj, vj, causal=True, **kw),
               attention.attention(qt, kt, vt, causal=True, **kw),
               ATTN_TOL)
        return
    if case == 'segments':
        sj, st = _both(_segments(2, 24, 3))
        kw_j, kw_t = {'segment_ids': sj}, {'segment_ids': st}
    elif case == 'q_positions':
        pos = np.stack([np.arange(24) + 0, np.arange(24) // 2]).astype(
            np.int32)
        pj, pt = _both(pos)
        kw_j, kw_t = {'q_positions': pj}, {'q_positions': pt.long()}
    causal = case != 'non_causal'
    _close(jax_attention.mha_reference(qj, kj, vj, causal=causal, **kw_j),
           attention.mha_reference(qt, kt, vt, causal=causal, **kw_t),
           ATTN_TOL)


@pytest.mark.parametrize('with_segments', [False, True])
def test_flash_plain_version_matches_pallas_flash(with_segments):
    """The port's flash plain version against the Pallas flash kernel
    (interpret mode), GQA 8/2, causal, with and without packed segment
    ids (id-0 padding included)."""
    (qj, qt), (kj, kt), (vj, vt) = _qkv(4, b=2, sq=64, sk=64, hq=8, hkv=2,
                                        d=64)
    sj = st = None
    if with_segments:
        sj, st = _both(_segments(2, 64, 5))
    ref = jax_flash.flash_attention(qj, kj, vj, causal=True,
                                    segment_ids=sj)
    out, lse = flash_attention.flash_attention_fwd_lse(
        qt, kt, vt, causal=True, segment_ids=st)
    _close(ref, out, ATTN_TOL)
    assert lse.shape == (2, 8, 64)
    # The public entry takes the same plain version on a CPU tensor.
    _close(ref, attention.attention(qt, kt, vt, causal=True,
                                    segment_ids=st), ATTN_TOL)


@pytest.mark.parametrize('causal', [True, False])
def test_flash_lse_matches_pallas(causal):
    (qj, qt), (kj, kt), (vj, vt) = _qkv(6, b=1, sq=64, sk=64, hq=4, hkv=1,
                                        d=64)
    out_j, lse_j = jax_flash.flash_attention_fwd_lse(qj, kj, vj,
                                                     causal=causal)
    out_t, lse_t = flash_attention.flash_attention_fwd_lse(
        qt, kt, vt, causal=causal)
    _close(out_j, out_t, ATTN_TOL)
    _close(lse_j, lse_t, ATTN_TOL)


def _paged_inputs(seed, slots=4, hq=4, hkv=2, d=64, n_pages=12, p=16,
                  mp=4):
    rng = _rng(seed)
    q = rng.normal(size=(slots, hq, d)).astype(np.float32)
    k_pool = rng.normal(size=(n_pages, hkv, p, d)).astype(np.float32)
    v_pool = rng.normal(size=(n_pages, hkv, p, d)).astype(np.float32)
    return q, k_pool, v_pool


@pytest.mark.parametrize('case', ['varied', 'length_zero', 'dummy_rows'])
def test_paged_plain_version_matches_pallas_paged(case):
    q, k_pool, v_pool = _paged_inputs(7)
    if case == 'varied':
        tables = [[1, 2, 3, 0], [4, 5, 0, 0], [6, 7, 8, 9], [10, 0, 0, 0]]
        lengths = [40, 17, 63, 0]
    elif case == 'length_zero':
        tables = [[2, 0, 0, 0], [3, 4, 0, 0], [5, 0, 0, 0], [6, 7, 8, 0]]
        lengths = [0, 0, 15, 33]
    else:
        # Released slots: all-zero rows with stale (even huge) lengths,
        # and a reserved row with an unreserved gap inside its span.
        tables = [[0, 0, 0, 0], [1, 2, 0, 0], [0, 0, 0, 0], [3, 0, 4, 0]]
        lengths = [9999, 20, 37, 40]
    tables = np.asarray(tables, np.int32)
    lengths = np.asarray(lengths, np.int32)
    args = [_both(a) for a in (q, k_pool, v_pool, tables, lengths)]
    ref = jax_paged.paged_decode_attention(*(a[0] for a in args))
    out = paged_attention.paged_decode_attention(*(a[1] for a in args))
    assert np.isfinite(out.numpy()).all()
    _close(ref, out, ATTN_TOL)


def test_paged_cache_statics_match_jax():
    rng = _rng(8)
    layers, n_pages, h, p, d = 2, 9, 2, 4, 8
    pool = rng.normal(size=(layers, n_pages, h, p, d)).astype(np.float32)
    prompt = rng.normal(size=(layers, 1, 20, h, d)).astype(np.float32)
    ids = np.array([5, 2, 7], np.int32)
    pj, pt = _both(pool)
    new_j = JaxPagePool.insert_prompt(pj, jnp.asarray(prompt),
                                      jnp.asarray(ids), 4)
    new_t = PagePool.insert_prompt(pt.clone(), torch.from_numpy(prompt),
                                   torch.from_numpy(ids), 4)
    _close(new_j, new_t, OPS_TOL)

    tables = np.array([[5, 2, 7], [1, 0, 0], [0, 0, 0]], np.int32)
    view_j = JaxPagePool.gather_view_layer(new_j[1], jnp.asarray(tables))
    view_t = PagePool.gather_view_layer(new_t[1], torch.from_numpy(tables))
    _close(view_j, view_t, OPS_TOL)

    # Slot 2 is released (dummy row, stale length past the row's span):
    # its write is clipped into the dummy page like the JAX scatter's.
    new_kv = rng.normal(size=(3, h, d)).astype(np.float32)
    lengths = np.array([9, 3, 50], np.int32)
    app_j = JaxPagePool.append_token_layer(
        new_j[0], jnp.asarray(new_kv), jnp.asarray(tables),
        jnp.asarray(lengths))
    app_t = PagePool.append_token_layer(
        new_t[0].clone(), torch.from_numpy(new_kv),
        torch.from_numpy(tables), torch.from_numpy(lengths))
    _close(app_j, app_t, OPS_TOL)


@pytest.mark.parametrize('shape', ['slots', 'leading'])
def test_sampling_filter_matches_jax(shape):
    rng = _rng(9)
    n, v = 5, 100
    topks = np.array([0, 1, 5, 64, 3], np.int32)
    topps = np.array([1.0, 0.5, 0.9, 0.3, 0.0], np.float32)
    dims = (n, v) if shape == 'slots' else (n, 3, v)
    scaled = (rng.normal(size=dims) * 3).astype(np.float32)
    out_j = np.asarray(jax_engine._sampling_filter(  # pylint: disable=protected-access
        jnp.asarray(scaled), jnp.asarray(topks), jnp.asarray(topps)))
    out_t = torch_engine.sampling_filter(
        torch.from_numpy(scaled), torch.from_numpy(topks),
        torch.from_numpy(topps)).numpy()
    np.testing.assert_array_equal(np.isinf(out_t), np.isinf(out_j))
    finite = np.isfinite(out_j)
    np.testing.assert_allclose(out_t[finite], out_j[finite], **OPS_TOL)
