"""The PyTorch port's sliding-window flash attention against the JAX
package's, on the CPU. The port's forward (flash_attention_fwd_lse: out
and lse) and its FlashAttention backward run their plain versions on CPU
tensors; the JAX side runs skypilot_tpu.ops.flash_attention, whose
forward and backward reach the Pallas kernels (_fwd_kernel, _dq_kernel,
_dkv_kernel with `window`) in interpret mode, as the JAX package's own
tests run them (tests/test_parallel.py TestWindowedFlash).

The same numpy inputs in float32 go to both: q [1, S, 4, 32], k/v
[1, S, 2, 32] (GQA), block_q = block_k = 64 so the Pallas grids have
several blocks and windows below, at and above one block; causal and
non-causal rows, with and without segment ids (id 0 as padding).
Tolerance 2e-5 (atol and rtol), as for the unwindowed kernels
(tests/test_torch_ops.py, tests/test_torch_flash_bwd.py).

Also: the dispatch (attention(window > 0) reaches flash_attention under
'auto' and 'flash', the reference under 'xla') and the wrappers'
refusals of a window that is not an int >= 0.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.ops import attention as jax_attention
from skypilot_tpu.ops import flash_attention as jax_flash
from skypilot_tpu_torch.ops import attention, flash_attention

TOL = dict(atol=2e-5, rtol=2e-5)


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """One intra-op thread: the suite runs in parallel workers that share
    the host's cores, and these tensors are tiny."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _segments(s, seed):
    """One packed row: three segments of random lengths, some longer
    than the windows, and an id-0 tail."""
    rng = np.random.default_rng(seed)
    cuts = np.sort(rng.choice(np.arange(16, s - 16), 3, replace=False))
    seg = np.zeros((1, s), np.int32)
    for j, (lo, hi) in enumerate(zip((0, *cuts[:-1]), cuts)):
        seg[0, lo:hi] = j + 1
    return seg


def _inputs(s, seed, with_seg):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(1, s, 4, 32)).astype(np.float32)
    k = rng.normal(size=(1, s, 2, 32)).astype(np.float32)
    v = rng.normal(size=(1, s, 2, 32)).astype(np.float32)
    do = rng.normal(size=(1, s, 4, 32)).astype(np.float32)
    return q, k, v, do, (_segments(s, seed + 1) if with_seg else None)


def _t(x):
    return None if x is None else torch.from_numpy(x)


def _j(x):
    return None if x is None else jnp.asarray(x)


@pytest.mark.parametrize('case', ['causal', 'noncausal', 'segments'])
@pytest.mark.parametrize('window', [1, 7, 64, 100, 256])
def test_forward_matches_pallas_interpret(window, case):
    """out and lse of the plain forward against _flash_fwd_impl's (the
    Pallas _fwd_kernel in interpret mode) at S = 256."""
    causal = case != 'noncausal'
    q, k, v, _, seg = _inputs(256, window, case == 'segments')
    jout, jlse = jax_flash._flash_fwd_impl(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), _j(seg), causal,
        64, 64, window)
    out, lse = flash_attention.flash_attention_fwd_lse(
        _t(q), _t(k), _t(v), causal=causal, segment_ids=_t(seg),
        window=window)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[..., 0], **TOL)


def test_window_past_the_row_is_no_window():
    q, k, v, _, seg = _inputs(128, 5, True)
    args = (_t(q), _t(k), _t(v))
    for w in (128, 1000):
        got = flash_attention.flash_attention_fwd_lse(
            *args, segment_ids=_t(seg), window=w)
        ref = flash_attention.flash_attention_fwd_lse(
            *args, segment_ids=_t(seg))
        for a, b in zip(got, ref):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_rows_that_see_nothing_give_zeros():
    """Non-causal rows with Sq > Sk + window see no key: out 0, lse 0,
    as the kernel's l == 0 guard gives."""
    rng = np.random.default_rng(9)
    q = torch.from_numpy(rng.normal(size=(1, 96, 4, 32)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(1, 40, 2, 32)).astype(np.float32))
    out, lse = flash_attention.flash_attention_fwd_lse(q, k, k,
                                                       causal=False,
                                                       window=30)
    # Row p sees keys k > p - 30: none once p >= 40 + 29.
    assert out[0, 69:].abs().max() == 0 and lse[0, :, 69:].abs().max() == 0
    assert out[0, :69].abs().sum(-1).min() > 0


def _jax_vjp(q, k, v, do, seg, causal, window):
    out, vjp = jax.vjp(
        lambda q_, k_, v_: jax_flash.flash_attention(
            q_, k_, v_, causal=causal, segment_ids=_j(seg), block_q=64,
            block_k=64, window=window),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return out, vjp(jnp.asarray(do))


@pytest.mark.parametrize('with_seg', [False, True])
@pytest.mark.parametrize('window', [7, 48, 100])
def test_backward_matches_pallas_interpret(window, with_seg):
    """dq, dk and dv of the port's FlashAttention (its plain backward)
    against jax.vjp of flash_attention (the Pallas _dq_kernel and
    _dkv_kernel in interpret mode) at S = 128, causal."""
    q, k, v, do, seg = _inputs(128, 100 + window, with_seg)
    jout, jgrads = _jax_vjp(q, k, v, do, seg, True, window)
    leaves = [_t(x).requires_grad_() for x in (q, k, v)]
    out = flash_attention.flash_attention(*leaves, causal=True,
                                          segment_ids=_t(seg),
                                          window=window)
    out.backward(_t(do))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               **TOL)
    for name, x, jg in zip(('dq', 'dk', 'dv'), leaves, jgrads):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(jg), **TOL,
                                   err_msg=name)


def test_plain_backward_matches_autograd_of_the_reference():
    """flash_attention_bwd from the forward's out and lse equals autograd
    through mha_reference with the same window, non-causal."""
    q, k, v, do, seg = _inputs(96, 11, True)
    qt, kt, vt, do_t, seg_t = _t(q), _t(k), _t(v), _t(do), _t(seg)
    out, lse = flash_attention.flash_attention_fwd_lse(
        qt, kt, vt, causal=False, segment_ids=seg_t, window=20)
    got = flash_attention.flash_attention_bwd(qt, kt, vt, out, lse, do_t,
                                              causal=False,
                                              segment_ids=seg_t, window=20)
    leaves = [x.clone().requires_grad_() for x in (qt, kt, vt)]
    ref_out = attention.mha_reference(*leaves, causal=False,
                                      segment_ids=seg_t, window=20)
    ref = torch.autograd.grad(ref_out, leaves, do_t)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, **TOL)


@pytest.mark.parametrize('impl,kw,flash', [
    ('auto', {}, True),
    ('flash', {}, True),
    ('xla', {}, False),
    ('auto', {'logit_softcap': 30.0}, False),
])
def test_dispatch_sends_a_window_to_flash(monkeypatch, impl, kw, flash):
    """attention(window > 0) reaches flash_attention with the window
    under 'auto' and 'flash' (a spy: on the CPU it runs the plain
    version), and the reference under 'xla' or with a soft-cap; both
    agree with the JAX package's reference. Head_dim 64: 'auto' takes
    the flash kernels only for a multiple of 64 (the JAX package's
    _flash_ok rule)."""
    seen = []
    real = flash_attention.flash_attention

    def spy(*args, **kwargs):
        seen.append(kwargs.get('window'))
        return real(*args, **kwargs)
    monkeypatch.setattr(flash_attention, 'flash_attention', spy)
    rng = np.random.default_rng(3)
    q = rng.normal(size=(1, 64, 4, 64)).astype(np.float32)
    k, v = (rng.normal(size=(1, 64, 2, 64)).astype(np.float32)
            for _ in range(2))
    out = attention.attention(_t(q), _t(k), _t(v), causal=True, window=9,
                              impl=impl, **kw)
    assert seen == ([9] if flash else [])
    ref = jax_attention.mha_reference(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), causal=True, window=9,
                                      **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize('window,exc', [(-1, ValueError), (4.0, TypeError),
                                        (True, TypeError),
                                        (np.int64(4), TypeError)])
def test_wrappers_refuse_a_bad_window(window, exc):
    """Every entry refuses a window that is not an int >= 0 before any
    launch, on CPU tensors too."""
    q = torch.zeros((1, 64, 4, 64), dtype=torch.bfloat16)
    k = torch.zeros((1, 64, 2, 64), dtype=torch.bfloat16)
    lse = torch.zeros((1, 4, 64))
    calls = (
        lambda: flash_attention.flash_attention(q, k, k, window=window),
        lambda: flash_attention.flash_attention_fwd_lse(q, k, k,
                                                        window=window),
        lambda: flash_attention.flash_attention_bwd(q, k, k, q, lse, q,
                                                    window=window),
        lambda: flash_attention.flash_bwd_cuda(q, k, k, q, lse, lse, None,
                                               True, window),
        lambda: flash_attention._flash_cuda(q, k, k, None, True, window),
    )
    for call in calls:
        with pytest.raises(exc, match='window'):
            call()
