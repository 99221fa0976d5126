"""The PyTorch port's flash attention backward against the JAX package's,
on the CPU: the port's FlashAttention autograd Function (its plain
backward, flash_attention_bwd_reference, on CPU tensors) against jax.vjp
of skypilot_tpu.ops.flash_attention.flash_attention, whose backward runs
the two Pallas kernels (_dq_kernel, _dkv_kernel) in interpret mode, as
the JAX package's own tests run them on the CPU.

The same numpy inputs in float32 go to both: q [B, S, 4, 32], k/v
[B, S, 2, 32] (GQA), block_q = block_k = 64 so the Pallas grids have
several blocks; causal and non-causal rows, with and without segment
ids (id 0 as padding). Tolerance 2e-5 (atol and rtol), as for the
forward (tests/test_torch_ops.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.ops import flash_attention as jax_flash
from skypilot_tpu_torch.ops import attention as torch_attention
from skypilot_tpu_torch.ops import flash_attention

TOL = dict(atol=2e-5, rtol=2e-5)


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """One intra-op thread: the suite runs in parallel workers that share
    the host's cores, and these tensors are tiny."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _segments(b, s, seed):
    """Packed rows: 2-4 segments of random lengths and an id-0 tail."""
    rng = np.random.default_rng(seed)
    seg = np.zeros((b, s), np.int32)
    for i in range(b):
        cuts = np.sort(rng.choice(np.arange(8, s - 8), 3, replace=False))
        for j, (lo, hi) in enumerate(zip((0, *cuts[:-1]), cuts)):
            seg[i, lo:hi] = j + 1
    return seg


def _inputs(b, s, seed, with_seg):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, s, 4, 32)).astype(np.float32)
    k = rng.normal(size=(b, s, 2, 32)).astype(np.float32)
    v = rng.normal(size=(b, s, 2, 32)).astype(np.float32)
    do = rng.normal(size=(b, s, 4, 32)).astype(np.float32)
    seg = _segments(b, s, seed + 1) if with_seg else None
    return q, k, v, do, seg


def _jax_vjp(q, k, v, do, seg, causal):
    seg_j = None if seg is None else jnp.asarray(seg)
    out, vjp = jax.vjp(
        lambda q_, k_, v_: jax_flash.flash_attention(
            q_, k_, v_, causal=causal, segment_ids=seg_j, block_q=64,
            block_k=64), jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return out, vjp(jnp.asarray(do))


def _torch_grads(q, k, v, do, seg, causal):
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    seg_t = None if seg is None else torch.from_numpy(seg)
    out = flash_attention.flash_attention(qt, kt, vt, causal=causal,
                                          segment_ids=seg_t)
    out.backward(torch.from_numpy(do))
    return out.detach(), (qt.grad, kt.grad, vt.grad)


@pytest.mark.parametrize('b,s,causal,with_seg', [
    (1, 128, True, False),
    (2, 64, True, True),
    (1, 128, False, False),
    (1, 128, False, True),
    (2, 128, True, True),
])
def test_backward_matches_pallas_interpret(b, s, causal, with_seg):
    q, k, v, do, seg = _inputs(b, s, seed=b * 1000 + s, with_seg=with_seg)
    jax_out, jax_grads = _jax_vjp(q, k, v, do, seg, causal)
    out, grads = _torch_grads(q, k, v, do, seg, causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(jax_out), **TOL)
    for name, g, jg in zip(('dq', 'dk', 'dv'), grads, jax_grads):
        assert g.shape == jg.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), **TOL,
                                   err_msg=name)


def test_plain_backward_from_saved_residuals():
    """flash_attention_bwd (the Function's backward; on CPU tensors the
    plain version) from the forward's out and lse equals autograd
    through mha_reference."""
    q, k, v, do, seg = _inputs(2, 64, seed=7, with_seg=True)
    qt, kt, vt = (torch.from_numpy(x) for x in (q, k, v))
    seg_t, do_t = torch.from_numpy(seg), torch.from_numpy(do)
    out, lse = flash_attention.flash_attention_fwd_lse(
        qt, kt, vt, causal=True, segment_ids=seg_t)
    got = flash_attention.flash_attention_bwd(qt, kt, vt, out, lse, do_t,
                                              causal=True,
                                              segment_ids=seg_t)
    leaves = [x.clone().requires_grad_() for x in (qt, kt, vt)]
    ref_out = torch_attention.mha_reference(*leaves, causal=True,
                                            segment_ids=seg_t)
    ref = torch.autograd.grad(ref_out, leaves, do_t)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, **TOL)


def test_lone_segment_row_has_zero_dq():
    """A query whose segment id no other key carries sees only its own
    key: p = 1 there, so ds = p * (dp - delta) = 0 and its dq is 0."""
    q, k, v, do, _ = _inputs(1, 64, seed=3, with_seg=False)
    qt, kt, vt = (torch.from_numpy(x) for x in (q, k, v))
    seg = torch.ones((1, 64), dtype=torch.int32)
    seg[0, 10] = 5
    out, lse = flash_attention.flash_attention_fwd_lse(
        qt, kt, vt, causal=False, segment_ids=seg)
    dq, dk, dv = flash_attention.flash_attention_bwd_reference(
        qt, kt, vt, out, lse, torch.from_numpy(do), causal=False,
        segment_ids=seg)
    assert torch.isfinite(dq).all() and torch.isfinite(dk).all()
    torch.testing.assert_close(dq[0, 10], torch.zeros_like(dq[0, 10]),
                               atol=1e-5, rtol=0)


def test_kernel_wrapper_refuses_what_it_does_not_compute():
    """The kernel wrapper's checks run before any launch: f32 operands,
    head_dim 32 and Sq != Sk raise (here on CPU tensors, which the
    public entry would send to the plain version)."""
    q = torch.zeros((1, 64, 4, 32))
    k = torch.zeros((1, 64, 2, 32))
    lse = torch.zeros((1, 4, 64))
    with pytest.raises(TypeError, match='bfloat16'):
        flash_attention.flash_bwd_cuda(q, k, k, q, lse, lse, None, True)
    qb, kb = q.bfloat16(), k.bfloat16()
    with pytest.raises(ValueError, match='head_dim'):
        flash_attention.flash_bwd_cuda(qb, kb, kb, qb, lse, lse, None, True)
    q64 = torch.zeros((1, 64, 4, 64), dtype=torch.bfloat16)
    k32 = torch.zeros((1, 32, 2, 64), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match='Sq == Sk'):
        flash_attention.flash_bwd_cuda(q64, k32, k32, q64, lse, lse, None,
                                       True)


@pytest.mark.parametrize('what,make', [
    ('lse', lambda lse: lse[:, :, :32]),                 # [B, Hq, S/2]
    ('lse', lambda lse: lse.transpose(1, 2)),            # [B, S, Hq]
    ('lse', lambda lse: lse.double()),
    ('lse', lambda lse: lse.bfloat16()),
    ('lse', lambda lse: lse.transpose(1, 2).contiguous()
     .transpose(1, 2)),                                 # not contiguous
    ('delta', lambda lse: lse[:, :2]),                   # [B, Hq/2, S]
    ('delta', lambda lse: lse.half()),
    ('seg', lambda lse: torch.ones((1, 64), dtype=torch.int64)),
    ('seg', lambda lse: torch.ones((1, 64), dtype=torch.float32)),
    ('seg', lambda lse: torch.ones((1, 32), dtype=torch.int32)),
])
def test_kernel_wrapper_refuses_bad_side_inputs(what, make):
    """lse and delta must be contiguous f32 [B, Hq, S] and segment ids a
    contiguous int32 [B, S]: anything else raises before any launch (CPU
    tensors; the operands themselves are valid bf16)."""
    q = torch.zeros((1, 64, 4, 64), dtype=torch.bfloat16)
    k = torch.zeros((1, 64, 2, 64), dtype=torch.bfloat16)
    lse = torch.zeros((1, 4, 64))
    args = {'lse': lse, 'delta': lse, 'seg': None}
    args[what] = make(lse)
    match = 'segment_ids' if what == 'seg' else what
    with pytest.raises(ValueError, match=match):
        flash_attention.flash_bwd_cuda(q, k, k, q, args['lse'],
                                       args['delta'], args['seg'], True)
