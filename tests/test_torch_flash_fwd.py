"""The PyTorch port's flash-attention forward on the CPU: the checks its
kernel wrapper makes before any launch, and its plain version against
the JAX package's Pallas forward kernel.

_fwd_operands holds the forward kernel's (csrc/flash_fwd.cu) checks and
runs on tensors of any device, so its refusals are held here on CPU
tensors: unbuilt head dims, operands that are not bfloat16, strides or
bases that the kernel's TMA tensor maps cannot take (16-byte multiples),
query heads that are not a multiple of the kv heads, segment ids with
Sq != Sk or of another dtype or shape, and bad windows.

The parity cases fill what tests/test_torch_ops.py, test_torch_window.py
and test_torch_gemma.py leave out: batch > 1 with GQA, causal, without
segment ids at head_dim 64, and sequence lengths that are not multiples
of the kernel's 128-row query tiles. The same numpy inputs in float32 go
to skypilot_tpu.ops.flash_attention.flash_attention_fwd_lse (its Pallas
kernel in interpret mode, as the JAX package's own tests run it) and to
the port's flash_attention_fwd_lse on CPU tensors (the plain version).
Tolerance 2e-5 (atol and rtol), as tests/test_torch_ops.py's.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.ops import flash_attention as jax_flash
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


def _bf16(*shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


def _operands(b=1, sq=64, sk=64, hq=4, hkv=2, d=64):
    return _bf16(b, sq, hq, d), _bf16(b, sk, hkv, d), _bf16(b, sk, hkv, d)


def test_operands_pass_strides_window_and_scale():
    """A valid call: the pointers before the outputs (segment ids last,
    None without them) and the arguments after them, as the C entry
    point takes them; the window is cut to Sq + 1."""
    q, k, v = _operands(b=2, sq=64, sk=48, hq=8, hkv=2, d=128)
    ins, rest = flash_attention._fwd_operands(q, k, v, None, False,
                                              window=1000)
    assert ins == (q.data_ptr(), k.data_ptr(), v.data_ptr(), None)
    assert rest == (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3], 2,
                    64, 48, 8, 2, 128, 0, 65, 128 ** -0.5)
    seg = torch.ones((2, 64), dtype=torch.int32)
    q, k, v = _operands(b=2, sq=64, sk=64)
    ins, rest = flash_attention._fwd_operands(q, k, v, seg, True)
    assert ins[3] == seg.data_ptr()
    assert rest[-3:-1] == (1, 0)   # causal, no window


@pytest.mark.parametrize('d', [32, 96, 192, 320])
def test_operands_refuse_unbuilt_head_dims(d):
    q, k, v = _operands(d=d)
    with pytest.raises(ValueError, match='head_dim'):
        flash_attention._fwd_operands(q, k, v, None, True)


def test_operands_refuse_other_dtypes():
    q, k, v = _operands()
    with pytest.raises(TypeError, match='bfloat16'):
        flash_attention._fwd_operands(q.float(), k, v, None, True)
    with pytest.raises(TypeError, match='bfloat16'):
        flash_attention._fwd_operands(q, k, v.half(), None, True)


@pytest.mark.parametrize('which,make', [
    # A row pitch of 68 elements (136 bytes): not a 16-byte multiple.
    ('q', lambda: _bf16(1, 64, 4, 68)[..., :64]),
    ('k', lambda: _bf16(1, 64, 2, 68)[..., :64]),
    # A base 8 bytes past a 16-byte boundary, heads 152 bytes apart.
    ('v', lambda: _bf16(1, 64, 2, 76)[..., 4:68]),
    # A base 2 bytes past a 16-byte boundary.
    ('q', lambda: torch.zeros(1 + 64 * 4 * 64,
                              dtype=torch.bfloat16)[1:].view(1, 64, 4, 64)),
    # A unit stride that is not the last.
    ('q', lambda: _bf16(1, 64, 64, 4).transpose(2, 3)),
])
def test_operands_refuse_what_tma_cannot_take(which, make):
    """The kernel reads q, k and v through TMA tensor maps: the last
    stride 1, the others and the base 16-byte multiples."""
    ops = dict(zip('qkv', _operands()))
    ops[which] = make()
    with pytest.raises(ValueError, match='16-byte'):
        flash_attention._fwd_operands(ops['q'], ops['k'], ops['v'], None,
                                      True)


def test_operands_refuse_head_counts_and_shapes():
    q, k, v = _operands(hq=6, hkv=4)
    with pytest.raises(ValueError, match='multiple of kv heads'):
        flash_attention._fwd_operands(q, k, v, None, True)
    q, k, v = _operands()
    with pytest.raises(ValueError, match='shape mismatch'):
        flash_attention._fwd_operands(q, k, v[:, :32], None, True)
    with pytest.raises(ValueError, match='shape mismatch'):
        flash_attention._fwd_operands(q, k[..., :32], v[..., :32], None,
                                      True)
    with pytest.raises(ValueError, match=r'\[B, S, H, D\]'):
        flash_attention._fwd_operands(q[0], k, v, None, True)


@pytest.mark.parametrize('make', [
    # Sq != Sk: segment ids are one [B, S] row for queries and keys.
    lambda: (_operands(sq=64, sk=32), torch.ones((1, 64), dtype=torch.int32)),
    lambda: (_operands(), torch.ones((1, 64), dtype=torch.int64)),
    lambda: (_operands(), torch.ones((1, 64), dtype=torch.float32)),
    lambda: (_operands(), torch.ones((1, 32), dtype=torch.int32)),
    lambda: (_operands(), torch.ones((2, 64), dtype=torch.int32)),
    lambda: (_operands(), torch.ones((1, 128), dtype=torch.int32)[:, ::2]),
])
def test_operands_refuse_bad_segment_ids(make):
    (q, k, v), seg = make()
    with pytest.raises(ValueError, match='segment_ids'):
        flash_attention._fwd_operands(q, k, v, seg, True)


@pytest.mark.parametrize('window,error', [
    (-1, ValueError), (1.5, TypeError), (True, TypeError),
    (None, TypeError), (np.float32(4), TypeError)])
def test_operands_refuse_bad_windows(window, error):
    q, k, v = _operands()
    with pytest.raises(error, match='window'):
        flash_attention._fwd_operands(q, k, v, None, True, window)


@pytest.mark.parametrize('b,s,hq,hkv,d,causal', [
    (2, 256, 8, 2, 64, True),     # batch > 1, GQA 4, two 128-row tiles
    (3, 128, 4, 1, 64, True),     # batch 3, MQA, one tile exactly
    (2, 200, 4, 2, 64, True),     # a ragged last tile (200 = 128 + 72)
    (2, 130, 4, 2, 128, True),    # two rows past the first tile
    (2, 200, 4, 2, 64, False),    # ragged and not causal
])
def test_plain_forward_matches_pallas(b, s, hq, hkv, d, causal):
    """out and lse of the port's plain forward against the Pallas kernel
    in interpret mode, without segment ids."""
    rng = np.random.default_rng(b * 1000 + s + d)
    q = rng.normal(size=(b, s, hq, d)).astype(np.float32)
    k = rng.normal(size=(b, s, hkv, d)).astype(np.float32)
    v = rng.normal(size=(b, s, hkv, d)).astype(np.float32)
    out_j, lse_j = jax_flash.flash_attention_fwd_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal)
    out_t, lse_t = flash_attention.flash_attention_fwd_lse(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal)
    assert out_t.shape == (b, s, hq, d) and lse_t.shape == (b, hq, s)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **TOL)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), **TOL)
