"""The port's weight-only int8/int4 quantization (models/quant.py, the
QuantLinear / QuantLinear4 projections of models/llama.py) against the
JAX package's, on the CPU at the 'debug' preset:

  * codes and scales byte-equal to the reference's _quantize_kernel,
    _quantize_kernel_int4 and the host mirrors _np_quantize_kernel(_int4)
    on random weights, an all-zero output channel, exact half-step ties
    (round half to even) and `in` below 128 (one int4 group);
  * QuantLinear / QuantLinear4 against QuantDense / QuantDense4 on the
    same codes: float32 within 1e-5, bfloat16 within one bf16 step of the
    output's scale (2e-2 relative: both round products to bf16);
  * the quantized model's logits against the reference's quantize_params
    model through params_from_jax (float32, 1e-5);
  * load_llama_params(quantize=) byte-equal to quantize_params of the
    float load; build_engine(checkpoint=, quantize=, spec_decode=2)
    greedy streams equal to the reference's;
  * a LoRA delta over a quantized base; the quantized random init.
"""
import dataclasses

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.infer import engine as jax_engine
from skypilot_tpu.infer import server as jax_server
from skypilot_tpu.models import llama as jax_llama
from skypilot_tpu.models import quant as jax_quant
from skypilot_tpu.models import weights as jax_weights
from skypilot_tpu_torch.infer import engine as torch_engine
from skypilot_tpu_torch.infer import lora as lora_lib
from skypilot_tpu_torch.infer import server as torch_server
from skypilot_tpu_torch.models import llama, quant, weights

MAX_SEQ = 64
MODES = ('int8', 'int4')
_DEBUG = dataclasses.replace(jax_llama.CONFIGS['debug'], max_seq_len=MAX_SEQ)


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope='module')
def ckpt(tmp_path_factory):
    """The debug model's float params and their HF checkpoint, written
    by the reference."""
    params = jax.jit(jax_llama.LlamaModel(_DEBUG).init)(
        jax.random.PRNGKey(7), jnp.zeros((1, 8), jnp.int32))
    d = str(tmp_path_factory.mktemp('qckpt'))
    jax_weights.save_hf_checkpoint(_DEBUG, params, d)
    return params, d


def _weight(case):
    """A [out, in] f32 weight for each quantizer case."""
    rng = np.random.default_rng(11)
    if case == 'random':
        return rng.normal(0, 0.05, (48, 256)).astype(np.float32)
    if case == 'zero_channel':
        w = rng.normal(0, 0.05, (16, 256)).astype(np.float32)
        w[5] = 0.0
        w[9, 128:] = 0.0          # an all-zero int4 group too
        return w
    if case == 'ties':
        # amax 127 * 2^-3 in every row and group: scale 2^-3 (int8) and
        # 127/7 * 2^-3 (int4); the rest are odd multiples of half a step,
        # so w / scale lands on k + 0.5 exactly in int8.
        w = (rng.integers(-100, 100, (8, 256)) + 0.5) * 2.0 ** -3
        w[:, ::128] = 127 * 2.0 ** -3
        return w.astype(np.float32)
    if case == 'narrow':          # in < 128: one int4 group
        return rng.normal(0, 0.05, (24, 64)).astype(np.float32)
    raise ValueError(case)


CASES = ('random', 'zero_channel', 'ties', 'narrow')


@pytest.mark.parametrize('mode', MODES)
@pytest.mark.parametrize('case', CASES)
def test_codes_and_scales_byte_equal_to_the_reference(case, mode):
    w = _weight(case)
    if mode == 'int8':
        q, s = quant.quantize_kernel(torch.from_numpy(w))
        ref = jax_quant._quantize_kernel(jnp.asarray(w.T))
        host = jax_weights._np_quantize_kernel(w.T)
        got_q = q.numpy().T
    else:
        q, s = quant.quantize_kernel_int4(torch.from_numpy(w))
        ref = jax_quant._quantize_kernel_int4(jnp.asarray(w.T))
        host = jax_weights._np_quantize_kernel_int4(w.T)
        got_q = q.numpy().T
        # Packing round-trips the codes.
        assert torch.equal(quant.unpack_int4(quant.pack_int4(q)), q)
    for want_q, want_s in ((ref['kernel'], ref['scale']), host):
        want_q = np.asarray(want_q).astype(np.int8)
        want_s = np.asarray(want_s)
        assert want_s.dtype == np.float32 and s.dtype == torch.float32
        np.testing.assert_array_equal(got_q, want_q)
        assert s.numpy().tobytes() == want_s.tobytes()
    if case == 'ties' and mode == 'int8':
        # Half-step ties rounded to even, not away from zero.
        assert (np.abs(w * 8 - np.round(w * 8)) == 0.5).any()
        np.testing.assert_array_equal(q.numpy(), np.round(w * 8))


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('mode', MODES)
def test_quant_linear_matches_quant_dense(mode, dtype):
    rng = np.random.default_rng(5)
    din, dout = 256, 96
    w = rng.normal(0, 0.05, (dout, din)).astype(np.float32)
    x = rng.normal(0, 1, (3, 5, din)).astype(np.float32)
    cfg = dataclasses.replace(llama.CONFIGS['debug'], dtype=dtype,
                              quant=mode)
    jdt = jnp.float32 if dtype == 'float32' else jnp.bfloat16
    if mode == 'int8':
        q, s = quant.quantize_kernel(torch.from_numpy(w))
        mod = llama.QuantLinear(din, dout, cfg)
        mod.weight.copy_(q)
        jmod = jax_llama.QuantDense(features=dout, logical_axes=('a', 'b'),
                                    dtype=jdt)
        kernel = jnp.asarray(q.numpy().T)
    else:
        q, s = quant.quantize_kernel_int4(torch.from_numpy(w))
        mod = llama.QuantLinear4(din, dout, cfg)
        mod.weight.copy_(quant.pack_int4(q))
        jmod = jax_llama.QuantDense4(features=dout, logical_axes=('a', 'b'),
                                     dtype=jdt)
        kernel = jnp.asarray(q.numpy().T, jnp.int4)
    mod.scale.copy_(s)
    ref = jmod.apply({'params': {'kernel': kernel,
                                 'scale': jnp.asarray(s.numpy())}},
                     jnp.asarray(x, jdt))
    with torch.no_grad():
        got = mod(torch.from_numpy(x).to(llama.torch_dtype(dtype)))
    assert got.dtype == llama.torch_dtype(dtype)
    ref = np.asarray(ref.astype(jnp.float32))
    got = got.float().numpy()
    if dtype == 'float32':
        np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
    else:
        # bf16 inputs and outputs on both sides; the products accumulate
        # in f32 in different orders: within 2e-2 of the output's scale.
        np.testing.assert_allclose(got, ref, atol=2e-2 * np.abs(ref).max(),
                                   rtol=0)


def _jax_quant_logits(params, mode, toks):
    qp = jax.jit(jax_quant.quantize_params,
                 static_argnames='mode')(params, mode=mode)
    model = jax_llama.LlamaModel(dataclasses.replace(_DEBUG, quant=mode))
    return qp, np.asarray(jax.jit(model.apply)(qp, jnp.asarray(toks)))


@pytest.mark.parametrize('mode', MODES)
def test_quantized_logits_match_the_reference(ckpt, mode):
    params, _ = ckpt
    toks = np.random.default_rng(2).integers(0, 256, (2, 12))
    qp, ref = _jax_quant_logits(params, mode, toks)
    cfg = dataclasses.replace(llama.CONFIGS['debug'], quant=mode)
    sd = weights.params_from_jax(
        jax.tree_util.tree_map(np.asarray, nn.meta.unbox(qp)), cfg)
    model = llama.LlamaModel(cfg)
    model.load_state_dict(sd)
    assert isinstance(model.lm_head, (llama.QuantLinear, llama.QuantLinear4))
    with torch.no_grad():
        got = model(torch.as_tensor(toks)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize('mode', MODES)
def test_stream_load_equals_quantize_after_the_float_load(ckpt, mode):
    _, d = ckpt
    cfg = weights.load_config(d, dtype='float32', param_dtype='float32')
    want = quant.quantize_params(
        weights.load_llama_params(cfg, d, device='cpu'), mode)
    got = weights.load_llama_params(cfg, d, device='cpu', quantize=mode)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k
    # The embedding and the norms stay float; lm_head is quantized.
    assert got['tok_embed'].dtype == torch.float32
    assert got['final_norm.weight'].dtype == torch.float32
    assert 'lm_head.scale' in got


def _streams(eng, make_params, prompts):
    eng.start()
    try:
        return [eng.generate(p, make_params(max_new_tokens=m))
                for p, m in prompts]
    finally:
        eng.stop()


@pytest.mark.parametrize('mode', MODES)
def test_quantized_spec_engine_streams_equal(ckpt, mode):
    """build_engine(checkpoint=, quantize=, spec_decode=2) against the
    reference's: greedy streams equal, one prompt repeating itself so the
    n-gram proposer's drafts are taken."""
    _, d = ckpt
    rng = np.random.default_rng(4)
    prompts = [(rng.integers(1, 256, 9).tolist() * 3, 12),
               (rng.integers(1, 256, 17).tolist(), 8)]
    kw = dict(checkpoint=d, num_slots=2, max_seq_len=MAX_SEQ,
              dtype='float32', quantize=mode, spec_decode=2, decode_chunk=4)
    ref = _streams(jax_server.build_engine(**kw), jax_engine.SamplingParams,
                   prompts)
    eng = torch_server.build_engine(device='cpu', page_size=16, **kw)
    assert eng.model.cfg.quant == mode
    got = _streams(eng, torch_engine.SamplingParams, prompts)
    assert got == ref
    assert eng.perf_stats()['spec_verify_steps'] > 0


@pytest.mark.parametrize('mode', MODES)
def test_lora_delta_over_a_quantized_base(mode):
    """The adapter's delta over a QuantLinear equals its delta over the
    float Linear of the dequantized weight; a quantized model takes a
    stack (validate_stack)."""
    cfg = dataclasses.replace(llama.CONFIGS['debug'], quant=mode)
    rng = np.random.default_rng(8)
    tree = {'layers': {'mlp': {'w_down': {'kernel': {
        'a': rng.normal(0, .5, (2, 128, 4)),
        'b': rng.normal(0, .5, (2, 4, 64))}}}}}
    stack = lora_lib.build_stack([(tree, 8.0)], dtype='float32')
    model = llama.LlamaModel(cfg)
    gen = torch.Generator()
    gen.manual_seed(0)
    model.init_weights(gen)
    lora_lib.validate_stack(stack, model)
    qlin = model.layers[1].mlp.w_down
    if mode == 'int8':
        w = quant.dequantize_kernel(qlin.weight, qlin.scale)
    else:
        w = quant.dequantize_kernel_int4(quant.unpack_int4(qlin.weight),
                                         qlin.scale)
    flin = llama.Linear(128, 64, cfg)
    flin.weight.data.copy_(w)
    x = torch.from_numpy(rng.normal(0, 1, (3, 4, 128)).astype(np.float32))
    ids = torch.tensor([1, 0, 1], dtype=torch.int32)
    route = (stack, 'layers.1.', ids, stack['scaling'][ids])
    with torch.no_grad():
        dq = llama._proj(qlin, x, route, 'mlp.w_down') - qlin(x)
        df = llama._proj(flin, x, route, 'mlp.w_down') - flin(x)
    np.testing.assert_allclose(dq.numpy(), df.numpy(), atol=1e-5, rtol=0)
    assert float(dq[1].abs().max()) == 0.0 and float(dq[0].abs().max()) > 0


@pytest.mark.parametrize('mode', MODES)
def test_quantized_random_init_is_the_float_init_quantized(mode):
    base = dataclasses.replace(llama.CONFIGS['debug'], param_dtype='bfloat16',
                               dtype='bfloat16')
    models = []
    for q in ('none', mode):
        m = llama.LlamaModel(dataclasses.replace(base, quant=q))
        gen = torch.Generator()
        gen.manual_seed(3)
        m.init_weights(gen)
        models.append(m)
    want = quant.quantize_params(models[0], mode)
    got = models[1].state_dict()
    assert list(got) == list(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    # build_engine's random init takes the same route.
    eng = torch_server.build_engine('debug', device='cpu', dtype='bfloat16',
                                    seed=3, quantize=mode, page_size=16)
    for k, t in eng.model.state_dict().items():
        assert torch.equal(t, want[k]), k
