"""The port's HF checkpoint I/O against the JAX package's, on the CPU in
float32 at the 'debug' preset and tiny mistral/gemma configs: checkpoints
written once per module by the reference's save_hf_checkpoint.

  * the port's safetensors reader (models/safetensors_io.py) against the
    `safetensors` package: whole files, a checkpoint split into two shards
    with an index, BF16/F16/F32/I8 tensors, row reads;
  * the port's writer: its files load in the package and in the
    reference's load_llama_params (logits within 1e-5);
  * config_from_hf / config_to_hf equal to the reference's for llama
    (with and without the Llama-3.1 rope), mistral and gemma; the
    reference's rope_scaling errors (the other families:
    tests/test_torch_families.py; MoE: tests/test_torch_moe_weights.py);
  * load_llama_params against the reference's (logits within 1e-5), a
    tied checkpoint into an untied config, build_engine(checkpoint=)'s
    greedy streams equal to the reference engine's;
  * the server's main() with --checkpoint/--tokenizer (and
    SKYT_WEIGHTS_CHECKPOINT over it) in a subprocess;
  * sft's --base-checkpoint and --data-tokenizer.
"""
import dataclasses
import json
import os
import signal
import subprocess
import sys
import time
import urllib.request

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import safetensors.torch
import torch

from skypilot_tpu.infer import engine as jax_engine
from skypilot_tpu.infer import server as jax_server
from skypilot_tpu.infer import tokenizer as jax_tokenizer
from skypilot_tpu.models import llama as jax_llama
from skypilot_tpu.models import weights as jax_weights
from skypilot_tpu.train import sft as jax_sft
from skypilot_tpu_torch.infer import engine as torch_engine
from skypilot_tpu_torch.infer import server as torch_server
from skypilot_tpu_torch.infer import tokenizer as torch_tokenizer
from skypilot_tpu_torch.models import llama, safetensors_io, weights
from skypilot_tpu_torch.train import sft

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAX_SEQ = 64
ATOL = 1e-5

_DEBUG = dataclasses.replace(jax_llama.CONFIGS['debug'], max_seq_len=MAX_SEQ)
# The reference's families at debug size: llama, mistral (a window on
# every layer) and gemma (GeGLU, 1 + w norms, embed scale, tied,
# head_dim 32 != dim / heads).
FAMILIES = {
    'llama': _DEBUG,
    'mistral': dataclasses.replace(_DEBUG, sliding_window=8,
                                   rope_theta=10000.0, norm_eps=1e-6),
    'gemma': dataclasses.replace(_DEBUG, mlp_act='gelu_tanh',
                                 norm_zero_centered=True, embed_scale=True,
                                 tie_embeddings=True, head_dim_override=32,
                                 rope_theta=10000.0, norm_eps=1e-6),
}


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_params(cfg, seed):
    params = jax.jit(jax_llama.LlamaModel(cfg).init)(
        jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))
    if cfg.norm_zero_centered:
        # Random norm weights: an all-zero init would not tell a norm
        # weight from its neighbour.
        rng = np.random.default_rng(seed)
        params = jax.tree_util.tree_map_with_path(
            lambda p, x: jnp.asarray(rng.normal(0, .1, x.shape), x.dtype)
            if 'norm' in jax.tree_util.keystr(p) else x,
            nn.meta.unbox(params))
    return params


@pytest.fixture(scope='module')
def ckpts(tmp_path_factory):
    """{family: (jax cfg, jax params, dir)}, written by the reference."""
    out = {}
    for i, (fam, cfg) in enumerate(FAMILIES.items()):
        params = _jax_params(cfg, 42 + i)
        d = str(tmp_path_factory.mktemp(f'ckpt_{fam}'))
        jax_weights.save_hf_checkpoint(cfg, params, d)
        out[fam] = (cfg, params, d)
    return out


def _tokens(seed=0, b=2, s=12):
    return np.random.default_rng(seed).integers(0, 256, (b, s))


def _port_cfg(d):
    return weights.load_config(d, dtype='float32', param_dtype='float32',
                               max_seq_len=MAX_SEQ, remat=False)


def _port_logits(cfg, sd, toks):
    model = llama.LlamaModel(cfg, device='meta')
    model.load_state_dict(sd, assign=True)
    with torch.no_grad():
        return model(torch.as_tensor(toks)).numpy()


# ------------------------------------------------------------ the reader
@pytest.mark.parametrize('fam', list(FAMILIES))
def test_reader_equals_the_safetensors_package(ckpts, fam):
    path = os.path.join(ckpts[fam][2], 'model.safetensors')
    want = safetensors.torch.load_file(path)
    with safetensors_io.ShardReader(ckpts[fam][2]) as r:
        assert sorted(r.keys()) == sorted(want)
        for k, v in want.items():
            got = r.get(k)
            assert got.dtype == v.dtype and torch.equal(got, v), k
            del got


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float16,
                                   torch.float32, torch.int8])
def test_reader_two_shards_with_index(ckpts, dtype, tmp_path):
    """The llama checkpoint cast to `dtype` and split over two shards
    with model.safetensors.index.json: every tensor and a row range equal
    to what the package wrote; a lone shard file reads as itself."""
    src = safetensors.torch.load_file(
        os.path.join(ckpts['llama'][2], 'model.safetensors'))
    cast = {k: (v * 100).to(dtype) if dtype == torch.int8 else v.to(dtype)
            for k, v in src.items()}
    names = sorted(cast)
    shards = {'model-00001-of-00002.safetensors': names[::2],
              'model-00002-of-00002.safetensors': names[1::2]}
    for fname, keys in shards.items():
        safetensors.torch.save_file({k: cast[k] for k in keys},
                                    str(tmp_path / fname))
    with open(tmp_path / safetensors_io.INDEX_FILE, 'w') as f:
        json.dump({'metadata': {}, 'weight_map': {
            k: fname for fname, keys in shards.items() for k in keys}}, f)
    with safetensors_io.ShardReader(str(tmp_path)) as r:
        assert sorted(r.keys()) == names
        for k in names:
            got = r.get(k)
            assert got.dtype == dtype and torch.equal(got, cast[k]), k
            del got
        emb = 'model.embed_tokens.weight'
        rows = r.get_rows(emb, 3, 40)
        assert torch.equal(rows, cast[emb][3:40])
        del rows
    one = str(tmp_path / 'model-00002-of-00002.safetensors')
    with safetensors_io.ShardReader(one) as r:
        assert sorted(r.keys()) == sorted(names[1::2])


def test_reader_refuses_a_directory_without_shards(tmp_path):
    with pytest.raises(FileNotFoundError, match='safetensors'):
        safetensors_io.ShardReader(str(tmp_path))


@pytest.mark.parametrize('meta,match', [
    ({'dtype': 'F32', 'shape': [4, 4], 'data_offsets': [0, 128]},
     'outside the file'),
    ({'dtype': 'F32', 'shape': [4, 4], 'data_offsets': [0, 32]},
     'holds 32 bytes'),
    ({'dtype': 'F8_E4M3', 'shape': [4], 'data_offsets': [0, 4]},
     'dtype')])
def test_reader_refuses_a_malformed_header(meta, match, tmp_path):
    header = json.dumps({'w': meta}).encode()
    with open(tmp_path / 'model.safetensors', 'wb') as f:
        f.write(len(header).to_bytes(8, 'little') + header + bytes(64))
    with pytest.raises(ValueError, match=match):
        safetensors_io.ShardReader(str(tmp_path))


# ------------------------------------------------------------ the writer
@pytest.mark.parametrize('fam', list(FAMILIES))
def test_writer_loads_in_the_package_and_the_reference(ckpts, fam,
                                                       tmp_path):
    cfg, params, d = ckpts[fam]
    pcfg = _port_cfg(d)
    sd = weights.load_llama_params(pcfg, d, device='cpu')
    n = weights.save_hf_checkpoint(pcfg, sd, str(tmp_path))
    path = tmp_path / 'model.safetensors'
    assert n == os.path.getsize(path)
    got = safetensors.torch.load_file(str(path))
    want = safetensors.torch.load_file(os.path.join(d, 'model.safetensors'))
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    with open(tmp_path / 'config.json') as f:
        assert json.load(f) == jax_weights.config_to_hf(cfg)
    toks = _tokens()
    model = jax_llama.LlamaModel(cfg)
    apply = jax.jit(model.apply)
    ref = np.asarray(apply(params, jnp.asarray(toks)))
    reloaded = np.asarray(apply(
        jax_weights.load_llama_params(cfg, str(tmp_path)),
        jnp.asarray(toks)))
    np.testing.assert_allclose(reloaded, ref, atol=ATOL, rtol=0)


def test_writer_refuses_a_quantized_state_dict(ckpts, tmp_path):
    d = ckpts['llama'][2]
    sd = weights.load_llama_params(_port_cfg(d), d, device='cpu',
                                   quantize='int8')
    with pytest.raises(ValueError, match='quantized'):
        weights.save_hf_checkpoint(_port_cfg(d), sd, str(tmp_path))


# ------------------------------------------------------------ the config
def _fields_equal(port_cfg, ref_cfg):
    for f in dataclasses.fields(port_cfg):
        assert getattr(port_cfg, f.name) == getattr(ref_cfg, f.name), f.name


@pytest.mark.parametrize('name,cfg', [
    ('llama', _DEBUG),
    ('llama31', jax_llama.CONFIGS['llama3-8b']),
    ('mistral', jax_llama.CONFIGS['mistral-7b']),
    ('gemma', jax_llama.CONFIGS['gemma-7b']),
    ('gemma_debug', FAMILIES['gemma'])])
def test_config_from_hf_and_back_match_the_reference(name, cfg):
    hf = jax_weights.config_to_hf(cfg)
    assert hf['model_type'] == name.split('_')[0].replace('31', '')
    port = weights.config_from_hf(hf, dtype='float32')
    _fields_equal(port, jax_weights.config_from_hf(hf, dtype='float32'))
    assert weights.config_to_hf(port) == hf


@pytest.mark.parametrize('rope_scaling', [
    {'rope_type': 'yarn', 'factor': 4.0},
    {'type': 'longrope'},
    {'rope_type': 'llama3', 'factor': 32.0, 'low_freq_factor': 1.0,
     'high_freq_factor': 4.0, 'original_max_position_embeddings': 8192}])
def test_bad_rope_scaling_raises_the_reference_error(rope_scaling):
    hf = dict(jax_weights.config_to_hf(_DEBUG), rope_scaling=rope_scaling)
    with pytest.raises(ValueError) as ref:
        jax_weights.config_from_hf(hf)
    with pytest.raises(ValueError) as got:
        weights.config_from_hf(hf)
    assert str(got.value) == str(ref.value)


# ------------------------------------------------------------ the loader
@pytest.mark.parametrize('fam', list(FAMILIES))
def test_load_llama_params_logits_match_the_reference(ckpts, fam):
    cfg, _, d = ckpts[fam]
    toks = _tokens(1)
    ref = np.asarray(jax.jit(jax_llama.LlamaModel(cfg).apply)(
        jax_weights.load_llama_params(cfg, d), jnp.asarray(toks)))
    got = _port_logits(_port_cfg(d),
                       weights.load_llama_params(_port_cfg(d), d,
                                                 device='cpu'), toks)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


def test_tied_checkpoint_into_untied_config(ckpts):
    """The gemma checkpoint is tied (no lm_head tensor): an untied config
    takes the embedding as its head, as the reference does."""
    d = ckpts['gemma'][2]
    cfg = dataclasses.replace(_port_cfg(d), tie_embeddings=False)
    sd = weights.load_llama_params(cfg, d, device='cpu')
    assert torch.equal(sd['lm_head.weight'], sd['tok_embed'])
    ref = jax_weights.load_llama_params(
        dataclasses.replace(ckpts['gemma'][0], tie_embeddings=False), d)
    np.testing.assert_array_equal(
        sd['lm_head.weight'].numpy(),
        np.asarray(ref['params']['lm_head']['kernel']).T)


def test_bf16_load_casts_like_the_reference(ckpts):
    cfg, _, d = ckpts['llama']
    ref = jax_weights.load_llama_params(cfg, d, param_dtype='bfloat16')
    sd = weights.load_llama_params(_port_cfg(d), d, device='cpu',
                                   param_dtype='bfloat16')
    want = np.asarray(ref['params']['layers']['attn']['wq']['kernel'][1],
                      np.float32).T
    got = sd['layers.1.attn.wq.weight']
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)


def _drain(q):
    out = []
    while True:
        tok = q.get(timeout=300)
        if tok is None:
            return out
        out.append(tok)


def _streams(eng, make_params, prompts):
    """A burst submitted before start() (ragged admission), then a lone
    request."""
    qs = [eng.submit(p, make_params(max_new_tokens=m))[1]
          for p, m in prompts[:-1]]
    eng.start()
    try:
        outs = [_drain(q) for q in qs]
        p, m = prompts[-1]
        return outs + [eng.generate(p, make_params(max_new_tokens=m))]
    finally:
        eng.stop()


PROMPTS = [(np.random.default_rng(3).integers(1, 256, n).tolist(), m)
           for n, m in ((5, 8), (17, 6), (9, 8), (11, 10))]


@pytest.mark.parametrize('fam', ['llama', 'gemma'])
def test_build_engine_from_a_checkpoint_streams_equal(ckpts, fam):
    d = ckpts[fam][2]
    ref = _streams(jax_server.build_engine(
        checkpoint=d, num_slots=4, max_seq_len=MAX_SEQ, dtype='float32',
        decode_chunk=4), jax_engine.SamplingParams, PROMPTS)
    eng = torch_server.build_engine(
        checkpoint=d, num_slots=4, max_seq_len=MAX_SEQ, dtype='float32',
        decode_chunk=4, page_size=16, device='cpu')
    assert eng.model.cfg.max_seq_len == MAX_SEQ
    assert eng.model.tok_embed.dtype == torch.float32
    got = _streams(eng, torch_engine.SamplingParams, PROMPTS)
    assert got == ref


def test_build_engine_refuses_bad_arguments(ckpts):
    d = ckpts['llama'][2]
    with pytest.raises(ValueError, match='quantize'):
        torch_server.build_engine(checkpoint=d, device='cpu',
                                  quantize='int3')
    with pytest.raises(ValueError, match='not both'):
        torch_server.build_engine(checkpoint=d, device='cpu', params={})


# ------------------------------------------------------------ the server
def _write_tokenizer(d):
    """A WordLevel tokenizer.json (the tokenizers runtime) and its
    tokenizer_config.json with bos/eos."""
    import tokenizers
    from tokenizers import models as tok_models
    from tokenizers import pre_tokenizers
    vocab = {'<s>': 0, '</s>': 1, '<unk>': 2, 'hello': 3, 'tpu': 4,
             'world': 5, 'again': 6}
    tok = tokenizers.Tokenizer(tok_models.WordLevel(vocab,
                                                    unk_token='<unk>'))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    tok.save(os.path.join(d, 'tokenizer.json'))
    with open(os.path.join(d, 'tokenizer_config.json'), 'w') as f:
        json.dump({'bos_token': '<s>', 'eos_token': '</s>'}, f)


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def _call(port, path, body=None):
    req = urllib.request.Request(
        f'http://127.0.0.1:{port}{path}',
        data=None if body is None else json.dumps(body).encode(),
        method='GET' if body is None else 'POST')
    with urllib.request.urlopen(req, timeout=60) as resp:
        return json.loads(resp.read())


def _start_server(argv, env_extra):
    port = _free_port()
    env = dict(os.environ)
    env.pop('SKYT_WEIGHTS_CHECKPOINT', None)
    # One intra-op thread, as in-process (the module's fixture): the
    # debug-sized tensors gain nothing from a thread pool a server.
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS='1', **env_extra)
    proc = subprocess.Popen(
        [sys.executable, '-m', 'skypilot_tpu_torch.infer.server',
         '--device', 'cpu', '--dtype', 'float32', '--num-slots', '2',
         '--max-seq-len', str(MAX_SEQ), '--port', str(port), *argv],
        cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    return proc, port


def _wait_healthy(proc, port):
    t0 = time.time()
    while time.time() - t0 < 120:
        assert proc.poll() is None, proc.stdout.read()[-3000:]
        try:
            if _call(port, '/health')['status'] == 'ok':
                return
        except OSError:
            time.sleep(0.3)
    raise AssertionError('server never became healthy')


def _stop(proc):
    proc.send_signal(signal.SIGTERM)
    try:
        rc = proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return rc, proc.stdout.read()


def test_server_main_serves_a_checkpoint_with_its_tokenizer(ckpts,
                                                            tmp_path):
    """main() --checkpoint D --tokenizer T: the model id is D's name,
    /generate on text equals /generate on the reference tokenizer's ids;
    a second replica with SKYT_WEIGHTS_CHECKPOINT=D2 serves D2 whatever
    --checkpoint says. Both exit 0 on SIGTERM."""
    d, d2 = ckpts['llama'][2], ckpts['mistral'][2]
    tok_dir = str(tmp_path)
    _write_tokenizer(tok_dir)
    a, port_a = _start_server(['--checkpoint', d, '--tokenizer', tok_dir],
                              {})
    b, port_b = _start_server(['--checkpoint', '/nonexistent'],
                              {'SKYT_WEIGHTS_CHECKPOINT': d2})
    try:
        _wait_healthy(a, port_a)
        _wait_healthy(b, port_b)
        models = _call(port_a, '/v1/models')
        assert models['data'][0]['id'] == os.path.basename(d)
        text = 'hello tpu world again'
        ids = jax_tokenizer.load_tokenizer(tok_dir).encode(text)
        by_text = _call(port_a, '/generate', {'text': text,
                                              'max_tokens': 6})
        by_ids = _call(port_a, '/generate', {'tokens': ids,
                                             'max_tokens': 6})
        assert by_text['tokens'] == by_ids['tokens']
        assert len(by_text['tokens']) == 6
        assert _call(port_b, '/v1/models')['data'][0]['id'] == \
            os.path.basename(d2)
    finally:
        rc_a, out_a = _stop(a)
        rc_b, out_b = _stop(b)
    assert rc_a == 0, out_a[-3000:]
    assert rc_b == 0, out_b[-3000:]
    assert 'SKYT_WEIGHTS_CHECKPOINT overrides' in out_b
    # The byte fallback, with the reference's warning: D2 has no
    # tokenizer.json.
    assert 'byte fallback' in out_b


# ------------------------------------------------------------ sft
def test_sft_base_checkpoint_loads_the_checkpoint(ckpts, monkeypatch):
    d = ckpts['llama'][2]
    seen = {}
    real = sft.load_base_checkpoint

    def spy(model, path, device):
        real(model, path, device)
        seen.update({k: v.clone() for k, v in model.state_dict().items()})
    monkeypatch.setattr(sft, 'load_base_checkpoint', spy)
    out = sft.main(['--device', 'cpu', '--model', 'debug', '--steps', '1',
                    '--batch', '1', '--seq', '16', '--log-every', '1',
                    '--base-checkpoint', d])
    assert out['steps'] == 1 and np.isfinite(out['losses']).all()
    want = safetensors.torch.load_file(os.path.join(d, 'model.safetensors'))
    names = dict(weights.hf_names(llama.CONFIGS['debug']))
    assert sorted(seen) == sorted(names)
    for key, hf in names.items():
        assert seen[key].dtype == torch.float32
        assert torch.equal(seen[key], want[hf]), key


def test_sft_resume_skips_the_base_load(ckpts, tmp_path, monkeypatch):
    d = ckpts['llama'][2]
    calls = []
    monkeypatch.setattr(sft, 'load_base_checkpoint',
                        lambda *a: calls.append(a))
    argv = ['--device', 'cpu', '--model', 'debug', '--batch', '1', '--seq',
            '16', '--log-every', '1', '--base-checkpoint', d,
            '--checkpoint-dir', str(tmp_path / 'run')]
    sft.main(argv + ['--steps', '1'])
    assert len(calls) == 1
    out = sft.main(argv + ['--steps', '2'])
    assert len(calls) == 1 and out['start_step'] == 1


@pytest.mark.parametrize('hf_over,match', [
    ({'vocab_size': 512}, "vocab_size=512 does not match --model 'debug' "
                          'vocab_size=256'),
    ({'intermediate_size': 96}, 'mlp_dim=96 does not match'),
    ({'model_type': 'mixtral'},
     "--base-checkpoint is 'mixtral' but --model 'debug' is dense")])
def test_sft_base_checkpoint_mismatch_exits(hf_over, match, tmp_path):
    """Before any weight is read (the dir holds only config.json)."""
    hf = dict(jax_weights.config_to_hf(_DEBUG), **hf_over)
    with open(tmp_path / 'config.json', 'w') as f:
        json.dump(hf, f)
    with pytest.raises(SystemExit, match=match):
        sft.main(['--device', 'cpu', '--model', 'debug', '--steps', '1',
                  '--base-checkpoint', str(tmp_path)])


def test_sft_dense_checkpoint_under_a_moe_model_exits(ckpts):
    with pytest.raises(SystemExit,
                       match="is 'llama' but --model 'debug-moe' is MoE"):
        sft.main(['--device', 'cpu', '--model', 'debug-moe', '--steps', '1',
                  '--base-checkpoint', ckpts['llama'][2]])


def test_sft_data_tokenizer_batches_equal_the_reference(tmp_path):
    _write_tokenizer(str(tmp_path))
    data = tmp_path / 'rows.jsonl'
    data.write_text('\n'.join(
        json.dumps({'text': ' '.join(['hello', 'tpu', 'world',
                                      'again'][:1 + i % 4])})
        for i in range(7)) + '\n' + json.dumps({'tokens': [7, 8, 9]}))
    ref = jax_sft.jsonl_batches(
        str(data), 256, 2, 8,
        tokenizer=jax_tokenizer.load_tokenizer(str(tmp_path)))
    got = sft.jsonl_batches(
        str(data), 256, 2, 8,
        tokenizer=torch_tokenizer.load_tokenizer(str(tmp_path)))
    for _ in range(3):
        a, b = next(ref), next(got)
        np.testing.assert_array_equal(b['tokens'], a['tokens'])
        np.testing.assert_array_equal(b['targets'], a['targets'])
    out = sft.main(['--device', 'cpu', '--model', 'debug', '--steps', '1',
                    '--batch', '2', '--seq', '8', '--log-every', '1',
                    '--prefetch', '0', '--data', str(data),
                    '--data-tokenizer', str(tmp_path)])
    assert out['steps'] == 1 and np.isfinite(out['losses']).all()
