"""The port's LoRA lifecycle against the JAX package's, on the CPU at the
'debug' preset in float32: one numpy base (the JAX model's init), one
numpy adapter tree (init_lora_params' shapes, A and B drawn from a seed
so that B != 0), then

  * apply_lora's adapters target the paths and shapes of
    init_lora_params (scanned and unscanned trees), B = 0;
  * the merged-at-use forward's logits against model.apply(merge_lora);
  * three LoRA train steps (loss, grad_norm, A and B after each) against
    make_lora_train_step on a one-device mesh, jitted; the base stays
    bit-unchanged and AdamW's state covers the adapters only;
  * sft.main --lora-rank from an HF base checkpoint: its checkpoints hold
    the adapter state only, and a run preempted (SIGTERM, exit 75) and
    resumed ends in the unbroken run's bits;
  * export_lora's merged tensors against merge_lora of the same trees;
    its refusals (no checkpoint, another rank);
  * load_adapter_dir -> build_stack_from_specs against build_stack of the
    tree, and the finetune -> export -> serve loop (the reference's
    test_finetune_export_serve_loop): serving the adapter's id gives the
    merged checkpoint's greedy tokens.

Tolerances: logits 1e-5 (rtol and atol), train steps 1e-5, merged
weights 1e-6: two frameworks' f32 arithmetic over two layers.
"""
import dataclasses
import os
import signal

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.models import llama as jax_llama
from skypilot_tpu.parallel import mesh as mesh_lib
from skypilot_tpu.train import lora as jax_lora
from skypilot_tpu.train import trainer as jax_trainer
from skypilot_tpu_torch.infer import engine as torch_engine
from skypilot_tpu_torch.infer import lora as infer_lora
from skypilot_tpu_torch.infer import server as torch_server
from skypilot_tpu_torch.models import llama, weights
from skypilot_tpu_torch.train import export_lora, lora, sft, trainer

LOGIT_TOL = dict(atol=1e-5, rtol=1e-5)
STEP_TOL = dict(atol=1e-5, rtol=1e-5)
MERGE_TOL = dict(atol=1e-6, rtol=1e-6)
RANK, ALPHA = 4, 8.0
B, S = 2, 16


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """One intra-op thread: the suite runs in parallel workers that share
    the host's cores, and these tensors are tiny."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_base(scan=True):
    cfg = dataclasses.replace(jax_llama.CONFIGS['debug'], scan_layers=scan)
    jm = jax_llama.LlamaModel(cfg)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, 8),
                                                           jnp.int32))
    return jm, _np(nn.meta.unbox(jp))['params']


def _adapter_tree(params, seed=3):
    """init_lora_params' tree with A and B redrawn N(0, 0.1) (numpy)."""
    tree = jax.eval_shape(lambda key: jax_lora.init_lora_params(
        params, jax_lora.LoRAConfig(rank=RANK, alpha=ALPHA), key),
        jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: rng.normal(0, 0.1, x.shape).astype(np.float32), tree)


def _port(params, attn='flash'):
    # 'flash': the debug preset's head_dim 16 takes the reference under
    # 'auto'; this holds the flash path (its plain version) to JAX.
    cfg = dataclasses.replace(llama.CONFIGS['debug'], attn_impl=attn)
    model = llama.LlamaModel(cfg)
    model.load_state_dict(weights.params_from_jax(params, cfg))
    return model


def _lora_port(params, tree=None):
    model = _port(params)
    gen = torch.Generator()
    gen.manual_seed(1)
    cfg = lora.LoRAConfig(rank=RANK, alpha=ALPHA)
    adapters = lora.apply_lora(model, cfg, gen)
    if tree is not None:
        lora.load_adapter_values(adapters, tree)
    return model, cfg, adapters


@pytest.fixture(scope='module')
def base():
    jm, params = _jax_base()
    return jm, params, _adapter_tree(params)


def _batch(seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, 256, (B, S + 1)).astype(np.int32)
    return {'tokens': toks[:, :-1], 'targets': toks[:, 1:]}


@pytest.mark.parametrize('scan', [True, False])
def test_adapter_init_targets_match_jax(base, scan):
    params = base[1] if scan else _jax_base(scan=False)[1]
    ref = jax_lora.init_lora_params(
        params, jax_lora.LoRAConfig(rank=RANK, alpha=ALPHA),
        jax.random.PRNGKey(1))
    want = {k: (a.shape, b.shape)
            for k, (a, b) in infer_lora.module_adapter(_np(ref)).items()}
    _, _, adapters = _lora_port(params)
    got = {k: (tuple(a.shape), tuple(b.shape))
           for k, (a, b) in adapters.items()}
    assert got == want and len(got) == 7 * 2
    assert all(not b.any() for _, b in adapters.values())
    # The reference's trainable count, and the same paths through the
    # JAX tree reader.
    assert lora.num_lora_params(adapters) == jax_lora.num_lora_params(ref)
    assert set(lora.adapters_from_jax(_np(ref))) == set(adapters)


def test_merged_forward_matches_jax(base):
    jm, params, tree = base
    lcfg = jax_lora.LoRAConfig(rank=RANK, alpha=ALPHA)
    toks = np.random.default_rng(4).integers(0, 256, (2, 12)).astype(
        np.int32)
    ref = jm.apply({'params': jax_lora.merge_lora(params, tree, lcfg)},
                   jnp.asarray(toks))
    model, _, _ = _lora_port(params, tree)
    with torch.no_grad():
        got = model(torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **LOGIT_TOL)
    # The adapter moves the logits (the check is not vacuous).
    plain = jm.apply({'params': params}, jnp.asarray(toks))
    assert np.abs(np.asarray(ref) - np.asarray(plain)).max() > 1e-2


def test_lora_train_steps_match_jax(base):
    jm, params, tree = base
    lcfg = jax_lora.LoRAConfig(rank=RANK, alpha=ALPHA)
    tcfg_kw = dict(warmup_steps=1, total_steps=10)
    mesh = mesh_lib.build_mesh(mesh_lib.MeshSpec(),
                               devices=jax.devices()[:1])
    jtx = jax_trainer.make_optimizer(jax_trainer.TrainerConfig(**tcfg_kw))
    jtree = jax.tree_util.tree_map(jnp.asarray, tree)
    jstate = jax_trainer.TrainStateS(step=jnp.zeros((), jnp.int32),
                                     params=jtree,
                                     opt_state=jtx.init(jtree))
    jstep = jax_lora.make_lora_train_step(
        jm, jax.tree_util.tree_map(jnp.asarray, params), jtx, mesh, lcfg)

    model, cfg, adapters = _lora_port(params, tree)
    frozen = {k: v.clone() for k, v in model.state_dict().items()
              if 'parametrizations.weight.0' not in k}
    tx = trainer.make_optimizer(trainer.TrainerConfig(**tcfg_kw))
    state = lora.create_lora_state(model, tx, cfg, adapters)
    step_fn = trainer.make_train_step(model, tx)
    for i in range(3):
        batch = _batch(10 + i)
        jstate, jmet = jstep(jstate, {k: jnp.asarray(v)
                                      for k, v in batch.items()})
        state, met = step_fn(state, {k: torch.from_numpy(
            np.ascontiguousarray(v)) for k, v in batch.items()})
        for key in ('loss', 'grad_norm'):
            np.testing.assert_allclose(met[key].item(), float(jmet[key]),
                                       **STEP_TOL, err_msg=f'{key} {i}')
        want = lora.adapters_from_jax(_np(jstate.params))
        for path, (a, b) in adapters.items():
            np.testing.assert_allclose(a.detach().numpy(),
                                       want[path][0].numpy(), **STEP_TOL,
                                       err_msg=f'{path} a {i}')
            np.testing.assert_allclose(b.detach().numpy(),
                                       want[path][1].numpy(), **STEP_TOL,
                                       err_msg=f'{path} b {i}')
    # The base is bit-unchanged and has no gradient; AdamW holds A and B.
    for k, v in frozen.items():
        assert torch.equal(model.state_dict()[k], v), k
    assert all(p.grad is None for n, p in model.named_parameters()
               if 'parametrizations.weight.0' not in n)
    opt = state.optimizer.state_dict()
    assert len(opt['state']) == 2 * len(adapters)
    ids = {id(p) for a, b in adapters.values() for p in (a, b)}
    assert {id(p) for p in state.params} == ids


def _capture_steps(real, box, preempt_after=None):
    """trainer.make_train_step's stand-in: its steps keep the last state
    in box['state'] and, with preempt_after=n, SIGTERM this process after
    the n-th step (sft then saves at that boundary and exits 75)."""
    def make(*args, **kw):
        step_fn = real(*args, **kw)
        calls = [0]

        def step(state, batch):
            out = step_fn(state, batch)
            box['state'] = out[0]
            calls[0] += 1
            if calls[0] == preempt_after:
                os.kill(os.getpid(), signal.SIGTERM)
            return out
        return step
    return make


@pytest.fixture(scope='module')
def lora_run(base, tmp_path_factory):
    """An HF base checkpoint of the JAX init (the port's writer), and
    sft.main --lora-rank on it: unbroken, then preempted after step 2 and
    resumed, with the same data (a JSONL of exactly two batches: sft
    restarts its stream on resume)."""
    _, params, _ = base
    root = tmp_path_factory.mktemp('lora')
    base_dir = str(root / 'base')
    pcfg = llama.CONFIGS['debug']
    weights.save_hf_checkpoint(pcfg, weights.params_from_jax(params, pcfg),
                               base_dir)
    rng = np.random.default_rng(7)
    data = str(root / 'two_batches.jsonl')
    with open(data, 'w') as f:
        f.write('{"tokens": %s}\n' % rng.integers(
            1, 256, 2 * B * (S + 1) - 1).tolist())
    # --lr 3: the schedule's 100-step warmup runs the 4 steps at 0-3% of
    # it, enough for the adapter to move the served greedy stream.
    argv = ['--device', 'cpu', '--model', 'debug', '--base-checkpoint',
            base_dir, '--lora-rank', str(RANK), '--lora-alpha', str(ALPHA),
            '--steps', '4', '--batch', str(B), '--seq', str(S),
            '--log-every', '1', '--lr', '3.0', '--data', data,
            '--prefetch', '0']
    real = trainer.make_train_step
    runs, code = {}, None
    try:
        for run in ('unbroken', 'preempted', 'resumed'):
            box = {}
            trainer.make_train_step = _capture_steps(
                real, box, 2 if run == 'preempted' else None)
            ckpt = str(root / ('unbroken' if run == 'unbroken' else 'run'))
            try:
                out = sft.main(argv + ['--checkpoint-dir', ckpt,
                                       '--checkpoint-every', '2'])
            except SystemExit as e:
                code = e.code
                continue
            runs[run] = (out, box['state'], ckpt)
    finally:
        trainer.make_train_step = real
    return base_dir, runs, code


def test_sft_lora_checkpoints_adapters_and_resumes_bit_equal(base,
                                                             lora_run):
    _, params, _ = base
    base_dir, runs, code = lora_run
    assert code == 75
    (out_a, sa, dir_a), (out_b, sb, _) = runs['unbroken'], runs['resumed']
    assert out_b['start_step'] == 2 and sa.step == sb.step == 4
    assert out_a['trainable_params'] == lora.num_lora_params(sa.adapters)
    assert out_a['losses'][2:] == out_b['losses']
    for path, (a, b) in sa.adapters.items():
        assert torch.equal(a, sb.adapters[path][0]), path
        assert torch.equal(b, sb.adapters[path][1]), path
    oa, ob = sa.optimizer.state_dict(), sb.optimizer.state_dict()
    for i in oa['state']:
        for key in ('exp_avg', 'exp_avg_sq'):
            assert torch.equal(oa['state'][i][key], ob['state'][i][key])
    # The base is the checkpoint's, bit for bit, after training (the
    # resumed run loaded it too: a LoRA checkpoint holds no base).
    want = weights.params_from_jax(params, llama.CONFIGS['debug'])
    for state in (sa, sb):
        got = {k.replace('.parametrizations.weight.original', '.weight'): v
               for k, v in state.model.state_dict().items()
               if 'parametrizations.weight.0' not in k}
        assert set(got) == set(want)
        for k, v in want.items():
            assert torch.equal(got[k], v.float()), k
    # The checkpoint holds the adapter state and nothing of the base.
    sd = torch.load(os.path.join(dir_a, '4', 'state.pt'),
                    weights_only=True)
    assert set(sd) == {'step', 'updates', 'mini_step', 'lora',
                       'lora_config', 'optimizer', 'acc_grads',
                       'trainer_config'}
    n_tensors = sum(t.numel() for t in jax.tree_util.tree_leaves(
        sd['lora']))
    assert n_tensors == lora.num_lora_params(sa.adapters)
    assert sd['lora_config']['rank'] == RANK


def test_export_lora_matches_reference_merge(base, lora_run, tmp_path):
    _, params, _ = base
    base_dir, runs, _ = lora_run
    _, state, run_dir = runs['unbroken']
    out = str(tmp_path / 'merged')
    export_lora.main(['--base', base_dir, '--adapter', run_dir, '--out',
                      out, '--lora-rank', str(RANK), '--lora-alpha',
                      str(ALPHA), '--device', 'cpu'])
    tree = infer_lora.load_adapter_dir(run_dir)
    ref = jax_lora.merge_lora(params, tree,
                              jax_lora.LoRAConfig(rank=RANK, alpha=ALPHA))
    pcfg = llama.CONFIGS['debug']
    want = weights.params_from_jax(_np(ref), pcfg)
    got = weights.load_llama_params(weights.load_config(out), out,
                                    device='cpu')
    assert set(got) == set(want)
    moved = 0
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), **MERGE_TOL,
                                   err_msg=k)
        moved += not np.array_equal(v.numpy(), weights.params_from_jax(
            params, pcfg)[k].numpy())
    assert moved == 7 * pcfg.n_layers   # every adapted projection moved


def test_export_lora_refusals(lora_run, tmp_path):
    base_dir, runs, _ = lora_run
    empty = tmp_path / 'empty'
    empty.mkdir()
    with pytest.raises(SystemExit, match='no checkpoint found'):
        export_lora.main(['--base', base_dir, '--adapter', str(empty),
                          '--out', str(tmp_path / 'o'), '--device', 'cpu',
                          '--lora-rank', str(RANK)])
    with pytest.raises(SystemExit, match='has rank 4.*--lora-rank is 8'):
        export_lora.main(['--base', base_dir, '--adapter',
                          runs['unbroken'][2], '--out',
                          str(tmp_path / 'o'), '--lora-rank', '8',
                          '--device', 'cpu'])
    assert not (tmp_path / 'o').exists()


def test_load_adapter_dir_refuses_what_it_cannot_read(tmp_path):
    with pytest.raises(FileNotFoundError):
        infer_lora.load_adapter_dir(str(tmp_path))
    orbax = tmp_path / 'orbax' / '3'
    orbax.mkdir(parents=True)
    with pytest.raises(ValueError, match='Orbax'):
        infer_lora.load_adapter_dir(str(tmp_path / 'orbax'))
    full = tmp_path / 'full' / '2'
    full.mkdir(parents=True)
    torch.save({'step': 2, 'model': {}}, str(full / 'state.pt'))
    with pytest.raises(ValueError, match='holds no adapters'):
        infer_lora.load_adapter_dir(str(tmp_path / 'full'))


def test_adapter_dir_stack_and_export_serve_loop(lora_run, tmp_path):
    """build_stack_from_specs of the sft dir equals build_stack of its
    tree; serving the adapter's id on the base checkpoint gives the
    merged checkpoint's greedy tokens."""
    base_dir, runs, _ = lora_run
    run_dir = runs['unbroken'][2]
    specs = infer_lora.parse_lora_flag([f'ft={run_dir}:{ALPHA}'])
    stack, names = infer_lora.build_stack_from_specs(specs,
                                                     dtype='float32')
    want = infer_lora.build_stack(
        [(infer_lora.load_adapter_dir(run_dir), ALPHA)], dtype='float32')
    assert names == {'ft': 1} and set(stack) == set(want)
    for k, v in want.items():
        for x, y in zip(v if isinstance(v, tuple) else (v,),
                        stack[k] if isinstance(v, tuple) else (stack[k],)):
            assert torch.equal(x, y), k
    merged = str(tmp_path / 'merged')
    export_lora.main(['--base', base_dir, '--adapter', run_dir, '--out',
                      merged, '--lora-rank', str(RANK), '--lora-alpha',
                      str(ALPHA), '--device', 'cpu'])
    prompt = [5, 9, 2, 31, 7, 7, 100, 3]

    def gen(ckpt, lora_id=0, stack=None):
        eng = torch_server.build_engine(checkpoint=ckpt, num_slots=2,
                                        max_seq_len=64, dtype='float32',
                                        device='cpu', lora_stack=stack)
        eng.start()
        try:
            return eng.generate(prompt, torch_engine.SamplingParams(
                max_new_tokens=8, lora_id=lora_id))
        finally:
            eng.stop()

    served = gen(base_dir, 1, stack)
    assert served == gen(merged)
    assert served != gen(base_dir)    # the adapter changes the stream
