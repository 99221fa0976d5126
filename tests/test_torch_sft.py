"""The PyTorch port's sft entrypoint and its training plumbing on the CPU
at the 'debug' preset: checkpoint resume (2 + 2 steps equal 4, exactly),
the Checkpointer's retention, the SIGTERM drill (a checkpoint, exit code
75, a resumed rerun, as the JAX package's chaos drill runs it),
sft.main end to end (synthetic and JSONL data, with and without the
prefetcher), the flags sft does not port yet (each exits with a reason),
DeferredMetrics' one-step lag and the Prefetcher's contracts.
tests/test_torch_train.py holds the parity with the JAX trainer.
"""
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from skypilot_tpu_torch.models import llama
from skypilot_tpu_torch.train import checkpoint as ckpt_lib
from skypilot_tpu_torch.train import prefetch, sft, trainer
from skypilot_tpu_torch.utils import metrics as metrics_lib

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """One intra-op thread: the suite runs in parallel workers that share
    the host's cores, and these tensors are tiny."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fresh_state():
    pm = llama.LlamaModel(llama.CONFIGS['debug'])
    gen = torch.Generator()
    gen.manual_seed(0)
    pm.init_weights(gen)
    tx = trainer.make_optimizer(trainer.TrainerConfig(warmup_steps=1,
                                                      total_steps=8))
    return trainer.create_state(pm, tx), trainer.make_train_step(pm, tx)


def test_checkpoint_resume_equals_an_unbroken_run(tmp_path):
    """2 steps, save, restore into a fresh state, 2 more steps: the same
    parameters, moments and step as 4 steps in one go, bit for bit."""
    data = sft.synthetic_batches(256, 2, 16, seed=20)
    batches = [{k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in next(data).items()} for _ in range(4)]
    state, step_fn = _fresh_state()
    for b in batches:
        state, _ = step_fn(state, b)

    first, step_fn1 = _fresh_state()
    for b in batches[:2]:
        first, _ = step_fn1(first, b)
    ckpt = ckpt_lib.Checkpointer(str(tmp_path / 'ck'),
                                 save_interval_steps=2)
    assert not ckpt.save(1, first)
    assert ckpt.save(2, first)
    ckpt.wait()
    assert ckpt.latest_step() == 2
    resumed, step_fn2 = _fresh_state()
    assert ckpt.restore(resumed) is resumed and resumed.step == 2
    for b in batches[2:]:
        resumed, _ = step_fn2(resumed, b)
    assert resumed.step == state.step == 4
    for (k, a), b in zip(state.model.state_dict().items(),
                         resumed.model.state_dict().values()):
        torch.testing.assert_close(b, a, rtol=0, atol=0, msg=k)
    sa, sb = state.optimizer.state_dict(), resumed.optimizer.state_dict()
    for i, st in sa['state'].items():
        for key in ('exp_avg', 'exp_avg_sq', 'step'):
            torch.testing.assert_close(sb['state'][i][key], st[key],
                                       rtol=0, atol=0)
    ckpt.close()


def test_checkpointer_keeps_the_newest(tmp_path):
    state, _ = _fresh_state()
    ckpt = ckpt_lib.Checkpointer(str(tmp_path / 'ck'), keep=2,
                                 save_interval_steps=1)
    assert ckpt.restore(state) is None
    for step in (1, 2, 3):
        assert ckpt.save(step, state)
    assert not ckpt.save(3, state, force=True)
    ckpt.close()
    assert ckpt.all_steps() == [2, 3]
    assert not [n for n in os.listdir(tmp_path / 'ck')
                if n.startswith('.tmp')]


def _sft_env():
    # One intra-op thread, as in-process: the debug model's tensors are
    # tiny, and a thread pool a worker makes each step ~15x slower.
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS='1')
    env.pop('JAX_COMPILATION_CACHE_DIR', None)
    return env


def test_sft_sigterm_checkpoints_and_exits_75(tmp_path):
    """SIGTERM mid-run: sft checkpoints at the next step boundary, waits
    for the write and exits 75; a rerun resumes from that step."""
    ckpt_dir = tmp_path / 'ckpt'
    args = [sys.executable, '-m', 'skypilot_tpu_torch.train.sft',
            '--device', 'cpu', '--model', 'debug', '--steps', '100000',
            '--batch', '1', '--seq', '16', '--checkpoint-dir',
            str(ckpt_dir), '--checkpoint-every', '5', '--log-every', '5']
    proc = subprocess.Popen(args, env=_sft_env(), cwd=str(tmp_path),
                            stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        deadline = time.time() + 120
        while time.time() < deadline:
            if proc.poll() is not None:
                raise AssertionError(f'sft died early rc={proc.returncode}'
                                     f':\n{proc.stdout.read()[-2000:]}')
            if ckpt_dir.exists() and any(p.name.isdigit()
                                         for p in ckpt_dir.iterdir()):
                break
            time.sleep(0.2)
        else:
            raise AssertionError('no checkpoint appeared')
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
        assert proc.returncode == ckpt_lib.EXIT_CODE_PREEMPTED == 75, \
            out[-2000:]
        assert 'preemption requested' in out
        saved = sorted(int(p.name) for p in ckpt_dir.iterdir()
                       if p.name.isdigit())
        assert saved, out[-2000:]
        resume_at = saved[-1]
        args2 = list(args)
        args2[args2.index('--steps') + 1] = str(resume_at + 3)
        out2 = subprocess.run(args2, env=_sft_env(), cwd=str(tmp_path),
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True,
                              timeout=120, check=True).stdout
        assert f'resumed from step {resume_at}' in out2
    finally:
        if proc.poll() is None:
            proc.kill()


def test_sft_main_runs_on_cpu(tmp_path):
    data = tmp_path / 'rows.jsonl'
    data.write_text('\n'.join(json.dumps({'text': f'row {i} of text'})
                              for i in range(5)))
    for extra in ([], ['--data', str(data), '--prefetch', '0']):
        out = sft.main(['--device', 'cpu', '--model', 'debug', '--steps',
                        '4', '--batch', '2', '--seq', '32', '--log-every',
                        '2'] + extra)
        assert out['steps'] == 4 and len(out['losses']) == 4
        assert all(np.isfinite(out['losses']))
        assert [log['step'] for log in out['logs']] == [2, 4]
        # Published losses lag one step: the first log is step 1's loss.
        assert out['logs'][0]['loss'] == pytest.approx(out['losses'][0])
        assert out['logs'][1]['loss'] == pytest.approx(out['losses'][2])
        assert out['logs'][0]['mfu'] is None        # no peak for the CPU


@pytest.mark.parametrize('flags,match', [
    (['--mesh', 'fsdp=2'], 'spans 2 devices'),
    (['--mesh', 'bogus=1'], 'unknown mesh axes'),
    (['--dcn-mesh', 'dp=2'], 'dcn-mesh'),
    (['--attn', 'ring'], 'ring'),
    (['--lora-rank', '8', '--model', 'debug-moe'], 'LoRA'),
    (['--base-checkpoint', '/nonexistent'], 'safetensors'),
    (['--data-tokenizer', '/nonexistent'], 'tokenizer'),
    (['--model', 'debug-moe'], 'MoE'),
])
def test_sft_refuses_unported_flags(flags, match):
    argv = ['--device', 'cpu', '--model', 'debug', '--steps', '1'] + flags
    with pytest.raises(SystemExit, match=match):
        sft.main(argv)


def test_sft_one_device_mesh_runs():
    out = sft.main(['--device', 'cpu', '--model', 'debug', '--mesh',
                    'dp=1,tp=1', '--steps', '1', '--batch', '1', '--seq',
                    '16', '--log-every', '1'])
    assert out['steps'] == 1


def test_deferred_metrics_publish_lags_one_step():
    pub = trainer.TrainMetricsPublisher(
        registry=metrics_lib.MetricsRegistry())
    dm = trainer.DeferredMetrics(pub)
    dm.on_step({'loss': torch.tensor(3.0), 'grad_norm': torch.tensor(1.0)})
    assert dm.publish() == {'loss': 3.0, 'grad_norm': 1.0}
    dm.on_step({'loss': torch.tensor(2.0), 'grad_norm': torch.tensor(0.5)})
    dm.on_step({'loss': torch.tensor(1.0), 'grad_norm': torch.tensor(0.25)})
    assert dm.publish(steps=2, step_time_s=0.5) == {'loss': 2.0,
                                                     'grad_norm': 0.5}
    assert pub.loss.value() == 2.0 and pub.steps.value() == 3
    assert pub.step_seconds.value() == 0.5


def test_prefetcher_order_errors_and_close():
    def source(n, fail_at=None):
        for i in range(n):
            if i == fail_at:
                raise ValueError('bad row')
            yield {'tokens': np.full((1, 4), i, np.int32)}
    place = prefetch.make_placer(torch.device('cpu'))
    pf = prefetch.Prefetcher(source(5), depth=2, place=place)
    got = [int(b['tokens'][0, 0]) for b in pf]
    assert got == list(range(5))
    pf.close()
    pf = prefetch.Prefetcher(source(5, fail_at=2), depth=2, place=place)
    assert int(next(pf)['tokens'][0, 0]) == 0
    assert int(next(pf)['tokens'][0, 0]) == 1
    with pytest.raises(ValueError, match='bad row'):
        next(pf)
    pf.close()
    pf = prefetch.Prefetcher(source(10**6), depth=2)
    next(pf)
    pf.close()                      # unblocks a producer on a full queue
    assert not pf._thread.is_alive()


def test_sft_refuses_to_run_without_cuda_unless_asked(monkeypatch):
    """The entrypoint trains on 'cuda' by default and raises where there
    is none; the CPU is used only when --device names it."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        sft.main(['--model', 'debug', '--steps', '1'])
