"""SFT training entrypoint: `python -m skypilot_tpu_torch.train.sft`
(counterpart of skypilot_tpu/train/sft.py, the workload behind
examples/llama_finetune.yaml).

One device (`--device`, default 'cuda'; the CPU only when named): a
Llama preset with f32 master weights and bf16 compute, each block
rematerialised, attention through the flash kernels (forward and the dq
and dk/dv backward kernels), AdamW with the JAX trainer's schedule,
clipping and accumulation (train/trainer.py), a prefetcher that places
the next batches on a side stream (train/prefetch.py), one-step-deferred
metrics, MFU at log boundaries, checkpoint/resume and the preemption
exit (code 75) at a step boundary (train/checkpoint.py). Synthetic or
byte-level JSONL data, the same batches as the JAX entrypoint for the
same seed.

The run is bit-reproducible, as the JAX entrypoint's is: main() runs
with torch.use_deterministic_algorithms(True, warn_only=True), so the
flash backward adds dq in a fixed order and a run preempted (exit 75)
and resumed from its checkpoint ends in the same bits as an unbroken
one. It leaves
torch.utils.deterministic.fill_uninitialized_memory off: that fill of
every torch.empty (a debugging aid, no part of the results' bits) cost
~32 ms of a ~0.55 s llama3-1b step on an H100. The caller's settings
are restored when main() returns or exits.

The flags are the JAX entrypoint's. Those whose machinery belongs to
another slice exit with the reason instead of being ignored: a mesh of
more than one device, --dcn-mesh and --attn ring (parallelism),
--lora-rank > 0 (LoRA training), --base-checkpoint (needs a safetensors
reader), --data-tokenizer (the tokenizer is not ported) and the MoE
presets.
"""
import argparse
import dataclasses
import json
import math
import time
from typing import Any, Dict, Iterator, Optional

import numpy as np
import torch

from skypilot_tpu_torch.utils import device as device_lib
from skypilot_tpu_torch.utils import env
from skypilot_tpu_torch.utils import log_utils

logger = log_utils.init_logger(__name__)

# The JAX MeshSpec axes (skypilot_tpu/parallel/mesh.py MESH_AXES).
MESH_AXES = ('pp', 'dp', 'cp', 'fsdp', 'ep', 'tp')
# The JAX package's MoE presets (models/moe.py MIXTRAL_CONFIGS).
MOE_MODELS = ('debug-moe', 'mixtral-8x7b', 'qwen3-30b-a3b')


def mesh_devices(spec: Optional[str]) -> int:
    """Devices a --mesh spec asks for: 'auto' (or none) is this one
    device; 'fsdp=8,tp=2' is the product of its axis sizes."""
    if not spec or spec == 'auto':
        return 1
    n = 1
    for part in spec.split(','):
        name, size = part.split('=')
        if name.strip() not in MESH_AXES:
            raise ValueError(f'unknown mesh axes {{{name.strip()!r}}}')
        n *= int(size)
    return n


def synthetic_batches(vocab_size: int, batch: int, seq: int,
                      seed: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    rng = np.random.default_rng(seed)
    while True:
        toks = rng.integers(0, vocab_size, (batch, seq + 1), dtype=np.int32)
        yield {'tokens': toks[:, :-1], 'targets': toks[:, 1:]}


def jsonl_batches(path: str, vocab_size: int, batch: int,
                  seq: int) -> Iterator[Dict[str, np.ndarray]]:
    """Pack {'text' or 'tokens'} JSONL rows into fixed [B, S] batches:
    'tokens' rows as they are (modulo the vocab), 'text' rows byte-level,
    a 0 after each row."""
    def _tokens():
        while True:
            n_rows = 0
            with open(path, 'r', encoding='utf-8') as f:
                for line in f:
                    if not line.strip():
                        continue
                    n_rows += 1
                    row = json.loads(line)
                    if 'tokens' in row:
                        yield from (int(t) % vocab_size
                                    for t in row['tokens'])
                    else:
                        yield from (b % vocab_size
                                    for b in row['text'].encode())
                    yield 0  # document separator
            if n_rows == 0:
                raise ValueError(f'no data rows in {path!r}')

    stream = _tokens()
    while True:
        flat = np.fromiter(stream, dtype=np.int32,
                           count=batch * (seq + 1))
        arr = flat.reshape(batch, seq + 1)
        yield {'tokens': arr[:, :-1], 'targets': arr[:, 1:]}


def analytic_flops(cfg, batch: int, seq: int) -> float:
    """Model FLOPs of one train step: 6 * params per token plus the
    attention's 12 * layers * dim * seq (sft.py:_analytic_flops)."""
    per_tok = 6 * cfg.num_params() + 12 * cfg.n_layers * cfg.dim * seq
    return float(per_tok * batch * seq)


def _refuse(args) -> None:
    """Exit with the reason for every flag whose machinery is another
    slice's."""
    try:
        n = mesh_devices(args.mesh)
    except ValueError as e:
        raise SystemExit(f'--mesh {args.mesh!r}: {e}') from None
    if n != 1:
        raise SystemExit(f'--mesh {args.mesh!r} spans {n} devices: meshes '
                         'and sharded training are not ported yet (the '
                         'parallelism slice); this trainer runs on one '
                         'device')
    if args.dcn_mesh:
        raise SystemExit('--dcn-mesh (multi-slice) is not ported yet (the '
                         'parallelism slice)')
    if args.attn == 'ring':
        raise SystemExit('--attn ring is not ported yet (ring attention '
                         'is the parallelism slice\'s)')
    if args.lora_rank > 0:
        raise SystemExit('--lora-rank > 0: LoRA training is not ported yet')
    if args.base_checkpoint:
        raise SystemExit('--base-checkpoint is not ported yet: it needs a '
                         'safetensors reader for the HF checkpoint')
    if args.data_tokenizer:
        raise SystemExit('--data-tokenizer is not ported yet (the '
                         'tokenizer lands with the server routes); JSONL '
                         "'text' rows are byte-level")


def build_model(name: str, attn: str, device: torch.device, seed: int = 0):
    """The preset on `device` with random weights from `seed` (embedding
    N(0, 0.02), projections N(0, 1/fan_in), norms 1, or 0 where they are
    zero-centred and applied as 1 + w, as Gemma's are)."""
    from skypilot_tpu_torch.models import llama
    if name in MOE_MODELS:
        raise SystemExit(f'{name} is a MoE model: MoE is not ported yet')
    if name not in llama.CONFIGS:
        raise SystemExit(f'unknown model {name}; choose from '
                         f'{sorted(llama.CONFIGS)}')
    cfg = llama.CONFIGS[name]
    if attn != 'auto':
        cfg = dataclasses.replace(cfg, attn_impl=attn)
    model = llama.LlamaModel(cfg, device='meta').to_empty(device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    model.init_weights(gen)
    return model


def main(argv=None) -> Dict[str, Any]:
    """Runs the loop with deterministic algorithms on (the caller's
    setting restored after); returns a summary (steps run, the per-step
    losses, the last logged step time, tokens/s and MFU, FLOPs per
    step)."""
    was = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled(),
           torch.utils.deterministic.fill_uninitialized_memory)
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.utils.deterministic.fill_uninitialized_memory = False
    try:
        return _main(argv)
    finally:
        torch.use_deterministic_algorithms(was[0], warn_only=was[1])
        torch.utils.deterministic.fill_uninitialized_memory = was[2]


def _main(argv) -> Dict[str, Any]:
    parser = argparse.ArgumentParser()
    parser.add_argument('--model', default='llama3-1b')
    parser.add_argument('--mesh', default='auto',
                        help="'auto' or a one-device spec; larger meshes "
                             'are not ported yet')
    parser.add_argument('--dcn-mesh', default=None,
                        help='multi-slice axes (not ported yet)')
    parser.add_argument('--steps', type=int, default=1000)
    parser.add_argument('--batch', type=int, default=8)
    parser.add_argument('--seq', type=int, default=2048)
    parser.add_argument('--attn', default='auto',
                        choices=['auto', 'flash', 'xla', 'ring'],
                        help="'ring' is not ported yet")
    parser.add_argument('--lr', type=float, default=3e-4)
    parser.add_argument('--data', default=None,
                        help='JSONL path; default synthetic')
    parser.add_argument('--data-tokenizer', default=None,
                        help='tokenizer for JSONL text rows (not ported '
                             'yet; text rows are byte-level)')
    parser.add_argument('--lora-rank', type=int, default=0,
                        help='> 0 enables LoRA (not ported yet)')
    parser.add_argument('--lora-alpha', type=float, default=16.0)
    parser.add_argument('--base-checkpoint', default=None,
                        help='HF-format checkpoint dir (not ported yet)')
    parser.add_argument('--checkpoint-dir', default=None)
    parser.add_argument('--checkpoint-every', type=int, default=100)
    parser.add_argument('--resume', default='auto',
                        choices=['auto', 'never'])
    parser.add_argument('--log-every', type=int, default=10)
    parser.add_argument('--prefetch', type=int, default=2,
                        help='input-pipeline prefetch depth: batches '
                             'placed on the device on a background thread '
                             'while the current step runs. 0 disables.')
    parser.add_argument('--device', default='cuda',
                        help="'cuda' (default) or 'cpu'")
    args = parser.parse_args(argv)
    _refuse(args)
    dev = device_lib.resolve_device(args.device)
    logger.info('device %s%s', dev, f' ({torch.cuda.get_device_name(dev)})'
                if dev.type == 'cuda' else '')

    from skypilot_tpu_torch.train import checkpoint as ckpt_lib
    from skypilot_tpu_torch.train import prefetch as prefetch_lib
    from skypilot_tpu_torch.train import trainer
    from skypilot_tpu_torch.utils import profiling

    # Preemption-safe exit: SIGTERM/SIGINT during start-up exits at once
    # with the preemption code; from the step loop on, the loop
    # checkpoints at the next step boundary and exits with it.
    guard = ckpt_lib.PreemptionGuard(immediate=True)
    try:
        model = build_model(args.model, args.attn, dev)
        cfg = model.cfg
        logger.info('%s: %.3fB params (%s masters, %s compute), remat %s, '
                    'attention %s', args.model, cfg.num_params() / 1e9,
                    cfg.param_dtype, cfg.dtype, cfg.remat, cfg.attn_impl)
        tcfg = trainer.TrainerConfig(learning_rate=args.lr,
                                     total_steps=args.steps)
        tx = trainer.make_optimizer(tcfg)
        state = trainer.create_state(model, tx)

        ckpt = None
        if args.checkpoint_dir:
            ckpt = ckpt_lib.Checkpointer(
                args.checkpoint_dir,
                save_interval_steps=args.checkpoint_every)
        start_step = 0
        if ckpt is not None and args.resume == 'auto':
            if ckpt.restore(state) is not None:
                start_step = state.step
                logger.info('resumed from step %d', start_step)

        step_fn = trainer.make_train_step(model, tx)
        batches = (jsonl_batches(args.data, cfg.vocab_size, args.batch,
                                 args.seq)
                   if args.data else
                   synthetic_batches(cfg.vocab_size, args.batch, args.seq))
        place = prefetch_lib.make_placer(dev)
        prefetcher = None
        if args.prefetch > 0:
            prefetcher = prefetch_lib.Prefetcher(batches,
                                                 depth=args.prefetch,
                                                 place=place)
            batches = prefetcher
        else:
            batches = (place(b).ready() for b in batches)

        prof = profiling.StepProfiler()   # no-op unless SKYT_PROFILE_DIR
        dmetrics = trainer.DeferredMetrics(trainer.TrainMetricsPublisher())
        flops = analytic_flops(cfg, args.batch, args.seq)
        peak = profiling.peak_flops(dev) if env.get_bool(
            'SKYT_TRAIN_MFU', True) else None
        # Every step's loss, kept on the device (one copy per step, no
        # sync); read once after the loop.
        losses = torch.zeros((max(args.steps - start_step, 0),),
                             dtype=torch.float32, device=dev)
        summary: Dict[str, Any] = {'start_step': start_step,
                                   'flops_per_step': flops, 'logs': []}

        # Step loop from here: checkpoint writes begin, so preemption
        # waits for a step boundary instead of exiting mid-write.
        guard.cooperative()
        t0 = time.perf_counter()
        last_t = t0
        tokens_seen = 0
        try:
            for step in range(start_step, args.steps):
                prof.on_step(step - start_step)
                batch = next(batches)
                state, metrics = step_fn(state, batch)
                dmetrics.on_step(metrics)   # starts a host copy, no sync
                losses[step - start_step].copy_(metrics['loss'])
                tokens_seen += args.batch * args.seq
                saved = ckpt.save(step + 1, state) \
                    if ckpt is not None else False
                if guard.requested:
                    if ckpt is not None:
                        if not saved:
                            ckpt.save(step + 1, state, force=True)
                        ckpt.wait()   # the write must land before exit
                        logger.info('preemption: checkpoint saved at '
                                    'step %d', step + 1)
                    logger.info(
                        'preemption requested (signal %s); exiting with '
                        'code %d for controller recovery', guard.signum,
                        guard.EXIT_CODE)
                    raise SystemExit(guard.EXIT_CODE)
                if (step + 1) % args.log_every == 0:
                    now = time.perf_counter()
                    n_window = min(args.log_every, step + 1 - start_step)
                    step_time = (now - last_t) / max(1, n_window)
                    mfu = flops / max(step_time, 1e-9) / peak \
                        if peak else None
                    host = dmetrics.publish(
                        step_time_s=step_time,
                        tokens_per_sec=tokens_seen / (now - t0),
                        steps=n_window, mfu=mfu)
                    last_t = now
                    summary['logs'].append({
                        'step': step + 1, 'loss': host.get('loss'),
                        'grad_norm': host.get('grad_norm'),
                        'step_time_s': step_time,
                        'tokens_per_sec': tokens_seen / (now - t0),
                        'window_tokens_per_sec':
                            args.batch * args.seq / step_time,
                        'mfu': mfu})
                    logger.info(
                        'step %d/%d loss=%.4f grad_norm=%.3f (one step '
                        'behind) step_time=%.3fs tokens/s=%.0f mfu=%s',
                        step + 1, args.steps,
                        host.get('loss', float('nan')),
                        host.get('grad_norm', float('nan')), step_time,
                        tokens_seen / (now - t0),
                        f'{mfu:.3f}' if mfu is not None else 'n/a')
        finally:
            prof.stop()
            if prefetcher is not None:
                prefetcher.close()
        if ckpt is not None:
            if ckpt.latest_step() != args.steps:
                ckpt.save(args.steps, state, force=True)
            ckpt.close()
        summary['losses'] = losses.tolist()
        summary['steps'] = args.steps - start_step
        bad = [i + start_step for i, x in enumerate(summary['losses'])
               if not math.isfinite(x)]
        if bad:
            raise RuntimeError(f'non-finite loss at steps {bad}')
        logger.info('done: %d steps', args.steps - start_step)
        return summary
    finally:
        # In-process callers (tests) outlive main(): give them their
        # SIGTERM/SIGINT handlers back however the run ends.
        guard.restore()


if __name__ == '__main__':
    main()
