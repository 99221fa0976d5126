#!/usr/bin/env python3
"""Serve the PyTorch port's paged engines on one CUDA card and print
their greedy token streams, for the skypilot_tpu_torch package of a
given checkout, so that two checkouts' streams can be compared:

    python3 paged_streams.py                          # this checkout
    python3 paged_streams.py --root <checkout> --label parent
    python3 paged_streams.py --only llama3-8b llama3-8b_spec --head-scale 10

Engines, at full width with random bf16 weights from seed 0 and
chip_smoke.py's engine settings (8 slots, max_seq_len 2048, 64-token
pages): llama3-8b plain and with kv_dtype='int8' (their decode steps run
paged_decode_attention and _q), with spec_decode=3, and with both
(their verify steps run paged_decode_attention_mq and _mq_q); gemma-7b
with spec_decode=3, and with int8 KV as well; gemma-2b with
spec_decode=3 (32 query rows a kv head). --only picks engines by label.
--head-scale multiplies the output head's weights (llama3-8b's untied
lm_head) after the seeded build, which scales every logit. --agreement
also runs chip_smoke.py's check_agreement on llama3-8b (decode and
verify steps' argmax through the kernels, their plain versions and f32
attention, head scaled by 1, 3 and 10) with this checkout's kernels,
before its engines. Each serves
chip_smoke.py's traffic (the burst, its first prompt a repeated sequence
for the n-gram proposer on the spec engines, then the lone prompt) with
every request greedy, 32 new tokens each. Prints one JSON line per
engine (its streams, verify steps and launch counts) and a last line
with all of them. Imports nothing of JAX.

    python3 paged_streams.py --compare <another run's output>

also recomputes, for each request whose stream differs from the other
run's, the last-position logits of the prompt and the streams' common
prefix through the model with its attention in f32 (chip_smoke.py's
plain_last_logits, exact=True; bf16 KV for the int8 engines too), and
reports the gap between the two runs' tokens there beside the logits'
standard deviation and the top-1 - top-2 gap.
"""
import argparse
import gc
import importlib.util
import json
import os
import sys

# (label, preset, engine options)
ENGINES = (('llama3-8b', 'llama3-8b', {}),
           ('llama3-8b_int8', 'llama3-8b', dict(kv_dtype='int8')),
           ('llama3-8b_spec', 'llama3-8b', dict(spec_decode=3)),
           ('llama3-8b_int8_spec', 'llama3-8b',
            dict(spec_decode=3, kv_dtype='int8')),
           ('gemma-7b_spec', 'gemma-7b', dict(spec_decode=3)),
           ('gemma-7b_int8_spec', 'gemma-7b',
            dict(spec_decode=3, kv_dtype='int8')),
           ('gemma-2b_spec', 'gemma-2b', dict(spec_decode=3)))


def divergences(smoke, model, prompts, mine, theirs):
    """At each request's first differing token: both tokens' logits by
    the model with f32 attention, given the prompt and the common
    prefix."""
    import torch
    out = []
    for i, (a, b) in enumerate(zip(mine, theirs)):
        k = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if k is None:
            continue
        ctx = torch.as_tensor([prompts[i] + a[:k]], device='cuda')
        with torch.inference_mode():
            logits = smoke.plain_last_logits(model, ctx, exact=True)[0]
        top = logits.topk(2)
        out.append({'request': i, 'at': k, 'this': a[k], 'other': b[k],
                    'plain_top1': int(top.indices[0]),
                    'gap_this_minus_other': float(logits[a[k]] -
                                                  logits[b[k]]),
                    'top1_minus_top2': float(top.values[0] -
                                             top.values[1]),
                    'logit_std': float(logits.std())})
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--root', default=os.path.dirname(
        os.path.abspath(__file__)), help='checkout whose package to serve')
    ap.add_argument('--label', default='this checkout')
    ap.add_argument('--compare', help="another run's output: where its "
                    'streams differ, score both tokens by the f32 plain '
                    'model')
    ap.add_argument('--only', nargs='+', metavar='LABEL',
                    help='serve these engines only')
    ap.add_argument('--head-scale', type=float, default=1.0,
                    help="scale the output head's weights (untied heads)")
    ap.add_argument('--agreement', action='store_true',
                    help="run chip_smoke.py's check_agreement on "
                    'llama3-8b first')
    args = ap.parse_args()
    other = {}
    if args.compare:
        with open(args.compare) as f:
            other = json.loads(f.read().strip().splitlines()[-1])[
                'engines']
    sys.path.insert(0, os.path.abspath(args.root))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print('paged_streams: no CUDA device', file=sys.stderr)
        return 2
    # The traffic and serving loop of this checkout's chip_smoke.py,
    # whichever package serves.
    spec = importlib.util.spec_from_file_location(
        'chip_smoke', os.path.join(os.path.dirname(
            os.path.abspath(__file__)), 'chip_smoke.py'))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from skypilot_tpu_torch.infer import engine as engine_lib
    from skypilot_tpu_torch.infer import server
    assert os.path.abspath(server.__file__).startswith(
        os.path.abspath(args.root)), server.__file__
    print(f'card: {smoke.card_line()}', flush=True)
    res = {}
    model, name = None, None
    for label, preset, opts in ENGINES:
        if args.only and label not in args.only:
            continue
        if preset != name:
            model = name = None
            gc.collect()
            torch.cuda.empty_cache()
            model = server.build_engine(preset, seed=smoke.SEED).model
            name = preset
            if args.agreement and preset == 'llama3-8b':
                agree = smoke.check_agreement(model)
                print(json.dumps({'label': args.label,
                                  'agreement': agree}), flush=True)
            if args.head_scale != 1.0:
                with torch.no_grad():
                    w = model.lm_head.weight
                    w.copy_((w.float() * args.head_scale).to(w.dtype))
        eng = engine_lib.InferenceEngine(
            model, num_slots=8, max_seq_len=2048, decode_chunk=16,
            page_size=64, **opts)
        burst, _, lone = smoke.traffic(model.cfg.vocab_size,
                                       repeat='spec_decode' in opts)
        greedy = [engine_lib.SamplingParams(max_new_tokens=smoke.MAX_NEW)
                  for _ in burst]
        smoke.warm_up(eng, np.random.default_rng(smoke.SEED + 2))
        outs, launches, _, _ = smoke.serve(eng, burst, greedy, lone)
        res[label] = {'streams': outs, 'launches': launches,
                      'verify_steps': eng.perf_stats().get(
                          'spec_verify_steps', 0),
                      'head_scale': args.head_scale}
        del eng
        gc.collect()
        torch.cuda.empty_cache()
        if label in other:
            res[label]['divergences'] = divergences(
                smoke, model, burst + [lone], outs,
                other[label]['streams'])
        print(json.dumps({'label': args.label, 'engine': label,
                          **res[label]}), flush=True)
    print(json.dumps({'label': args.label, 'engines': res}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
