#!/usr/bin/env python3
"""Time the PyTorch port's 8-slot decode on one CUDA card, greedy and
with each request option on one slot, for the skypilot_tpu_torch
package of a given checkout, so that two checkouts can be compared in
one call:

    python3 options_bench.py                        # this checkout
    python3 options_bench.py --root <checkout> --label parent

llama3-8b at full width (random bf16 weights from seed 0), chip_smoke.py's
engine settings (8 slots, max_seq_len 2048, 64-token pages, decode chunk
16). A round submits 8 requests of 64-token prompts (one page short of a
prefix hit) and 128 new tokens each before the engine starts, then
drains them: the engine's ms per decode step is its steady decode time
(pull-to-pull intervals with no admission between) over the steps
(steady tokens / 8). Rounds: greedy, then logprobs, presence and
frequency penalties, and logit_bias each on one slot, then greedy again,
the whole sequence --rounds times. A checkout whose engine refuses an
option reports the refusal. Prints one JSON line per round and a last
line with every round. Imports nothing of JAX.
"""
import argparse
import json
import os
import subprocess
import sys
import time

OPTIONS = (('greedy', {}), ('logprobs', {'logprobs': True}),
           ('penalties', {'presence_penalty': 0.5,
                          'frequency_penalty': 0.5}),
           ('bias', {'logit_bias': {17: 5.0}}), ('greedy_again', {}))
SLOTS = 8
PROMPT = 64
NEW = 128


def card_line() -> str:
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0] if out else ''


def one_round(eng, engine_lib, rng, opts):
    """ms per decode step with `opts` on the first of 8 requests, or the
    engine's refusal."""
    vocab = eng.model.cfg.vocab_size
    try:
        params = [engine_lib.SamplingParams(max_new_tokens=NEW, **(
            opts if i == 0 else {})) for i in range(SLOTS)]
        for p in params:
            p.validate()
    except (NotImplementedError, ValueError, TypeError) as e:
        return {'refused': f'{type(e).__name__}: {e}'}
    eng.reset_perf()
    queues = [eng.submit(rng.integers(1, vocab, PROMPT).tolist(), p)[1]
              for p in params]
    t0 = time.perf_counter()
    eng.start()
    try:
        for q in queues:
            n = 0
            while q.get(timeout=600) is not None:
                n += 1
            assert n == NEW, n
    finally:
        eng.stop()
    wall = time.perf_counter() - t0
    perf = eng.perf_stats()
    assert perf['steady_tokens'] > 0, perf
    return {'ms_per_step': perf['steady_time_s'] /
            (perf['steady_tokens'] / SLOTS) * 1e3,
            'steady_tokens': perf['steady_tokens'], 'wall_s': wall}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--root', default=os.path.dirname(
        os.path.abspath(__file__)))
    ap.add_argument('--label', default='this')
    ap.add_argument('--rounds', type=int, default=2)
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print('options_bench: no CUDA device', file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.root))
    from skypilot_tpu_torch.infer import engine as engine_lib
    from skypilot_tpu_torch.infer import server
    from skypilot_tpu_torch.ops import _build
    assert os.path.dirname(os.path.dirname(os.path.dirname(
        server.__file__))) == os.path.abspath(args.root), server.__file__
    card = card_line()
    t0 = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t0
    eng = server.build_engine('llama3-8b', num_slots=SLOTS, seed=0)
    rng = np.random.default_rng(7)
    # A warm-up round: first calls pay one-time set-up.
    one_round(eng, engine_lib, rng, {})
    rounds = []
    for r in range(args.rounds):
        for name, opts in OPTIONS:
            out = {'label': args.label, 'round': r, 'option': name,
                   **one_round(eng, engine_lib, rng, opts)}
            print(json.dumps(out), flush=True)
            rounds.append(out)
    print(json.dumps({'label': args.label, 'card': card,
                      'build_s': build_s, 'rounds': rounds}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
