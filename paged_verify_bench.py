#!/usr/bin/env python3
"""Time the PyTorch port's paged-decode kernels on one CUDA card at the
serving paths' shapes, for the skypilot_tpu_torch package of a given
checkout, so two checkouts can be compared on the same card:

    python3 paged_verify_bench.py                       # this checkout
    python3 paged_verify_bench.py --root <checkout> --label parent

It times paged_decode_attention_mq (bf16 pools) and
paged_decode_attention_mq_q (int8 pools with f32 scales) with T = 4 (the
spec engines' verify step, spec_decode=3), and the single-query wrappers
paged_decode_attention and paged_decode_attention_q (T = 1, a decode
step), on chip_smoke.py's decode inputs (8 slots of lengths 0, 63, 64, 600, 1500,
2048 - T, 130 and 777 tokens, the last one freed, 64-token pages, 32
pages a table row):

    llama3-8b  q [8, 4, 32, 128], pools [257, 8, 64, 128]
    gemma-7b   q [8, 4, 16, 256], pools [257, 16, 64, 256]
    gemma-2b   q [8, 4, 8, 256],  pools [257, 1, 64, 256] (32 query
               rows a kv head)

(q [8, 32, 128], [8, 16, 256] and [8, 8, 256] for T = 1).

For each: device ms per call from CUDA events around a replayed CUDA
graph of 50 calls (three replays, after a warm-up); eager ms per call
(the least of five runs of 50 calls on the stream, Python's launch
overhead included); the first kernel's and the merge's device ms per
call from torch.profiler's kernel records (a checkout whose kernel
merges inside its one launch has no merge kernel: merge_ms is null);
the plain version's ms; the bound, the larger of the bytes read and
written once over 3.35 TB/s and 4*d flops per query head and visible
(token, key) pair over 989 TFLOP/s. Inputs come from a seed. Prints the card
(nvidia-smi name, power.limit), one JSON line per case and a last JSON
line with all of them. Imports nothing of JAX.
"""
import argparse
import importlib.util
import json
import os
import subprocess
import sys

SHAPES = ('slice', 'gemma7b', 'gemma2b')
# (name, wrapper, int8 pools, T)
KERNELS = (('paged_decode_mq', 'paged_decode_attention_mq', False, 4),
           ('paged_decode_mq_q', 'paged_decode_attention_mq_q', True, 4),
           ('paged_decode', 'paged_decode_attention', False, 1),
           ('paged_decode_q', 'paged_decode_attention_q', True, 1))


def run_case(smoke, pa, gen, fn, quant, t, shape):
    args = smoke.paged_inputs(gen, t, quant, shape)
    wrapper = getattr(pa, fn)
    plain = getattr(pa, fn + '_reference')
    ms = smoke.time_ms(lambda: wrapper(*args), 50)
    # Host time varies from call to call: the least of five runs of 50.
    eager = min(smoke.eager_ms(lambda: wrapper(*args), 50)
                for _ in range(5))
    # The first kernel is paged_decode_verify at every T since the single-
    # query kernels' redesign (T > 1 since the verify kernel's), and
    # paged_decode_split before it; a separate paged_decode_merge
    # followed it until the merge was folded in.
    parts = smoke.device_ms_by_kernel(
        lambda: wrapper(*args),
        ('paged_decode_verify', 'paged_decode_split', 'paged_decode_merge'))
    first = parts['paged_decode_verify'] or parts['paged_decode_split']
    plain_ms = smoke.time_ms(lambda: plain(*args), 5)
    q, kp, tables, lengths = args[0], args[1], args[-2], args[-1]
    hq, d = q.shape[-2:]
    hkv, page = kp.shape[1], kp.shape[2]
    rows, pairs = smoke.visible_rows(tables, lengths, page, t)
    row_bytes = 2 * hkv * d * kp.element_size() + (2 * hkv * 4 if quant
                                                   else 0)
    nbytes = row_bytes * rows + 2 * 2 * q.numel() + \
        4 * (tables.numel() + lengths.numel())
    bound_bytes = nbytes / smoke.HBM_BYTES_PER_S * 1e3
    bound_flops = 4.0 * hq * d * pairs / smoke.BF16_FLOPS_PER_S * 1e3
    return {'shape': list(q.shape), 'pools': list(kp.shape),
            'kv_dtype': str(kp.dtype), 'ms': ms, 'eager_ms': eager,
            'split_ms': first,
            'merge_ms': parts['paged_decode_merge'], 'plain_ms': plain_ms,
            'bound_ms': max(bound_bytes, bound_flops),
            'bound_by': 'bytes' if bound_bytes >= bound_flops
            else 'operations'}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--root', default=os.path.dirname(
        os.path.abspath(__file__)), help='checkout whose package to time')
    ap.add_argument('--label', default='this checkout')
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch
    if not torch.cuda.is_available():
        print('paged_verify_bench: no CUDA device', file=sys.stderr)
        return 2
    # The inputs and timers of this checkout's chip_smoke.py, whichever
    # package is timed.
    spec = importlib.util.spec_from_file_location(
        'chip_smoke', os.path.join(os.path.dirname(
            os.path.abspath(__file__)), 'chip_smoke.py'))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from skypilot_tpu_torch.ops import paged_attention as pa
    assert os.path.abspath(pa.__file__).startswith(
        os.path.abspath(args.root)), pa.__file__
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f'card: {card}', flush=True)
    gen = torch.Generator(device='cuda')
    gen.manual_seed(0)
    res = {}
    with torch.inference_mode():
        for shape in SHAPES:
            for kname, fn, quant, t in KERNELS:
                key = f'{kname}_{shape}'
                res[key] = run_case(smoke, pa, gen, fn, quant, t, shape)
                print(json.dumps({'label': args.label, 'case': key,
                                  **res[key]}), flush=True)
                torch.cuda.empty_cache()
    print(json.dumps({'label': args.label, 'card': card, 'cases': res}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
