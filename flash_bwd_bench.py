#!/usr/bin/env python3
"""Time the PyTorch port's flash-attention backward on one CUDA card, at
the training path's shapes, for the skypilot_tpu_torch package of a
given checkout, so two checkouts can be compared on the same card:

    python3 flash_bwd_bench.py                       # this checkout
    python3 flash_bwd_bench.py --root <checkout> --label parent

It times flash_attention_bwd (delta = rowsum(dO * O), then the backward
kernel or kernels, with whatever zeroing and casting they need): device
ms per call from CUDA events around a replayed CUDA graph of 10 calls,
after a warm-up. Inputs are random (seeded); out and lse come from the
checkout's forward kernel. Cases (q [B, S, Hq, D], kv heads):

    sft_causal   [8, 2048, 32, 64], 8   llama3-1b, sft's defaults
    packed       as sft_causal, each row 4 segments (600, 64, 590, 600
                 tokens on 64-token pages) and id-0 padding
    noncausal    as sft_causal, not causal
    d128         [4, 2048, 32, 128], 8 llama3-8b's attention, causal
    mha          [8, 2048, 16, 64], 16  causal, one query head per kv head

Prints the card (nvidia-smi name, power.limit), then one JSON line per
case and a last JSON line with all of them. Imports nothing of JAX.
"""
import argparse
import json
import os
import subprocess
import sys

CASES = (
    ('sft_causal', 8, 2048, 32, 8, 64, True, False),
    ('packed', 8, 2048, 32, 8, 64, True, True),
    ('noncausal', 8, 2048, 32, 8, 64, False, False),
    ('d128', 4, 2048, 32, 8, 128, True, False),
    ('mha', 8, 2048, 16, 16, 64, True, False),
)
BURST = (600, 64, 590, 600)


def time_ms(fn, iters=10, reps=3):
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (iters * reps)
    del graph
    torch.cuda.empty_cache()
    return ms


def segments(b, s):
    import torch
    seg = torch.zeros((b, s), dtype=torch.int32)
    off = 0
    for j, n in enumerate(BURST):
        seg[:, off:off + n] = j + 1
        off += -(-n // 64) * 64
    return seg.cuda()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--root', default=os.path.dirname(
        os.path.abspath(__file__)), help='checkout whose package to time')
    ap.add_argument('--label', default='this checkout')
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch
    if not torch.cuda.is_available():
        print('flash_bwd_bench: no CUDA device', file=sys.stderr)
        return 2
    from skypilot_tpu_torch.ops import flash_attention as fa
    assert os.path.abspath(fa.__file__).startswith(
        os.path.abspath(args.root)), fa.__file__
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f'card: {card}', flush=True)
    gen = torch.Generator(device='cuda')
    gen.manual_seed(0)
    res = {}
    for name, b, s, hq, hkv, d, causal, packed in CASES:
        q, k, v = (torch.randn((b, s, h, d), generator=gen, device='cuda',
                               dtype=torch.bfloat16)
                   for h in (hq, hkv, hkv))
        seg = segments(b, s) if packed else None
        out, lse = fa.flash_attention_fwd_lse(q, k, v, causal=causal,
                                              segment_ids=seg)
        do = torch.randn(out.shape, generator=gen, device='cuda',
                         dtype=torch.bfloat16)
        ms = time_ms(lambda: fa.flash_attention_bwd(
            q, k, v, out, lse, do, causal=causal, segment_ids=seg))
        res[name] = {'shape': [b, s, hq, d], 'kv_heads': hkv,
                     'causal': causal, 'packed': packed, 'ms': ms}
        print(json.dumps({'label': args.label, 'case': name, **res[name]}),
              flush=True)
        del q, k, v, out, lse, do
    print(json.dumps({'label': args.label, 'card': card, 'cases': res}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
