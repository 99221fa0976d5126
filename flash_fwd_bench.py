#!/usr/bin/env python3
"""Time the PyTorch port's flash-attention forward kernel on one CUDA
card at every shape its paths give it, for the skypilot_tpu_torch
package of a given checkout, so two checkouts can be compared on the
same card:

    python3 flash_fwd_bench.py                       # this checkout
    python3 flash_fwd_bench.py --root <checkout> --label parent

It times flash_attention_fwd_lse (the kernel alone): device ms per call
from CUDA events around a replayed CUDA graph of 20 calls, after a
warm-up, three replays. Beside it, one call of PyTorch's
scaled_dot_product_attention on the same inputs (k/v expanded to the
query heads; causal, or a boolean mask for segments and windows), and
the bound: the larger of 4*d flops per query head and visible (q, k)
pair over 989 TFLOP/s and the bytes read and written once over
3.35 TB/s. Inputs are random bf16 from a seed. Cases (q [B, S, Hq, D],
kv heads, causal throughout):

    serve_packed   [1, 2048, 32, 128], 8   llama3-8b's burst row (600, 64,
                                           590, 600 tokens on 64-token
                                           pages, id-0 padding)
    serve_lone     [1, 512, 32, 128], 8    a lone prompt's bucket
    train          [8, 2048, 32, 64], 8    llama3-1b, sft's defaults
    window         [1, 8192, 32, 128], 8   mistral-7b, window 4096
    nowindow       the same, no window
    window_packed  as window, a 6000- and a 2000-token prompt packed
    gemma7b_packed [1, 2048, 16, 256], 16  the burst row
    gemma7b_lone   [1, 512, 16, 256], 16
    gemma2b_packed [1, 2048, 8, 256], 1
    gemma2b_train  [4, 2048, 8, 256], 1    gemma-2b, sft at batch 4

Prints the card (nvidia-smi name, power.limit), then one JSON line per
case and a last JSON line with all of them. Imports nothing of JAX.
"""
import argparse
import json
import os
import subprocess
import sys

from flash_bwd_bench import time_ms

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
BURST = (600, 64, 590, 600)
MISTRAL_BURST = (6000, 2000)
# (name, B, S, Hq, Hkv, D, segment lengths or None, page, window)
CASES = (
    ('serve_packed', 1, 2048, 32, 8, 128, BURST, 64, 0),
    ('serve_lone', 1, 512, 32, 8, 128, None, 0, 0),
    ('train', 8, 2048, 32, 8, 64, None, 0, 0),
    ('window', 1, 8192, 32, 8, 128, None, 0, 4096),
    ('nowindow', 1, 8192, 32, 8, 128, None, 0, 0),
    ('window_packed', 1, 8192, 32, 8, 128, MISTRAL_BURST, 64, 4096),
    ('gemma7b_packed', 1, 2048, 16, 16, 256, BURST, 64, 0),
    ('gemma7b_lone', 1, 512, 16, 16, 256, None, 0, 0),
    ('gemma2b_packed', 1, 2048, 8, 1, 256, BURST, 64, 0),
    ('gemma2b_train', 4, 2048, 8, 1, 256, None, 0, 0),
)


def segments(lengths, page, s):
    """One packed row: request j's tokens carry id j + 1 at a page-aligned
    offset; the tail is id 0."""
    import torch
    seg = torch.zeros((1, s), dtype=torch.int32)
    off = 0
    for j, n in enumerate(lengths):
        seg[0, off:off + n] = j + 1
        off += -(-n // page) * page
    return seg.cuda()


def visible(s, seg, window):
    """[S, S] bool: causal, within the window, same segment."""
    import torch
    pos = torch.arange(s, device='cuda')
    m = pos[None, :] <= pos[:, None]
    if window:
        m &= pos[:, None] - pos[None, :] < window
    if seg is not None:
        m &= seg[0, :, None] == seg[0, None, :]
    return m


def run_case(fa, gen, case):
    import torch
    import torch.nn.functional as F
    name, b, s, hq, hkv, d, lengths, page, window = case
    q, k, v = (torch.randn((b, s, h, d), generator=gen, device='cuda',
                           dtype=torch.bfloat16) for h in (hq, hkv, hkv))
    seg = segments(lengths, page, s) if lengths else None
    ms = time_ms(lambda: fa.flash_attention_fwd_lse(
        q, k, v, causal=True, segment_ids=seg, window=window), iters=20)
    mask = visible(s, seg, window)
    pairs = int(mask.sum())
    qt = q.transpose(1, 2)
    kx = k.repeat_interleave(hq // hkv, dim=2).transpose(1, 2)
    vx = v.repeat_interleave(hq // hkv, dim=2).transpose(1, 2)
    if seg is None and not window:
        lib = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kx, vx, is_causal=True), iters=20)
    else:
        lib = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kx, vx, attn_mask=mask[None, None]), iters=20)
    flops = 4.0 * d * b * hq * pairs
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel()) + 4 * b * hq * s
    if seg is not None:
        nbytes += 4 * seg.numel()
    bf = flops / BF16_FLOPS_PER_S * 1e3
    bb = nbytes / HBM_BYTES_PER_S * 1e3
    return {'shape': [b, s, hq, d], 'kv_heads': hkv, 'window': window,
            'segments': list(lengths) if lengths else None, 'ms': ms,
            'sdpa_ms': lib, 'bound_ms': max(bf, bb),
            'bound_by': 'operations' if bf >= bb else 'bytes'}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--root', default=os.path.dirname(
        os.path.abspath(__file__)), help='checkout whose package to time')
    ap.add_argument('--label', default='this checkout')
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch
    if not torch.cuda.is_available():
        print('flash_fwd_bench: no CUDA device', file=sys.stderr)
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
    for case in CASES:
        res[case[0]] = run_case(fa, gen, case)
        print(json.dumps({'label': args.label, 'case': case[0],
                          **res[case[0]]}), flush=True)
        torch.cuda.empty_cache()
    print(json.dumps({'label': args.label, 'card': card, 'cases': res}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
