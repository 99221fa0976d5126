#!/usr/bin/env python3
"""Drive the PyTorch port (skypilot_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py            # the full smoke, one card
    python3 chip_smoke.py --quick    # build + kernel-vs-plain checks only
    python3 chip_smoke.py --profile  # also profile one decode chunk
                                     # (bf16 and LoRA engines)

Phases (any failure exits non-zero and prints no result line):
  1. the card's name and power limit (nvidia-smi), and the build of
     every CUDA kernel from csrc/ (one nvcc per source, all at once);
  2. each kernel against its plain PyTorch version on the card, in bf16
     at the serving path's shapes (atol = rtol = 2e-2: bf16 outputs
     rounded against an f32-accumulated reference): flash, and the four
     paged decode kernels — one query per slot (q [8, 32, 128]) or the
     verify step's four (q [8, 4, 32, 128]), over bf16 pools
     [257, 8, 64, 128] or int8 ones from quantize_kv with f32 scales
     [257, 8, 64]; and the two grouped-LoRA kernels (LORA_CASES), as
     the delta and added in place into y, ids mixing 0 and three
     adapters at rank 16 (one rank 8, zero-padded): the gather kernel
     at decode ([8, 1, 4096] -> 14336 and [8, 1, 14336] -> 4096), the
     verify step ([8, 4, 4096]) and a lone admission ([1, 512, 4096]),
     the grouped kernel on the burst's packed row ([1, 2048, 4096],
     segment ids and 0 padding) and on random per-token ids, and small
     widths that are not multiples of 8 or of the tiles; id-0 rows must
     be exact zeros (or exactly y);
  3. llama3-8b at full width (random weights from a seed) served through
     build_engine -> InferenceEngine.submit/generate on the paged cache:
     a burst of mixed-length prompts submitted before start() (packed
     ragged prefill, one request sampled), then a lone request (single
     prefill). Every request must return its tokens, the path's kernels'
     launch counters (set to 0 just before, read just after) must rise,
     and one prefill's last-token logits must match the same model run
     with the plain attention (check_logits). Then the same model object
     serves three more engines, each freed before the next: (a)
     kv_dtype='int8', (b) spec_decode=3, (c) both — spec runs with a
     repeated prompt in the burst and at least one verify step; each
     must launch its kernel, and one paged step (s = 1 for (a), the
     s = 4 verify step for (b) and (c)) on a fixed prefilled cache must
     match its plain version within LOGIT_REL_L2 (check_step). Last, a
     fifth engine, build_engine(..., lora_stack=) on the same weights
     (same seed) with three random adapters (ranks 16, 8, 16, alpha 32,
     16, 32, on all seven projections): the burst on adapters 1, 2, 0, 3
     in one ragged row, the lone prompt on adapter 2. Both LoRA kernels
     must launch, the id-0 request's tokens must equal the bf16 run's,
     a decode step (s = 1 and 4) and a per-token prefill must match
     their plain versions within LOGIT_REL_L2, and the adapters must
     move an adapter slot's step logits (an id-0 slot's not at all);
  4. kernel timings: device time per call from CUDA events around a
     replayed CUDA graph of many calls (eager_ms: the same with Python's
     launch overhead), for the kernel, its plain version and one PyTorch
     library call where one computes the same function; and the bound
     (the larger of bytes / 3.35 TB/s and flops / 989 TFLOP/s, counted
     from this run's inputs); then the {"kernels": [...]} line;
  5. last line: {"ok": true, "device": {...}}.

It imports nothing of JAX and nothing of the JAX package.
"""
import argparse
import gc
import json
import math
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3
BF16_FLOPS_PER_S = 989e12       # H100 SXM dense bf16 tensor cores
TOL = dict(atol=2e-2, rtol=2e-2)
LOGIT_REL_L2 = 5e-2

SEED = 0
MODEL = 'llama3-8b'
# Burst prompt lengths: four segments whose page-rounded spans pack into
# one [1, 2048] row (with id-0 padding); then a lone 300-token prompt
# (bucket 512).
BURST = (600, 64, 590, 600)
LONE = 300
MAX_NEW = 32


def _log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0] if out else ''


def time_ms(fn, iters: int, reps: int = 3) -> float:
    """Device time of one fn() call: `iters` calls captured in a CUDA
    graph, replayed `reps` times between CUDA events, after a warm-up.
    The graph keeps Python's launch overhead out of the number."""
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


def eager_ms(fn, iters: int) -> float:
    """Wall time of one eager fn() call on the stream, Python launch
    overhead included (what the engine pays today)."""
    import torch
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def max_abs(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def packed_segments(lengths, page, total):
    """The engine's ragged layout: request j's tokens carry id j+1 at a
    page-aligned offset, page-rounding tails and the row's tail id 0."""
    import numpy as np
    seg = np.zeros((1, total), np.int32)
    off = 0
    for j, n in enumerate(lengths):
        seg[0, off:off + n] = j + 1
        off += -(-n // page) * page
    return seg


# ----------------------------------------------------------- phase 2
def flash_inputs(gen, s, hq=32, hkv=8, d=128):
    import torch
    q = torch.randn((1, s, hq, d), generator=gen, device='cuda',
                    dtype=torch.bfloat16)
    k = torch.randn((1, s, hkv, d), generator=gen, device='cuda',
                    dtype=torch.bfloat16)
    v = torch.randn((1, s, hkv, d), generator=gen, device='cuda',
                    dtype=torch.bfloat16)
    return q, k, v


def check_flash(gen):
    """The slice's shapes (a packed row of the engine's 4-segment layout,
    an unpacked causal row), then head_dim 64 with GQA 8/2, a ragged
    tail and non-causal rows for the kernel's other variants."""
    import torch
    from skypilot_tpu_torch.ops import flash_attention as fa
    res = {}
    seg = torch.as_tensor(packed_segments(BURST, 64, 2048), device='cuda')
    seg_small = torch.as_tensor(packed_segments((50, 3, 70, 33), 16, 200),
                                device='cuda')
    cases = (('packed', 2048, seg, {}, True),
             ('causal', 512, None, {}, True),
             ('d64_packed', 200, seg_small, dict(hq=8, hkv=2, d=64), True),
             ('d64_full', 200, None, dict(hq=8, hkv=2, d=64), False))
    for name, s, sg, shape, causal in cases:
        q, k, v = flash_inputs(gen, s, **shape)
        out, lse = fa.flash_attention_fwd_lse(q, k, v, causal=causal,
                                              segment_ids=sg)
        ref, ref_lse = fa.flash_attention_reference(
            q, k, v, causal=causal, segment_ids=sg)
        torch.cuda.synchronize()
        assert torch.isfinite(out.float()).all(), f'flash {name}: non-finite'
        torch.testing.assert_close(out.float(), ref.float(), **TOL)
        torch.testing.assert_close(lse, ref_lse, **TOL)
        res[name] = {'shape': list(q.shape),
                     'max_abs_err': max(max_abs(out, ref),
                                        max_abs(lse, ref_lse))}
        _log(f'flash {name} {list(q.shape)}: max|out-ref| '
             f'{max_abs(out, ref):.3e}, max|lse-ref| '
             f'{max_abs(lse, ref_lse):.3e} (atol=rtol=2e-2)')
    return res


def paged_inputs(gen, t=1, quant=False):
    """The slice's decode shapes: q [8, 32, 128] (t == 1) or
    [8, t, 32, 128], pools [257, 8, 64, 128] — bf16, or int8 from
    quantize_kv of bf16 data with f32 scales [257, 8, 64]; slots of mixed
    lengths (0 included, the longest run ending at position 2047) and a
    freed slot (all-zero row, stale length). Returns (q, k_pool, v_pool,
    tables, lengths), or with quant (q, k_pool, v_pool, k_scale,
    v_scale, tables, lengths)."""
    import numpy as np
    import torch
    from skypilot_tpu_torch.infer import paged_cache
    slots, hq, hkv, d, page, n_pages, mp = 8, 32, 8, 128, 64, 257, 32
    qshape = (slots, hq, d) if t == 1 else (slots, t, hq, d)
    q = torch.randn(qshape, generator=gen, device='cuda',
                    dtype=torch.bfloat16)
    kp = torch.randn((n_pages, hkv, page, d), generator=gen, device='cuda',
                     dtype=torch.bfloat16)
    vp = torch.randn((n_pages, hkv, page, d), generator=gen, device='cuda',
                     dtype=torch.bfloat16)
    lengths = np.array([0, 63, 64, 600, 1500, 2048 - t, 130, 777], np.int32)
    tables = np.zeros((slots, mp), np.int32)
    perm = np.random.default_rng(SEED).permutation(np.arange(1, n_pages))
    nxt = 0
    for s in range(slots - 1):          # the last slot is freed
        n = -(-(int(lengths[s]) + t) // page)
        tables[s, :n] = perm[nxt:nxt + n]
        nxt += n
    rest = (torch.as_tensor(tables, device='cuda'),
            torch.as_tensor(lengths, device='cuda'))
    if not quant:
        return (q, kp, vp) + rest
    (kq, ks), (vq, vs) = (paged_cache.quantize_kv(x) for x in (kp, vp))
    return (q, kq, vq, ks, vs) + rest


def visible_rows(tables, lengths, page, t=1):
    """(KV rows the paged kernel must read, query-key pairs it must
    score): rows at positions <= lengths[s] + t-1 on pages that pass the
    kernels' skip rule; token i of the slot scores the rows at positions
    <= lengths[s] + i."""
    tb, ln = tables.cpu().numpy(), lengths.cpu().numpy()
    rows = pairs = 0
    for s in range(tb.shape[0]):
        last = int(ln[s]) + t - 1
        for j in range(min(tb.shape[1], last // page + 1)):
            if tb[s, j] == 0 and j != 0:
                continue
            rows += min(page, last - j * page + 1)
            for i in range(t):
                pairs += max(0, min(page, int(ln[s]) + i - j * page + 1))
    return rows, pairs


def check_paged(gen):
    """The slice's shape, then head_dim 64 with 8 query heads per kv head
    and 32-token pages for the kernel's other variants."""
    import torch
    from skypilot_tpu_torch.ops import paged_attention as pa
    args = paged_inputs(gen)
    small_tables = torch.tensor([[3, 1, 0, 0], [0, 0, 0, 0], [2, 0, 4, 0]],
                                dtype=torch.int32, device='cuda')
    small = (torch.randn((3, 16, 64), generator=gen, device='cuda',
                         dtype=torch.bfloat16),
             torch.randn((5, 2, 32, 64), generator=gen, device='cuda',
                         dtype=torch.bfloat16),
             torch.randn((5, 2, 32, 64), generator=gen, device='cuda',
                         dtype=torch.bfloat16),
             small_tables,
             torch.tensor([40, 300, 100], dtype=torch.int32, device='cuda'))
    res = {}
    for name, a in (('slice', args), ('d64_g8_p32', small)):
        out = pa.paged_decode_attention(*a)
        ref = pa.paged_decode_attention_reference(*a)
        torch.cuda.synchronize()
        assert torch.isfinite(out.float()).all(), f'paged {name}: non-finite'
        torch.testing.assert_close(out.float(), ref.float(), **TOL)
        err = max_abs(out, ref)
        _log(f'paged {name} {list(a[0].shape)} pools {list(a[1].shape)}: '
             f'max|out-ref| {err:.3e} (atol=rtol=2e-2)')
        res[name] = {'shape': list(a[0].shape), 'max_abs_err': err}
    return res


# Kernels 3-5 (same source and design as kernel 2): their wrappers and
# plain versions, whether they take T > 1 queries and int8 pools.
FAMILY = {
    'paged_decode_mq': ('paged_decode_attention_mq', 4, False,
                        'skypilot_tpu/ops/paged_attention.py:98 _kernel_mq'),
    'paged_decode_q': ('paged_decode_attention_q', 1, True,
                       'skypilot_tpu/ops/paged_attention.py:150 _kernel_q'),
    'paged_decode_mq_q': ('paged_decode_attention_mq_q', 4, True,
                          'skypilot_tpu/ops/paged_attention.py:210 '
                          '_kernel_mq_q'),
}


def small_family_inputs(gen, t, quant):
    """head_dim 64, 8 query heads per kv head (T*G = 8 or 16 rows),
    32-token pages, a freed slot and an unreserved gap."""
    import torch
    from skypilot_tpu_torch.infer import paged_cache
    qshape = (3, 16, 64) if t == 1 else (3, t, 16, 64)
    q = torch.randn(qshape, generator=gen, device='cuda',
                    dtype=torch.bfloat16)
    pools = [torch.randn((5, 2, 32, 64), generator=gen, device='cuda',
                         dtype=torch.bfloat16) for _ in range(2)]
    rest = (torch.tensor([[3, 1, 0, 0], [0, 0, 0, 0], [2, 0, 4, 0]],
                         dtype=torch.int32, device='cuda'),
            torch.tensor([40, 300, 100 - t], dtype=torch.int32,
                         device='cuda'))
    if not quant:
        return (q, *pools) + rest
    (kq, ks), (vq, vs) = (paged_cache.quantize_kv(x) for x in pools)
    return (q, kq, vq, ks, vs) + rest


def check_family(gen):
    """Kernels 3-5 against their plain versions on the card: the slice's
    shapes (T = 4 for the verify kernels), then head_dim 64 with 8 query
    heads per kv head (T = 2: 16 rows)."""
    import torch
    from skypilot_tpu_torch.ops import paged_attention as pa
    res = {}
    for kname, (fn, t, quant, _) in FAMILY.items():
        wrapper = getattr(pa, fn)
        plain = getattr(pa, fn + '_reference')
        for name, a in (('slice', paged_inputs(gen, t, quant)),
                        ('d64_g8_p32', small_family_inputs(
                            gen, min(t, 2), quant))):
            out = wrapper(*a)
            ref = plain(*a)
            torch.cuda.synchronize()
            assert torch.isfinite(out.float()).all(), \
                f'{kname} {name}: non-finite'
            torch.testing.assert_close(out.float(), ref.float(), **TOL)
            err = max_abs(out, ref)
            _log(f'{kname} {name} q {list(a[0].shape)} pools '
                 f'{list(a[1].shape)} {a[1].dtype}: max|out-ref| {err:.3e} '
                 '(atol=rtol=2e-2)')
            res.setdefault(kname, {})[name] = {'shape': list(a[0].shape),
                                               'max_abs_err': err}
    return res


def lora_operands(gen, din, dout, ranks, alphas=None):
    """A stack of len(ranks) random adapters on the card: A [N, in, rmax],
    B [N, rmax, out] bf16 (id 0 all zeros, lower ranks zero-padded),
    scaling [N] f32 = alpha/rank (alpha 2*rank unless given). A ~
    N(0, 1/in) and B ~ N(0, 1/r): deltas of about the scale's size for
    x ~ N(0, 1)."""
    import torch
    rmax = max(ranks)
    n = len(ranks) + 1
    alphas = alphas or [2.0 * r for r in ranks]
    a = torch.zeros((n, din, rmax), dtype=torch.bfloat16, device='cuda')
    b = torch.zeros((n, rmax, dout), dtype=torch.bfloat16, device='cuda')
    for i, r in enumerate(ranks, 1):
        a[i, :, :r] = torch.randn((din, r), generator=gen,
                                  device='cuda') / math.sqrt(din)
        b[i, :r] = torch.randn((r, dout), generator=gen,
                               device='cuda') / math.sqrt(r)
    scaling = torch.tensor([0.0] + [al / r for al, r in zip(alphas, ranks)],
                           dtype=torch.float32, device='cuda')
    return a, b, scaling


# The burst's adapters: request j of BURST runs on adapter BURST_LORA[j].
BURST_LORA = (1, 2, 0, 3)
SLOT_LORA = (1, 2, 0, 3, 1, 0, 2, 3)


def burst_lora_row(total):
    """Per-token ids of the engine's packed burst row: segment j+1 takes
    BURST_LORA[j]; page tails and the row's padding take 0."""
    import numpy as np
    seg = packed_segments(BURST, 64, total)
    return np.where(seg > 0, np.asarray((0,) + BURST_LORA)[seg], 0).astype(
        np.int32)


# Kernels 6-7 cases: (name, B, S, in, out, ranks, ids: per-sequence list,
# 'burst' or 'random' per-token). Ranks 16 / 8 / 16 are the slice's
# (rank 8 padded to 16); the small cases cover rank 4 and ranks that are
# not multiples of 8, widths that are not multiples of 8 or of the
# kernel's tiles, and ragged token tails.
LORA_CASES = (
    ('gather_decode', 8, 1, 4096, 14336, (16, 8, 16), SLOT_LORA),
    ('gather_decode_down', 8, 1, 14336, 4096, (16, 8, 16), SLOT_LORA),
    ('gather_verify', 8, 4, 4096, 14336, (16, 8, 16), SLOT_LORA),
    ('gather_lone', 1, 512, 4096, 14336, (16, 8, 16), (2,)),
    ('grouped_burst', 1, 2048, 4096, 14336, (16, 8, 16), 'burst'),
    ('grouped_random', 2, 199, 4096, 1024, (16, 8, 16), 'random'),
    ('gather_odd', 3, 5, 64, 32, (4, 2, 4), (1, 0, 2)),
    ('grouped_odd', 2, 9, 64, 32, (4, 2, 4), 'random'),
    ('gather_ragged', 3, 21, 100, 37, (12, 5, 12), (3, 1, 0)),
    ('grouped_ragged', 2, 23, 100, 37, (12, 5, 12), 'random'),
)


def lora_case_inputs(gen, case):
    """(x, a, b, ids, scale) on the card for one LORA_CASES entry."""
    import numpy as np
    import torch
    _, bsz, s, din, dout, ranks, ids = case
    x = torch.randn((bsz, s, din), generator=gen, device='cuda',
                    dtype=torch.bfloat16)
    a, b, scaling = lora_operands(gen, din, dout, ranks)
    if ids == 'burst':
        ids_np = burst_lora_row(s)
    elif ids == 'random':
        ids_np = np.random.default_rng(SEED + 3).integers(
            0, len(ranks) + 1, (bsz, s)).astype(np.int32)
    else:
        ids_np = np.asarray(ids, np.int32)
    ids_t = torch.as_tensor(ids_np, device='cuda')
    return x, a, b, ids_t, scaling[ids_t.long()]


def check_lora(gen):
    """Kernels 6-7 against their plain versions (LORA_CASES), as the delta
    and added in place into a projection output y. Rows with id 0 must be
    exact zeros (delta) or exactly y (in place)."""
    import torch
    from skypilot_tpu_torch.ops import lora as lora_ops
    res = {}
    for case in LORA_CASES:
        name = case[0]
        x, a, b, ids, scale = lora_case_inputs(gen, case)
        per_token = ids.dim() == 2
        plain = lora_ops.lora_grouped_reference if per_token else \
            lora_ops.lora_gather_reference
        out = lora_ops.grouped_lora_delta(x, a, b, ids, scale)
        ref = plain(x, a, b, ids, scale)
        y = torch.randn(out.shape, generator=gen, device='cuda',
                        dtype=torch.bfloat16)
        fused = lora_ops.add_lora_delta_(y.clone(), x, a, b, ids, scale)
        fused_ref = y + ref
        torch.cuda.synchronize()
        zero = (ids == 0) if per_token else (ids == 0)[:, None].expand(
            x.shape[:2])
        assert torch.isfinite(out.float()).all(), f'lora {name}: non-finite'
        assert bool((out[zero] == 0).all()), f'lora {name}: id-0 rows not 0'
        assert bool((fused[zero] == y[zero]).all()), \
            f'lora {name}: in-place id-0 rows changed'
        torch.testing.assert_close(out.float(), ref.float(), **TOL)
        torch.testing.assert_close(fused.float(), fused_ref.float(), **TOL)
        d_err, f_err = max_abs(out, ref), max_abs(fused, fused_ref)
        ref_max = float(ref.float().abs().max())
        kname = 'lora_grouped' if per_token else 'lora_gather'
        _log(f'{kname} {name} x {list(x.shape)} -> {b.shape[-1]}, rank '
             f'{a.shape[-1]}: delta max|out-ref| {d_err:.3e} (max|ref| '
             f'{ref_max:.3e}), in place max|out-(y+ref)| {f_err:.3e} '
             f'(atol=rtol=2e-2); {int(zero.sum())} id-0 rows exact')
        res[name] = {'kernel': kname, 'shape': list(x.shape),
                     'out': b.shape[-1], 'max_abs_err': max(d_err, f_err),
                     'delta_err': d_err, 'fused_err': f_err,
                     'ref_max': ref_max}
    return res


# ----------------------------------------------------------- phase 3
def plain_proj(lora, i, name, linear, x):
    """Layer i's projection `name` with its adapter delta from the plain
    versions (JAX's y + d); lora: None or (stack, ids [B] or [B, S])."""
    from skypilot_tpu_torch.ops import lora as lora_ops
    y = linear(x)
    if lora is None:
        return y
    stack, ids = lora
    a, b = stack[f'layers.{i}.{name}']
    plain = lora_ops.lora_grouped_reference if ids.dim() == 2 else \
        lora_ops.lora_gather_reference
    return y + plain(x, a, b, ids, stack['scaling'][ids])


def plain_block(model, i, x, cos, sin, attend, lora):
    """Layer i by hand: attend(q, k, v) [B, S, Hq, d] in the kernel's
    place, every projection through plain_proj."""
    import torch.nn.functional as F
    from skypilot_tpu_torch.ops import rope
    cfg = model.cfg
    b, s, _ = x.shape
    h, hk, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    layer = model.layers[i]
    a, m = layer.attn, layer.mlp
    hn = layer.attn_norm(x)
    q = rope.apply_rope(plain_proj(lora, i, 'attn.wq', a.wq, hn).view(
        b, s, h, hd), cos, sin)
    k = rope.apply_rope(plain_proj(lora, i, 'attn.wk', a.wk, hn).view(
        b, s, hk, hd), cos, sin)
    v = plain_proj(lora, i, 'attn.wv', a.wv, hn).view(b, s, hk, hd)
    out = attend(q, k, v)
    x = x + plain_proj(lora, i, 'attn.wo', a.wo,
                       out.to(model.dtype).reshape(b, s, h * hd))
    hn = layer.mlp_norm(x)
    hidden = F.silu(plain_proj(lora, i, 'mlp.w_gate', m.w_gate, hn)) * \
        plain_proj(lora, i, 'mlp.w_up', m.w_up, hn)
    return x + plain_proj(lora, i, 'mlp.w_down', m.w_down, hidden)


def plain_last_logits(model, tokens, exact=False, lora=None):
    """The model's forward with flash's plain version in place of the
    kernel (exact=True: the same attention computed from f32 copies of
    q, k, v, output rounded to the model dtype) and the LoRA plain
    versions in place of theirs: last-position logits."""
    import torch
    from skypilot_tpu_torch.ops import flash_attention as fa
    from skypilot_tpu_torch.ops import rope
    cfg = model.cfg
    b, s = tokens.shape
    x = model.tok_embed.to(model.dtype)[tokens]
    pos = torch.arange(s, device=tokens.device)[None].expand(b, s)
    cos, sin = rope.rope_freqs(pos, cfg.head_dim, cfg.rope_theta,
                               use_llama31_scaling=cfg.use_llama31_rope)

    def attend(q, k, v):
        if exact:
            q, k, v = q.float(), k.float(), v.float()
        return fa.flash_attention_reference(q, k, v, causal=True)[0]
    for i in range(len(model.layers)):
        x = plain_block(model, i, x, cos, sin, attend, lora)
    return model.lm_head(model.final_norm(x)[:, -1:])[:, 0].float()


def kernel_last_logits(model, tokens, lora=None):
    """The engine's lone-request prefill path (flash kernel, unpacked;
    lora: None or (stack, ids) through the LoRA kernels)."""
    import torch
    cfg = model.cfg
    b, s = tokens.shape
    shape = (cfg.n_layers, b, s, cfg.n_kv_heads, cfg.head_dim)
    dev = tokens.device
    cache = {'k': torch.zeros(shape, dtype=model.dtype, device=dev),
             'v': torch.zeros(shape, dtype=model.dtype, device=dev)}
    lp = torch.full((b, 1), s - 1, dtype=torch.long, device=dev)
    kw = {} if lora is None else {'lora': lora[0], 'lora_ids': lora[1]}
    logits, _ = model(tokens, cache=cache, logit_positions=lp, **kw)
    return logits[:, 0].float()


def check_logits(model, prompt):
    """One prefill's last-token logits through the kernel path against
    the same model with the plain attention. 32 random-weight bf16
    layers amplify rounding, so the check has two parts: kernel vs plain
    within LOGIT_REL_L2 (relative L2), and the kernel no further from
    f32-attention logits than 1.5x the plain version's distance + 5e-3."""
    import torch
    with torch.inference_mode():
        toks = torch.as_tensor([prompt],
                               device=next(model.parameters()).device)
        got = kernel_last_logits(model, toks)
        ref = plain_last_logits(model, toks)
        exact = plain_last_logits(model, toks, exact=True)
        torch.cuda.synchronize()

    def rel(a, b):
        return float((a - b).norm() / b.norm())
    res = {'rel_kernel_plain': rel(got, ref),
           'rel_kernel_exact': rel(got, exact),
           'rel_plain_exact': rel(ref, exact),
           'max_abs_kernel_plain': max_abs(got, ref),
           'argmax_equal': int(got.argmax()) == int(ref.argmax())}
    _log('lone prefill last-token logits (rel L2): kernel vs plain '
         f'{res["rel_kernel_plain"]:.3e} (limit {LOGIT_REL_L2}), kernel '
         f'vs f32-attention {res["rel_kernel_exact"]:.3e}, plain vs '
         f'f32-attention {res["rel_plain_exact"]:.3e}; max abs kernel vs '
         f'plain {res["max_abs_kernel_plain"]:.3e}; argmax equal '
         f'{res["argmax_equal"]}')
    assert torch.isfinite(got).all(), 'non-finite logits'
    assert res['rel_kernel_plain'] <= LOGIT_REL_L2, res
    assert res['rel_kernel_exact'] <= \
        1.5 * res['rel_plain_exact'] + 5e-3, res
    return res


def drain(q):
    toks = []
    while True:
        tok = q.get(timeout=600)
        if tok is None:
            return toks
        toks.append(tok)


def serve(eng, burst, params, lone, lone_params=None):
    """Drive one engine as a user would: the burst submitted before
    start() (packed ragged prefill), drained, then the lone request. The
    launch counters are set to 0 just before and read just after.
    Returns (token lists, launches, burst TTFT max s, lone wall s)."""
    from skypilot_tpu_torch.infer import engine as engine_lib
    from skypilot_tpu_torch.ops import flash_attention as fa
    from skypilot_tpu_torch.ops import lora as lora_ops
    from skypilot_tpu_torch.ops import paged_attention as pa
    fa.reset_launches()
    pa.reset_launches()
    lora_ops.reset_launches()
    queues = [eng.submit(p, sp)[1] for p, sp in zip(burst, params)]
    eng.start()
    try:
        outs = [drain(q) for q in queues]
        burst_ttft = eng.perf_stats()['ttft_max_s']
        t_lone = time.perf_counter()
        outs.append(eng.generate(lone, lone_params or
                                 engine_lib.SamplingParams(
                                     max_new_tokens=MAX_NEW)))
        lone_s = time.perf_counter() - t_lone
    finally:
        eng.stop()
    launches = {'flash_fwd': fa.launches, **pa.launches,
                **lora_ops.launches}
    vocab = eng.model.cfg.vocab_size
    for i, toks in enumerate(outs):
        assert len(toks) == MAX_NEW, f'request {i}: {len(toks)} tokens'
        assert all(0 <= t < vocab for t in toks), f'request {i}: bad id'
    return outs, launches, burst_ttft, lone_s


def warm_up(eng, rng):
    """A short request first: the process's (or the path's) first
    CUDA/cuBLAS calls pay one-time set-up that is not serving time."""
    from skypilot_tpu_torch.infer import engine as engine_lib
    t_w = time.perf_counter()
    eng.start()
    try:
        eng.generate(rng.integers(1, eng.model.cfg.vocab_size, 64).tolist(),
                     engine_lib.SamplingParams(max_new_tokens=4))
    finally:
        eng.stop()
    eng.reset_perf()
    return time.perf_counter() - t_w


def traffic(vocab, repeat=False):
    """The burst (BURST lengths, request 1 sampled at temperature 0.8 and
    top-k 40) and the lone prompt; with repeat, request 0 is a seeded
    40-token sequence repeated to 600 tokens (n-gram hits for the
    speculative proposer)."""
    import numpy as np
    from skypilot_tpu_torch.infer import engine as engine_lib
    rng = np.random.default_rng(SEED)
    burst = [rng.integers(1, vocab, n).tolist() for n in BURST]
    lone = rng.integers(1, vocab, LONE).tolist()
    if repeat:
        seq = np.random.default_rng(SEED + 1).integers(1, vocab, 40).tolist()
        burst[0] = (seq * 15)[:BURST[0]]
    params = [engine_lib.SamplingParams(max_new_tokens=MAX_NEW)
              for _ in burst]
    params[1] = engine_lib.SamplingParams(max_new_tokens=MAX_NEW,
                                          temperature=0.8, top_k=40,
                                          seed=SEED)
    return burst, params, lone


def run_engine(card):
    import numpy as np
    import torch
    from skypilot_tpu_torch.infer import server

    t0 = time.perf_counter()
    eng = server.build_engine(MODEL, seed=SEED)
    torch.cuda.synchronize()
    _log(f'build_engine({MODEL!r}): {eng.model.cfg.num_params() / 1e9:.2f}B '
         f'params, {time.perf_counter() - t0:.1f}s; paged pool '
         f'{list(eng.cache["k"].shape)} {eng.cache["k"].dtype}')
    burst, params, lone = traffic(eng.model.cfg.vocab_size)
    cold_s = warm_up(eng, np.random.default_rng(SEED + 2))
    outs, launches, burst_ttft, lone_s = serve(eng, burst, params, lone)
    perf = eng.perf_stats()
    assert perf['ragged_dispatches'] >= 1, 'no ragged admission ran'
    assert perf['prefill_dispatches'] >= 2, 'no single prefill ran'
    assert launches['flash_fwd'] > 0, 'flash kernel never launched'
    assert launches['paged_decode'] > 0, 'paged kernel never launched'
    _log(f'engine: {len(outs)} requests x {MAX_NEW} tokens; launches '
         f'{launches}; ragged dispatches {perf["ragged_dispatches"]}, '
         f'prefill dispatches {perf["prefill_dispatches"]}')
    # TTFTs are the engine's own (submit -> first token delivered).
    lone_ttft = eng.ttfts()[-1]
    decode_s = lone_s - lone_ttft
    _log(f'engine [{card}]: warm-up request {cold_s:.2f} s; burst TTFT '
         f'max {burst_ttft * 1e3:.1f} ms (4 prompts, one packed 2048 '
         f'prefill); lone TTFT {lone_ttft * 1e3:.1f} ms, then '
         f'{decode_s / (MAX_NEW - 1) * 1e3:.1f} ms per token (1 live '
         f'slot); steady decode {perf.get("steady_decode_tok_s", 0):.1f} '
         f'tok/s over the run (8 slots, <= 4 live)')
    res = {'launches': launches, 'outs': outs, 'warmup_request_s': cold_s,
           'burst_ttft_max_s': burst_ttft, 'lone_ttft_s': lone_ttft,
           'lone_ms_per_token': decode_s / (MAX_NEW - 1) * 1e3,
           'steady_decode_tok_s': perf.get('steady_decode_tok_s'),
           'perf': perf}
    res['logits'] = check_logits(eng.model, lone)
    return eng, res


# The int8 and speculative paths: (label, engine options, the kernel the
# path adds).
PATHS = (('int8', dict(kv_dtype='int8'), 'paged_decode_q'),
         ('spec', dict(spec_decode=3), 'paged_decode_mq'),
         ('int8_spec', dict(kv_dtype='int8', spec_decode=3),
          'paged_decode_mq_q'))


def run_paths(model, card, bf16_ms_per_token):
    """Engine runs (a) int8 KV, (b) spec_decode=3, (c) both, on the same
    model object, each engine's pools freed before the next. Each takes
    the burst + lone traffic (spec runs: with the repeated prompt); its
    kernel must launch, spec runs must verify, and one decode step on a
    fixed prefilled cache must match its plain version."""
    import numpy as np
    import torch
    from skypilot_tpu_torch.infer import engine as engine_lib
    out = {}
    for label, opts, kernel in PATHS:
        eng = engine_lib.InferenceEngine(
            model, num_slots=8, max_seq_len=2048, decode_chunk=16,
            page_size=64, **opts)
        spec = 'spec_decode' in opts
        burst, params, lone = traffic(model.cfg.vocab_size, repeat=spec)
        warm_up(eng, np.random.default_rng(SEED + 2))
        outs, launches, burst_ttft, lone_s = serve(eng, burst, params, lone)
        perf = eng.perf_stats()
        assert launches['flash_fwd'] > 0, f'{label}: flash never launched'
        assert launches[kernel] > 0, f'{label}: {kernel} never launched'
        if spec:
            assert perf['spec_verify_steps'] > 0, f'{label}: no verify step'
        lone_ttft = eng.ttfts()[-1]
        ms_tok = (lone_s - lone_ttft) / (MAX_NEW - 1) * 1e3
        accept = perf.get('spec_accept_per_step')
        del eng                          # frees its pools
        gc.collect()
        torch.cuda.empty_cache()
        _log(f'{label}: engine freed, {torch.cuda.memory_allocated() / 2**30:.1f}'
             ' GiB allocated (the model\'s weights)')
        steps = check_step(model, 'int8' in label, 4 if spec else 1)
        res = {'launches': launches, 'burst_ttft_max_s': burst_ttft,
               'lone_ttft_s': lone_ttft, 'lone_ms_per_token': ms_tok,
               'steady_decode_tok_s': perf.get('steady_decode_tok_s'),
               'spec_accept_per_step': accept, 'perf': perf,
               'step_rel_kernel_plain': steps['rel']}
        if label == 'int8':
            bf16 = check_step(model, False, 1)
            res['step_rel_bf16_kernel_plain'] = bf16['rel']
            res['rel_int8_vs_bf16'] = rel_l2(steps['logits'],
                                             bf16['logits'])
            _log(f'{label}: decode-step logits int8-KV vs bf16-KV '
                 f'(rel L2, printed, not asserted): '
                 f'{res["rel_int8_vs_bf16"]:.3e}; bf16 step kernel vs '
                 f'plain {bf16["rel"]:.3e}')
        _log(f'engine {label} [{card}]: {len(outs)} requests x {MAX_NEW} '
             f'tokens; launches {launches}; burst TTFT max '
             f'{burst_ttft * 1e3:.1f} ms; lone {ms_tok:.1f} ms per token '
             f'(bf16 run: {bf16_ms_per_token:.1f}); steady decode '
             f'{perf.get("steady_decode_tok_s", 0):.1f} tok/s'
             + (f'; spec_accept_per_step {accept:.3f} over '
                f'{perf["spec_verify_steps"]} verify steps' if spec else ''))
        out[label] = res
    return out


# The phase-3 adapters: ranks, alphas (scaling 2 each) and their seed.
LORA_RANKS = (16, 8, 16)
LORA_ALPHAS = (32.0, 16.0, 32.0)
LORA_SEED = SEED + 11


def random_adapter_trees(cfg):
    """LORA_RANKS adapters on all seven projections in the training layout
    (scanned: a leading layer axis; numpy f32 from a seeded generator).
    A ~ N(0, 1/in) and B ~ N(0, 1/r) * 0.1 / (alpha/r): each delta is
    about a tenth of its projection's RMS (the random base weights give
    unit-RMS outputs for unit-RMS inputs)."""
    import numpy as np
    rng = np.random.default_rng(LORA_SEED)
    d, q_out = cfg.dim, cfg.n_heads * cfg.head_dim
    kv_out = cfg.n_kv_heads * cfg.head_dim
    shapes = {'attn': {'wq': (d, q_out), 'wk': (d, kv_out),
                       'wv': (d, kv_out), 'wo': (q_out, d)},
              'mlp': {'w_gate': (d, cfg.mlp_dim), 'w_up': (d, cfg.mlp_dim),
                      'w_down': (cfg.mlp_dim, d)}}
    trees = []
    for r, alpha in zip(LORA_RANKS, LORA_ALPHAS):
        gain = np.float32(0.1 / (alpha / r) / math.sqrt(r))

        def leaf(shape, scale):
            x = rng.standard_normal(shape, dtype=np.float32)
            x *= np.float32(scale)
            return x
        trees.append(({'layers': {scope: {name: {'kernel': {
            'a': leaf((cfg.n_layers, i, r), 1.0 / math.sqrt(i)),
            'b': leaf((cfg.n_layers, r, o), gain)}}
            for name, (i, o) in projs.items()}
            for scope, projs in shapes.items()}}, alpha))
    return trees


def check_lora_logits(model, stack, prompt):
    """An unpacked prefill whose quarters run on adapters BURST_LORA
    (per-token ids: the grouped kernel): last-token logits through the
    kernels against the plain versions, rel L2 <= LOGIT_REL_L2."""
    import numpy as np
    import torch
    dev = next(model.parameters()).device
    n = len(prompt)
    ids = np.asarray(BURST_LORA, np.int32)[
        np.arange(n) * len(BURST_LORA) // n][None]
    ids_t = torch.as_tensor(ids, device=dev)
    with torch.inference_mode():
        toks = torch.as_tensor([prompt], device=dev)
        got = kernel_last_logits(model, toks, (stack, ids_t))
        ref = plain_last_logits(model, toks, lora=(stack, ids_t))
        torch.cuda.synchronize()
    r = rel_l2(got, ref)
    _log(f'LoRA prefill [1, {n}] with per-token ids {BURST_LORA} by '
         f'quarter: last-token logits kernel vs plain rel L2 {r:.3e} (limit '
         f'{LOGIT_REL_L2}), argmax equal '
         f'{int(got.argmax()) == int(ref.argmax())}')
    assert torch.isfinite(got).all(), 'non-finite logits'
    assert r <= LOGIT_REL_L2, r
    return {'rel': r}


def run_lora(card, bf16_res, profile=False):
    """The fifth engine: build_engine(..., lora_stack=) with three random
    adapters (LORA_RANKS, padded to 16) on the same weights (the same
    seed) as the bf16 run. The burst runs on adapters BURST_LORA in one
    ragged row (the grouped kernel), the lone prompt on adapter 2 (the
    gather kernel, then decode). Both LoRA kernels must launch, the id-0
    request's tokens must equal the bf16 run's, and a decode step (s = 1
    and s = 4) and a per-token prefill must match their plain versions."""
    import numpy as np
    import torch
    from skypilot_tpu_torch.infer import engine as engine_lib
    from skypilot_tpu_torch.infer import lora as lora_lib
    from skypilot_tpu_torch.infer import server
    from skypilot_tpu_torch.models import llama
    t0 = time.perf_counter()
    stack = lora_lib.place_stack(
        lora_lib.build_stack(random_adapter_trees(llama.CONFIGS[MODEL]),
                             dtype='bfloat16'), torch.bfloat16, 'cuda')
    stack_s = time.perf_counter() - t0
    eng = server.build_engine(MODEL, seed=SEED, lora_stack=stack)
    nbytes = sum(a.numel() * 2 + b.numel() * 2
                 for k, (a, b) in ((k, v) for k, v in stack.items()
                                   if k != 'scaling'))
    _log(f'LoRA stack: {eng.num_adapters} entries (id 0 + ranks '
         f'{LORA_RANKS}, padded to 16) on {len(stack) - 1} projections, '
         f'{nbytes / 2**20:.0f} MiB bf16, built in {stack_s:.1f}s')
    burst, params, lone = traffic(eng.model.cfg.vocab_size)
    for p, lid in zip(params, BURST_LORA):
        p.lora_id = lid
    lone_params = engine_lib.SamplingParams(max_new_tokens=MAX_NEW,
                                            lora_id=2)
    warm_up(eng, np.random.default_rng(SEED + 2))
    outs, launches, burst_ttft, lone_s = serve(eng, burst, params, lone,
                                               lone_params)
    perf = eng.perf_stats()
    assert perf['ragged_dispatches'] >= 1, 'no ragged admission ran'
    assert perf['prefill_dispatches'] >= 2, 'no single prefill ran'
    for k in ('flash_fwd', 'paged_decode', 'lora_gather', 'lora_grouped'):
        assert launches[k] > 0, f'lora: {k} never launched'
    j = BURST_LORA.index(0)
    same = outs[j] == bf16_res['outs'][j]
    _log(f'LoRA engine: the id-0 request (burst {j}) gives the bf16 run\'s '
         f'tokens: {same}')
    assert same, (outs[j], bf16_res['outs'][j])
    lone_ttft = eng.ttfts()[-1]
    ms_tok = (lone_s - lone_ttft) / (MAX_NEW - 1) * 1e3
    _log(f'engine lora [{card}]: {len(outs)} requests x {MAX_NEW} tokens '
         f'(adapters {BURST_LORA} + lone on 2); launches {launches}; burst '
         f'TTFT max {burst_ttft * 1e3:.1f} ms; lone TTFT '
         f'{lone_ttft * 1e3:.1f} ms, then {ms_tok:.1f} ms per token (bf16 '
         f'run: {bf16_res["lone_ms_per_token"]:.1f}); steady decode '
         f'{perf.get("steady_decode_tok_s", 0):.1f} tok/s')
    prof = profile_decode(eng, card, SLOT_LORA) if profile else None
    model = eng.model
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    step = check_step(model, False, 1, lora=stack)
    verify = check_step(model, False, 4, lora=stack)
    prefill = check_lora_logits(model, stack, lone)
    return {'launches': launches, 'stack_build_s': stack_s,
            'stack_mib': nbytes / 2**20, 'burst_ttft_max_s': burst_ttft,
            'lone_ttft_s': lone_ttft, 'lone_ms_per_token': ms_tok,
            'steady_decode_tok_s': perf.get('steady_decode_tok_s'),
            'perf': perf, 'id0_equals_bf16': same,
            'step_rel_kernel_plain': step['rel'],
            'step_rel_adapter_vs_base': step['rel_adapter_vs_base'],
            'verify_rel_kernel_plain': verify['rel'],
            'prefill_rel_kernel_plain': prefill['rel'], 'profile': prof}


def rel_l2(a, b) -> float:
    return float((a - b).norm() / b.norm())


def plain_step_logits(model, toks, positions, cache, lora=None):
    """The model's paged step (s tokens per slot) with each paged kernel's
    plain version in its place (and the LoRA plain versions, lora: None or
    (stack, ids [B])); the same appends, in place on `cache`."""
    import torch
    from skypilot_tpu_torch.ops import rope
    cfg = model.cfg
    x = model.tok_embed[toks]
    cos, sin = rope.rope_freqs(positions, cfg.head_dim, cfg.rope_theta,
                               use_llama31_scaling=cfg.use_llama31_rope)
    pos = positions[:, 0].to(torch.int32).contiguous()
    tables = cache['tables']
    for i in range(len(model.layers)):
        def attend(q, k, v, i=i):
            return paged_plain(cache, i, q, k, v, tables, pos)
        x = plain_block(model, i, x, cos, sin, attend, lora)
    return model.lm_head(model.final_norm(x)).float()


def paged_plain(cache, i, q, k, v, tables, pos):
    """Layer i's appends (in place on `cache`) and the paged kernels'
    plain versions: [B, S, Hq, d]."""
    from skypilot_tpu_torch.infer.paged_cache import PagePool
    from skypilot_tpu_torch.ops import paged_attention as pa
    s = q.shape[1]
    kp, vp = cache['k'][i], cache['v'][i]
    if 'k_scale' in cache:
        ks, vs = cache['k_scale'][i], cache['v_scale'][i]
        PagePool.append_tokens_layer_q(kp, ks, k, tables, pos)
        PagePool.append_tokens_layer_q(vp, vs, v, tables, pos)
        if s == 1:
            return pa.paged_decode_attention_q_reference(
                q[:, 0], kp, vp, ks, vs, tables, pos)[:, None]
        return pa.paged_decode_attention_mq_q_reference(
            q, kp, vp, ks, vs, tables, pos)
    PagePool.append_tokens_layer(kp, k, tables, pos)
    PagePool.append_tokens_layer(vp, v, tables, pos)
    if s == 1:
        return pa.paged_decode_attention_reference(
            q[:, 0], kp, vp, tables, pos)[:, None]
    return pa.paged_decode_attention_mq_reference(q, kp, vp, tables, pos)


# A fixed prefilled cache: four live slots of these prompt lengths, four
# released slots (all-zero rows) at these stale lengths.
STEP_LIVE = (600, 64, 590, 300)
STEP_FREED = (1000, 5, 2040, 77)


def check_step(model, quant, s, lora=None):
    """One paged step of s tokens per slot (s = 1: decode; s = 4: verify)
    on a fixed prefilled cache (bf16 or int8 pools), through the kernels
    (the model's forward) and through their plain versions (the same
    layers by hand): rel L2 of the live slots' logits <= LOGIT_REL_L2.
    With a LoRA stack the slots take SLOT_LORA's adapters (the gather
    kernel) and the step also runs without the stack: an adapter slot's
    logits must move by more than LOGIT_REL_L2, an id-0 slot's not at all
    (its rows add nothing)."""
    import numpy as np
    import torch
    from skypilot_tpu_torch.infer.paged_cache import PagePool
    cfg = model.cfg
    dev = next(model.parameters()).device
    page, mp = 64, 32
    rng = np.random.default_rng(SEED + 7)
    spans = [-(-(n + s) // page) for n in STEP_LIVE]
    n_pages = sum(spans) + 1
    shape = (cfg.n_layers, n_pages, cfg.n_kv_heads, page, cfg.head_dim)
    pool_dt = torch.int8 if quant else model.dtype
    cache = {'k': torch.zeros(shape, dtype=pool_dt, device=dev),
             'v': torch.zeros(shape, dtype=pool_dt, device=dev)}
    if quant:
        for name in ('k_scale', 'v_scale'):
            cache[name] = torch.zeros(shape[:-1], device=dev)
    tables = np.zeros((8, mp), np.int32)
    nxt = 1
    with torch.inference_mode():
        for slot, (n, span) in enumerate(zip(STEP_LIVE, spans)):
            tables[slot, :span] = np.arange(nxt, nxt + span)
            nxt += span
            n_pad = -(-n // page) * page
            toks = torch.as_tensor(rng.integers(1, cfg.vocab_size, (1, n_pad)),
                                   device=dev)
            pshape = (cfg.n_layers, 1, n_pad, cfg.n_kv_heads, cfg.head_dim)
            _, pc = model(toks, cache={
                'k': torch.zeros(pshape, dtype=model.dtype, device=dev),
                'v': torch.zeros(pshape, dtype=model.dtype, device=dev)},
                logit_positions=torch.zeros((1, 1), dtype=torch.long,
                                            device=dev))
            ids = torch.as_tensor(tables[slot, :n_pad // page], device=dev)
            for name in ('k', 'v'):
                if quant:
                    PagePool.insert_prompt_q(cache[name],
                                             cache[f'{name}_scale'],
                                             pc[name], ids)
                else:
                    PagePool.insert_prompt(cache[name], pc[name], ids)
        lens = np.array(STEP_LIVE + STEP_FREED, np.int32)
        toks = torch.as_tensor(rng.integers(1, cfg.vocab_size, (8, s)),
                               device=dev)
        positions = torch.as_tensor(lens[:, None] + np.arange(s),
                                    device=dev)
        cache['tables'] = torch.as_tensor(tables, device=dev)
        copy = {k: v.clone() for k, v in cache.items()}
        kw, plain_lora = {}, None
        if lora is not None:
            ids = torch.tensor(SLOT_LORA, dtype=torch.int32, device=dev)
            kw, plain_lora = {'lora': lora, 'lora_ids': ids}, (lora, ids)
            base_cache = {k: v.clone() for k, v in cache.items()}
        got, _ = model(toks, positions=positions, cache=cache, **kw)
        ref = plain_step_logits(model, toks, positions, copy, plain_lora)
        if lora is not None:
            base, _ = model(toks, positions=positions, cache=base_cache)
        torch.cuda.synchronize()
    live = len(STEP_LIVE)
    got, ref = got[:live].float(), ref[:live]
    assert torch.isfinite(got).all(), 'non-finite step logits'
    r = rel_l2(got, ref)
    label = ('int8' if quant else 'bf16') + (' + LoRA' if lora else '')
    _log(f'{label} paged step s={s}: logits kernel vs '
         f'plain rel L2 {r:.3e} (limit {LOGIT_REL_L2}), argmax equal '
         f'{float((got.argmax(-1) == ref.argmax(-1)).float().mean()):.3f}')
    assert r <= LOGIT_REL_L2, r
    res = {'rel': r, 'logits': got}
    if lora is not None:
        base = base[:live].float()
        moved = [rel_l2(got[i], base[i]) for i in range(live)
                 if SLOT_LORA[i] != 0]
        still = [i for i in range(live) if SLOT_LORA[i] == 0]
        _log(f'{label} step: adapter slots move their logits by rel L2 '
             f'{", ".join(f"{m:.3e}" for m in moved)} against the base '
             f'model; id-0 slots {still} equal to the base: '
             f'{all(torch.equal(got[i], base[i]) for i in still)}')
        assert min(moved) > LOGIT_REL_L2, moved
        assert all(torch.equal(got[i], base[i]) for i in still)
        res['rel_adapter_vs_base'] = moved
    return res


def profile_decode(eng, card, slot_lora=None):
    """Where a decode step's time goes: one 16-step chunk under
    torch.profiler (host and device), summed by kernel. slot_lora: the
    adapter id of each (stale) slot during the chunk, for a LoRA engine."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    if slot_lora is not None:
        eng._d_lora.copy_(torch.tensor(slot_lora, dtype=torch.int32))
    with torch.inference_mode():
        eng._decode_n_impl(16, False).cpu()   # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            eng._decode_n_impl(16, False).cpu()
        wall = time.perf_counter() - t0
    # Device kernels only (the CPU ops that launched them also carry
    # their device time).
    events = [e for e in prof.key_averages()
              if str(e.device_type).endswith('CUDA')]
    dev_us = sum(e.self_device_time_total for e in events)
    what = 'profile' if slot_lora is None else \
        f'profile (LoRA, slots on adapters {list(slot_lora)})'
    _log(f'{what} [{card}]: decode chunk of 16 steps x 8 slots: wall '
         f'{wall * 1e3 / 16:.2f} ms/step, device busy '
         f'{dev_us / 1e3 / 16:.2f} ms/step')
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:12]
    for e in top:
        _log(f'  device {e.self_device_time_total / 1e3 / 16:8.3f} ms/step '
             f'{e.count // 16:6d} calls/step  {e.key[:72]}')
    host = [e for e in prof.key_averages()
            if not str(e.device_type).endswith('CUDA')]
    host_us = sum(e.self_cpu_time_total for e in host)
    _log(f'  host ops (profiled, inflated by the profiler): '
         f'{host_us / 1e3 / 16:.2f} ms/step self time in '
         f'{sum(e.count for e in host) // 16} calls/step')
    for e in sorted(host, key=lambda e: -e.self_cpu_time_total)[:8]:
        _log(f'  host {e.self_cpu_time_total / 1e3 / 16:8.3f} ms/step '
             f'{e.count // 16:6d} calls/step  {e.key[:72]}')
    return {'wall_ms_per_step': wall * 1e3 / 16,
            'device_ms_per_step': dev_us / 1e3 / 16,
            'host_ops_per_step': sum(e.count for e in host) // 16}


# ----------------------------------------------------------- phase 4
def time_flash(gen, s, seg_np=None):
    import numpy as np
    import torch
    import torch.nn.functional as F
    from skypilot_tpu_torch.ops import flash_attention as fa
    q, k, v = flash_inputs(gen, s)
    seg = torch.as_tensor(seg_np, device='cuda') if seg_np is not None \
        else None
    b, _, hq, d = q.shape
    def kernel():
        return fa.flash_attention_fwd_lse(q, k, v, causal=True,
                                          segment_ids=seg)
    ms = time_ms(kernel, 20)
    launch_ms = eager_ms(kernel, 20)
    plain_ms = time_ms(lambda: fa.flash_attention_reference(
        q, k, v, causal=True, segment_ids=seg), 2)
    causal = torch.ones((s, s), dtype=torch.bool, device='cuda').tril()
    mask = causal if seg is None else causal & (seg[0, :, None] ==
                                                seg[0, None, :])
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask[None, None], enable_gqa=True), 20)
    # Useful work: each visible (q, k) pair, QK^T and PV at 2 flops per
    # multiply-add each; an id's c tokens see c(c+1)/2 pairs.
    ids = seg_np[0] if seg_np is not None else np.ones(s, np.int32)
    pairs = sum(c * (c + 1) // 2 for c in np.unique(ids,
                                                    return_counts=True)[1])
    flops = 4.0 * hq * d * pairs
    nbytes = 2 * (q.numel() * 2 + k.numel() + v.numel()) + 4 * b * hq * s
    if seg is not None:
        nbytes += 4 * seg.numel()
    bound_flops = flops / BF16_FLOPS_PER_S * 1e3
    bound_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return {'shape': list(q.shape), 'ms': ms, 'eager_ms': launch_ms,
            'plain_ms': plain_ms, 'library_ms': lib_ms,
            'bound_ms': max(bound_flops, bound_bytes),
            'bound_by': 'operations' if bound_flops >= bound_bytes
            else 'bytes', 'flops': flops, 'bytes': nbytes}


def time_paged(gen, kname):
    """Kernel 2 (kname 'paged_decode') or one of FAMILY at the slice's
    decode shapes. The bound counts each visible K/V row (and its scales)
    once, q and out once, and 4*d flops per query head and visible
    (token, key) pair."""
    from skypilot_tpu_torch.ops import paged_attention as pa
    fn, t, quant, _ = FAMILY.get(kname, ('paged_decode_attention', 1,
                                         False, None))
    args = paged_inputs(gen, t, quant)
    wrapper = getattr(pa, fn)
    plain = getattr(pa, fn + '_reference')
    ms = time_ms(lambda: wrapper(*args), 50)
    launch_ms = eager_ms(lambda: wrapper(*args), 50)
    plain_ms = time_ms(lambda: plain(*args), 5)
    q, kp, tables, lengths = args[0], args[1], args[-2], args[-1]
    hq, d = q.shape[-2:]
    hkv, page = kp.shape[1], kp.shape[2]
    rows, pairs = visible_rows(tables, lengths, page, t)
    row_bytes = 2 * hkv * d * kp.element_size() + (2 * hkv * 4 if quant
                                                   else 0)
    nbytes = row_bytes * rows + 2 * 2 * q.numel() + \
        4 * (tables.numel() + lengths.numel())
    flops = 4.0 * hq * d * pairs
    bound_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    bound_flops = flops / BF16_FLOPS_PER_S * 1e3
    return {'shape': list(q.shape), 'ms': ms, 'eager_ms': launch_ms,
            'plain_ms': plain_ms, 'library_ms': None,
            'bound_ms': max(bound_bytes, bound_flops),
            'bound_by': 'bytes' if bound_bytes >= bound_flops
            else 'operations', 'flops': flops, 'bytes': nbytes}


def time_lora(gen, case):
    """Kernel 6 or 7 at one LORA_CASES shape: the kernel (the delta, and
    added in place into y as the model runs it), its plain version, and
    the nearest library path (no single PyTorch call gathers per-row
    adapters: index_select of each sequence's, or token's, A and B, two
    torch.bmm and the scale). The bound counts x, the output, the ids and
    scales, and each distinct non-zero adapter's A and B once, and
    2*r*(in + out) flops per token with an adapter."""
    import torch
    from skypilot_tpu_torch.ops import lora as lora_ops
    x, a, b, ids, scale = lora_case_inputs(gen, case)
    per_token = ids.dim() == 2
    plain = lora_ops.lora_grouped_reference if per_token else \
        lora_ops.lora_gather_reference
    bsz, s, din = x.shape
    r, dout = a.shape[-1], b.shape[-1]
    y = torch.randn((bsz, s, dout), generator=gen, device='cuda',
                    dtype=torch.bfloat16)

    def kernel():
        return lora_ops.grouped_lora_delta(x, a, b, ids, scale)
    ms = time_ms(kernel, 50)
    launch_ms = eager_ms(kernel, 50)
    fused_ms = time_ms(
        lambda: lora_ops.add_lora_delta_(y, x, a, b, ids, scale), 50)
    plain_ms = time_ms(lambda: plain(x, a, b, ids, scale), 5)
    if per_token:
        xs, rows, sc = x.reshape(-1, 1, din), ids.reshape(-1).long(), \
            scale.reshape(-1)
    else:
        xs, rows, sc = x, ids.long(), scale

    def library():
        ga = a.index_select(0, rows)
        gb = b.index_select(0, rows)
        return torch.bmm(torch.bmm(xs, ga), gb) * sc[:, None, None].to(
            x.dtype)
    lib_ms = time_ms(library, 5)
    tok_ids = ids if per_token else ids[:, None].expand(bsz, s)
    adapted = int((tok_ids != 0).sum())
    distinct = int(torch.unique(tok_ids[tok_ids != 0]).numel())
    nbytes = 2 * (x.numel() + bsz * s * dout) + \
        2 * distinct * r * (din + dout) + 4 * (ids.numel() + scale.numel())
    flops = 2.0 * adapted * r * (din + dout)
    bound_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    bound_flops = flops / BF16_FLOPS_PER_S * 1e3
    return {'kernel': 'lora_grouped' if per_token else 'lora_gather',
            'shape': list(x.shape), 'out': dout, 'rank': r, 'ms': ms,
            'eager_ms': launch_ms, 'fused_ms': fused_ms,
            'plain_ms': plain_ms, 'library_ms': None,
            'index_bmm_ms': lib_ms,
            'bound_ms': max(bound_bytes, bound_flops),
            'bound_by': 'bytes' if bound_bytes >= bound_flops
            else 'operations', 'flops': flops, 'bytes': nbytes,
            'adapted_tokens': adapted, 'distinct_adapters': distinct}


# Kernels 6-7 timed at these LORA_CASES shapes; the first of each kernel
# goes into the {"kernels": [...]} line.
LORA_TIMED = ('gather_decode', 'gather_decode_down', 'gather_verify',
              'gather_lone', 'grouped_burst')


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--quick', action='store_true',
                    help='build and check the kernels only')
    ap.add_argument('--profile', action='store_true',
                    help='also profile one decode chunk (bf16 and LoRA '
                    'engines)')
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 2
    from skypilot_tpu_torch.ops import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    name = torch.cuda.get_device_name(0)
    _log(f'card: {card}')
    _log(f'torch {torch.__version__} cuda {torch.version.cuda} '
         f'python {sys.version.split()[0]}')
    t0 = time.perf_counter()
    info = _build.build_all()
    build_s = time.perf_counter() - t0
    _log(f'kernels built in {build_s:.1f}s: ' + ', '.join(
        f'{k} {v["seconds"]:.1f}s' for k, v in info.items()))
    for k, v in info.items():
        for line in str(v['log']).splitlines():
            if 'registers' in line or 'spill' in line:
                _log(f'  ptxas {k}: {line.strip()}')

    gen = torch.Generator(device='cuda')
    gen.manual_seed(SEED)
    with torch.inference_mode():
        flash_res = check_flash(gen)
        paged_res = check_paged(gen)
        family_res = check_family(gen)
        lora_res = check_lora(gen)
    if args.quick:
        _log(card)
        print(json.dumps({'ok': True, 'device': {
            'platform': 'gpu', 'kind': name,
            'count': torch.cuda.device_count()}}))
        return 0

    eng, eng_res = run_engine(card)
    if args.profile:
        eng_res['profile'] = profile_decode(eng, card)
    model = eng.model
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    paths_res = run_paths(model, card, eng_res['lone_ms_per_token'])
    del model
    gc.collect()
    torch.cuda.empty_cache()
    lora_run = run_lora(card, eng_res, args.profile)
    gc.collect()
    torch.cuda.empty_cache()

    cases = {c[0]: c for c in LORA_CASES}
    with torch.inference_mode():
        tf = time_flash(gen, 2048, packed_segments(BURST, 64, 2048))
        tf_causal = time_flash(gen, 512)
        tp = {k: time_paged(gen, k) for k in ('paged_decode', *FAMILY)}
        tl = {c: time_lora(gen, cases[c]) for c in LORA_TIMED}
    timed = [('flash packed [1, 2048, 32, 128]', tf),
             ('flash unpacked causal [1, 512, 32, 128]', tf_causal)] + [
        (f'{k} {t["shape"]}', t) for k, t in tp.items()] + [
        (f'{t["kernel"]} {c} {t["shape"]} -> {t["out"]}', t)
        for c, t in tl.items()]
    for label, t in timed:
        lib = f'{t["library_ms"]:.4f}' if t['library_ms'] else 'none'
        extra = (f'; in place into y {t["fused_ms"]:.4f} ms; index_select + '
                 f'2 bmm {t["index_bmm_ms"]:.4f} ms'
                 if 'fused_ms' in t else '')
        _log(f'{label} [{card}]: {t["ms"]:.4f} ms (eager '
             f'{t["eager_ms"]:.4f}), plain {t["plain_ms"]:.4f} ms, '
             f'library {lib} ms, bound {t["bound_ms"]:.4f} ms '
             f'({t["bound_by"]}){extra}')
    # Each kernel's launches come from the run of the path it serves:
    # flash and kernel 2 from the bf16 run, kernels 3-5 from theirs.
    path_of = {kernel: label for label, _, kernel in PATHS}
    kernels = [
        {'name': 'flash_fwd', 'route': 'cuda',
         'source': 'skypilot_tpu_torch/csrc/flash_fwd.cu',
         'replaces': 'skypilot_tpu/ops/flash_attention.py:108 _fwd_kernel',
         'launches': eng_res['launches']['flash_fwd'],
         'max_abs_err': flash_res['packed']['max_abs_err'],
         'ms': tf['ms'], 'kernel_ms': tf['ms'], 'plain_ms': tf['plain_ms'],
         'bound_ms': tf['bound_ms'], 'bound_by': tf['bound_by'],
         'library_ms': tf['library_ms'], 'shape': tf['shape']}]
    for k, t in tp.items():
        launches = eng_res['launches'][k] if k == 'paged_decode' else \
            paths_res[path_of[k]]['launches'][k]
        err = paged_res['slice']['max_abs_err'] if k == 'paged_decode' \
            else family_res[k]['slice']['max_abs_err']
        kernels.append({
            'name': k, 'route': 'cuda',
            'source': 'skypilot_tpu_torch/csrc/paged_decode.cu',
            'replaces': FAMILY[k][3] if k in FAMILY else
            'skypilot_tpu/ops/paged_attention.py:50 _kernel',
            'launches': launches, 'max_abs_err': err, 'ms': t['ms'],
            'kernel_ms': t['ms'], 'eager_ms': t['eager_ms'],
            'plain_ms': t['plain_ms'], 'bound_ms': t['bound_ms'],
            'bound_by': t['bound_by'], 'library_ms': None,
            'shape': t['shape']})
    # Kernels 6-7: launches from the LoRA run; times at decode (gather)
    # and the burst's packed row (grouped).
    for k, case, line in (
            ('lora_gather', 'gather_decode',
             'skypilot_tpu/ops/lora.py:64 _gather_kernel'),
            ('lora_grouped', 'grouped_burst',
             'skypilot_tpu/ops/lora.py:74 _grouped_kernel')):
        t = tl[case]
        kernels.append({
            'name': k, 'route': 'cuda',
            'source': 'skypilot_tpu_torch/csrc/lora.cu', 'replaces': line,
            'launches': lora_run['launches'][k],
            'max_abs_err': lora_res[case]['max_abs_err'], 'ms': t['ms'],
            'kernel_ms': t['ms'], 'eager_ms': t['eager_ms'],
            'plain_ms': t['plain_ms'], 'bound_ms': t['bound_ms'],
            'bound_by': t['bound_by'], 'library_ms': None,
            'index_bmm_ms': t['index_bmm_ms'], 'fused_ms': t['fused_ms'],
            'shape': t['shape'] + [t['out']]})
    details = {'card': card, 'build_s': build_s, 'engine': eng_res,
               'paths': paths_res, 'lora': lora_run,
               'flash_packed': tf, 'flash_causal_512': tf_causal,
               'paged': tp, 'lora_timed': tl,
               'checks': {'flash': flash_res, 'paged': paged_res,
                          'family': family_res, 'lora': lora_res}}
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           'smoke_out')
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, 'chip_smoke.json'), 'w') as f:
        json.dump(details, f, indent=1, default=str)
    assert all(math.isfinite(k['ms']) for k in kernels)
    _log(card)
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': name,
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
