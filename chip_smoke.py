#!/usr/bin/env python3
"""Drive the PyTorch port (skypilot_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py            # the full smoke, one card
    python3 chip_smoke.py --quick    # build + kernel-vs-plain checks only
    python3 chip_smoke.py --profile  # also profile one decode chunk

Phases (any failure exits non-zero and prints no result line):
  1. the card's name and power limit (nvidia-smi), and the build of
     every CUDA kernel from csrc/ (one nvcc per source, all at once);
  2. each kernel against its plain PyTorch version on the card, in bf16
     at the serving path's shapes (atol = rtol = 2e-2: bf16 outputs
     rounded against an f32-accumulated reference);
  3. llama3-8b at full width (random weights from a seed) served through
     build_engine -> InferenceEngine.submit/generate on the paged cache:
     a burst of mixed-length prompts submitted before start() (packed
     ragged prefill), then a lone request (single prefill). Every
     request must return its tokens, both kernels' launch counters must
     rise during the run, and one prefill's last-token logits must match
     the same model run with the plain attention (check_logits);
  4. kernel timings: device time per call from CUDA events around a
     replayed CUDA graph of many calls (eager_ms: the same with Python's
     launch overhead), for the kernel, its plain version and one PyTorch
     library call where one computes the same function; and the bound
     (the larger of bytes / 3.35 TB/s and flops / 989 TFLOP/s, counted
     from this run's inputs);
  5. last line: {"ok": true, "device": {...}}.

It imports nothing of JAX and nothing of the JAX package.
"""
import argparse
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


def paged_inputs(gen):
    """q [8, 32, 128], pools [257, 8, 64, 128]; slots of mixed lengths
    (0 included) and a freed slot (all-zero row, stale length)."""
    import numpy as np
    import torch
    slots, hq, hkv, d, page, n_pages, mp = 8, 32, 8, 128, 64, 257, 32
    q = torch.randn((slots, hq, d), generator=gen, device='cuda',
                    dtype=torch.bfloat16)
    kp = torch.randn((n_pages, hkv, page, d), generator=gen, device='cuda',
                     dtype=torch.bfloat16)
    vp = torch.randn((n_pages, hkv, page, d), generator=gen, device='cuda',
                     dtype=torch.bfloat16)
    lengths = np.array([0, 63, 64, 600, 1500, 2047, 130, 777], np.int32)
    tables = np.zeros((slots, mp), np.int32)
    perm = np.random.default_rng(SEED).permutation(np.arange(1, n_pages))
    nxt = 0
    for s in range(slots - 1):          # the last slot is freed
        n = -(-(int(lengths[s]) + 1) // page)
        tables[s, :n] = perm[nxt:nxt + n]
        nxt += n
    return (q, kp, vp, torch.as_tensor(tables, device='cuda'),
            torch.as_tensor(lengths, device='cuda'))


def visible_rows(tables, lengths, page):
    """KV rows the paged kernel must read: positions <= lengths[s] on
    pages that pass kernel 2's skip rule."""
    t, ln = tables.cpu().numpy(), lengths.cpu().numpy()
    total = 0
    for s in range(t.shape[0]):
        pos = int(ln[s])
        for j in range(min(t.shape[1], pos // page + 1)):
            if t[s, j] == 0 and j != 0:
                continue
            total += min(page, pos - j * page + 1)
    return total


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


# ----------------------------------------------------------- phase 3
def plain_last_logits(model, tokens, exact=False):
    """The model's forward with flash's plain version in place of the
    kernel (exact=True: the same attention computed from f32 copies of
    q, k, v, output rounded to the model dtype): last-position logits."""
    import torch
    from skypilot_tpu_torch.ops import flash_attention as fa
    from skypilot_tpu_torch.ops import rope
    cfg = model.cfg
    b, s = tokens.shape
    h, hk, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    x = model.tok_embed.to(model.dtype)[tokens]
    pos = torch.arange(s, device=tokens.device)[None].expand(b, s)
    cos, sin = rope.rope_freqs(pos, hd, cfg.rope_theta,
                               use_llama31_scaling=cfg.use_llama31_rope)
    for layer in model.layers:
        a = layer.attn
        hn = layer.attn_norm(x)
        q = rope.apply_rope(a.wq(hn).view(b, s, h, hd), cos, sin)
        k = rope.apply_rope(a.wk(hn).view(b, s, hk, hd), cos, sin)
        v = a.wv(hn).view(b, s, hk, hd)
        if exact:
            q, k, v = q.float(), k.float(), v.float()
        out, _ = fa.flash_attention_reference(q, k, v, causal=True)
        x = x + a.wo(out.to(model.dtype).reshape(b, s, h * hd))
        x = x + layer.mlp(layer.mlp_norm(x))
    return model.lm_head(model.final_norm(x)[:, -1:])[:, 0].float()


def kernel_last_logits(model, tokens):
    """The engine's lone-request prefill path (flash kernel, unpacked)."""
    import torch
    cfg = model.cfg
    b, s = tokens.shape
    shape = (cfg.n_layers, b, s, cfg.n_kv_heads, cfg.head_dim)
    dev = tokens.device
    cache = {'k': torch.zeros(shape, dtype=model.dtype, device=dev),
             'v': torch.zeros(shape, dtype=model.dtype, device=dev)}
    lp = torch.full((b, 1), s - 1, dtype=torch.long, device=dev)
    logits, _ = model(tokens, cache=cache, logit_positions=lp)
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


def run_engine(card):
    import numpy as np
    import torch
    from skypilot_tpu_torch.infer import engine as engine_lib
    from skypilot_tpu_torch.infer import server
    from skypilot_tpu_torch.ops import flash_attention as fa
    from skypilot_tpu_torch.ops import paged_attention as pa

    t0 = time.perf_counter()
    eng = server.build_engine(MODEL, seed=SEED)
    torch.cuda.synchronize()
    _log(f'build_engine({MODEL!r}): {eng.model.cfg.num_params() / 1e9:.2f}B '
         f'params, {time.perf_counter() - t0:.1f}s; paged pool '
         f'{list(eng.cache["k"].shape)} {eng.cache["k"].dtype}')
    vocab = eng.model.cfg.vocab_size
    rng = np.random.default_rng(SEED)
    burst = [rng.integers(1, vocab, n).tolist() for n in BURST]
    lone = rng.integers(1, vocab, LONE).tolist()
    params = [engine_lib.SamplingParams(max_new_tokens=MAX_NEW)
              for _ in burst]
    params[1] = engine_lib.SamplingParams(max_new_tokens=MAX_NEW,
                                          temperature=0.8, top_k=40,
                                          seed=SEED)

    # Warm-up request: the process's first CUDA/cuBLAS calls pay one-time
    # set-up that is not serving time.
    t_w = time.perf_counter()
    eng.start()
    try:
        eng.generate(rng.integers(1, vocab, 64).tolist(),
                     engine_lib.SamplingParams(max_new_tokens=4))
    finally:
        eng.stop()
    cold_s = time.perf_counter() - t_w
    eng.reset_perf()

    fa.reset_launches()
    pa.reset_launches()
    queues = [eng.submit(p, sp)[1] for p, sp in zip(burst, params)]
    eng.start()
    try:
        outs = [drain(q) for q in queues]
        burst_ttft = eng.perf_stats()['ttft_max_s']
        t_lone = time.perf_counter()
        outs.append(eng.generate(lone, engine_lib.SamplingParams(
            max_new_tokens=MAX_NEW)))
        lone_s = time.perf_counter() - t_lone
    finally:
        eng.stop()
    launches = {'flash_fwd': fa.launches, 'paged_decode': pa.launches}
    perf = eng.perf_stats()
    for i, toks in enumerate(outs):
        assert len(toks) == MAX_NEW, f'request {i}: {len(toks)} tokens'
        assert all(0 <= t < vocab for t in toks), f'request {i}: bad id'
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
    res = {'launches': launches, 'warmup_request_s': cold_s,
           'burst_ttft_max_s': burst_ttft, 'lone_ttft_s': lone_ttft,
           'lone_ms_per_token': decode_s / (MAX_NEW - 1) * 1e3,
           'steady_decode_tok_s': perf.get('steady_decode_tok_s'),
           'perf': perf}
    res['logits'] = check_logits(eng.model, lone)
    return eng, res


def profile_decode(eng, card):
    """Where a decode step's time goes: one 16-step chunk under
    torch.profiler (host and device), summed by kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile
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
    _log(f'profile [{card}]: decode chunk of 16 steps x 8 slots: wall '
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


def time_paged(gen):
    from skypilot_tpu_torch.ops import paged_attention as pa
    q, kp, vp, tables, lengths = paged_inputs(gen)
    def kernel():
        return pa.paged_decode_attention(q, kp, vp, tables, lengths)
    ms = time_ms(kernel, 50)
    launch_ms = eager_ms(kernel, 50)
    plain_ms = time_ms(lambda: pa.paged_decode_attention_reference(
        q, kp, vp, tables, lengths), 5)
    s_slots, hq, d = q.shape
    hkv, page = kp.shape[1], kp.shape[2]
    rows = visible_rows(tables, lengths, page)
    nbytes = 2 * hkv * d * 2 * rows + 2 * 2 * q.numel() + \
        4 * (tables.numel() + lengths.numel())
    flops = 4.0 * hq * d * rows / hkv
    bound_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    bound_flops = flops / BF16_FLOPS_PER_S * 1e3
    return {'shape': list(q.shape), 'ms': ms, 'eager_ms': launch_ms,
            'plain_ms': plain_ms, 'library_ms': None,
            'bound_ms': max(bound_bytes, bound_flops),
            'bound_by': 'bytes' if bound_bytes >= bound_flops
            else 'operations', 'flops': flops, 'bytes': nbytes}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--quick', action='store_true',
                    help='build and check the kernels only')
    ap.add_argument('--profile', action='store_true',
                    help='also profile one decode chunk')
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
    if args.quick:
        _log(card)
        print(json.dumps({'ok': True, 'device': {
            'platform': 'gpu', 'kind': name,
            'count': torch.cuda.device_count()}}))
        return 0

    eng, eng_res = run_engine(card)
    if args.profile:
        eng_res['profile'] = profile_decode(eng, card)
    del eng
    torch.cuda.empty_cache()

    with torch.inference_mode():
        tf = time_flash(gen, 2048, packed_segments(BURST, 64, 2048))
        tf_causal = time_flash(gen, 512)
        tp = time_paged(gen)
    for label, t in (('flash packed [1, 2048, 32, 128]', tf),
                     ('flash unpacked causal [1, 512, 32, 128]', tf_causal),
                     ('paged [8, 32, 128]', tp)):
        lib = f'{t["library_ms"]:.4f}' if t['library_ms'] else 'none'
        _log(f'{label} [{card}]: {t["ms"]:.4f} ms (eager '
             f'{t["eager_ms"]:.4f}), plain {t["plain_ms"]:.4f} ms, '
             f'library {lib} ms, bound {t["bound_ms"]:.4f} ms '
             f'({t["bound_by"]})')
    kernels = [
        {'name': 'flash_fwd', 'route': 'cuda',
         'source': 'skypilot_tpu_torch/csrc/flash_fwd.cu',
         'replaces': 'skypilot_tpu/ops/flash_attention.py:108 _fwd_kernel',
         'launches': eng_res['launches']['flash_fwd'],
         'max_abs_err': flash_res['packed']['max_abs_err'],
         'ms': tf['ms'], 'kernel_ms': tf['ms'], 'plain_ms': tf['plain_ms'],
         'bound_ms': tf['bound_ms'], 'bound_by': tf['bound_by'],
         'library_ms': tf['library_ms'], 'shape': tf['shape']},
        {'name': 'paged_decode', 'route': 'cuda',
         'source': 'skypilot_tpu_torch/csrc/paged_decode.cu',
         'replaces': 'skypilot_tpu/ops/paged_attention.py:50 _kernel',
         'launches': eng_res['launches']['paged_decode'],
         'max_abs_err': paged_res['slice']['max_abs_err'],
         'ms': tp['ms'], 'kernel_ms': tp['ms'], 'plain_ms': tp['plain_ms'],
         'bound_ms': tp['bound_ms'], 'bound_by': tp['bound_by'],
         'library_ms': None, 'shape': tp['shape']},
    ]
    details = {'card': card, 'build_s': build_s, 'engine': eng_res,
               'flash_packed': tf, 'flash_causal_512': tf_causal,
               'paged': tp, 'checks': {'flash': flash_res,
                                       'paged': paged_res}}
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
