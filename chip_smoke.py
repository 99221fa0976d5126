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
     widths that are not multiples of 8 or of the tiles; ranks above
     128 (decode at ranks 256, 16, 8; [2, 23, 100] -> 37 at ranks 200,
     5, 12 with random per-token ids); id-0 rows must be exact zeros (or
     exactly y), REPEATS calls bit-equal, and the kernel's count of a
     block's shared memory (skyt_lora_smem) equal to lora_plan's; and
     the flash backward kernel (dq,
     dk and dv in one pass) against the plain backward (BWD_CASES: the
     sft shape [1, 2048, 32, 64] with 8 kv heads causal, a packed row,
     head_dim 128, non-causal rows, ragged tails, MHA, segment
     boundaries inside a key tile; and with the sliding window:
     mistral-7b's [1, 6144, 32, 128] row with window 4096, the packed
     sft row with window 300, windows 7, 65 and 100, causal or not); a
     second call on the same inputs must give bit-equal dk and dv
     (whether dq is, is logged: its f32 adds across key tiles land in no
     fixed order), and with torch.use_deterministic_algorithms on
     (ordered adds) the same checks hold and dq is bit-equal too. The
     forward kernel with the window (FWD_WINDOW_CASES): mistral-7b's
     [1, 6144] causal row and packed [1, 8192] row (6000 + 2000 tokens)
     at window 4096, windows 1, 7, 63, 65, 100 and one of S (bit-equal to
     no window), non-causal bands, head_dim 64 and 128, MHA, ragged
     tails, and rows that see no key (out 0 and lse 0 exactly). At head_dim
     256 (check_d256, on a generator of its own so that every check
     above keeps its inputs): the forward on gemma-7b's packed burst row
     [1, 2048, 16, 256] and lone row [1, 512, 16, 256], gemma-2b's packed
     row (8 q heads on 1 kv head), a ragged non-causal row and two
     windowed rows; the four paged kernels at gemma-7b's decode shapes
     (q [8, 16, 256] or [8, 4, 16, 256], pools [257, 16, 64, 256]) and
     gemma-2b's (pools [257, 1, 64, 256]; T = 4 gives 32 query rows a kv
     head), bf16 and int8; and the backward at head_dim 256
     (BWD_CASES_D256, on a generator of its own, both modes as above):
     gemma-2b's sft shape [4, 2048, 8, 256] with 1 kv head, gemma-7b's
     MHA row [1, 2048, 16, 256], a packed row with segment boundaries
     inside key tiles, a ragged S of 200, windows 100 (causal) and 65
     (not); and the forward as redesigned for Hopper (FWD_CASES, on a
     generator of its own): the two training shapes, batch > 1 with
     ragged tails, packed rows whose segments cross the 128-row q tiles,
     a window below one key tile at head_dim 256, Sq > Sk with rows that
     see no key and Sq < Sk, each also bit-equal across two calls; and
     the paged kernel (all four wrappers: one kernel for T = 1 and the
     verify step, its merge inside the launch) on cases of its own
     (check_verify, on a generator of its own; bf16 and int8 pools):
     VERIFY_CASES, query rows a kv head R = 2 (T = 2, G = 1), 24 (T = 3,
     G = 8), 48 at head_dim 256 and 256 (two row groups), page sizes 8,
     16, 32, 80 and 128 beside 64 (128 also at head_dim 256 with 32 rows;
     80 at head_dim 256), head_dim 64; DECODE_CASES, T = 1 at pages 8,
     10, 24, 80, 128 and 64, head dims 64, 128 and 256, G = 1, 4 and 8;
     each case's slots hold a length-0 slot (its other splits see no
     visible page), T tokens straddling a page boundary, an unreserved
     gap inside a slot's span, a long slot, a freed slot with a stale
     length; the kernel's own count of a block's shared memory must
     equal verify_plan's. Every paged case here and above is called
     REPEATS (20) times and must give bit-equal outputs (the merge's
     fixed order);
  3. llama3-8b at full width (random weights from a seed) served through
     build_engine -> InferenceEngine.submit/generate on the paged cache:
     a burst of mixed-length prompts submitted before start() (packed
     ragged prefill, one request sampled), then a lone request (single
     prefill). Every request must return its tokens, the path's kernels'
     launch counters (set to 0 just before, read just after) must rise,
     and one prefill's last-token logits must match the same model run
     with the plain attention (check_logits). Every engine here runs
     with prefix caching on (the default) and distinct random prompts:
     no request hits a published page (asserted in serve), so each phase
     keeps the uncached path it drove. Then the same model object
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
     move an adapter slot's step logits (an id-0 slot's not at all).
     On the same llama3-8b weights, a spec engine at 24-token pages
     (run_odd_pages: the verify kernel launches, every request returns
     its tokens) and step checks at pages 24 (verify), 8 and 80 (int8
     decode), then the greedy-agreement check (check_agreement): decode
     and verify steps with the output head scaled by 1, 3 and 10, argmax
     through the kernels, their plain versions and the plain attention
     in f32, logged with the f32 step's top-2 margins.
     Then the prefix paths on the same weights (run_prefix; page 64, 8
     slots of 2048): a 1536-token shared prefix (24 pages) + 128 tokens
     is a miss (one flash prefill, 32 launches), then a burst of 3
     requests with the prefix and 64/180/300-token suffixes: 72 hit
     pages, the paged kernel launched, each hit's first-token logits (as
     the engine computed them over the shared pages) within
     LOGIT_REL_L2 of the plain full forward; TTFT of the miss and the
     hits; the same on int8 pools (paged_decode_q). prefill_chunk=512
     on a 1900-token prompt while a 256-token request decodes: >= 3
     chunks, the other request's tokens arriving between chunks, the
     final chunk's logits within LOGIT_REL_L2. SKYT_KV_TIER=host on a
     20-page pool: a 1040-token prompt's 16 pages evicted by a request
     that reserves the pool (cancelled after its first token), spilled,
     promoted on the rerun (a prefix hit), every page bit-equal to the
     bytes the prefill wrote and to the bytes spilled; spill and
     promotion times.
     Then the HTTP front door on the same weights (run_http; the
     engine's settings as run_prefix's, the client http.client only):
     the port's server in process on an ephemeral port; 8 concurrent
     /generate requests of distinct prompts (64-1024 tokens) all 200
     with their tokens, the flash and paged counters (set to 0 just
     before, read just after) risen; a lone 64-token request over HTTP
     gives eng.generate's tokens, its first logprob (/v1/completions)
     within 5e-2 of the log-softmax of plain_last_logits; a stream
     gives the whole response's tokens (client TTFT to the first
     ndjson line and the engine's TTFT of the same request printed);
     presence_penalty=1e9 makes 32 distinct tokens, logit_bias
     {t: 100} every token t, X-Request-Deadline 0.2 s on max_tokens
     2048 ends early and skyt_infer_deadline_expired_total rises; ms
     per decode step with 8 greedy slots, then with logprobs,
     penalties or bias on one slot, then greedy again; the OpenAI
     routes' SSE ends in [DONE]; then `python -m
     skypilot_tpu_torch.infer.server --model llama3-8b --num-slots 8`
     as a subprocess answers /health and one /generate and exits 0 on
     SIGTERM. Its results print as one {"http": {...}} line before the
     kernels line.
     Then HF checkpoints on the same weights (run_checkpoint): the model
     written by weights.save_hf_checkpoint to a temporary directory
     (bytes, seconds; fewer layers at full width only if the disk cannot
     hold 32, logged), with a tokenizer.json when `tokenizers` is there;
     build_engine(checkpoint=) in bf16: a 512-token prompt's last logits
     bit-equal to the in-memory model's and the same greedy stream; with
     quantize int8 and int4: codes made on the card byte-equal to the
     CPU quantizer's (layers.0.attn.wq, lm_head) and to the loaded
     engine's, last logits within LOGIT_REL_L2 of plain_last_logits of
     the quantized model (check_logits), rel L2 against bf16 printed;
     for each mode the load's seconds, peak and resident memory, ms per
     token at 8 slots and at 4 slots with spec_decode=4, the flash and
     paged counters (set to 0 just before, read just after) risen; then
     the example's command line (examples/llama_8b_int8_serve.yaml:
     --checkpoint --num-slots 4 --max-seq-len 2048 --quantize int8
     --spec-decode 4) as a subprocess: /health, /v1/models naming the
     directory, /generate, SIGTERM -> 0. A {"checkpoint": {...}} line
     before the kernels line.
     Then mistral-7b (sliding window 4096 on every layer) at full width,
     build_engine('mistral-7b', max_seq_len=8192, num_slots=4): a burst
     of a 6000- and a 2000-token prompt (one sampled) packed into one
     [1, 8192] ragged row, then a lone 4600-token prompt, 32 tokens
     each; the flash forward must launch 32 times per prefill, the paged
     kernels never (windowed layers decode through the gather view, as
     in the JAX package); the 6000-token prompt's last-token logits must
     match the plain attention, and the window must move them at least
     4x as far as the kernel's rounding does; TTFT and ms per token.
     Then Gemma (run_gemma): gemma-7b at full width (build_engine, random
     bf16 weights from the seed, llama3-8b's engine settings and
     traffic) through four engines on one model, bf16, int8 KV,
     spec_decode=3 and both, and gemma-2b with spec_decode=3, whose
     verify steps run paged_decode_mq at 32 query rows a kv head (the
     counter by rows shows it); every request returns its tokens, each
     path's kernels launch, and prefill and step logits match the plain
     path within LOGIT_REL_L2; then the head_dim-256 timings (time_d256);
  4. kernel timings (the kernels line's flash_fwd, paged_decode and
     paged_decode_q entries also carry prefix_launches, the prefix
     phase's launches by part): device time per call from CUDA events around a
     replayed CUDA graph of many calls (eager_ms: the same with Python's
     launch overhead), for the kernel, its plain version and one PyTorch
     library call where one computes the same function (for the paged
     kernel also its device ms per call from torch.profiler's kernel
     records: one launch a call); and the bound
     (the larger of bytes / 3.35 TB/s and flops / 989 TFLOP/s, counted
     from this run's inputs);
  3'. training, after the serving engines: sft.main on llama3-1b at
     its defaults (8 x 2048, f32 masters, bf16 compute, remat) for 6
     steps, the flash counters set to 0 just before and read just after
     (32 forward launches and 16 backward launches per step), every loss
     finite and the first logged one within 1.5 of ln 128256; step time,
     tokens/s, MFU and peak memory printed. Then a grad check (one
     1 x 2048 step through the kernels against attn_impl='xla': rel L2
     of the flattened gradient <= 5e-2, losses within 1e-2) and a
     checkpoint save/restore round trip on a small bf16 config at
     sequence 128, and at 512 (where each dq element takes up to eight
     adds, one per key tile) with deterministic algorithms on (resumed
     equal to unbroken, asserted) and off (logged). sft.main runs with
     deterministic algorithms on: on llama3-1b at 2 x 2048 a 4-step run
     preempted (SIGTERM) after step 2, exit 75, and resumed to step 4
     must equal an unbroken 4-step run bit for bit (asserted), and the
     caller's setting must be back after each sft.main; the sft step's
     cost of the ordered adds (on, off, on, off in one process); a grad
     check through two full-width mistral-7b layers (window 4096) at
     1 x 6144 against attn_impl='xla' (rel L2 <= 5e-2, losses within
     1e-2, the backward kernel launched once per layer); sft.main on
     gemma-2b at full width at the largest of batch 8, 4 and 2 x 2048
     that fits (a batch that does not runs out of memory in its first
     step, in the loss's f32 logits over vocab 256000), 6 steps: 36
     forward and 18 backward launches a step, finite losses, the first logged within
     1.5 of ln 256000; a grad check through two full-width gemma-7b
     layers (head_dim 256, MHA) at 1 x 2048, as Mistral's;
  4'. the windowed forward and backward kernels at [1, 8192, 32, 128]
     with window 4096 against themselves without the window, their plain
     versions and SDPA with a boolean band mask (its backend logged);
     the backward kernel (and the forward) timed at the sft shape
     [8, 2048, 32, 64] causal against the plain backward and SDPA, with
     its adds ordered too, and the backward kernel at head_dim 128 and on
     packed rows; the same at head_dim 256 on gemma-2b's sft shape
     [4, 2048, 8, 256] (1 kv head) and gemma-7b's [1, 2048, 16, 256];
     then the {"http": {...}} line, the {"checkpoint": {...}} line and
     the {"kernels": [...]} line (all nine kernels, the windowed forward
     and backward, and the head_dim-256 entries *_gemma7b and *_gemma2b;
     flash_fwd and paged_decode carry http_launches, and with
     paged_decode_mq ckpt_launches);
  5. last line: {"ok": true, "device": {...}}.

It imports nothing of JAX and nothing of the JAX package.
"""
import argparse
import contextlib
import functools
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


def device_ms_by_kernel(fn, names, iters: int = 20):
    """Device ms per fn() call of each kernel whose name holds one of
    `names` (one call may launch several kernels), from torch.profiler's
    kernel records over `iters` eager calls; None for a name the
    profiler recorded no device time for."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = dict.fromkeys(names, 0.0)
    for e in prof.key_averages():
        for name in names:
            if name in e.key:
                us[name] += e.self_device_time_total
    return {name: us[name] / 1e3 / iters if us[name] > 0 else None
            for name in names}


def parts_text(t) -> str:
    """A paged timing's kernel device ms from the profiler."""
    if 'profiler_ms' not in t:
        return ''
    ms = t['profiler_ms']
    return '; kernel ' + (f'{ms:.4f} ms' if ms is not None else
                          'not measured') + ' (profiler, per call)'


def max_abs(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


# Calls of a paged kernel on the same inputs that must give bit-equal
# outputs: its split partials are merged in a fixed order inside the
# launch, whichever block ends last.
REPEATS = 20


def repeat_equal(fn, args, out, n=REPEATS) -> bool:
    """Whether n - 1 more fn(*args) calls each equal `out` bit for bit."""
    import torch
    return all(torch.equal(fn(*args), out) for _ in range(n - 1))


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


def check_flash(gen, cases=None):
    """The slice's shapes (a packed row of the engine's 4-segment layout,
    an unpacked causal row), then head_dim 64 with GQA 8/2, a ragged
    tail and non-causal rows for the kernel's other variants; or the
    given cases (name, S, segment ids, shape, causal)."""
    import torch
    from skypilot_tpu_torch.ops import flash_attention as fa
    res = {}
    seg = torch.as_tensor(packed_segments(BURST, 64, 2048), device='cuda')
    seg_small = torch.as_tensor(packed_segments((50, 3, 70, 33), 16, 200),
                                device='cuda')
    cases = cases or (
        ('packed', 2048, seg, {}, True),
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


# Kernel 1 with the sliding window: (name, Sq, Sk, Hq, Hkv, D, causal,
# segment lengths or None, window). Mistral's shapes (a 6144-token causal
# row and the engine's packed [1, 8192] row of a 6000- and a 2000-token
# prompt with id-0 padding, window 4096), then windows of 1, 7, 63, 65
# and 100 (below a tile, not a multiple of 64), one at least S (equal to
# no window), non-causal rows (a one-sided band), head_dim 64 and 128,
# MHA, ragged tails, segments longer than the window, and Sq > Sk +
# window, where the last rows see no key (out 0 and lse 0 exactly).
MISTRAL_BURST = (6000, 2000)
FWD_WINDOW_CASES = (
    ('mistral_causal', 6144, 6144, 32, 8, 128, True, None, 4096),
    ('mistral_packed', 8192, 8192, 32, 8, 128, True, MISTRAL_BURST, 4096),
    ('w1', 200, 200, 8, 2, 64, True, None, 1),
    ('w7_packed', 200, 200, 8, 2, 64, True, (50, 3, 70, 33), 7),
    ('w63', 300, 300, 8, 2, 128, True, None, 63),
    ('w65_mha', 300, 300, 8, 8, 64, True, None, 65),
    ('w100_noncausal_d64', 300, 300, 8, 2, 64, False, None, 100),
    ('w100_noncausal_packed_d128', 200, 200, 8, 2, 128, False, (90, 50),
     100),
    ('w_at_s', 200, 200, 8, 2, 128, True, None, 200),
    ('unseen_rows', 300, 200, 8, 2, 64, False, None, 50),
)


def seen_rows(sq, sk, causal, seg, window):
    """[B or 1, Sq] bool: query rows that see at least one key."""
    import torch
    qp = torch.arange(sq, device='cuda')[:, None]
    kp = torch.arange(sk, device='cuda')[None, :]
    m = torch.ones((sq, sk), dtype=torch.bool, device='cuda')
    if causal:
        m &= kp <= qp
    if window > 0:
        m &= qp - kp < window
    m = m[None]
    if seg is not None:
        m = m & (seg[:, :, None] == seg[:, None, :])
    return m.any(-1)


def check_flash_window(gen, cases=FWD_WINDOW_CASES):
    """Kernel 1 with the window (FWD_WINDOW_CASES) against its plain
    version on the same inputs: out and lse within atol = rtol = 2e-2;
    rows that see no key give out 0 and lse 0 exactly; a window of S
    gives the unwindowed kernel's bits."""
    import torch
    from skypilot_tpu_torch.ops import flash_attention as fa
    res = {}
    for name, sq, sk, hq, hkv, d, causal, lengths, window in cases:
        q = torch.randn((1, sq, hq, d), generator=gen, device='cuda',
                        dtype=torch.bfloat16)
        k, v = (torch.randn((1, sk, hkv, d), generator=gen, device='cuda',
                            dtype=torch.bfloat16) for _ in range(2))
        seg = None
        if lengths is not None:
            page = 64 if sq >= 2048 else 16
            seg = torch.as_tensor(packed_segments(lengths, page, sq),
                                  device='cuda')
        out, lse = fa.flash_attention_fwd_lse(q, k, v, causal=causal,
                                              segment_ids=seg, window=window)
        ref, ref_lse = fa.flash_attention_reference(
            q, k, v, causal=causal, segment_ids=seg, window=window)
        torch.cuda.synchronize()
        assert torch.isfinite(out.float()).all(), f'flash {name}: non-finite'
        torch.testing.assert_close(out.float(), ref.float(), **TOL)
        torch.testing.assert_close(lse, ref_lse, **TOL)
        unseen = ~seen_rows(sq, sk, causal, seg, window)
        n_unseen = int(unseen.sum())
        if n_unseen:
            assert not out[unseen].any(), f'{name}: unseen rows not 0'
            assert not lse.transpose(1, 2)[unseen].any(), \
                f'{name}: unseen rows lse not 0'
        same_as_unwindowed = None
        if window >= sq:
            plain = fa.flash_attention_fwd_lse(q, k, v, causal=causal,
                                               segment_ids=seg)
            same_as_unwindowed = bool(torch.equal(out, plain[0]) and
                                      torch.equal(lse, plain[1]))
            assert same_as_unwindowed, f'{name}: window >= S differs'
        err = max(max_abs(out, ref), max_abs(lse, ref_lse))
        res[name] = {'shape': list(q.shape), 'kv_shape': list(k.shape),
                     'causal': causal, 'segments': lengths,
                     'window': window, 'max_abs_err': err,
                     'rows_seeing_nothing': n_unseen,
                     'same_as_unwindowed': same_as_unwindowed}
        _log(f'flash window {window} {name} q {list(q.shape)} k '
             f'{list(k.shape)} causal {causal} segments {lengths}: '
             f'max|out-ref| {max_abs(out, ref):.3e}, max|lse-ref| '
             f'{max_abs(lse, ref_lse):.3e} (atol=rtol=2e-2); rows seeing '
             f'no key {n_unseen} (exact 0s)'
             + ('' if same_as_unwindowed is None else
                f'; bit-equal to no window {same_as_unwindowed}'))
        del q, k, v, out, lse, ref, ref_lse
        torch.cuda.empty_cache()
    return res


# Kernel 1 as redesigned for Hopper (128-row q tiles, two consumer
# warpgroups of 64 rows, 128-key tiles up to head_dim 128, 64-key tiles at
# 256): (name, B, Sq, Sk, Hq, Hkv, D, causal, segment lengths per row or
# None, window). The two training shapes (llama3-1b's GQA and gemma-2b's
# MQA), batch > 1 with ragged tails (S = 200 and 130, not multiples of
# 128 or of a key tile), packed rows whose segments (on 1-token pages,
# different in each row) cross the 128-row tile edges, a window below one
# 64-key tile at head_dim 256 (causal and not), Sq > Sk non-causal with a
# window (the last rows see no key: out 0 and lse 0 exactly) and without,
# and Sq < Sk causal.
FWD_CASES = (
    ('llama3_1b_train', 8, 2048, 2048, 32, 8, 64, True, None, 0),
    ('gemma2b_train', 4, 2048, 2048, 8, 1, 256, True, None, 0),
    ('ragged_s200_b2_d64', 2, 200, 200, 8, 2, 64, True, None, 0),
    ('ragged_s130_b3_d128', 3, 130, 130, 8, 2, 128, True, None, 0),
    ('ragged_s200_b2_d256_noncausal', 2, 200, 200, 8, 1, 256, False, None,
     0),
    ('packed_b2_d64', 2, 1024, 1024, 8, 2, 64, True,
     ((100, 150, 300, 77), (500, 27, 260)), 0),
    ('packed_b2_d128_noncausal', 2, 700, 700, 8, 2, 128, False,
     ((130, 250, 129), (64, 300, 200)), 0),
    ('packed_b2_d256', 2, 640, 640, 8, 1, 256, True,
     ((100, 150, 300), (64, 64, 200, 129)), 0),
    ('packed_window_d128', 1, 1000, 1000, 8, 2, 128, True,
     ((130, 250, 129, 300),), 100),
    ('window40_d256', 1, 300, 300, 8, 1, 256, True, None, 40),
    ('window40_b2_d256_noncausal', 2, 300, 300, 8, 2, 256, False, None, 40),
    ('sq_gt_sk_window_unseen', 2, 300, 130, 8, 2, 128, False, None, 60),
    ('sq_gt_sk_d64', 1, 300, 200, 8, 2, 64, False, None, 0),
    ('sq_lt_sk_causal_d256', 1, 130, 300, 8, 2, 256, True, None, 0),
)


def check_fwd(gen, cases=FWD_CASES):
    """Kernel 1 on FWD_CASES against its plain version on the same
    inputs: out and lse within atol = rtol = 2e-2, rows that see no key
    give out 0 and lse 0 exactly, and a second call gives the same bits
    (each block owns its rows' whole key range: no atomics). gen is their
    own generator, so the earlier checks keep their inputs."""
    import numpy as np
    import torch
    from skypilot_tpu_torch.ops import flash_attention as fa
    res = {}
    for name, b, sq, sk, hq, hkv, d, causal, rows, window in cases:
        q = torch.randn((b, sq, hq, d), generator=gen, device='cuda',
                        dtype=torch.bfloat16)
        k, v = (torch.randn((b, sk, hkv, d), generator=gen, device='cuda',
                            dtype=torch.bfloat16) for _ in range(2))
        seg = None if rows is None else torch.as_tensor(np.concatenate(
            [packed_segments(r, 1, sq) for r in rows]), device='cuda')
        out, lse = fa.flash_attention_fwd_lse(q, k, v, causal=causal,
                                              segment_ids=seg, window=window)
        again = fa.flash_attention_fwd_lse(q, k, v, causal=causal,
                                           segment_ids=seg, window=window)
        ref, ref_lse = fa.flash_attention_reference(
            q, k, v, causal=causal, segment_ids=seg, window=window)
        torch.cuda.synchronize()
        assert torch.isfinite(out.float()).all(), f'flash {name}: non-finite'
        torch.testing.assert_close(out.float(), ref.float(), **TOL)
        torch.testing.assert_close(lse, ref_lse, **TOL)
        same = bool(torch.equal(out, again[0]) and torch.equal(lse, again[1]))
        assert same, f'flash {name}: two calls differ'
        unseen = ~seen_rows(sq, sk, causal, seg, window).expand(b, sq)
        n_unseen = int(unseen.sum())
        if n_unseen:
            assert not out[unseen].any(), f'{name}: unseen rows not 0'
            assert not lse.transpose(1, 2)[unseen].any(), \
                f'{name}: unseen rows lse not 0'
        err = max(max_abs(out, ref), max_abs(lse, ref_lse))
        res[name] = {'shape': list(q.shape), 'kv_shape': list(k.shape),
                     'causal': causal, 'segments': rows, 'window': window,
                     'max_abs_err': err, 'rows_seeing_nothing': n_unseen,
                     'bit_equal_across_calls': same}
        _log(f'flash fwd {name} q {list(q.shape)} k {list(k.shape)} causal '
             f'{causal} segments {rows} window {window}: max|out-ref| '
             f'{max_abs(out, ref):.3e}, max|lse-ref| '
             f'{max_abs(lse, ref_lse):.3e} (atol=rtol=2e-2); rows seeing no '
             f'key {n_unseen} (exact 0s); bit-equal across calls {same}')
        del q, k, v, out, lse, again, ref, ref_lse
        torch.cuda.empty_cache()
    return res


# Kernels 8-9 cases: (name, B, S, Hq, Hkv, D, causal, segments, window).
# The sft shape at batch 1 (llama3-1b: 32 q and 8 kv heads, head_dim
# 64), a packed row, head_dim 128, non-causal rows, ragged tails and
# batch 2, MHA (Hkv == Hq), and a packed row on 16-token pages whose
# segment boundaries (100, 112, 149, 160, ...) fall inside the kernel's
# 64-key tiles and off their edges; then the sliding window: Mistral's
# 6144-token row (window 4096), the packed sft row with segments longer
# than its window, windows below a tile and not multiples of 64, causal
# and not.
BWD_CASES = (
    ('sft_causal', 1, 2048, 32, 8, 64, True, None, 0),
    ('sft_packed', 1, 2048, 32, 8, 64, True, BURST, 0),
    ('d128_causal', 1, 512, 32, 8, 128, True, None, 0),
    ('noncausal', 1, 2048, 32, 8, 64, False, None, 0),
    ('d64_ragged_packed', 2, 200, 8, 2, 64, True, (50, 3, 70, 33), 0),
    ('d128_ragged_noncausal', 2, 200, 8, 2, 128, False, (90, 50), 0),
    ('mha_causal', 2, 1024, 16, 16, 64, True, None, 0),
    ('packed_mid_tile', 1, 1024, 32, 8, 64, True, (100, 37, 250, 300), 0),
    ('mistral_window', 1, 6144, 32, 8, 128, True, None, 4096),
    ('sft_packed_window', 1, 2048, 32, 8, 64, True, BURST, 300),
    ('d64_window7', 2, 200, 8, 2, 64, True, None, 7),
    ('d128_noncausal_window100', 2, 300, 8, 2, 128, False, None, 100),
    ('packed_mid_tile_window65', 1, 1024, 32, 8, 64, True,
     (100, 37, 250, 300), 65),
)
# Head_dim 256, Gemma training (checked on a generator of its own, after
# check_d256, so that every check above keeps its inputs): gemma-2b's sft
# shape [4, 2048, 8 q / 1 kv heads], gemma-7b's MHA row [1, 2048, 16 /
# 16], a packed row whose segments end inside 64-key tiles, a ragged S of
# 200, windows that are not multiples of 64, causal and not.
BWD_CASES_D256 = (
    ('gemma2b_sft', 4, 2048, 8, 1, 256, True, None, 0),
    ('gemma7b_causal', 1, 2048, 16, 16, 256, True, None, 0),
    ('d256_packed_mid_tile', 1, 1024, 8, 1, 256, True, (100, 37, 250, 300),
     0),
    ('d256_ragged_noncausal', 2, 200, 8, 2, 256, False, None, 0),
    ('d256_window100', 1, 600, 8, 1, 256, True, None, 100),
    ('d256_noncausal_window65', 2, 300, 4, 2, 256, False, None, 65),
)


def bwd_inputs(gen, case):
    """(q, k, v, out, lse, do, seg) on the card for one BWD_CASES entry:
    out and lse from the forward kernel, do ~ N(0, 1)."""
    import torch
    from skypilot_tpu_torch.ops import flash_attention as fa
    _, b, s, hq, hkv, d, causal, lengths, window = case
    q = torch.randn((b, s, hq, d), generator=gen, device='cuda',
                    dtype=torch.bfloat16)
    k = torch.randn((b, s, hkv, d), generator=gen, device='cuda',
                    dtype=torch.bfloat16)
    v = torch.randn((b, s, hkv, d), generator=gen, device='cuda',
                    dtype=torch.bfloat16)
    seg = None
    if lengths is not None:
        page = 64 if s >= 2048 else 16
        seg = torch.as_tensor(packed_segments(lengths, page, s),
                              device='cuda').expand(b, s).contiguous()
    out, lse = fa.flash_attention_fwd_lse(q, k, v, causal=causal,
                                          segment_ids=seg, window=window)
    do = torch.randn(out.shape, generator=gen, device='cuda',
                     dtype=torch.bfloat16)
    return q, k, v, out, lse, do, seg


@contextlib.contextmanager
def deterministic_algorithms(on=True):
    """torch.use_deterministic_algorithms(on) inside the block (warn only,
    for the other ops of a training step) with the fill of uninitialized
    memory off, as sft.main runs; restored after it."""
    import torch
    was = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled(),
           torch.utils.deterministic.fill_uninitialized_memory)
    torch.use_deterministic_algorithms(on, warn_only=True)
    torch.utils.deterministic.fill_uninitialized_memory = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was[0], warn_only=was[1])
        torch.utils.deterministic.fill_uninitialized_memory = was[2]


def check_flash_bwd(gen, cases=BWD_CASES):
    """Kernels 8-9 (flash_attention_bwd on CUDA tensors: one backward
    kernel) against the plain backward on the same inputs (cases):
    dq, dk and dv within atol = rtol = 2e-2, and dk and dv of a second
    call on the same inputs bit-equal to the first (dq's bit-equality is
    logged). Then the same with deterministic algorithms on (the
    kernel's ordered adds; a wrong wait range there would hang, not
    err): dq bit-equal too."""
    import torch
    from skypilot_tpu_torch.ops import flash_attention as fa
    res = {}
    for case in cases:
        name, causal, window = case[0], case[6], case[8]
        q, k, v, out, lse, do, seg = bwd_inputs(gen, case)
        ref = fa.flash_attention_bwd_reference(q, k, v, out, lse, do,
                                               causal=causal,
                                               segment_ids=seg,
                                               window=window)
        for ordered in (False, True):
            with deterministic_algorithms(ordered):
                got = fa.flash_attention_bwd(q, k, v, out, lse, do,
                                             causal=causal, segment_ids=seg,
                                             window=window)
                again = fa.flash_attention_bwd(q, k, v, out, lse, do,
                                               causal=causal,
                                               segment_ids=seg,
                                               window=window)
            torch.cuda.synchronize()
            same = {g: bool(torch.equal(a, b2))
                    for g, a, b2 in zip(('dq', 'dk', 'dv'), got, again)}
            errs = {}
            for gname, g, r in zip(('dq', 'dk', 'dv'), got, ref):
                assert g.shape == r.shape, (name, gname, g.shape, r.shape)
                assert torch.isfinite(g.float()).all(), \
                    f'flash bwd {name} {gname}: non-finite'
                torch.testing.assert_close(g.float(), r.float(), **TOL)
                errs[gname] = max_abs(g, r)
                errs[gname + '_ref_max'] = float(r.float().abs().max())
            key = name + ('_ordered' if ordered else '')
            res[key] = {'shape': list(q.shape), 'kv_heads': k.shape[2],
                        'causal': causal, 'segments': seg is not None,
                        'window': window, 'ordered': ordered,
                        'max_abs_err': max(errs['dq'], errs['dk'],
                                           errs['dv']),
                        'max_abs_err_dq': errs['dq'],
                        'max_abs_err_dkv': max(errs['dk'], errs['dv']),
                        'bit_equal_second_call': same, **errs}
            _log(f'flash bwd {name} q {list(q.shape)} kv heads '
                 f'{k.shape[2]} causal {causal} segments {seg is not None} '
                 f'window {window} ordered adds {ordered}: max|d-ref| '
                 + ', '.join(f'{g} {errs[g]:.3e} (max|ref| '
                             f'{errs[g + "_ref_max"]:.2e})'
                             for g in ('dq', 'dk', 'dv'))
                 + ' (atol=rtol=2e-2); second call bit-equal: '
                 + ', '.join(f'{g} {same[g]}' for g in ('dq', 'dk', 'dv')))
            assert same['dk'] and same['dv'], (key, same)
            assert same['dq'] or not ordered, (key, same)
        del q, k, v, out, lse, do, seg, ref, got, again
        torch.cuda.empty_cache()
    return res


# Paged decode shapes (query heads, kv heads, head_dim) of the served
# models: llama3-8b (the slice's), gemma-7b, and gemma-2b, whose 8 query
# heads share 1 kv head (the verify step's T = 4 makes 32 query rows).
PAGED_SHAPES = {'slice': (32, 8, 128), 'gemma7b': (16, 16, 256),
                'gemma2b': (8, 1, 256)}


def paged_inputs(gen, t=1, quant=False, shape='slice'):
    """Decode shapes of PAGED_SHAPES[shape]: at the slice's, q
    [8, 32, 128] (t == 1) or [8, t, 32, 128], pools [257, 8, 64, 128] —
    bf16, or int8 from quantize_kv of bf16 data with f32 scales
    [257, 8, 64]; slots of mixed lengths (0 included, the longest run
    ending at position 2047) and a freed slot (all-zero row, stale
    length). Returns (q, k_pool, v_pool, tables, lengths), or with quant
    (q, k_pool, v_pool, k_scale, v_scale, tables, lengths)."""
    import numpy as np
    import torch
    from skypilot_tpu_torch.infer import paged_cache
    hq, hkv, d = PAGED_SHAPES[shape]
    slots, page, n_pages, mp = 8, 64, 257, 32
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
        same = repeat_equal(pa.paged_decode_attention, a, out)
        ref = pa.paged_decode_attention_reference(*a)
        torch.cuda.synchronize()
        assert torch.isfinite(out.float()).all(), f'paged {name}: non-finite'
        torch.testing.assert_close(out.float(), ref.float(), **TOL)
        assert same, f'paged {name}: calls differ'
        err = max_abs(out, ref)
        _log(f'paged {name} {list(a[0].shape)} pools {list(a[1].shape)}: '
             f'max|out-ref| {err:.3e} (atol=rtol=2e-2); {REPEATS} calls '
             'bit-equal')
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


# Kernel 2 and kernels 3-5.
PAGED_KERNELS = {'paged_decode': ('paged_decode_attention', 1, False,
                                  'skypilot_tpu/ops/paged_attention.py:50 '
                                  '_kernel'), **FAMILY}


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
            same = repeat_equal(wrapper, a, out)
            ref = plain(*a)
            torch.cuda.synchronize()
            assert torch.isfinite(out.float()).all(), \
                f'{kname} {name}: non-finite'
            torch.testing.assert_close(out.float(), ref.float(), **TOL)
            assert same, f'{kname} {name}: calls differ'
            err = max_abs(out, ref)
            _log(f'{kname} {name} q {list(a[0].shape)} pools '
                 f'{list(a[1].shape)} {a[1].dtype}: max|out-ref| {err:.3e} '
                 f'(atol=rtol=2e-2); {REPEATS} calls bit-equal')
            res.setdefault(kname, {})[name] = {'shape': list(a[0].shape),
                                               'max_abs_err': err}
    return res


# The paged kernel's own cases (check_verify, on a generator of its
# own): (name, T, Hq, Hkv, d, page size). Verify steps (VERIFY_CASES):
# query rows a kv head R = T*G not a multiple of 16 (2, 24), 48 at
# head_dim 256 (three m-tiles), 256 (two row groups); page sizes 16, 32
# and 128 beside 64 (128: two ring tiles a page), 8 (a 16-row box, 8 rows
# past the page) and 80 (a 64-row tile and a 16-row last box). Decode
# steps (DECODE_CASES, T = 1): pages 8, 24, 80, 128 and 10 (P % 4 != 0:
# the int8 scales read where used, not copied into the ring) beside 64,
# head dims 64, 128 and 256, G = 1, 4 and 8 query rows a kv head. Every
# case's slots (verify_lengths, in pages P): length 0 (its other splits
# see no visible page), T tokens straddling the first page boundary, a
# slot with an unreserved gap at page 1 inside its span, a long slot, a
# freed slot (all-zero row, stale length), a slot one short of a page.
VERIFY_CASES = (
    ('r2_t2_g1', 2, 8, 8, 128, 64),
    ('r24_t3_g8', 3, 16, 2, 128, 64),
    ('r48_d256', 6, 16, 2, 256, 64),
    ('p16', 4, 32, 8, 128, 16),
    ('p128', 4, 32, 8, 128, 128),
    ('p128_d256_r32', 4, 8, 1, 256, 128),
    ('d64_p32', 2, 16, 2, 64, 32),
    ('r256_two_groups', 8, 32, 1, 64, 64),
    ('p8', 4, 32, 8, 128, 8),
    ('p80_d256', 4, 16, 2, 256, 80),
)
DECODE_CASES = (
    ('t1_p8_g4_d128', 1, 32, 8, 128, 8),
    ('t1_p24_g1_d256', 1, 16, 16, 256, 24),
    ('t1_p80_g8_d64', 1, 16, 2, 64, 80),
    ('t1_p128_g4_d256', 1, 16, 4, 256, 128),
    ('t1_p24_g8_d128', 1, 8, 1, 128, 24),
    ('t1_p80_g1_d128', 1, 8, 8, 128, 80),
    ('t1_p10_g4_d64', 1, 16, 4, 64, 10),
    ('t1_p64_g8_d256', 1, 8, 1, 256, 64),
)


def verify_lengths(page):
    """VERIFY_CASES' slots: (lengths, freed slot, gap (slot, page))."""
    return [0, page - 1, 3 * page + 5, 10 * page + 7, 999, page - 1], 4, \
        (2, 1)


def verify_inputs(gen, t, hq, hkv, d, page, quant):
    """q [6, t, hq, d] and pools for VERIFY_CASES' slots: tables from a
    seeded numpy permutation, data from gen; int8 pools from quantize_kv
    with their f32 scales."""
    import numpy as np
    import torch
    from skypilot_tpu_torch.infer import paged_cache
    lengths, freed, (gs, gj) = verify_lengths(page)
    slots = len(lengths)
    need = [0 if s == freed else -(-(n + t) // page)
            for s, n in enumerate(lengths)]
    mp = max(need) + 1
    n_pages = sum(need) + 1
    perm = np.random.default_rng(SEED + 45).permutation(
        np.arange(1, n_pages))
    tables = np.zeros((slots, mp), np.int32)
    nxt = 0
    for s, n in enumerate(need):
        tables[s, :n] = perm[nxt:nxt + n]
        nxt += n
    tables[gs, gj] = 0
    q = torch.randn((slots, t, hq, d), generator=gen, device='cuda',
                    dtype=torch.bfloat16)
    pools = [torch.randn((n_pages, hkv, page, d), generator=gen,
                         device='cuda', dtype=torch.bfloat16)
             for _ in range(2)]
    rest = (torch.as_tensor(tables, device='cuda'),
            torch.as_tensor(np.asarray(lengths, np.int32), device='cuda'))
    if not quant:
        return (q, *pools) + rest
    (kq, ks), (vq, vs) = (paged_cache.quantize_kv(x) for x in pools)
    return (q, kq, vq, ks, vs) + rest


def check_verify(gen, cases=VERIFY_CASES + DECODE_CASES):
    """The paged kernel (paged_decode_attention_mq and _mq_q, or at T = 1
    paged_decode_attention and _q) against its plain versions on
    VERIFY_CASES and DECODE_CASES, bf16 and int8, within TOL, REPEATS
    calls bit-equal; each call's plan (verify_plan) and the kernel's own
    shared-memory count agree. gen is their own generator."""
    import torch
    from skypilot_tpu_torch.ops import _build
    from skypilot_tpu_torch.ops import paged_attention as pa
    lib = _build.load('paged_decode')
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    res = {}
    for name, t, hq, hkv, d, page in cases:
        for quant in (False, True):
            fn = 'paged_decode_attention' + ('_mq' if t > 1 else '') + \
                ('_q' if quant else '')
            a = verify_inputs(gen, t, hq, hkv, d, page, quant)
            if t == 1:
                a = (a[0][:, 0],) + a[1:]
            plan = pa.verify_plan(a[0].shape[0], t, hq, hkv, d, page,
                                  a[-2].shape[1], quant, sms)
            smem = lib.skyt_paged_verify_smem(
                d, int(quant), plan.tile_rows, plan.stages, plan.m_tiles,
                plan.key_splits)
            assert smem == plan.smem_bytes, (name, smem, plan)
            out = getattr(pa, fn)(*a)
            same = repeat_equal(getattr(pa, fn), a, out)
            ref = getattr(pa, fn + '_reference')(*a)
            torch.cuda.synchronize()
            label = f'{name}{"_int8" if quant else ""}'
            assert torch.isfinite(out.float()).all(), f'{label}: non-finite'
            torch.testing.assert_close(out.float(), ref.float(), **TOL)
            assert same, f'{label}: calls differ'
            err = max_abs(out, ref)
            _log(f'paged {label} q {list(a[0].shape)} pools '
                 f'{list(a[1].shape)} (R {plan.rows}, m-tiles '
                 f'{plan.m_tiles} x {plan.n_mgroups} groups, '
                 f'{plan.key_splits} key splits, tile {plan.tile_rows} '
                 f'(last {plan.tail_rows}), {plan.stages} stages, grid '
                 f'{list(plan.grid)}, smem {plan.smem_bytes}): max|out-ref| '
                 f'{err:.3e} (atol=rtol=2e-2); {REPEATS} calls bit-equal')
            res[label] = {'shape': list(a[0].shape), 'pools': list(
                a[1].shape), 'plan': plan._asdict(), 'max_abs_err': err}
            del a, out, ref
    torch.cuda.empty_cache()
    return res


# Head_dim 256 (Gemma): windowed forward rows (the D = 256 windowed
# instantiation): a packed row whose segments outlast the window on
# gemma-2b's 8 q / 1 kv heads, and a non-causal band with GQA 4/2.
D256_WINDOW_CASES = (
    ('w100_packed_d256', 300, 300, 8, 1, 256, True, (120, 90, 60), 100),
    ('w50_noncausal_d256', 200, 200, 4, 2, 256, False, None, 50),
)


def check_d256(gen):
    """The kernels at head_dim 256 against their plain versions: the
    flash forward on gemma-7b's packed burst row and lone row (16 q /
    16 kv heads), gemma-2b's packed row (8 q heads on 1 kv head), a
    ragged non-causal row and D256_WINDOW_CASES; the four paged kernels
    at gemma-7b's and gemma-2b's decode shapes (PAGED_SHAPES; T = 4 for
    the verify kernels, 32 query rows a kv head at gemma-2b's). gen is
    their own generator, so the earlier checks keep their inputs."""
    import torch
    from skypilot_tpu_torch.ops import paged_attention as pa
    seg = torch.as_tensor(packed_segments(BURST, 64, 2048), device='cuda')
    res = {'flash': check_flash(gen, (
        ('gemma7b_packed', 2048, seg, dict(hq=16, hkv=16, d=256), True),
        ('gemma7b_lone', 512, None, dict(hq=16, hkv=16, d=256), True),
        ('gemma2b_packed', 2048, seg, dict(hq=8, hkv=1, d=256), True),
        ('d256_full', 200, None, dict(hq=8, hkv=2, d=256), False))),
        'flash_window': check_flash_window(gen, D256_WINDOW_CASES)}
    for kname, (fn, t, quant, _) in PAGED_KERNELS.items():
        for shape in ('gemma7b', 'gemma2b'):
            a = paged_inputs(gen, t, quant, shape)
            out = getattr(pa, fn)(*a)
            same = repeat_equal(getattr(pa, fn), a, out)
            ref = getattr(pa, fn + '_reference')(*a)
            torch.cuda.synchronize()
            assert torch.isfinite(out.float()).all(), \
                f'{kname} {shape}: non-finite'
            torch.testing.assert_close(out.float(), ref.float(), **TOL)
            assert same, f'{kname} {shape}: calls differ'
            err = max_abs(out, ref)
            hq, hkv, _ = PAGED_SHAPES[shape]
            _log(f'{kname} {shape} q {list(a[0].shape)} pools '
                 f'{list(a[1].shape)} {a[1].dtype} ({t * hq // hkv} query '
                 f'rows a kv head): max|out-ref| {err:.3e} '
                 f'(atol=rtol=2e-2); {REPEATS} calls bit-equal')
            res.setdefault(kname, {})[shape] = {
                'shape': list(a[0].shape), 'rows': t * hq // hkv,
                'max_abs_err': err}
            del a, out, ref
    torch.cuda.empty_cache()
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
# kernel's tiles, and ragged token tails; two ranks above 128 (two rank
# tiles: 256 at decode, 200 with a part-filled second tile); and decode on
# a stack of eight adapters of which the batch uses two.
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
    ('gather_decode_r256', 8, 1, 4096, 14336, (256, 16, 8), SLOT_LORA),
    ('grouped_ragged_r200', 2, 23, 100, 37, (200, 5, 12), 'random'),
    ('gather_decode_sparse', 8, 1, 4096, 14336, (16,) * 8,
     (1, 0, 2, 1, 0, 2, 1, 0)),
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
    exact zeros (delta) or exactly y (in place), and REPEATS calls of each
    bit-equal (the shrink's partials are summed in a fixed order); the
    kernel's count of a block's shared memory (skyt_lora_smem) must equal
    lora_plan's."""
    import torch
    from skypilot_tpu_torch.ops import _build
    from skypilot_tpu_torch.ops import lora as lora_ops
    lib = _build.load('lora')
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
        for in_place in (False, True):
            plan = lora_ops.lora_plan(
                x.shape[0] * x.shape[1], x.shape[2], a.shape[-1],
                b.shape[-1], a.shape[0], in_place,
                torch.cuda.get_device_properties(0).multi_processor_count)
            got = lib.skyt_lora_smem(
                plan.tile_rows, plan.rank_width, plan.items_per_pass,
                plan.t_cols, plan.chunk_rows, plan.s_stages, plan.e_stages,
                int(in_place))
            assert got == plan.smem_bytes, \
                f'lora {name}: kernel smem {got} != plan {plan.smem_bytes}'
        assert repeat_equal(lora_ops.grouped_lora_delta,
                            (x, a, b, ids, scale), out), \
            f'lora {name}: delta calls differ'
        assert repeat_equal(
            lambda: lora_ops.add_lora_delta_(y.clone(), x, a, b, ids, scale),
            (), fused), f'lora {name}: in-place calls differ'
        d_err, f_err = max_abs(out, ref), max_abs(fused, fused_ref)
        ref_max = float(ref.float().abs().max())
        kname = 'lora_grouped' if per_token else 'lora_gather'
        _log(f'{kname} {name} x {list(x.shape)} -> {b.shape[-1]}, rank '
             f'{a.shape[-1]}: delta max|out-ref| {d_err:.3e} (max|ref| '
             f'{ref_max:.3e}), in place max|out-(y+ref)| {f_err:.3e} '
             f'(atol=rtol=2e-2); {int(zero.sum())} id-0 rows exact; '
             f'{REPEATS} calls bit-equal')
        res[name] = {'kernel': kname, 'shape': list(x.shape),
                     'out': b.shape[-1], 'max_abs_err': max(d_err, f_err),
                     'delta_err': d_err, 'fused_err': f_err,
                     'ref_max': ref_max}
    return res


# ----------------------------------------------------------- phase 3
def plain_proj(lora, i, name, linear, x):
    """Layer i's projection `name` with its adapter delta from the plain
    versions (JAX's y + d); lora: None or (stack, ids [B] or [B, S]).
    linear: a Linear, or a quantized model's QuantLinear / QuantLinear4
    (plain torch, no kernel: their forward is their plain version)."""
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
    hidden = m.act(plain_proj(lora, i, 'mlp.w_gate', m.w_gate, hn)) * \
        plain_proj(lora, i, 'mlp.w_up', m.w_up, hn)
    return x + plain_proj(lora, i, 'mlp.w_down', m.w_down, hidden)


def embed(model, tokens):
    """The model's input embedding, with Gemma's sqrt(dim) scale rounded
    to the compute dtype where the config has it."""
    import torch
    x = model.tok_embed[tokens].to(model.dtype)
    if model.cfg.embed_scale:
        x = x * torch.tensor(model.cfg.dim ** 0.5, dtype=model.dtype)
    return x


def head(model, x):
    """The model's output head: lm_head, or the tied embedding."""
    if model.lm_head is None:
        return x @ model.tok_embed.to(model.dtype).t()
    return model.lm_head(x)


def plain_last_logits(model, tokens, exact=False, lora=None):
    """The model's forward with flash's plain version in place of the
    kernel (exact=True: the same attention computed from f32 copies of
    q, k, v, output rounded to the model dtype), each layer with its
    window, and the LoRA plain versions in place of theirs:
    last-position logits."""
    import torch
    from skypilot_tpu_torch.ops import flash_attention as fa
    from skypilot_tpu_torch.ops import rope
    cfg = model.cfg
    b, s = tokens.shape
    x = embed(model, tokens)
    pos = torch.arange(s, device=tokens.device)[None].expand(b, s)
    cos, sin = rope.rope_freqs(pos, cfg.head_dim, cfg.rope_theta,
                               use_llama31_scaling=cfg.use_llama31_rope)

    def attend(q, k, v, window):
        if exact:
            q, k, v = q.float(), k.float(), v.float()
        return fa.flash_attention_reference(q, k, v, causal=True,
                                            window=window)[0]
    for i in range(len(model.layers)):
        x = plain_block(model, i, x, cos, sin, functools.partial(
            attend, window=model.layers[i].attn.window), lora)
    return head(model, model.final_norm(x)[:, -1:])[:, 0].float()


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


def check_logits(model, prompt, label='lone'):
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
    _log(f'{label} prefill last-token logits (rel L2): kernel vs plain '
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
    Prefix caching is on (the engines' default), and every prompt is a
    distinct random draw, so no request hits a published page and each
    phase keeps the uncached path it drove (asserted: 0 hit pages).
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
    assert eng.pool.prefix_stats['hit_pages'] == 0, eng.pool.prefix_stats
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


# ----------------------------------------------------------- phase 3: Mistral
# mistral-7b at full width (32 layers, dim 4096, 32 q / 8 kv heads,
# head_dim 128, mlp 14336, vocab 32000, sliding window 4096 on every
# layer; the JAX preset llama.py:165), random bf16 weights from SEED, 4
# slots of up to 8192 tokens on 64-token pages. A burst of a 6000- and a
# 2000-token prompt packs into one [1, 8192] ragged row, then a lone
# 4600-token prompt: the window cuts prefill rows and decode contexts.
MISTRAL = 'mistral-7b'
MISTRAL_WINDOW = 4096
MISTRAL_LONE = 4600
MISTRAL_SEQ = 8192
# The window must move the 6000-token prompt's logits at least this many
# times as far as the kernel's rounding does (kernel vs plain).
WINDOW_EFFECT_FACTOR = 4.0


def run_mistral(card):
    """Serve mistral-7b through build_engine on the card. The flash
    forward must launch 32 times per prefill (with the window: the
    engine has no other attention kernel to take) and no paged kernel at
    all (a windowed layer decodes through the gather view, as the JAX
    package's _xla_gather); one prefill's last-token logits must match
    the plain attention (check_logits), and the same prefill without the
    window must give logits that differ by WINDOW_EFFECT_FACTOR times
    more."""
    import numpy as np
    import torch
    from skypilot_tpu_torch.infer import engine as engine_lib
    from skypilot_tpu_torch.infer import server
    t0 = time.perf_counter()
    eng = server.build_engine(MISTRAL, max_seq_len=MISTRAL_SEQ, num_slots=4,
                              page_size=64, seed=SEED)
    torch.cuda.synchronize()
    cfg = eng.model.cfg
    _log(f'build_engine({MISTRAL!r}, max_seq_len={MISTRAL_SEQ}): '
         f'{cfg.num_params() / 1e9:.2f}B params, window '
         f'{cfg.sliding_window} on every layer, '
         f'{time.perf_counter() - t0:.1f}s; paged pool '
         f'{list(eng.cache["k"].shape)} {eng.cache["k"].dtype}; prefill '
         f'buckets {eng.prefill_buckets}, ragged cap {eng._ragged_max}')
    rng = np.random.default_rng(SEED + 20)
    burst = [rng.integers(1, cfg.vocab_size, n).tolist()
             for n in MISTRAL_BURST]
    lone = rng.integers(1, cfg.vocab_size, MISTRAL_LONE).tolist()
    params = [engine_lib.SamplingParams(max_new_tokens=MAX_NEW),
              engine_lib.SamplingParams(max_new_tokens=MAX_NEW,
                                        temperature=0.8, top_k=40,
                                        seed=SEED)]
    cold_s = warm_up(eng, np.random.default_rng(SEED + 2))
    outs, launches, burst_ttft, lone_s = serve(eng, burst, params, lone)
    perf = eng.perf_stats()
    prefills = perf['prefill_dispatches']
    paged = {k: v for k, v in launches.items() if k != 'flash_fwd'}
    _log(f'mistral engine: {len(outs)} requests x {MAX_NEW} tokens; '
         f'launches {launches} (paged and LoRA kernels: {paged}, all 0: '
         f'windowed layers decode through the gather view); ragged '
         f'dispatches {perf["ragged_dispatches"]}, prefill dispatches '
         f'{prefills}')
    assert perf['ragged_dispatches'] == 1 and prefills == 2, perf
    assert launches['flash_fwd'] == cfg.n_layers * prefills, launches
    assert not any(paged.values()), paged
    lone_ttft = eng.ttfts()[-1]
    ms_tok = (lone_s - lone_ttft) / (MAX_NEW - 1) * 1e3
    _log(f'engine mistral [{card}]: warm-up request {cold_s:.2f} s; burst '
         f'TTFT max {burst_ttft * 1e3:.1f} ms ({MISTRAL_BURST} tokens, one '
         f'packed [1, 8192] prefill); lone {MISTRAL_LONE}-token TTFT '
         f'{lone_ttft * 1e3:.1f} ms, then {ms_tok:.1f} ms per token (1 live '
         f'slot, context {MISTRAL_LONE}+); steady decode '
         f'{perf.get("steady_decode_tok_s", 0):.1f} tok/s over the run')
    model = eng.model
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    res = {'launches': launches, 'outs_lengths': [len(o) for o in outs],
           'warmup_request_s': cold_s, 'burst_ttft_max_s': burst_ttft,
           'lone_ttft_s': lone_ttft, 'lone_ms_per_token': ms_tok,
           'steady_decode_tok_s': perf.get('steady_decode_tok_s'),
           'perf': perf}
    res['logits'] = check_logits(model, burst[0],
                                 f'mistral {MISTRAL_BURST[0]}-token')
    # The same prefill with every layer's window taken off.
    with torch.inference_mode():
        toks = torch.as_tensor([burst[0]], device='cuda')
        windowed = kernel_last_logits(model, toks)
        for layer in model.layers:
            layer.attn.window = 0
        try:
            unwindowed = kernel_last_logits(model, toks)
        finally:
            for i, layer in enumerate(model.layers):
                layer.attn.window = cfg.layer_window(i)
    effect = rel_l2(unwindowed, windowed)
    res['rel_window_effect'] = effect
    _log(f'mistral: the {MISTRAL_BURST[0]}-token prompt\'s last-token '
         f'logits with the window vs without (rel L2) {effect:.3e}; kernel '
         f'vs plain {res["logits"]["rel_kernel_plain"]:.3e} (the window '
         f'must move them >= {WINDOW_EFFECT_FACTOR}x as far)')
    assert effect >= WINDOW_EFFECT_FACTOR * \
        res['logits']['rel_kernel_plain'], res
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return res


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


# ------------------------------------------------- phase 3: prefix caching
# llama3-8b's prefix paths on the same model object, page 64, 8 slots of
# 2048 tokens (the JAX engine's defaults). A 1536-token shared prefix is
# 24 full pages; the miss adds a 128-token suffix, the burst 64-300.
PREFIX_LEN = 1536
PREFIX_SUFFIXES = (128, 64, 180, 300)
PREFIX_HIT_PAGES = 3 * PREFIX_LEN // 64
# Chunked prefill: a 1900-token prompt in 512-token chunks (4 chunks)
# while a 256-token request decodes 128 tokens.
CHUNK_PROMPT = 1900
CHUNK = 512
CHUNK_OTHER = (256, 128)
# The host tier: prompt A of 16 full pages and a 16-token tail (the
# reserve shares at most (n - 1) // 64 pages, so all 16 are reusable) in
# a 20-page pool; B (100 tokens, 1180 new: all 20 pages) evicts all of
# A's published pages and is cancelled after its first token, so the
# rerun of A finds 19 free pages for the promotion.
TIER_PROMPT = 1040
TIER_POOL_TOKENS = 20 * 64
TIER_EVICTOR = (100, 1180)


def record_suffix_logits(eng):
    """Wrap the engine's suffix prefill (prefix hits and prefill chunks)
    to keep each call's (start, length, logits) as the engine computed
    them; the wrapper changes nothing the engine sees."""
    rec = []
    orig = eng._prefill_suffix_impl

    def wrapped(tokens, start, length, table_row, lora_id=0):
        out = orig(tokens, start, length, table_row, lora_id)
        rec.append((start, length, out[1].clone()))
        return out
    eng._prefill_suffix_impl = wrapped
    return rec


def reset_counters():
    from skypilot_tpu_torch.ops import flash_attention as fa
    from skypilot_tpu_torch.ops import paged_attention as pa
    fa.reset_launches()
    pa.reset_launches()


def read_counters():
    from skypilot_tpu_torch.ops import flash_attention as fa
    from skypilot_tpu_torch.ops import paged_attention as pa
    return {'flash_fwd': fa.launches, **pa.launches}


def check_hit_logits(model, prompt, logits, label):
    """A prefix hit's (or a final chunk's) first-token logits, as the
    engine computed them over the shared pages, against the plain full
    forward of the whole prompt (plain_last_logits): rel L2 within
    LOGIT_REL_L2."""
    import torch
    with torch.inference_mode():
        toks = torch.as_tensor([prompt],
                               device=next(model.parameters()).device)
        ref = plain_last_logits(model, toks)[0]
    got = logits.reshape(-1).float()
    rel = rel_l2(got, ref)
    _log(f'{label}: first-token logits vs plain full forward (rel L2) '
         f'{rel:.3e} (limit {LOGIT_REL_L2}); argmax equal '
         f'{int(got.argmax()) == int(ref.argmax())}')
    assert torch.isfinite(got).all(), f'{label}: non-finite logits'
    assert rel <= LOGIT_REL_L2, (label, rel)
    return rel


def run_shared_prefix(model, card, kv_dtype):
    """One miss (prefix + 128, a full prefill through the flash kernel,
    publishing its 26 full pages) then a burst of 3 hits (prefix + 64,
    180, 300), each sharing the prefix's 24 pages and prefilling only its
    suffix. Asserts 72 hit pages, one flash prefill (32 launches), the
    paged kernel launched, and each hit's logits against the plain full
    forward."""
    import numpy as np
    import torch
    from skypilot_tpu_torch.infer import engine as engine_lib
    label = f'prefix {kv_dtype}'
    eng = engine_lib.InferenceEngine(
        model, num_slots=8, max_seq_len=2048, decode_chunk=16, page_size=64,
        kv_dtype=kv_dtype, device=next(model.parameters()).device)
    assert eng.prefix_caching
    vocab = model.cfg.vocab_size
    rng = np.random.default_rng(SEED + 30)
    prefix = rng.integers(1, vocab, PREFIX_LEN).tolist()
    prompts = [prefix + rng.integers(1, vocab, n).tolist()
               for n in PREFIX_SUFFIXES]
    warm_up(eng, np.random.default_rng(SEED + 2))
    # A throwaway hit too (200 tokens twice: the second shares 3 pages):
    # the suffix path's first calls pay one-time set-up.
    warm = np.random.default_rng(SEED + 33).integers(1, vocab, 200).tolist()
    eng.start()
    try:
        for _ in range(2):
            eng.generate(warm, engine_lib.SamplingParams(max_new_tokens=4))
    finally:
        eng.stop()
    eng.reset_perf()
    rec = record_suffix_logits(eng)
    sp = engine_lib.SamplingParams(max_new_tokens=MAX_NEW)
    reset_counters()
    eng.start()
    try:
        outs = [eng.generate(prompts[0], sp)]
        hits0 = eng.pool.prefix_stats['hit_pages']
        queues = [eng.submit(p, sp)[1] for p in prompts[1:]]
        outs += [drain(q) for q in queues]
    finally:
        eng.stop()
    launches = read_counters()
    hit_pages = eng.pool.prefix_stats['hit_pages'] - hits0
    kernel = 'paged_decode_q' if kv_dtype == 'int8' else 'paged_decode'
    ttfts = eng.ttfts()
    _log(f'{label} [{card}]: {len(outs)} requests x {MAX_NEW} tokens; '
         f'{hit_pages} hit pages (want {PREFIX_HIT_PAGES}); launches '
         f'{launches}; TTFT miss ({len(prompts[0])} tokens, full prefill) '
         f'{ttfts[0] * 1e3:.1f} ms, hits (suffixes {PREFIX_SUFFIXES[1:]}, '
         f'admitted one after another) '
         + ', '.join(f'{t * 1e3:.1f}' for t in ttfts[1:]) + ' ms')
    for i, toks in enumerate(outs):
        assert len(toks) == MAX_NEW, f'{label} request {i}: {len(toks)}'
    assert hit_pages == PREFIX_HIT_PAGES, (label, hit_pages)
    assert launches['flash_fwd'] == model.cfg.n_layers, (label, launches)
    assert launches[kernel] > 0, f'{label}: {kernel} never launched'
    assert [length for _, length, _ in rec] == \
        [len(p) for p in prompts[1:]], (label, rec)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    rels = [check_hit_logits(model, p, logits, f'{label} hit {i}')
            for i, (p, (_, _, logits)) in enumerate(zip(prompts[1:], rec))]
    return {'launches': launches, 'hit_pages': hit_pages,
            'ttft_miss_s': ttfts[0], 'ttft_hits_s': ttfts[1:],
            'hit_rel_l2': rels,
            'prompt_lengths': [len(p) for p in prompts]}


def run_chunked(model, card):
    """prefill_chunk=512: a 256-token request is decoding when a
    1900-token prompt arrives, which prefills in 4 chunks (one per loop
    iteration, through the suffix path) while the other request keeps
    receiving tokens. Asserts >= 3 chunks, tokens of the other request
    delivered between chunks, and the final chunk's logits against the
    plain full forward."""
    import threading
    import numpy as np
    import torch
    from skypilot_tpu_torch.infer import engine as engine_lib
    eng = engine_lib.InferenceEngine(
        model, num_slots=8, max_seq_len=2048, decode_chunk=16, page_size=64,
        prefill_chunk=CHUNK, device=next(model.parameters()).device)
    vocab = model.cfg.vocab_size
    rng = np.random.default_rng(SEED + 31)
    other = rng.integers(1, vocab, CHUNK_OTHER[0]).tolist()
    long = rng.integers(1, vocab, CHUNK_PROMPT).tolist()
    warm_up(eng, np.random.default_rng(SEED + 2))
    rec = record_suffix_logits(eng)
    marks = []     # prefill_chunks as each of the other's tokens arrives
    reset_counters()
    eng.start()
    try:
        _, q_other = eng.submit(other, engine_lib.SamplingParams(
            max_new_tokens=CHUNK_OTHER[1]))
        assert q_other.get(timeout=600) is not None

        def watch():
            while q_other.get(timeout=600) is not None:
                marks.append(eng.perf['prefill_chunks'])
        watcher = threading.Thread(target=watch)
        watcher.start()
        t0 = time.perf_counter()
        out = eng.generate(long, engine_lib.SamplingParams(
            max_new_tokens=MAX_NEW))
        long_s = time.perf_counter() - t0
        watcher.join(timeout=600)
    finally:
        eng.stop()
    launches = read_counters()
    chunks = eng.perf['prefill_chunks']
    between = sorted({m for m in marks if 0 < m < chunks})
    _log(f'chunked prefill [{card}]: {CHUNK_PROMPT}-token prompt in '
         f'{chunks} chunks of {CHUNK}; the other request received '
         f'{len(marks) + 1} tokens, at chunk counts {sorted(set(marks))} '
         f'(between chunks: {between}); long prompt TTFT '
         f'{eng.ttfts()[-1] * 1e3:.1f} ms, {long_s:.2f} s for '
         f'{MAX_NEW} tokens; launches {launches}')
    assert len(out) == MAX_NEW, len(out)
    assert len(marks) + 1 == CHUNK_OTHER[1], len(marks)
    assert chunks >= 3, chunks
    assert len(between) >= 2, (marks, chunks)
    assert launches['paged_decode'] > 0, launches
    final = [lg for _, length, lg in rec if length == CHUNK_PROMPT]
    assert len(rec) == chunks and len(final) == 1, [r[:2] for r in rec]
    ttft = eng.ttfts()[-1]
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    rel = check_hit_logits(model, long, final[0], 'chunked final chunk')
    return {'launches': launches, 'chunks': chunks,
            'other_tokens_at_chunk_counts': marks,
            'long_ttft_s': ttft, 'final_rel_l2': rel}


def page_bytes(eng, hashes):
    """The bytes of each page published under `hashes`, every pool
    ({name: [L, H, P(, d)]} on the host)."""
    out = []
    for h in hashes:
        page = eng.pool.registered_page(h)
        assert page is not None, h.hex()
        out.append({n: eng.cache[n][:, page].to('cpu', copy=True)
                    for n in eng._kv_pool_keys()})
    return out


def same_bytes(a, b):
    import torch
    return sorted(a) == sorted(b) and all(
        a[n].dtype == b[n].dtype and a[n].shape == b[n].shape and
        torch.equal(a[n].view(torch.uint8), b[n].view(torch.uint8))
        for n in a)


def run_host_tier(model, card):
    """SKYT_KV_TIER=host on a 20-page pool: A (1040 tokens, 16 reusable
    pages) runs, B (100 tokens + 1180 new: all 20 pages) evicts every
    one of A's published pages (each cloned on the stream and copied to
    the host store by the writer thread) and is cancelled after its
    first token; A's rerun promotes its 16 pages back and is a prefix
    hit. Asserts 16 spilled and 16 promoted pages, each bit-equal to the
    bytes A's prefill wrote and to the bytes spilled."""
    import numpy as np
    import torch
    from skypilot_tpu_torch.infer import engine as engine_lib
    from skypilot_tpu_torch.infer import paged_cache
    old = os.environ.get('SKYT_KV_TIER')
    os.environ['SKYT_KV_TIER'] = 'host'
    try:
        eng = engine_lib.InferenceEngine(
            model, num_slots=8, max_seq_len=2048, decode_chunk=16,
            page_size=64, pool_tokens=TIER_POOL_TOKENS,
            device=next(model.parameters()).device)
    finally:
        if old is None:
            del os.environ['SKYT_KV_TIER']
        else:
            os.environ['SKYT_KV_TIER'] = old
    assert eng.kv_tier is not None
    vocab = model.cfg.vocab_size
    rng = np.random.default_rng(SEED + 32)
    a = rng.integers(1, vocab, TIER_PROMPT).tolist()
    b = rng.integers(1, vocab, TIER_EVICTOR[0]).tolist()
    hashes = paged_cache.page_hashes(a, 64)[:(TIER_PROMPT - 1) // 64]
    warm_up(eng, np.random.default_rng(SEED + 2))
    promote = eng._kv_try_promote
    promote_s = []

    def timed_promote(req):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = promote(req)
        torch.cuda.synchronize()
        promote_s.append((n, time.perf_counter() - t0))
        return n
    eng._kv_try_promote = timed_promote
    sp = engine_lib.SamplingParams(max_new_tokens=8)
    reset_counters()
    eng.start()
    try:
        first = eng.generate(a, sp)
        written = page_bytes(eng, hashes)
        rid, q_b = eng.submit(b, engine_lib.SamplingParams(
            max_new_tokens=TIER_EVICTOR[1]))
        assert q_b.get(timeout=600) is not None
        assert eng.cancel(rid)
        b_toks = drain(q_b)
        evicted = [eng.pool.registered_page(h) is None for h in hashes]
        assert eng.kv_tier.drain(60), 'spills did not finish'
        spilled = [eng.kv_tier.host.get(h, eng.kv_version) for h in hashes]
        hits0 = eng.pool.prefix_stats['hit_pages']
        again = eng.generate(a, sp)
        promoted = page_bytes(eng, hashes)
    finally:
        eng.stop()
    launches = read_counters()
    snap = eng.kv_tier.snapshot()
    hit = eng.pool.prefix_stats['hit_pages'] - hits0
    ttfts = eng.ttfts()
    n_prom = sum(n for n, _ in promote_s)
    prom_s = sum(s for n, s in promote_s if n)
    spill_ms = snap['spill_s'] / max(1, snap['spill_stored']) * 1e3
    page_mib = sum(t.numel() * t.element_size()
                   for t in written[0].values()) / 2**20
    _log(f'host tier [{card}]: A {TIER_PROMPT} tokens, {len(hashes)} '
         f'reusable pages of {page_mib:.1f} MiB; B reserved the pool and '
         f'was cancelled after {len(b_toks) + 1} token(s); evicted '
         f'{sum(evicted)}, spilled {snap["spill_stored"]} pages '
         f'({spill_ms:.2f} ms a page in the writer: copy to host + put), '
         f'host store {snap["host"]["bytes"] / 2**20:.0f} MiB; rerun '
         f'promoted {n_prom} pages in {prom_s * 1e3:.2f} ms '
         f'(install, synchronized), {hit} hit pages; TTFT A first '
         f'{ttfts[0] * 1e3:.1f} ms, A rerun {ttfts[-1] * 1e3:.1f} ms; '
         f'rerun tokens equal the first run\'s: {again == first}; '
         f'launches {launches}')
    assert all(evicted), evicted
    assert all(s is not None for s in spilled), 'a page was not spilled'
    assert all(same_bytes(s, w) for s, w in zip(spilled, written)), \
        'a spilled page differs from the page A wrote'
    assert n_prom == len(hashes) == 16, promote_s
    assert snap['promoted_pages'] == len(hashes), snap
    assert all(same_bytes(p, s) for p, s in zip(promoted, spilled)), \
        'a promoted page differs from the bytes spilled'
    assert hit == len(hashes), hit
    assert len(first) == len(again) == 8
    assert launches['paged_decode'] > 0, launches
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return {'launches': launches, 'evicted': sum(evicted),
            'spilled_pages': snap['spill_stored'],
            'spill_ms_per_page': spill_ms, 'page_mib': page_mib,
            'promoted_pages': n_prom, 'promote_ms': prom_s * 1e3,
            'hit_pages': hit, 'ttft_first_s': ttfts[0],
            'ttft_rerun_s': ttfts[-1], 'rerun_tokens_equal': again == first,
            'kv_tier': snap}


def run_prefix(model, card):
    """The prefix-caching phase: shared prefix on bf16 and int8 pools,
    chunked prefill, the host tier. Each part's launch counters are set
    to 0 just before it and read just after."""
    res = {'shared_bf16': run_shared_prefix(model, card, 'auto'),
           'shared_int8': run_shared_prefix(model, card, 'int8'),
           'chunked': run_chunked(model, card),
           'host_tier': run_host_tier(model, card)}
    res['launches'] = {part: r['launches'] for part, r in res.items()}
    return res


# ----------------------------------------------------- phase 3: HTTP front door
# The replica's HTTP server (infer/server.py) over an engine on the same
# llama3-8b weights (8 slots, max_seq_len 2048, 64-token pages), driven
# with http.client only. Eight concurrent /generate requests of distinct
# prompts (64-1024 tokens); every other prompt is 64 tokens, one page
# short of a prefix hit, so a repeated prompt keeps the uncached path.
HTTP_BURST = (64, 1024, 300, 512, 128, 800, 200, 700)
HTTP_NEW = 32
HTTP_SHORT = 64
HTTP_LP_TOL = 5e-2            # first logprob vs plain_last_logits'
HTTP_DEADLINE_S = 0.2
HTTP_COST_NEW = 128           # tokens a slot in the option-cost runs
HTTP_OPTIONS = (('greedy', {}), ('logprobs', {'logprobs': 0}),
                ('penalties', {'presence_penalty': 0.5,
                               'frequency_penalty': 0.5}),
                ('bias', {'logit_bias': {'17': 5.0}}),
                ('greedy_again', {}))


def http_call(port, method, path, body=None, headers=None, timeout=600):
    """One request over http.client: (status, headers, body bytes)."""
    import http.client
    conn = http.client.HTTPConnection('127.0.0.1', port, timeout=timeout)
    try:
        hdrs = dict(headers or {})
        data = None
        if body is not None:
            data = json.dumps(body)
            hdrs['Content-Type'] = 'application/json'
        conn.request(method, path, body=data, headers=hdrs)
        resp = conn.getresponse()
        return resp.status, {k.lower(): v for k, v in resp.getheaders()}, \
            resp.read()
    finally:
        conn.close()


def http_stream(port, path, body):
    """A streamed POST: (status, headers, lines, seconds to the first
    line, seconds to the end), timed from just before the request."""
    import http.client
    conn = http.client.HTTPConnection('127.0.0.1', port, timeout=600)
    try:
        t0 = time.perf_counter()
        conn.request('POST', path, body=json.dumps(body),
                     headers={'Content-Type': 'application/json'})
        resp = conn.getresponse()
        lines, first = [], None
        while True:
            line = resp.readline()
            if not line:
                break
            if first is None and line.strip():
                first = time.perf_counter() - t0
            if line.strip():
                lines.append(line.decode().strip())
        return resp.status, {k.lower(): v for k, v in resp.getheaders()}, \
            lines, first, time.perf_counter() - t0
    finally:
        conn.close()


def http_metric(port, name):
    _, _, raw = http_call(port, 'GET', '/metrics')
    for line in raw.decode().splitlines():
        if line.startswith(name + ' '):
            return float(line.split()[1])
    return 0.0


def sse_done(lines):
    """An SSE stream's events: its last is [DONE]."""
    events = [ln[len('data: '):] for ln in lines if ln.startswith('data: ')]
    assert events and events[-1] == '[DONE]', events[-2:]
    return [json.loads(e) for e in events[:-1]]


def http_option_cost(eng, port, rng, vocab, opts):
    """8 concurrent requests of HTTP_COST_NEW tokens, the options `opts`
    on the first only: the engine's ms per decode step over the steady
    intervals (8 live slots)."""
    import concurrent.futures
    prompts = [rng.integers(1, vocab, HTTP_SHORT).tolist() for _ in range(8)]
    eng.reset_perf()

    def one(i):
        if i == 0 and 'logprobs' in opts:
            return http_call(port, 'POST', '/v1/completions', {
                'prompt': prompts[i], 'max_tokens': HTTP_COST_NEW,
                **opts})[0]
        body = {'tokens': prompts[i], 'max_tokens': HTTP_COST_NEW}
        if i == 0:
            body.update(opts)
        return http_call(port, 'POST', '/generate', body)[0]
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        codes = list(pool.map(one, range(8)))
    assert codes == [200] * 8, codes
    perf = eng.perf_stats()
    assert perf['steady_tokens'] > 0, perf
    return perf['steady_time_s'] / (perf['steady_tokens'] / 8) * 1e3


def free_port():
    import socket
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def run_server_entry(card, model=MODEL, extra=(), argv=None, text=False):
    """`python -m skypilot_tpu_torch.infer.server --model llama3-8b
    --num-slots 8 --port <free>` in a subprocess: /health, /v1/models,
    one /generate, then SIGTERM must exit 0. extra: more flags; argv: the
    flags in place of --model/--num-slots; text: also one /generate on
    text (a checkpoint's tokenizer)."""
    import signal
    port = free_port()
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root)
    t0 = time.perf_counter()
    flags = ('--model', model, '--num-slots', '8') if argv is None \
        else tuple(argv)
    proc = subprocess.Popen(
        [sys.executable, '-m', 'skypilot_tpu_torch.infer.server',
         *flags, '--port', str(port), *extra],
        cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    try:
        healthy = None
        while time.perf_counter() - t0 < 300:
            assert proc.poll() is None, proc.stdout.read()[-4000:]
            try:
                if http_call(port, 'GET', '/health', timeout=5)[0] == 200:
                    healthy = time.perf_counter() - t0
                    break
            except OSError:
                pass
            time.sleep(0.5)
        assert healthy is not None, 'server never became healthy'
        status, _, raw = http_call(port, 'GET', '/v1/models')
        assert status == 200, raw[:500]
        model_id = json.loads(raw)['data'][0]['id']
        status, _, raw = http_call(port, 'POST', '/generate', {
            'tokens': list(range(1, 65)), 'max_tokens': 8})
        assert status == 200, raw[:500]
        toks = json.loads(raw)['tokens']
        assert len(toks) == 8, toks
        text_toks = None
        if text:
            status, _, raw = http_call(port, 'POST', '/generate', {
                'text': 'hello tpu world again', 'max_tokens': 8})
            assert status == 200, raw[:500]
            text_toks = json.loads(raw)['tokens']
            assert len(text_toks) == 8, text_toks
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=120)
        out = proc.stdout.read()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert rc == 0, (rc, out[-4000:])
    _log(f'server entry point {" ".join(flags)} [{card}]: healthy after '
         f'{healthy:.1f} s (build + warm-up request), /v1/models '
         f'{model_id!r}, /generate 200 with {len(toks)} tokens'
         + ('' if text_toks is None else
            f' (and {len(text_toks)} on text)') + f', SIGTERM -> exit {rc}')
    return {'healthy_s': healthy, 'exit_code': rc, 'model_id': model_id,
            'tokens': toks, 'text_tokens': text_toks}


def run_http(model, card):
    """The HTTP front door on the llama3-8b weights (see HTTP_BURST).
    Checks: 8 concurrent /generate all 200 with their tokens, the flash
    and paged counters (set to 0 just before, read just after) risen; a
    lone request over HTTP gives eng.generate's tokens and a first
    logprob within HTTP_LP_TOL of plain_last_logits'; a stream gives
    the whole response's tokens (client and engine TTFT printed);
    presence_penalty=1e9 makes 32 distinct tokens, logit_bias {t: 100}
    every token t, X-Request-Deadline 0.2 s ends a 2048-token request
    early and skyt_infer_deadline_expired_total rises; the ms per decode
    step with 8 slots, greedy and with each option on one slot; the
    OpenAI routes' SSE ends in [DONE]; then the server's entry point in
    a subprocess."""
    import concurrent.futures
    import numpy as np
    import torch
    from skypilot_tpu_torch.infer import engine as engine_lib
    from skypilot_tpu_torch.infer import server as server_lib
    from skypilot_tpu_torch.utils import metrics as metrics_lib
    vocab = model.cfg.vocab_size
    eng = engine_lib.InferenceEngine(
        model, num_slots=8, max_seq_len=2048, decode_chunk=16, page_size=64,
        device=next(model.parameters()).device,
        metrics_registry=metrics_lib.MetricsRegistry())
    warm_up(eng, np.random.default_rng(SEED + 2))
    srv = server_lib.InferenceServer(eng, model_id=MODEL)
    rng = np.random.default_rng(SEED + 50)
    res = {}
    eng.start()
    port = srv.start()
    try:
        burst = [rng.integers(1, vocab, n).tolist() for n in HTTP_BURST]
        reset_counters()
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(8) as pool:
            replies = list(pool.map(lambda p: http_call(
                port, 'POST', '/generate',
                {'tokens': p, 'max_tokens': HTTP_NEW}), burst))
        burst_s = time.perf_counter() - t0
        launches = read_counters()
        for i, (status, hdrs, raw) in enumerate(replies):
            assert status == 200, (i, status, raw[:300])
            toks = json.loads(raw)['tokens']
            assert len(toks) == HTTP_NEW and all(0 <= t < vocab
                                                 for t in toks), (i, toks)
            assert 'x-request-id' in hdrs
        assert launches['flash_fwd'] > 0, launches
        assert launches['paged_decode'] > 0, launches
        res['launches'] = launches
        res['burst_s'] = burst_s
        _log(f'http burst [{card}]: 8 concurrent /generate (prompts '
             f'{HTTP_BURST}) x {HTTP_NEW} tokens, all 200 in {burst_s:.2f} s; '
             f'launches {launches}')

        lone = rng.integers(1, vocab, HTTP_SHORT).tolist()
        status, _, raw = http_call(port, 'POST', '/generate',
                                   {'tokens': lone, 'max_tokens': HTTP_NEW})
        assert status == 200, raw[:300]
        http_toks = json.loads(raw)['tokens']
        eng_toks = eng.generate(lone, engine_lib.SamplingParams(
            max_new_tokens=HTTP_NEW))
        assert http_toks == eng_toks, (http_toks, eng_toks)
        status, _, raw = http_call(port, 'POST', '/v1/completions', {
            'prompt': lone, 'max_tokens': 1, 'logprobs': 0})
        assert status == 200, raw[:300]
        first_lp = json.loads(raw)['choices'][0]['logprobs'][
            'token_logprobs'][0]
        with torch.inference_mode():
            toks = torch.as_tensor([lone], device=eng.device)
            ref_lp = float(torch.log_softmax(plain_last_logits(
                model, toks)[0], -1)[http_toks[0]])
            ker_lp = float(torch.log_softmax(kernel_last_logits(
                model, toks)[0], -1)[http_toks[0]])
        _log(f'http lone [{card}]: tokens equal to eng.generate; first '
             f'logprob {first_lp:.5f}, plain_last_logits {ref_lp:.5f} '
             f'(|diff| {abs(first_lp - ref_lp):.2e}, limit {HTTP_LP_TOL}), '
             f'kernel prefill {ker_lp:.5f}')
        assert math.isfinite(first_lp)
        assert abs(first_lp - ref_lp) <= HTTP_LP_TOL, (first_lp, ref_lp)
        res['lone'] = {'first_logprob': first_lp, 'plain_logprob': ref_lp,
                       'kernel_logprob': ker_lp}

        sp = rng.integers(1, vocab, HTTP_SHORT).tolist()
        status, hdrs, lines, client_ttft, stream_s = http_stream(
            port, '/generate', {'tokens': sp, 'max_tokens': HTTP_NEW,
                                'stream': True})
        assert status == 200 and hdrs['transfer-encoding'] == 'chunked'
        stream_toks = [json.loads(ln)['token'] for ln in lines]
        whole = json.loads(http_call(port, 'POST', '/generate', {
            'tokens': sp, 'max_tokens': HTTP_NEW})[2])['tokens']
        assert stream_toks == whole, (stream_toks, whole)
        rid = hdrs['x-request-id']
        trace = json.loads(http_call(port, 'GET',
                                     f'/stats?request_id={rid}')[2])
        engine_ttft = trace['first_token'] - trace['queued']
        _log(f'http stream [{card}]: {len(stream_toks)} ndjson tokens equal '
             f'to the whole response; TTFT client (request sent -> first '
             f'line) {client_ttft * 1e3:.2f} ms, engine (queued -> first '
             f'token) {engine_ttft * 1e3:.2f} ms, gap '
             f'{(client_ttft - engine_ttft) * 1e3:.2f} ms; stream '
             f'{stream_s:.3f} s')
        res['stream'] = {'client_ttft_s': client_ttft,
                         'engine_ttft_s': engine_ttft, 'stream_s': stream_s}

        pen = json.loads(http_call(port, 'POST', '/generate', {
            'tokens': rng.integers(1, vocab, HTTP_SHORT).tolist(),
            'max_tokens': 32, 'presence_penalty': 1e9})[2])['tokens']
        assert len(pen) == 32 and len(set(pen)) == 32, pen
        biased = json.loads(http_call(port, 'POST', '/generate', {
            'tokens': rng.integers(1, vocab, HTTP_SHORT).tolist(),
            'max_tokens': 32, 'logit_bias': {'4242': 100}})[2])['tokens']
        assert biased == [4242] * 32, biased
        expired0 = http_metric(port, 'skyt_infer_deadline_expired_total')
        t0 = time.perf_counter()
        status, hdrs, raw = http_call(
            port, 'POST', '/generate',
            {'tokens': rng.integers(1, vocab, HTTP_SHORT).tolist(),
             'max_tokens': 2048},
            {'X-Request-Deadline': str(HTTP_DEADLINE_S)})
        dl_s = time.perf_counter() - t0
        assert status == 200, raw[:300]
        dl_toks = json.loads(raw)['tokens']
        expired = http_metric(port, 'skyt_infer_deadline_expired_total')
        assert len(dl_toks) < 2048 - HTTP_SHORT and expired == expired0 + 1, \
            (len(dl_toks), expired0, expired)
        trace = json.loads(http_call(
            port, 'GET', f'/stats?request_id={hdrs["x-request-id"]}')[2])
        assert trace['status'] == 'deadline', trace
        _log(f'http options [{card}]: presence_penalty=1e9 -> 32 distinct '
             f'tokens; logit_bias {{4242: 100}} -> 32 x 4242; '
             f'X-Request-Deadline {HTTP_DEADLINE_S} s on max_tokens 2048 -> '
             f'{len(dl_toks)} tokens in {dl_s:.3f} s, '
             f'skyt_infer_deadline_expired_total {expired0:g} -> '
             f'{expired:g}')
        res['options'] = {'deadline_tokens': len(dl_toks),
                          'deadline_wall_s': dl_s}

        cost = {name: http_option_cost(eng, port, rng, vocab, opts)
                for name, opts in HTTP_OPTIONS}
        _log(f'http option cost [{card}]: ms per decode step, 8 live slots, '
             f'{HTTP_COST_NEW} tokens each, the option on one slot: ' +
             ', '.join(f'{k} {v:.3f}' for k, v in cost.items()))
        res['ms_per_step'] = cost

        status, hdrs, lines, c_ttft, _ = http_stream(
            port, '/v1/completions', {'prompt': 'Tell me about the sea.',
                                      'max_tokens': 16, 'stream': True})
        assert status == 200, lines
        events = sse_done(lines)
        assert events[-1]['choices'][0]['finish_reason'] == 'length'
        status, hdrs, lines, chat_ttft, _ = http_stream(
            port, '/v1/chat/completions', {
                'messages': [{'role': 'user', 'content': 'Hello there.'}],
                'max_tokens': 16, 'stream': True})
        assert status == 200, lines
        chat = sse_done(lines)
        assert chat[0]['choices'][0]['delta'].get('role') == 'assistant'
        status, _, raw = http_call(port, 'GET', '/stats')
        stats = json.loads(raw)
        assert status == 200 and stats['kernel_paths']['paged_attention'] \
            == 'cuda', stats
        _log(f'http openai [{card}]: /v1/completions SSE {len(events)} '
             f'events + [DONE] (first event {c_ttft * 1e3:.2f} ms), '
             f'/v1/chat/completions SSE {len(chat)} events + [DONE] '
             f'({chat_ttft * 1e3:.2f} ms)')
        res['openai'] = {'completions_events': len(events),
                         'chat_events': len(chat)}
    finally:
        srv.stop()
        eng.stop()
    del eng, srv
    gc.collect()
    torch.cuda.empty_cache()
    res['entry'] = run_server_entry(card)
    return res


# ------------------------------------------------- phase 3: HF checkpoints
# llama3-8b's weights written as an HF checkpoint by the port's writer
# and served from it (page 64, 8 slots of 2048 tokens): bf16, then int8
# and int4 weight-only quantized as each tensor leaves the reader.
CKPT_PROMPT = 512
CKPT_NEW = 32
CKPT_COST_PROMPT = 128        # the ms-per-token runs: prompt, new tokens
CKPT_COST_NEW = 64
CKPT_QUANT = ('int8', 'int4')
CKPT_CODES_OF = ('layers.0.attn.wq', 'lm_head')
CKPT_DISK_MARGIN = 1.1         # free disk wanted over the weights' bytes


def ckpt_tokenizer(d):
    """A WordLevel tokenizer.json (and tokenizer_config.json) in d when
    the `tokenizers` package is there; False (no file: the server takes
    the byte fallback) when it is not."""
    try:
        import tokenizers
        from tokenizers import models as tok_models
        from tokenizers import pre_tokenizers
    except ImportError:
        return False
    vocab = {'<s>': 0, '</s>': 1, '<unk>': 2, 'hello': 3, 'tpu': 4,
             'world': 5, 'again': 6}
    tok = tokenizers.Tokenizer(tok_models.WordLevel(vocab,
                                                    unk_token='<unk>'))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    tok.save(os.path.join(d, 'tokenizer.json'))
    with open(os.path.join(d, 'tokenizer_config.json'), 'w') as f:
        json.dump({'bos_token': '<s>', 'eos_token': '</s>'}, f)
    return True


def cut_model(model, n_layers):
    """The first n_layers of `model` as a model of their own, sharing its
    tensors (no copy): the checkpoint a smaller disk can hold."""
    import dataclasses
    from skypilot_tpu_torch.models import llama
    cfg = dataclasses.replace(model.cfg, n_layers=n_layers)
    cut = llama.LlamaModel(cfg, device='meta')
    sd = {k: v for k, v in model.state_dict().items()
          if not k.startswith('layers.') or int(k.split('.')[1]) < n_layers}
    cut.load_state_dict(sd, assign=True)
    return cut


@contextlib.contextmanager
def timed_loads(record):
    """Wrap weights.load_checkpoint, as build_engine calls it, to keep
    each load's seconds, its peak device memory over what was allocated
    before it, and what stays resident; the wrapper changes nothing the
    engine sees."""
    import torch
    from skypilot_tpu_torch.models import weights
    real = weights.load_checkpoint

    def wrapped(*args, **kw):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = real(*args, **kw)
        torch.cuda.synchronize()
        record.append({'load_s': time.perf_counter() - t0,
                       'peak_gib': (torch.cuda.max_memory_allocated()
                                    - base) / 2**30,
                       'resident_gib': (torch.cuda.memory_allocated()
                                        - base) / 2**30})
        return out
    weights.load_checkpoint = wrapped
    try:
        yield record
    finally:
        weights.load_checkpoint = real


def ckpt_cost(eng, rng, n, repeat=False):
    """n concurrent requests (CKPT_COST_PROMPT tokens, CKPT_COST_NEW new
    each) on a started engine: ms per token a slot over the steady
    intervals (a decode step's time at n live slots; a spec engine's
    steps may give more than one). repeat: request 0 repeats a 16-token
    sequence, so the n-gram proposer drafts (verify steps)."""
    from skypilot_tpu_torch.infer import engine as engine_lib
    vocab = eng.model.cfg.vocab_size
    prompts = [rng.integers(1, vocab, CKPT_COST_PROMPT).tolist()
               for _ in range(n)]
    if repeat:
        prompts[0] = (rng.integers(1, vocab, 16).tolist() * 8)[
            :CKPT_COST_PROMPT]
    eng.reset_perf()
    queues = [eng.submit(p, engine_lib.SamplingParams(
        max_new_tokens=CKPT_COST_NEW))[1] for p in prompts]
    outs = [drain(q) for q in queues]
    assert all(len(o) == CKPT_COST_NEW for o in outs), [len(o) for o in outs]
    perf = eng.perf_stats()
    assert perf['steady_tokens'] > 0, perf
    return perf['steady_time_s'] / (perf['steady_tokens'] / n) * 1e3, perf


def ckpt_serve(eng, prompt, rng, card, label):
    """One engine from the checkpoint: warm-up, the prompt's greedy
    stream, then the 8-slot cost, the counters set to 0 just before and
    read just after; then a 4-slot spec_decode=4 engine on the same
    model (its verify kernel's counter too)."""
    import numpy as np
    import torch
    from skypilot_tpu_torch.infer import engine as engine_lib
    warm_up(eng, np.random.default_rng(SEED + 2))
    reset_counters()
    eng.start()
    try:
        toks = eng.generate(prompt, engine_lib.SamplingParams(
            max_new_tokens=CKPT_NEW))
        ms8, _ = ckpt_cost(eng, rng, 8)
    finally:
        eng.stop()
    launches = read_counters()
    assert launches['flash_fwd'] > 0, (label, launches)
    assert launches['paged_decode'] > 0, (label, launches)
    spec = engine_lib.InferenceEngine(
        eng.model, num_slots=4, max_seq_len=2048, decode_chunk=16,
        page_size=64, spec_decode=4, device=eng.device)
    warm_up(spec, np.random.default_rng(SEED + 2))
    reset_counters()
    spec.start()
    try:
        ms4, perf = ckpt_cost(spec, rng, 4, repeat=True)
    finally:
        spec.stop()
    spec_launches = read_counters()
    assert perf['spec_verify_steps'] > 0, (label, perf)
    assert spec_launches['paged_decode_mq'] > 0, (label, spec_launches)
    del spec
    gc.collect()
    torch.cuda.empty_cache()
    _log(f'checkpoint {label} [{card}]: ms per token {ms8:.3f} at 8 slots, '
         f'{ms4:.3f} at 4 slots with spec_decode=4 (accept per step '
         f'{perf["spec_accept_per_step"]:.3f}); launches {launches}, spec '
         f'{spec_launches}')
    return {'tokens': toks, 'ms_per_token_8': ms8,
            'ms_per_token_spec4': ms4,
            'spec_accept_per_step': perf['spec_accept_per_step'],
            'launches': launches, 'spec_launches': spec_launches}


def same_bits(a, b):
    """Equal bit for bit (floats compared as their integer words)."""
    import torch
    if a.is_floating_point():
        word = {2: torch.int16, 4: torch.int32}[a.element_size()]
        a, b = a.view(word), b.view(word)
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.cpu(), b.cpu())


def run_checkpoint(model, card):
    """HF checkpoint I/O and weight-only quantization on llama3-8b's
    weights (the phase's seconds, bytes and memory printed):
      * write: weights.save_hf_checkpoint of the model to a temporary
        directory (fewer layers at full width if the disk cannot hold 32;
        the cut is logged), with a tokenizer.json when `tokenizers` is
        there;
      * bf16: build_engine(checkpoint=) — last logits of a 512-token
        prompt bit-equal to the in-memory model's, the same greedy
        stream as an engine on the in-memory model;
      * int8, int4: codes made on the card byte-equal to the CPU
        quantizer's (layers.0.attn.wq, lm_head) and to the loaded
        engine's; last logits within LOGIT_REL_L2 of plain_last_logits
        of the same quantized model (check_logits); rel L2 against bf16;
      * each mode: the load's seconds, peak and resident memory; ms per
        token at 8 slots and at 4 slots with spec_decode=4; the flash
        and paged counters risen;
      * the example's command line (examples/llama_8b_int8_serve.yaml:
        --checkpoint --num-slots 4 --max-seq-len 2048 --quantize int8
        --spec-decode 4, --tokenizer when one was written) through
        run_server_entry.
    A finally removes the directory."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    from skypilot_tpu_torch.infer import engine as engine_lib
    from skypilot_tpu_torch.infer import server as server_lib
    from skypilot_tpu_torch.models import quant, weights
    res = {'card': card}
    d = tempfile.mkdtemp(prefix='skyt_ckpt_')
    try:
        weight_bytes = sum(t.numel() * t.element_size()
                           for t in model.state_dict().values())
        free = shutil.disk_usage(d).free
        src = model
        if free < CKPT_DISK_MARGIN * weight_bytes:
            per_layer = weight_bytes / model.cfg.n_layers
            n = int(free / CKPT_DISK_MARGIN / per_layer) - 2
            assert n >= 1, f'{free / 2**30:.1f} GiB free holds no layer'
            src = cut_model(model, n)
            _log(f'checkpoint: {free / 2**30:.1f} GiB free under {d} holds '
                 f'{n} of {model.cfg.n_layers} layers: the checkpoint is '
                 f'llama3-8b at full width cut to {n} layers')
        res.update({'disk_free_gib': free / 2**30,
                    'n_layers': src.cfg.n_layers})
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n_bytes = weights.save_hf_checkpoint(src.cfg, src.state_dict(), d)
        res['write_s'] = time.perf_counter() - t0
        res['bytes'] = n_bytes
        res['tokenizer'] = ckpt_tokenizer(d)
        _log(f'checkpoint write [{card}]: {n_bytes} bytes '
             f'({n_bytes / 2**30:.2f} GiB, {src.cfg.n_layers} layers) in '
             f'{res["write_s"]:.2f} s to {d} ({free / 2**30:.1f} GiB '
             f'free before); tokenizer.json '
             f'{"written" if res["tokenizer"] else "not written (no tokenizers package)"}')

        rng = np.random.default_rng(SEED + 60)
        vocab = model.cfg.vocab_size
        prompt = rng.integers(1, vocab, CKPT_PROMPT).tolist()
        toks = torch.as_tensor([prompt], device='cuda')
        with torch.inference_mode():
            mem_logits = kernel_last_logits(src, toks)
        ref_eng = engine_lib.InferenceEngine(
            src, num_slots=8, max_seq_len=2048, decode_chunk=16,
            page_size=64, device=torch.device('cuda'))
        ref_eng.start()
        try:
            ref_stream = ref_eng.generate(prompt, engine_lib.SamplingParams(
                max_new_tokens=CKPT_NEW))
        finally:
            ref_eng.stop()
        del ref_eng
        gc.collect()
        torch.cuda.empty_cache()

        loads = []
        modes = {}
        for mode in ('none',) + CKPT_QUANT:
            label = 'bf16' if mode == 'none' else mode
            with timed_loads(loads):
                eng = server_lib.build_engine(
                    checkpoint=d, num_slots=8, max_seq_len=2048,
                    page_size=64, quantize=mode, dtype=src.cfg.dtype)
            out = dict(loads[-1])
            _log(f'checkpoint load {label} [{card}]: {out["load_s"]:.2f} s, '
                 f'peak {out["peak_gib"]:.2f} GiB over the allocation '
                 f'before it, {out["resident_gib"]:.2f} GiB resident')
            with torch.inference_mode():
                got = kernel_last_logits(eng.model, toks)
            if mode == 'none':
                assert same_bits(got, mem_logits), \
                    'bf16 round trip: logits differ from the model\'s'
                out['logits_bit_equal'] = True
            else:
                codes = {}
                for name in CKPT_CODES_OF:
                    w = src.get_submodule(name).weight
                    qd, sd = quant.quantize_weight(w, mode)
                    qc, sc = quant.quantize_weight(w.cpu(), mode)
                    loaded = eng.model.get_submodule(name)
                    codes[name] = {
                        'card_vs_cpu': same_bits(qd, qc) and
                        same_bits(sd, sc),
                        'loaded_vs_card': same_bits(loaded.weight, qd) and
                        same_bits(loaded.scale, sd)}
                    assert all(codes[name].values()), (mode, name,
                                                       codes[name])
                out['codes_byte_equal'] = codes
                out['logits'] = check_logits(eng.model, prompt,
                                             label=f'checkpoint {mode}')
                out['rel_vs_bf16'] = rel_l2(got, mem_logits)
                _log(f'checkpoint {mode} [{card}]: codes made on the card '
                     f'byte-equal to the CPU quantizer\'s and to the '
                     f'loaded engine\'s on {", ".join(CKPT_CODES_OF)}; '
                     f'last logits rel L2 vs bf16 {out["rel_vs_bf16"]:.4e}')
            out.update(ckpt_serve(eng, prompt, rng, card, label))
            if mode == 'none':
                assert out['tokens'] == ref_stream, \
                    (out['tokens'], ref_stream)
                out['stream_equal'] = True
            del out['tokens']
            modes[label] = out
            del eng
            gc.collect()
            torch.cuda.empty_cache()
        res['modes'] = modes
        res['entry'] = run_server_entry(
            card, argv=('--checkpoint', d, '--num-slots', '4',
                        '--max-seq-len', '2048', '--quantize', 'int8',
                        '--spec-decode', '4') +
            (('--tokenizer', d) if res['tokenizer'] else ()),
            text=res['tokenizer'])
        assert res['entry']['model_id'] == os.path.basename(d), res['entry']
    finally:
        shutil.rmtree(d, ignore_errors=True)
    return res


# A spec engine on pages that the kernel's 16-row TMA boxes do not
# divide: 24 tokens (one 32-row box, its last 8 rows past the page).
ODD_PAGE = 24
# Output-head scales for the greedy-agreement check (not powers of two,
# which would scale every logit exactly).
HEAD_SCALES = (1.0, 3.0, 10.0)


def run_odd_pages(model, card):
    """A spec_decode=3 engine at ODD_PAGE-token pages on the same model
    serves the spec traffic (every request returns its tokens, the verify
    kernel launches), then step checks at pages the tiles do not divide:
    a verify step at 24, a decode step at 8 (bf16) and at 80 (int8: a
    64-row tile and a 16-row last box)."""
    import numpy as np
    import torch
    from skypilot_tpu_torch.infer import engine as engine_lib
    eng = engine_lib.InferenceEngine(
        model, num_slots=8, max_seq_len=2048, decode_chunk=16,
        page_size=ODD_PAGE, spec_decode=3)
    burst, params, lone = traffic(model.cfg.vocab_size, repeat=True)
    warm_up(eng, np.random.default_rng(SEED + 2))
    outs, launches, _, _ = serve(eng, burst, params, lone)
    perf = eng.perf_stats()
    assert launches['paged_decode_mq'] > 0, launches
    assert perf['spec_verify_steps'] > 0, 'no verify step'
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    res = {'launches': launches, 'verify_steps': perf['spec_verify_steps'],
           'spec_accept_per_step': perf.get('spec_accept_per_step'),
           'step_rel_kernel_plain': {
               'verify_p24': check_step(model, False, 4, page=24)['rel'],
               'decode_p8': check_step(model, False, 1, page=8)['rel'],
               'decode_int8_p80': check_step(model, True, 1,
                                             page=80)['rel']}}
    _log(f'engine spec at {ODD_PAGE}-token pages [{card}]: {len(outs)} '
         f'requests x {MAX_NEW} tokens; launches {launches}; '
         f'{perf["spec_verify_steps"]} verify steps; step logits kernel vs '
         f'plain (rel L2) {res["step_rel_kernel_plain"]}')
    return res


def check_agreement(model):
    """Greedy agreement of the decode (s = 1) and verify (s = 4) steps
    with the output head scaled by each of HEAD_SCALES: argmax through
    the kernels, through their plain versions and through the plain
    attention in f32 (check_step, exact=True), and the f32 step's top-2
    margins where the others differ from it. Logged and returned, not
    asserted. The model's head is restored after."""
    import torch
    w = model.lm_head.weight
    keep = w.detach().clone()
    res = {}
    try:
        for scale in HEAD_SCALES:
            with torch.no_grad():
                w.copy_((keep.float() * scale).to(w.dtype))
            for s in (1, 4):
                r = check_step(model, False, s, exact=True)
                r.pop('logits')
                res[f'x{scale:g}_s{s}'] = r
                _log(f'agreement, head x{scale:g}, s={s}: argmax kernel = '
                     f'plain {r["agree"]:.3f}, kernel = f32 '
                     f'{r["agree_kernel_f32"]:.3f}, plain = f32 '
                     f'{r["agree_plain_f32"]:.3f} over {r["positions"]} '
                     f'positions; rel L2 kernel vs f32 '
                     f'{r["rel_kernel_f32"]:.3e}, plain vs f32 '
                     f'{r["rel_plain_f32"]:.3e}; f32 top-2 margin (logit '
                     f'std units) median {r["margin_median"]:.3f}, where '
                     f'the kernel differs {r["margins_kernel_differs"]}, '
                     f'where plain differs {r["margins_plain_differs"]}')
    finally:
        with torch.no_grad():
            w.copy_(keep)
    return res


# ----------------------------------------------------------- phase 3: Gemma
# gemma-7b at full width (28 layers, dim 3072, 16 q / 16 kv heads,
# head_dim 256, GeGLU mlp 24576, vocab 256000, tied embeddings; the JAX
# preset llama.py:207), random bf16 weights from SEED, with llama3-8b's
# engine settings and traffic (8 slots, max_seq_len 2048, page 64; the
# burst packed into one [1, 2048] prefill, the lone 300-token prompt):
# one model through four engines, bf16, int8 KV, spec_decode=3 and both.
# Then gemma-2b (18 layers, dim 2048, 8 q heads on 1 kv head; :198) with
# spec_decode=3: its verify steps run paged_decode_mq at T*G = 4*8 = 32
# query rows a kv head.
GEMMA7B = 'gemma-7b'
GEMMA2B = 'gemma-2b'


def run_gemma(card):
    """Serve gemma-7b (four engines) and gemma-2b (spec) on the card;
    every request returns its tokens, the launch counters (0 just before
    each run) show the head_dim-256 flash forward and each paged kernel
    on its path and 32-row verify launches on gemma-2b, and prefill,
    decode-step and verify-step logits match the plain path."""
    import numpy as np
    import torch
    from skypilot_tpu_torch.infer import server
    from skypilot_tpu_torch.ops import paged_attention as pa
    res = {}
    for name, opts in ((GEMMA7B, {}), (GEMMA2B, {'spec_decode': 3})):
        t0 = time.perf_counter()
        eng = server.build_engine(name, seed=SEED, **opts)
        torch.cuda.synchronize()
        cfg = eng.model.cfg
        _log(f'build_engine({name!r}, {opts}): '
             f'{cfg.num_params() / 1e9:.2f}B params, head_dim '
             f'{cfg.head_dim}, {cfg.n_heads} q / {cfg.n_kv_heads} kv heads, '
             f'{time.perf_counter() - t0:.1f}s; paged pool '
             f'{list(eng.cache["k"].shape)} {eng.cache["k"].dtype}')
        spec = bool(opts)
        burst, params, lone = traffic(cfg.vocab_size, repeat=spec)
        cold_s = warm_up(eng, np.random.default_rng(SEED + 2))
        outs, launches, burst_ttft, lone_s = serve(eng, burst, params, lone)
        by_rows = {f'{k}/{r}': n for (k, r), n in
                   sorted(pa.launches_by_rows.items())}
        perf = eng.perf_stats()
        kernel = 'paged_decode_mq' if spec else 'paged_decode'
        assert launches['flash_fwd'] > 0, f'{name}: flash never launched'
        assert launches[kernel] > 0, f'{name}: {kernel} never launched'
        lone_ttft = eng.ttfts()[-1]
        ms_tok = (lone_s - lone_ttft) / (MAX_NEW - 1) * 1e3
        _log(f'engine {name} [{card}]: {len(outs)} requests x {MAX_NEW} '
             f'tokens; launches {launches}; paged launches by query rows a '
             f'kv head {by_rows}; warm-up request {cold_s:.2f} s; burst '
             f'TTFT max {burst_ttft * 1e3:.1f} ms; lone TTFT '
             f'{lone_ttft * 1e3:.1f} ms, then {ms_tok:.1f} ms per token; '
             f'steady decode {perf.get("steady_decode_tok_s", 0):.1f} tok/s'
             + (f'; spec_accept_per_step '
                f'{perf.get("spec_accept_per_step", 0):.3f} over '
                f'{perf["spec_verify_steps"]} verify steps' if spec else ''))
        if spec:
            assert by_rows.get('paged_decode_mq/32', 0) > 0, by_rows
        run = {'launches': launches, 'launches_by_rows': by_rows,
               'warmup_request_s': cold_s, 'burst_ttft_max_s': burst_ttft,
               'lone_ttft_s': lone_ttft, 'lone_ms_per_token': ms_tok,
               'steady_decode_tok_s': perf.get('steady_decode_tok_s'),
               'perf': perf}
        model = eng.model
        del eng
        gc.collect()
        torch.cuda.empty_cache()
        run['logits'] = check_logits(model, lone, f'{name} lone')
        run['step_rel_kernel_plain'] = check_step(model, False,
                                                  4 if spec else 1)['rel']
        if not spec:
            res['paths'] = run_paths(model, card, ms_tok)
        res[name] = run
        del model
        gc.collect()
        torch.cuda.empty_cache()
    return res


def time_d256(gen):
    """Phase 4 at head_dim 256: the flash forward on gemma-7b's packed
    burst row, its lone row and gemma-2b's packed row (SDPA's causal
    forward beside it), the four paged kernels at gemma-7b's and
    gemma-2b's decode shapes."""
    seg = packed_segments(BURST, 64, 2048)
    res = {'flash_gemma7b_packed': time_flash(gen, 2048, seg, 16, 16, 256),
           'flash_gemma7b_lone': time_flash(gen, 512, None, 16, 16, 256),
           'flash_gemma2b_packed': time_flash(gen, 2048, seg, 8, 1, 256)}
    for shape in ('gemma7b', 'gemma2b'):
        for k in PAGED_KERNELS:
            res[f'{k}_{shape}'] = time_paged(gen, k, shape)
    return res


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


def plain_step_logits(model, toks, positions, cache, lora=None,
                      exact=False):
    """The model's paged step (s tokens per slot) with each paged kernel's
    plain version in its place (and the LoRA plain versions, lora: None or
    (stack, ids [B])); the same appends, in place on `cache`. exact: the
    plain attention computed from f32 copies of q and the pools, its
    output rounded to the model dtype."""
    import torch
    from skypilot_tpu_torch.ops import rope
    cfg = model.cfg
    x = embed(model, toks)
    cos, sin = rope.rope_freqs(positions, cfg.head_dim, cfg.rope_theta,
                               use_llama31_scaling=cfg.use_llama31_rope)
    pos = positions[:, 0].to(torch.int32).contiguous()
    tables = cache['tables']
    for i in range(len(model.layers)):
        def attend(q, k, v, i=i):
            return paged_plain(cache, i, q, k, v, tables, pos, exact)
        x = plain_block(model, i, x, cos, sin, attend, lora)
    return head(model, model.final_norm(x)).float()


def paged_plain(cache, i, q, k, v, tables, pos, exact=False):
    """Layer i's appends (in place on `cache`) and the paged kernels'
    plain versions: [B, S, Hq, d] (exact: from f32 copies of q and the
    pools)."""
    from skypilot_tpu_torch.infer.paged_cache import PagePool
    from skypilot_tpu_torch.ops import paged_attention as pa
    s = q.shape[1]
    kp, vp = cache['k'][i], cache['v'][i]
    if exact:
        q = q.float()
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
    if exact:
        kp, vp = kp.float(), vp.float()
    if s == 1:
        return pa.paged_decode_attention_reference(
            q[:, 0], kp, vp, tables, pos)[:, None]
    return pa.paged_decode_attention_mq_reference(q, kp, vp, tables, pos)


# A fixed prefilled cache: four live slots of these prompt lengths, four
# released slots (all-zero rows) at these stale lengths.
STEP_LIVE = (600, 64, 590, 300)
STEP_FREED = (1000, 5, 2040, 77)


def check_step(model, quant, s, lora=None, page=64, exact=False):
    """One paged step of s tokens per slot (s = 1: decode; s = 4: verify)
    on a fixed prefilled cache (bf16 or int8 pools of `page`-token
    pages), through the kernels (the model's forward) and through their
    plain versions (the same layers by hand): rel L2 of the live slots'
    logits <= LOGIT_REL_L2. With a LoRA stack the slots take SLOT_LORA's
    adapters (the gather kernel) and the step also runs without the
    stack: an adapter slot's logits must move by more than LOGIT_REL_L2,
    an id-0 slot's not at all (its rows add nothing). exact: the step also
    runs with the plain attention in f32 (plain_step_logits), and the
    argmax agreements and top-2 margins of the three are returned."""
    import numpy as np
    import torch
    from skypilot_tpu_torch.infer.paged_cache import PagePool
    cfg = model.cfg
    dev = next(model.parameters()).device
    mp = max(32, -(-(max(STEP_LIVE) + s) // page))
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
        exact_cache = {k: v.clone() for k, v in cache.items()} \
            if exact else None
        got, _ = model(toks, positions=positions, cache=cache, **kw)
        ref = plain_step_logits(model, toks, positions, copy, plain_lora)
        if exact:
            f32 = plain_step_logits(model, toks, positions, exact_cache,
                                    exact=True)
        if lora is not None:
            base, _ = model(toks, positions=positions, cache=base_cache)
        torch.cuda.synchronize()
    live = len(STEP_LIVE)
    got, ref = got[:live].float(), ref[:live]
    assert torch.isfinite(got).all(), 'non-finite step logits'
    r = rel_l2(got, ref)
    agree = float((got.argmax(-1) == ref.argmax(-1)).float().mean())
    label = ('int8' if quant else 'bf16') + (' + LoRA' if lora else '') + \
        (f', {page}-token pages' if page != 64 else '')
    _log(f'{label} paged step s={s}: logits kernel vs '
         f'plain rel L2 {r:.3e} (limit {LOGIT_REL_L2}), argmax equal '
         f'{agree:.3f}')
    assert r <= LOGIT_REL_L2, r
    res = {'rel': r, 'logits': got, 'agree': agree}
    if exact:
        f32 = f32[:live]
        top = f32.topk(2, dim=-1).values
        # The f32-attention step's top-1 - top-2 gap at each position,
        # in units of its logits' std.
        margin = (top[..., 0] - top[..., 1]) / f32.std(dim=-1)
        am, ar, ae = got.argmax(-1), ref.argmax(-1), f32.argmax(-1)
        res.update({
            'positions': am.numel(),
            'agree_kernel_f32': float((am == ae).float().mean()),
            'agree_plain_f32': float((ar == ae).float().mean()),
            'rel_kernel_f32': rel_l2(got, f32),
            'rel_plain_f32': rel_l2(ref, f32),
            'margins_kernel_differs': margin[am != ae].tolist(),
            'margins_plain_differs': margin[ar != ae].tolist(),
            'margin_median': float(margin.median())})
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
def time_flash(gen, s, seg_np=None, hq=32, hkv=8, d=128):
    import numpy as np
    import torch
    import torch.nn.functional as F
    from skypilot_tpu_torch.ops import flash_attention as fa
    q, k, v = flash_inputs(gen, s, hq, hkv, d)
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


def time_paged(gen, kname, shape='slice'):
    """One of PAGED_KERNELS (kernel 2 or 3-5) at the decode
    shapes of PAGED_SHAPES[shape]. The bound counts each visible K/V row
    (and its scales) once, q and out once, and 4*d flops per query head
    and visible (token, key) pair."""
    from skypilot_tpu_torch.ops import paged_attention as pa
    fn, t, quant, _ = PAGED_KERNELS[kname]
    args = paged_inputs(gen, t, quant, shape)
    wrapper = getattr(pa, fn)
    plain = getattr(pa, fn + '_reference')
    ms = time_ms(lambda: wrapper(*args), 50)
    launch_ms = eager_ms(lambda: wrapper(*args), 50)
    # One launch a call, the merge folded in.
    parts = device_ms_by_kernel(lambda: wrapper(*args),
                                ('paged_decode_verify',))
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
            'profiler_ms': parts['paged_decode_verify'],
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
    plan = lora_ops.lora_plan(bsz * s, din, r, dout, a.shape[0], False,
                              torch.cuda.get_device_properties(
                                  0).multi_processor_count)
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
            'adapted_tokens': adapted, 'distinct_adapters': distinct,
            'plan': plan._asdict()}


# Kernels 6-7 timed at these LORA_CASES shapes; the first of each kernel
# goes into the {"kernels": [...]} line.
LORA_TIMED = ('gather_decode', 'gather_decode_down', 'gather_verify',
              'gather_lone', 'grouped_burst', 'gather_decode_r256',
              'gather_decode_sparse')


# ----------------------------------------------------------- phase 3: train
# sft at its own defaults on llama3-1b (16 layers, dim 2048, 32 q / 8 kv
# heads, head_dim 64, vocab 128256, tied; f32 masters, bf16 compute,
# remat 'full'): 6 steps of batch 8 x 2048.
SFT_MODEL = 'llama3-1b'
SFT_ARGV = ['--model', SFT_MODEL, '--batch', '8', '--seq', '2048',
            '--steps', '6', '--log-every', '2', '--prefetch', '2']
# Gemma training: sft on gemma-2b at full width (18 layers, dim 2048, 8 q
# heads on 1 kv head, head_dim 256, GeGLU mlp 16384, vocab 256000, tied)
# at the largest of these batches that fits: sft's default of 8 need not,
# as the loss's f32 logits of [8 x 2048, 256000] (15.6 GiB, one of
# several such copies) sit beside 40 GB of masters, gradients and AdamW
# moments.
GEMMA_SFT_BATCHES = (8, 4, 2)


def gemma_sft_argv(batch):
    return ['--model', GEMMA2B, '--batch', str(batch), '--seq', '2048',
            '--steps', '6', '--log-every', '2', '--prefetch', '2']
GRAD_REL_L2 = 5e-2
LOSS_ABS = 1e-2


def run_train(card, argv=SFT_ARGV):
    """sft.main(argv) on the card. The flash launch counters are set to 0
    just before and read just after: per step 2 * layers forward launches
    (every block, then again in the remat recompute) and one backward
    launch a block (llama3-1b: 32 and 16). Every step's loss must be
    finite, and the first logged one within 1.5 of ln(vocab) (random
    weights predict a near-uniform distribution)."""
    import torch
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.ops import flash_attention as fa
    from skypilot_tpu_torch.train import sft
    model = argv[argv.index('--model') + 1]
    cfg = llama.CONFIGS[model]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    t0 = time.perf_counter()
    out = sft.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {'flash_fwd': fa.launches, 'flash_bwd': fa.launches_bwd}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    steps = out['steps']
    want = {'flash_fwd': (2 if cfg.remat else 1) * cfg.n_layers * steps,
            'flash_bwd': cfg.n_layers * steps}
    losses = out['losses']
    last = out['logs'][-1]
    ln_v = math.log(cfg.vocab_size)
    _log(f'sft {" ".join(argv)} [{card}]: {steps} steps in '
         f'{wall:.1f} s (model build included); losses '
         + ', '.join(f'{x:.4f}' for x in losses)
         + f' (ln vocab {ln_v:.4f}); logged '
         + ', '.join(f'step {g["step"]}: loss {g["loss"]:.4f} grad_norm '
                     f'{g["grad_norm"]:.3f} step {g["step_time_s"]:.3f} s'
                     for g in out['logs']))
    mfu = 'n/a' if last['mfu'] is None else f'{last["mfu"]:.4f}'
    _log(f'sft {model} [{card}]: last window {last["step_time_s"]:.4f} '
         f's/step, {last["window_tokens_per_sec"]:.0f} tokens/s, MFU {mfu} '
         f'of 989 TFLOP/s ({out["flops_per_step"]:.4e} FLOPs/step, '
         f'analytic); peak memory {peak_gib:.2f} GiB; launches {launches} '
         f'(want {want})')
    assert all(math.isfinite(x) for x in losses), losses
    assert abs(out['logs'][0]['loss'] - ln_v) <= 1.5, out['logs'][0]
    assert launches == want, (launches, want)
    return {'model': model, 'argv': argv, 'launches': launches,
            'steps': steps, 'losses': losses,
            'logs': out['logs'], 'wall_s': wall, 'peak_gib': peak_gib,
            'step_time_s': last['step_time_s'],
            'tokens_per_sec': last['window_tokens_per_sec'],
            'mfu': last['mfu'], 'flops_per_step': out['flops_per_step']}


def _flat_grads(model):
    return [p.grad.float() for p in model.parameters()]


def check_train_grads(card, cfg=None, seq=2048, label=SFT_MODEL,
                      batch_seed=SEED + 5):
    """One full-width step's gradients at batch 1 x seq through the
    kernels against the same weights (seed SEED) and batch with
    attn_impl='xla' (the plain attention, differentiated by autograd):
    rel L2 of the flattened gradient <= GRAD_REL_L2, losses within
    LOSS_ABS. cfg: the model (default the sft preset). The flash
    counters are set to 0 before the kernels' step and returned."""
    import dataclasses
    import torch
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.ops import flash_attention as fa
    from skypilot_tpu_torch.train import sft, trainer
    dev = torch.device('cuda')
    cfg = cfg or llama.CONFIGS[SFT_MODEL]
    batch = next(sft.synthetic_batches(cfg.vocab_size, 1, seq,
                                       seed=batch_seed))
    tb = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    losses, grads = {}, {}
    for impl in ('xla', 'auto'):
        model = llama.LlamaModel(dataclasses.replace(cfg, attn_impl=impl),
                                 device='meta').to_empty(device=dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(SEED)
        model.init_weights(gen)
        fa.reset_launches()
        loss, _ = trainer.cross_entropy_loss(model(tb['tokens']),
                                             tb['targets'])
        loss.backward()
        losses[impl] = loss.item()
        grads[impl] = _flat_grads(model)
        del model, loss
    launches = {'flash_fwd': fa.launches, 'flash_bwd': fa.launches_bwd}
    num = den = 0.0
    for a, b in zip(grads['auto'], grads['xla']):
        num += float((a - b).square().sum())
        den += float(b.square().sum())
    torch.cuda.synchronize()
    del grads
    gc.collect()
    torch.cuda.empty_cache()
    res = {'rel_l2': math.sqrt(num / den), 'loss_flash': losses['auto'],
           'loss_xla': losses['xla'], 'grad_norm_xla': math.sqrt(den),
           'launches': launches, 'seq': seq}
    _log(f'grad check [{card}] {label} 1 x {seq}: flattened gradient '
         f'kernels vs attn_impl=xla rel L2 {res["rel_l2"]:.3e} (limit '
         f'{GRAD_REL_L2}); loss {res["loss_flash"]:.5f} vs '
         f'{res["loss_xla"]:.5f} (limit {LOSS_ABS}); |g| '
         f'{res["grad_norm_xla"]:.4f}; launches {launches}')
    assert math.isfinite(res['rel_l2']) and res['rel_l2'] <= GRAD_REL_L2, res
    assert abs(res['loss_flash'] - res['loss_xla']) <= LOSS_ABS, res
    return res


def check_mistral_grads(card, seq=6144):
    """check_train_grads through two layers of mistral-7b at full width
    (window 4096; f32 masters, bf16 compute, remat) at 1 x seq: the
    windowed forward and backward kernels against the plain attention.
    The backward kernel must launch once per layer."""
    import dataclasses
    from skypilot_tpu_torch.models import llama
    cfg = dataclasses.replace(llama.CONFIGS[MISTRAL], n_layers=2)
    res = check_train_grads(
        card, cfg, seq, f'{MISTRAL} (2 layers, window '
        f'{cfg.sliding_window})', SEED + 6)
    assert res['launches']['flash_bwd'] == cfg.n_layers, res['launches']
    return res


def run_gemma_train(card):
    """run_train on gemma-2b at the largest batch of GEMMA_SFT_BATCHES
    that fits on the card (a batch that does not runs out of memory in
    its first step, and its error is kept)."""
    import torch
    oom = {}
    for batch in GEMMA_SFT_BATCHES:
        try:
            res = run_train(card, gemma_sft_argv(batch))
        except torch.OutOfMemoryError as e:
            oom[batch] = str(e).split('\n')[0][:400]
            _log(f'sft {GEMMA2B} batch {batch} [{card}]: out of memory: '
                 f'{oom[batch]}')
        else:
            res.update({'batch': batch, 'out_of_memory': oom})
            return res
        # Out of the handler, the failed run's frames are freed.
        gc.collect()
        torch.cuda.empty_cache()
    raise RuntimeError(f'{GEMMA2B} sft fits at none of {GEMMA_SFT_BATCHES}')


def check_gemma_grads(card, seq=2048):
    """check_train_grads through two layers of gemma-7b at full width
    (head_dim 256, 16 q / 16 kv heads, GeGLU, 1 + w norms, embedding
    scale, tied; f32 masters, bf16 compute, remat) at 1 x seq: the
    head_dim-256 forward and backward kernels against the plain
    attention. The backward kernel must launch once per layer."""
    import dataclasses
    from skypilot_tpu_torch.models import llama
    cfg = dataclasses.replace(llama.CONFIGS[GEMMA7B], n_layers=2)
    res = check_train_grads(card, cfg, seq, f'{GEMMA7B} (2 layers)',
                            SEED + 7)
    assert res['launches']['flash_bwd'] == cfg.n_layers, res['launches']
    return res


def _capture_steps(real, box, preempt_after=None):
    """A stand-in for trainer.make_train_step (`real`) whose step
    functions keep the last state they returned in box['state'], and
    with preempt_after=n send this process SIGTERM after the n-th step,
    as a spot preemption would (sft's guard then saves a checkpoint at
    that step boundary and exits 75)."""
    import signal

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


def check_sft_resume(card):
    """sft.main on llama3-1b at 2 x 2048: a 4-step run preempted (SIGTERM)
    after step 2, which saves and exits 75, then resumed to step 4, must
    end in the same bits as an unbroken 4-step run: every parameter and
    AdamW moment, and the steps 3-4 losses (asserted). sft restarts its
    data stream on resume, as the JAX sft does, so both runs read a JSONL
    file of exactly two batches of tokens: every run sees batches 0, 1,
    0, 1. The deterministic-algorithms setting is the same after each
    sft.main (returned or exited) as before it."""
    import shutil
    import numpy as np
    import torch
    from skypilot_tpu_torch.train import sft, trainer
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           'smoke_out', 'resume')
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    b, seq = 2, 2048
    rng = np.random.default_rng(SEED + 12)
    data = os.path.join(out_dir, 'two_batches.jsonl')
    with open(data, 'w') as f:
        # One row plus its 0 separator: 2 x b x (seq + 1) tokens.
        f.write(json.dumps({'tokens': rng.integers(
            1, 128256, 2 * b * (seq + 1) - 1).tolist()}) + '\n')
    argv = ['--model', SFT_MODEL, '--batch', str(b), '--seq', str(seq),
            '--steps', '4', '--log-every', '1', '--data', data]
    ckpt = ['--checkpoint-dir', os.path.join(out_dir, 'ckpt')]
    before = torch.are_deterministic_algorithms_enabled()
    real = trainer.make_train_step
    finals, code = [], None
    try:
        for run in ('unbroken', 'preempted', 'resumed'):
            box = {}
            trainer.make_train_step = _capture_steps(
                real, box, 2 if run == 'preempted' else None)
            try:
                out = sft.main(argv + ([] if run == 'unbroken' else ckpt))
            except SystemExit as e:
                assert run == 'preempted', run
                code = e.code
            assert torch.are_deterministic_algorithms_enabled() == before
            if run != 'preempted':
                finals.append((out, box['state']))
            del box
    finally:
        trainer.make_train_step = real
    assert code == 75, code
    (unbroken, sa), (resumed, sb) = finals
    assert resumed['start_step'] == 2 and sa.step == sb.step == 4, \
        (resumed['start_step'], sa.step, sb.step)
    a = list(sa.model.state_dict().items())
    bb = list(sb.model.state_dict().values())
    oa, ob = sa.optimizer.state_dict(), sb.optimizer.state_dict()
    for i in oa['state']:
        for key in ('exp_avg', 'exp_avg_sq'):
            a.append((f'optimizer/{i}/{key}', oa['state'][i][key]))
            bb.append(ob['state'][i][key])
    differ = [k for (k, x), y in zip(a, bb) if not torch.equal(x, y)]
    losses_equal = unbroken['losses'][2:] == resumed['losses']
    res = {'unbroken_losses': unbroken['losses'],
           'resumed_losses': resumed['losses'], 'tensors': len(a),
           'tensors_differing': len(differ), 'preempt_exit': code}
    _log(f'sft resume [{card}] {SFT_MODEL} {b} x {seq} (sft runs with '
         f'deterministic algorithms on): preempted after step 2 (exit '
         f'{code}), resumed to step 4; {len(a)} parameter and moment '
         f'tensors, {len(differ)} differ from the unbroken run\'s; steps '
         f'3-4 losses unbroken {unbroken["losses"][2:]} vs resumed '
         f'{resumed["losses"]} (bit-equal {losses_equal})')
    assert not differ, differ[:5]
    assert losses_equal, res
    del finals, sa, sb, a, bb, oa, ob
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(out_dir, ignore_errors=True)
    return res


def time_sft_ordered(card, steps=3):
    """sft's step with the backward's dq adds ordered (deterministic
    algorithms on, as sft.main runs) and unordered, in turns on one
    model: llama3-1b at 8 x 2048, `steps` steps per turn after a warm-up,
    on, off, on, off; s/step per turn (host clock around synchronised
    steps)."""
    import torch
    from skypilot_tpu_torch.train import sft, trainer
    dev = torch.device('cuda')
    model = sft.build_model(SFT_MODEL, 'auto', dev, seed=SEED)
    tx = trainer.make_optimizer(trainer.TrainerConfig())
    state = trainer.create_state(model, tx)
    step_fn = trainer.make_train_step(model, tx)
    data = sft.synthetic_batches(model.cfg.vocab_size, 8, 2048, seed=SEED)
    batch = {k: torch.as_tensor(v, device=dev) for k, v in next(data).items()}
    turns = {'ordered': [], 'unordered': []}
    with deterministic_algorithms(True):
        for _ in range(2):
            state, _ = step_fn(state, batch)
    for ordered in (True, False, True, False):
        with deterministic_algorithms(ordered):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(steps):
                state, _ = step_fn(state, batch)
            torch.cuda.synchronize()
            turns['ordered' if ordered else 'unordered'].append(
                (time.perf_counter() - t0) / steps)
    del state, model, step_fn
    gc.collect()
    torch.cuda.empty_cache()
    res = dict(turns)
    res['cost_s'] = (sum(turns['ordered']) - sum(turns['unordered'])) / 2
    _log(f'sft step {SFT_MODEL} 8 x 2048 [{card}]: ordered dq adds '
         + ', '.join(f'{t:.4f}' for t in turns['ordered'])
         + ' s/step vs unordered '
         + ', '.join(f'{t:.4f}' for t in turns['unordered'])
         + f' (turns on, off, on, off): cost {res["cost_s"] * 1e3:.1f} '
         'ms/step')
    return res


def check_checkpoint(card, seq=128, exact=True):
    """Save and resume on the card with a small bf16 config (head_dim 64,
    so attention runs the flash kernels) on batches of 2 x seq tokens: 2
    steps, save, restore into a fresh state (the restored parameters and
    moments equal the saved ones bit for bit), then 2 more steps from
    both; the resumed run's losses and parameters match the unbroken
    one's (only logged when not exact)."""
    import shutil
    import torch
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.train import checkpoint as ckpt_lib
    from skypilot_tpu_torch.train import sft, trainer
    dev = torch.device('cuda')
    cfg = llama.LlamaConfig(vocab_size=512, dim=256, n_layers=2, n_heads=4,
                            n_kv_heads=2, mlp_dim=512,
                            max_seq_len=max(256, seq))
    tcfg = trainer.TrainerConfig(warmup_steps=1, total_steps=8)

    def fresh():
        model = llama.LlamaModel(cfg, device=dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(SEED)
        model.init_weights(gen)
        tx = trainer.make_optimizer(tcfg)
        return trainer.create_state(model, tx), \
            trainer.make_train_step(model, tx)
    data = sft.synthetic_batches(cfg.vocab_size, 2, seq, seed=SEED + 9)
    batches = [{k: torch.as_tensor(v, device=dev)
                for k, v in next(data).items()} for _ in range(4)]
    ck_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          'smoke_out', 'ckpt')
    shutil.rmtree(ck_dir, ignore_errors=True)
    state, step_fn = fresh()
    for b in batches[:2]:
        state, _ = step_fn(state, b)
    ckpt = ckpt_lib.Checkpointer(ck_dir, save_interval_steps=2)
    assert ckpt.save(2, state)
    ckpt.wait()
    resumed, step_fn2 = fresh()
    assert ckpt.restore(resumed) is resumed and resumed.step == 2
    same = all(torch.equal(a, b) for a, b in zip(
        state.model.state_dict().values(),
        resumed.model.state_dict().values()))
    sa, sb = state.optimizer.state_dict(), resumed.optimizer.state_dict()
    same = same and all(torch.equal(sa['state'][i][key].cpu(),
                                    sb['state'][i][key].cpu())
                        for i in sa['state']
                        for key in ('exp_avg', 'exp_avg_sq', 'step'))
    la, lb = [], []
    for b in batches[2:]:
        state, ma = step_fn(state, b)
        resumed, mb = step_fn2(resumed, b)
        la.append(float(ma['loss']))
        lb.append(float(mb['loss']))
    diff = max(float((a.float() - b.float()).abs().max()) for a, b in zip(
        state.model.state_dict().values(),
        resumed.model.state_dict().values()))
    ckpt.close()
    shutil.rmtree(ck_dir, ignore_errors=True)
    _log(f'checkpoint round trip [{card}] 2 x {seq}, deterministic '
         f'algorithms {torch.are_deterministic_algorithms_enabled()}: '
         f'restored state equal to the saved one: {same}; steps 3-4 losses '
         f'unbroken {la} vs resumed {lb}; max |param diff| after step 4 '
         f'{diff:.3e}')
    assert same
    if exact:
        assert all(abs(a - b) <= 1e-5 * abs(a)
                   for a, b in zip(la, lb)), (la, lb)
        assert diff <= 1e-5, diff
    return {'seq': seq, 'restored_equal': same, 'losses_unbroken': la,
            'losses_resumed': lb, 'max_param_diff': diff}


def time_bwd_at(gen, b, s, hq, hkv, d):
    """Kernels 8-9 (one backward kernel) at [b, s, hq, d], hkv kv heads,
    causal: flash_bwd_cuda (the kernel with the zeroing of its f32 dq
    accumulator and the cast to bf16; CUDA graph of calls), also with
    deterministic algorithms on (ordered adds), the zeroing and the cast
    alone, the whole backward (flash_attention_bwd: delta, then
    flash_bwd_cuda) eagerly beside one eager SDPA backward (k/v expanded
    to hq heads; dq, dk and dv; the backend SDPA picked is kept), and the
    plain backward; and kernel 1 at the same shape against its plain
    version and SDPA's forward. Bounds: 4*d flops per visible (q, k) pair and query head for
    the forward, 10*d for the backward (s, dp, dv, dk, dq once each),
    against the bytes each must move once."""
    import torch
    import torch.nn.functional as F
    from skypilot_tpu_torch.ops import flash_attention as fa
    q = torch.randn((b, s, hq, d), generator=gen, device='cuda',
                    dtype=torch.bfloat16)
    k = torch.randn((b, s, hkv, d), generator=gen, device='cuda',
                    dtype=torch.bfloat16)
    v = torch.randn((b, s, hkv, d), generator=gen, device='cuda',
                    dtype=torch.bfloat16)
    out, lse = fa.flash_attention_fwd_lse(q, k, v, causal=True)
    do = torch.randn(out.shape, generator=gen, device='cuda',
                     dtype=torch.bfloat16)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    res = {}
    res['bwd_ms'] = time_ms(lambda: fa.flash_bwd_cuda(
        q, k, v, do, lse, delta, None, True), 10)
    with deterministic_algorithms():
        res['bwd_ordered_ms'] = time_ms(lambda: fa.flash_bwd_cuda(
            q, k, v, do, lse, delta, None, True), 10)
        res['bwd_ordered_eager_ms'] = eager_ms(lambda: fa.flash_attention_bwd(
            q, k, v, out, lse, do, causal=True), 10)
    acc = torch.zeros(q.shape, dtype=torch.float32, device='cuda')
    res['zero_ms'] = time_ms(lambda: torch.zeros(
        q.shape, dtype=torch.float32, device='cuda'), 10)
    res['cast_ms'] = time_ms(lambda: acc.to(torch.bfloat16), 10)
    del acc
    res['bwd_eager_ms'] = eager_ms(lambda: fa.flash_attention_bwd(
        q, k, v, out, lse, do, causal=True), 10)
    res['plain_ms'] = time_ms(lambda: fa.flash_attention_bwd_reference(
        q, k, v, out, lse, do, causal=True), 1, reps=2)
    # The forward kernel at the same shape (the training path's), against
    # SDPA's forward on the same expanded k/v.
    res['fwd_ms'] = time_ms(lambda: fa.flash_attention_fwd_lse(
        q, k, v, causal=True), 10)
    res['fwd_plain_ms'] = time_ms(lambda: fa.flash_attention_reference(
        q, k, v, causal=True), 1, reps=2)
    kx = k.repeat_interleave(hq // hkv, dim=2).transpose(1, 2)
    vx = v.repeat_interleave(hq // hkv, dim=2).transpose(1, 2)
    res['fwd_library_ms'] = time_ms(lambda: F.scaled_dot_product_attention(
        q.transpose(1, 2), kx, vx, is_causal=True), 10)
    qt = q.transpose(1, 2).detach().requires_grad_()
    kt = kx.detach().requires_grad_()
    vt = vx.detach().requires_grad_()
    names = {int(v): k for k, v in
             torch.nn.attention.SDPBackend.__members__.items()}
    backend = int(torch._fused_sdp_choice(qt, kt, vt, None, 0.0, True))
    res['library_backend'] = names.get(backend, str(backend))
    with torch.enable_grad():
        sdpa_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    dot = do.transpose(1, 2)
    res['library_ms'] = eager_ms(lambda: torch.autograd.grad(
        sdpa_out, (qt, kt, vt), dot, retain_graph=True), 10)
    res['ratio_to_library'] = res['bwd_eager_ms'] / res['library_ms']
    pairs = b * hq * s * (s + 1) // 2
    # The backward reads q, k, v, dO, lse and delta and writes dq, dk and
    # dv (bf16); the forward reads q, k, v and writes out and lse.
    ins = 2 * (2 * q.numel() + k.numel() + v.numel()) + 2 * 4 * b * hq * s
    fwd_ins = 2 * (q.numel() + k.numel() + v.numel())
    for name, flops, nbytes in (
            ('fwd', 4.0 * d * pairs, fwd_ins + 2 * q.numel() + 4 * b * hq * s),
            ('bwd', 10.0 * d * pairs,
             ins + 2 * (q.numel() + k.numel() + v.numel()))):
        bf = flops / BF16_FLOPS_PER_S * 1e3
        bb = nbytes / HBM_BYTES_PER_S * 1e3
        res[f'{name}_bound_ms'] = max(bf, bb)
        res[f'{name}_bound_by'] = 'operations' if bf >= bb else 'bytes'
        res[f'{name}_flops'] = flops
        res[f'{name}_bytes'] = nbytes
    res['shape'] = [b, s, hq, d]
    res['kv_heads'] = hkv
    res['pairs'] = pairs
    del sdpa_out, qt, kt, vt, kx, vx
    torch.cuda.empty_cache()
    return res


def time_flash_bwd(gen):
    """time_bwd_at at the sft shape [8, 2048, 32, 64], 8 kv heads
    (llama3-1b's attention). Then flash_bwd_cuda alone on the burst's
    packed rows at the same shape and at head_dim 128 ([4, 2048, 32, 128]
    causal, 8 kv heads: llama3-8b's attention)."""
    import numpy as np
    import torch
    from skypilot_tpu_torch.ops import flash_attention as fa
    b, s, hq, hkv, d = 8, 2048, 32, 8, 64
    res = time_bwd_at(gen, b, s, hq, hkv, d)
    # The backward kernel's other variants on the training path's kind of
    # input: packed rows (8 copies of the burst's segments) and head_dim
    # 128.
    seg_np = packed_segments(BURST, 64, s)
    seg = torch.as_tensor(seg_np, device='cuda').expand(b, s).contiguous()
    for name, bb, dd, sg in (('packed', b, d, seg), ('d128', 4, 128, None)):
        q2, k2, v2 = (torch.randn((bb, s, h, dd), generator=gen,
                                  device='cuda', dtype=torch.bfloat16)
                      for h in (hq, hkv, hkv))
        out2, lse2 = fa.flash_attention_fwd_lse(q2, k2, v2, causal=True,
                                                segment_ids=sg)
        do2 = torch.randn(out2.shape, generator=gen, device='cuda',
                          dtype=torch.bfloat16)
        delta2 = (do2.float() * out2.float()).sum(-1).transpose(
            1, 2).contiguous()
        ms = time_ms(lambda: fa.flash_bwd_cuda(
            q2, k2, v2, do2, lse2, delta2, sg, True), 10)
        # Visible pairs: causal within each segment id.
        n_vis = s * (s + 1) // 2 if sg is None else sum(
            int(c) * (int(c) + 1) // 2
            for c in np.unique(seg_np, return_counts=True)[1])
        flops = 10.0 * dd * bb * hq * n_vis
        nbytes = (2 * (3 * q2.numel() + 2 * k2.numel() + 2 * v2.numel())
                  + 2 * 4 * bb * hq * s)
        bf = flops / BF16_FLOPS_PER_S * 1e3
        bb_ms = nbytes / HBM_BYTES_PER_S * 1e3
        res[name] = {'shape': list(q2.shape), 'kv_heads': hkv,
                     'segments': sg is not None, 'ms': ms,
                     'bound_ms': max(bf, bb_ms),
                     'bound_by': 'operations' if bf >= bb_ms else 'bytes'}
        del q2, k2, v2, out2, lse2, do2, delta2
    return res


def band_pairs(s, window):
    """Visible (q, k) pairs of one causal row of s tokens under a window
    (0: none): row p sees min(p + 1, window) keys."""
    w = window if window > 0 else s
    return sum(min(p + 1, w) for p in range(s))


def time_window(gen, s=8192, window=MISTRAL_WINDOW):
    """Kernels 1 and 8-9 with Mistral's window at [1, s, 32, 8, 128]
    causal (a full 8192-token row): the forward kernel and the backward
    kernel (flash_bwd_cuda, also with ordered adds) with the window and
    without it at the same shape, the plain forward and backward with
    the window, and SDPA with a boolean band mask (k/v expanded to 32
    heads; its forward, and its backward eagerly beside the kernel's
    whole backward eagerly), with the backend SDPA picked. Bounds: 4*d
    (forward) and 10*d (backward) flops per query head and visible pair,
    against the bytes each must move once."""
    import torch
    import torch.nn.functional as F
    from skypilot_tpu_torch.ops import flash_attention as fa
    b, hq, hkv, d = 1, 32, 8, 128
    q, k, v = flash_inputs(gen, s, hq, hkv, d)
    res = {'shape': [b, s, hq, d], 'kv_heads': hkv, 'window': window}
    for w, tag in ((window, ''), (0, '_nowindow')):
        res['fwd_ms' + tag] = time_ms(lambda: fa.flash_attention_fwd_lse(
            q, k, v, causal=True, window=w), 10)
    out, lse = fa.flash_attention_fwd_lse(q, k, v, causal=True,
                                          window=window)
    out0, lse0 = fa.flash_attention_fwd_lse(q, k, v, causal=True)
    do = torch.randn(out.shape, generator=gen, device='cuda',
                     dtype=torch.bfloat16)
    for w, tag, o in ((window, '', out), (0, '_nowindow', out0)):
        lw = lse if w else lse0
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
        res['bwd_ms' + tag] = time_ms(lambda: fa.flash_bwd_cuda(
            q, k, v, do, lw, delta, None, True, w), 5)
        if w:
            with deterministic_algorithms():
                res['bwd_ordered_ms'] = time_ms(lambda: fa.flash_bwd_cuda(
                    q, k, v, do, lw, delta, None, True, w), 5)
    res['bwd_eager_ms'] = eager_ms(lambda: fa.flash_attention_bwd(
        q, k, v, out, lse, do, causal=True, window=window), 5)
    del out0, lse0
    torch.cuda.empty_cache()
    res['fwd_plain_ms'] = eager_ms(lambda: fa.flash_attention_reference(
        q, k, v, causal=True, window=window), 1)
    torch.cuda.empty_cache()
    res['bwd_plain_ms'] = eager_ms(lambda: fa.flash_attention_bwd_reference(
        q, k, v, out, lse, do, causal=True, window=window), 1)
    torch.cuda.empty_cache()
    pos = torch.arange(s, device='cuda')
    band = (pos[None, :] <= pos[:, None]) & \
        (pos[:, None] - pos[None, :] < window)
    qt = q.transpose(1, 2)
    kx = k.repeat_interleave(hq // hkv, dim=2).transpose(1, 2)
    vx = v.repeat_interleave(hq // hkv, dim=2).transpose(1, 2)
    mask = band[None, None]
    names = {int(v): k for k, v in
             torch.nn.attention.SDPBackend.__members__.items()}
    backend = int(torch._fused_sdp_choice(qt, kx, vx, mask, 0.0, False))
    res['library_backend'] = names.get(backend, str(backend))
    res['fwd_library_ms'] = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kx, vx, attn_mask=mask), 10)
    leaves = [x.detach().requires_grad_() for x in (qt, kx, vx)]
    with torch.enable_grad():
        sdpa_out = F.scaled_dot_product_attention(*leaves, attn_mask=mask)
    dot = do.transpose(1, 2)
    res['bwd_library_ms'] = eager_ms(lambda: torch.autograd.grad(
        sdpa_out, leaves, dot, retain_graph=True), 5)
    del sdpa_out, leaves, kx, vx
    torch.cuda.empty_cache()
    for name, per_pair, nbytes in (
            ('fwd', 4.0, 2 * (2 * q.numel() + k.numel() + v.numel())
             + 4 * b * hq * s),
            ('bwd', 10.0, 2 * (3 * q.numel() + 2 * k.numel() + 2 * v.numel())
             + 2 * 4 * b * hq * s)):
        for w, tag in ((window, ''), (0, '_nowindow')):
            flops = per_pair * d * b * hq * band_pairs(s, w)
            bf = flops / BF16_FLOPS_PER_S * 1e3
            bb = nbytes / HBM_BYTES_PER_S * 1e3
            res[f'{name}_bound_ms{tag}'] = max(bf, bb)
            res[f'{name}_bound_by{tag}'] = 'operations' if bf >= bb \
                else 'bytes'
    res['pairs_per_head'] = band_pairs(s, window)
    res['pairs_per_head_nowindow'] = band_pairs(s, 0)
    return res


def log_window_timed(card, tw):
    for name in ('fwd', 'bwd'):
        extra = (f'; with ordered adds {tw["bwd_ordered_ms"]:.4f} ms; whole '
                 f'backward eager {tw["bwd_eager_ms"]:.4f} ms vs SDPA '
                 f'backward eager {tw["bwd_library_ms"]:.4f} ms'
                 if name == 'bwd' else
                 f'; SDPA forward {tw["fwd_library_ms"]:.4f} ms')
        _log(f'flash_{name} window {tw["window"]} causal {tw["shape"]} kv '
             f'heads {tw["kv_heads"]} [{card}]: {tw[name + "_ms"]:.4f} ms '
             f'(bound {tw[name + "_bound_ms"]:.4f}, '
             f'{tw[name + "_bound_by"]}) vs no window '
             f'{tw[name + "_ms_nowindow"]:.4f} ms (bound '
             f'{tw[name + "_bound_ms_nowindow"]:.4f}): ratio '
             f'{tw[name + "_ms"] / tw[name + "_ms_nowindow"]:.3f} (visible '
             f'pairs {tw["pairs_per_head"] / tw["pairs_per_head_nowindow"]:.3f}'
             f'); plain {tw[name + "_plain_ms"]:.2f} ms' + extra
             + f'; SDPA with the band mask took {tw["library_backend"]}')


def log_flash_bwd_timed(card, tb):
    _log(f'flash_bwd causal {tb["shape"]} kv heads {tb["kv_heads"]} '
         f'[{card}]: '
         f'{tb["bwd_ms"]:.4f} ms in a CUDA graph (kernel + zeroing '
         f'{tb["zero_ms"]:.4f} + cast {tb["cast_ms"]:.4f}; with ordered '
         f'adds {tb["bwd_ordered_ms"]:.4f}), bound '
         f'{tb["bwd_bound_ms"]:.4f} ms ({tb["bwd_bound_by"]}); whole '
         f'backward eager (delta, zeroing, kernel, cast) '
         f'{tb["bwd_eager_ms"]:.4f} ms vs one SDPA backward eager (k/v '
         f'expanded to {tb["shape"][2]} heads) {tb["library_ms"]:.4f} ms: '
         f'{tb["ratio_to_library"]:.3f}x, SDPA took '
         f'{tb["library_backend"]} (with ordered adds '
         f'{tb["bwd_ordered_eager_ms"]:.4f} ms, '
         f'{tb["bwd_ordered_eager_ms"] / tb["library_ms"]:.3f}x); plain '
         f'backward {tb["plain_ms"]:.4f} ms')
    _log(f'flash_fwd causal {tb["shape"]} kv heads {tb["kv_heads"]} '
         f'[{card}]: {tb["fwd_ms"]:.4f} ms, bound {tb["fwd_bound_ms"]:.4f} '
         f'ms ({tb["fwd_bound_by"]}), plain {tb["fwd_plain_ms"]:.4f} ms, '
         f'SDPA forward {tb["fwd_library_ms"]:.4f} ms')
    for name in ('packed', 'd128'):
        if name not in tb:
            continue
        t = tb[name]
        _log(f'flash_bwd causal {name} {t["shape"]} kv heads {t["kv_heads"]} '
             f'[{card}]: {t["ms"]:.4f} ms in a CUDA graph, bound '
             f'{t["bound_ms"]:.4f} ms ({t["bound_by"]})')


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
    device_kind = torch.cuda.get_device_name(0)
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
            if 'registers' in line or 'spill' in line or \
                    'entry function' in line:
                _log(f'  ptxas {k}: {line.strip()}')

    gen = torch.Generator(device='cuda')
    gen.manual_seed(SEED)
    with torch.inference_mode():
        flash_res = check_flash(gen)
        paged_res = check_paged(gen)
        family_res = check_family(gen)
        lora_res = check_lora(gen)
        window_res = check_flash_window(gen)
        bwd_res = check_flash_bwd(gen)
        gen_d256 = torch.Generator(device='cuda')
        gen_d256.manual_seed(SEED + 40)
        d256_res = check_d256(gen_d256)
        gen_bwd256 = torch.Generator(device='cuda')
        gen_bwd256.manual_seed(SEED + 41)
        bwd256_res = check_flash_bwd(gen_bwd256, BWD_CASES_D256)
        gen_fwd = torch.Generator(device='cuda')
        gen_fwd.manual_seed(SEED + 43)
        fwd_res = check_fwd(gen_fwd)
        gen_verify = torch.Generator(device='cuda')
        gen_verify.manual_seed(SEED + 44)
        verify_res = check_verify(gen_verify)
    if args.quick:
        _log(card)
        print(json.dumps({'ok': True, 'device': {
            'platform': 'gpu', 'kind': device_kind,
            'count': torch.cuda.device_count()}}))
        return 0

    kernels, details = run_serving(
        args, card, gen, {'flash': flash_res, 'paged': paged_res,
                          'family': family_res, 'lora': lora_res})
    details.update({'card': card, 'build_s': build_s})
    gc.collect()
    torch.cuda.empty_cache()
    mistral_res = run_mistral(card)
    gemma_res = run_gemma(card)
    with torch.inference_mode():
        td = time_d256(gen_d256)
    kernels += gemma_kernels(card, gemma_res, td, d256_res)
    gc.collect()
    torch.cuda.empty_cache()
    train_res = run_train(card)
    gc.collect()
    torch.cuda.empty_cache()
    grads_res = check_train_grads(card)
    gc.collect()
    torch.cuda.empty_cache()
    ckpt_res = check_checkpoint(card)
    # At 512 tokens each dq element takes up to eight adds (one per key
    # tile): the resumed run is exact with the kernel's ordered adds.
    with deterministic_algorithms():
        ckpt_long_res = check_checkpoint(card, seq=512)
    ckpt_long_res['unordered'] = check_checkpoint(card, seq=512, exact=False)
    gc.collect()
    torch.cuda.empty_cache()
    resume_res = check_sft_resume(card)
    ordered_res = time_sft_ordered(card)
    mistral_grads = check_mistral_grads(card)
    gc.collect()
    torch.cuda.empty_cache()
    gemma_train = run_gemma_train(card)
    gc.collect()
    torch.cuda.empty_cache()
    gemma_grads = check_gemma_grads(card)
    tw = time_window(gen)
    log_window_timed(card, tw)
    tb = time_flash_bwd(gen)
    log_flash_bwd_timed(card, tb)
    # Head_dim 256 at gemma-2b's sft shape (batch 4, 8 q heads on 1 kv
    # head) and gemma-7b's MHA row, on a generator of their own.
    gen_t256 = torch.Generator(device='cuda')
    gen_t256.manual_seed(SEED + 42)
    tg = {GEMMA2B: time_bwd_at(gen_t256, 4, 2048, 8, 1, 256),
          GEMMA7B: time_bwd_at(gen_t256, 1, 2048, 16, 16, 256)}
    for t in tg.values():
        log_flash_bwd_timed(card, t)
    # Rows 8 and 9 (_dq_kernel, _dkv_kernel) are one fused kernel here:
    # both entries carry its numbers and "fused": true; add them once.
    bwd_kernels = [
        {'name': 'flash_bwd', 'route': 'cuda', 'fused': True,
         'source': 'skypilot_tpu_torch/csrc/flash_bwd.cu',
         'replaces': f'skypilot_tpu/ops/flash_attention.py:{line}',
         'launches': train_res['launches']['flash_bwd'],
         'max_abs_err': bwd_res['sft_causal']['max_abs_err'],
         'ms': tb['bwd_ms'], 'kernel_ms': tb['bwd_ms'],
         'eager_ms': tb['bwd_eager_ms'], 'plain_ms': tb['plain_ms'],
         'bound_ms': tb['bwd_bound_ms'], 'bound_by': tb['bwd_bound_by'],
         'library_ms': tb['library_ms'], 'shape': tb['shape'],
         'ordered_ms': tb['bwd_ordered_ms'],
         'ordered_eager_ms': tb['bwd_ordered_eager_ms'],
         'packed_ms': tb['packed']['ms'], 'd128_ms': tb['d128']['ms'],
         'd128_shape': tb['d128']['shape']}
        for line in ('168 _dq_kernel', '216 _dkv_kernel')]
    for entry in kernels:
        if entry['name'] == 'flash_fwd_gemma2b':
            # gemma-2b's training shape and launches beside its serving
            # path's.
            t = tg[GEMMA2B]
            entry.update({'train_shape': t['shape'],
                          'train_launches': gemma_train['launches'][
                              'flash_fwd'],
                          'train_ms': t['fwd_ms'],
                          'train_plain_ms': t['fwd_plain_ms'],
                          'train_bound_ms': t['fwd_bound_ms'],
                          'train_library_ms': t['fwd_library_ms']})
        if entry['name'] == 'flash_fwd':
            # The training path's shape and launches beside the serving
            # path's.
            entry.update({'train_shape': tb['shape'],
                          'train_launches': train_res['launches'][
                              'flash_fwd'],
                          'train_ms': tb['fwd_ms'],
                          'train_plain_ms': tb['fwd_plain_ms'],
                          'train_bound_ms': tb['fwd_bound_ms'],
                          'train_library_ms': tb['fwd_library_ms']})
    kernels += bwd_kernels
    # The head_dim-256 backward: gemma-2b's launches from its sft run,
    # gemma-7b's from its grad check (both counted from 0 just before).
    for model, run, check in (
            (GEMMA2B, gemma_train, bwd256_res['gemma2b_sft']),
            (GEMMA7B, gemma_grads, bwd256_res['gemma7b_causal'])):
        t = tg[model]
        kernels.append({
            'name': 'flash_bwd_' + model.replace('-', ''), 'route': 'cuda',
            'fused': True,
            'source': 'skypilot_tpu_torch/csrc/flash_bwd.cu',
            'replaces': 'skypilot_tpu/ops/flash_attention.py:168 '
                        '_dq_kernel, :216 _dkv_kernel (head_dim 256)',
            'launches': run['launches']['flash_bwd'],
            'max_abs_err': check['max_abs_err'], 'ms': t['bwd_ms'],
            'kernel_ms': t['bwd_ms'], 'eager_ms': t['bwd_eager_ms'],
            'plain_ms': t['plain_ms'], 'bound_ms': t['bwd_bound_ms'],
            'bound_by': t['bwd_bound_by'], 'library_ms': t['library_ms'],
            'library': f'SDPA backward, k/v expanded '
                       f'({t["library_backend"]})',
            'shape': t['shape'], 'kv_heads': t['kv_heads'], 'head_dim': 256,
            'ordered_ms': t['bwd_ordered_ms'],
            'ordered_eager_ms': t['bwd_ordered_eager_ms']})
    # The windowed kernels: the forward's launches from the Mistral
    # engine's run, the backward's from the Mistral grad check (both
    # counted from 0 just before); times at [1, 8192, 32, 128].
    for kname, tag, launches, err, line in (
            ('flash_fwd_window', 'fwd', mistral_res['launches']['flash_fwd'],
             window_res['mistral_packed']['max_abs_err'], '108 _fwd_kernel'),
            ('flash_bwd_window', 'bwd',
             mistral_grads['launches']['flash_bwd'],
             bwd_res['mistral_window']['max_abs_err'],
             '168 _dq_kernel, :216 _dkv_kernel')):
        entry = {
            'name': kname, 'route': 'cuda',
            'source': f'skypilot_tpu_torch/csrc/flash_{tag}.cu',
            'replaces': f'skypilot_tpu/ops/flash_attention.py:{line} '
                        f'(window > 0)',
            'launches': launches, 'max_abs_err': err, 'ms': tw[tag + '_ms'],
            'kernel_ms': tw[tag + '_ms'], 'plain_ms': tw[tag + '_plain_ms'],
            'bound_ms': tw[tag + '_bound_ms'],
            'bound_by': tw[tag + '_bound_by'],
            'library_ms': tw[tag + '_library_ms'],
            'library': f'SDPA, boolean band mask ({tw["library_backend"]})',
            'shape': tw['shape'], 'window': tw['window'],
            'nowindow_ms': tw[tag + '_ms_nowindow'],
            'nowindow_bound_ms': tw[tag + '_bound_ms_nowindow']}
        if tag == 'bwd':
            entry.update({'fused': True,
                          'ordered_ms': tw['bwd_ordered_ms'],
                          'eager_ms': tw['bwd_eager_ms']})
        kernels.append(entry)
    details.update({'train': train_res, 'train_grads': grads_res,
                    'checkpoint': ckpt_res,
                    'checkpoint_512': ckpt_long_res, 'flash_bwd_timed': tb,
                    'mistral': mistral_res, 'mistral_grads': mistral_grads,
                    'gemma': gemma_res, 'd256_timed': td,
                    'gemma_train': gemma_train, 'gemma_grads': gemma_grads,
                    'gemma_bwd_timed': tg,
                    'sft_resume': resume_res, 'sft_ordered': ordered_res,
                    'window_timed': tw,
                    'checks': {'flash': flash_res, 'paged': paged_res,
                               'family': family_res, 'lora': lora_res,
                               'flash_window': window_res,
                               'flash_bwd': bwd_res, 'd256': d256_res,
                               'flash_bwd_d256': bwd256_res,
                               'flash_fwd': fwd_res,
                               'paged_verify': verify_res}})
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           'smoke_out')
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, 'chip_smoke.json'), 'w') as f:
        json.dump(details, f, indent=1, default=str)
    assert all(math.isfinite(k['ms']) for k in kernels)
    _log(card)
    http_res = details['http']
    print(json.dumps({'http': {
        'card': card, 'launches': http_res['launches'],
        'burst_s': http_res['burst_s'], 'lone': http_res['lone'],
        'stream': http_res['stream'], 'options': http_res['options'],
        'ms_per_step': http_res['ms_per_step'],
        'openai': http_res['openai'], 'entry': http_res['entry']}}))
    hf = details['hf_checkpoint']
    print(json.dumps({'checkpoint': {
        **{k: hf[k] for k in ('card', 'disk_free_gib', 'n_layers', 'bytes',
                              'write_s', 'tokenizer')},
        'modes': {label: {k: v for k, v in r.items() if k != 'logits'}
                  for label, r in hf['modes'].items()},
        'entry': {k: hf['entry'][k] for k in ('healthy_s', 'exit_code',
                                              'model_id')}}}))
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': device_kind,
        'count': torch.cuda.device_count()}}))
    return 0


def gemma_kernels(card, gemma_res, td, d256_res):
    """Log phase 4's head_dim-256 timings; return their entries of the
    kernels line: the flash forward and the four paged kernels at
    gemma-7b's shapes (launches from the gemma-7b engines' runs), and
    the flash forward and the 32-row verify kernel at gemma-2b's
    (launches from the gemma-2b spec run)."""
    for label, t in td.items():
        lib = f'{t["library_ms"]:.4f}' if t['library_ms'] else 'none'
        _log(f'{label} {t["shape"]} [{card}]: {t["ms"]:.4f} ms (eager '
             f'{t["eager_ms"]:.4f}), plain {t["plain_ms"]:.4f} ms, library '
             f'{lib} ms, bound {t["bound_ms"]:.4f} ms ({t["bound_by"]})'
             + parts_text(t))
    g7, g2 = gemma_res[GEMMA7B], gemma_res[GEMMA2B]
    path_of = {kernel: label for label, _, kernel in PATHS}
    entries = []
    for model, shape, runs in (
            ('gemma7b', 'gemma7b_packed', {'flash_fwd': g7,
                                           'paged_decode': g7}),
            ('gemma2b', 'gemma2b_packed', {'flash_fwd': g2,
                                           'paged_decode_mq': g2})):
        for k in ('flash_fwd', *PAGED_KERNELS):
            if model == 'gemma7b' and k in path_of:
                run = gemma_res['paths'][path_of[k]]
            elif k in runs:
                run = runs[k]
            else:
                continue
            flash = k == 'flash_fwd'
            t = td[f'flash_{shape}' if flash else f'{k}_{model}']
            check = d256_res['flash'][shape] if flash else \
                d256_res[k][model]
            entry = {
                'name': f'{k}_{model}', 'route': 'cuda',
                'source': 'skypilot_tpu_torch/csrc/' +
                ('flash_fwd.cu' if flash else 'paged_decode.cu'),
                'replaces': 'skypilot_tpu/ops/flash_attention.py:108 '
                '_fwd_kernel' if flash else PAGED_KERNELS[k][3],
                'launches': run['launches'][k],
                'max_abs_err': check['max_abs_err'], 'ms': t['ms'],
                'kernel_ms': t['ms'], 'eager_ms': t['eager_ms'],
                'plain_ms': t['plain_ms'], 'bound_ms': t['bound_ms'],
                'bound_by': t['bound_by'], 'library_ms': t['library_ms'],
                'shape': t['shape'], 'head_dim': 256}
            if flash and model == 'gemma7b':
                lone = td['flash_gemma7b_lone']
                entry.update({'lone_shape': lone['shape'],
                              'lone_ms': lone['ms'],
                              'lone_bound_ms': lone['bound_ms'],
                              'lone_plain_ms': lone['plain_ms'],
                              'lone_library_ms': lone['library_ms']})
            if not flash:
                entry.update({'profiler_ms': t['profiler_ms'],
                              'query_rows': check['rows']})
                entry['launches_by_rows'] = {
                    r: n for r, n in run['launches_by_rows'].items()
                    if r.startswith(k + '/')} if 'launches_by_rows' in \
                    run else None
            entries.append(entry)
    return entries


def run_serving(args, card, gen, checks):
    """Phase 3's serving engines, then phase 4's timings of kernels 1-7.
    checks: phase 2's results of kernels 1-7. Returns their entries of
    the kernels line and the details."""
    import torch
    eng, eng_res = run_engine(card)
    if args.profile:
        eng_res['profile'] = profile_decode(eng, card)
    model = eng.model
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    paths_res = run_paths(model, card, eng_res['lone_ms_per_token'])
    paths_res['odd_pages'] = run_odd_pages(model, card)
    paths_res['agreement'] = check_agreement(model)
    prefix_res = run_prefix(model, card)
    http_res = run_http(model, card)
    ckpt_res = run_checkpoint(model, card)
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
        tp = {k: time_paged(gen, k) for k in PAGED_KERNELS}
        tl = {c: time_lora(gen, cases[c]) for c in LORA_TIMED}
    timed = [('flash packed [1, 2048, 32, 128]', tf),
             ('flash unpacked causal [1, 512, 32, 128]', tf_causal)] + [
        (f'{k} {t["shape"]}', t) for k, t in tp.items()] + [
        (f'{t["kernel"]} {c} {t["shape"]} -> {t["out"]}', t)
        for c, t in tl.items()]
    for label, t in timed:
        lib = f'{t["library_ms"]:.4f}' if t['library_ms'] else 'none'
        extra = (f'; in place into y (fused_ms) {t["fused_ms"]:.4f} ms; '
                 f'index_select + 2 bmm {t["index_bmm_ms"]:.4f} ms; plan '
                 f'{t["plan"]}'
                 if 'fused_ms' in t else parts_text(t))
        _log(f'{label} [{card}]: {t["ms"]:.4f} ms (eager '
             f'{t["eager_ms"]:.4f}), plain {t["plain_ms"]:.4f} ms, '
             f'library {lib} ms, bound {t["bound_ms"]:.4f} ms '
             f'({t["bound_by"]}){extra}')

    flash_res, paged_res = checks['flash'], checks['paged']
    family_res, lora_res = checks['family'], checks['lora']
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
         'library_ms': tf['library_ms'], 'shape': tf['shape'],
         'lone_shape': tf_causal['shape'], 'lone_ms': tf_causal['ms'],
         'lone_plain_ms': tf_causal['plain_ms'],
         'lone_bound_ms': tf_causal['bound_ms'],
         'lone_library_ms': tf_causal['library_ms']}]
    # Rows 1, 2 and 4 also carry the prefix phase's launches, by part.
    kernels[0]['prefix_launches'] = {
        part: n['flash_fwd'] for part, n in prefix_res['launches'].items()}
    for k, t in tp.items():
        launches = eng_res['launches'][k] if k == 'paged_decode' else \
            paths_res[path_of[k]]['launches'][k]
        err = paged_res['slice']['max_abs_err'] if k == 'paged_decode' \
            else family_res[k]['slice']['max_abs_err']
        kernels.append({
            'name': k, 'route': 'cuda',
            'source': 'skypilot_tpu_torch/csrc/paged_decode.cu',
            'replaces': PAGED_KERNELS[k][3],
            'launches': launches, 'max_abs_err': err, 'ms': t['ms'],
            'kernel_ms': t['ms'], 'eager_ms': t['eager_ms'],
            'profiler_ms': t['profiler_ms'],
            'plain_ms': t['plain_ms'], 'bound_ms': t['bound_ms'],
            'bound_by': t['bound_by'], 'library_ms': None,
            'shape': t['shape']})
        if k in ('paged_decode', 'paged_decode_q'):
            kernels[-1]['prefix_launches'] = {
                part: n[k] for part, n in prefix_res['launches'].items()}
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
    # Rows 1 and 2 also carry the HTTP phase's launches.
    kernels[0]['http_launches'] = http_res['launches']['flash_fwd']
    kernels[1]['http_launches'] = http_res['launches']['paged_decode']
    # Rows 1-3 carry the checkpoint phase's, by engine (8-slot engines;
    # the verify kernel's from the spec_decode=4 engines).
    for entry in kernels[:3]:
        k = entry['name']
        entry['ckpt_launches'] = {
            label: r['spec_launches' if k == 'paged_decode_mq'
                     else 'launches'][k]
            for label, r in ckpt_res['modes'].items()}
    details = {'engine': eng_res, 'paths': paths_res, 'lora': lora_run,
               'prefix': prefix_res, 'http': http_res,
               'hf_checkpoint': ckpt_res,
               'flash_packed': tf, 'flash_causal_512': tf_causal,
               'paged': tp, 'lora_timed': tl}
    return kernels, details


if __name__ == '__main__':
    sys.exit(main())
