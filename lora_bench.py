#!/usr/bin/env python3
"""Time the PyTorch port's multi-LoRA kernels (lora_gather, lora_grouped)
on one CUDA card at the serving paths' shapes, for the skypilot_tpu_torch
package of a given checkout, so two checkouts can be compared on the same
card:

    python3 lora_bench.py                       # this checkout
    python3 lora_bench.py --root <checkout> --label parent

The cases are chip_smoke.py's LORA_TIMED (x [B, S, in] -> out, three
adapters and id 0 on a stack of rank 16, one of rank 8 zero-padded):

    gather_decode       [8, 1, 4096] -> 14336   (w_gate / w_up at decode)
    gather_decode_down  [8, 1, 14336] -> 4096   (w_down at decode)
    gather_verify       [8, 4, 4096] -> 14336   (the verify step)
    gather_lone         [1, 512, 4096] -> 14336 (a lone admission)
    grouped_burst       [1, 2048, 4096] -> 14336 (the packed burst row)
    gather_decode_r256  [8, 1, 4096] -> 14336 at ranks 256, 16, 8
    gather_decode_sparse [8, 1, 4096] -> 14336 on eight rank-16 adapters,
                        two of them used

made by this checkout's chip_smoke.py (lora_case_inputs) from a seed,
whichever package is timed. For each: the delta's device ms per call from
CUDA events around a replayed CUDA graph of 50 calls (grouped_lora_delta,
three replays after a warm-up) and the same in place (add_lora_delta_ into
y, as the model runs it); the delta's eager ms per call (the least of five
runs of 50 calls on the stream, Python's launch overhead included);
cold-L2 ms, the delta and in place: each call after a 128 MB buffer is
written (more than the 50 MB L2, as the decode step's GEMMs stream ~117 MB
of weights between two LoRA calls), the graph of buffer write + call less
the graph of the buffer write alone; and the bound, the larger of the bytes
read and written once (x, the output, ids and scales, each distinct
non-zero adapter's A and B; y too in place) over 3.35 TB/s and
2*r*(in + out) flops a token with an adapter over 989 TFLOP/s. A checkout
whose kernel refuses a case (rank above 128 before the redesign) reports
the error. Prints the card (nvidia-smi name, power.limit), one JSON line
per case and a last JSON line with all of them. Imports nothing of JAX.
"""
import argparse
import importlib.util
import json
import os
import subprocess
import sys

COLD_BYTES = 128 << 20


def run_case(smoke, lora_ops, gen, case, flush):
    import torch
    x, a, b, ids, scale = smoke.lora_case_inputs(gen, case)
    bsz, s, din = x.shape
    r, dout = a.shape[-1], b.shape[-1]
    y = torch.randn((bsz, s, dout), generator=gen, device='cuda',
                    dtype=torch.bfloat16)
    tok_ids = ids if ids.dim() == 2 else ids[:, None].expand(bsz, s)
    adapted = int((tok_ids != 0).sum())
    distinct = int(torch.unique(tok_ids[tok_ids != 0]).numel())
    nbytes = 2 * (x.numel() + bsz * s * dout) + \
        2 * distinct * r * (din + dout) + 4 * (ids.numel() + scale.numel())
    flops = 2.0 * adapted * r * (din + dout)
    bound_bytes = nbytes / smoke.HBM_BYTES_PER_S * 1e3
    bound_flops = flops / smoke.BF16_FLOPS_PER_S * 1e3
    res = {'kernel': 'lora_grouped' if ids.dim() == 2 else 'lora_gather',
           'shape': list(x.shape), 'out': dout, 'rank': r,
           'bound_ms': max(bound_bytes, bound_flops),
           'fused_bound_ms': max(
               (nbytes + 2 * bsz * s * dout) / smoke.HBM_BYTES_PER_S * 1e3,
               bound_flops),
           'bound_by': 'bytes' if bound_bytes >= bound_flops
           else 'operations'}

    def delta():
        return lora_ops.grouped_lora_delta(x, a, b, ids, scale)

    def fused():
        return lora_ops.add_lora_delta_(y, x, a, b, ids, scale)
    try:
        delta()
        torch.cuda.synchronize()
    except (ValueError, RuntimeError) as e:
        res['error'] = str(e)
        return res
    res['ms'] = smoke.time_ms(delta, 50)
    res['fused_ms'] = smoke.time_ms(fused, 50)
    # Host time varies from call to call: the least of five runs of 50.
    res['eager_ms'] = min(smoke.eager_ms(delta, 50) for _ in range(5))
    write = smoke.time_ms(lambda: flush.fill_(1.0), 20)
    res['flush_ms'] = write
    res['cold_ms'] = smoke.time_ms(lambda: (flush.fill_(1.0), delta()),
                                   20) - write
    res['cold_fused_ms'] = smoke.time_ms(lambda: (flush.fill_(1.0), fused()),
                                         20) - write
    if hasattr(lora_ops, 'lora_plan'):
        res['plan'] = lora_ops.lora_plan(
            bsz * s, din, r, dout, a.shape[0], False,
            torch.cuda.get_device_properties(0).multi_processor_count
        )._asdict()
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--root', default=os.path.dirname(
        os.path.abspath(__file__)), help='checkout whose package to time')
    ap.add_argument('--label', default='this checkout')
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch
    if not torch.cuda.is_available():
        print('lora_bench: no CUDA device', file=sys.stderr)
        return 2
    # The inputs and timers of this checkout's chip_smoke.py, whichever
    # package is timed.
    spec = importlib.util.spec_from_file_location(
        'chip_smoke', os.path.join(os.path.dirname(
            os.path.abspath(__file__)), 'chip_smoke.py'))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from skypilot_tpu_torch.ops import lora as lora_ops
    assert os.path.abspath(lora_ops.__file__).startswith(
        os.path.abspath(args.root)), lora_ops.__file__
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f'card: {card}', flush=True)
    cases = {c[0]: c for c in smoke.LORA_CASES}
    gen = torch.Generator(device='cuda')
    gen.manual_seed(0)
    flush = torch.empty(COLD_BYTES // 4, dtype=torch.float32, device='cuda')
    res = {}
    with torch.inference_mode():
        for name in smoke.LORA_TIMED:
            res[name] = run_case(smoke, lora_ops, gen, cases[name], flush)
            print(json.dumps({'label': args.label, 'case': name,
                              **res[name]}), flush=True)
            torch.cuda.empty_cache()
    print(json.dumps({'label': args.label, 'card': card, 'cases': res}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
