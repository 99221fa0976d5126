"""Grouped multi-LoRA delta: the CUDA kernels of csrc/lora.cu and their
plain versions (counterpart of skypilot_tpu/ops/lora.py).

Two kernels, one design, replacing the two TPU kernels of that module:

  * lora_gather  -> :64 _gather_kernel  (per-sequence ids [B]: decode,
    the speculative verify step, single admission)
  * lora_grouped -> :74 _grouped_kernel (per-token ids [B, S]: ragged
    prefill packs that mix adapters in one row)

Each token t with adapter id a = ids[t] gets
x[t] @ A[a] @ B[a] * scale[t], from the stacked A [N, in, r] and
B [N, r, out] (id 0 is the all-zeros no-adapter entry, scale
scaling[ids]). The kernels round as the JAX code does: the shrink to the
activation dtype between the two dots, the expand's output too, and the
scale multiply in that dtype.

What bounds them on an H100: memory bandwidth (x, each distinct non-zero
adapter's A and B, the output; 2*tokens*r*(in + out) flops at r <= 128).
The design (csrc/lora.cu): one block per 16 tokens (never crossing a
sequence for per-sequence ids) and a chunk of output columns; the block
lists its tokens' distinct non-zero ids, computes each one's shrink on
the tensor cores over its rows only, and accumulates the expand of each
id over that id's rows, so a token meets its own adapter and no other.
The column chunks of a token tile form thread block clusters of up to 8
that split the shrink's `in` between them and share its partial sums in
distributed shared memory. _grid picks the chunks so the grid covers
the card about four times: at decode (8 tiles of one token) up to 56
chunks of 256 columns, for the packed 2048-token row 8.

add_lora_delta_ adds the delta into the projection's output y in place:
on the card that is the kernel's epilogue (one launch per projection),
on the CPU y.add_(delta), JAX's y + d.

On a CUDA tensor each wrapper launches its kernel or raises; the plain
versions (*_reference) run only for CPU tensors. The JAX dispatch
ladder, autotune and VMEM gating are TPU machinery and have no
counterpart here.
"""
from typing import Optional

import torch

from skypilot_tpu_torch.ops import _build

# Kernel launches since the last reset, per kernel (chip_smoke.py reads
# them to show the serving path went through each kernel).
KERNELS = ('lora_gather', 'lora_grouped')
launches = dict.fromkeys(KERNELS, 0)

MAX_RANK = 128       # the kernel's shared-memory tiles hold r <= 128
_TILE_TOKENS = 16    # tokens per block
_PASS_COLS = 256     # output columns per expand pass (col_chunk unit)
_MAX_CLUSTER = 8     # portable thread block cluster size
# (device index, row tiles, out) -> (col_chunk, col_tiles, cluster)
_grids = {}


def reset_launches() -> None:
    for name in KERNELS:
        launches[name] = 0


# ------------------------------------------------------- plain versions
def lora_gather_reference(x: torch.Tensor, a: torch.Tensor,
                          b: torch.Tensor, lora_ids: torch.Tensor,
                          lora_scale: torch.Tensor) -> torch.Tensor:
    """Per-sequence ids [B] (JAX _xla_gather): each sequence gathers its
    A/B and runs both contractions; the scale multiplies in x's dtype
    after the second."""
    dtype = x.dtype
    ids = lora_ids.long()
    t = torch.einsum('bsi,bir->bsr', x, a[ids].to(dtype))
    d = torch.einsum('bsr,bro->bso', t, b[ids].to(dtype))
    return d * lora_scale[:, None, None].to(dtype)


def lora_grouped_reference(x: torch.Tensor, a: torch.Tensor,
                           b: torch.Tensor, lora_ids: torch.Tensor,
                           lora_scale: torch.Tensor) -> torch.Tensor:
    """Per-token ids [B, S] (JAX _xla_grouped): a loop over adapters 1..N-1
    with mask-and-accumulate (adapter 0 is zeros and is skipped)."""
    dtype = x.dtype
    acc = x.new_zeros(x.shape[:2] + (b.shape[-1],))
    for k in range(1, a.shape[0]):
        mask = (lora_ids == k).to(dtype)
        t = torch.einsum('bsi,ir->bsr', x * mask[..., None], a[k].to(dtype))
        acc = acc + torch.einsum('bsr,ro->bso', t, b[k].to(dtype))
    return acc * lora_scale[..., None].to(dtype)


# ------------------------------------------------------------- kernels
def _grid(dev: torch.device, row_tiles: int, dout: int):
    """(col_chunk, col_tiles, cluster) for a launch: column chunks per
    token tile so the grid is near four blocks per SM (at most one per
    _PASS_COLS columns), grouped in clusters of the largest power of two
    up to 8 that fits; col_tiles is a multiple of the cluster (a chunk
    past the width only shares the shrink)."""
    key = (dev.index, row_tiles, dout)
    grid = _grids.get(key)
    if grid is None:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        tiles = max(1, min(-(-dout // _PASS_COLS), -(-4 * sms // row_tiles)))
        cluster = 1 << (min(_MAX_CLUSTER, tiles).bit_length() - 1)
        tiles = -(-tiles // cluster) * cluster
        chunk = -(-(-(-dout // tiles)) // _PASS_COLS) * _PASS_COLS
        grid = _grids[key] = (chunk, tiles, cluster)
    return grid


def _refuse(name, x, a, b, lora_ids, lora_scale, y):
    """Raise with the first reason the kernel cannot take these operands."""
    bsz, seq, din = x.shape
    n, ain, r = a.shape
    dout = b.shape[-1]
    if ain != din or tuple(b.shape) != (n, r, dout):
        raise ValueError(f'shape mismatch: x {tuple(x.shape)}, a '
                         f'{tuple(a.shape)}, b {tuple(b.shape)}')
    if r > MAX_RANK:
        raise ValueError(f'{name} supports rank <= {MAX_RANK}, got {r}')
    for what, t in (('x', x), ('a', a), ('b', b)) + (
            (('y', y),) if y is not None else ()):
        if t.dtype != torch.bfloat16:
            raise TypeError(f'{name} takes bfloat16 {what}, got {t.dtype}')
        if not t.is_contiguous() or t.device != x.device:
            raise ValueError(f'{what} must be contiguous on {x.device}')
    if y is not None and tuple(y.shape) != (bsz, seq, dout):
        raise ValueError(f'y must be {(bsz, seq, dout)}, got '
                         f'{tuple(y.shape)}')
    want = (bsz, seq) if lora_ids.dim() == 2 else (bsz,)
    for what, t, dt in (('lora_ids', lora_ids, torch.int32),
                        ('lora_scale', lora_scale, torch.float32)):
        if t.dtype != dt or tuple(t.shape) != want or \
                not t.is_contiguous() or t.device != x.device:
            raise ValueError(f'{what} must be a contiguous {dt} {want} on '
                             f'{x.device}')
    raise AssertionError('unreachable')


def _lora_cuda(x, a, b, lora_ids, lora_scale, y):
    """Launch csrc/lora.cu: out = delta, or y + delta in place into y. The
    check runs once per projection of every forward, so its common case
    is one expression; _refuse names what failed."""
    per_token = lora_ids.dim() == 2
    name = 'lora_grouped' if per_token else 'lora_gather'
    bsz, seq, din = x.shape
    n, ain, r = a.shape
    dout = b.shape[-1]
    dev = x.device
    bf16 = torch.bfloat16
    ids_shape = lora_ids.shape
    if not (ain == din and b.shape[0] == n and b.shape[1] == r and
            r <= MAX_RANK and x.dtype == bf16 and a.dtype == bf16 and
            b.dtype == bf16 and lora_ids.dtype == torch.int32 and
            lora_scale.dtype == torch.float32 and
            lora_scale.shape == ids_shape and ids_shape[0] == bsz and
            (not per_token or ids_shape[1] == seq) and
            x.is_contiguous() and a.is_contiguous() and
            b.is_contiguous() and lora_ids.is_contiguous() and
            lora_scale.is_contiguous() and a.device == dev and
            b.device == dev and lora_ids.device == dev and
            lora_scale.device == dev and
            (y is None or (y.dtype == bf16 and y.is_contiguous() and
                           y.device == dev and
                           y.shape == (bsz, seq, dout)))):
        _refuse(name, x, a, b, lora_ids, lora_scale, y)
    row_tiles = -(-bsz * seq // _TILE_TOKENS) if per_token else \
        bsz * -(-seq // _TILE_TOKENS)
    out = y if y is not None else torch.empty(
        (bsz, seq, dout), dtype=x.dtype, device=dev)
    lib = _build.load('lora')
    rc = lib.skyt_lora(
        x.data_ptr(), a.data_ptr(), b.data_ptr(), lora_ids.data_ptr(),
        lora_scale.data_ptr(), None if y is None else y.data_ptr(),
        out.data_ptr(), bsz, seq, din, r, dout, n, int(per_token),
        *_grid(dev, row_tiles, dout),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, rc, name)
    launches[name] += 1
    return out


def _reference(x, a, b, lora_ids, lora_scale):
    if x.device.type != 'cpu':
        raise ValueError(f'unsupported device {x.device}')
    plain = lora_grouped_reference if lora_ids.dim() == 2 else \
        lora_gather_reference
    return plain(x, a, b, lora_ids, lora_scale)


def grouped_lora_delta(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                       lora_ids: torch.Tensor,
                       lora_scale: torch.Tensor) -> torch.Tensor:
    """Batched multi-LoRA delta. x: [B, S, in] activations; a: [N, in, r]
    stacked down-projections; b: [N, r, out]; lora_ids: [B]
    (per-sequence: the gather kernel) or [B, S] (per-token: the grouped
    kernel) int32 adapter ids; lora_scale: alpha/rank per id, the shape
    of lora_ids, f32. Returns the [B, S, out] delta in x's dtype."""
    if x.is_cuda:
        return _lora_cuda(x, a, b, lora_ids, lora_scale, None)
    return _reference(x, a, b, lora_ids, lora_scale)


def add_lora_delta_(y: torch.Tensor, x: torch.Tensor, a: torch.Tensor,
                    b: torch.Tensor, lora_ids: torch.Tensor,
                    lora_scale: torch.Tensor) -> torch.Tensor:
    """y += grouped_lora_delta(x, a, b, lora_ids, lora_scale), in place
    (y [B, S, out] is the projection's output); returns y. Rows without
    an adapter keep y exactly."""
    if x.is_cuda:
        return _lora_cuda(x, a, b, lora_ids, lora_scale, y)
    return y.add_(_reference(x, a, b, lora_ids, lora_scale))
