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
adapter's A and B, the output; 2*tokens*r*(in + out) flops at any LoRA
rank). The design (csrc/lora.cu): tiles of tokens for both id layouts (a
per-sequence call's token t has ids[t / S]), at decode and verify one
tile of every token; the tile's distinct ids listed by a warp vote;
every load started by a producer warp as its address is known (x's and
y's tiles as TMA boxes, an adapter's contiguous rows of A by a 1-D bulk
copy, B and rank tiles of A by TMA); one shrink pass for all the tile's
ids on mma.sync, `in` split over a thread block cluster, the partials
exchanged by st.async stores counted on the receivers' barriers; the
expand on wgmma from T in shared memory, masked per id so a token meets
its own adapter and no other; the output leaving by TMA stores while the
block goes on; ranks in tiles of at most 128, so any rank. lora_plan picks the
tiles, the column chunks, the cluster, the rank tiles and the rings.

add_lora_delta_ adds the delta into the projection's output y in place:
on the card that is the kernel's epilogue (one launch per projection),
on the CPU y.add_(delta), JAX's y + d.

On a CUDA tensor each wrapper launches its kernel or raises; the plain
versions (*_reference) run only for CPU tensors. The JAX dispatch
ladder, autotune and VMEM gating are TPU machinery and have no
counterpart here.
"""
import ctypes
import functools
from typing import NamedTuple, Tuple

import torch

from skypilot_tpu_torch.ops import _build

# Kernel launches since the last reset, per kernel (chip_smoke.py reads
# them to show the serving path went through each kernel).
KERNELS = ('lora_gather', 'lora_grouped')
launches = dict.fromkeys(KERNELS, 0)

PASS_COLS = 128      # output columns an expand pass (two wgmma panels)
MAX_CLUSTER = 16     # thread block cluster size (non-portable above 8)
# A prefill tile's cluster of 16 only where a cluster of 8 would give each
# block more than this many bytes of A to read (the shrink's share of
# `in`); a call of one tile (decode, verify) always takes 16: its time is
# the chain of each block's loads and shrink, which a shorter span cuts.
CLUSTER16_A_BYTES = 96 * 1024
SM_SMEM = 233472     # shared memory of an SM (228 KB)
MAX_TILE_ROWS = 64   # wgmma m64
T_COLS = 512         # T's preferred capacity in columns (ids x rank)
SMEM_LIMIT = 232448  # dynamic shared memory a block can use on an H100


class LoraPlan(NamedTuple):
    """One launch of csrc/lora.cu (lora_plan)."""
    tile_rows: int        # tokens a tile: 16, 32 or 64
    row_tiles: int
    col_passes: int       # PASS_COLS-column passes a block (its chunk)
    col_tiles: int        # blocks a tile, a multiple of the cluster
    cluster: int          # blocks splitting `in` for the shrink
    span: int             # rows of `in` a cluster block takes
    rank_width: int       # rank-tile width (a multiple of 16, <= 128)
    rank_tiles: int       # ceil(r / rank_width)
    items_per_pass: int   # rank tiles a shrink pass / expand k-block
    t_cols: int           # T's columns: the passes of ids_per_group ids
    ids_per_group: int    # whole ids a group (a tile's ids, in groups)
    chunk_rows: int       # rows of `in` a shrink stage
    s_stages: int         # shrink ring
    e_stages: int         # expand ring
    smem_bytes: int
    grid: Tuple[int, int]


def lora_smem_bytes(tm: int, wr: int, ipp: int, kt: int, kc: int, s1: int,
                    s2: int, in_place: bool) -> int:
    """A block's dynamic shared memory (csrc/lora.cu Layout): 1024 bytes
    to align the base; T [kt / 64 panels of tm rows x 128 bytes]; the
    expand ring (B: two 64-column panels of ipp * wr rows a stage; y: two
    panels of tm rows in place); the shrink ring (x: ceil(kc / 64) panels
    of tm rows, and ipp items of A [kc, wr] bf16); an output staging tile
    (two panels of tm rows; not in place, where the y tile is the
    staging), all 1024-byte aligned; the partials a block receives (at
    most tm * wp f32 and 16 quads of padding); the warps' partials
    [64 / tm, tm, wp] f32 when tm < 64; scales, distinct ids, row indices
    and groups (64 each) and a count; the mbarriers."""
    def up(n, a):
        return -(-n // a) * a
    wp = ipp * wr
    eb = up(tm * kt * 2, 1024) + s2 * up(wp * 256, 1024)
    ey = s2 * up(tm * 256, 1024) if in_place else 0
    s = s1 * up(-(-kc // 64) * tm * 128 + ipp * kc * wr * 2, 1024)
    out = 0 if in_place else up(tm * 256, 1024)
    ks = MAX_TILE_ROWS // tm
    part = tm * wp * 4 + 256 + (ks * tm * wp * 4 if ks > 1 else 0)
    meta = 4 * MAX_TILE_ROWS * 4 + 16
    bars = (2 * s1 + 2 * s2 + 2) * 8
    return 1024 + eb + ey + s + out + part + meta + bars


def _columns(passes_c: int, want: int,
             max_cluster: int) -> Tuple[int, int, int]:
    """(passes a block, blocks a tile, cluster) for about `want` blocks a
    tile: the largest cluster (up to max_cluster) and, for it, the most
    blocks (a multiple of it, at most `want`) whose blocks past the width
    stay within an eighth of those that have columns."""
    for c in (c for c in (16, 8, 4, 2, 1) if c <= max_cluster):
        for tiles in range(want // c * c, 0, -c):
            cpb = -(-passes_c // tiles)
            need = -(-passes_c // cpb)
            if -(-need // c) * c - need <= need // 8:
                return cpb, -(-need // c) * c, c
    raise AssertionError('unreachable')   # c = 1 always fits


@functools.lru_cache(maxsize=4096)
def lora_plan(tokens: int, din: int, r: int, dout: int, n_adapters: int,
              in_place: bool, sms: int) -> LoraPlan:
    """The kernel's launch for x [tokens, in] -> out over a stack of
    n_adapters (id 0 included) at rank r, on a card with `sms` SMs
    (cached: every projection of a step looks it up).

    Tiles of 16, 32 or 64 tokens (every token of a call of at most 64 in
    one tile); a tile's output in PASS_COLS-column passes, `col_passes`
    a block so the grid is about one block an SM for calls of at most 64
    tokens and two for longer ones; a tile's blocks in clusters
    (_columns; 16 for one tile, or where 8 would leave a block more
    than CLUSTER16_A_BYTES of A) that split `in` in spans of 16-row
    multiples. The rank in tiles of min(r rounded up to 16, 128)
    columns, as many a pass as fit 128 columns and the tile can have
    distinct ids; T holds up to T_COLS columns of whole ids
    (ids_per_group). The rings: one shrink stage where one chunk
    covers the span and the tile one pass, else the most stages (up to
    4 shrink stages, as many as a span has chunks, and 3 expand stages)
    with chunks of at least 64 rows, then the largest chunk, then the
    largest T that fit the shared memory (all of SMEM_LIMIT, or half an
    SM's for two blocks; then chunks down to 16 rows); fewer tile rows
    (a smaller T and staging) if nothing fits."""
    if min(tokens, din, r, dout, n_adapters, sms) <= 0:
        raise ValueError('lora_plan: sizes must be positive, got '
                         f'{(tokens, din, r, dout, n_adapters, sms)}')
    wr = min(-(-r // 16) * 16, 128)
    n_rt = -(-r // wr)
    passes_c = -(-dout // PASS_COLS)
    tm0 = 16 if tokens <= 16 else 32 if tokens <= 32 else MAX_TILE_ROWS
    for tm in (t for t in (64, 32, 16) if t <= tm0):
        row_tiles = -(-tokens // tm)
        max_ids = max(1, min(tm, n_adapters - 1))
        ipp = max(1, min(128 // wr, max_ids * n_rt))
        # Prefill-sized tiles stream their output: two blocks an SM hide
        # each other's latencies. Decode-sized calls have fewer blocks than
        # SMs: one an SM, all the shared memory for the rings.
        per_sm = 2 if tokens > MAX_TILE_ROWS else 1
        limit = SMEM_LIMIT if per_sm == 1 else SM_SMEM // per_sm - 1024
        want = max(1, min(passes_c, -(-per_sm * sms // row_tiles)))
        a_bytes = -(-din // 8) * ipp * wr * 2
        cpb, col_tiles, cluster = _columns(
            passes_c, want,
            MAX_CLUSTER if row_tiles == 1 or a_bytes > CLUSTER16_A_BYTES
            else 8)
        span = -(-(-(-din // cluster)) // 16) * 16
        wp = ipp * wr
        # T holds whole passes: ids_per_group ids take
        # ceil(ids * n_rt / ipp) passes of wp columns.
        kt_min = -(-(-(-n_rt // ipp) * wp) // 64) * 64
        kt = max(kt_min, -(-min(-(-max_ids * n_rt // ipp) * wp, T_COLS)
                           // 64) * 64)
        kts = [kt]
        while kts[-1] > kt_min:
            kts.append(max(kt_min, kts[-1] // 2 // 64 * 64))
        # Chunks of up to 256 rows (one TMA box), or one of 512 (two).
        kc = min(span, 512 if tm <= 32 else 128)
        kc = kc if kc <= 256 else (512 if kc == 512 else 256)
        kcs = [kc]
        while kcs[-1] > 16:
            kcs.append(max(16, kcs[-1] // 2 // 16 * 16))
        chunks = -(-span // kc)
        # One chunk of `in` and one pass (decode, verify): one shrink stage
        # holds all of it; else as many as the span has chunks (to 4).
        one_pass = -(-max_ids * n_rt // ipp) == 1
        rings = [(1, 3)] if chunks == 1 and one_pass else []
        rings += [(s1, s2) for s1, s2 in ((4, 3), (3, 3), (2, 3), (2, 2),
                                          (2, 1), (1, 1))
                  if s1 <= max(2, chunks)]
        for kc_floor in (min(64, kc), 16):
            for s1, s2, kc, kt in ((s1, s2, kc, kt) for s1, s2 in rings
                                   for kc in kcs if kc >= kc_floor
                                   for kt in kts):
                smem = lora_smem_bytes(tm, wr, ipp, kt, kc, s1, s2,
                                       in_place)
                if smem <= limit:
                    return LoraPlan(
                        tile_rows=tm, row_tiles=row_tiles,
                        col_passes=cpb, col_tiles=col_tiles,
                        cluster=cluster, span=span, rank_width=wr,
                        rank_tiles=n_rt, items_per_pass=ipp, t_cols=kt,
                        ids_per_group=kt // wp * ipp // n_rt,
                        chunk_rows=kc,
                        s_stages=s1, e_stages=s2, smem_bytes=smem, grid=(row_tiles, col_tiles))
    raise ValueError(f'lora: rank {r} needs more shared memory for one '
                     f"adapter's shrink than a block has ({SMEM_LIMIT})")


class _PlanArgs(ctypes.Structure):
    """A plan as csrc/lora.cu's PlanArgs: one pointer a launch."""
    _fields_ = [(name, ctypes.c_int) for name in (
        'tm', 'cpb', 'col_tiles', 'cluster', 'span', 'wr', 'ipp', 'kt',
        'per_group', 'kc', 's1', 's2')]


@functools.lru_cache(maxsize=4096)
def _plan_args(plan: LoraPlan) -> Tuple[_PlanArgs, int]:
    """The plan's _PlanArgs and its address (the caller holds the pair
    through the launch, so the struct outlives an eviction)."""
    args = _PlanArgs(plan.tile_rows, plan.col_passes, plan.col_tiles,
                     plan.cluster, plan.span, plan.rank_width,
                     plan.items_per_pass, plan.t_cols, plan.ids_per_group,
                     plan.chunk_rows, plan.s_stages, plan.e_stages)
    return args, ctypes.addressof(args)


@functools.lru_cache(maxsize=64)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


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
def _refuse(name, x, a, b, lora_ids, lora_scale, y):
    """Raise with the first reason the kernel cannot take these operands."""
    bsz, seq, din = x.shape
    n, ain, r = a.shape
    dout = b.shape[-1]
    if ain != din or tuple(b.shape) != (n, r, dout):
        raise ValueError(f'shape mismatch: x {tuple(x.shape)}, a '
                         f'{tuple(a.shape)}, b {tuple(b.shape)}')
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
            x.dtype == bf16 and a.dtype == bf16 and
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
    plan = lora_plan(bsz * seq, din, r, dout, n, y is not None,
                     _sm_count(dev.index))
    out = y if y is not None else torch.empty(
        (bsz, seq, dout), dtype=x.dtype, device=dev)
    args = _plan_args(plan)
    lib = _build.load('lora')
    rc = lib.skyt_lora(
        x.data_ptr(), a.data_ptr(), b.data_ptr(), lora_ids.data_ptr(),
        lora_scale.data_ptr(), None if y is None else y.data_ptr(),
        out.data_ptr(), bsz, seq, din, r, dout, n, int(per_token),
        args[1],
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
