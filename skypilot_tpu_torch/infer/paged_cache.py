"""Paged (block-table) KV cache for the serving engine (counterpart of
skypilot_tpu/infer/paged_cache.py).

A page POOL per layer

    k/v: [n_layers, n_pages, kv_heads, page_size, head_dim]

plus a per-slot block table mapping logical token positions to pages.
A request reserves ceil((prompt + max_new) / P) pages at admission, the
most it can touch, so decode never exhausts the pool mid-flight;
admission defers while the pool is full.

Page 0 is a shared dummy: unreserved table entries point at it. Freed
slots keep decoding with an all-zero table row and a stale length, so
their appends land in page 0 (the page index is clipped to the row)
and the paged kernel reads only page 0 for them.

int8 KV (kv_dtype='int8'): the k/v pools hold int8 codes and two f32
scale pools [n_layers, n_pages, kv_heads, page_size] hold one scale per
token and head: scale = amax/127 over head_dim (amax 0 -> scale 1), so an
append never re-scales settled entries. The never-written dummy page
keeps scale 0 and dequantizes to zeros, like the float pool's zero init.

The device-side statics update the pools IN PLACE (the JAX package
returns new arrays; in-place updates save a pool copy per call).
"""
import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

# KV pool modes ('auto': the model's compute dtype, no quantization).
KV_DTYPES = ('auto', 'int8')


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [..., d] float -> (int8 [..., d], f32 scale [...]): symmetric
    per-row (per token, per head) scale amax/127, rounded half to even
    and clipped to +-127. Rows with amax 0 get scale 1, so zero KV stays
    exactly zero."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.round(xf / scale[..., None]).clamp(-127, 127)
    return q.to(torch.int8), scale


def _run_pages(tables: torch.Tensor, start: torch.Tensor, s: int,
               page_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Page and in-page offset of positions start[b] + j, j < s, for
    every slot: ([slots * s], [slots * s]). The page index is clipped to
    the table row, so a released slot (all-zero row, stale length)
    writes into dummy page 0."""
    mp = tables.shape[1]
    pos = start.long()[:, None] + torch.arange(s, device=start.device)
    page = torch.gather(tables.long(), 1, (pos // page_size).clamp(0, mp - 1))
    return page.reshape(-1), (pos % page_size).reshape(-1)


@dataclasses.dataclass
class PagedConfig:
    page_size: int = 64
    n_pages: int = 0              # total pool pages (incl. dummy page 0)
    max_pages_per_slot: int = 0   # ceil(max_seq_len / page_size)

    @staticmethod
    def for_engine(max_seq_len: int, num_slots: int, page_size: int,
                   pool_tokens: Optional[int] = None) -> 'PagedConfig':
        """pool_tokens: KV budget in tokens; default the dense
        equivalent, num_slots * max_seq_len."""
        max_pages = -(-max_seq_len // page_size)
        tokens = pool_tokens if pool_tokens is not None \
            else num_slots * max_seq_len
        n_pages = -(-tokens // page_size) + 1   # +1: dummy page 0
        return PagedConfig(page_size=page_size, n_pages=n_pages,
                           max_pages_per_slot=max_pages)


class PagePool:
    """Host-side page accounting plus the device pools.

    Not thread-safe: owned by the engine loop thread, like the slot
    table."""

    def __init__(self, cfg: PagedConfig, n_layers: int, kv_heads: int,
                 head_dim: int, num_slots: int, dtype: torch.dtype,
                 device: torch.device, kv_dtype: str = 'auto') -> None:
        self.cfg = cfg
        self.num_slots = num_slots
        if kv_dtype not in KV_DTYPES:
            raise ValueError(f'kv_dtype must be one of {KV_DTYPES}, '
                             f'got {kv_dtype!r}')
        quantized = kv_dtype == 'int8'
        # Page-major: one page holds all kv heads ([H, P, d] contiguous).
        shape = (n_layers, cfg.n_pages, kv_heads, cfg.page_size, head_dim)
        pool_dtype = torch.int8 if quantized else dtype
        self.pools: Optional[Dict[str, torch.Tensor]] = {
            'k': torch.zeros(shape, dtype=pool_dtype, device=device),
            'v': torch.zeros(shape, dtype=pool_dtype, device=device)}
        if quantized:
            for name in ('k_scale', 'v_scale'):
                self.pools[name] = torch.zeros(shape[:-1],
                                               dtype=torch.float32,
                                               device=device)
        # Page 0 is the dummy; never allocated.
        self._free: List[int] = list(range(1, cfg.n_pages))
        self._owned: List[List[int]] = [[] for _ in range(num_slots)]
        # Host block-table mirror; the device copy lives in the engine's
        # cache dict and is written at insert / cleared at release.
        self.tables = np.zeros((num_slots, cfg.max_pages_per_slot),
                               np.int32)

    # --------------------------------------------------- host accounting
    def pages_needed(self, total_tokens: int) -> int:
        return min(-(-total_tokens // self.cfg.page_size),
                   self.cfg.max_pages_per_slot)

    def free_pages(self) -> int:
        return len(self._free)

    def try_reserve(self, slot: int,
                    total_tokens: int) -> Optional[np.ndarray]:
        """Reserve pages covering total_tokens for `slot`. Returns the
        slot's table row (np [max_pages_per_slot]) or None if the pool
        cannot satisfy the reservation."""
        n = self.pages_needed(total_tokens)
        assert not self._owned[slot], f'slot {slot} already holds pages'
        if n > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(n)]
        self._owned[slot] = pages
        row = np.zeros((self.cfg.max_pages_per_slot,), np.int32)
        row[:n] = pages
        self.tables[slot] = row
        return row

    def release(self, slot: int) -> None:
        self._free.extend(self._owned[slot])
        self._owned[slot] = []
        self.tables[slot] = 0

    # ------------------------------------------------------ device statics
    @staticmethod
    def insert_prompt(pool: torch.Tensor, prompt_kv: torch.Tensor,
                      page_ids: torch.Tensor,
                      src_off: int = 0) -> torch.Tensor:
        """Scatter a prefill cache into reserved pages, in place.

        pool:      [L, n_pages, H, P, d]
        prompt_kv: [L, 1, S, H, d] from the prefill
        page_ids:  [n] int — the pages receiving prompt positions
                   [src_off, src_off + n*P)."""
        n = page_ids.shape[0]
        l, _, _, h, d = prompt_kv.shape
        p = pool.shape[3]
        chunk = prompt_kv[:, 0, src_off:src_off + n * p]   # [L, n*P, H, d]
        chunk = chunk.reshape(l, n, p, h, d).transpose(2, 3)
        pool[:, page_ids.long()] = chunk.to(pool.dtype)
        return pool

    @staticmethod
    def gather_view_layer(pool: torch.Tensor,
                          tables: torch.Tensor) -> torch.Tensor:
        """One layer's per-slot contiguous KV view.

        pool: [n_pages, H, P, d]; tables: [slots, max_pages] int
        -> [slots, max_pages*P, H, d]"""
        _, h, p, d = pool.shape
        slots, mp = tables.shape
        v = pool[tables.long()]                  # [slots, mp, H, P, d]
        return v.transpose(2, 3).reshape(slots, mp * p, h, d)

    @staticmethod
    def append_token_layer(pool: torch.Tensor, new_kv: torch.Tensor,
                           tables: torch.Tensor,
                           lengths: torch.Tensor) -> torch.Tensor:
        """Scatter one decoded token's KV for every slot, one layer, in
        place.

        pool:    [n_pages, H, P, d]
        new_kv:  [slots, H, d] — written at position lengths[slot]
        tables:  [slots, max_pages] int
        lengths: [slots] int"""
        page, off = _run_pages(tables, lengths, 1, pool.shape[2])
        pool[page, :, off] = new_kv.to(pool.dtype)
        return pool

    @staticmethod
    def append_tokens_layer(pool: torch.Tensor, new_kv: torch.Tensor,
                            tables: torch.Tensor,
                            start: torch.Tensor) -> torch.Tensor:
        """Scatter a short run of tokens per slot (the speculative
        verify step's s = k+1), one layer, in place.

        pool:   [n_pages, H, P, d]
        new_kv: [slots, s, H, d] — token j of slot b at start[b] + j
        tables: [slots, max_pages] int
        start:  [slots] int"""
        slots, s, h, d = new_kv.shape
        page, off = _run_pages(tables, start, s, pool.shape[2])
        pool[page, :, off] = new_kv.reshape(slots * s, h, d).to(pool.dtype)
        return pool

    # ------------------------------------------ int8-quantized statics
    @staticmethod
    def insert_prompt_q(pool: torch.Tensor, scale_pool: torch.Tensor,
                        prompt_kv: torch.Tensor, page_ids: torch.Tensor,
                        src_off: int = 0
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
        """insert_prompt into an int8 pool: the codes into pool
        [L, n_pages, H, P, d], the per-token per-head scales into
        scale_pool [L, n_pages, H, P], in place."""
        n = page_ids.shape[0]
        l, _, _, h, d = prompt_kv.shape
        p = pool.shape[3]
        chunk = prompt_kv[:, 0, src_off:src_off + n * p]   # [L, n*P, H, d]
        q, s = quantize_kv(chunk.reshape(l, n, p, h, d).transpose(2, 3))
        ids = page_ids.long()
        pool[:, ids] = q
        scale_pool[:, ids] = s
        return pool, scale_pool

    @staticmethod
    def gather_view_layer_q(pool: torch.Tensor, scale_pool: torch.Tensor,
                            tables: torch.Tensor,
                            dtype: torch.dtype) -> torch.Tensor:
        """Dequantizing gather_view_layer: pool [n_pages, H, P, d] int8
        and scale_pool [n_pages, H, P] -> [slots, max_pages*P, H, d] at
        `dtype` (code * scale in f32, then cast)."""
        _, h, p, d = pool.shape
        slots, mp = tables.shape
        t = tables.long()
        v = pool[t].float() * scale_pool[t][..., None]
        return v.to(dtype).transpose(2, 3).reshape(slots, mp * p, h, d)

    @staticmethod
    def append_token_layer_q(pool: torch.Tensor, scale_pool: torch.Tensor,
                             new_kv: torch.Tensor, tables: torch.Tensor,
                             lengths: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """append_token_layer into an int8 pool: quantize each slot's row
        and scatter code and scale, in place."""
        page, off = _run_pages(tables, lengths, 1, pool.shape[2])
        q, s = quantize_kv(new_kv)             # [slots, H, d], [slots, H]
        pool[page, :, off] = q
        scale_pool[page, :, off] = s
        return pool, scale_pool

    @staticmethod
    def append_tokens_layer_q(pool: torch.Tensor, scale_pool: torch.Tensor,
                              new_kv: torch.Tensor, tables: torch.Tensor,
                              start: torch.Tensor
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """append_tokens_layer into an int8 pool (new_kv [slots, s, H,
        d]), in place."""
        slots, s, h, d = new_kv.shape
        page, off = _run_pages(tables, start, s, pool.shape[2])
        q, sc = quantize_kv(new_kv.reshape(slots * s, h, d))
        pool[page, :, off] = q
        scale_pool[page, :, off] = sc
        return pool, scale_pool
