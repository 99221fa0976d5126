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

The device-side statics update the pools IN PLACE (the JAX package
returns new arrays; in-place updates save a pool copy per call).
"""
import dataclasses
from typing import List, Optional

import numpy as np
import torch


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
                 device: torch.device) -> None:
        self.cfg = cfg
        self.num_slots = num_slots
        # Page-major: one page holds all kv heads ([H, P, d] contiguous).
        shape = (n_layers, cfg.n_pages, kv_heads, cfg.page_size, head_dim)
        self.pools = {'k': torch.zeros(shape, dtype=dtype, device=device),
                      'v': torch.zeros(shape, dtype=dtype, device=device)}
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
        p = pool.shape[2]
        mp = tables.shape[1]
        lengths = lengths.long()
        page = torch.gather(tables.long(), 1,
                            (lengths // p).clamp(0, mp - 1)[:, None])[:, 0]
        off = lengths % p
        pool[page, :, off] = new_kv.to(pool.dtype)
        return pool
