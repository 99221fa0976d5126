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

Prefix caching: a prompt's full pages are keyed by chained content
hashes (page_hashes, salted by the adapter id) and published once
written; a later prompt that agrees on a leading run of pages shares
them (refcounted, read-only) and computes only its suffix. Released
published pages stay warm in an LRU and are reclaimed (on_evict) only
when the plain free list is empty.

int8 KV (kv_dtype='int8'): the k/v pools hold int8 codes and two f32
scale pools [n_layers, n_pages, kv_heads, page_size] hold one scale per
token and head: scale = amax/127 over head_dim (amax 0 -> scale 1), so an
append never re-scales settled entries. The never-written dummy page
keeps scale 0 and dequantizes to zeros, like the float pool's zero init.

The device-side statics update the pools IN PLACE (the JAX package
returns new arrays; in-place updates save a pool copy per call).
"""
import collections
import dataclasses
import hashlib
from typing import Dict, List, Optional, Sequence, Tuple

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


def page_hashes(tokens: Sequence[int], page_size: int,
                salt: int = 0) -> List[bytes]:
    """Chained blake2b hashes (16-byte digests) of a prompt's FULL pages,
    the prefix-cache key: hash[i] covers tokens[0 : (i+1) * page_size],
    so two prompts share page i iff they agree on everything up to it.
    salt: the request's lora_id, hashed first (8 bytes little-endian)
    when nonzero, so pages never cross adapters. The bytes equal the JAX
    package's, so pages can cross replicas by these keys."""
    h = hashlib.blake2b(digest_size=16)
    if salt:
        h.update(int(salt).to_bytes(8, 'little'))
    out: List[bytes] = []
    for i in range(len(tokens) // page_size):
        h.update(np.asarray(tokens[i * page_size:(i + 1) * page_size],
                            dtype=np.int64).tobytes())
        out.append(h.digest())
    return out


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
        # Prefix cache: hash -> page and back, per-page refcounts, and the
        # LRU of released pages that still hold published content.
        self._refs = np.zeros((cfg.n_pages,), np.int64)
        self._registry: Dict[bytes, int] = {}
        self._page_hash: Dict[int, bytes] = {}
        self._cached_free: 'collections.OrderedDict[int, None]' = \
            collections.OrderedDict()
        self.prefix_stats = {'hit_pages': 0, 'miss_pages': 0,
                             'evictions': 0}
        # Called as on_evict(page, hash) when _alloc_page reclaims a
        # published page (the host tier's spill), before the page is
        # handed out; never from flush_prefix.
        self.on_evict = None

    # --------------------------------------------------- host accounting
    def pages_needed(self, total_tokens: int) -> int:
        return min(-(-total_tokens // self.cfg.page_size),
                   self.cfg.max_pages_per_slot)

    def free_pages(self) -> int:
        """Allocatable pages: never-published free pages plus published
        pages no slot references (reclaimable by eviction)."""
        return len(self._free) + len(self._cached_free)

    def prefix_cached_pages(self) -> int:
        """Pages holding published prefix KV, referenced or warm."""
        return len(self._registry)

    def _alloc_page(self) -> Optional[int]:
        if self._free:
            return self._free.pop()
        if self._cached_free:
            # Evict the least recently released published page.
            page, _ = self._cached_free.popitem(last=False)
            h = self._page_hash.pop(page)
            del self._registry[h]
            self.prefix_stats['evictions'] += 1
            if self.on_evict is not None:
                self.on_evict(page, h)
            return page
        return None

    def _unref(self, page: int) -> None:
        self._refs[page] -= 1
        assert self._refs[page] >= 0, f'page {page} refcount underflow'
        if self._refs[page] == 0:
            if page in self._page_hash:
                self._cached_free[page] = None
                self._cached_free.move_to_end(page)
            else:
                self._free.append(page)

    def flush_prefix(self) -> int:
        """Unpublish every entry (the adapter stack changed under the
        salts): warm pages return to the free list, referenced ones keep
        their slots and free as plain pages on release. Returns the
        entries flushed."""
        flushed = len(self._registry)
        self._registry.clear()
        self._page_hash.clear()
        self._free.extend(self._cached_free)
        self._cached_free.clear()
        return flushed

    def registered_page(self, h: bytes) -> Optional[int]:
        """The page published under hash `h`, or None."""
        return self._registry.get(h)

    def registered_hashes(self) -> List[bytes]:
        """Every published hash, in publish order."""
        return list(self._registry.keys())

    def prefix_peek(self, lookup_hashes: Sequence[bytes]) -> int:
        """Length of the leading registered run of `lookup_hashes`, read
        only (no refs taken, nothing evicted)."""
        n = 0
        for h in lookup_hashes:
            if h not in self._registry:
                break
            n += 1
        return n

    def install_prefix(self, hashes: Sequence[bytes]
                       ) -> Optional[List[int]]:
        """Allocate and register one page per hash at refcount 0 (warm
        LRU), for contents that arrive from the host tier; the caller
        writes them before any reservation reads them (one stream).
        Draws from the plain free list only, so a promotion never evicts
        published pages. Returns the pages, or None if a hash is already
        registered or the free list cannot cover the run."""
        if any(h in self._registry for h in hashes) or \
                len(hashes) > len(self._free):
            return None
        pages: List[int] = []
        for h in hashes:
            page = self._free.pop()
            self._registry[h] = page
            self._page_hash[page] = h
            self._cached_free[page] = None
            pages.append(page)
        return pages

    def try_reserve(self, slot: int,
                    total_tokens: int) -> Optional[np.ndarray]:
        """Reserve pages covering total_tokens for `slot`, sharing
        nothing. Returns the slot's table row (np [max_pages_per_slot])
        or None if the pool cannot satisfy the reservation."""
        res = self.try_reserve_prefix(slot, total_tokens, ())
        return None if res is None else res[0]

    def try_reserve_prefix(self, slot: int, total_tokens: int,
                           lookup_hashes: Sequence[bytes]
                           ) -> Optional[Tuple[np.ndarray, int]]:
        """Reserve pages covering total_tokens for `slot`, sharing the
        longest registered run of `lookup_hashes`. Returns (table row, n
        shared pages) or None if the pool cannot satisfy it; a doomed
        reservation bails before it evicts anything."""
        n = self.pages_needed(total_tokens)
        assert not self._owned[slot], f'slot {slot} already holds pages'
        shared: List[int] = []
        for h in lookup_hashes[:n]:
            page = self._registry.get(h)
            if page is None:
                break
            shared.append(page)
        for page in shared:
            if self._refs[page] == 0:
                self._cached_free.pop(page, None)
            self._refs[page] += 1
        if n - len(shared) > len(self._free) + len(self._cached_free):
            for page in shared:
                self._unref(page)
            return None
        private = [self._alloc_page() for _ in range(n - len(shared))]
        for page in private:
            self._refs[page] += 1
        self.prefix_stats['hit_pages'] += len(shared)
        self.prefix_stats['miss_pages'] += len(private)
        pages = shared + private
        self._owned[slot] = pages
        row = np.zeros((self.cfg.max_pages_per_slot,), np.int32)
        row[:n] = pages
        self.tables[slot] = row
        return row, len(shared)

    def publish(self, slot: int, hashes: Sequence[bytes]) -> None:
        """Register hash -> page for the slot's leading pages, once their
        writes are enqueued (later readers order after them on the
        stream). A hash or page already published is left as it is."""
        pages = self._owned[slot]
        for h, page in zip(hashes, pages):
            if h in self._registry or page in self._page_hash:
                continue
            self._registry[h] = page
            self._page_hash[page] = h

    def release(self, slot: int) -> None:
        for page in self._owned[slot]:
            self._unref(page)
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

    # ------------------------------------------------ whole-slot views
    @staticmethod
    def gather_view(pool: torch.Tensor,
                    tables: torch.Tensor) -> torch.Tensor:
        """All layers' per-slot contiguous KV view (a copy): pool
        [L, n_pages, H, P, d], tables [slots, max_pages] ->
        [L, slots, max_pages*P, H, d]."""
        l, _, h, p, d = pool.shape
        slots, mp = tables.shape
        v = pool[:, tables.long()]              # [L, slots, mp, H, P, d]
        return v.transpose(3, 4).reshape(l, slots, mp * p, h, d)

    @staticmethod
    def gather_view_q(pool: torch.Tensor, scale_pool: torch.Tensor,
                      tables: torch.Tensor,
                      dtype: torch.dtype) -> torch.Tensor:
        """Dequantizing gather_view: int8 pool [L, n_pages, H, P, d] and
        scale_pool [L, n_pages, H, P] -> [L, slots, max_pages*P, H, d] at
        `dtype` (code * scale in f32, then cast)."""
        l, _, h, p, d = pool.shape
        slots, mp = tables.shape
        t = tables.long()
        v = pool[:, t].float() * scale_pool[:, t][..., None]
        return v.to(dtype).transpose(3, 4).reshape(l, slots, mp * p, h, d)
