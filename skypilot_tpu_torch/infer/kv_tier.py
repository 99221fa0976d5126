"""Host-RAM tier of the prefix-KV cache (counterpart of
skypilot_tpu/infer/kv_tier.py, its L2 part).

  L1 (device)  the PagePool registry, the only tier the kernels read.
  L2 (host)    HostKVStore: a byte-budgeted LRU of evicted pages, keyed
               by the same chained content hashes. The engine's eviction
               hook clones the page on the device stream (before the
               insert that reuses it) and records an event; the writer
               thread waits on that event and copies the clone to host
               memory. On a registry miss whose hash run is host-resident
               the engine installs the pages back (a byte copy) and shares
               them.

The fleet tier (L3: GET /kv/prefix, peer fetch, prewarm) needs the HTTP
routes and is not ported: SKYT_KV_TIER=fleet raises in the engine.

Pages are CPU torch tensors at pool dtype ([L, H, P, d] codes or values,
[L, H, P] f32 scales), so a promoted page is byte-identical to the page
that spilled. The SKV1 codec (encode_pages / decode_pages) writes the
JAX package's wire format byte for byte: bfloat16 arrays travel as their
little-endian 2-byte words under the dtype tag 'bfloat16', so payloads
cross between a JAX replica and a port replica in both directions.

Every entry carries a version (the engine's kv_version, which each
prefix flush bumps; the wire format's 'weight_version'); lookups and
writes are gated on it, so pages computed before a flush never come back
after it.
"""
import collections
import json
import struct
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from skypilot_tpu_torch.utils import env
from skypilot_tpu_torch.utils import log_utils

logger = log_utils.init_logger(__name__)

TIERS = ('off', 'host', 'fleet')

# Wire format: magic + u32 header length + JSON header + the arrays' raw
# bytes, in header order.
_MAGIC = b'SKV1'

# Dtype tags of the wire format (numpy's names, as the JAX package writes
# them) and the torch dtypes they stand for.
_DTYPES = {'bfloat16': torch.bfloat16, 'float16': torch.float16,
           'float32': torch.float32, 'int8': torch.int8}
_TAGS = {v: k for k, v in _DTYPES.items()}

PageArrays = Dict[str, torch.Tensor]

FLEET_UNPORTED = ('SKYT_KV_TIER=fleet is not ported: the fleet tier (peer '
                  'fetch, prewarm) needs the /kv/prefix and /kv/index '
                  'HTTP routes, not ported yet; use "host" or "off"')


def tier_from_env() -> str:
    """The configured tier; a bad value degrades to 'off' with a
    warning."""
    t = (env.get('SKYT_KV_TIER', 'off') or 'off').strip().lower()
    if t not in TIERS:
        logger.warning('SKYT_KV_TIER=%r is not one of %s; tiering off',
                       t, TIERS)
        return 'off'
    return t


def encode_pages(pages: Sequence[Tuple[bytes, PageArrays]],
                 weight_version: int) -> bytes:
    """Serialize a page run (SKV1): raw bytes, no pickle."""
    header: Dict[str, Any] = {'v': 1,
                              'weight_version': int(weight_version),
                              'pages': []}
    blobs: List[bytes] = []
    for h, arrays in pages:
        entry = {'hash': h.hex(), 'arrays': []}
        for name in sorted(arrays):
            a = arrays[name].detach().cpu().contiguous()
            entry['arrays'].append({'name': name, 'dtype': _TAGS[a.dtype],
                                    'shape': list(a.shape)})
            blobs.append(a.view(torch.uint8).numpy().tobytes())
        header['pages'].append(entry)
    hj = json.dumps(header, sort_keys=True).encode('utf-8')
    return b''.join([_MAGIC, struct.pack('<I', len(hj)), hj] + blobs)


def decode_pages(data: bytes
                 ) -> Tuple[int, List[Tuple[bytes, PageArrays]]]:
    """Inverse of encode_pages: (weight_version, pages). Raises
    ValueError on a malformed payload."""
    if len(data) < 8 or data[:4] != _MAGIC:
        raise ValueError('bad kv transfer magic')
    (hlen,) = struct.unpack('<I', data[4:8])
    if 8 + hlen > len(data):
        raise ValueError('truncated kv transfer header')
    header = json.loads(data[8:8 + hlen].decode('utf-8'))
    off = 8 + hlen
    out: List[Tuple[bytes, PageArrays]] = []
    for entry in header['pages']:
        arrays: PageArrays = {}
        for spec in entry['arrays']:
            if spec['dtype'] not in _DTYPES:
                raise ValueError(f'unknown kv dtype {spec["dtype"]!r}')
            dt = _DTYPES[spec['dtype']]
            shape = [int(x) for x in spec['shape']]
            n = dt.itemsize * int(torch.Size(shape).numel())
            if off + n > len(data):
                raise ValueError('truncated kv transfer body')
            raw = torch.frombuffer(bytearray(data[off:off + n]),
                                   dtype=torch.uint8)
            arrays[spec['name']] = raw.view(dt).reshape(shape)
            off += n
        out.append((bytes.fromhex(entry['hash']), arrays))
    return int(header['weight_version']), out


def page_nbytes(arrays: PageArrays) -> int:
    return sum(a.numel() * a.element_size() for a in arrays.values())


class HostKVStore:
    """Thread-safe byte-budgeted LRU of spilled prefix pages (L2), keyed
    by content hash, each entry stamped with its version.
    set_version prunes other versions and gates later puts."""

    def __init__(self, budget_bytes: int) -> None:
        self.budget_bytes = max(0, int(budget_bytes))
        self._lock = threading.Lock()
        # hash -> (version, arrays, nbytes); order is recency.
        self._entries: 'collections.OrderedDict[bytes, Tuple[int, PageArrays, int]]' = \
            collections.OrderedDict()
        self._bytes = 0
        self._version: Optional[int] = None
        self.stats = {'puts': 0, 'put_drops': 0, 'evictions': 0,
                      'hits': 0, 'misses': 0, 'invalidated': 0}

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def set_version(self, version: int) -> int:
        """Drop every entry of another version and gate later puts to
        `version`. Returns the entries dropped."""
        with self._lock:
            self._version = int(version)
            stale = [h for h, (v, _, _) in self._entries.items()
                     if v != self._version]
            for h in stale:
                self._bytes -= self._entries.pop(h)[2]
            self.stats['invalidated'] += len(stale)
            return len(stale)

    def put(self, h: bytes, version: int, arrays: PageArrays) -> bool:
        nb = page_nbytes(arrays)
        with self._lock:
            if (self._version is not None and int(version) != self._version
                    or nb > self.budget_bytes):
                self.stats['put_drops'] += 1
                return False
            old = self._entries.pop(h, None)
            if old is not None:
                self._bytes -= old[2]
            while self._bytes + nb > self.budget_bytes and self._entries:
                _, (_, _, enb) = self._entries.popitem(last=False)
                self._bytes -= enb
                self.stats['evictions'] += 1
            self._entries[h] = (int(version), arrays, nb)
            self._bytes += nb
            self.stats['puts'] += 1
            return True

    def discard(self, h: bytes) -> None:
        """Drop one entry, any version (a page that failed the layout
        check)."""
        with self._lock:
            ent = self._entries.pop(h, None)
            if ent is not None:
                self._bytes -= ent[2]

    def get(self, h: bytes, version: int) -> Optional[PageArrays]:
        with self._lock:
            ent = self._entries.get(h)
            if ent is None or ent[0] != int(version):
                self.stats['misses'] += 1
                return None
            self._entries.move_to_end(h)
            self.stats['hits'] += 1
            return ent[1]

    def contains(self, h: bytes, version: int) -> bool:
        """Presence probe: no recency bump, no stats."""
        with self._lock:
            ent = self._entries.get(h)
            return ent is not None and ent[0] == int(version)

    def run(self, hashes: Sequence[bytes], version: int
            ) -> List[Tuple[bytes, PageArrays]]:
        """The leading resident run of `hashes` at `version`."""
        out: List[Tuple[bytes, PageArrays]] = []
        for h in hashes:
            arrays = self.get(h, version)
            if arrays is None:
                break
            out.append((h, arrays))
        return out

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {'entries': len(self._entries), 'bytes': self._bytes,
                    'budget_bytes': self.budget_bytes,
                    **{k: int(v) for k, v in self.stats.items()}}


class KVTierManager:
    """The engine's handle on the host tier: the store and the spill
    writer thread. Built only when SKYT_KV_TIER=host."""

    def __init__(self, host_bytes: Optional[int] = None) -> None:
        self.tier = 'host'
        self.host = HostKVStore(
            host_bytes if host_bytes is not None
            else env.get_int('SKYT_KV_HOST_BYTES'))
        # The pool's page layout, name -> (torch dtype, shape), which
        # promoted pages are checked against (None: no check).
        self.page_layout: Optional[Dict[str, Tuple[torch.dtype,
                                                   Tuple[int, ...]]]] = None
        # Spill queue of (hash, version, device clones, ready event);
        # bounded: a dropped spill costs a later recompute, an unbounded
        # queue would pin device memory.
        self._spill_q: 'collections.deque[Tuple[bytes, int, PageArrays, Any]]' = \
            collections.deque()
        self._spill_limit = 256
        self._busy = 0        # items popped, not yet stored
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._writer: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        # spill_s: the writer's seconds in its copies to host memory and
        # puts (from the event's completion on).
        self.stats = {'spill_enqueued': 0, 'spill_dropped': 0,
                      'spill_stored': 0, 'spill_s': 0.0, 'promotions': 0,
                      'promoted_pages': 0}

    # ----------------------------------------------------------- spill
    def start(self) -> None:
        if self._writer is None or not self._writer.is_alive():
            self._stop.clear()
            self._writer = threading.Thread(
                target=self._writer_loop, daemon=True,
                name='kv-tier-writer')
            self._writer.start()

    def stop(self) -> None:
        self._stop.set()
        self._wake.set()
        if self._writer is not None:
            self._writer.join(timeout=5)

    def enqueue_spill(self, h: bytes, version: int, device_arrays: PageArrays,
                      ready=None) -> None:
        """Engine side of the spill: `device_arrays` are clones of the
        evicted page enqueued before the insert that reuses it; `ready`
        (a CUDA event recorded after the clones, or None on the CPU) is
        what the writer waits on before its copy to host memory."""
        with self._lock:
            if len(self._spill_q) >= self._spill_limit:
                self.stats['spill_dropped'] += 1
                return
            self._spill_q.append((h, int(version), device_arrays, ready))
            self.stats['spill_enqueued'] += 1
        self._wake.set()

    def _writer_loop(self) -> None:
        while not self._stop.is_set():
            with self._lock:
                item = self._spill_q.popleft() if self._spill_q else None
                self._busy += item is not None
            if item is None:
                self._wake.wait(0.05)
                self._wake.clear()
                continue
            h, version, device_arrays, ready = item
            try:
                if ready is not None:
                    ready.synchronize()
                t0 = time.perf_counter()
                arrays = {k: v.to('cpu') for k, v in device_arrays.items()}
                stored = self.host.put(h, version, arrays)
                with self._lock:
                    self.stats['spill_s'] += time.perf_counter() - t0
                    self.stats['spill_stored'] += int(stored)
            except Exception:  # pylint: disable=broad-except
                # A failed spill costs a later recompute, never a request.
                logger.exception('kv spill write failed')
            finally:
                with self._lock:
                    self._busy -= 1

    def drain(self, timeout_s: float = 5.0) -> bool:
        """Block until every queued spill is stored (tests, benches)."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            with self._lock:
                if not self._spill_q and not self._busy:
                    return True
            self._wake.set()
            time.sleep(0.01)
        return False

    # ---------------------------------------------------------- layout
    def set_page_layout(self, layout: Dict[str, Tuple[torch.dtype,
                                                     Tuple[int, ...]]]
                        ) -> None:
        self.page_layout = dict(layout)

    def validate_page(self, arrays: PageArrays) -> Optional[str]:
        """None when `arrays` matches the pool's page layout, else the
        mismatch."""
        layout = self.page_layout
        if layout is None:
            return None
        if set(arrays) != set(layout):
            return (f'array keys {sorted(arrays)} != pool keys '
                    f'{sorted(layout)}')
        for name, (dt, shape) in layout.items():
            a = arrays[name]
            if a.dtype != dt or tuple(a.shape) != tuple(shape):
                return (f'{name}: {a.dtype}{list(a.shape)} != pool '
                        f'{dt}{list(shape)}')
        return None

    def note_promotion(self, pages: int) -> None:
        with self._lock:
            self.stats['promotions'] += 1
            self.stats['promoted_pages'] += pages

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            stats = dict(self.stats)
        return {'tier': self.tier, 'host': self.host.snapshot(), **stats}
