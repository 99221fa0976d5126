"""The safetensors format without the `safetensors` package (the port's
counterpart of skypilot_tpu/models/weights.py's _ShardReader and of the
safetensors.numpy.save_file call there).

A file is an 8-byte little-endian header length N, then N bytes of JSON
({name: {"dtype": "BF16", "shape": [...], "data_offsets": [begin, end]}}
plus an optional "__metadata__" of strings), then the tensors' raw
little-endian bytes, offsets counted from the end of the header.

  * ShardReader maps each file once (mmap, read-only) and gives CPU
    tensors of the header's dtype through torch.frombuffer at the
    tensor's offset: get(name) the whole tensor, get_rows(name, start,
    stop) only those rows. It takes a directory of one or several
    *.safetensors files, or model.safetensors.index.json's weight_map.
    The tensors it returns VIEW the read-only map: copy them (the
    loader copies each one to its device and dtype) and drop the views
    before close(), which unmaps the files.
  * save_file writes one file, the header padded with spaces to a
    multiple of 8 bytes as the package pads it, tensors in the order
    given, each written from its own CPU copy (a CUDA state_dict is
    never whole on the host).
"""
import json
import mmap
import os
import struct
import sys
import warnings
from typing import Dict, Iterable, List, Mapping, Optional, Tuple

import torch

INDEX_FILE = 'model.safetensors.index.json'

DTYPES: Dict[str, torch.dtype] = {
    'BF16': torch.bfloat16, 'F16': torch.float16, 'F32': torch.float32,
    'F64': torch.float64, 'I8': torch.int8, 'U8': torch.uint8,
    'I16': torch.int16, 'I32': torch.int32, 'I64': torch.int64,
    'BOOL': torch.bool}
_NAMES = {v: k for k, v in DTYPES.items()}

if sys.byteorder != 'little':   # pragma: no cover - every supported host
    raise ImportError('safetensors_io reads and writes little-endian '
                      'bytes in place; this host is big-endian')


def dtype_name(dtype: torch.dtype) -> str:
    if dtype not in _NAMES:
        raise ValueError(f'safetensors has no dtype for {dtype}')
    return _NAMES[dtype]


def read_header(path: str) -> Tuple[Dict[str, dict], int]:
    """(the JSON header without __metadata__, the data's start offset)."""
    with open(path, 'rb') as f:
        raw = f.read(8)
        if len(raw) != 8:
            raise ValueError(f'{path}: not a safetensors file')
        (n,) = struct.unpack('<Q', raw)
        header = json.loads(f.read(n))
    header.pop('__metadata__', None)
    return header, 8 + n


class _File:

    def __init__(self, path: str) -> None:
        self.path = path
        self.header, self.start = read_header(path)
        with open(path, 'rb') as f:
            size = os.fstat(f.fileno()).st_size
            self.map = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ) \
                if size else None
        for name, meta in self.header.items():
            lo, hi = meta['data_offsets']
            if meta['dtype'] not in DTYPES:
                raise ValueError(f'{path}: {name} has dtype '
                                 f'{meta["dtype"]}, not one of '
                                 f'{sorted(DTYPES)}')
            if not 0 <= lo <= hi <= size - self.start:
                raise ValueError(f'{path}: {name} lies outside the file')
            n = torch.empty((), dtype=DTYPES[meta['dtype']]).element_size()
            for d in meta['shape']:
                n *= d
            if hi - lo != n:
                raise ValueError(f'{path}: {name} holds {hi - lo} bytes, '
                                 f'its shape and dtype {n}')

    def tensor(self, name: str, start: Optional[int] = None,
               stop: Optional[int] = None) -> torch.Tensor:
        meta = self.header[name]
        dtype = DTYPES[meta['dtype']]
        shape: List[int] = list(meta['shape'])
        lo, _ = meta['data_offsets']
        itemsize = torch.empty((), dtype=dtype).element_size()
        if start is not None:
            if not shape:
                raise ValueError(f'{name} is a scalar: it has no rows')
            row = itemsize
            for d in shape[1:]:
                row *= d
            start, stop, _ = slice(start, stop).indices(shape[0])
            stop = max(start, stop)
            lo += start * row
            shape[0] = stop - start
        count = 1
        for d in shape:
            count *= d
        if count == 0:
            return torch.empty(shape, dtype=dtype)
        with warnings.catch_warnings():
            # The map is read-only, and torch warns that it cannot mark
            # a tensor so; the loader only ever copies from these views.
            warnings.simplefilter('ignore', UserWarning)
            flat = torch.frombuffer(self.map, dtype=dtype, count=count,
                                    offset=self.start + lo)
        return flat.view(shape)

    def close(self) -> None:
        if self.map is not None:
            try:
                self.map.close()
            except BufferError:
                # A view is still alive (say, in an exception's frames):
                # the map closes when the last view goes.
                pass
            self.map = None


class ShardReader:
    """Random access over a sharded or unsharded safetensors checkpoint
    directory (or one .safetensors file). Use as a context manager, or
    call close() once every returned view is gone."""

    def __init__(self, path: str) -> None:
        if os.path.isfile(path):
            self.ckpt_dir, files = os.path.dirname(path), [
                os.path.basename(path)]
            index = None
        else:
            self.ckpt_dir = path
            index = os.path.join(path, INDEX_FILE)
            if os.path.exists(index):
                with open(index, encoding='utf-8') as f:
                    weight_map = json.load(f)['weight_map']
                files = sorted(set(weight_map.values()))
            else:
                index = None
                files = sorted(f for f in os.listdir(path)
                               if f.endswith('.safetensors'))
            if not files:
                raise FileNotFoundError(f'no *.safetensors under {path}')
        self._files: Dict[str, _File] = {}
        self._where: Dict[str, str] = {}
        try:
            for fname in files:
                fh = _File(os.path.join(self.ckpt_dir, fname))
                self._files[fname] = fh
                if index is None:
                    for key in fh.header:
                        self._where[key] = fname
            if index is not None:
                for key, fname in weight_map.items():
                    if key not in self._files[fname].header:
                        raise ValueError(f'{INDEX_FILE} puts {key} in '
                                         f'{fname}, which lacks it')
                    self._where[key] = fname
        except BaseException:
            self.close()
            raise

    def __enter__(self) -> 'ShardReader':
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __contains__(self, name: str) -> bool:
        return name in self._where

    def keys(self) -> List[str]:
        return list(self._where)

    def get(self, name: str) -> torch.Tensor:
        """The whole tensor: a CPU view of the map, in the file's dtype."""
        return self._files[self._where[name]].tensor(name)

    def get_rows(self, name: str, start: int, stop: int) -> torch.Tensor:
        """Only rows [start, stop) of the tensor leave the map (phi3's
        fused qkv_proj splits by rows)."""
        return self._files[self._where[name]].tensor(name, start, stop)

    def close(self) -> None:
        for fh in self._files.values():
            fh.close()


def _header_bytes(entries: Dict[str, dict],
                  metadata: Optional[Mapping[str, str]]) -> bytes:
    head = dict(entries)
    if metadata:
        head = {'__metadata__': {str(k): str(v)
                                 for k, v in metadata.items()}, **head}
    raw = json.dumps(head, separators=(',', ':')).encode('utf-8')
    return raw + b' ' * (-len(raw) % 8)


def save_file(tensors: Iterable[Tuple[str, torch.Tensor]], path: str,
              metadata: Optional[Mapping[str, str]] = None) -> int:
    """Write (name, tensor) pairs, in their order, as one safetensors
    file; returns the bytes written. Tensors may live on any device: each
    is copied to the host on its own as it is written."""
    items = list(tensors) if not isinstance(tensors, Mapping) else \
        list(tensors.items())
    entries: Dict[str, dict] = {}
    off = 0
    for name, t in items:
        if name in entries:
            raise ValueError(f'tensor {name} given twice')
        n = t.numel() * t.element_size()
        entries[name] = {'dtype': dtype_name(t.dtype),
                         'shape': list(t.shape),
                         'data_offsets': [off, off + n]}
        off += n
    header = _header_bytes(entries, metadata)
    tmp = path + '.tmp'
    with open(tmp, 'wb') as f:
        f.write(struct.pack('<Q', len(header)))
        f.write(header)
        for _, t in items:
            host = t.detach().to('cpu').contiguous()
            if host.numel():
                f.write(memoryview(host.reshape(-1).view(torch.uint8)
                                   .numpy()))
    os.replace(tmp, path)
    return 8 + len(header) + off
