"""Tokenizers for the serving path: the port's copy of
skypilot_tpu/infer/tokenizer.py (ByteTokenizer, HFTokenizer,
load_tokenizer, load_chat_template, special_token_strings), so the HTTP
server accepts raw text.

  * HFTokenizer: a HuggingFace `tokenizer.json` through the `tokenizers`
    runtime (imported where it is built: an optional dependency); bos/eos
    ids resolved from tokenizer_config.json / config.json when present.
  * ByteTokenizer: dependency-free byte-level fallback for debug models,
    random-weight serving and tests.

`load_tokenizer(path)`: a directory or tokenizer.json file ->
HFTokenizer; None -> ByteTokenizer.
"""
import json
import os
from typing import List, Optional

from skypilot_tpu_torch.utils import log_utils

logger = log_utils.init_logger(__name__)


class ByteTokenizer:
    """UTF-8 bytes as token ids (mod vocab). Debug/test fallback only."""

    def __init__(self, vocab_size: int = 256) -> None:
        self.vocab_size = vocab_size
        self.bos_id: Optional[int] = None
        self.eos_id: Optional[int] = None

    def encode(self, text: str, add_bos: bool = False) -> List[int]:
        del add_bos
        return [b % self.vocab_size for b in text.encode()]

    def decode(self, tokens: List[int]) -> str:
        return bytes(t for t in tokens if 0 < t < 256).decode(
            'utf-8', errors='replace')


class HFTokenizer:
    """A HuggingFace fast tokenizer loaded from tokenizer.json.

    Uses the `tokenizers` runtime directly (no transformers import on the
    serving path — it is heavy and pulls torch).
    """

    def __init__(self, tokenizer_json: str,
                 bos_id: Optional[int] = None,
                 eos_id: Optional[int] = None) -> None:
        import tokenizers  # local import: optional dependency

        self._tok = tokenizers.Tokenizer.from_file(tokenizer_json)
        self.vocab_size = self._tok.get_vocab_size()
        self.bos_id = bos_id
        self.eos_id = eos_id
        if bos_id is None or eos_id is None:
            auto_bos, auto_eos = _special_ids_near(tokenizer_json, self._tok)
            self.bos_id = bos_id if bos_id is not None else auto_bos
            self.eos_id = eos_id if eos_id is not None else auto_eos

    def encode(self, text: str, add_bos: bool = True) -> List[int]:
        ids = self._tok.encode(text, add_special_tokens=False).ids
        if add_bos and self.bos_id is not None and (
                not ids or ids[0] != self.bos_id):
            ids = [self.bos_id] + ids
        return ids

    def decode(self, tokens: List[int]) -> str:
        # bos/eos may not be flagged special in the vocab; strip by id.
        specials = {self.bos_id, self.eos_id}
        toks = [t for t in tokens if t not in specials]
        return self._tok.decode(toks, skip_special_tokens=True)


def _sibling_configs(d: str):
    """Yield parsed tokenizer_config.json / config.json dicts from a
    checkpoint dir (skipping unreadable files)."""
    for fname in ('tokenizer_config.json', 'config.json'):
        path = os.path.join(d, fname)
        if not os.path.exists(path):
            continue
        try:
            with open(path, encoding='utf-8') as f:
                yield json.load(f)
        except (OSError, ValueError):
            continue


def _special_ids_near(tokenizer_json: str, tok
                      ) -> 'tuple[Optional[int], Optional[int]]':
    """Resolve bos/eos ids from sibling HF config files, falling back to
    well-known token strings in the vocab."""
    d = os.path.dirname(os.path.abspath(tokenizer_json))
    bos_tok = eos_tok = None
    for cfg in _sibling_configs(d):
        # config.json carries ids; tokenizer_config.json carries strings.
        if isinstance(cfg.get('bos_token_id'), int):
            return cfg['bos_token_id'], _first_int(cfg.get('eos_token_id'))
        bos_tok = bos_tok or _token_str(cfg.get('bos_token'))
        eos_tok = eos_tok or _token_str(cfg.get('eos_token'))
    candidates_bos = [bos_tok, '<|begin_of_text|>', '<s>', '<bos>']
    candidates_eos = [eos_tok, '<|end_of_text|>', '</s>', '<eos>']
    bos_id = _first_vocab_id(tok, candidates_bos)
    eos_id = _first_vocab_id(tok, candidates_eos)
    return bos_id, eos_id


def _token_str(val):
    if isinstance(val, str):
        return val
    if isinstance(val, dict):  # AddedToken serialization
        return val.get('content')
    return None


def _first_int(val):
    if isinstance(val, int):
        return val
    if isinstance(val, list) and val and isinstance(val[0], int):
        return val[0]  # llama-3.1 style eos list; first is <|end_of_text|>
    return None


def _first_vocab_id(tok, candidates) -> Optional[int]:
    for c in candidates:
        if not c:
            continue
        tid = tok.token_to_id(c)
        if tid is not None:
            return tid
    return None


def load_tokenizer(path: Optional[str] = None,
                   vocab_size: int = 256):
    """Factory: path to a checkpoint dir / tokenizer.json -> HFTokenizer;
    None -> ByteTokenizer(vocab_size)."""
    if path is None:
        return ByteTokenizer(vocab_size)
    if os.path.isdir(path):
        tj = os.path.join(path, 'tokenizer.json')
        if not os.path.exists(tj):
            raise FileNotFoundError(f'no tokenizer.json under {path}')
        path = tj
    logger.info('loading tokenizer from %s', path)
    return HFTokenizer(path)


def load_chat_template(path: str) -> 'Optional[str]':
    """The checkpoint's HF chat template (jinja source), if any.

    path: tokenizer dir or tokenizer.json path (an explicit template
    FILE override is read by the caller — server main's
    --chat-template — so a bad override fails loudly there instead of
    being silently reinterpreted as a directory here).
    tokenizer_config.json carries it as a string, or (newer multi-
    template format) a list of {'name', 'template'} dicts — 'default'
    wins, then a 'chat'-named entry; an arbitrary fallback pick is
    logged loudly (a silently chosen 'tool_use'/'rag' template would
    change every /v1/chat/completions prompt — ADVICE r5). The
    reference gets this rendering from vLLM, which reads the same
    field."""
    d = path if os.path.isdir(path) else os.path.dirname(
        os.path.abspath(path))
    for cfg in _sibling_configs(d):
        tpl = cfg.get('chat_template')
        if isinstance(tpl, str):
            return tpl
        if isinstance(tpl, list):
            by_name = {t.get('name'): t.get('template') for t in tpl
                       if isinstance(t, dict)}
            for want in ('default', 'chat'):
                if by_name.get(want):
                    logger.info(
                        'chat template: using %r of %d named templates '
                        '(%s)', want, len(by_name),
                        ', '.join(map(str, sorted(
                            k for k in by_name if k is not None))))
                    return by_name[want]
            name, chosen = next(
                ((n, t) for n, t in by_name.items() if t),
                (None, None))
            if chosen is not None:
                logger.warning(
                    "chat template: no 'default' or 'chat' entry among "
                    '%s; falling back to %r — pass --chat-template to '
                    'override', sorted(k for k in by_name
                                       if k is not None), name)
            return chosen
    return None


def special_token_strings(path: str) -> 'dict':
    """{'bos_token': ..., 'eos_token': ...} STRINGS for chat-template
    rendering — unresolved keys are OMITTED so jinja renders them as
    '' (Undefined) instead of the literal text 'None'."""
    d = path if os.path.isdir(path) else os.path.dirname(
        os.path.abspath(path))
    out = {}
    for cfg in _sibling_configs(d):
        for key in ('bos_token', 'eos_token'):
            if key not in out:
                val = _token_str(cfg.get(key))
                if val is not None:
                    out[key] = val
    return out
