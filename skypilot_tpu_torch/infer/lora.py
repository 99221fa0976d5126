"""Multi-LoRA serving: the stacked adapter collection (counterpart of
skypilot_tpu/infer/lora.py).

N adapters are stacked along a leading adapter axis, id 0 being the
all-zeros "no adapter" entry, and the engine routes every sequence
through its own adapter by id (SamplingParams.lora_id). The batched
delta is ops/lora.py (the grouped-LoRA kernels); models/llama.py adds it
to each adapted projection.

The port's stack is a flat dict keyed by the model's module paths:

    {'layers.3.attn.wq': (a [N, in, r], b [N, r, out]), ...,
     'scaling': [N] f32}

A stays [in, r] and B [r, out] per adapter, as in the JAX package;
scaling[i] = alpha_i / rank_i (0 for id 0 and every empty slot). Ranks
may differ between adapters: each is zero-padded to the stack's largest,
which leaves its delta unchanged.

Adapters come in the training layout (train/lora.py init_lora_params) as
nested dicts of numpy arrays,
{'layers': {'attn': {'wq': {'kernel': {'a', 'b'}}}}} with a leading layer
axis (scanned) or {'layer_3': {...}} per layer (unscanned); both map to
the same module paths. The build functions return CPU tensors; the
engine places the stack on its device in the model dtype once, when it
installs it.

Not ported: load_adapter_dir and build_stack_from_specs (they read
Orbax, which needs jax).
"""
import dataclasses
import re
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from skypilot_tpu_torch.models import llama, weights
from skypilot_tpu_torch.utils import log_utils

logger = log_utils.init_logger(__name__)

Stack = Dict[str, Any]

_PROJ_SCOPES = {'wq': 'attn', 'wk': 'attn', 'wv': 'attn', 'wo': 'attn',
                'w_gate': 'mlp', 'w_up': 'mlp', 'w_down': 'mlp'}
_LAYER = re.compile(r'layer_(\d+)$')


@dataclasses.dataclass(frozen=True)
class AdapterSpec:
    name: str
    path: str
    alpha: float = 16.0


def _leaves(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _flatten_adapter(tree: Mapping[str, Any]
                     ) -> Dict[tuple, Dict[str, np.ndarray]]:
    """Training-layout tree -> {collection_path: {'a': leaf, 'b': leaf}}
    where collection_path replaces .../<proj>/kernel with .../<proj>_ab
    (the JAX package's 'lora' collection scope)."""
    flat: Dict[tuple, Dict[str, np.ndarray]] = {}
    for keys, leaf in _leaves(tree):
        if len(keys) < 3 or keys[-1] not in ('a', 'b') or \
                keys[-2] != 'kernel':
            raise ValueError(f'not a LoRA adapter tree: leaf at {keys}')
        ckey = keys[:-3] + (f'{keys[-3]}_ab',)
        flat.setdefault(ckey, {})[keys[-1]] = np.asarray(leaf)
    return flat


def _pad_rank(a: np.ndarray, b: np.ndarray,
              rmax: int) -> Tuple[np.ndarray, np.ndarray]:
    r = a.shape[-1]
    if r == rmax:
        return a, b
    pad_a = [(0, 0)] * (a.ndim - 1) + [(0, rmax - r)]
    pad_b = [(0, 0)] * (b.ndim - 2) + [(0, rmax - r), (0, 0)]
    return np.pad(a, pad_a), np.pad(b, pad_b)


def module_entries(ckey: tuple, a: np.ndarray, b: np.ndarray):
    """One JAX collection path and its leaves -> [(module path, a, b)]:
    ('layers', 'attn', 'wq_ab') with a leading layer axis gives one entry
    per layer; ('layer_3', 'attn', 'wq_ab') gives 'layers.3.attn.wq'."""
    if len(ckey) != 3 or not ckey[-1].endswith('_ab'):
        raise ValueError(f'not a Llama projection scope: {"/".join(ckey)}')
    rest = f'{ckey[1]}.{ckey[2][:-3]}'
    if ckey[0] == 'layers':
        if a.shape[0] != b.shape[0]:
            raise ValueError(f'{"/".join(ckey)}: a and b disagree on the '
                             f'layer axis ({a.shape[0]} vs {b.shape[0]})')
        return [(f'layers.{i}.{rest}', a[i], b[i])
                for i in range(a.shape[0])]
    m = _LAYER.match(ckey[0])
    if m is None:
        raise ValueError(f'not a Llama projection scope: {"/".join(ckey)}')
    return [(f'layers.{m.group(1)}.{rest}', a, b)]


def _module_adapter(tree: Mapping[str, Any]
                    ) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
    """Training-layout tree -> {module path: (a [in, r], b [r, out])}."""
    out = {}
    for ckey, ab in _flatten_adapter(tree).items():
        for key, a, b in module_entries(ckey, ab['a'], ab['b']):
            out[key] = (a, b)
    return out


def _tensor(arr: np.ndarray, dtype: torch.dtype,
            device) -> torch.Tensor:
    return weights.to_tensor(arr).to(device=device, dtype=dtype)


def _assemble(mods: Dict[int, Dict[str, Tuple[np.ndarray, np.ndarray]]],
              alphas: Dict[int, float], num_slots: int, dtype: str,
              device) -> Stack:
    """{id: module adapter} -> the stack with num_slots entries: every id
    not in `mods` is zeros with scaling 0."""
    ids = sorted(mods)
    keys0 = sorted(mods[ids[0]])
    for aid in ids[1:]:
        if sorted(mods[aid]) != keys0:
            raise ValueError(
                f'adapter at id {aid} targets different projections than '
                f'id {ids[0]} — all served adapters must share targets')
    ranks = {aid: m[keys0[0]][0].shape[-1] for aid, m in mods.items()}
    rmax = max(ranks.values())
    tdtype = llama.torch_dtype(dtype)
    stack: Stack = {}
    for key in keys0:
        a0, b0 = mods[ids[0]][key]
        a_all = np.zeros((num_slots,) + a0.shape[:-1] + (rmax,), np.float32)
        b_all = np.zeros((num_slots, rmax) + b0.shape[1:], np.float32)
        for aid in ids:
            a, b = _pad_rank(*mods[aid][key], rmax)
            a_all[aid] = a
            b_all[aid] = b
        stack[key] = (_tensor(a_all, tdtype, device),
                      _tensor(b_all, tdtype, device))
    scaling = np.zeros(num_slots, np.float32)
    for aid in ids:
        scaling[aid] = alphas[aid] / ranks[aid]
    stack['scaling'] = torch.from_numpy(scaling).to(device)
    return stack


def build_stack(adapters: Sequence[Tuple[Mapping[str, Any], float]],
                dtype: str = 'bfloat16', device='cpu') -> Stack:
    """[(adapter_tree, alpha), ...] -> the stack: id 0 is the zeros no-op
    adapter (scaling 0), adapter i gets id i+1."""
    if not adapters:
        raise ValueError('build_stack needs at least one adapter')
    mods = {i: _module_adapter(t) for i, (t, _) in enumerate(adapters, 1)}
    alphas = {i: float(al) for i, (_, al) in enumerate(adapters, 1)}
    stack = _assemble(mods, alphas, len(adapters) + 1, dtype, device)
    logger.info('multi-LoRA stack: %d adapters, ranks %s (padded to %d), '
                '%d adapted projections', len(adapters),
                [adapter_rank(t) for t, _ in adapters],
                stack_rank(stack), len(stack) - 1)
    return stack


def adapter_rank(tree: Mapping[str, Any]) -> int:
    """The LoRA rank of an adapter tree (from any 'a' leaf's trailing dim
    — all projections of one adapter share the rank)."""
    flat = _flatten_adapter(tree)
    return int(next(iter(flat.values()))['a'].shape[-1])


def stack_rank(stack: Stack) -> int:
    """The stack's padded rank."""
    return int(next(a for k, (a, _) in _projections(stack)).shape[-1])


def _projections(stack: Stack):
    return ((k, v) for k, v in stack.items() if k != 'scaling')


def build_stack_assigned(
        assigned: Dict[int, Tuple[Mapping[str, Any], float]],
        num_slots: int, dtype: str = 'bfloat16', device='cpu') -> Stack:
    """{slot id: (adapter tree, alpha)} -> the stack with exactly
    `num_slots` entries. Ids are caller-assigned and stable: id 0 and
    every unassigned id are zeros with scaling 0, so an unloaded adapter
    leaves a hole instead of renumbering its neighbours."""
    if not assigned:
        raise ValueError('build_stack_assigned needs at least one '
                         'assigned adapter')
    for aid in assigned:
        if not 1 <= aid < num_slots:
            raise ValueError(f'adapter id {aid} out of range '
                             f'[1, {num_slots})')
    mods = {aid: _module_adapter(t) for aid, (t, _) in assigned.items()}
    alphas = {aid: float(al) for aid, (_, al) in assigned.items()}
    stack = _assemble(mods, alphas, num_slots, dtype, device)
    logger.info('multi-LoRA stack (assigned): %d/%d slot(s) occupied, '
                'padded rank %d, %d adapted projections', len(assigned),
                num_slots, stack_rank(stack), len(stack) - 1)
    return stack


def graft_adapter(stack: Stack, aid: int, tree: Mapping[str, Any],
                  alpha: float) -> Stack:
    """Graft one adapter into slot `aid` of an existing stack — set for
    aid < N, append for aid == N — without the other adapters' trees.
    Pure: returns a new stack, the input is untouched. Raises ValueError
    when the adapter targets different projections than the stack or its
    rank exceeds the stack's padded rank."""
    mod = _module_adapter(tree)
    n = int(stack['scaling'].shape[0])
    if not 1 <= aid <= n:
        raise ValueError(f'adapter id {aid} out of range [1, {n}]')
    if set(mod) != {k for k, _ in _projections(stack)}:
        raise ValueError(
            'adapter targets different projections than the live stack — '
            'all served adapters must share targets')
    r = adapter_rank(tree)
    stack_r = stack_rank(stack)
    if r > stack_r:
        raise ValueError(f'adapter rank {r} exceeds the stack\'s padded '
                         f'rank {stack_r}')
    out: Stack = {}
    for key, (a_all, b_all) in _projections(stack):
        a, b = _pad_rank(*mod[key], stack_r)
        new = []
        for leaf, val in ((a_all, a), (b_all, b)):
            val = _tensor(val, leaf.dtype, leaf.device)
            if aid < n:
                leaf = leaf.clone()
                leaf[aid] = val
            else:
                leaf = torch.cat([leaf, val[None]])
            new.append(leaf)
        out[key] = tuple(new)
    scaling = stack['scaling']
    val = torch.tensor(float(alpha) / r, dtype=scaling.dtype,
                       device=scaling.device)
    if aid < n:
        scaling = scaling.clone()
        scaling[aid] = val
    else:
        scaling = torch.cat([scaling, val[None]])
    out['scaling'] = scaling
    return out


def zero_slot(stack: Stack, aid: int) -> Stack:
    """Zero one adapter slot (A, B and scaling) — the unload apply: the
    slot becomes the no-op adapter, every other id unchanged. Pure:
    returns a new stack."""
    n = int(stack['scaling'].shape[0])
    if not 1 <= aid < n:
        raise ValueError(f'adapter id {aid} out of range [1, {n})')
    out: Stack = {}
    for key, leaves in _projections(stack):
        new = []
        for leaf in leaves:
            leaf = leaf.clone()
            leaf[aid] = 0
            new.append(leaf)
        out[key] = tuple(new)
    scaling = stack['scaling'].clone()
    scaling[aid] = 0.0
    out['scaling'] = scaling
    return out


# The projections an adapter can sit on: float, int8 and int4 bases.
_PROJ_TYPES = (torch.nn.Linear, llama.QuantLinear, llama.QuantLinear4)


def validate_stack(stack: Stack, model: torch.nn.Module) -> None:
    """Every entry must name an adapted projection of the serving model
    (a Linear, or a quantized base's QuantLinear / QuantLinear4, at
    layers.<i>.attn.<wq|wk|wv|wo> or
    layers.<i>.mlp.<w_gate|w_up|w_down>) with A [N, in_features, r] and
    B [N, r, out_features], one N shared with scaling [N].

    Without this a stack from another model (other depth or widths)
    fails silently or late: a projection the model does not have is
    never read, so adapter requests would serve base-model outputs."""
    if 'scaling' not in stack:
        raise ValueError('LoRA stack has no scaling entry')
    n = int(stack['scaling'].shape[0])
    bad = []
    for key, ab in _projections(stack):
        parts = key.split('.')
        try:
            lin = model.get_submodule(key)
        except AttributeError:
            lin = None
        ok = (len(parts) == 4 and parts[0] == 'layers' and
              _PROJ_SCOPES.get(parts[3]) == parts[2] and
              isinstance(lin, _PROJ_TYPES) and len(ab) == 2)
        if ok:
            a, b = ab
            ok = (a.dim() == 3 and b.dim() == 3 and
                  a.shape[:2] == (n, lin.in_features) and
                  b.shape[0] == n and b.shape[1] == a.shape[2] and
                  b.shape[2] == lin.out_features)
        if not ok:
            bad.append(key)
    if bad:
        raise ValueError(
            'LoRA stack does not match the serving model — these adapted '
            'projections have no counterpart of that shape in the model '
            f'(another model\'s adapter?): {sorted(bad)[:5]}')


def place_stack(stack: Stack, dtype: torch.dtype, device) -> Stack:
    """The stack with A/B in `dtype` and everything on `device` (scaling
    stays f32): the same object when it already is, else one copy."""
    def placed(t, dt):
        return t.device == torch.device(device) and t.dtype == dt and \
            t.is_contiguous()
    if all(placed(a, dtype) and placed(b, dtype)
           for _, (a, b) in _projections(stack)) and \
            placed(stack['scaling'], torch.float32):
        return stack
    out: Stack = {k: (a.to(device=device, dtype=dtype).contiguous(),
                      b.to(device=device, dtype=dtype).contiguous())
                  for k, (a, b) in _projections(stack)}
    out['scaling'] = stack['scaling'].to(device=device,
                                         dtype=torch.float32)
    return out


def parse_lora_flag(values: Optional[List[str]]) -> List[AdapterSpec]:
    """--lora name=path[:alpha], repeatable."""
    specs = []
    for v in values or []:
        if '=' not in v:
            raise ValueError(
                f'--lora expects name=path[:alpha], got {v!r}')
        name, rest = v.split('=', 1)
        alpha = 16.0
        if ':' in rest:
            # Split from the right so gs:// style paths keep working
            # when no alpha is given; a float parse decides.
            head, tail = rest.rsplit(':', 1)
            try:
                alpha = float(tail)
                rest = head
            except ValueError:
                pass
        specs.append(AdapterSpec(name=name, path=rest, alpha=alpha))
    if len({s.name for s in specs}) != len(specs):
        raise ValueError('duplicate --lora adapter names')
    return specs
