"""LoRA adapters for finetuning (counterpart of skypilot_tpu/train/lora.py).

Every targeted projection W [out, in] (a models/llama.py Linear) gains
an adapter A [in, r], B [r, out] (the JAX package's shapes: A and B
apply to the [in, out] kernel). The merge W + scaling * (A @ B)^T,
scaling = alpha / rank, happens at use, in W's dtype (the f32 master; A
and B are made in it), before the Linear's usual cast to the compute
dtype: it is a torch.nn.utils.parametrize parametrization of the frozen
weight, so it runs inside each block's forward. Under the per-block remat only that
block's merged weights exist at a time (the backward recomputes them);
no merged copy of the whole model is ever held. A ~ N(0, 1) / rank,
B = 0: step 0 is exactly the base model.

Training: apply_lora freezes every base parameter (requires_grad
False) and returns the adapters; create_lora_state builds the trainer's
state over the adapters only (AdamW's moments cover A and B, nothing of
the base), and trainer.make_train_step is the LoRA step as it is: its
loss, global norm, clipping and AdamW see only the parameters the
state's optimizer holds. The merge-at-use backward computes each merged
weight's full gradient on its way to dA and dB, as the reference's
value_and_grad through merge_lora does; the base's gradients are never
kept.

One adapter layout for the whole lifecycle: adapter_tree gives the
training layout of the JAX package (scanned: {'layers': {'attn': {'wq':
{'kernel': {'a' [L, in, r], 'b' [L, r, out]}}}}}), which sft's
checkpoints hold, export_lora merges and infer/lora.py's build
functions serve. adapters_from_jax reads the reference's
init_lora_params tree (scanned or unscanned) the same way.

Not ported: LoRA on a Mixture-of-Experts model (apply_lora raises; it
waits for MoE training, ROADMAP queue 1 item 11).
"""
import dataclasses
from typing import Any, Dict, Mapping, Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn.utils import parametrize

from skypilot_tpu_torch.train import trainer
from skypilot_tpu_torch.utils import log_utils

logger = log_utils.init_logger(__name__)

# Every linear of attention and the MLP (the reference's targets).
DEFAULT_TARGETS = ('wq', 'wk', 'wv', 'wo', 'w_gate', 'w_up', 'w_down')

Adapters = Dict[str, Tuple[nn.Parameter, nn.Parameter]]


@dataclasses.dataclass(frozen=True)
class LoRAConfig:
    rank: int = 8
    alpha: float = 16.0
    targets: Sequence[str] = DEFAULT_TARGETS

    @property
    def scaling(self) -> float:
        return self.alpha / self.rank


class LoRAMerge(nn.Module):
    """The parametrization of one frozen weight W [out, in]: W + scaling
    * (A @ B)^T in W's dtype (merge_lora's W + scaling * (A @ B)), as one
    addmm: (A @ B)^T = B^T @ A^T, with W added and the scaling applied in
    the GEMM's epilogue, so no full-size product, scaled copy or sum is
    written (forward or backward)."""

    def __init__(self, a: torch.Tensor, b: torch.Tensor,
                 scaling: float) -> None:
        super().__init__()
        self.a = nn.Parameter(a)
        self.b = nn.Parameter(b)
        self.scaling = scaling

    def forward(self, w: torch.Tensor) -> torch.Tensor:
        return torch.addmm(w, self.b.t(), self.a.t(), alpha=self.scaling)


def target_modules(model: nn.Module, cfg: LoRAConfig) -> Dict[str, nn.Linear]:
    """{module path: Linear} for every targeted projection, in module
    order (layer by layer; wq, wk, wv, wo, then w_gate, w_up, w_down)."""
    return {name: mod for name, mod in model.named_modules()
            if isinstance(mod, nn.Linear) and
            name.rsplit('.', 1)[-1] in cfg.targets}


def _refuse_moe(model: nn.Module) -> None:
    if any(hasattr(layer, 'moe_mlp') for layer in getattr(model, 'layers',
                                                          ())):
        raise NotImplementedError(
            'LoRA on a Mixture-of-Experts model is not ported yet: it waits '
            'for MoE training (ROADMAP queue 1 item 11)')


def apply_lora(model: nn.Module, cfg: LoRAConfig,
               generator: torch.Generator) -> Adapters:
    """Freeze every base parameter and parametrize each targeted weight
    with a fresh adapter (A ~ N(0, 1) / rank from `generator`, B = 0, in
    the weight's dtype and device). Returns {module path: (A, B)}."""
    _refuse_moe(model)
    targets = target_modules(model, cfg)
    if not targets:
        raise ValueError(f'no projections matched LoRA targets '
                         f'{tuple(cfg.targets)!r}')
    for p in model.parameters():
        p.requires_grad_(False)
    adapters: Adapters = {}
    for name, lin in targets.items():
        w = lin.weight
        a = torch.randn((lin.in_features, cfg.rank), generator=generator,
                        dtype=w.dtype, device=w.device) * (1.0 / cfg.rank)
        b = torch.zeros((cfg.rank, lin.out_features), dtype=w.dtype,
                        device=w.device)
        merge = LoRAMerge(a, b, cfg.scaling)
        parametrize.register_parametrization(lin, 'weight', merge)
        adapters[name] = (merge.a, merge.b)
    logger.info('LoRA: %d adapted projections, rank=%d alpha=%.1f, %d '
                'trainable params', len(adapters), cfg.rank, cfg.alpha,
                num_lora_params(adapters))
    return adapters


def num_lora_params(adapters: Adapters) -> int:
    return sum(a.numel() + b.numel() for a, b in adapters.values())


def adapter_tree(adapters: Adapters) -> Dict[str, Any]:
    """The adapters in the training layout, scanned (A and B stacked over
    the layers, CPU copies): {'layers': {'attn': {'wq': {'kernel': {'a':
    [L, in, r], 'b': [L, r, out]}}}, 'mlp': {...}}}."""
    by_proj: Dict[Tuple[str, str], list] = {}
    for path, (a, b) in adapters.items():
        _, i, scope, proj = path.split('.')
        by_proj.setdefault((scope, proj), []).append((int(i), a, b))
    tree: Dict[str, Any] = {}
    for (scope, proj), entries in by_proj.items():
        entries.sort(key=lambda e: e[0])
        if [e[0] for e in entries] != list(range(len(entries))):
            raise ValueError(f'{scope}.{proj}: adapters on layers '
                             f'{[e[0] for e in entries]}, not every layer')
        tree.setdefault(scope, {})[proj] = {'kernel': {
            'a': torch.stack([e[1].detach() for e in entries]).cpu(),
            'b': torch.stack([e[2].detach() for e in entries]).cpu()}}
    return {'layers': tree}


@torch.no_grad()
def load_adapter_values(adapters: Adapters, tree: Mapping[str, Any]) -> None:
    """Copy a training-layout tree (scanned or unscanned; numpy or torch
    leaves) into the adapters in place; it must name exactly their
    projections with their shapes."""
    from skypilot_tpu_torch.infer import lora as lora_lib
    mods = lora_lib.module_adapter(tree)
    if set(mods) != set(adapters):
        missing = sorted(set(adapters) - set(mods))
        extra = sorted(set(mods) - set(adapters))
        raise ValueError(f'adapter tree does not match the model: missing '
                         f'{missing[:3]}, unexpected {extra[:3]}')
    for path, (a, b) in adapters.items():
        for p, val in zip((a, b), mods[path]):
            val = torch.as_tensor(np.asarray(val))
            if tuple(val.shape) != tuple(p.shape):
                raise ValueError(f'{path}: adapter shape {tuple(val.shape)} '
                                 f'does not match {tuple(p.shape)}')
            p.copy_(val)


def adapters_from_jax(tree: Mapping[str, Any]
                      ) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
    """The reference's init_lora_params tree (numpy leaves, scanned or
    unscanned) -> {module path: (A [in, r], B [r, out])} CPU tensors."""
    from skypilot_tpu_torch.infer import lora as lora_lib
    return {path: (torch.from_numpy(np.array(a)), torch.from_numpy(np.array(b)))
            for path, (a, b) in lora_lib.module_adapter(tree).items()}


@dataclasses.dataclass
class LoRATrainState(trainer.TrainState):
    """The trainer's state over the adapters: its optimizer holds A and B
    only, and its state_dict (what the Checkpointer writes) holds the
    step, the adapters in the training layout, the LoRA config, the
    optimizer's state and the schedule's position: no base weight."""
    lora_cfg: LoRAConfig = LoRAConfig()
    adapters: Adapters = dataclasses.field(default_factory=dict)

    def state_dict(self) -> Dict[str, Any]:
        return {'step': self.step, 'updates': self.updates,
                'mini_step': self.mini_step,
                'lora': adapter_tree(self.adapters),
                'lora_config': {'rank': self.lora_cfg.rank,
                                'alpha': self.lora_cfg.alpha,
                                'targets': list(self.lora_cfg.targets)},
                'optimizer': self.optimizer.state_dict(),
                'acc_grads': self.acc_grads,
                'trainer_config': dataclasses.asdict(self.tcfg)}

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        saved = sd['lora_config']
        if saved['rank'] != self.lora_cfg.rank:
            raise ValueError(f'checkpoint adapters have rank '
                             f'{saved["rank"]}, this run {self.lora_cfg.rank}')
        load_adapter_values(self.adapters, sd['lora'])
        self.optimizer.load_state_dict(sd['optimizer'])
        self.step = int(sd['step'])
        self.updates = int(sd['updates'])
        self.mini_step = int(sd['mini_step'])
        acc = sd.get('acc_grads')
        self.acc_grads = None if acc is None else [
            a.to(p.device) for a, p in zip(acc, self.params)]


def create_lora_state(model: nn.Module, tx: trainer.Optimizer,
                      cfg: LoRAConfig, adapters: Adapters) -> LoRATrainState:
    """The train state over `adapters` (apply_lora's): AdamW over A and
    B in module order, the base frozen."""
    params = [p for a, b in adapters.values() for p in (a, b)]
    ids = {id(p) for p in params}
    loose = [n for n, p in model.named_parameters()
             if p.requires_grad and id(p) not in ids]
    if loose:
        raise ValueError(f'base parameters still trainable: {loose[:3]}')
    return LoRATrainState(step=0, model=model,
                          optimizer=tx.init_params(params),
                          schedule=tx.schedule, tcfg=tx.tcfg,
                          lora_cfg=cfg, adapters=adapters)
