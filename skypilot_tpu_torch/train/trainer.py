"""Training on one device: optimizer, loss, train and eval steps, and the
metrics plane (counterpart of skypilot_tpu/train/trainer.py).

The JAX trainer jits one sharded step over a mesh; here the step runs
eagerly on one device (mesh shardings are the parallelism slice's), and
the optax chain becomes torch.optim with the same arithmetic:

  * AdamW (eps 1e-8, weight decay on every parameter, as optax's
    unmasked adamw) at the learning rate of
    optax.warmup_cosine_decay_schedule(0, lr, warmup, max(total,
    warmup + 1), lr * 0.1) for the update's index: the first update runs
    at lr 0;
  * global-norm clipping exactly as optax.clip_by_global_norm: g is kept
    when its norm is below max_norm, else replaced by g / norm *
    max_norm (clip_grad_norm_ divides by norm + 1e-6 and is not used);
  * gradient accumulation as optax.MultiSteps: the running mean of k
    microbatch gradients (Welford, as there), applied on every k-th call.

The train state is updated in place (the JAX step returns a new one):
the parameters, AdamW's moments and the accumulators keep their storage.
"""
import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch import nn

from skypilot_tpu_torch.utils import metrics as metrics_lib


@dataclasses.dataclass
class TrainerConfig:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10000
    weight_decay: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    grad_clip: float = 1.0
    # Gradient accumulation (microbatches per step); 1 = off.
    grad_accum: int = 1


class TrainMetricsPublisher:
    """Training-side view of the shared metrics plane: step time,
    throughput, loss, grad norm and MFU land in the registry
    (utils/metrics.py) the serving layer would expose.

    publish() takes host floats the caller already has (DeferredMetrics
    hands it step k-1's); it adds no device syncs of its own."""

    def __init__(self, registry: Optional[
            'metrics_lib.MetricsRegistry'] = None) -> None:
        reg = registry or metrics_lib.REGISTRY
        self.step_seconds = reg.gauge(
            'skyt_train_step_seconds',
            'Wall time of the most recent training step')
        self.tokens_per_sec = reg.gauge(
            'skyt_train_tokens_per_sec',
            'Training throughput over the run so far')
        self.loss = reg.gauge(
            'skyt_train_loss', 'Most recently logged training loss')
        self.grad_norm = reg.gauge(
            'skyt_train_grad_norm',
            'Most recently logged global gradient norm')
        self.steps = reg.counter(
            'skyt_train_steps_total', 'Training steps completed')
        self.mfu = reg.gauge(
            'skyt_train_mfu',
            'Model FLOPs utilization over the last logging window '
            '(analytic FLOPs per step against the card\'s dense bf16 '
            'peak; utils/profiling.py)')

    def publish(self, metrics: Dict[str, Any],
                step_time_s: Optional[float] = None,
                tokens_per_sec: Optional[float] = None,
                steps: int = 1,
                mfu: Optional[float] = None) -> None:
        """metrics: {'loss', 'grad_norm', ...} as floats (or scalar
        tensors, read here)."""
        self.steps.inc(steps)
        if 'loss' in metrics:
            self.loss.set(float(metrics['loss']))
        if 'grad_norm' in metrics:
            self.grad_norm.set(float(metrics['grad_norm']))
        if step_time_s is not None:
            self.step_seconds.set(step_time_s)
        if tokens_per_sec is not None:
            self.tokens_per_sec.set(tokens_per_sec)
        if mfu is not None:
            self.mfu.set(mfu)


class DeferredMetrics:
    """One-step-deferred metrics pulls: published loss and grad_norm lag
    one step behind the step counter, and the head of the step chain is
    never synced.

    Reading step k-1's loss with .item() after step k is queued would
    wait for step k: one stream runs its work in order. So on_step(k)
    starts a non-blocking copy of step k's scalars into pinned host
    memory and records a CUDA event after it, and publish() waits on
    step k-1's event only, while step k runs on. CPU tensors are read
    directly (nothing is in flight)."""

    def __init__(self, publisher: TrainMetricsPublisher,
                 keys: Tuple[str, ...] = ('loss', 'grad_norm')) -> None:
        self._pub = publisher
        self._keys = keys
        self._prev: Optional[Tuple[List[str], torch.Tensor, Any]] = None
        self._cur: Optional[Tuple[List[str], torch.Tensor, Any]] = None

    def on_step(self, metrics: Dict[str, Any]) -> None:
        """Start step k's host copy (no sync)."""
        self._prev = self._cur
        names = [k for k in self._keys if k in metrics]
        if not names:
            self._cur = None
            return
        vals = torch.stack([torch.as_tensor(metrics[k]).detach().float()
                            .reshape(()) for k in names])
        if vals.is_cuda:
            host = torch.empty(vals.shape, dtype=vals.dtype,
                               pin_memory=True)
            host.copy_(vals, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
            self._cur = (names, host, event)
        else:
            self._cur = (names, vals, None)

    def publish(self, step_time_s: Optional[float] = None,
                tokens_per_sec: Optional[float] = None,
                steps: int = 1,
                mfu: Optional[float] = None) -> Dict[str, float]:
        """Publish step k-1's metrics (k still in flight) and return them
        as host floats; the first call of a run (no k-1 yet) reads the
        current step's."""
        src = self._prev if self._prev is not None else self._cur
        host: Dict[str, float] = {}
        if src is not None:
            names, vals, event = src
            if event is not None:
                event.synchronize()
            host = dict(zip(names, vals.tolist()))
        self._pub.publish(host, step_time_s=step_time_s,
                          tokens_per_sec=tokens_per_sec, steps=steps,
                          mfu=mfu)
        return host


def warmup_cosine_schedule(tcfg: TrainerConfig) -> Callable[[int], float]:
    """optax.warmup_cosine_decay_schedule(init_value=0, peak_value=lr,
    warmup_steps, decay_steps=max(total, warmup + 1), end_value=lr*0.1):
    linear from 0 over the warmup, then cosine decay to a tenth."""
    peak, warmup = tcfg.learning_rate, tcfg.warmup_steps
    decay = max(tcfg.total_steps, warmup + 1) - warmup
    end = peak * 0.1
    alpha = 0.0 if peak == 0.0 else end / peak

    def schedule(count: int) -> float:
        if count < warmup:
            frac = 1.0 - max(count, 0) / warmup
            return (0.0 - peak) * frac + peak
        t = min(count - warmup, decay)
        cosine = 0.5 * (1.0 + math.cos(math.pi * t / decay))
        return peak * ((1.0 - alpha) * cosine + alpha)
    return schedule


@dataclasses.dataclass
class Optimizer:
    """make_optimizer's result (the optax chain's counterpart): the
    config and its learning-rate schedule; init(model) builds the AdamW
    over the model's trainable parameters."""
    tcfg: TrainerConfig
    schedule: Callable[[int], float]

    def init(self, model: nn.Module) -> torch.optim.AdamW:
        return self.init_params(
            [p for p in model.parameters() if p.requires_grad])

    def init_params(self, params: List[torch.Tensor]) -> torch.optim.AdamW:
        """The AdamW over `params` (a LoRA run's adapters)."""
        t = self.tcfg
        return torch.optim.AdamW(
            params, lr=self.schedule(0), betas=(t.b1, t.b2), eps=1e-8,
            weight_decay=t.weight_decay)


def make_optimizer(tcfg: TrainerConfig) -> Optimizer:
    if tcfg.grad_accum < 1:
        raise ValueError(f'grad_accum must be >= 1, got {tcfg.grad_accum}')
    return Optimizer(tcfg, warmup_cosine_schedule(tcfg))


def global_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over every gradient (optax.global_norm),
    a device scalar in f32."""
    norms = torch._foreach_norm([g.float() for g in grads])
    return torch.linalg.vector_norm(torch.stack(norms))


def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float,
                         norm: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """In place, exactly optax.clip_by_global_norm: each g stays when the
    global norm is below max_norm, else becomes g / norm * max_norm.
    Decided on the device (no sync). Returns the norm."""
    if norm is None:
        norm = global_norm(grads)
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm.to(g.dtype) * max_norm))
    return norm


def cross_entropy_loss(logits: torch.Tensor, targets: torch.Tensor,
                       mask: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean next-token CE in f32. Targets < 0 or mask == 0 are ignored.

    Returns (loss, n_tokens)."""
    logits = logits.float()
    if mask is None:
        mask = (targets >= 0).float()
    targets = targets.clamp(min=0).long()
    logp = torch.log_softmax(logits, dim=-1)
    token_loss = -torch.gather(logp, -1, targets[..., None])[..., 0]
    n = mask.sum().clamp(min=1.0)
    return (token_loss * mask).sum() / n, n


@dataclasses.dataclass
class TrainState:
    """(step, model, optimizer, schedule) plus MultiSteps' accumulator.
    step counts train-step calls (microbatches, as the JAX state's);
    updates counts optimizer updates, the schedule's index."""
    step: int
    model: nn.Module
    optimizer: torch.optim.AdamW
    schedule: Callable[[int], float]
    tcfg: TrainerConfig
    updates: int = 0
    mini_step: int = 0
    acc_grads: Optional[List[torch.Tensor]] = None

    @property
    def params(self) -> List[torch.Tensor]:
        return [p for group in self.optimizer.param_groups
                for p in group['params']]

    def apply_gradients(self, grads: List[torch.Tensor]) -> None:
        """One call's gradients: accumulated (grad_accum > 1) or clipped
        and applied, as optax.MultiSteps(chain(clip, adamw))."""
        k = self.tcfg.grad_accum
        if k > 1:
            if self.acc_grads is None:
                self.acc_grads = [torch.zeros_like(g) for g in grads]
            for acc, g in zip(self.acc_grads, grads):
                acc.add_((g - acc) / (self.mini_step + 1))
            if self.mini_step < k - 1:
                self.mini_step += 1
                return
            grads = self.acc_grads
        clip_by_global_norm_(grads, self.tcfg.grad_clip)
        for p, g in zip(self.params, grads):
            p.grad = g
        lr = self.schedule(self.updates)
        for group in self.optimizer.param_groups:
            group['lr'] = lr
        self.optimizer.step()
        self.updates += 1
        if k > 1:
            self.mini_step = 0
            for acc in self.acc_grads:
                acc.zero_()
            for p in self.params:
                p.grad = None

    def state_dict(self) -> Dict[str, Any]:
        return {'step': self.step, 'updates': self.updates,
                'mini_step': self.mini_step,
                'model': self.model.state_dict(),
                'optimizer': self.optimizer.state_dict(),
                'acc_grads': self.acc_grads,
                'trainer_config': dataclasses.asdict(self.tcfg)}

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        self.model.load_state_dict(sd['model'])
        self.optimizer.load_state_dict(sd['optimizer'])
        self.step = int(sd['step'])
        self.updates = int(sd['updates'])
        self.mini_step = int(sd['mini_step'])
        acc = sd.get('acc_grads')
        self.acc_grads = None if acc is None else [
            a.to(p.device) for a, p in zip(acc, self.params)]


def create_state(model: nn.Module, tx: Optimizer) -> TrainState:
    return TrainState(step=0, model=model, optimizer=tx.init(model),
                      schedule=tx.schedule, tcfg=tx.tcfg)


def make_train_step(model: nn.Module, tx: Optimizer) -> Callable:
    """Returns (state, batch) -> (state, metrics), updating state in place.

    batch: {'tokens': [B, S], 'targets': [B, S], optional 'segment_ids'}
    tensors on the model's device. metrics: {'loss', 'tokens',
    'grad_norm'} device scalars; grad_norm is this call's gradient norm
    before clipping (optax.global_norm(grads))."""
    del tx   # the state carries the optimizer and its schedule

    def step_fn(state: TrainState, batch: Dict[str, torch.Tensor]):
        params = state.params
        for p in params:
            p.grad = None
        logits = state.model(batch['tokens'],
                             segment_ids=batch.get('segment_ids'))
        loss, n_tok = cross_entropy_loss(logits, batch['targets'])
        del logits
        loss.backward()
        grads = [p.grad for p in params]
        gnorm = global_norm(grads)
        state.apply_gradients(grads)
        state.step += 1
        return state, {'loss': loss.detach(), 'tokens': n_tok,
                       'grad_norm': gnorm}
    return step_fn


def make_eval_step(model: nn.Module) -> Callable:
    """Returns batch -> {'loss', 'tokens'} without gradients."""
    def eval_fn(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        with torch.no_grad():
            logits = model(batch['tokens'])
            loss, n = cross_entropy_loss(logits, batch['targets'])
        return {'loss': loss, 'tokens': n}
    return eval_fn
