"""In-place weight hot-swap and the adapter registry of a live engine
(counterpart of skypilot_tpu/infer/weight_swap.py).

WeightSwapManager owns one replica's swap lifecycle (infer/server.py's
POST /admin/weights):

  1. **stage**: the new weights (a checkpoint through the engine's
     param_loader, which reads it straight onto the device in the
     engine's weight mode, or a state_dict given in process) are placed
     on the live tensors' devices and the copy finishes while decoding
     goes on: the device holds both sets for the staging's duration;
  2. **validate**: the new state_dict must have the live one's keys and
     each tensor its shape and dtype; a mismatch aborts with the old
     weights live and the offending key named;
  3. **apply**: the engine re-points each parameter at a tick boundary
     (engine.request_weight_swap): in-flight requests drain by default
     (SKYT_SWAP_DRAIN), the prefix cache is flushed and weight_version
     moves (skyt_infer_weight_version).

Single-flight: a second swap while one is in flight raises SwapInFlight
(the server's 409). What the last swap replaced is retained for
swap_back(), the rollout's rollback lever: the checkpoint path when the
old weights came from one (restaged from disk: a second set of weights
is never pinned on the device for the bake), else the old tensors
themselves (in-process swaps).

AdapterRegistry hot-loads and unloads LoRA adapters (POST
/admin/adapters) through engine.request_adapter_update, sharing the swap
manager's single-flight lock.

Not ported: reshard and reshard_back raise WeightSwapError (elastic
resharding needs meshes, ROADMAP queue 1 item 13); the reference's
`weights.swap` and `adapter.load` fault points wait for the fault
catalog (queue 1 item 6.2), as serve/qos.py's did.
"""
import threading
import time
from typing import Any, Dict, Mapping, Optional

import torch

from skypilot_tpu_torch.infer import lora as lora_lib
from skypilot_tpu_torch.utils import env
from skypilot_tpu_torch.utils import log_utils
from skypilot_tpu_torch.utils import metrics as metrics_lib

logger = log_utils.init_logger(__name__)

RESHARD_UNPORTED = ('in-place resharding is not ported yet: it needs '
                    'meshes (ROADMAP queue 1 item 13)')


class WeightSwapError(RuntimeError):
    """A swap attempt failed; the old weights are still live."""


class SwapInFlight(WeightSwapError):
    """A swap is already in progress (single-flight; HTTP 409)."""


class AdapterInUse(WeightSwapError):
    """Unload refused: live requests still reference the adapter id
    (the server's 409; retry after those requests drain)."""


def validate_tree(live: Mapping[str, torch.Tensor],
                  new: Mapping[str, Any]) -> None:
    """Reject a replacement state_dict that does not match the live one
    in keys, per-tensor shape or dtype. Raises WeightSwapError naming the
    first offending key, before any device state changes."""
    missing = sorted(set(live) - set(new))
    extra = sorted(set(new) - set(live))
    if missing or extra:
        raise WeightSwapError(
            f'param tree structure mismatch: '
            f'{len(missing)} missing (e.g. {missing[:3]}), '
            f'{len(extra)} unexpected (e.g. {extra[:3]})')
    for key, leaf in live.items():
        cand = new[key]
        c_shape = tuple(getattr(cand, 'shape', ()))
        if tuple(leaf.shape) != c_shape:
            raise WeightSwapError(
                f'param {key}: shape {c_shape} does not match the live '
                f'{tuple(leaf.shape)}')
        c_dtype = getattr(cand, 'dtype', None)
        if c_dtype != leaf.dtype:
            raise WeightSwapError(
                f'param {key}: dtype {c_dtype} does not match the live '
                f'{leaf.dtype}')


def _sync(tensors) -> None:
    """Wait for the copies onto the card to finish (the apply must only
    swap references)."""
    if any(t.is_cuda for t in tensors):
        torch.cuda.synchronize()


class WeightSwapManager:
    """Staging, validation, single-flight, history and metrics of one
    engine's in-place weight swaps."""

    def __init__(self, engine,
                 registry: Optional['metrics_lib.MetricsRegistry'] = None
                 ) -> None:
        self.engine = engine
        # build_engine(checkpoint=)'s: None on an engine built otherwise.
        self._loader = engine.param_loader
        self.checkpoint: Optional[str] = engine.checkpoint_path
        # (version, {'checkpoint': path} | {'params': state_dict}) of the
        # weights the last successful swap replaced: the swap_back target.
        self._prev: Optional[tuple] = None
        self._old_params = None
        self._flight = threading.Lock()
        self.last: Optional[Dict[str, Any]] = None
        reg = registry or getattr(engine, 'metrics_registry', None) \
            or metrics_lib.REGISTRY
        self._m_swaps = reg.counter(
            'skyt_infer_weight_swaps_total',
            'In-place weight swap attempts by result (ok / aborted — '
            'aborted leaves the old weights live)', ('result',))
        self._m_swap_s = reg.histogram(
            'skyt_infer_weight_swap_seconds',
            'End-to-end weight swap duration (stage + validate + '
            'tick-boundary apply)')

    def info(self) -> Dict[str, Any]:
        return {'weight_version': self.engine.weight_version,
                'checkpoint': self.checkpoint,
                'swap_back_available': self._prev is not None,
                'last_swap': dict(self.last) if self.last else None}

    def swap(self, checkpoint: Optional[str] = None,
             params: Optional[Mapping[str, torch.Tensor]] = None,
             version: Optional[int] = None,
             drain: Optional[bool] = None) -> Dict[str, Any]:
        """Stage, validate and apply one weight swap. Exactly one of
        `checkpoint` (read by the engine's param loader) or `params` (a
        state_dict; tests and in-process pushes) must be given. Raises
        SwapInFlight on concurrency, WeightSwapError on any failure: the
        old weights are live in both cases."""
        if not self._flight.acquire(blocking=False):
            raise SwapInFlight(
                'a weight swap is already in flight on this replica')
        try:
            return self._swap_locked(checkpoint, params, version, drain)
        finally:
            self._flight.release()

    def swap_back(self, drain: Optional[bool] = None) -> Dict[str, Any]:
        """Restage and apply the weights the last successful swap
        replaced (the rollout's rollback lever)."""
        if not self._flight.acquire(blocking=False):
            raise SwapInFlight(
                'a weight swap is already in flight on this replica')
        try:
            if self._prev is None:
                raise WeightSwapError(
                    'no previous weights retained: nothing to swap back to')
            version, ref = self._prev
            return self._swap_locked(ref.get('checkpoint'),
                                     ref.get('params'), version, drain,
                                     is_back=True)
        finally:
            self._flight.release()

    def reshard(self, virtual_nodes: int,
                drain: Optional[bool] = None) -> Dict[str, Any]:
        del virtual_nodes, drain
        raise WeightSwapError(RESHARD_UNPORTED)

    def reshard_back(self, drain: Optional[bool] = None) -> Dict[str, Any]:
        del drain
        raise WeightSwapError(RESHARD_UNPORTED)

    def _swap_locked(self, checkpoint, params, version, drain,
                     is_back: bool = False) -> Dict[str, Any]:
        t0 = time.perf_counter()
        old_version = self.engine.weight_version
        old_checkpoint = self.checkpoint
        target = int(version) if version is not None else old_version + 1
        try:
            if (checkpoint is None) == (params is None):
                raise WeightSwapError(
                    'exactly one of checkpoint= or params= is required')
            if params is None:
                if self._loader is None:
                    raise WeightSwapError(
                        'this replica has no checkpoint loader (engine '
                        'built without build_engine); push a state_dict '
                        'instead')
                try:
                    params = self._loader(checkpoint)
                except Exception as e:  # pylint: disable=broad-except
                    raise WeightSwapError(
                        f'loading checkpoint {checkpoint!r} failed: '
                        f'{e}') from e
            validate_tree(self.engine.params, params)
            staged = self._stage(params)
            del params
            result = self.engine.request_weight_swap(
                staged, version=target, drain=drain)
        except WeightSwapError as e:
            self._abort(t0, target, checkpoint, str(e))
            raise
        except Exception as e:  # pylint: disable=broad-except
            self._abort(t0, target, checkpoint, str(e))
            raise WeightSwapError(
                f'weight swap failed (old weights intact): {e}') from e
        dur = time.perf_counter() - t0
        # Retain what was replaced: a path to restage from when there is
        # one (the old tensors are then released), else the tensors.
        if old_checkpoint is not None:
            self._prev = (old_version, {'checkpoint': old_checkpoint})
        else:
            self._prev = (old_version, {'params': self._old_params})
        self._old_params = None
        self.checkpoint = checkpoint
        self._m_swaps.labels('ok').inc()
        self._m_swap_s.observe(dur)
        self.last = {
            'ok': True, 'weight_version': result['weight_version'],
            'from_version': old_version, 'checkpoint': checkpoint,
            'swap_back': is_back, 'duration_s': round(dur, 4),
            'apply_s': result['apply_s'],
            'flushed_prefix_pages': result['flushed_prefix_pages'],
            'at': time.time()}
        logger.info('weight swap ok: v%d -> v%d in %.3fs (%s)', old_version,
                    result['weight_version'], dur,
                    checkpoint or 'state_dict')
        return dict(self.last)

    def _abort(self, t0: float, target: int, checkpoint,
               error: str) -> None:
        self._old_params = None
        self._m_swaps.labels('aborted').inc()
        self.last = {
            'ok': False, 'weight_version': self.engine.weight_version,
            'target_version': target, 'checkpoint': checkpoint,
            'error': error,
            'duration_s': round(time.perf_counter() - t0, 4),
            'at': time.time()}
        logger.warning('weight swap to v%d aborted (old weights intact): '
                       '%s', target, error)

    def _stage(self, params: Mapping[str, torch.Tensor]
               ) -> Dict[str, torch.Tensor]:
        """Each new tensor on its live tensor's device, the copies done
        before the tick-boundary apply (which then only re-points)."""
        live = self.engine.params
        self._old_params = live
        staged = {k: torch.as_tensor(v).to(live[k].device)
                  for k, v in params.items()}
        _sync(staged.values())
        return staged


class AdapterRegistry:
    """Hot-load and unload LoRA adapters into a live engine's stack at
    tick boundaries (the reference's adapter fleet, one instance per
    replica server). It shares the WeightSwapManager's single-flight
    lock: an adapter update never races a weight swap (HTTP 409).

    Invariants (the reference's):

    * **Stable ids.** A load takes the lowest free slot, or the same slot
      when replacing by name; an unload zeroes its slot and never
      renumbers, so in-flight requests stay on their adapter.
    * **Old stack intact on any error.** Loading, validation and staging
      all happen before the engine sees anything.
    * **Unload refuses while referenced.** AdapterInUse (409) while a
      waiting or active request carries the id.
    * **Replacement drains.** Reloading a name in place waits for empty
      slots by default; fresh ids apply at once.
    * **Reusing an id flushes the prefix cache** (pages are salted by
      the adapter id).

    A load whose rank exceeds the stack's padding rebuilds the stack from
    the retained host trees."""

    def __init__(self, engine, swap_mgr: WeightSwapManager,
                 dtype: Optional[str] = None, reserved_names=(),
                 on_change=None,
                 registry: Optional['metrics_lib.MetricsRegistry'] = None
                 ) -> None:
        self.engine = engine
        self._flight = swap_mgr._flight  # pylint: disable=protected-access
        self._dtype = dtype or str(engine.cfg.dtype)
        self._reserved = set(reserved_names)
        self._on_change = on_change
        # name -> {'id', 'alpha', 'path', 'version', 'rank', 'loaded_at'}
        self._adapters: Dict[str, Dict[str, Any]] = {}
        # Host trees by id (MBs): a rank-growing load rebuilds from them.
        self._trees: Dict[int, tuple] = {}
        # Every id that ever held an adapter: reusing one flushes.
        self._used_ids: set = set()
        self.last: Optional[Dict[str, Any]] = None
        reg = registry or getattr(engine, 'metrics_registry', None) \
            or metrics_lib.REGISTRY
        self._m_loaded = reg.gauge(
            'skyt_infer_adapters_loaded',
            'Adapters currently loaded on this replica (excluding the '
            'id-0 base slot)')
        self._m_loads = reg.counter(
            'skyt_infer_adapter_loads_total',
            'Adapter hot-load attempts by result (ok / aborted — '
            'aborted leaves the old stack live)', ('result',))
        self._m_unloads = reg.counter(
            'skyt_infer_adapter_unloads_total',
            'Adapter unload attempts by result (ok / refused — live '
            'requests still reference the id / aborted)', ('result',))
        self._m_loaded.set(0)

    # ------------------------------------------------------------ seeding
    def seed(self, specs) -> None:
        """Boot-time adapters (--lora flags): registered under the ids
        build_stack_from_specs gave them (spec order, from 1), their host
        trees retained. The engine already holds the boot stack."""
        for i, s in enumerate(specs, 1):
            tree = lora_lib.load_adapter_dir(s.path)
            self._trees[i] = (tree, float(s.alpha))
            self._adapters[s.name] = {
                'id': i, 'alpha': float(s.alpha), 'path': s.path,
                'version': 1, 'rank': lora_lib.adapter_rank(tree),
                'loaded_at': time.time()}
            self._used_ids.add(i)
        self._m_loaded.set(len(self._adapters))

    def seed_names(self, name_ids: Dict[str, int]) -> None:
        """Bookkeeping-only seed for an engine handed a prebuilt stack:
        ids registered without trees, so a later rank-growing load needs
        every other adapter reloaded first."""
        for name, lid in name_ids.items():
            self._adapters[name] = {
                'id': int(lid), 'alpha': None, 'path': None,
                'version': 1, 'rank': None, 'loaded_at': time.time()}
            self._used_ids.add(int(lid))
        self._m_loaded.set(len(self._adapters))

    # ------------------------------------------------------------ views
    def name_ids(self) -> Dict[str, int]:
        """{adapter name: stack id}: the server's routing map."""
        return {n: a['id'] for n, a in self._adapters.items()}

    def snapshot(self) -> Dict[str, Any]:
        """The /stats 'adapters' block."""
        return {
            'count': len(self._adapters),
            'stack_slots': int(self.engine.num_adapters or 0),
            'adapters': {
                n: {'id': a['id'], 'version': a['version'],
                    'alpha': a['alpha'], 'rank': a['rank'],
                    'path': a['path']}
                for n, a in self._adapters.items()}}

    # ------------------------------------------------------------- load
    def load(self, name: str, checkpoint: Optional[str] = None,
             params=None, alpha: float = 16.0,
             drain: Optional[bool] = None) -> Dict[str, Any]:
        """Stage, validate and apply one adapter load (a new name) or an
        in-place replacement (an existing name: same id, version + 1).
        Exactly one of `checkpoint` (an sft --lora-rank run's dir) or
        `params` (an adapter tree) must be given. Raises SwapInFlight on
        concurrency, WeightSwapError on any failure: the old stack is
        live in both cases."""
        if not self._flight.acquire(blocking=False):
            raise SwapInFlight(
                'a weight swap or adapter update is already in flight on '
                'this replica')
        try:
            return self._load_locked(name, checkpoint, params, alpha, drain)
        finally:
            self._flight.release()

    def _load_locked(self, name, checkpoint, params, alpha,
                     drain) -> Dict[str, Any]:
        t0 = time.perf_counter()
        try:
            if not isinstance(name, str) or not name:
                raise WeightSwapError(
                    'adapter name must be a non-empty string')
            if name in self._reserved:
                raise WeightSwapError(f'adapter name {name!r} collides with '
                                      'the served model id')
            if (checkpoint is None) == (params is None):
                raise WeightSwapError(
                    'exactly one of checkpoint= or params= is required')
            if params is None:
                try:
                    tree = lora_lib.load_adapter_dir(checkpoint)
                except Exception as e:  # pylint: disable=broad-except
                    raise WeightSwapError(
                        f'loading adapter {checkpoint!r} failed: {e}') from e
            else:
                tree = params
            try:
                rank = lora_lib.adapter_rank(tree)
                alpha = float(alpha)
            except Exception as e:  # pylint: disable=broad-except
                raise WeightSwapError(f'not a LoRA adapter tree: {e}') from e
            replacing = name in self._adapters
            if replacing:
                aid = self._adapters[name]['id']
            else:
                limit = env.get_int('SKYT_ADAPTER_MAX')
                if len(self._adapters) >= limit:
                    raise WeightSwapError(
                        f'adapter limit reached ({limit} loaded; raise '
                        'SKYT_ADAPTER_MAX)')
                taken = {a['id'] for a in self._adapters.values()}
                aid = 1
                while aid in taken:
                    aid += 1
            # The stack never shrinks; it grows a slot at a time.
            num_slots = max(int(self.engine.num_adapters or 0), aid + 1, 2)
            stack = self._build_with(aid, tree, alpha, num_slots)
            if drain is None:
                drain = replacing
            # The engine validates and places the stack on the caller's
            # thread before it queues the apply.
            result = self.engine.request_adapter_update(
                stack, num_adapters=num_slots,
                flush_prefix=aid in self._used_ids, drain=bool(drain))
        except WeightSwapError as e:
            self._abort('load', self._m_loads, t0, name, str(e),
                        checkpoint=checkpoint)
            raise
        except Exception as e:  # pylint: disable=broad-except
            self._abort('load', self._m_loads, t0, name, str(e),
                        checkpoint=checkpoint)
            raise WeightSwapError(
                f'adapter load failed (old stack intact): {e}') from e
        dur = time.perf_counter() - t0
        self._trees[aid] = (tree, alpha)
        version = self._adapters[name]['version'] + 1 if replacing else 1
        self._adapters[name] = {
            'id': aid, 'alpha': alpha, 'path': checkpoint,
            'version': version, 'rank': rank, 'loaded_at': time.time()}
        self._used_ids.add(aid)
        self._m_loaded.set(len(self._adapters))
        self._m_loads.labels('ok').inc()
        self.last = {
            'ok': True, 'op': 'load', 'name': name, 'id': aid,
            'version': version, 'rank': rank, 'alpha': alpha,
            'replaced': replacing, 'num_adapters': num_slots,
            'flushed_prefix_pages': result['flushed_prefix_pages'],
            'duration_s': round(dur, 4), 'apply_s': result['apply_s'],
            'at': time.time()}
        if self._on_change is not None:
            self._on_change()
        logger.info('adapter load ok: %r -> id %d v%d (rank %d, alpha %g) '
                    'in %.3fs', name, aid, version, rank, alpha, dur)
        return dict(self.last)

    def _build_with(self, aid, tree, alpha, num_slots):
        """The new stack with `tree` at slot `aid`: grafted into the live
        stack when its rank fits, else rebuilt from the retained trees."""
        live = self.engine._lora_stack  # pylint: disable=protected-access
        if live is None:
            return lora_lib.build_stack_assigned(
                {aid: (tree, alpha)}, num_slots, self._dtype)
        try:
            return lora_lib.graft_adapter(live, aid, tree, alpha)
        except ValueError as graft_err:
            assigned = {i: t for i, t in self._trees.items() if i != aid}
            missing = sorted(
                n for n, a in self._adapters.items()
                if a['id'] != aid and a['id'] not in self._trees)
            if missing:
                raise WeightSwapError(
                    f'cannot graft adapter ({graft_err}) and cannot rebuild '
                    f'the stack: no retained trees for {missing} (loaded '
                    'before this registry; reload them first)') \
                    from graft_err
            assigned[aid] = (tree, alpha)
            return lora_lib.build_stack_assigned(assigned, num_slots,
                                                 self._dtype)

    def _abort(self, op, counter, t0, name, error: str, **extra) -> None:
        counter.labels('aborted').inc()
        self.last = {
            'ok': False, 'op': op, 'name': name, **extra, 'error': error,
            'duration_s': round(time.perf_counter() - t0, 4),
            'at': time.time()}
        logger.warning('adapter %s %r aborted (old stack intact): %s', op,
                       name, error)

    # ----------------------------------------------------------- unload
    def unload(self, name: str,
               drain: Optional[bool] = None) -> Dict[str, Any]:
        """Zero one adapter's slot (the id is retired until reused).
        Raises AdapterInUse (409) while live requests reference the id,
        SwapInFlight on concurrency, WeightSwapError otherwise: the old
        stack is live in every error case."""
        if not self._flight.acquire(blocking=False):
            raise SwapInFlight(
                'a weight swap or adapter update is already in flight on '
                'this replica')
        try:
            return self._unload_locked(name, drain)
        finally:
            self._flight.release()

    def _unload_locked(self, name, drain) -> Dict[str, Any]:
        t0 = time.perf_counter()
        aid = None
        try:
            if name not in self._adapters:
                raise WeightSwapError(f'adapter {name!r} is not loaded')
            aid = self._adapters[name]['id']
            if self.engine.adapter_in_use(aid):
                raise AdapterInUse(
                    f'adapter {name!r} (id {aid}) is still referenced by '
                    'live requests; retry after they drain')
            live = self.engine._lora_stack  # pylint: disable=protected-access
            if live is None:
                raise WeightSwapError('engine has no adapter stack loaded')
            result = self.engine.request_adapter_update(
                lora_lib.zero_slot(live, aid),
                num_adapters=int(self.engine.num_adapters),
                flush_prefix=True, drain=bool(drain))
        except AdapterInUse:
            self._m_unloads.labels('refused').inc()
            raise
        except WeightSwapError as e:
            self._abort('unload', self._m_unloads, t0, name, str(e))
            raise
        except Exception as e:  # pylint: disable=broad-except
            self._abort('unload', self._m_unloads, t0, name, str(e))
            raise WeightSwapError(
                f'adapter unload failed (old stack intact): {e}') from e
        dur = time.perf_counter() - t0
        del self._adapters[name]
        self._trees.pop(aid, None)
        self._m_loaded.set(len(self._adapters))
        self._m_unloads.labels('ok').inc()
        self.last = {
            'ok': True, 'op': 'unload', 'name': name, 'id': aid,
            'flushed_prefix_pages': result['flushed_prefix_pages'],
            'duration_s': round(dur, 4), 'apply_s': result['apply_s'],
            'at': time.time()}
        if self._on_change is not None:
            self._on_change()
        logger.info('adapter unload ok: %r (id %d freed) in %.3fs', name,
                    aid, dur)
        return dict(self.last)
