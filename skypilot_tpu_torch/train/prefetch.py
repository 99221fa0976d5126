"""Host-device overlap for the train input pipeline (counterpart of
skypilot_tpu/train/prefetch.py).

Prefetcher moves batch assembly and upload off the step chain: a
producer thread pulls the next batches from the source iterator, places
them on the device and parks them in a BOUNDED queue, so while step k
runs, batches k+1..k+depth are already on their way.

Placement on a CUDA device (make_placer): each numpy array is pinned and
copied with non_blocking=True on a side stream, and an event is recorded
after the copies. The consumer's next() makes its current stream wait on
that event (no host sync) and calls record_stream on the placed tensors,
so the caching allocator does not hand their memory to another tensor
while the consumer stream may still read them.

Contracts (as the JAX prefetcher's):
  * bounded queue => backpressure: the producer never runs more than
    `depth` batches (plus the one it is building) ahead;
  * a producer exception is re-raised at the consumer's next();
  * close() always unblocks and joins the producer.
"""
import queue
import threading
from typing import Any, Callable, Dict, Iterator, Optional

import numpy as np
import torch

from skypilot_tpu_torch.utils import log_utils

logger = log_utils.init_logger(__name__)

_DONE = object()          # producer exhausted the source
_ERROR = object()         # producer raised; .error carries it


class PlacedBatch(dict):
    """A batch of device tensors whose copies were issued on a side
    stream; ready() must run on the consumer's stream before use."""

    def __init__(self, tensors: Dict[str, torch.Tensor],
                 event: Optional['torch.cuda.Event']) -> None:
        super().__init__(tensors)
        self.event = event

    def ready(self) -> 'PlacedBatch':
        if self.event is not None:
            stream = torch.cuda.current_stream()
            stream.wait_event(self.event)
            for t in self.values():
                t.record_stream(stream)
            self.event = None
        return self


def make_placer(device: torch.device
                ) -> Callable[[Dict[str, np.ndarray]], PlacedBatch]:
    """A batch -> PlacedBatch function for `device`: on the CPU a plain
    tensor copy; on a CUDA device pinned host memory, non-blocking copies
    on a side stream and an event after them."""
    device = torch.device(device)
    if device.type != 'cuda':
        def place_cpu(batch: Dict[str, np.ndarray]) -> PlacedBatch:
            return PlacedBatch({k: torch.from_numpy(np.array(v))
                                for k, v in batch.items()}, None)
        return place_cpu
    side = torch.cuda.Stream(device)

    def place(batch: Dict[str, np.ndarray]) -> PlacedBatch:
        with torch.cuda.stream(side):
            placed = {k: torch.from_numpy(np.ascontiguousarray(v))
                      .pin_memory().to(device, non_blocking=True)
                      for k, v in batch.items()}
            event = torch.cuda.Event()
            event.record(side)
        return PlacedBatch(placed, event)
    return place


class Prefetcher:
    """Bounded background prefetcher over a batch iterator.

    depth: max batches resident ahead of the consumer. place: optional
    batch -> PlacedBatch function (make_placer) run on the PRODUCER
    thread; next() readies each placed batch on the consumer's stream.
    """

    def __init__(self, source: Iterator[Dict[str, np.ndarray]],
                 depth: int = 2,
                 place: Optional[Callable] = None) -> None:
        if depth < 1:
            raise ValueError(f'prefetch depth must be >= 1, got {depth}')
        self._source = source
        self._place = place
        self._q: 'queue.Queue[Any]' = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self.error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name='train-prefetch')
        self._thread.start()

    # ------------------------------------------------------------ producer
    def _run(self) -> None:
        try:
            for batch in self._source:
                if self._stop.is_set():
                    return
                if self._place is not None:
                    batch = self._place(batch)
                if not self._offer(batch):
                    return
            self._offer(_DONE)
        except BaseException as e:  # pylint: disable=broad-except
            # Surface at the consumer; swallowing would look like a hang.
            self.error = e
            self._offer(_ERROR)

    def _offer(self, item: Any) -> bool:
        """put() that stays responsive to close() while the queue is
        full (the backpressure wait)."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def resident(self) -> int:
        """Batches currently staged ahead of the consumer."""
        return self._q.qsize()

    # ------------------------------------------------------------ consumer
    def __iter__(self) -> 'Prefetcher':
        return self

    def __next__(self) -> Dict[str, Any]:
        while True:
            if self.error is not None and self._q.empty():
                raise self.error
            try:
                item = self._q.get(timeout=0.05)
            except queue.Empty:
                if not self._thread.is_alive() and self._q.empty():
                    if self.error is not None:
                        raise self.error
                    raise StopIteration
                continue
            if item is _DONE:
                raise StopIteration
            if item is _ERROR:
                raise self.error
            if isinstance(item, PlacedBatch):
                item.ready()
            return item

    def close(self) -> None:
        """Stop the producer and join it. Idempotent; never raises the
        producer's error."""
        self._stop.set()
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout=10)
        if self._thread.is_alive():   # pragma: no cover - diagnostics
            logger.warning('prefetch producer did not exit within 10s')
