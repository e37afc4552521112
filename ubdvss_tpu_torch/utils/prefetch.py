"""Background-thread batch prefetch (feed/compute overlap).

Counterpart of ``ubdvss_tpu/utils/prefetch.py``: a worker thread runs the
source iterator — host collate AND the host-to-device copy happen there —
while the consumer dispatches work on the batches it already has.  The
contract is the JAX package's: at most ``depth`` items in flight beyond
the consumer, an exception of the source re-raised where the item would
have been consumed, and a daemon thread, so an abandoned iterator cannot
hang interpreter shutdown.

On the card the worker runs the source on its own ``torch.cuda.Stream``.
PyTorch's current stream is per thread, so without it the worker's copies
and device ops would go on the default stream and serialize with the
consumer's compute.  Each item is handed over with an event recorded on
the worker's stream after it; the consumer's stream waits on that event
before the item's first use, and every CUDA tensor of the item is marked
used by the consumer's stream (``record_stream``), so the allocator does
not hand its memory back to the worker's stream while the consumer still
reads it.  The source must copy from pinned memory (``data._to_device``)
for the copies to run asynchronously.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator, TypeVar

import torch

T = TypeVar("T")

_END = object()


def _cuda_tensors(item):
    """Every CUDA tensor in a (nested) dict / list / tuple item."""
    if isinstance(item, torch.Tensor):
        if item.is_cuda:
            yield item
    elif isinstance(item, dict):
        for v in item.values():
            yield from _cuda_tensors(v)
    elif isinstance(item, (list, tuple)):
        for v in item:
            yield from _cuda_tensors(v)


def prefetched(source: Iterable[T], depth: int = 2, device=None) -> Iterator[T]:
    """Iterate ``source`` in a worker thread, ``depth`` items ahead.

    ``device``: a CUDA device runs the source on a stream of its own on
    that device (see the module docstring); None or the CPU runs it as it
    is.  ``depth < 1`` iterates synchronously in the caller's thread.
    """
    if depth < 1:
        yield from source
        return
    dev = None if device is None else torch.device(device)
    stream = torch.cuda.Stream(dev) if dev is not None and dev.type == "cuda" else None
    q: queue.Queue = queue.Queue(maxsize=depth)

    def work():
        try:
            if stream is None:
                for item in source:
                    q.put((item, None))
            else:
                with torch.cuda.device(dev), torch.cuda.stream(stream):
                    for item in source:
                        ready = torch.cuda.Event()
                        ready.record(stream)
                        q.put((item, ready))
        except BaseException as e:  # noqa: BLE001 — re-raised in the consumer
            q.put((_END, e))
        else:
            q.put((_END, None))

    t = threading.Thread(target=work, daemon=True, name="batch-prefetch")
    t.start()
    while True:
        item, ready = q.get()
        if item is _END:
            if ready is not None:
                raise ready
            return
        if ready is not None:
            consumer = torch.cuda.current_stream(dev)
            consumer.wait_event(ready)
            for x in _cuda_tensors(item):
                x.record_stream(consumer)
        yield item
