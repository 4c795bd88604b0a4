"""Background batch prefetching — overlap host-side batch assembly and
host->device copies with device compute.

The port's counterpart of ``pychain_tpu/data/prefetch.py``: the same
bounded queue and daemon thread, with the same exception and close
behaviour.  ``prefetch`` runs the producing iterator in a daemon thread,
optionally applying a ``transfer`` function inside that thread so the
copy is done before the consumer asks for the batch.

:class:`to_device` is the transfer for a CUDA device.  It copies every
CPU tensor of an item from pinned memory on a CUDA stream of the
producer's own, records an event there and waits on that event alone:
the producer waits for its copy, never for the training steps queued on
the consumer's stream (``torch.cuda.synchronize`` would wait for both).
The consumer's stream waits on the same event when it takes the item,
and each copied tensor is marked as used on that stream
(``record_stream``), so the caching allocator does not hand its memory
to a later copy while a step still reads it.
"""

from __future__ import annotations

import dataclasses
import queue
import threading

import torch

from ..utils.device import host_to, resolve_device


class _End:
    """Queue sentinel: producer finished (possibly with an error)."""

    def __init__(self, exc=None):
        self.exc = exc


class Prefetcher:
    """Iterate ``iterator`` in a background thread, ``depth`` items ahead.

    ``transfer`` (optional) is applied to each item IN THE PRODUCER
    THREAD before it is queued: pass :class:`to_device` to overlap
    host->device copies with compute.

    Exceptions raised by the iterator or by ``transfer`` re-raise in
    the consumer at the position they occurred.  ``close()`` stops the
    producer promptly (also called by ``__exit__`` and the finalizer);
    breaking out of a consuming loop early is safe.
    """

    def __init__(self, iterator, depth: int = 2, transfer=None):
        if depth < 1:
            raise ValueError("depth must be >= 1")
        self._queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._produce, args=(iter(iterator), transfer),
            daemon=True)
        self._thread.start()

    def _produce(self, it, transfer):
        try:
            for item in it:
                if transfer is not None:
                    item = transfer(item)
                while not self._stop.is_set():
                    try:
                        self._queue.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if self._stop.is_set():
                    return
            end = _End()
        except BaseException as exc:  # noqa: BLE001 — re-raised in consumer
            end = _End(exc)
        while not self._stop.is_set():
            try:
                self._queue.put(end, timeout=0.1)
                return
            except queue.Full:
                continue

    def __iter__(self):
        return self

    def __next__(self):
        if self._stop.is_set():
            raise StopIteration
        item = self._queue.get()
        if isinstance(item, _End):
            self._stop.set()
            if item.exc is not None:
                raise item.exc
            raise StopIteration
        if isinstance(item, _Copied):
            return item.claim()
        return item

    def close(self):
        self._stop.set()
        # drain so a blocked producer can observe the stop event
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc_info):
        self.close()
        return False

    def __del__(self):
        try:
            self._stop.set()
        except Exception:  # pragma: no cover — interpreter teardown
            pass


def prefetch(iterator, depth: int = 2, transfer=None) -> Prefetcher:
    """Convenience constructor; see :class:`Prefetcher`."""
    return Prefetcher(iterator, depth=depth, transfer=transfer)


# ----------------------------------------------------------------------
# The transfer to a device
# ----------------------------------------------------------------------

def _map(item, fn):
    """``item`` with ``fn`` applied to each tensor in it: through tuples,
    lists and dataclasses (the engines' arrays); anything else (numpy
    arrays, None) passes as it is."""
    if isinstance(item, torch.Tensor):
        return fn(item)
    if isinstance(item, (tuple, list)):
        return type(item)(_map(v, fn) for v in item)
    if dataclasses.is_dataclass(item) and not isinstance(item, type):
        return dataclasses.replace(item, **{
            f.name: _map(getattr(item, f.name), fn)
            for f in dataclasses.fields(item) if f.init})
    return item


class _Copied:
    """An item whose tensors were copied on the producer's stream."""

    def __init__(self, item, event, tensors, device):
        self.item, self.event, self.tensors = item, event, tensors
        self.device = device

    def claim(self):
        """Called on the consumer's thread: its current stream waits for
        the copy, and owns the copied memory from here on."""
        stream = torch.cuda.current_stream(self.device)
        stream.wait_event(self.event)
        for t in self.tensors:
            t.record_stream(stream)
        return self.item


class to_device:
    """A ``transfer`` for :class:`Prefetcher`: every CPU tensor of an item
    (through tuples, lists and dataclasses) on ``device``.

    On a CUDA device the copies go from pinned memory on a stream of the
    producer's own, and the producer waits for that stream's event; the
    consumer's stream waits on the event in ``Prefetcher.__next__``.  On
    the CPU the item passes unchanged.  ``device=None`` means the card."""

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self._stream = None

    def __call__(self, item):
        if self.device.type != "cuda":
            return _map(item, lambda t: t.to(self.device))
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        copied = []

        def move(t):
            if t.device.type == "cuda":
                return t
            out = host_to(t, self.device)
            copied.append(out)
            return out
        with torch.cuda.stream(self._stream):
            out = _map(item, move)
            event = torch.cuda.Event()
            event.record(self._stream)
        event.synchronize()
        return _Copied(out, event, copied, self.device)
