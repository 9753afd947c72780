"""Input pipeline: a prefetching host->device data feed, the port of
``tepdist_tpu/data/prefetch.py``.

``fake_input_iterator`` keeps the FAKE_INPUT mode (generate once, yield
forever). ``DevicePrefetcher`` places the next batches on the device on a
worker thread while the current step runs: on the card each batch is
copied into pinned host memory and then to the device with
``non_blocking`` copies on a side stream, and ``next()`` makes the
consumer's current stream wait on that copy's event, so the step never
reads a half-copied batch.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Iterator, Optional

import torch

from tepdist_tpu_torch.core.device import resolve_device
from tepdist_tpu_torch.core.tree import tree_leaves, tree_map


def fake_input_iterator(batch_fn: Callable[[int], Any],
                        reuse_first: bool = True) -> Iterator[Any]:
    """FAKE_INPUT semantics: generate once, yield forever."""
    first = batch_fn(0)
    i = 0
    while True:
        if reuse_first:
            yield first
        else:
            yield batch_fn(i)
        i += 1


class DevicePrefetcher:
    """Wrap a host batch iterator (each batch a tree of numpy arrays or
    tensors); place up to ``depth`` batches ahead on ``device`` on a worker
    thread. An error of the source iterator is raised by ``next()``."""

    _DONE = object()

    def __init__(self, it: Iterator[Any], device="cuda", depth: int = 2):
        self._it = it
        self.device = resolve_device(device)
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._err: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="tepdist-prefetch")
        self._thread.start()

    def _place(self, batch):
        """(batch on the device, the copy's CUDA event or None)."""
        if self._stream is None:
            return tree_map(lambda x: torch.as_tensor(x).to(
                self.device, copy=True), batch), None
        with torch.cuda.device(self.device), torch.cuda.stream(self._stream):
            out = tree_map(lambda x: torch.as_tensor(x).pin_memory().to(
                self.device, non_blocking=True), batch)
            event = torch.cuda.Event()
            event.record(self._stream)
        return out, event

    def _loop(self):
        try:
            for batch in self._it:
                self._q.put(self._place(batch))
        except BaseException as e:  # noqa: BLE001 — surfaced on next()
            self._err = e
        finally:
            self._q.put(self._DONE)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._DONE:
            if self._err is not None:
                raise self._err
            raise StopIteration
        batch, event = item
        if event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(event)
            # The batch was allocated on the side stream; tell the caching
            # allocator the consumer's stream uses it too.
            for t in tree_leaves(batch):
                t.record_stream(stream)
        return batch
