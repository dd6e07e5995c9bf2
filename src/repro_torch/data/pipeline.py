"""Host-side input pipeline: background prefetch and device placement.

``Prefetcher`` overlaps host batch synthesis with the card's compute: one
producer thread and a bounded queue, as in the JAX package's
``data/pipeline.py``.  Where the JAX version places batches on a mesh, this
one moves each batch's arrays to one device as tensors.
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Dict, Iterable, Iterator, Optional, Union

import numpy as np
import torch

__all__ = ["Prefetcher", "to_device"]


def to_device(batch: Dict[str, np.ndarray], device: Union[str, torch.device]
              ) -> Dict[str, torch.Tensor]:
    """Host arrays -> tensors on ``device``."""
    return {key: torch.from_numpy(np.ascontiguousarray(val)).to(device)
            for key, val in batch.items()}


class Prefetcher:
    """Wrap an iterator with a background producer thread and a bounded
    queue.  With ``device``, each item (a dictionary of arrays) is placed
    there by the producer.  An error in the producer is raised by the next
    ``next()``.  ``close()`` stops and joins the producer."""

    _SENTINEL = object()
    _POLL_S = 0.05

    def __init__(self, it: Iterable, depth: int = 2,
                 device: Optional[Union[str, torch.device]] = None):
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._device = device
        self._err: Optional[Exception] = None
        self._stopped = threading.Event()
        self._thread = threading.Thread(target=self._produce, args=(iter(it),),
                                        daemon=True)
        self._thread.start()

    def _put(self, item: Any) -> bool:
        while not self._stopped.is_set():
            try:
                self._q.put(item, timeout=self._POLL_S)
                return True
            except queue.Full:
                continue
        return False

    def _produce(self, it: Iterator) -> None:
        try:
            for item in it:
                if self._device is not None:
                    item = to_device(item, self._device)
                if not self._put(item):
                    return
        except Exception as e:  # raised to the consumer by __next__
            self._err = e
        finally:
            self._put(self._SENTINEL)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._SENTINEL:
            self._q.put(item)            # every later next() stops too
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item

    def close(self, timeout: float = 30.0) -> None:
        self._stopped.set()
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise RuntimeError("the prefetch thread did not stop")
