"""Host-side input pipeline: background prefetch and device placement.

``Prefetcher`` overlaps host batch synthesis with the card's compute: one
producer thread and a bounded queue, as in the JAX package's
``data/pipeline.py``.  ``shard_batch`` places a global host batch by the
step's input shardings (``launch.sharding.NamedSharding`` on a
``DeviceMesh``): each rank keeps its block of a sharded key as a DTensor;
``to_device`` moves a batch's arrays to one device.
"""
from __future__ import annotations

import math
import queue
import threading
from typing import Any, Dict, Iterable, Iterator, Optional, Union

import numpy as np
import torch

__all__ = ["Prefetcher", "shard_batch", "to_device"]


def to_device(batch: Dict[str, np.ndarray], device: Union[str, torch.device]
              ) -> Dict[str, torch.Tensor]:
    """Host arrays -> tensors on ``device``."""
    return {key: torch.from_numpy(np.ascontiguousarray(val)).to(device)
            for key, val in batch.items()}


def _local_block(t: torch.Tensor, sharding) -> torch.Tensor:
    """This rank's block of a global tensor under ``sharding`` (a
    ``NamedSharding`` on a ``DeviceMesh``): a dim split over several axes
    in JAX's order, the first major, as ``jax.device_put`` lays it out and
    ``NamedSharding.placements`` describe it; a view, no copy."""
    mesh = sharding.mesh
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    for i in range(len(sharding.spec)):
        axes = sharding.spec.axes(i)
        parts = math.prod(sizes[a] for a in axes)
        if parts == 1:
            continue
        if t.shape[i] % parts:
            raise ValueError(f"dim {i} of size {t.shape[i]} does not split over {axes}")
        idx = 0
        for a in axes:
            idx = idx * sizes[a] + coord[a]
        n = t.shape[i] // parts
        t = t.narrow(i, idx * n, n)
    return t


def shard_batch(batch: Dict[str, np.ndarray], shardings: Dict[str, Any],
                device: Optional[Union[str, torch.device]] = None) -> Dict[str, torch.Tensor]:
    """Host arrays placed by ``shardings``: a key whose ``NamedSharding``
    lies on a ``DeviceMesh`` becomes a DTensor with its placements, any
    other key a tensor on ``device`` (default: the device type of the
    shardings' mesh, else the card).  Every rank passes the same global
    array and keeps its own block, sliced on the host before it is moved to
    the mesh's device, as ``jax.device_put`` of a global host array does:
    no collective, so a producer thread may place batches while the step's
    collectives run."""
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor

    meshes = [sh.mesh for sh in shardings.values() if isinstance(sh.mesh, DeviceMesh)]
    if device is None:
        device = meshes[0].device_type if meshes else "cuda"
    out = {}
    for key, val in batch.items():
        sh = shardings.get(key)
        if sh is None:
            out.update(to_device({key: val}, device))
        elif isinstance(sh.mesh, DeviceMesh):
            t = torch.from_numpy(np.ascontiguousarray(val))
            local = _local_block(t, sh).contiguous().to(sh.mesh.device_type)
            out[key] = DTensor.from_local(local, sh.mesh, list(sh.placements), run_check=False,
                                          shape=t.shape, stride=t.stride())
        else:
            raise ValueError(f"{key!r}: a sharding on {type(sh.mesh).__name__} places "
                             "nothing; give one on a DeviceMesh")
    return out


class Prefetcher:
    """Wrap an iterator with a background producer thread and a bounded
    queue.  With ``shardings``, each item (a dictionary of arrays) is placed
    by :func:`shard_batch` (its unsharded keys on ``device``); else, with
    ``device``, moved there.  An error in the producer is raised by the
    next ``next()``.  ``close()`` stops and joins the producer."""

    _SENTINEL = object()
    _POLL_S = 0.05

    def __init__(self, it: Iterable, depth: int = 2,
                 device: Optional[Union[str, torch.device]] = None,
                 shardings: Optional[Dict[str, Any]] = None):
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._device = device
        self._shardings = shardings
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
                if self._shardings is not None:
                    item = shard_batch(item, self._shardings, self._device)
                elif self._device is not None:
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
