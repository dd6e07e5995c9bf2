"""Checkpoint save and restore, in the JAX package's on-disk layout.

The counterpart of the JAX package's ``ckpt/checkpoint.py``:

  * atomic writes (a temporary directory, then a rename) of
    ``<root>/step_<n>/arrays.npz`` and a ``manifest.json`` with the step, a
    timestamp from an injectable clock, and each leaf's shape, dtype and
    CRC32 under ``leaf_<i>``, leaves in ``jax.tree.flatten`` order (dict
    keys sorted), so a torn write is never taken for a valid checkpoint and
    a checkpoint the JAX package wrote restores here;
  * replication across independent directories; restore takes the newest
    replica that passes its checksums;
  * an async mode that writes a host snapshot on a background thread;
  * ``CheckpointManager.maybe_save`` on the Young/Daly interval
    ``sqrt(2 C / lambda)`` from the fleet failure rate and the observed
    write cost.

numpy has no bfloat16 of its own and the port does not use ``ml_dtypes``, so
a bfloat16 leaf is stored as its ``uint16`` bits with ``"bfloat16"`` in the
manifest (the bytes, and so the CRC, are those of the bfloat16 array).  The
manifest clock defaults to ``time.perf_counter``; pass ``clock=time.time``
for wall-clock stamps.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading
import time
import zipfile
import zlib
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.availability import gang_failure_rate, young_daly_interval
from ..tree import tree_flatten, tree_map, tree_unflatten

__all__ = ["save_checkpoint", "load_checkpoint", "CheckpointManager"]

Clock = Callable[[], float]

_BF16 = "bfloat16"


def _host(x: Any) -> Tuple[np.ndarray, str]:
    """A leaf as a host array and the dtype name the manifest records."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), _BF16
        a = t.numpy()
    else:
        a = np.asarray(x)
    return a, str(a.dtype)


def _tensor(a: np.ndarray, dtype: str, device: torch.device) -> torch.Tensor:
    if dtype == _BF16:
        a = np.ascontiguousarray(a).view(np.int16)
        return torch.from_numpy(a.copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def _crc(a: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(a).tobytes())


def save_checkpoint(path: str, tree: Any, step: int,
                    extra: Optional[Dict[str, Any]] = None, *,
                    clock: Clock = time.perf_counter) -> str:
    """Atomically write one checkpoint directory ``<path>/step_<n>``."""
    os.makedirs(path, exist_ok=True)
    final = os.path.join(path, f"step_{step:08d}")
    tmp = tempfile.mkdtemp(prefix=".ckpt_tmp_", dir=path)
    try:
        leaves, _ = tree_flatten(tree)
        arrs, dtypes = {}, {}
        for i, leaf in enumerate(leaves):
            arrs[f"leaf_{i}"], dtypes[f"leaf_{i}"] = _host(leaf)
        manifest = {
            "step": int(step),
            "time": float(clock()),
            "leaves": {
                k: {"shape": list(v.shape), "dtype": dtypes[k], "crc": _crc(v)}
                for k, v in arrs.items()
            },
            "extra": extra or {},
        }
        np.savez(os.path.join(tmp, "arrays.npz"), **arrs)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        return final
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def _validate_and_load(ckpt_dir: str, like: Any) -> Tuple[Any, int, Dict]:
    with open(os.path.join(ckpt_dir, "manifest.json")) as f:
        manifest = json.load(f)
    leaves, structure = tree_flatten(like)
    out = []
    with np.load(os.path.join(ckpt_dir, "arrays.npz")) as data:
        for i, ref_leaf in enumerate(leaves):
            key = f"leaf_{i}"
            a = data[key]
            meta = manifest["leaves"][key]
            if _crc(a) != meta["crc"]:
                raise IOError(f"checksum mismatch in {ckpt_dir}:{key}")
            if list(a.shape) != list(ref_leaf.shape):
                raise IOError(f"shape mismatch in {ckpt_dir}:{key}: "
                              f"{a.shape} vs {tuple(ref_leaf.shape)}")
            device = ref_leaf.device if isinstance(ref_leaf, torch.Tensor) else "cpu"
            out.append(_tensor(a, meta["dtype"], device))
    return tree_unflatten(structure, out), manifest["step"], manifest.get("extra", {})


def load_checkpoint(paths: Sequence[str], like: Any
                    ) -> Tuple[Any, int, Dict[str, Any]]:
    """Restore the newest valid checkpoint across every replica directory,
    as tensors on the devices of ``like``'s leaves.

    Torn or corrupt replicas are skipped (checksums); raises
    ``FileNotFoundError`` when no valid checkpoint exists anywhere."""
    candidates: List[Tuple[int, str]] = []
    for root in paths:
        if not os.path.isdir(root):
            continue
        for name in os.listdir(root):
            if name.startswith("step_"):
                try:
                    candidates.append((int(name.split("_")[1]), os.path.join(root, name)))
                except ValueError:
                    continue
    candidates.sort(reverse=True)
    errors = []
    for _, d in candidates:
        try:
            return _validate_and_load(d, like)
        except (OSError, KeyError, ValueError, EOFError, zipfile.BadZipFile) as e:
            errors.append(f"{d}: {e}")   # torn or corrupt replica: try the next
    raise FileNotFoundError(
        "no valid checkpoint found" + (f"; errors: {errors}" if errors else "")
    )


@dataclass
class CheckpointManager:
    """Replicated, optionally async checkpointing with Young/Daly cadence.

    replica_dirs : k independent directories (ideally on independent failure
                   domains).  The replication degree is the paper's gamma.
    fleet_lams   : per-pod failure rates; the job fails if any pod fails, so
                   rates add (gang_failure_rate).
    """

    replica_dirs: Sequence[str]
    fleet_lams: Sequence[float] = (1e-5,)
    async_save: bool = False
    keep: int = 3
    clock: Clock = time.perf_counter      # manifest timestamps (inject for tests)

    _last_save_t: float = field(default=0.0, init=False)
    _write_cost: float = field(default=30.0, init=False)   # prior estimate, s
    _thread: Optional[threading.Thread] = field(default=None, init=False)
    _errors: List[str] = field(default_factory=list, init=False)

    @property
    def interval(self) -> float:
        lam = gang_failure_rate(self.fleet_lams)
        return young_daly_interval(lam, self._write_cost)

    def due(self, now: Optional[float] = None) -> bool:
        now = time.perf_counter() if now is None else now
        return (now - self._last_save_t) >= self.interval

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._errors:
            errs, self._errors = self._errors, []
            raise IOError(f"async checkpoint failed: {errs}")

    def _write_all(self, host_tree: Any, step: int, extra) -> None:
        t0 = time.perf_counter()
        try:
            for d in self.replica_dirs:
                save_checkpoint(d, host_tree, step, extra, clock=self.clock)
                self._gc(d)
        except Exception as e:   # reported by wait() / save()
            self._errors.append(str(e))
            return
        # online estimate of the write cost drives the Young/Daly interval
        self._write_cost = 0.5 * self._write_cost + 0.5 * max(
            time.perf_counter() - t0, 1e-3
        )

    def save(self, tree: Any, step: int, extra: Optional[Dict] = None) -> None:
        """Snapshot ``tree`` to the host (a copy, so later in-place updates
        do not reach it), then write every replica, on a background thread
        when ``async_save``."""
        self.wait()
        host_tree = tree_map(
            lambda x: x.detach().to("cpu", copy=True) if isinstance(x, torch.Tensor)
            else np.array(x), tree)
        self._last_save_t = time.perf_counter()
        if self.async_save:
            self._thread = threading.Thread(
                target=self._write_all, args=(host_tree, step, extra), daemon=True
            )
            self._thread.start()
        else:
            self._write_all(host_tree, step, extra)
            if self._errors:
                errs, self._errors = self._errors, []
                raise IOError(f"checkpoint failed: {errs}")

    def maybe_save(self, tree: Any, step: int, extra: Optional[Dict] = None) -> bool:
        if not self.due():
            return False
        self.save(tree, step, extra)
        return True

    def restore(self, like: Any) -> Tuple[Any, int, Dict[str, Any]]:
        return load_checkpoint(self.replica_dirs, like)

    def _gc(self, root: str) -> None:
        steps = sorted(
            (n for n in os.listdir(root) if n.startswith("step_")), reverse=True
        )
        for name in steps[self.keep:]:
            shutil.rmtree(os.path.join(root, name), ignore_errors=True)
