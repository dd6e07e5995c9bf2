"""A trace of the live bytes of a program, op by op, on any device.

:class:`LiveBytes` is a ``TorchDispatchMode`` that takes on every storage an
aten op makes and takes it off when it is freed, keeping the running total,
its peak and a log of the changes.  The dry-run (``launch/dryrun.py``)
prices its log per device; the kernels' meta route (``kernels/meta.py``)
traces the oracle WKV backward's live bytes with it.  Under a dispatch mode,
and on meta tensors, autograd takes its out-of-place paths for tensor
subclasses; the mode runs those ops in place as a card runs them
(:func:`_as_on_the_card`), so a trace on meta is the card's.  A CUDA kernel
that allocates buffers of its own inside an op, where no dispatch mode sees
them, is listed in :data:`CUDA_TEMPS`, and the mode holds those buffers for
the op beside its output.
"""
from __future__ import annotations

import weakref
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode, _disable_current_modes
from torch.utils._pytree import tree_leaves as _pytree_leaves

__all__ = ["LiveBytes", "CUDA_TEMPS"]

# A tensor's use counts inside ``__torch_dispatch__`` when only its caller
# holds it: the tensor's (the caller's, the dispatcher's and the mode's
# Python references) and its storage's.
_SOLE_USES = (4, 2)


def _sole(t: torch.Tensor) -> bool:
    """Held by the caller alone, and dense over its whole storage (the
    engine's ``can_accumulate_inplace``)."""
    st = t.untyped_storage()
    return ((t._use_count(), torch._C._storage_Use_Count(st._cdata)) == _SOLE_USES
            and t.storage_offset() == 0 and 0 not in t.stride()
            and st.nbytes() == t.numel() * t.element_size())


def _as_on_the_card(func, args, kwargs):
    """``func(*args, **kwargs)``, with the backward's allocations as a card
    makes them.  Under any dispatch mode, and on meta tensors with none,
    autograd takes its paths for tensor subclasses, which work out of place
    (``at::isTensorSubclassLike``): the engine sums two gradients of one
    tensor into a new one, and the backward of ``gather`` and of indexing
    scatter into a copy of their zeros.  On the card the engine adds into
    the gradient it holds when it holds the only reference, and those
    backwards scatter into their zeros in place: so here, inside a backward
    node, each such op on a tensor held by its caller alone runs in place
    (the same values, one tensor fewer)."""
    node = torch._C._current_autograd_node()
    if node is not None and not torch.is_grad_enabled():       # a backward formula
        if func is torch.ops.aten.add.Tensor and not kwargs and len(args) == 2:
            a, b = args
            if (isinstance(b, torch.Tensor) and a.shape == b.shape and a.dtype == b.dtype):
                if _sole(a):
                    return a.add_(b)
                if _sole(b) and not b.requires_grad:
                    return b.add_(a)
        elif func is torch.ops.aten.scatter_add.default and node.name() == "GatherBackward0":
            return args[0].scatter_add_(*args[1:], **kwargs)
        elif func is torch.ops.aten.index_put.default and node.name() == "IndexBackward0":
            return args[0].index_put_(*args[1:], **kwargs)
    return func(*args, **kwargs)


def _softmax_backward_temps(grad, output, dim, input_dtype):
    """The buffers CUDA's softmax backward (``softmax_backward_cuda_out``)
    makes inside the op: it forms ``grad * output`` and hands it to
    ``host_softmax_backward``, which makes it, and the output, contiguous
    where they are not.  The product is laid out on meta by the same rule
    (``TensorIterator``'s) as on the card: after a permuted gradient (the
    oracle attention backward's, through the cast of the weights) it is
    permuted too, and copied."""
    def like(t):
        return torch.empty_strided(t.shape, t.stride(), dtype=t.dtype, device="meta")

    tmp = like(grad) * like(output)
    return [tmp] * (1 if tmp.is_contiguous() else 2) + ([] if output.is_contiguous() else [output])


# aten ops whose CUDA kernel allocates buffers of its own, by op: the
# tensors (their shapes and bytes) it makes them like, freed when it returns
# (``chip_smoke.py``'s phase 13 holds them to the card's allocations)
CUDA_TEMPS = {torch.ops.aten._softmax_backward_data.default: _softmax_backward_temps}


class LiveBytes(TorchDispatchMode):
    """The bytes of the storages a traced program holds, op by op, and
    their peak.

    Every tensor an aten op returns is looked up by its untyped storage: a
    storage not seen before gets a slot, its bytes are added to ``live``,
    and a ``weakref.finalize`` on the storage takes them off when it is
    freed.  Each change is logged as (slot, +-bytes), so the log can be
    priced again per device (``launch.dryrun.cell_memory``).  :meth:`slot`
    registers the tensors that exist before the step (its arguments) first,
    or gives a seen storage its category.  While ``paused`` no new storage
    is taken on (a freed one still comes off).  With ``inherit`` a new
    storage takes the category of the first input that has one, and one an
    op makes from no tensor (``torch.zeros``) that of the op before (the
    optimizer's leaves, in ``launch.dryrun.update_temps``)."""

    def __init__(self, inherit: bool = False):
        super().__init__()
        self.inherit = inherit
        self.slot_shape: List[Tuple[int, ...]] = []
        self.slot_bytes: List[int] = []
        self.slot_cat: List[Any] = []
        self.ev_slot: List[int] = []
        self.ev_bytes: List[int] = []
        self.live = self.peak = 0
        self.paused = False
        self.update_at: Optional[int] = None      # events logged before the update
        self._slots: Dict[int, int] = {}          # id(storage) -> slot
        self._open = True
        self._last_cat: Any = None

    def slot(self, t: torch.Tensor, category: Any = None) -> int:
        st = t.untyped_storage()
        s = self._slots.get(id(st))
        if s is None:
            s, n = len(self.slot_bytes), st.nbytes()
            self._slots[id(st)] = s
            self.slot_shape.append(tuple(t.shape))
            self.slot_bytes.append(n)
            self.slot_cat.append(category)
            weakref.finalize(st, self._free, id(st), s, n)
            self._log(s, n)
        elif category is not None:
            self.slot_cat[s] = category
        return s

    def slot_of(self, t: torch.Tensor) -> Optional[int]:
        return self._slots.get(id(t.untyped_storage()))

    def _log(self, s: int, n: int) -> None:
        self.ev_slot.append(s)
        self.ev_bytes.append(n)
        self.live += n
        self.peak = max(self.peak, self.live)

    def _free(self, key: int, s: int, n: int) -> None:
        if self._open and self._slots.pop(key, None) is not None:
            self._log(s, -n)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not self.paused:
            # a tensor made outside the dispatcher (``torch.tensor`` of a
            # Python number, on meta) is taken on at its first use
            for t in _pytree_leaves((args, kwargs)):
                if isinstance(t, torch.Tensor) and self.slot_of(t) is None:
                    self.slot(t)
        out = _as_on_the_card(func, args, kwargs or {})
        if not self.paused:
            cat = None
            if self.inherit:
                ins = [t for t in _pytree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
                cat = next((self.slot_cat[s] for t in ins if (s := self.slot_of(t)) is not None
                            and self.slot_cat[s] is not None), None)
                if ins:
                    self._last_cat = cat
                else:
                    cat = self._last_cat        # a factory: the leaf being worked on
            for t in _pytree_leaves(out):
                if isinstance(t, torch.Tensor) and self.slot_of(t) is None:
                    self.slot(t, cat)
            temps = CUDA_TEMPS.get(func)
            if temps is not None:
                with _disable_current_modes():
                    made = temps(*args, **(kwargs or {}))
                self.transient([(tuple(t.shape), t.numel() * t.element_size()) for t in made],
                               cat)
        return out

    def transient(self, buffers: List[Tuple[Tuple[int, ...], int]], category: Any = None):
        """Take on ``buffers`` (shape, bytes), each a slot of its own, and
        take them off again: a kernel's own buffers, live for its call."""
        slots = []
        for shape, n in buffers:
            slots.append(len(self.slot_bytes))
            self.slot_shape.append(shape)
            self.slot_bytes.append(n)
            self.slot_cat.append(category)
            self._log(slots[-1], n)
        for s, (_, n) in zip(slots, buffers):
            self._log(s, -n)

    def close(self) -> None:
        """Stop logging frees: the storages still alive stay in the log."""
        self._open = False
