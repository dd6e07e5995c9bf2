"""Carry weights over from the JAX model.

``params_from_jax`` takes the JAX ``LM.init`` pytree after the caller has
turned it into nested dictionaries and lists of numpy arrays (for example
``jax.tree.map(np.asarray, params)``), stacked over layers, and returns the
same tree of torch tensors on one device, ready for the port's ``LM``.
The port itself never sees a JAX array.
"""
from __future__ import annotations

from typing import Any, Optional, Union

import numpy as np
import torch

from ..device import resolve_device

__all__ = ["params_from_jax"]


def _tensor(a: np.ndarray) -> torch.Tensor:
    a = np.array(a, order="C")    # a writable copy: JAX hands out read-only views
    if a.dtype.name == "bfloat16":
        # numpy has no bfloat16 of its own: move the bits and relabel them
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_jax(tree: Any, device: Optional[Union[str, torch.device]] = "cuda") -> Any:
    """Numpy pytree (dicts, lists, arrays) -> the same tree of tensors on
    ``device``, dtypes kept."""
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {key: conv(val) for key, val in node.items()}
        if isinstance(node, (list, tuple)):
            return [conv(val) for val in node]
        return _tensor(np.asarray(node)).to(dev)

    return conv(tree)
