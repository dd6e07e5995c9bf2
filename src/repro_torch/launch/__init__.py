"""Launch layer: meshes, sharding rules, the dry-run on the meta device,
the roofline priced for H100 cards, and the train and serve drivers.

The dry-run sets nothing at import (the JAX package's sets ``XLA_FLAGS``
for 512 host devices; PyTorch's meta device needs no such flag), and
``serve`` and ``train`` are imported as modules of their own.
"""
from .mesh import (AbstractMesh, dp_axes, make_host_mesh, make_mesh, make_production_mesh,
                   mesh_axis_sizes)
from .sharding import (
    NamedSharding,
    PartitionSpec,
    batch_shardings,
    cache_shardings,
    param_pspec,
    param_shardings,
    replicated,
)

__all__ = [
    "AbstractMesh",
    "make_production_mesh",
    "make_host_mesh",
    "make_mesh",
    "dp_axes",
    "mesh_axis_sizes",
    "PartitionSpec",
    "NamedSharding",
    "param_pspec",
    "param_shardings",
    "batch_shardings",
    "cache_shardings",
    "replicated",
]
