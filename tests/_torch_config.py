"""Config parity between the port and the JAX package, for the tests that
hold a port config against the JAX one.

The port's dataclasses (``repro_torch.models.config``) have every field of
the JAX package's, with the same values for every registered architecture,
plus a few fields of the port's alone (``norm_eps``, ``router_bias``, ...),
each at a default that computes what the JAX package computes.  So a port
config is held to a JAX one field by field over the JAX dataclass's
fields, nested ones included, and each field the port alone has must sit
at its default.
"""
import dataclasses

__all__ = ["jax_view", "port_only", "assert_same_config"]


def jax_view(port, jax_obj):
    """``port`` as a dictionary of the fields ``jax_obj``'s dataclass has,
    nested dataclasses likewise; a value under a field whose JAX value is no
    dataclass (None, say) is given whole."""
    if dataclasses.is_dataclass(port) and dataclasses.is_dataclass(jax_obj):
        return {f.name: jax_view(getattr(port, f.name), getattr(jax_obj, f.name))
                for f in dataclasses.fields(jax_obj)}
    return dataclasses.asdict(port) if dataclasses.is_dataclass(port) else port


def port_only(port, jax_obj, prefix=""):
    """``(path, value, default)`` of every field of ``port`` that
    ``jax_obj``'s dataclass lacks, nested dataclasses included."""
    out = []
    for f in dataclasses.fields(port):
        val = getattr(port, f.name)
        if not hasattr(jax_obj, f.name):
            out.append((prefix + f.name, val, f.default))
        elif dataclasses.is_dataclass(val) and dataclasses.is_dataclass(getattr(jax_obj, f.name)):
            out += port_only(val, getattr(jax_obj, f.name), f"{prefix}{f.name}.")
    return out


def assert_same_config(port, jax_obj):
    """Every field of the JAX config equal in the port's, and every field
    the port alone has at its default."""
    assert jax_view(port, jax_obj) == dataclasses.asdict(jax_obj)
    moved = [(path, val, default) for path, val, default in port_only(port, jax_obj)
             if val != default]
    assert not moved, moved
