"""Model substrate: config, layers, GQA and MLA attention, the mixture of
experts, the RWKV6 block and the ``LM`` assembly."""
from .config import MLAConfig, ModelConfig, MoEConfig, RecurrentConfig, reduced
from .convert import params_from_jax
from .transformer import LM, Segment, build_segments

__all__ = [
    "ModelConfig",
    "MoEConfig",
    "MLAConfig",
    "RecurrentConfig",
    "reduced",
    "LM",
    "Segment",
    "build_segments",
    "params_from_jax",
]
