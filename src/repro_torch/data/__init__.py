"""Data pipeline: the deterministic synthetic LM stream and a background
prefetcher that places batches on the model's device."""
from .pipeline import Prefetcher, to_device
from .synthetic import SyntheticLM, materialize_batch

__all__ = ["SyntheticLM", "materialize_batch", "Prefetcher", "to_device"]
