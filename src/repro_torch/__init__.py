"""PyTorch and CUDA port of the :mod:`repro` package for one NVIDIA H100.

Module paths mirror the JAX package, so ``repro_torch.models.recurrent`` is
the counterpart of ``repro.models.recurrent``.  The port imports ``torch``,
``numpy`` and the standard library only, never ``jax`` and nothing of
``repro``.  Entry points run on the card (``device="cuda"``) unless the caller
passes ``device="cpu"``; with no card they raise rather than fall back.
"""
