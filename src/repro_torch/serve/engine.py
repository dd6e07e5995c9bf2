"""Single-replica continuous-batching engine.

The counterpart of the JAX package's ``serve/engine.py``, with the same
slot, splice and step semantics: a fixed-capacity slot array over a
preallocated state; each request is prefilled into a fresh single-slot
state which is then spliced into its slot; every ``step()`` decodes all
slots in one batched call; finished requests free their slots.
``measure_interference`` fits the paper's linear service-time model
``T = m*k + c`` to measured decode-step latencies against the number of
co-batched sequences.

Where the JAX engine donates the old cache to each jitted call, this one
updates the state tensors in place: the model writes each layer's new state
into them, and a splice copies every leaf of a request's state into its
slot, along the batch axis the model names for it
(``LM.cache_batch_axes``): axis 1 under a layer axis, axis 2 for a hybrid
group's RG-LRU states, stacked over (groups, blocks).  (The JAX engine
splices every leaf along axis 1, which for a group's RG-LRU states is the
block axis: it serves the hybrid family wrongly; ROADMAP.md, "Known
reference faults".)  As in the JAX engine, an on-device ``pos`` holds each slot's next
position: set when a request is added, advanced for every slot, busy or
idle, after each step.

On a CUDA device the decode step is captured as CUDA graphs at the second
step and replayed after that (``LM.decode_graph``): ``tokens``, ``pos`` and
the caches are this engine's own static tensors, always written in place,
and the graph is this engine's and its model's alone.  On the CPU the step
stays eager.

An encoder-decoder model (Whisper) is refused at construction: requests
carry only tokens, and its prefill needs ``frames``.  (The JAX engine
passes only tokens too, and fails at ``add_request`` with ``KeyError:
'frames'``; ROADMAP.md, "Known reference faults".)  Decode such a model
through ``LM.prefill`` and ``LM.decode_step``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.interference import fit_linear_interference
from ..device import synchronize
from ..models.layers import FLOAT8
from ..models.transformer import LM
from ..obs.runtime import span

__all__ = ["ServingEngine", "measure_interference"]


def _splice(full, one, axis, slot: int) -> None:
    """Copy batch row 0 of every leaf of ``one`` into row ``slot`` of the
    same leaf of ``full``, in place.  ``axis`` is the batch axis, an int for
    every leaf below it or a dictionary by key (``LM.cache_batch_axes``)."""
    if isinstance(full, dict):
        for key in full:
            _splice(full[key], one[key], axis[key] if isinstance(axis, dict) else axis, slot)
        return
    if full.dtype in FLOAT8:     # a float8 cache: copy its bytes
        full, one = full.view(torch.uint8), one.view(torch.uint8)
    full.select(axis, slot).copy_(one.select(axis, 0))


@dataclass
class _Slot:
    request_id: Optional[str] = None
    pos: int = 0
    remaining: int = 0
    generated: Optional[List[int]] = None


class ServingEngine:
    """Runs on the model's device (``LM(cfg, device=...)``)."""

    def __init__(self, model: LM, params, max_batch: int = 8, max_seq: int = 512):
        if model.cfg.enc_dec:
            raise NotImplementedError(
                f"{model.cfg.name}: the engine's requests carry only tokens, and an "
                "encoder-decoder model's prefill needs frames (the JAX engine fails at "
                "add_request with KeyError: 'frames'; ROADMAP.md, 'Known reference "
                "faults'); decode it through LM.prefill and LM.decode_step")
        self.model = model
        self.params = params
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.device = model.device
        self.caches = model.init_cache(max_batch, max_seq)
        self.slots = [_Slot() for _ in range(max_batch)]
        # static buffers, written in place: a captured decode step reads these very tensors
        self.tokens = torch.zeros(max_batch, dtype=torch.long, device=self.device)
        self.pos = torch.zeros(max_batch, dtype=torch.int32, device=self.device)
        self.graph = None
        self.captures = self.replays = 0    # of decode-step graphs, by this engine

    # -- request lifecycle ------------------------------------------------------
    def free_slots(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if s.request_id is None]

    @property
    def active(self) -> int:
        return sum(s.request_id is not None for s in self.slots)

    @torch.inference_mode()
    def add_request(self, request_id: str, prompt: Sequence[int],
                    max_new_tokens: int) -> int:
        with span("serve.add_request", rid=request_id):
            free = self.free_slots()
            if not free:
                raise RuntimeError("no free slots")
            slot = free[0]
            prompt = torch.as_tensor(np.asarray(prompt, dtype=np.int64)[None, :],
                                     device=self.device)                  # (1, P)
            tmp_cache = self.model.init_cache(1, self.max_seq)
            logits, tmp_cache = self.model.prefill(
                self.params, {"tokens": prompt}, tmp_cache)
            # splice the single-request state into this slot, in place
            for full, one, axis in zip(self.caches, tmp_cache, self.model.cache_batch_axes()):
                _splice(full, one, axis, slot)
            with span("serve.readback"):
                first = int(torch.argmax(logits[0]))
            st = self.slots[slot]
            st.request_id = request_id
            st.pos = prompt.shape[1]
            st.remaining = max_new_tokens
            st.generated = [first]
            self.tokens[slot] = first
            self.pos[slot] = st.pos
        return slot

    @torch.inference_mode()
    def step(self) -> Dict[str, List[int]]:
        """One decode step for all slots; returns finished requests."""
        with span("serve.step") as sp:
            if sp:
                sp.set(rid=[st.request_id for st in self.slots if st.request_id is not None])
            nxt = torch.argmax(self._decode(), dim=-1)
            with span("serve.readback"):
                new_tokens = nxt.cpu().numpy()
            finished: Dict[str, List[int]] = {}
            for i, st in enumerate(self.slots):
                if st.request_id is None:
                    continue
                st.generated.append(int(new_tokens[i]))
                st.pos += 1
                st.remaining -= 1
                if st.remaining <= 0 or st.pos >= self.max_seq - 1:
                    finished[st.request_id] = st.generated
                    st.request_id = None
                    st.generated = None
            self.tokens.copy_(nxt)
            self.pos += 1
        return finished

    def _decode(self) -> torch.Tensor:
        """Every slot's logits for one step: on a CUDA device, through a
        :class:`~repro_torch.models.transformer.DecodeGraph` of the engine's
        model on this engine's own tensors (eager at first, then captured and
        replayed); elsewhere, or for a model whose step cannot be captured
        (``LM.decode_capturable``), eagerly.  A graph runs only the model it
        was made from: after ``self.model`` is swapped for another, a
        capturable one gets a graph of its own, and one with a kernel hook
        steps eagerly (its hook runs) while the old graph waits for its
        model to come back."""
        graph = self.graph
        if graph is not None and not graph.serves(self.model, self.params, self.caches):
            graph = None
        if graph is None and self.device.type == "cuda" and self.model.decode_capturable:
            graph = self.graph = self.model.decode_graph(self.params, self.tokens, self.pos,
                                                         self.caches)
        if graph is None:
            return self.model.decode_step(self.params, self.tokens, self.pos, self.caches)[0]
        captures, replays = graph.captures, graph.replays
        logits = graph()
        self.captures += graph.captures - captures
        self.replays += graph.replays - replays
        return logits


# -- the Fig. 4 analogue ---------------------------------------------------------
def measure_interference(
    model: LM, params, batch_sizes: Sequence[int], *, max_seq: int = 256,
    iters: int = 20, warmup: int = 3, prompt_len: int = 8,
) -> Tuple[float, float, float, List[Tuple[int, float]]]:
    """Measure decode-step latency as a function of co-batched sequences and
    fit ``T = m*k + c`` to the timings.  On the card the device is
    synchronised before each clock read.  Returns (m, c, r2, samples)."""
    samples: List[Tuple[int, float]] = []
    rng = np.random.default_rng(0)
    for k in batch_sizes:
        eng = ServingEngine(model, params, max_batch=int(k), max_seq=max_seq)
        for j in range(int(k)):
            eng.add_request(
                f"probe{j}", rng.integers(0, model.cfg.vocab, prompt_len),
                max_new_tokens=10**9,
            )
        for _ in range(warmup):
            eng.step()
        synchronize(model.device)
        t0 = time.perf_counter()
        for _ in range(iters):
            eng.step()
        synchronize(model.device)
        dt = (time.perf_counter() - t0) / iters
        samples.append((int(k), dt))
    m, c, r2 = fit_linear_interference(
        [s[0] for s in samples], [s[1] for s in samples]
    )
    return m, c, r2, samples
