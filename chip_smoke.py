"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each failing the run with a non-zero exit if anything is wrong:

1. device    requires CUDA; prints the card's name and power limit.
2. build     builds every CUDA kernel from ``src/repro_torch/csrc`` for
             sm_90a in one parallel build and prints nvcc's register and
             shared-memory reports; every bf16 attention instantiation's
             (head size; one warpgroup a block, no cluster) registers,
             spills and blocks an SM, failing on a spill;
             every bf16-q variant of the decode kernel's registers, spills
             and blocks an SM, failing on a spill or on fewer blocks an SM
             than its split plan counts on; every f32-q variant's (K/V
             kinds 0-4 at D = 64, 128, 256) registers, spills and blocks
             an SM.
3. kernels   holds each kernel against its plain PyTorch version on the
             card at the main paths' shapes (the WKV kernel also under a
             strong decay; the bf16 attention, decode and WKV kernels also
             against the plain version on their inputs cast up to float32),
             and times both (and, for attention and decode,
             ``scaled_dot_product_attention`` as a yardstick); the bf16
             attention kernel at the training shape, the prefill shapes and
             the hybrid, Whisper and vlm training shapes, each with the K/V
             bytes its plan fetches from L2 and those bytes over its time;
             the f32 SIMT
             attention kernel at the dense prefill shape with its bound at
             the f32 peak and SDPA in f32; the WKV kernel at 128, 200 and 512 tokens (a
             CUDA graph of calls, so the gaps between its three passes
             count; the decode times from profiles that saw every kernel
             of their calls), and the host's time a call of each; checks by the
             profiler that a call of attention or decode runs one kernel on
             the card and a WKV call three.  The decode kernel also on
             float8_e4m3fn K/V (a float8 cache) at the dense and the hybrid
             heads, q in bf16 and in f32, served and full, its bound from
             the bytes read with K/V at one byte an element, SDPA on the
             widened K/V as the yardstick.
4. serve     serves requests through ``ServingEngine`` on full-width
             RWKV6-3B in bf16 (random weights from a seed) and checks that
             every prefill went through the WKV kernel, that the tokens are
             valid ids, and one prefill's logits against the plain WKV.
5. fit       fits ``T = m*k + c`` to decode-step latency with
             ``measure_interference``.
6. dense     serves the same requests through ``ServingEngine`` on
             full-width Minitron-8B in bf16 with a KV cache and checks that
             every prefill went through the tensor-core attention kernel and every
             decode step through the decode kernel, that the tokens are
             valid ids, one prefill's logits against the plain attention
             and a few decode steps' logits against the plain decode
             attention (in bf16 and in a float32 copy); fits
             ``T = m*k + c`` on this model and profiles one decode step.
             Then a second engine over the same weights with
             ``kv_dtype="float8_e4m3fn"`` serves the same requests: every
             decode step runs the decode kernel once a layer on float8 K/V,
             reading each layer's slice of the engine's cache itself (no
             widened copy), valid tokens, a few decode steps' logits held
             against the plain route on the same float8 cache; greedy
             agreement with the bf16-cache engine, its step median and peak
             memory reported beside the bf16 engine's.  Prints a
             ``dense_float8`` line.
7. train     trains full-width Qwen1.5-0.5B in bf16 through
             ``repro_torch.launch.train.train`` (B=4, S=2048, 6 steps) and
             checks that every attention layer's forward ran the tensor-core
             attention kernel, that losses and gradient norms are finite, that step
             1 agrees with the same step through the plain attention (in
             bf16 and in a float32 copy), and that a checkpoint of the final
             state restores leaf for leaf.
8. place     the IBDASH placement core through ``repro_torch.api``: the
             four float64 decision kernels and the stable queue selection
             against their plain numpy versions, bit for bit, at G=1024
             rows and D=100,000 devices (exact ties, infeasible rows, +inf
             entries), with their times; one wave on the 100,000-device
             ``multi_tier`` fleet through ``orchestrate_batch`` for each
             kernel-backed policy, equal to the same wave on the CPU and
             launching its kernels; a 10,000-device wave equal to the
             scalar ``batched=False`` path; and ``run_one`` at the paper's
             100 devices and 1000 instances a cycle (``mix`` with a fused
             burst, ``churn`` with ``replan``), equal to the same run on
             the CPU instance for instance.  Prints a ``place`` JSON line.
9. stream    the streaming service, the serving fleet and the exporters
             through ``repro_torch``, each run on the card and on the CPU
             and held equal (``==``; only the two wall-clock metrics
             ``wave_plan_s`` and ``placements_per_sec`` left out):
             ``benchmarks/bench_stream.py``'s overload point (100 devices,
             Poisson arrivals at 240/s over 45 s, queue 256, waves of 30)
             with admission and as the no-admission baseline, each equal
             to the committed ``BENCH_stream.json`` (read as a file); the
             admitted run once more traced, its attribution report,
             summary and Chrome trace equal on both devices, the trace
             valid and its instance ledger rebuilt from the JSON alone;
             the fleet comparison of the JAX ``serve_demo`` (16 replicas, 600
             requests over 8 s; ibdash, petrel, lavea, round_robin, then
             ibdash fused, behind admission and under churn with replan)
             fed by the dense phase's fit.  Every IBDASH ``decide_batch``
             pool of at least ``BATCH_KERNEL_MIN_ROWS`` rows must launch
             the queue and scan kernels once.  Prints a ``stream`` line.
10. moe     serves the same requests through ``ServingEngine`` on
             full-width Qwen1.5-MoE-A2.7B in bf16 (24 layers, 60 experts
             top-4 and 4 shared ones, 28.6 GB of weights; TF32 off, so the
             router's product stays float32) and checks that every prefill
             ran the attention kernel 24 times and every decode step the
             decode kernel 24 times, that the tokens are valid ids and the
             peak memory fits the card; holds both kernels layer by layer
             on the path's own activations against their plain versions
             (in bf16 and in float32), and the whole model's logits by RMS
             distance, counting the (token, layer) expert sets that
             differ (a rounding can flip a near tie, so equal routing is
             not required); holds the sort dispatch against the einsum
             dispatch on one layer with no drops; fits ``T = m*k + c``;
             profiles a decode step beside its bound.  Then DeepSeek-V3 at published widths cut
             to 4 layers (its 3 dense layers and the first MoE layer, all
             256 experts) serves two requests without a kernel (MLA is
             plain torch, as in the JAX model) and its absorbed MLA decode
             is held against the expanded form layer by layer.  Prints a
             ``moe`` line.
11. hybrid  serves the same requests through ``ServingEngine`` on
             full-width RecurrentGemma-9B in bf16 (38 layers: 26 RG-LRU
             blocks and 12 local-attention blocks with MQA at D = 256 over
             a 2048-slot ring; 17.2 GB of weights) and checks that every
             prefill ran the attention kernel 12 times and every decode
             step the decode kernel 12 times, that the tokens are valid ids
             and the peak memory fits the card; holds both kernels layer by
             layer on the path's own activations (bf16 and float32) and the
             whole model's logits by RMS distance; holds one layer's RG-LRU
             scan against the sequential recurrence in float64; serves one
             request of 2000 tokens and 96 new ones through a second engine
             (ring of 2048 slots), 48 decode steps after the wrap, and holds
             the decode kernel layer by layer at a step after it; fits
             ``T = m*k + c``; profiles a decode step beside its bound.
             Prints a ``hybrid`` line.
12. vlm-audio (a) serves the same requests through ``ServingEngine`` on
             Qwen2-VL-72B at published width (64 query heads of 128 over 8
             kv heads, QKV bias, d_ff 29568, vocab 152064) cut to 24 of
             its 80 layers (47.1 GB of bf16 weights; text: RoPE on
             positions, which is M-RoPE for text), checks every prefill
             ran the attention kernel 24 times and every decode step the
             decode kernel 24 times at g = 8, holds both kernels layer by
             layer and the whole model's logits as phase 10 does, then one
             prefill and 4 decode steps with image-then-text M-RoPE ids
             (t, h and w differ) held the same way, and profiles a decode
             step beside its bound; (b) trains it cut to 4 layers (B=1,
             S=2048, 4 AdamW steps through ``make_train_step`` on the
             trainer's batches with text ``position_ids``): the kernel in
             every layer's forward, finite losses, step 1 against the
             plain attention as phase 7 holds it; (c) trains Whisper-tiny
             uncut through ``train()`` (B=8, S=448, Whisper's decoder
             context, 6 steps; zero frames) as phase 7 trains; (d) decodes
             Whisper-tiny through ``LM.prefill`` (the encoder over 8 x
             1500 frames from a seed, a 4-token prompt) and 60 greedy
             ``LM.decode_step``s over a 448-slot self cache and the
             1500-slot cross cache: the attention kernel 4 times a
             prefill, the decode kernel 4 times a step (D = 64, g = 1),
             both held layer by layer and the whole model's logits.  The
             encoder and cross-attention are plain torch, as the JAX
             model leaves them to XLA.  Prints a ``vlm_audio`` line.
13. train-moe-hybrid  trains Qwen1.5-MoE-A2.7B (B=1, S=2048) and
             RecurrentGemma-9B (B=1, S=4096, past its 2048-token window)
             through ``make_train_step(model, Adafactor(lr=1e-3))`` with
             ``remat="block"``, 4 steps each on the trainer's batches,
             uncut if the dry-run's traced peak of the same step on the
             one-card mesh (printed first) fits 0.9 of the card, else cut
             in depth: the attention kernel twice a layer a step (the
             forward and its recompute), finite losses, gradient norms and
             aux loss, the step median, tokens/s, and the card's peak memory
             over the steps within 10% of the traced peak, a profiled step;
             step 1 against the plain
             attention at full depth in bf16, and by phase 7's float32 and
             bf16 rules on a copy cut to 2 layers (one group for the
             hybrid).  Then phase 7's model at B=4, S=2048 under remat
             none, block and dots, 3 AdamW steps each: 24, 48 and 48
             attention launches a step, losses equal, gradient norms within
             1e-3, step medians and peak memory.  Prints a
             ``train_moe_hybrid`` line.
14. distribution  the distribution layer (``repro_torch.launch``,
             ``optim/compression.py``, ``train/pipeline.py``): (a) a
             one-rank NCCL process group and a (pod=1, data=1, model=1)
             ``DeviceMesh`` on the card; (b) phase 7's model and batch
             through the int8 cross-pod step (``grad_compression="int8"``,
             3 steps rounded to nearest, then one stochastic): step 1's
             loss ``==`` the plain step's from the same weights, each
             leaf's mean its own round trip bit for bit and within half a
             step (one, stochastic), the parameters within 5e-3 of the
             plain step's, 24 wgmma attention launches a step; both steps'
             ms, the quantize-gather-dequantize ms and the pod bytes;
             (c) the same 24 layers through ``split_stages(., 1)`` and
             ``pipeline_loss_fn`` on a one-rank "stage" mesh, M=4
             microbatches of (1, 2048): loss and gradient norm against
             ``LM.loss`` averaged over the microbatches, bf16 within 2^-7,
             a float32 copy cut to 2 layers within 1e-5, 96 launches in the
             forward; (e) the dry-run's twin of ``qwen1.5-0.5b train_4k``
             at B=4 on the one-card mesh: resident bytes ``==`` the
             card's, the step (remat "block") 3 times beside its roofline
             bound and the TFLOP/s on the counted FLOPs, its memory record
             and traced peak within 5% of the card's max_memory_allocated
             over the same steps; then, with the
             group destroyed, (d) the 80-cell dry-run grid on the meta
             device (64 ok, 16 skip: ``long_500k`` on the full-attention
             architectures; sequence parallelism, the default), both H100
             roofline tables with each cell's peak GiB a device and whether
             it fits a card, the count that fits on each mesh, the collective and binding terms of the
             seven recurrent, MLA/MoE and Adafactor cells held to the JAX
             records, one multi-pod cell under int8 compression,
             whose pod bytes are half the bf16 all-reduce's plus the
             scales, and ``qwen1.5-0.5b train_4k`` single under
             ``--seq-shard sp`` against ``none`` (bytes by axis, the
             collective term).  Prints a
             ``distribution`` line.
15. audit-kvdtype  (a) the port's kernel audit
             (``repro_torch.analysis.kernel_audit.builtin_targets("cuda")``):
             the five float64 decision kernels, the three kernels' entry
             points (launching the CUDA kernels) and a reduced Qwen1.5-0.5B's
             decode step and prefill through a ``ServingEngine``'s caches,
             each run on the card under the dispatch recorder and
             ``torch.cuda.set_sync_debug_mode("error")``: no finding (float64
             end to end, no host round trip, the expected input signatures,
             the cache written in place), their op counts, launches and
             cache pointers printed; (b) the decode kernel on K/V in another
             float dtype than q's (bf16 and f16 K/V under f32 q, f32 and f16
             K/V under bf16 q) and an f32 q over f32 K/V (the float32
             model's own cache) at phase 3's dense, MoE and hybrid heads, B=8,
             C=1024, served and full, against the plain version, with its
             time, the plain version's, SDPA's on K/V cast to q's dtype and
             the bound from the bytes at K/V's own width, and the registers
             and spills of those variants (in a whole run (b) runs beside
             phase 3's decode checks, where one call's profile is
             reliable); (c) full-width Minitron-8B in
             float32 (30.9 GB of weights) served with phase 6's requests
             from a float32 cache and from a bfloat16 one: every decode
             launch on the bf16-K/V kind reading the engine's cache itself,
             the prefill through the f32 attention kernel, 4 decode steps
             held against the plain route on the same cache and by phase
             6's RMS rule against the float32 cache's, greedy agreement with
             the float32 cache's tokens reported; then from a float16 cache,
             and the weights rounded to bfloat16 served from bfloat16,
             float32 and float16 caches.  Prints an ``audit_kvdtype`` line.

Phase 3 runs the attention and decode kernels also at the MoE path's
heads (Hq = Hk = 16, D = 128), at Command R+'s g = 12 (Hq = 96, Hk = 8) and
at RecurrentGemma's (Hq = 16, Hk = 1, D = 256, window 2048: the hybrid
prefill, the family's training length S = 4096 and the decode at the
served lengths, a full cache and past the ring's wrap), at Whisper's
decoder (Hq = Hk = 6, D = 64: training at B=8, S=448, decode over its
448-slot cache) and at Qwen2-VL's (Hq = 64, Hk = 8, D = 128: training at
S = 2048, decode at the serving shape).

The ``place``, ``stream``, ``moe``, ``hybrid``, ``vlm_audio``, ``dense_float8``,
``train_moe_hybrid``, ``distribution`` and ``audit_kvdtype`` lines come before the
``kernels`` line.  The line before the last is a JSON object with each kernel's
launches on its main paths (calls of its wrapper, by path and summed),
the kernels a call runs on the card, its error against the plain version,
its time, the plain version's time, its bound and the library call's time
at its main shape and by shape; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Imports nothing of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402
from torch.utils.checkpoint import checkpoint  # noqa: E402

from repro_torch.analysis.kernel_audit import builtin_targets, run_audit  # noqa: E402
from repro_torch.ckpt.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.api import (  # noqa: E402
    Orchestrator,
    SimConfig,
    make_cluster,
    make_policy,
    make_profile,
    orchestrate_batch,
    run_one,
)
from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.configs.shapes import SHAPES, ShapeSpec  # noqa: E402
from repro_torch.core import batched  # noqa: E402
from repro_torch.core.policy import IBDASHPolicy  # noqa: E402
from repro_torch.obs import (  # noqa: E402
    attribution_report,
    format_report,
    json_summary,
    ledger_from_trace,
    to_chrome_trace,
    validate_chrome_trace,
)
from repro_torch.launch.serve import fleet_interference  # noqa: E402
from repro_torch.serve.scheduler import ServingFleet  # noqa: E402
from repro_torch.stream import (  # noqa: E402
    AdmissionConfig,
    StreamingOrchestrator,
    default_streams,
    WALL_CLOCK_METRICS,
    poisson_arrivals,
    without_wall_clock,
)
from repro_torch.sim.apps import APP_BUILDERS  # noqa: E402
from repro_torch.sim.runner import policy_for  # noqa: E402
from repro_torch.data.synthetic import SyntheticLM  # noqa: E402
from repro_torch.data.pipeline import to_device  # noqa: E402
from repro_torch.kernels.bf16_split import bf16_split  # noqa: E402
from repro_torch.kernels.build import build  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.ref import bf16_split_ref  # noqa: E402
from repro_torch.kernels.flash_attention import smem_bytes as attn_smem_bytes  # noqa: E402
from repro_torch.kernels.flash_attention import tile_plan  # noqa: E402
from repro_torch.kernels.flash_attention import occupancy as attention_occupancy  # noqa: E402
from repro_torch.kernels.flash_decode import MAX_CLUSTER, flash_decode, heads_per_block  # noqa: E402
from repro_torch.kernels.flash_decode import call_plan, clustered, kv_kind  # noqa: E402
from repro_torch.kernels.flash_decode import planned_blocks_per_sm  # noqa: E402
from repro_torch.kernels.flash_decode import blocks_per_sm as decode_blocks_per_sm  # noqa: E402
from repro_torch.kernels.flash_decode import smem_bytes as decode_smem_bytes  # noqa: E402
from repro_torch.kernels import meta as kernel_meta  # noqa: E402
from repro_torch.kernels.flash_decode import _lib as decode_lib  # noqa: E402
from repro_torch.kernels.meta import attention_work, decode_work, wkv_cost  # noqa: E402
from repro_torch.kernels.meta import wkv_tiling  # noqa: E402
from repro_torch.kernels.ref import attention_ref, decode_attention_ref, rwkv6_ref  # noqa: E402
from repro_torch.kernels.rwkv6_scan import KERNELS_PER_CALL as WKV_KERNELS_PER_CALL  # noqa: E402
from repro_torch.kernels.rwkv6_scan import kernel_chunk, rwkv6_scan, smem_bytes  # noqa: E402
from repro_torch.launch import dryrun, roofline  # noqa: E402
from repro_torch import memtrace  # noqa: E402
from repro_torch.launch.mesh import AbstractMesh, make_host_mesh, make_mesh  # noqa: E402
from repro_torch.launch.mesh import mesh_axis_sizes  # noqa: E402
from repro_torch.launch.train import frontend_stubs, train  # noqa: E402
from repro_torch.models import LM  # noqa: E402
from repro_torch.models import moe as moe_module  # noqa: E402
from repro_torch.models import recurrent as recurrent_module  # noqa: E402
from repro_torch.models import transformer as transformer_module  # noqa: E402
from repro_torch.models.layers import FLOAT8, astype, norm_apply, torch_dtype  # noqa: E402
from repro_torch.optim import optimizers  # noqa: E402
from repro_torch.optim.compression import int8_dequantize, int8_quantize  # noqa: E402
from repro_torch.optim.optimizers import Adafactor, AdamW, global_norm  # noqa: E402
from repro_torch.optim.schedules import cosine_with_warmup  # noqa: E402
from repro_torch.serve.engine import ServingEngine, measure_interference  # noqa: E402
from repro_torch.train import step as step_module  # noqa: E402
from repro_torch.train.pipeline import pipeline_efficiency, pipeline_loss_fn  # noqa: E402
from repro_torch.train.pipeline import split_stages  # noqa: E402
from repro_torch.train.step import make_train_step, value_and_grad  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

# Published peaks of one H100 SXM (NVIDIA data sheet, dense, at 700 W).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
TF32_OPS_PER_S = 495e12
BF16_OPS_PER_S = 989e12
# FP64 outside the tensor cores (same data sheet): the decision kernels' type.
F64_OPS_PER_S = 34e12

H, N = 40, 64                       # RWKV6-3B: 40 heads of size 64
KERNEL_TOL = {torch.float32: 2e-3, torch.bfloat16: 5e-2}
# Prefill logits through the WKV kernel against the plain WKV (prefill_check):
# in float32, max |difference| within this share of max |logit| (the kernel's
# f32 error, about 1e-6 of |y|, grown through 32 layers); in bf16, RMS distance
# from the float32 plain logits within this factor of the plain bf16 path's.
LOGITS_F32_TOL = 1e-3
BF16_NOISE_FACTOR = 2.0
# The bf16 WKV kernel also against rwkv6_ref on its inputs cast up to
# float32: beyond the rounding of its bf16 y (half an ulp, at most 2^-8 of
# |y|), at most this share of max |y|, room for its products' TF32 operands
# (at most 2.4e-4 of max |y| at the kernel_phase shapes on an H100, so about
# 2x that); S_T, whose update stays in f32, within the f32 KERNEL_TOL.
WKV_BF16_UPCAST_TOL = 5e-4
SERVE_PROMPTS = (64, 128, 80, 200, 512, 16, 33, 256, 97, 20)
SERVE_NEW_TOKENS = (16, 32, 24, 20, 16, 32, 18, 28, 16, 24)

# Attention kernel against attention_ref: float32 at 1e-4 abs + rel (the
# JAX sweep's 3e-5, widened for the card's other summation order); bf16 at
# the sweep's 3e-2.
ATTN_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
# The bf16 attention kernel also against attention_ref on its inputs cast up
# to float32: beyond the rounding of its bf16 output (half an ulp, at most
# 2^-8 of |o|), at most ATTN_BF16_UPCAST_TOL abs, room for the rounding of P
# to bf16 (at most 2.6e-3 at the ATTN_CASES shapes on an H100, so about 2x
# that); and its RMS distance from that reference at most BF16_NOISE_FACTOR
# times the plain bf16 path's, which rounds its weights too.
BF16_HALF_ULP = 2.0 ** -8
ATTN_BF16_UPCAST_TOL = 5e-3
# (B, S, Hq, Hk, D, causal, window, dtypes): the training shape, the dense
# serving path's longest prefill (Minitron-8B's GQA heads at D=128), the MoE
# serving path's (Qwen-MoE's 16 heads, g = 1: one head x 64 tokens a block),
# Command R+'s g = 12 (12 heads x 5 tokens, 60 of 64 rows), a windowed,
# non-causal, ragged case at D=32, and RecurrentGemma's heads (MQA, g = 16:
# 4 tokens x 16 heads a block, D=256, window 2048) at the hybrid serving
# path's longest prefill and at the family's training length, where the
# window masks (the JAX package's own kernel route for it); Whisper's decoder
# (MHA, g = 1, D=64) at its training shape (S = 448, a ragged last tile of
# 64 tokens over 6 heads), and Qwen2-VL's heads (g = 8, D=128) at its
# training length
HYBRID_WINDOW = 2048
ATTN_CASES = (
    (4, 2048, 16, 16, 64, True, None, (torch.bfloat16,)),
    (1, 512, 32, 8, 128, True, None, (torch.float32, torch.bfloat16)),
    (1, 512, 16, 16, 128, True, None, (torch.float32, torch.bfloat16)),
    (1, 300, 96, 8, 128, True, None, (torch.float32, torch.bfloat16)),
    (1, 200, 4, 2, 32, False, 128, (torch.float32, torch.bfloat16)),
    (1, 512, 16, 1, 256, True, HYBRID_WINDOW, (torch.float32, torch.bfloat16)),
    (1, 4096, 16, 1, 256, True, HYBRID_WINDOW, (torch.float32, torch.bfloat16)),
    (8, 448, 6, 6, 64, True, None, (torch.float32, torch.bfloat16)),
    (1, 2048, 64, 8, 128, True, None, (torch.float32, torch.bfloat16)),
)
TRAIN_ARCH, TRAIN_B, TRAIN_S, TRAIN_STEPS = "qwen1.5-0.5b", 4, 2048, 6

DENSE_ARCH, SERVE_B, SERVE_C = "minitron-8b", 8, 1024
# Decode kernel against decode_attention_ref: the attention tolerances (the
# JAX sweep's 3e-2 in bf16; its 3e-5 in f32 widened to 1e-4 for the card's
# summation order).  (B, C, Hq, Hk, D, lengths): the serving shape with the
# lengths the first eight served prompts give at their first decode step
# and with every slot valid, D=64 MHA, and MQA with a ragged C (not a
# multiple of the 64-slot tile); lengths 1 and C; the MoE serving path's
# heads (g = 1, one head in the 16 mma rows), Command R+'s g = 12, and the
# hybrid serving path's (RecurrentGemma: MQA, g = 16 fills the 16 mma rows,
# D=256) served, full, and past its 2048-slot ring's wrap; Whisper's decoder
# (MHA, g = 1, D=64) over its 448-slot self cache, and the vlm serving path's
# (Qwen2-VL, g = 8) served.
SERVE_LENGTHS = tuple(n + 1 for n in SERVE_PROMPTS[:SERVE_B])
WHISPER_C = 448                    # Whisper's decoder context: its self cache
WHISPER_PROMPT, WHISPER_NEW = 4, 60
# the lengths of phase 12's last Whisper decode step, every row at its end
WHISPER_LENGTHS = (WHISPER_PROMPT + WHISPER_NEW,) * SERVE_B
DECODE_CASES = (
    (SERVE_B, SERVE_C, 32, 8, 128, SERVE_LENGTHS),
    (SERVE_B, SERVE_C, 32, 8, 128, (SERVE_C,) * SERVE_B),
    (SERVE_B, SERVE_C, 16, 16, 128, SERVE_LENGTHS),
    (SERVE_B, SERVE_C, 96, 8, 128, SERVE_LENGTHS),
    (4, 512, 16, 16, 64, (1, 512, 300, 77)),
    (3, 1000, 16, 1, 128, (1, 1000, 999)),
    (SERVE_B, SERVE_C, 16, 1, 256, SERVE_LENGTHS),
    (SERVE_B, SERVE_C, 16, 1, 256, (SERVE_C,) * SERVE_B),
    (1, HYBRID_WINDOW, 16, 1, 256, (HYBRID_WINDOW,)),
    (SERVE_B, WHISPER_C, 6, 6, 64, (1, 64, WHISPER_C, 200, 5, 300, 447, 33)),
    (SERVE_B, SERVE_C, 64, 8, 128, SERVE_LENGTHS),
)
# the decode kernel is timed over this many layers' caches in turn, so each
# launch finds its K and V outside the 50 MB L2 as a decode step does
DECODE_TIMING_LAYERS = 16
# The bf16 decode kernel also against decode_attention_ref on its inputs cast
# up to float32 (no rounding of the weights), abs: the kernel's roundings are
# then its bf16 weights (as the plain bf16 path rounds them) and its output.
DECODE_BF16_UPCAST_TOL = 1e-2
DECODE_CHECK_STEPS = 4
# Step 1 through the attention kernel against the same step through the
# plain attention, same weights and batch: in a float32 copy, loss and
# gradient norm within this relative tolerance (the kernel's f32 error, about
# 1e-6 of |o|, grown through 24 layers and a 151936-way softmax).
TRAIN_F32_RTOL = 1e-4


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def gpu_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return res.stdout.strip()


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean time of ``fn`` on the card over ``iters`` runs, by CUDA events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def wkv_inputs(B, T, dtype, gen, dev, strong_decay=False):
    """WKV inputs at the served model's heads; with ``strong_decay`` half the
    channels decay as w = exp(-exp(x + 2)), so the cumulative log-decay of a
    16-token sub-chunk falls below -87 and its exponential underflows in f32."""
    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)

    r, k, v = randn(B, T, H, N) * 0.5, randn(B, T, H, N) * 0.5, randn(B, T, H, N)
    w = torch.exp(-torch.exp(randn(B, T, H, N) - 2.0))      # decay in (0, 1)
    if strong_decay:
        w[..., : N // 2] = torch.exp(-torch.exp(randn(B, T, H, N // 2) + 2.0))
    return dict(r=r.to(dtype), k=k.to(dtype), v=v.to(dtype), w=w,
                u=randn(H, N) * 0.2, S0=randn(B, H, N, N) * 0.1)


def wkv_bound(T: int, chunk: int):
    """``(bound ms, bound_by, line)`` of the bf16 WKV scan at B=1: the larger
    of its bytes over the memory rate and its operations over their rates,
    SIMT at the f32 peak and the products at the TF32 peak, the larger of
    the two (the pipes run side by side)."""
    nbytes, simt, prod = wkv_cost(1, T, H, N, 2, chunk)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(simt / F32_OPS_PER_S, prod / TF32_OPS_PER_S) * 1e3
    line = (f"{nbytes} bytes -> {t_bytes:.4f} ms, {simt} f32 SIMT ops -> "
            f"{simt / F32_OPS_PER_S * 1e3:.4f} ms, {prod} TF32 product ops -> "
            f"{prod / TF32_OPS_PER_S * 1e3:.4f} ms")
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations", line


def pass_name(kernel: str) -> str:
    """``state``, ``carry`` or ``output`` for a WKV pass's kernel name."""
    m = re.search(r"rwkv6_(\w+?)_kernel", kernel)
    return m.group(1) if m else kernel[:60]


def split_phase(dev):
    """The head backward's split (``csrc/bf16_split.cu``) against its plain
    version, bit for bit: on a 10,880-column block of a cross-entropy
    cotangent at the train cell's shape (16,384 tokens over Qwen1.5-0.5B's
    151,936 columns: the block the backward splits), on values of every
    float32 exponent from 2^-100 to 2^100, and on rows of an odd length (the
    kernel's one-element path); then that block's time (CUDA events over 20
    launches) against its bound, 10 bytes an element at 3.35 TB/s."""
    gen = torch.Generator(device=dev).manual_seed(2)
    T, V, n = 16384, 151936, 10880
    g = torch.softmax(6.0 * torch.randn(T, V, generator=gen, device=dev), dim=-1)
    g[torch.arange(T, device=dev), torch.randint(0, V, (T,), generator=gen, device=dev)] -= 1.0
    sig = torch.randint(1 << 23, 1 << 24, (512, 1004), generator=gen, device=dev).double()
    exp = torch.randint(-100, 101, (512, 1004), generator=gen, device=dev) - 23
    wide = (torch.ldexp(sig, exp.double()) * (2 * torch.randint(0, 2, sig.shape, generator=gen,
                                                                 device=dev) - 1)).float()
    for name, x in (("cotangent block", g[:, 3 * n:4 * n]), ("wide exponents", wide),
                    ("wide exponents, odd rows", wide[:, 1:])):
        got = bf16_split(x)
        torch.cuda.synchronize()
        check(torch.equal(got, bf16_split_ref(x)), f"bf16_split differs from its plain "
              f"version on the {name}")
        check(bool((got.double().sum(dim=1) == x.double()).all()),
              f"bf16_split's pieces do not sum to the {name}")
    blk = g[:, :n]
    bf16_split(blk)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(20):
        bf16_split(blk)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / 20
    bound_ms = 10 * blk.numel() / HBM_BYTES_PER_S * 1e3
    print(f"[kernels] bf16_split: bit for bit with its plain version and exact on a "
          f"cotangent block ({T} x {n} of {V}), on exponents 2^-100..2^100 and on odd rows; "
          f"the block {ms:.4f} ms against its bound {bound_ms:.4f} ms (bytes: "
          f"{10 * blk.numel():,} at 3.35 TB/s), {100 * bound_ms / ms:.1f}% of it", flush=True)
    del g, blk
    torch.cuda.empty_cache()


def kernel_phase(dev):
    """The WKV kernel against its plain version at the main path's shapes
    (the bf16 kernel also against the plain version on its inputs cast up
    to float32), then its times at 128, 200 and 512 tokens."""
    gen = torch.Generator(device=dev).manual_seed(1)
    worst = 0.0
    cases = [(B, T, False) for B in (1, 8) for T in (64, 128, 80, 512)] + [(1, 512, True)]
    for B, T, strong in cases:
        for dtype in (torch.float32, torch.bfloat16):
            inp = wkv_inputs(B, T, dtype, gen, dev, strong_decay=strong)
            if strong:
                sub = float(torch.log(inp["w"][:, :16, :, : N // 2]).sum(1).min())
                check(sub < -87, f"strong decay: a sub-chunk's log-decay {sub:.1f} >= -87")
            y, s = rwkv6_scan(**inp)
            torch.cuda.synchronize()
            yr, sr = rwkv6_ref(**inp)
            tol = KERNEL_TOL[dtype]
            errs = []
            for got, want in ((y, yr), (s, sr)):
                got, want = got.float(), want.float()
                check(bool(torch.isfinite(got).all()), f"non-finite output B={B} T={T}")
                over = (got - want).abs() - (tol + tol * want.abs())
                errs.append(float((got - want).abs().max()))
                check(float(over.max()) <= 0, f"kernel disagrees B={B} T={T} {dtype}: "
                      f"max abs err {errs[-1]:.3e} beyond {tol} abs+rel")
            worst = max(worst, *errs)
            upcast = ""
            if dtype == torch.bfloat16:
                yu, su = rwkv6_ref(**{**inp, **{key: inp[key].float() for key in "rkv"}})
                scale = float(yu.abs().max())
                beyond = float(((y.float() - yu).abs() - BF16_HALF_ULP * yu.abs()).max())
                tol32 = KERNEL_TOL[torch.float32]
                s_over = float(((s - su).abs() - (tol32 + tol32 * su.abs())).max())
                case = f"B={B} T={T}{' strong decay' if strong else ''}"
                check(beyond <= WKV_BF16_UPCAST_TOL * scale,
                      f"bf16 WKV kernel {case}: y is {beyond:.3e} beyond its rounding from "
                      f"the float32 plain version, beyond {WKV_BF16_UPCAST_TOL} of max |y| "
                      f"{scale:.3f}")
                check(s_over <= 0, f"bf16 WKV kernel {case}: S_T beyond {tol32} abs+rel of "
                      f"the float32 plain version")
                upcast = (f"; against the float32 plain version on these inputs y "
                          f"{beyond:.3e} beyond 2^-8 of |y| = {beyond / scale:.3e} of max |y| "
                          f"{scale:.3f} (tol {WKV_BF16_UPCAST_TOL} of it), S_T "
                          f"{float((s - su).abs().max()):.3e} (tol {tol32} abs+rel)")
                del yu, su
            print(f"[kernels] rwkv6_scan B={B} T={T} {str(dtype)[6:]}"
                  f"{' strong decay' if strong else ''}: max abs err y {errs[0]:.3e}, "
                  f"S_T {errs[1]:.3e} (tol {tol} abs+rel){upcast}", flush=True)
    timing, chunk = {}, kernel_chunk()
    check(chunk == wkv_tiling()[0], f"the built WKV kernel's chunk {chunk} differs from the "
          f"{wkv_tiling()[0]} that kernels/meta.py reads from its source")
    for T in (128, 200, 512):
        inp = wkv_inputs(1, T, torch.bfloat16, gen, dev)
        call = lambda: rwkv6_scan(**inp)   # noqa: E731
        per_call = kernels_per_call(call)
        check(per_call == WKV_KERNELS_PER_CALL,
              f"one rwkv6_scan call ran {per_call} kernels on the card, not "
              f"{WKV_KERNELS_PER_CALL}")
        # a call's device time, its passes and the gaps between them, with
        # the host's launch rate out of the way; and by pass
        ms = graph_ms(call, calls=20)
        passes = device_times(call, iters=50)
        by_pass = ", ".join(f"{pass_name(name)} {t:.4f} ms" for name, t in passes.items())
        plain_ms = time_ms(lambda: rwkv6_ref(**inp), iters=3, warmup=1)
        bound, bound_by, cost = wkv_bound(T, chunk)
        us = host_us(call, ATTN_HOST_CALLS)
        timing[T] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, host_us=us,
                         bound_by=bound_by, kernels_per_call=per_call)
        print(f"[kernels] rwkv6_scan B=1 T={T} H={H} N={N} bf16, {per_call} kernels on the "
              f"card a call: {ms:.4f} ms a call (CUDA graph of 20 calls, by CUDA events; "
              f"kernel time by pass: {by_pass}; gaps {ms - sum(passes.values()):.4f} ms), "
              f"host {us:.2f} us a call; plain version {plain_ms:.3f} ms; bound {bound:.4f} ms "
              f"({cost}; counted at the kernel's {chunk}-token chunks), "
              f"{100 * bound / ms:.1f}% of bound", flush=True)
    return worst, timing


def serve_requests_for(cfg):
    """The served requests: prompts of SERVE_PROMPTS tokens drawn from seed
    0 over the model's vocabulary, SERVE_NEW_TOKENS new tokens each."""
    rng = np.random.default_rng(0)
    return [(f"req{i}", rng.integers(0, cfg.vocab, n).tolist(), m)
            for i, (n, m) in enumerate(zip(SERVE_PROMPTS, SERVE_NEW_TOKENS))]


def serve(engine, requests):
    """Admit requests as slots free up and step until all have finished,
    each prefill and step timed on the host clock after a synchronise.
    Returns ``(done, prefill seconds, step seconds, wall seconds)``."""
    pending, done = list(requests), {}
    prefill_s, step_s = [], []
    t_start = time.perf_counter()
    while len(done) < len(requests):
        while pending and engine.free_slots():
            t = time.perf_counter()
            engine.add_request(*pending.pop(0))
            torch.cuda.synchronize()
            prefill_s.append(time.perf_counter() - t)
        t = time.perf_counter()
        done.update(engine.step())
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
    return done, prefill_s, step_s, time.perf_counter() - t_start


def report_serve(tag, cfg, requests, done, prefill_s, step_s, wall, batch=SERVE_B):
    """Check that every request got its tokens, each a valid id, and print
    the served set's times."""
    for rid, prompt, n_new in requests:
        toks = done[rid]
        check(len(toks) == n_new + 1, f"{rid}: {len(toks)} tokens, wanted {n_new + 1}")
        check(all(0 <= t < cfg.vocab for t in toks), f"{rid}: token id out of range")
    n_tok = sum(len(t) for t in done.values())
    prompts = [len(prompt) for _, prompt, _ in requests]
    print(f"[{tag}] {len(requests)} requests (prompts {prompts}), "
          f"{n_tok} tokens in {wall:.3f} s = {n_tok / wall:.1f} tok/s, "
          f"{len(step_s)} decode steps at batch {batch}", flush=True)
    print(f"[{tag}] prefill ms per request: median {1e3 * np.median(prefill_s):.2f}, "
          f"by prompt length (in order, the first one cold) "
          f"{[(n, round(1e3 * x, 2)) for n, x in zip(prompts, prefill_s)]}", flush=True)
    print(f"[{tag}] decode step ms: median {1e3 * np.median(step_s):.2f}, "
          f"min {1e3 * min(step_s):.2f}, max {1e3 * max(step_s):.2f}", flush=True)


def serve_phase(dev):
    cfg = get_config("rwkv6-3b")
    model = LM(cfg, device=dev)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"[serve] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads of {cfg.recurrent.head_size}, d_ff {cfg.d_ff}, "
          f"vocab {cfg.vocab}, {cfg.dtype}; {n_params} parameters, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB, "
          f"init {time.perf_counter() - t0:.1f} s", flush=True)

    requests = serve_requests_for(cfg)
    engine = ServingEngine(model, params, max_batch=8, max_seq=1024)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    rwkv6_scan.launches = 0
    done, prefill_s, step_s, wall = serve(engine, requests)
    launches = rwkv6_scan.launches

    check(launches == cfg.n_layers * len(requests),
          f"rwkv6_scan launched {launches} times for {len(requests)} prefills "
          f"of {cfg.n_layers} layers")
    report_serve("serve", cfg, requests, done, prefill_s, step_s, wall)
    print(f"[serve] rwkv6_scan launches {launches} = {cfg.n_layers} layers x "
          f"{len(requests)} prefills; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)

    rid, prompt, _ = requests[3]
    lg = prefill_check("serve", model, params, prompt, "WKV kernel vs plain WKV",
                       mix_fn=rwkv6_ref)
    check(int(lg.argmax()) == done[rid][0], "prefill is not deterministic")
    longest = max(requests, key=lambda req: len(req[1]))
    engine = ServingEngine(model, params, max_batch=8, max_seq=1024)
    engine.add_request(*longest)
    profile_report("serve", lambda: engine.add_request(f"{longest[0]}-again", *longest[1:]))
    del engine
    return model, params, launches


def hold_logits(tag, what, kern16, plain16, kern32, plain32):
    """A kernel path's logits held against the plain path's, in float32 and
    in bf16.

    In float32 (the same weights cast up) the two must agree to
    LOGITS_F32_TOL of max |logit|.  In bf16 both paths round every
    activation, and 32 layers of random weights amplify a one-ulp difference
    into visible logit differences, so the kernel's bf16 logits are held
    against the float32 plain logits: their RMS distance may be at most
    BF16_NOISE_FACTOR times the plain bf16 path's own RMS distance from
    them."""
    for name, lg in (("bf16", kern16), ("float32", kern32)):
        check(bool(torch.isfinite(lg).all()), f"non-finite {name} logits: {what}")

    def rms(a, b):
        return float((a - b).square().mean().sqrt())

    def agree(a, b):
        return float((a.argmax(-1) == b.argmax(-1)).float().mean())

    scale32 = float(plain32.abs().max())
    err32 = float((kern32 - plain32).abs().max())
    rms_kern, rms_plain = rms(kern16, plain32), rms(plain16, plain32)
    print(f"[{tag}] {what}: float32 max abs diff {err32:.4e} (max |logit| {scale32:.4f}, "
          f"tol {LOGITS_F32_TOL} of it); bf16 max abs diff "
          f"{float((kern16 - plain16).abs().max()):.4e}; RMS from float32 plain: kernel bf16 "
          f"{rms_kern:.4e}, plain bf16 {rms_plain:.4e} (tol {BF16_NOISE_FACTOR}x); greedy "
          f"tokens of kernel bf16 agree with plain bf16 {agree(kern16, plain16):.3f}, with "
          f"plain float32 {agree(kern16, plain32):.3f}", flush=True)
    check(err32 <= LOGITS_F32_TOL * scale32,
          f"float32 logits differ by {err32:.4e}, beyond {LOGITS_F32_TOL} x {scale32:.4f}: {what}")
    check(rms_kern <= BF16_NOISE_FACTOR * rms_plain,
          f"bf16 logits are {rms_kern:.4e} RMS from float32, beyond {BF16_NOISE_FACTOR} x "
          f"the plain path's {rms_plain:.4e}: {what}")


def prefill_check(tag, model, params, prompt, what, **plain):
    """One prompt's prefill logits through the kernels, held against the
    same prefill through the plain versions that ``plain`` hands to ``LM``
    (``mix_fn=rwkv6_ref``, ``attn_fn=attention_ref``) by ``hold_logits``.
    Returns the kernels' bf16 logits."""
    cfg, dev = model.cfg, model.device
    tokens = torch.tensor([prompt], device=dev)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params32 = _tree_map(lambda t: t.float(), params)

    def prefill(c, p, hooks):
        m = LM(c, device=dev, **hooks)
        with torch.inference_mode():
            lg, _ = m.prefill(p, {"tokens": tokens}, m.init_cache(1, len(prompt)))
        return lg.float()

    kern16, plain16 = prefill(cfg, params, {}), prefill(cfg, params, plain)
    kern32, plain32 = prefill(cfg32, params32, {}), prefill(cfg32, params32, plain)
    del params32
    torch.cuda.empty_cache()
    hold_logits(tag, f"prefill logits, {len(prompt)} tokens, {what}",
                kern16, plain16, kern32, plain32)
    return kern16


def fit_phase(tag, model, params, prefill_kernels=(), step_kernels=(), per_call=None):
    """Fit ``T = m*k + c`` with ``measure_interference`` and check that each
    probe prefill launched every kernel of ``prefill_kernels`` and each
    probe step every kernel of ``step_kernels`` ``per_call`` times (once a
    layer unless given)."""
    sizes, warmup, iters = (1, 2, 4, 8), 3, 10
    for kern in (*prefill_kernels, *step_kernels):
        kern.launches = 0
    m, c, r2, samples = measure_interference(
        model, params, batch_sizes=sizes, max_seq=SERVE_C, iters=iters, warmup=warmup)
    n = per_call or model.cfg.n_layers
    for kern, calls, what in ([(k, sum(sizes), "probe prefills") for k in prefill_kernels]
                              + [(k, len(sizes) * (warmup + iters), "probe steps")
                                 for k in step_kernels]):
        check(kern.launches == n * calls,
              f"{kern.__name__} launched {kern.launches} times for {calls} {what}")
    check(bool(np.isfinite([m, c, r2]).all()), "non-finite interference fit")
    print(f"[{tag}] decode-step latency T = m*k + c: m={m * 1e3:.4f} ms/seq, "
          f"c={c * 1e3:.4f} ms, R^2={r2:.4f}", flush=True)
    for k, dt in samples:
        print(f"[{tag}]   k={k}: {dt * 1e3:.3f} ms (fit {(m * k + c) * 1e3:.3f} ms)", flush=True)
    return m, c, r2


def dense_phase(dev):
    """Serve the requests on full-width Minitron-8B with a KV cache; then the
    prefill and decode checks, the interference fit and a profiled decode
    step on the same model.  Returns the attention and the decode kernel's
    launches in the served set and the fit ``(m, c, r2)``."""
    cfg = get_config(DENSE_ARCH)
    model = LM(cfg, device=dev)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"[dense] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads of {cfg.head_dim} ({cfg.n_kv_heads} kv), d_ff {cfg.d_ff}, "
          f"vocab {cfg.vocab}, {cfg.dtype}; {n_params} parameters, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB, "
          f"init {time.perf_counter() - t0:.1f} s", flush=True)

    requests = serve_requests_for(cfg)
    engine = ServingEngine(model, params, max_batch=SERVE_B, max_seq=SERVE_C)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    flash_attention.launches = flash_decode.launches = rwkv6_scan.launches = 0
    flash_attention.wgmma_launches = flash_attention.simt_launches = 0
    done, prefill_s, step_s, wall = serve(engine, requests)
    attn_launches, launches = flash_attention.launches, flash_decode.launches
    peak = torch.cuda.max_memory_allocated()

    check(attn_launches == cfg.n_layers * len(requests),
          f"flash_attention launched {attn_launches} times for {len(requests)} prefills "
          f"of {cfg.n_layers} layers")
    check(flash_attention.wgmma_launches == attn_launches and flash_attention.simt_launches == 0,
          f"of {attn_launches} bf16 attention launches {flash_attention.wgmma_launches} went "
          f"through the tensor-core kernel, {flash_attention.simt_launches} the SIMT kernel")
    check(launches == cfg.n_layers * len(step_s),
          f"flash_decode launched {launches} times for {len(step_s)} decode steps "
          f"of {cfg.n_layers} layers")
    check(rwkv6_scan.launches == 0, "the dense serving path launched the WKV kernel")
    report_serve("dense", cfg, requests, done, prefill_s, step_s, wall)
    print(f"[dense] flash_attention launches {attn_launches} = {cfg.n_layers} layers x "
          f"{len(requests)} prefills, all through the tensor-core kernel; flash_decode launches {launches} = {cfg.n_layers} "
          f"layers x {len(step_s)} decode steps; peak memory {peak / 2**30:.2f} GiB", flush=True)
    del engine
    torch.cuda.empty_cache()

    rid, prompt, _ = requests[4]
    lg = prefill_check("dense", model, params, prompt,
                       "attention kernel vs plain attention", attn_fn=attention_ref)
    check(int(lg.argmax()) == done[rid][0], "prefill is not deterministic")
    decode_check(model, params, requests, done)
    fit = fit_phase("dense", model, params, (flash_attention,), (flash_decode,))
    engine = ServingEngine(model, params, max_batch=SERVE_B, max_seq=SERVE_C)
    for req in requests[:SERVE_B]:
        engine.add_request(*req)
    engine.step()
    profile_report("dense", engine.step)
    del engine
    torch.cuda.empty_cache()
    float8 = float8_serve(model, params, requests, done, step_s, peak)
    return (attn_launches, launches), fit, float8


def float8_serve(model, params, requests, done16, step16_s, peak16):
    """Phase 6's second engine: the same weights and requests with
    ``kv_dtype="float8_e4m3fn"``.  Checks every decode step ran the decode
    kernel once a layer on float8 K/V, on the engine's cache itself (no
    widened copy on the path), the tokens, and a few decode steps' logits
    against the plain route on the same float8 cache; reports greedy
    agreement with the bf16-cache engine, the step median and peak memory
    beside the bf16 engine's.  Returns the ``dense_float8`` line and the
    float8 launches."""
    tag, dev = "dense float8", model.device
    cfg = dataclasses.replace(model.cfg, kv_dtype="float8_e4m3fn")
    model8 = LM(cfg, device=dev)
    engine = ServingEngine(model8, params, max_batch=SERVE_B, max_seq=SERVE_C)
    check(all(c[key].dtype == FLOAT8_KV for c in engine.caches for key in ("k", "v")),
          "the float8 engine's cache is not float8")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    flash_attention.launches = flash_decode.launches = 0
    flash_decode.kind_launches.clear()
    done, prefill_s, step_s, wall = serve(engine, requests)
    attn_launches, launches = flash_attention.launches, flash_decode.launches
    launches8 = flash_decode.kind_launches.get((torch_dtype(cfg.dtype), FLOAT8_KV), 0)
    peak = torch.cuda.max_memory_allocated()
    check(attn_launches == cfg.n_layers * len(requests),
          f"flash_attention launched {attn_launches} times for {len(requests)} prefills")
    check(launches == launches8 == cfg.n_layers * len(step_s),
          f"flash_decode launched {launches} times ({launches8} on float8 K/V) for "
          f"{len(step_s)} decode steps of {cfg.n_layers} layers")
    report_serve(tag, cfg, requests, done, prefill_s, step_s, wall)
    same = [a == b for rid, _, _ in requests for a, b in zip(done[rid], done16[rid])]
    agree = float(np.mean(same))
    step_ms, step16_ms = 1e3 * float(np.median(step_s)), 1e3 * float(np.median(step16_s))
    print(f"[{tag}] flash_decode launches {launches} = {cfg.n_layers} layers x {len(step_s)} "
          f"decode steps, all on float8 K/V; greedy tokens equal to the bf16-cache engine's "
          f"{agree:.3f} ({sum(same)} of {len(same)}); decode step median {step_ms:.2f} ms "
          f"(bf16 cache {step16_ms:.2f}); peak memory {peak / 2**30:.2f} GiB (bf16 cache "
          f"{peak16 / 2**30:.2f})", flush=True)

    # the decode kernel reads the engine's float8 cache itself: each layer's
    # call gets that layer's slice of the stacked cache, not a widened copy
    seen = []

    def recorder(q, k, v, lengths):
        seen.append((k.dtype, v.dtype, k.data_ptr(), v.data_ptr()))
        return flash_decode(q, k, v, lengths)

    engine.model = LM(cfg, device=dev, decode_fn=recorder)
    engine.add_request(*requests[0])
    engine.step()
    (cache,) = engine.caches
    want = [(FLOAT8_KV, FLOAT8_KV, cache["k"][i].data_ptr(), cache["v"][i].data_ptr())
            for i in range(cfg.n_layers)]
    check(seen == want, "a decode step's kernel calls did not read the engine's float8 cache")
    print(f"[{tag}] a decode step's {len(seen)} kernel calls each read its layer's float8 "
          f"slice of the engine's cache (no widened copy)", flush=True)
    del engine
    torch.cuda.empty_cache()
    decode_check(model8, params, requests, done, tag)
    line = {"dense_float8": {
        "arch": cfg.name, "kv_dtype": cfg.kv_dtype, "prefill_ms": [1e3 * x for x in prefill_s],
        "step_ms_median": step_ms, "bf16_cache_step_ms_median": step16_ms,
        "steps": len(step_s), "tokens_per_s": sum(len(t) for t in done.values()) / wall,
        "peak_gib": peak / 2**30, "bf16_cache_peak_gib": peak16 / 2**30,
        "greedy_agreement_with_bf16_cache": agree,
        "launches": {"flash_attention": attn_launches, "flash_decode": launches,
                     "flash_decode_float8": launches8}}}
    return line, launches8


def decode_check(model, params, requests, done, tag="dense"):
    """A few decode steps from one prefilled cache through the decode kernel,
    held against the same steps through the plain decode attention.

    The first SERVE_B requests are prefilled into one engine; from a copy
    of its cache each path runs DECODE_CHECK_STEPS steps on the same tokens
    (the prefill's greedy tokens, then tokens drawn from a seed), held by
    ``hold_logits`` with the float32 paths' weights and cache cast up (a
    float8 cache stays float8: the float32 paths read it as it is)."""
    cfg, dev = model.cfg, model.device
    engine = ServingEngine(model, params, max_batch=SERVE_B, max_seq=SERVE_C)
    for req in requests[:SERVE_B]:
        engine.add_request(*req)
    check(engine.tokens.tolist() == [done[rid][0] for rid, _, _ in requests[:SERVE_B]],
          "prefill is not deterministic")
    rng = np.random.default_rng(3)
    feed = [engine.tokens.clone()] + [
        torch.as_tensor(rng.integers(0, cfg.vocab, SERVE_B), device=dev)
        for _ in range(DECODE_CHECK_STEPS - 1)]
    pos0, caches0 = engine.pos.clone(), engine.caches
    del engine

    def decode(c, p, decode_fn):
        m = LM(c, device=dev, decode_fn=decode_fn)
        dt = torch_dtype(c.dtype)
        caches = _tree_map(lambda t: t.to(dt, copy=True) if t.is_floating_point()
                           and t.dtype not in FLOAT8 else t.clone(), caches0)
        out = []
        with torch.inference_mode():
            for t in range(DECODE_CHECK_STEPS):
                lg, caches = m.decode_step(p, feed[t], pos0 + t, caches)
                out.append(lg.float())
        return torch.stack(out)

    kern16, plain16 = decode(cfg, params, None), decode(cfg, params, decode_attention_ref)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params32 = _tree_map(lambda t: t.float(), params)
    kern32 = decode(cfg32, params32, None)
    plain32 = decode(cfg32, params32, decode_attention_ref)
    del params32, caches0
    torch.cuda.empty_cache()
    hold_logits(tag, f"decode logits, {DECODE_CHECK_STEPS} steps at batch {SERVE_B}, "
                "decode kernel vs plain decode attention", kern16, plain16, kern32, plain32)


# The attention kernel is timed at the training shape and at the dense
# serving path's longest prefill (Minitron-8B's GQA heads), the latter over
# this many copies of its inputs in turn so each launch finds them outside
# the 50 MB L2, as a prefill does (the training shape's 67 MB exceed L2).
# The training shape is timed by CUDA events over back-to-back launches; the
# dense prefill shape, whose kernel takes less time than a call takes on the
# host, by the device time torch.profiler sees (device_ms).
# (name, B, S, Hq, Hk, D, window, copies, clock)
ATTN_TIMED = (("train", TRAIN_B, TRAIN_S, 16, 16, 64, None, 1, "events"),
              ("dense prefill", 1, 512, 32, 8, 128, None, 8, "device"),
              ("moe prefill", 1, 512, 16, 16, 128, None, 8, "device"),
              ("hybrid prefill", 1, 512, 16, 1, 256, HYBRID_WINDOW, 8, "device"),
              ("hybrid train", 1, 4096, 16, 1, 256, HYBRID_WINDOW, 1, "events"),
              ("whisper train", 8, WHISPER_C, 6, 6, 64, None, 8, "device"),
              ("vlm train", 1, 2048, 64, 8, 128, None, 1, "events"),
              ("vlm prefill", 1, 512, 64, 8, 128, None, 8, "device"))
# the host's time per call is measured over this many back-to-back calls
ATTN_HOST_CALLS = 200


def host_us(fn, calls: int) -> float:
    """The host's time per call of ``fn`` over ``calls`` back-to-back calls,
    not waiting for the card (the launch queue holds them all)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t) / calls * 1e6
    torch.cuda.synchronize()
    return us


def attention_phase(dev):
    """The attention kernel against attention_ref, then its times at the
    training shape and the dense prefill shape beside the plain version's
    and the library call's, and the host's time per call at the dense
    prefill shape.  Returns the worst error and ``{shape name: timing}``."""
    gen = torch.Generator(device=dev).manual_seed(2)
    worst = 0.0
    for B, S, Hq, Hk, D, causal, window, dtypes in ATTN_CASES:
        for dtype in dtypes:
            q = torch.randn((B, S, Hq, D), generator=gen, device=dev).to(dtype)
            k = torch.randn((B, S, Hk, D), generator=gen, device=dev).to(dtype)
            v = torch.randn((B, S, Hk, D), generator=gen, device=dev).to(dtype)
            out = flash_attention(q, k, v, causal=causal, window=window)
            torch.cuda.synchronize()
            ref = attention_ref(q, k, v, causal=causal, window=window)
            got, want = out.float(), ref.float()
            check(bool(torch.isfinite(got).all()), f"non-finite attention output S={S}")
            tol = ATTN_TOL[dtype]
            err = float((got - want).abs().max())
            over = float(((got - want).abs() - (tol + tol * want.abs())).max())
            check(over <= 0, f"attention kernel disagrees B={B} S={S} Hq={Hq} Hk={Hk} D={D} "
                  f"causal={causal} window={window} {dtype}: max abs err {err:.3e} "
                  f"beyond {tol} abs+rel")
            worst = max(worst, err)
            upcast = ""
            if dtype == torch.bfloat16:
                up = attention_ref(q.float(), k.float(), v.float(), causal=causal,
                                   window=window)
                beyond = float(((got - up).abs() - BF16_HALF_ULP * up.abs()).max())
                rms_kern = float((got - up).square().mean().sqrt())
                rms_plain = float((want - up).square().mean().sqrt())
                case = f"B={B} S={S} Hq={Hq} Hk={Hk} D={D} causal={causal} window={window}"
                check(beyond <= ATTN_BF16_UPCAST_TOL,
                      f"bf16 attention kernel {case} is {beyond:.3e} beyond its output's "
                      f"rounding from the float32 plain version, beyond {ATTN_BF16_UPCAST_TOL}")
                check(rms_kern <= BF16_NOISE_FACTOR * rms_plain,
                      f"bf16 attention kernel {case}: RMS distance {rms_kern:.3e} from the "
                      f"float32 plain version, beyond {BF16_NOISE_FACTOR}x the plain bf16 "
                      f"path's {rms_plain:.3e}")
                upcast = (f"; against the float32 plain version on these inputs "
                          f"{beyond:.3e} beyond 2^-8 of |o| (tol {ATTN_BF16_UPCAST_TOL} abs), "
                          f"RMS {rms_kern:.3e} vs the plain bf16 path's {rms_plain:.3e} "
                          f"(tol {BF16_NOISE_FACTOR}x)")
                del up
            print(f"[kernels] flash_attention B={B} S={S} Hq={Hq} Hk={Hk} D={D} "
                  f"causal={causal} window={window} {str(dtype)[6:]}: max abs err "
                  f"{err:.3e} (tol {tol} abs+rel){upcast}", flush=True)

    sdpa = torch.nn.functional.scaled_dot_product_attention
    timing = {}
    for name, B, S, Hq, Hk, D, window, n, clock in ATTN_TIMED:
        q, k, v = (torch.randn((n, B, S, H_, D), generator=gen, device=dev).to(torch.bfloat16)
                   for H_ in (Hq, Hk, Hk))
        qt, kt, vt = (t.transpose(2, 3).contiguous() for t in (q, k, v))   # (n, B, H, S, D)
        timer = time_ms if clock == "events" else device_ms
        iters = 20 * n
        # the library call: causal, or a causal band where the window masks
        if window is not None and window < S:
            pos = torch.arange(S, device=dev)
            band = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - window)
            lib_kw = dict(attn_mask=band, enable_gqa=Hq != Hk)
        else:
            lib_kw = dict(is_causal=True, enable_gqa=Hq != Hk)
        per_call = kernels_per_call(lambda: flash_attention(q[0], k[0], v[0], causal=True,
                                                            window=window))
        check(per_call == 1, f"one flash_attention call ran {per_call} kernels on the card")
        ms = timer(layers(lambda i: flash_attention(q[i], k[i], v[i], causal=True,
                                                    window=window), n), iters)
        plan = tile_plan(B, S, Hq, Hk, D, window=window)
        plain_ms = timer(layers(lambda i: attention_ref(q[i], k[i], v[i], causal=True,
                                                        window=window), n),
                         iters=3, warmup=1)
        library_ms = timer(layers(lambda i: sdpa(qt[i], kt[i], vt[i], **lib_kw), n), iters)
        lib_err = float((sdpa(qt[0], kt[0], vt[0], **lib_kw).transpose(1, 2).float()
                         - attention_ref(q[0], k[0], v[0], causal=True, window=window).float()
                         ).abs().max())
        ops, nbytes = attention_work(B, S, Hq, Hk, D, 2, window=window)
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / BF16_OPS_PER_S * 1e3
        bound = max(t_bytes, t_ops)
        timing[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound,
                            bound_by="bytes" if t_bytes >= t_ops else "operations",
                            kernels_per_call=per_call, kv_l2_bytes=plan["kv_l2_bytes"])
        print(f"[kernels] flash_attention {name} shape B={B} S={S} Hq={Hq} Hk={Hk} D={D} "
              f"causal window={window} bf16, {per_call} kernel on the card a call, {clock} time "
              f"({plan['blocks']} blocks of {plan['tokens_per_block']} tokens x "
              f"{plan['heads_per_block']} heads): {ms:.4f} ms; "
              f"plain version {plain_ms:.3f} ms; scaled_dot_product_attention "
              f"{library_ms:.4f} ms (max abs diff from the plain version {lib_err:.3e}); bound "
              f"{bound:.4f} ms ({nbytes} bytes -> {t_bytes:.4f} ms, {ops} bf16 ops -> "
              f"{t_ops:.4f} ms), {100 * bound / ms:.2f}% of bound; {ops / ms / 1e9:.1f} TFLOP/s; "
              f"the plan's K/V bytes from L2 {plan['kv_l2_bytes']}, "
              f"{plan['kv_l2_bytes'] / ms / 1e9:.2f} TB/s", flush=True)
        if name == "dense prefill":
            # the bf16 call encodes three tensor maps on the host; the f32 call
            # of the same shape encodes none
            host = {}
            for dtype in (torch.bfloat16, torch.float32):
                q1, k1, v1 = (t[0].to(dtype) for t in (q, k, v))
                host[dtype] = host_us(lambda: flash_attention(q1, k1, v1, causal=True),
                                      ATTN_HOST_CALLS)
            bf16_us, f32_us = host[torch.bfloat16], host[torch.float32]
            print(f"[kernels] flash_attention {name} shape, host time per call over "
                  f"{ATTN_HOST_CALLS} back-to-back calls: bf16 {bf16_us:.2f} us, f32 "
                  f"{f32_us:.2f} us (the bf16 call's tensor maps and alignment check "
                  f"{bf16_us - f32_us:.2f} us)", flush=True)
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()
    timing["f32 dense prefill"] = f32_attention_timing(dev, gen)
    return worst, timing


def f32_attention_timing(dev, gen):
    """The f32 SIMT attention kernel at the dense serving path's longest
    prefill (B=1, S=512, Hq=32, Hk=8, D=128; the float32 Minitron-8B's
    prefill), device time over 8 copies of its inputs, beside the plain
    version and SDPA in f32 (TF32 off); its bound from 4-byte elements and
    the f32 peak outside the tensor cores."""
    B, S, Hq, Hk, D, n = 1, 512, 32, 8, 128, 8
    q, k, v = (torch.randn((n, B, S, H_, D), generator=gen, device=dev) for H_ in (Hq, Hk, Hk))
    qt, kt, vt = (t.transpose(2, 3).contiguous() for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    call = lambda: flash_attention(q[0], k[0], v[0], causal=True)   # noqa: E731
    per_call = kernels_per_call(call)
    check(per_call == 1, f"one f32 flash_attention call ran {per_call} kernels on the card")
    ms = device_ms(layers(lambda i: flash_attention(q[i], k[i], v[i], causal=True), n), 20 * n)
    plain_ms = device_ms(layers(lambda i: attention_ref(q[i], k[i], v[i], causal=True), n),
                         iters=3, warmup=1)
    library_ms = device_ms(layers(lambda i: sdpa(qt[i], kt[i], vt[i], is_causal=True,
                                                 enable_gqa=True), n), 20 * n)
    ops, nbytes = attention_work(B, S, Hq, Hk, D, 4)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    bound = max(t_bytes, t_ops)
    print(f"[kernels] flash_attention f32 dense prefill shape B={B} S={S} Hq={Hq} Hk={Hk} "
          f"D={D} causal f32 (the SIMT kernel), {per_call} kernel on the card a call, device "
          f"time: {ms:.4f} ms; plain version {plain_ms:.3f} ms; scaled_dot_product_attention "
          f"in f32 {library_ms:.4f} ms; bound {bound:.4f} ms ({nbytes} bytes -> {t_bytes:.4f} "
          f"ms, {ops} f32 ops at the f32 peak outside the tensor cores, no TF32 -> "
          f"{t_ops:.4f} ms), {100 * bound / ms:.2f}% of bound", flush=True)
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound,
                bound_by="bytes" if t_bytes >= t_ops else "operations", kernels_per_call=per_call)


def ptxas_report(report):
    """``(kernel, registers, spill stores, spill loads)`` for each entry
    function in an ``nvcc -Xptxas -v`` report, names demangled where
    ``c++filt`` is present."""
    rows, name, spills = [], None, (0, 0)
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            rows.append((name, int(m.group(1)), *spills))
            name, spills = None, (0, 0)
    try:
        names = subprocess.run(["c++filt"], input="\n".join(r[0] for r in rows),
                               capture_output=True, text=True, timeout=60,
                               check=True).stdout.splitlines()
        rows = [(n.replace("(anonymous namespace)::", ""), *r[1:])
                for n, r in zip(names, rows)]
    except (OSError, subprocess.SubprocessError):
        pass
    return rows


def layers(fn, n):
    """A call that runs ``fn(0)``, ``fn(1)``, ..., ``fn(n-1)``, ``fn(0)``, ...
    on successive calls."""
    i = itertools.count()
    return lambda: fn(next(i) % n)


def decode_cost(B, Hq, Hk, D, lengths, elem_bytes, kv_bytes=None):
    """(bytes, operations) decode attention needs for these inputs, by
    ``kernels/meta.py``'s count over the rows' valid slots: q read and o
    written once (``elem_bytes`` an element), k and v read once up to each
    row's length (``kv_bytes`` an element, ``elem_bytes`` if None), the
    lengths themselves; 4*D operations for each (query head, valid slot)."""
    ops, nbytes = decode_work(B, Hq, Hk, D, int(sum(lengths)), elem_bytes,
                              kv_bytes or elem_bytes)
    return nbytes, ops


# torch.profiler now and then misses device events of a profile on an H100
# (in whole runs of this script: every event of one 0.26 ms attention call,
# one of a WKV call's three kernels, each seen by other profiles of the same
# call; in PR 27's run one SDPA timing read 0.0057 ms against 0.0161 on the
# same shape); a profile that saw too few events is taken again, up to this
# many times, and a call's kernels are the most that this many profiles of
# it saw
PROFILE_TRIES = 3


def profile_events(fn, calls: int) -> list:
    """The card's events of one profile of ``calls`` calls of ``fn`` under
    torch.profiler."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return [e for e in prof.events() if e.device_type == DeviceType.CUDA]


def device_events(fn, calls: int, want: int = 1) -> list:
    """The card's events of ``calls`` calls of ``fn``: the first of
    PROFILE_TRIES profiles that saw at least ``want``, else the last."""
    for _ in range(PROFILE_TRIES):
        events = profile_events(fn, calls)
        if len(events) >= want:
            break
    return events


def device_times(fn, iters: int, warmup: int = 3) -> dict:
    """Device time of ``fn`` per call by kernel name, in ms: the card's
    kernel times over ``iters`` calls under torch.profiler, over ``iters``.
    Gaps between kernels, which the host's launch rate sets for calls this
    short, are not counted."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    by_name = {}
    for e in device_events(fn, iters):
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / iters / 1e3
    check(sum(by_name.values()) > 0, "the profiler saw no device time")
    return by_name


def counted_ms(fn, iters: int, warmup: int = 3) -> tuple:
    """``(ms, events seen, events expected)``: ``device_ms`` from a profile
    that saw every kernel of its calls, ``iters`` x ``kernels_per_call(fn)``
    events (the decode phases' yardstick, for calls whose kernels a call do
    not vary); fails if PROFILE_TRIES profiles fell short."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    want = iters * kernels_per_call(fn)
    events = device_events(fn, iters, want)
    check(want > 0 and len(events) >= want,
          f"{PROFILE_TRIES} profiles of {iters} calls saw fewer device events than the {want} "
          f"their kernels make ({len(events)} the last)")
    return sum(e.time_range.elapsed_us() for e in events) / iters / 1e3, len(events), want


def kernels_per_call(fn) -> int:
    """The kernels one call of ``fn`` runs on the card, by torch.profiler:
    the most that PROFILE_TRIES profiles of one call that saw any event saw,
    of at most PROFILE_TRIES ** 2 profiles (0 if none saw any)."""
    fn()
    torch.cuda.synchronize()
    seen = []
    for _ in range(PROFILE_TRIES ** 2):
        n = len(profile_events(fn, 1))
        if n:
            seen.append(n)
        if len(seen) == PROFILE_TRIES:
            break
    return max(seen, default=0)


def graph_ms(fn, calls: int, replays: int = 10) -> float:
    """Device time of ``fn`` per call with the host out of the way: ``calls``
    calls captured in one CUDA graph, its replays timed by CUDA events.  The
    gaps between dependent kernels count; the host's launch rate does not."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    ms = time_ms(graph.replay, replays) / calls
    del graph
    return ms


def decode_plan(q, k) -> tuple:
    """``(split_keys, nsplit)`` of a decode call on these tensors, as the
    wrapper plans it on this card."""
    B, Hq, D = q.shape
    return call_plan(B, Hq, k.shape[2], k.shape[1], D, q.dtype, k.dtype,
                     torch.cuda.get_device_properties(0).multi_processor_count)[:2]


def events_seen(row) -> str:
    """The profile counts behind a decode row's three times, for its line."""
    return "device events seen / expected: " + ", ".join(
        f"{who} {seen}/{want}" for who, (seen, want) in row["events"].items())


def device_ms(fn, iters: int, warmup: int = 3) -> float:
    """Device time of ``fn`` per call, all its kernels summed (``device_times``)."""
    return sum(device_times(fn, iters, warmup).values())


def decode_phase(dev):
    """The decode kernel against decode_attention_ref, then its device time
    at the serving shape beside the plain version's and the library call's,
    each over DECODE_TIMING_LAYERS layers' caches in turn."""
    gen = torch.Generator(device=dev).manual_seed(3)
    worst = 0.0
    for B, C, Hq, Hk, D, lengths in DECODE_CASES:
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            q = torch.randn((B, Hq, D), generator=gen, device=dev).to(dtype)
            k = torch.randn((B, C, Hk, D), generator=gen, device=dev).to(dtype)
            v = torch.randn((B, C, Hk, D), generator=gen, device=dev).to(dtype)
            out = flash_decode(q, k, v, lens)
            torch.cuda.synchronize()
            got, want = out.float(), decode_attention_ref(q, k, v, lens).float()
            check(bool(torch.isfinite(got).all()), f"non-finite decode output C={C}")
            tol = ATTN_TOL[dtype]
            err = float((got - want).abs().max())
            over = float(((got - want).abs() - (tol + tol * want.abs())).max())
            check(over <= 0, f"decode kernel disagrees B={B} C={C} Hq={Hq} Hk={Hk} D={D} "
                  f"lengths={list(lengths)} {dtype}: max abs err {err:.3e} beyond {tol} abs+rel")
            worst = max(worst, err)
            upcast = ""
            if dtype == torch.bfloat16:
                up = decode_attention_ref(q.float(), k.float(), v.float(), lens)
                err_up = float((got - up).abs().max())
                check(err_up <= DECODE_BF16_UPCAST_TOL,
                      f"bf16 decode kernel B={B} C={C} Hq={Hq} Hk={Hk} D={D} is {err_up:.3e} "
                      f"from the float32 plain version on its inputs, beyond "
                      f"{DECODE_BF16_UPCAST_TOL}")
                upcast = (f"; against the float32 plain version on these inputs {err_up:.3e} "
                          f"(tol {DECODE_BF16_UPCAST_TOL} abs)")
            print(f"[kernels] flash_decode B={B} C={C} Hq={Hq} Hk={Hk} D={D} lengths "
                  f"{list(lengths)} {str(dtype)[6:]}: max abs err {err:.3e} "
                  f"(tol {tol} abs+rel){upcast}", flush=True)

    B, L = SERVE_B, DECODE_TIMING_LAYERS
    sdpa = torch.nn.functional.scaled_dot_product_attention
    timing = {}
    # the dense serving path's heads (Minitron-8B, g = 4), the MoE serving
    # path's (Qwen-MoE, g = 1), the hybrid's (RecurrentGemma, g = 16 at
    # D=256), the vlm's (Qwen2-VL, g = 8) and Whisper's decoder (g = 1 at
    # D=64 over its 448-slot cache, served at the lengths of its last decode
    # step), each served and full
    for path, C, served, Hq, Hk, D in (("", SERVE_C, SERVE_LENGTHS, 32, 8, 128),
                                       ("moe ", SERVE_C, SERVE_LENGTHS, 16, 16, 128),
                                       ("hybrid ", SERVE_C, SERVE_LENGTHS, 16, 1, 256),
                                       ("vlm ", SERVE_C, SERVE_LENGTHS, 64, 8, 128),
                                       ("whisper ", WHISPER_C, WHISPER_LENGTHS, 6, 6, 64)):
        q = torch.randn((L, B, Hq, D), generator=gen, device=dev).to(torch.bfloat16)
        k, v = (torch.randn((L, B, C, Hk, D), generator=gen, device=dev).to(torch.bfloat16)
                for _ in range(2))
        kt, vt = (t.transpose(2, 3).contiguous() for t in (k, v))    # (L, B, Hk, C, D)
        for lengths_name, lengths in (("served", served), ("full", (C,) * B)):
            name = path + lengths_name
            lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
            mask = (torch.arange(C, device=dev)[None, :] < lens[:, None])[:, None, None, :]
            lib = sdpa(q[0][:, :, None], kt[0], vt[0], attn_mask=mask,
                       enable_gqa=True)[:, :, 0]
            lib_err = float((lib.float() - decode_attention_ref(q[0], k[0], v[0], lens).float())
                            .abs().max())

            ms, *ev = counted_ms(layers(lambda i: flash_decode(q[i], k[i], v[i], lens), L), 4 * L)
            plain_ms, *plain_ev = counted_ms(
                layers(lambda i: decode_attention_ref(q[i], k[i], v[i], lens), L), L)
            library_ms, *lib_ev = counted_ms(
                layers(lambda i: sdpa(q[i][:, :, None], kt[i], vt[i], attn_mask=mask,
                                      enable_gqa=True), L), 4 * L)
            nbytes, ops = decode_cost(B, Hq, Hk, D, lengths, 2)
            t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / BF16_OPS_PER_S * 1e3
            bound = max(t_bytes, t_ops)
            timing[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound,
                                bound_by="bytes" if t_bytes >= t_ops else "operations",
                                events=dict(kernel=ev, plain=plain_ev, library=lib_ev))
            if name == "served":
                # one kernel on the card a call, and the host's time a call
                per_call = kernels_per_call(lambda: flash_decode(q[0], k[0], v[0], lens))
                check(per_call == 1, f"one flash_decode call ran {per_call} kernels on the card")
                timing["kernels_per_call"] = per_call
                timing["host_us"] = host_us(lambda: flash_decode(q[0], k[0], v[0], lens),
                                            ATTN_HOST_CALLS)
                print(f"[kernels] flash_decode {per_call} kernel on the card a call; host time "
                      f"per call over {ATTN_HOST_CALLS} back-to-back calls "
                      f"{timing['host_us']:.2f} us", flush=True)
            print(f"[kernels] flash_decode B={B} C={C} Hq={Hq} Hk={Hk} D={D} bf16, lengths "
                  f"{lengths_name} (sum {sum(lengths)}), (split_keys, nsplit) "
                  f"{decode_plan(q[0], k[0])}: device {ms:.4f} ms a launch; plain version {plain_ms:.4f} ms; "
                  f"scaled_dot_product_attention {library_ms:.4f} ms (max abs diff from the plain "
                  f"version {lib_err:.3e}); bound {bound:.4f} ms ({nbytes} bytes -> "
                  f"{t_bytes:.4f} ms, {ops} bf16 ops -> {t_ops:.4f} ms), {100 * bound / ms:.1f}% "
                  f"of bound; {events_seen(timing[name])}", flush=True)
        del q, k, v, kt, vt
        torch.cuda.empty_cache()
    return worst, timing



# The decode kernel on float8 K/V (a float8 KV cache): the dense serving
# path's heads (Minitron-8B) and the hybrid's (RecurrentGemma, D = 256), at
# the served lengths and full, q in bf16 and in f32, against the plain
# version (which widens K/V to q's dtype first) at the attention tolerances;
# timed with bf16 q, its bound from the bytes read with K/V at one byte an
# element, SDPA on the widened K/V as the yardstick.
FLOAT8_KV = torch.float8_e4m3fn
FLOAT8_DECODE_SHAPES = (("float8 ", 32, 8, 128), ("float8 hybrid ", 16, 1, 256))


def float8_decode_phase(dev):
    """The decode kernel on float8_e4m3fn K/V against decode_attention_ref,
    then its device time beside the plain version's and SDPA's on the
    widened K/V.  Returns the worst error and the times by shape."""
    gen = torch.Generator(device=dev).manual_seed(5)
    worst, timing = 0.0, {}
    B, C, L = SERVE_B, SERVE_C, DECODE_TIMING_LAYERS
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for path, Hq, Hk, D in FLOAT8_DECODE_SHAPES:
        for lengths in (SERVE_LENGTHS, (C,) * B):
            lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
            for dtype in (torch.float32, torch.bfloat16):
                q = torch.randn((B, Hq, D), generator=gen, device=dev).to(dtype)
                k, v = (astype(torch.randn((B, C, Hk, D), generator=gen, device=dev), FLOAT8_KV)
                        for _ in range(2))
                out = flash_decode(q, k, v, lens)
                torch.cuda.synchronize()
                got, want = out.float(), decode_attention_ref(q, k, v, lens).float()
                check(bool(torch.isfinite(got).all()), f"non-finite float8 decode output D={D}")
                tol = ATTN_TOL[dtype]
                err = float((got - want).abs().max())
                over = float(((got - want).abs() - (tol + tol * want.abs())).max())
                check(over <= 0, f"float8 decode kernel disagrees Hq={Hq} Hk={Hk} D={D} "
                      f"lengths={list(lengths)} q {dtype}: max abs err {err:.3e} beyond {tol}")
                worst = max(worst, err)
                print(f"[kernels] flash_decode float8_e4m3fn K/V B={B} C={C} Hq={Hq} Hk={Hk} "
                      f"D={D} lengths {list(lengths)} q {str(dtype)[6:]}: max abs err "
                      f"{err:.3e} (tol {tol} abs+rel)", flush=True)
        q = torch.randn((L, B, Hq, D), generator=gen, device=dev).to(torch.bfloat16)
        k, v = (astype(torch.randn((L, B, C, Hk, D), generator=gen, device=dev), FLOAT8_KV)
                for _ in range(2))
        kt, vt = (t.to(torch.bfloat16).transpose(2, 3).contiguous() for t in (k, v))
        for lengths_name, lengths in (("served", SERVE_LENGTHS), ("full", (C,) * B)):
            name = path + lengths_name
            lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
            mask = (torch.arange(C, device=dev)[None, :] < lens[:, None])[:, None, None, :]
            ms, *ev = counted_ms(layers(lambda i: flash_decode(q[i], k[i], v[i], lens), L), 4 * L)
            plain_ms, *plain_ev = counted_ms(
                layers(lambda i: decode_attention_ref(q[i], k[i], v[i], lens), L), L)
            library_ms, *lib_ev = counted_ms(
                layers(lambda i: sdpa(q[i][:, :, None], kt[i], vt[i], attn_mask=mask,
                                      enable_gqa=True), L), 4 * L)
            nbytes, ops = decode_cost(B, Hq, Hk, D, lengths, 2, kv_bytes=1)
            t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / BF16_OPS_PER_S * 1e3
            bound = max(t_bytes, t_ops)
            timing[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound,
                                bound_by="bytes" if t_bytes >= t_ops else "operations",
                                events=dict(kernel=ev, plain=plain_ev, library=lib_ev))
            if name == "float8 served":
                per_call = kernels_per_call(lambda: flash_decode(q[0], k[0], v[0], lens))
                check(per_call == 1, f"one float8 flash_decode call ran {per_call} kernels")
                timing["kernels_per_call"] = per_call
            print(f"[kernels] flash_decode float8_e4m3fn K/V B={B} C={C} Hq={Hq} Hk={Hk} D={D} "
                  f"bf16 q, lengths {lengths_name} (sum {sum(lengths)}): device {ms:.4f} ms a "
                  f"launch; plain version {plain_ms:.4f} ms; scaled_dot_product_attention on "
                  f"the widened K/V {library_ms:.4f} ms; bound {bound:.5f} ms ({nbytes} bytes "
                  f"-> {t_bytes:.5f} ms, {ops} bf16 ops -> {t_ops:.5f} ms), "
                  f"{100 * bound / ms:.1f}% of bound; {events_seen(timing[name])}", flush=True)
        del q, k, v, kt, vt
        torch.cuda.empty_cache()
    return worst, timing


def plain_attention(q, k, v, causal=True, window=None):
    """attention_ref, recomputed in the backward pass rather than keeping
    its (B, H, S, S) weights for all 24 layers: the same function and
    gradient, in the memory the kernel's path takes."""
    return checkpoint(attention_ref, q, k, v, use_reentrant=False,
                      causal=causal, window=window)


def step_one(cfg, dev, attn_fn, f32=False, shape=(TRAIN_B, TRAIN_S)):
    """Loss and gradient norm of the first training step of ``train()``
    (bf16 weights from seed 0, the stream's first batch of ``shape`` with
    the model's front-end stubs) through ``attn_fn`` (None: the kernel), in
    bf16 or in a float32 copy of the same weights."""
    params = LM(cfg, device=dev).init(torch.Generator(device=dev).manual_seed(0))
    if f32:
        cfg = dataclasses.replace(cfg, dtype="float32")
        params = tree_map(lambda t: t.float(), params)
    batch = to_device(frontend_stubs(cfg, next(iter(SyntheticLM(cfg.vocab, *shape, seed=0)))),
                      dev)
    loss, _, grads = value_and_grad(LM(cfg, device=dev, attn_fn=attn_fn), params, batch)
    gnorm = float(global_norm(grads))
    del params, grads
    torch.cuda.empty_cache()
    return float(loss), gnorm


# kernel-name fragments of the profile's groups, first match wins
PROFILE_GROUPS = (
    ("attention kernel", ("flash_attention_",)),
    ("decode kernel", ("flash_decode",)),
    ("WKV kernel", ("rwkv6_",)),
    ("matrix products", ("gemm", "xmma", "nvjet", "cutlass", "Kernel2")),
    ("softmax", ("softmax",)),
    ("reductions", ("reduce",)),
    ("copies and casts", ("copy", "Memcpy", "Memset", "cat", "index")),
)


def profile_report(tag, fn):
    """Run ``fn`` once under torch.profiler and print device time by kernel
    group and the top kernels, and the device's busy share of the call (the
    union of kernel intervals over the call's host-clock time, which the
    profiler itself lengthens)."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        print(f"[{tag}] profile: the profiler saw no device time", flush=True)
        return
    by_name, spans = {}, []
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
        spans.append((e.time_range.start, e.time_range.end))
    spans.sort()
    busy, (lo, hi) = 0.0, spans[0]
    for a, b in spans[1:]:
        if a > hi:
            busy, lo = busy + hi - lo, a
        hi = max(hi, b)
    busy += hi - lo
    total = sum(by_name.values())
    groups = {name: 0.0 for name, _ in PROFILE_GROUPS}
    groups["other elementwise"] = 0.0
    for name, us in by_name.items():
        group = next((g for g, keys in PROFILE_GROUPS if any(k in name for k in keys)),
                     "other elementwise")
        groups[group] += us
    print(f"[{tag}] profile: {wall_us / 1e3:.2f} ms on the host clock under the "
          f"profiler, {len(kernels)} device events, device busy {busy / 1e3:.2f} ms "
          f"({100 * busy / wall_us:.1f}%), kernel time {total / 1e3:.2f} ms", flush=True)
    for group, us in sorted(groups.items(), key=lambda kv: -kv[1]):
        if us > 0:
            print(f"[{tag}]   {group}: {us / 1e3:.2f} ms ({100 * us / total:.1f}%)", flush=True)
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        print(f"[{tag}]   kernel {us / 1e3:9.3f} ms  {name[:110]}", flush=True)


def profile_step(cfg, dev, params, opt_state, tag="train", shape=(TRAIN_B, TRAIN_S),
                 steps=TRAIN_STEPS):
    """One more training step, under torch.profiler."""
    step = make_train_step(LM(cfg, device=dev),
                           AdamW(lr=cosine_with_warmup(3e-3, 1, steps)))
    batch = to_device(frontend_stubs(cfg, next(iter(SyntheticLM(cfg.vocab, *shape, seed=1)))),
                      dev)
    profile_report(tag, lambda: step(params, opt_state, batch))


def train_phase(dev, tag="train", arch=TRAIN_ARCH, B=TRAIN_B, S=TRAIN_S, steps=TRAIN_STEPS):
    """Train full-width ``arch`` through ``repro_torch.launch.train.train``;
    check the kernel's launches (one a causal self-attention layer a forward
    pass), finite losses, a checkpoint restored leaf for leaf and step 1
    against the plain attention.  Returns the launches, the peak memory and
    the numbers for a JSON line."""
    cfg = get_config(arch)
    print(f"[{tag}] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads of {cfg.head_dim} ({cfg.n_kv_heads} kv), d_ff {cfg.d_ff}, "
          f"vocab {cfg.vocab}, {cfg.dtype}; B={B} S={S}, {steps} steps",
          flush=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as tmp:
        flash_attention.launches = rwkv6_scan.launches = 0
        flash_attention.wgmma_launches = flash_attention.simt_launches = 0
        out = train(arch, use_reduced=False, steps=steps, batch=B, seq=S,
                    ckpt_dirs=[str(Path(tmp) / "run")], log_every=1, device=dev)
        launches = flash_attention.launches
        peak = torch.cuda.max_memory_allocated()
        check(launches == cfg.n_layers * steps,
              f"flash_attention launched {launches} times for {steps} forward "
              f"passes of {cfg.n_layers} layers")
        check(flash_attention.wgmma_launches == launches and flash_attention.simt_launches == 0,
              f"of {launches} bf16 attention launches {flash_attention.wgmma_launches} went "
              f"through the tensor-core kernel, {flash_attention.simt_launches} the SIMT kernel")
        check(rwkv6_scan.launches == 0, "the training path launched the WKV kernel")
        check(bool(np.isfinite(out["losses"]).all() and np.isfinite(out["grad_norms"]).all()),
              f"non-finite loss or gradient norm: {out['losses']} {out['grad_norms']}")
        n_params = sum(t.numel() for t in tree_leaves(out["params"]))
        print(f"[{tag}] {n_params} parameters", flush=True)
        step_ms = 1e3 * np.asarray(out["step_s"])
        print(f"[{tag}] losses {[round(x, 5) for x in out['losses']]}; gradient norms "
              f"{[round(x, 5) for x in out['grad_norms']]}", flush=True)
        print(f"[{tag}] step ms {[round(float(x), 2) for x in step_ms]} (the first cold): "
              f"median {np.median(step_ms):.2f}, min {step_ms.min():.2f}, "
              f"max {step_ms.max():.2f}; {B * S / np.median(step_ms) * 1e3:.1f} "
              f"tokens/s at the median; peak memory {peak / 2**30:.2f} GiB; "
              f"flash_attention launches {launches} = {cfg.n_layers} layers x "
              f"{steps} forward passes, all through the tensor-core kernel", flush=True)

        profile_step(cfg, dev, out["params"], out["opt_state"], tag, (B, S), steps)
        state = (out["params"], out["opt_state"])
        mgr = CheckpointManager(replica_dirs=[str(Path(tmp) / "final")])
        t = time.perf_counter()
        mgr.save(state, steps)
        back, step, _ = mgr.restore(state)
        same = all(torch.equal(a, b) and a.dtype == b.dtype
                   for a, b in zip(tree_leaves(back), tree_leaves(state)))
        n_leaves = len(tree_leaves(state))
        check(step == steps and same, "the restored checkpoint differs from the state")
        print(f"[{tag}] checkpoint of the final state ({n_leaves} leaves, "
              f"{sum(x.numel() * x.element_size() for x in tree_leaves(state)) / 2**30:.2f} GiB) "
              f"saved and restored leaf for leaf equal in {time.perf_counter() - t:.1f} s",
              flush=True)
        kern16 = (out["losses"][0], out["grad_norms"][0])
        summary = dict(arch=cfg.name, params=n_params, batch=B, seq=S, losses=out["losses"],
                       grad_norms=out["grad_norms"], step_ms=step_ms.tolist(),
                       step_ms_median=float(np.median(step_ms)), peak_gib=peak / 2**30,
                       launches=launches, checkpoint_leaves=n_leaves)
        del out, state, back
        torch.cuda.empty_cache()

    summary["step1"] = step1_check(cfg, dev, kern16, tag, (B, S))
    return launches, peak, summary


def step1_check(cfg, dev, kern16, tag="train", shape=(TRAIN_B, TRAIN_S)):
    """Step 1 through the kernel against the plain attention, same weights
    and batch.  In a float32 copy: loss and gradient norm within
    TRAIN_F32_RTOL.  In bf16 both paths round every activation, so the
    kernel's bf16 step is held against the float32 plain step: its distance
    may be at most BF16_NOISE_FACTOR times the plain bf16 step's own
    distance, or 2^-9 (half a bf16 ulp) of the value, whichever is larger.
    Returns the four (loss, gradient norm) pairs."""
    plain16 = step_one(cfg, dev, plain_attention, shape=shape)
    kern32 = step_one(cfg, dev, None, f32=True, shape=shape)
    plain32 = step_one(cfg, dev, plain_attention, f32=True, shape=shape)
    for i, name in enumerate(("loss", "gradient norm")):
        ref = plain32[i]
        err32 = abs(kern32[i] - ref)
        d_kern, d_plain = abs(kern16[i] - ref), abs(plain16[i] - ref)
        allowed = max(BF16_NOISE_FACTOR * d_plain, 2.0 ** -9 * abs(ref))
        print(f"[{tag}] step 1 {name}: kernel bf16 {kern16[i]:.6f}, plain bf16 "
              f"{plain16[i]:.6f}, kernel f32 {kern32[i]:.6f}, plain f32 {ref:.6f}; f32 "
              f"rel diff {err32 / abs(ref):.3e} (tol {TRAIN_F32_RTOL}); bf16 distance from "
              f"plain f32: kernel {d_kern:.3e}, plain {d_plain:.3e} (allowed {allowed:.3e})",
              flush=True)
        check(err32 <= TRAIN_F32_RTOL * abs(ref),
              f"float32 step 1 {name}: kernel {kern32[i]} vs plain {ref}")
        check(d_kern <= allowed, f"bf16 step 1 {name}: kernel {kern16[i]} is {d_kern:.3e} "
              f"from the float32 plain step, beyond {allowed:.3e}")
    return dict(kernel_bf16=kern16, plain_bf16=plain16, kernel_f32=kern32, plain_f32=plain32)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {key: _tree_map(fn, val) for key, val in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(fn, val) for val in tree]
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, list):
        for val in tree:
            yield from _leaves(val)
    else:
        yield tree

# -- phase 8: the placement core ------------------------------------------------
PLACE_G, PLACE_D = 1024, 100_000        # decision kernels, bit for bit
PLACE_WAVE_D, PLACE_WAVE_B = 100_000, 16    # a wave on the 100k-device fleet
PLACE_SCALAR_D, PLACE_SCALAR_B = 10_000, 64  # a wave against the scalar path
PLACE_SCHEMES = ("ibdash", "churn_aware", "lavea", "round_robin", "tier_escalation")
PLACE_BUDGET = 4.0                      # tier_escalation's latency budget (s)
PLACE_TIMED = 10                        # timed calls of each decision kernel
# Each policy's kernels: a wave must launch each of these at least once.
PLACE_KERNELS = {
    "ibdash": (batched.select_queue, batched.ibdash_scan_kernel),
    "churn_aware": (batched.select_queue, batched.ibdash_scan_kernel),
    "lavea": (batched.lavea_kernel,),
    "round_robin": (batched.round_robin_kernel,),
    "tier_escalation": (batched.tier_escalation_kernel,),
}
# The JAX kernel each decision kernel takes the place of.
PLACE_REPLACES = {
    "select_queue": "src/repro/core/batched.py:581",
    "ibdash_scan_kernel": "src/repro/core/batched.py:476",
    "lavea_kernel": "src/repro/core/batched.py:521",
    "round_robin_kernel": "src/repro/core/batched.py:525",
    "tier_escalation_kernel": "src/repro/core/batched.py:531",
}
# run_one at the paper's fleet and burst (§V-G): 100 devices, 1000
# instances a cycle, SimConfig's 20 cycles.  The fused burst plans each
# cycle in one wave (the decision kernels run); churn with replan plans
# each arrival as it comes (pools of a few rows take the scalar rule) and
# costs 1.2-1.7 s of host time a cycle on the H100 machine (this phase's
# own runs), so it is cut to 6 cycles to keep the phase near two minutes.
PLACE_RUNS = (
    dict(scenario="mix", fused_burst=True),
    dict(scenario="churn", recovery="replan", n_cycles=6),
)


def decision_inputs(dev):
    """Inputs of the decision kernels at G x D on the card, from seed 8:
    half the rows integer-valued totals and queues (exact ties at every
    minimum), half continuous; +inf in about 1% of the totals; every 97th
    row wholly infeasible, every 89th with one feasible device, one row
    all +inf but feasible; pf in [0, 1)."""
    gen = torch.Generator(device=dev).manual_seed(8)
    G, D = PLACE_G, PLACE_D
    total = torch.rand(G, D, generator=gen, device=dev, dtype=torch.float64) * 50
    ints = torch.randint(1, 200, (G // 2, D), generator=gen, device=dev).double()
    total[: G // 2] = ints
    total[torch.rand(G, D, generator=gen, device=dev) < 0.01] = float("inf")
    total[5] = float("inf")
    pf = torch.rand(G, D, generator=gen, device=dev, dtype=torch.float64)
    queue = torch.randint(0, 6, (G, D), generator=gen, device=dev).double()
    queue[G // 2:] += torch.rand(G - G // 2, D, generator=gen, device=dev, dtype=torch.float64)
    feasible = torch.rand(G, D, generator=gen, device=dev) < 0.9
    feasible[::97] = False
    feasible[1::89] = False
    feasible[1::89, 7] = True
    tiers = torch.randint(0, 3, (D,), generator=gen, device=dev)
    cursor = 12345
    sizes = feasible.sum(dim=1)
    before = torch.cumsum(sizes > 0, 0) - (sizes > 0).long()
    targets = torch.where(sizes > 0, (cursor + before) % sizes.clamp(min=1), 0)
    return dict(total=total, pf=pf, queue=queue, feasible=feasible, tiers=tiers,
                targets=targets)


def decision_bytes(name, G, D, k):
    """Bytes each decision kernel must move at these shapes: every input read
    once, every output written once."""
    f64, i64 = 8, 8
    return {
        "select_queue": G * D * f64 + G * k * i64,
        "ibdash_scan_kernel": 2 * G * k * f64 + G * i64 + G * (k - 1),
        "lavea_kernel": G * D * f64 + G * D + G * i64,
        "round_robin_kernel": G * D + 2 * G * i64,
        "tier_escalation_kernel": G * D * f64 + G * D + D * i64 + G * i64,
    }[name]


def decision_ops(name, G, D, k, n_tiers):
    """Float64 operations each decision kernel does on these inputs: the
    comparisons of a sort (D log2 D a row), a masked select and a compare a
    candidate for an argmin, a sum and a compare for the prefix count, and
    the scan's dozen operations a row and step."""
    return {
        "select_queue": G * D * max(D.bit_length() - 1, 1),
        "ibdash_scan_kernel": 12 * G * (k - 1),
        "lavea_kernel": 2 * G * D,
        "round_robin_kernel": 3 * G * D,
        "tier_escalation_kernel": (n_tiers + 1) * 3 * G * D,
    }[name]


def decision_phase(dev):
    """The decision kernels and the queue selection against their plain
    numpy versions, bit for bit, then their device and host times."""
    inp = decision_inputs(dev)
    host = {key: val.cpu().numpy() for key, val in inp.items()}
    G, D = PLACE_G, PLACE_D
    gamma, alpha, beta = 3, 0.5, 0.1
    k = min(gamma + 1, D - 1) + 1
    n_tiers = int(host["tiers"].max()) + 1
    masked = torch.where(inp["feasible"], inp["total"], float("inf"))
    masked_h = np.where(host["feasible"], host["total"], np.inf)
    order = batched.select_queue(masked, k)
    order_h = order.cpu().numpy()
    s_total = torch.gather(inp["total"], 1, order)
    s_pf = torch.gather(inp["pf"], 1, order)
    n_feas = inp["feasible"].sum(dim=1)
    n_feas_h = host["feasible"].sum(axis=1)
    calls = {
        "select_queue": (lambda: batched.select_queue(masked, k),
                         lambda: batched.select_queue_plain(masked_h, k)),
        "ibdash_scan_kernel": (
            lambda: batched.ibdash_scan_kernel(s_total, s_pf, n_feas, alpha, beta, gamma),
            lambda: batched.ibdash_scan_plain(
                np.take_along_axis(host["total"], order_h, 1),
                np.take_along_axis(host["pf"], order_h, 1), n_feas_h, alpha, beta, gamma)),
        "lavea_kernel": (lambda: batched.lavea_kernel(inp["queue"], inp["feasible"]),
                         lambda: batched.lavea_plain(host["queue"], host["feasible"])),
        "round_robin_kernel": (
            lambda: batched.round_robin_kernel(inp["feasible"], inp["targets"]),
            lambda: batched.round_robin_plain(host["feasible"], host["targets"])),
        "tier_escalation_kernel": (
            lambda: batched.tier_escalation_kernel(inp["total"], inp["feasible"], inp["tiers"],
                                                   PLACE_BUDGET * 10, n_tiers),
            lambda: batched.tier_escalation_plain(host["total"], host["feasible"], host["tiers"],
                                                  PLACE_BUDGET * 10, n_tiers)),
    }
    out = {}
    for name, (kern, plain) in calls.items():
        got = kern().cpu().numpy()
        t = time.perf_counter()
        with np.errstate(invalid="ignore"):     # inf / inf in rows all +inf, as in numpy
            want = plain()
        plain_ms = (time.perf_counter() - t) * 1e3
        check(got.shape == want.shape and got.dtype == want.dtype,
              f"{name}: {got.shape} {got.dtype} against the plain {want.shape} {want.dtype}")
        n_diff = int((got != want).sum())
        check(n_diff == 0, f"{name} differs from its plain version at {n_diff} entries "
                           f"(G={G}, D={D})")
        ms = time_ms(kern, PLACE_TIMED)
        busy = device_ms(kern, PLACE_TIMED)
        us = host_us(kern, PLACE_TIMED)
        nbytes = decision_bytes(name, G, D, k)
        ops = decision_ops(name, G, D, k, n_tiers)
        by_bytes, by_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / F64_OPS_PER_S * 1e3
        bound = max(by_bytes, by_ops)
        out[name] = dict(ms=ms, kernel_ms=busy, host_us=us, plain_ms=plain_ms, bound_ms=bound,
                         bound_by="bytes" if by_bytes >= by_ops else "operations",
                         bytes=nbytes, ops=ops, mismatches=n_diff)
        print(f"[place] {name} G={G} D={D} float64: equal to its plain version at every "
              f"entry ({got.size} outputs); {ms:.4f} ms a call by CUDA events "
              f"({PLACE_TIMED} calls back to back), kernels' time {busy:.4f} ms, host "
              f"{us:.1f} us a call; plain numpy version {plain_ms:.1f} ms; bound {bound:.4f} ms "
              f"({nbytes:,} bytes at 3.35 TB/s: {by_bytes:.4f} ms; {ops:,} f64 operations at "
              f"34 TFLOP/s: {by_ops:.4f} ms), {100 * bound / ms:.1f}% of bound", flush=True)
    ties_ok = near_tie_check(dev, alpha, beta, gamma)
    rows_inf = int((~host["feasible"]).all(axis=1).sum())
    ties = int((host["total"][: G // 2] == host["total"][: G // 2].min(axis=1, keepdims=True))
               .sum(axis=1).mean())
    print(f"[place] decision inputs: {rows_inf} wholly infeasible rows, "
          f"{int(np.isinf(host['total']).sum()):,} +inf totals, {ties} devices tied at each "
          f"integer row's minimum on average; replicas accepted by the scan: "
          f"{int(calls['ibdash_scan_kernel'][0]().sum())}; at line 34's exact ties "
          f"{ties_ok}", flush=True)
    del inp, masked, order, s_total, s_pf
    torch.cuda.empty_cache()
    return out


def near_tie_check(dev, alpha, beta, gamma, G=PLACE_G, K=5) -> str:
    """The scan kernel on rows whose first replica candidate sits at the
    exact tie of Algorithm 1's line 34 (``w_new == w_s`` in exact
    arithmetic), so only the rounding of the four float64 operations of
    the weight update decides: a fused multiply-add on the card would flip
    some rows.  Must equal the plain version."""
    rng = np.random.default_rng(9)
    best = rng.uniform(0.5, 3.0, G)
    ratio = 1 + rng.integers(1, 20, (G, K - 1)) / 64
    comb0 = rng.uniform(0.3, 0.9, G)
    pf1 = 1 - alpha * (ratio[:, 0] - 1) / ((1 - alpha) * comb0)
    s_total = np.concatenate([best[:, None], best[:, None] * ratio], axis=1)
    s_pf = np.clip(np.concatenate([comb0[:, None], pf1[:, None],
                                   rng.uniform(0, 1, (G, K - 2))], axis=1), 0.0, 1.0)
    n_feas = np.full(G, K)
    want = batched.ibdash_scan_plain(s_total, s_pf, n_feas, alpha, beta, gamma)
    got = batched.ibdash_scan_kernel(
        *(torch.from_numpy(a).to(dev) for a in (s_total, s_pf, n_feas)),
        alpha, beta, gamma).cpu().numpy()
    n_diff = int((got != want).sum())
    check(n_diff == 0, f"ibdash_scan_kernel differs from its plain version at {n_diff} "
                       f"entries on rows at line 34's exact ties")
    return (f"{int(want[:, 0].sum())} of {G} rows accept their first candidate, "
            f"equal to the plain version")


def wave_apps(B, seed=1):
    """B seeded application instances (the four paper apps) and their
    arrival times over the paper's 1.5 s window, so every app's rows are
    distinct context rows and every policy's pool reaches its kernel."""
    rng = np.random.default_rng(seed)
    builders = list(APP_BUILDERS.values())
    apps = [builders[int(rng.integers(len(builders)))]().relabel(f"#{i}") for i in range(B)]
    times = np.sort(rng.uniform(0.0, 1.5, B)).tolist()
    return apps, times


def same_plans(tag, got, want):
    """Plans equal placement for placement, estimates included."""
    check(len(got) == len(want), f"{tag}: {len(got)} plans against {len(want)}")
    for a, b in zip(got, want):
        check(a.feasible == b.feasible and a.infeasible_task == b.infeasible_task
              and a.est_latency == b.est_latency and set(a.tasks) == set(b.tasks),
              f"{tag}: plan of {a.app.name} differs")
        for name, ta in a.tasks.items():
            tb = b.tasks[name]
            check([(r.did, r.est_exec, r.est_upload, r.est_transfer, r.pred_fail)
                   for r in ta.replicas]
                  == [(r.did, r.est_exec, r.est_upload, r.est_transfer, r.pred_fail)
                      for r in tb.replicas]
                  and ta.est_start == tb.est_start and ta.est_latency == tb.est_latency,
                  f"{tag}: placement of {name} differs")


def timed_decisions(policy) -> list:
    """Wrap ``policy.decide_batch`` so the one entry of the returned list
    sums its wall time (the decision kernels, their copies and the host's
    fan-out of the decisions)."""
    spent, inner = [0.0], policy.decide_batch

    def decide_batch(batch):
        t = time.perf_counter()
        try:
            return inner(batch)
        finally:
            spent[0] += time.perf_counter() - t

    policy.decide_batch = decide_batch
    return spent


def forbid_dense(*_a, **_k):
    raise RuntimeError("a dense (D, D) link matrix was built while planning a wave")


def wave_phase(dev):
    """One wave for each kernel-backed policy on the 100k-device multi-tier
    fleet, on the card and on the CPU, and a 10k-device wave against the
    scalar path."""
    out = {}
    for D, B in ((PLACE_WAVE_D, PLACE_WAVE_B), (PLACE_SCALAR_D, PLACE_SCALAR_B)):
        t = time.perf_counter()
        profile = make_profile(seed=0, device=dev)
        cluster = make_cluster(profile, scenario="multi_tier", n_devices=D, seed=0,
                               horizon=20.0, dt=0.5)
        cluster.link_bw = forbid_dense
        apps, times = wave_apps(B)
        n_tasks = sum(app.n_tasks for app in apps)
        print(f"[place] multi_tier fleet of {D:,} devices built in "
              f"{time.perf_counter() - t:.1f} s; a wave of {B} apps ({n_tasks} tasks)", flush=True)
        for scheme in PLACE_SCHEMES:
            cfg = SimConfig(seed=0, latency_budget=PLACE_BUDGET, device=dev.type)
            policy = policy_for(scheme, profile, cfg)
            orchestrate_batch(apps, cluster, policy, times=times)        # warm-up
            policy = policy_for(scheme, profile, cfg)
            decide_s = timed_decisions(policy)
            for kern in batched.DECISION_KERNELS:
                kern.launches = 0
            torch.cuda.synchronize()
            t = time.perf_counter()
            plans = orchestrate_batch(apps, cluster, policy, times=times)
            wave_s = time.perf_counter() - t
            launches = {kern.__name__: kern.launches for kern in batched.DECISION_KERNELS}
            for kern in PLACE_KERNELS[scheme]:
                check(kern.launches > 0, f"{scheme} wave at D={D} launched no {kern.__name__}")
            if D == PLACE_WAVE_D:
                ref = orchestrate_batch(apps, cluster, policy_for(
                    scheme, profile, SimConfig(seed=0, latency_budget=PLACE_BUDGET,
                                               device="cpu")), times=times)
                same_plans(f"{scheme} wave at D={D}, cuda against cpu", plans, ref)
                against = "the same wave on the CPU"
                if scheme == "ibdash":     # the policy by name, on the call's device
                    by_name = orchestrate_batch(apps, cluster, "ibdash", times=times,
                                                device="cuda")
                    same_plans(f"ibdash by name at D={D}", by_name, plans)
                    against += " and to the policy given by name with device='cuda'"
            else:
                ref = orchestrate_batch(apps, cluster, policy_for(scheme, profile, cfg),
                                        times=times, batched=False)
                same_plans(f"{scheme} wave at D={D}, batched against scalar", plans, ref)
                against = "the scalar batched=False path"
            placed = sum(len(p.tasks) for p in plans)
            out[f"{scheme}@{D}"] = dict(wave_ms=wave_s * 1e3, decide_ms=decide_s[0] * 1e3,
                                        instances_per_s=B / wave_s,
                                        tasks_per_s=placed / wave_s, launches=launches)
            print(f"[place] {scheme} wave, D={D:,}, B={B}: {wave_s * 1e3:.1f} ms "
                  f"({decide_s[0] * 1e3:.1f} ms of it in decide_batch), "
                  f"{B / wave_s:.1f} instances/s, {placed / wave_s:.1f} tasks placed/s; "
                  f"kernel calls {launches}; equal to {against}", flush=True)
        del cluster
    return out


def run_phase(dev):
    """run_one at the paper's scale on the card, held instance for instance
    against the same run on the CPU."""
    out = {}
    for kw in PLACE_RUNS:
        tag = ",".join(f"{k}={v}" for k, v in kw.items())
        for kern in batched.DECISION_KERNELS:
            kern.launches = 0
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        t = time.perf_counter()
        res = run_one("ibdash", SimConfig(device="cuda", **kw))
        wall = time.perf_counter() - t
        launches = {kern.__name__: kern.launches for kern in batched.DECISION_KERNELS}
        peak = torch.cuda.max_memory_allocated() - before
        t = time.perf_counter()
        ref = run_one("ibdash", SimConfig(device="cpu", **kw))
        cpu_wall = time.perf_counter() - t
        same_result(f"run_one {tag}", res, ref)
        if kw.get("fused_burst"):
            check(launches["ibdash_scan_kernel"] > 0, f"run_one {tag} launched no scan kernel")
        check(np.isfinite(res.avg_service_time) and 0.0 <= res.prob_failure <= 1.0,
              f"run_one {tag}: avg_service_time {res.avg_service_time}, "
              f"prob_failure {res.prob_failure}")
        cfg, full = SimConfig(**kw), SimConfig().n_cycles
        cut = "uncut" if cfg.n_cycles == full else f"cut from {full} for time"
        out[tag] = dict(n_cycles=cfg.n_cycles, instances=res.n,
                        avg_service_time=res.avg_service_time, prob_failure=res.prob_failure,
                        wall_s=wall, cpu_wall_s=cpu_wall, peak_bytes=peak, launches=launches)
        print(f"[place] run_one ibdash {tag}: {cfg.n_devices} devices, {cfg.n_cycles} cycles "
              f"of {cfg.instances_per_cycle} instances ({cut}), {res.n} instances; "
              f"avg_service_time {res.avg_service_time:.6f} s, prob_failure "
              f"{res.prob_failure:.6f}; {wall:.2f} s on cuda ({cpu_wall:.2f} s on cpu), "
              f"peak device memory {peak / 2**20:.1f} MiB above what the process held "
              f"before; kernel calls {launches}; equal "
              f"to the CPU run instance for instance", flush=True)
    return out


def place_phase(dev):
    """Phase 8: the decision kernels, waves and run_one; returns the place line."""
    t = time.perf_counter()
    kernels = decision_phase(dev)
    waves = wave_phase(dev)
    runs = run_phase(dev)
    wave_launches = {}
    for scheme in PLACE_SCHEMES:
        for name, n in waves[f"{scheme}@{PLACE_WAVE_D}"]["launches"].items():
            wave_launches[name] = wave_launches.get(name, 0) + n
    line = {"place": {
        "kernels": [dict(name=name, replaces=PLACE_REPLACES[name],
                         launches=wave_launches[name], **vals)
                    for name, vals in kernels.items()],
        "waves": waves, "runs": runs, "G": PLACE_G, "D": PLACE_D,
        "seconds": time.perf_counter() - t,
    }}
    print(f"[place] phase took {line['place']['seconds']:.1f} s", flush=True)
    return line

# -- phase 9: the streaming service, the serving fleet and the exporters -------
# benchmarks/bench_stream.py's overload point, with its constants: 100
# devices of the mixed fleet, Poisson arrivals at 240/s over 45 s from seed
# 7, a 256-deep admission queue, waves of at most 30 every 0.25 s tick, SLOs
# of 6 s (critical) and 30 s (best effort); the baseline runs with no
# admission and no wave cap.  Its committed results are read from the file.
STREAM_D, STREAM_RATE, STREAM_HORIZON = 100, 240.0, 45.0
STREAM_QUEUE_CAP, STREAM_WAVE_CAP, STREAM_TICK = 256, 30, 0.25
STREAM_SLO = (6.0, 30.0)
BENCH_STREAM = Path(__file__).resolve().parent / "BENCH_stream.json"
# the deterministic columns of a BENCH_stream.json row (all but its wall
# time and placement rate, which are read off the host's clock)
BENCH_COLUMNS = ("n_arrivals", "shed_rate", "shed", "completed", "lost", "deadline_missed",
                 "deadline_missed_critical", "p50_critical", "p99_critical", "p999_critical",
                 "p99_best_effort")
# The JAX serve_demo's fleet comparison (src/repro/launch/serve.py:64-76):
# 16 replicas from seed 0, 600 requests over an 8 s window from seed 1; then
# ibdash fused, behind the admission queue, and under churn with replan.
FLEET_POLICIES = ("ibdash", "petrel", "lavea", "round_robin")
FLEET_RUNS = tuple((pol, {}, {}) for pol in FLEET_POLICIES) + (
    ("ibdash", {}, dict(fused=True)),
    ("ibdash", {}, dict(admission=AdmissionConfig())),
    ("ibdash", dict(churn=True, recovery="replan"), {}),
)
CPU = torch.device("cpu")


@contextlib.contextmanager
def ibdash_pools():
    """Record the distinct-row count of every IBDASH-family ``decide_batch``
    call while the block runs (degraded policies made inside the service
    included): the calls whose pool reaches ``BATCH_KERNEL_MIN_ROWS`` must
    each launch the queue and scan kernels once, the others take the
    scalar rule."""
    sizes, inner = [], IBDASHPolicy.decide_batch

    def decide_batch(self, batch):
        sizes.append(batch.n_distinct)
        return inner(self, batch)

    IBDASHPolicy.decide_batch = decide_batch
    try:
        yield sizes
    finally:
        IBDASHPolicy.decide_batch = inner


def same_result(tag, a, b):
    """Two SimResults agree instance for instance and device for device."""
    check(a.n == b.n and np.array_equal(a.load_per_device, b.load_per_device),
          f"{tag}: load per device differs between cuda and cpu")
    check([dataclasses.astuple(r) for r in a.instances]
          == [dataclasses.astuple(r) for r in b.instances],
          f"{tag}: an instance record differs between cuda and cpu")
    check(repr((a.avg_service_time, a.prob_failure)) == repr((b.avg_service_time, b.prob_failure)),
          f"{tag}: average service time or failure rate differs between cuda and cpu")


def same_stream(tag, a, b):
    """Two StreamResults agree exactly, but for the wall-clock metrics."""
    same_result(tag, a.result, b.result)
    check(a.n_arrivals == b.n_arrivals and a.stats == b.stats,
          f"{tag}: the engine's counters differ between cuda and cpu")
    check([dataclasses.astuple(r) for r in a.shed_log]
          == [dataclasses.astuple(r) for r in b.shed_log],
          f"{tag}: the shed log differs between cuda and cpu")
    check(json.dumps(without_wall_clock(a.metrics), sort_keys=True)
          == json.dumps(without_wall_clock(b.metrics), sort_keys=True),
          f"{tag}: a metric differs between cuda and cpu")


def bench_row(res):
    """A StreamResult in bench_stream.measure's columns."""
    c = res.metrics["counters"]
    return {
        "n_arrivals": res.n_arrivals, "shed_rate": res.shed_rate, "shed": res.stats["shed"],
        "completed": res.stats["completed"], "lost": res.stats["lost"],
        "deadline_missed": c.get("deadline_missed", 0),
        "deadline_missed_critical": c.get("deadline_missed_latency_critical", 0),
        "p50_critical": res.p("p50", "latency_critical"),
        "p99_critical": res.p("p99", "latency_critical"),
        "p999_critical": res.p("p999", "latency_critical"),
        "p99_best_effort": res.p("p99", "best_effort"),
    }


def counted_run(dev, fn):
    """Run ``fn`` with the decision kernels' counts at 0 and IBDASH's pools
    recorded; returns its result and what was counted (wall seconds, the
    kernels' launches, the decide_batch calls and those at or above the
    kernels' row threshold, and on the card the peak memory above what the
    process held before)."""
    for kern in batched.DECISION_KERNELS:
        kern.launches = 0
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
    with ibdash_pools() as pools:
        t = time.perf_counter()
        out = fn()
        wall = time.perf_counter() - t
    counts = dict(
        wall_s=wall, launches={kern.__name__: kern.launches for kern in batched.DECISION_KERNELS},
        decide_batch_calls=len(pools),
        kernel_pools=sum(g >= batched.BATCH_KERNEL_MIN_ROWS for g in pools),
        peak_bytes=torch.cuda.max_memory_allocated() - before if dev.type == "cuda" else None)
    if dev.type == "cuda":
        check(counts["launches"]["ibdash_scan_kernel"] == counts["launches"]["select_queue"]
              == counts["kernel_pools"],
              f"{counts['kernel_pools']} IBDASH pools of at least "
              f"{batched.BATCH_KERNEL_MIN_ROWS} rows, but {counts['launches']} kernel launches")
    return out, counts


def overload_run(dev, admission, trace=False):
    """bench_stream.measure's overload point through the port's API on
    ``dev``: returns the service and its result."""
    profile = make_profile(seed=0, device=dev)
    cluster = make_cluster(profile, scenario="stream", n_devices=STREAM_D, seed=0,
                           horizon=STREAM_HORIZON * 6.0 + 120.0)
    orch = Orchestrator(cluster, make_policy("ibdash", alpha=0.5, beta=0.1, gamma=3,
                                             lats_model=profile.lats_model, device=dev),
                        trace=trace)
    arrivals = poisson_arrivals(default_streams(slo_critical=STREAM_SLO[0],
                                                slo_best_effort=STREAM_SLO[1]),
                                STREAM_RATE, STREAM_HORIZON, seed=7)
    service = StreamingOrchestrator(
        orch, admission=AdmissionConfig(queue_cap=STREAM_QUEUE_CAP) if admission else None,
        wave_cap=STREAM_WAVE_CAP if admission else None, tick=STREAM_TICK)
    return service, service.run(arrivals)


def describe(counts) -> str:
    peak = counts["peak_bytes"]
    return (f"{counts['wall_s']:.2f} s, {counts['decide_batch_calls']} decide_batch calls "
            f"({counts['kernel_pools']} pools of >= {batched.BATCH_KERNEL_MIN_ROWS} rows), "
            f"kernel launches {counts['launches']}, peak device memory "
            + (f"{peak / 2**20:.1f} MiB above what the process held before"
               if peak is not None else "not measured (cpu)"))


def overload_phase(cuda):
    """(a) The overload point with and without admission, on the card and
    on the CPU, equal to each other and to BENCH_stream.json."""
    bench = json.loads(BENCH_STREAM.read_text())["results"]
    out, results = {}, {}
    for point, admission in (("overload", True), ("overload_baseline", False)):
        runs = {}
        for name, dev in (("cuda", cuda), ("cpu", CPU)):
            (_, res), counts = counted_run(dev, lambda: overload_run(dev, admission))
            runs[name] = res
            counts["placements_per_sec"] = res.metrics["gauges"]["placements_per_sec"]
            out.setdefault(point, {})[name] = counts
            print(f"[stream] {point} on {name}: {res.n_arrivals} arrivals, shed "
                  f"{res.stats['shed']}, completed {res.stats['completed']}, lost "
                  f"{res.stats['lost']}, p99_critical {res.p('p99')!r}; "
                  f"{counts['placements_per_sec']:.1f} placements/s; {describe(counts)}",
                  flush=True)
        same_stream(f"{point} run", runs["cuda"], runs["cpu"])
        row, want = bench_row(runs["cuda"]), bench[point]
        for col in BENCH_COLUMNS:
            check(row[col] == want[col],
                  f"{point}: {col} {row[col]!r} against BENCH_stream.json's {want[col]!r}")
        out[point]["bench"] = row
        results[point] = runs["cuda"]
        print(f"[stream] {point}: equal on cuda and cpu (records, shed log, counters, every "
              f"metric but {', '.join(WALL_CLOCK_METRICS)}) and to BENCH_stream.json in "
              f"{len(BENCH_COLUMNS)} columns (shed {row['shed']}, completed {row['completed']}, "
              f"lost {row['lost']}, p99_critical {row['p99_critical']!r})", flush=True)
    return out, results["overload"]


def export_phase(cuda, untraced):
    """(b) The admitted overload once more, traced, on the card and on
    the CPU: equal reports and summaries, the same Chrome trace string for
    string, valid, and the ledger rebuilt from the exported JSON alone."""
    docs = {}
    for name, dev in (("cuda", cuda), ("cpu", CPU)):
        t = time.perf_counter()
        # trace=True: an empty Tracer() is falsy (it has a length), and the
        # Orchestrator of both packages reads a falsy trace as "off"
        service, res = overload_run(dev, True, trace=True)
        run_s = time.perf_counter() - t
        tracer = service.orch.trace
        t = time.perf_counter()
        report = attribution_report(tracer)
        summary = json_summary(tracer, service.metrics)
        summary["metrics"] = without_wall_clock(summary["metrics"])
        text = json.dumps(to_chrome_trace(tracer))
        docs[name] = (res, repr(report), format_report(report),
                      json.dumps(summary, sort_keys=True), text)
        print(f"[stream] traced overload on {name}: run {run_s:.2f} s, report and export "
              f"{time.perf_counter() - t:.2f} s; {len(tracer.spans)} spans, Chrome trace "
              f"{len(text)} bytes", flush=True)
    check([dataclasses.astuple(dataclasses.replace(r, tid=-1))
           for r in docs["cuda"][0].result.instances]
          == [dataclasses.astuple(r) for r in untraced.result.instances],
          "tracing changed an instance record of the overload run (trace ids aside)")
    (res, report, text_report, summary, text), cpu_doc = docs["cuda"], docs["cpu"]
    same_stream("traced overload", res, cpu_doc[0])
    check(report == cpu_doc[1] and text_report == cpu_doc[2],
          "attribution_report differs between cuda and cpu")
    check(summary == cpu_doc[3], "json_summary differs between cuda and cpu")
    check(text == cpu_doc[4], "the Chrome trace JSON differs between cuda and cpu")
    n_events = validate_chrome_trace(json.loads(text))
    ledger = ledger_from_trace(json.loads(text))
    want = {"admitted": res.n_arrivals, "completed": res.stats["completed"],
            "lost": res.stats["lost"], "shed": res.stats["shed"]}
    check(ledger == want, f"ledger from the exported trace {ledger} against the run's {want}")
    print(f"[stream] exports equal on cuda and cpu (attribution report, json_summary, "
          f"Chrome trace string for string); {n_events} events valid; ledger from the trace "
          f"alone {ledger}", flush=True)
    return dict(events=n_events, trace_bytes=len(text), ledger=ledger)


def fleet_phase(cuda, fit):
    """(c) The serving fleet fed by the card's full-width dense fit, on the
    card and on the CPU, equal run for run."""
    m, c, r2 = fit
    im = fleet_interference(m, c)
    print(f"[stream] fleet interference from {DENSE_ARCH}'s fit on the card: m={m!r} s/seq"
          + (" (below zero, taken as 0)" if m < 0 else "")
          + f", c={c!r} s (R^2 {r2:.4f}); long requests 3m, 6c", flush=True)
    out = {}
    for pol, fleet_kw, run_kw in FLEET_RUNS:
        tag = pol + "".join(f",{k}" for k in {**fleet_kw, **run_kw})
        runs = {}
        for name, dev in (("cuda", cuda), ("cpu", CPU)):
            fleet = ServingFleet(im, policy=pol, n_replicas=16, seed=0, device=dev, **fleet_kw)
            res, counts = counted_run(dev, lambda: fleet.run(
                n_requests=600, arrival_window=8.0, seed=1, **run_kw))
            runs[name] = (fleet, res)
            counts.update(avg_latency_s=res.avg_service_time, failure_rate=res.prob_failure,
                          device_down=fleet.engine.stats.device_down,
                          replica_deaths=fleet.engine.stats.replica_deaths)
            out.setdefault(tag, {})[name] = counts
            print(f"[stream] fleet {tag} on {name}: avg latency "
                  f"{res.avg_service_time * 1e3:.3f} ms, failure rate {res.prob_failure:.6f}, "
                  f"{counts['device_down']} replica departures; {describe(counts)}", flush=True)
        (fleet, res), (fleet_c, res_c) = runs["cuda"], runs["cpu"]
        same_result(f"fleet {tag}", res, res_c)
        check(fleet.engine.stats.as_dict() == fleet_c.engine.stats.as_dict(),
              f"fleet {tag}: the engine's counters differ between cuda and cpu")
        if "admission" in run_kw:
            same_stream(f"fleet {tag}", res.stream, res_c.stream)
        if run_kw.get("fused"):
            check(out[tag]["cuda"]["launches"]["ibdash_scan_kernel"] > 0,
                  f"fleet {tag} launched no scan kernel")
        check(np.isfinite(res.avg_service_time) and 0.0 <= res.prob_failure <= 1.0,
              f"fleet {tag}: avg latency {res.avg_service_time}, failure rate {res.prob_failure}")
    print(f"[stream] {len(FLEET_RUNS)} fleet runs equal on cuda and cpu", flush=True)
    return out


def stream_phase(dev, fit):
    """Phase 9: the overload point, its exports and the serving fleet, each
    run on ``dev`` and on the CPU; returns the stream line."""
    t = time.perf_counter()
    overload, admitted = overload_phase(dev)
    export = export_phase(dev, admitted)
    fleet = fleet_phase(dev, fit)
    launched = sum(runs["cuda"]["launches"]["ibdash_scan_kernel"]
                   for runs in (*overload.values(), *fleet.values()))
    check(launched > 0, "phase 9 launched no decision kernel on the card")
    line = {"stream": {"overload": overload, "export": export, "fleet": fleet,
                       "fit": dict(zip(("m", "c", "r2"), fit)),
                       "seconds": time.perf_counter() - t}}
    print(f"[stream] phase took {line['stream']['seconds']:.1f} s", flush=True)
    return line


# -- phase 10: the mixture of experts -----------------------------------------------
MOE_ARCH, DSV3_ARCH, DSV3_LAYERS, DSV3_REQUESTS = "qwen2-moe-a2.7b", "deepseek-v3-671b", 4, 2
# DeepSeek-V3's absorbed MLA decode against its expanded form, per layer on
# the same inputs: in a float32 copy of the layer within this share of max
# |out| (the two forms differ by summation order only, about 1e-6 of it);
# in bf16 by the BF16_NOISE_FACTOR rule against the float32 expanded form.
MLA_F32_TOL = 1e-4
# The sort dispatch against the einsum dispatch on one Qwen-MoE layer with no
# drops (capacity factor E / top_k, so C holds every claim): in a float32 copy
# within this share of max |y| (the two sum the same products in another
# order: scatter_add_ on the card adds in no fixed order); bf16 by the
# BF16_NOISE_FACTOR rule against the float32 einsum route.
DISPATCH_F32_TOL = 1e-4


class LayerHold:
    """An ``attn_fn`` or ``decode_fn`` for ``LM`` that runs the kernel and
    returns its output, and on the same inputs (the path's own activations,
    layer by layer) also runs the plain version, and both on the inputs
    cast up to float32.  ``check`` holds every call as ``hold_logits``
    holds logits: in float32 within LOGITS_F32_TOL of max |out|; in bf16 an
    RMS distance from the float32 plain output at most BF16_NOISE_FACTOR
    times the plain bf16 output's."""

    def __init__(self, kernel, plain):
        self.kernel, self.plain, self.rows = kernel, plain, []

    def __call__(self, *args, **kw):
        out = self.kernel(*args, **kw)
        up = [a.float() if a.is_floating_point() else a for a in args]
        p32 = self.plain(*up, **kw)
        k32 = self.kernel(*up, **kw)
        self.rows.append((float((k32 - p32).abs().max()), float(p32.abs().max()),
                          _rms(out.float(), p32), _rms(self.plain(*args, **kw).float(), p32)))
        return out

    def check(self, tag, what):
        check(len(self.rows) > 0, f"{what}: no call was held")
        for i, (err32, scale, rms_kern, rms_plain) in enumerate(self.rows):
            check(err32 <= LOGITS_F32_TOL * scale,
                  f"{what}, call {i}: float32 kernel differs by {err32:.4e}, beyond "
                  f"{LOGITS_F32_TOL} x {scale:.4f}")
            check(rms_kern <= BF16_NOISE_FACTOR * rms_plain,
                  f"{what}, call {i}: bf16 kernel is {rms_kern:.4e} RMS from float32, beyond "
                  f"{BF16_NOISE_FACTOR} x the plain path's {rms_plain:.4e}")
        rel32 = max(_ratio(r[0], r[1]) for r in self.rows)
        ratio = max(_ratio(r[2], r[3]) for r in self.rows)
        print(f"[{tag}] {what}: {len(self.rows)} calls held; float32 worst max abs diff "
              f"{rel32:.3e} of max |out| (tol {LOGITS_F32_TOL}); bf16 worst RMS from float32 "
              f"plain {ratio:.3f}x the plain bf16 path's (tol {BF16_NOISE_FACTOR}x)", flush=True)
        return dict(calls=len(self.rows), f32_rel_err=rel32, bf16_rms_ratio=ratio)


def _rms(a, b) -> float:
    return float((a - b).square().mean().sqrt())


def _ratio(a: float, b: float) -> float:
    return a / b if b > 0 else (0.0 if a == 0 else float("inf"))


def upcast_attention(q, k, v, causal=True, window=None):
    """The plain attention with no rounding inside: attention_ref on the
    inputs cast up to float32, rounded once to their dtype."""
    return attention_ref(q.float(), k.float(), v.float(), causal=causal,
                         window=window).to(q.dtype)


def upcast_decode(q, k, v, lengths):
    """decode_attention_ref on the inputs cast up, rounded once."""
    return decode_attention_ref(q.float(), k.float(), v.float(), lengths).to(q.dtype)


@contextlib.contextmanager
def recording_routes(routes):
    """Record each MoE layer's top-k expert sets (sorted) while in force."""
    real = moe_module._router

    def router(cfg, p, x2d):
        gates, idx, probs = real(cfg, p, x2d)
        routes.append(idx.sort(dim=-1).values)
        return gates, idx, probs

    moe_module._router = router
    try:
        yield routes
    finally:
        moe_module._router = real


def route_flips(a, b, n_layers) -> tuple:
    """(token, layer) rows whose top-k expert sets differ, the rows, and the
    differing rows by layer (the records run layer by layer, call by call)."""
    check(len(a) == len(b) > 0, "the two runs crossed different numbers of MoE layers")
    flips = [int((x != y).any(-1).sum()) for x, y in zip(a, b)]
    by_layer = [sum(flips[i::n_layers]) for i in range(n_layers)]
    return sum(flips), sum(x.shape[0] for x in a), by_layer


def path_logits(model, params, requests, done, recorder=None):
    """The whole model's logits through the kernels ("kernel"), the plain
    versions ("plain") and the plain versions without inner rounding
    ("upcast", ``upcast_*``), in bf16: one prompt's prefill, then
    DECODE_CHECK_STEPS decode steps at batch SERVE_B from one prefilled
    cache (keys ``"decode " + name``).  ``recorder(list)``, a context
    manager, records what each run sees.  Returns ``(logits, records)``."""
    cfg, dev = model.cfg, model.device
    record = recorder or contextlib.nullcontext
    rid, prompt, _ = requests[4]
    tokens = torch.tensor([prompt], device=dev)
    routes, out = {}, {}
    for name, hooks in (("kernel", {}), ("plain", dict(attn_fn=attention_ref)),
                        ("upcast", dict(attn_fn=upcast_attention))):
        m = LM(cfg, device=dev, **hooks)
        with torch.inference_mode(), record([]) as rec:
            lg, _ = m.prefill(params, {"tokens": tokens}, m.init_cache(1, len(prompt)))
        out[name], routes[name] = lg.float(), rec
    check(int(out["kernel"].argmax()) == done[rid][0], "prefill is not deterministic")

    engine = ServingEngine(model, params, max_batch=SERVE_B, max_seq=SERVE_C)
    for req in requests[:SERVE_B]:
        engine.add_request(*req)
    rng = np.random.default_rng(3)
    feed = [engine.tokens.clone()] + [
        torch.as_tensor(rng.integers(0, cfg.vocab, SERVE_B), device=dev)
        for _ in range(DECODE_CHECK_STEPS - 1)]
    pos0, caches0 = engine.pos.clone(), engine.caches
    del engine
    for name, fn in (("kernel", None), ("plain", decode_attention_ref),
                     ("upcast", upcast_decode)):
        m = LM(cfg, device=dev, decode_fn=fn)
        caches = _tree_map(lambda t: t.clone(), caches0)
        steps = []
        with torch.inference_mode(), record([]) as rec:
            for t in range(DECODE_CHECK_STEPS):
                lg, caches = m.decode_step(params, feed[t], pos0 + t, caches)
                steps.append(lg.float())
        out["decode " + name], routes["decode " + name] = torch.stack(steps), rec
        del caches
    del caches0
    torch.cuda.empty_cache()
    return out, routes


def hold_path_logits(tag, kern, plain, up, label, name):
    """The kernel path's logits within BF16_NOISE_FACTOR times the plain
    path's RMS distance from the upcast path's.  Returns the two RMS
    distances and the share of greedy tokens kernel and plain agree on."""
    check(bool(torch.isfinite(kern).all()), f"non-finite {name} logits")
    rms_kern, rms_plain = _rms(kern, up), _rms(plain, up)
    agree = float((kern.argmax(-1) == plain.argmax(-1)).float().mean())
    print(f"[{tag}] whole-model logits, {label}: RMS from the upcast plain path: kernel "
          f"{rms_kern:.4e}, plain bf16 {rms_plain:.4e} (tol {BF16_NOISE_FACTOR}x); RMS "
          f"kernel vs plain {_rms(kern, plain):.4e} (RMS of the logits "
          f"{float(plain.square().mean().sqrt()):.4e}); greedy tokens agree {agree:.3f}",
          flush=True)
    check(rms_kern <= BF16_NOISE_FACTOR * rms_plain,
          f"{name} logits through the kernels are {rms_kern:.4e} RMS from the upcast plain "
          f"path, beyond {BF16_NOISE_FACTOR} x the plain path's {rms_plain:.4e}")
    return dict(rms_kernel=rms_kern, rms_plain=rms_plain, greedy_agree=agree)


def moe_whole_model(model, params, requests, done):
    """The whole model's logits through the kernels, the plain versions and
    the plain versions without inner rounding (``path_logits``), held by
    ``hold_path_logits``; the (token, layer) top-k sets that differ between
    kernel and plain are counted, not required equal (a rounding can flip a
    near tie)."""
    cfg = model.cfg
    out, routes = path_logits(model, params, requests, done, recorder=recording_routes)
    line = {}
    for what in ("", "decode "):
        kern, plain, up = (out[what + n] for n in ("kernel", "plain", "upcast"))
        n_moe = cfg.n_layers - cfg.moe.n_dense_layers
        flips, rows, by_layer = route_flips(routes[what + "kernel"], routes[what + "plain"],
                                            n_moe)
        flips_up, _, _ = route_flips(routes[what + "upcast"], routes[what + "plain"], n_moe)
        name = "decode" if what else "prefill"
        label = (f"{DECODE_CHECK_STEPS} decode steps at batch {SERVE_B}" if what
                 else f"prefill of {len(requests[4][1])} tokens")
        held = hold_path_logits("moe", kern, plain, up, label, name)
        print(f"[moe] {label}: top-k sets that differ from the plain path's: kernel {flips}, "
              f"upcast {flips_up} of {rows} (token, layer) rows; kernel's by layer "
              f"{by_layer}", flush=True)
        line[name] = dict(held, route_flips=flips, route_flips_upcast=flips_up,
                          route_rows=rows, route_flips_by_layer=by_layer)
    return line


def dispatch_check(cfg, params, dev):
    """The sort route of ``moe_apply`` against the served einsum route on
    the first MoE layer's weights and a 512-token input drawn from a seed,
    with the capacity raised so that neither drops a claim (the two routes
    group and prioritise claims differently, so they agree only then)."""
    m = cfg.moe
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        m, capacity_factor=m.n_experts / m.top_k))
    p16 = _tree_map(lambda t: t[0], params["segments"][-1]["ffn"])
    gen = torch.Generator(device=dev).manual_seed(4)
    x16 = torch.randn((1, 512, cfg.d_model), generator=gen, device=dev).to(torch.bfloat16)
    out = {}
    with torch.inference_mode():
        for tag, c, p, x in (("16", cfg, p16, x16),
                             ("32", dataclasses.replace(cfg, dtype="float32"),
                              _tree_map(lambda t: t.float(), p16), x16.float())):
            for route in ("einsum", "sort"):
                out[tag, route] = moe_module.moe_apply(c, p, x, dispatch=route)[0].float()
    e32 = out["32", "einsum"]
    err32, scale = float((out["32", "sort"] - e32).abs().max()), float(e32.abs().max())
    rms_sort, rms_einsum = _rms(out["16", "sort"], e32), _rms(out["16", "einsum"], e32)
    print(f"[moe] sort dispatch vs einsum, one layer, 512 tokens, no drops: float32 max abs "
          f"diff {err32:.3e} (max |y| {scale:.4f}, tol {DISPATCH_F32_TOL} of it); bf16 RMS from "
          f"float32 einsum: sort {rms_sort:.4e}, einsum {rms_einsum:.4e} (tol "
          f"{BF16_NOISE_FACTOR}x)", flush=True)
    check(err32 <= DISPATCH_F32_TOL * scale,
          f"float32 sort dispatch differs from einsum by {err32:.4e}")
    check(rms_sort <= BF16_NOISE_FACTOR * rms_einsum,
          f"bf16 sort dispatch is {rms_sort:.4e} RMS from float32 einsum, beyond "
          f"{BF16_NOISE_FACTOR} x the bf16 einsum route's {rms_einsum:.4e}")
    return dict(f32_rel_err=err32 / scale, bf16_rms_ratio=_ratio(rms_sort, rms_einsum))


def moe_step_cost(cfg, params, lengths):
    """(bytes, operations) of one decode step at batch len(lengths) with the
    einsum dispatch, which sends its E*C rows (C = 1 at batch 8) through
    every expert: every weight read once except the embedding (only the
    batch's rows), the KV cache read up to each row's length and the new
    entries written, the float32 logits written; operations: 2 per
    multiply-add of every weight with the rows it meets (B tokens, E*C
    expert rows) and 4*D per (query head, valid slot) pair a layer."""
    B, m = len(lengths), cfg.moe
    d, n = cfg.d_model, cfg.n_layers
    C = max(int(np.ceil(B * m.top_k * m.capacity_factor / m.n_experts)), 1)
    expert_params = 3 * d * m.d_expert * m.n_experts * (n - m.n_dense_layers)
    all_params = sum(t.numel() for t in _leaves(params))
    embed = cfg.vocab * d
    kv = 2 * cfg.n_kv_heads * cfg.head_dim
    nbytes = (2 * (all_params - embed + B * d) + 2 * kv * n * (int(sum(lengths)) + B)
              + 4 * B * cfg.vocab)
    ops = (2 * B * (all_params - embed - expert_params) + 2 * C * expert_params
           + 4 * cfg.head_dim * cfg.n_heads * n * int(sum(lengths)))
    return nbytes, ops


def serve_and_hold(tag, model, params, n_attn):
    """Serve the requests through ``ServingEngine(SERVE_B, SERVE_C)``, the
    kernels' counts set to 0 just before: check that every prefill ran the
    attention kernel ``n_attn`` times, all through the tensor-core kernel,
    and every decode step the decode kernel ``n_attn`` times, that no WKV
    kernel ran, that the tokens are valid ids and the peak memory fits the
    card; then hold both kernels layer by layer on the path's own
    activations over SERVE_B prefills and DECODE_CHECK_STEPS decode steps.
    Returns ``(requests, done, prefill_s, step_s, wall, launches, peak,
    layer_line)``, ``launches`` the two kernels' on the served set."""
    cfg, dev = model.cfg, model.device
    requests = serve_requests_for(cfg)
    engine = ServingEngine(model, params, max_batch=SERVE_B, max_seq=SERVE_C)
    torch.cuda.synchronize()
    flash_attention.launches = flash_decode.launches = rwkv6_scan.launches = 0
    flash_attention.wgmma_launches = flash_attention.simt_launches = 0
    done, prefill_s, step_s, wall = serve(engine, requests)
    attn_launches, launches = flash_attention.launches, flash_decode.launches
    peak = torch.cuda.max_memory_allocated()
    check(attn_launches == n_attn * len(requests),
          f"flash_attention launched {attn_launches} times for {len(requests)} prefills "
          f"of {n_attn} attention layers")
    check(flash_attention.wgmma_launches == attn_launches,
          f"of {attn_launches} bf16 attention launches {flash_attention.wgmma_launches} went "
          f"through the tensor-core kernel")
    check(launches == n_attn * len(step_s),
          f"flash_decode launched {launches} times for {len(step_s)} decode steps "
          f"of {n_attn} attention layers")
    check(rwkv6_scan.launches == 0, f"the {tag} serving path launched the WKV kernel")
    total = torch.cuda.get_device_properties(0).total_memory
    check(peak < total, f"peak memory {peak} beyond the card's {total}")
    report_serve(tag, cfg, requests, done, prefill_s, step_s, wall)
    print(f"[{tag}] flash_attention launches {attn_launches} = {n_attn} layers x "
          f"{len(requests)} prefills, all through the tensor-core kernel at g = "
          f"{cfg.n_heads // cfg.n_kv_heads}, D={cfg.head_dim}; flash_decode launches "
          f"{launches} = {n_attn} layers x {len(step_s)} decode steps; peak memory "
          f"{peak / 2**30:.2f} GiB (weights and the batch-{SERVE_B} state included)",
          flush=True)
    del engine
    torch.cuda.empty_cache()

    hold_a = LayerHold(flash_attention, attention_ref)
    hold_d = LayerHold(flash_decode, decode_attention_ref)
    held = ServingEngine(LM(cfg, device=dev, attn_fn=hold_a, decode_fn=hold_d), params,
                         max_batch=SERVE_B, max_seq=SERVE_C)
    for req in requests[:SERVE_B]:
        held.add_request(*req)
    for _ in range(DECODE_CHECK_STEPS):
        held.step()
    del held
    torch.cuda.empty_cache()
    layer_line = {
        "flash_attention": hold_a.check(tag, f"flash_attention in every layer of "
                                             f"{SERVE_B} prefills"),
        "flash_decode": hold_d.check(tag, f"flash_decode in every layer of "
                                          f"{DECODE_CHECK_STEPS} decode steps at batch "
                                          f"{SERVE_B}"),
    }
    return (requests, done, prefill_s, step_s, wall, (attn_launches, launches), peak,
            layer_line)


def moe_phase(dev):
    """Phase 10: serve the requests on full-width Qwen1.5-MoE-A2.7B, hold its
    attention kernels layer by layer and the whole model's logits against
    the plain versions, fit ``T = m*k + c``, profile a decode step; then
    serve two requests on DeepSeek-V3 cut to 4 layers and hold its absorbed
    MLA decode against the expanded form.  Returns the ``moe`` line and the
    kernels' launches on the served set."""
    t_phase = time.perf_counter()
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 is on: the router must stay float32")
    cfg = get_config(MOE_ARCH)
    model = LM(cfg, device=dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    m = cfg.moe
    print(f"[moe] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads} "
          f"heads of {cfg.head_dim} ({cfg.n_kv_heads} kv), {m.n_experts} experts top-{m.top_k} "
          f"of width {m.d_expert} + {m.n_shared_experts} shared, capacity factor "
          f"{m.capacity_factor}, {m.dispatch} dispatch, vocab {cfg.vocab}, {cfg.dtype}; "
          f"{n_params} parameters ({cfg.param_count()} by ModelConfig.param_count), "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB, init "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    (requests, done, prefill_s, step_s, wall, (attn_launches, launches), peak,
     layer_line) = serve_and_hold("moe", model, params, cfg.n_layers)
    whole = moe_whole_model(model, params, requests, done)
    sort_line = dispatch_check(cfg, params, dev)
    fit = fit_phase("moe", model, params, (flash_attention,), (flash_decode,))

    nbytes, ops = moe_step_cost(cfg, params, SERVE_LENGTHS)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / BF16_OPS_PER_S * 1e3
    bound = max(t_bytes, t_ops)
    step_ms = 1e3 * float(np.median(step_s))
    print(f"[moe] decode-step bound at batch {SERVE_B} (first step's lengths): {nbytes} bytes "
          f"-> {t_bytes:.3f} ms, {ops} ops at the bf16 peak -> {t_ops:.3f} ms; bound "
          f"{bound:.3f} ms ({'bytes' if t_bytes >= t_ops else 'operations'}); median step "
          f"{step_ms:.2f} ms = {100 * bound / step_ms:.1f}% of bound", flush=True)
    engine = ServingEngine(model, params, max_batch=SERVE_B, max_seq=SERVE_C)
    for req in requests[:SERVE_B]:
        engine.add_request(*req)
    engine.step()
    profile_report("moe", engine.step)
    del engine, model, params
    torch.cuda.empty_cache()

    n_tok = sum(len(t) for t in done.values())
    line = {"moe": {
        "arch": cfg.name, "params": n_params,
        "prefill_ms": [1e3 * x for x in prefill_s], "prompts": list(SERVE_PROMPTS),
        "step_ms_median": step_ms, "steps": len(step_s), "tokens_per_s": n_tok / wall,
        "peak_gib": peak / 2**30, "step_bound_ms": bound,
        "step_bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "launches": {"flash_attention": attn_launches, "flash_decode": launches},
        "layer_check": layer_line, "whole_model": whole, "sort_vs_einsum": sort_line,
        "fit": dict(zip(("m", "c", "r2"), fit)),
        "deepseek": deepseek_part(dev),
    }}
    line["moe"]["seconds"] = time.perf_counter() - t_phase
    print(f"[moe] phase took {line['moe']['seconds']:.1f} s", flush=True)
    return line, attn_launches, launches


@contextlib.contextmanager
def holding_mla(rows):
    """While in force every MLA decode step (one token over a cache) also
    runs, on copies of the layer's cache, the absorbed and the expanded
    form in bf16 and in a float32 copy of the layer, and records
    (float32 max abs diff, max |out|, RMS of bf16 absorbed and of bf16
    expanded from float32 expanded)."""
    real = transformer_module.mla_apply

    def mla(cfg, p, x, positions, *, cache=None, absorbed=None, gapless=False):
        if cache is not None and x.shape[1] == 1:
            cfg32 = dataclasses.replace(cfg, dtype="float32")
            p32 = _tree_map(lambda t: t.float(), p)
            outs = {}
            for tag, c, pp, xx in (("16", cfg, p, x), ("32", cfg32, p32, x.float())):
                for form in (True, False):
                    kv = {key: val.to(torch.float32 if tag == "32" and val.is_floating_point()
                                      else val.dtype, copy=True) for key, val in cache.items()}
                    outs[tag, form] = real(c, pp, xx, positions, cache=kv,
                                           absorbed=form)[0].float()
            e32 = outs["32", False]
            rows.append((float((outs["32", True] - e32).abs().max()), float(e32.abs().max()),
                         _rms(outs["16", True], e32), _rms(outs["16", False], e32)))
        return real(cfg, p, x, positions, cache=cache, absorbed=absorbed, gapless=gapless)

    transformer_module.mla_apply = mla
    try:
        yield rows
    finally:
        transformer_module.mla_apply = real


def deepseek_part(dev):
    """DeepSeek-V3 at published widths, cut to its first DSV3_LAYERS layers
    (the three dense ones and the first MoE layer, all 256 experts): serve
    DSV3_REQUESTS requests (no kernel: MLA is plain torch, as in the JAX
    model), then hold the absorbed decode against the expanded form layer
    by layer over a few decode steps."""
    cfg = dataclasses.replace(get_config(DSV3_ARCH), n_layers=DSV3_LAYERS)
    model = LM(cfg, device=dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    m = cfg.moe
    print(f"[moe] {cfg.name} cut to {cfg.n_layers} layers ({m.n_dense_layers} dense, "
          f"{cfg.n_layers - m.n_dense_layers} MoE): d_model {cfg.d_model}, {cfg.n_heads} MLA "
          f"heads (q rank {cfg.mla.q_lora_rank}, kv rank {cfg.mla.kv_lora_rank}), "
          f"{m.n_experts} experts top-{m.top_k} of width {m.d_expert} + {m.n_shared_experts} "
          f"shared, {m.router_act} router, vocab {cfg.vocab}, {cfg.dtype}; {n_params} "
          f"parameters, {torch.cuda.memory_allocated() / 2**30:.2f} GiB, init "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    requests = serve_requests_for(cfg)[:DSV3_REQUESTS]
    engine = ServingEngine(model, params, max_batch=DSV3_REQUESTS, max_seq=SERVE_C)
    flash_attention.launches = flash_decode.launches = rwkv6_scan.launches = 0
    done, prefill_s, step_s, wall = serve(engine, requests)
    peak = torch.cuda.max_memory_allocated()
    check(flash_attention.launches == flash_decode.launches == rwkv6_scan.launches == 0,
          "the MLA serving path launched a kernel")
    report_serve("moe", cfg, requests, done, prefill_s, step_s, wall, batch=DSV3_REQUESTS)
    del engine

    # the held steps run eagerly from the engine's prefilled state, greedy
    # as the engine's steps: the hold syncs with the host, so the engine's
    # CUDA graph of the step could neither capture it nor replay it
    rows = []
    engine = ServingEngine(model, params, max_batch=DSV3_REQUESTS, max_seq=SERVE_C)
    for req in requests:
        engine.add_request(*req)
    tokens, pos, caches = engine.tokens, engine.pos, engine.caches
    with holding_mla(rows), torch.inference_mode():
        for _ in range(DECODE_CHECK_STEPS):
            logits, caches = model.decode_step(params, tokens, pos, caches)
            tokens, pos = logits.argmax(-1), pos + 1
    del engine, model, params, caches
    torch.cuda.empty_cache()
    check(len(rows) == DECODE_CHECK_STEPS * cfg.n_layers,
          f"{len(rows)} MLA decode calls held, wanted {DECODE_CHECK_STEPS * cfg.n_layers}")
    for i, (err32, scale, rms_abs, rms_exp) in enumerate(rows):
        check(err32 <= MLA_F32_TOL * scale,
              f"MLA call {i}: float32 absorbed differs from expanded by {err32:.4e}, beyond "
              f"{MLA_F32_TOL} x {scale:.4f}")
        check(rms_abs <= BF16_NOISE_FACTOR * rms_exp,
              f"MLA call {i}: bf16 absorbed is {rms_abs:.4e} RMS from float32 expanded, "
              f"beyond {BF16_NOISE_FACTOR} x bf16 expanded's {rms_exp:.4e}")
    rel32 = max(_ratio(r[0], r[1]) for r in rows)
    ratio = max(_ratio(r[2], r[3]) for r in rows)
    print(f"[moe] {cfg.name} absorbed MLA decode vs expanded, {len(rows)} (step, layer) calls "
          f"on the path's own inputs: float32 worst max abs diff {rel32:.3e} of max |out| "
          f"(tol {MLA_F32_TOL}); bf16 worst RMS from float32 expanded {ratio:.3f}x bf16 "
          f"expanded's (tol {BF16_NOISE_FACTOR}x); peak memory {peak / 2**30:.2f} GiB",
          flush=True)
    n_tok = sum(len(t) for t in done.values())
    return dict(arch=cfg.name, layers=cfg.n_layers, params=n_params, peak_gib=peak / 2**30,
                prefill_ms=[1e3 * x for x in prefill_s],
                step_ms_median=1e3 * float(np.median(step_s)), tokens_per_s=n_tok / wall,
                mla_calls=len(rows), mla_f32_rel_err=rel32, mla_bf16_rms_ratio=ratio)


# -- phase 11: the hybrid family ---------------------------------------------------
HYBRID_ARCH = "recurrentgemma-9b"
# the JAX LM.init's tree at full width, by jax.eval_shape (38 layers: 26 RG-LRU
# blocks and 12 local-attention blocks, each with its GeGLU MLP; the tied
# 256000 x 4096 embedding)
HYBRID_PARAMS = 8_578_519_040
# One layer's RG-LRU scan (ceil(log2 S) float32 doubling steps) against the
# sequential recurrence in float64 on the same (a, b): max |difference|
# within this share of max |h|.  Each doubling step rounds each term by a few
# ulps (6e-8); a channel with a near 1 sums ~1/(1-a) terms of mixed sign, so
# the error can reach sqrt(1000) ~ 30 times that of |h|: about 3e-5.
RGLRU_SCAN_TOL = 1e-4
# Past the window: one request of RING_PROMPT tokens and RING_NEW new ones
# through a ring of HYBRID_WINDOW slots (max_seq twice the window), so
# RING_PROMPT + RING_NEW - HYBRID_WINDOW = 48 decode steps run after the
# wrap; the step at RING_HOLD_POS is held layer by layer.
RING_PROMPT, RING_NEW, RING_HOLD_POS = 2000, 96, 2060


@contextlib.contextmanager
def recording_scans(rows):
    """While in force, the (a, b) of every RG-LRU scan (``linear_scan``)."""
    real = recurrent_module.linear_scan

    def scan(a, b):
        rows.append((a.clone(), b.clone()))
        return real(a, b)

    recurrent_module.linear_scan = scan
    try:
        yield rows
    finally:
        recurrent_module.linear_scan = real


def scan_check(model, params, prompt):
    """The first RG-LRU layer's scan of one prompt's prefill through the
    kernels, on its own (a, b), against the sequential recurrence in
    float64."""
    dev = model.device
    with torch.inference_mode(), recording_scans([]) as rows:
        model.prefill(params, {"tokens": torch.tensor([prompt], device=dev)},
                      model.init_cache(1, len(prompt)))
    n_rec = sum(seg.n * seg.n_rec for seg in model.segments)
    check(len(rows) == n_rec, f"{len(rows)} RG-LRU scans in a prefill of {n_rec} blocks")
    a, b = rows[0]
    del rows
    got = recurrent_module.linear_scan(a, b).double()
    a64, b64 = a.double(), b.double()
    ref, h = torch.empty_like(a64), torch.zeros_like(a64[:, 0])
    for t in range(a.shape[1]):
        h = a64[:, t] * h + b64[:, t]
        ref[:, t] = h
    err, scale = float((got - ref).abs().max()), float(ref.abs().max())
    print(f"[hybrid] RG-LRU scan of layer 0, {a.shape[1]} tokens x {a.shape[2]} channels, on "
          f"the path's own (a, b) (a in [{float(a.min()):.4f}, {float(a.max()):.4f}]): float32 "
          f"doubling scan vs sequential float64 max abs diff {err:.3e} (max |h| "
          f"{scale:.4f}, tol {RGLRU_SCAN_TOL} of it)", flush=True)
    check(err <= RGLRU_SCAN_TOL * scale,
          f"the RG-LRU scan differs from the float64 recurrence by {err:.3e}, beyond "
          f"{RGLRU_SCAN_TOL} x {scale:.4f}")
    return dict(tokens=a.shape[1], max_abs_err=err, max_abs_h=scale)


def ring_check(model, params, n_attn):
    """One request past the window: a RING_PROMPT-token prefill into a
    HYBRID_WINDOW-slot ring, then RING_NEW decode steps, 48 of them after
    the wrap; the step at RING_HOLD_POS held layer by layer (its decode
    calls all at lengths = HYBRID_WINDOW)."""
    cfg, dev = model.cfg, model.device
    prompt = np.random.default_rng(5).integers(0, cfg.vocab, RING_PROMPT).tolist()
    engine = ServingEngine(model, params, max_batch=1, max_seq=2 * HYBRID_WINDOW)
    check(engine.caches[0]["attn"]["k"].shape[2] == HYBRID_WINDOW,
          "the ring is not the window wide")
    hold, seen = LayerHold(flash_decode, decode_attention_ref), []

    def held(q, k, v, lengths):
        seen.append(lengths.tolist())
        return hold(q, k, v, lengths)

    held_model = LM(cfg, device=dev, decode_fn=held)
    flash_attention.launches = flash_decode.launches = 0
    t = time.perf_counter()
    engine.add_request("ring", prompt, RING_NEW)
    torch.cuda.synchronize()
    prefill_ms = 1e3 * (time.perf_counter() - t)
    check(flash_attention.launches == n_attn,
          f"a {RING_PROMPT}-token prefill launched flash_attention {flash_attention.launches} "
          f"times, wanted {n_attn}")
    done, steps, after_wrap = {}, 0, 0
    while engine.active:
        pos = engine.slots[0].pos
        engine.model = held_model if pos == RING_HOLD_POS else model
        done.update(engine.step())
        steps, after_wrap = steps + 1, after_wrap + (pos >= HYBRID_WINDOW)
    engine.model = model
    ring_pos = engine.caches[0]["attn"]["pos"]
    toks = done["ring"]
    check(len(toks) == RING_NEW + 1 and all(0 <= x < cfg.vocab for x in toks),
          "the request past the window did not get its tokens")
    check(after_wrap == RING_PROMPT + RING_NEW - HYBRID_WINDOW,
          f"{after_wrap} decode steps after the wrap")
    # the held step also runs the kernel once a layer on its inputs cast up
    check(flash_decode.launches == n_attn * (steps + 1),
          f"flash_decode launched {flash_decode.launches} times for {steps} steps")
    check(seen == [[HYBRID_WINDOW]] * n_attn, f"the held step's lengths were {seen}")
    check(int(ring_pos.max()) == RING_PROMPT + RING_NEW - 1
          and int(ring_pos.min()) == RING_PROMPT + RING_NEW - HYBRID_WINDOW,
          "the ring does not hold the last window of positions")
    line = hold.check("hybrid", f"flash_decode past the ring's wrap (position {RING_HOLD_POS}, "
                                f"lengths {HYBRID_WINDOW}), every layer")
    del engine
    torch.cuda.empty_cache()
    print(f"[hybrid] past the window: prefill of {RING_PROMPT} tokens {prefill_ms:.2f} ms "
          f"(flash_attention {n_attn} launches), {steps} decode steps, {after_wrap} after the "
          f"wrap; ring positions {int(ring_pos.min())}..{int(ring_pos.max())}", flush=True)
    return dict(prompt=RING_PROMPT, steps=steps, steps_after_wrap=after_wrap,
                prefill_ms=prefill_ms, hold=line)


def hybrid_step_cost(cfg, params, lengths, n_attn, n_rec):
    """(bytes, operations) of one decode step at batch len(lengths): every
    weight read once (the tied embedding is the lm_head), each attention
    layer's ring read up to each row's length and the new entries written,
    each RG-LRU block's state (h in float32, the conv window in bf16) read
    and written, the float32 logits written; operations: 2 per
    multiply-add of every weight with the batch's tokens and 4*D per (query
    head, valid slot) pair an attention layer."""
    B = len(lengths)
    all_params = sum(t.numel() for t in _leaves(params))
    W, cw = cfg.recurrent.lru_width, cfg.recurrent.conv_width
    kv = 2 * cfg.n_kv_heads * cfg.head_dim
    nbytes = (2 * all_params + 2 * kv * n_attn * (int(sum(lengths)) + B)
              + 2 * n_rec * B * (4 * W + 2 * (cw - 1) * W) + 4 * B * cfg.vocab)
    ops = 2 * B * all_params + 4 * cfg.head_dim * cfg.n_heads * n_attn * int(sum(lengths))
    return nbytes, ops


def hybrid_phase(dev):
    """Phase 11: serve the requests on full-width RecurrentGemma-9B, hold its
    attention kernels layer by layer and the whole model's logits against
    the plain versions, one RG-LRU scan against the float64 recurrence,
    serve one request past the window, fit ``T = m*k + c``, profile a decode
    step.  Returns the ``hybrid`` line and the kernels' launches on the
    served set."""
    t_phase = time.perf_counter()
    cfg = get_config(HYBRID_ARCH)
    model = LM(cfg, device=dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    n_attn = sum(seg.n for seg in model.segments if seg.has_attn)
    n_rec = sum(seg.n * seg.n_rec for seg in model.segments)
    r = cfg.recurrent
    print(f"[hybrid] {cfg.name}: {cfg.n_layers} layers ({n_rec} RG-LRU of width "
          f"{r.lru_width}, conv {r.conv_width}; {n_attn} local attention, window "
          f"{cfg.attn_window}), d_model {cfg.d_model}, {cfg.n_heads} heads of {cfg.head_dim} "
          f"({cfg.n_kv_heads} kv), GeGLU d_ff {cfg.d_ff}, vocab {cfg.vocab}, {cfg.dtype}; "
          f"{n_params} parameters, {torch.cuda.memory_allocated() / 2**30:.2f} GiB, init "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    check(n_params == HYBRID_PARAMS, f"{n_params} parameters, the JAX tree has {HYBRID_PARAMS}")

    (requests, done, prefill_s, step_s, wall, (attn_launches, launches), peak,
     layer_line) = serve_and_hold("hybrid", model, params, n_attn)
    out, _ = path_logits(model, params, requests, done)
    whole = {}
    for what, label in (("", f"prefill of {len(requests[4][1])} tokens"),
                        ("decode ", f"{DECODE_CHECK_STEPS} decode steps at batch {SERVE_B}")):
        name = "decode" if what else "prefill"
        whole[name] = hold_path_logits("hybrid", *(out[what + n] for n in
                                                    ("kernel", "plain", "upcast")), label, name)
    del out
    scan = scan_check(model, params, requests[4][1])
    ring = ring_check(model, params, n_attn)
    fit = fit_phase("hybrid", model, params, (flash_attention,), (flash_decode,),
                    per_call=n_attn)

    nbytes, ops = hybrid_step_cost(cfg, params, SERVE_LENGTHS, n_attn, n_rec)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / BF16_OPS_PER_S * 1e3
    bound = max(t_bytes, t_ops)
    step_ms = 1e3 * float(np.median(step_s))
    print(f"[hybrid] decode-step bound at batch {SERVE_B} (first step's lengths): {nbytes} "
          f"bytes -> {t_bytes:.3f} ms, {ops} ops at the bf16 peak -> {t_ops:.3f} ms; bound "
          f"{bound:.3f} ms ({'bytes' if t_bytes >= t_ops else 'operations'}); median step "
          f"{step_ms:.2f} ms = {100 * bound / step_ms:.1f}% of bound", flush=True)
    engine = ServingEngine(model, params, max_batch=SERVE_B, max_seq=SERVE_C)
    for req in requests[:SERVE_B]:
        engine.add_request(*req)
    engine.step()
    profile_report("hybrid", engine.step)
    del engine, model, params
    torch.cuda.empty_cache()

    n_tok = sum(len(t) for t in done.values())
    line = {"hybrid": {
        "arch": cfg.name, "params": n_params,
        "prefill_ms": [1e3 * x for x in prefill_s], "prompts": list(SERVE_PROMPTS),
        "step_ms_median": step_ms, "steps": len(step_s), "tokens_per_s": n_tok / wall,
        "peak_gib": peak / 2**30, "step_bound_ms": bound,
        "step_bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "launches": {"flash_attention": attn_launches, "flash_decode": launches},
        "layer_check": layer_line, "whole_model": whole, "rglru_scan": scan,
        "past_the_window": ring, "fit": dict(zip(("m", "c", "r2"), fit)),
    }}
    line["hybrid"]["seconds"] = time.perf_counter() - t_phase
    print(f"[hybrid] phase took {line['hybrid']['seconds']:.1f} s", flush=True)
    return line, attn_launches, launches


# -- phase 12: the vlm and audio families --------------------------------------
VLM_ARCH = "qwen2-vl-72b"
# 80 layers of bf16 weights are 145 GB: served cut to 24 layers (47.1 GB),
# trained cut to 4 (weights, gradients and two bf16 AdamW moments 48.0 GB)
VLM_SERVE_LAYERS, VLM_TRAIN_LAYERS = 24, 4
VLM_TRAIN_B, VLM_TRAIN_S, VLM_TRAIN_STEPS = 1, 2048, 4
# the JAX LM.init's tree at full width, by jax.eval_shape: the embedding,
# lm_head and final norm, and each layer (GQA with its QKV bias, SwiGLU)
VLM_OUTER_PARAMS, VLM_LAYER_PARAMS = 2_491_424_768, 877_684_736
# The M-RoPE check: a prompt of MROPE_TEXT text tokens, an image of
# MROPE_GRID = (t, h, w) merged patches, then text, its ids laid out as
# Qwen2-VL's get_rope_index lays them out
MROPE_TEXT, MROPE_GRID = 16, (1, 16, 24)
WHISPER_ARCH, WHISPER_PARAMS = "whisper-tiny", 36_448_128
WHISPER_TRAIN_B, WHISPER_TRAIN_STEPS = 8, 6


def mrope_ids(n, dev):
    """(3, 1, n) M-RoPE ids of MROPE_TEXT text tokens (all three streams
    0..MROPE_TEXT-1), a t x h x w image (each stream its own grid index plus
    MROPE_TEXT), then text counting on from one past the largest id so far,
    as Qwen2-VL's get_rope_index gives them."""
    t, h, w = MROPE_GRID
    text0 = np.broadcast_to(np.arange(MROPE_TEXT), (3, MROPE_TEXT))
    ti, hi, wi = np.meshgrid(np.arange(t), np.arange(h), np.arange(w), indexing="ij")
    img = np.stack([ti.ravel(), hi.ravel(), wi.ravel()]) + MROPE_TEXT
    rest = n - MROPE_TEXT - img.shape[1]
    check(rest > 0, f"a prompt of {n} ids leaves no text after the image")
    text1 = np.broadcast_to(img.max() + 1 + np.arange(rest), (3, rest))
    ids = np.concatenate([text0, img, text1], axis=1)[:, None, :]
    return torch.as_tensor(ids, dtype=torch.int32, device=dev)


def held_prefill_decode(tag, model, params, batch, capacity, feed, what, step_ids=None):
    """One prefill of ``batch`` into a cache of ``capacity`` slots, then a
    decode step for each token row of ``feed`` (with ``step_ids[t]``, (3, B,
    1) M-RoPE ids, if given), through four models on the same weights: the
    kernels with ``LayerHold`` on both (every attention call held layer by
    layer on the path's own activations), the kernels alone (their launches
    counted), the plain versions, and the plain versions without inner
    rounding; the whole model's logits held by ``hold_path_logits``.
    Returns ``(line, launches of the kernels' run (prefill, decode), the
    kernels' prefill logits)``."""
    cfg, dev = model.cfg, model.device
    B, S = batch["tokens"].shape
    hold_a = LayerHold(flash_attention, attention_ref)
    hold_d = LayerHold(flash_decode, decode_attention_ref)
    runs = (("held", dict(attn_fn=hold_a, decode_fn=hold_d)), ("kernel", {}),
            ("plain", dict(attn_fn=attention_ref, decode_fn=decode_attention_ref)),
            ("upcast", dict(attn_fn=upcast_attention, decode_fn=upcast_decode)))
    out, launches = {}, None
    for name, hooks in runs:
        m = LM(cfg, device=dev, **hooks)
        flash_attention.launches = flash_decode.launches = 0
        with torch.inference_mode():
            lg, caches = m.prefill(params, batch, m.init_cache(B, capacity))
            n_prefill = flash_attention.launches
            steps = []
            for t, tok in enumerate(feed):
                pos = torch.full((B,), S + t, dtype=torch.int32, device=dev)
                ids = None if step_ids is None else step_ids[t]
                lg_t, caches = m.decode_step(params, tok, pos, caches, ids)
                steps.append(lg_t.float())
        if name == "kernel":
            launches = (n_prefill, flash_decode.launches)
        out[name], out["decode " + name] = lg.float(), torch.stack(steps)
        del caches, m
        torch.cuda.empty_cache()
    line = {
        "flash_attention": hold_a.check(tag, f"flash_attention in every layer of the {what} "
                                             f"prefill"),
        "flash_decode": hold_d.check(tag, f"flash_decode in every layer of {len(feed)} {what} "
                                          f"decode steps at batch {B}"),
    }
    for key, label in (("", f"{what} prefill of {S} tokens at batch {B}"),
                       ("decode ", f"{len(feed)} {what} decode steps at batch {B}")):
        name = "decode" if key else "prefill"
        line[name] = hold_path_logits(tag, *(out[key + n] for n in ("kernel", "plain", "upcast")),
                                      label, f"{what} {name}")
    return line, launches, out["kernel"]


def dense_step_cost(cfg, params, lengths):
    """(bytes, operations) of one decode step at batch len(lengths) of a
    model whose embedding is a lookup table apart from its lm_head: every
    weight read once except the embedding (only the batch's rows), the KV
    cache read up to each row's length and the new entries written, the
    float32 logits written; operations: 2 per multiply-add of every weight
    but the embedding with the batch's tokens and 4*D per (query head,
    valid slot) pair a layer."""
    B, d, n = len(lengths), cfg.d_model, cfg.n_layers
    weights = sum(t.numel() for t in _leaves(params)) - cfg.vocab * d
    kv = 2 * cfg.n_kv_heads * cfg.head_dim
    nbytes = 2 * (weights + B * d) + 2 * kv * n * (int(sum(lengths)) + B) + 4 * B * cfg.vocab
    ops = 2 * B * weights + 4 * cfg.head_dim * cfg.n_heads * n * int(sum(lengths))
    return nbytes, ops


def vlm_serve_part(dev):
    """(a) Serve the requests on Qwen2-VL-72B at published width cut to
    VLM_SERVE_LAYERS layers (text: RoPE on positions, the M-RoPE of text),
    hold both kernels layer by layer and the whole model's logits; then one
    prefill and DECODE_CHECK_STEPS decode steps with image-then-text M-RoPE
    ids, held the same way.  Returns the part's line and the kernels'
    launches on the served set."""
    cfg = dataclasses.replace(get_config(VLM_ARCH), n_layers=VLM_SERVE_LAYERS)
    model = LM(cfg, device=dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"[vlm] {cfg.name} cut to {cfg.n_layers} layers: d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads of {cfg.head_dim} ({cfg.n_kv_heads} kv, QKV bias), SwiGLU d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab}, M-RoPE sections {cfg.mrope_sections}, {cfg.dtype}; "
          f"{n_params} parameters, {torch.cuda.memory_allocated() / 2**30:.2f} GiB, init "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    want = VLM_OUTER_PARAMS + cfg.n_layers * VLM_LAYER_PARAMS
    check(n_params == want, f"{n_params} parameters, the JAX tree has {want}")

    (requests, done, prefill_s, step_s, wall, (attn_launches, launches), peak,
     layer_line) = serve_and_hold("vlm", model, params, cfg.n_layers)
    out, _ = path_logits(model, params, requests, done)
    whole = {}
    for what, label in (("", f"prefill of {len(requests[4][1])} tokens"),
                        ("decode ", f"{DECODE_CHECK_STEPS} decode steps at batch {SERVE_B}")):
        name = "decode" if what else "prefill"
        whole[name] = hold_path_logits("vlm", *(out[what + n] for n in
                                                 ("kernel", "plain", "upcast")), label, name)
    text_logits = out["kernel"]
    del out

    # M-RoPE on the card: image-grid ids, then text
    prompt = requests[4][1]
    S = len(prompt)
    ids = mrope_ids(S + DECODE_CHECK_STEPS, dev)
    rng = np.random.default_rng(4)
    feed = [torch.as_tensor(rng.integers(0, cfg.vocab, 1), device=dev)
            for _ in range(DECODE_CHECK_STEPS)]
    batch = {"tokens": torch.tensor([prompt], device=dev), "position_ids": ids[:, :, :S]}
    mrope, (n_pre, n_dec), mrope_logits = held_prefill_decode(
        "vlm", model, params, batch, S + DECODE_CHECK_STEPS, feed, "M-RoPE",
        step_ids=[ids[:, :, S + t:S + t + 1] for t in range(DECODE_CHECK_STEPS)])
    check(n_pre == cfg.n_layers and n_dec == cfg.n_layers * DECODE_CHECK_STEPS,
          f"the M-RoPE prefill launched flash_attention {n_pre} times and its "
          f"{DECODE_CHECK_STEPS} decode steps flash_decode {n_dec} times")
    moved = _rms(mrope_logits, text_logits)
    check(moved > 0, "the M-RoPE ids did not change the prefill's logits")
    t, h, w = MROPE_GRID
    print(f"[vlm] M-RoPE: {MROPE_TEXT} text tokens, a {t}x{h}x{w} image, then text ({S} ids, "
          f"the largest {int(ids.max())}); flash_attention {n_pre} launches in the prefill, "
          f"flash_decode {n_dec} in {DECODE_CHECK_STEPS} steps; RMS of the prefill logits from "
          f"the same prompt's text prefill {moved:.4e}", flush=True)
    mrope["rms_from_text_prefill"] = moved

    nbytes, ops = dense_step_cost(cfg, params, SERVE_LENGTHS)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / BF16_OPS_PER_S * 1e3
    bound = max(t_bytes, t_ops)
    step_ms = 1e3 * float(np.median(step_s))
    print(f"[vlm] decode-step bound at batch {SERVE_B} (first step's lengths): {nbytes} bytes "
          f"-> {t_bytes:.3f} ms, {ops} ops at the bf16 peak -> {t_ops:.3f} ms; bound "
          f"{bound:.3f} ms ({'bytes' if t_bytes >= t_ops else 'operations'}); median step "
          f"{step_ms:.2f} ms = {100 * bound / step_ms:.1f}% of bound", flush=True)
    engine = ServingEngine(model, params, max_batch=SERVE_B, max_seq=SERVE_C)
    for req in requests[:SERVE_B]:
        engine.add_request(*req)
    engine.step()
    profile_report("vlm", engine.step)
    del engine, model, params
    torch.cuda.empty_cache()
    n_tok = sum(len(t) for t in done.values())
    line = dict(arch=cfg.name, layers=cfg.n_layers, params=n_params,
                prefill_ms=[1e3 * x for x in prefill_s], prompts=list(SERVE_PROMPTS),
                step_ms_median=step_ms, steps=len(step_s), tokens_per_s=n_tok / wall,
                peak_gib=peak / 2**30, step_bound_ms=bound,
                step_bound_by="bytes" if t_bytes >= t_ops else "operations",
                launches={"flash_attention": attn_launches, "flash_decode": launches},
                layer_check=layer_line, whole_model=whole, mrope=mrope)
    return line, attn_launches, launches


def vlm_train_part(dev):
    """(b) Train Qwen2-VL-72B at published width cut to VLM_TRAIN_LAYERS
    layers through ``make_train_step`` (AdamW on the trainer's schedule), on
    the stream's batches with the trainer's text ``position_ids``; check the
    kernel's launches, finite losses and step 1 against the plain
    attention.  Returns the part's line and the launches."""
    cfg = dataclasses.replace(get_config(VLM_ARCH), n_layers=VLM_TRAIN_LAYERS)
    B, S, steps = VLM_TRAIN_B, VLM_TRAIN_S, VLM_TRAIN_STEPS
    model = LM(cfg, device=dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    n_params = sum(t.numel() for t in _leaves(params))
    want = VLM_OUTER_PARAMS + cfg.n_layers * VLM_LAYER_PARAMS
    check(n_params == want, f"{n_params} parameters, the JAX tree has {want}")
    optimizer = AdamW(lr=cosine_with_warmup(3e-3, warmup=max(steps // 10, 1), total=steps))
    step_fn = make_train_step(model, optimizer)
    opt_state = optimizer.init(params)
    print(f"[vlm] {cfg.name} cut to {cfg.n_layers} layers for training: {n_params} parameters; "
          f"B={B} S={S}, {steps} AdamW steps; weights and state "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB", flush=True)
    stream = iter(SyntheticLM(cfg.vocab, B, S, seed=0))
    flash_attention.launches = rwkv6_scan.launches = flash_decode.launches = 0
    flash_attention.wgmma_launches = flash_attention.simt_launches = 0
    losses, gnorms, step_s = [], [], []
    for _ in range(steps):
        batch = to_device(frontend_stubs(cfg, next(stream)), dev)
        t = time.perf_counter()
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
        losses.append(float(metrics["loss"]))
        gnorms.append(float(metrics["grad_norm"]))
    launches = flash_attention.launches
    peak = torch.cuda.max_memory_allocated()
    total = torch.cuda.get_device_properties(0).total_memory
    check(peak < total, f"peak memory {peak} beyond the card's {total}")
    check(sorted(batch) == ["labels", "position_ids", "tokens"],
          f"the train batch holds {sorted(batch)}")
    check(launches == cfg.n_layers * steps,
          f"flash_attention launched {launches} times for {steps} forward passes of "
          f"{cfg.n_layers} layers")
    check(flash_attention.wgmma_launches == launches,
          f"of {launches} bf16 attention launches {flash_attention.wgmma_launches} went "
          f"through the tensor-core kernel")
    check(rwkv6_scan.launches == flash_decode.launches == 0,
          "the vlm training path launched another kernel")
    check(bool(np.isfinite(losses).all() and np.isfinite(gnorms).all()),
          f"non-finite loss or gradient norm: {losses} {gnorms}")
    step_ms = 1e3 * np.asarray(step_s)
    print(f"[vlm] train losses {[round(x, 5) for x in losses]}; gradient norms "
          f"{[round(x, 5) for x in gnorms]}; step ms {[round(float(x), 2) for x in step_ms]} "
          f"(the first cold), median {np.median(step_ms):.2f}; "
          f"{B * S / np.median(step_ms) * 1e3:.1f} tokens/s at the median; peak memory "
          f"{peak / 2**30:.2f} GiB (of {total / 2**30:.2f}); "
          f"flash_attention launches {launches} = {cfg.n_layers} layers x {steps} forward "
          f"passes, all through the tensor-core kernel (g = {cfg.n_heads // cfg.n_kv_heads}, "
          f"D={cfg.head_dim})", flush=True)
    del params, opt_state, step_fn, model, batch, metrics
    torch.cuda.empty_cache()
    step1 = step1_check(cfg, dev, (losses[0], gnorms[0]), "vlm", (B, S))
    line = dict(arch=cfg.name, layers=cfg.n_layers, cut="published width, "
                f"{VLM_TRAIN_LAYERS} of {get_config(VLM_ARCH).n_layers} layers",
                params=n_params, batch=B, seq=S, losses=losses, grad_norms=gnorms,
                step_ms=step_ms.tolist(), step_ms_median=float(np.median(step_ms)),
                peak_gib=peak / 2**30, launches=launches, step1=step1)
    return line, launches


def whisper_decode_part(dev):
    """(d) Decode Whisper-tiny through ``LM.prefill`` (the encoder over
    SERVE_B x 1500 frames drawn from a seed, a WHISPER_PROMPT-token prompt)
    and WHISPER_NEW greedy ``LM.decode_step``s over a WHISPER_C-slot self
    cache and the 1500-slot cross cache; check the kernels' launches and the
    tokens, then hold both kernels layer by layer and the whole model's
    logits over a prefill and DECODE_CHECK_STEPS steps.  Returns the part's
    line and the launches."""
    cfg = get_config(WHISPER_ARCH)
    model = LM(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    n_params = sum(t.numel() for t in _leaves(params))
    check(n_params == WHISPER_PARAMS, f"{n_params} parameters, the JAX tree has {WHISPER_PARAMS}")
    B = SERVE_B
    gen = torch.Generator(device=dev).manual_seed(1)
    frames = torch.randn((B, cfg.enc_len, cfg.d_model), generator=gen, device=dev)
    rng = np.random.default_rng(2)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab, (B, WHISPER_PROMPT)), device=dev)
    batch = {"tokens": prompt, "frames": frames}
    flash_attention.launches = flash_decode.launches = rwkv6_scan.launches = 0
    flash_attention.wgmma_launches = flash_attention.simt_launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        caches = model.init_cache(B, WHISPER_C)
        t = time.perf_counter()
        lg, caches = model.prefill(params, batch, caches)
        torch.cuda.synchronize()
        prefill_ms = 1e3 * (time.perf_counter() - t)
        check(flash_attention.launches == cfg.n_layers,
              f"the prefill launched flash_attention {flash_attention.launches} times")
        toks, step_s = [lg.argmax(-1)], []
        for i in range(WHISPER_NEW):
            pos = torch.full((B,), WHISPER_PROMPT + i, dtype=torch.int32, device=dev)
            t = time.perf_counter()
            lg, caches = model.decode_step(params, toks[-1], pos, caches)
            toks.append(lg.argmax(-1))
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t)
    attn_launches, launches = flash_attention.launches, flash_decode.launches
    peak = torch.cuda.max_memory_allocated()
    check(flash_attention.wgmma_launches == attn_launches,
          "a bf16 attention launch missed the tensor-core kernel")
    check(launches == cfg.n_layers * WHISPER_NEW,
          f"flash_decode launched {launches} times for {WHISPER_NEW} steps of {cfg.n_layers} "
          f"layers")
    check(rwkv6_scan.launches == 0, "the whisper decode path launched the WKV kernel")
    out = torch.stack(toks, 1)
    check(bool(((out >= 0) & (out < cfg.vocab)).all()), "a decoded token id is out of range")
    self_pos = caches[1]["self"]["pos"]
    check(int(self_pos.max()) == WHISPER_PROMPT + WHISPER_NEW - 1
          and int(caches[1]["cross"]["pos"].max()) == cfg.enc_len - 1,
          "the self and cross caches do not hold the positions written")
    del caches
    step_ms = 1e3 * np.asarray(step_s)
    print(f"[whisper] {cfg.name}: {cfg.n_layers} + {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads of {cfg.head_dim}, vocab {cfg.vocab}, {cfg.dtype}; {n_params} "
          f"parameters; decode at batch {B}: prefill of {WHISPER_PROMPT} tokens over "
          f"{cfg.enc_len} frames (the encoder included) {prefill_ms:.2f} ms; {WHISPER_NEW} "
          f"greedy steps over a {WHISPER_C}-slot self cache and the {cfg.enc_len}-slot cross "
          f"cache: median {np.median(step_ms):.2f} ms, min {step_ms.min():.2f}, max "
          f"{step_ms.max():.2f}; {B * WHISPER_NEW / step_ms.sum() * 1e3:.1f} tokens/s over the "
          f"steps; flash_attention {attn_launches} launches, flash_decode {launches} = "
          f"{cfg.n_layers} layers x {WHISPER_NEW} steps (D={cfg.head_dim}, g = 1); peak memory "
          f"{peak / 2**30:.2f} GiB", flush=True)
    print(f"[whisper] greedy tokens of row 0: {out[0].tolist()}", flush=True)

    feed = [torch.as_tensor(rng.integers(0, cfg.vocab, B), device=dev)
            for _ in range(DECODE_CHECK_STEPS)]
    held, (n_pre, n_dec), _ = held_prefill_decode("whisper", model, params, batch, WHISPER_C,
                                                  feed, "whisper")
    check(n_pre == cfg.n_layers and n_dec == cfg.n_layers * DECODE_CHECK_STEPS,
          f"the held run launched flash_attention {n_pre} and flash_decode {n_dec} times")
    del model, params
    torch.cuda.empty_cache()
    line = dict(arch=cfg.name, params=n_params, batch=B, frames=cfg.enc_len,
                prompt=WHISPER_PROMPT, steps=WHISPER_NEW, prefill_ms=prefill_ms,
                step_ms_median=float(np.median(step_ms)), peak_gib=peak / 2**30,
                launches={"flash_attention": attn_launches, "flash_decode": launches},
                check=held)
    return line, attn_launches, launches


def vlm_audio_phase(dev):
    """Phase 12: (a) serve Qwen2-VL-72B cut to 24 layers, and run M-RoPE on
    the card; (b) train it cut to 4 layers; (c) train Whisper-tiny uncut
    through ``train()``; (d) decode Whisper-tiny through the model.  Returns
    the ``vlm_audio`` line and each path's kernel launches."""
    t_phase = time.perf_counter()
    serve_line, vlm_attn, vlm_dec = vlm_serve_part(dev)
    torch.cuda.empty_cache()
    train_line, vlm_train = vlm_train_part(dev)
    torch.cuda.empty_cache()
    whisper_train, _, whisper_train_line = train_phase(
        dev, "whisper", WHISPER_ARCH, WHISPER_TRAIN_B, WHISPER_C, WHISPER_TRAIN_STEPS)
    torch.cuda.empty_cache()
    decode_line, whisper_attn, whisper_dec = whisper_decode_part(dev)
    line = {"vlm_audio": {"vlm_serve": serve_line, "vlm_train": train_line,
                          "whisper_train": whisper_train_line, "whisper_decode": decode_line}}
    line["vlm_audio"]["seconds"] = time.perf_counter() - t_phase
    print(f"[vlm-audio] phase took {line['vlm_audio']['seconds']:.1f} s", flush=True)
    attn = {"vlm serve": vlm_attn, "vlm train": vlm_train, "whisper train": whisper_train,
            "whisper decode": whisper_attn}
    dec = {"vlm serve": vlm_dec, "whisper decode": whisper_dec}
    return line, attn, dec


# -- phase 13: train the MoE and hybrid families -------------------------------------
# (arch, B, S, steps): Qwen1.5-MoE at its serving context, RecurrentGemma past
# its 2048-token window, so the kernel's window masks; both through
# make_train_step(model, Adafactor(lr=1e-3)) with remat="block", as the JAX
# dry-run composes them for its big configs
MOE_HYBRID_TRAIN = (("qwen2-moe-a2.7b", 1, 2048, 4), ("recurrentgemma-9b", 1, 4096, 4))
# the share of the card's memory the dry-run's traced peak may take before
# the run cuts the model in depth (room for the allocator's fragmentation)
TRAIN_MEMORY_SHARE = 0.9
# the traced peak against the card's max_memory_allocated over the steps
# (phase 13's models; the twin of phase 14 (e) within TWIN_PEAK_RTOL): room
# for the caching allocator's 512-byte rounding and the cuBLAS workspaces
# (32 MiB a handle and stream) it hands out, which no aten op makes
TRAIN_PEAK_RTOL = 0.01
# the softmax backward at RecurrentGemma-9B's training attention (B, Hk, g,
# S, S), whose CUDA kernel's own buffers memtrace.CUDA_TEMPS prices
SOFTMAX_CHECK_SHAPE = (1, 1, 16, 4096, 4096)
# the one-card mesh the dry-run prices phase 13's models on
ONE_CARD = AbstractMesh((1, 1, 1), ("pod", "data", "model"))
# step 1 on the full models: the kernel's bf16 loss and gradient norm
# against the plain attention's bf16 ones within two bf16 ulps of the value
# (no float32 copy of the full model fits; phase 7's float32 and bf16 rules
# run on a copy cut to STEP1_CUT_UNITS layers, or to one hybrid group of
# (rec, rec, attn), so the copy keeps an attention layer)
STEP1_BF16_REL = 2.0 ** -7
STEP1_CUT_UNITS = 2
# the remat comparison: phase 7's model and shape, REMAT_STEPS AdamW steps
# under each policy; gradient norms within REMAT_GNORM_RTOL (the embedding
# backward's atomics may sum in another order on the card); losses equal
REMAT_STEPS, REMAT_GNORM_RTOL = 3, 1e-3


def traced_peak(cfg, B, S, optimizer="adafactor"):
    """``(bytes, memory record)``: the dry-run's traced peak of a train step
    of ``cfg`` at (B, S) with ``optimizer`` on the one-card mesh (the step
    traced on the meta device, its live bytes logged op by op, the
    optimizer's update priced in the card's slices)."""
    cell = dryrun.build_cell(cfg.name, ShapeSpec("train", "train", S, B), opt=optimizer,
                             cfg=cfg)
    mem = dryrun.cell_memory(cell, dryrun.trace_cell(cell), ONE_CARD)
    return mem["peak_bytes"], mem


def fitted_config(tag, arch, B, S):
    """The config phase 13 trains: uncut if its traced peak fits
    TRAIN_MEMORY_SHARE of the card, else cut in depth (whole hybrid
    groups) until it does.  Prints the peak and the decision."""
    full = dataclasses.replace(get_config(arch), remat="block")
    budget = TRAIN_MEMORY_SHARE * torch.cuda.get_device_properties(0).total_memory
    step = len(full.recurrent.pattern) if full.family == "hybrid" else 1
    cfg = full
    t = time.perf_counter()
    while True:
        total, mem = traced_peak(cfg, B, S)
        if total <= budget or cfg.n_layers <= step:
            break
        cfg = dataclasses.replace(cfg, n_layers=cfg.n_layers - step)
    print(f"[{tag}] traced peak for {cfg.name} at {cfg.n_layers} of {full.n_layers} layers, "
          f"B={B} S={S}, Adafactor, remat block, on the one-card mesh: "
          f"{total / 2**30:.2f} GiB ({total / 1e9:.2f} GB) against {budget / 2**30:.2f} GiB "
          f"({TRAIN_MEMORY_SHARE} of the card); its parts at the peak (GiB): "
          + ", ".join(f"{k} {v / 2**30:.2f}" for k, v in mem["peak_parts"].items())
          + f"; traced in {time.perf_counter() - t:.1f} s", flush=True)
    check(total <= budget, f"{cfg.name} does not fit the card even at {cfg.n_layers} layers")
    cut = ("uncut" if cfg.n_layers == full.n_layers
           else f"cut in depth to {cfg.n_layers} of {full.n_layers} layers by the traced peak")
    print(f"[{tag}] {cfg.name} trains {cut}", flush=True)
    return cfg, total, mem, cut


def adafactor_train(tag, cfg, dev, B, S, steps):
    """Train ``cfg`` (remat="block") through ``make_train_step(model,
    Adafactor(lr=1e-3))`` on the trainer's batches for ``steps`` steps, then
    one profiled step.  Checks two attention launches a layer a step (the
    forward and its recompute), finite losses, gradient norms and aux loss.
    Returns the part's numbers."""
    model = LM(cfg, device=dev)
    n_attn = sum(seg.n for seg in model.segments
                 if seg.kind == "attn" or (seg.kind == "group" and seg.has_attn))
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    optimizer = Adafactor(lr=1e-3)
    opt_state = optimizer.init(params)
    step_fn = make_train_step(model, optimizer)
    init_peak = torch.cuda.max_memory_allocated() - base
    torch.cuda.reset_peak_memory_stats()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"[{tag}] {cfg.name}: {n_params} parameters, weights and Adafactor state "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB, init "
          f"{time.perf_counter() - t0:.1f} s; B={B} S={S}, {steps} steps, remat {cfg.remat}",
          flush=True)
    stream = iter(SyntheticLM(cfg.vocab, B, S, seed=0))
    flash_attention.launches = rwkv6_scan.launches = flash_decode.launches = 0
    flash_attention.wgmma_launches = flash_attention.simt_launches = 0
    losses, gnorms, auxes, step_s = [], [], [], []
    for _ in range(steps):
        batch = to_device(frontend_stubs(cfg, next(stream)), dev)
        t = time.perf_counter()
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
        losses.append(float(metrics["loss"]))
        gnorms.append(float(metrics["grad_norm"]))
        auxes.append(float(metrics["moe_aux"]))
    launches = flash_attention.launches
    peak = torch.cuda.max_memory_allocated() - base
    total = torch.cuda.get_device_properties(0).total_memory
    check(peak < total, f"peak memory {peak} beyond the card's {total}")
    check(launches == 2 * n_attn * steps,
          f"flash_attention launched {launches} times for {steps} steps of {n_attn} attention "
          f"layers, each forward once and once more in its recompute")
    check(flash_attention.wgmma_launches == launches,
          f"of {launches} bf16 attention launches {flash_attention.wgmma_launches} went "
          f"through the tensor-core kernel")
    check(rwkv6_scan.launches == flash_decode.launches == 0,
          f"the {tag} training path launched another kernel")
    check(bool(np.isfinite(losses).all() and np.isfinite(gnorms).all()
               and np.isfinite(auxes).all()),
          f"non-finite loss, gradient norm or aux loss: {losses} {gnorms} {auxes}")
    step_ms = 1e3 * np.asarray(step_s)
    print(f"[{tag}] losses {[round(x, 5) for x in losses]}; gradient norms "
          f"{[round(x, 5) for x in gnorms]}; aux loss {[round(x, 5) for x in auxes]}; step ms "
          f"{[round(float(x), 2) for x in step_ms]} (the first cold), median "
          f"{np.median(step_ms):.2f}; {B * S / np.median(step_ms) * 1e3:.1f} tokens/s at the "
          f"median; peak memory over the steps {peak / 2**30:.2f} GiB ({peak / 1e9:.2f} GB) "
          f"of {total / 2**30:.2f} (the weights' init {init_peak / 2**30:.2f}); "
          f"flash_attention launches {launches} = {n_attn} attention "
          f"layers x 2 (forward, recompute) x {steps} steps, all through the tensor-core "
          f"kernel", flush=True)
    batch = to_device(frontend_stubs(cfg, next(stream)), dev)
    profile_report(tag, lambda: step_fn(params, opt_state, batch))
    del params, opt_state, step_fn, model, batch, metrics
    torch.cuda.empty_cache()
    return dict(arch=cfg.name, layers=cfg.n_layers, params=n_params, batch=B, seq=S,
                losses=losses, grad_norms=gnorms, aux=auxes, step_ms=step_ms.tolist(),
                step_ms_median=float(np.median(step_ms)),
                tokens_per_s=float(B * S / np.median(step_ms) * 1e3), peak_gib=peak / 2**30,
                peak_bytes=peak, init_peak_bytes=init_peak, launches=launches,
                attn_layers=n_attn)


def full_step1_check(tag, cfg, dev, kern16, shape):
    """Step 1 of the full model through the kernel against the same step
    through the plain attention, both in bf16: loss and gradient norm within
    STEP1_BF16_REL of the plain values."""
    plain16 = step_one(cfg, dev, plain_attention, shape=shape)
    for i, name in enumerate(("loss", "gradient norm")):
        rel = abs(kern16[i] - plain16[i]) / abs(plain16[i])
        print(f"[{tag}] step 1 {name} at full depth: kernel bf16 {kern16[i]:.6f}, plain bf16 "
              f"{plain16[i]:.6f}; rel diff {rel:.3e} (tol {STEP1_BF16_REL:.3e})", flush=True)
        check(rel <= STEP1_BF16_REL, f"bf16 step 1 {name} of {cfg.name}: kernel {kern16[i]} vs "
              f"plain {plain16[i]}")
    return dict(kernel_bf16=kern16, plain_bf16=plain16)


def remat_comparison(dev):
    """Phase 7's model and shape under remat none, block and dots: REMAT_STEPS
    AdamW steps each from the same weights on the same batches.  Checks the
    attention launches a step (one forward a layer, twice under a recompute),
    losses equal and gradient norms within REMAT_GNORM_RTOL; reports each
    policy's step median and peak memory."""
    base = get_config(TRAIN_ARCH)
    B, S = TRAIN_B, TRAIN_S
    batches = [to_device(frontend_stubs(base, b), dev) for b in
               itertools.islice(iter(SyntheticLM(base.vocab, B, S, seed=0)), REMAT_STEPS)]
    out = {}
    for remat in ("none", "block", "dots"):
        cfg = dataclasses.replace(base, remat=remat)
        model = LM(cfg, device=dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        params = model.init(torch.Generator(device=dev).manual_seed(0))
        optimizer = AdamW(lr=cosine_with_warmup(3e-3, 1, REMAT_STEPS))
        opt_state = optimizer.init(params)
        step_fn = make_train_step(model, optimizer)
        flash_attention.launches = 0
        losses, gnorms, step_s = [], [], []
        for batch in batches:
            t = time.perf_counter()
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t)
            losses.append(float(metrics["loss"]))
            gnorms.append(float(metrics["grad_norm"]))
        per_step = flash_attention.launches / REMAT_STEPS
        want = cfg.n_layers * (1 if remat == "none" else 2)
        check(per_step == want, f"remat {remat}: {per_step} attention launches a step, "
              f"wanted {want}")
        out[remat] = dict(losses=losses, grad_norms=gnorms, step_ms=[1e3 * x for x in step_s],
                          step_ms_median=1e3 * float(np.median(step_s)),
                          peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                          attention_launches_per_step=per_step)
        print(f"[remat] {remat}: losses {losses}; gradient norms {gnorms}; step ms "
              f"{[round(1e3 * x, 2) for x in step_s]}, median "
              f"{out[remat]['step_ms_median']:.2f}; peak memory {out[remat]['peak_gib']:.2f} "
              f"GiB; {per_step:.0f} attention launches a step", flush=True)
        del params, opt_state, step_fn, model, metrics
        torch.cuda.empty_cache()
    for remat in ("block", "dots"):
        check(out[remat]["losses"] == out["none"]["losses"],
              f"remat {remat} losses {out[remat]['losses']} differ from none's "
              f"{out['none']['losses']}")
        rel = max(abs(a - b) / abs(b) for a, b in zip(out[remat]["grad_norms"],
                                                       out["none"]["grad_norms"]))
        out[remat]["grad_norm_rel_diff"] = rel
        print(f"[remat] {remat}: losses equal to none's; gradient norms within {rel:.3e} "
              f"relative (tol {REMAT_GNORM_RTOL})", flush=True)
        check(rel <= REMAT_GNORM_RTOL, f"remat {remat} gradient norms differ by {rel:.3e}")
    return out


def softmax_backward_check(dev):
    """``memtrace.CUDA_TEMPS`` against the card: one softmax backward at
    SOFTMAX_CHECK_SHAPE, its gradient laid out as the oracle attention
    backward hands it on (the cast of the weights' backward keeps the
    einsum's permuted (q, g, k) order), the card's peak above its operands
    against the tracker's on meta, to 512 bytes a buffer."""
    B, Hk, g, S, _ = SOFTMAX_CHECK_SHAPE

    def operands(device):
        return (torch.zeros((B, Hk, S, g, S), device=device).permute(0, 1, 3, 2, 4),
                torch.zeros(SOFTMAX_CHECK_SHAPE, device=device))

    op = torch.ops.aten._softmax_backward_data.default
    grad, out = operands(dev)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    gi = op(grad, out, -1, torch.float32)
    torch.cuda.synchronize()
    card = torch.cuda.max_memory_allocated() - base
    del grad, out, gi
    torch.cuda.empty_cache()
    traced = {}
    for name, table in (("with", memtrace.CUDA_TEMPS), ("without", {})):
        saved, memtrace.CUDA_TEMPS = memtrace.CUDA_TEMPS, table
        try:
            grad, out = operands("meta")
            live = memtrace.LiveBytes()
            with live:
                live.slot(grad)
                live.slot(out)
                op(grad, out, -1, torch.float32)
            live.close()
            traced[name] = live.peak - 2 * out.numel() * out.element_size()
        finally:
            memtrace.CUDA_TEMPS = saved
    print(f"[train-hybrid] softmax backward at {SOFTMAX_CHECK_SHAPE} f32, permuted gradient: "
          f"the card's peak above its operands {card} bytes; traced with memtrace.CUDA_TEMPS "
          f"{traced['with']}, without {traced['without']} (the output alone)", flush=True)
    check(abs(card - traced["with"]) <= 512 * 3, f"the softmax backward took {card} bytes on "
          f"the card, {traced['with']} traced")
    return dict(shape=list(SOFTMAX_CHECK_SHAPE), card_bytes=card, traced_bytes=traced["with"],
                traced_without_temps=traced["without"])


def train_moe_hybrid_phase(dev):
    """Phase 13: train Qwen1.5-MoE-A2.7B and RecurrentGemma-9B with
    Adafactor and remat="block", uncut or cut in depth as the dry-run's
    traced peak says; step 1 against the plain attention at full depth in
    bf16 and on a cut copy by phase 7's rules; then the remat comparison on
    phase 7's model.  Returns the ``train_moe_hybrid`` line and the
    attention launches by path."""
    t_phase = time.perf_counter()
    # A train step gathers each stacked leaf's gradient into one block while
    # its per-layer parts live (7.7 GiB for Qwen-MoE's experts), among blocks
    # the backward pass has freed and split: let the caching allocator map
    # more memory into a segment rather than fail on fragmentation (the
    # uncut MoE step failed so with 21.6 GiB reserved and free, on an
    # NVIDIA H100 80GB HBM3 at 700 W)
    torch.cuda.empty_cache()
    torch.cuda.memory._set_allocator_settings("expandable_segments:True")
    try:
        line, launches = train_moe_hybrid_runs(dev)
    finally:
        torch.cuda.empty_cache()
        torch.cuda.memory._set_allocator_settings("expandable_segments:False")
    line = {"train_moe_hybrid": line}
    line["train_moe_hybrid"]["seconds"] = time.perf_counter() - t_phase
    print(f"[train-moe-hybrid] phase took {line['train_moe_hybrid']['seconds']:.1f} s",
          flush=True)
    return line, launches


def train_moe_hybrid_runs(dev):
    """Phase 13's runs: returns its line's parts and the launches by path."""
    line, launches = {"softmax_backward": softmax_backward_check(dev)}, {}
    for arch, B, S, steps in MOE_HYBRID_TRAIN:
        tag = "train-moe" if arch == MOE_ARCH else "train-hybrid"
        cfg, traced, mem, cut = fitted_config(tag, arch, B, S)
        part = adafactor_train(tag, cfg, dev, B, S, steps)
        ratio = traced / part["peak_bytes"]
        print(f"[{tag}] traced peak {traced / 2**30:.2f} GiB against the card's "
              f"max_memory_allocated over the steps {part['peak_bytes'] / 2**30:.2f} GiB: "
              f"{ratio:.6f}x, {part['peak_bytes'] - traced} bytes apart (tol "
              f"{TRAIN_PEAK_RTOL})", flush=True)
        check(abs(ratio - 1) <= TRAIN_PEAK_RTOL, f"{cfg.name}: traced peak {traced} against "
              f"the card's {part['peak_bytes']}")
        part.update(cut=cut, traced_peak_bytes=traced, traced_over_card=ratio, memory=mem)
        part["step1"] = full_step1_check(tag, cfg, dev, (part["losses"][0],
                                                         part["grad_norms"][0]), (B, S))
        small = dataclasses.replace(cfg, n_layers=len(cfg.recurrent.pattern)
                                    if cfg.family == "hybrid" else STEP1_CUT_UNITS)
        kern16 = step_one(small, dev, None, shape=(B, S))
        part["step1_cut"] = dict(layers=small.n_layers,
                                 **step1_check(small, dev, kern16, tag, (B, S)))
        line[cfg.name] = part
        launches[f"{cfg.family} train"] = part["launches"]
        torch.cuda.empty_cache()
    line["remat"] = remat_comparison(dev)
    for remat, val in line["remat"].items():
        launches[f"remat {remat}"] = int(val["attention_launches_per_step"] * REMAT_STEPS)
    return line, launches


# ---------------------------------------------------------------------------
# Phase 14: the distribution layer
# ---------------------------------------------------------------------------
DIST_STEPS = 3                       # int8 steps rounded to nearest, then one stochastic
PIPE_M = 4                           # the pipeline's microbatches of (1, TRAIN_S)
PIPE_BF16_REL = 2.0 ** -7
PIPE_F32_REL = 1e-5
PIPE_F32_LAYERS = 2                  # the float32 copy's depth
INT8_PARAM_TOL = 5e-3                # tests/test_system.py's bound after one step
# the int8 step's gradients against a plain backward from the same weights,
# per leaf, relative to the leaf's largest: the embedding backward's atomics
# may sum in another order on the card (bf16 gradients)
INT8_GRAD_REL = 2.0 ** -7
# a round trip's error beyond its half (nearest) or whole (stochastic) step,
# in steps: the float32 division x / scale and the product q * scale each
# round within 2^-24 of a value of up to 127 steps
ROUNDTRIP_SLACK = 2 * 127 * 2.0 ** -24
INT8_SEED = 7                        # the stochastic step's generator
TWIN_ARCH, TWIN_SHAPE, TWIN_B, TWIN_STEPS = "qwen1.5-0.5b", "train_4k", 4, 3
# the twin's traced peak against the card's max_memory_allocated over its
# steps: room for the caching allocator's 512-byte rounding and the cuBLAS
# workspaces it holds, which the trace of aten ops does not see
TWIN_PEAK_RTOL = 0.01
GRID_CELLS, GRID_OK, GRID_SKIP = 80, 64, 16
# the recurrent, MLA/MoE and Adafactor cells whose plan is held to the JAX
# dry-run's records; phase 14 (d) prints their collective terms
HELD_CELLS = (("rwkv6-3b", "train_4k"), ("rwkv6-3b", "prefill_32k"),
              ("recurrentgemma-9b", "train_4k"), ("recurrentgemma-9b", "prefill_32k"),
              ("deepseek-v3-671b", "train_4k"), ("deepseek-v3-671b", "decode_32k"),
              ("command-r-plus-104b", "train_4k"))


class _MeanRecorder:
    """Stands in for ``train.step._cross_pod_int8_mean``: records each
    call's gradients and result."""

    def __init__(self, fn):
        self.fn, self.calls = fn, []

    def __call__(self, grads, mesh, generator=None):
        out = self.fn(grads, mesh, generator)
        self.calls.append((grads, out, generator is not None))
        return out


def _clone(tree):
    return tree_map(lambda t: t.detach().clone(), tree)


def _max_diff(a, b) -> float:
    return max(float((x.detach().float() - y.detach().float()).abs().max())
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def int8_part(dev, mesh, arch=TRAIN_ARCH, B=TRAIN_B, S=TRAIN_S):
    """(b): phase 7's model and batch through the int8 cross-pod step on the
    one-pod mesh, against the plain step from the same parameters."""
    cfg = get_config(arch)
    model = LM(cfg, device=dev)
    opt = AdamW(lr=3e-4)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    batches = [to_device(frontend_stubs(cfg, b), dev) for b in
               itertools.islice(iter(SyntheticLM(cfg.vocab, B, S, seed=0)), DIST_STEPS + 1)]
    n_params = sum(t.numel() for t in tree_leaves(params))
    plain_p, plain_s = _clone(params), opt.init(params)
    plain = make_train_step(model, opt)
    plain_ms = []
    for i in range(DIST_STEPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        plain_p, plain_s, m = plain(plain_p, plain_s, batches[i])
        torch.cuda.synchronize()
        plain_ms.append(1e3 * (time.perf_counter() - t))
        if i == 0:
            plain_loss, plain_after1 = float(m["loss"]), _clone(plain_p)
    del plain_p, plain_s

    recorder = _MeanRecorder(step_module._cross_pod_int8_mean)
    step_module._cross_pod_int8_mean = recorder
    params0 = _clone(params)
    try:
        step = make_train_step(model, opt, grad_compression="int8", mesh=mesh)
        state = opt.init(params)
        int8_ms, losses, launches = [], [], []
        for i in range(DIST_STEPS + 1):
            gen = (torch.Generator(device=dev).manual_seed(INT8_SEED) if i == DIST_STEPS
                   else None)
            flash_attention.launches = flash_attention.wgmma_launches = 0
            torch.cuda.synchronize()
            t = time.perf_counter()
            params, state, m = step(params, state, batches[i], gen)
            torch.cuda.synchronize()
            int8_ms.append(1e3 * (time.perf_counter() - t))
            losses.append(float(m["loss"]))
            launches.append(flash_attention.launches)
            check(flash_attention.wgmma_launches == flash_attention.launches == cfg.n_layers,
                  f"int8 step {i + 1}: {flash_attention.launches} attention launches "
                  f"({flash_attention.wgmma_launches} wgmma), wanted {cfg.n_layers}")
            if i == 0:
                d1 = _max_diff(params, plain_after1)
                check(losses[0] == plain_loss, f"int8 step 1 loss {losses[0]} != the plain "
                      f"step's {plain_loss}")
                check(d1 <= INT8_PARAM_TOL, f"after one int8 step the parameters are {d1} "
                      f"from the plain step's (tol {INT8_PARAM_TOL})")
                # the bound above holds whatever the gradient (AdamW's first
                # step moves a weight by about lr): the step must be the
                # optimizer's update on the mean it reduced, bit for bit
                replay = _clone(params0)
                opt.update(recorder.calls[0][1], opt.init(replay), replay)
                check(all(torch.equal(a, b) for a, b in zip(tree_leaves(params),
                                                            tree_leaves(replay))),
                      "int8 step 1's parameters differ from AdamW's update on its mean")
                del replay
    finally:
        step_module._cross_pod_int8_mean = recorder.fn
    del plain_after1
    # and the gradients it quantised must be a plain backward's
    _, _, plain_grads = value_and_grad(model, params0, batches[0])
    grad_rel = max(float((a.float() - b.float()).abs().max() / b.float().abs().max().clamp_min(
        1e-30)) for a, b in zip(tree_leaves(recorder.calls[0][0]), tree_leaves(plain_grads)))
    check(grad_rel <= INT8_GRAD_REL, f"int8 step 1's gradients {grad_rel:.3e} of a leaf's "
          f"largest from a plain backward's (tol {INT8_GRAD_REL:.3e})")
    del params0, plain_grads

    # one pod: the step's mean is each leaf's own round trip, bit for bit
    # (the stochastic one redrawn from the same seed, leaf by leaf)
    worst = {False: 0.0, True: 0.0}
    for grads, out, stochastic in (recorder.calls[0], recorder.calls[-1]):
        bound = 1.0 if stochastic else 0.5
        gen = torch.Generator(device=dev).manual_seed(INT8_SEED) if stochastic else None
        for g, o in zip(tree_leaves(grads), tree_leaves(out)):
            q, s = int8_quantize(g, gen)
            check(torch.equal(o, int8_dequantize(q, s, g.dtype)),
                  "the one-pod mean differs from the leaf's own round trip")
            err = float((int8_dequantize(q, s) - g.float()).abs().max())
            check(err <= float(s) * (bound + ROUNDTRIP_SLACK),
                  f"round-trip error {err} beyond {bound} step ({float(s)}) of a leaf")
            worst[stochastic] = max(worst[stochastic], err / float(s))
    grads = recorder.calls[0][0]
    leaves = tree_leaves(grads)
    events = []
    for _ in range(3):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        recorder.fn(grads, mesh, None)
        b.record()
        torch.cuda.synchronize()
        events.append(a.elapsed_time(b))
    npod = 2
    int8_bytes = sum(g.numel() for g in leaves) + 4 * len(leaves)
    grad_bytes = sum(g.numel() * g.element_size() for g in leaves)
    # an all-gather over p pods sends (p-1)/p of p*e bytes a pod; a ring
    # all-reduce of the bf16 gradients 2(p-1)/p of 2e
    wire_int8 = (npod - 1) * int8_bytes
    wire_bf16 = 2 * (npod - 1) / npod * grad_bytes
    quant_ms = float(np.median(events))
    print(f"[dist] (b) int8 cross-pod step, {cfg.name} ({n_params} parameters), B={B} S={S}, "
          f"AdamW, one pod: step 1 loss {losses[0]!r} == the plain step's; its gradients "
          f"within {grad_rel:.3e} of a leaf's largest of a plain backward's (tol "
          f"{INT8_GRAD_REL:.3e}); its parameters == AdamW's update on its int8 mean, bit for "
          f"bit, and within {d1:.3e} of the plain step's (tol {INT8_PARAM_TOL}); losses "
          f"{losses}; flash_attention launches a step {launches}, all wgmma", flush=True)
    print(f"[dist] (b) round trip: worst |dequantized - gradient| {worst[False]:.4f} of a "
          f"step to nearest (<= 0.5), {worst[True]:.4f} stochastic (<= 1), over "
          f"{len(leaves)} leaves", flush=True)
    print(f"[dist] (b) step ms: int8 {[round(x, 2) for x in int8_ms]} (the last stochastic), "
          f"median of the first {DIST_STEPS} {np.median(int8_ms[:DIST_STEPS]):.2f}; plain "
          f"{[round(x, 2) for x in plain_ms]}, median {np.median(plain_ms):.2f}; quantize + "
          f"gather + dequantize of all {len(leaves)} leaves {quant_ms:.3f} ms (median of 3, "
          f"CUDA events)", flush=True)
    print(f"[dist] (b) pod bytes a step: {int8_bytes} int8 + scale bytes a pod against "
          f"{grad_bytes} bf16 gradient bytes ({grad_bytes / int8_bytes:.3f}x); at 2 pods a "
          f"device sends {wire_int8} bytes in the int8 gather against {wire_bf16:.0f} in a "
          f"bf16 ring all-reduce", flush=True)
    out = dict(arch=cfg.name, params=n_params, batch=B, seq=S, losses=losses,
               plain_loss=plain_loss, param_diff_after_1=d1, grad_rel_diff_1=grad_rel,
               int8_step_ms=int8_ms,
               plain_step_ms=plain_ms, quant_gather_dequant_ms=quant_ms,
               worst_roundtrip_steps={"nearest": worst[False], "stochastic": worst[True]},
               int8_pod_bytes=int8_bytes, grad_pod_bytes=grad_bytes,
               launches_per_step=launches)
    del params, state, grads, recorder, batches
    torch.cuda.empty_cache()
    return out, sum(launches)


def _pipeline_adapters(model):
    """The LM's embedding, layers and loss as ``pipeline_loss_fn`` takes them
    (a dense model: one ``attn`` segment, no auxiliary loss)."""
    cfg, seg = model.cfg, model.segments[0]

    def embed_fn(ep, tokens):
        return ep["embedding"][tokens]

    def block_fn(lp, x):
        B, S = x.shape[:2]
        positions = torch.arange(S, device=x.device).expand(B, S)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return model._block(seg, lp, x, aux, positions=positions, cache=None, gapless=True,
                            position_ids=None, enc_out=None, enc_positions=None)[0]

    def loss_fn(hp, y, labels):
        return model._xent(hp, norm_apply(cfg, hp["final_norm"], y), labels)

    return embed_fn, block_fn, loss_fn


def pipeline_run(cfg, dev, mesh, tokens, labels):
    """Loss and gradient norm of the GPipe schedule on the one-stage mesh, and
    of ``LM.loss`` averaged over the same microbatches, from the same
    weights; and the attention launches of the pipeline's forward."""
    model = LM(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    for t in tree_leaves(params):
        t.requires_grad_(True)
    if not cfg.tie_embeddings:
        raise ValueError("the adapters take a tied embedding")
    embed_fn, block_fn, loss_fn = _pipeline_adapters(model)
    stages = split_stages(tree_map(lambda t: t.detach(), params["segments"][0]), 1)
    stages = tree_map(lambda t: t.requires_grad_(True), stages)
    head = {"embed": params["embed"], "final_norm": params["final_norm"]}
    pp = {"stages": stages, "embed": params["embed"], "head": head}
    batch = {"tokens": tokens, "labels": labels}
    flash_attention.launches = 0
    loss = pipeline_loss_fn(mesh, block_fn, embed_fn, loss_fn)(pp, batch)
    launches = flash_attention.launches
    loss.backward()
    grads = [t.grad for t in tree_leaves(stages)] + [
        t.grad for t in tree_leaves({"embed": params["embed"],
                                     "final_norm": params["final_norm"]}) if t.grad is not None]
    pipe = (float(loss.detach()), float(global_norm(grads)))
    for t in tree_leaves(params) + tree_leaves(stages):
        t.grad = None
    total, acc = 0.0, None
    for m in range(tokens.shape[0]):
        loss_m, _, g = value_and_grad(model, params, {"tokens": tokens[m], "labels": labels[m]})
        total += float(loss_m) / tokens.shape[0]
        g = [x.float() / tokens.shape[0] for x in tree_leaves(g)]
        acc = g if acc is None else [a + b for a, b in zip(acc, g)]
    ref = (total, float(global_norm(acc)))
    del params, stages, pp, grads, acc
    torch.cuda.empty_cache()
    return pipe, ref, launches


def pipeline_part(dev, mesh, arch=TRAIN_ARCH, S=TRAIN_S):
    """(c): the GPipe schedule on the one-stage mesh at full width, against
    ``LM.loss`` averaged over the same microbatches."""
    cfg = get_config(arch)
    b = next(iter(SyntheticLM(cfg.vocab, PIPE_M, S, seed=0)))
    tokens = torch.from_numpy(b["tokens"]).to(dev).reshape(PIPE_M, 1, S)
    labels = torch.from_numpy(b["labels"]).to(dev).reshape(PIPE_M, 1, S)
    t = time.perf_counter()
    pipe16, ref16, launches = pipeline_run(cfg, dev, mesh, tokens, labels)
    seconds = time.perf_counter() - t
    check(launches == PIPE_M * cfg.n_layers,
          f"the pipeline's forward launched flash_attention {launches} times, wanted "
          f"{PIPE_M} microbatches x {cfg.n_layers} layers")
    small = dataclasses.replace(cfg, n_layers=PIPE_F32_LAYERS, dtype="float32")
    pipe32, ref32, _ = pipeline_run(small, dev, mesh, tokens, labels)
    rel16 = [abs(a - b) / abs(b) for a, b in zip(pipe16, ref16)]
    rel32 = [abs(a - b) / abs(b) for a, b in zip(pipe32, ref32)]
    print(f"[dist] (c) GPipe, {cfg.name}, {cfg.n_layers} layers in split_stages(., 1), M="
          f"{PIPE_M} microbatches of (1, {S}), pipeline_efficiency({PIPE_M}, 1) = "
          f"{pipeline_efficiency(PIPE_M, 1)}: bf16 loss {pipe16[0]:.6f} against LM.loss's "
          f"mean {ref16[0]:.6f}, gradient norm {pipe16[1]:.6f} against {ref16[1]:.6f}, rel "
          f"diffs {rel16[0]:.3e} {rel16[1]:.3e} (tol {PIPE_BF16_REL:.3e}); float32 copy cut to "
          f"{PIPE_F32_LAYERS} layers: rel diffs {rel32[0]:.3e} {rel32[1]:.3e} (tol "
          f"{PIPE_F32_REL}); {launches} flash_attention launches in the forward; "
          f"{seconds:.1f} s", flush=True)
    check(max(rel16) <= PIPE_BF16_REL, f"bf16 pipeline against LM.loss: {pipe16} vs {ref16}")
    check(max(rel32) <= PIPE_F32_REL, f"f32 pipeline against LM.loss: {pipe32} vs {ref32}")
    return dict(arch=cfg.name, microbatches=PIPE_M, seq=S, stages=1,
                efficiency=pipeline_efficiency(PIPE_M, 1), bf16=dict(pipeline=pipe16, ref=ref16),
                f32_cut=dict(layers=PIPE_F32_LAYERS, pipeline=pipe32, ref=ref32),
                launches=launches), launches


def grid_part():
    """(d): the 80-cell dry-run grid on the meta device, both roofline
    tables, and one multi-pod cell under int8 compression."""
    traces, records = {}, {}
    variant = dict(remat="block")
    t = time.perf_counter()
    for arch in ARCHS:
        for shape in SHAPES:
            for mk in ("single", "multi"):
                records[dryrun.cell_key(arch, shape, mk, variant)] = dryrun.run_cell(
                    arch, shape, mk, traces=traces, **variant)
    seconds = time.perf_counter() - t
    status = [r["status"] for r in records.values()]
    fails = {k: r["error"] for k, r in records.items() if r["status"] == "fail"}
    skips = sorted(k for k, r in records.items() if r["status"] == "skip")
    cell_s = [r["total_s"] for r in records.values()]
    print(f"[dist] (d) dry-run grid: {len(records)} cells, {status.count('ok')} ok, "
          f"{status.count('skip')} skip, {status.count('fail')} fail in {seconds:.1f} s of "
          f"host time ({np.mean(cell_s):.2f} s a cell, the longest {max(cell_s):.2f} s; "
          f"{len(traces)} traces, each reused for both meshes)", flush=True)
    check(not fails, f"dry-run cells failed: {fails}")
    check(len(records) == GRID_CELLS and status.count("ok") == GRID_OK
          and status.count("skip") == GRID_SKIP, f"grid counts {len(records)} "
          f"{status.count('ok')} {status.count('skip')}")
    check(all("|long_500k|" in k for k in skips), f"unexpected skips: {skips}")
    for mk in ("single", "multi"):
        print(f"[dist] (d) H100 roofline, {mk} mesh (seconds a step; 989 TFLOP/s bf16, "
              f"3.35 TB/s, NVLink 450 GB/s in a node, InfiniBand 50 GB/s across; the traced "
              f"peak GiB a device, and whether it fits one card):", flush=True)
        for line in roofline.format_table(roofline.build_table(records, mk)).splitlines():
            print(f"[dist] (d)   {line}", flush=True)
    fits = {mk: sum(r["fits"] for r in roofline.build_table(records, mk))
            for mk in ("single", "multi")}
    n_rows = {mk: len(roofline.build_table(records, mk)) for mk in ("single", "multi")}
    print("[dist] (d) cells whose traced peak fits one card (" + f"{roofline.HBM_BYTES} "
          "bytes): " + "; ".join(f"{mk} mesh {fits[mk]} of {n_rows[mk]}" for mk in fits),
          flush=True)
    rows = {mk: {(r["arch"], r["shape"]): r for r in roofline.build_table(records, mk)}
            for mk in ("single", "multi")}
    held = {f"{a} {s}": {mk: [rows[mk][a, s]["collective_s"], rows[mk][a, s]["dominant"]]
                         for mk in ("single", "multi")} for a, s in HELD_CELLS}
    print("[dist] (d) collective term (s) and binding term, single | multi, of the cells held "
          "to the JAX records in tests/test_torch_collectives_{recurrent,adafactor}.py: "
          + "; ".join(f"{k} {v['single'][0]:.4g} {v['single'][1]} | {v['multi'][0]:.4g} "
                      f"{v['multi'][1]}" for k, v in held.items()), flush=True)
    arch = TRAIN_ARCH
    plain = records[dryrun.cell_key(arch, "train_4k", "multi", variant)]
    int8 = dryrun.run_cell(arch, "train_4k", "multi", traces=traces, remat="block",
                           compression="int8")
    check(int8["status"] == "ok", f"the int8 cell: {int8.get('error')}")
    n_leaves = len(tree_leaves(LM(get_config(arch), device="meta").init(torch.Generator())))
    p = int8["mesh_shape"]["pod"]
    w_int8, w_plain = (r["collectives"]["wire_by_axis"]["pod"] for r in (int8, plain))
    scales = 4 * (p - 1) * n_leaves
    print(f"[dist] (d) {arch} train_4k multi under --compression int8: {w_int8:.0f} bytes a "
          f"device on the pod links against {w_plain:.0f} for the bf16 all-reduce "
          f"({w_int8 / w_plain:.4f}x): at p = 2 the gather of one int8 byte an element sends "
          f"(p-1)/p of p*e/n = e/n bytes, the ring all-reduce of two bf16 bytes 2(p-1)/p of "
          f"2e/n = 2e/n, so half, plus {scales} bytes of float32 scales; a quarter of a "
          f"float32 all-reduce's", flush=True)
    check(w_int8 == w_plain / 2 + scales, f"int8 pod bytes {w_int8} != {w_plain} / 2 + "
          f"{scales}")
    seq = seq_shard_part(traces, records, variant)
    rows = {mk: roofline.build_table(records, mk) for mk in ("single", "multi")}
    return dict(cells=len(records), ok=status.count("ok"), skip=status.count("skip"),
                fail=status.count("fail"), seconds=seconds, cell_s_mean=float(np.mean(cell_s)),
                cell_s_max=max(cell_s), int8_pod_wire=w_int8, bf16_pod_wire=w_plain,
                seq_shard=seq, held_cells=held,
                fits=fits,
                roofline={mk: [{k: r[k] for k in ("arch", "shape", "compute_s", "memory_s",
                                                    "collective_s", "dominant", "mfu_bound",
                                                    "hbm_temp_gib", "peak_gib", "fits")}
                               for r in rs] for mk, rs in rows.items()})


def seq_shard_part(traces, records, variant):
    """(d): the train_4k single-pod cell of the train phase's architecture
    under sequence parallelism (the grid's default) against ``--seq-shard
    none``: the plan's bytes by axis and the roofline's collective term.
    Counted as the JAX dry-run's records count them (a reduce-scatter as
    the all-reduce of its input), SP moves more bytes over "model", as
    there."""
    arch = TRAIN_ARCH
    sp = records[dryrun.cell_key(arch, "train_4k", "single", variant)]
    none = dryrun.run_cell(arch, "train_4k", "single", traces=traces, seq_shard="none",
                           **variant)
    check(none["status"] == "ok", f"the seq_shard none cell: {none.get('error')}")
    out = {}
    for name, rec in (("sp", sp), ("none", none)):
        c, m = rec["collectives"], rec["mesh_shape"]["model"]
        as_reference = sum(v * (m if kind == "reduce-scatter" else 1)
                           for kind, axes in c["by_kind_axis"].items()
                           for a, v in axes.items() if a == "model")
        out[name] = dict(by_axis=c["by_axis"], wire_by_axis=c["wire_by_axis"],
                         total_bytes=c["total_bytes"], model_as_reference=as_reference,
                         collective_s=roofline.roofline_row(rec)["collective_s"])
    print(f"[dist] (d) {arch} train_4k single, --seq-shard sp against none: result bytes "
          f"a device by axis {_gb(out['sp']['by_axis'])} against "
          f"{_gb(out['none']['by_axis'])} GB ('model' as the reference counts it: "
          f"{out['sp']['model_as_reference'] / 1e9:.3f} against "
          f"{out['none']['model_as_reference'] / 1e9:.3f}), sent "
          f"{_gb(out['sp']['wire_by_axis'])} against {_gb(out['none']['wire_by_axis'])} GB; "
          f"collective term {out['sp']['collective_s']:.4f} s against "
          f"{out['none']['collective_s']:.4f} s", flush=True)
    check(out["sp"]["model_as_reference"] > out["none"]["model_as_reference"],
          "sp moves no more bytes over 'model' than none, counted as the reference counts")
    check(sp["flops_global"] == none["flops_global"], "sp and none traced differently")
    return out


def _gb(by_axis):
    return {k: round(v / 1e9, 3) for k, v in sorted(by_axis.items())}


def twin_part(dev, mesh):
    """(e): price the one-card train_4k cell at B=4 and hold it against the
    card: resident bytes, then the step's median beside its bound."""
    rec = dryrun.run_cell(TWIN_ARCH, TWIN_SHAPE, "card", mesh=mesh,
                          batch_override=TWIN_B, remat="block")
    check(rec["status"] == "ok", f"the twin cell: {rec.get('error')}")
    row = roofline.roofline_row(rec)
    shape = dataclasses.replace(SHAPES[TWIN_SHAPE], global_batch=TWIN_B)
    cfg = dryrun.make_cell_config(TWIN_ARCH, shape)
    model = LM(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    opt = dryrun.pick_optimizer(TWIN_ARCH)
    state = opt.init(params)
    card = {"param_bytes_per_device": sum(t.numel() * t.element_size()
                                          for t in tree_leaves(params)),
            "opt_bytes_per_device": sum(t.numel() * t.element_size()
                                        for t in tree_leaves(state))}
    print(f"[dist] (e) twin {TWIN_ARCH} {TWIN_SHAPE} at B={TWIN_B} on the one-card mesh: "
          f"resident {rec['resident']} (priced) against {card} (on the card)", flush=True)
    check(rec["resident"] == {k: float(v) for k, v in card.items()},
          f"priced resident bytes {rec['resident']} != the card's {card}")
    step = make_train_step(model, opt)
    batches = [to_device(frontend_stubs(cfg, b), dev) for b in itertools.islice(
        iter(SyntheticLM(cfg.vocab, TWIN_B, shape.seq_len, seed=0)), TWIN_STEPS)]
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated() - sum(
        t.numel() * t.element_size() for t in tree_leaves([params, state] + batches[:1]))
    step_s = []
    for b in batches:
        torch.cuda.synchronize()
        t = time.perf_counter()
        params, state, m = step(params, state, b)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
        check(bool(np.isfinite(float(m["loss"]))), "the twin step's loss is not finite")
    peak = torch.cuda.max_memory_allocated() - base
    med = float(np.median(step_s))
    tflops = rec["flops_global"] / med / 1e12
    mem = rec["memory"]
    ratio = mem["peak_bytes"] / peak
    print(f"[dist] (e) the step on the card (remat block, bf16, AdamW bf16 state): "
          f"{[round(1e3 * x, 2) for x in step_s]} ms, median {1e3 * med:.2f} ms; roofline "
          f"bound {1e3 * row['bound_s']:.2f} ms ({row['dominant']}: compute "
          f"{1e3 * row['compute_s']:.2f} ms from {rec['flops_global']:.4e} counted FLOPs, "
          f"memory {1e3 * row['memory_s']:.2f} ms from {rec['bytes_global']:.4e} counted "
          f"bytes, an upper bound); measured / bound {med / row['bound_s']:.2f}; "
          f"{tflops:.1f} TFLOP/s achieved on the counted FLOPs", flush=True)
    total = torch.cuda.get_device_properties(0).total_memory
    print(f"[dist] (e) twin memory record (bytes): {json.dumps(mem)}; the card holds {total} "
          f"bytes (roofline.HBM_BYTES {roofline.HBM_BYTES})", flush=True)
    check(total == roofline.HBM_BYTES, f"the card holds {total} bytes, the roofline prices "
          f"{roofline.HBM_BYTES}")
    print(f"[dist] (e) traced peak {mem['peak_bytes'] / 2**30:.4f} GiB against the card's "
          f"max_memory_allocated over the same steps {peak / 2**30:.4f} GiB (less what the "
          f"card held before but the step's own arguments): {ratio:.6f}x, "
          f"{peak - mem['peak_bytes']} bytes apart (tol {TWIN_PEAK_RTOL}); temporaries {mem['temp_size_in_bytes'] / 2**30:.4f} GiB",
          flush=True)
    check(abs(ratio - 1) <= TWIN_PEAK_RTOL, f"the twin's traced peak {mem['peak_bytes']} "
          f"against the card's {peak}")
    del params, state, step, batches
    torch.cuda.empty_cache()
    return dict(arch=TWIN_ARCH, shape=TWIN_SHAPE, batch=TWIN_B, resident=rec["resident"],
                card=card, step_ms=[1e3 * x for x in step_s], step_ms_median=1e3 * med,
                bound_ms=1e3 * row["bound_s"], bound_by=row["dominant"],
                compute_ms=1e3 * row["compute_s"], memory_ms=1e3 * row["memory_s"],
                flops=rec["flops_global"], bytes=rec["bytes_global"], tflops=tflops,
                peak_gib=peak / 2**30, peak_bytes=peak, memory=mem, traced_over_card=ratio)


def distribution_phase(dev, backend="nccl"):
    """Phase 14: the int8 cross-pod step and the GPipe schedule at full width
    on a one-rank process group, the dry-run grid on the meta device and the
    twin against the card.  Returns the ``distribution`` line and the
    attention launches by path."""
    t_phase = time.perf_counter()
    line = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_pg_") as tmp:
        dist.init_process_group(backend, init_method=f"file://{tmp}/store", rank=0,
                                world_size=1)
        try:
            mesh = make_host_mesh(pod=1, data=1, model=1, device_type=dev.type)
            print(f"[dist] (a) one-rank {backend} process group; mesh "
                  f"{mesh_axis_sizes(mesh)} on {dev.type}", flush=True)
            line["int8"], int8_launches = int8_part(dev, mesh)
            stage_mesh = make_mesh((1,), ("stage",), dev.type)
            line["pipeline"], pipe_launches = pipeline_part(dev, stage_mesh)
            line["twin"] = twin_part(dev, mesh)
        finally:
            dist.destroy_process_group()
    line["grid"] = grid_part()
    line["seconds"] = time.perf_counter() - t_phase
    print(f"[dist] phase took {line['seconds']:.1f} s", flush=True)
    return {"distribution": line}, {"train int8": int8_launches, "pipeline": pipe_launches}


# -- phase 15: audit-kvdtype ----------------------------------------------------------
# The decode kernel's kinds for K/V in another float dtype than q's (a cache
# in another kv_dtype than the model's), as (q dtype, K/V dtype), held at the
# dense serving path's heads (Minitron-8B, g = 4), the MoE path's (Qwen-MoE,
# g = 1) and the hybrid's (RecurrentGemma, g = 16, D = 256).
KV_KINDS = ((torch.float32, torch.bfloat16), (torch.float32, torch.float16),
            (torch.bfloat16, torch.float32), (torch.bfloat16, torch.float16),
            (torch.float32, torch.float32))
KV_KIND_SHAPES = (("", 32, 8, 128), ("moe ", 16, 16, 128), ("hybrid ", 16, 1, 256))


def kind_name(q_dtype, kv_dtype) -> str:
    return f"{str(kv_dtype)[6:]} K/V, {str(q_dtype)[6:]} q"


def audit_part(dev):
    """(a) Every target of the kernel audit (``builtin_targets``) rebuilt on
    the card and run under the dispatch recorder and
    ``set_sync_debug_mode("error")``: the findings (none allowed), each
    target's op count, signatures and kernel launches, and the engine's
    cache pointers before and after its decode step and prefill."""
    counted = {kern.__name__: kern for kern in
               (flash_attention, flash_decode, rwkv6_scan, *batched.DECISION_KERNELS)}
    rows, problems = {}, []
    for path, specs in builtin_targets(dev.type).items():
        for spec in specs:
            before = {name: kern.launches for name, kern in counted.items()}
            result = run_audit(spec)
            torch.cuda.synchronize()
            launched = {name: kern.launches - before[name] for name, kern in counted.items()
                        if kern.launches != before[name]}
            rows[spec.name] = dict(file=path, device=spec.device, ops=result.ops,
                                   signatures=result.signatures, launches=launched,
                                   findings=result.problems)
            print(f"[audit] {spec.name} ({path}, {spec.device}): {result.ops} aten ops over "
                  f"{len(spec.sweep)} sweep points, {result.signatures} input signatures "
                  f"(expected {spec.expected_signatures}), kernel launches {launched}, "
                  f"{len(result.problems)} findings", flush=True)
            for msg in result.problems:
                print(f"[audit]   finding: {msg}", flush=True)
            for leaf, (was, now) in result.pointers.items():
                print(f"[audit]   {spec.name} cache leaf {leaf}: storage {was:#x} before the "
                      f"call, {now:#x} after", flush=True)
            if result.pointers:
                rows[spec.name]["pointers_unchanged"] = all(
                    was == now for was, now in result.pointers.values())
            problems += result.problems
    check(not problems, f"the kernel audit on the card found {len(problems)} problems")
    for name, kern in (("attention", "flash_attention"), ("decode_attention", "flash_decode"),
                       ("rwkv6", "rwkv6_scan"), ("engine.decode_step", "flash_decode"),
                       ("engine.prefill", "flash_attention")):
        check(rows[name]["launches"].get(kern, 0) > 0,
              f"the audit of {name} on the card launched no {kern}")
    print(f"[audit] {len(rows)} targets audited on the card, 0 findings", flush=True)
    return rows


def kv_kinds_part(dev):
    """(b) The decode kernel on each of KV_KINDS against decode_attention_ref
    at KV_KIND_SHAPES (B=8, C=1024, served lengths and full), its device
    time beside the plain version's and SDPA's on K/V cast to q's dtype;
    its bound from the bytes read with K/V at their own width and the
    operations at q's type's peak (bf16 tensor cores, or f32 outside them).
    Returns ``{(q dtype, K/V dtype): (worst error, timing by shape)}``."""
    gen = torch.Generator(device=dev).manual_seed(7)
    B, C, L = SERVE_B, SERVE_C, DECODE_TIMING_LAYERS
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = {}
    for qd, kvd in KV_KINDS:
        worst, timing = 0.0, {}
        tol = ATTN_TOL[qd]
        peak = BF16_OPS_PER_S if qd == torch.bfloat16 else F32_OPS_PER_S
        for path, Hq, Hk, D in KV_KIND_SHAPES:
            q = torch.randn((L, B, Hq, D), generator=gen, device=dev).to(qd)
            k, v = (astype(torch.randn((L, B, C, Hk, D), generator=gen, device=dev), kvd)
                    for _ in range(2))
            kt, vt = (astype(t, qd).transpose(2, 3).contiguous() for t in (k, v))
            for lengths_name, lengths in (("served", SERVE_LENGTHS), ("full", (C,) * B)):
                name = path + lengths_name
                lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
                got = flash_decode(q[0], k[0], v[0], lens).float()
                torch.cuda.synchronize()
                want = decode_attention_ref(q[0], k[0], v[0], lens).float()
                check(bool(torch.isfinite(got).all()),
                      f"non-finite decode output, {kind_name(qd, kvd)}, D={D}")
                err = float((got - want).abs().max())
                over = float(((got - want).abs() - (tol + tol * want.abs())).max())
                check(over <= 0, f"decode kernel on {kind_name(qd, kvd)} disagrees Hq={Hq} "
                      f"Hk={Hk} D={D} lengths {lengths_name}: max abs err {err:.3e} beyond "
                      f"{tol} abs+rel")
                worst = max(worst, err)
                mask = (torch.arange(C, device=dev)[None, :] < lens[:, None])[:, None, None, :]
                ms, *ev = counted_ms(
                    layers(lambda i: flash_decode(q[i], k[i], v[i], lens), L), 2 * L)
                plain_ms, *plain_ev = counted_ms(
                    layers(lambda i: decode_attention_ref(q[i], k[i], v[i], lens), L), L)
                library_ms, *lib_ev = counted_ms(
                    layers(lambda i: sdpa(q[i][:, :, None], kt[i], vt[i], attn_mask=mask,
                                          enable_gqa=True), L), 2 * L)
                nbytes, ops = decode_cost(B, Hq, Hk, D, lengths, q.element_size(),
                                          kv_bytes=k.element_size())
                t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / peak * 1e3
                bound = max(t_bytes, t_ops)
                timing[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                                    bound_ms=bound,
                                    bound_by="bytes" if t_bytes >= t_ops else "operations",
                                    max_abs_err=err,
                                    events=dict(kernel=ev, plain=plain_ev, library=lib_ev))
                if name == "served":
                    per_call = kernels_per_call(lambda: flash_decode(q[0], k[0], v[0], lens))
                    check(per_call == 1, f"one flash_decode call on {kind_name(qd, kvd)} ran "
                          f"{per_call} kernels on the card")
                    timing["kernels_per_call"] = per_call
                plan = decode_plan(q[0], k[0])
                print(f"[kvdtype] flash_decode {kind_name(qd, kvd)} B={B} C={C} Hq={Hq} "
                      f"Hk={Hk} D={D}, lengths {lengths_name} (sum {sum(lengths)}), "
                      f"(split_keys, nsplit) {plan}: max abs err {err:.3e} (tol {tol} "
                      f"abs+rel); device {ms:.4f} ms a "
                      f"launch; plain version {plain_ms:.4f} ms; scaled_dot_product_attention "
                      f"on K/V cast to q's dtype {library_ms:.4f} ms; bound {bound:.5f} ms "
                      f"({nbytes} bytes -> {t_bytes:.5f} ms, {ops} ops -> {t_ops:.5f} ms), "
                      f"{100 * bound / ms:.1f}% of bound; {events_seen(timing[name])}",
                      flush=True)
            del q, k, v, kt, vt
            torch.cuda.empty_cache()
        out[(qd, kvd)] = (worst, timing)
    return out


# the decode kernel's K/V kinds under a bf16 q, by the kernel's kv_kind
BF16_Q_KV = {0: torch.bfloat16, 1: torch.float8_e4m3fn, 2: torch.float8_e5m2, 4: torch.float16,
             5: torch.float32}


def bf16_q_variants(report):
    """``[(kv_kind, D, kernel, registers, spill stores, spill loads, blocks an
    SM)]`` for every variant of the decode kernel under a bf16 q at D = 64,
    128 and 256 in an ``nvcc -Xptxas -v`` report, with the blocks one SM of
    this card holds at once (CUDA's occupancy calculator)."""
    rows = []
    for kern, regs, st, ld in ptxas_report(report):
        m = (re.search(r"flash_decode_split_kernel\s*<\s*(\d+)\s*,\s*(\d+)\s*>", kern)
             or re.search(r"flash_decode_split_kernelILi(\d+)ELi(\d+)E", kern)
             or re.search(r"flash_decode_kernel\s*<\s*__nv_bfloat16\s*,\s*(\d+)\s*,\s*(\d+)\s*>",
                          kern)
             or re.search(r"flash_decode_kernelI13__nv_bfloat16Li(\d+)ELi(\d+)E", kern))
        if m and int(m.group(2)) in (64, 128, 256):
            kind, D = int(m.group(1)), int(m.group(2))
            rows.append((kind, D, kern, regs, st, ld,
                         decode_blocks_per_sm(D, torch.bfloat16, BF16_Q_KV[kind])))
    return sorted(rows)


def report_attention_variants(report):
    """Print every attention kernel's registers and spills, and each bf16
    (wgmma) instantiation's blocks an SM (CUDA's occupancy calculator; one
    warpgroup a block, no cluster); check that every head size is built
    and that no bf16 instantiation spills."""
    rows = []
    for kern, regs, st, ld in ptxas_report(report):
        m = (re.search(r"flash_attention_wgmma_kernel\s*<\s*(\d+)\s*,", kern)
             or re.search(r"flash_attention_wgmma_kernelILi(\d+)E", kern))
        occ = ""
        if m:
            D = int(m.group(1))
            occ = f", {attention_occupancy(D)} blocks an SM, no cluster"
            rows.append((D, regs, st, ld))
            check(st == 0 and ld == 0, f"flash_attention {kern} spills")
        print(f"[build] flash_attention {kern}: {regs} registers, spill stores {st} bytes, "
              f"spill loads {ld} bytes{occ}", flush=True)
    if report:
        check(sorted(D for D, *_ in rows) == [32, 64, 128, 256],
              "the register report lacks a bf16 instantiation of flash_attention")
    return rows


F32_Q_KV = {0: torch.float32, 1: torch.float8_e4m3fn, 2: torch.float8_e5m2, 3: torch.bfloat16,
            4: torch.float16}


def report_f32_q_variants(report):
    """Print every f32-q variant of the decode kernel's registers, spills and
    blocks an SM at D = 64, 128 and 256, kinds 0-4; check that each holds at
    least the blocks an SM its split plan counts on."""
    rows = []
    for kern, regs, st, ld in ptxas_report(report):
        m = (re.search(r"flash_decode_f32_kernel\s*<\s*(\d+)\s*,\s*(\d+)\s*>", kern)
             or re.search(r"flash_decode_f32_kernelILi(\d+)ELi(\d+)E", kern))
        if m and int(m.group(2)) in (64, 128, 256):
            kind, D = int(m.group(1)), int(m.group(2))
            blocks = decode_blocks_per_sm(D, torch.float32, F32_Q_KV[kind])
            rows.append((kind, D, kern, regs, st, ld, blocks))
            print(f"[build] flash_decode f32 q, {str(F32_Q_KV[kind])[6:]} K/V, D={D} ({kern}): "
                  f"{regs} registers, spill stores {st} bytes, spill loads {ld} bytes, {blocks} "
                  f"blocks an SM", flush=True)
            want = planned_blocks_per_sm(D, torch.float32, F32_Q_KV[kind])
            check(blocks >= want, f"flash_decode {kern}: {blocks} blocks an SM, below the split "
                  f"plan's {want}")
    if report:
        check(sorted((kind, D) for kind, D, *_ in rows) ==
              sorted((kind, D) for kind in F32_Q_KV for D in (64, 128, 256)),
              "the register report lacks an f32-q variant of flash_decode")
    return sorted(rows)


def report_bf16_q_variants(report):
    """Print and check every bf16-q variant's registers, spills and blocks an
    SM: no spill, and at least the blocks an SM the split plan counts on."""
    rows = bf16_q_variants(report)
    for kind, D, kern, regs, st, ld, blocks in rows:
        print(f"[build] flash_decode bf16 q, {str(BF16_Q_KV[kind])[6:]} K/V, D={D} ({kern}): "
              f"{regs} registers, spill stores {st} bytes, spill loads {ld} bytes, {blocks} "
              f"blocks an SM", flush=True)
    if not report:
        print("[build] flash_decode was already built: no register report", flush=True)
        return rows
    check(sorted((kind, D) for kind, D, *_ in rows) ==
          sorted((kind, D) for kind in BF16_Q_KV for D in (64, 128, 256)),
          "the register report lacks a bf16-q variant of flash_decode")
    for kind, D, kern, regs, st, ld, blocks in rows:
        check(st == 0 and ld == 0, f"flash_decode {kern} spills")
        want = planned_blocks_per_sm(D, torch.bfloat16, BF16_Q_KV[kind])
        check(blocks >= want, f"flash_decode {kern}: {blocks} blocks an SM, below the split "
              f"plan's {want}")
    return rows


def serve_kv(tag, base, params, requests, kv_dtype):
    """Serve ``requests`` through ``ServingEngine`` on ``base``'s config with
    ``kv_dtype``: every prefill through the attention kernel (the SIMT one
    in float32) once a layer, every decode step through the decode kernel
    once a layer on K/V in the cache's dtype; valid tokens.  Returns the
    served stats."""
    dev = base.device
    cfg = dataclasses.replace(base.cfg, kv_dtype=kv_dtype)
    model = LM(cfg, device=dev)
    engine = ServingEngine(model, params, max_batch=SERVE_B, max_seq=SERVE_C)
    qd, kvd = torch_dtype(cfg.dtype), torch_dtype(kv_dtype or cfg.dtype)
    check(all(c[key].dtype == kvd for c in engine.caches for key in ("k", "v")),
          f"[{tag}] the engine's cache is not {kvd}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    flash_attention.launches = flash_attention.wgmma_launches = 0
    flash_attention.simt_launches = flash_decode.launches = 0
    flash_decode.kind_launches.clear()
    done, prefill_s, step_s, wall = serve(engine, requests)
    attn, dec, kinds = flash_attention.launches, flash_decode.launches, \
        dict(flash_decode.kind_launches)
    peak = torch.cuda.max_memory_allocated()
    check(attn == cfg.n_layers * len(requests),
          f"[{tag}] flash_attention launched {attn} times for {len(requests)} prefills")
    route = flash_attention.simt_launches if qd == torch.float32 else \
        flash_attention.wgmma_launches
    check(route == attn, f"[{tag}] of {attn} attention launches {route} went through the "
          f"{'SIMT' if qd == torch.float32 else 'tensor-core'} kernel")
    check(dec == cfg.n_layers * len(step_s),
          f"[{tag}] flash_decode launched {dec} times for {len(step_s)} decode steps")
    check(kinds == ({(qd, kvd): dec} if kvd != qd else {}),
          f"[{tag}] decode launches by K/V kind {kinds}, wanted all {dec} on "
          f"{kind_name(qd, kvd)}")
    report_serve(tag, cfg, requests, done, prefill_s, step_s, wall)
    print(f"[{tag}] flash_attention launches {attn} = {cfg.n_layers} layers x {len(requests)} "
          f"prefills; flash_decode launches {dec} = {cfg.n_layers} layers x {len(step_s)} "
          f"decode steps, all on {kind_name(qd, kvd)}; decode step median "
          f"{1e3 * float(np.median(step_s)):.2f} ms; peak memory {peak / 2**30:.2f} GiB",
          flush=True)
    del engine
    torch.cuda.empty_cache()
    return dict(model=model, done=done, steps=len(step_s), attn=attn, dec=dec,
                step_ms_median=1e3 * float(np.median(step_s)),
                prefill_ms=[1e3 * x for x in prefill_s], peak_gib=peak / 2**30,
                tokens_per_s=sum(len(t) for t in done.values()) / wall)


def agreement(requests, done, ref) -> float:
    same = [a == b for rid, _, _ in requests for a, b in zip(done[rid], ref[rid])]
    return float(np.mean(same))


def kvdtype_decode_check(tag, model, ref_model, params, requests):
    """DECODE_CHECK_STEPS decode steps of ``model`` (its cache in another
    dtype) from one prefilled cache through the decode kernel, held against
    the same steps through the plain decode attention on the same cache
    within LOGITS_F32_TOL of max |logit| (both read the cache in float32),
    and by phase 6's RMS rule against the plain steps over ``ref_model``'s
    cache in the model's own dtype (the unrounded K/V): the kernel's RMS
    distance from them at most BF16_NOISE_FACTOR times the plain route's."""
    dev = model.device

    def prefilled(m):
        engine = ServingEngine(m, params, max_batch=SERVE_B, max_seq=SERVE_C)
        for req in requests[:SERVE_B]:
            engine.add_request(*req)
        return engine.tokens.clone(), engine.pos.clone(), engine.caches

    first, pos0, caches = prefilled(model)
    _, _, ref_caches = prefilled(ref_model)
    rng = np.random.default_rng(3)
    feed = [first] + [torch.as_tensor(rng.integers(0, model.cfg.vocab, SERVE_B), device=dev)
                      for _ in range(DECODE_CHECK_STEPS - 1)]

    def decode(cfg, caches0, decode_fn):
        m = LM(cfg, device=dev, decode_fn=decode_fn)
        c = _tree_map(lambda t: t.clone(), caches0)
        out = []
        with torch.inference_mode():
            for t in range(DECODE_CHECK_STEPS):
                lg, c = m.decode_step(params, feed[t], pos0 + t, c)
                out.append(lg.float())
        return torch.stack(out)

    kern = decode(model.cfg, caches, None)
    plain = decode(model.cfg, caches, decode_attention_ref)
    ref = decode(ref_model.cfg, ref_caches, decode_attention_ref)
    del caches, ref_caches
    torch.cuda.empty_cache()
    check(bool(torch.isfinite(kern).all()), f"[{tag}] non-finite decode logits")
    scale, err = float(plain.abs().max()), float((kern - plain).abs().max())
    rms_kern, rms_plain = _rms(kern, ref), _rms(plain, ref)
    print(f"[{tag}] decode logits, {DECODE_CHECK_STEPS} steps at batch {SERVE_B}, decode "
          f"kernel vs plain decode attention on the same cache: max abs diff {err:.4e} (max "
          f"|logit| {scale:.4f}, tol {LOGITS_F32_TOL} of it); RMS from the plain route over "
          f"the {model.cfg.dtype} cache: kernel {rms_kern:.4e}, plain {rms_plain:.4e} (tol "
          f"{BF16_NOISE_FACTOR}x)", flush=True)
    check(err <= LOGITS_F32_TOL * scale,
          f"[{tag}] decode logits differ by {err:.4e}, beyond {LOGITS_F32_TOL} x {scale:.4f}")
    check(rms_kern <= BF16_NOISE_FACTOR * rms_plain,
          f"[{tag}] decode logits are {rms_kern:.4e} RMS from the unrounded cache's, beyond "
          f"{BF16_NOISE_FACTOR} x the plain route's {rms_plain:.4e}")
    return dict(max_abs_diff=err, max_abs_logit=scale, rms_kernel=rms_kern, rms_plain=rms_plain)


def kvdtype_serve_part(dev):
    """(c) Full-width Minitron-8B in float32 (30.9 GB of weights from a
    seed) served from a bfloat16 cache: every decode launch on the bf16-K/V
    kind, the prefill through the f32 attention kernel, the kernel reading
    the engine's cache itself, 4 decode steps held against the plain route,
    greedy agreement with the float32 cache's tokens; then from a float16
    cache, and the same weights rounded to bfloat16 served from float32 and
    float16 caches beside a bfloat16 one.  Returns the line and the decode
    launches by K/V kind and path."""
    tag = "kvdtype"
    cfg = dataclasses.replace(get_config(DENSE_ARCH), dtype="float32")
    base = LM(cfg, device=dev)
    params = base.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"[{tag}] {cfg.name} in float32: {n_params} parameters, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB", flush=True)
    requests = serve_requests_for(cfg)
    line, launches = {"arch": cfg.name}, {}
    ref = serve_kv(f"{tag} f32 cache", base, params, requests, None)
    main = serve_kv(f"{tag} bf16 cache", base, params, requests, "bfloat16")
    # the decode kernel reads the engine's bf16 cache itself: each layer's
    # call gets that layer's slice of the stacked cache, not a cast copy
    seen = []

    def recorder(q, k, v, lengths):
        seen.append((q.dtype, k.dtype, k.data_ptr(), v.data_ptr()))
        return flash_decode(q, k, v, lengths)

    cfg16 = main["model"].cfg
    engine = ServingEngine(LM(cfg16, device=dev, decode_fn=recorder), params,
                           max_batch=SERVE_B, max_seq=SERVE_C)
    engine.add_request(*requests[0])
    engine.step()
    (cache,) = engine.caches
    want = [(torch.float32, torch.bfloat16, cache["k"][i].data_ptr(), cache["v"][i].data_ptr())
            for i in range(cfg.n_layers)]
    check(seen == want, "a decode step's kernel calls did not read the engine's bf16 cache")
    print(f"[{tag}] a decode step's {len(seen)} kernel calls each read its layer's bf16 slice "
          "of the engine's cache (no cast copy)", flush=True)
    del engine, cache
    torch.cuda.empty_cache()
    hold = kvdtype_decode_check(f"{tag} bf16 cache", main["model"], ref["model"], params,
                                requests)
    f16 = serve_kv(f"{tag} f16 cache", base, params, requests, "float16")
    for name, res in (("bfloat16", main), ("float16", f16)):
        line[f"float32 model, {name} cache"] = dict(
            {key: res[key] for key in ("steps", "step_ms_median", "prefill_ms", "peak_gib",
                                       "tokens_per_s", "attn", "dec")},
            greedy_agreement_with_float32_cache=agreement(requests, res["done"], ref["done"]))
        print(f"[{tag}] float32 model, {name} cache: greedy tokens equal to the float32 "
              f"cache's {line[f'float32 model, {name} cache']['greedy_agreement_with_float32_cache']:.3f}; "
              f"decode step median {res['step_ms_median']:.2f} ms (float32 cache "
              f"{ref['step_ms_median']:.2f}); peak {res['peak_gib']:.2f} GiB (float32 cache "
              f"{ref['peak_gib']:.2f})", flush=True)
    line["float32 model, bfloat16 cache"]["decode_check"] = hold
    line["float32 model, float32 cache"] = {key: ref[key] for key in (
        "steps", "step_ms_median", "peak_gib", "tokens_per_s")}
    launches[(torch.float32, torch.bfloat16)] = {"kvdtype float32 model": main["dec"]}
    launches[(torch.float32, torch.float32)] = {"kvdtype float32 cache": ref["dec"]}
    launches[(torch.float32, torch.float16)] = {"kvdtype float32 model": f16["dec"]}
    same_kind = {"kvdtype float32 cache": ref["dec"]}
    attn = {"kvdtype float32 model": ref["attn"] + main["attn"] + f16["attn"]}
    del base, ref, main, f16
    params = _tree_map(lambda t: t.to(torch.bfloat16), params)
    torch.cuda.empty_cache()
    base16 = LM(dataclasses.replace(cfg, dtype="bfloat16"), device=dev)
    ref16 = serve_kv(f"{tag} bf16 model", base16, params, requests, None)
    for name in ("float32", "float16"):
        res = serve_kv(f"{tag} bf16 model {name} cache", base16, params, requests, name)
        agree = agreement(requests, res["done"], ref16["done"])
        line[f"bfloat16 model, {name} cache"] = dict(
            {key: res[key] for key in ("steps", "step_ms_median", "peak_gib", "tokens_per_s",
                                       "attn", "dec")},
            greedy_agreement_with_bfloat16_cache=agree)
        print(f"[{tag}] bfloat16 model, {name} cache: greedy tokens equal to the bfloat16 "
              f"cache's {agree:.3f}; decode step median {res['step_ms_median']:.2f} ms "
              f"(bfloat16 cache {ref16['step_ms_median']:.2f})", flush=True)
        launches[(torch.bfloat16, torch_dtype(name))] = {"kvdtype bfloat16 model": res["dec"]}
        attn["kvdtype bfloat16 model"] = attn.get("kvdtype bfloat16 model", 0) + res["attn"]
    same_kind["kvdtype bfloat16 cache"] = ref16["dec"]
    attn["kvdtype bfloat16 model"] += ref16["attn"]
    del params, base16, ref16
    torch.cuda.empty_cache()
    return line, launches, same_kind, attn


def audit_kvdtype_phase(dev, report="", kinds=None):
    """Phase 15: (a) the kernel audit on the card, (b) the decode kernel's
    kinds for K/V in another float dtype against the plain version with
    their times (``kv_kinds_part``, unless ``kinds`` holds its result) and
    the registers, spills and blocks an SM of every bf16-q variant (from
    ``report``, the build's ``-Xptxas -v`` output, where this run built the
    kernel), (c) a
    float32 Minitron-8B served from a bfloat16 cache and the other kinds'
    caches.  Returns the ``audit_kvdtype`` line, the kinds' held results,
    the main-path decode launches by kind and path, the kind-0 decode
    launches and the attention launches by path."""
    t_phase = time.perf_counter()
    line = {"audit": audit_part(dev)}
    line["registers"] = [dict(kv_dtype=str(BF16_Q_KV[kind])[6:], D=D, kernel=k, registers=r,
                              spill_stores=st, spill_loads=ld, blocks_per_sm=blocks)
                         for kind, D, k, r, st, ld, blocks in bf16_q_variants(report)]
    kinds = kinds or kv_kinds_part(dev)
    line["kinds"] = {kind_name(*key): timing for key, (_, timing) in kinds.items()}
    served, launches, same_kind, attn = kvdtype_serve_part(dev)
    line["serve"] = served
    line["seconds"] = time.perf_counter() - t_phase
    print(f"[kvdtype] phase took {line['seconds']:.1f} s", flush=True)
    return {"audit_kvdtype": line}, kinds, launches, same_kind, attn


# the per-shape numbers of a kernel's row in the kernels line
SHAPE_KEYS = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")


def meta_plan_check():
    """The decode wrapper and the dry-run's meta route plan the split scratch
    from ``flash_decode.heads_per_block`` and ``clustered`` (whose variants'
    splits, at most MAX_CLUSTER, are one cluster and take no scratch), the
    meta route for an H100's SMs: all must be the built kernel's and the
    card's, at every head size and K/V kind."""
    kinds = {torch.bfloat16: tuple(BF16_Q_KV.values()),
             torch.float32: (torch.float32, FLOAT8_KV, torch.float8_e5m2, torch.bfloat16,
                             torch.float16)}
    for qd, kv_dtypes in kinds.items():
        for D in (32, 64, 128, 256):
            check(heads_per_block(D, qd) == decode_lib().flash_decode_heads_per_block(
                D, int(qd == torch.bfloat16)),
                f"heads_per_block({D}, {qd}) differs from the kernel's")
            for kvd in kv_dtypes:
                got = decode_lib().flash_decode_max_splits(D, int(qd == torch.bfloat16),
                                                           kv_kind(qd, kvd))
                want = MAX_CLUSTER if clustered(D, qd) else 0
                check(got == want, f"the kernel's most splits at D={D}, {qd} q, {kvd} K/V are "
                      f"{got}, the wrapper plans for {want}")
    check(kernel_meta.H100_SMS == torch.cuda.get_device_properties(0).multi_processor_count,
          "meta's decode split plan assumes another SM count")
    print(f"[build] flash_decode.heads_per_block and clustered equal the built kernel's "
          f"heads a block and clustered variants at every head size and K/V kind; "
          f"the meta route's {kernel_meta.H100_SMS} SMs are the card's", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    dev = torch.device("cuda")
    card = gpu_line()
    print(card, flush=True)
    print(f"[device] {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}, "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t = time.perf_counter()
    reports = build(["rwkv6_scan", "flash_attention", "flash_decode", "bf16_split"])
    print(f"[build] all four kernels built in parallel in {time.perf_counter() - t:.1f} s",
          flush=True)
    for name, report in reports.items():
        print(f"[build] {name}:", flush=True)
        for line in report.splitlines() or ["(library already built)"]:
            print(f"[build]   {line}", flush=True)
    print(f"[build] rwkv6_scan dynamic shared memory per block of its output pass at "
          f"N={N}: {smem_bytes(N)} bytes (256 threads a block)", flush=True)
    print(f"[build] flash_attention dynamic shared memory per block: bf16 (wgmma) "
          + ", ".join(f"D={d} {attn_smem_bytes(d)} bytes" for d in (32, 64, 128, 256))
          + "; f32 (SIMT) "
          + ", ".join(f"D={d} {attn_smem_bytes(d, torch.float32)} bytes"
                      for d in (32, 64, 128, 256))
          + " (bf16: 160 threads a block, two blocks an SM, one at D=256; f32: 256 "
          "threads)", flush=True)
    report_attention_variants(reports.get("flash_attention", ""))
    print(f"[build] flash_decode dynamic shared memory per block: bf16 "
          + ", ".join(f"D={d} {decode_smem_bytes(d)} bytes" for d in (32, 64, 128, 256))
          + "; f32 "
          + ", ".join(f"D={d} {decode_smem_bytes(d, torch.float32)} bytes"
                      for d in (32, 64, 128, 256))
          + "; bf16 q, float8 K/V "
          + ", ".join(f"D={d} {decode_smem_bytes(d, torch.bfloat16, FLOAT8_KV)} bytes"
                      for d in (32, 64, 128, 256))
          + "; f32 q, float8 K/V "
          + ", ".join(f"D={d} {decode_smem_bytes(d, torch.float32, FLOAT8_KV)} bytes"
                      for d in (32, 64, 128, 256))
          + " (128 threads a block)", flush=True)
    # under a bf16 q the float8 ring may take no more than q's own; the f32
    # kernel sizes its tiles by the element width (more float8 slots a
    # tile), and report_f32_q_variants holds each of its variants to the
    # blocks an SM the split plan counts on instead
    for d in (32, 64, 128, 256):
        check(decode_smem_bytes(d, torch.bfloat16, FLOAT8_KV) <= decode_smem_bytes(d),
              f"the float8 ring at D={d} takes more shared memory than bf16's: the split "
              "plan would not hold")
    meta_plan_check()
    for name in ("rwkv6_scan", "flash_decode", "bf16_split"):
        for kern, regs, st, ld in ptxas_report(reports.get(name, "")):
            print(f"[build] {name} {kern}: {regs} registers, spill stores {st} bytes, "
                  f"spill loads {ld} bytes", flush=True)
    report_bf16_q_variants(reports.get("flash_decode", ""))
    report_f32_q_variants(reports.get("flash_decode", ""))

    worst, timing = kernel_phase(dev)
    split_phase(dev)
    attn_worst, attn_t = attention_phase(dev)
    dec_worst, dec_t = decode_phase(dev)
    dec8_worst, dec8_t = float8_decode_phase(dev)
    # phase 15's (b) runs here, beside the other decode checks: late in a
    # whole run (after phase 14) torch.profiler saw no device event in nine
    # profiles of one call in a row, and (b) counts a call's kernels so
    kv_kinds = kv_kinds_part(dev)
    flash_attention.launches = flash_decode.launches = 0
    model, params, launches = serve_phase(dev)
    check(flash_attention.launches == 0 and flash_decode.launches == 0,
          "the RWKV6 serving path launched an attention kernel")
    fit_phase("fit", model, params, (rwkv6_scan,))
    del model, params
    torch.cuda.empty_cache()
    (dense_attn_launches, dense_dec_launches), dense_fit, (dense8, dense8_launches) = \
        dense_phase(dev)
    torch.cuda.empty_cache()
    attn_launches, _, _ = train_phase(dev)
    torch.cuda.empty_cache()
    place = place_phase(dev)
    torch.cuda.empty_cache()
    stream = stream_phase(dev, dense_fit)
    torch.cuda.empty_cache()
    moe, moe_attn_launches, moe_dec_launches = moe_phase(dev)
    torch.cuda.empty_cache()
    hybrid, hybrid_attn_launches, hybrid_dec_launches = hybrid_phase(dev)
    torch.cuda.empty_cache()
    vlm_audio, vlm_audio_attn, vlm_audio_dec = vlm_audio_phase(dev)
    torch.cuda.empty_cache()
    train_mh, train_mh_attn = train_moe_hybrid_phase(dev)
    torch.cuda.empty_cache()
    distribution, dist_attn = distribution_phase(dev)
    torch.cuda.empty_cache()
    audit_kvdtype, kv_kinds, kv_launches, kv_same_kind, kv_attn = audit_kvdtype_phase(
        dev, reports.get("flash_decode", ""), kv_kinds)

    main_t, dec_main, attn_main = timing[512], dec_t["served"], attn_t["train"]
    attn_by_path = {"dense": dense_attn_launches, "train": attn_launches,
                    "moe": moe_attn_launches, "hybrid": hybrid_attn_launches, **vlm_audio_attn,
                    **train_mh_attn, **dist_attn, **kv_attn}
    dec_by_path = {"dense": dense_dec_launches, "moe": moe_dec_launches,
                   "hybrid": hybrid_dec_launches, **vlm_audio_dec, **kv_same_kind}
    print(f"[done] {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps(place), flush=True)
    print(json.dumps(stream), flush=True)
    print(json.dumps(moe), flush=True)
    print(json.dumps(hybrid), flush=True)
    print(json.dumps(vlm_audio), flush=True)
    print(json.dumps(dense8), flush=True)
    print(json.dumps(train_mh), flush=True)
    print(json.dumps(distribution), flush=True)
    print(json.dumps(audit_kvdtype), flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": [{
        "name": "rwkv6_scan",
        "route": "cuda",
        "source": "src/repro_torch/csrc/rwkv6_scan.cu",
        "replaces": "src/repro/kernels/rwkv6_scan.py:99",
        "launches": launches,
        "kernels_per_call": main_t["kernels_per_call"],
        "max_abs_err": worst,
        "ms": main_t["ms"],
        "plain_ms": main_t["plain_ms"],
        "bound_ms": main_t["bound_ms"],
        "bound_by": main_t["bound_by"],
        "library_ms": None,
    }, {
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:97",
        "launches": sum(attn_by_path.values()),
        "launches_by_path": attn_by_path,
        "kernels_per_call": attn_main["kernels_per_call"],
        "max_abs_err": attn_worst,
        "ms": attn_main["ms"],
        "plain_ms": attn_main["plain_ms"],
        "bound_ms": attn_main["bound_ms"],
        "bound_by": attn_main["bound_by"],
        "library_ms": attn_main["library_ms"],
        "by_shape": {name: {key: attn_t[name][key] for key in SHAPE_KEYS} for name in attn_t},
    }, {
        "name": "flash_decode",
        "route": "cuda",
        "source": "src/repro_torch/csrc/flash_decode.cu",
        "replaces": "src/repro/kernels/flash_decode.py:76",
        "launches": sum(dec_by_path.values()),
        "launches_by_path": dec_by_path,
        "kernels_per_call": dec_t["kernels_per_call"],
        "max_abs_err": dec_worst,
        "ms": dec_main["ms"],
        "plain_ms": dec_main["plain_ms"],
        "bound_ms": dec_main["bound_ms"],
        "bound_by": dec_main["bound_by"],
        "library_ms": dec_main["library_ms"],
        "by_shape": {name: {key: val[key] for key in SHAPE_KEYS}
                     for name, val in dec_t.items() if isinstance(val, dict)},
    }, {
        "name": "flash_decode (float8_e4m3fn K/V)",
        "route": "cuda",
        "source": "src/repro_torch/csrc/flash_decode.cu",
        "replaces": "src/repro/kernels/flash_decode.py:76",
        "launches": dense8_launches,
        "launches_by_path": {"dense float8": dense8_launches},
        "kernels_per_call": dec8_t["kernels_per_call"],
        "max_abs_err": dec8_worst,
        "ms": dec8_t["float8 served"]["ms"],
        "plain_ms": dec8_t["float8 served"]["plain_ms"],
        "bound_ms": dec8_t["float8 served"]["bound_ms"],
        "bound_by": dec8_t["float8 served"]["bound_by"],
        "library_ms": dec8_t["float8 served"]["library_ms"],
        "by_shape": {name: {key: val[key] for key in SHAPE_KEYS}
                     for name, val in dec8_t.items() if isinstance(val, dict)},
    }] + [{
        "name": f"flash_decode ({kind_name(*key)})",
        "route": "cuda",
        "source": "src/repro_torch/csrc/flash_decode.cu",
        "replaces": "src/repro/kernels/flash_decode.py:76",
        "launches": sum(kv_launches[key].values()),
        "launches_by_path": kv_launches[key],
        "kernels_per_call": timing_kv["kernels_per_call"],
        "max_abs_err": worst_kv,
        **{k: timing_kv["served"][k] for k in SHAPE_KEYS},
        "by_shape": {name: {k: val[k] for k in SHAPE_KEYS}
                     for name, val in timing_kv.items() if isinstance(val, dict)},
    } for key, (worst_kv, timing_kv) in kv_kinds.items()]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
