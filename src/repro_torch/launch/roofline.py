"""Roofline over the dry-run grid, priced for NVIDIA H100 SXM cards.

The counterpart of the JAX package's ``launch/roofline.py``.  Per (arch x
shape x mesh) cell, the three roofline terms from the dry-run's per-device
numbers (``launch/dryrun.py``):

    compute    = flops_per_device / PEAK_FLOPS        (989 TFLOP/s dense bf16)
    memory     = bytes_per_device / HBM_BW            (3.35 TB/s)
    collective = the sum over mesh axes of the bytes a device sends over
                 that axis / that axis's bandwidth: NVLink 4 (450 GB/s a
                 direction) for an axis whose groups lie within one 8-GPU
                 node, InfiniBand NDR (400 Gb/s = 50 GB/s a GPU) for one
                 that crosses nodes

The figures are NVIDIA's H100 SXM data sheet (dense bf16 tensor-core peak,
HBM3 rate, fourth-generation NVLink at 900 GB/s both directions) and one
ConnectX-7 NDR port a GPU, as in NVIDIA's DGX H100 nodes of eight cards.
The production meshes' ranks run row-major over ("pod",) "data", "model",
eight to a node, so every axis of 16 crosses nodes.

The step-time bound is the largest term, and the largest term is the
bottleneck.  Also reported, as in the reference:

    MODEL_FLOPS  = k*N*D  (k = 6 train / 2 inference, N = params, or active
                   params for MoE, D = tokens processed)
    useful_ratio = MODEL_FLOPS / (flops_per_device * chips)
    mfu_bound    = MODEL_FLOPS / (chips * peak * bound)

The memory term is an upper bound: the dry-run's bytes count every aten
op's operands and results in full.  From the dry-run's ``memory`` record
(a device's bytes from the traced peak of live bytes) each row also gives
``hbm_temp_gib``, its temporaries (the reference's column, read from
``temp_size_in_bytes`` as there), ``peak_gib``, the whole peak, and
``fits``, the peak within ``HBM_BYTES``, one card's memory.
"""
from __future__ import annotations

import argparse
import json
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from ..configs.shapes import SHAPES

__all__ = ["PEAK_FLOPS", "HBM_BW", "HBM_BYTES", "NVLINK_BW", "IB_BW", "GPUS_PER_NODE", "model_flops",
           "axis_bandwidth", "roofline_row", "build_table", "format_table", "main"]

PEAK_FLOPS = 989e12        # dense bf16 a card (H100 SXM data sheet)
HBM_BW = 3.35e12           # bytes/s a card (H100 SXM data sheet)
# bytes a card holds: torch.cuda.get_device_properties(0).total_memory on an
# NVIDIA H100 80GB HBM3 (power limit 700.00 W), read by chip_smoke.py phase 14
HBM_BYTES = 85_017_493_504
NVLINK_BW = 450e9          # bytes/s a direction a card, NVLink 4 inside a node
IB_BW = 50e9               # bytes/s a card, InfiniBand NDR 400 Gb/s between nodes
GPUS_PER_NODE = 8


def model_flops(rec: Dict[str, Any]) -> float:
    shape = SHAPES[rec["shape"]]
    n = rec.get("active_params") or rec.get("params")
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    tokens = shape.global_batch          # decode: one token per sequence
    return 2.0 * n * tokens


def axis_bandwidth(mesh_shape: Dict[str, int], axes: Sequence[str],
                   gpus_per_node: int = GPUS_PER_NODE) -> float:
    """NVLink's rate when every group of ``axes`` (ranks laid out row-major
    over the mesh, ``gpus_per_node`` to a node) lies within one node, else
    InfiniBand's."""
    names = list(mesh_shape)
    ranks = np.arange(int(np.prod(list(mesh_shape.values())))).reshape(
        tuple(mesh_shape.values()))
    idx = [names.index(a) for a in axes]
    rest = [i for i in range(len(names)) if i not in idx]
    groups = np.transpose(ranks, rest + idx).reshape(-1, int(np.prod([ranks.shape[i]
                                                                        for i in idx])))
    node = groups // gpus_per_node
    within = bool(np.all(node.min(axis=1) == node.max(axis=1)))
    return NVLINK_BW if within else IB_BW


def roofline_row(rec: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    if rec.get("status") != "ok":
        return None
    chips = rec["chips"]
    compute = rec["flops_per_device"] / PEAK_FLOPS
    memory = rec["bytes_per_device"] / HBM_BW
    coll = sum(nbytes / axis_bandwidth(rec["mesh_shape"], label.split("+"))
               for label, nbytes in rec["collectives"]["wire_by_axis"].items())
    terms = {"compute": compute, "memory": memory, "collective": coll}
    dominant = max(terms, key=terms.get)
    bound = max(terms.values())
    mf = model_flops(rec)
    useful = mf / max(rec["flops_per_device"] * chips, 1e-30)
    mfu_bound = mf / (chips * PEAK_FLOPS * max(bound, 1e-30))
    mem = rec["memory"]
    return {
        "arch": rec["arch"], "shape": rec["shape"], "mesh": rec["mesh"],
        "chips": chips,
        "compute_s": compute, "memory_s": memory, "collective_s": coll,
        "dominant": dominant, "bound_s": bound,
        "model_flops": mf, "useful_ratio": useful, "mfu_bound": mfu_bound,
        "hbm_temp_gib": mem["temp_size_in_bytes"] / 2**30,
        "peak_gib": mem["peak_bytes"] / 2**30, "fits": mem["fits"],
        "variant": rec.get("variant", {}),
    }


def build_table(results: Dict[str, Any], mesh: str = "single",
                include_variants: bool = False) -> List[Dict[str, Any]]:
    rows = []
    for key, rec in sorted(results.items()):
        if rec.get("mesh") != mesh:
            continue
        if not include_variants and rec.get("variant"):
            if set(rec["variant"].keys()) - {"remat"}:
                continue
        row = roofline_row(rec)
        if row:
            rows.append(row)
    return rows


def format_table(rows: List[Dict[str, Any]]) -> str:
    hdr = (f"{'arch':22s} {'shape':12s} {'compute':>9s} {'memory':>9s} "
           f"{'collect':>9s} {'dominant':>10s} {'useful':>7s} {'mfu<=':>6s} "
           f"{'peak GiB':>9s} {'fits':>4s}")
    out = [hdr, "-" * len(hdr)]
    for r in rows:
        out.append(
            f"{r['arch']:22s} {r['shape']:12s} {r['compute_s']:9.3g} "
            f"{r['memory_s']:9.3g} {r['collective_s']:9.3g} "
            f"{r['dominant']:>10s} {r['useful_ratio']:7.2f} {r['mfu_bound']:6.2f} "
            f"{r['peak_gib']:9.2f} {'yes' if r['fits'] else 'no':>4s}"
        )
    return "\n".join(out)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--results", default="dryrun_results.json")
    ap.add_argument("--mesh", default="single", choices=("single", "multi"))
    ap.add_argument("--variants", action="store_true")
    args = ap.parse_args(argv)
    with open(args.results) as f:
        results = json.load(f)
    rows = build_table(results, mesh=args.mesh, include_variants=args.variants)
    print(format_table(rows))


if __name__ == "__main__":
    main()
