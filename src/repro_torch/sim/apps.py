"""The four DAG applications used in the paper's evaluation (§V-C, Fig. 6).

  (1) LightGBM          read -> PCA -> {train_tree x K} -> combine/test
  (2) MapReduce sort    {map x M} -> {reduce x R}
  (3) Video analytics   split -> {extract_frame x C} -> classify
  (4) Matrix compute    {mat_mul, mat_inv} -> mat_mul -> mat_vec

Task-type ids index :data:`repro_torch.sim.profiles.TASK_TYPES`.  Data sizes are
chosen so cross-device transfers cost 0.05-0.5 s at ~100 MB/s links and
model uploads are expensive enough that artifact-cache awareness matters —
matching the regimes in the paper's Figs. 8-11.
"""
from __future__ import annotations

from typing import Callable, Dict, List

from ..core.dag import AppDAG, TaskSpec

MB = 1e6

__all__ = ["lightgbm_app", "mapreduce_app", "video_app", "matrix_app", "APP_BUILDERS", "all_apps"]


def lightgbm_app(n_trees: int = 6) -> AppDAG:
    tasks: List[TaskSpec] = [
        TaskSpec("read", ttype=0, out_bytes=40 * MB, mem_bytes=300 * MB),
        TaskSpec("pca", ttype=1, deps=("read",), out_bytes=12 * MB, mem_bytes=500 * MB),
    ]
    for k in range(n_trees):
        tasks.append(
            TaskSpec(
                f"train{k}", ttype=2, deps=("pca",), out_bytes=4 * MB,
                model_id="lgbm-lib", model_bytes=60 * MB, mem_bytes=800 * MB,
            )
        )
    tasks.append(
        TaskSpec(
            "combine", ttype=3, deps=tuple(f"train{k}" for k in range(n_trees)),
            out_bytes=1 * MB, mem_bytes=400 * MB,
        )
    )
    return AppDAG.from_tasks("lightgbm", tasks)


def mapreduce_app(n_map: int = 4, n_reduce: int = 2) -> AppDAG:
    tasks: List[TaskSpec] = [
        TaskSpec(f"map{m}", ttype=4, out_bytes=25 * MB, mem_bytes=400 * MB)
        for m in range(n_map)
    ]
    maps = tuple(f"map{m}" for m in range(n_map))
    for r in range(n_reduce):
        tasks.append(
            TaskSpec(f"reduce{r}", ttype=5, deps=maps, out_bytes=10 * MB,
                     mem_bytes=600 * MB)
        )
    return AppDAG.from_tasks("mapreduce", tasks)


def video_app(n_chunks: int = 4) -> AppDAG:
    tasks: List[TaskSpec] = [
        TaskSpec("split", ttype=6, out_bytes=30 * MB, mem_bytes=350 * MB)
    ]
    for c in range(n_chunks):
        tasks.append(
            TaskSpec(f"extract{c}", ttype=7, deps=("split",), out_bytes=3 * MB,
                     mem_bytes=450 * MB)
        )
    tasks.append(
        TaskSpec(
            "classify", ttype=8, deps=tuple(f"extract{c}" for c in range(n_chunks)),
            out_bytes=0.2 * MB, model_id="resnet", model_bytes=160 * MB,
            mem_bytes=900 * MB,
        )
    )
    return AppDAG.from_tasks("video", tasks)


def matrix_app() -> AppDAG:
    tasks = [
        TaskSpec("mm0", ttype=10, out_bytes=16 * MB, mem_bytes=500 * MB),
        TaskSpec("inv0", ttype=9, out_bytes=16 * MB, mem_bytes=500 * MB),
        TaskSpec("mm1", ttype=10, deps=("mm0", "inv0"), out_bytes=16 * MB,
                 mem_bytes=500 * MB),
        TaskSpec("mv0", ttype=11, deps=("mm1",), out_bytes=0.1 * MB,
                 mem_bytes=250 * MB),
    ]
    return AppDAG.from_tasks("matrix", tasks)


APP_BUILDERS: Dict[str, Callable[[], AppDAG]] = {
    "lightgbm": lightgbm_app,
    "mapreduce": mapreduce_app,
    "video": video_app,
    "matrix": matrix_app,
}


def all_apps() -> List[AppDAG]:
    return [b() for b in APP_BUILDERS.values()]
