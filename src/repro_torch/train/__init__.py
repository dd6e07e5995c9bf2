"""Training: the step factory (gradient accumulation over microbatches).
The cross-pod compressed reduction and the pipeline-parallel schedule are
queued in ROADMAP.md."""
from .step import TrainState, make_eval_step, make_train_step, value_and_grad

__all__ = ["TrainState", "make_train_step", "make_eval_step", "value_and_grad"]
