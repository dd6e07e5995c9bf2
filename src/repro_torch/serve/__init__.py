"""Serving: the continuous-batching engine (slot-based KV cache) and the
interference-aware fleet scheduler built on the IBDASH core."""
from .engine import ServingEngine, measure_interference
from .scheduler import RequestClass, ServingFleet, make_request_dag

__all__ = [
    "ServingEngine",
    "measure_interference",
    "ServingFleet",
    "RequestClass",
    "make_request_dag",
]
