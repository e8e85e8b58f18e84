# The paper's PGAS data structures with selectable RDMA / RPC backends,
# ported from `repro.core` (same module names, same public functions).
from . import (adaptive, am, cache, costmodel, faults, hashtable, pipeline,
               queue, routing, txn, types, window)
from .adaptive import AdaptiveEngine, Decision, default_engine
from .pipeline import Handle, Pipeline
from .types import AmoKind, Backend, OpStats, Promise
from .window import Window, make_window, rdma_cas, rdma_fao, rdma_get, rdma_put

__all__ = [
    "adaptive", "am", "cache", "costmodel", "faults", "hashtable",
    "pipeline", "queue", "routing", "txn", "types", "window",
    "AdaptiveEngine", "Decision", "default_engine",
    "Handle", "Pipeline",
    "AmoKind", "Backend", "OpStats", "Promise",
    "Window", "make_window", "rdma_cas", "rdma_fao", "rdma_get", "rdma_put",
]
