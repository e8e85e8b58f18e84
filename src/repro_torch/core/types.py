"""Core types for the PGAS data-structure layer (port of `repro.core.types`).

Concurrency *promises* (paper §II-C): the caller declares which operations
may run concurrently with the one being issued, which selects the cheapest
correct implementation (paper Tables II/III).

AMO opcodes: the fixed-function "NIC" operations available in RDMA style.
Anything richer goes through the RPC/active-message backend. Every word
the structures store is int32 (`torch.int32` is pinned wherever JAX uses
int32; torch would default to int64).
"""
from __future__ import annotations

import enum
from dataclasses import dataclass

import numpy as np
import torch


class Promise(enum.Enum):
    """Concurrency promise levels, paper notation C_RW / C_W / C_R / C_l."""

    CRW = "concurrent_read_write"  # fully atomic
    CW = "concurrent_write"        # phasal: only writes concurrent
    CR = "concurrent_read"         # phasal: only reads concurrent
    CL = "concurrent_local"        # local-only access (queue is host-local)


class Backend(enum.Enum):
    RDMA = "rdma"   # one-sided component ops (put/get/CAS/FAO phases)
    RPC = "rpc"     # aggregated active messages (one round trip + handler)
    AUTO = "auto"   # cost-model-selected per batch (core/adaptive.py)


def as_backend(backend) -> "Backend":
    """Coerce a Backend or its string value ("rdma"/"rpc"/"auto")."""
    return Backend(backend) if isinstance(backend, str) else backend


class AmoKind(enum.IntEnum):
    """Fixed-function atomics. Integer codes shared with the CUDA kernels
    (kernels/csrc/owner_lane.cu) and kernels/ref.py.

    Codes 0-6 are the primitive single-word AMOs; codes 7-9 are fused
    component descriptors [off | kind | a | b | aux0 | aux1 | vals...]
    that the owner lane applies as one serialized compound step.
    """

    PUT = 0    # unconditional store, returns previous value
    GET = 1    # read, no modification
    CAS = 2    # compare(a)-and-swap(b), returns previous value
    FAA = 3    # fetch-and-add(a)
    FOR = 4    # fetch-and-or(a)
    FAND = 5   # fetch-and-and(a)
    FXOR = 6   # fetch-and-xor(a)
    CAS_PUT = 7       # CAS(a->b) at off; on success put vals at aux0
    CAS_PUT_PUB = 8   # CAS_PUT, then on success mem[off] ^= aux1 (publish)
    FAO_GET = 9       # fetch-and-op(a, subkind b) at off; gather from aux0


# Hash-table slot flag states (stored in the flag word of each slot).
FLAG_EMPTY = 0
FLAG_RESERVED = 1
FLAG_READY = 2
# Reader counting for C_RW find: readers add READ_UNIT to the flag word.
READ_UNIT = 256
STATE_MASK = 255

EMPTY_KEY = -0x7FFFFFFF  # sentinel for "no key present"


def to_device(x, dtype: torch.dtype, device) -> torch.Tensor:
    """A tensor, array or scalar as a `dtype` tensor on `device`. A host
    array or tensor bound for a CUDA device goes through pinned memory
    with a non-blocking copy, so the host does not wait for the work
    already queued on the stream (a pageable copy would); the caching
    host allocator keeps the pinned block until its copy has run."""
    dev = torch.device(device)
    if dev.type == "cuda" and (isinstance(x, np.ndarray) or (
            isinstance(x, torch.Tensor) and x.device.type == "cpu")):
        host = torch.as_tensor(x, dtype=dtype)
        return host.pin_memory().to(dev, non_blocking=True)
    return torch.as_tensor(x, dtype=dtype, device=dev)


def to_host(x):
    """numpy copy of a tensor or array (None stays None). A CUDA tensor's
    copy waits for the work that produces it."""
    if x is None or isinstance(x, np.ndarray):
        return x
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def as_i32(x, device) -> torch.Tensor:
    """A tensor, array or scalar as an int32 tensor on `device`."""
    return to_device(x, torch.int32, device)


def as_mask(x, shape, device) -> torch.Tensor:
    """An optional validity mask as a bool tensor (all True when None)."""
    if x is None:
        return torch.ones(shape, dtype=torch.bool, device=device)
    return to_device(x, torch.bool, device)


@dataclass(frozen=True)
class OpStats:
    """Workload statistics fed to the cost model's backend chooser (the
    fields and defaults of `repro.core.types.OpStats`, whose comments say
    what each prices: skew = max owner load / mean, dedup = distinct-row
    fraction, target_busy_us = the owner's compute between dispatch
    points, loss_rate and abort_rate = measured retry probabilities,
    nranks = P, 0 for unknown)."""

    ops_per_rank: int = 1
    payload_bytes: int = 8
    expected_probes: float = 1.0
    contention: float = 1.0
    target_busy_us: float = 0.0
    progress_thread: bool = False
    skew: float = 1.0
    dedup: float = 1.0
    pipeline_depth: int = 1
    hit_rate: float = 0.0
    loss_rate: float = 0.0
    abort_rate: float = 0.0
    nranks: int = 0
