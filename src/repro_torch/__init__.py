"""PyTorch/CUDA port of the RDMA-vs-RPC distributed data structures and
of the serving, prefill and training paths of the model zoo.

Mirrors the JAX package `repro` module by module (`core/`, `kernels/`,
`configs/`, `models/`, `optim/`, `data/`, `runtime/`, `launch/`) and is
held against it by the parity
tests in `tests/test_torch_*.py`. It imports neither JAX nor `repro`.
Entry points take an explicit `device` that defaults to ``"cuda"``; the
tests ask for ``"cpu"`` by name. On a CUDA tensor the owner lanes, the RPC
handler bodies, attention, decode attention, expert dispatch and the
RG-LRU scan, and the backwards of attention and of the scan, launch the
hand-written kernels in `kernels/csrc/`; on a CPU tensor they run the
plain PyTorch versions in `kernels/ref.py`.
"""
from . import (configs, convert, core, data, kernels, launch, models,
               optim, runtime)

__all__ = ["configs", "convert", "core", "data", "kernels", "launch",
           "models", "optim", "runtime"]
