"""Shared checks and the launch call of the ctypes-bound kernels."""
from __future__ import annotations

import contextlib
import ctypes
import functools

import torch

from . import _build

PTR = ctypes.c_void_p
I64 = ctypes.c_longlong
I32 = ctypes.c_int


@functools.lru_cache(maxsize=None)
def function(lib: str, name: str, argtypes: tuple):
    """The C function `name` of csrc/<lib>.cu, typed (built on first use)."""
    fn = getattr(_build.load(lib), name)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


@contextlib.contextmanager
def library(lib: str, cdll: ctypes.CDLL):
    """Within the block, launch the kernels of csrc/<lib>.cu from `cdll`
    (from `_build.load_file`) instead."""
    saved = _build.load(lib)
    _build._LIBS[lib] = cdll
    function.cache_clear()
    try:
        yield
    finally:
        _build._LIBS[lib] = saved
        function.cache_clear()


def check(name: str, x: torch.Tensor, dtype: torch.dtype, shape: tuple,
          device: torch.device) -> None:
    """Raise unless x is a contiguous CUDA tensor of this dtype and shape."""
    if not x.is_cuda or x.device != device:
        raise ValueError(f"{name}: expected a tensor on {device}, "
                         f"got {x.device}")
    if x.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def launch(fn, kernel: str, device: torch.device, *args) -> None:
    """Call a C launcher on the current stream of `device`; raise if the
    launch reported a CUDA error."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{kernel}: kernel launch failed with CUDA "
                           f"error {err}")
