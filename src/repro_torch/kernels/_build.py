"""Build the CUDA sources in `csrc/` with nvcc and load them with ctypes.

Each `csrc/<name>.cu` exports plain C functions (no PyTorch headers), is
compiled on first use into `build/repro_torch_kernels/<name>-<hash>.so`
under the checkout, and is loaded with `ctypes`. Sources may include the
headers of `csrc/` (`*.cuh`), also from a copy built elsewhere. The file
name carries a hash of the source, the headers and the flags, so an edited
source or header is rebuilt and an unchanged one is reused. `build_all()`
starts one nvcc per source, all together, and waits for them.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = (Path(__file__).resolve().parents[3] / "build"
             / "repro_torch_kernels")
SOURCES = ("owner_lane", "hash_probe", "flash_decode", "moe_dispatch",
           "flash_attention", "flash_attention_bwd", "rg_lru", "txn_lane",
           "mlstm", "slstm")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: Dict[str, ctypes.CDLL] = {}
# nvcc's output for each source built in this process (ptxas register and
# shared-memory report), for a caller that wants to record it
build_log: Dict[str, str] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    cand = shutil.which("nvcc") or (
        os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None)
    if cand is None or not os.path.exists(cand):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return cand


def _target(src: Path) -> Path:
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha1(src.read_bytes() + headers
                          + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{src.stem}-{digest[:12]}.so"


def _compile(srcs: List[Path]) -> List[Path]:
    """Compile every source whose library is missing, one nvcc each, all
    started together. Raises with nvcc's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [(s, _target(s)) for s in srcs if not _target(s).exists()]
    procs = []
    for src, target in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp, str(src)]
        procs.append((src, target, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for src, target, tmp, proc in procs:
        out, _ = proc.communicate()
        build_log[src.stem] = out
        if proc.returncode == 0:
            os.replace(tmp, target)
        else:
            os.unlink(tmp)
            failed.append(f"nvcc {src.name} failed ({proc.returncode}):\n"
                          f"{out}")
    if failed:
        raise RuntimeError("\n".join(failed))
    return [_target(s) for s in srcs]


def build_all(names=SOURCES) -> List[Path]:
    """Compile csrc/<name>.cu for every name whose library is missing, all
    at once."""
    return _compile([CSRC / f"{n}.cu" for n in names])


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, built if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(_target(CSRC / f"{name}.cu")))
        _LIBS[name] = lib
    return lib


def load_file(src) -> ctypes.CDLL:
    """Build and load another source with the C interface of one in csrc/
    (an earlier version of it, or a copy with a planted fault); stand it
    in for that library with `_launch.library`."""
    (target,) = _compile([Path(src).resolve()])
    return ctypes.CDLL(str(target))
