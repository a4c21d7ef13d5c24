"""Hand-written Hopper kernels of the port, and what every kernel shares.

Each kernel package keeps the JAX package's three-file contract:
  <name>.py — the kernel (CUDA C++ in ``csrc/`` bound through ctypes, or Triton)
              and its launcher, which counts launches
  ops.py    — public wrapper: the kernel for CUDA tensors, the plain version
              for CPU tensors (or on request, ``impl="ref"``)
  ref.py    — the plain PyTorch version the kernel is held against

Kernels:
  flash_decode — one-token GQA attention over the slotted KV cache
                 (CUDA C++, ``csrc/flash_decode.cu``)
  rms_norm     — fused RMSNorm (Triton)
  outer_update — fused outer Nesterov step (`nesterov_2d`) and fused
                 delivery (`deliver_2d`: Eq. 3 blend or Algorithm-1
                 compensation, offline-worker mask) over the flat fragment
                 plane (CUDA C++, ``csrc/outer_update.cu``)
  delay_comp   — per-leaf Algorithm-1 delay compensation (CUDA C++,
                 ``csrc/delay_comp.cu``)
  delta_codec  — per-block absmax int8/int4 wire codec: `quantize_pack`
                 and `dequantize_unpack` (CUDA C++, ``csrc/delta_codec.cu``)
  rwkv6_scan   — RWKV-6 WKV recurrence with a matrix state per head,
                 `wkv_scan` (CUDA C++, ``csrc/rwkv6_scan.cu``)
  rglru_scan   — RG-LRU diagonal recurrence, `lru_scan` (CUDA C++,
                 ``csrc/rglru_scan.cu``)

None of the kernels has a backward: an "auto" wrapper raises when grad mode
is on and an input requires a gradient (`check_no_grad`), so a training
forward can never go through a kernel and silently cut the gradient.

CUDA sources are compiled at first use with ``nvcc`` for ``sm_90a`` into one
shared library per source under ``build/kernels/`` at the repo root (listed
in ``.gitignore``), from the repo's sources alone; the library is named by a
hash of its source, so an edited source is rebuilt.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Iterable, Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

# launches of each kernel since the last reset: a wrapper adds one where it
# launches its kernel and nowhere else, so a run can show that its main path
# went through the kernels (the port's counterpart of the JAX engine's
# trace counts)
LAUNCHES: Dict[str, int] = {"flash_decode": 0, "rms_norm": 0,
                             "nesterov_2d": 0, "deliver_2d": 0,
                             "delay_comp": 0, "quantize_pack": 0,
                             "dequantize_unpack": 0, "wkv_scan": 0,
                             "lru_scan": 0}


def count_launch(name: str) -> None:
    LAUNCHES[name] += 1


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def launch_counts() -> Dict[str, int]:
    return dict(LAUNCHES)


def check_no_grad(name: str, *tensors) -> None:
    """Raise if autograd would need a gradient through a kernel that has no
    backward (grad mode on and an input requires grad)."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} has no backward: its kernel would cut the gradient. "
            f"Call it with impl='ref' (the differentiable plain version) "
            f"on a training path, or under torch.no_grad()")


def resolve_device(device: Optional[str | torch.device] = None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another. Never drifts onto the CPU when CUDA is missing."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' to "
                               "run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): the "
                           "CUDA kernels are built from source at first use")
    return nvcc


def _lib_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, Path]:
    """Compile the named ``csrc/<name>.cu`` (default: all) that are not built
    yet, one ``nvcc`` per source, all started together. Raises with the
    compiler's output if any build fails."""
    names = sorted(p.stem for p in CSRC.glob("*.cu")) if names is None \
        else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = {n: _lib_path(n) for n in names}
    procs = []
    for n, lib in out.items():
        if lib.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{n}.cu")]
        procs.append((n, lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    errors = []
    for n, lib, tmp, p in procs:
        log = p.communicate()[0].decode(errors="replace")
        if p.returncode != 0:
            os.unlink(tmp)
            errors.append(f"nvcc failed for {n}.cu (rc {p.returncode}):\n{log}")
        else:
            os.replace(tmp, lib)        # atomic: a reader never sees half a .so
    if errors:
        raise RuntimeError("\n".join(errors))
    return out


@functools.cache
def load_library(name: str) -> ctypes.CDLL:
    """The shared library of ``csrc/<name>.cu``, built at first use."""
    return ctypes.CDLL(str(build([name])[name]))
