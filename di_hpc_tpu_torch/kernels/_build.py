"""Build, load and launch support for the port's CUDA kernels.

Every `di_hpc_tpu_torch/csrc/*.cu` is compiled for Hopper (`sm_90a`) by
`nvcc` into one shared library with a plain C interface, on first use, under
`build/torch_kernels/` at the repository root; the library is then loaded
with `ctypes`.  Each source compiles in its own `nvcc` process, all started
together, and one more `nvcc` links the objects.  The library's name carries
a hash of the sources, the `*.cuh` headers they share and the flags, so an
edited source builds anew.  A failed build raises with nvcc's output;
nothing falls back.

Nothing here runs at import: the CPU tests import every module, and `nvcc`
is only looked for when a kernel is first launched.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_p, _i, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signature of every exported function: name -> (restype, argtypes).
_SIGNATURES = {
    "lstm_layer_fwd_f32": (_i, [_p] * 13 + [_i] * 4 + [_p]),
    "lstm_layer_fwd_bf16": (_i, [_p] * 13 + [_i] * 4 + [_p]),
    "lstm_layer_fwd_at_rows": (_i, [_i, _i] + [_p] * 13 + [_i] * 4 + [_p]),
    "lstm_layer_smem_bytes": (ctypes.c_longlong, [_i, _i]),
    "lstm_layer_fwd_smem_bytes": (ctypes.c_longlong, [_i, _i, _i]),
    "lstm_layer_fwd_rows_per_group": (_i, [_i, _i, _i]),
    "lstm_layer_fwd_cluster_size": (_i, [_i]),
    "lstm_layer_fwd_max_active_clusters": (_i, [_i, _i, _i, _i]),
    "lstm_layer_bwd_v2_f32": (_i, [_p] * 20 + [_i] * 4 + [_p]),
    "lstm_layer_bwd_v2_bf16": (_i, [_p] * 20 + [_i] * 4 + [_p]),
    "lstm_layer_bwd_v2_smem_bytes": (ctypes.c_longlong, [_i, _i]),
    "lstm_layer_bwd_v2_rows_per_group": (_i, [_i, _i]),
    "lstm_layer_bwd_v2_cluster_size": (_i, [_i]),
    "lstm_layer_bwd_v2_max_active_clusters": (_i, [_i, _i, _i]),
    "lstm_layer_bwd_v1_f32": (_i, [_p] * 14 + [_i] * 6 + [_p]),
    "lstm_layer_bwd_v1_bf16": (_i, [_p] * 14 + [_i] * 6 + [_p]),
    "lstm_layer_bwd_v1_cluster_size": (_i, [_i]),
    "lstm_layer_bwd_v1_rows_per_group": (_i, [_i] * 4),
    "lstm_layer_bwd_v1_smem_bytes": (ctypes.c_longlong, [_i] * 4),
    "lstm_layer_bwd_v1_max_active_clusters": (_i, [_i] * 5),
    "vtrace_losses_f32": (_i, [_p] * 5 + [_i] * 2 + [_f] * 5 + [_i] * 2
                          + [_p]),
    "vtrace_returns_adv_f32": (_i, [_p] * 5 + [_i] * 2 + [_f] * 5 + [_i] * 2
                               + [_p]),
    "gae_f32": (_i, [_p] * 4 + [_i] * 2 + [_f] * 2 + [_i] * 2 + [_p]),
    "lambda_returns_f32": (_i, [_p] * 3 + [_i] * 2 + [_f] * 2 + [_i] * 2
                           + [_p]),
    "td_lambda_loss_f32": (_i, [_p] * 3 + [_i] * 2 + [_f] * 2 + [_i] * 2
                           + [_p]),
    "td_lambda_err_f32": (_i, [_p] * 3 + [_i] * 2 + [_f] * 2 + [_i] * 2
                          + [_p]),
    "upgo_advantages_f32": (_i, [_p] * 4 + [_i] * 4 + [_p]),
    "upgo_loss_f32": (_i, [_p] * 5 + [_i] * 4 + [_p]),
    "linear_scan_f32": (_i, [_p] * 4 + [_i] * 5 + [_p]),
    "dihpc_error_string": (ctypes.c_char_p, [_i]),
}


class Library:
    """The loaded kernel library, with the record of how it was built."""

    def __init__(self, path: Path, seconds: Optional[float], log: str):
        self.path = path
        self.build_seconds = seconds      # None when an earlier build was reused
        self.build_log = log              # nvcc's output, -Xptxas -v included
        self.cdll = ctypes.CDLL(str(path))
        for name, (restype, argtypes) in _SIGNATURES.items():
            fn = getattr(self.cdll, name)
            fn.restype = restype
            fn.argtypes = argtypes


_LIBRARY: Optional[Library] = None


def nvcc() -> str:
    """Path of the CUDA compiler; raises when the toolkit is missing."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels of di_hpc_tpu_torch "
                       "are built from source on first use and need the CUDA "
                       "toolkit (nvcc on PATH or /usr/local/cuda/bin/nvcc)")


def _run_all(cmds):
    """Start every command at once, wait for all; raise with the output of
    the first that failed."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"kernel build failed ({' '.join(cmd)}), "
                               f"exit {p.returncode}:\n{out}")
    return outs


def build() -> Library:
    """Compile (unless this exact build exists) and load the library."""
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources + sorted(CSRC.glob("*.cuh")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    tag = digest.hexdigest()[:16]
    lib_path = BUILD_DIR / f"libdihpc_torch_{tag}.so"
    log_path = lib_path.with_suffix(".log")
    if lib_path.exists():
        log = log_path.read_text() if log_path.exists() else ""
        return Library(lib_path, None, log)

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    compiler = nvcc()
    start = time.perf_counter()
    pid = os.getpid()           # private names: concurrent builds may race
    objs = [BUILD_DIR / f"{src.stem}_{tag}.{pid}.o" for src in sources]
    outs = _run_all([[compiler, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
                     for src, obj in zip(sources, objs)])
    tmp = BUILD_DIR / f"libdihpc_torch_{tag}.{pid}.so"
    outs += _run_all([[compiler, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp),
                       *map(str, objs)]])
    for obj in objs:
        obj.unlink()
    seconds = time.perf_counter() - start
    log = "\n".join(o.strip() for o in outs if o.strip())
    log_path.write_text(log)
    os.replace(tmp, lib_path)       # atomic: a concurrent build wins whole
    return Library(lib_path, seconds, log)


def library() -> Library:
    """The kernel library, built on first use in this process."""
    global _LIBRARY
    if _LIBRARY is None:
        _LIBRARY = build()
    return _LIBRARY


def check_status(name: str, status: int) -> None:
    """Raise if a launch function returned a CUDA error: a refused launch
    never runs, and a later synchronize would not report it."""
    if status != 0:
        msg = library().cdll.dihpc_error_string(status).decode()
        raise RuntimeError(f"{name}: CUDA launch failed with status {status} "
                           f"({msg})")


def on_cpu(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU: the wrapper then runs the
    plain PyTorch version.  Anything else goes to the kernel, which checks
    its inputs and raises on what it cannot take."""
    return all(t.device.type == "cpu" for t in tensors)


def check_kernel_inputs(name: str, tensors: dict, aligned=(),
                        dtypes: dict = None) -> None:
    """The CUDA kernels take contiguous tensors on one CUDA device, each of
    the dtype `dtypes` names for it (float32 where it names none); the names
    in `aligned` are also read 16 bytes at a time (16-byte alignment)."""
    first = next(iter(tensors.values()))
    dtypes = dtypes or {}
    for arg, t in tensors.items():
        if t.device.type != "cuda" or t.device != first.device:
            raise ValueError(f"{name}: all inputs must lie on one CUDA device "
                             f"(or all on the CPU); {arg} is on {t.device}, "
                             f"{next(iter(tensors))} on {first.device}")
        want = dtypes.get(arg, torch.float32)
        if t.dtype != want:
            raise TypeError(f"{name}: the CUDA kernel takes {arg} as {want}; "
                            f"got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
        if arg in aligned and t.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} must be 16-byte aligned")
