"""The port's host core: built from its own sources in ../csrc/host on first
use and loaded here.

 - `csrc/host/hostcore.c` is a CPython extension (`_dihpc_torch_hostcore`)
   whose `pack_padded` packs a list of contiguous float32 arrays into a
   padded batch and its mask, every element written once, with no Python
   work per array;
 - `csrc/host/bucketing.cpp` holds the exact bucketing DP behind a C ABI,
   loaded with ctypes.

Both are compiled with gcc/g++ into `build/torch_host/` at the repository
root, under names that carry a hash of the source, the flags and the
interpreter's extension suffix.  Each build writes a private file and
renames it into place, so processes that build at once never load a
partial file.  A failed build raises with the compiler's output; nothing
falls back to Python.  Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import importlib.machinery
import importlib.util
import os
import subprocess
import sysconfig
import threading
from pathlib import Path

import numpy as np

__all__ = ["get_native_lib", "get_native_ext", "native_pack_padded_f32",
           "native_oracle_split_group"]

HOST_SRC = Path(__file__).resolve().parent.parent / "csrc" / "host"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_host"
EXT_NAME = "_dihpc_torch_hostcore"

_lock = threading.Lock()
_built = {}


def _build(src: Path, compiler: str, flags) -> Path:
    """Compile `src` into a shared object unless this exact build exists;
    returns its path."""
    digest = hashlib.sha256(src.read_bytes())
    digest.update(" ".join([compiler, *flags]).encode())
    digest.update(sysconfig.get_config_var("EXT_SUFFIX").encode())
    so = BUILD_DIR / f"{src.stem}_{digest.hexdigest()[:16]}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.{threading.get_ident()}.so")
    cmd = [compiler, *flags, "-shared", "-fPIC", str(src), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except FileNotFoundError as e:
        raise RuntimeError(f"host core build: {compiler} not found; the port "
                           f"builds {src.name} from source on first use") from e
    if proc.returncode != 0:
        raise RuntimeError(f"host core build failed ({' '.join(cmd)}), exit "
                           f"{proc.returncode}:\n{proc.stderr}{proc.stdout}")
    os.replace(tmp, so)
    return so


def _once(name, make):
    """make() the first time `name` is asked for in this process."""
    if name not in _built:
        with _lock:
            if name not in _built:
                _built[name] = make()
    return _built[name]


def _load_lib() -> ctypes.CDLL:
    so = _build(HOST_SRC / "bucketing.cpp", "g++", ["-O2", "-std=c++17"])
    lib = ctypes.CDLL(str(so))
    lib.oracle_split_group.restype = ctypes.c_int64
    lib.oracle_split_group.argtypes = [
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64),
    ]
    return lib


def _load_ext():
    include = sysconfig.get_paths()["include"]
    so = _build(HOST_SRC / "hostcore.c", "gcc", ["-O2", f"-I{include}"])
    loader = importlib.machinery.ExtensionFileLoader(EXT_NAME, str(so))
    spec = importlib.util.spec_from_loader(EXT_NAME, loader)
    module = importlib.util.module_from_spec(spec)
    loader.exec_module(module)
    return module


def get_native_lib() -> ctypes.CDLL:
    """The bucketing library (ctypes), built on first use."""
    return _once("lib", _load_lib)


def get_native_ext():
    """The hostcore extension module, built and imported on first use."""
    return _once("ext", _load_ext)


def native_pack_padded_f32(srcs, max_shape, value: float = 0.0):
    """Pack contiguous float32 numpy arrays of one rank into a padded
    (len(srcs), *max_shape) batch filled with `value`, and its mask (1
    inside each array's extent, `value` outside); both float32 numpy arrays.
    The caller sends only contiguous float32 arrays; the C code raises
    ValueError on anything else."""
    out = np.empty((len(srcs), *max_shape), dtype=np.float32)
    mask = np.empty((len(srcs), *max_shape), dtype=np.float32)
    get_native_ext().pack_padded(srcs, out, mask, float(value))
    return out, mask


def native_oracle_split_group(numels, group: int):
    """The exact bucketing DP over ascending `numels`: (positions, cost),
    positions of length group + 1 from 0 to len(numels).  Raises ValueError
    unless 1 <= group <= len(numels)."""
    n = len(numels)
    arr = (ctypes.c_int64 * n)(*numels)
    out = (ctypes.c_int64 * (group + 1))()
    cost = get_native_lib().oracle_split_group(arr, n, group, out)
    if cost < 0:
        raise ValueError(f"oracle_split_group: cannot split {n} items into "
                         f"{group} groups (need 1 <= group <= {n})")
    return list(out), int(cost)
