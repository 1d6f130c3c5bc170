"""Build and load the port's Hopper kernels (CUDA C++ for ``sm_90a``).

Each ``csrc/*.cu`` source is compiled by ``nvcc`` on its own into a shared
library with a plain C interface, and loaded with ``ctypes``: no PyTorch
headers, so a build takes seconds, not minutes.  The libraries go to
``build/repro_torch_kernels/`` at the repository root, named by a hash of
the sources and flags, and are built on first use; all sources compile in
parallel.  Nothing here runs at import time: this module is imported on
machines without a CUDA toolkit (the CPU tests), where only the kernels'
plain versions run.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"

#: source stem -> C entry points (besides repro_error_string) and argtypes
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
ENTRY_POINTS = {
    "gemm_batch_invariant": {
        # x, w, part, out, M, N, K, chunks, dtype, stream
        "repro_gemm_batch_invariant": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    },
    "gemm_splitk": {
        # x, w, part, out, M, N, K, splits, combine, dtype, stream
        "repro_gemm_splitk": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    },
    "paged_attention": {
        # q, k, v, pos, tab, qpos, out, B, H, KV, D, bs, nblk, scale, dtype, stream
        "repro_paged_attention": [
            _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _P,
        ],
        # q, k, v, pos, tab, qpos, m, d, o, out, B, H, KV, D, bs, nblk,
        # splits, scale, combine, dtype, stream
        "repro_paged_attention_fast": [
            _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
            _I, _I, _I, _I, _I, _I, _I, _F, _I, _I, _P,
        ],
    },
    "decode_attention": {
        # q, k, v, lengths, out, B, H, KV, S, D, splits, scale, combine,
        # dtype, stream
        "repro_decode_attention": [
            _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _I, _P,
        ],
    },
    "rmsnorm": {
        # x, residual (or NULL), scale, out, M, D, eps, dtype, scale dtype,
        # stream
        "repro_rmsnorm": [_P, _P, _P, _P, _I, _I, _F, _I, _I, _P],
    },
}

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

#: dtype codes shared with csrc/common.cuh
DTYPE_CODES = {"float32": 0, "bfloat16": 1, "float16": 2}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``nvcc`` on PATH, or
    ``/usr/local/cuda/bin/nvcc``."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [Path(home) / "bin" / "nvcc"] if home else []
    found = shutil.which("nvcc")
    if found:
        cands.append(Path(found))
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.exists():
            return str(c)
    raise RuntimeError("nvcc not found: the Hopper kernels need the CUDA toolkit")


def _digest(stem: str) -> str:
    h = hashlib.sha256()
    for path in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{stem}.cu"]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def lib_path(stem: str) -> Path:
    return BUILD_DIR / f"lib{stem}-{_digest(stem)}.so"


def build_all() -> Dict[str, str]:
    """Compile every source whose library is missing, all in parallel.
    Returns ``{stem: compiler log}`` for the sources built by this call;
    raises with the log of any source that failed."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [s for s in ENTRY_POINTS if not lib_path(s).exists()]
    if not todo:
        return {}
    nvcc = nvcc_path()
    procs = {}
    for stem in todo:
        tmp = lib_path(stem).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{stem}.cu")]
        procs[stem] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    logs, failed = {}, []
    for stem, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        logs[stem] = out
        if proc.returncode != 0:
            failed.append(stem)
        else:
            os.replace(tmp, lib_path(stem))
    if failed:
        detail = "\n".join(f"--- {s}.cu\n{logs[s]}" for s in failed)
        raise RuntimeError(f"nvcc failed for {failed}:\n{detail}")
    return logs


@functools.lru_cache(maxsize=None)
def load(stem: str) -> ctypes.CDLL:
    """The loaded library of one source, built first if needed, with
    ``argtypes``/``restype`` declared for each entry point."""
    if not lib_path(stem).exists():
        build_all()
    lib = ctypes.CDLL(str(lib_path(stem)))
    for name, argtypes in ENTRY_POINTS[stem].items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.repro_error_string.argtypes = [ctypes.c_int]
    lib.repro_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise when a launcher returned a CUDA error code."""
    if rc != 0:
        msg = lib.repro_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
