"""Build and load the port's CUDA kernels (nvcc → shared library → ctypes).

Each `csrc/<name>.cu` is compiled by `nvcc` for sm_90a into its own shared
library with a plain C interface. The build happens at first use, from the
sources in this checkout, into `_build/` next to this file (listed in
.gitignore); a library is rebuilt whenever its sources change (the file
name carries a hash of them). `build_all()` starts one nvcc per source at
once and waits for all of them. A failed build raises; nothing falls back.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v", "-lineinfo"]

# C entry points of each library and their ctypes signatures: pointers and
# the stream as c_void_p, sizes as c_int, element strides as c_longlong, the
# softmax scale as c_float.
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_L = ctypes.c_longlong
SIGNATURES = {
    "paged_decode": {
        # ... out, workspace, B, K, G, h, n_grp, rows, bs, nb, n_split,
        # per, scale
        "paged_decode_launch": [_I, *[_P] * 7, *[_I] * 10, _F, _P],
        # int8 pages + the scale plane (k_scale, k_tok, v_scale, v_tok)
        "paged_decode_int8_launch": [_I, *[_P] * 11, *[_I] * 10, _F, _P],
    },
    "paged_prefill": {
        # ... out, workspace, B, K, S, G, h, bs, nb, n_split, per, scale,
        # window, sink
        "paged_prefill_launch": [_I, *[_P] * 10, *[_I] * 9, _F, _I, _I, _P],
        "paged_prefill_int8_launch": [_I, *[_P] * 14, *[_I] * 9, _F, _I, _I,
                                      _P],
    },
    "flash_prefill": {
        "flash_prefill_launch": [_I, _P, _P, _P, _P, _I, _I, _I, _I, _F,
                                 _I, _I, _I, _P],
    },
    "sink_decode": {
        # ... out, workspace, B, K, G, h, n_grp, rows, W, six strides,
        # n_split, per, scale
        "sink_decode_launch": [_I, *[_P] * 6, *[_I] * 7, *[_L] * 6, _I, _I,
                               _F, _P],
    },
    "block_topk": {
        "block_topk_launch": [_I, _P, _P, _P, _P, _P, _P,
                              _I, _I, _I, _I, _I, _I, _P],
        # ... scores, new_tables, new_lens, m, selected, mask, aux, B, K,
        # G, h, nb, bs, k_static, use_frac, frac, sink, recent
        "block_topk_select_launch": [_I, *[_P] * 12, *[_I] * 8, _F, _I, _I,
                                     _P],
        # scores, tables, lens, new_tables, new_lens, m, selected, mask,
        # aux, B, nb, bs, k_static, use_frac, frac, sink, recent, stream
        "block_topk_select_scores_launch": [*[_P] * 9, *[_I] * 5, _F, _I,
                                            _I, _P],
        "block_topk_plan": [_I, _P, _P],
    },
    "spec_verify": {
        "spec_verify_launch": [_I, *[_P] * 10, *[_I] * 9, _F, _P],
        "spec_verify_int8_launch": [_I, *[_P] * 14, *[_I] * 9, _F, _P],
    },
    "moe_gmm": {
        # ... out, S, C, D, F, n_cta
        "moe_gmm_launch": [_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    },
}

_loaded: dict[str, ctypes.CDLL] = {}   # dlopen'd libraries (process-wide)


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels can only be "
                           "built on a machine with the CUDA toolkit")
    return path


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build_all(names=None) -> dict:
    """Compile every library that is missing, all nvcc processes at once.
    → {name: {"seconds": wall seconds of its build (0.0 if cached),
    "log": nvcc's output (ptxas register/shared-memory report)}}."""
    names = list(SIGNATURES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs, report = {}, {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            report[name] = {"seconds": 0.0, "log": "(cached)"}
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *ARCH_FLAGS, *NVCC_FLAGS, "-I", str(CSRC),
               "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.monotonic())
    failed = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        report[name] = {"seconds": time.monotonic() - t0, "log": log}
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return report


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of library `name`, built first if needed."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    path = _lib_path(name)
    if not path.exists():
        build_all([name])
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    _loaded[name] = lib
    return lib


def check_launch(name: str, rc: int) -> None:
    """Raise unless a C entry point returned 0."""
    if rc == -1:
        raise ValueError(f"{name}: shape or dtype not supported by the kernel")
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {rc}")
