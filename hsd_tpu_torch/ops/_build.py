"""Build and load the port's CUDA kernels.

Every `hsd_tpu_torch/csrc/*.cu` is compiled by `nvcc` for `sm_90a` into a
shared library with a plain C interface, which `ctypes` loads. The build
runs at first use, one `nvcc` per source, all started together, into
`hsd_tpu_torch/csrc/build/` (listed in `.gitignore`). A library whose
source and flags are unchanged is reused. A missing `nvcc` or a failed
build raises: there is no other route for a CUDA tensor.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# C signatures of the exported functions, by library
SIGNATURES = {
    "gptq_i8": {
        "hsd_gptq_i8": (_I, [_P, _I, _I, _I, _P, _I, _P, _I, _P, _I, _P, _F,
                             _P, _I, _I, _P, _P, _P]),
        "hsd_gptq_i4": (_I, [_P, _I, _I, _I, _P, _I, _P, _I, _P, _I, _P, _F,
                             _P, _I, _I, _P, _P, _P]),
        "hsd_tail_workspace": (_LL, [_I] * 9),
        "hsd_gptq_tail": (_I, [_P, _I, _P, _I, _I, _I, _I, _I, _I,
                               _P, _P, _I, _I, _I, _P, _P, _I, _I, _I,
                               _P, _P, _I, _I, _I, _P, _F, _P, _I, _P,
                               _LL, _P]),
        "hsd_i8_error_string": (ctypes.c_char_p, [_I]),
    },
    "gptq_mma": {
        "hsd_k7": (_I, [_P, _I, _I, _I, _P, _I, _I, _P, _I, _P, _I, _P, _F,
                        _P, _P, _I, _P, _P]),
        "hsd_k7_stage": (_I, [_P, _I, _I, _I, _I, _P, _F, _P, _P, _P, _P]),
        "hsd_mma_error_string": (ctypes.c_char_p, [_I]),
    },
    "dequant": {
        "hsd_dequant": (_I, [_P, _I, _LL, _I, _I, _P, _I, _LL, _I, _P, _LL,
                             _P, _I, _P]),
        "hsd_dequant_error_string": (ctypes.c_char_p, [_I]),
    },
    "flash_decode": {
        "hsd_flash_decode": (_I, [_P, _LL, _P, _P, _I, _P, _P, _I, _P, _P, _P,
                                  _I, _I, _I, _I, _I, _I, _F, _P, _P, _P]),
        "hsd_flash_error_string": (ctypes.c_char_p, [_I]),
    },
}


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                           "from hsd_tpu_torch/csrc at first use")
    return path


def _target(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}_{h.hexdigest()[:16]}.so"


def build_all() -> Dict[str, Path]:
    """Compile every source whose library is missing, in parallel. Returns
    {name: library path}. Raises with the compiler's output on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {src.stem: (src, _target(src)) for src in sorted(CSRC.glob("*.cu"))}
    procs = {}
    for name, (src, out) in targets.items():
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(
            [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return {name: out for name, (_, out) in targets.items()}


def lib(name: str) -> ctypes.CDLL:
    """The loaded library `csrc/<name>.cu`, built on first use."""
    with _LOCK:
        if name not in _LIBS:
            paths = build_all()
            if name not in paths:
                raise RuntimeError(f"no CUDA source csrc/{name}.cu")
            handle = ctypes.CDLL(str(paths[name]))
            for fn, (restype, argtypes) in SIGNATURES.get(name, {}).items():
                f = getattr(handle, fn)
                f.restype, f.argtypes = restype, argtypes
            _LIBS[name] = handle
        return _LIBS[name]
