"""Build, load and count the hand-written CUDA kernels of `csrc/`.

Each `csrc/*.cu` source is compiled by its own `nvcc` process, all
started together, into a shared library with a plain C interface for
`sm_90a`, and loaded with `ctypes` (no PyTorch headers, so a build takes
seconds). Libraries are named by a hash of their sources and flags and go
to `build/kernels/` beside the package, so a second process reuses them.
The first kernel launch builds everything; `build()` does it explicitly.

`launches` counts, per kernel, the launches made by the wrappers in
`fields/cuda_limb.py`, `curve/cuda_group.py`, `curve/pairing.py`,
`utils/transcript.py` and `probes/mont_variants.py`;
`launch_widths` splits them by exact width (elements per launch) and
`times` (the doublings of one K3 or K6 launch; 1 for every other
kernel). Both go up only through `count`, where a wrapper launches.
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
SOURCES = ("mont_mul.cu", "g1.cu", "mont_sos.cu", "mont_tc.cu",
           "limb_product.cu", "mimc.cu", "g2.cu", "pairing.cu")
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: kernel name -> launches since the last `reset_launches()`
launches: collections.Counter = collections.Counter()
#: kernel name -> {(elements, times): launches}
launch_widths: collections.defaultdict = collections.defaultdict(
    collections.Counter)

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_SIGNATURES = {
    "lsk_mont_mul": [_P, _P, _P, _LL, _LL, _P, _P],
    "lsk_g1_add": [_P] * 9 + [_LL, _LL, _P, _P],
    "lsk_g1_double": [_P] * 6 + [_LL, _LL, ctypes.c_int, _P, _P],
    "lsk_g2_add": [_P] * 9 + [_LL, _LL, _P, _P],
    "lsk_g2_double": [_P] * 6 + [_LL, _LL, ctypes.c_int, _P, _P],
    "lsk_mont_mul_sos": [_P, _P, _P, _LL, _LL, _P, _P],
    "lsk_mont_mul_tc": [_P, _P, _P, _LL, _LL, _P, _P],
    "lsk_limb_product": [_P, _P, _P, _LL, _LL, ctypes.c_int, _P],
    "lsk_mimc": [_P, _P, _LL, _P, _LL, _LL, _P, ctypes.c_int, _P, _P],
    "lsk_pairing_miller": [_P] * 7 + [_LL, _LL, _P, _P],
    "lsk_pairing_final_exp": [_P, _LL, _LL, _P, _LL, _LL, _P, _LL, _P, _P],
}
_libs: dict = {}
#: source -> {"seconds": build time (0 when reused), "log": nvcc output,
#: ptxas's report included, also for a reused library}
build_log: dict = {}


def reset_launches() -> None:
    launches.clear()
    launch_widths.clear()


def count(name: str, total: int, times: int = 1) -> None:
    """Count one launch of kernel `name` over `total` >= 1 elements,
    `times` steps each (K3's and K6's doublings)."""
    launches[name] += 1
    launch_widths[name][(total, times)] += 1


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _digest(src: Path) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cuh")) + [src]:
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def build() -> dict:
    """Compile (in parallel) and load every kernel library; idempotent."""
    if _libs:
        return build_log
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    jobs = {}
    for name in SOURCES:
        src = CSRC / name
        lib = BUILD_DIR / f"lib{src.stem}_{_digest(src)}.so"
        if lib.exists():   # the nvcc output was kept beside it
            saved = lib.with_name(lib.name + ".log")
            build_log[name] = {"seconds": 0.0, "log": saved.read_text()
                               if saved.exists() else "reused " + lib.name}
            continue
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
        jobs[name] = (lib, tmp, time.perf_counter(),
                      subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (lib, tmp, t0, proc) in jobs.items():
        out, _ = proc.communicate()
        build_log[name] = {"seconds": time.perf_counter() - t0, "log": out}
        if proc.returncode != 0:
            failed.append(f"{name}:\n{out}")
            continue
        lib.with_name(lib.name + ".log").write_text(out)
        os.replace(tmp, lib)
    if failed:
        raise RuntimeError("kernel build failed\n" + "\n".join(failed))
    for name in SOURCES:
        src = CSRC / name
        lib = ctypes.CDLL(str(BUILD_DIR / f"lib{src.stem}_{_digest(src)}.so"))
        for fn, argtypes in _SIGNATURES.items():
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
        lib.lsk_error_string.argtypes = [ctypes.c_int]
        lib.lsk_error_string.restype = ctypes.c_char_p
        _libs[name] = lib
    return build_log


def function(source: str, fn: str):
    """The C entry point `fn` of the library built from `source`."""
    build()
    return getattr(_libs[source], fn)


def check(source: str, err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        msg = _libs[source].lsk_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: {msg} ({err})")


def words(values) -> ctypes.Array:
    """uint32 words for a kernel's constant parameter block."""
    return (ctypes.c_uint32 * len(values))(*values)
