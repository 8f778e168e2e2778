#!/usr/bin/env python3
"""Block-size sweep of K2 and K3 (`legosnark_tpu_torch/csrc/g1.cu`) on one
card, with each build's registers, spills and SASS instruction mix.

Builds g1.cu once per block size (`-DLSK_G1_THREADS=128` and `=256`, the
`nvcc` processes started together) into `build/sweep/`, prints ptxas's
registers and spills of each kernel, checks that every build agrees bit for
bit with the port's own build (`curve/cuda_group.py`), then times K2, K3 and
K3 with times = 17 at 2^20 points (ms, CUDA events) and at widths 1, 2, 32
and 2^10 (device us per launch over 200 back-to-back launches). Where the
toolkit has `cuobjdump`, it counts the SASS opcodes of each kernel of the
port's build.

Usage: python3 scripts/sweep_g1_threads.py        (needs one CUDA card)
"""
from __future__ import annotations

import collections
import ctypes
import os
import re
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

THREADS = (128, 256)
WIDTHS = (1, 2, 32, 1 << 10)
N = 1 << 20


def _build(kernels):
    """{threads: ctypes library} of g1.cu, one nvcc per block size."""
    out = kernels.BUILD_DIR.parent / "sweep"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for t in THREADS:
        lib = out / f"libg1_t{t}.so"
        cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, f"-DLSK_G1_THREADS={t}",
               "-o", str(lib), str(kernels.CSRC / "g1.cu")]
        procs[t] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True))
    libs = {}
    for t, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {t} threads:\n{log}")
        for ln in log.splitlines():
            if "registers" in ln or "spill" in ln or "Compiling entry" in ln:
                print(f"# ptxas {t} threads: {ln.strip()}")
        so = ctypes.CDLL(str(lib))
        for fn in ("lsk_g1_add", "lsk_g1_double"):
            getattr(so, fn).argtypes = kernels._SIGNATURES[fn]
            getattr(so, fn).restype = ctypes.c_int
        libs[t] = so
    return libs


def _sass_mix(kernels) -> None:
    """Opcode counts of each kernel in the port's build of g1.cu."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        print("# sass: cuobjdump not found")
        return
    lib = kernels.BUILD_DIR / f"libg1_{kernels._digest(kernels.CSRC / 'g1.cu')}.so"
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    mix, fn = {}, None
    for ln in text.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            fn = m.group(1)
            mix[fn] = collections.Counter()
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)", ln)
        if m and fn:
            mix[fn][m.group(1)] += 1
    for fn, c in mix.items():
        top = ", ".join(f"{op} {k}" for op, k in c.most_common(14))
        print(f"# sass {fn}: {sum(c.values())} instructions; {top}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("sweep_g1_threads: no CUDA device", file=sys.stderr)
        return 2
    from legosnark_tpu_torch import kernels
    from legosnark_tpu_torch.curve import cuda_group
    from legosnark_tpu_torch.utils.bench import launch_us, timed_ms

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"# card: {smi}")
    kernels.build()
    libs = _build(kernels)
    _sass_mix(kernels)

    # coordinates below 2^253 < q: the formulas are total, so any value in
    # [0, 2q) exercises the kernels' arithmetic
    gen = torch.Generator(device=dev).manual_seed(5)
    coords = []
    for _ in range(6):
        t = torch.randint(-2**31, 2**31 - 1, (8, N), dtype=torch.int32,
                          device=dev, generator=gen)
        t[7] &= 0x1FFFFFFF
        coords.append(t)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def launch(fn, cs, *args):
        outs = [torch.empty_like(cs[0]) for _ in range(3)]
        err = fn(*[c.data_ptr() for c in cs], *[o.data_ptr() for o in outs],
                 cs[0].shape[-1], cs[0].numel() // 8, *args,
                 ctypes.cast(cuda_group._words(), ctypes.c_void_p), stream)
        if err:
            raise RuntimeError(f"launch failed ({err})")
        return outs

    cases = {  # name -> (entry point, operands, extra args, port's version)
        "g1_add": ("lsk_g1_add", coords, (),
                   lambda cs: cuda_group.add_points(cs[:3], cs[3:])),
        "g1_double": ("lsk_g1_double", coords[:3], (1,),
                      lambda cs: cuda_group.double_point(cs)),
        "g1_double_times17": ("lsk_g1_double", coords[:3], (17,),
                              lambda cs: cuda_group.double_point(cs, 17)),
    }
    for name, (fn_name, cs, args, port) in cases.items():
        want = port(cs)
        for t, so in libs.items():
            fn = getattr(so, fn_name)
            got = launch(fn, cs, *args)
            same = all(torch.equal(g, w) for g, w in zip(got, want))
            if not same:
                print(f"# {name} {t} threads differs from the port's build")
                return 1
            ms = timed_ms(lambda: launch(fn, cs, *args), dev, 20)
            narrow = []
            for w in WIDTHS:
                sub = [c[:, :w].contiguous() for c in cs]
                d_us, _ = launch_us(lambda: launch(fn, sub, *args), dev)
                narrow.append(f"{w}: {d_us:.2f}")
            print(f"# {name} {t} threads: 2^20 {ms:.4f} ms; device us/launch "
                  f"by width {{{', '.join(narrow)}}}")
    print("# sweep ok: every build bit-identical to the port's")
    return 0


if __name__ == "__main__":
    sys.exit(main())
