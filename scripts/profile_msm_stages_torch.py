#!/usr/bin/env python3
"""Per-stage device time and memory of the PyTorch port's MSM, chunk by
chunk of windows.

Counterpart of `scripts/profile_msm_stages.py`. Runs `curve.msm.msm`'s
stages one by one on one GPU, each between CUDA events: the signed
digits and the negated sources [P | -P] (once per MSM), then per chunk
of windows (`msm.windows_per_chunk`) the sort, the gather (which also
negates), the prefix scan and the bucket boundaries with their tree sum,
and the Horner combine. Per chunk it also reports the device memory
allocated above the chunk's start at its peak, in bytes and in copies of
the chunk's gathered coordinates (what `msm.LIVE_COPIES_G1/_G2` assume).
The staged result must equal `msm.msm`'s bit for bit.

MSMs: one G1 row of 2^log_n points at window c; with --groth16 also the
four of Groth16 at n = 128 (`gadgets/groth16.py:prove`,
`examples/legogrothmatrix.py`): the two-row G1 MSM over 2129922 points,
the G2 MSM over 2129922, the C MSM over 4210690 and commit_emul's over
2113536, each at its default window. Points: 2^14 distinct multiples of
the generator, tiled; scalars: uniform below 2^253 from numpy seed 0.
Each MSM runs once through `msm.msm` first (warm-up and reference).

With --batch it also times `msm.batch_scalar_mul` on the two fixed-base
batches of Groth16's keygen at n = 128 (8486917 G1 and 2129924 G2
scalars, uniform below 2^253, c = 8 on `msm.generator_table`) at
`msm.BATCH_CHUNK` = 2^14, 2^16 and 2^18: device ms between CUDA events,
host seconds and the peak device memory above the call's start; every
chunk size must give the same points bit for bit.

Prints one line per stage and chunk, and as the last line the report as
JSON.

Usage: python3 scripts/profile_msm_stages_torch.py [log_n] [c] [--groth16]
                                                   [--batch]
       (defaults 20 and 17)
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from legosnark_tpu_torch import config  # noqa: E402
from legosnark_tpu_torch.curve import bn254, msm  # noqa: E402
from legosnark_tpu_torch.curve.group import (  # noqa: E402
    G1, G2, Point, point_concat, point_map, point_stack, scan)
from legosnark_tpu_torch.fields import limb as fl  # noqa: E402

#: Groth16's MSMs at n = 128: name -> (curve, rows of scalars, points)
GROTH16_128 = {"g16_ab_g1": (G1, 2, 2129922), "g16_b_g2": (G2, 1, 2129922),
               "g16_c_g1": (G1, 1, 4210690),
               "g16_commit_emul_g1": (G1, 1, 2113536)}
#: Groth16's keygen batches at n = 128: name -> (curve, scalars)
BATCHES_128 = {"g16_key_g1": (G1, 8486917), "g16_key_g2": (G2, 2129924)}
#: the `msm.BATCH_CHUNK` sizes that --batch compares
BATCH_CHUNKS = (1 << 14, 1 << 16, 1 << 18)


def random_scalars(rng, shape):
    """Canonical scalars [shape.., 8, n], uniform below 2^253 < r."""
    limbs = rng.integers(0, 1 << 32, shape[:-1] + (fl.NLIMBS, shape[-1]),
                         dtype=np.uint64)
    limbs[..., -1, :] &= (1 << 29) - 1
    return torch.from_numpy(limbs.astype(np.uint32).view(np.int32))


def inputs(C, rows: int, n: int, dev):
    """Points [E.., n] (2^14 distinct k G, tiled), scalars [rows.., 8, n]."""
    rng = np.random.default_rng(0)
    k = fl.tensor(fl.ints_to_limbs(
        [int(x) for x in rng.integers(1, 1 << 62, 1 << 14)]), dev)
    base = msm.batch_scalar_mul(C, msm.generator_table(C, dev), k, c=8)
    reps = -(-n // (1 << 14))
    pts = point_map(lambda t: t.repeat((1,) * (t.dim() - 1) + (reps,))
                    [..., :n].contiguous(), base)
    s = random_scalars(rng, (rows, n)).to(dev)
    return pts, (s if rows > 1 else s[0])


def profile(C, points, scalars, c: int, dev) -> dict:
    """The staged MSM with per-stage device ms and per-chunk peaks."""
    torch.cuda.synchronize(dev)
    ref = msm.msm(C, points, scalars, c=c)
    torch.cuda.synchronize(dev)
    n = scalars.shape[-1]
    lead = tuple(np.broadcast_shapes(tuple(C.F.batch_shape(points.x)[:-1]),
                                     tuple(scalars.shape[:-2])))
    W = -(-(bn254.FR.bits + 1) // c)
    chunk = msm.windows_per_chunk(C, W, lead, n)
    events = []

    def stage(name, fn, *args):
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        out = fn(*args)
        e1.record()
        events.append((name, e0, e1))
        return out

    def add(a, b):
        return C.add(Point(*a), Point(*b))

    mags, negs = stage("digits", lambda: msm._signed_digits(
        msm._all_digits(bn254.FR, scalars, c, W), c))
    src = stage("negation", lambda: point_concat([points, C.neg(points)]))
    parts, chunks = [], []
    for j in range(0, W, chunk):
        torch.cuda.synchronize(dev)
        start = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        tag = f"chunk{j // chunk}"
        smag, idx = stage(f"{tag}.sort", msm._sort_windows,
                          mags[j : j + chunk], negs[j : j + chunk])
        ps = stage(f"{tag}.gather", msm.point_index, C, src,
                   msm._rows(idx, lead), lead)
        pre = stage(f"{tag}.scan", lambda p: Point(*scan(add, p)), ps)
        del ps
        parts.append(stage(f"{tag}.buckets", msm._bucket_sums, C, smag, pre,
                           lead, 1 << (c - 1)))
        del pre
        torch.cuda.synchronize(dev)
        wc = min(chunk, W - j)
        peak = torch.cuda.max_memory_allocated(dev) - start
        copy = msm.window_bytes(C, lead, n) // (
            msm.LIVE_COPIES_G1 if C.g1 else msm.LIVE_COPIES_G2)
        chunks.append({"windows": wc, "peak_bytes": peak,
                       "planned_bytes": wc * msm.window_bytes(C, lead, n),
                       "live_copies": round(peak / (wc * copy), 3)})
    out = stage("horner", msm._horner, C,
                point_map(lambda *a: torch.cat(a), *parts), c)
    torch.cuda.synchronize(dev)
    if not all(torch.equal(a, b) for a, b in zip(out, ref)):
        raise SystemExit("staged MSM differs from msm.msm")
    ms = {}
    for name, e0, e1 in events:
        ms[name] = ms.get(name, 0.0) + e0.elapsed_time(e1)
    return {"n": n, "lead": list(lead), "c": c, "windows": W,
            "chunk": chunk, "ms": ms, "total_ms": sum(ms.values()),
            "chunks": chunks}


def profile_batch(C, n: int, dev) -> dict:
    """`msm.batch_scalar_mul` over n scalars at each of `BATCH_CHUNKS`."""
    s = random_scalars(np.random.default_rng(0), (n,)).to(dev)
    table = msm.generator_table(C, dev)
    msm.batch_scalar_mul(C, table, s[..., :1024])      # warm-up
    saved, ref, rows = msm.BATCH_CHUNK, None, {}
    try:
        for chunk in BATCH_CHUNKS:
            msm.BATCH_CHUNK = chunk
            torch.cuda.synchronize(dev)
            start = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            t0 = time.perf_counter()
            e0.record()
            out = msm.batch_scalar_mul(C, table, s)
            e1.record()
            torch.cuda.synchronize(dev)
            host_s = time.perf_counter() - t0
            if ref is None:
                ref = out
            elif not all(torch.equal(a, b) for a, b in zip(out, ref)):
                raise SystemExit(f"batch_scalar_mul at chunk {chunk} differs")
            rows[str(chunk)] = {
                "ms": e0.elapsed_time(e1), "host_s": host_s,
                "peak_bytes": torch.cuda.max_memory_allocated(dev) - start}
            del out
    finally:
        msm.BATCH_CHUNK = saved
    return {"n": n, "chunks": rows}


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("profile_msm_stages_torch: no CUDA device", file=sys.stderr)
        return 2
    flags = [a for a in argv if a.startswith("--")]
    args = [a for a in argv if not a.startswith("--")]
    log_n = int(args[0]) if args else 20
    c = int(args[1]) if len(args) > 1 else 17
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    cases = {f"g1_2e{log_n}_c{c}": (G1, 1, 1 << log_n, c)}
    if "--groth16" in flags:
        cases.update({k: (C, r, n, config.default_window(n))
                      for k, (C, r, n) in GROTH16_128.items()})
    report = {"device": torch.cuda.get_device_name(0), "smi": smi}
    with torch.inference_mode():
        for name, (C, rows, n, cw) in cases.items():
            pts, s = inputs(C, rows, n, dev)
            if rows > 1:      # a second set of bases, as Groth16's rows have
                pts = point_stack([pts, C.double(pts)])
            rep = profile(C, pts, s, cw, dev)
            report[name] = rep
            for stage_name, v in rep["ms"].items():
                print(f"{name} {stage_name:16s} {v:10.3f} ms", flush=True)
            for k, ch in enumerate(rep["chunks"]):
                print(f"{name} chunk{k}: {ch['windows']} windows, peak "
                      f"{ch['peak_bytes'] / 2**30:.3f} GiB (planned "
                      f"{ch['planned_bytes'] / 2**30:.3f}), "
                      f"{ch['live_copies']} live copies", flush=True)
            print(f"{name}: {rep['total_ms']:.3f} ms in {len(rep['chunks'])} "
                  f"chunk(s) of {rep['chunk']} of {rep['windows']} windows",
                  flush=True)
            del pts, s
            torch.cuda.empty_cache()
        if "--batch" in flags:
            for name, (C, n) in BATCHES_128.items():
                rep = profile_batch(C, n, dev)
                report[name] = rep
                for chunk, row in rep["chunks"].items():
                    print(f"{name} chunk {chunk:>6s}: {row['ms']:10.3f} ms "
                          f"device, {row['host_s']:.3f} s host, peak "
                          f"{row['peak_bytes'] / 2**30:.3f} GiB", flush=True)
                torch.cuda.empty_cache()
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
