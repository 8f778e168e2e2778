"""Gadget benchmark: the reference configurations of BASELINE.md.

Counterpart of `bench_gadgets.py`: the same selectors, configuration
names, phases, seeds and draws, and rows with the same keys. Every phase
gets one JSON row, printed as it is made and written to `--out` (rows
of configurations this run does not emit are kept). A row's `seconds`
are a warm call: the host clock around the call and a
`torch.cuda.synchronize` on the device of every tensor of its result
(`utils.benchmark.time_function`). `cold_s` is the first call of the
process, which also builds what later calls reuse (the generator tables,
the NTT's host tables, the kernel libraries' load); nothing is warmed
before it. `srs_cache_hit` says whether keygen found its key on disk.

Configurations (BASELINE.md): CPlink N = 2^10; CPpoly over 20 variables;
CPsc 16-variate; CPhad and CPhadL at n = 2^14; CPmmp 1024 x 1024, the
last three in the honest-verifier mode. `--scale F` (a fraction, e.g.
1/4) scales each exponent to max(2, round(v * F)), giving the names
`bench_gadgets.py` gives. `cppoly_20var` and `cpmmp_1024x1024` share one SRS file
(PST13 over 20 variables, seed 1).

Usage: python -m legosnark_tpu_torch.bench_gadgets [SELECTOR ...]
       [--scale F] [--cpu] [--out FILE] [--srs-cache DIR]
  SELECTOR in cplink cppoly cpmmp cphad cpsc (cphad runs cphad and cphadl);
  all by default. --out defaults to build/bench_gadgets_torch.json and
  --srs-cache to srs_cache/, both beside the package.
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import threading
import time
from fractions import Fraction
from pathlib import Path

import numpy as np
import torch

from .config import resolve_device
from .curve import bn254
from .curve.group import point_map
from .examples import cplink as cplink_example
from .examples import matrixsc
from .fields import limb as fl
from .gadgets import hadamard as cphad
from .gadgets import lipmaa
from .gadgets import matrix as cpmat
from .gadgets import poly as cppoly
from .gadgets import sumcheck as cpsc
from .utils import benchmark as bm
from .utils import rand as lrand

FR = bn254.FR
KNOWN = ("cplink", "cppoly", "cpmmp", "cphad", "cpsc")
DEFAULT_OUT = Path(__file__).resolve().parents[1] / "build" / \
    "bench_gadgets_torch.json"


class Rows:
    """The rows of one run. With a `path`, the file is rewritten after
    every row (to a temporary file, then moved into place, so an
    interrupted run never leaves it truncated), and the rows it held for
    configurations outside `replace` are kept."""

    def __init__(self, path=None, replace=()):
        self.path = None if path is None else Path(path)
        self.rows = []
        if self.path is None:
            return
        try:
            with open(self.path) as fh:
                old = json.load(fh)
        except (OSError, ValueError):
            old = []
        if isinstance(old, list):
            self.rows = [r for r in old if isinstance(r, dict)
                         and r.get("config") not in replace]

    def emit(self, config: str, phase: str, seconds: float,
             extra: dict | None = None) -> None:
        rec = {"config": config, "phase": phase, "seconds": round(seconds, 4)}
        for k, v in (extra or {}).items():
            rec[k] = round(v, 4) if isinstance(v, float) else v
        self.rows.append(rec)
        print(json.dumps(rec), flush=True)
        self.flush()

    def flush(self) -> None:
        if self.path is None:
            return
        self.path.parent.mkdir(parents=True, exist_ok=True)
        tmp = self.path.with_name(f"{self.path.name}.{os.getpid()}.tmp")
        with open(tmp, "w") as fh:
            json.dump(self.rows, fh, indent=1)
        os.replace(tmp, self.path)


def _timed(fn):
    """(fn(), seconds), the clock stopped after every CUDA tensor of the
    result is done."""
    out, micros = bm.time_function(fn)
    return out, micros / 1e6


def _cold_warm(rows: Rows, cfg: str, phase: str, fn, verdict: bool = False):
    """Calls fn twice; one row with the second call's seconds and the
    first's as `cold_s` (and `ok` from a verdict). Returns fn()."""
    out, cold = _timed(fn)
    out, warm = _timed(fn)
    extra = {"cold_s": cold}
    if verdict:
        extra["ok"] = bool(out)
    rows.emit(cfg, phase, warm, extra)
    return out


def same_point(r):
    """CPsc opens both tables at its own round challenges."""
    return r, r


def bench_cplink(log_n: int, device=None, rows: Rows | None = None) -> dict:
    """`examples.cplink.run`'s phases, then its total with the verdict."""
    dev = resolve_device(device)
    rows = rows or Rows()
    cfg = f"cplink_2e{log_n}"
    t0 = time.perf_counter()
    res = cplink_example.run(log_n, dev)
    total = time.perf_counter() - t0
    for phase in ("commit", "keygen", "prove", "verify"):
        rows.emit(cfg, phase, res["times"][phase])
    rows.emit(cfg, "total", total, {"ok": res["ok"]})
    return res


def bench_cppoly(d: int, device=None, cache_dir=None,
                 rows: Rows | None = None) -> dict:
    """CPpoly over d variables: keygen (seed 1, through the SRS cache), one
    commitment, an opening at a random point, verify."""
    dev = resolve_device(device)
    rows = rows or Rows()
    cfg = f"cppoly_{d}var"
    rng = np.random.default_rng(3)
    hit = cppoly.srs_path(d, 1, cache_dir).exists()
    key, dt = _timed(lambda: cppoly.keygen_cached(d, 1, cache_dir, dev))
    rows.emit(cfg, "keygen", dt, {"srs_cache_hit": hit})

    v = lrand.rand_fr_mont_fast(rng, 1 << d, dev)
    r = lrand.rand_fr_mont(rng, d, dev)
    cm = _cold_warm(rows, cfg, "commit", lambda: cppoly.commit(key, v))
    pf = _cold_warm(rows, cfg, "prove", lambda: cppoly.prove(key, v, r))
    (ans, ans_c), _ = _timed(lambda: cppoly.compute_answer(key, v, r))
    ok = _cold_warm(rows, cfg, "verify", lambda: (
        cppoly.check_commit(key, cm) & cppoly.verify(key, cm, ans_c, r, pf)),
        True)
    return {"key": key, "v": v, "r": r, "comm": cm, "proof": pf, "ans": ans,
            "ans_comm": ans_c, "ok": bool(ok)}


def cpsc_inputs(d: int, device=None) -> dict:
    """CPsc's draws from rng 7 + d: the tables a, b, the honest-verifier
    randomness (`rand` for the prover, `hv` its verifier half) and the
    round challenges."""
    dev = resolve_device(device)
    rng = np.random.default_rng(7 + d)
    a = lrand.rand_fr_mont_fast(rng, 1 << d, dev)
    b = lrand.rand_fr_mont_fast(rng, 1 << d, dev)
    rand = {"eq_k": lrand.rand_fr_mont(rng, d, dev),
            "prd_b": lrand.rand_fr_mont(rng, 5, dev),
            "eq_e": lrand.rand_fr_mont(rng, d, dev),
            "prd_e": lrand.rand_fr_mont(rng, 1, dev)}
    chal = lrand.rand_fr_mont(rng, d, dev)
    return {"a": a, "b": b, "rand": rand, "chal": chal,
            "hv": {"eq_e": rand["eq_e"], "prd_e": rand["prd_e"]}}


def bench_cpsc(d: int, device=None, cache_dir=None,
               rows: Rows | None = None) -> dict:
    """The standalone generalised sumcheck over two committed 2^d-entry
    MLEs a, b: z0 = sum_p a(p) b(p), both opened at the round challenges,
    honest-verifier mode."""
    dev = resolve_device(device)
    rows = rows or Rows()
    cfg = f"cpsc_{d}var"
    hit = cppoly.srs_path(d, d, cache_dir).exists()
    key, dt = _timed(lambda: cppoly.keygen_cached(d, d, cache_dir, dev))
    rows.emit(cfg, "keygen", dt, {"srs_cache_hit": hit})

    inp = cpsc_inputs(d, dev)
    a, b, rand, chal, hv = (inp[k] for k in ("a", "b", "rand", "chal", "hv"))
    tables = torch.stack([a, b])
    a_cm, b_cm = _cold_warm(rows, cfg, "commit", lambda: (
        cppoly.commit(key, a), cppoly.commit(key, b)))
    pf, z0, z0_comm, _ = _cold_warm(rows, cfg, "prove", lambda: cpsc.prove(
        key, tables, rand, same_point, (a, b), challenges=chal))
    ok = _cold_warm(rows, cfg, "verify", lambda: cpsc.verify(
        key, z0_comm, (a_cm, b_cm), pf, same_point, rand=hv), True)
    return {**inp, "key": key, "comms": (a_cm, b_cm), "proof": pf, "z0": z0,
            "z0_comm": z0_comm, "ok": bool(ok)}


def bench_cphad(log_n: int, device=None, cache_dir=None,
                rows: Rows | None = None) -> dict:
    """CPhad (the sumcheck over CPpoly) and CPhadL (Lipmaa's quotient
    argument) on u o u = u^2 at n = 2^log_n, honest-verifier mode."""
    dev = resolve_device(device)
    rows = rows or Rows()
    n, d = 1 << log_n, log_n
    rng = np.random.default_rng(31 + d)
    u = lrand.rand_fr_mont_fast(rng, n, dev)
    sq = fl.mont_mul(FR, u, u)

    cfg = f"cphad_2e{log_n}"
    hit = cppoly.srs_path(d, d, cache_dir).exists()
    key, dt = _timed(lambda: cphad.keygen_cached(n, d, cache_dir, dev))
    rows.emit(cfg, "keygen", dt, {"srs_cache_hit": hit})
    a_cm, c_cm = _cold_warm(rows, cfg, "commit", lambda: (
        cphad.commit_vec(key, u), cphad.commit_vec(key, sq)))
    nonces = cphad.make_nonces(d, seed=d, device=dev)
    rho = lrand.rand_fr_mont(rng, d, dev)
    chal = lrand.rand_fr_mont(rng, d, dev)
    hv = {"eq_e": lrand.rand_fr_mont(rng, d, dev),
          "prd_e": lrand.rand_fr_mont(rng, 1, dev)}
    pf = _cold_warm(rows, cfg, "prove", lambda: cphad.prove(
        key, u, u, sq, rho, chal, {**nonces, **hv}))
    ok = _cold_warm(rows, cfg, "verify", lambda: cphad.verify(
        key, a_cm, a_cm, c_cm, pf, hv), True)
    had = {"key": key, "comms": (a_cm, c_cm), "proof": pf, "ok": bool(ok)}

    cfg = f"cphadl_2e{log_n}"
    hit = lipmaa.srs_path(n, d, cache_dir).exists()
    lkey, dt = _timed(lambda: lipmaa.keygen_cached(n, d, cache_dir, dev))
    rows.emit(cfg, "keygen", dt, {"srs_cache_hit": hit})
    ds = lrand.rand_fr_mont(rng, 3, dev)
    # the three commitments (u, u, u^2 with r = d1, d2, d3) as rows of
    # one call, as examples.hadamard makes them
    cms = _cold_warm(rows, cfg, "commit", lambda: lipmaa.commit(
        lkey.interp, torch.stack([u, u, sq]), ds.T[:, :, None]))
    ca, cb, cc = (lipmaa.InterpComm(*(point_map(lambda x, i=i: x[i], p)
                                      for p in cms)) for i in range(3))
    pi = _cold_warm(rows, cfg, "prove",
                    lambda: lipmaa.prove(lkey, u, u, sq, ds))
    lok = _cold_warm(rows, cfg, "verify",
                     lambda: lipmaa.verify(lkey, ca, cb, cc, pi), True)
    return {"cphad": had, "cphadl": {"key": lkey, "comms": (ca, cb, cc),
                                     "pi": pi, "ok": bool(lok)}}


def bench_cpmmp(n: int, device=None, cache_dir=None,
                rows: Rows | None = None) -> dict:
    """CPmmp on n x n matrices with C = A*B public, honest-verifier mode:
    `examples.matrixsc`'s data, keygen (seed 1, through the SRS cache),
    challenges and nonces."""
    dev = resolve_device(device)
    rows = rows or Rows()
    d = int(n).bit_length() - 1
    cfg = f"cpmmp_{n}x{n}"
    rng = np.random.default_rng(17 + d)
    A, B, C, _ = matrixsc.make_data(rng, n, dev)
    hit = cppoly.srs_path(2 * d, 1, cache_dir).exists()
    key, dt = _timed(lambda: cpmat.keygen_cached(n, 1, cache_dir, dev))
    rows.emit(cfg, "keygen", dt, {"srs_cache_hit": hit})

    nonces = cpmat.make_nonces(d, seed=d, device=dev)
    chal = lrand.rand_fr_mont(rng, d, dev)
    hv = {"eq_e": lrand.rand_fr_mont(rng, d, dev),
          "prd_e": lrand.rand_fr_mont(rng, 1, dev)}
    r = lrand.rand_fr_mont(rng, d, dev)
    s = lrand.rand_fr_mont(rng, d, dev)
    a_cm, b_cm = _cold_warm(rows, cfg, "commit", lambda: (
        cpmat.commit_matrix(key, A), cpmat.commit_matrix(key, B)))
    pf = _cold_warm(rows, cfg, "prove", lambda: cpmat.prove_output_in_clear(
        key, A, B, C, r, s, nonces, challenges=chal, hv_rand=hv))
    ok = _cold_warm(rows, cfg, "verify", lambda: cpmat.verify_output_in_clear(
        key, a_cm, b_cm, C, pf, hv_rand=hv), True)
    return {"key": key, "comms": (a_cm, b_cm), "proof": pf, "ok": bool(ok)}


def parse_scale(text: str) -> Fraction:
    """A positive fraction such as 1, 1/4 or 0.25; anything else raises
    ValueError."""
    scale = Fraction(text)
    if scale <= 0:
        raise ValueError(f"scale must be positive, got {text!r}")
    return scale


def shrink(v: int, scale: Fraction) -> int:
    return max(2, round(v * scale))


def config_names(which, scale: Fraction) -> set:
    """The configurations a run of the selectors `which` at `scale` emits."""
    names = set()
    if "cplink" in which:
        names.add(f"cplink_2e{shrink(10, scale)}")
    if "cppoly" in which:
        names.add(f"cppoly_{shrink(20, scale)}var")
    if "cphad" in which:
        k = shrink(14, scale)
        names.update({f"cphad_2e{k}", f"cphadl_2e{k}"})
    if "cpsc" in which:
        names.add(f"cpsc_{shrink(16, scale)}var")
    if "cpmmp" in which:
        n = 1 << shrink(10, scale)
        names.add(f"cpmmp_{n}x{n}")
    return names


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m legosnark_tpu_torch.bench_gadgets",
        description="Gadget benchmark rows (cphad runs cphad and cphadl).")
    p.add_argument("which", nargs="*", metavar="SELECTOR",
                   help=f"any of {', '.join(KNOWN)} (all by default)")
    p.add_argument("--scale", type=parse_scale, default=Fraction(1))
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--out", type=Path, default=DEFAULT_OUT)
    p.add_argument("--srs-cache", type=Path, default=None)
    return p


def main(argv) -> dict:
    """Runs the selected configurations -> {configuration: what its bench
    function returned}. SIGTERM ends the run with exit code 143 after the
    rows so far are written."""
    parser = _parser()
    args = parser.parse_args(argv)
    bad = [w for w in args.which if w not in KNOWN]
    if bad:
        parser.error(f"unknown selector(s) {bad}; known: {', '.join(KNOWN)}")
    dev = resolve_device("cpu" if args.cpu else None)
    which = set(args.which) or set(KNOWN)
    scale, cache = args.scale, args.srs_cache
    rows = Rows(args.out, config_names(which, scale))
    on_main = threading.current_thread() is threading.main_thread()
    if on_main:
        prev = signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))
    out = {}
    try:
        if "cplink" in which:
            k = shrink(10, scale)
            out[f"cplink_2e{k}"] = bench_cplink(k, dev, rows)
        if "cppoly" in which:
            k = shrink(20, scale)
            out[f"cppoly_{k}var"] = bench_cppoly(k, dev, cache, rows)
        if "cpsc" in which:
            k = shrink(16, scale)
            out[f"cpsc_{k}var"] = bench_cpsc(k, dev, cache, rows)
        if "cphad" in which:
            k = shrink(14, scale)
            out.update({f"{name}_2e{k}": res for name, res in
                        bench_cphad(k, dev, cache, rows).items()})
        if "cpmmp" in which:
            n = 1 << shrink(10, scale)
            out[f"cpmmp_{n}x{n}"] = bench_cpmmp(n, dev, cache, rows)
    finally:
        rows.flush()
        if on_main:
            signal.signal(signal.SIGTERM, prev)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
