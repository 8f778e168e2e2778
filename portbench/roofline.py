"""The least time of the G1 kernels K2 (`g1_add_kernel`) and K3
(`g1_double_kernel`, `csrc/g1.cu`) on one H100, per launch.

The bound is the larger of the bytes over HBM's 3.35 TB/s (NVIDIA's data
sheet, H100 SXM) and the 32-bit multiply instructions over the card's
INT32 multiply rate. That rate is not on the data sheet: it is derived as
64 INT32 lanes per SM (compute capability 9.0, half of the 128 FP32 lanes
behind the published 67 TFLOP/s float32 rate) x 132 SMs x the 1.98 GHz
boost clock = 16.7e12 multiplies per second. A run whose card holds a
lower SM clock (`nvidia-smi --query-gpu=clocks.sm`) cannot reach it.

Counts, as `chip_smoke.py` counts them (its 2^20 bounds: K2 0.2317 ms,
K3 0.1489 ms, both by operations): a Montgomery product is 264 multiply
instructions (64 word products for a*b and 64 for m*p, each with its low
and high word, and 8 for m = t[0] * pinv); a complete G1 addition is 14
products and reads two points and writes one (9 x 32 bytes per point of
the batch); a doubling is 9 products, and K3 with `times` = t doubles
t times in one launch over 3 + 3 coordinates.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
INT32_MUL_PER_S = 64 * 132 * 1.98e9
IMUL_PER_MONT = 2 * (64 + 64) + 8
LIMB_BYTES = 32
#: the kernels' names as the profiler reports them (prefixes)
KERNELS = {"g1_add": "g1_add_kernel", "g1_double": "g1_double_kernel"}


def least_seconds(kernel: str, points: int, times: int = 1) -> float:
    """The least time of one launch of `kernel` over `points` points."""
    if kernel == "g1_add":
        nbytes, imuls = 9 * LIMB_BYTES * points, 14 * IMUL_PER_MONT * points
    elif kernel == "g1_double":
        nbytes = 6 * LIMB_BYTES * points
        imuls = times * 9 * IMUL_PER_MONT * points
    else:
        raise ValueError(f"no bound for kernel {kernel!r}")
    return max(nbytes / HBM_BYTES_PER_S, imuls / INT32_MUL_PER_S)
