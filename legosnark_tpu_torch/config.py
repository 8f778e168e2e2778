"""Device selection and the default MSM window.

Counterpart of `legosnark_tpu/config.py:38-51`, without the XLA compile
cache.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`cuda` unless the caller names another device. Asking for CUDA on
    a machine without a card raises: entry points never fall back to the
    CPU on their own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' to run on the CPU")
    return dev


def default_window(n: int) -> int:
    """Pippenger window c (bits) for an n-point MSM. The port always
    recodes digits as signed (curve/msm.py), which halves the bucket range,
    so c = 17 above 2^17 always runs with signed digits."""
    if n <= (1 << 10):
        return 8
    if n <= (1 << 16):
        return 10
    if n <= (1 << 17):
        return 13
    return 17
