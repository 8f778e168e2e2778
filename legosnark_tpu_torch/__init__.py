"""PyTorch/CUDA port of `legosnark_tpu` for an NVIDIA H100.

The module tree mirrors `legosnark_tpu` so that each ported function sits
at the same path as its JAX counterpart. Field elements are int32 tensors
of 8 x 32-bit limbs, limb-major `[..., 8, n]` (see `fields/limb.py`).

Entry points run on `cuda` unless the caller passes `device="cpu"`; with
no card they raise. On CUDA tensors every Fq/Fr Montgomery product runs
in the hand-written kernel of `csrc/mont_mul.cu` and every G1 add and
double in `csrc/g1.cu`; on CPU tensors the same wrappers take their plain
PyTorch versions.

This package imports neither `jax` nor anything of `legosnark_tpu`.
"""
