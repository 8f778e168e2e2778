"""Plain reference of Groth16 on the n x n matmul R1CS at the paper's top
size, n = 128 (2^21 constraints): the relation, the trapdoor's values and
the checks of `groth16_mm64`, whose docstring states them. The timed
statement is checked in full, every constraint of its QAP sums and every
private wire of its commitment, in Python ints."""
from __future__ import annotations

from .groth16_mm64 import R, Trapdoor, check, expected  # noqa: F401
