"""Size metadata of BulletProofs/Bootle circuits.

Counterpart of `legosnark_tpu/utils/bp_circuits.py` (the reference's
`utils/bp_circuits.{h,cc}`): reads the `=CIRC=` text format, one block
per circuit: a `=CIRC=` line, then `n_gates n_constraints [n_bits]`,
then one line each of per-row nonzero counts for WL, WR and WO. Used for
sizing experiments; no gadget consumes it.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List


@dataclass
class BPCircuit:
    n_gates: int = 0
    n_constraints: int = 0
    n_bits: int = 0
    wl_row_nnz: List[int] = field(default_factory=list)
    wr_row_nnz: List[int] = field(default_factory=list)
    wo_row_nnz: List[int] = field(default_factory=list)

    @property
    def total_nnz(self) -> int:
        return (sum(self.wl_row_nnz) + sum(self.wr_row_nnz)
                + sum(self.wo_row_nnz))


def parse_next(lines, i: int):
    """Parse the next `=CIRC=` block at or after line index i ->
    (circuit, index after it), or (None, len(lines)) at the end."""
    n = len(lines)
    while i < n and lines[i].strip() != "=CIRC=":
        i += 1
    if i >= n:
        return None, n
    header = lines[i + 1].split()
    circ = BPCircuit(n_gates=int(header[0]), n_constraints=int(header[1]),
                     n_bits=int(header[2]) if len(header) > 2 else 0)
    i += 2
    for attr in ("wl_row_nnz", "wr_row_nnz", "wo_row_nnz"):
        setattr(circ, attr, [int(tok) for tok in lines[i].split()])
        i += 1
    return circ, i


def read_from_file(path) -> List[BPCircuit]:
    """Every circuit of a `=CIRC=` file, in order."""
    with open(path) as fh:
        lines = fh.read().splitlines()
    out, i = [], 0
    while True:
        circ, i = parse_next(lines, i)
        if circ is None:
            return out
        out.append(circ)
