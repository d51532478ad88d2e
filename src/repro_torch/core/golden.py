"""Exact "golden" circuit builders (paper Sec. IV).

The paper's golden circuit is the 8x8 array multiplier produced by yosys for
the Verilog ``*`` operator.  We build the structurally equivalent textbook
array multiplier (AND partial products + half/full-adder reduction rows) — the
same netlist family yosys emits for small operand widths — directly as a CGP
genome, plus ripple-carry adders for the "structurally simpler circuits"
remark in Sec. IV.  Exactness of every builder is asserted against NumPy in
tests for widths 1..8 (and against the reference package's builders).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import gates
from repro_torch.core.genome import CGPSpec, Genome


class NetBuilder:
    """Builds a feed-forward netlist and pads it into a fixed-size genome."""

    def __init__(self, n_i: int, n_o: int):
        self.n_i = n_i
        self.n_o = n_o
        self.nodes: list[tuple[int, int, int]] = []

    def gate(self, func: int, a: int, b: int | None = None) -> int:
        if b is None:
            b = a
        idx = self.n_i + len(self.nodes)
        assert a < idx and b < idx, "feed-forward violation"
        self.nodes.append((a, b, func))
        return idx

    # convenience wrappers -------------------------------------------------
    def and_(self, a, b):  return self.gate(gates.AND, a, b)
    def or_(self, a, b):   return self.gate(gates.OR, a, b)
    def xor_(self, a, b):  return self.gate(gates.XOR, a, b)
    def buf(self, a):      return self.gate(gates.BUF, a)

    def half_adder(self, a: int, b: int) -> tuple[int, int]:
        return self.xor_(a, b), self.and_(a, b)

    def full_adder(self, a: int, b: int, c: int) -> tuple[int, int]:
        s1 = self.xor_(a, b)
        s = self.xor_(s1, c)
        c1 = self.and_(a, b)
        c2 = self.and_(s1, c)
        return s, self.or_(c1, c2)

    def const0(self) -> int:
        """A constant-0 wire: XOR(x, x) of input 0."""
        return self.gate(gates.XOR, 0, 0)

    def finish(self, outs: list[int], spec: CGPSpec) -> Genome:
        """Pad to ``spec.n_n`` nodes; int32 CPU tensors."""
        assert len(outs) == spec.n_o
        if len(self.nodes) > spec.n_n:
            raise ValueError(f"netlist needs {len(self.nodes)} nodes > "
                             f"spec.n_n={spec.n_n}")
        nodes = list(self.nodes)
        # pad with inert BUF(0) nodes — they are inactive by construction
        while len(nodes) < spec.n_n:
            nodes.append((0, 0, gates.BUF))
        return Genome(torch.tensor(nodes, dtype=torch.int32),
                      torch.tensor(outs, dtype=torch.int32))


def ripple_carry_adder(width: int, n_n: int | None = None) -> tuple[Genome, CGPSpec]:
    """width-bit + width-bit -> (width+1)-bit ripple-carry adder.

    Inputs: a[0..w-1] = indices 0..w-1 (LSB first), b = indices w..2w-1.
    """
    n_i, n_o = 2 * width, width + 1
    nb = NetBuilder(n_i, n_o)
    outs = []
    s, c = nb.half_adder(0, width)
    outs.append(s)
    for i in range(1, width):
        s, c = nb.full_adder(i, width + i, c)
        outs.append(s)
    outs.append(nb.buf(c))
    spec = CGPSpec(n_i=n_i, n_o=n_o, n_n=n_n or max(16, len(nb.nodes)))
    return nb.finish(outs, spec), spec


def array_multiplier(width: int, n_n: int | None = None) -> tuple[Genome, CGPSpec]:
    """width x width -> 2*width unsigned array multiplier (the paper's golden).

    Inputs: a = indices 0..w-1 (LSB first), b = indices w..2w-1.
    Row-by-row carry-save reduction with a final ripple row, the textbook
    array-multiplier structure.
    """
    w = width
    n_i, n_o = 2 * w, 2 * w
    nb = NetBuilder(n_i, n_o)

    # partial products pp[i][j] = a_j & b_i
    pp = [[nb.and_(j, w + i) for j in range(w)] for i in range(w)]

    outs = [pp[0][0]]
    # running row: bits of the current partial sum, LSB already emitted.
    row = pp[0][1:]          # w-1 bits: weights 1..w-1 relative to current row
    carry = None
    for i in range(1, w):
        new_row = []
        carry = None
        for j in range(w):
            # add pp[i][j] (weight i+j) to row bit (weight i+j) and carry
            acc = row[j] if j < len(row) else None
            p = pp[i][j]
            if acc is None and carry is None:
                s, carry = p, None
                new_row.append(s)
            elif acc is None:
                s, carry = nb.half_adder(p, carry)
                new_row.append(s)
            elif carry is None:
                s, carry = nb.half_adder(p, acc)
                new_row.append(s)
            else:
                s, carry = nb.full_adder(p, acc, carry)
                new_row.append(s)
        outs.append(new_row[0])
        row = new_row[1:]
        if carry is not None:
            row = row + [carry]
            carry = None
    # final row bits are the top output bits
    outs.extend(row)
    while len(outs) < n_o:
        outs.append(nb.const0())
    spec = CGPSpec(n_i=n_i, n_o=n_o, n_n=n_n or max(16, len(nb.nodes)))
    return nb.finish(outs, spec), spec


def golden_values(width: int, kind: str = "mul") -> np.ndarray:
    """int32 exact outputs over the exhaustive input cube (LSB-first operands).

    Tiled to at least 32 entries to match ``simulate.input_planes_np``
    packing of sub-word cubes (see there for why replication is exact).
    """
    n = 1 << (2 * width)
    xs = np.arange(max(n, 32), dtype=np.int64) % n
    a = xs & ((1 << width) - 1)
    b = xs >> width
    if kind == "mul":
        return (a * b).astype(np.int32)
    if kind == "add":
        return (a + b).astype(np.int32)
    raise ValueError(kind)
