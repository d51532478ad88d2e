"""Gate set Γ for the linear 1-D CGP used in the paper.

The paper uses standard 2-input/1-output CGP nodes (Sec. III-A); the full
experiments use the usual 8-function set of the EvoApprox line of work.
Every gate is a 4-bit truth table indexed by ``a + 2*b``, so simulation is a
branch-free 4-term mask merge — the CUDA kernel evaluates any gate without
control flow.

Power/area/delay constants are a FreePDK45-calibrated analytic proxy (no
RTL synthesis).  Only *relative* power (vs. the golden circuit) is ever
reported, matching the paper's figures.  Values are those of the reference
package, so both compute the same fitness.
"""
from __future__ import annotations

import numpy as np

# Gate codes.  Keep BUF first so that "wire-through" mutations are cheap.
BUF, INV, AND, OR, XOR, NAND, NOR, XNOR = range(8)

GATE_NAMES = ("buf", "inv", "and", "or", "xor", "nand", "nor", "xnor")
N_FUNCS = 8

# 4-bit truth tables, bit k = output for (a, b) with k = a + 2*b.
#                 BUF     INV     AND     OR      XOR     NAND    NOR     XNOR
TRUTH_TABLES = np.array([0b1010, 0b0101, 0b1000, 0b1110, 0b0110, 0b0111, 0b0001, 0b1001],
                        dtype=np.int32)

# all 8 truth tables packed into one 32-bit scalar (4 bits per gate code):
#   tt = (TT_PACKED >> (4*func)) & 0xF
TT_PACKED = int(sum(int(t) << (4 * i) for i, t in enumerate(TRUTH_TABLES)))

# Which gates ignore their second input (1-input gates).  Used by the active-set
# computation so that power is not attributed to a dangling fan-in.
ONE_INPUT = np.array([1, 1, 0, 0, 0, 0, 0, 0], dtype=np.int32)

# --- FreePDK45-calibrated analytic constants (per-gate) -----------------------
# Switching energy in fJ per output toggle, leakage in nW, area in um^2,
# propagation delay in ps (static-CMOS transistor-count ordering).
SWITCH_ENERGY_FJ = np.array([1.20, 0.70, 1.40, 1.40, 2.10, 1.00, 1.00, 2.10], dtype=np.float32)
LEAKAGE_NW      = np.array([18.0, 10.0, 22.0, 22.0, 36.0, 16.0, 16.0, 36.0], dtype=np.float32)
AREA_UM2        = np.array([1.06, 0.53, 1.33, 1.33, 2.13, 0.80, 0.80, 2.13], dtype=np.float32)
DELAY_PS        = np.array([18.0, 10.0, 22.0, 24.0, 30.0, 15.0, 18.0, 30.0], dtype=np.float32)
