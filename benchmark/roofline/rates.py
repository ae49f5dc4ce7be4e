"""The card's peaks and the least time a piece of work can take.

Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
its 700 W power limit): HBM at 3.35 TB/s, float32 outside the tensor
cores at 67 TFLOP/s. The integer rates follow from the clock that the
float32 rate implies (67e12 = 2 x 128 lanes x 132 SMs x 1.98 GHz): an SM
issues 128 lanes of instructions a clock, and has 64 lanes each of the
ALU pipe and of the IMAD (FMA-heavy) pipe.

A frozen copy of the bound arithmetic the port's smoke script uses
(``Ops``, ``bytes_bound``), so that a later change to the program cannot
move the yardstick.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
SMS = 132
SM_CLOCK_HZ = FP32_OPS_PER_S / (2 * 128 * SMS)
ISSUE_PER_S = 128 * SMS * SM_CLOCK_HZ
ALU_PER_S = IMAD_PER_S = 64 * SMS * SM_CLOCK_HZ


class Ops(tuple):
    """(fp32, integer, alu, imad) operation counts; ``+`` adds them, ``*``
    by a number scales all four."""

    def __new__(cls, fp=0.0, integer=0.0, alu=0.0, imad=0.0):
        return super().__new__(cls, (fp, integer, alu, imad))

    def __add__(self, other):
        return Ops(*(a + b for a, b in zip(self, other)))

    def __mul__(self, n):
        return Ops(*(a * n for a in self))

    __rmul__ = __mul__


def bytes_bound(nbytes: float, ops: Ops) -> tuple:
    """(seconds, "bytes" | "operations"): the larger of the bytes over the
    memory rate and the operations over their rates."""
    fp, integer, alu, imad = ops
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max(fp / FP32_OPS_PER_S, integer / ISSUE_PER_S,
                alu / ALU_PER_S, imad / IMAD_PER_S)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
