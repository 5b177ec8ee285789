"""The least time the chip needs for the dense layer's work, from shapes.

A dense call scores ``B`` queries of ``D`` f32 numbers against ``rows``
store rows of the stored type and writes each query's top ``k`` (an f32
value and an i32 row for each of ``slots`` routed slots).  The least
bytes read each scored row once (int8 rows with their f32 scale) and the
queries once, and write the top-k once; the least operations are the
``2 * B * rows * D`` of the products.  The least time is the larger of
bytes over the memory bandwidth and operations over the chip's peak for
the stored type.

Peaks: NVIDIA's data sheet for the H100 SXM, dense, at its 700 W limit.
"""

from __future__ import annotations

from dataclasses import dataclass

HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"int8": 1979e12, "bf16": 989e12, "float32": 67e12}
ROW_BYTES = {"int8": 1, "bf16": 2, "float32": 4}


@dataclass(frozen=True)
class DenseWork:
    dtype: str
    B: int
    rows: int
    D: int
    k: int
    slots: int = 1

    @property
    def bytes(self) -> float:
        row = self.D * ROW_BYTES[self.dtype] + (4 if self.dtype == "int8" else 0)
        return self.rows * row + self.B * self.D * 4 + self.B * self.slots * self.k * 8

    @property
    def ops(self) -> float:
        return 2.0 * self.B * self.rows * self.D

    def least_s(self) -> float:
        return max(self.bytes / HBM_BYTES_S, self.ops / PEAK_OPS_S[self.dtype])

    def bound(self) -> str:
        return "bytes" if self.bytes / HBM_BYTES_S >= self.ops / PEAK_OPS_S[self.dtype] else "operations"
