"""The least time the chip needs for a layer's work, from shapes.

A dense call scores ``B`` queries of ``D`` f32 numbers against ``rows``
store rows of the stored type and writes each query's top ``k`` (an f32
value and an i32 row for each of ``slots`` routed slots).  The least
bytes read each scored row once (int8 rows with their f32 scale) and the
queries once, and write the top-k once; the least operations are the
``2 * B * rows * D`` of the products.  The least time is the larger of
bytes over the memory bandwidth and operations over the chip's peak for
the stored type.

A model's call (``ModelWork``) brings its operations and bytes from its
reference file (``reference/models/<name>.py``: ``flops``, ``bytes``);
it carries the type its products run in, the configuration's, as the
key of its peak (``peak_key``); its least time is the larger of bytes
over the memory bandwidth and operations over that peak.

Peaks: NVIDIA's data sheet for the H100 SXM, dense, at its 700 W limit.
"""

from __future__ import annotations

from dataclasses import dataclass

HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"int8": 1979e12, "fp8": 1979e12, "bf16": 989e12, "float32": 67e12}
ROW_BYTES = {"int8": 1, "bf16": 2, "float32": 4}
# the peak a model's products run at, by the torch type a configuration names
TORCH_PEAK = {"torch.int8": "int8", "torch.float8_e4m3fn": "fp8", "torch.float8_e5m2": "fp8",
              "torch.bfloat16": "bf16", "torch.float16": "bf16", "torch.float32": "float32"}


def peak_key(torch_type: str) -> str:
    """The ``PEAK_OPS_S`` key of a model computing in ``torch_type``
    (``"torch.bfloat16"``; float16 runs at bf16's peak)."""
    return TORCH_PEAK[torch_type]


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


@dataclass(frozen=True)
class ModelWork:
    flops: float
    bytes: float
    dtype: str          # a PEAK_OPS_S key: the type the products run in

    def peak_s(self) -> float:
        """The operations' time at the chip's peak for the model's type."""
        return self.flops / PEAK_OPS_S[self.dtype]

    def least_s(self) -> float:
        return max(self.peak_s(), self.bytes / HBM_BYTES_S)
