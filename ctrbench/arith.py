"""FLOP and byte arithmetic of the tower, and the table of peaks, frozen here.

Model FLOP of one train step of B rows through a tower of widths ``dims``:
the forward is ``2·B·Σ in·out`` (every layer's product), the backward
``4·B·Σ in·out`` (the input gradient and the weight gradient of every
layer). The backward kernels' recompute of the hidden layers is not model
work and is not counted. Bytes count each input read once and each output
written once.

Peaks are NVIDIA's data-sheet rates for the SXM H100 at its 700 W limit.
The tower's products are 3xTF32, the fastest product that keeps float32's
accuracy, so their peak is the TF32 rate over three: 495 / 3 = 165 TFLOP/s.
A card missing from the table has no peak, and its shares are not read.
"""

from __future__ import annotations

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"tf32x3_flops": 495e12 / 3, "hbm_bytes_per_s": 3.35e12},
}


def peak(kind: str) -> dict | None:
    return PEAKS.get(kind)


def macs(dims) -> int:
    return sum(a * b for a, b in zip(dims[:-1], dims[1:]))


def params(dims) -> int:
    return sum(a * b + b for a, b in zip(dims[:-1], dims[1:]))


def tower_fwd_flop(batch: int, dims) -> int:
    return 2 * batch * macs(dims)


def tower_bwd_flop(batch: int, dims) -> int:
    return 4 * batch * macs(dims)


def tower_fwd_bytes(batch: int, dims) -> int:
    """x and the parameters in, the logits out, f32."""
    return 4 * (batch * dims[0] + params(dims) + batch)


def tower_bwd_bytes(batch: int, dims) -> int:
    """x, the parameters and the logits' gradient in; x's gradient and the
    parameters' gradients out, f32."""
    return 4 * (2 * batch * dims[0] + 2 * params(dims) + batch)


def bound_s(flop: float, nbytes: float, pk: dict) -> float:
    """The least time on the card: the larger of the FLOP at the 3xTF32
    peak and the bytes at the HBM rate."""
    return max(flop / pk["tf32x3_flops"], nbytes / pk["hbm_bytes_per_s"])
