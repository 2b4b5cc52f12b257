"""Published peaks of the cards the benchmark knows (frozen copy of
`scripts/roofline_b384_torch.py:PEAKS`).

NVIDIA H100 SXM data sheet, dense rates without sparsity: 989.4 TFLOP/s
bfloat16 on the tensor cores, 3.35 TB/s of HBM. Keyed on `torch.cuda.get_device_name()`; a card the table lacks is
refused, so a share is never taken against a guess. The rates assume the
card's full 700 W; the run prints `power.limit` beside them."""

from __future__ import annotations

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989.4e12, "hbm_bytes": 3.35e12},
}


def peaks_of(name: str) -> dict:
    if name not in PEAKS:
        raise ValueError(f"no published peak for the card {name!r}; the table holds "
                         f"{sorted(PEAKS)}")
    return PEAKS[name]
