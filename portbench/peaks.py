"""Published dense peaks of the cards the benchmark knows (NVIDIA's data
sheet, SXM part, at its full 700 W): FLOP/s by the dtype of the products'
operands (float32 with TF32 off: outside the tensor cores) and HBM bytes/s.
A card not named here has no peak, and every share of a peak is then left
out of the result."""

from __future__ import annotations

from typing import Optional

PEAKS = (
    ("H100 80GB HBM3", {"bfloat16": 989.4e12, "float32": 66.9e12, "hbm_bytes": 3.35e12}),
)


def peak(device_name: Optional[str], what: str) -> Optional[float]:
    if not device_name:
        return None
    return next((p[what] for key, p in PEAKS if key in device_name), None)
