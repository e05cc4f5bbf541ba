"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet: dense rates,
no sparsity, at the full 700 W power limit), and the card's name and power
limit as ``nvidia-smi`` reads them.

The peak a product is held to is fixed by its operands' dtype, whatever
kernel computes it: bf16 operands at the tensor cores' bf16 rate, fp32
operands at the TF32 rate, the fastest at which the card multiplies fp32
inputs at all (67 TFLOP/s is the rate outside the tensor cores).
"""

from __future__ import annotations

import subprocess

HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
TF32_FLOP_PER_S = 495e12

PRODUCT_PEAK = {"bfloat16": BF16_FLOP_PER_S, "float32": TF32_FLOP_PER_S}


def product_peak(dtype: str) -> float:
    """FLOP/s of products whose operands are ``dtype`` (``bfloat16`` or
    ``float32``)."""
    return PRODUCT_PEAK[dtype]


def card(fields: str = "name,power.limit") -> str:
    """``nvidia-smi``'s ``fields`` of card 0 (e.g. ``"NVIDIA H100 80GB HBM3,
    700.00 W"``), or ``"not read"`` where it does not answer."""
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader",
             "--id=0"],
            capture_output=True, text=True, timeout=30, check=True)
    except (OSError, subprocess.SubprocessError):
        return "not read"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else \
        "not read"
