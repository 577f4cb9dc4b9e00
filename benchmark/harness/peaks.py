"""Published peaks of the devices the benchmark runs on.

NVIDIA H100 SXM (NVIDIA's data sheet, dense rates, at its full 700 W
power limit): 67 TFLOP/s in float32 outside the tensor cores (the port's
solver runs its float32 matmuls with TF32 off), 989 TFLOP/s in bf16, 3.35
TB/s of HBM3 bandwidth.  A card set below 700 W runs slower under load;
the harness prints its power limit beside every share of a peak.
"""

from __future__ import annotations

PEAKS = {
    "H100": {"f32_flops": 67e12, "bf16_flops": 989e12, "bytes_per_s": 3.35e12},
}


def peaks_of(device_name: str):
    """The peaks of the device named ``device_name``, or None."""
    for key, peaks in PEAKS.items():
        if key in device_name:
            return peaks
    return None
