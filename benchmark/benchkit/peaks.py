"""Published peaks of the cards the benchmark runs on, by the name
``torch.cuda.get_device_name()`` gives. The NVIDIA H100 SXM's data sheet,
at its 700 W limit: 67 TFLOP/s of float32 outside the tensor cores, 3.35
TB/s of HBM3; its special-function lanes (logs, reciprocals, divisions)
are 16 an SM on 132 SMs at the 1980 MHz maximum SM clock."""

from __future__ import annotations

import subprocess

PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "f32_flops": 67e12,
        "hbm_bytes_s": 3.35e12,
        "special_ops_s": 132 * 16 * 1980e6,
    },
}


def peaks(kind: str):
    """The card's peaks, or None for a card the table does not hold."""
    return PEAKS.get(kind)


def least_seconds(work, pk) -> float:
    """The least time for a list of (operations, bytes, special-function
    operations), each item bound by the slowest of its three."""
    return sum(max(f / pk["f32_flops"], b / pk["hbm_bytes_s"],
                   s / pk["special_ops_s"]) for f, b, s in work)


def power_limit() -> str:
    """``nvidia-smi``'s name and power limit of the card, or "" without
    one."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return ""
