"""The float32 matrix-product precision of torch's own products.

``CNMF_TPU_MATMUL_PRECISION`` (the JAX package's knob, cnmf_tpu/ops/nmf.py:44)
picks it when the package is imported:

* ``highest`` (the default): full float32, TF32 off for matmuls and cuDNN;
* ``high``: TF32 in torch's products (cuBLAS and cuDNN);
* ``default``: the cheapest float32 product mode torch offers
  (``torch.set_float32_matmul_precision("medium")``: TF32 in cuBLAS, as
  ``high``; bfloat16 passes on the CPU's oneDNN).

The hand-written kernels of ``csrc/`` multiply in full float32 FFMA under
every value; the JAX package likewise keeps ``high`` at full precision
inside its Pallas kernels (cnmf_tpu/ops/pallas_mu.py:45-56). Only torch's
products (the CD grams, beta=2 MU, the refits' products) follow the
knob.
"""

from __future__ import annotations

import os

import torch

# the JAX package's precision names → torch's float32 matmul modes
TORCH_MODES = {"highest": "highest", "high": "high", "default": "medium"}


def knob_mode() -> str:
    """torch's mode for ``CNMF_TPU_MATMUL_PRECISION`` (default
    ``highest``); an unknown value raises."""
    name = os.environ.get("CNMF_TPU_MATMUL_PRECISION", "highest")
    if name not in TORCH_MODES:
        raise ValueError(f"CNMF_TPU_MATMUL_PRECISION={name!r}: one of "
                         f"{', '.join(TORCH_MODES)}")
    return TORCH_MODES[name]


def set_mode(mode: str) -> None:
    """torch's float32 matmul mode ``mode`` ('highest', 'high' or
    'medium'), which sets TF32 for cuBLAS products off at 'highest' and on
    otherwise, and TF32 for cuDNN to match."""
    torch.set_float32_matmul_precision(mode)
    torch.backends.cudnn.allow_tf32 = mode != "highest"
