"""cnmf_tpu_torch — the consensus NMF pipeline of ``cnmf_tpu``, in PyTorch.

A port of the JAX package to PyTorch and CUDA: the same ``cNMF`` stages
(prepare / factorize / combine / consensus), the same run-directory file
contract and the same sklearn solver semantics, with the HALS coordinate
descent half-sweeps and the KL multiplicative-update terms as hand-written
CUDA kernels for Hopper (``ops/cd_kernels.py``, ``ops/mu_kernels.py``,
``csrc/``), and the same ``Preprocess`` (seurat_v3 HVGs, PCA, Harmony batch
correction of the counts). It imports neither jax nor ``cnmf_tpu``.

    from cnmf_tpu_torch import cNMF, Preprocess
    obj = cNMF(output_dir="out", name="run")   # solves on the CUDA card

Every entry point runs on the card unless ``device="cpu"`` is passed; none
falls back to the CPU. The command line is ``cnmf-tpu-torch`` (``python -m
cnmf_tpu_torch.cli``).

Float32 matrix products run in full float32: TF32 is switched off for
matmuls and cuDNN when the package is imported, mirroring the JAX package's
``MATMUL_PRECISION='highest'`` (cnmf_tpu/ops/nmf.py:41-44).

``cNMF``, ``Preprocess`` and the file layer exported beside them (``AnnData``,
``read_h5ad``, ``write_h5ad``, ``save_df_to_npz``, ``save_df_to_text``,
``load_df_from_npz``; pandas, yaml, h5py) load on first use, so ``ops/`` and
``pipeline/stages.py`` import with numpy, scipy and torch only.
"""

import importlib

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

__version__ = "0.1.0"

# name -> the module that defines it, imported on first access
_LAZY = {
    "cNMF": "cnmf_tpu_torch.pipeline.cnmf",
    "Preprocess": "cnmf_tpu_torch.preprocess",
    "AnnData": "cnmf_tpu_torch.io.anndata_lite",
    "read_h5ad": "cnmf_tpu_torch.io.h5ad",
    "write_h5ad": "cnmf_tpu_torch.io.h5ad",
    "save_df_to_npz": "cnmf_tpu_torch.io.dataframe",
    "save_df_to_text": "cnmf_tpu_torch.io.dataframe",
    "load_df_from_npz": "cnmf_tpu_torch.io.dataframe",
}

__all__ = [*_LAZY, "__version__"]


def __getattr__(name):
    if name in _LAZY:
        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
