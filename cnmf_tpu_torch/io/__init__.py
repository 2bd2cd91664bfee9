from cnmf_tpu_torch.io.dataframe import save_df_to_npz, save_df_to_text, load_df_from_npz
from cnmf_tpu_torch.io.anndata_lite import AnnData
from cnmf_tpu_torch.io.h5ad import read_h5ad, write_h5ad
from cnmf_tpu_torch.io.tenx import read_10x_mtx
from cnmf_tpu_torch.io.loaders import load_counts
