from cnmf_tpu_torch.ops.nmf import (
    nmf_coordinate_descent,
    nmf_multiplicative_update,
    nnls_coordinate_descent,
    nnls_multiplicative_update,
    frobenius_error,
)
from cnmf_tpu_torch.ops.init import random_init_batch, nndsvd_init, nnls_w_init
