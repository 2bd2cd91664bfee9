"""The device mesh of the port: restarts × cells over a list of devices in
one process (``mesh``), and the sums and gathers over its shards
(``collectives``)."""

from cnmf_tpu_torch.parallel.mesh import (
    build_mesh,
    pad_to_multiple,
    shard_factorize_inputs,
)
