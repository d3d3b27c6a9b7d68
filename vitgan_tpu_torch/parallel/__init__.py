from vitgan_tpu_torch.parallel.mesh import (  # noqa: F401
    batch_rows,
    initialize_distributed,
    local_batch_size,
    make_mesh,
    shard_batch,
)
from vitgan_tpu_torch.parallel.sharding import shard_train_state  # noqa: F401
