from ctc_pytorch_tpu_torch.parallel.distributed import (  # noqa: F401
    initialize,
    local_rows,
    make_global_batch,
    shard_for_host,
    shutdown,
    spawn_ranks,
)
from ctc_pytorch_tpu_torch.parallel.mesh import (  # noqa: F401
    DataGroup,
    all_max,
    all_sum,
    make_mesh,
    pad_batch_to_devices,
    replicate,
    shard_batch,
)
