from ubdvss_tpu_torch.parallel.mesh import (
    make_mesh,
    replicate_to_mesh,
    shard_batch_to_mesh,
)

__all__ = ["make_mesh", "replicate_to_mesh", "shard_batch_to_mesh"]
