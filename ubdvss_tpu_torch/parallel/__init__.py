from ubdvss_tpu_torch.parallel.mesh import (
    entry_rows,
    make_mesh,
    reduce_to_first,
    replicate_params,
    replicate_to_mesh,
    shard_batch_to_mesh,
)

__all__ = ["entry_rows", "make_mesh", "reduce_to_first", "replicate_params", "replicate_to_mesh",
           "shard_batch_to_mesh"]
