from beso_tpu_torch.parallel.mesh import (
    all_reduce_grads,
    data_axes,
    data_index,
    data_rows,
    gather_full,
    init_distributed,
    make_mesh,
    make_multislice_mesh,
    partition_batch,
    partition_params,
    replicate,
    tp_param_spec,
)

__all__ = ["all_reduce_grads", "data_axes", "data_index", "data_rows", "gather_full",
           "init_distributed", "make_mesh", "make_multislice_mesh", "partition_batch",
           "partition_params", "replicate", "tp_param_spec"]
