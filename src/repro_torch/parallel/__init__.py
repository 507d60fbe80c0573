from repro_torch.parallel import tensor
from repro_torch.parallel.sharding import (P, PartitionSpec, activation_spec,
                                           batch_partition_specs, dp_axes,
                                           get_abstract_mesh, named_shardings,
                                           param_partition_specs, placements,
                                           sanitize_spec, shard_shape)

__all__ = ["P", "PartitionSpec", "activation_spec", "batch_partition_specs",
           "dp_axes", "get_abstract_mesh", "named_shardings",
           "param_partition_specs", "placements", "sanitize_spec",
           "shard_shape", "tensor"]
