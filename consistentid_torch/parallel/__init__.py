"""Data and tensor parallelism on torch.distributed (the JAX package's
parallel/): ranks and the (data, model) mesh, the split rules of the UNet
and the Llama decoder, and a single-host launcher."""
from .launch import free_port, launch
from .mesh import (DATA_AXIS, MODEL_AXIS, Mesh, all_gather_cat,
                   all_reduce_max, all_reduce_mean, all_reduce_sum,
                   broadcast_object, data_axis_size, default_backend,
                   initialize_multihost, make_mesh, model_axis_size,
                   rank_device, shard_batch, shard_rows, world_size)
from .tensor_parallel import (apply_llama_tensor_parallel,
                              apply_tensor_parallel, llama_split_plan,
                              tensor_parallel_unet, unet_split_plan)
