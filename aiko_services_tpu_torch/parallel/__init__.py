from .mesh import (                                           # noqa: F401
    MESH_AXIS_ORDER, Mesh, NamedSharding, PartitionSpec, ambient_mesh,
    create_mesh, default_devices, filter_specs, get_mesh, named_sharding,
    partition_spec, set_default_devices, shard_pytree, tree_shardings,
    use_mesh)
from .attention import (                                      # noqa: F401
    attention_reference, flash_attention, flash_attention_forward,
    flash_attention_plain, flash_attention_backward,
    flash_attention_backward_plain, ring_attention, sp_decode_attention,
    ulysses_attention)
