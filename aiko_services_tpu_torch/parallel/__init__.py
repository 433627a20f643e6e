from .mesh import (                                           # noqa: F401
    MESH_AXIS_ORDER, Mesh, NamedSharding, PartitionSpec, Sharded,
    ambient_mesh, assign, create_mesh, default_devices, filter_specs,
    get_mesh, layout_matches, leaf_layout, named_sharding, partition_spec,
    set_default_devices, shard_pytree, sharded_leaves, spec_layout,
    tree_shardings, unshard, use_mesh)
from .attention import (                                      # noqa: F401
    attention_reference, flash_attention, flash_attention_forward,
    flash_attention_plain, flash_attention_backward,
    flash_attention_backward_plain, ring_attention, ring_attention_grid,
    sp_decode_attention, sp_decode_grid, ulysses_attention,
    ulysses_attention_grid)
from .collectives import (                                    # noqa: F401
    all_gather, all_to_all, axis_index, begin_backward, collective_counts,
    collective_totals, conform, join_backward, map_shards, pmax, ppermute,
    psum, psum_scatter, reset_collective_counts, reshard, staged_bytes,
    wire_copy_bytes)
from .distributed import (                                    # noqa: F401
    global_mesh, initialize_distributed, is_distributed, process_card,
    process_count, process_index, shutdown_distributed)
