from ensemble_svs_with_interactions_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    batch_sharding,
    make_mesh,
    maybe_initialize_distributed,
    replicate,
    replicate_tree,
    shard_batch,
)
