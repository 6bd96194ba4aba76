"""Multi-device execution on a single-controller mesh (port of
`liquid_tpu/parallel/`)."""
from liquid_tpu_torch.parallel.dist import (  # noqa: F401
    Mesh, MeshUnsupported, dist_agg_by_key, dist_filter_agg,
    dist_filter_count, dist_lookup_join, dist_shuffle_by_key, make_mesh,
    replicate, shard_rows,
)
