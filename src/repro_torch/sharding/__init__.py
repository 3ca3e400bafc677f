from repro_torch.sharding.specs import (
    P,
    MeshShape,
    batch_pspec,
    cache_pspecs,
    param_pspecs,
    place_tree,
    state_pspecs,
    to_placements,
)
