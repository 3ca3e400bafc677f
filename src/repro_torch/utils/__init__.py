from repro_torch.utils.device import default_device
from repro_torch.utils.hlo_parse import (collective_breakdown,
                                         collective_bytes_from_hlo)
from repro_torch.utils.tree import (tree_flatten_concat, tree_unflatten_concat,
                                    tree_weighted_mean)
