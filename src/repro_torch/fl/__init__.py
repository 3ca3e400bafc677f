from repro_torch.fl.partition import (dirichlet_partition, iid_partition,
                                      scenario_partition)
from repro_torch.fl.server import (EXAMPLE_PARTICIPATING_USERS, DTWNSystem,
                                   FLConfig, example_association)
