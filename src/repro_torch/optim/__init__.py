from repro_torch.optim.optimizers import Optimizer, make_optimizer, sgd
