from repro_torch.optim.optimizers import (
    Optimizer,
    adafactor,
    adamw,
    make_optimizer,
    sgd,
)
from repro_torch.optim.schedule import cosine_schedule, linear_warmup_cosine
