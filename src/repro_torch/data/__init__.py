from repro_torch.data import cifar10, tokens
