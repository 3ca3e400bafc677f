from repro_torch.data import cifar10
