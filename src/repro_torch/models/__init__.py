"""Model architectures of the port: the paper's CNN (``cnn``) and the
decoder-only and encoder-decoder LM assemblies behind ``build_model``."""
from repro_torch.models.model import Model, build_model

__all__ = ["Model", "build_model"]
