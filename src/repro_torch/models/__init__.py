"""The models: the paper's ResNet (Task 1) and the dense transformer of
the serving path."""

from repro_torch.models import attention, layers, resnet, transformer

__all__ = ["attention", "layers", "resnet", "transformer"]
