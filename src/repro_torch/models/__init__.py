"""The models: the paper's ResNet (Task 1), its char-LSTM (Task 2) and
the dense transformer of the serving path."""

from repro_torch.models import attention, layers, lstm, resnet, transformer

__all__ = ["attention", "layers", "lstm", "resnet", "transformer"]
