"""The models: the paper's ResNet (Task 1), its char-LSTM (Task 2) and
the transformer families of the serving path (dense, moe, vlm, audio,
hybrid RG-LRU, Mamba-2 ssm)."""

from repro_torch.models import attention, layers, lstm, moe, resnet, rglru, ssm, transformer

__all__ = ["attention", "layers", "lstm", "moe", "resnet", "rglru", "ssm", "transformer"]
