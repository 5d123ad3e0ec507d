from repro_torch.optim import adamw, sgd

__all__ = ["adamw", "sgd"]
