from repro_torch.checkpoint.io import load_meta, restore, save

__all__ = ["save", "restore", "load_meta"]
