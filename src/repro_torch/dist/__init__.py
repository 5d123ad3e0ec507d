"""The serving steps of the reference's ``repro.dist`` on one device."""

from repro_torch.dist import step

__all__ = ["step"]
