from repro_torch.data import partition, pipeline, synthetic

__all__ = ["partition", "pipeline", "synthetic"]
