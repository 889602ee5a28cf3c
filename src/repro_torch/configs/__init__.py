"""Model configs (port of ``repro.configs``, the transformer family)."""
from repro_torch.configs.base import EncoderConfig, LMConfig, MLAConfig, MoEConfig

__all__ = ["EncoderConfig", "LMConfig", "MLAConfig", "MoEConfig"]
