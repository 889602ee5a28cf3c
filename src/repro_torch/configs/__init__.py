"""Model configs (port of ``repro.configs``, the transformer family) and
the architecture registry."""
from repro_torch.configs.base import EncoderConfig, LMConfig, MLAConfig, MoEConfig
from repro_torch.configs.registry import ASSIGNED, get_arch, get_config, list_archs

__all__ = ["ASSIGNED", "EncoderConfig", "LMConfig", "MLAConfig", "MoEConfig",
           "get_arch", "get_config", "list_archs"]
