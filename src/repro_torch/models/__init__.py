"""Model substrate: the PyTorch twin of ``repro.models`` (dense family so far)."""
from .config import MLAConfig, MambaConfig, ModelConfig, MoEConfig, RWKVConfig
from .registry import ModelAPI, get_api, make_smoke_batch, smoke_config
