"""Model substrate: the PyTorch twin of ``repro.models`` (every family serves)."""
from .config import MLAConfig, MambaConfig, ModelConfig, MoEConfig, RWKVConfig
from .registry import ModelAPI, get_api, make_smoke_batch, modality_inputs, smoke_config
