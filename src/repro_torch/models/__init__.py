"""PyTorch model code of the port: dense GQA decoders (``attn_mlp``)."""
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import Model

__all__ = ["Model", "ModelConfig"]
