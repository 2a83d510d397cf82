from repro_torch.configs.base import GAConfig

__all__ = ["GAConfig"]
