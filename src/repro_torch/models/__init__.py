"""Model zoo of the port: the dense and SSM LM families (port of
``repro/models``)."""
from repro_torch.models.model import Model, build_model, init_params

__all__ = ["Model", "build_model", "init_params"]
