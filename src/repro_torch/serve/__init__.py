from repro_torch.serve.batching import ContinuousBatcher, Request

__all__ = ["ContinuousBatcher", "Request"]
