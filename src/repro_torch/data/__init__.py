"""Data of the port: the synthetic solver datasets (``data.sparse``) and
the LM token pipeline (``data.tokens``)."""
from repro_torch.data.tokens import TokenPipeline, TokenPipelineState

__all__ = ["TokenPipeline", "TokenPipelineState"]
