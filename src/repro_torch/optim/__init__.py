"""The optimizer and gradient compression of the port (``repro.optim``)."""
from repro_torch.optim.adamw import AdamW, AdamWState, cosine_schedule
from repro_torch.optim.compress import (ErrorFeedback, compressed_all_reduce,
                                        dequantize_int8, quantize_int8)

__all__ = ["AdamW", "AdamWState", "cosine_schedule", "quantize_int8",
           "dequantize_int8", "compressed_all_reduce", "ErrorFeedback"]
