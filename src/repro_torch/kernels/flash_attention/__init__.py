from repro_torch.kernels.flash_attention.ops import (attention_chunked,
                                                     flash_attention)

__all__ = ["attention_chunked", "flash_attention"]
