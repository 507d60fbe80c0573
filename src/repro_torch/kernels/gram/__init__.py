from repro_torch.kernels.gram.ops import gram_and_proj, gram_fused, gram_t

__all__ = ["gram_and_proj", "gram_fused", "gram_t"]
