from repro_torch.kernels.sa_inner.ops import inner_impl, sa_inner_loop

__all__ = ["inner_impl", "sa_inner_loop"]
