from repro_torch.kernels.svm_inner.ops import inner_impl, svm_inner_loop

__all__ = ["inner_impl", "svm_inner_loop"]
