"""Hand-written CUDA kernels for Hopper (``sm_90a``), one per TPU kernel
on the ported path.

Each kernel subpackage follows ``repro.kernels``' convention:
    ops.py — the wrapper: checks, allocation, launch, launch counter
    ref.py — the plain PyTorch version (used for CPU tensors and as the
             oracle on the card)
and the CUDA sources live in ``csrc/``, built by ``_build``.

Kernels:
    gram     — fused Gram + projection  Y^T [Y | V]   (K1)
    sa_inner — the Lasso s-step SA inner loop, one block (K2, with the
               K0 power iteration as a device function)
    spmm     — blocked-ELL sparse x dense product  S @ D   (K4)
    svm_inner — the SVM s-step inner loop, one block (K3, reusing K0)
"""
KERNEL_PACKAGES = ("gram", "sa_inner", "spmm", "svm_inner")

__all__ = ["KERNEL_PACKAGES"]
