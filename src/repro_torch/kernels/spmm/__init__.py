from repro_torch.kernels.spmm.ops import (ell_spmm, scatter_add,
                                          scatter_dense, scatter_dense_into,
                                          scatter_steps, spmm_impl)

__all__ = ["ell_spmm", "scatter_add", "scatter_dense", "scatter_dense_into",
           "scatter_steps", "spmm_impl"]
