"""PyTorch/CUDA port of the synchronization-avoiding (SA) first-order
solvers (Devarakonda et al., 2017), for an NVIDIA H100.

The package mirrors ``repro``'s layout module for module; its entry
points run on the card unless the caller asks for the CPU
(``SolverConfig(device="cpu")``). On a CUDA tensor the hot spots go
through the hand-written kernels under ``repro_torch.kernels``; on a CPU
tensor their plain PyTorch versions run.

    from repro_torch import api
    res = api.solve(api.LassoProblem(A=A, b=b, lam=lam),
                    api.SolverConfig(block_size=8, s=16, iterations=512))
"""
