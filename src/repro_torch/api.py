"""``repro_torch.api`` — the public surface of the port.

    from repro_torch import api
    res = api.solve(api.LassoProblem(A=A, b=b, lam=lam),
                    api.SolverConfig(block_size=8, s=16, iterations=512))

Sharded over the ranks of a ``torch.distributed`` process group, every
rank making the same call:

    res = api.solve(problem, cfg, backend="sharded")   # default group

Surviving host failures, the same call on every rank (checkpoints at
outer-iteration boundaries, re-grouping over the survivors):

    res = api.solve_elastic(problem, cfg, elastic=api.ElasticConfig(
        checkpoint_dir=d, checkpoint_every=1))
"""
from repro_torch.core.api import (BACKENDS, families, resolve_family, solve,
                                  solve_sharded)
from repro_torch.core.sfista import SFISTAProblem
from repro_torch.core.types import (FAMILIES, KERNELS, KernelSpec,
                                    LassoProblem, LogRegProblem,
                                    ProblemFamily, SolveState, SolverConfig,
                                    SolverResult, SparseOperand, SVMProblem,
                                    build_kernel_params, register_family,
                                    register_kernel)
from repro_torch.runtime.elastic import ElasticConfig, solve_elastic

__all__ = [
    "solve", "solve_sharded", "solve_elastic", "resolve_family",
    "families", "BACKENDS", "ElasticConfig",
    "FAMILIES", "ProblemFamily", "register_family",
    "KERNELS", "KernelSpec", "register_kernel", "build_kernel_params",
    "LassoProblem", "SVMProblem", "LogRegProblem", "SFISTAProblem",
    "SparseOperand",
    "SolverConfig", "SolverResult", "SolveState",
]
