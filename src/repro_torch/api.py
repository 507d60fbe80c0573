"""``repro_torch.api`` — the public surface of the port.

    from repro_torch import api
    res = api.solve(api.LassoProblem(A=A, b=b, lam=lam),
                    api.SolverConfig(block_size=8, s=16, iterations=512))
"""
from repro_torch.core.api import BACKENDS, families, resolve_family, solve
from repro_torch.core.types import (FAMILIES, LassoProblem, ProblemFamily,
                                    SolveState, SolverConfig, SolverResult,
                                    SparseOperand, SVMProblem,
                                    register_family)

__all__ = [
    "solve", "resolve_family", "families", "BACKENDS",
    "FAMILIES", "ProblemFamily", "register_family",
    "LassoProblem", "SVMProblem", "SparseOperand",
    "SolverConfig", "SolverResult", "SolveState",
]
