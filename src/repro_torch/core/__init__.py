"""Core of the port: the SA first-order solvers on PyTorch tensors.

    LassoProblem, SolverConfig, SolverResult, SolveState
    FAMILIES / register_family        — the problem-family registry
    solve_lasso                       — lasso dispatch (cfg.s, accelerated)
    bcd_lasso, acc_bcd_lasso, cd_lasso, acc_cd_lasso (classical) and
    sa_bcd_lasso, sa_acc_bcd_lasso, sa_cd_lasso, sa_acc_cd_lasso (SA)
"""
from repro_torch.core.types import (FAMILIES, LassoProblem, ProblemFamily,
                                    SolveState, SolverConfig, SolverResult,
                                    register_family, require_unit_block,
                                    resume_carry)
from repro_torch.core.lasso import (acc_bcd_lasso, acc_cd_lasso, bcd_lasso,
                                    cd_lasso, lasso_objective, solve_lasso)
from repro_torch.core.sa_lasso import (sa_acc_bcd_lasso, sa_acc_cd_lasso,
                                       sa_bcd_lasso, sa_cd_lasso)
from repro_torch.core.engine import FamilyProgram, run_program

__all__ = [
    "FAMILIES", "ProblemFamily", "register_family", "require_unit_block",
    "LassoProblem", "SolverConfig", "SolverResult", "SolveState",
    "resume_carry",
    "acc_bcd_lasso", "acc_cd_lasso", "bcd_lasso", "cd_lasso", "solve_lasso",
    "lasso_objective",
    "sa_acc_bcd_lasso", "sa_acc_cd_lasso", "sa_bcd_lasso", "sa_cd_lasso",
    "FamilyProgram", "run_program",
]
