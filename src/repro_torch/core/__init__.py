"""Core of the port: the SA first-order solvers on PyTorch tensors.

    LassoProblem, SVMProblem, SparseOperand, SolverConfig, SolverResult,
    SolveState
    FAMILIES / register_family        — the problem-family registry
    solve_lasso                       — lasso dispatch (cfg.s, accelerated)
    bcd_lasso, acc_bcd_lasso, cd_lasso, acc_cd_lasso (classical) and
    sa_bcd_lasso, sa_acc_bcd_lasso, sa_cd_lasso, sa_acc_cd_lasso (SA)
    solve_svm                         — linear SVM dispatch (cfg.s)
    bdcd_svm, dcd_svm (classical) and sa_bdcd_svm, sa_svm (SA);
    primal_objective, dual_objective, duality_gap
"""
from repro_torch.core.types import (FAMILIES, LassoProblem, ProblemFamily,
                                    SolveState, SolverConfig, SolverResult,
                                    SparseOperand, SVMProblem,
                                    operand_matvec, operand_rmatvec,
                                    register_family, require_unit_block,
                                    resume_carry)
from repro_torch.core.lasso import (acc_bcd_lasso, acc_cd_lasso, bcd_lasso,
                                    cd_lasso, lasso_objective, solve_lasso)
from repro_torch.core.sa_lasso import (sa_acc_bcd_lasso, sa_acc_cd_lasso,
                                       sa_bcd_lasso, sa_cd_lasso)
from repro_torch.core.svm import (bdcd_svm, dcd_svm, dual_objective,
                                  duality_gap, primal_objective, solve_svm)
from repro_torch.core.sa_svm import sa_bdcd_svm, sa_svm
from repro_torch.core.engine import FamilyProgram, run_program

__all__ = [
    "FAMILIES", "ProblemFamily", "register_family", "require_unit_block",
    "LassoProblem", "SVMProblem", "SparseOperand", "SolverConfig",
    "SolverResult", "SolveState", "resume_carry",
    "operand_matvec", "operand_rmatvec",
    "acc_bcd_lasso", "acc_cd_lasso", "bcd_lasso", "cd_lasso", "solve_lasso",
    "lasso_objective",
    "sa_acc_bcd_lasso", "sa_acc_cd_lasso", "sa_bcd_lasso", "sa_cd_lasso",
    "bdcd_svm", "dcd_svm", "solve_svm", "sa_bdcd_svm", "sa_svm",
    "primal_objective", "dual_objective", "duality_gap",
    "FamilyProgram", "run_program",
]
