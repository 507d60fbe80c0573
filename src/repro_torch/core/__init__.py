"""Core of the port: the SA first-order solvers on PyTorch tensors.

    LassoProblem, SVMProblem, SparseOperand, SolverConfig, SolverResult,
    SolveState
    FAMILIES / register_family        — the problem-family registry
    solve_lasso                       — lasso dispatch (cfg.s, accelerated)
    bcd_lasso, acc_bcd_lasso, cd_lasso, acc_cd_lasso (classical) and
    sa_bcd_lasso, sa_acc_bcd_lasso, sa_cd_lasso, sa_acc_cd_lasso (SA)
    solve_svm                         — SVM dispatch (kernel, cfg.s)
    bdcd_svm, dcd_svm (classical) and sa_bdcd_svm, sa_svm (SA);
    primal_objective, dual_objective, duality_gap
    KERNELS / register_kernel         — the SVM kernel registry
    solve_ksvm, kbdcd_svm, sa_kbdcd_svm, kernel_dual_objective
                                      — kernel SVM (K-BDCD, SA-K-BDCD)
    LogRegProblem, solve_logreg, bcd_logreg, sa_bcd_logreg,
    logreg_objective                  — logistic regression
    SFISTAProblem, solve_sfista, sfista, ca_sfista, sfista_objective
                                      — sampled FISTA and CA-SFISTA
    solve_lasso_sharded, solve_svm_sharded
                                      — the sharded Lasso and SVM shims
"""
from repro_torch.core.types import (FAMILIES, KERNELS, KernelSpec,
                                    LassoProblem, LogRegProblem,
                                    ProblemFamily, SolveState, SolverConfig,
                                    SolverResult, SparseOperand, SVMProblem,
                                    build_kernel_params, operand_matvec,
                                    operand_rmatvec, register_family,
                                    register_kernel, require_unit_block,
                                    resume_carry)
from repro_torch.core.lasso import (acc_bcd_lasso, acc_cd_lasso, bcd_lasso,
                                    cd_lasso, lasso_objective, solve_lasso)
from repro_torch.core.sa_lasso import (sa_acc_bcd_lasso, sa_acc_cd_lasso,
                                       sa_bcd_lasso, sa_cd_lasso)
from repro_torch.core.svm import (bdcd_svm, dcd_svm, dual_objective,
                                  duality_gap, primal_objective, solve_svm)
from repro_torch.core.sa_svm import sa_bdcd_svm, sa_svm
from repro_torch.core.kernel_svm import (kbdcd_svm, kernel_dual_objective,
                                         sa_kbdcd_svm, solve_ksvm)
from repro_torch.core.logreg import (bcd_logreg, logreg_objective,
                                     solve_logreg)
from repro_torch.core.sa_logreg import sa_bcd_logreg
from repro_torch.core.sfista import (SFISTAProblem, ca_sfista, sfista,
                                     sfista_objective, solve_sfista)
from repro_torch.core.engine import FamilyProgram, run_program
from repro_torch.core.distributed import (solve_lasso_sharded,
                                          solve_svm_sharded)

__all__ = [
    "FAMILIES", "ProblemFamily", "register_family", "require_unit_block",
    "KERNELS", "KernelSpec", "register_kernel", "build_kernel_params",
    "LassoProblem", "SVMProblem", "LogRegProblem", "SFISTAProblem",
    "SparseOperand", "SolverConfig",
    "SolverResult", "SolveState", "resume_carry",
    "operand_matvec", "operand_rmatvec",
    "acc_bcd_lasso", "acc_cd_lasso", "bcd_lasso", "cd_lasso", "solve_lasso",
    "lasso_objective",
    "sa_acc_bcd_lasso", "sa_acc_cd_lasso", "sa_bcd_lasso", "sa_cd_lasso",
    "bdcd_svm", "dcd_svm", "solve_svm", "sa_bdcd_svm", "sa_svm",
    "primal_objective", "dual_objective", "duality_gap",
    "solve_ksvm", "kbdcd_svm", "sa_kbdcd_svm", "kernel_dual_objective",
    "solve_logreg", "bcd_logreg", "sa_bcd_logreg", "logreg_objective",
    "solve_sfista", "sfista", "ca_sfista", "sfista_objective",
    "FamilyProgram", "run_program",
    "solve_lasso_sharded", "solve_svm_sharded",
]
