"""Stub problem families for tests/test_torch_analysis.py: each breaks
ONE static contract of ``repro_torch.analysis`` (or none).

A module of its own, importing no JAX: the replication pass's two gloo
ranks unpickle these families by reference, so they import this module
(the spawned ranks inherit the test process's ``sys.path``). Every solve
is a row-partitioned gradient descent on a LassoProblem whose outer
iterations are marked for the recorder (``seams.outer_loop``).
"""
import dataclasses

import torch

from repro_torch import seams
from repro_torch.core import linalg
from repro_torch.core.types import (LassoProblem, ProblemFamily,
                                    SolverResult, SparseOperand)


def _descend(problem, cfg, group, grad, steps=None):
    A = problem.A.todense() if isinstance(problem.A, SparseOperand) \
        else problem.A
    x = torch.zeros(A.shape[1], dtype=cfg.dtype, device=A.device)
    objs = []
    for _ in seams.outer_loop(range(steps or cfg.outer_iterations)):
        x = x - 0.01 * grad(A, problem.b, x, group)
        objs.append(torch.zeros((), dtype=cfg.dtype, device=A.device))
    return SolverResult(x=x, objective=torch.stack(objs))


def good_grad(A, b, x, group):
    """The one all-reduce of an outer iteration."""
    return linalg.preduce(A.T @ (A @ x - b), group)


def solve_good(problem, cfg, x0=None, state=None, group=None):
    return _descend(problem, cfg, group, good_grad)


def solve_two_preduce(problem, cfg, x0=None, state=None, group=None):
    """A second all-reduce in every outer iteration."""
    def grad(A, b, x, group):
        g = good_grad(A, b, x, group)
        return g + linalg.preduce(torch.sum(g), group)
    return _descend(problem, cfg, group, grad)


def solve_divergent(problem, cfg, x0=None, state=None, group=None):
    """x (declared replicated) takes a rank-local term that is never
    reduced: the sum of this rank's rows."""
    def grad(A, b, x, group):
        return good_grad(A, b, x, group) + 1e-3 * torch.sum(A)
    return _descend(problem, cfg, group, grad)


def solve_downcast(problem, cfg, x0=None, state=None, group=None):
    """The products run in float32 whatever the solve's dtype."""
    def grad(A, b, x, group):
        f32 = torch.float32
        g = A.to(f32).T @ (A.to(f32) @ x.to(f32) - b.to(f32))  # NARROW
        return linalg.preduce(g.to(x.dtype), group)
    return _descend(problem, cfg, group, grad)


def solve_per_inner(problem, cfg, x0=None, state=None, group=None):
    """One all-reduce per INNER iteration: the solve ignores s."""
    return _descend(problem, cfg, group, good_grad, steps=cfg.iterations)


def stub(solve, name, variants=("classical",)):
    return ProblemFamily(
        name=name, problem_cls=LassoProblem, solve=solve,
        variants={v: "" for v in variants}, partition="row",
        default_axes="data", bench_problem_kwargs={"lam": 0.1})


GOOD = stub(solve_good, "stub_good")
TWO_PREDUCE = stub(solve_two_preduce, "stub_two_preduce")
DIVERGENT = stub(solve_divergent, "stub_divergent")
DOWNCAST = stub(solve_downcast, "stub_downcast")
SA_GOOD = stub(solve_good, "stub_sa", variants=("sa",))
SA_PER_INNER = stub(solve_per_inner, "stub_sa_per_inner", variants=("sa",))


def with_costs(fam, costs):
    return dataclasses.replace(fam, costs=costs)
