"""Replication check (the port of ``repro/analysis/replication.py``).

The sharded backend declares some outputs replicated: the objective
trace, a row-partitioned family's x, the ``aux_out`` vectors and state
leaves laid out "replicated". Every rank must compute the same value for
each. ``repro`` proves it statically, by a taint analysis of the
shard_map body; eager code has no trace to taint, so the port checks it
by running: every selected family x variant is solved on a TWO-rank gloo
group (``core.distributed.run_ranks``; one spawn for the whole pass, not
one per family), and each declared-replicated output must be bit-equal
on both ranks. A rank-dependent value shows on two ranks, as a
shard-local value left unreduced does.

``repro``'s ``taint_jaxpr`` and ``shard_map_out_taints`` have no
counterpart: there is no jaxpr.
"""
from __future__ import annotations

from typing import Iterable, List, Optional, Sequence, Tuple

import torch

from repro_torch.analysis.common import (Diagnostic, bench_shape,
                                         certification_problem,
                                         family_variants, variant_config)
from repro_torch.core.types import FAMILIES, ProblemFamily

__all__ = ["check_replication", "check_replication_families",
           "replicated_outputs"]

WORLD = 2


def replicated_outputs(fam: ProblemFamily, cfg, res):
    """(name, tensor) of every output the sharded solve declares
    replicated: the objective, x for a row-partitioned family, the
    "replicated" ``aux_out`` vectors and state leaves."""
    outs = [("objective", res.objective)]
    if fam.partition == "row":
        outs.append(("x", res.x))
    outs += [(k, res.aux[k]) for k, lay in fam.aux_out
             if lay == "replicated"]
    if fam.state_layout is not None:
        carry = res.aux["state"].carry
        outs += [(f"state.{k}", carry[k]) for k, lay in fam.state_layout(cfg)
                 if lay == "replicated"]
    return outs


def _bits(t):
    """``t``'s bit pattern as integers (bit-equality: NaN equals NaN)."""
    t = torch.as_tensor(t).reshape(1, -1).contiguous()
    if t.is_floating_point():
        t = t.view({8: torch.int64, 4: torch.int32,
                    2: torch.int16}[t.element_size()])
    return t


def _rank_check(rank: int, world: int, subjects, iterations: int,
                device: str):
    """Every rank: solve each (family, variants) subject and gather each
    declared-replicated output's bits from every rank (rank 0 returns
    the diagnostics)."""
    from repro_torch.core import linalg
    from repro_torch.core.api import solve_sharded
    import torch.distributed as dist
    group = dist.group.WORLD
    diags: List[Diagnostic] = []
    checked: List[str] = []
    for fam, variants in subjects:
        fam = FAMILIES[fam] if isinstance(fam, str) else fam
        m, n = bench_shape(fam)
        for variant in variants:
            where = f"{fam.name}:{variant}"
            checked.append(where)
            cfg = variant_config(fam, variant, iterations=iterations,
                                 device=device)
            problem = certification_problem(fam, m, n, cfg.dtype, device)
            res = solve_sharded(problem, cfg, group, family=fam)
            for name, value in replicated_outputs(fam, cfg, res):
                both = linalg.pgather(_bits(value), group)
                differ = int((both != both[:1]).any(dim=0).sum())
                if differ:
                    diags.append(Diagnostic(
                        "replication", "error", where,
                        f"output {name!r} is declared replicated but "
                        f"{differ} of its {both.shape[1]} element(s) "
                        f"differ between the {world} ranks: it derives "
                        f"from rank-local data never reduced, so ranks "
                        f"silently disagree"))
    return diags, checked


def check_replication_families(
        subjects: Iterable[Tuple[ProblemFamily, Optional[Sequence[str]]]],
        iterations: int = 16, device="cuda"
) -> Tuple[List[Diagnostic], List[str]]:
    """The replication check of several (family, variants) subjects in
    ONE two-rank gloo job on ``device`` (variants None: all of the
    family's). A registered family travels to the ranks by name, another
    by pickle (its callables must be importable module-level names)."""
    from repro_torch.core.distributed import run_ranks
    payload = []
    for fam, variants in subjects:
        ref = fam.name if FAMILIES.get(fam.name) is fam else fam
        payload.append((ref, tuple(variants or family_variants(fam))))
    if not payload:
        return [], []
    return run_ranks(_rank_check, WORLD, backend="gloo", device=str(device),
                     args=(tuple(payload), iterations, str(device)))


def check_replication(fam: ProblemFamily,
                      variants: Optional[Tuple[str, ...]] = None,
                      iterations: int = 16, device="cuda"
                      ) -> Tuple[List[Diagnostic], List[str]]:
    """The replication check of every registered variant of ``fam``."""
    return check_replication_families([(fam, variants)], iterations,
                                      device)
