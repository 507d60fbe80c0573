"""Silent f64 -> f32 narrowing detection (the port of
``repro/analysis/dtypes.py``).

The numerical claims of the paper (machine-precision agreement of the
s-step recurrences with the classical iterates) mean something only if a
float64 experiment runs in float64 end to end. In eager PyTorch that
breaks silently where a tensor is made without a dtype (``torch.zeros``
defaults to float32), where a float64 value is copied into a float32
buffer, or where a kernel computes in f32 whatever it is given (K1's
3xTF32 ``wgmma`` body).

This pass runs each family x variant's sharded solve at float64 under a
narrowing :class:`~repro_torch.analysis.record.Recorder` and reports:

  * every dispatched operation that reads a float64 tensor and yields a
    float32, float16 or bfloat16 one (``_to_copy``, ``copy_`` into a
    narrower buffer, ...), inside a kernel's plain version too;
  * every kernel seam whose float64 call returns another type, or takes
    a body that computes in f32,

each with the Python source line that made it (``file:line``).
"""
from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import torch

from repro_torch.analysis.collectives import recorded_solve
from repro_torch.analysis.common import (Diagnostic, bench_shape,
                                         certification_problem,
                                         family_variants, one_rank_group,
                                         variant_config)
from repro_torch.analysis.record import Recorder
from repro_torch.core.types import ProblemFamily

__all__ = ["find_float_narrowing", "check_dtypes"]


def find_float_narrowing(fn: Callable, *args, **kwargs
                         ) -> List[Tuple[str, str, str]]:
    """Run ``fn(*args, **kwargs)`` under a narrowing recorder: every
    float narrowing it made, as (src dtype, dst dtype, "what at
    file:line")."""
    rec = Recorder(narrowing=True)
    with rec:
        fn(*args, **kwargs)
    return [(src, dst, f"{what} at {line}")
            for src, dst, what, line in rec.narrowing]


def check_dtypes(fam: ProblemFamily,
                 variants: Optional[Tuple[str, ...]] = None,
                 iterations: int = 16, device="cuda"
                 ) -> Tuple[List[Diagnostic], List[str]]:
    """Solve each variant at float64 on ``device`` and flag every silent
    float narrowing."""
    diags: List[Diagnostic] = []
    checked: List[str] = []
    m, n = bench_shape(fam)
    with one_rank_group(device):
        for variant in variants or family_variants(fam):
            where = f"{fam.name}:{variant}"
            checked.append(where)
            cfg = variant_config(fam, variant, iterations=iterations,
                                 device=device, dtype=torch.float64)
            problem = certification_problem(fam, m, n, torch.float64,
                                            device)
            rec = recorded_solve(fam, cfg, problem, narrowing=True)
            seen = set()
            for src, dst, what, line in rec.narrowing:
                if (what, line) in seen:
                    continue
                seen.add((what, line))
                diags.append(Diagnostic(
                    "dtypes", "error", where,
                    f"silent {src} -> {dst} downcast at {line} ({what}): "
                    f"a float64 solve loses precision there — thread the "
                    f"dtype through instead"))
    return diags, checked
