"""The elastic runtime (the port of ``repro.runtime``'s elastic part):
:func:`solve_elastic` / :class:`ElasticConfig`, with the
:class:`FailureInjector` and :class:`StragglerMonitor` it consults.

``repro.runtime``'s ``Trainer`` / ``TrainerConfig`` (``driver.py``, the LM
training loop) are not ported yet: they come with LM training. Its
``build_1d_mesh`` has no counterpart: after a failure the survivors form
a process group (``repro_torch.core.distributed.survivor_group``).
"""
from repro_torch.runtime.elastic import ElasticConfig, solve_elastic
from repro_torch.runtime.failures import FailureInjector
from repro_torch.runtime.stragglers import StragglerMonitor

__all__ = ["ElasticConfig", "solve_elastic", "FailureInjector",
           "StragglerMonitor"]
