"""The runtime of the port (``repro.runtime``): the LM trainer
(:class:`Trainer` / :class:`TrainerConfig`, ``driver.py``: one gradient
reduction per step, checkpoints, failures and re-grouping over the
survivors), the elastic sharded solve (:func:`solve_elastic` /
:class:`ElasticConfig`), and the :class:`FailureInjector` and
:class:`StragglerMonitor` both consult.

``repro.runtime``'s ``build_1d_mesh`` has no counterpart: after a failure
the survivors form a process group
(``repro_torch.core.distributed.survivor_group``).
"""
from repro_torch.runtime.driver import Trainer, TrainerConfig
from repro_torch.runtime.elastic import ElasticConfig, solve_elastic
from repro_torch.runtime.failures import FailureInjector
from repro_torch.runtime.stragglers import StragglerMonitor

__all__ = ["Trainer", "TrainerConfig", "ElasticConfig", "solve_elastic",
           "FailureInjector", "StragglerMonitor"]
