"""Roofline terms of the port (the port of ``repro/roofline/analysis.py``).

Three terms per (arch x shape x mesh) cell, all in seconds:

    compute    = FLOPs per device             / peak FLOP/s of one card
    memory     = HBM bytes per device         / HBM bandwidth of one card
    collective = collective bytes per device  / NVLink bandwidth of one card

``repro`` reads its FLOPs and bytes off a compiled XLA program; the port
counts them on the meta device (``repro_torch.launch.dryrun``), so the
same arithmetic serves both. ``HW_H100`` is the default machine: the
NVIDIA H100 SXM5 80GB data sheet's peaks (bf16 dense on the tensor
cores, HBM3, NVLink 4) and the device memory the card itself reports.

The collective term's bytes are a :class:`CollectiveStats`, ``repro``'s
typed counts and result bytes over its five kinds. ``repro`` parses them
from a compiled program's HLO; the port builds them from what an
``analysis.record.Recorder`` saw of one rank's step
(:func:`collective_stats` of its ``collective_traffic()``; the dry run
runs the step on the meta device inside a process group of the ``fake``
backend, ``launch.dryrun``).

Scoped out: ``HW_V5E`` describes a TPU, and
``collective_stats_from_hlo``, ``collective_bytes_from_hlo`` and
``cost_analysis_dict`` read compiled XLA, which an eager program does not
have.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Mapping, Optional

# repro's five kinds, its CollectiveStats' keys
COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")


@dataclasses.dataclass(frozen=True)
class Hardware:
    name: str
    peak_flops: float        # per chip, FLOP/s
    hbm_bw: float            # per chip, B/s
    ici_bw: float            # per link, B/s (here NVLink, per card)
    hbm_bytes: float         # per chip


# NVIDIA H100 SXM5 data sheet: 989 TFLOP/s bf16 dense, 3.35 TB/s HBM3,
# 900 GB/s NVLink 4; hbm_bytes is ``total_memory`` as the card reports it
# (``torch.cuda.get_device_properties(0)``, an H100 80GB HBM3 at 700 W).
HW_H100 = Hardware(name="h100-sxm5-80gb", peak_flops=989e12, hbm_bw=3.35e12,
                   ici_bw=900e9, hbm_bytes=85_017_493_504)


@dataclasses.dataclass(frozen=True)
class CollectiveStats:
    """Typed per-collective counts and result bytes (``repro``'s), over
    :data:`COLLECTIVES`."""

    counts: Mapping[str, int]
    bytes: Mapping[str, float]

    @property
    def total_bytes(self) -> float:
        return float(sum(self.bytes.values()))

    @property
    def total_count(self) -> int:
        return int(sum(self.counts.values()))


def collective_stats(traffic: Mapping[str, Mapping[str, Mapping]],
                     groups: Optional[Iterable[str]] = None
                     ) -> CollectiveStats:
    """The collectives of ``traffic`` ({group: {kind: {"count", "bytes"}}}:
    ``Recorder.collective_traffic()``, or a dry-run cell's
    ``collectives_by_axis``) summed over the groups ``groups`` (default:
    all), as a :class:`CollectiveStats`: each kind's count and result
    bytes (the ``Recorder``'s convention is ``repro``'s). Kinds outside
    ``repro``'s five (a broadcast, a barrier) are left out."""
    counts = dict.fromkeys(COLLECTIVES, 0)
    bytes_ = dict.fromkeys(COLLECTIVES, 0.0)
    for group in traffic if groups is None else groups:
        for kind, v in traffic.get(group, {}).items():
            if kind in counts:
                counts[kind] += v["count"]
                bytes_[kind] += v["bytes"]
    return CollectiveStats(counts=counts, bytes=bytes_)


def two_point_fit(cost1: float, cost2: float, n1: int, n2: int,
                  n_target: int) -> float:
    """cost(n) = fixed + n * per_unit, fit on (n1, cost1), (n2, cost2)."""
    per = (cost2 - cost1) / max(n2 - n1, 1)
    fixed = cost1 - n1 * per
    return fixed + n_target * per


def roofline_terms(flops_per_dev: float, bytes_per_dev: float,
                   coll_bytes_per_dev: float, hw: Hardware = HW_H100,
                   mac_correction: float = 1.0) -> Dict[str, float]:
    """The three terms (seconds) + the bound classification."""
    compute = flops_per_dev * mac_correction / hw.peak_flops
    memory = bytes_per_dev / hw.hbm_bw
    collective = coll_bytes_per_dev / hw.ici_bw
    dominant = max(("compute", compute), ("memory", memory),
                   ("collective", collective), key=lambda kv: kv[1])[0]
    total = max(compute, memory, collective)
    return {"compute_s": compute, "memory_s": memory,
            "collective_s": collective, "dominant": dominant,
            "bound_s": total,
            "roofline_fraction": compute / total if total > 0 else 0.0}


def model_flops(n_params_active: int, kind: str, tokens: int,
                batch: int = 1) -> float:
    """MODEL_FLOPS: 6*N*D for training (fwd+bwd), 2*N*D for inference.

    decode: D = batch (one token per sequence per step).
    """
    if kind == "train":
        return 6.0 * n_params_active * tokens
    if kind == "prefill":
        return 2.0 * n_params_active * tokens
    return 2.0 * n_params_active * batch        # decode: per step
