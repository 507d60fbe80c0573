#!/usr/bin/env python3
"""How far hymba-1.5b's bf16 training drifts over the model axis, beside
how far one rank drifts from itself when only its summation order
changes: hymba's widths (d 1600, 25 / 5 heads of 64 in a window of 1024,
25 SSM heads, d_ff 5,504, vocabulary 32,001, 128 meta rows) at 2 layers,
bf16, on the CPU, from the weights of seed 0 and the same batches.

    PYTHONPATH=src python3 tools/hymba_drift.py [--steps 4] [--seq 512]

Runs, each ``--steps`` steps of ``cosine_schedule(3e-4, 2, 8)`` at global
batch 2 (phase 21 (e)'s schedule and batch):

  one      one rank, 2 microbatches of 1 (phase 21 (e)'s reference)
  one_k1   one rank, 1 microbatch of 2: the same function, the gradient
           summed in another order
  m2       two gloo ranks, model axis 2, 2 microbatches, ``shard_acts``
           (phase 21 (e)'s split: attention and SSM by flat columns)
  f32      one rank, 2 microbatches, the same model at f32

and prints each run's losses, the relative drift of ``one_k1`` and of
``m2`` from ``one`` at each step, and of each bf16 run from ``f32``,
against phase 21's bf16 bar of 5e-3. If the split drifts further from
one rank than one rank does from itself, the split is at fault.
"""
import argparse
import dataclasses
import json
import sys
import tempfile
import time

import torch

BAR = 5e-3


def _arch(dtype):
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("hymba-1.5b"), n_layers=2,
                               dtype=dtype)


def _losses(dtype, steps, seq, k=2, m=1, group=None):
    from repro_torch.data import TokenPipeline
    from repro_torch.optim import AdamW, cosine_schedule
    from repro_torch.runtime.driver import Trainer, TrainerConfig
    arch = _arch(dtype)
    with tempfile.TemporaryDirectory() as tmp:
        tr = Trainer(arch, AdamW(learning_rate=cosine_schedule(3e-4, 2, 8)),
                     TokenPipeline(arch.vocab_size, 2, seq, seed=0),
                     TrainerConfig(steps=steps, ckpt_dir=tmp,
                                   ckpt_every=steps + 1, microbatches=k,
                                   model_axis=m, shard_acts=m > 1),
                     group=group, device="cpu")
        tr._save = lambda: None
        return tr.run()["losses"]


def _rank(rank, world, steps, seq, threads):
    import torch.distributed as dist
    torch.set_num_threads(threads)
    return _losses("bfloat16", steps, seq, m=2, group=dist.group.WORLD)


def _drift(got, want):
    return [abs(a - b) / abs(b) for a, b in zip(got, want)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args(argv)
    from repro_torch.core import distributed
    torch.set_num_threads(args.threads)
    runs = {}
    for name, kw in (("one", {}), ("one_k1", {"k": 1}),
                     ("f32", {"dtype": "float32"})):
        t0 = time.perf_counter()
        runs[name] = _losses(kw.pop("dtype", "bfloat16"), args.steps,
                             args.seq, **kw)
        print(f"{name}: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    runs["m2"] = distributed.run_ranks(
        _rank, 2, "gloo", device="cpu",
        args=(args.steps, args.seq, max(1, args.threads // 2)))
    print(f"m2: {time.perf_counter() - t0:.1f} s", flush=True)
    report = {"steps": args.steps, "seq": args.seq, "losses": runs,
              "drift_from_one": {n: _drift(runs[n], runs["one"])
                                 for n in ("one_k1", "m2")},
              "drift_from_f32": {n: _drift(runs[n], runs["f32"])
                                 for n in ("one", "one_k1", "m2")}}
    for part in ("drift_from_one", "drift_from_f32"):
        for n, d in report[part].items():
            print(f"{part} {n}: " + " ".join(f"{x:.3e}" for x in d)
                  + f" (max {max(d):.3e}, bar {BAR})")
    split, order = (max(report["drift_from_one"][n])
                    for n in ("m2", "one_k1"))
    print(f"split {split:.3e} against one rank's own reordering "
          f"{order:.3e}: " + ("the split drifts further" if split > order
                              else "within one rank's own drift"))
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
