"""Training launcher of the port (the port of ``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
        --smoke --steps 50 --ckpt-dir ckpt [--device cpu]

``repro``'s flags, plus ``--device`` (``cuda`` by default: the kernels;
``cpu``: the plain versions). ``--smoke`` picks the reduced same-family
config. The trainer (``repro_torch.runtime.driver``) provides
checkpointing, failure handling and re-grouping over the survivors. Its
hosts are the ranks of the default process group: under
``python -m torch.distributed.run --standalone --nproc-per-node P`` the P
ranks train data parallel, each holding its shards of the weights and the
AdamW state (FSDP, ``repro_torch.parallel.fsdp``, as ``repro``'s trainer
shards over 'data'); run plainly, a group of one rank is made here
(NCCL on the card, gloo on the CPU), so each step still makes its one
gradient reduction. ``--model-axis m`` splits the ranks into ``repro``'s
(data, model) grid, m ranks a model group (tensor, expert and sequence
parallelism, ``repro_torch.parallel.tensor``): run it under torchrun with
a world size that m divides; one process with m > 1 raises ``repro``'s
"no usable device configuration".
"""
from __future__ import annotations

import argparse

import torch.distributed as dist

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import distributed
from repro_torch.data.tokens import TokenPipeline
from repro_torch.optim.adamw import AdamW, cosine_schedule
from repro_torch.runtime.driver import Trainer, TrainerConfig, check_config


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=10)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--model-axis", type=int, default=1)
    ap.add_argument("--remat", default="none")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (repro_ckpt in the temporary "
                         "directory by default)")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (the plain versions)")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    kw = {} if args.ckpt_dir is None else {"ckpt_dir": args.ckpt_dir}
    cfg = TrainerConfig(steps=args.steps, ckpt_every=args.ckpt_every,
                        microbatches=args.microbatches, remat=args.remat,
                        model_axis=args.model_axis, seed=args.seed, **kw)
    check_config(cfg)
    arch = get_smoke_config(args.arch) if args.smoke \
        else get_config(args.arch)
    pipeline = TokenPipeline(vocab_size=arch.vocab_size,
                             global_batch=args.global_batch,
                             seq_len=args.seq_len, seed=args.seed)
    optimizer = AdamW(learning_rate=cosine_schedule(
        args.lr, args.warmup, args.steps))
    with distributed.join_hosts(args.device):
        trainer = Trainer(arch, optimizer, pipeline, cfg,
                          group=dist.group.WORLD, device=args.device)
        out = trainer.run()
        if out["lost"] or dist.get_rank() != trainer.live[0]:
            return
    losses = out["losses"]
    print(f"arch={arch.name} steps={out['final_step']} "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    for e in out["events"]:
        print("event:", e)


if __name__ == "__main__":
    main()
