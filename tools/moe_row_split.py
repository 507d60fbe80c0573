#!/usr/bin/env python3
"""granite-moe-1b-a400m's smoke config at f32 trained 3 steps on a
(data 2, model 2) grid in 2 microbatches of the global batch 4: the port
(four gloo ranks on the CPU, from the ``src`` tree given) against
``repro``'s ``Trainer`` on four forced host devices, from the same
weights. Prints each rank's losses and their largest relative error
against ``repro``'s.

    python3 tools/moe_row_split.py [--src DIR]

``--src``: the ``src`` directory whose ``repro_torch`` trains (this
checkout's by default; another tree's, such as a parent commit unpacked
with ``git archive``, to read its row split). ``repro`` always comes from
this checkout. An MoE routes each microbatch's tokens as one group, so
the error shows whether the port's microbatch j holds ``repro``'s rows.
"""
import argparse
import os
import subprocess
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GB, SEQ, STEPS, K = 4, 32, 3, 2

REF = r'''
import dataclasses, sys
import jax
import numpy as np
from repro.configs import get_smoke_config
from repro.data.tokens import TokenPipeline
from repro.models import lm
from repro.optim.adamw import AdamW, cosine_schedule
from repro.runtime.driver import Trainer, TrainerConfig
tmp, GB, SEQ, STEPS, K = sys.argv[1], *map(int, sys.argv[2:])
arch = dataclasses.replace(get_smoke_config("granite-moe-1b-a400m"),
                           dtype="float32")


def flat(t, p=""):
    if isinstance(t, dict):
        for k, v in t.items():
            yield from flat(v, f"{p}/{k}" if p else k)
    else:
        yield p, np.asarray(t)


np.savez(f"{tmp}/tree.npz", **dict(flat(lm.init_params(arch,
                                                       jax.random.key(0)))))
tr = Trainer(arch, AdamW(learning_rate=cosine_schedule(1e-3, 1, STEPS)),
             TokenPipeline(arch.vocab_size, GB, SEQ),
             TrainerConfig(steps=STEPS, ckpt_dir=f"{tmp}/ref", ckpt_every=2,
                           model_axis=2, microbatches=K))
np.save(f"{tmp}/ref.npy", np.asarray(tr.run()["losses"]))
'''


def _rank(rank, world, tmp, tree):
    import dataclasses
    import torch
    import torch.distributed as dist
    from repro_torch import convert
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import TokenPipeline
    from repro_torch.optim import AdamW, cosine_schedule
    from repro_torch.runtime import Trainer, TrainerConfig
    torch.set_num_threads(1)
    arch = dataclasses.replace(get_smoke_config("granite-moe-1b-a400m"),
                               dtype="float32")
    tr = Trainer(arch, AdamW(learning_rate=cosine_schedule(1e-3, 1, STEPS)),
                 TokenPipeline(arch.vocab_size, GB, SEQ),
                 TrainerConfig(steps=STEPS, ckpt_dir=f"{tmp}/port{rank}",
                               ckpt_every=2, model_axis=2, microbatches=K),
                 group=dist.group.WORLD, device="cpu",
                 model=convert.lm_params_from_numpy(arch, tree, "cpu"))
    np.save(f"{tmp}/port{rank}.npy", np.asarray(tr.run()["losses"]))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    src = os.path.abspath(ap.parse_args().src)
    sys.path.insert(0, src)
    from repro_torch import convert
    from repro_torch.core import distributed
    with tempfile.TemporaryDirectory() as tmp:
        env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
                   JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_backend_optimization_level=0 "
                             "--xla_force_host_platform_device_count=4")
        subprocess.run([sys.executable, "-c", REF, tmp, str(GB), str(SEQ),
                        str(STEPS), str(K)], env=env, check=True)
        with np.load(os.path.join(tmp, "tree.npz")) as f:
            tree = convert._nest({k: f[k] for k in f.files}, "/")
        distributed.run_ranks(_rank, 4, "gloo", device="cpu",
                              args=(tmp, tree))
        ref = np.load(os.path.join(tmp, "ref.npy"))
        print(f"repro: {ref.tolist()}")
        for r in range(4):
            got = np.load(os.path.join(tmp, f"port{r}.npy"))
            err = float(np.max(np.abs(got - ref) / np.abs(ref)))
            print(f"port rank {r} ({src}): {got.tolist()}, max rel "
                  f"{err:.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
