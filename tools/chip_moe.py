#!/usr/bin/env python3
"""Phase 17 of ``chip_smoke.py`` alone, on one card: sliding-window
attention and the MoE block.

    python3 tools/chip_moe.py

Run from the root of a checkout on a machine with an NVIDIA H100. It
builds the kernels (one ``nvcc`` per source, together), prints ptxas's
report of K5 (``flash_attention``) and calls ``chip_smoke.phase_moe``,
which prints what phase 17 prints: mixtral-8x7b at full width (16
layers) and granite-moe-1b-a400m at full width and depth, each prefilled
at B 1, S 8192 (launches, median of three, tokens/s, peak memory, the
split) and served (batch 8, prompt 128, generate 32); K5's windowed call
at mixtral's shape against its plain version, SDPA with a band mask and
the same call at window 0; f32 card against CPU at granite widths and
mixtral-smoke serving through its ring; the serving CLI. The last line is
what K5's row gains. Any failed check raises.

Then it times two ways to the places of the picks in their experts on
the card, at the two prefills' pick counts (mixtral: T K = 16,384 over 8
experts; granite: 65,536 over 32): ``layers.expert_places``' sort by
expert and ``repro``'s cumsum of the (T K, E) one-hot down the picks,
which must give the same integers.
"""
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def places_by_cumsum(e, n_experts):
    """The same places as ``repro`` computes them: the cumsum of the
    one-hot down the picks."""
    import torch.nn.functional as F
    return F.one_hot(e, n_experts).cumsum(0).gather(1, e[:, None])[:, 0] - 1


def time_places():
    import torch
    import chip_smoke
    from repro_torch.models import layers as L
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    for what, picks, n_experts in (("mixtral", 8192 * 2, 8),
                                   ("granite", 8192 * 8, 32)):
        e = torch.randint(0, n_experts, (picks,), generator=gen,
                          device="cuda")
        if not torch.equal(L.expert_places(e, n_experts),
                           places_by_cumsum(e, n_experts)):
            raise AssertionError(f"{what}: the sort's places differ from "
                                 f"the one-hot cumsum's")
        t_sort = chip_smoke.time_ms(lambda: L.expert_places(e, n_experts),
                                    20)
        t_scan = chip_smoke.time_ms(lambda: places_by_cumsum(e, n_experts),
                                    5)
        print(f"places of {picks} picks over {n_experts} experts ({what}'s "
              f"prefill): sort {t_sort:.4f} ms, one-hot cumsum "
              f"{t_scan:.4f} ms (CUDA events; the same integers)",
              flush=True)


def main() -> int:
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch
    import chip_smoke
    from repro_torch.kernels import KERNEL_PACKAGES, _build
    if not torch.cuda.is_available():
        print("chip_moe.py: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}; {smi}",
          flush=True)
    t0 = time.perf_counter()
    _build.build(KERNEL_PACKAGES)
    print(f"kernels built in {time.perf_counter() - t0:.1f} s", flush=True)
    chip_smoke.log_ptxas("flash_attention")
    print(json.dumps(chip_smoke.phase_moe()), flush=True)
    time_places()
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
