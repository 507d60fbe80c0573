#!/usr/bin/env python3
"""Phase 19 of ``chip_smoke.py`` alone, on one card: the encoder-decoder
(whisper-large-v3) and the vision stub (pixtral-12b).

    python3 tools/chip_encdec.py

Run from the root of a checkout on a machine with an NVIDIA H100. It
builds the kernels (one ``nvcc`` per source, together), prints ptxas's
report of K5 (``flash_attention``), runs phase 7's K5 sweep (which holds
the bidirectional calls at ragged lengths, whisper's 1500 x 1500 and
448 x 1500 among them, against the plain version) and calls
``chip_smoke.phase_encdec``, which prints what phase 19 prints: whisper
at full width and depth prefilled on 8 clips (96 K5 launches, the split,
K5 at the encoder's and the cross call's shapes against its plain
version, SDPA and its bound), served with the cross cache, decode against
prefill; pixtral at full width and depth prefilled with 1,024 patches
and served; f32 card against CPU and the smoke configs' serving; the
serving CLI. The last JSON line is K5's two rows. Any failed check
raises.
"""
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch
    import chip_smoke
    from repro_torch.kernels import KERNEL_PACKAGES, _build
    if not torch.cuda.is_available():
        print("chip_encdec.py: torch.cuda.is_available() is False",
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
    t0 = time.perf_counter()
    chip_smoke.phase_attention_kernel()
    print(f"phase 7 done in {time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps(chip_smoke.phase_encdec()), flush=True)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
