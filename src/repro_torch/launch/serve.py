"""Serving launcher of the port: batched greedy decoding with a KV and
state cache (the port of ``repro/launch/serve.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \\
        --smoke --batch 4 --prompt-len 32 --gen-len 16 --device cpu

Every arch ``lm.check_ported`` accepts runs: the dense and MoE archs
(``--arch mixtral-8x7b`` or ``granite-moe-1b-a400m``; mixtral's
sliding-window layers decode through a ring cache), hymba-1.5b (a ring
of k and v beside the SSM heads' f32 state; its decode sees no meta
tokens, as in ``repro``) and xlstm-350m (the mLSTM and sLSTM states),
and pixtral-12b (decode carries no patches, as in ``repro``). As
``repro``'s, the CLI refuses an encoder-decoder arch (whisper-large-v3);
``BatchedServer.generate`` serves one, against a cross cache filled from
the frames it is given, or against ``repro``'s zeros. Runs on the card
unless ``--device cpu`` is given. As in ``repro``, the
prompt is fed through the decode path one token at a time (teacher
forcing: correct, though not the fast path; the bulk prefill is
``LM.prefill``), then ``gen_len`` tokens are decoded greedily.

On a model split over a model axis (``lm.LM(arch, device, axis)``) every
rank of the model group calls ``generate`` with the same prompts: each
allocates its shares of the cache (``lm.init_cache(..., axis=)``), the
logits are whole on every rank, and every rank takes the same greedy
tokens. Over a ``data`` axis that divides the batch, each rank decodes
its rows (an MoE routing the data group's tokens as one) and the tokens
are gathered back to the whole batch. No flag: the CLI serves one rank,
as ``repro``'s does.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import lm
from repro_torch.parallel import tensor as par


class BatchedServer:
    """Greedy batched decoding with a shared cache (``lm.init_cache``: k
    and v linear, or a ring for a sliding-window layer, the recurrent
    layers' states, and an encoder-decoder arch's cross k and v)."""

    def __init__(self, arch, model, max_seq: int, data=None):
        """``data``: the data axis (``parallel.tensor.Axis``) whose ranks
        split the batch, or None."""
        self.arch = arch
        self.model = model
        self.max_seq = max_seq
        self.data = data if data is not None and data.size > 1 else None

    @torch.inference_mode()
    def generate(self, prompts: np.ndarray, gen_len: int,
                 extras=None) -> np.ndarray:
        """prompts: (B, P) int32. Returns (B, gen_len) int32. With
        ``extras["frames"]`` (B, encoder_seq, D) an encoder-decoder arch's
        cross cache is filled from them first (the encoder runs, and K5
        with it); without, it stays zeros, as ``repro``'s server leaves
        it. Other extras (patches) are not decoded, as in ``repro``."""
        B, P = prompts.shape
        dev = self.model.embed.device
        # the batch splits over the data axis only where it divides
        data = self.data if self.data and B % self.data.size == 0 \
            else None
        rows = slice(None)
        if data is not None:
            n = B // data.size
            rows = slice(data.index * n, (data.index + 1) * n)
        cache = lm.init_cache(self.arch, B, self.max_seq, dev,
                              self.model.axis, data)
        if extras and "frames" in extras and self.arch.is_encdec:
            self.model.fill_cross_cache(cache, extras["frames"][rows])
        toks = torch.as_tensor(np.asarray(prompts)[rows], device=dev)
        logits = None
        for t in range(P):
            logits, cache = self.model.decode_step(toks[:, t:t + 1], cache,
                                                   t, data)
        out = []
        tok = torch.argmax(logits[:, -1], dim=-1)
        for t in range(gen_len):
            out.append(tok)
            logits, cache = self.model.decode_step(tok[:, None], cache,
                                                   P + t, data)
            tok = torch.argmax(logits[:, -1], dim=-1)
        out = par.gather_rows(torch.stack(out, dim=1), data)
        return out.to(torch.int32).cpu().numpy()


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (the plain versions)")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    arch = get_smoke_config(args.arch) if args.smoke \
        else get_config(args.arch)
    if arch.is_encdec:
        raise SystemExit("use the audio pipeline for enc-dec archs")
    model = lm.init_params(arch, args.seed, device=args.device)
    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(0, arch.vocab_size,
                           (args.batch, args.prompt_len)).astype(np.int32)
    server = BatchedServer(arch, model,
                           max_seq=args.prompt_len + args.gen_len)
    t0 = time.perf_counter()
    out = server.generate(prompts, args.gen_len)
    dt = time.perf_counter() - t0
    tps = args.batch * args.gen_len / dt
    print(f"arch={arch.name} generated {out.shape} in {dt:.2f}s "
          f"({tps:.1f} tok/s); sample: {out[0][:8].tolist()}")


if __name__ == "__main__":
    main()
