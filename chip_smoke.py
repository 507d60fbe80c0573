#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA H100. It
builds the hand-written kernels from ``src/repro_torch/kernels/csrc`` and

1. builds the kernels (one ``nvcc`` per source, together; ptxas's
   registers and spills of each ``gram``, ``flash_attention``, ``spmm``,
   ``svm_inner`` and ``sa_inner`` instance are printed, and a spill in a
   ``wgmma`` body or an ``sa_inner`` instance fails, as does a missing
   ``flash_attention`` wgmma instance at D = 64, 128 or 160), holds each kernel
   against its plain PyTorch version on
   the card, at the main paths' shapes and at edge shapes, and times
   ``gram`` and ``sa_inner`` with their plain versions and (``gram``)
   ``torch.matmul`` with CUDA events. ``gram`` routes by
   ``dispatch.gram_route``: each case checks the body it took (``wgmma``
   for f32 where TMA can describe the operands, else ``simt``: f64, and
   f32 views at an unaligned start; a non-contiguous view is copied
   first), that two calls give the same bits, and the C side's tile plan
   and shared-memory formula against ``kernels/dispatch.py``; ``sa_inner``
   routes by ``dispatch.sa_inner_route`` (``warp``: mu <= 32 and its
   layout in shared memory; ``block``: the rest) and runs both bodies
   where the warp body serves (f32 and f64, an all-zero diagonal block,
   its f32 cap (238, 1)), each twice for the same bits, with its layouts
   and power-warp count checked against dispatch's; the path's
   call Y^T [Y | ytil | ztil] is timed with both bodies and
   ``torch.matmul`` (TF32 off), and a 1xTF32 emulation of it must miss
   K1's bar there. ``flash_attention`` runs on bf16 views one element
   into their storage, which it copies first. ``spmm`` (every case twice,
   bit for bit) and ``svm_inner`` (both bodies where the ``warp`` body
   serves, on both sides of its caps) run over their sweeps. A latency
   probe (``sync_step_probe`` in ``csrc/sa_inner.cu``) times one shuffle
   reduction and block barrier, the latency bound of ``sa_inner`` and
   ``svm_inner`` per dependent step;
2. drives the dense Lasso path — ``repro_torch.api.solve`` on a dense
   Lasso at the shape of LIBSVM ``epsilon`` (400,000 x 2,000, f32),
   SA-accBCD with mu = 8, s = 16, H = 512 — checks that ``gram`` (all
   through its ``wgmma`` body) and ``sa_inner`` (all through its ``warp``
   body) each launched ceil(H/s) = 32 times, that the objective is
   finite and falls, and that the
   classical accBCD (s = 1) gives the same trace within rel 1e-3; then
   times where each outer iteration's time goes, and ``sa_inner``'s two
   bodies on the inputs the solve gave it;
3. runs an f64 solve on the card (epsilon-like, 8192 x 512) through the
   same kernels (``gram``'s ``simt`` body, ``sa_inner``'s ``warp`` body)
   and holds it to the CPU solve within 1e-8;
4. drives the sparse SVM path — ``api.solve`` on a linear SVM-L1 at the
   shape of LIBSVM ``news20.binary`` (19,996 x 1,355,191, ~9.1 M nonzeros,
   a SparseOperand made on the card), SA-BDCD mu = 1, s = 64, H = 4096 —
   checks 64 launches each of ``spmm`` and ``svm_inner`` (all of its
   ``warp`` body) and none of ``gram``, a finite falling dual trace and
   the classical BDCD (s = 1) within rel 1e-3, times the phases, and
   times ``spmm`` and ``svm_inner`` on the inputs the solve gave them
   against their plain versions, ``spmm`` in turns with
   ``torch.sparse.mm`` and ``svm_inner`` beside its ``block`` body;
5. drives the sparse Lasso path — SA-accBCD mu = 8, s = 16, H = 512 on a
   sparse Lasso at the shape of LIBSVM ``url`` (2,396,130 x 3,231,961,
   ~279 M nonzeros) — with the same checks (32 launches each of ``spmm``
   and ``sa_inner``, all of its ``warp`` body, none of ``gram``) and
   phase split;
6. runs f64 sparse solves on the card (SVM rcv1-like, Lasso news20-like)
   through ``spmm``, ``svm_inner`` and ``sa_inner`` and holds them to the
   CPU solves within 1e-8;
7. holds ``flash_attention`` against its plain version at every case of
   tests/test_kernels.py's ATTN_CASES and more (ragged lengths, windows,
   decode-like Sq = 1, bidirectional, bidirectional at ragged lengths
   (whisper's 1500 x 1500 and 448 x 1500), strided views, stablelm-12b's
   D = 160 ragged with a window, at one query over 384 keys, bidirectional
   130 x 400 and as strided views), at f32 (atol 2e-3) and bf16 (atol
   2e-2), checking that each call took the body
   ``dispatch.flash_attention_route`` names (bf16 at D = 64, 128 and 160:
   ``wgmma``, D = 160 through its 64-byte tail panel; the rest: ``simt``),
   and a bf16 D = 160 call forced onto the ``simt`` body; checks both
   bodies' tile sizes and shared-memory formulas (the wgmma body's at
   each of its head dimensions) against ``kernels/dispatch.py``, and one
   gradient against the plain version's autograd;
8. drives the LM prefill — ``LM.prefill`` of llama3-8b at full width
   (32 layers, 8.03 B parameters, bf16, random from a seed) on B = 1,
   S = 8192 — checks 32 launches of ``flash_attention``, all of its
   ``wgmma`` body, and none of the other kernels and finite logits,
   times the steady prefill and where its time goes, then holds the
   kernel on the q/k/v of the first layer against the plain version
   (bf16 within one rounding step of the output, rtol 2^-7 and atol
   4e-3; the same q/k/v in f32 within atol 2e-4) and times it with the
   plain version, its ``simt`` body at bf16, its ``wgmma`` body without
   ping-pong and ``scaled_dot_product_attention``;
9. drives serving — ``BatchedServer.generate`` with batch 8, prompt 128,
   generate 32 on the same model — checks that it launched no kernel
   (decode attention is plain PyTorch, as in repro), times the decode
   steps and where their time goes, and holds the teacher-forced decode
   logits at the last prompt position to ``prefill``'s within atol 0.12,
   rtol 0.05;
10. runs tinyllama-1.1b widths cut to 2 layers at f32, B = 2, S = 512, on
   the card (through ``flash_attention``) and on the CPU (plain), and
   holds the logits within rel 1e-4 and the generated tokens equal;
11. (run after phase 6) drives the sharded backend, ``api.solve(...,
   backend="sharded")``: (a) over NCCL at world size 1 in this process,
   on phase 2's epsilon Lasso — x and the trace bit-identical to phase
   2's local solve, 64 all-reduces with the objective tracked and 32
   without, 32 launches each of ``gram``'s ``wgmma`` body and
   ``sa_inner``'s ``warp`` body; the steady walls of both backends in
   turns, and one NCCL all-reduce of the (128, 130) f32 payload timed;
   (b) four gloo ranks on the one card (``core.distributed.run_ranks``;
   gloo stages CUDA tensors through the host), each making the full data
   from the seed: epsilon (100,000 rows a rank) and news20.binary
   (338,798 feature columns a rank) at the paths' settings, and an f64
   epsilon-like 8192 x 512 Lasso. Each rank checks its kernels' launches
   (32 of ``gram``'s ``wgmma`` and ``sa_inner``'s ``warp`` body; 64 of
   ``spmm`` and ``svm_inner``'s ``warp`` body, none of ``gram``), its
   ceil(H/s) all-reduces untracked, and that x (alpha) and the trace are
   the same bits on every rank; rank 0's traces hold to phases 2 and
   4's local solves within rel 1e-3, the f64 solve to the CPU within
   1e-8. Part (a) also runs phase 12's three families at NCCL world
   size 1: ceil(H/s) all-reduces untracked (tracked: the same for ksvm
   and logreg, twice for CA-SFISTA), their launches, and the trace and
   vectors against phase 12's local solve bit for bit (where the local
   solve does not repeat its own bits, the atomic adds of its scatters,
   within rel 1e-5, and the log says so);
12. (run after phase 6) drives the other solver families at full width:
   ``api.solve`` on the news20.binary data of phase 4 as a kernel SVM
   (SA-K-BDCD, rbf gamma 0.1, SVM-L1; mu 1, s 64, H 4096, then mu 4,
   s 16, H 1024) and as logistic regression (SA-BCD, lam 1e-3, mu 4,
   s 16, H 1024), and on the epsilon data of phase 2 as CA-SFISTA
   (mu 8, s 16, H 512). Each checks its launches (ksvm: ceil(H/s) = 64
   each of ``spmm`` in the cross orientation A Y^T and ``svm_inner``'s
   ``warp`` body; logreg: 64 of ``spmm``; CA-SFISTA: 32 of ``gram``'s
   ``wgmma`` body with one vector; no other kernel), its SA trace
   against its classical solve (rel 1e-3; the dual descends, SFISTA's
   momentum is checked end to end), times the steady solves, the device's
   busy share of one (torch.profiler) and where an outer iteration's
   time goes, and holds ``spmm``, ``svm_inner``
   (both shapes) and ``gram`` to their plain versions on the inputs the
   path gave them, with their times, bounds and library calls. Then f64
   on the card against the CPU within 1e-8 (ksvm rbf and logreg
   rcv1-like, sparse CA-SFISTA news20-like through ``spmm`` with one
   extra vector) and ksvm's tracked dual against
   ``kernel_dual_objective`` within 1e-8;
13. (run after phase 11) the cost model and the calibrated autotuner
   (``repro_torch.tune``) on the card: (a) ``measure_machine()`` (gamma
   from ``torch.matmul`` GEMMs, alpha and beta from an elementwise pass,
   kappa from a tiny ``bcd_lasso``), each finite and positive, beta
   resolved (under 100 TB/s); (b)
   ``tune.tune`` on phase 2's epsilon Lasso with its incumbent (mu 8,
   s 16, H 512) and on phase 4's news20.binary SVM with its incumbent
   (mu 1, s 64, H 4096), 48-iteration pilot solves, the cache in a
   temporary directory: each pilot point, the fitted machine, the
   selected config, the predicted times and the guard's timings, with
   K1 and K2 (epsilon) or K4 and K3 (news20.binary), and no other
   kernel, launched during the calibration; (c) a second ``tune.tune`` from the cache that launches
   no kernel; (d) the tuned config (and the model's own pick where the
   guard kept the incumbent) at full H against the incumbent: each one's
   launches (ceil(H/s) of each kernel of the SA path; the classical
   dense Lasso at s = 1 reaches no kernel, as in repro), its trace
   against the classical solve at its mu within rel 1e-3, the objective
   each reaches after H (and, for a config of another mu, its objective
   and time at the incumbent's H mu coordinate updates), and the median
   of five steady solves of each in turns, per solve and per outer
   iteration (H cut, and only H, where the guard's timings predict more
   than a minute); (f) ``python -m repro_torch.launch.solve
   --list-families`` and ``--tune`` as subprocesses on the card;
14. (run after phase 13) the static contracts of ``repro_torch.analysis``
   on the card: (a) ``check_all(device="cuda")`` over every pass, family
   and variant at the certification shapes, with its subject counts and
   info rows (payload bytes per outer iteration, counted/modeled F and W
   per family x variant x s), failing on any error diagnostic, and K1-K4
   each launched during it; (b) every family x variant x s of the
   certification grid, dense and sparse, counted on the card and on the
   CPU (flops, words, messages, payload bytes per outer iteration): all
   equal; (c) on phase 2's epsilon and phase 4's news20.binary data, one
   sharded solve each at NCCL world size 1 under the recorder: exactly
   one all-reduce in each of the 32 / 64 outer iterations, of the fused
   block's (s mu)(s mu + 2) / (s mu)(s mu + 1) f32 words (66,560 /
   16,640 bytes), the counted F and W against Table I at the true dims
   beside the declared bands, and the recorder's overhead (ms per outer
   iteration with and without it, median of three); (d)
   ``tune.select_config(..., certified=True)`` on the epsilon problem
   with phase 13's fitted machine; (e) ``python -m repro_torch.analysis
   --json --families lasso --checks collectives`` as a subprocess on the
   card (the CLI path; (a) ran the whole registry), exit 0 and ``ok:
   true``, started with the launchers that run beside phase 21;
15. (run last, after the LM phases 7-10, so that nothing it might leave
   behind, an NCCL group, ranks or save threads, is there while another
   phase is timed) the elastic runtime (``api.solve_elastic``):
   (a) at NCCL world size 1 in this process, phase 2's epsilon Lasso in
   segments of checkpoint_every 1 and 8 outer iterations (async save)
   and 1 (sync save): x and the trace bit-identical to phase 2's local
   solve, 32 launches each of ``gram``'s ``wgmma`` body and
   ``sa_inner``'s ``warp`` body and no other kernel, the 3 checkpoints
   kept, each with the state's four leaves and their specs; the bytes of
   a checkpoint, its host copy, save and restore ms; the ms per outer
   iteration segmented against the monolithic sharded solve (medians of
   three, in turns), and a segment's split (the family's solve and each
   callback of its program, shard setup, end gathers, the checkpoint's
   host copy); (b) four gloo ranks on the one card, each making the full
   data from the seed: epsilon with host 2 killed at inner iteration 200
   (8 steps into the s-group at 192) and news20.binary with host 0, the
   checkpoint writer, killed at 2,000 (16 into the s-group at 1,984),
   checkpoint_every 1: each must resume at 192 / 1,984 on three
   survivors, with a trace of H entries, x (alpha) within rel 1e-3 of the
   undisturbed P = 4 elastic solve, the same bits on every survivor, and
   as many launches of K1 and K2 (K4 and K3) on each survivor as on a
   rank of the undisturbed run; restore and group-build ms, the
   rolled-back iterations and the disturbed minus undisturbed wall are
   printed; (c) on the same ranks, ``repro``'s f64 chaos schedules
   (tests/test_chaos.py's problem) on the card and on the CPU: x within
   1e-8, the recoveries equal; (d) ``python -m torch.distributed.run
   --standalone --nproc-per-node 4 -m -- repro_torch.launch.solve ...
   --checkpoint-every 1 --inject-failure 10:2 --device cuda`` as a
   subprocess (its rendezvous on a free port): exit 0, gloo
   at world size 4, a failure and a restore event, the final objective
   within rel 1e-3 of the same command without the elastic flags (the
   two started together, beside phase 21);
16. (run after phase 10, before phase 15) LM training
   (``repro_torch.runtime.Trainer``, one gradient reduction per step):
   (a) tinyllama-1.1b at full width and depth (22 layers, bf16, random
   from a seed) at train_4k's S = 4096, global batch 8 (cut from 256) in
   8 microbatches of 1, 8 steps of ``cosine_schedule(3e-4, 2, 8)``, NCCL
   at world size 1: every loss finite and the last below the first,
   exactly 22 x 8 K5 launches a step, all ``wgmma``, no other kernel, one
   counted reduction a step; ms per step, tokens/s, peak memory, the
   final checkpoint's bytes and times, the step's split by CUDA events
   (forward: K5 and the rest; backward: K5's plain VJP and the rest; the
   reduction; AdamW), and K5 against its plain version on the first
   microbatch's layer-0 q/k/v (the prefill's bar); (b) f32, tinyllama
   widths at 2 layers, B 2, S 512: one step on the card against the CPU
   from the same weights (loss rel 1e-4; the reduced gradients, and the
   card's AdamW against the CPU's on the card's gradients, within 1e-4 of
   each leaf's max; the updated parameters too, where the gradient is
   not zero within the two devices' rounding: Adam's first step is ~lr
   sign(g)), then ``remat`` "full" and
   "dots" against "none" on the card (the loss bit for bit, gradients
   within 1e-6 of each leaf's max, K5 launched twice a layer); (c)
   microbatches 1 against 4 on the card, 3 steps, losses within rel
   1e-5; (d) four gloo ranks on the one card at tinyllama's vocabulary
   and head dimension, d_model 256, 2 layers, f32, a checkpoint every 2
   steps: undisturbed 4 steps, then ranks 2 and 3 killed at step 3,
   resumed at step 2 on [0, 1] to 4 with losses within rel 1e-5 of the
   undisturbed run; the checkpoint's bytes, write and restore times; (e)
   ``python -m repro_torch.launch.train --arch tinyllama-1.1b --smoke
   --steps 20 --ckpt-dir <tmp>`` exits 0 (with the other launchers,
   beside phase 21); (f) whisper-large-v3 at full
   width and depth (bf16) trained 3 steps through ``make_train_step`` on
   8 clips of 1,500 stub frames and 448 tokens in 2 microbatches, and
   (g) pixtral-12b at full width, 8 layers, 3 steps at S 4096 (1,024 patch
   rows) in 2 microbatches: finite losses, exactly 96 (whisper: the
   encoder's, the causal and the cross calls) or 8 K5 launches a
   microbatch, all ``wgmma``, K5 on the first call's q/k/v against its
   plain version (the prefill's bar), the step's split (the encoder and
   the cross steps apart), the peak;
17. (run after phase 10, before phase 16) sliding-window attention and
   the MoE block: (a) mixtral-8x7b at full width (d 4096, 32/8 heads of
   128, 8 experts top 2, d_ff 14,336, vocab 32,000, window 4096, bf16),
   its depth cut from 32 to 16 layers (23.48 B parameters, 46.96 GB; the
   32 would not fit the card), random from a seed: ``LM.prefill`` at B 1,
   S 8192, exactly 16 K5 launches, all ``wgmma``, no other kernel,
   finite logits; the median of three, tokens/s, peak memory, the split
   by CUDA events (K5, q/k/v, rope, the attention's rest, router +
   top-k, dispatch, the expert products, combine, rmsnorm, unembed), the
   device's busy share, K5 on layer 0's q/k/v against its plain version
   (the prefill's bar); then ``BatchedServer.generate`` batch 8, prompt
   128, generate 32: no kernel, ms per step against the bytes a step
   reads at the HBM rate, a step's split; (b) K5's windowed call on
   those q/k/v: its time, device time, plain version,
   ``scaled_dot_product_attention`` with an explicit (S, S) band mask
   (the backend it picks logged), the bound from the live pairs, and the
   same call at window 0; (c) granite-moe-1b-a400m at full width and
   depth (24 layers, 32 experts top 8, heads of 64): the same prefill
   (24 ``wgmma`` launches, causal) and serving; (d) f32 at granite
   widths, 2 layers, B 2, S 512, the card against the CPU from the same
   weights: logits rel 1e-4, aux and ``train_loss`` rel 1e-5, the chosen
   experts equal except within 1e-5 of a top-k tie (counted), then
   mixtral-smoke (window 32) serving prompt 40 + generate 16 through its
   ring of 32: the card's tokens equal the CPU's; (e) ``python -m
   repro_torch.launch.serve --arch mixtral-8x7b --smoke --prompt-len 40
   --gen-len 16`` exits 0 on the card;
18. (run after phase 17, before phase 16) the recurrent blocks: (a)
   hymba-1.5b at full width and depth (32 ``hybrid`` layers: attention
   of 25/5 heads of 64 in a window of 1024 beside 25 SSM heads of key
   dim 16, d 1600, d_ff 5,504, vocab 32,001, 128 meta tokens, bf16;
   1.433 B parameters), random from a seed: ``LM.prefill`` at B 1, S 8192
   (8,320 positions), exactly 32 K5 launches, all ``wgmma``, no other
   kernel, finite logits; the median of three, tokens/s, peak memory,
   the split by CUDA events (K5, q/k/v, rope, the attention's rest, the
   SSM projections, ``chunked_gla``'s intra-chunk and inter-chunk parts,
   the SSM gate and out, the MLP, rmsnorm, unembed), the busy share, K5 on
   layer 0's q/k/v against its plain version (the prefill's bar) with its
   time, device time, bound, SDPA with an explicit band mask and the same
   call at window 0; ``BatchedServer.generate`` batch 8, prompt 128,
   generate 32: no kernel, ms per step against the bytes a step reads,
   the idle share and operations a step; decode against prefill at
   meta_tokens 0 (atol 0.12, rtol 0.05); (b) xlstm-350m at full width
   and depth (24 layers, mLSTM and sLSTM in turn, d 1024, 4 heads of
   256, vocab 50,304, bf16; 0.2416 B parameters): the prefill at B 1, S
   2048 (cut from 8192: the sLSTM's steps are launched one by one), no
   kernel, finite logits, one steady prefill (three prefills in all,
   cut from five for the run's time), tokens/s, the split
   (mLSTM intra-chunk, inter-chunk, the sLSTM scan, the projections), the
   device operations of an sLSTM step; serving as in (a); (c) f32 at
   hymba and xlstm widths, 2 layers, B 2, S 512, the card against the
   CPU from the same weights (logits rel 1e-4, ``train_loss`` rel 1e-5),
   and the smoke configs serving prompt 40 + generate 16 (hymba-smoke
   through its ring of 32): the card's tokens equal the CPU's; (d)
   ``python -m repro_torch.launch.serve --arch hymba-1.5b --smoke
   --prompt-len 40 --gen-len 16`` and the same for xlstm-350m exit 0 on
   the card;
19. (run after phase 18, before phase 16) the encoder-decoder and the
   vision stub: (a) whisper-large-v3 at full width and depth (32 encoder
   and 32 decoder layers, d 1280, 20 heads of 64, ``mlp2`` with gelu,
   vocab 51,866, tied embeddings, sinusoidal positions, bf16;
   1,536,522,240 parameters), random from a seed: ``LM.prefill`` of 8
   clips of 1,500 stub frames and 448 decoder tokens (Whisper's
   published decoder context), exactly 96 K5 launches (the encoder's,
   the decoder's causal self-attention and its cross-attention, 32
   each), all ``wgmma``, no other kernel, finite logits; the median of
   three, tokens/s, the split by CUDA events (the encoder, the cross
   steps, the decoder's K5 and rest, each K5 part told apart), the busy
   share, the copies K5's wrapper makes; K5 on the encoder's layer 0 and
   on the first cross call against its plain version (the prefill's
   bar, and the same q/k/v in f32 within atol 2e-4), each timed with
   the plain version, its simt body, its wgmma body without ping-pong
   and non-causal SDPA, with the bound from its live pairs; then
   ``BatchedServer.generate`` batch 8, prompt 128, generate 32 with the
   cross cache filled from the 8 clips (32 K5 launches in the fill, none
   in decode), ms per step against the bytes a step reads, the split,
   the idle share; decode against prefill at the last prompt position
   logged at bf16 and held to repro's bar (atol 0.12, rtol 0.05) in f32,
   at full depth; (b) pixtral-12b at full width and depth (40 layers, d
   5120, 32/8 heads of 128, d_ff 14,336, vocab 131,072; 24.50 GB bf16):
   the prefill at B 1, S 8192 (1,024 random patch rows, then 7,168
   tokens), exactly 40 K5 launches, all ``wgmma``, the median of three,
   peak memory, the split, the busy share, K5 on layer 0's q/k/v against
   its plain version; serving as in (a), without patches; (c) f32 at
   whisper widths (2 + 2 layers, B 2, 1,500 frames, S 64) and pixtral
   widths (2 layers, B 2, S 512 with 128 patches), the card against the
   CPU (logits rel 1e-4), then whisper-smoke (with frames) and
   pixtral-smoke serving prompt 40 + 16: the card's tokens equal the
   CPU's; (d) ``python -m repro_torch.launch.serve --arch pixtral-12b
   --smoke --prompt-len 40 --gen-len 16`` exits 0 on the card, and the
   same for whisper-large-v3 exits 1 with repro's refusal;
20. (run after phase 16, before phase 15) the dry run against the card:
   ``repro_torch.launch.dryrun.run_cell`` on a one-card mesh, on the meta
   device, at the own arch and shape of nine paths measured above (phase
   8's llama3-8b prefill, 16 (a)'s tinyllama-1.1b training step, 17 (a)'s
   mixtral-8x7b prefill at 16 layers, 19 (a)'s whisper prefill of 8
   clips, 19 (b)'s pixtral-12b prefill, 16 (f)'s and (g)'s training
   steps, 22's qwen1.5-4b and stablelm-12b prefills; nothing is run
   again; 16 (f) and (g)'s cells counted in the dry run's subprocess): the
   argument bytes equal the bytes of the card's model, inputs and (the
   training step) AdamW state exactly; the predicted peak (argument +
   temp) within [0.8, 1.25] of the card's peak device memory in the
   path's first run (what was allocated before it and is not the path's
   taken out); at llama3-8b's prefill, the
   ``analysis.record.Recorder``'s FLOPs of a prefill on the card (phase 8
   counts one) equal the meta count exactly; the bound on ``HW_H100``,
   its share of the measured time and model_flops / (s x peak) printed;
   mixtral-8x7b's prefill_32k cell at full depth, and phase 17's path at
   full depth, do not fit one card, and the path at 16 layers does; the
   one-card ``DeviceMesh`` over NCCL at world size 1 places a tensor by
   the port's partition specs;
21. (run after phase 20, before phase 15) tensor, expert and sequence
   parallelism and FSDP over two gloo ranks sharing the card (see the
   comments above TP_FULL): (a) tinyllama-1.1b, (b) granite-moe-1b, (e)
   hymba-1.5b, (f) xlstm-350m at S 256, (h) whisper-large-v3 and (i)
   pixtral-12b (8 layers) with their frames or patches, each at full
   width on data 1 x model 2 against one rank; (c) f32 at 2 layers; (d)
   FSDP as data 2 x model 1; (g) split serving. Every rank's argument
   bytes, last step's FLOPs and collectives equal its own dry-run cell,
   its peak within [0.8, 1.25] of the cell's;
22. (run after phase 19, before phase 16) qwen1.5-4b and stablelm-12b at
   full width and depth (bf16): phase 8's prefill at B 1, S 8192 (40 K5
   launches, all on the ``wgmma`` body and none on ``simt``, at qwen's D
   128 and at stablelm's D 160, as ``dispatch.flash_attention_route``
   names it), K5 on layer 0's q/k/v against its plain version with its
   times (the wrapper, the body without ping-pong, the ``simt`` body at
   bf16), SDPA's and its bound, phase 9's serving, and the served generate's
   decode logits at the last prompt position against prefill's (atol
   0.12, rtol 0.05). Phases 9, 18 and 19 take those decode logits from
   their served generate too (its prompt is the check's).

Before the kernels' line, the timeline: each phase's and part's seconds
and the whole script's.

Any failed check raises, so the exit code is non-zero. The last lines
are the kernels' JSON line (for each of ``gram``, ``sa_inner``, ``spmm``,
``svm_inner`` and ``flash_attention``, and a row for each kernel at a
phase 12 path's shape: its launches on its main path (``flash_attention``
also its launches per training step and its error and times at the
training shape, phase 16, and its launches per mixtral prefill, error,
times, bound and SDPA's time at mixtral's windowed shape, with the time
at window 0, phase 17, and the same at hymba's, phase 18; and two rows of
its own at whisper's bidirectional shapes, the encoder's and the cross
call's, phase 19),
its error against the plain version, its time through the wrapper
(``ms``, CUDA events over back-to-back calls, host work included), its
device time alone (``device_ms``: the summed kernel durations of a
torch.profiler trace of back-to-back calls, taken once more when it
holds no kernel record, and failing when the second holds none either;
``sa_inner``'s on the epsilon
path's inputs, ``spmm``'s and ``svm_inner``'s on news20.binary's), the
plain version's time, the bound and, where one PyTorch call computes the
same function, that call's time), the card's name and power limit as
``nvidia-smi`` reports them, and the device JSON line. Without a card,
or outside a checkout, it exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

# The latency probe's time per dependent step, from phase 1.
PROBE = {}
# Phases 2 and 4's local solves (on the CPU), which phase 11 holds the
# sharded backend to.
LOCAL = {}

# H100 SXM published peaks (NVIDIA data sheet): f32 outside the tensor
# cores and TF32 on the dense tensor cores here; bf16 on the dense tensor
# cores and HBM3 bandwidth from the port's roofline (``HW_H100``), which
# the dry run (phase 20) reads too.
F32_FLOPS = 67e12
TF32_FLOPS = 494.7e12
if os.path.isdir(os.path.join(SRC, "repro_torch")):
    sys.path.insert(0, SRC)
    from repro_torch.roofline import HW_H100
    BF16_FLOPS, HBM_BYTES_PER_S = HW_H100.peak_flops, HW_H100.hbm_bw
# What phases 8, 16 (a), 17 (a) and 19 measured of each path, by arch
# name, for phase 20: the arch and shape run, the steady seconds, the
# peak device memory of the first run less what was allocated before it
# that is not the path's ("peak"), the bytes of the model, its inputs and
# (training) the AdamW state ("args"), and (phase 8) the Recorder's FLOPs
# of a prefill on the card.
MEASURED = {}

M_EPS, N_EPS = 400_000, 2_000           # LIBSVM epsilon
K0_ROUNDS = 33          # K0's dependent rounds: 32 power iterations + 1
# Phase 2's label of K1's call, Y^T [Y | ytil | ztil] read in place.
GRAM_PHASE = "gram kernel (Y^T [Y | V], no cat)"
MU, S, H = 8, 16, 512
# LIBSVM news20.binary (SVM path) and url (sparse Lasso path; density f
# as src/repro/core/cost_model.py:246 gives it).
M_NEWS, N_NEWS, F_NEWS = 19_996, 1_355_191, 3.36e-4
S_SVM, H_SVM = 64, 4096
M_URL, N_URL, F_URL = 2_396_130, 3_231_961, 3.6e-5
# The url Lasso plants a 1%-dense x: with the recipe's default 32 nonzeros
# among 3.2 M features, only ~4% of the solve's 512 blocks of 8 would
# meet one, and lam = 0.1 lam_max zeroes every other step, so the
# objective could not visibly fall.
K_URL = N_URL // 100

# The LM serving path: llama3-8b at full width (32 layers, bf16). The
# prefill is cut from repro's prefill_32k shape (configs.SHAPES; B 32,
# S 32,768) to B 1 at Llama 3's published context of 8192, for the run's
# time limit.
LLAMA = "llama3-8b"
PREFILL_B, PREFILL_S = 1, 8192
SERVE_B, SERVE_P, SERVE_G = 8, 128, 32
# f32 card vs CPU: tinyllama-1.1b widths cut to 2 layers (~0.9 GB f32).
TINY, TINY_LAYERS, TINY_B, TINY_S = "tinyllama-1.1b", 2, 2, 512
# (B, Hq, Hkv, Sq, Sk, D, causal, window): tests/test_kernels.py
# ATTN_CASES, then ragged keys, a ragged window, 4:1 GQA at D = 128 over a
# partial last tile, a bidirectional Sq < Sk, stablelm-12b's heads
# (32 over 8 of D = 160) over a partial last tile, the smoke configs'
# D = 16 at the training launcher's default batch and length, and
# hymba-1.5b's 25 query heads over 5 (group 5, D = 64) at its window of
# 1024 (640 positions: the f32 check's 512 tokens + 128 meta tokens) and
# at a ragged length under a narrower window; then bidirectional calls at
# ragged lengths: whisper-large-v3's encoder (20 heads of 64, 1500 =
# 11 x 128 + 92 frames) and its cross-attention (448 decoder positions
# over the 1500), 4:1 GQA at D = 128 over a partial last key tile, and
# D = 32 (the simt body) at 200 x 200; then stablelm-12b's D = 160 (the
# wgmma body's 64-byte tail panel at bf16) at 4:1 GQA: ragged with a
# window of 100, one query over 384 keys, bidirectional 130 x 400.
ATTN_CASES = [
    (2, 4, 2, 128, 128, 64, True, 0),
    (1, 8, 2, 256, 256, 64, True, 64),
    (1, 4, 4, 100, 100, 32, True, 0),
    (1, 2, 1, 1, 384, 64, True, 0),
    (1, 2, 1, 1, 384, 64, True, 128),
    (2, 2, 2, 64, 64, 128, False, 0),
    (2, 4, 2, 100, 228, 32, True, 0),
    (1, 8, 2, 300, 300, 128, True, 100),
    (1, 32, 8, 1000, 1000, 128, True, 0),
    (1, 4, 1, 128, 256, 64, False, 0),
    (1, 32, 8, 520, 520, 160, True, 0),
    (8, 4, 2, 128, 128, 16, True, 0),
    (1, 25, 5, 640, 640, 64, True, 1024),
    (1, 25, 5, 650, 650, 64, True, 300),
    (1, 20, 20, 1500, 1500, 64, False, 0),
    (2, 20, 20, 448, 1500, 64, False, 0),
    (1, 4, 1, 100, 228, 128, False, 0),
    (1, 2, 2, 200, 200, 32, False, 0),
    (1, 8, 2, 300, 300, 160, True, 100),
    (1, 4, 1, 1, 384, 160, True, 0),
    (1, 4, 1, 130, 400, 160, False, 0),
]


# (seconds since the script's start, the line) of each line that opens a
# phase or a part of one, for ``log_timeline``
TIMELINE = []
T_START = time.perf_counter()


def log(msg: str) -> None:
    if msg.startswith("phase "):
        TIMELINE.append((time.perf_counter() - T_START, msg[:48]))
    print(msg, flush=True)


def log_timeline() -> None:
    """Each phase's and part's seconds, from its opening line to the next
    one's (a phase that logs in parts is split by them), and the whole
    script's."""
    now = time.perf_counter() - T_START
    log(f"timeline (s from the start, s until the next line):")
    for (t, what), nxt in zip(TIMELINE, TIMELINE[1:] + [(now, "")]):
        log(f"  {t:8.1f} {nxt[0] - t:8.1f}  {what}")
    log(f"the whole script: {now:.1f} s")


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls, by CUDA
    events after ``warmup`` calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / reps


def trace_kernel_ms(fn, n: int):
    """Summed mean kernel durations (ms) per call of ``fn`` in one
    torch.profiler trace of ``n`` back-to-back calls, or None when the
    trace holds no kernel record."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    path = os.path.join(ROOT, "build", "device_ms_trace.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    # The trace drops kernel records, more of them the longer the process
    # has run (1-4 of 50 early in this script, all 5 of K5's 0.7 ms calls
    # by phase 17, 19 of 20 in phase 8 with the idle below): 0.2 s of
    # idle on each side of the calls and 50 calls keep some.
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(0.2)
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        time.sleep(0.2)
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    os.remove(path)
    by_name = {}
    for e in events:
        if e.get("cat") == "kernel" and "dur" in e:
            by_name.setdefault(e["name"], []).append(float(e["dur"]))
    if not by_name:
        return None
    counts = sorted(len(d) for d in by_name.values())
    if counts != [n] * len(counts):
        log(f"  (device time: the trace holds {counts} records of "
            f"{len(counts)} kernel(s) over {n} calls)")
    return sum(sum(d) / len(d) for d in by_name.values()) / 1e3


def device_ms(fn, n: int = 50):
    """Device time per call of ``fn``: from a torch.profiler trace (the
    same machinery as ``device_profile``) of ``n`` back-to-back calls,
    the mean duration of each kernel ``fn`` launches, summed over its
    kernels, so the host's launch work between them is left out. Means,
    not totals over ``n``: a trace can miss a call's record (the first,
    in some runs), and that is logged. A trace that holds no kernel
    record at all is taken once more, and that is logged; if the second
    holds none either, this raises, so no kernel row's device time is
    left unmeasured unnoticed."""
    for attempt in (1, 2):
        got = trace_kernel_ms(fn, n)
        if got is not None:
            return got
        log(f"  (device time: trace {attempt} of {n} calls held no kernel "
            f"record{'; tracing again' if attempt == 1 else ''})")
    raise AssertionError(f"device_ms: two traces of {n} calls held no "
                         f"kernel record")


def fmt_ms(t) -> str:
    return "not measured" if t is None else f"{t:.4f}"


def bound_ms(nbytes: float, flops: float, peak_flops: float = F32_FLOPS):
    """(least time in ms, what bounds it) on the published peaks: bytes at
    the HBM rate, operations at ``peak_flops`` (their type's rate)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak_flops
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def sa_inner_flops(s: int, mu: int, iters: int) -> float:
    """Floating-point operations of one sa_inner call on its inputs: the
    power iterations (skipped at mu = 1), the masked cross-term and
    collision sums over the j*mu earlier entries of each step, the prox."""
    power = 0 if mu == 1 else s * (iters * (2 * mu * mu + 3 * mu)
                                   + 2 * mu * mu + 4 * mu)
    chain = sum(mu * j * mu * 5 for j in range(s))
    return power + chain + s * (4 + mu * 12)


def svm_inner_flops(s: int, mu: int, iters: int) -> float:
    """Floating-point operations of one svm_inner call on its inputs: the
    power iterations (skipped at mu = 1), the cross-term and collision
    sums over the j*mu earlier entries of each step, the clipped update,
    and the dual increments."""
    power = 0 if mu == 1 else s * (iters * (2 * mu * mu + 3 * mu)
                                   + 2 * mu * mu + 4 * mu)
    chain = sum(mu * j * mu * 4 for j in range(s))
    return power + chain + s * mu * 12 + s * (2 * mu * mu + 4 * mu)


def log_ptxas(name: str) -> None:
    """ptxas's registers and spills for each kernel of library ``name``,
    from the build this process ran (-Xptxas -v). ``flash_attention`` must
    report a ``wgmma`` instance at each of ``dispatch``'s
    FLASH_WGMMA_HEAD_DIMS."""
    import re
    from repro_torch.kernels import _build, dispatch
    out = _build.BUILD_LOG.get(name)
    if out is None:
        log(f"  {name}: built before this process; no ptxas report")
        return
    entry, spill, wgmma_dims = None, "", set()
    for line in out.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = m.group(1)
        elif "spill stores" in line:
            spill = line.strip()
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            dim = re.search(r"Li(\d+)E", entry)
            dim = dim.group(1) if dim else "?"
            prec = "f64" if re.search(r"kernelId", entry) else "f32"
            if name == "spmm":
                body = f"{prec} col_groups={dim}"
            elif name == "svm_inner":
                body = (f"warp {prec} rows/lane={dim}" if "warp" in entry
                        else f"block {prec} G " + (
                            "smem" if "Lb1E" in entry else "global"))
            elif name == "sa_inner":
                body = ("probe" if "probe" in entry else
                        f"warp {prec} rows/lane={dim}" if "warp" in entry
                        else f"block {prec} G " + (
                            "smem" if "Lb1E" in entry else "global"))
            elif name == "gram":
                kind = re.search(r"(gram_[a-z]+_kernel)I(\w)", entry)
                prec = "f64" if kind.group(2) == "d" else "f32"
                body = (f"{kind.group(1)} N={dim}" if "wgmma" in entry
                        else f"{kind.group(1)} {prec}")
            else:
                body = ("wgmma bf16" if "wgmma" in entry else
                        "simt f32" if "kernelIf" in entry else
                        "simt bf16") + f" D={dim}"
                if "wgmma" in entry:
                    wgmma_dims.add(int(dim))
            log(f"  ptxas {name} {body}: {m.group(1)} registers; {spill}")
            if ("wgmma" in entry or name == "sa_inner") \
                    and ", 0 bytes spill stores" not in spill:
                raise AssertionError(f"ptxas: {name} {body} spills: {spill}")
            entry = None
    if name == "flash_attention" \
            and wgmma_dims != set(dispatch.FLASH_WGMMA_HEAD_DIMS):
        raise AssertionError(f"ptxas: flash_attention wgmma instances at D "
                             f"{sorted(wgmma_dims)}, dispatch routes "
                             f"{dispatch.FLASH_WGMMA_HEAD_DIMS}")


def check_close(name, got, want, rtol, atol):
    import torch
    err = float((got - want).abs().max())
    ok = bool(torch.allclose(got, want, rtol=rtol, atol=atol))
    log(f"  {name}: max_abs_err {err:.3e} (rtol {rtol:g}, atol {atol:.3g})"
        f" {'ok' if ok else 'FAIL'}")
    if not ok or not torch.isfinite(got).all():
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version (max abs err {err:.3e})")
    return err


# ---------------------------------------------------------------------------
# Phase 1: every kernel against its plain version.
# ---------------------------------------------------------------------------

def inner_inputs(s, mu, n_ids, dtype, gen):
    import torch
    dev = "cuda"
    G0 = torch.randn(256, s * mu, generator=gen, device=dev, dtype=dtype)
    G = (G0.T @ G0).contiguous()
    yp, zp = (torch.randn(s, mu, generator=gen, device=dev, dtype=dtype)
              for _ in range(2))
    zv = 0.1 * torch.randn(s, mu, generator=gen, device=dev, dtype=dtype)
    idx = torch.randint(0, n_ids, (s, mu), generator=gen, device=dev)
    th = torch.linspace(0.5, 0.01, s, device=dev, dtype=dtype)
    coefU = (1.0 - 250.0 * th) / (th * th)
    return G, yp, zp, zv, idx, th, coefU


def random_ell(R, C, per_row, gen, dtype, empty_rows=0):
    """(vals, idx, blocks) of an (R, C) blocked-ELL operand with about
    ``per_row`` distinct ascending column ids per row (rows < empty_rows
    have none), made on the card."""
    import torch
    from repro_torch.core.types import SparseOperand
    nnz = max(1, int(R * per_row))
    keys = torch.unique(torch.randint(0, R * C, (nnz,), generator=gen,
                                      device="cuda"))
    keys = keys[keys // C >= empty_rows]
    op = SparseOperand.from_coo(
        keys // C, keys % C,
        torch.randn(keys.numel(), generator=gen, device="cuda",
                    dtype=dtype), (R, C))
    return op.row_vals, op.row_cols, op.row_blocks


def gram_case(name, fn, want, route, rtol, atol):
    """One call of K1 against its plain version: the body it took must be
    ``route``, and a second call must give the same bits."""
    import torch
    from repro_torch.kernels.gram import gram_t
    before = dict(gram_t.route_launches)
    got = fn()
    torch.cuda.synchronize()
    took = [r for r, n in gram_t.route_launches.items() if n != before[r]]
    if took != [route]:
        raise AssertionError(f"gram {name}: took {took}, route {route}")
    err = check_close(f"gram {name} ({route})", got, want, rtol, atol)
    if not torch.equal(got, fn()):
        raise AssertionError(f"gram {name}: two calls differ")
    return err


def phase_gram(gen):
    """K1: both bodies against the plain version at the main path's call
    and at edge shapes, the C side's plan against dispatch's, and the
    times of the path's call."""
    import torch
    from repro_torch.kernels import _build, dispatch
    from repro_torch.kernels.gram import gram_fused, gram_t
    from repro_torch.kernels.gram.ops import _declare, _launch
    from repro_torch.kernels.gram.ref import (gram_fused_ref, gram_t_ref,
                                              gram_t_tf32)
    lib = _build.load("gram", _declare)
    log_ptxas("gram")
    got = (lib.gram_wgmma_tile_p(), lib.gram_wgmma_block_k(),
           lib.gram_wgmma_max_vecs())
    want = (dispatch.GRAM_WGMMA_TILE_P, dispatch.GRAM_WGMMA_BLOCK_K,
            dispatch.GRAM_WGMMA_MAX_VECS)
    if got != want:
        raise AssertionError(f"gram wgmma constants: C {got} vs {want}")
    for q in (1, 24, 25, 65, 72, 73, 130, 136, 137, 514):
        if lib.gram_wgmma_tile_n(q) != dispatch.gram_tile_n(q):
            raise AssertionError(f"gram tile of q = {q} differs")
    for same, p, q in ((1, 128, 130), (1, 64, 65), (1, 512, 514),
                       (0, 128, 130), (1, 4, 6), (1, 128, 8)):
        if bool(lib.gram_wgmma_shared(same, p, q)) != \
                dispatch.gram_wgmma_shared(bool(same), p, q):
            raise AssertionError(f"gram sharing differs at {(same, p, q)}")
    for tn in dispatch.GRAM_WGMMA_TILE_NS:
        for sh in (False, True):
            c_bytes = lib.gram_wgmma_smem_bytes(tn, int(sh))
            rings = (lib.gram_wgmma_raw_stages(int(sh)),
                     lib.gram_wgmma_op_stages(int(sh)))
            if c_bytes != dispatch.gram_wgmma_smem_bytes(tn, sh) or \
                    rings != (dispatch.gram_wgmma_raw_stages(sh),
                              dispatch.gram_wgmma_op_stages(sh)):
                raise AssertionError(f"gram smem layout differs at {tn}, "
                                     f"{sh}: C {c_bytes}")
    f32, f64 = torch.float32, torch.float64

    def bar(m):
        return 2e-4, 2e-4 * math.sqrt(m)

    # The path's call: Y (m, s mu) against [Y | ytil | ztil], the vectors
    # as the (2, m) stack the solver passes.
    m, p, k = M_EPS, S * MU, 2
    Y = torch.randn(m, p, generator=gen, device="cuda")
    V = torch.randn(k, m, generator=gen, device="cuda")
    want = gram_fused_ref(Y, V)
    err = gram_case(f"Y^T [Y | V] ({m}, {p}, k={k})",
                    lambda: gram_fused(Y, V), want, "wgmma", *bar(m))
    W = torch.cat([Y, V.T], dim=1)
    emu = float((gram_fused(Y, V) - gram_t_tf32(Y, W)).abs().max())

    def bar_ratio(got):
        # max over entries of |got - want| / (atol + rtol |want|): above 1
        # where check_close's torch.allclose fails
        rtol, atol = bar(m)
        return float(((got - want).abs() / (atol + rtol * want.abs())).max())
    ratio, one_ratio = bar_ratio(gram_fused(Y, V)), \
        bar_ratio(gram_t_tf32(Y, W, passes=1))
    log(f"  gram path call vs the 3xTF32 emulation: max_abs_err {emu:.3e};"
        f" max err / limit: the kernel {ratio:.4f}, the 1xTF32 emulation "
        f"{one_ratio:.4f}")
    # The bar must tell the kernel from one that drops the lo terms.
    if one_ratio <= 1.0:
        raise AssertionError(f"gram: 1xTF32 meets K1's bar at m = {m}")
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("torch.matmul would time TF32, not f32")
    ms = time_ms(lambda: gram_fused(Y, V), 20)
    row = {
        "name": "gram", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/gram.cu",
        "replaces": "src/repro/kernels/gram/kernel.py:48",
        "max_abs_err": err, "ms": ms,
        "plain_ms": time_ms(lambda: gram_fused_ref(Y, V), 20),
        "library_ms": time_ms(lambda: torch.matmul(Y.T, W), 20)}
    # Least time for the same f32-accurate work: Y and V read once, the
    # output written once; three TF32 products on the tensor cores for
    # the entries the function needs: G's upper half (it is symmetric)
    # and P.
    q = p + k
    entries = p * (p + 1) // 2 + p * k
    row["bound_ms"], row["bound_by"] = bound_ms(
        (m * p + k * m + p * q) * 4, 3 * 2.0 * m * entries, TF32_FLOPS)
    ops_ms = 3 * 2.0 * m * entries / TF32_FLOPS * 1e3
    fma = 2.0 * m * p * q / F32_FLOPS * 1e3
    row["device_ms"] = device_ms(lambda: gram_fused(Y, V), 20)
    simt_ms = time_ms(lambda: _launch(Y, Y, V, route="simt"), 20)
    cat_ms = time_ms(lambda: torch.matmul(Y.T, torch.cat([Y, V.T], 1)), 20)
    log(f"  gram path call: wgmma {ms:.4f} ms (device "
        f"{fmt_ms(row['device_ms'])}), simt body {simt_ms:.4f}, "
        f"torch.matmul {row['library_ms']:.4f} (with the cat "
        f"{cat_ms:.4f}); bound {row['bound_ms']:.4f} ms by "
        f"{row['bound_by']} (3xTF32 on {entries} entries at "
        f"{TF32_FLOPS / 1e12:g} TFLOP/s {ops_ms:.4f}; f32 FMA on all "
        f"{p * q} {fma:.4f})")
    # x^T y at the path's shape: q = 130 is not whole 16-byte rows, so
    # the simt body serves it.
    x, y = Y, W.contiguous()
    gram_case(f"x^T y ({m}, {p}, {q})", lambda: gram_t(x, y),
              gram_t_ref(x, y), dispatch.gram_route(f32, m, p, q), *bar(m))
    b_xy, _ = bound_ms((m * p + m * q + p * q) * 4, 2.0 * m * p * q)
    xy_ms = time_ms(lambda: gram_t(x, y), 20)
    mm_ms = time_ms(lambda: torch.matmul(x.T, y), 20)
    log(f"  gram x^T y ({m}, {p}, {q}): {xy_ms:.4f} ms, torch.matmul "
        f"{mm_ms:.4f}, f32-FMA bound {b_xy:.4f}")
    del Y, V, W, x, y, want
    # Edge shapes (f32): the fused call at s 64, mu 8 (A not shared: four
    # tiles of p and of q); the dense SVM's Y^T [Y | x] over epsilon's
    # 2,000 features; m below one 32-row stage; p = 1; x^T y at p = 257
    # (simt) and p = 256 (wgmma, the 24-wide tile); Y^T Y (A shared, no
    # vectors); more vectors than the wgmma body takes.
    for m, p, k in ((M_EPS, 512, 2), (N_EPS, 64, 1), (20, 128, 2),
                    (1000, 1, 1), (5000, 128, 0), (3000, 64, 9)):
        Y = torch.randn(m, p, generator=gen, device="cuda")
        V = torch.randn(k, m, generator=gen, device="cuda")
        route = dispatch.gram_route(f32, m, p, p + k, y_cols=p)
        if k:
            gram_case(f"Y^T [Y | V] ({m}, {p}, k={k})",
                      lambda: gram_fused(Y, V), gram_fused_ref(Y, V),
                      route, *bar(m))
        else:
            gram_case(f"Y^T Y ({m}, {p})", lambda: gram_t(Y, Y),
                      gram_t_ref(Y, Y), route, *bar(m))
    for (m, p, q), dtype in (((513, 257, 3), f32), ((513, 256, 4), f32),
                             ((513, 257, 3), f64)):
        x = torch.randn(m, p, generator=gen, device="cuda", dtype=dtype)
        y = torch.randn(m, q, generator=gen, device="cuda", dtype=dtype)
        tol = bar(m) if dtype == f32 else (1e-12, 1e-12)
        gram_case(f"{dtype} x^T y ({m}, {p}, {q})", lambda: gram_t(x, y),
                  gram_t_ref(x, y), dispatch.gram_route(dtype, m, p, q),
                  *tol)
    Y = torch.randn(8192, S * MU, generator=gen, device="cuda", dtype=f64)
    V = torch.randn(2, 8192, generator=gen, device="cuda", dtype=f64)
    gram_case("f64 Y^T [Y | V] (8192, 128, k=2)", lambda: gram_fused(Y, V),
              gram_fused_ref(Y, V), "simt", 1e-12, 1e-12)
    # f32 views TMA cannot describe: one element into fresh storage (a
    # start 4 bytes past 16-byte alignment) goes to the simt body, which
    # reads scalars; a column slice (not contiguous) is copied first and
    # keeps the wgmma body.
    m, p = 20_000, S * MU
    buf = torch.randn(m * p + 1, generator=gen, device="cuda")
    x = buf[1:].view(m, p)
    y = torch.randn(m, p, generator=gen, device="cuda")
    gram_case(f"x^T y ({m}, {p}, {p}), x at element offset 1",
              lambda: gram_t(x, y), gram_t_ref(x, y), "simt", *bar(m))
    gram_case(f"x^T x ({m}, {p}) at element offset 1", lambda: gram_t(x, x),
              gram_t_ref(x, x), "simt", *bar(m))
    w = torch.randn(m, p + 1, generator=gen, device="cuda")[:, :p]
    gram_case(f"x^T x ({m}, {p}), a column slice of rows of {p + 1}",
              lambda: gram_t(w, w), gram_t_ref(w, w), "wgmma", *bar(m))
    return row


def sync_step_ms(lib):
    """(ms per step, ms per empty launch) of ``sync_step_probe`` in
    ``csrc/sa_inner.cu``: 2^14 rounds of a shuffle reduction and a block
    barrier against none, back to back by CUDA events."""
    import ctypes
    import torch
    fn = lib.sync_step_probe
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty(1, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def run(steps):
        rc = fn(steps, out.data_ptr(), 0, stream)
        if rc:
            raise RuntimeError(f"sync_step_probe: CUDA error {rc}")
    n = 1 << 14
    empty = time_ms(lambda: run(0), 200, 5)
    return (time_ms(lambda: run(n), 20, 2) - empty) / n, empty


def sa_inner_call(ins, kw, body):
    """One K2 call through ``body`` (the route's, via the public wrapper,
    or forced): checks that it took that body -> (dz, eta)."""
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.sa_inner import sa_inner_loop
    from repro_torch.kernels.sa_inner.ops import _launch
    s, mu = ins[1].shape
    before = dict(sa_inner_loop.route_launches)
    out = (sa_inner_loop(*ins, **kw)
           if body == dispatch.sa_inner_route(s, mu, ins[0].element_size())
           else _launch(*ins, kw["q"], kw["lam1"], kw["lam2"],
                        kw["power_iters"], route=body))
    took = [r for r, n in sa_inner_loop.route_launches.items()
            if n != before[r]]
    if took != [body]:
        raise AssertionError(f"sa_inner ({s}, {mu}) took {took}, not {body}")
    return out


def phase_sa_inner(gen):
    """K2's two bodies against the plain version: the C side's layouts,
    power-warp count and route against dispatch's; every case through
    the body the route picks and, where that is the warp body, the block
    body too (forced), each twice (the same bits); an all-zero diagonal
    block (the tiny floor) and the warp body at its f32 cap (238, 1);
    then the times at the paths' (16, 8) f32. Returns the kernel row."""
    import torch
    from repro_torch.kernels import _build, dispatch
    from repro_torch.kernels.sa_inner import sa_inner_loop
    from repro_torch.kernels.sa_inner.ops import _declare
    from repro_torch.kernels.sa_inner.ref import sa_inner_ref
    lib = _build.load("sa_inner", _declare)
    for s, mu, isz in ((16, 8, 4), (64, 8, 4), (16, 8, 8), (238, 1, 4),
                       (239, 1, 4), (168, 1, 8), (169, 1, 8), (2, 32, 4),
                       (3, 5, 4), (7, 20, 8), (85, 3, 4), (1, 1, 8)):
        for g in (True, False):
            want = dispatch.sa_inner_smem_bytes(s, mu, isz, g)
            got = lib.sa_inner_smem_bytes(s, mu, isz, int(g))
            if got != want:
                raise AssertionError(f"sa_inner smem layout differs: C {got}"
                                     f" vs dispatch {want} at {(s, mu, isz)}")
        got = (lib.sa_inner_warp_smem_bytes(s, mu, isz),
               lib.sa_inner_power_warps(s, mu),
               "warp" if lib.sa_inner_warp_fits(s, mu, isz) else "block")
        if got != (dispatch.sa_inner_warp_smem_bytes(s, mu, isz),
                   dispatch.sa_inner_power_warps(s, mu),
                   dispatch.sa_inner_route(s, mu, isz)):
            raise AssertionError(f"sa_inner warp layout / power warps / "
                                 f"route differ: C {got} at {(s, mu, isz)}")
    f32, f64 = torch.float32, torch.float64
    kw = dict(q=250.0, lam1=0.05, lam2=0.01, power_iters=32)
    # (s, mu, dtype, ids drawn from 0..n_ids-1, all-zero diagonal block)
    for s, mu, dtype, n_ids, zero in ((16, 8, f32, 2000, None),
                                      (16, 8, f32, 12, None),
                                      (16, 8, f32, 2000, 5),
                                      (64, 8, f32, 2000, None),
                                      (4, 1, f32, 4, None),
                                      (238, 1, f32, 4000, None),
                                      (239, 1, f32, 4000, None),
                                      (3, 5, f32, 64, None),
                                      (2, 32, f32, 12, None),
                                      (7, 20, f32, 50, None),
                                      (4, 1, f64, 4, None),
                                      (16, 8, f64, 2000, None),
                                      (16, 8, f64, 2000, 5),
                                      (168, 1, f64, 4000, None),
                                      (7, 20, f64, 50, None)):
        ins = inner_inputs(s, mu, n_ids, dtype, gen)
        if zero is not None:
            G, yp, zp = ins[0], ins[1], ins[2]
            G[zero * mu:(zero + 1) * mu, :] = 0.0
            G[:, zero * mu:(zero + 1) * mu] = 0.0
            yp[zero] = 0.0
            zp[zero] = 0.0
        isz = ins[0].element_size()
        route = dispatch.sa_inner_route(s, mu, isz)
        where = "smem" if dispatch.sa_inner_g_in_smem(s, mu, isz) \
            else "global"
        dz_r, eta_r = sa_inner_ref(*ins, **kw)
        tol = (1e-4, 1e-5) if dtype == f32 else (1e-12, 1e-12)
        name = f"sa_inner {dtype} (s={s}, mu={mu}, ids < {n_ids}" + (
            f", block {zero} all zero)" if zero is not None else ")")
        etas = {}
        for body in ("warp", "block") if route == "warp" else ("block",):
            dz, eta = sa_inner_call(ins, kw, body)
            tag = "warp" if body == "warp" else f"block, G {where}"
            e = check_close(f"{name} [{tag}] dz", dz, dz_r, *tol)
            check_close(f"{name} [{tag}] eta", eta, eta_r, tol[0], 0.0)
            dz2, eta2 = sa_inner_call(ins, kw, body)
            if not (torch.equal(dz, dz2) and torch.equal(eta, eta2)):
                raise AssertionError(f"{name} [{body}]: two calls differ")
            etas[body] = eta
            if zero is not None and not (
                    float(eta[zero]) == 1.0 / torch.finfo(dtype).tiny):
                raise AssertionError(f"{name}: eta of the zero block "
                                     f"{float(eta[zero])}, not 1 / tiny")
            if (s, mu, dtype, n_ids, zero, body) == (
                    S, MU, f32, 2000, None, "warp"):
                row_ins, err = ins, e
        if len(etas) == 2:
            log(f"  {name}: the two bodies' eta equal bit for bit: "
                f"{torch.equal(etas['warp'], etas['block'])}")
    ins = row_ins
    smu = S * MU
    nbytes = smu * smu * 4 + 3 * smu * 4 + smu * 8 + 2 * S * 4 \
        + smu * 4 + S * 4
    b, why = bound_ms(nbytes, sa_inner_flops(S, MU, 32))
    row = {"name": "sa_inner", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/sa_inner.cu",
           "replaces": "src/repro/kernels/sa_inner/kernel.py:91",
           "max_abs_err": err,
           "ms": time_ms(lambda: sa_inner_loop(*ins, **kw), 200, 5),
           "plain_ms": time_ms(lambda: sa_inner_ref(*ins, **kw), 5, 1),
           "device_ms": device_ms(lambda: sa_inner_loop(*ins, **kw)),
           "bound_ms": b, "bound_by": why, "library_ms": None}
    block_ms = time_ms(lambda: sa_inner_call(ins, kw, "block"), 200, 5)
    block_dev = device_ms(lambda: sa_inner_call(ins, kw, "block"))
    log(f"  sa_inner (s={S}, mu={MU}) f32 [warp]: {row['ms']:.4f} ms, device "
        f"{fmt_ms(row['device_ms'])}; block body {block_ms:.4f} ms, device "
        f"{fmt_ms(block_dev)}; plain {row['plain_ms']:.4f}")
    return row


def phase_kernels():
    import torch
    from repro_torch.kernels import _build, dispatch
    from repro_torch.kernels.sa_inner.ops import _declare as inner_declare

    log("phase 1: kernels against their plain versions")
    t0 = time.perf_counter()
    names = ["gram", "sa_inner", "spmm", "svm_inner", "flash_attention"]
    _build.build(names)                     # one nvcc per source, together
    log(f"  built {', '.join(names)} in {time.perf_counter() - t0:.1f} s")
    for name in ("flash_attention", "spmm", "svm_inner", "sa_inner"):
        log_ptxas(name)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    rows = {}

    rows["gram"] = phase_gram(gen)
    flash_offset_case(gen)

    rows["sa_inner"] = phase_sa_inner(gen)
    lib = _build.load("sa_inner", inner_declare)

    # The latency bound of sa_inner (s = 16) and svm_inner (s = 64): the
    # inner steps form one dependent chain, each step at least one warp
    # shuffle reduction and one block barrier in a block of 16 warps.
    step, empty = sync_step_ms(lib)
    PROBE["step_ms"] = step
    log(f"  latency probe: {step * 1e3:.4f} us per step (shuffle reduction "
        f"+ block barrier, 16 warps), empty launch {empty:.4f} ms; latency "
        f"bounds sa_inner (s={S}) {S * step:.6f} ms, svm_inner "
        f"(s={S_SVM}) {S_SVM * step:.6f} ms, power_iter_max_eig (K0: 32 "
        f"iterations and the Rayleigh quotient, {K0_ROUNDS} dependent "
        f"rounds) {K0_ROUNDS * step:.6f} ms")

    phase_spmm_sweep(gen)
    phase_svm_inner_sweep(gen)
    for r in rows.values():
        log(f"  {r['name']}: {r['ms']:.4f} ms (device "
            f"{fmt_ms(r['device_ms'])}; plain {r['plain_ms']:.4f} ms, bound "
            f"{r['bound_ms']:.5f} ms by {r['bound_by']}, library "
            f"{r['library_ms']})")
    torch.cuda.synchronize()
    return rows


def empty_ell(R, K, dtype):
    """(vals, idx, blocks) of R ELL rows of width K with no active block
    (padded slots: index 0, value 0), made on the card."""
    import torch
    return (torch.zeros(R, K, device="cuda", dtype=dtype),
            torch.zeros(R, K, device="cuda", dtype=torch.int32),
            torch.zeros(R, device="cuda", dtype=torch.int32))


def spmm_case(name, vals, idx, blocks, D, tol):
    """One ``ell_spmm`` call against its plain version; a second call must
    give the same bits (the cluster sums in a fixed order)."""
    import torch
    from repro_torch.kernels.spmm import ell_spmm
    from repro_torch.kernels.spmm.ref import ell_spmm_ref
    got = ell_spmm(vals, idx, blocks, D)
    err = check_close(name, got, ell_spmm_ref(vals, idx, D), *tol)
    if not torch.equal(got, ell_spmm(vals, idx, blocks, D)):
        raise AssertionError(f"spmm {name}: two calls differ")
    return err


def phase_spmm_sweep(gen):
    """K4 against its plain version: the SVM path's shape (64 rows of ~455
    slots, D 1,355,191 x 65) and its classical call (R = 1, Q = 2), the
    url Lasso path's (128 of ~86, D 2,396,130 x 130), the
    test_spmm_kernel_sweep shapes, R = 1 with Q = 2, two q tiles (Q =
    300), every column-group instance at f32 and f64, rows with no slots
    and all rows empty; the C side's constants against dispatch's."""
    import torch
    from repro_torch.kernels import _build, dispatch
    from repro_torch.kernels.spmm.ops import _declare
    lib = _build.load("spmm", _declare)
    got = (lib.spmm_q_tile(), lib.spmm_warps(), lib.spmm_max_splits())
    want = (dispatch.SPMM_Q_TILE, dispatch.SPMM_WARPS,
            dispatch.SPMM_MAX_SPLITS)
    if got != want:
        raise AssertionError(f"spmm constants: C {got} vs dispatch {want}")
    log(f"  spmm: {dispatch.SPMM_WARPS} warps a block, clusters of up to "
        f"{dispatch.SPMM_MAX_SPLITS}, D-row reads in flight per warp by "
        f"column groups: " + ", ".join(
            f"{g}: {lib.spmm_in_flight(g)}" for g in range(1, 9)))
    f32, f64 = torch.float32, torch.float64
    for R, C, Q, per_row, dtype, empty in (
            (64, N_NEWS, S_SVM + 1, F_NEWS * N_NEWS, f32, 0),
            (1, N_NEWS, 2, F_NEWS * N_NEWS, f32, 0),
            (S * MU, M_URL, S * MU + 2, F_URL * M_URL, f32, 0),
            (12, 40, 5, 12, f32, 0),
            (33, 128, 17, 6.4, f32, 0),
            (64, 200, 1, 100, f32, 0),
            (7, 16, 130, 6.4, f32, 0),
            (1, 50, 2, 10, f32, 0),
            (40, 3000, 300, 12, f32, 5),
            (7, 16, 130, 6.4, f64, 2),
            (S * MU, M_URL, S * MU + 2, F_URL * M_URL, f64, 0)):
        vals, idx, blocks = random_ell(R, C, per_row, gen, dtype, empty)
        D = torch.randn(C, Q, generator=gen, device="cuda", dtype=dtype)
        plan = dispatch.spmm_plan(R, idx.shape[1], Q)
        tol = (1e-4, 1e-4) if dtype == f32 else (1e-12, 1e-12)
        spmm_case(f"spmm {dtype} R={R} K={idx.shape[1]} C={C} Q={Q}"
                  f"{f' ({empty} empty rows)' if empty else ''} [col_groups "
                  f"{plan.col_groups}, q_tiles {plan.q_tiles}, splits "
                  f"{plan.splits}]", vals, idx, blocks, D, tol)
        del D
    # Every column-group instance (1-8 groups of 32), f32 and f64.
    for dtype in (f32, f64):
        tol = (1e-4, 1e-4) if dtype == f32 else (1e-12, 1e-12)
        for Q in (29, 61, 93, 125, 157, 189, 221, 256):
            vals, idx, blocks = random_ell(5, 3000, 200, gen, dtype)
            D = torch.randn(3000, Q, generator=gen, device="cuda",
                            dtype=dtype)
            plan = dispatch.spmm_plan(5, idx.shape[1], Q)
            spmm_case(f"spmm {dtype} R=5 K={idx.shape[1]} Q={Q} [col_groups "
                      f"{plan.col_groups}, splits {plan.splits}]", vals, idx,
                      blocks, D, tol)
    for R, K, Q, dtype in ((3, 16, 65, f32), (1, 8, 2, f64)):
        vals, idx, blocks = empty_ell(R, K, dtype)
        D = torch.randn(40, Q, generator=gen, device="cuda", dtype=dtype)
        spmm_case(f"spmm {dtype} R={R} K={K} Q={Q}, every row empty", vals,
                  idx, blocks, D, (0.0, 0.0))


def phase_svm_inner_sweep(gen):
    """K3's two bodies against the plain version: where the warp body
    serves, the block body too (forced); shapes on both sides of the
    warp body's caps (mu = 32 | 33; s mu at its shared-memory limit, f32
    and f64); G in global memory; ids from 0..11 so blocks collide; hinge
    (nu = 1) and squared hinge (nu = inf); the C side's two layouts
    against dispatch's."""
    import torch
    from repro_torch.kernels import _build, dispatch
    from repro_torch.kernels.svm_inner import svm_inner_loop
    from repro_torch.kernels.svm_inner.ops import _declare, _launch
    from repro_torch.kernels.svm_inner.ref import svm_inner_ref
    lib = _build.load("svm_inner", _declare)
    for s, mu, isz in ((64, 1, 4), (16, 8, 4), (64, 8, 4), (16, 8, 8),
                       (238, 1, 4), (167, 1, 8), (2, 32, 4), (237, 1, 4),
                       (166, 1, 8)):
        for g in (True, False):
            want = dispatch.svm_inner_smem_bytes(s, mu, isz, g)
            got = lib.svm_inner_smem_bytes(s, mu, isz, int(g))
            if got != want:
                raise AssertionError(f"svm_inner smem layout differs: C "
                                     f"{got} vs dispatch {want} at "
                                     f"{(s, mu, isz)}")
        got = lib.svm_inner_warp_smem_bytes(s, mu, isz)
        if got != dispatch.svm_inner_warp_smem_bytes(s, mu, isz):
            raise AssertionError(f"svm_inner warp layout differs: C {got} at "
                                 f"{(s, mu, isz)}")
    f32, f64 = torch.float32, torch.float64
    # (s, mu, dtype, route, G in shared memory for the block body)
    for s, mu, dtype, route, smem in ((64, 1, f32, "warp", True),
                                      (16, 8, f32, "warp", True),
                                      (3, 5, f32, "warp", True),
                                      (2, 32, f32, "warp", True),
                                      (2, 33, f32, "block", True),
                                      (237, 1, f32, "warp", True),
                                      (238, 1, f32, "block", True),
                                      (64, 8, f32, "block", False),
                                      (64, 1, f64, "warp", True),
                                      (16, 8, f64, "warp", True),
                                      (166, 1, f64, "warp", True),
                                      (167, 1, f64, "block", True),
                                      (64, 8, f64, "block", False)):
        isz = 4 if dtype == f32 else 8
        if dispatch.svm_inner_route(s, mu, isz) != route or \
                dispatch.svm_inner_g_in_smem(s, mu, isz) != smem:
            raise AssertionError(f"svm_inner ({s}, {mu}) route / G placement")
        tol_th = (1e-4, 1e-5) if dtype == f32 else (1e-12, 1e-12)
        tol_dl = (1e-4, 1e-4) if dtype == f32 else (1e-12, 1e-12)
        bodies = ("warp", "block") if route == "warp" else ("block",)
        for nu in (1.0, float("inf")):
            ins = svm_inputs(s, mu, 12, dtype, gen)
            th_r, dl_r = svm_inner_ref(*ins, 0.3, nu)
            for body in bodies:
                before = dict(svm_inner_loop.route_launches)
                th, dl = (svm_inner_loop(*ins, gamma=0.3, nu=nu)
                          if body == route else
                          _launch(*ins, 0.3, nu, 32, route=body))
                took = [r for r, n in svm_inner_loop.route_launches.items()
                        if n != before[r]]
                if took != [body]:
                    raise AssertionError(f"svm_inner ({s}, {mu}) took {took}")
                where = "smem" if body == "warp" or smem else "global"
                check_close(f"svm_inner {dtype} (s={s}, mu={mu}, nu={nu}) "
                            f"[{body}, G {where}] theta", th, th_r, *tol_th)
                check_close(f"svm_inner {dtype} (s={s}, mu={mu}, nu={nu}) "
                            f"[{body}] dual increments", dl, dl_r, *tol_dl)


def flash_offset_case(gen):
    """K5 on bf16 q, k, v one element into fresh storage (2 bytes past
    16-byte alignment): each is copied into aligned storage, and the
    wgmma body runs on the copies."""
    import torch
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref
    shape = (1, 4, 256, 128)
    n = math.prod(shape)
    q, k, v = (torch.randn(n + 1, generator=gen, device="cuda").mul(
        0.3).to(torch.bfloat16)[1:].view(shape) for _ in range(3))
    before = dict(flash_attention.route_launches)
    out = flash_attention(q, k, v)
    taken = {r: c - before[r] for r, c in
             flash_attention.route_launches.items() if c != before[r]}
    if taken != {"wgmma": 1}:
        raise AssertionError(f"flash_attention offset views: {taken}")
    check_close(f"flash_attention bf16 {shape} at element offset 1 (copied) "
                f"[wgmma]", out.float(),
                attention_ref(q, k, v).float(), 0.0, 2e-2)


def svm_inputs(s, mu, n_ids, dtype, gen):
    import torch
    dev = "cuda"
    G0 = torch.randn(64, s * mu, generator=gen, device=dev, dtype=dtype)
    G = (G0.T @ G0 + 0.5 * torch.eye(s * mu, device=dev,
                                     dtype=dtype)).contiguous()
    proj = torch.randn(s, mu, generator=gen, device=dev, dtype=dtype)
    b = torch.where(torch.randn(s, mu, generator=gen, device=dev) < 0,
                    -1.0, 1.0).to(dtype)
    a_vals = 0.2 * torch.rand(s, mu, generator=gen, device=dev, dtype=dtype)
    idx = torch.randint(0, n_ids, (s, mu), generator=gen, device=dev)
    return G, proj, b, a_vals, idx


# ---------------------------------------------------------------------------
# Phase 2: the main path at full data size.
# ---------------------------------------------------------------------------

def epsilon_problem(seed: int):
    """A dense Lasso at the shape of LIBSVM epsilon, made on the card by the
    make_lasso_dataset recipe: planted 32-sparse x, noise 0.1,
    lam = 0.1 ||A^T b||_inf."""
    import torch
    from repro_torch.api import LassoProblem
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    A = torch.randn(M_EPS, N_EPS, generator=gen, device="cuda")
    support = torch.randperm(N_EPS, generator=gen, device="cuda")[:32]
    x_true = torch.zeros(N_EPS, device="cuda")
    x_true[support] = torch.randn(32, generator=gen, device="cuda")
    b = A @ x_true + 0.1 * torch.randn(M_EPS, generator=gen, device="cuda")
    lam = 0.1 * float((A.T @ b).abs().max())
    return LassoProblem(A=A, b=b, lam=lam)


class PhaseTimer:
    """CUDA event pairs around named callables: device time per phase.
    The first call's arguments of each are kept in ``first`` (unless
    ``keep_first=False``: a training step's would hold its buffers)."""

    def __init__(self):
        self.events = {}
        self.first = {}

    def wrap(self, name, fn, keep_first: bool = True):
        import torch

        def timed(*args, **kw):
            if keep_first:
                self.first.setdefault(name, (args, kw))
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = fn(*args, **kw)
            e1.record()
            self.events.setdefault(name, []).append((e0, e1))
            return out
        return timed

    def totals_ms(self):
        import torch
        torch.cuda.synchronize()
        return {k: sum(a.elapsed_time(b) for a, b in v)
                for k, v in self.events.items()}


def phase_main_path():
    import dataclasses
    import inspect
    import torch
    from repro_torch import api
    from repro_torch.core import engine, sa_lasso
    from repro_torch.kernels import sa_inner
    from repro_torch.kernels.gram import gram_t
    from repro_torch.kernels.sa_inner import ops as sa_inner_ops

    log(f"phase 2: main path, dense Lasso {M_EPS} x {N_EPS} f32, "
        f"SA-accBCD mu={MU} s={S} H={H}")
    problem = epsilon_problem(seed=0)
    cfg = api.SolverConfig(block_size=MU, s=S, iterations=H)
    outer = cfg.outer_iterations

    zero_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = api.solve(problem, cfg)
    obj = res.objective.cpu()
    wall = time.perf_counter() - t0
    counts = read_counts()
    LOCAL["epsilon"] = (res.x.cpu(), obj)
    bodies = dict(gram_t.route_launches)
    k2_bodies = dict(sa_inner.sa_inner_loop.route_launches)
    launches = {"gram": counts["gram"], "sa_inner": counts["sa_inner"]}
    peak = torch.cuda.max_memory_allocated()
    log(f"  launches in the solve: {counts} (expected {outer} each of "
        f"gram and sa_inner); gram by body {bodies} (expected {outer} "
        f"wgmma); sa_inner by body {k2_bodies} (expected {outer} warp)")
    log(f"  objective {float(obj[0]):.6g} -> {float(obj[-1]):.6g}; "
        f"inner_impl {res.aux['inner_impl']}")
    log(f"  wall {wall:.4f} s, {wall / outer * 1e3:.4f} ms per outer "
        f"iteration; peak device memory {peak / 2**30:.3f} GiB")
    if counts != {"gram": outer, "sa_inner": outer, "spmm": 0,
                  "svm_inner": 0, "flash_attention": 0}:
        raise AssertionError(f"main path launches {counts}, expected "
                             f"{outer} of gram and sa_inner")
    if bodies != {"wgmma": outer, "simt": 0}:
        raise AssertionError(f"gram bodies {bodies}, expected {outer} "
                             f"wgmma")
    if k2_bodies != {"warp": outer, "block": 0}:
        raise AssertionError(f"sa_inner bodies {k2_bodies}, expected "
                             f"{outer} warp")
    # Accelerated BCD is not a descent method: allow rises of 1e-2 of the
    # start within a trace that falls overall.
    rise = float((obj[1:] - obj[:-1]).max() / obj[0])
    log(f"  largest one-step rise {rise:.3e} of the starting objective")
    if not (torch.isfinite(obj).all() and obj[-1] < obj[0] and rise < 1e-2):
        raise AssertionError("objective trace not finite and falling")
    if res.aux["inner_impl"] != "cuda":
        raise AssertionError(f"inner loop ran as {res.aux['inner_impl']}")

    classical = api.solve(problem, dataclasses.replace(cfg, s=1))
    obj_c = classical.objective.cpu()
    dev = float(((obj - obj_c).abs() / obj_c.abs()).max())
    log(f"  SA vs classical accBCD (s=1): max rel objective deviation "
        f"{dev:.3e} (bar 1e-3)")
    if not dev <= 1e-3:
        raise AssertionError(f"SA and classical traces differ: {dev:.3e}")

    # Steady state: five more solves, untraced, host clock around each.
    walls = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        api.solve(problem, cfg)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) / outer * 1e3)
    log(f"  steady solves: ms per outer iteration "
        f"{' '.join(f'{w:.4f}' for w in walls)} (median "
        f"{sorted(walls)[2]:.4f})")

    # Where each outer iteration's time goes: CUDA events around the
    # engine's phases and the kernels inside them, on one more solve.
    timer = PhaseTimer()
    prog = sa_lasso._ACC_PROGRAM
    wrapped = dataclasses.replace(
        prog, **{k: timer.wrap(k, getattr(prog, k)) for k in
                 ("assemble", "reduce", "inner", "defer", "finalize")})
    saved = (engine.sample_all, sa_lasso.gram_local,
             sa_inner.sa_inner_loop, sa_lasso.deferred_steps)
    engine.sample_all = timer.wrap("sample", saved[0])
    sa_lasso.gram_local = timer.wrap(GRAM_PHASE, saved[1])
    sa_inner.sa_inner_loop = timer.wrap("sa_inner kernel", saved[2])
    sa_lasso.deferred_steps = timer.wrap("deferred GEMVs", saved[3])
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.run_program(wrapped, problem, cfg)
        torch.cuda.synchronize()
        wall2 = time.perf_counter() - t0
    finally:
        (engine.sample_all, sa_lasso.gram_local, sa_inner.sa_inner_loop,
         sa_lasso.deferred_steps) = saved
    tot = timer.totals_ms()
    split = {
        "sample (threefry + sort)": tot["sample"],
        "gather Y = A[:, blocks]": tot["assemble"] - tot[GRAM_PHASE],
        GRAM_PHASE: tot[GRAM_PHASE],
        "reduce (G, P views)": tot["reduce"],
        "sa_inner kernel": tot["sa_inner kernel"],
        "inner rest (gather z, index_add)": tot["inner"]
        - tot["sa_inner kernel"],
        "deferred GEMVs": tot["deferred GEMVs"],
        "objective stitching": tot["defer"] - tot["deferred GEMVs"],
        "finalize": tot["finalize"],
    }
    log(f"  where the time goes (device time per outer iteration, traced "
        f"solve wall {wall2 / outer * 1e3:.4f} ms/outer):")
    for k, v in split.items():
        log(f"    {k:36s} {v / outer:.4f} ms")
    args, kw = timer.first["sa_inner kernel"]
    k2 = device_ms(lambda: sa_inner.sa_inner_loop(*args, **kw))
    call = inspect.signature(sa_inner.sa_inner_loop).bind(*args, **kw)
    call.apply_defaults()
    k2_block = device_ms(lambda: sa_inner_ops._launch(*call.args,
                                                      route="block"))
    log(f"  sa_inner on the path's inputs: device {fmt_ms(k2)} ms per call "
        f"[warp]; the block body on the same inputs {fmt_ms(k2_block)}")
    return launches, k2


# ---------------------------------------------------------------------------
# Phase 3: f64 on the card against the CPU.
# ---------------------------------------------------------------------------

def phase_f64():
    import torch
    from repro_torch import api
    from repro_torch.data.sparse import make_lasso_dataset
    from repro_torch.kernels import sa_inner
    from repro_torch.kernels.gram import gram_t

    log("phase 3: f64 epsilon-like (8192 x 512) on the card vs the CPU")
    out = {}
    for device in ("cuda", "cpu"):
        A, b, lam_max = make_lasso_dataset("epsilon-like", seed=0,
                                           device=device)
        cfg = api.SolverConfig(block_size=MU, s=S, iterations=128,
                               dtype=torch.float64, device=device)
        zero_counts()
        out[device] = api.solve(api.LassoProblem(A=A, b=b,
                                                 lam=0.1 * lam_max), cfg)
        if device == "cuda":
            n = (gram_t.launches, sa_inner.sa_inner_loop.launches,
                 gram_t.route_launches["simt"],
                 sa_inner.sa_inner_loop.route_launches["warp"])
            if n != (8, 8, 8, 8):
                raise AssertionError(f"f64 solve launches {n}, expected 8 "
                                     f"(gram all simt, sa_inner all warp)")
    o_gpu = out["cuda"].objective.cpu()
    o_cpu = out["cpu"].objective
    dev = float(((o_gpu - o_cpu).abs() / o_cpu.abs()).max())
    dx = float((out["cuda"].x.cpu() - out["cpu"].x).abs().max())
    log(f"  max rel objective deviation {dev:.3e}, max |dx| {dx:.3e} "
        f"(bar 1e-8)")
    if not (dev <= 1e-8 and dx <= 1e-8):
        raise AssertionError("f64 card solve differs from the CPU solve")


# ---------------------------------------------------------------------------
# Phases 4-6: the sparse paths.
# ---------------------------------------------------------------------------

def sparse_coo_on_card(m, n, f, gen):
    """Duplicate-free COO triplets of an (m, n) matrix of density about f
    with standard normal values, made on the card by the data makers'
    recipe: uniform nonzero positions, at least one nonzero per column."""
    import torch
    keys = torch.unique(torch.randint(0, m * n, (round(m * n * f),),
                                      generator=gen, device="cuda"))
    rows, cols = keys // n, keys % n
    del keys
    empty = torch.nonzero(torch.bincount(cols, minlength=n) == 0).flatten()
    rows = torch.cat([rows, torch.randint(0, m, (empty.numel(),),
                                          generator=gen, device="cuda")])
    cols = torch.cat([cols, empty])
    # A draw of exactly 0 is a stored zero, which SparseOperand.shard
    # keeps: the one-rank shard is this operand (phase 11 checks it).
    vals = torch.randn(rows.numel(), generator=gen, device="cuda")
    return rows, cols, vals


def news20_problem(seed: int):
    """A sparse linear SVM-L1 at the shape of LIBSVM news20.binary, made
    on the card by the make_svm_dataset recipe: a planted unit w and
    b = sign(A w + 0.1 noise)."""
    import torch
    from repro_torch.api import SparseOperand, SVMProblem
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    A = SparseOperand.from_coo(*sparse_coo_on_card(M_NEWS, N_NEWS, F_NEWS,
                                                   gen), (M_NEWS, N_NEWS))
    w = torch.randn(N_NEWS, generator=gen, device="cuda")
    w /= torch.linalg.vector_norm(w)
    b = torch.sign(A.matvec(w) + 0.1 * torch.randn(M_NEWS, generator=gen,
                                                   device="cuda"))
    b[b == 0] = 1.0
    return SVMProblem(A=A, b=b, lam=1.0, loss="l1")


def url_problem(seed: int):
    """A sparse Lasso at the shape of LIBSVM url, made on the card by the
    make_lasso_dataset recipe with k_sparse = K_URL: planted K_URL-sparse
    x, noise 0.1, lam = 0.1 ||A^T b||_inf."""
    import torch
    from repro_torch.api import LassoProblem, SparseOperand
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    A = SparseOperand.from_coo(*sparse_coo_on_card(M_URL, N_URL, F_URL,
                                                   gen), (M_URL, N_URL))
    x_true = torch.zeros(N_URL, device="cuda")
    x_true[torch.randperm(N_URL, generator=gen, device="cuda")[:K_URL]] = \
        torch.randn(K_URL, generator=gen, device="cuda")
    b = A.matvec(x_true) + 0.1 * torch.randn(M_URL, generator=gen,
                                             device="cuda")
    return LassoProblem(A=A, b=b, lam=0.1 * float(A.rmatvec(b).abs().max()))


def counters():
    from repro_torch.kernels import sa_inner, spmm, svm_inner
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.gram import gram_t
    return {"gram": gram_t, "sa_inner": sa_inner.sa_inner_loop,
            "spmm": spmm.ell_spmm, "svm_inner": svm_inner.svm_inner_loop,
            "flash_attention": flash_attention}


def zero_counts():
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.gram import gram_t
    for fn in counters().values():
        fn.launches = 0
    from repro_torch.kernels.sa_inner import sa_inner_loop
    from repro_torch.kernels.svm_inner import svm_inner_loop
    flash_attention.route_launches.update(wgmma=0, simt=0)
    gram_t.route_launches.update(wgmma=0, simt=0)
    svm_inner_loop.route_launches.update(warp=0, block=0)
    sa_inner_loop.route_launches.update(warp=0, block=0)


def read_counts():
    return {k: fn.launches for k, fn in counters().items()}


def check_trace(obj, obj_c, what, descent: bool, momentum: bool = False):
    """A finite trace that falls (by at most 1e-2 of its start at a step
    for an accelerated method; not at all beyond roundoff for dual
    descent; end to end only for SFISTA's subspace momentum, which is
    not a descent method at any bar) and matches the classical trace
    within rel 1e-3."""
    import torch
    steps = obj[1:] - obj[:-1]
    scale = float(obj.abs().max())
    rise = float(steps.max()) / scale
    log(f"  {what}: objective {float(obj[0]):.6g} -> {float(obj[-1]):.6g}; "
        f"largest one-step rise {rise:.3e} of max |objective|")
    bar = math.inf if momentum else 1e-5 if descent else 1e-2
    if not (torch.isfinite(obj).all() and obj[-1] < obj[0] and rise < bar):
        raise AssertionError(f"{what}: trace not finite and falling")
    dev = float(((obj - obj_c).abs()
                 / torch.clamp(obj_c.abs(), min=1e-3 * scale)).max())
    log(f"  {what}: SA vs classical (s=1) max rel deviation {dev:.3e} "
        f"(bar 1e-3)")
    if not dev <= 1e-3:
        raise AssertionError(f"{what}: SA and classical traces differ")


def bodies_now():
    """Launches by body of K1, K2 and K3, under "<kernel> <body>" keys."""
    out = {}
    for name in ("gram", "sa_inner", "svm_inner"):
        out.update({f"{name} {k}": v for k, v in
                    counters()[name].route_launches.items()})
    return out


def solve_counted(problem, cfg, want, want_bodies=None):
    """The main path of a phase: one solve with every count set to 0 just
    before and read just after; raises unless the launches equal
    ``want``, the launches by body those of ``want_bodies`` (keys of
    ``bodies_now``), and every kernel the solve reports (``inner_impl``,
    ``spmm_impl``) ran as CUDA. Returns (result, trace on the CPU,
    launches)."""
    import torch
    from repro_torch import api
    zero_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = api.solve(problem, cfg)
    obj = res.objective.cpu()
    wall = time.perf_counter() - t0
    got, bodies = read_counts(), bodies_now()
    impls = {k: res.aux[k] for k in ("inner_impl", "spmm_impl")
             if k in res.aux}
    outer = cfg.outer_iterations
    log(f"  launches in the solve: {got} (expected {want})"
        + (f"; by body {bodies} (expected {want_bodies})"
           if want_bodies else ""))
    log(f"  wall {wall:.4f} s, {wall / outer * 1e3:.4f} ms per outer "
        f"iteration (first solve); peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; {impls}")
    if got != want or any(bodies[k] != n
                          for k, n in (want_bodies or {}).items()):
        raise AssertionError(f"launches {got}, bodies {bodies}; expected "
                             f"{want}, {want_bodies}")
    if any(v != "cuda" for v in impls.values()):
        raise AssertionError(f"a kernel ran as its plain version: {impls}")
    return res, obj, got


def steady(problem, cfg, n=5):
    import torch
    from repro_torch import api
    walls = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        api.solve(problem, cfg)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) / cfg.outer_iterations * 1e3)
    log(f"  steady solves: ms per outer iteration "
        f"{' '.join(f'{w:.4f}' for w in walls)} (median "
        f"{sorted(walls)[n // 2]:.4f})")
    return sorted(walls)[n // 2]


def traced(prog, problem, cfg, patches):
    """One more solve of ``prog`` with CUDA events around its callbacks and
    around each (owner, attribute, label) of ``patches``; returns the
    PhaseTimer and the solve's wall time."""
    import dataclasses
    import torch
    from repro_torch.core import engine
    timer = PhaseTimer()
    wrapped = dataclasses.replace(
        prog, **{k: timer.wrap(k, getattr(prog, k)) for k in
                 ("assemble", "reduce", "inner", "defer", "finalize")})
    saved = [(o, a, getattr(o, a)) for o, a, _ in patches]
    for (o, a, label), (_, _, fn) in zip(patches, saved):
        setattr(o, a, timer.wrap(label, fn))
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.run_program(wrapped, problem, cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        for o, a, fn in saved:
            setattr(o, a, fn)
    return timer, wall


def log_split(split, outer, wall):
    log(f"  where the time goes (device time per outer iteration, traced "
        f"solve wall {wall / outer * 1e3:.4f} ms/outer):")
    for k, v in split.items():
        log(f"    {k:36s} {v / outer:.4f} ms")


def spmm_row(args, kw):
    """The spmm kernel row on the arguments the main path gave it: error
    and time against the plain version, ``torch.sparse.mm`` on a CSR
    tensor of the same rows, and the bound from the slots this call
    reads (active nonzeros, the distinct D rows they touch)."""
    import torch
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.spmm import ell_spmm
    from repro_torch.kernels.spmm.ref import ell_spmm_ref
    vals, idx, blocks, D = args
    ell_block = kw.get("ell_block", 8)
    (R, K), (C, Q) = vals.shape, D.shape
    active = torch.arange(K, device="cuda")[None, :] \
        < blocks[:, None] * ell_block
    nnz = int(active.sum())
    touched = int(torch.unique(idx[active]).numel())
    isz = D.element_size()
    nbytes = nnz * (4 + isz) + R * 4 + touched * Q * isz + R * Q * isz
    b, why = bound_ms(nbytes, 2.0 * nnz * Q)
    out = ell_spmm(*args, **kw)
    err = check_close(f"spmm on the path's inputs (R={R} K={K} C={C} "
                      f"Q={Q}, {nnz} active slots)", out,
                      ell_spmm_ref(vals, idx, D), 1e-4, 1e-4)
    if not torch.equal(out, ell_spmm(*args, **kw)):
        raise AssertionError("spmm on the path's inputs: two calls differ")
    crow = torch.zeros(R + 1, dtype=torch.int64, device="cuda")
    crow[1:] = torch.cumsum(active.sum(1), 0)
    csr = torch.sparse_csr_tensor(crow, idx[active].to(torch.int64),
                                  vals[active], size=(R, C))
    lib_err = float((torch.sparse.mm(csr, D) - out).abs().max())
    row = {"name": "spmm", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/spmm.cu",
           "replaces": "src/repro/kernels/spmm/kernel.py:62",
           "max_abs_err": err,
           "plain_ms": time_ms(lambda: ell_spmm_ref(vals, idx, D), 3, 1),
           "bound_ms": b, "bound_by": why}
    # The kernel and torch.sparse.mm in turns, three rounds; medians.
    timed = {"ms": lambda: ell_spmm(*args, **kw),
             "library_ms": lambda: torch.sparse.mm(csr, D)}
    rounds = {name: [] for name in timed}
    for _ in range(3):
        for name, fn in timed.items():
            rounds[name].append(time_ms(fn, 50, 3))
    row.update({name: sorted(ts)[1] for name, ts in rounds.items()})
    row["device_ms"] = device_ms(lambda: ell_spmm(*args, **kw))
    lib_dev = device_ms(lambda: torch.sparse.mm(csr, D))
    plan = dispatch.spmm_plan(R, K, Q, torch.cuda.get_device_properties(
        0).multi_processor_count)
    dev = row["device_ms"]
    log(f"  spmm at this shape: {row['ms']:.4f} ms, device {fmt_ms(dev)} "
        f"({fmt_ms(dev and dev / b)}x the bound; {plan}); "
        f"torch.sparse.mm {row['library_ms']:.4f} ms, device "
        f"{fmt_ms(lib_dev)} [max abs diff {lib_err:.2e}]; plain "
        f"{row['plain_ms']:.4f}; bound {b:.5f} ms by {why}: "
        f"{nbytes / 1e6:.2f} MB, {2.0 * nnz * Q / 1e6:.2f} MFLOP (rounds, "
        f"ms: " + "; ".join(f"{n} {' '.join(f'{t:.4f}' for t in ts)}"
                            for n, ts in rounds.items()) + ")")
    return row


def svm_inner_row(args, kw):
    """The svm_inner kernel row on the arguments the main path gave it:
    the body the route picks against the plain version, its time through
    the wrapper and on the device alone, and the block body's beside it."""
    import torch
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.svm_inner import svm_inner_loop
    from repro_torch.kernels.svm_inner.ops import _launch
    from repro_torch.kernels.svm_inner.ref import svm_inner_ref
    G, proj, b_sel, a_vals, idx = args
    s, mu = proj.shape
    smu, isz = s * mu, G.element_size()
    th, dl = svm_inner_loop(*args, **kw)
    th_r, dl_r = svm_inner_ref(*args, kw["gamma"], kw["nu"],
                               kw["power_iters"])
    err = check_close(f"svm_inner on the path's inputs (s={s}, mu={mu}) "
                      f"theta", th, th_r, 1e-4, 1e-5)
    check_close("svm_inner on the path's inputs dual increments", dl, dl_r,
                1e-4, 1e-4)
    nbytes = (smu * smu + 3 * smu + smu + s) * isz + smu * 8
    b, why = bound_ms(nbytes, svm_inner_flops(s, mu, kw["power_iters"]))
    row = {"name": "svm_inner", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/svm_inner.cu",
           "replaces": "src/repro/kernels/svm_inner/kernel.py:91",
           "max_abs_err": err,
           "ms": time_ms(lambda: svm_inner_loop(*args, **kw), 200, 5),
           "plain_ms": time_ms(lambda: svm_inner_ref(
               *args, kw["gamma"], kw["nu"], kw["power_iters"]), 3, 1),
           "device_ms": device_ms(lambda: svm_inner_loop(*args, **kw)),
           "bound_ms": b, "bound_by": why, "library_ms": None}
    route = dispatch.svm_inner_route(s, mu, isz)
    block = (*args, kw["gamma"], kw["nu"], kw["power_iters"])
    th_b, dl_b = _launch(*block, route="block")
    check_close("the block body on the same inputs, theta", th_b, th_r,
                1e-4, 1e-5)
    check_close("the block body on the same inputs, dual increments",
                dl_b, dl_r, 1e-4, 1e-4)
    block_ms = time_ms(lambda: _launch(*block, route="block"), 200, 5)
    block_dev = device_ms(lambda: _launch(*block, route="block"))
    step = PROBE.get("step_ms")
    lat = None if step is None else s * step
    ratio = None if lat is None or row["device_ms"] is None \
        else row["device_ms"] / lat
    log(f"  svm_inner at this shape [{route}]: {row['ms']:.4f} ms, device "
        f"{fmt_ms(row['device_ms'])} ({fmt_ms(ratio)}x the latency bound "
        f"{fmt_ms(lat)} ms of {s} probe steps); block body "
        f"{block_ms:.4f} ms, device {fmt_ms(block_dev)}; plain "
        f"{row['plain_ms']:.4f}; bound {b:.6f} ms by {why}")
    return row


def phase_svm():
    import dataclasses
    import importlib
    import torch
    from repro_torch import api
    from repro_torch.core import engine, sparse_exec
    from repro_torch.kernels import spmm, svm_inner
    # (the package's name sa_svm is the solver function, as in repro)
    sa_svm = importlib.import_module("repro_torch.core.sa_svm")

    log(f"phase 4: sparse SVM path, news20.binary shape {M_NEWS} x "
        f"{N_NEWS} f32, SVM-L1 SA-BDCD mu=1 s={S_SVM} H={H_SVM}")
    t0 = time.perf_counter()
    problem = news20_problem(seed=0)
    torch.cuda.synchronize()
    A = problem.A
    log(f"  operand made on the card in {time.perf_counter() - t0:.2f} s: "
        f"nnz {A.nnz}, row ELL {tuple(A.row_cols.shape)}, column ELL "
        f"{tuple(A.col_rows.shape)}")
    cfg = api.SolverConfig(block_size=1, s=S_SVM, iterations=H_SVM)
    outer = cfg.outer_iterations
    res, obj, launches = solve_counted(
        problem, cfg, {"gram": 0, "sa_inner": 0, "spmm": outer,
                       "svm_inner": outer, "flash_attention": 0})
    LOCAL["news20"] = obj
    bodies = dict(svm_inner.svm_inner_loop.route_launches)
    log(f"  svm_inner by body {bodies} (expected {outer} warp)")
    if bodies != {"warp": outer, "block": 0}:
        raise AssertionError(f"svm_inner bodies {bodies}, expected {outer} "
                             f"warp")
    classical = api.solve(problem, dataclasses.replace(cfg, s=1))
    check_trace(obj, classical.objective.cpu(), "dual trace", descent=True)
    steady(problem, cfg)

    prog = sa_svm._BDCD_PROGRAM
    timer, wall = traced(prog, problem, cfg, [
        (engine, "sample_all", "sample"),
        (type(A), "gather_rows", "take"),
        (sparse_exec, "_fused_rhs", "densify"),
        (spmm, "ell_spmm", "spmm"),
        (svm_inner, "svm_inner_loop", "svm_inner")])
    tot = timer.totals_ms()
    log_split({
        "sample (threefry + sort)": tot["sample"],
        "take (gather ELL rows)": tot["take"],
        "densify D = [Y^T | x]": tot["densify"],
        "spmm kernel": tot["spmm"],
        "assemble rest": tot["assemble"] - tot["take"] - tot["densify"]
        - tot["spmm"],
        "reduce (+ gamma I)": tot["reduce"],
        "svm_inner kernel": tot["svm_inner"],
        "inner rest (gather b, alpha)": tot["inner"] - tot["svm_inner"],
        "alpha / x updates + trace": tot["defer"],
        "finalize": tot["finalize"],
    }, outer, wall)
    rows = {"spmm": spmm_row(*timer.first["spmm"]),
            "svm_inner": svm_inner_row(*timer.first["svm_inner"])}
    return rows, launches


def phase_url():
    import dataclasses
    import torch
    from repro_torch import api
    from repro_torch.core import engine, sa_lasso, sparse_exec
    from repro_torch.kernels import sa_inner, spmm

    log(f"phase 5: sparse Lasso path, url shape {M_URL} x {N_URL} f32, "
        f"SA-accBCD mu={MU} s={S} H={H}")
    t0 = time.perf_counter()
    problem = url_problem(seed=0)
    torch.cuda.synchronize()
    A = problem.A
    ell_bytes = sum(t.numel() * t.element_size() for t in (
        A.row_cols, A.row_vals, A.row_blocks, A.col_rows, A.col_vals,
        A.col_blocks))
    log(f"  operand made on the card in {time.perf_counter() - t0:.2f} s: "
        f"nnz {A.nnz}, row ELL {tuple(A.row_cols.shape)}, column ELL "
        f"{tuple(A.col_rows.shape)}, {ell_bytes / 1e9:.3f} GB of ELL arrays")
    cfg = api.SolverConfig(block_size=MU, s=S, iterations=H)
    outer = cfg.outer_iterations
    res, obj, launches = solve_counted(
        problem, cfg, {"gram": 0, "sa_inner": outer, "spmm": outer,
                       "svm_inner": 0, "flash_attention": 0})
    bodies = dict(sa_inner.sa_inner_loop.route_launches)
    log(f"  sa_inner by body {bodies} (expected {outer} warp)")
    if bodies != {"warp": outer, "block": 0}:
        raise AssertionError(f"sa_inner bodies {bodies}, expected {outer} "
                             f"warp")
    classical = api.solve(problem, dataclasses.replace(cfg, s=1))
    check_trace(obj, classical.objective.cpu(), "objective", descent=False)
    del classical
    steady(problem, cfg)

    timer, wall = traced(sa_lasso._ACC_PROGRAM, problem, cfg, [
        (engine, "sample_all", "sample"),
        (type(A), "gather_cols", "take"),
        (sparse_exec, "_fused_rhs", "densify"),
        (spmm, "ell_spmm", "spmm"),
        (sa_inner, "sa_inner_loop", "sa_inner"),
        (sa_lasso, "deferred_steps", "deferred")])
    tot = timer.totals_ms()
    log_split({
        "sample (threefry + sort)": tot["sample"],
        "take (gather ELL columns)": tot["take"],
        "densify D = [Y | ytil | ztil]": tot["densify"],
        "spmm kernel": tot["spmm"],
        "assemble rest": tot["assemble"] - tot["take"] - tot["densify"]
        - tot["spmm"],
        "reduce (G, P views)": tot["reduce"],
        "sa_inner kernel": tot["sa_inner"],
        "inner rest (gather z, index_add)": tot["inner"] - tot["sa_inner"],
        "deferred scatter-adds": tot["deferred"],
        "objective stitching": tot["defer"] - tot["deferred"],
        "finalize": tot["finalize"],
    }, outer, wall)
    spmm_row(*timer.first["spmm"])
    return launches


def phase_f64_sparse():
    import torch
    from repro_torch import api
    from repro_torch.data.sparse import make_lasso_dataset, make_svm_dataset

    log("phase 6: f64 sparse solves on the card vs the CPU (SVM rcv1-like "
        "mu=4 s=8 H=256; Lasso news20-like mu=8 s=16 H=128)")
    out = {}
    for device in ("cuda", "cpu"):
        A, b = make_svm_dataset("rcv1-like", 0, as_operand=True,
                                device=device)
        zero_counts()
        svm = api.solve(api.SVMProblem(A=A, b=b), api.SolverConfig(
            block_size=4, s=8, iterations=256, dtype=torch.float64,
            device=device))
        got_svm = read_counts()
        A, b, lam_max = make_lasso_dataset("news20-like", 0, as_operand=True,
                                           device=device)
        zero_counts()
        lasso = api.solve(api.LassoProblem(A=A, b=b, lam=0.1 * lam_max),
                          api.SolverConfig(block_size=MU, s=S,
                                           iterations=128,
                                           dtype=torch.float64,
                                           device=device))
        got_lasso = read_counts()
        got_lasso["sa_inner warp"] = counters()[
            "sa_inner"].route_launches["warp"]
        if device == "cuda":
            want_svm = {"gram": 0, "sa_inner": 0, "spmm": 32,
                        "svm_inner": 32, "flash_attention": 0}
            want_lasso = {"gram": 0, "sa_inner": 8, "spmm": 8,
                          "svm_inner": 0, "flash_attention": 0,
                          "sa_inner warp": 8}
            if (got_svm, got_lasso) != (want_svm, want_lasso):
                raise AssertionError(f"f64 sparse launches {got_svm}, "
                                     f"{got_lasso}")
        out[device] = (svm, lasso)
    for i, what in enumerate(("SVM", "Lasso")):
        g, c = out["cuda"][i], out["cpu"][i]
        o_g, o_c = g.objective.cpu(), c.objective
        dev = float(((o_g - o_c).abs() / o_c.abs()).max())
        dx = float((g.x.cpu() - c.x).abs().max())
        extra = float((g.aux["alpha"].cpu() - c.aux["alpha"]).abs().max()) \
            if what == "SVM" else 0.0
        log(f"  {what}: max rel objective deviation {dev:.3e}, max |dx| "
            f"{dx:.3e}{f', max |dalpha| {extra:.3e}' if extra else ''} "
            f"(bar 1e-8; scatter-adds are atomics on the card)")
        if not (dev <= 1e-8 and dx <= 1e-8 and extra <= 1e-8):
            raise AssertionError(f"f64 sparse {what} card solve differs "
                                 f"from the CPU solve")


# ---------------------------------------------------------------------------
# Phase 12 (run after phase 6): the kernel SVM, logistic regression and
# SFISTA families at full width.
# ---------------------------------------------------------------------------

KSVM_GAMMA = 0.1                # rbf's width: the registry's CLI default
MU_K, S_K, H_K = 4, 16, 1024    # ksvm run 2 and logreg: s mu = 64
LAM_LOGREG = 1e-3               # the logreg family's CLI default


def ksvm_problem(svm):
    """The news20.binary SVM of phase 4 with the rbf kernel."""
    import dataclasses
    return dataclasses.replace(svm, kernel="rbf",
                               kernel_params={"gamma": KSVM_GAMMA})


def logreg_problem(svm):
    """Logistic regression on the news20.binary data of phase 4."""
    from repro_torch.api import LogRegProblem
    return LogRegProblem(A=svm.A, b=svm.b, lam=LAM_LOGREG)


def sfista_problem(lasso):
    """CA-SFISTA on the epsilon Lasso data of phase 2 (its lam)."""
    from repro_torch.api import SFISTAProblem
    return SFISTAProblem(A=lasso.A, b=lasso.b, lam=lasso.lam)


def gram_k1_row(args, kw):
    """K1 on CA-SFISTA's call Y^T [Y | ry] (k = 1 vector): error against
    the plain version, its time through the wrapper and on the device,
    the plain version's, ``torch.matmul`` on the concatenated operand,
    and the bound (Y and ry read once, the output written once; 3xTF32
    products for G's upper half and P)."""
    import torch
    from repro_torch.kernels.gram import gram_fused, gram_t
    from repro_torch.kernels.gram.ref import gram_fused_ref
    Y, V = args
    (m, p), k = Y.shape, V.shape[0]
    before = dict(gram_t.route_launches)
    out = gram_fused(Y, V)
    took = [r for r, n in gram_t.route_launches.items() if n != before[r]]
    err = check_close(f"gram on CA-SFISTA's inputs (m={m}, p={p}, k={k}; "
                      f"{took})", out, gram_fused_ref(Y, V), 2e-4,
                      2e-4 * math.sqrt(m))
    if took != ["wgmma"]:
        raise AssertionError(f"gram on CA-SFISTA's inputs took {took}")
    W = torch.cat([Y, V.T], dim=1)
    entries = p * (p + 1) // 2 + p * k
    b, why = bound_ms((m * p + k * m + p * (p + k)) * 4,
                      3 * 2.0 * m * entries, TF32_FLOPS)
    row = {"name": "gram (CA-SFISTA: Y^T [Y | ry], k = 1)", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/gram.cu",
           "replaces": "src/repro/kernels/gram/kernel.py:48",
           "max_abs_err": err,
           "ms": time_ms(lambda: gram_fused(Y, V), 20),
           "device_ms": device_ms(lambda: gram_fused(Y, V), 20),
           "plain_ms": time_ms(lambda: gram_fused_ref(Y, V), 20),
           "library_ms": time_ms(lambda: torch.matmul(Y.T, W), 20),
           "bound_ms": b, "bound_by": why}
    log(f"  gram at CA-SFISTA's call: {row['ms']:.4f} ms, device "
        f"{fmt_ms(row['device_ms'])}; plain {row['plain_ms']:.4f}; "
        f"torch.matmul on [Y | ry] {row['library_ms']:.4f}; bound "
        f"{b:.4f} ms by {why}")
    return row


def phase_families():
    """Phase 12: SA-K-BDCD (rbf) and SA-BCD logistic regression on the
    news20.binary shape, CA-SFISTA on the epsilon shape."""
    import importlib
    import dataclasses
    import torch
    from repro_torch import api
    from repro_torch.core import engine, kernel_svm, linalg
    from repro_torch.kernels import spmm, svm_inner
    from repro_torch.kernels.spmm.ref import ell_spmm_ref
    # (the package's names sa_logreg and sfista are the solver functions,
    # as in repro)
    sa_logreg = importlib.import_module("repro_torch.core.sa_logreg")
    sfista_mod = importlib.import_module("repro_torch.core.sfista")
    rows, launches, summary = {}, {}, {}

    log(f"phase 12: the kernel SVM, logistic regression and SFISTA "
        f"families: news20.binary {M_NEWS} x {N_NEWS} (ksvm rbf gamma "
        f"{KSVM_GAMMA}, SVM-L1; logreg lam {LAM_LOGREG}) and epsilon "
        f"{M_EPS} x {N_EPS} (CA-SFISTA), f32")
    t0 = time.perf_counter()
    svm = news20_problem(seed=0)
    torch.cuda.synchronize()
    A = svm.A
    log(f"  news20.binary made on the card in {time.perf_counter() - t0:.2f}"
        f" s: nnz {A.nnz}, row ELL {tuple(A.row_cols.shape)}")
    none = {"gram": 0, "sa_inner": 0, "spmm": 0, "svm_inner": 0,
            "flash_attention": 0}
    take_patches = [(engine, "sample_all", "sample"),
                    (type(A), "gather_rows", "take"),
                    (spmm, "scatter_dense", "densify"),
                    (spmm, "ell_spmm", "spmm")]

    ksvm = ksvm_problem(svm)
    for mu, s, iters in ((1, S_SVM, H_SVM), (MU_K, S_K, H_K)):
        what = f"ksvm rbf SA-K-BDCD mu={mu} s={s} H={iters}"
        log(f"  {what}:")
        cfg = api.SolverConfig(block_size=mu, s=s, iterations=iters)
        outer = cfg.outer_iterations
        res, obj, got = solve_counted(
            ksvm, cfg, {**none, "spmm": outer, "svm_inner": outer},
            {"svm_inner warp": outer, "svm_inner block": 0})
        LOCAL[("ksvm", mu)] = {"objective": obj,
                               "alpha": res.aux["alpha"].cpu(),
                               "f": res.aux["f"].cpu(), "x": res.x.cpu()}
        launches[what] = got
        classical = api.solve(ksvm, dataclasses.replace(cfg, s=1))
        check_trace(obj, classical.objective.cpu(), "dual trace",
                    descent=True)
        del classical
        wall = steady(ksvm, cfg)
        log_profile(what, device_profile(lambda: api.solve(ksvm, cfg)),
                    wall, outer)
        timer, traced_wall = traced(
            kernel_svm._SAK_PROGRAM, ksvm, cfg, take_patches + [
                (kernel_svm, "_kernelize", "kernelize"),
                (svm_inner, "svm_inner_loop", "svm_inner")])
        tot = timer.totals_ms()
        split = {
            "sample (threefry + sort)": tot["sample"],
            "take (gather ELL rows)": tot["take"],
            "densify Y^T (n x s mu)": tot["densify"],
            "spmm kernel (A Y^T)": tot["spmm"],
            "assemble rest (norms column)": tot["assemble"] - tot["take"]
            - tot["densify"] - tot["spmm"],
            "kernelize (rbf)": tot["kernelize"],
            "reduce rest (G = K[B] + gamma I)": tot["reduce"]
            - tot["kernelize"],
            "svm_inner kernel": tot["svm_inner"],
            "inner rest (gather f, b, alpha)": tot["inner"]
            - tot["svm_inner"],
            "defer (f GEMV, alpha, x, trace)": tot["defer"],
            "finalize": tot["finalize"],
        }
        log_split(split, outer, traced_wall)
        summary[what] = wall
        k3 = svm_inner_row(*timer.first["svm_inner"])
        k3.update(name=f"svm_inner (ksvm kernel block, s {s}, mu {mu})",
                  launches=outer)
        rows[f"svm_inner ksvm mu{mu}"] = k3
        if mu == 1:
            k4 = spmm_row(*timer.first["spmm"])
            k4.update(name="spmm (ksvm and logreg cross block A Y^T)",
                      launches=outer)
            rows["spmm cross"] = k4
        del timer, res

    logreg = logreg_problem(svm)
    what = f"logreg SA-BCD mu={MU_K} s={S_K} H={H_K}"
    log(f"  {what}:")
    cfg = api.SolverConfig(block_size=MU_K, s=S_K, iterations=H_K)
    outer = cfg.outer_iterations
    res, obj, got = solve_counted(logreg, cfg, {**none, "spmm": outer})
    LOCAL["logreg"] = {"objective": obj, "margins": res.aux["margins"].cpu(),
                       "x": res.x.cpu()}
    launches[what] = got
    classical = api.solve(logreg, dataclasses.replace(cfg, s=1))
    check_trace(obj, classical.objective.cpu(), "objective", descent=False)
    del classical, res
    wall = steady(logreg, cfg)
    log_profile(what, device_profile(lambda: api.solve(logreg, cfg)), wall,
                outer)
    timer, traced_wall = traced(
        sa_logreg._LOGREG_PROGRAM, logreg, cfg, take_patches + [
            (linalg, "power_iteration_max_eig_batched", "power")])
    tot = timer.totals_ms()
    split = {
        "sample (threefry + sort)": tot["sample"],
        "take (gather ELL rows)": tot["take"],
        "densify Y^T (n x s mu)": tot["densify"],
        "spmm kernel (A Y^T)": tot["spmm"],
        "reduce (local: none)": tot["reduce"],
        "power iterations (s blocks, batched)": tot["power"],
        "inner chain (s steps, plain PyTorch)": tot["inner"] - tot["power"],
        "defer (w = rho w + Y^T U)": tot["defer"],
        "finalize": tot["finalize"],
    }
    log_split(split, outer, traced_wall)
    summary[what] = wall
    args, kw = timer.first["spmm"]
    check_close("spmm on logreg's inputs", spmm.ell_spmm(*args, **kw),
                ell_spmm_ref(args[0], args[1], args[3]), 1e-4, 1e-4)
    del timer, args, kw, svm, ksvm, logreg, A
    torch.cuda.empty_cache()

    lasso = epsilon_problem(seed=0)
    problem = sfista_problem(lasso)
    what = f"CA-SFISTA mu={MU} s={S} H={H}"
    log(f"  {what} on epsilon (lam {problem.lam:.6g}):")
    cfg = api.SolverConfig(block_size=MU, s=S, iterations=H)
    outer = cfg.outer_iterations
    res, obj, got = solve_counted(problem, cfg, {**none, "gram": outer},
                                  {"gram wgmma": outer, "gram simt": 0})
    LOCAL["sfista"] = {"objective": obj, "x": res.x.cpu(),
                       "residual": res.aux["residual"].cpu()}
    launches[what] = got
    classical = api.solve(problem, dataclasses.replace(cfg, s=1))
    check_trace(obj, classical.objective.cpu(), "objective", descent=False,
                momentum=True)
    del classical, res
    wall = steady(problem, cfg)
    log_profile(what, device_profile(lambda: api.solve(problem, cfg)), wall,
                outer)
    timer, traced_wall = traced(
        sfista_mod._CA_PROGRAM, problem, cfg, [
            (engine, "sample_all", "sample"),
            (sfista_mod, "gram_local", "gram"),
            (linalg, "power_iteration_max_eig_batched", "power"),
            (sfista_mod, "deferred_steps", "deferred")])
    tot = timer.totals_ms()
    split = {
        "sample (threefry + sort)": tot["sample"],
        "gather Y = A[:, blocks]": tot["assemble"] - tot["gram"],
        "gram kernel (Y^T [Y | ry])": tot["gram"],
        "reduce (G, P views)": tot["reduce"],
        "power iterations (s blocks, batched)": tot["power"],
        "inner chain (s steps, plain PyTorch)": tot["inner"] - tot["power"],
        "deferred GEMVs": tot["deferred"],
        "objective stitching": tot["defer"] - tot["deferred"],
        "finalize": tot["finalize"],
    }
    log_split(split, outer, traced_wall)
    summary[what] = wall
    k1 = gram_k1_row(*timer.first["gram"])
    k1["launches"] = outer
    rows["gram k1"] = k1
    log("  phase 12 summary (steady wall, median of five, ms per outer "
        "iteration): " + "; ".join(f"{k} {w:.4f}"
                                   for k, w in summary.items()))
    log("  phase 12 launches per solve: " + "; ".join(
        f"{k} {{{', '.join(f'{n}: {c}' for n, c in v.items() if c)}}}"
        for k, v in launches.items()))
    return rows


def phase_families_f64():
    """Phase 12 (f64): the three families on the card against the CPU,
    and ksvm's tracked dual against ``kernel_dual_objective``."""
    import dataclasses
    import torch
    from repro_torch import api
    from repro_torch.core.kernel_svm import kernel_dual_objective
    from repro_torch.data.sparse import make_lasso_dataset, make_svm_dataset

    log("phase 12 (f64): card vs CPU, ksvm rbf rcv1-like mu=4 s=8 H=256, "
        "logreg rcv1-like mu=4 s=8 H=256, sparse CA-SFISTA news20-like "
        "mu=8 s=16 H=128")
    none = {"gram": 0, "sa_inner": 0, "spmm": 0, "svm_inner": 0,
            "flash_attention": 0}
    cfg = api.SolverConfig(block_size=4, s=8, iterations=256,
                           dtype=torch.float64)
    out = {}
    for device in ("cuda", "cpu"):
        c = dataclasses.replace(cfg, device=device)
        A, b = make_svm_dataset("rcv1-like", 0, as_operand=True,
                                device=device)
        ksvm = api.SVMProblem(A=A, b=b, kernel="rbf",
                              kernel_params={"gamma": KSVM_GAMMA})
        logreg = api.LogRegProblem(A=A, b=b, lam=LAM_LOGREG)
        A, b, lam_max = make_lasso_dataset("news20-like", 0, as_operand=True,
                                           device=device)
        sf = api.SFISTAProblem(A=A, b=b, lam=0.1 * lam_max)
        sf_cfg = api.SolverConfig(block_size=MU, s=S, iterations=128,
                                  dtype=torch.float64, device=device)
        got = {}
        for name, problem, cf, want in (
                ("ksvm", ksvm, c, {**none, "spmm": 32, "svm_inner": 32}),
                ("logreg", logreg, c, {**none, "spmm": 32}),
                ("sfista", sf, sf_cfg, {**none, "spmm": 8})):
            zero_counts()
            got[name] = api.solve(problem, cf)
            if device == "cuda" and read_counts() != want:
                raise AssertionError(f"f64 {name} launches {read_counts()}, "
                                     f"expected {want}")
        if device == "cuda":
            direct = float(kernel_dual_objective(dataclasses.replace(
                ksvm, A=ksvm.A.to(dtype=torch.float64)),
                got["ksvm"].aux["alpha"]))
            tracked = float(got["ksvm"].aux["dual"])
            dev = abs(tracked - direct) / abs(direct)
            log(f"  ksvm tracked dual {tracked:.15g} against "
                f"kernel_dual_objective {direct:.15g}: rel {dev:.3e} (bar "
                f"1e-8)")
            if not dev <= 1e-8:
                raise AssertionError("ksvm tracked dual differs from the "
                                     "direct one")
        out[device] = got
    for name, vecs in (("ksvm", ("alpha", "f")), ("logreg", ("margins",)),
                       ("sfista", ("residual",))):
        g, c = out["cuda"][name], out["cpu"][name]
        o_g, o_c = g.objective.cpu(), c.objective
        dev = float(((o_g - o_c).abs() / o_c.abs()).max())
        dx = max([float((g.x.cpu() - c.x).abs().max())]
                 + [float((g.aux[k].cpu() - c.aux[k]).abs().max())
                    for k in vecs])
        log(f"  {name}: max rel objective deviation {dev:.3e}, max |dv| "
            f"over x, {', '.join(vecs)} {dx:.3e} (bar 1e-8)")
        if not (dev <= 1e-8 and dx <= 1e-8):
            raise AssertionError(f"f64 {name} card solve differs from the "
                                 f"CPU solve")


# ---------------------------------------------------------------------------
# Phase 11 (run after phase 6): the sharded backend over torch.distributed.
# ---------------------------------------------------------------------------

P_GLOO = 4
# The epsilon path's fused payload: the (s mu, s mu + 2) Gram/projection
# block, f32.
PAYLOAD = (S * MU, S * MU + 2)


def rel_dev(obj, ref):
    """Max relative deviation of a trace from ``ref``, each step against
    max(|ref|, 1e-3 max |ref|) (a dual trace starts near 0)."""
    import torch
    scale = float(ref.abs().max())
    return float(((obj - ref).abs()
                  / torch.clamp(ref.abs(), min=1e-3 * scale)).max())


def solve_reductions(problem, cfg, backend="sharded"):
    """(result, reductions counted, launches, K1 and K2 bodies) of one
    solve, every count set to 0 just before and read just after."""
    import torch
    from repro_torch import api
    from repro_torch.core import linalg
    zero_counts()
    with linalg.count_reductions() as c:
        res = api.solve(problem, cfg, backend=backend)
        torch.cuda.synchronize()
    return res, c.n, read_counts(), bodies_now()


def check_path(what, reductions, got, bodies, want, want_bodies, outer,
               say=log):
    say(f"  {what}: {reductions} reductions (expected {outer}); launches "
        f"{got}; bodies {bodies}")
    if reductions != outer:
        raise AssertionError(f"{what}: {reductions} reductions, expected "
                             f"{outer}")
    if got != want or any(bodies[k] != n for k, n in want_bodies.items()):
        raise AssertionError(f"{what}: launches {got}, bodies {bodies}; "
                             f"expected {want}, {want_bodies}")


def split_solve(owner, attr, problem, cfg, backend, patches):
    """One more solve through ``api.solve(..., backend=)`` with CUDA events
    around the callbacks of the program ``owner.attr``, each all-reduce
    (``linalg.preduce``; with gloo, host staging and the wait for the
    other ranks included), the end-of-solve gathers and each (owner,
    attribute, label) of ``patches`` -> (device ms per outer iteration by
    phase, the traced solve's wall per outer iteration)."""
    import dataclasses
    import torch
    from repro_torch import api
    from repro_torch.core import linalg
    timer = PhaseTimer()
    prog = getattr(owner, attr)
    wrapped = dataclasses.replace(
        prog, **{k: timer.wrap(k, getattr(prog, k)) for k in
                 ("assemble", "reduce", "inner", "defer", "finalize")})
    patches = list(patches) + [(linalg, "preduce", "all-reduce"),
                               (linalg, "pgather", "end gathers")]
    saved = [(o, a, getattr(o, a)) for o, a, _ in patches]
    setattr(owner, attr, wrapped)
    for (o, a, label), (_, _, fn) in zip(patches, saved):
        setattr(o, a, timer.wrap(label, fn))
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        api.solve(problem, cfg, backend=backend)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        setattr(owner, attr, prog)
        for o, a, fn in saved:
            setattr(o, a, fn)
    outer = cfg.outer_iterations
    tot = timer.totals_ms()
    tot.setdefault("end gathers", 0.0)
    return {k: v / outer for k, v in tot.items()}, wall / outer * 1e3


def epsilon_split(problem, cfg, backend, say=log):
    from repro_torch.core import engine, sa_lasso
    from repro_torch.kernels import sa_inner
    t, wall = split_solve(sa_lasso, "_ACC_PROGRAM", problem, cfg, backend, [
        (engine, "sample_all", "sample"),
        (sa_lasso, "gram_local", GRAM_PHASE),
        (sa_inner, "sa_inner_loop", "sa_inner kernel"),
        (sa_lasso, "deferred_steps", "deferred GEMVs")])
    split = {
        "sample (threefry + sort)": t["sample"],
        "gather Y = A[:, blocks]": t["assemble"] - t[GRAM_PHASE],
        GRAM_PHASE: t[GRAM_PHASE],
        "all-reduce": t.get("all-reduce", 0.0),
        "reduce rest (G, P views)": t["reduce"] - t.get("all-reduce", 0.0),
        "sa_inner kernel": t["sa_inner kernel"],
        "inner rest (gather z, index_add)": t["inner"]
        - t["sa_inner kernel"],
        "deferred GEMVs": t["deferred GEMVs"],
        "defer rest": t["defer"] - t["deferred GEMVs"],
        "finalize": t["finalize"],
        "end gathers": t["end gathers"],
    }
    say(f"  where the time goes, {backend}, objective untracked (device "
        f"time per outer iteration; traced solve wall {wall:.4f} ms):")
    for k, v in split.items():
        say(f"    {k:36s} {v:.4f} ms")


def news20_split(problem, cfg, say):
    import importlib
    from repro_torch.core import engine, sparse_exec
    from repro_torch.kernels import spmm, svm_inner
    sa_svm = importlib.import_module("repro_torch.core.sa_svm")
    t, wall = split_solve(sa_svm, "_BDCD_PROGRAM", problem, cfg, "sharded", [
        (engine, "sample_all", "sample"),
        (type(problem.A), "gather_rows", "take"),
        (sparse_exec, "_fused_rhs", "densify"),
        (spmm, "ell_spmm", "spmm"),
        (svm_inner, "svm_inner_loop", "svm_inner")])
    split = {
        "sample (threefry + sort)": t["sample"],
        "take (gather ELL rows)": t["take"],
        "densify D = [Y^T | x]": t["densify"],
        "spmm kernel": t["spmm"],
        "assemble rest": t["assemble"] - t["take"] - t["densify"]
        - t["spmm"],
        "all-reduce": t["all-reduce"],
        "reduce rest (+ gamma I)": t["reduce"] - t["all-reduce"],
        "svm_inner kernel": t["svm_inner"],
        "inner rest (gather b, alpha)": t["inner"] - t["svm_inner"],
        "alpha / x updates": t["defer"],
        "finalize": t["finalize"],
        "end gathers": t["end gathers"],
    }
    say(f"  where the time goes, sharded, objective untracked (device time "
        f"per outer iteration; traced solve wall {wall:.4f} ms):")
    for k, v in split.items():
        say(f"    {k:36s} {v:.4f} ms")


def phase_sharded_nccl():
    """Phase 11 (a): NCCL at world size 1 in this process, on the
    epsilon Lasso of phase 2."""
    import dataclasses
    import statistics
    import torch
    import torch.distributed as dist
    from repro_torch import api
    from repro_torch.core import distributed, linalg

    log(f"phase 11 (a): sharded backend, NCCL at world size 1, dense Lasso "
        f"{M_EPS} x {N_EPS} f32, SA-accBCD mu={MU} s={S} H={H}")
    dist.init_process_group(
        "nccl", init_method=f"tcp://localhost:{distributed.free_port()}",
        world_size=1, rank=0)
    try:
        problem = epsilon_problem(seed=0)
        cfg = api.SolverConfig(block_size=MU, s=S, iterations=H)
        outer = cfg.outer_iterations
        want = {"gram": outer, "sa_inner": outer, "spmm": 0,
                "svm_inner": 0, "flash_attention": 0}
        want_bodies = {"gram wgmma": outer, "sa_inner warp": outer}
        res, tracked, got, bodies = solve_reductions(problem, cfg)
        log(f"  tracked objective: {tracked} reductions (2 per outer "
            f"iteration: the block and the s squared residual norms; the "
            f"CPU test's count is {2 * outer})")
        if tracked != 2 * outer:
            raise AssertionError(f"tracked solve: {tracked} reductions")
        x_l, obj_l = LOCAL["epsilon"]
        same = (torch.equal(res.x.cpu(), x_l),
                torch.equal(res.objective.cpu(), obj_l))
        log(f"  x and trace bit-identical to phase 2's local solve: {same}")
        if not all(same):
            again = api.solve(problem, cfg)
            log(f"  (a second local solve repeats phase 2's bits: "
                f"{torch.equal(again.x.cpu(), x_l)}, "
                f"{torch.equal(again.objective.cpu(), obj_l)})")
            raise AssertionError("sharded at world size 1 differs from the "
                                 "local solve")
        untracked = dataclasses.replace(cfg, track_objective=False)
        _, n, got, bodies = solve_reductions(problem, untracked)
        check_path("untracked solve", n, got, bodies, want, want_bodies,
                   outer)

        walls = {}
        for i in range(6):
            turn = ("local", "sharded") if i % 2 == 0 else ("sharded",
                                                            "local")
            for backend in turn:
                for c in (cfg, untracked):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    api.solve(problem, c, backend=backend)
                    torch.cuda.synchronize()
                    walls.setdefault((backend, c.track_objective), []) \
                        .append((time.perf_counter() - t0) / outer * 1e3)
        for (backend, track), w in walls.items():
            log(f"  steady {backend}, objective "
                f"{'tracked' if track else 'untracked'}: ms per outer "
                f"iteration {' '.join(f'{v:.4f}' for v in w)} (median "
                f"{statistics.median(w):.4f})")
        epsilon_split(problem, untracked, "local")
        epsilon_split(problem, untracked, "sharded")

        buf = torch.randn(PAYLOAD, device="cuda")
        group = dist.group.WORLD
        pairs = []
        for _ in range(220):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            linalg.preduce(buf, group)
            e1.record()
            pairs.append((e0, e1))
        torch.cuda.synchronize()
        ms = [a.elapsed_time(b) for a, b in pairs[20:]]
        log(f"  one NCCL all-reduce of the {PAYLOAD} f32 payload "
            f"({buf.numel() * 4} bytes) through linalg.preduce: median "
            f"{statistics.median(ms):.4f} ms over {len(ms)} calls (CUDA "
            f"events around each; min {min(ms):.4f}, max {max(ms):.4f})")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            linalg.preduce(buf, group)
        host = (time.perf_counter() - t0) / 200 * 1e3
        torch.cuda.synchronize()
        back = (time.perf_counter() - t0) / 200 * 1e3
        # NCCL at world size 1 may launch no kernel at all: no kernel
        # row, so an empty trace reads "not measured" here.
        dev = trace_kernel_ms(lambda: linalg.preduce(buf, group), 50)
        log(f"  the same, 200 back to back: host {host:.4f} ms a call to "
            f"return, {back:.4f} ms a call to the last one's end; device "
            f"{fmt_ms(dev)} ms a call (torch.profiler kernel durations)")
        sharded_families_nccl(problem)
    finally:
        dist.destroy_process_group()


def sharded_families_nccl(lasso):
    """Phase 11 (a), the families of phase 12 at NCCL world size 1: each
    sharded solve against phase 12's local solve, bit for bit, with its
    reductions and launches counted (objective untracked: ceil(H/s);
    tracked: the same for ksvm and logreg, whose traces come from
    replicated data, twice that for CA-SFISTA)."""
    import dataclasses
    import torch
    from repro_torch import api
    from repro_torch.core.sparse_exec import shard_operand
    svm = news20_problem(seed=0)
    A = svm.A
    one = shard_operand(A, 1, 0, A.shape[1])
    log(f"  news20.binary: the one-rank shard's row ELL arrays are the "
        f"operand's: {all(torch.equal(getattr(A, k), getattr(one, k)) for k in ('row_cols', 'row_vals', 'row_blocks'))}")
    del one, A
    none = {"gram": 0, "sa_inner": 0, "spmm": 0, "svm_inner": 0,
            "flash_attention": 0}
    ksvm_outer = H_SVM // S_SVM
    cases = (
        ("ksvm rbf mu=1", ksvm_problem(svm),
         api.SolverConfig(block_size=1, s=S_SVM, iterations=H_SVM),
         LOCAL[("ksvm", 1)], ("alpha", "f"), 1,
         {**none, "spmm": ksvm_outer, "svm_inner": ksvm_outer},
         {"svm_inner warp": ksvm_outer}),
        ("logreg", logreg_problem(svm),
         api.SolverConfig(block_size=MU_K, s=S_K, iterations=H_K),
         LOCAL["logreg"], ("margins",), 1, {**none, "spmm": H_K // S_K},
         {}),
        ("CA-SFISTA", sfista_problem(lasso),
         api.SolverConfig(block_size=MU, s=S, iterations=H),
         LOCAL["sfista"], ("residual",), 2, {**none, "gram": H // S},
         {"gram wgmma": H // S}))
    for what, problem, cfg, local, vecs, per_outer, want, want_bodies \
            in cases:
        outer = cfg.outer_iterations
        log(f"  {what}, sharded at NCCL world size 1:")
        res, tracked, _, _ = solve_reductions(problem, cfg)
        if tracked != per_outer * outer:
            raise AssertionError(f"{what}: {tracked} reductions tracked, "
                                 f"expected {per_outer * outer}")
        _, n, got, bodies = solve_reductions(
            problem, dataclasses.replace(cfg, track_objective=False))
        check_path(f"{what}, untracked", n, got, bodies, want, want_bodies,
                   outer)
        leaves = {"objective": res.objective.cpu(), "x": res.x.cpu(),
                  **{k: res.aux[k].cpu() for k in vecs}}
        same = {k: torch.equal(v, local[k]) for k, v in leaves.items()}
        log(f"  {what}: {tracked} reductions tracked; bit-identical to "
            f"phase 12's local solve: {same}")
        if all(same.values()):
            continue
        again = api.solve(problem, cfg)
        again = {"objective": again.objective.cpu(), "x": again.x.cpu(),
                 **{k: again.aux[k].cpu() for k in vecs}}
        repeat = {k: torch.equal(v, local[k]) for k, v in again.items()}
        log(f"  {what}: a second local solve repeats phase 12's bits: "
            f"{repeat}")
        if all(repeat.values()):
            raise AssertionError(f"{what}: sharded at world size 1 differs "
                                 f"from the local solve")
        dev = max(rel_dev(leaves["objective"], local["objective"]),
                  *(float((leaves[k] - local[k]).abs().max()
                          / local[k].abs().max().clamp(min=1e-30))
                    for k in leaves if k != "objective"))
        log(f"  {what}: the local solve does not repeat its own bits (the "
            f"atomic adds of its scatters); sharded against local: max "
            f"relative deviation {dev:.3e} (bar 1e-5)")
        if not dev <= 1e-5:
            raise AssertionError(f"{what}: sharded differs from local")


def sharded_rank(rank, world):
    """Phase 11 (b), one rank: the epsilon Lasso and the news20.binary
    SVM at full width, sharded over ``world`` gloo ranks on one card, and
    a small f64 Lasso. Every rank checks its own launches, reductions and
    that the replicated state is the same on every rank; rank 0 logs and
    returns what the parent compares."""
    import dataclasses
    import statistics
    import torch
    import torch.distributed as dist
    from repro_torch import api
    from repro_torch.core import linalg
    from repro_torch.data.sparse import make_lasso_dataset
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say = log if rank == 0 else (lambda msg: None)

    def everywhere(t):
        rows = linalg.pgather(t.reshape(1, -1), dist.group.WORLD)
        return all(torch.equal(r, rows[0]) for r in rows)

    def run(what, problem, cfg, want, want_bodies, replicated, payload,
            split):
        outer = cfg.outer_iterations
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = api.solve(problem, cfg, backend="sharded")
        obj = res.objective.cpu()
        first = (time.perf_counter() - t0) / outer * 1e3
        untracked = dataclasses.replace(cfg, track_objective=False)
        _, n, got, bodies = solve_reductions(problem, untracked)
        check_path(f"{what}, rank {rank}", n, got, bodies, want,
                   want_bodies, outer, say)
        same = [everywhere(v) for v in replicated(res) + (res.objective,)]
        say(f"  {what}: replicated state and trace bit-identical on every "
            f"rank: {same}")
        if not all(same):
            raise AssertionError(f"{what}: replicas differ across ranks")
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            api.solve(problem, untracked, backend="sharded")
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) / outer * 1e3)
        split(problem, untracked)
        buf = torch.randn(payload, device="cuda")
        lone = []
        for _ in range(60):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            linalg.preduce(buf, dist.group.WORLD)
            torch.cuda.synchronize()
            lone.append((time.perf_counter() - t0) * 1e3)
        say(f"  {what}: one all-reduce of its {payload} f32 payload alone, "
            f"the ranks back to back (gloo, host-staged): median "
            f"{statistics.median(lone[10:]):.4f} ms over 50")
        say(f"  {what}: ms per outer iteration, first (tracked) "
            f"{first:.4f}, steady untracked {' '.join(f'{w:.4f}' for w in walls)}"
            f" (median {statistics.median(walls):.4f})")
        return obj

    out = {}
    problem = epsilon_problem(seed=0)
    cfg = api.SolverConfig(block_size=MU, s=S, iterations=H)
    outer = cfg.outer_iterations
    say(f"  epsilon: {M_EPS // world} rows of {M_EPS} per rank")
    out["epsilon"] = run(
        "epsilon", problem, cfg,
        {"gram": outer, "sa_inner": outer, "spmm": 0, "svm_inner": 0,
         "flash_attention": 0},
        {"gram wgmma": outer, "sa_inner warp": outer},
        lambda r: (r.x, r.aux["state"].carry["z"], r.aux["state"].carry["y"]),
        PAYLOAD, lambda p, c: epsilon_split(p, c, "sharded", say))
    del problem
    torch.cuda.empty_cache()

    problem = news20_problem(seed=0)
    cfg = api.SolverConfig(block_size=1, s=S_SVM, iterations=H_SVM)
    outer = cfg.outer_iterations
    say(f"  news20.binary: {-(-N_NEWS // world)} of {N_NEWS} feature "
        f"columns per rank")
    out["news20"] = run(
        "news20.binary", problem, cfg,
        {"gram": 0, "sa_inner": 0, "spmm": outer, "svm_inner": outer,
         "flash_attention": 0},
        {"svm_inner warp": outer},
        lambda r: (r.aux["alpha"], r.aux["dual"]), (S_SVM, S_SVM + 1),
        lambda p, c: news20_split(p, c, say))
    del problem
    torch.cuda.empty_cache()

    A, b, lam_max = make_lasso_dataset("epsilon-like", seed=0, device="cuda")
    res = api.solve(api.LassoProblem(A=A, b=b, lam=0.1 * lam_max),
                    api.SolverConfig(block_size=MU, s=S, iterations=128,
                                     dtype=torch.float64),
                    backend="sharded")
    if not everywhere(res.x):
        raise AssertionError("f64: x differs across ranks")
    out["f64"] = (res.x.cpu(), res.objective.cpu())
    return out


def phase_sharded_gloo():
    """Phase 11 (b): four gloo ranks on the one card (``run_ranks``)."""
    import torch
    from repro_torch import api
    from repro_torch.core import distributed
    from repro_torch.data.sparse import make_lasso_dataset

    log(f"phase 11 (b): sharded backend, {P_GLOO} gloo ranks (host-staged "
        f"all-reduce) on one card: epsilon SA-accBCD mu={MU} s={S} H={H}, "
        f"news20.binary SVM-L1 SA-BDCD mu=1 s={S_SVM} H={H_SVM}, f64 "
        f"epsilon-like 8192 x 512")
    t0 = time.perf_counter()
    out = distributed.run_ranks(sharded_rank, P_GLOO, "gloo", device="cuda")
    log(f"  {P_GLOO} ranks done in {time.perf_counter() - t0:.1f} s "
        f"(start, data made on the card, solves)")
    for what, key in (("epsilon", "epsilon"), ("news20.binary", "news20")):
        ref = LOCAL[key][1] if key == "epsilon" else LOCAL[key]
        obj = out[key]
        dev = rel_dev(obj, ref)
        log(f"  {what}: rank 0's trace against phase "
            f"{2 if key == 'epsilon' else 4}'s local solve: max rel "
            f"deviation {dev:.3e} (bar 1e-3)")
        if not (torch.isfinite(obj).all() and dev <= 1e-3):
            raise AssertionError(f"{what}: sharded trace differs")
    A, b, lam_max = make_lasso_dataset("epsilon-like", seed=0, device="cpu")
    cpu = api.solve(api.LassoProblem(A=A, b=b, lam=0.1 * lam_max),
                    api.SolverConfig(block_size=MU, s=S, iterations=128,
                                     dtype=torch.float64, device="cpu"))
    x, obj = out["f64"]
    dev = float(((obj - cpu.objective).abs() / cpu.objective.abs()).max())
    dx = float((x - cpu.x).abs().max())
    log(f"  f64 at P={P_GLOO} against the CPU solve: max rel objective "
        f"deviation {dev:.3e}, max |dx| {dx:.3e} (bar 1e-8)")
    if not (dev <= 1e-8 and dx <= 1e-8):
        raise AssertionError("f64 sharded solve differs from the CPU solve")


# ---------------------------------------------------------------------------
# Phase 13: the cost model and the calibrated autotuner on the card.
# ---------------------------------------------------------------------------

PILOT_ITERS = 48                # repro's default pilot solve length
# Phase 13 (d) cuts H, and only H, where the tuned and incumbent solves at
# full H would take longer than this (seconds, by the guard's timings).
TUNE_FULL_H_BUDGET_S = 60.0


def fmt_machine(mach) -> str:
    """A machine's four parameters as rates: gamma as TFLOP/s, beta as
    GB/s (8-byte words), alpha and kappa in us; the raw seconds beside
    them (a fitted parameter may be 0)."""
    def rate(x, scale):
        return f"{scale / x:.4f}" if x > 0 else "inf"
    return (f"gamma {rate(mach.gamma, 1e-12)} TFLOP/s, beta "
            f"{rate(mach.beta, 8e-9)} GB/s, alpha {mach.alpha * 1e6:.4f} "
            f"us, kappa {mach.kappa * 1e6:.4f} us (gamma {mach.gamma:.6g} "
            f"s/flop, beta {mach.beta:.6g} s/word)")


def fmt_cfg(cfg) -> str:
    return (f"s={cfg.s} mu={cfg.block_size} "
            f"symmetric_gram={cfg.symmetric_gram}")


def solves_in_turns(problem, cfgs, n=5):
    """{name: median seconds} of ``n`` steady solves of each config, run
    in turns, objective tracking off, host clock around each solve ended
    by a device sync."""
    import dataclasses
    import torch
    from repro_torch import api
    walls = {k: [] for k in cfgs}
    for _ in range(n):
        for k, cfg in cfgs.items():
            cfg = dataclasses.replace(cfg, track_objective=False)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            api.solve(problem, cfg)
            torch.cuda.synchronize()
            walls[k].append(time.perf_counter() - t0)
    for k, w in walls.items():
        log(f"    {k}: s per solve {' '.join(f'{x:.6f}' for x in w)}")
    return {k: sorted(w)[n // 2] for k, w in walls.items()}


def tune_path(what, problem, base, calib_kernels, tmp, smi, descent,
              want_launches):
    """Phase 13 (b)-(d) on one path: calibrate and select with counted
    launches, the cache hit, then the tuned config at full H against the
    incumbent ``base``. ``want_launches(cfg)`` gives the launches by kernel
    one solve of ``cfg`` must make. Returns the record PERF.md reads."""
    import dataclasses
    import torch
    from repro_torch import api, tune

    log(f"  {what}: incumbent {fmt_cfg(base)} H={base.iterations}; "
        f"tune.tune(pilot_iters={PILOT_ITERS})")
    zero_counts()
    t0 = time.perf_counter()
    tr = tune.tune(problem, base, pilot_iters=PILOT_ITERS, cache_dir=tmp)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, bodies = read_counts(), bodies_now()
    rep = tr.calibration
    log(f"  (b) calibrated in {wall:.2f} s; launches during the tune "
        f"{counts}; by body {bodies}")
    for p in rep.points:
        log(f"    pilot s={p['s']} mu={p['mu']}: measured "
            f"{p['measured_s']:.6f} s, predicted {p['predicted_s']:.6f} s, "
            f"ratio {p['ratio']:.4f}")
    log(f"    max_ratio {rep.max_ratio:.4f}")
    log(f"    fitted machine: {fmt_machine(tr.machine)}; {smi}")
    log(f"    selected {fmt_cfg(tr.config)}; predicted tuned "
        f"{tr.predicted_s:.6f} s, incumbent {tr.predicted_default_s:.6f} s "
        f"at H={base.iterations}; guard_times {tr.guard_times}")
    missing = [k for k in calib_kernels if counts[k] == 0]
    other = [k for k in counts if k not in calib_kernels and counts[k]]
    if missing or other:
        raise AssertionError(f"{what}: launches during the calibration "
                             f"{counts}; expected {calib_kernels} and no "
                             f"other kernel")
    if not (math.isfinite(rep.max_ratio)
            and all(math.isfinite(v) and v >= 0 for v in
                    (tr.machine.alpha, tr.machine.beta, tr.machine.gamma,
                     tr.machine.kappa))):
        raise AssertionError(f"{what}: fitted machine {tr.machine}")

    zero_counts()
    hit = tune.tune(problem, base, pilot_iters=PILOT_ITERS, cache_dir=tmp)
    counts = read_counts()
    log(f"  (c) cache hit: from_cache {hit.from_cache}, launches {counts}, "
        f"selected {fmt_cfg(hit.config)} (the model's pick, no guard)")
    if not hit.from_cache or any(counts.values()):
        raise AssertionError(f"{what}: the cached tune measured again")

    # (d): the tuned config, and the model's own pick where the guard
    # kept the incumbent over it, each against the incumbent at full H.
    cfgs = {"tuned": tr.config, "incumbent": base}
    if (hit.config.s, hit.config.block_size, hit.config.symmetric_gram) != \
            (tr.config.s, tr.config.block_size, tr.config.symmetric_gram):
        cfgs["model"] = hit.config
    H = base.iterations
    if tr.guard_times is not None:
        per_iter = max(tr.guard_times["selected_s"],
                       tr.guard_times["incumbent_s"]) / PILOT_ITERS
        est = per_iter * H * 7 * len(cfgs)    # 5 steady, counted, classical
        if est > TUNE_FULL_H_BUDGET_S:
            cut = max(base.s, int(H * TUNE_FULL_H_BUDGET_S / est)
                      // base.s * base.s)
            log(f"  H cut from {H} to {cut}: the guard's timings predict "
                f"{est:.1f} s for (d) at full H")
            H = cut
    cfgs = {k: dataclasses.replace(c, iterations=H) for k, c in cfgs.items()}
    out = {"H": H, "max_ratio": rep.max_ratio,
           "machine": dataclasses.asdict(tr.machine)}
    for k, cfg in cfgs.items():
        out[k] = fmt_cfg(cfg)
        log(f"  (d) {k} {fmt_cfg(cfg)} at H={H}")
        res, obj, out[k + "_launches"] = solve_counted(problem, cfg,
                                                       want_launches(cfg))
        log(f"    {k} solve's bodies {bodies_now()}")
        classical = api.solve(problem, dataclasses.replace(cfg, s=1))
        check_trace(obj, classical.objective.cpu(), f"{k} (s={cfg.s}, "
                    f"mu={cfg.block_size})", descent=descent)
        out[k + "_objective"] = float(obj[-1])
    log(f"    objective after H={H}: " + ", ".join(
        f"{k} {out[k + '_objective']:.6g}" for k in cfgs))
    med = solves_in_turns(problem, cfgs)
    for k, cfg in cfgs.items():
        outer = cfg.outer_iterations
        out[k + "_ms"] = med[k] * 1e3
        log(f"    {k} {fmt_cfg(cfg)}: median {med[k] * 1e3:.4f} ms per "
            f"solve, {med[k] * 1e3 / outer:.4f} ms per outer iteration "
            f"({outer} outer)")
    log(f"    fastest per solve at H={H}: {min(med, key=med.get)} "
        f"(recorded, not a check)")
    # The model prices an iteration, not its progress: a config with
    # another mu runs again at the incumbent's coordinate updates, H mu.
    for k, cfg in cfgs.items():
        if k == "incumbent" or cfg.block_size == base.block_size:
            continue
        h_eq = H * base.block_size // cfg.block_size
        if med[k] / H * h_eq * 6 > TUNE_FULL_H_BUDGET_S:
            log(f"    {k} at H={h_eq} skipped: over the phase's budget")
            continue
        eq = dataclasses.replace(cfg, iterations=h_eq)
        log(f"  (d) {k} {fmt_cfg(eq)} at H={h_eq}, the incumbent's "
            f"{H} x {base.block_size} coordinate updates")
        res, obj, _ = solve_counted(problem, eq, want_launches(eq))
        ms = solves_in_turns(problem, {k: eq})[k] * 1e3
        # the first iteration at or below the incumbent's final objective,
        # and its share of the solve's time (time taken as linear in H)
        below = torch.nonzero(obj <= out["incumbent_objective"]).flatten()
        reach = int(below[0]) + 1 if below.numel() else None
        out[k + "_equal_updates"] = {
            "H": h_eq, "objective": float(obj[-1]), "ms": ms,
            "reaches_incumbent_at": reach,
            "ms_to_reach": None if reach is None else ms * reach / h_eq}
        log(f"    {k} at H={h_eq}: objective {float(obj[-1]):.6g} (the "
            f"incumbent's {out['incumbent_objective']:.6g}), median "
            f"{ms:.4f} ms per solve (the incumbent's "
            f"{med['incumbent'] * 1e3:.4f}); reaches the incumbent's "
            f"objective at iteration {reach}, ~"
            + ("never" if reach is None else f"{ms * reach / h_eq:.4f} ms")
            + " by the solve's time per iteration")
    return out


def phase_tuner(smi):
    """Phase 13: the cost model and the calibrated autotuner on the card."""
    import dataclasses
    import subprocess as sp
    import tempfile
    import torch
    from repro_torch import api, tune

    log("phase 13: the cost model and the calibrated autotuner on the card")
    t0 = time.perf_counter()
    mach = tune.measure_machine()
    log(f"  (a) measure_machine() in {time.perf_counter() - t0:.2f} s: "
        f"{mach.name}: {fmt_machine(mach)}; {smi}")
    # beta must be resolved: a marginal cost under the launches' noise
    # leaves measure_alpha_beta's floor, a rate beyond any memory.
    if not (all(math.isfinite(v) and v > 0 for v in
                (mach.alpha, mach.beta, mach.gamma, mach.kappa))
            and 8 / mach.beta < 100e12):
        raise AssertionError(f"microbench machine {mach}")
    record = {"microbench": dataclasses.asdict(mach)}
    none = {k: 0 for k in counters()}

    with tempfile.TemporaryDirectory(prefix="repro_tune_") as tmp:
        problem = epsilon_problem(seed=0)

        def eps_launches(cfg):
            outer = cfg.outer_iterations if cfg.s > 1 else 0
            return dict(none, gram=outer, sa_inner=outer)

        record["epsilon"] = tune_path(
            f"epsilon Lasso {M_EPS} x {N_EPS} f32", problem,
            api.SolverConfig(block_size=MU, s=S, iterations=H),
            ("gram", "sa_inner"), tmp, smi, descent=False,
            want_launches=eps_launches)
        del problem
        torch.cuda.empty_cache()

        problem = news20_problem(seed=0)

        def svm_launches(cfg):
            return dict(none, spmm=cfg.outer_iterations,
                        svm_inner=cfg.outer_iterations if cfg.s > 1 else 0)

        record["news20"] = tune_path(
            f"news20.binary SVM-L1 {M_NEWS} x {N_NEWS} f32", problem,
            api.SolverConfig(block_size=1, s=S_SVM, iterations=H_SVM),
            ("spmm", "svm_inner"), tmp, smi, descent=True,
            want_launches=svm_launches)
        del problem
        torch.cuda.empty_cache()

        log("  (f) the launcher on the card, as subprocesses")
        env = dict(os.environ, PYTHONPATH=SRC, REPRO_TUNE_CACHE=tmp)
        cmd = [sys.executable, "-m", "repro_torch.launch.solve"]
        out = sp.run(cmd + ["--list-families"], cwd=ROOT, env=env,
                     capture_output=True, text=True, timeout=300)
        text = out.stdout
        log("    " + text.replace("\n", "\n    ").rstrip())
        if out.returncode or text.count("tune_space:") != 5 or any(
                f"{f}  (" not in text for f in api.families()):
            raise AssertionError(f"--list-families: {out.stderr[-2000:]}")
        t0 = time.perf_counter()
        out = sp.run(cmd + ["--problem", "lasso", "--dataset",
                            "epsilon-like", "--mu", "8", "--s", "16",
                            "--iterations", "512", "--accelerated",
                            "--tune"], cwd=ROOT, env=env,
                     capture_output=True, text=True, timeout=600)
        text = out.stdout
        log(f"    --tune in {time.perf_counter() - t0:.1f} s:")
        log("    " + text.replace("\n", "\n    ").rstrip())
        if out.returncode or "tuned[lasso]: s=" not in text \
                or " -> " not in text:
            raise AssertionError(f"--tune: {out.stderr[-2000:]}")
        first, last = (float(v) for v in
                       text.split("obj ")[1].split(",")[0].split(" -> "))
        if not (math.isfinite(last) and last < first):
            raise AssertionError(f"--tune solve did not descend: {text}")
    log(f"  phase 13 record: {json.dumps(record)}")
    return record


# ---------------------------------------------------------------------------
# Phase 14: the static contracts (repro_torch.analysis) on the card.
# ---------------------------------------------------------------------------

def contract_counts(device):
    """{(family, variant, s, "dense" | "sparse"): (flops, words, messages,
    payload bytes per outer iteration, each outer iteration's collectives
    by kind)} of every family x variant x s of the certification grid:
    what ``solver_cost_count`` and ``solver_collective_budget`` give,
    both from one recorded sharded solve on ``device`` over a one-rank
    group."""
    from repro_torch.analysis import costs
    from repro_torch.analysis.collectives import (collective_budget,
                                                  recorded_solve)
    from repro_torch.analysis.common import (certification_problem,
                                             family_variants,
                                             one_rank_group, variant_config)
    from repro_torch.core.api import FAMILIES
    out = {}
    with one_rank_group(device):
        for name in sorted(FAMILIES):
            fam = FAMILIES[name]
            mu = costs.cost_tolerance(name).mu or fam.bench_block_size
            m, n = costs.CERT_SHAPES[fam.partition]
            operand = costs.certification_operand(fam)
            for v in family_variants(fam):
                for s in (costs.CERT_S_GRID if v.startswith(("sa", "ca"))
                          else (1,)):
                    cfg = variant_config(fam, v, device=device, s=s,
                                         block_size=mu,
                                         iterations=costs.CERT_ITERATIONS)
                    for kind, op in (("dense", None), ("sparse", operand)):
                        rec = recorded_solve(fam, cfg, certification_problem(
                            fam, m, n, cfg.dtype, device, op))
                        c = costs.cost_count(rec)
                        b = collective_budget(rec)
                        out[name, v, s, kind] = (
                            c.flops, c.words, c.messages,
                            b.per_iteration_bytes, b.outer)
    return out


def full_width_contract(what, problem, cfg, fam, dims, want_bytes):
    """Phase 14 (c) on one path: one sharded solve at NCCL world size 1
    under the recorder; every outer iteration must hold exactly one
    all-reduce of ``want_bytes`` and nothing else; the counted F and W
    against the family's Table I hook at the true dims; the recorder's
    overhead (ms per outer iteration with and without it, median of 3)."""
    import statistics
    import torch
    from repro_torch.analysis import costs
    from repro_torch.analysis.collectives import (budget_diags,
                                                  collective_budget)
    from repro_torch.analysis.common import one_rank_group
    from repro_torch.analysis.record import Recorder
    from repro_torch.core import linalg
    from repro_torch.core.api import solve_sharded
    outer = cfg.outer_iterations
    with one_rank_group("cuda") as group:
        zero_counts()
        rec = Recorder()
        with linalg.count_reductions() as red, rec:
            solve_sharded(problem, cfg, group)
        torch.cuda.synchronize()
        budget = collective_budget(rec)
        count = costs.cost_count(rec)
        others = sum(n for it in budget.outer for k, n in it.items()
                     if k != "all-reduce")
        log(f"  {what}: {len(budget.outer)} outer iterations marked "
            f"(expected {outer}); all-reduces by iteration "
            f"{[it['all-reduce'] for it in budget.outer]}; other "
            f"collectives in them {others}; "
            f"setup {budget.amortized}; end gathers {budget.end_gathers} "
            f"({budget.end_gather_bytes:.0f} B); linalg.count_reductions "
            f"{red.n}; launches {read_counts()}")
        errs = budget_diags(what, cfg, budget)
        sizes = sorted({t.allreduce_bytes for t in rec.outer})
        log(f"  {what}: all-reduce payload per outer iteration, counted "
            f"{sizes} B, expected {want_bytes} B")
        if errs or red.n != outer or sizes != [want_bytes]:
            raise AssertionError(f"{what}: {[d.message for d in errs]}, "
                                 f"{red.n} reductions, payload {sizes}")
        model = fam.costs(dims, cfg.iterations, cfg.block_size, cfg.s, 1)
        tol = costs.cost_tolerance(fam.name)
        f_ratio = count.flops / model["F"]
        w_ratio = count.words / model["W"]
        log(f"  {what}: counted F {count.flops:.6g} flops (in the outer "
            f"iterations {count.flops_in_loop:.6g}; by kernel "
            f"{ {k: float(v) for k, v in count.kernel_flops.items()} }), "
            f"W {count.words:.6g} words, L {count.messages:.0f} messages; "
            f"Table I at m={dims.m} n={dims.n} f={dims.f:.6g}: F "
            f"{model['F']:.6g}, W {model['W']:.6g}, L {model['L']:.6g}; "
            f"ratios F {f_ratio:.4f} (band {tol.f_band}), W {w_ratio:.4f} "
            f"(band {tol.w_band}): "
            + ("inside" if tol.f_band[0] <= f_ratio <= tol.f_band[1]
               and tol.w_band[0] <= w_ratio <= tol.w_band[1]
               else "OUTSIDE") + " the bands")
        walls = {"recorder": [], "plain": []}
        for _ in range(3):
            for k in ("plain", "recorder"):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if k == "recorder":
                    with Recorder():
                        solve_sharded(problem, cfg, group)
                else:
                    solve_sharded(problem, cfg, group)
                torch.cuda.synchronize()
                walls[k].append((time.perf_counter() - t0) / outer * 1e3)
        med = {k: statistics.median(v) for k, v in walls.items()}
        log(f"  {what}: ms per outer iteration, solve alone "
            f"{' '.join(f'{v:.4f}' for v in walls['plain'])} (median "
            f"{med['plain']:.4f}), under the recorder "
            f"{' '.join(f'{v:.4f}' for v in walls['recorder'])} (median "
            f"{med['recorder']:.4f}): overhead "
            f"{med['recorder'] - med['plain']:.4f} ms per outer iteration")
    return {"payload_bytes": sizes[0], "f_ratio": f_ratio,
            "w_ratio": w_ratio, "ms": med["plain"],
            "ms_recorded": med["recorder"]}


def phase_contracts(smi, tuner):
    """Phase 14: the static contracts of repro_torch.analysis on the
    card."""
    import torch
    from repro_torch import analysis, api, tune
    from repro_torch.core.cost_model import Machine, ProblemDims
    from repro_torch.core.types import FAMILIES
    from repro_torch.kernels import sa_inner, svm_inner
    from repro_torch.kernels.gram import gram_t

    log(f"phase 14: the static contracts (repro_torch.analysis) on the "
        f"card; {smi}")
    t_phase = time.perf_counter()
    zero_counts()
    t0 = time.perf_counter()
    report = analysis.check_all(device="cuda")
    log(f"  (a) check_all(device='cuda') in {time.perf_counter() - t0:.1f} "
        f"s: {len(report.checked)} subjects, {len(report.errors)} "
        f"error(s); by pass " + ", ".join(
            f"{c} {sum(x.startswith(c + ':') for x in report.checked)}"
            for c in analysis.CHECKS))
    for d in report.diagnostics:
        if d.check in ("collectives", "costs") or d.severity != "info":
            log(f"    {d.format()}")
    launched = dict(read_counts(), **{f"gram {k}": v for k, v in
                                       gram_t.route_launches.items()},
                    **{f"sa_inner {k}": v for k, v in
                       sa_inner.sa_inner_loop.route_launches.items()},
                    **{f"svm_inner {k}": v for k, v in
                       svm_inner.svm_inner_loop.route_launches.items()})
    log(f"  (a) kernel launches during check_all, by body: {launched}")
    if not report.ok:
        raise AssertionError(f"check_all on the card: "
                             f"{[d.format() for d in report.errors]}")
    missing = [k for k in ("gram", "sa_inner", "spmm", "svm_inner")
               if launched[k] == 0]
    if missing:
        raise AssertionError(f"check_all launched none of {missing}")

    t0 = time.perf_counter()
    card = contract_counts("cuda")
    cpu = contract_counts("cpu")
    diff = [k for k in card if card[k] != cpu[k]]
    log(f"  (b) {len(card)} family x variant x s x operand points counted "
        f"on the card and on the CPU in {time.perf_counter() - t0:.1f} s: "
        f"flops, words, messages and payload bytes per outer iteration "
        f"equal at {len(card) - len(diff)}")
    for k in diff[:8]:
        log(f"    differs at {k}: card {card[k][:3]}, CPU {cpu[k][:3]}")
    if diff or set(card) != set(cpu):
        raise AssertionError(f"card and CPU counts differ at {diff}")

    record = {}
    problem = epsilon_problem(seed=0)
    cfg = api.SolverConfig(block_size=MU, s=S, iterations=H,
                           track_objective=False)
    record["epsilon"] = full_width_contract(
        f"(c) epsilon Lasso {M_EPS} x {N_EPS}, mu={MU} s={S} H={H}",
        problem, cfg, FAMILIES["lasso"], ProblemDims(m=M_EPS, n=N_EPS, f=1.0),
        4 * (S * MU) * (S * MU + 2))
    base = api.SolverConfig(block_size=MU, s=S, iterations=H)
    machine = Machine(**tuner["epsilon"]["machine"])
    t0 = time.perf_counter()
    picked = tune.select_config(problem, machine, base, certified=True)
    log(f"  (d) select_config(certified=True) on the epsilon Lasso with "
        f"phase 13's fitted machine in {time.perf_counter() - t0:.1f} s: "
        f"{fmt_cfg(picked)}")
    if picked.s < 1 or picked.block_size < 1:
        raise AssertionError(f"certified selection {picked}")
    del problem
    torch.cuda.empty_cache()
    svm = news20_problem(seed=0)
    cfg = api.SolverConfig(block_size=1, s=S_SVM, iterations=H_SVM,
                           track_objective=False)
    nnz = svm.A.nnz
    record["news20"] = full_width_contract(
        f"(c) news20.binary SVM {M_NEWS} x {N_NEWS}, {nnz} nonzeros, mu=1 "
        f"s={S_SVM} H={H_SVM}", svm, cfg, FAMILIES["svm"],
        ProblemDims(m=M_NEWS, n=N_NEWS, f=nnz / (M_NEWS * N_NEWS)),
        4 * S_SVM * (S_SVM + 1))
    del svm
    torch.cuda.empty_cache()

    # (e), the CLI on the card, runs with the launchers beside phase 21
    # (``launchers_start``, ``analysis_cli_ok``)
    log(f"  phase 14 in {time.perf_counter() - t_phase:.1f} s; record: "
        f"{json.dumps(record)}")
    return record


# ---------------------------------------------------------------------------
# Phase 15 (run last): the elastic runtime on the card.
# ---------------------------------------------------------------------------

# Where phase 15 (b) kills a host: 8 steps into the epsilon s-group at
# 192 (host 2), 16 into the news20.binary s-group at 1,984 (host 0, the
# checkpoint writer).
KILL_EPS = (200, 2)
KILL_NEWS = (2000, 0)
# Phase 15 (c): repro's chaos schedules (tests/test_chaos.py) at f64:
# name -> (family, s, accelerated, H, failures, straggler).
CHAOS_F64 = {
    "lasso s4 acc": ("lasso", 4, True, 14, {6: [3]}, False),
    "svm s3": ("svm", 3, False, 13, {7: [0]}, False),
    "ksvm s3": ("ksvm", 3, False, 13, {8: [2]}, False),
    "straggler eviction": ("lasso", 2, True, 12, {}, True),
}
CLI_RECIPE = ["--problem", "lasso", "--dataset", "w1a-like", "--s", "4",
              "--iterations", "24", "--device", "cuda"]


def strip_seconds(recoveries):
    return [{k: v for k, v in r.items() if not k.endswith("_seconds")}
            for r in recoveries]


def elastic_layout_ok(directory, keep, last, step_len):
    """The checkpoints left under ``directory``: the newest ``keep``
    boundaries up to ``last``, each with the accelerated Lasso state's
    four leaves and their specs. Returns the bytes of the newest."""
    steps = sorted(os.listdir(directory))
    want = [f"step_{last - i * step_len:08d}" for i in range(keep)][::-1]
    if steps != want:
        raise AssertionError(f"checkpoints {steps}, expected {want}")
    for step in steps:
        with open(os.path.join(directory, step, "manifest.json")) as f:
            leaves = {leaf["path"]: (leaf["shape"], leaf["dtype"],
                                     leaf["spec"])
                      for leaf in json.load(f)["leaves"]}
        if leaves != {"y": ([N_EPS], "float32", []),
                      "z": ([N_EPS], "float32", []),
                      "ytil": ([M_EPS], "float32", ["data"]),
                      "ztil": ([M_EPS], "float32", ["data"])}:
            raise AssertionError(f"{step}: leaves {leaves}")
    path = os.path.join(directory, steps[-1])
    return sum(os.path.getsize(os.path.join(path, f))
               for f in os.listdir(path))


def median_ms(fn, n=5):
    import statistics
    import torch
    walls = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(walls)


def segment_split(problem, cfg, tmp):
    """One more elastic solve at checkpoint_every 1 with the card
    synchronised around each segment's ``solve_sharded`` call, the
    family's solve inside it, each callback of the SA-accBCD program
    (``sa_lasso._ACC_PROGRAM``: setup, the theta schedule, the block
    draws, assemble, reduce, inner, defer, finalize), the end gathers
    and the writer's ``CheckpointManager.save`` (the host copy; the
    write runs in its thread): ms per segment of each, and of the rest."""
    import dataclasses
    import torch
    from repro_torch import api
    from repro_torch.checkpoint import ckpt
    from repro_torch.core import api as core_api
    from repro_torch.core import linalg, sa_lasso
    from repro_torch.core.types import FAMILIES
    spent = {}

    def timed(label, fn):
        def run(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            spent[label] = spent.get(label, 0.0) + time.perf_counter() - t0
            return out
        return run

    fam = FAMILIES["lasso"]
    fam_t = dataclasses.replace(fam, solve=timed("family solve", fam.solve))
    prog = sa_lasso._ACC_PROGRAM
    steps = ("setup", "schedule", "sample", "assemble", "reduce", "inner",
             "defer", "finalize")
    saved = [(core_api, "solve_sharded"), (linalg, "pgather"),
             (ckpt.CheckpointManager, "save"), (sa_lasso, "_ACC_PROGRAM")]
    originals = [getattr(o, a) for o, a in saved]
    for (o, a), fn, label in zip(saved[:3], originals, (
            "solve_sharded", "end gathers", "checkpoint host copy")):
        setattr(o, a, timed(label, fn))
    sa_lasso._ACC_PROGRAM = dataclasses.replace(
        prog, **{k: timed(k, getattr(prog, k)) for k in steps})
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        api.solve_elastic(problem, cfg, family=fam_t,
                          elastic=api.ElasticConfig(checkpoint_dir=tmp))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        for (o, a), fn in zip(saved, originals):
            setattr(o, a, fn)
    segs = cfg.outer_iterations
    ms = {k: v / segs * 1e3 for k, v in spent.items()}
    split = {"segment wall": wall / segs * 1e3,
             "family solve": ms["family solve"]}
    split.update({f"  {k}": ms[k] for k in steps})
    split["  engine rest"] = ms["family solve"] - sum(ms[k] for k in steps)
    split.update({
        "shard setup and the rest of solve_sharded":
            ms["solve_sharded"] - ms["family solve"] - ms["end gathers"],
        "end gathers (pgather of ztil, ytil)": ms["end gathers"],
        "checkpoint host copy (writer, D2H)": ms["checkpoint host copy"],
        "driver rest": wall / segs * 1e3 - ms["solve_sharded"]
        - ms["checkpoint host copy"]})
    return split


def phase_elastic_nccl():
    """Phase 15 (a): the segmented epsilon Lasso at NCCL world size 1 in
    this process, undisturbed."""
    import statistics
    import tempfile
    import torch
    import torch.distributed as dist
    from repro_torch import api
    from repro_torch.checkpoint import ckpt
    from repro_torch.core import distributed

    log(f"phase 15 (a): elastic runtime, NCCL at world size 1, dense Lasso "
        f"{M_EPS} x {N_EPS} f32, SA-accBCD mu={MU} s={S} H={H}, "
        f"undisturbed, segments of checkpoint_every outer iterations")
    dist.init_process_group(
        "nccl", init_method=f"tcp://localhost:{distributed.free_port()}",
        world_size=1, rank=0)
    rec = {}
    try:
        problem = epsilon_problem(seed=0)
        cfg = api.SolverConfig(block_size=MU, s=S, iterations=H)
        outer = cfg.outer_iterations
        x_l, obj_l = LOCAL["epsilon"]
        want = {"gram": outer, "sa_inner": outer, "spmm": 0,
                "svm_inner": 0, "flash_attention": 0}
        want_bodies = {"gram wgmma": outer, "gram simt": 0,
                       "sa_inner warp": outer, "sa_inner block": 0,
                       "svm_inner warp": 0, "svm_inner block": 0}
        with tempfile.TemporaryDirectory(prefix="phase15_") as tmp:
            for every, async_save in ((1, True), (8, True), (1, False)):
                what = (f"checkpoint_every {every}, "
                        f"{'async' if async_save else 'sync'} save")
                d = os.path.join(tmp, f"{every}-{async_save}")
                zero_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = api.solve_elastic(
                    problem, cfg, elastic=api.ElasticConfig(
                        checkpoint_dir=d, checkpoint_every=every,
                        async_save=async_save))
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                got, bodies = read_counts(), bodies_now()
                same = (torch.equal(res.x.cpu(), x_l),
                        torch.equal(res.objective.cpu(), obj_l))
                nbytes = elastic_layout_ok(d, 3, H, every * S)
                log(f"  {what}: wall {wall:.3f} s ({wall / outer * 1e3:.4f} "
                    f"ms per outer iteration, first); x and trace "
                    f"bit-identical to phase 2's local solve: {same}; "
                    f"launches {got}; by body {bodies}; 3 checkpoints "
                    f"left, {nbytes} bytes each")
                if not all(same):
                    raise AssertionError(f"{what}: the segmented solve "
                                         f"differs from the local solve")
                if got != want or any(bodies[k] != n
                                      for k, n in want_bodies.items()):
                    raise AssertionError(f"{what}: launches {got}, bodies "
                                         f"{bodies}")
            carry = dict(res.aux["state"].carry)
            host = ckpt._host_tree(carry)
            specs = {"z": [], "y": [], "ztil": ["data"], "ytil": ["data"]}
            d2 = os.path.join(tmp, "timing")
            rec["host_copy_ms"] = median_ms(lambda: ckpt._host_tree(carry))
            rec["save_ms"] = median_ms(lambda: ckpt.save_checkpoint(
                d2, H, host, specs, {"iteration": H}))
            rec["restore_ms"] = median_ms(lambda: ckpt.restore_checkpoint(
                d2, device="cuda"))
            rec["bytes"] = nbytes
            log(f"  one checkpoint of the state ({nbytes} bytes on disk, "
                f"{sum(v.array.nbytes for v in host.values())} of leaves): "
                f"host copy {rec['host_copy_ms']:.4f} ms, save (npz, "
                f"fsync, rename) {rec['save_ms']:.4f} ms, restore onto "
                f"the card {rec['restore_ms']:.4f} ms (medians of 5)")

            walls = {}
            runs = [("monolithic sharded", None), ("elastic every 1", 1),
                    ("elastic every 8", 8)]
            for i in range(3):
                for label, every in runs[i:] + runs[:i]:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    if every is None:
                        api.solve(problem, cfg, backend="sharded")
                    else:
                        api.solve_elastic(
                            problem, cfg, elastic=api.ElasticConfig(
                                checkpoint_dir=os.path.join(
                                    tmp, f"turn{i}-{every}"),
                                checkpoint_every=every))
                    torch.cuda.synchronize()
                    walls.setdefault(label, []).append(
                        (time.perf_counter() - t0) / outer * 1e3)
            base = statistics.median(walls["monolithic sharded"])
            for label, w in walls.items():
                med = statistics.median(w)
                rec[label] = med
                log(f"  {label}: ms per outer iteration "
                    f"{' '.join(f'{v:.4f}' for v in w)} (median {med:.4f}; "
                    f"{med - base:+.4f} against the monolithic solve)")
            split = segment_split(problem, cfg, os.path.join(tmp, "split"))
            log("  a segment at checkpoint_every 1, the card synchronised "
                "around each part (ms per segment):")
            for k, v in split.items():
                log(f"    {k:58s} {v:.4f}")
            rec["split"] = split
        # survivor_group under NCCL: twice in a row over the same rank
        # (torch names both alike), each all-reducing on the card.
        sums = []
        for _ in range(2):
            g = distributed.survivor_group([0])
            t = torch.ones(1, device="cuda")
            dist.all_reduce(t, group=g)
            sums.append(float(t))
            dist.destroy_process_group(g)
        log(f"  survivor_group([0]) under NCCL twice in a row: all-reduce "
            f"of ones gives {sums}")
        if sums != [1.0, 1.0]:
            raise AssertionError(f"NCCL survivor groups gave {sums}")
    finally:
        dist.destroy_process_group()
    return rec


def chaos_problem(family, device):
    """tests/test_chaos.py's problem (numpy seed 5, 30 x 44) at f64."""
    import numpy as np
    import torch
    from repro_torch import api
    rng = np.random.default_rng(5)
    m, n = 30, 44
    A = torch.as_tensor(rng.standard_normal((m, n)), device=device)
    b = torch.as_tensor(rng.standard_normal(m), device=device)
    signs = torch.as_tensor(np.sign(rng.standard_normal(m)), device=device)
    lam = 0.1 * float((A.T @ b).abs().max())
    if family == "lasso":
        return api.LassoProblem(A=A, b=b, lam=lam)
    if family == "svm":
        return api.SVMProblem(A=A, b=signs, lam=0.5)
    return api.SVMProblem(A=A, b=signs, lam=0.5, kernel="rbf",
                          kernel_params={"gamma": 0.3})


def elastic_rank(rank, world, tmp):
    """Phase 15 (b) and (c), one rank: the elastic solves at full width
    over ``world`` gloo ranks on one card, and the f64 chaos schedules on
    the card and on the CPU. Every rank writes what it saw to its own
    file under ``tmp`` (a rank that dies returns no solution)."""
    import torch
    from repro_torch import api
    from repro_torch.runtime import FailureInjector, StragglerMonitor
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}

    def timed_solve(fn):
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0, read_counts(), bodies_now()

    def run(key, problem, cfg, kill, vec):
        step, host = kill
        _, first, _, _ = timed_solve(
            lambda: api.solve(problem, cfg, backend="sharded"))
        _, mono, _, _ = timed_solve(
            lambda: api.solve(problem, cfg, backend="sharded"))
        for label, injector in (
                ("undisturbed", None),
                ("disturbed", FailureInjector(failures={step: [host]}))):
            res, wall, counts, bodies = timed_solve(
                lambda: api.solve_elastic(
                    problem, cfg, elastic=api.ElasticConfig(
                        checkpoint_dir=os.path.join(tmp, key, label)),
                    injector=injector))
            lost = res.x is None
            out[(key, label)] = {
                "vec": None if lost else vec(res).cpu(),
                "objective": None if lost else res.objective.cpu(),
                "wall": wall, "counts": counts, "bodies": bodies,
                "report": res.aux["elastic"]}
        out[(key, "monolithic")] = {"first": first, "wall": mono}

    problem = epsilon_problem(seed=0)
    run("epsilon", problem, api.SolverConfig(block_size=MU, s=S,
                                             iterations=H),
        KILL_EPS, lambda r: r.x)
    del problem
    torch.cuda.empty_cache()
    problem = news20_problem(seed=0)
    run("news20", problem, api.SolverConfig(block_size=1, s=S_SVM,
                                            iterations=H_SVM),
        KILL_NEWS, lambda r: r.aux["alpha"])
    del problem
    torch.cuda.empty_cache()

    for name, (family, s, acc, H_c, failures, straggler) in \
            CHAOS_F64.items():
        for device in ("cuda", "cpu"):
            kw = {"injector": FailureInjector(
                failures={k: list(v) for k, v in failures.items()})}
            if straggler:
                kw["monitor"] = StragglerMonitor(
                    n_hosts=world, threshold=1.5, patience=1, evict_after=2)
                kw["host_times"] = lambda seg, live: {
                    h: (6.0 if h == 2 else 1.0) for h in live}
            res = api.solve_elastic(
                chaos_problem(family, device),
                api.SolverConfig(block_size=4, s=s, iterations=H_c,
                                 accelerated=acc, dtype=torch.float64,
                                 device=device),
                family=family, elastic=api.ElasticConfig(
                    checkpoint_dir=os.path.join(tmp, "chaos", name, device)),
                **kw)
            out[("chaos", name, device)] = {
                "x": None if res.x is None else res.x.cpu(),
                "report": res.aux["elastic"]}
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))


def check_recovery(what, ranks, key, kill, resumed, survivors, kernels,
                   rec):
    """Phase 15 (b)'s checks of one path over the ranks' files."""
    import torch
    step, host = kill
    want_rec = [{"kind": "failure", "hosts": [host],
                 "resumed_iteration": resumed, "n_hosts": len(survivors)}]
    und = {r: ranks[r][(key, "undisturbed")] for r in ranks}
    dis = {r: ranks[r][(key, "disturbed")] for r in ranks}
    first = dis[survivors[0]]
    report = first["report"]
    log(f"  {what}: host {host} killed at inner iteration {step}: events "
        f"{report['events']}")
    log(f"  {what}: recoveries {report['recoveries']}; live hosts "
        f"{report['live_hosts']}")
    if strip_seconds(report["recoveries"]) != want_rec \
            or report["live_hosts"] != survivors:
        raise AssertionError(f"{what}: recovered as {report}, expected "
                             f"{want_rec} on {survivors}")
    for r in ranks:
        if r in survivors:
            if strip_seconds(dis[r]["report"]["recoveries"]) != want_rec:
                raise AssertionError(f"{what}: rank {r} decided otherwise")
        elif not dis[r]["report"]["lost"] or dis[r]["vec"] is not None:
            raise AssertionError(f"{what}: rank {r} did not leave the job")
    if first["objective"].shape[0] != H_OF[key]:
        raise AssertionError(f"{what}: trace of {first['objective'].shape}")
    for r in survivors[1:]:
        if not (torch.equal(dis[r]["vec"], first["vec"])
                and torch.equal(dis[r]["objective"], first["objective"])):
            raise AssertionError(f"{what}: survivors {survivors[0]} and {r} "
                                 f"hold different bits")
    ref = und[survivors[0]]
    dev = float((first["vec"] - ref["vec"]).abs().max()
                / ref["vec"].abs().max())
    tdev = rel_dev(first["objective"], ref["objective"])
    log(f"  {what}: trace of {first['objective'].shape[0]} entries; the "
        f"survivors hold the same bits; against the undisturbed P = 4 "
        f"solve: max |dv| / max |v| {dev:.3e} (bar 1e-3), trace max rel "
        f"deviation {tdev:.3e} (bar 1e-5)")
    if not dev <= 1e-3:
        raise AssertionError(f"{what}: recovered solution differs")
    # On an H100 80GB HBM3 at 700 W the recovered traces read 1.6e-7
    # (epsilon) and 1.2e-7 (news20.binary): a restore of a slightly wrong
    # state passes the bar on x but shows here.
    if not tdev <= 1e-5:
        raise AssertionError(f"{what}: recovered trace differs")
    for r in survivors:
        got = {k: dis[r]["counts"][k] for k in kernels}
        base = {k: und[r]["counts"][k] for k in kernels}
        log(f"  {what}: rank {r} launched {got} (undisturbed {base}); by "
            f"body {dis[r]['bodies']}")
        if got != base or dis[r]["counts"] != und[r]["counts"]:
            raise AssertionError(f"{what}: rank {r} launched "
                                 f"{dis[r]['counts']}, the undisturbed run "
                                 f"{und[r]['counts']}")
    lost = {r: dis[r]["counts"] for r in ranks if r not in survivors}
    log(f"  {what}: the lost rank's launches before it left: {lost}")
    mono = ranks[survivors[0]][(key, "monolithic")]
    outer = H_OF[key] // S_OF[key]
    r0 = report["recoveries"][0]
    extra = {r: dis[r]["wall"] - und[r]["wall"] for r in survivors}
    out = {"restore_ms": r0["restore_seconds"] * 1e3,
           "group_ms": r0["group_seconds"] * 1e3,
           "rolled_back": step - resumed,
           "extra_wall_s": max(extra.values()),
           "undisturbed_ms_per_outer": ref["wall"] / outer * 1e3,
           "monolithic_ms_per_outer": mono["wall"] / outer * 1e3}
    log(f"  {what}: restore {out['restore_ms']:.3f} ms, survivors' group "
        f"built in {out['group_ms']:.3f} ms, rolled back {step} - "
        f"{resumed} = {out['rolled_back']} iterations; wall disturbed "
        f"minus undisturbed by survivor "
        f"{ {r: round(v, 4) for r, v in extra.items()} } s")
    log(f"  {what}: ms per outer iteration at P = 4: monolithic sharded "
        f"{out['monolithic_ms_per_outer']:.4f} (first solve "
        f"{mono['first'] / outer * 1e3:.4f}), elastic every 1 "
        f"{out['undisturbed_ms_per_outer']:.4f}")
    rec[key] = out


H_OF = {"epsilon": H, "news20": H_SVM}
S_OF = {"epsilon": S, "news20": S_SVM}


def phase_elastic_gloo():
    """Phase 15 (b) and (c): four gloo ranks on the one card."""
    import tempfile
    import torch
    from repro_torch.core import distributed

    log(f"phase 15 (b): elastic runtime, {P_GLOO} gloo ranks on one card, "
        f"checkpoint_every 1: epsilon (host {KILL_EPS[1]} killed at "
        f"{KILL_EPS[0]}), news20.binary (host {KILL_NEWS[1]}, the writer, "
        f"killed at {KILL_NEWS[0]}); (c) repro's f64 chaos schedules, card "
        f"against CPU")
    rec = {}
    with tempfile.TemporaryDirectory(prefix="phase15_") as tmp:
        t0 = time.perf_counter()
        distributed.run_ranks(elastic_rank, P_GLOO, "gloo", device="cuda",
                              args=(tmp,))
        log(f"  {P_GLOO} ranks done in {time.perf_counter() - t0:.1f} s")
        ranks = {r: torch.load(os.path.join(tmp, f"rank{r}.pt"),
                               weights_only=False) for r in range(P_GLOO)}
    check_recovery("epsilon", ranks, "epsilon", KILL_EPS, 192, [0, 1, 3],
                   ("gram", "sa_inner"), rec)
    log(f"  epsilon: the three survivors shard {M_EPS} rows as "
        f"{-(-M_EPS // 3)} a rank, the last padded")
    check_recovery("news20.binary", ranks, "news20", KILL_NEWS, 1984,
                   [1, 2, 3], ("spmm", "svm_inner"), rec)
    for name in CHAOS_F64:
        card = {r: ranks[r][("chaos", name, "cuda")] for r in ranks}
        cpu = {r: ranks[r][("chaos", name, "cpu")] for r in ranks}
        live = card[0]["report"]["live_hosts"] if not \
            card[0]["report"]["lost"] else \
            card[min(r for r in ranks if not card[r]["report"]["lost"])][
                "report"]["live_hosts"]
        rc = strip_seconds(card[live[0]]["report"]["recoveries"])
        rcpu = strip_seconds(cpu[live[0]]["report"]["recoveries"])
        dx = max(float((card[r]["x"] - cpu[r]["x"]).abs().max())
                 for r in live)
        log(f"  (c) {name}: recoveries {rc}; live hosts {live}; card "
            f"against CPU max |dx| {dx:.3e} (bar 1e-8)")
        if rc != rcpu or not rc or not dx <= 1e-8:
            raise AssertionError(f"(c) {name}: card {rc}, CPU {rcpu}, "
                                 f"|dx| {dx:.3e}")
    return rec


def elastic_cli_start():
    """Phase 15 (d): repro's verify recipe through torchrun on the card,
    the elastic run and the plain one started together (each its own
    free rendezvous port); ``elastic_cli_finish`` checks them. Run beside
    phase 21, as the launchers are: one after the other they took ~49 s."""
    import tempfile
    env = dict(os.environ, PYTHONPATH=SRC)
    # "--" ends torchrun's options: the argparse of some Python 3.12
    # releases reads the launcher's --s as an abbreviation of torchrun's.
    # --standalone: each job's rendezvous takes a free port, not
    # torchrun's default 29500, which another job may hold.
    torchrun = [sys.executable, "-m", "torch.distributed.run",
                "--standalone", "--nproc-per-node", str(P_GLOO), "-m", "--",
                "repro_torch.launch.solve"] + CLI_RECIPE
    procs = {}
    for k, cmd in (("elastic", torchrun + ["--checkpoint-every", "1",
                                           "--inject-failure", "10:2"]),
                   ("plain", torchrun)):
        out = tempfile.TemporaryFile(mode="w+")
        err = tempfile.TemporaryFile(mode="w+")
        procs[k] = (out, err, subprocess.Popen(
            cmd, cwd=ROOT, env=env, stdout=out, stderr=err, text=True))
    return {"procs": procs, "t0": time.perf_counter()}


def elastic_cli_finish(state) -> None:
    """Wait for ``elastic_cli_start``'s two runs (600 s at most) and hold
    them: exit 0 at gloo world size 4, a failure and a restore event, and
    the recovered objective within rel 1e-3 of the plain run's."""
    import re
    outs = {}
    for k, (out, err, p) in state["procs"].items():
        left = 600 - (time.perf_counter() - state["t0"])
        try:
            p.wait(timeout=max(left, 1))
        except subprocess.TimeoutExpired:
            for *_, q in state["procs"].values():
                q.kill()
            raise AssertionError("(d) the CLI ran past 600 s")
        texts = []
        for f in (out, err):
            f.seek(0)
            texts.append(f.read())
            f.close()
        outs[k] = (*texts, p.returncode)
    summary = re.compile(r"obj ([^,\s]+) -> ([^,\s]+)")
    lines = outs["elastic"][0].strip().splitlines()
    log(f"  phase 15 (d): torchrun --standalone --nproc-per-node {P_GLOO} "
        f"-m -- repro_torch.launch.solve {' '.join(CLI_RECIPE)} "
        f"--checkpoint-every 1 --inject-failure 10:2, exit "
        f"{outs['elastic'][2]} (with the plain run beside it, both done "
        f"{time.perf_counter() - state['t0']:.1f} s after their start):")
    for ln in lines:
        log(f"    {ln}")
    plain = summary.search(outs["plain"][0])
    got = summary.search(lines[-1]) if lines else None
    ok = (outs["elastic"][2] == 0 and outs["plain"][2] == 0
          and lines[0].startswith(f"elastic: backend gloo, world size "
                                  f"{P_GLOO}")
          and any("failed in segment" in ln for ln in lines)
          and any("restored iteration" in ln for ln in lines)
          and got is not None and plain is not None)
    if not ok:
        raise AssertionError(f"(d) the CLI: {outs['elastic'][0][-2000:]} "
                             f"{outs['elastic'][1][-2000:]} "
                             f"{outs['plain'][1][-2000:]}")
    dev = max(abs(float(g) - float(w)) / abs(float(w))
              for g, w in zip(got.groups(), plain.groups()))
    log(f"    the plain run: {plain.group(0)}; max rel deviation {dev:.3e} "
        f"(bar 1e-3)")
    if not dev <= 1e-3:
        raise AssertionError("(d) the recovered objective differs")


def phase_elastic(cli: bool = True):
    """Phase 15: (a), then (b) and (c), then (d) (unless ``cli`` is
    False: ``chip_smoke.py`` runs it beside phase 21)."""
    t0 = time.perf_counter()
    rec = {"nccl": phase_elastic_nccl()}
    rec["gloo"] = phase_elastic_gloo()
    if cli:
        elastic_cli_finish(elastic_cli_start())
    log(f"  phase 15 in {time.perf_counter() - t0:.1f} s; record: "
        f"{json.dumps(rec)}")
    return rec


# ---------------------------------------------------------------------------
# Phases 7-10: the LM serving path.
# ---------------------------------------------------------------------------

def attn_inputs(B, Hq, Hkv, Sq, Sk, D, dtype, gen):
    import torch
    q = 0.3 * torch.randn(B, Hq, Sq, D, generator=gen, device="cuda")
    k = 0.3 * torch.randn(B, Hkv, Sk, D, generator=gen, device="cuda")
    v = torch.randn(B, Hkv, Sk, D, generator=gen, device="cuda")
    return q.to(dtype), k.to(dtype), v.to(dtype)


def phase_attention_kernel():
    import torch
    from repro_torch.kernels import _build, dispatch
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention.ops import _declare, _launch
    from repro_torch.kernels.flash_attention.ref import attention_ref

    log("phase 7: flash_attention against its plain version (atol 2e-3 at "
        "f32, 2e-2 at bf16)")
    lib = _build.load("flash_attention", _declare)
    tiles = (lib.flash_attention_block_q(), lib.flash_attention_block_k())
    if tiles != (dispatch.FLASH_BLOCK_Q, dispatch.FLASH_BLOCK_K):
        raise AssertionError(f"flash_attention tiles: C {tiles} vs dispatch")
    tiles = (lib.flash_attention_wgmma_block_q(),
             lib.flash_attention_wgmma_block_k(),
             lib.flash_attention_wgmma_stages())
    if tiles != (dispatch.FLASH_WGMMA_BLOCK_Q, dispatch.FLASH_WGMMA_BLOCK_K,
                 dispatch.FLASH_WGMMA_STAGES):
        raise AssertionError(f"flash_attention wgmma tiles and stages: C "
                             f"{tiles} vs dispatch")
    for D in dispatch.FLASH_HEAD_DIMS:
        got = lib.flash_attention_smem_bytes(D)
        if got != dispatch.flash_attention_smem_bytes(D):
            raise AssertionError(f"flash_attention smem at D={D}: C {got} "
                                 f"vs dispatch")
    for D in dispatch.FLASH_WGMMA_HEAD_DIMS:
        got = lib.flash_attention_wgmma_smem_bytes(D)
        if got != dispatch.flash_attention_smem_bytes(D, "wgmma"):
            raise AssertionError(f"flash_attention wgmma smem at D={D}: C "
                                 f"{got} vs dispatch")
    log(f"  tiles and shared memory agree with dispatch: simt "
        f"{dispatch.FLASH_BLOCK_Q} x {dispatch.FLASH_BLOCK_K}, wgmma "
        f"{dispatch.FLASH_WGMMA_BLOCK_Q} x {dispatch.FLASH_WGMMA_BLOCK_K} "
        f"over {dispatch.FLASH_WGMMA_STAGES} stages ("
        + ", ".join(f"{dispatch.flash_attention_smem_bytes(D, 'wgmma')} "
                    f"bytes at D = {D}"
                    for D in dispatch.FLASH_WGMMA_HEAD_DIMS) + ")")

    def routed(what, q, k, v, force=None, **kw):
        """flash_attention(q, k, v) -> out; raises unless exactly one
        launch of the body dispatch routes (dtype, D) to was counted (of
        body ``force`` where given, through ``_launch``)."""
        want = force or dispatch.flash_attention_route(q.dtype, q.shape[3])
        before = dict(flash_attention.route_launches)
        out = flash_attention(q, k, v, **kw) if force is None else _launch(
            q, k, v, kw.get("causal", True), kw.get("window", 0),
            q.shape[3] ** -0.5, route=force)
        taken = {r: n - before[r] for r, n in
                 flash_attention.route_launches.items() if n != before[r]}
        if taken != {want: 1}:
            raise AssertionError(f"flash_attention {what}: launched {taken}, "
                                 f"expected one of the {want} body")
        return out, want

    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    for case in ATTN_CASES:
        B, Hq, Hkv, Sq, Sk, D, causal, window = case
        for dtype, atol in ((torch.float32, 2e-3), (torch.bfloat16, 2e-2)):
            q, k, v = attn_inputs(B, Hq, Hkv, Sq, Sk, D, dtype, gen)
            out, route = routed(case, q, k, v, causal=causal, window=window)
            if out.dtype != dtype or out.shape != q.shape:
                raise AssertionError(f"flash_attention {case} gave "
                                     f"{out.dtype} {tuple(out.shape)}")
            check_close(f"flash_attention {dtype} {case} [{route}]",
                        out.float(),
                        attention_ref(q, k, v, causal=causal,
                                      window=window).float(), 0.0, atol)
    # q, k, v as attention_train hands them over without rope: transposed
    # views of (B, S, H, D) projections, not contiguous; at D = 160 the
    # tail panel's tensor maps read them in place too.
    for D in (128, 160):
        x = torch.randn(2, 200, 8 + 2 * 2, D, generator=gen,
                        device="cuda").to(torch.bfloat16)
        q, k, v = (t.transpose(1, 2) for t in x.split([8, 2, 2], dim=2))
        out, route = routed("strided views", q, k, v)
        check_close(f"flash_attention bf16 strided views (2, 8/2, 200, {D}) "
                    f"[{route}]", out.float(), attention_ref(q, k, v).float(),
                    0.0, 2e-2)
    # The simt body stays for f32 and bf16 at D = 16 and 32; forced, it
    # still serves bf16 at D = 160 (the time it is measured against).
    q, k, v = attn_inputs(1, 32, 8, 520, 520, 160, torch.bfloat16, gen)
    out, route = routed("forced simt", q, k, v, force="simt")
    check_close(f"flash_attention bf16 (1, 32/8, 520, 160) forced [{route}]",
                out.float(), attention_ref(q, k, v).float(), 0.0, 2e-2)
    # The backward is the plain version's VJP, as in repro.
    q, k, v = (t.requires_grad_() for t in
               attn_inputs(1, 2, 1, 64, 64, 32, torch.float32, gen))
    flash_attention(q, k, v, window=24).sum().backward()
    grads = [t.grad for t in (q, k, v)]
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    attention_ref(*leaves, window=24).sum().backward()
    for name, g, leaf in zip("qkv", grads, leaves):
        check_close(f"flash_attention d{name} (1, 2/1, 64, 32) f32", g,
                    leaf.grad, 0.0, 2e-3)
    torch.cuda.synchronize()


def live_pairs(Sq: int, Sk: int, causal: bool, window: int) -> int:
    """(query, key) pairs inside the causal/window band, per head."""
    n = 0
    for i in range(Sq):
        qpos = i + Sk - Sq
        hi = min(qpos, Sk - 1) if causal else Sk - 1
        lo = max(qpos - window + 1, 0) if window > 0 else 0
        n += max(hi - lo + 1, 0)
    return n


def flash_row(args, kw, what="layer 0's q/k/v of the prefill"):
    """The flash_attention kernel row on the q/k/v that the prefill's first
    layer gave it (or ``what`` other call): error and time against the
    plain version (run one KV head group at a time: all 32 heads at once
    would hold ~35 GB of f32 scores), its simt body at bf16 (forced
    through ``_launch``'s route), its wgmma body without ping-pong and
    SDPA (causal or not, as the call), and the bound from this call's live
    pairs.

    Outputs here are means of v over up to 8192 keys, ~0.02-0.03 in most
    rows, so repro's bf16 bar of 2e-2 could not tell a dropped key tile
    from rounding. Kernel and plain version both round once to bf16 at
    the end, so they may differ by one rounding step of the output: at
    most 2^-7 of its size (rtol), plus atol 4e-3 for the rest (the wgmma
    body's bf16 P, as in FA3 and SDPA, and f32 reordering). The same
    q/k/v in f32 (the simt body) are held at atol 2e-4 (f32 reordering
    gives ~1e-6 there)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention.ops import _launch
    from repro_torch.kernels.flash_attention.ref import attention_ref
    q, k, v = args
    (B, Hq, Sq, D), (Hkv, Sk) = q.shape, k.shape[1:3]
    g = Hq // Hkv
    causal = kw.get("causal", True)

    def plain():
        return torch.cat([attention_ref(q[:, i * g:(i + 1) * g],
                                        k[:, i:i + 1], v[:, i:i + 1], **kw)
                          for i in range(Hkv)], dim=1)

    def sdpa():
        return F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                              enable_gqa=True)

    def simt():
        return _launch(q, k, v, causal, kw.get("window", 0), D ** -0.5,
                       route="simt")

    out = flash_attention(q, k, v, **kw)
    want = plain().float()
    err = check_close(f"flash_attention on {what} "
                      f"{tuple(q.shape)} / {tuple(k.shape)} {q.dtype} "
                      f"[{dispatch.flash_attention_route(q.dtype, D)}]",
                      out.float(), want, 2.0 ** -7, 4e-3)
    mean_ref = float(want.abs().mean())
    log(f"  mean |plain| {mean_ref:.3e}: max err / mean |plain| "
        f"{err / mean_ref:.3e}")
    check_close("the simt body on the same q/k/v (bf16)", simt().float(),
                want, 2.0 ** -7, 4e-3)
    del want
    q32, k32, v32 = (t.float() for t in (q, k, v))
    want32 = torch.cat([attention_ref(q32[:, i * g:(i + 1) * g],
                                      k32[:, i:i + 1], v32[:, i:i + 1], **kw)
                        for i in range(Hkv)], dim=1)
    err32 = check_close("the same q/k/v in float32",
                        flash_attention(q32, k32, v32, **kw), want32, 0.0,
                        2e-4)
    log(f"  mean |plain| {float(want32.abs().mean()):.3e}: max err / mean "
        f"|plain| {err32 / float(want32.abs().mean()):.3e}")
    del q32, k32, v32, want32
    lib_err = float((sdpa().float() - out.float()).abs().max())
    pairs = B * live_pairs(Sq, Sk, causal, kw.get("window", 0))
    flops = 4.0 * Hq * D * pairs
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    b, why = bound_ms(nbytes, flops, BF16_FLOPS)
    # The wgmma body, SDPA and the wgmma body without ping-pong in turns,
    # three rounds of ten calls each (the card's clocks drift over a run,
    # so back-to-back blocks would favour whichever went first); medians.
    timed = {"ms": lambda: flash_attention(q, k, v, **kw),
             "library_ms": sdpa,
             "no_pingpong_ms": lambda: _launch(
                 q, k, v, causal, kw.get("window", 0), D ** -0.5,
                 pingpong=False)}
    rounds = {name: [] for name in timed}
    for _ in range(3):
        for name, fn in timed.items():
            rounds[name].append(time_ms(fn, 10, 1))
    row = {"name": "flash_attention", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
           "replaces": "src/repro/kernels/flash_attention/kernel.py:101",
           "max_abs_err": err,
           "plain_ms": time_ms(plain, 2, 1),
           "bound_ms": b, "bound_by": why,
           "simt_ms": time_ms(simt, 3, 1),
           **{name: sorted(ts)[1] for name, ts in rounds.items()}}
    row["device_ms"] = device_ms(lambda: flash_attention(q, k, v, **kw))
    log(f"  flash_attention at this shape: {row['ms']:.4f} ms (device "
        f"{fmt_ms(row['device_ms'])}), "
        f"{flops / row['ms'] / 1e9:.2f} TFLOP/s, {b / row['ms']:.3f} of "
        f"the bound; without ping-pong {row['no_pingpong_ms']:.4f} ms; "
        f"SDPA {row['library_ms']:.4f} ms, "
        f"{flops / row['library_ms'] / 1e9:.2f} TFLOP/s [max abs diff "
        f"{lib_err:.2e}] (rounds, ms: "
        + "; ".join(f"{n} {' '.join(f'{t:.4f}' for t in ts)}"
                    for n, ts in rounds.items()) + ")")
    log(f"  simt body at bf16 {row['simt_ms']:.4f} ms, "
        f"{flops / row['simt_ms'] / 1e9:.2f} TFLOP/s; plain "
        f"{row['plain_ms']:.4f} ms; bound {b:.4f} ms by {why}: "
        f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.1f} GFLOP at the bf16 "
        f"tensor-core peak")
    return row


def llama_model():
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    arch = get_config(LLAMA)
    t0 = time.perf_counter()
    model = lm.init_params(arch, seed=0, device="cuda")
    torch.cuda.synchronize()
    n = sum(p.numel() for p in model.parameters())
    nbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    log(f"  {arch.name}: {arch.n_layers} layers, d_model {arch.d_model}, "
        f"{arch.n_heads}/{arch.n_kv_heads} heads of {arch.head_dim_}, d_ff "
        f"{arch.d_ff}, vocab {arch.vocab_size}, {arch.dtype}: {n / 1e9:.3f} "
        f"B parameters ({nbytes / 1e9:.2f} GB), random from seed 0, made on "
        f"the card in {time.perf_counter() - t0:.2f} s")
    return arch, model


def device_profile(fn, top: int = 6):
    """(device busy ms, device operations run, [(name, ms), ...] of the
    ``top`` kernels) of one call of ``fn`` under torch.profiler: the
    union of the kernel, memcpy and memset intervals of its trace (so
    nothing is counted twice), or (None, 0, []) when the trace holds no
    device events on this machine."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    path = os.path.join(ROOT, "build", "profile_trace.json")
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
        os.remove(path)
    except Exception as exc:            # untried profiler: report, go on
        log(f"  torch.profiler gave no device trace ({exc!r})")
        return None, 0, []
    dev = [e for e in events if e.get("cat") in
           ("kernel", "gpu_memcpy", "gpu_memset") and "dur" in e]
    if not dev:
        return None, 0, []
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in dev)
    busy, (lo, hi) = 0.0, spans[0]
    for a, b in spans[1:]:
        if a > hi:
            busy, lo, hi = busy + hi - lo, a, b
        else:
            hi = max(hi, b)
    busy += hi - lo
    by_name = {}
    for e in dev:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + float(e["dur"])
    ranked = sorted(by_name.items(), key=lambda r: -r[1])[:top]
    return busy / 1e3, len(dev), [(n, us / 1e3) for n, us in ranked]


def log_profile(what, prof, wall_ms, n):
    """Device-busy share of ``n`` steps whose untraced wall per step is
    ``wall_ms``, and the kernels that take most of it."""
    total, ops, top = prof
    if total is None:
        log(f"  {what}: device busy time not measured")
        return
    log(f"  {what}: device busy {total / n:.4f} ms per step of "
        f"{wall_ms:.4f} ms wall (idle share {1 - total / n / wall_ms:.3f}; "
        f"torch.profiler trace); {ops / n:.1f} device operations per "
        f"step; top kernels, ms per step:")
    for name, ms in top:
        log(f"    {ms / n:9.4f}  {name[:100]}")


def phase_prefill(arch, model):
    import torch
    from repro_torch.configs import SHAPES
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import layers as L
    from repro_torch.models import lm

    B, S = PREFILL_B, PREFILL_S
    full = SHAPES["prefill_32k"]
    log(f"phase 8: prefill, {arch.name} at full width, B={B} S={S} (cut "
        f"from repro's {full.name}: B={full.global_batch} S={full.seq_len})")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    toks = torch.randint(0, arch.vocab_size, (B, S), generator=gen,
                         device="cuda", dtype=torch.int32)
    with torch.no_grad():
        zero_counts()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        logits = model.prefill(toks)
        torch.cuda.synchronize()
        cold = time.perf_counter() - t0
        measured = measured_peak(before, path_bytes(model, toks))
        got = read_counts()
        routes = dict(flash_attention.route_launches)
        want = dict.fromkeys(got, 0)
        want["flash_attention"] = arch.n_layers
        want_routes = {"wgmma": arch.n_layers, "simt": 0}
        log(f"  launches in the prefill: {got} (expected {want}); "
            f"flash_attention by body {routes} (expected {want_routes})")
        log(f"  first prefill {cold:.4f} s; peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
        if got != want or routes != want_routes:
            raise AssertionError(f"prefill launches {got} {routes}, "
                                 f"expected {want} {want_routes}")
        if logits.shape != (B, 1, arch.vocab_size) \
                or not torch.isfinite(logits).all():
            raise AssertionError(f"prefill logits {tuple(logits.shape)} not "
                                 f"finite of shape (B, 1, V)")
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model.prefill(toks)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        med = sorted(walls)[1]
        log(f"  steady prefills: {' '.join(f'{w:.4f}' for w in walls)} s "
            f"(median {med:.4f} s, {B * S / med:.1f} tokens/s)")
        measured["card_flops"] = recorded_flops(lambda: model.prefill(toks))
        MEASURED[arch.name] = dict(measured, arch=arch, seconds=med,
                                   shape=path_shape(toks))

        timer = PhaseTimer()
        patches = [(L, "flash_attention", "kernel"),
                   (L, "project_qkv", "proj"), (L, "apply_rope", "rope"),
                   (L, "attention_train", "attn"), (L, "mlp", "mlp"),
                   (L, "rmsnorm", "norm"), (lm.LM, "_logits", "logits")]
        saved = [(o, a, getattr(o, a)) for o, a, _ in patches]
        for o, a, label in patches:
            setattr(o, a, timer.wrap(label, getattr(o, a)))
        try:
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            e0.record()
            model.prefill(toks)
            e1.record()
            torch.cuda.synchronize()
        finally:
            for o, a, fn in saved:
                setattr(o, a, fn)
        tot = timer.totals_ms()
        total = e0.elapsed_time(e1)
        e_norm = timer.events["norm"][-1]
        unembed = tot["logits"] - e_norm[0].elapsed_time(e_norm[1])
        split = {
            "flash_attention kernel": tot["kernel"],
            "q/k/v projections (GEMMs)": tot["proj"],
            "rope (q, k)": tot["rope"],
            "attention out (o relayout + wo GEMM)": tot["attn"]
            - tot["proj"] - tot["rope"] - tot["kernel"],
            "MLP (gate/up/down GEMMs, SiLU mul)": tot["mlp"],
            "rmsnorm (2 per layer + final)": tot["norm"],
            "unembed GEMM (last position)": unembed,
            "rest (embed gather, residual adds)": total - tot["attn"]
            - tot["mlp"] - tot["norm"] - unembed,
        }
        log(f"  where a prefill's time goes (device time, ms; traced "
            f"prefill {total:.3f} ms):")
        for name, ms in split.items():
            log(f"    {name:40s} {ms:10.3f}  {100 * ms / total:5.1f}%")
        log_profile("one prefill", device_profile(
            lambda: model.prefill(toks)), med * 1e3, 1)
        row = flash_row(*timer.first["kernel"])
    return row, got["flash_attention"]


def phase_serve(arch, model):
    import numpy as np
    import torch
    from repro_torch.launch.serve import BatchedServer
    from repro_torch.models import layers as L
    from repro_torch.models import lm

    B, P, G = SERVE_B, SERVE_P, SERVE_G
    log(f"phase 9: serving, {arch.name} at full width, "
        f"BatchedServer.generate batch {B}, prompt {P}, generate {G}")
    prompts = np.random.default_rng(0).integers(
        0, arch.vocab_size, (B, P)).astype(np.int32)
    server = BatchedServer(arch, model, max_seq=P + G)
    server.generate(prompts[:, :4], 2)                  # warm-up
    zero_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    with served_logits(model, P - 1) as kept:
        t0 = time.perf_counter()
        out = server.generate(prompts, G)
        wall = time.perf_counter() - t0
    got = read_counts()
    steps = P + G
    log(f"  launches in generate: {got} (expected none: decode attention "
        f"is plain PyTorch, as in repro)")
    log(f"  {steps} decode steps in {wall:.4f} s: {wall / steps * 1e3:.4f} "
        f"ms per step, {B * G / wall:.1f} generated tokens/s "
        f"({B * steps / wall:.1f} tokens/s through the decode path); peak "
        f"device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} "
        f"GiB; sample {out[0][:8].tolist()}")
    if any(got.values()):
        raise AssertionError(f"generate launched kernels: {got}")
    if out.shape != (B, G) or out.dtype != np.int32 \
            or not ((out >= 0) & (out < arch.vocab_size)).all():
        raise AssertionError(f"generate gave {out.dtype} {out.shape}")

    # Where a decode step's time goes: CUDA events over 16 steps of
    # another generate (prompt 8, generate 8).
    timer = PhaseTimer()
    patches = [(L, "attention_decode", "attn"), (L, "project_qkv", "proj"),
               (L, "decode_qkv", "proj"), (L, "apply_rope", "rope"),
               (L, "mlp", "mlp"),
               (L, "rmsnorm", "norm"), (lm.LM, "_logits", "logits")]
    saved = [(o, a, getattr(o, a)) for o, a, _ in patches]
    for o, a, label in patches:
        setattr(o, a, timer.wrap(label, getattr(o, a)))
    try:
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        e0.record()
        server.generate(prompts[:, :8], 8)
        e1.record()
        torch.cuda.synchronize()
        traced = time.perf_counter() - t0
    finally:
        for o, a, fn in saved:
            setattr(o, a, fn)
    tot = timer.totals_ms()
    n = 16
    total = e0.elapsed_time(e1)
    split = {
        "q/k/v projections (GEMVs)": tot["proj"],
        "rope (q, k)": tot["rope"],
        "attention (cache write, repeat, softmax, wo)": tot["attn"]
        - tot["proj"] - tot["rope"],
        "MLP (gate/up/down GEMVs, SiLU mul)": tot["mlp"],
        "rmsnorm": tot["norm"],
        "final norm + unembed": tot["logits"],
        "rest (embed gather, residual adds, argmax)": total - tot["attn"]
        - tot["mlp"] - tot["norm"] - tot["logits"],
    }
    log(f"  where a decode step's time goes (CUDA events, ms per step; "
        f"traced wall {traced / n * 1e3:.3f} ms per step; where the device "
        f"idles between launches these intervals are mostly host time):")
    for name, ms in split.items():
        log(f"    {name:44s} {ms / n:8.4f}  {100 * ms / total:5.1f}%")
    log_profile("16 decode steps", device_profile(
        lambda: server.generate(prompts[:, :8], 8)), wall / steps * 1e3, n)

    # The kernel path against the decode path at full width: the served
    # generate's teacher-forced decode logits at the last prompt position
    # (its cache P + G long) against prefill's.
    with torch.no_grad():
        last = model.prefill(torch.as_tensor(prompts, device="cuda"))
    check_close(f"decode logits at position {P - 1} (the served generate's "
                f"step, cache {P + G}) vs prefill (B={B})",
                kept[0].float(), last.float(), 0.05, 0.12)


def phase_f32_lm():
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.serve import BatchedServer
    from repro_torch.models import lm

    arch = dataclasses.replace(get_config(TINY), n_layers=TINY_LAYERS,
                               dtype="float32")
    B, S = TINY_B, TINY_S
    log(f"phase 10: f32 {TINY} widths at {TINY_LAYERS} layers, B={B} S={S},"
        f" the card (flash_attention) vs the CPU (plain)")
    gpu = lm.init_params(arch, seed=0, device="cuda")
    cpu = lm.LM(arch, "cpu")
    cpu.load_state_dict(gpu.state_dict())
    toks = np.random.default_rng(1).integers(
        0, arch.vocab_size, (B, S)).astype(np.int32)
    with torch.no_grad():
        flash_attention.launches = 0
        lg = gpu.forward(torch.as_tensor(toks, device="cuda")).cpu()
        if flash_attention.launches != TINY_LAYERS:
            raise AssertionError(f"f32 forward launched flash_attention "
                                 f"{flash_attention.launches} times")
        lc = cpu.forward(torch.as_tensor(toks))
    rel = float((lg - lc).abs().max() / lc.abs().max())
    log(f"  logits {tuple(lg.shape)}: max |card - cpu| / max |cpu| "
        f"{rel:.3e} (bar 1e-4)")
    if not rel <= 1e-4:
        raise AssertionError("f32 card logits differ from the CPU's")
    t_gpu = BatchedServer(arch, gpu, 24).generate(toks[:, :16], 8)
    t_cpu = BatchedServer(arch, cpu, 24).generate(toks[:, :16], 8)
    log(f"  generated tokens equal: {bool((t_gpu == t_cpu).all())} "
        f"({t_gpu[0].tolist()})")
    if not (t_gpu == t_cpu).all():
        raise AssertionError("f32 card and CPU generate different tokens")


# ---------------------------------------------------------------------------
# Phase 17: sliding-window attention and the MoE block.
# ---------------------------------------------------------------------------

# (a) mixtral-8x7b at full width, its depth cut from 32 to 16 layers: the
# 32 hold 46.70 B parameters, 93.4 GB at bf16, more than the card's 80 GB;
# 16 hold 23.48 B (46.96 GB) and leave room for the prefill's (E, C, F)
# buffers. (c) granite-moe-1b-a400m at full width and depth. Both prefill
# B 1 at S 8192 (PREFILL_B, PREFILL_S: mixtral's is twice its window, so
# K5's band skips whole key tiles) and serve as phase 9 does.
MIXTRAL, MIXTRAL_LAYERS = "mixtral-8x7b", 16
GRANITE = "granite-moe-1b-a400m"
# (d) f32, the card against the CPU: granite widths at 2 layers, B x S;
# then mixtral-smoke (window 32) serving prompt 40 + 16, so its ring wraps.
MOE_F32_LAYERS, MOE_F32_B, MOE_F32_S = 2, 2, 512
RING_P, RING_G = 40, 16


def moe_model(name, n_layers=None):
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    arch = get_config(name)
    full = arch.n_layers
    if n_layers is not None:
        arch = dataclasses.replace(arch, n_layers=n_layers)
    t0 = time.perf_counter()
    model = lm.init_params(arch, seed=0, device="cuda")
    torch.cuda.synchronize()
    n = sum(p.numel() for p in model.parameters())
    nbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    log(f"  {arch.name}: {arch.n_layers} layers"
        f"{'' if n_layers is None else f' (cut from {full})'}, d_model "
        f"{arch.d_model}, {arch.n_heads}/{arch.n_kv_heads} heads of "
        f"{arch.head_dim_}, {arch.n_experts} experts top {arch.top_k}, "
        f"d_ff {arch.d_ff}, vocab {arch.vocab_size}, window {arch.window}, "
        f"{arch.dtype}: {n / 1e9:.3f} B parameters ({nbytes / 1e9:.2f} GB), "
        f"random from seed 0, made on the card in "
        f"{time.perf_counter() - t0:.2f} s")
    return arch, model, nbytes


# What a split times: (module, attribute, label); the MoE's parts are the
# functions ``layers.moe_tokens`` calls.
def moe_patches():
    from repro_torch.models import layers as L
    from repro_torch.models import lm
    return [(L, "flash_attention", "kernel"), (L, "project_qkv", "proj"),
            (L, "decode_qkv", "proj"),
            (L, "apply_rope", "rope"), (L, "attention_train", "attn"),
            (L, "attention_decode", "attn_decode"),
            (L, "moe_route", "route"), (L, "moe_dispatch", "dispatch"),
            (L, "expert_ffn", "experts"), (L, "moe_combine", "combine"),
            (L, "moe", "moe"), (L, "rmsnorm", "norm"),
            (lm.LM, "_logits", "logits")]


def timed_split(fn, keep=("kernel",), patches=None):
    """(total device ms, {label: ms}, PhaseTimer) of one ``fn()`` with
    CUDA events around each function of ``patches`` (default
    ``moe_patches``); the first call's arguments are kept for the labels
    in ``keep``."""
    import torch
    timer = PhaseTimer()
    patches = moe_patches() if patches is None else patches
    saved = [(o, a, getattr(o, a)) for o, a, _ in patches]
    for o, a, label in patches:
        setattr(o, a, timer.wrap(label, getattr(o, a), label in keep))
    try:
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
    finally:
        for o, a, f in saved:
            setattr(o, a, f)
    tot = timer.totals_ms()
    tot = {label: tot.get(label, 0.0) for _, _, label in patches}
    return e0.elapsed_time(e1), tot, timer


def moe_split(total, tot, attn):
    """The rows of a split: ``attn`` is the attention label
    (``attn`` for a prefill, ``attn_decode`` for a decode step)."""
    moe_parts = tot["route"] + tot["dispatch"] + tot["experts"] \
        + tot["combine"]
    return {
        "K5 (flash_attention)": tot["kernel"],
        "q/k/v projections (GEMMs)": tot["proj"],
        "rope (q, k)": tot["rope"],
        "attention rest (o relayout + wo; decode: cache, softmax)":
            tot[attn] - tot["proj"] - tot["rope"] - tot["kernel"],
        "router + top-k + aux (f32)": tot["route"],
        "dispatch (places by a sort + scatter)": tot["dispatch"],
        "expert products (3 bmm, SiLU mul)": tot["experts"],
        "combine (gather, weight, sum over K)": tot["combine"],
        "MoE rest (reshapes)": tot["moe"] - moe_parts,
        "rmsnorm (2 per layer + final)": tot["norm"],
        "final norm's rest + unembed": tot["logits"],
        "rest (embed gather, residual adds)": total - tot[attn]
        - tot["moe"] - tot["norm"] - tot["logits"],
    }


def log_moe_split(what, total, split, n=1):
    log(f"  where {what}'s time goes (device time by CUDA events, ms"
        f"{'' if n == 1 else ' per step'}; traced {total / n:.3f} ms):")
    for name, ms in split.items():
        log(f"    {name:58s} {ms / n:10.3f}  {100 * ms / total:5.1f}%")


def prefill_inputs(arch, B, S, gen, dtype=None):
    """(tokens, extras) of a prefill of S positions in ``repro``'s
    ``input_specs`` split, drawn by ``gen`` on the card: S random tokens,
    except that a vision-stub arch takes n = min(n_patches, S // 4) random
    patch rows and S - n tokens, and an encoder-decoder arch adds (B,
    encoder_seq, D) random frames; extras in ``dtype`` (default the
    arch's)."""
    import torch
    dtype = dtype or arch.torch_dtype
    n = S - x_text_len(arch, S)
    toks = torch.randint(0, arch.vocab_size, (B, S - n), generator=gen,
                         device="cuda", dtype=torch.int32)
    rows = {"frames": arch.encoder_seq if arch.is_encdec else 0,
            "patches": n}
    return toks, {k: torch.randn(B, r, arch.d_model, generator=gen,
                                 device="cuda").to(dtype)
                  for k, r in rows.items() if r}


def path_bytes(*parts) -> int:
    """Bytes of the tensors of ``parts``: modules (their parameters),
    tensors, and dicts, lists or tuples of them (an AdamW state)."""
    import torch
    total = 0
    for p in parts:
        if isinstance(p, torch.nn.Module):
            total += path_bytes(*p.parameters())
        elif isinstance(p, torch.Tensor):
            total += p.numel() * p.element_size()
        elif isinstance(p, dict):
            total += path_bytes(*p.values())
        elif isinstance(p, (list, tuple)):
            total += path_bytes(*p)
    return total


def measured_peak(before: int, resident: int) -> dict:
    """The path's peak device memory since the last reset of the peak
    statistics: the peak less what was allocated at ``before`` that is not
    the path's (``before`` less its ``resident`` bytes: the model, its
    inputs, the AdamW state); and ``args``, those resident bytes."""
    import torch
    other = before - resident
    return {"peak": torch.cuda.max_memory_allocated() - other,
            "args": resident, "other": other}


def path_shape(toks, extras=None):
    """The ``ShapeConfig`` of a prefill's inputs, as ``input_specs`` splits
    it (a vision-stub arch's patch rows count in its length)."""
    from repro_torch.configs import ShapeConfig
    patches = (extras or {}).get("patches")
    n = 0 if patches is None else patches.shape[1]
    return ShapeConfig("prefill_32k", "prefill", toks.shape[1] + n,
                       toks.shape[0])


def recorded_flops(fn) -> float:
    """The FLOPs ``analysis.record.Recorder`` counts of one ``fn()`` on
    the card (products at dispatch, K5 by its seam's event)."""
    import torch
    from repro_torch.analysis.record import Recorder
    with torch.no_grad(), Recorder() as rec:
        fn()
    torch.cuda.synchronize()
    return sum(t.flops for t in rec.spans())


def counted_prefill(arch, model, toks, extras=None, want_k5=None,
                    steady=3, route="wgmma", kept=None):
    """``model.prefill(toks, extras)`` counted and timed: exactly
    ``want_k5`` K5 launches (default: one a layer with attention), all of
    body ``route``, and no other kernel; finite (B, 1, V) logits; the
    first prefill, peak memory and the median of ``steady`` more, with
    tokens/s over the tokens and patch rows (and frames/s for an
    encoder-decoder arch's frames). ``kept``: a dict that receives K5's
    first call's ((q, k, v), kw) of the last steady prefill. Returns (K5's
    launches, the median s)."""
    import torch
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import layers as L
    from repro_torch.models import lm
    extras = extras or {}
    real_fa = L.flash_attention

    def first_call(q, k, v, **kw):
        kept.setdefault("qkv", ((q, k, v), kw))
        return real_fa(q, k, v, **kw)
    if want_k5 is None:
        want_k5 = sum(arch.block_at(i) in lm.ATTENTION_KINDS
                      for i in range(arch.n_layers))
    B = toks.shape[0]
    with torch.no_grad():
        zero_counts()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        logits = model.prefill(toks, extras)
        torch.cuda.synchronize()
        cold = time.perf_counter() - t0
        measured = measured_peak(before, path_bytes(model, toks, extras))
        got = read_counts()
        routes = dict(flash_attention.route_launches)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        want = dict.fromkeys(got, 0)
        want["flash_attention"] = want_k5
        want_routes = {"wgmma": 0, "simt": 0}
        want_routes[route] = want_k5
        shapes = {k: tuple(v.shape) for k, v in extras.items()}
        meta = f", {arch.meta_tokens} meta rows first" \
            if arch.meta_tokens else ""
        log(f"  prefill tokens {tuple(toks.shape)}{meta}"
            f"{f', extras {shapes}' if shapes else ''}: launches {got} "
            f"(expected {want}); K5 by body {routes} (expected "
            f"{want_routes}); first prefill {cold:.4f} s; peak device "
            f"memory {peak:.3f} GiB")
        if got != want or routes != want_routes:
            raise AssertionError(f"{arch.name} prefill launches {got} "
                                 f"{routes}, expected {want} {want_routes}")
        if logits.shape != (B, 1, arch.vocab_size) \
                or not torch.isfinite(logits).all():
            raise AssertionError(f"{arch.name} prefill logits "
                                 f"{tuple(logits.shape)} not finite")
        walls = []
        for i in range(steady):
            # the last one keeps K5's first call (not the first, whose peak
            # phase 20 reads)
            if kept is not None and i == steady - 1:
                L.flash_attention = first_call
            try:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                model.prefill(toks, extras)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            finally:
                L.flash_attention = real_fa
    med = sorted(walls)[steady // 2]
    tokens = toks.numel() + (extras["patches"].shape[0]
                             * extras["patches"].shape[1]
                             if "patches" in extras else 0)
    frames = ""
    if "frames" in extras:
        n_frames = extras["frames"].shape[0] * extras["frames"].shape[1]
        frames = f", {n_frames / med:.1f} frames/s"
    log(f"  steady prefills: {' '.join(f'{w:.4f}' for w in walls)} s "
        f"(median {med:.4f} s, {tokens / med:.1f} tokens/s{frames})")
    MEASURED[arch.name] = dict(measured, arch=arch, seconds=med,
                               shape=path_shape(toks, extras))
    return got["flash_attention"], med


def k5_held(q, k, v, kw, what):
    """K5 on ``what``'s q/k/v (a prefill's layer 0) against its plain
    version, one KV head group at a time, at the prefill's bar (rtol
    2^-7, atol 4e-3). Returns the error."""
    import torch
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref
    g = q.shape[1] // k.shape[1]
    with torch.no_grad():
        want = torch.cat([attention_ref(q[:, i * g:(i + 1) * g],
                                        k[:, i:i + 1], v[:, i:i + 1], **kw)
                          for i in range(k.shape[1])], dim=1).float()
        return check_close(f"K5 on layer 0's q/k/v of {what} "
                           f"{tuple(q.shape)} / {tuple(k.shape)} {q.dtype} "
                           f"{kw}", flash_attention(q, k, v, **kw).float(),
                           want, 2.0 ** -7, 4e-3)


def moe_prefill(arch, model):
    """Phase 17's prefill of ``arch``: launches, median of three, peak
    memory, the split, and K5 on layer 0's q/k/v against its plain
    version. Returns (launches of K5, its error, layer 0's (q, k, v),
    kw)."""
    import torch

    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    toks = torch.randint(0, arch.vocab_size, (PREFILL_B, PREFILL_S),
                         generator=gen, device="cuda", dtype=torch.int32)
    launches, med = counted_prefill(arch, model, toks,
                                    want_k5=arch.n_layers)
    with torch.no_grad():
        total, tot, timer = timed_split(lambda: model.prefill(toks))
        log_moe_split("a prefill", total, moe_split(total, tot, "attn"))
        log_profile("one prefill", device_profile(
            lambda: model.prefill(toks)), med * 1e3, 1)
    (q, k, v), kw = timer.first["kernel"]
    del timer
    err = k5_held(q, k, v, kw, f"the {arch.name} prefill")
    return launches, err, (q, k, v), kw


@contextlib.contextmanager
def served_logits(model, pos: int):
    """Within the block, the logits of each ``model.decode_step`` at
    position ``pos`` (a generate's last prompt position: its prompt is
    teacher-forced through decode_step), appended to the list it
    yields."""
    kept, real = [], model.decode_step

    def step(tokens, cache, p, *args, **kw):
        out = real(tokens, cache, p, *args, **kw)
        if p == pos:
            kept.append(out[0].detach().clone())
        return out
    model.decode_step = step
    try:
        yield kept
    finally:
        del model.decode_step


def moe_serve(arch, model, nbytes_read, patches=None, split=None,
              diagnose=True):
    """Phase 17's serving run: ``BatchedServer.generate`` at phase 9's
    batch, prompt and length; no kernel launched (decode attention is
    plain PyTorch); ms per step against the bytes a step reads (every
    weight but the embedding table, whose B rows are gathered, since the
    dispatch runs all E experts' buffers) at the HBM rate; with
    ``diagnose``, the split of a decode step over ``patches`` by
    ``split(total, tot, timer)`` (default: the MoE's) and the busy share.
    Phase 18 serves the recurrent archs through it. Returns the timed
    generate's decode logits at the last prompt position (its prompt is
    ``decode_vs_prefill``'s, teacher-forced)."""
    import numpy as np
    import torch
    from repro_torch.launch.serve import BatchedServer

    B, P, G = SERVE_B, SERVE_P, SERVE_G
    prompts = np.random.default_rng(0).integers(
        0, arch.vocab_size, (B, P)).astype(np.int32)
    server = BatchedServer(arch, model, max_seq=P + G)
    server.generate(prompts[:, :4], 2)                  # warm-up
    zero_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    with served_logits(model, P - 1) as kept:
        t0 = time.perf_counter()
        out = server.generate(prompts, G)
        wall = time.perf_counter() - t0
    got = read_counts()
    steps = P + G
    step_ms = wall / steps * 1e3
    bound = nbytes_read / HBM_BYTES_PER_S * 1e3
    log(f"  serving batch {B}, prompt {P}, generate {G}: launches {got} "
        f"(expected none); {steps} decode steps in {wall:.4f} s: "
        f"{step_ms:.4f} ms per step, {B * G / wall:.1f} generated tokens/s;"
        f" a step reads {nbytes_read / 1e9:.2f} GB of weights: bound "
        f"{bound:.4f} ms at the HBM rate, the step at {step_ms / bound:.2f}x"
        f" it; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; sample "
        f"{out[0][:8].tolist()}")
    if any(got.values()):
        raise AssertionError(f"generate launched kernels: {got}")
    if out.shape != (B, G) or out.dtype != np.int32 \
            or not ((out >= 0) & (out < arch.vocab_size)).all():
        raise AssertionError(f"generate gave {out.dtype} {out.shape}")
    if not diagnose:
        return kept[0]
    t0 = time.perf_counter()
    total, tot, timer = timed_split(
        lambda: server.generate(prompts[:, :8], 8), keep=(),
        patches=patches)
    traced = time.perf_counter() - t0
    log(f"  16 decode steps of another generate (prompt 8, generate 8) "
        f"under CUDA events: traced wall {traced / 16 * 1e3:.3f} ms per "
        f"step; where the device idles between launches these intervals "
        f"are mostly host time")
    log_moe_split("a decode step", total,
                  moe_split(total, tot, "attn_decode") if split is None
                  else split(total, tot, timer), 16)
    log_profile("16 decode steps", device_profile(
        lambda: server.generate(prompts[:, :8], 8)), step_ms, 16)
    return kept[0]


def sdpa_backend(q, k, v, mask):
    """The backend ``scaled_dot_product_attention`` picks for these
    operands (its dispatcher's own choice), or why it cannot say."""
    import torch
    from torch.nn.attention import SDPBackend
    try:
        return SDPBackend(torch._fused_sdp_choice(
            q, k, v, mask, 0.0, False, scale=None, enable_gqa=True)).name
    except Exception as exc:             # private API: report, go on
        return f"unknown ({exc!r})"


def window_row(q, k, v, kw, launches, err, prefix="window",
               what="mixtral's"):
    """K5's windowed call at ``what`` shape (layer 0's q/k/v): its time
    through the wrapper, device time, plain version, SDPA with an explicit
    band mask, the same call at window 0, and the bound from this call's
    live pairs, as the ``prefix``_... keys of K5's row (mixtral's:
    window_..., and window0_ms)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref
    (B, Hq, Sq, D), (Hkv, Sk) = q.shape, k.shape[1:3]
    g, window = Hq // Hkv, kw["window"]
    pos = torch.arange(Sq, device=q.device)
    band = (pos[None, :] <= pos[:, None]) \
        & (pos[None, :] > pos[:, None] - window)
    backend = sdpa_backend(q, k, v, band)

    def plain():
        return torch.cat([attention_ref(q[:, i * g:(i + 1) * g],
                                        k[:, i:i + 1], v[:, i:i + 1], **kw)
                          for i in range(Hkv)], dim=1)

    def sdpa():
        return F.scaled_dot_product_attention(q, k, v, attn_mask=band,
                                              enable_gqa=True)

    lib_err = float((sdpa().float() - plain().float()).abs().max())
    # The windowed call, the same call at window 0 and SDPA in turns,
    # three rounds of ten calls (five of SDPA); medians.
    timed = {"ms": (lambda: flash_attention(q, k, v, **kw), 10),
             "window0_ms": (lambda: flash_attention(q, k, v, causal=True,
                                                    window=0), 10),
             "library_ms": (sdpa, 5)}
    rounds = {name: [] for name in timed}
    for _ in range(3):
        for name, (fn, reps) in timed.items():
            rounds[name].append(time_ms(fn, reps, 1))
    med = {name: sorted(ts)[1] for name, ts in rounds.items()}
    pairs = B * live_pairs(Sq, Sk, True, window)
    pairs0 = B * live_pairs(Sq, Sk, True, 0)
    flops = 4.0 * Hq * D * pairs
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    b, why = bound_ms(nbytes, flops, BF16_FLOPS)
    w0 = "window0_ms" if prefix == "window" else f"{prefix}_window0_ms"
    row = {f"{prefix}_launches": launches, f"{prefix}_max_abs_err": err,
           f"{prefix}_ms": med["ms"],
           f"{prefix}_device_ms": device_ms(
               lambda: flash_attention(q, k, v, **kw)),
           f"{prefix}_plain_ms": time_ms(plain, 2, 1),
           f"{prefix}_bound_ms": b, f"{prefix}_bound_by": why,
           f"{prefix}_library_ms": med["library_ms"],
           w0: med["window0_ms"]}
    ms = row[f"{prefix}_ms"]
    ratio = ms / row[w0]
    log(f"  K5 windowed at {what} shape {tuple(q.shape)} / "
        f"{tuple(k.shape)} bf16, window {window}: {ms:.4f} "
        f"ms (device {fmt_ms(row[f'{prefix}_device_ms'])}), "
        f"{flops / ms / 1e9:.1f} TFLOP/s, {b / ms:.3f}"
        f" of the bound ({b:.4f} ms by {why}: {pairs} live pairs, "
        f"{flops / 1e9:.1f} GFLOP); plain {row[f'{prefix}_plain_ms']:.4f} "
        f"ms; SDPA with the (S, S) band mask "
        f"{row[f'{prefix}_library_ms']:.4f} ms "
        f"(backend {backend}; max |SDPA - plain| {lib_err:.2e}) (rounds, "
        f"ms: " + "; ".join(f"{n} {' '.join(f'{t:.4f}' for t in ts)}"
                            for n, ts in rounds.items()) + ")")
    log(f"  the same call at window 0 ({pairs0} live pairs, "
        f"{pairs / pairs0:.3f} of them): {row[w0]:.4f} ms; "
        f"windowed / window 0 = {ratio:.3f}")
    if ratio > 0.9:
        log("  FINDING: the windowed call takes as long as window 0: the "
            "band does not skip whole key tiles")
    return row


def moe_f32_card_vs_cpu():
    """Phase 17 (d): f32 granite widths at 2 layers, card against CPU
    from the same weights; then mixtral-smoke serving through a ring that
    wraps."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.serve import BatchedServer
    from repro_torch.models import layers as L
    from repro_torch.models import lm

    arch = dataclasses.replace(get_config(GRANITE), n_layers=MOE_F32_LAYERS,
                               dtype="float32")
    B, S = MOE_F32_B, MOE_F32_S
    log(f"phase 17 (d): f32 {GRANITE} widths at {MOE_F32_LAYERS} layers, "
        f"B={B} S={S}, the card against the CPU")
    gpu = lm.init_params(arch, seed=0, device="cuda")
    cpu = lm.LM(arch, "cpu")
    cpu.load_state_dict(gpu.state_dict())
    rng = np.random.default_rng(1)
    toks = rng.integers(0, arch.vocab_size, (B, S)).astype(np.int32)
    batch = {"tokens": toks,
             "targets": rng.integers(0, arch.vocab_size,
                                     (B, S)).astype(np.int32)}
    picks = {"cuda": [], "cpu": []}
    outs = {"cuda": [], "cpu": []}
    route, combine = L.moe_route, L.moe_combine

    def recorded(router, xf, top_k, dp=None):
        out = route(router, xf, top_k, dp)
        picks[xf.device.type].append((router, xf, out[1]))
        return out

    def combined(out_buf, row, keep, topw):
        out = combine(out_buf, row, keep, topw)
        outs[out.device.type].append((out.cpu(), int((~keep).sum())))
        return out
    L.moe_route, L.moe_combine = recorded, combined
    try:
        with torch.no_grad():
            flash_attention.launches = 0
            lg, aux_g = gpu.forward_aux(torch.as_tensor(toks, device="cuda"))
            lg, aux_g = lg.cpu(), float(aux_g)
            if flash_attention.launches != MOE_F32_LAYERS:
                raise AssertionError(f"f32 forward launched K5 "
                                     f"{flash_attention.launches} times")
            lc, aux_c = cpu.forward_aux(torch.as_tensor(toks))
            aux_c = float(aux_c)
            loss_g = float(lm.train_loss(gpu, batch))
            loss_c = float(lm.train_loss(cpu, batch))
    finally:
        L.moe_route, L.moe_combine = route, combine
    # The chosen experts, layer by layer (the forwards' calls), with the
    # CPU's gap between each token's K-th and (K+1)-th probability.
    K = arch.top_k
    differ, near = 0, 0
    for (_, _, eg), (router, xf, ec) in zip(picks["cuda"][:MOE_F32_LAYERS],
                                             picks["cpu"][:MOE_F32_LAYERS]):
        probs = torch.softmax(xf.float() @ router, dim=-1)
        top = torch.sort(probs, dim=-1, descending=True).values
        gap = top[:, K - 1] - top[:, K]
        same = (eg.cpu().sort(-1).values == ec.sort(-1).values).all(-1)
        differ += int((~same).sum())
        near += int((gap < 1e-5).sum())
        if bool((~same & (gap >= 1e-5)).any()):
            raise AssertionError("f32 card and CPU pick other experts away "
                                 "from a near-tie")
    rel = float((lg - lc).abs().max() / lc.abs().max())
    worst = int((lg - lc).abs().amax(-1).reshape(-1).argmax())
    for i, ((og, dg), (oc, dc)) in enumerate(zip(
            outs["cuda"][:MOE_F32_LAYERS], outs["cpu"][:MOE_F32_LAYERS])):
        log(f"  layer {i}: MoE output max |card - cpu| "
            f"{float((og - oc).abs().max()):.3e} (max |cpu| "
            f"{float(oc.abs().max()):.3e}; at token "
            f"{int((og - oc).abs().amax(-1).argmax())}); dropped picks "
            f"{dg} / {dc}")
    log(f"  the CPU: {torch.backends.cpu.get_cpu_capability()}, "
        f"{torch.get_num_threads()} threads, float32 matmul precision "
        f"{torch.get_float32_matmul_precision()}; the largest logits "
        f"difference at token {worst}")
    rel_aux = abs(aux_g - aux_c) / abs(aux_c)
    rel_loss = abs(loss_g - loss_c) / abs(loss_c)
    log(f"  logits {tuple(lg.shape)}: max |card - cpu| / max |cpu| "
        f"{rel:.3e} (bar 1e-4); aux {aux_g:.7f} / {aux_c:.7f}, rel "
        f"{rel_aux:.3e} (bar 1e-5); train_loss {loss_g:.7f} / {loss_c:.7f},"
        f" rel {rel_loss:.3e} (bar 1e-5); tokens whose experts differ "
        f"{differ} of {B * S} x {MOE_F32_LAYERS} layers, {near} within 1e-5 "
        f"of a top-{K} tie")
    if not (rel <= 1e-4 and rel_aux <= 1e-5 and rel_loss <= 1e-5):
        raise AssertionError("f32 card and CPU differ")
    del gpu, cpu, picks, outs

    smoke = dataclasses.replace(get_smoke_config(MIXTRAL), dtype="float32")
    gpu = lm.init_params(smoke, seed=0, device="cuda")
    cpu = lm.LM(smoke, "cpu")
    cpu.load_state_dict(gpu.state_dict())
    prompts = rng.integers(0, smoke.vocab_size, (4, RING_P)).astype(np.int32)
    t_gpu = BatchedServer(smoke, gpu, RING_P + RING_G).generate(prompts,
                                                                RING_G)
    t_cpu = BatchedServer(smoke, cpu, RING_P + RING_G).generate(prompts,
                                                                RING_G)
    ring = lm.init_cache(smoke, 1, RING_P + RING_G, "cpu")["k"][0].shape[2]
    log(f"  {smoke.name} f32 serving prompt {RING_P} + {RING_G} through a "
        f"ring of {ring} (window {smoke.window}): card tokens equal the "
        f"CPU's: {bool((t_gpu == t_cpu).all())} ({t_gpu[0].tolist()})")
    if ring != smoke.window or not (t_gpu == t_cpu).all():
        raise AssertionError("mixtral-smoke ring serving: card and CPU "
                             "differ")




def phase_moe():
    """Phase 17: (a) mixtral-8x7b at full width (16 layers): prefill,
    serving; (b) K5's windowed call at its shape; (c) granite-moe-1b at
    full width and depth: prefill, serving; (d) f32 card against CPU;
    (e) the CLI (run with phase 16's, ``phase_launchers``). Returns
    what K5's row gains."""
    import gc
    import torch
    t0 = time.perf_counter()
    log(f"phase 17 (a): {MIXTRAL} at full width, depth cut to "
        f"{MIXTRAL_LAYERS} layers")
    arch, model, nbytes = moe_model(MIXTRAL, MIXTRAL_LAYERS)
    launches, err, (q, k, v), kw = moe_prefill(arch, model)
    if kw.get("window") != arch.window:
        raise AssertionError(f"mixtral's K5 call took {kw}, not window "
                             f"{arch.window}")
    embed = model.embed.numel() * model.embed.element_size()
    moe_serve(arch, model, nbytes - embed)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 17 (b): K5's windowed call at {MIXTRAL}'s shape")
    row = window_row(q, k, v, kw, launches, err)
    del q, k, v
    torch.cuda.empty_cache()
    log(f"phase 17 (c): {GRANITE} at full width and depth")
    arch, model, nbytes = moe_model(GRANITE)
    moe_prefill(arch, model)
    embed = model.embed.numel() * model.embed.element_size()
    moe_serve(arch, model, nbytes - embed)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    moe_f32_card_vs_cpu()
    torch.cuda.empty_cache()
    log(f"phase 17 done in {time.perf_counter() - t0:.1f} s")
    return row


# ---------------------------------------------------------------------------
# Phase 18: the recurrent blocks (hymba's hybrid block, xLSTM).
# ---------------------------------------------------------------------------

# (a) hymba-1.5b at full width and depth, prefilled at B 1, S 8192 (8320
# positions with its 128 meta tokens); (b) xlstm-350m at full width and
# depth, its prefill cut from S 8192 to 2048: the sLSTM is S dependent
# steps of ~20 eager operations a layer, which the host launches one by
# one (12 layers x 8192 steps would take ~20 s a prefill); its steady
# prefills cut from three to XLSTM_STEADY, three prefills in all with the
# first and the split's (each takes ~6 s, and phase 19 needs the time).
# Both serve as phase 9 does.
HYMBA, XLSTM, XLSTM_S, XLSTM_STEADY = "hymba-1.5b", "xlstm-350m", 2048, 1
# (c) f32 card against CPU at hymba and xlstm widths, 2 layers, B x S; the
# smoke configs serve prompt RING_P + RING_G (hymba-smoke's ring of 32
# wraps).
REC_F32_LAYERS, REC_F32_B, REC_F32_S = 2, 2, 512


def recurrent_model(name):
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    arch = get_config(name)
    t0 = time.perf_counter()
    model = lm.init_params(arch, seed=0, device="cuda")
    torch.cuda.synchronize()
    n = sum(p.numel() for p in model.parameters())
    nbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    log(f"  {arch.name}: {arch.n_layers} layers {arch.block_pattern}, "
        f"d_model {arch.d_model}, {arch.n_heads}/{arch.n_kv_heads} heads "
        f"of {arch.head_dim_}, SSM heads {arch.ssm_heads} of key dim "
        f"{arch.ssm_state}, d_ff {arch.d_ff}, vocab {arch.vocab_size}, "
        f"window {arch.window}, {arch.meta_tokens} meta tokens, "
        f"{arch.dtype}: {n / 1e9:.4f} B parameters ({nbytes / 1e9:.2f} GB),"
        f" random from seed 0, made on the card in "
        f"{time.perf_counter() - t0:.2f} s")
    return arch, model, nbytes


# What phase 18's splits time: the attention's parts, the recurrent
# module's functions (``chunked_gla`` calls ``gla_intra`` and
# ``gla_inter``), the MLP, the norms and the unembedding.
def recurrent_patches():
    from repro_torch.models import layers as L
    from repro_torch.models import lm
    from repro_torch.models import recurrent as R
    return [(L, "flash_attention", "kernel"), (L, "project_qkv", "proj"),
            (L, "decode_qkv", "proj"),
            (L, "apply_rope", "rope"), (L, "attention_train", "attn"),
            (L, "attention_decode", "attn_decode"),
            (R, "_ssm_qkva", "ssm_proj"), (R, "gla_intra", "intra"),
            (R, "gla_inter", "inter"), (R, "gla_step", "gla_step"),
            (R, "ssm_heads_train", "ssm"), (R, "ssm_heads_step", "ssm_step"),
            (R, "_mlstm_qkvifa", "mlstm_proj"), (R, "mlstm_train", "mlstm"),
            (R, "mlstm_step", "mlstm_step"), (R, "_slstm_pre", "slstm_proj"),
            (R, "slstm_scan", "slstm_scan"), (R, "slstm_train", "slstm"),
            (L, "mlp", "mlp"), (L, "rmsnorm", "norm"),
            (lm.LM, "_logits", "logits")]


def recurrent_split(total, tot, unembed, decode=False):
    """The rows of a phase 18 split (labels of ``recurrent_patches``);
    ``unembed`` is the logits' time less the final norm's."""
    attn = tot["attn_decode"] if decode else tot["attn"]
    ssm = tot["ssm_step"] if decode else tot["ssm"]
    mlstm = tot["mlstm_step"] if decode else tot["mlstm"]
    gla = tot["gla_step"] if decode else tot["intra"] + tot["inter"]
    rows = {}
    if attn and not decode:
        rows["K5 (flash_attention)"] = tot["kernel"]
    if attn:
        rows.update({
            "q/k/v projections (GEMMs)": tot["proj"],
            "rope (q, k)": tot["rope"],
            "attention rest (o relayout + wo; decode: cache, softmax)":
                attn - tot["proj"] - tot["rope"] - tot["kernel"]})
    if ssm:
        rows["SSM projections (q, k, v, decay)"] = tot["ssm_proj"]
    if ssm or mlstm:
        if decode:
            rows["recurrence step (gla_step)"] = gla
        else:
            rows["chunked_gla intra-chunk (C x C products)"] = tot["intra"]
            rows["chunked_gla inter-chunk (the boundary loop)"] = \
                tot["inter"]
    if ssm:
        rows["SSM gate and out"] = ssm - tot["ssm_proj"] - (
            gla if not mlstm else 0)
    if mlstm:
        rows["mLSTM projections (q, k, v, gates)"] = tot["mlstm_proj"]
        rows["mLSTM gate, normaliser and out"] = \
            mlstm - tot["mlstm_proj"] - gla
    if tot["slstm"]:
        rows["sLSTM input projections"] = tot["slstm_proj"]
        rows["sLSTM scan (dependent steps)"] = tot["slstm_scan"]
        rows["sLSTM out"] = tot["slstm"] - tot["slstm_proj"] \
            - tot["slstm_scan"]
    if tot["mlp"]:
        rows["MLP (gate/up/down GEMMs, SiLU mul)"] = tot["mlp"]
    rows["rmsnorm"] = tot["norm"]
    rows["unembed (last position)"] = unembed
    rows["rest (embed gather, meta rows, residual adds)"] = total - attn \
        - ssm - mlstm - tot["slstm"] - tot["mlp"] - tot["norm"] - unembed
    return rows


def unembed_ms(tot, timer):
    """The logits' time less the final norms': the last norm of each
    ``LM._logits`` call (every call of the traced function runs the same
    number of norms)."""
    norms = timer.events.get("norm", [])
    calls = len(timer.events.get("logits", []))
    if not calls:
        return 0.0
    per = len(norms) // calls
    return tot["logits"] - sum(a.elapsed_time(b)
                               for a, b in norms[per - 1::per])


def traced_prefill(arch, model, toks, extras=None, steady=3):
    """A prefill of ``toks`` (and ``extras``) through ``counted_prefill``
    (K5 once a layer with attention, all wgmma, nothing else; the median
    of ``steady``), then its split by CUDA events over
    ``recurrent_patches`` and the busy share (phases 18 and 19). Returns
    (K5's launches, layer 0's (q, k, v), kw), or (0, None, None) without
    attention."""
    import torch
    launches, med = counted_prefill(arch, model, toks, extras,
                                    steady=steady)
    with torch.no_grad():
        total, tot, timer = timed_split(lambda: model.prefill(toks, extras),
                                        patches=recurrent_patches())
        log_moe_split("a prefill", total, recurrent_split(
            total, tot, unembed_ms(tot, timer)))
        if launches:
            log_profile("one prefill", device_profile(
                lambda: model.prefill(toks, extras)), med * 1e3, 1)
            (q, k, v), kw = timer.first["kernel"]
            return launches, (q, k, v), kw
    return 0, None, None


def decode_vs_prefill(arch, model, what, hold=True, extras=None,
                      logits=None):
    """Teacher-forced decode's logits at the last of 128 prompt positions
    (batch 8) against ``prefill``'s, with the meta tokens off: decode
    never sees them, in ``repro`` too, so with them the two differ by
    design. ``extras["frames"]`` (an encoder-decoder arch) fill decode's
    cross cache and go to the prefill. ``logits``: those decode logits
    as a served generate of the same prompts gave them
    (``served_logits``, its cache P + G long), in place of a decode of
    its own. Held to ``repro``'s bar (atol 0.12, rtol 0.05) if ``hold``,
    else only logged."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.models import lm
    B, P = SERVE_B, SERVE_P
    served = None if logits is None else SERVE_P + SERVE_G
    prompts = np.random.default_rng(0).integers(
        0, arch.vocab_size, (B, P)).astype(np.int32)
    model.arch = dataclasses.replace(arch, meta_tokens=0)
    try:
        with torch.no_grad():
            toks = torch.as_tensor(prompts, device="cuda")
            if logits is None:
                cache = lm.init_cache(model.arch, B, P, "cuda")
                if extras:
                    model.fill_cross_cache(cache, extras["frames"])
                for t in range(P):
                    logits, cache = model.decode_step(toks[:, t:t + 1],
                                                      cache, t)
            last = model.prefill(toks, extras)
    finally:
        model.arch = arch
    source = "" if served is None else \
        f", the served generate's step (cache {served})"
    name = (f"{arch.name}{what} decode logits at position {P - 1} vs "
            f"prefill (B={B}, meta_tokens 0, {arch.dtype}{source}; max "
            f"|prefill logit| {float(last.float().abs().max()):.4f})")
    if hold:
        check_close(name, logits.float(), last.float(), 0.05, 0.12)
    else:
        log(f"  {name}: max_abs_err "
            f"{float((logits.float() - last.float()).abs().max()):.3e} "
            f"(logged, not held)")


def slstm_step_ops(arch):
    """Device operations and host ms of one sLSTM step at ``arch``'s full
    width (B 1), from 16 steps of ``recurrent.slstm_scan``."""
    import torch
    from repro_torch.models import recurrent as R
    H, dh = arch.n_heads, arch.d_model // arch.n_heads
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    pre = torch.randn(16, H, 1, 4 * dh, generator=gen, device="cuda")
    r = torch.randn(H, dh, 4 * dh, generator=gen, device="cuda") * dh ** -0.5
    state = tuple(torch.zeros(H, 1, dh, device="cuda") for _ in range(4))
    with torch.no_grad():
        step_ms = time_ms(lambda: R.slstm_scan(pre, r, state), 5) / 16
        busy, ops, _ = device_profile(lambda: R.slstm_scan(pre, r, state))
    log(f"  an sLSTM step at d {arch.d_model}, {H} heads of {dh}: "
        f"{ops / 16:.1f} device operations, {step_ms:.4f} ms of wall "
        f"(CUDA events over 16 steps), device busy "
        f"{fmt_ms(None if busy is None else busy / 16)} ms")


def recurrent_serve(arch, model, nbytes):
    """Serving at phase 9's batch, prompt and length through
    ``moe_serve`` (no kernel; ms per step against every weight but the
    embedding table at the HBM rate; the split), then decode against
    prefill at meta_tokens 0 at full depth: logged at bf16, where the
    two paths' roundings drift apart over the depth (hymba's 32 layers
    miss ``repro``'s bar), and held to that bar with the model cast to
    f32. The bf16 models are held to it at 2 layers, in (c)."""
    import dataclasses
    embed = model.embed.numel() * model.embed.element_size()
    served = moe_serve(arch, model, nbytes - embed,
                       patches=recurrent_patches(),
                       split=lambda total, tot, timer: recurrent_split(
                           total, tot, unembed_ms(tot, timer), decode=True))
    decode_vs_prefill(arch, model, " (full depth)", hold=False,
                      logits=served)
    del served
    model.float()
    decode_vs_prefill(dataclasses.replace(arch, dtype="float32"), model,
                      " (full depth)")


def recurrent_f32_card_vs_cpu():
    """Phase 18 (c): f32 at hymba and xlstm widths, 2 layers, the card
    against the CPU from the same weights; at bf16, decode against
    prefill at meta_tokens 0 at ``repro``'s bar; the smoke configs'
    serving."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.serve import BatchedServer
    from repro_torch.models import lm

    B, S = REC_F32_B, REC_F32_S
    rng = np.random.default_rng(1)
    for name in (HYMBA, XLSTM):
        arch = dataclasses.replace(get_config(name),
                                   n_layers=REC_F32_LAYERS, dtype="float32")
        log(f"phase 18 (c): f32 {name} widths at {REC_F32_LAYERS} layers, "
            f"B={B} S={S} ({S + arch.meta_tokens} positions), the card "
            f"against the CPU")
        gpu = lm.init_params(arch, seed=0, device="cuda")
        cpu = lm.LM(arch, "cpu")
        cpu.load_state_dict(gpu.state_dict())
        batch = {"tokens": rng.integers(0, arch.vocab_size,
                                        (B, S)).astype(np.int32),
                 "targets": rng.integers(0, arch.vocab_size,
                                         (B, S)).astype(np.int32)}
        want = sum(arch.block_at(i) in lm.ATTENTION_KINDS
                   for i in range(arch.n_layers))
        with torch.no_grad():
            flash_attention.launches = 0
            lg = gpu.forward(torch.as_tensor(batch["tokens"],
                                             device="cuda")).cpu()
            if flash_attention.launches != want:
                raise AssertionError(f"f32 forward launched K5 "
                                     f"{flash_attention.launches} times, "
                                     f"not {want}")
            lc = cpu.forward(torch.as_tensor(batch["tokens"]))
            loss_g = float(lm.train_loss(gpu, batch))
            loss_c = float(lm.train_loss(cpu, batch))
        rel = float((lg - lc).abs().max() / lc.abs().max())
        rel_loss = abs(loss_g - loss_c) / abs(loss_c)
        log(f"  logits {tuple(lg.shape)}: max |card - cpu| / max |cpu| "
            f"{rel:.3e} (bar 1e-4); train_loss {loss_g:.7f} / "
            f"{loss_c:.7f}, rel {rel_loss:.3e} (bar 1e-5); K5 launches "
            f"{want}")
        if not (rel <= 1e-4 and rel_loss <= 1e-5):
            raise AssertionError(f"f32 {name}: card and CPU differ")
        del gpu, cpu
        bf16 = dataclasses.replace(arch, dtype="bfloat16")
        decode_vs_prefill(bf16, lm.init_params(bf16, seed=0, device="cuda"),
                          f" ({REC_F32_LAYERS} layers)")

        smoke = dataclasses.replace(get_smoke_config(name), dtype="float32")
        gpu = lm.init_params(smoke, seed=0, device="cuda")
        cpu = lm.LM(smoke, "cpu")
        cpu.load_state_dict(gpu.state_dict())
        prompts = rng.integers(0, smoke.vocab_size,
                               (4, RING_P)).astype(np.int32)
        t_gpu = BatchedServer(smoke, gpu, RING_P + RING_G).generate(
            prompts, RING_G)
        t_cpu = BatchedServer(smoke, cpu, RING_P + RING_G).generate(
            prompts, RING_G)
        cache = lm.init_cache(smoke, 1, RING_P + RING_G, "cpu")
        ring = cache["k"][0].shape[2] if "k" in cache else None
        log(f"  {smoke.name} f32 serving prompt {RING_P} + {RING_G}"
            f"{'' if ring is None else f' through a ring of {ring}'}, "
            f"cache entries {sorted(cache)}: card tokens equal the CPU's: "
            f"{bool((t_gpu == t_cpu).all())} ({t_gpu[0].tolist()})")
        if not (t_gpu == t_cpu).all() or ring not in (None, smoke.window):
            raise AssertionError(f"{smoke.name} serving: card and CPU "
                                 f"differ")




def phase_recurrent():
    """Phase 18: (a) hymba-1.5b at full width and depth: prefill (K5 32
    times, windowed), K5 at its shape, serving; (b) xlstm-350m at full
    width and depth: prefill at S 2048 (no kernel), an sLSTM step's
    operations, serving; (c) f32 card against CPU; (d) the CLI (run with
    phase 16's, ``phase_launchers``). Returns
    what K5's row gains."""
    import gc
    import torch
    t0 = time.perf_counter()
    log(f"phase 18 (a): {HYMBA} at full width and depth")
    arch, model, nbytes = recurrent_model(HYMBA)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    toks, _ = prefill_inputs(arch, 1, PREFILL_S, gen)
    launches, (q, k, v), kw = traced_prefill(arch, model, toks)
    if kw.get("window") != arch.window:
        raise AssertionError(f"hymba's K5 call took {kw}, not window "
                             f"{arch.window}")
    recurrent_serve(arch, model, nbytes)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    err = k5_held(q, k, v, kw, f"the {HYMBA} prefill")
    row = window_row(q, k, v, kw, launches, err, prefix="hymba",
                     what="hymba's")
    del q, k, v
    torch.cuda.empty_cache()

    log(f"phase 18 (b): {XLSTM} at full width and depth, prefill cut to "
        f"S {XLSTM_S}")
    arch, model, nbytes = recurrent_model(XLSTM)
    gen.manual_seed(2)
    traced_prefill(arch, model, prefill_inputs(arch, 1, XLSTM_S, gen)[0],
                   steady=XLSTM_STEADY)
    slstm_step_ops(arch)
    recurrent_serve(arch, model, nbytes)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    recurrent_f32_card_vs_cpu()
    torch.cuda.empty_cache()
    log(f"phase 18 done in {time.perf_counter() - t0:.1f} s")
    return row


# ---------------------------------------------------------------------------
# Phase 19: the encoder-decoder (whisper) and the vision stub (pixtral).
# ---------------------------------------------------------------------------

# (a) whisper-large-v3 at full width and depth (32 encoder and 32 decoder
# layers): a prefill of WHISPER_B clips of encoder_seq = 1,500 stub frames
# (repro's input_specs shape) and WHISPER_S decoder tokens (448: Whisper's
# published decoder context, n_text_ctx in openai/whisper's
# ModelDimensions); serving at phase 9's batch, prompt and length, with
# the cross cache filled from the same clips.
WHISPER, WHISPER_B, WHISPER_S = "whisper-large-v3", 8, 448
# (b) pixtral-12b at full width and depth, prefilled at B 1, S 8192 in
# input_specs' split at that length (min(n_patches, S // 4) = 1,024 patch
# rows, then 7,168 tokens), and served as in (a) without patches: decode
# carries none, as in repro.
PIXTRAL = "pixtral-12b"
# (c) f32, the card against the CPU: whisper widths at 2 + 2 layers, B 2,
# its 1,500 frames and S 64 tokens; pixtral widths at 2 layers, B 2, S 512
# positions in input_specs' split (128 patches, 384 tokens).
ENC_F32_LAYERS, ENC_F32_B, WHISPER_F32_S, PIXTRAL_F32_S = 2, 2, 64, 512


def stub_model(name):
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    arch = get_config(name)
    t0 = time.perf_counter()
    model = lm.init_params(arch, seed=0, device="cuda")
    torch.cuda.synchronize()
    n = sum(p.numel() for p in model.parameters())
    nbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    enc = sum(p.numel() for p in model.encoder.parameters()) \
        if arch.is_encdec else 0
    encoder = (f" + {arch.encoder_layers} encoder layers over "
               f"{arch.encoder_seq} frames") if enc else ""
    log(f"  {arch.name}: {arch.n_layers} decoder layers{encoder}"
        f", d_model {arch.d_model}, {arch.n_heads}/{arch.n_kv_heads} heads "
        f"of {arch.head_dim_}, d_ff {arch.d_ff} ({arch.mlp_type}, "
        f"{arch.act}), vocab {arch.vocab_size}, positions {arch.pos_embed}, "
        f"frontend {arch.frontend}, {arch.dtype}: {n:,} parameters "
        f"({nbytes / 1e9:.2f} GB{f'; the encoder {enc:,}' if enc else ''}),"
        f" random from seed 0, made on the card in "
        f"{time.perf_counter() - t0:.2f} s (device memory allocated "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB)")
    return arch, model, nbytes


def whisper_prefill(arch, model, toks, extras, med):
    """Phase 19 (a)'s split of a whisper prefill by CUDA events (the
    encoder, the decoder's cross steps, its self-attention K5 and its
    rest, K5's calls told apart by their order: the encoder's n_enc, then
    each decoder layer's self and cross call), the busy share, the
    copies ``_readable`` makes, and K5 on the encoder's layer 0 and the
    first cross call against the plain version with their times (the
    rows this phase adds to the kernels' line)."""
    import torch
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models import layers as L
    from repro_torch.models import lm
    n_enc, n_dec = arch.encoder_layers, arch.n_layers
    patches = [(L, "flash_attention", "kernel"),
               (lm.Encoder, "forward", "encoder"),
               (lm.Block, "_cross", "cross"), (lm, "cross_kv", "cross_kv"),
               (lm.LM, "_logits", "logits")]
    with torch.no_grad():
        total, tot, timer = timed_split(lambda: model.prefill(toks, extras),
                                        keep=(), patches=patches)
    k5 = [a.elapsed_time(b) for a, b in timer.events["kernel"]]
    if len(k5) != n_enc + 2 * n_dec:
        raise AssertionError(f"traced whisper prefill: {len(k5)} K5 calls")
    enc_k5, self_k5, cross_k5 = (sum(k5[:n_enc]), sum(k5[n_enc::2]),
                                 sum(k5[n_enc + 1::2]))
    split = {
        f"encoder ({n_enc} layers, pos_embed, final norm)": tot["encoder"],
        f"  of which K5 (bidirectional, {arch.encoder_seq} x "
        f"{arch.encoder_seq})": enc_k5,
        f"decoder cross steps ({n_dec}: norm_x, q, k/v, K5, wo)":
            tot["cross"],
        "  of which the encoder output's k/v projections": tot["cross_kv"],
        f"  of which K5 (bidirectional, {toks.shape[1]} x "
        f"{arch.encoder_seq})": cross_k5,
        "decoder K5 (causal self-attention)": self_k5,
        "decoder rest (q/k/v, wo, MLP, norms, embed, sinusoid)":
            total - tot["encoder"] - tot["cross"] - self_k5
            - tot["logits"],
        "final norm + unembed (last position)": tot["logits"],
    }
    log_moe_split("a prefill", total, split)
    log_profile("one prefill", device_profile(
        lambda: model.prefill(toks, extras)), med * 1e3, 1)

    # One more prefill keeps the q/k/v of K5's first encoder call and
    # first cross call, and counts the operands _readable copies.
    kept, copies, calls = {}, [], [0]
    keep_at = {0: "encoder", n_enc + 1: "cross"}
    flash, readable = L.flash_attention, fa_ops._readable

    def capture(*a, **kw):
        if calls[0] in keep_at:
            kept[keep_at[calls[0]]] = (a, kw)
        calls[0] += 1
        return flash(*a, **kw)

    def counted(t, route):
        out = readable(t, route)
        if out is not t:
            copies.append(tuple(t.shape))
        return out

    L.flash_attention, fa_ops._readable = capture, counted
    try:
        with torch.no_grad():
            model.prefill(toks, extras)
    finally:
        L.flash_attention, fa_ops._readable = flash, readable
    log(f"  operands K5's wrapper copied (_readable) in one prefill: "
        f"{len(copies)} {sorted(set(copies))}: the cross k and v are "
        f"transposed views of the (B, Se, Hkv Dh) projections, whose "
        f"strides TMA reads in place")
    if copies:
        t = torch.empty(copies[0], dtype=arch.torch_dtype, device="cuda")
        log(f"  one such copy {copies[0]}: "
            f"{time_ms(lambda: t.clone(), 10):.4f} ms")
    rows = []
    for part, what, n in (("encoder", "whisper's encoder layer 0 "
                           "(bidirectional)", n_enc),
                          ("cross", "whisper's decoder layer 0 cross-"
                           "attention (bidirectional)", n_dec)):
        (q, k, v), kw = kept[part]
        if kw.get("causal", True) or kw.get("window", 0):
            raise AssertionError(f"whisper's {part} K5 call took {kw}")
        with torch.no_grad():
            row = flash_row((q, k, v), kw, what)
        row["name"] = (f"flash_attention (whisper-large-v3 {part}, "
                       f"bidirectional {q.shape[2]} x {k.shape[2]})")
        row["launches"] = n
        rows.append(row)
    return rows


def whisper_serve(arch, model, nbytes, frames):
    """Phase 19 (a)'s serving: ``BatchedServer.generate`` at phase 9's
    batch, prompt and length with the cross cache filled from ``frames``
    (the fill launches K5 once an encoder layer, decode none); ms per
    step against the bytes a step reads (the decoder's weights, the tied
    embedding the unembedding reads among them, alone and with the cross
    and self caches) at the HBM rate; a step's split and the idle share."""
    import numpy as np
    import torch
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.serve import BatchedServer
    from repro_torch.models import layers as L
    from repro_torch.models import lm

    B, P, G = SERVE_B, SERVE_P, SERVE_G
    prompts = np.random.default_rng(0).integers(
        0, arch.vocab_size, (B, P)).astype(np.int32)
    server = BatchedServer(arch, model, max_seq=P + G)
    extras = {"frames": frames}
    server.generate(prompts[:, :4], 2, extras)          # warm-up
    fill, fill_s = model.fill_cross_cache, []

    def timed_fill(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fill(*a, **kw)
        torch.cuda.synchronize()
        fill_s.append(time.perf_counter() - t0)
        return out

    model.fill_cross_cache = timed_fill
    try:
        zero_counts()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        with served_logits(model, P - 1) as kept:
            t0 = time.perf_counter()
            out = server.generate(prompts, G, extras)
            wall = time.perf_counter() - t0
    finally:
        del model.fill_cross_cache
    got = read_counts()
    routes = dict(flash_attention.route_launches)
    want = dict.fromkeys(got, 0)
    want["flash_attention"] = arch.encoder_layers
    steps = P + G
    step_ms = (wall - fill_s[0]) / steps * 1e3
    enc = sum(p.numel() * p.element_size()
              for p in model.encoder.parameters())
    weights = nbytes - enc
    item = torch.finfo(arch.torch_dtype).bits // 8
    kv = arch.n_layers * 2 * B * arch.n_kv_heads * arch.head_dim_ * item
    cross, self_kv = kv * arch.encoder_seq, kv * (P + G)
    bound_w = weights / HBM_BYTES_PER_S * 1e3
    bound = (weights + cross + self_kv) / HBM_BYTES_PER_S * 1e3
    log(f"  serving batch {B}, prompt {P}, generate {G}, the cross cache "
        f"filled from the {B} clips: launches {got} (expected {want}: the "
        f"fill's encoder; decode none), K5 by body {routes}; the fill "
        f"{fill_s[0] * 1e3:.2f} ms; {steps} decode steps in "
        f"{wall - fill_s[0]:.4f} s: {step_ms:.4f} ms per step, "
        f"{B * G / wall:.1f} generated tokens/s (fill included); a step "
        f"reads {weights / 1e9:.3f} GB of decoder weights (bound "
        f"{bound_w:.4f} ms at the HBM rate; the step at "
        f"{step_ms / bound_w:.2f}x it), {cross / 1e9:.3f} GB of cross k/v "
        f"and {self_kv / 1e9:.3f} GB of self k/v (all three: bound "
        f"{bound:.4f} ms, the step at {step_ms / bound:.2f}x); peak device "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; "
        f"sample {out[0][:8].tolist()}")
    if got != want or routes != {"wgmma": arch.encoder_layers, "simt": 0}:
        raise AssertionError(f"whisper generate launched {got} {routes}")
    if out.shape != (B, G) or out.dtype != np.int32 \
            or not ((out >= 0) & (out < arch.vocab_size)).all():
        raise AssertionError(f"generate gave {out.dtype} {out.shape}")
    # A decode step's split over 16 steps of another generate (prompt 8,
    # generate 8) against a zero cross cache: decode's work does not
    # depend on the cache's values, and the fill stays out of the steps.
    patches = [(L, "attention_decode", "self"),
               (L, "cross_attention_decode", "xattn"),
               (L, "mlp", "mlp"), (L, "rmsnorm", "norm"),
               (lm.LM, "_logits", "logits")]
    t0 = time.perf_counter()
    total, tot, timer = timed_split(
        lambda: server.generate(prompts[:, :8], 8), keep=(),
        patches=patches)
    traced = time.perf_counter() - t0
    log(f"  16 decode steps of another generate (prompt 8, generate 8) "
        f"under CUDA events: traced wall {traced / 16 * 1e3:.3f} ms per "
        f"step; where the device idles between launches these intervals "
        f"are mostly host time")
    unembed = unembed_ms(tot, timer)
    log_moe_split("a decode step", total, {
        "self-attention (q/k/v, cache write, softmax, wo)": tot["self"],
        f"cross-attention (q, softmax over {arch.encoder_seq} keys, wo)":
            tot["xattn"],
        "MLP (up/down GEMVs, GELU)": tot["mlp"],
        "rmsnorm (3 per layer + final)": tot["norm"],
        "unembed (tied embedding)": unembed,
        "rest (embed gather, sinusoid, residual adds, argmax)": total
        - tot["self"] - tot["xattn"] - tot["mlp"] - tot["norm"] - unembed,
    }, 16)
    log_profile("16 decode steps", device_profile(
        lambda: server.generate(prompts[:, :8], 8)), step_ms, 16)
    return kept[0]


def encdec_f32_card_vs_cpu():
    """Phase 19 (c): f32 at whisper widths (2 + 2 layers, 1,500 frames)
    and pixtral widths (2 layers, with patches), the card against the CPU
    from the same weights and inputs; then whisper-smoke (with frames)
    and pixtral-smoke serving prompt 40 + 16 on both."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.serve import BatchedServer
    from repro_torch.models import lm

    B = ENC_F32_B
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    for name, S in ((WHISPER, WHISPER_F32_S), (PIXTRAL, PIXTRAL_F32_S)):
        full = get_config(name)
        over = dict(n_layers=ENC_F32_LAYERS, dtype="float32")
        if full.is_encdec:
            over["encoder_layers"] = ENC_F32_LAYERS
        arch = dataclasses.replace(full, **over)
        toks, extras = prefill_inputs(arch, B, S, gen, torch.float32)
        encoder = f" + {ENC_F32_LAYERS} encoder layers" \
            if arch.is_encdec else ""
        log(f"phase 19 (c): f32 {name} widths at {ENC_F32_LAYERS} layers"
            f"{encoder}, tokens {tuple(toks.shape)}, extras "
            f"{ {k: tuple(v.shape) for k, v in extras.items()} }, the card "
            f"against the CPU")
        gpu = lm.init_params(arch, seed=0, device="cuda")
        cpu = lm.LM(arch, "cpu")
        cpu.load_state_dict(gpu.state_dict())
        want = arch.n_layers + (arch.encoder_layers + arch.n_layers
                                if arch.is_encdec else 0)
        with torch.no_grad():
            flash_attention.launches = 0
            lg = gpu.forward(toks, extras).cpu()
            if flash_attention.launches != want:
                raise AssertionError(f"f32 forward launched K5 "
                                     f"{flash_attention.launches} times, "
                                     f"not {want}")
            lc = cpu.forward(toks.cpu(), {k: v.cpu()
                                          for k, v in extras.items()})
        rel = float((lg - lc).abs().max() / lc.abs().max())
        log(f"  logits {tuple(lg.shape)}: max |card - cpu| / max |cpu| "
            f"{rel:.3e} (bar 1e-4); K5 launches {want}")
        if not rel <= 1e-4:
            raise AssertionError(f"f32 {name}: card and CPU differ")
        del gpu, cpu, lg, lc

        smoke = dataclasses.replace(get_smoke_config(name), dtype="float32")
        gpu = lm.init_params(smoke, seed=0, device="cuda")
        cpu = lm.LM(smoke, "cpu")
        cpu.load_state_dict(gpu.state_dict())
        rng = np.random.default_rng(6)
        prompts = rng.integers(0, smoke.vocab_size,
                               (4, RING_P)).astype(np.int32)
        frames = rng.standard_normal(
            (4, smoke.encoder_seq, smoke.d_model)).astype(np.float32)
        ex = (lambda dev: {"frames": torch.as_tensor(frames, device=dev)}) \
            if smoke.is_encdec else (lambda dev: None)
        t_gpu = BatchedServer(smoke, gpu, RING_P + RING_G).generate(
            prompts, RING_G, ex("cuda"))
        t_cpu = BatchedServer(smoke, cpu, RING_P + RING_G).generate(
            prompts, RING_G, ex("cpu"))
        filled = " with the cross cache filled from 4 clips" \
            if smoke.is_encdec else ""
        log(f"  {smoke.name} f32 serving prompt {RING_P} + {RING_G}{filled}"
            f": card tokens equal the CPU's: "
            f"{bool((t_gpu == t_cpu).all())} ({t_gpu[0].tolist()})")
        if not (t_gpu == t_cpu).all():
            raise AssertionError(f"{smoke.name} serving: card and CPU "
                                 f"differ")




def phase_encdec():
    """Phase 19: (a) whisper-large-v3 at full width and depth: a prefill
    of 8 clips (96 K5 launches, all wgmma), its split, K5 at the
    encoder's and the cross-attention's shapes, serving with the cross
    cache, decode against prefill; (b) pixtral-12b at full width and
    depth: prefill with 1,024 patches (40 launches), serving; (c) f32 card
    against CPU; (d) the CLI (run with phase 16's, ``phase_launchers``).
    Returns K5's rows at whisper's two shapes."""
    import dataclasses
    import gc
    import torch
    t0 = time.perf_counter()
    log(f"phase 19 (a): {WHISPER} at full width and depth")
    arch, model, nbytes = stub_model(WHISPER)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    toks, extras = prefill_inputs(arch, WHISPER_B, WHISPER_S, gen)
    _, med = counted_prefill(arch, model, toks, extras,
                             arch.encoder_layers + 2 * arch.n_layers)
    rows = whisper_prefill(arch, model, toks, extras, med)
    frames = extras["frames"][:SERVE_B]
    served = whisper_serve(arch, model, nbytes, frames)
    decode_vs_prefill(arch, model, " (full depth)", hold=False,
                      extras={"frames": frames}, logits=served)
    del served
    model.float()
    decode_vs_prefill(dataclasses.replace(arch, dtype="float32"), model,
                      " (full depth)", extras={"frames": frames.float()})
    del model, toks, extras, frames
    gc.collect()
    torch.cuda.empty_cache()

    log(f"phase 19 (b): {PIXTRAL} at full width and depth (device memory "
        f"allocated before it: {torch.cuda.memory_allocated() / 2**30:.2f} "
        f"GiB; mixtral's and llama3-8b's weights are freed)")
    arch, model, nbytes = stub_model(PIXTRAL)
    toks, extras = prefill_inputs(arch, PREFILL_B, PREFILL_S, gen)
    _, (q, k, v), kw = traced_prefill(arch, model, toks, extras)
    k5_held(q, k, v, kw, f"the {PIXTRAL} prefill "
            f"({extras['patches'].shape[1]} patch rows first)")
    del q, k, v
    embed = model.embed.numel() * model.embed.element_size()
    moe_serve(arch, model, nbytes - embed, patches=recurrent_patches(),
              split=lambda total, tot, timer: recurrent_split(
                  total, tot, unembed_ms(tot, timer), decode=True))
    del model, toks, extras
    gc.collect()
    torch.cuda.empty_cache()
    encdec_f32_card_vs_cpu()
    torch.cuda.empty_cache()
    log(f"phase 19 done in {time.perf_counter() - t0:.1f} s")
    return rows


# ---------------------------------------------------------------------------
# Phase 22: the two dense archs served on the card.
# ---------------------------------------------------------------------------

# qwen1.5-4b (40 layers, d 2560, 20/20 heads of 128, QKV bias, d_ff 6,912,
# vocab 151,936) and stablelm-12b (40 layers, d 5120, 32/8 heads of 160,
# d_ff 13,824, vocab 100,352) at full width and depth, bf16, random from a
# seed: phase 8's prefill (B 1, S 8192) and phase 9's serving. K5 takes its
# wgmma body at qwen's D 128 (group 1) and at stablelm's D 160 (group 4,
# the 64-byte tail panel), as ``dispatch.flash_attention_route`` names it.
DENSE_SERVED = ("qwen1.5-4b", "stablelm-12b")


def dense_k5_row(q, k, v, kw, name, launches, err):
    """K5's row at ``name``'s prefill shape: the wrapper's time and its
    device time, the wgmma body's without ping-pong and the simt body's at
    bf16 (both forced through ``_launch``), the plain version's (one KV
    head group at a time), SDPA's (causal, GQA) and the bound from the
    call's live pairs. The wrapper, SDPA and the body without ping-pong
    run in turns, three rounds of five calls (medians), as phase 8's."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention.ops import _launch
    from repro_torch.kernels.flash_attention.ref import attention_ref
    (B, Hq, Sq, D), (Hkv, Sk) = q.shape, k.shape[1:3]
    g = Hq // Hkv
    route = dispatch.flash_attention_route(q.dtype, D)

    def plain():
        return torch.cat([attention_ref(q[:, i * g:(i + 1) * g],
                                        k[:, i:i + 1], v[:, i:i + 1], **kw)
                          for i in range(Hkv)], dim=1)
    timed = {"ms": lambda: flash_attention(q, k, v, **kw),
             "library_ms": lambda: F.scaled_dot_product_attention(
                 q, k, v, is_causal=True, enable_gqa=True),
             "no_pingpong_ms": lambda: _launch(q, k, v, True, 0, D ** -0.5,
                                               pingpong=False)}
    rounds = {n: [] for n in timed}
    with torch.no_grad():
        for _ in range(3):
            for n, fn in timed.items():
                rounds[n].append(time_ms(fn, 5, 1))
        simt_ms = time_ms(lambda: _launch(q, k, v, True, 0, D ** -0.5,
                                          route="simt"), 2, 1)
        plain_ms = time_ms(plain, 2, 1)
        dev = device_ms(lambda: flash_attention(q, k, v, **kw))
    ms, lib, nopp = (sorted(rounds[n])[1] for n in timed)
    flops = 4.0 * Hq * D * B * live_pairs(Sq, Sk, True, 0)
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    b, why = bound_ms(nbytes, flops, BF16_FLOPS)
    log(f"  K5 ({route}) at {name}'s prefill shape {tuple(q.shape)} / "
        f"{tuple(k.shape)}: {ms:.4f} ms (device {fmt_ms(dev)}), "
        f"{flops / ms / 1e9:.1f} TFLOP/s, {b / ms:.3f} of the bound ({b:.4f}"
        f" ms by {why}); SDPA {lib:.4f} ms ({ms / lib:.3f}x); without "
        f"ping-pong {nopp:.4f} ms; the simt body at bf16 {simt_ms:.4f} ms; "
        f"plain {plain_ms:.4f} ms (rounds, ms: "
        + "; ".join(f"{n} {' '.join(f'{t:.4f}' for t in ts)}"
                    for n, ts in rounds.items()) + ")")
    return {"name": f"flash_attention ({name} prefill, {route}, "
                    f"{tuple(q.shape)} / {tuple(k.shape)})",
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:101",
            "launches": launches, "max_abs_err": err, "ms": ms,
            "device_ms": dev, "plain_ms": plain_ms, "bound_ms": b,
            "bound_by": why, "library_ms": lib, "no_pingpong_ms": nopp,
            "simt_ms": simt_ms}


def phase_dense():
    """Phase 22: each of DENSE_SERVED at full width and depth: the prefill
    at B 1, S 8192 (one K5 launch a layer, all on the body
    ``dispatch.flash_attention_route`` names, no other kernel, finite
    logits, the median of three; the path recorded for phase 20), K5 on
    layer 0's q/k/v against its plain version (the prefill's bar) with
    its times, bound and SDPA's; ``BatchedServer.generate`` at batch 8,
    prompt 128, generate 32 (no kernel; ms a step against the weights'
    bytes), and the served generate's decode logits at the last prompt
    position against prefill's (``repro``'s bar). Returns K5's rows."""
    import gc
    import torch
    from repro_torch.kernels import dispatch
    t0 = time.perf_counter()
    rows = []
    for part, name in zip("ab", DENSE_SERVED):
        log(f"phase 22 ({part}): {name} at full width and depth, prefill B "
            f"{PREFILL_B} S {PREFILL_S}, serving batch {SERVE_B}, prompt "
            f"{SERVE_P}, generate {SERVE_G}")
        arch, model, nbytes = stub_model(name)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(2)
        toks = torch.randint(0, arch.vocab_size, (PREFILL_B, PREFILL_S),
                             generator=gen, device="cuda", dtype=torch.int32)
        route = dispatch.flash_attention_route(arch.torch_dtype,
                                               arch.head_dim_)
        kept = {}
        launches, _ = counted_prefill(arch, model, toks, route=route,
                                      kept=kept)
        (q, k, v), kw = kept.pop("qkv")
        err = k5_held(q, k, v, kw, f"the {name} prefill")
        rows.append(dense_k5_row(q, k, v, kw, name, launches, err))
        del q, k, v, toks
        embed = model.embed.numel() * model.embed.element_size()
        served = moe_serve(arch, model, nbytes - embed, diagnose=False)
        decode_vs_prefill(arch, model, "", logits=served)
        del model, served
        gc.collect()
        torch.cuda.empty_cache()
    log(f"phase 22 done in {time.perf_counter() - t0:.1f} s")
    return rows


# ---------------------------------------------------------------------------
# Phase 16: LM training.
# ---------------------------------------------------------------------------

# (a) tinyllama-1.1b at full width and depth, bf16, at train_4k's sequence
# length; the global batch cut from train_4k's 256 to 2, in 2 microbatches
# of one sequence (a second sequence would double the plain-VJP backward's
# f32 score tensors).
TRAIN_ARCH, TRAIN_GB, TRAIN_K, TRAIN_STEPS = "tinyllama-1.1b", 2, 2, 8
# (b)-(d): tinyllama-1.1b widths cut to 2 layers at f32 (~219 M
# parameters): (b) B x S for the card against the CPU; (c) microbatches 1
# against 4; (d) four gloo ranks, a checkpoint every 2 steps, ranks 2 and 3
# killed at step 3 (the survivors resume at 2; (d) ran 12 steps, every 4,
# killed at 6, before phase 21 took their time).
TT_B, TT_S = 2, 512
# (f), (g): the two archs whose batch carries extras, trained on one rank
# through make_train_step: whisper-large-v3 at full width and depth, 8
# clips of 1,500 stub frames and 448 decoder tokens (n_text_ctx) in 2
# microbatches; pixtral-12b at full width, its depth cut from 40 to 8
# layers, S 4096 (1,024 patch rows, 3,072 tokens), global batch 2 in 2
# (all 40 layers need 196 GB at 16 B a parameter). The dry run's 1x1
# cell at 8 layers: 73.64 GB (68.58 GiB of the card's 79.18), fits_hbm
# with 11.4 GB to spare; 9 layers leave 6.6 GB, 10 layers 1.8 GB.
TRAIN_X = {"whisper-large-v3": dict(B=8, S=448, k=2, steps=3, part="(f)"),
           "pixtral-12b": dict(B=2, S=4096, k=2, steps=3, layers=8,
                               part="(g)")}
TT_MB = (8, 256, 3)                     # global batch, length, steps
TT_GLOO = (8, 256, 4, 2)                # global batch, length, steps, every
# (d)'s model: tinyllama's vocabulary and head dimension at d_model 256
# (4 heads of 64 over one KV head), d_ff 704, 2 layers, f32: 17.8 M
# parameters, a 0.21 GB checkpoint. Its checks (losses against the
# undisturbed run, the events, the restore) need no width; at the 2-layer
# tinyllama widths (219 M parameters, an 876 MB buffer through the host
# and 2.63 GB checkpoints) the four ranks took 83.0 s (H100 80GB HBM3,
# 700 W).
TT_GLOO_WIDTHS = dict(d_model=256, n_heads=4, n_kv_heads=1, d_ff=704)
TT_KILL = (3, [2, 3])


class CallTimes:
    """Host seconds of each call of ``owner.attr``, while installed."""

    def __init__(self, owner, attr):
        self.owner, self.attr, self.seconds = owner, attr, []
        self.fn = getattr(owner, attr)

    def __enter__(self):
        fn, seconds = self.fn, self.seconds

        def timed(*args, **kw):
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            seconds.append(time.perf_counter() - t0)
            return out
        setattr(self.owner, self.attr, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.attr, self.fn)
        return False


def dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(path) for f in fs)


def train_step_split(timer, k: int, layers: int, n: int):
    """Device ms of each part of a step, means over the last ``n`` steps
    of the CUDA event pairs ``timer`` holds (``k`` microbatches, ``layers``
    K5 launches a microbatch)."""
    def last(name, per_step):
        pairs = timer.events.get(name, [])[-per_step * n:]
        return sum(a.elapsed_time(b) for a, b in pairs) / n
    total = last("step", 1)
    fwd, k5f = last("forward", k), last("k5_forward", k * layers)
    bwd, k5b = last("backward", k), last("k5_backward", k * layers)
    red, opt = last("reduction", 1), last("optimizer", 1)
    return total, {
        "forward: K5 (wgmma)": k5f,
        "forward: the rest (GEMMs, rope, norms, f32 logits, loss)":
            fwd - k5f,
        "backward: K5's plain-VJP (attention_ref recomputed, f32)": k5b,
        "backward: the rest (GEMM grads, norms, embedding)": bwd - k5b,
        "gradient reduction (one preduce, NCCL world 1)": red,
        "AdamW (clip, moments, update)": opt,
        "rest (f32 accumulation of the grads, buffer, host)":
            total - fwd - bwd - red - opt,
    }


def phase_train_full():
    """Phase 16 (a): full-width, full-depth tinyllama-1.1b training."""
    import dataclasses
    import shutil
    import tempfile
    import torch
    import torch.distributed as dist
    import torch.nn.functional as F
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.core import distributed, linalg
    from repro_torch.data import TokenPipeline
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.models import layers as L
    from repro_torch.models import lm
    from repro_torch.optim import AdamW, cosine_schedule
    from repro_torch.runtime.driver import Trainer, TrainerConfig

    arch = get_config(TRAIN_ARCH)
    full = SHAPES["train_4k"]
    S, B, k, n = full.seq_len, TRAIN_GB, TRAIN_K, TRAIN_STEPS
    log(f"phase 16 (a): training {arch.name} at full width and depth "
        f"({arch.n_layers} layers, {arch.dtype}), S={S}, global batch {B} "
        f"(cut from repro's {full.name}: B={full.global_batch} "
        f"S={full.seq_len}) in {k} microbatches of {B // k}, {n} steps, "
        f"cosine_schedule(3e-4, 2, {n}), NCCL at world size 1")
    dist.init_process_group(
        "nccl", init_method=f"tcp://localhost:{distributed.free_port()}",
        world_size=1, rank=0)
    tmp = tempfile.mkdtemp(prefix="phase16_")
    try:
        t0 = time.perf_counter()
        model = lm.init_params(arch, seed=0, device="cuda")
        torch.cuda.synchronize()
        n_params = sum(p.numel() for p in model.parameters())
        log(f"  {n_params / 1e9:.3f} B parameters, made on the card in "
            f"{time.perf_counter() - t0:.2f} s")
        tr = Trainer(arch, AdamW(learning_rate=cosine_schedule(3e-4, 2, n)),
                     TokenPipeline(arch.vocab_size, B, S, seed=0),
                     TrainerConfig(steps=n, ckpt_dir=tmp, ckpt_every=n,
                                   microbatches=k),
                     group=dist.group.WORLD, device="cuda", model=model)
        # no checkpoint at full width (an 11 GB host copy and write, ~21 s;
        # left out to make room for phase 21): phase 16 (d) writes, times and
        # restores the trainer's checkpoints at 2 layers
        tr._save = lambda: None
        timer = PhaseTimer()
        walls = []
        inner = tr.step_fn

        def step(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = timer.wrap("step", inner, False)(*args)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            return out
        tr.step_fn = step
        real_grad = torch.autograd.grad
        timed_grad = timer.wrap("backward", real_grad, False)
        depth = [0]

        def outer_grad(*args, **kw):      # K5's VJP calls grad inside
            if depth[0]:
                return real_grad(*args, **kw)
            depth[0] += 1
            try:
                return timed_grad(*args, **kw)
            finally:
                depth[0] -= 1
        k5_bwd = fa_ops._Flash.backward
        patches = [
            (lm, "train_loss", timer.wrap("forward", lm.train_loss, False)),
            (L, "flash_attention", timer.wrap("k5_forward",
                                              L.flash_attention)),
            (torch.autograd, "grad", outer_grad),
            (fa_ops._Flash, "backward",
             staticmethod(timer.wrap("k5_backward", k5_bwd, False))),
            (linalg, "preduce", timer.wrap("reduction", linalg.preduce,
                                           False)),
            (AdamW, "update", timer.wrap("optimizer", AdamW.update, False))]
        saved = [(o, a, o.__dict__[a]) for o, a, _ in patches]
        for o, a, fn in patches:
            setattr(o, a, fn)
        zero_counts()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        resident = path_bytes(model, tr.opt_state)
        try:
            with linalg.count_reductions() as red:
                t0 = time.perf_counter()
                out = tr.run()
                run_s = time.perf_counter() - t0
        finally:
            for o, a, fn in saved:
                setattr(o, a, fn)
        got, routes = read_counts(), dict(flash_attention.route_launches)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        measured = measured_peak(before, resident)
        per_step = arch.n_layers * k
        want = dict.fromkeys(got, 0)
        want["flash_attention"] = per_step * n
        losses = out["losses"]
        log(f"  losses: {' '.join(f'{x:.4f}' for x in losses)}")
        log(f"  launches: {got} (expected {want}); K5 by body {routes} "
            f"(expected wgmma {per_step} x {n}); counted reductions "
            f"{red.n} (expected 1 per step, {n})")
        if got != want or routes != {"wgmma": per_step * n, "simt": 0}:
            raise AssertionError(f"(a) launches {got} {routes}")
        if red.n != n or red.max != 0:
            raise AssertionError(f"(a) {red.n} reductions in {n} steps")
        if len(losses) != n or not all(math.isfinite(x) for x in losses) \
                or not losses[-1] < losses[0]:
            raise AssertionError(f"(a) losses {losses}")
        steady = sorted(walls[1:])[len(walls[1:]) // 2]
        tokens = B * S
        log(f"  step walls (s): {' '.join(f'{w:.4f}' for w in walls)}; "
            f"steady (median after the first) {steady:.4f} s, "
            f"{tokens / steady:.1f} tokens/s; peak device memory "
            f"{peak:.3f} GiB")
        # the step's batch, tokens and targets (B, S) int32, is made in the
        # step: in the peak, and an argument of the dry run's step.
        MEASURED[arch.name] = dict(
            measured, args=resident + 2 * B * S * 4, arch=arch,
            seconds=steady, shape=dataclasses.replace(full, global_batch=B),
            opts={"remat": tr.cfg.remat, "microbatches": k})
        log(f"  run() {run_s:.1f} s")
        total, split = train_step_split(timer, k, arch.n_layers, n - 1)
        log(f"  where a step's time goes (device time by CUDA events, ms, "
            f"mean of steps 2-{n}; the step {total:.1f} ms):")
        for name, ms in split.items():
            log(f"    {name:60s} {ms:10.2f}  {100 * ms / total:5.1f}%")
        # K5 against its plain version on the q/k/v that the first
        # microbatch's layer 0 gave it (the prefill's bar, phase 8).
        (q, kk, v), kw = timer.first["k5_forward"]
        q, kk, v = (t.detach() for t in (q, kk, v))
        with torch.no_grad():
            got_o = flash_attention(q, kk, v, **kw)
            want_o = attention_ref(q, kk, v, **kw).float()
        err = check_close(f"K5 on layer 0's q/k/v of training step 1 "
                          f"{tuple(q.shape)} / {tuple(kk.shape)} {q.dtype}",
                          got_o.float(), want_o, 2.0 ** -7, 4e-3)
        k5_ms = time_ms(lambda: flash_attention(q, kk, v, **kw), 10, 1)
        plain_ms = time_ms(lambda: attention_ref(q, kk, v, **kw), 3, 1)
        sdpa_ms = time_ms(lambda: F.scaled_dot_product_attention(
            q, kk, v, is_causal=True, enable_gqa=True), 10, 1)
        flops = 4.0 * q.shape[1] * q.shape[3] * live_pairs(S, S, True, 0)
        nbytes = (2 * q.numel() + kk.numel() + v.numel()) * q.element_size()
        bound, why = bound_ms(nbytes, flops, BF16_FLOPS)
        log(f"  K5 at this shape {k5_ms:.4f} ms ({flops / k5_ms / 1e9:.1f} "
            f"TFLOP/s), its plain version {plain_ms:.4f} ms, "
            f"scaled_dot_product_attention {sdpa_ms:.4f} ms; bound "
            f"{bound:.4f} ms by {why}")
        del tr, model, q, kk, v, got_o, want_o, timer
        return {"train_launches_per_step": per_step,
                "train_max_abs_err": err, "train_ms": k5_ms,
                "train_plain_ms": plain_ms, "train_bound_ms": bound,
                "train_library_ms": sdpa_ms}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        dist.destroy_process_group()
        torch.cuda.empty_cache()


def x_arch(name, c):
    """``name``'s config at full width, its depth cut to ``c["layers"]``
    where that is set (pixtral-12b's runs)."""
    import dataclasses
    from repro_torch.configs import get_config
    arch = get_config(name)
    if c.get("layers"):
        arch = dataclasses.replace(arch, n_layers=c["layers"])
    return arch


def x_text_len(arch, S: int) -> int:
    """The tokens of a train step of S positions in ``input_specs``' split
    (a vision-stub arch's patch rows count in S)."""
    return S - (min(arch.n_patches, S // 4)
                if arch.frontend == "vision_stub" else 0)


def x_extras(arch, B: int, S: int, seed: int):
    """A train step's frames or patches (``prefill_inputs``' extras),
    drawn by a generator of ``seed`` on the card: the same numbers in
    every process that draws them."""
    import torch
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    return prefill_inputs(arch, B, S, gen)[1]


def k5_per_microbatch(arch) -> int:
    """K5's launches in one microbatch's forward: each decoder layer with
    attention, and an encoder-decoder arch's encoder layers and each
    decoder layer's cross-attention."""
    from repro_torch.models import lm
    n = sum(arch.block_at(i) in lm.ATTENTION_KINDS
            for i in range(arch.n_layers))
    return n + (arch.encoder_layers + arch.n_layers if arch.is_encdec
                else 0)


def x_shape(arch, c, part):
    """The ``ShapeConfig`` of a train run ``c`` under its own name."""
    import dataclasses
    from repro_torch.configs import SHAPES
    return dataclasses.replace(SHAPES["train_4k"], name=f"phase 16 {part}",
                               global_batch=c["B"], seq_len=c["S"])


def train_x_run(name, c):
    """Phase 16 (f) or (g): ``name`` trained at full width on one rank
    through ``make_train_step`` with its frames or patches in the batch
    (``Trainer.run`` passes only tokens and targets, as ``repro``'s
    does): c["steps"] steps of ``cosine_schedule(3e-4, 2, steps)``, the
    same extras each step and the pipeline's tokens. Checks finite
    losses, K5's launches (all wgmma), K5 on layer 0's q/k/v (the
    encoder's, for whisper) against its plain version; records the path
    for phase 20 under "``name`` train". Returns K5's launches a
    microbatch."""
    import torch
    import torch.nn.functional as F
    from repro_torch.data import TokenPipeline
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models import layers as L
    from repro_torch.models import lm
    from repro_torch.optim import AdamW, cosine_schedule
    from repro_torch.runtime.driver import TrainerConfig, make_train_step

    import gc
    gc.collect()
    torch.cuda.empty_cache()
    arch = x_arch(name, c)
    B, S, k, n, part = c["B"], c["S"], c["k"], c["steps"], c["part"]
    T = x_text_len(arch, S)
    cut = f", depth cut to {arch.n_layers} layers" if c.get("layers") \
        else " and depth"
    log(f"phase 16 {part}: training {name} at full width{cut} ({arch.dtype}"
        f"), global batch {B} in {k} microbatches, {S} positions ({T} "
        f"tokens{f', {S - T} patch rows' if S > T else ''}"
        f"{f', {arch.encoder_seq} frames a clip' if arch.is_encdec else ''}"
        f"), {n} steps of cosine_schedule(3e-4, 2, {n}), through "
        f"make_train_step on one rank (device memory allocated before it "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB)")
    t0 = time.perf_counter()
    model = lm.init_params(arch, seed=0, device="cuda")
    model.requires_grad_(True)
    opt = AdamW(learning_rate=cosine_schedule(3e-4, 2, n))
    state = opt.init(dict(model.named_parameters()))
    extras = x_extras(arch, B, S, 11)
    torch.cuda.synchronize()
    log(f"  {sum(p.numel() for p in model.parameters()):,} parameters, "
        f"made on the card in {time.perf_counter() - t0:.2f} s; extras "
        f"{ {e: tuple(v.shape) for e, v in extras.items()} }")
    step = make_train_step(arch, opt, TrainerConfig(microbatches=k))
    pipe = TokenPipeline(arch.vocab_size, B, T, seed=0)
    timer = PhaseTimer()
    real_grad = torch.autograd.grad
    timed_grad = timer.wrap("backward", real_grad, False)
    depth = [0]

    def outer_grad(*args, **kw):          # K5's VJP calls grad inside
        if depth[0]:
            return real_grad(*args, **kw)
        depth[0] += 1
        try:
            return timed_grad(*args, **kw)
        finally:
            depth[0] -= 1
    k5_bwd = fa_ops._Flash.backward
    patches = [
        (lm, "train_loss", timer.wrap("forward", lm.train_loss, False)),
        (L, "flash_attention", timer.wrap("k5_forward", L.flash_attention)),
        (lm.Encoder, "forward", timer.wrap("encoder", lm.Encoder.forward,
                                           False)),
        (lm.Block, "_cross", timer.wrap("cross", lm.Block._cross, False)),
        (torch.autograd, "grad", outer_grad),
        (fa_ops._Flash, "backward",
         staticmethod(timer.wrap("k5_backward", k5_bwd, False))),
        (AdamW, "update", timer.wrap("optimizer", AdamW.update, False))]
    saved = [(o, a, o.__dict__[a]) for o, a, _ in patches]
    zero_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    resident = path_bytes(model, state, extras)
    losses, walls = [], []
    for o, a, fn in patches:
        setattr(o, a, fn)
    try:
        for i in range(n):
            toks, tgts = pipe.batch_at(i)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            # the loss is a view of the step's f32 gradient buffer: kept
            # into the next step, it would keep that buffer (4 B a
            # parameter) too, as the trainer's float() does not
            losses.append(float(timer.wrap("step", step, False)(
                model, state, {"tokens": toks, "targets": tgts, **extras})))
            walls.append(time.perf_counter() - t1)
    finally:
        for o, a, fn in saved:
            setattr(o, a, fn)
    got, routes = read_counts(), dict(flash_attention.route_launches)
    peak = torch.cuda.max_memory_allocated()
    measured = measured_peak(before, resident)
    per = k5_per_microbatch(arch)
    want = dict.fromkeys(got, 0)
    want["flash_attention"] = per * k * n
    log(f"  losses: {' '.join(f'{x:.4f}' for x in losses)}")
    log(f"  launches: {got} (expected {want}); K5 by body {routes} "
        f"(expected wgmma {per} a microbatch x {k} x {n} steps)")
    if got != want or routes != {"wgmma": per * k * n, "simt": 0}:
        raise AssertionError(f"phase 16 {part} launches {got} {routes}")
    if len(losses) != n or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"phase 16 {part} losses {losses}")
    steady = sorted(walls[1:])[len(walls[1:]) // 2]
    log(f"  step walls (s): {' '.join(f'{w:.4f}' for w in walls)}; steady "
        f"(median after the first) {steady:.4f} s, {B * S / steady:.1f} "
        f"positions/s; peak device memory {peak / 2 ** 30:.3f} GiB")
    # the tokens and targets, (B, T) int32, are made in the step: in the
    # peak, and arguments of the dry run's step
    MEASURED[f"{name} train"] = dict(
        measured, args=resident + 2 * B * T * 4, arch=arch, seconds=steady,
        shape=x_shape(arch, c, part),
        opts={"remat": "none", "microbatches": k})

    total, split = train_step_split(timer, k, per, n - 1)
    # one rank, no group: make_train_step reduces nothing
    del split["gradient reduction (one preduce, NCCL world 1)"]
    if arch.is_encdec:
        # the forward's K5 and rest, apart: each microbatch's K5 calls are
        # the encoder's n_enc, then each decoder layer's self-attention and
        # cross-attention in turn
        n_enc, n_dec = arch.encoder_layers, arch.n_layers
        k5 = [a.elapsed_time(b) for a, b in timer.events["k5_forward"]
              [-k * per * (n - 1):]]
        mbs = [k5[i * per:(i + 1) * per] for i in range(len(k5) // per)]
        enc_k5, self_k5, cross_k5 = (
            sum(sum(m[part]) for m in mbs) / (n - 1)
            for part in (slice(n_enc), slice(n_enc, None, 2),
                         slice(n_enc + 1, None, 2)))
        last = {label: sum(a.elapsed_time(b) for a, b in timer.events[label]
                           [-m * (n - 1):]) / (n - 1)
                for label, m in (("encoder", k), ("cross", k * n_dec))}
        fwd = split.pop("forward: K5 (wgmma)") \
            + split.pop("forward: the rest (GEMMs, rope, norms, f32 logits, "
                        "loss)")
        split = {
            f"forward: encoder ({n_enc} layers)": last["encoder"],
            f"  of which K5 (bidirectional {arch.encoder_seq} x "
            f"{arch.encoder_seq})": enc_k5,
            f"forward: decoder cross steps ({n_dec})": last["cross"],
            f"  of which K5 (bidirectional {T} x {arch.encoder_seq})":
                cross_k5,
            "forward: decoder K5 (causal)": self_k5,
            "forward: decoder rest (GEMMs, norms, f32 logits, loss)":
                fwd - last["encoder"] - last["cross"] - self_k5,
            **split}
    log(f"  where a step's time goes (device time by CUDA events, ms, mean "
        f"of steps 2-{n}; the step {total:.1f} ms):")
    for label, ms in split.items():
        log(f"    {label:60s} {ms:10.2f}  {100 * ms / total:5.1f}%")
    (q, kk, v), kw = timer.first["k5_forward"]
    q, kk, v = (t.detach() for t in (q, kk, v))
    what = "the encoder's layer 0" if arch.is_encdec else "layer 0"
    err = k5_held(q, kk, v, kw, f"{what} in training step 1")
    with torch.no_grad():
        k5_ms = time_ms(lambda: flash_attention(q, kk, v, **kw), 10, 1)
        sdpa_ms = time_ms(lambda: F.scaled_dot_product_attention(
            q, kk, v, is_causal=kw.get("causal", True), enable_gqa=True),
            10, 1)
    flops = 4.0 * q.shape[0] * q.shape[1] * q.shape[3] * live_pairs(
        q.shape[2], kk.shape[2], kw.get("causal", True), 0)
    nbytes = (2 * q.numel() + kk.numel() + v.numel()) * q.element_size()
    bound, why = bound_ms(nbytes, flops, BF16_FLOPS)
    log(f"  K5 at this shape {k5_ms:.4f} ms ({flops / k5_ms / 1e9:.1f} "
        f"TFLOP/s), scaled_dot_product_attention {sdpa_ms:.4f} ms; bound "
        f"{bound:.4f} ms by {why}")
    del model, state, opt, extras, timer, q, kk, v, step
    torch.cuda.empty_cache()
    return {"launches_per_microbatch": per, "max_abs_err": err,
            "ms": k5_ms, "library_ms": sdpa_ms, "bound_ms": bound}


def phase_train_extras():
    """Phase 16 (f), (g): TRAIN_X's runs. Returns K5's launches a
    microbatch of each."""
    return {name: train_x_run(name, c)["launches_per_microbatch"]
            for name, c in TRAIN_X.items()}


def tiny_train_arch():
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(TINY), n_layers=TINY_LAYERS,
                               dtype="float32")


def gloo_train_arch():
    """(d)'s model: tiny_train_arch narrowed to TT_GLOO_WIDTHS."""
    import dataclasses
    return dataclasses.replace(tiny_train_arch(), **TT_GLOO_WIDTHS)


def train_optimizer():
    from repro_torch.optim import AdamW, cosine_schedule
    return AdamW(learning_rate=cosine_schedule(3e-4, 2, 8))


def one_step(model, batch, k=1):
    """(loss, {name: reduced f32 grad on the host}) of one optimizer step
    of ``model`` (updated in place) through ``make_train_step``."""
    from repro_torch.optim import AdamW
    from repro_torch.runtime.driver import TrainerConfig, make_train_step
    opt = train_optimizer()
    model.requires_grad_(True)
    state = opt.init(dict(model.named_parameters()))
    grads = {}
    real = AdamW.update

    def keep(self, g, st, params):
        grads.update({n: t.detach().cpu().clone() for n, t in g.items()})
        return real(self, g, st, params)
    AdamW.update = keep
    try:
        loss = float(make_train_step(model.arch, opt, TrainerConfig(
            microbatches=k))(model, state, batch))
    finally:
        AdamW.update = real
    return loss, grads


def leaf_err(got, want):
    """max |got - want| / max |want| of one leaf."""
    return float((got - want).abs().max() / want.abs().max())


def phase_train_card_vs_cpu():
    """Phase 16 (b): one f32 step on the card against the CPU, and the
    checkpointing policies against each other on the card.

    Adam's first step moves each entry by about lr sign(g), so an entry
    whose gradient is zero within the f32 rounding of the two devices may
    move the other way: end to end, the updated parameters are held to
    1e-4 of their leaf's max where the CPU's gradient exceeds 100 times
    the leaf's largest card-CPU gradient difference, and each part alone
    everywhere: the reduced gradients, and the card's AdamW against the
    CPU's on the card's gradients."""
    import torch
    from repro_torch.data import TokenPipeline
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import lm

    arch = tiny_train_arch()
    log(f"phase 16 (b): one f32 training step of {TINY} widths at "
        f"{TINY_LAYERS} layers, B={TT_B} S={TT_S}, the card (K5) against "
        f"the CPU (plain); then remat none / full / dots on the card")
    gpu = lm.init_params(arch, seed=0, device="cuda")
    cpu = lm.LM(arch, "cpu")
    cpu.load_state_dict(gpu.state_dict())
    p0 = {n: p.detach().cpu().clone() for n, p in cpu.named_parameters()}
    toks, tgts = TokenPipeline(arch.vocab_size, TT_B, TT_S, seed=0).batch_at(0)
    batch = {"tokens": toks, "targets": tgts}
    flash_attention.launches = 0
    t0 = time.perf_counter()
    lg, gg = one_step(gpu, batch)
    t1 = time.perf_counter()
    launched = flash_attention.launches
    lc, gc = one_step(cpu, batch)
    rel = abs(lg - lc) / abs(lc)
    log(f"  loss card {lg:.7f} cpu {lc:.7f}: rel {rel:.3e} (bar 1e-4); K5 "
        f"launched {launched} times (expected {TINY_LAYERS}); the step "
        f"{t1 - t0:.2f} s on the card, {time.perf_counter() - t1:.2f} s on "
        f"the CPU")
    if not rel <= 1e-4 or launched != TINY_LAYERS:
        raise AssertionError("(b) the card's loss differs from the CPU's")
    # the CPU's AdamW on the card's reduced gradients, from the same weights
    ref = lm.LM(arch, "cpu")
    ref.load_state_dict(p0)
    opt = train_optimizer()
    params = dict(ref.named_parameters())
    opt.update(gg, opt.init(params), params)
    card = {n: p.detach().cpu() for n, p in gpu.named_parameters()}
    g_err = {n: leaf_err(gg[n], gc[n]) for n in gc}
    opt_err = max(leaf_err(card[n], params[n].detach()) for n in card)
    worst = max(g_err, key=g_err.get)
    over = flips = over_cond = 0
    e2e = e2e_cond = 0.0
    for name, pc in cpu.named_parameters():
        pc = pc.detach()
        err, scale = (card[name] - pc).abs(), pc.abs().max()
        cond = gc[name].abs() > 100 * (gg[name] - gc[name]).abs().max()
        bad = err > 1e-4 * scale
        over += int(bad.sum())
        flips += int((bad & (gg[name].sign() != gc[name].sign())).sum())
        over_cond += int((bad & cond).sum())
        e2e = max(e2e, float(err.max() / scale))
        if cond.any():
            e2e_cond = max(e2e_cond, float(err[cond].max() / scale))
    log(f"  reduced gradients: max |card - cpu| / max |cpu| per leaf "
        f"{g_err[worst]:.3e} ({worst}; bar 1e-4); the card's AdamW against "
        f"the CPU's on the card's gradients {opt_err:.3e} (bar 1e-4)")
    log(f"  updated parameters, card step against CPU step: max |card - cpu|"
        f" / max |cpu| per leaf {e2e:.3e}, {over} entries over 1e-4 ({flips}"
        f" where the two gradients differ in sign); where the gradient "
        f"exceeds 100x the leaf's gradient difference {e2e_cond:.3e}, "
        f"{over_cond} entries over 1e-4 (bar: none)")
    if not g_err[worst] <= 1e-4 or not opt_err <= 1e-4 or over_cond:
        raise AssertionError("(b) the card's step differs from the CPU's")
    del cpu, ref, params, gg, gc, card
    # remat on the card: the same loss bits; the embedding's backward adds
    # with atomics, so the gradients' bits may differ.
    gpu.load_state_dict(p0)
    named = list(gpu.named_parameters())
    ref = None
    for remat in ("none", "full", "dots"):
        flash_attention.launches = 0
        loss = lm.train_loss(gpu, batch, remat=remat)
        grads = torch.autograd.grad(loss, [p for _, p in named])
        n_k5 = flash_attention.launches
        if ref is None:
            ref = (loss.detach(), grads)
            log(f"  remat none: loss {float(ref[0]):.7f}, K5 launched {n_k5}")
            continue
        dg = max(leaf_err(g, r) for g, r in zip(grads, ref[1]))
        same = bool(torch.equal(loss.detach(), ref[0]))
        log(f"  remat {remat}: loss bit-equal to none {same}; grads max "
            f"|diff| / max per leaf {dg:.3e} (bar 1e-6); K5 launched {n_k5} "
            f"(expected {2 * TINY_LAYERS})")
        if not same or not dg <= 1e-6 or n_k5 != 2 * TINY_LAYERS:
            raise AssertionError(f"(b) remat {remat} differs from none")
    del gpu, ref, grads
    torch.cuda.empty_cache()


def phase_train_microbatches():
    """Phase 16 (c): microbatches 1 against 4 on the card, f32."""
    import torch
    from repro_torch.data import TokenPipeline
    from repro_torch.models import lm
    from repro_torch.optim import AdamW, cosine_schedule
    from repro_torch.runtime.driver import TrainerConfig, make_train_step

    arch = tiny_train_arch()
    B, S, n = TT_MB
    log(f"phase 16 (c): {TINY} widths at {TINY_LAYERS} layers, f32, global "
        f"batch {B}, S={S}, {n} steps: microbatches 1 against 4 on the card")
    pipe = TokenPipeline(arch.vocab_size, B, S, seed=0)
    losses = {}
    for k in (1, 4):
        model = lm.init_params(arch, seed=0, device="cuda")
        model.requires_grad_(True)
        opt = AdamW(learning_rate=cosine_schedule(3e-4, 2, n))
        state = opt.init(dict(model.named_parameters()))
        step = make_train_step(arch, opt, TrainerConfig(microbatches=k))
        losses[k] = []
        for i in range(n):
            toks, tgts = pipe.batch_at(i)
            losses[k].append(float(step(model, state, {"tokens": toks,
                                                        "targets": tgts})))
        del model, state
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses[4], losses[1]))
    log(f"  losses k=1 {losses[1]}, k=4 {losses[4]}: max rel {rel:.3e} "
        f"(bar 1e-5)")
    if not rel <= 1e-5:
        raise AssertionError("(c) microbatches change the losses")
    torch.cuda.empty_cache()


def train_rank(rank, world, tmp):
    """Phase 16 (d) on one of four gloo ranks sharing the card: the
    undisturbed run, then ranks 2 and 3 killed at step 6."""
    import torch
    import torch.distributed as dist
    from repro_torch.checkpoint import ckpt
    from repro_torch.core import linalg
    from repro_torch.data import TokenPipeline
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import lm
    from repro_torch.optim import AdamW, cosine_schedule
    from repro_torch.runtime import FailureInjector
    from repro_torch.runtime.driver import Trainer, TrainerConfig

    arch = gloo_train_arch()
    B, S, n, every = TT_GLOO
    out = {}
    for name in ("undisturbed", "failure"):
        kw = {} if name == "undisturbed" else {
            "failure_injector": FailureInjector({TT_KILL[0]: TT_KILL[1]})}
        tr = Trainer(arch, AdamW(learning_rate=cosine_schedule(3e-4, 2, n)),
                     TokenPipeline(arch.vocab_size, B, S, seed=0),
                     TrainerConfig(steps=n, ckpt_dir=os.path.join(tmp, name),
                                   ckpt_every=every),
                     group=dist.group.WORLD, device="cuda",
                     model=lm.init_params(arch, seed=0, device="cuda"), **kw)
        flash_attention.launches = 0
        t0 = time.perf_counter()
        with linalg.count_reductions() as red, \
                CallTimes(ckpt, "save_checkpoint") as save, \
                CallTimes(Trainer, "_restore") as restore:
            res = tr.run()
        res.update(wall=time.perf_counter() - t0, reductions=red.n,
                   live=list(tr.live), launches=flash_attention.launches,
                   save_s=save.seconds, restore_s=restore.seconds)
        if rank == 0 and name == "undisturbed":
            res["ckpt_bytes"] = dir_bytes(os.path.join(tmp, name,
                                                       f"step_{n:08d}"))
        out[name] = res
        del tr
        torch.cuda.empty_cache()
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))


def phase_train_gloo():
    """Phase 16 (d): a checkpoint and an injected failure at tinyllama
    widths, four gloo ranks on the one card."""
    import tempfile
    import torch
    from repro_torch.core import distributed

    B, S, n, every = TT_GLOO
    step, dead = TT_KILL
    back = step // every * every        # the checkpoint the survivors resume
    log(f"phase 16 (d): {TINY} narrowed to {TT_GLOO_WIDTHS} at "
        f"{TINY_LAYERS} layers, f32, {P_GLOO} "
        f"gloo ranks on the one card, global batch {B}, S={S}, {n} steps, a "
        f"checkpoint every {every}: undisturbed, then ranks {dead} killed at "
        f"step {step}")
    with tempfile.TemporaryDirectory(prefix="phase16_") as tmp:
        t0 = time.perf_counter()
        distributed.run_ranks(train_rank, P_GLOO, "gloo", device="cuda",
                              args=(tmp,))
        log(f"  {P_GLOO} ranks done in {time.perf_counter() - t0:.1f} s")
        ranks = {r: torch.load(os.path.join(tmp, f"rank{r}.pt"),
                               weights_only=False) for r in range(P_GLOO)}
    und = ranks[0]["undisturbed"]
    for r in range(P_GLOO):
        u = ranks[r]["undisturbed"]
        if u["final_step"] != n or u["reductions"] != n or u["lost"] \
                or u["losses"] != und["losses"]:
            raise AssertionError(f"(d) undisturbed rank {r}: {u}")
    log(f"  undisturbed: losses {' '.join(f'{x:.5f}' for x in und['losses'])}"
        f"; {und['reductions']} reductions and {und['launches']} K5 launches "
        f"a rank; wall {und['wall']:.1f} s")
    log(f"  a checkpoint: {und['ckpt_bytes'] / 1e9:.3f} GB on disk; writes "
        f"(rank 0, async) {' '.join(f'{s:.2f}' for s in und['save_s'])} s")
    for r in dead:
        f = ranks[r]["failure"]
        if not f["lost"] or f["final_step"] != step:
            raise AssertionError(f"(d) rank {r} did not leave at {step}: {f}")
    worst = 0.0
    for r in range(P_GLOO):
        if r in dead:
            continue
        f = ranks[r]["failure"]
        resumed = [e for e in f["events"] if "re-meshed" in e]
        ok = (not f["lost"] and f["final_step"] == n and f["live"] == [0, 1]
              and resumed and resumed[0].endswith(f"resumed at step {back}")
              and f["losses"][:step] == und["losses"][:step]
              and len(f["losses"]) == step + n - back)
        if not ok:
            raise AssertionError(f"(d) survivor {r}: {f}")
        rel = max(abs(a - b) / abs(b)
                  for a, b in zip(f["losses"][step:], und["losses"][back:]))
        worst = max(worst, rel)
        log(f"  survivor {r}: events {f['events']}; losses from step {back} "
            f"{' '.join(f'{x:.5f}' for x in f['losses'][step:])}; max rel "
            f"to the undisturbed run {rel:.3e} (bar 1e-5); restore "
            f"{' '.join(f'{s:.3f}' for s in f['restore_s'])} s; wall "
            f"{f['wall']:.1f} s")
    if not worst <= 1e-5:
        raise AssertionError("(d) the recovered losses differ")


# Phase 14 (e): the static contracts' CLI on the card, one pass on the
# Lasso family (14 (a) ran the whole registry in the script's process).
ANALYSIS_CLI = ["-m", "repro_torch.analysis", "--json", "--families",
                "lasso", "--checks", "collectives"]


def analysis_cli_ok(rc, out):
    """Phase 14 (e)'s check: exit 0 and the JSON report's ``ok``; logs its
    subjects and errors."""
    try:
        cli = json.loads(out) if rc == 0 else {}
    except ValueError:
        cli = {}
    log(f"  phase 14 (e): python {' '.join(ANALYSIS_CLI)} on the card: "
        f"exit {rc}, ok {cli.get('ok')}, {len(cli.get('checked', ()))} "
        f"subjects, {cli.get('errors')} error(s)")
    return rc == 0 and bool(cli.get("ok"))


def launcher_cmd(module, arch, *args):
    return [sys.executable, "-m", f"repro_torch.launch.{module}", "--arch",
            arch, "--smoke", *args]


def launchers_start():
    """Phases 17 (e), 18 (d), 19 (d), 16 (e) and 14 (e): the serving and
    training launchers and the static contracts' CLI on the card, and
    phase 16 (d) (``phase_train_gloo`` in a process of its own), each a
    process, started together (the kernels are built; the smoke models
    share the card); ``launchers_finish`` holds each to its own check:
    mixtral-smoke, hymba-smoke and xlstm-smoke decode (hymba-smoke's heads
    of 20 are not a K5 head dimension, so decode only), pixtral-smoke
    serves and whisper is refused with ``repro``'s message;
    tinyllama-smoke trains 20 steps and writes its checkpoint; ``python
    -m repro_torch.analysis --json --families lasso --checks collectives``
    exits 0 with ``ok`` (``analysis_cli_ok``); 16 (d) exits 0. They run
    beside phase 21, whose checks hold no time (its ranks' collectives
    go through the host for minutes): one after another they took their
    sum, together about the longest one's time (~29 s, and 16 (d) ~27 s
    before), beside phase 21 nothing. Returns their state."""
    import tempfile
    me = os.path.splitext(os.path.basename(__file__))[0]
    serve = ("--prompt-len", "40", "--gen-len", "16")
    tmp = tempfile.TemporaryDirectory(prefix="phase16_cli_")
    ckpt = os.path.join(tmp.name, "ckpt")
    runs = [
        ("phase 17 (e)", launcher_cmd("serve", MIXTRAL, *serve),
         lambda rc, out, err: rc == 0
         and "arch=mixtral-smoke generated (4, 16)" in out + err),
        ("phase 18 (d)", launcher_cmd("serve", HYMBA, *serve),
         lambda rc, out, err: rc == 0
         and "arch=hymba-smoke generated (4, 16)" in out + err),
        ("phase 18 (d)", launcher_cmd("serve", XLSTM, *serve),
         lambda rc, out, err: rc == 0
         and "arch=xlstm-smoke generated (4, 16)" in out + err),
        ("phase 19 (d)", launcher_cmd("serve", PIXTRAL, *serve),
         lambda rc, out, err: rc == 0
         and "arch=pixtral-smoke generated (4, 16)" in out + err),
        ("phase 19 (d)", launcher_cmd("serve", WHISPER, *serve),
         lambda rc, out, err: rc == 1
         and "use the audio pipeline for enc-dec archs" in out + err),
        ("phase 16 (e)", launcher_cmd("train", TRAIN_ARCH, "--steps",
                                      "20", "--ckpt-dir", ckpt),
         lambda rc, out, err: launcher_trained(rc, out + err, ckpt)),
        ("phase 14 (e)", [sys.executable, *ANALYSIS_CLI],
         lambda rc, out, err: analysis_cli_ok(rc, out)),
        # four gloo ranks of its own, whose checks (losses, events, the
        # restore) raise in it: its log is printed whole
        ("phase 16 (d)", [sys.executable, "-c", f"import {me}; "
                          f"{me}.phase_train_gloo()"],
         lambda rc, out, err: rc == 0)]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.dirname(os.path.abspath(__file__)), SRC]))
    t0 = time.perf_counter()
    procs, ends = [], {}
    for i, (label, cmd, check) in enumerate(runs):
        out = tempfile.TemporaryFile(mode="w+")
        err = tempfile.TemporaryFile(mode="w+")
        p = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=out, stderr=err,
                             text=True)
        procs.append((label, cmd, check, out, err, p))
        # each one's end, seen when it comes (the script is busy then)
        threading.Thread(target=lambda i=i, p=p: (
            p.wait(), ends.setdefault(i, time.perf_counter() - t0)),
            daemon=True).start()
    return {"tmp": tmp, "ckpt": ckpt, "procs": procs, "t0": t0,
            "ends": ends}


def launcher_trained(rc, text, ckpt):
    """Phase 16 (e)'s check: exit 0, the loss line, one checkpoint."""
    import re
    m = re.search(r"arch=tinyllama-smoke steps=20 loss (\S+) -> (\S+)",
                  text)
    return rc == 0 and m is not None \
        and sorted(os.listdir(ckpt)) == ["step_00000020"]


def launchers_finish(state) -> None:
    """Wait for ``launchers_start``'s processes (600 s at most from their
    start), log each and raise if any failed its check."""
    procs, t0, ckpt = state["procs"], state["t0"], state["ckpt"]
    ends = state["ends"]
    try:
        while len(ends) < len(procs):
            if time.perf_counter() - t0 > 600:
                for *_, p in procs:
                    p.kill()
                raise AssertionError("the launchers ran past 600 s")
            time.sleep(0.05)
        failed = []
        for i, (label, cmd, check, out, err, p) in enumerate(procs):
            texts = []
            for f in (out, err):
                f.seek(0)
                texts.append(f.read())
                f.close()
            text = "\n".join(t.strip() for t in texts if t.strip())
            shown = " ".join(cmd[1:]).replace(ckpt, "<tmp>")
            tail = text[-300:] if "--json" not in cmd else \
                f"{len(texts[0])} bytes of JSON"
            if label == "phase 16 (d)":          # its own log, whole
                tail = "\n" + texts[0].rstrip()
            log(f"{label}: {shown}: exit {p.returncode} in {ends[i]:.1f} s "
                f"(started together): {tail}")
            if not check(p.returncode, *texts):
                failed.append(f"{label} {shown}: {text[-3000:]}")
    finally:
        state["tmp"].cleanup()
    log(f"  the {len(procs)} launchers together in "
        f"{max(ends.values()):.1f} s")
    if failed:
        raise AssertionError(f"the launchers: {failed}")


def phase_launchers():
    """The launchers of ``launchers_start`` alone, waited for."""
    launchers_finish(launchers_start())


def phase_training():
    """Phase 16: (a) full width, (f) and (g) the archs with extras at full
    width (``phase_train_extras``), (b) card against CPU, (c)
    microbatches; (d), the checkpoint and a failure over gloo ranks, and
    (e), the CLI, run in processes of their own beside phase 21, with
    phases 14 and 17-19's launchers (``launchers_start``). Returns what
    K5's row gains."""
    t0 = time.perf_counter()
    row = phase_train_full()
    row["train_x_launches_per_microbatch"] = phase_train_extras()
    phase_train_card_vs_cpu()
    phase_train_microbatches()
    log(f"phase 16 done in {time.perf_counter() - t0:.1f} s")
    return row


# ---------------------------------------------------------------------------
# Phase 20: the dry run against the card.
# ---------------------------------------------------------------------------

# The paths phase 20 holds the dry run to, by the arch name each measured
# path recorded in MEASURED: phase 8, 16 (a), 17 (a), 19 (a) and (b).
DRY_PATHS = (LLAMA, "tinyllama-1.1b", "mixtral-8x7b", "whisper-large-v3",
             "pixtral-12b", "whisper-large-v3 train", "pixtral-12b train",
             "qwen1.5-4b", "stablelm-12b")
PEAK_RATIO = (0.8, 1.25)


def phase_dryrun(smi: str, paths=DRY_PATHS):
    """Phase 20: ``repro_torch.launch.dryrun.run_cell`` on a one-card mesh
    at each measured path's own arch and shape (on the meta device, on
    this machine's CPU): (a) its argument bytes equal the card's model,
    inputs and AdamW state, exactly; (b) its predicted peak (argument +
    temp) within PEAK_RATIO of the card's measured peak; (c) at llama3-8b's
    prefill, the Recorder's FLOPs on the card equal the meta count
    exactly; (d) the bound on HW_H100, its share of the measured time and
    model_flops / (s x peak), printed; (e) mixtral-8x7b's prefill_32k cell
    at full depth does not fit one card, nor its phase 17 path at full
    depth, which at 16 layers does. Then the one-card ``DeviceMesh`` over
    NCCL at world size 1 places a small tensor by the port's specs."""
    import dataclasses
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.core import distributed
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel import sharding
    from repro_torch.roofline import HW_H100

    t0 = time.perf_counter()
    one = make_mesh((1, 1), ("data", "model"))
    log(f"phase 20: the dry run on the meta device against the card's own "
        f"runs ({smi}; HW_H100: {HW_H100.peak_flops / 1e12:.0f} TFLOP/s "
        f"bf16, {HW_H100.hbm_bw / 1e12:.2f} TB/s, hbm_bytes "
        f"{HW_H100.hbm_bytes}; the card reports "
        f"{torch.cuda.get_device_properties(0).total_memory})")
    rows = []
    # phase 16 (f) and (g)'s cells come from the dry run's subprocess
    # (``tp_dry_start``): whisper's train step takes ~10 s of host
    waited = tp_dry_collect([1])
    log(f"  (phase 16 (f) and (g)'s cells from the dry run's subprocess; "
        f"waited {waited:.1f} s)")
    for name in paths:
        got = MEASURED[name]
        arch, shape = got["arch"], got["shape"]
        opts = dryrun.DryrunOptions(cost_fit=False, **got.get("opts", {}))
        t1 = time.perf_counter()
        r = TP_DRY["cells"].get(f"phase 20 {name}") or dryrun.run_cell(
            arch.name, shape.name, mesh=one, arch=arch, shape=shape,
            opts=opts, verbose=False)
        if r["status"] != "ok":
            raise AssertionError(f"phase 20: the dry run of {name} failed: "
                                 f"{r.get('traceback')}")
        mem, terms = r["memory"], r["roofline"]
        ratio = mem["total_bytes"] / got["peak"]
        sec = got["seconds"]
        mfu = r["model_flops"] / (sec * HW_H100.peak_flops)
        opts_note = f" {got['opts']}" if "opts" in got else ""
        log(f"  {name} ({arch.n_layers} layers) {shape.kind} B "
            f"{shape.global_batch} S {shape.seq_len}{opts_note}: "
            f"(a) argument bytes {mem['argument_bytes']} predicted, "
            f"{got['args']} on the card; (b) peak {mem['total_bytes']} B "
            f"predicted (temp {mem['temp_bytes']}), {got['peak']} B "
            f"measured ({got['other']} B allocated before it not the "
            f"path's, taken out), ratio {ratio:.4f}; (d) bound "
            f"{terms['bound_s'] * 1e3:.3f} ms by {terms['dominant']} "
            f"(compute {terms['compute_s'] * 1e3:.3f}, memory "
            f"{terms['memory_s'] * 1e3:.3f}), measured {sec * 1e3:.3f} ms: "
            f"the bound's share {terms['bound_s'] / sec:.4f}; model_flops "
            f"{r['model_flops']:.4e}: {mfu:.4f} of the peak; dry run "
            f"{time.perf_counter() - t1:.1f} s")
        if mem["argument_bytes"] != got["args"]:
            raise AssertionError(f"phase 20 (a) {name}: argument bytes "
                                 f"{mem['argument_bytes']} != {got['args']}")
        if not PEAK_RATIO[0] <= ratio <= PEAK_RATIO[1]:
            raise AssertionError(f"phase 20 (b) {name}: peak ratio {ratio}")
        if "card_flops" in got:
            meta = r["per_device"]["flops_macs"]
            log(f"  (c) {name}: the Recorder's FLOPs of a prefill on the "
                f"card {got['card_flops']:.6e}, on the meta device "
                f"{meta:.6e}")
            if got["card_flops"] != meta:
                raise AssertionError(f"phase 20 (c) {name}: card "
                                     f"{got['card_flops']} != meta {meta}")
        rows.append((name, terms["bound_s"] / sec, mfu))
    if LLAMA in paths \
            and not any("card_flops" in MEASURED[n] for n in paths):
        raise AssertionError("phase 20 (c): no path carried card FLOPs")

    full = get_config("mixtral-8x7b")
    path = MEASURED.get("mixtral-8x7b")
    fits = {}
    for what, arch, shape in () if path is None else (
            ("prefill_32k, full depth", full, SHAPES["prefill_32k"]),
            ("prefill_32k, 16 layers", path["arch"], SHAPES["prefill_32k"]),
            ("phase 17's path, full depth", full, path["shape"]),
            ("phase 17's path, 16 layers", path["arch"], path["shape"])):
        r = dryrun.run_cell(full.name, shape.name, mesh=one, arch=arch,
                            shape=shape, opts=dryrun.DryrunOptions(
                                cost_fit=False), verbose=False)
        fits[what] = r["memory"]["fits_hbm"]
        log(f"  (e) mixtral-8x7b {what} (B {shape.global_batch}, S "
            f"{shape.seq_len}, {arch.n_layers} layers): "
            f"{r['memory']['total_bytes'] / 1e9:.2f} GB predicted, fits_hbm "
            f"{fits[what]}")
    want = {"prefill_32k, full depth": False,
            "phase 17's path, full depth": False,
            "phase 17's path, 16 layers": True}
    if path is not None and any(fits[k] != v for k, v in want.items()):
        raise AssertionError(f"phase 20 (e): fits_hbm {fits}, expected "
                             f"{want}")

    dist.init_process_group(
        "nccl", init_method=f"tcp://localhost:{distributed.free_port()}",
        world_size=1, rank=0)
    try:
        dm = one.device_mesh("cuda")
        w = torch.arange(24, dtype=torch.float32, device="cuda").reshape(4, 6)
        spec = sharding.param_partition_specs({"layers.0.attn.wq": w},
                                              one)["layers.0.attn.wq"]
        placed = sharding.named_shardings(None, {"wq": spec}, dm)["wq"]
        d = distribute_tensor(w, dm, placed)
        log(f"  the one-card DeviceMesh {dm}: spec {spec}, placements "
            f"{d.placements}, local {tuple(d.to_local().shape)}")
        if not torch.equal(d.to_local(), w):
            raise AssertionError("phase 20: the placed tensor differs")
    finally:
        dist.destroy_process_group()
    log(f"phase 20 done in {time.perf_counter() - t0:.1f} s")
    return rows


# ---------------------------------------------------------------------------
# Phase 21: tensor, expert and sequence parallelism over the model axis.
# ---------------------------------------------------------------------------

# Two gloo ranks share the card as one model group (data 1 x model 2):
# NCCL refuses two ranks on one card. (a) tinyllama-1.1b at full width and
# depth, bf16, S 2048, global batch 2 in 2 microbatches, phase 16 (a)'s
# learning-rate schedule, 2 steps with shard_acts. (b)
# granite-moe-1b-a400m at full width and depth, bf16, S 2048, global batch
# 2 in 2 microbatches, 2 steps (EP: 16 of 32 experts a rank; the
# vocabulary of 49,155 whole). Each against the same steps in one process
# on the card. (c) f32 at 2 layers, tinyllama, granite and hymba widths, B
# 4, S 256, 2 steps, m = 2 with and without shard_acts against m = 1: the
# losses and step 1's reduced gradients within TP_BAR. (d) FSDP: the two
# ranks as data 2 x model 1 train tinyllama-1.1b at full width and depth,
# bf16, S 2048, global batch 2 in one microbatch (one row a rank: (a)'s 2
# in 2 would not divide by D k), 2 steps, each rank holding its shards of
# the weights and the AdamW moments (repro's fsdp rule); against (a)'s
# one-rank run, which sees the same two rows and the same mean. (a), (c)
# and (d) took 3 steps until (e) and (f) needed their time.
#
# (e) hymba-1.5b at full width and depth, bf16, S 2048 (2,176 positions
# with its 128 meta rows), global batch 2 in 2 microbatches, 2 steps with
# shard_acts: its attention (25 / 5 heads) and SSM heads split by flat
# columns, K5 on the whole heads on each rank. At 3 steps its third loss
# read 5.694e-03 from one rank's (H100 80GB HBM3, 700 W), AdamW's first
# steps amplifying bf16 rounding: its split is held exactly by (c) at f32
# instead, at hymba's widths. Each rank of (e) runs the whole recurrence
# and K5 at all heads, which the dry run's count of the rank's own step
# sees.
#
# (f) xlstm-350m at full width and depth, bf16, S 512 (the sLSTM's S
# host-launched steps a layer make S 2048's backward cost minutes), global
# batch 2 in one microbatch (in 2, each step's sLSTM launches double: 19.7
# s a step on one rank), 2 steps, its mLSTM and sLSTM split by heads (2 of
# 4 a rank). Each against the same steps in one process on the card, the
# port's first full-width training of a recurrent arch.
#
# (g) split serving, before the ranks train, on the weights (a), (b), (e)
# and (f) build from the seed (the one-rank references on the one-rank
# models, before they train too): each arch's prefill at B 1 and its
# run's S (K5 at the rank's heads, or at the whole heads of a flat column
# split, held to its plain version on layer 0's q, k, v), then TP_SERVE's
# 8 decode steps at batch 8 against a cache of 4,096 positions made from
# a seed and cut to the rank's share (``models.lm.shard_cache``: the
# KV cache's sequence split 2,048 / 2,048, hymba's ring of 1,024 split 512
# / 512 and wrapped, every slot live, the recurrent states whole), at
# positions 4,088-4,095; each rank's f32 copy of its shards against one
# rank's f32 copy within TP_SERVE_F32_BAR, both routed with one rank's
# bf16 MoE picks (the check that a wrong split fails); the bf16 logits
# against one rank's within the serving bar or twice one rank's own bf16
# error against its f32 copy; a rank's argument bytes (parameters, cache,
# tokens, pos) equal to the dry run's 1x2 decode cell, and (c)'s f32
# models the same at TP_BAR.
TP_M = 2
TP_FULL = {"tinyllama-1.1b": dict(B=2, S=2048, k=2, steps=2, sp=True,
                                  part="(a)"),
           "granite-moe-1b-a400m": dict(B=2, S=2048, k=2, steps=2,
                                        sp=False, part="(b)"),
           "hymba-1.5b": dict(B=2, S=2048, k=2, steps=2, sp=True,
                              part="(e)"),
           "xlstm-350m": dict(B=2, S=256, k=1, steps=2, sp=False,
                              part="(f)")}
# (h), (i): the archs whose batch carries extras, their frames or patches
# from a seed (the same on one rank and on each rank: the model axis does
# not split the batch), through the trainer's step. whisper-large-v3 at full
# width and depth, S 448 (its 1,500 frames a clip whole on each rank: the
# encoder runs without sequence parallelism, the decoder with it); the
# heads 10 a rank, the tied vocabulary 25,933. pixtral-12b at full width,
# 8 layers (phase 16 (g)'s cut), S 2048 (512 patch rows first, on rank 0
# under shard_acts), heads 16 / 4 a rank, the vocabulary 65,536.
TP_X = {"whisper-large-v3": dict(B=2, S=448, k=2, steps=2, sp=True,
                                 part="(h)"),
        "pixtral-12b": dict(B=2, S=2048, k=2, steps=2, sp=True, layers=8,
                            part="(i)")}
TP_FSDP = dict(B=2, S=2048, k=1, steps=2, sp=False)
TP_F32 = dict(B=4, S=256, steps=2, layers=2)
# (c)'s widths: hymba's flat columns too
TP_F32_ARCHS = ("tinyllama-1.1b", "granite-moe-1b-a400m", "hymba-1.5b")
TP_BAR = 1e-5                    # phase 16 (c)'s bar (f32)
# (g)'s decode: batch, cache length, steps at its last positions, seed
TP_SERVE = dict(B=8, S=4096, steps=8, seed=0)
SERVE_BAR = dict(atol=0.12, rtol=0.05)    # phases 9-19's bf16 serving bar
# (g): the ranks' f32 copies at full depth against one rank's f32 copy,
# max |m2 - m1| / max |m1| (the same function in f32, the same routing).
# A prefill runs S steps from the start: hymba's and xlstm's recurrences
# read 1.131e-04 / 2.098e-04 there (H100 80GB HBM3, 700 W), 8 decode steps
# at most 3.129e-05; a split that drops a sum or the merge reads 0.36-1.4
TP_SERVE_F32_BAR = dict(prefill=1e-3, decode=1e-4)
# bf16 losses, rel to one rank: sound runs read 3.1e-4 / 4.4e-4 (an H100
# 80GB HBM3 at 700 W), a wrong split reads the loss of other weights
TP_BF16_BAR = 5e-3


# The dry run's cells of phase 21's runs, each a rank's own step counted
# on the meta device (1x2 for TP_FULL's runs and (g)'s decode, 2x1 for
# (d)'s FSDP), in two subprocesses at the lowest priority from the
# script's start: xlstm's (its sLSTM's 12 x 512 steps a microbatch,
# forward and backward, op by op on the meta device) costs minutes of
# host, spent beside the phases before phase 21, which reads the cells
# (``tp_dry_cells``). The subprocesses also keep the count's process
# group (the ``fake`` backend's) out of the script's process.
TP_DRY = {}


def tp_dry_runs():
    """{key: (arch name, run, mesh)} of the runs whose cells phase 21
    reads: TP_FULL's and TP_X's at 1x2, and "fsdp", (d)'s at 2x1."""
    from repro_torch.launch.mesh import make_mesh
    runs = {name: (name, c, make_mesh((1, TP_M), ("data", "model")))
            for name, c in {**TP_FULL, **TP_X}.items()}
    runs["fsdp"] = (TRAIN_ARCH, TP_FSDP,
                    make_mesh((TP_M, 1), ("data", "model")))
    return runs


def tp_dry_write(path: str, keys: str) -> None:
    """The dry run's cells of the runs ``keys`` (comma-separated keys of
    ``tp_dry_runs``, or "``name`` train" for phase 16's TRAIN_X runs, which
    phase 20 reads as "phase 20 ``name`` train"): {key: its train cell,
    key + " decode": the arch's 1x2 decode cell (TP_FULL's runs)}, each
    rank 0's, and rank 1's of a run
    with shard_acts (key + " rank 1"), written to ``path`` as JSON (what a
    subprocess runs). Only under shard_acts do a model group's ranks run
    different shapes: the prefix rows (hymba's meta tokens, pixtral's
    patches) sit on rank 0 and, with a vocabulary the axis does not split,
    carry no logits there."""
    import dataclasses
    import torch
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    torch.set_num_threads(1)
    runs = tp_dry_runs()
    cells = {}
    for key in keys.split(","):
        if key.endswith(" train"):            # phase 16 (f), (g) on one card
            name = key[:-len(" train")]
            c = TRAIN_X[name]
            arch = x_arch(name, c)
            shape = x_shape(arch, c, c["part"])
            cells["phase 20 " + key] = dryrun.run_cell(
                name, shape.name, mesh=make_mesh((1, 1), ("data", "model")),
                arch=arch, shape=shape, opts=dryrun.DryrunOptions(
                    cost_fit=False, remat="none", microbatches=c["k"]),
                verbose=False)
            continue
        name, c, mesh = runs[key]
        shape = dataclasses.replace(SHAPES["train_4k"], global_batch=c["B"],
                                    seq_len=c["S"])
        # a cell of its own name: run_cell reads microbatches=1 as the
        # named cell's default (xlstm-350m's train_4k: 2)
        for r in range(TP_M if c["sp"] else 1):
            cells[key + (f" rank {r}" if r else "")] = dryrun.run_cell(
                name, "phase 21", mesh=mesh, arch=x_arch(name, c),
                shape=shape, opts=dryrun.DryrunOptions(
                    cost_fit=False, remat="none", microbatches=c["k"],
                    shard_acts=c["sp"]), verbose=False, rank=r)
        if key not in TP_FULL:
            continue
        # (g)'s decode at its batch and cache length
        shape = dataclasses.replace(SHAPES["decode_32k"],
                                    global_batch=TP_SERVE["B"],
                                    seq_len=TP_SERVE["S"])
        cells[name + " decode"] = dryrun.run_cell(
            name, "phase 21 (g)", mesh=mesh, arch=get_config(name),
            shape=shape, opts=dryrun.DryrunOptions(cost_fit=False),
            verbose=False)
    with open(path, "w") as f:
        json.dump(cells, f)


def tp_dry_start() -> None:
    """Start ``tp_dry_write`` in two subprocesses at nice 19 (once): one
    for xlstm-350m's cells (its sLSTM's steps, op by op on the meta
    device, are most of the work), one for the rest and phase 20's cells
    of TRAIN_X's runs, so the cells are ready no later than xlstm's alone.
    They are killed at exit if nothing collects them."""
    if TP_DRY:
        return
    import atexit
    import tempfile
    me = os.path.splitext(os.path.basename(__file__))[0]
    keys = list(TP_FULL) + list(TP_X) + ["fsdp"] \
        + [f"{name} train" for name in TRAIN_X]
    heavy = "xlstm-350m"
    procs = []
    for part in (heavy, ",".join(k for k in keys if k != heavy)):
        fd, path = tempfile.mkstemp(prefix="phase21_dry_", suffix=".json")
        os.close(fd)
        proc = subprocess.Popen(
            [sys.executable, "-c", f"import sys, {me}; "
             f"{me}.tp_dry_write(sys.argv[1], sys.argv[2])", path, part],
            cwd=ROOT, env=dict(os.environ, PYTHONPATH=os.pathsep.join(
                [os.path.dirname(os.path.abspath(__file__)), SRC])),
            preexec_fn=lambda: os.nice(19), stdout=subprocess.DEVNULL,
            stderr=subprocess.PIPE, text=True)
        procs.append((proc, path))
        atexit.register(lambda p=proc: p.poll() is None and p.kill())
    TP_DRY.update(procs=procs, t0=time.perf_counter(), cells={}, done=set())


def tp_dry_collect(which) -> float:
    """Wait for the subprocesses ``which`` (indices into TP_DRY["procs"])
    and add their cells to TP_DRY["cells"]; the seconds waited."""
    tp_dry_start()
    t0 = time.perf_counter()
    for i in which:
        if i in TP_DRY["done"]:
            continue
        proc, path = TP_DRY["procs"][i]
        _, err = proc.communicate(timeout=1200)
        if proc.returncode:
            raise AssertionError(f"the dry run's subprocess failed: "
                                 f"{err[-3000:]}")
        with open(path) as f:
            TP_DRY["cells"].update(json.load(f))
        os.remove(path)
        TP_DRY["done"].add(i)
    return time.perf_counter() - t0


def tp_dry_cells(heavy: bool = True) -> dict:
    """Wait for the dry run's cells ({key: cell}; without xlstm-350m's
    unless ``heavy``)."""
    waited = tp_dry_collect([0, 1] if heavy else [1])
    log(f"  the dry run's 1x2 and 2x1 cells (two subprocesses at nice 19): "
        f"done {time.perf_counter() - TP_DRY['t0']:.1f} s after their "
        f"start, waited {waited:.1f} s for")
    return TP_DRY["cells"]


def tp_schedule():
    from repro_torch.optim import AdamW, cosine_schedule
    return AdamW(learning_rate=cosine_schedule(3e-4, 2, TRAIN_STEPS))


class TpRecording:
    """An optimizer that keeps its first update's gradients (on the host),
    then updates as AdamW does."""

    def __init__(self, opt):
        self.opt, self.grads = opt, None

    def init(self, params):
        return self.opt.init(params)

    def update(self, grads, state, params, **kw):
        if self.grads is None:
            self.grads = {n: g.detach().float().cpu().clone()
                          for n, g in grads.items()}
        return self.opt.update(grads, state, params, **kw)


def tp_f32_arch(name):
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(name), n_layers=TP_F32["layers"],
                               dtype="float32")


def tp_trainer(arch, B, S, steps, k=1, sp=False, m=1, group=None, opt=None):
    """A trainer that keeps no checkpoint (its save is a no-op: a
    full-width gather and write is phase 16's to time); its pipeline's
    rows hold the tokens of S positions (``x_text_len``)."""
    import tempfile
    from repro_torch.data import TokenPipeline
    from repro_torch.runtime.driver import Trainer, TrainerConfig
    tr = Trainer(arch, opt or tp_schedule(),
                 TokenPipeline(arch.vocab_size, B, x_text_len(arch, S),
                               seed=0),
                 TrainerConfig(steps=steps, ckpt_dir=tempfile.mkdtemp(
                     prefix="phase21_"), ckpt_every=steps + 1,
                     microbatches=k, model_axis=m, shard_acts=sp),
                 group=group, device="cuda")
    tr._save = lambda: None
    return tr


@contextlib.contextmanager
def tp_routing(force=None):
    """Within the block each MoE call's (picks, router probabilities) on
    the device, appended to the list it yields in the order of the calls
    (no host copy: the caller copies after its timed steps). ``force``:
    another run's list, whose picks each call takes in place of its own
    (its weights renormalised from its own probabilities), so that
    another model computes that run's routing."""
    import torch
    from torch.utils._python_dispatch import _disable_current_modes
    from repro_torch.models import layers as L
    picks, real_route = [], L.moe_route
    forced = None
    if force is not None:
        forced = [t.to("cuda") for t, _ in force]

    def route(router, xf, top_k, dp=None):
        got = real_route(router, xf, top_k, dp)
        # the probabilities kept are this harness's product, not the
        # model's: an open Recorder does not count it
        with _disable_current_modes():
            probs = torch.softmax(xf.float() @ router, -1)
        if forced is not None:
            tope = forced[len(picks)]
            topw = probs.gather(-1, tope)
            topw = topw / torch.clamp_min(topw.sum(-1, keepdim=True), 1e-9)
            got = (topw, tope) + tuple(got[2:])
        picks.append((got[1], probs))
        return got
    L.moe_route = route
    try:
        yield picks
    finally:
        L.moe_route = real_route


def tp_host(picks):
    return [(t.cpu(), p.cpu()) for t, p in picks]


def tp_serve(arch, model, group, S, B=1, force=None):
    """(g) on this rank (``group``: the model group, or None for one
    rank) before ``model`` trains: a prefill of B x S tokens from
    TP_SERVE's seed (K5's launches, its first call's shapes and its error
    against the plain version on them), then TP_SERVE's decode steps
    against a whole cache drawn from the seed and cut to the rank's
    share, the last step under the ``Recorder`` on the ranks. Returns the
    logits, the greedy tokens, the MoE picks of the prefill and the
    decode, the walls, the rank's argument bytes and cache bytes, the
    collectives by group. A bf16 model also serves an f32 copy of itself
    (on the ranks, of their shards) on the same inputs, its MoE routed
    as one rank's bf16 run (``prefill_f32``, ``decode_f32``): one rank's
    copy gives its own bf16 error, and the ranks' copies against one
    rank's hold the split exactly at full depth. ``force``: one rank's
    MoE picks {"prefill", "decode"}, with which the ranks' f32 copies
    route, and with which the rank decodes again from the same cache
    (``decode_forced``)."""
    import copy
    import torch
    from repro_torch.analysis.record import Recorder
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.models import layers as L
    from repro_torch.models import lm

    c = TP_SERVE
    start = time.perf_counter()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(c["seed"])
    toks = torch.randint(arch.vocab_size, (B, S), generator=gen,
                         device="cuda")
    kept, real_fa = {}, L.flash_attention

    def first_call(q, k, v, **kw):
        kept.setdefault("qkv", ((q, k, v), kw))
        return real_fa(q, k, v, **kw)
    zero_counts()
    L.flash_attention = first_call
    try:
        with torch.inference_mode(), tp_routing() as routed:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            last = model.prefill(toks)
            torch.cuda.synchronize()
            prefill_s = time.perf_counter() - t0
    finally:
        L.flash_attention = real_fa
    out = {"prefill": last.float().cpu(), "prefill_s": prefill_s,
           "prefill_picks": tp_host(routed),
           "launches": dict(flash_attention=flash_attention.launches,
                            **{"k5 " + b: n for b, n in
                               flash_attention.route_launches.items()}),
           "k5_shape": None, "k5_err": None, "k5_ok": None}
    del routed
    if "qkv" in kept:
        (q, k, v), kw = kept.pop("qkv")
        with torch.no_grad():
            o = flash_attention(q, k, v, **kw).float()
            want = attention_ref(q, k, v, **kw).float()
        out.update(k5_shape=(tuple(q.shape), tuple(k.shape)),
                   k5_err=float((o - want).abs().max()),
                   k5_ok=bool(torch.allclose(o, want, rtol=2.0 ** -7,
                                             atol=4e-3)))
        del q, k, v, o, want
    # one rank's MoE picks, which the f32 copies take
    force = force or {"prefill": out["prefill_picks"]}
    ref = None
    if arch.dtype != "float32":
        # sharing the model group, which a deep copy cannot copy
        group_of = model.axis.group if model.axis is not None else None
        ref = copy.deepcopy(model, {id(group_of): group_of}).float()
        with torch.inference_mode(), tp_routing(force["prefill"]):
            out["prefill_f32"] = ref.prefill(toks).cpu()
    if group is None and ref is not None:
        # one rank's own f32 sensitivity: its copy again with every
        # weight moved one ulp, up or down by a coin from its own seed
        nudged, coin = copy.deepcopy(ref), torch.Generator(device="cuda")
        coin.manual_seed(c["seed"] + 1)
        with torch.no_grad():
            for p in nudged.parameters():
                up = torch.rand(p.shape, generator=coin, device="cuda") < 0.5
                p.copy_(torch.nextafter(p, torch.where(up, math.inf,
                                                       -math.inf)))
        with torch.inference_mode(), tp_routing(force["prefill"]):
            out["prefill_f32_ulp"] = nudged.prefill(toks).cpu()
        del nudged
    del last, toks
    cache = lm.init_cache(arch, c["B"], c["S"], "cuda")
    with torch.no_grad():
        for layers in cache.values():
            for t in layers:
                if t is not None:
                    t.copy_(torch.randn(t.shape, generator=gen,
                                        device="cuda").mul_(0.5))
    cache32 = None
    if ref is not None:
        # a copy: the f32 states would alias the decode's own
        cache32 = lm.Cache({e: [None if t is None else t.to(
            torch.float32, copy=True) for t in ts] for e, ts in cache.items()})
        cache32.seq_len = cache.seq_len
    if model.axis is not None:
        cache = lm.shard_cache(cache, model.axis)
        if cache32 is not None:
            cache32 = lm.shard_cache(cache32, model.axis)
    dtoks = torch.randint(arch.vocab_size, (c["B"], c["steps"]),
                          generator=gen, device="cuda")
    held = {kind: path_bytes([t for e, ts in cache.items() for t in ts
                              if t is not None and (e in ("k", "v"))
                              == (kind == "kv")])
            for kind in ("kv", "states")}
    out.update(args=path_bytes(model, cache) + c["B"] * 4 + 4, held=held)
    again = None
    if "decode" in force:           # the rank's cache, before it decodes
        again = lm.Cache({e: [None if t is None else t.clone() for t in ts]
                          for e, ts in cache.items()})
        again.seq_len = c["S"]
    rec = Recorder()
    decode, walls, picks = tp_decode(model, cache, dtoks, group, rec)
    out.update(decode=decode, tokens=decode.argmax(-1), walls=walls,
               picks=picks, collectives={} if group is None else
               tp_group(rec, model.axis.group),
               decode_flops=sum(t.flops for t in rec.spans()))
    del cache
    force.setdefault("decode", picks)
    if again is not None:
        out["decode_forced"] = tp_decode(model, again, dtoks, None, None,
                                         force=force["decode"])[0]
        del again
    if ref is not None:
        out["decode_f32"] = tp_decode(ref, cache32, dtoks, None, None,
                                      force=force["decode"])[0]
        del ref, cache32
    del dtoks
    torch.cuda.empty_cache()
    out["wall"] = time.perf_counter() - start
    return out


def tp_decode(model, cache, dtoks, group, rec, force=None):
    """TP_SERVE's decode steps at its last positions, the ranks' last
    step under ``rec``: (the logits (steps, B, V) on the host, each
    step's wall, each MoE call's picks and router probabilities on the
    host, copied after the steps). ``force``: another run's picks, which
    each MoE call takes (``tp_routing``)."""
    import torch
    c = TP_SERVE
    logits, walls = [], []
    with torch.inference_mode(), tp_routing(force) as picks:
        for step in range(c["steps"]):
            recorded = group is not None and step == c["steps"] - 1
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with rec if recorded else contextlib.nullcontext():
                got, cache = model.decode_step(
                    dtoks[:, step:step + 1], cache,
                    c["S"] - c["steps"] + step)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            logits.append(got[:, 0].float())
    return torch.stack(logits).cpu(), walls, tp_host(picks)


def tp_routed_alike(arch, got, want):
    """The (steps, B) mask of the decode tokens whose MoE routing equals
    one rank's at every layer and step so far: the same top-k picks in
    order and the same picks kept under the capacity (a flip elsewhere
    moves the places behind it); and the largest gap between one rank's
    K-th and (K+1)-th router probability where a token's picks first
    differ (0.0 when none do). ``got`` / ``want``: ``tp_serve``'s
    ``picks``."""
    import torch
    from repro_torch.models.layers import expert_places
    steps, E, K = TP_SERVE["steps"], arch.n_experts, arch.top_k
    per = len(want) // steps
    B = want[0][0].shape[0]
    C = max(int(B * K / E * arch.capacity_factor), 4)
    alike, rows, gap = torch.ones(B, dtype=torch.bool), [], 0.0
    for s in range(steps):
        for (tg, _), (to, probs) in zip(got[s * per:(s + 1) * per],
                                        want[s * per:(s + 1) * per]):
            kept = [(expert_places(t.reshape(-1), E) < C).view(B, K)
                    for t in (tg, to)]
            # a flip's gap, where the token's routing was one rank's
            # until this call (after it, its input is another)
            flip = alike & (tg.sort(-1).values != to.sort(-1).values).any(-1)
            alike &= (tg == to).all(-1) & (kept[0] == kept[1]).all(-1)
            if flip.any():
                top = probs.sort(-1, descending=True).values
                gap = max(gap, float((top[:, K - 1] - top[:, K])[flip].max()))
        rows.append(alike.clone())
    return torch.stack(rows), gap


def tp_group(rec, group) -> dict:
    """{kind: {"count", "bytes"}} of the collectives ``rec`` saw on
    ``group`` (None: none), the dry run's ``collectives_by_axis``
    layout: each kind's count and result bytes."""
    if group is None:
        return {}
    return rec.collective_traffic().get(group.group_name, {})


def tp_counts(kinds) -> dict:
    """{kind: count} of ``tp_group``'s layout."""
    return {kind: v["count"] for kind, v in kinds.items()}


def tp_held_to_dry(got, cell) -> list:
    """What differs between a rank's last step (``tp_full_run``'s
    collectives by axis and FLOPs) and the dry run's cell of it (rank 0's
    step on the meta device): [] when the collectives (each axis's kinds,
    count and result bytes) and the FLOPs are equal, exactly."""
    want = {a: k for a, k in cell["collectives_by_axis"].items() if k}
    have = {a: k for a, k in got["collectives"].items() if k}
    out = []
    if have != want:
        out.append(f"collectives {have} != the dry run's {want}")
    if got["flops"] != cell["per_device"]["flops_macs"]:
        out.append(f"FLOPs {got['flops']} != the dry run's "
                   f"{cell['per_device']['flops_macs']}")
    return out


def tp_full_run(name, group, c=None, m=None, force=None):
    """One full-width path on this rank (``group``: the two ranks, or None
    for one process; ``c``: the run, TP_FULL[name] by default; ``m``: the
    model axis, TP_M on the two ranks by default, 1 for (d)'s FSDP):
    losses, step walls, launches, peak and argument bytes, counted
    reductions, the last step's collectives by axis (``tp_group``'s
    count and result bytes) and FLOPs, K5 on layer 0's q/k/v."""
    import torch
    from repro_torch.analysis.record import Recorder
    from repro_torch.configs import get_config
    from repro_torch.core import linalg
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.models import layers as L

    serve = c is None                        # (g) before (a)-(f) train
    c = c or TP_FULL[name]
    arch = x_arch(name, c)
    if m is None:
        m = 1 if group is None else TP_M
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tr = tp_trainer(arch, c["B"], c["S"], c["steps"], c["k"], c["sp"], m,
                    group)
    # the build's peak, kept: the window restarts after (g)'s serving
    build = torch.cuda.max_memory_allocated()
    served = tp_serve(arch, tr.model, group, c["S"], force=force) \
        if serve else None
    # (h), (i): the frames or patches, every row on each rank (data 1),
    # the same each step
    extras = x_extras(arch, c["B"], c["S"], 13)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    resident = path_bytes(tr.model, tr.opt_state, extras)
    inner, walls, kept = tr.step_fn, [], {}
    real_fa = L.flash_attention

    def first_call(q, k, v, **kw):
        kept.setdefault("qkv", ((q.detach(), k.detach(), v.detach()), kw))
        return real_fa(q, k, v, **kw)
    rec = Recorder()

    def step(model, state, batch):
        # the ranks' last step under the Recorder (one rank has no
        # collectives to tally, and the Recorder's dispatch costs host)
        last = len(walls) == c["steps"] - 1 and group is not None
        batch = dict(batch, **extras)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if last:
            with rec:
                out = inner(model, state, batch)
        else:
            out = inner(model, state, batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        return out
    tr.step_fn = step
    zero_counts()
    L.flash_attention = first_call
    try:
        with linalg.count_reductions() as counted:
            res = tr.run()
    finally:
        L.flash_attention = real_fa
    got = dict(read_counts(), **{"k5 " + b: n for b, n in
                                 flash_attention.route_launches.items()})
    peak = measured_peak(before, resident)
    peak["peak"] = max(peak["peak"], build - peak["other"])
    grid = tr.grid
    rows = c["B"] // grid.data.size          # the rank's tokens and targets
    out = {"losses": res["losses"], "walls": walls, "launches": got,
           "args": peak["args"] + 2 * rows * x_text_len(arch, c["S"]) * 4,
           "reductions": counted.n,
           "peak": peak["peak"], "other": peak["other"],
           "collectives": {"model": tp_group(rec, grid.model.group),
                           "data": tp_group(rec, grid.data.group)},
           "flops": sum(t.flops for t in rec.spans()),
           "k5_shape": None, "k5_err": None, "k5_ok": None,
           "params": sum(p.numel() for p in tr.model.parameters()),
           "events": res["events"], "lost": res["lost"], "serve": served}
    del tr, extras
    if "qkv" in kept:                        # an arch with attention
        (q, k, v), kw = kept.pop("qkv")
        with torch.no_grad():
            o = flash_attention(q, k, v, **kw)
            want = attention_ref(q, k, v, **kw).float()
        out.update(k5_shape=(tuple(q.shape), tuple(k.shape)),
                   k5_err=float((o.float() - want).abs().max()),
                   k5_ok=bool(torch.allclose(o.float(), want,
                                             rtol=2.0 ** -7, atol=4e-3)))
        del q, k, v, o, want
    torch.cuda.empty_cache()
    return out


def tp_f32_run(name, sp, group, tmp, rank):
    """(c) on this rank: 3 f32 steps at 2 layers; the losses and the
    largest relative error of step 1's reduced gradients against the
    one-rank reference's (its shards, cut as this rank holds them)."""
    import torch
    from repro_torch.parallel import tensor as par
    arch = tp_f32_arch(name)
    opt = TpRecording(tp_schedule())
    tr = tp_trainer(arch, TP_F32["B"], TP_F32["S"], TP_F32["steps"],
                    sp=sp, m=TP_M, group=group, opt=opt)
    # (g) at f32, once an arch, before it trains
    served = None if sp else tp_serve(arch, tr.model, group, TP_F32["S"])
    res = tr.run()
    ref = torch.load(os.path.join(tmp, f"ref_{name}.pt"), weights_only=False)
    lay = par.layout(arch, TP_M)
    worst = 0.0
    for n, g in opt.grads.items():
        want = par.cut(ref["grads"][n], lay[n], tr.grid.model)
        worst = max(worst, leaf_err(g, want))
    del tr, opt, ref
    torch.cuda.empty_cache()
    return {"losses": res["losses"], "grad_err": worst, "serve": served}


def tp_rank(rank, world, tmp, extras_only=False):
    """Phase 21 on one of the two gloo ranks sharing the card (only (h)
    and (i) with ``extras_only``)."""
    import torch
    import torch.distributed as dist
    out = {}
    for name, c in TP_X.items():
        out[name] = tp_full_run(name, dist.group.WORLD, c)
    if extras_only:
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
        return
    picks = torch.load(os.path.join(tmp, "picks.pt"), weights_only=False)
    for name in TP_FULL:
        out[name] = tp_full_run(name, dist.group.WORLD,
                                force=picks.get(name))
    out["fsdp"] = tp_full_run(TRAIN_ARCH, dist.group.WORLD, TP_FSDP, m=1)
    for name in TP_F32_ARCHS:
        for sp in (False, True):
            out[(name, sp)] = tp_f32_run(name, sp, dist.group.WORLD, tmp,
                                         rank)
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))


def tp_rel(got, want):
    return max(abs(a - b) / abs(b) for a, b in zip(got, want))


def phase_tp(smi: str, extras_only: bool = False):
    """Phase 21: tensor, expert and sequence parallelism over two gloo
    ranks sharing the card (see TP_FULL, TP_X, TP_F32): (a), (b), (e),
    (f), (h) and (i) at full width, with the dry run's 1x2 prediction of
    each rank's argument bytes, its last step's FLOPs and collectives (by
    axis and kind, count and result bytes; all exact; a rank's own cell
    under shard_acts) and its peak (within phase 20's PEAK_RATIO), and
    (c); then (d), FSDP over the two ranks as data 2 (TP_FSDP,
    ``phase_tp_fsdp``, held to the 2x1 cell the same way); (g), their
    split serving before they train (TP_SERVE, ``phase_tp_serve``). With
    ``extras_only``, (h) and (i) alone."""
    import tempfile
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import distributed
    from repro_torch.models import lm

    tp_dry_start()
    t0 = time.perf_counter()
    log(f"phase 21: tensor, expert and sequence parallelism, {TP_M} gloo "
        f"ranks on the one card as one model group (data 1 x model {TP_M}), "
        f"then as data {TP_M} x model 1 (FSDP); gloo reduces CUDA tensors "
        f"through the host, not NCCL over NVLink; {smi}")
    full = {} if extras_only else TP_FULL
    with tempfile.TemporaryDirectory(prefix="phase21_") as tmp:
        one = {name: tp_full_run(name, None, c) for name, c in TP_X.items()}
        one.update((name, tp_full_run(name, None)) for name in full)
        # (g): one rank's MoE decode picks, which the ranks decode with too
        torch.save({name: {"prefill": one[name]["serve"]["prefill_picks"],
                           "decode": one[name]["serve"]["picks"]}
                    for name in full if get_config(name).n_experts},
                   os.path.join(tmp, "picks.pt"))
        for name in () if extras_only else TP_F32_ARCHS:
            arch = tp_f32_arch(name)
            opt = TpRecording(tp_schedule())
            tr = tp_trainer(arch, TP_F32["B"], TP_F32["S"], TP_F32["steps"],
                            opt=opt)
            one[("f32 serve", name)] = tp_serve(arch, tr.model, None,
                                                TP_F32["S"])
            losses = tr.run()["losses"]
            torch.save({"grads": opt.grads}, os.path.join(tmp,
                                                         f"ref_{name}.pt"))
            one[("f32", name)] = losses
            del tr, opt
            torch.cuda.empty_cache()
        t1 = time.perf_counter()
        distributed.run_ranks(tp_rank, TP_M, "gloo", device="cuda",
                              args=(tmp, extras_only))
        ranks = {r: torch.load(os.path.join(tmp, f"rank{r}.pt"),
                               weights_only=False) for r in range(TP_M)}
        log(f"  {TP_M} ranks done in {time.perf_counter() - t1:.1f} s")
    cells = tp_dry_cells(heavy=not extras_only)
    failed = []
    for name, c in {**full, **TP_X}.items():
        arch = x_arch(name, c)
        part = c["part"]
        want = one[name]["losses"]
        layers, k = arch.n_layers, c["k"]
        depth = f"depth cut to {layers} layers (" if c.get("layers") \
            else f"depth ({layers} layers, "
        log(f"  {part} {name}: full width and {depth}"
            f"{arch.dtype}), S {c['S']}, global batch {c['B']} in {k} "
            f"microbatch(es), {c['steps']} steps, shard_acts {c['sp']}, "
            f"cosine_schedule(3e-4, 2, {TRAIN_STEPS}); one-rank losses "
            f"{' '.join(f'{x:.4f}' for x in want)}")
        o = one[name]
        log(f"    one rank: step walls (s) "
            f"{' '.join(f'{w:.4f}' for w in o['walls'])}; peak "
            f"{o['peak'] / 2 ** 30:.3f} GiB; arguments {o['args']} B; "
            f"launches {o['launches']}")
        # K5 launches: each attention layer (and an encoder-decoder arch's
        # encoder layers and cross calls), a microbatch and step, at the
        # rank's heads, or at the whole heads where the split cuts a head
        per = k5_per_microbatch(arch) * k * c["steps"]
        heads = arch.n_heads // TP_M if arch.n_heads % TP_M == 0 \
            and arch.n_kv_heads % TP_M == 0 else arch.n_heads
        for r in range(TP_M):
            got = ranks[r][name]
            rel = tp_rel(got["losses"], want)
            # the rank's own cell, where the ranks' steps differ (SP)
            cell = cells.get(f"{name} rank {r}", cells[name])
            if cell["status"] != "ok":
                raise AssertionError(f"phase 21 {part}: the dry run "
                                     f"failed: {cell.get('traceback')}")
            mem = cell["memory"]
            ratio = mem["total_bytes"] / got["peak"]
            log(f"    rank {r}: losses "
                f"{' '.join(f'{x:.4f}' for x in got['losses'])} (max rel to "
                f"one rank {rel:.3e}, bar {TP_BF16_BAR}); step walls (s) "
                f"{' '.join(f'{w:.4f}' for w in got['walls'])}; "
                f"{got['params']} parameters; peak "
                f"{got['peak'] / 2 ** 30:.3f} GiB; arguments {got['args']} "
                f"B, the dry run's 1x2 prediction {mem['argument_bytes']} B; "
                f"predicted peak {mem['total_bytes']} B (temp "
                f"{mem['temp_bytes']}), ratio {ratio:.4f} (bar {PEAK_RATIO})")
            log(f"    rank {r}: launches {got['launches']} (K5 at "
                f"{got['k5_shape']}; expected {per} wgmma, "
                f"{per // c['steps']} a step); the last step's FLOPs "
                f"{got['flops']:.0f} (the dry run's 1x2 rank "
                f"{cell['per_device']['flops_macs']:.0f}) and collectives "
                f"by axis, count and result bytes {got['collectives']} "
                f"(the dry run's {cell['collectives_by_axis']}); K5 against "
                f"its plain version on layer 0's q/k/v max_abs_err "
                f"{got['k5_err']} (rtol 2^-7, atol 4e-3)")
            if got["lost"] or got["events"] or rel > TP_BF16_BAR \
                    or not all(math.isfinite(x) for x in got["losses"]):
                raise AssertionError(f"phase 21 {part} rank {r}: {got}")
            if got["launches"]["flash_attention"] != per \
                    or got["launches"]["k5 wgmma"] != per \
                    or got["launches"]["k5 simt"] != 0 \
                    or (per and (got["k5_shape"][0][1] != heads
                                 or not got["k5_ok"])):
                raise AssertionError(f"phase 21 {part} rank {r}: K5 "
                                     f"{got['launches']} {got['k5_shape']}")
            if tp_counts(got["collectives"]["data"]) != {"all-reduce": 1} \
                    or not got["collectives"]["model"]:
                raise AssertionError(f"phase 21 {part} rank {r}: "
                                     f"collectives {got['collectives']}")
            if got["args"] != mem["argument_bytes"]:
                raise AssertionError(f"phase 21 {part} rank {r}: argument "
                                     f"bytes {got['args']} != "
                                     f"{mem['argument_bytes']}")
            # every rank and part is logged before these raise
            failed += [f"{part} rank {r}: {x}"
                       for x in tp_held_to_dry(got, cell)]
            if not PEAK_RATIO[0] <= ratio <= PEAK_RATIO[1]:
                failed.append(f"{part} rank {r}: peak ratio {ratio}")
    if not extras_only:
        failed += phase_tp_fsdp(one[TRAIN_ARCH]["losses"], ranks,
                                cells["fsdp"])
        try:
            phase_tp_serve(one, ranks, cells, smi)
        except AssertionError as e:
            failed.append(str(e))
    if failed:
        raise AssertionError(f"phase 21: {failed}")
    for name in () if extras_only else TP_F32_ARCHS:
        want = one[("f32", name)]
        for sp in (False, True):
            for r in range(TP_M):
                got = ranks[r][(name, sp)]
                rel = tp_rel(got["losses"], want)
                log(f"  (c) f32 {name} widths at {TP_F32['layers']} layers, "
                    f"B {TP_F32['B']}, S {TP_F32['S']}, shard_acts {sp}, "
                    f"rank {r}: losses "
                    f"{' '.join(f'{x:.7f}' for x in got['losses'])}, max rel "
                    f"to one rank {rel:.3e}; step 1's reduced gradients, max "
                    f"|m2 - m1| / max |m1| per leaf {got['grad_err']:.3e} "
                    f"(bar {TP_BAR})")
                if not rel <= TP_BAR or not got["grad_err"] <= TP_BAR:
                    raise AssertionError(f"phase 21 (c) {name} sp={sp} rank "
                                         f"{r}: {got}")
    log(f"phase 21 done in {time.perf_counter() - t0:.1f} s")
    # K5's launches a step on each rank of the model axis, as counted
    per_step = {}
    for name, c in {**full, **TP_X}.items():
        counts = {ranks[r][name]["launches"]["k5 wgmma"] for r in ranks}
        if len(counts) != 1:
            raise AssertionError(f"phase 21 {name}: K5 launches differ "
                                 f"between the ranks: {counts}")
        if lm.has_attention(get_config(name)):
            per_step[name] = counts.pop() // c["steps"]
    if extras_only:
        return {"tp_launches_per_step": per_step}
    counts = {ranks[r]["fsdp"]["launches"]["k5 wgmma"] for r in ranks}
    if len(counts) != 1:
        raise AssertionError(f"phase 21 (d): K5 launches differ between the "
                             f"ranks: {counts}")
    per_step[TRAIN_ARCH + " fsdp"] = counts.pop() // TP_FSDP["steps"]
    return {"tp_launches_per_step": per_step}


def tp_logit_err(got, want) -> float:
    """max |got - want| / max |want|."""
    return float((got - want).abs().max() / want.abs().max())


def tp_within(got, want, f32):
    """(passed, max |got - want|, one rank's own max |want - f32|): got
    within SERVE_BAR of want, or no farther from it than twice one rank's
    own bf16 error (two bf16 roundings of the same function apart)."""
    import torch
    gap = float((got - want).abs().max())
    own = float((want - f32).abs().max())
    return (bool(torch.allclose(got, want, **SERVE_BAR))
            or gap <= 2 * own), gap, own


def phase_tp_serve(one, ranks, cells, smi):
    """Phase 21 (g)'s checks: each rank's prefill and decode logits
    against one rank's at TP_BAR (f32, (c)'s models); at full depth, the
    rank's f32 copy against one rank's f32 copy within TP_SERVE_F32_BAR
    (both routed with one rank's bf16 picks; one rank's own sensitivity,
    its copy with every weight moved one ulp, logged), and at bf16 within
    ``tp_within``'s bar (an MoE's decode taken again with one rank's
    picks; its own picks may differ only at a top-k near-tie), K5 in
    each split prefill
    (one wgmma launch an attention layer at the rank's heads, or at the
    whole heads of a flat column split, held to its plain version), a
    rank's argument bytes equal to the dry run's 1x2 decode cell, and its
    last decode step's collectives (count and result bytes) and FLOPs
    equal to the cell's (rank 0's step on the meta device); the greedy
    tokens' agreement and the decode ms a step on two ranks against one
    logged. Every arch and rank is logged before a failure raises."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    c = TP_SERVE
    failed = []
    for name in TP_F32_ARCHS:
        o = one[("f32 serve", name)]
        for r in range(TP_M):
            g = ranks[r][(name, False)]["serve"]
            pre, dec = (tp_logit_err(g[k], o[k]) for k in ("prefill",
                                                           "decode"))
            log(f"  (g) f32 {name} widths at {TP_F32['layers']} layers, "
                f"rank {r}: prefill B 1 S {TP_F32['S']} and {c['steps']} "
                f"decode steps, max |m2 - m1| / max |m1| {pre:.3e} / "
                f"{dec:.3e} (bar {TP_BAR})")
            if not (pre <= TP_BAR and dec <= TP_BAR):
                failed.append(f"f32 {name} rank {r}: {pre} {dec}")
    log(f"  (g) split serving, before training, on the runs' weights: "
        f"prefill at B 1 and each run's S, then {c['steps']} decode steps "
        f"at batch {c['B']} against a cache of {c['S']} positions from "
        f"seed {c['seed']} cut to each rank's share, at positions "
        f"{c['S'] - c['steps']}-{c['S'] - 1}; one rank and each rank also "
        f"serve an f32 copy (one rank's own bf16 error, and the split held "
        f"in f32 at full depth); {smi}")
    for name, run in TP_FULL.items():
        arch = get_config(name)
        o = one[name]["serve"]
        cell = cells[name + " decode"]
        if cell["status"] != "ok":
            raise AssertionError(f"phase 21 (g) {name}: the dry run failed: "
                                 f"{cell.get('traceback')}")
        mem = cell["memory"]
        per = sum(arch.block_at(i) in lm.ATTENTION_KINDS
                  for i in range(arch.n_layers))
        heads = arch.n_heads // TP_M if arch.n_heads % TP_M == 0 \
            and arch.n_kv_heads % TP_M == 0 else arch.n_heads
        one_ms = 1e3 * float(np.median(o["walls"][1:]))
        walls = ", ".join(f"{ranks[r][name]['serve']['wall']:.1f}"
                          for r in range(TP_M))
        log(f"    {name}: one rank served in {o['wall']:.1f} s (each rank "
            f"{walls} s); prefill S {run['S']} "
            f"{o['prefill_s']:.4f} s, decode {one_ms:.2f} ms a step (median "
            f"of steps 2-{c['steps']}), cache {o['held']['kv']} B of k and "
            f"v, {o['held']['states']} B of states; launches "
            f"{o['launches']}")
        for r in range(TP_M):
            g = ranks[r][name]["serve"]
            alike = tp_routed_alike(arch, g["picks"], o["picks"]) \
                if arch.n_experts else (None, 0.0)
            share = float(alike[0].float().mean()) if arch.n_experts \
                else 1.0
            pre_ok, pre_gap, pre_own = tp_within(
                g["prefill"], o["prefill"], o["prefill_f32"])
            # an MoE held with one rank's picks: a flip at a near-tie
            # moves the capacity's drops behind it, at batch 8 in every
            # token within the 24 layers and 8 steps
            dec_ok, dec_gap, dec_own = tp_within(
                g["decode_forced"] if arch.n_experts else g["decode"],
                o["decode"], o["decode_f32"])
            # the same function in f32 at full depth, routed alike
            f32 = [tp_logit_err(g[k], o[k]) for k in ("prefill_f32",
                                                      "decode_f32")]
            agree = float((g["tokens"] == o["tokens"]).float().mean())
            ms = 1e3 * float(np.median(g["walls"][1:-1]))
            log(f"    {name} rank {r}: f32 copies at full depth (one "
                f"rank's MoE picks), max |m2 - m1| / max |m1| prefill "
                f"{f32[0]:.3e} (max |m1| "
                f"{float(o['prefill_f32'].abs().max()):.4f}; one rank's "
                f"copy with every weight moved one ulp "
                f"{tp_logit_err(o['prefill_f32_ulp'], o['prefill_f32']):.3e})"
                f", decode {f32[1]:.3e} (max |m1| "
                f"{float(o['decode_f32'].abs().max()):.4f}), bars "
                f"{TP_SERVE_F32_BAR}")
            log(f"    {name} rank {r}: prefill {g['prefill_s']:.4f} s, "
                f"last-position logits {tuple(g['prefill'].shape)} max "
                f"|m2 - m1| {pre_gap:.4e} (max |m1| "
                f"{float(o['prefill'].abs().max()):.4f}; one rank's own "
                f"bf16 error {pre_own:.4e}); decode max |m2 - m1| "
                f"{dec_gap:.4e} (max |m1| "
                f"{float(o['decode'].abs().max()):.4f}; its own "
                f"{dec_own:.4e})"
                + (f" with one rank's MoE picks (the f32 copy's too); its "
                   f"own routing is one rank's at {share:.4f} of the "
                   f"token-steps, a flip's largest top-k gap "
                   f"{alike[1]:.3e} (bar 1e-2), and its own decode's max "
                   f"|m2 - m1| "
                   f"{float((g['decode'] - o['decode']).abs().max()):.4e}"
                   if arch.n_experts else "")
                + f"; bar: atol {SERVE_BAR['atol']} rtol "
                f"{SERVE_BAR['rtol']}, or within twice one rank's own; "
                f"greedy tokens agree {agree:.4f}; {ms:.2f} ms a decode "
                f"step (median of steps 2-{c['steps'] - 1}) against one "
                f"rank's {one_ms:.2f}; the last step's collectives on the "
                f"model group, count and result bytes {g['collectives']} "
                f"(the dry run's 1x2 decode cell "
                f"{cell['collectives_by_axis']}), its FLOPs "
                f"{g['decode_flops']:.0f} (the cell's "
                f"{cell['per_device']['flops_macs']:.0f})")
            log(f"    {name} rank {r}: K5 launches {g['launches']} at "
                f"{g['k5_shape']} (expected {per} wgmma"
                + (f" at {heads} heads" if per else "") + "), "
                f"max_abs_err against its plain version {g['k5_err']}; "
                f"holds {g['held']['kv']} B of k and v, "
                f"{g['held']['states']} B of states; arguments "
                f"{g['args']} B, the dry run's 1x2 decode cell "
                f"{mem['argument_bytes']} B")
            if not (pre_ok and dec_ok) or not torch.isfinite(
                    g["decode"]).all() or g["prefill"].shape \
                    != (1, 1, arch.vocab_size) or alike[1] >= 1e-2:
                failed.append(f"{name} rank {r}: logits off one rank's")
            if not (f32[0] <= TP_SERVE_F32_BAR["prefill"]
                    and f32[1] <= TP_SERVE_F32_BAR["decode"]):
                failed.append(f"{name} rank {r}: f32 logits off one "
                              f"rank's: {f32}")
            if g["launches"]["flash_attention"] != per \
                    or g["launches"]["k5 wgmma"] != per \
                    or g["launches"]["k5 simt"] != 0 \
                    or (per and (g["k5_shape"][0][1] != heads
                                 or not g["k5_ok"])):
                failed.append(f"{name} rank {r}: K5 {g['launches']} "
                              f"{g['k5_shape']}")
            if g["args"] != mem["argument_bytes"]:
                failed.append(f"{name} rank {r}: argument bytes "
                              f"{g['args']} != {mem['argument_bytes']}")
            # the decode's collectives are the model group's: the cell's
            # data axis (one rank) has none
            failed += [f"{name} rank {r}: {x}" for x in tp_held_to_dry(
                {"collectives": {"model": g["collectives"]},
                 "flops": g["decode_flops"]}, cell)]
    if failed:
        raise AssertionError(f"phase 21 (g): {failed}")


def phase_tp_fsdp(want, ranks, cell) -> list:
    """Phase 21 (d)'s checks: each rank's losses within TP_BF16_BAR of (a)'s
    one-rank run (``want``), its argument bytes equal to the dry run's 2x1
    cell (``cell``, from ``tp_dry_write``'s subprocess), one counted
    reduction a step (a reduce-scatter over the data group), 22 K5 wgmma
    launches a step at the full heads, K5 held to its plain version, all
    raising at once; and the ones returned, which the caller raises after
    the other parts are logged: the last step's collectives (count and
    result bytes) and FLOPs equal to the cell's, the peak within
    PEAK_RATIO of the cell's. The step walls are logged."""
    from repro_torch.configs import get_config

    c, D = TP_FSDP, TP_M
    arch = get_config(TRAIN_ARCH)
    if cell["status"] != "ok":
        raise AssertionError(f"phase 21 (d): the dry run failed: "
                             f"{cell.get('traceback')}")
    mem, failed = cell["memory"], []
    per = arch.n_layers * c["k"] * c["steps"]
    log(f"  (d) {TRAIN_ARCH} FSDP over data {D} x model 1: full width and "
        f"depth ({arch.n_layers} layers, {arch.dtype}), S {c['S']}, global "
        f"batch {c['B']} in {c['k']} microbatch (one row a rank), "
        f"{c['steps']} steps; (a)'s one-rank losses "
        f"{' '.join(f'{x:.4f}' for x in want)}")
    for r in range(D):
        got = ranks[r]["fsdp"]
        rel = tp_rel(got["losses"], want)
        ratio = mem["total_bytes"] / got["peak"]
        log(f"    rank {r}: losses "
            f"{' '.join(f'{x:.4f}' for x in got['losses'])} (max rel to "
            f"one rank {rel:.3e}, bar {TP_BF16_BAR}); step walls (s) "
            f"{' '.join(f'{w:.4f}' for w in got['walls'])}; "
            f"{got['params']} parameters held (shards); peak "
            f"{got['peak'] / 2 ** 30:.3f} GiB; arguments {got['args']} B, "
            f"the dry run's 2x1 prediction {mem['argument_bytes']} B; "
            f"predicted peak {mem['total_bytes']} B (temp "
            f"{mem['temp_bytes']}), ratio {ratio:.4f} (bar {PEAK_RATIO})")
        log(f"    rank {r}: launches {got['launches']} (K5 at {got['k5_shape']};"
            f" expected {per} wgmma); counted reductions "
            f"{got['reductions']}; the last step's FLOPs {got['flops']:.0f} "
            f"(the dry run's 2x1 rank {cell['per_device']['flops_macs']:.0f})"
            f" and collectives by axis, count and result bytes "
            f"{got['collectives']} (the dry run's "
            f"{cell['collectives_by_axis']}); K5 against its plain version "
            f"on layer 0's q/k/v max_abs_err {got['k5_err']:.3e} (rtol 2^-7, "
            f"atol 4e-3)")
        if got["lost"] or got["events"] or rel > TP_BF16_BAR \
                or not all(math.isfinite(x) for x in got["losses"]):
            raise AssertionError(f"phase 21 (d) rank {r}: {got}")
        if got["launches"]["flash_attention"] != per \
                or got["launches"]["k5 wgmma"] != per \
                or got["launches"]["k5 simt"] != 0 \
                or got["k5_shape"][0][1] != arch.n_heads \
                or not got["k5_ok"]:
            raise AssertionError(f"phase 21 (d) rank {r}: K5 "
                                 f"{got['launches']} {got['k5_shape']}")
        # a step: the one gradient reduce-scatter, the clip's norm, the
        # weights gathered a layer each and once for the rest, the whole
        # leaves' gradients gathered once
        step = {"reduce-scatter": 1, "all-reduce": 1,
                "all-gather": c["k"] * (arch.n_layers + 1) + 1}
        if got["reductions"] != c["steps"] \
                or tp_counts(got["collectives"]["data"]) != step \
                or got["collectives"]["model"]:
            raise AssertionError(f"phase 21 (d) rank {r}: reductions "
                                 f"{got['reductions']}, collectives "
                                 f"{got['collectives']}, want {step}")
        if got["args"] != mem["argument_bytes"]:
            raise AssertionError(f"phase 21 (d) rank {r}: argument bytes "
                                 f"{got['args']} != {mem['argument_bytes']}")
        failed += [f"(d) rank {r}: {x}" for x in tp_held_to_dry(got, cell)]
        if not PEAK_RATIO[0] <= ratio <= PEAK_RATIO[1]:
            failed.append(f"(d) rank {r}: peak ratio {ratio}")
    return failed


def main() -> int:
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print("chip_smoke.py: run it from the root of a checkout "
              "(src/repro_torch not found)", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: torch.cuda.is_available() is False; this "
              "script needs an NVIDIA card", file=sys.stderr)
        return 1
    sys.path.insert(0, SRC)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"card: {torch.cuda.get_device_name(0)}; {smi}; "
        f"count {torch.cuda.device_count()}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    tp_dry_start()
    try:
        return run_phases(smi)
    except BaseException:
        log_timeline()              # how far the run got, and when
        raise


def run_phases(smi: str) -> int:
    """Every phase in order (see the module docstring), then the kernels'
    line, the card's line and the device line."""
    import torch
    rows = phase_kernels()
    launches, rows["sa_inner"]["device_ms"] = phase_main_path()
    torch.cuda.empty_cache()
    phase_f64()
    svm_rows, svm_launches = phase_svm()
    torch.cuda.empty_cache()
    phase_url()
    torch.cuda.empty_cache()
    phase_f64_sparse()
    torch.cuda.empty_cache()
    family_rows = phase_families()
    torch.cuda.empty_cache()
    phase_families_f64()
    torch.cuda.empty_cache()
    phase_sharded_nccl()
    torch.cuda.empty_cache()
    phase_sharded_gloo()
    torch.cuda.empty_cache()
    tuner = phase_tuner(smi)
    torch.cuda.empty_cache()
    phase_contracts(smi, tuner)
    torch.cuda.empty_cache()
    phase_attention_kernel()
    arch, model = llama_model()
    rows["flash_attention"], fa_launches = phase_prefill(arch, model)
    phase_serve(arch, model)
    del model
    torch.cuda.empty_cache()
    phase_f32_lm()
    torch.cuda.empty_cache()
    window_row = phase_moe()
    torch.cuda.empty_cache()
    hymba_row = phase_recurrent()
    torch.cuda.empty_cache()
    encdec_rows = phase_encdec()
    torch.cuda.empty_cache()
    dense_rows = phase_dense()
    torch.cuda.empty_cache()
    train_row = phase_training()
    torch.cuda.empty_cache()
    phase_dryrun(smi)
    # the CLI checks (phases 14 (e), 15 (d), 16 (e), 17 (e), 18 (d), 19
    # (d)) run beside phase 21, which times nothing it checks
    launched, cli = launchers_start(), elastic_cli_start()
    try:
        tp_row = phase_tp(smi)
    finally:
        launchers_finish(launched)
        elastic_cli_finish(cli)
    torch.cuda.empty_cache()
    phase_elastic(cli=False)

    rows.update(svm_rows)
    rows.update(family_rows)
    rows["flash_attention"]["launches"] = fa_launches
    rows["flash_attention"].update(train_row)
    rows["flash_attention"].update(tp_row)
    rows["flash_attention"].update(window_row)
    rows["flash_attention"].update(hymba_row)
    for name, n in launches.items():
        rows[name]["launches"] = n
    for name in svm_rows:
        rows[name]["launches"] = svm_launches[name]
    rows.update((row["name"], row) for row in encdec_rows + dense_rows)
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")
    # K5's rows: the wgmma body without ping-pong and the simt body at
    # bf16 (phases 8, 22); the training step, the windowed calls at
    # mixtral's and hymba's shapes, the launches a step on a rank of phase
    # 21's grid
    extra = ("no_pingpong_ms", "simt_ms") + tuple(train_row) \
        + tuple(window_row) + tuple(hymba_row) + tuple(tp_row)
    log_timeline()
    print(json.dumps({"kernels": [{k: r[k] for k in keys + extra if k in r}
                                  for r in rows.values()]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
