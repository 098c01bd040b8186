#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card (an H100).

Phases, one line each (a failed check raises and the script exits
non-zero; nothing falls back to the CPU or to the plain versions):

1. the card: ``nvidia-smi`` name and power limit, torch's device name;
2. build: nvcc compiles every CUDA source of the port (``csrc/*.cu``)
   into its 16 libraries (``build.library_names``), one nvcc a CPU core,
   the slowest first, each library's seconds from its log; the instances
   of the tensor-core kernels, those of their own, the padded ones
   (each kernel's default tile at the widths of ``fa.PADDED_HEAD_DIMS``
   up to 256) and the wide ones (their one tile at 384 and 512) apart
   (K1 in
   ``flash_attention.cu``, at block_q 64 and 128 by block_k 64 and 128 at
   D 128, D 80, D 112 and D 160; K4, K6c and the partials modes K5b and
   K6d in ``paged_prefill.cu``, at every tile: rows 16, 32, 48, 64 and 80
   by keys 64 and 128 at D 128, rows 16, 32 and 64 at D 160; K3, K6a and
   the dense (K2) and partials (K5a over bf16 pools, K6b over int8 pools)
   modes in ``paged_decode.cu``, at key tiles 32 and 64 at D 128 and D
   160, and the dense mode at both at D 80 and D 112) with
   their registers and spills from the
   ``-Xptxas -v`` log, their shared memory and resident blocks per SM, and
   for the decode kernel the clusters of 1, 2, 4 and 8 CTAs the card holds
   at once;
3. K1 ``flash_attention`` against its plain version at the prefill shapes
   of yi-6b (G=8) and deepseek-7b (G=1), at G=3 and G=2 and a few edge
   shapes (S=300, a window, non-causal): bf16 on the tensor-core kernel
   at every tile (``FlashBlocks``' four at D 128; bit-equality with the
   default tile counted), float32 on the SIMT template; each instance's
   registers, local bytes, shared memory and blocks an SM; every tile
   timed at the yi-6b prefill (the sweep), and the default tile's time,
   bound, plain time and the time of torch's SDPA on the same inputs;
4. K2 ``flash_decode`` against its plain version: bf16 on the dense mode
   of ``paged_decode.cu``'s cluster kernel at every cluster size, at the
   yi-6b and deepseek-7b decode shapes, at G=3 and G=40 and at S=1000
   (not a multiple of the 64-key tile), float32 on the SIMT template,
   each launch's kernel checked; NaN in the strips past ``kv_len`` must
   leave the output finite and bit-equal to the zeroed strips' run; a
   ``kv_len == 0`` row must come out exactly 0; its cluster size, time,
   bound, plain time and SDPA's at yi-6b's and deepseek-7b's decode
   shapes, with its time at every cluster size and with every lane
   empty;
5. serve: ``serve_config`` on yi-6b at full width (32 layers, d_model
   4096, random weights from a seed), 8 requests over 4 dense lanes;
   every request must finish with 32 tokens, and the kernels' launch
   counters, zeroed just before, must show K1 once per layer per
   admission (on the tensor-core kernel), K2 once per layer per decode
   step, each launch on the cluster kernel (counted by ``last_kernel``),
   and no K3 or K4;
6. logits: prefill + 4 decode steps at the full config, through the
   kernels and through the plain versions, must agree;
7. K3 ``flash_paged_decode`` against its plain version at the paged
   decode shapes (shuffled pages, table entries past ``kv_len`` on page
   0): bf16 on the cluster kernel of ``paged_decode.cu`` (at every
   cluster size, and with NaN in the slots past ``kv_len`` of the last
   live pages), float32 on the SIMT template; a ``kv_len == 0`` row that
   must come out exactly 0; its cluster size, time, bound, plain time and
   the time of SDPA on the pre-gathered K/V at the yi-6b and the
   deepseek-7b (G = 1) decode shapes, with its time at every cluster size
   and with every lane empty, and the timing method's floor;
8. K4 ``flash_paged_prefill`` likewise at the prefill-chunk shapes (a
   chunk at 0, at 384, starting mid-page, a ragged last chunk): bf16 on
   the tensor-core kernel, float32 on the SIMT template; timed at the
   main path's chunk beside the plain version, SDPA and the bound;
9. paged serve: the same requests through the paged KV pool with chunked
   prefill (chunks of 128, pages of 16); every request must finish with
   32 tokens and the counters must show K4 once per layer per chunk, K3
   once per layer per decode step, and no K1 or K2;
10. paged logits: a 300-token prompt as chunks of 128 (the last ragged)
   + 4 paged decode steps at the full config, kernels against plain;
11. split-KV decode, K5a (phase 1) + K5c (combine) at the phase-7 shapes
   for 2, 3, 8 and 16 splits (16: more splits than a short lane's
   tiles): bf16 on the cluster kernel's partials mode, float32 on the
   SIMT template, each launch's kernel checked; the partials against the
   plain version cut at the kernel's own tiles (rows without a key in a
   split exactly (-1e30, 0, 0)), the merged output against the split and
   the one-pass plain versions (bf16: the merged route, K5c in K5a's
   epilogue, one launch, also bit-equal to standalone K5c over the
   partials of its own launch, every arrival counter 0 after each call);
   ``num_splits=1`` equal to K3 exactly, a ``kv_len == 0`` row exactly 0,
   and a sweep of 2, 4, 8 and 16 splits at the phase-7 timing shape, the
   merged route beside phase 1 + standalone K5c;
12. int8 pages: K6a (decode; bf16 on the cluster kernel, at every
   cluster size and with NaN scales past ``kv_len``), K6b + K5c (split
   decode, 8 splits; bf16 on the cluster kernel's partials mode, its
   partials held to the plain version cut at its own 64-key tiles with
   the pools' scales at 2, 3, 8 and 16 splits, float32 on the SIMT
   template at its 32-key tiles, each launch's kernel checked, NaN scales
   past ``kv_len`` leaving every partial bit-equal; bf16 with K5c in its
   epilogue, held bit-equal to standalone K5c at 2, 3, 8 and 16 splits)
   and K6c (prefill chunk) against their plain versions on pools
   quantized from the phase-7 and phase-8 cases, rows without keys
   exactly 0, with times at the phase-7 and phase-8 timing shapes and
   K6b's split-count sweep, the merged route beside phase 1 + K5c;
13. serves of the phase-5 requests from the paged pool in chunks of 128:
   int8 pages with 8 splits, int8 pages in one pass, and fp pages with 8
   splits; every request must finish with 32 tokens and each serve's
   counters must show its kernels once per layer per chunk or decode
   step (the split serves: K5a or K6b with K5c in the epilogue, all on
   the cluster kernel), and no other kernel (no standalone K5c); every
   arrival counter 0 after each serve; (d) the fp 8-split serve with
   float32 compute and caches at full width, depth cut to 8 layers: a
   float32 query keeps K5a on the SIMT template and standalone K5c, once
   per layer per decode step (the launches of K5c's row);
14. int8 paged logits: phase 10's prompt and decode steps (two in one
   pass, two with 8 splits) over int8 pools, kernels against plain;
15. split prefill/verify, K5b (phase 1) + K5c, against the split plain
   version (partials and output) and the one-pass plain version at the
   verify shapes of yi-6b and deepseek-7b (4 lanes with chunks of 5 and
   an idle lane with no key, which must come out exactly 0) and at the
   phase-8 chunk, for 2, 3 and 8 splits: bf16 on the tensor-core
   kernel's partials mode, its partials against the split plain version
   cut at its own tiles, rows without a key in a split exactly (-1e30,
   0, 0), its output the merged route's (K5c in the epilogue, one
   launch), bit-equal to standalone K5c over its launch's partials at 2,
   3, 8 and 16 splits; a sweep of 2, 4, 8 and 16 splits at both timing
   shapes (``num_splits=1`` is K4's own launch), the merged route beside
   phase 1 + standalone K5c, and SDPA;
16. K6d + K5c, the same over pools quantized from the phase-15 cases:
   bf16 on the same partials mode over int8 pools, held as K5b is;
17. serves of yi-6b at full width from the paged pool in chunks of 128:
   (a) speculative, a self-speculative draft of 16 layers proposing 4
   tokens per tick, verify with 8 splits; (b) the same over int8 pages;
   (c) the prefix cache with a shared 256-token system prompt; (d) (c)
   with the cache off; (e) (a) on an engine built here with a draft of
   all 32 layers, which is the target, so its greedy drafts must be
   accepted (near-ties apart).  Every request must finish with 32 tokens
   and the
   counters must show each serve's kernels exactly (K5b or K6d with K5c
   in the epilogue once per layer per verify, no standalone K5c, every
   arrival counter 0 after the serve; the draft's K1 and K2 once per draft layer
   per draft prefill and decode step, counted here by wrapping the
   draft's methods, the draft's K2 all on the cluster kernel), and (c)
   must save prefill chunks against (d);
18. verify logits: phase 10's prompt, then one speculative verify of 5
   tokens in one pass and with 8 splits, over bf16 and int8 pools,
   kernels against plain, and a one-token verify against the paged
   decode step.
19. K8 ``matmul`` against its plain version: float32 and bfloat16, with
   and without bias, all four epilogues, ragged shapes aligned for TMA
   and not, every instantiated tile, each launch on the kernel
   ``matmul.route`` names (bf16 ``block_m`` 64 and 128 on aligned
   shapes: the wgmma kernel; otherwise ``mma.sync`` at ``block_m`` 32);
   the shared-memory formula of the install-time cost model against the
   kernel's; the wgmma instances' registers, spills, ring stages and
   resident blocks per SM; every bf16 tile timed at yi-6b's MLP
   projection of a 512-token prefill (M=512, K=4096, N=11008), beside
   its bound, its plain version and ``torch.matmul``;
20. K7 ``fdm_stress``, fused and split, against its plain version on a
   ragged 60x50x130 grid and a 256^3 one, over several tiles, and both
   variants timed over those tiles at 256^3 with their bounds;
21. the install path: in a fresh workdir ``register_kernel_regions`` at
   the phase-19 shape and ``run_install_tuning(wall_clock=True)``, whose
   CUDA-event executor times K8 on every candidate tile and K1 on
   ``FlashBlocks``' 4 evaluations (yi-6b's prefill of 512); the
   trajectories, the winners (K1's beside phase 3's sweep) and the record
   file (whose fingerprint must name the card); ``ops.mm`` must then
   launch K8 with the winner's tiles, and a second session on the workdir
   must measure nothing; then Sample 8 at both levels
   (``examples/autotune_fdm_torch.py``'s ``main``).  The launch counters
   are zeroed before this phase and read after it (the ``SsmChunk``
   region, declared beside ``MatmulBlocks``, launches K9 here too; phase
   25 reports it).  Then phase 5's serve with the winners published: all
   its K1 launches at ``FlashBlocks``' tile (``by_tile``);
22. K9 ``selective_scan`` (the time-parallel chunked scan) against its
   plain version: float32 and bfloat16, ragged L and Di, every
   ``SsmChunk`` candidate, with and without the final state, at small
   widths and at falcon-mamba-7b's (Di 8192, N 16, L 512, B 1 and 4);
   the shared-memory formula of the cost model against the kernel's, for
   both input types; the chunk sweep timed at the prefill shape (B 1, L
   512, bf16, with the final state) beside its bound (the largest of the
   byte, float32-operation and exp floors, each printed) and the plain
   version;
23. serve: ``serve_config`` on falcon-mamba-7b at full width (64 Mamba-1
   layers, d_inner 8192, random weights from a seed), phase 5's 8
   requests over 4 dense lanes; every request must finish with 32
   tokens, and the counters must show K9 exactly once per layer per
   admission and no K1-K8;
24. falcon-mamba logits: a 300-token prompt and 4 decode steps at the
   full config, kernels against plain, and ``forward``'s last-position
   logits against prefill's;
25. the ``SsmChunk`` install run: in a fresh workdir at (seq 512, d_inner
   8192, d_state 16), the CUDA-event executor times K9 at the chunks the
   d-spline samples; the trajectory, the fit beside the measured chunks
   and the winner; ``ops.ssm_scan`` must then launch K9 with the
   winner's chunk, and a second session must measure nothing;
26. the gateway: the phase-5 requests through ``serve_config(gateway=
   True)`` at yi-6b's full width, each a TCP client of 127.0.0.1
   streaming SSE frames: (a) phase 9's paged config at the pipeline's
   default knobs (``max_inflight`` 2, ``admit_batch`` 4), (b) the same at
   ``max_inflight`` 1, (c) phase 17a's speculative config.  Every stream
   must end in ``done`` with 32 tokens, the greedy tokens must equal
   phase 9's (a, b) and 17a's (c) serve, and the counters must show
   phase 9's and 17a's kernels exactly (K4 once per layer per chunk and
   K3 once per layer per decode step on their tensor-core and cluster
   kernels; K5b with K5c merged once per layer per verify, the draft's K1
   and K2, no standalone K5c, every arrival counter 0) and nothing else;
   (a) must overlap ticks, (b) none.  (d) phase 9's engine behind a
   queue of 2 under the 8 clients plus one that hangs up after two token
   frames: a 429 served and retried, one cancel, every other stream
   ``done`` with 32 tokens, and the pool exact afterwards (no used page;
   used + free + cached = pages - 1).  Printed for each: tokens/s,
   p50/p99 TTFT, ITL and queue wait, goodput, ticks and overlapped
   ticks, and the loop's host ms a tick in schedule + dispatch, in the
   wait on the tick's CUDA event and in emit;
27. run-time AT: (a) every tile instance of the decode kernel (K3, K6a,
   K2, and K5a and K6b merged at 8 splits, at the phase-7 and phase-4
   shapes) and of the prefill kernel (K4 and K6c at the phase-8 chunk,
   K5b and K6d merged at 8 splits on the verify shape) against plain and
   timed, a table of tile -> ms; (b) phase 9's serve with ``autotune`` in
   a fresh workdir, its launch and tile counters zeroed just before and
   read just after: the ``DecodeBucket`` and ``PrefillBucket`` regions
   measure each candidate once, each measured call waiting for the
   device, every measured candidate's tile launched on its route, and
   commit; printed per region the candidates' costs, the winners and the
   launches by tile; then the same serve in the same workdir must make
   zero measurements (every region warm-loaded, the same winners); greedy
   agreement with phase 9 reported (a tile changes bf16 rounding); (c)
   phase 17a's speculative serve tuned (a ``SpecBucket`` commits),
   ``--kv-dtype auto`` (every ``KVPrecision`` bucket commits; agreements
   and the resolved pool printed) and the gateway tuned (``GatewayPolicy``
   commits after its windows);
28. phi4-mini-3.8b at published widths (32 layers, d_model 3072, 24 q / 8
   kv heads: G 3, D 128; tied embeddings; random bf16 weights from seed
   0), phase 5's requests, 4 lanes, 32 tokens each: (a) dense lanes (K1
   at G 3 and K2); (b) the paged pool in chunks of 128 (K4 at the 48-row
   tile, K3); (c) int8 pages with 8 splits (K6c, K6b with K5c merged);
   (d)-(g) a 16-layer draft proposing 4, verify at 8 splits (K5b with K5c
   merged; int8: K6d), at the default 48 x 128 tile and with the 48 x 64
   tile published.  Each serve's counters by kernel and by tile must
   show exactly its kernels at its tile.  The logits of phases 6, 10, 14
   and 18 at phi4-mini, kernels against plain; then K4 and K6c at its
   chunk of 128 and K5b and K6d merged at its verify shape with 8
   splits, at both 48-row tiles, against plain and timed beside the
   plain version, SDPA and the bound: rows of the kernels line, with
   their launches from (a)-(g) by tile;
29. moonshot-v1-16b-a3b at published widths and depth (48 layers, d_model
   2048, 16 q / 16 kv heads: G 1, D 128; 64 experts top-6 + 2 shared,
   d_ff 1408, capacity factor 1.25; random bf16 weights from seed 0, 57.8
   GB, once every earlier model is freed), phase 5's requests, 4 lanes,
   32 tokens each: (a) dense lanes (K1 once per layer per admission, K2
   once per layer per tick); (b) the paged pool in chunks of 128 (K4 at
   G 1's default tile, K3); (c) int8 pages with 8 splits (K6c, K6b with
   K5c merged); (d) a 24-layer self-draft proposing 4, verify at 8 splits
   (K5b with K5c merged).  Each serve's counters must show exactly its
   kernels; the MoE's routing (pairs routed and dropped, by token count)
   is printed beside it.  The logits of (a)-(d), kernels against plain,
   with the (layer, token, choice) routing decisions that differ between
   the two routes: logits over 5e-2 of their scale pass only when a flip
   is behind them and the first flipped MoE call's input is within 5e-2
   of its own scale; and the kernel run again with the plain run's
   routing replayed, whose logits must be within 5e-2 of plain's.  One
   MoE layer timed at decode (4 lanes) and at a 512-token prefill beside
   its byte floors (every expert read; only the routed ones), with the
   device operations it launches; the peak memory;
30. llama4-scout-17b-a16e cut to 12 of its 48 layers at published widths
   (d_model 5120, 40 q / 8 kv heads: G 5, D 128; 16 experts top-1 + 1
   shared, d_ff 8192; 57.0 GB of random bf16 weights, made once every
   earlier model is freed; the cut printed on its own line): phase 29's
   serves (a)-(d) and (e), the speculative serve over int8 pages, with
   the prefill kernel at G 5's 80-row tile (block_q 16) by 128 keys: K4,
   K6c, K5b and K6d with K5c merged, each counted by tile; phase 29's
   logits, routing flips and replayed routing, the MoE layer and the
   peak memory; then K4, K6c, K5b and K6d at both 80-row tiles against
   plain and timed (rows of the kernels line, as phase 28's);
31. h2o-danube-1.8b whole (24 layers, d_model 2560, 32 q / 8 kv heads: G
   4, D 80, window 4096): K1 at D 80 at its four tiles (a prefill of
   4608 tokens, past the window) and K2 at D 80 at both key tiles (4
   rings of 4096 slots) against plain and timed beside SDPA and the
   bound, each instance's registers and occupancy; a dense serve of 8
   requests whose prompts (4600, 4080, 4090, 4350, 1000, 4070, 4200,
   3000 tokens) wrap the ring at prefill and in decode, 32 new tokens
   each, K1 and K2 counted by tile and by kernel; the logits of a
   4094-token prompt (decode wraps) and a 4200-token one (prefill rolls)
   with 4 decode steps, kernels against plain; and ``--cache paged``
   refused with a ``ValueError`` naming the paged pool;
32. whisper-tiny whole (4 + 4 layers, d_model 384, 6 heads: D 64, G 1),
   through its model entry points, as the JAX package runs it (its
   engine serves no encoder-decoder): K1 over the encoder's 1500 frames
   (not causal), over the decoder's prompt of 224 (causal) and across
   (224 rows over 1500 keys: K1 with a key length of its own), K2 over
   the self cache and the 1500-row cross cache, each against plain and
   timed beside SDPA and the bound, with K2's cluster size; 4 lanes of
   1500 random frame embeddings, prompts of 224 and of 4 tokens, 64
   greedy new tokens each, K1 and K2 counted by call (encoder, self,
   cross); TTFT, tokens/s and ITL; the logits of both prompt lengths
   with 4 decode steps, kernels against plain; peak memory;
33. zamba2-7b whole (81 Mamba-2 layers, d_model 3584, d_inner 7168; a
   shared block of 32 q / 32 kv heads, D 112, window 4096, 13 times):
   K1 at D 112 at its four tiles (a prefill of 4608 tokens, past the
   window) and K2 at D 112 at both key tiles (4 rings of 4096 slots)
   against plain and timed beside SDPA and the bound, each instance's
   registers and occupancy; phase 31's dense serve (its prompts wrap the
   shared block's rings at prefill and in decode), K1 and K2 counted by
   tile and by kernel; the logits of a 4094-token and a 4200-token
   prompt with 4 decode steps, kernels against plain; ``--cache paged``
   refused; peak memory; one decode tick profiled (``profile_decode``,
   4 lanes at prompts of 4093: host and device ms, busy share);
34. pixtral-12b whole (40 layers, d_model 5120, 32 q / 8 kv heads: G 4,
   D 160; 25.6 GB of random bf16 weights from seed 0 with the vision
   stub's ``frontend_proj``; nothing cut), served text-only as the JAX
   engine serves it: phase 28's (a) dense, (b) paged at the D-160
   default tile (block_q 8 x 128 keys), (c) int8 at 8 splits, (c1) int8
   in one pass, (c2) bf16 at 8 splits, (d) speculative and (e)
   speculative over int8 pages (a 20-layer self-draft), each serve's
   kernels counted by tile and the one-pass decode's by cluster size
   (c = 4: one CTA an SM at D 160 and 64 keys); the logits of (a)-(d)
   against plain; (f) the vision prefill: 4 lanes of 1024 seeded patch
   embeddings in front of a 256-token prompt (S' = 1280) through
   ``Model.prefill(frontend_embeds=)``, then 31 greedy ``decode_step``
   calls, K1 and K2 counted, TTFT and ITL, its logits against plain;
   then K1 at its four tiles over (f)'s prefill, K2 at both key tiles
   over its lanes, K3, K6a, K5a and K6b (merged, 8 splits) at both key
   tiles and K4, K6c, K5b and K6d (merged, 8 splits) at every tile of
   the D-160 ladder (block_q 4, 8, 16 by keys 64, 128), against plain and
   timed beside SDPA and the bound, with their launches from the phase;
35. training (``launch/steps.py``'s ``build_train_step``: loss,
   ``torch.autograd.grad``, AdamW): (a) K1's and K9's
   ``torch.autograd.Function``s through ``ops.attention`` and
   ``ops.ssm_scan`` against autograd of their plain versions on the same
   inputs (output and every input gradient within 2e-2 of its scale): K1
   at the trainer's shape (B 2, S 1024, 32 q / 4 kv heads of 128,
   causal), whisper's cross shape (224 x 1500, D 64, G 1) and
   h2o-danube's D 80 with a window, K9 at B 1, L 128, Di 8192, N 16; each
   Function's forward + backward timed (L2 flushed) beside the plain
   route's and, for K1, SDPA's, K9's also as a CUDA graph (captured
   once, replayed) beside the eager time; (b) yi-6b at full width cut
   to 12 of its 32 layers, float32 weights and AdamW moments: 6 steps at
   B 4, S 1024 through the compiled step, as ``launch/train.py`` runs it
   (one CUDA graph captured at the first step, replayed at the others:
   1 capture, 5 replays, 0 recaptures; a falling loss; step time,
   tokens/s, peak memory; K1 through its Function once per layer per
   step; the last step profiled: device time, busy share, the time by
   kind of kernel and the kernels that take most), beside an eager twin
   on the same weights and batches (every step's loss and grad norm
   within 1e-3 relative, the launches equal, the last parameters'
   largest difference beside a second eager run's, the step time, busy
   share, peak and reserved memory of both; the eager one's forward and
   AdamW's update timed alone), then single steps from the same weights
   and batch through the plain route, and 2 microbatches and remat
   ``full`` (3 steps, each graphed beside its eager twin), each held to
   the kernel route's first step: loss and global grad norm within 1e-3
   relative, and the grad norms of the sequence mixer's leaves
   (attention's wq/wk/wv/wo) and of layer 0's leaves within 1e-2 (peak
   memory beside the first run's); (b2) falcon-mamba-7b at full width
   cut to 4 of its 64 layers: 3 steps at B 1, S 512 graphed beside
   eager (K9 through its Function once per layer per step) and a
   plain-route step, held so (the mixer: the scan's leaves); (c) the
   guard: a paged decode whose q requires grad raises under
   ``torch.enable_grad()`` and launches nothing; (d) one train step
   graphed (2 steps: the second a replay) against eager, loss and grad
   norm within 1e-3 relative, for each family (b) and (b2) do not
   train, at published widths: moonshot-v1-16b-a3b cut to 2 of 48
   layers (MoE), zamba2-7b to 6 of 81 (the shared block once),
   pixtral-12b to 2 of 40 (1024 patches in front), h2o-danube-1.8b to 2
   of 24, whisper-tiny whole (llama4-scout is left out: one of its
   layers is ~36 GB of float32 state; moonshot covers MoE);
36. static AT (``tuning/static.py``, ``launch/analytic.py``, the H100 rows
   of ``core/cost.py``): (a) the card's row read by its name (an unknown
   card fails) beside ``nvidia-smi``'s name and power limit;
   ``analytic_plan_cost`` of every candidate plan of every applicable
   cell at that row, ``tune_all_layouts`` in a temporary record store
   (each winner the argmin), and a second ``AutoTuner`` on the store
   reading every winner back without tuning; (b) ``train(...,
   autotune=True)`` in a temporary working directory: yi-6b at full
   width cut to 2 of 32 layers, B 2 x S 1024, 2 steps, the layout plan
   ``tp``, the loss finite (falling or reported), K1 through
   ``FlashAttentionFn`` once per layer per step and no other kernel, the
   compiled step captured once and replayed once;
   (c) ``step_for_shape``'s prefill (S 1024, B 4) and decode steps at
   yi-6b's full width cut to 2 layers (K1 once per layer, K2 once per
   layer a step, counted) against the same steps with
   ``use_kernel=False``; (d) K1 against the chunked plain version
   (``ref.chunked_attention``, the plain route above 2048 queries) at
   yi-6b's train_4k length, B 1, S 4096, 32 q / 4 kv heads of 128, bf16,
   causal and with a window of 1024, each timed beside SDPA and the
   bound; (e) phase 35's train step's share of the card's bf16 peak:
   ``model_flops`` (6 N D) over its measured step time, beside the
   analytic count's and the analytic roofline bound of the step;
37. tensor-parallel paged serving (``ServingEngine(mesh=...)`` over
   ``torch.distributed``): a 1x2 world spawned by ``run_world``, both
   ranks on the one card over gloo (NCCL refuses two ranks on one
   device; what gloo cannot carry is staged through the host), each
   holding yi-6b at full width, depth cut to 8 of its 32 layers
   (``MESH_LAYERS``; the same seeded weights, checked by a checksum
   all-reduce) and its half of the KV heads, serving phase 9's
   requests: (a) the paged pool without chunks (K1 prefill, K3), (b)
   chunks of 128 (K4, K3), (c) int8 pages at 8 splits (K6c, K6b with
   K5c merged), (d) speculative at 8 splits (K5b with K5c merged; the
   draft replicated); rank 0 serves each unsharded first, in the same
   phase: greedy tokens equal, each admission's first logits bit-equal
   (or within 5e-2 of their scale), each rank's launches by kernel
   exactly its serve's, pools half the unsharded bytes; (e) two prompts
   of 4096 tokens whose prefill takes the ring (float32), held to the
   unsharded K1 prefill within 5e-2 of the logits' scale, the token
   agreement printed, and one ring attention timed beside K1; (f)
   ``compressed_psum`` of CUDA tensors against the exact sum; (g)
   ``"1x1"`` in a NCCL world of one rank, (b)'s tokens.  Printed:
   tokens/s, TTFT and ITL against the unsharded serve, launches per rank,
   pool bytes, the bytes staged through the host and the host ms in the
   collectives, peak memory a rank.  Two ranks share one card: no time
   here is a multi-card speed;
38. the layout tooling: (a) phase 26a's gateway serve, yi-6b at full
   width cut to 8 of 32 layers as in phase 37, through ``serve
   --gateway --mesh 1x2`` (two ranks on the one card over gloo; rank 0's
   gateway broadcasts each tick's admissions, rank 1 follows): greedy
   tokens equal to rank 0's unsharded gateway serve in the phase, each
   admission's first logits bit-equal to it (or within 5e-2 of their
   scale), each rank's K4 and K3 launches equal to it and to each other,
   tokens/s, TTFT, ITL and the loop's host ms a tick beside the
   unsharded gateway's; (b) the same with ``--autotune``
   (``GatewayPolicy`` windows of one request), twice in one workdir: the
   warm run measures nothing and both ranks hold rank 0's winners, and
   is held to rank 0's unsharded gateway serve over the same records (a
   tuner of the mesh's region names binding no mesh, which warm-loads
   the same winners: the same tiles and splits) exactly: every greedy
   token, every first logit bit for bit, the launches; its agreement
   with the untuned unsharded serve (other tiles, other rounding) is
   printed; (c)
   ``dryrun_cell`` (fake tensors over fake worlds of 256 and 512 ranks,
   on the host's CPU) for yi-6b decode_32k (all 32 layers; its per-rank
   FLOPs within 10% of ``step_costs``' share) and train_4k
   (depth cut to 2 layers) on 16x16 and 2x16x16 at full width: per-rank
   dot FLOPs against ``step_costs``' over the ranks, bytes a rank,
   collective bytes by kind, seconds a cell; (d) ``tune_layout`` for
   yi-6b train_4k with ``compiled_plan_cost`` (at 2 layers), beside the
   analytic winner, read back warm, the bound of (c)'s plan equal to
   (c)'s.  (c) and (d) need no device: each runs in a process of its
   own (one core each), both started before phase 37.
39. every head dim and group size the Pallas attention kernels take: K1-K6d
   against plain at D 24, 36, 37, 80, 90, 96, 100, 112, 160 and 256 (28 q
   / 4 kv heads: G 7; 37 and 90 give bf16 and int8 rows that are no
   multiple of 4 bytes), bf16 on the tensor cores and float32 on the SIMT
   templates, each launch on its route and on the instance ``fa.route``
   (``pa.prefill_route`` for a prefill) names (the head dim's own, or the
   padded one of the smallest width of ``fa.PADDED_HEAD_DIMS`` at or
   above it), and the prefill kernel's flattened (position, head) rows,
   on the padded instances, at G 3 and 5 (D 160), 7 (D 128), 9 (D 64) and
   96; D 520 (above the limit) refused; (d) the padded instances, forced
   by the private
   ``fa._forced_width``, bit-equal to the head dims' own (K1, K2,
   K3 and K5a, K4 and K5b; bf16 and float32); (a) float32 serves of 4
   requests: h2o-danube-1.8b whole at D 80 on dense lanes, zamba2-7b cut
   to 13 layers (the shared block twice) at D 112, pixtral-12b cut to 10
   of 40 layers at D 160 dense, paged, at 8 splits, over int8 pages in
   one pass and at 8 splits, and speculative over fp and int8 pages, all
   on the SIMT templates, logits within 1e-3 of their scale of plain;
   (b) yi-6b's widths cut to 8 layers at d_head 96, 256 and 100 (a bf16
   row of 200 bytes: 4-byte copies), dense, paged, int8 at 8 splits and
   speculative on the padded instances, logits, and K1, K2, K3 and K4 at
   D 96 and 256 timed beside plain, SDPA and the bound; (c) Qwen2-7B's
   28 q / 4 kv heads (G 7, D 128) and 24 / 8 (G 3) at D 160 on yi-6b's
   widths, paged, int8 at 8 splits and speculative over fp and int8
   pages on the flattened rows, logits, and K4, K6c, K5b and K6d at G 7
   timed.
40. head dims above 256, on the wide instances (384 and 512: a 16-row
   slab served by one warp per 128 columns, ``csrc/common.cuh``): K1-K6d
   against plain at D 264, 300, 384 and 512, bf16 and float32 (28 q / 4
   kv heads, the prefill on the flattened rows), each launch on the wide
   instance ``fa.route`` names; the wide rung forced at D 128 and 256
   against the head dims' own instances (within the type's tolerance:
   the slices' partial sums change the order); (a) yi-6b's widths at
   d_head 512, all 32 layers (9.7 B parameters), dense and paged serves;
   (b) the same cut to 8 layers: bf16 pages at 8 splits, int8 pages in
   one pass and at 8 splits, speculative over bf16 and int8 pages; (c)
   float32 at d_head 512, 8 layers, on the SIMT templates; (d) d_head 300
   (a bf16 row of 600 bytes: 4-byte copies); (e) Qwen2-7B's 28 q / 4 kv
   heads at d_head 384 on the flattened rows; logits of each against
   plain; (f) K1's autograd Function at D 512 against the plain
   autograd; K1-K6d at D 512 timed beside plain, SDPA and the bound.

Phases 5, 9, 13a-c, 17a-b and 26a serve graphed (the engine's compiled
steps, CUDA graphs replayed: ``serving/compiled.py``) and then eager on
the same weights (the decode through ``decode_fn=``, the chunk, verify
and draft decode through the engine's step attributes): every greedy
token, the first logits (each admission's and the first decode tick's)
bit for bit or within 5e-2 of their scale, and every launch count equal;
each prints both serves' tokens/s, p50 TTFT and ITL, captures, replays
and peak memory.  Every other serve runs graphed, as the engine does by
default; phases 37-38's sharded engines keep eager steps.

Then the script's run time by group of phases, one JSON line with every
kernel's numbers,
and as the last line
``{"ok": true, "device": {...}}``.  Exits 2 without printing a result
when no CUDA device is present.

Usage::

    python3 chip_smoke.py
"""
from __future__ import annotations

import asyncio
import collections
import contextlib
import dataclasses
import functools
import gc
import importlib.util
import io
import json
import math
import re
import subprocess
import sys
import tempfile
import time
from collections.abc import Callable
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import repro_torch.at as at  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.distributed import (collectives, compressed_psum,  # noqa: E402
                                     run_world)
from repro_torch.distributed.compression import quantize_int8_rows  # noqa: E402
from repro_torch.distributed.sharding import make_serving_mesh  # noqa: E402
from repro_torch.kernels import build, ref  # noqa: E402
from repro_torch.kernels import fdm_stress as fk  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import matmul as mmk  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.kernels import ssm_scan as k9  # noqa: E402
from repro_torch.kernels import autograd as ag  # noqa: E402
from repro_torch.kernels.autograd import (FlashAttentionFn,  # noqa: E402
                                          SelectiveScanFn)
from repro_torch.data import DataConfig, batch_for_step  # noqa: E402
from repro_torch.launch.steps import (build_eval_loss,  # noqa: E402
                                      build_train_step)
from repro_torch.models import LayoutPlan  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
import repro_torch.launch.serve as serve_mod  # noqa: E402
from repro_torch.launch.serve import (ServeConfig, draw_prompts,  # noqa: E402
                                      serve_config, serve_engine)
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import moe, transformer  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.serving import Request, ServingEngine  # noqa: E402
from repro_torch.serving import compiled  # noqa: E402
from repro_torch.serving.compiled import (CompiledStep,  # noqa: E402
                                         compile_step)
from repro_torch.serving.kvcache import tree_leaves  # noqa: E402
from repro_torch.serving.gateway import (GatewayPolicyKnobs,  # noqa: E402
                                         GatewayServer, PipelinedEngine,
                                         sse_generate)
from repro_torch.core.fitting import fit_dspline  # noqa: E402
from repro_torch.tuning import (register_kernel_regions,  # noqa: E402
                                run_install_tuning)
from repro_torch.tuning.install import CHUNK_VALUES  # noqa: E402
from repro_torch.configs import ShapeConfig, all_cells, get_shape  # noqa: E402
from repro_torch.core import cost  # noqa: E402
from repro_torch.launch.analytic import model_flops, step_costs  # noqa: E402
from repro_torch.launch.steps import step_for_shape  # noqa: E402
from repro_torch.launch.train import train  # noqa: E402
from repro_torch.tuning import (analytic_plan_cost,  # noqa: E402
                                candidate_plans, tune_all_layouts)

# published peaks of one H100 SXM (NVIDIA data sheet, dense): the least
# time a kernel could take is the larger of bytes / HBM rate and
# operations / peak rate for the operands' type
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-4}   # rtol = atol
SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
PAGED_SOURCE = "src/repro_torch/kernels/csrc/paged_attention.cu"
PREFILL_SOURCE = "src/repro_torch/kernels/csrc/paged_prefill.cu"
DECODE_SOURCE = "src/repro_torch/kernels/csrc/paged_decode.cu"
TC_KERNEL = pa.TC_KERNEL
KERNELS = fa.KERNELS + pa.KERNELS + mmk.KERNELS + fk.KERNELS + k9.KERNELS
FLASH = "src/repro/kernels/flash_attention.py"
BF16 = torch.bfloat16
SERVE = dict(arch="yi-6b", reduced=False, n_requests=8, n_lanes=4,
             max_len=1024, prompt_len=512, max_new=32, device="cuda")


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def randn(shape, seed: int, dtype) -> torch.Tensor:
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def compare(got: torch.Tensor, want: torch.Tensor, dtype) -> float:
    """Max abs error; raises unless |got - want| <= tol + tol * |want|."""
    torch.cuda.synchronize()
    got, want = got.float(), want.float()
    check(bool(torch.isfinite(got).all()), "kernel output is not finite")
    err = (got - want).abs()
    tol = TOL[dtype]
    check(bool((err <= tol + tol * want.abs()).all()),
          f"max abs err {float(err.max()):.3e} over tolerance {tol}")
    return float(err.max())


def time_ms(fn, iters: int = 20) -> tuple[float, float]:
    """(device ms, call ms) of one call of ``fn``, means over ``iters``.

    Device ms: CUDA events around each launch, all enqueued behind a spin
    kernel so the host's launch overhead is not in the interval, and each
    after a 64 MiB write that evicts the 50 MB L2 (on the main path a
    layer's KV cache is cold: it is not read again until the next step).
    Call ms: host clock around back-to-back calls ending in a sync, i.e.
    what a caller waits per call, wrapper overhead included."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    marks = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    torch.cuda._sleep(100_000_000)      # ~50 ms of spinning at ~2 GHz
    for start, end in marks:
        flush.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    device = sum(s.elapsed_time(e) for s, e in marks) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return device, (time.perf_counter() - t0) * 1e3 / iters


def bound(n_bytes: float, n_ops: float, dtype) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_OPS_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------


def phase_card() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi)
    name = torch.cuda.get_device_name(0)
    print(f"[1 card] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {name!r} count {torch.cuda.device_count()} "
          f"capability {torch.cuda.get_device_capability(0)}")
    return smi


def phase_build() -> None:
    t0 = time.perf_counter()
    paths = build.build_all()
    for lib_part in ("", build.PADDED, build.WIDE):
        fa._lib(lib_part)
        pa._lib(lib_part)
        pa._tc_lib(lib_part)
        pa._dec_lib(lib_part)
    pa._tc_lib(build.INT8_POOLS)
    mmk._lib()
    fk._lib()
    k9._lib()
    dt = time.perf_counter() - t0
    print(f"[2 build] {len(paths)} libraries built and loaded in {dt:.1f}s: "
          + ", ".join(p.name for p in paths.values()))
    for p in paths.values():
        log = p.with_suffix(".log")
        if log.exists():
            text = log.read_text()
            regs = [int(r) for r in re.findall(r"Used (\d+) registers", text)]
            spills = [int(r) for r in
                      re.findall(r"(\d+) bytes spill stores", text)]
            secs = re.match(r"nvcc seconds: ([\d.]+)", text)
            print(f"    ptxas {p.name}: "
                  + (f"nvcc {secs.group(1)} s, " if secs else "")
                  + f"{len(regs)} kernels, registers "
                  f"max {max(regs, default=0)}, spill stores "
                  f"{sum(spills)} bytes in {sum(1 for x in spills if x)} "
                  f"kernels (full report in {log.name})")
    # instances of their own (19, 76, 39, as before the padded ones),
    # padded ones (pad=1: 6 widths; the prefill kernel's 4 kinds and the
    # decode kernel's 5 modes at each) and wide ones (the 2 rungs above
    # 256, one tile each)
    for source, kernel, pattern, info, n in (
            ("flash_attention", fa.TC_KERNEL,
             r"ILi(?P<d>\d+)ELi(?P<bq>\d+)ELi(?P<bk>\d+)ELb(?P<pad>[01])EE",
             lambda d, kind, t: fa.tc_info(d, t["bq"], t["bk"],
                                           dp=d * t["pad"]), (19, 6, 2)),
            ("paged_prefill", TC_KERNEL,
             r"I(?:13__nv_bfloat16|(?P<int8>a))Li(?P<d>\d+)ELb(?P<split>[01])"
             r"ELi(?P<slabs>\d)ELi(?P<bk>\d+)ELb(?P<pad>[01])EE",
             lambda d, kind, t: pa.tc_info(d, kind, 64, rows=16 * t["slabs"],
                                           block_k=t["bk"], dp=d * t["pad"]),
             (76, 24, 8)),
            ("paged_decode", pa.DECODE_TC_KERNEL,
             r"I(?:13__nv_bfloat16|(?P<int8>a))Li(?P<d>\d+)ELi(?P<mode>\d)"
             r"ELi(?P<bk>\d+)ELb(?P<pad>[01])EE",
             lambda d, kind, t: pa.decode_tc_info(d, kind, 64,
                                                  block_k=t["bk"],
                                                  dp=d * t["pad"]),
             (39, 30, 10))):
        logs = [paths[name].with_suffix(".log")
                for name in (source, source + build.PADDED,
                             source + build.WIDE,
                             *(source + p for p in build.OWN_PARTS.get(
                                 source, ())))]
        if not all(log.exists() for log in logs):
            continue
        lines, pads, wides = [], [], []
        for kind, d, regs, spill, tile in tc_instances(
                "".join(log.read_text() for log in logs), kernel, pattern):
            card = info(d, kind, tile)
            shape = "".join(f" {k}={v}" for k, v in tile.items()
                            if k != "pad")
            out = (lines if not tile.get("pad") else
                   wides if d in fa.WIDE_HEAD_DIMS else pads)
            out.append(f"{kind + ' ' if kind else ''}D={d}{shape}: {regs} "
                         f"registers, {spill} B spill stores, "
                         f"{card['smem_bytes']} B shared"
                         + (" at 64 table entries" if kind
                            and kind != "bf16 dense" else "")
                         + f", {card['blocks_per_sm']} block(s)/SM"
                         + (f", clusters of c held at once (c: n) "
                            f"{card['clusters']}" if "clusters" in card
                            else ""))
        check((len(lines), len(pads), len(wides)) == n,
              f"{len(lines)} {kernel} instances of their own, "
              f"{len(pads)} padded and {len(wides)} wide in the ptxas log, "
              f"expected {n}")
        print(f"    {kernel} instances (ptxas -v and the card's "
              f"occupancy): " + "; ".join(lines))
        print(f"    {kernel} padded instances (width D): " + "; ".join(pads))
        print(f"    {kernel} wide instances (width D, the head dim across "
              f"D / 128 warps): " + "; ".join(wides))


def tc_instances(log: str, kernel: str,
                 pattern: str) -> list[tuple[str, int, int, int, dict]]:
    """(kind, D, registers, spill-store bytes, tile) of every instance of
    a tensor-core kernel in an ``-Xptxas -v`` log.  ``pattern`` matches the
    template arguments of its mangled name: the head dim ``d`` and, for
    the paged kernels, ``int8`` pools and the ``split`` flag (prefill) or
    the ``mode`` (decode: paged, dense, partials), whose kind is then one
    of ``pa.TC_KINDS`` (prefill) or ``pa.DECODE_KINDS`` (decode), and the
    tile: ``slabs`` (16-row slabs of the query tile) or ``bq`` (K1's
    query rows) and ``bk`` (keys); K1's kind is empty."""
    out = []
    for chunk in log.split("Compiling entry function")[1:]:
        m = re.search(kernel + pattern, chunk.split("\n", 1)[0])
        if not m:
            continue
        regs = re.search(r"Used (\d+) registers", chunk)
        spill = re.search(r"(\d+) bytes spill stores", chunk)
        args = m.groupdict()
        if "mode" in args:          # the decode kernel: paged, dense, split
            kind = ("int8" if args["int8"] else "bf16") + (
                "", " dense", " split")[int(args["mode"])]
        else:
            kind = ("" if "int8" not in args else
                    ("int8" if args["int8"] else "bf16")
                    + (" split" if args.get("split") == "1" else ""))
        tile = {k: int(args[k]) for k in ("slabs", "bq", "bk", "pad")
                if args.get(k)}
        out.append((kind, int(args["d"]), int(regs.group(1)) if regs else -1,
                    int(spill.group(1)) if spill else 0, tile))
    return out


def phase_k1() -> tuple[dict, dict]:
    """K1 against plain at every instance on phase 3's cases (the D = 128
    bf16 cases at each of the four tiles, bit-equality with the default
    tile reported), each instance's registers, spills and blocks an SM,
    and the tile sweep at the yi-6b prefill.  Returns the default tile's
    row and the sweep {tile: device ms}."""
    # (label, B, H, Hkv, S, D, dtype, causal, window)
    cases = [("yi-6b prefill (G=8)", 1, 32, 4, 512, 128, BF16, True, None),
             ("deepseek-7b prefill (G=1)", 1, 32, 32, 512, 128, BF16, True,
              None),
             ("G=3 (24 q / 8 kv heads)", 1, 24, 8, 512, 128, BF16, True, None),
             ("S=300", 1, 32, 4, 300, 128, BF16, True, None),
             ("window=64", 1, 32, 4, 512, 128, BF16, True, 64),
             ("non-causal", 1, 32, 4, 512, 128, BF16, False, None),
             ("G=2 D=64 S=200 non-causal window=32", 2, 8, 4, 200, 64, BF16,
              False, 32),
             ("fp32 reduced", 2, 4, 2, 100, 16, torch.float32, True, None)]
    errs, same = [], 0
    for i, (label, b, h, hkv, s, d, dtype, causal, window) in enumerate(cases):
        q = randn((b, h, s, d), 10 * i, dtype)
        k = randn((b, hkv, s, d), 10 * i + 1, dtype)
        v = randn((b, hkv, s, d), 10 * i + 2, dtype)
        kw = dict(causal=causal, window=window)
        want = ref.attention_ref(q, k, v, **kw)
        default = fa.flash_attention(q, k, v, **kw)
        cells = []
        for tile in fa.attention_tiles(dtype, d):
            n = fa.flash_attention.by_tile[tile]
            got = fa.flash_attention(q, k, v, **kw, block_q=tile[0],
                                     block_k=tile[1])
            err = compare(got, want, dtype)
            check(fa.flash_attention.last_kernel
                  == (fa.TC_KERNEL if dtype == BF16
                      else "flash_attention_kernel")
                  and fa.flash_attention.by_tile[tile] == n + 1,
                  f"K1 {label} {tile}: launched "
                  f"{fa.flash_attention.last_kernel}")
            equal = bool(torch.equal(got, default))
            same += equal
            cells.append(f"{tile[0]}x{tile[1]} {err:.2e}"
                         + ("" if equal else " (not bit-equal to 64x64)"))
        errs.append(f"{label} " + ", ".join(cells))
    print(f"[3 K1 flash_attention] max abs err vs plain by tile (block_q x "
          f"block_k; tol bf16 {TOL[BF16]}, fp32 {TOL[torch.float32]}; bf16 "
          f"on {fa.TC_KERNEL}, fp32 on the SIMT template; {same} launches "
          f"bit-equal to the default tile's): " + "; ".join(errs))
    infos = []
    for d in fa.DENSE_HEAD_DIMS:
        for tile in fa.attention_tiles(BF16, d):
            info = fa.tc_info(d, *tile)
            check(info["smem_bytes"] == fa.smem_bytes(*tile, d),
                  f"K1 D={d} {tile}: shared memory {info['smem_bytes']}, "
                  f"the formula says {fa.smem_bytes(*tile, d)}")
            check(d not in fa.TILED_HEAD_DIMS or info["local_bytes"] == 0,
                  f"K1 D={d} {tile} spills {info['local_bytes']} bytes")
            infos.append(f"D={d} {tile[0]}x{tile[1]}: {info['registers']} "
                         f"registers, {info['local_bytes']} B local, "
                         f"{info['smem_bytes']} B shared, "
                         f"{info['blocks_per_sm']} block(s)/SM")
    print("[3 K1 flash_attention] instances on the card: " + "; ".join(infos))

    # timing at the main path's shape: a yi-6b prefill of 512 tokens
    b, h, hkv, s, d = 1, 32, 4, 512, 128
    q, k, v = (randn((b, n, s, d), 90 + j, BF16)
               for j, n in enumerate((h, hkv, hkv)))
    err = compare(fa.flash_attention(q, k, v), ref.attention_ref(q, k, v), BF16)
    pairs = s * (s + 1) // 2                      # causal (q, k) pairs
    n_bytes = 2 * (q.numel() + k.numel() + v.numel() + q.numel())
    bound_ms, bound_by = bound(n_bytes, 4 * b * h * pairs * d, BF16)
    sweep = {tile: time_ms(lambda: fa.flash_attention(
        q, k, v, block_q=tile[0], block_k=tile[1]))[0]
        for tile in fa.attention_tiles(BF16, d)}
    times = {
        "ms": time_ms(lambda: fa.flash_attention(q, k, v)),
        "plain_ms": time_ms(lambda: ref.attention_ref(q, k, v)),
        "library_ms": time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True))}
    print(f"[3 K1 flash_attention] tile sweep at the yi-6b prefill, device "
          f"ms (block_q x block_k -> ms): "
          + ", ".join(f"{t[0]}x{t[1]} {ms:.4f}" for t, ms in sweep.items())
          + f"; fastest {min(sweep, key=sweep.get)}; SDPA "
          f"{times['library_ms'][0]:.4f}, bound {bound_ms:.5f} ms")
    print(f"[3 K1 flash_attention] yi-6b prefill B=1 H=32 Hkv=4 S=512 D=128 "
          f"bf16 causal on {fa.TC_KERNEL}, device ms (ms per call incl. "
          f"host): "
          + ", ".join(f"{k} {d:.4f} ({c:.4f})" for k, (d, c) in times.items())
          + f", bound {bound_ms:.4f} ms ({bound_by})")
    return {"name": "flash_attention", "route": "cuda", "source": SOURCE,
            "replaces": "src/repro/kernels/flash_attention.py:106",
            "max_abs_err": err, "bound_ms": bound_ms, "bound_by": bound_by,
            **{k: d for k, (d, _) in times.items()}}, sweep


def phase_k2() -> dict:
    """K2: bf16 on the dense mode of ``paged_decode.cu``'s cluster kernel
    at every cluster size, float32 on the SIMT template; NaN past kv_len;
    a ``kv_len == 0`` row; the timing shape's times, the empty-lanes
    fixed cost and the cluster-size sweep at yi-6b's and deepseek-7b's
    kv heads."""
    # (label, B, H, Hkv, S, D, kv_len): S = 1000 is not a multiple of the
    # 64-key tile
    cases = [("yi-6b decode", 4, 32, 4, 1024, 128, [1024, 517, 33, 300]),
             ("deepseek-7b decode", 4, 32, 32, 1024, 128, [700, 1024, 16, 1]),
             ("G=3 S=1000", 4, 24, 8, 1000, 128, [1000, 517, 33, 999]),
             ("G=40 D=64 S=1000", 2, 40, 1, 1000, 64, [1000, 77])]
    errs = []
    for i, (label, b, h, hkv, s, d, kv_len) in enumerate(cases):
        q = randn((b, h, 1, d), 100 + 10 * i, BF16)
        k = randn((b, hkv, s, d), 101 + 10 * i, BF16)
        v = randn((b, hkv, s, d), 102 + 10 * i, BF16)
        lens = torch.tensor(kv_len, dtype=torch.int32, device="cuda")
        want = ref.decode_ref(q, k, v, lens)
        by_c = []
        for c in pa.CLUSTER_SIZES:
            err = compare(fa.flash_decode(q, k, v, lens, _cluster=c), want,
                          BF16)
            check(fa.flash_decode.last_kernel == pa.DECODE_TC_KERNEL,
                  f"K2 {label} c={c} ran {fa.flash_decode.last_kernel}")
            by_c.append(f"c={c} {err:.2e}")
        errs.append(f"{label} " + ", ".join(by_c))
    q, k, v = (randn((2, n, m, 16), 140 + j, torch.float32)
               for j, (n, m) in enumerate(((4, 1), (2, 64), (2, 64))))
    lens = torch.tensor([61, 7], dtype=torch.int32, device="cuda")
    err = compare(fa.flash_decode(q, k, v, lens),
                  ref.decode_ref(q, k, v, lens), torch.float32)
    check(fa.flash_decode.last_kernel == fa.DECODE_SIMT_KERNEL,
          f"K2 fp32 ran {fa.flash_decode.last_kernel}")
    errs.append(f"fp32 reduced {err:.2e} ({fa.DECODE_SIMT_KERNEL})")
    # NaN in every strip row past kv_len: finite, bit-equal to the run on
    # the strips with those rows zeroed
    kv_len = [1000, 517, 33, 300]
    q = randn((4, 32, 1, 128), 150, BF16)
    kv = [randn((4, 4, 1000, 128), 151 + j, BF16) for j in range(2)]
    lens = torch.tensor(kv_len, dtype=torch.int32, device="cuda")
    dirty, zeroed = [t.clone() for t in kv], [t.clone() for t in kv]
    for i, n in enumerate(kv_len):
        for t, z in zip(dirty, zeroed):
            t[i, :, n:] = float("nan")
            z[i, :, n:] = 0
    got = fa.flash_decode(q, *dirty, lens)
    clean = fa.flash_decode(q, *zeroed, lens)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got).all()), "K2: NaN past kv_len reached the "
          "output")
    check(torch.equal(got, clean), "K2: the rows past kv_len changed the "
          "output")
    err = compare(got, ref.decode_ref(q, *zeroed, lens), BF16)
    errs.append(f"NaN past kv_len (S=1000): finite, equal to the zeroed "
                f"strips' run, {err:.2e} vs plain")
    # a row with kv_len == 0 is exactly 0 (the plain version gives the
    # mean of v there, so that row is checked on its own)
    q = randn((2, 32, 1, 128), 140, BF16)
    k = randn((2, 4, 256, 128), 141, BF16)
    kv_len = torch.tensor([0, 77], dtype=torch.int32, device="cuda")
    out = fa.flash_decode(q, k, k, kv_len)
    torch.cuda.synchronize()
    check(bool((out[0] == 0).all()), "kv_len == 0 row is not exactly 0")
    compare(out[1:], ref.decode_ref(q, k, k, kv_len)[1:], BF16)
    errs.append("kv_len==0 row exactly 0")
    print(f"[4 K2 flash_decode] max abs err vs plain (tol bf16 {TOL[BF16]}, "
          f"fp32 {TOL[torch.float32]}; bf16 on {pa.DECODE_TC_KERNEL}'s "
          f"dense mode by cluster size): " + "; ".join(errs))

    # timing at the main path's shape: yi-6b, 4 lanes, max_len 1024; then
    # deepseek-7b's kv heads (G = 1) on the same lanes
    b, h, s, d = 4, 32, 1024, 128
    gen = torch.Generator(device="cuda").manual_seed(153)
    kv_len = torch.randint(1, s + 1, (b,), generator=gen, device="cuda",
                           dtype=torch.int32)
    mask = (torch.arange(s, device="cuda")[None, :]
            < kv_len[:, None])[:, None, None, :]
    rows = {}
    for label, hkv, seed in (("yi-6b", 4, 150), ("deepseek-7b", 32, 160)):
        q = randn((b, h, 1, d), seed, BF16)
        k = randn((b, hkv, s, d), seed + 1, BF16)
        v = randn((b, hkv, s, d), seed + 2, BF16)
        err = compare(fa.flash_decode(q, k, v, kv_len),
                      ref.decode_ref(q, k, v, kv_len), BF16)
        keys = int(kv_len.sum())
        n_bytes = 2 * (2 * keys * hkv * d + 2 * b * h * d) + 4 * b
        bound_ms, bound_by = bound(n_bytes, 4 * h * keys * d, BF16)
        times = {
            "ms": time_ms(lambda: fa.flash_decode(q, k, v, kv_len)),
            "plain_ms": time_ms(lambda: ref.decode_ref(q, k, v, kv_len)),
            "library_ms": time_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    q, k, v, attn_mask=mask, enable_gqa=True))}
        c = pa.cluster_size(b, hkv, pa.sm_count(0))
        by_c = {n: time_ms(lambda: fa.flash_decode(q, k, v, kv_len,
                                                   _cluster=n))[0]
                for n in pa.CLUSTER_SIZES}
        idle = torch.zeros_like(kv_len)
        empty = time_ms(lambda: fa.flash_decode(q, k, v, idle))[0]
        print(f"[4 K2 flash_decode] {label} decode B=4 H=32 Hkv={hkv} S=1024 "
              f"D=128 bf16 kv_len={kv_len.tolist()}, "
              f"{fa.flash_decode.last_kernel} in clusters of c={c} "
              f"({b * hkv * c} CTAs), device ms (ms per call incl. host): "
              + ", ".join(f"{k} {dev:.4f} ({call:.4f})"
                          for k, (dev, call) in times.items())
              + f", bound {bound_ms:.5f} ms ({bound_by}); by cluster size "
              + ", ".join(f"c={n} {t:.4f}" for n, t in by_c.items())
              + f"; every lane empty (kv_len 0) {empty:.4f}")
        rows[label] = {"name": "flash_decode", "route": "cuda",
                       "source": DECODE_SOURCE,
                       "replaces": "src/repro/kernels/flash_attention.py:203",
                       "max_abs_err": err, "bound_ms": bound_ms,
                       "bound_by": bound_by,
                       **{k: d for k, (d, _) in times.items()}}
    return rows["yi-6b"]


class _RouteCount:
    """A kernel wrapper that also counts, by ``last_kernel``, the kernels
    its calls launch.  Every other attribute is the wrapper's own: the
    wrapper's body names itself (``paged_decode_split.launches += 1``),
    and while this stands in its module's global, those updates must
    still reach the wrapper."""

    def __init__(self, fn, tally: collections.Counter):
        object.__setattr__(self, "_fn", fn)
        object.__setattr__(self, "_tally", tally)

    def __call__(self, *args, **kw):
        out = self._fn(*args, **kw)
        self._tally[self._fn.last_kernel] += 1
        return out

    def __getattr__(self, name):
        return getattr(self._fn, name)

    def __setattr__(self, name, value):
        setattr(self._fn, name, value)


@contextlib.contextmanager
def replayed(tally: collections.Counter):
    """While the block runs, a compiled step's replay adds to ``tally``
    what its capture counted there (``compiled.EXTRA_TALLIES``): a count
    taken by a Python wrapper reads as if every step ran eagerly."""
    compiled.EXTRA_TALLIES.append(tally)
    try:
        yield tally
    finally:
        compiled.EXTRA_TALLIES.remove(tally)


@contextlib.contextmanager
def kernels_by_route(module, name: str):
    """Count, by ``last_kernel``, the kernels that the wrapper
    ``module.name`` launches while the block runs: the serving path looks
    the wrapper up there at each call (``ops.flash_decode``,
    ``pa.paged_decode_split``), so every launch passes through the count
    (a replay's through :func:`replayed`)."""
    fn = getattr(module, name)
    tally = collections.Counter()
    setattr(module, name, _RouteCount(fn, tally))
    try:
        with replayed(tally):
            yield tally
    finally:
        setattr(module, name, fn)


@contextlib.contextmanager
def clusters_used():
    """Count, by cluster size, the bf16 one-pass decode launches (K3, K6a,
    K2) while the block runs: the wrappers ask ``pa.decode_cluster`` for
    their cluster size at each launch."""
    fn = pa.decode_cluster
    tally = collections.Counter()

    def counted(*args, **kw):
        c = fn(*args, **kw)
        tally[c] += 1
        return c

    pa.decode_cluster = counted
    try:
        with replayed(tally):
            yield tally
    finally:
        pa.decode_cluster = fn


def serve_with_counts(engine: ServingEngine | None = None,
                      **kw) -> tuple[dict, dict[str, int]]:
    """One run of the phase-5 requests, through ``serve_config`` or on
    ``engine`` when one is given, with every kernel's launch counter
    zeroed just before and read just after."""
    for kernel in KERNELS:
        kernel.launches = 0
    fa.flash_attention.last_kernel = fa.flash_decode.last_kernel = None
    for kernel in pa.KERNELS:
        if kernel is not pa.split_combine:    # one kernel: no route to name
            kernel.last_kernel = None
    scfg = ServeConfig(**{**SERVE, **kw})
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.memory_allocated()
    report = (serve_config(scfg) if engine is None
              else serve_engine(engine, scfg))
    torch.cuda.synchronize()
    report["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    report["peak_over_start_gb"] = (torch.cuda.max_memory_allocated()
                                    - start) / 1e9
    launches = {k.__name__: k.launches for k in KERNELS}
    n_requests, max_new = SERVE["n_requests"], SERVE["max_new"]
    check(report["finished"] == n_requests,
          f"{report['finished']}/{n_requests} requests finished")
    check(all(len(t) == max_new for t in report["outputs"].values()),
          "a request did not get its 32 tokens")
    return report, launches


#: the steps an engine compiles beside its decode (``decode_fn=``)
STEP_ATTRS = ("_prefill_step", "_verify", "_draft_decode")
AB_TOL = 5e-2        # the serves' logits bound (phases 6, 10, 14, 18)


def eager_engine(model, params, **kw) -> ServingEngine:
    """The engine ``serve_config`` builds for phase 5's requests with
    ``kw`` (untuned), on ``model`` and ``params`` (the same seed's
    weights), its steps eager: the decode through ``decode_fn=``, the
    prompt chunk, the verify and the draft's decode through the engine's
    step attributes (each compiled step's ``fn``)."""
    scfg = ServeConfig(**{**SERVE, **kw})
    paged = scfg.cache == "paged"
    splits = scfg.num_splits if paged else None
    extra = {}
    if scfg.draft:
        draft = model.draft_model()
        extra = dict(draft_model=draft, spec_k=scfg.spec_k,
                     draft_params=model.slice_draft_params(params, draft))
    engine = ServingEngine(
        model, params, n_lanes=scfg.n_lanes, max_len=scfg.max_len,
        cache=scfg.cache, n_pages=scfg.n_pages, page_size=scfg.page_size,
        timeslice=scfg.timeslice, prefill_chunk=scfg.prefill_chunk,
        prefix_cache=scfg.prefix_cache, kv_dtype=scfg.kv_dtype,
        num_splits=splits,
        decode_fn=(functools.partial(model.paged_decode_step,
                                     num_splits=splits)
                   if paged else model.decode_step), **extra)
    for name in STEP_ATTRS:
        step = getattr(engine, name, None)
        if isinstance(step, CompiledStep):
            setattr(engine, name, step.fn)
    return engine


@contextlib.contextmanager
def first_logits_and_tick():
    """While open, every engine records each admission's first logits by
    prompt (:func:`first_logits_by_prompt`) and, under ``"tick"``, the
    logits of the first decode tick it emits."""
    inner = ServingEngine.emit

    def emit(self, work):
        if work is not None and "tick" not in firsts:
            firsts["tick"] = work.logits.float().cpu()
        return inner(self, work)

    with first_logits_by_prompt() as firsts:
        ServingEngine.emit = emit
        try:
            yield firsts
        finally:
            ServingEngine.emit = inner


def serve_ab_line(label: str, report: dict) -> str:
    g = report["graphs"]
    return (f"{label} {report['tokens_per_s']:.1f} tok/s, p50 ttft "
            f"{report['p50_ttft_s']:.4f}s, p50 itl {report['p50_itl_s']:.4f}s,"
            f" wall {report['wall_s']:.3f}s, captures {g['captures']}, replays "
            f"{g['replays']}, recaptures {g['recaptures']}, graphs by step "
            f"{g['graphs']}, peak {report['peak_gb']:.2f} GB "
            f"({report['peak_over_start_gb']:.2f} over the serve's start)")


def graph_ab(what: str, graphed: tuple, eager: tuple) -> str:
    """The graphed serve (report, launches, first logits) against the
    eager one of the same requests on the same weights: every greedy
    token equal, the same launches, the first logits (each admission's and
    the first decode tick's) bit-equal or within ``AB_TOL`` of their scale;
    returns the line that reports both."""
    (g, g_launches, g_firsts), (e, e_launches, e_firsts) = graphed, eager
    check(g["graphs"]["replays"] > 0 and e["graphs"]["captures"] == 0,
          f"{what}: graphed {g['graphs']}, eager {e['graphs']}")
    check(g["outputs"] == e["outputs"],
          f"{what}: graphed greedy tokens {greedy_agreement(g, e)} equal to "
          "the eager serve's")
    check(g_launches == e_launches,
          f"{what}: launches graphed {g_launches}, eager {e_launches}")
    check(g_firsts.keys() == e_firsts.keys(),
          f"{what}: first logits of {len(g_firsts)} and {len(e_firsts)}")
    logits = first_logits(g_firsts, e_firsts)
    if logits["bit_equal"] < logits["n"]:
        check(logits["worst_rel"] <= AB_TOL,
              f"{what}: graphed first logits {logits} against eager's")
    return (f"{what}: " + serve_ab_line("graphed", g) + "; "
            + serve_ab_line("eager", e) + f"; greedy tokens "
            f"{greedy_agreement(g, e)} equal, first logits "
            f"{logits['bit_equal']}/{logits['n']} bit-equal (worst "
            f"{logits['worst_rel']:.3g} of scale), launches equal")


def eager_twin(what: str, graphed: tuple, model, params,
               run: Callable = serve_with_counts,
               probe: Callable = first_logits_and_tick, **kw) -> str:
    """Serve ``kw`` again on :func:`eager_engine` through ``run`` (which
    takes the engine and ``kw`` and returns the report and the launches
    first), its first logits recorded by ``probe`` as the graphed serve's
    were, and hold the graphed serve ``graphed`` to it
    (:func:`graph_ab`)."""
    with probe() as firsts:
        report, launches, *_ = run(engine=eager_engine(model, params, **kw),
                                   **kw)
    return graph_ab(what, graphed, (report, launches, firsts))


def phase_serve(smi: str, model, params) -> tuple[dict, dict[str, int]]:
    n_layers, n_requests = 32, SERVE["n_requests"]
    with kernels_by_route(ops, "flash_decode") as k2_routes, \
            first_logits_and_tick() as firsts:
        report, launches = serve_with_counts()
    check(all(launches[k.__name__] == 0 for k in pa.KERNELS),
          f"the dense serve launched paged kernels: {launches}")
    check(launches["flash_attention"] == n_layers * n_requests,
          f"K1 launched {launches['flash_attention']} times, expected "
          f"{n_layers * n_requests} (one per layer per admission)")
    check(fa.flash_attention.last_kernel == fa.TC_KERNEL,
          f"the dense serve's K1 ran {fa.flash_attention.last_kernel}")
    check(launches["flash_decode"] == n_layers * report["decode_steps"],
          f"K2 launched {launches['flash_decode']} times, expected "
          f"{n_layers} x {report['decode_steps']} decode steps")
    check(dict(k2_routes) == {pa.DECODE_TC_KERNEL: launches["flash_decode"]},
          f"the dense serve's K2 launches by kernel: {dict(k2_routes)}")
    print(f"[5 serve] yi-6b full (32 layers, d_model 4096): "
          f"{report['finished']}/{n_requests} requests, "
          f"{report['generated_tokens']} tokens in {report['wall_s']:.3f}s = "
          f"{report['tokens_per_s']:.1f} tok/s, p50 ttft "
          f"{report['p50_ttft_s']:.4f}s, p50 itl {report['p50_itl_s']:.4f}s, "
          f"{report['decode_steps']} decode steps, launches {launches}, "
          f"K2 launches by kernel {dict(k2_routes)}, on {smi}")
    print("[5 graphed against eager] " + eager_twin(
        "phase 5", (report, launches, firsts), model, params))
    return report, launches


def dense_logits(model, params, plen: int = 128, max_len: int = 256
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Prefill + 4 decode steps of one prompt of ``plen`` tokens at the
    full config, through the plain versions and then through the kernels,
    fed the same tokens; returns the (plain, kernel) logits of every
    step."""
    cfg = model.cfg
    gen = torch.Generator(device="cuda").manual_seed(7)
    prompt = torch.randint(0, cfg.vocab_size, (1, plen), generator=gen,
                           device="cuda")
    tokens: list[int] = []
    runs = {}
    for use_kernel in (False, True):
        logits, caches = model.prefill(params, prompt, max_len,
                                       use_kernel=use_kernel)
        steps = [logits]
        for i in range(4):
            if not use_kernel:
                tokens.append(int(steps[-1][0].argmax()))
            token = torch.tensor([[tokens[i]]], device="cuda")
            pos = torch.tensor([prompt.shape[1] + i], device="cuda")
            logits, caches = model.decode_step(params, caches, token, pos,
                                               use_kernel=use_kernel)
            steps.append(logits)
        runs[use_kernel] = torch.stack(steps)
    torch.cuda.synchronize()
    return runs[False], runs[True]


def phase_logits(model, params, tag: str = "[6 logits] yi-6b full") -> None:
    plain, kern = dense_logits(model, params)
    print(f"{tag}, prefill 128 + 4 decode steps: "
          + check_logits(plain, kern, model.cfg.padded_vocab, "logits"))


def paged_case(b, h, hkv, d, psz, nblk, kv_len, dtype, seed, c=1):
    """q (B, H, c, D), bf16/fp32 pools of B * nblk pages plus the null
    page, a table of shuffled distinct pages whose entries past kv_len
    point at page 0, and kv_len (B,) int32."""
    n_pages = b * nblk + 1
    q = randn((b, h, c, d), seed, dtype)
    kp = randn((n_pages, hkv, psz, d), seed + 1, dtype)
    vp = randn((n_pages, hkv, psz, d), seed + 2, dtype)
    gen = torch.Generator(device="cuda").manual_seed(seed + 3)
    table = (torch.randperm(n_pages - 1, generator=gen, device="cuda") + 1)
    table = table.reshape(b, nblk).to(torch.int32)
    lens = torch.tensor(kv_len, dtype=torch.int32, device="cuda")
    live = torch.arange(nblk, device="cuda")[None, :] * psz < lens[:, None]
    table = torch.where(live, table, 0).to(torch.int32).contiguous()
    return q, kp, vp, table, lens


def decode_pools(kp, vp, quant: bool):
    """The pools (and scales) a one-pass decode reads, and its wrapper."""
    if quant:
        (k8, ks), (v8, vs) = quantize_int8_rows(kp), quantize_int8_rows(vp)
        return (k8, v8, ks, vs), pa.flash_paged_decode_quant
    return (kp, vp), pa.flash_paged_decode


def plain_decode(q, pools, table, lens) -> torch.Tensor:
    k, v, *scales = pools
    ks, vs = scales if scales else (None, None)
    return ref.paged_decode_ref(q, k, v, table, lens, k_scale=ks, v_scale=vs)


def nan_past_kv_len(pools, table, kv_len, psz):
    """Copies of ``pools`` (codes and scales, or bf16 pools) with the slots
    past kv_len of each lane's last live page set to NaN (int8 codes:
    127), and with them set to 0."""
    dirty = [t.clone() for t in pools]
    zeroed = [t.clone() for t in pools]
    for i, n in enumerate(kv_len):
        if n % psz:
            page = int(table[i, n // psz])
            for t, z in zip(dirty, zeroed):
                t[page, :, n % psz:] = (127 if t.dtype == torch.int8
                                        else float("nan"))
                z[page, :, n % psz:] = 0
    return dirty, zeroed


def tc_decode_checks(quant: bool) -> str:
    """The bf16 decode kernel (K3, or K6a with ``quant``) at the yi-6b
    decode case against plain for every cluster size, and with NaN (int8:
    codes 127, NaN scales) in the slots past kv_len of each lane's last
    live page: finite, equal to its run on the pools with those slots
    zeroed, within tolerance of plain there."""
    kv_len, psz = [1024, 517, 33, 300], 16
    q, kp, vp, table, lens = paged_case(4, 32, 4, 128, psz, 64, kv_len, BF16,
                                        260)
    pools, kernel = decode_pools(kp, vp, quant)
    want = plain_decode(q, pools, table, lens)
    errs = []
    for c in pa.CLUSTER_SIZES:
        got = kernel(q, *pools, table, lens, _cluster=c)
        check(kernel.last_kernel == pa.DECODE_TC_KERNEL,
              f"{kernel.__name__} c={c} ran {kernel.last_kernel}")
        errs.append(f"c={c} {compare(got, want, BF16):.2e}")
    dirty, zeroed = nan_past_kv_len(pools, table, kv_len, psz)
    got = kernel(q, *dirty, table, lens)
    clean = kernel(q, *zeroed, table, lens)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got).all()),
          f"{kernel.__name__}: NaN past kv_len reached the output")
    check(torch.equal(got, clean), f"{kernel.__name__}: the slots past "
          "kv_len changed the output")
    err = compare(got, plain_decode(q, zeroed, table, lens), BF16)
    return ("; ".join(errs) + f"; NaN past kv_len in the last live pages: "
            f"finite, equal to the zeroed pools' run, {err:.2e} vs plain")


def phase_k3() -> dict:
    # (label, B, H, Hkv, D, psz, nblk, kv_len, dtype)
    cases = [("yi-6b paged decode", 4, 32, 4, 128, 16, 64,
              [1024, 517, 33, 300], BF16),
             ("deepseek-7b paged decode", 4, 32, 32, 128, 16, 64,
              [700, 1024, 16, 1], BF16),
             ("fp32 reduced", 2, 4, 2, 16, 8, 8, [61, 7], torch.float32)]
    errs = []
    for i, (label, b, h, hkv, d, psz, nblk, kv_len, dtype) in enumerate(cases):
        q, kp, vp, table, lens = paged_case(b, h, hkv, d, psz, nblk, kv_len,
                                            dtype, 200 + 10 * i)
        err = compare(pa.flash_paged_decode(q, kp, vp, table, lens),
                      ref.paged_decode_ref(q, kp, vp, table, lens), dtype)
        kernel = pa.flash_paged_decode.last_kernel
        check(kernel == (pa.DECODE_TC_KERNEL if dtype == BF16
                         else pa.DECODE_SIMT_KERNEL),
              f"K3 {label} ran {kernel}")
        errs.append(f"{label} {err:.2e} ({kernel})")
    q, kp, vp, table, lens = paged_case(2, 32, 4, 128, 16, 8, [0, 77], BF16,
                                        240)
    out = pa.flash_paged_decode(q, kp, vp, table, lens)
    torch.cuda.synchronize()
    check(bool((out[0] == 0).all()), "K3: kv_len == 0 row is not exactly 0")
    compare(out[1:], ref.paged_decode_ref(q, kp, vp, table, lens)[1:], BF16)
    errs.append("kv_len==0 row exactly 0")
    errs.append("yi-6b by cluster size " + tc_decode_checks(False))
    print(f"[7 K3 flash_paged_decode] max abs err vs plain (tol bf16 "
          f"{TOL[BF16]}, fp32 {TOL[torch.float32]}): " + "; ".join(errs))

    # timing at the main path's shape: yi-6b, 4 lanes of max_len 1024 in
    # pages of 16 (the pool of the paged serve phase); then deepseek-7b's
    # kv heads (G = 1) on the same lanes
    rows = {}
    for label, hkv, seed in (("yi-6b", 4, 250), ("deepseek-7b", 32, 270)):
        b, h, d, psz, nblk = 4, 32, 128, 16, 64
        kv_len = [839, 720, 190, 544]
        q, kp, vp, table, lens = paged_case(b, h, hkv, d, psz, nblk, kv_len,
                                            BF16, seed)
        err = compare(pa.flash_paged_decode(q, kp, vp, table, lens),
                      ref.paged_decode_ref(q, kp, vp, table, lens), BF16)
        keys = sum(kv_len)
        bound_ms, bound_by = bound(
            decode_bytes(kv_len, b, h, hkv, d, psz, 2, 2),
            4 * h * keys * d, BF16)
        k_dense = ref.gather_pages(kp, table)          # gathered once, untimed
        v_dense = ref.gather_pages(vp, table)
        mask = (torch.arange(nblk * psz, device="cuda")[None, :]
                < lens[:, None])[:, None, None, :]
        times = {
            "ms": time_ms(lambda: pa.flash_paged_decode(q, kp, vp, table,
                                                        lens)),
            "plain_ms": time_ms(
                lambda: ref.paged_decode_ref(q, kp, vp, table, lens)),
            "library_ms": time_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    q, k_dense, v_dense, attn_mask=mask, enable_gqa=True))}
        c = pa.cluster_size(b, hkv, pa.sm_count(0))
        # the same lanes at every cluster size, and with every lane empty
        # (the kernel's fixed cost: launch, setup, merges, cluster barriers)
        by_c = {n: time_ms(lambda: pa.flash_paged_decode(
            q, kp, vp, table, lens, _cluster=n))[0] for n in pa.CLUSTER_SIZES}
        idle = torch.zeros_like(lens)
        empty = time_ms(lambda: pa.flash_paged_decode(q, kp, vp, table,
                                                      idle))[0]
        print(f"[7 K3 flash_paged_decode] {label} B=4 H=32 Hkv={hkv} D=128 "
              f"psz=16 nblk=64 bf16 kv_len={kv_len}, "
              f"{pa.flash_paged_decode.last_kernel} in clusters of c={c} "
              f"({b * hkv * c} CTAs), device ms (ms per call incl. host): "
              + ", ".join(f"{k} {dev:.4f} ({call:.4f})"
                          for k, (dev, call) in times.items())
              + f", bound {bound_ms:.5f} ms ({bound_by}); library = SDPA "
              f"with a kv_len mask on the pre-gathered dense K/V (gather "
              f"not timed); by cluster size "
              + ", ".join(f"c={n} {t:.4f}" for n, t in by_c.items())
              + f"; every lane empty (kv_len 0) {empty:.4f}")
        rows[label] = {"name": "flash_paged_decode", "route": "cuda",
                       "source": DECODE_SOURCE,
                       "replaces": f"{FLASH}:491",
                       "max_abs_err": err, "bound_ms": bound_ms,
                       "bound_by": bound_by,
                       **{k: d for k, (d, _) in times.items()}}
    one = torch.zeros(1, device="cuda")
    print(f"[7 K3 flash_paged_decode] the timing method's floor, a "
          f"one-element add: {time_ms(lambda: one.add_(1))[0]:.4f} ms")
    return rows["yi-6b"]


def phase_k4() -> dict:
    # (label, H, Hkv, D, psz, C, start, valid rows, dtype): sequence 0 has
    # the chunk at ``start``; sequence 1 a full chunk at 0
    cases = [("yi-6b chunk at 0", 32, 4, 128, 16, 128, 0, 128, BF16),
             ("yi-6b chunk at 384", 32, 4, 128, 16, 128, 384, 128, BF16),
             ("mid-page start 200", 32, 4, 128, 16, 128, 200, 128, BF16),
             ("ragged last chunk", 32, 4, 128, 16, 128, 256, 44, BF16),
             ("deepseek-7b chunk", 32, 32, 128, 16, 128, 256, 128, BF16),
             ("fp32 reduced", 4, 2, 16, 8, 8, 12, 5, torch.float32)]
    errs = []
    for i, (label, h, hkv, d, psz, c, start, valid, dtype) in enumerate(cases):
        nblk = -(-(start + c) // psz)
        q, kp, vp, table, lens = paged_case(2, h, hkv, d, psz, nblk,
                                            [start + valid, c], dtype,
                                            300 + 10 * i, c=c)
        starts = torch.tensor([start, 0], dtype=torch.int32, device="cuda")
        got = pa.flash_paged_prefill(q, kp, vp, table, starts, lens)
        check(pa.flash_paged_prefill.last_kernel
              == (TC_KERNEL if dtype == BF16 else "paged_prefill_kernel"),
              f"K4 {label}: launched {pa.flash_paged_prefill.last_kernel}")
        want = ref.paged_prefill_ref(q, kp, vp, table, starts, lens)
        # rows at positions >= kv_len are padding: not compared
        err = max(compare(got[:1, :, :valid], want[:1, :, :valid], dtype),
                  compare(got[1:], want[1:], dtype))
        errs.append(f"{label} {err:.2e}")
    q, kp, vp, table, lens = paged_case(2, 32, 4, 128, 16, 2, [0, 20], BF16,
                                        370, c=8)
    starts = torch.tensor([0, 12], dtype=torch.int32, device="cuda")
    out = pa.flash_paged_prefill(q, kp, vp, table, starts, lens)
    torch.cuda.synchronize()
    check(bool((out[0] == 0).all()), "K4: rows with no key are not exactly 0")
    compare(out[1:], ref.paged_prefill_ref(q, kp, vp, table, starts,
                                           lens)[1:], BF16)
    errs.append("kv_len==0 rows exactly 0")
    print(f"[8 K4 flash_paged_prefill] max abs err vs plain (tol bf16 "
          f"{TOL[BF16]}, fp32 {TOL[torch.float32]}): " + "; ".join(errs))

    # timing at the main path's shape: a yi-6b chunk of 128 at start 384
    # (kv_len 512) in pages of 16
    h, hkv, d, psz, c, start = 32, 4, 128, 16, 128, 384
    kv = start + c
    q, kp, vp, table, lens = paged_case(1, h, hkv, d, psz, kv // psz, [kv],
                                        BF16, 380, c=c)
    starts = torch.tensor([start], dtype=torch.int32, device="cuda")
    err = compare(pa.flash_paged_prefill(q, kp, vp, table, starts, lens),
                  ref.paged_prefill_ref(q, kp, vp, table, starts, lens), BF16)
    pairs = sum(start + i + 1 for i in range(c))   # causal (q, k) pairs
    n_bytes = 2 * (2 * q.numel() + 2 * kv * hkv * d) + 4 * (kv // psz + 2)
    bound_ms, bound_by = bound(n_bytes, 4 * h * pairs * d, BF16)
    k_dense = ref.gather_pages(kp, table)          # gathered once, untimed
    v_dense = ref.gather_pages(vp, table)
    causal = (torch.arange(kv, device="cuda")[None, :]
              <= start + torch.arange(c, device="cuda")[:, None])
    times = {
        "ms": time_ms(lambda: pa.flash_paged_prefill(q, kp, vp, table, starts,
                                                     lens)),
        "plain_ms": time_ms(lambda: ref.paged_prefill_ref(q, kp, vp, table,
                                                          starts, lens)),
        "library_ms": time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k_dense, v_dense, attn_mask=causal, enable_gqa=True))}
    print(f"[8 K4 flash_paged_prefill] yi-6b B=1 H=32 Hkv=4 C=128 D=128 "
          f"psz=16 bf16 start=384 kv_len=512 ({pairs} causal pairs per "
          f"head, 32-row query tiles), device ms (ms "
          f"per call incl. host): "
          + ", ".join(f"{k} {d:.4f} ({c:.4f})" for k, (d, c) in times.items())
          + f", bound {bound_ms:.5f} ms ({bound_by}); library = SDPA with "
          f"the causal mask on the pre-gathered dense K/V (gather not timed)")
    return {"name": "flash_paged_prefill", "route": "cuda",
            "source": PREFILL_SOURCE,
            "replaces": "src/repro/kernels/flash_attention.py:668",
            "max_abs_err": err, "bound_ms": bound_ms, "bound_by": bound_by,
            **{k: d for k, (d, _) in times.items()}}


def greedy_agreement(report: dict, other: dict) -> str:
    """Tokens equal position by position to another serve's, as a count."""
    same = sum(a == b for rid, toks in report["outputs"].items()
               for a, b in zip(toks, other["outputs"][rid]))
    return f"{same}/{sum(len(t) for t in report['outputs'].values())}"


def only_launched(launches: dict[str, int], kernels, what: str) -> None:
    """Every kernel outside ``kernels`` was launched no time."""
    names = {k.__name__ for k in kernels}
    stray = {k: n for k, n in launches.items() if n and k not in names}
    check(not stray, f"{what} launched other kernels: {stray}")


PAGED = dict(cache="paged", page_size=16, prefill_chunk=128)


def phase_paged_serve(smi: str, dense: dict, model, params
                      ) -> tuple[dict, dict[str, int]]:
    n_layers = 32
    with first_logits_and_tick() as firsts:
        report, launches = serve_with_counts(**PAGED)
    check(launches["flash_paged_prefill"] == n_layers * report["prefill_chunks"],
          f"K4 launched {launches['flash_paged_prefill']} times, expected "
          f"{n_layers} x {report['prefill_chunks']} prefill chunks")
    check(launches["flash_paged_decode"] == n_layers * report["decode_steps"],
          f"K3 launched {launches['flash_paged_decode']} times, expected "
          f"{n_layers} x {report['decode_steps']} decode steps")
    only_launched(launches, (pa.flash_paged_prefill, pa.flash_paged_decode),
                  "the paged serve")
    check(pa.flash_paged_prefill.last_kernel == TC_KERNEL,
          f"the paged serve's K4 ran {pa.flash_paged_prefill.last_kernel}")
    check(pa.flash_paged_decode.last_kernel == pa.DECODE_TC_KERNEL,
          f"the paged serve's K3 ran {pa.flash_paged_decode.last_kernel}")
    check(report["cache"]["n_pages"] == 257, "default pool is not 257 pages")
    print(f"[9 paged serve] yi-6b full, pages of 16 (257), chunks of 128: "
          f"{report['finished']}/{SERVE['n_requests']} requests, "
          f"{report['generated_tokens']} tokens in {report['wall_s']:.3f}s = "
          f"{report['tokens_per_s']:.1f} tok/s, p50 ttft "
          f"{report['p50_ttft_s']:.4f}s, p50 itl {report['p50_itl_s']:.4f}s, "
          f"{report['prefill_chunks']} prefill chunks, "
          f"{report['decode_steps']} decode steps, preemptions "
          f"{report['preemptions']}, launches {launches}, kv "
          f"{json.dumps(report['cache'])}; greedy tokens equal to the dense "
          f"serve's (reported only: bf16 sums differ in order) "
          f"{greedy_agreement(report, dense)}, on {smi}")
    print("[9 graphed against eager] " + eager_twin(
        "phase 9", (report, launches, firsts), model, params, **PAGED))
    return report, launches


def paged_logits(model, params, quantized: bool = False,
                 splits=(None,) * 4) -> tuple[torch.Tensor, torch.Tensor]:
    """A 300-token prompt as chunks of 128 (the last one ragged, its
    padded positions past the table's last block) and one paged decode
    step per entry of ``splits`` (its ``num_splits``) at the full config,
    through the kernels and through the plain versions, fed the same
    tokens; returns the (plain, kernel) logits of every step."""
    cfg = model.cfg
    psz, c, plen, max_len = 16, 128, 300, 320
    nblk = max_len // psz
    gen = torch.Generator(device="cuda").manual_seed(8)
    prompt = torch.randint(0, cfg.vocab_size, (1, plen), generator=gen,
                           device="cuda")
    table = (torch.randperm(nblk, generator=gen, device="cuda") + 1)
    table = table.to(torch.int32)[None]
    dev = lambda *x: torch.tensor(x, device="cuda")  # noqa: E731
    tokens: list[int] = []
    runs = {}
    for use_kernel in (False, True):
        caches = model.init_paged_caches(nblk + 1, psz, device="cuda",
                                         quantized=quantized)
        steps = []
        for start in range(0, plen, c):
            end = min(start + c, plen)
            chunk = torch.zeros((1, c), dtype=torch.long, device="cuda")
            chunk[0, :end - start] = prompt[0, start:end]
            logits, caches = model.paged_prefill_step(
                params, caches, table, chunk, dev(start), dev(end),
                dev(end - start - 1), use_kernel=use_kernel)
            steps.append(logits)
        for i, ns in enumerate(splits):
            if not use_kernel:
                tokens.append(int(steps[-1][0].argmax()))
            logits, caches = model.paged_decode_step(
                params, caches, table, dev([tokens[i]]), dev(plen + i),
                use_kernel=use_kernel, num_splits=ns)
            steps.append(logits)
        runs[use_kernel] = torch.stack(steps)
    torch.cuda.synchronize()
    return runs[False], runs[True]


def check_logits(plain: torch.Tensor, kern: torch.Tensor, vocab: int,
                 what: str, rel: float = 5e-2) -> str:
    """Kernel against plain logits of the same steps (phases 6, 10, 14,
    18).

    Tolerance: both paths take the same bf16 inputs (int8 pages: the same
    codes and scales) and round the attention output to bf16.  The plain
    versions compute in float32; the kernels sum in float32 too, but the
    tensor-core kernels (K1, K4, K5b and K6c with a bf16 query) also
    round P (for int8 pages P times the value scale) to bf16 before P.V,
    which moves an output by at most 2^-8 (bf16's unit roundoff) of the
    largest |v|.  So they
    differ by about an ulp of bf16 (2^-8 relative) per attention output
    element, and 32 layers of bf16 matmuls carry that into the logits.
    The check allows 5e-2 of the logits' own scale (their max magnitude;
    ``rel`` another share: phase 39's float32 runs, 1e-3), and reports the
    argmax agreement beside it."""
    check(tuple(kern.shape) == (plain.shape[0], 1, vocab), f"{what} shape")
    check(bool(torch.isfinite(kern).all() and torch.isfinite(plain).all()),
          f"{what} are not finite")
    scale = float(plain.abs().max())
    err = float((kern - plain).abs().max())
    agree = int((kern.argmax(-1) == plain.argmax(-1)).sum())
    check(err <= rel * scale,
          f"{what} differ by {err:.3e}, over {rel} x scale {scale:.3e}")
    return (f"kernels vs plain max abs diff {err:.3e} (logit scale "
            f"{scale:.3e}, tol {rel * scale:.3e}), argmax agrees "
            f"{agree}/{plain.shape[0]}")


def phase_paged_logits(model, params,
                       tag: str = "[10 paged logits] yi-6b full") -> None:
    plain, kern = paged_logits(model, params)
    print(f"{tag}, 300-token prompt as chunks of 128 "
          f"+ 4 paged decode steps: "
          + check_logits(plain, kern, model.cfg.padded_vocab, "paged logits"))


def row(name: str, source: str, replaces: str, err: float, n_bytes: float,
        n_ops: float, times: dict, dtype=BF16) -> dict:
    """One kernel's entry of the ``kernels`` JSON line."""
    bound_ms, bound_by = bound(n_bytes, n_ops, dtype)
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "max_abs_err": err, "bound_ms": bound_ms,
            "bound_by": bound_by,
            **{k: (None if v is None else v[0]) for k, v in times.items()}}


def fmt_times(times: dict) -> str:
    return ", ".join(f"{k} {v[0]:.4f} ({v[1]:.4f})" for k, v in times.items()
                     if v is not None)


def decode_bytes(kv_len, b, h, hkv, d, psz, kv_elem: int, q_elem: int,
                 scale_bytes: int = 0, writes_o: bool = True) -> float:
    """Bytes a paged decode must move: every live K/V row (and its scales)
    once, q in and (unless it writes split partials instead) o out, the
    live table entries and kv_len."""
    keys = sum(kv_len)
    live_pages = sum(-(-n // psz) for n in kv_len)
    return (2 * keys * hkv * (d * kv_elem + scale_bytes)
            + (1 + writes_o) * b * h * d * q_elem + 4 * (live_pages + b))


def counters_zero() -> bool:
    """Every arrival counter of the merged split routes is 0."""
    torch.cuda.synchronize()
    return all(int(c.count_nonzero()) == 0 for c in pa.arrival_counters())


def merged_bit_equal(merged, args, ns: int, what: str) -> None:
    """K5c's merged route (``merged``, one launch) against standalone K5c
    over the partials that same launch wrote: bit-equal, and every arrival
    counter 0 afterwards."""
    o, parts = merged(*args, ns, return_partials=True)
    want = pa.split_combine(*parts, BF16).reshape(o.shape)
    torch.cuda.synchronize()
    check(torch.equal(o, want), f"{what} ns={ns}: the merged output is not "
          "bit-equal to K5c over the partials of its launch")
    check(counters_zero(), f"{what} ns={ns}: an arrival counter is not 0")


def phase_k5() -> list[dict]:
    """K5a + K5c: bf16 on the cluster kernel's partials mode, its partials
    held to the plain version cut at its own 64-key tiles (float32: the
    SIMT template's, at 32-key tiles), the merged output to the split and
    the one-pass plain versions (bf16: the merged route, K5c in K5a's
    epilogue, also bit-equal to standalone K5c over its own partials);
    ns=1 is K3; the split sweep, the merged route beside phase 1 + K5c."""
    # (label, B, H, Hkv, D, psz, nblk, kv_len, dtype): the phase-7 cases
    cases = [("yi-6b paged decode", 4, 32, 4, 128, 16, 64,
              [1024, 517, 33, 300], BF16),
             ("deepseek-7b paged decode", 4, 32, 32, 128, 16, 64,
              [700, 1024, 16, 1], BF16),
             ("fp32 reduced", 2, 4, 2, 16, 8, 8, [61, 7], torch.float32)]
    errs, part_errs, ratio = [], [], 0.0
    for i, (label, b, h, hkv, d, psz, nblk, kv_len, dtype) in enumerate(cases):
        q, kp, vp, table, lens = paged_case(b, h, hkv, d, psz, nblk, kv_len,
                                            dtype, 200 + 10 * i)
        one_pass = ref.paged_decode_ref(q, kp, vp, table, lens)
        check(torch.equal(pa.flash_paged_decode(q, kp, vp, table, lens,
                                                num_splits=1),
                          pa.flash_paged_decode(q, kp, vp, table, lens)),
              f"K5 {label}: num_splits=1 is not K3's output")
        tc = dtype == BF16
        tile = pa.DECODE_TILE_KEYS if tc else 32
        # ns 16 leaves the short lanes' trailing splits without a tile
        for ns in (2, 3, 8, 16) if tc else (2, 3, 8):
            parts = pa.paged_decode_split(q, kp, vp, table, lens, ns)
            check(pa.paged_decode_split.last_kernel
                  == (pa.DECODE_TC_KERNEL if tc else pa.DECODE_SIMT_KERNEL),
                  f"K5a {label} ran {pa.paged_decode_split.last_kernel}")
            _, want = ref.paged_decode_split_tiles_ref(q, kp, vp, table, lens,
                                                       ns, block_k=tile)
            acc_abs = None
            if tc:      # sum_j p_j |v_j| of every split
                _, (_, _, acc_abs) = ref.paged_decode_split_tiles_ref(
                    q, kp, vp.float().abs(), table, lens, ns, block_k=tile)
            err, r = compare_partials(parts, want, acc_abs)
            ratio = max(ratio, r)
            part_errs.append(f"{label} ns={ns} {err:.2e}")
            n_merged = pa.paged_decode_split_merged.launches
            got = pa.flash_paged_decode(q, kp, vp, table, lens, num_splits=ns)
            check(pa.paged_decode_split_merged.launches == n_merged + tc,
                  f"K5 {label}: the bf16 split decode did not take the "
                  "merged route (or the float32 one did)")
            err = max(compare(got, ref.paged_decode_split_ref(
                q, kp, vp, table, lens, ns), dtype),
                compare(got, one_pass, dtype))
            errs.append(f"{label} ns={ns} {err:.2e}")
            if tc:
                merged_bit_equal(pa.paged_decode_split_merged,
                                 (q, kp, vp, table, lens), ns,
                                 f"K5a+K5c {label}")
    q, kp, vp, table, lens = paged_case(2, 32, 4, 128, 16, 8, [0, 77], BF16,
                                        240)
    out = pa.flash_paged_decode(q, kp, vp, table, lens, num_splits=8)
    torch.cuda.synchronize()
    check(bool((out[0] == 0).all()), "K5: kv_len == 0 row is not exactly 0")
    compare(out[1:], ref.paged_decode_ref(q, kp, vp, table, lens)[1:], BF16)
    errs.append("kv_len==0 row exactly 0; ns=1 equal to K3; the merged "
                "route bit-equal to K5c over its launch's partials at "
                "2/3/8/16 splits, every arrival counter 0 after each call")
    print(f"[11 K5 split-KV decode] max abs err vs plain (tol bf16 "
          f"{TOL[BF16]}, fp32 {TOL[torch.float32]}; bf16 on "
          f"{pa.DECODE_TC_KERNEL}'s partials mode, fp32 on the SIMT "
          f"template): partials (m, l, acc) against the plain version cut "
          f"at the kernel's own tiles (64 keys; fp32: 32), acc within "
          f"2^-8 sum p|v| + 2e-4 (1 + |acc|), its worst error {ratio:.3f}x "
          f"the bf16 tolerance 2e-2 (1 + |acc|), rows without a key in a "
          f"split exactly (-1e30, 0, 0): " + "; ".join(part_errs)
          + "; merged output (bf16: K5c in K5a's epilogue; fp32: K5c) "
          "against the split and the one-pass plain versions: "
          + "; ".join(errs))

    # the split-count sweep at the phase-7 timing shape
    b, h, hkv, d, psz, nblk = 4, 32, 4, 128, 16, 64
    kv_len = [839, 720, 190, 544]
    q, kp, vp, table, lens = paged_case(b, h, hkv, d, psz, nblk, kv_len,
                                        BF16, 250)
    want = ref.paged_decode_ref(q, kp, vp, table, lens)
    sweep = []
    for ns in (1, 2, 4, 8, 16):
        if ns == 1:
            p1 = time_ms(lambda: pa.flash_paged_decode(q, kp, vp, table, lens))
            sweep.append(f"ns=1 (K3) {p1[0]:.4f}")
            continue
        parts = pa.paged_decode_split(q, kp, vp, table, lens, ns)
        p1 = time_ms(lambda: pa.paged_decode_split(q, kp, vp, table, lens, ns))
        p2 = time_ms(lambda: pa.split_combine(*parts, BF16))
        both = time_ms(lambda: pa.split_combine(
            *pa.paged_decode_split(q, kp, vp, table, lens, ns), BF16))
        merged = time_ms(lambda: pa.flash_paged_decode(q, kp, vp, table, lens,
                                                       num_splits=ns))
        check(pa.paged_decode_split_merged.last_kernel == pa.DECODE_TC_KERNEL,
              "the bf16 split decode did not take the merged route")
        sweep.append(f"ns={ns} merged {merged[0]:.4f} against phase 1 + K5c "
                     f"{both[0]:.4f} timed together (apart: {p1[0]:.4f} + "
                     f"{p2[0]:.4f})")
        if ns == 8:
            parts8, t1, t2, t12, tb = parts, p1, p2, merged, both
    print(f"[11 K5 split-KV decode] yi-6b B=4 H=32 Hkv=4 D=128 psz=16 "
          f"nblk=64 bf16 kv_len={kv_len}, device ms by split count (merged: "
          f"one launch, K5c in K5a's epilogue): " + "; ".join(sweep))

    ns, g = 8, h // hkv
    err1 = compare(pa.flash_paged_decode(q, kp, vp, table, lens, num_splits=ns),
                   want, BF16)
    m, l, acc = parts8
    _, l_star, acc_star = ref.combine_split_states(m, l, acc)
    # standalone K5c as the float32 route (13d) calls it: a float32 output
    f32 = torch.float32
    err2 = compare(pa.split_combine(m, l, acc, f32),
                   ref.finalize_split_states(l_star, acc_star), f32)
    partial_bytes = 4 * b * hkv * ns * g * (2 + d)
    k_dense = ref.gather_pages(kp, table)          # gathered once, untimed
    v_dense = ref.gather_pages(vp, table)
    mask = (torch.arange(nblk * psz, device="cuda")[None, :]
            < lens[:, None])[:, None, None, :]
    keys = sum(kv_len)
    k5a = {"ms": t12,
           "plain_ms": time_ms(lambda: ref.paged_decode_split_tiles_ref(
               q, kp, vp, table, lens, ns, block_k=pa.DECODE_TILE_KEYS)),
           "library_ms": time_ms(
               lambda: torch.nn.functional.scaled_dot_product_attention(
                   q, k_dense, v_dense, attn_mask=mask, enable_gqa=True))}
    k5c = {"ms": time_ms(lambda: pa.split_combine(m, l, acc, f32)),
           "plain_ms": time_ms(lambda: ref.finalize_split_states(
               *ref.combine_split_states(m, l, acc)[1:])),
           "library_ms": None}
    # the merged route moves what K3 must (the partials stay in L2): K/V
    # once, q in and o out, the live table entries and kv_len
    rows = [dict(row("paged_decode_split_merged", DECODE_SOURCE,
                     f"{FLASH}:535", err1,
                     decode_bytes(kv_len, b, h, hkv, d, psz, 2, 2),
                     4 * h * keys * d, k5a), merges=f"{FLASH}:315"),
            row("split_combine", PAGED_SOURCE, f"{FLASH}:315", err2,
                partial_bytes + 4 * b * h * d, 4 * b * h * ns * d, k5c, f32)]
    print(f"[11 K5 split-KV decode] ns=8 at that shape, device ms (ms per "
          f"call incl. host): K5a with K5c in its epilogue (one launch) "
          f"{fmt_times(k5a)}, bound {rows[0]['bound_ms']:.5f} ms "
          f"({rows[0]['bound_by']}: K/V, q and o once, the partials in L2); "
          f"against phase 1 + standalone K5c {tb[0]:.4f} timed together "
          f"(apart: {t1[0]:.4f} + {t2[0]:.4f}); standalone K5c (the "
          f"float32 route's, float32 out) {fmt_times(k5c)}, bound "
          f"{rows[1]['bound_ms']:.5f} ms "
          f"({rows[1]['bound_by']}); plain K5a = the split plain version "
          f"cut at the kernel's 64-key tiles (both phases), K5c = combine "
          f"+ finalize on the same partials; "
          f"library = SDPA with a kv_len mask on the pre-gathered K/V "
          f"(gather not timed)")
    return rows


def phase_k6() -> list[dict]:
    errs = []
    # decode on pools quantized from the phase-7 cases
    cases = [("yi-6b paged decode", 4, 32, 4, 128, 16, 64,
              [1024, 517, 33, 300], BF16),
             ("deepseek-7b paged decode", 4, 32, 32, 128, 16, 64,
              [700, 1024, 16, 1], BF16),
             ("fp32 reduced", 2, 4, 2, 16, 8, 8, [61, 7], torch.float32),
             ("kv_len 0", 2, 32, 4, 128, 16, 8, [0, 77], BF16)]
    for i, (label, b, h, hkv, d, psz, nblk, kv_len, dtype) in enumerate(cases):
        q, kp, vp, table, lens = paged_case(b, h, hkv, d, psz, nblk, kv_len,
                                            dtype, 400 + 10 * i)
        (k8, ks), (v8, vs) = quantize_int8_rows(kp), quantize_int8_rows(vp)
        want = ref.paged_decode_ref(q, k8, v8, table, lens, k_scale=ks,
                                    v_scale=vs)
        for ns in (1, 8):
            got = pa.flash_paged_decode_quant(q, k8, v8, ks, vs, table, lens,
                                              num_splits=ns)
            launched = (pa.flash_paged_decode_quant if ns == 1
                        else pa.paged_decode_split_quant_merged
                        if dtype == BF16
                        else pa.paged_decode_split_quant).last_kernel
            check(launched == (pa.DECODE_TC_KERNEL if dtype == BF16
                               else pa.DECODE_SIMT_KERNEL),
                  f"{'K6a' if ns == 1 else 'K6b'} {label} ran {launched}")
            live = torch.tensor(kv_len, device="cuda") > 0
            if not bool(live.all()):
                torch.cuda.synchronize()
                check(bool((got[~live] == 0).all()),
                      f"K6 ns={ns}: kv_len == 0 row is not exactly 0")
            err = compare(got[live], want[live], dtype)
            errs.append(f"{label} ns={ns} {err:.2e}")
    # prefill chunks on pools quantized from the phase-8 cases
    cases = [("yi-6b chunk at 0", 32, 4, 128, 16, 128, 0, 128, BF16),
             ("yi-6b chunk at 384", 32, 4, 128, 16, 128, 384, 128, BF16),
             ("mid-page start 200", 32, 4, 128, 16, 128, 200, 128, BF16),
             ("ragged last chunk", 32, 4, 128, 16, 128, 256, 44, BF16),
             ("fp32 reduced", 4, 2, 16, 8, 8, 12, 5, torch.float32)]
    for i, (label, h, hkv, d, psz, c, start, valid, dtype) in enumerate(cases):
        nblk = -(-(start + c) // psz)
        q, kp, vp, table, lens = paged_case(2, h, hkv, d, psz, nblk,
                                            [start + valid, c], dtype,
                                            500 + 10 * i, c=c)
        (k8, ks), (v8, vs) = quantize_int8_rows(kp), quantize_int8_rows(vp)
        starts = torch.tensor([start, 0], dtype=torch.int32, device="cuda")
        got = pa.flash_paged_prefill_quant(q, k8, v8, ks, vs, table, starts,
                                           lens)
        check(pa.flash_paged_prefill_quant.last_kernel
              == (TC_KERNEL if dtype == BF16 else "paged_prefill_kernel"),
              f"K6c {label}: launched "
              f"{pa.flash_paged_prefill_quant.last_kernel}")
        want = ref.paged_prefill_ref(q, k8, v8, table, starts, lens,
                                     k_scale=ks, v_scale=vs)
        err = max(compare(got[:1, :, :valid], want[:1, :, :valid], dtype),
                  compare(got[1:], want[1:], dtype))
        errs.append(f"{label} {err:.2e}")
    q, kp, vp, table, lens = paged_case(2, 32, 4, 128, 16, 2, [0, 20], BF16,
                                        570, c=8)
    (k8, ks), (v8, vs) = quantize_int8_rows(kp), quantize_int8_rows(vp)
    starts = torch.tensor([0, 12], dtype=torch.int32, device="cuda")
    out = pa.flash_paged_prefill_quant(q, k8, v8, ks, vs, table, starts, lens)
    torch.cuda.synchronize()
    check(bool((out[0] == 0).all()), "K6c: rows with no key are not exactly 0")
    errs.append("rows without keys exactly 0")
    errs.append("K6a yi-6b by cluster size " + tc_decode_checks(True))
    errs.append("K6b partials " + k6b_checks())
    print(f"[12 K6 int8 pages] max abs err vs plain (tol bf16 {TOL[BF16]}, "
          f"fp32 {TOL[torch.float32]}): " + "; ".join(errs))

    # decode timings at the phase-7 timing shape
    b, h, hkv, d, psz, nblk = 4, 32, 4, 128, 16, 64
    kv_len = [839, 720, 190, 544]
    q, kp, vp, table, lens = paged_case(b, h, hkv, d, psz, nblk, kv_len,
                                        BF16, 250)
    (k8, ks), (v8, vs) = quantize_int8_rows(kp), quantize_int8_rows(vp)
    want = ref.paged_decode_ref(q, k8, v8, table, lens, k_scale=ks,
                                v_scale=vs)
    k_dense = ref.gather_pages(k8.to(BF16) * ks[..., None].to(BF16), table)
    v_dense = ref.gather_pages(v8.to(BF16) * vs[..., None].to(BF16), table)
    mask = (torch.arange(nblk * psz, device="cuda")[None, :]
            < lens[:, None])[:, None, None, :]
    sdpa = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k_dense, v_dense, attn_mask=mask, enable_gqa=True))
    keys, ns, g = sum(kv_len), 8, h // hkv
    n_bytes = decode_bytes(kv_len, b, h, hkv, d, psz, 1, 2, scale_bytes=4)
    k6a = {"ms": time_ms(lambda: pa.flash_paged_decode_quant(
               q, k8, v8, ks, vs, table, lens)),
           "plain_ms": time_ms(lambda: ref.paged_decode_ref(
               q, k8, v8, table, lens, k_scale=ks, v_scale=vs)),
           "library_ms": sdpa}
    k6b = {"ms": time_ms(lambda: pa.flash_paged_decode_quant(
               q, k8, v8, ks, vs, table, lens, num_splits=ns)),
           "plain_ms": time_ms(lambda: ref.paged_decode_split_tiles_ref(
               q, k8, v8, table, lens, ns, k_scale=ks, v_scale=vs,
               block_k=pa.DECODE_TILE_KEYS)),
           "library_ms": sdpa}
    k6b_kernel = pa.paged_decode_split_quant_merged.last_kernel
    check(k6b_kernel == pa.DECODE_TC_KERNEL,
          f"the bf16 int8 split decode ran {k6b_kernel}")
    sweep = []
    for n_sp in (2, 4, 8, 16):
        parts = pa.paged_decode_split_quant(q, k8, v8, ks, vs, table, lens,
                                            n_sp)
        p1 = time_ms(lambda: pa.paged_decode_split_quant(
            q, k8, v8, ks, vs, table, lens, n_sp))
        p2 = time_ms(lambda: pa.split_combine(*parts, BF16))
        both = time_ms(lambda: pa.split_combine(*pa.paged_decode_split_quant(
            q, k8, v8, ks, vs, table, lens, n_sp), BF16))
        merged = time_ms(lambda: pa.paged_decode_split_quant_merged(
            q, k8, v8, ks, vs, table, lens, n_sp))
        sweep.append(f"ns={n_sp} merged {merged[0]:.4f} against phase 1 + "
                     f"K5c {both[0]:.4f} timed together (apart: {p1[0]:.4f} "
                     f"+ {p2[0]:.4f})")
    rows = [row("flash_paged_decode_quant", DECODE_SOURCE, f"{FLASH}:951",
                compare(pa.flash_paged_decode_quant(q, k8, v8, ks, vs, table,
                                                    lens), want, BF16),
                n_bytes, 4 * h * keys * d, k6a),
            dict(row("paged_decode_split_quant_merged", DECODE_SOURCE,
                     f"{FLASH}:1001",
                     compare(pa.flash_paged_decode_quant(
                         q, k8, v8, ks, vs, table, lens, num_splits=ns),
                         want, BF16),
                     n_bytes, 4 * h * keys * d, k6b), merges=f"{FLASH}:315")]
    print(f"[12 K6 int8 pages] yi-6b decode B=4 H=32 Hkv=4 D=128 psz=16 "
          f"nblk=64 bf16 q, int8 pools, kv_len={kv_len}, device ms (ms per "
          f"call incl. host): K6a ({pa.flash_paged_decode_quant.last_kernel} "
          f"in clusters of c={pa.cluster_size(b, hkv, pa.sm_count(0))}) "
          f"{fmt_times(k6a)}, bound "
          f"{rows[0]['bound_ms']:.5f} ms ({rows[0]['bound_by']}); K6b with "
          f"K5c in its epilogue (8 splits, one launch of {k6b_kernel}'s "
          f"partials mode over int8 pools) {fmt_times(k6b)}, bound "
          f"{rows[1]['bound_ms']:.5f} ms ({rows[1]['bound_by']}: the "
          f"partials in L2), plain = the split plain version cut at its "
          f"64-key tiles; by split count: " + "; ".join(sweep))

    # prefill timing at the phase-8 timing shape: a chunk of 128 at 384
    h, hkv, d, psz, c, start = 32, 4, 128, 16, 128, 384
    kv = start + c
    q, kp, vp, table, lens = paged_case(1, h, hkv, d, psz, kv // psz, [kv],
                                        BF16, 380, c=c)
    (k8, ks), (v8, vs) = quantize_int8_rows(kp), quantize_int8_rows(vp)
    starts = torch.tensor([start], dtype=torch.int32, device="cuda")
    err = compare(pa.flash_paged_prefill_quant(q, k8, v8, ks, vs, table,
                                               starts, lens),
                  ref.paged_prefill_ref(q, k8, v8, table, starts, lens,
                                        k_scale=ks, v_scale=vs), BF16)
    pairs = sum(start + i + 1 for i in range(c))
    k_dense = ref.gather_pages(k8.to(BF16) * ks[..., None].to(BF16), table)
    v_dense = ref.gather_pages(v8.to(BF16) * vs[..., None].to(BF16), table)
    causal = (torch.arange(kv, device="cuda")[None, :]
              <= start + torch.arange(c, device="cuda")[:, None])
    k6c = {"ms": time_ms(lambda: pa.flash_paged_prefill_quant(
               q, k8, v8, ks, vs, table, starts, lens)),
           "plain_ms": time_ms(lambda: ref.paged_prefill_ref(
               q, k8, v8, table, starts, lens, k_scale=ks, v_scale=vs)),
           "library_ms": time_ms(
               lambda: torch.nn.functional.scaled_dot_product_attention(
                   q, k_dense, v_dense, attn_mask=causal, enable_gqa=True))}
    n_bytes = 2 * 2 * q.numel() + 2 * kv * hkv * (d + 4) + 4 * (kv // psz + 2)
    rows.append(row("flash_paged_prefill_quant", PREFILL_SOURCE,
                    f"{FLASH}:1186", err, n_bytes, 4 * h * pairs * d, k6c))
    print(f"[12 K6 int8 pages] yi-6b chunk B=1 H=32 Hkv=4 C=128 D=128 psz=16 "
          f"bf16 q, int8 pools, start=384 kv_len=512, device ms (ms per call "
          f"incl. host): K6c {fmt_times(k6c)}, bound "
          f"{rows[2]['bound_ms']:.5f} ms ({rows[2]['bound_by']}); library "
          f"= SDPA on the pre-gathered, pre-dequantized bf16 K/V (gather "
          f"and dequant not timed)")
    return rows


def k6b_checks() -> str:
    """K6b's partials on int8 pools quantized from the phase-7 cases: bf16
    on the cluster kernel's partials mode, held to the plain version cut
    at its 64-key tiles with the pools' scales (float32: the SIMT
    template's 32-key tiles), at 2, 3, 8 and 16 splits (16: more splits
    than a short lane's tiles); and with codes 127 and NaN scales in the
    slots past kv_len of each lane's last live page, every partial finite
    and bit-equal to the run on the pools with those slots zeroed."""
    cases = [("yi-6b", 4, 32, 4, 128, 16, 64, [1024, 517, 33, 300], BF16),
             ("deepseek-7b", 4, 32, 32, 128, 16, 64, [700, 1024, 16, 1],
              BF16),
             ("fp32 reduced", 2, 4, 2, 16, 8, 8, [61, 7], torch.float32)]
    out, ratio = [], 0.0
    for i, (label, b, h, hkv, d, psz, nblk, kv_len, dtype) in enumerate(cases):
        q, kp, vp, table, lens = paged_case(b, h, hkv, d, psz, nblk, kv_len,
                                            dtype, 600 + 10 * i)
        (k8, ks), (v8, vs) = quantize_int8_rows(kp), quantize_int8_rows(vp)
        tc = dtype == BF16
        kw = dict(k_scale=ks, v_scale=vs,
                  block_k=pa.DECODE_TILE_KEYS if tc else 32)
        for ns in (2, 3, 8, 16) if tc else (2, 3, 8):
            parts = pa.paged_decode_split_quant(q, k8, v8, ks, vs, table,
                                                lens, ns)
            launched = pa.paged_decode_split_quant.last_kernel
            check(launched == (pa.DECODE_TC_KERNEL if tc
                               else pa.DECODE_SIMT_KERNEL),
                  f"K6b {label} ns={ns} ran {launched}")
            _, want = ref.paged_decode_split_tiles_ref(q, k8, v8, table, lens,
                                                       ns, **kw)
            acc_abs = None
            if tc:      # sum_j p_j |v_j| of every split
                _, (_, _, acc_abs) = ref.paged_decode_split_tiles_ref(
                    q, k8, v8.float().abs(), table, lens, ns, **kw)
            err, r = compare_partials(parts, want, acc_abs)
            ratio = max(ratio, r)
            out.append(f"{label} ns={ns} {err:.2e}")
            if tc:
                merged_bit_equal(pa.paged_decode_split_quant_merged,
                                 (q, k8, v8, ks, vs, table, lens), ns,
                                 f"K6b+K5c {label}")
    kv_len, psz = [1024, 517, 33, 300], 16
    q, kp, vp, table, lens = paged_case(4, 32, 4, 128, psz, 64, kv_len, BF16,
                                        660)
    pools = [*quantize_int8_rows(kp), *quantize_int8_rows(vp)]
    dirty, zeroed = nan_past_kv_len(pools, table, kv_len, psz)
    got, clean = (pa.paged_decode_split_quant(q, k8, v8, ks, vs, table, lens,
                                              8)
                  for k8, ks, v8, vs in (dirty, zeroed))
    torch.cuda.synchronize()
    for g, c in zip(got, clean):
        check(bool(torch.isfinite(g).all()) and torch.equal(g, c),
              "K6b: the slots past kv_len changed a partial")
    return ("; ".join(out) + f"; acc's worst error {ratio:.3f}x the bf16 "
            f"tolerance 2e-2 (1 + |acc|); codes 127 and NaN scales past "
            f"kv_len: every partial finite and bit-equal to the zeroed "
            f"pools' run; the merged route (K5c in K6b's epilogue) "
            f"bit-equal to K5c over its launch's partials at 2/3/8/16 "
            f"splits, every arrival counter 0 after each call")


def phase_split_int8_serves(smi: str, paged: dict, model, params
                            ) -> tuple[dict[str, int], dict[str, dict]]:
    """The phase-9 serve with int8 pages and split-KV: (a) int8 with 8
    splits, (b) int8 in one pass, (c) fp with 8 splits.  The split serves
    run K6b / K5a with K5c in their epilogue, one launch a layer a step,
    and no standalone K5c (``only_launched``).  Returns each new kernel's
    launches from the serve that runs it, and the serves' reports by
    label."""
    n_layers = 32
    serves = [("int8, 8 splits", dict(kv_dtype="int8", num_splits=8),
               (pa.flash_paged_prefill_quant,
                pa.paged_decode_split_quant_merged)),
              ("int8, one pass", dict(kv_dtype="int8"),
               (pa.flash_paged_prefill_quant, pa.flash_paged_decode_quant)),
              ("fp, 8 splits", dict(num_splits=8),
               (pa.flash_paged_prefill, pa.paged_decode_split_merged))]
    counts, lines, reports, abs_ = {}, [], {}, []
    for n, (label, kw, (prefill, *decode)) in enumerate(serves):
        with kernels_by_route(pa, "paged_decode_split_merged") as k5a_routes, \
                kernels_by_route(pa, "paged_decode_split_quant_merged") \
                as k6b_routes, first_logits_and_tick() as firsts:
            report, launches = serve_with_counts(**PAGED, **kw)
        abs_.append(eager_twin(f"13{'abc'[n]} ({label})",
                               (report, launches, firsts), model, params,
                               **PAGED, **kw))
        reports[label] = report
        what = f"the {label} serve"
        only_launched(launches, (prefill, *decode), what)
        check(counters_zero(), f"{what}: an arrival counter is not 0")
        for kernel, routes in ((pa.paged_decode_split_merged, k5a_routes),
                               (pa.paged_decode_split_quant_merged,
                                k6b_routes)):
            if kernel in decode:
                check(dict(routes) == {pa.DECODE_TC_KERNEL:
                                       launches[kernel.__name__]},
                      f"{what}: {kernel.__name__} launches by kernel "
                      f"{dict(routes)}")
        check(prefill.last_kernel == TC_KERNEL,
              f"{what}: {prefill.__name__} ran {prefill.last_kernel}")
        check(launches[prefill.__name__]
              == n_layers * report["prefill_chunks"],
              f"{what}: {prefill.__name__} launched "
              f"{launches[prefill.__name__]} times, expected {n_layers} x "
              f"{report['prefill_chunks']} prefill chunks")
        for kernel in decode:
            check(launches[kernel.__name__] == n_layers * report["decode_steps"],
                  f"{what}: {kernel.__name__} launched "
                  f"{launches[kernel.__name__]} times, expected {n_layers} x "
                  f"{report['decode_steps']} decode steps")
        if pa.flash_paged_decode_quant in decode:
            check(pa.flash_paged_decode_quant.last_kernel
                  == pa.DECODE_TC_KERNEL,
                  f"{what}: K6a ran "
                  f"{pa.flash_paged_decode_quant.last_kernel}")
        check(report["kv_dtype"] == kw.get("kv_dtype", "fp"), "kv_dtype")
        for name, n in launches.items():
            if n:
                counts.setdefault(name, n)
        cache = report["cache"]
        lines.append(
            f"{label}: {report['tokens_per_s']:.1f} tok/s, p50 ttft "
            f"{report['p50_ttft_s']:.4f}s, p50 itl {report['p50_itl_s']:.4f}s, "
            f"{report['prefill_chunks']} chunks, {report['decode_steps']} "
            f"decode steps, launches "
            f"{ {k: n for k, n in launches.items() if n} }"
            + (f" (K5a+K5c by kernel {dict(k5a_routes)})" if k5a_routes
               else "")
            + (f" (K6b+K5c by kernel {dict(k6b_routes)})" if k6b_routes
               else "")
            + f", pool_bytes "
            f"{cache['pool_bytes']} ({cache['kv_bytes_per_token']:.1f} B per "
            f"token) against fp {paged['cache']['pool_bytes']}, kv "
            f"{json.dumps(cache)}, greedy tokens equal to the phase-9 "
            f"serve's {greedy_agreement(report, paged)}")
    print(f"[13 split-KV and int8 serves] yi-6b full, pages of 16, chunks of "
          f"128, on {smi}: " + "; ".join(lines))
    print("[13 graphed against eager] " + " | ".join(abs_))
    return {k.__name__: counts[k.__name__] for k in
            (pa.paged_decode_split_merged, pa.flash_paged_decode_quant,
             pa.paged_decode_split_quant_merged,
             pa.flash_paged_prefill_quant)}, reports


FP32_LAYERS = 8      # depth of the float32-compute serve (13d)


def phase_fp32_split_serve(smi: str, cfg) -> dict[str, int]:
    """13d: the 13c serve (fp pages, 8 splits) of yi-6b at full width with
    float32 compute and caches, depth cut to :data:`FP32_LAYERS` layers
    (random weights from seed 0): a float32 query keeps the two-launch
    split route, K5a on the SIMT template then standalone K5c, once per
    layer per decode step; K4 on the SIMT template per chunk.  Returns
    standalone K5c's launches."""
    fp32 = build_model(dataclasses.replace(
        cfg, n_layers=FP32_LAYERS, compute_dtype="float32",
        cache_dtype="float32"))
    engine = ServingEngine(fp32, fp32.init(0, "cuda"),
                           n_lanes=SERVE["n_lanes"], max_len=SERVE["max_len"],
                           cache="paged", page_size=16, prefill_chunk=128,
                           num_splits=8)
    with kernels_by_route(pa, "paged_decode_split") as routes:
        report, launches = serve_with_counts(engine, cache="paged",
                                             page_size=16, prefill_chunk=128,
                                             num_splits=8)
    what = "the float32 split serve"
    decode = (pa.paged_decode_split, pa.split_combine)
    only_launched(launches, (pa.flash_paged_prefill, *decode), what)
    for kernel, want in ((pa.flash_paged_prefill, report["prefill_chunks"]),
                         *((k, report["decode_steps"]) for k in decode)):
        check(launches[kernel.__name__] == FP32_LAYERS * want > 0,
              f"{what}: {kernel.__name__} launched "
              f"{launches[kernel.__name__]} times, expected {FP32_LAYERS} "
              f"x {want}")
    check(dict(routes) == {pa.DECODE_SIMT_KERNEL:
                           launches["paged_decode_split"]},
          f"{what}: K5a launches by kernel {dict(routes)}")
    check(pa.flash_paged_prefill.last_kernel == "paged_prefill_kernel",
          f"{what}: K4 ran {pa.flash_paged_prefill.last_kernel}")
    print(f"[13d float32 split serve] yi-6b at full width, {FP32_LAYERS} "
          f"layers, float32 compute and pages of 16, chunks of 128, 8 "
          f"splits, on {smi}: {report['finished']}/{SERVE['n_requests']} "
          f"requests, {report['tokens_per_s']:.1f} tok/s, "
          f"{report['prefill_chunks']} chunks, {report['decode_steps']} "
          f"decode steps, launches "
          f"{ {k: n for k, n in launches.items() if n} } (K5a by kernel "
          f"{dict(routes)}): a float32 query keeps K5a + standalone K5c")
    return {"split_combine": launches["split_combine"]}


def phase_int8_logits(model, params,
                      tag: str = "[14 int8 paged logits] yi-6b full") -> None:
    plain, kern = paged_logits(model, params, quantized=True,
                               splits=(None, None, 8, 8))
    print(f"{tag}, int8 pools, 300-token prompt "
          f"as chunks of 128 + 2 decode steps in one pass + 2 with 8 splits: "
          + check_logits(plain, kern, model.cfg.padded_vocab,
                         "int8 paged logits"))


# --------------------------------------------------------------------------
# phases 15-18: split prefill/verify, speculative and prefix-cache serves
# --------------------------------------------------------------------------

# (label, H, Hkv, D, psz, nblk, starts, valid rows, C, dtype): verify
# chunks of k + 1 = 5 rows with an idle lane (no key), and the phase-8
# prefill chunk
SPLIT_CASES = [
    ("yi-6b verify", 32, 4, 128, 16, 64, [839, 720, 190, 544, 0],
     [5, 5, 5, 5, 0], 5, BF16),
    ("deepseek-7b verify", 32, 32, 128, 16, 64, [839, 720, 190, 544, 0],
     [5, 5, 5, 5, 0], 5, BF16),
    ("yi-6b chunk at 384", 32, 4, 128, 16, 32, [384], [128], 128, BF16),
    ("fp32 reduced", 4, 2, 16, 8, 12, [12, 0, 40], [5, 0, 3], 8,
     torch.float32),
]
VERIFY_SHAPE = SPLIT_CASES[0]
CHUNK_SHAPE = SPLIT_CASES[2]


def split_case(case, seed: int, quant: bool):
    """q, pools (fp, or int8 quantized from them), table, start, kv_len."""
    _, h, hkv, d, psz, nblk, starts, valid, c, dtype = case
    kv_len = [s + v for s, v in zip(starts, valid)]
    q, kp, vp, table, lens = paged_case(len(starts), h, hkv, d, psz, nblk,
                                        kv_len, dtype, seed, c=c)
    start = torch.tensor(starts, dtype=torch.int32, device="cuda")
    if quant:
        (k8, ks), (v8, vs) = quantize_int8_rows(kp), quantize_int8_rows(vp)
        return q, ops.PagedPools(k8, v8, ks, vs), table, start, lens
    return q, ops.PagedPools(kp, vp), table, start, lens


def compare_partials(got, want, acc_abs=None) -> tuple[float, float]:
    """(max abs error, acc's worst ratio to the bf16 tolerance) of split
    partials (m, l, acc) against the plain version's cut at the same
    partition.  The SIMT template's are fp32 sums of the same
    fp32-converted inputs: all three at the fp32 tolerance.  The
    tensor-core partials mode (``acc_abs`` given: the plain acc over |v|,
    sum_j p_j |v_j|) rounds P to bf16 for P.V: m and l at the fp32
    tolerance, acc within what P's rounding can move it by, 2^-8 sum_j
    p_j |v_j|, plus 2e-4 (1 + |acc|) for fp32 sums taken in another
    order.  The ratio of acc's error to the bf16 tolerance, 2e-2 + 2e-2
    |acc|, is returned for the record: where acc's terms cancel, P's
    roundings add up to more.  Either way a row that saw no key of a
    split must be exactly (-1e30, 0, 0)."""
    (gm, gl, gacc), (m, l, acc) = got, want
    err = max(compare(gm, m, torch.float32), compare(gl, l, torch.float32))
    ratio = 0.0
    if acc_abs is not None:
        acc_err = (gacc - acc).abs()
        bound = 2.0 ** -8 * acc_abs + 2e-4 * (1 + acc.abs())
        check(bool(torch.isfinite(gacc).all() and (acc_err <= bound).all()),
              "acc moved by more than P's bf16 rounding allows")
        err = max(err, float(acc_err.max()))
        ratio = float((acc_err / (TOL[BF16] * (1 + acc.abs()))).max())
    else:
        err = max(err, compare(gacc, acc, torch.float32))
    empty = m == ref.NEG_INF
    check(bool((gm[empty] == ref.NEG_INF).all() and (gl[empty] == 0).all()
               and (gacc[empty] == 0).all()),
          "a row that saw no key of its split is not exactly (-1e30, 0, 0)")
    return err, ratio


def split_phase(quant: bool) -> tuple[dict, dict]:
    """Checks of K5b (or K6d) + K5c against the plain versions over the
    split cases; returns the verify-shape and chunk-shape timings.  The
    bf16 K5b and K6d are the tensor-core kernel's partials mode: their
    partials are held to the plain version cut at its own tiles (32 // G
    chunk rows, 128 keys); the SIMT template's (fp32) at 64 rows, 32
    keys.  A bf16 split call is the merged route (K5c in the epilogue, one
    launch), held bit-equal to standalone K5c over its launch's partials
    at 2, 3, 8 and 16 splits."""
    kernel = pa.paged_prefill_split_quant if quant else pa.paged_prefill_split
    one_pass = pa.flash_paged_prefill_quant if quant else pa.flash_paged_prefill
    merged = (pa.paged_prefill_split_quant_merged if quant
              else pa.paged_prefill_split_merged)
    errs, out_errs, ratio = [], [], 0.0
    for i, case in enumerate(SPLIT_CASES):
        label, h, hkv, *_, valid, c, dtype = case
        q, pools, table, start, lens = split_case(case, 600 + 10 * i, quant)
        sc = (pools.k_scale, pools.v_scale) if quant else ()
        kw = dict(k_scale=pools.k_scale, v_scale=pools.v_scale)
        tc = dtype == BF16
        if tc:
            kw.update(block_q=pa.TC_TILE_ROWS // (h // hkv),
                      block_k=pa.TC_TILE_KEYS)
        args = (q, pools.k, pools.v, *sc, table, start, lens)
        plain = ref.paged_prefill_ref(q, pools.k, pools.v, table, start, lens,
                                      k_scale=pools.k_scale,
                                      v_scale=pools.v_scale)
        for ns in (2, 3, 8, 16) if tc else (2, 3, 8):
            n_merged = merged.launches
            got = one_pass(*args, num_splits=ns)
            check(merged.launches == n_merged + tc,
                  f"{label} ns={ns}: the bf16 split verify did not take the "
                  "merged route (or the float32 one did)")
            if tc:
                merged_bit_equal(merged, args, ns,
                                 f"{'K6d' if quant else 'K5b'}+K5c {label}")
            want, parts = ref.paged_prefill_split_ref(
                q, pools.k, pools.v, table, start, lens, ns, **kw)
            acc_abs = None
            if tc:      # sum_j p_j |v_j| of every split (|v| dequantized)
                _, (_, _, acc_abs) = ref.paged_prefill_split_ref(
                    q, pools.k, pools.v.float().abs(), table, start, lens,
                    ns, **kw)
            err, r = compare_partials(kernel(*args, ns), parts, acc_abs)
            ratio = max(ratio, r)
            out_err = 0.0
            check(kernel.last_kernel == (TC_KERNEL if tc
                                         else "paged_prefill_kernel"),
                  f"{'K6d' if quant else 'K5b'} {label}: launched "
                  f"{kernel.last_kernel}")
            for b, v in enumerate(valid):
                if v == 0:
                    torch.cuda.synchronize()
                    check(bool((got[b] == 0).all()),
                          f"{label} ns={ns}: a lane with no key is not "
                          "exactly 0")
                    continue
                out_err = max(out_err,
                              compare(got[b, :, :v], want[b, :, :v], dtype),
                              compare(got[b, :, :v], plain[b, :, :v], dtype))
            errs.append(f"{label} ns={ns} {err:.2e}")
            out_errs.append(f"{label} ns={ns} {out_err:.2e}")
    name = "K6d" if quant else "K5b"
    print(f"[{16 if quant else 15} {name} split {'int8 ' if quant else ''}"
          f"prefill/verify] max abs err vs plain (tol bf16 {TOL[BF16]}, "
          f"fp32 {TOL[torch.float32]}; bf16 on {TC_KERNEL}'s partials mode"
          + (" over int8 pools" if quant else "")
          + f", its partials against the plain version at its own tiles, "
          f"acc within 2^-8 sum p|v| + 2e-4 (1 + |acc|); its worst error is "
          f"{ratio:.3f}x the bf16 tolerance 2e-2 (1 + |acc|)"
          + "): partials (m, l, acc), fp32: " + "; ".join(errs)
          + "; merged output (bf16: K5c in the epilogue; fp32: K5c): "
          + "; ".join(out_errs)
          + "; idle lanes exactly 0; rows without a key in a split exactly "
          "(-1e30, 0, 0); the merged route bit-equal to K5c over its "
          "launch's partials at 2/3/8/16 splits, every arrival counter 0 "
          "after each call")

    timings = {}
    sweep_ns = (1, 2, 4, 8, 16)
    for shape_name, case, seed in (("verify", VERIFY_SHAPE, 650),
                                   ("chunk", CHUNK_SHAPE, 660)):
        q, pools, table, start, lens = split_case(case, seed, quant)
        sc = (pools.k_scale, pools.v_scale) if quant else ()
        args = (q, pools.k, pools.v, *sc, table, start, lens)
        sweep = []
        for ns in sweep_ns:
            if ns == 1:
                # the one pass held to the plain version at this shape
                # (live lanes) before it is timed; an idle lane exactly 0
                got = one_pass(*args)
                check(one_pass.last_kernel == TC_KERNEL,
                      f"{one_pass.__name__} {shape_name}: launched "
                      f"{one_pass.last_kernel}")
                want = ref.paged_prefill_ref(
                    q, pools.k, pools.v, table, start, lens,
                    k_scale=pools.k_scale, v_scale=pools.v_scale)
                lane_errs = []
                for b, v in enumerate(case[7]):
                    if v == 0:
                        torch.cuda.synchronize()
                        check(bool((got[b] == 0).all()),
                              f"{shape_name} ns=1: a lane with no key is "
                              "not exactly 0")
                    else:
                        lane_errs.append(compare(got[b, :, :v],
                                                 want[b, :, :v], case[-1]))
                t1 = time_ms(lambda: one_pass(*args))
                sweep.append(f"ns=1 (one pass) {t1[0]:.4f} (max abs err "
                             f"vs plain {max(lane_errs):.2e})")
                timings[(shape_name, 1)] = (t1, None, None)
                continue
            parts = kernel(*args, ns)
            p1 = time_ms(lambda: kernel(*args, ns))
            p2 = time_ms(lambda: pa.split_combine(*parts, q.dtype))
            both = time_ms(lambda: pa.split_combine(*kernel(*args, ns),
                                                    q.dtype))
            whole = time_ms(lambda: merged(*args, ns))
            sweep.append(f"ns={ns} merged {whole[0]:.4f} against phase 1 + "
                         f"K5c {both[0]:.4f} timed together (apart: "
                         f"{p1[0]:.4f} + {p2[0]:.4f})")
            timings[(shape_name, ns)] = (p1, p2, whole, both)
        print(f"[{16 if quant else 15} {name}] {case[0]} shape, device ms by "
              f"split count (merged: one launch, K5c in {name}'s epilogue): "
              + "; ".join(sweep))
    return timings


def chunk_work(case, kv_elem: int, scale_bytes: int = 0,
               writes_o: bool = True):
    """(bytes, operations) of one chunk's attention: every committed key
    row (and its scales) read once, q read and (unless it writes split
    partials instead) o written, the live table entries, start and kv_len;
    4 flops per visible (query, key) pair and head dim."""
    _, h, hkv, d, psz, _, starts, valid, c, dtype = case
    keys = sum(s + v for s, v in zip(starts, valid))
    pages = sum(-(-(s + v) // psz) for s, v in zip(starts, valid))
    pairs = sum(s + i + 1 for s, v in zip(starts, valid) for i in range(v))
    q_bytes = len(starts) * h * c * d * torch.finfo(dtype).bits // 8
    n_bytes = (2 * keys * hkv * (d * kv_elem + scale_bytes)
               + (1 + writes_o) * q_bytes
               + 4 * (pages + 2 * len(starts)))
    return n_bytes, 4 * h * pairs * d


def split_rows(quant: bool, timings: dict) -> list[dict]:
    """The K5b (or K6d) row of the kernels line: the verify shape at 8
    splits, the merged route (K5c in the epilogue, one launch), beside the
    split plain version and SDPA on the pre-gathered (for int8,
    pre-dequantized bf16) K/V with the causal offset mask."""
    ns = 8
    q, pools, table, start, lens = split_case(VERIFY_SHAPE, 650, quant)
    kw = dict(k_scale=pools.k_scale, v_scale=pools.v_scale)
    _, h, hkv, d, psz, nblk, starts, valid, c, _ = VERIFY_SHAPE
    one_pass = pa.flash_paged_prefill_quant if quant else pa.flash_paged_prefill
    sc = (pools.k_scale, pools.v_scale) if quant else ()
    got = one_pass(q, pools.k, pools.v, *sc, table, start, lens,
                   num_splits=ns)
    want = ref.paged_prefill_ref(q, pools.k, pools.v, table, start, lens,
                                 **kw)
    live = [b for b, v in enumerate(valid) if v]
    err = compare(got[live], want[live], BF16)   # the merged output's
    k_pool, v_pool = pools.k, pools.v
    if quant:
        k_pool = pools.k.to(BF16) * pools.k_scale[..., None].to(BF16)
        v_pool = pools.v.to(BF16) * pools.v_scale[..., None].to(BF16)
    k_dense = ref.gather_pages(k_pool, table)       # gathered once, untimed
    v_dense = ref.gather_pages(v_pool, table)
    kj = torch.arange(nblk * psz, device="cuda")
    qi = start[:, None] + torch.arange(c, device="cuda")
    mask = ((kj <= qi[..., None]) & (kj < lens[:, None, None]))[:, None]
    times = {"ms": timings[("verify", ns)][2],
             "plain_ms": time_ms(lambda: ref.paged_prefill_split_ref(
                 q, pools.k, pools.v, table, start, lens, ns, **kw,
                 block_q=pa.TC_TILE_ROWS // (h // hkv),
                 block_k=pa.TC_TILE_KEYS)),
             "library_ms": time_ms(
                 lambda: torch.nn.functional.scaled_dot_product_attention(
                     q, k_dense, v_dense, attn_mask=mask, enable_gqa=True))}
    # the merged route moves what K4 must (the partials stay in L2): K/V
    # once, q in and o out, the live table entries, start and kv_len
    n_bytes, n_ops = chunk_work(VERIFY_SHAPE, 1 if quant else 2,
                                4 if quant else 0)
    name = ("paged_prefill_split_quant_merged" if quant
            else "paged_prefill_split_merged")
    r = dict(row(name, PREFILL_SOURCE,
                 f"{FLASH}:{1239 if quant else 779}", err,
                 n_bytes, n_ops, times), merges=f"{FLASH}:315")
    phase1, combine, _, both = (t[0] for t in timings[("verify", ns)])
    k4 = timings.get(("verify", 1))
    print(f"[{16 if quant else 15} {'K6d' if quant else 'K5b'}] verify shape "
          f"(yi-6b B=5 H=32 Hkv=4 C=5 D=128 psz=16 nblk=64 starts "
          f"{starts}), 8 splits, device ms (ms per call incl. host): "
          f"merged (K5c in the epilogue, one launch) {fmt_times(times)}, "
          f"bound {r['bound_ms']:.5f} ms ({r['bound_by']}: K/V, q and o "
          f"once, the partials in L2); against phase 1 + standalone K5c "
          f"{both:.4f} ms timed together (apart: {phase1:.4f} + "
          f"{combine:.4f})"
          + (f"; K4's {k4[0][0]:.4f} ms in one pass" if k4 else "")
          + "; plain = the split plain version (both phases); library = "
          "SDPA with the causal-offset mask on the pre-gathered "
          + ("pre-dequantized bf16 " if quant else "") + "K/V (not timed: "
          "the gather)")
    return [r]


def phase_k5b() -> list[dict]:
    return split_rows(False, split_phase(False))


def phase_k6d() -> list[dict]:
    return split_rows(True, split_phase(True))


def count_draft_calls() -> tuple[dict, Callable[[], None]]:
    """Wrap ``Model.prefill`` and ``Model.decode_step`` to count the calls
    made on a draft model (config name ending in ``-draft``; a replay of
    the engine's compiled draft decode counts as its capture did); returns
    the counts and a function that restores the methods."""
    counts = collections.Counter({"prefill": 0, "decode_step": 0})
    compiled.EXTRA_TALLIES.append(counts)
    originals = {name: getattr(Model, name) for name in counts}

    def wrap(name):
        def method(self, *args, **kw):
            if self.cfg.name.endswith("-draft"):
                counts[name] += 1
            return originals[name](self, *args, **kw)
        return method

    for name in counts:
        setattr(Model, name, wrap(name))

    def restore():
        compiled.EXTRA_TALLIES.remove(counts)
        for name, fn in originals.items():
            setattr(Model, name, fn)
    return counts, restore


def self_draft_engine(model, params) -> ServingEngine:
    """The engine of serve (a) with a draft of all the target's layers."""
    draft = model.draft_model(depth_frac=1.0)
    return ServingEngine(
        model, params, n_lanes=SERVE["n_lanes"], max_len=SERVE["max_len"],
        cache="paged", page_size=16, prefill_chunk=128, draft_model=draft,
        draft_params=model.slice_draft_params(params, draft), spec_k=4,
        num_splits=8)


SPEC = dict(cache="paged", page_size=16, prefill_chunk=128, draft=True,
            spec_k=4, num_splits=8)


def spec_serve(what: str, n_draft: int, verify, prefill,
               run: Callable[..., tuple[dict, dict]] = serve_with_counts,
               n_layers: int = 32, **kw
               ) -> tuple[dict, dict[str, int], dict, dict]:
    """One speculative serve of the phase-5 requests (by ``run``, which
    returns the report and the launches) with the draft's calls and K2's
    kernels counted; checks every launch count (K5b / K6d with K5c in
    their epilogue once a layer a verify and no standalone K5c, the
    target's chunks, the draft's K1 and K2 once a draft layer a draft
    prefill and decode step) and that every arrival counter is back at 0.
    Returns the report, the launches, the draft calls and K2's routes."""
    drafts, restore = count_draft_calls()
    try:
        with kernels_by_route(ops, "flash_decode") as k2_routes:
            report, launches = run(**kw)
    finally:
        restore()
    verifies = report["spec"]["spec_ticks"]
    check(verifies > 0 and verifies == report["decode_steps"],
          f"{what}: {verifies} verify calls, {report['decode_steps']} ticks")
    for kernel, want in (
            (verify, n_layers * verifies),
            (prefill, n_layers * report["prefill_chunks"]),
            (fa.flash_attention, n_draft * drafts["prefill"]),
            (fa.flash_decode, n_draft * drafts["decode_step"])):
        check(launches[kernel.__name__] == want > 0,
              f"{what}: {kernel.__name__} launched "
              f"{launches[kernel.__name__]} times, expected {want}")
    only_launched(launches, (verify, prefill, fa.flash_attention,
                             fa.flash_decode), what)
    check(counters_zero(), f"{what}: an arrival counter is not 0")
    check(fa.flash_attention.last_kernel == fa.TC_KERNEL,
          f"{what}: the draft's K1 ran {fa.flash_attention.last_kernel}")
    check(dict(k2_routes) == {pa.DECODE_TC_KERNEL: launches["flash_decode"]},
          f"{what}: the draft's K2 launches by kernel {dict(k2_routes)}")
    check(verify.last_kernel == TC_KERNEL,
          f"{what}: {verify.__name__} ran {verify.last_kernel}")
    return report, launches, drafts, dict(k2_routes)


def phase_spec_prefix_serves(smi: str, paged: dict, int8_reports: dict,
                             model, params) -> tuple[dict[str, int], dict]:
    """Phase 17; returns the new kernels' launches and serve (a)'s report."""
    n_layers = 32
    lines, counts, abs_ = [], {}, []
    for label, kw, n_draft, verify, prefill in (
            ("(a) speculative, 8 splits", SPEC, 16,
             pa.paged_prefill_split_merged, pa.flash_paged_prefill),
            ("(b) speculative, int8, 8 splits", dict(SPEC, kv_dtype="int8"),
             16, pa.paged_prefill_split_quant_merged,
             pa.flash_paged_prefill_quant),
            ("(e) speculative, 8 splits, a draft of all 32 layers",
             dict(SPEC, engine=self_draft_engine(model, params)), n_layers,
             pa.paged_prefill_split_merged, pa.flash_paged_prefill)):
        what = f"serve {label}"
        with first_logits_and_tick() as firsts:
            report, launches, drafts, k2_routes = spec_serve(
                what, n_draft, verify, prefill, **kw)
        if "engine" not in kw:        # (a), (b): then eager
            abs_.append(eager_twin(
                f"17{label[1]} ({label[4:]})", (report, launches, firsts),
                model, params, run=functools.partial(
                    spec_serve, f"{what}, eager", n_draft, verify, prefill),
                **kw))
        if label.startswith("(a)"):
            spec_a = report
        spec, verifies = report["spec"], report["spec"]["spec_ticks"]
        if n_draft == n_layers:
            check(spec["accepted_tokens"] > 0,
                  f"{what}: the target as its own draft had no draft "
                  "token accepted")
        counts.setdefault(verify.__name__, launches[verify.__name__])
        other = int8_reports["int8, one pass"] if "int8" in label else paged
        emitted = report["generated_tokens"] - SERVE["n_requests"]
        lines.append(
            f"{label}: {report['tokens_per_s']:.1f} tok/s, p50 ttft "
            f"{report['p50_ttft_s']:.4f}s, p50 itl {report['p50_itl_s']:.4f}s,"
            f" {verifies} verify calls emitting {emitted / verifies:.2f} tokens"
            f" each (over the lanes), spec {json.dumps(spec)}, draft "
            f"prefills {drafts['prefill']}, draft decode steps "
            f"{drafts['decode_step']} (K2 by kernel {k2_routes}), "
            f"{report['prefill_chunks']} chunks, "
            f"launches { {k: n for k, n in launches.items() if n} }, greedy "
            f"tokens equal to the {'13b' if 'int8' in label else 'phase-9'} "
            f"serve's {greedy_agreement(report, other)}")
    reports = {}
    for cache in (True, False):
        report, launches = serve_with_counts(
            cache="paged", page_size=16, prefill_chunk=128,
            prefix_cache=cache, shared_prefix=256)
        what = f"the prefix-cache {'on' if cache else 'off'} serve"
        for kernel, want in ((pa.flash_paged_prefill,
                              n_layers * report["prefill_chunks"]),
                             (pa.flash_paged_decode,
                              n_layers * report["decode_steps"])):
            check(launches[kernel.__name__] == want > 0,
                  f"{what}: {kernel.__name__} launched "
                  f"{launches[kernel.__name__]} times, expected {want}")
        only_launched(launches, (pa.flash_paged_prefill,
                                 pa.flash_paged_decode), what)
        reports[cache] = report
    on, off = reports[True], reports[False]
    prompts = draw_prompts(ServeConfig(**SERVE, shared_prefix=256),
                           model.cfg.vocab_size)
    no_cache = sum(-(-len(p) // 128) for p in prompts)
    check(off["prefill_chunks"] == no_cache,
          f"cache off: {off['prefill_chunks']} chunks, expected {no_cache}")
    check(on["prefix_cache"]["hit_requests"] >= 1
          and on["cache"]["prefix"]["hits"] >= 1, "no prefix-cache hit")
    check(on["prefill_chunks"] < no_cache,
          f"the prefix cache saved no chunk: {on['prefill_chunks']} against "
          f"{no_cache}")
    for label, report in (("(c) prefix cache on", on),
                          ("(d) prefix cache off", off)):
        lines.append(
            f"{label}: {report['tokens_per_s']:.1f} tok/s, p50 ttft "
            f"{report['p50_ttft_s']:.4f}s, mean ttft "
            f"{report['mean_ttft_s']:.4f}s, p50 itl "
            f"{report['p50_itl_s']:.4f}s, {report['prefill_chunks']} chunks, "
            f"{report['decode_steps']} decode steps"
            + (f", prefix {json.dumps(report['cache']['prefix'])}, hit rate "
               f"{report['prefix_cache']['hit_rate']:.3f}, greedy tokens "
               f"equal to (d)'s {greedy_agreement(on, off)}"
               if report is on else ""))
    print(f"[17 speculative and prefix-cache serves] yi-6b full, pages of "
          f"16, chunks of 128, on {smi}: " + "; ".join(lines))
    print("[17 graphed against eager] " + " | ".join(abs_))
    return counts, spec_a


def phase_verify_logits(model, params,
                        tag: str = "[18 verify logits] yi-6b full") -> None:
    """Phase 10's prompt, then one verify of a 5-token chunk (the argmax
    continuation and 4 seeded tokens) in one pass and with 8 splits, over
    bf16 and int8 pools, through the kernels and the plain versions; and
    a one-token verify against the paged decode step on the kernels."""
    cfg = model.cfg
    psz, c, plen, max_len = 16, 128, 300, 320
    nblk = max_len // psz
    gen = torch.Generator(device="cuda").manual_seed(8)
    prompt = torch.randint(0, cfg.vocab_size, (1, plen), generator=gen,
                           device="cuda")
    table = (torch.randperm(nblk, generator=gen, device="cuda") + 1)
    table = table.to(torch.int32)[None]
    extra = torch.randint(0, cfg.vocab_size, (4,), generator=gen,
                          device="cuda")
    dev = lambda *x: torch.tensor(x, device="cuda")  # noqa: E731
    lines = []
    for quantized in (False, True):
        runs = {}
        for use_kernel in (False, True):
            caches = model.init_paged_caches(nblk + 1, psz, device="cuda",
                                             quantized=quantized)
            for start in range(0, plen, c):
                end = min(start + c, plen)
                chunk = torch.zeros((1, c), dtype=torch.long, device="cuda")
                chunk[0, :end - start] = prompt[0, start:end]
                logits, caches = model.paged_prefill_step(
                    params, caches, table, chunk, dev(start), dev(end),
                    dev(end - start - 1), use_kernel=use_kernel)
            if not use_kernel:
                first = int(logits[0].argmax())
            tokens = torch.cat([dev(first), extra])[None]
            for ns in (None, 8):
                runs[use_kernel, ns], caches = model.speculative_step(
                    params, caches, table, tokens, dev(plen), dev(plen + 5),
                    num_splits=ns, use_kernel=use_kernel)
            if use_kernel:
                one, caches = model.speculative_step(
                    params, caches, table, tokens[:, :1], dev(plen),
                    dev(plen + 1), num_splits=8, use_kernel=True)
                dec, caches = model.paged_decode_step(
                    params, caches, table, tokens[:, :1], dev(plen),
                    use_kernel=True)
        torch.cuda.synchronize()
        kind = "int8" if quantized else "bf16"
        for ns in (None, 8):
            lines.append(f"{kind} pools, {'8 splits' if ns else 'one pass'}: "
                         + check_logits(runs[False, ns][0, :, None],
                                        runs[True, ns][0, :, None],
                                        cfg.padded_vocab,
                                        f"{kind} verify logits"))
        lines.append(f"{kind} one-token verify vs paged decode step: "
                     + check_logits(dec[:, None], one[:, 0][:, None],
                                    cfg.padded_vocab,
                                    f"{kind} one-token verify"))
    print(f"{tag}, 300-token prompt as chunks of 128, "
          "then a verify of 5 tokens: " + "; ".join(lines))


# --------------------------------------------------------------------------
# the install path: K8 matmul, K7 fdm_stress, install-time AT, Sample 8
# --------------------------------------------------------------------------

MM_SOURCE = "src/repro_torch/kernels/csrc/matmul.cu"
FDM_SOURCE = "src/repro_torch/kernels/csrc/fdm_stress.cu"
MM_SHAPE = (512, 4096, 11008)        # yi-6b MLP projection, 512-token prefill
# float32 operations per grid point of the stress update (divisions
# counted as one): fused 54, split 57 (QG formed twice)
FDM_OPS = {"fused": 54, "split": 57}
FDM_ARRAYS = {"fused": 24, "split": 26}   # grid arrays read + written


def wgmma_instances() -> str:
    """The wgmma instances of K8: ptxas registers and spill stores from
    the build log, and the card's shared memory, ring stages and resident
    blocks per SM."""
    log = build.library_path("matmul").with_suffix(".log").read_text()
    ptxas = {}
    for chunk in log.split("Compiling entry function")[1:]:
        m = re.search(r"mm_bf16_wgmma_kernelILi(\d+)ELi(\d+)ELi(\d+)E",
                      chunk.split("\n", 1)[0])
        if m:
            regs = re.search(r"Used (\d+) registers", chunk)
            spill = re.search(r"(\d+) bytes spill stores", chunk)
            ptxas[tuple(map(int, m.groups()))] = (
                int(regs.group(1)) if regs else -1,
                int(spill.group(1)) if spill else 0)
    tiles = sorted(t for t in mmk.TILES if t[0] >= 64)
    check(sorted(ptxas) == tiles, f"wgmma instances in the ptxas log: "
          f"{sorted(ptxas)}, expected {tiles}")
    parts = []
    for t in tiles:
        card = mmk.wgmma_info(*t)
        check(card["blocks_per_sm"] >= 1 and card["smem_bytes"]
              == mmk.smem_bytes(*t), f"wgmma instance {t}: {card}")
        parts.append(f"{t} {ptxas[t][0]} registers, {ptxas[t][1]} B spill "
                     f"stores, {card['stages']} stages, {card['smem_bytes']} "
                     f"B shared, {card['blocks_per_sm']} block(s)/SM")
    return "; ".join(parts)


def phase_k8() -> dict:
    """K8 against its plain version; every bf16 tile timed at MM_SHAPE.
    Returns the row's numbers and the sweep's device ms by tile."""
    gen = torch.Generator(device="cuda").manual_seed(19)

    def operands(m, k, n, dtype):
        x = torch.randn((m, k), generator=gen, device="cuda") * k ** -0.5
        y = torch.randn((k, n), generator=gen, device="cuda")
        b = torch.randn((n,), generator=gen, device="cuda")
        return x.to(dtype), y.to(dtype), b.to(dtype)

    def run(x, y, tiles, *args, **kw):
        """K8 at ``tiles``; checks that the kernel the library reports
        launching is the one ``route`` names."""
        got = mmk.matmul(x, y, *args, block_m=tiles[0], block_n=tiles[1],
                         block_k=tiles[2], **kw)
        want = mmk.route(x.dtype, y.shape[1], x.shape[1], tiles,
                         x.data_ptr(), y.data_ptr())
        check((mmk.matmul.last_kernel, mmk.matmul.last_tiles) == want,
              f"K8 {tuple(x.shape)} @ {tuple(y.shape)} at {tiles} ran "
              f"{mmk.matmul.last_kernel} {mmk.matmul.last_tiles}, expected "
              f"{want}")
        return got

    errs = []
    # 200x328x136: aligned for TMA, ragged against every tile; 77x300x200
    # (K % 8) and 1x8x24 as well: the wgmma kernel takes the first and
    # the last, the mma.sync kernel the second (block_m 32)
    shapes = ((77, 300, 200), (128, 1024, 256), (1, 8, 24), (200, 328, 136))
    for dtype in (torch.float32, BF16):
        worst = 0.0
        for m, k, n in shapes:
            x, y, b = operands(m, k, n, dtype)
            for epilogue in mmk.EPILOGUES:
                for bias in (None, b):
                    for tiles in ((128, 128, 64), (32, 64, 32)):
                        worst = max(worst, compare(
                            run(x, y, tiles, bias, epilogue=epilogue),
                            ref.matmul_ref(x, y, bias, epilogue), dtype))
        for m, k, n in ((77, 300, 200), (200, 328, 136)):
            x, y, b = operands(m, k, n, dtype)
            want = ref.matmul_ref(x, y, b, "gelu")
            for tiles in sorted(mmk.TILES):
                worst = max(worst, compare(
                    run(x, y, tiles, b, epilogue="gelu"), want, dtype))
        for tiles in sorted(mmk.TILES):
            elem = 4 if dtype == torch.float32 else 2
            check(mmk.kernel_smem_bytes(dtype, *tiles)
                  == mmk.smem_bytes(*tiles, elem),
                  f"shared-memory formula differs from the kernel's at "
                  f"{tiles} {dtype}")
        errs.append(f"{dtype} {worst:.2e}")
    # float32 at the timing depth (K=4096): the kernel's and torch's fp32
    # sums against a float64 product, the kernel held to the fp32 tolerance
    x, y, _ = operands(512, 4096, 1000, torch.float32)
    exact = (x.double() @ y.double()).float()
    deep = (compare(mmk.matmul(x, y), exact, torch.float32),
            compare(torch.matmul(x, y), exact, torch.float32))
    errs.append(f"fp32 512x4096x1000 against float64: kernel {deep[0]:.2e}, "
                f"torch.matmul {deep[1]:.2e}")
    limit = mmk.smem_per_block_limit("cuda")
    print(f"[19 K8 matmul] max abs err vs plain over 4 shapes (77x300x200, "
          f"128x1024x256, 1x8x24, 200x328x136) x 4 epilogues x bias on/off "
          f"at tiles (128, 128, 64) and (32, 64, 32), and all "
          f"{len(mmk.TILES)} tiles at 77x300x200 and 200x328x136, each "
          f"launch on the kernel route() names (tol bf16 {TOL[BF16]}, "
          f"fp32 {TOL[torch.float32]}): " + "; ".join(errs)
          + f"; smem formula equal to the kernel's for every tile; "
          f"per-block shared-memory limit {limit} bytes")
    print(f"[19 K8 matmul] {mmk.WGMMA_KERNEL} instances (ptxas -v and the "
          f"card's occupancy): " + wgmma_instances())

    m, k, n = MM_SHAPE
    x, y, _ = operands(m, k, n, BF16)
    sweep = {}
    for tiles in sorted(mmk.TILES):
        run(x, y, tiles)
        check(tiles[0] < 64 or mmk.matmul.last_kernel == mmk.WGMMA_KERNEL,
              f"K8 at the yi-6b shape and {tiles} ran "
              f"{mmk.matmul.last_kernel}")
        kw = dict(block_m=tiles[0], block_n=tiles[1], block_k=tiles[2])
        sweep[tiles] = time_ms(lambda: mmk.matmul(x, y, **kw))[0]
    best = min(sweep, key=sweep.get)
    err = compare(run(x, y, best), ref.matmul_ref(x, y), BF16)
    n_bytes = 2 * (m * k + k * n + m * n)
    bound_ms, bound_by = bound(n_bytes, 2 * m * n * k, BF16)
    times = {"plain_ms": time_ms(lambda: ref.matmul_ref(x, y)),
             "library_ms": time_ms(lambda: torch.matmul(x, y))}
    order = sorted(sweep, key=sweep.get)
    print(f"[19 K8 matmul] M={m} K={k} N={n} bf16, device ms by tile "
          f"(bm, bn, bk), fastest first (block_m 64 and 128: "
          f"{mmk.WGMMA_KERNEL}; 32: {mmk.MMA_KERNEL}): "
          + ", ".join(f"{t} {sweep[t]:.4f}" for t in order)
          + "; " + ", ".join(f"{k} {d:.4f} ({c:.4f})"
                             for k, (d, c) in times.items())
          + f" (ms per call incl. host in brackets), bound {bound_ms:.4f} ms "
          f"({bound_by}); library = torch.matmul")
    row = {"name": "matmul", "route": "cuda", "source": MM_SOURCE,
           "replaces": "src/repro/kernels/matmul.py:111", "max_abs_err": err,
           "bound_ms": bound_ms, "bound_by": bound_by,
           **{k: d for k, (d, _) in times.items()}}
    return row, sweep


def load_example(name: str):
    """``examples/<name>.py`` of this checkout as a module."""
    spec = importlib.util.spec_from_file_location(
        name, Path(__file__).resolve().parent / "examples" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def phase_k7(sample) -> dict:
    """K7 fused and split against the plain version; both timed at 256^3
    over Sample 8's tiles.  The row carries the fastest fused tile."""
    errs, sweep = [], {}
    for shape in ((60, 50, 130), (256, 256, 256)):
        arrays, state = sample.fdm_grid(shape, "cuda", seed=20)
        want = ref.fdm_stress_ref(arrays, state, 0.1)
        worst = 0.0
        for variant in fk.VARIANTS:
            for tiles in sample.TILES:
                got = fk.fdm_stress(arrays, state, 0.1, variant=variant,
                                    bx=tiles[0], by=tiles[1], bz=tiles[2])
                worst = max(worst, max(compare(got[k], want[k],
                                               torch.float32)
                                       for k in fk.STATE))
        errs.append(f"{'x'.join(map(str, shape))} {worst:.2e}")
    # arrays, state, want are the 256^3 grid's
    points = 256 ** 3
    for variant in fk.VARIANTS:
        for tiles in sample.TILES:
            kw = dict(variant=variant, bx=tiles[0], by=tiles[1], bz=tiles[2])
            sweep[variant, tiles] = time_ms(
                lambda: fk.fdm_stress(arrays, state, 0.1, **kw))[0]
    bounds = {v: bound(4 * (FDM_ARRAYS[v] * points + 3 * 256),
                       FDM_OPS[v] * points, torch.float32)
              for v in fk.VARIANTS}
    plain = time_ms(lambda: ref.fdm_stress_ref(arrays, state, 0.1))
    best = min((key for key in sweep if key[0] == "fused"), key=sweep.get)
    err = max(compare(fk.fdm_stress(arrays, state, 0.1, bx=best[1][0],
                                    by=best[1][1], bz=best[1][2])[k],
                      want[k], torch.float32) for k in fk.STATE)
    print(f"[20 K7 fdm_stress] max abs err vs plain, fused and split over "
          f"tiles {sample.TILES} (tol fp32 {TOL[torch.float32]}): "
          + "; ".join(errs))
    print("[20 K7 fdm_stress] 256^3 float32, device ms by variant and tile: "
          + ", ".join(f"{v} {t} {ms:.4f}" for (v, t), ms in sweep.items())
          + "; bounds " + ", ".join(f"{v} {b:.4f} ms ({by})"
                                    for v, (b, by) in bounds.items())
          + f"; plain {plain[0]:.4f} ({plain[1]:.4f} per call incl. host); "
          f"library none (no one PyTorch call)")
    bound_ms, bound_by = bounds["fused"]
    return {"name": "fdm_stress", "route": "cuda", "source": FDM_SOURCE,
            "replaces": "src/repro/kernels/fdm_stress.py:139",
            "max_abs_err": err, "ms": sweep[best], "plain_ms": plain[0],
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


def phase_install(smi: str, sample, k1_sweep: dict
                  ) -> tuple[dict[str, int], tuple]:
    """Install-time AT of K8 and K1 on the card, ops.mm with K8's winner,
    the warm path, Sample 8 at both levels, and a dense serve whose K1
    launches all take FlashBlocks' winner; returns the launch counts of K8
    and K7 and K8's winner's tiles."""
    for kernel in KERNELS:
        kernel.launches = 0
    at.clear_published()
    m, k, n = MM_SHAPE
    workdir = tempfile.mkdtemp(prefix="oat_install_")
    timed = at.executors.get("cuda-event")
    trajectory = []

    def logged(region, bp_env):
        measure = timed(region, bp_env)

        def run(assignment):
            cost = measure(assignment)
            trajectory.append((dict(assignment), cost))
            return cost
        return run

    at.executors.register("cuda-event", logged, overwrite=True)
    try:
        session = at.AutoTuner(workdir)
        register_kernel_regions(session, m=m, n=n, k=k, **SSM_SHAPE)
        tuned = run_install_tuning(session, wall_clock=True)
    finally:
        at.executors.register("cuda-event", timed, overwrite=True)
    winner = tuned["MatmulBlocks"]
    tiles = (winner["block_m"], winner["block_n"], winner["block_k"])
    check(tiles in mmk.TILES, f"winner {tiles} is not an instantiated tile")
    check(session.executor_calls == len(trajectory) > 0,
          f"{session.executor_calls} evaluations, {len(trajectory)} timed")
    check(at.tuned("matmul") == winner, "the winner was not published")
    path = at.ATRecordStore(workdir).path
    with open(path) as f:
        records = [json.loads(line) for line in f if line.strip()]
    card = torch.cuda.get_device_name(0).replace(" ", "-").lower()
    check(any(r["region"] == "MatmulBlocks" and card in r["machine"]
              for r in records), f"no MatmulBlocks record names {card}")
    print(f"[21 install] MatmulBlocks at M={m} N={n} K={k} bf16, CUDA-event "
          f"executor (min of 10 launches), trajectory (bm, bn, bk) -> ms: "
          + ", ".join(f"({a['MatmulBlocks_BM']}, {a['MatmulBlocks_BN']}, "
                      f"{a['MatmulBlocks_BK']}) {c * 1e3:.4f}"
                      for a, c in trajectory if "MatmulBlocks_BM" in a)
          + f"; winner {winner}; record file {path}: {json.dumps(records)}")
    flash = [((a["FlashBlocks_BLOCK_Q"], a["FlashBlocks_BLOCK_K"]), c)
             for a, c in trajectory if "FlashBlocks_BLOCK_Q" in a]
    k1_tile = tuple(tuned["FlashBlocks"][k] for k in ("block_q", "block_k"))
    check(len(flash) == 4 and all(c < float("inf") for _, c in flash),
          f"FlashBlocks measured {flash}")
    check(k1_tile in fa.attention_tiles(BF16, 128)
          and at.tuned("flash_attention") == tuned["FlashBlocks"],
          f"FlashBlocks' winner {k1_tile} is not an instance or was not "
          "published")
    check(any(r["region"] == "FlashBlocks" and card in r["machine"]
              for r in records), f"no FlashBlocks record names {card}")
    best = min(k1_sweep, key=k1_sweep.get)
    print(f"[21 install] FlashBlocks at seq {SSM_SHAPE['seq']} d_head 128 "
          f"(yi-6b's 32 q / 4 kv heads, causal) bf16, CUDA-event executor "
          f"(min of 10 launches), 4 evaluations (ad-hoc: block_k, then "
          f"block_q), trajectory (block_q, block_k) -> ms: "
          + ", ".join(f"{t} {c * 1e3:.4f}" for t, c in flash)
          + f"; committed {k1_tile} (phase 3's sweep: {k1_sweep[k1_tile]:.4f}"
          f" ms there; its fastest {best} {k1_sweep[best]:.4f} ms)")

    gen = torch.Generator(device="cuda").manual_seed(21)
    x = (torch.randn((m, k), generator=gen, device="cuda") * k ** -0.5).to(BF16)
    y = torch.randn((k, n), generator=gen, device="cuda").to(BF16)
    before = mmk.matmul.launches
    out = ops.mm(x, y, epilogue="silu")
    err = compare(out, ref.matmul_ref(x, y, None, "silu"), BF16)
    want = mmk.route(BF16, n, k, tiles, x.data_ptr(), y.data_ptr())
    check(mmk.matmul.launches == before + 1
          and (mmk.matmul.last_kernel, mmk.matmul.last_tiles) == want,
          f"ops.mm launched {mmk.matmul.launches - before} times with "
          f"{mmk.matmul.last_kernel} {mmk.matmul.last_tiles}, expected once "
          f"with {want}")
    check(tiles[0] < 64 or mmk.matmul.last_kernel == mmk.WGMMA_KERNEL,
          f"the winner {tiles} ran {mmk.matmul.last_kernel}, not "
          f"{mmk.WGMMA_KERNEL}")

    again = at.AutoTuner(workdir)
    register_kernel_regions(again, m=m, n=n, k=k, **SSM_SHAPE)
    check(run_install_tuning(again, wall_clock=True) == tuned,
          "the second session loaded another winner")
    check(again.executor_calls == 0,
          f"the second session measured {again.executor_calls} times")
    check(again.ctx.store.entry("FlashBlocks_BLOCK_Q").value == k1_tile[0]
          and again.ctx.store.entry("FlashBlocks_BLOCK_K").value == k1_tile[1],
          "the second session loaded another FlashBlocks winner")
    print(f"[21 install] ops.mm launched K8 with the winner's tiles {tiles} "
          f"on {mmk.matmul.last_kernel} (max abs err vs plain {err:.2e}); a "
          f"second session on the "
          f"workdir warm-loaded {again.ctx.store.entry('MatmulBlocks_BM').value}"
          f"/{again.ctx.store.entry('MatmulBlocks_BN').value}/"
          f"{again.ctx.store.entry('MatmulBlocks_BK').value} with 0 "
          f"measurements, on {smi}")

    result = sample.main(["--device", "cuda"])
    check(result["level1"]["candidates"] == 8
          and result["level1"]["measured"] == 8, "Sample 8 level 1")
    check(len(result["level2"]["results"]) == 2 * len(sample.TILES),
          "Sample 8 level 2")
    torch.cuda.synchronize()
    launches = {kern.__name__: kern.launches for kern in KERNELS}
    only_launched(launches, (mmk.matmul, fk.fdm_stress, k9.selective_scan,
                             fa.flash_attention), "the install phase")
    check(launches["matmul"] > 0 and launches["fdm_stress"] > 0
          and launches["flash_attention"] > 0,
          f"the install phase launched {launches}")
    print(f"[21 install] Sample 8 level 1: winner #{result['level1']['winner'] + 1} "
          f"of 8; level 2 fastest {result['level2']['fastest']}; launches "
          f"{launches}")

    # a dense serve with the install-time tiles published: every K1 launch
    # at FlashBlocks' winner
    fa.flash_attention.by_tile.clear()
    report, serve_launches = serve_with_counts()
    k1_tiles = dict(fa.flash_attention.by_tile)
    check(k1_tiles == {k1_tile: 32 * SERVE["n_requests"]}
          == {k1_tile: serve_launches["flash_attention"]},
          f"the dense serve after install launched K1 by tile {k1_tiles}")
    print(f"[21 install] the phase-5 serve after install: "
          f"{report['tokens_per_s']:.1f} tok/s, K1 launches by tile "
          f"{k1_tiles}, on {smi}")
    at.clear_published()
    return {k: launches[k] for k in ("matmul", "fdm_stress")}, tiles



# --------------------------------------------------------------------------
# falcon-mamba-7b: K9 selective_scan, the Mamba-1 serve, SsmChunk
# --------------------------------------------------------------------------

SSM_SOURCE = "src/repro_torch/kernels/csrc/ssm_scan.cu"
FM = "falcon-mamba-7b"
FM_LAYERS = 64
# the SsmChunk region at falcon-mamba's prefill shape (phases 21 and 25)
SSM_SHAPE = dict(seq=512, d_inner=8192, d_state=16)


def ssm_case(bsz, length, di, n, seed, dtype):
    """x, dt (softplus, positive), a (-1 .. -N for every channel, as
    falcon-mamba's a_log gives), b, c, d (ones) on the card."""
    x = randn((bsz, length, di), seed, dtype)
    dt = torch.nn.functional.softplus(
        randn((bsz, length, di), seed + 1, torch.float32) - 2.0).to(dtype)
    a = -torch.arange(1, n + 1, dtype=torch.float32,
                      device="cuda").expand(di, n).contiguous()
    return (x, dt, a, randn((bsz, length, n), seed + 2, dtype),
            randn((bsz, length, n), seed + 3, dtype),
            torch.ones((di,), dtype=dtype, device="cuda"))


#: exp results an SM's special-function units give a clock (Hopper)
SFU_EXP_PER_CLOCK = 16


def exp_floor_ms(n_exp: float) -> tuple[float, str]:
    """The least time ``n_exp`` float32 exps take on the card's SFUs: 16 a
    clock an SM at the card's maximum SM clock (``nvidia-smi``'s
    ``clocks.max.sm``), and that clock for the record."""
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return (n_exp / (SFU_EXP_PER_CLOCK * sms * mhz * 1e6) * 1e3,
            f"{SFU_EXP_PER_CLOCK}/clock x {sms} SMs x {mhz:.0f} MHz")


def ssm_bound(bsz, length, di, n) -> tuple[float, str, str]:
    """K9's bound at bf16 inputs with the final state: the largest of its
    bytes over the HBM rate, its float32 operations over the float32 peak
    and its exps (one per (b, t, d, n) item) over the SFUs' rate; the
    exps are operations, so they bound it as "operations".  Returns (ms,
    bound_by, the three floors as text)."""
    n_bytes, n_ops = ssm_work(bsz, length, di, n, 2)
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_OPS_PER_S[torch.float32] * 1e3
    t_exp, rate = exp_floor_ms(bsz * length * di * n)
    text = (f"bytes {t_bytes:.5f} ms, float32 operations {t_ops:.5f} ms, "
            f"exps {t_exp:.5f} ms ({rate})")
    if t_bytes >= max(t_ops, t_exp):
        return t_bytes, "bytes", text
    return max(t_ops, t_exp), "operations", text


def ssm_work(bsz, length, di, n, elem: int) -> tuple[float, float]:
    """(bytes, float32 operations) of one scan with the final state: x, dt
    and y (B L Di each) and b, c (B L N each) in the input type, d, a and
    the final state; per (b, t, d, n) the exp, its product, two multiplies,
    an add and the C product and sum (6), per (b, t, d) D x + its add."""
    n_bytes = (elem * (3 * bsz * length * di + 2 * bsz * length * n + di)
               + 4 * di * n + 4 * bsz * di * n)
    return n_bytes, bsz * length * di * (6 * n + 2)


def phase_k9() -> tuple[dict, dict]:
    """K9 against its plain version over dtypes, ragged shapes, every
    chunk and both outputs; the chunk sweep timed at the prefill shape.
    Returns the row's numbers and the sweep's device ms by chunk."""
    # (label, B, L, Di, N, dtype)
    cases = [("fp32 reduced", 2, 96, 128, 8, torch.float32),
             ("fp32 ragged L and Di", 3, 90, 100, 16, torch.float32),
             ("bf16 ragged L", 2, 33, 256, 16, BF16),
             ("fp32 falcon-mamba width", 1, 300, 8192, 16, torch.float32),
             ("falcon-mamba B=1", 1, 512, 8192, 16, BF16),
             ("falcon-mamba B=4", 4, 512, 8192, 16, BF16)]
    errs = []
    for i, (label, b, length, di, n, dtype) in enumerate(cases):
        args = ssm_case(b, length, di, n, 220 + 10 * i, dtype)
        want_y, want_h = ref.selective_scan_ref(*args,
                                                return_final_state=True)
        worst = 0.0
        for chunk in CHUNK_VALUES:
            y, h = k9.selective_scan(*args, chunk=chunk,
                                     return_final_state=True)
            worst = max(worst, compare(y, want_y, dtype),
                        compare(h, want_h, dtype),
                        compare(k9.selective_scan(*args, chunk=chunk),
                                want_y, dtype))
        errs.append(f"{label} {worst:.2e}")
    for n in k9.STATES:
        for chunk in CHUNK_VALUES:
            for elem in (2, 4):
                check(k9.kernel_smem_bytes(n, chunk, elem)
                      == k9.smem_bytes(n, chunk, elem),
                      f"shared-memory formula differs from the kernel's at "
                      f"N={n} chunk={chunk} elem={elem}")
    print(f"[22 K9 selective_scan] max abs err vs plain over chunks "
          f"{CHUNK_VALUES}, y and final state, with and without the state "
          f"(tol bf16 {TOL[BF16]}, fp32 {TOL[torch.float32]}): "
          + "; ".join(errs) + "; smem formula equal to the kernel's")

    # timing at the main path's shape: one falcon-mamba prefill layer of
    # 512 tokens, with the final state
    b, length, di, n = 1, SSM_SHAPE["seq"], SSM_SHAPE["d_inner"], \
        SSM_SHAPE["d_state"]
    args = ssm_case(b, length, di, n, 290, BF16)
    sweep = {chunk: time_ms(lambda: k9.selective_scan(
        *args, chunk=chunk, return_final_state=True))[0]
        for chunk in CHUNK_VALUES}
    best = min(sweep, key=sweep.get)
    want = ref.selective_scan_ref(*args, return_final_state=True)
    got = k9.selective_scan(*args, chunk=best, return_final_state=True)
    err = max(compare(got[0], want[0], BF16), compare(got[1], want[1], BF16))
    bound_ms, bound_by, floors = ssm_bound(b, length, di, n)
    plain = time_ms(lambda: ref.selective_scan_ref(*args,
                                                   return_final_state=True))
    args4 = ssm_case(4, length, di, n, 295, BF16)
    b4 = time_ms(lambda: k9.selective_scan(*args4, chunk=best,
                                           return_final_state=True))
    bound4 = ssm_bound(4, length, di, n)
    print(f"[22 K9 selective_scan] falcon-mamba prefill layer B=1 L={length} "
          f"Di={di} N={n} bf16 with the final state, device ms by chunk: "
          + ", ".join(f"{c} {ms:.4f}" for c, ms in sweep.items())
          + f"; bound {bound_ms:.5f} ms ({bound_by}; the floors: {floors}); "
          f"plain {plain[0]:.4f} ({plain[1]:.4f} per call incl. host); "
          f"library none (no one PyTorch call); B=4 at chunk {best}: "
          f"{b4[0]:.4f} ms, bound {bound4[0]:.5f} ms ({bound4[1]}; "
          f"{bound4[2]})")
    return {"name": "selective_scan", "route": "cuda", "source": SSM_SOURCE,
            "replaces": "src/repro/kernels/ssm_scan.py:74",
            "max_abs_err": err, "ms": sweep[best], "plain_ms": plain[0],
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None}, sweep


def phase_fm_serve(smi: str) -> int:
    """falcon-mamba-7b at full width through ``serve_config`` on dense
    lanes; returns K9's launches."""
    report, launches = serve_with_counts(arch=FM)
    admissions = SERVE["n_requests"] + report["preemptions"]
    check(launches["selective_scan"] == FM_LAYERS * admissions,
          f"K9 launched {launches['selective_scan']} times, expected "
          f"{FM_LAYERS} x {admissions} admissions")
    only_launched(launches, (k9.selective_scan,), "the falcon-mamba serve")
    print(f"[23 serve] falcon-mamba-7b full (64 Mamba-1 layers, d_model "
          f"4096, d_inner 8192, d_state 16), 4 dense lanes: "
          f"{report['finished']}/{SERVE['n_requests']} requests, "
          f"{report['generated_tokens']} tokens in {report['wall_s']:.3f}s = "
          f"{report['tokens_per_s']:.1f} tok/s, ttft p50 "
          f"{report['p50_ttft_s']:.4f}s p99 {report['p99_ttft_s']:.4f}s, itl "
          f"p50 {report['p50_itl_s']:.4f}s p99 {report['p99_itl_s']:.4f}s, "
          f"{report['decode_steps']} decode steps, {admissions} admissions, "
          f"launches {launches}, lane state "
          f"{report['cache']['pool_bytes']} bytes, on {smi}")
    return launches["selective_scan"]


def phase_fm_logits(model, params) -> None:
    """A 300-token prompt, prefill + 4 decode steps at the full config,
    kernels against plain; and ``forward``'s last-position logits (one K9
    launch per layer, without the state) against prefill's."""
    cfg = model.cfg
    gen = torch.Generator(device="cuda").manual_seed(24)
    prompt = torch.randint(0, cfg.vocab_size, (1, 300), generator=gen,
                           device="cuda")
    tokens: list[int] = []
    runs = {}
    for use_kernel in (False, True):
        logits, caches = model.prefill(params, prompt, use_kernel=use_kernel)
        steps = [logits]
        for i in range(4):
            if not use_kernel:
                tokens.append(int(steps[-1][0].argmax()))
            logits, caches = model.decode_step(
                params, caches, torch.tensor([[tokens[i]]], device="cuda"),
                torch.tensor([prompt.shape[1] + i], device="cuda"),
                use_kernel=use_kernel)
            steps.append(logits)
        runs[use_kernel] = torch.stack(steps)
    before = k9.selective_scan.launches
    hidden, _ = model.forward(params, prompt)
    full = model.head_logits(params, hidden[:, -1])
    torch.cuda.synchronize()
    check(k9.selective_scan.launches == before + FM_LAYERS,
          f"forward launched K9 {k9.selective_scan.launches - before} times")
    print(f"[24 falcon-mamba logits] prefill 300 + 4 decode steps: "
          + check_logits(runs[False], runs[True], cfg.padded_vocab,
                         "falcon-mamba logits")
          + "; forward's last position against prefill's: "
          + check_logits(runs[True][:1], full[None], cfg.padded_vocab,
                         "forward logits"))


def phase_ssm_install(smi: str, sweep: dict) -> int:
    """Install-time AT of K9's chunk on the card in a fresh workdir; the
    d-spline fit beside the measured chunks; ops.ssm_scan with the winner;
    the warm path.  Returns the winner's chunk."""
    at.clear_published()
    m, k, n = MM_SHAPE
    workdir = tempfile.mkdtemp(prefix="oat_ssm_install_")
    timed = at.executors.get("cuda-event")
    trajectory = []

    def logged(region, bp_env):
        measure = timed(region, bp_env)

        def run(assignment):
            cost = measure(assignment)
            trajectory.append((dict(assignment), cost))
            return cost
        return run

    at.executors.register("cuda-event", logged, overwrite=True)
    try:
        session = at.AutoTuner(workdir)
        register_kernel_regions(session, m=m, n=n, k=k, **SSM_SHAPE)
        tuned = run_install_tuning(session, wall_clock=True)
    finally:
        at.executors.register("cuda-event", timed, overwrite=True)
    winner = tuned["SsmChunk"]["chunk"]
    check(winner in CHUNK_VALUES, f"winner {winner} is not a candidate")
    check(at.tuned("ssm_scan") == {"chunk": winner},
          "the winner was not published")
    measured = [(a["SsmChunk_CHUNK"], c) for a, c in trajectory
                if "SsmChunk_CHUNK" in a]
    check(len(measured) == 8 and all(c < float("inf") for _, c in measured),
          f"SsmChunk measured {measured}")
    xs = [float(x) for x, _ in measured]
    fit = fit_dspline(xs, [c for _, c in measured])(
        np.asarray(CHUNK_VALUES, dtype=np.float64))
    check(CHUNK_VALUES[int(fit.argmin())] == winner,
          "the winner is not the fit's minimum")
    path = at.ATRecordStore(workdir).path
    with open(path) as f:
        records = [json.loads(line) for line in f if line.strip()]
    card = torch.cuda.get_device_name(0).replace(" ", "-").lower()
    check(any(r["region"] == "SsmChunk" and card in r["machine"]
              for r in records), f"no SsmChunk record names {card}")
    print(f"[25 install] SsmChunk at seq {SSM_SHAPE['seq']} d_inner "
          f"{SSM_SHAPE['d_inner']} d_state {SSM_SHAPE['d_state']} bf16, "
          f"CUDA-event executor (min of 10 launches), measured chunk -> ms: "
          + ", ".join(f"{x} {c * 1e3:.4f}" for x, c in measured)
          + "; d-spline fit at the candidates: "
          + ", ".join(f"{x} {p * 1e3:.4f}" for x, p in zip(CHUNK_VALUES, fit))
          + f"; winner {winner} (phase 22's sweep: {sweep[winner]:.4f} ms "
          f"at the winner, fastest chunk {min(sweep, key=sweep.get)}); "
          f"record file {path}")

    b, length, di, n_state = 1, SSM_SHAPE["seq"], SSM_SHAPE["d_inner"], \
        SSM_SHAPE["d_state"]
    args = ssm_case(b, length, di, n_state, 250, BF16)
    before = k9.selective_scan.launches
    y, h = ops.ssm_scan(*args, return_final_state=True)
    want = ref.selective_scan_ref(*args, return_final_state=True)
    err = max(compare(y, want[0], BF16), compare(h, want[1], BF16))
    check(k9.selective_scan.launches == before + 1
          and k9.selective_scan.last_chunk == min(winner, length),
          f"ops.ssm_scan launched {k9.selective_scan.launches - before} "
          f"times with chunk {k9.selective_scan.last_chunk}, expected once "
          f"with {winner}")
    again = at.AutoTuner(workdir)
    register_kernel_regions(again, m=m, n=n, k=k, **SSM_SHAPE)
    check(run_install_tuning(again, wall_clock=True) == tuned,
          "the second session loaded another winner")
    check(again.executor_calls == 0,
          f"the second session measured {again.executor_calls} times")
    print(f"[25 install] ops.ssm_scan launched K9 with the winner's chunk "
          f"{winner} (max abs err vs plain {err:.2e}); a second session on "
          f"the workdir warm-loaded chunk "
          f"{again.ctx.store.entry('SsmChunk_CHUNK').value} with 0 "
          f"measurements, on {smi}")
    at.clear_published()
    return winner



# --------------------------------------------------------------------------
# phase 26: the HTTP/SSE gateway
# --------------------------------------------------------------------------


@contextlib.contextmanager
def gateway_knobs(**knobs):
    """``serve_config``'s gateway with other pipeline knobs: the serve
    module builds its ``PipelinedEngine`` by that name at each call."""
    pipelined = serve_mod.PipelinedEngine
    serve_mod.PipelinedEngine = functools.partial(
        pipelined, knobs=GatewayPolicyKnobs(**knobs))
    try:
        yield
    finally:
        serve_mod.PipelinedEngine = pipelined


def gateway_checks(what: str, report: dict, other: dict,
                   other_name: str) -> dict:
    """Every stream ended in ``done`` (``serve_with_counts`` checked the
    32 tokens) and the greedy tokens equal ``other``'s; returns the
    gateway report."""
    g = report["gateway"]
    check(g["streams"] == {"done": SERVE["n_requests"]},
          f"{what}: the streams ended {g['streams']}")
    check(g["cancelled"] == 0 and g["cancels"] == 0,
          f"{what}: {g['cancels']} cancels")
    check(report["outputs"] == other["outputs"],
          f"{what}: greedy tokens differ from {other_name}'s, "
          f"{greedy_agreement(report, other)} equal")
    return g


def gateway_line(label: str, report: dict) -> str:
    def ms(x):
        return f"{x * 1e3:.1f}" if x is not None else "n/a"

    g = report["gateway"]
    per_tick = {k: v / g["ticks"] for k, v in g["host_ms"].items()}
    return (
        f"{label}: {report['tokens_per_s']:.1f} tok/s, ttft p50 "
        f"{ms(report['p50_ttft_s'])} p99 {ms(report['p99_ttft_s'])} ms, itl "
        f"p50 {ms(report['p50_itl_s'])} p99 {ms(report['p99_itl_s'])} ms, "
        f"queue wait p50 {ms(report['p50_queue_wait_s'])} p99 "
        f"{ms(report['p99_queue_wait_s'])} ms, goodput "
        f"{g['goodput_tok_s']:.1f} tok/s (SLO {g['slo_attainment']:.3f}: "
        f"ttft {g['slo_ttft_s']} s, itl {g['slo_itl_s']} s), {g['ticks']} "
        f"ticks, {g['overlapped_ticks']} overlapped, host ms a tick: "
        f"schedule+dispatch {per_tick['schedule_dispatch']:.2f}, wait "
        f"{per_tick['wait']:.2f}, emit {per_tick['emit']:.2f}, policy "
        f"{g['policy']}, wall {g['wall_s']:.3f} s")


def gateway_backpressure(smi: str, paged: dict) -> str:
    """(d): phase 9's engine behind a gateway whose queue holds 2, the
    eight phase-5 clients at once plus a ninth (prompt 0 again) that hangs
    up after two token frames; a bounced client waits ``Retry-After``
    and tries again."""
    model = build_model(get_arch("yi-6b"))
    engine = ServingEngine(model, model.init(0, "cuda"),
                           n_lanes=SERVE["n_lanes"], max_len=SERVE["max_len"],
                           cache="paged", page_size=16, prefill_chunk=128)
    prompts = draw_prompts(ServeConfig(**SERVE), model.cfg.vocab_size)
    max_new = SERVE["max_new"]

    async def client(port: int, prompt: list[int], disconnect_after=None):
        tokens, bounced = [], 0
        while True:
            final = None
            async for kind, payload in sse_generate(
                    "127.0.0.1", port, prompt, max_new_tokens=max_new,
                    disconnect_after=disconnect_after):
                if kind == "tokens":
                    tokens.extend(payload)
                else:
                    final = (kind, payload)
            if final and final[0] == "http_error" \
                    and final[1]["status"] == 429:
                bounced += 1
                await asyncio.sleep(float(final[1]["retry_after"]))
                continue
            return tokens, bounced, final

    async def run():
        pipe = PipelinedEngine(engine, queue_limit=2)
        srv = GatewayServer(pipe)
        await srv.start()
        t0 = time.monotonic()
        results = await asyncio.gather(
            *[client(srv.port, p) for p in prompts],
            client(srv.port, prompts[0], disconnect_after=2))
        wall = time.monotonic() - t0
        await srv.drain()
        return pipe, results, wall

    pipe, results, wall = asyncio.run(run())
    torch.cuda.synchronize()
    what = "gateway (d)"
    check(pipe._loop_error is None, f"{what}: the loop failed: "
          f"{pipe._loop_error!r}")
    *served, (hung_up, hung_bounces, hung_final) = results
    bounces = sum(r[1] for r in results)
    check(pipe.rejected >= 1 and bounces == pipe.rejected,
          f"{what}: {pipe.rejected} 429s served, {bounces} retried")
    check(pipe.cancels == 1 and len(engine.cancelled) == 1,
          f"{what}: {pipe.cancels} cancels, {len(engine.cancelled)} "
          "cancelled requests")
    check(hung_final is None and len(hung_up) >= 2,
          f"{what}: the hanging-up client got {len(hung_up)} tokens and "
          f"{hung_final}")
    check(all(final and final[0] == "done" and len(tokens) == max_new
              for tokens, _, final in served),
          f"{what}: streams ended {[r[2] and r[2][0] for r in served]}")
    check(len(engine.finished) == SERVE["n_requests"],
          f"{what}: {len(engine.finished)} requests finished")
    kv = engine.kv.stats()
    check(kv["used_pages"] == 0 and kv["used_pages"] + kv["free_pages"]
          + kv["cached_pages"] == kv["n_pages"] - 1,
          f"{what}: the pool after the serve {json.dumps(kv)}")
    same = sum(a == b for i, (tokens, _, _) in enumerate(served)
               for a, b in zip(tokens, paged["outputs"][i]))
    summary = engine.metrics.summary()
    del engine, model
    torch.cuda.empty_cache()
    return (f"(d) queue limit 2, 8 clients + 1 hanging up after 2 frames: "
            f"{pipe.rejected} 429s served, all retried ({pipe.ticks} ticks, "
            f"{pipe.overlapped_ticks} overlapped, wall {wall:.3f} s), "
            f"{pipe.cancels} cancel after {len(hung_up)} tokens (the "
            f"hanging-up client bounced {hung_bounces} times), 8/8 done "
            f"with 32 tokens, queue wait p50 "
            f"{summary['queue_wait_s']['p50'] * 1e3:.1f} p99 "
            f"{summary['queue_wait_s']['p99'] * 1e3:.1f} ms, greedy tokens "
            f"equal to phase 9's (reported) {same}/{8 * max_new}, pool "
            f"used {kv['used_pages']} free {kv['free_pages']} cached "
            f"{kv['cached_pages']} of {kv['n_pages']}")


def phase_gateway(smi: str, paged: dict, spec_a: dict) -> None:
    """Phase 26: the phase-5 requests through ``serve_config(gateway=True)``
    at yi-6b's full width, each a TCP client of 127.0.0.1 streaming SSE:
    (a) phase 9's paged config at the default knobs, (b) at
    ``max_inflight`` 1, (c) phase 17a's speculative config; greedy tokens
    equal to the synchronous serves', the launch counts exact; (d)
    backpressure and a disconnect."""
    t0 = time.perf_counter()
    n_layers = 32
    paged_kw = dict(cache="paged", page_size=16, prefill_chunk=128,
                    gateway=True)
    lines = []
    for label, knobs in (("(a) paged, max_inflight 2, admit_batch 4", {}),
                         ("(b) paged, max_inflight 1",
                          {"max_inflight": 1})):
        what = f"gateway {label[:3]}"
        # by prompt alone: a gateway's first tick holds the lanes its
        # clients' arrivals filled
        with gateway_knobs(**knobs), first_logits_by_prompt() as firsts:
            report, launches = serve_with_counts(**paged_kw)
        if not knobs:                 # (a): then eager, on the same weights
            model = build_model(get_arch("yi-6b"))
            params = model.init(0, "cuda")
            with gateway_knobs():
                ab = eager_twin("26a", (report, launches, firsts), model,
                                params, probe=first_logits_by_prompt,
                                **paged_kw)
            del model, params
        g = gateway_checks(what, report, paged, "phase 9")
        check(g["policy"]["max_inflight"] == knobs.get("max_inflight", 2),
              f"{what}: knobs {g['policy']}")
        for kernel, want in (
                (pa.flash_paged_prefill, n_layers * report["prefill_chunks"]),
                (pa.flash_paged_decode, n_layers * report["decode_steps"])):
            check(launches[kernel.__name__] == want > 0,
                  f"{what}: {kernel.__name__} launched "
                  f"{launches[kernel.__name__]} times, expected {want}")
        only_launched(launches, (pa.flash_paged_prefill,
                                 pa.flash_paged_decode), what)
        check(pa.flash_paged_prefill.last_kernel == TC_KERNEL,
              f"{what}: K4 ran {pa.flash_paged_prefill.last_kernel}")
        check(pa.flash_paged_decode.last_kernel == pa.DECODE_TC_KERNEL,
              f"{what}: K3 ran {pa.flash_paged_decode.last_kernel}")
        check((g["overlapped_ticks"] > 0) == (not knobs),
              f"{what}: {g['overlapped_ticks']} overlapped ticks")
        lines.append(gateway_line(label, report) + f", {report['prefill_chunks']}"
                     f" chunks, {report['decode_steps']} decode steps, launches "
                     f"{ {k: n for k, n in launches.items() if n} }")
    report, launches, drafts, k2_routes = spec_serve(
        "gateway (c)", 16, pa.paged_prefill_split_merged,
        pa.flash_paged_prefill, **SPEC, gateway=True)
    gateway_checks("gateway (c)", report, spec_a, "phase 17a")
    lines.append(gateway_line("(c) speculative, 8 splits", report)
                 + f", {report['spec']['spec_ticks']} verify calls, draft "
                 f"prefills {drafts['prefill']}, draft decode steps "
                 f"{drafts['decode_step']} (K2 by kernel {k2_routes}), "
                 f"launches { {k: n for k, n in launches.items() if n} }")
    lines.append(gateway_backpressure(smi, paged))
    lines.append(f"graphed against eager: {ab}")
    print(f"[26 gateway] yi-6b full, pages of 16, chunks of 128, 8 requests "
          f"of 32 tokens as TCP clients of 127.0.0.1, in "
          f"{time.perf_counter() - t0:.1f}s, on {smi}: " + "; ".join(lines))


# --------------------------------------------------------------------------
# phase 27: run-time AT on the card
# --------------------------------------------------------------------------

TILED = (fa.flash_decode, pa.flash_paged_decode, pa.flash_paged_decode_quant,
         pa.paged_decode_split_merged, pa.paged_decode_split_quant_merged,
         pa.flash_paged_prefill, pa.flash_paged_prefill_quant,
         pa.paged_prefill_split_merged, pa.paged_prefill_split_quant_merged)


def tile_sweep() -> list[str]:
    """Phase 27(a): every new instance at the main path's shapes against
    plain, timed (CUDA events, L2 flushed): the decode kernel as K3, K6a
    (yi-6b's four lanes), K2 (dense S 1024) and merged K5a and K6b at 8
    splits; the prefill kernel as K4 and K6c (the phase-8 chunk) and
    merged K5b and K6d at 8 splits on the verify shape."""
    lines = []
    b, h, hkv, d, psz, nblk = 4, 32, 4, 128, 16, 64
    kv_len = [839, 720, 190, 544]
    q, kp, vp, table, lens = paged_case(b, h, hkv, d, psz, nblk, kv_len,
                                        BF16, 2700)
    (k8, ks), (v8, vs) = quantize_int8_rows(kp), quantize_int8_rows(vp)
    dk = randn((b, hkv, 1024, d), 2701, BF16)
    dv = randn((b, hkv, 1024, d), 2702, BF16)
    dlens = torch.tensor([1024, 517, 33, 300], dtype=torch.int32,
                         device="cuda")
    plain = {"fp": ref.paged_decode_ref(q, kp, vp, table, lens),
             "int8": ref.paged_decode_ref(q, k8, v8, table, lens, k_scale=ks,
                                          v_scale=vs),
             "dense": ref.decode_ref(q, dk, dv, dlens)}
    modes = {
        "K3": (lambda bk: pa.flash_paged_decode(q, kp, vp, table, lens,
                                                block_k=bk), "fp"),
        "K6a": (lambda bk: pa.flash_paged_decode_quant(
            q, k8, v8, ks, vs, table, lens, block_k=bk), "int8"),
        "K2": (lambda bk: fa.flash_decode(q, dk, dv, dlens, block_k=bk),
               "dense"),
        "K5a+K5c ns=8": (lambda bk: pa.paged_decode_split_merged(
            q, kp, vp, table, lens, 8, block_k=bk), "fp"),
        "K6b+K5c ns=8": (lambda bk: pa.paged_decode_split_quant_merged(
            q, k8, v8, ks, vs, table, lens, 8, block_k=bk), "int8")}
    for label, (fn, want) in modes.items():
        cells = []
        for bk in pa.DECODE_BLOCK_KS:
            err = compare(fn(bk), plain[want], BF16)
            cells.append(f"{bk}: {time_ms(lambda: fn(bk))[0]:.4f} ms "
                         f"(err {err:.2e})")
        lines.append(f"decode {label} block_k -> " + ", ".join(cells))
    check(counters_zero(), "tile sweep: an arrival counter is not 0")
    tiles = [(bq, bk) for bq in pa.prefill_tiles(BF16, 128, 8)[0]
             for bk in pa.TC_BLOCK_KS]
    for shape, kinds in ((CHUNK_SHAPE, ("K4", "K6c")),
                         (VERIFY_SHAPE, ("K5b+K5c ns=8", "K6d+K5c ns=8"))):
        for kind in kinds:
            quant = kind.startswith("K6")
            q2, pools, table2, start2, lens2 = split_case(shape, 2710, quant)
            ns = 8 if "ns=8" in kind else 1
            want = ref.paged_prefill_ref(q2, pools.k, pools.v, table2,
                                         start2, lens2, k_scale=pools.k_scale,
                                         v_scale=pools.v_scale)
            valid = shape[7]
            cells = []
            for bq, bk in tiles:
                def run(bq=bq, bk=bk):
                    return ops.paged_prefill(q2, pools, table2, start2, lens2,
                                             num_splits=ns, block_q=bq,
                                             block_k=bk)
                got = run()
                err = max(compare(got[i, :, :n], want[i, :, :n], BF16)
                          for i, n in enumerate(valid) if n)
                cells.append(f"({bq}, {bk}): {time_ms(run)[0]:.4f} ms "
                             f"(err {err:.2e})")
            lines.append(f"prefill {kind} at {shape[0]} (block_q, block_k) "
                         f"-> " + ", ".join(cells))
    check(counters_zero(), "tile sweep: an arrival counter is not 0")
    return lines


def tuned_serve(model, params, workdir: str, **kw) -> tuple[dict, dict]:
    """One serve of the phase-5 requests at yi-6b's full width with
    run-time AT in ``workdir``, every launch counter and tile count zeroed
    just before and read just after; every request must finish with its
    32 tokens.  Returns the report and {wrapper: {tile: launches}}."""
    at.clear_published()
    for kernel in KERNELS:
        kernel.launches = 0
    for kernel in TILED:
        kernel.by_tile.clear()
    scfg = ServeConfig(**{**SERVE, **kw, "autotune": True,
                          "workdir": workdir})
    report = serve_mod.serve_model(model, params, scfg)
    torch.cuda.synchronize()
    at.clear_published()
    check(report["finished"] == SERVE["n_requests"]
          and all(len(t) == SERVE["max_new"]
                  for t in report["outputs"].values()),
          f"tuned serve {kw}: {report['finished']} requests finished")
    check(counters_zero(), f"tuned serve {kw}: an arrival counter is not 0")
    by_tile = {k.__name__: dict(k.by_tile) for k in TILED if k.by_tile}
    return report, by_tile


def region_lines(a: dict) -> list[str]:
    """Per measured region: each candidate's cost, the waits for the
    device, and what committed."""
    return [f"{name}: " + ", ".join(f"{lab} {c * 1e3:.2f} ms"
                                    for lab, c in costs.items())
            + f" (waited {a['waits'].get(name, 0)})"
            for name, costs in a["costs"].items()]


def check_cold(what: str, report: dict, by_tile: dict, families) -> dict:
    """A cold tuned serve: the regions of ``families`` measured, each
    measured candidate of the decode, prefill and verify regions waited
    for the device, every measured region committed."""
    a = report["autotune"]
    kinds = {name.split("_")[0] for name in a["measured_regions"]}
    check(set(families) <= kinds,
          f"{what}: measured {a['measured_regions']}, expected {families}")
    for name, costs in a["costs"].items():
        if name.split("_")[0] in ("DecodeBucket", "PrefillBucket",
                                  "SpecBucket"):
            check(a["waits"].get(name) == len(costs),
                  f"{what}: {name} measured {len(costs)} candidates, "
                  f"{a['waits'].get(name)} waited for the device")
    check(a["measurements"] == sum(len(c) for c in a["costs"].values()),
          f"{what}: measurements {a['measurements']}")
    check(by_tile, f"{what}: no tiled kernel launched")
    return a


def phase_autotune(smi: str, paged: dict, spec_a: dict) -> None:
    """Phase 27: run-time AT on the card.  (a) the tile sweep; (b) a cold
    tuned serve of phase 9's config in a fresh workdir, then a warm one in
    the same workdir, which must measure nothing; (c) phase 17a's
    speculative config, ``--kv-dtype auto`` and the gateway, tuned."""
    t0 = time.perf_counter()
    lines = tile_sweep()
    print(f"[27a tile sweep] yi-6b shapes, bf16, device ms (CUDA events, L2 "
          f"flushed), max abs err vs plain (tol {TOL[BF16]}), on {smi}: "
          + "; ".join(lines))
    model = build_model(get_arch("yi-6b"))
    params = model.init(0, "cuda")
    n_layers = 32
    paged_kw = dict(cache="paged", page_size=16, prefill_chunk=128)
    with tempfile.TemporaryDirectory() as wd:
        cold, cold_tiles = tuned_serve(model, params, wd, **paged_kw)
        a = check_cold("27b cold", cold, cold_tiles,
                       ("DecodeBucket", "PrefillBucket"))
        decode = (cold_tiles.get("flash_paged_decode", {}),
                  cold_tiles.get("paged_decode_split_merged", {}))
        check(sum(decode[0].values()) + sum(decode[1].values())
              == n_layers * cold["decode_steps"],
              f"27b cold: decode launches by tile {cold_tiles}, "
              f"{cold['decode_steps']} steps")
        for name, costs in a["costs"].items():
            for label in costs:
                pp = dict(kv.split("=") for kv in label.split(","))
                if name.startswith("DecodeBucket"):
                    route = decode[int(pp["num_splits"]) > 1]
                    check(route.get(int(pp["block_k"]), 0) >= n_layers,
                          f"27b cold: candidate {label} of {name} has no "
                          f"launches at its tile: {cold_tiles}")
                elif name.startswith("PrefillBucket"):
                    tile = (int(pp["block_q"]), int(pp["block_k"]))
                    check(cold_tiles.get("flash_paged_prefill", {}).get(
                        tile, 0)
                          >= n_layers, f"27b cold: candidate {label} of "
                          f"{name} has no launches: {cold_tiles}")
        warm, warm_tiles = tuned_serve(model, params, wd, **paged_kw)
        w = warm["autotune"]
        check(w["executor_calls"] == 0 and w["measurements"] == 0
              and not w["measured_regions"] and not w["waits"],
              f"27b warm: {w['measurements']} measurements in "
              f"{w['measured_regions']}")
        check(set(a["measured_regions"]) <= set(w["warm_regions"]),
              f"27b warm: warm-loaded {w['warm_regions']}, cold measured "
              f"{a['measured_regions']}")
        check(w["committed"] == a["committed"],
              "27b warm: committed parameters differ from the cold serve's")
    print(f"[27b tuned serve] yi-6b full, pages of 16, chunks of 128, "
          f"8 requests of 32 tokens, on {smi}: cold {cold['tokens_per_s']:.1f} "
          f"tok/s, {a['measurements']} measurements in "
          f"{len(a['measured_regions'])} regions: "
          + "; ".join(region_lines(a))
          + f"; committed {json.dumps(a['committed'], default=str)}; "
          f"launches by tile {cold_tiles}; greedy tokens equal to phase 9's "
          f"(reported: a tile changes bf16 rounding) "
          f"{greedy_agreement(cold, paged)}.  Warm: "
          f"{warm['tokens_per_s']:.1f} tok/s, executor_calls "
          f"{w['executor_calls']}, measurements {w['measurements']}, "
          f"{len(w['warm_regions'])} regions warm-loaded, launches by tile "
          f"{warm_tiles}, greedy tokens equal to phase 9's "
          f"{greedy_agreement(warm, paged)}, to the cold serve's "
          f"{greedy_agreement(warm, cold)}")
    with tempfile.TemporaryDirectory() as wd:
        spec, spec_tiles = tuned_serve(model, params, wd, **SPEC)
        sa = check_cold("27c spec", spec, spec_tiles, ("SpecBucket",))
        committed_spec = {b: pp for b, pp in sa["committed"]["spec"].items()
                          if pp is not None}
        check(committed_spec, "27c spec: no SpecBucket committed")
    with tempfile.TemporaryDirectory() as wd:
        auto, auto_tiles = tuned_serve(model, params, wd, kv_dtype="auto",
                                       **paged_kw)
        kv = auto["autotune"]["committed"]["kv_precision"]
        check(all(v is not None for v in kv.values()),
              f"27c kv auto: KVPrecision committed {kv}")
        env = {name: costs for name, costs in auto["autotune"]["costs"].items()
               if name.startswith("KVPrecision")}
    with tempfile.TemporaryDirectory() as wd:
        gate, gate_tiles = tuned_serve(model, params, wd, gateway=True,
                                       policy_window=1, **paged_kw)
        g = gate["gateway"]
        check(g["streams"] == {"done": SERVE["n_requests"]},
              f"27c gateway: streams {g['streams']}")
        check(g["policy"].get("committed") is not None,
              f"27c gateway: GatewayPolicy did not commit: {g['policy']}")
    print(f"[27c tuned serves] on {smi}: speculative (17a, 8 splits) "
          f"{spec['tokens_per_s']:.1f} tok/s, "
          + "; ".join(region_lines(sa)) + f", SpecBucket committed "
          f"{committed_spec}, launches by tile {spec_tiles}, greedy tokens "
          f"equal to 17a's {greedy_agreement(spec, spec_a)}; kv auto: "
          f"KVPrecision committed {kv}, candidates' wall ms "
          f"{ {n: {k: round(v * 1e3, 2) for k, v in c.items()} for n, c in env.items()} }"
          f", agreement {auto_agreements(auto)}, resolved pool "
          f"{auto['kv_dtype']}, {auto['tokens_per_s']:.1f} tok/s, greedy "
          f"tokens equal to phase 9's {greedy_agreement(auto, paged)}; "
          f"gateway {gate['tokens_per_s']:.1f} tok/s, {g['policy']['windows']}"
          f" windows, GatewayPolicy committed {g['policy']['committed']}; "
          f"phase 27 in {time.perf_counter() - t0:.1f}s")
    del model, params
    torch.cuda.empty_cache()


def auto_agreements(report: dict) -> dict:
    """The greedy-agreement values the KVPrecision candidates reported."""
    return {name: {lab: env.get("agreement") for lab, env in cands.items()}
            for name, cands in report["autotune"]["reported"].items()
            if name.startswith("KVPrecision")}


# --------------------------------------------------------------------------
# phase 28: phi4-mini-3.8b at published widths (G 3: the 48-row tile)
# --------------------------------------------------------------------------

PHI4 = "phi4-mini-3.8b"
# phi4-mini's verify and chunk shapes (24 q / 8 kv heads), as the yi-6b
# ones of SPLIT_CASES
PHI4_VERIFY = ("phi4-mini verify", 24, 8, 128, 16, 64,
               [839, 720, 190, 544, 0], [5, 5, 5, 5, 0], 5, BF16)
PHI4_CHUNK = ("phi4-mini chunk at 384", 24, 8, 128, 16, 32, [384], [128],
              128, BF16)
# the wrappers whose launches phase 28 counts by tile
PHI4_TILED = TILED + (fa.flash_attention,)


def model_serve(model, params, by_tile: dict, tile=None, **kw
                ) -> tuple[dict, dict[str, int]]:
    """One serve of the phase-5 requests on a model built once (phi4-mini,
    moonshot), its launch and tile counters zeroed just before and read just
    after, the launches by tile stored in ``by_tile`` ({wrapper:
    Counter}); with ``tile`` the prefill and verify tile (block_q,
    block_k) is published for the serve, as the run-time AT's
    PrefillBucket and SpecBucket publish theirs."""
    at.clear_published()
    for kernel in KERNELS:
        kernel.launches = 0
    for kernel in PHI4_TILED:
        kernel.by_tile.clear()
    fa.flash_attention.last_kernel = fa.flash_decode.last_kernel = None
    if tile is not None:
        for key in ("flash_paged_prefill", "flash_paged_verify"):
            at.publish(key, block_q=tile[0], block_k=tile[1])
    try:
        report = serve_mod.serve_model(
            model, params,
            ServeConfig(**{**SERVE, "arch": model.cfg.name, **kw}))
        torch.cuda.synchronize()
    finally:
        at.clear_published()
    launches = {k.__name__: k.launches for k in KERNELS}
    for kernel in PHI4_TILED:
        by_tile[kernel.__name__] = collections.Counter(kernel.by_tile)
    check(report["finished"] == SERVE["n_requests"]
          and all(len(t) == SERVE["max_new"]
                  for t in report["outputs"].values()),
          f"{model.cfg.name} serve {kw}: {report['finished']} requests "
          "finished")
    check(counters_zero(),
          f"{model.cfg.name} serve {kw}: an arrival counter is not 0")
    return report, launches


def serve_line(label: str, report: dict, launches: dict, seen: dict) -> str:
    return (f"{label}: {report['tokens_per_s']:.1f} tok/s, p50 ttft "
            f"{report['p50_ttft_s']:.4f}s, p50 itl "
            f"{report['p50_itl_s']:.4f}s, {report['prefill_chunks']} chunks, "
            f"{report['decode_steps']} ticks, launches { {k: n for k, n in launches.items() if n} }, "
            f"by tile { {k: dict(v) for k, v in seen.items() if v} }")


def dense_arch_serves(model, params, smi: str, tag: str, title: str,
                      default: tuple[int, int], spec_tiles: tuple = (),
                      every_paged_mode: bool = False) -> dict:
    """The serves of an attention arch at published widths (phase 28:
    phi4-mini, phase 34: pixtral-12b), ``tag`` naming it in the checks:
    (a) dense lanes (K1, K2), (b) the paged pool in chunks of 128 (K4 at
    the prefill kernel's ``default`` tile, K3), (c) int8 pages at 8 splits
    (K6c, K6b with K5c merged), with ``every_paged_mode`` also (c1) int8
    pages in one pass (K6a) and (c2) bf16 pages at 8 splits (K5a with K5c
    merged), (d) and (e) speculative decoding with a self-draft of half
    the layers at 8 splits over bf16 and int8 pages, then the same at each
    tile of ``spec_tiles`` ((f), (g), ...).  Prints
    one line under ``title`` and returns the launches by tile of every
    tiled wrapper over all of them."""
    n_layers = model.cfg.n_layers
    tallies: list[dict] = []          # each serve's launches by tile

    def tally() -> dict:
        tallies.append({})
        return tallies[-1]

    lines = []
    # (a) dense lanes: K1 at G 3, K2
    seen = tally()
    with kernels_by_route(ops, "flash_decode") as k2_routes:
        report, launches = model_serve(model, params, seen)
    only_launched(launches, (fa.flash_attention, fa.flash_decode),
                  f"{tag} (a) dense")
    check(launches["flash_attention"] == n_layers * SERVE["n_requests"]
          and fa.flash_attention.last_kernel == fa.TC_KERNEL,
          f"{tag} (a): K1 launched {launches['flash_attention']} times on "
          f"{fa.flash_attention.last_kernel}")
    check(launches["flash_decode"] == n_layers * report["decode_steps"]
          and dict(k2_routes) == {pa.DECODE_TC_KERNEL:
                                  launches["flash_decode"]},
          f"{tag} (a): K2 launched {launches['flash_decode']} times, by "
          f"kernel {dict(k2_routes)}")
    lines.append(serve_line("(a) dense lanes", report, launches, seen))
    dense = report
    # (b) the paged pool, chunks of 128: K4 at the default tile, K3; (c)
    # int8 pages, 8 splits: K6c, K6b with K5c merged; (c1) int8 pages in
    # one pass: K6c, K6a; (c2) bf16 pages, 8 splits: K4, K5a with K5c
    paged_modes = [
        ("(b) paged, chunks of 128", {}, pa.flash_paged_prefill,
         pa.flash_paged_decode),
        ("(c) int8 pages, 8 splits", dict(kv_dtype="int8", num_splits=8),
         pa.flash_paged_prefill_quant, pa.paged_decode_split_quant_merged)]
    if every_paged_mode:
        paged_modes += [
            ("(c1) int8 pages, one pass", dict(kv_dtype="int8"),
             pa.flash_paged_prefill_quant, pa.flash_paged_decode_quant),
            ("(c2) bf16 pages, 8 splits", dict(num_splits=8),
             pa.flash_paged_prefill, pa.paged_decode_split_merged)]
    for label, kw, prefill, decode in paged_modes:
        seen = tally()
        with clusters_used() as clusters:
            report, launches = model_serve(model, params, seen,
                                           cache="paged", page_size=16,
                                           prefill_chunk=128, **kw)
        what = f"{tag} {label}"
        only_launched(launches, (prefill, decode), what)
        check(launches[prefill.__name__] == n_layers * report["prefill_chunks"]
              and dict(seen[prefill.__name__]) == {
                  default: launches[prefill.__name__]}
              and prefill.last_kernel == TC_KERNEL,
              f"{what}: {prefill.__name__} by tile "
              f"{dict(seen[prefill.__name__])}, {report['prefill_chunks']} "
              f"chunks, on {prefill.last_kernel}")
        check(launches[decode.__name__] == n_layers * report["decode_steps"]
              and decode.last_kernel == pa.DECODE_TC_KERNEL,
              f"{what}: {decode.__name__} launched "
              f"{launches[decode.__name__]} times on {decode.last_kernel}")
        lines.append(serve_line(label, report, launches, seen)
                     + f", greedy tokens equal to (a)'s "
                     f"{greedy_agreement(report, dense)}"
                     + (f", K3 clusters of c by launch {dict(clusters)}"
                        if clusters else ""))
    # (d), (e) a draft of half the layers proposing 4, verify at 8 splits,
    # over bf16 and int8 pages, at the default tile; then at each tile of
    # spec_tiles
    specs = [("(d) speculative", False, None),
             ("(e) speculative, int8", True, None)]
    for i, tile in enumerate(spec_tiles):
        what = f"{tile[0]}x{tile[1]} tiles"
        specs += [(f"({'fghijk'[2 * i]}) speculative, {what}", False, tile),
                  (f"({'fghijk'[2 * i + 1]}) speculative, int8, {what}",
                   True, tile)]
    for label, quant, tile in specs:
        seen = tally()
        verify = (pa.paged_prefill_split_quant_merged if quant
                  else pa.paged_prefill_split_merged)
        prefill = (pa.flash_paged_prefill_quant if quant
                   else pa.flash_paged_prefill)
        kw = dict(SPEC, kv_dtype="int8") if quant else dict(SPEC)
        report, launches, drafts, k2_routes = spec_serve(
            f"{tag} {label}", n_layers // 2, verify, prefill,
            run=functools.partial(model_serve, model, params, seen, tile),
            n_layers=n_layers, **kw)
        want = tile or default
        for kernel in (verify, prefill):
            check(dict(seen[kernel.__name__]) == {
                want: launches[kernel.__name__]},
                f"{tag} {label}: {kernel.__name__} by tile "
                f"{dict(seen[kernel.__name__])}, expected all at {want}")
        lines.append(serve_line(label, report, launches, seen)
                     + f", spec {json.dumps(report['spec'])}, draft "
                     f"prefills {drafts['prefill']}, draft decode steps "
                     f"{drafts['decode_step']}")
    print(f"{title}, 8 requests of 32 tokens, 4 lanes, on {smi}: "
          + "; ".join(lines))
    by_tile = collections.defaultdict(collections.Counter)
    for seen in tallies:
        for name, tiles in seen.items():
            by_tile[name].update(tiles)
    return by_tile


def tile_rows(tag: str, g: int, what: str, chunk: tuple, verify: tuple,
              by_tile: dict, seed: int, served=None,
              d: int = 128, tiles=None,
              kinds=("K4", "K6c", "K5b+K5c", "K6d+K5c")) -> list[dict]:
    """The kernels line's rows of the prefill kernel at group size ``g``
    (phase 28: phi4-mini's G 3; phase 30: llama4-scout's G 5): K4 and K6c
    at the arch's chunk of 128 at 384, K5b and K6d with K5c merged at its
    verify shape with 8 splits, at each of G's tiles (block_q 16 by 64 and
    128 keys), against plain, timed beside the plain version, SDPA on the
    pre-gathered (for int8, pre-dequantized bf16) K/V and the bound;
    launches from the phase's serves, by tile, which must have launched
    each kernel at every tile of ``served`` (None: every tile).  ``d`` is
    the head dim whose ladder the tiles come from (phase 34: pixtral's
    160); ``tiles`` (default: that ladder by both key tiles) and ``kinds``
    narrow the rows (phase 39: the default tile)."""
    if tiles is None:
        tiles = [(bq, bk) for bq in pa.prefill_tiles(BF16, d, g)[0]
                 for bk in pa.TC_BLOCK_KS]
    rows, lines = [], []
    for label, case, quant, ns, line in (
            (label, case, quant, ns, line) for label, case, quant, ns, line
            in (("K4", chunk, False, 1, 733),
                ("K6c", chunk, True, 1, 1186),
                ("K5b+K5c", verify, False, 8, 779),
                ("K6d+K5c", verify, True, 8, 1239)) if label in kinds):
        _, h, hkv, d, psz, nblk, starts, valid, c, _ = case
        q, pools, table, start, lens = split_case(case, seed + line, quant)
        kw = dict(k_scale=pools.k_scale, v_scale=pools.v_scale)
        want = ref.paged_prefill_ref(q, pools.k, pools.v, table, start, lens,
                                     **kw)
        live = [b for b, v in enumerate(valid) if v]
        k_pool, v_pool = pools.k, pools.v
        if quant:
            k_pool = pools.k.to(BF16) * pools.k_scale[..., None].to(BF16)
            v_pool = pools.v.to(BF16) * pools.v_scale[..., None].to(BF16)
        k_dense = ref.gather_pages(k_pool, table)   # gathered once, untimed
        v_dense = ref.gather_pages(v_pool, table)
        kj = torch.arange(nblk * psz, device="cuda")
        qi = start[:, None] + torch.arange(c, device="cuda")
        mask = ((kj <= qi[..., None]) & (kj < lens[:, None, None]))[:, None]
        library = time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k_dense, v_dense, attn_mask=mask, enable_gqa=True))
        n_bytes, n_ops = chunk_work(case, 1 if quant else 2,
                                    4 if quant else 0)
        if quant:
            wrapper = (pa.paged_prefill_split_quant_merged if ns > 1
                       else pa.flash_paged_prefill_quant)
        else:
            wrapper = (pa.paged_prefill_split_merged if ns > 1
                       else pa.flash_paged_prefill)
        for tile in tiles:
            def run(tile=tile):
                return ops.paged_prefill(q, pools, table, start, lens,
                                         num_splits=ns, block_q=tile[0],
                                         block_k=tile[1])
            n = wrapper.by_tile[tile]
            got = run()
            check(wrapper.by_tile[tile] == n + 1
                  and wrapper.last_kernel == TC_KERNEL,
                  f"{tag} {label} {tile}: {wrapper.__name__} did not launch "
                  f"at the tile on {TC_KERNEL}")
            err = compare(got[live], want[live], BF16)
            if ns > 1:
                plain = time_ms(lambda tile=tile: ref.paged_prefill_split_ref(
                    q, pools.k, pools.v, table, start, lens, ns, **kw,
                    block_q=tile[0], block_k=tile[1]))
            else:
                plain = time_ms(lambda: ref.paged_prefill_ref(
                    q, pools.k, pools.v, table, start, lens, **kw))
            times = {"ms": time_ms(run), "plain_ms": plain,
                     "library_ms": library}
            r = row(f"{wrapper.__name__}[{'' if d == 128 else f'D{d} '}"
                    f"G{g} {tile[0]}x{tile[1]}]",
                    PREFILL_SOURCE, f"{FLASH}:{line}", err, n_bytes, n_ops,
                    times)
            r.update(launches=by_tile.get(wrapper.__name__, {}).get(tile, 0),
                     shape=case[0], tile=list(tile))
            if ns > 1:
                r["merges"] = f"{FLASH}:315"
            check(r["launches"] > 0 or (served is not None
                                        and tile not in served),
                  f"{tag} {label} {tile}: no launch in the phase's serves")
            rows.append(r)
            lines.append(f"{label} {tile}: {fmt_times(times)}, bound "
                         f"{r['bound_ms']:.5f} ms ({r['bound_by']}), err "
                         f"{err:.2e}, {r['launches']} launches in the serves")
    check(counters_zero(), f"{tag}: an arrival counter is not 0")
    print(f"{tag} the prefill kernel at G {g} ({what}), against plain (tol "
          f"{TOL[BF16]}), device ms (ms per call incl. host; library: SDPA "
          f"on the pre-gathered K/V, not timed: the gather): "
          + "; ".join(lines))
    return rows


def phi4_rows(by_tile: dict) -> list[dict]:
    """Phase 28's rows: the prefill kernel at G 3's 48-row tiles."""
    return tile_rows("[28 phi4-mini kernels]", 3,
                     "24 q / 8 kv heads; 48-row tiles", PHI4_CHUNK,
                     PHI4_VERIFY, by_tile, 2800)


def phase_phi4(smi: str) -> list[dict]:
    """Phase 28: phi4-mini-3.8b at published widths, random bf16 weights
    from seed 0: its serves (a)-(g), its logits against plain (dense,
    paged, int8 with splits, verify), and the G-3 kernel rows."""
    t0 = time.perf_counter()
    model = build_model(get_arch(PHI4))
    params = model.init(0, "cuda")
    check("lm_head" not in params, "phi4-mini's head is not the embedding")
    by_tile = dense_arch_serves(
        model, params, smi, "phi4",
        f"[28 phi4-mini serves] {PHI4} full (32 layers, d_model 3072, 24 q "
        f"/ 8 kv heads, G 3, D 128, tied embeddings)", (16, 128),
        spec_tiles=((16, 64),))
    tag = f"[28 logits] {PHI4} full"
    phase_logits(model, params, tag)
    phase_paged_logits(model, params, tag)
    phase_int8_logits(model, params, tag)
    phase_verify_logits(model, params, tag)
    del model, params
    torch.cuda.empty_cache()
    rows = phi4_rows(by_tile)
    print(f"[28 phi4-mini] phase 28 in {time.perf_counter() - t0:.1f}s")
    return rows


# --------------------------------------------------------------------------
# phase 29: moonshot-v1-16b-a3b at published widths (MoE, G 1)
# --------------------------------------------------------------------------

MOONSHOT = "moonshot-v1-16b-a3b"


def routing_line(calls: list[dict]) -> str:
    """The traced MoE calls of a serve by token count T (4: a decode tick
    of 4 lanes; 20: a verify of 4 x 5; 128: a prefill chunk; a draft's
    calls too): calls, (token, choice) pairs and the pairs dropped past
    their expert's capacity."""
    by_t = collections.defaultdict(lambda: [0, 0, 0])
    for c in calls:
        n = by_t[c["keep"].shape[0]]
        n[0] += 1
        n[1] += c["keep"].numel()
        n[2] += int((~c["keep"]).sum())
    return ("routing by T (calls, pairs, dropped) of the Python calls "
            "(eager steps, a compiled step's warm-up and capture; a "
            "replay records none) ") + ", ".join(
        f"{t}: {tuple(v)}" for t, v in sorted(by_t.items()))


def moe_serves(model, params, tag: str, title: str, int8_spec: bool = False
               ) -> tuple[dict[str, dict], dict]:
    """(a)-(d) of phases 29 and 30, the serves of an MoE arch (moonshot,
    llama4-scout's cut): dense lanes, the paged pool, int8 pages with 8
    splits, a self-draft of half the layers (and with ``int8_spec`` (e),
    the draft over int8 pages); returns each one's launches and the
    launches by tile over all of them."""
    cfg = model.cfg
    n_layers = cfg.n_layers
    lines, counts = [], {}
    tallies: list[dict] = []
    g = cfg.n_heads // cfg.n_kv_heads
    default = (pa.default_block_q(cfg.head_dim, g), pa.TC_TILE_KEYS)
    # (a) dense lanes: K1 and K2 at the arch's G
    seen = {}
    tallies.append(seen)
    with kernels_by_route(ops, "flash_decode") as k2_routes, \
            moe.trace_routing() as calls:
        report, launches = model_serve(model, params, seen)
    only_launched(launches, (fa.flash_attention, fa.flash_decode),
                  f"{cfg.name} (a) dense")
    check(launches["flash_attention"] == n_layers * SERVE["n_requests"]
          and fa.flash_attention.last_kernel == fa.TC_KERNEL,
          f"{cfg.name} (a): K1 launched {launches['flash_attention']} times "
          f"on {fa.flash_attention.last_kernel}")
    check(launches["flash_decode"] == n_layers * report["decode_steps"]
          and dict(k2_routes) == {pa.DECODE_TC_KERNEL:
                                  launches["flash_decode"]},
          f"{cfg.name} (a): K2 launched {launches['flash_decode']} times, by "
          f"kernel {dict(k2_routes)}")
    lines.append(serve_line("(a) dense lanes", report, launches, seen)
                 + ", " + routing_line(calls))
    dense, counts["a"] = report, launches
    # (b) the paged pool, chunks of 128: K4 at G's default tile (G 1: 32
    # x 128; G 5: 80 x 128), K3; (c) int8 pages, 8 splits: K6c, K6b with
    # K5c merged
    for key, label, kw, prefill, decode in (
            ("b", "(b) paged, chunks of 128", {}, pa.flash_paged_prefill,
             pa.flash_paged_decode),
            ("c", "(c) int8 pages, 8 splits",
             dict(kv_dtype="int8", num_splits=8),
             pa.flash_paged_prefill_quant,
             pa.paged_decode_split_quant_merged)):
        seen = {}
        tallies.append(seen)
        with moe.trace_routing() as calls:
            report, launches = model_serve(model, params, seen,
                                           cache="paged", page_size=16,
                                           prefill_chunk=128, **kw)
        what = f"{cfg.name} {label}"
        only_launched(launches, (prefill, decode), what)
        check(launches[prefill.__name__] == n_layers * report["prefill_chunks"]
              and dict(seen[prefill.__name__]) == {
                  default: launches[prefill.__name__]}
              and prefill.last_kernel == TC_KERNEL,
              f"{what}: {prefill.__name__} by tile "
              f"{dict(seen[prefill.__name__])}, {report['prefill_chunks']} "
              f"chunks, on {prefill.last_kernel}")
        check(launches[decode.__name__] == n_layers * report["decode_steps"]
              and decode.last_kernel == pa.DECODE_TC_KERNEL,
              f"{what}: {decode.__name__} launched "
              f"{launches[decode.__name__]} times on {decode.last_kernel}")
        lines.append(serve_line(label, report, launches, seen)
                     + f", greedy tokens equal to (a)'s (reported only) "
                     f"{greedy_agreement(report, dense)}, "
                     + routing_line(calls))
        counts[key] = launches
    # (d) a self-draft of half the layers proposing 4, verify at 8 splits;
    # with int8_spec also (e), the same over int8 pages (K6d)
    for key, label, quant in (("d", "(d) speculative, 8 splits", False),
                              ("e", "(e) speculative, int8, 8 splits",
                               True))[:2 if int8_spec else 1]:
        seen = {}
        tallies.append(seen)
        verify = (pa.paged_prefill_split_quant_merged if quant
                  else pa.paged_prefill_split_merged)
        prefill = (pa.flash_paged_prefill_quant if quant
                   else pa.flash_paged_prefill)
        with moe.trace_routing() as calls:
            report, launches, drafts, _ = spec_serve(
                f"{cfg.name} {label}", n_layers // 2, verify, prefill,
                run=functools.partial(model_serve, model, params, seen),
                n_layers=n_layers,
                **(dict(SPEC, kv_dtype="int8") if quant else SPEC))
        for kernel in (verify, prefill):
            check(dict(seen[kernel.__name__]) == {
                default: launches[kernel.__name__]},
                f"{cfg.name} {label}: {kernel.__name__} by tile "
                f"{dict(seen[kernel.__name__])}, expected all at {default}")
        lines.append(serve_line(label, report, launches, seen)
                     + f", spec {json.dumps(report['spec'])}, draft "
                     f"prefills {drafts['prefill']}, draft decode steps "
                     f"{drafts['decode_step']}, greedy tokens equal to "
                     f"(a)'s (reported only) "
                     f"{greedy_agreement(report, dense)}, "
                     + routing_line(calls))
        counts[key] = launches
    print(f"{tag} {title}, 8 requests of 32 tokens, 4 lanes: "
          + "; ".join(lines))
    by_tile = collections.defaultdict(collections.Counter)
    for seen in tallies:
        for name, tiles in seen.items():
            by_tile[name].update(tiles)
    return counts, by_tile


def verify_logits(model, params, ns: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Phase 18's bf16 case: phase 10's prompt as chunks of 128, then one
    verify of 5 tokens with ``ns`` splits, through the plain versions and
    then the kernels; returns the (plain, kernel) logits, (5, 1, V)."""
    cfg = model.cfg
    psz, c, plen, max_len = 16, 128, 300, 320
    nblk = max_len // psz
    gen = torch.Generator(device="cuda").manual_seed(8)
    prompt = torch.randint(0, cfg.vocab_size, (1, plen), generator=gen,
                           device="cuda")
    table = (torch.randperm(nblk, generator=gen, device="cuda") + 1)
    table = table.to(torch.int32)[None]
    extra = torch.randint(0, cfg.vocab_size, (4,), generator=gen,
                          device="cuda")
    dev = lambda *x: torch.tensor(x, device="cuda")  # noqa: E731
    runs = {}
    for use_kernel in (False, True):
        caches = model.init_paged_caches(nblk + 1, psz, device="cuda")
        for start in range(0, plen, c):
            end = min(start + c, plen)
            chunk = torch.zeros((1, c), dtype=torch.long, device="cuda")
            chunk[0, :end - start] = prompt[0, start:end]
            logits, caches = model.paged_prefill_step(
                params, caches, table, chunk, dev(start), dev(end),
                dev(end - start - 1), use_kernel=use_kernel)
        if not use_kernel:
            first = int(logits[0].argmax())
        tokens = torch.cat([dev(first), extra])[None]
        logits, _ = model.speculative_step(
            params, caches, table, tokens, dev(plen), dev(plen + 5),
            num_splits=ns, use_kernel=use_kernel)
        runs[use_kernel] = logits[0, :, None]
    torch.cuda.synchronize()
    return runs[False], runs[True]


def routed_logits(plain: torch.Tensor, kern: torch.Tensor,
                  held: torch.Tensor, calls: list, n_layers: int, vocab: int,
                  what: str) -> str:
    """``check_logits`` with the MoE's routing beside it.  ``calls`` are
    the traced MoE calls (with their inputs) of the plain run and then of
    the kernel run, in the same order; a (layer, token, choice) routing
    decision differs where the two runs chose other experts.  bf16
    attention differences can flip a router near-tie, and one flip moves
    the queue positions behind it, so other pairs drop or stay, and the
    next layers' inputs differ further.  So the kernel run's logits over
    the bound pass only when a flip is behind them and the input of the
    first MoE call that flips, the last point before the flip, is within
    5e-2 of its own scale between the routes.  ``held``: the kernel run
    again with the plain run's routing replayed at every MoE call, which
    must be within the bound of ``plain`` at every position (the kernels
    at full depth, with the routing held equal)."""
    half = len(calls) // 2
    check(len(calls) == 2 * half > 0, f"{what}: {len(calls)} MoE calls")
    pairs = list(zip(calls[:half], calls[half:]))
    flips = [int((a["top_i"] != b["top_i"]).sum()) for a, b in pairs]
    drops = [sum(int((~c["keep"]).sum()) for c in side)
             for side in (calls[:half], calls[half:])]
    first = next((i for i, f in enumerate(flips) if f), None)
    flip_text = (f"routing decisions that differ {sum(flips)}/"
                 f"{sum(a['top_i'].numel() for a, _ in pairs)} in "
                 f"{sum(1 for f in flips if f)} of {half} MoE calls"
                 + ("" if first is None else
                    f", the first at call {first} (layer "
                    f"{first % n_layers}): {flips[first]}/"
                    f"{pairs[first][0]['top_i'].numel()}")
                 + f", dropped pairs plain {drops[0]} kernels {drops[1]}")
    check(tuple(kern.shape) == (plain.shape[0], 1, vocab), f"{what} shape")
    check(bool(torch.isfinite(kern).all() and torch.isfinite(plain).all()),
          f"{what} are not finite")
    held_text = "routing held to plain's: " + check_logits(
        plain, held, vocab, f"{what} (routing held)")
    scale = float(plain.abs().max())
    err = float((kern - plain).abs().max())
    if err <= 5e-2 * scale or first is None:
        return (check_logits(plain, kern, vocab, what) + "; " + flip_text
                + "; " + held_text)
    xp, xk = (c["x"].float() for c in pairs[first])
    x_scale = float(xp.abs().max())
    x_err = float((xk - xp).abs().max())
    check(x_err <= 5e-2 * x_scale,
          f"{what}: logits differ by {err:.3e} (over 5e-2 x {scale:.3e}) "
          f"and the input of MoE call {first}, the first to flip, by "
          f"{x_err:.3e} (over 5e-2 x {x_scale:.3e})")
    return (f"logits OVER 5e-2 of their scale by a routing flip: max abs "
            f"diff {err:.3e} (logit scale {scale:.3e}); held at the input "
            f"of MoE call {first}, the first that flips: max abs diff "
            f"{x_err:.3e} (scale {x_scale:.3e}, tol {5e-2 * x_scale:.3e}); "
            + flip_text + "; " + held_text)


def moe_logits(model, params, tag: str) -> None:
    """The logits of (a)-(d) on an MoE arch, kernels against plain, with
    the routing flips between the two routes, and again with the plain
    run's routing replayed in both."""
    lines = []
    for label, run in (
            ("(a) dense, prefill 128 + 4 decode steps",
             lambda: dense_logits(model, params)),
            ("(b) paged, 300 tokens as chunks of 128 + 4 decode steps",
             lambda: paged_logits(model, params)),
            ("(c) int8 pages, the same with 8 splits",
             lambda: paged_logits(model, params, quantized=True,
                                  splits=(8,) * 4)),
            ("(d) then a verify of 5 tokens, 8 splits",
             lambda: verify_logits(model, params, 8))):
        with moe.trace_routing(inputs=True) as calls:
            plain, kern = run()
        plain_calls = calls[:len(calls) // 2]
        with moe.replay_routing(plain_calls + plain_calls):
            again, held = run()
        lines.append(f"{label}: " + routed_logits(
            plain, kern, held, calls, model.cfg.n_layers,
            model.cfg.padded_vocab, f"{model.cfg.name} {label} logits")
            + f"; plain replaying its own routing: max abs diff "
            f"{float((again - plain).abs().max()):.3e}")
        del calls, plain_calls
    print(f"{tag} {model.cfg.name}: " + "; ".join(lines))


def device_ops(fn) -> int:
    """Operations ``fn`` puts on the card (kernels, copies, memsets), from
    ``torch.profiler``'s device events; 0 if the profiler sees none."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA)


def moe_layer_times(model, params, tag: str) -> None:
    """One MoE layer (layer 0's weights) at decode (4 lanes) and at a
    512-token prefill group: device ms (CUDA events behind a spin), the
    operations it launches, and two byte floors: every expert read (what
    the batched product does) and only the experts this input routes to,
    both with the shared experts, the router and x in and out."""
    cfg = model.cfg
    mcfg = transformer.moe_config(cfg)
    p = transformer._layer(params["layers"]["moe"], 0)
    d, f = cfg.d_model, cfg.d_ff
    expert = 3 * d * f * 2
    fixed = 3 * d * f * cfg.n_shared_experts * 2 + d * cfg.n_experts * 2
    lines = []
    for label, shape in (("decode of 4 lanes", (4, 1, d)),
                         ("prefill of 512", (1, 512, d))):
        x = randn(shape, 2900 + shape[1], BF16)

        def run(x=x):
            return moe.apply_moe(p, x, mcfg, with_aux=False)

        with moe.trace_routing() as calls:
            run()
        top_i, keep = calls[0]["top_i"], calls[0]["keep"]
        routed = int(torch.unique(top_i[keep]).numel())
        io = 2 * x.numel() * 2
        floors = {n: (n * expert + fixed + io) / HBM_BYTES_PER_S * 1e3
                  for n in (cfg.n_experts, routed)}
        times = time_ms(run)
        lines.append(
            f"{label}: {times[0]:.4f} ms ({times[1]:.4f} a call with the "
            f"host), {device_ops(run)} device operations; byte floors: all "
            f"{cfg.n_experts} experts {floors[cfg.n_experts]:.4f} ms, the "
            f"{routed} routed {floors[routed]:.4f} ms; "
            f"{int((~keep).sum())}/{keep.numel()} pairs dropped, capacity "
            f"{moe.capacity(mcfg, min(mcfg.group_size, shape[0] * shape[1]))}"
            f"; x {cfg.n_layers} layers: {times[0] * cfg.n_layers:.2f} ms")
    print(f"{tag} {cfg.name}, one MoE layer (bf16, "
          f"{cfg.n_experts} x 3 x {d} x {f} expert weights, "
          f"{cfg.n_experts * expert / 1e9:.3f} GB), device ms: "
          + "; ".join(lines))


def phase_moe(smi: str, n: int, cfg, cut: str,
              int8_spec: bool = False) -> dict:
    """Phases 29 and 30: an MoE arch at published widths (``cfg``, its
    depth cut where ``cut`` names one), random bf16 weights from seed 0,
    made on the card once every earlier model is freed: its serves
    (a)-(d) with the launches they must make, its logits against plain
    with the routing flips, one MoE layer timed, and the peak memory.
    Returns the serves' launches by tile."""
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg)
    params = model.init(0, "cuda")
    n_params = sum(t.numel() for t in tree_leaves(params))
    norms = (2 * cfg.n_layers + 1) * cfg.d_model
    check(n_params == cfg.param_count() + norms,
          f"{cfg.name} holds {n_params} parameters, param_count() "
          f"{cfg.param_count()} + {norms} norm weights")
    print(f"[{n} {cfg.name}] {cut}; {cfg.param_count() / 1e9:.2f} B "
          f"parameters ({cfg.active_param_count() / 1e9:.2f} B active a "
          f"token): {(torch.cuda.memory_allocated() - before) / 1e9:.2f} GB "
          f"allocated for the bf16 weights, {before / 1e9:.3f} GB before "
          "them")
    g = cfg.n_heads // cfg.n_kv_heads
    title = (f"{cfg.name} ({cfg.n_layers} layers, d_model {cfg.d_model}, "
             f"{cfg.n_heads} q / {cfg.n_kv_heads} kv heads, G {g}, D "
             f"{cfg.head_dim}, {cfg.n_experts} experts top-{cfg.top_k} + "
             f"{cfg.n_shared_experts} shared, capacity factor "
             f"{cfg.capacity_factor}) on {smi}")
    _, by_tile = moe_serves(model, params, f"[{n} serves]", title,
                            int8_spec)
    moe_logits(model, params, f"[{n} logits]")
    moe_layer_times(model, params, f"[{n} moe layer]")
    peak = torch.cuda.max_memory_allocated()
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[{n} {cfg.name}] peak memory allocated {peak / 1e9:.2f} GB of "
          f"{torch.cuda.get_device_properties(0).total_memory / 1e9:.2f}; "
          f"phase {n} in {time.perf_counter() - t0:.1f}s")
    return by_tile


def phase_moonshot(smi: str) -> None:
    """Phase 29: moonshot-v1-16b-a3b at published widths and depth."""
    phase_moe(smi, 29, get_arch(MOONSHOT), "published widths and depth, "
              "nothing cut")


# --------------------------------------------------------------------------
# phase 30: llama4-scout-17b-a16e, 12 of its 48 layers (MoE, G 5: the
# prefill kernel's 80-row tile)
# --------------------------------------------------------------------------

LLAMA4 = "llama4-scout-17b-a16e"
#: the depth cut: 12 of 48 layers at published widths, 57.0 GB of bf16
#: weights (the whole arch, 215.5 GB, does not fit one 80 GB card)
LLAMA4_LAYERS = 12
# llama4-scout's verify and chunk shapes (40 q / 8 kv heads), as PHI4's
LLAMA4_VERIFY = ("llama4 verify", 40, 8, 128, 16, 64,
                 [839, 720, 190, 544, 0], [5, 5, 5, 5, 0], 5, BF16)
LLAMA4_CHUNK = ("llama4 chunk at 384", 40, 8, 128, 16, 32, [384], [128],
                128, BF16)


def phase_llama4(smi: str) -> list[dict]:
    """Phase 30: llama4-scout-17b-a16e cut to 12 of its 48 layers at
    published widths: the MoE phase's serves, logits and layer times, then
    the prefill kernel's rows at G 5's 80-row tiles, with their launches
    from the serves."""
    cfg = dataclasses.replace(get_arch(LLAMA4), n_layers=LLAMA4_LAYERS)
    full = get_arch(LLAMA4)
    cut = (f"depth cut: {LLAMA4_LAYERS} of {full.n_layers} layers at "
           f"published widths ({2 * cfg.param_count() / 1e9:.1f} GB of bf16 "
           f"weights of the whole arch's {2 * full.param_count() / 1e9:.1f})")
    print(f"[30 llama4-scout] {cut}")
    by_tile = phase_moe(smi, 30, cfg, cut, int8_spec=True)
    return tile_rows("[30 llama4-scout kernels]", 5,
                     "40 q / 8 kv heads; 80-row tiles", LLAMA4_CHUNK,
                     LLAMA4_VERIFY, by_tile, 3000,
                     served=[(16, pa.TC_TILE_KEYS)])


# --------------------------------------------------------------------------
# phases 31 and 33: the sliding-window archs on dense lanes of rings:
# h2o-danube-1.8b (every layer; D 80, G 4) and zamba2-7b's shared block
# (13 applications; D 112, G 1), both whole
# --------------------------------------------------------------------------

DANUBE = "h2o-danube-1.8b"
ZAMBA = "zamba2-7b"
# prompt lengths of the dense serves: three longer than the 4096-key window
# (prefill rolls the ring), three whose 32 new tokens cross it in decode
RING_PROMPTS = (4600, 4080, 4090, 4350, 1000, 4070, 4200, 3000)
RING_MAX_LEN = 4700


def ring_kernel_rows(smi: str, arch: str, phase: int,
                     seed: int) -> list[dict]:
    """K1 at the arch's head dim (every tile; its windowed prefill of 4608
    tokens, past the window) and K2 (both key tiles; 4 lanes of rings of
    ``window`` slots) against plain, timed beside SDPA with the window's
    mask and the bound, and each instance's registers and occupancy."""
    cfg = get_arch(arch)
    h, hkv, d, w = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.window
    rows, lines, infos = [], [], []
    s = 4608
    q, k, v = (randn((1, n, s, d), seed + j, BF16)
               for j, n in enumerate((h, hkv, hkv)))
    qi = torch.arange(s, device="cuda")[:, None]
    kj = torch.arange(s, device="cuda")[None, :]
    mask = (kj <= qi) & (qi - kj < w)
    kw = dict(causal=True, window=w)
    default = fa.flash_attention(q, k, v, **kw)
    for tile in fa.attention_tiles(BF16, d):
        r, line = k1_kernel_row(f"D{d} {tile[0]}x{tile[1]}", q, k, v, kw,
                                mask, f"{arch} prefill S={s} window {w}",
                                tile)
        same = bool(torch.equal(fa.flash_attention(
            q, k, v, **kw, block_q=tile[0], block_k=tile[1]), default))
        rows.append(r)
        lines.append(line + ("" if same else ", NOT bit-equal to 64x64"))
        info = fa.tc_info(d, *tile)
        infos.append(f"K1 {tile[0]}x{tile[1]}: {info['registers']} "
                     f"registers, {info['local_bytes']} B local, "
                     f"{info['smem_bytes']} B shared, "
                     f"{info['blocks_per_sm']} block(s)/SM")
    del q, k, v, mask, default
    b = 4
    kv_len = torch.tensor([w, w, 2000, 3000], dtype=torch.int32,
                          device="cuda")
    q = randn((b, h, 1, d), seed + 10, BF16)
    k = randn((b, hkv, w, d), seed + 11, BF16)
    v = randn((b, hkv, w, d), seed + 12, BF16)
    for bk in pa.decode_block_ks(BF16, d, dense=True):
        r, line = k2_kernel_row(f"D{d} {bk}", q, k, v, kv_len,
                                f"{arch} decode B={b} ring {w}", bk)
        rows.append(r)
        lines.append(line)
        info = pa.decode_tc_info(d, "bf16 dense", block_k=bk)
        infos.append(f"K2 block_k {bk}: {info['registers']} registers, "
                     f"{info['local_bytes']} B local, {info['smem_bytes']} B "
                     f"shared, {info['blocks_per_sm']} CTA(s)/SM, clusters "
                     f"held at once {info['clusters']}")
    print(f"[{phase} {arch} kernels] D {d} ({h} q / {hkv} kv heads, G "
          f"{h // hkv}, window {w}) against plain (tol {TOL[BF16]}), device "
          f"ms (ms per call incl. host) on {smi}: " + "; ".join(lines)
          + "; instances: " + "; ".join(infos))
    return rows


def ring_serve(model, params, smi: str, phase: int, ring_key: str,
               n_attn: int, what: str) -> dict[str, int]:
    """The dense serve of a sliding-window arch: 8 requests of
    RING_PROMPTS tokens, 32 new each, over 4 lanes whose ``ring_key``
    caches are rings of ``window`` slots; every request finishes with its
    32 tokens, and the counters show K1 once an attention (``n_attn`` a
    token) an admission and K2 once an attention a tick, on the
    tensor-core and cluster kernels, at the default tiles, and nothing
    else."""
    gen = np.random.default_rng(phase)
    engine = ServingEngine(model, params, n_lanes=4, max_len=RING_MAX_LEN)
    slots = engine.kv.caches[ring_key][0].shape[3]
    check(slots == model.cfg.window,
          f"{model.cfg.name}'s rings hold {slots} slots, not the window's")
    at.clear_published()
    for kernel in KERNELS:
        kernel.launches = 0
    for kernel in (fa.flash_attention, fa.flash_decode):
        kernel.by_tile.clear()
    with kernels_by_route(ops, "flash_decode") as k2_routes:
        for rid, plen in enumerate(RING_PROMPTS):
            prompt = gen.integers(0, model.cfg.vocab_size, plen).tolist()
            engine.submit(Request(rid=rid, prompt=prompt, max_new_tokens=32))
        t0 = time.perf_counter()
        finished = engine.run(max_steps=len(RING_PROMPTS) * 40)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in KERNELS}
    name = model.cfg.name
    check(len(finished) == len(RING_PROMPTS)
          and all(len(r.out_tokens) == 32 for r in finished),
          f"{name} serve: {len(finished)} requests finished")
    only_launched(launches, (fa.flash_attention, fa.flash_decode),
                  f"{name} dense")
    ticks = engine.steps
    summary = engine.metrics.summary()
    check(launches["flash_attention"] == n_attn * len(RING_PROMPTS)
          and dict(fa.flash_attention.by_tile) == {
              fa.TC_DEFAULT_TILE: launches["flash_attention"]}
          and fa.flash_attention.last_kernel == fa.TC_KERNEL,
          f"{name}: K1 launched {launches['flash_attention']} times, by "
          f"tile {dict(fa.flash_attention.by_tile)}")
    check(launches["flash_decode"] == n_attn * ticks
          and dict(fa.flash_decode.by_tile) == {
              pa.DECODE_TILE_KEYS: launches["flash_decode"]}
          and dict(k2_routes) == {pa.DECODE_TC_KERNEL:
                                  launches["flash_decode"]},
          f"{name}: K2 launched {launches['flash_decode']} times in "
          f"{ticks} ticks, by kernel {dict(k2_routes)}")
    w = model.cfg.window
    crossed = sum(1 for p in RING_PROMPTS if p < w < p + 32)
    rolled = sum(1 for p in RING_PROMPTS if p > w)
    gen_tokens = sum(len(r.out_tokens) for r in finished)
    print(f"[{phase} serve] {name} full ({what}) on {smi}: dense lanes of "
          f"{w}-slot rings, prompts {list(RING_PROMPTS)} ({rolled} rolled at "
          f"prefill, {crossed} wrapping in decode), 32 new tokens each, 4 "
          f"lanes: {gen_tokens} tokens in {wall:.3f}s = "
          f"{gen_tokens / wall:.1f} tok/s, {ticks} ticks, p50 ttft "
          f"{summary['ttft_s']['p50']:.4f}s, p50 itl "
          f"{summary['itl_s']['p50']:.4f}s, launches "
          f"{ {k: n for k, n in launches.items() if n} }, K1 by tile "
          f"{dict(fa.flash_attention.by_tile)}, K2 by tile "
          f"{dict(fa.flash_decode.by_tile)}, K2 by kernel {dict(k2_routes)}")
    return {"flash_attention": launches["flash_attention"],
            "flash_decode": launches["flash_decode"], "ticks": ticks}


def ring_checks(model, params, phase: int) -> str:
    """Kernels against plain on a prompt of 4094 tokens and 4 decode steps
    (slots 4094, 4095, then 0 and 1 of the ring) and one of 4200 (prefill
    keeps its last 4096 keys, rolled); then ``--cache paged`` must be
    refused as in the JAX package.  Returns the refusal."""
    lines = []
    for plen in (4094, 4200):
        plain, kern = dense_logits(model, params, plen, RING_MAX_LEN)
        lines.append(f"prompt {plen} + 4 decode steps: "
                     + check_logits(plain, kern, model.cfg.padded_vocab,
                                    f"{model.cfg.name} logits ({plen})"))
    print(f"[{phase} logits] {model.cfg.name} full, free-running: "
          + "; ".join(lines))
    try:
        ServingEngine(model, params, n_lanes=4, max_len=RING_MAX_LEN,
                      cache="paged", page_size=16, prefill_chunk=128)
    except ValueError as e:
        check("paged" in str(e), f"the paged refusal does not say paged: {e}")
        return str(e)
    raise RuntimeError(f"chip_smoke check failed: {model.cfg.name} served "
                       "from the paged pool")


def ring_launches(rows: list[dict], counts: dict[str, int]) -> None:
    """The serve's launches on its default tiles' rows, 0 on the others."""
    for r in rows:
        r["launches"] = counts[r["name"].split("[")[0]] if r["tile"] in (
            list(fa.TC_DEFAULT_TILE), [pa.DECODE_TILE_KEYS]) else 0


def phase_danube(smi: str) -> list[dict]:
    """Phase 31: h2o-danube-1.8b whole at published widths (random bf16
    weights from seed 0): K1 and K2 at D 80 against plain and timed, the
    dense serve that wraps the ring in prefill and in decode, its logits
    against plain, and the paged pool refused as in the JAX package."""
    t0 = time.perf_counter()
    rows = ring_kernel_rows(smi, DANUBE, 31, 3100)
    cfg = get_arch(DANUBE)
    model = build_model(cfg)
    params = model.init(0, "cuda")
    print(f"[31 h2o-danube] {cfg.param_count() / 1e9:.2f} B parameters, "
          f"whole (24 layers, nothing cut)")
    ring_launches(rows, ring_serve(
        model, params, smi, 31, "kv", cfg.n_layers,
        "24 layers, d_model 2560, 32 q / 8 kv heads, G 4, D 80"))
    refusal = ring_checks(model, params, 31)
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[31 h2o-danube] --cache paged raises ValueError: {refusal!r}; "
          f"phase 31 in {time.perf_counter() - t0:.1f}s")
    return rows


# --------------------------------------------------------------------------
# phase 32: whisper-tiny's encoder-decoder; phase 33: zamba2-7b's Mamba-2
# stack and its shared block
# --------------------------------------------------------------------------


class _ShapeCount(_RouteCount):
    """A kernel wrapper that also counts its calls by ``key(*args, **kw)``
    (which call of the model a launch serves, told by its shapes)."""

    def __init__(self, fn, tally: collections.Counter, key):
        super().__init__(fn, tally)
        object.__setattr__(self, "_key", key)

    def __call__(self, *args, **kw):
        out = self._fn(*args, **kw)
        self._tally[self._key(*args, **kw)] += 1
        return out


@contextlib.contextmanager
def calls_by_shape(module, name: str, key):
    """Count the calls of wrapper ``module.name`` by ``key`` while the
    block runs (as :func:`kernels_by_route` counts them by kernel)."""
    fn = getattr(module, name)
    tally = collections.Counter()
    setattr(module, name, _ShapeCount(fn, tally, key))
    try:
        with replayed(tally):
            yield tally
    finally:
        setattr(module, name, fn)


def _k1_call(q, k, v, causal=True, window=None, **kw) -> str:
    if k.shape[2] != q.shape[2]:
        return "cross"
    return "self" if causal else "encoder"


def _k2_call(q, k, v, kv_len=None, **kw) -> str:
    return "cross" if kv_len is None else "self"


def k1_kernel_row(name: str, q, k, v, kw: dict, mask, shape: str,
                  tile=None) -> tuple[dict, str]:
    """K1 on (q, k, v) with ``kw`` against its plain version, timed beside
    it, SDPA with ``mask`` (None: no mask, or ``is_causal`` when ``kw``
    is causal without a window) and the bound (Q, K, V read and O written
    once; 4 D operations per visible (query, key) pair)."""
    sq, sk = q.shape[2], k.shape[2]
    want = ref.attention_ref(q, k, v, **kw)
    run = functools.partial(fa.flash_attention, q, k, v, **kw,
                            **({} if tile is None else
                               dict(block_q=tile[0], block_k=tile[1])))
    got = run()
    check(fa.flash_attention.last_kernel == fa.TC_KERNEL,
          f"K1 {name} ran {fa.flash_attention.last_kernel}")
    err = compare(got, want, BF16)
    if mask is not None:
        pairs = int(mask.sum())
    elif kw.get("causal"):
        pairs = sq * (sq + 1) // 2
    else:
        pairs = sq * sk
    sdpa_kw = (dict(attn_mask=mask) if mask is not None
               else dict(is_causal=bool(kw.get("causal"))))
    times = {"ms": time_ms(run),
             "plain_ms": time_ms(lambda: ref.attention_ref(q, k, v, **kw)),
             "library_ms": time_ms(
                 lambda: torch.nn.functional.scaled_dot_product_attention(
                     q, k, v, enable_gqa=True, **sdpa_kw))}
    n_bytes = 2 * (2 * q.numel() + k.numel() + v.numel())
    n_ops = 4 * q.shape[0] * q.shape[1] * pairs * q.shape[3]
    r = row(f"flash_attention[{name}]", SOURCE, f"{FLASH}:106", err, n_bytes,
            n_ops, times)
    r.update(shape=shape, tile=list(tile or fa.TC_DEFAULT_TILE))
    return r, (f"K1 {name}: {fmt_times(times)}, bound {r['bound_ms']:.5f} ms "
               f"({r['bound_by']}), err {err:.2e}")


def k2_kernel_row(name: str, q, k, v, kv_len, shape: str,
                  block_k=None) -> tuple[dict, str]:
    """K2 on a dense strip against its plain version, timed beside it,
    SDPA (masked to ``kv_len``) and the bound (the live K/V rows, q and o
    once)."""
    b, h, _, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    lens = [s] * b if kv_len is None else kv_len.tolist()
    want = ref.decode_ref(q, k, v, kv_len)
    run = functools.partial(fa.flash_decode, q, k, v, kv_len,
                            block_k=block_k)
    got = run()
    check(fa.flash_decode.last_kernel == pa.DECODE_TC_KERNEL,
          f"K2 {name} ran {fa.flash_decode.last_kernel}")
    err = compare(got, want, BF16)
    mask = (None if kv_len is None else
            (torch.arange(s, device="cuda")[None, :]
             < kv_len[:, None])[:, None, None, :])
    times = {"ms": time_ms(run),
             "plain_ms": time_ms(lambda: ref.decode_ref(q, k, v, kv_len)),
             "library_ms": time_ms(
                 lambda: torch.nn.functional.scaled_dot_product_attention(
                     q, k, v, attn_mask=mask, enable_gqa=True))}
    keys = sum(min(n, s) for n in lens)
    n_bytes = 2 * (2 * keys * hkv * d + 2 * b * h * d) + 4 * b
    n_ops = 4 * (h // hkv) * hkv * keys * d
    r = row(f"flash_decode[{name}]", DECODE_SOURCE, f"{FLASH}:203", err,
            n_bytes, n_ops, times)
    bk = pa.decode_tile("flash_decode", q, block_k)
    r.update(shape=shape, tile=[bk])
    c = pa.cluster_size(b, hkv, pa.sm_count(0),
                        fa.route("flash_decode", q.dtype, d).width, bk)
    return r, (f"K2 {name} (block_k {bk}, c={c}): {fmt_times(times)}, "
               f"bound {r['bound_ms']:.5f} ms ({r['bound_by']}), err "
               f"{err:.2e}")


WHISPER = "whisper-tiny"
WHISPER_PROMPTS = (224, 4)     # batch (a), and the start-of-transcript (b)
WHISPER_NEW = 64               # the last position, 224 + 63, under 448


def whisper_kernel_rows(smi: str) -> list[dict]:
    """K1 non-causal over the encoder's 1500 frames, causal over the
    decoder's prompt of 224 and across, 224 rows over 1500 keys, and K2
    over the self cache and the 1500-row cross cache, at whisper-tiny's
    shapes (B 4, 6 heads, G 1, D 64), against plain and timed."""
    cfg = get_arch(WHISPER)
    b, h, d, se = 4, cfg.n_heads, cfg.head_dim, cfg.frontend_seq
    sq = WHISPER_PROMPTS[0]
    rows, lines = [], []
    qe, ke, ve = (randn((b, h, se, d), 3200 + j, BF16) for j in range(3))
    qs, ks, vs = (randn((b, h, sq, d), 3210 + j, BF16) for j in range(3))
    for args in (("whisper encoder S1500", qe, ke, ve, dict(causal=False),
                  None, "whisper-tiny encoder B=4 S=1500"),
                 ("whisper self S224", qs, ks, vs, dict(causal=True), None,
                  "whisper-tiny decoder prefill B=4 S=224"),
                 ("whisper cross 224x1500", qs, ke, ve, dict(causal=False),
                  None, "whisper-tiny cross B=4 Sq=224 Sk=1500")):
        r, line = k1_kernel_row(*args)
        rows.append(r)
        lines.append(line)
    max_len = sq + WHISPER_NEW
    q1 = randn((b, h, 1, d), 3220, BF16)
    kc, vc = (randn((b, h, max_len, d), 3221 + j, BF16) for j in range(2))
    kv_len = torch.tensor([max_len, 256, 240, sq + 1], dtype=torch.int32,
                          device="cuda")
    for args in (("whisper self", q1, kc, vc, kv_len,
                  f"whisper-tiny decode B=4 self cache {max_len}"),
                 ("whisper cross 1500", q1, ke, ve, None,
                  "whisper-tiny decode B=4 cross cache 1500")):
        r, line = k2_kernel_row(*args)
        rows.append(r)
        lines.append(line)
    info = fa.tc_info(d)
    dinfo = pa.decode_tc_info(d, "bf16 dense")
    print(f"[32 whisper kernels] D 64, 6 q / 6 kv heads (G 1), B 4, "
          f"against plain (tol {TOL[BF16]}), device ms (ms per call incl. "
          f"host) on {smi}: " + "; ".join(lines)
          + f"; K2's cluster size at B 4 x Hkv 6: "
          f"{pa.cluster_size(b, h, pa.sm_count(0))}; instances: K1 64x64 "
          f"{info['registers']} registers, {info['local_bytes']} B local, "
          f"{info['smem_bytes']} B shared, {info['blocks_per_sm']} block(s)"
          f"/SM; K2 block_k 64 {dinfo['registers']} registers, "
          f"{dinfo['local_bytes']} B local, {dinfo['blocks_per_sm']} "
          f"CTA(s)/SM")
    return rows


def whisper_frames(cfg, b: int, seed: int) -> torch.Tensor:
    """The audio stub's input: (B, 1500, d) float32 frame embeddings."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn((b, cfg.frontend_seq, cfg.d_model), generator=gen,
                       device="cuda")


def whisper_greedy(model, params, frames, plen: int, new: int,
                   use_kernel=None) -> tuple[torch.Tensor, dict]:
    """Prefill of a (B, plen) prompt from seed 32 over ``frames``, then
    ``new`` greedy decode steps; returns the tokens (B, new) and the
    times: prefill (TTFT) and decode seconds."""
    cfg = model.cfg
    gen = torch.Generator(device="cuda").manual_seed(32)
    prompt = torch.randint(0, cfg.vocab_size, (frames.shape[0], plen),
                           generator=gen, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, caches = model.prefill(params, prompt, plen + new,
                                   use_kernel=use_kernel,
                                   frontend_embeds=frames)
    check(tuple(logits.shape) == (frames.shape[0], cfg.padded_vocab)
          and bool(torch.isfinite(logits).all()),
          f"whisper prefill logits {tuple(logits.shape)} not finite")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    out = []
    for i in range(new):
        token = logits.argmax(-1)
        out.append(token)
        pos = torch.full((frames.shape[0],), plen + i, device="cuda")
        logits, caches = model.decode_step(params, caches, token[:, None],
                                           pos, use_kernel=use_kernel)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    check(bool(torch.isfinite(logits).all()), "whisper decode logits")
    return torch.stack(out, 1), {"prefill_s": t1 - t0, "decode_s": t2 - t1}


def whisper_logits(model, params, frames, plen: int) -> str:
    """Kernels against plain on lane 0: a prefill of ``plen`` tokens and
    4 decode steps fed the plain route's greedy tokens."""
    runs, tokens = {}, []
    gen = torch.Generator(device="cuda").manual_seed(7)
    prompt = torch.randint(0, model.cfg.vocab_size, (1, plen), generator=gen,
                           device="cuda")
    for use_kernel in (False, True):
        logits, caches = model.prefill(params, prompt, plen + 8,
                                       use_kernel=use_kernel,
                                       frontend_embeds=frames[:1])
        steps = [logits]
        for i in range(4):
            if not use_kernel:
                tokens.append(int(steps[-1][0].argmax()))
            logits, caches = model.decode_step(
                params, caches, torch.tensor([[tokens[i]]], device="cuda"),
                torch.tensor([plen + i], device="cuda"),
                use_kernel=use_kernel)
            steps.append(logits)
        runs[use_kernel] = torch.stack(steps)
    torch.cuda.synchronize()
    return check_logits(runs[False], runs[True], model.cfg.padded_vocab,
                        f"whisper logits ({plen})")


def phase_whisper(smi: str) -> list[dict]:
    """Phase 32: whisper-tiny whole (4 + 4 layers, random bf16 weights
    from seed 0) through its model entry points, as the JAX package runs
    it (its engine serves no encoder-decoder): 4 lanes of 1500 random
    frame embeddings, prompts of 224 and of 4 tokens, 64 greedy new
    tokens each; K1 (encoder, decoder self-attention, cross attention
    with Sk 1500 != Sq) and K2 (self and cross caches) counted by call;
    the kernel rows; logits against plain; peak memory."""
    t0 = time.perf_counter()
    rows = whisper_kernel_rows(smi)
    cfg = get_arch(WHISPER)
    model = build_model(cfg)
    params = model.init(0, "cuda")
    frames = whisper_frames(cfg, 4, 32)
    for plen in WHISPER_PROMPTS:    # warm-up: the first call of a shape
        whisper_greedy(model, params, frames, plen, 1)   # picks its GEMMs
    torch.cuda.reset_peak_memory_stats()
    for kernel in KERNELS:
        kernel.launches = 0
    for kernel in (fa.flash_attention, fa.flash_decode):
        kernel.by_tile.clear()
    lines = []
    with calls_by_shape(ops, "flash_attention", _k1_call) as k1_calls, \
            calls_by_shape(ops, "flash_decode", _k2_call) as k2_calls:
        for plen in WHISPER_PROMPTS:
            toks, times = whisper_greedy(model, params, frames, plen,
                                         WHISPER_NEW)
            n = toks.numel()
            lines.append(
                f"prompts of {plen}: TTFT {times['prefill_s']:.4f}s "
                f"(encoder + prefill), {n} tokens in "
                f"{times['decode_s']:.3f}s = {n / times['decode_s']:.1f} "
                f"tok/s, ITL {times['decode_s'] / WHISPER_NEW * 1e3:.2f} ms")
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    launches = {k.__name__: k.launches for k in KERNELS}
    only_launched(launches, (fa.flash_attention, fa.flash_decode),
                  "whisper-tiny")
    n_b, layers = len(WHISPER_PROMPTS), cfg.n_layers
    want_k1 = {"encoder": cfg.n_encoder_layers * n_b, "self": layers * n_b,
               "cross": layers * n_b}
    want_k2 = {"self": layers * WHISPER_NEW * n_b,
               "cross": layers * WHISPER_NEW * n_b}
    check(dict(k1_calls) == want_k1
          and launches["flash_attention"] == sum(want_k1.values())
          and fa.flash_attention.last_kernel == fa.TC_KERNEL,
          f"whisper: K1 calls {dict(k1_calls)}, expected {want_k1}")
    check(dict(k2_calls) == want_k2
          and launches["flash_decode"] == sum(want_k2.values())
          and fa.flash_decode.last_kernel == pa.DECODE_TC_KERNEL,
          f"whisper: K2 calls {dict(k2_calls)}, expected {want_k2}")
    for r in rows:     # a row's name: "<kernel>[whisper <call> ...]"
        kernel, what = r["name"].split("[")
        tally = k1_calls if kernel == "flash_attention" else k2_calls
        r["launches"] = tally[what.rstrip("]").split()[1]]
    logit_lines = [f"prompt {plen} + 4 decode steps: "
                   + whisper_logits(model, params, frames, plen)
                   for plen in WHISPER_PROMPTS]
    del model, params, frames
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[32 whisper] {WHISPER} whole (4 + 4 layers, d_model 384, 6 "
          f"heads, D 64, {cfg.param_count() / 1e6:.1f} M parameters) through "
          f"prefill(frontend_embeds=) and decode_step on {smi}: 4 lanes of "
          f"{cfg.frontend_seq} frames; " + "; ".join(lines)
          + f"; K1 calls {dict(k1_calls)}, K2 calls {dict(k2_calls)} (by "
          f"kernel: {fa.flash_attention.last_kernel}, "
          f"{fa.flash_decode.last_kernel}), peak memory {peak / 1e9:.3f} GB")
    print(f"[32 logits] {WHISPER} free-running: " + "; ".join(logit_lines)
          + f"; phase 32 in {time.perf_counter() - t0:.1f}s")
    return rows


def phase_zamba(smi: str) -> list[dict]:
    """Phase 33: zamba2-7b whole at published widths (81 layers, random
    bf16 weights from seed 0; nothing cut): K1 and K2 at D 112 against
    plain and timed, the dense serve whose shared block's rings wrap at
    prefill and in decode, its logits against plain, the paged pool
    refused as in the JAX package, the peak memory, and one decode tick
    profiled (``launch/profile_decode.py``'s ``profile_decode``)."""
    from repro_torch.launch.profile_decode import profile_decode
    t0 = time.perf_counter()
    rows = ring_kernel_rows(smi, ZAMBA, 33, 3300)
    cfg = get_arch(ZAMBA)
    model = build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    params = model.init(0, "cuda")
    napp = cfg.n_shared_attn_applications()
    print(f"[33 zamba2] {cfg.param_count() / 1e9:.2f} B parameters, whole "
          f"(81 layers, nothing cut)")
    ring_launches(rows, ring_serve(
        model, params, smi, 33, "shared_kv", napp,
        f"81 Mamba-2 layers, d_model 3584, d_inner 7168; the shared block "
        f"{napp} times: 32 q / 32 kv heads, G 1, D 112"))
    refusal = ring_checks(model, params, 33)
    peak = torch.cuda.max_memory_allocated()
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    prof = profile_decode(ZAMBA, reduced=False, max_len=RING_MAX_LEN,
                          prompt_len=4094, steps=4)
    eager = prof["eager"]
    check(prof["device_ms_per_tick"] > 0 and eager["device_ms_per_tick"] > 0,
          "the zamba2 profile saw no device time")
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[33 zamba2] --cache paged raises ValueError: {refusal!r}; peak "
          f"memory {peak / 1e9:.2f} GB; one decode tick profiled "
          f"(profile_decode --arch {ZAMBA} --full, 4 lanes at prompts of "
          f"4093, rings wrapping), graphed: host "
          f"{prof['host_ms_per_tick']:.3f} ms, device "
          f"{prof['device_ms_per_tick']:.3f} ms, busy share "
          f"{prof['busy_share']:.3f}, {prof['launches_per_tick']:.1f} device "
          f"operations a tick, graphs {prof['graphs']}; eager: host "
          f"{eager['host_ms_per_tick']:.3f} ms, device "
          f"{eager['device_ms_per_tick']:.3f} ms, busy share "
          f"{eager['busy_share']:.3f}, {eager['launches_per_tick']:.1f} "
          f"device operations a tick; top (graphed): "
          + ", ".join(f"{n[:48]} {ms:.3f} ms x{c:.0f}"
                      for n, ms, c in prof["kernels"][:5])
          + f"; phase 33 in {time.perf_counter() - t0:.1f}s")
    return rows


# --------------------------------------------------------------------------
# phase 34: pixtral-12b whole (40 layers; D 160, G 4; the vision stub)
# --------------------------------------------------------------------------

PIXTRAL = "pixtral-12b"
# pixtral's verify and chunk shapes (32 q / 8 kv heads of 160), as phi4's
PIXTRAL_VERIFY = ("pixtral verify", 32, 8, 160, 16, 64,
                  [839, 720, 190, 544, 0], [5, 5, 5, 5, 0], 5, BF16)
PIXTRAL_CHUNK = ("pixtral chunk at 384", 32, 8, 160, 16, 32, [384], [128],
                 128, BF16)
# the decode rows' lanes (pages of 16 as the paged serve's pool)
PIXTRAL_DECODE = [839, 720, 190, 544]
# (f): 4 lanes of the stub's 1024 patches in front of 256-token prompts
# (S' = 1280), then 32 greedy tokens
VISION = dict(lanes=4, prompt=256, new=32)


def vision_serve(model, params, smi: str) -> dict[str, int]:
    """34 (f): ``Model.prefill(frontend_embeds=)`` of 4 lanes of 1024
    seeded patch embeddings in front of a 256-token prompt, then 31 greedy
    ``decode_step`` calls (32 tokens), on the kernels with their counters
    zeroed just before: K1 once a layer over S' = 1280 (at the default
    tile), K2 once a layer a step (at the rule's cluster size), no paged
    kernel; TTFT (the prefill and its token) and the ITL (one step) on the
    host's clock.  Then the plain route's logits of the prefill and the
    first 4 steps, fed the kernel route's tokens, against the kernels'.
    Returns the launches."""
    cfg = model.cfg
    b, f, plen, new = (VISION["lanes"], cfg.frontend_seq, VISION["prompt"],
                       VISION["new"])
    s = f + plen
    gen = torch.Generator(device="cuda").manual_seed(34)
    patches = torch.randn((b, f, cfg.d_model), generator=gen,
                          device="cuda").to(BF16)
    prompt = torch.randint(0, cfg.vocab_size, (b, plen), generator=gen,
                           device="cuda")
    pos = lambda i: torch.full((b,), s + i, device="cuda")  # noqa: E731
    for kernel in KERNELS:
        kernel.launches = 0
    fa.flash_attention.last_kernel = fa.flash_decode.last_kernel = None
    k1_tiles = collections.Counter(fa.flash_attention.by_tile)
    with kernels_by_route(ops, "flash_decode") as k2_routes, \
            clusters_used() as clusters:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches = model.prefill(params, prompt, s + new,
                                       frontend_embeds=patches)
        tokens = [logits.argmax(-1)]
        torch.cuda.synchronize()
        ttft = time.perf_counter() - t0
        kern, itl = [logits], []
        for i in range(new - 1):
            t1 = time.perf_counter()
            logits, caches = model.decode_step(params, caches,
                                               tokens[-1][:, None], pos(i))
            tokens.append(logits.argmax(-1))
            torch.cuda.synchronize()
            itl.append(time.perf_counter() - t1)
            if i < 4:
                kern.append(logits)
    launches = {k.__name__: k.launches for k in KERNELS}
    n = cfg.n_layers
    only_launched(launches, (fa.flash_attention, fa.flash_decode),
                  "pixtral (f)")
    k1_tiles = fa.flash_attention.by_tile - k1_tiles
    check(launches["flash_attention"] == n and dict(k1_tiles) == {
        fa.TC_DEFAULT_TILE: n} and fa.flash_attention.last_kernel
          == fa.TC_KERNEL,
          f"pixtral (f): K1 launched {launches['flash_attention']} times, "
          f"by tile {dict(k1_tiles)}, on {fa.flash_attention.last_kernel}")
    c = pa.cluster_size(b, cfg.n_kv_heads, pa.sm_count(0), cfg.head_dim)
    check(launches["flash_decode"] == n * (new - 1)
          and dict(k2_routes) == {pa.DECODE_TC_KERNEL: n * (new - 1)}
          and dict(clusters) == {c: n * (new - 1)},
          f"pixtral (f): K2 launched {launches['flash_decode']} times, by "
          f"kernel {dict(k2_routes)}, by cluster size {dict(clusters)}")
    check(tuple(caches["kv"][0].shape) == (n, b, cfg.n_kv_heads, s + new,
                                           cfg.head_dim),
          f"pixtral (f): caches {tuple(caches['kv'][0].shape)}")
    out = torch.stack(tokens, 1)
    check(tuple(out.shape) == (b, new) and bool(
        ((out >= 0) & (out < cfg.padded_vocab)).all()),
        "pixtral (f): the greedy tokens")
    del caches
    plain, (logits, caches) = [], model.prefill(
        params, prompt, s + 5, use_kernel=False, frontend_embeds=patches)
    plain.append(logits)
    for i in range(4):
        logits, caches = model.decode_step(params, caches,
                                           tokens[i][:, None], pos(i),
                                           use_kernel=False)
        plain.append(logits)
    del caches
    vocab = cfg.padded_vocab
    verdict = check_logits(torch.stack(plain).reshape(-1, 1, vocab),
                           torch.stack(kern).reshape(-1, 1, vocab), vocab,
                           "pixtral (f) logits")
    itl_ms = sorted(1e3 * t for t in itl)
    print(f"[34 pixtral-12b (f) vision prefill] {b} lanes of {f} seeded "
          f"patch embeddings (frontend_proj) + a {plen}-token prompt (S' = "
          f"{s}) through Model.prefill(frontend_embeds=), then {new - 1} "
          f"greedy decode_step calls ({new} tokens a lane), on {smi}: TTFT "
          f"{ttft:.4f}s, ITL p50 {itl_ms[len(itl_ms) // 2]:.2f} ms (min "
          f"{itl_ms[0]:.2f}, max {itl_ms[-1]:.2f}), launches "
          f"{ {k: v for k, v in launches.items() if v} }, K1 by tile "
          f"{dict(k1_tiles)}, K2 clusters of c by launch {dict(clusters)}; "
          f"prefill + 4 steps, kernels vs plain (fed the same tokens, "
          f"{b} lanes): {verdict}")
    return launches


def pixtral_decode_rows(by_tile: dict, seed: int, h: int = 32, hkv: int = 8,
                        d: int = 160, tag: str = "[34 pixtral-12b kernels]",
                        shape: str = "pixtral decode",
                        kinds=("K3", "K6a", "K5a+K5c", "K6b+K5c")
                        ) -> list[dict]:
    """The kernels line's rows of the decode kernel at pixtral's shapes (4
    lanes of the phase-7 lengths, pages of 16, 32 q / 8 kv heads of 160;
    ``h``, ``hkv`` and ``d`` another geometry, phase 39's): of ``kinds``,
    K3 and K6a in one pass, K5a and K6b with K5c merged at 8 splits, at
    each key tile, against plain, timed beside the plain version, SDPA on
    the pre-gathered (int8: pre-dequantized bf16) K/V with a kv_len mask,
    and the bound; launches from the phase's serves, by tile."""
    b, psz, nblk = 4, 16, 64
    kv_len = PIXTRAL_DECODE
    rows, lines = [], []
    for label, quant, ns, line, wrapper in (
            (label, quant, ns, line, wrapper) for label, quant, ns, line,
            wrapper in (
            ("K3", False, 1, 491, pa.flash_paged_decode),
            ("K6a", True, 1, 951, pa.flash_paged_decode_quant),
            ("K5a+K5c", False, 8, 535, pa.paged_decode_split_merged),
            ("K6b+K5c", True, 8, 1001, pa.paged_decode_split_quant_merged))
            if label in kinds):
        q, kp, vp, table, lens = paged_case(b, h, hkv, d, psz, nblk, kv_len,
                                            BF16, seed + line)
        pools, _ = decode_pools(kp, vp, quant)
        paged = ops.PagedPools(*pools)
        kw = dict(k_scale=paged.k_scale, v_scale=paged.v_scale)
        want = plain_decode(q, pools, table, lens)
        k_pool, v_pool = paged.k, paged.v
        if quant:
            k_pool = paged.k.to(BF16) * paged.k_scale[..., None].to(BF16)
            v_pool = paged.v.to(BF16) * paged.v_scale[..., None].to(BF16)
        k_dense = ref.gather_pages(k_pool, table)   # gathered once, untimed
        v_dense = ref.gather_pages(v_pool, table)
        mask = (torch.arange(nblk * psz, device="cuda")[None, :]
                < lens[:, None])[:, None, None, :]
        library = time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k_dense, v_dense, attn_mask=mask, enable_gqa=True))
        if ns > 1:
            plain = time_ms(lambda: ref.paged_decode_split_ref(
                q, paged.k, paged.v, table, lens, ns, **kw))
        else:
            plain = time_ms(lambda: plain_decode(q, pools, table, lens))
        n_bytes = decode_bytes(kv_len, b, h, hkv, d, psz, 1 if quant else 2,
                               2, 4 if quant else 0)
        n_ops = 4 * h * sum(kv_len) * d
        for bk in pa.decode_block_ks(BF16, d):
            def run(bk=bk):
                return ops.paged_decode(q, paged, table, lens,
                                        num_splits=ns, block_k=bk)
            n = wrapper.by_tile[bk]
            got = run()
            check(wrapper.by_tile[bk] == n + 1
                  and wrapper.last_kernel == pa.DECODE_TC_KERNEL,
                  f"{tag} {label} block_k {bk}: {wrapper.__name__} did not "
                  f"launch at the tile on {pa.DECODE_TC_KERNEL}")
            err = compare(got, want, BF16)
            times = {"ms": time_ms(run), "plain_ms": plain,
                     "library_ms": library}
            r = row(f"{wrapper.__name__}[D{d} G{h // hkv} {bk}]",
                    DECODE_SOURCE, f"{FLASH}:{line}", err, n_bytes, n_ops,
                    times)
            r.update(launches=by_tile.get(wrapper.__name__, {}).get(bk, 0),
                     shape=f"{shape} B={b} kv_len {kv_len}",
                     tile=[bk])
            if ns > 1:
                r["merges"] = f"{FLASH}:315"
            check(r["launches"] > 0 or bk != pa.DECODE_TILE_KEYS,
                  f"{tag} {label} block_k {bk}: no launch in the serves")
            rows.append(r)
            c = ""
            if ns == 1:     # the rule's cluster size, and each one timed
                by_c = {n: time_ms(lambda n=n: wrapper(
                    q, *pools, table, lens, block_k=bk, _cluster=n))[0]
                    for n in pa.CLUSTER_SIZES}
                rule = pa.cluster_size(b, hkv, pa.sm_count(0), d, bk, quant)
                c = f", c={rule} (by cluster size " + ", ".join(
                    f"c={n} {t:.4f}" for n, t in by_c.items()) + ")"
            lines.append(f"{label} block_k {bk}{c}: {fmt_times(times)}, bound "
                         f"{r['bound_ms']:.5f} ms ({r['bound_by']}), err "
                         f"{err:.2e}, {r['launches']} launches in the serves")
    check(counters_zero(), f"{tag} an arrival counter is not 0")
    print(f"{tag} the decode kernel at D {d}, G {h // hkv} (4 "
          f"lanes of {kv_len} keys in pages of 16), against plain (tol "
          f"{TOL[BF16]}), device ms (ms per call incl. host; library: SDPA "
          f"on the pre-gathered K/V): " + "; ".join(lines))
    return rows


def phase_pixtral(smi: str) -> list[dict]:
    """Phase 34: pixtral-12b whole at published widths (40 layers, random
    bf16 weights from seed 0; nothing cut): the serves (a)-(e) of phase 28
    (dense, paged, int8 at 8 splits, speculative over bf16 and int8
    pages) and (c1) int8 in one pass, (c2) bf16 at 8 splits (so every
    D-160 kernel serves), their logits against plain, (f) the vision prefill through the
    stub, then the kernels at D 160 and G 4 against plain and timed: K1 at
    every tile over the vision prefill's S', K2 at both key tiles over its
    lanes, the decode kernel's K3, K6a, K5a and K6b, and the prefill
    kernel's K4, K6c, K5b and K6d at every tile of the D-160 ladder."""
    t0 = time.perf_counter()
    cfg = get_arch(PIXTRAL)
    model = build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    params = model.init(0, "cuda")
    check(tuple(params["frontend_proj"].shape) == (cfg.d_model, cfg.d_model),
          "pixtral's patch projection")
    weights = sum(t.numel() for t in tree_leaves(params))
    print(f"[34 pixtral-12b] {weights / 1e9:.2f} B parameters "
          f"({cfg.param_count() / 1e9:.2f} B in the analytic count, which "
          f"leaves out frontend_proj), {2 * weights / 1e9:.1f} GB of bf16 "
          f"weights, whole (40 layers, nothing cut); decode clusters of c = "
          f"{pa.cluster_size(4, cfg.n_kv_heads, pa.sm_count(0), 160)} at 4 "
          f"lanes (D 160, 64 keys: one CTA an SM)")
    by_tile = dense_arch_serves(
        model, params, smi, "pixtral",
        f"[34 pixtral-12b serves] {PIXTRAL} full (40 layers, d_model 5120, "
        f"32 q / 8 kv heads, G 4, D 160), text only",
        (pa.default_block_q(160, 4), pa.TC_TILE_KEYS),
        every_paged_mode=True)
    tag = f"[34 logits] {PIXTRAL} full"
    phase_logits(model, params, tag)
    phase_paged_logits(model, params, tag)
    phase_int8_logits(model, params, tag)
    phase_verify_logits(model, params, tag)
    launches = vision_serve(model, params, smi)
    peak = torch.cuda.max_memory_allocated()
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    for name in ("flash_attention", "flash_decode"):
        by_tile[name].update(
            {fa.TC_DEFAULT_TILE if name == "flash_attention"
             else pa.DECODE_TILE_KEYS: launches[name]})
    rows = pixtral_dense_rows(smi, by_tile)
    rows += pixtral_decode_rows(by_tile, 3400)
    rows += tile_rows("[34 pixtral-12b kernels]", 4,
                      "32 q / 8 kv heads of 160; the D-160 ladder",
                      PIXTRAL_CHUNK, PIXTRAL_VERIFY, by_tile, 3450,
                      served=[(pa.default_block_q(160, 4),
                               pa.TC_TILE_KEYS)], d=160)
    print(f"[34 pixtral-12b] peak memory {peak / 1e9:.2f} GB; phase 34 in "
          f"{time.perf_counter() - t0:.1f}s")
    return rows


def pixtral_dense_rows(smi: str, by_tile: dict) -> list[dict]:
    """K1 at every tile over the vision prefill's shape (4 lanes, S' =
    1280, causal) and K2 at both key tiles over its decode lanes (strips
    of 1312 slots), against plain, timed beside SDPA and the bound, with
    their launches from the phase's runs by tile."""
    h, hkv, d = 32, 8, 160
    b, s = VISION["lanes"], 1024 + VISION["prompt"]
    rows, lines = [], []
    q, k, v = (randn((b, n, s, d), 3400 + j, BF16)
               for j, n in enumerate((h, hkv, hkv)))
    default = fa.flash_attention(q, k, v)
    for tile in fa.attention_tiles(BF16, d):
        r, line = k1_kernel_row(f"D{d} {tile[0]}x{tile[1]}", q, k, v,
                                dict(causal=True), None,
                                f"pixtral vision prefill B={b} S'={s}", tile)
        same = bool(torch.equal(fa.flash_attention(
            q, k, v, block_q=tile[0], block_k=tile[1]), default))
        check(same, f"[34] K1 {tile} is not bit-equal to the default tile")
        r["launches"] = by_tile["flash_attention"].get(tile, 0)
        rows.append(r)
        lines.append(line + f", {r['launches']} launches in the phase")
    del q, k, v, default
    slots = s + VISION["new"]
    kv_len = torch.tensor([s + 31, s + 20, s + 9, s], dtype=torch.int32,
                          device="cuda")
    q = randn((b, h, 1, d), 3410, BF16)
    k = randn((b, hkv, slots, d), 3411, BF16)
    v = randn((b, hkv, slots, d), 3412, BF16)
    for bk in pa.decode_block_ks(BF16, d, dense=True):
        r, line = k2_kernel_row(f"D{d} {bk}", q, k, v, kv_len,
                                f"pixtral decode B={b} strips of {slots}",
                                bk)
        r["launches"] = by_tile["flash_decode"].get(bk, 0)
        check(r["launches"] > 0 or bk != pa.DECODE_TILE_KEYS,
              "[34] K2: no launch in the phase")
        rows.append(r)
        lines.append(line + f", {r['launches']} launches in the phase")
    print(f"[34 pixtral-12b kernels] K1 and K2 at D 160, G 4, against plain "
          f"(tol {TOL[BF16]}), device ms (ms per call incl. host) on {smi}: "
          + "; ".join(lines))
    return rows


# --------------------------------------------------------------------------
# phase 35: training
# --------------------------------------------------------------------------

AUTOGRAD_SOURCE = "src/repro_torch/kernels/autograd.py"
#: (b): yi-6b's published widths cut to 12 of 32 layers (float32 weights,
#: gradients and AdamW moments: 16 B a parameter)
TRAIN = dict(arch="yi-6b", layers=12, batch=4, seq=1024, steps=6, lr=3e-4,
             warmup=2)
#: (b2): falcon-mamba-7b's published widths cut to 4 of 64 layers
TRAIN_SSM = dict(arch=FM, layers=4, batch=1, seq=512, steps=3, lr=3e-4,
                 warmup=1)
#: the steps of the microbatch and remat pairs of (b): a warm-up (and the
#: capture), a timed step, a profiled step
PAIR_STEPS = 3
#: (d): one family each that (b) and (b2) do not train, at published
#: widths, cut in depth (``layers`` None: whole); 2 steps, graphed (the
#: second a replay) against eager
TRAIN_FAMILIES = (
    dict(arch="moonshot-v1-16b-a3b", layers=2, batch=1, seq=512,
         cut="cut to 2 of 48 layers (MoE: 64 experts, top 6)"),
    dict(arch="zamba2-7b", layers=6, batch=1, seq=512,
         cut="cut to 6 of 81 layers (the shared block applied once, after "
             "layer 6)"),
    dict(arch="pixtral-12b", layers=2, batch=1, seq=256,
         cut="cut to 2 of 40 layers (1024 patches in front: S' 1280)"),
    dict(arch="h2o-danube-1.8b", layers=2, batch=2, seq=512,
         cut="cut to 2 of 24 layers (window 4096)"),
    dict(arch="whisper-tiny", layers=None, batch=2, seq=256,
         cut="whole (4 encoder + 4 decoder layers, 1500 frames)"))
FN_TOL = 2e-2          # of each tensor's scale (max |plain|)


def fn_errors(got, want) -> list[float]:
    """Each pair's max |got - want| over max |want|; raises past FN_TOL
    or on a non-finite value."""
    torch.cuda.synchronize()
    errs = []
    for g, w in zip(got, want):
        g, w = g.float(), w.float()
        check(bool(torch.isfinite(g).all()), "a gradient is not finite")
        errs.append(float((g - w).abs().max() / w.abs().max()))
    check(max(errs) <= FN_TOL, f"Function vs plain autograd: scaled errors "
          f"{errs} over {FN_TOL}")
    return errs


def grad_leaf(t: torch.Tensor) -> torch.Tensor:
    return t.detach().clone().requires_grad_(True)


def attention_fn_case(label, b, h, hkv, sq, sk, d, kw, seed) -> dict:
    """K1's Function through ``ops.attention`` (grad on) against autograd
    through ``ref.attention_ref`` on the same bf16 inputs: the output and
    dq, dk, dv.  Returns the case's tensors and errors."""
    q, k, v = (grad_leaf(randn((b, n, s, d), seed + j, BF16))
               for j, (n, s) in enumerate(((h, sq), (hkv, sk), (hkv, sk))))
    do = randn((b, h, sq, d), seed + 3, BF16)
    n0 = FlashAttentionFn.launches
    out = ops.attention(q, k, v, **kw)
    check(FlashAttentionFn.launches == n0 + 1
          and type(out.grad_fn).__name__ == "FlashAttentionFnBackward",
          f"[35a] {label}: ops.attention did not go through FlashAttentionFn")
    got = (out, *torch.autograd.grad(out, (q, k, v), do))
    want_o = ref.attention_ref(q, k, v, **kw)
    want = (want_o, *torch.autograd.grad(want_o, (q, k, v), do))
    errs = fn_errors(got, want)
    err = max(float((g.float() - w.float()).abs().max())
              for g, w in zip(got, want))
    return dict(q=q, k=k, v=v, do=do, errs=errs, err=err)


def attention_pairs(sq: int, sk: int, kw: dict) -> int:
    if kw.get("window") is not None:
        w = kw["window"]
        return sum(min(i + 1, w) for i in range(sq))
    return sq * (sq + 1) // 2 if kw.get("causal") else sq * sk


def phase_train_functions(smi: str) -> list[dict]:
    """(a): K1's and K9's Functions against autograd of their plain
    versions, and their forward + backward timed.  Returns their two
    rows (launches filled in by (b) and (b2))."""
    lines = []
    cases = [("trainer yi-6b B2 S1024", 2, 32, 4, 1024, 1024, 128,
              dict(causal=True)),
             ("whisper cross 224x1500", 4, 6, 6, 224, 1500, 64,
              dict(causal=False)),
             ("h2o-danube D80 window 512", 2, 32, 8, 1024, 1024, 80,
              dict(causal=True, window=512))]
    main = None
    for i, (label, b, h, hkv, sq, sk, d, kw) in enumerate(cases):
        c = attention_fn_case(label, b, h, hkv, sq, sk, d, kw, 3500 + 10 * i)
        lines.append(f"{label}: out, dq, dk, dv within "
                     + ", ".join(f"{e:.2e}" for e in c["errs"]))
        if main is None:
            main, main_kw = c, kw
    q, k, v, do = main["q"], main["k"], main["v"], main["do"]

    def fwd_bwd(fn):
        return lambda: torch.autograd.grad(fn(), (q, k, v), do)

    kern = fwd_bwd(lambda: FlashAttentionFn.apply(q, k, v, True, None, {}))
    plain = fwd_bwd(lambda: ref.attention_ref(q, k, v, causal=True))
    sdpa = fwd_bwd(lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True))
    times = {"ms": time_ms(kern), "plain_ms": time_ms(plain),
             "library_ms": time_ms(sdpa)}
    b, h, sq, d = q.shape
    pairs = attention_pairs(sq, sq, main_kw)
    # read q, k, v, dO; write O, dq, dk, dv (bf16); 7 products of 2 D
    # operations per visible (query, key) pair a head: 2 forward, 5 back
    n_bytes = 2 * (2 * q.numel() + k.numel() + v.numel()) \
        + 2 * (q.numel() + k.numel() + v.numel())
    n_ops = 7 * 2 * b * h * pairs * d
    r1 = row("FlashAttentionFn[fwd+bwd yi-6b train B2 S1024]",
             AUTOGRAD_SOURCE, f"{FLASH}:106", main["err"], n_bytes, n_ops,
             times)
    r1.update(forward=SOURCE, shape="B 2, 32 q / 4 kv heads of 128, S 1024, "
              "causal, bf16", backward="closed form, float32 PyTorch ops")
    lines.append(f"K1 Function fwd+bwd at the trainer's shape: "
                 f"{fmt_times(times)} (library: SDPA fwd+bwd), bound "
                 f"{r1['bound_ms']:.5f} ms ({r1['bound_by']}, bf16 peak)")
    del q, k, v, do, main

    bs, length, di, n = 1, 128, SSM_SHAPE["d_inner"], SSM_SHAPE["d_state"]
    args = tuple(grad_leaf(t) for t in ssm_case(bs, length, di, n, 3550,
                                                BF16))
    gy = randn((bs, length, di), 3560, BF16)
    n0 = SelectiveScanFn.launches
    y = ops.ssm_scan(*args)
    check(SelectiveScanFn.launches == n0 + 1
          and type(y.grad_fn).__name__ == "SelectiveScanFnBackward",
          "[35a] ops.ssm_scan did not go through SelectiveScanFn")
    got = (y, *torch.autograd.grad(y, args, gy))
    want_y = ref.selective_scan_ref(*args)
    want = (want_y, *torch.autograd.grad(want_y, args, gy))
    errs = fn_errors(got, want)
    err = max(float((g.float() - w.float()).abs().max())
              for g, w in zip(got, want))
    lines.append(f"K9 B{bs} L{length} Di{di} N{n}: y, dx, d dt, dA, dB, dC, "
                 "dD within " + ", ".join(f"{e:.2e}" for e in errs))
    times = {"ms": time_ms(lambda: torch.autograd.grad(
                 SelectiveScanFn.apply(*args, {}), args, gy), iters=5),
             "plain_ms": time_ms(lambda: torch.autograd.grad(
                 ref.selective_scan_ref(*args), args, gy), iters=3),
             "library_ms": None}
    # bytes: x, dt, B, C, D, gy read and y, dx, d dt, dB, dC, dD written
    # (bf16), A read and dA written (float32); float32 operations: the
    # forward's 6 N + 2 a (b, t, d), the backward's 20 N + 4 (the states
    # recomputed, the state gradient, dC, dB, dx, d dt, dA); two exps a
    # (b, t, d, n), forward and recomputed
    elems = bs * length * di
    n_bytes = 2 * (2 * (3 * elems + 2 * bs * length * n + di)) + 8 * di * n
    n_ops = elems * (26 * n + 6)
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_OPS_PER_S[torch.float32] * 1e3
    t_exp, rate = exp_floor_ms(2 * elems * n)
    bound_ms, bound_by = ((t_bytes, "bytes") if t_bytes >= max(t_ops, t_exp)
                          else (max(t_ops, t_exp), "operations"))
    # the same forward + backward captured once as a CUDA graph (the
    # inputs persistent, gy per-tick) and replayed: the reverse loop's
    # launches leave the host.  Fresh leaves: ``y`` keeps the eager
    # graph of ``args`` alive, its AccumulateGrad nodes on the default
    # stream, which a capture on another stream cannot wait for
    def k9_fwd_bwd(xs, g):
        return torch.autograd.grad(SelectiveScanFn.apply(*xs, {}), xs, g)
    leaves = tuple(grad_leaf(t) for t in args)
    graphed = compile_step(k9_fwd_bwd, "K9 fwd+bwd")
    g_times = time_ms(lambda: graphed(leaves, gy), iters=5)
    g_out = [t.clone() for t in graphed(leaves, gy)]
    e_out = k9_fwd_bwd(leaves, gy)
    fn_errors(g_out, e_out)
    g_bits = all(torch.equal(a, b) for a, b in zip(g_out, e_out))
    check(graphed.captures == 1 and graphed.recaptures == 0
          and graphed.replays >= 5, f"[35a] K9 graphed: {graphed.captures} "
          f"captures, {graphed.replays} replays")
    r2 = {"name": f"SelectiveScanFn[fwd+bwd B{bs} L{length} Di{di} N{n}]",
          "route": "cuda", "source": AUTOGRAD_SOURCE,
          "replaces": "src/repro/kernels/ssm_scan.py:74", "max_abs_err": err,
          "ms": times["ms"][0], "plain_ms": times["plain_ms"][0],
          "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
          "graphed_ms": g_times[0],
          "forward": SSM_SOURCE, "backward": "reverse-time loop over L, "
          "float32 PyTorch ops"}
    lines.append(f"K9 Function fwd+bwd: {fmt_times(times)}, bound "
                 f"{bound_ms:.5f} ms ({bound_by}; bytes {t_bytes:.5f}, "
                 f"float32 operations {t_ops:.5f}, exps {t_exp:.5f} ({rate}))"
                 f"; graphed (one capture, {graphed.replays} replays) "
                 f"{g_times[0]:.4f} ms ({g_times[1]:.4f}) against eager "
                 f"{times['ms'][0]:.4f} ({times['ms'][1]:.4f}), gradients "
                 f"{'bit-equal' if g_bits else 'within the tolerance'}")
    del args, gy, y, got, want, want_y, graphed, g_out, e_out, leaves
    print(f"[35a train Functions] against autograd of the plain versions "
          f"(tol {FN_TOL} of each tensor's scale), device ms (ms per call "
          f"incl. host) on {smi}: " + "; ".join(lines))
    return [r1, r2]


def train_setup(spec: dict, use_kernel=None, **plan_kw):
    """The cut config, fresh float32 weights (seed 0), AdamW state, the
    step function and the batches of ``spec``."""
    cfg = get_arch(spec["arch"])
    if spec.get("layers") is not None:
        cfg = dataclasses.replace(cfg, n_layers=spec["layers"])
    model = build_model(cfg)
    params = model.init(0, "cuda", dtype=cfg.param_dtype)
    opt = adamw.init(params)
    step = build_train_step(
        model, LayoutPlan(name="smoke", **plan_kw),
        adamw.AdamWConfig(lr=spec.get("lr", 3e-4),
                          warmup_steps=spec.get("warmup", 1),
                          total_steps=spec.get("steps", 2)),
        use_kernel=use_kernel)
    # a frontend's frames or patches in the batch, as launch/train.py's
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=spec["seq"],
                      global_batch=spec["batch"], seed=0,
                      frontend_seq=cfg.frontend_seq if cfg.frontend != "none"
                      or cfg.is_encoder_decoder else 0,
                      d_model=cfg.d_model)
    return cfg, params, opt, step, dcfg


#: kernel-name patterns of the step's device time by kind, in order
KERNEL_KINDS = (("K1", ("flash_attention",)),
                ("K9", ("ssm_scan",)),
                ("float32 products", ("f32f32", "sgemm")),
                ("bf16 products", ("gemm", "nvjet", "xmma", "cutlass")),
                ("elementwise, casts, reductions", ("elementwise", "reduce",
                                                    "copy", "softmax",
                                                    "index", "scatter",
                                                    "gather", "cat")))


def device_breakdown(prof, wall_s: float) -> tuple[str, float]:
    """A profiled step's device time: the sum over kernels, the busy
    share of the step's wall time, the sums by kind (the first pattern a
    kernel's name holds; K1's float32 backward and the optimizer are in
    "float32 products" and "elementwise") and the 6 kernels that take
    most; and the busy share."""
    us = {e.key: e.self_device_time_total for e in prof.key_averages()
          if e.device_type == torch.autograd.DeviceType.CUDA
          and e.self_device_time_total > 0}
    total = sum(us.values()) / 1e3
    check(total > 0, "[35b] the profiled step shows no device time")
    kinds = collections.Counter()
    for key, t in us.items():
        kind = next((k for k, pats in KERNEL_KINDS
                     if any(p in key.lower() for p in pats)), "other")
        kinds[kind] += t / 1e3
    top = sorted(us.items(), key=lambda kv: -kv[1])[:6]
    busy = total / (wall_s * 1e3)
    return (f"device {total:.1f} ms of {wall_s * 1e3:.1f} ms wall (busy "
            f"share {busy:.3f}); by kind "
            + ", ".join(f"{k} {v:.1f}" for k, v in kinds.most_common())
            + " ms; top kernels: "
            + "; ".join(f"{k[:60]} {v / 1e3:.1f} ms" for k, v in top)), busy


def events_ms(fn, n: int = 3) -> float:
    """Mean device ms of ``fn`` over ``n`` calls after one more, by CUDA
    events around each (no L2 flush: a step's work is far past 50 MB)."""
    fn()
    marks = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(n)]
    for start, end in marks:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in marks) / n


def step_parts(spec: dict, model, params, opt, batch) -> str:
    """The step's forward (the loss without a graph) and AdamW's update
    (on gradients of the params' shapes) timed alone; the backward is
    what the step takes beyond them."""
    plan = LayoutPlan(name="smoke")
    forward = build_eval_loss(model, plan)
    fwd = events_ms(lambda: forward(params, batch))
    grads = [torch.randn_like(p) for p in adamw.leaves(params)]
    cfg = adamw.AdamWConfig(lr=spec["lr"], warmup_steps=spec["warmup"],
                            total_steps=spec["steps"])
    upd = events_ms(lambda: adamw.update(grads, opt, params, cfg))
    return f"forward (no graph) {fwd:.1f} ms, AdamW update {upd:.1f} ms"


def named_leaves(tree: dict, prefix: str = ""):
    for key, v in tree.items():
        if isinstance(v, dict):
            yield from named_leaves(v, f"{prefix}{key}.")
        else:
            yield prefix + key, v


def group_norm_hooks(params: dict, nmb: int):
    """Hooks on the layer leaves that gather one step's gradient of two
    groups, summed over its ``nmb`` microbatches: the sequence mixer's
    leaves (attention's wq/wk/wv/wo, or the scan's) whole, and layer 0's
    slice of every layer leaf.  At random init the head and the
    embedding dominate the global norm, so a route that dropped the
    mixer's gradient would barely move it; these norms would move by
    ~1.  Returns (handles, norms): ``norms()`` gives {group: norm} after
    the step.  With one microbatch a hook keeps a squared norm only;
    with more it sums float32 copies (~2.5 GB at yi-6b's 12 layers)."""
    layers = params["layers"]
    mixer = "attn." if "attn" in layers else "ssm."
    sums: dict = {}

    def hook(key: tuple, sel):
        def fn(g):
            g = sel(g).detach().float()
            if nmb == 1:
                sums[key] = torch.linalg.vector_norm(g) ** 2
            elif key in sums:
                sums[key].add_(g)
            else:
                sums[key] = g.clone()
        return fn

    handles = []
    for name, p in named_leaves(layers):
        p.requires_grad_(True)
        handles.append(p.register_hook(hook(("layer 0", name),
                                            lambda g: g[0])))
        if name.startswith(mixer):
            handles.append(p.register_hook(hook(("mixer", name),
                                                lambda g: g)))

    def norms() -> dict:
        sq = collections.Counter()
        for (group, _), v in sums.items():
            sq[group] += float(v if nmb == 1 else
                               torch.linalg.vector_norm(v / nmb) ** 2)
        sums.clear()
        return {group: sq[group] ** 0.5 for group in ("mixer", "layer 0")}
    return handles, norms


def pool_bytes() -> tuple[int, int]:
    """The caching allocator's reserved bytes: (the default pool's, the
    graphs' private pools')."""
    default = private = 0
    for seg in torch.cuda.memory_snapshot():
        if tuple(seg.get("segment_pool_id", (0, 0))) == (0, 0):
            default += seg["total_size"]
        else:
            private += seg["total_size"]
    return default, private


class HooksOff(compiled.CudaGraphs):
    """The capture seam with ``group_norm_hooks``' handles removed just
    before the capture: the warm-up (the first step, a real one) feeds
    the hooks; a hook left in would run inside the capture and record
    writes to buffers that the replays never compute.  Also records what
    the capture reserved in the default pool and in the private pools
    (``pools``): the backward runs on autograd's device thread, and
    every allocation the capture makes, the backward's included, must
    land in the graph's pool."""

    def __init__(self, handles: list):
        self.handles = handles
        self.pools = None

    def capture(self, call, stream, device):
        for handle in self.handles:
            handle.remove()
        torch.cuda.empty_cache()
        before = pool_bytes()
        out = super().capture(call, stream, device)
        after = pool_bytes()
        self.pools = tuple(b - a for a, b in zip(before, after))
        return out


def host_leaves(params: dict) -> list[torch.Tensor]:
    return [p.detach().cpu() for p in adamw.leaves(params)]


def leaves_diff(params: dict, host: list[torch.Tensor]) -> float:
    """The largest |param - host| over every leaf."""
    return max(float((p.detach() - h.to(p.device)).abs().max())
               for p, h in zip(adamw.leaves(params), host))


def train_run(spec: dict, n_steps: int, use_kernel=None, profile=False,
              graphed=False, hooks=True, parts=False, against=None,
              keep=False, **plan_kw) -> dict:
    """``n_steps`` steps from fresh weights, every kernel counter zeroed
    just before and read just after, each step synchronised and timed
    (with ``profile``, the last under ``torch.profiler``; with ``parts``
    the forward and AdamW's update timed alone after it); the first
    step's group grad norms (``group_norm_hooks``, with ``hooks``) under
    ``groups``.  ``graphed``: the step compiled as the trainer compiles
    it (``compile_step(..., per_tick=("batch",))``), its graphs under
    ``graphs``.  ``against``: host leaves to hold the last parameters to
    (``diff``); ``keep``: the last parameters' host leaves (``host``)."""
    cfg, params, opt, step, dcfg = train_setup(spec, use_kernel, **plan_kw)
    handles, group_norms = (group_norm_hooks(
        params, plan_kw.get("num_microbatches", 1)) if hooks
        else ([], dict))
    seam = HooksOff(handles)
    if graphed:
        step = compile_step(step, "train", backend=seam, per_tick=("batch",))
    batches = [{k: v.cuda() for k, v in batch_for_step(dcfg, s).items()}
               for s in range(n_steps)]
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for kernel in KERNELS + ag.FUNCTIONS:
        kernel.launches = 0
    losses, norms, times, breakdown, busy = [], [], [], None, None
    for i, batch in enumerate(batches):
        prof = (torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
            if profile and i == n_steps - 1 else contextlib.nullcontext())
        with prof:
            t0 = time.perf_counter()
            params, opt, metrics = step(params, opt, batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
        if i == 0:
            for handle in handles:
                handle.remove()
            groups = group_norms()
    launches = {k.__name__: k.launches
                for k in KERNELS + ag.FUNCTIONS}
    peak = torch.cuda.max_memory_allocated()
    reserved = torch.cuda.max_memory_reserved()
    graphs = compiled.graph_stats([step])
    if profile:                 # after the peak: the parts take memory
        breakdown, busy = device_breakdown(prof, times[-1])
        if parts:
            breakdown += "; " + step_parts(spec, build_model(cfg), params,
                                           opt, batches[-1])
    n_params = sum(t.numel() for t in adamw.leaves(params))
    diff = None if against is None else leaves_diff(params, against)
    host = host_leaves(params) if keep else None
    del params, opt, step, batches
    gc.collect()
    torch.cuda.empty_cache()
    check(all(np.isfinite(losses)) and all(np.isfinite(norms))
          and all(np.isfinite(list(groups.values()))),
          f"[35] {spec['arch']}: a loss or grad norm is not finite: "
          f"{losses} {norms} {groups}")
    return dict(losses=losses, norms=norms, groups=groups, times=times,
                peak=peak, reserved=reserved, launches=launches,
                n_params=n_params, cfg=cfg, breakdown=breakdown, busy=busy,
                graphs=graphs, diff=diff, host=host, pools=seam.pools)


AGREE_TOL = 1e-3        # relative: the first step's loss and grad norm
GROUP_TOL = 1e-2        # relative: the mixer's and layer 0's grad norms


def agree(what: str, run: dict, ref_run: dict) -> str:
    """The first step's loss and global grad norm within AGREE_TOL and
    its group grad norms within GROUP_TOL, relative to ``ref_run``'s
    (the same weights and batch)."""
    def off(a: float, b: float) -> float:
        return abs(a / b - 1)
    dl = off(run["losses"][0], ref_run["losses"][0])
    dn = off(run["norms"][0], ref_run["norms"][0])
    dg = {g: off(run["groups"][g], ref_run["groups"][g])
          for g in ref_run["groups"]}
    check(dl <= AGREE_TOL and dn <= AGREE_TOL
          and max(dg.values()) <= GROUP_TOL,
          f"[35] {what}: loss {run['losses'][0]} / grad norm "
          f"{run['norms'][0]} / groups {run['groups']} against "
          f"{ref_run['losses'][0]} / {ref_run['norms'][0]} / "
          f"{ref_run['groups']}")
    return (f"{what}: loss {run['losses'][0]:.4f} ({dl:.1e} off), grad norm "
            f"{run['norms'][0]:.4f} ({dn:.1e} off), "
            + ", ".join(f"{g} {run['groups'][g]:.4f} ({d:.1e} off)"
                        for g, d in dg.items())
            + f", peak {run['peak'] / 1e9:.2f} GB")


def only_train_kernels(launches: dict, fn, wrapper, per_step: int,
                       n_steps: int, what: str) -> None:
    """The run launched ``fn``'s kernel (through ``fn``) once per layer
    per step and no other kernel."""
    want = per_step * n_steps
    check(launches[fn.__name__] == launches[wrapper.__name__] == want,
          f"[35] {what}: {launches[fn.__name__]} launches through "
          f"{fn.__name__}, {launches[wrapper.__name__]} of "
          f"{wrapper.__name__}, expected {want}")
    others = {k: n for k, n in launches.items()
              if n and k not in (fn.__name__, wrapper.__name__)}
    check(not others, f"[35] {what}: other kernels launched: {others}")


def step_ms(run: dict) -> float:
    """The run's step time (ms): the median of the steps after the first
    (the warm-up and, graphed, the capture) and before a profiled last."""
    times = run["times"][1:-1] if run["breakdown"] else run["times"][1:]
    return float(np.median(times)) * 1e3


def rel_off(a: list[float], b: list[float]) -> float:
    return max(abs(x / y - 1) for x, y in zip(a, b))


def train_pair(spec: dict, n_steps: int, what: str, noise: bool = True,
               profile: bool = True, parts: bool = False,
               hooks: bool = True, **plan_kw) -> tuple[dict, dict, str]:
    """``n_steps`` steps eager (its last parameters kept on the host),
    the same steps graphed (the trainer's compiled step) from the same
    weights and batches, held to it, and with ``noise`` the eager steps
    again, their last parameters held to the first eager run's (the
    backward's atomics): every step's loss and grad norm within
    AGREE_TOL relative, one capture and a replay every later step, the
    launches equal.  Returns (graphed, eager, the line that reports
    both)."""
    kw = dict(profile=profile, hooks=hooks, **plan_kw)
    eager = train_run(spec, n_steps, keep=True, parts=parts, **kw)
    graphed = train_run(spec, n_steps, graphed=True, against=eager["host"],
                        **kw)
    again = (train_run(spec, n_steps, hooks=False, against=eager["host"],
                       **plan_kw)["diff"] if noise else None)
    eager["host"] = None
    g, e = graphed["graphs"], eager["graphs"]
    check((g["captures"], g["replays"], g["recaptures"])
          == (1, n_steps - 1, 0) and e["captures"] == 0,
          f"[35] {what}: graphed {g}, eager {e}")
    dl = rel_off(graphed["losses"], eager["losses"])
    dn = rel_off(graphed["norms"], eager["norms"])
    check(dl <= AGREE_TOL and dn <= AGREE_TOL,
          f"[35] {what}: graphed losses {graphed['losses']} / grad norms "
          f"{graphed['norms']} against eager {eager['losses']} / "
          f"{eager['norms']}")
    check(graphed["launches"] == eager["launches"],
          f"[35] {what}: launches graphed {graphed['launches']}, eager "
          f"{eager['launches']}")
    fns = {f.__name__: graphed["launches"][f.__name__] for f in ag.FUNCTIONS
           if graphed["launches"][f.__name__]}

    def busy(run):
        return "not profiled" if run["busy"] is None else f"{run['busy']:.3f}"
    line = (f"{what}: {g['captures']} capture, {g['replays']} replays, "
            f"{g['recaptures']} recaptures; losses graphed "
            + ", ".join(f"{x:.6f}" for x in graphed["losses"])
            + " / eager " + ", ".join(f"{x:.6f}" for x in eager["losses"])
            + f" ({dl:.1e} off), grad norms graphed "
            + ", ".join(f"{x:.6f}" for x in graphed["norms"])
            + " / eager " + ", ".join(f"{x:.6f}" for x in eager["norms"])
            + f" ({dn:.1e} off); the last parameters' largest difference "
            f"graphed - eager {graphed['diff']:.3e}"
            + ("" if again is None else f" (eager - eager {again:.3e})")
            + f"; step {step_ms(graphed):.1f} ms graphed / "
            f"{step_ms(eager):.1f} eager (first step, with the warm-up and "
            f"the capture, {graphed['times'][0] * 1e3:.1f} / "
            f"{eager['times'][0] * 1e3:.1f}); busy share {busy(graphed)} / "
            f"{busy(eager)}; peak allocated {graphed['peak'] / 1e9:.2f} / "
            f"{eager['peak'] / 1e9:.2f} GB, reserved "
            f"{graphed['reserved'] / 1e9:.2f} / {eager['reserved'] / 1e9:.2f}"
            f" GB; the capture reserved {graphed['pools'][1] / 1e9:.2f} GB "
            f"in its private pool, {graphed['pools'][0] / 1e9:.2f} GB in the "
            f"default pool; launches equal ({fns})")
    check(graphed["pools"][0] <= 0, f"[35] {what}: the capture reserved "
          f"{graphed['pools'][0]} bytes in the default pool")
    return graphed, eager, line


def phase_train(smi: str) -> tuple[dict[str, int], float]:
    """(b), (b2) and (c).  Returns the Functions' launches in the main
    path's (graphed) runs and (b)'s graphed step time (s)."""
    t0 = time.perf_counter()
    spec = TRAIN
    n = spec["steps"]
    main, main_eager, main_line = train_pair(spec, n, "yi-6b", parts=True)
    cfg = main["cfg"]
    tokens = spec["batch"] * spec["seq"]
    only_train_kernels(main["launches"], FlashAttentionFn, fa.flash_attention,
                       cfg.n_layers, n, "yi-6b")
    losses = main["losses"]
    check(np.mean(losses[4:6]) < np.mean(losses[0:2]),
          f"[35b] yi-6b: the loss did not fall: {losses}")
    step_s = step_ms(main) / 1e3
    per_layer = (main["n_params"] - 2 * cfg.padded_vocab * cfg.d_model) \
        / cfg.n_layers
    print(f"[35b train yi-6b] published widths (d_model {cfg.d_model}, 32 q "
          f"/ 4 kv heads of 128, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}) cut "
          f"to {cfg.n_layers} of 32 layers: {main['n_params'] / 1e9:.3f} B "
          f"parameters ({per_layer / 1e6:.1f} M a layer), float32 weights, "
          f"gradients and AdamW moments {16 * main['n_params'] / 1e9:.1f} "
          f"GB; {n} steps at B {spec['batch']}, S {spec['seq']}, lr "
          f"{spec['lr']}, warmup {spec['warmup']}, through the compiled "
          f"step (a CUDA graph captured once, replayed): losses "
          + ", ".join(f"{x:.4f}" for x in losses)
          + f"; grad norms " + ", ".join(f"{x:.3f}" for x in main["norms"])
          + f"; step time {step_s * 1e3:.1f} ms (median of steps 2-5; all "
          + ", ".join(f"{x * 1e3:.1f}" for x in main["times"])
          + f" ms), {tokens / step_s:.0f} tokens/s (eager "
          f"{step_ms(main_eager):.1f} ms, "
          f"{tokens / step_ms(main_eager) * 1e3:.0f} tokens/s); peak memory "
          f"{main['peak'] / 1e9:.2f} GB; K1 through FlashAttentionFn "
          f"{main['launches']['FlashAttentionFn']} launches; on {smi}; "
          f"step 6 profiled, graphed: {main['breakdown']}; eager: "
          f"{main_eager['breakdown']}")
    print(f"[35b graphed yi-6b] against the eager step on the same weights "
          f"and batches (tol {AGREE_TOL} relative), on {smi}: {main_line}")
    lines = [agree("plain route (use_kernel=False)",
                   train_run(spec, 1, use_kernel=False), main)]
    pair_lines = []
    mb, mb_eager, line = train_pair(spec, PAIR_STEPS, "2 microbatches",
                                    num_microbatches=2)
    only_train_kernels(mb["launches"], FlashAttentionFn, fa.flash_attention,
                       2 * cfg.n_layers, PAIR_STEPS, "yi-6b 2 microbatches")
    lines.append(agree("2 microbatches", mb_eager, main))
    pair_lines.append(line)
    full, full_eager, line = train_pair(spec, PAIR_STEPS, "remat full",
                                        remat="full")
    lines.append(agree("remat full", full_eager, main))
    pair_lines.append(line)
    print(f"[35b train yi-6b] single steps from the same weights and batch "
          f"against the kernel route's first step (loss "
          f"{losses[0]:.4f}, grad norm {main['norms'][0]:.4f}, mixer "
          f"{main['groups']['mixer']:.4f}, layer 0 "
          f"{main['groups']['layer 0']:.4f}, peak "
          f"{main['peak'] / 1e9:.2f} GB; tol {AGREE_TOL} and {GROUP_TOL} "
          f"relative): " + "; ".join(lines))
    print(f"[35b graphed yi-6b] the microbatch and remat runs, each graphed "
          f"against its eager twin ({PAIR_STEPS} steps) on {smi}: "
          + "; ".join(pair_lines))

    spec2 = TRAIN_SSM
    n2 = spec2["steps"]
    fm, fm_eager, fm_line = train_pair(spec2, n2, "falcon-mamba-7b")
    only_train_kernels(fm["launches"], SelectiveScanFn, k9.selective_scan,
                       spec2["layers"], n2, "falcon-mamba")
    fm_plain = train_run(spec2, 1, use_kernel=False)
    print(f"[35b2 train falcon-mamba-7b] published widths cut to "
          f"{spec2['layers']} of 64 layers ({fm['n_params'] / 1e9:.3f} B "
          f"parameters), {n2} steps at B {spec2['batch']}, S "
          f"{spec2['seq']} through the compiled step: losses "
          + ", ".join(f"{x:.4f}" for x in fm["losses"])
          + f", step times " + ", ".join(f"{x * 1e3:.1f}" for x in
                                         fm["times"])
          + f" ms, peak {fm['peak'] / 1e9:.2f} GB; K9 through "
          f"SelectiveScanFn {fm['launches']['SelectiveScanFn']} launches; "
          + agree("plain route", fm_plain, fm) + f"; graphed against eager "
          f"on {smi}: {fm_line}")

    kp = torch.zeros((4, 4, 16, 128), dtype=BF16, device="cuda")
    q = randn((1, 32, 1, 128), 3590, BF16).requires_grad_(True)
    table = torch.zeros((1, 1), dtype=torch.int32, device="cuda")
    kv_len = torch.tensor([5], dtype=torch.int32, device="cuda")
    before = {k.__name__: k.launches for k in KERNELS}
    try:
        with torch.enable_grad():
            ops.paged_decode(q, ops.PagedPools(kp, kp), table, kv_len)
        raised = ""
    except RuntimeError as e:
        raised = str(e)
    check("item 9a" in raised, "[35c] a paged decode with grad did not "
          f"raise the guard: {raised!r}")
    check(before == {k.__name__: k.launches for k in KERNELS},
          "[35c] the refused paged decode launched a kernel")
    print(f"[35c guard] ops.paged_decode with q requiring grad raises "
          f"RuntimeError and launches nothing: {raised.split(';')[0]}; "
          f"phase 35 (b)-(c) in {time.perf_counter() - t0:.1f}s")
    return {"FlashAttentionFn": main["launches"]["FlashAttentionFn"],
            "SelectiveScanFn": fm["launches"]["SelectiveScanFn"]}, step_s


def train_families(smi: str) -> None:
    """(d): one train step graphed against eager for each family that (b)
    and (b2) do not train (``TRAIN_FAMILIES``): 2 steps each, the second
    a replay, every step's loss and grad norm within AGREE_TOL relative
    of the eager run's on the same weights and batches."""
    t0 = time.perf_counter()
    lines = []
    for spec in TRAIN_FAMILIES:
        graphed, _, line = train_pair(spec, 2, spec["arch"], noise=False,
                                      profile=False, hooks=False)
        check(sum(graphed["launches"][f.__name__] for f in ag.FUNCTIONS)
              > 0, f"[35d] {spec['arch']}: no launch through a Function")
        lines.append(f"{line} [{graphed['n_params'] / 1e9:.3f} B "
                     f"parameters, {spec['cut']}, B {spec['batch']} x S "
                     f"{spec['seq']}]")
    print(f"[35d graphed families] one train step graphed (the second, a "
          f"replay) against eager from the same weights and batches, at "
          f"published widths, on {smi}: " + "; ".join(lines)
          + f"; in {time.perf_counter() - t0:.1f}s")


def phase_training(smi: str) -> tuple[list[dict], float]:
    """Phase 35: (a) the Functions, (b) yi-6b and (b2) falcon-mamba
    trained through the compiled step, each beside its eager twin, (c)
    the guard, (d) one graphed step of each other family.  Returns the
    Functions' two rows and (b)'s graphed step time (s, the median of
    steps 2-5)."""
    rows = phase_train_functions(smi)
    gc.collect()
    torch.cuda.empty_cache()
    launches, step_s = phase_train(smi)
    train_families(smi)
    rows[0]["launches"] = launches["FlashAttentionFn"]
    rows[1]["launches"] = launches["SelectiveScanFn"]
    return rows, step_s


# --------------------------------------------------------------------------
# phase 36: static AT, train --autotune, step_for_shape, chunked attention
# --------------------------------------------------------------------------

#: (b) and (c): yi-6b's published widths cut to 2 of 32 layers
STATIC_TRAIN = dict(arch="yi-6b", layers=2, batch=2, seq=1024, steps=2)
STEP_SHAPE = dict(batch=4, seq=1024, decode_steps=2)
#: (d): K1 at yi-6b's train_4k length, against the chunked plain version
CHUNKED_CASE = dict(b=1, h=32, hkv=4, s=4096, d=128, window=1024)


def region_of(arch: str, shape: str) -> str:
    return f"Layout_{arch}_{shape}".replace("-", "_").replace(".", "_")


def static_at_on_the_card(smi: str) -> str:
    """(a): every applicable cell's plans costed at the card's row, tuned
    in a temporary record store and read back warm.  Returns the card's
    name."""
    name = torch.cuda.get_device_name(0)
    spec = cost.chip_spec(name)         # KeyError: the card has no row
    cells = [(a.name, s.name, s.kind) for a, s, _, _ in all_cells()]
    costs = {(a, s): {p: analytic_plan_cost(a, s, p, chip=name)
                      for p in candidate_plans(kind)}
             for a, s, kind in cells}
    with tempfile.TemporaryDirectory() as workdir:
        won = tune_all_layouts(at.AutoTuner(workdir), costs, chip=name)
        for cell, plan in won.items():
            c = costs[cell]
            check(plan == min(c, key=c.get),
                  f"[36a] {cell}: tuned {plan!r}, argmin of {c}")
        again = at.AutoTuner(workdir)
        check(tune_all_layouts(again, costs, chip=name) == won,
              "[36a] a second session read other winners")
        check(sorted(again.warm_hits) == sorted(
            ("static", region_of(*cell)) for cell in costs),
              f"[36a] the second session tuned again: {again.warm_hits}")
    print(f"[36a static AT] the card {name!r} (nvidia-smi: {smi}) reads "
          f"the row bf16 {spec.peak_flops_bf16:.4g} FLOP/s, HBM "
          f"{spec.hbm_bw:.4g} B/s, link {spec.link_bw:.4g} B/s (default "
          f"row {name == cost.DEFAULT_CHIP}); {len(won)} cells at 256 cards"
          f", model axis 16, plans' seconds (compute + memory + collective)"
          f" -> the winner, each the argmin, all read back warm by a second"
          f" session: " + "; ".join(
              f"{a} {s}: " + ", ".join(f"{p} {t:.6g}"
                                       for p, t in costs[a, s].items())
              + f" -> {won[a, s]}" for a, s in costs))
    return name


def train_autotuned(smi: str, card: str) -> int:
    """(b): ``train(autotune=True)`` in a temporary working directory (the
    record store goes there: no ``ckpt_dir``, so no checkpoint is
    written).  Returns K1's launches."""
    spec = STATIC_TRAIN
    out = io.StringIO()
    for kernel in KERNELS + ag.FUNCTIONS:
        kernel.launches = 0
    with tempfile.TemporaryDirectory() as workdir, \
            contextlib.chdir(workdir), contextlib.redirect_stdout(out):
        t0 = time.perf_counter()
        run = train(arch=spec["arch"], steps=spec["steps"], reduced=False,
                    layers=spec["layers"], batch=spec["batch"],
                    seq_len=spec["seq"], autotune=True, device="cuda",
                    log_every=1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        static = Path(workdir, "OAT_StaticParam.dat").read_text()
    launches = {k.__name__: k.launches for k in KERNELS + ag.FUNCTIONS}
    only_train_kernels(launches, FlashAttentionFn, fa.flash_attention,
                       spec["layers"], spec["steps"], "[36b] yi-6b")
    lines = out.getvalue().strip().splitlines()
    check(run["tuned_plan"] == "tp" and any(
        "static AT: layout plan for (yi-6b, train_4k) -> 'tp'" in x
        for x in lines), f"[36b] the plan: {run['tuned_plan']!r}, {lines}")
    check(region_of("yi-6b", "train_4k") in static,
          "[36b] the plan is not in the record store")
    losses = run["losses"]
    check(len(losses) == spec["steps"] and all(np.isfinite(losses)),
          f"[36b] losses {losses}")
    graphs = run["graphs"]
    check((graphs["captures"], graphs["replays"], graphs["recaptures"])
          == (1, spec["steps"] - 1, 0), f"[36b] the compiled step: {graphs}")
    fell = losses[-1] < losses[0]
    del run
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[36b train --autotune] train(arch='yi-6b', layers="
          f"{spec['layers']}, batch {spec['batch']}, seq_len {spec['seq']}, "
          f"{spec['steps']} steps, autotune=True, chip {card!r}) in "
          f"{wall:.1f}s: " + " | ".join(lines) + f"; the loss "
          f"{'fell' if fell else 'did NOT fall'} ({losses[0]:.4f} -> "
          f"{losses[-1]:.4f}); K1 through FlashAttentionFn "
          f"{launches['FlashAttentionFn']} launches, no other kernel; the "
          f"compiled step {graphs}; on {smi}")
    return launches["flash_attention"]


def tree_clone(tree):
    """A copy of a cache tree (the decode step writes its caches in
    place)."""
    if isinstance(tree, dict):
        return {k: tree_clone(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_clone(v) for v in tree)
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


def steps_for_shapes(smi: str) -> int:
    """(c): the prefill and decode steps of ``step_for_shape`` through the
    kernels (counted) and through the plain versions, from the same
    weights, tokens and caches.  Returns K1's launches."""
    b, s, n_dec = STEP_SHAPE["batch"], STEP_SHAPE["seq"], \
        STEP_SHAPE["decode_steps"]
    cfg = dataclasses.replace(get_arch("yi-6b"), n_layers=2)
    model = build_model(cfg)
    params = model.init(0, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(36)
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                           device="cuda")
    plan = LayoutPlan(name="smoke")
    pre = ShapeConfig("prefill_1k", s, b, "prefill")
    dec = ShapeConfig("decode_1k", s + n_dec, b, "decode")
    _, caches = model.prefill(params, tokens, s + n_dec, use_kernel=False)
    logits, fed, launches = {}, [], None
    for use_kernel in (False, True):     # the plain run picks the tokens
        prefill = step_for_shape(model, pre, plan, use_kernel=use_kernel)
        decode = step_for_shape(model, dec, plan, use_kernel=use_kernel)
        c = tree_clone(caches)
        if use_kernel:
            for kernel in KERNELS + ag.FUNCTIONS:
                kernel.launches = 0
        got = [prefill(params, {"tokens": tokens})[0]]
        for i in range(n_dec):
            if not use_kernel:
                fed.append(got[-1].argmax(-1)[:, None])
            pos = torch.full((b,), s + i, device="cuda")
            out, c = decode(params, c, fed[i], pos)
            got.append(out)
        torch.cuda.synchronize()
        if use_kernel:
            launches = {k.__name__: k.launches
                        for k in KERNELS + ag.FUNCTIONS}
        logits[use_kernel] = torch.stack(got)
    want = {"flash_attention": cfg.n_layers,
            "flash_decode": cfg.n_layers * n_dec}
    check({k: n for k, n in launches.items() if n} == want,
          f"[36c] the steps launched {launches}, expected {want}")
    check(fa.flash_decode.last_kernel == pa.DECODE_TC_KERNEL,
          f"[36c] K2 ran {fa.flash_decode.last_kernel}")
    v = cfg.padded_vocab
    line = check_logits(logits[False].reshape(-1, 1, v),
                        logits[True].reshape(-1, 1, v), v, "[36c] logits")
    del model, params, caches, logits
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[36c step_for_shape] yi-6b published widths cut to "
          f"{cfg.n_layers} layers, prefill (S {s}, B {b}) + {n_dec} decode "
          f"steps through the kernels (K1 {launches['flash_attention']}, K2 "
          f"{launches['flash_decode']} launches, no other) against "
          f"use_kernel=False, fed the same tokens: {line}; on {smi}")
    return launches["flash_attention"]


def k1_against_chunked(smi: str) -> dict:
    """(d): K1 against ``ref.chunked_attention`` at S 4096, causal and
    windowed, each timed beside the chunked plain version, SDPA and the
    bound.  Returns the causal case's row (the windowed case's numbers
    under ``window``)."""
    c = CHUNKED_CASE
    q, k, v = (randn((c["b"], n, c["s"], c["d"]), 3600 + j, BF16)
               for j, n in enumerate((c["h"], c["hkv"], c["hkv"])))
    cases = {"causal": dict(causal=True),
             "window": dict(causal=True, window=c["window"])}
    out, lines = {}, []
    for label, kw in cases.items():
        want = ref.chunked_attention(q, k, v, **kw)
        run = functools.partial(fa.flash_attention, q, k, v, **kw)
        got = run()
        check(fa.flash_attention.last_kernel == fa.TC_KERNEL,
              f"[36d] K1 ran {fa.flash_attention.last_kernel}")
        err = compare(got, want, BF16)
        if "window" in kw:
            pairs = sum(min(i + 1, kw["window"]) for i in range(c["s"]))
            i = torch.arange(c["s"], device="cuda")
            mask = (i[None, :] <= i[:, None]) \
                & (i[:, None] - i[None, :] < kw["window"])
            sdpa_kw = dict(attn_mask=mask)
        else:
            pairs = c["s"] * (c["s"] + 1) // 2
            sdpa_kw = dict(is_causal=True)
        times = {"ms": time_ms(run),
                 "plain_ms": time_ms(lambda: ref.chunked_attention(
                     q, k, v, **kw), iters=5),
                 "library_ms": time_ms(
                     lambda: torch.nn.functional.scaled_dot_product_attention(
                         q, k, v, enable_gqa=True, **sdpa_kw))}
        n_bytes = 2 * (2 * q.numel() + k.numel() + v.numel())
        n_ops = 4 * c["b"] * c["h"] * pairs * c["d"]
        out[label] = row(
            f"flash_attention[yi-6b train_4k S {c['s']} vs chunked plain]",
            SOURCE, f"{FLASH}:106", err, n_bytes, n_ops, times)
        lines.append(f"{label}: {fmt_times(times)}, bound "
                     f"{out[label]['bound_ms']:.5f} ms "
                     f"({out[label]['bound_by']}), err {err:.2e}")
    r = out["causal"]
    w = out["window"]
    r.update(shape=f"B {c['b']}, {c['h']} q / {c['hkv']} kv heads of "
             f"{c['d']}, S {c['s']}, causal, bf16", tile=list(
                 fa.TC_DEFAULT_TILE), plain="ref.chunked_attention "
             "(blocks of 1024)", window={k: w[k] for k in (
                 "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                 "max_abs_err")} | {"window": c["window"]})
    print(f"[36d K1 vs chunked] B {c['b']}, {c['h']} q / {c['hkv']} kv heads "
          f"of {c['d']}, S {c['s']}, bf16, against ref.chunked_attention "
          f"(the plain route above {ops.CHUNKED_THRESHOLD} queries, blocks "
          f"of 1024; library: SDPA), device ms (ms per call incl. host) on "
          f"{smi}: " + "; ".join(lines))
    return r


def train_peak_share(smi: str, card: str, step_s: float) -> None:
    """(e): phase 35's step (yi-6b cut to its layers, B x S) as a
    ``ShapeConfig``: its MODEL_FLOPS and analytic FLOPs over the measured
    step time and the card's bf16 peak, and the analytic roofline bound
    of the step at the card's row."""
    spec = cost.chip_spec(card)
    cfg = dataclasses.replace(get_arch(TRAIN["arch"]),
                              n_layers=TRAIN["layers"])
    shape = ShapeConfig("phase35", TRAIN["seq"], TRAIN["batch"], "train")
    mf = model_flops(cfg, shape)
    ana = step_costs(cfg, shape)
    terms = cost.roofline_terms(ana.flops, ana.bytes, 0.0, 1,
                                peak_flops=spec.peak_flops_bf16,
                                hbm_bw=spec.hbm_bw, ici_bw=spec.link_bw)
    mfu = mf / step_s / spec.peak_flops_bf16
    check(0 < mfu < 1, f"[36e] share of the peak {mfu}")
    print(f"[36e train share of the peak] phase 35's step (yi-6b, "
          f"{cfg.n_layers} layers, B {shape.global_batch} x S "
          f"{shape.seq_len}): model_flops (6 N D, N "
          f"{cfg.active_param_count() / 1e9:.4f} B) {mf / 1e12:.3f} TFLOP "
          f"over the measured {step_s * 1e3:.1f} ms is "
          f"{mf / step_s / 1e12:.1f} TFLOP/s, {mfu:.4f} of the card's bf16 "
          f"peak {spec.peak_flops_bf16 / 1e12:.1f} TFLOP/s; the analytic "
          f"count (attention and the optimizer in) {ana.flops / 1e12:.3f} "
          f"TFLOP, {ana.flops / step_s / spec.peak_flops_bf16:.4f}; the "
          f"analytic roofline bound {terms.bound_s * 1e3:.1f} ms "
          f"({terms.dominant}: compute {terms.compute_s * 1e3:.1f}, memory "
          f"{terms.memory_s * 1e3:.1f} ms), the step at "
          f"{terms.bound_s / step_s:.3f} of it; on {smi}")


def phase_static(smi: str, step_s: float) -> list[dict]:
    """Phase 36: (a) static AT on the card, (b) train --autotune, (c)
    step_for_shape, (d) K1 against the chunked plain version, (e) the
    train step's share of the peak.  Returns (d)'s row, its launches
    those of K1 in (b) and (c)."""
    t0 = time.perf_counter()
    card = static_at_on_the_card(smi)
    k1 = train_autotuned(smi, card)
    k1 += steps_for_shapes(smi)
    r = k1_against_chunked(smi)
    r["launches"] = k1
    train_peak_share(smi, card, step_s)
    print(f"[36] phase 36 in {time.perf_counter() - t0:.1f}s")
    return [r]


# --------------------------------------------------------------------------
# phase 37: tensor-parallel paged serving over torch.distributed
# --------------------------------------------------------------------------

MESH = "1x2"
#: (label, what, engine keywords, the serve's kernels)
MESH_SERVES = (
    ("a", "paged decode (K1 prefill, K3)", {},
     (fa.flash_attention, pa.flash_paged_decode)),
    ("b", "chunks of 128 (K4, K3)", dict(prefill_chunk=128),
     (pa.flash_paged_prefill, pa.flash_paged_decode)),
    ("c", "int8, 8 splits (K6c, K6b + K5c)",
     dict(prefill_chunk=128, kv_dtype="int8", num_splits=8),
     (pa.flash_paged_prefill_quant, pa.paged_decode_split_quant_merged)),
    ("d", "speculative, 8 splits (K4, K5b + K5c; the draft's K1, K2)",
     dict(prefill_chunk=128, draft=True, spec_k=4, num_splits=8),
     (pa.flash_paged_prefill, pa.paged_prefill_split_merged,
      fa.flash_attention, fa.flash_decode)))
MESH_RING_PROMPTS, MESH_RING_LEN = 2, 4096   # (e): prompts the ring takes
PSUM_SHAPE = (4096, 1024)            # (f)
#: phases 37 and 38 (a, b) serve yi-6b at full width cut to this many of
#: its 32 layers: two ranks sharing one card check the mechanism, not a
#: speed, and every check holds at any depth (the launch counts scale
#: with the layers)
MESH_LAYERS = 8


def mesh_cut(layers: int) -> str:
    """The depth of a phase 37 or 38 serve, as its line prints it."""
    full = get_arch("yi-6b").n_layers
    return (f"depth cut: {layers} of {full} layers" if layers < full
            else f"all {full} layers")


def mesh_model(layers: int):
    """yi-6b at full width cut to ``layers`` of its 32 layers, random bf16
    weights from seed 0 on the card."""
    model = build_model(dataclasses.replace(get_arch("yi-6b"),
                                            n_layers=layers))
    return model, model.init(0, "cuda")


def mesh_engine(model, params, mesh, kw: dict, n_lanes: int,
                max_len: int) -> tuple[ServingEngine, dict]:
    """A paged engine (pages of 16) on ``mesh`` (None: unsharded) whose
    admissions record their first logits, by request id."""
    kw = dict(kw)
    if kw.pop("draft", False):
        draft = model.draft_model()
        kw.update(draft_model=draft,
                  draft_params=model.slice_draft_params(params, draft))
    engine = ServingEngine(model, params, n_lanes=n_lanes, max_len=max_len,
                           cache="paged", page_size=16, mesh=mesh, **kw)
    firsts, inner = {}, engine._next_token

    def first(req, logits):
        firsts.setdefault(req.rid, logits.float().cpu())
        return inner(req, logits)

    engine._next_token = first
    return engine, firsts


def mesh_serve(model, params, mesh, kw: dict, prompts=None) -> dict:
    """Phase 5's requests (or ``prompts``, 32 new tokens each) through
    :func:`mesh_engine`, every launch counter and the collectives' counts
    zeroed just before and read just after."""
    scfg = ServeConfig(**SERVE)
    n_lanes, max_len = SERVE["n_lanes"], SERVE["max_len"]
    if prompts is not None:
        n_lanes, max_len = len(prompts), len(prompts[0]) + 64
    engine, firsts = mesh_engine(model, params, mesh, kw, n_lanes, max_len)
    for kernel in KERNELS:
        kernel.launches = 0
    collectives.reset_counts()
    drafts, restore = count_draft_calls()
    try:
        if prompts is None:
            report = serve_engine(engine, scfg)
        else:
            for rid, p in enumerate(prompts):
                engine.submit(Request(rid=rid, prompt=p,
                                      max_new_tokens=SERVE["max_new"]))
            engine.run(max_steps=4 * SERVE["max_new"])
            s = engine.metrics.summary()
            report = {"outputs": {r.rid: list(r.out_tokens)
                                  for r in engine.finished},
                      "tokens_per_s": s["tokens_per_s"],
                      "p50_ttft_s": s["ttft_s"]["p50"],
                      "p50_itl_s": s["itl_s"]["p50"],
                      "decode_steps": engine.steps,
                      "prefill_chunks": engine.prefill_chunks}
    finally:
        restore()
    torch.cuda.synchronize()
    return {"report": report, "firsts": firsts, "drafts": drafts,
            "launches": {k.__name__: k.launches for k in KERNELS
                         if k.launches},
            "staged": dict(collectives.STAGED),
            "calls": dict(collectives.CALLS),
            "seconds": dict(collectives.SECONDS),
            "pool_bytes": engine.kv.pool_bytes(),
            "pool_heads": engine.kv.caches["kv"][0].shape[2],
            "counters_zero": counters_zero()}


def first_logits(got: dict, want: dict) -> dict:
    """Each admission's first logits against the reference's: how many
    are bit-equal, and the largest difference over the logits' scale."""
    same = sum(torch.equal(got[r], want[r]) for r in want)
    worst = max(float((got[r] - want[r]).abs().max())
                / float(want[r].abs().max()) for r in want)
    return {"bit_equal": same, "n": len(want), "worst_rel": worst,
            "argmax": sum(int(got[r].argmax()) == int(want[r].argmax())
                          for r in want)}


def wall_ms(fn, iters: int = 5) -> float:
    """Host ms a call of ``fn``, from a synchronised start to the device's
    end (the ring's collectives stage through the host, so its time is
    the wall's)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def mesh_rank(layers: int) -> dict:
    """One rank of phase 37's 1x2 world (both ranks on the one card, over
    gloo), yi-6b cut to ``layers``: (a)-(d) served sharded, each after
    rank 0 served it unsharded (rank 1 waiting); (e) the ring; (f)
    ``compressed_psum``.  Returns what the parent checks and prints."""
    mesh = make_serving_mesh(MESH)
    model, params = mesh_model(layers)
    serve_mod.check_same_weights(params, mesh)
    rank0 = mesh.rank == 0
    out = {"rank": mesh.rank, "backend": dist.get_backend(),
           "coords": dict(mesh.coords), "serves": {},
           "draft_layers": model.draft_model().cfg.n_layers}
    for label, _, kw, _ in MESH_SERVES:
        ref = mesh_serve(model, params, None, kw) if rank0 else None
        dist.barrier()
        got = mesh_serve(model, params, mesh, kw)
        got["rank"] = mesh.rank
        if rank0:
            got["ref"] = {k: ref[k] for k in ("report", "pool_bytes",
                                              "pool_heads")}
            got["first"] = first_logits(got["firsts"], ref["firsts"])
            if label == "b":                # (g) holds its serve to these
                out["b_ref_firsts"] = ref["firsts"]
        del got["firsts"]
        out["serves"][label] = got
    # (e) two prompts of 4096 tokens: the prefill takes the ring
    rng = np.random.default_rng(SERVE["n_requests"])
    prompts = rng.integers(0, model.cfg.vocab_size,
                           size=(MESH_RING_PROMPTS, MESH_RING_LEN)).tolist()
    ref = mesh_serve(model, params, None, {}, prompts) if rank0 else None
    dist.barrier()
    got = mesh_serve(model, params, mesh, {}, prompts)
    got["rank"] = mesh.rank
    if rank0:
        got["ref"] = {"report": ref["report"]}
        got["first"] = first_logits(got["firsts"], ref["firsts"])
    del got["firsts"]
    q = randn((1, 32, MESH_RING_LEN, 128), 37, torch.bfloat16)
    k, v = (randn((1, 4, MESH_RING_LEN, 128), s, torch.bfloat16)
            for s in (38, 39))
    collectives.reset_counts()
    ring_out = ops.attention(q, k, v, mesh=mesh)
    got["ring_calls"] = dict(collectives.CALLS)
    dist.barrier()
    got["ring_ms"] = wall_ms(lambda: ops.attention(q, k, v, mesh=mesh))
    dist.barrier()
    if rank0:
        k1_out = ops.attention(q, k, v)
        got["ring_err"] = compare(ring_out, k1_out, torch.bfloat16)
        got["k1_ms"] = wall_ms(lambda: ops.attention(q, k, v))
        got["k1_device_ms"] = time_ms(lambda: ops.attention(q, k, v))[0]
    dist.barrier()
    out["ring"] = got
    # (f) compressed_psum on CUDA tensors against the exact sum
    xs = [torch.randn(PSUM_SHAPE, generator=torch.Generator("cuda")
                      .manual_seed(100 + r), device="cuda")
          for r in range(mesh.shape["model"])]
    collectives.reset_counts()
    s = compressed_psum(xs[mesh.coords["model"]], mesh.group("model"))
    exact = xs[0] + xs[1]
    out["psum"] = {"err": float((s - exact).abs().max()),
                   "bound": 2 * max(float(x.abs().max()) for x in xs) / 127,
                   "finite": bool(torch.isfinite(s).all()),
                   "staged": dict(collectives.STAGED), "on": str(s.device)}
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return out


def nccl_rank(ref_tokens: dict, ref_firsts: dict, layers: int) -> dict:
    """(g): phase 37b's serve through ``"1x1"`` in a NCCL world of one
    rank: the unsharded path, no collective in the serve; one all-reduce
    (the weights' checksum) goes through NCCL."""
    mesh = make_serving_mesh("1x1")
    model, params = mesh_model(layers)
    c = serve_mod.weights_checksum(params)
    back = collectives.all_reduce(torch.tensor([c], dtype=torch.float64,
                                               device="cuda"))
    got = mesh_serve(model, params, mesh, MESH_SERVES[1][2])
    got["first"] = first_logits(got.pop("firsts"), ref_firsts)
    got["backend"] = dist.get_backend()
    got["checksum_same"] = float(back[0]) == c
    got["tokens_equal"] = got["report"]["outputs"] == ref_tokens
    return got


def mesh_launch_check(label: str, got: dict, kernels, n_layers: int,
                      n_draft: int) -> None:
    """Each rank's launches: the serve's kernels and no other, each
    launched, and the per-layer counts of its chunks, steps and verifies
    (``n_layers`` the target's, ``n_draft`` the draft's)."""
    what = f"37{label}, rank {got['rank']}"
    launches, report = got["launches"], got["report"]
    only_launched(launches, kernels, what)
    check(all(launches.get(k.__name__, 0) > 0 for k in kernels),
          f"{what}: a kernel of the serve was not launched: {launches}")
    check(got["counters_zero"], f"{what}: an arrival counter is not 0")
    steps = report["decode_steps"]
    want = {"a": {"flash_attention": n_layers * SERVE["n_requests"],
                  "flash_paged_decode": n_layers * steps},
            "b": {"flash_paged_prefill": n_layers * report["prefill_chunks"],
                  "flash_paged_decode": n_layers * steps},
            "c": {"flash_paged_prefill_quant":
                  n_layers * report["prefill_chunks"],
                  "paged_decode_split_quant_merged": n_layers * steps},
            "d": {"flash_paged_prefill": n_layers * report["prefill_chunks"],
                  "paged_prefill_split_merged": n_layers * steps,
                  "flash_attention": n_draft * got["drafts"]["prefill"],
                  "flash_decode": n_draft * got["drafts"]["decode_step"]}
            }[label]
    for name, n in want.items():
        check(launches.get(name, 0) == n,
              f"{what}: {name} launched {launches.get(name, 0)} times, "
              f"expected {n}")


def phase_mesh(smi: str, layers: int = MESH_LAYERS) -> None:
    """Phase 37: tensor-parallel paged serving of yi-6b (full width, cut
    to ``layers`` of 32) on a 1x2 mesh, both ranks on the one card over
    gloo (NCCL refuses two ranks on one device): (a)-(d) greedy tokens
    equal to the
    unsharded engine's, served by rank 0 in the same phase, each
    admission's first logits bit-equal (or within 5e-2 of their scale),
    per-rank launches by kernel, pools half the unsharded bytes; (e) two
    prompts of 4096 tokens whose prefill takes the ring, against the
    unsharded K1 prefill within 5e-2 of the logits' scale; (f)
    ``compressed_psum`` on CUDA tensors; (g) ``"1x1"`` in a NCCL world of
    one rank.  Two ranks share the card: no time here is a multi-card
    speed."""
    t0 = time.perf_counter()
    gc.collect()
    before = torch.cuda.memory_reserved()
    torch.cuda.empty_cache()
    print(f"[37 mesh] the parent's reserved device memory "
          f"{before / 1e9:.2f} GB, after freeing its cached blocks "
          f"{torch.cuda.memory_reserved() / 1e9:.2f} GB; spawning {MESH} "
          f"(2 ranks on cuda:0, backend gloo)")
    ranks = run_world(mesh_rank, 2, device="cuda", args=(layers,),
                      join_timeout_s=900.0)
    check([r["rank"] for r in ranks] == [0, 1], "ranks out of order")
    check(all(r["backend"] == "gloo" for r in ranks), "backend not gloo")
    r0 = ranks[0]
    n_draft = r0["draft_layers"]
    cut = mesh_cut(layers)
    lines = []
    for label, what, kw, kernels in MESH_SERVES:
        a, b = (r["serves"][label] for r in ranks)
        ref = a["ref"]
        outputs = a["report"]["outputs"]
        check(b["report"]["outputs"] == outputs,
              f"37{label}: the ranks' tokens differ")
        check(len(outputs) == SERVE["n_requests"]
              and all(len(t) == SERVE["max_new"] for t in outputs.values()),
              f"37{label}: a request did not get its 32 tokens")
        check(outputs == ref["report"]["outputs"],
              f"37{label}: greedy tokens differ from the unsharded "
              f"engine's: {greedy_agreement(a['report'], ref['report'])}")
        f = a["first"]
        check(f["bit_equal"] == f["n"] or f["worst_rel"] <= 5e-2,
              f"37{label}: first logits {f}")
        for r in (a, b):
            mesh_launch_check(label, r, kernels, layers, n_draft)
        check(a["pool_heads"] * 2 == ref["pool_heads"]
              and a["pool_bytes"] * 2 == ref["pool_bytes"],
              f"37{label}: pools {a['pool_bytes']} B at {a['pool_heads']} "
              f"heads against {ref['pool_bytes']} B")
        rep, rref = a["report"], ref["report"]
        gathers = a["calls"].get("all_gather", 0)
        gather_s = a["seconds"].get("all_gather", 0.0)
        lines.append(
            f"({label}) {what}: greedy tokens equal to the unsharded "
            f"engine's {greedy_agreement(rep, rref)}, first logits "
            f"bit-equal {f['bit_equal']}/{f['n']} (worst "
            f"{f['worst_rel']:.2e} of the scale); sharded "
            f"{rep['tokens_per_s']:.1f} tok/s, p50 ttft "
            f"{rep['p50_ttft_s']:.4f}s, p50 itl {rep['p50_itl_s']:.4f}s "
            f"against unsharded {rref['tokens_per_s']:.1f} tok/s, "
            f"{rref['p50_ttft_s']:.4f}s, {rref['p50_itl_s']:.4f}s; "
            f"{rep['prefill_chunks']} chunks, {rep['decode_steps']} ticks; "
            f"launches rank 0 {a['launches']}, rank 1 {b['launches']}; "
            f"pool {a['pool_bytes']} B a rank ({a['pool_heads']} of "
            f"{ref['pool_heads']} KV heads) against {ref['pool_bytes']} B; "
            f"staged bytes by op {a['staged']}, collectives {a['calls']}; "
            f"all-gathers {gather_s * 1e3 / max(gathers, 1):.3f} ms a call "
            f"(host clock), {gather_s * 1e3 / rep['decode_steps']:.2f} ms "
            f"a tick" + (" (every gather in a decode tick)"
                         if label == "a" else " (chunks' gathers in)"))
    print(f"[37 mesh serves] yi-6b at full width, {cut} (a draft of "
          f"{n_draft}), {MESH}, 8 requests of 32 tokens, 4 lanes, pages of "
          f"16, ranks sharing one card on {smi}: " + "; ".join(lines))
    a, b = (r["ring"] for r in ranks)
    rep, rref = a["report"], a["ref"]["report"]
    check(b["report"]["outputs"] == rep["outputs"],
          "37e: the ranks' tokens differ")
    check(all(len(t) == SERVE["max_new"] for t in rep["outputs"].values()),
          "37e: a request did not get its 32 tokens")
    f = a["first"]
    check(f["worst_rel"] <= 5e-2, f"37e: first logits {f}")
    for r in (a, b):
        check(r["launches"].get("flash_attention", 0) == 0,
              f"37e: K1 ran under the ring: {r['launches']}")
        check(r["ring_calls"].get("ring_send") == 1
              and r["ring_calls"].get("all_gather") == 1,
              f"37e: the ring's collectives {r['ring_calls']}")
        check(r["launches"].get("flash_paged_decode", 0)
              == layers * rep["decode_steps"],
              f"37e: K3 launches {r['launches']}")
    check(a["ring_err"] <= TOL[torch.bfloat16],
          f"37e: the ring against K1 {a['ring_err']}")
    print(f"[37e ring] yi-6b, {cut}: 2 prompts of {MESH_RING_LEN} tokens, "
          f"prefill through the "
          f"ring (float32, 1 block send a layer a rank; no K1 launch): first "
          f"logits against the unsharded K1 prefill within "
          f"{f['worst_rel']:.2e} of their scale (tol 5e-2), argmax agrees "
          f"{f['argmax']}/{f['n']}; greedy tokens equal to the unsharded "
          f"engine's {greedy_agreement(rep, rref)} (bf16 near-ties may "
          f"flip); sharded p50 ttft {rep['p50_ttft_s']:.4f}s against "
          f"{rref['p50_ttft_s']:.4f}s; launches rank 0 {a['launches']}, "
          f"rank 1 {b['launches']}; staged bytes {a['staged']}, host "
          f"seconds in the collectives {a['seconds']}; one "
          f"attention at B 1, 32 q / 4 kv heads of 128, S {MESH_RING_LEN}: the "
          f"ring {a['ring_ms']:.3f} ms a call (wall, both ranks at once, "
          f"the K/V blocks and the output staged through the host) against "
          f"K1 alone {a['k1_ms']:.3f} ms (wall; device "
          f"{a['k1_device_ms']:.4f} ms), outputs within {a['ring_err']:.2e}"
          f" (tol {TOL[torch.bfloat16]}); on {smi}")
    for r in ranks:
        p = r["psum"]
        check(p["finite"] and p["err"] <= p["bound"],
              f"37f: compressed_psum on rank {r['rank']}: {p}")
    p = r0["psum"]
    print(f"[37f compressed_psum] {PSUM_SHAPE} float32 on {p['on']}, 2 "
          f"ranks: max error against the exact sum {p['err']:.4e} (bound "
          f"2 amax / 127 = {p['bound']:.4e}); staged bytes {p['staged']}")
    b = r0["serves"]["b"]
    g = run_world(nccl_rank, 1, device="cuda",
                  args=(b["ref"]["report"]["outputs"], r0["b_ref_firsts"],
                        layers),
                  join_timeout_s=600.0)[0]
    f = g["first"]
    check(g["backend"] == "nccl" and g["checksum_same"],
          f"37g: backend {g['backend']}, checksum {g['checksum_same']}")
    check(g["tokens_equal"], "37g: 1x1 tokens differ from the unsharded "
          "engine's")
    check(f["bit_equal"] == f["n"] or f["worst_rel"] <= 5e-2,
          f"37g: first logits {f}")
    g["rank"] = 0
    mesh_launch_check("b", g, MESH_SERVES[1][3], layers, n_draft)
    check(not g["calls"], f"37g: the 1x1 serve made collectives {g['calls']}")
    print(f"[37g 1x1] yi-6b, {cut}: phase 37b's serve through "
          f"make_serving_mesh('1x1') in "
          f"a NCCL world of one rank (one all-reduce through NCCL, the "
          f"weights' checksum; none in the serve): greedy tokens equal to "
          f"the unsharded engine's, first logits bit-equal "
          f"{f['bit_equal']}/{f['n']} (worst {f['worst_rel']:.2e}; the "
          f"reference ran in another process), "
          f"{g['report']['tokens_per_s']:.1f} tok/s, launches "
          f"{g['launches']}, pool {g['pool_bytes']} B")
    print(f"[37 peak memory] rank 0 {r0['peak_gb']:.2f} GB, rank 1 "
          f"{ranks[1]['peak_gb']:.2f} GB; phase 37 in "
          f"{time.perf_counter() - t0:.1f}s")


# --------------------------------------------------------------------------
# phase 38: the layout tooling: the gateway over a 1x2 mesh, the dry run
# over a fake world of 256 and 512 ranks, static AT by the dry run's bound
# --------------------------------------------------------------------------

#: phase 26a's gateway serve: the paged pool, chunks of 128, max_inflight 2
GATEWAY_26A = dict(cache="paged", page_size=16, prefill_chunk=128,
                   gateway=True)
#: (38c) the dry run's cells: (shape, multi_pod, layers of yi-6b's 32; None:
#: all of them)
DRY_CELLS = (("decode_32k", False, None), ("train_4k", False, 2),
             ("train_4k", True, 2))
DRY_LAYERS = 2                      # (38d) the depth the plans are run at


@contextlib.contextmanager
def first_logits_by_prompt():
    """While open, every engine's admissions record their first logits,
    keyed by the prompt (a gateway's request ids follow the clients'
    arrival order, which may differ from serve to serve)."""
    firsts, inner = {}, ServingEngine._next_token

    def first(self, req, logits):
        key = tuple(int(t) for t in req.prompt)
        if key not in firsts:
            firsts[key] = logits.float().cpu()
        return inner(self, req, logits)

    ServingEngine._next_token = first
    try:
        yield firsts
    finally:
        ServingEngine._next_token = inner


def gateway_serve_counts(model, params, scfg: ServeConfig, mesh,
                         tuner=None) -> dict:
    """One serve of ``scfg`` (through its gateway) on this rank, every
    launch counter zeroed just before and read just after, and each
    admission's first logits by prompt (``tuner``: ``serve_model``'s)."""
    for kernel in KERNELS:
        kernel.launches = 0
    with first_logits_by_prompt() as firsts:
        report = serve_mod.serve_model(model, params, scfg, mesh, tuner)
    torch.cuda.synchronize()
    return {"report": report, "firsts": firsts,
            "launches": {k.__name__: k.launches
                         for k in KERNELS if k.launches}}


def gateway_rank(workdir: str, layers: int) -> dict:
    """One rank of phase 38's 1x2 world (both ranks on the one card over
    gloo), yi-6b cut to ``layers``: (a) rank 0 serves phase 26a's gateway
    unsharded (rank 1 waiting), then rank 0's gateway serves it over the
    mesh with rank 1 following; (b) the same with ``--autotune`` in
    ``workdir``, twice, and then rank 0 (rank 1 waiting) serves it
    unsharded with the winners the mesh serves committed: its tuner
    declares the mesh's regions (``_mesh1x2``) in ``workdir`` and binds
    no mesh, so it warm-loads them and runs the unsharded steps at the
    same tiles and splits."""
    mesh = make_serving_mesh(MESH)
    model, params = mesh_model(layers)
    serve_mod.check_same_weights(params, mesh)
    base = ServeConfig(**{**SERVE, **GATEWAY_26A})
    out = {"rank": mesh.rank}
    if mesh.rank == 0:
        out["ref"] = gateway_serve_counts(model, params, base, None)
    dist.barrier()
    out["a"] = gateway_serve_counts(
        model, params, dataclasses.replace(base, mesh=MESH), mesh)
    # GatewayPolicy windows of one request, as phase 27c: its four
    # candidates commit within the 8 requests
    tuned = dataclasses.replace(base, mesh=MESH, autotune=True,
                                workdir=workdir, policy_window=1)
    for run in ("cold", "warm"):
        out[run] = gateway_serve_counts(model, params, tuned, mesh)
    if mesh.rank == 0:
        like = serve_mod.make_autotuner(model, tuned, None)
        out["like"] = gateway_serve_counts(
            model, params, dataclasses.replace(tuned, mesh=None), None,
            like)
    dist.barrier()
    if mesh.rank != 0:                 # rank 0's logits are the ones held
        for run in ("a", "cold", "warm"):
            del out[run]["firsts"]
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return out


def mesh_gateway_line(label: str, report: dict) -> str:
    """Throughput, TTFT, ITL and the gateway loop's host ms a tick."""
    def ms(x):
        return f"{x * 1e3:.1f}" if x is not None else "n/a"

    g = report["gateway"]
    per_tick = {k: v / max(g["ticks"], 1) for k, v in g["host_ms"].items()}
    return (f"{label} {report['tokens_per_s']:.1f} tok/s, ttft p50 "
            f"{ms(report['p50_ttft_s'])} p99 {ms(report['p99_ttft_s'])} ms, "
            f"itl p50 {ms(report['p50_itl_s'])} p99 "
            f"{ms(report['p99_itl_s'])} ms, {g['ticks']} ticks "
            f"({g['overlapped_ticks']} overlapped), host ms a tick: "
            f"schedule+dispatch {per_tick['schedule_dispatch']:.2f}, wait "
            f"{per_tick['wait']:.2f}, emit {per_tick['emit']:.2f}")


def gateway_mesh_checks(label: str, lead: dict, follow: dict,
                        ref: dict | None, tuned: bool = False) -> None:
    """Both ranks finished the same requests with the same tokens, every
    stream ended in ``done``, each rank launched K4 and K3 (``tuned``: K4
    and the decode tiles' kernels, K3 or K5a with K5c merged, as the
    ``DecodeBucket`` regions' split counts pick) and no other, the same
    counts on both (and, against ``ref``, the unsharded serve's counts
    and tokens)."""
    what = f"38{label}"
    rep = lead["report"]
    check(rep["gateway"]["streams"] == {"done": SERVE["n_requests"]},
          f"{what}: the streams ended {rep['gateway']['streams']}")
    check(all(len(t) == SERVE["max_new"] for t in rep["outputs"].values()),
          f"{what}: a request did not get its 32 tokens")
    check(follow["report"]["gateway"]["by_rid"] == rep["gateway"]["by_rid"],
          f"{what}: the ranks' tokens differ")
    kernels = (pa.flash_paged_prefill, pa.flash_paged_decode)
    allowed = kernels + ((pa.paged_decode_split_merged,) if tuned else ())
    for r in (lead, follow):
        only_launched(r["launches"], allowed, f"{what}, a rank")
        check(r["launches"].get(kernels[0].__name__, 0) > 0
              and any(r["launches"].get(k.__name__, 0) > 0
                      for k in allowed[1:]),
              f"{what}: K4 or the decode kernel not launched: "
              f"{r['launches']}")
    check(lead["launches"] == follow["launches"],
          f"{what}: launches differ by rank: {lead['launches']} against "
          f"{follow['launches']}")
    if ref is not None:
        check(rep["outputs"] == ref["report"]["outputs"],
              f"{what}: greedy tokens differ from the unsharded gateway's "
              f"{greedy_agreement(rep, ref['report'])}")
        check(lead["launches"] == ref["launches"],
              f"{what}: launches a rank {lead['launches']} against the "
              f"unsharded serve's {ref['launches']}")


@contextlib.contextmanager
def dry_depth(layers: int | None):
    """The dry run, the roofline and static AT read yi-6b cut to
    ``layers`` of its 32 layers (None: whole); the widths stay."""
    from repro_torch.launch import dryrun, roofline
    from repro_torch.tuning import static

    def cut(name: str):
        cfg = get_arch(name)
        return cfg if layers is None else dataclasses.replace(
            cfg, n_layers=layers)

    mods = (dryrun, roofline, static)
    saved = [m.get_arch for m in mods]
    for m in mods:
        m.get_arch = cut
    try:
        yield cut
    finally:
        for m, f in zip(mods, saved):
            m.get_arch = f


def dry_run_cells() -> tuple[list[str], dict]:
    """(c): ``dryrun_cell`` on the fake 16x16 and 2x16x16 worlds at yi-6b's
    full width: each record's per-rank dot FLOPs against ``step_costs``'
    over the ranks, argument and peak bytes a rank, collective bytes by
    kind and the cell's seconds.  Returns the lines and the 16x16
    train_4k cell's bound by plan."""
    from repro_torch.distributed.process_mesh import world_size
    from repro_torch.launch.dryrun import dryrun_cell
    from repro_torch.launch.roofline import from_artifact
    lines, bounds = [], {}
    for shape, multi, layers in DRY_CELLS:
        with dry_depth(layers) as cut:
            t0 = time.perf_counter()
            rec = dryrun_cell("yi-6b", shape, multi_pod=multi, verbose=False)
            secs = time.perf_counter() - t0
            ana = step_costs(cut("yi-6b"), get_shape(shape)).flops
            bound = from_artifact(rec)
        check(world_size() == 1, "38c: the fake world outlived its cell")
        check(rec["mesh"] == ("2x16x16" if multi else "16x16")
              and rec["chips"] == (512 if multi else 256),
              f"38c: mesh {rec['mesh']}")
        flops = rec["hlo_dot_flops"]
        check(flops > 0 and rec["memory"]["argument_bytes"] > 0
              and math.isfinite(bound.bound_s),
              f"38c: {shape} record {rec['memory']}, {flops}")
        # the decode step runs on the plan's shards: a rank's share of
        # step_costs' FLOPs (0.9931 in the CPU rehearsal)
        check(rec["kind"] != "decode"
              or 0.9 <= flops * rec["chips"] / ana <= 1.1,
              f"38c: decode FLOPs a rank x{flops * rec['chips'] / ana:.3f} "
              f"of step_costs' share")
        coll = {k: f"{v:.4g}" for k, v in
                rec["hlo_collective_bytes"].items() if v}
        lines.append(
            f"yi-6b {shape} on {rec['mesh']} ({rec['plan']}, remat "
            f"{rec['remat']}, {rec['num_microbatches']} microbatches"
            + (f"; depth cut to {layers} of 32 layers" if layers else
               "; all 32 layers") + f"): dot FLOPs a rank {flops:.4g} "
            f"against step_costs' {ana / rec['chips']:.4g} over the ranks "
            f"(x{flops * rec['chips'] / ana:.3f}); bytes a rank: arguments "
            f"{rec['memory']['argument_bytes']:.4g}, made at the peak "
            f"{rec['memory']['temp_bytes']:.4g}, in all "
            f"{rec['bytes_per_device']:.4g}; collective bytes a rank {coll}; "
            f"roofline bound {bound.bound_s:.4g} s ({bound.dominant}); "
            f"{secs:.1f} s on the host's CPU")
        if (shape, multi, layers) == ("train_4k", False, DRY_LAYERS):
            bounds[rec["plan"]] = bound.bound_s
    return lines, bounds


def layout_by_dry_run(card: str) -> tuple[str, dict]:
    """(d): ``tune_layout`` for yi-6b train_4k with ``cost_fn`` the dry
    run's bound (``compiled_plan_cost``, each plan run once), beside the
    analytic winner at the same depth; a second session reads the winner
    back warm (the costs already known, no dry run).  Returns the line
    and the bound by plan."""
    from repro_torch.tuning import static
    with dry_depth(DRY_LAYERS), tempfile.TemporaryDirectory() as workdir:
        known, runs = {}, []

        def cost_fn(plan: str) -> float:
            if plan not in known:
                runs.append(plan)
                known[plan] = static.compiled_plan_cost("yi-6b", "train_4k",
                                                        plan)
            return known[plan]

        t0 = time.perf_counter()
        won = static.tune_layout(at.AutoTuner(workdir), "yi-6b", "train_4k",
                                 cost_fn=cost_fn)
        secs = time.perf_counter() - t0
        check(won == min(known, key=known.get),
              f"38d: tuned {won!r}, the argmin of {known}")
        again = at.AutoTuner(workdir)
        check(static.tune_layout(again, "yi-6b", "train_4k",
                                 cost_fn=cost_fn) == won,
              "38d: a second session read another winner")
        check(("static", region_of("yi-6b", "train_4k")) in again.warm_hits
              and set(known) == set(candidate_plans("train")),
              f"38d: not read back warm: {again.warm_hits}, runs {runs}")
        analytic = {p: analytic_plan_cost("yi-6b", "train_4k", p, chip=card)
                    for p in candidate_plans("train")}
    return (f"tune_layout(yi-6b, train_4k, cost_fn=compiled_plan_cost) at "
            f"{DRY_LAYERS} of 32 layers, 16x16: dry-run bounds "
            + ", ".join(f"{p} {c:.6g} s" for p, c in known.items())
            + f" -> {won!r} ({len(runs)} dry runs, {runs}; {secs:.1f} s), "
            f"read back warm with no dry run; the analytic costs at the "
            f"same depth "
            + ", ".join(f"{p} {c:.6g} s" for p, c in analytic.items())
            + f" -> {min(analytic, key=analytic.get)!r} (phase 36, all 32 "
            f"layers: 'tp')"), known


DRY_CHILD = r'''
import json, sys, time
import chip_smoke as cs
t0 = time.perf_counter()
if sys.argv[2] == "c":
    lines, bounds = cs.dry_run_cells()
    out = {"lines": lines, "bounds": bounds}
else:
    line, bounds = cs.layout_by_dry_run(sys.argv[1])
    out = {"line": line, "bounds": bounds}
print("DRY" + json.dumps({**out, "s": time.perf_counter() - t0}))
'''


def start_dry_runs() -> dict:
    """Phase 38 (c) and (d), each in a process of its own, started before
    phase 37: fake tensors on the host's CPU need no device, so they run
    beside the card's phases 37 and 38a-b, one core each (a dry run runs
    one thread).  Returns {part: (the process, its stdout and stderr
    files)}."""
    dry = {}
    for part in ("c", "d"):
        out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
        dry[part] = (subprocess.Popen(
            [sys.executable, "-c", DRY_CHILD, torch.cuda.get_device_name(0),
             part], cwd=str(Path(__file__).resolve().parent), stdout=out,
            stderr=err, text=True), out, err)
    return dry


def stop_dry_runs(dry: dict) -> None:
    """Kill the dry runs' processes still running (a phase failed before
    phase 38 waited for them)."""
    for proc, _, _ in dry.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def dry_result(dry: dict, part: str) -> dict:
    """What the dry runs' process ``part`` printed, once it has ended."""
    proc, out, err = dry[part]
    proc.wait(timeout=1200)
    out.seek(0)
    err.seek(0)
    check(proc.returncode == 0,
          f"38{part}: the dry-run process exited {proc.returncode}: "
          f"{err.read()[-3000:]}")
    return json.loads(next(x for x in out.read().splitlines()
                           if x.startswith("DRY"))[3:])


def firsts_agree(got: dict, want: dict) -> dict:
    """:func:`first_logits` of two serves' first logits by prompt."""
    check(set(got) == set(want), "the serves admitted other prompts")
    return first_logits(got, want)


def phase_gateway_mesh(smi: str, layers: int = MESH_LAYERS) -> None:
    """Phase 38 (a) and (b) (:func:`phase_layout`) with yi-6b cut to
    ``layers`` of its 32 layers."""
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    cut = mesh_cut(layers)
    with tempfile.TemporaryDirectory() as workdir:
        ranks = run_world(gateway_rank, 2, device="cuda",
                          args=(workdir, layers), join_timeout_s=900.0)
    lead, follow = ranks
    check([r["rank"] for r in ranks] == [0, 1], "ranks out of order")
    ref, like = lead["ref"], lead["like"]
    gateway_mesh_checks("a", lead["a"], follow["a"], ref)
    fa_ = firsts_agree(lead["a"]["firsts"], ref["firsts"])
    check(fa_["bit_equal"] == fa_["n"] or fa_["worst_rel"] <= 5e-2,
          f"38a: first logits {fa_}")
    cold, warm = lead["cold"]["report"], lead["warm"]["report"]
    gateway_mesh_checks("b cold", lead["cold"], follow["cold"], None, True)
    ca, wa = cold["autotune"], warm["autotune"]
    la = like["report"]["autotune"]
    check(ca["measurements"] > 0 and wa["measurements"] == 0
          and la["measurements"] == 0,
          f"38b: measurements cold {ca['measurements']}, warm "
          f"{wa['measurements']} (in {wa['measured_regions']}), unsharded "
          f"over the mesh's records {la['measurements']} (in "
          f"{la['measured_regions']})")
    check(all(n.endswith("_mesh1x2") for n in ca["measured_regions"]),
          f"38b: regions {ca['measured_regions']}")
    check(wa["committed"] == ca["committed"] == la["committed"]
          == follow["warm"]["report"]["autotune"]["committed"],
          "38b: the ranks', the runs' or the unsharded serve's winners "
          "differ")
    fl = firsts_agree(lead["warm"]["firsts"], like["firsts"])
    print(f"[38a gateway over 1x2] yi-6b at full width, {cut}, phase 26a's "
          f"8 requests of 32 tokens as TCP clients of rank 0's gateway, "
          f"ranks sharing one card (gloo) on {smi}: greedy tokens equal to "
          f"rank 0's unsharded gateway serve "
          f"{greedy_agreement(lead['a']['report'], ref['report'])}, first "
          f"logits bit-equal {fa_['bit_equal']}/{fa_['n']}; launches a rank "
          f"{lead['a']['launches']} (both ranks, the unsharded serve's "
          f"{ref['launches']}); "
          + mesh_gateway_line("sharded", lead["a"]["report"]) + "; "
          + mesh_gateway_line("unsharded", ref["report"])
          + f"; {lead['a']['report']['gateway']['syncs']} tick messages")
    print(f"[38b autotuned gateway over 1x2] yi-6b, {cut}: cold: "
          f"{ca['measurements']} measurements in "
          f"{len(ca['measured_regions'])} regions, committed "
          f"{ca['committed']}; warm: 0 measurements, "
          f"{len(wa['warm_regions'])} regions warm-loaded, rank 0's winners "
          f"on both ranks; against rank 0's unsharded gateway serve over "
          f"the same records (0 measurements, {len(la['warm_regions'])} "
          f"regions warm-loaded, the same winners): greedy tokens equal "
          f"{greedy_agreement(warm, like['report'])}, first logits "
          f"bit-equal {fl['bit_equal']}/{fl['n']} (worst "
          f"{fl['worst_rel']:.2e} of the scale), launches unsharded "
          f"{like['launches']}; against the untuned unsharded serve "
          f"(other tiles, other rounding) {greedy_agreement(warm, ref['report'])}"
          f" tokens equal; " + mesh_gateway_line("cold", cold) + "; "
          + mesh_gateway_line("warm", warm) + "; "
          + mesh_gateway_line("unsharded, same winners", like["report"])
          + f"; peak memory rank 0 {lead['peak_gb']:.2f} GB, rank 1 "
          f"{follow['peak_gb']:.2f} GB; launches a rank cold "
          f"{lead['cold']['launches']}, warm {lead['warm']['launches']}; "
          f"38a-b in {time.perf_counter() - t0:.1f}s")
    # like for like: the unsharded serve at the warm run's committed tiles
    # and splits; each head's attention is independent of the sharding,
    # so every greedy token and every first logit is the same
    gateway_mesh_checks("b warm", lead["warm"], follow["warm"], like, True)
    check(fl["bit_equal"] == fl["n"],
          f"38b: first logits against the unsharded serve at the same "
          f"winners {fl}")


def phase_layout(smi: str, dry, layers: int = MESH_LAYERS) -> None:
    """Phase 38: (a) phase 26a's gateway serve (yi-6b at full width cut to
    ``layers`` of its 32 layers, paged, chunks of 128, max_inflight 2)
    through ``serve --gateway --mesh 1x2``: two ranks on the one card over
    gloo, rank 0's gateway broadcasting each tick's admissions to rank 1;
    greedy tokens equal to rank 0's unsharded gateway serve in the phase
    and each admission's first logits bit-equal to it, per-rank launches
    of K4 and K3 equal to it and to each other; (b) the same with
    ``--autotune``, twice in one workdir: the warm run measures nothing
    and commits rank 0's winners, and is held to rank 0's unsharded
    gateway serve over the same records (the same winners, warm-loaded:
    the same tiles and splits) exactly: every greedy token, every first
    logit bit for bit, the launches; (c) the dry run at full width over
    fake worlds; (d) static AT by the dry run's bound ((c) and (d) run in
    ``dry``, :func:`start_dry_runs`'s processes, which this phase waits
    for)."""
    t0 = time.perf_counter()
    phase_gateway_mesh(smi, layers)
    t1 = time.perf_counter()
    c, d = dry_result(dry, "c"), dry_result(dry, "d")
    # (d) ran (c)'s 16x16 train_4k cell again at its plan: the same bound
    check(all(d["bounds"][p] == b for p, b in c["bounds"].items()),
          f"38d: bounds {d['bounds']} against (c)'s {c['bounds']}")
    print("[38c dry run] fake tensors over fake worlds (no device work): "
          + "; ".join(c["lines"]))
    print("[38d static AT by the dry run] " + d["line"] + "; the bound of "
          f"(c)'s plan equal to (c)'s")
    print(f"[38 layout] the gateway (a, b) in {t1 - t0:.1f}s; the dry runs "
          f"took (c) {c['s']:.1f}s and (d) {d['s']:.1f}s in processes of "
          f"their own beside phases 37-38b, {time.perf_counter() - t1:.1f}s "
          f"waited for here")


# --------------------------------------------------------------------------
# phase 39: every head dim and group size the Pallas kernels take
# --------------------------------------------------------------------------

#: (a) the float32 serves: (arch, layers kept or None for the whole, modes)
P39_FP32 = (("h2o-danube-1.8b", None, ("dense",)),
            ("zamba2-7b", 13, ("dense",)),
            ("pixtral-12b", 10, ("dense", "paged", "split", "int8",
                                 "int8 split", "spec", "spec int8")))
#: (b) the bf16 head dims on yi-6b's widths: Phi-3-mini's 96, Gemma-7B's
#: 256, and 100 (a bf16 row of 200 bytes, no multiple of 16)
P39_DIMS = (96, 256, 100)
P39_LAYERS = 8
#: (c) group sizes on yi-6b's widths: (label, q heads, kv heads, D)
P39_GROUPS = (("Qwen2-7B's G 7", 28, 4, 128), ("G 3 at D 160", 24, 8, 160))
#: the phase's serves: 4 requests of 8 tokens after 200-token prompts
P39_SERVE = dict(n_requests=4, n_lanes=4, prompt_len=200, max_new=8,
                 max_len=512)
P39_PAGED = dict(cache="paged", page_size=16, prefill_chunk=128)
#: the kernel checks: head dims of the padded route (and 80, 112, 160 in
#: float32) at G 7, 37 and 90 among them for rows of bf16 and int8 that
#: are no multiple of 4 bytes (byte copies, the stores' odd and 2-column
#: tails), group sizes of the flattened prefill rows
P39_CHECK_DIMS = (24, 36, 37, 80, 90, 96, 100, 112, 160, 256)
P39_CHECK_GROUPS = ((3, 8, 160), (5, 4, 160), (7, 4, 128), (9, 2, 64),
                    (96, 1, 128))                       # (G, Hkv, D)
#: (d) a padded instance forced at a head dim with an instance of its own:
#: (d, width)
P39_BIT_EQUAL = ((80, 96), (112, 128), (64, 96), (128, 160))

F32 = torch.float32
#: the kernel a launch runs, by query type: K1, K2, the paged decode and
#: the paged prefill
P39_ROUTES = {BF16: (fa.TC_KERNEL, pa.DECODE_TC_KERNEL, pa.DECODE_TC_KERNEL,
                     TC_KERNEL),
              F32: ("flash_attention_kernel", fa.DECODE_SIMT_KERNEL,
                    pa.DECODE_SIMT_KERNEL, "paged_prefill_kernel")}


def p39_kernel(wrapper, dtype) -> str:
    """The kernel ``wrapper`` must have run for a query of ``dtype``."""
    k1, k2, dec, pre = P39_ROUTES[dtype]
    if wrapper is fa.flash_attention:
        return k1
    if wrapper is fa.flash_decode:
        return k2
    return dec if "decode" in wrapper.__name__ else pre


def p39_route(wrapper, dtype, d: int, g: int):
    """The instance a launch of ``wrapper`` takes: ``pa.prefill_route``'s
    for a prefill or verify kernel at group size ``g``, else
    ``fa.route``'s."""
    if "prefill" in wrapper.__name__:
        return pa.prefill_route(wrapper.__name__, dtype, d, g)
    return fa.route(wrapper.__name__, dtype, d)


def p39_launch(wrapper, dtype, d: int, g: int, fn, want, what: str,
               live=None, tag: str = "[39]") -> float:
    """``fn()`` must launch ``wrapper`` once on the kernel of ``dtype``'s
    route, on the padded instance :func:`p39_route` names where it names
    one (a head dim with none of its own, or a prefill whose G ``g``
    divides none of the own instance's row tiles), and agree with
    ``want`` on the rows ``live`` selects (a decode's lanes with keys:
    the kernels give exactly 0 where kv_len is 0, which the caller
    checks)."""
    n, w = wrapper.launches, dict(wrapper.by_width)
    got = fn()
    rt = p39_route(wrapper, dtype, d, g)
    padded = {k: v - w.get(k, 0) for k, v in wrapper.by_width.items()
              if v != w.get(k, 0)}
    check(wrapper.launches == n + 1
          and wrapper.last_kernel == p39_kernel(wrapper, dtype)
          and padded == ({rt.width: 1} if rt.padded else {}),
          f"{tag} {what}: {wrapper.__name__} launched "
          f"{wrapper.launches - n} times on {wrapper.last_kernel}, padded "
          f"launches by width {padded}, expected {rt}")
    if live is not None:
        check(live is not P39_LIVE or bool((got[3] == 0).all()),
              f"{tag} {what}: the lane without keys is not exactly 0")
        got, want = got[live], want[live]
    return compare(got, want, dtype)


#: the lanes with keys of the phase's decode cases (kv_len 200, 97, 1, 0)
P39_LIVE = slice(0, 3)


def p39_paged_checks(dtype, h: int, hkv: int, d: int, seed: int,
                     decode: bool = True, tag: str = "[39]") -> float:
    """K3/K6a, the split decode (K5a/K6b with K5c) at 8 splits, K4/K6c on
    a chunk of 40 at 60 and one at 0 with 33 rows, and the split prefill
    (K5b/K6d with K5c) at 4 splits, over fp and int8 pools, against
    plain; returns the largest error."""
    errs = []
    g = h // hkv
    for quant in (False, True):
        if decode:
            q, kp, vp, table, lens = paged_case(4, h, hkv, d, 16, 16,
                                                [200, 97, 1, 0], dtype, seed)
            pools, one = decode_pools(kp, vp, quant)
            want = plain_decode(q, pools, table, lens)
            for ns in (1, 8):
                if ns == 1:
                    wrapper = one
                elif dtype == BF16:
                    wrapper = (pa.paged_decode_split_quant_merged if quant
                               else pa.paged_decode_split_merged)
                else:
                    wrapper = (pa.paged_decode_split_quant if quant
                               else pa.paged_decode_split)
                errs.append(p39_launch(
                    wrapper, dtype, d, g, lambda ns=ns: one(
                        q, *pools, table, lens, num_splits=ns), want,
                    f"decode G {g} D {d} {dtype} int8 {quant} ns {ns}",
                    P39_LIVE, tag))
        case = ("p39", h, hkv, d, 16, 16, [60, 0], [40, 33], 40, dtype)
        q, pp, table, start, lens = split_case(case, seed + 7, quant)
        want = ref.paged_prefill_ref(q, pp.k, pp.v, table, start, lens,
                                     k_scale=pp.k_scale, v_scale=pp.v_scale)
        live = torch.zeros(q.shape, dtype=torch.bool, device="cuda")
        for b, v in enumerate(case[7]):     # rows past kv_len are padding
            live[b, :, :v] = True
        for ns in (1, 4):
            if ns == 1:
                wrapper = (pa.flash_paged_prefill_quant if quant
                           else pa.flash_paged_prefill)
            elif dtype == BF16:
                wrapper = (pa.paged_prefill_split_quant_merged if quant
                           else pa.paged_prefill_split_merged)
            else:
                wrapper = (pa.paged_prefill_split_quant if quant
                           else pa.paged_prefill_split)
            errs.append(p39_launch(
                wrapper, dtype, d, g, lambda ns=ns: ops.paged_prefill(
                    q, pp, table, start, lens, num_splits=ns), want,
                f"prefill G {g} D {d} {dtype} int8 {quant} ns {ns}", live,
                tag))
    check(counters_zero(), f"{tag} an arrival counter is not 0")
    return max(errs)


def p39_kernel_checks() -> str:
    """39 (kernels): K1-K6d against plain at every head dim of
    :data:`P39_CHECK_DIMS` in bf16 and float32 (G 7: 28 q / 4 kv heads),
    each launch checked on its route (tensor cores or the SIMT template)
    and instance (its own, or the padded one :func:`p39_route` names); the
    prefill kernel's flattened rows at :data:`P39_CHECK_GROUPS`; a head
    dim above 256 refused.  Returns the summary."""
    t0 = time.perf_counter()
    errs = collections.defaultdict(float)
    for dtype in (BF16, F32):
        for i, d in enumerate(P39_CHECK_DIMS):
            seed = 39000 + 100 * i + (50 if dtype == F32 else 0)
            h, hkv = 28, 4
            q = randn((2, h, 200, d), seed, dtype)
            k = randn((2, hkv, 200, d), seed + 1, dtype)
            v = randn((2, hkv, 200, d), seed + 2, dtype)
            errs["K1", dtype] = max(errs["K1", dtype], p39_launch(
                fa.flash_attention, dtype, d, h // hkv,
                lambda: fa.flash_attention(q, k, v, causal=True),
                ref.attention_ref(q, k, v, causal=True), f"K1 D {d}"))
            kv_len = torch.tensor([200, 97, 1, 0], dtype=torch.int32,
                                  device="cuda")
            q1 = randn((4, h, 1, d), seed + 3, dtype)
            k1 = randn((4, hkv, 200, d), seed + 4, dtype)
            errs["K2", dtype] = max(errs["K2", dtype], p39_launch(
                fa.flash_decode, dtype, d, h // hkv,
                lambda: fa.flash_decode(q1, k1, k1, kv_len),
                ref.decode_ref(q1, k1, k1, kv_len), f"K2 D {d}", P39_LIVE))
            errs["K3-K6d", dtype] = max(errs["K3-K6d", dtype],
                                        p39_paged_checks(dtype, h, hkv, d,
                                                         seed + 10))
    for i, (g, hkv, d) in enumerate(P39_CHECK_GROUPS):
        errs["K4-K6d G", BF16] = max(errs["K4-K6d G", BF16], p39_paged_checks(
            BF16, g * hkv, hkv, d, 39500 + 10 * i, decode=False))
    over = fa.MAX_HEAD_DIM + 8
    q = torch.zeros((1, 2, 8, over), dtype=BF16, device="cuda")
    try:
        fa.flash_attention(q, q, q)
        refused = None
    except ValueError as e:
        refused = str(e)
    check(refused is not None and str(fa.MAX_HEAD_DIM) in refused,
          f"[39] a head dim of {over} was not refused: {refused!r}")
    return (f"K1-K6d against plain at D {P39_CHECK_DIMS} (28 q / 4 kv "
            f"heads, bf16 and float32) and the prefill kernel at (G, Hkv, D) "
            f"{P39_CHECK_GROUPS}, max abs err "
            + ", ".join(f"{k} {'bf16' if t == BF16 else 'fp32'} {e:.2e}"
                        for (k, t), e in errs.items())
            + f"; D {over} refused ({refused!r}); "
            f"{time.perf_counter() - t0:.1f}s")


def p39_bit_equal() -> str:
    """39 (d): at a head dim with an instance of its own, the padded
    instance of a wider rung, forced by the private ``fa._forced_width``,
    must give the same bits: K1, K2, K3 (and K5a with K5c at 8 splits)
    and K4 (and K5b with K5c at 4 splits), bf16 and float32, at the
    (d, width) pairs of :data:`P39_BIT_EQUAL` that have an instance of
    their own."""
    n = 0
    for dtype in (BF16, F32):
        for i, (d, width) in enumerate(P39_BIT_EQUAL):
            seed = 39700 + 10 * i
            q = randn((1, 8, 150, d), seed, dtype)
            k = randn((1, 2, 150, d), seed + 1, dtype)
            q1 = randn((4, 8, 1, d), seed + 2, dtype)
            kv_len = torch.tensor([150, 70, 1, 0], dtype=torch.int32,
                                  device="cuda")
            k1 = randn((4, 2, 150, d), seed + 3, dtype)
            pq, kp, vp, table, lens = paged_case(4, 8, 2, d, 16, 16,
                                                 [200, 97, 1, 0], dtype,
                                                 seed + 4)
            case = ("p39", 8, 2, d, 16, 16, [60, 0], [40, 33], 40, dtype)
            cq, pp, ctable, start, clens = split_case(case, seed + 5, False)
            calls = []
            if d in fa.head_dims("flash_attention", dtype):
                calls.append(("K1", lambda: fa.flash_attention(
                    q, k, k, causal=True)))
            # the same cluster size for both: the rule reads the instance
            # it launches, and another c cuts the keys at other places
            if d in fa.head_dims("flash_decode", dtype):
                calls.append(("K2", lambda: fa.flash_decode(
                    q1, k1, k1, kv_len, _cluster=2)))
            if d in fa.head_dims("flash_paged_decode", dtype):
                for ns in (1, 8):
                    calls.append((f"K3 ns {ns}", lambda ns=ns:
                                  pa.flash_paged_decode(
                                      pq, kp, vp, table, lens,
                                      num_splits=ns, _cluster=2)))
                for ns in (1, 4):
                    calls.append((f"K4 ns {ns}", lambda ns=ns:
                                  pa.flash_paged_prefill(
                                      cq, pp.k, pp.v, ctable, start, clens,
                                      num_splits=ns)))
            for label, call in calls:
                own = call()
                with fa._forced_width(width):
                    padded = call()
                torch.cuda.synchronize()
                check(torch.equal(own, padded),
                      f"[39 (d)] {label} {dtype} at D {d}: the padded "
                      f"instance of width {width} is not bit-equal to D "
                      f"{d}'s own (max abs diff "
                      f"{float((own.float() - padded.float()).abs().max()):.3e})")
                n += 1
    check(counters_zero(), "[39 (d)] an arrival counter is not 0")
    return (f"{n} launches of a padded instance bit-equal to the head dim's "
            f"own at (D, width) {P39_BIT_EQUAL}, bf16 and float32")


def p39_modes(dtype) -> dict:
    """The phase's serve modes: (serve keywords, the kernels that serve
    them and no other)."""
    bf16 = dtype == BF16
    split = ((pa.paged_decode_split_merged,) if bf16 else
             (pa.paged_decode_split, pa.split_combine))
    split8 = ((pa.paged_decode_split_quant_merged,) if bf16 else
              (pa.paged_decode_split_quant, pa.split_combine))
    verify = ((pa.paged_prefill_split_merged,) if bf16 else
              (pa.paged_prefill_split, pa.split_combine))
    verify8 = ((pa.paged_prefill_split_quant_merged,) if bf16 else
               (pa.paged_prefill_split_quant, pa.split_combine))
    draft = (fa.flash_attention, fa.flash_decode)
    return {
        "dense": ({}, (fa.flash_attention, fa.flash_decode)),
        "paged": (P39_PAGED, (pa.flash_paged_prefill, pa.flash_paged_decode)),
        "split": (dict(P39_PAGED, num_splits=8),
                  (pa.flash_paged_prefill,) + split),
        "int8": (dict(P39_PAGED, kv_dtype="int8"),
                 (pa.flash_paged_prefill_quant, pa.flash_paged_decode_quant)),
        "int8 split": (dict(P39_PAGED, kv_dtype="int8", num_splits=8),
                       (pa.flash_paged_prefill_quant,) + split8),
        "spec": (dict(SPEC), (pa.flash_paged_prefill,) + verify + draft),
        "spec int8": (dict(SPEC, kv_dtype="int8"),
                      (pa.flash_paged_prefill_quant,) + verify8 + draft),
    }


def p39_serves(model, params, tag: str, modes, n_attn: int) -> tuple[dict, str]:
    """The serves of ``modes`` (:func:`p39_modes`) of a model built at
    full width, each with the launch, tile and width counters zeroed just
    before and read just after: every request finishes with its tokens;
    exactly the mode's kernels launch, each on its query type's route and,
    where the head dim has no instance of its own, on the padded one;
    outside the speculative modes K1 once an attention layer an admission
    and every other kernel once an attention layer a chunk or a step.
    Returns the launches by tile over the serves and their line."""
    cfg = model.cfg
    dtype = BF16 if cfg.compute_dtype == "bfloat16" else F32
    d = cfg.head_dim
    table = p39_modes(dtype)
    by_tile = collections.defaultdict(collections.Counter)
    lines = []
    for mode in modes:
        kw, kernels = table[mode]
        at.clear_published()
        for kernel in KERNELS:
            kernel.launches = 0
            if hasattr(kernel, "by_width"):
                kernel.by_width.clear()
        for kernel in PHI4_TILED:
            kernel.by_tile.clear()
        report = serve_mod.serve_model(model, params, ServeConfig(
            **{**SERVE, **P39_SERVE, "arch": cfg.name, **kw}))
        torch.cuda.synchronize()
        launches = {k.__name__: k.launches for k in KERNELS}
        what = f"{tag} {mode}"
        check(report["finished"] == P39_SERVE["n_requests"]
              and all(len(t) == P39_SERVE["max_new"]
                      for t in report["outputs"].values()),
              f"{what}: {report['finished']} requests finished")
        only_launched(launches, kernels, what)
        for kernel in kernels:
            n = launches[kernel.__name__]
            check(n > 0, f"{what}: {kernel.__name__} never launched")
            if kernel is not pa.split_combine:
                check(kernel.last_kernel == p39_kernel(kernel, dtype),
                      f"{what}: {kernel.__name__} ran {kernel.last_kernel}")
                rt = p39_route(kernel, dtype, d,
                               cfg.n_heads // cfg.n_kv_heads)
                check(dict(kernel.by_width) == ({rt.width: n} if rt.padded
                                                else {}),
                      f"{what}: {kernel.__name__}'s padded launches by "
                      f"width {dict(kernel.by_width)} of {n}, route {rt}")
        if not mode.startswith("spec"):
            steps = {kernels[0]: (report["prefill_chunks"] if "paged" in kw
                                  .get("cache", "") else
                                  P39_SERVE["n_requests"]),
                     kernels[1]: report["decode_steps"]}
            for kernel, count in steps.items():
                check(launches[kernel.__name__] == n_attn * count,
                      f"{what}: {kernel.__name__} launched "
                      f"{launches[kernel.__name__]} times, expected "
                      f"{n_attn} x {count}")
        check(counters_zero(), f"{what}: an arrival counter is not 0")
        for kernel in PHI4_TILED:
            by_tile[kernel.__name__].update(kernel.by_tile)
        lines.append(f"{mode} {report['tokens_per_s']:.1f} tok/s, launches "
                     f"{ {k: n for k, n in launches.items() if n} }")
    at.clear_published()
    return by_tile, "; ".join(lines)


def p39_logits(model, params, tag: str, paged: bool) -> str:
    """Prefill + 4 decode steps on dense lanes (and, with ``paged``, phase
    10's paged run and phase 14's int8 run at 8 splits), kernels against
    plain: within 5e-2 of the logits' scale in bf16 (check_logits), 1e-3
    in float32, whose kernels take every product in fp32."""
    vocab = model.cfg.padded_vocab
    rel = 1e-3 if model.cfg.compute_dtype == "float32" else 5e-2
    runs = [("dense", dense_logits(model, params))]
    if paged:
        runs += [("paged", paged_logits(model, params)),
                 ("int8 pages, 8 splits", paged_logits(
                     model, params, quantized=True, splits=(8, 8, 8, 8)))]
    return "; ".join(f"{label} logits: " + check_logits(
        plain, kern, vocab, f"{tag} {label} logits", rel)
        for label, (plain, kern) in runs)


def p39_model(name: str, dtype: str, layers: int | None, **widths):
    """The arch ``name`` at published widths (``widths`` replacing fields:
    another head geometry), cut to ``layers`` (None: whole), in ``dtype``
    compute and caches; random weights from seed 0."""
    cfg = get_arch(name)
    cfg = dataclasses.replace(cfg, compute_dtype=dtype, cache_dtype=dtype,
                              n_layers=layers or cfg.n_layers, **widths)
    model = build_model(cfg)
    return model, model.init(0, "cuda")


def p39_free() -> None:
    gc.collect()
    torch.cuda.empty_cache()


def phase_shapes(smi: str) -> list[dict]:
    """Phase 39: every head dim and group size the Pallas attention kernels
    take.  (kernels) K1-K6d at the padded route's head dims and the
    flattened prefill rows' group sizes against plain; (a) float32 serves
    at D 80 (h2o-danube-1.8b whole, dense lanes), 112 (zamba2-7b cut to
    13 layers: the shared block twice) and 160 (pixtral-12b cut to 10 of
    40 layers: every serve mode), all on the SIMT templates, logits
    against plain; (b) yi-6b's widths cut to 8 layers at d_head 96, 256
    and 100, dense, paged, int8 at 8 splits and speculative, on the
    padded instances, logits, and K1-K4 at D 96 and 256 timed beside
    plain, SDPA and the bound; (c) Qwen2-7B's 28 q / 4 kv heads (G 7, D
    128) and 24 / 8 (G 3) at D 160 on yi-6b's widths, paged, int8 at 8
    splits and speculative on the flattened rows, and K4, K6c, K5b and
    K6d at G 7 timed; (d) the padded instances bit-equal to the head dims'
    own."""
    t0 = time.perf_counter()
    print(f"[39 kernels] {p39_kernel_checks()}")
    print(f"[39 (d) bit-equality] {p39_bit_equal()}")
    rows = []
    # (a) float32 serves on the SIMT templates
    for name, layers, modes in P39_FP32:
        model, params = p39_model(name, "float32", layers)
        cfg = model.cfg
        n_attn = (cfg.n_shared_attn_applications() if cfg.attn_period
                  else cfg.n_layers)
        _, line = p39_serves(model, params, f"[39 (a) {name} float32]",
                             modes, n_attn)
        logits = p39_logits(model, params, f"[39 (a) {name}]",
                            paged="paged" in modes)
        print(f"[39 (a) {name} float32] {cfg.n_layers} of "
              f"{get_arch(name).n_layers} layers, D {cfg.head_dim}, "
              f"{cfg.n_heads} q / {cfg.n_kv_heads} kv heads (route "
              f"{fa.route('flash_attention', F32, cfg.head_dim)} for K1, "
              f"{fa.route('flash_paged_decode', F32, cfg.head_dim)} for the "
              f"paged kernels), on {smi}: {line}; {logits}")
        del model, params
        p39_free()
    # (b) bf16 at the padded head dims, on yi-6b's widths
    for d in P39_DIMS:
        model, params = p39_model("yi-6b", "bfloat16", P39_LAYERS, d_head=d)
        by_tile, line = p39_serves(model, params, f"[39 (b) D {d}]",
                                   ("dense", "paged", "int8 split", "spec"),
                                   P39_LAYERS)
        logits = p39_logits(model, params, f"[39 (b) D {d}]", paged=True)
        print(f"[39 (b) yi-6b widths, d_head {d}] {P39_LAYERS} of 32 layers, "
              f"32 q / 4 kv heads, routes K1 "
              f"{fa.route('flash_attention', BF16, d)}, paged "
              f"{fa.route('flash_paged_decode', BF16, d)}, on {smi}: {line}; "
              f"{logits}")
        del model, params
        p39_free()
        if d in (96, 256):
            rows += p39_dense_rows(d, by_tile)
            rows += pixtral_decode_rows(by_tile, 3900 + d, 32, 4, d,
                                        f"[39 (b) D {d} kernels]",
                                        "yi-6b widths decode", ("K3",))
            default = (pa.default_block_q(d, 8),
                       pa.default_block_k(BF16, d))
            rows += tile_rows(f"[39 (b) D {d} kernels]", 8,
                              f"32 q / 4 kv heads of {d}",
                              ("p39 chunk at 384", 32, 4, d, 16, 32, [384],
                               [128], 128, BF16), None, by_tile, 3950 + d,
                              d=d, tiles=[default], kinds=("K4",))
    # (c) group sizes on the flattened rows
    for label, h, hkv, d in P39_GROUPS:
        model, params = p39_model("yi-6b", "bfloat16", P39_LAYERS,
                                  n_heads=h, n_kv_heads=hkv, d_head=d)
        by_tile, line = p39_serves(model, params, f"[39 (c) {label}]",
                                   ("paged", "int8 split", "spec",
                                    "spec int8"), P39_LAYERS)
        logits = p39_logits(model, params, f"[39 (c) {label}]", paged=True)
        g = h // hkv
        default = (pa.default_block_q(d, g), pa.default_block_k(BF16, d))
        print(f"[39 (c) {label}] yi-6b widths, {P39_LAYERS} layers, {h} q / "
              f"{hkv} kv heads of {d} (G {g}: prefill tiles "
              f"{pa.prefill_tiles(BF16, d, g)}, flattened "
              f"{pa.flattened(d, g)} on "
              f"{pa.prefill_route('flash_paged_prefill', BF16, d, g)}, "
              f"default {default}), on {smi}: {line}; "
              f"{logits}")
        del model, params
        p39_free()
        if g == 7:
            rows += tile_rows(
                f"[39 (c) {label} kernels]", g, f"{h} q / {hkv} kv heads of "
                f"{d}, flattened rows",
                ("G 7 chunk at 384", h, hkv, d, 16, 32, [384], [128], 128,
                 BF16),
                ("G 7 verify", h, hkv, d, 16, 64, [839, 720, 190, 544, 0],
                 [5, 5, 5, 5, 0], 5, BF16), by_tile, 3990, d=d,
                tiles=[default])
    print(f"[39] phase 39 in {time.perf_counter() - t0:.1f}s")
    return rows


def p39_dense_rows(d: int, by_tile: dict, phase: str = "39 (b)"
                   ) -> list[dict]:
    """K1 (causal prefill of 512, 32 q / 4 kv heads) and K2 (4 lanes of
    the phase-7 lengths in strips of 1024) at head dim ``d`` on the padded
    instance, against plain, timed beside SDPA and the bound, with the
    launches of the phase's serves."""
    rows = []
    q = randn((1, 32, 512, d), 3960 + d, BF16)
    k = randn((1, 4, 512, d), 3961 + d, BF16)
    v = randn((1, 4, 512, d), 3962 + d, BF16)
    r, line1 = k1_kernel_row(f"D{d}", q, k, v, dict(causal=True), None,
                             f"yi-6b widths prefill S=512 D {d}",
                             fa.attention_tiles(BF16, d)[0])
    r["launches"] = sum(by_tile.get("flash_attention", {}).values())
    rows.append(r)
    kv_len = torch.tensor(PIXTRAL_DECODE, dtype=torch.int32, device="cuda")
    q1 = randn((4, 32, 1, d), 3963 + d, BF16)
    k1 = randn((4, 4, 1024, d), 3964 + d, BF16)
    v1 = randn((4, 4, 1024, d), 3965 + d, BF16)
    r, line2 = k2_kernel_row(f"D{d}", q1, k1, v1, kv_len,
                             f"yi-6b widths decode D {d}")
    r["launches"] = sum(by_tile.get("flash_decode", {}).values())
    rows.append(r)
    check(all(r["launches"] > 0 for r in rows),
          f"[{phase} D {d}] K1 or K2 not launched in the serves")
    print(f"[{phase} D {d} kernels] {line1}; {line2}")
    return rows


# --------------------------------------------------------------------------
# phase 40: head dims above 256, on the wide instances
# --------------------------------------------------------------------------

#: the kernel checks' head dims: 264 and 300 (a bf16 row of 600 bytes, no
#: multiple of 16: the 4-byte copies) on the rung 384, and the rungs' own
#: widths 384 and 512
P40_CHECK_DIMS = (264, 300, 384, 512)
#: the forced wide rung at a head dim with an instance of its own: (d, width)
P40_FORCED = ((128, 384), (256, 512))
#: yi-6b's widths at d_head 512: (a) every layer, (b) cut to P40_LAYERS
P40_D = 512
P40_LAYERS = 8
#: (c) float32 at d_head 512 on the SIMT templates: the serve modes
P40_FP32_MODES = ("dense", "paged", "int8 split", "spec", "spec int8")
#: (d) d_head 300 (the 4-byte copies); (e) Qwen2-7B's 28 q / 4 kv heads (G
#: 7) at d_head 384, on the flattened rows
P40_D300 = 300
P40_G7 = ("Qwen2-7B's G 7 at D 384", 28, 4, 384)


def p40_kernel_checks() -> str:
    """40 (kernels): K1-K6d (K5c merged for a bf16 query, standalone for
    float32) against plain at every head dim of :data:`P40_CHECK_DIMS`, bf16
    and float32, 28 q / 4 kv heads (G 7, the prefill on the flattened
    rows), each launch on the route and wide instance ``fa.route`` and
    ``pa.prefill_route`` name; then the wide rung forced at D 128 and 256
    (:data:`P40_FORCED`) against the head dim's own instance, within the
    type's tolerance (the slices' partial sums change the order of Q.K^T's
    sums, so not bit for bit).  Returns the summary."""
    t0 = time.perf_counter()
    errs = collections.defaultdict(float)
    for dtype in (BF16, F32):
        for i, d in enumerate(P40_CHECK_DIMS):
            seed = 40000 + 100 * i + (50 if dtype == F32 else 0)
            h, hkv = 28, 4
            check(fa.route("flash_attention", dtype, d).wide,
                  f"[40] D {d} does not route to a wide instance")
            q = randn((2, h, 200, d), seed, dtype)
            k = randn((2, hkv, 200, d), seed + 1, dtype)
            v = randn((2, hkv, 200, d), seed + 2, dtype)
            errs["K1", dtype] = max(errs["K1", dtype], p39_launch(
                fa.flash_attention, dtype, d, h // hkv,
                lambda: fa.flash_attention(q, k, v, causal=True),
                ref.attention_ref(q, k, v, causal=True), f"K1 D {d}",
                tag="[40]"))
            kv_len = torch.tensor([200, 97, 1, 0], dtype=torch.int32,
                                  device="cuda")
            q1 = randn((4, h, 1, d), seed + 3, dtype)
            k1 = randn((4, hkv, 200, d), seed + 4, dtype)
            v1 = randn((4, hkv, 200, d), seed + 5, dtype)
            errs["K2", dtype] = max(errs["K2", dtype], p39_launch(
                fa.flash_decode, dtype, d, h // hkv,
                lambda: fa.flash_decode(q1, k1, v1, kv_len),
                ref.decode_ref(q1, k1, v1, kv_len), f"K2 D {d}", P39_LIVE,
                tag="[40]"))
            errs["K3-K6d", dtype] = max(errs["K3-K6d", dtype],
                                        p39_paged_checks(dtype, h, hkv, d,
                                                         seed + 10,
                                                         tag="[40]"))
    forced = collections.defaultdict(float)
    for dtype in (BF16, F32):
        for i, (d, width) in enumerate(P40_FORCED):
            seed = 40700 + 10 * i
            q = randn((1, 8, 150, d), seed, dtype)
            k = randn((1, 2, 150, d), seed + 1, dtype)
            q1 = randn((4, 8, 1, d), seed + 2, dtype)
            kv_len = torch.tensor([150, 70, 1, 0], dtype=torch.int32,
                                  device="cuda")
            k1 = randn((4, 2, 150, d), seed + 3, dtype)
            pq, kp, vp, table, lens = paged_case(4, 8, 2, d, 16, 16,
                                                 [200, 97, 1, 0], dtype,
                                                 seed + 4)
            case = ("p40", 8, 2, d, 16, 16, [60, 0], [40, 33], 40, dtype)
            cq, pp, ctable, start, clens = split_case(case, seed + 5, False)
            calls = [("K1", fa.flash_attention, None,
                      lambda: fa.flash_attention(q, k, k, causal=True)),
                     ("K2", fa.flash_decode, P39_LIVE,
                      lambda: fa.flash_decode(q1, k1, k1, kv_len,
                                              _cluster=2))]
            split = ((pa.paged_decode_split_merged,
                      pa.paged_prefill_split_merged) if dtype == BF16 else
                     (pa.paged_decode_split, pa.paged_prefill_split))
            for ns in (1, 8):
                calls.append((f"K3 ns {ns}", pa.flash_paged_decode if ns == 1
                              else split[0], P39_LIVE,
                              lambda ns=ns: pa.flash_paged_decode(
                                  pq, kp, vp, table, lens, num_splits=ns,
                                  _cluster=2)))
            chunk = torch.zeros(cq.shape, dtype=torch.bool, device="cuda")
            for b, n in enumerate(case[7]):   # rows past the chunk: padding
                chunk[b, :, :n] = True
            for ns in (1, 4):
                calls.append((f"K4 ns {ns}", pa.flash_paged_prefill if ns == 1
                              else split[1], chunk,
                              lambda ns=ns: pa.flash_paged_prefill(
                                  cq, pp.k, pp.v, ctable, start, clens,
                                  num_splits=ns)))
            for label, wrapper, live, call in calls:
                own = call()
                with fa._forced_width(width):
                    forced[label.split()[0], dtype] = max(
                        forced[label.split()[0], dtype], p39_launch(
                            wrapper, dtype, d, 4, call, own,
                            f"{label} {dtype} D {d} forced to {width}",
                            live, tag="[40 forced]"))
    check(counters_zero(), "[40] an arrival counter is not 0")
    return (f"K1-K6d against plain at D {P40_CHECK_DIMS} (28 q / 4 kv heads, "
            f"bf16 and float32, each on its wide instance), max abs err "
            + ", ".join(f"{k} {'bf16' if t == BF16 else 'fp32'} {e:.2e}"
                        for (k, t), e in errs.items())
            + f"; the wide rung forced at (D, width) {P40_FORCED} against the "
            "head dim's own instance, max abs diff "
            + ", ".join(f"{k} {'bf16' if t == BF16 else 'fp32'} {e:.2e}"
                        for (k, t), e in forced.items())
            + f"; {time.perf_counter() - t0:.1f}s")


def p40_function(smi: str) -> str:
    """40 (f): K1's autograd Function (forward on the wide instance, the
    backward in PyTorch ops) at D 512 against the plain autograd: the
    output and dq, dk, dv within FN_TOL of each tensor's scale."""
    n0 = fa.flash_attention.by_width[P40_D]
    case = attention_fn_case("D 512", 1, 8, 2, 256, 256, P40_D,
                             dict(causal=True), 40900)
    check(fa.flash_attention.by_width[P40_D] == n0 + 1,
          "[40 (f)] the Function's forward did not run the wide instance")
    return (f"FlashAttentionFn at D {P40_D} (8 q / 2 kv heads, S 256, "
            f"causal) vs the plain autograd on {smi}: scaled errors (o, dq, "
            f"dk, dv) {[f'{e:.2e}' for e in case['errs']]}")


def p40_serve(smi: str, tag: str, name_dtype: str, layers: int | None,
              modes, **widths) -> dict:
    """The serves of ``modes`` and the logits of yi-6b's widths with
    ``widths`` replaced, in ``name_dtype`` compute, cut to ``layers``;
    returns the launches by tile over the serves."""
    model, params = p39_model("yi-6b", name_dtype, layers, **widths)
    cfg = model.cfg
    by_tile, line = p39_serves(model, params, tag, modes, cfg.n_layers)
    logits = p39_logits(model, params, tag,
                        paged=any(m != "dense" for m in modes))
    dtype = BF16 if name_dtype == "bfloat16" else F32
    g = cfg.n_heads // cfg.n_kv_heads
    print(f"{tag} {cfg.n_layers} of 32 layers, {cfg.n_heads} q / "
          f"{cfg.n_kv_heads} kv heads of {cfg.head_dim}, {name_dtype}, "
          f"routes K1 {fa.route('flash_attention', dtype, cfg.head_dim)}, "
          f"paged {fa.route('flash_paged_decode', dtype, cfg.head_dim)}, "
          f"prefill "
          f"{pa.prefill_route('flash_paged_prefill', dtype, cfg.head_dim, g)}"
          f" at tiles {pa.prefill_tiles(dtype, cfg.head_dim, g)}, on {smi}: "
          f"{line}; {logits}")
    del model, params
    p39_free()
    return by_tile


def phase_wide(smi: str) -> list[dict]:
    """Phase 40: head dims above 256, on the wide instances (the head dim
    split across warps, ``csrc/common.cuh``).  (kernels) every wide kernel
    against plain and the forced wide rung against the own instances
    (:func:`p40_kernel_checks`); (a) yi-6b's widths at d_head 512, all 32
    layers (9.7 B parameters), dense and paged serves and logits; (b) the
    same cut to 8 layers: bf16 pages at 8 splits (K5a with K5c merged),
    int8 pages in one pass (K6a) and at 8 splits (K6c, K6b with K5c
    merged), speculative over bf16 and int8 pages (K5b, K6d with K5c
    merged); (c) float32 at d_head 512, 8 layers, on the SIMT templates;
    (d) d_head 300; (e) Qwen2-7B's G 7 at d_head 384 on the flattened
    rows; (f) K1's autograd Function at D 512; K1-K6d at D 512 timed
    beside plain, SDPA and the bound, with the launches of (a) and (b)
    (the kernel rows)."""
    t0 = time.perf_counter()
    print(f"[40 kernels] {p40_kernel_checks()}")
    by_tile = p40_serve(smi, "[40 (a) yi-6b widths, d_head 512]",
                        "bfloat16", None, ("dense", "paged"), d_head=P40_D)
    for name, tiles in p40_serve(
            smi, f"[40 (b) d_head {P40_D}]", "bfloat16", P40_LAYERS,
            ("split", "int8", "int8 split", "spec", "spec int8"),
            d_head=P40_D).items():
        by_tile[name].update(tiles)
    p40_serve(smi, f"[40 (c) d_head {P40_D} float32]", "float32", P40_LAYERS,
              P40_FP32_MODES, d_head=P40_D)
    p40_serve(smi, f"[40 (d) d_head {P40_D300}]", "bfloat16", P40_LAYERS,
              ("dense", "paged", "int8 split", "spec"), d_head=P40_D300)
    label, h, hkv, d = P40_G7
    p40_serve(smi, f"[40 (e) {label}]", "bfloat16", P40_LAYERS,
              ("paged", "int8 split", "spec", "spec int8"), n_heads=h,
              n_kv_heads=hkv, d_head=d)
    print(f"[40 (f)] {p40_function(smi)}")
    d = P40_D
    rows = p39_dense_rows(d, by_tile, phase="40 (a)")
    rows += pixtral_decode_rows(by_tile, 4000 + d, 32, 4, d,
                                f"[40 D {d} kernels]", "yi-6b widths decode")
    rows += tile_rows(f"[40 D {d} kernels]", 8, f"32 q / 4 kv heads of {d}",
                      ("p40 chunk at 384", 32, 4, d, 16, 32, [384], [128],
                       128, BF16),
                      ("p40 verify", 32, 4, d, 16, 64, [839, 720, 190, 544, 0],
                       [5, 5, 5, 5, 0], 5, BF16), by_tile, 4050 + d, d=d,
                      tiles=[(pa.default_block_q(d, 8),
                              pa.default_block_k(BF16, d))])
    print(f"[40] phase 40 in {time.perf_counter() - t0:.1f}s")
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); nothing was run", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    marks = [("start", t0)]

    def done(phases: str) -> None:
        marks.append((phases, time.perf_counter()))

    smi = phase_card()
    phase_build()
    done("1-2")
    k1_row, k1_sweep = phase_k1()
    rows = [k1_row, phase_k2()]
    model = build_model(get_arch("yi-6b"))
    params = model.init(0, "cuda")
    dense, launches = phase_serve(smi, model, params)
    phase_logits(model, params)
    rows += [phase_k3(), phase_k4()]
    paged, paged_launches = phase_paged_serve(smi, dense, model, params)
    launches.update({k: paged_launches[k] for k in
                     ("flash_paged_decode", "flash_paged_prefill")})
    phase_paged_logits(model, params)
    rows += phase_k5() + phase_k6()
    counts, int8_reports = phase_split_int8_serves(smi, paged, model, params)
    launches.update(counts)
    launches.update(phase_fp32_split_serve(smi, model.cfg))
    phase_int8_logits(model, params)
    rows += phase_k5b() + phase_k6d()
    spec_counts, spec_a = phase_spec_prefix_serves(smi, paged, int8_reports,
                                                   model, params)
    launches.update(spec_counts)
    phase_verify_logits(model, params)
    del model, params
    torch.cuda.empty_cache()
    done("3-18")
    sample = load_example("autotune_fdm_torch")
    mm_row, mm_sweep = phase_k8()
    rows += [mm_row, phase_k7(sample)]
    install_launches, winner = phase_install(smi, sample, k1_sweep)
    launches.update(install_launches)
    mm_row["ms"] = mm_sweep[winner]     # the tile the install path published
    done("19-21")
    k9_row, k9_sweep = phase_k9()
    rows.append(k9_row)
    launches["selective_scan"] = phase_fm_serve(smi)
    fm_model = build_model(get_arch(FM))
    fm_params = fm_model.init(0, "cuda")
    phase_fm_logits(fm_model, fm_params)
    del fm_model, fm_params
    torch.cuda.empty_cache()
    chunk = phase_ssm_install(smi, k9_sweep)
    k9_row["ms"] = k9_sweep[chunk]      # the chunk the install path published
    done("22-25")
    check(len(rows) == 14, f"{len(rows)} kernel rows, expected 14")
    for row in rows:
        row["launches"] = launches[row["name"]]
    phase_gateway(smi, paged, spec_a)
    done("26")
    phase_autotune(smi, paged, spec_a)
    done("27")
    rows += phase_phi4(smi)
    done("28")
    check(len(rows) == 22, f"{len(rows)} kernel rows, expected 22")
    phase_moonshot(smi)
    done("29")
    rows += phase_llama4(smi)
    done("30")
    check(len(rows) == 30, f"{len(rows)} kernel rows, expected 30")
    rows += phase_danube(smi)
    done("31")
    check(len(rows) == 36, f"{len(rows)} kernel rows, expected 36")
    rows += phase_whisper(smi)
    done("32")
    rows += phase_zamba(smi)
    done("33")
    check(len(rows) == 47, f"{len(rows)} kernel rows, expected 47")
    rows += phase_pixtral(smi)
    done("34")
    check(len(rows) == 85, f"{len(rows)} kernel rows, expected 85")
    train_rows, step_s = phase_training(smi)
    rows += train_rows
    done("35")
    check(len(rows) == 87, f"{len(rows)} kernel rows, expected 87")
    rows += phase_static(smi, step_s)
    done("36")
    check(len(rows) == 88, f"{len(rows)} kernel rows, expected 88")
    dry = start_dry_runs()
    try:
        phase_mesh(smi)
        done("37")
        phase_layout(smi, dry)
        done("38")
    finally:
        stop_dry_runs(dry)
    rows += phase_shapes(smi)
    done("39")
    check(len(rows) == 100, f"{len(rows)} kernel rows, expected 100")
    rows += phase_wide(smi)
    done("40")
    check(len(rows) == 110, f"{len(rows)} kernel rows, expected 110")
    print(f"[done] phases 1-40 in {time.perf_counter() - t0:.1f}s; by phase "
          + ", ".join(f"{label} {t - marks[i][1]:.1f}s"
                      for i, (label, t) in enumerate(marks[1:])))
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
