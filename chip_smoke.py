#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing a line; any failure exits non-zero:
  1. the device (nvidia-smi name and power limit, torch and CUDA versions);
  2. build the CUDA kernels from ``src/repro_torch/csrc`` (seconds), print
     the registers and spills (``nvcc -Xptxas -v``) of each kernel of the
     flash forward, delta, dq, dkv, SSD forward, SSD backward and RG-LRU
     libraries and count the tensor-core instructions (HGMMA, HMMA) that
     ``cuobjdump -sass`` finds in each but the delta and RG-LRU ones: none
     fails;
  3. each attention kernel against its plain PyTorch version on the same
     inputs: at the yi-6b main-path shape (B 2, S 2048, H 32, K 4, D 128,
     causal, bf16), a sliding-window case and a ragged Sq != Sk case, at
     the recurrentgemma-2b main-path shape (B 2, S 2048, H 10, K 1,
     D 256, window 2048, bf16) and a case where that window bites
     (S 4096), at gemma3-4b's (H 8, K 4, D 256, window 1024, which skips
     kv tiles, and its global layer without the window) and at
     qwen3-moe-235b-a22b's (H 64, K 4, D 128, causal), and at MLA's
     padded heads with the explicit scale 1 / sqrt(dn + dr):
     deepseek-v2-lite-16b's (H = K = 16, 192 / 128 in D 256) and
     minicpm3-4b's (H = K = 40, 96 / 64 in D 128), at seamless-m4t-medium's
     decoder self-attention (H = K = 16, D 64) and internvl2-26b's (H 48
     over K 8, D 128), at a tensor-parallel rank's yi-6b heads (H 16 over
     K 2) at S 2048 and at phase 25's serving prefill (S 64, bf16 and
     f32), then the backward
     kernels on the forward kernel's own outputs against the plain chain,
     and two dq calls and two dkv calls bitwise equal; max errors against
     the stated tolerance, and the kernel's (CUDA events over 5 calls, and
     its kernels' device time from ``torch.profiler`` over 20), the plain
     version's and a library call's time (SDPA at MLA's unpadded dims) at
     the yi-6b, recurrentgemma-2b, gemma3-4b (local), qwen3, the two
     MLA, the seamless and the internvl2 shapes; every bound of phases 3,
     3b and 3c is its kernel's work function (beside its wrapper in
     ``kernels/``, ``analysis/cost.WORK``) at the case's shape, the one a
     dry run counts the kernel by;
  3b. the same for the SSD kernels: at the mamba2-2.7b main-path shape
     (B 2, S 2048, H 80, P 64, N 128, chunk 256, bf16 x/B/C with B and C
     broadcast over heads, f32 dA), f32 reduced and ragged cases and bf16
     ragged and reduced-width cases, then the backward kernel on the
     forward-with-residuals kernel's own chunk states against the plain
     chain, two calls of each kernel bitwise equal, and the chunk-parallel
     kernels of the two forwards (three each) and of the backward (four)
     timed apart (``torch.profiler``);
  3c. the same for the RG-LRU kernels: at the recurrentgemma-2b main-path
     shape (B 2, S 2048, W 2560, f32), a ragged one (S 600, W 64), S and W
     off the (128-step, 32-channel) tile, and a grid of tiles far larger
     than the card holds at once (B 64, S 8192: the chained scan's forward
     progress), then the backward kernel on the forward kernel's own
     output, and two calls of each kernel bitwise equal;
  11. (run right after 3c) the dense-cache serving path of every
     registered arch at its reduced config, f32, the kernels on: prefill
     plus one decode step against the train forward's logits at the
     reference's tolerance, on the card and on the CPU, card against CPU,
     and the prefill's launches those of a forward (seamless-reduced's
     batch holds encoder frames, internvl2-reduced's frontend embeddings);
  12. (run next) ``ServeEngine`` at published widths and full depth on
     yi-6b, gemma3-4b and deepseek-v2-lite-16b (all 64 experts), bf16:
     4 slots, 16-token pages, 2048 context, buckets to 1024, a staggered
     trace of 4 greedy requests, each also run alone: every request
     completes, co-batched equals solo token for token, ``engine.step()``
     under ``torch.cuda.set_sync_debug_mode("error")``, one flash forward
     a prefill and attention layer; prefill ms per bucket, decode step ms
     at 1 and 4 active slots beside its bytes bound, tokens/s, the paged
     cache bytes and the peak allocation;
  4. card against CPU: yi-6b-reduced, mamba2-reduced,
     recurrentgemma-reduced, gemma3-reduced, deepseek-67b-reduced,
     qwen3-moe-reduced, deepseek-v2-lite-reduced, minicpm3-reduced,
     seamless-reduced and internvl2-reduced in
     f32 with the kernels, 4 temporal SPB steps from
     the same seeded weights as on the CPU plain path, with the card run's
     launch counts checked against the steps' depths;
  5. each path at full width: SPBEngine on yi-6b cut to 8 layers, on
     mamba2-2.7b cut to 32, on recurrentgemma-2b cut to 12, on gemma3-4b
     cut to 12, on qwen3-moe-235b-a22b cut to 4 layers of 8 held experts
     (rank 0 of a 16-way expert-parallel layer), on deepseek-v2-lite-16b
     cut to 4 (the dense layer 0 and 3 MoE layers of all 64 experts), on
     minicpm3-4b cut to 24, on seamless-m4t-medium whole (12 encoder and
     12 decoder layers over 2048 frames) and on internvl2-26b cut to 4
     (1024 patch embeddings and 1024 text tokens), bf16, temporal
     k=4, batch 2 x 2048, 8 steps, with the launch counts of every kernel
     checked against the step's depth (an encoder layer and a
     cross-attention launch none; the counts are zeroed before each
     path and read after it), each step's peak allocation leaving at least
     ``HEADROOM_GB`` of the card;
  6. temporal-mb at full width: yi-6b, mamba2-2.7b and
     recurrentgemma-2b, batch 8 x 2048 (four microbatches of phase 5's
     shape, one at each depth of the k=4 cycle, then one optimizer
     step), 3 steps, each step's launches checked
     against its cycle, its time on the host clock and by CUDA events
     beside the sum of one cycle of phase 5's temporal steps; the engine's
     policy sets ``needs_step_time`` and must observe no less than the
     card's time;
  7. card against CPU with gradient compression: the three reduced
     configs, 4 temporal-mb steps with topk and 4 temporal steps with
     lowrank, losses within 1e-3; randk's structure on the card;
  8. the driver's restart loop on the card: yi-6b-reduced with the
     kernels, 8 steps straight and with a failure injected at step 5,
     exactly one FAILURE line and the same last xent to 1e-5;
  9. a JigSaw session at full width: ``LiveBackend`` on the card with a
     yi-6b job (8 layers) and a mamba2-2.7b job (32), two workers each
     (depths 4 and 8, 16 and 32), 3 iterations on 2 machine slots under
     ``JigsawScheduler``, batch 2 x 2048: both jobs done, each task's
     launches checked against its depth (the counts are zeroed before the
     session and read after it), every measured task the interval the
     runtime scheduled, each warm depth's measured ms within 10% of a
     CUDA-event timing of one step at that depth, each worker's estimate
     the EMA of its warm measurements, finite xent; one line a task, the
     host time outside the steps and each job's peak memory;
  10. a fault session on the card: yi-6b-reduced and mamba2-reduced with
     the kernels under one machine crash and one transient task failure,
     checkpointed every iteration: both jobs done, a restore, exactly one
     retry; then a ``KernelError`` raised inside one attempt leaves
     ``ClusterRuntime.run()`` with no retry counted;
  14. horizontal fusion (run after phase 10): ``FusedEngine`` of two
     tenants of yi-6b (cut to 4 layers), mamba2-2.7b (16) and
     recurrentgemma-2b (6) at published widths, batch 2 x 2048 each,
     temporal k=4, 8 steps (two cycles), beside two solo ``SPBEngine``s
     with the same seeds and batches: each tenant's loss and grad_norm
     within 1e-3 relative of its solo engine at every step of the first
     cycle (the second's deviations printed) and finite, each fused
     step's launches those of one solo step at its depth (all nine
     kernels, each once a layer, at J x B rows), the first step's
     forward kernels at J x B = 4 rows (read at the wrappers), the
     stacked group's peak leaving ``HEADROOM_GB``; the fused step's ms
     beside the sum of the two solo steps', per depth, over the warm
     second cycle.  Then a JigSaw session with ``LiveBackend(fuse=True)``:
     two identical yi-6b tenants (one fused group) and a mamba2-2.7b
     tenant at the same cuts, two workers, 2 iterations: both scheduled
     jobs done, the group's ``fused_with``, every member's 4 steps and a
     finite last xent, each task's launches one solo step's;
  16. (run after 14) CUDA-graph step tables (``engine/graphs.py``,
     ``engine/aot.py``): (a) yi-6b's ``ServeEngine`` at published widths
     and full depth (phase 12's geometry and prompts), eager and then
     with ``compile_table()`` in the same call: greedy outputs equal
     token for token, the same launches, decode ms at 1 and 4 active
     slots, host enqueue and device busy ms, kernels a step and prefill
     ms per bucket, both ways; (b) yi-6b at phase 5's cut, temporal k=4
     at depths 2, 4, 6 and 8, batch 2 x 2048, eager and graphed from the
     same seeded state and batches over 8 steps whose learning rate
     changes every step: loss, grad_norm, lr and every parameter
     bit-equal, each replay's launches an eager step's at its depth,
     warm step ms both ways, each entry's pool bytes beside the peak
     allocation; (c) the table stored, then loaded by a fresh process
     with ``nvcc`` out of reach and every build refused: its libraries
     come from the table and its first step's loss equals (b)'s; (d)
     ``launch/train.py --compilation-cache-dir`` twice: a miss, then a
     hit; (e) a step that reads a device value on the host cannot be
     captured: ``compile_table`` raises and the eager entry stays;
  17. (run after 16) the layer recompute (``remat``; ``models/lm.py``):
     yi-6b at phase 5's cut, batch 2 x 2048, from one seed over the same
     batches at depths 2 (three steps) and 8 (three), under 'none',
     'dots' and 'full'; mamba2-2.7b at 8 then 32 (three), recurrentgemma-2b
     at 3 then 12 and seamless-m4t-medium at 6 then 24, under 'none' and
     'full': every step's launches exactly ``expected_launches(...,
     remat=)`` (a live layer's forward kernel twice), warm step ms and
     ``max_memory_allocated`` by depth, losses, grad norms and updated
     parameters bit-equal to 'none''s (a leaf that differs is named and
     held within ``TOL``); then yi-6b's step table captured under 'full'
     and under 'none' at depths 2 and 8: each replay bit-equal to the
     eager run of its policy, the pools' GB; with phase 15 the dry run of
     each of these configs, depths and policies (counted TFLOP, saved GB,
     predicted peak beside the measured one; FLOPs must rise and saved
     bytes fall from 'none' to 'dots' to 'full');
  18. (run after 17) the data-parallel group and spatial SPB
     (``launch/mesh.py``), every rank a process of its own
     (``mesh.spawn``, start method spawn, a join timeout), the ranks
     sharing the card over gloo: (a) four ranks of yi-6b-reduced, f32,
     the kernels on, 2 steps each of spatial k 4, spatial k 2 with and
     without the subgroup re-reduce, and temporal k 2, on the card and
     then on the CPU over the same process group: every rank's
     parameters bit-identical to rank 0's, losses card against CPU
     within phase 4's 1e-3 relative, and, since 2 warm-up steps move
     the loss and the weights too little for that to see a wrong
     gradient, each step's grad norm and AdamW's first moment card
     against CPU within 1e-4 relative and the parameters' change within
     1e-3, each card step's launches ``expected_launches`` at the rank's
     depth; (b) two ranks
     of yi-6b at published widths cut to 2 layers (one row of 2048
     each), bf16, k 2, in temporal (a cycle), spatial and spatial with
     the re-reduce, one state carried through: the replicas bit-identical
     after each mode, every step's launches exact, a line a rank and
     mode with step ms, host ms inside the collectives and the peak
     allocation; (c) one counted step a depth (``analysis/cost.CostMode``)
     whose all-reduce calls and payload equal ``dp_reckoning`` exactly
     and whose wire bytes are the ring model's;
  19. (run after 18) ZeRO-1 over the data group and restart under a
     group (``SPBEngine(zero1=)``, ``dist/sharding.py``): (a) two ranks
     of yi-6b-reduced, f32, the kernels on, temporal and spatial k 2 for
     2 steps, replicated and with ZeRO-1, on the card and then on the CPU:
     ZeRO-1's parameters and gathered moments bit-identical to the
     replicated group's and across ranks, ZeRO-1 card against CPU within
     phase 18's limits, launches exact; (b) two ranks of phase 18's
     2-layer cut, temporal k 2 for 2 steps, replicated then ZeRO-1 from
     one seed: bit-identical across ranks and runs, launches exact, the
     last step's all-reduces and all-gathers counted exactly as
     ``dp_reckoning`` and ``dp_gather_reckoning`` with the ring model's
     wire bytes, ZeRO-1's peak under the replicated one by at least 0.87
     of the state's reckoned fall (6 B a parameter), a
     line a rank and run with step ms, host ms inside the collectives and
     the peak beside the dry run's count; (c) four ranks of that cut with
     ZeRO-1 (batch 4 x 2048, 2 steps), the same checks; (d)
     ``launch/train.py --data-parallel 2`` with a checkpoint every 2
     steps, straight and with ``--fail-at 3``: the xent bit for bit, and
     the last checkpoint restored into a one-process engine;
  20. (run after 19) pipelines (``dist/pipeline``: ``SPBEngine(
     parallelism="pipeline")``, one stage a rank, ``mesh.spawn(grid=)``),
     two stage ranks sharing the card over gloo: (a) yi-6b at published
     widths cut to 8 layers over 2 stages, bf16, 1F1B over 4 microbatches
     of one row of 2048, temporal k 4 (bwd_stages 2, 1, 2, 1) for one
     cycle: every step's launches on each rank exact (a frozen stage
     launches its forward kernels alone, a live one its forward twice and
     the backward kernels), finite losses, the first xent within 1e-3 of
     one process's forward on the card, the bytes a rank sends a step
     exact (activations, cotangents, the tied table); a line a rank and
     bwd_stages with step ms, host ms inside the messages and the
     collectives, the measured bubble beside the table's, the peak beside
     the dry run's count; (b) reduced yi-6b and mamba2-2.7b (f32, the
     kernels) for one cycle: xent within 1e-3 of one process on the CPU,
     launches exact (no SSD backward on a frozen stage);
  21. (run after 20) tensor parallelism inside the stages on (stage 2,
     data 1, model 2) and (2, 2, 2) grids, yi-6b cut to 2 layers
     (``phase_tensor_parallel``);
  22. (run after 21) expert parallelism (``models/moe.moe_fwd_ep``) on
     ``(data, model)`` grids of ranks sharing the card over gloo
     (``mesh.spawn(grid=(D, T))``,
     ``SPBEngine(group=<GridGroup>)``): (a) reduced deepseek-v2-lite-16b
     with ``impl="ep"``, f32, on (1, 2) and (2, 2), two steps at capacity
     1.25 and 8, each grid also on the CPU: the losses card against CPU
     (1e-3), the xent at capacity 8 against one dense process (1e-5),
     the replicas' non-expert leaves bit-identical, the small path (4
     tokens) against the CPU, calls, bytes and launches exact; (b)
     deepseek-v2-lite-16b at published widths cut to 3 layers (the dense
     layer 0 and 2 MoE layers, 32 of 64 experts a rank), bf16, on (1, 2),
     batch 2 x 2048, one k 4 cycle: a line a rank and depth with the
     step ms (a depth's step in the cycle's second half, else its one),
     the model group's host ms, calls and bytes by kind
     (held exact against ``roofline.ep_calls``), each MoE layer's share
     of slots dropped at capacity, launches and the peak beside the
     reckoning;
  23. (run after 22) the training step's last knobs: (a) ``FusedEngine``
     of two yi-6b tenants at phase 14's cut under 'none', 'dots' and
     'full' from the same seeds: launches exact under each policy,
     'dots' and 'full' held to 'none' bit for bit or within ``TOL``, warm
     ms and peak by depth (``phase_fused_dots``); (b) compression under
     ZeRO-2 on a (2, 2, 1) pipeline: reduced yi-6b under topk, randk and
     lowrank against the CPU grid and one compressed process, then
     yi-6b's 2-layer cut under topk; (c) compression on (1, 2) and (2, 2)
     ``(data, model)`` grids: reduced deepseek under topk and randk
     against the CPU grid, then phase 22's cut under topk on (1, 2); each
     full-width step's ms split into the gather, the compressor and the
     rest, its gathered bytes beside a world-wide gather's, and the peak
     (``phase_compressed_grids``);
  24. (run after 23) spatial co-location on the card
     (``launch/mesh.make_submeshes(count=2)``: two disjoint partitions of
     its SMs, each a green context with a stream of its own,
     ``device.CardShare``): (a) the units (the driver's smallest SM
     partition) and SMs of each submesh; a port kernel (the RG-LRU scan)
     and a bf16 product on each share read and write the primary
     context's memory (the scan bit-equal to the whole card's); one bf16
     8192^3 product's ms on the whole card and on each share (at least
     0.7 of card SMs / share SMs times slower, or the partition is not
     real); ten products on each share at once overlap and each runs at
     its alone speed (disjoint SMs); torch's own green contexts of as many
     SMs, at once, for comparison; (b) the reference's resize script at
     published widths: yi-6b at phase 14's cut, batch 2 x 2048, temporal
     k 2, one engine moved to submesh 1 at step 2 and back at step 4, one
     staying on submesh 0, the same seed and batches: each loss within
     1e-3 relative, bit-equality printed, launches exact a step, 2
     resizes; (c) a JigSaw session of phase 14's yi-6b and mamba2-2.7b
     tenants (two workers, 3 iterations) on the two submeshes
     (``LiveBackend(submeshes=)``, concurrent rounds): both done with a
     finite xent, ``max_concurrent_tasks`` 2, the resizes equal to the
     moves seen and to the engines' own counts, the session's launches
     the sum of its tasks' at their depths; each task's measured ms
     beside its depth's warm ms alone on the whole card and on the half
     share, the session's wall time beside the same session
     time-multiplexed on the whole card, and the card's peak
     (``phase_spatial``);
  25. (run after 24) sharded serving (``ServeEngine(group=)``) on a
     (data 1, model 2) grid of two ranks that share the card over gloo
     (``launch/mesh.spawn(grid=(1, 2))``): yi-6b at published widths and
     full depth, bf16, the kernels on, each rank drawing phase 12's seed-0
     params leaf by leaf and keeping its share; 4 slots of 16-token pages,
     2048 context, four greedy prompts in the 64 bucket, 16 new tokens,
     each alone, then staggered: every request completes, staggered equals
     solo, the two ranks' outputs and prefill logits are bit-identical,
     the prefill logits of the same widths at ``SHARD_F32_LAYERS`` layers
     in f32 within ``PIPE_TOL`` (relative L2) of one process's and the
     bf16 ones within twice one process's own bf16-vs-f32 spread at full
     depth, the first token one process's wherever its top-2
     margin exceeds ``PIPE_TOL``, reduced yi-6b in f32 on the grid one
     process's tokens token for token, each step's model-group calls and
     bytes ``roofline.serve_tp_calls``, the flash forward once a prefill
     and attention layer at the local H 16 over K 2, the rank's pool half
     the one-process pool and its params the reckoning; prefill ms, the
     decode step's ms and host ms in the model group by slots live, params
     held, pool bytes and peak, beside the card's name and power limit
     (``phase_sharded_serve``; the one-process references run while the
     ranks start and draw their weights, and the ranks wait for them to
     end before the timed trace, so the card runs only the two ranks
     there); then, yi-6b freed, the same ranks decode gemma3-4b at
     published widths and full depth (34 layers), bf16, seed-0 params
     drawn leaf by leaf, 4 tokens from position 524,284 of a long_500k
     cache filled from a seed, under the reference's small-batch
     override ``{"batch": None, "kv_seq": ("data", "model")}``
     (``shard_decode_step``: the batch on both ranks, the cache's
     sequence halved, the attention whole, one combine gather a layer):
     the ranks bit-identical, the logits at ``LONG_F32_LAYERS`` layers in
     f32 within ``PIPE_TOL`` of one process's and the bf16 ones within
     twice one process's bf16-vs-f32 spread, one gather a layer a step,
     params and cache k/v bytes the reckoning's; decode step ms and the
     seq and model groups' gloo ms a step (``[sharded-serve-long]``
     lines; the one-process references, f32 at full depth freed before
     bf16, run with yi-6b's while the ranks start);
  15. (run last, after 25, on the host) the dry run of each phase-5 path:
     every depth of its cycle counted on the meta device at batch
     2 x 2048 with the kernels' meta entries (``launch/dryrun.py``):
     counted TFLOP and GB, the three H100 roofline terms
     (``analysis/roofline.py``), MFU against phase 5's warm steps, the
     predicted peak (state + temporaries) beside ``max_memory_allocated``;
     fails when a compute term exceeds a measured step, when counted
     FLOPs or bytes do not fall strictly with depth, when a kernel's
     counted work differs from its phase 3/3b/3c bound's at the same
     shape, or when a kernel was launched (the records go to a temporary
     directory); then the JigSaw cost model's profile of yi-6b's cut from
     those records, its forward:backward split fitted over the cycle's
     depths (no resnet50 fallback, no assumed split), beside the measured
     steps; last, one rank of each production mesh (``phase_pod_dryrun``,
     ``[pod-dryrun]`` lines): gemma3-4b long_500k on the 16 x 16 pod and
     the (2, 16, 16) mesh, its bytes and collectives the reckoning's, and
     yi-6b decode_32k on the pod an error record;
  13. a ``{"kernels": [...]}`` line (launches by path, among them
     ``launches_decode``, ``launches_serve``, ``launches_fused`` and
     ``launches_fused_jigsaw``, ``launches_graphs`` (phase 16's graph
     replays), ``launches_remat`` (phase 17's runs, by arch and policy),
     ``launches_data_parallel`` (phase 18's, by run and rank),
     ``launches_zero`` (phase 19's), ``launches_pipeline`` (phase 20's,
     by run and stage), ``launches_tensor_parallel`` and
     ``launches_expert_parallel`` (phases 21's and 22's, by run and rank),
     ``launches_fused_dots`` (phase 23 (a)'s 'dots' run) and
     ``launches_compressed`` (phase 23 (b) and (c)'s, by run and rank),
     ``launches_spatial`` (phase 24 (b)'s and (c)'s),
     ``launches_sharded_serve`` (phase 25's, by rank),
     the fused phase's ms by depth and peak, phase 17's and phase 18's
     figures,
     and phase 15's ``dryrun_by_arch`` and ``pod_dryrun``), the card's
     name and power
     limit, and last the
     ``{"ok": true, ...}`` line.

Needs a CUDA card: without one it exits 1 and prints no result.
"""
from __future__ import annotations

import dataclasses
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

# (atol, rtol) by the kernel output's dtype: a bf16 output against the f32
# plain version is off by bf16 rounding (2^-8 relative) plus the f32 sums'
# order; an f32 output (lse, delta, every output of f32 inputs) is f32 math
# summed in another order.
TOL = {"bfloat16": (5e-3, 2e-2), "float32": (1e-4, 1e-4)}
MAIN = dict(B=2, Sq=2048, Sk=2048, H=32, K=4, D=128, causal=True, window=0,
            dtype="bfloat16")
# recurrentgemma-2b's local attention: MQA, head_dim 256, window 2048
# (which masks nothing more than causality at S 2048)
RG_MAIN = dict(B=2, Sq=2048, Sk=2048, H=10, K=1, D=256, causal=True,
               window=2048, dtype="bfloat16")
# gemma3-4b's local attention: GQA 8 over 4 (G 2), head_dim 256, window
# 1024, which skips whole kv tiles at S 2048; its global layer is the same
# without the window
G3_MAIN = dict(B=2, Sq=2048, Sk=2048, H=8, K=4, D=256, causal=True,
               window=1024, dtype="bfloat16")
# qwen3-moe-235b-a22b's attention: 64 q heads over 4 kv heads (G 16)
Q3_MAIN = dict(MAIN, H=64)
# MLA's attention on the kernels (models/layers._mla_attention): heads of
# qk dim dn + dr and v dim dv zero-padded to one dispatched D, scaled by
# 1 / sqrt(dn + dr): deepseek-v2-lite-16b's 192 / 128 in D 256 (16 heads)
# and minicpm3-4b's 96 / 64 in D 128 (40 heads)
DS2_MAIN = dict(MAIN, H=16, K=16, D=256, mla=(192, 128))
MC3_MAIN = dict(MAIN, H=40, K=40, D=128, mla=(96, 64))
# the decoder self-attention of the encoder-decoder and frontend archs:
# seamless-m4t-medium's MHA at head_dim 64, internvl2-26b's 48 q heads over
# 8 kv heads (G 6) over 1024 patch and 1024 text positions
SM4T_MAIN = dict(MAIN, H=16, K=16, D=64)
IV2_MAIN = dict(MAIN, H=48, K=8)
# yi-6b's attention on a tensor-parallel stage of 2 model ranks (phase
# 21): the local heads, 16 q over 2 kv (G 8), one row of 2048
TP_MAIN = dict(MAIN, B=1, H=16, K=2)
# the same heads at phase 25's serving prefill: one right-padded prompt of
# the 64 bucket, causal, in bf16 (the wgmma kernel) and in f32 (the simple
# kernel, phase 25's f32 check), held against the plain version here
SERVE_TP = dict(TP_MAIN, Sq=64, Sk=64)
CASES = {
    "main": MAIN,
    "window": dict(B=1, Sq=1024, Sk=1024, H=8, K=2, D=64, causal=True,
                   window=256, dtype="float32"),
    "ragged": dict(B=1, Sq=100, Sk=200, H=4, K=2, D=32, causal=False,
                   window=0, dtype="float32"),
    "rg_main": RG_MAIN,
    "rg_window": dict(RG_MAIN, B=1, Sq=4096, Sk=4096),
    "g3_main": G3_MAIN,
    "g3_global": dict(G3_MAIN, window=0),
    "q3_main": Q3_MAIN,
    "ds2_mla": DS2_MAIN,
    "mc3_mla": MC3_MAIN,
    "sm4t_main": SM4T_MAIN,
    "iv2_main": IV2_MAIN,
    "tp_main": TP_MAIN,
    "serve_tp": SERVE_TP,
    "serve_tp_f32": dict(SERVE_TP, dtype="float32"),
}
TIMED = {"main": "yi-6b", "rg_main": "recurrentgemma-2b",   # case: arch
         "g3_main": "gemma3-4b", "q3_main": "qwen3-moe-235b-a22b",
         "ds2_mla": "deepseek-v2-lite-16b", "mc3_mla": "minicpm3-4b",
         "sm4t_main": "seamless-m4t-medium", "iv2_main": "internvl2-26b",
         "tp_main": "yi-6b/tp2"}
# SSD cases: (B, S, H, P, N, chunk, dtype of x/B/C, B/C broadcast over
# heads); dA is f32 -U(0.05, 2.0) as in tests/test_kernel_grads.py.  Every
# SSD and RG-LRU output is f32, held at that suite's measure:
# max|got - want| / max(max|want|, 1) <= 1e-5.
SCAN_TOL = 1e-5
SSD_MAIN = dict(B=2, S=2048, H=80, P=64, N=128, chunk=256, dtype="bfloat16",
                grouped=True)
SSD_CASES = {
    "main": SSD_MAIN,
    "reduced": dict(B=2, S=256, H=8, P=16, N=16, chunk=32, dtype="float32",
                    grouped=False),
    "ragged": dict(B=1, S=600, H=4, P=64, N=128, chunk=256, dtype="float32",
                   grouped=True),
    "short": dict(B=2, S=100, H=4, P=16, N=16, chunk=256, dtype="float32",
                  grouped=False),
    "bf16_ragged": dict(B=1, S=600, H=4, P=64, N=128, chunk=256,
                        dtype="bfloat16", grouped=True),
    "bf16_reduced": dict(B=2, S=100, H=8, P=16, N=16, chunk=32,
                         dtype="bfloat16", grouped=False),
}
# RG-LRU cases (B, S, W); a ~ U(0.1, 0.999), b ~ N(0, 1) as in
# tests/test_kernel_grads.py.  The kernels' tile is 128 steps by 32
# channels: "off_tile" and "short" miss it in S and W, and "many_tiles"
# hands out 65536 tiles, far more than the card holds at once.
RGLRU_CASES = {
    "main": dict(B=2, S=2048, W=2560),
    "ragged": dict(B=2, S=600, W=64),
    "off_tile": dict(B=3, S=1000, W=100),
    "short": dict(B=1, S=17, W=130),
    "many_tiles": dict(B=64, S=8192, W=512),
}
# phases 6-10 run these; phase 4 also the seven below, phase 5 also the
# six of them with a full-width cut (deepseek-67b has none)
ARCHS = ("yi-6b", "mamba2-2.7b", "recurrentgemma-2b")
CARD_VS_CPU_ARCHS = ARCHS + ("gemma3-4b", "deepseek-67b",
                             "qwen3-moe-235b-a22b", "deepseek-v2-lite-16b",
                             "minicpm3-4b", "seamless-m4t-medium",
                             "internvl2-26b")
FULL_WIDTH_ARCHS = ARCHS + ("gemma3-4b", "qwen3-moe-235b-a22b",
                            "deepseek-v2-lite-16b", "minicpm3-4b",
                            "seamless-m4t-medium", "internvl2-26b")
# phase 12 serves these at published widths and full depth (the reference's
# acceptance archs: dense GQA, local + global windows, MLA with MoE)
SERVE_ARCHS = ("yi-6b", "gemma3-4b", "deepseek-v2-lite-16b")
# the reference's prefill + decode tolerance (tests/test_decode_consistency.py)
DECODE_TOL = 2e-4
# the least room (GB) a full-width step's peak allocation must leave on the
# card (phases 5 and 9)
HEADROOM_GB = 8.0
KERNELS = {     # name: (source, TPU kernel it replaces)
    "flash_fwd": ("src/repro_torch/csrc/flash_fwd.cu",
                  "src/repro/kernels/flash_attention.py:58"),
    "flash_delta": ("src/repro_torch/csrc/flash_delta.cu",
                    "src/repro/kernels/flash_attention_bwd.py:71"),
    "flash_dq": ("src/repro_torch/csrc/flash_dq.cu",
                 "src/repro/kernels/flash_attention_bwd.py:99"),
    "flash_dkv": ("src/repro_torch/csrc/flash_dkv.cu",
                  "src/repro/kernels/flash_attention_bwd.py:140"),
    "ssd_fwd": ("src/repro_torch/csrc/ssd_fwd.cu",
                "src/repro/kernels/ssd.py:21"),
    "ssd_fwd_res": ("src/repro_torch/csrc/ssd_fwd.cu",
                    "src/repro/kernels/ssd_bwd.py:48"),
    "ssd_bwd": ("src/repro_torch/csrc/ssd_bwd.cu",
                "src/repro/kernels/ssd_bwd.py:129"),
    "rglru_fwd": ("src/repro_torch/csrc/rglru.cu",
                  "src/repro/kernels/rglru.py:24"),
    "rglru_bwd": ("src/repro_torch/csrc/rglru.cu",
                  "src/repro/kernels/rglru_bwd.py:27"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


# each phase's wall seconds, in the order run (the whole script must end
# well inside its 1200 s limit on a card that may run below 700 W)
PHASE_S: dict = {}
_T_START = time.perf_counter()


def clocked(name: str, fn, *args, **kw):
    """``fn(*args, **kw)``, its wall seconds logged and kept in
    :data:`PHASE_S` under ``name``."""
    t0 = time.perf_counter()
    try:
        return fn(*args, **kw)
    finally:
        PHASE_S[name] = round(time.perf_counter() - t0, 1)
        log(f"[clock] {name} {PHASE_S[name]:.1f}s "
            f"({time.perf_counter() - _T_START:.1f}s since start)")


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(flops: float, nbytes: float, dtype: str):
    """(least ms, what bounds it) at the H100's peaks
    (``analysis/roofline.py``)."""
    from repro_torch.analysis.roofline import HBM_BW, PEAK_FLOPS_BY_DTYPE
    t_ops, t_bytes = flops / PEAK_FLOPS_BY_DTYPE[dtype], nbytes / HBM_BW
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def set_bound(record: dict, name: str, shape: dict, dtype: str) -> None:
    """A kernel's bound at ``shape`` from its work function
    (``analysis/cost.WORK``, the one a dry run counts it by); the record
    keeps the work as ``work`` = [shape key, flops, bytes]."""
    from repro_torch.analysis import cost
    flops, nb = cost.WORK[name](**shape)
    record["work"] = [cost.shape_key(shape), flops, nb]
    record["bound_ms"], record["bound_by"] = bound(flops, nb, dtype)


def check_close(name: str, got, want):
    """(max abs error, max abs error over max |want|, tolerance, largest
    share of the allowed error used); raises when
    |got - want| > atol + rtol * |want| with the tolerance of got's dtype."""
    import torch
    atol, rtol = tol = TOL[str(got.dtype).removeprefix("torch.")]
    got, want = got.float(), want.float()
    err = (got - want).abs()
    allowed = atol + rtol * want.abs()
    bad = err > allowed
    max_abs = float(err.max())
    rel = max_abs / max(float(want.abs().max()), 1e-30)
    if not torch.isfinite(got).all() or bool(bad.any()):
        raise AssertionError(f"{name}: max_abs_err={max_abs:.3e} exceeds "
                             f"atol {atol} + rtol {rtol} * |want| "
                             f"({int(bad.sum())} elements)")
    return max_abs, rel, tol, float((err / allowed).max())


def check_all(name: str, got, want) -> float:
    """check_close over matching outputs; logs one line, returns the max
    abs error."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    errs = [check_close(name, g, w) for g, w in zip(got, want, strict=True)]
    max_abs = max(e[0] for e in errs)
    tols = " ".join(f"{a}+{r}*|want|" for a, r in dict.fromkeys(
        e[2] for e in errs))
    each = ",".join(f"{e[0]:.3e}" for e in errs)
    log(f"[kernels] {name:24s} max_abs_err={max_abs:.3e} "
        f"max_rel_err={max(e[1] for e in errs):.3e} per_output=[{each}] "
        f"tol={tols} used={max(e[3] for e in errs):.3f} of it, ok")
    return max_abs


def _kernel_label(mangled: str) -> str:
    """``fwd_wgmma_kernel<128>`` from a mangled ``flash::``, ``ssd::`` or
    ``rglru::`` kernel name."""
    m = re.match(r"_ZN(?:5flash|3ssd|5rglru)(\d+)", mangled)
    if not m:
        return mangled
    name = mangled[m.end():m.end() + int(m.group(1))]
    rest = mangled[m.end() + int(m.group(1)):]
    args = re.match(r"I((?:f|13__nv_bfloat16|Li\d+E)+)E", rest)
    if not args:
        return name
    label = ["float" if f else "bf16" if bf else d for f, bf, d in
             re.findall(r"(f)|(13__nv_bfloat16)|Li(\d+)E", args.group(1))]
    return f"{name}<{','.join(label)}>"


TENSOR_CORE_LIBS = ("flash_fwd", "flash_dq", "flash_dkv", "ssd_fwd",
                    "ssd_bwd")


def log_resources(lib: str) -> None:
    """Each kernel's registers and spills from the library's build log."""
    from repro_torch.kernels import _build
    fn = None
    for line in _build.build_log(lib).splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(_Z\w+)", line)
        if m:
            fn, spills = _kernel_label(m.group(1)), ""
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                      r"loads", line)
        if m and fn:
            spills = f"spill stores {m.group(1)} B, loads {m.group(2)} B"
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            log(f"[build] {lib:9s} {fn:30s} {m.group(1)} registers, "
                f"{spills}")


def phase_tensor_cores() -> dict:
    """Phase 2's report: every kernel's registers and spills, and the
    number of tensor-core instructions in the SASS of each library whose
    bf16 kernels run on the tensor cores.  Raises when one of those has
    none.  Returns {library: {"HGMMA": n, "HMMA": n}}."""
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.kernels import _build

    def dump(lib: str) -> str:
        return subprocess.run(
            [_build.nvcc_tool("cuobjdump"), "-sass",
             str(_build.lib_path(lib))], check=True, capture_output=True,
            text=True).stdout

    with ThreadPoolExecutor(len(TENSOR_CORE_LIBS)) as pool:   # one a library
        dumps = dict(zip(TENSOR_CORE_LIBS, pool.map(dump, TENSOR_CORE_LIBS)))
    counts = {}
    log_resources("rglru")
    log_resources("flash_delta")
    for lib in TENSOR_CORE_LIBS:
        log_resources(lib)
        sass = dumps[lib]
        counts[lib] = {op: len(re.findall(rf"\b{op}\b", sass))
                       for op in ("HGMMA", "HMMA")}
        log(f"[build] {lib} tensor-core instructions in SASS: "
            f"{counts[lib]}")
        if not sum(counts[lib].values()):
            raise AssertionError(f"{lib}: no tensor-core instruction in "
                                 f"its SASS")
    return counts


def counters():
    """The kernel wrappers, each with its launch count in ``.launches``."""
    from repro_torch.engine.graphs import launch_counters
    return launch_counters()


def zero_launches() -> None:
    for fn in counters().values():
        fn.launches = 0


def launches_now() -> dict:
    return {n: fn.launches for n, fn in counters().items()}


def launches_since(before: dict) -> dict:
    return {n: c - before[n] for n, c in launches_now().items()}


def expected_launches(cfg, depths, remat: str = "none") -> dict:
    """Launches of ``len(depths)`` steps at these SPB depths, layer by
    layer: an attention layer runs the flash forward always and the delta,
    dq and dkv kernels when it is in the suffix; an SSD layer runs the
    primal scan in the frozen prefix and the forward-with-residuals plus
    the backward in the suffix; an RG-LRU layer runs the scan always and
    the backward scan when it is in the suffix; an MLA layer and an
    encoder-decoder's ``xdec`` decoder layer (its causal self-attention)
    as an attention layer.  An encoder layer and a cross-attention run the
    plain blockwise path and launch nothing, so only the decoder's layers
    count, live when the suffix (counted over the encoder and the decoder)
    reaches them.  Depth 0 is a forward alone (prefill).

    Under the layer recompute (``remat`` 'dots' or 'full', the eager and
    graphed steps) a live layer's forward runs twice, both times with
    grad on: its first pass under the checkpoint and its recompute in the
    backward each launch the forward kernel of the differentiable path
    (the flash forward with ``lse``, the SSD forward-with-residuals, the
    RG-LRU scan); the first pass's residuals are dropped.  A frozen layer
    runs once, as under 'none'."""
    from repro_torch.config import layer_kinds
    want = dict.fromkeys(counters(), 0)
    kinds = layer_kinds(cfg)
    twice = remat != "none"
    for d in depths:
        for i, (mixer, _) in enumerate(kinds):
            live = i >= len(kinds) - d
            if mixer == "ssd":
                fwd, bwd = (("ssd_fwd_res",), ("ssd_bwd",)) if live else \
                    (("ssd_fwd",), ())
            elif mixer == "rglru":
                fwd, bwd = ("rglru_fwd",), (("rglru_bwd",) if live else ())
            elif mixer in ("attn", "local", "mla", "xdec"):
                # MLA's attention runs the same kernels on padded heads
                fwd, bwd = ("flash_fwd",), (("flash_delta", "flash_dq",
                                             "flash_dkv") if live else ())
            else:
                raise ValueError(f"no kernels known for mixer {mixer!r}")
            for n in fwd * (2 if live and twice else 1) + bwd:
                want[n] += 1
    return want


def check_launches(phase: str, before: dict, depths, cfg,
                   remat: str = "none") -> dict:
    """The launches since ``before`` against :func:`expected_launches`.
    Returns them."""
    grew = launches_since(before)
    want = expected_launches(cfg, depths, remat)
    if grew != want:
        raise AssertionError(f"{phase}: launches {grew} != {want}")
    return grew


def sms() -> int:
    import torch
    return torch.cuda.get_device_properties(0).multi_processor_count


def dkv_by_split(bwd, kw, G: int) -> dict:
    """compute_dkv's time with its q heads split over each divisor of G,
    the planner (``dkv_head_splits``) replaced for the measurement."""
    from repro_torch.kernels import flash_attention_bwd as fab
    planner, out = fab.dkv_head_splits, {}
    try:
        for s in (d for d in range(1, G + 1) if G % d == 0):
            fab.dkv_head_splits = lambda *_, s=s: s
            out[s] = round(time_ms(lambda: fab.compute_dkv(*bwd, **kw),
                                   iters=5), 4)
    finally:
        fab.dkv_head_splits = planner
    return out


def phase_kernels():
    """Phase 3: every attention kernel against its plain version; timings
    at each main-path shape.  Returns {case: {name: record}} for the
    timed cases."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fab

    timed = {}
    for case, c in CASES.items():
        dt = getattr(torch, c["dtype"])
        gen = torch.Generator(device="cuda").manual_seed(1)
        B, Sq, Sk, H, K, D = (c[k] for k in ("B", "Sq", "Sk", "H", "K", "D"))
        mk = lambda *s: torch.randn(s, generator=gen, device="cuda").to(dt)
        # public (B, S, H, D) tensors, passed as kernel-layout views; an MLA
        # case draws q, k at dqk and v, dO at dv and zero-pads them to D,
        # with the scale 1 / sqrt(dqk), as the main path passes them
        dqk, dv = c.get("mla", (D, D))
        q0, k0, v0, do0 = mk(B, Sq, H, dqk), mk(B, Sk, K, dqk), \
            mk(B, Sk, K, dv), mk(B, Sq, H, dv)
        q, k, v, do = (F.pad(x, (0, D - x.shape[-1]))
                       for x in (q0, k0, v0, do0))
        qt, kt, vt, dot_ = (x.transpose(1, 2) for x in (q, k, v, do))
        kw = dict(causal=c["causal"], window=c["window"])
        if "mla" in c:
            kw["scale"] = dqk ** -0.5
        ot_p, lse_p = fa.fwd_plain(qt, kt, vt, with_lse=True, **kw)
        delta_p = fab.delta_plain(ot_p, dot_)

        bwd = (qt, kt, vt, dot_, lse_p, delta_p)
        runs = {    # name: (kernel wrapper, plain version), same inputs
            "flash_fwd": (
                lambda: fa.fwd_kernel_layout(qt, kt, vt, with_lse=True, **kw),
                lambda: fa.fwd_plain(qt, kt, vt, with_lse=True, **kw)),
            "flash_delta": (lambda: fab.compute_delta(ot_p, dot_),
                            lambda: fab.delta_plain(ot_p, dot_)),
            "flash_dq": (lambda: fab.compute_dq(*bwd, **kw),
                         lambda: fab.dq_plain(*bwd, **kw)),
            "flash_dkv": (lambda: fab.compute_dkv(*bwd, **kw),
                          lambda: fab.dkv_plain(*bwd, **kw)),
        }
        records = {}
        for name, (kern, plain) in runs.items():
            max_abs = check_all(f"{case} {name}", kern(), plain())
            if name in ("flash_dq", "flash_dkv"):   # one owner, no atomics
                first, again = kern(), kern()
                first = first if isinstance(first, tuple) else (first,)
                again = again if isinstance(again, tuple) else (again,)
                if not all(torch.equal(a, b) for a, b in zip(first, again)):
                    raise AssertionError(f"{case}: two {name} calls differ")
            if case in TIMED:
                records[name] = {"max_abs_err": max_abs,
                                 "ms": time_ms(kern, iters=5),
                                 "plain_ms": time_ms(plain, iters=3, warmup=1)}
        # the chain the main path runs: the backward kernels on the forward
        # kernel's own ot and lse, against the plain chain
        ot_k, lse_k = fa.fwd_kernel_layout(qt, kt, vt, with_lse=True, **kw)
        dq_k, dk_k, dv_k = fab.bwd_kernel_layout(qt, kt, vt, ot_k, lse_k,
                                                 dot_, **kw)
        check_all(f"{case} fwd->delta->dq,dkv", (dq_k, dk_k, dv_k),
                  (fab.dq_plain(*bwd, **kw), *fab.dkv_plain(*bwd, **kw)))

        if case not in TIMED:
            continue
        # each wrapper's kernels' device time, the four wrappers traced in
        # one profiler session (kernel fwd_* is flash_fwd's, dkv_* dkv's)
        by_kernel = kernel_device_ms(
            lambda: [kern() for kern, _ in runs.values()], "flash", iters=20)
        for name, (kern, _) in runs.items():
            mine = [ms for k, ms in by_kernel.items()
                    if k.split("_")[0] == name.removeprefix("flash_")]
            if CALL_MS in by_kernel:
                mine = [time_ms(kern, iters=20, warmup=1)]
            if not mine:
                raise AssertionError(f"{case}: the profiler saw no kernel "
                                     f"of {name}")
            records[name]["device_ms"] = round(sum(mine), 4)
        # bounds from this run's inputs (the kernels' work functions, the
        # ones a dry run counts): each input read once, each output
        # written once; operations over the pairs the mask lets in.  An
        # MLA case counts the unpadded work (q, k at dqk, v, o at dv): the
        # padding's cost shows in x_bound
        at = dict(B=B, H=H, K=K, Sq=Sq, Sk=Sk, dqk=dqk, dv=dv,
                  causal=c["causal"], window=c["window"],
                  itemsize=q0.element_size())
        shapes = {"flash_fwd": dict(at, with_lse=True),
                  "flash_delta": dict(B=B, H=H, Sq=Sq, dv=dv,
                                      itemsize=q0.element_size()),
                  "flash_dq": at, "flash_dkv": at}
        for name, sh in shapes.items():
            set_bound(records[name], name, sh, c["dtype"])
        # library yardsticks, never called by the port: SDPA forward (its
        # causal mask is the whole mask where the window masks nothing
        # more, else the kernels' own pair mask as a boolean attn_mask);
        # the row dot product of O and dO (rounded to bf16 at the end,
        # where the kernel keeps f32); SDPA's backward alone (dQ, dK and dV
        # in one call) for dq and dkv; SDPA forward + backward beside the
        # four kernels
        assert c["causal"]
        mask = (dict(is_causal=True) if c["window"] in (0, Sq) else
                dict(attn_mask=fa.pair_mask(Sq, Sk, True, c["window"],
                                            "cuda")))
        # SDPA at the unpadded head dims (its default scale 1 / sqrt(dqk))
        qs, ks, vs = (x.transpose(1, 2) for x in (q0, k0, v0))
        sdpa = lambda: F.scaled_dot_product_attention(
            qs, ks, vs, enable_gqa=True, **mask)
        records["flash_fwd"]["library_ms"] = time_ms(sdpa)
        records["flash_delta"]["library_ms"] = time_ms(
            lambda: torch.linalg.vecdot(ot_p[..., :dv], dot_[..., :dv]))
        qg, kg, vg = (x.detach().requires_grad_(True) for x in (qs, ks, vs))
        gs = do0.transpose(1, 2)
        out = F.scaled_dot_product_attention(qg, kg, vg, enable_gqa=True,
                                             **mask)
        sdpa_bwd = time_ms(lambda: torch.autograd.grad(
            out, (qg, kg, vg), gs, retain_graph=True))
        for name in ("flash_dq", "flash_dkv"):
            records[name]["library_ms"] = sdpa_bwd
        del out

        def sdpa_fwd_bwd():
            out = F.scaled_dot_product_attention(qg, kg, vg, enable_gqa=True,
                                                 **mask)
            torch.autograd.grad(out, (qg, kg, vg), gs)

        records["_sdpa_fwd_bwd_ms"] = time_ms(sdpa_fwd_bwd)
        records["_dkv_ms_by_split"] = dkv_by_split(bwd, kw, H // K)
        for name in runs:
            r = records[name]
            log(f"[kernels] {case:7s} {name:11s} ms={r['ms']:.4f} "
                f"device_ms={r['device_ms']:.4f} "
                f"plain_ms={r['plain_ms']:.4f} bound_ms={r['bound_ms']:.4f} "
                f"({r['bound_by']}) library_ms={r['library_ms']:.4f} "
                f"x_bound={r['ms'] / r['bound_ms']:.2f} "
                f"x_bound_device={r['device_ms'] / r['bound_ms']:.2f} "
                f"x_library={r['ms'] / r['library_ms']:.2f}")
        log(f"[kernels] {case:7s} SDPA fwd+bwd ms="
            f"{records['_sdpa_fwd_bwd_ms']:.4f}")
        log(f"[kernels] {case:7s} flash_dkv ms by head split "
            f"{records['_dkv_ms_by_split']} (the planner takes "
            f"{fab.dkv_head_splits(B, K, H // K, Sk, D, sms())})")
        timed[case] = records
    return timed


def ssd_inputs(c: dict):
    """Public-layout SSD operands on the card for one case: x (B,S,H,P),
    dA (B,S,H) f32, b and c (B,S,H,N) (head-stride-0 views when
    ``grouped``, as the main path passes them), dy, dstate."""
    import torch
    dt = getattr(torch, c["dtype"])
    gen = torch.Generator(device="cuda").manual_seed(2)
    B, S, H, P, N = (c[k] for k in ("B", "S", "H", "P", "N"))
    mk = lambda *s: torch.randn(s, generator=gen, device="cuda")
    x = mk(B, S, H, P).to(dt)
    dA = -(torch.rand((B, S, H), generator=gen, device="cuda") * 1.95 + 0.05)
    heads = 1 if c["grouped"] else H
    b_src, c_src = mk(B, S, heads, N).to(dt), mk(B, S, heads, N).to(dt)
    b, cm = b_src.expand(B, S, H, N), c_src.expand(B, S, H, N)
    return x, dA, b, cm, mk(B, S, H, P), mk(B, H, P, N)


def check_rel(name: str, got, want) -> float:
    """The SSD measure over matching f32 outputs; logs one line, returns
    the max abs error."""
    import torch
    errs = []
    for g, w in zip(got, want, strict=True):
        if g.dtype != torch.float32 or not torch.isfinite(g).all():
            raise AssertionError(f"{name}: expected finite float32 outputs")
        err = float((g - w).abs().max())
        errs.append((err, err / max(float(w.abs().max()), 1.0)))
    rel = max(e[1] for e in errs)
    log(f"[kernels] {name:24s} max_abs_err={max(e[0] for e in errs):.3e} "
        f"rel_err={rel:.3e} per_output=[{','.join(f'{e[1]:.2e}' for e in errs)}]"
        f" tol={SCAN_TOL} {'ok' if rel <= SCAN_TOL else 'FAIL'}")
    if not rel <= SCAN_TOL:
        raise AssertionError(f"{name}: rel_err {rel:.3e} > {SCAN_TOL}")
    return max(e[0] for e in errs)


PROFILER_TRIES = 3
CALL_MS = "call_by_cuda_events"  # kernel_device_ms without a trace


def cuda_trace(fn, iters: int, wanted, whole: bool = False):
    """The ``key_averages()`` events that ``wanted`` accepts from one
    ``torch.profiler`` trace of ``iters`` calls of ``fn``, or None.  CUPTI
    now and then hands back a trace without the call's kernels (once on an
    H100, in the SSD phase, after the flash phase's trace had worked in the
    same process), or with some of their launches lost (another run's SSD
    backward showed half its device time), so such a trace is logged and
    taken again, up to ``PROFILER_TRIES`` traces.  ``whole``: every call
    launches each kernel as often, so a count that ``iters`` does not
    divide is a trace with launches lost."""
    import torch
    for attempt in range(1, PROFILER_TRIES + 1):
        torch.cuda.synchronize()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [ev for ev in prof.key_averages() if wanted(ev)]
        lost = [ev.key for ev in events if whole and ev.count % iters]
        if events and not lost:
            return events
        log(f"[profiler] trace {attempt}/{PROFILER_TRIES} "
            + (f"lost launches of {lost}" if lost
               else "held none of the kernels looked for"))
    return None


def kernel_device_ms(kern, namespace: str = "ssd", iters: int = 5) -> dict:
    """The device ms of each CUDA kernel of ``namespace`` that one call of
    ``kern`` launches (the bf16 SSD path's chunk-parallel phases; an
    RG-LRU kernel without its scratch's zeroing; the attention kernels of
    the four flash wrappers, called in turn, without the wrappers' host
    work), averaged over ``iters`` calls traced with ``torch.profiler``.
    When no trace holds them all, the whole call's ms from CUDA events, under
    the one key ``CALL_MS`` (the wrappers' host work and any other kernel
    of the call included)."""
    kern()
    events = cuda_trace(kern, iters, lambda ev: ev.device_time_total > 0
                        and re.search(rf"{namespace}::\w+", ev.key),
                        whole=True)
    if events is None:
        ms = time_ms(kern, iters=iters, warmup=1)
        log(f"[profiler] no whole trace of the {namespace} kernels: the "
            f"call's ms from CUDA events instead, {ms:.4f}")
        return {CALL_MS: round(ms, 4)}
    return {re.search(rf"{namespace}::(\w+)", ev.key).group(1):
            round(ev.device_time_total / iters / 1e3, 4) for ev in events}


def phase_ssd_kernels():
    """Phase 3b: the SSD kernels against their plain versions; timings and
    bounds at the main-path shape.  Returns {name: record}."""
    import torch
    from repro_torch.kernels import ssd, ssd_bwd

    records = {}
    for case, c in SSD_CASES.items():
        x, dA, b, cm, dy, dstate = ssd_inputs(c)
        Q = c["chunk"]
        _, _, cs_p = ssd_bwd.fwd_res_plain(x, dA, b, cm, chunk=Q)
        bwd = (x, dA, b, cm, cs_p, dy, dstate)
        runs = {    # name: (kernel wrapper, plain version), same inputs
            "ssd_fwd": (
                lambda: ssd.ssd_fwd_kernel_layout(x, dA, b, cm, chunk=Q),
                lambda: ssd.ssd_fwd_plain(x, dA, b, cm, chunk=Q)),
            "ssd_fwd_res": (
                lambda: ssd_bwd.fwd_res_kernel_layout(x, dA, b, cm, chunk=Q),
                lambda: ssd_bwd.fwd_res_plain(x, dA, b, cm, chunk=Q)),
            "ssd_bwd": (
                lambda: ssd_bwd.bwd_kernel_layout(*bwd, chunk=Q),
                lambda: ssd_bwd.bwd_plain(*bwd, chunk=Q)),
        }
        for name, (kern, plain) in runs.items():
            max_abs = check_rel(f"{case} {name}", kern(), plain())
            if case == "main":
                records[name] = {"max_abs_err": max_abs,
                                 "ms": time_ms(kern, iters=5),
                                 "plain_ms": time_ms(plain, iters=3, warmup=1),
                                 "library_ms": None}
        # one owner per output, fixed-order sums: two calls agree
        for name, (kern, _) in runs.items():
            first, again = kern(), kern()
            if not all(torch.equal(a, b) for a, b in zip(first, again)):
                raise AssertionError(f"{case}: two {name} calls differ")
        log(f"[kernels] {case:24s} two calls of each of {list(runs)} "
            f"bitwise equal")
        if case == "main":
            for name, (kern, _) in runs.items():
                records[f"_{name}_phase_ms"] = kernel_device_ms(kern)
                records[name]["device_ms"] = round(
                    sum(records[f"_{name}_phase_ms"].values()), 4)
                log(f"[kernels] main   {name} by phase (ms): "
                    f"{records[f'_{name}_phase_ms']}")
        # the chain the main path runs: the backward kernel on the forward
        # kernel's own chunk states, against the plain chain
        _, _, cs_k = ssd_bwd.fwd_res_kernel_layout(x, dA, b, cm, chunk=Q)
        check_rel(f"{case} fwd_res->bwd",
                  ssd_bwd.bwd_kernel_layout(x, dA, b, cm, cs_k, dy, dstate,
                                            chunk=Q),
                  ssd_bwd.bwd_plain(*bwd, chunk=Q))
        if case != "main":
            continue
        # bounds from this run's inputs (ssd.ssd_fwd_work and the others):
        # each input read once (B and C as the one group they broadcast),
        # each output written once; operations over the causal pairs of
        # each chunk
        sh = dict(B=c["B"], S=c["S"], H=c["H"], P=c["P"], N=c["N"], chunk=Q,
                  itemsize=x.element_size(),
                  groups=1 if c["grouped"] else c["H"])
        for name in runs:
            set_bound(records[name], name, sh, c["dtype"])
            r = records[name]
            log(f"[kernels] main   {name:11s} ms={r['ms']:.4f} "
                f"plain_ms={r['plain_ms']:.4f} bound_ms={r['bound_ms']:.4f} "
                f"({r['bound_by']}) x_bound={r['ms'] / r['bound_ms']:.2f} "
                f"library_ms=None (no single PyTorch call computes the "
                f"chunked scan)")
    return records


def phase_rglru_kernels():
    """Phase 3c: the RG-LRU kernels against their plain versions; timings
    and bounds at the main-path shape.  Returns {name: record}."""
    import torch
    from repro_torch.kernels import rglru, rglru_bwd

    records = {}
    for case, c in RGLRU_CASES.items():
        gen = torch.Generator(device="cuda").manual_seed(3)
        shape = (c["B"], c["S"], c["W"])
        a = torch.rand(shape, generator=gen, device="cuda") * 0.899 + 0.1
        b, dy = (torch.randn(shape, generator=gen, device="cuda")
                 for _ in "bd")
        h_p = rglru.rglru_plain(a, b)
        runs = {    # name: (kernel wrapper, plain version), same inputs
            "rglru_fwd": (lambda: (rglru.rglru_scan(a, b),),
                          lambda: (rglru.rglru_plain(a, b),)),
            "rglru_bwd": (lambda: rglru_bwd.bwd_kernel_layout(a, h_p, dy),
                          lambda: rglru_bwd.bwd_plain(a, h_p, dy)),
        }
        for name, (kern, plain) in runs.items():
            max_abs = check_rel(f"{case} {name}", kern(), plain())
            if case == "main":
                records[name] = {"max_abs_err": max_abs,
                                 "ms": time_ms(kern, iters=20),
                                 "plain_ms": time_ms(plain, iters=3, warmup=1),
                                 "library_ms": None}
            elif case == "many_tiles":
                records[f"_{name}_many_tiles_ms"] = time_ms(kern, iters=3)
        # each tile combines with its one predecessor in a fixed order:
        # two calls agree
        for name, (kern, _) in runs.items():
            first, again = kern(), kern()
            if not all(torch.equal(x, y) for x, y in zip(first, again)):
                raise AssertionError(f"{case}: two {name} calls differ")
        log(f"[kernels] {case:24s} two calls of each of {list(runs)} "
            f"bitwise equal")
        # the chain the main path runs: the backward kernel on the forward
        # kernel's own output, against the plain chain
        h_k = rglru.rglru_scan(a, b)
        grads = rglru_bwd.bwd_kernel_layout(a, h_k, dy)
        check_rel(f"{case} fwd->bwd", grads, rglru_bwd.bwd_plain(a, h_p, dy))
        if case == "many_tiles":
            log(f"[kernels] many_tiles finished on {sms()} SMs: rglru_fwd "
                f"ms={records['_rglru_fwd_many_tiles_ms']:.4f} rglru_bwd "
                f"ms={records['_rglru_bwd_many_tiles_ms']:.4f}")
        if case != "main":
            continue
        for name, (kern, _) in runs.items():
            records[f"_{name}_device_ms"] = kernel_device_ms(kern, "rglru")
            records[name]["device_ms"] = round(
                sum(records[f"_{name}_device_ms"].values()), 4)
            log(f"[kernels] main   {name} device ms by kernel: "
                f"{records[f'_{name}_device_ms']}")
        # bounds from this run's inputs (rglru.rglru_fwd_work and
        # rglru_bwd's): each tensor read or written once; one multiply-add
        # per channel and step (two in the backward)
        for name in runs:
            set_bound(records[name], name, dict(B=c["B"], S=c["S"],
                                                W=c["W"]), "float32")
            r = records[name]
            log(f"[kernels] main   {name:11s} ms={r['ms']:.4f} "
                f"plain_ms={r['plain_ms']:.4f} bound_ms={r['bound_ms']:.4f} "
                f"({r['bound_by']}) x_bound={r['ms'] / r['bound_ms']:.2f} "
                f"library_ms=None (no single PyTorch call computes a "
                f"linear recurrence)")
    return records


def phase_card_vs_cpu(arch: str):
    """Phase 4: the same 4 SPB steps on the card (kernels) and on the CPU
    (plain versions), from one set of seeded weights."""
    import torch
    from repro_torch.config import SPBConfig, TrainConfig
    from repro_torch.configs import reduced_config
    from repro_torch.data.pipeline import Pipeline
    from repro_torch.dist import steps as steps_lib
    from repro_torch.engine.engine import SPBEngine
    from repro_torch.models import lm
    from repro_torch.tree import tree_map

    cfg = dataclasses.replace(reduced_config(arch), use_pallas=True)
    tcfg, spb = TrainConfig(num_steps=4), SPBConfig(mode="temporal", k=4)
    params = lm.init_lm(torch.Generator().manual_seed(0), cfg, "cpu")
    losses = {}
    for dev in ("cuda", "cpu"):
        eng = SPBEngine(cfg, tcfg, spb, device=dev)
        eng.attach_state(steps_lib.state_from_params(
            tree_map(torch.clone, params), tcfg))
        pipe = Pipeline(cfg, 2, 64, seed=0)
        zero_launches()
        before, losses[dev], depths = launches_now(), [], []
        for s in range(4):
            losses[dev].append(float(
                eng.train_step(pipe.get_batch(s), s)["loss"]))
            depths.append(eng.last_depth)
        if dev == "cuda":       # the card run went through the kernels
            grew = check_launches(f"card-vs-cpu {arch}", before, depths, cfg)
            log(f"[card-vs-cpu] {cfg.name} depths={depths} launches="
                f"{ {n: c for n, c in grew.items() if c} }")
    for s, (a, b) in enumerate(zip(losses["cuda"], losses["cpu"])):
        rel = abs(a - b) / abs(b)
        log(f"[card-vs-cpu] {cfg.name} step={s} loss_cuda={a:.6f} "
            f"loss_cpu={b:.6f} rel={rel:.2e} tol=1e-3")
        if not rel <= 1e-3:
            raise AssertionError(f"{arch}: card and CPU losses differ at "
                                 f"step {s}")


def phase_full_width(arch: str):
    """Phase 5: one path at full width; returns its launch counts per
    kernel, zeroed just before the run and read just after, and each
    step's ms, depth and peak allocation (GB)."""
    import torch
    from repro_torch.config import SPBConfig, TrainConfig
    from repro_torch.configs import (FULL_WIDTH_BATCH, FULL_WIDTH_SEQ,
                                     full_width_config, make_batch)
    from repro_torch.engine.engine import SPBEngine
    from repro_torch.tree import tree_leaves

    cfg = full_width_config(arch)
    steps = 8
    total_gb = torch.cuda.mem_get_info()[1] / 1e9
    eng = SPBEngine(cfg, TrainConfig(num_steps=steps),
                    SPBConfig(mode="temporal", k=4), device="cuda")
    t0 = time.perf_counter()
    eng.init_state(0)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(eng.state["params"]))
    log(f"[full-width] {arch} num_layers={cfg.num_layers} "
        f"enc_layers={cfg.enc_layers} {cfg.dtype} "
        f"params={n_params} init_s={time.perf_counter() - t0:.2f} "
        f"card_gb={total_gb:.2f}")
    batches = [make_batch(cfg, FULL_WIDTH_BATCH, FULL_WIDTH_SEQ, seed=s,
                          device="cuda") for s in range(steps)]
    zero_launches()
    times, depths, peaks = [], [], []
    for s in range(steps):
        before = launches_now()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = eng.train_step(batches[s], s)
        loss = float(m["loss"])
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        d = eng.last_depth
        grew = check_launches(f"full-width {arch} step {s}", before, [d], cfg)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        log(f"[full-width] {arch} step={s} depth={d} loss={loss:.4f} "
            f"moe_aux={float(m['moe_aux']):.4f} "
            f"gnorm={float(m['grad_norm']):.4f} step_ms={ms:.1f} "
            f"max_mem_gb={peak_gb:.2f} "
            f"launches={ {n: c for n, c in grew.items() if c} }")
        if not math.isfinite(loss):
            raise AssertionError(f"{arch}: loss not finite at step {s}")
        if total_gb - peak_gb < HEADROOM_GB:
            raise AssertionError(
                f"{arch}: step {s}'s peak allocation {peak_gb:.2f} GB leaves "
                f"under {HEADROOM_GB} of the card's {total_gb:.2f}; cut a "
                f"depth in configs.FULL_WIDTH_LAYERS")
        times.append(ms)
        depths.append(d)
        peaks.append(peak_gb)
    return launches_now(), times, depths, peaks


def check_counted_work(records, bounds) -> set:
    """Each kernel's counted work in the dry-run ``records`` against the
    work its phase 2/3 bound used at the same shape (``bounds``: {kernel:
    [shape key, flops, bytes]}).  Returns the kernels matched; raises on a
    difference."""
    matched = set()
    for rec in records:
        for name, by_shape in rec["kernel_shapes"].items():
            key, flops, nb = bounds[name]
            if key in by_shape:
                got = by_shape[key]
                if (got["flops"], got["bytes"]) != (flops, nb):
                    raise AssertionError(
                        f"dry run: {name} at {key} counts {got}, its bound "
                        f"used {flops} flops and {nb} bytes")
                matched.add(name)
    return matched


def phase_dryrun(phase5: dict, peaks: dict, bounds: dict) -> dict:
    """Phase 15 (host only, run last): each full-width path at every
    depth of its cycle dry-run on the meta device at phase 5's batch
    (``launch/dryrun.py``, ``use_pallas`` on, so the kernels' meta
    entries count them) beside phase 5's measured steps of the second
    cycle: counted TFLOP and GB, the three roofline terms, MFU against
    the measured step, the predicted peak (state + temporaries) against
    ``max_memory_allocated``.  Fails when a compute term exceeds a
    measured step, when the counted FLOPs or bytes do not fall strictly
    with depth, when a kernel's counted work differs from its bound's
    at the same shape, or when the dry run launched a kernel.  The
    records go to a temporary directory, not the checkout's
    ``results/``.  Then the JigSaw cost model's profile of yi-6b's cut
    from these records, its forward:backward split fitted over the
    cycle's depths, with no fallback.  Returns {arch: {depth: row}}."""
    import tempfile
    import warnings
    from repro_torch.analysis import roofline
    from repro_torch.config import SPBConfig
    from repro_torch.configs import (FULL_WIDTH_BATCH, FULL_WIDTH_SEQ,
                                     full_width_config)
    from repro_torch.engine.policies import make_policy
    from repro_torch.jigsaw import costmodel
    from repro_torch.launch import dryrun

    t0 = time.perf_counter()
    before = launches_now()
    out, recs, matched = {}, [], set()
    tmp = tempfile.TemporaryDirectory(prefix="dryrun_")
    for arch, (times, depths) in phase5.items():
        cfg = full_width_config(arch)
        counted, rows = [], {}
        for d in sorted(set(depths)):
            rec = dryrun.run_cell(arch, "train_4k", cut="full_width",
                                  depth=d, batch=FULL_WIDTH_BATCH,
                                  seq_len=FULL_WIDTH_SEQ, force=True,
                                  out_dir=tmp.name)
            if not rec.get("ok"):
                raise AssertionError(f"dry run of {arch} at depth {d}: "
                                     f"{rec.get('error')}")
            recs.append(rec)
            row = roofline.roofline_row(rec, cfg)
            # phase 5's second (warm) cycle at this depth
            warm = [i for i in range(len(depths) // 2, len(depths))
                    if depths[i] == d]
            ms = [times[i] for i in warm]
            peak = max(peaks[arch][i] for i in warm)
            ma = rec["memory_analysis"]
            pred_gb = (ma["argument_size_in_bytes"]
                       + ma["temp_size_in_bytes"]) / 1e9
            mfu = [row.model_flops / (roofline.PEAK_FLOPS * t / 1e3)
                   for t in ms]
            rows[d] = {"tflop": rec["flops_per_device"] / 1e12,
                       "gb": rec["bytes_per_device"] / 1e9,
                       "compute_ms": row.compute_s * 1e3,
                       "memory_ms": row.memory_s * 1e3,
                       "collective_ms": row.collective_s * 1e3,
                       "dominant": row.dominant,
                       "model_tflop": row.model_flops / 1e12,
                       "measured_ms": ms, "mfu": mfu,
                       "predicted_peak_gb": pred_gb, "max_mem_gb": peak,
                       "saved_gb": rec["saved_bytes"] / 1e9,
                       "count_s": rec["count_s"]}
            log(f"[dryrun] {arch} depth={d} tflop={rows[d]['tflop']:.3f} "
                f"gb={rows[d]['gb']:.2f} compute_ms={rows[d]['compute_ms']:.2f}"
                f" memory_ms={rows[d]['memory_ms']:.2f} collective_ms=0 "
                f"bound={row.dominant} measured_ms="
                f"{[round(t, 1) for t in ms]} model_tflop="
                f"{rows[d]['model_tflop']:.3f} mfu={[round(m, 4) for m in mfu]}"
                f" predicted_peak_gb={pred_gb:.2f} max_mem_gb={peak:.2f} "
                f"saved_gb={rows[d]['saved_gb']:.2f} "
                f"kernels={ {k: int(v['calls']) for k, v in rec['kernels'].items()} }"
                + (" (bytes term above the measured step: L2 serves "
                   "re-reads)" if row.memory_s * 1e3 > min(ms) else ""))
            if not ms or row.compute_s * 1e3 > min(ms):
                raise AssertionError(f"{arch} depth {d}: counted compute "
                                     f"{row.compute_s * 1e3:.2f} ms exceeds "
                                     f"the measured step {ms}")
            counted.append((rec["flops_per_device"], rec["bytes_per_device"]))
        for i, what in enumerate(("FLOPs", "bytes")):
            seq = [c[i] for c in counted]
            if not all(a < b for a, b in zip(seq, seq[1:])):
                raise AssertionError(f"{arch}: counted {what} do not fall "
                                     f"strictly with depth: {seq}")
        out[arch] = rows
    matched = check_counted_work(recs, bounds)
    if matched != set(KERNELS):
        raise AssertionError(f"dry runs never counted {set(KERNELS) - matched}"
                             f" at their bound's shape")
    if launches_since(before) != dict.fromkeys(KERNELS, 0):
        raise AssertionError("the dry run launched a kernel")
    # the cost model's profile of yi-6b's cut, from these records
    cfg = full_width_config("yi-6b")
    prof, split_counted = costmodel.h100_profile(cfg, results_dir=tmp.name)
    tmp.cleanup()
    if prof is None or not split_counted:
        raise AssertionError(f"no counted cost-model profile of yi-6b's cut "
                             f"from the dry runs: {prof}")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        pol = make_policy("costmodel", cfg, SPBConfig(mode="temporal", k=4),
                          profile=prof)
    prof = pol.profile
    L = cfg.num_layers
    log(f"[dryrun] costmodel yi-6b profile fwd_ms={prof.fwd_s * 1e3:.2f} "
        f"bwd_ms={prof.bwd_s * 1e3:.2f} by depth (profile vs measured ms): "
        + " ".join(f"{d}: {prof.task_time(d / L) * 1e3:.2f} vs "
                   f"{[round(t, 1) for t in out['yi-6b'][d]['measured_ms']]}"
                   for d in sorted(out["yi-6b"])))
    log(f"[dryrun] {len(recs)} dry runs, every kernel counted at its bound's "
        f"shape, none launched, {time.perf_counter() - t0:.1f}s")
    return out


class _TimedFullBackprop:
    """A policy that asks for the step's time (``needs_step_time``): the
    engine synchronizes the card before it reads the clock."""
    needs_step_time = True

    def __init__(self):
        self.times = []

    def depth_for_step(self, step):
        return None

    def observe(self, step, step_time_s):
        self.times.append(step_time_s)


def cycle_depths(cfg, spb) -> list:
    """The depths of one temporal-mb step's microbatches, in order."""
    from repro_torch.core import spb as spb_lib
    sched = spb_lib.make_schedule(cfg, spb)
    return [sched.depths[i] for i in sched.order]


def phase_temporal_mb(arch: str, temporal_ms: list) -> dict:
    """Phase 6: temporal-mb at full width, batch 4 x FULL_WIDTH_BATCH x
    FULL_WIDTH_SEQ (each microbatch the shape phase 5's steps run), 3
    steps, each step's launches checked against its cycle's depths.  Its
    policy sets ``needs_step_time``: the time it observes must be no
    shorter than the step's time on the card (CUDA events).  Returns the
    launch counts, zeroed just before the run and read just after."""
    import torch
    from repro_torch.config import SPBConfig, TrainConfig
    from repro_torch.configs import (FULL_WIDTH_BATCH, FULL_WIDTH_SEQ,
                                     full_width_config, make_batch)
    from repro_torch.engine.engine import SPBEngine

    cfg = full_width_config(arch)
    steps, spb = 3, SPBConfig(mode="temporal-mb", k=4)
    policy = _TimedFullBackprop()
    eng = SPBEngine(cfg, TrainConfig(num_steps=steps), spb, policy=policy,
                    device="cuda")
    eng.init_state(0)
    depths = cycle_depths(cfg, spb)
    batches = [make_batch(cfg, 4 * FULL_WIDTH_BATCH, FULL_WIDTH_SEQ, seed=s,
                          device="cuda") for s in range(steps)]
    # the four temporal steps of one cycle in phase 5 (its second cycle)
    four = sum(temporal_ms[len(depths):2 * len(depths)])
    # CUDA events around the step function itself, inside the engine's
    # clock: the card's time from the step's dispatch to its last kernel
    ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in "01")
    step_fn = eng.step_fn("mb")

    def timed_step(state, batch):
        ev0.record()
        out = step_fn(state, batch)
        ev1.record()
        return out

    eng._steps["mb"] = timed_step
    zero_launches()
    for s in range(steps):
        before = launches_now()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = eng.train_step(batches[s], s)
        loss = float(m["loss"])
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        device_ms = ev0.elapsed_time(ev1)
        observed_ms = policy.times[-1] * 1e3
        grew = check_launches(f"temporal-mb {arch} step {s}", before, depths,
                              cfg)
        log(f"[temporal-mb] {arch} step={s} depths={depths} loss={loss:.4f} "
            f"step_ms={ms:.1f} device_ms={device_ms:.1f} "
            f"observed_ms={observed_ms:.1f} "
            f"max_mem_gb={torch.cuda.max_memory_allocated() / 1e9:.2f} "
            f"four_temporal_steps_ms={four:.1f} "
            f"launches={ {n: c for n, c in grew.items() if c} }")
        if not math.isfinite(loss):
            raise AssertionError(f"{arch}: temporal-mb loss not finite at "
                                 f"step {s}")
        # CUDA events have ~0.5 us resolution
        if observed_ms < device_ms - 0.01:
            raise AssertionError(
                f"{arch}: a needs_step_time policy observed {observed_ms} ms "
                f"of a step the card ran for {device_ms} ms")
    return launches_now()


def phase_card_vs_cpu_compressed(arch: str):
    """Phase 7: card against CPU with gradient compression: 4 temporal-mb
    steps with topk (batch 4 x 64) and 4 temporal steps with lowrank
    (batch 2 x 64, its projections drawn from the step's CPU generator, so
    both devices project on the same q), from one set of seeded weights,
    losses within 1e-3 relative; then randk's structure on the card."""
    import torch
    from repro_torch.config import SPBConfig, TrainConfig
    from repro_torch.configs import reduced_config
    from repro_torch.core import compress
    from repro_torch.data.pipeline import Pipeline
    from repro_torch.dist import steps as steps_lib
    from repro_torch.engine.engine import SPBEngine
    from repro_torch.models import lm
    from repro_torch.tree import tree_leaves, tree_map

    cfg = dataclasses.replace(reduced_config(arch), use_pallas=True)
    params = lm.init_lm(torch.Generator().manual_seed(0), cfg, "cpu")
    for mode, method, batch in (("temporal-mb", "topk", 4),
                                ("temporal", "lowrank", 2)):
        tcfg = TrainConfig(num_steps=4, compression=method)
        spb = SPBConfig(mode=mode, k=4)
        losses = {}
        for dev in ("cuda", "cpu"):
            eng = SPBEngine(cfg, tcfg, spb, device=dev)
            eng.attach_state(steps_lib.state_from_params(
                tree_map(torch.clone, params), tcfg))
            pipe = Pipeline(cfg, batch, 64, seed=0)
            before, losses[dev], depths = launches_now(), [], []
            for s in range(4):
                losses[dev].append(float(
                    eng.train_step(pipe.get_batch(s), s)["loss"]))
                depths += (cycle_depths(cfg, spb) if mode == "temporal-mb"
                           else [eng.last_depth])
            if dev == "cuda":
                check_launches(f"compressed {mode} {arch}", before, depths,
                               cfg)
        for s, (a, b) in enumerate(zip(losses["cuda"], losses["cpu"])):
            rel = abs(a - b) / abs(b)
            log(f"[compressed] {cfg.name} {mode} {method} step={s} "
                f"loss_cuda={a:.6f} loss_cpu={b:.6f} rel={rel:.2e} "
                f"tol=1e-3")
            if not rel <= 1e-3:
                raise AssertionError(f"{arch} {mode} {method}: card and CPU "
                                     f"losses differ at step {s}")
    # randk draws differ across devices: its structure, leaf by leaf
    gen = torch.Generator().manual_seed(1)
    grads = tree_map(lambda p: torch.randn(p.shape, generator=gen).cuda(),
                     params)
    ratio = 0.1
    out = compress.compress_tree(grads, "randk", ratio,
                                 torch.Generator().manual_seed(2))
    for g, c in zip(tree_leaves(grads), tree_leaves(out)):
        kept = c != 0
        if int(kept.sum()) != max(1, int(g.numel() * ratio)) or \
                not torch.equal(c[kept], g[kept] * (1.0 / ratio)):
            raise AssertionError(f"{arch}: randk on the card kept the wrong "
                                 f"entries of a {tuple(g.shape)} leaf")
    log(f"[compressed] {cfg.name} randk on the card: exactly k entries a "
        f"leaf, each g / {ratio}, over {len(tree_leaves(out))} leaves")


def phase_restart() -> None:
    """Phase 8: the driver's restart loop on the card: yi-6b-reduced with
    the kernels, 8 temporal steps with a checkpoint every 4, once straight
    and once with a failure injected at step 5 (restored from step 4):
    exactly one FAILURE line, the injected one, and the same last xent to
    1e-5 relative."""
    import contextlib
    import io
    import shutil
    from repro_torch.launch import train as train_mod

    root = Path(__file__).resolve().parent / "build" / "chip_smoke_ckpt"
    shutil.rmtree(root, ignore_errors=True)
    args = ["--device", "cuda", "--use-pallas", "--arch", "yi-6b",
            "--steps", "8", "--checkpoint-every", "4", "--spb-mode",
            "temporal", "--batch", "2", "--seq", "64", "--log-every", "100"]
    runs = {}
    for name, extra in (("straight", []), ("failed", ["--fail-at", "5"])):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            history = train_mod.train(args + ["--checkpoint-dir",
                                              str(root / name)] + extra)
        lines = out.getvalue().splitlines()
        for line in lines:
            log(f"[restart] {name}: {line}")
        runs[name] = (history, [ln for ln in lines if "FAILURE" in ln])
    shutil.rmtree(root, ignore_errors=True)
    (straight, clean), (failed, failures) = runs["straight"], runs["failed"]
    rel = abs(failed[-1] - straight[-1]) / abs(straight[-1])
    log(f"[restart] last xent straight={straight[-1]:.7f} "
        f"after_restart={failed[-1]:.7f} rel={rel:.2e} tol=1e-5 "
        f"failure_lines={len(failures)}")
    if clean or failures != ["[train] FAILURE: injected failure; restart 1"]:
        raise AssertionError(f"restart: FAILURE lines {clean} / {failures}")
    if not rel <= 1e-5 or len(failed) != 9:
        raise AssertionError("restart: the resumed run does not end where "
                             "the straight one does")


# the JigSaw session (phase 9): per arch, the full-depth step's seconds and
# peak GB at batch 2 x 2048 (PERF.md section 5), seeding the scheduler's
# estimates; the live feedback replaces the times with measurements
JIGSAW_JOBS = {"yi-6b": (0.217, 38.5), "mamba2-2.7b": (0.465, 43.3)}
JIGSAW_TOL = 0.10       # measured step against CUDA events, relative


def _task_log_backend(feed_random: bool):
    """A ``LiveBackend`` that logs each task's (job, worker, iteration,
    depth, measured s, launches, peak allocated and reserved bytes).
    With ``feed_random`` its batches come from ``configs.make_batch`` on
    the card (a fused group's stacked, one a member): the ``MarkovLM``
    pipeline would build a (vocab, vocab) float64 table of ~33 GB at
    yi-6b's vocabulary."""
    import torch
    from repro_torch.cluster.live import LiveBackend

    class TaskLogBackend(LiveBackend):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.task_log, self.arrival_s = [], {}

        def job_arrived(self, job, now):
            t0 = time.perf_counter()
            super().job_arrived(job, now)
            torch.cuda.synchronize()
            self.arrival_s[job.job_id] = time.perf_counter() - t0

        def run_task(self, job, task, *a, **kw):
            before = launches_now()
            torch.cuda.reset_peak_memory_stats()
            measured = super().run_task(job, task, *a, **kw)
            self.task_log.append(dict(
                job=task.job_id, worker=task.worker_id, it=task.iteration,
                depth=self.engines[task.job_id].last_depth, s=measured,
                launches=launches_since(before),
                alloc=torch.cuda.max_memory_allocated(),
                reserved=torch.cuda.max_memory_reserved()))
            return measured

        def _stacked_batch(self, jid, step):
            if not feed_random:
                return super()._stacked_batch(jid, step)
            return _card_batch(self, jid, step)

    return TaskLogBackend


def _card_batch(backend, jid: int, step: int):
    """The batch one task of ``jid`` takes from ``configs.make_batch`` on
    the card (a fused group's stacked, one a member)."""
    from repro_torch.configs import make_batch
    from repro_torch.engine import stack_batches
    lj = backend.jobs[jid]
    batches = [make_batch(lj.cfg, lj.batch, lj.seq, seed=1000 * m + step,
                          device=backend.device)
               for m in backend._members(jid)]
    return batches[0] if len(batches) == 1 else stack_batches(batches)


def check_task_launches(phase: str, backend) -> dict:
    """Each logged task's launches against its depth; returns their sum
    by job id."""
    by_job = {}
    for t in backend.task_log:
        want = expected_launches(backend.jobs[t["job"]].cfg, [t["depth"]])
        if t["launches"] != want:
            raise AssertionError(f"{phase}: task {t} launched "
                                 f"{t['launches']} != {want}")
        acc = by_job.setdefault(t["job"], dict.fromkeys(want, 0))
        for n, c in want.items():
            acc[n] += c
    return by_job


def phase_jigsaw(phase5: dict) -> dict:
    """Phase 9: the JigSaw session at full width (see the module
    docstring).  ``phase5``: {arch: (step ms, depths)} of phase 5, printed
    beside the session's warm ms at the same depth.  Returns the launch
    counts by arch, zeroed just before the session and read just after."""
    import torch
    from repro_torch.cluster import ClusterRuntime, make_live_job
    from repro_torch.config import SPBConfig, TrainConfig
    from repro_torch.configs import (FULL_WIDTH_BATCH, FULL_WIDTH_SEQ,
                                     full_width_config, make_batch)
    from repro_torch.jigsaw.schedulers import JigsawScheduler

    iters, workers, ema = 3, 2, 0.5
    jobs = []
    for jid, (arch, (est_s, mem_gb)) in enumerate(JIGSAW_JOBS.items()):
        cfg = full_width_config(arch)
        jobs.append(make_live_job(
            jid, arrival=0.0, cfg=cfg, iterations=iters, num_workers=workers,
            batch=FULL_WIDTH_BATCH, seq=FULL_WIDTH_SEQ, est_step_s=est_s,
            est_mem_gb=mem_gb, model_size_gb=0.01,
            tcfg=TrainConfig(num_steps=iters * workers, seed=jid),
            spb=SPBConfig(mode="temporal", k=workers)))
    estimates = {(lj.spec.job_id, w): ws.duration
                 for lj in jobs for w, ws in enumerate(lj.spec.workers)}
    backend = _task_log_backend(feed_random=True)(jobs, device="cuda",
                                                  ema=ema)
    runtime = ClusterRuntime(backend.specs(), JigsawScheduler(), backend,
                             num_machines=2, machine_mem_gb=80.0, gamma=0.1,
                             horizon=60.0, record_schedule=True)
    zero_launches()
    t0 = time.perf_counter()
    try:
        res = runtime.run()
    except torch.cuda.OutOfMemoryError as e:
        raise AssertionError(
            f"jigsaw: out of memory after {len(backend.task_log)} tasks "
            f"(peaks so far "
            f"{[round(t['alloc'] / 1e9, 2) for t in backend.task_log]} GB)"
            f": the two tenants no longer fit the card; cut a depth in "
            f"configs.full_width_config") from e
    wall = time.perf_counter() - t0
    grew = launches_now()
    by_job = check_task_launches("jigsaw", backend)
    want = dict.fromkeys(grew, 0)
    for acc in by_job.values():
        for n, c in acc.items():
            want[n] += c
    if grew != want:
        raise AssertionError(f"jigsaw: launches {grew} != {want}")

    names = dict(enumerate(JIGSAW_JOBS))
    for t in backend.task_log:
        log(f"[jigsaw] job={t['job']} ({names[t['job']]}) worker={t['worker']}"
            f" iter={t['it']} depth={t['depth']} measured_ms="
            f"{t['s'] * 1e3:.1f} max_mem_gb={t['alloc'] / 1e9:.2f} "
            f"reserved_gb={t['reserved'] / 1e9:.2f} launches="
            f"{ {n: c for n, c in t['launches'].items() if c} }")
    depths = {j: sorted(d) for j, d in backend.observed_depths.items()}
    log(f"[jigsaw] scheduler=jigsaw jobs_done={len(res.jct)}/{len(jobs)} "
        f"depths={depths} makespan={res.makespan:.3f}s util={res.util:.3f} "
        f"goodput={res.goodput:.3f} migrations={sum(res.migrations.values())}"
        f" wall={wall:.3f}s")
    if len(res.jct) != len(jobs) or res.failed_jobs:
        raise AssertionError(f"jigsaw: jobs_done {len(res.jct)}/{len(jobs)}")
    for lj in jobs:
        jid, L = lj.spec.job_id, lj.cfg.num_layers
        if depths[jid] != [L // workers, L]:
            raise AssertionError(f"jigsaw: job {jid} ran depths "
                                 f"{depths[jid]}, not {[L // workers, L]}")
        if not math.isfinite(backend.last_xent[jid]):
            raise AssertionError(f"jigsaw: job {jid} xent not finite")
    # the virtual clock is the card's: each scheduled interval is the
    # task's measured time
    for m, s, e, jid, wid, it in res.schedule:
        meas = backend.task_measured[(jid, wid, it)]
        if not math.isclose(e - s, meas, rel_tol=1e-9):
            raise AssertionError(f"jigsaw: task {(jid, wid, it)} scheduled "
                                 f"{e - s} s, measured {meas} s")
    # each worker's estimate is the EMA of its warm measurements (its
    # first run, at a depth new to its job, is left out)
    for (jid, w), est in estimates.items():
        want_d = est
        for it in range(1, iters):
            want_d = (1 - ema) * want_d + ema * backend.task_measured[
                (jid, w, it)]
        got = runtime.jobs_by_id[jid].workers[w].duration
        if not math.isclose(got, want_d, rel_tol=1e-12) or got == est:
            raise AssertionError(f"jigsaw: job {jid} worker {w} estimate "
                                 f"{got} != EMA {want_d} (seed {est})")
    spent = sum(backend.task_measured.values())
    arrival = sum(backend.arrival_s.values())
    log(f"[jigsaw] wall_s={wall:.4f} sum_measured_s={spent:.4f} "
        f"job_arrival_s={arrival:.4f} (engine build and init) "
        f"outside_steps_s={wall - spent:.4f} "
        f"outside_steps_less_arrival_s={wall - spent - arrival:.4f} "
        f"share_of_wall_less_arrival="
        f"{(wall - spent - arrival) / (wall - arrival):.4%}")
    for lj in jobs:
        jid = lj.spec.job_id
        mine = [t for t in backend.task_log if t["job"] == jid]
        log(f"[jigsaw] job={jid} ({lj.cfg.name}) peak max_memory_allocated_gb"
            f"={max(t['alloc'] for t in mine) / 1e9:.2f} "
            f"max_memory_reserved_gb="
            f"{max(t['reserved'] for t in mine) / 1e9:.2f} "
            f"final_xent={backend.last_xent[jid]:.4f}")
    free, total = torch.cuda.mem_get_info()
    room = (total - max(t["alloc"] for t in backend.task_log)) / 1e9
    log(f"[jigsaw] card_gb={total / 1e9:.2f} free_gb_now={free / 1e9:.2f} "
        f"room_at_peak_allocation_gb={room:.2f} "
        f"least_room_gb={HEADROOM_GB}")
    # the resting tenant's state stays resident while the other steps, so
    # a deeper step or a larger state shows here before it runs out
    if room < HEADROOM_GB:
        raise AssertionError(
            f"jigsaw: the peak allocation leaves {room:.2f} GB of the card, "
            f"under {HEADROOM_GB}: the two tenants are close to not "
            f"fitting; cut a depth in configs.full_width_config")

    # each warm depth's measured ms against CUDA events around one more
    # step of the same engine at that depth
    ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in "01")
    for lj in jobs:
        jid, arch = lj.spec.job_id, names[lj.spec.job_id]
        engine = backend.engines[jid]
        p5_ms, p5_depths = phase5[arch]
        for w in range(workers):
            warm = [t["s"] * 1e3 for t in backend.task_log
                    if (t["job"], t["worker"]) == (jid, w) and t["it"] > 0]
            depth = engine.resolve_depth(
                math.ceil((w + 1) / workers * lj.cfg.num_layers))
            batch = make_batch(lj.cfg, lj.batch, lj.seq, seed=999,
                               device="cuda")
            torch.cuda.synchronize()
            ev0.record()
            engine.train_step(batch, depth=depth)
            ev1.record()
            torch.cuda.synchronize()
            event_ms = ev0.elapsed_time(ev1)
            mean = sum(warm) / len(warm)
            # phase 5's second cycle (steps 4-7) at this depth
            p5 = [ms for ms, d in zip(p5_ms[4:], p5_depths[4:]) if d == depth]
            log(f"[jigsaw] job={jid} ({arch}) depth={depth} warm_measured_ms="
                f"{[round(x, 2) for x in warm]} mean={mean:.2f} "
                f"event_ms={event_ms:.2f} rel={mean / event_ms - 1:+.4f} "
                f"tol={JIGSAW_TOL} phase5_step_ms={[round(x, 1) for x in p5]}")
            if abs(mean / event_ms - 1) > JIGSAW_TOL:
                raise AssertionError(f"jigsaw: job {jid} depth {depth}: "
                                     f"measured {mean} ms against events "
                                     f"{event_ms} ms")
    backend.close()
    return {names[jid]: {n: c for n, c in acc.items() if c}
            for jid, acc in by_job.items()}


class _StepClock:
    """A scripted clock: each (start, end) pair of calls measures one
    virtual second, so the fault plan's crash lands mid-session whatever
    the card's speed."""

    def __init__(self):
        self.t, self.mid = 0.0, False

    def __call__(self):
        if self.mid:
            self.t += 1.0
        self.mid = not self.mid
        return self.t


def phase_cluster_faults() -> None:
    """Phase 10: yi-6b-reduced and mamba2-reduced with the kernels on the
    card, two workers each, 4 iterations on 2 machine slots, under one
    crash of machine 0 (t=3.5, back at 4.5) and one transient failure of
    job 1 worker 0's iteration 1, checkpointed every iteration: both jobs
    done, at least one restore, exactly one retry, each task's launches
    against its depth.  Then a ``KernelError`` raised in one attempt
    leaves ``ClusterRuntime.run()`` with no retry counted."""
    import shutil
    from repro_torch.cluster import ClusterRuntime, FaultPlan, make_live_job
    from repro_torch.config import SPBConfig, TrainConfig
    from repro_torch.configs import reduced_config
    from repro_torch.jigsaw.schedulers import JigsawScheduler
    from repro_torch.kernels._build import KernelError

    def jobs():
        return [make_live_job(
            jid, arrival=0.0,
            cfg=dataclasses.replace(reduced_config(arch), use_pallas=True),
            iterations=4, num_workers=2, batch=2, seq=64, est_step_s=1.0,
            tcfg=TrainConfig(num_steps=8, seed=jid),
            spb=SPBConfig(mode="temporal", k=2))
            for jid, arch in enumerate(JIGSAW_JOBS)]

    root = Path(__file__).resolve().parent / "build" / "chip_smoke_cluster"
    shutil.rmtree(root, ignore_errors=True)
    plan = FaultPlan.parse("crash:0@3.5+1.0;fail:1.0@1", restore_s=0.25)
    backend = _task_log_backend(feed_random=False)(
        jobs(), device="cuda", timer=_StepClock(), ckpt_dir=str(root))
    res = ClusterRuntime(backend.specs(), JigsawScheduler(), backend,
                         num_machines=2, gamma=0.05, horizon=1e9,
                         record_schedule=True, faults=plan,
                         ckpt_every=1).run()
    backend.close()
    shutil.rmtree(root, ignore_errors=True)
    launches = {j: {n: c for n, c in acc.items() if c} for j, acc in
                check_task_launches("cluster-faults", backend).items()}
    log(f"[cluster-faults] jobs_done={len(res.jct)}/2 crashes={res.crashes} "
        f"killed={len(res.killed_tasks)} retried={res.retried_tasks} "
        f"backend_retries={backend.retries} restores={backend.restores} "
        f"lost_iterations={res.lost_iterations} steps_run={backend.steps_run}"
        f" tasks_run={len(backend.task_log)} goodput={res.goodput:.3f} "
        f"util={res.util:.3f} launches={launches}")
    if len(res.jct) != 2 or res.failed_jobs:
        raise AssertionError("cluster-faults: a job did not finish")
    if not sum(backend.restores.values()) or res.crashes != 1:
        raise AssertionError("cluster-faults: the crash restored nothing")
    if res.retried_tasks != [(1, 0, 1)] or backend.retries:
        raise AssertionError("cluster-faults: not exactly one retry")
    if backend.steps_run != {0: 8, 1: 8}:
        raise AssertionError(f"cluster-faults: steps {backend.steps_run}")

    fault = KernelError("injected: flash_dq: CUDA error 700")

    def hook(jid, task, attempt):
        if (jid, task.iteration) == (1, 1):
            raise fault

    naps = []
    backend = _task_log_backend(feed_random=False)(
        jobs(), device="cuda", fault_hook=hook, sleeper=naps.append)
    try:
        ClusterRuntime(backend.specs(), JigsawScheduler(), backend,
                       num_machines=2, horizon=1e9).run()
    except KernelError as e:
        if e is not fault:
            raise
    else:
        raise AssertionError("cluster-faults: the KernelError was swallowed")
    backend.close()
    log(f"[cluster-faults] KernelError left run() after "
        f"{len(backend.task_log)} tasks: retries={backend.retries} "
        f"sleeps={naps} failed={backend.failed}")
    if backend.retries or naps or backend.failed:
        raise AssertionError("cluster-faults: a device fault was retried")


# horizontal fusion (phase 14): J tenants of each arch at published widths,
# each cut to these layers so that the stacked group's peak allocation
# leaves HEADROOM_GB of the card (bf16 params with f32 master and moments:
# ~14 B a parameter of state, two f32 gradient copies in the optimizer)
FUSED_LAYERS = {"yi-6b": 4, "mamba2-2.7b": 16, "recurrentgemma-2b": 6}
FUSED_J = 2
FUSED_STEPS = 8         # two k=4 cycles; the second is timed warm
# per tenant and step of the first cycle, loss and grad_norm against the
# solo engine: the card-vs-CPU check's relative tolerance (a fused step
# batches each product over the J jobs and, at J x B rows, may split the
# dkv kernel's GQA heads over other blocks, so its bf16 sums round in
# another order).  The second cycle's deviations are printed, not held:
# recurrentgemma-2b's early steps move its loss from 35 to 20 at grad
# norms up to 64, and such steps amplify the first cycle's rounding.
FUSED_TOL = 1e-3
FUSED_HELD = 4
# the kernel wrappers whose first call in a fused step is held at J x B rows
FUSED_ENTRY = {"flash_fwd": ("flash_attention", "fwd_kernel_layout"),
               "ssd_fwd": ("ssd", "ssd_fwd_kernel_layout"),
               "ssd_fwd_res": ("ssd_bwd", "fwd_res_kernel_layout"),
               "rglru_fwd": ("rglru", "rglru_scan")}


def fused_config(arch: str):
    from repro_torch.configs import full_width_config
    return dataclasses.replace(full_width_config(arch),
                               num_layers=FUSED_LAYERS[arch])


class _RowsSpy:
    """Stands in for a kernel wrapper in its module and records the
    leading dim of each call's first operand; ``.launches`` reads and
    writes the wrapper's own count, which the wrapper bumps by its module
    global (now this spy)."""

    def __init__(self, real, rows: list):
        self.__dict__.update(_real=real, _rows=rows)

    def __call__(self, *a, **kw):
        self._rows.append(a[0].shape[0])
        return self._real(*a, **kw)

    def __getattr__(self, name):
        return getattr(self._real, name)

    def __setattr__(self, name, value):
        setattr(self._real, name, value)


def _spy_rows(fn):
    """Run ``fn()`` with the forward kernels' wrappers spied on; returns
    (fn's result, {kernel: leading dims of its calls})."""
    import importlib
    rows = {n: [] for n in FUSED_ENTRY}
    mods = {n: importlib.import_module(f"repro_torch.kernels.{m}")
            for n, (m, _) in FUSED_ENTRY.items()}
    real = {n: getattr(mods[n], attr) for n, (_, attr) in FUSED_ENTRY.items()}
    try:
        for n, (_, attr) in FUSED_ENTRY.items():
            setattr(mods[n], attr, _RowsSpy(real[n], rows[n]))
        return fn(), rows
    finally:
        for n, (_, attr) in FUSED_ENTRY.items():
            setattr(mods[n], attr, real[n])


def _timed_steps(eng, batches, cfg, phase, start: int = 0):
    """Run ``eng`` over ``batches`` (one a step, from step ``start``),
    each step's launches checked against one solo step at its depth;
    returns per step (depth, ms, metrics on the host, peak GB)."""
    import torch
    out = []
    for s, batch in enumerate(batches, start):
        before = launches_now()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = eng.train_step(batch, s)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        d = eng.last_depth
        check_launches(f"{phase} step {s}", before, [d], cfg)
        out.append((d, ms, {k: v.detach().cpu() for k, v in m.items()},
                    torch.cuda.max_memory_allocated() / 1e9))
    return out


def phase_fused(arch: str) -> dict:
    """Phase 14: ``FusedEngine`` of ``FUSED_J`` tenants of ``arch`` at
    published widths, cut to ``FUSED_LAYERS``, batch 2 x 2048 each,
    temporal k=4, ``FUSED_STEPS`` steps, beside ``FUSED_J`` solo
    ``SPBEngine``s with the same seeds and batches (run first, one at a
    time: the stacked group and a solo pair do not fit the card
    together).  Holds each tenant's loss and grad_norm against its solo
    engine at ``FUSED_TOL`` over the first ``FUSED_HELD`` steps (one
    cycle) and finite after, each fused step's launches against one solo
    step's, and the first fused step's forward kernels at J x B rows.
    Returns the fused run's launch counts, zeroed just before it and read
    just after."""
    import torch
    from repro_torch.config import SPBConfig, TrainConfig
    from repro_torch.configs import (FULL_WIDTH_BATCH, FULL_WIDTH_SEQ,
                                     make_batch)
    from repro_torch.engine import FusedEngine, SPBEngine, stack_batches
    from repro_torch.tree import tree_leaves

    cfg = fused_config(arch)
    tcfg = TrainConfig(num_steps=FUSED_STEPS)
    spb = SPBConfig(mode="temporal", k=4)
    total_gb = torch.cuda.mem_get_info()[1] / 1e9
    seeds = list(range(FUSED_J))
    batches = [[make_batch(cfg, FULL_WIDTH_BATCH, FULL_WIDTH_SEQ,
                           seed=100 * j + s, device="cuda")
                for s in range(FUSED_STEPS)] for j in seeds]
    solo = []
    for j in seeds:
        eng = SPBEngine(cfg, tcfg, spb, device="cuda")
        eng.init_state(j)
        solo.append(_timed_steps(eng, batches[j], cfg,
                                 f"fused {arch} solo {j}"))
        del eng
        torch.cuda.empty_cache()
    eng = FusedEngine(cfg, tcfg, spb, num_jobs=FUSED_J, device="cuda")
    eng.init_states(seeds)
    n_params = sum(t[0].numel() for t in tree_leaves(eng.state["params"]))
    stacked = [stack_batches([batches[j][s] for j in seeds])
               for s in range(FUSED_STEPS)]
    zero_launches()
    first, rows = _spy_rows(lambda: _timed_steps(
        eng, stacked[:1], cfg, f"fused {arch}"))
    fused = first + _timed_steps(eng, stacked[1:], cfg, f"fused {arch}",
                                 start=1)
    grew = launches_now()
    want_rows = FUSED_J * FULL_WIDTH_BATCH
    seen = {n: r[0] for n, r in rows.items() if r}
    if not seen or any(r != want_rows for r in seen.values()):
        raise AssertionError(f"fused {arch}: the first step's forward "
                             f"kernels saw batches {seen}, not {want_rows}")
    rel = {}            # (step, tenant, metric): |fused / solo - 1|
    for s, (d, ms, m, peak) in enumerate(fused):
        for j in seeds:
            sd, sms, sm, _ = solo[j][s]
            if sd != d:
                raise AssertionError(f"fused {arch} step {s}: depth {d}, "
                                     f"solo {sd}")
            for k in ("loss", "grad_norm"):
                got, want = float(m[k][j]), float(sm[k])
                rel[s, j, k] = abs(got / want - 1)
                if not math.isfinite(got) or (
                        s < FUSED_HELD and rel[s, j, k] > FUSED_TOL):
                    raise AssertionError(
                        f"fused {arch} step {s} tenant {j}: {k} {got} "
                        f"against solo {want} (rel tol {FUSED_TOL})")
        solo_ms = [solo[j][s][1] for j in seeds]
        solo_loss = [round(float(solo[j][s][2]["loss"]), 4) for j in seeds]
        log(f"[fused] {arch} step={s} depth={d} "
            f"loss={[round(float(m['loss'][j]), 4) for j in seeds]} "
            f"solo_loss={solo_loss}"
            f" gnorm={[round(float(m['grad_norm'][j]), 4) for j in seeds]} "
            f"fused_ms={ms:.1f} solo_ms={[round(x, 1) for x in solo_ms]} "
            f"sum_solo_ms={sum(solo_ms):.1f} max_mem_gb={peak:.2f} "
            f"solo_max_mem_gb="
            f"{[round(solo[j][s][3], 2) for j in seeds]}")
    peak = max(p for _, _, _, p in fused)
    half = FUSED_STEPS // 2         # the second cycle: every depth warm
    by_depth = {}
    for s in range(half, FUSED_STEPS):
        d = fused[s][0]
        by_depth[d] = (round(fused[s][1], 2),
                       round(sum(solo[j][s][1] for j in seeds), 2))
    held = max(v for (s, _, _), v in rel.items() if s < FUSED_HELD)
    after = max(v for (s, _, _), v in rel.items() if s >= FUSED_HELD)
    log(f"[fused] {arch} num_layers={cfg.num_layers} J={FUSED_J} "
        f"params_per_tenant={n_params} warm fused_ms_vs_sum_solo_ms_by_depth"
        f"={by_depth} max_rel_dev_first_cycle={held:.3e} (held at "
        f"{FUSED_TOL}) max_rel_dev_second_cycle={after:.3e} "
        f"peak_gb={peak:.2f} card_gb={total_gb:.2f} "
        f"rows_seen={seen} launches={ {n: c for n, c in grew.items() if c} }")
    if total_gb - peak < HEADROOM_GB:
        raise AssertionError(f"fused {arch}: peak {peak:.2f} GB leaves under "
                             f"{HEADROOM_GB} of the card's {total_gb:.2f}; "
                             f"cut a depth in FUSED_LAYERS")
    del eng
    torch.cuda.empty_cache()
    return {"launches": {n: c for n, c in grew.items() if c},
            "ms_by_depth": by_depth, "peak_gb": round(peak, 2),
            "first_step_ms": round(fused[0][1], 1),
            "max_rel_dev": [held, after]}


def phase_fused_jigsaw() -> dict:
    """Phase 14b: a JigSaw session with ``LiveBackend(fuse=True)`` on the
    card: two identical yi-6b tenants (one fused group) and one
    mamba2-2.7b tenant at the ``FUSED_LAYERS`` cuts, two workers each, 2
    iterations on 2 machine slots: every job done, the group's
    ``fused_with``, each member's steps its iterations' tasks, a finite
    last xent for each, each task's launches one solo step's at its
    depth.  Returns the launches by scheduled job's arch, zeroed just
    before the session and read just after."""
    import torch
    from repro_torch.cluster import ClusterRuntime, make_live_job
    from repro_torch.config import SPBConfig, TrainConfig
    from repro_torch.configs import FULL_WIDTH_BATCH, FULL_WIDTH_SEQ
    from repro_torch.jigsaw.schedulers import JigsawScheduler

    iters, workers = 2, 2
    archs = ("yi-6b", "yi-6b", "mamba2-2.7b")
    jobs = [make_live_job(
        jid, arrival=0.0, cfg=fused_config(arch), iterations=iters,
        num_workers=workers, batch=FULL_WIDTH_BATCH, seq=FULL_WIDTH_SEQ,
        est_step_s=0.2, est_mem_gb=20.0, model_size_gb=0.01,
        tcfg=TrainConfig(num_steps=iters * workers, seed=jid),
        spb=SPBConfig(mode="temporal", k=workers))
        for jid, arch in enumerate(archs)]
    backend = _task_log_backend(feed_random=True)(jobs, device="cuda",
                                                  fuse=True)
    runtime = ClusterRuntime(backend.specs(), JigsawScheduler(), backend,
                             num_machines=2, machine_mem_gb=80.0, gamma=0.1,
                             horizon=60.0, record_schedule=True)
    zero_launches()
    t0 = time.perf_counter()
    res = runtime.run()
    wall = time.perf_counter() - t0
    grew = launches_now()
    by_job = check_task_launches("fused-jigsaw", backend)
    want = dict.fromkeys(grew, 0)
    for acc in by_job.values():
        for n, c in acc.items():
            want[n] += c
    if grew != want:
        raise AssertionError(f"fused-jigsaw: launches {grew} != {want}")
    summary = backend.summary()
    for t in backend.task_log:
        log(f"[fused-jigsaw] job={t['job']} worker={t['worker']} "
            f"iter={t['it']} depth={t['depth']} measured_ms="
            f"{t['s'] * 1e3:.1f} max_mem_gb={t['alloc'] / 1e9:.2f} "
            f"launches={ {n: c for n, c in t['launches'].items() if c} }")
    xent = {j: round(s["final_xent"], 4) for j, s in summary.items()}
    log(f"[fused-jigsaw] jobs_done={len(res.jct)}/{len(backend.specs())} "
        f"fused={backend.fused} steps_run={backend.steps_run} "
        f"final_xent={xent} makespan={res.makespan:.3f}s wall={wall:.3f}s")
    if backend.fused != {0: [0, 1]} or len(res.jct) != 2 or res.failed_jobs:
        raise AssertionError(f"fused-jigsaw: fused {backend.fused}, jobs "
                             f"done {sorted(res.jct)}")
    for jid, s in summary.items():
        if s["fused_with"] != ([0, 1] if jid < 2 else None):
            raise AssertionError(f"fused-jigsaw: job {jid} fused_with "
                                 f"{s['fused_with']}")
        if s["steps_run"] != iters * workers:
            raise AssertionError(f"fused-jigsaw: job {jid} ran "
                                 f"{s['steps_run']} steps")
        if not math.isfinite(s["final_xent"]):
            raise AssertionError(f"fused-jigsaw: job {jid} xent not finite")
    backend.close()
    return {archs[jid]: {n: c for n, c in acc.items() if c}
            for jid, acc in by_job.items()}


def phase_decode(arch: str) -> dict:
    """Phase 11: the dense-cache serving path at ``arch``'s reduced config
    in f32 with the kernels: a prefill of 63 of 64 positions (after a
    frontend's embeddings; over 64 encoder frames) and one decode step
    against the train forward's logits on the card, at the reference's
    tolerance (``DECODE_TOL``); the same on the CPU (the plain versions),
    and the card's logits against the CPU's.  The card's prefill launches
    what a forward does (``expected_launches`` at depth 0: the flash
    forward for attention and MLA, the primal SSD and RG-LRU scans), the
    decode step nothing.  Returns the card's launches."""
    import torch
    from repro_torch.configs import make_batch, reduced_config
    from repro_torch.models import lm
    from repro_torch.tree import tree_map

    cfg = dataclasses.replace(reduced_config(arch), use_pallas=True)
    params = lm.init_lm(torch.Generator().manual_seed(0), cfg, "cpu")
    # 64 positions: the tokens, after a frontend's embeddings; an
    # encoder-decoder's 64 frames
    batch = make_batch(cfg, 2, 64, seed=1, device="cpu")
    del batch["labels"]
    enc_len = 64 if cfg.enc_layers else 0
    logits, errs, grew = {}, {}, {}
    for dev in ("cuda", "cpu"):
        p = tree_map(lambda x: x.to(dev), params)
        b = {k: v.to(dev) for k, v in batch.items()}
        t = b["tokens"]
        with torch.no_grad():
            train, _ = lm.forward_train(p, b, cfg)
        cache = lm.init_cache(cfg, 2, 64, enc_len, device=dev)
        before = launches_now()
        pre, cache = lm.prefill(p, dict(b, tokens=t[:, :-1]), cfg, cache)
        dec, cache = lm.decode_step(p, cache, t[:, -1:], cfg)
        grew[dev] = launches_since(before)
        logits[dev] = (pre[:, 0].cpu(), dec[:, 0].cpu())
        errs[dev] = [decode_close(f"decode {arch} {dev} {name}", a, b)
                     for name, a, b in (("prefill", pre[:, 0], train[:, -2]),
                                        ("decode", dec[:, 0], train[:, -1]))]
    cross = max(decode_close(f"decode {arch} cuda vs cpu", a, b)
                for a, b in zip(logits["cuda"], logits["cpu"]))
    want = expected_launches(cfg, [0])
    if grew["cuda"] != want or any(grew["cpu"].values()):
        raise AssertionError(f"decode {arch}: card launches {grew['cuda']} "
                             f"!= {want}, cpu {grew['cpu']}")
    log(f"[decode] {cfg.name} max_abs_err prefill_vs_forward "
        f"cuda={errs['cuda'][0]:.3e} cpu={errs['cpu'][0]:.3e} "
        f"decode_vs_forward cuda={errs['cuda'][1]:.3e} "
        f"cpu={errs['cpu'][1]:.3e} cuda_vs_cpu={cross:.3e} "
        f"tol={DECODE_TOL}+{DECODE_TOL}*|want| "
        f"launches={ {n: c for n, c in grew['cuda'].items() if c} }")
    return grew["cuda"]


def decode_close(name: str, got, want) -> float:
    """The reference's decode check (rtol = atol = ``DECODE_TOL``);
    returns the max abs error."""
    import torch
    err = (got.float() - want.float()).abs()
    if not bool(torch.isfinite(got).all()) or bool(
            (err > DECODE_TOL * (1 + want.float().abs())).any()):
        raise AssertionError(f"{name}: logits off by {float(err.max()):.3e}")
    return float(err.max())


def device_busy(fn, iters: int = 3):
    """(the card's busy ms of one call of ``fn``: every kernel it launches,
    from a ``torch.profiler`` trace over ``iters`` calls; the kernels a
    call launches)."""
    from torch.autograd import DeviceType
    kern = cuda_trace(fn, iters, lambda ev: ev.device_type == DeviceType.CUDA)
    if kern is None:
        raise AssertionError("the profiler saw no kernel on the card")
    return (sum(ev.device_time_total for ev in kern) / iters / 1e3,
            sum(ev.count for ev in kern) // iters)


class _EventLog:
    """Wraps an engine's step functions with CUDA events around each call,
    recorded without a sync and read after the run; ``raw`` keeps the
    unwrapped functions."""

    def __init__(self, engine):
        import torch
        self.raw, self.calls = dict(engine._steps), []
        for key, fn in self.raw.items():
            def timed(*a, key=key, fn=fn):
                ev = [torch.cuda.Event(enable_timing=True) for _ in "01"]
                ev[0].record()
                fn(*a)
                ev[1].record()
                self.calls.append((key, ev))
            engine._steps[key] = timed

    def ms(self, prefix: str, since: int = 0) -> dict:
        """{key: [ms of each call]} of the keys starting with ``prefix``."""
        import torch
        torch.cuda.synchronize()
        out = {}
        for key, (a, b) in self.calls[since:]:
            if key.startswith(prefix):
                out.setdefault(key, []).append(round(a.elapsed_time(b), 4))
        return out


def serve_bound(engine):
    """The least time of one decode step, ms: every weight read once (the
    dense MoE reads all its experts, the tied table once as the
    unembedding) and each layer's gathered cache view read once -- every
    slot at the full context, as ``pages[page_table]`` gathers it -- over
    the card's memory rate.  Returns (ms, weight bytes, view bytes)."""
    from repro_torch.tree import tree_leaves
    weights = sum(t.numel() * t.element_size()
                  for t in tree_leaves(engine.params))
    per_token = sum(t.shape[0] * t[0, 0, 0].numel() * t.element_size()
                    for t in tree_leaves(engine.state["groups"]))
    view = per_token * engine.geom.num_slots * engine.geom.max_context
    from repro_torch.analysis.roofline import HBM_BW
    return (weights + view) / HBM_BW * 1e3, weights, view


SERVE_MAX_NEW = 16
# (prompt length, arrival in engine steps) of the staggered trace: one
# prompt in each prefill bucket (16, 64, 256, 1024), arriving mid-decode
SERVE_TRACE = ((700, 0), (12, 2), (200, 4), (50, 6))


def phase_serve(arch: str) -> dict:
    """Phase 12: ``ServeEngine`` on the card at ``arch``'s published widths
    and full depth, bf16, the kernels on, the weights built leaf by leaf
    on the card from a seed; 4 slots of 16-token pages, 2048 context,
    buckets up to 1024, greedy, random prompts from a seeded generator.
    Each request of ``SERVE_TRACE`` runs alone, then all four staggered:
    every request completes, the co-batched outputs equal the solo ones
    token for token, and every ``engine.step()`` runs under
    ``torch.cuda.set_sync_debug_mode("error")`` (a host sync in admission
    or decode raises).  The flash forward launches once a prefill and
    attention layer, nothing else.  Prints the prefill ms per bucket and
    the decode step's ms (CUDA events) at 1 and 4 active slots beside its
    bytes bound, tokens/s, the paged cache bytes and the peak allocation.
    Returns the launches, zeroed before the solo runs and read after the
    staggered one."""
    import collections

    import torch
    from repro_torch.config import layer_kinds
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.serve import ServeEngine, cache_bytes, default_geometry
    from repro_torch.tree import tree_leaves

    cfg = dataclasses.replace(get_config(arch), use_pallas=True)
    geom = default_geometry(num_slots=4, page_size=16, max_context=2048)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init_lm(torch.Generator(device="cuda").manual_seed(0), cfg,
                        "cuda")
    torch.cuda.synchronize()
    init_s, init_peak = time.perf_counter() - t0, \
        torch.cuda.max_memory_allocated()
    eng = ServeEngine(cfg, geom=geom, params=params, device="cuda")
    bound_ms, w_bytes, view_bytes = serve_bound(eng)
    log(f"[serve] {arch} num_layers={cfg.num_layers} {cfg.dtype} "
        f"params={sum(t.numel() for t in tree_leaves(params))} "
        f"weight_bytes={w_bytes} init_s={init_s:.2f} "
        f"init_peak_gb={init_peak / 1e9:.2f} "
        f"paged_cache_bytes={cache_bytes(cfg, geom)} "
        f"buckets={list(eng.buckets)}")
    gen = torch.Generator().manual_seed(7)
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=gen).tolist()
               for n, _ in SERVE_TRACE]
    events = _EventLog(eng)

    def run(trace):
        """Replay [(arrival step, prompt)] to the end, every step under the
        sync check; returns (requests in trace order, wall seconds)."""
        start, pending, reqs = eng.clock, collections.deque(trace), []
        torch.cuda.synchronize()
        t = time.perf_counter()
        while pending or eng._live or eng.scheduler.queue:
            while pending and pending[0][0] <= eng.clock - start:
                reqs.append(eng.submit(pending.popleft()[1],
                                       max_new=SERVE_MAX_NEW))
            torch.cuda.set_sync_debug_mode("error")
            try:
                eng.step(1)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            eng.poll()
        torch.cuda.synchronize()
        return reqs, time.perf_counter() - t

    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    solo = [run([(0, p)])[0][0].output for p in prompts]
    mark = len(events.calls)
    reqs, wall = run([(at, p) for (_, at), p in zip(SERVE_TRACE, prompts)])
    grew = launches_now()
    outs = [r.output for r in reqs]
    if len(reqs) != len(prompts) or not all(r.done for r in reqs) or \
            any(len(o) != SERVE_MAX_NEW for o in outs):
        raise AssertionError(f"serve {arch}: not every request completed "
                             f"({[len(o) for o in outs]})")
    if outs != solo:
        raise AssertionError(f"serve {arch}: co-batched outputs differ from "
                             f"solo: {outs} != {solo}")
    attn = sum(m in ("attn", "local", "mla") for m, _ in layer_kinds(cfg))
    want = dict.fromkeys(grew, 0)
    want["flash_fwd"] = 2 * len(prompts) * attn
    if grew != want:
        raise AssertionError(f"serve {arch}: launches {grew} != {want}")
    prefill = events.ms("prefill_")
    stag_decode = events.ms("decode", since=mark).get("decode", [])
    # the decode step alone, at 1 and at 4 active slots (every slot
    # computes either way): CUDA events over 10 calls of the raw step
    step_ms = {}
    for n in (1, 4):
        for _ in range(n):
            eng.submit(prompts[1], max_new=SERVE_MAX_NEW)
        eng.step(1)             # admits all n, one decode: 2 tokens each
        step_ms[n] = time_ms(lambda: events.raw["decode"](
            eng.params, eng.state, None), iters=10, warmup=2)
        eng.drain()
    # where a decode step's time goes: the host's enqueue of it against
    # the card's busy time (the step's kernels, torch.profiler)
    raw = lambda: events.raw["decode"](eng.params, eng.state, None)
    eng.submit(prompts[1], max_new=SERVE_MAX_NEW)
    eng.step(1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    raw()
    host_ms = (time.perf_counter() - t0) * 1e3
    busy_ms, kernels = device_busy(raw, iters=3)
    eng.drain()
    peak = torch.cuda.max_memory_allocated()
    tokens = sum(len(o) for o in outs)
    by_bucket = {int(k.split("_")[1]): v for k, v in prefill.items()}
    log(f"[serve] {arch} requests={len(reqs)} "
        f"completed={sum(r.done for r in reqs)} co_batched_equal_solo=True "
        f"sync_debug=error tokens={tokens} "
        f"wall_s={wall:.4f} tokens_per_s={tokens / wall:.2f} "
        f"decode_steps_staggered={len(stag_decode)} "
        f"launches={ {n: c for n, c in grew.items() if c} }")
    log(f"[serve] {arch} prefill_ms_by_bucket (solo, staggered) "
        f"{dict(sorted(by_bucket.items()))}")
    log(f"[serve] {arch} decode_step_ms slots_active_1={step_ms[1]:.4f} "
        f"slots_active_4={step_ms[4]:.4f} bound_ms={bound_ms:.4f} (bytes: "
        f"weights {w_bytes} + gathered views {view_bytes}) "
        f"x_bound={step_ms[4] / bound_ms:.2f} staggered_decode_ms "
        f"median={sorted(stag_decode)[len(stag_decode) // 2]:.4f} "
        f"min={min(stag_decode):.4f} max={max(stag_decode):.4f}")
    log(f"[serve] {arch} decode_step host_enqueue_ms={host_ms:.4f} "
        f"device_busy_ms={busy_ms:.4f} kernels_per_step={kernels}")
    log(f"[serve] {arch} max_memory_allocated_gb={peak / 1e9:.2f} "
        f"card_gb={torch.cuda.mem_get_info()[1] / 1e9:.2f}")
    del eng, params, events
    torch.cuda.empty_cache()
    return {n: c for n, c in grew.items() if c}


# the graphs phase's training check: yi-6b at phase 5's cut, one cycle of
# k = 4 twice (the first cycle warms up), batch 2 x 2048
GRAPH_STEPS = 8
GRAPH_DEPTHS = (2, 4, 6, 8)

# run in a fresh process by the graphs phase: load a stored step table with
# nvcc out of reach and every build refused, run one graphed step, print
# the loss's bits and the libraries' files as JSON
_FRESH_LOAD = r'''
import json, sys
sys.path.insert(0, "src")
import torch
from repro_torch.kernels import _build

def refuse(*a, **k):
    raise RuntimeError("a kernel library was built")

_build.build = refuse
_build.BUILD_DIR = _build.BUILD_DIR.parent / "nothing_here"
from repro_torch.config import SPBConfig, TrainConfig
from repro_torch.configs import full_width_config, make_batch
from repro_torch.engine.engine import SPBEngine
cfg = full_width_config("yi-6b")
eng = SPBEngine(cfg, TrainConfig(num_steps=int(sys.argv[2])),
                SPBConfig(mode="temporal", k=4), device="cuda")
eng.init_state(0)
loaded = eng.load_aot(sys.argv[1])
m = eng.train_step(make_batch(cfg, 2, 2048, seed=0, device="cuda"), 0)
print(json.dumps({"loaded": loaded, "depth": eng.last_depth,
                  "loss": float(m["loss"]),
                  "libs": {n: str(p) for n, p in _build._LIB_FILES.items()},
                  "keys": sorted(eng.depth_keys())}))
'''

# run in a fresh process by the graphs phase: a step that syncs the host
# cannot be captured; compile_table must raise and leave the eager entry
_CAPTURE_FAILS = r'''
import json, sys
sys.path.insert(0, "src")
import torch
from repro_torch.config import SPBConfig, TrainConfig
from repro_torch.configs import make_batch, reduced_config
from repro_torch.engine.engine import SPBEngine
cfg = reduced_config("yi-6b")
eng = SPBEngine(cfg, TrainConfig(), SPBConfig(mode="temporal", k=2),
                shared_cache=False, device="cuda")
eng.init_state(0)
eager = eng.step_fn(2)

def syncing(state, batch, **kw):
    out = eager(state, batch, **kw)
    float(out[1]["loss"])          # a host read of a device value
    return out

eng._eager_step = lambda key: syncing
batch = make_batch(cfg, 2, 64, seed=0, device="cpu")
try:
    eng.compile_table(eng.batch_specs_like(batch), depths=[2])
    print(json.dumps({"raised": None}))
except RuntimeError as e:
    print(json.dumps({"raised": type(e).__name__ + ": " + str(e)[:200],
                      "compiled": len(eng._compiled),
                      "eager_kept": eng.step_fn(2) is eager,
                      "step_after": float(eng.train_step(batch, 0,
                                                         depth=2)["loss"])}))
'''


def _serve_measure(eng, prompts, label: str) -> dict:
    """Phase 12's measurements of ``eng`` (eager, or with its step table):
    the staggered trace under sync-debug "error" (outputs and launches),
    prefill ms per bucket and decode ms by CUDA events, the decode step's
    host enqueue and the card's busy time and kernels (``torch.profiler``).
    """
    import collections

    import torch

    events = _EventLog(eng)
    start, pending, reqs = eng.clock, collections.deque(
        (at, p) for (_, at), p in zip(SERVE_TRACE, prompts)), []
    before = launches_now()
    torch.cuda.synchronize()
    while pending or eng._live or eng.scheduler.queue:
        while pending and pending[0][0] <= eng.clock - start:
            reqs.append(eng.submit(pending.popleft()[1],
                                   max_new=SERVE_MAX_NEW))
        torch.cuda.set_sync_debug_mode("error")
        try:
            eng.step(1)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        eng.poll()
    grew = launches_since(before)
    prefill = {int(k.split("_")[1]): v
               for k, v in events.ms("prefill_").items()}
    raw = lambda: events.raw["decode"](eng.params, eng.state, None)
    step_ms = {}
    for n in (1, 4):
        for _ in range(n):
            eng.submit(prompts[1], max_new=SERVE_MAX_NEW)
        eng.step(1)
        step_ms[n] = time_ms(raw, iters=10, warmup=2)
        eng.drain()
    eng.submit(prompts[1], max_new=SERVE_MAX_NEW)
    eng.step(1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    raw()
    host_ms = (time.perf_counter() - t0) * 1e3
    busy_ms, kernels = device_busy(raw, iters=3)
    eng.drain()
    eng._steps.update(events.raw)
    out = {"outputs": [r.output for r in reqs], "launches": grew,
           "prefill_ms": dict(sorted(prefill.items())),
           "decode_ms_1": step_ms[1], "decode_ms_4": step_ms[4],
           "host_enqueue_ms": host_ms, "device_busy_ms": busy_ms,
           "kernels_per_step": kernels}
    log(f"[graphs] serve yi-6b {label} decode_step_ms "
        f"slots_active_1={step_ms[1]:.4f} slots_active_4={step_ms[4]:.4f} "
        f"host_enqueue_ms={host_ms:.4f} device_busy_ms={busy_ms:.4f} "
        f"kernels_per_step={kernels} prefill_ms_by_bucket "
        f"{out['prefill_ms']} launches="
        f"{ {n: c for n, c in grew.items() if c} }")
    return out


def phase_graphs_serve() -> dict:
    """Graphs phase (a): yi-6b's ``ServeEngine`` at published widths and
    full depth (phase 12's geometry, params and prompts), eager (once
    cold, then measured) and then with ``compile_table()``, in the same
    call: greedy outputs equal token
    for token, the same launches; decode ms at 1 and 4 active slots, host
    enqueue, busy ms and kernels a step, prefill ms per bucket.  Returns
    the launches of the graphed trace."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.serve import ServeEngine, default_geometry

    cfg = dataclasses.replace(get_config("yi-6b"), use_pallas=True)
    geom = default_geometry(num_slots=4, page_size=16, max_context=2048)
    params = lm.init_lm(torch.Generator(device="cuda").manual_seed(0), cfg,
                        "cuda")
    eng = ServeEngine(cfg, geom=geom, params=params, device="cuda")
    gen = torch.Generator().manual_seed(7)
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=gen).tolist()
               for n, _ in SERVE_TRACE]
    _serve_measure(eng, prompts, "eager (cold: first calls)")
    eager = _serve_measure(eng, prompts, "eager")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.compile_table()
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    graphed = _serve_measure(eng, prompts, "graphed")
    if graphed["outputs"] != eager["outputs"]:
        raise AssertionError(f"graphs: graphed greedy outputs "
                             f"{graphed['outputs']} != eager "
                             f"{eager['outputs']}")
    if graphed["launches"] != eager["launches"]:
        raise AssertionError(f"graphs: graphed serve launches "
                             f"{graphed['launches']} != eager "
                             f"{eager['launches']}")
    log(f"[graphs] serve yi-6b greedy_outputs_equal=True "
        f"capture_s={capture_s:.2f} entries={sorted(eng._compiled)} "
        f"decode_x_eager_1={graphed['decode_ms_1'] / eager['decode_ms_1']:.4f}"
        f" decode_x_eager_4="
        f"{graphed['decode_ms_4'] / eager['decode_ms_4']:.4f} "
        f"max_memory_allocated_gb={torch.cuda.max_memory_allocated() / 1e9:.2f}")
    del eng, params
    torch.cuda.empty_cache()
    return {n: c for n, c in graphed["launches"].items() if c}


def _train_run(eng, batches, label: str) -> list:
    """Each step's (depth, loss, grad_norm, lr as host tensors, ms,
    launches) over ``batches``."""
    import torch
    rows = []
    for s, batch in enumerate(batches):
        before = launches_now()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = eng.train_step(batch, s)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        rows.append({"depth": eng.last_depth, "ms": ms,
                     "launches": launches_since(before),
                     **{k: m[k].detach().cpu()
                        for k in ("loss", "grad_norm", "lr")}})
        log(f"[graphs] train yi-6b {label} step={s} depth={eng.last_depth} "
            f"loss={float(m['loss']):.6f} gnorm={float(m['grad_norm']):.6f} "
            f"lr={float(m['lr']):.6e} step_ms={ms:.1f}")
    return rows


def phase_graphs_train(table_dir: Path) -> dict:
    """Graphs phase (b): yi-6b at phase 5's cut (8 layers), temporal k=4,
    batch 2 x 2048, eager and then graphed from the same seeded state and
    batches over ``GRAPH_STEPS`` steps, the learning rate changing every
    step (warm-up): loss, grad_norm, lr and every parameter bit-equal; each
    replay's launches those of an eager step at its depth; warm step ms of
    the second cycle, graphed against eager; the pool's bytes beside the
    peak allocation.  Stores the table at ``table_dir`` for (c).  Returns
    the launches of the graphed steps."""
    import torch
    from repro_torch.config import SPBConfig, TrainConfig
    from repro_torch.configs import (FULL_WIDTH_BATCH, FULL_WIDTH_SEQ,
                                     full_width_config, make_batch)
    from repro_torch.engine.engine import SPBEngine
    from repro_torch.tree import tree_leaves

    cfg = full_width_config("yi-6b")
    tcfg, spb = TrainConfig(num_steps=GRAPH_STEPS), SPBConfig(mode="temporal",
                                                               k=4)
    batches = [make_batch(cfg, FULL_WIDTH_BATCH, FULL_WIDTH_SEQ, seed=s,
                          device="cuda") for s in range(GRAPH_STEPS)]
    runs, peaks = {}, {}
    for label in ("eager", "graphed"):
        torch.cuda.empty_cache()
        eng = SPBEngine(cfg, tcfg, spb, device="cuda")
        eng.init_state(0)
        if label == "graphed":
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.compile_table(eng.batch_specs_like(batches[0]),
                              depths=GRAPH_DEPTHS)
            torch.cuda.synchronize()
            capture_s = time.perf_counter() - t0
            pools = {d: eng.memory_analysis(d) for d in GRAPH_DEPTHS}
            replay = {d: eng._graphs[d].graph.launches for d in GRAPH_DEPTHS}
        torch.cuda.reset_peak_memory_stats()
        runs[label] = _train_run(eng, batches, label)
        peaks[label] = torch.cuda.max_memory_allocated()
        params = [t.detach().cpu() for t in tree_leaves(eng.state["params"])]
        runs[label + "_params"] = params
        if label == "graphed":
            eng.export_aot(table_dir)
        del eng
    eager, graphed = runs["eager"], runs["graphed"]
    for e, g in zip(eager, graphed):
        if e["depth"] != g["depth"]:
            raise AssertionError(f"graphs: depth {g['depth']} != eager "
                                 f"{e['depth']}")
        for k in ("loss", "grad_norm", "lr"):
            if not torch.equal(e[k], g[k]):
                raise AssertionError(f"graphs: depth {e['depth']} {k} "
                                     f"{g[k].item()!r} != eager "
                                     f"{e[k].item()!r}")
        if g["launches"] != e["launches"] or \
                g["launches"] != expected_launches(cfg, [g["depth"]]):
            raise AssertionError(f"graphs: a graphed step launched "
                                 f"{g['launches']}, eager {e['launches']}")
    for d, got in replay.items():
        eager_d = next(r["launches"] for r in eager if r["depth"] == d)
        if got != {n: c for n, c in eager_d.items() if c}:
            raise AssertionError(f"graphs: depth {d}'s replay launches "
                                 f"{got} != an eager step's {eager_d}")
    differ = [i for i, (a, b) in enumerate(zip(runs["eager_params"],
                                               runs["graphed_params"]))
              if not torch.equal(a, b)]
    if differ:
        raise AssertionError(f"graphs: {len(differ)} parameter leaves "
                             f"differ from eager after {GRAPH_STEPS} steps")
    warm = {label: {d: [r["ms"] for r in rows[4:] if r["depth"] == d]
                    for d in GRAPH_DEPTHS}
            for label, rows in (("eager", eager), ("graphed", graphed))}
    log(f"[graphs] train yi-6b bit_equal=True steps={GRAPH_STEPS} "
        f"lrs={[float(r['lr']) for r in graphed]} params_equal="
        f"{len(runs['eager_params'])}/{len(runs['eager_params'])} "
        f"replay_launches={ {d: l for d, l in replay.items()} } "
        f"capture_s={capture_s:.2f}")
    log(f"[graphs] train yi-6b warm_step_ms eager={warm['eager']} "
        f"graphed={warm['graphed']}")
    log(f"[graphs] train yi-6b pool_bytes={pools} "
        f"max_memory_allocated_gb eager={peaks['eager'] / 1e9:.2f} "
        f"graphed={peaks['graphed'] / 1e9:.2f}")
    grew = {}
    for r in graphed:
        for n, c in r["launches"].items():
            grew[n] = grew.get(n, 0) + c
    return {"launches": {n: c for n, c in grew.items() if c},
            "first_loss": float(graphed[0]["loss"]),
            "warm_ms": warm, "pools": pools,
            "peak_gb": {k: v / 1e9 for k, v in peaks.items()}}


def _run_child(code: str, *args: str, env=None, timeout: int = 300) -> dict:
    """Run ``code`` in a fresh Python from the repository root; its last
    output line is JSON."""
    res = subprocess.run([sys.executable, "-c", code, *args], env=env,
                         cwd=Path(__file__).resolve().parent,
                         capture_output=True, text=True, timeout=timeout)
    if res.returncode:
        raise AssertionError(f"child failed ({res.returncode}):\n"
                             f"{res.stdout[-2000:]}\n{res.stderr[-3000:]}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def phase_graphs() -> dict:
    """The graphs phase (run after 14, before 15): (a) serving and (b)
    training, eager against the step table (:func:`phase_graphs_serve`,
    :func:`phase_graphs_train`); (c) a fresh process with ``nvcc`` out of
    reach (``CUDA_HOME`` unset, ``PATH`` without the toolkit, every build
    refused, an empty build directory) loads (b)'s stored table, its
    libraries from the table, and its first graphed step's loss equals
    (b)'s; (d) ``launch/train.py --compilation-cache-dir`` twice into an
    empty directory: first a miss, then a hit; (e) a step that syncs the
    host fails to capture and ``compile_table`` raises, the eager entry
    kept.  Returns the launches of the graphed runs by part."""
    import os
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    import torch

    tmp = tempfile.TemporaryDirectory(prefix="graphs_")
    root = Path(tmp.name)
    env = {k: v for k, v in os.environ.items()
           if k not in ("CUDA_HOME", "CUDA_PATH")}
    env["PATH"] = os.pathsep.join(p for p in env.get("PATH", "").split(
        os.pathsep) if "cuda" not in p.lower())
    cc = root / "cc"
    flags = ["-m", "repro_torch.launch.train", "--arch", "yi-6b", "--steps",
             "1", "--batch", "2", "--seq", "64", "--spb-mode", "temporal",
             "--use-pallas", "--compilation-cache-dir", str(cc)]

    def cc_runs() -> list:
        lines = []
        for _ in range(2):
            res = subprocess.run(
                [sys.executable, *flags], capture_output=True, text=True,
                timeout=600, cwd=Path(__file__).resolve().parent,
                env=dict(os.environ, PYTHONPATH=str(
                    Path(__file__).resolve().parent / "src")))
            cc_line = [ln for ln in res.stdout.splitlines()
                       if ln.startswith("[cc]")]
            if res.returncode or len(cc_line) != 1:
                raise AssertionError(f"graphs: --compilation-cache-dir run "
                                     f"failed:\n{res.stdout[-2000:]}\n"
                                     f"{res.stderr[-2000:]}")
            lines.append(cc_line[0])
        return lines

    # (c), (d) and (e) are processes of their own that share nothing with
    # this one but the card: (d) (its builds, then two reduced steps) and
    # (e) (a reduced engine) start first and run beside (a) and (b); (c)
    # needs (b)'s stored table
    with ThreadPoolExecutor(3) as pool:
        cached = pool.submit(cc_runs)
        capture = pool.submit(_run_child, _CAPTURE_FAILS)
        serve = phase_graphs_serve()
        train = phase_graphs_train(root / "table")
        torch.cuda.empty_cache()
        fresh = pool.submit(_run_child, _FRESH_LOAD, str(root / "table"),
                            str(GRAPH_STEPS), env=env)
        got, lines, fails = (f.result() for f in (fresh, cached, capture))
    stray = {n: p for n, p in got["libs"].items()
             if Path(p).parent != root / "table"}
    if not got["loaded"] or stray or got["loss"] != train["first_loss"]:
        raise AssertionError(f"graphs: the fresh process loaded={got} "
                             f"(libraries off the table: {stray}; loss "
                             f"{got['loss']} against {train['first_loss']})")
    log(f"[graphs] fresh_process load_aot=True nvcc_reachable=False "
        f"builds=0 keys={got['keys']} libs={sorted(got['libs'])} "
        f"first_loss_equal=True")
    for line in lines:
        log(f"[graphs] {line}")
    if "(miss)" not in lines[0] or "(hit" not in lines[1]:
        raise AssertionError(f"graphs: the compilation cache went {lines}, "
                             f"not a miss then a hit")
    if not fails.get("raised") or fails["compiled"] or \
            not fails["eager_kept"]:
        raise AssertionError(f"graphs: a failed capture gave {fails}")
    log(f"[graphs] capture_failure raised={fails['raised']!r} "
        f"compiled={fails['compiled']} eager_entry_kept=True")
    tmp.cleanup()
    return {"serve_yi-6b": serve, "train_yi-6b": train["launches"]}


# the recompute phase: per arch, the SPB depths its steps run, in order,
# at phase 5's cut and batch (the first step warms up; a shallow depth
# first, so the frozen prefix's kernels run too) and the policies held
# against 'none'
REMAT_RUNS = {
    "yi-6b": ((2, 2, 2, 8, 8, 8), ("none", "dots", "full")),
    "mamba2-2.7b": ((8, 32, 32, 32), ("none", "full")),
    "recurrentgemma-2b": ((3, 12, 12, 12), ("none", "full")),
    "seamless-m4t-medium": ((6, 24, 24, 24), ("none", "full")),
}


def _leaf_names(tree, prefix: str = "") -> list:
    if isinstance(tree, dict):
        return [n for k in tree for n in _leaf_names(tree[k],
                                                     f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [n for i, v in enumerate(tree)
                for n in _leaf_names(v, f"{prefix}{i}/")]
    return [prefix.rstrip("/")]


def _remat_run(cfg, depths, batches, remat: str, *, graphed: bool = False):
    """One engine under ``remat`` from seed 0 over ``batches`` at
    ``depths`` (graphed: its step table captured at those depths first);
    each step's loss, grad norm, ms, peak and launches, checked against
    :func:`expected_launches`; the params after the run (host copies)."""
    import gc

    import torch
    from repro_torch.config import SPBConfig, TrainConfig
    from repro_torch.engine.engine import SPBEngine
    from repro_torch.tree import tree_leaves

    gc.collect()        # an earlier engine's graphs and state, in cycles
    torch.cuda.empty_cache()
    # what earlier phases leave allocated: in every step's peak, none of
    # the step's own
    leftover = torch.cuda.memory_allocated()
    eng = SPBEngine(cfg, TrainConfig(num_steps=len(depths)),
                    SPBConfig(mode="temporal", k=4), device="cuda",
                    remat=remat)
    eng.init_state(0)
    out = {"pool_gb": None, "leftover_gb": leftover / 1e9}
    if graphed:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.compile_table(eng.batch_specs_like(batches[0]),
                          depths=sorted(set(depths)))
        torch.cuda.synchronize()
        out["capture_s"] = time.perf_counter() - t0
        out["pool_gb"] = eng.memory_analysis(depths[-1])[
            "pool_total_bytes"] / 1e9
    label = f"{cfg.name} {remat}{' graphed' if graphed else ''}"
    zero_launches()
    rows = []
    for s, (d, batch) in enumerate(zip(depths, batches)):
        before = launches_now()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = eng.train_step(batch, s, depth=d)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        grew = check_launches(f"remat {label} step {s}", before, [d], cfg,
                              remat)
        row = {"depth": d, "ms": ms,
               "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
               "launches": {n: c for n, c in grew.items() if c},
               **{k: m[k].detach().cpu() for k in ("loss", "grad_norm")}}
        if not math.isfinite(float(row["loss"])):
            raise AssertionError(f"remat {label}: loss not finite at {s}")
        rows.append(row)
    out["launches"] = {n: c for n, c in launches_now().items() if c}
    out["rows"] = rows
    out["params"] = [t.detach().cpu() for t in tree_leaves(
        eng.state["params"])]
    out["names"] = _leaf_names(eng.state["params"])
    del eng
    torch.cuda.empty_cache()
    return out


def _hold_to(label: str, got: dict, want: dict) -> dict:
    """``got``'s losses, grad norms and params against ``want``'s: bit
    for bit, or, where a value differs, within ``TOL`` (named in the
    result)."""
    import torch
    differ = {}
    pairs = [(f"step {i} {k}", a[k], b[k])
             for i, (a, b) in enumerate(zip(got["rows"], want["rows"]))
             for k in ("loss", "grad_norm")]
    pairs += list(zip(got["names"], got["params"], want["params"]))
    for name, a, b in pairs:
        if torch.equal(a, b):
            continue
        a32, b32 = a.float(), b.float()
        atol, rtol = TOL[str(b.dtype).replace("torch.", "")]
        err = float((a32 - b32).abs().max())
        if not torch.allclose(a32, b32, atol=atol, rtol=rtol):
            raise AssertionError(f"remat {label}: {name} differs by {err} "
                                 f"beyond {(atol, rtol)}")
        differ[name] = err
    return differ


def phase_remat() -> dict:
    """Phase 17 (run after 16): the layer recompute at phase 5's cuts,
    batch 2 x 2048.  Each arch of :data:`REMAT_RUNS` trains from one seed
    over the same batches and depths under each policy: every step's
    launches exactly :func:`expected_launches` under that policy (a live
    layer's forward kernel twice), its ms and ``max_memory_allocated``,
    and the losses, grad norms and updated parameters bit-equal to
    'none''s (a difference is named and held within ``TOL``).  Then
    yi-6b's step table captured under 'full' (and under 'none', for its
    pool) at depths 2 and 8: each replay bit-equal to the eager 'full'
    run, and the pools' bytes.  Returns {arch: {policy: figures}}."""
    from repro_torch.configs import (FULL_WIDTH_BATCH, FULL_WIDTH_SEQ,
                                     full_width_config, make_batch)

    t0 = time.perf_counter()
    out = {}
    for arch, (depths, policies) in REMAT_RUNS.items():
        cfg = full_width_config(arch)
        batches = [make_batch(cfg, FULL_WIDTH_BATCH, FULL_WIDTH_SEQ, seed=s,
                              device="cuda") for s in range(len(depths))]
        runs = {}
        for remat in policies:
            runs[remat] = _remat_run(cfg, depths, batches, remat)
        if arch == "yi-6b":
            for remat in ("full", "none"):
                runs[remat + "_graphed"] = _remat_run(
                    cfg, depths, batches, remat, graphed=True)
        out[arch] = {}
        for label, run in runs.items():
            base = runs[label.split("_")[0]] if "graphed" in label \
                else runs["none"]
            differ = _hold_to(f"{arch} {label}", run, base)
            # a step after one at its own depth is warm; a depth run once
            # (the shallow one of the SSD, RG-LRU and encoder paths) keeps
            # its only step for its peak
            warm, every = {}, {}
            for i, r in enumerate(run["rows"]):
                every.setdefault(r["depth"], []).append(r)
                if i and r["depth"] == run["rows"][i - 1]["depth"]:
                    warm.setdefault(r["depth"], []).append(r)
            fig = {"warm_ms": {d: [round(r["ms"], 2) for r in rs]
                               for d, rs in warm.items()},
                   "peak_gb": {d: round(max(r["peak_gb"] for r in
                                            warm.get(d, rs)), 3)
                               for d, rs in every.items()},
                   "launches_a_step": {d: rs[0]["launches"]
                                       for d, rs in every.items()},
                   "launches": run["launches"], "differ": differ,
                   "pool_gb": run["pool_gb"],
                   "leftover_gb": round(run["leftover_gb"], 3)}
            out[arch][label] = fig
            base_label = ("eager " + label.split("_")[0]
                          if "graphed" in label else "none")
            log(f"[remat] {arch} {label} depths={list(depths)} "
                f"warm_step_ms={fig['warm_ms']} max_mem_gb={fig['peak_gb']} "
                f"leftover_gb={fig['leftover_gb']} "
                f"launches_a_step={fig['launches_a_step']} "
                f"bit_equal_to_{base_label.replace(' ', '_')}={not differ} "
                f"differ={differ}"
                + (f" pool_gb={run['pool_gb']:.2f} "
                   f"capture_s={run['capture_s']:.2f}"
                   if run["pool_gb"] is not None else ""))
        del runs
    log(f"[remat] phase {time.perf_counter() - t0:.1f}s")
    return out


def phase_remat_dryrun(remat: dict) -> dict:
    """With phase 15 (host only): the dry run of each recompute run's
    config and depths under each policy (``launch/dryrun.py --remat``):
    counted TFLOP, predicted peak (state + temporaries) and saved GB
    beside phase 17's ``max_memory_allocated``, also less what earlier
    phases left allocated before the run.  Fails when the counted
    FLOPs do not rise or the saved bytes do not fall from 'none' to
    'dots' to 'full', or a kernel was launched."""
    import tempfile
    from repro_torch.configs import FULL_WIDTH_BATCH, FULL_WIDTH_SEQ
    from repro_torch.launch import dryrun

    before = launches_now()
    tmp = tempfile.TemporaryDirectory(prefix="dryrun_remat_")
    out = {}
    for arch, (depths, policies) in REMAT_RUNS.items():
        out[arch] = {}
        for d in sorted(set(depths)):
            counted = []
            for pol in policies:
                rec = dryrun.run_cell(arch, "train_4k", cut="full_width",
                                      depth=d, batch=FULL_WIDTH_BATCH,
                                      seq_len=FULL_WIDTH_SEQ, force=True,
                                      out_dir=tmp.name, remat=pol)
                if not rec.get("ok"):
                    raise AssertionError(f"dry run of {arch} at {d} under "
                                         f"{pol}: {rec.get('error')}")
                ma = rec["memory_analysis"]
                row = {"tflop": rec["flops_per_device"] / 1e12,
                       "gb": rec["bytes_per_device"] / 1e9,
                       "saved_gb": rec["saved_bytes"] / 1e9,
                       "predicted_peak_gb": (ma["argument_size_in_bytes"]
                                             + ma["temp_size_in_bytes"]) / 1e9,
                       "max_mem_gb": remat[arch][pol]["peak_gb"][d],
                       "leftover_gb": remat[arch][pol]["leftover_gb"]}
                out[arch][f"{pol}@{d}"] = row
                counted.append((rec["flops_per_device"], rec["saved_bytes"]))
                log(f"[remat-dryrun] {arch} depth={d} remat={pol} "
                    f"tflop={row['tflop']:.3f} gb={row['gb']:.2f} "
                    f"saved_gb={row['saved_gb']:.2f} predicted_peak_gb="
                    f"{row['predicted_peak_gb']:.2f} max_mem_gb="
                    f"{row['max_mem_gb']} less_leftover_gb="
                    f"{row['max_mem_gb'] - row['leftover_gb']:.3f}")
            flops, saved = zip(*counted)
            if not (all(a < b for a, b in zip(flops, flops[1:]))
                    and all(a > b for a, b in zip(saved, saved[1:]))):
                raise AssertionError(f"dry run of {arch} at {d}: FLOPs "
                                     f"{flops} and saved bytes {saved} over "
                                     f"{policies}")
    tmp.cleanup()
    if launches_since(before) != dict.fromkeys(KERNELS, 0):
        raise AssertionError("the recompute's dry run launched a kernel")
    return out


# ---------------------------------------------------------------------------
# Phase 18: the data-parallel group and spatial SPB, ranks sharing the card
# ---------------------------------------------------------------------------

# phase 18 (a): (run, mode, k, subgroup_reduce) on yi-6b-reduced, f32, 4 ranks
DP_REDUCED_RANKS = 4
DP_REDUCED_RUNS = (("spatial_k4", "spatial", 4, False),
                   ("spatial_k2", "spatial", 2, False),
                   ("spatial_k2_sub", "spatial", 2, True),
                   ("temporal_k2", "temporal", 2, False))
# phase 18 (b): yi-6b at published widths cut to 2 layers, bf16, 2 ranks of
# one row of 2048 each, k 2: (run, mode, subgroup_reduce).  At 4 layers the
# dry run counted a rank's peak at 24.33 GB (state 13.36 GB and 10.97 GB of
# temporaries); at 2 (608,194,560 parameters) two ranks leave the card room
# for phase 19 (d) and the reduced grids of phases 22 and 23, which run
# beside phases 18 (b) and 19 (b, c) (``main``)
DP_FULL_RANKS = 2
DP_FULL_LAYERS = 2
DP_FULL_K = 2
DP_FULL_RUNS = (("temporal", "temporal", False), ("spatial", "spatial", False),
                ("spatial_sub", "spatial", True))
DP_JOIN_S = 900.0
# phase 18 (a), card against CPU after 2 steps: the relative gap of each
# step's grad norm, and the relative L2 distance, over the whole tree, of
# AdamW's first moment (the clipped gradients' running mean) and of the
# parameters' change (params - init).  A loss moves ~4e-4 in 2 steps at
# the warm-up lr and a parameter ~6e-5, so phase 4's 1e-3 on the loss
# and on the parameters could not see a wrong gradient; these can.  The
# change's limit is wider: AdamW's second step divides by a running RMS
# that nearly cancels for a few elements, so the f32 rounding shows more
# there (1.3e-4 at k 2 on an H100, against 1e-6 in the moment; a planted
# weighting fault moves it 7e-3 and the moment 0.39; PERF.md, §6)
DP_GNORM_TOL = 1e-4
DP_MOMENT_TOL = 1e-4
DP_UPDATE_TOL = 1e-3


def _rank_depth(eng):
    """The suffix depth of the engine's last step on this rank."""
    if eng.spb.mode == "spatial":
        from repro_torch.core import spb as spb_lib
        return spb_lib.snapped_depths(eng.cfg, eng.spb)[
            eng.group.rank % eng.spb.k]
    return eng.last_depth


def _params_numpy(params) -> dict:
    """A param tree as f32 numpy arrays by leaf name."""
    from repro_torch.tree import tree_leaves
    return {n: t.detach().float().cpu().numpy()
            for n, t in zip(_leaf_names(params), tree_leaves(params))}


def _params_digest(params) -> str:
    """sha256 of every parameter's bits, in leaf order."""
    import hashlib
    import torch
    from repro_torch.tree import tree_leaves
    h = hashlib.sha256()
    for t in tree_leaves(params):
        t = t.detach().contiguous()
        h.update(t.view(torch.uint8 if t.element_size() == 1 else
                        {2: torch.int16, 4: torch.int32}[t.element_size()]
                        ).cpu().numpy().tobytes())
    return h.hexdigest()


def dp_rank_reduced(group) -> dict:
    """Phase 18 (a), one rank: each run of :data:`DP_REDUCED_RUNS` for 2
    steps from the seeded weights (:func:`dp_reduced_init`), on the card
    and then on the CPU (the same process group), this rank's rows of each
    global batch: each step's loss, grad norm, depth and launches, and
    the final parameters and AdamW first moment."""
    import torch
    from repro_torch.config import SPBConfig, TrainConfig
    from repro_torch.configs import reduced_config
    from repro_torch.data.pipeline import Pipeline
    from repro_torch.dist import steps as steps_lib
    from repro_torch.engine.engine import SPBEngine
    from repro_torch.tree import tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(reduced_config("yi-6b"), use_pallas=True)
    tcfg = TrainConfig(num_steps=2)
    params = dp_reduced_init(cfg)
    out = {}
    for name, mode, k, sub in DP_REDUCED_RUNS:
        spb = SPBConfig(mode=mode, k=k, subgroup_reduce=sub)
        out[name] = {}
        for dev in ("cuda", "cpu"):
            # the same process group (and subgroups): gloo takes both
            g = group if dev == "cuda" else dataclasses.replace(
                group, device=torch.device("cpu"))
            # replicated, as phase 18 ran before ZeRO-1 (phase 19)
            eng = SPBEngine(cfg, tcfg, spb, group=g, shared_cache=False,
                            zero1=False)
            eng.attach_state(steps_lib.state_from_params(
                tree_map(torch.clone, params), tcfg))
            pipe = Pipeline(cfg, DP_REDUCED_RANKS, 64, seed=0)
            run = {"losses": [], "grad_norms": [], "depths": [],
                   "launches": []}
            for s in range(2):
                before = launches_now()
                m = eng.train_step(g.shard(pipe.get_batch(s)), s)
                run["losses"].append(float(m["loss"]))
                run["grad_norms"].append(float(m["grad_norm"]))
                run["depths"].append(_rank_depth(eng))
                run["launches"].append(launches_since(before))
            run["params"] = _params_numpy(eng.state["params"])
            run["mu"] = _params_numpy(eng.state["opt"]["mu"])
            out[name][dev] = run
    return out


def dp_reduced_init(cfg):
    """Phase 18 (a)'s initial weights, drawn on the CPU (the card's
    generator draws other numbers from the same seed)."""
    import torch
    from repro_torch.models import lm
    return lm.init_lm(torch.Generator().manual_seed(0), cfg, "cpu")


def _rel_l2(got: dict, want: dict) -> float:
    """||got - want|| / ||want||, over every leaf of two trees of numpy
    arrays by leaf name, in f64."""
    import numpy as np
    num = sum(float(np.sum((got[n].astype(np.float64) - v) ** 2))
              for n, v in want.items())
    den = sum(float(np.sum(v.astype(np.float64) ** 2)) for v in want.values())
    return math.sqrt(num / den)


def phase_data_parallel_reduced() -> dict:
    """Phase 18 (a): four ranks share the card over gloo (yi-6b-reduced,
    f32, kernels on) in the runs of :data:`DP_REDUCED_RUNS`: every rank's
    parameters bit-identical to rank 0's, on the card and on the CPU;
    losses and parameters card against CPU within phase 4's 1e-3
    relative; the parameters' change, AdamW's first moment and each
    step's grad norm card against CPU within :data:`DP_UPDATE_TOL`,
    :data:`DP_MOMENT_TOL` and :data:`DP_GNORM_TOL`; each card step's
    launches ``expected_launches`` at the rank's depth (none on the CPU).
    Logs every rank's figures before it raises at any that failed.
    Returns each run's launches a rank."""
    import numpy as np
    from repro_torch.configs import reduced_config
    from repro_torch.launch import mesh

    cfg = dataclasses.replace(reduced_config("yi-6b"), use_pallas=True)
    init = _params_numpy(dp_reduced_init(cfg))
    t0 = time.perf_counter()
    ranks = mesh.spawn("chip_smoke:dp_rank_reduced", DP_REDUCED_RANKS,
                       device="cuda", threads=2, timeout_s=DP_JOIN_S)
    launches, failed = {}, []
    for name, mode, k, sub in DP_REDUCED_RUNS:
        for dev in ("cuda", "cpu"):
            want = ranks[0][name][dev]["params"]
            for r, out in enumerate(ranks):
                got = out[name][dev]["params"]
                if not all(np.array_equal(got[n], want[n]) for n in want):
                    failed.append(f"{name} {dev}: rank {r}'s parameters "
                                  f"differ from rank 0's")
        for r, out in enumerate(ranks):
            card, cpu = out[name]["cuda"], out[name]["cpu"]
            where = f"{name} rank {r}"
            loss = max(abs(a - b) / abs(b)
                       for a, b in zip(card["losses"], cpu["losses"]))
            gnorm = max(abs(a - b) / b for a, b in zip(card["grad_norms"],
                                                       cpu["grad_norms"]))
            update = _rel_l2(
                {n: card["params"][n] - v for n, v in init.items()},
                {n: cpu["params"][n] - v for n, v in init.items()})
            moment = _rel_l2(card["mu"], cpu["mu"])
            for what, got, tol in (("loss", loss, 1e-3),
                                   ("grad norm", gnorm, DP_GNORM_TOL),
                                   ("parameter change", update,
                                    DP_UPDATE_TOL),
                                   ("first moment", moment, DP_MOMENT_TOL)):
                if not got <= tol:
                    failed.append(f"{where}: {what} card vs CPU {got:.3e} "
                                  f"> {tol:g}")
            for s, (d, grew) in enumerate(zip(card["depths"],
                                              card["launches"])):
                if grew != expected_launches(cfg, [d]):
                    failed.append(f"{where} step {s}: launches {grew} != "
                                  f"{expected_launches(cfg, [d])}")
            if any(any(g.values()) for g in cpu["launches"]):
                failed.append(f"{where}: a CPU step launched a kernel")
            launches[f"{name}/rank{r}"] = {
                n: sum(g[n] for g in card["launches"]) for n in KERNELS}
            log(f"[data-parallel] {name} rank={r} depths={card['depths']} "
                f"loss_cuda={card['losses']} loss_cpu={cpu['losses']} "
                f"gnorm_cuda={card['grad_norms']} "
                f"gnorm_cpu={cpu['grad_norms']} card_vs_cpu: "
                f"loss={loss:.3e} (tol 1e-3) gnorm={gnorm:.3e} "
                f"(tol {DP_GNORM_TOL:g}) update_l2={update:.3e} "
                f"(tol {DP_UPDATE_TOL:g}) moment_l2={moment:.3e} "
                f"(tol {DP_MOMENT_TOL:g}) launches="
                f"{ {n: c for n, c in launches[f'{name}/rank{r}'].items() if c} }")
    log(f"[data-parallel] reduced phase {time.perf_counter() - t0:.1f}s")
    if failed:
        raise AssertionError("data-parallel: " + "; ".join(failed))
    return launches


def dp_full_config():
    from repro_torch.configs import full_width_config
    return dataclasses.replace(full_width_config("yi-6b"),
                               num_layers=DP_FULL_LAYERS)


def dp_rank_full(group) -> dict:
    """Phase 18 (b), one rank: yi-6b's 2-layer cut in each mode of
    :data:`DP_FULL_RUNS` (one state carried through them), 2 timed steps
    then the counted ones (one cycle of ``temporal``, one ``spatial``
    step) under ``analysis/cost.CostMode``; each step's ms, host ms inside
    the collectives, launches and depth, the counted all-reduces, the
    peak allocation and a digest of the parameters after each mode."""
    import gc
    import torch
    from repro_torch.analysis import cost
    from repro_torch.config import SPBConfig, TrainConfig
    from repro_torch.configs import make_batch
    from repro_torch.engine.engine import SPBEngine

    cfg = dp_full_config()
    tcfg = TrainConfig(num_steps=10)
    rows = 1
    state, out = None, {}
    for name, mode, sub in DP_FULL_RUNS:
        spb = SPBConfig(mode=mode, k=DP_FULL_K, subgroup_reduce=sub)
        eng = SPBEngine(cfg, tcfg, spb, group=group, shared_cache=False,
                        zero1=False)
        if state is None:
            eng.init_state(0)
        else:
            eng.attach_state(state)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        run = {"steps": [], "counted": []}
        counted = DP_FULL_K if mode == "temporal" else 1
        for i in range(2 + counted):
            s = eng.state["step"]
            batch = group.shard(make_batch(cfg, rows * group.size, 2048,
                                           seed=s, device="cuda"))
            before, r0 = launches_now(), group.reduce_s
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if i < 2:
                m = eng.train_step(batch, s)
            else:
                with cost.CostMode() as mode_:
                    m = eng.train_step(batch, s)
            loss = float(m["loss"])
            torch.cuda.synchronize()
            step = {"ms": (time.perf_counter() - t0) * 1e3,
                    "reduce_ms": (group.reduce_s - r0) * 1e3,
                    "depth": _rank_depth(eng), "loss": loss,
                    "launches": launches_since(before)}
            if i < 2:
                run["steps"].append(step)
            else:
                step["collectives"] = mode_.summary.collectives()
                run["counted"].append(step)
        run["max_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        run["digest"] = _params_digest(eng.state["params"])
        out[name] = run
        state = eng.state
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    return out


def dp_reckoning(cfg, mode: str, depth, sub: bool) -> dict:
    """The all-reduce payload one rank's step should count (PERF.md's
    reckoning): ``temporal`` at ``depth`` the non-layer leaves and the live rows
    of every layer leaf plus the three f32 metrics; ``spatial`` every leaf
    and the two f32 metrics (loss, xent), and with the re-reduce every
    row whose contributor count is above 1 once more."""
    import torch
    from repro_torch.config import SPBConfig, total_layers
    from repro_torch.core import spb as spb_lib
    from repro_torch.models import lm
    from repro_torch.tree import tree_leaves

    shapes = lm.param_shapes(cfg)
    nbytes = lambda t: t.numel() * t.element_size()
    row = sum(nbytes(t[0]) for t in tree_leaves(shapes["groups"]))
    other = sum(nbytes(t) for t in tree_leaves(
        {k: v for k, v in shapes.items() if k != "groups"}))
    f32 = torch.tensor(0.0).element_size()
    calls = len(tree_leaves(shapes)) + 1            # the leaves, the metrics
    if mode == "temporal":
        return {"count": calls,
                "payload_bytes": other + depth * row + 3 * f32}
    payload = other + total_layers(cfg) * row + 2 * f32
    if sub:
        spb = SPBConfig(mode="spatial", k=DP_FULL_K, subgroup_reduce=True)
        per_level = max(1, DP_FULL_RANKS // DP_FULL_K)
        live = [c * per_level for c in spb_lib.layer_contributors(cfg, spb)]
        again = sum(1 for c in live if c > 1)
        payload += again * row
        calls += again * len(tree_leaves(shapes["groups"]))
    return {"count": calls, "payload_bytes": payload}


def phase_data_parallel_full() -> dict:
    """Phase 18 (b) and (c): two ranks of yi-6b's 2-layer cut share the
    card over gloo in each mode of :data:`DP_FULL_RUNS`: the replicas'
    parameters bit-identical after every mode, every step's launches
    ``expected_launches`` at the rank's depth, finite losses, and each
    counted step's all-reduce calls and payload exactly
    :func:`dp_reckoning`'s, its wire bytes the ring model's.  Prints a
    line a rank and mode: step ms, host ms inside the collectives,
    counts, peak allocation.  Returns the launches and the figures."""
    from repro_torch.analysis import cost
    from repro_torch.launch import mesh

    cfg = dp_full_config()
    t0 = time.perf_counter()
    ranks = mesh.spawn("chip_smoke:dp_rank_full", DP_FULL_RANKS,
                       device="cuda", timeout_s=DP_JOIN_S)
    launches, figures = {}, {}
    for name, mode, sub in DP_FULL_RUNS:
        digests = {out[name]["digest"] for out in ranks}
        if len(digests) != 1:
            raise AssertionError(f"data-parallel full {name}: the replicas' "
                                 f"parameters differ")
        for r, out in enumerate(ranks):
            run = out[name]
            for step in run["steps"] + run["counted"]:
                want = expected_launches(cfg, [step["depth"]])
                if step["launches"] != want:
                    raise AssertionError(
                        f"data-parallel full {name} rank {r}: launches "
                        f"{step['launches']} != {want}")
                if not math.isfinite(step["loss"]):
                    raise AssertionError(f"data-parallel full {name} rank "
                                         f"{r}: loss not finite")
            counted = []
            for step in run["counted"]:
                c = step["collectives"].get("all-reduce", {})
                want = dp_reckoning(cfg, mode, step["depth"], sub)
                wire = cost.wire_bytes("all-reduce", DP_FULL_RANKS,
                                       want["payload_bytes"])
                got = (c.get("count"), c.get("payload_bytes"),
                       c.get("wire_bytes"))
                if got != (want["count"], want["payload_bytes"], wire):
                    raise AssertionError(
                        f"data-parallel full {name} rank {r} depth "
                        f"{step['depth']}: counted (calls, payload, wire) "
                        f"{got} != the reckoning's "
                        f"{(want['count'], want['payload_bytes'], wire)}")
                counted.append({"depth": step["depth"], "calls": got[0],
                                "payload_bytes": got[1],
                                "wire_bytes": got[2]})
            key = f"{name}/rank{r}"
            launches[key] = {n: sum(s["launches"][n] for s in
                                    run["steps"] + run["counted"])
                             for n in KERNELS}
            figures[key] = {
                "depths": [s["depth"] for s in run["steps"]],
                "step_ms": [round(s["ms"], 2) for s in run["steps"]],
                "reduce_ms": [round(s["reduce_ms"], 2)
                              for s in run["steps"]],
                "counted": counted,
                "max_mem_gb": round(run["max_mem_gb"], 3)}
            log(f"[data-parallel] full yi-6b/{DP_FULL_LAYERS} {name} "
                f"rank={r} depths={figures[key]['depths']} "
                f"step_ms={figures[key]['step_ms']} "
                f"reduce_host_ms={figures[key]['reduce_ms']} "
                f"allreduce={counted} "
                f"max_mem_gb={figures[key]['max_mem_gb']} "
                f"losses={[round(s['loss'], 4) for s in run['steps']]} "
                f"launches={ {n: c for n, c in launches[key].items() if c} } "
                f"(each step expected_launches at its depth) "
                f"replicas=bit-identical")
    log(f"[data-parallel] full phase {time.perf_counter() - t0:.1f}s")
    return {"launches": launches, "figures": figures}


# ---------------------------------------------------------------------------
# Phase 19: ZeRO-1 over the data group, and restart under a group
# ---------------------------------------------------------------------------

# phase 19 (a): (run, mode, k) on yi-6b-reduced, f32, 2 ranks of 2 rows
ZERO_REDUCED_RANKS = 2
ZERO_REDUCED_RUNS = (("temporal_k2", "temporal", 2),
                     ("spatial_k2", "spatial", 2))
# phase 19 (b): phase 18's 2-layer cut, bf16, temporal k 2, 2 ranks of one
# row of 2048, ZeRO-1 off then on; (c) 4 ranks of it with ZeRO-1
ZERO_FULL_K = 2
ZERO_FOUR_RANKS = 4
# the least a ZeRO-1 rank's peak must fall under the replicated rank's at
# n 2, as a share of the state's fall (12 of its 14 bytes a parameter
# halve: 6 B a parameter, 5.7 GB at 4 layers, where the bound was 5.0 GB)
ZERO_PEAK_DROP_SHARE = 0.87


def zero1_rank_reduced(group) -> dict:
    """Phase 19 (a), one rank: each run of :data:`ZERO_REDUCED_RUNS` with
    ZeRO-1 off, then on, from phase 18's seeded weights
    (:func:`dp_reduced_init`), 2 steps on the card and then on the CPU
    (the same process group), this rank's rows of each global batch:
    each step's loss, grad norm, depth and launches, the parameters, and
    on rank 0 the gathered state (parameters and AdamW's moments)."""
    import torch
    from repro_torch.config import SPBConfig, TrainConfig
    from repro_torch.configs import reduced_config
    from repro_torch.data.pipeline import Pipeline
    from repro_torch.dist import steps as steps_lib
    from repro_torch.engine.engine import SPBEngine
    from repro_torch.tree import tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(reduced_config("yi-6b"), use_pallas=True)
    tcfg = TrainConfig(num_steps=2)
    params = dp_reduced_init(cfg)
    out = {}
    for name, mode, k in ZERO_REDUCED_RUNS:
        for dev in ("cuda", "cpu"):
            g = group if dev == "cuda" else dataclasses.replace(
                group, device=torch.device("cpu"))
            for zero1 in (False, True):
                eng = SPBEngine(cfg, tcfg, SPBConfig(mode=mode, k=k),
                                group=g, shared_cache=False, zero1=zero1)
                eng.attach_state(steps_lib.state_from_params(
                    tree_map(torch.clone, params), tcfg))
                pipe = Pipeline(cfg, 2 * ZERO_REDUCED_RANKS, 64, seed=0)
                run = {"losses": [], "grad_norms": [], "depths": [],
                       "launches": []}
                for s in range(2):
                    before = launches_now()
                    m = eng.train_step(g.shard(pipe.get_batch(s)), s)
                    run["losses"].append(float(m["loss"]))
                    run["grad_norms"].append(float(m["grad_norm"]))
                    run["depths"].append(_rank_depth(eng))
                    run["launches"].append(launches_since(before))
                run["params"] = _params_numpy(eng.state["params"])
                whole = eng.gathered_state()
                run["whole"] = None if whole is None else {
                    key: _params_numpy(tree) for key, tree in (
                        ("params", whole["params"]),
                        ("mu", whole["opt"]["mu"]),
                        ("nu", whole["opt"]["nu"]))}
                out[name, dev, zero1] = run
    return out


def _same_arrays(got: dict, want: dict) -> bool:
    """Two trees of numpy arrays by leaf name, bit for bit."""
    import numpy as np
    return set(got) == set(want) and all(
        np.array_equal(got[n], want[n]) for n in want)


def phase_zero1_reduced() -> dict:
    """Phase 19 (a): two ranks share the card over gloo (yi-6b-reduced,
    f32, kernels on) in the runs of :data:`ZERO_REDUCED_RUNS`, replicated
    and with ZeRO-1, on the card and on the CPU: ZeRO-1's parameters and
    gathered moments bit-identical to the replicated group's, and every
    rank's parameters to rank 0's, on each device; ZeRO-1 card against
    CPU within phase 18's limits (loss 1e-3, grad norm and first moment
    1e-4, the parameters' change 1e-3); each card step's launches
    ``expected_launches`` at the rank's depth, none on the CPU.  Logs
    every figure before it raises at any that failed.  Returns each run's
    launches a rank."""
    from repro_torch.configs import reduced_config
    from repro_torch.launch import mesh

    cfg = dataclasses.replace(reduced_config("yi-6b"), use_pallas=True)
    init = _params_numpy(dp_reduced_init(cfg))
    t0 = time.perf_counter()
    ranks = mesh.spawn("chip_smoke:zero1_rank_reduced", ZERO_REDUCED_RANKS,
                       device="cuda", threads=2, timeout_s=DP_JOIN_S)
    launches, failed = {}, []
    for name, _, _ in ZERO_REDUCED_RUNS:
        for dev in ("cuda", "cpu"):
            for zero1 in (False, True):
                want = ranks[0][name, dev, zero1]["params"]
                for r, out in enumerate(ranks):
                    if not _same_arrays(out[name, dev, zero1]["params"],
                                        want):
                        failed.append(f"{name} {dev} zero1={zero1}: rank "
                                      f"{r}'s parameters differ from "
                                      f"rank 0's")
            zero, repl = (ranks[0][name, dev, z] for z in (True, False))
            same = zero["losses"] == repl["losses"] and all(
                _same_arrays(zero["whole"][key], repl["whole"][key])
                for key in ("params", "mu", "nu"))
            if not same:
                failed.append(f"{name} {dev}: ZeRO-1 differs from the "
                              f"replicated group")
            log(f"[zero] {name} {dev} ZeRO-1 against replicated: losses, "
                f"parameters and gathered moments "
                f"{'bit-identical' if same else 'DIFFER'}")
        card, cpu = (ranks[0][name, dev, True] for dev in ("cuda", "cpu"))
        loss = max(abs(a - b) / abs(b)
                   for a, b in zip(card["losses"], cpu["losses"]))
        gnorm = max(abs(a - b) / b for a, b in zip(card["grad_norms"],
                                                   cpu["grad_norms"]))
        update = _rel_l2(
            {n: card["whole"]["params"][n] - v for n, v in init.items()},
            {n: cpu["whole"]["params"][n] - v for n, v in init.items()})
        moment = _rel_l2(card["whole"]["mu"], cpu["whole"]["mu"])
        for what, got, tol in (("loss", loss, 1e-3),
                               ("grad norm", gnorm, DP_GNORM_TOL),
                               ("parameter change", update, DP_UPDATE_TOL),
                               ("first moment", moment, DP_MOMENT_TOL)):
            if not got <= tol:
                failed.append(f"{name}: {what} card vs CPU {got:.3e} > "
                              f"{tol:g}")
        for r, out in enumerate(ranks):
            grew = {}
            for zero1 in (False, True):
                run = out[name, "cuda", zero1]
                for s, (d, got) in enumerate(zip(run["depths"],
                                                 run["launches"])):
                    if got != expected_launches(cfg, [d]):
                        failed.append(f"{name} rank {r} zero1={zero1} step "
                                      f"{s}: launches {got} != "
                                      f"{expected_launches(cfg, [d])}")
                if any(any(g.values())
                       for g in out[name, "cpu", zero1]["launches"]):
                    failed.append(f"{name} rank {r}: a CPU step launched a "
                                  f"kernel")
                if zero1:
                    grew = {n: sum(g[n] for g in run["launches"])
                            for n in KERNELS}
                    launches[f"{name}/zero1/rank{r}"] = grew
            log(f"[zero] {name} rank={r} depths="
                f"{out[name, 'cuda', True]['depths']} launches="
                f"{ {n: c for n, c in grew.items() if c} }")
        log(f"[zero] {name} ZeRO-1 card_vs_cpu: loss={loss:.3e} (tol 1e-3) "
            f"gnorm={gnorm:.3e} (tol {DP_GNORM_TOL:g}) update_l2={update:.3e}"
            f" (tol {DP_UPDATE_TOL:g}) moment_l2={moment:.3e} "
            f"(tol {DP_MOMENT_TOL:g}) loss_cuda={card['losses']} "
            f"loss_cpu={cpu['losses']}")
    log(f"[zero] reduced phase {time.perf_counter() - t0:.1f}s")
    if failed:
        raise AssertionError("zero: " + "; ".join(failed))
    return launches


def zero1_rank_full(group, zero1_runs, steps: int) -> dict:
    """Phase 19 (b) and (c), one rank: yi-6b's 2-layer cut, temporal k 2,
    once a value of ``zero1_runs`` (ZeRO-1 off, then on), each from the
    same seeded weights (``init_state(0)``) for ``steps`` steps, the last
    under ``analysis/cost.CostMode``: each step's ms, host ms inside the
    collectives, launches, depth and loss, the counted collectives, the
    peak allocation and a digest of the parameters."""
    import gc
    import torch
    from repro_torch.analysis import cost
    from repro_torch.config import SPBConfig, TrainConfig
    from repro_torch.configs import make_batch
    from repro_torch.engine.engine import SPBEngine

    cfg = dp_full_config()
    out = {}
    for zero1 in zero1_runs:
        eng = SPBEngine(cfg, TrainConfig(num_steps=10),
                        SPBConfig(mode="temporal", k=ZERO_FULL_K),
                        group=group, shared_cache=False, zero1=zero1)
        eng.init_state(0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        run = {"steps": []}
        for i in range(steps):
            s = eng.state["step"]
            batch = group.shard(make_batch(cfg, group.size, 2048, seed=s,
                                           device="cuda"))
            before, r0 = launches_now(), group.reduce_s
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if i < steps - 1:
                m = eng.train_step(batch, s)
            else:
                with cost.CostMode() as counted:
                    m = eng.train_step(batch, s)
            loss = float(m["loss"])
            torch.cuda.synchronize()
            run["steps"].append({
                "ms": (time.perf_counter() - t0) * 1e3,
                "reduce_ms": (group.reduce_s - r0) * 1e3,
                "depth": _rank_depth(eng), "loss": loss,
                "launches": launches_since(before)})
        run["collectives"] = counted.summary.collectives()
        run["max_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        run["digest"] = _params_digest(eng.state["params"])
        out[zero1] = run
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    return out


def dp_gather_reckoning(cfg, n: int) -> dict:
    """The all-gathers one ZeRO-1 rank's step of ``cfg`` over ``n`` ranks
    should count (the all-reduce's reckoning extended): one call a
    parameter leaf that ``dist/sharding.dp_partition_plan`` shards, its
    whole bytes as payload."""
    from repro_torch.dist import sharding
    from repro_torch.models import lm
    from repro_torch.tree import tree_leaves

    shapes = lm.param_shapes(cfg)
    mesh = sharding.Mesh((n, 1), ("data", "model"))
    specs = tree_leaves(sharding.params_pspec(shapes, mesh),
                        is_leaf=lambda x: isinstance(x, sharding.P))
    planned = [t for t, spec in zip(tree_leaves(shapes), specs)
               if sharding.dp_partition_plan(spec, t.shape, mesh)]
    return {"count": len(planned),
            "payload_bytes": sum(t.numel() * t.element_size()
                                 for t in planned)}


def _check_zero1_run(cfg, what: str, run: dict, zero1: bool, n: int) -> list:
    """Phase 19 (b) and (c)'s checks of one rank's run: each step's
    launches ``expected_launches`` at its depth and a finite loss, and the
    counted step's all-reduces and all-gathers (calls, payload, the ring
    model's wire bytes) exactly the reckoning's.  Returns the counted
    collectives."""
    from repro_torch.analysis import cost
    for step in run["steps"]:
        want = expected_launches(cfg, [step["depth"]])
        if step["launches"] != want:
            raise AssertionError(f"zero {what}: launches {step['launches']} "
                                 f"!= {want}")
        if not math.isfinite(step["loss"]):
            raise AssertionError(f"zero {what}: loss not finite")
    depth = run["steps"][-1]["depth"]
    reduce = dp_reckoning(cfg, "temporal", depth, False)
    gather = dp_gather_reckoning(cfg, n) if zero1 else None
    counted = {}
    for kind, want in (("all-reduce", reduce), ("all-gather", gather)):
        c = run["collectives"].get(kind)
        got = None if c is None else (c["count"], c["payload_bytes"],
                                      c["wire_bytes"])
        expect = None if want is None else (
            want["count"], want["payload_bytes"],
            cost.wire_bytes(kind, n, want["payload_bytes"]))
        if got != expect:
            raise AssertionError(f"zero {what} depth {depth}: counted {kind} "
                                 f"(calls, payload, wire) {got} != the "
                                 f"reckoning's {expect}")
        counted[kind] = got
    return counted


def phase_zero1_full() -> dict:
    """Phase 19 (b) and (c): two ranks of yi-6b's 2-layer cut share the
    card over gloo, temporal k 2 for 2 steps, replicated and then with
    ZeRO-1: the parameters bit-identical across ranks and runs, launches
    and counted collectives exact (:func:`_check_zero1_run`), ZeRO-1's
    peak under the replicated one by at least
    :data:`ZERO_PEAK_DROP_SHARE` of the state's reckoned fall; then
    four ranks of it with ZeRO-1 for 2 steps (batch 4 x 2048), the same
    checks.  Prints, a rank and run, step ms, host ms inside the
    collectives and the peak beside the dry run's count
    (``launch/dryrun.count_cell(data_parallel=n)``), made first."""
    from repro_torch.launch import dryrun, mesh
    from repro_torch.models import lm
    from repro_torch.tree import tree_leaves

    cfg = dp_full_config()
    n_params = sum(t.numel() for t in tree_leaves(lm.param_shapes(cfg)))
    predicted = {}
    for n, zero1 in ((DP_FULL_RANKS, False), (DP_FULL_RANKS, True),
                     (ZERO_FOUR_RANKS, True)):
        rec = dryrun.count_cell("yi-6b", "train_4k", cut="full_width",
                                layers=DP_FULL_LAYERS, batch=n,
                                seq_len=2048, data_parallel=n, zero1=zero1)
        predicted[n, zero1] = {
            "peak_gb": rec["predicted_peak_bytes"] / 1e9,
            "state_gb": rec["state_bytes"]["zero1" if zero1
                                           else "replicated"] / 1e9,
            "collectives": rec["collective_breakdown"]}
        log(f"[zero] dry run yi-6b/{DP_FULL_LAYERS} n={n} zero1={zero1} "
            f"depth={DP_FULL_LAYERS}: predicted_peak_gb="
            f"{predicted[n, zero1]['peak_gb']:.3f} "
            f"state_gb={predicted[n, zero1]['state_gb']:.3f} "
            f"wire_bytes={rec['collective_breakdown']}")
    t0 = time.perf_counter()
    two = mesh.spawn("chip_smoke:zero1_rank_full", DP_FULL_RANKS,
                     (False, True), 2, device="cuda", timeout_s=DP_JOIN_S)
    four = mesh.spawn("chip_smoke:zero1_rank_full", ZERO_FOUR_RANKS,
                      (True,), 2, device="cuda", timeout_s=DP_JOIN_S)
    launches, figures = {}, {}
    for n, ranks, runs in ((DP_FULL_RANKS, two, (False, True)),
                           (ZERO_FOUR_RANKS, four, (True,))):
        if len({out[z]["digest"] for out in ranks for z in runs}) != 1:
            raise AssertionError(f"zero n={n}: the parameters differ across "
                                 f"ranks or runs")
        for r, out in enumerate(ranks):
            for zero1 in runs:
                run = out[zero1]
                key = f"n{n}/zero1={zero1}/rank{r}"
                counted = _check_zero1_run(cfg, key, run, zero1, n)
                launches[key] = {n_: sum(s["launches"][n_]
                                         for s in run["steps"])
                                 for n_ in KERNELS}
                # the last step ran under CostMode: its ms are no timing
                figures[key] = {
                    "depths": [s["depth"] for s in run["steps"]],
                    "step_ms": [round(s["ms"], 2) for s in run["steps"][:-1]],
                    "collective_host_ms": [round(s["reduce_ms"], 2)
                                           for s in run["steps"][:-1]],
                    "counted_step_ms": round(run["steps"][-1]["ms"], 2),
                    "counted": counted,
                    "max_mem_gb": round(run["max_mem_gb"], 3),
                    "predicted_peak_gb": round(predicted[n, zero1]
                                               ["peak_gb"], 3)}
                log(f"[zero] full yi-6b/{DP_FULL_LAYERS} n={n} "
                    f"zero1={zero1} rank={r} "
                    f"depths={figures[key]['depths']} "
                    f"step_ms={figures[key]['step_ms']} "
                    f"collective_host_ms="
                    f"{figures[key]['collective_host_ms']} "
                    f"counted_step_ms={figures[key]['counted_step_ms']} "
                    f"counted={counted} "
                    f"max_mem_gb={figures[key]['max_mem_gb']} "
                    f"predicted_peak_gb="
                    f"{figures[key]['predicted_peak_gb']} "
                    f"losses={[round(s['loss'], 4) for s in run['steps']]} "
                    f"launches="
                    f"{ {k: c for k, c in launches[key].items() if c} } "
                    f"replicas=bit-identical")
        if n == DP_FULL_RANKS:
            least = ZERO_PEAK_DROP_SHARE * 6 * n_params / 1e9
            for r, out in enumerate(ranks):
                drop = out[False]["max_mem_gb"] - out[True]["max_mem_gb"]
                if drop < least:
                    raise AssertionError(
                        f"zero rank {r}: ZeRO-1's peak is {drop:.3f} GB "
                        f"under the replicated one, not {least:.3f} GB "
                        f"({ZERO_PEAK_DROP_SHARE} of the state's fall)")
    log(f"[zero] full phase {time.perf_counter() - t0:.1f}s")
    return {"launches": launches, "figures": figures}


def phase_zero1_restart() -> None:
    """Phase 19 (d): ``launch/train.py --data-parallel 2`` on the card
    (yi-6b-reduced, the kernels, temporal k 2, 4 steps, a checkpoint
    every 2), straight and with ``--fail-at 3`` (restored from step 2),
    the two runs side by side: the xent of every step bit for bit the
    straight run's; the last checkpoint (step 4, the whole state) restores
    into a one-process engine on the card with every tensor equal."""
    import shutil
    from concurrent.futures import ThreadPoolExecutor
    import torch
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.config import SPBConfig, TrainConfig
    from repro_torch.configs import reduced_config
    from repro_torch.engine.engine import SPBEngine
    from repro_torch.launch import train as train_mod
    from repro_torch.tree import tree_leaves

    root = Path(__file__).resolve().parent / "build" / "chip_smoke_zero_ckpt"
    shutil.rmtree(root, ignore_errors=True)
    args = ["--device", "cuda", "--use-pallas", "--arch", "yi-6b",
            "--steps", "4", "--checkpoint-every", "2", "--spb-mode",
            "temporal", "--spb-k", "2", "--batch", "4", "--seq", "64",
            "--log-every", "100", "--data-parallel", "2"]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        straight = pool.submit(train_mod.train, args + [
            "--checkpoint-dir", str(root / "straight")])
        failed = pool.submit(train_mod.train, args + [
            "--checkpoint-dir", str(root / "failed"), "--fail-at", "3"])
        straight, failed = straight.result(), failed.result()
    mgr = CheckpointManager(root / "failed")
    cfg = dataclasses.replace(reduced_config("yi-6b"), use_pallas=True)
    eng = SPBEngine(cfg, TrainConfig(), SPBConfig(mode="temporal", k=2),
                    device="cuda")
    state, step = mgr.restore(eng.state_shapes)
    eng.attach_state(state)
    want = tree_leaves({"params": state["params"], "opt": state["opt"]})
    got = tree_leaves({"params": eng.state["params"],
                       "opt": eng.state["opt"]})
    restored = step == 4 and eng.state["step"] == 4 and all(
        g.is_cuda and torch.equal(g.detach().cpu(), w)
        for g, w in zip(got, want))
    shutil.rmtree(root, ignore_errors=True)
    same = failed[:3] == straight[:3] and failed[3:] == straight[2:]
    log(f"[zero-restart] straight_xent={straight} failed_xent={failed} "
        f"resumed_equal_bit_for_bit={same} last_checkpoint_step={step} "
        f"restores_into_one_process={restored} "
        f"({time.perf_counter() - t0:.1f}s)")
    if not (same and len(straight) == 4 and len(failed) == 5):
        raise AssertionError("zero restart: the resumed group's xent is not "
                             "the straight run's")
    if not restored:
        raise AssertionError("zero restart: the group's checkpoint does not "
                             "restore into one process")


# phase 20: pipelines (``dist/pipeline``), one stage a rank, the ranks
# sharing the card over gloo: yi-6b at published widths cut to 8 layers over
# 2 stages of 4, 1F1B over 4 microbatches of one row of 2048, temporal k 4
# (the cycle 8, 2, 6, 4 snaps to the stages as 8, 4, 8, 4: bwd_stages 2, 1,
# 2, 1), one cycle; then reduced yi-6b and mamba2-2.7b (f32, the kernels)
# over 2 stages for one cycle, held against one process on the CPU.  A
# rank holds 4 layers and the table or the head: the dry run counts a
# 4-layer cut of one row at 24.3 GB, so the two ranks fit the card.
PIPE_STAGES = 2
PIPE_M = 4
PIPE_FULL_LAYERS = 8
PIPE_FULL_STEPS = 4
PIPE_REDUCED = ("yi-6b", "mamba2-2.7b")
PIPE_REDUCED_STEPS = 4
PIPE_TOL = 1e-3         # phase 4's card against CPU


def pipe_config(what: str):
    """Phase 20's configs: ``"full"`` (yi-6b's 8-layer cut), else the
    arch's reduced config on the kernels."""
    from repro_torch.configs import full_width_config, reduced_config
    if what == "full":
        return dataclasses.replace(full_width_config("yi-6b"),
                                   num_layers=PIPE_FULL_LAYERS)
    return dataclasses.replace(reduced_config(what), use_pallas=True)


def _pipe_engine(cfg, group, steps: int):
    from repro_torch.config import SPBConfig, TrainConfig
    from repro_torch.engine.engine import SPBEngine
    return SPBEngine(cfg, TrainConfig(num_steps=steps, microbatches=PIPE_M),
                     SPBConfig(mode="temporal", k=4), group=group,
                     parallelism="pipeline", shared_cache=False)


def _pipe_steps(eng, group, batches, start: int = 0) -> list:
    """Each step of a pipeline rank (steps ``start``, ``start + 1``, ...):
    ms (host clock, synchronized), host ms inside the point-to-point
    messages and inside the stage and data axes' collectives, the items'
    busy ms, bytes sent by kind, depth, bwd_stages, metrics and
    launches."""
    import torch
    from repro_torch.dist.group import TAG_ACT, TAG_COT, TAG_TENSOR
    kinds = {TAG_ACT: "act", TAG_COT: "cot", TAG_TENSOR: "table"}
    out = []
    for s, batch in enumerate(batches, start):
        before = launches_now()
        p0, sent0 = group.p2p_s, dict(group.p2p_by_tag)
        r0, b0 = group.reduce_s + group.data.reduce_s, group.busy_s
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = eng.train_step(group.shard(batch, PIPE_M), s)
        metrics = {k: float(v) for k, v in m.items()}
        torch.cuda.synchronize()
        out.append({
            "ms": (time.perf_counter() - t0) * 1e3,
            "p2p_ms": (group.p2p_s - p0) * 1e3,
            "collective_ms": (group.reduce_s + group.data.reduce_s - r0) * 1e3,
            "busy_ms": (group.busy_s - b0) * 1e3,
            "sent": {name: group.p2p_by_tag.get(t, 0) - sent0.get(t, 0)
                     for t, name in kinds.items()},
            "depth": eng.last_depth,
            "bwd_stages": eng.step_fn(eng.last_depth).bwd_stages,
            "launches": launches_since(before), **metrics})
    return out


def pipe_rank(group) -> dict:
    """Phase 20, one stage's rank: the full-width run from ``init_state(0)``
    on the card's generator, then each reduced arch from weights drawn on
    the CPU; each step's figures (:func:`_pipe_steps`) and the peaks."""
    import gc
    import torch
    from repro_torch.config import TrainConfig
    from repro_torch.configs import make_batch
    from repro_torch.data.pipeline import Pipeline
    from repro_torch.dist import steps as steps_lib
    from repro_torch.models import lm

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = pipe_config("full")
    eng = _pipe_engine(cfg, group, PIPE_FULL_STEPS)
    eng.init_state(0)
    batches = [make_batch(cfg, PIPE_M, 2048, seed=s, device="cuda")
               for s in range(PIPE_FULL_STEPS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = {"full": {"steps": _pipe_steps(eng, group, batches),
                    "max_mem_gb": torch.cuda.max_memory_allocated() / 1e9}}
    del eng, batches
    gc.collect()
    torch.cuda.empty_cache()
    for arch in PIPE_REDUCED:
        cfg = pipe_config(arch)
        eng = _pipe_engine(cfg, group, PIPE_REDUCED_STEPS)
        eng.attach_state(steps_lib.state_from_params(
            lm.init_lm(torch.Generator().manual_seed(0), cfg, "cpu"),
            TrainConfig()))
        pipe = Pipeline(cfg, PIPE_M, 64, seed=0)
        out[arch] = {"steps": _pipe_steps(
            eng, group, [pipe.get_batch(s)
                         for s in range(PIPE_REDUCED_STEPS)])}
    return out


def expected_stage_launches(cfg, stage: int, bwd_stages: int) -> dict:
    """Launches of one pipeline step on ``stage``'s rank: each of the
    :data:`PIPE_M` microbatches runs the stage's forward under no_grad
    (:func:`expected_launches` at depth 0 of the stage's layers), and on a
    live stage the backward tick's recompute and backward on top (the
    stage's layers all live)."""
    from repro_torch.config import stage_layer_counts
    n = stage_layer_counts(cfg, PIPE_STAGES)[stage]
    scfg = dataclasses.replace(cfg, num_layers=n)
    want = {k: c * PIPE_M for k, c in expected_launches(scfg, [0]).items()}
    if stage >= PIPE_STAGES - bwd_stages:
        for k, c in expected_launches(scfg, [n]).items():
            want[k] += c * PIPE_M
    return want


def _pipe_one_process(cfg, device: str, steps: int, batches) -> list:
    """One process, the same cycle snapped to the stages, on ``device``
    from the reduced run's CPU-drawn weights: each step's xent and depth."""
    import torch
    from repro_torch.config import SPBConfig, TrainConfig
    from repro_torch.dist import steps as steps_lib
    from repro_torch.engine.engine import SPBEngine
    from repro_torch.models import lm
    eng = SPBEngine(cfg, TrainConfig(num_steps=steps, microbatches=PIPE_M),
                    SPBConfig(mode="temporal", k=4,
                              pipeline_stages=PIPE_STAGES),
                    device=device, shared_cache=False)
    eng.attach_state(steps_lib.state_from_params(
        lm.init_lm(torch.Generator().manual_seed(0), cfg, "cpu"),
        TrainConfig()))
    return [(float(eng.train_step(b, s)["xent"]), eng.last_depth)
            for s, b in enumerate(batches)]


def phase_pipeline(smi: str) -> dict:
    """Phase 20: two stage ranks share the card over gloo
    (``launch/mesh.spawn(grid=(2, 1, 1))``, ``SPBEngine(parallelism=
    "pipeline")``): (a) yi-6b's 8-layer full-width cut, 1F1B over 4
    microbatches, temporal k 4 for one cycle: every rank's launches a
    step :func:`expected_stage_launches` (a frozen stage launches the
    forward kernels alone: no delta, dq or dkv), finite losses, the first
    step's xent within :data:`PIPE_TOL` of one process's forward on the
    card, the bytes each rank sends a step exactly the activations'
    (``B/M x S x d_model x 2`` a send), the cotangents' and the tied
    table's; a line a rank and bwd_stages with step ms, host ms inside
    the messages and the collectives, the measured bubble beside
    ``analysis/roofline.pipeline_bubble_fraction``, and the peak beside
    the dry run's count of a 4-layer rank; (b) reduced yi-6b and
    mamba2-2.7b for one cycle: each step's xent within :data:`PIPE_TOL`
    of one process on the CPU, launches exact (mamba2's frozen stage
    launches no SSD backward).  Every line carries the card's name and
    power limit.  Returns each run's launches a rank, and the figures."""
    import torch
    from repro_torch.analysis import roofline
    from repro_torch.configs import make_batch
    from repro_torch.data.pipeline import Pipeline
    from repro_torch.launch import dryrun, mesh
    from repro_torch.models import lm

    cfg = pipe_config("full")
    rec = dryrun.count_cell("yi-6b", "train_4k", cut="full_width",
                            layers=PIPE_FULL_LAYERS // PIPE_STAGES, batch=1,
                            seq_len=2048)
    ma = rec["memory_analysis"]
    predicted_gb = (ma["argument_size_in_bytes"]
                    + ma["temp_size_in_bytes"]) / 1e9
    log(f"[pipeline] dry run yi-6b/{PIPE_FULL_LAYERS // PIPE_STAGES} batch 1 "
        f"x 2048 (one rank's layers, table and head): predicted_peak_gb="
        f"{predicted_gb:.3f} card={smi}")
    t0 = time.perf_counter()
    ranks = mesh.spawn("chip_smoke:pipe_rank", PIPE_STAGES, device="cuda",
                       grid=(PIPE_STAGES, 1, 1), timeout_s=DP_JOIN_S)
    failed, launches, figures = [], {}, {}
    # (a) the full-width run
    act = 1 * 2048 * cfg.d_model * 2            # one row of 2048, bf16
    table = cfg.padded_vocab * cfg.d_model * 2
    with torch.no_grad():
        params = lm.init_lm(torch.Generator(device="cuda").manual_seed(0),
                            cfg, "cuda")
        _, mm = lm.loss_fn(params, make_batch(cfg, PIPE_M, 2048, seed=0,
                                              device="cuda"), cfg)
        one_xent = float(mm["xent"])
    del params
    torch.cuda.empty_cache()
    for stage, out in enumerate(ranks):
        run = out["full"]
        key = f"full/stage{stage}"
        launches[key] = {n: sum(s["launches"][n] for s in run["steps"])
                         for n in KERNELS}
        for i, st in enumerate(run["steps"]):
            b = st["bwd_stages"]
            want = expected_stage_launches(cfg, stage, b)
            if st["launches"] != want:
                failed.append(f"{key} step {i}: launches {st['launches']} "
                              f"!= {want}")
            if not math.isfinite(st["loss"]):
                failed.append(f"{key} step {i}: loss not finite")
            sent = {"act": PIPE_M * act if stage < PIPE_STAGES - 1 else 0,
                    "cot": PIPE_M * act if stage > 0 and
                    stage - 1 >= PIPE_STAGES - b else 0,
                    "table": table}
            if st["sent"] != sent:
                failed.append(f"{key} step {i}: sent {st['sent']} != {sent}")
        rel = abs(run["steps"][0]["xent"] - one_xent) / abs(one_xent)
        if not rel <= PIPE_TOL:
            failed.append(f"{key}: first xent {run['steps'][0]['xent']} vs "
                          f"one process {one_xent}: {rel:.3e}")
        for b in sorted({st["bwd_stages"] for st in run["steps"]}):
            warm = [st for st in run["steps"][PIPE_FULL_STEPS // 2:]
                    if st["bwd_stages"] == b]
            mean = lambda k: sum(st[k] for st in warm) / len(warm)
            fig = {"step_ms": round(mean("ms"), 2),
                   "p2p_host_ms": round(mean("p2p_ms"), 2),
                   "collective_host_ms": round(mean("collective_ms"), 2),
                   "busy_ms": round(mean("busy_ms"), 2),
                   "bubble": round(1.0 - mean("busy_ms") / mean("ms"), 4),
                   "bubble_table": round(roofline.pipeline_bubble_fraction(
                       PIPE_STAGES, PIPE_M, kind="1f1b", bwd_stages=b), 4),
                   "sent_bytes": warm[0]["sent"],
                   "act_bytes_a_send": act,
                   "max_mem_gb": round(run["max_mem_gb"], 3),
                   "predicted_peak_gb": round(predicted_gb, 3),
                   "launches": {k: c for k, c in
                                warm[0]["launches"].items() if c}}
            figures[f"{key}/bwd_stages{b}"] = fig
            log(f"[pipeline] full yi-6b/{PIPE_FULL_LAYERS} S={PIPE_STAGES} "
                f"M={PIPE_M} 1f1b stage={stage} bwd_stages={b} "
                f"depths={[st['depth'] for st in run['steps']]} "
                + " ".join(f"{k}={v}" for k, v in fig.items())
                + f" first_xent={run['steps'][0]['xent']:.6f} "
                f"one_process_xent={one_xent:.6f} card={smi}")
    # (b) the reduced runs against one process on the CPU
    for arch in PIPE_REDUCED:
        rcfg = pipe_config(arch)
        pipe = Pipeline(rcfg, PIPE_M, 64, seed=0)
        want = _pipe_one_process(rcfg, "cpu", PIPE_REDUCED_STEPS,
                                 [pipe.get_batch(s)
                                  for s in range(PIPE_REDUCED_STEPS)])
        for stage, out in enumerate(ranks):
            run = out[arch]["steps"]
            key = f"{arch}/stage{stage}"
            launches[key] = {n: sum(s["launches"][n] for s in run)
                             for n in KERNELS}
            rel = max(abs(st["xent"] - w) / abs(w)
                      for st, (w, _d) in zip(run, want))
            if not rel <= PIPE_TOL:
                failed.append(f"{key}: xent card vs one CPU process "
                              f"{rel:.3e} > {PIPE_TOL:g}")
            if [st["depth"] for st in run] != [d for _w, d in want]:
                failed.append(f"{key}: depths differ from one process's")
            for i, st in enumerate(run):
                exp = expected_stage_launches(rcfg, stage, st["bwd_stages"])
                if st["launches"] != exp:
                    failed.append(f"{key} step {i}: launches "
                                  f"{st['launches']} != {exp}")
            log(f"[pipeline] reduced {arch} stage={stage} "
                f"depths={[st['depth'] for st in run]} "
                f"bwd_stages={[st['bwd_stages'] for st in run]} "
                f"xent_card={[round(st['xent'], 6) for st in run]} "
                f"xent_cpu_one_process={[round(w, 6) for w, _ in want]} "
                f"card_vs_cpu={rel:.3e} (tol {PIPE_TOL:g}) "
                f"step_ms={[round(st['ms'], 2) for st in run]} launches="
                f"{ {k: c for k, c in launches[key].items() if c} } "
                f"card={smi}")
    log(f"[pipeline] phase {time.perf_counter() - t0:.1f}s")
    if failed:
        raise AssertionError("pipeline: " + "; ".join(failed))
    return {"launches": launches, "figures": figures}


# ---------------------------------------------------------------------------
# Phase 21: tensor parallelism inside the pipeline's stages
# ---------------------------------------------------------------------------

TP_T = 2                 # the model axis
TP_FULL_LAYERS = 2       # part (a): yi-6b's 2-layer cut on (2, 1, 2)
TP_FULL_STEPS = 2        # the cycle's first two steps: bwd_stages 2, 1
TP_ZERO_LAYERS = 2       # part (b): yi-6b's 2-layer cut on (2, 2, 2)
TP_ZERO_STEPS = 2
TP_REDUCED_STEPS = 4
# the reckoning of a rank's peak: bf16 params and grads (2 + 2 B a
# parameter), the f32 master and AdamW's two moments (12 B, over the data
# axis under ZeRO-1), and the optimizer's two f32 passes over the
# gradient (the clipped and the SPB-scaled copies, 8 B)
TP_BYTES_A_PARAM = lambda d: 2 + 2 + 12 / d + 8     # noqa: E731


def tp_config(what: str):
    """Phase 21's configs: ``"full"`` and ``"zero"`` (yi-6b's 2-layer
    cut), else reduced yi-6b on the kernels."""
    from repro_torch.configs import full_width_config, reduced_config
    layers = {"full": TP_FULL_LAYERS, "zero": TP_ZERO_LAYERS}.get(what)
    if layers:
        return dataclasses.replace(full_width_config("yi-6b"),
                                   num_layers=layers)
    return dataclasses.replace(reduced_config("yi-6b"), use_pallas=True)


def _tp_engine(cfg, group, steps: int, **kw):
    from repro_torch.config import SPBConfig, TrainConfig
    from repro_torch.engine.engine import SPBEngine
    return SPBEngine(cfg, TrainConfig(num_steps=steps, microbatches=PIPE_M),
                     SPBConfig(mode="temporal", k=4), group=group,
                     parallelism="pipeline", tensor_parallel=TP_T,
                     shared_cache=False, **kw)


def _tp_steps(eng, group, batches) -> list:
    """:func:`_pipe_steps`, and each step's host ms inside the model
    group's collectives and its calls and bytes by kind."""
    model = group.model
    out = []
    for s, batch in enumerate(batches):
        m0, c0, b0 = model.reduce_s, dict(model.calls), dict(model.bytes)
        st = _pipe_steps(eng, group, [batch], start=s)[0]
        st["model_ms"] = (model.reduce_s - m0) * 1e3
        st["model_calls"] = {k: [model.calls[k] - c0.get(k, 0),
                                 model.bytes[k] - b0.get(k, 0)]
                             for k in model.calls
                             if model.calls[k] - c0.get(k, 0)}
        out.append(st)
    return out


def _tp_reduced(group, sp: bool, zero2: bool, rows: int) -> dict:
    """Reduced yi-6b on this grid from CPU-drawn weights, one cycle twice."""
    import torch
    from repro_torch.config import TrainConfig
    from repro_torch.data.pipeline import Pipeline
    from repro_torch.dist import steps as steps_lib
    from repro_torch.models import lm
    cfg = tp_config("reduced")
    eng = _tp_engine(cfg, group, TP_REDUCED_STEPS, sequence_parallel=sp,
                     zero2=zero2)
    eng.attach_state(steps_lib.state_from_params(
        lm.init_lm(torch.Generator().manual_seed(0), cfg, "cpu"),
        TrainConfig()))
    pipe = Pipeline(cfg, rows, 64, seed=0)
    return {"steps": _tp_steps(eng, group, [pipe.get_batch(s) for s in
                                            range(TP_REDUCED_STEPS)])}


def tp_rank(group, part: str) -> dict:
    """Phase 21, one rank of the grid.  Part ``"a"`` on (2, 1, 2): the
    2-layer cut from ``init_state(0)`` on the card's generator, sequence
    parallelism off then on, then reduced yi-6b both ways.  Part ``"b"``
    on (2, 2, 2), sequence parallelism on: the 2-layer cut under ZeRO-2
    then ZeRO-1, this rank's updated parameters compared (bit for bit, or
    the largest difference), then reduced yi-6b under ZeRO-2."""
    import gc
    import torch
    from repro_torch.configs import make_batch
    from repro_torch.tree import tree_leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    D = group.data.size
    out = {}
    if part == "a":
        cfg = tp_config("full")
        runs = [(f"full/sp{int(sp)}", dict(sequence_parallel=sp))
                for sp in (False, True)]
        steps = TP_FULL_STEPS
    else:
        cfg = tp_config("zero")
        runs = [(f"zero/zero{2 if z2 else 1}",
                 dict(sequence_parallel=True, zero2=z2))
                for z2 in (True, False)]
        steps = TP_ZERO_STEPS
    batches = [make_batch(cfg, PIPE_M * D, 2048, seed=s, device="cuda")
               for s in range(steps)]
    kept = None
    for label, kw in runs:
        eng = _tp_engine(cfg, group, steps, **kw)
        eng.init_state(0)
        n_params = sum(t.numel() for t in tree_leaves(eng.state["params"]))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        run = {"steps": _tp_steps(eng, group, batches),
               "max_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
               "params": n_params}
        if part == "b":     # the f32 masters (this rank's ZeRO-1 slices)
            # and the bf16 parameters the step wrote
            mine = [[t.detach().cpu() for t in tree_leaves(tree)]
                    for tree in (eng.state["opt"]["master"],
                                 eng.state["params"])]
            if kept is None:
                kept = mine
            else:
                (m2, p2), (m1, p1) = kept, mine
                run["vs_zero2_equal"] = all(torch.equal(a, b)
                                            for a, b in zip(m2 + p2, m1 + p1))
                run["vs_zero2_max_abs"] = max(
                    float((a - b).abs().max()) for a, b in zip(m2, m1))
                run["vs_zero2_params_differing"] = sum(
                    int((a != b).sum()) for a, b in zip(p2, p1))
        out[label] = run
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    del batches, kept
    if part == "a":
        for sp in (False, True):
            out[f"reduced/sp{int(sp)}"] = _tp_reduced(group, sp, False,
                                                      PIPE_M)
    else:
        out["reduced/zero2"] = _tp_reduced(group, True, True, PIPE_M * D)
    return out


def _tp_calls_want(cfg, stage: int, b: int, sp: bool, seq: int) -> dict:
    """``roofline.pipeline_tp_calls`` of one step on ``stage``'s rank at
    bwd_stages ``b``: one row a microbatch on each data rank."""
    from repro_torch.analysis import roofline
    from repro_torch.config import stage_layer_counts
    want = roofline.pipeline_tp_calls(
        cfg, stage_layer_counts(cfg, PIPE_STAGES)[stage], PIPE_M, 1, seq,
        model_parallel=TP_T,
        live=stage >= PIPE_STAGES - b,
        need_dx=(b == PIPE_STAGES) if stage == 0
        else stage - 1 >= PIPE_STAGES - b, sequence_parallel=sp)
    return {k: list(v) for k, v in want.items()}


def phase_tensor_parallel(smi: str) -> dict:
    """Phase 21: tensor parallelism inside the pipeline's stages, the
    ranks sharing the card over gloo (``launch/mesh.spawn(grid=(S, D,
    T))``).  (a) yi-6b's 2-layer cut at published widths on (stage 2,
    data 1, model 2): 1F1B over 4 microbatches of one row of 2048, the k 4
    cycle's first two steps (bwd_stages 2 and 1), sequence parallelism
    off and on; (b) its 2-layer cut on (2, 2, 2) with sequence
    parallelism under ZeRO-2 and
    ZeRO-1.  Every rank's launches a step :func:`expected_stage_launches`
    (a launch count does not depend on the heads: the kernels run at the
    local H 16 over K 2), its point-to-point bytes by kind and its
    model-group calls and bytes ``analysis/roofline.pipeline_tp_calls``,
    finite losses, the first full-width xent within :data:`PIPE_TOL` of
    one process's forward on the card, each rank's peak beside the
    reckoning (:data:`TP_BYTES_A_PARAM`), ZeRO-2's updated f32 parameters
    (the masters) within 1e-6 of ZeRO-1's, bit for bit or not (its gradient
    norm sums the data shards' squares in another order), and reduced yi-6b on each grid within
    :data:`PIPE_TOL` of one CPU process, every step.  Returns each run's
    launches a rank, and the figures."""
    import torch
    from repro_torch.configs import make_batch
    from repro_torch.data.pipeline import Pipeline
    from repro_torch.dist.pipeline import stage as pp_stage
    from repro_torch.launch import mesh
    from repro_torch.models import lm
    from repro_torch.tree import tree_leaves

    failed, launches, figures = [], {}, {}
    t0 = time.perf_counter()
    grids = {"a": (PIPE_STAGES, 1, TP_T), "b": (PIPE_STAGES, 2, TP_T)}
    cfgs = {"a": tp_config("full"), "b": tp_config("zero")}
    # the reckonings, before the runs: what each stage's rank holds
    reckon = {}
    for part, (S, D, T) in grids.items():
        cfg = cfgs[part]
        smap = pp_stage.build_stage_map(cfg, S)
        table = cfg.padded_vocab * cfg.d_model
        for stage in range(S):
            n = sum(t.numel() for t in tree_leaves(pp_stage.local_tree(
                lm.param_shapes(cfg), cfg, smap, stage, model=(0, T))))
            gb = (n * TP_BYTES_A_PARAM(D)
                  + (2 * table if stage == S - 1 else 0)) / 1e9
            reckon[(part, stage)] = (n, gb)
            log(f"[tensor-parallel] reckoning {part} grid={grids[part]} "
                f"stage={stage}: {n} parameters held, {gb:.3f} GB of state "
                f"(with the table's copy on the last stage) card={smi}")
    with torch.no_grad():
        cfg = cfgs["a"]
        params = lm.init_lm(torch.Generator(device="cuda").manual_seed(0),
                            cfg, "cuda")
        _, mm = lm.loss_fn(params, make_batch(cfg, PIPE_M, 2048, seed=0,
                                              device="cuda"), cfg)
        one_xent = float(mm["xent"])
    del params
    torch.cuda.empty_cache()
    act = 1 * 2048 * cfgs["a"].d_model * 2          # one row of 2048, bf16
    table = cfgs["a"].padded_vocab * cfgs["a"].d_model * 2
    for part, grid in grids.items():
        S, D, T = grid
        n = S * D * T
        tp = time.perf_counter()
        ranks = mesh.spawn("chip_smoke:tp_rank", n, part, device="cuda",
                           grid=grid, timeout_s=DP_JOIN_S)
        log(f"[tensor-parallel] part {part} grid={grid}: "
            f"{time.perf_counter() - tp:.1f}s")
        cfg = cfgs[part]
        for r, out in enumerate(ranks):
            stage, d, t = r // (D * T), r // T % D, r % T
            for label, run in out.items():
                if label.startswith("reduced"):
                    continue
                key = f"{label}/stage{stage}/d{d}/t{t}"
                sp = "sp1" in label or part == "b"
                launches[key] = {k: sum(st["launches"][k]
                                        for st in run["steps"])
                                 for k in KERNELS}
                for i, st in enumerate(run["steps"]):
                    b = st["bwd_stages"]
                    want = expected_stage_launches(cfg, stage, b)
                    if st["launches"] != want:
                        failed.append(f"{key} step {i}: launches "
                                      f"{st['launches']} != {want}")
                    if not math.isfinite(st["loss"]):
                        failed.append(f"{key} step {i}: loss not finite")
                    sent = {"act": PIPE_M * act if stage < S - 1 else 0,
                            "cot": PIPE_M * act if stage > 0 and
                            stage - 1 >= S - b else 0,
                            "table": table}
                    if st["sent"] != sent:
                        failed.append(f"{key} step {i}: sent {st['sent']} "
                                      f"!= {sent}")
                    calls = _tp_calls_want(cfg, stage, b, sp, 2048)
                    if st["model_calls"] != calls:
                        failed.append(f"{key} step {i}: model-group calls "
                                      f"{st['model_calls']} != {calls}")
                if part == "a":
                    rel = abs(run["steps"][0]["xent"] - one_xent) / \
                        abs(one_xent)
                    if not rel <= PIPE_TOL:
                        failed.append(f"{key}: first xent "
                                      f"{run['steps'][0]['xent']} vs one "
                                      f"process {one_xent}: {rel:.3e}")
                if "vs_zero2_equal" in run and not (
                        run["vs_zero2_equal"]
                        or run["vs_zero2_max_abs"] <= 1e-6):
                    failed.append(f"{key}: ZeRO-1's f32 parameters differ "
                                  f"from ZeRO-2's by "
                                  f"{run['vs_zero2_max_abs']}")
                n_held, gb = reckon[(part, stage)]
                for b in sorted({st["bwd_stages"] for st in run["steps"]}):
                    warm = [st for st in run["steps"][len(run["steps"]) // 2:]
                            if st["bwd_stages"] == b] or \
                        [st for st in run["steps"] if st["bwd_stages"] == b]
                    mean = lambda k: sum(st[k] for st in warm) / len(warm)
                    fig = {"step_ms": round(mean("ms"), 2),
                           "p2p_host_ms": round(mean("p2p_ms"), 2),
                           "model_host_ms": round(mean("model_ms"), 2),
                           "stage_data_collective_host_ms":
                               round(mean("collective_ms"), 2),
                           "busy_ms": round(mean("busy_ms"), 2),
                           "sent_bytes": warm[0]["sent"],
                           "model_calls": warm[0]["model_calls"],
                           "model_calls_counted": _tp_calls_want(
                               cfg, stage, b, sp, 2048),
                           "max_mem_gb": round(run["max_mem_gb"], 3),
                           "reckoned_gb": round(gb, 3),
                           "params_held": run["params"],
                           "params_reckoned": n_held,
                           "launches": {k: c for k, c in
                                        warm[0]["launches"].items() if c}}
                    if "vs_zero2_equal" in run:
                        fig["zero1_vs_zero2_bit_equal"] = \
                            run["vs_zero2_equal"]
                        fig["zero1_vs_zero2_master_max_abs"] = \
                            run["vs_zero2_max_abs"]
                        fig["zero1_vs_zero2_bf16_params_differing"] = \
                            run["vs_zero2_params_differing"]
                    figures[f"{key}/bwd_stages{b}"] = fig
                    log(f"[tensor-parallel] {label} yi-6b/{cfg.num_layers} "
                        f"grid={grid} M={PIPE_M} 1f1b stage={stage} d={d} "
                        f"t={t} bwd_stages={b} depths="
                        f"{[st['depth'] for st in run['steps']]} "
                        + " ".join(f"{k}={v}" for k, v in fig.items())
                        + f" first_xent={run['steps'][0]['xent']:.6f} "
                        f"card={smi}")
        # the reduced runs against one process on the CPU
        for label in [k for k in ranks[0] if k.startswith("reduced")]:
            rows = PIPE_M * D
            rcfg = tp_config("reduced")
            pipe = Pipeline(rcfg, rows, 64, seed=0)
            want = _pipe_one_process(rcfg, "cpu", TP_REDUCED_STEPS,
                                     [pipe.get_batch(s)
                                      for s in range(TP_REDUCED_STEPS)])
            sp = "sp1" in label or part == "b"
            for r, out in enumerate(ranks):
                stage = r // (D * T)
                run = out[label]["steps"]
                key = f"{label}/grid{''.join(map(str, grid))}/rank{r}"
                launches[key] = {k: sum(st["launches"][k] for st in run)
                                 for k in KERNELS}
                rel = max(abs(st["xent"] - w) / abs(w)
                          for st, (w, _d) in zip(run, want))
                if not rel <= PIPE_TOL:
                    failed.append(f"{key}: xent card vs one CPU process "
                                  f"{rel:.3e} > {PIPE_TOL:g}")
                for i, st in enumerate(run):
                    b = st["bwd_stages"]
                    exp = expected_stage_launches(rcfg, stage, b)
                    if st["launches"] != exp:
                        failed.append(f"{key} step {i}: launches "
                                      f"{st['launches']} != {exp}")
                    calls = _tp_calls_want(rcfg, stage, b, sp, 64)
                    if st["model_calls"] != calls:
                        failed.append(f"{key} step {i}: model-group calls "
                                      f"{st['model_calls']} != {calls}")
                if r == 0:
                    log(f"[tensor-parallel] {label} grid={grid} "
                        f"depths={[st['depth'] for st in run]} "
                        f"xent_card={[round(st['xent'], 6) for st in run]} "
                        f"xent_cpu_one_process="
                        f"{[round(w, 6) for w, _ in want]} "
                        f"card_vs_cpu={rel:.3e} (tol {PIPE_TOL:g}) "
                        f"step_ms={[round(st['ms'], 2) for st in run]} "
                        f"card={smi}")
    log(f"[tensor-parallel] phase {time.perf_counter() - t0:.1f}s")
    if failed:
        raise AssertionError("tensor-parallel: " + "; ".join(failed))
    return {"launches": launches, "figures": figures}


EP_ARCH = "deepseek-v2-lite-16b"
EP_GRIDS = ((1, 2), (2, 2))      # part (a): reduced, ranks sharing the card
EP_STEPS = 2
EP_ROWS, EP_SEQ = 4, 32          # part (a)'s global batch
EP_TOL = 1e-3                    # card against CPU, as phase 4's
EP_DENSE_TOL = 1e-5              # capacity 8 against one dense process
EP_FULL_LAYERS = 3               # part (b): the dense layer 0 and 2 MoE
EP_FULL_GRID = (1, 2)
EP_FULL_STEPS = 4                # one k 4 cycle; its second half is warm
EP_ACT_GB = 4.0                  # part (b)'s activations over the state


def ep_config(what: str, **moe_kw):
    """Phase 22's configs: ``"full"`` (deepseek-v2-lite-16b at published
    widths cut to 3 layers, every expert, bf16, the kernels), else its
    reduced config in f32 on the kernels; ``impl="ep"`` both."""
    from repro_torch.configs import full_width_config, reduced_config
    if what == "full":
        cfg = dataclasses.replace(full_width_config(EP_ARCH),
                                  num_layers=EP_FULL_LAYERS)
        moe = dataclasses.replace(cfg.moe, experts_held=None)
    else:
        cfg = dataclasses.replace(reduced_config(EP_ARCH), use_pallas=True)
        moe = cfg.moe
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        moe, impl="ep", **moe_kw))


def _ep_engine(cfg, group, steps: int):
    from repro_torch.config import SPBConfig, TrainConfig
    from repro_torch.engine.engine import SPBEngine
    return SPBEngine(cfg, TrainConfig(num_steps=steps),
                     SPBConfig(mode="temporal", k=4), group=group,
                     shared_cache=False)


def _replicated_digest(eng) -> str:
    """sha256 of the rank's non-expert parameters' bits."""
    from repro_torch.dist import steps as steps_lib
    from repro_torch.tree import tree_leaves
    return _params_digest([t for t, r in zip(
        tree_leaves(eng.state["params"]),
        tree_leaves(steps_lib.ep_roles(eng.cfg))) if r != "expert"])


def _ep_steps(eng, group, batches) -> list:
    """Each step of a grid rank: ms (host clock, synchronized), the model
    group's host ms, calls and payload bytes by kind, each MoE layer's
    dropped and routed slots, depth, metrics and launches."""
    import torch
    from repro_torch.models import moe
    model = group.model
    out = []
    for s, batch in enumerate(batches):
        before = launches_now()
        c0, b0, t0s = dict(model.calls), dict(model.bytes), \
            dict(model.seconds)
        drops = []
        moe.DROP_SINKS.append(lambda n, k: drops.append((n, k)))
        try:
            if eng.device.type == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = eng.train_step(group.shard(batch), s)
            metrics = {k: float(v) for k, v in m.items()}
            if eng.device.type == "cuda":
                torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        finally:
            moe.DROP_SINKS.pop()
        out.append({
            "ms": ms, "depth": eng.last_depth,
            "model_ms": {k: (model.seconds[k] - t0s.get(k, 0.0)) * 1e3
                         for k in model.seconds},
            "model_calls": {k: [model.calls[k] - c0.get(k, 0),
                                model.bytes[k] - b0.get(k, 0)]
                            for k in model.calls
                            if model.calls[k] - c0.get(k, 0)},
            "dropped": [[int(n), k] for n, k in drops],
            "launches": launches_since(before), **metrics})
    return out


def _ep_small(group, device: str) -> dict:
    """The small path on this grid: one MoE layer of the reduced config
    (the seeded weights, this rank's experts) on 4 tokens (2 rows of 2),
    forward and backward of ``sum(out * w) + aux``: the output and the
    input's gradient on this rank."""
    import numpy as np
    import torch
    from repro_torch.models import lm, moe
    from repro_torch.tree import tree_map
    cfg = ep_config("reduced")
    D, T = group.data.size, group.model.size
    d, t = group.data_index, group.model_index
    # the first MoE layer: row 0 of the second group
    layer = tree_map(lambda w: w[0], lm.init_lm(
        torch.Generator().manual_seed(0), cfg, "cpu")["groups"][1][0]["ffn"])
    held = cfg.moe.num_experts // T

    def take(w):
        if w.dim() == 3 and w.shape[0] == cfg.moe.num_experts:
            w = w[t * held:(t + 1) * held]
        return w.clone().to(device).requires_grad_(True)

    p = tree_map(take, layer)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 2, cfg.d_model)).astype(np.float32)
    w = rng.standard_normal((2, 2, cfg.d_model)).astype(np.float32)
    rows = 2 // D
    xd = torch.from_numpy(x[d * rows:(d + 1) * rows]).to(device
                                                         ).requires_grad_()
    y, aux = moe.moe_fwd_ep(p, xd, cfg, group=group.model)
    wd = torch.from_numpy(w[d * rows:(d + 1) * rows]).to(device)
    ((y * wd).sum() + aux / D).backward()
    return {"y": y.detach().cpu().numpy(), "dx": xd.grad.cpu().numpy(),
            "aux": float(aux)}


def ep_rank(group, part: str, device: str) -> dict:
    """Phase 22, one rank of a ``(data, model)`` grid.  Part ``"a"``:
    reduced deepseek-v2-lite-16b (f32, the kernels, from the CPU-drawn
    seeded weights) at capacity 1.25 and 8, two steps each, then the small
    path; part ``"b"``: its 3-layer cut at published widths, bf16, from
    ``init_state(0)`` on the card's generator, one k 4 cycle."""
    import gc
    import torch
    from repro_torch.config import TrainConfig
    from repro_torch.configs import make_batch
    from repro_torch.data.pipeline import Pipeline
    from repro_torch.dist import steps as steps_lib
    from repro_torch.models import lm
    from repro_torch.tree import tree_leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    if part == "a":
        for cap in (1.25, 8.0):
            cfg = ep_config("reduced", capacity_factor=cap)
            eng = _ep_engine(cfg, group, EP_STEPS)
            eng.attach_state(steps_lib.state_from_params(
                lm.init_lm(torch.Generator().manual_seed(0), cfg, "cpu"),
                TrainConfig()))
            pipe = Pipeline(cfg, EP_ROWS, EP_SEQ, seed=0)
            out[f"cap{cap}"] = {
                "steps": _ep_steps(eng, group, [pipe.get_batch(s) for s in
                                                range(EP_STEPS)]),
                "replicated": _replicated_digest(eng)}
        out["small"] = _ep_small(group, device)
        return out
    cfg = ep_config("full")
    eng = _ep_engine(cfg, group, EP_FULL_STEPS)
    eng.init_state(0)
    held = sum(t.numel() for t in tree_leaves(eng.state["params"]))
    batches = [make_batch(cfg, 2, 2048, seed=s, device="cuda")
               for s in range(EP_FULL_STEPS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    steps = _ep_steps(eng, group, batches)
    out["full"] = {"steps": steps, "params": held,
                   "max_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                   "replicated": _replicated_digest(eng)}
    del eng, batches
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _ep_dense_one_process(cfg, device: str) -> list:
    """Reduced deepseek's dense path in one process on ``device`` from the
    same weights and batches: each step's xent."""
    import torch
    from repro_torch.config import SPBConfig, TrainConfig
    from repro_torch.data.pipeline import Pipeline
    from repro_torch.dist import steps as steps_lib
    from repro_torch.engine.engine import SPBEngine
    from repro_torch.models import lm
    dense = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, impl="dense"))
    eng = SPBEngine(dense, TrainConfig(num_steps=EP_STEPS),
                    SPBConfig(mode="temporal", k=4), device=device,
                    shared_cache=False)
    eng.attach_state(steps_lib.state_from_params(
        lm.init_lm(torch.Generator().manual_seed(0), dense, "cpu"),
        TrainConfig()))
    pipe = Pipeline(dense, EP_ROWS, EP_SEQ, seed=0)
    return [float(eng.train_step(pipe.get_batch(s), s)["xent"])
            for s in range(EP_STEPS)]


def _ep_spawn(grid, part: str, device: str) -> list:
    """:func:`ep_rank`'s ``part`` on the ``(data, model)`` ``grid``."""
    from repro_torch.launch import mesh
    return mesh.spawn("chip_smoke:ep_rank", grid[0] * grid[1], part, device,
                      device=device, grid=grid, timeout_s=DP_JOIN_S)


def ep_reduced_runs() -> tuple:
    """Phase 22 (a)'s runs, held by :func:`phase_expert_parallel`: each
    grid of :data:`EP_GRIDS` on the card and on the CPU, and one process's
    dense steps on the card at capacity 8.  Reduced and small on the card,
    they run beside phases 18 (b) and 19 (b, c) (``main``)."""
    from concurrent.futures import ThreadPoolExecutor
    tp = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        runs = {(g, dev): pool.submit(_ep_spawn, g, "a", dev)
                for g in EP_GRIDS for dev in ("cuda", "cpu")}
        dense = _ep_dense_one_process(ep_config("reduced",
                                                capacity_factor=8.0), "cuda")
        runs = {k: f.result() for k, f in runs.items()}
    log(f"[expert-parallel] part a grids={list(EP_GRIDS)} card and cpu: "
        f"{time.perf_counter() - tp:.1f}s")
    return runs, dense


def phase_expert_parallel(smi: str, reduced: tuple) -> dict:
    """Phase 22: expert parallelism on ``(data, model)`` grids of ranks
    sharing the card over gloo (``launch/mesh.spawn(grid=(D, T))``,
    ``SPBEngine(group=<GridGroup>)``,
    ``models/moe.moe_fwd_ep``).  (a) reduced deepseek-v2-lite-16b with
    ``impl="ep"``, f32 on the kernels, on (1, 2) and (2, 2), two temporal
    steps, each grid also on the CPU: every step's loss within
    :data:`EP_TOL` of the same grid's CPU run; at capacity 8 the xent
    within :data:`EP_DENSE_TOL` of one process's dense step on the card
    (the loss adds 0.01 x the aux, which under expert parallelism is the
    mean of each rank's Switch loss over its own tokens, not the global
    one, as in the reference); every
    rank's non-expert parameters bit-identical; the small path (4 tokens)
    within phase 3's f32 ``TOL`` of the CPU; the model group's calls and
    bytes a step ``analysis/roofline.ep_calls``'s; launches exact.  (b)
    deepseek-v2-lite-16b at published widths cut to 3 layers (the dense
    layer 0 and 2 MoE layers of 64 experts of width 1408, 32 a rank),
    bf16, on (1, 2), batch 2 x 2048, one k 4 cycle: a line a rank and
    depth with the step ms (warm where the cycle's second half ran the
    depth), the model group's host ms, calls and payload bytes by kind
    (held exact against the reckoning), each MoE
    layer's share of routed slots dropped at capacity 1.25, the flash
    kernels' launches against ``expected_launches`` (MLA's attention on
    the padded D 256), and the peak beside the reckoning
    (:data:`TP_BYTES_A_PARAM` a parameter held, plus
    :data:`EP_ACT_GB`).  ``reduced``: (a)'s runs (:func:`ep_reduced_runs`).
    Returns each run's launches a rank, and the figures."""
    import torch
    from repro_torch.analysis import roofline
    from repro_torch.config import layer_kinds
    from repro_torch.models import lm
    from repro_torch.models.moe import capacity
    from repro_torch.tree import tree_leaves

    failed, launches, figures = [], {}, {}
    t0 = time.perf_counter()
    full = ep_config("full")
    # the reckoning, before the runs: what a rank of (b) holds
    m = full.moe
    D, T = EP_FULL_GRID
    expert = 3 * full.d_model * m.d_ff_expert
    whole = sum(t.numel() for t in tree_leaves(lm.param_shapes(full)))
    moe_layers = sum(1 for _k, f in layer_kinds(full) if f == "moe")
    n_held = whole - moe_layers * expert * m.num_experts * (T - 1) // T
    reckoned_gb = n_held * TP_BYTES_A_PARAM(D) / 1e9
    c = capacity(2 // D * 2048 // T * m.top_k, m.num_experts,
                 m.capacity_factor)
    log(f"[expert-parallel] reckoning full grid={EP_FULL_GRID}: {n_held} "
        f"parameters a rank ({m.num_experts // T} of {m.num_experts} "
        f"experts of width {m.d_ff_expert} in each of {moe_layers} MoE "
        f"layers), {reckoned_gb:.3f} GB of state at "
        f"{TP_BYTES_A_PARAM(D):g} B a parameter; capacity C={c}, an "
        f"all-to-all sends E C D 2 = {m.num_experts * c * full.d_model * 2}"
        f" B card={smi}")

    runs, dense = reduced
    for grid in EP_GRIDS:
        gd, gt = grid
        card, cpu = runs[(grid, "cuda")], runs[(grid, "cpu")]
        for cap in ("cap1.25", "cap8.0"):
            ccfg = ep_config("reduced", capacity_factor=float(cap[3:]))
            digests = {r[cap]["replicated"] for r in card}
            if len(digests) != 1:
                failed.append(f"{cap} grid={grid}: the ranks' non-expert "
                              f"parameters differ ({len(digests)} digests)")
            for r, (got, want) in enumerate(zip(card, cpu)):
                key = f"reduced/{cap}/grid{gd}{gt}/rank{r}"
                run = got[cap]["steps"]
                launches[key] = {k: sum(st["launches"][k] for st in run)
                                 for k in KERNELS}
                rel = max(abs(a["loss"] - b["loss"]) / abs(b["loss"])
                          for a, b in zip(run, want[cap]["steps"]))
                if not rel <= EP_TOL:
                    failed.append(f"{key}: loss card vs cpu {rel:.3e}")
                if cap == "cap8.0":     # the aux differs by definition
                    dr = max(abs(a["xent"] - b) / abs(b)
                             for a, b in zip(run, dense))
                    if not dr <= EP_DENSE_TOL:
                        failed.append(f"{key}: xent vs one dense process "
                                      f"{dr:.3e} > {EP_DENSE_TOL:g}")
                for i, st in enumerate(run):
                    want_l = expected_launches(ccfg, [st["depth"]])
                    if st["launches"] != want_l:
                        failed.append(f"{key} step {i}: launches "
                                      f"{st['launches']} != {want_l}")
                    calls = {k: list(v) for k, v in roofline.ep_calls(
                        ccfg, EP_ROWS // gd, EP_SEQ, model_parallel=gt,
                        depth=st["depth"]).items()}
                    if st["model_calls"] != calls:
                        failed.append(f"{key} step {i}: model-group calls "
                                      f"{st['model_calls']} != {calls}")
                if r == 0:
                    log(f"[expert-parallel] reduced {cap} grid={grid} "
                        f"depths={[st['depth'] for st in run]} "
                        f"loss_card={[round(st['loss'], 6) for st in run]} "
                        f"loss_cpu="
                        f"{[round(st['loss'], 6) for st in want[cap]['steps']]}"
                        f" card_vs_cpu={rel:.3e} (tol {EP_TOL:g})"
                        + (f" xent_card="
                           f"{[round(st['xent'], 6) for st in run]} "
                           f"xent_dense_one_process="
                           f"{[round(x, 6) for x in dense]} vs_dense={dr:.3e}"
                           f" (tol {EP_DENSE_TOL:g})"
                           if cap == "cap8.0" else "")
                        + f" dropped={[st['dropped'] for st in run]} "
                        f"replicas_bit_identical={len(digests) == 1} "
                        f"card={smi}")
        small = max(check_all(f"ep small grid={grid} rank {r} {k}",
                              torch.from_numpy(a["small"][k]),
                              torch.from_numpy(b["small"][k]))
                    for r, (a, b) in enumerate(zip(card, cpu))
                    for k in ("y", "dx"))
        log(f"[expert-parallel] small path grid={grid} 4 tokens: "
            f"max_abs_err={small:.3e} card={smi}")
    # (b) the full-width cut
    tp = time.perf_counter()
    ranks = _ep_spawn(EP_FULL_GRID, "b", "cuda")
    log(f"[expert-parallel] part b grid={EP_FULL_GRID}: "
        f"{time.perf_counter() - tp:.1f}s")
    if len({r["full"]["replicated"] for r in ranks}) != 1:
        failed.append("full: the ranks' non-expert parameters differ")
    for r, out in enumerate(ranks):
        run = out["full"]
        key = f"full/grid{D}{T}/rank{r}"
        steps = run["steps"]
        launches[key] = {k: sum(st["launches"][k] for st in steps)
                         for k in KERNELS}
        if run["params"] != n_held:
            failed.append(f"{key}: {run['params']} parameters held, "
                          f"reckoned {n_held}")
        state_gb = n_held * (TP_BYTES_A_PARAM(D) - 8) / 1e9
        if not state_gb <= run["max_mem_gb"] <= reckoned_gb + EP_ACT_GB:
            failed.append(f"{key}: peak {run['max_mem_gb']:.3f} GB outside "
                          f"[{state_gb:.3f}, {reckoned_gb + EP_ACT_GB:.3f}]")
        for i, st in enumerate(steps):
            want_l = expected_launches(full, [st["depth"]])
            if st["launches"] != want_l:
                failed.append(f"{key} step {i}: launches {st['launches']} "
                              f"!= {want_l}")
            calls = {k: list(v) for k, v in roofline.ep_calls(
                full, 2 // D, 2048, model_parallel=T,
                depth=st["depth"]).items()}
            if st["model_calls"] != calls:
                failed.append(f"{key} step {i}: model-group calls "
                              f"{st['model_calls']} != {calls}")
            if not math.isfinite(st["loss"]):
                failed.append(f"{key} step {i}: loss not finite")
        for depth in sorted({st["depth"] for st in steps}):
            warm = [st for st in steps[len(steps) // 2:]
                    if st["depth"] == depth] or \
                [st for st in steps if st["depth"] == depth]
            mean = lambda f: sum(f(st) for st in warm) / len(warm)  # noqa
            kinds = sorted(warm[0]["model_ms"])
            fig = {"step_ms": round(mean(lambda st: st["ms"]), 2),
                   "model_host_ms": {k: round(mean(
                       lambda st: st["model_ms"][k]), 2) for k in kinds},
                   "model_calls": warm[0]["model_calls"],
                   "dropped_share_by_layer": [
                       round(n / k, 5) for n, k in warm[0]["dropped"]],
                   "max_mem_gb": round(run["max_mem_gb"], 3),
                   "reckoned_gb": round(reckoned_gb, 3),
                   "params_held": run["params"],
                   "launches": {k: c for k, c in warm[0]["launches"].items()
                                if c}}
            figures[f"{key}/depth{depth}"] = fig
            log(f"[expert-parallel] full deepseek-v2-lite-16b/"
                f"{EP_FULL_LAYERS} grid={EP_FULL_GRID} rank={r} "
                f"depth={depth} " + " ".join(f"{k}={v}" for k, v in
                                              fig.items())
                + f" losses={[round(st['loss'], 4) for st in steps]} "
                f"card={smi}")
    log(f"[expert-parallel] phase {time.perf_counter() - t0:.1f}s")
    if failed:
        raise AssertionError("expert-parallel: " + "; ".join(failed))
    return {"launches": launches, "figures": figures}


# phase 23: the training step's last knobs
FD_POLICIES = ("none", "dots", "full")   # (a): fused yi-6b under each
CZ_GRID = (2, 2, 1)              # (b): a pipeline of 2 stages x 2 data
CZ_METHODS = ("topk", "randk", "lowrank")
CZ_STEPS = 2                     # depths 4 and 2 (bwd_stages 2 and 1)
CZ_FULL_LAYERS = 2               # (b)'s full-width topk run: yi-6b cut
CG_METHODS = ("topk", "randk")   # (c): reduced deepseek on EP_GRIDS
CG_STEPS = 2
CG_FULL_STEPS = 2                # (c)'s full-width topk run on (1, 2)


def _fused_dots_run(cfg, stacked, remat: str) -> dict:
    """``FusedEngine`` of ``FUSED_J`` tenants (seeds 0..J-1) under
    ``remat`` over ``stacked``: each step's depth, ms, peak, launches
    (held to :func:`expected_launches` under the policy), loss and grad
    norm (J each, on the card), and the params after (copies on the
    card).  The counts are zeroed just before the run."""
    import gc
    import torch
    from repro_torch.config import SPBConfig, TrainConfig
    from repro_torch.engine import FusedEngine
    from repro_torch.tree import tree_leaves

    gc.collect()
    torch.cuda.empty_cache()
    eng = FusedEngine(cfg, TrainConfig(num_steps=FUSED_STEPS),
                      SPBConfig(mode="temporal", k=4), num_jobs=FUSED_J,
                      device="cuda", remat=remat, shared_cache=False)
    eng.init_states(list(range(FUSED_J)))
    zero_launches()
    rows = []
    for s, batch in enumerate(stacked):
        before = launches_now()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = eng.train_step(batch, s)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        d = eng.last_depth
        grew = check_launches(f"fused-dots {remat} step {s}", before, [d],
                              cfg, remat)
        rows.append({"depth": d, "ms": ms,
                     "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                     "launches": {n: c for n, c in grew.items() if c},
                     **{k: m[k].detach().clone()
                        for k in ("loss", "grad_norm")}})
        if not all(math.isfinite(x) for x in rows[-1]["loss"].tolist()):
            raise AssertionError(f"fused-dots {remat}: loss not finite "
                                 f"at step {s}")
    out = {"rows": rows,
           "launches": {n: c for n, c in launches_now().items() if c},
           "params": [t.detach().clone() for t in tree_leaves(
               eng.state["params"])],
           "names": _leaf_names(eng.state["params"])}
    del eng
    torch.cuda.empty_cache()
    return out


def phase_fused_dots(smi: str) -> dict:
    """Phase 23 (a): ``FusedEngine`` of ``FUSED_J`` tenants of yi-6b at
    phase 14's cut (published widths, ``FUSED_LAYERS`` layers, batch 2 x
    2048 each, temporal k 4, ``FUSED_STEPS`` steps) under 'none', 'dots'
    and 'full' from the same seeds and batches: every step's launches
    exactly :func:`expected_launches` under its policy (a live layer's
    flash forward twice under the recompute), and 'dots''s and 'full''s
    losses, grad norms and updated parameters held to 'none''s bit for
    bit or within ``TOL`` (:func:`_hold_to`); a line a policy with the
    warm ms and the peak by depth.  Returns the 'dots' run's launch
    counts (zeroed just before it) and the figures."""
    from repro_torch.configs import (FULL_WIDTH_BATCH, FULL_WIDTH_SEQ,
                                     make_batch)
    from repro_torch.engine import stack_batches

    t0 = time.perf_counter()
    cfg = fused_config("yi-6b")
    stacked = [stack_batches([make_batch(cfg, FULL_WIDTH_BATCH,
                                         FULL_WIDTH_SEQ, seed=100 * j + s,
                                         device="cuda")
                              for j in range(FUSED_J)])
               for s in range(FUSED_STEPS)]
    runs, figures = {}, {}
    for remat in FD_POLICIES:
        run = _fused_dots_run(cfg, stacked, remat)
        differ = {} if remat == "none" else _hold_to(
            f"fused {remat}", run, runs["none"])
        half = FUSED_STEPS // 2         # the second cycle: every depth warm
        fig = {"warm_ms": {}, "peak_gb": {}, "launches_a_step": {}}
        for r in run["rows"][half:]:
            fig["warm_ms"].setdefault(r["depth"], []).append(
                round(r["ms"], 2))
            fig["peak_gb"][r["depth"]] = round(max(
                r["peak_gb"], fig["peak_gb"].get(r["depth"], 0.0)), 3)
            fig["launches_a_step"][r["depth"]] = r["launches"]
        fig.update(launches=run["launches"], differ=differ)
        figures[remat] = fig
        log(f"[fused-dots] yi-6b/{cfg.num_layers} J={FUSED_J} "
            f"{remat} depths={[r['depth'] for r in run['rows']]} "
            f"warm_step_ms={fig['warm_ms']} max_mem_gb={fig['peak_gb']} "
            f"launches_a_step={fig['launches_a_step']} "
            f"bit_equal_to_none={not differ} differ={differ} "
            f"losses={[[round(x, 4) for x in r['loss'].tolist()] for r in run['rows'][:2]]} "
            f"card={smi}")
        if remat == "none":
            runs["none"] = run
        del run
    del runs, stacked
    log(f"[fused-dots] phase {time.perf_counter() - t0:.1f}s")
    return {"launches": figures["dots"]["launches"], "figures": figures}


def cz_config(what: str):
    """Phase 23 (b)'s configs: ``"full"`` (yi-6b's 2-layer cut), else
    reduced yi-6b on the kernels."""
    from repro_torch.configs import full_width_config, reduced_config
    if what == "full":
        return dataclasses.replace(full_width_config("yi-6b"),
                                   num_layers=CZ_FULL_LAYERS)
    return dataclasses.replace(reduced_config("yi-6b"), use_pallas=True)


def _compressed_steps(eng, group, batches, chunks: int) -> list:
    """Each step of a compressed rank: ms (host clock, the card
    synchronized), the compression's gather and compressor ms and the
    bytes it gathered (``dist/steps.COMPRESSION_SINKS``), depth, metrics
    and launches."""
    import torch
    from repro_torch.dist import steps as steps_lib
    cuda = eng.device.type == "cuda"
    out = []
    for s, batch in enumerate(batches):
        before = launches_now()
        got = []
        steps_lib.COMPRESSION_SINKS.append(lambda *a: got.append(a))
        try:
            if cuda:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = eng.train_step(group.shard(batch, chunks), s)
            metrics = {k: float(v) for k, v in m.items()}
            if cuda:
                torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        finally:
            steps_lib.COMPRESSION_SINKS.pop()
        (gather_s, compress_s, gathered, world), = got
        fn = eng.step_fn(eng.last_depth)
        out.append({"ms": ms,
                    "bwd_stages": getattr(fn, "bwd_stages", None),
                    "gather_ms": gather_s * 1e3,
                    "compress_ms": compress_s * 1e3,
                    "gathered_bytes": gathered, "world_bytes": world,
                    "depth": eng.last_depth,
                    "launches": launches_since(before), **metrics})
    return out


def cz_rank(group, parts: str, device: str) -> dict:
    """Phase 23 (b), one rank of the ``(stage, data, model)`` grid under
    ZeRO-2, running each of ``parts`` in turn.  Part ``"a"``: reduced
    yi-6b (f32, from the CPU-drawn seeded weights) under each of
    :data:`CZ_METHODS`, two steps; part ``"b"``: yi-6b's 2-layer cut at
    published widths, bf16, ``topk``, from ``init_state(0)`` on the card's
    generator."""
    import gc
    import torch
    from repro_torch.config import SPBConfig, TrainConfig
    from repro_torch.configs import make_batch
    from repro_torch.data.pipeline import Pipeline
    from repro_torch.dist import steps as steps_lib
    from repro_torch.engine.engine import SPBEngine
    from repro_torch.models import lm

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    D = group.data.size

    def engine(cfg, method):
        return SPBEngine(cfg, TrainConfig(num_steps=CZ_STEPS,
                                          microbatches=PIPE_M,
                                          compression=method),
                         SPBConfig(mode="temporal", k=4), group=group,
                         parallelism="pipeline", zero2=True,
                         shared_cache=False)

    out = {}
    if "a" in parts:
        cfg = cz_config("reduced")
        pipe = Pipeline(cfg, PIPE_M * D, 64, seed=0)
        batches = [pipe.get_batch(s) for s in range(CZ_STEPS)]
        for method in CZ_METHODS:
            eng = engine(cfg, method)
            eng.attach_state(steps_lib.state_from_params(
                lm.init_lm(torch.Generator().manual_seed(0), cfg, "cpu"),
                TrainConfig()))
            out[method] = _compressed_steps(eng, group, batches, PIPE_M)
        del eng
    if "b" not in parts:
        return out
    cfg = cz_config("full")
    eng = engine(cfg, "topk")
    eng.init_state(0)
    batches = [make_batch(cfg, PIPE_M * D, 2048, seed=s, device="cuda")
               for s in range(CZ_STEPS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out["full"] = {"steps": _compressed_steps(eng, group, batches, PIPE_M),
                   "max_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    del eng, batches
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _cz_one_process(method: str) -> list:
    """Reduced yi-6b in one process on the card, compressed: each step's
    metrics, the cycle snapped to the 2 stages."""
    import torch
    from repro_torch.config import SPBConfig, TrainConfig
    from repro_torch.data.pipeline import Pipeline
    from repro_torch.dist import steps as steps_lib
    from repro_torch.engine.engine import SPBEngine
    from repro_torch.models import lm
    cfg = cz_config("reduced")
    eng = SPBEngine(cfg, TrainConfig(num_steps=CZ_STEPS, microbatches=PIPE_M,
                                     compression=method),
                    SPBConfig(mode="temporal", k=4,
                              pipeline_stages=CZ_GRID[0]),
                    device="cuda", shared_cache=False)
    eng.attach_state(steps_lib.state_from_params(
        lm.init_lm(torch.Generator().manual_seed(0), cfg, "cpu"),
        TrainConfig()))
    pipe = Pipeline(cfg, PIPE_M * CZ_GRID[1], 64, seed=0)
    return [{k: float(v) for k, v in eng.train_step(
        pipe.get_batch(s), s).items()} for s in range(CZ_STEPS)]


def cg_rank(group, parts: str, device: str) -> dict:
    """Phase 23 (c), one rank of a ``(data, model)`` grid, running each of
    ``parts`` in turn.  Part ``"a"``: reduced deepseek-v2-lite-16b
    (``impl="ep"``, f32, the kernels, from the CPU-drawn seeded weights)
    under each of :data:`CG_METHODS`, two steps; part ``"b"``: phase 22's
    3-layer cut at published widths, bf16, ``topk``, from
    ``init_state(0)`` on the card's generator."""
    import gc
    import torch
    from repro_torch.config import SPBConfig, TrainConfig
    from repro_torch.configs import make_batch
    from repro_torch.data.pipeline import Pipeline
    from repro_torch.dist import steps as steps_lib
    from repro_torch.engine.engine import SPBEngine
    from repro_torch.models import lm

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def engine(cfg, method, steps):
        return SPBEngine(cfg, TrainConfig(num_steps=steps,
                                          compression=method),
                         SPBConfig(mode="temporal", k=4), group=group,
                         shared_cache=False)

    out = {}
    if "a" in parts:
        cfg = ep_config("reduced")
        pipe = Pipeline(cfg, EP_ROWS, EP_SEQ, seed=0)
        batches = [pipe.get_batch(s) for s in range(CG_STEPS)]
        for method in CG_METHODS:
            eng = engine(cfg, method, CG_STEPS)
            eng.attach_state(steps_lib.state_from_params(
                lm.init_lm(torch.Generator().manual_seed(0), cfg, "cpu"),
                TrainConfig()))
            out[method] = _compressed_steps(eng, group, batches, 1)
        del eng
    if "b" not in parts:
        return out
    cfg = ep_config("full")
    eng = engine(cfg, "topk", CG_FULL_STEPS)
    eng.init_state(0)
    batches = [make_batch(cfg, 2, 2048, seed=s, device="cuda")
               for s in range(CG_FULL_STEPS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out["full"] = {"steps": _compressed_steps(eng, group, batches, 1),
                   "max_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    del eng, batches
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _split_line(st: dict) -> str:
    """A compressed step's ms split into the gather, the compressor and
    the rest, and its gathered bytes beside a world-wide gather's."""
    rest = st["ms"] - st["gather_ms"] - st["compress_ms"]
    return (f"step_ms={st['ms']:.2f} gather_ms={st['gather_ms']:.2f} "
            f"compress_ms={st['compress_ms']:.2f} rest_ms={rest:.2f} "
            f"gathered_bytes={st['gathered_bytes']} "
            f"world_gather_bytes={st['world_bytes']}")


# phase 23's grids whose ranks run the reduced part, then the full-width one
CZ_FULL_RUNS = {("cz", CZ_GRID): "cz_rank", ("cg", EP_FULL_GRID): "cg_rank"}


def _cz_spawn(target: str, grid, parts: str, device: str) -> list:
    """``target`` (:func:`cz_rank` or :func:`cg_rank`) on ``grid``."""
    from repro_torch.launch import mesh
    return mesh.spawn(f"chip_smoke:{target}", math.prod(grid), parts,
                      device, device=device, grid=grid, timeout_s=DP_JOIN_S)


def compressed_reduced_runs() -> tuple:
    """Phase 23 (b) and (c)'s reduced runs, held by
    :func:`phase_compressed_grids`: every grid on the CPU, the card's
    (2, 2) ``(data, model)`` grid, and one compressed process on the card
    a method.  Reduced and small on the card, they run beside phases
    18 (b) and 19 (b, c) (``main``)."""
    from concurrent.futures import ThreadPoolExecutor
    t0 = time.perf_counter()
    with ThreadPoolExecutor(4) as pool:
        cpu = {("cz", CZ_GRID): pool.submit(_cz_spawn, "cz_rank", CZ_GRID,
                                            "a", "cpu")}
        cpu.update({("cg", g): pool.submit(_cz_spawn, "cg_rank", g, "a",
                                           "cpu") for g in EP_GRIDS})
        card = {("cg", g): pool.submit(_cz_spawn, "cg_rank", g, "a", "cuda")
                for g in EP_GRIDS if ("cg", g) not in CZ_FULL_RUNS}
        one = {m: _cz_one_process(m) for m in CZ_METHODS}
        cpu = {k: f.result() for k, f in cpu.items()}
        card = {k: f.result() for k, f in card.items()}
    log(f"[compressed] reduced runs on the cpu, and on the card's "
        f"{[g for _, g in card]}: {time.perf_counter() - t0:.1f}s")
    return cpu, card, one


def phase_compressed_grids(smi: str, reduced: tuple) -> dict:
    """Phase 23 (b) and (c): compression where the ranks hold shares.
    (b) ZeRO-2 on a pipeline of :data:`CZ_GRID` (ranks sharing the card
    over gloo): reduced yi-6b under ``topk``, ``randk`` and ``lowrank``,
    two steps at depths 4 and 2, each rank's loss, xent and grad norm
    within :data:`PIPE_TOL` of the same grid on the CPU and of one
    compressed process on the card, launches exact
    (:func:`expected_stage_launches`); then yi-6b's
    :data:`CZ_FULL_LAYERS`-layer cut at published widths under ``topk``,
    two steps.  (c) reduced deepseek-v2-lite-16b on :data:`EP_GRIDS` under
    ``topk`` and ``randk``, card against the same grid on the CPU within
    :data:`EP_TOL`, launches exact; then phase 22's cut under ``topk`` on
    (1, 2), two steps.  A line a full-width rank and step with the step's
    ms split into the gather, the compressor and the rest, the gathered
    bytes beside a world-wide gather's, and the peak.  ``reduced``: the
    reduced runs (:func:`compressed_reduced_runs`).  Returns each run's
    launches a rank, and the figures."""
    failed, launches, figures = [], {}, {}
    t0 = time.perf_counter()
    S, D, T = CZ_GRID
    cpu, card, one = reduced
    card = dict(card)
    # the grids whose ranks also run a full-width part, one at a time (a
    # full-width run shares the card with nothing else of this phase)
    timed = {}
    for (kind, grid), target in CZ_FULL_RUNS.items():
        tp = time.perf_counter()
        ranks = _cz_spawn(target, grid, "ab", "cuda")
        log(f"[compressed] {kind} grid={grid}, reduced then full: "
            f"{time.perf_counter() - tp:.1f}s")
        card[(kind, grid)] = ranks
        timed[(kind, grid)] = ranks
    rcfg = cz_config("reduced")
    for (kind, grid), ranks in card.items():
        methods = CZ_METHODS if kind == "cz" else CG_METHODS
        tol = PIPE_TOL if kind == "cz" else EP_TOL
        for method in methods:
            worst = {"cpu": 0.0, "one_process": 0.0}
            for r, (got, want) in enumerate(zip(ranks, cpu[(kind, grid)])):
                run = got[method]
                key = f"{kind}/{method}/grid{''.join(map(str, grid))}/rank{r}"
                launches[key] = {k: sum(st["launches"][k] for st in run)
                                 for k in KERNELS}
                pairs = [("cpu", st, w) for st, w in
                         zip(run, want[method])]
                if kind == "cz":
                    pairs += [("one_process", st, w) for st, w in
                              zip(run, one[method])]
                for what, st, w in pairs:
                    for k in ("loss", "xent", "grad_norm"):
                        rel = abs(st[k] - w[k]) / abs(w[k])
                        worst[what] = max(worst[what], rel)
                        if not rel <= tol:
                            failed.append(f"{key}: {k} card vs {what} "
                                          f"{rel:.3e} > {tol:g}")
                for i, st in enumerate(run):
                    if kind == "cz":
                        want_l = expected_stage_launches(
                            rcfg, r // (D * T), st["bwd_stages"])
                    else:
                        want_l = expected_launches(ep_config("reduced"),
                                                   [st["depth"]])
                    if st["launches"] != want_l:
                        failed.append(f"{key} step {i}: launches "
                                      f"{st['launches']} != {want_l}")
            run = ranks[0][method]
            log(f"[compressed] reduced {kind} {method} grid={grid} "
                f"depths={[st['depth'] for st in run]} "
                f"loss_card={[round(st['loss'], 6) for st in run]} "
                f"loss_cpu="
                f"{[round(st['loss'], 6) for st in cpu[(kind, grid)][0][method]]}"
                f" max_rel_card_vs_cpu={worst['cpu']:.3e}"
                + (f" max_rel_card_vs_one_process="
                   f"{worst['one_process']:.3e}" if kind == "cz" else "")
                + f" (tol {tol:g}) gathered_bytes="
                f"{[st['gathered_bytes'] for st in run]} world_gather_bytes="
                f"{[st['world_bytes'] for st in run]} card={smi}")
    # the full-width runs
    for (kind, grid), ranks in timed.items():
        cfg = cz_config("full") if kind == "cz" else ep_config("full")
        dd = grid[1] if kind == "cz" else grid[0]
        tt = grid[2] if kind == "cz" else grid[1]
        for r, out in enumerate(ranks):
            run = out["full"]
            key = f"full/{kind}/grid{''.join(map(str, grid))}/rank{r}"
            launches[key] = {k: sum(st["launches"][k]
                                    for st in run["steps"])
                             for k in KERNELS}
            for i, st in enumerate(run["steps"]):
                if kind == "cz":
                    want_l = expected_stage_launches(cfg, r // (dd * tt),
                                                     st["bwd_stages"])
                else:
                    want_l = expected_launches(cfg, [st["depth"]])
                if st["launches"] != want_l:
                    failed.append(f"{key} step {i}: launches "
                                  f"{st['launches']} != {want_l}")
                if not math.isfinite(st["loss"]):
                    failed.append(f"{key} step {i}: loss not finite")
                figures[f"{key}/step{i}"] = {
                    k: (round(v, 3) if isinstance(v, float) else v)
                    for k, v in st.items() if k != "launches"}
                log(f"[compressed] full {kind} {cfg.name}/"
                    f"{cfg.num_layers} topk grid={grid} rank={r} step={i} "
                    f"depth={st['depth']} {_split_line(st)} "
                    f"loss={st['loss']:.4f} "
                    f"max_mem_gb={run['max_mem_gb']:.3f} card={smi}")
    log(f"[compressed] phase {time.perf_counter() - t0:.1f}s")
    if failed:
        raise AssertionError("compressed: " + "; ".join(failed))
    return {"launches": launches, "figures": figures}


# -- phase 24: spatial co-location on one card -----------------------------

SPATIAL_ARCHS = ("yi-6b", "mamba2-2.7b")    # phase 14's cuts, one a job
SPATIAL_STEPS = 6       # (b): moved at step 2, back at step 4
SPATIAL_TOL = 1e-3      # (b): phase 14's relative check
PRODUCT_N = 8192        # (a): one bf16 N^3 product
# (a): a share's product takes at least this share of (the card's SMs
# over the share's) times the whole card's time: a partition that is not
# real runs at the whole card's speed
SLOWDOWN_MIN = 0.7
# (a): two shares' products at once each within this factor of alone, and
# overlapping for at least this share of the shorter run
CONCURRENT_MAX = 1.3
OVERLAP_MIN = 0.5


def _stream_ms(fn, stream, iters: int = 10, warmup: int = 2) -> float:
    """``fn``'s ms by CUDA events on ``stream`` (waited on by its end
    event: a share's stream is not the primary context's)."""
    import torch
    with torch.cuda.stream(stream):
        for _ in range(warmup):
            fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


# the route not taken, in a process of its own: a green context that
# torch made current leaves the allocator blocks it mapped in that context,
# which cannot be freed once the context is gone
_TORCH_GREEN = """
import json, sys, threading, time
import torch
from torch.cuda.green_contexts import GreenContext
sms, n, iters = map(int, sys.argv[1:4])
A = torch.randn(n, n, device="cuda", dtype=torch.bfloat16)
B = torch.randn(n, n, device="cuda", dtype=torch.bfloat16)
torch.cuda.synchronize()
ctxs = [GreenContext.create(num_sms=sms, device_id=0) for _ in range(2)]
out = [None, None]

def run(i):
    ctxs[i].set_context()
    try:
        stream = ctxs[i].Stream()
        with torch.cuda.stream(stream):
            A @ B                       # warm
        stream.synchronize()
        t0 = time.perf_counter()
        with torch.cuda.stream(stream):
            for _ in range(iters):
                A @ B
        stream.synchronize()
        out[i] = (time.perf_counter() - t0) * 1e3
    finally:
        ctxs[i].pop_context()

threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
for t in threads:
    t.start()
for t in threads:
    t.join(120)
print(json.dumps(out))
"""


def _torch_green_contexts_ms(sms: int, iters: int = 10) -> list:
    """The route not taken: two ``torch.cuda.green_contexts`` of ``sms``
    SMs each, ``iters`` bf16 products on each from two threads at once;
    the wall ms of each thread."""
    out = _run_child(_TORCH_GREEN, str(sms), str(PRODUCT_N), str(iters),
                     timeout=180)
    if None in out:
        raise AssertionError(f"spatial: torch's green contexts did not "
                             f"finish: {out}")
    return out


def phase_spatial_share(subs) -> dict:
    """Phase 24 (a): the shares themselves (see the module docstring)."""
    import torch
    from repro_torch.device import card_units, on_share
    from repro_torch.kernels import rglru

    units = card_units("cuda")
    if [len(s.units) * units.unit_sms for s in subs] != [s.sms for s in subs]:
        raise AssertionError(f"spatial: submeshes {subs} against "
                             f"{units.unit_sms} SMs a unit")
    log(f"[spatial] units={units.count} unit_sms={units.unit_sms} "
        f"leftover_sms={units.leftover_sms} card_sms={units.total_sms} "
        f"submeshes={[(s.index, s.units, s.sms) for s in subs]}")
    # a tensor of the primary context's allocator, read and written by a
    # port kernel and by a bf16 product on each share
    gen = torch.Generator(device="cuda").manual_seed(0)
    a = torch.rand(2, 2048, 2560, device="cuda", generator=gen) * 0.9
    b = torch.randn(2, 2048, 2560, device="cuda", generator=gen)
    n = PRODUCT_N
    A = torch.randn(n, n, device="cuda", dtype=torch.bfloat16, generator=gen)
    B = torch.randn(n, n, device="cuda", dtype=torch.bfloat16, generator=gen)
    h_card, c_card = rglru.rglru_scan(a, b), A[:256] @ B
    for sub in subs:
        with on_share(sub.share):
            h, c = rglru.rglru_scan(a, b), A[:256] @ B
            w = a.clone()
            w.mul_(2.0)
        sub.share.stream.synchronize()
        err = (c.float() - c_card.float()).abs().max().item()
        if not torch.equal(h, h_card) or not torch.equal(w, a * 2.0) or \
                err > TOL["bfloat16"][1] * c_card.float().abs().max().item():
            raise AssertionError(f"spatial: submesh {sub.index}: rglru "
                                 f"equal {torch.equal(h, h_card)}, write "
                                 f"{torch.equal(w, a * 2.0)}, product err "
                                 f"{err}")
        log(f"[spatial] submesh={sub.index} rglru_bit_equal=True "
            f"write_ok=True product_max_abs_err={err} "
            f"product_bit_equal={torch.equal(c, c_card)}")
    card = torch.cuda.current_stream()
    whole = _stream_ms(lambda: A @ B, card)
    alone = [_stream_ms(lambda: A @ B, s.share.stream) for s in subs]
    for sub, ms in zip(subs, alone):
        ratio, want = ms / whole, units.total_sms / sub.sms
        log(f"[spatial] product {n}^3 bf16 submesh={sub.index} "
            f"sms={sub.sms} ms={ms:.4f} whole_card_ms={whole:.4f} "
            f"slowdown={ratio:.3f} card_sms/sms={want:.3f}")
        if ratio < SLOWDOWN_MIN * want:
            raise AssertionError(f"spatial: submesh {sub.index} of {sub.sms} "
                                 f"SMs runs the product {ratio:.2f}x the "
                                 f"whole card's time, not ~{want:.2f}x: "
                                 f"the partition is not real")
    # both shares at once: each alone's speed (disjoint SMs), overlapping
    iters = 10
    t0 = torch.cuda.Event(enable_timing=True)
    t0.record()
    marks = []
    for sub in subs:
        s0 = torch.cuda.Event(enable_timing=True)
        s1 = torch.cuda.Event(enable_timing=True)
        with on_share(sub.share):
            s0.record()
            for _ in range(iters):
                A @ B
            s1.record()
        marks.append((s0, s1))
    for _, s1 in marks:
        s1.synchronize()
    spans = [(t0.elapsed_time(s0), t0.elapsed_time(s1)) for s0, s1 in marks]
    both = [(e - s) / iters for s, e in spans]
    overlap = min(e for _, e in spans) - max(s for s, _ in spans)
    shorter = min(e - s for s, e in spans)
    log(f"[spatial] concurrent {iters} products a submesh: spans_ms="
        f"{[(round(s, 3), round(e, 3)) for s, e in spans]} "
        f"overlap_ms={overlap:.3f} ms_a_product={[round(x, 4) for x in both]}"
        f" alone_ms={[round(x, 4) for x in alone]}")
    if overlap < OVERLAP_MIN * shorter or any(
            x > CONCURRENT_MAX * y for x, y in zip(both, alone)):
        raise AssertionError(f"spatial: the shares' products overlapped "
                             f"{overlap:.2f} of {shorter:.2f} ms at "
                             f"{both} ms against {alone} alone")
    torch_ms = _torch_green_contexts_ms(subs[-1].sms, iters)
    log(f"[spatial] torch.cuda.green_contexts (not used): two contexts of "
        f"{subs[-1].sms} SMs, {iters} products each at once: "
        f"wall_ms={[round(x, 3) for x in torch_ms]} against "
        f"{alone[-1] * iters:.3f} ms alone on submesh {subs[-1].index}")
    return {"units": units._asdict(),
            "submesh_sms": [s.sms for s in subs],
            "product_ms": {"whole_card": whole, "submeshes": alone,
                           "concurrent": both},
            "overlap_ms": overlap,
            "torch_green_contexts_wall_ms": torch_ms}


def phase_spatial_resize(subs) -> dict:
    """Phase 24 (b): the reference's ``_RESIZE_SCRIPT`` at published
    widths (see the module docstring).  Returns the launches, zeroed just
    before and read just after."""
    import torch
    from repro_torch.config import SPBConfig, TrainConfig
    from repro_torch.configs import (FULL_WIDTH_BATCH, FULL_WIDTH_SEQ,
                                     make_batch)
    from repro_torch.engine import SPBEngine

    cfg = fused_config("yi-6b")
    tcfg = TrainConfig(num_steps=SPATIAL_STEPS)
    spb = SPBConfig(mode="temporal", k=2)
    moved = SPBEngine(cfg, tcfg, spb, submesh=subs[0])
    stay = SPBEngine(cfg, tcfg, spb, submesh=subs[0])
    moved.init_state(0)
    stay.init_state(0)
    zero_launches()
    rows, bit_equal = [], True
    for s in range(SPATIAL_STEPS):
        if s in (2, 4):
            moved.resize(subs[1] if s == 2 else subs[0])
        batch = make_batch(cfg, FULL_WIDTH_BATCH, FULL_WIDTH_SEQ, seed=s,
                           device="cuda")
        got = {}
        for label, eng in (("moved", moved), ("stay", stay)):
            before = launches_now()
            t0 = time.perf_counter()
            m = eng.train_step(batch, s)        # returns when its share ran
            ms = (time.perf_counter() - t0) * 1e3
            check_launches(f"spatial resize {label} step {s}", before,
                           [eng.last_depth], cfg)
            got[label] = (float(m["loss"]), ms, eng.submesh.index)
        (lm_, mms, msub), (ls, sms_, _) = got["moved"], got["stay"]
        rel = abs(lm_ / ls - 1)
        bit_equal &= lm_ == ls
        rows.append(rel)
        log(f"[spatial-resize] step={s} depth={moved.last_depth} "
            f"submesh={msub} loss={lm_} stay_loss={ls} rel={rel:.3e} "
            f"ms={mms:.1f} stay_ms={sms_:.1f}")
        if not math.isfinite(lm_) or rel > SPATIAL_TOL:
            raise AssertionError(f"spatial resize step {s}: loss {lm_} "
                                 f"against {ls} (rel tol {SPATIAL_TOL})")
    grew = launches_now()
    if moved.resizes != 2 or moved.submesh is not subs[0]:
        raise AssertionError(f"spatial resize: {moved.resizes} resizes, "
                             f"on submesh {moved.submesh.index}")
    log(f"[spatial-resize] yi-6b layers={cfg.num_layers} resizes="
        f"{moved.resizes} bit_equal={bit_equal} max_rel={max(rows):.3e} "
        f"(held at {SPATIAL_TOL})")
    del moved, stay
    torch.cuda.empty_cache()
    return {"launches": {n: c for n, c in grew.items() if c},
            "bit_equal": bit_equal, "max_rel": max(rows)}


def _spatial_alone_ms(subs) -> dict:
    """Phase 24 (c)'s yardsticks: each arch's warm step ms at each depth
    of its cycle, alone on the whole card and alone on the half share
    (``subs[-1]``): {arch: {depth: [whole ms, half ms]}}."""
    import torch
    from repro_torch.config import SPBConfig, TrainConfig
    from repro_torch.configs import (FULL_WIDTH_BATCH, FULL_WIDTH_SEQ,
                                     make_batch)
    from repro_torch.engine import SPBEngine

    out = {}
    for arch in SPATIAL_ARCHS:
        cfg = fused_config(arch)
        batch = make_batch(cfg, FULL_WIDTH_BATCH, FULL_WIDTH_SEQ, seed=0,
                           device="cuda")
        out[arch] = {}
        for where in (dict(device="cuda"), dict(submesh=subs[-1])):
            eng = SPBEngine(cfg, TrainConfig(num_steps=8),
                            SPBConfig(mode="temporal", k=2), **where)
            eng.init_state(0)
            for d in [k for k in eng.depth_keys() if k is not None]:
                times = []
                for _ in range(3):          # the first warms
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    eng.train_step(batch, depth=d)
                    torch.cuda.synchronize()
                    times.append((time.perf_counter() - t0) * 1e3)
                out[arch].setdefault(d, []).append(sum(times[1:]) / 2)
            del eng
            torch.cuda.empty_cache()
    return out


def _spatial_backend():
    """A ``LiveBackend`` that logs each task's (job, worker, iteration,
    depth, measured s) from inside the job's lock, and counts the moves
    ``_ensure_submesh`` sees; its batches come from
    ``configs.make_batch`` on the card, as phase 9's."""
    from repro_torch.cluster.live import LiveBackend

    class SpatialBackend(LiveBackend):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.task_log, self.moves = [], {}

        def _ensure_submesh(self, jid, machine):
            if self.submeshes and self.engines[jid].submesh is not \
                    self.submeshes[machine]:
                self.moves[jid] = self.moves.get(jid, 0) + 1
            super()._ensure_submesh(jid, machine)

        def _attempt(self, job, task, ctx):
            measured, metrics = super()._attempt(job, task, ctx)
            self.task_log.append(dict(
                job=task.job_id, worker=task.worker_id, it=task.iteration,
                depth=self.engines[task.job_id].last_depth, s=measured))
            return measured, metrics

        def _stacked_batch(self, jid, step):
            return _card_batch(self, jid, step)

    return SpatialBackend


def _spatial_session(label: str, where: dict, count: bool):
    """One JigSaw session of ``SPATIAL_ARCHS`` (phase 24 (c)); ``where``:
    ``submeshes=`` or ``device=``.  With ``count`` the launches are zeroed
    just before ``run()`` and read just after.  Returns (result, backend,
    wall s, launches, peak GB, each engine's own resize count)."""
    import torch
    from repro_torch.cluster import ClusterRuntime, make_live_job
    from repro_torch.config import SPBConfig, TrainConfig
    from repro_torch.configs import FULL_WIDTH_BATCH, FULL_WIDTH_SEQ
    from repro_torch.jigsaw.schedulers import JigsawScheduler

    iters, workers = 3, 2
    jobs = [make_live_job(
        jid, arrival=0.0, cfg=fused_config(arch), iterations=iters,
        num_workers=workers, batch=FULL_WIDTH_BATCH, seq=FULL_WIDTH_SEQ,
        est_step_s=JIGSAW_JOBS[arch][0] / 2, est_mem_gb=20.0,
        model_size_gb=0.01,
        tcfg=TrainConfig(num_steps=iters * workers, seed=jid),
        spb=SPBConfig(mode="temporal", k=workers))
        for jid, arch in enumerate(SPATIAL_ARCHS)]
    backend = _spatial_backend()(jobs, **where)
    runtime = ClusterRuntime(backend.specs(), JigsawScheduler(), backend,
                             num_machines=2, machine_mem_gb=40.0, gamma=0.1,
                             horizon=60.0, record_schedule=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    if count:
        zero_launches()
    t0 = time.perf_counter()
    res = runtime.run()
    wall = time.perf_counter() - t0
    grew = launches_now()
    peak = torch.cuda.max_memory_allocated() / 1e9
    summary = backend.summary()
    if len(res.jct) != len(jobs) or res.failed_jobs or any(
            s["steps_run"] != iters * workers
            or not math.isfinite(s["final_xent"])
            for s in summary.values()):
        raise AssertionError(f"spatial {label}: jobs done {sorted(res.jct)}"
                             f", summary {summary}")
    log(f"[spatial-jigsaw] {label} jobs_done={len(res.jct)}/{len(jobs)} "
        f"final_xent={ {j: round(s['final_xent'], 4) for j, s in summary.items()} } "
        f"max_concurrent_tasks={backend.max_concurrent_tasks} "
        f"resizes={backend.resizes} makespan={res.makespan:.3f}s "
        f"wall_s={wall:.3f} peak_gb={peak:.3f}")
    moved = {j: e.resizes for j, e in backend.engines.items() if e.resizes}
    backend.close()
    return res, backend, wall, grew, peak, moved


def phase_spatial(smi: str) -> dict:
    """Phase 24: spatial co-location on one card (see the module
    docstring).  Returns the launches of (b) and (c), each zeroed just
    before its run and read just after, and the figures."""
    import torch
    from repro_torch.launch.mesh import assert_disjoint, make_submeshes

    t_phase = time.perf_counter()
    subs = make_submeshes(count=2, device="cuda")
    assert_disjoint(subs)
    share = phase_spatial_share(subs)
    resize = phase_spatial_resize(subs)
    alone = _spatial_alone_ms(subs)
    res, backend, wall, grew, peak, moved = _spatial_session(
        "submeshes", dict(submeshes=subs), count=True)
    want = dict.fromkeys(grew, 0)
    for t in backend.task_log:
        cfg = backend.jobs[t["job"]].cfg
        for n, c in expected_launches(cfg, [t["depth"]]).items():
            want[n] += c
        whole, half = alone[SPATIAL_ARCHS[t["job"]]][t["depth"]]
        log(f"[spatial-jigsaw] job={t['job']} worker={t['worker']} "
            f"iter={t['it']} depth={t['depth']} measured_ms="
            f"{t['s'] * 1e3:.1f} alone_whole_card_ms={whole:.1f} "
            f"alone_half_share_ms={half:.1f}")
    if grew != want:
        raise AssertionError(f"spatial session: launches {grew} != the sum "
                             f"of its tasks' {want}")
    if backend.max_concurrent_tasks != 2:
        raise AssertionError(f"spatial session: max_concurrent_tasks "
                             f"{backend.max_concurrent_tasks}, not 2")
    if not backend.resizes == backend.moves == moved:
        raise AssertionError(f"spatial session: resizes {backend.resizes} "
                             f"against the moves seen {backend.moves} and "
                             f"the engines' own counts {moved}")
    torch.cuda.empty_cache()
    _, _, wall_tm, _, peak_tm, _ = _spatial_session(
        "time-multiplexed", dict(device="cuda"), count=False)
    secs = time.perf_counter() - t_phase
    log(f"[spatial] session wall_s={wall:.3f} time_multiplexed_wall_s="
        f"{wall_tm:.3f} ratio={wall / wall_tm:.3f} peak_gb={peak:.3f} "
        f"time_multiplexed_peak_gb={peak_tm:.3f} phase_s={secs:.1f} "
        f"launches={ {n: c for n, c in grew.items() if c} } {smi}")
    torch.cuda.empty_cache()
    return {"launches": {"resize": resize["launches"],
                         "session": {n: c for n, c in grew.items() if c}},
            "figures": {
                **share, "resize_bit_equal": resize["bit_equal"],
                "resize_max_rel": resize["max_rel"],
                "alone_ms_by_depth": {a: {str(d): v for d, v in r.items()}
                                      for a, r in alone.items()},
                "task_ms": [dict(t, s=round(t["s"] * 1e3, 3))
                            for t in backend.task_log],
                "session_wall_s": wall, "time_multiplexed_wall_s": wall_tm,
                "peak_gb": peak, "time_multiplexed_peak_gb": peak_tm,
                "resizes": backend.resizes, "phase_s": secs}}


# Phase 25: sharded serving.  yi-6b at published widths and full depth,
# bf16, the kernels on, on a (data 1, model 2) grid of ranks that share
# the card over gloo; 4 slots of 16-token pages, 2048 context, prompts in
# the 64 bucket, greedy, SERVE_MAX_NEW new tokens
SHARD_ARCH = "yi-6b"
SHARD_GRID = (1, 2)
SHARD_BUCKET = 64
# (prompt length, arrival in engine steps): every prompt in the 64 bucket
SHARD_TRACE = ((60, 0), (17, 2), (41, 4), (33, 6))
# the f32 check's depth: it holds the row-parallel joins against one
# process at published widths, which a few layers show as well as 32
SHARD_F32_LAYERS = 4
# the most a rank waits for the one-process references before its trace
SHARD_GATE_S = 600.0


def shard_config(what: str):
    """Phase 25's configs: ``"full"`` (phase 12's yi-6b, bf16),
    ``"f32_full"`` (the same in f32), ``"f32"`` (its published widths at
    ``SHARD_F32_LAYERS`` layers, f32) or ``"reduced"`` (reduced yi-6b,
    f32), all on the kernels."""
    from repro_torch.configs import get_config, reduced_config
    cfg = reduced_config(SHARD_ARCH) if what == "reduced" else \
        get_config(SHARD_ARCH)
    if what.startswith("f32"):
        cfg = dataclasses.replace(cfg, dtype="float32")
    if what == "f32":
        cfg = dataclasses.replace(cfg, num_layers=SHARD_F32_LAYERS)
    return dataclasses.replace(cfg, use_pallas=True)


def shard_geometry():
    from repro_torch.serve import default_geometry
    return default_geometry(num_slots=4, page_size=16, max_context=2048)


class _HeadsSpy(_RowsSpy):
    """:class:`_RowsSpy` recording each call's (query heads, KV heads)."""

    def __call__(self, *a, **kw):
        self._rows.append((a[0].shape[1], a[1].shape[1]))
        return self._real(*a, **kw)


def _serve_trace(eng, prompts) -> dict:
    """Each prompt alone, then all of them staggered by ``SHARD_TRACE``'s
    arrivals, to the end: the outputs of each, in trace order."""
    import collections

    def run(trace):
        start, pending, reqs = eng.clock, collections.deque(trace), []
        while pending or eng._live or eng.scheduler.queue:
            while pending and pending[0][0] <= eng.clock - start:
                reqs.append(eng.submit(pending.popleft()[1],
                                       max_new=SERVE_MAX_NEW))
            eng.step(1)
            eng.poll()
        return reqs

    solo = [run([(0, p)])[0] for p in prompts]
    stag = run([(at, p) for (_, at), p in zip(SHARD_TRACE, prompts)])
    return {"solo": [r.output for r in solo],
            "staggered": [r.output for r in stag],
            "done": all(r.done for r in solo + stag)}


def _prefill_logits(params, cfg, pool, prompts, tp) -> list:
    """Each prompt's prefill logits (f32, on the host), its K/V written to
    the trash page only (a page row of page 0)."""
    import torch
    from repro_torch.models import lm
    dev = pool[0][0]["self"]["k"].device
    row = torch.zeros(shard_geometry().pages_per_slot, dtype=torch.int64,
                      device=dev)
    out = []
    for p in prompts:
        tokens = torch.zeros((1, SHARD_BUCKET), dtype=torch.int64,
                             device=dev)
        tokens[0, :len(p)] = torch.tensor(p, device=dev)
        lg, _ = lm.serve_prefill(params, tokens, cfg, pool, page_row=row,
                                 prompt_len=torch.tensor([len(p)],
                                                         device=dev), tp=tp)
        out.append(lg[0, :cfg.vocab_size].float().cpu())
    return out


def _wait_gate(path: str) -> float:
    """Wait until the file ``path`` exists; the seconds waited."""
    t0 = time.perf_counter()
    while not Path(path).exists():
        if time.perf_counter() - t0 > SHARD_GATE_S:
            raise TimeoutError(f"no {path} after {SHARD_GATE_S:g} s")
        time.sleep(0.02)
    return time.perf_counter() - t0


def shard_rank(group, prompts, rprompts, gate, ltokens) -> dict:
    """Phase 25, one rank of the (1, 2) grid: the engine from phase 12's
    seed-0 params drawn leaf by leaf (this rank's share kept), the prefill
    logits of each prompt; once the file ``gate`` exists (the parent's
    references are done), the traces with every step function's
    model-group calls and host seconds, its CUDA events, the slots live at
    the call and the flash forward's heads a call; then the f32 model's
    prefill logits and reduced yi-6b in f32 on the same grid, and the
    seconds of each part; last, yi-6b freed, the long-context decode of
    gemma3-4b (:func:`long_rank`) on the same ranks."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.serve import ServeEngine
    from repro_torch.tree import tree_leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = group.model
    cfg = shard_config("full")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = ServeEngine(cfg, geom=shard_geometry(), group=group, seed=0)
    torch.cuda.synchronize()
    out = {"init_s": time.perf_counter() - t0,
           "init_peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "held": eng.held_bytes(),
           "params": sum(t.numel() for t in tree_leaves(eng.params)),
           "local_heads": (eng.params["groups"][0][0]["mixer"]["wq"].shape[-1]
                           // cfg.head_dim,
                           eng.params["groups"][0][0]["mixer"]["wk"].shape[-1]
                           // cfg.head_dim)}
    out["logits"] = _prefill_logits(eng.params, cfg, eng.state["groups"],
                                    prompts, eng.tp)
    out["gate_s"] = _wait_gate(gate)
    calls = []
    raw = dict(eng._steps)
    for key, fn in raw.items():
        def counted(*a, key=key, fn=fn):
            c0, b0 = dict(model.calls), dict(model.bytes)
            s0 = sum(model.seconds.values())
            live = len(eng._live)
            ev = [torch.cuda.Event(enable_timing=True) for _ in "01"]
            ev[0].record()
            fn(*a)
            ev[1].record()
            calls.append((key, {k: [model.calls[k] - c0.get(k, 0),
                                    model.bytes[k] - b0.get(k, 0)]
                                for k in model.calls
                                if model.calls[k] - c0.get(k, 0)}, ev,
                          live, sum(model.seconds.values()) - s0))
        eng._steps[key] = counted
    heads = []
    real = fa.fwd_kernel_layout
    fa.fwd_kernel_layout = _HeadsSpy(real, heads)
    try:
        before = real.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out["trace"] = _serve_trace(eng, prompts)
        torch.cuda.synchronize()
        out["trace_s"] = time.perf_counter() - t0
        out["flash_fwd"] = real.launches - before
    finally:
        fa.fwd_kernel_layout = real
    out["heads"] = sorted(set(heads))
    torch.cuda.synchronize()
    # (key, calls, CUDA-event ms, slots live, host ms in the model group)
    out["calls"] = [(k, c, round(ev[0].elapsed_time(ev[1]), 4), live,
                     round(host * 1e3, 4))
                    for k, c, ev, live, host in calls]
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del eng, raw, calls
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    f32 = ServeEngine(shard_config("f32"), geom=shard_geometry(),
                      group=group, seed=0)
    out["logits_f32"] = _prefill_logits(f32.params, f32.cfg,
                                        f32.state["groups"], prompts, f32.tp)
    del f32
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    small = ServeEngine(shard_config("reduced"), geom=shard_geometry(),
                        group=group, seed=0)
    out["reduced"] = _serve_trace(small, rprompts)
    out["f32_s"], out["reduced_s"] = t1 - t0, time.perf_counter() - t1
    del small
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out["long"] = long_rank(group, ltokens)
    out["long_s"] = time.perf_counter() - t0
    return out


def _one_process_serve(prompts, rprompts) -> dict:
    """Phase 25's one-process references on the card: the prefill logits
    of phase 12's seed-0 yi-6b in bf16 and in f32 (the same draws), and of
    the f32 cut, and reduced yi-6b's traces in f32."""
    import torch
    from repro_torch.models import lm
    from repro_torch.serve import ServeEngine, cache_bytes, init_paged_cache
    out = {"pool": cache_bytes(shard_config("full"), shard_geometry())}
    for what, key in (("full", "logits"), ("f32_full", "logits_f32_full"),
                      ("f32", "logits_f32")):
        cfg = shard_config(what)
        params = lm.init_lm(torch.Generator(device="cuda").manual_seed(0),
                            cfg, "cuda")
        pool = init_paged_cache(cfg, shard_geometry(), "cuda")
        out[key] = _prefill_logits(params, cfg, pool, prompts, None)
        del params, pool
        torch.cuda.empty_cache()
    small = ServeEngine(shard_config("reduced"), geom=shard_geometry(),
                        device="cuda", seed=0)
    out["reduced"] = _serve_trace(small, rprompts)
    return out


def _shard_figures(calls) -> dict:
    """A rank's step figures from its trace's calls: each prefill's ms and
    host ms in the model group, and the decode step's (median, min, max)
    of both by the slots live at the call."""
    def stats(xs):
        xs = sorted(xs)
        return [xs[len(xs) // 2], xs[0], xs[-1]]

    live = sorted({n for k, *_, n, _h in calls if k == "decode"})
    return {"prefill_ms": [ms for k, _, ms, *_ in calls if k != "decode"],
            "prefill_model_host_ms": [h for k, *_, h in calls
                                      if k != "decode"],
            "decode_ms_by_live": {n: stats([ms for k, _, ms, m, _h in calls
                                            if k == "decode" and m == n])
                                  for n in live},
            "decode_model_host_ms_by_live": {
                n: stats([h for k, _, _ms, m, h in calls
                          if k == "decode" and m == n]) for n in live}}


def _rel(a, b) -> float:
    """||a - b|| / ||b|| of two f32 host tensors."""
    return float((a - b).norm() / b.norm())


# Phase 25's long-context decode: gemma3-4b at published widths and full
# depth, bf16, on the same (1, 2) grid, the small-batch override of the
# reference's dry run (the batch on every rank, the cache's sequence
# sharded over ("data", "model"), the attention whole), LONG_STEPS tokens
# from the end of a long_500k cache filled from a seed
LONG_ARCH, LONG_SHAPE, LONG_STEPS = "gemma3-4b", "long_500k", 4
# the f32 check's cut: one superblock of 5 local and 1 global layer, at the
# shape's full 524,288 positions
LONG_F32_LAYERS = 6
# what a rank of the (1, 2) grid holds of the full-depth bf16 cache's k and
# v, reckoned by hand: 5 global layers of (1, 262144, 4, 256) and 29 local
# rings of (1, 512, 4, 256), two tensors each, 2 B an element
LONG_CACHE_KV_BYTES = 2 * 2 * 4 * 256 * (5 * 262144 + 29 * 512)


def long_config(what: str):
    """The long-context configs: ``"bf16"`` (gemma3-4b as published),
    ``"f32_full"`` (the same in f32, the same draws) or ``"f32"`` (its
    first ``LONG_F32_LAYERS`` layers in f32)."""
    from repro_torch.configs import get_config
    cfg = get_config(LONG_ARCH)
    if what.startswith("f32"):
        cfg = dataclasses.replace(cfg, dtype="float32")
    if what == "f32":
        cfg = dataclasses.replace(cfg, num_layers=LONG_F32_LAYERS)
    return cfg


def long_tokens() -> list:
    """The LONG_STEPS tokens decoded, from seed 11."""
    import torch
    gen = torch.Generator().manual_seed(11)
    return torch.randint(0, long_config("bf16").vocab_size, (LONG_STEPS,),
                         generator=gen).tolist()


def _fill_long_cache(cache, shares: int, share=None) -> None:
    """Fill a dense cache's k and v from seeded generators, N(0, 1) drawn
    in f32 and cast, one generator a (leaf, layer row, block of the
    sequence) with ``shares`` blocks: the whole cache (``share`` None) or
    block ``share`` of it (a rank's, whose leaves hold only that block),
    so a rank's share equals its block of one process's whole cache in
    either dtype.  The position is set to the last LONG_STEPS."""
    import torch
    from repro_torch.config import SHAPES
    from repro_torch.tree import tree_leaves
    for i, t in enumerate(tree_leaves(cache["groups"])):
        W = t.shape[2] if share is not None else t.shape[2] // shares
        blocks = range(shares) if share is None else [share]
        for row in range(t.shape[0]):
            for b in blocks:
                gen = torch.Generator(device=t.device).manual_seed(
                    (i * 1000 + row) * 16 + b)
                at = 0 if share is not None else b * W
                part = torch.empty(t[row].narrow(1, at, W).shape,
                                   dtype=torch.float32, device=t.device)
                part.normal_(generator=gen)
                t[row].narrow(1, at, W).copy_(part)
                del part
    cache["pos"].fill_(SHAPES[LONG_SHAPE].seq_len - LONG_STEPS)


def _long_decode(fn, params, cache, tokens) -> list:
    """The LONG_STEPS tokens' logits (f32, on the host) of ``fn(params,
    cache, tokens)`` on the card."""
    import torch
    out = []
    for tok in tokens:
        lg, cache = fn(params, cache, torch.tensor([[tok]], device="cuda"))
        out.append(lg[0, 0].float().cpu())
    return out


def _one_process_long(tokens) -> dict:
    """Phase 25's one-process long-context references on the card: the
    logits of gemma3-4b's seed-0 draws in f32 at full depth (freed before
    the next), bf16 at full depth and f32 at the LONG_F32_LAYERS cut, each
    from the whole seeded cache."""
    import torch
    from repro_torch.config import SHAPES
    from repro_torch.models import lm
    out = {}
    S = SHAPES[LONG_SHAPE].seq_len
    for what in ("f32_full", "bf16", "f32"):
        cfg = long_config(what)
        params = lm.init_lm(torch.Generator(device="cuda").manual_seed(0),
                            cfg, "cuda")
        cache = lm.init_cache(cfg, 1, S, device="cuda")
        _fill_long_cache(cache, SHARD_GRID[1])
        out[what] = _long_decode(
            lambda p, c, t: lm.decode_step(p, c, t, cfg), params, cache,
            tokens)
        del params, cache
        torch.cuda.empty_cache()
    return out


def long_rank(group, tokens) -> dict:
    """Phase 25's long-context decode on one rank of the (1, 2) grid:
    gemma3-4b's seed-0 params drawn leaf by leaf (the rank's block kept:
    the attention whole, the FFN halved), its block of the seeded
    long_500k cache, LONG_STEPS tokens by ``shard_decode_step`` under the
    small-batch override, each step's CUDA-event ms and host seconds in
    the seq and the model group; then the same at the f32 cut; the bytes
    held and the reckoning's."""
    import torch
    from repro_torch.config import SHAPES
    from repro_torch.dist import sharding
    from repro_torch.dist import steps as steps_lib
    from repro_torch.launch import dryrun
    from repro_torch.models import lm
    from repro_torch.tree import tree_leaves, tree_map

    grid = sharding.Mesh(SHARD_GRID, ("data", "model"))
    at = sharding.mesh_coords(grid, group.rank)
    S = SHAPES[LONG_SHAPE].seq_len
    out = {}
    for what in ("bf16", "f32"):
        cfg = long_config(what)
        t0 = time.perf_counter()
        fn, pshapes, cshapes, specs = steps_lib.shard_decode_step(
            grid, cfg, 1, S, rules_overrides=dryrun.SMALL_BATCH_DECODE,
            group=group)
        with sharding.rules(dryrun.SMALL_BATCH_DECODE):
            seq = group.seq_group(grid, sharding.seq_axes(grid))
        params = lm.init_lm(torch.Generator(device="cuda").manual_seed(0),
                            cfg, "cuda", keep=sharding.share_keeper(
                                specs["params"], pshapes, grid, at))
        cache = tree_map(lambda m: torch.empty(m.shape, dtype=m.dtype,
                                               device="cuda"),
                         sharding.local_shapes(specs["cache"], cshapes, grid))
        _fill_long_cache(cache, seq.size, seq.rank)
        torch.cuda.synchronize()
        run = {"setup_s": time.perf_counter() - t0, "share": seq.rank,
               "shares": seq.size,
               "param_bytes": sum(t.numel() * t.element_size()
                                  for t in tree_leaves(params)),
               "cache_kv_bytes": sum(t.numel() * t.element_size()
                                     for t in tree_leaves(cache["groups"])),
               "reckoned_params": sharding.sharded_state_bytes(
                   pshapes, specs["params"], grid),
               "reckoned_cache": sharding.sharded_state_bytes(
                   cshapes, specs["cache"], grid)}
        steps = []

        def timed(p, c, t):
            s0 = sum(seq.seconds.values())
            m0 = sum(group.model.seconds.values())
            ev = [torch.cuda.Event(enable_timing=True) for _ in "01"]
            ev[0].record()
            res = fn(p, c, t)
            ev[1].record()
            steps.append((ev, sum(seq.seconds.values()) - s0,
                          sum(group.model.seconds.values()) - m0))
            return res

        run["logits"] = _long_decode(timed, params, cache, tokens)
        torch.cuda.synchronize()
        run["step_ms"] = [round(ev[0].elapsed_time(ev[1]), 3)
                          for ev, _, _ in steps]
        run["seq_gloo_ms"] = [round(s * 1e3, 3) for _, s, _ in steps]
        run["model_gloo_ms"] = [round(m * 1e3, 3) for _, _, m in steps]
        run["seq_calls"] = dict(seq.calls)
        run["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        out[what] = run
        seq.calls.clear()
        del params, cache, fn
        torch.cuda.empty_cache()
    return out


def phase_sharded_serve(smi: str) -> dict:
    """Phase 25: sharded serving on the card (``ServeEngine(group=)``,
    ``launch/mesh.spawn(grid=(1, 2))``; see the module docstring).  The
    one-process references run in this process while the ranks start and
    draw their weights; the ranks start their timed trace once they are
    done.  Returns each rank's launches and the figures."""
    import tempfile
    import torch
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.analysis import roofline
    from repro_torch.config import layer_kinds
    from repro_torch.dist import sharding
    from repro_torch.launch import mesh
    from repro_torch.models import lm

    t0 = time.perf_counter()
    cfg, rcfg = shard_config("full"), shard_config("reduced")
    gen = torch.Generator().manual_seed(7)
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=gen).tolist()
               for n, _ in SHARD_TRACE]
    rprompts = [[t % rcfg.vocab_size for t in p] for p in prompts]
    ltokens = long_tokens()
    with tempfile.TemporaryDirectory(prefix="shard_gate_") as tmp, \
            ThreadPoolExecutor(1) as lane:
        gate = str(Path(tmp) / "references_done")
        ranks = lane.submit(mesh.spawn, "chip_smoke:shard_rank", 2, prompts,
                            rprompts, gate, ltokens, device="cuda",
                            grid=SHARD_GRID, timeout_s=DP_JOIN_S)
        try:
            t1 = time.perf_counter()
            one = _one_process_serve(prompts, rprompts)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            t2 = time.perf_counter()
            long_one = _one_process_long(ltokens)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            refs_s = time.perf_counter() - t1
            long_refs_s = time.perf_counter() - t2
        finally:
            Path(gate).touch()      # a failure above still lets the ranks end
        ranks = ranks.result()
    failed = []
    T = SHARD_GRID[1]
    grid = sharding.Mesh(SHARD_GRID, ("data", "model"))
    shapes = lm.param_shapes(cfg)
    reckoned = sharding.sharded_state_bytes(
        shapes, sharding.serve_params_pspec(shapes, cfg, grid), grid)
    want = {"prefill": {k: list(v) for k, v in roofline.serve_tp_calls(
                cfg, T, 1, SHARD_BUCKET).items()},
            "decode": {k: list(v) for k, v in roofline.serve_tp_calls(
                cfg, T, shard_geometry().num_slots, 1).items()}}
    attn = sum(m in ("attn", "local") for m, _ in layer_kinds(cfg))
    n_prefill = 2 * len(prompts)
    for r, got in enumerate(ranks):
        tr = got["trace"]
        if not tr["done"] or any(len(o) != SERVE_MAX_NEW
                                 for o in tr["solo"] + tr["staggered"]):
            failed.append(f"rank {r}: not every request completed")
        if tr["staggered"] != tr["solo"]:
            failed.append(f"rank {r}: staggered outputs differ from solo")
        if r and (tr != ranks[0]["trace"]
                  or got["reduced"] != ranks[0]["reduced"]):
            failed.append(f"rank {r}: outputs differ from rank 0's")
        if r and not all(torch.equal(a, b) for a, b in
                         zip(got["logits"], ranks[0]["logits"])):
            failed.append(f"rank {r}: prefill logits differ from rank 0's")
        if got["reduced"]["solo"] != one["reduced"]["solo"] or \
                got["reduced"]["staggered"] != one["reduced"]["staggered"]:
            failed.append(f"rank {r}: reduced f32 tokens differ from one "
                          f"process's")
        # f32 at full width: the sharded sums against one process's, to
        # PIPE_TOL; bf16: within twice one process's own bf16-vs-f32
        # spread (tests/test_torch_bf16_parity.py's rule), since a bf16
        # join rounds each partial sum where one product rounds once
        rel32 = [_rel(a, b) for a, b in zip(got["logits_f32"],
                                             one["logits_f32"])]
        rel = [_rel(a, b) for a, b in zip(got["logits"], one["logits"])]
        spread = [_rel(a, b) for a, b in zip(one["logits"],
                                             one["logits_f32_full"])]
        if not max(rel32) <= PIPE_TOL:
            failed.append(f"rank {r}: f32 prefill logits' relative L2 "
                          f"distance at {SHARD_F32_LAYERS} layers "
                          f"distance to one process {max(rel32):.3e} > "
                          f"{PIPE_TOL:g}")
        if not all(x <= 2 * sp for x, sp in zip(rel, spread)):
            failed.append(f"rank {r}: bf16 prefill logits' relative L2 "
                          f"distance to one process {rel} over twice its "
                          f"bf16-vs-f32 spread {spread}")
        for i, (a, b) in enumerate(zip(got["logits"], one["logits"])):
            top = torch.topk(b, 2).values
            if float(top[0] - top[1]) > PIPE_TOL and \
                    tr["solo"][i][0] != int(b.argmax()):
                failed.append(f"rank {r} prompt {i}: first token "
                              f"{tr['solo'][i][0]} != one process's "
                              f"{int(b.argmax())} (margin "
                              f"{float(top[0] - top[1]):.4f})")
        for key, c, *_ in got["calls"]:
            w = want["decode" if key == "decode" else "prefill"]
            if c != w:
                failed.append(f"rank {r} {key}: model-group calls {c} != "
                              f"{w}")
        if got["flash_fwd"] != n_prefill * attn or \
                got["heads"] != [(cfg.num_heads // T, cfg.num_kv_heads // T)]:
            failed.append(f"rank {r}: flash forward {got['flash_fwd']} "
                          f"launches at heads {got['heads']}, not "
                          f"{n_prefill * attn} at "
                          f"{(cfg.num_heads // T, cfg.num_kv_heads // T)}")
        if got["held"]["pool"] * T != one["pool"]:
            failed.append(f"rank {r}: pool {got['held']['pool']} B is not "
                          f"1/{T} of one process's {one['pool']}")
        if got["held"]["params"] != reckoned:
            failed.append(f"rank {r}: params {got['held']['params']} B != "
                          f"the reckoning's {reckoned}")
        fig = _shard_figures(got["calls"])
        log(f"[sharded-serve] {SHARD_ARCH}/{cfg.num_layers} bf16 grid="
            f"{SHARD_GRID} rank={r} params_held={got['params']} "
            f"param_bytes={got['held']['params']} (reckoned {reckoned}) "
            f"pool_bytes={got['held']['pool']} (one process {one['pool']}) "
            f"init_s={got['init_s']:.2f} init_peak_gb="
            f"{got['init_peak_gb']:.3f} peak_gb={got['peak_gb']:.3f} "
            f"local_heads={got['local_heads']} card={smi}")
        log(f"[sharded-serve] rank={r} prefill_ms (bucket {SHARD_BUCKET}, "
            f"CUDA events) {fig['prefill_ms']} prefill_model_group_host_ms "
            f"{fig['prefill_model_host_ms']} decode_step_ms by slots live "
            f"(median, min, max over the trace's steps) "
            f"{fig['decode_ms_by_live']} model_group_host_ms_a_decode_step "
            f"{fig['decode_model_host_ms_by_live']} trace_s="
            f"{got['trace_s']:.2f} waited_for_references_s="
            f"{got['gate_s']:.2f} f32_s={got['f32_s']:.2f} reduced_s="
            f"{got['reduced_s']:.2f} card={smi}")
        log(f"[sharded-serve] rank={r} prefill_logits_rel_l2_vs_one_process "
            f"f32 at {SHARD_F32_LAYERS} layers="
            f"{[f'{x:.3e}' for x in rel32]} (tol {PIPE_TOL:g}) "
            f"bf16={[f'{x:.3e}' for x in rel]} (tol twice the one "
            f"process's bf16-vs-f32 {[f'{x:.3e}' for x in spread]}) "
            f"first_tokens={[o[0] for o in tr['solo']]} one_process="
            f"{[int(b.argmax()) for b in one['logits']]} "
            f"model_calls_prefill={want['prefill']} "
            f"model_calls_decode={want['decode']} flash_fwd="
            f"{got['flash_fwd']} at heads {got['heads']} reduced_f32_equal="
            f"{got['reduced'] == one['reduced']} card={smi}")
    failed += _long_checks(ranks, long_one, smi)
    secs = time.perf_counter() - t0
    log(f"[sharded-serve] phase {secs:.1f}s (one-process references "
        f"{refs_s:.1f}s, of them the long-context ones {long_refs_s:.1f}s, "
        f"while the ranks started; the ranks' long-context decode "
        f"{[round(g['long_s'], 1) for g in ranks]}s)")
    if failed:
        raise AssertionError("sharded-serve: " + "; ".join(failed))
    return {"launches": {f"rank{r}": {"flash_fwd": got["flash_fwd"]}
                         for r, got in enumerate(ranks)},
            "figures": {f"rank{r}": {
                **_shard_figures(got["calls"]),
                "param_bytes": got["held"]["params"],
                "pool_bytes": got["held"]["pool"],
                "params_held": got["params"],
                "peak_gb": round(got["peak_gb"], 3),
                "logits_rel_l2_bf16": [_rel(a, b) for a, b in zip(
                    got["logits"], one["logits"])],
                "logits_rel_l2_f32": [_rel(a, b) for a, b in zip(
                    got["logits_f32"], one["logits_f32"])],
                "long_decode_step_ms": got["long"]["bf16"]["step_ms"],
                "long_seq_gloo_ms": got["long"]["bf16"]["seq_gloo_ms"],
                "long_model_gloo_ms": got["long"]["bf16"]["model_gloo_ms"],
                "long_param_bytes": got["long"]["bf16"]["param_bytes"],
                "long_cache_kv_bytes": got["long"]["bf16"]["cache_kv_bytes"]}
                for r, got in enumerate(ranks)} | {"phase_s": secs}}


def _long_checks(ranks, one, smi) -> list:
    """Phase 25's long-context checks and lines: the ranks' logits
    bit-identical at every step, the f32 cut's within ``PIPE_TOL``
    (relative L2) of one process's, the bf16 ones within twice one
    process's own bf16-vs-f32 spread, one combine gather a layer a step,
    and the bytes held the reckoning's.  Returns what failed."""
    import torch
    from repro_torch.config import SHAPES, total_layers
    failed = []
    layers = total_layers(long_config("bf16"))
    pos = SHAPES[LONG_SHAPE].seq_len - LONG_STEPS
    spread = [_rel(a, b) for a, b in zip(one["bf16"], one["f32_full"])]
    for r, got in enumerate(ranks):
        run, cut = got["long"]["bf16"], got["long"]["f32"]
        same = all(torch.equal(a, b) for what in ("bf16", "f32")
                   for a, b in zip(got["long"][what]["logits"],
                                   ranks[0]["long"][what]["logits"]))
        if not same:
            failed.append(f"rank {r}: long-context logits differ from "
                          f"rank 0's")
        rel32 = [_rel(a, b) for a, b in zip(cut["logits"], one["f32"])]
        rel = [_rel(a, b) for a, b in zip(run["logits"], one["bf16"])]
        if not max(rel32) <= PIPE_TOL:
            failed.append(f"rank {r}: long-context f32 logits' relative L2 "
                          f"distance at {LONG_F32_LAYERS} layers to one "
                          f"process {max(rel32):.3e} > {PIPE_TOL:g}")
        if not all(x <= 2 * sp for x, sp in zip(rel, spread)):
            failed.append(f"rank {r}: long-context bf16 logits' relative "
                          f"L2 distance {rel} over twice one process's "
                          f"bf16-vs-f32 spread {spread}")
        if run["seq_calls"] != {"all-gather": LONG_STEPS * layers}:
            failed.append(f"rank {r}: combine gathers {run['seq_calls']}, "
                          f"not {LONG_STEPS * layers}")
        if run["param_bytes"] != run["reckoned_params"] or \
                run["cache_kv_bytes"] != LONG_CACHE_KV_BYTES or \
                run["reckoned_cache"] != LONG_CACHE_KV_BYTES + 8:
            failed.append(f"rank {r}: long-context bytes held params "
                          f"{run['param_bytes']} (reckoned "
                          f"{run['reckoned_params']}) cache k/v "
                          f"{run['cache_kv_bytes']} (reckoned "
                          f"{LONG_CACHE_KV_BYTES}, with the position "
                          f"{run['reckoned_cache']})")
        log(f"[sharded-serve-long] {LONG_ARCH}/{layers} bf16 {LONG_SHAPE} "
            f"grid={SHARD_GRID} rank={r} share={run['share']}/"
            f"{run['shares']} override={{'batch': None, 'kv_seq': "
            f"('data', 'model')}} param_bytes={run['param_bytes']} "
            f"(reckoned {run['reckoned_params']}) cache_kv_bytes="
            f"{run['cache_kv_bytes']} (reckoned {LONG_CACHE_KV_BYTES}) "
            f"setup_s={run['setup_s']:.2f} peak_gb={run['peak_gb']:.3f} "
            f"card={smi}")
        log(f"[sharded-serve-long] rank={r} decode_step_ms (CUDA events, "
            f"{LONG_STEPS} steps from position {pos}) {run['step_ms']} "
            f"seq_group_gloo_ms_a_step {run['seq_gloo_ms']} "
            f"model_group_gloo_ms_a_step {run['model_gloo_ms']} "
            f"f32_cut_step_ms {cut['step_ms']} card={smi}")
        log(f"[sharded-serve-long] rank={r} logits_rel_l2_vs_one_process "
            f"f32 at {LONG_F32_LAYERS} layers="
            f"{[f'{x:.3e}' for x in rel32]} (tol {PIPE_TOL:g}) "
            f"bf16={[f'{x:.3e}' for x in rel]} (tol twice the one "
            f"process's bf16-vs-f32 {[f'{x:.3e}' for x in spread]}) "
            f"bit_identical_to_rank0={same} card={smi}")
    return failed


# phase 25's dry runs on the production meshes: (arch, shape, multi-pod,
# whether the reference's rule table lays it out)
POD_CELLS = (("gemma3-4b", "long_500k", False, True),
             ("gemma3-4b", "long_500k", True, True),
             ("yi-6b", "decode_32k", False, False))


def phase_pod_dryrun() -> dict:
    """With phase 15 (host only): one rank of each production mesh counted
    on the meta device (``launch/dryrun.py --pod``/``--multi-pod``):
    gemma3-4b ``long_500k`` on the 16 x 16 pod and the (2, 16, 16) mesh
    under the small-batch override (256 sequence shards), and yi-6b
    ``decode_32k`` on the pod, an error record (4 KV heads over 16 model
    ranks, the reference's refusal).  Fails where a record's outcome is
    not that, where gemma3's bytes are not the reckoning's or its
    collective bytes not ``roofline.serve_tp_calls``'s, or when a kernel
    was launched."""
    import tempfile
    from repro_torch.analysis import roofline
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun

    before = launches_now()
    tmp = tempfile.TemporaryDirectory(prefix="dryrun_pod_")
    failed, out = [], {}
    for arch, shape, multi, ok in POD_CELLS:
        rec = dryrun.run_cell(arch, shape, pod=not multi, multi_pod=multi,
                              force=True, out_dir=tmp.name)
        name = f"{arch}/{shape}/{dryrun.mesh_name(multi)}"
        if rec["ok"] != ok:
            failed.append(f"{name}: ok={rec['ok']} "
                          f"{rec.get('error', '')[:200]}")
            continue
        if not ok:
            log(f"[pod-dryrun] {name} error record (as the reference "
                f"refuses it): {rec['error'][:160]}")
            out[name] = {"ok": False}
            continue
        calls = roofline.serve_tp_calls(
            get_config(arch), 16, 1, 1, seq_shards=rec["seq_shards"],
            whole=frozenset({"attn"}))
        want = roofline.serve_wire_bytes(calls, 16, rec["seq_shards"])
        if rec["collective_breakdown"] != want or \
                rec["param_bytes"] != 2746311680 or \
                rec["cache_bytes"] != 42418176 + 8:
            failed.append(f"{name}: collectives "
                          f"{rec['collective_breakdown']} (reckoned {want}) "
                          f"param_bytes {rec['param_bytes']} cache_bytes "
                          f"{rec['cache_bytes']}")
        out[name] = {k: rec[k] for k in (
            "chips", "seq_shards", "param_bytes", "cache_bytes",
            "flops_per_device", "bytes_per_device",
            "collective_bytes_per_device", "num_collectives", "count_s")}
        log(f"[pod-dryrun] {name} chips={rec['chips']} rank of "
            f"{rec['data_parallel']} x {rec['model_parallel']}, override "
            f"{rec['rules_overrides']}: seq_shards={rec['seq_shards']} "
            f"param_bytes={rec['param_bytes']} cache_bytes="
            f"{rec['cache_bytes']} GFLOP={rec['flops_per_device'] / 1e9:.3f}"
            f" GB={rec['bytes_per_device'] / 1e9:.3f} collective_GB="
            f"{rec['collective_bytes_per_device'] / 1e9:.4f} "
            f"({rec['num_collectives']} calls) count_s={rec['count_s']}")
    if any(launches_since(before).values()):
        failed.append(f"a kernel launched: {launches_since(before)}")
    tmp.cleanup()
    if failed:
        raise AssertionError("pod-dryrun: " + "; ".join(failed))
    return out


def _dryruns(phase5: dict, peaks: dict, bounds: dict, remat: dict):
    """:func:`phase_dryrun`, :func:`phase_remat_dryrun` and
    :func:`phase_pod_dryrun`, in a process of their own (started by
    ``main``); their lines go to the same output."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    t0 = time.perf_counter()
    dry = phase_dryrun(phase5, peaks, bounds)
    t1 = time.perf_counter()
    remat_dry = phase_remat_dryrun(remat)
    t2 = time.perf_counter()
    pod = phase_pod_dryrun()
    return dry, remat_dry, pod, {
        "dryrun": round(t1 - t0, 1), "remat_dryrun": round(t2 - t1, 1),
        "pod_dryrun": round(time.perf_counter() - t2, 1)}


def main() -> int:
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False   # f32 products in f32
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    log(f"[device] {smi}")
    log(f"[device] torch.cuda.get_device_name={torch.cuda.get_device_name(0)} "
        f"count={torch.cuda.device_count()} torch={torch.__version__} "
        f"cuda={torch.version.cuda}")
    t0 = time.perf_counter()
    secs = _build.build()
    log(f"[build] {len(_build.SOURCES)} kernels built in {secs:.1f}s "
        f"(phase {time.perf_counter() - t0:.1f}s)")
    tensor_cores = clocked("tensor_cores", phase_tensor_cores)

    timed = clocked("kernels", phase_kernels)
    records = dict(timed["main"])
    records.update(clocked("ssd_kernels", phase_ssd_kernels))
    records.update(clocked("rglru_kernels", phase_rglru_kernels))
    torch.cuda.empty_cache()
    from repro_torch.configs import ARCHS as REGISTERED
    decode_by_arch = {arch: clocked(f"decode/{arch}", phase_decode, arch)
                      for arch in REGISTERED}
    torch.cuda.empty_cache()
    # the serving path's own launches: counted from each arch's runs
    serve_by_arch = {arch: clocked(f"serve/{arch}", phase_serve, arch)
                     for arch in SERVE_ARCHS}
    if not all(g.get("flash_fwd") for g in serve_by_arch.values()):
        raise AssertionError(f"a serve path never launched the flash "
                             f"forward: {serve_by_arch}")
    for arch in CARD_VS_CPU_ARCHS:
        clocked(f"card_vs_cpu/{arch}", phase_card_vs_cpu, arch)
        torch.cuda.empty_cache()
    # each path's own launches: its kernels' counts from its own run
    by_arch, temporal_ms, phase5, peaks = {}, {}, {}, {}
    for arch in FULL_WIDTH_ARCHS:
        grew, temporal_ms[arch], depths, peaks[arch] = clocked(
            f"full_width/{arch}", phase_full_width, arch)
        phase5[arch] = (temporal_ms[arch], depths)
        by_arch[arch] = {n: c for n, c in grew.items() if c}
        torch.cuda.empty_cache()
    launches = {n: sum(g.get(n, 0) for g in by_arch.values())
                for n in KERNELS}
    idle = [n for n in KERNELS if not launches[n]]
    if idle:
        raise AssertionError(f"kernels the main paths never launched: {idle}")
    mb_by_arch = {}
    for arch in ARCHS:
        grew = clocked(f"temporal_mb/{arch}", phase_temporal_mb, arch,
                       temporal_ms[arch])
        mb_by_arch[arch] = {n: c for n, c in grew.items() if c}
        torch.cuda.empty_cache()
    idle = [n for n in KERNELS
            if not any(g.get(n) for g in mb_by_arch.values())]
    if idle:
        raise AssertionError(f"kernels the temporal-mb paths never "
                             f"launched: {idle}")
    for arch in ARCHS:
        clocked(f"card_vs_cpu_compressed/{arch}",
                phase_card_vs_cpu_compressed, arch)
    clocked("restart", phase_restart)
    torch.cuda.empty_cache()
    jigsaw_by_arch = clocked("jigsaw", phase_jigsaw, phase5)
    torch.cuda.empty_cache()
    idle = [n for n in KERNELS if not n.startswith("rglru")
            and not any(g.get(n) for g in jigsaw_by_arch.values())]
    if idle:
        raise AssertionError(f"kernels the JigSaw session never launched: "
                             f"{idle}")
    clocked("cluster_faults", phase_cluster_faults)
    torch.cuda.empty_cache()
    # the fused paths' own launches: zeroed before each arch's fused run
    fused_by_arch = {arch: clocked(f"fused/{arch}", phase_fused, arch)
                     for arch in ARCHS}
    idle = [n for n in KERNELS
            if not any(g["launches"].get(n) for g in fused_by_arch.values())]
    if idle:
        raise AssertionError(f"kernels the fused paths never launched: "
                             f"{idle}")
    fused_jigsaw = clocked("fused_jigsaw", phase_fused_jigsaw)
    torch.cuda.empty_cache()
    # phases 18 (a) and 19 (a), reduced ranks in processes of their own
    # whose parent side touches no card (so no capture or sync check of
    # this process sees them), run beside the graphs and recompute phases
    early = ThreadPoolExecutor(1)
    reduced_groups = early.submit(lambda: (
        clocked("data_parallel_reduced", phase_data_parallel_reduced),
        clocked("zero_reduced", phase_zero1_reduced)))
    graphs_by_path = clocked("graphs", phase_graphs)
    idle = [n for n in ("flash_fwd", "flash_delta", "flash_dq", "flash_dkv")
            if not graphs_by_path["train_yi-6b"].get(n)]
    if idle or not graphs_by_path["serve_yi-6b"].get("flash_fwd"):
        raise AssertionError(f"graph replays never launched {idle}: "
                             f"{graphs_by_path}")
    torch.cuda.empty_cache()
    remat_by_arch = clocked("remat", phase_remat)
    idle = [n for n in KERNELS if not any(
        f["launches"].get(n) for runs in remat_by_arch.values()
        for f in runs.values())]
    if idle:
        raise AssertionError(f"kernels the recompute runs never launched: "
                             f"{idle}")
    torch.cuda.empty_cache()
    # the dry runs are host only and launch nothing: a process of their own
    # runs them beside the rank phases, so no timed phase of this process
    # carries their modules (~100k more Python objects) or their garbage
    # collections, and their minute is off the script's time
    dry_pool = ProcessPoolExecutor(1, mp_context=multiprocessing.get_context(
        "spawn"))
    dryruns = dry_pool.submit(_dryruns, phase5, peaks,
                              {n: records[n]["work"] for n in KERNELS},
                              remat_by_arch)
    dp_launches, zero1_by_run = clocked("reduced_groups_waited",
                                        reduced_groups.result)
    early.shutdown()
    # the ranks run in processes of their own: the parent holds nothing.
    # The restart and the reduced grids of phases 22 and 23 (a few GB of
    # the card together; their parent side launches kernels, but no phase
    # beside them reads this process's counts) run in a second lane beside
    # the two full-width phases: each check reads only its own ranks
    with ThreadPoolExecutor(1) as lane:
        small = lane.submit(lambda: (
            clocked("zero_restart", phase_zero1_restart),
            clocked("expert_parallel_reduced", ep_reduced_runs),
            clocked("compressed_reduced", compressed_reduced_runs)))
        dp_full = clocked("data_parallel_full", phase_data_parallel_full)
        zero1_full = clocked("zero_full", phase_zero1_full)
        _, ep_reduced, cz_reduced = small.result()
    dp_launches.update(dp_full["launches"])
    idle = [n for n in ("flash_fwd", "flash_delta", "flash_dq", "flash_dkv")
            if not any(g.get(n) for g in dp_launches.values())]
    if idle:
        raise AssertionError(f"kernels the data-parallel ranks never "
                             f"launched: {idle}")
    zero1_by_run.update(zero1_full["launches"])
    idle = [n for n in ("flash_fwd", "flash_delta", "flash_dq", "flash_dkv")
            if not any(g.get(n) for g in zero1_by_run.values())]
    if idle:
        raise AssertionError(f"kernels the ZeRO-1 ranks never launched: "
                             f"{idle}")
    pipeline = clocked("pipeline", phase_pipeline, smi)
    idle = [n for n in ("flash_fwd", "flash_delta", "flash_dq", "flash_dkv",
                        "ssd_fwd", "ssd_fwd_res", "ssd_bwd")
            if not any(g.get(n) for g in pipeline["launches"].values())]
    if idle:
        raise AssertionError(f"kernels the pipeline ranks never launched: "
                             f"{idle}")
    tensor_parallel = clocked("tensor_parallel", phase_tensor_parallel,
                              smi)
    idle = [n for n in ("flash_fwd", "flash_delta", "flash_dq", "flash_dkv")
            if not any(g.get(n) for g in
                       tensor_parallel["launches"].values())]
    if idle:
        raise AssertionError(f"kernels the tensor-parallel ranks never "
                             f"launched: {idle}")
    expert_parallel = clocked("expert_parallel", phase_expert_parallel,
                              smi, ep_reduced)
    idle = [n for n in ("flash_fwd", "flash_delta", "flash_dq", "flash_dkv")
            if not any(g.get(n) for g in
                       expert_parallel["launches"].values())]
    if idle:
        raise AssertionError(f"kernels the expert-parallel ranks never "
                             f"launched: {idle}")
    fused_dots = clocked("fused_dots", phase_fused_dots, smi)
    idle = [n for n in ("flash_fwd", "flash_delta", "flash_dq", "flash_dkv")
            if not fused_dots["launches"].get(n)]
    if idle:
        raise AssertionError(f"kernels the fused 'dots' step never "
                             f"launched: {idle}")
    torch.cuda.empty_cache()
    compressed = clocked("compressed", phase_compressed_grids, smi,
                         cz_reduced)
    idle = [n for n in ("flash_fwd", "flash_delta", "flash_dq", "flash_dkv")
            if not any(g.get(n) for g in compressed["launches"].values())]
    if idle:
        raise AssertionError(f"kernels the compressed ranks never "
                             f"launched: {idle}")
    torch.cuda.empty_cache()
    spatial = clocked("spatial", phase_spatial, smi)
    idle = [n for n in KERNELS if not n.startswith("rglru")
            and not spatial["launches"]["session"].get(n)]
    if idle:
        raise AssertionError(f"kernels the spatial session never "
                             f"launched: {idle}")
    torch.cuda.empty_cache()
    sharded = clocked("sharded_serve", phase_sharded_serve, smi)
    if not all(g.get("flash_fwd") for g in sharded["launches"].values()):
        raise AssertionError(f"a sharded serving rank never launched the "
                             f"flash forward: {sharded['launches']}")
    dryrun_by_arch, remat_dryrun, pod_dryrun, dry_s = clocked(
        "dryruns_waited", dryruns.result)
    dry_pool.shutdown()
    PHASE_S.update(dry_s)

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        r = records[name]
        entry = {"name": name, "route": "cuda", "source": source,
                 "replaces": replaces, "launches": launches[name],
                 "launches_by_arch": {a: g[name] for a, g in by_arch.items()
                                      if name in g},
                 "launches_temporal_mb": {a: g[name]
                                          for a, g in mb_by_arch.items()
                                          if name in g},
                 "launches_jigsaw": {a: g[name]
                                     for a, g in jigsaw_by_arch.items()
                                     if name in g},
                 "launches_decode": {a: g[name]
                                     for a, g in decode_by_arch.items()
                                     if g.get(name)},
                 "launches_serve": {a: g.get(name, 0)
                                    for a, g in serve_by_arch.items()},
                 "launches_fused": {a: g["launches"][name]
                                    for a, g in fused_by_arch.items()
                                    if name in g["launches"]},
                 "launches_fused_jigsaw": {a: g[name]
                                           for a, g in fused_jigsaw.items()
                                           if name in g},
                 "launches_graphs": {p: g[name]
                                     for p, g in graphs_by_path.items()
                                     if name in g},
                 "launches_remat": {f"{a}/{label}": f["launches"][name]
                                    for a, runs in remat_by_arch.items()
                                    for label, f in runs.items()
                                    if name in f["launches"]},
                 "launches_data_parallel": {k: g[name]
                                            for k, g in dp_launches.items()
                                            if g.get(name)},
                 "launches_zero": {k: g[name]
                                   for k, g in zero1_by_run.items()
                                   if g.get(name)},
                 "launches_pipeline": {k: g[name]
                                       for k, g in pipeline["launches"].items()
                                       if g.get(name)},
                 "launches_tensor_parallel": {
                     k: g[name] for k, g in
                     tensor_parallel["launches"].items() if g.get(name)},
                 "launches_expert_parallel": {
                     k: g[name] for k, g in
                     expert_parallel["launches"].items() if g.get(name)},
                 "launches_fused_dots": fused_dots["launches"].get(name, 0),
                 "launches_compressed": {
                     k: g[name] for k, g in compressed["launches"].items()
                     if g.get(name)},
                 "launches_spatial": {
                     k: g[name] for k, g in spatial["launches"].items()
                     if g.get(name)},
                 "launches_sharded_serve": {
                     k: g[name] for k, g in sharded["launches"].items()
                     if g.get(name)},
                 "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                 "device_ms": r["device_ms"], "plain_ms": r["plain_ms"],
                 "bound_ms": r["bound_ms"],
                 "bound_by": r["bound_by"], "library_ms": r["library_ms"]}
        for case, arch in TIMED.items():   # the flash kernels at each shape
            if case != "main" and name in timed[case]:
                entry["at_" + re.sub(r"\W", "_", arch)] = timed[case][name]
        kernels.append(entry)
    log(json.dumps({"kernels": kernels,
                    "dryrun_by_arch": {
                        a: {str(d): r for d, r in rows.items()}
                        for a, rows in dryrun_by_arch.items()},
                    "sdpa_fwd_bwd_ms": {TIMED[c]: t["_sdpa_fwd_bwd_ms"]
                                        for c, t in timed.items()},
                    "dkv_ms_by_head_split": {
                        TIMED[c]: t["_dkv_ms_by_split"]
                        for c, t in timed.items()},
                    "ssd_phase_ms": {
                        n: records[f"_{n}_phase_ms"]
                        for n in ("ssd_fwd", "ssd_fwd_res", "ssd_bwd")},
                    "rglru_device_ms": {
                        n: records[f"_{n}_device_ms"]
                        for n in ("rglru_fwd", "rglru_bwd")},
                    "rglru_many_tiles_ms": {
                        n: records[f"_{n}_many_tiles_ms"]
                        for n in ("rglru_fwd", "rglru_bwd")},
                    "tensor_core_sass": tensor_cores,
                    "fused_ms_vs_sum_solo_ms_by_depth": {
                        a: {str(d): t for d, t in g["ms_by_depth"].items()}
                        for a, g in fused_by_arch.items()},
                    "fused_peak_gb": {a: g["peak_gb"]
                                      for a, g in fused_by_arch.items()},
                    "fused_first_step_ms": {
                        a: g["first_step_ms"]
                        for a, g in fused_by_arch.items()},
                    "fused_max_rel_dev_by_cycle": {
                        a: g["max_rel_dev"]
                        for a, g in fused_by_arch.items()},
                    "remat": {a: {label: {k: v for k, v in f.items()
                                          if k != "launches"}
                                  for label, f in runs.items()}
                              for a, runs in remat_by_arch.items()},
                    "remat_dryrun": remat_dryrun,
                    "pod_dryrun": pod_dryrun,
                    "data_parallel": dp_full["figures"],
                    "zero": zero1_full["figures"],
                    "pipeline": pipeline["figures"],
                    "tensor_parallel": tensor_parallel["figures"],
                    "expert_parallel": expert_parallel["figures"],
                    "fused_dots": {
                        p: {k: v for k, v in f.items() if k != "launches"}
                        for p, f in fused_dots["figures"].items()},
                    "compressed": compressed["figures"],
                    "spatial": spatial["figures"],
                    "sharded_serve": sharded["figures"],
                    "phase_s": PHASE_S}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
