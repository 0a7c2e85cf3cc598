"""Chip smoke test of the PyTorch + CUDA port (`src/repro_torch`) on one GPU.

    python3 chip_smoke.py                    # every phase, as run on the card
    python3 chip_smoke.py --phases env,kernels
    python3 chip_smoke.py --phases env,train_kernels,train_check,train
    python3 chip_smoke.py --phases env,decode_kernels,engine_check,engine
    python3 chip_smoke.py --phases env,kernels,decode_kernels,engine,train_kernels
    python3 chip_smoke.py --phases env,moe_kernels,moe_check,moe_engine,moe_train
    python3 chip_smoke.py --phases env,level_kernels,level_check,level_serve,ladder
    python3 chip_smoke.py --phases env,level_kernels,level_train,level_moe
    python3 chip_smoke.py --phases env,campaign_kernels,campaign_train,campaign_train_chunked,moe_campaign
    python3 chip_smoke.py --phases env,chain_kernels,whisper_check,whisper_serve
    python3 chip_smoke.py --phases env,act_chains
    python3 chip_smoke.py --phases env,ssm_check,ssm_serve

Phases (each prints its own lines; any failed check exits non-zero):

  env          card name and power limit (nvidia-smi), torch / CUDA
               versions, the nvcc build of every kernel source with its
               -Xptxas -v register / shared-memory / spill lines;
  kernels      each CUDA kernel against its plain PyTorch version on the card
               at the serving path's shapes in bf16 (qwen2-7b, 4 requests of
               128 tokens): max error, report agreement, a deterministic SEU
               on integer-valued operands (corrected, located), and CUDA-event
               times of the kernel, its plain version and one PyTorch library
               call computing the same product without ABFT; K1 runs on the
               tensor-core instance (csrc/ft_gemm_sm90.cu) under the plan of
               `ft_gemm.plan`, timed beside FT off and the SIMT instance at
               its own tiles, with SEUs at k-step 0, mid-way in a later
               split-K range and at the last step, each with a detect-only
               control counted by the split-K rule; K5 at decode
               attention's QKᵀ and PV on views of the cache on its tensor-
               core instance (csrc/batched_sm90.cu, `ft_gemm.plan_k5`) at
               FT off, block, tile and inner against its plain version,
               the SIMT instance pinned by its tiles at block, tile and
               inner against its own, SEUs on both at each level (the new
               one at k-step 0 of its 256-deep walk, the SIMT one at k-step
               3 of its 32-deep one) with detect-only controls, and the kernels' device times (torch.profiler)
               beside whole calls, FT off, the SIMT instance, the plain
               versions, torch.matmul and the bound; K2 at the prefill shape
               (112 / 16 heads, S 128) on its tensor-core instance
               (csrc/flash_fwd_sm90.cu) against its plain version, with an
               SEU in S and one in Δ, beside the SIMT instance (pinned
               blocks), SDPA and the bound;
  serve_check  qwen2-7b at full width, depth cut to 2 layers: prefill and 2
               decode steps (the same tokens fed to both) through the kernels
               and through their plain versions; logits agree within 2e-2 of
               max|logit|, no detection; then each path fed its own greedy
               tokens, printed with the top-2 margins (not checked);
  serve        `repro_torch.train.serve.generate` on qwen2-7b at full width
               and depth (random bf16 weights from a seed): 4 requests x 128
               prompt tokens, 32 greedy tokens, once under a dispatch guard
               (every kernel's launch count from that run, no library matmul
               / attention call on the FT path), once timed without it; then
               one decode step and one prefill under torch.profiler (the
               device's busy time and idle share, kernels by time) and the
               host time of one K1 call; the decode profile again with
               K5's SIMT instance pinned (`simt_batched`), the prefill
               profile again with K2's SIMT instance pinned
               (`simt_flash_fwd`);
  level_kernels  K1 and K5 at the tile (warp) and inner (thread) FT levels
               against their plain versions on the card in bf16 at
               qwen2-7b's prefill and decode w_gate+silu, decode wk+bias,
               decode lm_head, decode QKᵀ and PV shapes (K1 on its
               tensor-core level instance, K5 on its tensor-core one): max
               error, reports equal, no detection on clean data, an SEU on
               integer-valued operands corrected bit for bit and located
               and left in place by a detect-only policy (at inner counted
               once); at the decode w_gate+silu (split-K) an SEU in every
               16-row band of a block, and at tile a campaign at rate 1.0
               with an SEU in another band; K1's CUDA-event times beside FT
               off and block on the tensor cores (the like-for-like
               ablation) and the SIMT instance pinned at the level (held
               against its plain version at the decode shapes); the bf16
               level ablation on a 4 096 square (off, block, tile, inner,
               torch.matmul);
               K5's device times (torch.profiler) beside FT off, block and
               torch.matmul on the same clock and instance, its whole
               calls' CUDA-event times (the SIMT instance's too) under
               their own keys; the bound, the plain version and the
               library call. Then the tile and inner levels of training and
               MoE on the instances the plans pick in bf16 (K1, K7 and K8 on
               the tensor cores), each timed beside the SIMT instance pinned
               at the level (K8's also held against its plain version): K1's
               w_gate+silu with act_grad and its dw on the transposed-A
               walk at phi4-mini-3.8b's training shape (2 x 512 tokens), K7
               at qwen3-moe-235b-a22b's decode gate and its training dbuf
               product (the wᵀ view), K8 at its training dw gate (8 192
               rows -> (128, 4 096, 1 536) f32): max error and reports
               against the plain version under the same plan, no detection
               on clean data, an SEU on integer-valued operands corrected
               bit for bit, located and left by detect-only, an SEU in each
               16-row band of one block (K8: and one in the last group's
               dead tail), at tile a campaign at rate 1.0 plus an SEU in
               another band of one block in the same interval (two SEUs in
               two bands, both corrected); CUDA-event times beside the same
               instance at block (pinned SIMT tiles), the tensor-core block
               call, FT off, the library call and the bound;
  level_check  qwen2-7b at full width, 2 layers: prefill and 2 decode steps
               at each level through the kernels against their plain
               versions and against block (logits within 2e-2 of
               max|logit|, no detection);
  level_serve  `generate` on qwen2-7b at full width and depth, 4 requests x
               128 prompt tokens, 16 greedy tokens, at block, tile and
               inner (block at the same token count as the other two, so
               tokens/s compares like for like), as `serve` runs it (launch counts, dispatch guard,
               prefill and decode times, tokens/s, peak memory, zero
               detections);
  ladder       the paper's step-wise GEMM ladder and FT-level ablation on
               f32 squares of 1 024, 4 096 and 8 192 (TF32 off):
               torch.matmul (cuBLAS), K9 naive_gemm, K1 FT off at each
               compiled tile, K1 at block / tile x verify step / final and
               at inner (which verifies every k-step's Δ whatever
               ``verify`` says), block detect-only, the torch-op non-fused baseline;
               CUDA-event time, TFLOP/s, the f32 bound and each rung's
               overhead over K1 FT off and over torch.matmul; K9 and K1
               against their plain versions at 1 024 and 4 096; one SEU per
               launch at k-step 0, mid and last at 4 096, corrected at each
               level, timed against the clean run;
  decode_kernels  the paged decode K6 on its tensor-core instance
               (csrc/flash_decode_sm90.cu: `plan_decode`'s ranges, then the
               combine) against its plain version under the same plan on
               the card at qwen2-7b's decode shape in bf16 (28 / 4 heads, dh
               128, pages of 64, 8 slots of lengths 0 to 1 024 whose pages
               come out of order from a shuffled pool): max error, reports
               equal, no detection on clean data, the split report equal to
               the unsplit walk's in det / corr / row / col / k; the SIMT
               kernel (pinned) against the unsplit walk; an SEU in Δ and
               one in S corrected and located (and left in place by a
               detect-only policy), the reference's exact-operand SEU (dh
               256, f32, the SIMT kernel) corrected bit for bit; the
               combine alone against its plain version; CUDA-event times of
               the whole call, the kernel, the combine, the SIMT kernel,
               the plain versions and one SDPA call over the gathered dense
               cache, and the bounds;
  engine_check qwen2-7b at full width, depth cut to 2 layers: one
               `paged_decode_step` against one dense `decode_step` on the
               same tokens (slot lengths 37, 64, 0, 129; logits within 2e-2
               of max|logit|, caches equal), then `ServeEngine` serving 6
               requests on 3 slots against one single-slot engine per
               request (tokens equal, budgets met, pages returned, "dec_flash"
               in the telemetry scope with no detection, K6 launched twice
               per decode step);
  engine       `repro_torch.train.engine.ServeEngine` on qwen2-7b at full
               width and depth: 16 requests (prompts of 16-512 tokens and
               budgets of 8-32 greedy tokens drawn from --seed) on 8 slots,
               max_len 1 024, pages of 64, once under the dispatch guard
               (launch counts: K6 and its combine 28 per decode step on the
               tensor cores, K5 none), once timed
               without it: decode ms per step, prefill ms per request, TTFT,
               generated tokens/s, peak memory, pool bytes, free pages;
               then one decode step with every slot live under
               torch.profiler (busy time, idle share) on K6's tensor-core
               instance and again with its SIMT kernel pinned
               (`simt_decode`);
  train_kernels  the training kernels against their plain versions on the
               card at phi4-mini-3.8b's training shapes in bf16 (2 x 512
               tokens): K1 with the act_grad output and the dx = g·Wᵀ /
               dw = Xᵀ·g GEMMs on transposed views; max error, report
               agreement, a deterministic SEU each, CUDA-event times beside
               the bound, the plain version and one library call. K2 with
               the saved statistics on its tensor-core instance at
               phi4-mini's and qwen3-moe-235b-a22b's attention shapes (as
               the prefill's, and m, l within 1e-3). Then K3 (dQ) and K4
               (dK/dV) at
               phi4-mini's (48 / 16 heads) and qwen3-moe-235b-a22b's (128 /
               8 heads) attention shapes (S 512, dh 128, causal): the plan
               (the tensor-core instance, csrc/flash_bwd_sm90.cu, and K4's
               range count), outputs within one bf16 ulp of the plain
               version under the same plan, reports det / corr / row / col
               / k equal and tau within 1e-3; on integer operands one SEU
               per backward GEMM (dP in each kernel, the dQ, dV and dK
               deltas, and a dV SEU in a K4 range before the last),
               corrected, located and left by a detect-only policy; the
               range reduce against its plain version; times of the new
               instance, the SIMT one (pinned blocks), the plain version,
               SDPA backward and the bound;
  train_check  phi4-mini-3.8b at full width, depth cut to 2 layers, 1 x 256
               tokens: `loss_fn` and its backward through the kernels and
               through their plain versions (loss within 1e-3, every grad
               leaf within 2e-2 relative, no detection); a `bwd_inject` SEU
               in a w_down dw GEMM and one in the flash dK, corrected to the
               clean grads (and left in them by a detect-only policy);
  train        `repro_torch.train.train_loop.train` on phi4-mini-3.8b at
               full width and depth (random bf16 weights from a seed),
               2 x 512 tokens, 4 steps (step 0 has lr 0): step times,
               tokens/s, peak memory, losses, FT counters, launches per
               step (every K3 / K4 launch on the tensor-core instance);
               then one more step through `make_train_step` under the
               dispatch guard, whose launch counts are checked, and one
               under torch.profiler (busy time and idle share), again with
               K3 and K4 pinned to their SIMT instances, and with K2 pinned
               to its SIMT instance;
  moe_kernels  the grouped kernels K7 and K8 on their tensor-core instances
               (csrc/grouped_sm90.cu, the plan's default for bf16) against
               their plain versions under the same plan on the card at
               qwen3-moe-235b-a22b's shapes in bf16 (128 experts, d 4 096,
               expert d_ff 1 536): K7 at the engine's decode (8 slots x
               top-8 = 64 rows, 4 096->1 536 and 1 536->4 096), a 512-token
               prefill (4 096 rows) and the training dbuf product (8 192
               rows against the transposed w); K8 at the training dw (8 192
               rows); max error, report fields equal, no detection on clean
               data; SEUs in K7's ragged last group (a chunk running past
               row_end) at the first and the last k-step and in K8's last
               ragged tile, corrected bit for bit and located, and left by a
               detect-only policy; garbage in the buffer's dead rows changes
               nothing; empty groups come back zero from the kernel; the
               SIMT instances (csrc/ft_gemm.cu GROUPED, csrc/tgmm.cu) at
               their pinned tiles against their own plain versions; CUDA-
               event times of the new instance (verify step and final, FT
               off) beside the SIMT one, the bound, the plain version and one
               library call (torch._grouped_mm; for K8 with an f32 output
               where this torch takes it, else its bf16 output, labelled
               with the bytes it moves);
  moe_check    qwen3-moe-235b-a22b at full width, depth cut to 2 layers: a
               forward through the kernels and through their plain versions
               under the same plans (logits within 2e-2 of max|logit|, the
               routing mostly the same, no detection); `ServeEngine`
               serving 6 requests on 3 slots against one single-slot engine
               per request (every K7 launch on the tensor-core instance);
               `loss_fn` and its backward kernel vs plain, and a
               `bwd_inject` SEU in moe_gate's dw (K8, on the tensor-core
               instance) corrected to the clean grads (and left by a
               detect-only policy);
  moe_engine   `ServeEngine` on qwen3-moe-235b-a22b at full width, 12 of its
               94 layers (62 GB of weights): 16 requests as in `engine` on
               8 slots, max_len 1 024; launch counts (K7 3 per layer per
               prefill and per decode step, all on the tensor-core
               instance, K6 and its combine 1 per layer per decode step),
               decode ms per step, prefill ms, TTFT, tokens/s, peak memory,
               pages back,
               detections; one decode step with every slot live under
               torch.profiler on the tensor-core K7 and again with the SIMT
               tiles pinned (the kernels before the redesign), and with K6's
               SIMT kernel pinned;
  moe_train    `train_loop.train` on qwen3-moe-235b-a22b at full width, 1
               layer (with f32 AdamW, 2 layers would not fit the card),
               2 x 512 tokens, `remat="full"`, 4 steps: step times,
               tokens/s, peak memory, loss and aux per step, launches of
               K1-K8 per step (checked: every K3, K4, K7 and K8 launch on
               the tensor-core instances), detections; then one guarded
               step, and one step each under torch.profiler on the
               tensor-core instances, on the SIMT K7 / K8 and on the SIMT
               K3 / K4;
  level_train  `train_loop.train` on phi4-mini-3.8b at full width and depth,
               2 x 512 tokens, `remat="full"`, 3 steps at block, tile and
               inner from one seed: each level's losses within 1e-2 of
               block's, zero detections, launches per step (K1 on the
               tensor cores at every level), step times, one more step under torch.profiler (busy
               time, idle share); then at 2 layers x 256 tokens a
               `bwd_inject` SEU in w_down's dw (the transposed-A walk),
               corrected to the clean grads by train_check's rule (1e-3)
               and left by detect-only (>= 100x), and a campaign on w_gate
               (its forward act_grad kernel and its backward GEMMs) at each
               level: each act_grad call with the clean run's operands
               gives its outputs bit for bit but at the corrected cells
               (there within one bf16 ulp), and the grads match the plain
               versions' correction of the same draws within 2e-2
               (detect-only >= 10x further);
  level_moe    qwen3-moe-235b-a22b at tile and inner: `ServeEngine` at full
               width, 12 layers, 8 requests on 8 slots (decode ms per step,
               prefill ms, TTFT, tokens/s, peak memory, launches: K1 and K7
               on the tensor-core level instances, zero detections, pages
               back, one profiled decode step), `train_loop.train` at 1
               layer as moe_train (3 steps, launches: K1, K7 and K8 on the
               tensor-core level instances, one profiled step), and
               `bwd_inject` SEUs in
               moe_gate's dw (K8) and dbuf (K7 on the wᵀ walk) corrected by
               train_check's rule and left by detect-only;
  campaign_kernels  stochastic SEU campaigns on the GEMM family's
               instances (K1, K5, K7, K8, tensor cores and SIMT, K1's
               tensor-core level instance at tile, K8's at tile and inner),
               each at a
               main-path shape and a shape with a tail block, on integer-
               valued operands under a fixed triple at rates 0.5 and 1.0:
               reports equal to the planned plain version's, one detection and
               correction per SEU the blocks draw (`templates/seu.py`), the
               output the clean call's, detect-only controls, rate 0 the clean
               call bit for bit; the paper's Fig. 16 analogue on K1's
               tensor-core instance at qwen2-7b's decode and prefill
               w_gate+silu and a 4 096 square (clean, rate 0, rate 1.0, FT
               off, torch.matmul; errors per call and per minute at rate 1.0;
               CUDA events, three rounds in turns), and K5, K7 and K8 (K8 at
               block, tile and inner) at rate 0 and 1.0 beside their clean
               calls (K5 at decode by calls
               queued behind a device-side sleep). Then the flash family's
               nine instances on Gaussian bf16 (f32 for the SIMT ones) under
               the same triple at rates 0.5 and 1.0: K2 on the tensor cores at
               the prefill shape and at phi4-mini's S 512 (dh 128) and at
               whisper's dh 64 (16 heads over 300 frames), K3 and K4 at
               phi4-mini's S 512 (K4 in 3 ranges), K6 at the engine's shape (9
               ranges), the SIMT K2, K3, K4 and K6 in f32 and K6 at pages of
               16: reports equal to the planned plain version's in det / corr
               / row / col / k and tau, one detection and correction per drawn
               SEU, the outputs within the bf16 tolerance of the clean call's,
               detect-only leaving the SEUs in, rate 0 the clean call; and the
               Fig. 16 table of K2 at the prefill shape, K3 + K4 at S 512 and
               K6 at the engine's shape (the device time of a call, its
               kernels back to back: CUDA events around calls queued behind a
               device-side sleep, `queued_ms`; clean, rate 0, rate 1.0, three
               rounds in turns);
  campaign_train  phi4-mini-3.8b at full width and depth, 2 x 512 tokens,
               `remat="full"`, the default (flash) attention, 4 steps from
               one initialisation three times: clean, a campaign at
               CAMPAIGN_RATE every step, the same detect-only; each step's
               detections equal the SEUs its forward's GEMM and flash blocks
               draw, within a 5-sigma binomial band of rate x blocks; the
               backward's K3 and K4 reports (`ops.flash_ft_bwd` wrapped)
               detect and correct each SEU they draw; losses and the
               parameters after step 1 within 1e-3 relative of the clean
               run, the detect-only losses at least 100x further off; step
               times, the first step of each run under the dispatch guard,
               the last profiled (busy time, idle share);
  campaign_train_chunked  the same on chunked attention (QKᵀ and PV
               through K5's SIMT instance, no flash kernel);
  moe_campaign the same as campaign_train with two steps of the moe_train
               model (qwen3-moe-235b-a22b at full width, 1 layer, flash
               attention), at MOE_CAMPAIGN_RATE; the first step guarded, the
               second profiled;
  chain_kernels  K1's epilogue chains: bias? + gelu / relu on the tensor-
               core instances at FT off, block, tile and inner, with and
               without act_grad, at whisper-medium's w1 shape (6 000 x 1 024
               -> 4 096, bf16) against the plain version under the same
               plan; an SEU on integer operands at each level corrected bit
               for bit and located, and left by detect-only; CUDA-event
               times beside torch.matmul + F.gelu(approximate="tanh") and
               the bound; the SIMT chain instance (csrc/ft_gemm_chain.cu) on
               every chain it takes in bf16 and f32 at every level, with
               act_grad, against its plain version, an SEU per level on a
               residual chain, and its time at w1's width on gelu+residual;
  act_chains   the last parts of the TPU kernels: K5 with the chains relu
               and gelu+relu on its tensor-core instance at qwen2-7b's
               dec_qk (4 x 4 x 7 x 256 x 128 on the permuted K cache) and
               on the SIMT chain instance (csrc/ft_gemm_chain.cu) at
               mamba2's ssd_cb (384 x 256 x 128 x 256); K7 with silu and
               gelu+relu at qwen3-moe's decode gate (64 rows over 128
               experts, 4 096 -> 1 536) on its tensor-core instance (bf16)
               and its SIMT chain instance (f32); K1's chains of several
               activations (gelu+relu, bias+silu+relu+residual) on the
               chain instance at whisper's w1 (6 000 x 1 024 -> 4 096):
               each at FT off, block, tile and inner against its plain
               version under the same plan (one launch of the instance,
               outputs to one bf16 ulp, reports equal), an SEU on integer
               operands at each level corrected bit for bit and located,
               and left by detect-only, the queued device time at block
               beside the plain version, the library (the product, then the
               chain) and the bound; the SIMT K5 at 70 000 slices of 17 x 8
               · 8 x 8 (above gridDim.z's 65 535) against its plain version,
               an SEU in the last slice; then the front doors once each
               (`ops.grouped_gemm_call` with a chain for K5, K7 and K8, which
               drops it, and `ops.gemm_call`; the rows front door pins K7's
               and K8's SIMT tiles), every launch count set to 0 before and
               read after, under the dispatch guard, each output held to its
               plain version;
  whisper_check  whisper-medium at full width, 2 + 2 layers: prefill and 2
               decode steps (the same tokens fed to both) through the
               kernels and through their plain versions at FT off, block,
               tile and inner (logits within 2e-2 of max|logit|, no
               detection, launch counts); K2 on the tensor cores at dh 64
               (csrc/flash_fwd_sm90.cu) at the encoder's 1 500-frame
               self-attention (with and without the statistics), the
               prefill's cross-attention and the decoder's causal 16-token
               self-attention, each as the train_kernels phase checks K2
               (plan, launches, the plain version, an SEU in S and in Δ
               corrected, located and left by detect-only), timed beside the
               SIMT instance (pinned blocks), the same call zero-padded to dh
               128, SDPA and the bound; and K5 at the cross cache's xdec_qk /
               xdec_pv (K 64 / 1 500; tau's k 1 500; an SEU in the ragged
               last k-step corrected) against their plain versions, times
               beside torch.matmul and the bound;
  whisper_serve  `generate` on whisper-medium at full width and depth (24 +
               24 layers, random bf16 weights from a seed): 4 requests of 16
               prompt tokens over 1 500 frames drawn from the seed, 8 greedy
               tokens, at FT off, block, tile and inner: launch counts (K1
               by instance, K2, K5; none at FT off, whose products take the
               plain-matmul fast path, as in the reference), the dispatch
               guard, prefill and decode times, tokens/s, peak memory, one
               decode step and one prefill under torch.profiler (busy time,
               idle share); at block the prefill and `generate` again with
               K2 pinned to its SIMT instance (`simt_flash_fwd`): logits
               within 2e-2 of max|logit| of the tensor cores', its profile,
               the greedy tokens compared (printed); an SEU in encoder
               layer 0's w1 at block, tile and inner corrected (the clean
               run's tokens, its prefill logits to bf16 rounding) and left
               by detect-only;
  ssm_check    mamba2-780m (the SSM family) at full width, 2 layers: a
               prefill of 4 x 512 tokens (two SSD chunks of 256) and 2
               decode steps (the same tokens fed to both) through the
               kernels and through their plain versions at FT off, block,
               tile and inner (logits within 2e-2 of max|logit|, no
               detection, launch counts: K1 2 a layer and the head per
               prefill and per decode step on the level's tensor-core
               instance, K5 4 a layer per prefill on its SIMT instance,
               none at FT off); then K5's SIMT instance at the four SSD
               products of that prefill (ssd_cb, ssd_lx, ssd_state, ssd_ch;
               384 slices of 128-256 rows) against its plain version at FT
               off and each level, an SEU on integer operands in one slice
               corrected bit for bit and located at its global row and
               column, and left by detect-only; times of the kernel (queued
               device time), FT off, the plain version, torch.matmul and the
               bound;
  ssm_serve    `generate` on mamba2-780m at full width and depth (48
               layers, random bf16 weights from a seed): 4 requests x 512
               prompt tokens, 32 greedy tokens, at FT off, block, tile and
               inner: launch counts, the dispatch guard (the decode
               readout's f32 einsum its one allowance), prefill and decode
               times, tokens/s, peak memory, one prefill and one decode step
               under torch.profiler (busy time, idle share, K5's share of
               the prefill); at block an SEU in layer 0's first ssd_cb
               product corrected (the clean run's tokens, its prefill
               logits to bf16 rounding) and left by detect-only.

The last two lines are {"kernels": [...]} and
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Without a CUDA device the script fails before printing any result.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
import traceback
from contextlib import contextmanager

import numpy as np
import torch
import torch.utils._python_dispatch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

from repro_torch.configs import (mamba2_780m, phi4_mini_38b,  # noqa: E402
                                 qwen2_7b, qwen3_moe_235b,
                                 whisper_medium)
from repro_torch.configs.base import RunConfig, ShapeConfig     # noqa: E402
from repro_torch.core import ft_verdict_dot, telemetry          # noqa: E402
from repro_torch.core.policy import (FT_OFF, InjectionSpec,     # noqa: E402
                                     NONFUSED_BASELINE, OFFLINE_DETECT,
                                     ONLINE_BLOCK)
from repro_torch.data import pipeline as data_lib               # noqa: E402
from repro_torch.kernels import build, flashft, ft_gemm         # noqa: E402
from repro_torch.kernels import gemm as base_gemm               # noqa: E402
from repro_torch.kernels import grouped_gemm, ops               # noqa: E402
from repro_torch.kernels import grouped as kgrouped             # noqa: E402
from repro_torch.kernels.templates import BatchedKernelSpec     # noqa: E402
from repro_torch.kernels.templates import epilogues             # noqa: E402
from repro_torch.models import (mamba2, moe, model_zoo,       # noqa: E402
                                transformer, whisper)
from repro_torch.models.blocks import Ctx                       # noqa: E402
from repro_torch.optim import adamw                             # noqa: E402
from repro_torch.train import engine, kv_cache, serve, train_loop  # noqa: E402

PEAK_FLOPS = 989e12        # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_BYTES = 3.35e12       # H100 SXM HBM3
FT = ONLINE_BLOCK.replace(backend="pallas")
DETECT = OFFLINE_DETECT.replace(backend="pallas")
BATCH, PROMPT, NEW_TOKENS, MAX_LEN = 4, 128, 32, 256
#: training: phi4-mini-3.8b, 2 x 512 tokens, 4 steps; the check at 1 x 256
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 2, 512, 4
CHECK_SEQ, CHECK_LAYERS = 256, 2
#: kernel vs plain: one bf16 ulp at the top of the output's range (the two
#: sum in different orders in f32, then round to bf16).
BF16_TOL = 2.0 ** -7
#: f32 kernel vs plain or library at K <= 8 192: the two sum in different
#: orders in f32; 1e-4 of the top of the output's range.
F32_TOL = 1e-4
#: The paper's GEMM anatomy: the tile (warp) and inner (thread) FT levels
#: beside block; level_serve's greedy tokens.
LEVELS = ("tile", "inner")
K5_LEVELS = ("block",) + LEVELS
#: K5's long-cache timing row (positions)
LONG_CACHE = 4096
LEVEL_NEW_TOKENS = 16
#: The ladder: f32 squares, bound by the f32 rate of the CUDA cores (H100
#: SXM, NVIDIA data sheet: 67 TFLOP/s without the tensor cores).
LADDER_SIZES = (1024, 4096, 8192)
PEAK_F32 = 67e12

KERNELS = {
    # K1 on the tensor cores: every bf16 2-D call at FT off and block
    "ft_gemm_sm90": dict(route="cuda",
                         source="src/repro_torch/kernels/csrc/"
                                "ft_gemm_sm90.cu",
                         replaces="src/repro/kernels/templates/registry.py:48",
                         counter=ft_gemm.FT_GEMM_SM90),
    # ... and at the tile and inner levels (the same kernels, built from
    # their own source)
    "ft_gemm_level_sm90": dict(route="cuda",
                               source="src/repro_torch/kernels/csrc/"
                                      "ft_gemm_level_sm90.cu",
                               replaces="src/repro/kernels/templates/"
                                        "registry.py:48",
                               counter=ft_gemm.FT_GEMM_LEVEL_SM90),
    # K1's SIMT instance: f32, pinned tiles, other chains and walks
    "ft_gemm_2d": dict(route="cuda",
                       source="src/repro_torch/kernels/csrc/ft_gemm.cu",
                       replaces="src/repro/kernels/templates/registry.py:48",
                       counter=ft_gemm.FT_GEMM_2D_SIMT),
    # ... and its chain instance: every chain ft_gemm.cu does not compile,
    # as a runtime op list
    "ft_gemm_chain": dict(route="cuda",
                          source="src/repro_torch/kernels/csrc/"
                                 "ft_gemm_chain.cu",
                          replaces="src/repro/kernels/templates/"
                                   "registry.py:48",
                          counter=ft_gemm.FT_GEMM_CHAIN),
    # K5 on the tensor cores: every bf16 call of at most 16 rows a slice
    "ft_gemm_batched_sm90": dict(route="cuda",
                                 source="src/repro_torch/kernels/csrc/"
                                        "batched_sm90.cu",
                                 replaces="src/repro/kernels/templates/"
                                          "registry.py:518",
                                 counter=ft_gemm.FT_GEMM_BATCHED_SM90),
    # K5's SIMT instance: f32, more than 16 rows, pinned tiles
    "ft_gemm_batched": dict(route="cuda",
                            source="src/repro_torch/kernels/csrc/ft_gemm.cu",
                            replaces="src/repro/kernels/templates/"
                                     "registry.py:520",
                            counter=ft_gemm.FT_GEMM_BATCHED),
    # ... and with an activation chain, on the chain instance
    "ft_gemm_batched_chain": dict(route="cuda",
                                  source="src/repro_torch/kernels/csrc/"
                                         "ft_gemm_chain.cu",
                                  replaces="src/repro/kernels/templates/"
                                           "registry.py:518",
                                  counter=ft_gemm.FT_GEMM_BATCHED_CHAIN),
    # K2 on the tensor cores: every bf16 call at head dim 64 or 128
    "flash_ft_sm90": dict(route="cuda",
                          source="src/repro_torch/kernels/csrc/"
                                 "flash_fwd_sm90.cu",
                          replaces="src/repro/kernels/flashft.py:114",
                          counter=flashft.FLASH_FT_SM90),
    # its SIMT instance: f32, pinned blocks
    "flash_ft": dict(route="cuda",
                     source="src/repro_torch/kernels/csrc/flash_ft.cu",
                     replaces="src/repro/kernels/flashft.py:114",
                     counter=flashft.FLASH_FT),
    # K3 and K4 on the tensor cores: every bf16 call at head dim 128, and
    # K4's range reduce
    "flash_dq_sm90": dict(route="cuda",
                          source="src/repro_torch/kernels/csrc/"
                                 "flash_bwd_sm90.cu",
                          replaces="src/repro/kernels/flashft.py:488",
                          counter=flashft.FLASH_DQ_SM90),
    "flash_dkv_sm90": dict(route="cuda",
                           source="src/repro_torch/kernels/csrc/"
                                  "flash_bwd_sm90.cu",
                           replaces="src/repro/kernels/flashft.py:569",
                           counter=flashft.FLASH_DKV_SM90),
    "flash_dkv_reduce": dict(route="cuda",
                             source="src/repro_torch/kernels/csrc/"
                                    "flash_bwd_sm90.cu",
                             replaces="src/repro/kernels/flashft.py:569",
                             counter=flashft.FLASH_DKV_REDUCE),
    # their SIMT instances: f32, head dim 64, pinned blocks
    "flash_dq": dict(route="cuda",
                     source="src/repro_torch/kernels/csrc/flash_ft_bwd.cu",
                     replaces="src/repro/kernels/flashft.py:488",
                     counter=flashft.FLASH_DQ),
    "flash_dkv": dict(route="cuda",
                      source="src/repro_torch/kernels/csrc/flash_ft_bwd.cu",
                      replaces="src/repro/kernels/flashft.py:569",
                      counter=flashft.FLASH_DKV),
    # K6 on the tensor cores: every bf16 call of 16 query rows per kv head
    # at head dim 128 in pages of 32 or 64, split over the pages, and the
    # combine of its ranges
    "flash_decode_sm90": dict(route="cuda",
                              source="src/repro_torch/kernels/csrc/"
                                     "flash_decode_sm90.cu",
                              replaces="src/repro/kernels/flashft.py:270",
                              counter=flashft.FLASH_DECODE_SM90),
    "flash_decode_combine": dict(route="cuda",
                                 source="src/repro_torch/kernels/csrc/"
                                        "flash_decode_sm90.cu",
                                 replaces="src/repro/kernels/flashft.py:270",
                                 counter=flashft.FLASH_DECODE_COMBINE),
    # its SIMT instance: f32, dh 256, pages of 16, 32 query rows
    "flash_decode": dict(route="cuda",
                         source="src/repro_torch/kernels/csrc/"
                                "flash_decode.cu",
                         replaces="src/repro/kernels/flashft.py:270",
                         counter=flashft.FLASH_DECODE),
    # K7: batched_kernel_call with grouped=True (the grouped body of
    # emit.py:233 render), on the tensor cores: every bf16 call at every
    # level
    "ft_gemm_grouped_sm90": dict(route="cuda",
                                 source="src/repro_torch/kernels/csrc/"
                                        "grouped_sm90.cu",
                                 replaces="src/repro/kernels/templates/"
                                          "registry.py:520",
                                 counter=grouped_gemm.FT_GEMM_GROUPED_SM90),
    # K7's SIMT instance: f32 and the pinned SIMT tiles
    "ft_gemm_grouped": dict(route="cuda",
                            source="src/repro_torch/kernels/csrc/ft_gemm.cu",
                            replaces="src/repro/kernels/templates/"
                                     "registry.py:520",
                            counter=grouped_gemm.FT_GEMM_GROUPED_SIMT),
    # ... and with an activation chain, its chain instance
    "ft_gemm_grouped_chain": dict(route="cuda",
                                  source="src/repro_torch/kernels/csrc/"
                                         "ft_gemm_chain.cu",
                                  replaces="src/repro/kernels/templates/"
                                           "registry.py:520",
                                  counter=grouped_gemm.FT_GEMM_GROUPED_CHAIN),
    # K8 on the tensor cores, and its SIMT instance
    "tgmm_sm90": dict(route="cuda",
                      source="src/repro_torch/kernels/csrc/grouped_sm90.cu",
                      replaces="src/repro/kernels/templates/registry.py:411",
                      counter=grouped_gemm.TGMM_SM90),
    "tgmm": dict(route="cuda", source="src/repro_torch/kernels/csrc/tgmm.cu",
                 replaces="src/repro/kernels/templates/registry.py:411",
                 counter=grouped_gemm.TGMM_SIMT),
    "naive_gemm": dict(route="cuda",
                       source="src/repro_torch/kernels/csrc/gemm_naive.cu",
                       replaces="src/repro/kernels/gemm.py:61",
                       counter=base_gemm.NAIVE_GEMM),
}
#: zero launches of the MoE kernels and of K9, for the model paths'
#: expected counts
OFF_PATH = {"ft_gemm_grouped_sm90": 0, "ft_gemm_grouped": 0,
            "tgmm_sm90": 0, "tgmm": 0, "naive_gemm": 0}
#: zero launches of the flash backward, for the serving paths
NO_FLASH_BWD = {"flash_dq_sm90": 0, "flash_dkv_sm90": 0,
                "flash_dkv_reduce": 0, "flash_dq": 0, "flash_dkv": 0}
#: paged serving: qwen2-7b, 16 requests on 8 slots, max_len 1 024
ENGINE_SLOTS, ENGINE_REQUESTS, ENGINE_MAX_LEN = 8, 16, 1024
DECODE_LENGTHS = (0, 1, 63, 64, 65, 300, 777, 1024)


def k1_launches(count: int, level: str = "block"):
    """The expected K1 2-D counts of a bf16 path at FT ``level``: every
    launch on the tensor cores, on ft_gemm_sm90 at off and block, on
    ft_gemm_level_sm90 at tile and inner; the SIMT instances never, nor
    the chain instances of csrc/ft_gemm_chain.cu (K1's, K5's and K7's: no
    model path has a chain they take)."""
    lv = level in ("tile", "inner")
    return {"ft_gemm_sm90": 0 if lv else count,
            "ft_gemm_level_sm90": count if lv else 0, "ft_gemm_2d": 0,
            "ft_gemm_chain": 0, "ft_gemm_batched_chain": 0,
            "ft_gemm_grouped_chain": 0}


def k5_launches(count: int):
    """K5's expected counts on a bf16 path (decode attention's cache
    products, n_rep <= 16): every launch on the tensor-core instance."""
    return {"ft_gemm_batched_sm90": count, "ft_gemm_batched": 0}


def k2_launches(count: int):
    """K2's expected counts on a bf16 path at head dim 64 or 128: every
    launch on the tensor-core instance."""
    return {"flash_ft_sm90": count, "flash_ft": 0}


def k6_launches(count: int):
    """K6's expected counts on a bf16 path (16 query rows per kv head, dh
    128, pages of 64): every launch on the tensor-core instance followed
    by its combine, the SIMT kernel never."""
    return {"flash_decode_sm90": count, "flash_decode_combine": count,
            "flash_decode": 0}


def flash_bwd_launches(cfg, layers: int):
    """The flash backward's expected launches in a bf16 train step of
    TRAIN_BATCH x TRAIN_SEQ tokens: K3 and K4 on the tensor cores once per
    layer, K4's range reduce too when `plan_bwd` cuts its walk, the SIMT
    kernels never."""
    nb = -(-TRAIN_SEQ // flashft.BLOCK)
    ranges = flashft.dkv_ranges(TRAIN_BATCH * cfg.n_kv_heads * nb,
                                cfg.n_heads // cfg.n_kv_heads * nb)
    return {"flash_dq_sm90": layers, "flash_dkv_sm90": layers,
            "flash_dkv_reduce": layers if ranges > 1 else 0, "flash_dq": 0,
            "flash_dkv": 0}


class CheckFailed(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise CheckFailed(what)
    print(f"  ok: {what}")


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / iters


def bound(flops: float, nbytes: float):
    t_op, t_by = flops / PEAK_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_op, "operations") if t_op >= t_by else (t_by, "bytes")


def device_events(fn, iters: int = 1, warmup: int = 0):
    """``iters`` calls of ``fn``, after ``warmup`` more, under
    `torch.profiler` (CUDA activity only): the device's kernel intervals as
    (name, start, end) in µs, and the host wall time in µs from the first
    call to the end of the device work."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans = [(e.name, e.time_range.start, e.time_range.end)
             for e in prof.events()
             if getattr(e, "device_type", None)
             == torch.autograd.DeviceType.CUDA]
    return spans, wall_us


def device_profile(fn, groups=None):
    """One call of ``fn`` (`device_events`): the host wall time to the end
    of the device work, the device's busy time (the union of its kernel
    intervals), the idle share 1 - busy / wall, and the kernels by total
    time. idle_share is None ("not measured") when the trace holds no
    device event. ``groups`` {label: predicate on a kernel's name} adds
    each group's summed kernel time, ``group_ms``."""
    spans, wall_us = device_events(fn)
    by_name = collections.Counter()
    group_us = collections.Counter()
    for name, lo, hi in spans:
        by_name[name[:60]] += hi - lo
        for label, pred in (groups or {}).items():
            if pred(name):
                group_us[label] += hi - lo
    busy, end = 0.0, -math.inf
    for _, lo, hi in sorted(spans, key=lambda x: x[1:]):
        lo = max(lo, end)
        if hi > lo:
            busy += hi - lo
        end = max(end, hi)
    out = dict(wall_ms=wall_us / 1e3, busy_ms=busy / 1e3,
               idle_share=(1.0 - busy / wall_us) if spans else None,
               kernels=len(spans),
               top=[(n, round(t / 1e3, 3))
                    for n, t in by_name.most_common(6)])
    if groups:
        out["group_ms"] = {k: group_us[k] / 1e3 for k in groups}
    return out


def kernel_device_ms(fn, iters: int = 50) -> float:
    """The device time of one call of ``fn``: the summed durations of the
    kernels it launches (`device_events` over ``iters`` calls after a
    warm-up), per call. The host's time to launch each call does not
    count, as it does in `time_ms` over back-to-back calls of a few
    microseconds each."""
    spans, _ = device_events(fn, iters, warmup=3)
    total = sum(hi - lo for _, lo, hi in spans)
    check(total > 0, "the profiler saw the call's kernels on the device")
    return total / iters / 1e3


def queued_ms(fn, iters: int = 30, warmup: int = 3) -> float:
    """The device time of one call of ``fn``, its kernels back to back:
    CUDA events around ``iters`` calls queued behind a device-side sleep
    that outlasts the host's time to enqueue them, so the host's launch
    time (tens of µs a call, as long as K2's or K6's kernel) does not
    count, and no profiler trace is read (a long run's traces drop events
    and carry some over from the session before). Checks that the sleep
    was still running when the last call was queued, and retries with a
    longer one until it was."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for attempt in range(4):
        # spin cycles for 4x the host's enqueue time at a 2 GHz clock
        torch.cuda._sleep(int((4 * host_s + 1e-3) * 2e9) << attempt)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        ahead = not start.query()
        end.synchronize()
        if ahead:
            return start.elapsed_time(end) / iters
    check(False, "the calls were queued before the device reached them")


def k1_host_us(a, b, calls: int = 200, **kw) -> float:
    """Host time of one `ft_gemm` call (plan, allocation, the ctypes launch),
    from ``calls`` calls enqueued back to back without a synchronisation."""
    for _ in range(3):
        ft_gemm.ft_gemm(a, b, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        ft_gemm.ft_gemm(a, b, **kw)
    host = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return host


# ---------------------------------------------------------------------------
# env
# ---------------------------------------------------------------------------

def phase_env() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    builds = build.build_all()
    print(f"nvcc build of {len(builds)} sources (in parallel): "
          f"{time.perf_counter() - t0:.1f} s wall")
    for rec in builds.values():
        print(f"  {rec.name}.cu: {rec.seconds:.1f} s -> {rec.path.name}")
        fn = ""
        for line in rec.log.splitlines():
            if "Compiling entry function" in line:
                fn = line.split("'")[1] if "'" in line else line
                # the instance: the mangled name from the kernel's own name
                # on, its template arguments included (FT, LEVEL, tiles, ...)
                # (a mangled name is <length><identifier>; the length's
                # digits may follow a hash's digits, so try each suffix)
                fn = next((fn[m.end():] for m in re.finditer(r"\d+", fn)
                           for i in range(m.start(), m.end())
                           if fn[m.end():m.end() + int(fn[i:m.end()])]
                           .endswith("kernel")), fn)
            elif "Used" in line or "spill" in line:
                print(f"    {fn[:100]}: {line.strip()}")
            elif "wgmma" in line:
                # ptxas's note when it serialises an instance's wgmmas
                print(f"    {line.strip()[:220]}")
    return smi


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------

def _rand(gen, *shape, scale=1.0):
    return (torch.randn(*shape, generator=gen, device="cuda") * scale
            ).to(torch.bfloat16)


def _ints(gen, *shape):
    return torch.randint(-2, 3, shape, generator=gen, device="cuda"
                         ).to(torch.bfloat16)


def _plain_gemm(a, b, **kw):
    """K1's plain version under the plan the kernel follows (tiles and
    split-K ranges)."""
    return ft_gemm.planned_plain(a, b, **kw)


def _simt_ms(a, b, iters, warmup=3, **kw):
    """The time of the same call on K1's SIMT instance at its own tiles."""
    return time_ms(lambda: ft_gemm.ft_gemm(
        a, b, tiles=ft_gemm.pick_tiles(a.shape[-2]), **kw), iters,
        warmup=warmup)


def _k1_seus(label, a, b, kw, row, col, steps):
    """Deterministic SEUs of K1 at each of ``steps`` (256-deep k-steps) on
    integer-valued operands: corrected bit for bit and located; then the
    same SEU under a detect-only policy left in place and counted by the
    split-K rule (once at each later verification of its split and at the
    final one)."""
    p = ft_gemm.plan_call(a, b, ft=FT, chain=kw.get("chain", ()))
    ranges = ft_gemm.split_ranges(a.shape[1], p.tiles[2], p.splits)
    clean, _ = ft_gemm.ft_gemm(a, b, ft=FT, **kw)
    for step in steps:
        inj = (1, -1, row, col, step)
        z = next(i for i, (lo, hi) in enumerate(ranges) if lo <= step < hi)
        out, rep = ft_gemm.ft_gemm(a, b, ft=FT, inj=inj, inj_mag=1000.0,
                                   **kw)
        cell = rep[rep[..., 0] > 0]
        check(torch.equal(out, clean) and float(rep[..., 0].sum()) == 1.0
              and float(rep[..., 1].sum()) == 1.0 and int(cell[0, 2]) == row
              and int(cell[0, 3]) == col
              and abs(float(cell[0, 4]) - 1000.0) < 1e-3,
              f"K1 {label}: SEU at (row {row}, col {col}, k-step {step}, "
              f"split {z} of {p.splits}) corrected bit for bit and located")
        out_d, rep_d = ft_gemm.ft_gemm(a, b, ft=DETECT, inj=inj,
                                       inj_mag=1000.0, **kw)
        want = max(0, ranges[z][1] - 1 - step) + 1
        diff = (out_d != clean).nonzero()
        check(diff.shape[0] == 1 and int(diff[0, 0]) == row
              and int(diff[0, 1]) == col
              and float(rep_d[..., 0].sum()) == want
              and float(rep_d[..., 1].sum()) == 0.0,
              f"K1 {label}: the same SEU left by detect-only and counted "
              f"{want} time(s)")


def _cmp_outputs(name, got, want, rep_k=None, rep_p=None, tol=BF16_TOL):
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    check(err <= tol * scale,
          f"{name}: max|kernel - plain| {err:.3g} <= {tol:.4g} x "
          f"{scale:.3g}")
    if rep_k is not None:
        fields = [0, 1, 2, 3, 7]
        check(torch.equal(rep_k[..., fields], rep_p[..., fields]),
              f"{name}: report det / corr / row / col / k fields equal")
        tau_rel = ((rep_k[..., 6] - rep_p[..., 6]).abs()
                   / rep_p[..., 6].abs().clamp_min(1e-30)).max().item()
        check(tau_rel <= 1e-5, f"{name}: report tau within 1e-5 ({tau_rel:.2g})")
        check(bool((rep_k[..., 5] < rep_k[..., 6]).all())
              and float(rep_k[..., 0].sum()) == 0.0,
              f"{name}: clean run, max residual below tau, no detection")
    return err


def _k5_seus(label, a, b, simt):
    """Deterministic SEUs of K5 on integer-valued operands, broadcast into
    every slice, at each level: on the tensor-core instance at k-step 0 of
    its 256-deep walk, and on the SIMT instance (pinned tiles) at k-step 3
    of its 32-deep one; each corrected bit for bit and located, reports
    equal to the plain version's under the same plan, and left in place
    by a detect-only policy."""
    m, n = a.shape[-2], b.shape[-1]
    slices = a.shape[:-2].numel()
    cases = [(lv, None, (1, -1, m - 1, n - 1, 0)) for lv in K5_LEVELS]
    cases += [(lv, simt, (1, -1, m - 1, n - 1, 3)) for lv in K5_LEVELS]
    for level, tiles, inj in cases:
        ft = FT.replace(level=level)
        where = "SIMT" if tiles else "tensor cores"
        clean, _ = ft_gemm.ft_gemm(a, b, ft=ft, tiles=tiles)
        out, rep = ft_gemm.ft_gemm(a, b, ft=ft, tiles=tiles, inj=inj,
                                   inj_mag=500.0)
        _, rep_p = _plain_gemm(a, b, ft=ft, tiles=tiles, inj=inj,
                               inj_mag=500.0)
        cells = rep[rep[..., 0] > 0]
        check(torch.equal(out, clean)
              and float(rep[..., 0].sum()) == slices
              and float(rep[..., 1].sum()) == slices
              and bool((cells[:, 2] == m - 1).all())
              and bool((cells[:, 3] == n - 1).all())
              and bool(((cells[:, 4] - 500.0).abs() < 1e-2).all())
              and torch.equal(rep[..., :4], rep_p[..., :4]),
              f"K5 {label} {level} ({where}): SEU at k-step {inj[4]} in "
              f"each of {slices} slices corrected bit for bit, located, "
              f"reports equal to the plain version's")
        left, rep_d = ft_gemm.ft_gemm(a, b, ft=ft.replace(action="detect"),
                                      tiles=tiles, inj=inj, inj_mag=500.0)
        diff = (left != clean).reshape(slices, -1).sum(-1)
        check(bool((diff == 1).all()) and float(rep_d[..., 1].sum()) == 0.0
              and float(rep_d[..., 0].sum()) >= slices,
              f"K5 {label} {level} ({where}): the same SEU left in place by "
              f"a detect-only policy")


def _k5_kernels(gen, cfg):
    """K5 at qwen2-7b's decode attention shapes: the tensor-core instance
    (csrc/batched_sm90.cu) at each level against its plain version, the
    SIMT instance pinned by its tiles at each level against its own, SEUs
    on both, and the times: the kernel alone on
    the device's clock (`kernel_device_ms`), the whole wrapper call
    (CUDA events over back-to-back calls), FT off, the SIMT instance, the
    plain versions, one torch.matmul on the same views and the bound."""
    kvh, rep_n = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads
    b_kv, dh = BATCH * kvh, cfg.head_dim
    simt = ft_gemm.pick_tiles(rep_n)

    def k5_operands(make, s=MAX_LEN):
        k_cache, v_cache = (make(gen, BATCH, s, kvh, dh) for _ in range(2))
        tail = "" if s == MAX_LEN else f", cache {s}"
        return {"dec_qk" + tail: (make(gen, BATCH, kvh, rep_n, dh),
                                  k_cache.permute(0, 2, 3, 1)),
                "dec_pv" + tail: (make(gen, BATCH, kvh, rep_n, s),
                                  v_cache.transpose(1, 2))}

    new = dict(max_abs_err=0.0, detail=[], headline="dec_qk")
    old = dict(max_abs_err=0.0, detail=[], headline="dec_qk")
    counters = (ft_gemm.FT_GEMM_BATCHED_SM90, ft_gemm.FT_GEMM_BATCHED)
    # The serving shapes, then a long cache (PV's 64 CTAs walk 16 k-steps:
    # whether its grid starves there).
    cases = {**k5_operands(_rand), **k5_operands(_rand, LONG_CACHE)}
    for label, (a, b) in cases.items():
        m, k, n = a.shape[-2], a.shape[-1], b.shape[-1]
        p = ft_gemm.plan_call(a, b, ft=FT)
        check(p.instance == "sm90" and p.tiles in ft_gemm.BATCHED_SM90_TILES,
              f"K5 {label}: planned on the tensor-core instance ({p})")
        for level in (None,) + K5_LEVELS:
            ft = None if level is None else FT.replace(level=level)
            before = [c.launches for c in counters]
            out, rep = ft_gemm.ft_gemm(a, b, ft=ft)
            check([c.launches - x for c, x in zip(counters, before)]
                  == [1, 0], f"K5 {label} {level or 'FT off'}: one launch "
                  f"of the tensor-core instance, none of the SIMT one")
            out_p, rep_p = _plain_gemm(a, b, ft=ft)
            new["max_abs_err"] = max(new["max_abs_err"], _cmp_outputs(
                f"K5 {label} {level or 'FT off'}", out, out_p, rep, rep_p))
            if rep is not None:
                check(torch.equal(rep[..., :4], rep_p[..., :4]),
                      f"K5 {label} {level}: report det / corr / row / col "
                      f"equal")
        for level in K5_LEVELS:
            ft = FT.replace(level=level)
            before = [c.launches for c in counters]
            out, rep = ft_gemm.ft_gemm(a, b, ft=ft, tiles=simt)
            check([c.launches - x for c, x in zip(counters, before)]
                  == [0, 1], f"K5 SIMT {label} {level}: one launch of the "
                  f"SIMT instance at the pinned tiles {simt}")
            out_p, rep_p = _plain_gemm(a, b, ft=ft, tiles=simt)
            old["max_abs_err"] = max(old["max_abs_err"], _cmp_outputs(
                f"K5 SIMT {label} {level}", out, out_p, rep, rep_p))
        b_dense = b.contiguous()
        runs = {
            "ms": lambda: ft_gemm.ft_gemm(a, b, ft=FT),
            "ft_off_ms": lambda: ft_gemm.ft_gemm(a, b),
            "contiguous_b_ms": lambda: ft_gemm.ft_gemm(a, b_dense, ft=FT),
            "simt_ms": lambda: ft_gemm.ft_gemm(a, b, ft=FT, tiles=simt),
            "simt_contiguous_b_ms": lambda: ft_gemm.ft_gemm(
                a, b_dense, ft=FT, tiles=simt),
            "library_ms": lambda: torch.matmul(a, b)}
        dev = {key: kernel_device_ms(fn, 50) for key, fn in runs.items()}
        call = {key: time_ms(fn, 50) for key, fn in runs.items()}
        plain_ms = time_ms(lambda: _plain_gemm(a, b, ft=FT), 2)
        simt_plain_ms = time_ms(lambda: _plain_gemm(a, b, ft=FT, tiles=simt),
                                2)
        b_ms, b_by = bound(2.0 * b_kv * m * n * k,
                           2 * b_kv * (m * k + k * n + m * n))
        base = dict(shape=label, batch=b_kv, M=m, N=n, K=k, bound_ms=b_ms,
                    bound_by=b_by, library_ms=dev["library_ms"],
                    library_call_ms=call["library_ms"])
        new["detail"].append(dict(
            base, tiles=p.tiles, ms=dev["ms"], call_ms=call["ms"],
            ft_off_ms=dev["ft_off_ms"], contiguous_b_ms=dev["contiguous_b_ms"],
            simt_ms=dev["simt_ms"], simt_call_ms=call["simt_ms"],
            plain_ms=plain_ms))
        old["detail"].append(dict(
            base, tiles=simt, ms=dev["simt_ms"], call_ms=call["simt_ms"],
            contiguous_b_ms=dev["simt_contiguous_b_ms"],
            plain_ms=simt_plain_ms))
        print(f"  K5 {label} ({BATCH}x{kvh}x{m}x{n}x{k}, B a strided view of "
              f"the cache), device ms: tensor cores {dev['ms']:.5f} (tiles "
              f"{p.tiles}; FT off {dev['ft_off_ms']:.5f}, contiguous B "
              f"{dev['contiguous_b_ms']:.5f}), SIMT {dev['simt_ms']:.5f} "
              f"({dev['simt_ms'] / dev['ms']:.1f}x; contiguous B "
              f"{dev['simt_contiguous_b_ms']:.5f}), torch.matmul "
              f"{dev['library_ms']:.5f}, bound {b_ms:.5f} ({b_by}); whole "
              f"calls (CUDA events) {call['ms']:.4f} / SIMT "
              f"{call['simt_ms']:.4f} / torch.matmul "
              f"{call['library_ms']:.4f} ms; plain {plain_ms:.3f} ms (SIMT "
              f"tiles {simt_plain_ms:.3f})")
    for label, (a, b) in k5_operands(_ints).items():
        _k5_seus(label, a, b, simt)
    return {"ft_gemm_batched_sm90": new, "ft_gemm_batched": old}


def phase_kernels():
    gen = torch.Generator(device="cuda").manual_seed(0)
    cfg = qwen2_7b.CONFIG
    d, dff, v = cfg.d_model, cfg.d_ff, cfg.padded_vocab()
    qd, kvd = cfg.qkv_dims
    m_pre, m_dec = BATCH * PROMPT, BATCH
    rows = {}

    # ---- K1: the 2-D ABFT GEMM at the projection shapes ------------------
    k1_cases = [  # (label, M, N, K, chain)
        ("prefill wq+bias", m_pre, qd, d, ("bias",)),
        ("prefill w_gate+silu", m_pre, dff, d, ("silu",)),
        ("prefill w_down", m_pre, d, dff, ()),
        ("decode wk+bias", m_dec, kvd, d, ("bias",)),
        ("decode w_gate+silu", m_dec, dff, d, ("silu",)),
        ("decode w_down", m_dec, d, dff, ()),
        ("decode lm_head", m_dec, v, d, ()),
    ]
    k1_err, k1_rows = 0.0, []
    for label, m, n, k, chain in k1_cases:
        a = _rand(gen, m, k)
        b = _rand(gen, k, n, scale=0.02)
        bias = _rand(gen, n, scale=0.02) if "bias" in chain else None
        kw = dict(chain=chain, bias=bias, ft=FT)
        p = ft_gemm.plan_call(a, b, chain=chain, ft=FT)
        check(p.instance == "sm90", f"K1 {label}: planned on the tensor-core "
              f"instance ({p})")
        before = ft_gemm.FT_GEMM_SM90.launches
        out, rep = ft_gemm.ft_gemm(a, b, **kw)
        check(ft_gemm.FT_GEMM_SM90.launches == before + 1,
              f"K1 {label}: one launch of the tensor-core instance")
        out_p, rep_p = _plain_gemm(a, b, **kw)
        k1_err = max(k1_err, _cmp_outputs(f"K1 {label}", out, out_p, rep,
                                          rep_p))
        check(torch.equal(rep[..., :4], rep_p[..., :4]),
              f"K1 {label}: report det / corr / row / col equal")
        iters = 3 if m == m_pre or n == v else 10
        ms = time_ms(lambda: ft_gemm.ft_gemm(a, b, **kw), iters)
        ms_off = time_ms(lambda: ft_gemm.ft_gemm(a, b, chain=chain, bias=bias,
                                                 ft=None), iters)
        final = dict(kw, ft=FT.replace(verify="final"))
        ms_final = time_ms(lambda: ft_gemm.ft_gemm(a, b, **final), iters)
        simt_ms = _simt_ms(a, b, iters, **kw)
        plain_ms = time_ms(lambda: _plain_gemm(a, b, **kw), 1, warmup=0)
        lib = ((lambda: torch.addmm(bias, a, b)) if bias is not None
               else (lambda: torch.matmul(a, b)))
        lib_ms = time_ms(lib, iters)
        nbytes = 2 * (m * k + k * n + m * n + (n if bias is not None else 0))
        b_ms, b_by = bound(2.0 * m * n * k, nbytes)
        k1_rows.append(dict(shape=label, M=m, N=n, K=k, tiles=p.tiles,
                            splits=p.splits, ms=ms, ft_off_ms=ms_off,
                            verify_final_ms=ms_final, simt_ms=simt_ms,
                            plain_ms=plain_ms, library_ms=lib_ms,
                            bound_ms=b_ms, bound_by=b_by))
        print(f"  K1 {label} ({m}x{n}x{k}, tiles {p.tiles}, {p.splits} "
              f"split(s)): kernel {ms:.4f} ms, FT off {ms_off:.4f} ms (FT "
              f"overhead {ms / ms_off:.3f}x), verify final {ms_final:.4f} "
              f"ms, SIMT {simt_ms:.3f} ms "
              f"({simt_ms / ms:.1f}x the kernel), plain {plain_ms:.3f} ms, "
              f"library {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    # Deterministic SEUs on integer-valued operands at the decode wq shape
    # (split-K ranges of its 14 k-steps): at k-step 0, mid-way in a later
    # range, and at the last step (verified after the bias fold).
    a, b, bias = _ints(gen, m_dec, d), _ints(gen, d, qd), _ints(gen, qd)
    _k1_seus("decode wq+bias", a, b, dict(chain=("bias",), bias=bias),
             m_dec - 1, qd - 1, (0, 6, d // 256 - 1))
    _k1_seus("decode wq+bias", a, b, dict(chain=("bias",), bias=bias), 1,
             700, (5,))
    rows["ft_gemm_sm90"] = dict(max_abs_err=k1_err, detail=k1_rows,
                                headline="decode w_gate+silu")

    # ---- K5: the batched ABFT GEMM at the decode attention operands ------
    # As `blocks.decode_attention` passes them: the grouped queries / probs
    # (B, KVH, rep, ·) against strided views of the (B, S, KVH, dh) cache.
    # The tensor-core instance under `plan_k5` at each level and FT off
    # against its plain version under the same plan; the SIMT instance
    # pinned by its tiles against its own.
    rows.update(_k5_kernels(gen, cfg))

    # ---- K2: flash attention at the prefill shape -------------------------
    rows.update(_flash_fwd_kernels(gen, "qwen2-7b prefill", cfg.n_heads,
                                   cfg.n_kv_heads, BATCH, PROMPT, False))
    return rows


# ---------------------------------------------------------------------------
# serve_check / serve
# ---------------------------------------------------------------------------

@contextmanager
def plain_kernels():
    """Swap each kernel wrapper for its plain version on the card (the
    comparison side of serve_check and train_check)."""
    names = ("flash_ft_fwd", "flash_ft_dq", "flash_ft_dkv")
    saved = ft_gemm.ft_gemm, [getattr(flashft, n) for n in names]

    def gemm(a, b, *, tiles=None, **kw):
        return ft_gemm.planned_plain(a, b, tiles=tiles, **kw)

    def blocks_of(plain):
        def run(*args, bq=None, bkv=None, **kw):
            return plain(*args, bq=bq or flashft.BLOCK,
                         bkv=bkv or flashft.BLOCK, **kw)
        return run

    def grouped(buf, w, gid, row_end, *, tiles=None, **kw):
        return grouped_gemm.planned_grouped_plain(buf, w, gid, row_end,
                                                  tiles=tiles, **kw)

    def tgmm(x, g, row_end, *, bm, tiles=None, **kw):
        return grouped_gemm.planned_tgmm_plain(x, g, row_end, bm=bm,
                                               tiles=tiles, **kw)

    saved_grouped = grouped_gemm.ft_gemm_grouped, grouped_gemm.tgmm
    ft_gemm.ft_gemm = gemm
    grouped_gemm.ft_gemm_grouped, grouped_gemm.tgmm = grouped, tgmm
    for n, plain in zip(names[:2], (flashft.flash_ft_plain,
                                    flashft.flash_dq_plain)):
        setattr(flashft, n, blocks_of(plain))
    flashft.flash_ft_dkv = flashft.planned_dkv_plain
    try:
        yield
    finally:
        ft_gemm.ft_gemm = saved[0]
        grouped_gemm.ft_gemm_grouped, grouped_gemm.tgmm = saved_grouped
        for n, fn in zip(names, saved[1]):
            setattr(flashft, n, fn)


@contextmanager
def simt_grouped():
    """Pin K7's and K8's SIMT tiles on every call: the grouped kernels as
    they ran before their tensor-core instances, for the profiles' "before"
    in the same run."""
    saved = grouped_gemm.ft_gemm_grouped, grouped_gemm.tgmm

    def grouped(buf, w, gid, row_end, **kw):
        bm = buf.shape[0] // gid.shape[0]
        return saved[0](buf, w, gid, row_end,
                        **dict(kw, tiles=kw.get("tiles") or (bm, 128, 32)))

    def tgmm(x, g, row_end, *, bm, **kw):
        return saved[1](x, g, row_end, bm=bm,
                        **dict(kw, tiles=kw.get("tiles") or (bm, 64, 64)))

    grouped_gemm.ft_gemm_grouped, grouped_gemm.tgmm = grouped, tgmm
    try:
        yield
    finally:
        grouped_gemm.ft_gemm_grouped, grouped_gemm.tgmm = saved


@contextmanager
def simt_batched():
    """Pin the SIMT tiles on every K5 call: the batched GEMM as it ran
    before its tensor-core instance, for the profiles' "before" in the
    same run."""
    saved = ft_gemm.ft_gemm

    def pinned(a, b, *, tiles=None, **kw):
        if a.dim() > 2 and tiles is None:
            tiles = ft_gemm.pick_tiles(a.shape[-2])
        return saved(a, b, tiles=tiles, **kw)

    ft_gemm.ft_gemm = pinned
    try:
        yield
    finally:
        ft_gemm.ft_gemm = saved


@contextmanager
def simt_flash_fwd():
    """Pin the SIMT blocks on every K2 call: the flash forward as it ran
    before its tensor-core instance, for the profiles' "before" in the same
    run."""
    saved = flashft.flash_ft_fwd

    def pinned(*args, bq=None, bkv=None, **kw):
        return saved(*args, bq=bq or flashft.BLOCK, bkv=bkv or flashft.BLOCK,
                     **kw)

    flashft.flash_ft_fwd = pinned
    try:
        yield
    finally:
        flashft.flash_ft_fwd = saved


@contextmanager
def simt_decode():
    """Pin the SIMT kernel on every K6 call: the paged decode as it ran
    before its tensor-core instance, for the profiles' "before"."""
    saved = flashft.flash_ft_decode

    def pinned(*args, **kw):
        return saved(*args, **dict(kw, simt=True))

    flashft.flash_ft_decode = pinned
    try:
        yield
    finally:
        flashft.flash_ft_decode = saved


@contextmanager
def simt_flash_bwd():
    """Pin the SIMT blocks on every K3 and K4 call: the flash backward as
    it ran before its tensor-core instance, for the profiles' "before" in
    the same run."""
    names = ("flash_ft_dq", "flash_ft_dkv")
    saved = [getattr(flashft, n) for n in names]

    def pinned(fn):
        def run(*args, bq=None, bkv=None, **kw):
            return fn(*args, bq=bq or flashft.BLOCK, bkv=bkv or flashft.BLOCK,
                      **kw)
        return run

    for n, fn in zip(names, saved):
        setattr(flashft, n, pinned(fn))
    try:
        yield
    finally:
        for n, fn in zip(names, saved):
            setattr(flashft, n, fn)


def _serve_logits(params, cfg, run, prompts, feed):
    """Logits of a prefill and 2 decode steps of ``run`` (and its FT
    totals); ``feed`` None feeds each step the path's own greedy tokens."""
    prefill_fn, decode_fn = serve.make_serve_fns(cfg, run)
    with telemetry.ft_scope() as scope:
        cache = transformer.init_cache(cfg, BATCH, MAX_LEN)
        logits, cache = prefill_fn(params, prompts.cuda(), cache)
        out = [logits.float().reshape(BATCH, -1)]
        for i in range(2):
            tok = (torch.argmax(out[-1], -1)[:, None] if feed is None
                   else feed[i].cuda())
            logits, cache = decode_fn(params, tok, cache)
            out.append(logits.float().reshape(BATCH, -1))
        return out, scope.totals()


def _check_logits(name, got, want):
    for i, (g_, w_) in enumerate(zip(got, want)):
        err = (g_ - w_).abs().max().item()
        scale = w_.abs().max().item()
        check(bool(torch.isfinite(g_).all()) and err <= 2e-2 * scale,
              f"{name} step {i}: max|difference| of the logits {err:.3g} "
              f"<= 2e-2 x {scale:.3g}")


def _check_inputs(cfg):
    """serve_check's and level_check's prompts and decode tokens. The same
    decode tokens go to every path: on random weights the logits are
    near-flat, so each path's own argmax could pick another token."""
    gen = torch.Generator().manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), generator=gen)
    steps = torch.randint(0, cfg.vocab_size, (2, BATCH, 1), generator=gen)
    return prompts, steps


def phase_serve_check():
    cfg = dataclasses.replace(qwen2_7b.CONFIG, n_layers=2)
    run = RunConfig(model=cfg, ft=FT, dtype="bfloat16")
    params = transformer.init(cfg, seed=1, dtype=torch.bfloat16)
    prompts, steps = _check_inputs(cfg)
    got, tot_k = _serve_logits(params, cfg, run, prompts, steps)
    with plain_kernels():
        want, tot_p = _serve_logits(params, cfg, run, prompts, steps)
    _check_logits("serve_check kernel vs plain", got, want)
    check(tot_k["detected"] == 0 and tot_p["detected"] == 0,
          f"serve_check: zero detections (kernels {tot_k}, plain {tot_p})")
    # Each path fed its own greedy tokens (not checked: a flip is allowed
    # where the top-2 margin is below the kernel-vs-plain error).
    greedy_k, _ = _serve_logits(params, cfg, run, prompts, None)
    with plain_kernels():
        greedy_p, _ = _serve_logits(params, cfg, run, prompts, None)
    for i, (g_, w_) in enumerate(zip(greedy_k, greedy_p)):
        top2 = torch.topk(g_, 2, dim=-1).values
        print(f"  greedy step {i}: kernel argmax "
              f"{torch.argmax(g_, -1).tolist()}, plain argmax "
              f"{torch.argmax(w_, -1).tolist()}, kernel top-2 margin "
              f"{[round(x, 4) for x in (top2[:, 0] - top2[:, 1]).tolist()]}, "
              f"max|kernel - plain| {(g_ - w_).abs().max().item():.3g}")


class LibraryCallGuard(torch.utils._python_dispatch.TorchDispatchMode):
    """Records every dispatched library matmul / attention op (`einsum`
    too: under `torch.inference_mode` it reaches the guard whole, not as
    the `bmm` it runs). ``allow`` (name, args) → bool admits the ones a
    path runs outside any kernel by design (the MoE router's f32 product,
    mamba2's decode readout), counted in ``allowed``."""
    BANNED = ("mm", "bmm", "addmm", "baddbmm", "matmul", "dot", "mv",
              "linear", "einsum", "scaled_dot_product_attention",
              "_scaled_dot_product_flash_attention",
              "_scaled_dot_product_efficient_attention",
              "_scaled_dot_product_cudnn_attention")

    def __init__(self, allow=None):
        super().__init__()
        self.hits = []
        self.seen = set()
        self.allow = allow
        self.allowed = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        self.seen.add(name)
        if name in self.BANNED:
            if self.allow is not None and self.allow(name, args):
                self.allowed += 1
            else:
                self.hits.append(str(func))
        return func(*args, **(kwargs or {}))


def router_product(n_experts: int):
    """The guard's allowance for the MoE router: an f32 `mm` (or `matmul`,
    as inference mode dispatches it) with the expert count among its
    operand dims (its forward and its two backward products), which the
    reference leaves to a plain einsum too."""
    def allow(name, args):
        ts = [a for a in args if isinstance(a, torch.Tensor)]
        return (name in ("mm", "matmul")
                and all(t.dtype == torch.float32 for t in ts)
                and any(n_experts in t.shape for t in ts))
    return allow


def ssm_readout(cfg):
    """The guard's allowance for mamba2's decode readout y = C·h, which the
    reference leaves to a plain f32 einsum too: the einsum
    "bhn,bhnp->bhp" (or the `bmm` it runs) on f32 operands, one of them
    the state's (…, N, P)."""
    n, p = cfg.ssm.state, cfg.ssm.head_dim

    def allow(name, args):
        if name == "einsum":
            eq, args = args[0], args[1]
            if eq.replace(" ", "") != "bhn,bhnp->bhp":
                return False
        elif name != "bmm":
            return False
        ts = [a for a in args if isinstance(a, torch.Tensor)]
        return (len(ts) == 2 and all(t.dtype == torch.float32 for t in ts)
                and any(tuple(t.shape[-2:]) == (n, p) for t in ts))
    return allow


def _qwen_serving(layers: int):
    """qwen2-7b at full width and ``layers`` deep, random bf16 weights
    from seed 0, and the batch serving phases' prompts."""
    cfg = qwen2_7b.CONFIG
    if layers != cfg.n_layers:
        print(f"  depth cut: {layers} of {cfg.n_layers} layers")
        cfg = dataclasses.replace(cfg, n_layers=layers)
    t0 = time.perf_counter()
    params = transformer.init(cfg, seed=0, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    print(f"  init: {n_params / 1e9:.2f} B parameters in "
          f"{time.perf_counter() - t0:.1f} s")
    prompts = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT),
                            generator=torch.Generator().manual_seed(0)).numpy()
    return cfg, params, prompts


def _serve_run(name, params, cfg, run, prompts, new_tokens):
    """`generate` once under the dispatch guard (launch counts, dispatched
    ops, FT totals) and once timed without it, then the phase times through
    the same entry points: medians of 3 prefills and of 8 decode steps,
    each timed alone. Checks the launch counts (K1 7 per layer + the head
    per prefill and per decode step, K5 2 per layer per decode step, K2 1
    per layer per prefill) and zero detections. Returns (launches, the
    phase's summary)."""
    sc = serve.ServeConfig(max_len=MAX_LEN)
    torch.cuda.reset_peak_memory_stats()
    # The main path's run, under the guard: launch counts and dispatched ops.
    for k in KERNELS.values():
        k["counter"].launches = 0
    guard = LibraryCallGuard()
    with telemetry.ft_scope() as scope, guard:
        tokens = serve.generate(params, prompts, cfg, run, sc,
                                max_new_tokens=new_tokens, device="cuda")
        torch.cuda.synchronize()
    launches = {n: k["counter"].launches for n, k in KERNELS.items()}
    totals = scope.totals()
    # The timed run, without the guard's per-op Python (the first served
    # as warm-up); it must give the same greedy tokens.
    t0 = time.perf_counter()
    again = serve.generate(params, prompts, cfg, run, sc,
                           max_new_tokens=new_tokens, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"  {name} generate: {tokens.shape} tokens in {wall:.2f} s "
          f"({tokens.size / wall:.2f} new tokens/s), peak memory "
          f"{peak:.1f} GiB")
    print(f"  launches (guarded run): {launches}; FT totals {totals}")
    check((again == tokens).all(), f"{name}: the timed run repeats the "
          f"greedy tokens")
    check(tokens.shape == (BATCH, new_tokens) and int(tokens.min()) >= 0
          and int(tokens.max()) < cfg.vocab_size,
          f"{name}: generate returned in-vocabulary tokens of the expected "
          f"shape")
    check(not guard.hits, f"{name}: no library matmul / attention op "
          f"dispatched ({sorted(set(guard.hits))})")
    per_step = cfg.n_layers * 7 + 1
    check(launches == {**k1_launches(per_step * (new_tokens + 1),
                                     run.ft.level),
                       **k5_launches(2 * cfg.n_layers * new_tokens),
                       **k2_launches(cfg.n_layers), **NO_FLASH_BWD,
                       **k6_launches(0), **OFF_PATH},
          f"{name}: launch counts K1 {per_step} per prefill and per decode "
          f"step (every one on the tensor-core {run.ft.level} instance), K5 {2 * cfg.n_layers} per decode step (every one on "
          f"the tensor-core instance), K2 {cfg.n_layers} per prefill (on the "
          f"tensor-core instance)")
    check(totals["detected"] == 0, f"{name}: zero detections")
    prefill_fn, decode_fn = serve.make_serve_fns(cfg, run)
    prompts_d = torch.as_tensor(prompts).cuda()
    pre = []
    for _ in range(3):
        cache = transformer.init_cache(cfg, BATCH, MAX_LEN)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = prefill_fn(params, prompts_d, cache)
        torch.cuda.synchronize()
        pre.append((time.perf_counter() - t0) * 1e3)
    tok = torch.argmax(logits, -1)[:, None]
    dec, k5_steps = [], []
    k5 = (ft_gemm.FT_GEMM_BATCHED_SM90, ft_gemm.FT_GEMM_BATCHED)
    for _ in range(8):
        before = [c.launches for c in k5]
        t0 = time.perf_counter()
        logits, cache = decode_fn(params, tok, cache)
        tok = torch.argmax(logits.reshape(BATCH, -1), -1)[:, None]
        torch.cuda.synchronize()
        dec.append((time.perf_counter() - t0) * 1e3)
        k5_steps.append([c.launches - x for c, x in zip(k5, before)])
    check(all(x == [2 * cfg.n_layers, 0] for x in k5_steps),
          f"{name}: each of 8 decode steps launches K5's tensor-core "
          f"instance {2 * cfg.n_layers} times, its SIMT instance never")
    prefill_ms, decode_ms = statistics.median(pre), statistics.median(dec)
    print(f"  {name}: prefill {prefill_ms:.1f} ms median of "
          f"{[round(x, 1) for x in pre]} ({BATCH}x{PROMPT} tokens), decode "
          f"{decode_ms:.1f} ms per step median of "
          f"{[round(x, 1) for x in dec]} ({BATCH} tokens)")
    # Where a step's time goes: the device's busy and idle share over one
    # decode step and one prefill (torch.profiler), and the host time of
    # one K1 call at the decode wq+bias shape.
    prof = {}
    if name == "serve":
        state = {"tok": tok, "cache": cache}

        def one_decode():
            state["logits"], state["cache"] = decode_fn(
                params, state["tok"], state["cache"])

        prof["decode"] = device_profile(one_decode)
        with simt_batched():
            prof["decode SIMT K5"] = device_profile(one_decode)
        prof["decode again"] = device_profile(one_decode)
        fresh = transformer.init_cache(cfg, BATCH, MAX_LEN)
        prof["prefill"] = device_profile(
            lambda: prefill_fn(params, prompts_d, fresh))
        with simt_flash_fwd():
            fresh = transformer.init_cache(cfg, BATCH, MAX_LEN)
            prof["prefill SIMT K2"] = device_profile(
                lambda: prefill_fn(params, prompts_d, fresh))
        gen = torch.Generator(device="cuda").manual_seed(3)
        a = _rand(gen, BATCH, cfg.d_model)
        w = _rand(gen, cfg.d_model, cfg.qkv_dims[0], scale=0.02)
        bq = _rand(gen, cfg.qkv_dims[0], scale=0.02)
        prof["k1_host_us"] = k1_host_us(a, w, chain=("bias",), bias=bq,
                                        ft=run.ft)
        for k_, v_ in prof.items():
            print(f"  {name} {k_}: {v_}")
    return launches, dict(
        arch=cfg.arch_id, layers=cfg.n_layers, level=run.ft.level,
        batch=BATCH, prompt=PROMPT, new_tokens=new_tokens, generate_s=wall,
        new_tokens_per_s=tokens.size / wall, prefill_ms=prefill_ms,
        decode_ms_per_step=decode_ms, peak_gib=peak,
        detected=totals["detected"], launches=launches, profile=prof)


def phase_serve(layers: int):
    cfg, params, prompts = _qwen_serving(layers)
    run = RunConfig(model=cfg, ft=FT, dtype="bfloat16")
    launches, summary = _serve_run("serve", params, cfg, run, prompts,
                                   NEW_TOKENS)
    print(json.dumps({"serve": summary}))
    return launches


# ---------------------------------------------------------------------------
# level_kernels / level_check / level_serve / ladder: the paper's GEMM anatomy
# ---------------------------------------------------------------------------

def phase_level_kernels():
    """K1 and K5 at the tile and inner levels against their plain versions
    at serving shapes of qwen2-7b (bf16), beside FT off and block; K1's
    SEUs in every band of a split-K block; the bf16 level ablation; then
    the training and MoE shapes (`_level_training_kernels`)."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    cfg = qwen2_7b.CONFIG
    d, dff = cfg.d_model, cfg.d_ff
    kvh, rep_n, dh = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, \
        cfg.head_dim

    def operands(make, label):
        """(a, b, chain, kw, slices) of a case; make(shape, scale) draws."""
        if label == "dec_qk":
            k_cache = make((BATCH, MAX_LEN, kvh, dh), 1.0)
            return (make((BATCH, kvh, rep_n, dh), 1.0),
                    k_cache.permute(0, 2, 3, 1), (), {}, BATCH * kvh)
        if label == "dec_pv":
            v_cache = make((BATCH, MAX_LEN, kvh, dh), 1.0)
            return (make((BATCH, kvh, rep_n, MAX_LEN), 1.0),
                    v_cache.transpose(1, 2), (), {}, BATCH * kvh)
        m = BATCH * PROMPT if label.startswith("prefill") else BATCH
        a = make((m, d), 1.0)
        if label == "decode wk+bias":
            return (a, make((d, kvh * dh), 0.02), ("bias",),
                    dict(bias=make((kvh * dh,), 0.02)), 1)
        if label == "decode lm_head":
            return a, make((d, cfg.vocab_size), 0.02), (), {}, 1
        return a, make((d, dff), 0.02), ("silu",), {}, 1

    def rnd(shape, scale):
        return _rand(gen, *shape, scale=scale)

    def ints(shape, scale):
        return _ints(gen, *shape)

    rows = {"ft_gemm_level_sm90": dict(max_abs_err=0.0, detail=[]),
            "ft_gemm_2d": dict(max_abs_err=0.0, detail=[]),
            "ft_gemm_batched_sm90": dict(max_abs_err=0.0, detail=[])}
    for label, name in (("prefill w_gate+silu", "ft_gemm_level_sm90"),
                        ("decode w_gate+silu", "ft_gemm_level_sm90"),
                        ("decode wk+bias", "ft_gemm_level_sm90"),
                        ("decode lm_head", "ft_gemm_level_sm90"),
                        ("dec_qk", "ft_gemm_batched_sm90"),
                        ("dec_pv", "ft_gemm_batched_sm90")):
        a, b, chain, kw, nb = operands(rnd, label)
        m, k, n = a.shape[-2], a.shape[-1], b.shape[-1]
        # K1 and K5 run the levels on the tensor cores.
        counter = (ft_gemm.FT_GEMM_BATCHED_SM90 if a.dim() > 2
                   else ft_gemm.FT_GEMM_LEVEL_SM90)
        iters = 3 if m == BATCH * PROMPT else 10
        simt = ft_gemm.pick_tiles(m)
        lib = ((lambda: torch.addmm(kw["bias"], a, b)) if kw
               else (lambda: torch.matmul(a, b)))
        if a.dim() > 2:
            # K5: its few-µs kernels on the device's own clock, FT off, block
            # and the library call beside the level on the same instance (the
            # tensor cores); the whole calls' CUDA-event times, the SIMT
            # instance's included, under their own keys.
            off_ms = kernel_device_ms(lambda: ft_gemm.ft_gemm(a, b))
            block_ms = kernel_device_ms(lambda: ft_gemm.ft_gemm(a, b, ft=FT))
            lib_ms = kernel_device_ms(lib)
            calls = dict(
                block_call_ms=time_ms(lambda: ft_gemm.ft_gemm(a, b, ft=FT),
                                      iters),
                simt_ft_off_call_ms=time_ms(lambda: ft_gemm.ft_gemm(
                    a, b, tiles=simt), iters),
                simt_block_call_ms=time_ms(lambda: ft_gemm.ft_gemm(
                    a, b, ft=FT, tiles=simt), iters),
                library_call_ms=time_ms(lib, iters))
            where = "on the device, tensor cores"
        else:
            # K1: FT off and block on the tensor cores (the like-for-like
            # ablation of the levels), CUDA events over back-to-back calls;
            # the SIMT instance pinned at each level beside it below.
            off_ms = time_ms(lambda: ft_gemm.ft_gemm(a, b, chain=chain,
                                                     **kw), iters)
            block_ms = time_ms(lambda: ft_gemm.ft_gemm(
                a, b, chain=chain, ft=FT, **kw), iters)
            lib_ms = time_ms(lib, iters)
            calls = {}
            where = "on the tensor cores"
        b_ms, b_by = bound(2.0 * nb * m * n * k,
                           2 * nb * (m * k + k * n + m * n)
                           + sum(2 * x.numel() for x in kw.values()))
        for level in LEVELS:
            ft = FT.replace(level=level)
            before = counter.launches
            out, rep = ft_gemm.ft_gemm(a, b, chain=chain, ft=ft, **kw)
            check(counter.launches == before + 1,
                  f"{level} {label}: one launch of the tensor-core "
                  f"{'' if a.dim() > 2 else 'level '}instance")
            out_p, rep_p = _plain_gemm(a, b, chain=chain, ft=ft, **kw)
            err = _cmp_outputs(f"{level} {label}", out, out_p, rep, rep_p)
            check(torch.equal(rep[..., :4], rep_p[..., :4]),
                  f"{level} {label}: report det / corr / row / col equal")
            ms = time_ms(lambda: ft_gemm.ft_gemm(a, b, chain=chain, ft=ft,
                                                 **kw), iters)
            extra = dict(calls)
            if a.dim() > 2:
                extra["call_ms"] = ms
                ms = kernel_device_ms(lambda: ft_gemm.ft_gemm(a, b, ft=ft))
            else:
                extra["simt_ms"] = time_ms(lambda: ft_gemm.ft_gemm(
                    a, b, chain=chain, ft=ft, tiles=simt, **kw),
                    max(iters // 3, 1))
                if m == BATCH:
                    # the SIMT instance pinned at the level, against its
                    # plain version at its tiles (the ft_gemm_2d row)
                    o_s, r_s = ft_gemm.ft_gemm(a, b, chain=chain, ft=ft,
                                               tiles=simt, **kw)
                    (o_p, r_p), p_ms = _timed(lambda: _plain_gemm(
                        a, b, chain=chain, ft=ft, tiles=simt, **kw))
                    e_s = _cmp_outputs(f"{level} {label} SIMT pinned", o_s,
                                       o_p, r_s, r_p)
                    rows["ft_gemm_2d"]["max_abs_err"] = max(
                        rows["ft_gemm_2d"]["max_abs_err"], e_s)
                    rows["ft_gemm_2d"]["detail"].append(dict(
                        shape=f"{label} ({level}, SIMT tiles {simt})",
                        level=level, M=m, N=n, K=k, ms=extra["simt_ms"],
                        plain_ms=p_ms, library_ms=lib_ms, bound_ms=b_ms,
                        bound_by=b_by))
            plain_ms = time_ms(lambda: _plain_gemm(a, b, chain=chain, ft=ft,
                                                   **kw), 1, warmup=0)
            rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"], err)
            rows[name]["detail"].append(dict(
                shape=f"{label} ({level})", level=level, batch=nb, M=m, N=n,
                K=k, ms=ms, ft_off_ms=off_ms, block_ms=block_ms,
                plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                bound_by=b_by, **extra))
            print(f"  {level} {label} ({nb}x{m}x{n}x{k}), {where}: kernel "
                  f"{ms:.5f} ms, FT off {off_ms:.5f} ms, block "
                  f"{block_ms:.5f} ms ({ms / off_ms:.3f}x FT off, "
                  f"{ms / block_ms:.3f}x block), library {lib_ms:.5f} ms; "
                  f"bound {b_ms:.5f} ms ({b_by}); plain {plain_ms:.3f} ms; "
                  + ", ".join(f"{x} {y:.4f}" for x, y in extra.items()))
        # A deterministic SEU on integer-valued operands, in every slice, at
        # a k-step mid-way in the walk of the instance the plan picks.
        a, b, chain, kw, nb = operands(ints, label)
        bk = ft_gemm.plan_call(a, b, chain=chain,
                               ft=FT.replace(level=LEVELS[0])).tiles[2]
        row, col, step = m - 1, n - 3, ft_gemm.cdiv(k, bk) // 2
        inj = (1, -1, row, col, step)
        for level in LEVELS:
            ft = FT.replace(level=level)
            clean, _ = ft_gemm.ft_gemm(a, b, chain=chain, ft=ft, **kw)
            out, rep = ft_gemm.ft_gemm(a, b, chain=chain, ft=ft, inj=inj,
                                       inj_mag=1000.0, **kw)
            cells = rep[rep[..., 0] > 0]
            check(torch.equal(out, clean)
                  and float(rep[..., 0].sum()) == nb
                  and float(rep[..., 1].sum()) == nb
                  and bool((cells[:, 2] == row).all())
                  and bool((cells[:, 3] == col).all())
                  and bool(((cells[:, 4] - 1000.0).abs() < 1e-2).all()),
                  f"{level} {label}: SEU at (row {row}, col {col}, step "
                  f"{step}) in each of {nb} slice(s) corrected bit for bit "
                  f"and located")
            out_d, rep_d = ft_gemm.ft_gemm(a, b, chain=chain,
                                           ft=ft.replace(action="detect"),
                                           inj=inj, inj_mag=1000.0, **kw)
            diff = (out_d != clean).reshape(-1, m, n).nonzero()
            n_det = float(rep_d[..., 0].sum())
            check(diff.shape[0] == nb and bool((diff[:, 1] == row).all())
                  and bool((diff[:, 2] == col).all())
                  and float(rep_d[..., 1].sum()) == 0.0 and n_det >= nb
                  and (level == "tile" or n_det == nb),
                  f"{level} {label}: the same SEU left in place by a "
                  f"detect-only policy ({n_det:.0f} detections"
                  f"{'' if level == 'tile' else ', once'})")
        if label == "decode w_gate+silu":
            _split_band_seus(label, a, b, chain, kw)
    _level_ablation(gen, rows)
    _merge_rows(rows, _level_training_kernels(gen))
    return rows


def _split_band_seus(label, a, b, chain, kw):
    """K1 at decode on split-K (qwen2-7b's w_gate + silu): an SEU in each
    16-row band of block (0, 1) at each level, at k-steps in different
    ranges, corrected bit for bit and located (the rows past M are the
    block's padding rows, carried by the partials when an SEU lands
    there); at tile a campaign at rate 1.0 and an SEU in another band of
    that block at the drawn step, both corrected."""
    m, k, n = a.shape[0], a.shape[1], b.shape[1]
    p = ft_gemm.plan_call(a, b, chain=chain, ft=FT.replace(level="tile"))
    bm, bn, bk = p.tiles
    check(p.splits > 1, f"{label}: split-K at the level ({p.splits} ranges)")
    gk = ft_gemm.cdiv(k, bk)
    for level in LEVELS:
        ft = FT.replace(level=level)
        clean, _ = ft_gemm.ft_gemm(a, b, chain=chain, ft=ft, **kw)
        for band in range(bm // 16):
            row, col = band * 16 + (3 * band + 1) % 16, bn + 7 * band
            step = (band * gk) // (bm // 16)
            out, rep = ft_gemm.ft_gemm(a, b, chain=chain, ft=ft,
                                       inj=(1, -1, row, col, step),
                                       inj_mag=1000.0, **kw)
            cells = rep[rep[..., 0] > 0]
            check(torch.equal(out, clean) and float(rep[..., 0].sum()) == 1.0
                  and float(rep[..., 1].sum()) == 1.0
                  and (int(cells[0, 2]), int(cells[0, 3])) == (row, col),
                  f"{level} {label}: SEU in band {band} (row {row}, col "
                  f"{col}, k-step {step} of {gk} in {p.splits} ranges) "
                  f"corrected bit for bit and located")
    ftc = FT.replace(level="tile", inject_rate=1.0)
    clean, _ = ft_gemm.ft_gemm(a, b, chain=chain, ft=ftc, **kw)
    gm, gn = ft_gemm.cdiv(m, bm), ft_gemm.cdiv(n, bn)
    _, st, r, c = ft_gemm.seu_draws(BAND_TRIPLE, ftc, 1, gm, gn, gk, p.tiles,
                                    False)
    r2 = _next_band(int(r[0, 0, 1]), 16, bm)
    inj = (1, -1, r2, bn + (int(c[0, 0, 1]) + 1) % bn, int(st[0, 0, 1]))
    out, rep = ft_gemm.ft_gemm(a, b, chain=chain, ft=ftc, rng=BAND_TRIPLE,
                               inj=inj, inj_mag=1000.0, **kw)
    _, rep_p = _plain_gemm(a, b, chain=chain, ft=ftc, rng=BAND_TRIPLE,
                           inj=inj, inj_mag=1000.0, **kw)
    check(torch.equal(out, clean) and torch.equal(rep[..., :4], rep_p[..., :4])
          and float(rep[0, 1, 0]) == float(rep[0, 1, 1]) == 2.0,
          f"tile {label}: a campaign at rate 1.0 and an SEU in another band "
          f"of block (0, 1) at the drawn k-step ({inj}), under split-K: both "
          f"corrected, reports as the plain version's")


def _level_ablation(gen, rows):
    """The paper's level ablation like for like on the tensor cores: K1 on
    a bf16 4 096 square at FT off, block, tile and inner, each level's
    overhead over FT off and over torch.matmul (CUDA events)."""
    n = 4096
    a, b = _rand(gen, n, n), _rand(gen, n, n, scale=0.02)
    lib_ms = time_ms(lambda: torch.matmul(a, b), 20)
    off_ms = time_ms(lambda: ft_gemm.ft_gemm(a, b), 20)
    b_ms, b_by = bound(2.0 * n ** 3, 2 * 3 * n * n)
    out = {}
    for level in ("block",) + LEVELS:
        ft = FT.replace(level=level)
        got, rep = ft_gemm.ft_gemm(a, b, ft=ft)
        check(float(rep[..., 0].sum()) == 0.0,
              f"ablation {level}: no detection on the {n} square")
        out[level] = time_ms(lambda: ft_gemm.ft_gemm(a, b, ft=ft), 20)
    for level, ms in out.items():
        print(f"  ablation bf16 {n}^3 {level}: {ms:.4f} ms, "
              f"{(ms / off_ms - 1) * 100:.1f} % over FT off {off_ms:.4f} ms, "
              f"{(ms / lib_ms - 1) * 100:.1f} % over torch.matmul "
              f"{lib_ms:.4f} ms; bound {b_ms:.4f} ms ({b_by})")
    print(json.dumps({"level_ablation": dict(
        n=n, dtype="bfloat16", ft_off_ms=off_ms, library_ms=lib_ms,
        bound_ms=b_ms, **{f"{lv}_ms": ms for lv, ms in out.items()})}))
    for level in LEVELS:
        rows["ft_gemm_level_sm90"]["detail"].append(dict(
            shape=f"ablation {n}x{n}x{n} ({level})", level=level, M=n, N=n,
            K=n, ms=out[level], ft_off_ms=off_ms, block_ms=out["block"],
            plain_ms=None, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by))


def phase_level_check():
    cfg = dataclasses.replace(qwen2_7b.CONFIG, n_layers=2)
    params = transformer.init(cfg, seed=1, dtype=torch.bfloat16)
    prompts, steps = _check_inputs(cfg)
    block, _ = _serve_logits(params, cfg,
                             RunConfig(model=cfg, ft=FT, dtype="bfloat16"),
                             prompts, steps)
    for level in LEVELS:
        run = RunConfig(model=cfg, ft=FT.replace(level=level),
                        dtype="bfloat16")
        got, tot_k = _serve_logits(params, cfg, run, prompts, steps)
        with plain_kernels():
            want, tot_p = _serve_logits(params, cfg, run, prompts, steps)
        _check_logits(f"level_check {level} kernel vs plain", got, want)
        _check_logits(f"level_check {level} vs block", got, block)
        check(tot_k["detected"] == 0 and tot_p["detected"] == 0,
              f"level_check {level}: zero detections (kernels {tot_k}, "
              f"plain {tot_p})")


def phase_level_serve(layers: int):
    cfg, params, prompts = _qwen_serving(layers)
    launches = {n: 0 for n in KERNELS}
    for level in ("block",) + LEVELS:
        run = RunConfig(model=cfg, ft=FT.replace(level=level),
                        dtype="bfloat16")
        got, summary = _serve_run(f"level_serve {level}", params, cfg, run,
                                  prompts, LEVEL_NEW_TOKENS)
        for n in launches:
            launches[n] += got[n]
        print(json.dumps({"level_serve": summary}))
    return launches


def _ladder_bound(n: int):
    """(bound ms, by) of an f32 n x n x n product on the CUDA cores."""
    t_op = 2.0 * n ** 3 / PEAK_F32 * 1e3
    t_by = 3 * 4 * n * n / PEAK_BYTES * 1e3
    return (t_op, "operations") if t_op >= t_by else (t_by, "bytes")


def phase_ladder():
    """The paper's step-wise GEMM ladder and FT-level ablation on the card:
    f32 squares, every rung through its library entry point."""
    print(f"  peaks: f32 on the CUDA cores {PEAK_F32 / 1e12:.0f} TFLOP/s "
          f"(H100 SXM, NVIDIA data sheet; TF32 off), HBM "
          f"{PEAK_BYTES / 1e12:.2f} TB/s; the bf16 bounds of the other "
          f"phases divide by {PEAK_FLOPS / 1e12:.0f} TFLOP/s")

    def ft_rung(pol):
        return lambda a, b: ops.ft_matmul_report(a, b, ft=pol)[0]

    def gemm_rung(tiles):
        return lambda a, b: base_gemm.gemm(a, b, tiles=tiles)

    rungs = [("torch.matmul", torch.matmul), ("K9 naive", base_gemm.naive_gemm)]
    rungs += [(f"K1 FT off {t[0]}x{t[1]}x{t[2]}", gemm_rung(t))
              for t in ft_gemm.TILES]
    rungs += [(f"K1 {lvl} {v}", ft_rung(FT.replace(level=lvl, verify=v)))
              for lvl in ("block", "tile") for v in ("step", "final")]
    rungs += [("K1 inner (verify n/a)", ft_rung(FT.replace(level="inner")))]
    rungs += [("K1 block detect-only", ft_rung(DETECT)),
              ("torch-op non-fused", lambda a, b: ft_verdict_dot(
                  a, b, NONFUSED_BASELINE)[0])]
    gen = torch.Generator(device="cuda").manual_seed(9)
    data = {n: (torch.randn(n, n, generator=gen, device="cuda"),
                torch.randn(n, n, generator=gen, device="cuda"))
            for n in LADDER_SIZES}
    # The main path's run: every rung once at every size, each output held
    # against the library product.
    for kern in KERNELS.values():
        kern["counter"].launches = 0
    for n, (a, b) in data.items():
        ref = torch.matmul(a, b)
        scale = ref.abs().max().item()
        for name, fn in rungs[1:]:
            err = (fn(a, b) - ref).abs().max().item()
            check(err <= F32_TOL * scale, f"ladder {n}: {name} within "
                  f"{err:.3g} <= {F32_TOL:g} x {scale:.3g} of torch.matmul")
    torch.cuda.synchronize()
    launches = {n: k["counter"].launches for n, k in KERNELS.items()}
    n_k1 = sum(name.startswith("K1") for name, _ in rungs)
    expect = {n: 0 for n in KERNELS}
    expect.update(ft_gemm_2d=n_k1 * len(LADDER_SIZES),
                  naive_gemm=len(LADDER_SIZES))
    check(launches == expect, f"ladder launches: K1 {n_k1} and K9 1 per "
          f"size ({launches})")
    # K9 and K1 against their plain versions.
    k9_err = 0.0
    for n in LADDER_SIZES[:2]:
        a, b = data[n]
        k9_err = max(k9_err, _cmp_outputs(
            f"K9 {n}", base_gemm.naive_gemm(a, b),
            base_gemm.naive_gemm_plain(a, b), tol=F32_TOL))
        tiles = ft_gemm.pick_tiles(n)
        for pol in (None, FT, FT.replace(level="tile"),
                    FT.replace(level="inner")):
            out, rep = ft_gemm.ft_gemm(a, b, ft=pol)
            out_p, rep_p = ft_gemm.ft_gemm_plain(a, b, tiles=tiles, ft=pol)
            level = pol.level if pol else "FT off"
            _cmp_outputs(f"K1 {level} {n}", out, out_p, rep, rep_p,
                         tol=F32_TOL)
    # Times: CUDA events around each rung.
    table, k9_rows = [], []
    for n, (a, b) in data.items():
        b_ms, b_by = _ladder_bound(n)
        iters = {1024: 10, 4096: 3}.get(n, 1)
        ms = {}
        for name, fn in rungs:
            ms[name] = time_ms(lambda: fn(a, b), iters, warmup=1)
        plain_ms = time_ms(lambda: base_gemm.naive_gemm_plain(a, b), iters,
                           warmup=1)
        off = ms[rungs[2][0]]
        lib = ms["torch.matmul"]
        for name, _ in rungs:
            t = ms[name]
            row = dict(size=n, rung=name, ms=t,
                       tflops=2.0 * n ** 3 / (t * 1e-3) / 1e12,
                       bound_ms=b_ms, bound_by=b_by,
                       over_ft_off=t / off - 1.0, over_library=t / lib - 1.0)
            table.append(row)
            print(f"  {n:5d} {name:24s} {t:10.3f} ms {row['tflops']:7.2f} "
                  f"TFLOP/s  bound {b_ms:.3f} ms ({b_by})  "
                  f"{100 * row['over_ft_off']:+8.1f} % over K1 FT off  "
                  f"{100 * row['over_library']:+9.1f} % over torch.matmul")
        k9_rows.append(dict(shape=f"{n}x{n}x{n} f32", ms=ms["K9 naive"],
                            plain_ms=plain_ms, library_ms=lib, bound_ms=b_ms,
                            bound_by=b_by))
    # One SEU per launch at k-step 0, mid and last, at 4 096, corrected at
    # each level (integer-valued operands: bit for bit).
    n = 4096
    a = torch.randint(-2, 3, (n, n), generator=gen, device="cuda").float()
    b = torch.randint(-2, 3, (n, n), generator=gen, device="cuda").float()
    ks = n // ft_gemm.pick_tiles(n)[2]
    for level in ("block",) + LEVELS:
        pol = FT.replace(level=level)
        clean, _ = ops.ft_matmul_report(a, b, ft=pol)
        clean_ms = time_ms(lambda: ops.ft_matmul_report(a, b, ft=pol), 3,
                           warmup=1)
        for step in (0, ks // 2, ks - 1):
            spec = InjectionSpec(row=n // 3, col=4 * n // 5, magnitude=1000.0,
                                 k_step=step)
            out, rep = ops.ft_matmul_report(a, b, ft=pol, spec=spec)
            cell = rep[rep[..., 0] > 0]
            check(torch.equal(out, clean) and float(rep[..., 0].sum()) == 1
                  and float(rep[..., 1].sum()) == 1
                  and int(cell[0, 2]) == n // 3
                  and int(cell[0, 3]) == 4 * n // 5,
                  f"ladder {level}: SEU at k-step {step} corrected bit for "
                  f"bit and located")
            seu_ms = time_ms(lambda: ops.ft_matmul_report(a, b, ft=pol,
                                                          spec=spec),
                             3, warmup=1)
            print(f"  {level} SEU at k-step {step}: {seu_ms:.3f} ms against "
                  f"{clean_ms:.3f} ms clean ({seu_ms / clean_ms:.3f}x)")
            table.append(dict(size=n, rung=f"K1 {level} step, SEU at k-step "
                              f"{step}", ms=seu_ms, clean_ms=clean_ms))
    print(json.dumps({"ladder": table}))
    return launches, {"naive_gemm": dict(max_abs_err=k9_err, detail=k9_rows,
                                         headline="4096x4096x4096 f32")}


# ---------------------------------------------------------------------------
# decode_kernels / engine_check / engine
# ---------------------------------------------------------------------------

def _decode_pool(gen, lengths, kvh, dh, page, dtype):
    """Pools of random values (stale contents everywhere, the null page
    included) and a page table whose rows take their pages in order from a
    shuffled pool, so no slot's pages are contiguous."""
    b = len(lengths)
    mp = -(-max(lengths) // page)
    n_pages = 1 + b * mp
    k, v = (torch.randn(n_pages, kvh, page, dh, generator=gen, device="cuda"
                        ).to(dtype) for _ in range(2))
    perm = (torch.randperm(n_pages - 1, generator=gen, device="cuda") + 1
            ).tolist()
    table = torch.zeros(b, mp, dtype=torch.int32)
    for slot, length in enumerate(lengths):
        n = -(-length // page)
        table[slot, :n] = torch.tensor(perm[:n], dtype=torch.int32)
        perm = perm[n:]
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    return k, v, table.cuda(), lens


def _exact_decode_seu():
    """The reference's exact-operand SEU case (tests/test_serve_engine.py):
    one-hot 64·e_t queries and keys, integer V, dh 256, pages of 16, f32:
    the output is exact, so the corrected run equals the clean one bit for
    bit; a detect-only policy leaves the SEU in the output."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    dh, page, kvh, lengths = 256, 16, 2, (272, 320)
    b, mp = len(lengths), 512 // page
    k = torch.zeros(1 + b * mp, kvh, page, dh, device="cuda")
    v = torch.randint(-2, 3, k.shape, generator=gen, device="cuda").float()
    table = (torch.arange(b * mp, device="cuda").view(b, mp) + 1).int()
    for slot, length in enumerate(lengths):
        t = torch.arange(length, device="cuda")
        k[table[slot, t // page].long(), :, t % page, t % dh] = 64.0
    tq = torch.randint(0, dh, (b, kvh * 2), generator=gen, device="cuda")
    q = 64.0 * torch.nn.functional.one_hot(tq, dh).float()
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    spec = InjectionSpec(row=1, col=7, magnitude=777.0, k_step=320 // page - 1)
    g = 1 * kvh + 0
    clean, _ = ops.flash_ft_decode(q, k, v, lens, table, ft=FT)
    fixed, rep = ops.flash_ft_decode(q, k, v, lens, table, ft=FT, spec=spec,
                                     inj_g=g)
    left, rep_d = ops.flash_ft_decode(q, k, v, lens, table, ft=DETECT,
                                      spec=spec, inj_g=g)
    cell = rep[g, 0]
    check(torch.equal(fixed, clean) and float(rep[..., 0].sum()) == 1.0
          and (int(cell[2]), int(cell[3])) == (1, 7)
          and abs(float(cell[4]) - 777.0) < 1.0,
          "K6 exact-operand SEU (dh 256, f32): corrected bit for bit, "
          "located at (row 1, col 7)")
    check(float(rep_d[..., 0].sum()) == 1.0
          and float((left - clean).abs().max()) > 1.0,
          f"K6 exact-operand SEU detect-only: detected, left in the output "
          f"(off by {float((left - clean).abs().max()):.3g})")


def _decode_reports(name, rep_k, rep_p):
    """K6's reports against the plain version's: det / corr / row / col / k
    equal, tau within 1e-5, no detection. (The max residual spans S's
    verifications too, whose tau is far above the last Δ's in field 6, so
    the two are not compared; a length-0 slot's rows stay zero.)"""
    fields = [0, 1, 2, 3, 7]
    check(torch.equal(rep_k[..., fields], rep_p[..., fields]),
          f"{name}: report det / corr / row / col / k fields equal")
    tau_rel = ((rep_k[..., 6] - rep_p[..., 6]).abs()
               / rep_p[..., 6].abs().clamp_min(1e-30)).max().item()
    check(tau_rel <= 1e-5, f"{name}: report tau within 1e-5 ({tau_rel:.2g})")
    check(float(rep_k[..., 0].sum()) == 0.0, f"{name}: clean run, no "
          f"detection")


def phase_decode_kernels():
    gen = torch.Generator(device="cuda").manual_seed(4)
    cfg = qwen2_7b.CONFIG
    kvh, h, dh = cfg.n_kv_heads, cfg.n_heads, cfg.head_dim
    n_rep, page = h // kvh, kv_cache.DEFAULT_PAGE
    lengths = DECODE_LENGTHS
    b = len(lengths)
    k, v, table, lens = _decode_pool(gen, lengths, kvh, dh, page,
                                     torch.bfloat16)
    q = _rand(gen, b, h, dh)
    sub = flashft.sublane(q.dtype)
    bq = -(-n_rep // sub) * sub
    qg = torch.nn.functional.pad(q.view(b * kvh, n_rep, dh),
                                 (0, 0, 0, bq - n_rep))
    kw = dict(ft=FT, scale=dh ** -0.5, tau_dh=dh)
    p = flashft.plan_decode(qg, k, v, table)
    check(p.instance == "sm90"
          and p.ranges == flashft.decode_ranges(b * kvh, table.shape[1]),
          f"K6: the tensor-core instance, each row's pages in {p.ranges} "
          f"ranges ({p})")
    names = ("flash_decode_sm90", "flash_decode_combine", "flash_decode")
    before = {n: KERNELS[n]["counter"].launches for n in names}
    out, rep = flashft.flash_ft_decode(qg, k, v, lens, table, **kw)
    torch.cuda.synchronize()
    got = {n: KERNELS[n]["counter"].launches - before[n] for n in names}
    check(got == {"flash_decode_sm90": 1, "flash_decode_combine": 1,
                  "flash_decode": 0}, f"K6: launches {got}")
    out_p, rep_p = flashft.planned_decode_plain(qg, k, v, lens, table, **kw)
    err = _cmp_outputs("K6 paged decode (split)", out[:, :n_rep],
                       out_p[:, :n_rep])
    _decode_reports("K6 paged decode (split)", rep, rep_p)
    out_u, rep_u = flashft.flash_decode_plain(qg, k, v, lens, table, **kw)
    fields = [0, 1, 2, 3, 7]
    check(torch.equal(rep[..., fields], rep_u[..., fields]),
          "K6: the split report equals the unsplit walk's in det, corr, row, "
          "col and k")
    _cmp_outputs("K6 split vs the unsplit walk", out[:, :n_rep],
                 out_u[:, :n_rep])
    check(not out[:kvh].any() and not rep[:kvh].any(),
          "K6: the length-0 slot writes exact zeros and a zero report")
    out_s, rep_s = flashft.flash_ft_decode(qg, k, v, lens, table, simt=True,
                                           **kw)
    simt_err = _cmp_outputs("K6 SIMT (pinned) vs the unsplit walk",
                            out_s[:, :n_rep], out_u[:, :n_rep])
    _decode_reports("K6 SIMT (pinned) vs the unsplit walk", rep_s, rep_u)
    # SEUs in slot 6 (777 tokens), kv head 2, page 5, at row 3: one in Δ
    # through the ops front, one in S through the wrapper; each with a
    # detect-only control.
    slot, head = 6, 2
    g = slot * kvh + head
    spec = InjectionSpec(row=3, col=100, magnitude=64.0, k_step=5)
    clean, _ = ops.flash_ft_decode(q, k, v, lens, table, ft=FT)
    fixed, rep_f = ops.flash_ft_decode(q, k, v, lens, table, ft=FT,
                                       spec=spec, inj_g=g)
    left, rep_d = ops.flash_ft_decode(q, k, v, lens, table, ft=DETECT,
                                      spec=spec, inj_g=g)
    cell = rep_f[g, 0]
    check(float(rep_f[..., 0].sum()) == 1.0 and float(rep_f[..., 1].sum())
          == 1.0 and (int(cell[2]), int(cell[3])) == (3, 100)
          and abs(float(cell[4]) - 64.0) < 0.5,
          "K6 SEU in Δ (slot 6, kv head 2, page 5): detected, corrected, "
          "located at (row 3, col 100)")
    check(float(rep_d[..., 0].sum()) == 1.0 and float(rep_d[..., 1].sum())
          == 0.0, "K6 SEU in Δ detect-only: detected, not corrected")
    at = (slot, head * n_rep + 3, 100)
    print(f"  K6 SEU: corrected element {fixed[at].item()!r}, clean "
          f"{clean[at].item()!r} (whole outputs equal: "
          f"{torch.equal(fixed, clean)}), detect-only {left[at].item()!r}")
    check(torch.equal(fixed[at], clean[at]),
          "K6 SEU in Δ: the corrected element equals the clean one")
    _seu_at("K6 Δ", fixed, left, clean, at)
    inj = (flashft.INJ_S, g, 0, 5, 3, 20)
    clean_g, _ = flashft.flash_ft_decode(qg, k, v, lens, table, **kw)
    fixed, rep_f = flashft.flash_ft_decode(qg, k, v, lens, table, inj=inj,
                                           inj_mag=64.0, **kw)
    left, rep_d = flashft.flash_ft_decode(qg, k, v, lens, table, inj=inj,
                                          inj_mag=64.0, **dict(kw, ft=DETECT))
    cell = rep_f[g, 0]
    check(float(rep_f[..., 0].sum()) == 1.0 and float(rep_f[..., 1].sum())
          == 1.0 and (int(cell[2]), int(cell[3])) == (3, 5 * page + 20)
          and abs(float(cell[4]) - 64.0) < 0.5,
          f"K6 SEU in S (slot 6, kv head 2, page 5): detected, corrected, "
          f"located at (row 3, col {5 * page + 20})")
    check(float(rep_d[..., 0].sum()) == 1.0 and float(rep_d[..., 1].sum())
          == 0.0, "K6 SEU in S detect-only: detected, not corrected")
    moved = (left.float() - clean_g.float()).abs()
    idx = tuple(int(t) for t in torch.unravel_index(moved.argmax(),
                                                    moved.shape))
    _seu_at("K6 S", fixed, left, clean_g, idx)
    _exact_decode_seu()
    # The combine alone, from one launch's workspace.
    stream = torch.cuda.current_stream().cuda_stream
    n_g = b * kvh
    ws = torch.empty(p.ranges * n_g * flashft.DECODE_PARTIAL, device="cuda")
    args = (qg.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(),
            table.data_ptr(), ws.data_ptr(), p.ranges, b, kvh, bq, dh, page,
            table.shape[1], k.shape[0], 1, int(FT.corrects), dh ** -0.5,
            FT.rel_tau * flashft.F32EPS * dh, FT.rel_tau * flashft.F32EPS,
            0, 0, 0, 0, 0, 0, 0.0, *ft_gemm.seu_args(None, FT, 0), stream)
    flashft.FLASH_DECODE_SM90(*args)
    out_c, rep_c = torch.empty_like(qg), torch.empty_like(rep)

    def combine():
        flashft.FLASH_DECODE_COMBINE(ws.data_ptr(), out_c.data_ptr(),
                                     rep_c.data_ptr(), n_g, p.ranges, stream)

    combine()
    out_cp, rep_cp = flashft.combine_ws_plain(ws, n_g, p.ranges)
    c_err = _cmp_outputs("K6 combine vs its plain version", out_c, out_cp)
    check(torch.equal(rep_c, rep_cp) and torch.equal(out_c, out)
          and torch.equal(rep_c, rep),
          "K6 combine: reports equal to its plain version's, output and "
          "report equal to the whole call's")
    # Times at the main path's shape; SDPA over the dense (B, H, S, dh) cache
    # gathered beforehand (the gather is not timed), with the length mask.
    call_ms = time_ms(lambda: flashft.flash_ft_decode(qg, k, v, lens, table,
                                                      **kw), 50)
    ms = time_ms(lambda: flashft.FLASH_DECODE_SM90(*args), 50)
    comb_ms = time_ms(combine, 50)
    simt_ms = time_ms(lambda: flashft.flash_ft_decode(
        qg, k, v, lens, table, simt=True, **kw), 20)
    plain_ms = time_ms(lambda: flashft.planned_decode_plain(
        qg, k, v, lens, table, **kw), 3)
    plain_u = time_ms(lambda: flashft.flash_decode_plain(
        qg, k, v, lens, table, **kw), 3)
    comb_plain = time_ms(lambda: flashft.combine_ws_plain(ws, n_g, p.ranges),
                         3)
    s_max = table.shape[1] * page
    kd, vd = (kv_cache.gather_layer(x, table).permute(0, 2, 1, 3)
              .repeat_interleave(n_rep, dim=1) for x in (k, v))
    mask = (torch.arange(s_max, device="cuda")[None, :] < lens[:, None]
            )[:, None, None, :]
    q4 = q[:, :, None, :]
    lib_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q4, kd, vd, attn_mask=mask), 50)
    live_pages = sum(-(-n // page) for n in lengths)
    nbytes = (2 * b * h * dh                        # q
              + 2 * 2 * live_pages * kvh * page * dh  # live pages of K and V
              + 2 * b * h * dh                      # out
              + 4 * (b + table.numel()))            # lengths, table
    b_ms, b_by = bound(4.0 * dh * h * sum(lengths), nbytes)
    # The combine reads the partials of the ranges that hold pages (acc,
    # m, l, report) and the (m, l, report) of the empty ones, and writes
    # out (16 rows a kv head) and the report.
    full = sum(min(p.ranges, -(-n // page)) for n in lengths) * kvh
    c_bytes = (full * 4 * flashft.DECODE_PARTIAL
               + (p.ranges * n_g - full) * 4 * (2 * bq + 8)
               + n_g * (2 * bq * dh + 32))
    cb_ms, cb_by = bound(3.0 * full * bq * dh, c_bytes)
    shape = (f"{b} slots x {h} / {kvh} heads, dh {dh}, pages of {page}, "
             f"lengths {list(lengths)}")
    print(f"  K6 paged decode ({shape}, {p.ranges} ranges): the call "
          f"{call_ms:.4f} ms (kernel {ms:.4f}, combine {comb_ms:.4f}), SIMT "
          f"{simt_ms:.4f} ms ({simt_ms / call_ms:.1f}x), plain "
          f"{plain_ms:.2f} ms (unsplit {plain_u:.2f}), SDPA over the "
          f"gathered cache {lib_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by}); "
          f"combine bound {cb_ms:.5f} ms ({cb_by}), plain "
          f"{comb_plain:.3f} ms")
    lib = "SDPA over the gathered dense cache, length mask, gather not timed"
    return {
        "flash_decode_sm90": dict(max_abs_err=err, detail=[dict(
            shape=shape, ranges=p.ranges, ms=ms, call_ms=call_ms,
            simt_ms=simt_ms, plain_ms=plain_ms, library_ms=lib_ms,
            library=lib, bound_ms=b_ms, bound_by=b_by)]),
        "flash_decode_combine": dict(max_abs_err=c_err, detail=[dict(
            shape=f"{shape}, {p.ranges} ranges", ms=comb_ms,
            plain_ms=comb_plain, library_ms=None, bound_ms=cb_ms,
            bound_by=cb_by)]),
        "flash_decode": dict(max_abs_err=simt_err, detail=[dict(
            shape=shape, ms=simt_ms, plain_ms=plain_u, library_ms=lib_ms,
            library=lib, bound_ms=b_ms, bound_by=b_by)]),
    }


class ProbeEngine(engine.ServeEngine):
    """The engine, recording per request the top-2 logit gap of every
    sampled token and, per call, the host time of each prefill (admission,
    scatter and first sample) and of each decode step (from the end of
    admission to the end of the step's sample, which synchronises)."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.gaps = collections.defaultdict(list)
        self.prefill_ms, self.decode_ms = [], []
        self.live_per_step = []
        self._next_rid, self._admitting = 0, False
        self._t = time.perf_counter()

    def _admit(self):
        self._admitting = True
        self._t = time.perf_counter()
        try:
            super()._admit()
        finally:
            self._admitting = False

    def _sample(self, logits):
        top2 = torch.topk(logits.float(), 2, dim=-1).values
        tok = super()._sample(logits)
        now = time.perf_counter()
        gap = (top2[:, 0] - top2[:, 1]).tolist()
        top = top2[:, 0].abs().tolist()
        if self._admitting:        # FIFO admission: rids come in order
            self.gaps[self._next_rid].append((gap[0], top[0]))
            self._next_rid += 1
            self.prefill_ms.append((now - self._t) * 1e3)
        else:
            for s, req in enumerate(self.slot_req):
                if req is not None:
                    self.gaps[req.rid].append((gap[s], top[s]))
            self.decode_ms.append((now - self._t) * 1e3)
            self.live_per_step.append(sum(r is not None
                                          for r in self.slot_req))
        self._t = now
        return tok


def _prompts(rng, n, lo, hi, budget_lo, budget_hi, vocab):
    lens = rng.integers(lo, hi + 1, n)
    budgets = rng.integers(budget_lo, budget_hi + 1, n)
    return [rng.integers(0, vocab, int(m)) for m in lens], \
        [int(x) for x in budgets]


def phase_engine_check():
    cfg = dataclasses.replace(qwen2_7b.CONFIG, n_layers=2)
    run = RunConfig(model=cfg, ft=FT, dtype="bfloat16")
    params = transformer.init(cfg, seed=3, dtype=torch.bfloat16)
    ctx = Ctx(ft=FT, dtype=torch.bfloat16)
    rng = torch.Generator().manual_seed(3)
    # ---- one paged step against one dense step ---------------------------
    lengths = [37, 64, 0, 129]
    b, page, max_len = len(lengths), kv_cache.DEFAULT_PAGE, 256
    plan = kv_cache.plan_pages(n_slots=b, max_len=max_len)
    alloc = kv_cache.PageAllocator(plan.n_pages, b, plan.max_pages, page)
    paged = kv_cache.init_paged_cache(cfg.n_layers, plan.n_pages, b,
                                      plan.max_pages, cfg.n_kv_heads, page,
                                      cfg.head_dim)
    dense = transformer.init_cache(cfg, b, max_len)
    with torch.inference_mode():
        for length in lengths:
            slot, _ = alloc.alloc_slot(length)
            if length == 0:
                continue
            toks = torch.randint(0, cfg.vocab_size, (1, length),
                                 generator=rng).cuda()
            c1 = transformer.init_cache(cfg, 1, length)
            _, c1 = transformer.prefill(params, toks, c1, cfg, ctx)
            kv_cache.write_prefill(paged, slot,
                                   torch.as_tensor(alloc.page_table[slot]),
                                   c1["k"][:, 0], c1["v"][:, 0], length)
            dense["k"][:, slot, :length] = c1["k"][:, 0]
            dense["v"][:, slot, :length] = c1["v"][:, 0]
        for slot, length in enumerate(lengths):
            alloc.ensure(slot, length + 1)
        paged["page_table"], _ = alloc.snapshot("cuda")
        paged["length"] = torch.tensor(lengths, dtype=torch.int32,
                                       device="cuda")
        dense["length"] = paged["length"].clone()
        tok = torch.randint(0, cfg.vocab_size, (b, 1), generator=rng).cuda()
        for k in KERNELS.values():
            k["counter"].launches = 0
        lp, paged = transformer.paged_decode_step(params, tok, paged, cfg, ctx)
        k6 = (flashft.FLASH_DECODE_SM90.launches,
              flashft.FLASH_DECODE.launches)
        ld, dense = transformer.decode_step(params, tok, dense, cfg, ctx)
    lp, ld = lp.float().reshape(b, -1), ld.float().reshape(b, -1)
    err, scale = (lp - ld).abs().max().item(), ld.abs().max().item()
    check(bool(torch.isfinite(lp).all()) and err <= 2e-2 * scale,
          f"engine_check: paged vs dense decode step logits {err:.3g} <= "
          f"2e-2 x {scale:.3g} (slot lengths {lengths})")
    check(k6 == (cfg.n_layers, 0), f"engine_check: the paged step launched "
          f"K6 once per layer, on the tensor cores ({k6})")
    pk, pv = kv_cache.gather_dense(paged)
    same, worst = True, 0.0
    for slot, length in enumerate(lengths):
        for got, want in ((pk, dense["k"]), (pv, dense["v"])):
            same &= (torch.equal(got[:, slot, :length], want[:, slot, :length])
                     and torch.equal(got[0, slot, length],
                                     want[0, slot, length]))
            new = got[1:, slot, length].float()
            ref = want[1:, slot, length].float()
            worst = max(worst, ((new - ref).abs().max()
                                / ref.abs().max().clamp_min(1e-30)).item())
    check(same, "engine_check: after the step every slot's prompt and layer "
          "0's new token are cached bit for bit as in the dense cache")
    check(worst <= 2e-2, f"engine_check: layer 1's new token within 2e-2 of "
          f"max|kv| of the dense one ({worst:.3g}; its input carries the two "
          f"attention paths' difference)")
    # ---- the engine against one single-slot engine per request -----------
    prng = np.random.default_rng(3)
    prompts, budgets = _prompts(prng, 6, 5, 120, 3, 12, cfg.vocab_size)
    ec = dict(max_len=256, n_slots=3)
    eng = ProbeEngine(params, cfg, run, engine.EngineConfig(**ec))
    for p_, m in zip(prompts, budgets):
        eng.submit(p_, max_new_tokens=m)
    for k in KERNELS.values():
        k["counter"].launches = 0
    with telemetry.ft_scope() as scope:
        res = eng.run()
        sites = scope.site_totals()
    k6 = (flashft.FLASH_DECODE_SM90.launches, flashft.FLASH_DECODE.launches)
    steps = len(eng.decode_ms)
    solo = []
    for p_, m in zip(prompts, budgets):
        one = ProbeEngine(params, cfg, run,
                          engine.EngineConfig(max_len=256, n_slots=1))
        one.submit(p_, max_new_tokens=m)
        solo.append((one.run()[0], one.gaps[0]))
    for r, (s_, s_gaps) in zip(res, solo):
        if r.tokens == s_.tokens:
            continue
        t = next(i for i, (x, y) in enumerate(zip(r.tokens, s_.tokens))
                 if x != y)
        (ga, ta), (gb, tb) = eng.gaps[r.rid][t], s_gaps[t]
        tie = min(ga, gb) <= BF16_TOL * max(ta, tb)
        print(f"  request {r.rid}: engine and solo differ at token {t} "
              f"({r.tokens[t]} vs {s_.tokens[t]}); top-2 logit gaps {ga:.4g} "
              f"(engine) and {gb:.4g} (solo) at |top| {max(ta, tb):.4g}")
        check(tie, f"engine_check: request {r.rid}'s first difference is a "
              f"bf16 tie (gap <= {BF16_TOL:.4f} x |top|)")
    same = sum(r.tokens == s_.tokens for r, (s_, _) in zip(res, solo))
    print(f"  {same} of {len(res)} requests give their solo tokens exactly")
    check([len(r.tokens) for r in res] == budgets,
          f"engine_check: every request met its budget {budgets}")
    eng.alloc.check_invariants()
    check(eng.alloc.n_free == eng.plan.n_pages - 1,
          f"engine_check: all {eng.plan.n_pages - 1} pages came back")
    dec = sites.get("dec_flash")
    check(dec is not None and all(t["detected"] == 0 for t in sites.values()),
          f"engine_check: 'dec_flash' in the scope's site totals, no "
          f"detection ({dec})")
    check(k6 == (cfg.n_layers * steps, 0), f"engine_check: K6 launches "
          f"{k6} = {cfg.n_layers} x {steps} decode steps, all on the tensor "
          f"cores")


def phase_engine(seed: int, smi: str):
    cfg = qwen2_7b.CONFIG
    run = RunConfig(model=cfg, ft=FT, dtype="bfloat16")
    t0 = time.perf_counter()
    params = transformer.init(cfg, seed=0, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    print(f"  init: {sum(p.numel() for p in params.parameters()) / 1e9:.2f} B "
          f"parameters in {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(seed)
    prompts, budgets = _prompts(rng, ENGINE_REQUESTS, 16, 512, 8, 32,
                                cfg.vocab_size)
    ec = engine.EngineConfig(max_len=ENGINE_MAX_LEN, n_slots=ENGINE_SLOTS)

    def serve_all(guard=None):
        eng = ProbeEngine(params, cfg, run, ec)
        for p_, m in zip(prompts, budgets):
            eng.submit(p_, max_new_tokens=m)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with telemetry.ft_scope() as scope:
            if guard is None:
                res = eng.run()
            else:
                with guard:
                    res = eng.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            totals = scope.totals()
        return eng, res, wall, totals

    torch.cuda.reset_peak_memory_stats()
    for k in KERNELS.values():
        k["counter"].launches = 0
    guard = LibraryCallGuard()
    eng_g, res_g, wall_g, tot_g = serve_all(guard)
    launches = {n: k["counter"].launches for n, k in KERNELS.items()}
    steps = len(eng_g.decode_ms)
    eng, res, wall, totals = serve_all()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    pool = sum(eng.cache[n].nbytes for n in ("k_pages", "v_pages"))
    n_tok = sum(len(r.tokens) for r in res)
    dec_ms, pre_ms = (statistics.median(eng.decode_ms),
                      statistics.median(eng.prefill_ms))
    ttft = [r.ttft_s * 1e3 for r in res]
    print(f"  {ENGINE_REQUESTS} requests, prompts {[len(p_) for p_ in prompts]}"
          f", budgets {budgets}")
    print(f"  guarded run {wall_g:.2f} s; launches {launches}; {steps} decode "
          f"steps; FT totals {tot_g}")
    print(f"  timed run {wall:.2f} s: {n_tok} tokens, {n_tok / wall:.2f} "
          f"generated tokens/s; decode {dec_ms:.1f} ms per step (median of "
          f"{len(eng.decode_ms)}: min {min(eng.decode_ms):.1f}, max "
          f"{max(eng.decode_ms):.1f}); prefill {pre_ms:.1f} ms per request "
          f"(median; min {min(eng.prefill_ms):.1f}, max "
          f"{max(eng.prefill_ms):.1f}); TTFT median "
          f"{statistics.median(ttft):.0f} ms, max {max(ttft):.0f} ms")
    print(f"  peak memory {peak:.2f} GiB; pool {pool / 1e9:.3f} GB "
          f"({eng.plan.n_pages} pages of {eng.plan.page_size}); free pages at "
          f"the end {eng.alloc.n_free}")
    check([r.tokens for r in res] == [r.tokens for r in res_g],
          "engine: the timed run repeats the guarded run's greedy tokens")
    check([len(r.tokens) for r in res] == budgets
          and all(0 <= t < cfg.vocab_size for r in res for t in r.tokens),
          "engine: every request met its budget with in-vocabulary tokens")
    eng.alloc.check_invariants()
    check(eng.alloc.n_free == eng.plan.n_pages - 1 == eng_g.alloc.n_free,
          f"engine: all {eng.plan.n_pages - 1} pages came back")
    check(tot_g["detected"] == 0 and totals["detected"] == 0,
          "engine: zero detections")
    check(not guard.hits, f"engine: no library matmul / attention op "
          f"dispatched ({sorted(set(guard.hits))})")
    per = cfg.n_layers * 7 + 1
    expect = {**k1_launches(per * (ENGINE_REQUESTS + steps)),
              **k5_launches(0),
              **k2_launches(cfg.n_layers * ENGINE_REQUESTS), **NO_FLASH_BWD,
              **k6_launches(cfg.n_layers * steps),
              **OFF_PATH}
    check(launches == expect,
          f"engine: launches K1 {per} per prefill and per decode step, K2 "
          f"{cfg.n_layers} per prefill, K6 and its combine {cfg.n_layers} "
          f"per decode step (K2 and K6 on the tensor cores), K5 none")
    # Where a decode step's time goes: one decode step with every slot live
    # under torch.profiler, on K6's tensor-core instance and again with its
    # SIMT kernel pinned (K6 before the redesign).
    prof = {}
    for name, pin in (("tensor cores", contextlib.nullcontext()),
                      ("SIMT K6", simt_decode())):
        with pin:
            eng_p = ProbeEngine(params, cfg, run, ec)
            for p_, m in zip(prompts[:ENGINE_SLOTS], budgets[:ENGINE_SLOTS]):
                eng_p.submit(p_, max_new_tokens=m)
            eng_p.step()                 # the admissions and a decode step
            check(sum(r is not None for r in eng_p.slot_req) == ENGINE_SLOTS,
                  f"engine profile ({name}): every slot live")
            prof[name] = device_profile(eng_p.step)
            del eng_p
        print(f"  profiled decode step ({name}): {prof[name]}")
    print(json.dumps({"engine": dict(
        arch=cfg.arch_id, layers=cfg.n_layers, slots=ENGINE_SLOTS,
        requests=ENGINE_REQUESTS, max_len=ENGINE_MAX_LEN,
        page=eng.plan.page_size, seed=seed,
        prompt_lens=[len(p_) for p_ in prompts], budgets=budgets,
        decode_steps=steps, run_s=wall, guarded_run_s=wall_g,
        generated_tokens=n_tok, tokens_per_s=n_tok / wall,
        decode_ms_median=dec_ms, decode_ms=eng.decode_ms,
        prefill_ms_median=pre_ms, prefill_ms=eng.prefill_ms,
        ttft_ms_median=statistics.median(ttft), ttft_ms_max=max(ttft),
        peak_gib=peak, pool_bytes=pool, free_pages=eng.alloc.n_free,
        launches=launches, profile=prof, card=smi)}))
    return launches


# ---------------------------------------------------------------------------
# train_kernels
# ---------------------------------------------------------------------------

def _bf16_close(got, want):
    err = (got.float() - want.float()).abs().max().item()
    return err, err <= BF16_TOL * want.float().abs().max().item()


def _seu_at(name, fixed, left, clean, idx):
    """The SEU's element: the corrected run within one bf16 ulp of the clean
    one, and the detect-only run (same injection) well outside that."""
    c = clean[idx].float().item()
    tol = BF16_TOL * max(abs(c), 1.0)
    fe = abs(fixed[idx].float().item() - c)
    le = abs(left[idx].float().item() - c)
    check(fe <= tol and le >= 4 * tol,
          f"{name} SEU at {idx}: corrected off by {fe:.3g} <= {tol:.3g}, "
          f"detect-only off by {le:.3g}")


def _flash_bwd_bounds(bh, g, s, dh, causal):
    """(bound_ms, bound_by) of K3 and K4: 3 and 4 GEMMs of 2·dh per live
    (query, key) pair; bytes = q, k, v, g and the f32 statistics read once,
    the gradients written once (bf16 operands)."""
    pairs = s * (s + 1) // 2 if causal else s * s
    io = 2 * dh * s * (2 * bh + 2 * g)          # q, g, k, v
    stats = 4 * 3 * bh * s                      # m, l, di
    dq = bound(3 * 2.0 * dh * pairs * bh, io + stats + 2 * dh * s * bh)
    dkv = bound(4 * 2.0 * dh * pairs * bh, io + stats + 2 * 2 * dh * s * g)
    return dq, dkv


def _flash_fwd_kernels(gen, label, n_heads, n_kv, batch, s, save_stats,
                       dh=128, causal=True, skv=None):
    """K2 at one attention shape (batch x s query tokens over ``skv`` keys,
    s by default, n_heads / n_kv heads, head dim ``dh``, causal or not,
    bf16): the plan (the tensor-core instance, one launch and none of the
    SIMT one); the kernel against its plain version (outputs within
    BF16_TOL; with ``save_stats`` m and l within 1e-3; reports det / corr /
    row / col / k equal, tau within 1e-5, no detection); the SIMT instance
    (pinned blocks) against the same plain version; on integer operands an
    SEU in S and one in Δ, each corrected, located and left by a detect-
    only policy; CUDA-event times of both instances, the plain version,
    one SDPA forward and, at dh 64, the same call zero-padded to dh 128
    (the reference's width) on the dh-128 instance, each also as a device
    time (`queued_ms`: a short call's CUDA-event time is the host's launch
    time); the bound. Returns the rows of flash_ft_sm90 and flash_ft."""
    skv = s if skv is None else skv
    blk = flashft.BLOCK
    bh, gk = batch * n_heads, batch * n_kv
    n_rep, nqb = bh // gk, -(-s // blk)
    shape = (f"{label}, {bh} heads / {gk} kv heads, "
             f"{f'S {s}' if skv == s else f'Sq {s}, Skv {skv}'}, dh {dh}, "
             f"{'causal' if causal else 'non-causal'}")
    fkw = dict(ft=FT, scale=dh ** -0.5, tau_dh=128, n_rep=n_rep,
               causal=causal, save_stats=save_stats)
    q, k, v = _rand(gen, bh, s, dh), _rand(gen, gk, skv, dh), \
        _rand(gen, gk, skv, dh)
    p = flashft.plan_fwd(q, k, v)
    check(p.instance == "sm90", f"K2 {label}: the tensor-core instance ({p})")
    names = ("flash_ft_sm90", "flash_ft")
    before = {n: KERNELS[n]["counter"].launches for n in names}
    res = flashft.flash_ft_fwd(q, k, v, **fkw)
    torch.cuda.synchronize()
    got = {n: KERNELS[n]["counter"].launches - before[n] for n in names}
    check(got == {"flash_ft_sm90": 1, "flash_ft": 0},
          f"K2 {label}: launches {got}")
    res_p = flashft.flash_ft_plain(q, k, v, **fkw)
    err = _cmp_outputs(f"K2 {label} out", res[0], res_p[0], res[-1],
                       res_p[-1])
    if save_stats:
        st = max((res[1] - res_p[1]).abs().max().item(),
                 (res[2] - res_p[2]).abs().max().item()
                 / res_p[2].abs().max().item())
        check(st <= 1e-3, f"K2 {label} stats: m and l (l relative) within "
              f"1e-3 of plain ({st:.3g})")
    pin = dict(fkw, bq=blk, bkv=blk)
    res_s = flashft.flash_ft_fwd(q, k, v, **pin)
    simt_err = _cmp_outputs(f"K2 SIMT {label} out", res_s[0], res_p[0],
                            res_s[-1], res_p[-1])
    # SEUs on integer-valued q, k, v: in S and in Δ of the last query
    # head's last q block at kv step 1 (0 when that block has one), at a
    # live (row, col).
    ints = (_ints(gen, bh, s, dh), _ints(gen, gk, skv, dh),
            _ints(gen, gk, skv, dh))
    clean = flashft.flash_ft_fwd(*ints, **fkw)
    qb, row = nqb - 1, min(63, s - 1 - (nqb - 1) * blk)
    last = qb * blk + row + skv - s if causal else skv - 1  # its last key
    step = min(1, last // blk)
    s_col = min(40, last - step * blk)
    for target, col in ((flashft.INJ_S, s_col),
                        (flashft.INJ_DELTA, min(99, dh - 5))):
        inj = (target, bh - 1, qb, step, row, col)
        what = "S" if target == flashft.INJ_S else "Δ"
        fixed = flashft.flash_ft_fwd(*ints, inj=inj, inj_mag=300.0, **fkw)
        left = flashft.flash_ft_fwd(*ints, inj=inj, inj_mag=300.0,
                                    **dict(fkw, ft=DETECT))
        rep, rep_d, cell = fixed[-1], left[-1], fixed[-1][bh - 1, qb]
        at = (qb * blk + row, step * blk + col if what == "S" else col)
        check(float(rep[..., 0].sum()) == 1.0 and float(rep[..., 1].sum())
              == 1.0 and (int(cell[2]), int(cell[3])) == at
              and abs(float(cell[4]) - 300.0) < 1.0,
              f"K2 {label}: SEU in {what} corrected, located at {at}")
        _cmp_outputs(f"K2 {label} SEU in {what}: corrected out vs clean",
                     fixed[0], clean[0])
        if save_stats:
            check(torch.allclose(fixed[1], clean[1], rtol=1e-5, atol=1e-5)
                  and torch.allclose(fixed[2], clean[2], rtol=1e-3,
                                     atol=1e-3),
                  f"K2 {label} SEU in {what}: m, l as clean")
        check(float(rep_d[..., 0].sum()) == 1.0
              and float(rep_d[..., 1].sum()) == 0.0,
              f"K2 {label}: SEU in {what} detect-only counted once")
        moved = (left[0].float() - clean[0].float()).abs()
        idx = tuple(int(t) for t in torch.unravel_index(moved.argmax(),
                                                        moved.shape))
        _seu_at(f"K2 {label} {what}", fixed[0], left[0], clean[0], idx)
    ms = time_ms(lambda: flashft.flash_ft_fwd(q, k, v, **fkw), 20)
    simt_ms = time_ms(lambda: flashft.flash_ft_fwd(q, k, v, **pin), 5,
                      warmup=1)
    plain_ms = time_ms(lambda: flashft.flash_ft_plain(q, k, v, **fkw), 1,
                       warmup=0)
    calls = {"kernel": lambda: flashft.flash_ft_fwd(q, k, v, **fkw),
             "SIMT": lambda: flashft.flash_ft_fwd(q, k, v, **pin)}
    pad_ms = None
    if dh < 128:
        padded = [torch.nn.functional.pad(x, (0, 128 - dh)).contiguous()
                  for x in (q, k, v)]
        calls["padded"] = lambda: flashft.flash_ft_fwd(*padded, **fkw)
        pad_ms = time_ms(calls["padded"], 20)
    q4 = q.view(batch, n_heads, s, dh)
    k4, v4 = (x.view(batch, n_kv, skv, dh).repeat_interleave(n_rep, dim=1)
              for x in (k, v))
    calls["SDPA"] = lambda: torch.nn.functional.scaled_dot_product_attention(
        q4, k4, v4, is_causal=causal)
    lib_ms = time_ms(calls["SDPA"], 20)
    device = {n: queued_ms(fn, iters=5 if n == "SIMT" else 30)
              for n, fn in calls.items()}
    # live (query, key) pairs: bottom-right-aligned causal, else all
    pairs = (s * (skv - s) + s * (s + 1) // 2) if causal else s * skv
    b_ms, b_by = bound(4.0 * dh * pairs * bh,
                       2 * dh * (2 * s * bh + 2 * skv * gk)
                       + (2 * 4 * bh * s if save_stats else 0))
    print(f"  K2 {shape}{' with stats' if save_stats else ''}: kernel "
          f"{ms:.4f} ms, SIMT {simt_ms:.4f} ms ({simt_ms / ms:.1f}x), "
          + (f"padded to dh 128 {pad_ms:.4f} ms, " if pad_ms else "")
          + f"plain {plain_ms:.2f} ms, SDPA forward {lib_ms:.4f} ms, bound "
          f"{b_ms:.5f} ms ({b_by}); device ms (queued): "
          + ", ".join(f"{n} {x:.4f}" for n, x in device.items()))
    lib = "SDPA forward" + (", KV repeated" if n_rep > 1 else "")
    row = dict(shape=shape, ms=ms, simt_ms=simt_ms, plain_ms=plain_ms,
               library_ms=lib_ms, library=lib, bound_ms=b_ms, bound_by=b_by,
               device_ms=device)
    if pad_ms is not None:
        row["padded_dh128_ms"] = pad_ms
    return {
        "flash_ft_sm90": dict(max_abs_err=err, detail=[row]),
        "flash_ft": dict(max_abs_err=simt_err, detail=[dict(
            shape=shape, ms=simt_ms, plain_ms=plain_ms, library_ms=lib_ms,
            library=lib, bound_ms=b_ms, bound_by=b_by)]),
    }


def phase_train_kernels():
    gen = torch.Generator(device="cuda").manual_seed(2)
    cfg = phi4_mini_38b.CONFIG
    d, dff, v = cfg.d_model, cfg.d_ff, cfg.padded_vocab()
    qd, kvd = cfg.qkv_dims
    t = TRAIN_BATCH * TRAIN_SEQ
    rows = {}

    # ---- K1: act_grad and the backward GEMMs on transposed views --------
    x, h = _rand(gen, t, d), _rand(gen, t, dff)
    w = {"wq": _rand(gen, d, qd, scale=0.02),
         "w_gate": _rand(gen, d, dff, scale=0.02),
         "w_down": _rand(gen, dff, d, scale=0.02),
         "lm_head": _rand(gen, d, v, scale=0.02)}
    g = {n: _rand(gen, t, w[n].shape[1], scale=1e-3) for n in w}
    cases = [  # (label, a, b, chain, act_grad)
        ("fwd w_gate+silu act_grad", x, w["w_gate"], ("silu",), True),
        ("dx wq = g·wqT", g["wq"], w["wq"].t(), (), False),
        ("dw wq = xT·g", x.t(), g["wq"], (), False),
        ("dx w_gate = g·w_gateT", g["w_gate"], w["w_gate"].t(), (), False),
        ("dw w_gate = xT·g", x.t(), g["w_gate"], (), False),
        ("dx w_down = g·w_downT", g["w_down"], w["w_down"].t(), (), False),
        ("dw w_down = hT·g", h.t(), g["w_down"], (), False),
        ("dw lm_head = xT·g", x.t(), g["lm_head"], (), False),
    ]
    k1_err, k1_rows = 0.0, []
    for label, a, b, chain, ag in cases:
        m, k = a.shape
        n = b.shape[1]
        kw = dict(chain=chain, ft=FT, save_act_grad=ag)
        p = ft_gemm.plan_call(a, b, **kw)
        check(p.instance == "sm90", f"K1 {label}: planned on the tensor-core "
              f"instance ({p})")
        out, rep = ft_gemm.ft_gemm(a, b, **kw)
        out_p, rep_p = _plain_gemm(a, b, **kw)
        if ag:
            (out, agk), (out_p, agp) = out, out_p
            err, ok = _bf16_close(agk, agp)
            check(ok, f"K1 {label}: act_grad max|kernel - plain| {err:.3g}")
        k1_err = max(k1_err, _cmp_outputs(f"K1 {label}", out, out_p, rep,
                                          rep_p))
        check(torch.equal(rep[..., :4], rep_p[..., :4]),
              f"K1 {label}: report det / corr / row / col equal")
        big = n == v
        iters = 2 if big else 5
        ms = time_ms(lambda: ft_gemm.ft_gemm(a, b, **kw), iters,
                     warmup=1 if big else 3)
        ms_off = time_ms(lambda: ft_gemm.ft_gemm(
            a, b, chain=chain, save_act_grad=ag), iters,
            warmup=1 if big else 3)
        final = dict(kw, ft=FT.replace(verify="final"))
        ms_final = time_ms(lambda: ft_gemm.ft_gemm(a, b, **final), iters,
                           warmup=1 if big else 3)
        simt_ms = _simt_ms(a, b, iters, warmup=1, **kw)
        plain_ms = time_ms(lambda: _plain_gemm(a, b, **kw), 1, warmup=0)
        lib_ms = time_ms(lambda: torch.matmul(a, b), iters)
        b_ms, b_by = bound(2.0 * m * n * k,
                           2 * (m * k + k * n + m * n * (2 if ag else 1)))
        k1_rows.append(dict(shape=f"{label} {m}x{n}x{k}", M=m, N=n, K=k,
                            a_strides=list(a.stride()),
                            b_strides=list(b.stride()), tiles=p.tiles,
                            splits=p.splits, ms=ms, ft_off_ms=ms_off,
                            verify_final_ms=ms_final, simt_ms=simt_ms,
                            plain_ms=plain_ms, library_ms=lib_ms,
                            bound_ms=b_ms, bound_by=b_by))
        print(f"  K1 {label} ({m}x{n}x{k}, A strides {tuple(a.stride())}, "
              f"B strides {tuple(b.stride())}, tiles {p.tiles}, {p.splits} "
              f"split(s)): kernel {ms:.4f} ms, FT off {ms_off:.4f} ms, "
              f"verify final {ms_final:.4f} ms, SIMT "
              f"{simt_ms:.3f} ms ({simt_ms / ms:.1f}x the kernel), plain "
              f"{plain_ms:.3f} ms, library {lib_ms:.4f} ms, bound "
              f"{b_ms:.4f} ms ({b_by})")
    # SEUs on integer operands: the act_grad variant and a dw on views.
    a, b = _ints(gen, t, d), _ints(gen, d, 512)
    (clean, clean_g), _ = ft_gemm.ft_gemm(a, b, chain=("silu",), ft=FT,
                                          save_act_grad=True)
    (out, out_g), rep = ft_gemm.ft_gemm(a, b, chain=("silu",), ft=FT,
                                        save_act_grad=True,
                                        inj=(1, -1, 700, 300, 5),
                                        inj_mag=512.0)
    cell = rep[rep[..., 0] > 0]
    check(torch.equal(out, clean) and torch.equal(out_g, clean_g)
          and float(rep[..., 0].sum()) == 1.0 and int(cell[0, 2]) == 700
          and int(cell[0, 3]) == 300,
          "K1 act_grad SEU corrected bit for bit (C and act_grad), located")
    a, b = _ints(gen, t, dff).t(), _ints(gen, t, 256)
    _k1_seus("dw on a transposed view", a, b, {}, 8000, 200, (0, 2, 3))
    rows["ft_gemm_sm90"] = dict(max_abs_err=k1_err, detail=k1_rows)

    # ---- K2 with stats at the training attention shapes ---------------
    for label, c in (("phi4-mini", cfg), ("qwen3-moe", qwen3_moe_235b.CONFIG)):
        _merge_rows(rows, _flash_fwd_kernels(gen, label, c.n_heads,
                                             c.n_kv_heads, TRAIN_BATCH,
                                             TRAIN_SEQ, True))

    # ---- K3 and K4 at phi4-mini's and qwen3-moe-235b-a22b's shapes -------
    for label, c in (("phi4-mini", cfg), ("qwen3-moe", qwen3_moe_235b.CONFIG)):
        _merge_rows(rows, _flash_bwd_kernels(gen, label, c))
    return rows


FLASH_BWD = ("flash_dq_sm90", "flash_dkv_sm90", "flash_dkv_reduce",
             "flash_dq", "flash_dkv")


def _flash_bwd_kernels(gen, label, cfg):
    """K3 and K4 at one model's training attention shape (TRAIN_BATCH x
    TRAIN_SEQ tokens, causal, bf16): the plan; the tensor-core instance
    against its plain version under the same plan (outputs within
    BF16_TOL, reports det / corr / row / col / k equal, tau within 1e-3);
    one SEU per backward GEMM on integer operands, corrected, located and
    left by a detect-only policy, one of them in a K4 range before the
    last; the range reduce against its plain version; the times of both
    instances, the plain versions, SDPA backward and the bound."""
    bh, gk, dh = (TRAIN_BATCH * cfg.n_heads, TRAIN_BATCH * cfg.n_kv_heads,
                  cfg.head_dim)
    n_rep, s, blk = bh // gk, TRAIN_SEQ, flashft.BLOCK
    nb = -(-s // blk)
    shape = f"{label}, {bh} heads / {gk} kv heads, S {s}, dh {dh}, causal"
    fkw = dict(ft=FT, scale=dh ** -0.5, tau_dh=dh, n_rep=n_rep, causal=True)
    q, k, v, go = (_rand(gen, bh, s, dh), _rand(gen, gk, s, dh),
                   _rand(gen, gk, s, dh), _rand(gen, bh, s, dh))
    o, m, l, _ = flashft.flash_ft_fwd(q, k, v, save_stats=True, **fkw)
    di = (go.float() * o.float()).sum(-1)
    args = (q, k, v, go, m, l, di)
    p = flashft.plan_bwd(q, k, v, go, n_rep=n_rep, causal=True)
    check(p.instance == "sm90"
          and p.ranges == flashft.dkv_ranges(gk * nb, n_rep * nb),
          f"K3/K4 {shape}: the tensor-core instance, K4's walk in "
          f"{p.ranges} ranges ({p})")
    before = {n: KERNELS[n]["counter"].launches for n in FLASH_BWD}
    dq, rep_q = flashft.flash_ft_dq(*args, **fkw)
    dk, dv, rep_kv = flashft.flash_ft_dkv(*args, **fkw)
    torch.cuda.synchronize()
    got = {n: KERNELS[n]["counter"].launches - before[n] for n in FLASH_BWD}
    check(got == {"flash_dq_sm90": 1, "flash_dkv_sm90": 1,
                  "flash_dkv_reduce": int(p.ranges > 1), "flash_dq": 0,
                  "flash_dkv": 0}, f"K3/K4 {label}: launches {got}")
    dq_p, rep_qp = flashft.flash_dq_plain(*args, **fkw)
    dk_p, dv_p, rep_kvp = flashft.planned_dkv_plain(*args, **fkw)
    err_q = _cmp_outputs(f"K3 {label} dq", dq, dq_p)
    err_kv = max(_cmp_outputs(f"K4 {label} dk", dk, dk_p),
                 _cmp_outputs(f"K4 {label} dv", dv, dv_p))
    # (The max-residual field spans all of a step's verifications while tau
    # is the last one's, the dQ / dK delta's, so the two are not compared.)
    fields = [0, 1, 2, 3, 7]
    for name, rk, rp in (("K3", rep_q, rep_qp), ("K4", rep_kv, rep_kvp)):
        tau_rel = ((rk[..., 6] - rp[..., 6]).abs()
                   / rp[..., 6].abs().clamp_min(1e-30)).max().item()
        check(float(rk[..., 0].sum()) == 0.0 == float(rp[..., 0].sum())
              and torch.equal(rk[..., fields], rp[..., fields])
              and tau_rel <= 1e-3,
              f"{name} {label} report: no detection, det / corr / row / col "
              f"/ k equal, tau within 1e-3 of plain ({tau_rel:.2g})")
    # The SIMT instance (pinned blocks) against its own plain version.
    pin = dict(fkw, bq=blk, bkv=blk)
    sq_, _ = flashft.flash_ft_dq(*args, **pin)
    sk_, sv_, _ = flashft.flash_ft_dkv(*args, **pin)
    dk_1, dv_1, _ = flashft.flash_dkv_plain(*args, **fkw)
    simt_err_q = _cmp_outputs(f"K3 SIMT {label} dq", sq_, dq_p)
    simt_err_kv = max(_cmp_outputs(f"K4 SIMT {label} dk", sk_, dk_1),
                      _cmp_outputs(f"K4 SIMT {label} dv", sv_, dv_1))

    # SEUs on integer-valued q, k, v, g: one per backward GEMM.
    ints = (_ints(gen, bh, s, dh), _ints(gen, gk, s, dh),
            _ints(gen, gk, s, dh), _ints(gen, bh, s, dh))
    co, cm, cl, _ = flashft.flash_ft_fwd(*ints[:3], save_stats=True, **fkw)
    iargs = (*ints, cm, cl, (ints[3].float() * co.float()).sum(-1))
    clean_q = flashft.flash_ft_dq(*iargs, **fkw)[:1]
    clean_kv = flashft.flash_ft_dkv(*iargs, **fkw)[:2]
    hk = n_rep + 1                     # a query head of kv head 1
    cases = [  # target, query head, block, step, row, col, magnitude
        ("dp_q", 5, 4, 2, 10, 33, 3e4), ("dq", 5, 4, 2, 10, 77, 300.0),
        ("dp_kv", hk, 2, 5, 40, 12, 3e4), ("dv", hk, 2, 5, 40, 12, 300.0),
        ("dk", hk, 2, 5, 40, 12, 300.0), ("dv", 0, 0, 1, 7, 100, 300.0)]
    first_range = None
    for target, head, bl, step, row, col, mag in cases:
        vec = (1, flashft.BWD_TARGETS[target], head, bl, step, row, col)
        in_q = target in flashft.DQ_TARGETS
        where = f"{target} at head {head}, block {bl}, step {step}"
        if not in_q:
            lo, live = flashft.dkv_walk(s, s, bl * blk, causal=True)
            z = flashft.dkv_range_of((head % n_rep) * live + step - lo,
                                     n_rep * live, p.ranges)
            where += f" (range {z} of {p.ranges})"
            if head == 0:
                first_range = z

        def run(ft):
            kw = dict(fkw, ft=ft, inj=vec, inj_mag=mag)
            if in_q:
                dq_, rq = flashft.flash_ft_dq(*iargs, **kw)
                return (dq_,), rq
            dk_, dv_, rkv = flashft.flash_ft_dkv(*iargs, **kw)
            return (dk_, dv_), rkv

        (outs, rep), (left, lrep) = run(FT), run(DETECT)
        clean = clean_q if in_q else clean_kv
        kname = "K3" if in_q else "K4"
        for x, c in zip(outs, clean):
            _cmp_outputs(f"{kname} {label} SEU {where}: corrected vs clean",
                         x, c)
        cell = rep[head, bl] if in_q else rep[head // n_rep, bl]
        at = {"dp_q": (bl * blk + row, step * blk + col),
              "dq": (bl * blk + row, col),
              "dp_kv": (step * blk + row, bl * blk + col)}.get(
                  target, (bl * blk + row, col))
        check(float(rep[..., 0].sum()) == 1.0 and float(cell[1]) == 1.0
              and (int(cell[2]), int(cell[3])) == at,
              f"{kname} {label} SEU {where}: corrected, located at {at}")
        check(float(lrep[..., 0].sum()) == 1.0
              and float(lrep[..., 1].sum()) == 0.0,
              f"{kname} {label} SEU {where}: detect-only counts it once")
        moved = [(x.float() - c.float()).abs() for x, c in zip(left, clean)]
        i = max(range(len(moved)), key=lambda j: moved[j].max().item())
        idx = tuple(int(t) for t in torch.unravel_index(moved[i].argmax(),
                                                        moved[i].shape))
        _seu_at(f"{kname} {label} {where}", outs[i], left[i], clean[i], idx)
    check(first_range is not None and first_range < p.ranges - 1,
          f"K4 {label}: an SEU in range {first_range} of {p.ranges}, not "
          f"the last, corrected")

    # The range reduce alone, from one ranged launch's workspace.
    red_row = None
    if p.ranges > 1:
        ws = torch.empty(p.ranges * gk * nb * (2 * blk * dh + 8),
                         device="cuda")
        rk_, rv_ = torch.empty_like(k), torch.empty_like(v)
        rr_ = torch.empty(gk, nb, 8, device="cuda")
        ptrs, rest = flashft._bwd_launch_args(q, k, go, m, l, di, ft=FT,
                                              scale=dh ** -0.5, tau_dh=dh,
                                              n_rep=n_rep, causal=True,
                                              inj=None, inj_mag=0.0,
                                              rng=None, salt=0)
        flashft.FLASH_DKV_SM90(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                               *ptrs, rk_.data_ptr(), rv_.data_ptr(),
                               rr_.data_ptr(), ws.data_ptr(), p.ranges,
                               *rest)

        def reduce():
            flashft.FLASH_DKV_REDUCE(ws.data_ptr(), rk_.data_ptr(),
                                     rv_.data_ptr(), rr_.data_ptr(), gk, s,
                                     p.ranges, rest[-1])

        reduce()
        pk, pv, pr = flashft.dkv_reduce_plain(ws, gk, s, p.ranges)
        red_err = max((rk_.float() - pk.float()).abs().max().item(),
                      (rv_.float() - pv.float()).abs().max().item())
        check(red_err == 0.0 and torch.equal(rr_, pr)
              and torch.equal(rk_, dk) and torch.equal(rr_, rep_kv),
              f"K4 {label} range reduce: equal to its plain version and to "
              f"the whole call")
        ms_red = time_ms(reduce, 20)
        pl_red = time_ms(lambda: flashft.dkv_reduce_plain(ws, gk, s,
                                                          p.ranges), 3)
        r_ms, r_by = bound(2.0 * p.ranges * gk * s * dh,
                           4 * ws.numel() + 2 * 2 * gk * s * dh + 32 * gk * nb)
        print(f"  K4 {label} range reduce ({p.ranges} ranges): kernel "
              f"{ms_red:.4f} ms, plain {pl_red:.3f} ms, bound {r_ms:.5f} ms "
              f"({r_by})")
        red_row = dict(max_abs_err=red_err, detail=[dict(
            shape=f"{shape}, {p.ranges} ranges", ms=ms_red, plain_ms=pl_red,
            library_ms=None, bound_ms=r_ms, bound_by=r_by)])

    # Times: both instances, the plain versions, SDPA backward, the bound.
    ms_q = time_ms(lambda: flashft.flash_ft_dq(*args, **fkw), 20)
    ms_kv = time_ms(lambda: flashft.flash_ft_dkv(*args, **fkw), 20)
    simt_q = time_ms(lambda: flashft.flash_ft_dq(*args, **pin), 3, warmup=1)
    simt_kv = time_ms(lambda: flashft.flash_ft_dkv(*args, **pin), 3,
                      warmup=1)
    pl_q = time_ms(lambda: flashft.flash_dq_plain(*args, **fkw), 1, warmup=0)
    pl_kv = time_ms(lambda: flashft.planned_dkv_plain(*args, **fkw), 1,
                    warmup=0)
    pl_kv1 = time_ms(lambda: flashft.flash_dkv_plain(*args, **fkw), 1,
                     warmup=0)
    q4 = q.view(TRAIN_BATCH, cfg.n_heads, s, dh).detach().requires_grad_()
    k4, v4 = (x_.view(TRAIN_BATCH, cfg.n_kv_heads, s, dh).repeat_interleave(
        n_rep, dim=1).detach().requires_grad_() for x_ in (k, v))
    sdpa_out = torch.nn.functional.scaled_dot_product_attention(
        q4, k4, v4, is_causal=True)
    g4 = go.view(TRAIN_BATCH, cfg.n_heads, s, dh)
    lib_b = time_ms(lambda: torch.autograd.grad(
        sdpa_out, (q4, k4, v4), g4, retain_graph=True), 10)
    (bq_ms, bq_by), (bkv_ms, bkv_by) = _flash_bwd_bounds(bh, gk, s, dh, True)
    print(f"  K3 dQ ({shape}): kernel {ms_q:.4f} ms, SIMT {simt_q:.4f} ms "
          f"({simt_q / ms_q:.1f}x), plain {pl_q:.2f} ms, bound {bq_ms:.5f} "
          f"ms ({bq_by}); K4 dK/dV ({p.ranges} ranges, the reduce "
          f"included): kernel {ms_kv:.4f} ms, SIMT {simt_kv:.4f} ms "
          f"({simt_kv / ms_kv:.1f}x), plain {pl_kv:.2f} ms (one range "
          f"{pl_kv1:.2f}), bound {bkv_ms:.5f} ms ({bkv_by}); SDPA backward "
          f"(dq, dk, dv together, KV repeated) {lib_b:.4f} ms")
    lib = "SDPA backward, dq+dk+dv together, KV repeated"
    rows = {
        "flash_dq_sm90": dict(max_abs_err=err_q, detail=[dict(
            shape=shape, ms=ms_q, simt_ms=simt_q, plain_ms=pl_q,
            library_ms=lib_b, library=lib, bound_ms=bq_ms, bound_by=bq_by)]),
        "flash_dkv_sm90": dict(max_abs_err=err_kv, detail=[dict(
            shape=shape, ranges=p.ranges, ms=ms_kv, simt_ms=simt_kv,
            plain_ms=pl_kv, library_ms=lib_b, library=lib, bound_ms=bkv_ms,
            bound_by=bkv_by)]),
        "flash_dq": dict(max_abs_err=simt_err_q, detail=[dict(
            shape=shape, ms=simt_q, plain_ms=pl_q, library_ms=lib_b,
            library=lib, bound_ms=bq_ms, bound_by=bq_by)]),
        "flash_dkv": dict(max_abs_err=simt_err_kv, detail=[dict(
            shape=shape, ms=simt_kv, plain_ms=pl_kv1, library_ms=lib_b,
            library=lib, bound_ms=bkv_ms, bound_by=bkv_by)]),
    }
    if red_row is not None:
        rows["flash_dkv_reduce"] = red_row
    return rows


# ---------------------------------------------------------------------------
# train_check / train
# ---------------------------------------------------------------------------

def _grads_of(params, cfg, batch, ctx):
    """(loss, {name: grad}, FT totals) of one loss_fn + backward."""
    for p in params.parameters():
        p.grad = None
    with telemetry.ft_scope() as scope:
        loss, _ = transformer.loss_fn(params, batch, cfg, ctx, remat="full")
        loss.backward()
        totals = scope.totals()
    grads = {n: p.grad.clone() for n, p in params.named_parameters()}
    return float(loss.detach()), grads, totals


def phase_train_check():
    cfg = dataclasses.replace(phi4_mini_38b.CONFIG, n_layers=CHECK_LAYERS)
    params = transformer.init(cfg, seed=5, dtype=torch.bfloat16)
    params.requires_grad_(True)
    tok = torch.randint(0, cfg.vocab_size, (1, CHECK_SEQ + 1),
                        generator=torch.Generator().manual_seed(5)).cuda()
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    ctx = Ctx(ft=FT, dtype=torch.bfloat16)
    loss_k, grads_k, tot_k = _grads_of(params, cfg, batch, ctx)
    with plain_kernels():
        loss_p, grads_p, tot_p = _grads_of(params, cfg, batch, ctx)
    rel = abs(loss_k - loss_p) / abs(loss_p)
    check(rel <= 1e-3, f"train_check: loss kernel {loss_k:.6f} vs plain "
          f"{loss_p:.6f} (relative {rel:.2g} <= 1e-3)")
    worst = max(((grads_k[n].float() - grads_p[n].float()).norm()
                 / grads_p[n].float().norm().clamp_min(1e-30)).item()
                for n in grads_p)
    check(worst <= 2e-2, f"train_check: every grad leaf within 2e-2 "
          f"relative Frobenius (worst {worst:.3g})")
    check(tot_k["detected"] == 0 and tot_p["detected"] == 0,
          f"train_check: zero detections (kernels {tot_k}, plain {tot_p})")
    seus = {
        # k_step counts the 256-deep k-steps of the dw's K = 256 tokens
        "w_down dw": ("w_down", ("dw", InjectionSpec(row=700, col=1000,
                                                     magnitude=64.0,
                                                     k_step=0))),
        # dK values are small (the loss is a mean over 256 tokens), and the
        # correction leaves the f32 rounding of the SEU's magnitude in the
        # corrected element: ulp(1.0) is not small against such an element,
        # and the backward spread a magnitude of 1.0 to 1.7e-3 of the grads
        # (this check with the tensor-core K1 upstream). 2^-10 stays far
        # above the block's tau and leaves a rounding of ulp(2^-10).
        "flash dK": ("attn_flash", dict(
            inject=InjectionSpec(row=20, col=9, magnitude=2.0 ** -10,
                                 k_step=2),
            inj_target="dk", inj_bh=5, inj_blk=1)),
    }
    def rel_err(grads):
        return max(((grads[n].float() - grads_k[n].float()).norm()
                    / grads_k[n].float().norm().clamp_min(1e-30)).item()
                   for n in grads_k)

    # The corrected element keeps the rounding of the f32 correction (the
    # located magnitude carries the column sum's rounding) and then of the
    # bf16 output, so the grads equal the clean ones to that rounding: a
    # relative error far below the SEU's, which a detect-only policy leaves.
    for label, hook in seus.items():
        _, hurt, _ = _grads_of(params, cfg, batch,
                               dataclasses.replace(ctx, bwd_inject=hook))
        exact = all(torch.equal(hurt[n], grads_k[n]) for n in grads_k)
        fixed = rel_err(hurt)
        _, left, _ = _grads_of(params, cfg, batch, dataclasses.replace(
            ctx, ft=DETECT, bwd_inject=hook))
        kept = rel_err(left)
        check(fixed <= 1e-3 and kept >= 100 * max(fixed, 1e-6),
              f"train_check: SEU in the {label} corrected: grads as the clean "
              f"run's (bit for bit: {exact}; worst leaf relative error "
              f"{fixed:.3g}), detect-only leaves it ({kept:.3g})")
    for p in params.parameters():
        p.grad = None


def phase_train(smi: str):
    cfg = phi4_mini_38b.CONFIG
    run = RunConfig(model=cfg, ft=FT, dtype="bfloat16", remat="full")
    # The first steps of a run under the default schedule (100 warmup
    # steps of 1 000); step 0 has lr 0.
    tc = train_loop.TrainConfig(log_every=1)
    shape = ShapeConfig("chip_smoke", TRAIN_SEQ, TRAIN_BATCH, "train")
    per_step = []

    def log(msg):
        per_step.append({n: k["counter"].launches
                         for n, k in KERNELS.items()})
        print(f"  {msg}", flush=True)

    torch.cuda.reset_peak_memory_stats()
    for k in KERNELS.values():
        k["counter"].launches = 0
    t0 = time.perf_counter()
    with telemetry.ft_scope() as scope:
        out = train_loop.train(cfg, run, shape, tc, log=log, device="cuda",
                               stop_at=TRAIN_STEPS)
    wall = time.perf_counter() - t0
    sites = {s: t for s, t in scope.site_totals().items() if t["detected"]}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    prev = {n: 0 for n in KERNELS}
    launches = []
    for snap in per_step:
        launches.append({n: snap[n] - prev[n] for n in KERNELS})
        prev = snap
    times = [x * 1e3 for x in out["step_times"]]
    step_ms = statistics.median(times[1:])
    tokens = TRAIN_BATCH * TRAIN_SEQ
    n_params = sum(p.numel() for p in out["params"].parameters())
    losses = [h["loss"] for h in out["history"]]
    print(f"  {n_params / 1e9:.2f} B parameters; steps "
          f"{[round(x, 1) for x in times]} ms, median of steps "
          f"1-{TRAIN_STEPS - 1} {step_ms:.1f} ms ({tokens / step_ms * 1e3:.1f} "
          f"tokens/s); train() wall {wall:.1f} s with init; peak memory "
          f"{peak:.1f} GiB")
    print(f"  losses {losses}; FT counters per step "
          f"{[(h['detected'], h['corrected']) for h in out['history']]}; "
          f"sites with detections {sites}")
    print(f"  launches per step {launches}")
    check(len(losses) == TRAIN_STEPS and all(math.isfinite(x) for x in losses),
          "train: a finite loss at every step")
    check(all(h["detected"] == 0 for h in out["history"]),
          "train: zero detections")
    expect = {**k1_launches(28 * cfg.n_layers + 3), **k5_launches(0),
              **k2_launches(2 * cfg.n_layers),
              **flash_bwd_launches(cfg, cfg.n_layers), **k6_launches(0),
              **OFF_PATH}
    check(all(x == expect for x in launches),
          f"train: launches per step {expect} at every step")
    # One more step through make_train_step under the dispatch guard.
    opt_cfg = adamw.AdamWConfig(lr=run.learning_rate,
                                weight_decay=run.weight_decay,
                                grad_clip=run.grad_clip)
    step_fn = train_loop.make_train_step(cfg, run, opt_cfg, tc)
    pipe = data_lib.for_model(cfg, shape, seed=run.seed)
    batch = {k: torch.as_tensor(x, dtype=torch.long, device="cuda")
             for k, x in pipe.batch_at(TRAIN_STEPS).items()}
    for k in KERNELS.values():
        k["counter"].launches = 0
    guard = LibraryCallGuard()
    with guard:
        _, _, metrics = step_fn(out["params"], out["opt_state"], batch,
                                TRAIN_STEPS)
        torch.cuda.synchronize()
    guarded = {n: k["counter"].launches for n, k in KERNELS.items()}
    print(f"  guarded step: loss {float(metrics['loss']):.4f}, launches "
          f"{guarded}, {len(guard.seen)} distinct ops dispatched")
    check(not guard.hits, f"train: no library matmul / attention op "
          f"dispatched in the forward or the backward "
          f"({sorted(set(guard.hits))})")
    check(any("index_put" in op for op in guard.seen),
          "train: the guard saw the backward's ops (the embedding's "
          "index_put)")
    check(guarded == expect, f"train: guarded step launches {guarded}")
    # Where the step's time goes: the device's busy and idle share over one
    # more step (torch.profiler), then over one with K3 and K4 pinned to
    # their SIMT instances (the kernels before the tensor-core redesign).
    prof = {}
    for i, (name, pin) in enumerate((("tensor cores", contextlib.nullcontext()),
                                     ("SIMT K3 / K4", simt_flash_bwd()),
                                     ("SIMT K2", simt_flash_fwd()))):
        with pin:
            prof[name] = device_profile(lambda: step_fn(
                out["params"], out["opt_state"], batch, TRAIN_STEPS + 1 + i))
        print(f"  profiled step ({name}): {prof[name]}")
    print(json.dumps({"train": dict(
        arch=cfg.arch_id, layers=cfg.n_layers, batch=TRAIN_BATCH,
        seq=TRAIN_SEQ, steps=TRAIN_STEPS, step_ms=times,
        median_step_ms=step_ms, tokens_per_s=tokens / step_ms * 1e3,
        peak_gib=peak, losses=losses, launches_per_step=launches[-1],
        profile=prof, card=smi)}))
    return guarded


# ---------------------------------------------------------------------------
# moe_kernels / moe_check / moe_engine / moe_train
# ---------------------------------------------------------------------------

MOE = qwen3_moe_235b.CONFIG
#: the MoE paths: engine at 12 of 94 layers (62 GB of bf16 weights), the
#: checks at 2, training at 1 (with f32 AdamW, 2 layers need 75 GB)
MOE_ENGINE_LAYERS, MOE_CHECK_LAYERS, MOE_TRAIN_LAYERS = 12, 2, 1


def _moe_layout(gen, n_rows, bm, ragged_last=3, empty=4):
    """A layout over MOE's 128 experts from random expert ids, with
    ``ragged_last`` rows routed to the last expert (a ragged last group) and
    ``empty`` experts from the 40th on routed nothing (at 64 rows most
    groups are empty anyway)."""
    e = MOE.moe.n_experts
    ids = torch.randint(0, e - 1 - empty, (n_rows,), generator=gen,
                        device="cuda")
    ids = torch.where(ids >= 40, ids + empty, ids)
    ids[:ragged_last] = e - 1
    return kgrouped.make_layout(ids, e, bm)


def _live(lay):
    """(live rows, live experts) of a layout (host values)."""
    counts = lay.counts.tolist()
    return sum(counts), sum(c > 0 for c in counts)


def _library_grouped(buf, w, lay):
    """One library call computing buf @ w[gid] per group: torch._grouped_mm
    over the aligned group ends where this torch takes that form, else a
    loop of torch.matmul over the live experts. Returns (fn, label)."""
    bm = lay.bm
    ends = ((lay.row_end + bm - 1) // bm * bm).to(torch.int32)
    if hasattr(torch, "_grouped_mm"):
        try:
            torch._grouped_mm(buf, w, offs=ends)
            torch.cuda.synchronize()
            return (lambda: torch._grouped_mm(buf, w, offs=ends),
                    "torch._grouped_mm")
        except Exception as exc:                 # form not taken: say so
            print(f"  torch._grouped_mm refused ({type(exc).__name__}: "
                  f"{str(exc).splitlines()[0][:80]}); timing a matmul loop")
    spans = [(g, int(b), int(r)) for g, (b, r) in
             enumerate(zip(lay.base.tolist(), lay.row_end.tolist())) if r > b]
    return (lambda: [torch.matmul(buf[b:r], w[g]) for g, b, r in spans],
            "loop of torch.matmul over the live experts")


def _library_tgmm(x, g, lay):
    """One library call computing dw[e] = x_eᵀ g_e: torch._grouped_mm with
    the group ends along the reduction and an f32 output (like for like with
    K8) where this torch takes that form, else the same call with its bf16
    output, else a loop of torch.matmul. Returns (fn, label, out dtype)."""
    bm = lay.bm
    ends = ((lay.row_end + bm - 1) // bm * bm).to(torch.int32)
    xt = x.t()
    if hasattr(torch, "_grouped_mm"):
        for kw in (dict(out_dtype=torch.float32), {}):
            try:
                out = torch._grouped_mm(xt, g, offs=ends, **kw)
                torch.cuda.synchronize()
                return (lambda: torch._grouped_mm(xt, g, offs=ends, **kw),
                        f"torch._grouped_mm ({out.dtype} out)", out.dtype)
            except Exception as exc:
                print(f"  torch._grouped_mm {kw} refused "
                      f"({type(exc).__name__}: "
                      f"{str(exc).splitlines()[0][:80]})")
    spans = [(b, r) for b, r in zip(lay.base.tolist(), lay.row_end.tolist())
             if r > b]
    return (lambda: [torch.matmul(xt[:, b:r], g[b:r]) for b, r in spans],
            "loop of torch.matmul over the live experts", x.dtype)


def _launched(counter, fn):
    """fn() and the launches it added to ``counter``."""
    before = counter.launches
    out = fn()
    return out, counter.launches - before


def phase_moe_kernels():
    gen = torch.Generator(device="cuda").manual_seed(16)
    d, f = MOE.d_model, MOE.moe.expert_d_ff
    e, top_k = MOE.moe.n_experts, MOE.moe.top_k
    dec_rows = ENGINE_SLOTS * top_k
    pre_rows, train_rows = PROMPT * top_k * 4, TRAIN_BATCH * TRAIN_SEQ * top_k
    bm = kgrouped.plan_grouped(dec_rows, f, d, torch.bfloat16,
                               n_groups=e)[0]
    simt7, simt8 = (bm, 128, 32), (bm, 64, 64)
    w_gate = _rand(gen, e, d, f, scale=0.02)
    w_down = _rand(gen, e, f, d, scale=0.02)
    rows = {}

    # ---- K7 at the engine's and the trainer's shapes ---------------------
    # Each on the tensor-core instance (the plan's default) against its
    # plain version under the same plan, and the SIMT instance at its tiles
    # in the same run.
    k7_cases = [  # (label, rows, w)
        (f"decode gate {dec_rows} rows {d}->{f}", dec_rows, w_gate),
        (f"decode down {dec_rows} rows {f}->{d}", dec_rows, w_down),
        (f"prefill gate {pre_rows} rows {d}->{f}", pre_rows, w_gate),
        (f"train dbuf gate {train_rows} rows {f}->{d} (w^T view)",
         train_rows, w_gate.transpose(-1, -2)),
    ]
    k7_err, k7_rows, simt_rows, simt_err = 0.0, [], [], 0.0
    for label, n_rows, w in k7_cases:
        lay = _moe_layout(gen, n_rows, bm)
        k, n = w.shape[1], w.shape[2]
        buf = kgrouped.scatter_rows(_rand(gen, n_rows, k), lay)
        args = (buf, w, lay.gid, lay.row_end)
        p = grouped_gemm.plan_k7_call(buf, w, lay.gid)
        (out, rep), nl = _launched(grouped_gemm.FT_GEMM_GROUPED_SM90,
                                   lambda: grouped_gemm.ft_gemm_grouped(
                                       *args, ft=FT))
        check(p.instance == "sm90" and nl == 1,
              f"K7 {label}: planned and launched on the tensor cores "
              f"(tiles {p.tiles}, chunk {p.chunk}, w k-major {p.w_kmajor})")
        out_p, rep_p = grouped_gemm.planned_grouped_plain(*args, ft=FT)
        k7_err = max(k7_err, _cmp_outputs(f"K7 {label}", out, out_p, rep,
                                          rep_p))
        live_rows, live_e = _live(lay)
        iters = 20 if n_rows == dec_rows else 5
        ms = time_ms(lambda: grouped_gemm.ft_gemm_grouped(*args, ft=FT),
                     iters)
        ms_final = time_ms(lambda: grouped_gemm.ft_gemm_grouped(
            *args, ft=FT.replace(verify="final")), iters)
        ms_off = time_ms(lambda: grouped_gemm.ft_gemm_grouped(*args), iters)
        simt_ms = time_ms(lambda: grouped_gemm.ft_gemm_grouped(
            *args, ft=FT, tiles=simt7), min(iters, 3))
        plain_ms = time_ms(lambda: grouped_gemm.planned_grouped_plain(
            *args, ft=FT), 1, warmup=0)
        lib, lib_label = _library_grouped(buf, w, lay)
        lib_ms = time_ms(lib, iters)
        nbytes = 2 * (live_rows * k + live_e * k * n + live_rows * n)
        b_ms, b_by = bound(2.0 * live_rows * n * k, nbytes)
        k7_rows.append(dict(shape=label, rows=n_rows, t_buf=lay.t_buf,
                            live_experts=live_e, K=k, N=n, ms=ms,
                            final_ms=ms_final, ft_off_ms=ms_off,
                            simt_ms=simt_ms, plain_ms=plain_ms,
                            library_ms=lib_ms, library=lib_label,
                            bound_ms=b_ms, bound_by=b_by))
        print(f"  K7 {label} ({live_rows} live rows in {lay.t_buf}, "
              f"{live_e} live experts): tensor cores {ms:.4f} ms (final "
              f"{ms_final:.4f}, FT off {ms_off:.4f}), SIMT {simt_ms:.4f} ms, "
              f"plain {plain_ms:.2f} ms, library {lib_ms:.4f} ms "
              f"({lib_label}), bound {b_ms:.5f} ms ({b_by})")
        if n_rows == dec_rows and w is w_gate:
            # The SIMT instance against its own plain version here.
            (out_s, rep_s), nl = _launched(
                grouped_gemm.FT_GEMM_GROUPED_SIMT,
                lambda: grouped_gemm.ft_gemm_grouped(*args, ft=FT,
                                                     tiles=simt7))
            out_sp, rep_sp = grouped_gemm.ft_gemm_grouped_plain(
                *args, tiles=simt7, ft=FT)
            check(nl == 1, "K7 SIMT: pinned tiles launch the SIMT instance")
            simt_err = _cmp_outputs(f"K7 SIMT {label}", out_s, out_sp, rep_s,
                                    rep_sp)
            simt_plain_ms = time_ms(lambda: grouped_gemm.ft_gemm_grouped_plain(
                *args, tiles=simt7, ft=FT), 1, warmup=0)
            simt_rows.append(dict(shape=label, ms=simt_ms,
                                  plain_ms=simt_plain_ms, library_ms=lib_ms,
                                  bound_ms=b_ms, bound_by=b_by))
        else:
            simt_rows.append(dict(shape=label, ms=simt_ms, plain_ms=None,
                                  library_ms=lib_ms, bound_ms=b_ms,
                                  bound_by=b_by))
        del out_p, rep_p
    # SEUs at the decode shape on integer operands, in the ragged last
    # group (its chunk runs past row_end into the buffer's dead tail), at
    # the first and the last 256-deep k-step: corrected bit for bit and
    # located; left in place by a detect-only policy.
    lay = _moe_layout(gen, dec_rows, bm)
    buf = kgrouped.scatter_rows(_ints(gen, dec_rows, d), lay)
    wi = _ints(gen, e, d, f)
    args = (buf, wi, lay.gid, lay.row_end)
    clean, rep0 = grouped_gemm.ft_gemm_grouped(*args, ft=FT)
    check(float(rep0[..., 0].sum()) == 0.0, "K7 integer operands: clean run "
          "undetected")
    grp = e - 1                                   # the ragged last group
    row = int(lay.row_end[grp]) - 1
    col, mag = f - 5, 1000.0
    for step in (0, ft_gemm.cdiv(d, 256) - 1):
        inj = (1, row, col, step)
        fixed, rep = grouped_gemm.ft_gemm_grouped(*args, ft=FT, inj=inj,
                                                  inj_mag=mag)
        _, rep_p = grouped_gemm.planned_grouped_plain(*args, ft=FT, inj=inj,
                                                      inj_mag=mag)
        cell = rep[rep[..., 0] > 0]
        check(torch.equal(fixed, clean) and float(rep[..., 0].sum()) == 1.0
              and float(rep[..., 1].sum()) == 1.0 and int(cell[0, 2]) == row
              and int(cell[0, 3]) == col
              and abs(float(cell[0, 4]) - mag) < 1e-3
              and torch.equal(rep[..., :4], rep_p[..., :4]),
              f"K7 SEU in the ragged last group (row {row}, col {col}, "
              f"k-step {step}) corrected bit for bit and located, report as "
              f"the plain version's")
        left, rep_d = grouped_gemm.ft_gemm_grouped(*args, ft=DETECT, inj=inj,
                                                   inj_mag=mag)
        moved = float(left[row, col].float() - clean[row, col].float())
        check(float(rep_d[..., 0].sum()) >= 1.0
              and float(rep_d[..., 1].sum()) == 0.0
              and abs(moved - mag) <= 16.0
              and int((left != clean).sum()) == 1,
              f"K7 the same SEU detect-only: detected "
              f"{float(rep_d[..., 0].sum()):.0f} time(s), left in place "
              f"(moved {moved:.1f})")
    empty = lay.counts == 0
    dead = torch.ones(lay.t_buf, dtype=torch.bool, device="cuda")
    dead[lay.positions.long()] = False
    dirty = buf.clone()
    dirty[dead] = 3.0
    got, rep_g = grouped_gemm.ft_gemm_grouped(dirty, wi, lay.gid,
                                              lay.row_end, ft=FT)
    check(bool(empty.any()) and not bool(fixed[dead].any())
          and torch.equal(got, clean) and torch.equal(rep_g, rep0),
          f"K7: {int(empty.sum())} empty groups, the dead rows written as "
          f"zeros; garbage in the dead rows changes nothing (masking)")
    rows["ft_gemm_grouped_sm90"] = dict(max_abs_err=k7_err, detail=k7_rows,
                                        headline=k7_cases[0][0])
    rows["ft_gemm_grouped"] = dict(max_abs_err=simt_err, detail=simt_rows,
                                   headline=k7_cases[0][0])

    # ---- K8 at the training dw ---------------------------------------------
    spec = BatchedKernelSpec(ft_level="block", tgmm=True)
    lay = _moe_layout(gen, train_rows, bm)
    x = kgrouped.scatter_rows(_rand(gen, train_rows, d), lay)
    g = kgrouped.scatter_rows(_rand(gen, train_rows, f, scale=1e-3), lay)
    p = grouped_gemm.plan_k8_call(x, g, bm)
    (dw, rep), nl = _launched(grouped_gemm.TGMM_SM90,
                              lambda: kgrouped.tgmm_buffer_call(spec, x, g,
                                                                lay, ft=FT))
    label = f"train dw gate {train_rows} rows -> ({e}, {d}, {f}) f32"
    check(p.instance == "sm90" and nl == 1,
          f"K8 {label}: planned and launched on the tensor cores (tiles "
          f"{p.tiles}, interval {p.chunk} rows)")
    dw_p, rep_p = grouped_gemm.planned_tgmm_plain(x, g, lay.row_end, bm=bm,
                                                  ft=FT)
    live = lay.counts > 0            # an empty group's report is all zero
    k8_err = _cmp_outputs(f"K8 {label}", dw, dw_p, rep[live], rep_p[live])
    check(not bool(dw[~live].any()) and not bool(rep[~live].any()),
          f"K8: the {int((~live).sum())} empty groups' dw and report zero")
    del dw_p, rep_p
    live_rows, live_e = _live(lay)
    call = lambda **kw: kgrouped.tgmm_buffer_call(spec, x, g, lay, **kw)  # noqa: E731
    ms = time_ms(lambda: call(ft=FT), 5)
    ms_final = time_ms(lambda: call(ft=FT.replace(verify="final")), 5)
    ms_off = time_ms(lambda: kgrouped.tgmm_buffer_call(
        BatchedKernelSpec(tgmm=True), x, g, lay), 5)
    simt_ms = time_ms(lambda: call(ft=FT, tiles=simt8), 3)
    plain_ms = time_ms(lambda: grouped_gemm.planned_tgmm_plain(
        x, g, lay.row_end, bm=bm, ft=FT), 1, warmup=0)
    (dw_s, rep_s), nl = _launched(grouped_gemm.TGMM_SIMT,
                                  lambda: call(ft=FT, tiles=simt8))
    dw_sp, rep_sp = grouped_gemm.tgmm_plain(x, g, lay.row_end, tiles=simt8,
                                            ft=FT)
    check(nl == 1, "K8 SIMT: pinned tiles launch csrc/tgmm.cu")
    simt8_err = _cmp_outputs(f"K8 SIMT {label}", dw_s, dw_sp, rep_s[live],
                             rep_sp[live])
    del dw_s, dw_sp
    simt_plain_ms = time_ms(lambda: grouped_gemm.tgmm_plain(
        x, g, lay.row_end, tiles=simt8, ft=FT), 1, warmup=0)
    lib, lib_label, lib_dtype = _library_tgmm(x, g, lay)
    lib_ms = time_ms(lib, 5)
    flops = 2.0 * live_rows * d * f
    in_bytes = 2 * live_rows * (d + f)
    b_ms, b_by = bound(flops, in_bytes + 4 * e * d * f)
    b16_ms, _ = bound(flops, in_bytes + 2 * e * d * f)
    lib_bytes = in_bytes + (4 if lib_dtype == torch.float32 else 2) * e * d * f
    print(f"  K8 {label} ({live_rows} live rows in {lay.t_buf}, {live_e} "
          f"live experts): tensor cores {ms:.3f} ms (final {ms_final:.3f}, "
          f"FT off {ms_off:.3f}), SIMT {simt_ms:.3f} ms, plain {plain_ms:.1f} "
          f"ms (SIMT plan {simt_plain_ms:.1f}), library {lib_ms:.3f} ms "
          f"({lib_label}, moves {lib_bytes / 1e9:.3f} GB), bound {b_ms:.4f} "
          f"ms ({b_by}, f32 dw; {b16_ms:.4f} ms with a bf16 dw)")
    # SEUs on integer operands in the ragged last tile of the last group:
    # corrected bit for bit, located; detect-only leaves it (and the dead
    # tail's verifications count it again); empty groups come back zero.
    lay = _moe_layout(gen, train_rows, bm)
    xi = kgrouped.scatter_rows(_ints(gen, train_rows, d), lay)
    gi = kgrouped.scatter_rows(_ints(gen, train_rows, f), lay)
    clean, rep0 = kgrouped.tgmm_buffer_call(spec, xi, gi, lay, ft=FT)
    grp = e - 1
    tile = (int(lay.row_end[grp]) - 1) // bm       # the ragged last tile
    col = min(700, f - 1)
    inj = InjectionSpec(row=d - 1, col=col, magnitude=500.0, k_step=tile)
    fixed, rep = kgrouped.tgmm_buffer_call(spec, xi, gi, lay, ft=FT,
                                           inject=inj)
    cell = rep[grp, (d - 1) // 128, col // 128]
    check(float(rep0[..., 0].sum()) == 0.0 and torch.equal(fixed, clean)
          and float(rep[..., 0].sum()) == 1.0 and int(cell[2]) == d - 1
          and int(cell[3]) == col and abs(float(cell[4]) - 500.0) < 1e-3,
          "K8 SEU in the ragged last tile of the last group's dw corrected "
          "bit for bit and located")
    left, rep_d = kgrouped.tgmm_buffer_call(spec, xi, gi, lay, ft=DETECT,
                                            inject=inj)
    _, rep_dp = grouped_gemm.planned_tgmm_plain(
        xi, gi, lay.row_end, bm=bm, ft=DETECT,
        inj=(1, d - 1, col, tile), inj_mag=500.0)
    moved = float(left[grp, d - 1, col] - clean[grp, d - 1, col])
    check(float(rep_d[..., 0].sum()) == float(rep_dp[..., 0].sum()) >= 1.0
          and float(rep_d[..., 1].sum()) == 0.0 and moved == 500.0,
          f"K8 the same SEU detect-only: detected "
          f"{float(rep_d[..., 0].sum()):.0f} times as the plain version (the "
          f"last group re-verifies on the buffer's dead tail), left in place")
    empty = lay.counts == 0
    check(bool(empty.any()) and not bool(fixed[empty].any())
          and not bool(rep[empty].any()),
          f"K8: the {int(empty.sum())} empty groups' dw and report are zero, "
          f"written by the kernel (no pass after it)")
    rows["tgmm_sm90"] = dict(max_abs_err=k8_err, detail=[dict(
        shape=label, rows=train_rows, t_buf=lay.t_buf, live_experts=live_e,
        K=d, N=f, ms=ms, final_ms=ms_final, ft_off_ms=ms_off, simt_ms=simt_ms,
        plain_ms=plain_ms, library_ms=lib_ms, library=lib_label,
        library_bytes=lib_bytes, bound_ms=b_ms, bound_by=b_by,
        bound_bf16_out_ms=b16_ms)], headline=label)
    rows["tgmm"] = dict(max_abs_err=simt8_err, detail=[dict(
        shape=label, ms=simt_ms, plain_ms=simt_plain_ms, library_ms=lib_ms,
        bound_ms=b_ms, bound_by=b_by)], headline=label)
    return rows


class _RoutingTap:
    """Records the expert indices and router probabilities of every
    `moe._routing` call; with ``replay`` (a tap of an earlier run) each
    call routes to that run's experts instead of its own, gate values and
    aux taken from its own probabilities as `moe._routing` takes them, so
    two paths route alike and stay differentiable."""

    def __init__(self, replay=None):
        self.idx, self.probs = [], []
        self.replay = replay

    def __enter__(self):
        self._orig = moe._routing

        def routing(xt, router, mc):
            out = self._orig(xt, router, mc)
            probs = torch.softmax(torch.matmul(xt.float(), router.float()),
                                  -1)
            self.probs.append(probs.detach())
            self.idx.append(out[1])
            if self.replay is None:
                return out
            idx = self.replay.idx[len(self.idx) - 1]
            gate = torch.gather(probs, -1, idx)
            gate = gate / torch.clamp_min(gate.sum(-1, keepdim=True), 1e-9)
            ce = torch.nn.functional.one_hot(idx[..., 0], mc.n_experts)
            aux = mc.n_experts * torch.sum(probs.mean(0) * ce.float().mean(0))
            return gate, idx, aux

        moe._routing = routing
        return self

    def __exit__(self, *exc):
        moe._routing = self._orig


def phase_moe_check():
    cfg = dataclasses.replace(MOE, n_layers=MOE_CHECK_LAYERS)
    run = RunConfig(model=cfg, ft=FT, dtype="bfloat16")
    params = transformer.init(cfg, seed=7, dtype=torch.bfloat16)
    ctx = Ctx(ft=FT, dtype=torch.bfloat16)
    rng = torch.Generator().manual_seed(7)
    e, top_k = cfg.moe.n_experts, cfg.moe.top_k
    # ---- the forward through the kernels and through the plain versions --
    tok = torch.randint(0, cfg.vocab_size, (2, 128), generator=rng).cuda()

    def fwd(replay=None):
        with telemetry.ft_scope() as scope, _RoutingTap(replay) as tap, \
                torch.inference_mode():
            logits, aux = transformer.forward(params, tok, cfg, ctx)
            return logits.float(), float(aux), tap, scope.totals()

    # The plain path replays the kernel path's routing (its own is compared
    # below): a token whose expert set flips at a rounding tie goes through
    # other experts, which no tolerance on the logits would absorb.
    lk, aux_k, tap_k, tot_k = fwd()
    with plain_kernels():
        lp, aux_p, tap_p, tot_p = fwd(replay=tap_k)
    err, scale = (lk - lp).abs().max().item(), lp.abs().max().item()
    check(bool(torch.isfinite(lk).all()) and err <= 2e-2 * scale,
          f"moe_check: forward logits kernel vs plain (same routing) "
          f"{err:.3g} <= 2e-2 x {scale:.3g}")
    # Each path's own router sees its own layer input, which the two paths
    # round differently in bf16: the probabilities must agree to that
    # rounding; a token whose top-k margin is below the difference may
    # pick another expert set (printed, not checked).
    for layer, (ik, ip, pk, pp) in enumerate(zip(tap_k.idx, tap_p.idx,
                                                 tap_k.probs, tap_p.probs)):
        flip = ~(torch.sort(ik, -1).values
                 == torch.sort(ip, -1).values).all(-1)
        top = torch.topk(pk, top_k + 1, -1).values
        margin = top[:, -2] - top[:, -1]
        dp, scale = float((pk - pp).abs().max()), float(pk.max())
        worst = float(margin[flip].max()) if bool(flip.any()) else 0.0
        print(f"  layer {layer} routing: {int(flip.sum())} of {len(flip)} "
              f"tokens pick another expert set on the plain path, their "
              f"top-{top_k} margins <= {worst:.3g} (median margin "
              f"{float(margin.median()):.3g}); max router probability "
              f"difference {dp:.3g}")
        check(dp <= 2e-2 * scale,
              f"moe_check: layer {layer}'s router probabilities on the two "
              f"paths within 2e-2 x {scale:.3g} ({dp:.3g})")
    check(tot_k["detected"] == 0 and tot_p["detected"] == 0,
          f"moe_check: zero detections (kernels {tot_k}, plain {tot_p})")
    # ---- the engine against one single-slot engine per request -----------
    prng = np.random.default_rng(7)
    prompts, budgets = _prompts(prng, 6, 5, 120, 3, 12, cfg.vocab_size)
    eng = ProbeEngine(params, cfg, run, engine.EngineConfig(max_len=256,
                                                            n_slots=3))
    for p_, m in zip(prompts, budgets):
        eng.submit(p_, max_new_tokens=m)
    for k in KERNELS.values():
        k["counter"].launches = 0
    with telemetry.ft_scope() as scope:
        res = eng.run()
        sites = scope.site_totals()
    k7 = grouped_gemm.FT_GEMM_GROUPED.launches
    k7_sm90 = grouped_gemm.FT_GEMM_GROUPED_SM90.launches
    steps = len(eng.decode_ms)
    solo = []
    for p_, m in zip(prompts, budgets):
        one = ProbeEngine(params, cfg, run,
                          engine.EngineConfig(max_len=256, n_slots=1))
        one.submit(p_, max_new_tokens=m)
        solo.append((one.run()[0], one.gaps[0]))
    for r, (s_, s_gaps) in zip(res, solo):
        if r.tokens == s_.tokens:
            continue
        t = next(i for i, (x, y) in enumerate(zip(r.tokens, s_.tokens))
                 if x != y)
        (ga, ta), (gb, tb) = eng.gaps[r.rid][t], s_gaps[t]
        print(f"  request {r.rid}: engine and solo differ at token {t}; "
              f"top-2 logit gaps {ga:.4g} / {gb:.4g} at |top| "
              f"{max(ta, tb):.4g}")
        check(min(ga, gb) <= BF16_TOL * max(ta, tb),
              f"moe_check: request {r.rid}'s first difference is a bf16 tie")
    n_same = sum(r.tokens == s_.tokens for r, (s_, _) in zip(res, solo))
    print(f"  {n_same} of {len(res)} requests give their solo tokens exactly")
    check([len(r.tokens) for r in res] == budgets
          and eng.alloc.n_free == eng.plan.n_pages - 1,
          "moe_check: every request met its budget, all pages came back")
    check({"moe_gate", "moe_up", "moe_down", "dec_flash"} <= set(sites)
          and all(t["detected"] == 0 for t in sites.values()),
          "moe_check: the MoE sites and dec_flash in the scope, no detection")
    check(k7 == k7_sm90 == 3 * cfg.n_layers * (len(prompts) + steps),
          f"moe_check: K7 launches {k7} = 3 x {cfg.n_layers} layers x "
          f"({len(prompts)} prefills + {steps} decode steps), every one on "
          f"the tensor-core instance")
    # ---- loss and grads: kernels vs plain, and a dw SEU in moe_gate ------
    params.requires_grad_(True)
    tok = torch.randint(0, cfg.vocab_size, (1, CHECK_SEQ + 1),
                        generator=rng).cuda()
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    with _RoutingTap() as tap_g:
        loss_k, grads_k, tot_k = _grads_of(params, cfg, batch, ctx)
    with plain_kernels(), _RoutingTap(replay=tap_g):
        loss_p, grads_p, tot_p = _grads_of(params, cfg, batch, ctx)
    rel = abs(loss_k - loss_p) / abs(loss_p)
    rels = {n: ((grads_k[n].float() - grads_p[n].float()).norm()
                / grads_p[n].float().norm().clamp_min(1e-30)).item()
            for n in grads_p}
    worst = max(rels, key=rels.get)
    check(rel <= 1e-3 and rels[worst] <= 2e-2 and tot_k["detected"] == 0
          and tot_p["detected"] == 0,
          f"moe_check: loss kernel {loss_k:.6f} vs plain {loss_p:.6f} "
          f"(relative {rel:.2g}, the plain path on the kernel path's "
          f"routing), every grad leaf within 2e-2 relative (worst "
          f"{rels[worst]:.3g}, {worst}), no detection")
    del grads_p
    # Buffer tile 0 is always the first tile of the first non-empty group.
    hook = ("moe_gate", ("dw", InjectionSpec(
        row=min(700, cfg.d_model - 1), col=min(1000, cfg.moe.expert_d_ff - 1),
        magnitude=1.0, k_step=0)))

    def rel_err(grads):
        return max(((grads[n].float() - grads_k[n].float()).norm()
                    / grads_k[n].float().norm().clamp_min(1e-30)).item()
                   for n in grads_k)

    before = grouped_gemm.TGMM.launches, grouped_gemm.TGMM_SM90.launches
    _, hurt, _ = _grads_of(params, cfg, batch,
                           dataclasses.replace(ctx, bwd_inject=hook))
    k8 = grouped_gemm.TGMM.launches - before[0]
    k8_sm90 = grouped_gemm.TGMM_SM90.launches - before[1]
    fixed = rel_err(hurt)
    del hurt
    _, left, _ = _grads_of(params, cfg, batch, dataclasses.replace(
        ctx, ft=DETECT, bwd_inject=hook))
    kept = rel_err(left)
    check(k8 == k8_sm90 == 3 * cfg.n_layers and fixed <= 1e-3
          and kept >= 100 * max(fixed, 1e-6),
          f"moe_check: SEU in moe_gate's dw (K8, {k8} launches, all on the "
          f"tensor-core instance) corrected: "
          f"worst leaf relative error {fixed:.3g}; detect-only leaves it "
          f"({kept:.3g})")
    for p in params.parameters():
        p.grad = None


def phase_moe_engine(seed: int, smi: str):
    cfg = dataclasses.replace(MOE, n_layers=MOE_ENGINE_LAYERS)
    print(f"  depth cut: {cfg.n_layers} of {MOE.n_layers} layers (the "
          f"full width; 94 layers need 468 GB)")
    run = RunConfig(model=cfg, ft=FT, dtype="bfloat16")
    t0 = time.perf_counter()
    params = transformer.init(cfg, seed=0, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    print(f"  init: {sum(p.numel() for p in params.parameters()) / 1e9:.2f} B "
          f"parameters in {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(seed)
    prompts, budgets = _prompts(rng, ENGINE_REQUESTS, 16, 512, 8, 32,
                                cfg.vocab_size)
    ec = engine.EngineConfig(max_len=ENGINE_MAX_LEN, n_slots=ENGINE_SLOTS)

    def serve_all(guard=None):
        eng = ProbeEngine(params, cfg, run, ec)
        for p_, m in zip(prompts, budgets):
            eng.submit(p_, max_new_tokens=m)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with telemetry.ft_scope() as scope:
            if guard is None:
                res = eng.run()
            else:
                with guard:
                    res = eng.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            totals = scope.totals()
        return eng, res, wall, totals

    torch.cuda.reset_peak_memory_stats()
    for k in KERNELS.values():
        k["counter"].launches = 0
    guard = LibraryCallGuard(allow=router_product(cfg.moe.n_experts))
    eng_g, res_g, wall_g, tot_g = serve_all(guard)
    launches = {n: k["counter"].launches for n, k in KERNELS.items()}
    steps = len(eng_g.decode_ms)
    eng, res, wall, totals = serve_all()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    pool = sum(eng.cache[n].nbytes for n in ("k_pages", "v_pages"))
    n_tok = sum(len(r.tokens) for r in res)
    dec_ms, pre_ms = (statistics.median(eng.decode_ms),
                      statistics.median(eng.prefill_ms))
    full = [x for x, n_live in zip(eng.decode_ms, eng.live_per_step)
            if n_live == ENGINE_SLOTS]
    ttft = [r.ttft_s * 1e3 for r in res]
    print(f"  {ENGINE_REQUESTS} requests, prompts {[len(p_) for p_ in prompts]}"
          f", budgets {budgets}")
    print(f"  guarded run {wall_g:.2f} s; launches {launches}; {steps} decode "
          f"steps; FT totals {tot_g}; router products allowed "
          f"{guard.allowed}")
    print(f"  timed run {wall:.2f} s: {n_tok} tokens, {n_tok / wall:.2f} "
          f"generated tokens/s; decode {dec_ms:.1f} ms per step (median of "
          f"{len(eng.decode_ms)}: min {min(eng.decode_ms):.1f}, max "
          f"{max(eng.decode_ms):.1f}; {len(full)} steps with all "
          f"{ENGINE_SLOTS} slots live, median "
          f"{statistics.median(full) if full else float('nan'):.1f}); prefill "
          f"{pre_ms:.1f} ms per request (median; min {min(eng.prefill_ms):.1f}"
          f", max {max(eng.prefill_ms):.1f}); TTFT median "
          f"{statistics.median(ttft):.0f} ms, max {max(ttft):.0f} ms")
    print(f"  peak memory {peak:.2f} GiB; pool {pool / 1e9:.3f} GB "
          f"({eng.plan.n_pages} pages of {eng.plan.page_size}); free pages at "
          f"the end {eng.alloc.n_free}")
    check([r.tokens for r in res] == [r.tokens for r in res_g],
          "moe_engine: the timed run repeats the guarded run's greedy tokens")
    check([len(r.tokens) for r in res] == budgets,
          "moe_engine: every request met its budget")
    check(all(0 <= t < cfg.padded_vocab() for r in res for t in r.tokens),
          f"moe_engine: every token within the head's {cfg.padded_vocab()} "
          f"rows (the vocabulary padded to 256, as the reference's head; "
          f"random weights can pick a padding row)")
    eng.alloc.check_invariants()
    check(eng.alloc.n_free == eng.plan.n_pages - 1 == eng_g.alloc.n_free,
          f"moe_engine: all {eng.plan.n_pages - 1} pages came back")
    check(tot_g["detected"] == 0 and totals["detected"] == 0,
          "moe_engine: zero detections")
    check(not guard.hits and guard.allowed > 0,
          f"moe_engine: no library matmul / attention op dispatched but the "
          f"router's f32 product ({sorted(set(guard.hits))})")
    per = 4 * cfg.n_layers + 1
    calls = ENGINE_REQUESTS + steps
    expect = {**k1_launches(per * calls), **k5_launches(0),
              **k2_launches(cfg.n_layers * ENGINE_REQUESTS), **NO_FLASH_BWD,
              **k6_launches(cfg.n_layers * steps),
              "ft_gemm_grouped_sm90": 3 * cfg.n_layers * calls,
              "ft_gemm_grouped": 0, "tgmm_sm90": 0, "tgmm": 0,
              "naive_gemm": 0}
    check(launches == expect,
          f"moe_engine: launches K1 {per}, K7 {3 * cfg.n_layers} per prefill "
          f"and per decode step, K2 {cfg.n_layers} per prefill, K6 and its "
          f"combine {cfg.n_layers} per decode step (K2 and K6 on the tensor "
          f"cores), K5 and K8 none")
    # Where a decode step's time goes: one decode step with every slot live
    # under torch.profiler, on the grouped kernels' tensor-core instances
    # and on their SIMT instances (the kernels before the redesign).
    prof = {}
    for name, pin in (("tensor cores", contextlib.nullcontext()),
                      ("SIMT", simt_grouped()), ("SIMT K6", simt_decode())):
        with pin:
            eng_p = ProbeEngine(params, cfg, run, ec)
            for p_, m in zip(prompts[:ENGINE_SLOTS], budgets[:ENGINE_SLOTS]):
                eng_p.submit(p_, max_new_tokens=m)
            eng_p.step()                 # the admissions and a decode step
            prof[name] = device_profile(eng_p.step)
            del eng_p
        print(f"  profiled decode step ({name}): {prof[name]}")
    print(json.dumps({"moe_engine": dict(
        arch=cfg.arch_id, layers=cfg.n_layers, slots=ENGINE_SLOTS,
        requests=ENGINE_REQUESTS, max_len=ENGINE_MAX_LEN,
        page=eng.plan.page_size, seed=seed,
        prompt_lens=[len(p_) for p_ in prompts], budgets=budgets,
        decode_steps=steps, run_s=wall, guarded_run_s=wall_g,
        generated_tokens=n_tok, tokens_per_s=n_tok / wall,
        decode_ms_median=dec_ms, decode_ms=eng.decode_ms,
        decode_ms_all_slots_median=statistics.median(full) if full else None,
        prefill_ms_median=pre_ms, prefill_ms=eng.prefill_ms,
        ttft_ms_median=statistics.median(ttft), ttft_ms_max=max(ttft),
        peak_gib=peak, pool_bytes=pool, free_pages=eng.alloc.n_free,
        launches=launches, profile=prof, card=smi)}))
    return launches


def phase_moe_train(smi: str):
    cfg = dataclasses.replace(MOE, n_layers=MOE_TRAIN_LAYERS)
    print(f"  depth cut: {cfg.n_layers} of {MOE.n_layers} layers (bf16 "
          f"params and grads with f32 AdamW moments: 12 bytes a parameter)")
    run = RunConfig(model=cfg, ft=FT, dtype="bfloat16", remat="full")
    tc = train_loop.TrainConfig(log_every=1)
    shape = ShapeConfig("chip_smoke_moe", TRAIN_SEQ, TRAIN_BATCH, "train")
    per_step = []

    def log(msg):
        per_step.append({n: k["counter"].launches
                         for n, k in KERNELS.items()})
        print(f"  {msg}", flush=True)

    torch.cuda.reset_peak_memory_stats()
    for k in KERNELS.values():
        k["counter"].launches = 0
    t0 = time.perf_counter()
    with telemetry.ft_scope() as scope:
        out = train_loop.train(cfg, run, shape, tc, log=log, device="cuda",
                               stop_at=TRAIN_STEPS)
    wall = time.perf_counter() - t0
    sites = {s: t for s, t in scope.site_totals().items() if t["detected"]}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    prev = {n: 0 for n in KERNELS}
    launches = []
    for snap in per_step:
        launches.append({n: snap[n] - prev[n] for n in KERNELS})
        prev = snap
    times = [x * 1e3 for x in out["step_times"]]
    step_ms = statistics.median(times[1:])
    tokens = TRAIN_BATCH * TRAIN_SEQ
    n_params = sum(p.numel() for p in out["params"].parameters())
    losses = [h["loss"] for h in out["history"]]
    auxes = [h["aux"] for h in out["history"]]
    print(f"  {n_params / 1e9:.2f} B parameters; steps "
          f"{[round(x, 1) for x in times]} ms, median of steps "
          f"1-{TRAIN_STEPS - 1} {step_ms:.1f} ms ({tokens / step_ms * 1e3:.1f} "
          f"tokens/s); train() wall {wall:.1f} s with init; peak memory "
          f"{peak:.1f} GiB")
    print(f"  losses {losses}; aux {auxes}; FT counters per step "
          f"{[(h['detected'], h['corrected']) for h in out['history']]}; "
          f"sites with detections {sites}")
    print(f"  launches per step {launches}")
    check(len(losses) == TRAIN_STEPS and all(math.isfinite(x) for x in losses)
          and all(math.isfinite(x) and x > 0 for x in auxes),
          "moe_train: a finite loss and aux at every step")
    check(all(h["detected"] == 0 for h in out["history"]),
          "moe_train: zero detections")
    n_l = cfg.n_layers
    # Per layer: K1 4 attention projections forward, again in the remat
    # recompute, and dx + dw each in the backward (16), lm_head 3; K7 3
    # expert GEMMs forward, in the recompute and as dbuf (9); K8 3 dw.
    expect = {**k1_launches(16 * n_l + 3), **k5_launches(0),
              **k2_launches(2 * n_l), **flash_bwd_launches(cfg, n_l),
              **k6_launches(0), "ft_gemm_grouped_sm90": 9 * n_l,
              "ft_gemm_grouped": 0, "tgmm_sm90": 3 * n_l, "tgmm": 0,
              "naive_gemm": 0}
    check(all(x == expect for x in launches),
          f"moe_train: launches per step {expect} at every step")
    opt_cfg = adamw.AdamWConfig(lr=run.learning_rate,
                                weight_decay=run.weight_decay,
                                grad_clip=run.grad_clip)
    step_fn = train_loop.make_train_step(cfg, run, opt_cfg, tc)
    pipe = data_lib.for_model(cfg, shape, seed=run.seed)
    batch = {k: torch.as_tensor(x, dtype=torch.long, device="cuda")
             for k, x in pipe.batch_at(TRAIN_STEPS).items()}
    for k in KERNELS.values():
        k["counter"].launches = 0
    guard = LibraryCallGuard(allow=router_product(cfg.moe.n_experts))
    with guard:
        _, _, metrics = step_fn(out["params"], out["opt_state"], batch,
                                TRAIN_STEPS)
        torch.cuda.synchronize()
    guarded = {n: k["counter"].launches for n, k in KERNELS.items()}
    print(f"  guarded step: loss {float(metrics['loss']):.4f}, launches "
          f"{guarded}, router products allowed {guard.allowed}")
    check(not guard.hits and guard.allowed == 4 * n_l,
          f"moe_train: no library matmul / attention op dispatched but the "
          f"router's product in the forward, in the remat recompute and "
          f"its two backward products ({sorted(set(guard.hits))})")
    check(guarded == expect, f"moe_train: guarded step launches {guarded}")
    # Where the step's time goes: one more step under torch.profiler on the
    # tensor-core instances, then one with K7 and K8 on their SIMT ones, then
    # one with K3 and K4 on theirs.
    prof = {}
    for i, (name, pin) in enumerate((
            ("tensor cores", contextlib.nullcontext()),
            ("SIMT K7 / K8", simt_grouped()),
            ("SIMT K3 / K4", simt_flash_bwd()))):
        with pin:
            prof[name] = device_profile(lambda: step_fn(
                out["params"], out["opt_state"], batch, TRAIN_STEPS + 1 + i))
        print(f"  profiled step ({name}): {prof[name]}")
    print(json.dumps({"moe_train": dict(
        arch=cfg.arch_id, layers=n_l, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
        steps=TRAIN_STEPS, step_ms=times, median_step_ms=step_ms,
        tokens_per_s=tokens / step_ms * 1e3, peak_gib=peak, losses=losses,
        aux=auxes, launches_per_step=launches[-1], profile=prof,
        card=smi)}))
    return guarded


# ---------------------------------------------------------------------------
# level_kernels: the tile and inner levels of training and MoE (K1 with
# act_grad and on the dw walk, K7 on both walks, K8) on their tensor-core
# instances, the SIMT ones pinned beside them
# ---------------------------------------------------------------------------

#: A campaign triple for the two-band checks: at rate 1.0 every block draws
#: one SEU, and a deterministic SEU aimed at another band of one block in
#: the same interval makes two SEUs in two bands of that block.
BAND_TRIPLE = (1, 20260417, 77)


def _timed(fn):
    """(fn(), its CUDA-event time in ms) of one call."""
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    out = fn()
    t1.record()
    t1.synchronize()
    return out, t0.elapsed_time(t1)


def _next_band(r: int, band: int, rows: int) -> int:
    """The row at r's offset in the next band (cyclically) of a block of
    ``rows`` rows."""
    return ((r // band + 1) % (rows // band)) * band + r % band


def _first(x):
    """C of a K1 call's output (C, or (C, act_grad))."""
    return x[0] if isinstance(x, tuple) else x


def _same(a, b) -> bool:
    if isinstance(a, tuple):
        return all(torch.equal(x, y) for x, y in zip(a, b))
    return torch.equal(a, b)


@dataclasses.dataclass
class _LevelCase:
    """One instance at one training / MoE shape. ``call(ft, simt=False,
    **kw)`` runs the wrapper (``simt`` pins the SIMT tiles at block, the
    like-for-like row), ``plain(ft, **kw)`` the plain version under the
    plan; ``ints`` the same case on integer-valued operands; ``seu`` the
    deterministic SEU (inj, magnitude, (row, col)) of the integer case;
    ``band_seu(ft)`` the (inj, report index, rows, cols) of a deterministic
    SEU in another band of a block that the campaign at rate 1.0 hits in
    the same interval (None: no block of the case has two bands); ``bands``
    the (inj, (row, col)) of an SEU in each 16-row band of one block of the
    integer case (tensor-core level instances); ``live`` the report rows to
    compare (K8: live groups); ``sm90``: the plan runs the level on the
    tensor cores, and ``call(ft, simt_=True)`` pins the SIMT instance at
    the level too (the SIMT kernel at the level, timed beside it);
    ``pinned(ft)``: the plain version under the pinned SIMT tiles, against
    which that SIMT call is held too, its row ``simt_name``."""
    label: str
    name: str
    counter: object
    call: object
    plain: object
    lib: object
    lib_label: str
    flops: float
    nbytes: float
    iters: int
    ints: object = None
    seu: object = None
    band_seu: object = None
    bands: object = None
    live: object = None
    sm90: bool = False
    pinned: object = None
    simt_name: str = ""


def _level_k1_cases(gen):
    """K1's w_gate + silu with act_grad and its dw on the transposed-A walk
    at phi4-mini-3.8b's training shapes (2 x 512 tokens)."""
    cfg = phi4_mini_38b.CONFIG
    m, d, dff = TRAIN_BATCH * TRAIN_SEQ, cfg.d_model, cfg.d_ff
    simt = ft_gemm.pick_tiles(m)
    tiles = ft_gemm.SM90_TILES[0]          # the plan's, both cases

    def gate(make):
        a, b = make((m, d), 1.0), make((d, dff), 0.02)

        def call(ft, simt_=False, **kw):
            return ft_gemm.ft_gemm(a, b, chain=("silu",), ft=ft,
                                   save_act_grad=True,
                                   tiles=simt if simt_ else None, **kw)

        def plain(ft, **kw):
            return ft_gemm.planned_plain(a, b, chain=("silu",), ft=ft,
                                         save_act_grad=True, **kw)
        return a, b, call, plain

    def dw(make):
        x, g = make((m, d), 1.0), make((m, dff), 1.0)
        a = x.t()                      # unit stride along m: LAYOUT 2

        def call(ft, simt_=False, **kw):
            return ft_gemm.ft_gemm(a, g, ft=ft,
                                   tiles=ft_gemm.pick_tiles(d) if simt_
                                   else None, **kw)

        def plain(ft, **kw):
            return ft_gemm.planned_plain(a, g, ft=ft, **kw)
        return a, g, call, plain

    def rnd(shape, scale):
        return _rand(gen, *shape, scale=scale)

    def ints(shape, scale):
        return _ints(gen, *shape)

    cases = []
    for label, build_, (mm, nn, kk), nout in (
            (f"train w_gate+silu act_grad {m}x{dff}x{d}", gate, (m, dff, d),
             2),
            (f"train dw w_gate x.T {d}x{dff}x{m}", dw, (d, dff, m), 1)):
        a, b, call, plain = build_(rnd)
        ai, bi, call_i, plain_i = build_(ints)
        check(ft_gemm.plan_call(a, b, ft=FT.replace(level="tile")).tiles
              == tiles, f"{label}: the tensor-core plan at the levels")
        bm, bn, bk = tiles
        row, col, step = mm - 1, nn - 3, ft_gemm.cdiv(kk, bk) // 2

        def bands(bm=bm, bn=bn, kk=kk):
            gk = ft_gemm.cdiv(kk, 256)
            out = []
            for q in range(bm // 16):   # block (1, 1)
                r, c = bm + 16 * q + (3 * q + 1) % 16, bn + 5 * q
                out.append(((1, -1, r, c, (q * gk) // (bm // 16)), (r, c)))
            return out

        def band_seu(ft, tiles=tiles, mm=mm, nn=nn, kk=kk):
            gm, gn, gk = (ft_gemm.cdiv(mm, tiles[0]), ft_gemm.cdiv(nn, tiles[1]),
                          ft_gemm.cdiv(kk, tiles[2]))
            _, st, r, c = ft_gemm.seu_draws(BAND_TRIPLE, ft, 1, gm, gn, gk,
                                            tiles, False)
            i, j = 1, 1
            r2 = i * tiles[0] + _next_band(int(r[0, i, j]),
                                           ft_gemm.band_of(tiles), tiles[0])
            c2 = j * tiles[1] + (int(c[0, i, j]) + 1) % tiles[1]
            return ((1, -1, r2, c2, int(st[0, i, j])), (i, j),
                    slice(i * tiles[0], (i + 1) * tiles[0]),
                    slice(j * tiles[1], (j + 1) * tiles[1]))

        cases.append(_LevelCase(
            label=label, name="ft_gemm_level_sm90",
            counter=ft_gemm.FT_GEMM_LEVEL_SM90, call=call, plain=plain,
            lib=(lambda a=a, b=b: torch.matmul(a, b)), lib_label="torch.matmul",
            flops=2.0 * mm * nn * kk,
            nbytes=2 * (mm * kk + kk * nn + nout * mm * nn), iters=3,
            ints=(call_i, plain_i), seu=((1, -1, row, col, step), 1000.0,
                                         (row, col)),
            band_seu=band_seu, bands=bands, sm90=True))
    return cases


def _level_moe_cases(gen):
    """K7 at the engine's decode gate and the training dbuf product (the wᵀ
    view, LAYOUT 1), K8 at the training dw gate, at qwen3-moe-235b-a22b's
    shapes (128 experts, d 4 096, expert d_ff 1 536)."""
    d, f = MOE.d_model, MOE.moe.expert_d_ff
    e, top_k = MOE.moe.n_experts, MOE.moe.top_k
    dec_rows = ENGINE_SLOTS * top_k
    train_rows = TRAIN_BATCH * TRAIN_SEQ * top_k
    bm = kgrouped.plan_grouped(dec_rows, f, d, torch.bfloat16,
                               n_groups=e)[0]
    cases = []
    for label, n_rows, transpose in (
            (f"decode gate {dec_rows} rows {d}->{f}", dec_rows, False),
            (f"train dbuf gate {train_rows} rows {f}->{d} (w^T view)",
             train_rows, True)):
        lay = _moe_layout(gen, n_rows, bm)
        k, n = (f, d) if transpose else (d, f)
        tiles = (bm, 128, 32)                  # the SIMT instance's
        k7 = grouped_gemm.SM90_GROUPED_TILES   # the plan's

        def build_(make, lay=lay, k=k, n=n, n_rows=n_rows,
                   transpose=transpose, tiles=tiles):
            w = make(e, d, f)
            w = w.transpose(-1, -2) if transpose else w
            buf = kgrouped.scatter_rows(make(n_rows, k), lay)
            args = (buf, w, lay.gid, lay.row_end)

            def call(ft, simt_=False, **kw):
                return grouped_gemm.ft_gemm_grouped(
                    *args, ft=ft, tiles=tiles if simt_ else None, **kw)

            def plain(ft, **kw):
                return grouped_gemm.planned_grouped_plain(*args, ft=ft, **kw)
            return buf, w, call, plain

        buf, w, call, plain = build_(lambda *s: _rand(gen, *s, scale=0.02
                                                      if len(s) == 3
                                                      else 1.0))
        ints = build_(lambda *s: _ints(gen, *s))[2:]
        live_rows, live_e = _live(lay)
        lib, lib_label = _library_grouped(buf, w, lay)
        check(grouped_gemm.plan_k7_call(buf, w, lay.gid,
                                        ft=FT.replace(level="tile")).tiles
              == k7, f"{label}: the tensor-core plan at the levels")
        grp = e - 1                                  # the ragged last group
        row, col = int(lay.row_end[grp]) - 1, n - 5
        step = ft_gemm.cdiv(k, 256) // 2
        # the first 64-row chunk of the largest group: its four bands
        big = int(torch.argmax(lay.counts))
        i0 = int(lay.base[big]) // bm
        four = int(lay.counts[big]) >= 64

        def band_seu(ft, lay=lay, k=k, n=n, i=i0):
            """Tile i's campaign SEU and one in another tile (band) of its
            chunk whose own SEU falls in another k-step."""
            gn, gk = ft_gemm.cdiv(n, 128), ft_gemm.cdiv(k, 256)
            _, st, r, c = grouped_gemm.seu_tile_draws(
                BAND_TRIPLE, ft, lay.num_tiles, gn, gk, k7, "cuda")
            t, j = next((q, j) for j in (1, 0) for q in (i + 1, i + 2, i + 3)
                        if int(st[q, j]) != int(st[i, j]))
            r2 = t * bm + int(r[i, j])
            c2 = j * 128 + (int(c[i, j]) + 1) % 128
            return ((1, r2, c2, int(st[i, j])), (t, j),
                    slice(t * bm, (t + 1) * bm), slice(j * 128, (j + 1) * 128))

        def bands(k=k, i=i0):
            gk = ft_gemm.cdiv(k, 256)
            out = []
            for q in range(4):
                r, c = (i + q) * bm + (3 * q + 1) % bm, 128 + 5 * q
                out.append(((1, r, c, q * gk // 4), (r, c)))
            return out

        cases.append(_LevelCase(
            label=label, name="ft_gemm_grouped_sm90",
            counter=grouped_gemm.FT_GEMM_GROUPED_SM90, call=call, plain=plain,
            lib=lib, lib_label=lib_label, flops=2.0 * live_rows * n * k,
            nbytes=2 * (live_rows * k + live_e * k * n + live_rows * n),
            iters=10 if n_rows == dec_rows else 3, ints=ints,
            seu=((1, row, col, step), 1000.0, (row, col)),
            band_seu=band_seu if four else None, bands=bands if four else None,
            sm90=True))
    # K8 at the training dw of the gate: dw (128, 4 096, 1 536) f32
    lay = _moe_layout(gen, train_rows, bm)
    tiles = (bm, 64, 64)                       # the SIMT instance's
    k8 = grouped_gemm.SM90_TGMM_TILES          # the plan's
    _, bn, bk = k8

    def build8(make, scale):
        x = kgrouped.scatter_rows(make(train_rows, d, 1.0), lay)
        g = kgrouped.scatter_rows(make(train_rows, f, scale), lay)

        def call(ft, simt_=False, **kw):
            return grouped_gemm.tgmm(x, g, lay.row_end, bm=bm, ft=ft,
                                     tiles=tiles if simt_ else None, **kw)

        def plain(ft, **kw):
            return grouped_gemm.planned_tgmm_plain(x, g, lay.row_end, bm=bm,
                                                   ft=ft, **kw)
        return x, g, call, plain

    x, g, call, plain = build8(lambda *s: _rand(gen, *s[:-1], scale=s[-1]),
                               1e-3)
    ints = build8(lambda *s: _ints(gen, *s[:-1]), 1.0)[2:]
    live_rows, live_e = _live(lay)
    lib, lib_label, _ = _library_tgmm(x, g, lay)
    check(grouped_gemm.plan_k8_call(x, g, bm, ft=FT.replace(level="tile"))
          .tiles == k8, "K8 train dw: the tensor-core plan at the levels")
    tile = (int(lay.row_end[e - 1]) - 1) // bm     # the ragged last tile
    first, _, re = grouped_gemm._group_span(lay.row_end, bm, lay.num_tiles)
    grp0 = int(torch.nonzero(lay.counts > 0)[0])   # the first live group
    n0 = (int(lay.counts[grp0]) + bm - 1) // bm

    def band_seu(ft):
        gk, gn = ft_gemm.cdiv(d, bk), ft_gemm.cdiv(f, bn)
        _, st, r, c = grouped_gemm.seu_dw_draws(
            BAND_TRIPLE, ft, (re - first * bm).clamp_min(0), gk, gn, k8)
        ki, nj = 1, 1
        r2 = ki * bk + _next_band(int(r[grp0, ki, nj]),
                                  ft_gemm.band_of(k8, "tgmm"), bk)
        c2 = nj * bn + (int(c[grp0, ki, nj]) + 1) % bn
        return ((1, r2, c2, int(first[grp0]) + int(st[grp0, ki, nj])),
                (grp0, ki, nj), (grp0, slice(ki * bk, (ki + 1) * bk)),
                slice(nj * bn, (nj + 1) * bn))

    def bands():
        """An SEU in each 16-row band of dw block (1, 1) of the first live
        group, over its stages, and one in the last group's dead tail."""
        out = []
        for q in range(bk // 16):
            r, c = bk + 16 * q + (3 * q + 1) % 16, bn + 5 * q
            out.append(((1, r, c, int(first[grp0]) + q * n0 // 8), (r, c)))
        return out + [((1, 5, 9, lay.num_tiles - 1), (5, 9))]

    cases.append(_LevelCase(
        label=f"train dw gate {train_rows} rows -> ({e}, {d}, {f}) f32",
        name="tgmm_sm90", counter=grouped_gemm.TGMM_SM90, call=call,
        plain=plain, lib=lib, lib_label=lib_label,
        flops=2.0 * live_rows * d * f,
        nbytes=2 * live_rows * (d + f) + 4 * e * d * f, iters=3, ints=ints,
        seu=((1, d - 1, min(700, f - 1), tile), 500.0,
             (d - 1, min(700, f - 1))),
        band_seu=band_seu, bands=bands, live=lay.counts > 0, sm90=True,
        pinned=lambda ft: grouped_gemm.tgmm_plain(x, g, lay.row_end,
                                                  tiles=tiles, ft=ft),
        simt_name="tgmm"))
    return cases


def _level_case(c: _LevelCase, rows):
    """One instance at tile and inner against its plain version under the
    same plan: max error, reports equal, no detection on clean data;
    CUDA-event times beside the SIMT instance at block (and, where the
    plan takes the level to the tensor cores, pinned at the same level),
    the tensor-core block call and the library call; on integer-valued
    operands an SEU corrected bit for bit and located and left by
    detect-only (at inner counted once), one in each band of a block, and
    at tile two SEUs in two bands of one block in one interval, both
    corrected."""
    live = c.live if c.live is not None else Ellipsis
    where = "tensor-core level" if c.sm90 else "SIMT"
    block_ms = time_ms(lambda: c.call(FT, simt_=True), c.iters)
    sm90_ms = time_ms(lambda: c.call(FT), c.iters)
    off_ms = time_ms(lambda: c.call(None), c.iters)
    lib_ms = time_ms(c.lib, c.iters)
    b_ms, b_by = bound(c.flops, c.nbytes)
    for level in LEVELS:
        ft = FT.replace(level=level)
        (out, rep), nl = _launched(c.counter, lambda: c.call(ft))
        check(nl == 1, f"{level} {c.label}: one launch of the {where} "
                       f"instance (the plan's rule)")
        (out_p, rep_p), plain_ms = _timed(lambda: c.plain(ft))
        pairs = (zip(("C", "act_grad"), out, out_p)
                 if isinstance(out, tuple) else [("out", out, out_p)])
        err = max(_cmp_outputs(f"{level} {c.label} {what}", got, want,
                               rep[live], rep_p[live])
                  for what, got, want in pairs)
        del out_p, rep_p
        ms = time_ms(lambda: c.call(ft), c.iters)
        simt = {}
        if c.sm90:
            simt["simt_ms"] = time_ms(lambda: c.call(ft, simt_=True),
                                      max(c.iters // 3, 1), warmup=1)
        if c.pinned is not None:
            # the SIMT instance at the level against its own plain version
            out_s, rep_s = c.call(ft, simt_=True)
            (out_sp, rep_sp), pinned_ms = _timed(lambda: c.pinned(ft))
            err_s = _cmp_outputs(f"{level} {c.label} SIMT", out_s, out_sp,
                                 rep_s[live], rep_sp[live])
            del out_s, out_sp
            r = rows[c.simt_name]
            r["max_abs_err"] = max(r["max_abs_err"], err_s)
            r["detail"].append(dict(
                shape=f"{c.label} ({level})", level=level,
                ms=simt["simt_ms"], plain_ms=pinned_ms,
                library_ms=lib_ms, library=c.lib_label, bound_ms=b_ms,
                bound_by=b_by))
        rows[c.name]["max_abs_err"] = max(rows[c.name]["max_abs_err"], err)
        rows[c.name]["detail"].append(dict(
            shape=f"{c.label} ({level})", level=level, ms=ms,
            block_ms=block_ms, block_sm90_ms=sm90_ms, ft_off_ms=off_ms,
            plain_ms=plain_ms,
            library_ms=lib_ms, library=c.lib_label, bound_ms=b_ms,
            bound_by=b_by, **simt))
        print(f"  {level} {c.label}: {where} {ms:.4f} ms "
              f"({ms / sm90_ms:.3f}x the tensor-core block {sm90_ms:.4f}; "
              f"FT off {off_ms:.4f}; SIMT block {block_ms:.4f}"
              + (f"; SIMT {level} {simt['simt_ms']:.4f}" if simt else "")
              + f"), library {lib_ms:.4f} ms ({c.lib_label}), "
              f"bound {b_ms:.5f} ms ({b_by}), plain {plain_ms:.1f} ms")
    call_i, plain_i = c.ints
    inj, mag, (row, col) = c.seu
    for level in LEVELS:
        ft = FT.replace(level=level)
        clean, rep0 = call_i(ft)
        check(float(rep0[..., 0].sum()) == 0.0,
              f"{level} {c.label}: integer operands, clean run undetected")
        fixed, rep = call_i(ft, inj=inj, inj_mag=mag)
        cells = rep[rep[..., 0] > 0]
        check(_same(fixed, clean) and float(rep[..., 0].sum()) == 1.0
              and float(rep[..., 1].sum()) == 1.0
              and int(cells[0, 2]) == row and int(cells[0, 3]) == col
              and abs(float(cells[0, 4]) - mag) < 1e-2,
              f"{level} {c.label}: SEU {inj} corrected bit for bit and "
              f"located")
        left, rep_d = call_i(ft.replace(action="detect"), inj=inj,
                             inj_mag=mag)
        diff = (_first(left) != _first(clean)).nonzero()
        n_det = float(rep_d[..., 0].sum())
        check(diff.shape[0] == 1 and tuple(diff[0, -2:].tolist()) ==
              (row, col) and n_det >= 1.0
              and float(rep_d[..., 1].sum()) == 0.0
              and (level == "tile" or not c.sm90 or n_det == 1.0),
              f"{level} {c.label}: the same SEU left in place by a "
              f"detect-only policy ({n_det:.0f} detections)")
        for inj_b, (rb, cb) in (c.bands() if c.bands else ()):
            fixed, rep = call_i(ft, inj=inj_b, inj_mag=mag)
            cells = rep[rep[..., 0] > 0]
            check(_same(fixed, clean) and float(rep[..., 0].sum()) == 1.0
                  and float(rep[..., 1].sum()) == 1.0
                  and (int(cells[0, 2]), int(cells[0, 3])) == (rb, cb),
                  f"{level} {c.label}: SEU {inj_b} in its band corrected "
                  f"bit for bit and located")
        if level != "tile" or c.band_seu is None:
            continue
        ftc = ft.replace(inject_rate=1.0)
        inj2, cell, rs, cs = c.band_seu(ftc)
        kw = dict(inj=inj2, inj_mag=mag, rng=BAND_TRIPLE)
        fixed, rep = call_i(ftc, **kw)
        _, rep_p = plain_i(ftc, **kw)
        ok = torch.equal(rep[live][..., :4], rep_p[live][..., :4])
        check(_same(fixed, clean) and ok
              and float(rep[cell][0]) == float(rep[cell][1]) == 2.0,
              f"tile {c.label}: a campaign at rate 1.0 and an SEU in another "
              f"band of block {cell} at the same interval ({inj2}): both "
              f"corrected ({float(rep[cell][1]):.0f} in that block, "
              f"{float(rep[..., 1].sum()):.0f} in all), reports as the "
              f"plain version's")
        left, _ = call_i(ftc.replace(action="detect"), **kw)
        moved = int((_first(left)[rs][..., cs] != _first(clean)[rs][..., cs])
                    .sum())
        check(moved >= 2, f"tile {c.label}: detect-only leaves both SEUs of "
                          f"that block ({moved} elements moved)")


def _level_training_kernels(gen):
    """The new instances of this slice: K1 with act_grad and on the dw walk
    at phi4-mini's training shapes, K7 (decode gate, training dbuf) and K8
    (training dw) at qwen3-moe's, each at tile and inner."""
    rows = {n: dict(max_abs_err=0.0, detail=[])
            for n in ("ft_gemm_level_sm90", "ft_gemm_grouped_sm90",
                      "tgmm_sm90", "tgmm")}
    for c in _level_k1_cases(gen):
        _level_case(c, rows)
        torch.cuda.empty_cache()
    for c in _level_moe_cases(gen):
        _level_case(c, rows)
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# level_train / level_moe: the training and MoE paths at tile and inner
# ---------------------------------------------------------------------------

#: steps of each level_train / level_moe training run (step 0 has lr 0)
LEVEL_TRAIN_STEPS = 3
#: the w_gate campaign of level_train's SEU check: the rate per output
#: block (256 forward w_gate blocks on the tensor cores at 2 layers x 256
#: tokens, and the backward's)
LEVEL_GATE_RATE = 1e-2


def _train_run(cfg, run, shape, steps, label):
    """`train_loop.train` on the card for ``steps`` steps with the launch
    counters zeroed first: (out, per-step launch counts, step times in ms,
    FT sites with a detection, peak GiB)."""
    tc = train_loop.TrainConfig(log_every=1)
    per_step = []

    def log(msg):
        per_step.append({n: k["counter"].launches
                         for n, k in KERNELS.items()})
        print(f"  {label}: {msg}", flush=True)

    torch.cuda.reset_peak_memory_stats()
    for k in KERNELS.values():
        k["counter"].launches = 0
    with telemetry.ft_scope() as scope:
        out = train_loop.train(cfg, run, shape, tc, log=log, device="cuda",
                               stop_at=steps)
    sites = {s: t for s, t in scope.site_totals().items() if t["detected"]}
    prev = {n: 0 for n in KERNELS}
    launches = []
    for snap in per_step:
        launches.append({n: snap[n] - prev[n] for n in KERNELS})
        prev = snap
    times = [x * 1e3 for x in out["step_times"]]
    return (out, launches, times, sites,
            torch.cuda.max_memory_allocated() / 2 ** 30)


def _profile_step(cfg, run, shape, out, step):
    """One more train step of ``out``'s params under torch.profiler."""
    tc = train_loop.TrainConfig(log_every=1)
    opt_cfg = adamw.AdamWConfig(lr=run.learning_rate,
                                weight_decay=run.weight_decay,
                                grad_clip=run.grad_clip)
    step_fn = train_loop.make_train_step(cfg, run, opt_cfg, tc)
    pipe = data_lib.for_model(cfg, shape, seed=run.seed)
    batch = {k: torch.as_tensor(x, dtype=torch.long, device="cuda")
             for k, x in pipe.batch_at(step).items()}
    return device_profile(lambda: step_fn(out["params"], out["opt_state"],
                                          batch, step))


def _rel_err(grads, ref):
    """The worst leaf's relative Frobenius distance of grads from ref."""
    return max(((grads[n].float() - ref[n].float()).norm()
                / ref[n].float().norm().clamp_min(1e-30)).item()
               for n in ref)


def _seu_rule(label, clean, hurt, left):
    """train_check's rule: the corrected grads within 1e-3 worst-leaf
    relative error of the clean ones, detect-only at least 100x further."""
    fixed, kept = _rel_err(hurt, clean), _rel_err(left, clean)
    check(fixed <= 1e-3 and kept >= 100 * max(fixed, 1e-6),
          f"{label} corrected: grads as the clean run's (worst leaf "
          f"relative error {fixed:.3g}), detect-only leaves it ({kept:.3g})")


@contextmanager
def act_grad_calls(into: list):
    """Record every K1 call that saves act_grad (the MLP gate's forward,
    and its recomputation under remat) into ``into``: its operands, its
    output and act_grad, and its report."""
    inner = ft_gemm.ft_gemm

    def gemm(a, b, **kw):
        res, rep = inner(a, b, **kw)
        if kw.get("save_act_grad"):
            into.append(tuple(None if t is None else t.detach().clone()
                              for t in (a, b, res[0], res[1], rep)))
        return res, rep

    ft_gemm.ft_gemm = gemm
    try:
        yield
    finally:
        ft_gemm.ft_gemm = inner


def _bf16_ulps(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """|x - y| of two bf16 tensors in bf16 ulps: the distance of their
    bit patterns in sign-magnitude order (across zero too)."""
    def ordered(t):
        i = t.view(torch.int16).int()
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return (ordered(x) - ordered(y)).abs()


def _call_rule(label, clean_calls, hurt_calls):
    """Each act_grad K1 call of the campaign run whose operands equal the
    clean run's: its output and act_grad equal the clean call's bit for
    bit, but at the cells its report says it corrected, where they may
    be one bf16 ulp off (or within the block's tau): the f32 correction
    restores the element to within f32 rounding at the SEU's size, and
    the bf16 store then rounds to the clean value or to its neighbour.
    Returns the number of corrected cells whose output moved."""
    check(len(clean_calls) == len(hurt_calls) > 0,
          f"{label}: the same act_grad K1 calls in both runs "
          f"({len(clean_calls)}, {len(hurt_calls)})")
    same = fixed = moved = worst = 0
    ok = True
    for (a0, b0, y0, g0, _), (a1, b1, y1, g1, rep) in zip(clean_calls,
                                                          hurt_calls):
        if not (torch.equal(a0, a1) and torch.equal(b0, b1)):
            continue
        same += 1
        bm = ft_gemm.cdiv(y0.shape[0], rep.shape[0])
        bn = ft_gemm.cdiv(y0.shape[1], rep.shape[1])
        hit = rep[..., 1] > 0
        fixed += int(hit.sum())
        cells = torch.zeros_like(y0, dtype=torch.bool)
        cells[rep[..., 2][hit].long(), rep[..., 3][hit].long()] = True
        tau = rep[..., 6].repeat_interleave(bm, 0)[:y0.shape[0]]
        tau = tau.repeat_interleave(bn, 1)[:, :y0.shape[1]]
        for x0, x1 in ((y0, y1), (g0, g1)):
            off = x0 != x1
            ulps = _bf16_ulps(x0, x1)
            near = (ulps <= 1) | ((x0.float() - x1.float()).abs() <= tau)
            ok &= bool((cells | ~off).all()) and bool((near | ~off).all())
            worst = max(worst, int(ulps.max()))
        moved += int(((y0 != y1) | (g0 != g1))[cells].sum())
    check(same > 0 and ok,
          f"{label}: {same} act_grad K1 calls with the clean run's operands "
          f"give its output and act_grad bit for bit but at the {fixed} "
          f"corrected cells, {moved} of which moved (largest move "
          f"{worst} bf16 ulps)")
    return moved


def _campaign_rule(label, hurt, left, plain_fixed, clean):
    """A campaign's grads on real-valued operands: the corrected grads
    against the plain versions' correction of the same draws within 2e-2
    worst-leaf relative error (train_check's limit for the kernels
    against the plain versions on this model and batch), detect-only at
    least 10x further. (A corrected element may come out one bf16 ulp
    from the clean run's, `_call_rule`, and bf16 backprop spreads that
    to every leaf; the distance to the clean grads is printed.)"""
    fixed, kept = _rel_err(hurt, plain_fixed), _rel_err(left, plain_fixed)
    check(fixed <= 2e-2 and kept >= 10 * fixed,
          f"{label} corrected: grads as the plain versions' correction of "
          f"the same draws (worst leaf relative error {fixed:.3g}; "
          f"{_rel_err(hurt, clean):.3g} from the clean grads), detect-only "
          f"leaves it ({kept:.3g})")


def phase_level_train(smi: str):
    """phi4-mini-3.8b trained at full width and depth at tile and inner
    (and at block from the same seed, for the losses), then SEUs in a dw
    and in w_gate's forward at 2 layers."""
    cfg = phi4_mini_38b.CONFIG
    shape = ShapeConfig("chip_smoke", TRAIN_SEQ, TRAIN_BATCH, "train")
    n_l = cfg.n_layers
    launches = {n: 0 for n in KERNELS}
    summary, losses = {}, {}
    for level in ("block",) + LEVELS:
        run = RunConfig(model=cfg, ft=FT.replace(level=level),
                        dtype="bfloat16", remat="full")
        out, per, times, sites, peak = _train_run(
            cfg, run, shape, LEVEL_TRAIN_STEPS, f"level_train {level}")
        losses[level] = [h["loss"] for h in out["history"]]
        step_ms = statistics.median(times[1:])
        print(f"  {level}: steps {[round(x, 1) for x in times]} ms, median "
              f"of steps 1-{LEVEL_TRAIN_STEPS - 1} {step_ms:.1f} ms "
              f"({TRAIN_BATCH * TRAIN_SEQ / step_ms * 1e3:.1f} tokens/s), "
              f"peak {peak:.1f} GiB, losses {losses[level]}, FT counters "
              f"{[(h['detected'], h['corrected']) for h in out['history']]}, "
              f"sites with detections {sites}")
        print(f"  {level} launches per step {per[-1]}")
        check(all(math.isfinite(x) for x in losses[level])
              and all(h["detected"] == 0 for h in out["history"]),
              f"level_train {level}: finite losses, zero detections")
        expect = {**k1_launches(28 * n_l + 3, level), **k5_launches(0),
                  **k2_launches(2 * n_l), **flash_bwd_launches(cfg, n_l),
                  **k6_launches(0), **OFF_PATH}
        check(all(x == expect for x in per),
              f"level_train {level}: launches per step {expect} at every "
              f"step (K1 on the tensor cores)")
        if level != "block":
            for n in launches:
                launches[n] += sum(x[n] for x in per)
            prof = _profile_step(cfg, run, shape, out, LEVEL_TRAIN_STEPS)
            print(f"  {level} profiled step: {prof}")
            summary[level] = dict(step_ms=times, median_step_ms=step_ms,
                                  tokens_per_s=TRAIN_BATCH * TRAIN_SEQ
                                  / step_ms * 1e3, peak_gib=peak,
                                  losses=losses[level],
                                  launches_per_step=per[-1], profile=prof)
        del out
        torch.cuda.empty_cache()
    for level in LEVELS:
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses[level],
                                                     losses["block"]))
        check(rel <= 1e-2, f"level_train {level}: each step's loss within "
                           f"1e-2 relative of block's from the same seed "
                           f"(worst {rel:.3g}; bf16 outputs of f32 sums in "
                           f"other orders)")
    # SEUs at 2 layers x 256 tokens: a bwd_inject SEU in w_down's dw (the
    # transposed-A walk) and a campaign on w_gate (its forward act_grad
    # kernel and its backward GEMMs), each corrected at each level.
    cfg2 = dataclasses.replace(cfg, n_layers=CHECK_LAYERS)
    params = transformer.init(cfg2, seed=5, dtype=torch.bfloat16)
    params.requires_grad_(True)
    tok = torch.randint(0, cfg2.vocab_size, (1, CHECK_SEQ + 1),
                        generator=torch.Generator().manual_seed(5)).cuda()
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    dw_hook = ("w_down", ("dw", InjectionSpec(row=700, col=1000,
                                              magnitude=64.0, k_step=0)))

    def gate_campaign(ctx):
        return dataclasses.replace(
            ctx, ft=ctx.ft.replace(inject_rate=LEVEL_GATE_RATE),
            key=torch.Generator().manual_seed(11), inject_sites=("w_gate",))

    for level in LEVELS:
        ft = FT.replace(level=level)
        ctx = Ctx(ft=ft, dtype=torch.bfloat16)
        clean_calls, hurt_calls = [], []
        with act_grad_calls(clean_calls):
            _, clean, tot = _grads_of(params, cfg2, batch, ctx)
        check(tot["detected"] == 0, f"level_train {level}: clean 2-layer "
                                    f"grads, zero detections")
        before = (ft_gemm.FT_GEMM_LEVEL_SM90.launches,
                  ft_gemm.FT_GEMM_2D_SIMT.launches)
        _, hurt, _ = _grads_of(params, cfg2, batch,
                               dataclasses.replace(ctx, bwd_inject=dw_hook))
        lv = ft_gemm.FT_GEMM_LEVEL_SM90.launches - before[0]
        simt = ft_gemm.FT_GEMM_2D_SIMT.launches - before[1]
        _, left, _ = _grads_of(params, cfg2, batch, dataclasses.replace(
            ctx, ft=ft.replace(action="detect"), bwd_inject=dw_hook))
        check(lv == 28 * CHECK_LAYERS + 3 and simt == 0,
              f"level_train {level}: every K1 call of the step on the "
              f"tensor-core level instance ({lv})")
        _seu_rule(f"level_train {level}: SEU in w_down's dw (LAYOUT 2)",
                  clean, hurt, left)
        del hurt, left
        camp = gate_campaign(ctx)
        with act_grad_calls(hurt_calls):
            _, hurt, tot = _grads_of(params, cfg2, batch, camp)
        _, left, tot_d = _grads_of(params, cfg2, batch, dataclasses.replace(
            camp, ft=camp.ft.replace(action="detect")))
        with plain_kernels():
            _, plain_clean, _ = _grads_of(params, cfg2, batch, ctx)
            _, plain_fixed, tot_p = _grads_of(params, cfg2, batch, camp)
        check(tot["detected"] > 0 and tot["detected"] == tot["corrected"]
              and tot_d["corrected"] == 0
              and tot_p["detected"] == tot["detected"],
              f"level_train {level}: w_gate campaign at {LEVEL_GATE_RATE}: "
              f"{tot['detected']:.0f} SEUs detected and corrected, as many "
              f"as the plain versions find in the same draws "
              f"({tot_p['detected']:.0f}; detect-only: "
              f"{tot_d['detected']:.0f} detected, none corrected)")
        _call_rule(f"level_train {level}: w_gate campaign", clean_calls,
                   hurt_calls)
        print(f"  level_train {level}: clean grads, kernels against the "
              f"plain versions: worst leaf relative error "
              f"{_rel_err(clean, plain_clean):.3g}")
        _campaign_rule(f"level_train {level}: SEUs in w_gate (forward "
                       f"act_grad, backward dx / dw)", hurt, left,
                       plain_fixed, clean)
        del clean, hurt, left, plain_clean, plain_fixed
        del clean_calls, hurt_calls
    params.requires_grad_(False)
    del params
    print(json.dumps({"level_train": dict(
        arch=cfg.arch_id, layers=n_l, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
        steps=LEVEL_TRAIN_STEPS, block_losses=losses["block"], **summary,
        card=smi)}))
    return launches


def phase_level_moe(seed: int, smi: str):
    """qwen3-moe-235b-a22b at tile and inner: the engine's decode at 12
    layers, a one-layer train step, and SEUs in K7 (dbuf) and K8 (dw)."""
    cfg = dataclasses.replace(MOE, n_layers=MOE_ENGINE_LAYERS)
    print(f"  depth cut: {cfg.n_layers} of {MOE.n_layers} layers")
    t0 = time.perf_counter()
    params = transformer.init(cfg, seed=0, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    print(f"  init {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(seed)
    prompts, budgets = _prompts(rng, ENGINE_SLOTS, 16, 512, 8, 32,
                                cfg.vocab_size)
    ec = engine.EngineConfig(max_len=ENGINE_MAX_LEN, n_slots=ENGINE_SLOTS)
    launches = {n: 0 for n in KERNELS}
    summary = {}
    for level in LEVELS:
        run = RunConfig(model=cfg, ft=FT.replace(level=level),
                        dtype="bfloat16")
        eng = ProbeEngine(params, cfg, run, ec)
        for p_, m in zip(prompts, budgets):
            eng.submit(p_, max_new_tokens=m)
        for k in KERNELS.values():
            k["counter"].launches = 0
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with telemetry.ft_scope() as scope:
            res = eng.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
            totals = scope.totals()
        got = {n: k["counter"].launches for n, k in KERNELS.items()}
        for n in launches:
            launches[n] += got[n]
        steps = len(eng.decode_ms)
        n_tok = sum(len(r.tokens) for r in res)
        dec_ms, pre_ms = (statistics.median(eng.decode_ms),
                          statistics.median(eng.prefill_ms))
        ttft = [r.ttft_s * 1e3 for r in res]
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        print(f"  engine {level}: {len(prompts)} requests, {steps} decode "
              f"steps, {wall:.2f} s, {n_tok / wall:.2f} generated tokens/s; "
              f"decode {dec_ms:.1f} ms per step (median), prefill "
              f"{pre_ms:.1f} ms per request (median), TTFT median "
              f"{statistics.median(ttft):.0f} ms; peak {peak:.2f} GiB; FT "
              f"totals {totals}; launches {got}")
        check([len(r.tokens) for r in res] == budgets
              and eng.alloc.n_free == eng.plan.n_pages - 1
              and totals["detected"] == 0,
              f"level_moe engine {level}: every budget met, all pages back, "
              f"zero detections")
        per = 4 * cfg.n_layers + 1
        calls = len(prompts) + steps
        expect = {**k1_launches(per * calls, level), **k5_launches(0),
                  **k2_launches(cfg.n_layers * len(prompts)), **NO_FLASH_BWD,
                  **k6_launches(cfg.n_layers * steps),
                  "ft_gemm_grouped_sm90": 3 * cfg.n_layers * calls,
                  "ft_gemm_grouped": 0,
                  "tgmm_sm90": 0, "tgmm": 0, "naive_gemm": 0}
        check(got == expect,
              f"level_moe engine {level}: K1 {per} and K7 "
              f"{3 * cfg.n_layers} per prefill and per decode step, all on "
              f"the tensor-core level instances; K2, K6 and its combine as "
              f"at block")
        eng_p = ProbeEngine(params, cfg, run, ec)
        for p_, m in zip(prompts, budgets):
            eng_p.submit(p_, max_new_tokens=m)
        eng_p.step()                 # the admissions and a decode step
        prof = device_profile(eng_p.step)
        print(f"  engine {level} profiled decode step: {prof}")
        summary[level] = dict(engine=dict(
            requests=len(prompts), decode_steps=steps, run_s=wall,
            generated_tokens=n_tok, tokens_per_s=n_tok / wall,
            decode_ms_median=dec_ms, decode_ms=eng.decode_ms,
            prefill_ms_median=pre_ms, ttft_ms_median=statistics.median(ttft),
            peak_gib=peak, launches=got, profile=prof))
        del eng, eng_p
        torch.cuda.empty_cache()
    del params
    torch.cuda.empty_cache()
    # One-layer training, as moe_train, at each level.
    cfg1 = dataclasses.replace(MOE, n_layers=MOE_TRAIN_LAYERS)
    shape = ShapeConfig("chip_smoke_moe", TRAIN_SEQ, TRAIN_BATCH, "train")
    n_l = cfg1.n_layers
    for level in LEVELS:
        run = RunConfig(model=cfg1, ft=FT.replace(level=level),
                        dtype="bfloat16", remat="full")
        out, per, times, sites, peak = _train_run(
            cfg1, run, shape, LEVEL_TRAIN_STEPS, f"level_moe train {level}")
        for n in launches:
            launches[n] += sum(x[n] for x in per)
        losses = [h["loss"] for h in out["history"]]
        auxes = [h["aux"] for h in out["history"]]
        step_ms = statistics.median(times[1:])
        print(f"  train {level}: steps {[round(x, 1) for x in times]} ms, "
              f"median {step_ms:.1f} ms ({TRAIN_BATCH * TRAIN_SEQ / step_ms * 1e3:.1f}"
              f" tokens/s), peak {peak:.1f} GiB, losses {losses}, aux "
              f"{auxes}, sites with detections {sites}; launches per step "
              f"{per[-1]}")
        check(all(math.isfinite(x) for x in losses)
              and all(math.isfinite(x) and x > 0 for x in auxes)
              and all(h["detected"] == 0 for h in out["history"]),
              f"level_moe train {level}: finite loss and aux, zero "
              f"detections")
        expect = {**k1_launches(16 * n_l + 3, level), **k5_launches(0),
                  **k2_launches(2 * n_l), **flash_bwd_launches(cfg1, n_l),
                  **k6_launches(0), "ft_gemm_grouped_sm90": 9 * n_l,
                  "ft_gemm_grouped": 0, "tgmm_sm90": 3 * n_l, "tgmm": 0,
                  "naive_gemm": 0}
        check(all(x == expect for x in per),
              f"level_moe train {level}: launches per step {expect} (K1, K7 "
              f"and K8 on the tensor-core level instances)")
        prof = _profile_step(cfg1, run, shape, out, LEVEL_TRAIN_STEPS)
        print(f"  train {level} profiled step: {prof}")
        summary[level]["train"] = dict(
            step_ms=times, median_step_ms=step_ms, peak_gib=peak,
            losses=losses, aux=auxes, launches_per_step=per[-1],
            profile=prof)
        del out
        torch.cuda.empty_cache()
    # SEUs in K8 (moe_gate's dw) and in K7 (moe_gate's dbuf, the wᵀ walk)
    # at one layer x 256 tokens; buffer tile 0 is the first tile of the
    # first non-empty group.
    params = transformer.init(cfg1, seed=7, dtype=torch.bfloat16)
    params.requires_grad_(True)
    tok = torch.randint(0, cfg1.vocab_size, (1, CHECK_SEQ + 1),
                        generator=torch.Generator().manual_seed(7)).cuda()
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    hooks = {
        "K8 moe_gate dw": ("moe_gate", ("dw", InjectionSpec(
            row=700, col=1000, magnitude=1.0, k_step=0))),
        "K7 moe_gate dbuf": ("moe_gate", ("dbuf", InjectionSpec(
            row=0, col=100, magnitude=1.0, k_step=0))),
    }
    for level in LEVELS:
        ft = FT.replace(level=level)
        ctx = Ctx(ft=ft, dtype=torch.bfloat16)
        _, clean, tot = _grads_of(params, cfg1, batch, ctx)
        check(tot["detected"] == 0, f"level_moe {level}: clean grads, zero "
                                    f"detections")
        for label, hook in hooks.items():
            _, hurt, _ = _grads_of(params, cfg1, batch,
                                   dataclasses.replace(ctx, bwd_inject=hook))
            _, left, _ = _grads_of(params, cfg1, batch, dataclasses.replace(
                ctx, ft=ft.replace(action="detect"), bwd_inject=hook))
            _seu_rule(f"level_moe {level}: SEU in {label}", clean, hurt, left)
            del hurt, left
        del clean
    params.requires_grad_(False)
    del params
    print(json.dumps({"level_moe": dict(
        arch=MOE.arch_id, engine_layers=MOE_ENGINE_LAYERS,
        train_layers=MOE_TRAIN_LAYERS, slots=ENGINE_SLOTS, seed=seed,
        prompt_lens=[len(p_) for p_ in prompts], budgets=budgets, **summary,
        card=smi)}))
    return launches


# ---------------------------------------------------------------------------
# campaign_kernels / campaign_train / moe_campaign: stochastic SEU campaigns
# ---------------------------------------------------------------------------

#: A fixed campaign triple (enable, seed0, seed1) for the kernel checks.
TRIPLE = (1, 123456789, 987654321)
#: Training campaigns: the rate per output block, chosen so that a step's
#: forward GEMMs draw some tens of SEUs (phi4-mini at 2 x 512 tokens runs
#: about 1.9e5 forward blocks a step, the one-layer qwen3-moe about 5.6e4).
CAMPAIGN_RATE, MOE_CAMPAIGN_RATE = 4e-4, 1e-3
#: Ragged groups, empty ones, a 100-row group (two 64-row chunks on the
#: tensor cores) and a dead tail: the grouped instances' tail shape.
CAMPAIGN_SIZES = [13, 0, 100, 7, 70, 0, 0, 5]


def _k1_hits(a, b, ft, rng, chain=(), act_grad=False, tiles=None):
    """The blocks of a K1 / K5 launch that draw an SEU (bool), from its
    plan."""
    p = ft_gemm.plan_call(a, b, chain=chain, ft=ft, save_act_grad=act_grad,
                          tiles=tiles)
    m, k = a.shape[-2:]
    bm, bn, bk = p.tiles
    return ft_gemm.seu_draws(rng, ft, a[..., 0, 0].numel(),
                             ft_gemm.cdiv(m, bm),
                             ft_gemm.cdiv(b.shape[-1], bn),
                             ft_gemm.cdiv(k, bk), p.tiles, a.dim() > 2,
                             "cpu")[0]


def _gemm_case(label, counter, a, b, chain=(), act_grad=False, tiles=None,
               level="block"):
    """A K1 or K5 instance's campaign case: (label, counter, call, plain,
    hits), each taking (ft, rng)."""
    kw = dict(chain=chain, save_act_grad=act_grad, tiles=tiles)

    def lvl(ft):
        return ft.replace(level=level)

    def first(x):
        return x[0] if act_grad else x

    def call(ft, rng):
        out, rep = ft_gemm.ft_gemm(a, b, ft=lvl(ft), rng=rng, **kw)
        return first(out), rep

    def plain(ft, rng):
        out, rep = ft_gemm.planned_plain(a, b, ft=lvl(ft), rng=rng, **kw)
        return first(out), rep

    return (label, counter, call, plain,
            lambda ft, rng: _k1_hits(a, b, lvl(ft), rng, chain, act_grad,
                                     tiles))


def _k7_case(label, counter, buf, w, lay, tiles=None):
    args = (buf, w, lay.gid, lay.row_end)

    def hits(ft, rng):
        p = grouped_gemm.plan_k7_call(buf, w, lay.gid, tiles)
        return grouped_gemm.seu_tile_draws(
            rng, ft, lay.num_tiles, ft_gemm.cdiv(w.shape[2], p.tiles[1]),
            ft_gemm.cdiv(w.shape[1], p.tiles[2]), p.tiles, "cpu")[0]

    return (label, counter,
            lambda ft, rng: grouped_gemm.ft_gemm_grouped(
                *args, ft=ft, rng=rng, tiles=tiles),
            lambda ft, rng: grouped_gemm.planned_grouped_plain(
                *args, ft=ft, rng=rng, tiles=tiles), hits)


def _k8_case(label, counter, x, g, lay, tiles=None, level="block"):
    def lvl(ft):
        return ft.replace(level=level)

    def hits(ft, rng):
        p = grouped_gemm.plan_k8_call(x, g, lay.bm, tiles)
        live = (lay.row_end.long() - lay.base.long()).cpu()
        return grouped_gemm.seu_dw_draws(
            rng, ft, live, ft_gemm.cdiv(x.shape[1], p.tiles[2]),
            ft_gemm.cdiv(g.shape[1], p.tiles[1]), p.tiles)[0]

    return (label, counter,
            lambda ft, rng: grouped_gemm.tgmm(x, g, lay.row_end, bm=lay.bm,
                                              ft=lvl(ft), rng=rng,
                                              tiles=tiles),
            lambda ft, rng: grouped_gemm.planned_tgmm_plain(
                x, g, lay.row_end, bm=lay.bm, ft=lvl(ft), rng=rng,
                tiles=tiles),
            hits)


def _campaign_check(label, counter, call, plain, hits):
    """One instance under the fixed triple at rates 0.5 and 1.0, on
    integer-valued operands (every contribution exact on both sides):
    reports equal the plain version's under the same plan (det / corr / row
    / col / k exactly, magnitude and max residual to 1e-5 relative), one
    detection per SEU the blocks draw, the output equal to the clean call's
    (within the bf16 tolerance: bit for bit here); detect-only leaves the
    SEUs in place; rate 0 with the triple is the clean call bit for bit.
    Returns the SEU counts at 0.5 and 1.0."""
    clean, rep0 = call(FT, None)
    n_hits = []
    for rate in (0.5, 1.0):
        for ft in (FT.replace(inject_rate=rate),
                   DETECT.replace(inject_rate=rate)):
            before = counter.launches
            out, rep = call(ft, TRIPLE)
            torch.cuda.synchronize()
            check(counter.launches == before + 1,
                  f"campaign {label}: launched on its instance")
            out_p, rep_p = plain(ft, TRIPLE)
            n_hit = int(hits(ft, TRIPLE).sum())
            fields = [0, 1, 2, 3, 7]
            rel = ((rep[..., 4:6] - rep_p[..., 4:6]).abs()
                   / rep_p[..., 4:6].abs().clamp_min(1e-30)).max().item()
            check(torch.equal(rep[..., fields], rep_p[..., fields])
                  and rel <= 1e-5,
                  f"campaign {label} rate {rate} {ft.action}: report equal "
                  f"to the plain version's (mag / max residual within "
                  f"{rel:.2g})")
            check(torch.equal(out, out_p), f"campaign {label} rate {rate} "
                  f"{ft.action}: output equal to the plain version's")
            det, corr = float(rep[..., 0].sum()), float(rep[..., 1].sum())
            if ft.corrects:
                n_hits.append(n_hit)
                err = (out.float() - clean.float()).abs().max().item()
                check(n_hit > 0 and det == corr == n_hit and err <= BF16_TOL
                      * clean.float().abs().max().item(),
                      f"campaign {label} rate {rate}: {n_hit} SEUs drawn, "
                      f"each detected and corrected once, the output within "
                      f"the bf16 tolerance of the clean call (max diff "
                      f"{err:.3g}; bit for bit: {torch.equal(out, clean)})")
            else:
                # SEUs in rows or columns past the output's edge are
                # detected but never stored
                moved = int((out != clean).sum())
                check(det >= n_hit and corr == 0 and moved <= n_hit,
                      f"campaign {label} rate {rate} detect-only: {moved} "
                      f"stored elements left moved by {n_hit} SEUs, "
                      f"{det:.0f} detections, no correction")
    out, rep = call(FT, TRIPLE)
    check(torch.equal(out, clean) and torch.equal(rep, rep0),
          f"campaign {label}: rate 0 with the triple is the clean call")
    return n_hits


def _flash_campaign_check(label, counter, call, plain, hits):
    """One flash instance under the fixed triple at rates 0.5 and 1.0 on
    Gaussian operands, against its planned plain version: reports equal in
    det / corr / row / col / k and tau within 1e-5 (the magnitude and max
    residual follow the kernel's own sums), one detection a drawn SEU,
    corrected once, and the outputs within the bf16 tolerance of the plain
    version's and of the clean call's; detect-only leaves the SEUs in
    (some output off by more than four tolerances); rate 0 with the triple
    is the clean call bit for bit. Returns the SEU counts at 0.5 and 1.0."""
    clean, rep0 = call(FT, None)
    top = max(x.float().abs().max().item() for x in clean)
    n_hits = []
    for rate in (0.5, 1.0):
        for ft in (FT.replace(inject_rate=rate),
                   DETECT.replace(inject_rate=rate)):
            before = counter.launches
            outs, rep = call(ft, TRIPLE)
            torch.cuda.synchronize()
            check(counter.launches == before + 1,
                  f"campaign {label}: launched on its instance")
            outs_p, rep_p = plain(ft, TRIPLE)
            n_hit = int(hits(ft, TRIPLE).sum())
            fields = [0, 1, 2, 3, 7]
            tau = ((rep[..., 6] - rep_p[..., 6]).abs()
                   / rep_p[..., 6].abs().clamp_min(1e-30)).max().item()
            check(torch.equal(rep[..., fields], rep_p[..., fields])
                  and tau <= 1e-5,
                  f"campaign {label} rate {rate} {ft.action}: report det / "
                  f"corr / row / col / k equal to the plain version's, tau "
                  f"within {tau:.2g}")
            errs = [_bf16_close(o, op) for o, op in zip(outs, outs_p)]
            check(all(ok for _, ok in errs), f"campaign {label} rate {rate} "
                  f"{ft.action}: outputs within the bf16 tolerance of the "
                  f"plain version's (max diff {max(e for e, _ in errs):.3g})")
            det, corr = float(rep[..., 0].sum()), float(rep[..., 1].sum())
            moved = max((o.float() - c.float()).abs().max().item()
                        for o, c in zip(outs, clean))
            if ft.corrects:
                n_hits.append(n_hit)
                check(n_hit > 0 and det == corr == n_hit
                      and moved <= BF16_TOL * top,
                      f"campaign {label} rate {rate}: {n_hit} SEUs drawn, "
                      f"each detected and corrected once, the outputs within "
                      f"the bf16 tolerance of the clean call (max diff "
                      f"{moved:.3g})")
            else:
                check(det == n_hit and corr == 0
                      and moved > 4 * BF16_TOL * top,
                      f"campaign {label} rate {rate} detect-only: {det:.0f} "
                      f"detections of {n_hit} SEUs, no correction, outputs "
                      f"moved by up to {moved:.3g}")
    outs, rep = call(FT, TRIPLE)
    check(all(torch.equal(o, c) for o, c in zip(outs, clean))
          and torch.equal(rep, rep0),
          f"campaign {label}: rate 0 with the triple is the clean call")
    return n_hits


def _flash_fwd_case(label, counter, q, k, v, n_rep, causal=True,
                    save_stats=False):
    kw = dict(scale=q.shape[-1] ** -0.5, tau_dh=128, n_rep=n_rep,
              causal=causal, save_stats=save_stats)

    def call(ft, rng):
        res = flashft.flash_ft_fwd(q, k, v, ft=ft, rng=rng, **kw)
        return (res[0],), res[-1]

    def plain(ft, rng):
        res = flashft.flash_ft_plain(q, k, v, ft=ft, rng=rng, **kw)
        return (res[0],), res[-1]

    return (label, counter, call, plain,
            lambda ft, rng: flashft.seu_fwd_draws(
                rng, ft, q.shape[0], q.shape[1], k.shape[1], q.shape[-1],
                causal=causal, device="cuda")[0])


def _flash_bwd_cases(label, counters, q, k, v, g, n_rep, causal=True):
    """K3's and K4's cases on one backward problem (the statistics of the
    clean forward on the card)."""
    kw = dict(scale=q.shape[-1] ** -0.5, tau_dh=128, n_rep=n_rep,
              causal=causal)
    o, m, l, _ = flashft.flash_ft_fwd(q, k, v, ft=FT, save_stats=True, **kw)
    di = (g.float() * o.float()).sum(-1)
    ops_ = (q, k, v, g, m, l, di)
    bh, sq, skv = q.shape[0], q.shape[1], k.shape[1]

    def dq(ft, rng):
        out, rep = flashft.flash_ft_dq(*ops_, ft=ft, rng=rng, **kw)
        return (out,), rep

    def dq_p(ft, rng):
        out, rep = flashft.flash_dq_plain(*ops_, ft=ft, rng=rng, **kw)
        return (out,), rep

    def dkv(ft, rng):
        dk, dv, rep = flashft.flash_ft_dkv(*ops_, ft=ft, rng=rng, **kw)
        return (dk, dv), rep

    def dkv_p(ft, rng):
        dk, dv, rep = flashft.planned_dkv_plain(*ops_, ft=ft, rng=rng, **kw)
        return (dk, dv), rep

    return [
        (f"K3 {label}", counters[0], dq, dq_p,
         lambda ft, rng: flashft.seu_dq_draws(
             rng, ft, bh, sq, skv, 128, causal=causal, device="cuda")[0]),
        (f"K4 {label}", counters[1], dkv, dkv_p,
         lambda ft, rng: flashft.seu_dkv_draws(
             rng, ft, bh // n_rep, n_rep, sq, skv, 128, causal=causal,
             device="cuda")[0])]


def _decode_case(label, counter, gen, dtype, page, simt):
    """K6 at the engine's shape: qwen2-7b's 4 kv heads x 7 query rows
    (padded to the sublane), 8 slots of DECODE_LENGTHS."""
    cfg = qwen2_7b.CONFIG
    kvh, dh = cfg.n_kv_heads, cfg.head_dim
    n_rep = cfg.n_heads // kvh
    k, v, table, lens = _decode_pool(gen, DECODE_LENGTHS, kvh, dh, page,
                                     dtype)
    bq = -(-n_rep // flashft.sublane(dtype)) * flashft.sublane(dtype)
    q = torch.zeros(len(DECODE_LENGTHS) * kvh, bq, dh, device="cuda",
                    dtype=dtype)
    q[:, :n_rep] = _rand(gen, len(DECODE_LENGTHS) * kvh, n_rep, dh).to(dtype)
    kw = dict(scale=dh ** -0.5, tau_dh=dh, simt=simt)
    args = (q, k, v, lens, table)

    def call(ft, rng):
        out, rep = flashft.flash_ft_decode(*args, ft=ft, rng=rng, **kw)
        return (out,), rep

    def plain(ft, rng):
        out, rep = flashft.planned_decode_plain(*args, ft=ft, rng=rng, **kw)
        return (out,), rep

    p = flashft.plan_decode(q, k, v, table, simt=simt)
    return ((label, counter, call, plain,
             lambda ft, rng: flashft.seu_decode_draws(
                 rng, ft, lens, kvh, page, table.shape[1], bq, dh)[0]), p)


def _flash_campaign_kernels(gen):
    """The flash family's campaign cases and the Fig. 16 table of K2, K3 +
    K4 and K6 (see the module docstring). Returns (SEU counts, times)."""
    q2, phi = qwen2_7b.CONFIG, phi4_mini_38b.CONFIG
    bf = torch.bfloat16

    def heads(cfg, batch, s, dtype=bf):
        bh, gk = batch * cfg.n_heads, batch * cfg.n_kv_heads
        return (_rand(gen, bh, s, cfg.head_dim).to(dtype),
                _rand(gen, gk, s, cfg.head_dim).to(dtype),
                _rand(gen, gk, s, cfg.head_dim).to(dtype),
                _rand(gen, bh, s, cfg.head_dim).to(dtype),
                cfg.n_heads // cfg.n_kv_heads)

    pq, pk, pv, _, prep = heads(q2, BATCH, PROMPT)
    tq, tk, tv, tg, trep = heads(phi, TRAIN_BATCH, TRAIN_SEQ)
    sq_, sk_, sv_, sg_, _ = heads(phi, 1, 200, torch.float32)
    srep = 3
    pb = flashft.plan_bwd(tq, tk, tv, tg, n_rep=trep)
    check(pb.instance == "sm90" and pb.ranges == 3,
          f"K4 at phi4-mini's S {TRAIN_SEQ}: the tensor cores in 3 ranges "
          f"({pb})")
    k6, p6 = _decode_case(f"K6 sm90 engine {ENGINE_SLOTS} slots, pages of "
                          f"{kv_cache.DEFAULT_PAGE}", flashft.FLASH_DECODE_SM90,
                          gen, bf, kv_cache.DEFAULT_PAGE, False)
    check(p6.instance == "sm90" and p6.ranges == 9,
          f"K6 at the engine's shape: the tensor cores in 9 ranges ({p6})")
    cases = [
        _flash_fwd_case(f"K2 sm90 prefill {BATCH}x{PROMPT} "
                        f"{q2.n_heads}/{q2.n_kv_heads}",
                        flashft.FLASH_FT_SM90, pq, pk, pv, prep),
        _flash_fwd_case(f"K2 sm90 train {TRAIN_BATCH}x{TRAIN_SEQ} "
                        f"{phi.n_heads}/{phi.n_kv_heads} stats",
                        flashft.FLASH_FT_SM90, tq, tk, tv, trep,
                        save_stats=True),
        *_flash_bwd_cases(f"sm90 train {TRAIN_BATCH}x{TRAIN_SEQ}",
                          (flashft.FLASH_DQ_SM90, flashft.FLASH_DKV_SM90),
                          tq, tk, tv, tg, trep),
        k6,
        _flash_fwd_case("K2 simt f32 24/8 S 200", flashft.FLASH_FT, sq_, sk_,
                        sv_, srep),
        *_flash_bwd_cases("simt f32 24/8 S 200",
                          (flashft.FLASH_DQ, flashft.FLASH_DKV), sq_, sk_,
                          sv_, sg_, srep),
        _decode_case("K6 simt f32 engine, pages of 64", flashft.FLASH_DECODE,
                     gen, torch.float32, kv_cache.DEFAULT_PAGE, True)[0],
        _decode_case("K6 simt bf16 engine, pages of 16", flashft.FLASH_DECODE,
                     gen, bf, 16, True)[0],
        # the dh-64 instance (a direct call: the front pads dh to 128 under
        # a campaign), whisper's 16 heads over 300 frames, MHA
        _flash_fwd_case("K2 sm90 dh 64 16 heads S 300 non-causal",
                        flashft.FLASH_FT_SM90, *(_rand(gen, 16, 300, 64)
                                                 for _ in range(3)), 1,
                        causal=False),
    ]
    counts = {}
    for case in cases:
        counts[case[0]] = _flash_campaign_check(*case)
        torch.cuda.empty_cache()
    print(f"  flash SEUs drawn at rates 0.5 / 1.0: {counts}")

    # ---- the Fig. 16 table: device times (`queued_ms`) of the whole call,
    # clean / rate 0 / rate 1.0, three rounds in turns; the kernels a call
    # launches: K2; K3, K4 and its reduce; K6 and its combine -------------
    timed = [(cases[0][0], [cases[0]]),
             (f"K3 + K4 sm90 train {TRAIN_BATCH}x{TRAIN_SEQ}",
              [cases[2], cases[3]]),
             (cases[4][0], [cases[4]])]
    times = {}
    for label, group in timed:
        t = {"clean": [], "rate 0": [], "rate 1.0": []}
        for _ in range(3):
            for name, ft, rng in (("clean", FT, None), ("rate 0", FT, TRIPLE),
                                  ("rate 1.0", FT.replace(inject_rate=1.0),
                                   TRIPLE)):
                def fn(ft=ft, rng=rng):
                    for c in group:
                        c[2](ft, rng)
                t[name].append(queued_ms(fn))
        row = {name + " ms": statistics.median(xs) for name, xs in t.items()}
        row.update({name + " ms, 3 rounds": xs for name, xs in t.items()})
        n = sum(int(c[4](FT.replace(inject_rate=1.0), TRIPLE).sum())
                for c in group)
        row["errors per call at rate 1.0"] = n
        row["errors per minute at rate 1.0"] = n * 60e3 / row["rate 1.0 ms"]
        for v in ("rate 0", "rate 1.0"):
            row[f"{v} / clean"] = row[f"{v} ms"] / row["clean ms"]
        times[label] = row
        print(f"  {label}: {row}")
    return counts, times


def phase_campaign_kernels():
    gen = torch.Generator(device="cuda").manual_seed(23)
    q = qwen2_7b.CONFIG
    phi = phi4_mini_38b.CONFIG
    d, f = MOE.d_model, MOE.moe.expert_d_ff
    e, top_k = MOE.moe.n_experts, MOE.moe.top_k
    toks = TRAIN_BATCH * TRAIN_SEQ
    f32 = torch.float32
    rep_h, n_rep = q.n_heads // q.n_kv_heads, phi.n_heads // phi.n_kv_heads
    simt = ft_gemm.FT_GEMM_2D_SIMT
    cases = [
        # K1 on the tensor cores: phi4-mini's training w_gate + silu with
        # act_grad; a ragged call that split-K cuts
        _gemm_case(f"K1 sm90 train w_gate+silu ({toks}, {phi.d_model}) x "
                   f"({phi.d_model}, {phi.d_ff})", ft_gemm.FT_GEMM_SM90,
                   _ints(gen, toks, phi.d_model),
                   _ints(gen, phi.d_model, phi.d_ff), chain=("silu",),
                   act_grad=True),
        _gemm_case("K1 sm90 tail (200, 1000) x (1000, 296), split-K",
                   ft_gemm.FT_GEMM_SM90, _ints(gen, 200, 1000),
                   _ints(gen, 1000, 296)),
        # qwen2-7b's decode w_gate + silu at the tile level (level_serve's):
        # the tensor-core level instance (split-K, 16-row bands), and K1's
        # SIMT instance pinned by its tiles; an f32 tail at its square tiles
        _gemm_case(f"K1 sm90 tile decode w_gate+silu ({BATCH}, {q.d_model})"
                   f" x ({q.d_model}, {q.d_ff}), split-K",
                   ft_gemm.FT_GEMM_LEVEL_SM90, _ints(gen, BATCH, q.d_model),
                   _ints(gen, q.d_model, q.d_ff), chain=("silu",),
                   level="tile"),
        _gemm_case(f"K1 simt tile decode w_gate+silu ({BATCH}, {q.d_model})"
                   f" x ({q.d_model}, {q.d_ff})", simt,
                   _ints(gen, BATCH, q.d_model), _ints(gen, q.d_model, q.d_ff),
                   chain=("silu",), level="tile",
                   tiles=ft_gemm.pick_tiles(BATCH)),
        _gemm_case("K1 simt tail f32 (130, 300) x (300, 200)", simt,
                   _ints(gen, 130, 300).to(f32), _ints(gen, 300, 200).to(f32),
                   tiles=(64, 64, 32)),
        # K5 on the tensor cores: qwen2-7b's decode QK^T over a 256-position
        # cache; a ragged call
        _gemm_case(f"K5 sm90 decode QK^T ({BATCH}, {q.n_kv_heads}, {rep_h}, "
                   f"{q.head_dim}) x (.., {q.head_dim}, {MAX_LEN})",
                   ft_gemm.FT_GEMM_BATCHED_SM90,
                   _ints(gen, BATCH, q.n_kv_heads, rep_h, q.head_dim),
                   _ints(gen, BATCH, q.n_kv_heads, q.head_dim, MAX_LEN)),
        _gemm_case("K5 sm90 tail (4, 2, 7, 304) x (4, 2, 304, 72)",
                   ft_gemm.FT_GEMM_BATCHED_SM90, _ints(gen, 4, 2, 7, 304),
                   _ints(gen, 4, 2, 304, 72)),
        # K5's SIMT instance: phi4-mini's chunked attention QK^T of the
        # training campaign (n_rep x 512 query rows per kv head)
        _gemm_case(f"K5 simt train QK^T ({TRAIN_BATCH}, {phi.n_kv_heads}, "
                   f"{n_rep * TRAIN_SEQ}, {phi.head_dim}) x (.., "
                   f"{phi.head_dim}, {TRAIN_SEQ})", ft_gemm.FT_GEMM_BATCHED,
                   _ints(gen, TRAIN_BATCH, phi.n_kv_heads, n_rep * TRAIN_SEQ,
                         phi.head_dim),
                   _ints(gen, TRAIN_BATCH, phi.n_kv_heads, phi.head_dim,
                         TRAIN_SEQ)),
        _gemm_case("K5 simt tail f32 (2, 3, 40, 77) x (2, 3, 77, 50)",
                   ft_gemm.FT_GEMM_BATCHED, _ints(gen, 2, 3, 40, 77).to(f32),
                   _ints(gen, 2, 3, 77, 50).to(f32)),
    ]
    # K7 and K8: qwen3-moe-235b-a22b's training gate (forward) and dw, and
    # the small ragged layout; the SIMT instances at their pinned tiles.
    train_rows = toks * top_k
    lay = _moe_layout(gen, train_rows, 16)
    buf = kgrouped.scatter_rows(_ints(gen, train_rows, d), lay)
    w = _ints(gen, e, d, f)
    gb = kgrouped.scatter_rows(_ints(gen, train_rows, f), lay)
    small = _grouped_small(gen)
    sbuf = kgrouped.scatter_rows(_ints(gen, small.n_rows, 512), small)
    sw = _ints(gen, len(CAMPAIGN_SIZES), 512, 200)
    sx = kgrouped.scatter_rows(_ints(gen, small.n_rows, 152), small)
    sg = kgrouped.scatter_rows(_ints(gen, small.n_rows, 200), small)
    dec = _moe_layout(gen, ENGINE_SLOTS * top_k, 16)
    dbuf = kgrouped.scatter_rows(_ints(gen, ENGINE_SLOTS * top_k, d), dec)
    cases += [
        _k7_case(f"K7 sm90 train gate {train_rows} rows {d}->{f}",
                 grouped_gemm.FT_GEMM_GROUPED_SM90, buf, w, lay),
        _k7_case("K7 sm90 tail (groups " + str(CAMPAIGN_SIZES) + ")",
                 grouped_gemm.FT_GEMM_GROUPED_SM90, sbuf, sw, small),
        _k7_case(f"K7 simt decode gate {ENGINE_SLOTS * top_k} rows {d}->{f}",
                 grouped_gemm.FT_GEMM_GROUPED_SIMT, dbuf, w, dec,
                 tiles=(16, 128, 32)),
        _k7_case("K7 simt tail f32", grouped_gemm.FT_GEMM_GROUPED_SIMT,
                 sbuf.float(), sw.float(), small, tiles=(16, 128, 32)),
        _k8_case(f"K8 sm90 train dw {train_rows} rows ({e}, {d}, {f})",
                 grouped_gemm.TGMM_SM90, buf, gb, lay),
        _k8_case("K8 sm90 tail", grouped_gemm.TGMM_SM90, sx, sg, small),
        # K8's tensor-core level instances (16-row bands of dw at tile, a
        # 64-row stage's Δ at inner), the same shapes
        *[_k8_case(f"K8 sm90 {lv} train dw {train_rows} rows ({e}, {d}, "
                   f"{f})", grouped_gemm.TGMM_SM90, buf, gb, lay, level=lv)
          for lv in LEVELS],
        *[_k8_case(f"K8 sm90 {lv} tail", grouped_gemm.TGMM_SM90, sx, sg,
                   small, level=lv) for lv in LEVELS],
        _k8_case(f"K8 simt train dw {train_rows} rows ({e}, {d}, {f})",
                 grouped_gemm.TGMM_SIMT, buf, gb, lay, tiles=(16, 64, 64)),
        _k8_case("K8 simt tail f32", grouped_gemm.TGMM_SIMT, sx.float(),
                 sg.float(), small, tiles=(16, 64, 64)),
    ]
    counts = {}
    for case in cases:
        counts[case[0]] = _campaign_check(*case)
        torch.cuda.empty_cache()
    print(f"  SEUs drawn at rates 0.5 / 1.0: {counts}")

    # ---- times: the paper's Fig. 16 analogue on K1 (tensor cores) and the
    # hook's cost on K5, K7 and K8 ----------------------------------------
    times = {}
    k1_shapes = [(f"decode w_gate+silu ({BATCH}, {q.d_model}) x ({q.d_model},"
                  f" {q.d_ff})", BATCH, q.d_model, q.d_ff, ("silu",)),
                 (f"prefill w_gate+silu ({BATCH * PROMPT}, {q.d_model}) x "
                  f"({q.d_model}, {q.d_ff})", BATCH * PROMPT, q.d_model,
                  q.d_ff, ("silu",)),
                 ("square 4096", 4096, 4096, 4096, ())]
    for label, m, k, n, chain in k1_shapes:
        a, b = _rand(gen, m, k), _rand(gen, k, n, scale=0.02)
        p = ft_gemm.plan_call(a, b, chain=chain, ft=FT)
        blocks = ft_gemm.cdiv(m, p.tiles[0]) * ft_gemm.cdiv(n, p.tiles[1])

        def k1(ft, rng):
            return lambda: ft_gemm.ft_gemm(a, b, chain=chain, ft=ft, rng=rng)
        row = dict(plan=f"{p.instance} {p.tiles} x{p.splits}", blocks=blocks)
        variants = (("clean", k1(FT, None)), ("rate 0", k1(FT, TRIPLE)),
                    ("rate 1.0", k1(FT.replace(inject_rate=1.0), TRIPLE)),
                    ("ft off", k1(None, None)))
        # three rounds in turns, the median of each: noise moves a single
        # reading by up to 5 % at decode. CUDA events over 30 back-to-back
        # calls: the device is the bound at these shapes (a call's host
        # time, 0.05-0.07 ms, is below its device time)
        ev = {name: [] for name, _ in variants}
        for _ in range(3):
            for name, fn in variants:
                ev[name].append(time_ms(fn, 30))
        for name, _ in variants:
            row[name + " ms"] = statistics.median(ev[name])
            row[name + " ms, 3 rounds"] = ev[name]
        lib = (lambda: torch.nn.functional.silu(a @ b)) if chain else \
            (lambda: a @ b)
        row["torch.matmul ms"] = time_ms(lib, 20)
        row["errors per call at rate 1.0"] = blocks
        row["errors per minute at rate 1.0"] = (
            blocks * 60e3 / row["rate 1.0 ms"])
        for v in ("rate 0", "rate 1.0"):
            row[f"{v} / clean"] = row[f"{v} ms"] / row["clean ms"]
        row["rate 1.0 / torch.matmul"] = (row["rate 1.0 ms"]
                                          / row["torch.matmul ms"])
        times[f"K1 sm90 {label}"] = row
        print(f"  K1 sm90 {label}: {row}")
    k1_dec = times[f"K1 sm90 {k1_shapes[0][0]}"]
    check(k1_dec["rate 0 / clean"] <= 1.05,
          f"K1 decode w_gate+silu: rate 0 within 5% of the clean time "
          f"({k1_dec['rate 0 / clean']:.4f})")
    hook = [next(c for c in cases if c[0].startswith(prefix))
            for prefix in ("K5 sm90 decode", "K5 simt train", "K7 sm90 train",
                           "K8 sm90 train", "K8 sm90 tile train",
                           "K8 sm90 inner train")]
    for label, _, call, _, _ in hook:
        # K5 at decode runs 0.004 ms on the device against 0.04 of host time
        # a call: its time is that of calls queued behind a device-side
        # sleep (`queued_ms`, as the flash table's; a long run's profiler
        # traces drop events); the others CUDA events over back-to-back
        # calls
        row = {}
        t = {"clean": [], "rate 0": [], "rate 1.0": []}
        for _ in range(3):
            for name, ft, rng in (("clean", FT, None), ("rate 0", FT, TRIPLE),
                                  ("rate 1.0", FT.replace(inject_rate=1.0),
                                   TRIPLE)):
                fn = lambda: call(ft, rng)           # noqa: E731
                t[name].append(queued_ms(fn) if label.startswith("K5 sm90")
                               else time_ms(fn, 10))
        for name, xs in t.items():
            row[name + " ms"] = statistics.median(xs)
        row["rate 0 / clean"] = row["rate 0 ms"] / row["clean ms"]
        row["rate 1.0 / clean"] = row["rate 1.0 ms"] / row["clean ms"]
        times[label] = row
        print(f"  {label} (integer operands): {row}")
    f_counts, f_times = _flash_campaign_kernels(gen)
    counts.update(f_counts)
    times.update(f_times)
    print(json.dumps({"campaign_kernels": dict(seus=counts, times=times)}))


def _grouped_small(gen):
    """A layout of CAMPAIGN_SIZES groups on the 16-row tile."""
    ids = torch.cat([torch.full((n,), g, dtype=torch.long)
                     for g, n in enumerate(CAMPAIGN_SIZES)]).cuda()
    ids = ids[torch.randperm(len(ids), generator=gen, device="cuda")]
    return kgrouped.make_layout(ids, len(CAMPAIGN_SIZES), 16)


@contextmanager
def forward_blocks():
    """Record every K1, K5, K7 and K2 launch of a forward under an open
    telemetry scope with a campaign armed (the protected calls whose
    detections the scope records: not the backward's, not the remat
    recompute's) by its plan, and every flash backward (`ops.flash_ft_bwd`,
    K3 and K4) with a campaign key; on exit count the forward launches'
    output blocks and the blocks whose SEU the triple draws, and the
    backward's draws beside its reports' detections and corrections (the
    draws and sums run after the step, on the host). Yields {"blocks",
    "hits", "bwd_hits", "bwd_det", "bwd_corr"}, filled on exit."""
    tot = {"blocks": 0, "hits": 0, "bwd_hits": 0, "bwd_det": 0.0,
           "bwd_corr": 0.0}
    calls, bwd = [], []
    saved = (ft_gemm.ft_gemm, grouped_gemm.ft_gemm_grouped,
             flashft.flash_ft_fwd, ops.flash_ft_bwd)

    def counted(ft, rng):
        return (ft_gemm.seu_armed(rng, ft)
                and telemetry.current_scope() is not None)

    def gemm(a, b, **kw):
        ft, rng = kw.get("ft"), kw.get("rng")
        if counted(ft, rng):
            p = ft_gemm.plan_call(a, b, chain=tuple(kw.get("chain", ())),
                                  ft=ft,
                                  save_act_grad=kw.get("save_act_grad",
                                                       False),
                                  tiles=kw.get("tiles"))
            m, k = a.shape[-2:]
            bm, bn, bk = p.tiles
            # shapes only: the operands are not held past the call
            args = (rng, ft, a[..., 0, 0].numel(), ft_gemm.cdiv(m, bm),
                    ft_gemm.cdiv(b.shape[-1], bn), ft_gemm.cdiv(k, bk),
                    p.tiles, a.dim() > 2, "cpu")
            calls.append(lambda: ft_gemm.seu_draws(*args)[0])
        return saved[0](a, b, **kw)

    def grouped(buf, w, gid, row_end, **kw):
        ft, rng = kw.get("ft"), kw.get("rng")
        if counted(ft, rng):
            p = grouped_gemm.plan_k7_call(buf, w, gid, kw.get("tiles"))
            args = (rng, ft, gid.shape[0],
                    ft_gemm.cdiv(w.shape[2], p.tiles[1]),
                    ft_gemm.cdiv(w.shape[1], p.tiles[2]), p.tiles, "cpu")
            calls.append(lambda: grouped_gemm.seu_tile_draws(*args)[0])
        return saved[1](buf, w, gid, row_end, **kw)

    def flash_fwd(q, k, v, **kw):
        ft, rng = kw.get("ft"), kw.get("rng")
        if counted(ft, rng):
            args = (rng, ft, q.shape[0], q.shape[1], k.shape[1], q.shape[2])
            causal = kw.get("causal", True)
            calls.append(lambda: flashft.seu_fwd_draws(*args,
                                                       causal=causal)[0])
        return saved[2](q, k, v, **kw)

    def flash_bwd(q, k, v, o, m, l, g, **kw):
        res = saved[3](q, k, v, o, m, l, g, **kw)
        ft = kw.get("ft", FT)
        rng = flashft.encode_rng(kw.get("key"), ft)
        if ft_gemm.seu_armed(rng, ft):
            n_rep, causal = kw.get("n_rep", 1), kw.get("causal", True)
            bh, sq, skv = q.shape[0], q.shape[1], k.shape[1]
            dp = -(-q.shape[2] // 128) * 128     # the front's width
            bwd.append((res[3], res[4], lambda: (
                flashft.seu_dq_draws(rng, ft, bh, sq, skv, dp,
                                     causal=causal)[0],
                flashft.seu_dkv_draws(rng, ft, bh // n_rep, n_rep, sq, skv,
                                      dp, causal=causal)[0])))
        return res

    (ft_gemm.ft_gemm, grouped_gemm.ft_gemm_grouped, flashft.flash_ft_fwd,
     ops.flash_ft_bwd) = gemm, grouped, flash_fwd, flash_bwd
    try:
        yield tot
    finally:
        (ft_gemm.ft_gemm, grouped_gemm.ft_gemm_grouped, flashft.flash_ft_fwd,
         ops.flash_ft_bwd) = saved
        for draw in calls:
            h = draw()
            tot["blocks"] += h.numel()
            tot["hits"] += int(h.sum())
        for rep_dq, rep_dkv, draw in bwd:
            tot["bwd_hits"] += sum(int(h.sum()) for h in draw())
            for r in (rep_dq, rep_dkv):
                tot["bwd_det"] += float(r[..., 0].sum())
                tot["bwd_corr"] += float(r[..., 1].sum())


def _campaign_runs(cfg, rate, steps, smi, label, path_kernels,
                   guard_allow=None, attn_impl="auto", bwd_seus=True):
    """The model ``cfg`` at full width under `make_train_step` (bf16, f32
    AdamW, ``remat="full"``, ``attn_impl`` attention: "auto" takes the flash
    kernels), ``steps`` steps from one initialisation three times: clean, a
    campaign at ``rate`` on every step (correct), the same campaign
    detect-only. Checks every campaign step detects and corrects SEUs, one
    per SEU its forward blocks draw, within a 5-sigma binomial band of rate
    x forward blocks, and that the flash backward's reports detect (and,
    correcting, correct) each SEU its K3 and K4 blocks draw (some over the
    run when ``bwd_seus``); the losses and the
    parameters after step 1 (when ``steps`` > 1) within 1e-3 relative of
    the clean run, the detect-only losses at least 100x further off. The
    first step of each run runs under the dispatch guard and the last one
    (when ``steps`` > 1) under the profiler (busy time, idle share); the
    runs' step times are host times to the end of the device work. Every kernel
    of ``path_kernels`` must launch in the campaign run; returns its launch
    counts (all counters set to 0 just before it)."""
    run = RunConfig(model=cfg, ft=FT, dtype="bfloat16", remat="full",
                    attn_impl=attn_impl)
    tc = train_loop.TrainConfig(inject_every=1)
    opt_cfg = adamw.AdamWConfig(lr=run.learning_rate,
                                weight_decay=run.weight_decay,
                                grad_clip=run.grad_clip)
    shape = ShapeConfig(f"chip_smoke_{label}", TRAIN_SEQ, TRAIN_BATCH,
                        "train")
    params = model_zoo.module_for(cfg).init(cfg, seed=run.seed,
                                            dtype=torch.bfloat16,
                                            device="cuda")
    params.requires_grad_(True)
    # the initial parameters and the clean run's after step 1 wait on the
    # host: three copies of phi4-mini's would not fit the card beside the
    # f32 AdamW moments
    init = {n: p.detach().to("cpu", copy=True)
            for n, p in params.named_parameters()}
    pipe = data_lib.for_model(cfg, shape, seed=run.seed)
    batches = [{k: torch.as_tensor(x, dtype=torch.long, device="cuda")
                for k, x in pipe.batch_at(i).items()} for i in range(steps)]
    # step 0 runs at lr 0: the parameters after step 1 are compared
    after = min(1, steps - 1)
    results = {}
    for name, ft in (("clean", FT), ("campaign", FT.replace(
            inject_rate=rate)), ("detect-only", DETECT.replace(
            inject_rate=rate))):
        with torch.no_grad():
            for n, p in params.named_parameters():
                p.copy_(init[n])
        opt = None
        torch.cuda.empty_cache()
        opt = train_loop.init_opt_state(params, opt_cfg, tc)
        step_fn = train_loop.make_train_step(
            cfg, dataclasses.replace(run, ft=ft), opt_cfg, tc)
        key_of = (lambda i: None) if name == "clean" else \
            (lambda i: train_loop.inject_key(tc, i))
        r = dict(loss=[], det=[], corr=[], blocks=[], hits=[], bwd_hits=[],
                 bwd_det=[], bwd_corr=[], step_ms=[], profile=None)
        guard = LibraryCallGuard(allow=guard_allow)
        for k in KERNELS.values():
            k["counter"].launches = 0
        for i in range(steps):
            # the first step under the dispatch guard (its Python dispatch
            # costs host time), the last one profiled, those between timed
            last = i == steps - 1 and steps > 1
            with forward_blocks() as fb, (guard if i == 0 else
                                          contextlib.nullcontext()):
                def one():
                    return step_fn(params, opt, batches[i], i, key_of(i))
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if last:
                    box = {}
                    prof = device_profile(lambda: box.update(m=one()[2]))
                    metrics = box["m"]
                    r["profile"] = prof
                else:
                    metrics = one()[2]
                    torch.cuda.synchronize()
                r["step_ms"].append((time.perf_counter() - t0) * 1e3)
            r["loss"].append(float(metrics["loss"]))
            r["det"].append(float(metrics["ft"].detected))
            r["corr"].append(float(metrics["ft"].corrected))
            r["blocks"].append(fb["blocks"])
            r["hits"].append(fb["hits"])
            for f in ("bwd_hits", "bwd_det", "bwd_corr"):
                r[f].append(fb[f])
            if steps > 1 and i == after:
                r["after"] = {n: p.detach().to("cpu", copy=True)
                              for n, p in params.named_parameters()} \
                    if name == "clean" else \
                    max(float((p.detach().float()
                               - results["clean"]["after"][n].to(
                                   p.device).float()).norm()
                              / results["clean"]["after"][n].to(
                                  p.device).float().norm())
                        for n, p in params.named_parameters())
        check(not guard.hits, f"{label} {name}: no library matmul / "
              f"attention op dispatched in the guarded step "
              f"({sorted(set(guard.hits))})")
        r["launches"] = {n: k["counter"].launches
                         for n, k in KERNELS.items()}
        results[name] = r
        print(f"  {label} {name}: losses {r['loss']}, detected {r['det']}, "
              f"corrected {r['corr']}, forward blocks {r['blocks']}, SEUs "
              f"drawn in the forward {r['hits']}, flash backward: SEUs "
              f"drawn {r['bwd_hits']}, detected {r['bwd_det']}, corrected "
              f"{r['bwd_corr']}, step ms "
              f"{[round(x, 1) for x in r['step_ms']]} (the first guarded, "
              f"the last profiled), profile {r['profile']}")
    del opt, init
    clean, hot, left = (results[n] for n in ("clean", "campaign",
                                             "detect-only"))
    check(all(d == 0 for d in clean["det"]), f"{label}: clean run, zero "
          f"detections")
    for i in range(steps):
        n_b, n_h = hot["blocks"][i], hot["hits"][i]
        sd = math.sqrt(n_b * rate * (1 - rate))
        check(hot["det"][i] == hot["corr"][i] == n_h > 0
              and abs(n_h - rate * n_b) <= 5 * sd,
              f"{label} step {i}: detected == corrected == {n_h:.0f} SEUs "
              f"drawn, within 5 sigma ({5 * sd:.1f}) of {rate} x {n_b} "
              f"forward blocks ({rate * n_b:.1f})")
        b_h, b_d, b_c = (hot[f][i] for f in ("bwd_hits", "bwd_det",
                                               "bwd_corr"))
        d_h, d_d, d_c = (left[f][i] for f in ("bwd_hits", "bwd_det",
                                                "bwd_corr"))
        check(b_d == b_c == b_h and d_d == d_h and d_c == 0,
              f"{label} step {i}: the flash backward's K3 and K4 detected and "
              f"corrected each of the {b_h} SEUs they drew (detect-only: "
              f"{d_d:.0f} of {d_h} detected, none corrected)")
    n_bwd = sum(hot["bwd_hits"])
    if attn_impl == "chunked":
        check(n_bwd == 0, f"{label}: no flash backward ran")
    elif bwd_seus:
        check(n_bwd > 0, f"{label}: the flash backward drew {n_bwd} SEUs over "
              f"the run")
    off = [abs(h - c) / abs(c) for h, c in zip(hot["loss"], clean["loss"])]
    off_d = [abs(h - c) / abs(c) for h, c in zip(left["loss"],
                                                 clean["loss"])]
    check(max(off) <= 1e-3, f"{label}: every loss within 1e-3 relative of "
          f"the clean run's (worst {max(off):.3g})")
    check(max(off_d) >= 100 * max(off) and max(off_d) > 0,
          f"{label}: the detect-only losses at least 100x further off "
          f"(worst {max(off_d):.3g})")
    if steps > 1:
        check(hot["after"] <= 1e-3, f"{label}: every parameter after step "
              f"1 within 1e-3 relative (Frobenius) of the clean run's "
              f"(worst {hot['after']:.3g}; detect-only "
              f"{left['after']:.3g})")
    launched = hot["launches"]
    path = [n for n in path_kernels if launched[n] == 0]
    check(not path, f"{label}: every kernel of the path launched in the "
          f"campaign run ({ {n: launched[n] for n in path_kernels} })")
    out = {n: {k: v for k, v in r.items() if k != "after"}
           for n, r in results.items()}
    if steps > 1:
        out["params_after_step_1_rel"] = dict(campaign=hot["after"],
                                              detect_only=left["after"])
    print(json.dumps({label: dict(arch=cfg.arch_id, layers=cfg.n_layers,
                                  rate=rate, runs=out, card=smi)}))
    return launched


#: The flash family's kernels on a bf16 training path (tensor cores).
FLASH_TRAIN_KERNELS = ("flash_ft_sm90", "flash_dq_sm90", "flash_dkv_sm90")


def phase_campaign_train(smi: str):
    return _campaign_runs(phi4_mini_38b.CONFIG, CAMPAIGN_RATE, TRAIN_STEPS,
                          smi, "campaign_train",
                          ("ft_gemm_sm90",) + FLASH_TRAIN_KERNELS)


def phase_campaign_train_chunked(smi: str):
    return _campaign_runs(phi4_mini_38b.CONFIG, CAMPAIGN_RATE, TRAIN_STEPS,
                          smi, "campaign_train_chunked",
                          ("ft_gemm_sm90", "ft_gemm_batched"),
                          attn_impl="chunked")


def phase_moe_campaign(smi: str):
    cfg = dataclasses.replace(MOE, n_layers=MOE_TRAIN_LAYERS)
    return _campaign_runs(cfg, MOE_CAMPAIGN_RATE, 2, smi, "moe_campaign",
                          ("ft_gemm_sm90", "ft_gemm_grouped_sm90",
                           "tgmm_sm90") + FLASH_TRAIN_KERNELS,
                          guard_allow=router_product(cfg.moe.n_experts),
                          bwd_seus=False)


# ---------------------------------------------------------------------------
# chain_kernels / whisper_check / whisper_serve: K1's last epilogue chains
# and whisper-medium served on the card
# ---------------------------------------------------------------------------

#: whisper-medium serving: 4 requests of 16 prompt tokens over 1 500 frames
#: each, 8 greedy tokens, a self cache of 32 positions
W_BATCH, W_PROMPT, W_NEW_TOKENS, W_MAX_LEN = 4, 16, 8, 32
#: FT off and the three levels
W_LEVELS = ("off", "block", "tile", "inner")
#: The chains the SIMT chain instance is held to in chain_kernels (it
#: takes every chain csrc/ft_gemm.cu does not compile at the call's level)
SIMT_CHAINS = [("bias", "relu"), ("bias", "gelu"), ("gelu",), ("relu",),
               ("residual",), ("gelu", "residual"), ("bias", "residual"),
               ("residual", "bias", "silu"), ("bias", "gelu", "residual"),
               ("relu", "bias"), ("silu", "residual", "bias")]


def _w_ft(level):
    return None if level == "off" else FT.replace(level=level)


def _outs(res, ag):
    """The outputs of a K1 call: (C,) or (C, act_grad)."""
    return tuple(res) if ag else (res,)


def _cmp_k1(label, got, want, kw, a, b, tol=BF16_TOL):
    """A K1 call with its chain against its plain version: C and the
    report by `_cmp_outputs`, act_grad likewise but for relu, whose
    derivative jumps at 0: the two sum in different orders, so they may
    disagree where the pre-activation is within rounding of 0, and only
    there (within 1e-3 of its largest magnitude)."""
    ag, chain = kw.get("save_act_grad", False), kw["chain"]
    err = _cmp_outputs(label, _outs(got[0], ag)[0], _outs(want[0], ag)[0],
                       got[1], want[1], tol=tol)
    if not ag:
        return err
    g_, w_ = got[0][1], want[0][1]
    if "relu" not in chain:
        return max(err, _cmp_outputs(f"{label} act_grad", g_, w_, tol=tol))
    pre = epilogues.reference_apply(
        chain[:chain.index("relu")], a.float() @ b.float(),
        bias=kw.get("bias"), residual=kw.get("residual"))
    flip = g_ != w_
    near = pre.abs() <= 1e-3 * pre.abs().max()
    check(bool((near | ~flip).all()), f"{label} act_grad: equal but at "
          f"{int(flip.sum())} cells, each a pre-activation within 1e-3 of "
          f"max|pre| of 0")
    return err


def _chain_seu(label, counter, a, b, kw, row, step):
    """One deterministic SEU on integer-valued operands in ``row``, at the
    last column whose pre-activation (with the bias) is positive, so that
    the activation cannot hide it: corrected (the clean output bit for bit,
    one detection and correction, located), and under a detect-only policy
    left in place with no correction."""
    pre = a[row].float() @ b.float()
    if kw.get("bias") is not None:
        pre = pre + kw["bias"].float()
    col = int((pre > 0).nonzero()[-1])
    clean, _ = ft_gemm.ft_gemm(a, b, **kw)
    inj = (1, -1, row, col, step)
    before = counter.launches
    fixed, rep = ft_gemm.ft_gemm(a, b, inj=inj, inj_mag=64.0, **kw)
    check(counter.launches == before + 1, f"{label}: one launch")
    cell = rep[rep[..., 0] > 0]
    check(torch.equal(fixed, clean) and float(rep[..., 0].sum()) == 1.0
          and float(rep[..., 1].sum()) == 1.0 and int(cell[-1, 2]) == row
          and int(cell[-1, 3]) == col and abs(float(cell[-1, 4]) - 64.0)
          < 1e-3, f"{label}: SEU at (row {row}, col {col}, k-step {step}) "
          f"corrected bit for bit and located")
    left, rep_d = ft_gemm.ft_gemm(
        a, b, inj=inj, inj_mag=64.0,
        **dict(kw, ft=kw["ft"].replace(action="detect")))
    diff = (left != clean).nonzero().tolist()
    check(diff == [[row, col]] and float(rep_d[..., 0].sum()) >= 1.0
          and float(rep_d[..., 1].sum()) == 0.0,
          f"{label}: detect-only leaves the SEU at ({row}, {col}) and "
          f"corrects nothing")


def phase_chain_kernels():
    """K1's gelu / relu chains on the tensor cores at whisper's w1 shape,
    and the SIMT chain instance on every chain it takes."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    cfg = whisper_medium.CONFIG
    m, n, k = W_BATCH * cfg.n_audio_frames, cfg.d_ff, cfg.d_model
    rows = {"ft_gemm_sm90": dict(max_abs_err=0.0, detail=[],
                                 headline="w1+gelu block"),
            "ft_gemm_level_sm90": dict(max_abs_err=0.0, detail=[],
                                       headline="w1+gelu tile"),
            "ft_gemm_chain": dict(max_abs_err=0.0, detail=[],
                                  headline="w1 gelu+residual")}
    a = _rand(gen, m, k)
    b = _rand(gen, k, n, scale=0.02)
    bias = _rand(gen, n, scale=0.02)
    res = _rand(gen, m, n)
    nbytes = 2 * (m * k + k * n + m * n)
    b_ms, b_by = bound(2.0 * m * n * k, nbytes)
    # ---- the tensor cores: bias? + gelu / relu, act_grad, every level ----
    for level in W_LEVELS:
        ft = _w_ft(level)
        name = ("ft_gemm_level_sm90" if level in ("tile", "inner")
                else "ft_gemm_sm90")
        counter = KERNELS[name]["counter"]
        for act in ("gelu", "relu"):
            for chain in ((act,), ("bias", act)):
                for ag in (False, True):
                    label = f"K1 w1 {'+'.join(chain)}{' act_grad' if ag else ''} {level}"
                    kw = dict(chain=chain, ft=ft, save_act_grad=ag,
                              bias=bias if "bias" in chain else None)
                    p = ft_gemm.plan_call(a, b, chain=chain, ft=ft,
                                          save_act_grad=ag)
                    check(p.instance == "sm90", f"{label}: planned on the "
                          f"tensor cores ({p})")
                    before = counter.launches
                    got = ft_gemm.ft_gemm(a, b, **kw)
                    check(counter.launches == before + 1,
                          f"{label}: one launch of {name}")
                    want = _plain_gemm(a, b, **kw)
                    rows[name]["max_abs_err"] = max(
                        rows[name]["max_abs_err"],
                        _cmp_k1(label, got, want, kw, a, b))
        # times at whisper's w1: gelu, no bias, no act_grad
        kw = dict(chain=("gelu",), ft=ft)
        ms = time_ms(lambda: ft_gemm.ft_gemm(a, b, **kw), 10)
        plain_ms = time_ms(lambda: _plain_gemm(a, b, **kw), 1, warmup=0)
        lib_ms = time_ms(lambda: torch.nn.functional.gelu(
            torch.matmul(a, b), approximate="tanh"), 10)
        rows[name]["detail"].append(dict(
            shape=f"w1+gelu {level}", M=m, N=n, K=k, level=level, ms=ms,
            plain_ms=plain_ms, library_ms=lib_ms,
            library="torch.matmul then F.gelu(approximate='tanh')",
            bound_ms=b_ms, bound_by=b_by))
        print(f"  K1 w1+gelu {level} ({m}x{n}x{k}) on {name}: {ms:.4f} ms, "
              f"plain {plain_ms:.2f} ms, library {lib_ms:.4f} ms, bound "
              f"{b_ms:.4f} ms ({b_by})")
    # SEUs on integer operands at w1's shape, one per level, with act_grad
    ai, bi = _ints(gen, m, k), _ints(gen, k, n)
    for level in W_LEVELS[1:]:
        name = ("ft_gemm_level_sm90" if level in ("tile", "inner")
                else "ft_gemm_sm90")
        _chain_seu(f"K1 w1+gelu {level}", KERNELS[name]["counter"], ai, bi,
                   dict(chain=("gelu",), ft=_w_ft(level)), m - 1, 2)
    # ---- the SIMT chain instance ----------------------------------------
    counter = ft_gemm.FT_GEMM_CHAIN
    err = 0.0
    launched = 0
    for dtype, (sm, sn, sk) in ((torch.bfloat16, (4, 1000, 640)),
                                (torch.float32, (300, 520, 700))):
        g2 = torch.Generator(device="cuda").manual_seed(sm + sn)
        mk = lambda *s: (torch.randn(*s, generator=g2, device="cuda")
                         ).to(dtype)
        a2, b2 = mk(sm, sk), mk(sk, sn) * 0.05
        bias2, res2 = mk(sn) * 0.1, mk(sm, sn)
        for chain in SIMT_CHAINS:
            act = any(x in ("silu", "gelu", "relu") for x in chain)
            for level in W_LEVELS:
                ft = _w_ft(level)
                for ag in ((False, True) if act else (False,)):
                    kw = dict(chain=chain, ft=ft, save_act_grad=ag,
                              bias=bias2 if "bias" in chain else None,
                              residual=res2 if "residual" in chain
                              else None)
                    p = ft_gemm.plan_call(a2, b2, chain=chain, ft=ft,
                                          save_act_grad=ag)
                    if p.instance != "simt_chain":
                        continue
                    before = counter.launches
                    got = ft_gemm.ft_gemm(a2, b2, **kw)
                    check(counter.launches == before + 1,
                          f"SIMT chain {chain} {level}: one launch")
                    launched += 1
                    want = _plain_gemm(a2, b2, **kw)
                    err = max(err, _cmp_k1(
                        f"SIMT chain {'+'.join(chain)}{' act_grad' * ag} "
                        f"{level} {str(dtype)[6:]} {sm}x{sn}x{sk}", got,
                        want, kw, a2, b2,
                        tol=BF16_TOL if dtype == torch.bfloat16
                        else F32_TOL))
    check(launched >= 60, f"the chain instance ran {launched} calls")
    # SEUs on the chain instance at each level (integer f32 operands, a
    # residual chain; exact)
    a2, b2 = _ints(gen, 300, 700).float(), _ints(gen, 700, 520).float()
    bias2, res2 = _ints(gen, 520).float(), _ints(gen, 300, 520).float()
    for level in W_LEVELS[1:]:
        _chain_seu(f"SIMT chain bias+gelu+residual {level}", counter, a2, b2,
                   dict(chain=("bias", "gelu", "residual"), ft=_w_ft(level),
                        bias=bias2, residual=res2), 299, 3)
    # its time at whisper's w1 width, on a residual-after-gelu chain
    kw = dict(chain=("gelu", "residual"), residual=res, ft=FT)
    ms = time_ms(lambda: ft_gemm.ft_gemm(a, b, **kw), 3, warmup=1)
    plain_ms = time_ms(lambda: _plain_gemm(a, b, **kw), 1, warmup=0)
    lib_ms = time_ms(lambda: torch.nn.functional.gelu(
        torch.matmul(a, b), approximate="tanh") + res, 10)
    cb_ms, cb_by = bound(2.0 * m * n * k, nbytes + 2 * m * n)
    rows["ft_gemm_chain"]["max_abs_err"] = err
    rows["ft_gemm_chain"]["detail"].append(dict(
        shape="w1 gelu+residual", M=m, N=n, K=k, ms=ms, plain_ms=plain_ms,
        library_ms=lib_ms,
        library="torch.matmul, F.gelu(approximate='tanh'), add",
        bound_ms=cb_ms, bound_by=cb_by))
    print(f"  SIMT chain instance, w1 gelu+residual block ({m}x{n}x{k}): "
          f"{ms:.3f} ms, plain {plain_ms:.2f} ms, library {lib_ms:.4f} ms, "
          f"bound {cb_ms:.4f} ms ({cb_by}); {launched} chain calls held to "
          f"their plain versions")
    return rows


# ---------------------------------------------------------------------------
# act_chains: the last parts of the TPU kernels
# ---------------------------------------------------------------------------

#: act_chains: the chains of each case (K5 and K7 aux-free, K1 two or more
#: activations) and the SIMT K5's grid case (70 000 slices of 17 x 8 · 8 x 8)
K5_CHAINS = [("relu",), ("gelu", "relu")]
K7_CHAINS = [("silu",), ("gelu", "relu")]
K1_CHAINS = [("gelu", "relu"), ("bias", "silu", "relu", "residual")]
GRID_SLICES = 70_000


def _lib_chain(y, chain, bias=None, residual=None):
    """The library side of a chain: torch's own ops after the product."""
    for name in chain:
        if name == "bias":
            y = y + bias
        elif name == "residual":
            y = y + residual
        elif name == "gelu":
            y = torch.nn.functional.gelu(y, approximate="tanh")
        else:
            y = getattr(torch.nn.functional, name)(y)
    return y


def _hold_plain(label, name, call, plain, level, tol=BF16_TOL):
    """One call of instance ``name`` at ``level`` against its plain version
    under the same plan: one launch of that instance, outputs within
    ``tol`` of the top of the range, reports equal, no detection."""
    ft = _w_ft(level)
    (out, rep), n = _launched(KERNELS[name]["counter"], lambda: call(ft=ft))
    check(n == 1, f"{label} {level}: one launch of {name}")
    out_p, rep_p = plain(ft=ft)
    return _cmp_outputs(f"{label} {level}", out, out_p, rep, rep_p, tol=tol)


def _seu_hold(label, name, call, plain, level, inj, cell):
    """An SEU of 64 on integer operands at ``inj``, where the pre-activation
    is positive (no activation hides it): corrected to the clean output bit
    for bit, one detection and correction located at ``cell`` (row, col),
    the report's det / corr / row / col the plain version's; under
    detect-only the output moves at one cell and nothing is corrected."""
    ft = FT.replace(level=level)
    counter = KERNELS[name]["counter"]
    clean, _ = call(ft=ft)
    (fixed, rep), n = _launched(counter, lambda: call(ft=ft, inj=inj,
                                                      inj_mag=64.0))
    _, rep_p = plain(ft=ft, inj=inj, inj_mag=64.0)
    hit = rep[rep[..., 0] > 0]
    check(n == 1, f"{label} {level}: one launch of {name}")
    check(torch.equal(fixed, clean)
          and float(rep[..., 0].sum()) == float(rep[..., 1].sum()) == 1.0
          and (int(hit[-1, 2]), int(hit[-1, 3])) == cell
          and torch.equal(rep[..., :4], rep_p[..., :4]),
          f"{label} {level}: SEU at {cell} (inj {inj}) on {name} corrected "
          f"bit for bit and located, report as the plain version's")
    left, rep_d = call(ft=ft.replace(action="detect"), inj=inj, inj_mag=64.0)
    check(int((left != clean).sum()) == 1
          and float(rep_d[..., 0].sum()) >= 1.0
          and float(rep_d[..., 1].sum()) == 0.0,
          f"{label} {level}: detect-only leaves the SEU in one cell and "
          f"corrects nothing")


def _last_positive(pre):
    """The last index of a 1-D pre-activation that is positive."""
    return int((pre > 0).nonzero()[-1])


def _time_row(shape, call, plain, library, flops, nbytes, base, base_label,
              lib_queued=True, **extra):
    """A kernel row: the call's queued device ms at block beside ``base``,
    the same product without the chain (``base_label``: on which
    instance), in the same run; its plain version's ms, the library's (the
    product and then the chain: queued device time, or with ``lib_queued``
    false CUDA events over back-to-back calls, for a library call that
    waits on the host) and the bound."""
    ms = queued_ms(lambda: call(ft=FT), iters=10)
    base_ms = queued_ms(lambda: base(ft=FT), iters=10)
    plain_ms = time_ms(lambda: plain(ft=FT), 1, warmup=0)
    lib_ms = (queued_ms(library, iters=10) if lib_queued
              else time_ms(library, 10))
    b_ms, b_by = bound(flops, nbytes)
    print(f"  {shape}: {ms:.4f} ms (queued device time, block; without the "
          f"chain {base_ms:.4f} on {base_label}), plain {plain_ms:.2f} ms, "
          f"library {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    return dict(shape=shape, ms=ms, no_chain_ms=base_ms, no_chain=base_label,
                plain_ms=plain_ms, library_ms=lib_ms,
                library="torch.matmul (or torch._grouped_mm) then the "
                        "activations", bound_ms=b_ms, bound_by=b_by, **extra)


def _k5_chain_cases(gen, rows):
    """K5 with a chain on both instances: the tensor cores at dec_qk
    (qwen2-7b's decode QKᵀ on the permuted K cache), the SIMT chain
    instance at mamba2's ssd_cb (384 slices of 256 x 128 · 128 x 256)."""
    cfg, mcfg = qwen2_7b.CONFIG, mamba2_780m.CONFIG
    kvh, rep_n, dh = (cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads,
                      cfg.head_dim)
    q, sn = mcfg.ssm.chunk, mcfg.ssm.state
    nb = M_BATCH * (M_PROMPT // q) * mamba2.dims(mcfg)[1]

    def dec_qk(make):
        cache = make(gen, BATCH, MAX_LEN, kvh, dh)
        return make(gen, BATCH, kvh, rep_n, dh), cache.permute(0, 2, 3, 1)

    def ssd_cb(make):
        return make(gen, nb, q, sn), make(gen, nb, sn, q)

    for name, label, operands in (
            ("ft_gemm_batched_sm90", "K5 dec_qk", dec_qk),
            ("ft_gemm_batched_chain", "K5 ssd_cb", ssd_cb)):
        for chain in K5_CHAINS:
            tag = f"{label} {'+'.join(chain)}"
            a, b = operands(_rand)
            p = ft_gemm.plan_call(a, b, chain=chain, ft=FT)
            want = "sm90" if name.endswith("sm90") else "simt_chain"
            check(p.instance == want, f"{tag}: planned on {name} ({p})")

            def call(a=a, b=b, chain=chain, **kw):
                return ft_gemm.ft_gemm(a, b, chain=chain, **kw)

            def plain(a=a, b=b, chain=chain, **kw):
                return _plain_gemm(a, b, chain=chain, **kw)

            for level in W_LEVELS:
                rows[name]["max_abs_err"] = max(
                    rows[name]["max_abs_err"],
                    _hold_plain(tag, name, call, plain, level))
            m, k, n = a.shape[-2], a.shape[-1], b.shape[-1]
            slices = a.shape[:-2].numel()
            rows[name]["detail"].append(_time_row(
                tag, call, plain,
                lambda a=a, b=b, chain=chain: _lib_chain(torch.matmul(a, b),
                                                         chain),
                2.0 * slices * m * n * k,
                2 * slices * (m * k + k * n + m * n),
                lambda a=a, b=b, **kw: ft_gemm.ft_gemm(a, b, **kw),
                "the same instance" if want == "sm90" else "ft_gemm.cu",
                batch=slices, M=m, N=n, K=k, chain=chain))
            ai, bi = operands(_ints)
            step = min(1, ft_gemm.cdiv(k, p.tiles[2]) - 1)
            s_ = slices - 1
            row = m - 1
            col = _last_positive(ai.reshape(-1, m, k)[s_, row].float()
                                 @ bi.reshape(-1, k, n)[s_].float())

            def call_i(ai=ai, bi=bi, chain=chain, **kw):
                return ft_gemm.ft_gemm(ai, bi, chain=chain, **kw)

            def plain_i(ai=ai, bi=bi, chain=chain, **kw):
                return _plain_gemm(ai, bi, chain=chain, **kw)

            for level in W_LEVELS[1:]:
                _seu_hold(tag, name, call_i, plain_i, level,
                          (1, s_, row, col, step), (row, col))


def _k5_grid_case():
    """The SIMT K5 at GRID_SLICES slices of (17 x 8)·(8 x 8), more than a
    gridDim.z of 65 535 could hold: one launch, outputs and every report
    row equal to the plain version's, an SEU in the last slice corrected
    and located there."""
    gen = torch.Generator(device="cuda").manual_seed(70)
    a, b = _ints(gen, GRID_SLICES, 17, 8), _ints(gen, GRID_SLICES, 8, 8)
    check(ft_gemm.plan_call(a, b, ft=FT).instance == "simt",
          "K5 grid: the SIMT instance")
    for inj in (None, (1, GRID_SLICES - 1, 16, 7, 0)):
        kw = dict(ft=FT, inj=inj, inj_mag=64.0)
        (out, rep), n = _launched(ft_gemm.FT_GEMM_BATCHED,
                                  lambda: ft_gemm.ft_gemm(a, b, **kw))
        out_p, rep_p = _plain_gemm(a, b, **kw)
        hit = (rep[..., 0] > 0).nonzero().tolist()
        check(n == 1 and torch.equal(out, out_p)
              and torch.equal(rep[..., [0, 1, 2, 3, 7]],
                              rep_p[..., [0, 1, 2, 3, 7]])
              and hit == ([] if inj is None else [[GRID_SLICES - 1, 0, 0]]),
              f"K5 SIMT at {GRID_SLICES} slices of 17x8·8x8, one launch"
              f"{'' if inj is None else ', an SEU in the last slice'}: "
              f"outputs and every report row equal to the plain version's")


def _k7_chain_cases(gen, rows):
    """K7 with a chain on both instances at qwen3-moe's decode gate (64
    rows over 128 experts, 4 096 -> 1 536): the tensor cores in bf16, the
    SIMT chain instance in f32."""
    d, f = MOE.d_model, MOE.moe.expert_d_ff
    e, dec_rows = MOE.moe.n_experts, ENGINE_SLOTS * MOE.moe.top_k
    for name, dtype in (("ft_gemm_grouped_sm90", torch.bfloat16),
                        ("ft_gemm_grouped_chain", torch.float32)):
        bm = kgrouped.plan_grouped(dec_rows, f, d, dtype, n_groups=e)[0]
        lay = _moe_layout(gen, dec_rows, bm)
        live_rows, live_e = _live(lay)
        for chain in K7_CHAINS:
            tag = f"K7 decode gate {'+'.join(chain)} {str(dtype)[6:]}"
            w = _rand(gen, e, d, f, scale=0.02).to(dtype)
            buf = kgrouped.scatter_rows(_rand(gen, dec_rows, d).to(dtype),
                                        lay)
            args = (buf, w, lay.gid, lay.row_end)
            p = grouped_gemm.plan_k7_call(buf, w, lay.gid, ft=FT,
                                          chain=chain)
            want = "sm90" if name.endswith("sm90") else "simt_chain"
            check(p.instance == want, f"{tag}: planned on {name} ({p})")

            def call(args=args, chain=chain, **kw):
                return grouped_gemm.ft_gemm_grouped(*args, chain=chain, **kw)

            def plain(args=args, chain=chain, **kw):
                return grouped_gemm.planned_grouped_plain(*args, chain=chain,
                                                          **kw)

            tol = BF16_TOL if dtype == torch.bfloat16 else F32_TOL
            for level in W_LEVELS:
                rows[name]["max_abs_err"] = max(
                    rows[name]["max_abs_err"],
                    _hold_plain(tag, name, call, plain, level, tol=tol))
            lib, lib_label = _library_grouped(buf, w, lay)

            def library(lib=lib, chain=chain):
                y = lib()
                return ([_lib_chain(t, chain) for t in y]
                        if isinstance(y, list) else _lib_chain(y, chain))

            rows[name]["detail"].append(_time_row(
                tag, call, plain, library, 2.0 * live_rows * f * d,
                buf.element_size() * (live_rows * d + live_e * d * f
                                      + live_rows * f),
                lambda args=args, **kw: grouped_gemm.ft_gemm_grouped(*args,
                                                                     **kw),
                "the same instance" if want == "sm90"
                else "ft_gemm.cu GROUPED", lib_queued=False,
                rows=dec_rows, live_experts=live_e, K=d, N=f, chain=chain,
                library_call=lib_label))
            bi = kgrouped.scatter_rows(_ints(gen, dec_rows, d).to(dtype), lay)
            wi = _ints(gen, e, d, f).to(dtype)
            grp = e - 1                               # the ragged last group
            row = int(lay.row_end[grp]) - 1
            col = _last_positive(bi[row].float() @ wi[grp].float())
            args_i = (bi, wi, lay.gid, lay.row_end)

            def call_i(args=args_i, chain=chain, **kw):
                return grouped_gemm.ft_gemm_grouped(*args, chain=chain, **kw)

            def plain_i(args=args_i, chain=chain, **kw):
                return grouped_gemm.planned_grouped_plain(*args, chain=chain,
                                                          **kw)

            step = min(1, ft_gemm.cdiv(d, p.tiles[2]) - 1)
            for level in W_LEVELS[1:]:
                _seu_hold(tag, name, call_i, plain_i, level,
                          (1, row, col, step), (row, col))


def _k1_chain_cases(gen, rows):
    """K1's chains of two or more activations on the chain instance at
    whisper-medium's w1 (6 000 x 1 024 -> 4 096, bf16)."""
    cfg = whisper_medium.CONFIG
    m, n, k = W_BATCH * cfg.n_audio_frames, cfg.d_ff, cfg.d_model
    name = "ft_gemm_chain"
    a, b = _rand(gen, m, k), _rand(gen, k, n, scale=0.02)
    bias, res = _rand(gen, n, scale=0.02), _rand(gen, m, n)
    ai, bi = _ints(gen, m, k), _ints(gen, k, n)
    bias_i, res_i = _ints(gen, n), _ints(gen, m, n)
    for chain in K1_CHAINS:
        tag = f"K1 w1 {'+'.join(chain)}"
        aux = dict(bias=bias if "bias" in chain else None,
                   residual=res if "residual" in chain else None)
        p = ft_gemm.plan_call(a, b, chain=chain, ft=FT)
        check(p.instance == "simt_chain" and "two or more" in p.reason,
              f"{tag}: planned on the chain instance ({p.reason})")

        def call(chain=chain, aux=aux, **kw):
            return ft_gemm.ft_gemm(a, b, chain=chain, **aux, **kw)

        def plain(chain=chain, aux=aux, **kw):
            return _plain_gemm(a, b, chain=chain, **aux, **kw)

        for level in W_LEVELS:
            rows[name]["max_abs_err"] = max(
                rows[name]["max_abs_err"],
                _hold_plain(tag, name, call, plain, level))
        rows[name]["detail"].append(_time_row(
            tag, call, plain,
            lambda chain=chain, aux=aux: _lib_chain(torch.matmul(a, b), chain,
                                                    **aux),
            2.0 * m * n * k,
            2 * (m * k + k * n + m * n * (2 if "residual" in chain else 1)),
            lambda **kw: ft_gemm.ft_gemm(a, b, chain=("gelu",),
                                         tiles=p.tiles, **kw),
            f"ft_gemm.cu at {p.tiles}, gelu alone", M=m, N=n, K=k,
            chain=chain))
        kw = dict(chain=chain, ft=FT,
                  bias=bias_i if "bias" in chain else None,
                  residual=res_i if "residual" in chain else None)
        for level in W_LEVELS[1:]:
            _chain_seu(f"{tag} {level}", KERNELS[name]["counter"], ai, bi,
                       dict(kw, ft=FT.replace(level=level)), m - 1, 2)


def _front_door_path(gen):
    """The slice's entry points, once each at block, with every launch
    count set to 0 just before and read just after, under the dispatch
    guard: `ops.grouped_gemm_call` with a chain for K5 (tensor cores and
    SIMT), K7 (tensor cores and SIMT) and K8 (which drops the chain), and
    `ops.gemm_call` for K1's chain of several activations. Each output is
    held to the plain version under the same plan. Returns the counts."""
    from repro_torch.kernels.templates import KernelSpec
    cfg, mcfg = qwen2_7b.CONFIG, mamba2_780m.CONFIG
    kvh, rep_n, dh = (cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads,
                      cfg.head_dim)
    nb = M_BATCH * (M_PROMPT // mcfg.ssm.chunk) * mamba2.dims(mcfg)[1]
    d, f, e = MOE.d_model, MOE.moe.expert_d_ff, MOE.moe.n_experts
    rows = ENGINE_SLOTS * MOE.moe.top_k
    wm = whisper_medium.CONFIG
    chain = ("gelu", "relu")
    spec = KernelSpec(ft_level="block", epilogue=chain)
    k5 = [(_rand(gen, BATCH, kvh, rep_n, dh),
           _rand(gen, BATCH, MAX_LEN, kvh, dh).permute(0, 2, 3, 1)),
          (_rand(gen, nb, mcfg.ssm.chunk, mcfg.ssm.state),
           _rand(gen, nb, mcfg.ssm.state, mcfg.ssm.chunk))]
    ids = torch.randint(0, e, (rows,), generator=gen, device="cuda")
    k7 = [(_rand(gen, rows, d).to(dt), _rand(gen, e, d, f, scale=0.02).to(dt))
          for dt in (torch.bfloat16, torch.float32)]
    xg, gg = _rand(gen, 8 * rows, d), _rand(gen, 8 * rows, f)
    ids8 = torch.randint(0, e, (8 * rows,), generator=gen, device="cuda")
    k1 = (_rand(gen, 1000, wm.d_model), _rand(gen, wm.d_model, wm.d_ff,
                                              scale=0.02),
          _rand(gen, wm.d_ff, scale=0.02), _rand(gen, 1000, wm.d_ff))
    k1_chain = ("bias", "silu", "relu", "residual")
    torch.cuda.synchronize()
    for kern in KERNELS.values():
        kern["counter"].launches = 0
    guard = LibraryCallGuard()
    with guard:
        outs = [ops.grouped_gemm_call(spec, a, b, ft=FT) for a, b in k5]
        outs += [ops.grouped_gemm_call(spec, x, w, group_ids=ids, ft=FT)
                 for x, w in k7]
        dw, _ = ops.grouped_gemm_call(spec, xg, gg, group_ids=ids8,
                                      n_groups=e, ft=FT)
        outs.append(ops.gemm_call(
            KernelSpec(ft_level="block", epilogue=k1_chain), k1[0], k1[1],
            bias=k1[2], residual=k1[3], ft=FT))
        torch.cuda.synchronize()
    launches = {n_: k["counter"].launches for n_, k in KERNELS.items()}
    # The rows front door of K7 and K8 (`grouped_matmul_rows`,
    # `tgmm_matmul_rows`) passes on the row tile it plans as SIMT tiles, so
    # both run on their SIMT instances there, K7 with a chain on its chain
    # instance; the model paths call the buffer fronts without tiles.
    expect = {n_: 0 for n_ in KERNELS}
    expect.update(ft_gemm_batched_sm90=1, ft_gemm_batched_chain=1,
                  ft_gemm_grouped_chain=2, tgmm=1, ft_gemm_chain=1)
    print(f"  launches (the front doors' run): "
          f"{ {n_: c for n_, c in launches.items() if c} }")
    check(launches == expect, "the front doors launched K5's two instances, "
          "K7's SIMT chain instance (bf16 and f32), K8's SIMT instance and "
          "K1's chain instance once each, nothing else")
    check(not guard.hits, f"the dispatch guard saw no library call inside "
          f"the kernel calls ({guard.hits[:3]})")
    for (a, b), (out, rep) in zip(k5, outs[:2]):
        want, rep_p = _plain_gemm(a, b, chain=chain, ft=FT)
        _cmp_outputs(f"front door K5 {tuple(a.shape)}", out, want, rep, rep_p)
    for (x, w), (out, rep), dt in zip(k7, outs[2:4],
                                      (torch.bfloat16, torch.float32)):
        bm = kgrouped.plan_grouped(rows, f, d, dt, n_groups=e)[0]
        lay = kgrouped.make_layout(ids, e, bm)
        want, _ = grouped_gemm.planned_grouped_plain(
            kgrouped.scatter_rows(x, lay), w, lay.gid, lay.row_end,
            chain=chain, ft=FT)
        _cmp_outputs(f"front door K7 {dt}", out,
                     kgrouped.gather_rows(want, lay),
                     tol=BF16_TOL if dt == torch.bfloat16 else F32_TOL)
    dw0, _ = ops.grouped_gemm_call(KernelSpec(ft_level="block"), xg, gg,
                                   group_ids=ids8, n_groups=e, ft=FT)
    check(torch.equal(dw, dw0) and float(dw.min()) < 0.0,
          "front door K8: the chain dropped (the chain-free call's dw, "
          "negative entries kept), as the reference's front door drops it")
    want, rep_p = _plain_gemm(k1[0], k1[1], chain=k1_chain, bias=k1[2],
                              residual=k1[3], ft=FT)
    _cmp_outputs("front door K1 bias+silu+relu+residual", outs[4][0], want,
                 outs[4][1], rep_p)
    return launches


def phase_act_chains():
    """The last parts of the TPU kernels on the card: K5's and K7's
    activation chains on both instances of each, K1's chains of several
    activations on the chain instance, the SIMT K5 above 65 535 slices,
    and the slice's front doors."""
    gen = torch.Generator(device="cuda").manual_seed(32)
    names = ("ft_gemm_batched_sm90", "ft_gemm_batched_chain",
             "ft_gemm_grouped_sm90", "ft_gemm_grouped_chain",
             "ft_gemm_chain")
    rows = {n_: dict(max_abs_err=0.0, detail=[]) for n_ in names}
    _k5_chain_cases(gen, rows)
    _k5_grid_case()
    _k7_chain_cases(gen, rows)
    _k1_chain_cases(gen, rows)
    for r in rows.values():
        r["headline"] = r["detail"][0]["shape"]
    return _front_door_path(gen), rows


def _whisper_model(layers=None, seed=0):
    """whisper-medium at full width (``layers`` encoder and decoder layers,
    all of them by default), random bf16 weights from ``seed``."""
    cfg = whisper_medium.CONFIG
    if layers is not None:
        print(f"  depth cut: {layers} + {layers} of {cfg.enc_layers} + "
              f"{cfg.n_layers} layers")
        cfg = dataclasses.replace(cfg, n_layers=layers, enc_layers=layers)
    t0 = time.perf_counter()
    params = whisper.init(cfg, seed=seed, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    print(f"  init: {n_params / 1e9:.3f} B parameters in "
          f"{time.perf_counter() - t0:.1f} s")
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    prompts = torch.randint(0, cfg.vocab_size, (W_BATCH, W_PROMPT),
                            generator=gen, device="cuda")
    frames = torch.randn(W_BATCH, cfg.n_audio_frames, cfg.d_model,
                         generator=gen, device="cuda")
    steps = torch.randint(0, cfg.vocab_size, (2, W_BATCH, 1), generator=gen,
                          device="cuda")
    return cfg, params, prompts, frames, steps


def _w_run(cfg, level):
    return RunConfig(model=cfg, ft=FT_OFF if level == "off" else
                     FT.replace(level=level), dtype="bfloat16")


def _family_logits(params, cfg, run, prompts, feed, max_len, extra=None):
    """Logits of a prefill (``extra`` whisper's frames) and 2 decode steps
    fed ``feed`` through the family's serving functions, and the FT totals
    and sites."""
    batch = prompts.shape[0]
    prefill_fn, decode_fn = serve.make_serve_fns(cfg, run)
    with telemetry.ft_scope() as scope:
        cache = model_zoo.module_for(cfg).init_cache(cfg, batch, max_len)
        logits, cache = prefill_fn(params, prompts, cache, extra)
        out = [logits.float().reshape(batch, -1)]
        for i in range(2):
            logits, cache = decode_fn(params, feed[i], cache)
            out.append(logits.float().reshape(batch, -1))
        return out, scope.totals(), scope.sites()


def whisper_launches(cfg, level, prefills, decodes):
    """whisper's expected launch counts: K1 6 per encoder layer, 10 per
    decoder layer and the head per prefill, 8 per decoder layer and the
    head per decode step, all on the level's tensor-core instance (w1's
    gelu too); K2 once per encoder layer and twice per decoder layer per
    prefill, on the tensor cores at head dim 64; K5 4 per decoder layer
    per decode step on the tensor cores. FT off runs none: its products
    are the plain-matmul fast path, as in the reference."""
    if level == "off":
        return {n: 0 for n in KERNELS}
    k1 = (prefills * (6 * cfg.enc_layers + 10 * cfg.n_layers + 1)
          + decodes * (8 * cfg.n_layers + 1))
    return {**k1_launches(k1, level),
            **k5_launches(4 * cfg.n_layers * decodes),
            **k2_launches(prefills * (cfg.enc_layers + 2 * cfg.n_layers)),
            **NO_FLASH_BWD, **k6_launches(0), **OFF_PATH}


def _whisper_attention_kernels(gen, cfg):
    """K2 on the tensor cores at head dim 64 (`_flash_fwd_kernels`) at the
    prefill's three attention shapes: the encoder's self-attention (4 x 16
    heads over 1 500 frames, non-causal; with and without the statistics),
    the cross-attention (16 queries over 1 500 frames) and the decoder's
    causal self-attention (16 tokens); and K5 at the decode step's
    cross-cache products (xdec_qk, K = 64; xdec_pv, K = 1 500, P's rows
    padded to 1 504): each against its plain version (bf16), an SEU in
    K5's ragged last k-step corrected, the times beside the library call
    and the bound."""
    dh, h, ta = cfg.head_dim, cfg.n_heads, cfg.n_audio_frames
    out = {"ft_gemm_batched_sm90": dict(max_abs_err=0.0, detail=[])}
    for label, sq, skv, causal, stats in (
            ("whisper encoder self-attention", ta, ta, False, False),
            ("whisper encoder self-attention", ta, ta, False, True),
            ("whisper cross-attention prefill", W_PROMPT, ta, False, False),
            ("whisper decoder self-attention prefill", W_PROMPT, W_PROMPT,
             True, False)):
        _merge_rows(out, _flash_fwd_kernels(gen, label, h, h, W_BATCH, sq,
                                            stats, dh=dh, causal=causal,
                                            skv=skv))
    # K5 over the cross cache, as decode_attention passes it
    xk = _rand(gen, W_BATCH, ta, h, dh)
    xv = _rand(gen, W_BATCH, ta, h, dh)
    qg = _rand(gen, W_BATCH, h, 1, dh)
    pad = -ta % 8          # P's rows padded as decode_attention pads them
    pp = torch.softmax(torch.randn(W_BATCH, h, 1, ta + pad, device="cuda"),
                       -1).to(torch.bfloat16)[..., :ta]
    cases = {"xdec_qk": (qg, xk.permute(0, 2, 3, 1)),
             "xdec_pv": (pp, xv.transpose(1, 2))}
    counters = (ft_gemm.FT_GEMM_BATCHED_SM90, ft_gemm.FT_GEMM_BATCHED)
    for label, (a, b) in cases.items():
        mm, kd, nn = a.shape[-2], a.shape[-1], b.shape[-1]
        p = ft_gemm.plan_call(a, b, ft=FT)
        check(p.instance == "sm90", f"K5 whisper {label}: the tensor-core "
              f"instance ({p})")
        for level in W_LEVELS:
            ft = _w_ft(level)
            before = [c.launches for c in counters]
            got, rep = ft_gemm.ft_gemm(a, b, ft=ft)
            check([c.launches - x for c, x in zip(counters, before)]
                  == [1, 0], f"K5 whisper {label} {level}: one tensor-core "
                  f"launch")
            want, rep_p = _plain_gemm(a, b, ft=ft)
            out["ft_gemm_batched_sm90"]["max_abs_err"] = max(
                out["ft_gemm_batched_sm90"]["max_abs_err"],
                _cmp_outputs(f"K5 whisper {label} {level}", got, want, rep,
                             rep_p))
            if rep is not None:
                check(float(rep[..., 7].max()) == kd,
                      f"K5 whisper {label} {level}: tau's k counts {kd}, "
                      f"not the padded depth")
        ms = queued_ms(lambda: ft_gemm.ft_gemm(a, b, ft=FT))
        call_ms = time_ms(lambda: ft_gemm.ft_gemm(a, b, ft=FT), 30)
        lib_ms = queued_ms(lambda: torch.matmul(a, b))
        plain_ms = time_ms(lambda: _plain_gemm(a, b, ft=FT), 2)
        nb = W_BATCH * h
        b_ms, b_by = bound(2.0 * nb * mm * nn * kd,
                           2 * nb * (mm * kd + kd * nn + mm * nn))
        out["ft_gemm_batched_sm90"]["detail"].append(dict(
            shape=f"whisper {label}", batch=nb, M=mm, N=nn, K=kd, ms=ms,
            call_ms=call_ms, plain_ms=plain_ms, library_ms=lib_ms,
            bound_ms=b_ms, bound_by=b_by))
        print(f"  K5 whisper {label} ({nb}x{mm}x{nn}x{kd}): {ms:.5f} ms "
              f"device (queued), call {call_ms:.4f} ms, plain "
              f"{plain_ms:.3f} ms, torch.matmul {lib_ms:.5f} ms, bound "
              f"{b_ms:.5f} ms ({b_by})")
    # an SEU in xdec_pv's ragged last k-step (positions 1 280-1 499),
    # integer operands: corrected bit for bit, located
    a = _ints(gen, W_BATCH, h, 1, ta + pad)[..., :ta]
    b = _ints(gen, W_BATCH, ta, h, dh).transpose(1, 2)
    clean, _ = ft_gemm.ft_gemm(a, b, ft=FT)
    last, col = (ta - 1) // 256, dh // 2 + 1
    for level in W_LEVELS[1:]:
        fixed, rep = ft_gemm.ft_gemm(a, b, ft=FT.replace(level=level),
                                     inj=(1, 5, 0, col, last), inj_mag=64.0)
        cell = rep[rep[..., 0] > 0]
        check(torch.equal(fixed, clean) and float(rep[..., 1].sum()) == 1.0
              and (int(cell[0, 2]), int(cell[0, 3])) == (0, col),
              f"K5 whisper xdec_pv {level}: an SEU in the ragged last "
              f"k-step {last} corrected bit for bit and located")
    return out


def phase_whisper_check():
    """whisper-medium at full width, 2 + 2 layers: prefill and 2 decode
    steps through the kernels against their plain versions at FT off,
    block, tile and inner; whisper's attention kernels at their shapes."""
    cfg, params, prompts, frames, steps = _whisper_model(layers=2, seed=1)
    for level in W_LEVELS:
        run = _w_run(cfg, level)
        before = {n: k["counter"].launches for n, k in KERNELS.items()}
        got, tot_k, _ = _family_logits(params, cfg, run, prompts, steps,
                                       W_MAX_LEN, frames)
        launched = {n: k["counter"].launches - before[n]
                    for n, k in KERNELS.items()}
        with plain_kernels():
            want, tot_p, _ = _family_logits(params, cfg, run, prompts,
                                            steps, W_MAX_LEN, frames)
        _check_logits(f"whisper_check {level} kernel vs plain", got, want)
        check(tot_k["detected"] == 0 and tot_p["detected"] == 0,
              f"whisper_check {level}: zero detections (kernels {tot_k}, "
              f"plain {tot_p})")
        check(launched == whisper_launches(cfg, level, 1, 2),
              f"whisper_check {level}: launch counts "
              f"{ {n: c for n, c in launched.items() if c} }")
    gen = torch.Generator(device="cuda").manual_seed(12)
    return _whisper_attention_kernels(gen, whisper_medium.CONFIG)


@contextmanager
def w1_seu(mag=64.0, step=1):
    """A deterministic SEU in the first w1 product (encoder layer 0's gelu
    chain) under the context: `ops.fused_matmul`, which the FT front calls
    for every fused projection, with an injection on its first gelu call,
    at (5/7 of the rows, 3/5 of the columns). Yields the list of (report,
    row, col) of the injected call."""
    saved = ops.fused_matmul
    reps = []

    def injected(a, b, **kw):
        if kw.get("act") != "gelu" or reps:
            return saved(a, b, **kw)
        row, col = a.shape[0] * 5 // 7, b.shape[1] * 3 // 5
        out, rep = saved(a, b, **dict(kw, inject=InjectionSpec(
            row=row, col=col, magnitude=mag, k_step=step)))
        reps.append((rep, row, col))
        return out, rep

    ops.fused_matmul = injected
    try:
        yield reps
    finally:
        ops.fused_matmul = saved


def _serve_level(name, generate_fn, expected, prefill, new_cache, decode_fn,
                 params, batch, allow=None, groups=None):
    """One FT setting of a serving phase: ``generate_fn()`` (a `generate`
    call) once under the dispatch guard (``allow`` its allowance) with
    every launch counter at 0, checked against the ``expected`` counts and
    for zero detections, and once timed, which must repeat its tokens;
    then medians of 3 prefills (``prefill(cache)`` on ``new_cache()``) and
    of 6 decode steps, each timed alone, and one of each under
    torch.profiler (``groups`` as `device_profile` takes them). Returns
    (tokens, the launch counts, the guard, the setting's summary)."""
    for k_ in KERNELS.values():
        k_["counter"].launches = 0
    guard = LibraryCallGuard(allow=allow)
    torch.cuda.reset_peak_memory_stats()
    with telemetry.ft_scope() as scope, guard:
        toks = generate_fn()
        torch.cuda.synchronize()
    got = {n: k_["counter"].launches for n, k_ in KERNELS.items()}
    totals = scope.totals()
    print(f"  {name}: launches {({n: c for n, c in got.items() if c})}, "
          f"FT totals {totals}, library matmul / attention ops "
          f"{len(guard.hits)}, allowed {guard.allowed}")
    check(got == expected, f"{name}: the expected launch counts")
    check(totals["detected"] == 0, f"{name}: zero detections")
    t0 = time.perf_counter()
    again = generate_fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check((again == toks).all(), f"{name}: the timed run repeats the "
          f"greedy tokens")
    pre = []
    for _ in range(3):
        cache = new_cache()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = prefill(cache)
        torch.cuda.synchronize()
        pre.append((time.perf_counter() - t0) * 1e3)
    state = {"tok": torch.argmax(logits, -1)[:, None], "cache": cache}
    dec = []

    def one_decode():
        lg, state["cache"] = decode_fn(params, state["tok"], state["cache"])
        state["tok"] = torch.argmax(lg.reshape(batch, -1), -1)[:, None]

    for _ in range(6):
        t0 = time.perf_counter()
        one_decode()
        torch.cuda.synchronize()
        dec.append((time.perf_counter() - t0) * 1e3)
    prof = {"decode": device_profile(one_decode)}
    fresh = new_cache()
    prof["prefill"] = device_profile(lambda: prefill(fresh), groups=groups)
    print(f"  {name}: generate {wall:.3f} s ({toks.size / wall:.2f} new "
          f"tokens/s), prefill {statistics.median(pre):.1f} ms median "
          f"of {[round(x, 1) for x in pre]}, decode "
          f"{statistics.median(dec):.2f} ms a step median of "
          f"{[round(x, 2) for x in dec]}, peak {peak:.2f} GiB")
    for k_, v_ in prof.items():
        print(f"  {name} {k_} profile: {v_}")
    return toks, got, guard, dict(
        generate_s=wall, new_tokens_per_s=toks.size / wall,
        prefill_ms=statistics.median(pre), prefill_runs=pre,
        decode_ms_per_step=statistics.median(dec), decode_runs=dec,
        peak_gib=peak, launches={n: c for n, c in got.items() if c},
        profile=prof)


def phase_whisper_serve(smi: str):
    """`generate` on whisper-medium at full width and depth at FT off,
    block, tile and inner; at block again with K2 pinned to its SIMT
    instance; an SEU in w1 at each level corrected."""
    cfg, params, prompts, frames, _ = _whisper_model()
    prompts_np = prompts.cpu().numpy()
    sc = serve.ServeConfig(max_len=W_MAX_LEN)
    launches = {n: 0 for n in KERNELS}
    summary, tokens_at = {}, {}
    for level in W_LEVELS:
        run = _w_run(cfg, level)
        name = f"whisper_serve {level}"
        prefill_fn, decode_fn = serve.make_serve_fns(cfg, run)
        toks, got, guard, summary[level] = _serve_level(
            name, lambda: serve.generate(
                params, prompts_np, cfg, run, sc,
                max_new_tokens=W_NEW_TOKENS, extra=frames, device="cuda"),
            whisper_launches(cfg, level, 1, W_NEW_TOKENS),
            lambda cache: prefill_fn(params, prompts, cache, frames),
            lambda: whisper.init_cache(cfg, W_BATCH, W_MAX_LEN), decode_fn,
            params, W_BATCH)
        for n in launches:
            launches[n] += got[n]
        tokens_at[level] = toks
        check(toks.shape == (W_BATCH, W_NEW_TOKENS) and int(toks.min()) >= 0
              and int(toks.max()) < cfg.vocab_size,
              f"{name}: in-vocabulary tokens of the expected shape")
        if level != "off":
            check(not guard.hits, f"{name}: no library matmul / attention "
                  f"op dispatched")
    # K2 pinned to its SIMT instance (head dim 64 as it ran before the
    # tensor cores took it) at block: the prefill's logits against the
    # tensor cores' (the whisper_check rule), its busy time, and whether
    # the greedy tokens are the same (printed: a near-tie may flip one).
    run = _w_run(cfg, "block")
    prefill_fn, _ = serve.make_serve_fns(cfg, run)
    tc_logits, _ = prefill_fn(params, prompts, whisper.init_cache(
        cfg, W_BATCH, W_MAX_LEN), frames)
    with simt_flash_fwd():
        simt_logits, _ = prefill_fn(params, prompts, whisper.init_cache(
            cfg, W_BATCH, W_MAX_LEN), frames)
        simt_toks = serve.generate(params, prompts_np, cfg, run, sc,
                                   max_new_tokens=W_NEW_TOKENS, extra=frames,
                                   device="cuda")
        fresh = whisper.init_cache(cfg, W_BATCH, W_MAX_LEN)
        summary["block"]["profile"]["prefill SIMT K2"] = device_profile(
            lambda: prefill_fn(params, prompts, fresh, frames))
    _check_logits("whisper_serve block, K2 on the tensor cores vs SIMT",
                  [tc_logits.float()], [simt_logits.float()])
    same = int((simt_toks == tokens_at["block"]).sum())
    summary["block"]["simt_k2_same_tokens"] = same
    print(f"  whisper_serve block, K2 SIMT: {same} of {simt_toks.size} "
          f"greedy tokens as on the tensor cores; prefill profile "
          f"{summary['block']['profile']['prefill SIMT K2']}")
    # An SEU in encoder layer 0's w1 at each level: corrected, the prefill
    # logits those of the clean run to bf16 rounding, the tokens the clean
    # run's; detect-only leaves it (logits off, no correction).
    for level in W_LEVELS[1:]:
        run = _w_run(cfg, level)
        prefill_fn, _ = serve.make_serve_fns(cfg, run)
        clean, _ = prefill_fn(params, prompts, whisper.init_cache(
            cfg, W_BATCH, W_MAX_LEN), frames)
        with w1_seu() as reps, telemetry.ft_scope() as scope:
            toks = serve.generate(params, prompts_np, cfg, run, sc,
                                  max_new_tokens=W_NEW_TOKENS, extra=frames,
                                  device="cuda")
        tot = scope.totals()
        rep, row, col = reps[0]
        cell = rep[rep[..., 0] > 0]
        check(len(reps) == 1 and tot["detected"] == tot["corrected"] == 1.0
              and (int(cell[0, 2]), int(cell[0, 3])) == (row, col),
              f"whisper_serve {level}: the w1 SEU detected, corrected and "
              f"located once ({tot})")
        check((toks == tokens_at[level]).all(), f"whisper_serve {level}: "
              f"the tokens with the corrected SEU are the clean run's")
        for action in ("correct", "detect"):
            fn, _ = serve.make_serve_fns(cfg, RunConfig(
                model=cfg, ft=run.ft.replace(action=action),
                dtype="bfloat16"))
            with w1_seu(), telemetry.ft_scope() as scope:
                lg, _ = fn(params, prompts, whisper.init_cache(
                    cfg, W_BATCH, W_MAX_LEN), frames)
            err = (lg.float() - clean.float()).abs().max().item()
            scale = clean.float().abs().max().item()
            tot = scope.totals()
            if action == "correct":
                check(err <= BF16_TOL * scale, f"whisper_serve {level}: "
                      f"corrected prefill logits within {err:.3g} of the "
                      f"clean run's")
            else:
                check(err > BF16_TOL * scale and tot["corrected"] == 0.0
                      and tot["detected"] >= 1.0,
                      f"whisper_serve {level} detect-only: the SEU left "
                      f"(logits off by {err:.3g}), {tot}")
    print(json.dumps({"whisper_serve": dict(
        arch=cfg.arch_id, layers=[cfg.enc_layers, cfg.n_layers],
        batch=W_BATCH, prompt=W_PROMPT, frames=cfg.n_audio_frames,
        new_tokens=W_NEW_TOKENS, card=smi, levels=summary)}))
    return launches


# ---------------------------------------------------------------------------
# ssm_check / ssm_serve: mamba2-780m, the SSM family
# ---------------------------------------------------------------------------

#: mamba2-780m serving: 4 requests x 512 prompt tokens (two SSD chunks of
#: 256), 32 greedy tokens; ssm_check at 2 of the 48 layers
M_BATCH, M_PROMPT, M_NEW_TOKENS, M_MAX_LEN = 4, 512, 32, 1024
M_CHECK_LAYERS = 2
SSD_SITES = ("ssd_cb", "ssd_lx", "ssd_state", "ssd_ch")


def _mamba2_model(layers=None, seed=0):
    """mamba2-780m at full width (``layers`` deep, all 48 by default),
    random bf16 weights from ``seed``, the prompts and two decode tokens."""
    cfg = mamba2_780m.CONFIG
    if layers is not None:
        print(f"  depth cut: {layers} of {cfg.n_layers} layers")
        cfg = dataclasses.replace(cfg, n_layers=layers)
    t0 = time.perf_counter()
    params = mamba2.init(cfg, seed=seed, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    print(f"  init: {n_params / 1e9:.3f} B parameters in "
          f"{time.perf_counter() - t0:.1f} s")
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    prompts = torch.randint(0, cfg.vocab_size, (M_BATCH, M_PROMPT),
                            generator=gen, device="cuda")
    steps = torch.randint(0, cfg.vocab_size, (2, M_BATCH, 1), generator=gen,
                          device="cuda")
    return cfg, params, prompts, steps


def mamba2_launches(cfg, level, prefills, decodes):
    """mamba2's expected launch counts: K1 2 a layer (in_proj, out_proj)
    and the head per prefill and per decode step, on the level's tensor-
    core instance; K5 4 a layer per prefill (the SSD products, more than
    16 rows a slice), all on its SIMT instance by `plan_k5`'s rule; no
    other kernel. FT off runs none: its products take the plain-matmul
    fast path, as in the reference."""
    if level == "off":
        return {n: 0 for n in KERNELS}
    return {**k1_launches((2 * cfg.n_layers + 1) * (prefills + decodes),
                          level),
            "ft_gemm_batched_sm90": 0,
            "ft_gemm_batched": 4 * cfg.n_layers * prefills,
            **k2_launches(0), **NO_FLASH_BWD, **k6_launches(0), **OFF_PATH}


def _ssd_operands(cfg, make, gen):
    """The four SSD products of a 4 x 512-token prefill as `ssd_chunked`
    passes them: B·nc·H slices, Q = the chunk, N = the state, P = the
    head dim."""
    q, n, p = cfg.ssm.chunk, cfg.ssm.state, cfg.ssm.head_dim
    nb = M_BATCH * (M_PROMPT // q) * mamba2.dims(cfg)[1]
    return {"ssd_cb": (make(gen, nb, q, n), make(gen, nb, n, q)),
            "ssd_lx": (make(gen, nb, q, q), make(gen, nb, q, p)),
            "ssd_state": (make(gen, nb, n, q), make(gen, nb, q, p)),
            "ssd_ch": (make(gen, nb, q, n), make(gen, nb, n, p))}


def _ssd_kernels(gen, cfg):
    """K5's SIMT instance at the four SSD products: the plan, one launch
    each at FT off and each level against the plain version under the same
    plan (reports equal), an SEU of 64 on integer operands in one slice at
    its second k-step corrected bit for bit and located at its global row and
    column at each level, and left by detect-only; the times: the kernel
    at block and FT off (queued device time), the plain version, one
    torch.matmul on the same operands and the bound."""
    rows = dict(max_abs_err=0.0, detail=[])
    counters = (ft_gemm.FT_GEMM_BATCHED_SM90, ft_gemm.FT_GEMM_BATCHED)
    for label, (a, b) in _ssd_operands(cfg, _rand, gen).items():
        nb, m, k = a.shape
        n = b.shape[-1]
        p = ft_gemm.plan_call(a, b, ft=FT)
        check(p.instance == "simt" and p.tiles == ft_gemm.pick_tiles(m),
              f"K5 {label} ({nb}x{m}x{n}x{k}): the SIMT instance at "
              f"{p.tiles} by plan_k5's rule ({p.reason})")
        for level in W_LEVELS:
            ft = _w_ft(level)
            before = [c.launches for c in counters]
            got, rep = ft_gemm.ft_gemm(a, b, ft=ft)
            check([c.launches - x for c, x in zip(counters, before)]
                  == [0, 1], f"K5 {label} {level}: one SIMT launch")
            want, rep_p = _plain_gemm(a, b, ft=ft)
            rows["max_abs_err"] = max(rows["max_abs_err"], _cmp_outputs(
                f"K5 {label} {level}", got, want, rep, rep_p))
        ms = queued_ms(lambda: ft_gemm.ft_gemm(a, b, ft=FT))
        off_ms = queued_ms(lambda: ft_gemm.ft_gemm(a, b))
        lib_ms = queued_ms(lambda: torch.matmul(a, b))
        plain_ms = time_ms(lambda: _plain_gemm(a, b, ft=FT), 2)
        b_ms, b_by = bound(2.0 * nb * m * n * k,
                           2 * nb * (m * k + k * n + m * n))
        rows["detail"].append(dict(
            shape=f"mamba2 {label}", batch=nb, M=m, N=n, K=k, tiles=p.tiles,
            ms=ms, ft_off_ms=off_ms, plain_ms=plain_ms, library_ms=lib_ms,
            bound_ms=b_ms, bound_by=b_by))
        print(f"  K5 {label} ({nb}x{m}x{n}x{k}, SIMT {p.tiles}): {ms:.4f} ms "
              f"device (queued; FT off {off_ms:.4f}, {2.0 * nb * m * n * k / ms / 1e9:.1f} "
              f"TFLOP/s), plain {plain_ms:.2f} ms, torch.matmul "
              f"{lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    for label, (a, b) in _ssd_operands(cfg, _ints, gen).items():
        nb, m, k = a.shape
        n = b.shape[-1]
        s_, row, col = nb // 3, m * 5 // 7, n * 3 // 5
        step = min(1, ft_gemm.cdiv(k, ft_gemm.plan_call(a, b).tiles[2]) - 1)
        inj = (1, s_, row, col, step)
        for level in W_LEVELS[1:]:
            ft = FT.replace(level=level)
            clean, _ = ft_gemm.ft_gemm(a, b, ft=ft)
            fixed, rep = ft_gemm.ft_gemm(a, b, ft=ft, inj=inj, inj_mag=64.0)
            hit = (rep[..., 0] > 0).nonzero()
            cell = rep[rep[..., 0] > 0]
            check(torch.equal(fixed, clean) and hit.shape[0] == 1
                  and int(hit[0, 0]) == s_
                  and float(rep[..., 1].sum()) == 1.0
                  and (int(cell[0, 2]), int(cell[0, 3])) == (row, col)
                  and abs(float(cell[0, 4]) - 64.0) < 1e-2,
                  f"K5 {label} {level}: an SEU in slice {s_} at (row {row}, "
                  f"col {col}, k-step {step}) corrected bit for bit and "
                  f"located")
            left, rep_d = ft_gemm.ft_gemm(a, b, ft=ft.replace(
                action="detect"), inj=inj, inj_mag=64.0)
            diff = (left != clean).nonzero()
            check(diff.shape[0] == 1
                  and tuple(int(x) for x in diff[0]) == (s_, row, col)
                  and float(rep_d[..., 1].sum()) == 0.0
                  and float(rep_d[..., 0].sum()) >= 1.0,
                  f"K5 {label} {level}: the same SEU left in place by "
                  f"detect-only")
    return {"ft_gemm_batched": rows}


def phase_ssm_check():
    """mamba2-780m at full width, 2 layers: prefill and 2 decode steps
    through the kernels against their plain versions at FT off, block,
    tile and inner; K5's SIMT instance at the SSD products."""
    cfg, params, prompts, steps = _mamba2_model(layers=M_CHECK_LAYERS,
                                                seed=1)
    for level in W_LEVELS:
        run = _w_run(cfg, level)
        before = {n: k["counter"].launches for n, k in KERNELS.items()}
        got, tot_k, sites = _family_logits(params, cfg, run, prompts, steps,
                                           M_MAX_LEN)
        launched = {n: k["counter"].launches - before[n]
                    for n, k in KERNELS.items()}
        with plain_kernels():
            want, tot_p, _ = _family_logits(params, cfg, run, prompts, steps,
                                            M_MAX_LEN)
        _check_logits(f"ssm_check {level} kernel vs plain", got, want)
        check(tot_k["detected"] == 0 and tot_p["detected"] == 0,
              f"ssm_check {level}: zero detections (kernels {tot_k}, plain "
              f"{tot_p})")
        check(launched == mamba2_launches(cfg, level, 1, 2),
              f"ssm_check {level}: launch counts "
              f"{ {n: c for n, c in launched.items() if c} }")
        if level != "off":
            check(set(SSD_SITES) <= sites, f"ssm_check {level}: the four "
                  f"SSD products record their FT summaries")
    gen = torch.Generator(device="cuda").manual_seed(13)
    return _ssd_kernels(gen, cfg)


@contextmanager
def ssd_cb_seu(mag=64.0, step=0):
    """A deterministic SEU in the first batched product under the context
    (layer 0's ssd_cb in a mamba2 prefill): `ops.grouped_gemm_call`, which
    the batched FT front calls, with an injection on its first call in
    slice 5 at (5/7 of the rows, 3/5 of the columns). Yields the list of
    (report, slice, row, col) of the injected call."""
    saved = ops.grouped_gemm_call
    reps = []

    def injected(spec, a, b, **kw):
        if reps:
            return saved(spec, a, b, **kw)
        row, col = a.shape[-2] * 5 // 7, b.shape[-1] * 3 // 5
        out, rep = saved(spec, a, b, **dict(kw, inject=InjectionSpec(
            row=row, col=col, magnitude=mag, k_step=step), inj_batch=5))
        reps.append((rep, 5, row, col))
        return out, rep

    ops.grouped_gemm_call = injected
    try:
        yield reps
    finally:
        ops.grouped_gemm_call = saved


def phase_ssm_serve(smi: str):
    """`generate` on mamba2-780m at full width and depth at FT off, block,
    tile and inner; an SEU in layer 0's first ssd_cb at block corrected."""
    t_phase = time.perf_counter()
    cfg, params, prompts, _ = _mamba2_model()
    prompts_np = prompts.cpu().numpy()
    sc = serve.ServeConfig(max_len=M_MAX_LEN)
    launches = {n: 0 for n in KERNELS}
    summary, tokens_at = {}, {}
    for level in W_LEVELS:
        run = _w_run(cfg, level)
        name = f"ssm_serve {level}"
        prefill_fn, decode_fn = serve.make_serve_fns(cfg, run)
        toks, got, guard, summary[level] = _serve_level(
            name, lambda: serve.generate(
                params, prompts_np, cfg, run, sc,
                max_new_tokens=M_NEW_TOKENS, device="cuda"),
            mamba2_launches(cfg, level, 1, M_NEW_TOKENS),
            lambda cache: prefill_fn(params, prompts, cache),
            lambda: mamba2.init_cache(cfg, M_BATCH, M_MAX_LEN), decode_fn,
            params, M_BATCH, allow=ssm_readout(cfg),
            groups={"K5 SIMT": lambda k: "ft_gemm_kernel" in k})
        for n in launches:
            launches[n] += got[n]
        tokens_at[level] = toks
        prof = summary[level]["profile"]["prefill"]
        prof["k5_share"] = (prof["group_ms"]["K5 SIMT"] / prof["busy_ms"]
                            if prof["busy_ms"] else None)
        print(f"  {name}: K5's share of the prefill's device busy time "
              f"{prof['k5_share']}")
        # greedy over the padded head, as the reference's (random weights
        # may pick a padding row)
        check(toks.shape == (M_BATCH, M_NEW_TOKENS) and int(toks.min()) >= 0
              and int(toks.max()) < cfg.padded_vocab(),
              f"{name}: tokens of the expected shape inside the padded "
              f"vocabulary ({cfg.padded_vocab()})")
        if level != "off":
            check(not guard.hits and guard.allowed
                  == cfg.n_layers * M_NEW_TOKENS,
                  f"{name}: no library matmul / attention op dispatched but "
                  f"the decode readout, once a layer a step")
    # An SEU in layer 0's first ssd_cb at block: corrected, the clean run's
    # tokens, the prefill logits those of the clean run to bf16 rounding;
    # detect-only leaves it (detected, not corrected). Every detection is
    # the injected block's: at k-step 0 on real-valued scores the
    # correction leaves the f32 rounding of 64 (7.6e-6), which the next
    # step's tau (k = 64) may flag and correct again, as the plain version
    # does.
    run = _w_run(cfg, "block")
    prefill_fn, _ = serve.make_serve_fns(cfg, run)
    clean, _ = prefill_fn(params, prompts, mamba2.init_cache(
        cfg, M_BATCH, M_MAX_LEN))
    with ssd_cb_seu() as reps, telemetry.ft_scope() as scope:
        toks = serve.generate(params, prompts_np, cfg, run, sc,
                              max_new_tokens=M_NEW_TOKENS, device="cuda")
    tot, site_tot = scope.totals(), scope.site_totals()
    rep, s_, row, col = reps[0]
    hit = (rep[..., 0] > 0).nonzero()
    cell = rep[rep[..., 0] > 0]
    print(f"  ssm_serve block, ssd_cb SEU: FT totals {tot}, the injected "
          f"block's record {cell.tolist()}")
    check(len(reps) == 1 and tot["detected"] == tot["corrected"] >= 1.0
          and site_tot["ssd_cb"]["corrected"] == tot["corrected"]
          and float(rep[..., 1].sum()) == tot["corrected"]
          and hit.shape[0] == 1 and int(hit[0, 0]) == s_
          and (int(cell[0, 2]), int(cell[0, 3])) == (row, col),
          f"ssm_serve block: the ssd_cb SEU (slice {s_}, row {row}, col "
          f"{col}) detected, corrected and located in its one block, no "
          f"detection elsewhere ({tot})")
    check((toks == tokens_at["block"]).all(), "ssm_serve block: the tokens "
          "with the corrected SEU are the clean run's")
    for action in ("correct", "detect"):
        fn, _ = serve.make_serve_fns(cfg, RunConfig(
            model=cfg, ft=run.ft.replace(action=action), dtype="bfloat16"))
        with ssd_cb_seu(), telemetry.ft_scope() as scope:
            lg, _ = fn(params, prompts, mamba2.init_cache(
                cfg, M_BATCH, M_MAX_LEN))
        err = (lg.float() - clean.float()).abs().max().item()
        scale = clean.float().abs().max().item()
        tot = scope.totals()
        if action == "correct":
            check(err <= BF16_TOL * scale, f"ssm_serve block: corrected "
                  f"prefill logits within {err:.3g} of the clean run's")
        else:
            check(tot["corrected"] == 0.0 and tot["detected"] >= 1.0,
                  f"ssm_serve block detect-only: the SEU detected and left "
                  f"(logits off by {err:.3g}), {tot}")
    print(json.dumps({"ssm_serve": dict(
        arch=cfg.arch_id, layers=cfg.n_layers, batch=M_BATCH,
        prompt=M_PROMPT, new_tokens=M_NEW_TOKENS, card=smi,
        phase_s=time.perf_counter() - t_phase, levels=summary)}))
    return launches


def _merge_rows(rows, more):
    """Add a phase's kernel rows: shapes append, the max error is the
    larger; the first phase's headline shape stays."""
    for name, r in more.items():
        old = rows.get(name)
        if old is None:
            rows[name] = dict(r, headline=r.get("headline",
                                                r["detail"][0]["shape"]))
        else:
            old["detail"] += r["detail"]
            old["max_abs_err"] = max(old["max_abs_err"], r["max_abs_err"])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="env,kernels,serve_check,serve,"
                    "level_kernels,level_check,level_serve,ladder,"
                    "decode_kernels,engine_check,engine,train_kernels,"
                    "train_check,train,moe_kernels,moe_check,moe_engine,"
                    "moe_train,level_train,level_moe,campaign_kernels,"
                    "campaign_train,campaign_train_chunked,moe_campaign,"
                    "chain_kernels,act_chains,whisper_check,whisper_serve,"
                    "ssm_check,ssm_serve")
    ap.add_argument("--layers", type=int, default=qwen2_7b.CONFIG.n_layers,
                    help="serve and level_serve depth (the width is always "
                         "full)")
    ap.add_argument("--seed", type=int, default=0,
                    help="the engine phase's prompt lengths and budgets")
    args = ap.parse_args()
    phases = args.phases.split(",")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = None
    rows, by_path, failed, late_rows, chain_rows, act_rows = \
        {}, {}, [], {}, {}, {}
    t_start = time.perf_counter()
    for phase in phases:
        t0 = time.perf_counter()
        print(f"== {phase}", flush=True)
        try:
            if phase == "env":
                smi = phase_env()
            elif phase == "kernels":
                _merge_rows(rows, phase_kernels())
            elif phase == "serve_check":
                phase_serve_check()
            elif phase == "serve":
                by_path["serve"] = phase_serve(args.layers)
            elif phase == "level_kernels":
                # merged after the loop: the SIMT K7 / K8 rows keep the
                # moe_kernels phase's headline shape
                late_rows = phase_level_kernels()
            elif phase == "level_check":
                phase_level_check()
            elif phase == "level_serve":
                by_path["level_serve"] = phase_level_serve(args.layers)
            elif phase == "ladder":
                by_path["ladder"], more = phase_ladder()
                _merge_rows(rows, more)
            elif phase == "decode_kernels":
                _merge_rows(rows, phase_decode_kernels())
            elif phase == "engine_check":
                phase_engine_check()
            elif phase == "engine":
                by_path["engine"] = phase_engine(args.seed, smi)
            elif phase == "train_kernels":
                _merge_rows(rows, phase_train_kernels())
            elif phase == "train_check":
                phase_train_check()
            elif phase == "train":
                by_path["train"] = phase_train(smi)
            elif phase == "moe_kernels":
                _merge_rows(rows, phase_moe_kernels())
            elif phase == "moe_check":
                phase_moe_check()
            elif phase == "moe_engine":
                by_path["moe_engine"] = phase_moe_engine(args.seed, smi)
            elif phase == "moe_train":
                by_path["moe_train"] = phase_moe_train(smi)
            elif phase == "level_train":
                by_path["level_train"] = phase_level_train(smi)
            elif phase == "level_moe":
                by_path["level_moe"] = phase_level_moe(args.seed, smi)
            elif phase == "campaign_kernels":
                phase_campaign_kernels()
            elif phase == "campaign_train":
                by_path["campaign_train"] = phase_campaign_train(smi)
            elif phase == "campaign_train_chunked":
                by_path["campaign_train_chunked"] = \
                    phase_campaign_train_chunked(smi)
            elif phase == "moe_campaign":
                by_path["moe_campaign"] = phase_moe_campaign(smi)
            elif phase == "chain_kernels":
                # merged after the loop, as level_kernels: the earlier
                # phases' headline shapes stay
                chain_rows = phase_chain_kernels()
            elif phase == "act_chains":
                # merged after the loop too
                by_path["act_chains"], act_rows = phase_act_chains()
            elif phase == "whisper_check":
                _merge_rows(rows, phase_whisper_check())
            elif phase == "whisper_serve":
                by_path["whisper_serve"] = phase_whisper_serve(smi)
            elif phase == "ssm_check":
                _merge_rows(rows, phase_ssm_check())
            elif phase == "ssm_serve":
                by_path["ssm_serve"] = phase_ssm_serve(smi)
            else:
                raise SystemExit(f"unknown phase {phase!r}")
        except Exception:
            # Report and go on to the next phase (a failed build ends the
            # run): the script still exits non-zero with no result line.
            traceback.print_exc(file=sys.stdout)
            failed.append(phase)
            if phase == "env":
                break
        torch.cuda.empty_cache()
        print(f"== {phase} done in {time.perf_counter() - t0:.1f} s",
              flush=True)
    print(f"total {time.perf_counter() - t_start:.1f} s")
    _merge_rows(rows, late_rows)
    _merge_rows(rows, chain_rows)
    _merge_rows(rows, act_rows)
    if failed:
        print(f"chip_smoke: FAILED phases {failed}", flush=True)
        return 1
    if smi is not None:
        print(smi)
    entries = []
    for name, meta in KERNELS.items():
        r = rows.get(name)
        head = None
        if r is not None:
            head = next(d for d in r["detail"] if d["shape"] == r["headline"])
        counts = {path: c[name] for path, c in by_path.items()}
        entries.append({
            "name": name, "route": meta["route"], "source": meta["source"],
            "replaces": meta["replaces"],
            "launches": sum(counts.values()) if counts else None,
            "launches_by_path": counts,
            "max_abs_err": r["max_abs_err"] if r else None,
            "ms": head["ms"] if head else None,
            "plain_ms": head["plain_ms"] if head else None,
            "bound_ms": head["bound_ms"] if head else None,
            "bound_by": head["bound_by"] if head else None,
            "library_ms": head["library_ms"] if head else None,
            "shape": r["headline"] if r else None,
            "shapes": r["detail"] if r else None,
        })
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
