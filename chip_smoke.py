#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU: ``python3 chip_smoke.py``.

1. Build: compiles the CUDA kernels of the port's ``csrc/`` with nvcc (one
   process per source, all at once) into ``build/kernels/``.
2. Kernel checks: each kernel at ImageBERT-A's shapes (B=256, S=40, H=768,
   N=12, I=3072, bf16, seeded inputs) against its plain PyTorch version on
   the same card, within two bf16 ulps (CARD_ATOL, CARD_RTOL); then every
   kernel checked again and timed at the main path's batch (B=512), beside
   its bound, its plain version and one PyTorch library call of the same
   function (a yardstick the port never calls).
   The same for LXMERT's kernels at its shapes (lang F=23, visn T=10, seeded
   key masks with some all-masked rows): the cross and dual attention cores,
   the cross block in both directions, the dual block, and the self-attention
   and erf-GELU FFN blocks at S=23 and S=10. And for the fused encoder layer
   (``KMR_FUSED_LAYER=1``): ``layer_tail`` and ``encoder_layer`` at S=40 (no
   mask, tanh GELU), S=30 (ImageBERT-B's masks, some pairs with every key past
   the query masked, tanh), S=23 and S=10 (LXMERT's masks, erf), and the
   GEMM's "f32" epilogue at ImageBERT-B's label-conv shape; timed at B=512,
   S=30 beside the two blocks they replace. And the full-bias instance of
   ``attn_core`` / ``attn_core_cross`` (a head-shared [B, Sq, Sk] bias, the
   blocks' [B, 1, S, S] / [B, 1, F, T]): held to its plain version at S=40 and
   at LXMERT's 23<-10 and 10<-23, through both blocks, and a key mask spread over
   every query through it equal to the key-mask instance bit for bit; timed at
   B=512 beside SDPA with the same mask (no model path feeds a full bias).
3. Full-width scoring, three models, each a 2048-row synthetic TSV scored end
   to end through ``ScoringEngine`` (bf16, batch 512, random weights from
   the seed, the native parser inline, the engine's default loader): ImageBERT-A (12 x 768); LXMERT (9/5/5 x 768) on its default
   route, with ``KMR_DUAL_CROSS=1`` and with ``KMR_FUSED_LAYER=1``;
   ImageBERT-B (12 x 768, S=30, AM head) on its default route and with
   ``KMR_FUSED_LAYER=1``, and ImageBERT-C (B with the sen2forest query
   rewrite). Every launch counter is set to 0 just before each of the seven
   runs and read just after it, and must show exactly the launches that path
   makes. ImageBERT-A's scores are held against the plain path on the card
   (max |d score| <= SCORE_BAND). LXMERT's and ImageBERT-B's, whose heads make
   them more sensitive, are held against the f32 truth on the card (plain
   blocks in f32): both bf16 paths (kernels, plain) within SCORE_BAND of it
   (ImageBERT-B, whose AM head has a slope up to 7.5: the kernel path's worst
   pair within SCORE_BAND or B_KERNEL_OVER_PLAIN times the plain path's worst,
   whichever is larger, and its 99th percentile within SCORE_BAND), and within
   2 * SCORE_BAND of each other; each model's other routes against its
   default route within SCORE_BAND (the fused layer rounds as the two blocks
   do, so it is also reported whether they are bit-equal); ImageBERT-C equal
   to ImageBERT-B bit for bit on every row without the rewrite's trigger; each
   model against its f32 plain path on the CPU for a few pairs.
4. The attention backends and serving export. Kernel checks: ``mha`` and
   ``mha_packed`` (``csrc/mha.cu``) against their plain versions at S=40 with
   no bias, S=30 with ImageBERT-B's [B,1,1,S] key mask, with a [B,1,S,S] and
   a [B,N,S,S] bias, in bf16 (CARD_ATOL, CARD_RTOL) and f32 (MHA_F32_BAND),
   timed at B=512 beside their bounds and SDPA, and again with the launches
   queued behind a spinning kernel (the device's time alone) beside the host's
   time to enqueue one call. Paths, each with the launch
   counters around it: ImageBERT-A, -B and -C through
   ``ScoringEngine(attention_backend="pallas")`` (12 ``mha`` launches a batch,
   and B/C's label-conv ``gemm``), A held to the plain path within SCORE_BAND,
   B held to the f32 truth as its kernel path is, C equal to B off the trigger
   rows; ImageBERT-A in f32 (the engine picks "xla": 0 launches, TF32 off)
   within F32_SCORE_BAND of the f32 truth; ImageBERT-A exported at B=512 with
   "pallas_packed" (bit-equal to the engine's default route on one batch, the
   same kernel launches) and "xla" (within SCORE_BAND of the plain path), each
   reloaded from ``build/smoke/``; and ``ops/attention.py:mha_packed``, the
   only entry point of the ``mha_packed`` kernel (no model path reaches it, as
   in the JAX package).

5. Training (ImageBERT-A). Kernel checks at B=32 and B=256 (S=40, H=768, 12
   heads, I=3072, bf16): the GEMM's transposed-weight mode and training
   epilogues, ``ln_train``/``ln_train_bwd`` and ``attn_train``/``attn_train_bwd``
   (``csrc/ln_train.cu``, ``csrc/attn_train.cu``) against their plain versions
   at dropout 0 and 0.1, with and without a key mask (CARD_ATOL, CARD_RTOL;
   F32_OUT_BAND on f32 outputs), and at rate 0.5 the dropped units of each
   kernel equal to the hash mask's, bit for bit. Each timed at B=256 beside
   its bound, plain version and a library yardstick; the train blocks
   (``ops/train_blocks.py``) forward and backward the same, and held against
   their plain oracles' autograd at B=256 (y in the ulp band, the 7 gradients
   in relative L2 within TRAIN_GRAD_REL_L2). ``attn_train``/``attn_train_bwd``
   are also held and timed at LXMERT's self-attention shapes (S=23 and S=10,
   its key masks); every ``attn_train*`` and ``ln_train*`` row carries the
   device's time alone beside ``cuda_ms``, and the attention rows' yardstick is
   SDPA with dropout on its fastest fused backend, forward and backward chosen
   apart and named (``sdpa_library``, ``sdpa_backward_library``). Then the
   path: ImageBERT-A at full
   width (12 x 768), batch 256, dropout 0.1, random weights from the seed, on
   batches of a synthetic TSV through the port's hard-negative sampler. Step 1
   from one set of params, batch and seed on the kernel route, the plain route
   in bf16 and the plain route in f32 (the truth, TF32 off): the kernel route's
   gradients within TRAIN_STEP_REL_L2 of the truth in relative L2, or within
   TRAIN_OVER_PLAIN times the bf16 plain route's own error, whichever is
   larger, parameter by parameter. Then TRAIN_STEPS steps on the kernel route,
   device time split into forward, backward and optimizer (CUDA events), the
   launch counters exact at every step and the loss finite; two more steps
   under torch.profiler (device time by kernel, the device's busy share; the
   table in ``build/smoke/train/profile.txt``); and TRAIN_STEPS steps through
   ``cli/train.py`` (the "imagebert_a_train" path of
   the kernel line, host sampler included: end-to-end pairs/s). The rest of
   training: step 1's check runs with the MLM loss on (weight
   MLM_WEIGHT), so it holds ``cls/predictions`` and the tied word embeddings
   too; the MLM head's forward and backward at B=256 are timed beside their
   bound; ``cli/build_packed.py`` drains A's sampler over the TSV into packed
   shards (instances/s, bytes on disk), and TRAIN_STEPS steps through
   ``cli/train.py --packed-dir`` with the MLM loss, ``--grad-summaries`` and
   a valid pass every VALID_EVERY steps over a VALID_ROWS-row planted valid
   set ("imagebert_a_train_packed": the train launches of every step plus the
   scoring launches of every valid batch, exact; its pairs/s beside the
   sampler path's and the device's; each valid pass's seconds); then that run
   again as RESUME_AT steps and ``--resume`` for the rest, every parameter
   and moment bit-equal to the straight run's, and no gradient varying
   between three runs of one step on the same inputs.
   ImageBERT-B/C (its train blocks at S=30 with its key masks, every fourth
   pair's box keys all masked): the train blocks and ``attn_train``/
   ``attn_train_bwd`` held to their plain versions at S=30 and timed at B=256;
   the label conv's training Function (``ops/band_conv.py``: [2560, 6144] @ the
   band of 8 f32 taps) forward and backward held to its plain version's
   autograd and timed. Then the path: ImageBERT-B at full width, B=256, B's
   recipe (Adam on the staircase, per-value clip, AM loss, EMA) through
   ``train.Trainer`` on batches of B's sampler: step 1 held to the f32 truth as
   A's (the taps included), one step with the word-match loss (its head gets
   a gradient), TRAIN_STEPS timed steps with the launch counters exact at every
   step ("imagebert_b_train"), two profiled steps
   (``build/smoke/train/imagebert_b_profile.txt``), TRAIN_STEPS steps through
   ``cli/train.py --model imagebert_b`` whose checkpoint (8 taps)
   ``cli/score.py`` scores on the card (finite scores, exact launches), and
   B_C_CLI_STEPS steps of ``--model imagebert_c``; B's sampler drained by
   ``cli/build_packed.py`` (its word-match fields among the shards) and
   B_PACKED_STEPS steps through ``cli/train.py --packed-dir
   --word-match-weight 0.5`` ("imagebert_b_train_packed"). A's, B's and LXMERT's
   weight gradients are the glue of ``ops/train_blocks.py:weight_grads``.
6. Training (LXMERT). Kernel checks at B=32 and B=256, 23<-10 and 10<-23
   (H=768, 12 heads, bf16, seeded key masks with some visn rows all masked):
   ``attn_train_cross``/``attn_train_cross_bwd`` (``csrc/attn_train.cu``'s
   cross entry points) against their plain versions at dropout 0 and 0.1,
   with and without the key mask (CARD_ATOL, CARD_RTOL), and at rate 0.5 the
   dropped units equal to the hash mask's, bit for bit. The train cross block
   (``ops/train_blocks.py:cross_attention_block_train``) forward and backward
   against its plain oracle's autograd at B=256 (y in the ulp band, its 10
   gradients within TRAIN_GRAD_REL_L2); each timed at B=256 beside its bound,
   plain version and library yardstick. Then the path ("lxmert_train"):
   LXMERT 9/5/5 x 768, batch 256, dropout 0.1, random weights from the seed,
   batches of the LXMERT featurizer over the synthetic TSV with labels drawn
   from the seed, through ``train.Trainer``: step 1 on the kernel route, the
   plain route in bf16 and the f32 truth, with the MLM loss on the lang stream
   (MLM_POSITIONS masked positions a pair from the seed), held as
   ImageBERT-A's; one step
   with ``am_loss`` (the ``logit_W`` head gets a gradient); TRAIN_STEPS steps
   on the kernel route with the split device time and the launch counters
   exact at every step; two profiled steps (the table in
   ``build/smoke/train/lxmert_profile.txt``).
7. The host loaders and the one-shot run. A testB-like TSV of ONE_SHOT_ROWS
   rows from the seed (~58 pairs a query, each product under 1-3 queries,
   the sen2forest trigger in a tenth of the queries, one malformed row that
   must count as a parse error): ImageBERT-A at full width scores it through
   each host loader (the per-example Python path and the native span loader),
   with the launch counters set to 0 before each run and read after it; each
   loader's rows/s alone (no model), its end-to-end pairs/s, and the device's
   pairs/s on the same batches staged; the scores of both runs equal bit for
   bit. Then ``cli/main.py`` as a subprocess on the card (bf16, A's weights
   those of the runs here, B's and LXMERT's the CLI's seed-0 init): four
   score files of every valid pair, ImageBERT-A's
   equal to the in-process scores bit for bit, a ``submission.csv`` with a row
   for each query, and ``ensemble.vectorized.build_submission_vectorized`` on the card
   (float64) giving its rows, with the dedup filter keeping some pairs and
   dropping others; each scorer's wall and engine seconds and the total.
8. Checkpoint import and distillation, at full width. The reference's checkpoint
   forms written from the seed's weights by ``tests/torch_tf_bundle_writer.py``
   (numpy only) into ``build/smoke/distill/``: ImageBERT-A a TF1 bundle,
   ImageBERT-B a TF1 bundle of raw variables and EMA shadows (snappy index
   blocks), LXMERT 9/5/5 a ``BEST.pth`` state dict with ``module.`` prefixes.
   Each read by ``checkpoint.load_checkpoint`` (seconds, bytes), its params equal
   to the npz tree's, and ``cli/score.py`` on it (A, B, C, LXMERT; 2048 pairs)
   bit-equal to the npz route, B's scores unlike its raw variables'. Then
   ``cli/distill.py``: a DISTIL_LAYERS-layer ImageBERT-B student from the live
   12-layer teacher (the B bundle), ``--init-from-teacher``, TRAIN_STEPS steps at
   TRAIN_B and a valid pass (launches exact: the teacher's scoring blocks and
   the student's train blocks every step, the valid and agreement batches); the
   teacher's ms a batch and the student's step ms (CUDA events), pairs/s on the
   device and end to end; the student's ``best.npz`` through ``cli/score.py``
   (its shape from ``student_config.json``) equal to ``ScoringEngine`` on its
   params, its rank fidelity to the teacher (``cli/score_fidelity.py``) and
   both scorers' device pairs/s at B=512. ``cli/train.py --layers
   DISTIL_LAYERS --init-from <A npz> --distill-from <A bundle>`` for
   A_DISTIL_STEPS steps on phase 5's packed shards; ``cli/distill.py`` of an
   LX_STUDENT LXMERT student from ``BEST.pth``; step 1 of the B and A students
   against the f32 truth under phase 5's rule.
9. Two-tower recall (``models/two_tower.py``) at full width: 4 + 4 layers of
   768, 12 heads, tanh GELU, embed_dim 128, temperature 0.05, weights from the
   seed. The towers at B=512 over a testB-like TSV of ONE_SHOT_ROWS rows
   (~5,000 products, ~140 queries) through ``TowerEngine``, on the default
   route and with ``KMR_FUSED_LAYER=1`` (launches exact for each tower and
   batch): the query tower at S=20 and the product tower at S=10 under their
   key masks (products with no box among them), the label conv and both
   projections (N=128) on ``gemm_bf16``; the embeddings and the pairs' cosines
   held to the f32 truth within SCORE_BAND or B_KERNEL_OVER_PLAIN times the
   plain bf16 route's error, whichever is larger (phase 3's ImageBERT-B rule);
   device and end-to-end rows/s. Training at TRAIN_B on the TSV's positive
   rows (query groups from the query ids; the train blocks at dropout 0): step
   1 against the f32 truth under phase 5's rule, TRAIN_STEPS timed steps with
   exact launches, and TOWER_CLI_STEPS steps through ``cli/train.py --model
   two_tower`` with a valid pass. Its ``step_<N>.npz`` feeds ``cli/recall.py
   build --packed --store-features`` over the TSV and VALID_ROWS planted
   valid rows, then ``query`` and ``curve`` against the valid answers, then
   ``cli/cascade.py`` over the packed catalog (ImageBERT-B reranking the
   CASCADE_K recalled products of each valid query; recall@K and nDCG@5), its
   scores and rows equal to one ``ScoringEngine`` pass over the recalled
   candidates. ``cli/bench_recall_3m.py`` at 3M products x 128 as a
   subprocess (build and recall seconds, peak RSS, the recall curve, 64
   queries' top-500 held to a float64 oracle on the same bf16 values) beside
   the derived bound (the float16 catalog once over PCIe, the products at the
   bf16 peak). Both towers exported (``serving.export_tower``, "xla"),
   reloaded and equal to the live embedder bit for bit. The towers' blocks
   timed alone beside their library yardsticks (``block_libraries``).
10. The int8 serving path, data parallelism and the last utilities.
   ImageBERT-A at full width over phase 3's TSV in its ``int8-ffn`` and
   ``int8`` trees (``ops/quant.py``, residual leaves bf16) on the engine's
   default route beside the bf16 kernels: exact launches (int8-ffn: 12
   attention blocks' kernels a batch and no FFN kernel; int8: none), device
   and end-to-end pairs/s; ``dense_q8`` on the card equal to the CPU's at
   both FFN shapes (1e-6 relative), ``torch._int_mm`` alone beside its int8
   bound, ``gemm_bf16`` and ``torch.matmul``, the quant and dequant passes;
   ``tests/test_quant.py``'s rank fidelity at its MID config on the card
   and the CPU; both modes through ``cli/export.py --quantize``, reloaded
   bit-equal to the engine. ``cli/train.py --distributed`` under ``torchrun``
   (NCCL, world 1), DP_STEPS steps on phase 5's packed shards, bit-equal to
   the run without it; two gloo ranks on the card (this script with
   ``--dp-rank``): DP_TRAIN_STEPS steps of A at TRAIN_B, dropout TRAIN_RATE,
   each loss within DP_LOSS_BAND of one rank's and step 1's gradients within
   phase 5's TRAIN_STEP_REL_L2, and ``recall_sharded`` over RECALL_ROWS x 128
   with ties equal to one rank's recall; the train kernels' dropout on a
   rank's rows equal to the global batch's rows; ``cli/dryrun_multichip.py 2
   --device cuda`` with its full-config stage; ``best_mha``'s pick at A's and
   B's shapes; ``cli/bench_all.py`` and ``cli/perf_lab.py model_q8`` and
   ``int8``.
11. The JAX package's orbax checkpoints, read without orbax, tensorstore or
   JAX (``checkpoint/orbax_io.py``): the libzstd loaded and its version; the
   committed fixture ``tests/data/orbax_tiny_a/`` (written by orbax itself)
   leaf-equal to its npz twin; ImageBERT-A and the two-tower at full width
   written as orbax directories by ``tests/torch_orbax_writer.py``, each
   read by ``load_checkpoint`` beside its npz (seconds, MB/s), then phase
   3's 2,048 pairs scored through ``cli/score.py --checkpoint <dir>`` and a
   catalog built through ``cli/recall.py build``, bit-equal to the npz route
   with exact launches; the files deleted.

The GEMM sites (run after phase 2's kernel timings): every ``gemm_bf16``
launch shape of the driven paths (``gemm_sites()``: ImageBERT-A at S=40,
ImageBERT-B at S=30 with its label conv, LXMERT scoring on its default route
at 23 and 10 rows a pair with the cross blocks' Q and K/V products, the three
training steps at B=256 with the transposed-weight and aux epilogues and B's
label conv forward and dx), each
held against ``gemm_plain`` once and timed alone beside its bound, one
``torch.matmul`` of the same operands and its launches per batch or step (the
paths' launch counts, which the per-path sums must equal); and the host time
to enqueue one ``kernels.gemm`` call, without synchronising, over 1,000 calls.

Also in phase 2: ``layer_tail`` and ``attn_core`` at every other shape the
driven paths launch them (LXMERT's fused route S=23 and S=10, erf; the self
core at ImageBERT-B's S=30 and LXMERT's S=23 and S=10 with their key masks),
each beside its bound, plain version and library call.

``--seed N`` draws the inputs, data and weights from another seed (0 by
default). Prints the card's name and power limit, a ``{"kernels": [...]}``
line, and as its last line ``{"ok": true, "device": {...}}``. Exits
non-zero, with no result, when any phase fails or no CUDA device is present.
The full nvcc report (ptxas registers, shared memory, spills) goes to
``build/kernels/nvcc.log``; its summary lines are printed.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import os
import re
import shutil
import subprocess
import sys
import time
import traceback
from pathlib import Path

REPO = Path(__file__).resolve().parent
PKG = "kddcup_2020_multimodalitiesrecall_2nd_place_tpu_torch"
TPU_PKG_DIR = "kddcup_2020_multimodalitiesrecall_2nd_place_tpu"  # the reference, named in "replaces"

# NVIDIA H100 SXM data sheet, dense: bf16 tensor cores, f32 CUDA cores, HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_INT8_OPS = 1979e12
HBM_BYTES_PER_S = 3.35e12

CHECK_B, MAIN_B, S, H, N, I = 256, 512, 40, 768, 12, 3072
LX_F, LX_T = 23, 10  # LXMERT's lang and visn stream lengths
LX_DEPTHS = (9, 5, 5)  # l_layers, r_layers, x_layers
LX_DIRECTIONS = (("lang<-visn", LX_F, LX_T), ("visn<-lang", LX_T, LX_F))  # an x-layer's cross blocks: (F, T)
B_S = 30  # ImageBERT-B/C's sequence: 20 query + 10 image tokens
CONV_BLOCKS = 48  # [H, H] blocks of the 8x8 label-conv band inside the kernel's reach
# bf16 outputs: |d| <= CARD_ATOL + CARD_RTOL * |plain| elementwise, i.e. two bf16 ulps of the
# plain value (2^-6 relative) above a 1.6e-2 floor: kernel and plain version round the same
# intermediates, but their long sums run in another order, which can flip one bf16 rounding
CARD_ATOL, CARD_RTOL = 1.6e-2, 2.0**-6
F32_OUT_BAND = 1e-3  # f32 outputs of the residual epilogue (summation order only), abs
SCORE_BAND = 1e-2  # kernel path vs plain path, scores on the card
# LXMERT: its logit_fc head (a LayerNorm before the 2-way dense) spreads random-init scores
# over ~[0.40, 0.78], where ImageBERT-A's NSP head keeps them in ~[0.42, 0.46], so one bf16
# rounding flipped in any of its 58 blocks moves a score ~5x further. Each bf16 path (kernels,
# plain) is held to the f32 truth on the card within SCORE_BAND; two such paths then lie
# within 2 * SCORE_BAND of each other, the band of the kernel-vs-plain check there
LX_PAIR_BAND = 2 * SCORE_BAND
# LXMERT's routes: the environment flags each run sets
LX_ROUTES = {"lxmert": {}, "lxmert_dual_cross": {"KMR_DUAL_CROSS": True},
             "lxmert_fused_layer": {"KMR_FUSED_LAYER": True}}
# ImageBERT-B: its AM head (scale 30) turns the cosine gap into a score with a slope up to 7.5, and
# random-init scores spread over ~[0.46, 0.79]; both its bf16 paths (kernels, plain) lie about equally far
# from the f32 truth (mean |d| 2.4e-3, worst of 2048 pairs 1.1e-2 and 9.8e-3 at seed 0). The plain path is
# held to the truth within SCORE_BAND; the kernel path within SCORE_BAND at the 99th percentile, and at
# its worst pair within SCORE_BAND or B_KERNEL_OVER_PLAIN times the plain path's worst in the same run
B_KERNEL_OVER_PLAIN = 1.25
CPU_SCORE_BAND = 5e-2  # bf16 kernels vs the f32 plain path on the CPU
MHA_F32_BAND = 1e-5  # the f32 mha kernels vs their plain versions: summation order only, abs
F32_SCORE_BAND = 1e-4  # the f32 "xla" route vs the f32 truth (plain blocks in f32), scores on the card
N_ROWS, SEED = 2048, 0
# phase 7: a testB-like TSV (~58 pairs a query, products under 1-3 queries, ~59 KB a row), and the
# time limit of its one-shot subprocess
ONE_SHOT_ROWS, ONE_SHOT_TIMEOUT_S = 8192, 600
# training: ImageBERT-A's batch (scripts/train.py:55), a check batch, the steps of the path
TRAIN_B, TRAIN_CHECK_B, TRAIN_STEPS, TRAIN_RATE = 256, 32, 10, 0.1
B_C_CLI_STEPS = 3  # ImageBERT-C through cli/train.py: B's path on rewritten queries
# the rest of training: the MLM loss's weight in A's and LXMERT's step-1 checks and A's packed run (the
# sampler's 10 masked positions a pair), the valid TSV of A's packed run (make_eval_tsv rows, scored in
# MAIN_B batches every TRAIN_STEPS // 2 steps), ImageBERT-B's steps through --packed-dir, and the step at
# which the resume check splits A's packed run
MLM_WEIGHT, MLM_POSITIONS = 0.1, 10
# the MLM head's leaves and the table it is tied to: each must get a gradient in a step-1 check with the MLM on
MLM_HEAD = ("cls/predictions/output_bias", "cls/predictions/transform/dense/kernel",
            "cls/predictions/transform/LayerNorm/gamma", "bert/embeddings/word_embeddings")
VALID_ROWS, VALID_EVERY = 1024, TRAIN_STEPS // 2
B_PACKED_STEPS = 3
RESUME_AT = TRAIN_STEPS // 2
# the train blocks vs their plain oracles' autograd, bf16: the oracle rounds its weight and GELU gradients
# to bf16 at its casts, the kernels keep them f32, so gradients are held in relative L2
TRAIN_GRAD_REL_L2 = 2e-2
# one full-width step vs the f32 truth: each parameter's gradient within 5e-2 relative L2, or within 1.25 x
# the bf16 plain route's own error, whichever is larger (the ImageBERT-B rule of the scoring phase)
TRAIN_STEP_REL_L2, TRAIN_OVER_PLAIN = 5e-2, 1.25
# phase 9: the two-tower's layers per tower and embedding width (models/two_tower.py:TwoTowerConfig), its query
# and product lengths, the steps of cli/train.py --model two_tower, the cascade's k-recall, the 3M-product
# catalog of cli/bench_recall_3m.py and that subprocess's time limit, and the host link that catalog crosses
# (PCIe 5.0 x16, one direction, the H100 SXM's host interface)
TOWER_LAYERS, TOWER_D, TOWER_Q, TOWER_P = 4, 128, 20, 10
TOWER_CLI_STEPS, CASCADE_K = 5, 50
RECALL_3M, RECALL_3M_TIMEOUT_S = 3_000_000, 600
PCIE_BYTES_PER_S = 64e9
# phase 10: the rank-fidelity config of tests/test_quant.py (MID, 20 queries x 30 products); the steps of the
# torchrun world-1 run and of the two gloo ranks, the band that holds the ranks' losses to one rank's (relative;
# their gradients are held by TRAIN_STEP_REL_L2), a subprocess's time limit, and the sharded recall's catalog rows
# (not a multiple of 2)
MID = {"hidden_size": 128, "num_hidden_layers": 4, "num_attention_heads": 4, "intermediate_size": 512}
MID_Q, MID_P = 20, 30
DP_STEPS, DP_TRAIN_STEPS, DP_LOSS_BAND, DP_TIMEOUT_S = 5, 2, 1e-4, 600
RECALL_ROWS = 262_141


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
        return r.stdout.strip().splitlines()[0] if r.returncode == 0 and r.stdout.strip() else "unavailable"
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unavailable ({e})"


def ptxas_summary(text: str) -> list[str]:
    """The register, shared-memory and spill lines of one source's ``nvcc -Xptxas -v`` report, each
    prefixed by the function it describes (demangled where ``c++filt`` is on the path)."""
    rows, fn = [], "?"
    for line in text.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties for )([^' ]+)", line)
        if m:
            fn = m.group(1)
        elif "Used" in line or "spill" in line:
            rows.append((fn, line.replace("ptxas info    :", "").strip()))
    names = sorted({fn for fn, _ in rows})
    try:
        r = subprocess.run(["c++filt"], input="\n".join(names), capture_output=True, text=True, timeout=30)
        plain = dict(zip(names, r.stdout.splitlines())) if r.returncode == 0 else {}
    except (OSError, subprocess.TimeoutExpired):
        plain = {}
    return [f"{plain.get(fn, fn)}: {line}" for fn, line in rows]


def cuda_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn over iters launches, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


SPIN_CYCLES = 200_000_000  # ~0.1 s of one spinning kernel at the H100's clocks


def device_only_ms(torch, fn, iters: int = 20, warmup: int = 3) -> tuple[float, float]:
    """(mean device time of fn, host microseconds to enqueue one call): the iters calls are enqueued
    behind a kernel that spins for SPIN_CYCLES (doubled until the host finishes enqueueing before the
    spin ends), so the events around them read the device's time alone, where cuda_ms reads the
    larger of it and the host's enqueue."""
    for _ in range(warmup):
        fn()
    for attempt in range(4):
        torch.cuda.synchronize()
        spin, start, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        spin.record()
        torch.cuda._sleep(SPIN_CYCLES << attempt)
        start.record()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        host_s = time.perf_counter() - t0
        end.record()
        torch.cuda.synchronize()
        if host_s * 1e3 < spin.elapsed_time(start):
            return start.elapsed_time(end) / iters, host_s / iters * 1e6
    raise RuntimeError(f"the host took {host_s * 1e3:.1f} ms to enqueue {iters} calls, longer than the spin")


def fastest_fused(torch, make_call):
    """make_call(backend) -> a no-argument SDPA library call made under that backend. SDPA falls back
    to its math backend where no fused one takes the inputs, so the call returned carries in
    ``backends`` the fastest of the fused backends (flash, cuDNN, memory-efficient) that does, and
    time_row times it with only that one enabled; ``[MATH]`` where none does."""
    import warnings

    from torch.nn.attention import SDPBackend, sdpa_kernel

    best, chosen = float("inf"), None
    for backend in [getattr(SDPBackend, n) for n in ("FLASH_ATTENTION", "CUDNN_ATTENTION", "EFFICIENT_ATTENTION")
                    if hasattr(SDPBackend, n)]:
        try:
            with warnings.catch_warnings(), sdpa_kernel(backend):
                warnings.simplefilter("ignore")
                call = make_call(backend)
                ms = cuda_ms(torch, call, iters=5, warmup=1)
        except (RuntimeError, NotImplementedError):
            continue
        if ms < best:
            best, chosen = ms, call
            chosen.backends = [backend]
    if chosen is None:
        chosen = make_call(SDPBackend.MATH)
        chosen.backends = [SDPBackend.MATH]
    return chosen


def sdpa_library(torch, q, k, v, mask=None, dropout_p: float = 0.0):
    """One SDPA call on [B, heads, S, 64] operands, an optional additive mask and dropout: the library
    call of an attention core, on its fastest fused backend."""

    def call():
        return torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=mask, dropout_p=dropout_p)

    return fastest_fused(torch, lambda backend: call)


def sdpa_backward_library(torch, q, k, v, dout, mask=None, dropout_p: float = 0.0):
    """``torch.autograd.grad`` against dout of one SDPA call on [B, heads, S, 64] leaves that require
    grad (an optional additive mask, dropout): the library call of a training attention core's
    backward, its graph built under the fused backend that runs the backward fastest."""

    def make_call(backend):
        out = torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=mask, dropout_p=dropout_p)
        return lambda: torch.autograd.grad(out, (q, k, v), dout, retain_graph=True)

    return fastest_fused(torch, make_call)


def with_backends(fn, *sdpa_calls):
    """fn, a composite library call, tagged with the backends of the SDPA calls it makes."""
    fn.backends = sorted({b for c in sdpa_calls for b in c.backends}, key=lambda b: b.name)
    return fn


def nbytes_of(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound_ms(bytes_moved: float, flops: float, peak_flops: float) -> tuple[float, str]:
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, flops / peak_flops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def launch_counters() -> tuple:
    """Every wrapper with a launch counter: the kernels, then the blocks."""
    from importlib import import_module

    k = import_module(f"{PKG}.ops.kernels")
    blocks = [
        getattr(import_module(f"{PKG}.ops.{mod}"), mod)
        for mod in ("attention_block", "ffn_block", "cross_attention_block", "dual_cross_attention_block",
                    "encoder_layer")
    ]
    tb = import_module(f"{PKG}.ops.train_blocks")
    train = [tb.ffn_block_train, tb.ffn_block_train_backward, tb.attention_block_train,
             tb.attention_block_train_backward, tb.cross_attention_block_train,
             tb.cross_attention_block_train_backward]
    return (*k.WRAPPERS, *blocks, *train)


ROUTE_FLAGS = ("KMR_DUAL_CROSS", "KMR_FUSED_LAYER")


@contextlib.contextmanager
def route(**flags: bool):
    """Each of ROUTE_FLAGS set to 1 inside the block if named true, unset
    inside otherwise, and unset after it either way."""
    for name in ROUTE_FLAGS:
        if flags.get(name):
            os.environ[name] = "1"
        else:
            os.environ.pop(name, None)
    try:
        yield
    finally:
        for name in ROUTE_FLAGS:
            os.environ.pop(name, None)


@contextlib.contextmanager
def packed_route():
    """The "pallas_packed" attention backend inside the block: the route of the
    fused blocks (``models/core.py:Blocks``), which every engine on CUDA in
    bf16 takes by default, for model calls made outside an engine."""
    from importlib import import_module

    with import_module(f"{PKG}.ops.attention").attention_backend("pallas_packed"):
        yield


class Smoke:
    def __init__(self, torch, seed: int = SEED):
        self.torch = torch
        self.seed = seed
        self.dev = torch.device("cuda")
        self.gen = torch.Generator(device="cpu").manual_seed(seed)
        self.errors: dict[str, float] = {}
        self.failures: list[str] = []

    def randn(self, *shape, scale=1.0, dtype=None):
        t = scale * self.torch.randn(*shape, generator=self.gen)
        return t.to(self.dev, dtype or self.torch.float32)

    def check(self, name: str, kernel_name: str, got, want, atol: float, rtol: float = 0.0) -> None:
        torch = self.torch
        torch.cuda.synchronize()
        if isinstance(got, tuple):  # the two streams' outputs of a dual launch
            got, want = (torch.cat([t.float().flatten() for t in ts]) for ts in (got, want))
        got, want = got.float(), want.float()
        ok = got.shape == want.shape and bool(torch.isfinite(got).all())
        d = (got - want).abs() if ok else None
        err = d.max().item() if ok else float("inf")
        ok = ok and bool((d <= atol + rtol * want.abs()).all())
        self.errors[kernel_name] = max(self.errors.get(kernel_name, 0.0), err)
        log(f"check {name}: max_abs_err={err:.6g} band=|d| <= {atol:g} + {rtol:g}*|plain| "
            f"max|plain|={want.abs().max().item():.4g} {'ok' if ok else 'FAIL'}")
        if not ok:
            self.failures.append(name)

    # ---- phase 2: kernels against their plain versions --------------------------

    def layer_weights(self):
        w = {
            "wqkv": self.randn(H, 3 * H, scale=0.02, dtype=self.torch.bfloat16),
            "bqkv": self.randn(3 * H, scale=0.02),
            "wo": self.randn(H, H, scale=0.02, dtype=self.torch.bfloat16),
            "bo": self.randn(H, scale=0.02),
            "w1": self.randn(H, I, scale=0.02, dtype=self.torch.bfloat16),
            "b1": self.randn(I, scale=0.02),
            "w2": self.randn(I, H, scale=0.02, dtype=self.torch.bfloat16),
            "b2": self.randn(H, scale=0.02),
            "gamma": 1.0 + self.randn(H, scale=0.1),
            "beta": self.randn(H, scale=0.1),
        }
        return w

    def full_bias(self, b: int, sq: int, sk: int):
        """A head-shared [b, sq, sk] f32 bias from its own generator (the other draws keep their
        sequence): normal, with a quarter of the entries at -10000 (key 0 of every query live)."""
        torch = self.torch
        gen = torch.Generator(device="cpu").manual_seed(self.seed + 11 + sq * 100 + sk)
        bias = torch.randn(b, sq, sk, generator=gen)
        masked = torch.rand(b, sq, sk, generator=gen) < 0.25
        masked[..., 0] = False
        return bias.masked_fill(masked, -10000.0).to(self.dev)

    def check_kernels(self, w) -> None:
        from importlib import import_module

        k = import_module(f"{PKG}.ops.kernels")
        ab = import_module(f"{PKG}.ops.attention_block")
        fb = import_module(f"{PKG}.ops.ffn_block")
        att = import_module(f"{PKG}.ops.attention")
        torch = self.torch
        m = CHECK_B * S
        x = self.randn(CHECK_B, S, H, dtype=torch.bfloat16)
        x2d = x.reshape(m, H)
        qkv = k.gemm(x2d, w["wqkv"], w["bqkv"], "bias")
        self.check("gemm qkv [bias]", "gemm_bf16", qkv, k.gemm_plain(x2d, w["wqkv"], w["bqkv"], "bias"), CARD_ATOL, CARD_RTOL)
        for epi in ("gelu_tanh", "gelu_erf"):
            self.check(f"gemm ffn-up [{epi}]", "gemm_bf16", k.gemm(x2d, w["w1"], w["b1"], epi),
                       k.gemm_plain(x2d, w["w1"], w["b1"], epi), CARD_ATOL, CARD_RTOL)
        hmid = k.gemm_plain(x2d, w["w1"], w["b1"], "gelu_tanh")
        self.check("gemm out-proj [residual]", "gemm_bf16", k.gemm(x2d, w["wo"], w["bo"], "residual", x2d),
                   k.gemm_plain(x2d, w["wo"], w["bo"], "residual", x2d), F32_OUT_BAND)
        self.check("gemm ffn-down [residual]", "gemm_bf16", k.gemm(hmid, w["w2"], w["b2"], "residual", x2d),
                   k.gemm_plain(hmid, w["w2"], w["b2"], "residual", x2d), F32_OUT_BAND)
        mask = (torch.rand(CHECK_B, S, generator=self.gen) > 0.3).float()
        mask[:, 0] = 1.0
        key_bias = att.mask_to_bias(mask).to(self.dev)
        for label, kb in (("no bias", None), ("key mask", key_bias)):
            self.check(f"attn_core [{label}]", "attn_core", k.attn_core(qkv, kb, CHECK_B, S, N),
                       k.attn_core_plain(qkv, kb, CHECK_B, S, N), CARD_ATOL, CARD_RTOL)
        # the full-bias instance: a random head-shared [B, S, S] bias, and the key mask spread over every
        # query, which must give the key-mask instance's output bit for bit
        full = self.full_bias(CHECK_B, S, S)
        self.check("attn_core [full bias]", "attn_core", k.attn_core(qkv, full, CHECK_B, S, N),
                   k.attn_core_plain(qkv, full, CHECK_B, S, N), CARD_ATOL, CARD_RTOL)
        spread = key_bias[:, None, :].expand(CHECK_B, S, S).contiguous()
        self.check("attn_core [key mask as a full bias == key mask]", "attn_core",
                   k.attn_core(qkv, spread, CHECK_B, S, N), k.attn_core(qkv, key_bias, CHECK_B, S, N), 0.0)
        y = self.randn(m, H, scale=2.0) + 0.5
        self.check("layernorm", "layernorm", k.layernorm(y, w["gamma"], w["beta"]),
                   k.layernorm_plain(y, w["gamma"], w["beta"], out_dtype=torch.bfloat16), CARD_ATOL, CARD_RTOL)
        aw = [w[n] for n in ("wqkv", "bqkv", "wo", "bo", "gamma", "beta")]
        for label, kb in (("no bias", None), ("key mask", key_bias), ("full bias [B,1,S,S]", full[:, None])):
            self.check(f"attention_block [{label}]", "attention_block", ab.attention_block(x, *aw, N, kb),
                       ab.attention_block_plain(x, *aw, N, kb), CARD_ATOL, CARD_RTOL)
        fw = [w[n] for n in ("w1", "b1", "w2", "b2", "gamma", "beta")]
        for approx in (True, False):
            self.check(f"ffn_block [gelu {'tanh' if approx else 'erf'}]", "ffn_block",
                       fb.ffn_block(x, *fw, approximate_gelu=approx),
                       fb.ffn_block_plain(x, *fw, approximate_gelu=approx), CARD_ATOL, CARD_RTOL)

    def time_row(self, rows, name, key, kernel_fn, plain_fn, library_fn, nbytes, flops, peak,
                 atol=CARD_ATOL, rtol=CARD_RTOL, check=True, device=False) -> None:
        """Check kernel_fn against plain_fn once more (unless ``check`` is
        false: the caller held them), then time the kernel, its plain version
        and the library call into rows[name], beside the bound derived from
        nbytes and flops; with ``device``, also the kernel's and the library
        call's device time alone and the host's enqueue of one call
        (device_only_ms), for launches that take about as long on the device
        as the host takes to enqueue them."""
        from torch.nn.attention import sdpa_kernel

        torch = self.torch
        if check:
            self.check(f"{name} [B={MAIN_B}]", key, kernel_fn(), plain_fn(), atol, rtol)
        bms, by = bound_ms(nbytes, flops, peak)
        r = {
            "ms": cuda_ms(torch, kernel_fn),
            "plain_ms": cuda_ms(torch, plain_fn, iters=5),
            "bound_ms": bms,
            "bound_by": by,
            "library_ms": None,
        }
        if library_fn is not None and hasattr(library_fn, "backends"):  # SDPA on the backend chosen
            with sdpa_kernel(library_fn.backends):
                r["library_ms"] = cuda_ms(torch, library_fn)
            r["library_sdpa_backend"] = "+".join(b.name.lower() for b in library_fn.backends)
        elif library_fn is not None:
            r["library_ms"] = cuda_ms(torch, library_fn)
        rows[name] = r
        lib = f"{r['library_ms']:.4f}" if r["library_ms"] is not None else "n/a"
        if "library_sdpa_backend" in r:
            lib += f" (SDPA {r['library_sdpa_backend']})"
        log(f"time {name}: ms={r['ms']:.4f} bound_ms={bms:.4f} ({by}) plain_ms={r['plain_ms']:.4f} "
            f"library_ms={lib} achieved={flops / r['ms'] / 1e9:.1f} TFLOP/s")
        if not device:
            return
        r["device_ms"], r["host_enqueue_us"] = device_only_ms(torch, kernel_fn)
        msg = f"time {name}, device alone: ms={r['device_ms']:.4f}"
        if library_fn is not None:
            scope = sdpa_kernel(library_fn.backends) if hasattr(library_fn, "backends") else contextlib.nullcontext()
            with scope:
                r["library_device_ms"], r["library_host_enqueue_us"] = device_only_ms(torch, library_fn)
            msg += (f" library_ms={r['library_device_ms']:.4f}; host enqueue of one call {r['host_enqueue_us']:.1f} "
                    f"us (library {r['library_host_enqueue_us']:.1f})")
        log(msg)

    def time_kernels(self, w) -> dict[str, dict]:
        """Kernel / plain / library / bound times at the main path's batch, each
        kernel's output also held against its plain version at that batch."""
        from importlib import import_module

        k = import_module(f"{PKG}.ops.kernels")
        ab = import_module(f"{PKG}.ops.attention_block")
        fb = import_module(f"{PKG}.ops.ffn_block")
        torch = self.torch
        F = torch.nn.functional
        b, m = MAIN_B, MAIN_B * S
        x = self.randn(b, S, H, dtype=torch.bfloat16)
        x2d = x.reshape(m, H)
        qkv = k.gemm(x2d, w["wqkv"], w["bqkv"], "bias")
        hmid = k.gemm(x2d, w["w1"], w["b1"], "gelu_tanh")
        rows = {}

        def gemm_site(name, a, wt, bias, epi, res=None):
            mm, kk = a.shape
            nn = wt.shape[1]
            out_bytes = mm * nn * (4 if epi == "residual" else 2)
            nbytes = mm * kk * 2 + kk * nn * 2 + nn * 4 + out_bytes + (mm * nn * 2 if res is not None else 0)
            band = (F32_OUT_BAND, 0.0) if epi == "residual" else (CARD_ATOL, CARD_RTOL)
            self.time_row(rows, name, "gemm_bf16", lambda: k.gemm(a, wt, bias, epi, res),
                lambda: k.gemm_plain(a, wt, bias, epi, res),
                lambda: torch.matmul(a, wt), nbytes, 2.0 * mm * nn * kk, PEAK_BF16_FLOPS, *band)

        gemm_site("gemm_bf16 qkv", x2d, w["wqkv"], w["bqkv"], "bias")
        ctx = k.attn_core(qkv, None, b, S, N)
        gemm_site("gemm_bf16 out-proj", ctx, w["wo"], w["bo"], "residual", x2d)
        gemm_site("gemm_bf16 ffn-up", x2d, w["w1"], w["b1"], "gelu_tanh")
        gemm_site("gemm_bf16 ffn-down", hmid, w["w2"], w["b2"], "residual", x2d)

        q, kk_, v = (t.reshape(b, S, N, 64).transpose(1, 2).contiguous() for t in qkv.split(H, dim=1))
        self.time_row(rows, "attn_core", "attn_core", lambda: k.attn_core(qkv, None, b, S, N), lambda: k.attn_core_plain(qkv, None, b, S, N),
            sdpa_library(torch, q, kk_, v), m * 3 * H * 2 + m * H * 2,
            4.0 * b * N * S * S * 64, PEAK_BF16_FLOPS)
        full = self.full_bias(b, S, S)
        self.time_row(rows, f"attn_core S={S} full bias", "attn_core", lambda: k.attn_core(qkv, full, b, S, N),
                      lambda: k.attn_core_plain(qkv, full, b, S, N),
                      sdpa_library(torch, q, kk_, v, full.to(torch.bfloat16)[:, None]),
                      m * 3 * H * 2 + m * H * 2 + nbytes_of((full,)), 4.0 * b * N * S * S * 64, PEAK_BF16_FLOPS)
        y = self.randn(m, H)
        self.time_row(rows, "layernorm", "layernorm", lambda: k.layernorm(y, w["gamma"], w["beta"]),
            lambda: k.layernorm_plain(y, w["gamma"], w["beta"], out_dtype=torch.bfloat16),
            lambda: F.layer_norm(y, (H,), w["gamma"], w["beta"], 1e-12),
            m * H * 4 + 2 * H * 4 + m * H * 2, 8.0 * m * H, PEAK_F32_FLOPS)
        aw = [w[n] for n in ("wqkv", "bqkv", "wo", "bo", "gamma", "beta")]
        fw = [w[n] for n in ("w1", "b1", "w2", "b2", "gamma", "beta")]
        self.time_row(rows, "attention_block", "attention_block", lambda: ab.attention_block(x, *aw, N), lambda: ab.attention_block_plain(x, *aw, N),
            None, 2 * m * H * 2 + nbytes_of(aw),
            2.0 * m * H * 3 * H + 4.0 * b * N * S * S * 64 + 2.0 * m * H * H, PEAK_BF16_FLOPS)
        self.time_row(rows, "ffn_block", "ffn_block", lambda: fb.ffn_block(x, *fw), lambda: fb.ffn_block_plain(x, *fw), None,
            2 * m * H * 2 + nbytes_of(fw), 4.0 * m * H * I, PEAK_BF16_FLOPS)
        return rows

    # ---- the GEMM sites: every gemm_bf16 launch shape of the driven paths --------

    def time_gemm_sites(self) -> list[dict]:
        """Each launch shape of ``gemm_sites()`` on seeded operands (unit-scale
        activations, weights scaled by 1/sqrt(K), no bias on the transposed-weight
        products, as the train blocks call them): held against ``gemm_plain``
        once, then timed alone beside its bound and one ``torch.matmul`` of the
        same operands."""
        from importlib import import_module

        k = import_module(f"{PKG}.ops.kernels")
        torch = self.torch
        bf16 = torch.bfloat16
        gen = torch.Generator(device=self.dev).manual_seed(self.seed)

        def randn(*shape, scale=1.0, dtype=torch.float32):
            return (scale * torch.randn(*shape, generator=gen, device=self.dev)).to(dtype)

        rows = []
        for path, site, m, n, kk, epi, trans, launches in gemm_sites():
            a = randn(m, kk, dtype=bf16)
            w = randn(*((n, kk) if trans else (kk, n)), scale=kk ** -0.5, dtype=bf16)
            bias = None if trans else randn(n, scale=0.1)
            res = randn(m, n, dtype=bf16) if epi == "residual" else None
            aux = randn(m, n) if epi in k.AUX_IN else None
            label = f"{path} {site} [{m}x{n}x{kk} {epi}{' trans_b' if trans else ''}]"
            got = k.gemm(a, w, bias, epi, res, aux, trans)
            want = k.gemm_plain(a, w, bias, epi, res, aux, trans)
            if epi in k.SAVE:
                self.check(f"gemm site {label} out", "gemm_bf16", got[0], want[0], CARD_ATOL, CARD_RTOL)
                self.check(f"gemm site {label} u", "gemm_bf16", got[1], want[1], F32_OUT_BAND)
            elif epi in k.F32_OUT:
                self.check(f"gemm site {label}", "gemm_bf16", got, want, F32_OUT_BAND)
            else:
                self.check(f"gemm site {label}", "gemm_bf16", got, want, CARD_ATOL, CARD_RTOL)
            del got, want
            out_bytes = 4 if epi in k.F32_OUT else 2
            nbytes = (m * kk + kk * n) * 2 + (0 if bias is None else n * 4) + m * n * out_bytes
            nbytes += (m * n * 2 if res is not None else 0) + (m * n * 4 if aux is not None else 0)
            nbytes += m * n * 4 if epi in k.SAVE else 0
            flops = 2.0 * m * n * kk
            bms, by = bound_ms(nbytes, flops, PEAK_BF16_FLOPS)
            ms = cuda_ms(torch, lambda: k.gemm(a, w, bias, epi, res, aux, trans))
            wt = w.T if trans else w
            mm = cuda_ms(torch, lambda: torch.matmul(a, wt))
            rows.append({"path": path, "site": site, "m": m, "n": n, "k": kk, "epilogue": epi, "trans_b": trans,
                         "launches": launches, "ms": ms, "bound_ms": bms, "bound_by": by, "matmul_ms": mm,
                         "tflops": flops / ms / 1e9})
            log(f"gemm site {label}: ms={ms:.4f} bound_ms={bms:.4f} ({by}) matmul_ms={mm:.4f} "
                f"achieved={flops / ms / 1e9:.1f} TFLOP/s launches={launches}")
            del a, w, bias, res, aux
        return rows

    def gemm_enqueue_us(self, calls: int = 1000, repeats: int = 5) -> dict:
        """Host time to enqueue one ``kernels.gemm`` call, no synchronisation
        inside the timed loop, at LXMERT training's smallest product ([2560 x
        768] @ [768 x 768], "f32"), whose launch takes less device time than its
        enqueue: µs a call over ``calls`` calls, the best and the median of
        ``repeats`` runs."""
        from importlib import import_module

        k = import_module(f"{PKG}.ops.kernels")
        torch = self.torch
        a = self.randn(TRAIN_B * LX_T, H, dtype=torch.bfloat16)
        w = self.randn(H, H, scale=H ** -0.5, dtype=torch.bfloat16)
        bias = self.randn(H, scale=0.1)
        runs = []
        for _ in range(repeats):
            for _ in range(20):
                k.gemm(a, w, bias, "f32")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                k.gemm(a, w, bias, "f32")
            runs.append((time.perf_counter() - t0) / calls * 1e6)
            torch.cuda.synchronize()
        runs.sort()
        return {"best_us": runs[0], "median_us": runs[len(runs) // 2], "calls": calls, "repeats": repeats}

    # ---- phase 2, LXMERT: its kernels at its shapes ---------------------------

    def lxmert_case(self, w, b: int):
        """lang [b, 23, H] and visn [b, 10, H] bf16 streams, their key-mask
        biases (lang lengths 3..23; visn box counts 0..10, pair 0 with none, so
        every visn key of that pair is masked), the cross block's weights
        (Wq, bq, Wkv, bkv, Wo, bo, gamma, beta) and the dual block's (fused Wqkv)."""
        from importlib import import_module

        torch = self.torch
        att = import_module(f"{PKG}.ops.attention")
        lang = self.randn(b, LX_F, H, dtype=torch.bfloat16)
        visn = self.randn(b, LX_T, H, dtype=torch.bfloat16)
        nq = torch.randint(3, LX_F + 1, (b,), generator=self.gen)
        nb = torch.randint(0, LX_T + 1, (b,), generator=self.gen)
        nb[0] = 0
        lb = att.mask_to_bias((torch.arange(LX_F)[None] < nq[:, None]).float()).to(self.dev)
        vb = att.mask_to_bias((torch.arange(LX_T)[None] < nb[:, None]).float()).to(self.dev)
        cw = [w["wqkv"][:, :H].contiguous(), w["bqkv"][:H].contiguous(), w["wqkv"][:, H:].contiguous(),
              w["bqkv"][H:].contiguous(), w["wo"], w["bo"], w["gamma"], w["beta"]]
        dw = [w[n] for n in ("wqkv", "bqkv", "wo", "bo", "gamma", "beta")]
        return lang, visn, lb, vb, cw, dw

    def check_lxmert_kernels(self, w) -> None:
        from importlib import import_module

        k = import_module(f"{PKG}.ops.kernels")
        ab = import_module(f"{PKG}.ops.attention_block")
        fb = import_module(f"{PKG}.ops.ffn_block")
        cb = import_module(f"{PKG}.ops.cross_attention_block")
        db = import_module(f"{PKG}.ops.dual_cross_attention_block")
        b = CHECK_B
        lang, visn, lb, vb, cw, dw = self.lxmert_case(w, b)
        lqkv = k.gemm(lang.reshape(b * LX_F, H), w["wqkv"], w["bqkv"], "bias")
        vqkv = k.gemm(visn.reshape(b * LX_T, H), w["wqkv"], w["bqkv"], "bias")
        band = (CARD_ATOL, CARD_RTOL)
        for label, q, kv, bias, sq, sk in (
            ("lang<-visn", lqkv[:, :H].contiguous(), vqkv[:, H:].contiguous(), vb, LX_F, LX_T),
            ("visn<-lang", vqkv[:, :H].contiguous(), lqkv[:, H:].contiguous(), lb, LX_T, LX_F),
        ):
            self.check(f"attn_core_cross [{label}]", "attn_core_cross", k.attn_core_cross(q, kv, bias, b, sq, sk, N),
                       k.attn_core_cross_plain(q, kv, bias, b, sq, sk, N), *band)
            full = self.full_bias(b, sq, sk)
            self.check(f"attn_core_cross [{label}, full bias]", "attn_core_cross",
                       k.attn_core_cross(q, kv, full, b, sq, sk, N), k.attn_core_cross_plain(q, kv, full, b, sq, sk, N),
                       *band)
        pairs = zip(("lang<-visn", "visn<-lang"), k.attn_core_dual(lqkv, vqkv, lb, vb, b, LX_F, LX_T, N),
                    k.attn_core_dual_plain(lqkv, vqkv, lb, vb, b, LX_F, LX_T, N))
        for label, got, want in pairs:
            self.check(f"attn_core_dual [{label}]", "attn_core_dual", got, want, *band)
        for label, x, ctx, bias in (("lang<-visn", lang, visn, vb), ("visn<-lang", visn, lang, lb)):
            self.check(f"cross_attention_block [{label}]", "cross_attention_block",
                       cb.cross_attention_block(x, ctx, *cw, N, bias),
                       cb.cross_attention_block_plain(x, ctx, *cw, N, bias), *band)
            full = self.full_bias(b, x.shape[1], ctx.shape[1])[:, None]
            self.check(f"cross_attention_block [{label}, full bias [B,1,F,T]]", "cross_attention_block",
                       cb.cross_attention_block(x, ctx, *cw, N, full),
                       cb.cross_attention_block_plain(x, ctx, *cw, N, full), *band)
        pairs = zip(("lang", "visn"), db.dual_cross_attention_block(lang, visn, *dw, N, lb, vb),
                    db.dual_cross_attention_block_plain(lang, visn, *dw, N, lb, vb))
        for label, got, want in pairs:
            self.check(f"dual_cross_attention_block [{label}]", "dual_cross_attention_block", got, want, *band)
        fw = [w[n] for n in ("w1", "b1", "w2", "b2", "gamma", "beta")]
        for label, x, bias in ((f"S={LX_F}", lang, lb), (f"S={LX_T}", visn, vb)):
            self.check(f"attention_block [{label}, key mask]", "attention_block", ab.attention_block(x, *dw, N, bias),
                       ab.attention_block_plain(x, *dw, N, bias), *band)
            self.check(f"ffn_block [gelu erf, {label}]", "ffn_block", fb.ffn_block(x, *fw, approximate_gelu=False),
                       fb.ffn_block_plain(x, *fw, approximate_gelu=False), *band)

    def time_lxmert_kernels(self, w) -> dict[str, dict]:
        """The new launches at the main path's batch: kernel / plain / library /
        bound, each output held against its plain version once more."""
        from importlib import import_module

        k = import_module(f"{PKG}.ops.kernels")
        ab = import_module(f"{PKG}.ops.attention_block")
        fb = import_module(f"{PKG}.ops.ffn_block")
        cb = import_module(f"{PKG}.ops.cross_attention_block")
        db = import_module(f"{PKG}.ops.dual_cross_attention_block")
        torch = self.torch
        F = torch.nn.functional
        b = MAIN_B
        lang, visn, lb, vb, cw, dw = self.lxmert_case(w, b)
        rows = {}
        # the self-attention and FFN blocks at LXMERT's lengths, for the model's time breakdown
        fw = [w[n] for n in ("w1", "b1", "w2", "b2", "gamma", "beta")]
        for s, x, bias in ((LX_F, lang, lb), (LX_T, visn, vb)):
            m = b * s
            self.time_row(rows, f"attention_block S={s}", "attention_block",
                          lambda x=x, bias=bias: ab.attention_block(x, *dw, N, bias),
                          lambda x=x, bias=bias: ab.attention_block_plain(x, *dw, N, bias), None,
                          2 * m * H * 2 + nbytes_of((bias, *dw)),
                          2.0 * m * H * 3 * H + 4.0 * b * N * s * s * 64 + 2.0 * m * H * H, PEAK_BF16_FLOPS)
            self.time_row(rows, f"ffn_block S={s}", "ffn_block",
                          lambda x=x: fb.ffn_block(x, *fw, approximate_gelu=False),
                          lambda x=x: fb.ffn_block_plain(x, *fw, approximate_gelu=False), None,
                          2 * m * H * 2 + nbytes_of(fw), 4.0 * m * H * I, PEAK_BF16_FLOPS)
        lqkv = k.gemm(lang.reshape(b * LX_F, H), w["wqkv"], w["bqkv"], "bias")
        vqkv = k.gemm(visn.reshape(b * LX_T, H), w["wqkv"], w["bqkv"], "bias")
        dirs = {  # q rows, kv rows, the key stream's bias, Sq, Sk, query stream, key stream
            "lang<-visn": (lqkv[:, :H].contiguous(), vqkv[:, H:].contiguous(), vb, LX_F, LX_T, lang, visn),
            "visn<-lang": (vqkv[:, :H].contiguous(), lqkv[:, H:].contiguous(), lb, LX_T, LX_F, visn, lang),
        }
        sdpa = {}
        for label, (q, kv, bias, sq, sk, x, ctx) in dirs.items():
            # the library yardstick: SDPA with Sq != Sk and the key mask, [B, N, S, 64]
            qh = q.reshape(b, sq, N, 64).transpose(1, 2).contiguous()
            kh, vh = (t.reshape(b, sk, N, 64).transpose(1, 2).contiguous() for t in kv.split(H, dim=1))
            mask = bias.to(torch.bfloat16)[:, None, None, :]
            sdpa[label] = sdpa_library(torch, qh, kh, vh, mask)
            self.time_row(rows, f"attn_core_cross {label}", "attn_core_cross",
                          lambda q=q, kv=kv, bias=bias, sq=sq, sk=sk: k.attn_core_cross(q, kv, bias, b, sq, sk, N),
                          lambda q=q, kv=kv, bias=bias, sq=sq, sk=sk: k.attn_core_cross_plain(q, kv, bias, b, sq, sk, N),
                          sdpa[label], nbytes_of((q, kv, bias)) + b * sq * H * 2, 4.0 * b * N * sq * sk * 64,
                          PEAK_BF16_FLOPS)
            full = self.full_bias(b, sq, sk)
            self.time_row(rows, f"attn_core_cross {label} full bias", "attn_core_cross",
                          lambda q=q, kv=kv, full=full, sq=sq, sk=sk: k.attn_core_cross(q, kv, full, b, sq, sk, N),
                          lambda q=q, kv=kv, full=full, sq=sq, sk=sk: k.attn_core_cross_plain(q, kv, full, b, sq, sk, N),
                          sdpa_library(torch, qh, kh, vh, full.to(torch.bfloat16)[:, None]),
                          nbytes_of((q, kv, full)) + b * sq * H * 2, 4.0 * b * N * sq * sk * 64, PEAK_BF16_FLOPS)
            x2d, c2d, y = x.reshape(b * sq, H), ctx.reshape(b * sk, H), self.randn(b * sq, H)

            def lib(x2d=x2d, c2d=c2d, q=q, y=y, s=sdpa[label]):  # the five launches' library calls
                torch.matmul(x2d, cw[0]), torch.matmul(c2d, cw[2]), s(), torch.matmul(q, cw[4])
                return F.layer_norm(y, (H,), cw[6], cw[7], 1e-12)

            self.time_row(rows, f"cross_attention_block {label}", "cross_attention_block",
                          lambda x=x, ctx=ctx, bias=bias: cb.cross_attention_block(x, ctx, *cw, N, bias),
                          lambda x=x, ctx=ctx, bias=bias: cb.cross_attention_block_plain(x, ctx, *cw, N, bias),
                          with_backends(lib, sdpa[label]), nbytes_of((x, ctx, bias, *cw)) + b * sq * H * 2,
                          2.0 * b * sq * H * H + 2.0 * b * sk * H * 2 * H + 4.0 * b * N * sq * sk * 64
                          + 2.0 * b * sq * H * H, PEAK_BF16_FLOPS)
        both = tuple(sdpa.values())
        dual_flops = 2.0 * 4.0 * b * N * LX_F * LX_T * 64
        self.time_row(rows, "attn_core_dual", "attn_core_dual",
                      lambda: k.attn_core_dual(lqkv, vqkv, lb, vb, b, LX_F, LX_T, N),
                      lambda: k.attn_core_dual_plain(lqkv, vqkv, lb, vb, b, LX_F, LX_T, N),
                      with_backends(lambda: [s() for s in both], *both),
                      nbytes_of((lqkv, vqkv, lb, vb)) + b * (LX_F + LX_T) * H * 2,
                      dual_flops, PEAK_BF16_FLOPS)
        streams = [(lang.reshape(b * LX_F, H), lqkv[:, :H].contiguous(), self.randn(b * LX_F, H)),
                   (visn.reshape(b * LX_T, H), vqkv[:, :H].contiguous(), self.randn(b * LX_T, H))]

        def dual_lib():  # the seven launches' library calls: per stream QKV, out-proj, LN; both SDPAs
            for (x2d, ctx2d, y), s in zip(streams, both):
                torch.matmul(x2d, dw[0]), s(), torch.matmul(ctx2d, dw[2]), F.layer_norm(y, (H,), dw[4], dw[5], 1e-12)

        self.time_row(rows, "dual_cross_attention_block", "dual_cross_attention_block",
                      lambda: db.dual_cross_attention_block(lang, visn, *dw, N, lb, vb),
                      lambda: db.dual_cross_attention_block_plain(lang, visn, *dw, N, lb, vb),
                      with_backends(dual_lib, *both), nbytes_of((lang, visn, lb, vb, *dw)) + b * (LX_F + LX_T) * H * 2,
                      2.0 * b * (LX_F + LX_T) * H * 3 * H + dual_flops + 2.0 * b * (LX_F + LX_T) * H * H,
                      PEAK_BF16_FLOPS)
        return rows

    # ---- phase 2, ImageBERT-B/C: the fused encoder layer and the label conv -------

    def key_bias(self, b: int, s: int):
        """Seeded key-mask rows [b, s] as each model makes them, or None (S=40:
        ImageBERT-A masks nothing). S=30: ImageBERT-B's query lengths 2..20 and
        box counts 0..10, every fourth pair with no box, so all its keys past
        the query are masked; S=23/10: LXMERT's lang lengths 3..23 and visn box
        counts 0..10 (pair 0 with none)."""
        from importlib import import_module

        torch = self.torch
        att = import_module(f"{PKG}.ops.attention")
        if s == S:
            return None
        if s == B_S:
            nq = torch.randint(2, 21, (b,), generator=self.gen)
            nb = torch.randint(0, 11, (b,), generator=self.gen)
            nb[::4] = 0
            keep = torch.cat([torch.arange(20)[None] < nq[:, None], torch.arange(10)[None] < nb[:, None]], dim=1)
        else:
            n = torch.randint(3 if s == LX_F else 0, s + 1, (b,), generator=self.gen)
            n[0] = s if s == LX_F else 0
            keep = torch.arange(s)[None] < n[:, None]
        return att.mask_to_bias(keep.float()).to(self.dev)

    def layer_args(self, w):
        """The 12 weights of encoder_layer (LN2 with its own gamma and beta)."""
        g2, be2 = 1.0 + self.randn(H, scale=0.1), self.randn(H, scale=0.1)
        return [w[n] for n in ("wqkv", "bqkv", "wo", "bo", "gamma", "beta", "w1", "b1", "w2", "b2")] + [g2, be2]

    def label_band(self, dtype=None):
        """The label conv's banded weight [8H, 8H] from seeded taps (0.02), and its tiled bias."""
        from importlib import import_module

        ib = import_module(f"{PKG}.models.imagebert_b")
        band = ib.label_conv_band(0.02 * self.torch.randn(8, H, H, generator=self.gen),
                                  0.02 * self.torch.randn(H, generator=self.gen))
        return band["kernel"].to(self.dev, dtype or self.torch.bfloat16), band["bias"].to(self.dev)

    def check_layer_kernels(self, w) -> None:
        """layer_tail and encoder_layer against their plain versions at the four
        lengths (S=40 no mask, tanh; S=30 ImageBERT-B masks, tanh; S=23 and 10
        LXMERT masks, erf), and the "f32" epilogue at the label conv's shape."""
        from importlib import import_module

        k = import_module(f"{PKG}.ops.kernels")
        el = import_module(f"{PKG}.ops.encoder_layer")
        torch = self.torch
        b = CHECK_B
        lw = self.layer_args(w)
        for s, tanh in ((S, True), (B_S, True), (LX_F, False), (LX_T, False)):
            label = f"S={s}, {'key mask' if s != S else 'no mask'}, gelu {'tanh' if tanh else 'erf'}"
            x = self.randn(b, s, H, dtype=torch.bfloat16)
            bias = self.key_bias(b, s)
            self.check(f"encoder_layer [{label}]", "encoder_layer", el.encoder_layer(x, *lw, N, bias, tanh),
                       el.encoder_layer_plain(x, *lw, N, bias, tanh), CARD_ATOL, CARD_RTOL)
            ctx, x2d = self.randn(b * s, H, dtype=torch.bfloat16), x.reshape(b * s, H)
            self.check(f"layer_tail [{label}]", "layer_tail", k.layer_tail(ctx, x2d, *lw[2:], tanh),
                       k.layer_tail_plain(ctx, x2d, *lw[2:], tanh), CARD_ATOL, CARD_RTOL)
        band, bias = self.label_band()
        a = self.randn(b * 10, 8 * H, dtype=torch.bfloat16)
        self.check("gemm label conv [f32]", "gemm_bf16", k.gemm(a, band, bias, "f32"),
                   k.gemm_plain(a, band, bias, "f32"), F32_OUT_BAND)

    def time_layer_kernels(self, w) -> dict[str, dict]:
        """At ImageBERT-B's batch (B=512, S=30, its key masks): layer_tail,
        encoder_layer and the label conv's product, each kernel / plain /
        library / bound and held against its plain version once more; and the
        two blocks at S=30, for the model's time breakdown."""
        from importlib import import_module

        k = import_module(f"{PKG}.ops.kernels")
        ab = import_module(f"{PKG}.ops.attention_block")
        fb = import_module(f"{PKG}.ops.ffn_block")
        el = import_module(f"{PKG}.ops.encoder_layer")
        torch = self.torch
        b, s = MAIN_B, B_S
        m = b * s
        lw = self.layer_args(w)
        x, bias = self.randn(b, s, H, dtype=torch.bfloat16), self.key_bias(b, s)
        x2d, ctx = x.reshape(m, H), self.randn(m, H, dtype=torch.bfloat16)
        rows = {}
        tail_flops = 2.0 * m * H * H + 4.0 * m * H * I
        layer_flops = 2.0 * m * H * 3 * H + 4.0 * b * N * s * s * 64 + tail_flops
        y = self.randn(m, H)

        self.time_row(rows, f"layer_tail S={s}", "layer_tail", lambda: k.layer_tail(ctx, x2d, *lw[2:]),
                      lambda: k.layer_tail_plain(ctx, x2d, *lw[2:]), self.tail_library(ctx, y, lw, True),
                      3 * m * H * 2 + nbytes_of(lw[2:]), tail_flops, PEAK_BF16_FLOPS)
        # the library yardstick of the whole layer: one PyTorch call, erf GELU and a boolean key mask
        # (time only: it differs from the port in GELU, mask form and rounding points)
        ref_layer = torch.nn.TransformerEncoderLayer(
            H, N, I, dropout=0.0, activation="gelu", batch_first=True, norm_first=False, layer_norm_eps=1e-12,
        ).to(self.dev, torch.bfloat16).eval()
        pad = bias < 0

        def layer_lib():
            with torch.inference_mode():
                return ref_layer(x, src_key_padding_mask=pad)

        self.time_row(rows, f"encoder_layer S={s}", "encoder_layer", lambda: el.encoder_layer(x, *lw, N, bias),
                      lambda: el.encoder_layer_plain(x, *lw, N, bias), layer_lib,
                      2 * m * H * 2 + nbytes_of((bias, *lw)), layer_flops, PEAK_BF16_FLOPS)
        aw, fw = lw[:6], lw[6:]
        self.time_row(rows, f"attention_block S={s}", "attention_block", lambda: ab.attention_block(x, *aw, N, bias),
                      lambda: ab.attention_block_plain(x, *aw, N, bias), None, 2 * m * H * 2 + nbytes_of((bias, *aw)),
                      2.0 * m * H * 3 * H + 4.0 * b * N * s * s * 64 + 2.0 * m * H * H, PEAK_BF16_FLOPS)
        self.time_row(rows, f"ffn_block S={s}", "ffn_block", lambda: fb.ffn_block(x, *fw), lambda: fb.ffn_block_plain(x, *fw),
                      None, 2 * m * H * 2 + nbytes_of(fw), 4.0 * m * H * I, PEAK_BF16_FLOPS)
        band, cbias = self.label_band()
        a = self.randn(b * 10, 8 * H, dtype=torch.bfloat16)
        # the conv needs 48 of the band's 64 [H, H] blocks (each output sees the taps inside the kernel)
        self.time_row(rows, "gemm_bf16 label conv [f32]", "gemm_bf16", lambda: k.gemm(a, band, cbias, "f32"),
                      lambda: k.gemm_plain(a, band, cbias, "f32"), lambda: torch.matmul(a, band),
                      nbytes_of((a, band, cbias)) + b * 10 * 8 * H * 4, 2.0 * b * 10 * H * H * CONV_BLOCKS,
                      PEAK_BF16_FLOPS, F32_OUT_BAND, 0.0)
        return rows

    def tail_library(self, ctx, y, lw, tanh: bool):
        """layer_tail's launches as library calls (3 matmuls, GELU, 2 LayerNorms), on its inputs."""
        torch = self.torch
        F = torch.nn.functional

        def call():
            a = F.layer_norm(torch.matmul(ctx, lw[2]).float() + y, (H,), lw[4], lw[5], 1e-12).to(torch.bfloat16)
            hmid = F.gelu(torch.matmul(a, lw[6]), approximate="tanh" if tanh else "none")
            return F.layer_norm(torch.matmul(hmid, lw[8]).float() + y, (H,), lw[10], lw[11], 1e-12)

        return call

    def attn_core_case(self, b: int, s: int):
        """The self-attention core's inputs at batch b and length s: qkv [b*s, 3H] bf16, the key bias of
        the model with that length (key_bias), and SDPA's [b, N, s, 64] operands and bf16 mask."""
        torch = self.torch
        qkv = self.randn(b * s, 3 * H, dtype=torch.bfloat16)
        bias = self.key_bias(b, s)
        heads = [t.reshape(b, s, N, 64).transpose(1, 2).contiguous() for t in qkv.split(H, dim=1)]
        mask = None if bias is None else bias.to(torch.bfloat16)[:, None, None, :]
        return qkv, bias, heads, mask

    def time_path_shapes(self, w) -> dict[str, dict]:
        """layer_tail and attn_core at the driven paths' other shapes, at B=512: layer_tail at LXMERT's
        fused-route lengths S=23 and S=10 (erf GELU), attn_core at ImageBERT-B's S=30 and LXMERT's S=23
        and S=10 (their key masks); each kernel / plain / library / bound, held against its plain
        version once more (the main rows, layer_tail S=30 and attn_core S=40, are timed above)."""
        from importlib import import_module

        k = import_module(f"{PKG}.ops.kernels")
        torch = self.torch
        b, rows = MAIN_B, {}
        lw = self.layer_args(w)
        for s in (LX_F, LX_T):
            m = b * s
            x2d, ctx, y = self.randn(m, H, dtype=torch.bfloat16), self.randn(m, H, dtype=torch.bfloat16), self.randn(m, H)
            self.time_row(rows, f"layer_tail S={s}", "layer_tail",
                          lambda x2d=x2d, ctx=ctx: k.layer_tail(ctx, x2d, *lw[2:], False),
                          lambda x2d=x2d, ctx=ctx: k.layer_tail_plain(ctx, x2d, *lw[2:], False),
                          self.tail_library(ctx, y, lw, False), 3 * m * H * 2 + nbytes_of(lw[2:]),
                          2.0 * m * H * H + 4.0 * m * H * I, PEAK_BF16_FLOPS)
        for s in (B_S, LX_F, LX_T):
            qkv, bias, heads, mask = self.attn_core_case(b, s)
            self.time_row(rows, f"attn_core S={s}", "attn_core",
                          lambda qkv=qkv, bias=bias, s=s: k.attn_core(qkv, bias, b, s, N),
                          lambda qkv=qkv, bias=bias, s=s: k.attn_core_plain(qkv, bias, b, s, N),
                          sdpa_library(torch, *heads, mask),
                          nbytes_of((qkv, bias)) + b * s * H * 2, 4.0 * b * N * s * s * 64, PEAK_BF16_FLOPS)
        return rows

    # ---- phase 2, the attention backends: mha and mha_packed ---------------------

    def mha_cases(self, b: int):
        """The mha kernels' inputs at batch b, by row name: (q, k, v [b, N, S, 64],
        their packed [b, S, H] forms, the bias or None): ImageBERT-A's S=40 with no
        bias; ImageBERT-B's S=30 with its [B,1,1,S] key mask (every fourth pair's
        keys past the query all masked), with a full [B,1,S,S] bias (a random
        score bias under the same mask), and with a [B,N,S,S] one (mha only);
        and the key-mask case in f32."""
        torch = self.torch
        cases = {}
        for name, s, dtype, kind in (("S=40", S, torch.bfloat16, None), ("S=30 key mask", B_S, torch.bfloat16, "key"),
                                     ("S=30 [B,1,S,S] bias", B_S, torch.bfloat16, "full"),
                                     ("S=30 [B,N,S,S] bias", B_S, torch.bfloat16, "heads"),
                                     ("f32 S=30 key mask", B_S, torch.float32, "key")):
            packed = [self.randn(b, s, H, dtype=dtype) for _ in range(3)]
            heads = [t.reshape(b, s, N, 64).transpose(1, 2).contiguous() for t in packed]
            bias = None
            if kind is not None:
                bias = self.key_bias(b, s)[:, None, None, :]
                if kind == "full":
                    bias = bias + self.randn(b, 1, s, s)
                elif kind == "heads":
                    bias = bias + self.randn(b, N, s, s)
            cases[name] = (heads, packed, bias)
        return cases

    def check_mha_kernels(self) -> None:
        """mha and mha_packed against their plain versions at every case of
        mha_cases (B = CHECK_B): bf16 in the ulp band, f32 within 1e-5."""
        from importlib import import_module

        k = import_module(f"{PKG}.ops.kernels")
        for name, (heads, packed, bias) in self.mha_cases(CHECK_B).items():
            band = (MHA_F32_BAND, 0.0) if name.startswith("f32") else (CARD_ATOL, CARD_RTOL)
            self.check(f"mha [{name}]", "mha", k.mha(*heads, bias), k.mha_plain(*heads, bias), *band)
            if bias is None or bias.shape[1] == 1:
                self.check(f"mha_packed [{name}]", "mha_packed", k.mha_packed(*packed, N, bias),
                           k.mha_packed_plain(*packed, N, bias), *band)

    def time_mha_kernels(self) -> dict[str, dict]:
        """Each case at the main path's batch: kernel / plain / SDPA (the bias as
        a float mask in the inputs' dtype) / bound, held against the plain version
        once more; and the kernel's and SDPA's device time alone with the host's
        enqueue time of one call (device_only_ms), since a launch here takes about
        as long on the device as the host takes to enqueue it."""
        from importlib import import_module

        k = import_module(f"{PKG}.ops.kernels")
        torch = self.torch
        b, rows = MAIN_B, {}
        for name, (heads, packed, bias) in self.mha_cases(b).items():
            f32 = name.startswith("f32")
            band = (MHA_F32_BAND, 0.0) if f32 else (CARD_ATOL, CARD_RTOL)
            s, el = heads[0].shape[2], heads[0].element_size()
            nbytes = 4 * b * N * s * 64 * el + (0 if bias is None else nbytes_of((bias,)))
            flops, peak = 4.0 * b * N * s * s * 64, PEAK_F32_FLOPS if f32 else PEAK_BF16_FLOPS
            mask = None if bias is None else bias.to(heads[0].dtype)
            views = [t.view(b, s, N, 64).transpose(1, 2) for t in packed]  # SDPA on the packed buffers, in place
            calls = [(f"mha {name}", "mha", lambda h=heads, bi=bias: k.mha(*h, bi),
                      lambda h=heads, bi=bias: k.mha_plain(*h, bi), sdpa_library(torch, *heads, mask))]
            if bias is None or bias.shape[1] == 1:
                calls.append((f"mha_packed {name}", "mha_packed", lambda p=packed, bi=bias: k.mha_packed(*p, N, bi),
                              lambda p=packed, bi=bias: k.mha_packed_plain(*p, N, bi),
                              sdpa_library(torch, *views, mask)))
            for row, key, kernel_fn, plain_fn, library_fn in calls:
                self.time_row(rows, row, key, kernel_fn, plain_fn, library_fn, nbytes, flops, peak, *band,
                              device=True)
        return rows

    # ---- phase 3: the main path ----------------------------------------------

    def score_main_path(self) -> tuple[dict, dict]:
        from importlib import import_module

        import numpy as np

        torch = self.torch
        pkg = import_module(PKG)
        data = import_module(f"{PKG}.data")
        synthetic = import_module(f"{PKG}.data.synthetic")
        models = import_module(f"{PKG}.models")
        imagebert_a = import_module(f"{PKG}.models.imagebert_a")
        engine_mod = import_module(f"{PKG}.parallel.engine")
        tok = import_module(f"{PKG}.tokenization")

        work = pkg.BUILD_DIR / "smoke"
        work.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        tsv = work / "pairs.tsv"
        tsv.write_text("\n".join(synthetic.make_tsv(N_ROWS, seed=self.seed)) + "\n")
        labels = work / "labels.txt"
        labels.write_text("".join(f"{key}\t{val}\n" for key, val in synthetic.SYNTHETIC_LABELS.items()))
        spec = models.get_model("imagebert_a")
        cfg = spec.config
        if (cfg.hidden_size, cfg.num_hidden_layers, cfg.num_attention_heads) != (H, 12, N):
            raise RuntimeError(f"not the full-width config: {cfg} (is KMR_CONFIG_OVERRIDES set?)")
        params = spec.init_params(self.seed)
        engine = engine_mod.ScoringEngine(spec, params, device=self.dev, precision=models.Precision.bf16())
        featurizer = data.Featurizer(tok.FullTokenizer.google_style(pkg.VOCAB_PATH),
                                     data.load_multimodal_labels(labels))
        log(f"setup: {N_ROWS}-row TSV and {cfg.num_hidden_layers}x{cfg.hidden_size} params in "
            f"{time.perf_counter() - t0:.1f} s")

        batches = list(data.batches_from_files([tsv], featurizer.imagebert_a, MAIN_B))
        engine.score_batch(batches[0])  # warm-up: CUDA context, library handles, allocator
        torch.cuda.synchronize()

        counted = launch_counters()
        for w in counted:
            w.launches = 0
        stats = engine_mod.ScoringStats()
        result = engine.score_files([tsv], featurizer, MAIN_B, stats=stats)
        torch.cuda.synchronize()
        launches = {w.__name__: w.launches for w in counted}
        log(f"main path: {stats.pairs} pairs in {stats.batches} batches, {stats.seconds:.3f} s, "
            f"{stats.pairs_per_second:.1f} pairs/s end to end (host parse + featurize included)")
        log(f"launches: {json.dumps(launches)}")
        if stats.pairs != N_ROWS:
            raise RuntimeError(f"main path scored {stats.pairs} pairs, expected {N_ROWS}")

        # device time of the model alone on staged batches, and the plain path on the card
        staged = [engine.to_device(bt) for bt in batches]

        def run_all(blocks):
            return [imagebert_a.score(engine.params, bt, cfg, engine.precision, blocks) for bt in staged]

        with torch.inference_mode(), packed_route():
            dev_ms = cuda_ms(torch, lambda: run_all(models.KERNEL_BLOCKS), iters=3, warmup=1)
            plain_dev_ms = cuda_ms(torch, lambda: run_all(models.PLAIN_BLOCKS), iters=1, warmup=1)
            kern = torch.cat(run_all(models.KERNEL_BLOCKS)).float().cpu()
            plain = torch.cat(run_all(models.PLAIN_BLOCKS)).float().cpu()
        valid = torch.from_numpy(np.concatenate([bt["valid"] for bt in batches]))
        kern, plain = kern[valid], plain[valid]
        n_pad = len(batches) * MAIN_B
        log(f"device: model alone {dev_ms:.3f} ms for {n_pad} padded pairs = "
            f"{n_pad / dev_ms * 1e3:.1f} pairs/s (plain path {plain_dev_ms:.3f} ms)")
        if not bool(torch.isfinite(kern).all()) or kern.shape != (N_ROWS,):
            raise RuntimeError("kernel-path scores are not finite or of the wrong shape")
        d_score = (kern - plain).abs().max().item()
        engine_scores = torch.tensor([result[str(q)][str(p)] for bt in batches
                                      for q, p, ok in zip(bt["query_id"], bt["product_id"], bt["valid"]) if ok])
        d_engine = (engine_scores - kern).abs().max().item()
        same_rank, n_q = self.ranking_agreement(batches, kern, plain)
        log(f"scores: range [{kern.min().item():.5f}, {kern.max().item():.5f}], max |d| kernel vs plain "
            f"on the card = {d_score:.6g} (band {SCORE_BAND:g}), engine vs staged = {d_engine:.3g}, "
            f"identical per-query ranking in {same_rank}/{n_q} queries")
        if d_score > SCORE_BAND or d_engine > 1e-6:
            raise RuntimeError("kernel-path scores disagree with the plain path")

        # a small input against the f32 plain path on the CPU (the CPU tests' reference)
        small = {key: val[:8] for key, val in staged[0].items()}
        with torch.inference_mode(), packed_route():
            ref = imagebert_a.score(params, {key: val.cpu() for key, val in small.items()}, cfg,
                                    models.Precision.f32())
        d_cpu = (kern[:8] - ref).abs().max().item()
        log(f"scores: max |d| bf16 kernels vs f32 plain on the CPU, 8 pairs = {d_cpu:.6g} (band {CPU_SCORE_BAND:g})")
        if not d_cpu <= CPU_SCORE_BAND:
            raise RuntimeError("kernel-path scores disagree with the f32 CPU reference")
        rates = {"pairs": stats.pairs, "seconds": stats.seconds, "pairs_per_second": stats.pairs_per_second,
                 "device_ms": dev_ms, "device_pairs": n_pad, "device_pairs_per_second": n_pad / dev_ms * 1e3,
                 "plain_device_ms": plain_dev_ms, "max_abs_score_err": d_score,
                 "max_abs_score_err_vs_cpu_f32": d_cpu, "identical_rankings": [same_rank, n_q]}
        return launches, stats.batches, rates

    def time_unfused_layer(self, enc_params, cfg, prec, backend: str, bias, s: int) -> dict:
        """Layer 0's attention block and FFN block through ``models/core.py``
        under ``backend`` (the unfused route of "xla" and "pallas"), at B=MAIN_B,
        length s, on seeded inputs in the compute dtype: ms of each."""
        from importlib import import_module

        torch = self.torch
        core = import_module(f"{PKG}.models.core")
        att = import_module(f"{PKG}.ops.attention")
        lp = core.unbind_layers(enc_params)[0]
        x = self.randn(MAIN_B, s, H, dtype=prec.compute_dtype)
        with torch.inference_mode(), att.attention_backend(backend):
            a_ms = cuda_ms(torch, lambda: core.attention_block(lp["attention"], x, bias, cfg, prec), iters=10)
            f_ms = cuda_ms(torch, lambda: core.ffn_block(lp["ffn"], x, cfg, prec), iters=10)
        return {"attention_block_ms": a_ms, "ffn_block_ms": f_ms}

    def score_imagebert_a_backends(self) -> tuple[dict[str, dict], int, dict]:
        """ImageBERT-A at full width through ScoringEngine on the "pallas" backend
        (bf16: the unfused route, each attention core one mha launch) and in f32
        (the engine picks "xla" by itself: plain f32 products, TF32 off), with the
        launch counters around each run; then the serving export of the same
        weights, "pallas_packed" and "xla" in bf16, each reloaded and scoring one
        staged batch with the counters around it. Scores: "pallas" within
        SCORE_BAND of the plain path, as the default route is held; f32 within
        F32_SCORE_BAND of the f32 truth; the "pallas_packed" artifact bit-equal to
        the engine's default route on the same batch with the same kernel
        launches; the "xla" artifact within SCORE_BAND of the plain path."""
        from importlib import import_module

        import numpy as np

        torch = self.torch
        pkg = import_module(PKG)
        data = import_module(f"{PKG}.data")
        synthetic = import_module(f"{PKG}.data.synthetic")
        models = import_module(f"{PKG}.models")
        imagebert_a = import_module(f"{PKG}.models.imagebert_a")
        engine_mod = import_module(f"{PKG}.parallel.engine")
        tok = import_module(f"{PKG}.tokenization")
        att = import_module(f"{PKG}.ops.attention")
        kernels = import_module(f"{PKG}.ops.kernels")
        serving = import_module(f"{PKG}.serving")

        work = pkg.BUILD_DIR / "smoke"
        work.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        tsv = work / "pairs_backends.tsv"
        tsv.write_text("\n".join(synthetic.make_tsv(N_ROWS, seed=self.seed)) + "\n")
        labels = work / "labels.txt"
        labels.write_text("".join(f"{key}\t{val}\n" for key, val in synthetic.SYNTHETIC_LABELS.items()))
        spec = models.get_model("imagebert_a")
        cfg = spec.config
        if (cfg.hidden_size, cfg.num_hidden_layers, cfg.num_attention_heads) != (H, 12, N):
            raise RuntimeError(f"not the full-width config: {cfg} (is KMR_CONFIG_OVERRIDES set?)")
        params = spec.init_params(self.seed)
        bf16, f32 = models.Precision.bf16(), models.Precision.f32()
        engines = {
            "imagebert_a_pallas": engine_mod.ScoringEngine(spec, params, device=self.dev, precision=bf16,
                                                           attention_backend="pallas"),
            "imagebert_a_f32": engine_mod.ScoringEngine(spec, params, device=self.dev, precision=f32),
        }
        default = engine_mod.ScoringEngine(spec, params, device=self.dev, precision=bf16)
        tf32 = {"matmul": torch.backends.cuda.matmul.allow_tf32, "cudnn": torch.backends.cudnn.allow_tf32}
        log(f"backends: the f32 engine picked {engines['imagebert_a_f32'].attention_backend!r}, the bf16 one "
            f"{default.attention_backend!r}; TF32 {tf32}")
        if engines["imagebert_a_f32"].attention_backend != "xla" or default.attention_backend != "pallas_packed":
            raise RuntimeError("the engine's default backend rule picked another backend")
        if any(tf32.values()):
            raise RuntimeError("TF32 is on in f32 mode")
        featurizer = data.Featurizer(tok.FullTokenizer.google_style(pkg.VOCAB_PATH),
                                     data.load_multimodal_labels(labels))
        log(f"setup: {N_ROWS}-row TSV and {cfg.num_hidden_layers}x{cfg.hidden_size} params in "
            f"{time.perf_counter() - t0:.1f} s")
        batches = list(data.batches_from_files([tsv], featurizer.imagebert_a, MAIN_B))
        for engine in (*engines.values(), default):  # warm-up
            engine.score_batch(batches[0])
        torch.cuda.synchronize()

        launches, results, rates = {}, {}, {}
        counted = launch_counters()
        for run, engine in engines.items():
            for w in counted:
                w.launches = 0
            stats = engine_mod.ScoringStats()
            results[run] = engine.score_files([tsv], featurizer, MAIN_B, stats=stats)
            torch.cuda.synchronize()
            launches[run] = {w.__name__: w.launches for w in counted}
            log(f"main path {run}: {stats.pairs} pairs in {stats.batches} batches, {stats.seconds:.3f} s, "
                f"{stats.pairs_per_second:.1f} pairs/s end to end (host parse + featurize included)")
            log(f"launches {run}: {json.dumps(launches[run])}")
            if stats.pairs != N_ROWS:
                raise RuntimeError(f"{run} scored {stats.pairs} pairs, expected {N_ROWS}")
            rates[run] = {"pairs": stats.pairs, "seconds": stats.seconds, "pairs_per_second": stats.pairs_per_second}

        staged = [default.to_device(bt) for bt in batches]
        n_pad = len(batches) * MAIN_B

        def run_all(engine, blocks=models.KERNEL_BLOCKS):
            return torch.cat([imagebert_a.score(engine.params, bt, cfg, engine.precision, blocks)
                              for bt in staged]).float()

        scores = {}
        with torch.inference_mode():
            for run, engine in engines.items():
                with att.attention_backend(engine.attention_backend):
                    dev_ms = cuda_ms(torch, lambda: run_all(engine), iters=3, warmup=1)
                    scores[run] = run_all(engine).cpu()
                rates[run].update(device_ms=dev_ms, device_pairs=n_pad, device_pairs_per_second=n_pad / dev_ms * 1e3)
                log(f"device {run}: model alone {dev_ms:.3f} ms for {n_pad} padded pairs = "
                    f"{n_pad / dev_ms * 1e3:.1f} pairs/s")
            with packed_route():
                plain_all = run_all(default, models.PLAIN_BLOCKS).cpu()
                truth = run_all(engines["imagebert_a_f32"], models.PLAIN_BLOCKS).cpu()  # plain blocks in f32
        valid = torch.from_numpy(np.concatenate([bt["valid"] for bt in batches]))
        pallas, s32, plain, truth = (t[valid] for t in (scores["imagebert_a_pallas"], scores["imagebert_a_f32"],
                                                         plain_all, truth))
        for name, t in (("pallas", pallas), ("f32", s32)):
            if not bool(torch.isfinite(t).all()) or t.shape != (N_ROWS,):
                raise RuntimeError(f"ImageBERT-A {name} scores are not finite or of the wrong shape")
        d_pallas, d_f32 = (pallas - plain).abs().max().item(), (s32 - truth).abs().max().item()
        d_engine = max(
            (torch.tensor([results[run][str(q)][str(p)] for bt in batches
                           for q, p, ok in zip(bt["query_id"], bt["product_id"], bt["valid"]) if ok]) - t).abs().max().item()
            for run, t in (("imagebert_a_pallas", pallas), ("imagebert_a_f32", s32))
        )
        same_rank, n_q = self.ranking_agreement(batches, pallas, plain)
        log(f"scores imagebert_a: \"pallas\" vs the plain path max |d| = {d_pallas:.6g} (band {SCORE_BAND:g}), "
            f"identical per-query ranking in {same_rank}/{n_q} queries; f32 (\"xla\") vs the f32 truth max |d| = "
            f"{d_f32:.6g} (band {F32_SCORE_BAND:g}); engine vs staged = {d_engine:.3g}")
        if d_pallas > SCORE_BAND or d_f32 > F32_SCORE_BAND or d_engine > 1e-6:
            raise RuntimeError("ImageBERT-A on \"pallas\" or in f32 disagrees with its reference")
        rates["imagebert_a_pallas"].update(max_abs_score_err_vs_plain=d_pallas, identical_rankings=[same_rank, n_q],
                                           layers=self.time_unfused_layer(default.params["bert"]["encoder"], cfg,
                                                                          bf16, "pallas", None, S))
        rates["imagebert_a_f32"].update(max_abs_score_err_vs_f32_truth=d_f32, tf32=tf32,
                                        layers=self.time_unfused_layer(
                                            engines["imagebert_a_f32"].params["bert"]["encoder"], cfg, f32, "xla",
                                            None, S))

        # the serving export: one staged batch through each reloaded artifact, the counters around it
        bt0 = batches[0]
        with torch.inference_mode():
            for w in counted:
                w.launches = 0
            live = default.score_batch(bt0).float().cpu()
            torch.cuda.synchronize()
        live_launches = {w.__name__: w.launches for w in counted}
        art, export = {}, {}
        for backend in ("pallas_packed", "xla"):
            t0 = time.perf_counter()
            out_dir = work / f"export_imagebert_a_{backend}"
            meta = serving.save_scorer(out_dir, serving.export_scorer(spec, params, MAIN_B, bf16, backend, self.dev),
                                       spec, MAIN_B, backend)
            scorer = serving.load_scorer(out_dir)
            seconds = time.perf_counter() - t0
            feats = {key: bt0[key] for key in scorer.feature_keys}
            scorer(feats)  # warm-up
            torch.cuda.synchronize()
            for w in counted:
                w.launches = 0
            art[backend] = torch.from_numpy(scorer(feats))
            torch.cuda.synchronize()
            run = f"imagebert_a_export_{backend}"
            launches[run] = {w.__name__: w.launches for w in counted}
            size = sum(f.stat().st_size for f in out_dir.iterdir())
            export[backend] = {"export_save_load_seconds": seconds, "bytes": size, "custom_ops": meta["custom_ops"]}
            log(f"export {backend}: traced, saved ({size / 1e6:.1f} MB) and reloaded in {seconds:.1f} s; custom ops "
                f"{meta['custom_ops']}; launches on one batch: {json.dumps(launches[run])}")
        kernel_names = [w.__name__ for w in kernels.WRAPPERS]
        same_launches = all(live_launches[k] == launches["imagebert_a_export_pallas_packed"][k] for k in kernel_names)
        bit_equal = bool(torch.equal(art["pallas_packed"], live))
        d_xla = (art["xla"] - plain_all[:MAIN_B]).abs().max().item()
        export["pallas_packed"].update(bit_equal_to_engine=bit_equal, same_kernel_launches=same_launches)
        export["xla"].update(max_abs_score_err_vs_plain=d_xla)
        log(f"export: the \"pallas_packed\" artifact vs the engine's default route on one batch: bit-equal "
            f"{bit_equal}, the same kernel launches {same_launches} (engine: {json.dumps(live_launches)}); the "
            f"\"xla\" artifact vs the plain path max |d| = {d_xla:.6g} (band {SCORE_BAND:g})")
        if not bit_equal or not same_launches or d_xla > SCORE_BAND:
            raise RuntimeError("the exported artifacts do not score as the engine does")
        rates["export"] = export
        return launches, len(batches), rates

    def drive_mha_packed(self) -> dict:
        """``ops/attention.py:mha_packed``, the one entry point that reaches the
        mha_packed kernel (no model path does, as in the JAX package), at
        ImageBERT-A's shape, with the counters around the call; its output held
        against the plain version."""
        from importlib import import_module

        torch = self.torch
        att = import_module(f"{PKG}.ops.attention")
        k = import_module(f"{PKG}.ops.kernels")
        q, kk, v = (self.randn(MAIN_B, S, H, dtype=torch.bfloat16) for _ in range(3))
        counted = launch_counters()
        torch.cuda.synchronize()
        for w in counted:
            w.launches = 0
        out = att.mha_packed(q, kk, v, N)
        torch.cuda.synchronize()
        launches = {w.__name__: w.launches for w in counted}
        log(f"launches mha_packed entry point: {json.dumps(launches)}")
        self.check("ops/attention.py:mha_packed [S=40]", "mha_packed", out, k.mha_packed_plain(q, kk, v, N),
                   CARD_ATOL, CARD_RTOL)
        return launches

    def score_lxmert(self) -> tuple[dict[str, dict], int, dict]:
        """LXMERT at full width through ScoringEngine, on its default route,
        with KMR_DUAL_CROSS=1 and with KMR_FUSED_LAYER=1; the launch counters
        around each run."""
        from importlib import import_module

        import numpy as np

        torch = self.torch
        pkg = import_module(PKG)
        data = import_module(f"{PKG}.data")
        synthetic = import_module(f"{PKG}.data.synthetic")
        models = import_module(f"{PKG}.models")
        lxmert = import_module(f"{PKG}.models.lxmert")
        engine_mod = import_module(f"{PKG}.parallel.engine")
        tok = import_module(f"{PKG}.tokenization")

        work = pkg.BUILD_DIR / "smoke"
        work.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        tsv = work / "pairs_lxmert.tsv"
        tsv.write_text("\n".join(synthetic.make_tsv(N_ROWS, seed=self.seed)) + "\n")
        labels = work / "labels.txt"
        labels.write_text("".join(f"{key}\t{val}\n" for key, val in synthetic.SYNTHETIC_LABELS.items()))
        spec = models.get_model("lxmert")
        cfg = spec.config
        shape = (cfg.bert.hidden_size, cfg.bert.num_attention_heads, cfg.l_layers, cfg.r_layers, cfg.x_layers)
        if shape != (H, N, *LX_DEPTHS):
            raise RuntimeError(f"not the full-width LXMERT config: {cfg} (is KMR_CONFIG_OVERRIDES set?)")
        params = spec.init_params(self.seed)
        engine = engine_mod.ScoringEngine(spec, params, device=self.dev, precision=models.Precision.bf16())
        featurizer = data.Featurizer(tok.FullTokenizer.hf_style(pkg.VOCAB_PATH),
                                     data.load_multimodal_labels(labels))
        log(f"setup: {N_ROWS}-row TSV and LXMERT {LX_DEPTHS}x{H} params in {time.perf_counter() - t0:.1f} s")

        batches = list(data.batches_from_files([tsv], featurizer.lxmert, MAIN_B))
        for flags in LX_ROUTES.values():  # warm-up of every route
            with route(**flags):
                engine.score_batch(batches[0])
        torch.cuda.synchronize()

        launches, results, rates = {}, {}, {}
        counted = launch_counters()
        for run, flags in LX_ROUTES.items():
            with route(**flags):
                for w in counted:
                    w.launches = 0
                stats = engine_mod.ScoringStats()
                results[run] = engine.score_files([tsv], featurizer, MAIN_B, stats=stats)
                torch.cuda.synchronize()
                launches[run] = {w.__name__: w.launches for w in counted}
            log(f"main path {run}: {stats.pairs} pairs in {stats.batches} batches, {stats.seconds:.3f} s, "
                f"{stats.pairs_per_second:.1f} pairs/s end to end (host parse + featurize included)")
            log(f"launches {run}: {json.dumps(launches[run])}")
            if stats.pairs != N_ROWS:
                raise RuntimeError(f"{run} scored {stats.pairs} pairs, expected {N_ROWS}")
            rates[run] = {"pairs": stats.pairs, "seconds": stats.seconds,
                          "pairs_per_second": stats.pairs_per_second}

        staged = [engine.to_device(bt) for bt in batches]

        def run_all(blocks):
            return [lxmert.score(engine.params, bt, cfg, engine.precision, blocks) for bt in staged]

        n_pad = len(batches) * MAIN_B
        scores = {}
        with torch.inference_mode(), packed_route():
            for run, flags in LX_ROUTES.items():
                with route(**flags):
                    dev_ms = cuda_ms(torch, lambda: run_all(models.KERNEL_BLOCKS), iters=3, warmup=1)
                    scores[run] = torch.cat(run_all(models.KERNEL_BLOCKS)).float().cpu()
                rates[run].update(device_ms=dev_ms, device_pairs=n_pad,
                                  device_pairs_per_second=n_pad / dev_ms * 1e3)
                log(f"device {run}: model alone {dev_ms:.3f} ms for {n_pad} padded pairs = "
                    f"{n_pad / dev_ms * 1e3:.1f} pairs/s")
            plain_dev_ms = cuda_ms(torch, lambda: run_all(models.PLAIN_BLOCKS), iters=1, warmup=1)
            plain = torch.cat(run_all(models.PLAIN_BLOCKS)).float().cpu()
            # the f32 truth on the card: plain blocks, f32 weights and activations
            params32 = import_module(f"{PKG}.checkpoint").tree_to(params, self.dev)
            ref32 = torch.cat([lxmert.score(params32, bt, cfg, models.Precision.f32(), models.PLAIN_BLOCKS)
                               for bt in staged]).float().cpu()
            del params32
        valid = torch.from_numpy(np.concatenate([bt["valid"] for bt in batches]))
        kern, dual, fused, plain, ref32 = (scores["lxmert"][valid], scores["lxmert_dual_cross"][valid],
                                           scores["lxmert_fused_layer"][valid], plain[valid], ref32[valid])
        spread = {}
        for label, a, b_ in (("kernel-plain", kern, plain), ("kernel-f32", kern, ref32), ("plain-f32", plain, ref32),
                             ("fused-default", fused, kern), ("fused-f32", fused, ref32)):
            d = (a - b_).abs()
            spread[label] = {"max": d.max().item(), "mean": d.mean().item(),
                             "p99": d.quantile(0.99).item(), "p50": d.quantile(0.5).item()}
        log(f"scores lxmert |d| spread (f32 = plain blocks in f32 on the card): {json.dumps(spread)}")
        if not all(bool(torch.isfinite(t).all()) and t.shape == (N_ROWS,) for t in (kern, dual, fused)):
            raise RuntimeError("LXMERT kernel-path scores are not finite or of the wrong shape")
        d_score, d_route = spread["kernel-plain"]["max"], (dual - kern).abs().max().item()
        d_fused = spread["fused-default"]["max"]
        d_truth = max(spread["kernel-f32"]["max"], spread["plain-f32"]["max"])
        d_engine = max(
            (torch.tensor([results[run][str(q)][str(p)] for bt in batches
                           for q, p, ok in zip(bt["query_id"], bt["product_id"], bt["valid"]) if ok]) - s).abs().max().item()
            for run, s in (("lxmert", kern), ("lxmert_dual_cross", dual), ("lxmert_fused_layer", fused))
        )
        same_rank, n_q = self.ranking_agreement(batches, kern, plain)
        log(f"scores lxmert: range [{kern.min().item():.5f}, {kern.max().item():.5f}], max |d| of each bf16 "
            f"path vs the f32 truth on the card = {d_truth:.6g} (band {SCORE_BAND:g}), kernel vs plain = "
            f"{d_score:.6g} (band {LX_PAIR_BAND:g}; plain path {plain_dev_ms:.3f} ms), dual-cross route vs "
            f"default = {d_route:.6g} (band {SCORE_BAND:g}), fused-layer route vs default = {d_fused:.6g} (band "
            f"{SCORE_BAND:g}; bit-equal: {bool(torch.equal(fused, kern))}), engine vs staged = {d_engine:.3g}, identical per-query ranking in {same_rank}/{n_q} "
            f"queries")
        if (d_truth > SCORE_BAND or d_score > LX_PAIR_BAND or d_route > SCORE_BAND or d_fused > SCORE_BAND
                or d_engine > 1e-6):
            raise RuntimeError("LXMERT scores disagree with the f32 truth, the plain path or across routes")

        small = {key: val[:8].cpu() for key, val in staged[0].items()}
        with torch.inference_mode(), packed_route():
            ref = lxmert.score(params, small, cfg, models.Precision.f32())
        d_cpu = (kern[:8] - ref).abs().max().item()
        log(f"scores lxmert: max |d| bf16 kernels vs f32 plain on the CPU, 8 pairs = {d_cpu:.6g} "
            f"(band {CPU_SCORE_BAND:g})")
        if not d_cpu <= CPU_SCORE_BAND:
            raise RuntimeError("LXMERT kernel-path scores disagree with the f32 CPU reference")
        rates["lxmert"].update(plain_device_ms=plain_dev_ms, max_abs_score_err=d_score, score_spread=spread,
                               max_abs_score_err_dual_vs_default=d_route,
                               max_abs_score_err_fused_vs_default=d_fused, max_abs_score_err_vs_cpu_f32=d_cpu,
                               identical_rankings=[same_rank, n_q])
        return launches, len(batches), rates

    def score_imagebert_b(self) -> tuple[dict[str, dict], int, dict]:
        """ImageBERT-B at full width through ScoringEngine on its default route
        and with KMR_FUSED_LAYER=1, then ImageBERT-C (the sen2forest rewrite) on
        the same weights; the launch counters around each run. Scores: each
        bf16 path (kernels, plain) against the f32 truth on the card, the two
        routes against each other, C against B (bit for bit off the trigger
        rows), a few pairs against the f32 plain path on the CPU."""
        from importlib import import_module

        import numpy as np

        torch = self.torch
        pkg = import_module(PKG)
        data = import_module(f"{PKG}.data")
        tsv_mod = import_module(f"{PKG}.data.tsv")
        synthetic = import_module(f"{PKG}.data.synthetic")
        models = import_module(f"{PKG}.models")
        heads = import_module(f"{PKG}.models.heads")
        imagebert_b = import_module(f"{PKG}.models.imagebert_b")
        engine_mod = import_module(f"{PKG}.parallel.engine")
        tok = import_module(f"{PKG}.tokenization")
        att = import_module(f"{PKG}.ops.attention")

        work = pkg.BUILD_DIR / "smoke"
        work.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        lines = synthetic.make_tsv(N_ROWS, seed=self.seed)
        tsv = work / "pairs_imagebert_b.tsv"
        tsv.write_text("\n".join(lines) + "\n")
        labels = work / "labels.txt"
        labels.write_text("".join(f"{key}\t{val}\n" for key, val in synthetic.SYNTHETIC_LABELS.items()))
        trigger = torch.tensor([tsv_mod.SEN2FOREST_SRC in tsv_mod.parse_line(line).query
                                for line in lines if not tsv_mod.is_header(line)])
        spec_b, spec_c = models.get_model("imagebert_b"), models.get_model("imagebert_c")
        cfg = spec_b.config
        if (cfg.hidden_size, cfg.num_hidden_layers, cfg.num_attention_heads) != (H, 12, N):
            raise RuntimeError(f"not the full-width config: {cfg} (is KMR_CONFIG_OVERRIDES set?)")
        params = spec_b.init_params(self.seed)
        bf16 = models.Precision.bf16()
        engines = {"imagebert_b": engine_mod.ScoringEngine(spec_b, params, device=self.dev, precision=bf16),
                   "imagebert_c": engine_mod.ScoringEngine(spec_c, params, device=self.dev, precision=bf16)}
        for name, spec in (("imagebert_b", spec_b), ("imagebert_c", spec_c)):  # the "pallas" backend
            engines[f"{name}_pallas"] = engine_mod.ScoringEngine(spec, params, device=self.dev, precision=bf16,
                                                                 attention_backend="pallas")
        # run name, model, KMR_FUSED_LAYER; a run ending in _pallas takes its own engine
        runs = (("imagebert_b", "imagebert_b", False), ("imagebert_b_fused_layer", "imagebert_b", True),
                ("imagebert_c", "imagebert_c", False), ("imagebert_b_pallas", "imagebert_b", False),
                ("imagebert_c_pallas", "imagebert_c", False))
        engine_of = {run: engines[run if run.endswith("_pallas") else model] for run, model, _ in runs}
        google = tok.FullTokenizer.google_style(pkg.VOCAB_PATH)
        label_texts = data.load_multimodal_labels(labels)
        featurizers = {"imagebert_b": data.Featurizer(google, label_texts),
                       "imagebert_c": data.Featurizer(google, label_texts, sen2forest=True)}
        log(f"setup: {N_ROWS}-row TSV ({int(trigger.sum())} with the sen2forest trigger) and ImageBERT-B "
            f"{cfg.num_hidden_layers}x{cfg.hidden_size} params in {time.perf_counter() - t0:.1f} s")

        batches = {name: list(data.batches_from_files([tsv], fz.imagebert_b, MAIN_B)) for name, fz in featurizers.items()}
        engine = engines["imagebert_b"]
        for fused in (False, True):  # warm-up of both routes
            with route(KMR_FUSED_LAYER=fused):
                engine.score_batch(batches["imagebert_b"][0])
        engines["imagebert_b_pallas"].score_batch(batches["imagebert_b"][0])
        torch.cuda.synchronize()

        launches, results, rates = {}, {}, {}
        counted = launch_counters()
        for run, model, fused in runs:
            with route(KMR_FUSED_LAYER=fused):
                for w in counted:
                    w.launches = 0
                stats = engine_mod.ScoringStats()
                results[run] = engine_of[run].score_files([tsv], featurizers[model], MAIN_B, stats=stats)
                torch.cuda.synchronize()
                launches[run] = {w.__name__: w.launches for w in counted}
            log(f"main path {run}: {stats.pairs} pairs in {stats.batches} batches, {stats.seconds:.3f} s, "
                f"{stats.pairs_per_second:.1f} pairs/s end to end (host parse + featurize included)")
            log(f"launches {run}: {json.dumps(launches[run])}")
            if stats.pairs != N_ROWS:
                raise RuntimeError(f"{run} scored {stats.pairs} pairs, expected {N_ROWS}")
            rates[run] = {"pairs": stats.pairs, "seconds": stats.seconds, "pairs_per_second": stats.pairs_per_second}

        staged = {name: [engine.to_device(bt) for bt in bts] for name, bts in batches.items()}
        n_pad = len(batches["imagebert_b"]) * MAIN_B

        def run_all(model, blocks, p=engine.params, prec=bf16, out="score"):
            return torch.cat([imagebert_b.apply(p, bt, cfg, prec, blocks)[out] for bt in staged[model]]).float()

        scores = {}
        with torch.inference_mode(), packed_route():
            for run, model, fused in runs:
                with route(KMR_FUSED_LAYER=fused), att.attention_backend(engine_of[run].attention_backend):
                    dev_ms = cuda_ms(torch, lambda: run_all(model, models.KERNEL_BLOCKS), iters=3, warmup=1)
                    scores[run] = run_all(model, models.KERNEL_BLOCKS).cpu()
                rates[run].update(device_ms=dev_ms, device_pairs=n_pad, device_pairs_per_second=n_pad / dev_ms * 1e3)
                log(f"device {run}: model alone {dev_ms:.3f} ms for {n_pad} padded pairs = "
                    f"{n_pad / dev_ms * 1e3:.1f} pairs/s")
            plain_dev_ms = cuda_ms(torch, lambda: run_all("imagebert_b", models.PLAIN_BLOCKS), iters=1, warmup=1)
            plain = run_all("imagebert_b", models.PLAIN_BLOCKS).cpu()
            # the f32 truth on the card: plain blocks and plain label-conv product, f32 weights and activations
            params32 = import_module(f"{PKG}.checkpoint").tree_to(params, self.dev)
            f32 = models.Precision.f32()
            ref32 = run_all("imagebert_b", models.PLAIN_BLOCKS, params32, f32).cpu()
            pooled32 = run_all("imagebert_b", models.PLAIN_BLOCKS, params32, f32, "pooled")
            cos32 = heads.am_cosines(params32["cls"]["seq_relationship"], pooled32)[:, 1].cpu()  # the fed label's class
            del params32, pooled32
        valid = torch.from_numpy(np.concatenate([bt["valid"] for bt in batches["imagebert_b"]]))
        kern, fused, c_scores, plain, ref32, cos32 = (t[valid] for t in (
            scores["imagebert_b"], scores["imagebert_b_fused_layer"], scores["imagebert_c"], plain, ref32, cos32))
        pallas, c_pallas = scores["imagebert_b_pallas"][valid], scores["imagebert_c_pallas"][valid]
        for name, t in (("kernel", kern), ("fused", fused), ("imagebert_c", c_scores), ("pallas", pallas),
                        ("imagebert_c pallas", c_pallas)):
            if not bool(torch.isfinite(t).all()) or t.shape != (N_ROWS,):
                raise RuntimeError(f"ImageBERT-B {name} scores are not finite or of the wrong shape")
        # pairs whose f32 cos for the fed class is within 1e-3 of the margin can flip the margin on a
        # rounding: left out of the bands and counted
        near = (cos32 - heads.AM_MARGIN).abs() < 1e-3
        keep = ~near
        spread = {}
        for label, a, b_ in (("kernel-plain", kern, plain), ("kernel-f32", kern, ref32), ("plain-f32", plain, ref32),
                             ("fused-default", fused, kern), ("fused-f32", fused, ref32), ("pallas-f32", pallas, ref32),
                             ("pallas-plain", pallas, plain)):
            d = (a - b_)[keep].abs()
            spread[label] = {"max": d.max().item(), "mean": d.mean().item(), "p99": d.quantile(0.99).item()}
        log(f"scores imagebert_b |d| spread (f32 = plain blocks in f32 on the card): {json.dumps(spread)}")
        kern_truth, plain_truth = spread["kernel-f32"]["max"], spread["plain-f32"]["max"]
        kern_band = max(SCORE_BAND, B_KERNEL_OVER_PLAIN * plain_truth)
        p99_truth = max(spread["kernel-f32"]["p99"], spread["plain-f32"]["p99"])
        d_pair, d_route = spread["kernel-plain"]["max"], spread["fused-default"]["max"]
        off = ~trigger
        c_equal = bool(torch.equal(c_scores[off], kern[off]))
        c_moved = int((c_scores[trigger] != kern[trigger]).sum())
        pallas_truth, pallas_p99 = spread["pallas-f32"]["max"], spread["pallas-f32"]["p99"]
        c_pallas_equal = bool(torch.equal(c_pallas[off], pallas[off]))
        c_pallas_moved = int((c_pallas[trigger] != pallas[trigger]).sum())
        d_engine = max(
            (torch.tensor([results[run][str(q)][str(p)] for bt in batches["imagebert_b"]
                           for q, p, ok in zip(bt["query_id"], bt["product_id"], bt["valid"]) if ok]) - t).abs().max().item()
            for run, t in (("imagebert_b", kern), ("imagebert_b_fused_layer", fused), ("imagebert_c", c_scores),
                           ("imagebert_b_pallas", pallas), ("imagebert_c_pallas", c_pallas))
        )
        same_rank, n_q = self.ranking_agreement(batches["imagebert_b"], kern, plain)
        log(f"scores imagebert_b: range [{kern.min().item():.5f}, {kern.max().item():.5f}], f32 cos of the fed class "
            f"in [{cos32.min().item():.4f}, {cos32.max().item():.4f}], {int(near.sum())} pairs within 1e-3 of the "
            f"{heads.AM_MARGIN} margin left out; |d| vs the f32 truth: p99 of each bf16 path {p99_truth:.6g} "
            f"(band {SCORE_BAND:g}), max plain {plain_truth:.6g} (band {SCORE_BAND:g}), max kernels {kern_truth:.6g} "
            f"(band {kern_band:.6g}); kernel vs plain = {d_pair:.6g} "
            f"(band {2 * SCORE_BAND:g}; plain path "
            f"{plain_dev_ms:.3f} ms), fused route vs default = {d_route:.6g} (band {SCORE_BAND:g}; bit-equal: "
            f"{bool(torch.equal(fused, kern))}), engine vs "
            f"staged = {d_engine:.3g}, identical per-query ranking in {same_rank}/{n_q} queries")
        log(f"scores imagebert_c: equal to imagebert_b bit for bit on all {int(off.sum())} rows without the trigger: "
            f"{c_equal}; {c_moved} of {int(trigger.sum())} trigger rows differ")
        log(f"scores imagebert_b on \"pallas\": |d| vs the f32 truth p99 {pallas_p99:.6g} (band {SCORE_BAND:g}), max "
            f"{pallas_truth:.6g} (band {kern_band:.6g}); vs the plain path max {spread['pallas-plain']['max']:.6g}; "
            f"imagebert_c on \"pallas\" equal to imagebert_b on \"pallas\" bit for bit off the trigger rows: "
            f"{c_pallas_equal}; {c_pallas_moved} trigger rows differ")
        if (p99_truth > SCORE_BAND or plain_truth > SCORE_BAND or kern_truth > kern_band
                or d_pair > 2 * SCORE_BAND or d_route > SCORE_BAND or d_engine > 1e-6):
            raise RuntimeError("ImageBERT-B scores disagree with the f32 truth, the plain path or across routes")
        if not c_equal or c_moved == 0:
            raise RuntimeError("ImageBERT-C is not ImageBERT-B plus the sen2forest rewrite")
        if pallas_p99 > SCORE_BAND or pallas_truth > kern_band:
            raise RuntimeError("ImageBERT-B on the \"pallas\" backend disagrees with the f32 truth")
        if not c_pallas_equal or c_pallas_moved == 0:
            raise RuntimeError("ImageBERT-C on \"pallas\" is not ImageBERT-B on \"pallas\" plus the sen2forest rewrite")

        small = {key: val[:8].cpu() for key, val in staged["imagebert_b"][0].items()}
        with torch.inference_mode(), packed_route():
            ref = imagebert_b.score(params, small, cfg, models.Precision.f32())
        d_cpu = (kern[:8] - ref).abs().max().item()
        log(f"scores imagebert_b: max |d| bf16 kernels vs f32 plain on the CPU, 8 pairs = {d_cpu:.6g} "
            f"(band {CPU_SCORE_BAND:g})")
        if not d_cpu <= CPU_SCORE_BAND:
            raise RuntimeError("ImageBERT-B kernel-path scores disagree with the f32 CPU reference")
        rates["imagebert_b"].update(plain_device_ms=plain_dev_ms, score_spread=spread, near_margin_pairs=int(near.sum()),
                                    max_abs_score_err_vs_cpu_f32=d_cpu, identical_rankings=[same_rank, n_q])
        rates["imagebert_c"].update(equal_off_trigger=c_equal, trigger_rows=int(trigger.sum()),
                                    trigger_rows_moved=c_moved)
        rates["imagebert_c_pallas"].update(equal_off_trigger=c_pallas_equal, trigger_rows_moved=c_pallas_moved)
        rates["imagebert_b_pallas"]["layers"] = self.time_unfused_layer(
            engine.params["bert"]["encoder"], cfg, bf16, "pallas", self.key_bias(MAIN_B, B_S), B_S)
        return launches, len(batches["imagebert_b"]), rates

    # ---- phase 5: training ------------------------------------------------------

    def train_weights(self, kind: str) -> list:
        """f32 master weights of one train block at full width, as the trainer holds them."""
        torch = self.torch
        shapes = [(H, I), (I,), (I, H), (H,)] if kind == "ffn" else [(H, 3 * H), (3 * H,), (H, H), (H,)]
        ws = [self.randn(*sh, scale=0.02) for sh in shapes]
        return ws + [1.0 + self.randn(H, scale=0.1), self.randn(H, scale=0.1)]

    def check_rel(self, name: str, key: str, got, want, band: float) -> list[float]:
        """Each of got's tensors against want's in relative L2 (the errors, logged);
        a failure unless all are finite and within ``band``."""
        torch = self.torch
        torch.cuda.synchronize()
        errs = [((g.float() - w.float()).norm() / w.float().norm().clamp_min(1e-30)).item() for g, w in zip(got, want)]
        abs_err = max((g.float() - w.float()).abs().max().item() for g, w in zip(got, want))
        ok = all(bool(torch.isfinite(g).all()) for g in got) and max(errs) <= band
        self.errors[key] = max(self.errors.get(key, 0.0), abs_err)
        log(f"check {name}: relative L2 per tensor {[f'{e:.3g}' for e in errs]} (band {band:g}), "
            f"max_abs_err={abs_err:.6g} {'ok' if ok else 'FAIL'}")
        if not ok:
            self.failures.append(name)
        return errs

    def train_kernel_case(self, b: int, identity_v: bool = False):
        """The train kernels' inputs at batch b: x, a key mask's bias, qkv (with V = I in every head when
        identity_v: ctx then holds the dropped probabilities), dctx, dy, and an f32 projection h."""
        from importlib import import_module

        torch = self.torch
        att = import_module(f"{PKG}.ops.attention")
        m = b * S
        qkv = self.randn(m, 3 * H)
        if identity_v:
            v = torch.zeros(b, S, N, 64, device=self.dev)
            v[:, torch.arange(S), :, torch.arange(S)] = 1.0
            qkv[:, 2 * H:] = v.reshape(m, H)
        mask = (torch.rand(b, S, generator=self.gen) > 0.3).float()
        mask[:, 0] = 1.0
        return {"x": self.randn(m, H, dtype=torch.bfloat16), "bias": att.mask_to_bias(mask).to(self.dev),
                "qkv": qkv.to(torch.bfloat16), "dctx": self.randn(m, H, dtype=torch.bfloat16),
                "dy": self.randn(m, H, dtype=torch.bfloat16), "h": self.randn(m, H)}

    def check_train_kernels(self) -> None:
        """The train kernels against their plain versions at TRAIN_CHECK_B and TRAIN_B, dropout 0 and
        TRAIN_RATE, with and without a key mask; at rate 0.5 the dropped units equal the hash mask's."""
        from importlib import import_module

        k = import_module(f"{PKG}.ops.kernels")
        dropout = import_module(f"{PKG}.ops.dropout")
        torch = self.torch
        fw, aw = self.train_weights("ffn"), self.train_weights("attn")
        w1, w2, wqkv, wo = (w.to(torch.bfloat16) for w in (fw[0], fw[2], aw[0], aw[2]))
        for b in (TRAIN_CHECK_B, TRAIN_B):
            c = self.train_kernel_case(b)
            m, rows = b * S, 4 * S
            x = c["x"]
            g, u = k.gemm(x, w1, fw[1], "gelu_tanh_save")
            gp, up = k.gemm_plain(x, w1, fw[1], "gelu_tanh_save")
            self.check(f"gemm ffn-up [gelu_tanh_save, bf16 out, B={b}]", "gemm_bf16", g, gp, CARD_ATOL, CARD_RTOL)
            self.check(f"gemm ffn-up [gelu_tanh_save, f32 u, B={b}]", "gemm_bf16", u, up, F32_OUT_BAND)
            self.check(f"gemm ffn-down [f32, B={b}]", "gemm_bf16", k.gemm(gp, w2, fw[3], "f32"),
                       k.gemm_plain(gp, w2, fw[3], "f32"), F32_OUT_BAND)
            dh = c["dy"]
            self.check(f"gemm dh@W2^T [gelu_bwd_tanh, B={b}]", "gemm_bf16",
                       k.gemm(dh, w2, None, "gelu_bwd_tanh", aux=up, trans_b=True),
                       k.gemm_plain(dh, w2, None, "gelu_bwd_tanh", aux=up, trans_b=True), CARD_ATOL, CARD_RTOL)
            self.check(f"gemm du@W1^T [residual_f32, B={b}]", "gemm_bf16",
                       k.gemm(gp, w1, None, "residual_f32", aux=c["h"], trans_b=True),
                       k.gemm_plain(gp, w1, None, "residual_f32", aux=c["h"], trans_b=True), CARD_ATOL, CARD_RTOL)
            self.check(f"gemm do@Wo^T [bias, no bias, B={b}]", "gemm_bf16", k.gemm(dh, wo, None, "bias", trans_b=True),
                       k.gemm_plain(dh, wo, None, "bias", trans_b=True), CARD_ATOL, CARD_RTOL)
            self.check(f"gemm dqkv@Wqkv^T [residual_f32, B={b}]", "gemm_bf16",
                       k.gemm(c["qkv"], wqkv, None, "residual_f32", aux=c["h"], trans_b=True),
                       k.gemm_plain(c["qkv"], wqkv, None, "residual_f32", aux=c["h"], trans_b=True),
                       CARD_ATOL, CARD_RTOL)
            gamma, beta = aw[4], aw[5]
            for rate in (0.0, TRAIN_RATE, 0.5):
                args = (77, rate, rows)
                self.check(f"ln_train [rate {rate}, B={b}]", "ln_train", k.ln_train(c["h"], x, gamma, beta, *args),
                           k.ln_train_plain(c["h"], x, gamma, beta, *args), CARD_ATOL, CARD_RTOL)
                got = k.ln_train_bwd(c["h"], x, c["dy"], gamma, *args)
                want = k.ln_train_bwd_plain(c["h"], x, c["dy"], gamma, *args)
                self.check(f"ln_train_bwd dz [rate {rate}, B={b}]", "ln_train_bwd", got[0], want[0], 1e-4, 1e-4)
                self.check(f"ln_train_bwd dh [rate {rate}, B={b}]", "ln_train_bwd", got[1], want[1], CARD_ATOL,
                           CARD_RTOL)
                self.check(f"ln_train_bwd partials [rate {rate}, B={b}]", "ln_train_bwd", got[2:], want[2:],
                           F32_OUT_BAND, 1e-4)
                if rate == 0.5:
                    keep = dropout.hidden_keep(77, rate, m, H, rows, self.dev)
                    same = bool(torch.equal(got[1] == 0, ~keep)) and bool(torch.equal(want[1] == 0, ~keep))
                    log(f"check ln_train_bwd masks [rate 0.5, B={b}]: dropped units equal to the hash mask's "
                        f"in kernel and plain version: {same}")
                    if not same:
                        self.failures.append(f"ln_train masks B={b}")
                for label, bias in (("no mask", None), ("key mask", c["bias"])):
                    a = (b, S, N, 55, rate, dropout.pick_block(b, 8))
                    self.check(f"attn_train [rate {rate}, {label}, B={b}]", "attn_train",
                               k.attn_train(c["qkv"], bias, *a), k.attn_train_plain(c["qkv"], bias, *a),
                               CARD_ATOL, CARD_RTOL)
                    self.check(f"attn_train_bwd [rate {rate}, {label}, B={b}]", "attn_train_bwd",
                               k.attn_train_bwd(c["qkv"], c["dctx"], bias, *a),
                               k.attn_train_bwd_plain(c["qkv"], c["dctx"], bias, *a), CARD_ATOL, CARD_RTOL)
            ci = self.train_kernel_case(b, identity_v=True)
            blk = dropout.pick_block(b, 8)
            keep = dropout.cross_probs_keep(123, 0.5, b, N, S, S, blk, self.dev)
            same = True
            for fn in (k.attn_train, k.attn_train_plain):
                probs = fn(ci["qkv"], None, b, S, N, 123, 0.5, blk).reshape(b, S, N, 64)[..., :S].permute(0, 2, 1, 3)
                same = same and bool(torch.equal(probs == 0, ~keep))
            ones = torch.zeros(b * S, H, device=self.dev)  # dctx = I per head: dV holds the dropped probabilities
            ones.view(b, S, N, 64)[:, torch.arange(S), :, torch.arange(S)] = 1.0
            for fn in (k.attn_train_bwd, k.attn_train_bwd_plain):
                dv = fn(ci["qkv"], ones.to(torch.bfloat16), None, b, S, N, 123, 0.5, blk)[:, 2 * H:]
                dv = dv.reshape(b, S, N, 64)[..., :S].permute(0, 2, 3, 1)  # [b, n, query, key]
                same = same and bool(torch.equal(dv == 0, ~keep))
            log(f"check attn_train masks [rate 0.5, B={b}]: dropped probabilities equal to the hash mask's in "
                f"the forward and backward kernels and their plain versions: {same}")
            if not same:
                self.failures.append(f"attn_train masks B={b}")

    def train_block_fns(self, kind: str, x, ws, bias, dy):
        """(forward of the kernel block, its backward, the plain oracle's forward, the oracle's autograd
        backward, the library forward, its autograd backward) at TRAIN_RATE and x's sequence length, each a
        no-argument callable."""
        from importlib import import_module

        torch = self.torch
        F = torch.nn.functional
        tb = import_module(f"{PKG}.ops.train_blocks")
        dropout = import_module(f"{PKG}.ops.dropout")
        b, s = x.shape[:2]
        if kind == "ffn":
            block = dropout.pick_block(b, dropout.train_block("ffn"))
            kernel = lambda x, *w: tb.ffn_block_train(x, *w, 42, dropout_rate=TRAIN_RATE)  # noqa: E731
            plain = lambda x, *w: tb.ffn_block_train_plain(x, *w, 42, dropout_rate=TRAIN_RATE)  # noqa: E731
            backward = lambda: tb.ffn_block_train_backward(dy, x, *ws[:5], 42, TRAIN_RATE, True, 1e-12, block)  # noqa: E731

            def library(x, w1, b1, w2, b2, g, be):  # bf16 matmuls, GELU, F.dropout, F.layer_norm
                hmid = F.gelu(torch.matmul(x, w1.to(torch.bfloat16)) + b1.to(torch.bfloat16), approximate="tanh")
                hid = F.dropout(torch.matmul(hmid, w2.to(torch.bfloat16)) + b2.to(torch.bfloat16), TRAIN_RATE)
                return F.layer_norm((hid + x).float(), (H,), g, be, 1e-12).to(torch.bfloat16)
        else:
            block = dropout.pick_block(b, dropout.train_block("attn"))
            kernel = lambda x, *w: tb.attention_block_train(  # noqa: E731
                x, *w, N, 42, bias=bias, attn_dropout_rate=TRAIN_RATE, hidden_dropout_rate=TRAIN_RATE)
            plain = lambda x, *w: tb.attention_block_train_plain(  # noqa: E731
                x, *w, N, 42, bias=bias, attn_dropout_rate=TRAIN_RATE, hidden_dropout_rate=TRAIN_RATE)
            kb = None if bias is None else bias.reshape(b, s).float().contiguous()
            backward = lambda: tb.attention_block_train_backward(  # noqa: E731
                dy, x, *ws[:5], kb, N, 42, TRAIN_RATE, TRAIN_RATE, 1e-12, block)

            def library(x, wqkv, bqkv, wo, bo, g, be):  # bf16 matmuls, SDPA with dropout, F.layer_norm
                qkv = torch.matmul(x, wqkv.to(torch.bfloat16)) + bqkv.to(torch.bfloat16)
                q, k_, v = (t.reshape(b, s, N, 64).transpose(1, 2) for t in qkv.split(H, dim=-1))
                mask = None if bias is None else bias.to(torch.bfloat16).reshape(b, 1, 1, s)
                ctx = F.scaled_dot_product_attention(q, k_, v, attn_mask=mask, dropout_p=TRAIN_RATE)
                o = F.dropout(torch.matmul(ctx.transpose(1, 2).reshape(b, s, H), wo.to(torch.bfloat16))
                              + bo.to(torch.bfloat16), TRAIN_RATE)
                return F.layer_norm((o + x).float(), (H,), g, be, 1e-12).to(torch.bfloat16)

        def grads_of(fn):
            leaves = [x.detach().clone().requires_grad_(), *(w.detach().clone().requires_grad_() for w in ws)]
            y = fn(*leaves)
            return lambda: torch.autograd.grad(y, leaves, dy, retain_graph=True)

        fwd = (lambda: kernel(x, *ws), lambda: plain(x, *ws), lambda: library(x, *ws))
        return fwd, (backward, grads_of(plain), grads_of(library))

    def time_train_kernels(self) -> dict[str, dict]:
        """At TRAIN_B: the train blocks held against their plain oracles (forward in the ulp band, the
        backward's 7 gradients in relative L2), at ImageBERT-A's S=40 and at ImageBERT-B's S=30 with its key
        masks; then every train kernel and block timed beside its bound, plain version and library yardstick,
        and ImageBERT-B's label conv as its training Function (``band_conv_rows``)."""
        from importlib import import_module

        k = import_module(f"{PKG}.ops.kernels")
        att = import_module(f"{PKG}.ops.attention")
        torch = self.torch
        b = TRAIN_B
        rows = {}
        mask = torch.ones(b, S)
        mask[1::3, 25:] = 0.0  # a key mask on every third pair, for the block check (ImageBERT-A passes none)
        for s, checks, timed_bias in ((S, (("no mask", None), ("key mask", att.mask_to_bias(mask).to(self.dev))),
                                       None),
                                      (B_S, None, self.key_bias(b, B_S))):
            checks = checks or (("ImageBERT-B key mask", timed_bias),)
            m, suffix = b * s, "" if s == S else f" S={s}"
            x = self.randn(b, s, H, dtype=torch.bfloat16)
            dy = self.randn(b, s, H, dtype=torch.bfloat16)
            for kind in ("ffn", "attn"):
                ws = self.train_weights(kind)
                name = "ffn_block_train" if kind == "ffn" else "attention_block_train"
                for label, bb in checks if kind == "attn" else (("", None),):
                    (kf, pf, _), (kb_, pb, _) = self.train_block_fns(kind, x, ws, bb, dy)
                    tag = f"[S={s}, rate {TRAIN_RATE}{', ' + label if label else ''}, B={b}]"
                    self.check(f"{name} y vs plain oracle {tag}", name, kf(), pf(), CARD_ATOL, CARD_RTOL)
                    got, want = kb_(), pb()
                    if got[0].dtype != torch.bfloat16 or any(g.dtype != torch.float32 for g in got[1:]):
                        self.failures.append(f"{name} gradient dtypes")
                    self.check_rel(f"{name}_backward dx, dW_in, db_in, dW_out, db_out, dgamma, dbeta vs the "
                                   f"oracle's autograd {tag}", f"{name}_backward", got, want, TRAIN_GRAD_REL_L2)
                bb = timed_bias if kind == "attn" else None
                (kf, pf, lf), (kb_, pb, lb) = self.train_block_fns(kind, x, ws, bb, dy)
                wbytes = nbytes_of(ws) + (0 if bb is None else nbytes_of((bb,)))
                if kind == "ffn":
                    fwd_flops, bwd_flops = 4.0 * m * H * I, 12.0 * m * H * I
                else:
                    core = 4.0 * b * N * s * s * 64
                    fwd_flops = 2.0 * m * H * 3 * H + core + 2.0 * m * H * H
                    bwd_flops = fwd_flops + 2.0 * m * H * H + 10.0 * b * N * s * s * 64 + 2.0 * m * 3 * H * H \
                        + 2.0 * m * H * 3 * H + 2.0 * m * H * H
                self.time_row(rows, name + suffix, name, kf, pf, lf, 4 * m * H + wbytes, fwd_flops, PEAK_BF16_FLOPS,
                              check=False)
                self.time_row(rows, f"{name}_backward{suffix}", f"{name}_backward", kb_, pb, lb,
                              6 * m * H + 2 * wbytes, bwd_flops, PEAK_BF16_FLOPS, check=False)
        rows.update(self.band_conv_rows())

        # the kernels inside the blocks, at the blocks' shapes (rate TRAIN_RATE, no mask)
        F = torch.nn.functional
        m = b * S
        c = self.train_kernel_case(b)
        fw, aw = self.train_weights("ffn"), self.train_weights("attn")
        w1, w2, wqkv, wo = (w.to(torch.bfloat16) for w in (fw[0], fw[2], aw[0], aw[2]))
        gamma, beta, rows_pb = aw[4], aw[5], 4 * S
        x2d, h32, dy2d = c["x"], c["h"], c["dy"]
        z = h32 + x2d.float()
        zl = z.clone().requires_grad_()
        yl = F.layer_norm(zl, (H,), gamma, beta, 1e-12)
        self.time_row(rows, "ln_train", "ln_train", lambda: k.ln_train(h32, x2d, gamma, beta, 77, TRAIN_RATE, rows_pb),
                      lambda: k.ln_train_plain(h32, x2d, gamma, beta, 77, TRAIN_RATE, rows_pb),
                      lambda: F.layer_norm(z, (H,), gamma, beta, 1e-12), m * H * 8 + 2 * H * 4, 12.0 * m * H,
                      PEAK_F32_FLOPS, check=False, device=True)
        parts = -(-m // k.LN_TRAIN_BWD_ROWS)
        self.time_row(rows, "ln_train_bwd", "ln_train_bwd",
                      lambda: k.ln_train_bwd(h32, x2d, dy2d, gamma, 77, TRAIN_RATE, rows_pb),
                      lambda: k.ln_train_bwd_plain(h32, x2d, dy2d, gamma, 77, TRAIN_RATE, rows_pb),
                      lambda: torch.autograd.grad(yl, (zl,), dy2d.float(), retain_graph=True),
                      m * H * 14 + H * 4 + 2 * parts * H * 4, 20.0 * m * H, PEAK_F32_FLOPS, check=False, device=True)
        # attn_train at ImageBERT-A's S=40 (no mask), ImageBERT-B's S=30 and LXMERT's S=23 and S=10 (their key
        # masks; B's with every fourth pair's box keys all masked)
        for s in (S, B_S, LX_F, LX_T):
            name = "" if s == S else f" S={s}"
            if s == S:
                qkv_s, dctx_s, bias_s = c["qkv"], c["dctx"], None
            else:
                qkv_s = self.randn(b * s, 3 * H, dtype=torch.bfloat16)
                dctx_s = self.randn(b * s, H, dtype=torch.bfloat16)
                bias_s = self.key_bias(b, s)
            a = (b, s, N, 55, TRAIN_RATE, 8)
            fwd = (lambda qkv=qkv_s, bias=bias_s, a=a: k.attn_train(qkv, bias, *a),
                   lambda qkv=qkv_s, bias=bias_s, a=a: k.attn_train_plain(qkv, bias, *a))
            bwd = (lambda qkv=qkv_s, d=dctx_s, bias=bias_s, a=a: k.attn_train_bwd(qkv, d, bias, *a),
                   lambda qkv=qkv_s, d=dctx_s, bias=bias_s, a=a: k.attn_train_bwd_plain(qkv, d, bias, *a))
            if s != S:  # S=40 is held in check_train_kernels
                for rate in (0.0, TRAIN_RATE) if s == B_S else (TRAIN_RATE,):
                    ar = (b, s, N, 55, rate, 8)
                    tag = f"[S={s}, {'ImageBERT-B' if s == B_S else 'LXMERT'} key mask, rate {rate}, B={b}]"
                    self.check(f"attn_train {tag}", "attn_train", k.attn_train(qkv_s, bias_s, *ar),
                               k.attn_train_plain(qkv_s, bias_s, *ar), CARD_ATOL, CARD_RTOL)
                    self.check(f"attn_train_bwd {tag}", "attn_train_bwd", k.attn_train_bwd(qkv_s, dctx_s, bias_s, *ar),
                               k.attn_train_bwd_plain(qkv_s, dctx_s, bias_s, *ar), CARD_ATOL, CARD_RTOL)
            heads = [t.reshape(b, s, N, 64).transpose(1, 2).contiguous().requires_grad_()
                     for t in qkv_s.split(H, dim=1)]
            mask = None if bias_s is None else bias_s.to(torch.bfloat16).reshape(b, 1, 1, s)
            lib_fwd = sdpa_library(torch, *heads, mask, TRAIN_RATE)
            lib_bwd = sdpa_backward_library(torch, *heads, dctx_s.reshape(b, s, N, 64).transpose(1, 2), mask,
                                            TRAIN_RATE)
            in_bytes = nbytes_of((qkv_s,) if bias_s is None else (qkv_s, bias_s))
            self.time_row(rows, f"attn_train{name}", "attn_train", *fwd, lib_fwd, in_bytes + b * s * H * 2,
                          4.0 * b * N * s * s * 64, PEAK_BF16_FLOPS, check=False, device=True)
            self.time_row(rows, f"attn_train_bwd{name}", "attn_train_bwd", *bwd, lib_bwd,
                          in_bytes + nbytes_of((qkv_s, dctx_s)), 10.0 * b * N * s * s * 64, PEAK_BF16_FLOPS,
                          check=False, device=True)
        # the GEMM's training launches (its other rows are the inference ones)
        qkv = c["qkv"]
        _, u = k.gemm(x2d, w1, fw[1], "gelu_tanh_save")
        g16 = k.gemm(x2d, w1, fw[1], "gelu_tanh")
        for label, fn, pfn, lib, mm, nn, kk_, out_bytes in (
            ("gelu_tanh_save", lambda: k.gemm(x2d, w1, fw[1], "gelu_tanh_save"),
             lambda: k.gemm_plain(x2d, w1, fw[1], "gelu_tanh_save"), lambda: torch.matmul(x2d, w1), m, I, H, 6),
            ("f32", lambda: k.gemm(g16, w2, fw[3], "f32"), lambda: k.gemm_plain(g16, w2, fw[3], "f32"),
             lambda: torch.matmul(g16, w2), m, H, I, 4),
            ("gelu_bwd_tanh trans_b", lambda: k.gemm(dy2d, w2, None, "gelu_bwd_tanh", aux=u, trans_b=True),
             lambda: k.gemm_plain(dy2d, w2, None, "gelu_bwd_tanh", aux=u, trans_b=True),
             lambda: torch.matmul(dy2d, w2.T), m, I, H, 6),
            ("residual_f32 trans_b K=3072", lambda: k.gemm(g16, w1, None, "residual_f32", aux=h32, trans_b=True),
             lambda: k.gemm_plain(g16, w1, None, "residual_f32", aux=h32, trans_b=True),
             lambda: torch.matmul(g16, w1.T), m, H, I, 6),
            ("bias trans_b (dctx)", lambda: k.gemm(dy2d, wo, None, "bias", trans_b=True),
             lambda: k.gemm_plain(dy2d, wo, None, "bias", trans_b=True), lambda: torch.matmul(dy2d, wo.T), m, H, H, 2),
            ("residual_f32 trans_b K=2304", lambda: k.gemm(qkv, wqkv, None, "residual_f32", aux=h32, trans_b=True),
             lambda: k.gemm_plain(qkv, wqkv, None, "residual_f32", aux=h32, trans_b=True),
             lambda: torch.matmul(qkv, wqkv.T), m, H, 3 * H, 6),
        ):
            self.time_row(rows, f"gemm_bf16 train {label}", "gemm_bf16", fn, pfn, lib,
                          mm * kk_ * 2 + kk_ * nn * 2 + mm * nn * out_bytes, 2.0 * mm * nn * kk_, PEAK_BF16_FLOPS,
                          check=False)
        return rows

    def band_conv_rows(self) -> dict[str, dict]:
        """ImageBERT-B's label conv as its training Function (``ops/band_conv.py``) at TRAIN_B: [B*10, 8H] @
        the band of 8 f32 taps, forward ("f32" out, F32_OUT_BAND) and backward (dx in the ulp band, the taps'
        and bias's gradients in relative L2 against the oracle's autograd), each then timed beside its bound
        (the band's 48 non-zero [H, H] blocks), its plain version and a library call: one ``torch.mm`` with an
        f32 out, and autograd through a bf16 ``torch.matmul``."""
        from importlib import import_module

        torch = self.torch
        bc = import_module(f"{PKG}.ops.band_conv")
        mc = TRAIN_B * 10
        x = self.randn(mc, 8 * H, dtype=torch.bfloat16)
        taps, bias = self.randn(8, H, H, scale=0.02), self.randn(H, scale=0.1)
        dy = self.randn(mc, 8 * H)
        band = bc.conv_band(taps.to(torch.bfloat16), 3)

        def grads_of(fn, *args):
            leaves = [t.detach().clone().requires_grad_() for t in args]
            y = fn(*leaves)
            return lambda: torch.autograd.grad(y, leaves, dy.to(y.dtype), retain_graph=True)

        kernel, plain = (grads_of(lambda *a, f=f: f(*a, 3), x, taps, bias)
                         for f in (bc.band_conv_train, bc.band_conv_train_plain))
        tag = f"[{mc} x {8 * H} @ {8 * H} x {8 * H}, B={TRAIN_B}]"
        self.check(f"band_conv_train y vs plain {tag}", "band_conv_train", bc.band_conv_train(x, taps, bias, 3),
                   bc.band_conv_train_plain(x, taps, bias, 3), F32_OUT_BAND)
        got, want = kernel(), plain()
        self.check(f"band_conv_train dx vs the plain version's autograd {tag}", "band_conv_train", got[0], want[0],
                   CARD_ATOL, CARD_RTOL)
        if got[0].dtype != torch.bfloat16 or any(g.dtype != torch.float32 for g in got[1:]):
            self.failures.append("band_conv_train gradient dtypes")
        self.check_rel(f"band_conv_train dtaps, dbias vs the plain version's autograd {tag}", "band_conv_train",
                       got[1:], want[1:], TRAIN_GRAD_REL_L2)
        rows: dict[str, dict] = {}
        flops = 2.0 * mc * H * H * CONV_BLOCKS
        ins = nbytes_of((x, taps, bias))
        self.time_row(rows, "band_conv_train", "band_conv_train", lambda: bc.band_conv_train(x, taps, bias, 3),
                      lambda: bc.band_conv_train_plain(x, taps, bias, 3),
                      lambda: torch.mm(x, band, out_dtype=torch.float32), ins + mc * 8 * H * 4, flops,
                      PEAK_BF16_FLOPS, check=False)
        self.time_row(rows, "band_conv_train_backward", "band_conv_train", kernel, plain,
                      grads_of(torch.matmul, x, band), ins + nbytes_of((dy, x, taps, bias)), 2 * flops,
                      PEAK_BF16_FLOPS, check=False)
        return rows

    def train_data(self, work):
        """A synthetic TSV, its labels and query_labels.txt (every synthetic query, as tests/test_scripts.py
        writes them) -> (tsv path, labels path, query-labels path)."""
        from importlib import import_module

        synthetic = import_module(f"{PKG}.data.synthetic")
        tsv, labels, qlabels = work / "train.tsv", work / "labels.txt", work / "query_labels.txt"
        tsv.write_text("\n".join(synthetic.make_tsv(N_ROWS, seed=self.seed)) + "\n")
        labels.write_text("".join(f"{key}\t{val}\n" for key, val in synthetic.SYNTHETIC_LABELS.items()))
        qlabels.write_text("".join(f"{300000 + i}\t{q}\tdress,others\n"
                                   for i, q in enumerate(synthetic.SYNTHETIC_QUERIES)))
        return tsv, labels, qlabels

    def sampled_train_batches(self, name: str):
        """The training data of ImageBERT-A or -B at full width: the synthetic TSV of ``train_data`` under
        build/smoke/train, the model's spec (held to the full-width config with dropout TRAIN_RATE), its
        params from the seed, and TRAIN_STEPS batches of TRAIN_B pairs from its recipe's hard-negative
        sampler -> (spec, params, batches, (tsv, labels, qlabels), sampled pairs)."""
        from importlib import import_module

        pkg = import_module(PKG)
        data = import_module(f"{PKG}.data")
        models = import_module(f"{PKG}.models")
        tok = import_module(f"{PKG}.tokenization")
        work = pkg.BUILD_DIR / "smoke" / "train"
        work.mkdir(parents=True, exist_ok=True)
        tsv, labels, qlabels = self.train_data(work)
        spec = models.get_model(name)
        cfg = spec.config
        if (cfg.hidden_size, cfg.num_hidden_layers, cfg.num_attention_heads, cfg.hidden_dropout_prob,
                cfg.attention_probs_dropout_prob) != (H, 12, N, TRAIN_RATE, TRAIN_RATE):
            raise RuntimeError(f"not the full-width config with dropout {TRAIN_RATE}: {cfg}")
        sampler_cfg = data.SamplerConfig.imagebert_a if name == "imagebert_a" else data.SamplerConfig.imagebert_b
        sampler = data.HardNegativeSampler(
            data.Featurizer(tok.FullTokenizer.google_style(pkg.VOCAB_PATH), data.load_multimodal_labels(labels)),
            data.QueryLabelIndex.load(qlabels), sampler_cfg(self.seed))
        lines = tsv.read_text().splitlines()
        examples = []
        while len(examples) < TRAIN_STEPS * TRAIN_B:
            examples.extend(sampler.examples(lines))
        batches = [data.pad_batch(data.stack_examples(examples[i * TRAIN_B:(i + 1) * TRAIN_B]), TRAIN_B)
                   for i in range(TRAIN_STEPS)]
        return spec, spec.init_params(self.seed), batches, (tsv, labels, qlabels), len(examples)

    def train_imagebert_a(self) -> tuple[dict[str, dict], dict]:
        """The training path at full width: the step-1 check of the kernel route against the plain routes
        with the MLM loss on; TRAIN_STEPS timed steps with the counters read at every one; the MLM head's
        forward and backward timed; TRAIN_STEPS steps through cli/train.py on the sampler; packed shards of
        the same TSV from cli/build_packed.py and TRAIN_STEPS steps through cli/train.py --packed-dir with the
        MLM loss, the gradient summaries and a valid pass every VALID_EVERY steps; that run again as
        RESUME_AT steps and a --resume for the rest, held bit-equal to it -> (each counted CLI run's
        launches, held exact; the phase's numbers)."""
        from importlib import import_module

        import numpy as np

        torch = self.torch
        pkg = import_module(PKG)
        models = import_module(f"{PKG}.models")
        train = import_module(f"{PKG}.train")
        train_cli = import_module(f"{PKG}.cli.train")
        build_packed = import_module(f"{PKG}.cli.build_packed")
        optim = import_module(f"{PKG}.train.optim")

        work = pkg.BUILD_DIR / "smoke" / "train"
        t0 = time.perf_counter()
        spec, params, batches, (tsv, labels, qlabels), n_examples = self.sampled_train_batches("imagebert_a")
        cfg = spec.config
        # A's recipe with a short warmup and horizon, so the few steps move the parameters (the recipe's
        # 30k-step warmup starts at LR 0)
        tc = dataclasses.replace(train.recipe_for("imagebert_a"), num_warmup_steps=TRAIN_STEPS // 2,
                                 num_train_steps=10 * TRAIN_STEPS)
        log(f"train setup: {n_examples} sampled pairs, {cfg.num_hidden_layers}x{cfg.hidden_size} params, "
            f"{time.perf_counter() - t0:.1f} s")

        step1 = self.step1_against_truth(spec, dataclasses.replace(tc, mlm_loss_weight=MLM_WEIGHT), params,
                                         batches[0], "train (MLM loss on)", MLM_HEAD)
        trainer = train.Trainer(spec, tc, precision=models.Precision.bf16(), device=self.dev)
        state = trainer.init_state(params)
        _, steps = self.timed_train_steps(trainer, state, batches, PER_STEP, "train")
        profile = self.profile_steps(trainer, state, batches[:2])
        del trainer, state
        mlm = self.time_mlm_head(params)

        # the user's entry point: cli/train.py, counters around the whole run
        runs = {}
        schedule = ["--warmup-steps", str(tc.num_warmup_steps), "--total-steps", str(tc.num_train_steps),
                    "--seed", str(self.seed), "--checkpoint-every", "1000", "--batch-size", str(TRAIN_B)]
        report = counted_run(torch, runs, "imagebert_a_train", expected_launches(TRAIN_STEPS, PER_STEP),
                             lambda: train_cli.main(["--model", "imagebert_a", "--train-tsv", str(tsv), "--labels",
                                                     str(labels), "--query-labels", str(qlabels), "--steps",
                                                     str(TRAIN_STEPS), "--out", str(work / "run"), *schedule]))
        log(f"train end to end through cli/train.py: {report['pairs']} pairs in {report['seconds']:.3f} s = "
            f"{report['pairs_per_second']:.1f} pairs/s (host sampler included)")
        ckpt = optim.flatten_paths(import_module(f"{PKG}.checkpoint").load_npz(work / "run" / f"step_{TRAIN_STEPS}.npz"))
        if not all(np.isfinite(v).all() for v in ckpt.values()):
            raise RuntimeError("the trained checkpoint holds non-finite values")

        # the sampler drained once into packed shards, then cli/train.py --packed-dir with the MLM loss, the
        # gradient summaries and the valid loop; counters around the training run, valid passes included
        packed = work / "packed_a"
        for d in (packed, work / "run_packed", work / "run_resume"):
            shutil.rmtree(d, ignore_errors=True)
        build = build_packed.main(["--model", "imagebert_a", "--train-tsv", str(tsv), "--labels", str(labels),
                                   "--query-labels", str(qlabels), "--out", str(packed), "--seed", str(self.seed)])
        log(f"cli/build_packed.py: {build['num_instances']} instances in {build['seconds']:.3f} s = "
            f"{build['instances_per_second']:.1f} instances/s, {build['bytes']} bytes on disk")
        valid_tsv, answers = self.valid_data(work)

        def packed_argv(n_steps, out, *extra):
            return ["--model", "imagebert_a", "--packed-dir", str(packed), "--labels", str(labels), "--steps",
                    str(n_steps), "--out", str(out), *schedule, "--mlm-weight", str(MLM_WEIGHT), "--grad-summaries",
                    "--valid-tsv", str(valid_tsv), "--answers", str(answers), "--valid-every", str(VALID_EVERY),
                    "--valid-batch-size", str(MAIN_B), *extra]

        n_valid = (TRAIN_STEPS // VALID_EVERY) * -(-VALID_ROWS // MAIN_B)
        train_part, valid_part = expected_launches(TRAIN_STEPS, PER_STEP), expected_launches(n_valid,
                                                                                              PER_BATCH["imagebert_a"])
        packed_trainer, straight, packed_report = counted_run(
            torch, runs, "imagebert_a_train_packed", {k: train_part[k] + valid_part[k] for k in train_part},
            lambda: train_cli.run(packed_argv(TRAIN_STEPS, work / "run_packed")))
        first = json.loads((work / "run_packed" / "metrics.jsonl").read_text().splitlines()[0])
        ndcgs = [v["valid_ndcg5"] for v in packed_report["valid"]]
        summaries = [k for k in first if k.startswith("grad_norm_pre_clip/")]
        if (len(ndcgs) != TRAIN_STEPS // VALID_EVERY or not all(0.0 <= v <= 1.0 for v in ndcgs)
                or not np.isfinite(first["mlm_loss"]) or "grad_norm_post_clip/cls/predictions" not in first
                or not (work / "run_packed" / "best.npz").exists()):
            raise RuntimeError(f"the packed run's valid passes {ndcgs}, first metrics {sorted(first)}")
        log(f"train end to end through cli/train.py --packed-dir (MLM loss {MLM_WEIGHT}, {len(summaries)} gradient "
            f"groups summarised): {packed_report['pairs']} pairs in {packed_report['seconds']:.3f} s = "
            f"{packed_report['pairs_per_second']:.1f} pairs/s (sampler path {report['pairs_per_second']:.1f}, "
            f"device {steps['device_pairs_per_second']:.1f}); valid passes {json.dumps(packed_report['valid'])}; "
            f"checkpoint {packed_report['checkpoint_seconds']:.3f} s")

        # the resume check: RESUME_AT steps, then --resume for the rest, against the straight run
        train_cli.run(packed_argv(RESUME_AT, work / "run_resume"))
        _, resumed, _ = train_cli.run(packed_argv(TRAIN_STEPS - RESUME_AT, work / "run_resume", "--resume",
                                                  str(work / "run_resume" / f"state_{RESUME_AT}.npz")))
        # bit for bit: every parameter and both moments of the resumed run equal the straight run's. The
        # probe names any gradient that differs between runs of one step on the same inputs (an op that sums
        # in a varying order on the card would part the two runs)
        varying = self.varying_grads(packed_trainer, straight, batches[0])
        names = straight.optimizer.names
        pairs = {"params": (straight.leaves(), resumed.leaves()), "m": (straight.optimizer.m, resumed.optimizer.m),
                 "v": (straight.optimizer.v, resumed.optimizer.v)}
        differ = [f"{kind}/{n}" for kind, (xs, ys) in pairs.items()
                  for n, x, y in zip(names, xs, ys, strict=True) if not torch.equal(x, y)]
        if resumed.step != straight.step or differ or varying:
            raise RuntimeError(f"{RESUME_AT} + {TRAIN_STEPS - RESUME_AT} resumed steps (step {resumed.step}) are not "
                               f"{TRAIN_STEPS} straight ones bit for bit: {differ[:8]}; gradients varying between "
                               f"runs of one step: {varying}")
        resume = {"bit_equal_tensors": len(names) * len(pairs), "tensors": len(names) * len(pairs),
                  "grads_varying_between_runs_of_a_step": varying}
        log(f"resume: {RESUME_AT} steps, then --resume for {TRAIN_STEPS - RESUME_AT}, against {TRAIN_STEPS} straight "
            f"steps (step {resumed.step}): bit-equal {json.dumps(resume)}")
        del packed_trainer, straight, resumed
        for d in (work / "run", work / "run_packed", work / "run_resume"):  # ~1.8 GB of checkpoints each
            shutil.rmtree(d)
        rates = {"step1": step1, **steps, "cli": report, "profile": profile, "mlm_head": mlm, "build_packed": build,
                 "cli_packed": packed_report, "resume": resume,
                 "device_busy_share": profile["device_busy_ms_per_step"] / steps["device_ms_per_step"]["total"]}
        log(f"train: the device busy {100 * rates['device_busy_share']:.1f}% of a step (the profiled kernels' sum "
            f"over the CUDA-event step time)")
        return runs, rates

    def varying_grads(self, trainer, state, batch, runs: int = 3) -> list[str]:
        """One step's gradients ``runs`` times on the same params, batch and dropout seed -> the parameters whose
        gradient differs between any two runs (the ops that sum in a varying order on the card)."""
        torch = self.torch
        dev_batch = trainer.to_device(batch)
        first, _ = trainer.grads(state, dev_batch, seed=3)
        varying = set()
        for _ in range(runs - 1):
            again, _ = trainer.grads(state, dev_batch, seed=3)
            varying.update(n for n, a, b in zip(state.optimizer.names, first, again) if not torch.equal(a, b))
        log(f"one step's gradients {runs} times on the same inputs: {len(varying)} of {len(first)} vary: "
            f"{sorted(varying)}")
        return sorted(varying)

    def valid_data(self, work):
        """A planted valid set (``make_eval_tsv``, VALID_ROWS rows from the seed) and its answers -> their paths."""
        from importlib import import_module

        lines, answers = import_module(f"{PKG}.data.synthetic").make_eval_tsv(VALID_ROWS, seed=self.seed)
        tsv, path = work / "valid.tsv", work / "valid_answer.json"
        tsv.write_text("\n".join(lines) + "\n")
        path.write_text(json.dumps(answers))
        return tsv, path

    def time_mlm_head(self, params) -> dict:
        """The tied MLM head and loss of one B=TRAIN_B step (MLM_POSITIONS masked positions a pair, the
        seed's A weights, bf16 operands into f32 products), forward and forward + backward by CUDA events,
        beside their bound: the products' operations at the bf16 tensor-core rate (their operands are bf16) or
        the bytes (hidden states, the table, the head, the logits written), whichever is larger."""
        from importlib import import_module

        torch = self.torch
        heads = import_module(f"{PKG}.models.heads")
        models = import_module(f"{PKG}.models")
        rows = TRAIN_B * MLM_POSITIONS
        head = params["cls"]["predictions"]
        table = params["bert"]["embeddings"]["word_embeddings"].to(self.dev).requires_grad_()
        vocab = table.shape[0]
        tree = {"transform": {"dense": {k: v.to(self.dev).requires_grad_() for k, v in head["transform"]["dense"].items()},
                              "LayerNorm": {k: v.to(self.dev) for k, v in head["transform"]["LayerNorm"].items()}},
                "output_bias": head["output_bias"].to(self.dev).requires_grad_()}
        g = torch.Generator(device="cpu").manual_seed(self.seed + 70)
        hidden = torch.randn(rows, H, generator=g).to(self.dev).requires_grad_()
        ids = torch.randint(0, vocab, (rows,), generator=g).to(self.dev)
        weights = (torch.rand(rows, generator=g) > 0.3).float().to(self.dev)
        leaves = [hidden, table, tree["transform"]["dense"]["kernel"], tree["output_bias"]]
        prec = models.Precision.bf16()

        def forward():
            return heads.mlm_loss(heads.mlm_logits(tree, hidden, table, prec), ids, weights)

        def forward_backward():
            torch.autograd.grad(forward(), leaves)

        with torch.no_grad():
            fwd_ms = cuda_ms(torch, forward)
        both_ms = cuda_ms(torch, forward_backward)
        flops = 2 * rows * H * (H + vocab)
        logits_bytes = rows * vocab * 4
        ins = nbytes_of((hidden, table, tree["transform"]["dense"]["kernel"], tree["output_bias"]))
        fwd_bound, fwd_by = bound_ms(ins + logits_bytes, flops, PEAK_BF16_FLOPS)
        bwd_bound, bwd_by = bound_ms(2 * ins + logits_bytes, 2 * flops, PEAK_BF16_FLOPS)
        out = {"rows": rows, "vocab": vocab, "forward_ms": fwd_ms, "backward_ms": both_ms - fwd_ms,
               "forward_bound_ms": fwd_bound, "forward_bound_by": fwd_by, "backward_bound_ms": bwd_bound,
               "backward_bound_by": bwd_by}
        log(f"MLM head at B={TRAIN_B} ({rows} masked positions, vocab {vocab}): forward {fwd_ms:.4f} ms "
            f"(bound {fwd_bound:.4f}, {fwd_by}), backward {both_ms - fwd_ms:.4f} ms (bound {bwd_bound:.4f}, {bwd_by})")
        return out

    def train_imagebert_b(self) -> tuple[dict[str, dict], dict]:
        """ImageBERT-B training at full width through train.Trainer (B's recipe: Adam on the staircase,
        per-value clip, AM loss, EMA; the label conv as its 8 taps): the step-1 check against the f32 truth,
        taps included; TRAIN_STEPS timed steps with the counters read at every one; two profiled steps; one
        step with the word-match loss; TRAIN_STEPS steps through cli/train.py, its checkpoint scored by
        cli/score.py; B_C_CLI_STEPS steps of ImageBERT-C through cli/train.py -> (each run's launches: the
        timed steps summed, the two training CLI runs and the scoring run, each held exact; the numbers)."""
        from importlib import import_module

        import numpy as np

        torch = self.torch
        pkg = import_module(PKG)
        models = import_module(f"{PKG}.models")
        train = import_module(f"{PKG}.train")
        train_cli = import_module(f"{PKG}.cli.train")
        score_cli = import_module(f"{PKG}.cli.score")
        checkpoint = import_module(f"{PKG}.checkpoint")
        optim = import_module(f"{PKG}.train.optim")

        work = pkg.BUILD_DIR / "smoke" / "train"
        t0 = time.perf_counter()
        spec, params, batches, (tsv, labels, qlabels), n_examples = self.sampled_train_batches("imagebert_b")
        cfg = spec.config
        tc = train.recipe_for("imagebert_b")
        n_params = sum(v.numel() for v in optim.flatten_paths(spec.train_params(params)).values())
        log(f"imagebert_b train setup: {n_examples} sampled pairs, {cfg.num_hidden_layers}x{cfg.hidden_size}, "
            f"{n_params} trained parameters (the label conv as 8 taps), {time.perf_counter() - t0:.1f} s")

        step1 = self.step1_against_truth(spec, tc, params, batches[0], "imagebert_b train")
        bf16 = models.Precision.bf16()
        wm = train.Trainer(spec, dataclasses.replace(tc, word_match_loss_weight=0.5), precision=bf16, device=self.dev)
        state = wm.init_state(params, seed=self.seed)
        grads, metrics = wm.grads(state, wm.to_device(batches[0]), seed=1)
        g_head = dict(zip(state.optimizer.names, grads))["kdd_query_match/output_weights"].abs().max().item()
        wm_step = {"loss": metrics["loss"].item(), "word_match_loss": metrics["word_match_loss"].item(),
                   "max_abs_head_grad": g_head}
        log(f"imagebert_b train step 1 with the word-match loss (weight 0.5): {json.dumps(wm_step)}")
        if not all(np.isfinite(list(wm_step.values()))) or not g_head > 0:
            raise RuntimeError("the word-match step gave a non-finite loss or no gradient of its head")
        del wm, state, grads

        trainer = train.Trainer(spec, tc, precision=bf16, device=self.dev)
        state = trainer.init_state(params)
        runs = {}
        runs["imagebert_b_train"], steps = self.timed_train_steps(trainer, state, batches, PER_STEP_B,
                                                                   "imagebert_b train")
        profile = self.profile_steps(trainer, state, batches[:2], "imagebert_b_profile.txt")
        del trainer, state

        def counted(path, n, per, fn):
            return counted_run(torch, runs, path, expected_launches(n, per), fn)

        def cli_argv(model, steps, out):
            return ["--model", model, "--train-tsv", str(tsv), "--labels", str(labels), "--query-labels",
                    str(qlabels), "--steps", str(steps), "--batch-size", str(TRAIN_B), "--out", str(out),
                    "--checkpoint-every", "1000", "--seed", str(self.seed)]

        report = counted("imagebert_b_train_cli", TRAIN_STEPS, PER_STEP_B,
                             lambda: train_cli.main(cli_argv("imagebert_b", TRAIN_STEPS, work / "run_b")))
        log(f"imagebert_b train end to end through cli/train.py: {report['pairs']} pairs in {report['seconds']:.3f} s "
            f"= {report['pairs_per_second']:.1f} pairs/s (host sampler included)")
        ckpt = work / "run_b" / f"step_{TRAIN_STEPS}.npz"
        tree = checkpoint.load_npz(ckpt)
        if tree["kdd_conv1"].keys() != {"weights", "biases"} or tree["kdd_conv1"]["weights"].shape != (8, H, H):
            raise RuntimeError(f"the checkpoint's kdd_conv1 is not 8 taps: {tree['kdd_conv1'].keys()}")
        scores = work / "scores_b.tsv"
        n_pairs = N_ROWS
        counted("imagebert_b_trained_score", -(-n_pairs // MAIN_B), PER_BATCH["imagebert_b"],
                    lambda: score_cli.main(["--model", "imagebert_b", "--tsv", str(tsv), "--labels", str(labels),
                                            "--checkpoint", str(ckpt), "--out", str(scores),
                                            "--expect-pairs", str(n_pairs)]))
        values = np.array([float(line.split("\t")[2]) for line in scores.read_text().splitlines()])
        if len(values) != n_pairs or not np.isfinite(values).all():
            raise RuntimeError(f"the trained checkpoint's scores: {len(values)} rows, "
                               f"finite {np.isfinite(values).all()}")
        log(f"imagebert_b trained checkpoint through cli/score.py: {len(values)} finite scores in "
            f"[{values.min():.4f}, {values.max():.4f}]")
        c_report = counted("imagebert_c_train_cli", B_C_CLI_STEPS, PER_STEP_B,
                               lambda: train_cli.main(cli_argv("imagebert_c", B_C_CLI_STEPS, work / "run_c")))
        # B's sampler drained into packed shards (its word-match fields among them), then B_PACKED_STEPS steps
        # through cli/train.py --packed-dir with the word-match loss on
        packed = work / "packed_b"
        for d in (packed, work / "run_b_packed"):
            shutil.rmtree(d, ignore_errors=True)
        build = import_module(f"{PKG}.cli.build_packed").main([
            "--model", "imagebert_b", "--train-tsv", str(tsv), "--labels", str(labels), "--query-labels", str(qlabels),
            "--out", str(packed), "--seed", str(self.seed)])
        if not {"word_match_labels", "word_match_weights"} <= set(build["fields"]):
            raise RuntimeError(f"B's packed shards hold no word-match fields: {build['fields']}")
        b_packed = counted("imagebert_b_train_packed", B_PACKED_STEPS, PER_STEP_B, lambda: train_cli.main([
            "--model", "imagebert_b", "--packed-dir", str(packed), "--labels", str(labels), "--steps",
            str(B_PACKED_STEPS), "--batch-size", str(TRAIN_B), "--out", str(work / "run_b_packed"),
            "--checkpoint-every", "1000", "--seed", str(self.seed), "--word-match-weight", "0.5"]))
        first = json.loads((work / "run_b_packed" / "metrics.jsonl").read_text().splitlines()[0])
        if not np.isfinite([first["loss"], first["word_match_loss"]]).all():
            raise RuntimeError(f"B's packed run: first metrics {first}")
        log(f"imagebert_b through cli/train.py --packed-dir with the word-match loss: {b_packed['pairs']} pairs in "
            f"{b_packed['seconds']:.3f} s = {b_packed['pairs_per_second']:.1f} pairs/s; step 0 loss "
            f"{first['loss']:.5f}, word-match loss {first['word_match_loss']:.5f}")
        for d in (work / "run_b", work / "run_c", work / "run_b_packed"):  # ~2.3 GB of checkpoints each
            shutil.rmtree(d)
        rates = {"step1": step1, "word_match_step1": wm_step, **steps, "cli": report, "cli_imagebert_c": c_report,
                 "build_packed": build, "cli_packed": b_packed,
                 "trained_scores": {"pairs": len(values), "min": float(values.min()), "max": float(values.max())},
                 "profile": profile,
                 "device_busy_share": profile["device_busy_ms_per_step"] / steps["device_ms_per_step"]["total"]}
        log(f"imagebert_b train: the device busy {100 * rates['device_busy_share']:.1f}% of a step (the profiled "
            f"kernels' sum over the CUDA-event step time)")
        return runs, rates

    def step1_against_truth(self, spec, tc, params, batch, tag: str, must_hold: tuple[str, ...] = (),
                            loss_over_plain: bool = False) -> dict:
        """Step 1 from one params/batch/seed on three routes: the kernels, plain in bf16 and plain in f32 (the
        truth, TF32 off). Fails unless each parameter's gradient on the kernel route is within TRAIN_STEP_REL_L2
        of the truth in relative L2, or within TRAIN_OVER_PLAIN times the bf16 plain route's own error, whichever
        is larger, the losses are finite and within 1e-2 (with ``loss_over_plain``, within 1e-2 or
        TRAIN_OVER_PLAIN times the plain route's own loss error, whichever is larger: the two-tower's logits
        are cosines over a temperature of 0.05, twenty times the cosines' bf16 errors), and every parameter of
        ``must_hold`` got a non-zero gradient among those held -> the losses (and the MLM loss where it is on)
        and the worst 5 parameters."""
        from importlib import import_module

        import numpy as np

        torch = self.torch
        models = import_module(f"{PKG}.models")
        train = import_module(f"{PKG}.train")
        bf16 = models.Precision.bf16()
        routes = {"kernel": (bf16, models.TRAIN_KERNEL_BLOCKS), "plain_bf16": (bf16, models.TRAIN_PLAIN_BLOCKS),
                  "plain_f32": (models.Precision.f32(), models.TRAIN_PLAIN_BLOCKS)}
        step1, mlm_losses = {}, {}
        for route_name, (prec, blocks) in routes.items():
            trainer = train.Trainer(spec, tc, precision=prec, device=self.dev, blocks=blocks)
            state = trainer.init_state(params)
            grads, metrics = trainer.grads(state, trainer.to_device(batch), seed=1)
            step1[route_name] = (metrics["loss"].item(), [g.detach() for g in grads], state.optimizer.names)
            if "mlm_loss" in metrics:
                mlm_losses[route_name] = metrics["mlm_loss"].item()
            del trainer, state, grads
        tf32 = torch.backends.cuda.matmul.allow_tf32
        (loss_k, gk, names), (loss_p, gp, _), (loss_t, gt, _) = (step1[r] for r in routes)
        worst, failed = [], []
        for name, a, p_, t in zip(names, gk, gp, gt):
            tn = t.float().norm().clamp_min(1e-30)
            ek, ep = ((a.float() - t.float()).norm() / tn).item(), ((p_.float() - t.float()).norm() / tn).item()
            worst.append((ek, ep, name))
            if not ek <= max(TRAIN_STEP_REL_L2, TRAIN_OVER_PLAIN * ep):
                failed.append(name)
        worst.sort(reverse=True)
        log(f"{tag} step 1: loss kernel {loss_k:.6f}, plain bf16 {loss_p:.6f}, f32 truth {loss_t:.6f}; gradients "
            f"vs the truth, relative L2 (kernel, plain bf16, name), worst 5: "
            f"{[(f'{a:.3g}', f'{b_:.3g}', n) for a, b_, n in worst[:5]]}; band max({TRAIN_STEP_REL_L2:g}, "
            f"{TRAIN_OVER_PLAIN:g} x plain); TF32 after the f32 route: {tf32}")
        loss_band = max(1e-2, TRAIN_OVER_PLAIN * abs(loss_p - loss_t)) if loss_over_plain else 1e-2
        if failed or not all(np.isfinite([loss_k, loss_p, loss_t])) or abs(loss_k - loss_t) > loss_band:
            raise RuntimeError(f"{tag}: step-1 gradients of the kernel route disagree with the f32 truth: {failed}")
        by_name = dict(zip(names, gk))
        unheld = [n for n in must_hold if n not in by_name or not by_name[n].abs().max().item() > 0]
        if unheld:
            raise RuntimeError(f"{tag}: no gradient held for {unheld}")
        out = {"loss_kernel": loss_k, "loss_plain_bf16": loss_p, "loss_f32_truth": loss_t, "params": len(names),
               "worst_rel_l2": [{"param": n, "kernel": a, "plain_bf16": b_} for a, b_, n in worst[:5]]}
        if mlm_losses:
            out["mlm_loss"] = mlm_losses
            log(f"{tag} step 1: MLM loss {json.dumps(mlm_losses)}")
        return out

    def timed_train_steps(self, trainer, state, batches, per_step: dict, tag: str) -> tuple[dict, dict]:
        """One step per batch on the kernel route, the device time split into forward, backward and optimizer by
        CUDA events; every launch counter set to 0 before each step, read after it and held to ``per_step``
        -> (the launches summed over the steps, the numbers)."""
        import numpy as np

        torch = self.torch
        start = [p.detach().clone() for p in state.leaves()]
        counted = launch_counters()
        expected = expected_launches(1, per_step)
        total = dict.fromkeys(expected, 0)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        split, losses = [], []
        for i, batch in enumerate(batches):
            dev_batch = trainer.to_device(batch)
            torch.cuda.synchronize()
            for w in counted:
                w.launches = 0
            gen = torch.Generator(device=self.dev).manual_seed(100 + i)
            ev[0].record()
            loss, metrics = trainer.loss_fn(state.params, dev_batch, gen)
            ev[1].record()
            grads = torch.autograd.grad(loss, state.leaves(), allow_unused=True)
            grads = [torch.zeros_like(p) if g is None else g for p, g in zip(state.leaves(), grads)]
            ev[2].record()
            metrics.update(trainer.apply(state, grads))
            ev[3].record()
            torch.cuda.synchronize()
            counts = {w.__name__: w.launches for w in counted}
            if counts != expected:
                raise RuntimeError(f"{tag} step {i + 1} launches {counts}, expected {expected}")
            total = {name: total[name] + n for name, n in counts.items()}
            split.append([ev[j].elapsed_time(ev[j + 1]) for j in range(3)])
            losses.append(metrics["loss"].item())
        moved = max((p.detach() - s0).abs().max().item() for p, s0 in zip(state.leaves(), start))
        fwd, bwd, opt = (float(np.median([r[j] for r in split[1:]])) for j in range(3))
        n, b = len(batches), len(batches[0]["labels"])
        log(f"{tag} {n} steps on the kernel route at B={b}: losses {[round(v, 5) for v in losses]}; "
            f"device ms per step (median of steps 2..{n}): forward {fwd:.3f}, backward {bwd:.3f}, "
            f"optimizer {opt:.3f}, total {fwd + bwd + opt:.3f} = {b / (fwd + bwd + opt) * 1e3:.1f} pairs/s "
            f"on the device; max |param moved| {moved:.3g}; launches exact at every step")
        if not all(np.isfinite(losses)) or not moved > 0:
            raise RuntimeError(f"{tag}: training diverged or did not move the parameters")
        return total, {"losses": losses, "device_ms_per_step": {"forward": fwd, "backward": bwd, "optimizer": opt,
                                                                "total": fwd + bwd + opt},
                       "device_pairs_per_second": b / (fwd + bwd + opt) * 1e3}

    def profile_steps(self, trainer, state, batches, table_name: str = "profile.txt") -> dict:
        """torch.profiler over train steps on the kernel route: the device time by kernel (the table goes to
        build/smoke/train/<table_name>), per step."""
        from importlib import import_module

        from torch.profiler import ProfilerActivity, profile

        torch = self.torch
        dev_batches = [trainer.to_device(b) for b in batches]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for i, b in enumerate(dev_batches):
                grads, _ = trainer.grads(state, b, seed=200 + i)
                trainer.apply(state, grads)
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        averages = prof.key_averages()
        table = averages.table(sort_by="self_device_time_total", row_limit=40)
        (import_module(PKG).BUILD_DIR / "smoke" / "train" / table_name).write_text(table)
        # the kernels themselves (the ops that launch them carry the same time as their own "self" device time)
        kernels = [e for e in averages if str(e.device_type).endswith("CUDA")]
        n = len(batches)
        busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / n
        by_name: dict[str, float] = {}  # kernel names cut to 80 characters; templates that share a prefix add up
        for e in kernels:
            by_name[e.key[:80]] = by_name.get(e.key[:80], 0.0) + e.self_device_time_total / 1e3 / n
        top = dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:20])
        out = {"steps": n, "wall_ms_per_step_profiler_on": wall_ms / n, "device_busy_ms_per_step": busy_ms,
               "kernel_ms_per_step": top}
        log(f"train profile, {n} steps: device busy {busy_ms:.3f} ms a step (kernels' sum; wall "
            f"{wall_ms / n:.1f} ms a step with the profiler on); ms a step by kernel: "
            f"{json.dumps(out['kernel_ms_per_step'])}")
        return out



    # ---- phase 6: LXMERT training -------------------------------------------------

    def cross_train_case(self, b: int, f: int, t: int, identity: bool = False):
        """The cross train kernels' inputs at batch b, f queries over t keys: q [b*f, H], kv [b*t, 2H], the key
        stream's seeded mask rows (``key_bias``: LXMERT's; its visn rows include pairs with every key masked) and
        dctx. With ``identity`` V and dctx are the identity per head, so ctx holds the dropped probabilities and
        dV their transpose."""
        torch = self.torch
        q, kv, dctx = (self.randn(*shape) for shape in ((b * f, H), (b * t, 2 * H), (b * f, H)))
        if identity:
            v = torch.zeros(b, t, N, 64, device=self.dev)
            v[:, torch.arange(t), :, torch.arange(t)] = 1.0
            kv[:, H:] = v.reshape(b * t, H)
            dctx = torch.zeros(b, f, N, 64, device=self.dev)
            dctx[:, torch.arange(f), :, torch.arange(f)] = 1.0
        return {"q": q.to(torch.bfloat16), "kv": kv.to(torch.bfloat16), "bias": self.key_bias(b, t),
                "dctx": dctx.reshape(b * f, H).to(torch.bfloat16)}

    def check_cross_train_kernels(self) -> None:
        """attn_train_cross and its backward against their plain versions at TRAIN_CHECK_B and TRAIN_B, both
        directions, dropout 0 and TRAIN_RATE, with and without the key mask; at rate 0.5 the dropped units
        equal the hash mask's, in the forward and backward kernels and their plain versions."""
        from importlib import import_module

        k = import_module(f"{PKG}.ops.kernels")
        dropout = import_module(f"{PKG}.ops.dropout")
        torch = self.torch
        for b in (TRAIN_CHECK_B, TRAIN_B):
            blk = dropout.pick_block(b, 8)
            for label, f, t in LX_DIRECTIONS:
                c = self.cross_train_case(b, f, t)
                for rate in (0.0, TRAIN_RATE):
                    for mlabel, bias in (("no mask", None), ("key mask", c["bias"])):
                        a = (b, f, t, N, 55, rate, blk)
                        tag = f"[{label}, rate {rate}, {mlabel}, B={b}]"
                        self.check(f"attn_train_cross {tag}", "attn_train_cross",
                                   k.attn_train_cross(c["q"], c["kv"], bias, *a),
                                   k.attn_train_cross_plain(c["q"], c["kv"], bias, *a), CARD_ATOL, CARD_RTOL)
                        self.check(f"attn_train_cross_bwd dq, dkv {tag}", "attn_train_cross_bwd",
                                   k.attn_train_cross_bwd(c["q"], c["kv"], c["dctx"], bias, *a),
                                   k.attn_train_cross_bwd_plain(c["q"], c["kv"], c["dctx"], bias, *a),
                                   CARD_ATOL, CARD_RTOL)
                ci = self.cross_train_case(b, f, t, identity=True)
                keep = dropout.cross_probs_keep(123, 0.5, b, N, f, t, blk, self.dev)
                same = True
                for fn in (k.attn_train_cross, k.attn_train_cross_plain):
                    probs = fn(ci["q"], ci["kv"], None, b, f, t, N, 123, 0.5, blk)
                    probs = probs.reshape(b, f, N, 64)[..., :t].permute(0, 2, 1, 3)  # [b, n, query, key]
                    same = same and bool(torch.equal(probs == 0, ~keep))
                for fn in (k.attn_train_cross_bwd, k.attn_train_cross_bwd_plain):
                    dv = fn(ci["q"], ci["kv"], ci["dctx"], None, b, f, t, N, 123, 0.5, blk)[1][:, H:]
                    dv = dv.reshape(b, t, N, 64)[..., :f].permute(0, 2, 3, 1)  # [b, n, query, key]
                    same = same and bool(torch.equal(dv == 0, ~keep))
                log(f"check attn_train_cross masks [{label}, rate 0.5, B={b}]: dropped probabilities equal to the "
                    f"hash mask's in the forward and backward kernels and their plain versions: {same}")
                if not same:
                    self.failures.append(f"attn_train_cross masks {label} B={b}")

    def cross_block_fns(self, x, ctx, ws, bias, dy):
        """(forward of the train cross block, its backward, the plain oracle's forward, the oracle's autograd
        backward, the library forward, its autograd backward) at TRAIN_RATE, each a no-argument callable."""
        from importlib import import_module

        torch = self.torch
        F = torch.nn.functional
        tb = import_module(f"{PKG}.ops.train_blocks")
        dropout = import_module(f"{PKG}.ops.dropout")
        b, f, _ = x.shape
        t = ctx.shape[1]
        block = dropout.pick_block(b, dropout.train_block("attn"))
        kw = dict(bias=bias, attn_dropout_rate=TRAIN_RATE, hidden_dropout_rate=TRAIN_RATE)
        kernel = lambda x, c, *w: tb.cross_attention_block_train(x, c, *w, N, 42, **kw)  # noqa: E731
        plain = lambda x, c, *w: tb.cross_attention_block_train_plain(x, c, *w, N, 42, **kw)  # noqa: E731
        backward = lambda: tb.cross_attention_block_train_backward(  # noqa: E731
            dy, x, ctx, *ws[:7], bias, N, 42, TRAIN_RATE, TRAIN_RATE, 1e-12, block)

        def library(x, c, wq, bq, wkv, bkv, wo, bo, g, be):  # bf16 matmuls, SDPA with mask and dropout, F.layer_norm
            q = torch.matmul(x, wq.to(torch.bfloat16)) + bq.to(torch.bfloat16)
            kv = torch.matmul(c, wkv.to(torch.bfloat16)) + bkv.to(torch.bfloat16)
            qh = q.reshape(b, f, N, 64).transpose(1, 2)
            kh, vh = (z.reshape(b, t, N, 64).transpose(1, 2) for z in kv.split(H, dim=-1))
            o = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=bias.to(torch.bfloat16).reshape(b, 1, 1, t),
                                               dropout_p=TRAIN_RATE)
            o = F.dropout(torch.matmul(o.transpose(1, 2).reshape(b, f, H), wo.to(torch.bfloat16))
                          + bo.to(torch.bfloat16), TRAIN_RATE)
            return F.layer_norm((o + x).float(), (H,), g, be, 1e-12).to(torch.bfloat16)

        def grads_of(fn):
            leaves = [x.detach().clone().requires_grad_(), ctx.detach().clone().requires_grad_(),
                      *(w.detach().clone().requires_grad_() for w in ws)]
            y = fn(*leaves)
            return lambda: torch.autograd.grad(y, leaves, dy, retain_graph=True)

        fwd = (lambda: kernel(x, ctx, *ws), lambda: plain(x, ctx, *ws), lambda: library(x, ctx, *ws))
        return fwd, (backward, grads_of(plain), grads_of(library))

    def time_cross_train_kernels(self) -> dict[str, dict]:
        """At TRAIN_B, both directions: the train cross block held against its plain oracle (y in the ulp band,
        its 10 gradients in relative L2), then the block, forward and backward, and the kernels inside it timed
        beside their bounds, plain versions and library yardsticks."""
        from importlib import import_module

        k = import_module(f"{PKG}.ops.kernels")
        torch = self.torch
        b = TRAIN_B
        shapes = [(H, H), (H,), (H, 2 * H), (2 * H,), (H, H), (H,)]
        ws = [self.randn(*sh, scale=0.02) for sh in shapes] + [1.0 + self.randn(H, scale=0.1),
                                                                self.randn(H, scale=0.1)]
        wbytes = nbytes_of(ws)
        rows = {}
        for label, f, t in LX_DIRECTIONS:
            x, ctx = self.randn(b, f, H, dtype=torch.bfloat16), self.randn(b, t, H, dtype=torch.bfloat16)
            dy = self.randn(b, f, H, dtype=torch.bfloat16)
            bias = self.key_bias(b, t)
            (kf, pf, lf), (kb_, pb, lb) = self.cross_block_fns(x, ctx, ws, bias, dy)
            name, tag = "cross_attention_block_train", f"[{label}, rate {TRAIN_RATE}, key mask, B={b}]"
            self.check(f"{name} y vs plain oracle {tag}", name, kf(), pf(), CARD_ATOL, CARD_RTOL)
            got, want = kb_(), pb()
            if any(g.dtype != torch.bfloat16 for g in got[:2]) or any(g.dtype != torch.float32 for g in got[2:]):
                self.failures.append(f"{name} gradient dtypes")
            self.check_rel(f"{name}_backward dx, dctx, dWq, dbq, dWkv, dbkv, dWo, dbo, dgamma, dbeta vs the "
                           f"oracle's autograd {tag}", f"{name}_backward", got, want, TRAIN_GRAD_REL_L2)
            mf, mt, core = b * f, b * t, 4.0 * b * N * f * t * 64
            fwd_flops = 2.0 * mf * H * H + 2.0 * mt * H * 2 * H + core + 2.0 * mf * H * H
            bwd_flops = (fwd_flops + 2.0 * mf * H * H + 2.5 * core + 2.0 * mf * H * H + 2.0 * mt * 2 * H * H
                         + 2.0 * mf * H * H + 2.0 * mt * H * 2 * H + 2.0 * mf * H * H)
            act = 2 * (mf + mt) * H  # x and ctx, bf16
            self.time_row(rows, f"{name} {label}", name, kf, pf, lf, act + wbytes + bias.numel() * 4 + 2 * mf * H,
                          fwd_flops, PEAK_BF16_FLOPS, check=False)
            self.time_row(rows, f"{name}_backward {label}", f"{name}_backward", kb_, pb, lb,
                          2 * act + 2 * mf * H + 2 * wbytes + bias.numel() * 4, bwd_flops, PEAK_BF16_FLOPS,
                          check=False)

            # the kernels inside the block, at its shapes (rate TRAIN_RATE, the key mask)
            c = self.cross_train_case(b, f, t)
            q, kv, dctx = c["q"], c["kv"], c["dctx"]
            qh = q.reshape(b, f, N, 64).transpose(1, 2).contiguous().requires_grad_()
            kh, vh = (z.reshape(b, t, N, 64).transpose(1, 2).contiguous().requires_grad_() for z in kv.split(H, 1))
            mask = bias.to(torch.bfloat16).reshape(b, 1, 1, t)
            lib_fwd = sdpa_library(torch, qh, kh, vh, mask, TRAIN_RATE)
            lib_bwd = sdpa_backward_library(torch, qh, kh, vh, dctx.reshape(b, f, N, 64).transpose(1, 2), mask,
                                            TRAIN_RATE)
            a = (b, f, t, N, 55, TRAIN_RATE, 8)
            self.time_row(rows, f"attn_train_cross {label}", "attn_train_cross",
                          lambda q=q, kv=kv, bias=bias, a=a: k.attn_train_cross(q, kv, bias, *a),
                          lambda q=q, kv=kv, bias=bias, a=a: k.attn_train_cross_plain(q, kv, bias, *a), lib_fwd,
                          nbytes_of((q, kv, bias)) + mf * H * 2, core, PEAK_BF16_FLOPS, check=False, device=True)
            self.time_row(rows, f"attn_train_cross_bwd {label}", "attn_train_cross_bwd",
                          lambda q=q, kv=kv, d=dctx, bias=bias, a=a: k.attn_train_cross_bwd(q, kv, d, bias, *a),
                          lambda q=q, kv=kv, d=dctx, bias=bias, a=a: k.attn_train_cross_bwd_plain(q, kv, d, bias, *a),
                          lib_bwd, 2 * nbytes_of((q, kv)) + nbytes_of((dctx, bias)), 2.5 * core, PEAK_BF16_FLOPS,
                          check=False, device=True)
        return rows

    def train_lxmert(self) -> tuple[dict, dict]:
        """The LXMERT training path at full width through train.Trainer: the step-1 check against the f32
        truth, one step with am_loss, TRAIN_STEPS timed steps with the counters read at every one, two
        profiled steps -> (the launches summed over the timed steps, the phase's numbers)."""
        from importlib import import_module

        import numpy as np

        torch = self.torch
        pkg = import_module(PKG)
        data = import_module(f"{PKG}.data")
        synthetic = import_module(f"{PKG}.data.synthetic")
        models = import_module(f"{PKG}.models")
        tok = import_module(f"{PKG}.tokenization")
        train = import_module(f"{PKG}.train")

        work = pkg.BUILD_DIR / "smoke" / "train"
        work.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        spec = models.get_model("lxmert")
        cfg = spec.config
        shape = (cfg.bert.hidden_size, cfg.bert.num_attention_heads, cfg.l_layers, cfg.r_layers, cfg.x_layers,
                 cfg.bert.hidden_dropout_prob, cfg.bert.attention_probs_dropout_prob)
        if shape != (H, N, *LX_DEPTHS, TRAIN_RATE, TRAIN_RATE):
            raise RuntimeError(f"not the full-width LXMERT config with dropout {TRAIN_RATE}: {cfg}")
        params = spec.init_params(self.seed)
        tsv, labels = work / "pairs_lxmert.tsv", work / "labels.txt"
        tsv.write_text("\n".join(synthetic.make_tsv(N_ROWS, seed=self.seed)) + "\n")
        labels.write_text("".join(f"{key}\t{val}\n" for key, val in synthetic.SYNTHETIC_LABELS.items()))
        featurizer = data.Featurizer(tok.FullTokenizer.hf_style(pkg.VOCAB_PATH), data.load_multimodal_labels(labels))
        rng = np.random.default_rng(self.seed)
        staged = list(data.batches_from_files([tsv], featurizer.lxmert, TRAIN_B))
        batches = []
        for i in range(TRAIN_STEPS):
            batch = dict(staged[i % len(staged)])
            batch["labels"] = rng.integers(0, 2, TRAIN_B).astype(np.int32)
            batches.append(batch)
        tc = dataclasses.replace(train.recipe_for("lxmert"), num_warmup_steps=TRAIN_STEPS // 2,
                                 num_train_steps=10 * TRAIN_STEPS)
        optim = import_module(f"{PKG}.train.optim")
        n_params = sum(v.numel() for v in optim.flatten_paths(spec.train_params(params)).values())
        log(f"lxmert train setup: {len(staged)} featurized {TRAIN_B}-pair batches, LXMERT {LX_DEPTHS}x{H}, "
            f"{n_params} trained parameters, {time.perf_counter() - t0:.1f} s")

        # step 1 with the MLM loss on the lang stream: MLM_POSITIONS masked positions a pair inside the query
        # (LXMERT's featurizer makes no MLM targets), their ids and 0/1 weights from the seed
        mlm_batch = {**batches[0],
                     "masked_lm_positions": rng.integers(1, LX_F - 1, (TRAIN_B, MLM_POSITIONS)).astype(np.int32),
                     "masked_lm_ids": rng.integers(0, cfg.bert.vocab_size, (TRAIN_B, MLM_POSITIONS)).astype(np.int32),
                     "masked_lm_weights": (rng.random((TRAIN_B, MLM_POSITIONS)) > 0.3).astype(np.float32)}
        step1 = self.step1_against_truth(spec, dataclasses.replace(tc, mlm_loss_weight=MLM_WEIGHT), params, mlm_batch,
                                         "lxmert train (MLM loss on the lang stream)", MLM_HEAD)
        bf16 = models.Precision.bf16()
        am = train.Trainer(spec, dataclasses.replace(tc, am_loss=True), precision=bf16, device=self.dev)
        state = am.init_state(params)
        grads, metrics = am.grads(state, am.to_device(batches[0]), seed=1)
        g_w = dict(zip(state.optimizer.names, grads))["logit_W"].abs().max().item()
        am_loss = metrics["loss"].item()
        log(f"lxmert train step 1 with am_loss: loss {am_loss:.6f}, max |d logit_W| {g_w:.4g}")
        if not np.isfinite(am_loss) or not g_w > 0:
            raise RuntimeError("the am_loss step gave a non-finite loss or no logit_W gradient")
        del am, state, grads

        trainer = train.Trainer(spec, tc, precision=bf16, device=self.dev)
        state = trainer.init_state(params)
        launches, steps = self.timed_train_steps(trainer, state, batches, PER_STEP_LXMERT, "lxmert train")
        log(f"launches lxmert_train ({TRAIN_STEPS} steps, summed): {json.dumps(launches)}")
        profile = self.profile_steps(trainer, state, batches[:2], "lxmert_profile.txt")
        va = trainer.eval_params(state)["bert"]["encoder"]["x_layers"]["visual_attention"]
        if not all(torch.equal(va["qkv"][n], torch.cat([va["query"][n], va["kv"][n]], dim=-1))
                   for n in ("kernel", "bias")):
            raise RuntimeError("eval_params' visual_attention/qkv is not cat(query, kv)")
        del trainer, state
        rates = {"step1": step1, "am_loss_step1": {"loss": am_loss, "max_abs_logit_W_grad": g_w}, **steps,
                 "profile": profile,
                 "device_busy_share": profile["device_busy_ms_per_step"] / steps["device_ms_per_step"]["total"]}
        log(f"lxmert train: the device busy {100 * rates['device_busy_share']:.1f}% of a step (the profiled "
            f"kernels' sum over the CUDA-event step time)")
        return launches, rates

    # ---- phase 7: the host loaders and the one-shot run -------------------------

    def one_shot(self, n_rows: int = ONE_SHOT_ROWS) -> tuple[dict[str, dict], int, dict]:
        """ImageBERT-A at full width over a testB-like TSV through each host loader (the
        per-example Python path and the native span loader): each loader's rows/s alone, its
        end-to-end pairs/s, the launches of each run and its scores, which must be bit-equal
        across the loaders; the device's rate on the same batches. Then ``cli/main.py`` as a
        subprocess (four scorers, bf16, A's weights those of the runs here) and the device
        fusion against its submission."""
        from importlib import import_module

        torch = self.torch
        pkg = import_module(PKG)
        data = import_module(f"{PKG}.data")
        fast = import_module(f"{PKG}.data.fast_pipeline")
        synthetic = import_module(f"{PKG}.data.synthetic")
        models = import_module(f"{PKG}.models")
        imagebert_a = import_module(f"{PKG}.models.imagebert_a")
        engine_mod = import_module(f"{PKG}.parallel.engine")
        checkpoint = import_module(f"{PKG}.checkpoint")
        ensemble = import_module(f"{PKG}.ensemble")
        vectorized = import_module(f"{PKG}.ensemble.vectorized")
        tok = import_module(f"{PKG}.tokenization")

        work = pkg.BUILD_DIR / "smoke" / "oneshot"
        shutil.rmtree(work, ignore_errors=True)
        work.mkdir(parents=True)
        t0 = time.perf_counter()
        tsv = work / "testB.tsv"
        tsv.write_text("\n".join(synthetic.make_testb_tsv(n_rows, seed=self.seed)) + "\n")
        labels = work / "labels.txt"
        labels.write_text("".join(f"{key}\t{val}\n" for key, val in synthetic.SYNTHETIC_LABELS.items()))
        spec = models.get_model("imagebert_a")
        cfg = spec.config
        if (cfg.hidden_size, cfg.num_hidden_layers, cfg.num_attention_heads) != (H, 12, N):
            raise RuntimeError(f"not the full-width config: {cfg} (is KMR_CONFIG_OVERRIDES set?)")
        params = spec.init_params(self.seed)
        engine = engine_mod.ScoringEngine(spec, params, device=self.dev, precision=models.Precision.bf16())
        featurizer = data.Featurizer(tok.FullTokenizer.google_style(pkg.VOCAB_PATH),
                                     data.load_multimodal_labels(labels))
        cpus = os.cpu_count() or 2
        loaders = {"python": {"use_native": False}, "native": {"use_native": True}}
        log(f"phase 7 setup: {n_rows}-row testB-like TSV ({tsv.stat().st_size / 1e6:.1f} MB) and "
            f"{cfg.num_hidden_layers}x{cfg.hidden_size} params in {time.perf_counter() - t0:.1f} s; "
            f"os.cpu_count() = {cpus}")

        def loader(cfg_, stats):
            if cfg_["use_native"]:
                return fast.native_batches_from_files([tsv], featurizer, "imagebert_a", MAIN_B, stats=stats)
            return data.batches_from_files([tsv], featurizer.imagebert_a, MAIN_B, stats=stats, prefetch=0)

        alone = {}
        for name, cfg_ in loaders.items():  # the loader alone, no model
            stats = data.PipelineStats()
            t0 = time.perf_counter()
            rows = sum(int(bt["valid"].sum()) for bt in loader(cfg_, stats))
            sec = time.perf_counter() - t0
            alone[name] = {"rows": rows, "seconds": sec, "rows_per_second": rows / sec, "parse_errors": stats.errors}
            log(f"loader {name} alone: {rows} rows in {sec:.3f} s = {rows / sec:.1f} rows/s, "
                f"{stats.errors} parse error(s)")
            if rows != n_rows or stats.errors != 1:
                raise RuntimeError(f"loader {name}: {rows} rows and {stats.errors} parse errors, expected {n_rows} and 1")

        batches = list(fast.native_batches_from_files([tsv], featurizer, "imagebert_a", MAIN_B))
        engine.score_batch(batches[0])  # warm-up
        staged = [engine.to_device(bt) for bt in batches]
        with torch.inference_mode(), packed_route():
            dev_ms = cuda_ms(torch, lambda: [imagebert_a.score(engine.params, bt, cfg, engine.precision)
                                             for bt in staged], iters=2, warmup=1)
        n_pad = len(batches) * MAIN_B
        del staged
        log(f"device: model alone {dev_ms:.3f} ms for {n_pad} padded pairs = {n_pad / dev_ms * 1e3:.1f} pairs/s")

        counted = launch_counters()
        launches, results, e2e = {}, {}, {}
        for name, cfg_ in loaders.items():
            for w in counted:
                w.launches = 0
            stats = engine_mod.ScoringStats()
            results[name] = engine.score_files([tsv], featurizer, MAIN_B, stats=stats, **cfg_)
            torch.cuda.synchronize()
            launches[f"imagebert_a_testb_{name}"] = {w.__name__: w.launches for w in counted}
            e2e[name] = {"pairs": stats.pairs, "batches": stats.batches, "seconds": stats.seconds,
                         "pairs_per_second": stats.pairs_per_second, "parse_errors": stats.pipeline.errors}
            log(f"end to end, loader {name}: {stats.pairs} pairs in {stats.batches} batches, {stats.seconds:.3f} s, "
                f"{stats.pairs_per_second:.1f} pairs/s")
            if (stats.pairs, stats.batches, stats.pipeline.errors) != (n_rows, len(batches), 1):
                raise RuntimeError(f"loader {name}: {stats.pairs} pairs, {stats.batches} batches, "
                                   f"{stats.pipeline.errors} parse errors")
        ref = results["native"]
        scores = torch.tensor([s for row in ref.values() for s in row.values()])
        if not bool(torch.isfinite(scores).all()) or len(scores) != n_rows:
            raise RuntimeError("the scores are not finite or not one a pair")
        unequal = [name for name, res in results.items() if res != ref]
        log(f"scores: the {len(results)} loaders' runs bit-equal: {not unequal}")
        if unequal:
            raise RuntimeError(f"the scores of loaders {unequal} differ from the native loader's")

        # the one-shot run: cli/main.py, A's weights those above (the other scorers the CLI's own seed-0 init)
        checkpoint.save_npz(work / "a.npz", checkpoint.params_to_jax(params))
        cmd = [sys.executable, "-m", f"{PKG}.cli.main", "--tsv", str(tsv), "--labels", str(labels),
               "--checkpoint-a", str(work / "a.npz"), "--batch-size", str(MAIN_B),
               "--expect-pairs", str(n_rows), "--workdir", str(work / "run"), "--device", "cuda"]
        env = {**os.environ, "PYTHONPATH": os.pathsep.join(filter(None, [str(REPO), os.environ.get("PYTHONPATH")]))}
        t0 = time.perf_counter()
        r = subprocess.run(cmd, capture_output=True, text=True, env=env, cwd=REPO, timeout=ONE_SHOT_TIMEOUT_S)
        wall = time.perf_counter() - t0
        for line in r.stdout.strip().splitlines():
            log(f"one-shot: {line}")
        if r.returncode != 0:
            log(r.stderr[-4000:])
            raise RuntimeError(f"cli/main.py exited {r.returncode}")
        summary = json.loads(r.stdout.strip().splitlines()[-1])
        run = work / "run"
        tables = [ensemble.load_tsv_scores(run / "testB_score_b.txt"), ensemble.load_tsv_scores(run / "testB_score_c.txt"),
                  ensemble.load_tsv_scores(run / "testB_score_a.txt"),
                  ensemble.load_csv_scores(run / "testB_score_lxmert.csv")]
        counts = [sum(len(row) for row in t.values()) for t in tables]
        if counts != [n_rows] * 4:
            raise RuntimeError(f"the score files hold {counts} pairs, expected {n_rows} each")
        if tables[2] != ref:
            raise RuntimeError("cli/main.py's ImageBERT-A scores differ from the in-process run's")
        rows = ensemble.read_submission(run / "submission.csv")
        if len(rows) != len(ref):
            raise RuntimeError(f"submission.csv has {len(rows)} queries, the TSV {len(ref)}")
        t0 = time.perf_counter()
        device_rows = vectorized.build_submission_vectorized(*tables, device=self.dev)
        fusion_device_s = time.perf_counter() - t0
        if device_rows != rows:
            raise RuntimeError("the device fusion's rows differ from the dict path's submission.csv")
        _, _, _, pcodes, n_products, merged = vectorized.tables_to_arrays(*tables)
        _, keep = vectorized.fusion_filter_device(torch.from_numpy(merged).to(self.dev),
                                                torch.from_numpy(pcodes).to(self.dev), n_products)
        kept = int(keep.sum())
        log(f"fusion: {len(rows)} queries, the dedup filter kept {kept} of {n_rows} pairs ({kept / n_rows:.4f}) over "
            f"{n_products} products; device fusion {fusion_device_s:.3f} s, the same rows as submission.csv")
        if not 0 < kept < n_rows:
            raise RuntimeError(f"the dedup filter kept {kept} of {n_rows} pairs")
        for model, b in summary["breakdown"].items():
            log(f"one-shot {model}: wall {b['wall_s']} s, engine {b.get('engine_s')} s, loader {b.get('loader')}")
        log(f"one-shot total: {summary['total_wall_s']} s ({wall:.2f} s with the process)")
        rates = {"rows": n_rows, "tsv_bytes": tsv.stat().st_size, "cpu_count": cpus,
                 "loader_alone": alone, "end_to_end": e2e, "device_ms": dev_ms, "device_pairs": n_pad,
                 "device_pairs_per_second": n_pad / dev_ms * 1e3, "one_shot": summary, "one_shot_wall_s": wall,
                 "queries": len(rows), "kept_pairs": kept, "products": n_products,
                 "fusion_device_s": fusion_device_s}
        return launches, len(batches), rates

    @staticmethod
    def ranking_agreement(batches, kern, plain) -> tuple[int, int]:
        keys = [(q, p) for bt in batches for q, p, ok in zip(bt["query_id"], bt["product_id"], bt["valid"]) if ok]
        by_q: dict = {}
        for i, (q, p) in enumerate(keys):
            by_q.setdefault(int(q), []).append(i)
        same = sum(
            sorted(ix, key=lambda i: -kern[i].item()) == sorted(ix, key=lambda i: -plain[i].item())
            for ix in by_q.values()
        )
        return same, len(by_q)

    # ---- phase 8: checkpoint import and distillation ------------------------------

    def reference_checkpoints(self, work) -> dict:
        """The reference's three checkpoint forms at full width, from the seed's weights, each beside an npz
        tree of the same weights (``tests/torch_tf_bundle_writer.py``, numpy only): ImageBERT-A a TF1 bundle
        (its MLM head included); ImageBERT-B a TF1 bundle with snappy index blocks, its raw variables from the
        seed and ``/ExponentialMovingAverage`` shadows from the next seed (the npz holds the shadows, and
        ``b_raw.npz`` the raw variables); LXMERT 9/5/5 a ``BEST.pth`` state dict (``module.`` prefixes, the
        KDDModel's heads, an NSP head from the seed) -> {model: (reference path, npz path, the reference
        files' bytes)}."""
        from importlib import import_module

        import numpy as np

        torch = self.torch
        sys.path.insert(0, str(REPO / "tests"))
        writer = import_module("torch_tf_bundle_writer")
        models = import_module(f"{PKG}.models")
        checkpoint = import_module(f"{PKG}.checkpoint")

        def tree(name, seed):
            return checkpoint.params_to_jax(models.get_model(name).init_params(seed))

        out = {}
        a = tree("imagebert_a", self.seed)
        writer.write_tf_bundle(work / "ImageBertKDD.ckpt-85002", writer.imagebert_a_tf_names(a), tensor_crcs=False)
        checkpoint.save_npz(work / "a.npz", a)
        out["imagebert_a"] = work / "ImageBertKDD.ckpt-85002", work / "a.npz"
        raw, shadows = tree("imagebert_b", self.seed), tree("imagebert_b", self.seed + 1)
        b_prefix = work / "model_attention_kdd_am_word_match_finetune_valid.ckpt-251"
        writer.write_tf_bundle(b_prefix, writer.with_ema_shadows(writer.imagebert_b_tf_names(raw),
                                                                 writer.imagebert_b_tf_names(shadows)),
                               snappy=True, tensor_crcs=False)
        checkpoint.save_npz(work / "b.npz", shadows)
        checkpoint.save_npz(work / "b_raw.npz", raw)
        out["imagebert_b"] = out["imagebert_c"] = b_prefix, work / "b.npz"
        lx = tree("lxmert", self.seed)
        rng = np.random.default_rng(self.seed)
        lx["cls"]["seq_relationship"] = {"kernel": (0.02 * rng.standard_normal((H, 2))).astype(np.float32),
                                         "bias": np.zeros(2, np.float32)}
        torch.save({k: torch.from_numpy(v) for k, v in writer.lxmert_torch_names(lx).items()}, work / "BEST.pth")
        checkpoint.save_npz(work / "lxmert.npz", lx)
        out["lxmert"] = work / "BEST.pth", work / "lxmert.npz"
        return {name: (ref, npz, sum(p.stat().st_size for p in work.glob(ref.name + "*")))
                for name, (ref, npz) in out.items()}

    def import_and_distil(self) -> tuple[dict[str, dict], dict]:
        """Phase 8: the reference's checkpoint forms (``reference_checkpoints``) read by ``load_checkpoint``,
        each import's seconds and bytes, its params equal to the npz route's, and ``cli/score.py`` on each
        (A, B through its EMA shadows, C, LXMERT) bit-equal to the npz route's scores, B's unlike its raw
        variables'. Then distillation on the card: ``cli/distill.py`` of a 4-layer ImageBERT-B student from
        the live 12-layer teacher (the B bundle), ``--init-from-teacher``, TRAIN_STEPS steps at TRAIN_B and a
        valid pass; the teacher's ms a batch, the student's step ms, pairs/s on the device and end to end; the
        student's ``best.npz`` through ``cli/score.py`` (its shape from the sidecar) equal to ``ScoringEngine``
        on the same params, its rank fidelity to the teacher (``cli/score_fidelity.py``) and both scorers'
        device pairs/s; ``cli/train.py --layers 4 --init-from <A npz> --distill-from <A bundle>`` on phase 5's
        packed shards; ``cli/distill.py`` of a 3/2/2 LXMERT student from the ``BEST.pth`` teacher; the step-1
        gradients of the B and A students against the f32 truth (phase 5's rule) -> (each counted run's
        launches, held exact; the phase's numbers)."""
        from importlib import import_module

        import numpy as np

        torch = self.torch
        pkg = import_module(PKG)
        models = import_module(f"{PKG}.models")
        data = import_module(f"{PKG}.data")
        pipeline = import_module(f"{PKG}.data.pipeline")
        tok = import_module(f"{PKG}.tokenization")
        checkpoint = import_module(f"{PKG}.checkpoint")
        train = import_module(f"{PKG}.train")
        engine_mod = import_module(f"{PKG}.parallel.engine")
        attention = import_module(f"{PKG}.ops.attention")
        ensemble = import_module(f"{PKG}.ensemble")
        score_cli = import_module(f"{PKG}.cli.score")
        distill_cli = import_module(f"{PKG}.cli.distill")
        train_cli = import_module(f"{PKG}.cli.train")
        fidelity = import_module(f"{PKG}.cli.score_fidelity")

        t_phase = time.perf_counter()
        work = pkg.BUILD_DIR / "smoke" / "distill"
        shutil.rmtree(work, ignore_errors=True)
        work.mkdir(parents=True)
        tsv, labels, _ = self.train_data(work)
        valid_tsv, answers = self.valid_data(work)
        t0 = time.perf_counter()
        ckpts = self.reference_checkpoints(work)
        log(f"phase 8 setup: the reference's checkpoint forms written at full width in "
            f"{time.perf_counter() - t0:.1f} s: " + ", ".join(f"{m} {ref.name} {nbytes} bytes"
                                                           for m, (ref, _, nbytes) in ckpts.items()))
        runs, rates = {}, {"card": nvidia_smi()}
        n_score = -(-N_ROWS // MAIN_B)

        def counted(path, expected, fn):
            return counted_run(torch, runs, path, {k: expected.get(k, 0) for k in expected_launches(0, {})}, fn)

        def scores_of(path) -> dict:
            load = ensemble.load_csv_scores if str(path).endswith(".csv") else ensemble.load_tsv_scores
            return {(q, p): s for q, row in load(path).items() for p, s in row.items()}

        # 1-2: each import against the npz route, its params and its scores through cli/score.py
        imports, scored = {}, {}
        for model in ("imagebert_a", "imagebert_b", "imagebert_c", "lxmert"):
            ref, npz, nbytes = ckpts[model]
            spec = models.get_model(model)
            timed = {}
            for kind, path in (("reference", ref), ("npz", npz)):
                t0 = time.perf_counter()
                timed[kind] = checkpoint.flatten_tree(checkpoint.load_checkpoint(model, path, spec))
                timed[f"{kind}_s"] = time.perf_counter() - t0
            differ = [k for k in timed["npz"] if not np.array_equal(timed["reference"][k], timed["npz"][k])]
            if timed["reference"].keys() != timed["npz"].keys() or differ:
                raise RuntimeError(f"{model}: the imported params differ from the npz route's: {differ[:5]}")
            imports[model] = {"format": ref.name, "bytes": nbytes, "import_s": timed["reference_s"],
                              "npz_bytes": npz.stat().st_size, "npz_s": timed["npz_s"], "leaves": len(timed["npz"])}
            del timed
            suffix = ".csv" if model == "lxmert" else ".tsv"
            for kind, path in (("reference", ref), ("npz", npz)):
                out = work / f"scores_{model}_{kind}{suffix}"
                counted(f"import_{model}_{kind}", expected_launches(n_score, PER_BATCH[model]),
                        lambda: score_cli.main(["--model", model, "--tsv", str(tsv), "--labels", str(labels),
                                                "--checkpoint", str(path), "--out", str(out),
                                                "--expect-pairs", str(N_ROWS)]))
                scored[(model, kind)] = scores_of(out)
            got, want = scored[(model, "reference")], scored[(model, "npz")]
            if got != want or len(got) != N_ROWS or not np.isfinite(list(got.values())).all():
                raise RuntimeError(f"{model}: scores through {ref.name} differ from the npz route's "
                                   f"({sum(got.get(k) != v for k, v in want.items())} of {len(want)} pairs)")
            log(f"import {model}: {ref.name} ({nbytes} bytes) read in {imports[model]['import_s']:.3f} s, the npz "
                f"({imports[model]['npz_bytes']} bytes) in {imports[model]['npz_s']:.3f} s; params and "
                f"{len(got)} scores bit-equal to the npz route's")
        raw = work / "scores_imagebert_b_raw.tsv"
        counted("import_imagebert_b_raw", expected_launches(n_score, PER_BATCH["imagebert_b"]),
                lambda: score_cli.main(["--model", "imagebert_b", "--tsv", str(tsv), "--labels", str(labels),
                                        "--checkpoint", str(work / "b_raw.npz"), "--out", str(raw)]))
        shadow_scores, raw_scores = scored[("imagebert_b", "reference")], scores_of(raw)
        moved = sum(shadow_scores[k] != raw_scores[k] for k in raw_scores)
        if moved < N_ROWS // 2:
            raise RuntimeError(f"B's EMA shadows were not read: {moved} of {N_ROWS} scores differ from the raw "
                               "variables'")
        imports["imagebert_b"]["scores_unlike_the_raw_variables"] = moved
        log(f"import imagebert_b: the EMA shadows read ({moved} of {N_ROWS} scores differ from the raw variables')")
        rates["imports"] = imports

        # 3: live distillation of a 4-layer B student from the 12-layer teacher bundle
        b_prefix = ckpts["imagebert_b"][0]
        student_b = models.get_model("imagebert_b", overrides={"num_hidden_layers": DISTIL_LAYERS})
        teacher_b = models.get_model("imagebert_b")
        n_distil = -(-N_ROWS // TRAIN_B)
        n_valid = -(-VALID_ROWS // TRAIN_B)
        run_b = work / "distill_b"
        teacher_per, student_per = scoring_launches("imagebert_b", 12), scoring_launches("imagebert_b", DISTIL_LAYERS)
        expected = sum_launches((TRAIN_STEPS, teacher_per), (TRAIN_STEPS, train_launches("imagebert_b", DISTIL_LAYERS)),
                                (n_valid, student_per), (n_distil, teacher_per), (n_distil, student_per))
        report_b = counted("distill_imagebert_b", expected, lambda: distill_cli.main([
            "--model", "imagebert_b", "--student-layers", str(DISTIL_LAYERS), "--tsv", str(tsv), "--labels",
            str(labels), "--teacher-checkpoint", str(b_prefix), "--init-from-teacher", "--batch-size", str(TRAIN_B),
            "--steps", str(TRAIN_STEPS), "--out", str(run_b), "--valid-tsv", str(valid_tsv), "--answers",
            str(answers), "--checkpoint-every", "1000", "--seed", str(self.seed)]))
        lines = [json.loads(line) for line in (run_b / "metrics.jsonl").read_text().splitlines()]
        if (not np.isfinite([lines[0]["distill_loss"], report_b["distill_mae"]]).all()
                or not (run_b / "best.npz").exists() or report_b["pairs"] != TRAIN_STEPS * TRAIN_B):
            raise RuntimeError(f"the B distillation run: {lines[:2]}, {report_b}")

        # the teacher's forward and the student's step, staged: the student from the teacher's layers
        fz = data.Featurizer(tok.FullTokenizer.google_style(pkg.VOCAB_PATH), data.load_multimodal_labels(labels))
        batches = list(pipeline.iter_batches(tsv.read_text().splitlines(), fz.imagebert_b, TRAIN_B))
        teacher_params = checkpoint.load_checkpoint("imagebert_b", b_prefix, teacher_b)
        teacher = train.LiveTeacher(teacher_b, teacher_params)
        for b in batches[:2]:
            teacher.attach(b)  # warm-up
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda.synchronize()
        ev[0].record()
        attached = [teacher.attach(b) for b in batches]
        ev[1].record()
        torch.cuda.synchronize()
        teacher_ms = ev[0].elapsed_time(ev[1]) / len(batches)
        # the teacher's forward alone, on batches staged on the device (attach also copies the features)
        staged = [teacher.engine.to_device({**b, "labels": np.ones_like(b["labels"])}) for b in batches]

        def teacher_forward():
            with torch.inference_mode(), attention.attention_backend(teacher.engine.attention_backend):
                for f in staged:
                    teacher_b.apply(teacher.engine.params, f, teacher_b.config, teacher.engine.precision)

        teacher_forward_ms = cuda_ms(torch, teacher_forward, iters=5, warmup=1) / len(staged)
        del staged
        tc_b =dataclasses.replace(train.recipe_for("imagebert_b"), distill_weight=1.0, distill_temperature=2.0,
                                   hard_loss_weight=0.0)
        mapped = train.init_student_from_teacher(checkpoint.params_to_jax(student_b.init_params(self.seed)),
                                                 checkpoint.params_to_jax(teacher_params))
        student_params = student_b.from_jax(checkpoint.params_from_jax(mapped))
        step1_b = self.step1_against_truth(student_b, tc_b, student_params, attached[0], "imagebert_b student (distil)")
        trainer = train.Trainer(student_b, tc_b, precision=models.Precision.bf16(), device=self.dev)
        state = trainer.init_state(student_params)
        _, steps_b = self.timed_train_steps(trainer, state, attached, train_launches("imagebert_b", DISTIL_LAYERS),
                                            "imagebert_b student (distil)")
        del trainer, state, attached
        step_ms = steps_b["device_ms_per_step"]["total"]
        distil = {"teacher_ms_per_batch": teacher_ms, "teacher_forward_ms_per_batch_staged": teacher_forward_ms,
                  "student_step_ms": steps_b["device_ms_per_step"],
                  "device_pairs_per_second": TRAIN_B / (teacher_ms + step_ms) * 1e3,
                  "end_to_end_pairs_per_second": report_b["pairs_per_second"], "cli": report_b, "step1": step1_b,
                  "first_metrics": lines[0]}
        log(f"distil imagebert_b 12 -> {DISTIL_LAYERS} layers at B={TRAIN_B}: the teacher {teacher_ms:.3f} ms a batch "
            f"(its forward on staged batches {teacher_forward_ms:.3f} ms), "
            f"the student's step {step_ms:.3f} ms (device) = {distil['device_pairs_per_second']:.1f} pairs/s on the "
            f"device, {report_b['pairs_per_second']:.1f} pairs/s end to end through cli/distill.py "
            f"({report_b['seconds']:.3f} s for {report_b['pairs']} pairs; checkpoints {report_b['checkpoint_seconds']:.3f} s, "
            f"valid {report_b['valid_seconds']:.3f} s apart); step 0 distill loss "
            f"{lines[0]['distill_loss']:.5f}, valid {json.dumps(report_b['valid'])}")

        # the student's best.npz through cli/score.py (its shape from the sidecar) against ScoringEngine
        student_scores = work / "scores_student_b.tsv"
        counted("distill_imagebert_b_student_score", expected_launches(n_score, scoring_launches("imagebert_b",
                                                                                                   DISTIL_LAYERS)),
                lambda: score_cli.main(["--model", "imagebert_b", "--tsv", str(tsv), "--labels", str(labels),
                                        "--checkpoint", str(run_b / "best.npz"), "--out", str(student_scores)]))
        best = student_b.from_jax(checkpoint.params_from_jax(checkpoint.load_npz(run_b / "best.npz")))
        engine = engine_mod.ScoringEngine(student_b, best)
        want = engine.score_files([tsv], fz, MAIN_B)
        got = scores_of(student_scores)
        if got != {(q, p): s for q, row in want.items() for p, s in row.items()}:
            raise RuntimeError("the student's best.npz through cli/score.py differs from ScoringEngine on its params")
        fid = fidelity.main(["--reference", str(work / "scores_imagebert_b_reference.tsv"), "--candidate",
                             str(student_scores)])
        distil["fidelity_vs_teacher"] = fid
        teacher_engine = teacher.engine
        device_rates = {}
        stage = list(pipeline.iter_batches(tsv.read_text().splitlines(), fz.imagebert_b, MAIN_B))
        for name, eng, spec in (("teacher_12", teacher_engine, teacher_b), (f"student_{DISTIL_LAYERS}", engine,
                                                                            student_b)):
            feats = [eng.to_device(b) for b in stage]

            def run_all(eng=eng, spec=spec, feats=feats):
                with torch.inference_mode(), attention.attention_backend(eng.attention_backend):
                    for f in feats:
                        spec.apply(eng.params, f, spec.config, eng.precision)

            ms = cuda_ms(torch, run_all, iters=5, warmup=1)
            device_rates[name] = {"ms_per_batch": ms / len(stage),
                                  "pairs_per_second": len(stage) * MAIN_B / ms * 1e3}
        distil["scoring_device"] = device_rates
        log(f"distil imagebert_b: the student's best.npz through cli/score.py equals ScoringEngine on its params; "
            f"fidelity to the teacher {json.dumps(fid)}; device scoring at B={MAIN_B}: "
            f"{json.dumps(device_rates)}")
        del teacher, teacher_engine, teacher_params, engine
        rates["distill_imagebert_b"] = distil

        # 4: ImageBERT-A through cli/train.py: 4 layers from the 12-layer npz, a live teacher from the bundle
        packed = pkg.BUILD_DIR / "smoke" / "train" / "packed_a"
        a_prefix, a_npz, _ = ckpts["imagebert_a"]
        expected = sum_launches((A_DISTIL_STEPS, scoring_launches("imagebert_a", 12)),
                                (A_DISTIL_STEPS, train_launches("imagebert_a", DISTIL_LAYERS)))
        report_a = counted("train_imagebert_a_distill_from", expected, lambda: train_cli.main([
            "--model", "imagebert_a", "--packed-dir", str(packed), "--labels", str(labels), "--steps",
            str(A_DISTIL_STEPS), "--batch-size", str(TRAIN_B), "--out", str(work / "train_a"), "--layers",
            str(DISTIL_LAYERS), "--init-from", str(a_npz), "--distill-from", str(a_prefix), "--warmup-steps", "2",
            "--total-steps", "50", "--checkpoint-every", "1000", "--seed", str(self.seed)]))
        first = json.loads((work / "train_a" / "metrics.jsonl").read_text().splitlines()[0])
        sidecar = json.loads((work / "train_a" / "student_config.json").read_text())
        if not np.isfinite([first["loss"], first["distill_loss"]]).all() or sidecar["overrides"] != {
                "num_hidden_layers": DISTIL_LAYERS}:
            raise RuntimeError(f"cli/train.py --distill-from: first metrics {first}, sidecar {sidecar}")
        student_a = models.get_model("imagebert_a", overrides={"num_hidden_layers": DISTIL_LAYERS})
        teacher_a_spec = models.get_model("imagebert_a")
        teacher_a = train.LiveTeacher(teacher_a_spec, checkpoint.load_checkpoint("imagebert_a", a_prefix,
                                                                                 teacher_a_spec))
        batch_a = teacher_a.attach(next(iter(data.PackedDataset(packed).batches(TRAIN_B, epochs=None,
                                                                                 seed=self.seed))))
        mapped = train.init_student_from_teacher(checkpoint.params_to_jax(student_a.init_params(self.seed)),
                                                 checkpoint.load_npz(a_npz))
        tc_a = dataclasses.replace(train.recipe_for("imagebert_a"), distill_weight=1.0, distill_temperature=2.0,
                                   hard_loss_weight=0.5, num_warmup_steps=2, num_train_steps=50)
        step1_a = self.step1_against_truth(student_a, tc_a, student_a.from_jax(checkpoint.params_from_jax(mapped)),
                                           batch_a, "imagebert_a student (--distill-from)")
        del teacher_a, batch_a
        rates["train_imagebert_a_distill_from"] = {"cli": report_a, "first_metrics": first, "step1": step1_a}
        log(f"cli/train.py --layers {DISTIL_LAYERS} --init-from <A npz> --distill-from <A bundle>: "
            f"{report_a['pairs']} pairs in {report_a['seconds']:.3f} s = {report_a['pairs_per_second']:.1f} pairs/s "
            f"(the live teacher's forward in every step); step 0 loss {first['loss']:.5f}, distill loss "
            f"{first['distill_loss']:.5f}")

        # 5: a 3/2/2 LXMERT student from the BEST.pth teacher
        lx_teacher = scoring_launches("lxmert", LX_DEPTHS)
        lx_student = scoring_launches("lxmert", LX_STUDENT)
        expected = sum_launches((LX_DISTIL_STEPS, lx_teacher), (LX_DISTIL_STEPS, train_launches("lxmert", LX_STUDENT)),
                                (n_distil, lx_teacher), (n_distil, lx_student))
        overrides = dict(zip(("l_layers", "r_layers", "x_layers"), LX_STUDENT))
        report_lx = counted("distill_lxmert", expected, lambda: distill_cli.main([
            "--model", "lxmert", "--student-overrides", json.dumps(overrides), "--tsv", str(tsv), "--labels",
            str(labels), "--teacher-checkpoint", str(ckpts["lxmert"][0]), "--init-from-teacher", "--batch-size",
            str(TRAIN_B), "--steps", str(LX_DISTIL_STEPS), "--out", str(work / "distill_lx"), "--checkpoint-every",
            "1000", "--seed", str(self.seed)]))
        if not np.isfinite([report_lx["distill_mae"], report_lx["distill_tau"]]).all():
            raise RuntimeError(f"the LXMERT distillation run: {report_lx}")
        rates["distill_lxmert"] = report_lx
        log(f"distil lxmert 9/5/5 -> {'/'.join(map(str, LX_STUDENT))} (l/r/x) from BEST.pth: {report_lx['pairs']} "
            f"pairs in {report_lx['seconds']:.3f} s = {report_lx['pairs_per_second']:.1f} pairs/s end to end; tau "
            f"{report_lx['distill_tau']:.4f}, MAE {report_lx['distill_mae']:.4f}")
        shutil.rmtree(work)  # ~4 GB of checkpoints and runs
        rates["phase_seconds"] = time.perf_counter() - t_phase
        log(f"phase 8: {rates['phase_seconds']:.1f} s")
        return runs, rates

    # ---- phase 9: two-tower recall ---------------------------------------------------

    def tower_batches(self, fz, exs) -> list[dict]:
        """The examples in ImageBERT-B's layout, in batches of MAIN_B (the tail padded)."""
        from importlib import import_module

        data = import_module(f"{PKG}.data")
        b = MAIN_B
        return [data.pad_batch(data.stack_examples([fz.imagebert_b(ex) for ex in exs[i:i + b]]), b)
                for i in range(0, len(exs), b)]

    def tower_embeddings(self, spec, params, fz, exs: dict) -> tuple[dict, dict]:
        """Part 1 of phase 9: both towers at B=MAIN_B over the products and the queries of ``exs`` (side ->
        examples), through ``TowerEngine`` on the default route and with KMR_FUSED_LAYER=1 (counted, exact),
        then on the kernel route, the plain bf16 route and the f32 truth (plain blocks in f32) on the same staged
        batches: the embeddings and the cosines of the TSV's pairs, the kernels within SCORE_BAND or
        B_KERNEL_OVER_PLAIN x the plain route's error of the truth, whichever is larger -> (the counted runs'
        launches, the numbers)."""
        from importlib import import_module

        torch = self.torch
        models = import_module(f"{PKG}.models")
        two_tower = import_module(f"{PKG}.models.two_tower")
        engine_mod = import_module(f"{PKG}.parallel.engine")
        checkpoint = import_module(f"{PKG}.checkpoint")

        bf16 = models.Precision.bf16()
        engine = engine_mod.TowerEngine(spec, params, device=self.dev, precision=bf16)
        runs, out = {}, {}
        t0 = time.perf_counter()
        batches = {side: self.tower_batches(fz, exs[side]) for side in ("product", "query")}
        out["featurize_s"] = time.perf_counter() - t0
        n = {side: len(exs[side]) for side in batches}
        for fused in (False, True):  # warm-up of both routes
            with route(KMR_FUSED_LAYER=fused):
                for side, bts in batches.items():
                    engine.embed(side, bts[0])
        emb, e2e = {}, {}
        for suffix, fused in (("", False), ("_fused_layer", True)):
            with route(KMR_FUSED_LAYER=fused):
                for side, bts in batches.items():
                    per = tower_fused_launches(side) if fused else tower_launches(side)
                    t0 = time.perf_counter()
                    emb[side + suffix] = counted_run(
                        torch, runs, f"two_tower_{side}{suffix}", expected_launches(len(bts), per),
                        lambda bts=bts, side=side: torch.cat([engine.embed(side, b) for b in bts]).cpu())[:n[side]]
                    e2e[side + suffix] = n[side] / (time.perf_counter() - t0)
        staged = {side: [engine.side_to_device(side, b) for b in bts] for side, bts in batches.items()}
        params32 = checkpoint.tree_to(params, self.dev)
        f32 = models.Precision.f32()
        routes = {"kernel": (engine.params, bf16, models.KERNEL_BLOCKS),
                  "plain_bf16": (engine.params, bf16, models.PLAIN_BLOCKS),
                  "f32_truth": (params32, f32, models.PLAIN_BLOCKS)}
        res, dev_ms = {}, {}
        with torch.inference_mode(), packed_route():
            for side in batches:
                def run(p, prec, blocks, side=side):
                    return torch.cat([two_tower.SIDES[side][0](p, f, spec.config, prec, blocks) for f in staged[side]])

                for name, args in routes.items():
                    res[(side, name)] = run(*args).cpu()[:n[side]]
                dev_ms[side] = cuda_ms(torch, lambda run=run: run(*routes["kernel"]), iters=3, warmup=1)
                dev_ms[side + "_plain_bf16"] = cuda_ms(torch, lambda run=run: run(*routes["plain_bf16"]), iters=1,
                                                       warmup=1)
        del params32, staged
        for side in batches:
            if not torch.equal(res[(side, "kernel")], emb[side]):
                raise RuntimeError(f"the {side} tower through TowerEngine differs from its staged kernel route")
        # the cosines of the TSV's (query, product) pairs
        rows = {side: {key: i for i, key in enumerate(keys)} for side, keys in exs["keys"].items()}
        qi = torch.tensor([rows["query"][q] for q, _ in exs["pairs"]])
        pi = torch.tensor([rows["product"][p] for _, p in exs["pairs"]])

        def cos(q, p):
            return (q[qi] * p[pi]).sum(dim=-1)

        errs = {}
        truth_cos = cos(res[("query", "f32_truth")], res[("product", "f32_truth")])
        for name in ("kernel", "plain_bf16", "fused_layer"):
            get = (lambda side: emb[side + "_fused_layer"]) if name == "fused_layer" else (
                lambda side, name=name: res[(side, name)])
            for side in batches:
                errs[f"{side}_emb_{name}"] = (get(side) - res[(side, "f32_truth")]).abs().max().item()
            errs[f"cos_{name}"] = (cos(get("query"), get("product")) - truth_cos).abs().max().item()
        for key in ("product_emb", "query_emb", "cos"):
            for name in ("kernel", "fused_layer"):
                band = max(SCORE_BAND, B_KERNEL_OVER_PLAIN * errs[f"{key}_plain_bf16"])
                if not errs[f"{key}_{name}"] <= band:
                    raise RuntimeError(f"two_tower {key} on the {name} route: max |d| {errs[f'{key}_{name}']:.6g} "
                                       f"vs the f32 truth, band {band:.6g}")
        fused_equal = {side: bool(torch.equal(emb[side], emb[side + "_fused_layer"])) for side in batches}
        for side in batches:
            if not (bool(torch.isfinite(emb[side]).all()) and emb[side].shape == (n[side], spec.config.embed_dim)):
                raise RuntimeError(f"the {side} embeddings are not finite or of the wrong shape")
        out.update({"products": n["product"], "queries": n["query"], "pairs": len(exs["pairs"]),
                    "max_abs_err_vs_f32_truth": errs, "fused_layer_bit_equal": fused_equal,
                    "device_ms": dev_ms, "end_to_end_per_second": e2e,
                    "device_per_second": {side: len(batches[side]) * MAIN_B / dev_ms[side] * 1e3 for side in batches}})
        log(f"two_tower at B={MAIN_B}: {n['product']} products, {n['query']} queries, {len(exs['pairs'])} pairs; max "
            f"|d| vs the f32 truth (kernels, plain bf16, fused layer): " + ", ".join(
                f"{key} {errs[key + '_kernel']:.4g} / {errs[key + '_plain_bf16']:.4g} / {errs[key + '_fused_layer']:.4g}"
                for key in ("product_emb", "query_emb", "cos"))
            + f" (band max({SCORE_BAND:g}, {B_KERNEL_OVER_PLAIN:g} x plain)); the fused layer bit-equal to the two "
            f"blocks: {fused_equal}; device {json.dumps(out['device_per_second'])} rows/s (B={MAIN_B}, padded), end "
            f"to end {json.dumps(e2e)} rows/s")
        return runs, out

    def tower_block_rows(self) -> dict[str, dict]:
        """The towers' launches timed alone at B=MAIN_B, each held against its plain version once more: the
        attention and FFN blocks (tanh GELU) and the fused layer at S=20 and S=10 under the towers' key masks
        (lengths 1..S, every fourth pair's keys all masked), with the device's time alone, each beside its library
        yardstick (``block_libraries``), and the label conv's and a projection's gemm ("f32")."""
        from importlib import import_module

        k = import_module(f"{PKG}.ops.kernels")
        ab = import_module(f"{PKG}.ops.attention_block")
        fb = import_module(f"{PKG}.ops.ffn_block")
        el = import_module(f"{PKG}.ops.encoder_layer")
        att = import_module(f"{PKG}.ops.attention")
        torch = self.torch
        b, rows = MAIN_B, {}
        lw = self.layer_args(self.layer_weights())
        aw, fw = lw[:6], lw[6:]
        for s in (TOWER_Q, TOWER_P):
            m = b * s
            x = self.randn(b, s, H, dtype=torch.bfloat16)
            lengths = torch.randint(1, s + 1, (b,), generator=self.gen)
            lengths[::4] = 0
            bias = att.mask_to_bias((torch.arange(s)[None] < lengths[:, None]).float()).to(self.dev)
            attn_flops = 2.0 * m * H * 3 * H + 4.0 * b * N * s * s * 64 + 2.0 * m * H * H
            attn_lib, ffn_lib, layer_lib = self.block_libraries(x, aw, fw, bias)
            self.time_row(rows, f"attention_block S={s} tower", "attention_block",
                          lambda x=x, bias=bias: ab.attention_block(x, *aw, N, bias),
                          lambda x=x, bias=bias: ab.attention_block_plain(x, *aw, N, bias), attn_lib,
                          2 * m * H * 2 + nbytes_of((bias, *aw)), attn_flops, PEAK_BF16_FLOPS, device=True)
            self.time_row(rows, f"ffn_block S={s} tower", "ffn_block", lambda x=x: fb.ffn_block(x, *fw),
                          lambda x=x: fb.ffn_block_plain(x, *fw), ffn_lib, 2 * m * H * 2 + nbytes_of(fw),
                          4.0 * m * H * I, PEAK_BF16_FLOPS, device=True)
            self.time_row(rows, f"encoder_layer S={s} tower", "encoder_layer",
                          lambda x=x, bias=bias: el.encoder_layer(x, *lw, N, bias),
                          lambda x=x, bias=bias: el.encoder_layer_plain(x, *lw, N, bias), layer_lib,
                          2 * m * H * 2 + nbytes_of((bias, *lw)), attn_flops + 4.0 * m * H * I, PEAK_BF16_FLOPS,
                          device=True)
        band, cbias = self.label_band()
        a = self.randn(b * 10, 8 * H, dtype=torch.bfloat16)
        self.time_row(rows, "gemm_bf16 label conv [f32] tower", "gemm_bf16", lambda: k.gemm(a, band, cbias, "f32"),
                      lambda: k.gemm_plain(a, band, cbias, "f32"), lambda: torch.matmul(a, band),
                      nbytes_of((a, band, cbias)) + b * 10 * 8 * H * 4, 2.0 * b * 10 * H * H * CONV_BLOCKS,
                      PEAK_BF16_FLOPS, F32_OUT_BAND, 0.0)
        pa = self.randn(b, H, dtype=torch.bfloat16)
        pw, pb = self.randn(H, TOWER_D, scale=H ** -0.5, dtype=torch.bfloat16), self.randn(TOWER_D, scale=0.02)
        self.time_row(rows, "gemm_bf16 projection [f32] tower", "gemm_bf16", lambda: k.gemm(pa, pw, pb, "f32"),
                      lambda: k.gemm_plain(pa, pw, pb, "f32"), lambda: torch.matmul(pa, pw),
                      nbytes_of((pa, pw, pb)) + b * TOWER_D * 4, 2.0 * b * H * TOWER_D, PEAK_BF16_FLOPS,
                      F32_OUT_BAND, 0.0, device=True)
        if self.failures:
            raise RuntimeError(f"the towers' launches disagree with their plain versions: {self.failures}")
        return rows

    def block_libraries(self, x, aw, fw, bias):
        """The library yardsticks of the attention block, the FFN block and the layer (their sum) on x [B, S, H]
        bf16 under the key mask ``bias`` [B, S]: the QKV and out-proj products (``torch.matmul`` of the bf16
        operands), SDPA on its fastest fused backend with the same additive key mask, ``F.layer_norm``; the up
        product, ``F.gelu(approximate="tanh")``, the down product, ``F.layer_norm``."""
        torch = self.torch
        F = torch.nn.functional
        wqkv, bqkv, wo, bo, g1, b1 = aw
        w1, c1, w2, c2, g2, b2 = fw
        b, s, _ = x.shape
        x2d = x.reshape(b * s, H)
        mask = bias.to(torch.bfloat16)[:, None, None, :]
        heads = (torch.matmul(x2d, wqkv) + bqkv).to(torch.bfloat16).reshape(b, s, 3, N, 64).permute(2, 0, 3, 1, 4)
        sdpa = sdpa_library(torch, heads[0], heads[1], heads[2], mask)

        def attn(x2d=x2d):
            qkv = (torch.matmul(x2d, wqkv) + bqkv).to(torch.bfloat16).reshape(b, s, 3, N, 64).permute(2, 0, 3, 1, 4)
            ctx = F.scaled_dot_product_attention(qkv[0], qkv[1], qkv[2], attn_mask=mask)
            y = torch.matmul(ctx.transpose(1, 2).reshape(b * s, H), wo) + bo + x2d
            return F.layer_norm(y.float(), (H,), g1, b1, 1e-12).to(torch.bfloat16)

        def ffn(x2d=x2d):
            hmid = F.gelu(torch.matmul(x2d, w1) + c1, approximate="tanh").to(torch.bfloat16)
            y = torch.matmul(hmid, w2) + c2 + x2d
            return F.layer_norm(y.float(), (H,), g2, b2, 1e-12).to(torch.bfloat16)

        return with_backends(attn, sdpa), ffn, with_backends(lambda: ffn(attn()), sdpa)

    def two_tower(self) -> tuple[dict[str, dict], dict]:
        """Phase 9: two-tower recall at full width (4 + 4 layers of 768, embed_dim 128) from the seed's weights:
        the towers at B=MAIN_B over a testB-like TSV (``tower_embeddings``); training at TRAIN_B (step 1 against
        the f32 truth, TRAIN_STEPS timed steps, TOWER_CLI_STEPS steps and a valid pass through ``cli/train.py``);
        ``cli/recall.py build --packed --store-features`` of the TSV and the planted valid set with the trained
        ``step_<N>.npz``, ``query``, ``curve`` and ``cli/cascade.py`` over the packed catalog (ImageBERT-B
        reranking), its rows held to a ``ScoringEngine`` pass over the recalled candidates; the 3M-product recall
        (``cli/bench_recall_3m.py``, its float64 oracle); both towers exported, reloaded and held to the live
        embedder -> (each counted run's launches, the phase's numbers)."""
        from importlib import import_module

        import numpy as np

        torch = self.torch
        pkg = import_module(PKG)
        models = import_module(f"{PKG}.models")
        data = import_module(f"{PKG}.data")
        pipeline = import_module(f"{PKG}.data.pipeline")
        synthetic = import_module(f"{PKG}.data.synthetic")
        tok = import_module(f"{PKG}.tokenization")
        train = import_module(f"{PKG}.train")
        engine_mod = import_module(f"{PKG}.parallel.engine")
        serving = import_module(f"{PKG}.serving")
        train_cli = import_module(f"{PKG}.cli.train")
        recall_cli = import_module(f"{PKG}.cli.recall")
        cascade_cli = import_module(f"{PKG}.cli.cascade")

        t_phase = time.perf_counter()
        work = pkg.BUILD_DIR / "smoke" / "tower"
        shutil.rmtree(work, ignore_errors=True)
        work.mkdir(parents=True)
        tsv, labels = work / "testB.tsv", work / "labels.txt"
        testb = synthetic.make_testb_tsv(ONE_SHOT_ROWS, seed=self.seed)
        tsv.write_text("\n".join(testb) + "\n")
        labels.write_text("".join(f"{key}\t{val}\n" for key, val in synthetic.SYNTHETIC_LABELS.items()))
        valid_tsv, answers = self.valid_data(work)
        catalog_tsv = work / "catalog.tsv"  # the testB rows and the valid rows: the answers' products are in it
        catalog_tsv.write_text("\n".join(testb + valid_tsv.read_text().splitlines()[1:]) + "\n")
        # the training rows: testB's, shuffled from the seed (in file order a 256-row batch holds ~5 queries, whose
        # groups would mask most of its in-batch negatives)
        train_tsv = work / "train.tsv"
        order = np.random.default_rng(self.seed).permutation(len(testb) - 1) + 1
        train_tsv.write_text("\n".join([testb[0]] + [testb[i] for i in order]) + "\n")
        spec = models.get_model("two_tower")
        tcfg = spec.config
        if (tcfg.bert.hidden_size, tcfg.bert.num_hidden_layers, tcfg.bert.num_attention_heads, tcfg.embed_dim,
                tcfg.temperature) != (H, TOWER_LAYERS, N, TOWER_D, 0.05):
            raise RuntimeError(f"not the full-width two-tower config: {tcfg} (is KMR_TOWER_CONFIG_OVERRIDES set?)")
        params = spec.init_params(self.seed)
        fz = data.Featurizer(tok.FullTokenizer.google_style(pkg.VOCAB_PATH), data.load_multimodal_labels(labels))
        with open(tsv, "r", encoding="utf-8") as f:
            examples = list(pipeline.iter_examples(f))
        products, queries = {}, {}
        for ex in examples:
            products.setdefault(ex.product_id, ex)
            queries.setdefault(ex.query_id, ex)
        exs = {"product": list(products.values()), "query": list(queries.values()),
               "pairs": [(ex.query_id, ex.product_id) for ex in examples]}
        exs["keys"] = {"product": [ex.product_id for ex in exs["product"]], "query": [ex.query_id for ex in exs["query"]]}
        log(f"phase 9 setup: {len(examples)}-row testB-like TSV, {len(exs['product'])} products, {len(exs['query'])} "
            f"queries; two_tower {TOWER_LAYERS}+{TOWER_LAYERS} x {H} layers, embed_dim {TOWER_D}, params in "
            f"{time.perf_counter() - t_phase:.1f} s")
        runs, rates = {}, {"card": nvidia_smi()}

        def counted(path, expected, fn):
            return counted_run(torch, runs, path, {k: expected.get(k, 0) for k in expected_launches(0, {})}, fn)

        # 1: the towers, and their launches timed alone
        tower_runs, rates["towers"] = self.tower_embeddings(spec, params, fz, exs)
        runs.update(tower_runs)
        blocks = self.tower_block_rows()
        rates["towers"]["block_rows"] = blocks
        rates["towers"]["device_ms_per_batch"] = tower_breakdown(blocks, rates["towers"])
        log(json.dumps({"two_tower_device_ms_per_batch": rates["towers"]["device_ms_per_batch"]}))

        # 4 (before 2: its checkpoint feeds the recall build): training at TRAIN_B on the TSV's positive rows,
        # shuffled
        train_batches = list(itertools.islice(train_cli.positive_batches(fz, [str(train_tsv)], TRAIN_B), TRAIN_STEPS))
        tc = train.recipe_for("two_tower")
        step1 = self.step1_against_truth(spec, tc, params, train_batches[0], "two_tower", loss_over_plain=True,
                                         must_hold=("query_proj/kernel", "product_proj/kernel", "kdd_conv1/weights",
                                                    "kdd_conv2/kernel", "bert/embeddings/word_embeddings",
                                                    "bert/embeddings/position_embeddings"))
        trainer = train.Trainer(spec, tc, precision=models.Precision.bf16(), device=self.dev)
        state = trainer.init_state(params)
        runs["two_tower_train"], steps = self.timed_train_steps(trainer, state, train_batches, TOWER_TRAIN, "two_tower")
        del trainer, state
        run_dir = work / "train"
        n_valid = -(-VALID_ROWS // TRAIN_B)
        expected = sum_launches((TOWER_CLI_STEPS, TOWER_TRAIN), (n_valid, tower_pair_launches()))
        report = counted("two_tower_train_cli", expected, lambda: train_cli.main([
            "--model", "two_tower", "--train-tsv", str(train_tsv), "--labels", str(labels), "--steps",
            str(TOWER_CLI_STEPS),
            "--batch-size", str(TRAIN_B), "--out", str(run_dir), "--valid-tsv", str(valid_tsv), "--answers",
            str(answers), "--valid-every", str(TOWER_CLI_STEPS), "--checkpoint-every", str(TOWER_CLI_STEPS),
            "--seed", str(self.seed)]))
        first = json.loads((run_dir / "metrics.jsonl").read_text().splitlines()[0])
        ckpt = run_dir / f"step_{TOWER_CLI_STEPS}.npz"
        if not np.isfinite([first["loss"], first["in_batch_accuracy"]]).all() or not ckpt.exists() \
                or report["pairs"] != TOWER_CLI_STEPS * TRAIN_B or not report["valid"]:
            raise RuntimeError(f"cli/train.py --model two_tower: first metrics {first}, report {report}")
        rates["train"] = {"step1": step1, "steps": steps, "cli": report, "first_metrics": first}
        log(f"two_tower training at B={TRAIN_B}: {steps['device_pairs_per_second']:.1f} pairs/s on the device; "
            f"cli/train.py {report['pairs']} pairs in {report['seconds']:.3f} s = {report['pairs_per_second']:.1f} "
            f"pairs/s end to end; step 0 loss {first['loss']:.5f}, in-batch accuracy {first['in_batch_accuracy']:.4f}; "
            f"valid {json.dumps(report['valid'])}")

        # 2: the recall CLIs over a packed catalog built with the trained towers, and the cascade
        cat = work / "catalog"
        n_catalog = ONE_SHOT_ROWS + VALID_ROWS
        common = ["--labels", str(labels), "--checkpoint", str(ckpt)]
        t0 = time.perf_counter()
        counted("two_tower_recall_build", expected_launches(-(-n_catalog // MAIN_B), tower_launches("product")),
                lambda: recall_cli.main(["build", "--tsv", str(catalog_tsv), *common, "--out", str(cat), "--packed",
                                         "--store-features"]))
        build_s = time.perf_counter() - t0
        ds = data.CatalogDataset(cat)
        if len(ds) != n_catalog or "features" not in ds.fields:
            raise RuntimeError(f"the packed catalog holds {len(ds)} products and {ds.fields}, expected {n_catalog}")
        n_q = -(-VALID_ROWS // MAIN_B)
        recall_tsv = work / "recall.tsv"
        counted("two_tower_recall_query", expected_launches(n_q, tower_launches("query")),
                lambda: recall_cli.main(["query", "--tsv", str(valid_tsv), *common, "--catalog", str(cat), "--out",
                                         str(recall_tsv)]))
        lines = recall_tsv.read_text().splitlines()
        pids = {int(p) for p in ds.product_ids()}
        if len(lines) != VALID_ROWS or not all(int(p) in pids for ln in lines for p in ln.split("\t")[1].split(",")):
            raise RuntimeError(f"recall.tsv: {len(lines)} rows, or products outside the catalog")
        curve = counted("two_tower_recall_curve", expected_launches(n_q, tower_launches("query")),
                        lambda: recall_cli.main(["curve", "--tsv", str(valid_tsv), *common, "--catalog", str(cat),
                                                 "--answers", str(answers), "--ks", "5,10,50,100"]))
        csv = work / "cascade.csv"
        n_queries = len(json.loads(answers.read_text()))
        n_rerank = -(-n_queries * CASCADE_K // MAIN_B)
        t0 = time.perf_counter()
        casc = counted("two_tower_cascade", sum_launches((1, tower_launches("query")),
                                                         (n_rerank, PER_BATCH["imagebert_b"])),
                       lambda: cascade_cli.main(["--queries", str(valid_tsv), "--catalog", str(cat), "--labels",
                                                 str(labels), "--tower-checkpoint", str(ckpt), "--cross-model",
                                                 "imagebert_b", "--k-recall", str(CASCADE_K), "--answers", str(answers),
                                                 "--batch-size", str(MAIN_B), "--out", str(csv)]))
        cascade_s = time.perf_counter() - t0
        agree = self.cascade_agreement(ds, valid_tsv, labels, ckpt, casc, csv)
        rates["recall"] = {"catalog_rows": n_catalog, "build_s": build_s, "curve": curve,
                           "catalog_bytes": sum(p.stat().st_size for p in cat.iterdir()),
                           "cascade": {k: casc[k] for k in ("recall_at_k", "k", "cascade_ndcg5", "queries", "pairs")},
                           "cascade_s": cascade_s, "cascade_agreement": agree}
        log(f"two_tower recall: the packed catalog of {n_catalog} rows built in {build_s:.2f} s "
            f"({rates['recall']['catalog_bytes'] / 1e6:.1f} MB); curve {json.dumps(curve)}; cascade over it "
            f"(ImageBERT-B, k-recall {CASCADE_K}) in {cascade_s:.2f} s: recall@{casc['k']} {casc['recall_at_k']}, "
            f"nDCG@5 {casc['cascade_ndcg5']} over {casc['queries']} queries and {casc['pairs']} pairs; its rows equal "
            f"a ScoringEngine pass over the recalled candidates")

        # 3: the 3M-product recall, a subprocess (its own peak RSS)
        rates["recall_3m"] = self.recall_3m(work / "recall3m")

        # 5: both towers exported, reloaded and held to the live embedder on the "xla" backend
        rates["export"] = self.export_towers(spec, params, fz, exs, work, runs)
        shutil.rmtree(work)
        rates["phase_seconds"] = time.perf_counter() - t_phase
        log(f"phase 9: {rates['phase_seconds']:.1f} s")
        return runs, rates

    def cascade_agreement(self, ds, valid_tsv, labels, ckpt, casc: dict, csv) -> dict:
        """The cascade's rerank scores and rows against one ScoringEngine pass over the recalled candidates:
        the queries embedded from ``ckpt`` (in the cascade's batch), recalled over ``ds``, the candidates' rows
        gathered and reranked by ImageBERT-B (the seed-0 init the cascade takes) in batches of MAIN_B ->
        the numbers; raises unless the scores are bit-equal and every row is their top 5."""
        from importlib import import_module

        import numpy as np

        pkg = import_module(PKG)
        data = import_module(f"{PKG}.data")
        pipeline = import_module(f"{PKG}.data.pipeline")
        tok = import_module(f"{PKG}.tokenization")
        models = import_module(f"{PKG}.models")
        engine_mod = import_module(f"{PKG}.parallel.engine")
        recall_cli = import_module(f"{PKG}.cli.recall")

        fz = data.Featurizer(tok.FullTokenizer.google_style(pkg.VOCAB_PATH), data.load_multimodal_labels(labels))
        by_id = {}
        with open(valid_tsv, "r", encoding="utf-8") as f:
            for ex in pipeline.iter_examples(f):
                by_id.setdefault(ex.query_id, ex)
        queries = list(by_id.values())
        towers = recall_cli.tower_engine(ckpt, self.dev)
        q = towers.embed("query", self.tower_batches(fz, queries)[0]).cpu().numpy()[:len(queries)]
        _, top = data.recall_chunked(q, ds, k=min(CASCADE_K, len(ds)), device=self.dev)
        spec = models.get_model("imagebert_b")
        engine = engine_mod.ScoringEngine(spec, spec.init_params(0), device=self.dev)
        qrows, cols = np.nonzero(top >= 0)
        idx = top[qrows, cols]
        scores: dict[str, dict[str, float]] = {}
        for i in range(0, len(idx), MAIN_B):
            rows = ds.rows(idx[i:i + MAIN_B])
            qr = qrows[i:i + MAIN_B]
            batch = data.pad_batch(data.rerank_batch("imagebert_b", [fz.query_token_ids(queries[r]) for r in qr],
                                                     np.array([queries[r].query_id for r in qr]), rows), MAIN_B)
            s = engine.score_batch(batch).float().cpu().numpy()[:len(qr)]
            for j, sc in enumerate(s):
                scores.setdefault(str(queries[qr[j]].query_id), {})[str(int(rows["product_id"][j]))] = float(sc)
        if scores != casc["scores"]:
            raise RuntimeError("the cascade's rerank scores differ from a ScoringEngine pass over its candidates")
        want = [f"{qid}," + ",".join(p for p, _ in sorted(scores[qid].items(), key=lambda kv: -kv[1])[:5])
                for qid in (str(ex.query_id) for ex in queries)]
        got = csv.read_text().splitlines()[1:]
        if got != want:
            raise RuntimeError("the cascade's rows are not the top 5 of the engine's scores")
        return {"queries": len(queries), "pairs": int(len(idx)), "scores_bit_equal": True, "rows_equal": True}

    def recall_3m(self, out_dir) -> dict:
        """``cli/bench_recall_3m.py --products 3000000 --queries 512 --dim 128 --check-queries 64`` as a
        subprocess on the card: its last line (build and recall seconds, peak RSS, the recall curve, the float64
        oracle's check), beside the derived bound of the recall (the float16 catalog once over PCIe, the
        products at the bf16 peak); the ~0.8 GB of shards deleted after."""
        # started through a small launcher process: Linux carries a process's peak RSS (ru_maxrss) across
        # fork and exec, so a child of this ~12 GB process would report this process's peak as its own
        launcher = "import subprocess, sys; sys.exit(subprocess.call(sys.argv[1:]))"
        cmd = [sys.executable, "-c", launcher, sys.executable, "-m", f"{PKG}.cli.bench_recall_3m", "--products",
               str(RECALL_3M), "--queries", str(MAIN_B), "--dim", str(TOWER_D), "--out-dir", str(out_dir),
               "--check-queries", "64"]
        env = {**os.environ, "PYTHONPATH": os.pathsep.join(filter(None, [str(REPO), os.environ.get("PYTHONPATH")]))}
        t0 = time.perf_counter()
        r = subprocess.run(cmd, capture_output=True, text=True, env=env, cwd=REPO, timeout=RECALL_3M_TIMEOUT_S)
        wall = time.perf_counter() - t0
        shutil.rmtree(out_dir, ignore_errors=True)
        if r.returncode != 0:
            log(r.stderr[-4000:])
            raise RuntimeError(f"cli/bench_recall_3m.py exited {r.returncode}: {r.stdout[-2000:]}")
        line = json.loads(r.stdout.strip().splitlines()[-1])
        catalog_bytes = RECALL_3M * TOWER_D * 2
        flops = 2.0 * MAIN_B * RECALL_3M * TOWER_D
        pcie_ms, mm_ms = catalog_bytes / PCIE_BYTES_PER_S * 1e3, flops / PEAK_BF16_FLOPS * 1e3
        line.update(wall_s=wall, bound={"catalog_bytes": catalog_bytes, "pcie_ms": pcie_ms, "flops": flops,
                                        "products_ms": mm_ms, "bound_ms": max(pcie_ms, mm_ms),
                                        "bound_by": "bytes over PCIe" if pcie_ms >= mm_ms else "operations"})
        log(f"recall 3M: {json.dumps(line)}")
        if not line["check"]["ok"] or line["products"] != RECALL_3M:
            raise RuntimeError(f"the 3M-product recall disagrees with its float64 oracle: {line['check']}")
        return line

    def export_towers(self, spec, params, fz, exs, work, runs: dict) -> dict:
        """Both towers exported at B=MAIN_B in bf16 (``serving.export_tower``, the "xla" backend), reloaded, and
        one batch embedded by the artifact and by the live ``TowerEngine`` on the same backend: bit-equal, with
        the same launches (the label conv's and the projection's gemm; counted) -> the numbers."""
        from importlib import import_module

        torch = self.torch
        models = import_module(f"{PKG}.models")
        serving = import_module(f"{PKG}.serving")
        engine_mod = import_module(f"{PKG}.parallel.engine")
        bf16 = models.Precision.bf16()
        live = engine_mod.TowerEngine(spec, params, device=self.dev, precision=bf16, attention_backend="xla")
        out = {}
        for side in ("query", "product"):
            batch = self.tower_batches(fz, exs[side][:MAIN_B])[0]
            t0 = time.perf_counter()
            art_dir = work / f"export_{side}"
            meta = serving.save_scorer(art_dir, serving.export_tower(spec, params, side, MAIN_B, bf16, self.dev),
                                       f"two_tower_{side}", MAIN_B, "xla")
            scorer = serving.load_scorer(art_dir)
            seconds = time.perf_counter() - t0
            feats = {k: batch[k] for k in scorer.feature_keys}
            want = live.embed(side, batch).cpu()
            scorer(feats)  # warm-up
            per = {"gemm": 1 + (side == "product")}
            got = torch.from_numpy(counted_run(torch, runs, f"two_tower_export_{side}", expected_launches(1, per),
                                               lambda: scorer(feats)))
            equal = bool(torch.equal(got, want))
            size = sum(f.stat().st_size for f in art_dir.iterdir())
            out[side] = {"export_save_load_seconds": seconds, "bytes": size, "custom_ops": meta["custom_ops"],
                         "bit_equal_to_live": equal, "max_abs_err": (got - want).abs().max().item()}
            log(f"export two_tower {side}: traced, saved ({size / 1e6:.1f} MB) and reloaded in {seconds:.1f} s; "
                f"custom ops {meta['custom_ops']}; one batch bit-equal to the live embedder: {equal}")
            if not equal:
                raise RuntimeError(f"the exported {side} tower differs from the live embedder: {out[side]}")
        return out

    # ---- phase 10: the int8 serving path, data parallelism, the last utilities ------------------------------

    def int8_serving(self) -> tuple[dict[str, dict], dict]:
        """Phase 10, part 1: ImageBERT-A at full width (12 x 768, the seed's weights) over phase 3's TSV in
        MAIN_B batches, its int8-ffn and int8 trees (``ops/quant.py:quantize_for_serving``, the residual leaves
        bf16) through ``ScoringEngine`` on its default route beside the bf16 kernels: end-to-end and device
        pairs/s, exact launches (int8-ffn: the attention blocks' kernels and no FFN kernel; int8: none); the
        int8 dense at the FFN shapes (``int8_rows``); the rank fidelity of ``tests/test_quant.py`` at its MID
        config (``int8_rank_fidelity``); both modes exported through ``cli/export.py --quantize``, reloaded and
        bit-equal to the engine on one batch -> (each counted run's launches, the part's numbers)."""
        from importlib import import_module

        import numpy as np

        torch = self.torch
        pkg = import_module(PKG)
        data = import_module(f"{PKG}.data")
        models = import_module(f"{PKG}.models")
        engine_mod = import_module(f"{PKG}.parallel.engine")
        attention = import_module(f"{PKG}.ops.attention")
        quant = import_module(f"{PKG}.ops.quant")
        tok = import_module(f"{PKG}.tokenization")
        checkpoint = import_module(f"{PKG}.checkpoint")
        export_cli = import_module(f"{PKG}.cli.export")
        serving = import_module(f"{PKG}.serving")

        t_part = time.perf_counter()
        work = pkg.BUILD_DIR / "smoke"
        tsv, labels = work / "pairs.tsv", work / "labels.txt"  # phase 3's
        spec = models.get_model("imagebert_a")
        cfg, bf16 = spec.config, models.Precision.bf16()
        params = spec.init_params(self.seed)
        featurizer = data.Featurizer(tok.FullTokenizer.google_style(pkg.VOCAB_PATH), data.load_multimodal_labels(labels))
        batches = list(data.batches_from_files([tsv], featurizer.imagebert_a, MAIN_B))
        valid = torch.from_numpy(np.concatenate([bt["valid"] for bt in batches]))
        runs, rates = {}, {"card": nvidia_smi()}

        def staged_run(engine):
            staged = [engine.to_device(bt) for bt in batches]

            def run():
                with torch.inference_mode(), attention.attention_backend(engine.attention_backend):
                    return [spec.apply(engine.params, bt, cfg, bf16)["score"] for bt in staged]

            ms = cuda_ms(torch, run, iters=3, warmup=1)
            return ms, torch.cat(run()).float().cpu()

        base = engine_mod.ScoringEngine(spec, params, device=self.dev, precision=bf16)
        base_ms, base_scores = staged_run(base)
        n_pad = len(batches) * MAIN_B
        rates["bf16"] = {"device_ms_per_batch": base_ms / len(batches), "device_pairs_per_second": n_pad / base_ms * 1e3}
        engines = {}
        for mode, path in (("int8-ffn", "imagebert_a_int8_ffn"), ("int8", "imagebert_a_int8")):
            t0 = time.perf_counter()
            qparams = quant.quantize_for_serving(spec, params, mode, bf16_residual=True)
            quantize_s = time.perf_counter() - t0
            engine = engine_mod.ScoringEngine(spec, qparams, device=self.dev, precision=bf16)
            if engine.attention_backend != "pallas_packed":
                raise RuntimeError(f"{mode}: the engine took {engine.attention_backend}, not its default route")
            engine.score_batch(batches[0])
            torch.cuda.synchronize()
            stats = engine_mod.ScoringStats()
            result = counted_run(torch, runs, path, expected_launches(len(batches), PER_BATCH[path]),
                                 lambda engine=engine, stats=stats: engine.score_files([tsv], featurizer, MAIN_B,
                                                                                       stats=stats))
            ms, scores = staged_run(engine)
            scores, ref = scores[valid], base_scores[valid]
            engine_scores = torch.tensor([result[str(q)][str(p)] for bt in batches
                                          for q, p, ok in zip(bt["query_id"], bt["product_id"], bt["valid"]) if ok])
            if stats.pairs != N_ROWS or not bool(torch.isfinite(scores).all()) or scores.shape != (N_ROWS,):
                raise RuntimeError(f"{mode}: {stats.pairs} pairs scored, finite {bool(torch.isfinite(scores).all())}")
            d_engine = (engine_scores - scores).abs().max().item()
            if d_engine > 1e-6:
                raise RuntimeError(f"{mode}: the engine's scores differ from the staged run's by {d_engine}")
            same_rank, n_q = self.ranking_agreement(batches, scores, ref)
            rates[mode] = {"quantize_seconds": quantize_s, "pairs": stats.pairs, "seconds": stats.seconds,
                           "pairs_per_second": stats.pairs_per_second, "device_ms_per_batch": ms / len(batches),
                           "device_pairs_per_second": n_pad / ms * 1e3,
                           "max_abs_score_diff_vs_bf16_kernels": (scores - ref).abs().max().item(),
                           "mean_abs_score_diff_vs_bf16_kernels": (scores - ref).abs().mean().item(),
                           "identical_rankings_vs_bf16": [same_rank, n_q]}
            log(f"{mode}: {stats.pairs} pairs end to end {stats.pairs_per_second:.1f} pairs/s, on the device "
                f"{rates[mode]['device_pairs_per_second']:.1f} pairs/s (bf16 kernels "
                f"{rates['bf16']['device_pairs_per_second']:.1f}); scores vs the bf16 kernels max |d| "
                f"{rates[mode]['max_abs_score_diff_vs_bf16_kernels']:.4g}, same ranking in {same_rank}/{n_q} queries")
            engines[mode] = engine
        rates["dense"] = self.int8_rows()
        rates["rank_fidelity"] = self.int8_rank_fidelity()

        # both modes through the user's entry point, cli/export.py --quantize, from a checkpoint of the weights
        out_root = work / "int8"
        shutil.rmtree(out_root, ignore_errors=True)
        out_root.mkdir(parents=True)
        ckpt = out_root / "a.npz"
        checkpoint.save_npz(ckpt, checkpoint.params_to_jax(params))
        host = {k: v for k, v in batches[0].items()}
        rates["export"] = {}
        for mode, path in (("int8-ffn", "imagebert_a_export_int8_ffn"), ("int8", "imagebert_a_export_int8")):
            out = out_root / mode
            t0 = time.perf_counter()
            export_cli.main(["--model", "imagebert_a", "--checkpoint", str(ckpt), "--batch-size", str(MAIN_B),
                             "--backend", "pallas_packed", "--quantize", mode, "--out", str(out)])
            export_s = time.perf_counter() - t0
            scorer = serving.load_scorer(out)
            if scorer.meta["quantize"] != mode:
                raise RuntimeError(f"{out}/meta.json records quantize {scorer.meta['quantize']!r}")
            feats = {k: host[k] for k in scorer.feature_keys}
            got = counted_run(torch, runs, path, expected_launches(1, PER_BATCH[path]), lambda: scorer(feats))
            want = engines[mode].score_batch(host).float().cpu().numpy()
            if not np.array_equal(got, want):
                raise RuntimeError(f"the reloaded {mode} artifact differs from the engine: max |d| "
                                   f"{np.abs(got - want).max()}")
            size = sum(f.stat().st_size for f in out.iterdir())
            rates["export"][mode] = {"export_seconds": export_s, "bytes": size, "bit_equal_to_engine": True}
            log(f"export {mode}: {export_s:.1f} s, {size / 1e6:.1f} MB, reloaded = the engine bit for bit")
        shutil.rmtree(out_root)
        rates["part_seconds"] = time.perf_counter() - t_part
        return runs, rates

    def int8_rows(self) -> dict:
        """The int8 dense at the two FFN shapes of a B=MAIN_B batch ([20480, 768] x [768, 3072] and [20480, 3072]
        x [3072, 768]): ``dense_q8`` on the card against the port's ``dense_q8`` on the CPU (1e-6 relative: the
        int32 sums are exact); ``torch._int_mm`` alone against its int8 bound (the data sheet's 1979 TOPS dense)
        and against ``gemm_bf16`` and ``torch.matmul`` of bf16 operands; the row-quant and the dequant passes;
        the whole ``dense_q8`` against the bf16 dense of ``models/core.py``."""
        from importlib import import_module

        torch = self.torch
        quant = import_module(f"{PKG}.ops.quant")
        k = import_module(f"{PKG}.ops.kernels")
        core = import_module(f"{PKG}.models.core")
        out = {}
        m = MAIN_B * S
        for k_in, n in ((H, I), (I, H)):
            name = f"[{m}x{k_in}]x[{k_in}x{n}]"
            x = self.randn(m, k_in, dtype=torch.bfloat16)
            w = self.randn(k_in, n, scale=k_in ** -0.5).cpu()
            p = {**quant.quantize_kernel(w), "bias": self.randn(n, scale=0.02).cpu()}
            pc = {key: v.to(self.dev) for key, v in p.items()}
            got, want = quant.dense_q8(pc, x).cpu(), quant.dense_q8(p, x.cpu())
            rel = ((got - want).abs().max() / want.abs().max()).item()
            if not rel <= 1e-6:
                raise RuntimeError(f"dense_q8 {name} on the card differs from the CPU's by {rel:.3g} relative")
            x_q, x_scale = quant.quantize_rows(x)
            acc = quant.int8_matmul(x_q, pc["kernel_q8"])
            ops = 2.0 * m * k_in * n
            int8_bound, int8_by = bound_ms(m * k_in + k_in * n + 4 * m * n, ops, PEAK_INT8_OPS)
            wb, xb = w.to(self.dev, torch.bfloat16), x
            r = {"card_vs_cpu_max_rel": rel, "int_mm_ms": cuda_ms(torch, lambda: torch._int_mm(x_q, pc["kernel_q8"])),
                 "int_mm_bound_ms": int8_bound, "int_mm_bound_by": int8_by,
                 "gemm_bf16_ms": cuda_ms(torch, lambda: k.gemm(xb, wb, pc["bias"], "bias")),
                 "matmul_bf16_ms": cuda_ms(torch, lambda: torch.matmul(xb, wb)),
                 "bf16_bound_ms": bound_ms(2 * m * k_in + 2 * k_in * n + 2 * m * n, ops, PEAK_BF16_FLOPS)[0],
                 "quant_pass_ms": cuda_ms(torch, lambda: quant.quantize_rows(x)),
                 "dequant_pass_ms": cuda_ms(torch, lambda: quant.dequantize(acc, x_scale, pc)),
                 "dense_q8_ms": cuda_ms(torch, lambda: quant.dense_q8(pc, x)),
                 "dense_bf16_ms": cuda_ms(torch, lambda: core.dense({"kernel": wb, "bias": pc["bias"]}, x,
                                                                    core.Precision(torch.bfloat16)))}
            r["int_mm_tops"] = ops / r["int_mm_ms"] / 1e9
            out[name] = r
            log(f"int8 {name}: dense_q8 card vs CPU {rel:.3g} relative; _int_mm {r['int_mm_ms']:.4f} ms "
                f"({r['int_mm_tops']:.0f} TOPS; bound {int8_bound:.4f} ms, {int8_by}), gemm_bf16 {r['gemm_bf16_ms']:.4f}, "
                f"torch.matmul bf16 {r['matmul_bf16_ms']:.4f} (bound {r['bf16_bound_ms']:.4f}); quant pass "
                f"{r['quant_pass_ms']:.4f}, dequant pass {r['dequant_pass_ms']:.4f}; dense_q8 {r['dense_q8_ms']:.4f} "
                f"vs the bf16 dense {r['dense_bf16_ms']:.4f} ms")
        return out

    def int8_rank_fidelity(self) -> dict:
        """``tests/test_quant.py:146-210`` through the port on the card: ImageBERT-A and -B at its MID config
        (128 wide, 4 layers, the seed's weights) over 20 queries x 30 products, f32 (the "xla" route, TF32 off)
        and each int8 mode, on the card and on the CPU. Each int8 run's scores on the card within SCORE_BAND of
        the CPU's (an activation whose f32 value lies at an int8 rounding boundary rounds to either side, and
        ImageBERT-B's AM head amplifies the step up to 7.5x: 2.8e-3 on its full mode on the H100);
        the FFN-only mode meets the test's thresholds (mean Kendall
        tau >= 0.98, min >= 0.95, mean top-5 overlap >= 0.95, min >= 0.8, nDCG@5 delta <= 0.01); the full mode's
        numbers are reported beside whether they meet them (the JAX package's own full mode misses its nDCG@5
        threshold at two of four init keys, ROADMAP.md Queue 3)."""
        from importlib import import_module

        import numpy as np

        torch = self.torch
        models = import_module(f"{PKG}.models")
        quant = import_module(f"{PKG}.ops.quant")
        checkpoint = import_module(f"{PKG}.checkpoint")
        engine_mod = import_module(f"{PKG}.parallel.engine")
        batchspec = import_module(f"{PKG}.data.batchspec")
        out = {}
        for name in ("imagebert_a", "imagebert_b"):
            spec = models.get_model(name, overrides=MID)
            params = spec.init_params(self.seed)
            batch = batchspec.example_batch(name, spec.config, MID_Q * MID_P, np.random.default_rng(5))

            def scores(p, device):
                eng = engine_mod.ScoringEngine(spec, p, device=device, precision=models.Precision.f32())
                return eng.score_batch(batch).float().cpu().numpy()

            f32 = {d: scores(params, d) for d in (self.dev, "cpu")}
            for mode, only in (("full", None), ("ffn", ("ffn",))):
                qp = spec.from_jax(quant.quantize_dense_tree(checkpoint.params_from_jax(checkpoint.params_to_jax(params)),
                                                             only_paths=only))
                q8 = {d: scores(qp, d) for d in (self.dev, "cpu")}
                d_card = float(np.abs(q8[self.dev] - q8["cpu"]).max())
                card, cpu = rank_fidelity(f32[self.dev], q8[self.dev]), rank_fidelity(f32["cpu"], q8["cpu"])
                meets = {k: fidelity_met(v) for k, v in (("card", card), ("cpu", cpu))}
                out[f"{name} {mode}"] = {"card": card, "cpu": cpu, "meets_thresholds": meets,
                                         "max_abs_card_vs_cpu": d_card}
                log(f"rank fidelity {name} {mode} (MID): card {json.dumps(card)} meets {meets['card']}; CPU meets "
                    f"{meets['cpu']}; int8 scores card vs CPU max |d| {d_card:.3g}")
                if d_card > SCORE_BAND or (mode == "ffn" and not meets["card"]):
                    raise RuntimeError(f"int8 rank fidelity {name} {mode}: {out[f'{name} {mode}']}")
        return out

    def data_parallel(self) -> tuple[dict[str, dict], dict]:
        """Phase 10, part 2: ``torchrun --standalone --nproc_per_node 1 -m <port>.cli.train --distributed`` (NCCL)
        for DP_STEPS steps of ImageBERT-A at full width on phase 5's packed shards, held bit-equal to the same run
        without ``--distributed`` (counted); two gloo ranks on the one card (``dp_worker``): DP_TRAIN_STEPS steps
        of A at full width, TRAIN_B pairs a step (half a rank), dropout TRAIN_RATE, each rank's losses and
        parameters held to one rank's steps on the global batch (``two_ranks``), and ``recall_sharded`` over a
        RECALL_ROWS x TOWER_D catalog with planted ties, equal to ``top_k_products`` on one rank; the train
        kernels' dropout on a rank's rows equal to the global batch's rows bit for bit; ``cli/dryrun_multichip.py
        2 --device cuda`` with its full-config stage; ``best_mha``'s pick at A's and B's shapes -> (each counted
        run's launches, the part's numbers)."""
        from importlib import import_module

        import numpy as np

        torch = self.torch
        pkg = import_module(PKG)
        train_cli = import_module(f"{PKG}.cli.train")
        attention = import_module(f"{PKG}.ops.attention")
        t_part = time.perf_counter()
        runs, rates = {}, {"card": nvidia_smi()}
        work = pkg.BUILD_DIR / "smoke" / "dp"
        shutil.rmtree(work, ignore_errors=True)
        work.mkdir(parents=True)
        env = {k: v for k, v in os.environ.items() if k not in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")}

        # world 1 under NCCL through torchrun, against the run without --distributed
        train_dir = pkg.BUILD_DIR / "smoke" / "train"
        argv = ["--model", "imagebert_a", "--packed-dir", str(train_dir / "packed_a"), "--labels",
                str(train_dir / "labels.txt"), "--steps", str(DP_STEPS), "--batch-size", str(TRAIN_B),
                "--checkpoint-every", str(DP_STEPS), "--warmup-steps", str(TRAIN_STEPS // 2), "--total-steps",
                str(10 * TRAIN_STEPS), "--seed", str(self.seed)]
        plain = counted_run(torch, runs, "imagebert_a_train_dp_plain", expected_launches(DP_STEPS, PER_STEP),
                            lambda: train_cli.main([*argv, "--out", str(work / "plain")]))
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "1",
                            "-m", f"{PKG}.cli.train", "--distributed", *argv, "--out", str(work / "nccl")],
                           cwd=REPO, env=env, capture_output=True, text=True, timeout=DP_TIMEOUT_S)
        torchrun_s = time.perf_counter() - t0
        if r.returncode != 0:
            raise RuntimeError(f"torchrun cli/train.py --distributed failed:\n{r.stderr[-4000:]}")
        report = json.loads(r.stdout.strip().splitlines()[-1])
        with np.load(work / "plain" / f"state_{DP_STEPS}.npz") as a, np.load(work / "nccl" / f"state_{DP_STEPS}.npz") as b:
            differ = [key for key in a.files if key not in b.files or not np.array_equal(a[key], b[key])]
            n_arrays = len(a.files)
        same_log = (work / "plain" / "metrics.jsonl").read_text() == (work / "nccl" / "metrics.jsonl").read_text()
        if differ or not same_log or report["world_size"] != 1:
            raise RuntimeError(f"torchrun --distributed (world {report['world_size']}) differs from the plain run: "
                               f"{differ[:8]}, metrics equal {same_log}")
        rates["nccl_world_1"] = {"steps": DP_STEPS, "bit_equal_arrays": n_arrays, "metrics_equal": same_log,
                                 "torchrun_seconds": torchrun_s, "pairs_per_second": report["pairs_per_second"],
                                 "plain_pairs_per_second": plain["pairs_per_second"]}
        log(f"cli/train.py --distributed under torchrun (NCCL, world 1): {DP_STEPS} steps bit-equal to the plain run "
            f"({n_arrays} arrays of state_{DP_STEPS}.npz, metrics.jsonl equal); {report['pairs_per_second']:.1f} "
            f"pairs/s (plain {plain['pairs_per_second']:.1f}), the command {torchrun_s:.1f} s")
        shutil.rmtree(work / "plain")
        shutil.rmtree(work / "nccl")

        # two gloo ranks on the one card, against one rank on the global batch
        rates["gloo_two_ranks"] = self.two_ranks(work, env)
        rates["dropout_shards"] = self.dropout_shard_masks()

        # the dry run, its full-config stage on the card
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", f"{PKG}.cli.dryrun_multichip", "2", "--device", "cuda"], cwd=REPO,
                           env=env, capture_output=True, text=True, timeout=DP_TIMEOUT_S)
        last = r.stdout.strip().splitlines()[-1] if r.stdout.strip() else ""
        if r.returncode != 0 or not last.startswith("dryrun_multichip(2): ok") or "full-config" not in last:
            raise RuntimeError(f"cli/dryrun_multichip.py 2 --device cuda: {last!r}\n{r.stderr[-4000:]}")
        rates["dryrun"] = {"line": last, "seconds": time.perf_counter() - t0}
        log(f"{last} ({rates['dryrun']['seconds']:.1f} s)")

        # best_mha's pick at A's and B's attention shapes
        picks = {}
        for label, s, has_bias in (("imagebert_a", S, False), ("imagebert_b", B_S, True)):
            q = self.randn(MAIN_B, N, s, 64, dtype=torch.bfloat16)
            bias = self.randn(MAIN_B, 1, 1, s) if has_bias else None
            route = attention.backend_choice(q, bias)
            choice, t_kernel, t_xla = attention._backend_choice((*q.shape, has_bias, str(q.dtype)))
            picks[label] = {"shape": list(q.shape), "bias": has_bias, "route": route, "mha_kernel_ms": t_kernel,
                            "mha_xla_ms": t_xla}
            log(f"best_mha {label} {list(q.shape)} bias={has_bias}: {route} (mha kernel {t_kernel:.4f} ms, "
                f"mha_xla {t_xla:.4f} ms)")
        rates["best_mha"] = picks
        rates["part_seconds"] = time.perf_counter() - t_part
        return runs, rates

    def two_ranks(self, work, env) -> dict:
        """``dp_worker`` on two gloo ranks of the one card, against ``dp_case`` and ``recall_case`` on one rank
        here: the ranks' losses equal, rank 0's initial params equal to one rank's (broadcast from rank 0);
        each loss within DP_LOSS_BAND relative of one rank's and step 1's averaged gradients within phase 5's
        TRAIN_STEP_REL_L2 of one rank's, leaf by leaf (cuBLAS's f32 products pick another algorithm at a rank's
        rows than at the global batch's, so rows round apart in bf16 training; the band is measured and
        recorded, with the two steps' update in relative L2); the sharded recall's indices and scores equal to
        one rank's."""
        import socket

        torch = self.torch
        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            port = sock.getsockname()[1]
        t0 = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, str(REPO / "chip_smoke.py"), "--seed", str(self.seed), "--dp-rank",
                                   str(r), "--dp-port", str(port), "--dp-out", str(work)], cwd=REPO, env=env,
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for r in range(2)]
        try:
            errs = [p.communicate(timeout=DP_TIMEOUT_S)[1] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        for r, (p, err) in enumerate(zip(procs, errs)):
            if p.returncode != 0:
                raise RuntimeError(f"gloo rank {r} on the card failed (exit {p.returncode}):\n{err[-4000:]}")
        spawn_s = time.perf_counter() - t0
        ranks = [json.loads((work / f"rank{r}.json").read_text()) for r in range(2)]
        ref_losses, ref, ref_ms = dp_case(torch, 0, 1, self.seed, self.dev)
        got = torch.load(work / "rank0_params.pt")

        def rel_l2(a, b):
            return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()

        init_equal = all(torch.equal(got["init"][n], t) for n, t in ref["init"].items())
        grad_rel = {n: rel_l2(got["grads"][n], g) for n, g in ref["grads"].items()}
        update_rel = {n: rel_l2(got["params"][n] - got["init"][n], p - ref["init"][n]) for n, p in ref["params"].items()}
        loss_rel = [abs(a - b) / abs(b) for a, b in zip(ranks[0]["losses"], ref_losses)]
        worst, worst_update = max(grad_rel, key=grad_rel.get), max(update_rel, key=update_rel.get)
        ref_s, ref_i = recall_case(torch, 0, 1, self.seed, self.dev)
        rec = torch.load(work / "rank0_recall.pt")
        recall_equal = torch.equal(rec["indices"], ref_i.cpu()) and torch.equal(rec["scores"], ref_s.cpu())
        out = {"losses": ranks[0]["losses"], "one_rank_losses": ref_losses, "loss_max_rel": max(loss_rel),
               "init_params_equal": init_equal, "step1_grad_max_rel_l2": grad_rel[worst], "step1_grad_worst": worst,
               "update_max_rel_l2": update_rel[worst_update], "update_worst": worst_update,
               "ranks_losses_equal": ranks[0]["losses"] == ranks[1]["losses"],
               "step_ms": ranks[0]["step_ms"], "one_rank_step_ms": ref_ms, "recall_equal": recall_equal,
               "recall_ms": ranks[0]["recall_ms"], "recall_rows": RECALL_ROWS, "spawn_seconds": spawn_s}
        log(f"two gloo ranks on the card: losses {ranks[0]['losses']} vs one rank {ref_losses} (max rel "
            f"{out['loss_max_rel']:.3g}); step 1's averaged gradients vs one rank's, max rel L2 {grad_rel[worst]:.3g} "
            f"({worst}); the two steps' update, max rel L2 {update_rel[worst_update]:.3g} ({worst_update}); the same "
            f"initial params {init_equal}; steps {ranks[0]['step_ms']} ms "
            f"vs one rank {ref_ms} ms; recall_sharded over {RECALL_ROWS} x {TOWER_D} on 2 ranks = one rank: "
            f"{recall_equal} ({ranks[0]['recall_ms']:.2f} ms); {spawn_s:.1f} s")
        if not (out["ranks_losses_equal"] and init_equal and out["loss_max_rel"] <= DP_LOSS_BAND
                and grad_rel[worst] <= TRAIN_STEP_REL_L2 and recall_equal):
            raise RuntimeError(f"two gloo ranks disagree with one rank: {json.dumps(out)}")
        return out

    def dropout_shard_masks(self) -> dict:
        """The train kernels' dropout on a rank's rows (``ops/dropout.py:batch_shard``, the seed shifted by the
        rank's first block) equal to the global batch's rows bit for bit: ``ln_train`` (the hidden draw, FFN
        blocks of 4 pairs) and ``attn_train`` (each head's probabilities, attention blocks of 8) at rate 0.5,
        TRAIN_B pairs as two ranks of half."""
        from importlib import import_module

        torch = self.torch
        k = import_module(f"{PKG}.ops.kernels")
        dropout = import_module(f"{PKG}.ops.dropout")
        b, seed, rate, half = TRAIN_B, 12345, 0.5, TRAIN_B // 2
        m = b * S
        h, x, gamma, beta = (self.randn(m, H), self.randn(m, H, dtype=torch.bfloat16), self.randn(H), self.randn(H))
        qkv = self.randn(m, 3 * H, dtype=torch.bfloat16)
        ffn_block, _ = dropout.shard_block("ffn", b, None, seed)
        attn_block, _ = dropout.shard_block("attn", b, None, seed)
        want_ln = k.ln_train(h, x, gamma, beta, seed, rate, ffn_block * S)
        want_at = k.attn_train(qkv, None, b, S, N, seed, rate, attn_block)
        equal = True
        for r in range(2):
            rows = slice(r * half * S, (r + 1) * half * S)
            with dropout.batch_shard(r * half, b):
                fb, fs = dropout.shard_block("ffn", half, None, seed)
                ab_, as_ = dropout.shard_block("attn", half, None, seed)
                got_ln = k.ln_train(h[rows], x[rows], gamma, beta, fs, rate, fb * S)
                got_at = k.attn_train(qkv[rows].contiguous(), None, half, S, N, as_, rate, ab_)
            equal = equal and torch.equal(got_ln, want_ln[rows]) and torch.equal(got_at, want_at[rows])
        log(f"dropout on two ranks' rows = the global batch's rows bit for bit (ln_train, attn_train at rate {rate}): "
            f"{equal}")
        if not equal:
            raise RuntimeError("a rank's dropout masks differ from the global batch's rows")
        return {"ln_train": True, "attn_train": True, "rate": rate, "pairs": b}

    def utilities(self) -> dict:
        """Phase 10, part 3: ``cli/bench_all.py`` at B=MAIN_B (one line a scorer), ``cli/perf_lab.py model_q8
        imagebert_a MAIN_B ffn`` and ``int8``, in this process."""
        from importlib import import_module

        bench_all = import_module(f"{PKG}.cli.bench_all")
        perf_lab = import_module(f"{PKG}.cli.perf_lab")
        t0 = time.perf_counter()
        lines = bench_all.main(["--batch-size", str(MAIN_B), "--iters", "4"])
        perf_lab.main(["model_q8", "imagebert_a", str(MAIN_B), "ffn", "--iters", "4"])
        perf_lab.main(["int8", "--iters", "10"])
        return {"bench_all": lines, "seconds": time.perf_counter() - t0}

    # ---- phase 11: the JAX package's orbax checkpoints, read without orbax -----------------------------------

    def orbax_checkpoints(self) -> tuple[dict[str, dict], dict]:
        """Phase 11: the port's orbax reader (``checkpoint/orbax_io.py``; no orbax, tensorstore or JAX here).
        The libzstd it loaded; the committed fixture ``tests/data/orbax_tiny_a/`` (the real orbax's output)
        leaf-equal to its npz twin; ImageBERT-A at full width (12 x 768, the seed's weights) written as an orbax
        directory by ``tests/torch_orbax_writer.py`` beside its npz, each read by ``load_checkpoint`` (seconds,
        MB/s of the decoded leaves) and scored over phase 3's TSV through ``cli/score.py --checkpoint`` (exact
        launches, the scores bit-equal); the two-tower at its widths the same way through ``cli/recall.py
        build`` (the catalogs bit-equal); the files deleted -> (each counted run's launches, the phase's
        numbers)."""
        from importlib import import_module

        import numpy as np

        torch = self.torch
        pkg = import_module(PKG)
        models = import_module(f"{PKG}.models")
        checkpoint = import_module(f"{PKG}.checkpoint")
        zstd = import_module(f"{PKG}.checkpoint.zstd")
        ensemble = import_module(f"{PKG}.ensemble")
        score_cli = import_module(f"{PKG}.cli.score")
        recall_cli = import_module(f"{PKG}.cli.recall")
        sys.path.insert(0, str(REPO / "tests"))
        writer = import_module("torch_orbax_writer")

        t_phase = time.perf_counter()
        work = pkg.BUILD_DIR / "smoke" / "orbax"
        shutil.rmtree(work, ignore_errors=True)
        work.mkdir(parents=True)
        tsv, labels = pkg.BUILD_DIR / "smoke" / "pairs.tsv", pkg.BUILD_DIR / "smoke" / "labels.txt"  # phase 3's
        runs, rates = {}, {"card": nvidia_smi(), "libzstd": {"path": zstd.library()._name, "version": zstd.version()}}
        log(f"phase 11: libzstd {zstd.version()} from {zstd.library()._name}")

        def counted(path, expected, fn):
            return counted_run(torch, runs, path, {k: expected.get(k, 0) for k in expected_launches(0, {})}, fn)

        def same_leaves(got: dict, want: dict, what: str) -> int:
            got, want = checkpoint.flatten_tree(got), checkpoint.flatten_tree(want)
            differ = [k for k in want if k not in got or got[k].dtype != want[k].dtype
                      or got[k].tobytes() != want[k].tobytes()]
            if got.keys() != want.keys() or differ:
                raise RuntimeError(f"{what}: leaves differ from the npz twin's: {sorted(got.keys() ^ want.keys())[:5]} "
                                   f"{differ[:5]}")
            return len(want)

        # 1: the committed fixture, written by orbax and tensorstore
        fixture = REPO / "tests" / "data" / "orbax_tiny_a"
        t0 = time.perf_counter()
        got = checkpoint.restore_pytree(fixture)
        fixture_s = time.perf_counter() - t0
        n = same_leaves(got, checkpoint.load_npz(fixture.with_suffix(".npz")), "tests/data/orbax_tiny_a")
        rates["fixture"] = {"leaves": n, "seconds": fixture_s,
                            "bytes": sum(p.stat().st_size for p in fixture.rglob("*") if p.is_file())}
        log(f"the committed orbax fixture: {n} leaves read in {fixture_s:.4f} s, equal to its npz twin")

        def write_both(name: str, tree: dict) -> dict:
            t0 = time.perf_counter()
            writer.write_orbax(work / name, tree, seed=self.seed)
            write_s = time.perf_counter() - t0
            checkpoint.save_npz(work / f"{name}.npz", tree)
            return {"leaves_bytes": sum(np.asarray(v).nbytes for v in checkpoint.flatten_tree(tree).values()),
                    "orbax_bytes": sum(p.stat().st_size for p in (work / name).rglob("*") if p.is_file()),
                    "npz_bytes": (work / f"{name}.npz").stat().st_size, "write_s": write_s}

        def timed_loads(model: str, name: str, spec, info: dict) -> None:
            """``load_checkpoint`` on the directory and on the npz, twice each in turns (the second pair warm in
            the page cache), and ``restore_pytree`` alone; the params equal."""
            loaded = {}
            for turn in range(2):
                for kind, path in (("orbax", work / name), ("npz", work / f"{name}.npz")):
                    t0 = time.perf_counter()
                    loaded[kind] = checkpoint.load_checkpoint(model, path, spec)
                    info[f"{kind}_load_s_{turn}"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            checkpoint.restore_pytree(work / name)
            info["restore_pytree_s"] = time.perf_counter() - t0
            for kind in ("orbax", "npz"):
                info[f"{kind}_load_mb_per_s"] = info["leaves_bytes"] / 1e6 / info[f"{kind}_load_s_1"]
            info["restore_pytree_mb_per_s"] = info["leaves_bytes"] / 1e6 / info["restore_pytree_s"]
            same_leaves(loaded["orbax"], loaded["npz"], name)

        # 2: ImageBERT-A at full width, scored over phase 3's TSV from the directory and from the npz
        spec = models.get_model("imagebert_a")
        info_a = write_both("imagebert_a", checkpoint.params_to_jax(spec.init_params(self.seed)))
        timed_loads("imagebert_a", "imagebert_a", spec, info_a)
        n_score = -(-N_ROWS // MAIN_B)
        scores = {}
        for kind, path in (("orbax", work / "imagebert_a"), ("npz", work / "imagebert_a.npz")):
            out = work / f"scores_{kind}.tsv"
            t0 = time.perf_counter()
            counted(f"orbax_imagebert_a_{kind}", expected_launches(n_score, PER_BATCH["imagebert_a"]),
                    lambda: score_cli.main(["--model", "imagebert_a", "--tsv", str(tsv), "--labels", str(labels),
                                            "--checkpoint", str(path), "--out", str(out),
                                            "--expect-pairs", str(N_ROWS)]))
            info_a[f"score_cli_{kind}_s"] = time.perf_counter() - t0
            scores[kind] = {(q, p): s for q, row in ensemble.load_tsv_scores(out).items() for p, s in row.items()}
        if scores["orbax"] != scores["npz"] or len(scores["npz"]) != N_ROWS \
                or not np.isfinite(list(scores["npz"].values())).all():
            raise RuntimeError(f"imagebert_a: the orbax directory's scores differ from the npz route's "
                               f"({sum(scores['orbax'].get(k) != v for k, v in scores['npz'].items())} of "
                               f"{len(scores['npz'])} pairs)")
        rates["imagebert_a"] = info_a
        log(f"orbax imagebert_a: {info_a['leaves_bytes'] / 1e6:.1f} MB of leaves ({info_a['orbax_bytes'] / 1e6:.1f} "
            f"MB on disk, written in {info_a['write_s']:.2f} s); load_checkpoint {info_a['orbax_load_s_1']:.3f} s "
            f"({info_a['orbax_load_mb_per_s']:.0f} MB/s) beside the npz's {info_a['npz_load_s_1']:.3f} s "
            f"({info_a['npz_load_mb_per_s']:.0f} MB/s), restore_pytree alone {info_a['restore_pytree_s']:.3f} s; "
            f"{N_ROWS} scores through cli/score.py bit-equal to the npz route's")

        # 3: the two-tower at its widths, a catalog built from the directory and from the npz
        tower = models.get_model("two_tower")
        info_t = write_both("two_tower", checkpoint.params_to_jax(tower.init_params(self.seed)))
        timed_loads("two_tower", "two_tower", tower, info_t)
        catalogs = {}
        for kind, path in (("orbax", work / "two_tower"), ("npz", work / "two_tower.npz")):
            cat = work / f"catalog_{kind}.npz"
            counted(f"orbax_two_tower_{kind}", expected_launches(n_score, tower_launches("product")),
                    lambda: recall_cli.main(["build", "--tsv", str(tsv), "--labels", str(labels), "--checkpoint",
                                             str(path), "--out", str(cat)]))
            with np.load(cat) as z:
                catalogs[kind] = {k: z[k] for k in z.files}
        if catalogs["orbax"].keys() != catalogs["npz"].keys() or any(
                catalogs["orbax"][k].tobytes() != v.tobytes() for k, v in catalogs["npz"].items()):
            raise RuntimeError("two_tower: the catalog built from the orbax directory differs from the npz route's")
        info_t["catalog_rows"] = int(len(next(iter(catalogs["npz"].values()))))
        rates["two_tower"] = info_t
        log(f"orbax two_tower: {info_t['leaves_bytes'] / 1e6:.1f} MB of leaves; load_checkpoint "
            f"{info_t['orbax_load_s_1']:.3f} s beside the npz's {info_t['npz_load_s_1']:.3f} s; the catalog of "
            f"{info_t['catalog_rows']} rows through cli/recall.py build bit-equal to the npz route's")
        shutil.rmtree(work)
        rates["phase_seconds"] = time.perf_counter() - t_phase
        log(f"phase 11: {rates['phase_seconds']:.1f} s")
        return runs, rates


PER_A = f"one ImageBERT-A layer at B={MAIN_B}, S={S}"
PER_X = f"one LXMERT x-layer at B={MAIN_B}, F={LX_F}, T={LX_T}"
PER_B = f"one ImageBERT-B layer at B={MAIN_B}, S={B_S} (fused route)"
PER_MHA = f"one attention core at B={MAIN_B}, S={S}, bf16, no bias (ImageBERT-A's; the other cases under \"shapes\")"
PER_T = f"one ImageBERT-A training block at B={TRAIN_B}, S={S}, dropout {TRAIN_RATE}, no mask"
PER_XT = (f"one LXMERT x-layer's two train cross blocks at B={TRAIN_B} ({LX_F}<-{LX_T} and {LX_T}<-{LX_F}), "
          f"dropout {TRAIN_RATE}, key masks")
KERNELS = [
    # name, source, TPU kernel it replaces, the rows of time_kernels() / time_lxmert_kernels()
    # that make up one layer's launches, and which layer that is
    ("attention_block", f"{PKG}/ops/attention_block.py", f"{TPU_PKG_DIR}/ops/pallas_attention.py:479",
     ["attention_block"], PER_A),
    ("ffn_block", f"{PKG}/ops/ffn_block.py", f"{TPU_PKG_DIR}/ops/pallas_ffn.py:79", ["ffn_block"], PER_A),
    ("cross_attention_block", f"{PKG}/ops/cross_attention_block.py", f"{TPU_PKG_DIR}/ops/pallas_attention.py:713",
     ["cross_attention_block lang<-visn", "cross_attention_block visn<-lang"], PER_X),
    ("dual_cross_attention_block", f"{PKG}/ops/dual_cross_attention_block.py",
     f"{TPU_PKG_DIR}/ops/pallas_attention.py:912", ["dual_cross_attention_block"], PER_X),
    ("gemm_bf16", f"{PKG}/csrc/gemm_bf16.cu", f"{TPU_PKG_DIR}/ops/pallas_attention.py:200",
     ["gemm_bf16 qkv", "gemm_bf16 out-proj", "gemm_bf16 ffn-up", "gemm_bf16 ffn-down"], PER_A),
    ("attn_core", f"{PKG}/csrc/attn_core.cu", f"{TPU_PKG_DIR}/ops/pallas_attention.py:327", ["attn_core"], PER_A),
    ("attn_core_cross", f"{PKG}/csrc/attn_core.cu", f"{TPU_PKG_DIR}/ops/pallas_attention.py:615",
     ["attn_core_cross lang<-visn", "attn_core_cross visn<-lang"], PER_X),
    ("attn_core_dual", f"{PKG}/csrc/attn_core.cu", f"{TPU_PKG_DIR}/ops/pallas_attention.py:858",
     ["attn_core_dual"], PER_X),
    ("layernorm", f"{PKG}/csrc/layernorm.cu", f"{TPU_PKG_DIR}/ops/pallas_attention.py:237",
     ["layernorm", "layernorm"], PER_A),
    ("encoder_layer", f"{PKG}/ops/encoder_layer.py", f"{TPU_PKG_DIR}/ops/pallas_layer.py:128",
     [f"encoder_layer S={B_S}"], PER_B),
    ("layer_tail", f"{PKG}/csrc/layer_tail.cu", f"{TPU_PKG_DIR}/ops/pallas_layer.py:84",
     [f"layer_tail S={B_S}"], PER_B),
    ("mha", f"{PKG}/csrc/mha.cu", f"{TPU_PKG_DIR}/ops/pallas_attention.py:49", [f"mha S={S}"], PER_MHA),
    ("mha_packed", f"{PKG}/csrc/mha.cu", f"{TPU_PKG_DIR}/ops/pallas_attention.py:136", [f"mha_packed S={S}"],
     PER_MHA),
    # the training blocks (rows 8-11 of PERF.md's table) and the kernels inside them
    ("ffn_block_train", f"{PKG}/ops/train_blocks.py", f"{TPU_PKG_DIR}/ops/pallas_train.py:297",
     ["ffn_block_train"], PER_T),
    ("ffn_block_train_backward", f"{PKG}/ops/train_blocks.py", f"{TPU_PKG_DIR}/ops/pallas_train.py:323",
     ["ffn_block_train_backward"], PER_T),
    ("attention_block_train", f"{PKG}/ops/train_blocks.py", f"{TPU_PKG_DIR}/ops/pallas_train.py:864",
     ["attention_block_train"], PER_T),
    ("attention_block_train_backward", f"{PKG}/ops/train_blocks.py", f"{TPU_PKG_DIR}/ops/pallas_train.py:897",
     ["attention_block_train_backward"], PER_T),
    ("ln_train", f"{PKG}/csrc/ln_train.cu", f"{TPU_PKG_DIR}/ops/pallas_train.py:189", ["ln_train"], PER_T),
    ("ln_train_bwd", f"{PKG}/csrc/ln_train.cu", f"{TPU_PKG_DIR}/ops/pallas_train.py:218", ["ln_train_bwd"], PER_T),
    ("attn_train", f"{PKG}/csrc/attn_train.cu", f"{TPU_PKG_DIR}/ops/pallas_train.py:548", ["attn_train"], PER_T),
    ("attn_train_bwd", f"{PKG}/csrc/attn_train.cu", f"{TPU_PKG_DIR}/ops/pallas_train.py:811", ["attn_train_bwd"],
     PER_T),
    # LXMERT's train cross block (rows 12-13) and its attention kernel
    ("cross_attention_block_train", f"{PKG}/ops/train_blocks.py", f"{TPU_PKG_DIR}/ops/pallas_train.py:1264",
     [f"cross_attention_block_train {d[0]}" for d in LX_DIRECTIONS], PER_XT),
    ("cross_attention_block_train_backward", f"{PKG}/ops/train_blocks.py",
     f"{TPU_PKG_DIR}/ops/pallas_train.py:1300", [f"cross_attention_block_train_backward {d[0]}" for d in LX_DIRECTIONS],
     PER_XT),
    ("attn_train_cross", f"{PKG}/csrc/attn_train.cu", f"{TPU_PKG_DIR}/ops/pallas_train.py:1041",
     [f"attn_train_cross {d[0]}" for d in LX_DIRECTIONS], PER_XT),
    ("attn_train_cross_bwd", f"{PKG}/csrc/attn_train.cu", f"{TPU_PKG_DIR}/ops/pallas_train.py:1213",
     [f"attn_train_cross_bwd {d[0]}" for d in LX_DIRECTIONS], PER_XT),
]
# the GEMM's "f32" epilogue (ImageBERT-B's banded label conv, one launch a batch) rides in the
# gemm_bf16 entry under this key, timed alone at B=512
F32_EPILOGUE_ROW = "gemm_bf16 label conv [f32]"
LAUNCH_KEY = {"gemm_bf16": "gemm"}


def gemm_sites() -> list[tuple]:
    """Every gemm_bf16 launch shape of the driven paths, one row per distinct
    (M, N, K, epilogue, trans_b) of a path: (path, site, M, N, K, epilogue,
    trans_b, launches per 512-pair batch or per training step). Scoring: the
    default route at B=512 (the two-tower: a batch of 512 queries and one of
    512 products); training at B=256, where a backward recomputes its block's
    forward products and the last x-layer's visn stream runs no backward
    (PER_STEP_LXMERT)."""
    l_, r_, x_ = LX_DEPTHS
    rows = []

    def layers(path, m, fwd, gelu, bwd=0):
        """fwd encoder layers' four products at m rows; with bwd, a training step's (bwd backwards)."""
        if not bwd:
            return [(path, "qkv", m, 3 * H, H, "bias", False, fwd), (path, "out-proj", m, H, H, "residual", False, fwd),
                    (path, "ffn-up", m, I, H, gelu, False, fwd), (path, "ffn-down", m, H, I, "residual", False, fwd)]
        return [(path, "qkv", m, 3 * H, H, "bias", False, fwd + bwd), (path, "out-proj", m, H, H, "f32", False, fwd + bwd),
                (path, "ffn-up", m, I, H, gelu, False, fwd), (path, "ffn-up save", m, I, H, gelu + "_save", False, bwd),
                (path, "ffn-down", m, H, I, "f32", False, fwd + bwd),
                (path, "du = dh W2^T gelu'", m, I, H, gelu.replace("gelu_", "gelu_bwd_"), True, bwd),
                (path, "dx = du W1^T + dz", m, H, I, "residual_f32", True, bwd),
                (path, "dctx = do Wo^T", m, H, H, "bias", True, bwd),
                (path, "dx = dqkv Wqkv^T + dz", m, H, 3 * H, "residual_f32", True, bwd)]

    def cross(path, mq, mkv, fwd, bwd=0):
        """fwd cross blocks with mq query rows against mkv context rows (bwd backwards)."""
        out = [(path, "cross q", mq, H, H, "bias", False, fwd + bwd),
               (path, "cross kv", mkv, 2 * H, H, "bias", False, fwd + bwd),
               (path, "out-proj", mq, H, H, "f32" if bwd else "residual", False, fwd + bwd)]
        if bwd:
            out += [(path, "dctx = do Wo^T", mq, H, H, "bias", True, bwd),
                    (path, "cross dx = dq Wq^T + dz", mq, H, H, "residual_f32", True, bwd),
                    (path, "cross dctx = dkv Wkv^T", mkv, H, 2 * H, "bias", True, bwd)]
        return out

    a, b, lf, lt = MAIN_B * S, MAIN_B * B_S, MAIN_B * LX_F, MAIN_B * LX_T
    rows += layers("imagebert_a", a, 12, "gelu_tanh")
    rows += layers("imagebert_b", b, 12, "gelu_tanh") + [("imagebert_b", "label conv", MAIN_B * 10, 8 * H, 8 * H,
                                                           "f32", False, 1)]
    rows += layers("lxmert", lf, l_ + x_, "gelu_erf") + layers("lxmert", lt, r_ + x_, "gelu_erf")
    rows += cross("lxmert", lf, lt, x_) + cross("lxmert", lt, lf, x_)
    # the two-tower: both towers' layers at B=512 (queries and products), the product tower's label conv, and
    # the two projections to TOWER_D columns ("f32", M = 512)
    rows += layers("two_tower", MAIN_B * TOWER_Q, TOWER_LAYERS, "gelu_tanh")
    rows += layers("two_tower", MAIN_B * TOWER_P, TOWER_LAYERS, "gelu_tanh") + [
        ("two_tower", "label conv", MAIN_B * 10, 8 * H, 8 * H, "f32", False, 1),
        ("two_tower", "query_proj", MAIN_B, TOWER_D, H, "f32", False, 1),
        ("two_tower", "product_proj", MAIN_B, TOWER_D, H, "f32", False, 1)]
    ta, tb, tf, tt = TRAIN_B * S, TRAIN_B * B_S, TRAIN_B * LX_F, TRAIN_B * LX_T
    rows += layers("imagebert_a_train", ta, 12, "gelu_tanh", bwd=12)
    rows += layers("imagebert_b_train", tb, 12, "gelu_tanh", bwd=12) + [
        ("imagebert_b_train", "label conv", TRAIN_B * 10, 8 * H, 8 * H, "f32", False, 1),
        ("imagebert_b_train", "label conv dx = d band^T", TRAIN_B * 10, 8 * H, 8 * H, "bias", True, 1)]
    rows += layers("lxmert_train", tf, l_ + x_, "gelu_erf", bwd=l_ + x_)
    rows += layers("lxmert_train", tt, r_ + x_, "gelu_erf", bwd=r_ + x_ - 1)
    rows += cross("lxmert_train", tf, tt, x_, bwd=x_) + cross("lxmert_train", tt, tf, x_, bwd=x_ - 1)
    # its training step at B=256: both towers' layers forward and backward (the projections are plain products)
    # and the label conv's Function
    rows += layers("two_tower_train", TRAIN_B * TOWER_Q, TOWER_LAYERS, "gelu_tanh", bwd=TOWER_LAYERS)
    rows += layers("two_tower_train", TRAIN_B * TOWER_P, TOWER_LAYERS, "gelu_tanh", bwd=TOWER_LAYERS) + [
        ("two_tower_train", "label conv", TRAIN_B * 10, 8 * H, 8 * H, "f32", False, 1),
        ("two_tower_train", "label conv dx = d band^T", TRAIN_B * 10, 8 * H, 8 * H, "bias", True, 1)]
    merged: dict[tuple, list] = {}
    for path, site, m, n, k, epi, trans, launches in rows:
        key = (path, m, n, k, epi, trans)
        if key in merged:
            merged[key][1] += f" + {site}" if site not in merged[key][1] else ""
            merged[key][-1] += launches
        else:
            merged[key] = [path, site, m, n, k, epi, trans, launches]
    return [tuple(r) for r in merged.values()]


def gemm_site_launches() -> dict[str, int]:
    """gemm_sites()' launches summed per path."""
    out: dict[str, int] = {}
    for path, *_, launches in gemm_sites():
        out[path] = out.get(path, 0) + launches
    return out


def kernel_line(times: dict, launches: dict[str, dict], errors: dict) -> dict:
    """``launches``: path -> counter name -> launches in that path's run;
    each kernel's ``launches`` is its sum over the paths."""
    out = []
    for name, source, replaces, rows, per in KERNELS:
        rs = [times[r] for r in rows]
        lib = [r["library_ms"] for r in rs]
        by_path = {path: counts[LAUNCH_KEY.get(name, name)] for path, counts in launches.items()}
        out.append({
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": errors[name],
            "ms": sum(r["ms"] for r in rs),
            "plain_ms": sum(r["plain_ms"] for r in rs),
            "bound_ms": sum(r["bound_ms"] for r in rs),
            "bound_by": "operations" if any(r["bound_by"] == "operations" for r in rs) else "bytes",
            "library_ms": None if None in lib else sum(lib),
            "per": f"{len(rows)} launch(es) of {per}",
        })
        if name == "gemm_bf16":
            out[-1]["f32_epilogue"] = {**times[F32_EPILOGUE_ROW], "per": "1 launch: the label conv of one "
                                       f"512-pair ImageBERT-B batch"}
            out[-1]["train_launches"] = {row: times[row] for row in times if row.startswith("gemm_bf16 train ")}
            # ImageBERT-B's label conv in training: its Function's forward and backward, B=256
            out[-1]["label_conv_train"] = {row: times[row] for row in ("band_conv_train", "band_conv_train_backward")}
        if name.startswith("mha") or name in ("attn_core", "attn_core_cross", "layer_tail", "attn_train",
                                              "attn_train_bwd", "ffn_block_train", "ffn_block_train_backward",
                                              "attention_block_train", "attention_block_train_backward"):
            out[-1]["shapes"] = {row: times[row] for row in times if row.startswith(f"{name} ") and row not in rows}
        if all("device_ms" in r for r in rs):  # the device's time alone and the host's enqueue, beside "ms"
            out[-1].update({key: sum(r[key] for r in rs) for key in ("device_ms", "library_device_ms", "host_enqueue_us")})
            backends = sorted({r["library_sdpa_backend"] for r in rs if "library_sdpa_backend" in r})
            if backends:
                out[-1]["library_sdpa_backend"] = "+".join(backends)
    return {"kernels": out}


def lxmert_breakdown(times: dict, rates: dict, n_batches: int) -> dict:
    """One 512-pair LXMERT batch on the device (default route): the blocks, from
    their launches timed alone at the model's shapes, and the rest of the
    measured model time (embeddings, visual encoder, pooler, head, gaps)."""
    l_, x_ = LX_DEPTHS[0], LX_DEPTHS[2]
    lang_layers, visn_layers = l_ + x_, LX_DEPTHS[1] + x_
    out = {
        "self_attention_blocks": lang_layers * times[f"attention_block S={LX_F}"]["ms"]
        + visn_layers * times[f"attention_block S={LX_T}"]["ms"],
        "ffn_blocks": lang_layers * times[f"ffn_block S={LX_F}"]["ms"] + visn_layers * times[f"ffn_block S={LX_T}"]["ms"],
        "cross_attention_blocks": x_ * (times["cross_attention_block lang<-visn"]["ms"]
                                        + times["cross_attention_block visn<-lang"]["ms"]),
    }
    model = rates["lxmert"]["device_ms"] / n_batches
    out["rest"] = model - sum(out.values())
    out["model"] = model
    return out


def imagebert_b_breakdown(times: dict, rates: dict, n_batches: int) -> dict:
    """One 512-pair ImageBERT-B batch on the device, on each route: the layers,
    from their launches timed alone at the model's shapes, the label conv's
    product, and the rest of the measured model time (embeddings, the other
    denses, pooler, AM head, gaps)."""
    out = {}
    for run, parts in (("imagebert_b", {"attention_blocks": f"attention_block S={B_S}",
                                        "ffn_blocks": f"ffn_block S={B_S}"}),
                       ("imagebert_b_fused_layer", {"encoder_layers": f"encoder_layer S={B_S}"})):
        r = {part: 12 * times[row]["ms"] for part, row in parts.items()}
        r["label_conv"] = times[F32_EPILOGUE_ROW]["ms"]
        model = rates[run]["device_ms"] / n_batches
        r["rest"] = model - sum(r.values())
        r["model"] = model
        out[run] = r
    return out


def backends_breakdown(times: dict, a_rates: dict, a_batches: int, b_rates: dict, b_batches: int) -> dict:
    """One 512-pair batch on the device on the "pallas" backend (ImageBERT-A,
    ImageBERT-B) and in f32 on "xla" (ImageBERT-A): the 12 layers' attention and
    FFN blocks, each timed alone through ``models/core.py`` (of which the mha
    launches, timed alone), ImageBERT-B's label conv, and the rest of the
    measured model time (embeddings, pooler, head, gaps)."""
    out = {}
    for run, rates, n, mha_row, conv in (("imagebert_a_pallas", a_rates, a_batches, f"mha S={S}", False),
                                         ("imagebert_b_pallas", b_rates, b_batches, f"mha S={B_S} key mask", True),
                                         ("imagebert_a_f32", a_rates, a_batches, None, False)):
        layers = rates[run]["layers"]
        r = {"attention_blocks": 12 * layers["attention_block_ms"], "ffn_blocks": 12 * layers["ffn_block_ms"]}
        if conv:
            r["label_conv"] = times[F32_EPILOGUE_ROW]["ms"]
        model = rates[run]["device_ms"] / n
        r["rest"] = model - sum(r.values())
        r["model"] = model
        if mha_row:
            r["of_the_attention_blocks_mha"] = 12 * times[mha_row]["ms"]
        out[run] = r
    return out


def counted_run(torch, runs: dict, path: str, expected: dict, fn):
    """``fn()`` with every launch counter set to 0 just before it and read just after it into
    ``runs[path]``, which must equal ``expected`` -> what ``fn`` returned."""
    torch.cuda.synchronize()
    counted = launch_counters()
    for w in counted:
        w.launches = 0
    out = fn()
    torch.cuda.synchronize()
    runs[path] = {w.__name__: w.launches for w in counted}
    if runs[path] != expected:
        raise RuntimeError(f"{path} launches {runs[path]}, expected {expected}")
    log(f"launches {path}: {json.dumps(runs[path])}")
    return out


def expected_launches(n: int, per_batch: dict) -> dict:
    """Every counter's expected launches over n batches; unnamed counters 0."""
    return {w.__name__: n * per_batch.get(w.__name__, 0) for w in launch_counters()}


# launches per scored batch: 12 layers of ImageBERT-A; LXMERT's 9 + 5 self-attention
# layers, 5 x-layers of 2 self-attention and 2 FFN blocks, and the x-layers' two
# cross directions as 2 cross blocks (5 launches each) or 1 dual block (7 launches)
PER_BATCH = {
    "imagebert_a": {"attention_block": 12, "ffn_block": 12, "gemm": 48, "attn_core": 12, "layernorm": 24},
    "lxmert": {"attention_block": 24, "ffn_block": 24, "cross_attention_block": 10, "gemm": 24 * 4 + 10 * 3,
               "attn_core": 24, "attn_core_cross": 10, "layernorm": 48 + 10},
    "lxmert_dual_cross": {"attention_block": 24, "ffn_block": 24, "dual_cross_attention_block": 5,
                          "gemm": 24 * 4 + 5 * 4, "attn_core": 24, "attn_core_dual": 5, "layernorm": 48 + 10},
    # KMR_FUSED_LAYER=1: the 14 L/R layers keep their two blocks, the x-layers' 10 stream layers
    # are one fused layer each (QKV gemm, attn_core, layer_tail)
    "lxmert_fused_layer": {"attention_block": 14, "ffn_block": 14, "cross_attention_block": 10,
                           "encoder_layer": 10, "gemm": 14 * 4 + 10 * 3 + 10, "attn_core": 24,
                           "attn_core_cross": 10, "layer_tail": 10, "layernorm": 28 + 10},
    # 12 layers and the label conv's gemm ("f32" epilogue); C is B's path on rewritten queries
    "imagebert_b": {"attention_block": 12, "ffn_block": 12, "gemm": 48 + 1, "attn_core": 12, "layernorm": 24},
    "imagebert_b_fused_layer": {"encoder_layer": 12, "gemm": 12 + 1, "attn_core": 12, "layer_tail": 12},
    # the "pallas" backend: the unfused route, each self-attention core one mha launch; B and C keep
    # the label conv's gemm, one XLA dot under every backend in the JAX package
    "imagebert_a_pallas": {"mha": 12},
    "imagebert_b_pallas": {"mha": 12, "gemm": 1},
    # f32 on the card: the engine's "xla" route, plain products only
    "imagebert_a_f32": {},
    # one batch through each reloaded artifact: the default route's kernel launches, and no block
    # counter (the blocks are Python compositions, which an artifact does not hold)
    "imagebert_a_export_pallas_packed": {"gemm": 48, "attn_core": 12, "layernorm": 24},
    "imagebert_a_export_xla": {},
    # one call of ops/attention.py:mha_packed, the kernel's only entry point
    "mha_packed_entry": {"mha_packed": 1},
    # the int8 trees on the default route: int8-ffn's attention blocks (an int8 FFN takes the unfused route);
    # int8 runs no block kernel; their reloaded artifacts the same kernels without block counters
    "imagebert_a_int8_ffn": {"attention_block": 12, "gemm": 24, "attn_core": 12, "layernorm": 12},
    "imagebert_a_int8": {},
    "imagebert_a_export_int8_ffn": {"gemm": 24, "attn_core": 12, "layernorm": 12},
    "imagebert_a_export_int8": {},
}
PER_BATCH["imagebert_c"] = PER_BATCH["imagebert_b"]
# launches per ImageBERT-A training step (12 layers): forward, attention block = QKV gemm, attn_train, out-proj
# gemm ("f32"), ln_train; FFN block = up gemm (GELU), down gemm ("f32"), ln_train. Backward: each block's
# forward recomputed (the FFN up gemm with the "_save" epilogue), ln_train_bwd, then the transposed-weight
# gemms (attention: dctx and dx around attn_train_bwd; FFN: du and dx)
PER_STEP = {"attention_block_train": 12, "ffn_block_train": 12, "attention_block_train_backward": 12,
            "ffn_block_train_backward": 12, "gemm": 12 * (2 + 2 + 4 + 4), "attn_train": 12 + 12,
            "attn_train_bwd": 12, "ln_train": 12 + 12, "ln_train_bwd": 12 + 12}
PER_BATCH["imagebert_c_pallas"] = PER_BATCH["imagebert_b_pallas"]
# launches per ImageBERT-B/C training step: A's 12 layers (S=30, with the key mask), and the label conv's
# Function, one gemm forward ("f32") and one backward (dx, transposed weight); its band's gradient is
# glue (``ops/train_blocks.py:weight_grads``), no kernel of the port
PER_STEP_B = {**PER_STEP, "gemm": PER_STEP["gemm"] + 2}
# launches per LXMERT training step (9/5/5). Forward: 24 self-attention and 24 FFN train blocks (the L and R
# stacks' 14 layers, the x-layers' 10 stream layers), as ImageBERT-A's, and 10 cross train blocks (Q, KV and
# out-proj gemms, attn_train_cross, ln_train). Backward: every block but the last x-layer's visn stream (its
# visn<-lang cross block, self-attention and FFN), whose output no loss reads (the pooler reads lang), so
# autograd never runs those three: 23 + 23 + 9. A cross backward recomputes its three gemms and attn_train_cross,
# then ln_train_bwd, the dctx_out gemm, attn_train_cross_bwd, the dx and dctx gemms (9 gemms in all)
PER_STEP_LXMERT = {"attention_block_train": 24, "ffn_block_train": 24, "cross_attention_block_train": 10,
                   "attention_block_train_backward": 23, "ffn_block_train_backward": 23,
                   "cross_attention_block_train_backward": 9,
                   "gemm": 24 * 2 + 24 * 2 + 10 * 3 + 23 * 4 + 23 * 4 + 9 * 6,
                   "attn_train": 24 + 23, "attn_train_bwd": 23, "attn_train_cross": 10 + 9, "attn_train_cross_bwd": 9,
                   "ln_train": 24 + 24 + 10, "ln_train_bwd": 23 + 23 + 9}


# phase 8: the students' depth (ImageBERT-B through cli/distill.py, ImageBERT-A through cli/train.py --layers),
# the steps of A's run and of the LXMERT student's, and that student's stacks (l, r, x as LX_DEPTHS)
DISTIL_LAYERS, A_DISTIL_STEPS, LX_DISTIL_STEPS, LX_STUDENT = 4, 5, 3, (3, 2, 2)


def scoring_launches(model: str, depth) -> dict:
    """Launches per scored batch on the default route at any depth: ``depth`` layers of ImageBERT-A or -B/C
    (B/C with its label conv's gemm), or LXMERT's (l, r, x) stacks; PER_BATCH's counts at the full depths."""
    if model == "lxmert":
        l_, r_, x_ = depth
        n, c = l_ + r_ + 2 * x_, 2 * x_
        return {"attention_block": n, "ffn_block": n, "cross_attention_block": c, "gemm": 4 * n + 3 * c,
                "attn_core": n, "attn_core_cross": c, "layernorm": 2 * n + c}
    conv = 1 if model in ("imagebert_b", "imagebert_c") else 0
    return {"attention_block": depth, "ffn_block": depth, "gemm": 4 * depth + conv, "attn_core": depth,
            "layernorm": 2 * depth}


def train_launches(model: str, depth) -> dict:
    """Launches per training step at any depth (PER_STEP, PER_STEP_B and PER_STEP_LXMERT at the full depths):
    LXMERT's backward skips the last x-layer's visn stream, whose output no loss reads."""
    if model == "lxmert":
        l_, r_, x_ = depth
        n, c = l_ + r_ + 2 * x_, 2 * x_
        return {"attention_block_train": n, "ffn_block_train": n, "cross_attention_block_train": c,
                "attention_block_train_backward": n - 1, "ffn_block_train_backward": n - 1,
                "cross_attention_block_train_backward": c - 1,
                "gemm": 2 * n + 2 * n + 3 * c + 4 * (n - 1) + 4 * (n - 1) + 6 * (c - 1),
                "attn_train": 2 * n - 1, "attn_train_bwd": n - 1, "attn_train_cross": 2 * c - 1,
                "attn_train_cross_bwd": c - 1, "ln_train": 2 * n + c, "ln_train_bwd": 2 * (n - 1) + c - 1}
    per = {k: v * depth // 12 for k, v in PER_STEP.items()}
    if model in ("imagebert_b", "imagebert_c"):
        per["gemm"] += 2  # the label conv's Function, forward and dx
    return per


def tower_launches(side: str) -> dict:
    """Launches per batch of one two-tower embedder on the default route: its TOWER_LAYERS layers, its
    projection's gemm ("f32") and, for the product tower, the label conv's."""
    per = scoring_launches("imagebert_a", TOWER_LAYERS)
    per["gemm"] += 1 + (side == "product")
    return per


def tower_fused_launches(side: str) -> dict:
    """The same with KMR_FUSED_LAYER=1: each layer one fused encoder layer (QKV gemm, attn_core, layer_tail)."""
    return {"encoder_layer": TOWER_LAYERS, "gemm": TOWER_LAYERS + 1 + (side == "product"), "attn_core": TOWER_LAYERS,
            "layer_tail": TOWER_LAYERS}


def tower_breakdown(blocks: dict, towers: dict) -> dict:
    """One 512-row batch of each tower on the device (default route): its layers from their launches timed
    alone, the label conv's and the projection's gemm, and the rest of the measured time (the embeddings and
    their LayerNorm, the mean pooling, the L2 norms, the host's enqueue between launches)."""
    out = {}
    for side, s, conv, count in (("query", TOWER_Q, False, "queries"), ("product", TOWER_P, True, "products")):
        r = {"attention_blocks": TOWER_LAYERS * blocks[f"attention_block S={s} tower"]["ms"],
             "ffn_blocks": TOWER_LAYERS * blocks[f"ffn_block S={s} tower"]["ms"],
             "projection": blocks["gemm_bf16 projection [f32] tower"]["ms"]}
        if conv:
            r["label_conv"] = blocks["gemm_bf16 label conv [f32] tower"]["ms"]
        batches = -(-towers[count] // MAIN_B)
        model = towers["device_ms"][side] / batches
        r["rest"] = model - sum(r.values())
        r["model"] = model
        out[side] = r
    return out


def tower_pair_launches() -> dict:
    """Launches per batch of (query, product) pairs, scored as their cosines (both towers)."""
    return sum_launches((1, tower_launches("query")), (1, tower_launches("product")))


def sum_launches(*parts: tuple[int, dict]) -> dict:
    """(n, launches per batch or step) pairs -> the launches of them all."""
    out: dict[str, int] = {}
    for n, per in parts:
        for name, v in per.items():
            out[name] = out.get(name, 0) + n * v
    return out


# launches per two-tower training step: both towers' layers as ImageBERT-A's train blocks at dropout 0, and the
# label conv's Function (forward and dx); the projections and the contrastive logits are plain products
TOWER_TRAIN = sum_launches((2, train_launches("imagebert_a", TOWER_LAYERS)), (1, {"gemm": 2}))


# ---- phase 10: the data-parallel cases, run on each gloo rank (``--dp-rank``) and on one rank -----------------


def dp_case(torch, rank: int, world: int, seed: int, dev) -> tuple[list[float], dict, list[float]]:
    """DP_TRAIN_STEPS steps of ImageBERT-A at full width (dropout TRAIN_RATE, bf16 kernels, phase 5's schedule)
    on this rank's rows of a TRAIN_B-pair batch from the seed -> (losses, {"init", "grads" (step 1's, averaged
    over the ranks), "params"}: f32 tensors on the CPU by name, ms a step)."""
    from importlib import import_module

    import numpy as np

    models = import_module(f"{PKG}.models")
    train = import_module(f"{PKG}.train")
    batchspec = import_module(f"{PKG}.data.batchspec")
    optim = import_module(f"{PKG}.train.optim")
    spec = models.get_model("imagebert_a")
    tc = dataclasses.replace(train.recipe_for("imagebert_a"), num_warmup_steps=TRAIN_STEPS // 2,
                             num_train_steps=10 * TRAIN_STEPS)
    trainer = train.Trainer(spec, tc, device=dev)
    state = trainer.init_state(spec.init_params(seed))
    batch = batchspec.example_batch("imagebert_a", spec.config, TRAIN_B, np.random.default_rng(seed))
    batch["labels"] = np.random.default_rng(seed + 1).integers(0, 2, TRAIN_B).astype(np.int32)
    rows = TRAIN_B // world
    local = {k: v[rank * rows:(rank + 1) * rows] for k, v in batch.items()}
    names = state.optimizer.names
    out = {"init": {n: p.detach().float().cpu() for n, p in zip(names, state.leaves())}}
    losses, step_ms = [], []
    for step in range(DP_TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        grads, metrics = trainer.grads(state, trainer.to_device(local), seed=100 + step)
        trainer.apply(state, grads)
        losses.append(float(metrics["loss"]))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if step == 0:
            out["grads"] = {n: g.detach().float().cpu() for n, g in zip(names, grads)}
    out["params"] = {name: p.detach().float().cpu() for name, p in optim.flatten_paths(state.params).items()}
    return losses, out, step_ms


def recall_case(torch, rank: int, world: int, seed: int, dev):
    """``recall_sharded`` of 64 queries over a RECALL_ROWS x TOWER_D bf16 catalog from the seed, rows duplicated
    across the shards (ties), k=10 -> (scores, indices); on one rank ``top_k_products`` over the whole catalog."""
    from importlib import import_module

    two_tower = import_module(f"{PKG}.models.two_tower")
    gen = torch.Generator().manual_seed(seed)
    cat = torch.randn(RECALL_ROWS, TOWER_D, generator=gen)
    q = torch.randn(64, TOWER_D, generator=gen)
    cat[RECALL_ROWS - 5:] = cat[:5]  # ties across the shards, in the last shard's tail
    cat[RECALL_ROWS // 2 + 7] = cat[3]
    cat, q = cat.to(dev, torch.bfloat16), q.to(dev)
    if world == 1:
        return two_tower.top_k_products(q, cat, k=10)
    return two_tower.recall_sharded(q, cat, k=10)


def dp_worker(rank: int, port: int, out_dir: str, seed: int) -> int:
    """One of two gloo ranks on the one card: ``dp_case``, then ``recall_case`` (timed); writes
    ``rank<r>.json`` and, on rank 0, the params and the recall."""
    import torch

    sys.path.insert(0, str(REPO))
    from importlib import import_module

    distributed = import_module(f"{PKG}.parallel.distributed")
    distributed.maybe_initialize(f"tcp://localhost:{port}", 2, rank, device="cuda", backend="gloo")
    dev = torch.device("cuda")
    losses, params, step_ms = dp_case(torch, rank, 2, seed, dev)
    recall_case(torch, rank, 2, seed, dev)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scores, indices = recall_case(torch, rank, 2, seed, dev)
    torch.cuda.synchronize()
    recall_ms = (time.perf_counter() - t0) * 1e3
    out = Path(out_dir)
    (out / f"rank{rank}.json").write_text(json.dumps({"losses": losses, "step_ms": step_ms, "recall_ms": recall_ms}))
    if rank == 0:
        torch.save(params, out / "rank0_params.pt")  # {"init", "grads", "params"}
        torch.save({"scores": scores.cpu(), "indices": indices.cpu()}, out / "rank0_recall.pt")
    import torch.distributed as dist

    dist.destroy_process_group()
    return 0


def rank_fidelity(f32, q8, n_queries: int = None, n_products: int = None) -> dict:
    """``tests/test_quant.py``'s rank-fidelity numbers of int8 scores against f32 ones (MID_Q queries of MID_P
    products): per-query Kendall tau, top-5 overlap, and the nDCG@5 loss against the f32 top 5 as answers."""
    from importlib import import_module

    import numpy as np

    evaluate_scores = import_module(f"{PKG}.eval").evaluate_scores
    n_queries, n_products = n_queries or MID_Q, n_products or MID_P
    taus, overlaps, f32_table, q8_table, answers = [], [], {}, {}, {}
    for q in range(n_queries):
        a, b = f32[q * n_products:(q + 1) * n_products], q8[q * n_products:(q + 1) * n_products]
        ii, jj = np.triu_indices(n_products, 1)
        taus.append(float(np.mean(np.sign(a[ii] - a[jj]) * np.sign(b[ii] - b[jj]))))
        top_a, top_b = np.argsort(-a)[:5], np.argsort(-b)[:5]
        overlaps.append(len(set(top_a) & set(top_b)) / 5)
        f32_table[str(q)] = {str(p): float(a[p]) for p in range(n_products)}
        q8_table[str(q)] = {str(p): float(b[p]) for p in range(n_products)}
        answers[str(q)] = [str(p) for p in top_a]
    return {"mean_tau": float(np.mean(taus)), "min_tau": float(np.min(taus)), "mean_top5": float(np.mean(overlaps)),
            "min_top5": float(np.min(overlaps)),
            "ndcg_delta": evaluate_scores(f32_table, answers) - evaluate_scores(q8_table, answers)}


def fidelity_met(r: dict) -> bool:
    """``tests/test_quant.py``'s thresholds."""
    return (r["mean_tau"] >= 0.98 and r["min_tau"] >= 0.95 and r["mean_top5"] >= 0.95 and r["min_top5"] >= 0.8
            and r["ndcg_delta"] <= 0.01)


def main(argv: list[str] | None = None) -> int:
    import argparse

    import torch

    args = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    args.add_argument("--seed", type=int, default=SEED, help="seed of the inputs, data and weights")
    # phase 10 starts two gloo ranks of this script on the card
    args.add_argument("--dp-rank", type=int, default=None, help=argparse.SUPPRESS)
    args.add_argument("--dp-port", type=int, default=None, help=argparse.SUPPRESS)
    args.add_argument("--dp-out", default=None, help=argparse.SUPPRESS)
    parsed = args.parse_args(argv)
    seed = parsed.seed

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    try:
        from importlib import import_module

        build = import_module(f"{PKG}.ops._build")
    except ImportError as e:
        print(f"chip_smoke: the port package is not beside this script ({e})", file=sys.stderr)
        return 2
    if parsed.dp_rank is not None:
        return dp_worker(parsed.dp_rank, parsed.dp_port, parsed.dp_out, seed)
    try:
        t_run = time.perf_counter()
        log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
        t0 = time.perf_counter()
        logs = build.build_all()
        log(f"build: {time.perf_counter() - t0:.1f} s for {list(build.SOURCES)}")
        (build.BUILD_DIR / "kernels" / "nvcc.log").write_text(
            "\n".join(f"--- {n} ---\n{t}" for n, t in logs.items()))
        for name, text in logs.items():
            for line in ptxas_summary(text):
                log(f"ptxas {name}: {line}")
        mha_lib = build.load("mha")
        log("mha dynamic shared memory: bf16 " + ", ".join(
            f"{mha_lib.kmr_mha_smem_bytes(s, 1)} B at S={s}" for s in (S, B_S, 64))
            + f" a CTA of {mha_lib.kmr_mha_warps()} warps; f32 {mha_lib.kmr_mha_smem_bytes(S, 0)} B a CTA at S={S}")
        at_lib = build.load("attn_train")
        log("attn_train dynamic shared memory: " + ", ".join(
            f"S={s} forward {at_lib.kmr_attn_train_smem_bytes(s, s, 0)} B, backward "
            f"{at_lib.kmr_attn_train_smem_bytes(s, s, 1)} B" for s in (LX_T, LX_F, S, 64))
            + f"; the forward a CTA of {at_lib.kmr_attn_train_fwd_warps()} warps, the backward a CTA a (pair, head)")

        smoke = Smoke(torch, seed)
        weights = smoke.layer_weights()
        smoke.check_kernels(weights)
        smoke.check_lxmert_kernels(weights)
        smoke.check_layer_kernels(weights)
        smoke.check_mha_kernels()
        if smoke.failures:
            raise RuntimeError(f"kernels disagree with their plain versions: {smoke.failures}")
        times = smoke.time_kernels(weights)
        times.update(smoke.time_lxmert_kernels(weights))
        times.update(smoke.time_layer_kernels(weights))
        times.update(smoke.time_mha_kernels())
        times.update(smoke.time_path_shapes(weights))
        if smoke.failures:
            raise RuntimeError(f"kernels disagree with their plain versions: {smoke.failures}")
        depth_rules = [(scoring_launches("imagebert_a", 12), PER_BATCH["imagebert_a"]),
                       (scoring_launches("imagebert_b", 12), PER_BATCH["imagebert_b"]),
                       (scoring_launches("lxmert", LX_DEPTHS), PER_BATCH["lxmert"]),
                       (train_launches("imagebert_a", 12), PER_STEP), (train_launches("imagebert_b", 12), PER_STEP_B),
                       (train_launches("lxmert", LX_DEPTHS), PER_STEP_LXMERT)]
        if any(got != want for got, want in depth_rules):
            raise RuntimeError("the launch counts at any depth disagree with the full-depth tables")
        per_path = {"imagebert_a": PER_BATCH["imagebert_a"]["gemm"], "imagebert_b": PER_BATCH["imagebert_b"]["gemm"],
                    "lxmert": PER_BATCH["lxmert"]["gemm"], "imagebert_a_train": PER_STEP["gemm"],
                    "imagebert_b_train": PER_STEP_B["gemm"], "lxmert_train": PER_STEP_LXMERT["gemm"],
                    "two_tower": tower_pair_launches()["gemm"], "two_tower_train": TOWER_TRAIN["gemm"]}
        if gemm_site_launches() != per_path:
            raise RuntimeError(f"gemm sites launch {gemm_site_launches()} a batch or step, the paths {per_path}")
        smoke.time_gemm_sites()
        if smoke.failures:
            raise RuntimeError(f"gemm_bf16 disagrees with gemm_plain at a site: {smoke.failures}")
        log(json.dumps({"gemm_enqueue_us": smoke.gemm_enqueue_us()}))
        launches, n_batches, rates = smoke.score_main_path()
        expected = expected_launches(n_batches, PER_BATCH["imagebert_a"])
        if launches != expected or n_batches == 0:
            raise RuntimeError(f"main path launches {launches}, expected {expected}")
        log(json.dumps({"end_to_end": rates}))
        lx_launches, lx_batches, lx_rates = smoke.score_lxmert()
        for route, counts in lx_launches.items():
            expected = expected_launches(lx_batches, PER_BATCH[route])
            if counts != expected or lx_batches == 0:
                raise RuntimeError(f"{route} launches {counts}, expected {expected}")
        log(json.dumps({"end_to_end_lxmert": lx_rates}))
        log(json.dumps({"lxmert_device_ms_per_batch": lxmert_breakdown(times, lx_rates, lx_batches)}))
        b_launches, b_batches, b_rates = smoke.score_imagebert_b()
        for run, counts in b_launches.items():
            expected = expected_launches(b_batches, PER_BATCH[run])
            if counts != expected or b_batches == 0:
                raise RuntimeError(f"{run} launches {counts}, expected {expected}")
        log(json.dumps({"end_to_end_imagebert_b": b_rates}))
        log(json.dumps({"imagebert_b_device_ms_per_batch": imagebert_b_breakdown(times, b_rates, b_batches)}))
        a_launches, a_batches, a_rates = smoke.score_imagebert_a_backends()
        for run, counts in a_launches.items():
            n = 1 if run.startswith("imagebert_a_export") else a_batches
            expected = expected_launches(n, PER_BATCH[run])
            if counts != expected or a_batches == 0:
                raise RuntimeError(f"{run} launches {counts}, expected {expected}")
        log(json.dumps({"end_to_end_backends": a_rates}))
        log(json.dumps({"backends_device_ms_per_batch": backends_breakdown(times, a_rates, a_batches, b_rates,
                                                                            b_batches)}))
        packed = smoke.drive_mha_packed()
        if packed != expected_launches(1, PER_BATCH["mha_packed_entry"]) or smoke.failures:
            raise RuntimeError(f"mha_packed entry point: launches {packed}, failures {smoke.failures}")
        smoke.check_train_kernels()
        if smoke.failures:
            raise RuntimeError(f"train kernels disagree with their plain versions: {smoke.failures}")
        times.update(smoke.time_train_kernels())
        if smoke.failures:
            raise RuntimeError(f"train blocks disagree with their plain oracles: {smoke.failures}")
        train_runs, train_rates = smoke.train_imagebert_a()
        expected = expected_launches(TRAIN_STEPS, PER_STEP)
        if train_runs["imagebert_a_train"] != expected:
            raise RuntimeError(f"imagebert_a_train launches {train_runs['imagebert_a_train']}, expected {expected}")
        log(json.dumps({"train_imagebert_a": train_rates}))
        b_train_launches, b_train_rates = smoke.train_imagebert_b()
        expected = expected_launches(TRAIN_STEPS, PER_STEP_B)
        if b_train_launches["imagebert_b_train"] != expected:
            raise RuntimeError(f"imagebert_b_train launches {b_train_launches['imagebert_b_train']}, "
                               f"expected {expected}")
        log(json.dumps({"train_imagebert_b": b_train_rates}))
        smoke.check_cross_train_kernels()
        if smoke.failures:
            raise RuntimeError(f"cross train kernels disagree with their plain versions: {smoke.failures}")
        times.update(smoke.time_cross_train_kernels())
        if smoke.failures:
            raise RuntimeError(f"the train cross block disagrees with its plain oracle: {smoke.failures}")
        lx_train_launches, lx_train_rates = smoke.train_lxmert()
        expected = expected_launches(TRAIN_STEPS, PER_STEP_LXMERT)
        if lx_train_launches != expected:
            raise RuntimeError(f"lxmert_train launches {lx_train_launches}, expected {expected}")
        log(json.dumps({"train_lxmert": lx_train_rates}))
        ot_launches, ot_batches, ot_rates = smoke.one_shot()
        for path, counts in ot_launches.items():
            expected = expected_launches(ot_batches, PER_BATCH["imagebert_a"])
            if counts != expected or ot_batches == 0:
                raise RuntimeError(f"{path} launches {counts}, expected {expected}")
        log(json.dumps({"one_shot": ot_rates}))
        di_launches, di_rates = smoke.import_and_distil()
        log(json.dumps({"import_and_distil": di_rates}))
        tt_launches, tt_rates = smoke.two_tower()
        log(json.dumps({"two_tower": tt_rates}))
        torch.cuda.empty_cache()  # phase 10's subprocesses share the card
        t_phase10 = time.perf_counter()
        q8_launches, q8_rates = smoke.int8_serving()
        log(json.dumps({"int8_serving": q8_rates}))
        dp_launches, dp_rates = smoke.data_parallel()
        log(json.dumps({"data_parallel": dp_rates}))
        util_rates = smoke.utilities()
        log(json.dumps({"utilities": util_rates}))
        log(f"phase 10: {time.perf_counter() - t_phase10:.1f} s")
        ob_launches, ob_rates = smoke.orbax_checkpoints()
        log(json.dumps({"orbax_checkpoints": ob_rates}))
        all_launches = {"imagebert_a": launches, **lx_launches, **b_launches, **a_launches,
                        "mha_packed_entry": packed, **train_runs, **b_train_launches,
                        "lxmert_train": lx_train_launches, **ot_launches, **di_launches, **tt_launches,
                        **q8_launches, **dp_launches, **ob_launches}
        line = kernel_line(times, all_launches, smoke.errors)
        unlaunched = [kr["name"] for kr in line["kernels"] if kr["launches"] == 0]
        if unlaunched:
            raise RuntimeError(f"kernels never launched on a driven path: {unlaunched}")
        log(json.dumps(line))
        log(f"chip_smoke: {time.perf_counter() - t_run:.1f} s for phases 1-11, the build included")
        log(f"nvidia-smi: {nvidia_smi()}")
    except Exception:  # any phase failing fails the run, with its traceback
        traceback.print_exc()
        return 1
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
