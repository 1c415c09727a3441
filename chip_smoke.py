#!/usr/bin/env python3
"""On-card gates of abcnet_tpu_torch on one GPU, and the kernel-alone
times: the one microbenchmark of the port. Whole-program rates belong to
the benchmark (BENCHMARK.json, benchmark/run.py), not to this script.

    python3 chip_smoke.py        # from the root of a checkout, one card

Drives the port's serving path (bit pack, unpack kernel, production U-Net
on the step-43100 snapshot, NMS/top-K kernel, sparse heads, packed
transport, host assembly, scoring) on the 64-molecule fixture
abcnet_tpu_torch/assets/smoke_step43100.npz, its training path on the
same molecules (abcnet_tpu_torch/assets/train_step43100.npz: their label
strings and the JAX package's f32 eval losses on the first 16), and every
other entry point of the port, and prints one JSON line per phase, in
this order:

  1. environment: the card, its power limit and maximum SM clock, the
     kernel and assembler builds (all compilers started at once), ptxas's
     registers and spills, and the counts of the noise kernel's
     instructions by opcode (cuobjdump -sass);
  2. device_guard: every kernel wrapper on the last visible GPU while GPU
     0 is current, bit-equal to its plain version, bn_act within its
     tolerances (on a one-GPU machine it says so: "gpus": 1);
  3. kernels_vs_plain: the kernels against their plain PyTorch versions
     on the card, bit-equal (unpack on random and fixture bits; the noise
     kernel on twelve cases; NMS/top-K on random, plateau, threshold,
     edge, constant and below-threshold maps, on maps that try the seams
     between the kernel's bands of rows, K = 128 and 160, on an odd shape
     and on K = H*W, f32 and bf16, every cluster size, both heatmaps in
     one launch against two plain calls, and the fixture's real heatmaps
     from one bf16 forward of the snapshot, alone and as a pair); bn_act,
     the train-mode conv bias -> BatchNorm -> activation -> cast, forward
     and backward against bn_act_plain at the inc1, down5, head and
     fused-head-bank shapes of a batch of 64, bf16 and f32, each
     activation, without and with a conv bias (its gradient within a
     stated absolute bound, and on gradients that do not cancel against a
     float64 sum), within stated tolerances, and four of them on four
     streams at once bit-equal to each alone; bn_act_eval, serving's conv
     bias -> BatchNorm -> activation -> cast, against bn_act_eval_plain at
     every BatchNorm shape of sparse serving at batch 64 and the fused
     bank's, bf16 and f32, with the snapshot's statistics and with random
     ones, and on contiguous NCHW, bit-equal (else within one bf16 ulp,
     f32 two, counted), then the fixture served through it against the
     same serving through bn_act_eval_plain; conv_s8 at the int8
     backbone's 28 site shapes of batch 64 and on the quantize's rounding
     sweeps, bit-equal;
  4. serving_f32 (TF32 off): SMILES against the JAX package's f32 SMILES,
     gate >= 62/64;
  5. serving_bf16, the production setting, through the CLI's serving loop
     at batch 64, with the kernels' launch counts set to 0 just before and
     read just after (one unpack, one NMS and 28 bn_act_eval launches):
     exact match against the truth next to the TPU's, gate port >= TPU -
     3/64;
  6. cbam_gate_sites: the CBAM gate's kernels against the stock chain at
     the 13 site shapes of a batch of 64, each site's share of differing
     elements and their size gated, and each site's times (the kernels,
     the stock chain, the byte bound); cbam_serving: a seeded CBAM U-Net
     served through make_infer_pipeline under a profile, 13 cbam_gates
     and 13 cbam_fused a batch, three kernels a site inside the cbam
     spans and no stock reduction there, and 4 stem_sites and 4
     stem_fused a batch; stem_conv_sites: the CBAM stem's conv kernel
     against the plain chain (stem_conv_bn_act_eval_plain) and the stock
     chain (cuDNN's conv, then bn_act_eval) at its four 5x5 sites of a
     batch of 64 on the fixture's activations through a seeded CBAM U-Net
     whose stem BatchNorms hold moved statistics, each site's share of
     differing elements and their size gated, and each site's times (the kernel, the plain chain, the
     stock chain, the bound);
     dcn_sites: the DLA-34 + DCN model's deformable columns kernel
     against the plain op at its 16 sites of a batch of 64, on the
     fixture's activations through a seeded model (its BatchNorms
     recalibrated by the plain reference, offsets of about a pixel), the
     columns and the site's output each gated, and each site's times (the
     op, the plain op, the bound from benchmark/counts_dla.py);
     dcn_serving: that model served through make_infer_pipeline under a
     profile, 16 dcn_sites and 16 kernel launches a batch;
  7. train_f32: `eval_step` in f32 (TF32 off) on the snapshot weights
     against the JAX losses, per term, relative 1e-3;
  8. train_bf16: the production setting (bf16, batch 64, full width) from
     a seeded random init, TRAIN_STEPS steps through `fit` on the raw
     samples (geometric augment, collate, prefetch, noise kernel,
     targets, forward, losses, backward, Adam, the sampled metrics step,
     one evaluation), launch counts set to 0 before and read after; then
     the weights go through save_snapshot/load_snapshot and the serving
     pipeline decodes the fixture with them;
  9. bn_act_shapes and kernel_times, the kernel-alone times: each kernel
     and its plain version at the shapes of a batch of 64 (median of 25
     CUDA-event timings, each launched behind a sleep kernel so the
     host's launch overhead is not timed; the NMS kernel on the fixture's
     real heatmaps and on random maps, which take its sorting route),
     beside the bound from the bytes each must move or the integer
     instructions it must run (bn_act with the conv bias, beside the
     chain it replaces, and bn_act_eval at the inc1 shape; line
     bn_act_shapes: each bn_act kernel at every BatchNorm shape of the
     train step; the CBAM gate's row from cbam_gate_sites, the stem
     conv's from stem_conv_sites);
 10. conv_bias_fold: the train step with the conv bias folded into bn_act
     against the routing before the fold (the conv adds its bias, its
     gradient a separate sum), a trace of each: at least one aten::add_
     and one aten::sum call fewer a step a BatchNorm;
 11. bn_act_step: one train_step at batch 64 from the snapshot through
     bn_act's kernels and through bn_act_plain (which adds the conv bias
     in front: the routing before the fold, bit for bit), same batch and
     generator seed: in f32 (TF32 off) losses per term 1e-3 and the
     gradient tree 1e-2 relative L2; in bf16 within the floor the run
     measures (the plain step against itself on the reversed batch); the
     conv bias handed to every BatchNorm on both;
 12. mesh_serving: make_infer_pipeline over every visible GPU (four row
     blocks on a one-GPU machine), peak dicts bit-equal to the unsharded
     pipeline on each row block, SMILES against the whole batch;
 13. multiproc_serving: two ranks of a process group (NCCL on two GPUs,
     or both on the one card over gloo), each serving its 32 rows of the
     fixture batch through make_infer_pipeline(mesh=the rank's mesh) and
     assembling them in its own pool; rank 1 moves one statistic of its
     weights, which the pipeline's replication from rank 0 undoes; peak
     dicts bit-equal to the unsharded pipeline on each rank's row block,
     SMILES against the whole batch, launches per rank;
 14. conv_s8_sites and quant_serving: prepare_quant on the snapshot,
     calibrated on 32 fixture images, the 64 molecules served through the
     int8 backbone; exact match beside bf16, peak dicts and SMILES equal
     to the plain int8 backbone's, the int8 backbone's time against the
     bf16 trunk's, each conv_s8 site's time (line conv_s8_sites), int32
     accumulators against a float64 conv on the card;
 15. variants (bf16, 512², batch 64, seeded init): UNetS2D and UNetCBAM
     take 5 train steps each, S2D also serves; fused_head_bank and
     remat_blocks beside the plain UNet, first-step losses against it;
     the fused bank's eval forward through bn_act_eval's kernel against
     bn_act_eval_plain, bit-equal;
 16. ddp_train: two ranks of data-parallel training (NCCL on two GPUs, or
     both ranks on the one card over gloo), full width at 512²: the first
     f32 step at global batch 16 against one process at batch 16 on the
     same images (losses, gradients, running statistics), then bf16 at
     global batch 64 through `fit` for 10 steps, ranks bit-equal;
 17. generator (no GPU work): the port's molecule generator on the card's
     host makes the JAX package's data: the two held-out pools of
     final_eval (seeds 777001 rdkit, 777002 indigo, 256 each) against the
     512 truths of logs/final_eval_step43100.csv, the first 32 of each
     against the fixtures' label strings, SMILES and drawings (images
     reported as bit-equal counts and differing-pixel shares, with the
     Pillow and FreeType versions), every (mode, engine) stream and the
     corpus mode against assets/gen_digests.npz;
     data.pipeline.generate_examples over a spawn pool of 4 against the
     serial concatenation of its chunks and the JAX package's list
     (assets/examples_digests.npz);
 18. final_eval: the n=256 evaluation (eval/final_eval.py) in bf16 on the
     snapshot over those pools: heatmap metrics per lineage, exact /
     exact_canonical / dice / decode rate per lineage and overall with
     the sub-cell and the integer-cell assembler, row-by-row agreement
     with the TPU's smiles_pred; gates: overall exact >= the TPU's 0.8379
     - 0.02, decode rate >= 0.99, one unpack and one NMS launch per
     serving batch; then final_eval_failure_buckets: eval.classify_results
     and eval.failure_taxonomy (host only) on the run's answers, written
     as a results CSV (buckets sum to n, `ok` = the isomeric hits of
     score_pairs, the taxonomy holds every struct miss, no launch), and
     on logs/final_eval_step43100.csv, each printout's sha256 equal to
     the JAX script's (FAILURE_BUCKET_DIGESTS);
 19. cli_loop, through the port's main() in a temporary directory: gen ->
     train --synthetic -> img2smiles -> test-acc -> cal-acc on the
     results CSV and on a copy with InChI truths; img2smiles and test-acc
     --ckpt of the checkpoint directory train wrote, their peak dicts and
     counts against the module fit left in memory; then test-acc's counting
     in f32 (TF32 off) on fixture rows 0-15 against the JAX package's
     counts (assets/test_acc_step43100.npz);
 20. bench_record, bench_train and bench: `python -m abcnet_tpu_torch
     bench` (sparse, then its train steps at the default --train-batch,
     128, the JAX bench's) and `bench --dense --skip-train` through the
     CLI's main(), each record printed, then the bench's train steps
     alone at 128 and at 64 (paths `bench_sparse`, `bench_dense`,
     `bench_train`, `bench_train_64`); gates: exit 0 and no error, the
     rates finite and > 0, implied TFLOP/s <= the H100's 989, one unpack
     and one NMS launch per call of the serving program, one noise launch
     and four bn_act launches a BatchNorm per train step, the train steps'
     peak memory <= 64 GiB at 128 and <= 30 GiB at 64, the default
     snapshot's weights in the records, and the bench's program on the
     clean-carry batch of buffer 0 bit-equal to make_infer_pipeline on its
     images;
 21. eval_decode_ceiling, eval_degraded_bench, eval_cross_engine,
     eval_e2e_overfit and eval_suite: the README's four evaluation entry
     points through their main(argv), each path's launches read from its
     own run: eval.decode_ceiling 150 1000 (>= 149/150 a mode, one NMS
     launch a sample, buckets and failures equal to the port's CPU run on
     the first 30 samples a mode), eval.degraded_bench 128 (clean decode
     >= 0.95 and exact >= the TPU's 0.75 - 8/128, gray scan at threshold
     0.2 above its 0.6 control, one unpack and one NMS launch a batch,
     each variant's first batch bit-equal to make_infer_pipeline at its
     threshold; the table beside the TPU's), eval.cross_engine_eval 128
     (pools aligned, eval-on-a exact >= the TPU's 0.9766 - 8/128, decode
     >= 0.99), eval.e2e_overfit 64 75 (300 steps at batch 16: loss finite
     and falling, exit code 0 iff the printed exact > 0, one noise launch
     a step);
 22. recipe_pool_r5, recipe_train_r5, recipe_checkpoint_start,
     recipe_finetune_robust, recipe_finetune_hard and recipe: the
     production training recipe's four entry points through their
     main(argv) in a temporary directory, each path's launches read from
     its own run (`pool_r5`, `train_r5`, `finetune_robust`,
     `finetune_hard_mine`, `finetune_hard`): train.build_pool_r5 with 512
     train rows (the 256 eval rows and the first 256 train rows against
     assets/pool_r5_digests.npz: labels, SMILES, lineage, engine, engine B
     images bit-equal, engine A ink masks of 16 rows within 1% of pixels);
     train.train_r5 for 75 s with a 75-s budget from a seeded init (the
     three learning rates in order, loss finite, EVAL keys, the
     checkpoint, the float16 snapshot stored by its rule, its fixture
     SMILES reported beside the run's weights', the commit logged, one
     noise launch a train and a metrics step); recipe.finetune_state at
     batch 128 from that checkpoint directory (its step and every
     optimizer-state tensor bit-equal to the file's, not a resume, no
     launch; freed again); the committed snapshot's own EVAL and FINAL
     numbers on the eval split; train.finetune_robust (64-row engine B
     pool; the float16 snapshot of the weights it trained serves their
     SMILES) and train.finetune_hard (mined set against the phase's own
     count of misses, the cache read again) at batch 128 with the plain
     step for about 40 s each, gated against the snapshot's numbers less
     0.05;
 23. script (the whole run's seconds), the card line of nvidia-smi, then
     the kernels line (the kernel_times rows, conv_s8's from
     conv_s8_sites, each with `launches_by_path`), then the result.

Every new path is driven with the kernels' launch counts set to 0 just
before it and read just after (`launches_by_path` of the kernels line).
`--phases a,b` runs the environment phase, bf16 serving and the named
phases only (for iterating on the card; `kernels` names
kernels_vs_plain); with no arguments every phase runs.

Exits non-zero on any failed phase, and without a result when there is
no CUDA device or no abcnet_tpu_torch package beside the script.
"""

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
BATCH = 64
REPS = 25
SLEEP_CYCLES = 4_000_000          # ~2 ms at H100 clocks, hides the launch
HBM_BYTES_PER_S = 3.35e12         # H100 SXM (data sheet)
F32_OPS_PER_S = 67e12             # H100 SXM, float32 outside tensor cores
# The noise kernel's arithmetic is 32-bit integer work. An SM of compute
# capability 9.0 executes 64 such instructions a clock (integer add, multiply
# and logic rows of the arithmetic-throughput table in NVIDIA's CUDA C++
# programming manual), half its 128 f32 lanes; the card has 132 SMs and its
# maximum SM clock is read from nvidia-smi (clocks.max.sm).
SMS = 132
INT32_LANES_PER_SM_CLOCK = 64
# The least integer instructions unpack + noise needs per packed byte (4
# Philox4x32-10 calls on counters that differ in their draw number only):
#   rounds 3-10 of the 4 calls, 2 wide multiplies + 2 three-input xors each
#   round 1: the multiply by the byte index, shared; 4 xors
#   round 2: 4 multiplies (the 4 draws still share one counter word), 7 xors
#   18 round-key additions, shared by the 4 calls
#   8 pixels x (2 compares + 2 logic operations)
#   8 pixels x 1 to select and pack the output value
NOISE_OPS_PER_BYTE = 8 * 4 * 4 + (1 + 4) + (4 + 7) + 18 + 8 * 4 + 8
# bn_act (ops/bn_act.py, csrc/bn_act.cu) against bn_act_plain on the card
# at the shapes the production step gives it at batch 64: inc1, down5, a
# head's OutConv, the fused head bank; bf16 and f32, each activation,
# forward and backward. Both sides compute in f32 and round alike; the
# order of the sums differs, and so do the statistics in their last bits.
#   * batch mean within 1e-5 of the channel's root mean square, biased
#     variance 1e-5 relative (both sides are also read against float64);
#   * bf16: y within one bf16 ulp of the plain value (with a floor of 1e-6
#     of the tensor's largest value: near 0 the two f32 pre-activations'
#     last bits exceed a bf16 ulp, and a relu may cut one and pass the
#     other); dx 1e-2 relative L2;
#   * f32: y within 1e-6 of the tensor's largest value; dx 1e-4
#     relative L2 where the two sides' activation masks agree,
#     and the masks may differ only at ties, |pre| <= 1e-5 of the largest
#     (a flipped element changes dx by its whole dy, so flips at the
#     1e-7 level would alone give a relative L2 near 3e-4);
#   * dgamma and dbeta 1e-3 relative L2.
BN_EPS = 1e-5
BN_ACT_SHAPES = {"inc1": (BATCH, 16, 512, 512),
                 "down5": (BATCH, 512, 16, 16),
                 "head": (BATCH, 128, 128, 128),
                 "head_bank": (BATCH, 1024, 128, 128)}
BN_STAT_REL, BN_Y_REL, BN_DPARAM_REL, BN_TIE_REL = 1e-5, 1e-6, 1e-3, 1e-5
BN_DX_REL = {"bfloat16": 1e-2, "float32": 1e-4}
# Every case runs without and with a conv bias (random, of x's type). The
# conv bias gradient through a batch-statistics BatchNorm is 0 in exact
# arithmetic, so both sides return rounding residue: it is held to an
# absolute bound per channel, BN_DCB_SUM_REL[type] * sum|dx_plain|. The
# two sides' dx elements are each x's type's rounding of f32 values a few
# f32 ulps apart: 2u apart at most (u = 2^-8 in bf16, 2^-24 in f32); each
# side's f32 sum of its dx is within L * 2^-24 * sum|dx| of the exact one,
# L its longest chain of serial additions, which 2^-13 covers for both
# together (L <= 4096 a side; the kernel's is at most chunk / rows + 8,
# 339 at batch 64); each side's final rounding to x's type adds at most u
# * |its sum| <= u * sum|dx|. Sum: 4u + 2^-13 (4u covers the rounding
# twice over, f32's 4 * 2^-24 the ulps of the f32 values).
# That bound cannot see a lost block partial (a chunk's sum of dx is far
# below it), so (d)'s sum is also held where it does not cancel: with the
# backward's two sums replaced by zeros and dy moved by +1, dx = gamma *
# invstd * g with g of one sign where the activation passes it, and the
# kernel's bias gradient is held to the float64 sum of the dx it wrote,
# within u * |that sum| + 2^-13 * sum|dx| (its final rounding and its f32
# chains, as above); a lost or doubled partial of one of P <= 1056 chunks
# moves the sum by ~1/P of it, which the f32 cases see (u = 2^-24) and
# the bf16 ones where P < 256 (at batch 64 down5, head and the head
# bank, not inc1): each case reports P and whether its bound is below 1/P
# of every channel's sum, and each type needs one case that is.
BN_DCB_SUM_REL = {"bfloat16": 4 * 2 ** -8 + 2 ** -13,
                  "float32": 4 * 2 ** -24 + 2 ** -13}
BN_DCB_CHAIN_REL = 2 ** -13
BN_UNIT_ROUNDOFF = {"bfloat16": 2 ** -8, "float32": 2 ** -24}
# The least f32 operations an element of bn_act's forward and backward:
# the statistics 3 (subtract, multiply-add, add), the apply 3 (subtract,
# multiply-add, activation), the backward sums 7 (the pre-activation 2,
# the mask 1, xhat 2, two accumulations), the backward apply 6 (the
# pre-activation 2, the mask 1, xhat 1, two multiply-adds), the conv bias
# 3 (its add in the forward and in the backward, the accumulation of its
# gradient).
BN_ACT_OPS_PER_ELEMENT = 3 + 3 + 7 + 6 + 3
# bn_act_step: one train_step at batch 64 from the snapshot through the
# kernels and through bn_act_plain, same batch and generator seed. f32
# (TF32 off): losses per term 1e-3 relative, the gradient tree 1e-2
# relative L2. bf16 cannot be held to those: every bf16 BatchNorm output
# rounds its f32 value, and a last-bit difference in the statistics flips
# some roundings, which the next layers carry on until each activation
# differs by about one bf16 rounding. The plain step against itself on the
# batch in reversed row order (the same math, the sums in another order)
# differed by 2.6e-3 in its largest loss term and 3.6e-2 in the gradient
# tree on an H100 (PERF.md §6). The bf16 comparison is held to that
# floor, measured again in each run: its largest term within 3x the
# floor's, its tree within 2x.
BN_STEP_LOSS_REL, BN_STEP_GRAD_REL = 1e-3, 1e-2
BN_STEP_FLOOR_LOSS, BN_STEP_FLOOR_GRAD = 3.0, 2.0
# The train step's BatchNorms by shape at batch 64 (channels, side,
# activation, how many of the production UNet's 34 have it), where
# kernel_times times each kernel of bn_act (line `bn_act_shapes`).
BN_STEP_SHAPES = {"inc1_inc2": (16, 512, "relu", 4),
                  "down1": (32, 256, "relu", 2),
                  "down2_inc3": (64, 128, "relu", 4),
                  "down3_up2": (128, 64, "relu", 4),
                  "down4_up1": (256, 32, "relu", 4),
                  "down5": (512, 16, "relu", 2),
                  "up3_dconv": (128, 128, "relu", 6),
                  "heads": (128, 128, "leaky_relu", 8)}
# Least bytes of each, in units of x's size: (a) reads x; (b) reads x and
# writes y; (c) reads x and dy; (d) reads x and dy and writes dx; the op
# (all four) reads x, writes y, reads x and dy, writes dx.
BN_STEP_BYTES = {"a_stats": 1, "b_apply": 2, "c_grad_sums": 2,
                 "d_grad_apply": 3, "op": 5}
# bn_act_eval (ops/bn_act.py, csrc/bn_act.cu kernel (e)): eval-mode conv
# bias -> BatchNorm -> activation -> cast. Its launches in one eval forward,
# one a BatchNorm the forward runs: the production UNet's sparse serving
# (13 DoubleConvs x 2 + the two heatmap heads) and dense forwards (every
# head: eval_step, the metrics step, test-acc, --dense), the fused head
# bank (one BatchNorm for the eight heads), UNetS2D (its two stem
# DoubleConvs in place of the production stem's five).
EVAL_BN = {"sparse": 28, "dense": 34, "fused_bank": 27, "s2d_sparse": 22}
# The least f32 operations an element of bn_act_eval: the bias add, the
# multiply-add, the activation.
BN_EVAL_OPS_PER_ELEMENT = 3
# Its cases on the card: every distinct BatchNorm shape of sparse serving
# at batch 64 and the fused bank, with the snapshot's running statistics,
# weights and conv bias of a BatchNorm of that shape (the bank's are its
# eight heads' side by side) and with random ones. The kernel pins the
# roundings of the chain it replaced, so the tolerance is bit-equality.
BN_EVAL_SHAPES = {"inc1": ((BATCH, 16, 512, 512), "relu", "inc1.bn0"),
                  "down1": ((BATCH, 32, 256, 256), "relu",
                            "down1.double_conv.bn0"),
                  "down2": ((BATCH, 64, 128, 128), "relu",
                            "down2.double_conv.bn0"),
                  "down3": ((BATCH, 128, 64, 64), "relu",
                            "down3.double_conv.bn0"),
                  "down4": ((BATCH, 256, 32, 32), "relu",
                            "down4.double_conv.bn0"),
                  "down5": ((BATCH, 512, 16, 16), "relu",
                            "down5.double_conv.bn0"),
                  "dconv1": ((BATCH, 128, 128, 128), "relu", "dconv1.bn0"),
                  "head": ((BATCH, 128, 128, 128), "leaky_relu",
                           "out_atom_target.bn0"),
                  "head_bank": ((BATCH, 1024, 128, 128), "leaky_relu",
                                None)}
TRAIN_STEPS = 30                  # steps of the train_bf16 phase
TRAIN_LOSS_FRACTION = 0.5         # gate: last total < this x first total
EVAL_REL_TOL = 1e-3               # train_f32: per loss term against JAX
# ddp_train, f32 step of two ranks against one process at batch 16 (TF32
# off, the snapshot weights, noise and dropout off). Only the order of the
# sums differs: losses and running statistics to 1e-4 relative; gradients
# by the relative L2 error of each leaf and of the whole tree. A train-mode
# BatchNorm backward amplifies the f32 order of the sums
# (tests/test_torch_parallel.py: up to 1.6e-2 on the CPU); on an H100 the
# first run measured 5.8e-4 and 2.6e-4, and the gates keep a tenfold margin.
DDP_LOSS_REL, DDP_STAT_REL = 1e-4, 1e-4
DDP_GRAD_LEAF, DDP_GRAD_TREE = 1e-2, 5e-3
DDP_BATCH_F32, DDP_BATCH_BF16, DDP_STEPS = 16, 64, 10
VARIANT_STEPS = 5
# fused head bank vs per-head, first-step losses in bf16: one 128->1024
# conv against eight 128->128 convs may round the bf16 logits differently.
FUSED_LOSS_REL = 2e-2
# int8 serving: the TPU's int8 run lost 1.2 points of exact match on 256
# rows (logs/quant_r5.log); 4 of 64 rows allow that and near-tie flips.
QUANT_EXACT_SLACK = 4 / 64
# conv_s8 (ops/conv_s8.py, csrc/conv_s8.cu): the 28 3x3 sites of
# forward_quant on a 512² image (abcnet_tpu/models/unet.py:178-198), in
# forward order: (key, H = W, C_in, C_out, act, out type). Tolerance:
# bit-equal to conv3x3_s8_plain (the kernel pins the chain's roundings).
CONV_S8_SITES = (
    ("inc1.0", 512, 1, 16), ("inc1.1", 512, 16, 16),
    ("inc2.0", 512, 16, 16), ("inc2.1", 512, 16, 16),
    ("down1.0", 256, 16, 32), ("down1.1", 256, 32, 32),
    ("down2.0", 128, 32, 64), ("down2.1", 128, 64, 64),
    ("inc3.0", 128, 64, 64), ("inc3.1", 128, 64, 64),
    ("down3.0", 64, 64, 128), ("down3.1", 64, 128, 128),
    ("down4.0", 32, 128, 256), ("down4.1", 32, 256, 256),
    ("down5.0", 16, 256, 512), ("down5.1", 16, 512, 512),
    ("up1.0", 32, 512, 256), ("up1.1", 32, 256, 256),
    ("up2.0", 64, 256, 128), ("up2.1", 64, 128, 128),
    ("up3.0", 128, 128, 128), ("up3.1", 128, 128, 128),
    ("dconv1.0", 128, 128, 128), ("dconv1.1", 128, 128, 128),
    ("dconv2.0", 128, 128, 128), ("dconv2.1", 128, 128, 128),
    ("y:atom_target", 128, 128, 128), ("y:bond_target", 128, 128, 128))
INT8_OPS_PER_S = 1.979e15         # H100 SXM, dense int8 tensor cores
# cbam_gate (ops/cbam_gate.py, csrc/cbam_gate.cu): the CBAM U-Net's 13
# DoubleConvCBAM gate sites at 512² in forward order, (block, C, H = W)
# (benchmark/configs/unet_cbam_bf16.json). A site's least bytes: y read
# twice, res once, out written once (benchmark/counts_cbam.py:gate_bytes).
# Tolerance against cbam_gate_eval_plain on the card (the stock chain):
# summation order only (the spatial mean, the MLP and the 7x7 conv summed
# in another order than ATen, cuBLAS and cuDNN; a bf16 rounding at a
# boundary may flip): at most CBAM_DIFF_SHARE of the elements differ, each
# within CBAM_REL of the scale |sa * ca * y| + |res|, which a flipped
# rounding of a sigmoid's argument v reaches at |v| = 16 (it moves the
# gate by up to 2^-7 |v| relative; tests/test_torch_cbam_gate_cuda.py).
CBAM_SITES = (("inc1", 32, 512), ("inc2", 32, 512), ("down1", 32, 256),
              ("down2", 64, 128), ("inc3", 64, 128), ("down3", 128, 64),
              ("down4", 256, 32), ("down5", 512, 16), ("up1", 256, 32),
              ("up2", 128, 64), ("up3", 128, 128), ("dconv1", 128, 128),
              ("dconv2", 128, 128))
CBAM_GATE_PASSES = 4
CBAM_DIFF_SHARE, CBAM_REL = 1e-3, 2 ** -3
# stem_conv (ops/stem_conv.py, csrc/stem_conv.cu): the CBAM U-Net's four 5x5
# stem sites at 512² (inc1.0, 1 -> 32 channels; inc1.1, inc2.0, inc2.1,
# 32 -> 32). A site's least time: the larger of its operations over the
# bf16 peak and its bytes (input read once, output written once, bf16) over
# the HBM bandwidth (benchmark/metrics/stem_conv_roofline_pct.py; 2.936 ms
# at batch 64). Tolerance against the plain chain and the stock chain
# (cuDNN's conv, then bn_act_eval with the conv bias): summation order
# only, so a conv sum within its f32 order error of a bf16 rounding
# boundary rounds the other way: at most STEM_DIFF_SHARE of the elements
# differ, each within one bf16 unit of the conv sum through the BatchNorm's
# scale plus one of the bias add and one of the output
# (tests/test_torch_stem_conv_cuda.py).
BF16_OPS_PER_S = 989e12           # H100 SXM, dense bf16 tensor cores
STEM_DIFF_SHARE = 1e-3
# deform_conv (ops/deform_conv.py, csrc/deform_conv.cu): the DLA-34 + DCN
# model's 16 deformable sites. The columns kernel rounds each f32 operation
# alone, in the plain op's order, so its columns equal the plain op's bit
# for bit; DCN_DIFF_SHARE leaves room for a libm exp that differs from
# ATen's sigmoid in its last bit (one bf16 unit at most, DCN_ULPS). The
# site's output is the same GEMM and bn_act_eval on those columns. A site's
# least time: benchmark/counts_dla.py (operations of the offset conv and
# the contraction over the bf16 peak, or its input and output bytes over
# the HBM bandwidth, the larger).
DCN_DIFF_SHARE, DCN_ULPS = 1e-6, 1


def conv_s8_site(key):
    """(act, out type name) of a conv_s8 site: relu into the bf16 carry in
    the trunk, leaky_relu in f32 at the heads' 3x3."""
    return ("leaky_relu", "float32") if key.startswith("y:") \
        else ("relu", "bfloat16")


def conv_s8_bound_ms(batch, h, ci, co, out_bytes):
    """(bytes ms, operations ms) of one site: read x (bf16), write out,
    over 3.35 TB/s; 2 * pixels * C_out * 9 * C_in over the int8 peak."""
    px = batch * h * h
    t_bytes = (px * ci * 2 + px * co * out_bytes) / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * px * co * 9 * ci / INT8_OPS_PER_S * 1e3
    return t_bytes, t_ops
# mesh_serving: row blocks on a one-GPU machine, and the SMILES that may
# flip against the whole-batch run (near-tie NMS flips, as the f32 gate
# allows against JAX)
MESH_BLOCKS = 4
MESH_SMILES_SLACK = 2
# generator: molecules per held-out pool of final_eval; the largest share
# of an image's pixels that may differ from the fixture's drawing (engine A
# draws labels with Pillow and FreeType, whose builds may differ).
GEN_POOL_N = 256
PIXEL_SHARE_MAX = 0.01
# generate_examples: the size of the list timed over the default pool
EXAMPLES_BIG_N = 384
# final_eval: the TPU's overall bf16 exact match on the same 512 molecules
# (logs/final_eval_r5e.log) is the reference; the port may be 2 points
# below it (a different conv summation order flips near-tie peaks).
FINAL_EVAL_TPU_EXACT = 0.8379
FINAL_EVAL_SLACK = 0.02
FINAL_EVAL_DECODE_MIN = 0.99
# final_eval: sha256 of the printouts of eval.classify_results and
# eval.failure_taxonomy at their default arguments on
# logs/final_eval_step43100.csv, which are the JAX scripts' printouts
# (tests/test_torch_failure_buckets.py): the card's host stack, without
# JAX or pandas, holds them byte for byte.
FAILURE_BUCKET_DIGESTS = {
    "classify_results":
        "1880181021b6089bd6819704ac69a06f933e23d459835247f4f8e15530744a1b",
    "failure_taxonomy":
        "8d94ba1506f91ff658ec787416a3eea1dead56f40bd37a812cd43c4babdc6d33",
}
# cli_loop: test-acc's f32 counts on fixture rows 0-15 against the JAX
# package's, each within max(2, 1%) (near-tie peaks of f32 logits).
TESTACC_ABS, TESTACC_REL = 2, 0.01
# multiproc_serving: two ranks, each serving its rows of the fixture batch
# of 64 and assembling them in its own pool of MULTIPROC_POOL processes;
# rank 1 moves one running statistic of its weights before its pipeline
# replicates rank 0's. SMILES may flip against the whole-batch run as in
# mesh_serving (MESH_SMILES_SLACK).
MULTIPROC_RANKS = 2
MULTIPROC_POOL = 2
MOVED_STAT = "down4.double_conv.bn1.running_mean"
# bench: the port's --train-batch default is the JAX bench's (bench.py:62).
# The bench's plain train steps are gated on their peak memory at 128 and
# at BATCH: under the 64.19 GiB that the fine-tunes' remat-heads step
# took at 128 (PERF.md §5), and under 30 GiB at 64 (44.25 GiB before the
# train-mode BatchNorm kept only the bf16 conv output, ops/bn_act.py).
BENCH_JAX_TRAIN_BATCH = 128
BENCH_TRAIN_BATCH = BENCH_JAX_TRAIN_BATCH
BENCH_PEAK_GIB = {BENCH_JAX_TRAIN_BATCH: 64.0, BATCH: 30.0}
# eval_suite: the README's four evaluation entry points through main().
# decode_ceiling at the JAX script's defaults (150 a mode from seed 1000,
# production targets): the TPU made 150/150 in both modes
# (logs/decode_ceiling_r2.log), one miss a mode is allowed; the port's CPU
# run on the card's host, to which the card's buckets and failures are
# held, takes the first CEILING_CPU_N samples of each mode (the whole 150
# would take about a minute of host time).
CEILING_ARGS = ("150", "1000")
CEILING_MIN_OK = 149
CEILING_CPU_N = 30
# degraded_bench and cross_engine_eval on the snapshot: the TPU's numbers
# at step 37500 over 128 molecules (logs/degraded_r5d.log,
# logs/cross_engine_r5d.log) less 8/128, the final_eval near-tie
# allowance.
DEGRADED_N = 128
DEGRADED_TPU_CLEAN_EXACT = 0.7500
DEGRADED_DECODE_MIN = 0.95
CROSS_N = 128
CROSS_TPU_EXACT = {"a": 0.9766, "b": 0.8906}
CROSS_DECODE_MIN = 0.99
EVAL_NEAR_TIE = 8 / 128
# e2e_overfit: 64 examples, as in the JAX script's small run (64 150),
# but 75 epochs (300 steps at batch 16) of its 150: on one H100 600 steps
# took 58-62 s and 300 took 26-29 s. Fewer steps cost more: after 100 the
# model decodes all 64 images into wrong structures, and the run, most of
# it scoring them (a tautomer search each), took 63 s; after 300 it
# decodes 3.
E2E_ARGS = ("64", "75")
# recipe: the fine-tunes' batch (scripts/finetune_hard.py:43,
# finetune_robust.py:40), trained with the plain step (no remat).
FT_BATCH = 128
# recipe: the production recipe's four entry points on a pool of
# RECIPE_TRAIN_N train rows (cut from 90000) after the 256-row eval split;
# train_r5 for 75 s with a 75-s budget (all three learning rates), each
# fine-tune for about 40 s (setup included in the deadline). The gates
# hold the fine-tuned weights to the snapshot's own numbers on the same
# split less 0.05.
RECIPE_TRAIN_N = 512
RECIPE_TRAIN_S = 75.0
RECIPE_FT_S = 40.0
RECIPE_SLACK = 0.05


def emit(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
        else f"nvidia-smi failed: {out.stderr.strip()}"


def max_sm_clock_hz():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60)
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def sass_opcodes(path, kernel_substring):
    """{opcode: count} over the SASS of the kernels in the library `path`
    whose mangled name holds `kernel_substring` (cuobjdump -sass), the
    opcode cut at its first dot but for the wide and high multiplies."""
    import collections
    import re
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "-sass", path], capture_output=True,
                         text=True, timeout=120, check=True).stdout
    counts, inside = collections.Counter(), False
    for line in out.splitlines():
        if "Function :" in line:
            inside = kernel_substring in line
        m = re.match(r"\s+/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\d+\s+)?([A-Z0-9_.]+)",
                     line)
        if inside and m:
            op = m.group(1)
            keep = [t for t in op.split(".")[1:] if t in ("WIDE", "HI")]
            counts[".".join([op.split(".")[0], *keep])] += 1
    return dict(sorted(counts.items(), key=lambda kv: -kv[1]))


# ---------------------------------------------------------------------------
# Timing
# ---------------------------------------------------------------------------

def device_ms(torch, fn, reps=REPS):
    """Median device time of fn() over `reps` runs. Each run is queued
    behind a sleep kernel, so the events bracket only the device work."""
    fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for start, end in ev:
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    times = sorted(s.elapsed_time(e) for s, e in ev)
    return times[len(times) // 2]


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

def phase_environment(torch):
    from abcnet_tpu_torch.infer.native import load_native
    from abcnet_tpu_torch.utils import build

    t0 = time.time()
    paths = build.build()
    build_s = time.time() - t0
    ptxas = {}
    for name in build.KERNELS:
        with open(paths[name] + ".log") as f:
            ptxas[name] = [ln.strip() for ln in f
                           if "registers" in ln or "spill" in ln]
    # The bf16 instance of the noise kernel: Lb1 is the mangled <true>.
    sass = sass_opcodes(paths["noise"], "unpack_noise_kernelILb1")
    emit("environment", ok=True, device=torch.cuda.get_device_name(0),
         nvidia_smi=smi_line(), max_sm_clock_mhz=max_sm_clock_hz() / 1e6,
         torch=torch.__version__, cuda=torch.version.cuda, build_s=build_s,
         ptxas=ptxas, noise_bf16_sass_opcodes=sass,
         assembler="native" if load_native() is not None else "numpy")


def _peak_cases(torch, g=128, b=BATCH):
    gen = torch.Generator().manual_seed(0)
    cases = [("random_x3", torch.randn(b, g, g, generator=gen) * 3, -1.0)]
    plateau = torch.full((b, g, g), -5.0)
    edges = torch.zeros((b, g, g))
    for i in range(b):
        r, c = (4 * i) % (g - 2), (7 * i + 3) % (g - 2)
        plateau[i, r:r + 2, c:c + 2] = 2.0             # all four survive
        plateau[i, (r + 60) % g, (c + 60) % g] = -1.0  # at threshold: drops
        plateau[i, (r + 30) % g, (c + 90) % g] = 7.0   # isolated peak
        edges[i, 0, 0], edges[i, 0, g - 1] = 3.0, 4.0
        edges[i, g - 1, g - 1], edges[i, g - 1, 0] = 5.0, 0.5
        edges[i, i % g, g - 1] = 6.0                   # an edge peak
    cases += [("plateau_threshold", plateau, -1.0), ("edges", edges, 0.5),
              ("constant", torch.full((b, g, g), 0.25), -1.0),
              ("below_threshold", torch.full((b, g, g), -2.0), -1.0)]

    # Maps that try the seams between the kernel's bands of rows (32 rows
    # each at cluster size 4, 16 at 8).
    seams = torch.full((b, g, g), -5.0)
    dense = torch.full((b, g, g), -5.0)
    ties = torch.full((b, g, g), -5.0)
    late = torch.full((b, g, g), -5.0)
    dense[:, 0:32:2, 0:g:2] = torch.rand(b, 16, g // 2, generator=gen) * 4
    dense[:, 40, 40], dense[:, 70, 5], dense[:, g - 1, g - 1] = 9.0, 8.0, 7.0
    late[:, 100:g:3, 1:g:9] = torch.rand(b, 10, 15, generator=gen) * 3
    late[:, 0, 0] = -1.0                               # at threshold: drops
    for i in range(b):
        for n, seam in enumerate((32, 64, 96)):
            c = 10 + 30 * n + i % 20
            seams[i, seam - 1:seam + 1, c:c + 2] = 2.0 + n     # plateau
            seams[i, seam - 1, c + 8] = seams[i, seam + 1, c + 8] = 1.5
            seams[i, seam - 1, 0] = seams[i, seam, g - 1] = 4.0 + n
            seams[i, seam, 3] = 3.0                    # on a seam row
            seams[i, seam - 1, 100], seams[i, seam, 101] = 0.5, 0.75
        for r, c in ((120, 3), (5, 100), (64, 64), (33, 0), (31, g - 1),
                     (96, 7), (5, 2), (70, 90)):
            ties[i, r, (c + i) % g] = 1.25             # one score, 4 bands
        ties[i, 50, 50] = 6.0
    cases += [("band_seams", seams, -1.0), ("dense_band", dense, -1.0),
              ("ties_across_bands", ties, -1.0), ("late_band_only", late, -1.0)]
    return cases


def _small_peak_cases(torch, b=BATCH):
    """Shapes off the serving path, each with its own K: a width that takes
    the kernel's scalar route, and K = H*W on a map smaller than 2K cells,
    where the exhausted slots come from every band's bitmask."""
    gen = torch.Generator().manual_seed(1)
    return [("odd_shape", torch.randn(b, 20, 28, generator=gen) * 3, -1.0, 24),
            ("k_equals_n", torch.randn(b, 8, 8, generator=gen) * 3, -1.0, 64)]


def check_nms(torch, maps, k, thr, cluster=None, got=None):
    """Kernel vs plain version on one batch of maps. Returns (max abs
    score difference over finite slots, slots compared, whether every
    index slot is equal, the exhausted ones too). Raises if a score or an
    index of a finite slot differs. `got` is a result to hold against the
    plain version in place of a single-map launch."""
    from abcnet_tpu_torch.ops.peaks import CLUSTER, nms_topk, nms_topk_plain
    s, i = got if got is not None else nms_topk(maps, k, thr,
                                                cluster or CLUSTER)
    ps, pi = nms_topk_plain(maps, k, thr)
    finite = torch.isfinite(ps)
    if not torch.equal(torch.isfinite(s), finite):
        raise AssertionError("nms_topk: finite slots differ")
    if not torch.equal(s[finite], ps[finite]) or \
            not torch.equal(i[finite], pi[finite]):
        raise AssertionError("nms_topk: finite slots differ in score or "
                             "index")
    err = float((s[finite] - ps[finite]).abs().max()) if finite.any() \
        else 0.0
    return err, int(finite.sum()), bool(torch.equal(i, pi))


def check_nms_pair(torch, a_map, b_map, thr=-1.0):
    """Both maps through one launch (K = 128 and 160, as the decode calls
    it) against two plain calls. Returns (max abs error, every index slot
    equal); raises on a difference in a finite slot or a launch count
    other than one."""
    from abcnet_tpu_torch.ops.peaks import nms_topk, nms_topk_pair
    before = nms_topk.launches
    got_a, got_b = nms_topk_pair(a_map, 128, b_map, 160, thr)
    if nms_topk.launches != before + 1:
        raise AssertionError("nms_topk_pair: not one launch")
    err_a, _, idx_a = check_nms(torch, a_map, 128, thr, got=got_a)
    err_b, _, idx_b = check_nms(torch, b_map, 160, thr, got=got_b)
    return max(err_a, err_b), idx_a and idx_b


def check_noise(torch, bit_sets, dev):
    """The noise kernel against its plain version, bit-equal, and against
    what it must do: rates 0 are the pure unpack; the realized salt and
    pepper fractions of each image lie within 6 binomial standard
    deviations (+ 1e-6) of its rates; the same (rates, seed) gives the
    same mask; images of one batch get different noise. Returns (cases,
    max abs difference from the plain version)."""
    from abcnet_tpu_torch.data.pipeline import draw_noise_rates
    from abcnet_tpu_torch.ops.noise import unpack_noise, unpack_noise_plain
    from abcnet_tpu_torch.ops.unpack import unpack_bits

    gen = torch.Generator(device=dev).manual_seed(0)
    cases, err = [], 0.0
    for name, bits_np in bit_sets.items():
        bits = torch.from_numpy(bits_np).to(dev)
        b = bits.shape[0]
        ink = unpack_bits(bits, torch.float32) > 0
        rates = draw_noise_rates(b, 0.2, dev, gen)
        for dt in (torch.bfloat16, torch.float32):
            for seed in (0, 43100, 2 ** 63 - 2):
                got = unpack_noise(bits, rates, seed, dt)
                want = unpack_noise_plain(bits, rates, seed, dt)
                err = max(err, float((got.float() - want.float()).abs().max()))
                if not torch.equal(got, want):
                    raise AssertionError(f"unpack_noise {name} {dt} seed "
                                         f"{seed}: differs from plain")
                if not torch.equal(got, unpack_noise(bits, rates, seed, dt)):
                    raise AssertionError("unpack_noise: not repeatable")
                cases.append(f"{name}/{str(dt)[6:]}/seed={seed}")
            zero = unpack_noise(bits, torch.zeros_like(rates), 7, dt)
            if not torch.equal(zero, unpack_bits(bits, dt)):
                raise AssertionError(f"unpack_noise {name} {dt}: rates 0 "
                                     "differ from unpack_bits")
        # Realized rates. Pepper alone (salt 0) erases ink at rate p; salt
        # alone (pepper 0) inks white pixels at rate s.
        zeros = torch.zeros(b, device=dev)
        pep = unpack_noise(bits, torch.stack([zeros, rates[:, 1]], 1), 11,
                           torch.float32) > 0
        salt = unpack_noise(bits, torch.stack([rates[:, 0], zeros], 1), 11,
                            torch.float32) > 0
        n_ink = ink.sum((1, 2)).double()
        n_white = (~ink).sum((1, 2)).double()
        worst = 0.0
        for want, n, hits in (
                (rates[:, 1].double(), n_ink, (ink & ~pep).sum((1, 2))),
                (rates[:, 0].double(), n_white, (salt & ~ink).sum((1, 2)))):
            n = n.clamp(min=1)
            tol = 6 * torch.sqrt(want * (1 - want) / n) + 1e-6
            dev_sigma = ((hits.double() / n - want).abs() / tol).max()
            worst = max(worst, float(dev_sigma))
        if worst > 1.0:
            raise AssertionError(f"unpack_noise {name}: realized rates off "
                                 f"by {worst:.2f} x the 6-sigma tolerance")
        full = unpack_noise(bits[:1].expand(2, -1, -1).contiguous(),
                            rates[:1].expand(2, -1).contiguous(), 3,
                            torch.float32)
        if torch.equal(full[0], full[1]):
            raise AssertionError("unpack_noise: two images of a batch got "
                                 "the same noise")
        cases.append(f"{name}/rates within {worst:.2f} of the 6-sigma "
                     "tolerance")
    return cases, err


def bn_act_inputs(torch, shape, dtype, gen, dev="cuda"):
    """(x, dy, weight, bias) of one bn_act case on `dev`: x with a spread
    and an offset of its own in each channel, in `dtype`, x and dy
    channels_last (the layout of the port's activations)."""
    c = shape[1]
    fmt = torch.channels_last
    off = torch.rand(c, device=dev, generator=gen) * 4 - 2
    spread = torch.rand(c, device=dev, generator=gen) * 2.5 + 0.5
    x = torch.randn(shape, device=dev, generator=gen)
    x = x.mul_(spread[:, None, None]).add_(off[:, None, None]).to(
        dtype, memory_format=fmt)
    dy = torch.randn(shape, device=dev, generator=gen).to(
        dtype, memory_format=fmt)
    weight = torch.rand(c, device=dev, generator=gen) + 0.5
    bias = torch.rand(c, device=dev, generator=gen) - 0.5
    return x, dy, weight, bias


def bn_conv_bias(torch, c, dtype, gen, dev="cuda"):
    """A random conv bias of `c` channels in `dtype`, of the size of the
    per-channel offsets bn_act_inputs gives x."""
    return (torch.randn(c, device=dev, generator=gen) * 1.5).to(dtype)


def bn_act_grads(torch, fn, x, dy, weight, bias, act, conv_bias=None):
    """(y, mean, var, dx, dweight, dbias, dconv_bias or None) of fn =
    bn_act or bn_act_plain."""
    leaves = [t.detach().requires_grad_(True)
              for t in (x, weight, bias, conv_bias) if t is not None]
    cb = leaves[3] if conv_bias is not None else None
    y, mean, var = fn(*leaves[:3], BN_EPS, act, None, cb)
    grads = torch.autograd.grad(y, leaves, dy)
    dcb = grads[3] if conv_bias is not None else None
    return (y.detach(), mean, var, *grads[:3], dcb)


def _rel_l2(got, want):
    return float((got.float() - want.float()).norm()
                 / want.float().norm().clamp_min(1e-30))


def bn_act_stats64(torch, x):
    """Per-channel mean and biased variance of NCHW x in float64, a block
    of channels at a time."""
    parts = [torch.var_mean(x[:, c:c + 64].double(), dim=(0, 2, 3),
                            correction=0) for c in range(0, x.shape[1], 64)]
    return (torch.cat([m for _, m in parts]),
            torch.cat([v for v, _ in parts]))


def bn_act_masks(torch, x, w, b, conv_bias=None):
    """(where the kernels' and the plain version's pre-activations agree
    in sign, the number of elements where they do not, the largest |pre|
    among those over the largest |pre|): the "none" outputs of both, in
    f32."""
    from abcnet_tpu_torch.ops.bn_act import bn_act, bn_act_plain

    with torch.no_grad():
        pre_k = bn_act(x, w, b, BN_EPS, "none", None, conv_bias)[0]
        pre_p = bn_act_plain(x, w, b, BN_EPS, "none", None, conv_bias)[0]
        agree = (pre_k > 0) == (pre_p > 0)
        del pre_k
        top = float(pre_p.abs().max())
        tie = float(pre_p.abs().masked_fill_(agree, 0).max()) / top
    return agree, int((~agree).sum()), tie


def compare_bn_act(torch, got, want, dtype, act, stats64, masks=None):
    """The errors of the kernels' (y, mean, var, dx, dw, db) against the
    plain version's, and whether each is within its tolerance (see
    BN_EPS, BN_DCB_SUM_REL). `masks`: bn_act_masks of x, for f32."""
    y, mean, var, dx, dw, db, dcb = got
    yp, mp, vp, dxp, dwp, dbp, dcbp = want
    rms = (mp.square() + vp).sqrt()
    mean_err = float(((mean - mp).abs() / rms).max())
    var_err = float(((var - vp).abs() / vp).max())
    m64, v64 = stats64
    res = {"mean_rel": mean_err, "var_rel": var_err,
           "f64_var_rel": {
               "kernels": float(((var.double() - v64).abs() / v64).max()),
               "plain": float(((vp.double() - v64).abs() / v64).max())},
           "f64_mean_rel": {
               "kernels": float(((mean.double() - m64).abs() / rms).max()),
               "plain": float(((mp.double() - m64).abs() / rms).max())}}
    ypf = yp.float()
    diff = (y.float() - ypf).abs()
    top = float(ypf.abs().max())
    res.update(y_max_abs_err=float(diff.max()), y_max_abs=top)
    name = str(dtype)[6:]
    ties_ok = True
    if dtype == torch.bfloat16:
        _, e = torch.frexp(ypf)
        ulp = torch.ldexp(torch.ones_like(ypf), e - 8).masked_fill_(
            ypf == 0, 0.0)
        del e
        y_ok = bool((diff <= ulp.add_(BN_Y_REL * top)).all())
        del ulp, diff, ypf
        res["dx_rel_l2"] = _rel_l2(dx, dxp)
    else:
        y_ok = float(diff.max()) <= BN_Y_REL * top
        del diff, ypf
        agree, flips, tie = masks
        if act == "none":
            res["dx_rel_l2"] = _rel_l2(dx, dxp)
        else:
            res["dx_rel_l2"] = float(
                torch.where(agree, dx - dxp, 0.0).norm()
                / torch.where(agree, dxp, 0.0).norm())
            res["dx_rel_l2_all"] = _rel_l2(dx, dxp)
            res.update(mask_flips=flips, flip_max_pre_rel=tie)
            ties_ok = tie <= BN_TIE_REL
    res.update(y_within=y_ok, masks_differ_only_at_ties=ties_ok,
               dweight_rel_l2=_rel_l2(dw, dwp), dbias_rel_l2=_rel_l2(db, dbp))
    dcb_ok = True
    if dcbp is not None:
        bound = BN_DCB_SUM_REL[name] * _abs_channel_sums(torch, dxp)
        diff = (dcb.double() - dcbp.double()).abs()
        dcb_ok = dcb.dtype == dcbp.dtype and bool((diff <= bound).all())
        res.update(dconv_bias_max_abs_err=float(diff.max()),
                   dconv_bias_bound_min=float(bound.min()),
                   dconv_bias_plain_max_abs=float(dcbp.abs().max()),
                   dconv_bias_within=dcb_ok)
    res["ok"] = (mean_err <= BN_STAT_REL and var_err <= BN_STAT_REL and y_ok
                 and ties_ok and dcb_ok
                 and res["dx_rel_l2"] <= BN_DX_REL[name]
                 and res["dweight_rel_l2"] <= BN_DPARAM_REL
                 and res["dbias_rel_l2"] <= BN_DPARAM_REL)
    return res


def _abs_channel_sums(torch, t):
    """Per-channel sums of |t| in float64, a block of channels at a
    time."""
    return torch.cat([t[:, c:c + 64].double().abs().sum((0, 2, 3))
                      for c in range(0, t.shape[1], 64)])


def check_dconv_bias_sum(torch, x, dy, w, b, cb, act):
    """Kernel (d)'s conv bias gradient where it does not cancel: the
    backward's two sums replaced by zeros and dy moved by +1 (dx = gamma *
    invstd * g, g > 0 where the activation passes it), against the
    float64 sum of the dx the kernel wrote (see BN_DCB_SUM_REL). Also
    whether the bound would see one of the launch's P block partials
    lost or doubled: its largest share of a channel's sum below 1/P."""
    from abcnet_tpu_torch.ops import bn_act as ops

    name = str(x.dtype)[6:]
    c = x.shape[1]
    P, _ = ops._split(x, c, ops._vec(c, x, dy), ops.SUMS_KIND, act)
    with torch.no_grad():
        st = ops.stats(x, BN_EPS, cb)
        zeros = torch.zeros(2, x.shape[1], device=x.device)
        dy = dy + 1
        dx, dcb = ops.grad_apply(x, dy, st, w, b, zeros, 1.0, act, cb)
        del dy
        want = torch.cat([dx[:, c:c + 64].double().sum((0, 2, 3))
                          for c in range(0, x.shape[1], 64)])
        bound = (BN_UNIT_ROUNDOFF[name] * want.abs()
                 + BN_DCB_CHAIN_REL * _abs_channel_sums(torch, dx))
        diff = (dcb.double() - want).abs()
    ok = bool((diff <= bound).all())
    bound_share = float((bound / want.abs()).max())
    return {"ok": ok, "max_abs_err": float(diff.max()),
            "max_rel_err": float((diff / want.abs()).max()),
            "max_abs": float(want.abs().max()), "partials": P,
            "bound_share_max": bound_share,
            "sees_one_partial": bound_share < 1 / P}


def check_bn_act_streams(torch, n=4, shape=(4, 64, 32, 32)):
    """n bn_acts, forward and backward with a conv bias, each on a stream
    of its own and released together (every stream waits on one event
    behind a sleep kernel, so their reductions' blocks share the card),
    against each run alone: bit-equal, since each launch merges its own
    partials through its own tickets in a fixed order. Alternates bf16
    and f32 and the activations."""
    from abcnet_tpu_torch.ops.bn_act import bn_act

    gen = torch.Generator(device="cuda").manual_seed(14)
    acts = ("relu", "leaky_relu", "none")
    runs = []
    for i in range(n):
        dt = (torch.bfloat16, torch.float32)[i % 2]
        x, dy, w, b = bn_act_inputs(torch, shape, dt, gen)
        runs.append((x, dy, w, b, acts[i % 3],
                     bn_conv_bias(torch, shape[1], dt, gen)))
    alone = [bn_act_grads(torch, bn_act, *r) for r in runs]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream() for _ in runs]
    gate = torch.cuda.Stream()
    equal = []
    for _ in range(3):
        with torch.cuda.stream(gate):
            torch.cuda._sleep(20 * SLEEP_CYCLES)
            opened = gate.record_event()
        together = []
        for st, r in zip(streams, runs):
            st.wait_stream(torch.cuda.current_stream())
            st.wait_event(opened)
            with torch.cuda.stream(st):
                together.append(bn_act_grads(torch, bn_act, *r))
        torch.cuda.synchronize()
        equal.append(all(torch.equal(g, a) for got, want in zip(together, alone)
                         for g, a in zip(got, want)))
    return {"case": "streams", "shape": list(shape), "streams": n,
            "rounds": len(equal), "ok": all(equal),
            "bit_equal_to_alone": equal}


def check_bn_act(torch):
    """bn_act's kernels against bn_act_plain at BN_ACT_SHAPES, bf16 and
    f32, channels_last (the layout of the port's activations), each
    activation, forward and backward; y and dx channels_last. Returns
    (cases, the largest |y - y_plain|)."""
    from abcnet_tpu_torch.ops.bn_act import ACTS, bn_act, bn_act_plain

    gen = torch.Generator(device="cuda").manual_seed(11)
    cases, err = [], 0.0
    runs = [(name, shape, dtype) for name, shape in BN_ACT_SHAPES.items()
            for dtype in (torch.bfloat16, torch.float32)]
    for name, shape, dtype in runs:
        x, dy, w, b = bn_act_inputs(torch, shape, dtype, gen)
        cb = bn_conv_bias(torch, shape[1], dtype, gen)
        for conv_bias in (None, cb):
            with torch.no_grad():
                xb = x if conv_bias is None else x + conv_bias[:, None, None]
                stats64 = bn_act_stats64(torch, xb)
                del xb
            masks = bn_act_masks(torch, x, w, b, conv_bias) \
                if dtype == torch.float32 else None
            for act in sorted(ACTS):
                got = bn_act_grads(torch, bn_act, x, dy, w, b, act, conv_bias)
                want = bn_act_grads(torch, bn_act_plain, x, dy, w, b, act,
                                    conv_bias)
                res = compare_bn_act(torch, got, want, dtype, act, stats64,
                                     masks)
                res["channels_last"] = all(
                    t.stride() == x.stride() for t in (got[0], got[3]))
                res["ok"] = res["ok"] and res["channels_last"]
                del got, want
                err = max(err, res["y_max_abs_err"])
                cases.append({"case": name, "shape": list(shape),
                              "dtype": str(dtype)[6:], "act": act,
                              "conv_bias": conv_bias is not None, **res})
            del masks
            torch.cuda.empty_cache()
        res = check_dconv_bias_sum(torch, x, dy, w, b, cb, "relu")
        cases.append({"case": f"{name}_dconv_bias_sum", "shape": list(shape),
                      "dtype": str(dtype)[6:], "act": "relu", **res})
        del x, dy
        torch.cuda.empty_cache()
    cases.append(check_bn_act_streams(torch))
    torch.cuda.synchronize()
    # each type has a case whose bound sees one lost or doubled partial
    for dt in ("bfloat16", "float32"):
        if not any(c.get("sees_one_partial") for c in cases
                   if c.get("dtype") == dt):
            cases.append({"case": f"dconv_bias_sum_{dt}_sees_a_partial",
                          "dtype": dt, "ok": False})
    bad = [c for c in cases if not c["ok"]]
    if bad:
        raise AssertionError(f"bn_act differs from bn_act_plain: {bad[:4]}")
    return cases, err


def bn_eval_inputs(torch, shape, dtype, gen, dev="cuda",
                   fmt=None):
    """(x, conv_bias, (running_mean, running_var, weight, bias)) of one
    bn_act_eval case on `dev`, random: x a conv output without its bias
    in `dtype`, channels_last unless `fmt` says otherwise."""
    c = shape[1]

    def rand(n):
        return torch.rand(n, device=dev, generator=gen)

    x = (torch.randn(shape, device=dev, generator=gen) * 2 + 0.3).to(
        dtype, memory_format=fmt or torch.channels_last)
    conv_bias = ((rand(c) - 0.5) * 0.6).to(dtype)
    return x, conv_bias, ((rand(c) - 0.5) * 2, rand(c) * 3 + 1e-3,
                          rand(c) + 0.5, rand(c) - 0.5)


def _snapshot_bn_terms(torch, model, bn_name):
    """(conv_bias, (running_mean, running_var, weight, bias)) of the
    snapshot's BatchNorm `bn_name` and its conv, f32; None: the fused
    bank's, the eight heads' OutConvs side by side."""
    mods = dict(model.named_modules())
    if bn_name is None:
        pairs = [(model.head(n).conv0, model.head(n).bn0)
                 for n in model.head_names]
    else:
        pairs = [(mods[bn_name.rsplit("bn", 1)[0] + "conv0"],
                  mods[bn_name])]
    cat = lambda get: torch.cat([get(c, b).detach().float()  # noqa: E731
                                 for c, b in pairs])
    return cat(lambda c, b: c.bias), (
        cat(lambda c, b: b.running_mean), cat(lambda c, b: b.running_var),
        cat(lambda c, b: b.weight), cat(lambda c, b: b.bias))


def _ulp_check(torch, got, want):
    """(differing elements, max |got - want|, every difference within one
    bf16 ulp (f32: two ulps) of want)."""
    bad = got != want
    n = int(bad.sum())
    if n == 0:
        return 0, 0.0, True
    g, w = got[bad].float(), want[bad].float()
    _, e = torch.frexp(w)
    ulps = 1 if got.dtype == torch.bfloat16 else 2
    bits = 8 if got.dtype == torch.bfloat16 else 24
    tol = ulps * torch.ldexp(torch.ones_like(w), e - bits)
    return n, float((g - w).abs().max()), bool(((g - w).abs() <= tol).all())


def check_bn_act_eval(torch):
    """bn_act_eval's kernel against bn_act_eval_plain at BN_EVAL_SHAPES,
    bf16 and f32, channels_last, with the snapshot's statistics and conv
    bias and with random ones; then a contiguous NCHW case (the kernel's
    second index path). Returns (cases, the largest |y - y_plain|)."""
    from abcnet_tpu_torch.__main__ import DEFAULT_SNAPSHOT
    from abcnet_tpu_torch.models.weights import load_snapshot
    from abcnet_tpu_torch.ops.bn_act import bn_act_eval, bn_act_eval_plain

    model, _ = load_snapshot(DEFAULT_SNAPSHOT, "cuda", torch.float32)
    gen = torch.Generator(device="cuda").manual_seed(13)
    runs = [(name, shape, act, bn_name, stats, dtype, None)
            for name, (shape, act, bn_name) in BN_EVAL_SHAPES.items()
            for stats in ("snapshot", "random")
            for dtype in (torch.bfloat16, torch.float32)]
    runs.append(("down3_nchw", BN_EVAL_SHAPES["down3"][0], "relu",
                 BN_EVAL_SHAPES["down3"][2], "snapshot", torch.bfloat16,
                 torch.contiguous_format))
    cases, err = [], 0.0
    for name, shape, act, bn_name, stats, dtype, fmt in runs:
        x, cb, st = bn_eval_inputs(torch, shape, dtype, gen, fmt=fmt)
        if stats == "snapshot":
            cb, st = _snapshot_bn_terms(torch, model, bn_name)
            cb = cb.to(dtype)
        with torch.no_grad():
            got = bn_act_eval(x, cb, *st, BN_EPS, act, dtype)
            want = bn_act_eval_plain(x, cb, *st, BN_EPS, act, dtype)
        torch.cuda.synchronize()
        differing, max_err, within = _ulp_check(torch, got, want)
        err = max(err, max_err)
        cases.append({"case": name, "shape": list(shape), "act": act,
                      "dtype": str(dtype)[6:], "stats": stats,
                      "layout": "nchw" if fmt else "channels_last",
                      "bit_equal": differing == 0,
                      "differing_elements": differing,
                      "max_abs_err": max_err, "within_ulps": within,
                      "same_layout": got.stride() == x.stride(),
                      "ok": within and got.stride() == x.stride()})
        del x, got, want
        torch.cuda.empty_cache()
    del model
    bad = [c for c in cases if not c["ok"]]
    if bad:
        raise AssertionError(f"bn_act_eval differs from bn_act_eval_plain: "
                             f"{bad[:4]}")
    return cases, err


def _bn_eval_layouts(torch, model, fixture):
    """{dtype: {"sparse" | "dense": (calls whose x is channels_last,
    calls)}} of bn_act_eval in the sparse serving forward and the dense
    (eval_step's) forward of the fixture by `model` (bf16, the snapshot),
    in bf16 and in f32 with TF32 off: the layout each BatchNorm meets."""
    from abcnet_tpu_torch.data.pipeline import pack_images
    from abcnet_tpu_torch.infer.decode import DENSE_HEADS_SPARSE_MODE
    from abcnet_tpu_torch.models import unet
    from abcnet_tpu_torch.ops import bn_act
    from abcnet_tpu_torch.ops.unpack import unpack_bits

    seen = []

    def recording(x, *rest):
        seen.append(x.is_contiguous(memory_format=torch.channels_last))
        return bn_act.bn_act_eval(x, *rest)

    bits = torch.from_numpy(pack_images(fixture["images"])).cuda()
    tf32 = torch.backends.cudnn.allow_tf32
    out = {}
    unet.bn_act_eval = recording
    try:
        for dtype in (torch.bfloat16, torch.float32):
            torch.backends.cudnn.allow_tf32 = dtype != torch.float32
            model.dtype = dtype           # the compute dtype; f32 masters
            masks = unpack_bits(bits, dtype)[..., None]
            out[str(dtype)[6:]] = {}
            for mode, kw in (("sparse", {"dense_heads":
                                         DENSE_HEADS_SPARSE_MODE,
                                         "return_features": True}),
                             ("dense", {})):
                seen.clear()
                with torch.no_grad():
                    model(masks, **kw)
                out[str(dtype)[6:]][mode] = (sum(seen), len(seen))
    finally:
        unet.bn_act_eval = bn_act.bn_act_eval
        torch.backends.cudnn.allow_tf32 = tf32
        model.dtype = torch.bfloat16
    return out


def check_bn_act_eval_serving(torch, fixture):
    """bf16 serving of the fixture (make_infer_pipeline on the snapshot,
    one batch of 64) through bn_act_eval's kernel against the same
    serving through bn_act_eval_plain (the name models.unet calls
    patched): the peak dicts bit-equal, or else SMILES >= BATCH - 1 equal
    with the differing peak entries counted."""
    import numpy as np

    from abcnet_tpu_torch.__main__ import DEFAULT_SNAPSHOT, img2smiles_loop
    from abcnet_tpu_torch.infer.decode import make_infer_pipeline
    from abcnet_tpu_torch.models import unet
    from abcnet_tpu_torch.models.weights import load_snapshot
    from abcnet_tpu_torch.ops import bn_act

    model, _ = load_snapshot(DEFAULT_SNAPSHOT, "cuda", torch.bfloat16)
    run = make_infer_pipeline(model, "cuda")
    images = fixture["images"]
    reset_launches()
    got = run(images)
    launches = read_launches()
    got_smiles = img2smiles_loop(run, list(images), BATCH, log_every=0)
    unet.bn_act_eval = bn_act.bn_act_eval_plain
    try:
        want = run(images)
        want_smiles = img2smiles_loop(run, list(images), BATCH, log_every=0)
    finally:
        unet.bn_act_eval = bn_act.bn_act_eval
    equal = _peaks_equal(want, got)
    agree = sum(a == b for a, b in zip(got_smiles, want_smiles))
    layouts = _bn_eval_layouts(torch, model, fixture)
    res = {"peaks_bit_equal": equal,
           "differing_peak_entries": {k: int(np.sum(got[k] != want[k]))
                                      for k in want},
           "smiles_agree": agree, "n": len(images),
           "launches": launches["bn_act_eval"],
           "channels_last_calls": layouts,
           "ok": (equal or agree >= len(images) - 1)
           and launches == serving_launches(1)
           and all(n == EVAL_BN[mode] for by_mode in layouts.values()
                   for mode, (_, n) in by_mode.items())}
    del model, run
    torch.cuda.empty_cache()
    if not res["ok"]:
        raise AssertionError(f"serving through bn_act_eval differs from "
                             f"bn_act_eval_plain: {res}")
    return res


def conv_s8_inputs(torch, shape, co, gen, dev="cuda",
                   dtype="bfloat16"):
    """A conv_s8 site's operands: x (B, H, W, C_in) with about 2% of its
    values past the clamp at scale 4/127, a random HWIO int8 kernel, the
    scale, coef = scale * sw and the bias."""
    ci = shape[-1]
    x = (torch.randn(shape, device=dev, generator=gen) * 2).to(
        getattr(torch, dtype))
    k = torch.randint(-127, 128, (3, 3, ci, co), device=dev, generator=gen,
                      dtype=torch.int8)
    scale = 4.0 / 127.0
    coef = scale * (torch.rand(co, device=dev, generator=gen) * 1e-3 + 1e-4)
    bias = torch.randn(co, device=dev, generator=gen) * 0.5
    return x, k, scale, coef, bias


# Scales the quantize's rounding is swept at: 1.0f / f32(s) and f32(1 / s),
# the reciprocal ATen multiplies by, differ for 0.0371.
CONV_S8_SCALES = (4 / 127, 0.0371, 0.0123456789, 0.3, 1.7e-3)


def conv_s8_sweep(torch, dtype, scale, dev="cuda"):
    """Inputs that take conv_s8's quantize apart, (1, H, 32, 32) in
    `dtype` (bf16 or f32): every finite bf16 value; in f32 each rounding
    boundary (k + 1/2) * scale for -129 <= k <= 128 with its four f32
    neighbours either side. Through an identity kernel (identity_s8) the
    output is the quantized input."""
    if dtype == torch.bfloat16:
        v = torch.arange(-2 ** 15, 2 ** 15, dtype=torch.int32).to(
            torch.int16).view(torch.bfloat16).float()
    else:
        c = ((torch.arange(-129, 129, dtype=torch.float64) + 0.5) *
             scale).float()
        vals, up, down = [c], c, c
        for _ in range(4):
            up = torch.nextafter(up, torch.tensor(float("inf")))
            down = torch.nextafter(down, torch.tensor(float("-inf")))
            vals += [up, down]
        v = torch.cat(vals)
    v = v[torch.isfinite(v)]
    v = torch.cat([v, v.new_zeros(-v.numel() % 1024)])
    return v.reshape(1, -1, 32, 32).to(dev, dtype)


def identity_s8(torch, dev="cuda"):
    """(kernel, coef, bias) of a 32-channel conv whose f32 output with act
    "none" is its int8 input: 1 on the diagonal of the centre tap."""
    k = torch.zeros(3, 3, 32, 32, dtype=torch.int8, device=dev)
    k[1, 1] = torch.eye(32, dtype=torch.int8, device=dev)
    return (k, torch.ones(32, device=dev),
            torch.zeros(32, device=dev))


def raw_bits(torch, t):
    """A bf16 or f32 tensor's bits, for comparisons bit for bit."""
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def check_conv_s8(torch):
    """conv3x3_s8 against conv3x3_s8_plain at the 28 site shapes of a batch
    of 64 (CONV_S8_SITES), random operands, and on the quantize's rounding
    sweeps (conv_s8_sweep) at CONV_S8_SCALES: bit-equal, compared as raw
    bits (the sweeps' outputs also equal to q8 of the input)."""
    from abcnet_tpu_torch.ops.conv_s8 import (conv3x3_s8, conv3x3_s8_plain,
                                              pack_weights, q8)
    gen = torch.Generator(device="cuda").manual_seed(18)
    cases, err = [], 0.0
    for key, h, ci, co in CONV_S8_SITES:
        act, out = conv_s8_site(key)
        x, k, scale, coef, bias = conv_s8_inputs(torch, (BATCH, h, h, ci), co,
                                                 gen)
        dt = getattr(torch, out)
        got = conv3x3_s8(x, pack_weights(k), scale, coef, bias, act, dt)
        want = conv3x3_s8_plain(x, k, scale, coef, bias, act, dt)
        equal = bool(torch.equal(raw_bits(torch, got), raw_bits(torch, want)))
        err = max(err, float((got.float() - want.float()).abs().max()))
        cases.append({"site": key, "shape": [BATCH, h, h, ci, co],
                      "act": act, "out": out, "equal": equal})
        del x, got, want
    k, coef, bias = identity_s8(torch)
    w = pack_weights(k)
    for dt in (torch.bfloat16, torch.float32):
        for scale in CONV_S8_SCALES:
            x = conv_s8_sweep(torch, dt, scale)
            got = conv3x3_s8(x, w, scale, coef, bias, "none", torch.float32)
            want = conv3x3_s8_plain(x, k, scale, coef, bias, "none",
                                    torch.float32)
            equal = bool(torch.equal(raw_bits(torch, got),
                                     raw_bits(torch, want)) and
                         torch.equal(got, q8(x, scale).float()))
            cases.append({"site": f"rounding/{str(dt)[6:]}/{scale:.6g}",
                          "values": x.numel(), "equal": equal})
    torch.cuda.synchronize()
    if not all(c["equal"] for c in cases):
        raise AssertionError("conv_s8 differs from conv3x3_s8_plain: " +
                             str([c["site"] for c in cases
                                  if not c["equal"]]))
    return cases, err


def phase_kernels(torch, fixture):
    import numpy as np

    from abcnet_tpu_torch.data.pipeline import pack_images
    from abcnet_tpu_torch.ops.unpack import unpack_bits, unpack_bits_plain

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    bit_sets = {
        "random": rng.integers(0, 256, (BATCH, 512, 64), dtype=np.uint8),
        "fixture": pack_images(fixture["images"]),
    }
    unpack_err, unpack_cases = 0.0, []
    for name, bits in bit_sets.items():
        t = torch.from_numpy(bits).to(dev)
        for dt in (torch.bfloat16, torch.float32):
            got, want = unpack_bits(t, dt), unpack_bits_plain(t, dt)
            if not torch.equal(got, want):
                raise AssertionError(f"unpack_bits {name} {dt}: differs")
            unpack_err = max(unpack_err,
                             float((got.float() - want.float()).abs().max()))
            unpack_cases.append(f"{name}/{str(dt)[6:]}")

    noise_cases, noise_err = check_noise(torch, bit_sets, dev)

    nms_err, nms_cases = 0.0, []
    big = _peak_cases(torch)
    cases = [(name, maps, thr, k) for name, maps, thr in big
             for k in (128, 160)] + _small_peak_cases(torch)
    for name, maps, thr, k in cases:
        for dt in (torch.float32, torch.bfloat16):
            m = maps.to(dev, dt)
            err, n_finite, all_idx = check_nms(torch, m, k, thr)
            # the same slots whatever number of CTAs shares a map
            others = all(check_nms(torch, m, k, thr, c)[2] for c in (1, 2, 8))
            nms_err = max(nms_err, err)
            nms_cases.append({"case": name, "dtype": str(dt)[6:],
                              "k": k, "finite_slots": n_finite,
                              "all_indices_equal": all_idx,
                              "cluster_1_2_8_equal": others})
    # Both heatmaps in one launch: every case beside the next one.
    for (name, a_map, thr), (other, b_map, _) in zip(big, big[1:] + big[:1]):
        for dt in (torch.float32, torch.bfloat16):
            err, all_idx = check_nms_pair(torch, a_map.to(dev, dt),
                                          b_map.to(dev, dt), thr)
            nms_err = max(nms_err, err)
            nms_cases.append({"case": f"pair:{name}+{other}",
                              "dtype": str(dt)[6:], "k": [128, 160],
                              "all_indices_equal": all_idx})
    # The fixture's real heatmaps (one bf16 forward of the snapshot): each
    # map at its K, then both in one launch.
    maps = fixture_heatmaps(torch, fixture)
    for m, k in zip(maps, (128, 160)):
        err, n_finite, all_idx = check_nms(torch, m, k, -1.0)
        nms_err = max(nms_err, err)
        nms_cases.append({"case": "fixture_heatmap", "dtype": "bfloat16",
                          "k": k, "finite_slots": n_finite,
                          "all_indices_equal": all_idx})
    err, all_idx = check_nms_pair(torch, *maps)
    nms_err = max(nms_err, err)
    nms_cases.append({"case": "pair:fixture_heatmaps", "dtype": "bfloat16",
                      "k": [128, 160], "all_indices_equal": all_idx})
    torch.cuda.synchronize()
    if not all(c["all_indices_equal"] and c.get("cluster_1_2_8_equal", True)
               for c in nms_cases):
        raise AssertionError("nms_topk: an exhausted slot's index differs "
                             "from the plain version")
    bn_cases, bn_err = check_bn_act(torch)
    eval_cases, eval_err = check_bn_act_eval(torch)
    eval_serving = check_bn_act_eval_serving(torch, fixture)
    s8_cases, s8_err = check_conv_s8(torch)
    emit("kernels_vs_plain", ok=True, unpack_cases=unpack_cases,
         unpack_max_abs_err=unpack_err, noise_cases=noise_cases,
         noise_max_abs_err=noise_err, nms_cases=nms_cases,
         nms_max_abs_err=nms_err, bn_act_cases=bn_cases,
         bn_act_max_abs_err=bn_err,
         bn_act_gate=f"mean and var {BN_STAT_REL} relative; bf16: y one "
                     f"bf16 ulp + {BN_Y_REL} of max|y|; f32: y {BN_Y_REL} "
                     "of max|y|, masks differ only at ties (|pre| <= "
                     f"{BN_TIE_REL} of max); dx {BN_DX_REL} relative L2 "
                     "(f32: where the masks agree); dweight, dbias "
                     f"{BN_DPARAM_REL}; with a conv bias its gradient "
                     f"within {BN_DCB_SUM_REL} x sum|dx| a channel, and "
                     "where it does not cancel within u x |its float64 "
                     f"sum| + {BN_DCB_CHAIN_REL} x sum|dx|",
         bn_act_eval_cases=eval_cases, bn_act_eval_max_abs_err=eval_err,
         bn_act_eval_gate="bit-equal to bn_act_eval_plain, or else within "
                          "one bf16 ulp (f32: two ulps) with the differing "
                          "elements counted",
         bn_act_eval_serving=eval_serving, conv_s8_cases=s8_cases,
         conv_s8_max_abs_err=s8_err,
         conv_s8_gate="bit-equal to conv3x3_s8_plain at every site shape "
                      f"of a batch of {BATCH} and on every rounding sweep")
    return {"unpack_bits": unpack_err, "unpack_noise": noise_err,
            "nms_topk": nms_err, "bn_act": bn_err, "bn_act_eval": eval_err,
            "conv_s8": s8_err}, maps


def fixture_heatmaps(torch, fixture):
    """(atom, bond) heatmap logits, (64, 128, 128) bf16 each, of one bf16
    forward of the snapshot on the fixture's drawings: the maps a serving
    batch hands the NMS kernel."""
    from abcnet_tpu_torch.__main__ import DEFAULT_SNAPSHOT
    from abcnet_tpu_torch.data.pipeline import device_unpack_bits, \
        pack_images
    from abcnet_tpu_torch.infer.decode import DENSE_HEADS_SPARSE_MODE
    from abcnet_tpu_torch.models.weights import load_snapshot

    model, _ = load_snapshot(DEFAULT_SNAPSHOT, "cuda", torch.bfloat16)
    bits = torch.from_numpy(pack_images(fixture["images"])).cuda()
    with torch.no_grad():
        heatmaps = model(device_unpack_bits(bits, dtype=torch.bfloat16),
                         dense_heads=DENSE_HEADS_SPARSE_MODE)
    maps = tuple(heatmaps[k][..., 0].contiguous()
                 for k in ("atom_target", "bond_target"))
    del model, heatmaps
    torch.cuda.empty_cache()
    return maps


def serve(torch, fixture, dtype):
    from abcnet_tpu_torch.__main__ import DEFAULT_SNAPSHOT, img2smiles_loop
    from abcnet_tpu_torch.infer.decode import make_infer_pipeline
    from abcnet_tpu_torch.models.weights import load_snapshot

    model, _ = load_snapshot(DEFAULT_SNAPSHOT, "cuda", dtype)
    run = make_infer_pipeline(model, "cuda")
    preds = img2smiles_loop(run, list(fixture["images"]), BATCH, log_every=0)
    return model, [p or "" for p in preds]


def phase_f32(torch, fixture):
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    _, preds = serve(torch, fixture, torch.float32)
    ref = fixture["jax_f32"].tolist()
    agree = sum(p == r for p, r in zip(preds, ref))
    mismatched = [{"row": i, "port": p, "jax_f32": r}
                  for i, (p, r) in enumerate(zip(preds, ref)) if p != r]
    ok = agree >= 62
    emit("serving_f32", ok=ok, agree_with_jax_f32=agree, n=len(ref),
         gate=">= 62", mismatched=mismatched)
    if not ok:
        raise AssertionError("f32 serving disagrees with the JAX SMILES")


def phase_bf16(torch, fixture):
    from abcnet_tpu_torch.eval.scoring import score_pairs

    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    model, preds = serve(torch, fixture, torch.bfloat16)
    launches = read_launches()
    truth = fixture["truth"].tolist()
    tpu = fixture["tpu_bf16"].tolist()
    port_rep = score_pairs(truth, [p or None for p in preds])
    tpu_rep = score_pairs(truth, [p or None for p in tpu])
    agree = sum(p == t for p, t in zip(preds, tpu))
    n_batches = -(-len(truth) // BATCH)
    ok = (port_rep.exact_match >= tpu_rep.exact_match - 3 / 64
          and launches == serving_launches(n_batches))
    emit("serving_bf16", ok=ok, launches=launches,
         agree_with_tpu_bf16=agree, n=len(truth),
         port_exact=port_rep.exact_match, tpu_exact=tpu_rep.exact_match,
         gate="port_exact >= tpu_exact - 3/64; one unpack and one NMS "
              f"launch per batch, {EVAL_BN['sparse']} bn_act_eval (one a "
              "BatchNorm), no train kernel", port=str(port_rep),
         tpu=str(tpu_rep), peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
         mismatched_vs_tpu=[{"row": i, "port": p, "tpu": t}
                            for i, (p, t) in enumerate(zip(preds, tpu))
                            if p != t])
    if not ok:
        raise AssertionError("bf16 serving below the gate")
    return model, launches, preds


def bn_act_row(torch, launches, errs):
    """The kernels-line row of bn_act at the inc1 shape, bf16, relu, with
    a conv bias: the forward and backward through the kernels (conv bias
    gradient included), through bn_act_plain, through the chain the fold
    replaced (the bias add, the four kernels without a bias, the bias
    gradient's sum, by autograd) and without a conv bias, timed in turns
    (each path, then each again in reverse order), and through the stock
    chain before the kernels (the bias add, .float() -> F.batch_norm ->
    relu -> .to(bf16), autograd); the bound from the bytes the op must
    move (read x, write y; read x and dy, write dx)."""
    import torch.nn.functional as F

    from abcnet_tpu_torch.ops.bn_act import bn_act, bn_act_plain

    shape = BN_ACT_SHAPES["inc1"]
    gen = torch.Generator(device="cuda").manual_seed(12)
    x, dy, w, b = bn_act_inputs(torch, shape, torch.bfloat16, gen)
    cb = bn_conv_bias(torch, shape[1], torch.bfloat16, gen)
    xg, wg, bg, cbg = (t.detach().requires_grad_(True)
                       for t in (x, w, b, cb))

    def through(fn):
        return lambda: torch.autograd.grad(
            fn(xg, wg, bg, BN_EPS, "relu", None, cbg)[0],
            (xg, wg, bg, cbg), dy)

    def unfolded(xx, ww, bb, eps, act, group, cc):
        return bn_act(xx + cc[:, None, None], ww, bb, eps, act)

    def stock(xx, ww, bb, eps, act, group, cc):
        xb = xx + cc[:, None, None]
        zeros = torch.zeros(xb.shape[1], device=xb.device)
        out = F.batch_norm(xb.float(), zeros, torch.zeros_like(zeros), ww, bb,
                           True, 1.0, eps)
        return (F.relu(out).to(xb.dtype),)

    with torch.no_grad():
        forward_ms = device_ms(torch, lambda: bn_act(x, w, b, BN_EPS,
                                                     "relu", None, cb))
    paths = {"fold": through(bn_act), "unfolded": through(unfolded),
             "without_conv_bias": lambda: torch.autograd.grad(
                 bn_act(xg, wg, bg, BN_EPS, "relu")[0], (xg, wg, bg), dy)}
    turns = {k: [] for k in paths}
    for path in (*paths, *reversed(paths)):
        turns[path].append(device_ms(torch, paths[path]))
    ms = sum(turns["fold"]) / 2
    replaced_ms = sum(turns["unfolded"]) / 2
    plain_ms = device_ms(torch, through(bn_act_plain))
    stock_ms = device_ms(torch, through(stock))
    nbytes = x.numel() * x.element_size() * (2 + 3)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = x.numel() * BN_ACT_OPS_PER_ELEMENT / F32_OPS_PER_S * 1e3
    del x, dy, xg
    torch.cuda.empty_cache()
    return {
        "name": "bn_act", "route": "cuda",
        "source": "abcnet_tpu_torch/csrc/bn_act.cu",
        "replaces": "abcnet_tpu/models/unet.py:40-48 (the XLA fusion of "
                    "the conv bias, BatchNorm, relu and astype; no Pallas "
                    "counterpart)",
        "launches": launches["bn_act"], "max_abs_err": errs["bn_act"],
        "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None, "operations_type": "f32",
        "shape": f"{shape} bf16, relu, conv bias: forward and backward (4 "
                 "kernels); launches counted over the train_bf16 phase",
        "replaced_ms": replaced_ms, "turns_ms": turns,
        "replaced": "the bias add, the four kernels without a conv bias, "
                    "the bias gradient's sum",
        "stock_chain_ms": stock_ms, "forward_ms": forward_ms,
        "without_conv_bias_ms": sum(turns["without_conv_bias"]) / 2,
        "library": "none: no single PyTorch call adds a bias, normalizes "
                   "with batch statistics, activates and casts"}


def bn_act_step_shapes(torch):
    """bn_act at each BatchNorm shape of the train step (BN_STEP_SHAPES,
    bf16, channels_last, a random conv bias): each kernel alone with the
    conv bias ((d) with its gradient), the op forward and backward through
    autograd with the conv bias folded in (`op`), without a conv bias, and
    what the fold replaced (the bias add, the op without a conv bias, the
    bias gradient's sum), beside each one's least bytes over HBM_BYTES_PER_S
    (BN_STEP_BYTES); `per_step_ms` sums count x ms over the shapes."""
    from abcnet_tpu_torch.ops import bn_act as ops

    gen = torch.Generator(device="cuda").manual_seed(13)
    rows, per_step = {}, {}
    for name, (c, side, act, count) in BN_STEP_SHAPES.items():
        x, dy, w, b = bn_act_inputs(torch, (BATCH, c, side, side),
                                    torch.bfloat16, gen)
        cb = bn_conv_bias(torch, c, torch.bfloat16, gen)
        st = ops.stats(x, BN_EPS, cb)
        sums = ops.grad_sums(x, dy, st, w, b, act, cb)
        inv_n = 1.0 / (x.numel() // c)
        xg, wg, bg, cbg = (t.detach().requires_grad_(True)
                           for t in (x, w, b, cb))
        with torch.no_grad():
            row = {
                "a_stats": device_ms(torch, lambda: ops.stats(x, BN_EPS, cb)),
                "b_apply": device_ms(
                    torch, lambda: ops.apply(x, st, w, b, act, cb)),
                "c_grad_sums": device_ms(
                    torch, lambda: ops.grad_sums(x, dy, st, w, b, act, cb)),
                "d_grad_apply": device_ms(
                    torch, lambda: ops.grad_apply(x, dy, st, w, b, sums,
                                                  inv_n, act, cb))}
        row["op"] = device_ms(torch, lambda: torch.autograd.grad(
            ops.bn_act(xg, wg, bg, BN_EPS, act, None, cbg)[0],
            (xg, wg, bg, cbg), dy))
        row["op_without_conv_bias"] = device_ms(
            torch, lambda: torch.autograd.grad(
                ops.bn_act(xg, wg, bg, BN_EPS, act)[0], (xg, wg, bg), dy))
        row["unfolded"] = device_ms(torch, lambda: torch.autograd.grad(
            ops.bn_act(xg + cbg[:, None, None], wg, bg, BN_EPS, act)[0],
            (xg, wg, bg, cbg), dy))
        nbytes = x.numel() * x.element_size()
        row["bound_ms"] = {k: v * nbytes / HBM_BYTES_PER_S * 1e3
                           for k, v in BN_STEP_BYTES.items()}
        row.update(channels=c, side=side, act=act, count=count)
        rows[name] = row
        for k in ("op", "op_without_conv_bias", "unfolded"):
            per_step[k] = per_step.get(k, 0.0) + count * row[k]
        per_step["bound"] = per_step.get("bound", 0.0) + \
            count * row["bound_ms"]["op"]
        del x, dy, xg, st, sums
        torch.cuda.empty_cache()
    emit("bn_act_shapes", ok=True, batch=BATCH, shapes=rows,
         per_step_ms=per_step,
         batchnorms=sum(v[3] for v in BN_STEP_SHAPES.values()),
         note="bf16, channels_last, conv bias; medians of "
              f"{REPS} CUDA-event timings, each behind a sleep kernel")


def bn_act_eval_row(torch, launches, errs):
    """The kernels-line row of bn_act_eval at the inc1 shape, bf16, relu,
    with a conv bias: the kernel, and bn_act_eval_plain (the chain it
    replaced: the bias add_, .float(), F.batch_norm, relu, .to()), both
    without autograd; the bound from the bytes it must move (read x,
    write y)."""
    from abcnet_tpu_torch.ops.bn_act import bn_act_eval, bn_act_eval_plain

    shape = BN_EVAL_SHAPES["inc1"][0]
    gen = torch.Generator(device="cuda").manual_seed(14)
    x, cb, st = bn_eval_inputs(torch, shape, torch.bfloat16, gen)
    with torch.no_grad():
        ms = device_ms(torch, lambda: bn_act_eval(
            x, cb, *st, BN_EPS, "relu", torch.bfloat16))
        plain_ms = device_ms(torch, lambda: bn_act_eval_plain(
            x, cb, *st, BN_EPS, "relu", torch.bfloat16))
    t_bytes = x.numel() * x.element_size() * 2 / HBM_BYTES_PER_S * 1e3
    t_ops = x.numel() * BN_EVAL_OPS_PER_ELEMENT / F32_OPS_PER_S * 1e3
    del x
    torch.cuda.empty_cache()
    return {
        "name": "bn_act_eval", "route": "cuda",
        "source": "abcnet_tpu_torch/csrc/bn_act.cu",
        "replaces": "abcnet_tpu/models/unet.py:40-48 (the XLA fusion of "
                    "the conv bias, BatchNorm with the running statistics, "
                    "relu and astype; no Pallas counterpart)",
        "launches": launches["bn_act_eval"],
        "max_abs_err": errs["bn_act_eval"], "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None, "operations_type": "f32",
        "shape": f"{shape} bf16, relu, conv bias; launches counted over "
                 "the serving_bf16 phase",
        "library": "none: no single PyTorch call adds a bias, normalizes "
                   "with running statistics, activates and casts"}


def cbam_gate_inputs(torch, shape, dtype, gen, residual="identity",
                     dev="cuda"):
    """A gate site's operands: y (a BatchNorm output, about unit scale) and
    res (a ReLU output, as the identity shortcut carries it, or a 1x1 conv
    of one, `residual="conv"`), channels_last in dtype, and the f32 weights
    of the shared MLP and the 7x7 conv, He-normal with small biases."""
    import torch.nn.functional as F

    cl = torch.channels_last
    c = shape[1]

    def randn(*s):
        return torch.randn(*s, device=dev, generator=gen)

    y = randn(*shape).to(dtype).contiguous(memory_format=cl)
    res = randn(*shape).relu().to(dtype).contiguous(memory_format=cl)
    if residual == "conv":
        res = F.conv2d(res, (randn(c, c, 1, 1) * c ** -0.5).to(dtype),
                       (randn(c) * 0.1).to(dtype))
    mid = max(c // 16, 1)
    weights = (randn(mid, c) * (2 / c) ** 0.5, randn(mid) * 0.1,
               randn(c, mid) * (2 / mid) ** 0.5, randn(c) * 0.1,
               randn(1, 2, 7, 7) * (2 / 98) ** 0.5, randn(1) * 0.1)
    return y, res, weights


def cbam_gate_bound_ms(b, c, h):
    return CBAM_GATE_PASSES * b * c * h * h * 2 / HBM_BYTES_PER_S * 1e3


def cbam_gate_site_times(torch):
    """Per site of a batch of 64: the kernels' ms, the stock chain's ms
    (cbam_gate_eval_plain on the card) and the byte bound, each a median
    of device_ms."""
    from abcnet_tpu_torch.ops.cbam_gate import (cbam_gate_eval,
                                                cbam_gate_eval_plain)

    gen = torch.Generator(device="cuda").manual_seed(23)
    sites = {}
    for name, c, h in CBAM_SITES:
        y, res, w = cbam_gate_inputs(torch, (BATCH, c, h, h),
                                     torch.bfloat16, gen)
        with torch.no_grad():
            sites[name] = {
                "ms": device_ms(torch, lambda: cbam_gate_eval(
                    y, res, *w, torch.bfloat16)),
                "plain_ms": device_ms(torch, lambda: cbam_gate_eval_plain(
                    y, res, *w, torch.bfloat16), 5),
                "bound_ms": cbam_gate_bound_ms(BATCH, c, h)}
        del y, res
        torch.cuda.empty_cache()
    return sites


def cbam_gate_row(torch, sites, launches, err):
    """The kernels-line row of cbam_gate: the inc1 shape (64 x 32 x 512²,
    bf16) and the sum over the 13 sites of a batch of 64, each beside its
    byte bound and the stock chain it replaced (cbam_gate_eval_plain, the
    plain version, is that chain)."""
    def total(key):
        return sum(v[key] for v in sites.values())

    inc1 = sites["inc1"]
    return {
        "name": "cbam_gate", "route": "cuda",
        "source": "abcnet_tpu_torch/csrc/cbam_gate.cu",
        "replaces": "abcnet_tpu/models/unet_cbam.py (XLA's fusions of "
                    "ChannelAttention, SpatialAttention, the residual add "
                    "and relu; no Pallas counterpart)",
        "launches": launches, "max_abs_err": err,
        "ms": inc1["ms"], "plain_ms": inc1["plain_ms"],
        "replaced_chain_ms": inc1["plain_ms"],
        "bound_ms": inc1["bound_ms"], "bound_by": "bytes",
        "sites_ms": total("ms"), "sites_plain_ms": total("plain_ms"),
        "sites_bound_ms": total("bound_ms"),
        "sites_roofline_pct": 100 * total("bound_ms") / total("ms"),
        "library_ms": None, "operations_type": "f32",
        "shape": f"({BATCH},32,512,512) bf16 channels_last (inc1); sites: "
                 f"the 13 of a batch of {BATCH}; three kernels a call",
        "library": "none: no single PyTorch call computes a CBAM gate"}


def cbam_kernels_in_spans(path):
    """(the `abcnet.cbam` host ranges of a chrome trace, the names of the
    kernels launched inside them): a kernel counts where the runtime call
    that launched it (same correlation id) lies inside a range on the
    range's thread."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    ranges = [(e["tid"], e["ts"], e["ts"] + e["dur"]) for e in events
              if e.get("name") == "abcnet.cbam" and e.get("ph") == "X"]
    kernels = {e["args"]["correlation"]: e["name"] for e in events
               if e.get("cat") == "kernel" and "correlation" in
               e.get("args", {})}
    inside = []
    for e in events:
        corr = e.get("args", {}).get("correlation")
        if e.get("cat") in ("cuda_runtime", "cuda_driver") and \
                corr in kernels and \
                any(t == e["tid"] and a <= e["ts"] <= z
                    for t, a, z in ranges):
            inside.append(kernels[corr])
    return ranges, inside


def phase_cbam_gate(torch, fixture):
    """The CBAM gate's kernels against the stock chain at the 13 sites of
    a batch of 64, their times (line `cbam_gate_sites`), and the CBAM
    U-Net (bf16, seeded) served through make_infer_pipeline under a
    profile: 13 `cbam_gates` and 13 `cbam_fused` a batch, 13 calls of
    the kernels, and no stock reduction (`reduce_kernel`) inside the
    `cbam` spans. Returns (the serving launches, the kernels-line row)."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    from abcnet_tpu_torch.__main__ import img2smiles_loop
    from abcnet_tpu_torch.infer.decode import make_infer_pipeline
    from abcnet_tpu_torch.models import UNetCBAM
    from abcnet_tpu_torch.ops.cbam_gate import (cbam_gate_eval,
                                                cbam_gate_eval_plain)
    from abcnet_tpu_torch.utils import profiling

    gen = torch.Generator(device="cuda").manual_seed(22)
    diffs, worst, ok = {}, 0.0, True
    for name, c, h in CBAM_SITES:
        y, res, w = cbam_gate_inputs(torch, (BATCH, c, h, h),
                                     torch.bfloat16, gen)
        with torch.no_grad():
            got = cbam_gate_eval(y, res, *w, torch.bfloat16).float()
            want = cbam_gate_eval_plain(y, res, *w, torch.bfloat16).float()
        d = (got - want).abs()
        share = (d > 0).double().mean().item()
        # the scale |sa * ca * y| + |res|, from below: out - res is the
        # gated term where relu passes it, -res where it clips
        r = res.float().abs()
        rel = (d / ((want - res.float()).abs() + r + 1e-30)).max().item()
        diffs[name] = {"differing_share": share, "max_rel": rel}
        worst = max(worst, d.max().item())
        ok = ok and share <= CBAM_DIFF_SHARE and rel <= CBAM_REL
        del y, res, got, want, d
        torch.cuda.empty_cache()
    sites = cbam_gate_site_times(torch)
    row = cbam_gate_row(torch, sites, None, worst)
    emit("cbam_gate_sites", ok=ok, batch=BATCH, row=row, sites={
        k: {**v, **diffs[k]} for k, v in sites.items()},
        gate=f"each site: at most {CBAM_DIFF_SHARE} of the elements differ "
             f"from cbam_gate_eval_plain, each within {CBAM_REL} of "
             "|out| + 2|res|")

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = UNetCBAM(dtype=torch.bfloat16)
    run = make_infer_pipeline(model.cuda().eval(), "cuda")
    images = list(fixture["images"]) * 2
    img2smiles_loop(run, images[:BATCH], BATCH, log_every=0)       # warm
    torch.cuda.synchronize()
    reset_launches()
    profiling.clear()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        img2smiles_loop(run, images, BATCH, log_every=0)
        torch.cuda.synchronize()
    launches = read_launches()
    counters = list(profiling.counters().values())
    profiling.clear()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        ranges, inside = cbam_kernels_in_spans(path)
    n = len(images) // BATCH
    reductions = sorted({k for k in inside if "reduce_kernel" in k})
    ours = sum("cbam_gate.cu" in k or "gate_kernel" in k or
               "pool_kernel" in k or "mlp_kernel" in k for k in inside)
    served = (len(counters) == n and
              all(c.get("cbam_gates") == c.get("cbam_fused") == 13 and
                  c.get("stem_sites") == c.get("stem_fused") == 4
                  for c in counters) and
              launches["cbam_gate"] == 13 * n and len(ranges) == 13 * n and
              launches["stem_conv"] == 4 * n and
              not reductions and ours == 3 * 13 * n)
    emit("cbam_serving", ok=served, batches=n, launches=launches,
         counters=counters, cbam_ranges=len(ranges),
         kernels_in_cbam_ranges=sorted(set(inside)),
         gate_kernels_in_ranges=ours, reduce_kernels_in_ranges=reductions,
         gate="13 cbam_gates = 13 cbam_fused a batch, 13 calls of the "
              "kernels a batch (3 kernels each) inside the 13 cbam spans, "
              "no reduce_kernel there; 4 stem_sites = 4 stem_fused and 4 "
              "stem_conv launches a batch")
    del model, run
    torch.cuda.empty_cache()
    if not ok:
        raise AssertionError("cbam_gate differs from the stock chain past "
                             "its tolerance")
    if not served:
        raise AssertionError("the CBAM serving path did not run the gate's "
                             "kernels at every site")
    return launches, {**row, "launches": launches["cbam_gate"]}


def stem_bound_ms(b, c_in, h):
    ops = 2 * b * h * h * c_in * 32 * 25
    nbytes = b * h * h * (c_in + 32) * 2
    return max(ops / BF16_OPS_PER_S, nbytes / HBM_BYTES_PER_S) * 1e3


def bf16_ulp(torch, v):
    """One bf16 unit in the last place at |v| (v of any float type)."""
    m = v.double().abs().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(m)) - 7)


def stem_conv_f64(torch, x, conv):
    """The conv's sum in float64 on x and the conv's bf16 weights."""
    import torch.nn.functional as F

    w = conv.weight.to(torch.bfloat16).double()
    return F.conv2d(x.double(), w, None, padding=2)


def stem_site_tolerance(torch, s, conv, bn, want):
    """The elementwise bound of the kernel against the stock chain, from
    the float64 conv sum s: one bf16 unit of the conv sum (it may round to
    either side) and one of the bias add, through the BatchNorm's scale,
    plus one unit of the output."""
    cb = conv.bias.to(torch.bfloat16).double()[:, None, None]
    scale = (bn.weight.double() / (bn.running_var.double() + bn.eps)
             .sqrt())[:, None, None].abs()
    return scale * (bf16_ulp(torch, s) + bf16_ulp(torch, s.abs() + cb.abs())
                    ) + bf16_ulp(torch, want)


def stem_site_operands(torch, model, images):
    """[(site, x, conv, bn, act)] of the four stem sites: each site's input
    as the stock chain leaves it on `images` (B, H, W, 1) through the
    eval-mode CBAM U-Net `model` (the gates through cbam_gate_eval), bf16
    channels_last."""
    from abcnet_tpu_torch.models.unet import _conv
    from abcnet_tpu_torch.ops.cbam_gate import cbam_gate_eval
    from abcnet_tpu_torch.ops.stem_conv import stem_conv_bn_act_eval_plain

    bf = torch.bfloat16
    x = images.permute(0, 3, 1, 2).to(bf)
    out = []
    with torch.no_grad():
        for block in ("inc1", "inc2"):
            m = getattr(model, block)
            y = x
            for i, act in enumerate(("relu", "none")):
                conv, bn = getattr(m, f"conv{i}"), getattr(m, f"bn{i}")
                out.append((f"{block}.{i}", y, conv, bn, act))
                y = stem_conv_bn_act_eval_plain(
                    y, conv.weight, conv.bias, bn.running_mean,
                    bn.running_var, bn.weight, bn.bias, bn.eps, act)
            res = _conv(m.conv2, x, bf) if hasattr(m, "conv2") else x
            x = cbam_gate_eval(y, res, *m.cbam.weights(), bf)
    return out


def stem_site_args(x, conv, bn, act):
    return (x, conv.weight, conv.bias, bn.running_mean, bn.running_var,
            bn.weight, bn.bias, bn.eps, act)


def stem_stock_chain(torch, x, conv, bn, act):
    """The chain the port ran at a stem site before the kernel: cuDNN's
    conv without its bias, then bn_act_eval (kernel (e)) adding it."""
    import torch.nn.functional as F

    from abcnet_tpu_torch.ops.bn_act import bn_act_eval

    bf = torch.bfloat16
    return bn_act_eval(F.conv2d(x, conv.weight.to(bf), None, padding=2),
                       conv.bias.to(bf), bn.running_mean, bn.running_var,
                       bn.weight, bn.bias, bn.eps, act, bf)


def stem_moved_statistics(torch, model, seed=0):
    """Draw the running statistics and affine parameters of the CBAM
    U-Net's four stem BatchNorms from a seeded generator on their device,
    as a trained model holds them: a default-initialized BatchNorm (mean
    0, variance 1, weight 1, bias 0) leaves a bf16 input as it is, so a
    kernel that dropped or mixed up its epilogue's operands would pass."""
    gen = torch.Generator(device=model.inc1.bn0.running_mean.device)
    gen.manual_seed(seed)
    with torch.no_grad():
        for block in ("inc1", "inc2"):
            for i in (0, 1):
                bn = getattr(getattr(model, block), f"bn{i}")
                bn.running_mean.normal_(0.0, 0.3, generator=gen)
                bn.running_var.uniform_(0.5, 2.0, generator=gen)
                bn.weight.normal_(1.0, 0.2, generator=gen)
                bn.bias.normal_(0.0, 0.1, generator=gen)


def stem_site_check(torch, got, want, s, conv, bn):
    """(share of the elements of `got` that differ from `want`, whether
    each lies within stem_site_tolerance, the largest difference)."""
    tol = stem_site_tolerance(torch, s, conv, bn, want)
    d = (got.double() - want.double()).abs()
    out = ((d > 0).double().mean().item(), bool((d <= tol).all()),
           d.max().item())
    del tol, d
    return out


def phase_stem_conv(torch, fixture):
    """The stem's kernel at its four sites of a batch of 64 on the
    fixture's activations (a seeded CBAM U-Net, bf16, eval, its stem
    BatchNorms with moved statistics) against the plain chain and the
    stock chain on the same operands, each site's times beside its bound
    (line `stem_conv_sites`). Returns the kernels-line row."""
    from abcnet_tpu_torch.data.pipeline import pack_images
    from abcnet_tpu_torch.models import UNetCBAM
    from abcnet_tpu_torch.ops.stem_conv import (stem_conv_bn_act_eval,
                                                stem_conv_bn_act_eval_plain)
    from abcnet_tpu_torch.ops.unpack import unpack_bits

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = UNetCBAM(dtype=torch.bfloat16)
    model = model.cuda().eval()
    stem_moved_statistics(torch, model)
    bits = torch.from_numpy(pack_images(fixture["images"])).cuda()
    images = unpack_bits(bits, torch.bfloat16)[..., None]
    sites, ok, worst = {}, True, 0.0
    for name, x, conv, bn, act in stem_site_operands(torch, model, images):
        args = stem_site_args(x, conv, bn, act)
        with torch.no_grad():
            got = stem_conv_bn_act_eval(*args)
            s = stem_conv_f64(torch, x, conv)
            plain = stem_conv_bn_act_eval_plain(*args)
            share, within, err = stem_site_check(torch, got, plain, s, conv,
                                                 bn)
            del plain
            stock = stem_stock_chain(torch, x, conv, bn, act)
            stock_share, stock_within, stock_err = stem_site_check(
                torch, got, stock, s, conv, bn)
            del stock, s
            worst = max(worst, err, stock_err)
            c_in = x.shape[1]
            sites[name] = {
                "c_in": c_in, "act": act,
                "ms": device_ms(torch, lambda: stem_conv_bn_act_eval(*args)),
                "plain_ms": device_ms(
                    torch, lambda: stem_conv_bn_act_eval_plain(*args), 5),
                "library_ms": device_ms(
                    torch, lambda: stem_stock_chain(torch, x, conv, bn, act)),
                "bound_ms": stem_bound_ms(x.shape[0], c_in, x.shape[2]),
                "differing_share": share, "within_tolerance": within,
                "stock_differing_share": stock_share,
                "stock_within_tolerance": stock_within}
        ok = (ok and share <= STEM_DIFF_SHARE and within and
              stock_share <= STEM_DIFF_SHARE and stock_within)
        del got
        torch.cuda.empty_cache()

    def total(key):
        return sum(v[key] for v in sites.values())

    row = {
        "name": "stem_conv", "route": "cuda",
        "source": "abcnet_tpu_torch/csrc/stem_conv.cu",
        "replaces": "abcnet_tpu/models/unet_cbam.py (XLA's 5x5 convs of the "
                    "stem and the fusion of bias, BatchNorm and activation "
                    "after them; no Pallas counterpart)",
        "launches": None, "max_abs_err": worst,
        "ms": total("ms"), "plain_ms": total("plain_ms"),
        "columns_ms": total("columns_ms"),
        "columns_ms_cell_offsets": total("columns_ms_cell_offsets"),
        "bound_ms": total("bound_ms"),
        "bound_by": ", ".join(
            f"{by} at {sum(v['bound_by'] == by for v in sites.values())} "
            "sites" for by in sorted({v["bound_by"]
                                      for v in sites.values()})),
        "roofline_pct": 100 * total("bound_ms") / total("ms"),
        "library_ms": total("library_ms"), "operations_type": "bf16",
        "shape": f"the four stem sites of a batch of {BATCH} at 512² (1 -> "
                 "32 and three 32 -> 32), bf16 channels_last, on the "
                 "fixture's activations",
        "library": "the stock chain it replaced: cuDNN's conv, then "
                   "bn_act_eval with the conv bias"}
    emit("stem_conv_sites", ok=ok, batch=BATCH, row=row, sites=sites,
         gate=f"each site, its BatchNorm's statistics moved: at most "
              f"{STEM_DIFF_SHARE} of the elements differ from the plain "
              "chain, and from the stock chain, each within one bf16 unit "
              "of the conv sum and of the bias add through the BatchNorm's "
              "scale plus one of the output")
    del model, images, bits
    torch.cuda.empty_cache()
    if not ok:
        raise AssertionError("stem_conv differs from the plain or the "
                             "stock chain past its tolerance")
    return row


def phase_times(torch, fixture, maps, launches, errs, cbam_row, stem_row):
    """Line kernel_times: each kernel alone at the shapes of a batch of 64
    against its plain version and its bound (device_ms; the NMS kernel on
    the fixture's real heatmaps `maps`), and line bn_act_shapes. Returns
    the kernels-line rows."""
    from abcnet_tpu_torch.data.pipeline import draw_noise_rates, pack_images
    from abcnet_tpu_torch.ops.noise import int32_probe, unpack_noise, \
        unpack_noise_plain
    from abcnet_tpu_torch.ops.peaks import CLUSTER, nms_topk_pair, \
        nms_topk_pair_plain
    from abcnet_tpu_torch.ops.unpack import unpack_bits, unpack_bits_plain

    # The serving shapes: (64, 512, 64) packed bits -> bf16 (64, 512, 512);
    # the two (64, 128, 128) bf16 heatmaps, K = 128 (atoms), 160 (bonds).
    dt = torch.bfloat16
    bits = torch.from_numpy(pack_images(fixture["images"])).cuda()
    a_map, b_map = maps
    el = a_map.element_size()
    unpack_bytes = bits.numel() + bits.numel() * 8 * el
    nms_bytes = (a_map.numel() + b_map.numel()) * el + BATCH * (128 + 160) * 8
    nms_ops = (a_map.numel() + b_map.numel()) * 9     # 3x3 compares
    # The training shapes: the same packed batch, one rate pair per image
    # (amount 0.2, as fit draws them), the seed in device memory.
    rates = draw_noise_rates(BATCH, 0.2, bits.device,
                             torch.Generator(device="cuda").manual_seed(1))
    seed = torch.tensor([43100], dtype=torch.int64, device="cuda")
    noise_bytes = unpack_bytes + rates.numel() * 4 + 8
    noise_ops = bits.numel() * NOISE_OPS_PER_BYTE
    int32_ops_per_s = SMS * INT32_LANES_PER_SM_CLOCK * max_sm_clock_hz()
    rows = [
        ("unpack_bits", "abcnet_tpu_torch/csrc/unpack.cu",
         "abcnet_tpu/ops/pallas_input.py:59",
         lambda: unpack_bits(bits, dt), lambda: unpack_bits_plain(bits, dt),
         unpack_bytes, bits.numel() * 8, "f32",
         f"({BATCH},512,64) u8 -> ({BATCH},512,512) {str(dt)[6:]}"),
        ("unpack_noise", "abcnet_tpu_torch/csrc/noise.cu",
         "abcnet_tpu/ops/pallas_input.py:63",
         lambda: unpack_noise(bits, rates, seed, dt),
         lambda: unpack_noise_plain(bits, rates, seed, dt),
         noise_bytes, noise_ops, "int32",
         f"({BATCH},512,64) u8 + ({BATCH},2) f32 rates -> ({BATCH},512,512) "
         f"{str(dt)[6:]}; launches counted over the train_bf16 phase"),
        ("nms_topk", "abcnet_tpu_torch/csrc/nms_topk.cu",
         "abcnet_tpu/ops/pallas_peaks.py:78",
         lambda: nms_topk_pair(a_map, 128, b_map, 160, -1.0),
         lambda: nms_topk_pair_plain(a_map, 128, b_map, 160, -1.0),
         nms_bytes, nms_ops, "f32",
         f"1 launch per batch for both maps: 2 x ({BATCH},128,128) "
         f"{str(dt)[6:]}, K=128 and K=160, cluster of {CLUSTER} CTAs a map"),
    ]
    kernels = []
    for name, src, repl, kern, plain, nbytes, nops, ops_type, shape in rows:
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = nops / (int32_ops_per_s if ops_type == "int32"
                        else F32_OPS_PER_S) * 1e3
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": repl,
            "launches": launches[name], "max_abs_err": errs[name],
            "ms": device_ms(torch, kern), "plain_ms": device_ms(torch, plain),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None, "operations_type": ops_type, "shape": shape})
    kernels.append(bn_act_row(torch, launches, errs))
    bn_act_step_shapes(torch)
    kernels.append(bn_act_eval_row(torch, launches, errs))
    kernels.append(cbam_row)
    kernels.append(stem_row)

    # Beside the NMS row: maps with far more than K survivors in every band
    # (random logits, what an untrained model gives): the sorting route.
    dense = (torch.randn(BATCH, 128, 128, device="cuda",
                         generator=torch.Generator(device="cuda")
                         .manual_seed(2)) * 3).to(dt)
    nms_extra = {"dense_maps_ms": device_ms(torch, lambda: nms_topk_pair(
        dense, 128, dense, 160, -1.0))}
    # Beside the noise row: what the card executes of a Philox round's
    # instruction mix, against the table rate the bound is made from.
    probe_out = torch.empty(SMS * 16 * 256, dtype=torch.int32, device="cuda")
    probe_ops = int32_probe(probe_out, 2048) * probe_out.numel()
    probe_ms = device_ms(torch, lambda: int32_probe(probe_out, 2048))
    noise_extra = {
        "int32_table_ops_per_s": int32_ops_per_s,
        "int32_probe_ops_per_s": probe_ops / (probe_ms * 1e-3),
        "ops_per_byte": NOISE_OPS_PER_BYTE,
        "bytes_bound_ms": noise_bytes / HBM_BYTES_PER_S * 1e3,
    }
    emit("kernel_times", ok=True, kernels=[
        {**k, "bound_by": k["bound_by"] if k["bound_by"] == "bytes"
         else f"{k['operations_type']} operations",
         **(nms_extra if k["name"] == "nms_topk" else {}),
         **(noise_extra if k["name"] == "unpack_noise" else {})}
        for k in kernels])
    return kernels


def bf16_units(torch, got, want):
    """(share of elements that differ, most bf16 units between them) of
    two bf16 tensors of one shape (their bit patterns as ordered
    integers)."""
    def ordered(t):
        i = t.contiguous().view(torch.int16).int()
        return torch.where(i < 0, -32768 - i, i)
    d = (ordered(got) - ordered(want)).abs()
    return (d > 0).double().mean().item(), int(d.max().item())


def dcn_seeded_model(torch, images_u8, offset_scale=1.0):
    """DLASeg in bf16 on the card, on the benchmark's seeded kernels
    (benchmark/dla_weights.py:drawn) with its offset convs at
    `offset_scale` of He-normal (1: offsets of about a pixel), every
    BatchNorm recalibrated to the plain reference's float32 batch
    statistics over `images_u8` (the reference's `calibrate`)."""
    import tempfile

    import numpy as np

    from abcnet_tpu_torch.models.weights import load_weights
    from benchmark import dla_weights, harness
    from benchmark.reference import decode as ref_decode
    from benchmark.reference import dla_dcn as ref_dla

    cfg = harness.load_json(os.path.join(
        HERE, "benchmark", "configs", "dla34_dcn_bf16.json"))
    w = {k: torch.from_numpy(v).cuda() for k, v in dla_weights.drawn(
        dict(cfg, offset_kernel_scale=offset_scale)).items()}
    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=True, allow_tf32=False):
        ref_dla.forward(w, ref_decode.binarize(images_u8, "cuda"),
                        calibrate=True)
    arrays = dla_weights.with_default_stats(
        {k: v.cpu().numpy() for k, v in w.items()})
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "dla.npz")
        np.savez(path, __step__=np.int64(0), **arrays)
        model, _ = load_weights(path, device="cuda", dtype=torch.bfloat16)
    return model


def dcn_site_operands(torch, model, images):
    """[(site name, DeformConv, its bf16 input)] of the 16 deformable
    sites over one eval forward of `images` (B, H, W, 1)."""
    from abcnet_tpu_torch.models.dla_dcn import DeformConv

    got, hooks = [], []
    for name, m in model.named_modules():
        if isinstance(m, DeformConv):
            hooks.append(m.register_forward_hook(
                lambda mod, inp, out, name=name: got.append(
                    (name, mod, inp[0].to(torch.bfloat16)))))
    try:
        with torch.no_grad():
            model(images, dense_heads=("atom_target",))
    finally:
        for h in hooks:
            h.remove()
    return got


def dcn_site_args(torch, mod, x):
    """The arguments of deform_conv_bn_act_eval at a site: x, the offset
    / mask conv's bf16 output, the DCN's weight and bias, the BatchNorm's
    terms, relu."""
    from abcnet_tpu_torch.models.dla_dcn import _conv

    bn = mod.bn0
    with torch.no_grad():
        om = _conv(mod.conv1, x, torch.bfloat16)
    return (x, om, mod.conv0.weight, mod.conv0.bias, bn.running_mean,
            bn.running_var, bn.weight, bn.bias, bn.eps, "relu")


def dcn_bound_ms(b, h, ci, co):
    """Least time of what deform_conv_bn_act_eval does at a site over a
    batch: the larger of the contraction's operations over the bf16 peak
    (the offset / mask conv's output is its argument, so that conv's are
    not counted) and the site's bytes over HBM: (ms, what bounds it)."""
    from benchmark import counts_dla
    from benchmark.counts import BF16_OPS_PER_S as OPS, HBM_BYTES_PER_S

    t_ops = b * counts_dla.ops(h, ci, co, 3) / OPS
    t_bytes = counts_dla.site_bytes(b, h, ci, co) / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), \
        "bf16 operations" if t_ops >= t_bytes else "bytes"


def phase_dcn(torch, fixture):
    """The deformable columns kernel at the 16 sites of a batch of 64 on
    the fixture's activations through a seeded DLA-34 + DCN (bf16, its
    BatchNorms recalibrated, offsets of about a pixel) against the plain
    op, and each site's times beside its bound, with the columns kernel
    timed at these offsets and at the cell's (`offset_kernel_scale` of
    them: the same offset kernels scaled, on the same activations) (line
    `dcn_sites`); then the
    model served through make_infer_pipeline under a profile: 16
    `dcn_sites` and 16 kernel launches a batch, and `dcn_device_us`
    (line `dcn_serving`). Returns the kernels-line row."""
    from torch.profiler import ProfilerActivity, profile

    from abcnet_tpu_torch.__main__ import img2smiles_loop
    from abcnet_tpu_torch.data.pipeline import pack_images
    from abcnet_tpu_torch.infer.decode import make_infer_pipeline
    from abcnet_tpu_torch.ops.deform_conv import (
        deform_conv_bn_act_eval, deform_conv_bn_act_eval_plain,
        modulated_columns, modulated_columns_plain)
    from abcnet_tpu_torch.ops.unpack import unpack_bits
    from abcnet_tpu_torch.utils import profiling

    from benchmark import harness

    cell_scale = harness.load_json(os.path.join(
        HERE, "benchmark", "configs", "dla34_dcn_bf16.json"))[
            "offset_kernel_scale"]
    model = dcn_seeded_model(torch, fixture["images"])
    bits = torch.from_numpy(pack_images(fixture["images"])).cuda()
    images = unpack_bits(bits, torch.bfloat16)[..., None]
    sites, ok, worst = {}, True, 0
    for name, mod, x in dcn_site_operands(torch, model, images):
        args = dcn_site_args(torch, mod, x)
        with torch.no_grad():
            col_share, col_units = bf16_units(
                torch, modulated_columns(x, args[1]),
                modulated_columns_plain(x, args[1]))
            out_share, out_units = bf16_units(
                torch, deform_conv_bn_act_eval(*args),
                deform_conv_bn_act_eval_plain(*args))
            off = args[1][:, :18].float().abs()
            om_cell = torch.nn.functional.conv2d(
                x, (mod.conv1.weight * cell_scale).to(torch.bfloat16),
                mod.conv1.bias.to(torch.bfloat16),
                padding=mod.conv1.padding)
            off_cell = om_cell[:, :18].float().abs()
            b, ci, h, _ = x.shape
            co = args[2].shape[0]
            bound_ms, bound_by = dcn_bound_ms(b, h, ci, co)
            sites[name] = {
                "h": h, "c_in": ci, "c_out": co,
                "ms": device_ms(torch, lambda: deform_conv_bn_act_eval(
                    *args)),
                "plain_ms": device_ms(
                    torch, lambda: deform_conv_bn_act_eval_plain(*args), 5),
                "bound_ms": bound_ms, "bound_by": bound_by,
                "columns_ms": device_ms(
                    torch, lambda: modulated_columns(x, args[1])),
                "columns_ms_cell_offsets": device_ms(
                    torch, lambda: modulated_columns(x, om_cell)),
                "abs_offset_px_median_cell": off_cell.median().item(),
                "abs_offset_px_max_cell": off_cell.max().item(),
                "columns_differing_share": col_share,
                "columns_max_units": col_units,
                "out_differing_share": out_share,
                "out_max_units": out_units,
                "abs_offset_px_median": off.median().item(),
                "abs_offset_px_max": off.max().item()}
        worst = max(worst, col_units, out_units)
        ok = (ok and col_share <= DCN_DIFF_SHARE and col_units <= DCN_ULPS
              and out_share <= DCN_DIFF_SHARE and out_units <= DCN_ULPS)
        torch.cuda.empty_cache()

    def total(key):
        return sum(v[key] for v in sites.values())

    row = {
        "name": "deform_conv", "route": "cuda",
        "source": "abcnet_tpu_torch/csrc/deform_conv.cu",
        "replaces": "none: the JAX package has no deformable conv (the "
                    "DLA-34 + DCN model is the port's own)",
        "launches": None, "max_abs_err": worst,
        "ms": total("ms"), "plain_ms": total("plain_ms"),
        "columns_ms": total("columns_ms"),
        "columns_ms_cell_offsets": total("columns_ms_cell_offsets"),
        "bound_ms": total("bound_ms"),
        "bound_by": ", ".join(
            f"{by} at {sum(v['bound_by'] == by for v in sites.values())} "
            "sites" for by in sorted({v["bound_by"]
                                      for v in sites.values()})),
        "roofline_pct": 100 * total("bound_ms") / total("ms"),
        "operations_type": "bf16",
        "shape": f"the 16 deformable sites of a batch of {BATCH} (16² to "
                 "128², 64 to 512 channels), bf16 channels_last, on the "
                 "fixture's activations: columns kernel, GEMM, bn_act_eval"}
    emit("dcn_sites", ok=ok, batch=BATCH, row=row, sites=sites,
         gate=f"each site: at most {DCN_DIFF_SHARE} of the columns and of "
              f"the outputs differ from the plain op, by at most "
              f"{DCN_ULPS} bf16 unit")

    run = make_infer_pipeline(model, "cuda")
    pool = list(fixture["images"]) * 2
    img2smiles_loop(run, pool[:BATCH], BATCH, log_every=0)         # warm
    torch.cuda.synchronize()
    reset_launches()
    profiling.clear()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        img2smiles_loop(run, pool, BATCH, log_every=0)
        torch.cuda.synchronize()
    launches = read_launches()
    counters = list(profiling.counters().values())
    profiling.clear()
    n = len(pool) // BATCH
    served = (len(counters) == n and
              all(c.get("dcn_sites") == 16 and c.get("dcn_device_us", 0) > 0
                  for c in counters) and
              launches["deform_conv"] == 16 * n)
    emit("dcn_serving", ok=served, batches=n, launches=launches,
         counters=counters,
         gate="16 dcn_sites and 16 deform_conv launches a batch, the "
              "sites' device time in dcn_device_us")
    del model, run, images, bits
    torch.cuda.empty_cache()
    if not ok:
        raise AssertionError("deform_conv differs from the plain op past "
                             "its tolerance")
    if not served:
        raise AssertionError("the DLA serving path did not run the "
                             "deformable kernel at every site")
    return {**row, "launches": launches["deform_conv"]}


# ---------------------------------------------------------------------------
# Training phases
# ---------------------------------------------------------------------------

def fixture_samples(fixture, labels):
    """The 64 fixture molecules as raw Samples (drawing + label strings)."""
    import hashlib

    from abcnet_tpu_torch.data.pipeline import Sample

    digest = hashlib.sha256(fixture["images"].tobytes()).hexdigest()
    if digest != str(labels["images_sha256"]):
        raise AssertionError("the training fixture's labels belong to other "
                             "drawings than the serving fixture holds")
    return [Sample(img, str(a), str(b), str(smi)) for img, a, b, smi in
            zip(fixture["images"], labels["atoms_string"],
                labels["bonds_string"], labels["smiles"])]


def phase_train_f32(torch, samples, labels):
    """eval_step in f32 (TF32 off) on the snapshot weights, rows 0-15,
    against the JAX package's f32 CPU losses for the same batch."""
    import random

    from abcnet_tpu_torch.__main__ import DEFAULT_SNAPSHOT
    from abcnet_tpu_torch.data import pipeline
    from abcnet_tpu_torch.models.weights import load_snapshot
    from abcnet_tpu_torch.train import trainer

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model, _ = load_snapshot(DEFAULT_SNAPSHOT, "cuda", torch.float32)
    state = trainer.create_state(trainer.TrainConfig(dtype="float32"), model)
    rng = random.Random(0)
    rows = labels["eval_rows"].tolist()
    batch = trainer.to_device(pipeline.collate(
        [pipeline.sample_to_example(samples[i], rng, train=False)
         for i in rows]), "cuda")
    total, losses, metrics = trainer.eval_step(state, batch)
    want = dict(zip(labels["eval_loss_names"].tolist(),
                    labels["eval_losses"].tolist()))
    want["total"] = float(labels["eval_total"])
    got = {k: float(v) for k, v in losses.items()}
    got["total"] = float(total)
    # relative, with an absolute floor of 1e-7 for a term that is 0 (no
    # atom of these rows carries an hs label)
    rel = {k: abs(got[k] - want[k]) / max(abs(want[k]), 1e-7 / EVAL_REL_TOL)
           for k in want}
    ok = all(v <= EVAL_REL_TOL for v in rel.values()) and \
        all(bool(torch.isfinite(n)) for n, _ in metrics.values())
    emit("train_f32", ok=ok, rows=len(rows), port=got, jax_f32_cpu=want,
         rel_err=rel, gate=f"rel_err <= {EVAL_REL_TOL} per term",
         n_metrics=len(metrics))
    if not ok:
        raise AssertionError("f32 eval_step disagrees with the JAX losses")


def phase_train_bf16(torch, fixture, samples):
    """The production training setting through fit's loop, then the
    weights through the snapshot layout into the serving pipeline."""
    import random
    import tempfile

    from abcnet_tpu_torch.__main__ import img2smiles_loop
    from abcnet_tpu_torch.data import pipeline
    from abcnet_tpu_torch.infer.decode import make_infer_pipeline
    from abcnet_tpu_torch.models.weights import load_snapshot, save_snapshot
    from abcnet_tpu_torch.train import trainer

    cfg = trainer.TrainConfig(batch_size=BATCH, epochs=TRAIN_STEPS,
                              eval_every=TRAIN_STEPS, seed=0)
    rng = random.Random(0)
    test = [pipeline.sample_to_example(s, rng, train=False)
            for s in samples[:cfg.eval_batch_size]]
    state = trainer.create_state(cfg)
    bn = state.model.inc1.bn0
    bn_before = (bn.running_mean.clone(), bn.running_var.clone())

    # fit calls the module's train_step and train_metrics_step; wrap them
    # to keep each step's losses (device tensors, read after the loop) and
    # to count the forward passes that take noisy input.
    totals, terms, noisy = [], [], [0]
    step_fn, metrics_fn = trainer.train_step, trainer.train_metrics_step

    def recording_step(*a, **kw):
        out = step_fn(*a, **kw)
        totals.append(out[1])
        terms.append(out[2])
        noisy[0] += 1
        return out

    def counting_metrics(*a, **kw):
        noisy[0] += 1
        return metrics_fn(*a, **kw)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    trainer.train_step, trainer.train_metrics_step = \
        recording_step, counting_metrics
    try:
        state = trainer.fit(cfg, samples, test, state=state, verbose=False)
    finally:
        trainer.train_step, trainer.train_metrics_step = step_fn, metrics_fn
    torch.cuda.synchronize()
    launches = read_launches()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30

    total_list = [float(t) for t in totals]
    finite = all(bool(torch.isfinite(v)) for d in terms for v in d.values()) \
        and all(t == t and abs(t) != float("inf") for t in total_list)
    bn_moved = not torch.equal(bn.running_mean, bn_before[0]) and \
        not torch.equal(bn.running_var, bn_before[1])
    fell = total_list[-1] < TRAIN_LOSS_FRACTION * total_list[0]
    ok = (finite and bn_moved and fell and state.step == TRAIN_STEPS
          and launches["unpack_noise"] == noisy[0]
          and launches["unpack_bits"] == 1 and launches["nms_topk"] == 0
          and launches["bn_act"] == train_bn_launches(state.model,
                                                      TRAIN_STEPS)
          and launches["bn_act_eval"] == EVAL_BN["dense"] * (
              noisy[0] - len(totals) + launches["unpack_bits"]))

    # Weights through the npz snapshot layout into the serving pipeline.
    with tempfile.TemporaryDirectory() as tmp:
        path = save_snapshot(state.model, os.path.join(tmp, "smoke.npz"),
                             step=state.step)
        served, step = load_snapshot(path, "cuda", torch.bfloat16)
    same = all(torch.equal(v, served.state_dict()[k])
               for k, v in state.model.state_dict().items()
               if not k.endswith("num_batches_tracked"))
    preds = img2smiles_loop(make_infer_pipeline(served, "cuda"),
                            list(fixture["images"]), BATCH, log_every=0)
    ok = ok and same and step == TRAIN_STEPS and len(preds) == BATCH
    emit("train_bf16", ok=ok, batch=BATCH, steps=state.step,
         params=sum(p.numel() for p in state.model.parameters()),
         total_first=total_list[0], total_last=total_list[-1],
         totals=total_list, gate=f"finite; last < {TRAIN_LOSS_FRACTION} x "
         "first; BN running stats moved; unpack_noise launches == noisy "
         "forward passes; unpack_bits launches == 1 (the evaluation); "
         "bn_act launches == 4 a BatchNorm a train step; bn_act_eval "
         f"launches == {EVAL_BN['dense']} a metrics step and an evaluation "
         "batch",
         all_finite=finite, bn_running_stats_moved=bn_moved,
         noisy_forward_passes=noisy[0], launches=launches,
         last_terms={k: float(v) for k, v in terms[-1].items()},
         peak_mem_gib=peak_gib, snapshot_roundtrip_equal=same,
         served_decoded=sum(p is not None for p in preds))
    if not ok:
        raise AssertionError("bf16 training below its gates")
    return state, launches


def phase_conv_bias_fold(torch, samples, state):
    """Line conv_bias_fold: the train step (batch 64, the train_bf16
    phase's state) with the conv bias folded into bn_act against the
    routing before the fold, counted in a trace of each."""
    import random

    from abcnet_tpu_torch.data import pipeline
    from abcnet_tpu_torch.train import trainer

    rng = random.Random(1)
    batch = trainer.to_device(pipeline.collate(
        [pipeline.sample_to_example(s, rng, train=True) for s in samples]),
        "cuda")
    fold = fold_against_unfolded(torch, state, batch)
    emit("conv_bias_fold", batch=BATCH, **fold,
         gate="at least one aten::add_ and one aten::sum call fewer a step "
              "a BatchNorm than the routing before the fold")
    if not fold["ok"]:
        raise AssertionError(f"the conv bias fold: {fold}")


def _unfolded_routing(bn, x):
    """models.unet._folds_conv_bias before the train-mode fold: the conv
    keeps its bias in train mode (ATen adds it after cuDNN's conv and
    sums its gradient in a pass of its own)."""
    return not bn.training and x.device.type == "cuda"


def fold_against_unfolded(torch, state, batch, n=3):
    """train_step with the conv bias folded into bn_act (the main path)
    and with the routing before the fold (`_unfolded_routing`), on one
    resident batch: a trace of n steps of each, the calls a step of its
    `aten::add_` and `aten::sum` rows. Gate: the fold runs at least one
    add_ and one sum fewer a BatchNorm of the model."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from abcnet_tpu_torch.models import unet
    from abcnet_tpu_torch.models.unet import BatchNorm
    from abcnet_tpu_torch.train import trainer

    folds = unet._folds_conv_bias
    routing = {"fold": folds, "unfolded": _unfolded_routing}
    res = {}
    try:
        for path in ("fold", "unfolded"):
            unet._folds_conv_bias = routing[path]
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                for i in range(n):
                    trainer.train_step(state, batch, i, with_metrics=False)
                torch.cuda.synchronize()
            rows = {a.key: a for a in prof.key_averages()
                    if a.device_type == DeviceType.CPU}
            for op in ("aten::add_", "aten::sum"):
                a = rows.get(op)
                res.setdefault(op, {})[path] = {
                    "calls_per_step": a.count / n if a else 0.0}
    finally:
        unet._folds_conv_bias = folds
    n_bn = sum(isinstance(m, BatchNorm) for m in state.model.modules())
    res["batchnorms"] = n_bn
    res["fewer_calls_per_step"] = {
        op: res[op]["unfolded"]["calls_per_step"]
        - res[op]["fold"]["calls_per_step"]
        for op in ("aten::add_", "aten::sum")}
    res["ok"] = all(v >= n_bn for v in res["fewer_calls_per_step"].values())
    return res


def _bn_step(torch, host, path, dtype=None, drop=True, amount=0.2):
    """One train_step at batch 64 from the snapshot, its BatchNorms through
    bn_act's kernels or through bn_act_plain (the name models.unet calls
    patched; it adds the conv bias in front, so the plain step is the
    routing before the fold bit for bit): (total, losses, gradients,
    bn_act launches, conv bias hand-offs, peak GiB)."""
    from abcnet_tpu_torch.__main__ import DEFAULT_SNAPSHOT
    from abcnet_tpu_torch.models import unet
    from abcnet_tpu_torch.models.weights import load_snapshot
    from abcnet_tpu_torch.ops import bn_act
    from abcnet_tpu_torch.train import trainer

    dtype = dtype or torch.bfloat16
    model, _ = load_snapshot(DEFAULT_SNAPSHOT, "cuda", dtype)
    state = trainer.create_state(trainer.TrainConfig(
        batch_size=BATCH, dtype=str(dtype)[6:]), model)
    batch = trainer.to_device(host, "cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    drop_was = unet.OutConv.DROP
    unet.OutConv.DROP = drop_was if drop else 0.0
    op = bn_act.bn_act_plain if path == "plain" else bn_act.bn_act
    handed = []

    def handing(x, weight, bias, eps, act, group=None, conv_bias=None):
        handed.append(conv_bias is not None)
        return op(x, weight, bias, eps, act, group, conv_bias)

    unet.bn_act = handing
    reset_launches()
    try:
        _, total, losses, _ = trainer.train_step(state, batch, rng=0,
                                                 amount=amount,
                                                 with_metrics=False)
        torch.cuda.synchronize()
    finally:
        unet.bn_act = bn_act.bn_act
        unet.OutConv.DROP = drop_was
    run = {"total": float(total),
           "losses": {k: float(v) for k, v in losses.items()},
           "grads": {k: p.grad.detach().float().clone()
                     for k, p in model.named_parameters()
                     if p.grad is not None},
           "launches": read_launches(),
           "expect_bn": train_bn_launches(model, 1) if path == "kernels"
           else 0,
           "conv_bias_handed": sum(handed), "batchnorms": len(handed),
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    del state, model, batch
    torch.cuda.empty_cache()
    return run


def _bn_step_diff(a, b):
    """(relative difference of each loss term and of the total, relative
    L2 of the gradient tree) of run a against run b."""
    rel = {k: abs(v - b["losses"][k]) / max(abs(b["losses"][k]), 1e-6)
           for k, v in a["losses"].items()}
    rel["total"] = abs(a["total"] - b["total"]) / max(abs(b["total"]), 1e-6)
    num = sum(float((a["grads"][k] - g).square().sum())
              for k, g in b["grads"].items())
    den = sum(float(g.square().sum()) for g in b["grads"].values())
    return rel, (num / den) ** 0.5


def phase_bn_act_step(torch, samples):
    """One train_step at batch 64 from the snapshot through bn_act's
    kernels against the same step through bn_act_plain, same batch and
    generator seed: in f32 (TF32 off), held to BN_STEP_LOSS_REL and
    BN_STEP_GRAD_REL; in bf16, held to the floor the same run measures
    (the plain step against itself on the batch in reversed row order,
    noise and dropout off: the same math, the sums in another order)."""
    import random

    from abcnet_tpu_torch.data import pipeline

    rng = random.Random(3)
    exs = [pipeline.sample_to_example(s, rng, train=True)
           for s in samples[:BATCH]]
    host, host_rev = pipeline.collate(exs), pipeline.collate(exs[::-1])
    bf16 = {path: _bn_step(torch, host, path) for path in ("kernels",
                                                           "plain")}
    floor = [_bn_step(torch, h, "plain", drop=False, amount=0.0)
             for h in (host, host_rev)]
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        f32 = {path: _bn_step(torch, host, path, torch.float32)
               for path in ("kernels", "plain")}
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32
    f32_loss, f32_tree = _bn_step_diff(f32["kernels"], f32["plain"])
    bf_loss, bf_tree = _bn_step_diff(bf16["kernels"], bf16["plain"])
    fl_loss, fl_tree = _bn_step_diff(floor[1], floor[0])
    runs = [*bf16.values(), *floor, *f32.values()]
    launches_ok = all(r["launches"]["bn_act"] == r["expect_bn"]
                      and r["launches"]["bn_act_eval"] == 0
                      for r in runs)
    handed_ok = all(r["conv_bias_handed"] == r["batchnorms"] == 34
                    for r in runs)
    gates = {
        "f32_losses": max(f32_loss.values()) <= BN_STEP_LOSS_REL,
        "f32_grad_tree": f32_tree <= BN_STEP_GRAD_REL,
        "bf16_losses_within_floor": max(bf_loss.values())
        <= BN_STEP_FLOOR_LOSS * max(fl_loss.values()),
        "bf16_grad_tree_within_floor": bf_tree
        <= BN_STEP_FLOOR_GRAD * fl_tree,
        "bn_act_launches": launches_ok,
        "conv_bias_handed_to_every_batchnorm": handed_ok,
    }
    ok = all(gates.values())
    emit("bn_act_step", ok=ok, batch=BATCH, gates=gates,
         f32={"loss_rel_err": f32_loss, "grad_tree_rel_l2": f32_tree},
         bf16={"loss_rel_err": bf_loss, "grad_tree_rel_l2": bf_tree,
               "totals": {k: v["total"] for k, v in bf16.items()},
               "peak_gib": {k: v["peak_gib"] for k, v in bf16.items()}},
         bf16_floor={"loss_rel_err": fl_loss, "grad_tree_rel_l2": fl_tree},
         bn_act_launches={"bf16": {k: v["launches"]["bn_act"]
                                   for k, v in bf16.items()},
                          "f32": {k: v["launches"]["bn_act"]
                                  for k, v in f32.items()}},
         conv_bias_handed={k: v["conv_bias_handed"]
                           for k, v in bf16.items()},
         gate=f"f32 (TF32 off): losses <= {BN_STEP_LOSS_REL} relative per "
              f"term, gradient tree <= {BN_STEP_GRAD_REL} relative L2; "
              f"bf16: the largest term <= {BN_STEP_FLOOR_LOSS} x and the "
              f"tree <= {BN_STEP_FLOOR_GRAD} x the floor (the plain step "
              "on the reversed batch, noise and dropout off); 4 bn_act "
              "launches a BatchNorm on the kernel path, none on the plain; "
              "the conv bias handed to each of the 34 BatchNorms on both")
    if not ok:
        raise AssertionError("the train step through bn_act's kernels "
                             "differs from the plain one")
    return dict(bf16["kernels"]["launches"])


# ---------------------------------------------------------------------------
# Slice 4: device guard, data parallel, mesh serving, variants, int8
# ---------------------------------------------------------------------------

def reset_launches():
    from abcnet_tpu_torch.ops import bn_act
    from abcnet_tpu_torch.ops.cbam_gate import cbam_gate_eval
    from abcnet_tpu_torch.ops.conv_s8 import conv3x3_s8
    from abcnet_tpu_torch.ops.deform_conv import modulated_columns
    from abcnet_tpu_torch.ops.noise import unpack_noise
    from abcnet_tpu_torch.ops.peaks import nms_topk
    from abcnet_tpu_torch.ops.stem_conv import stem_conv_bn_act_eval
    from abcnet_tpu_torch.ops.unpack import unpack_bits
    for fn in (unpack_bits, unpack_noise, nms_topk, conv3x3_s8,
               cbam_gate_eval, stem_conv_bn_act_eval, modulated_columns):
        fn.launches = 0
    bn_act.reset_launches()


def read_launches():
    """Launches by kernel; bn_act's are those of its four train-mode entry
    points (statistics, apply, backward sums, backward apply) together,
    bn_act_eval's those of the eval kernel, conv_s8's those of the int8
    conv kernel, cbam_gate's the calls of the CBAM gate's kernels (three
    kernels a call, one call a site), stem_conv's those of the CBAM
    stem's conv kernel (one a site), deform_conv's those of the DLA
    model's deformable columns kernel (one a site)."""
    from abcnet_tpu_torch.ops import bn_act
    from abcnet_tpu_torch.ops.cbam_gate import cbam_gate_eval
    from abcnet_tpu_torch.ops.conv_s8 import conv3x3_s8
    from abcnet_tpu_torch.ops.deform_conv import modulated_columns
    from abcnet_tpu_torch.ops.noise import unpack_noise
    from abcnet_tpu_torch.ops.peaks import nms_topk
    from abcnet_tpu_torch.ops.stem_conv import stem_conv_bn_act_eval
    from abcnet_tpu_torch.ops.unpack import unpack_bits
    return {"unpack_bits": unpack_bits.launches,
            "unpack_noise": unpack_noise.launches,
            "nms_topk": nms_topk.launches, "bn_act": bn_act.launches(),
            "bn_act_eval": bn_act.eval_apply.launches,
            "conv_s8": conv3x3_s8.launches,
            "cbam_gate": cbam_gate_eval.launches,
            "stem_conv": stem_conv_bn_act_eval.launches,
            "deform_conv": modulated_columns.launches}


def serving_launches(batches, eval_batches=0, model="sparse"):
    """The launch dict of `batches` sparse serving batches and
    `eval_batches` dense eval forwards (eval_step, test-acc) of the
    production UNet, nothing trained, no int8 backbone."""
    return {"unpack_bits": batches + eval_batches, "unpack_noise": 0,
            "nms_topk": batches, "bn_act": 0,
            "bn_act_eval": EVAL_BN[model] * batches
            + EVAL_BN["dense"] * eval_batches, "conv_s8": 0, "cbam_gate": 0,
            "stem_conv": 0, "deform_conv": 0}


def train_bn_launches(model, steps):
    """bn_act launches of `steps` train steps of `model`: four a
    BatchNorm a step (the statistics and the apply in the forward, the
    sums and the apply in the backward)."""
    from abcnet_tpu_torch.models.unet import BatchNorm
    return 4 * steps * sum(isinstance(m, BatchNorm) for m in model.modules())


def phase_device_guard(torch):
    """Every kernel wrapper on the last visible GPU while GPU 0 is the
    current device, bit-equal to its plain version there (bn_act within
    the kernels phase's tolerances; bn_act_eval and conv_s8 bit-equal)."""
    import numpy as np

    from abcnet_tpu_torch.data.pipeline import draw_noise_rates
    from abcnet_tpu_torch.ops.bn_act import (bn_act, bn_act_eval,
                                             bn_act_eval_plain, bn_act_plain)
    from abcnet_tpu_torch.ops.conv_s8 import (conv3x3_s8, conv3x3_s8_plain,
                                              pack_weights)
    from abcnet_tpu_torch.ops.noise import (int32_probe, unpack_noise,
                                            unpack_noise_plain)
    from abcnet_tpu_torch.ops.unpack import unpack_bits, unpack_bits_plain

    gpus = torch.cuda.device_count()
    dev = torch.device("cuda", gpus - 1)
    torch.cuda.set_device(0)
    rng = np.random.default_rng(3)
    bits = torch.from_numpy(rng.integers(0, 256, (BATCH, 512, 64),
                                         dtype=np.uint8)).to(dev)
    checked = []
    for dt in (torch.bfloat16, torch.float32):
        if not torch.equal(unpack_bits(bits, dt), unpack_bits_plain(bits, dt)):
            raise AssertionError(f"unpack_bits on {dev} differs")
        rates = draw_noise_rates(BATCH, 0.2, dev, torch.Generator(
            device=dev).manual_seed(0))
        for seed in (0, 43100):
            got = unpack_noise(bits, rates, seed, dt)
            if got.device != dev or not torch.equal(
                    got, unpack_noise_plain(bits, rates, seed, dt)):
                raise AssertionError(f"unpack_noise on {dev} differs")
        checked += [f"unpack_bits/{str(dt)[6:]}", f"unpack_noise/{str(dt)[6:]}"]
    for name, maps, thr in _peak_cases(torch)[:2]:
        for dt in (torch.float32, torch.bfloat16):
            m = maps.to(dev, dt)
            _, _, all_idx = check_nms(torch, m, 128, thr)
            err, pair_idx = check_nms_pair(torch, m, m, thr)
            if not (all_idx and pair_idx) or err:
                raise AssertionError(f"nms_topk on {dev} differs ({name})")
            checked += [f"nms_topk/{name}/{str(dt)[6:]}",
                        f"nms_topk_pair/{name}/{str(dt)[6:]}"]
    probe = torch.empty(SMS * 256, dtype=torch.int32, device=dev)
    int32_probe(probe, 4)
    gen = torch.Generator(device=dev).manual_seed(4)
    for dt in (torch.bfloat16, torch.float32):
        x, dy, w, b = bn_act_inputs(torch, (8, 32, 64, 64), dt, gen, dev)
        cb = bn_conv_bias(torch, 32, dt, gen, dev)
        got = bn_act_grads(torch, bn_act, x, dy, w, b, "relu", cb)
        with torch.no_grad():
            stats64 = bn_act_stats64(torch, x + cb[:, None, None])
        res = compare_bn_act(
            torch, got, bn_act_grads(torch, bn_act_plain, x, dy, w, b,
                                     "relu", cb), dt, "relu", stats64,
            bn_act_masks(torch, x, w, b, cb) if dt == torch.float32
            else None)
        if not res["ok"] or any(t.device != dev for t in got):
            raise AssertionError(f"bn_act on {dev} differs: {res}")
        checked.append(f"bn_act/{str(dt)[6:]}")
        x, cb, st = bn_eval_inputs(torch, (8, 32, 64, 64), dt, gen, dev)
        with torch.no_grad():
            got = bn_act_eval(x, cb, *st, BN_EPS, "relu", dt)
            if got.device != dev or not torch.equal(
                    got, bn_act_eval_plain(x, cb, *st, BN_EPS, "relu", dt)):
                raise AssertionError(f"bn_act_eval on {dev} differs")
        checked.append(f"bn_act_eval/{str(dt)[6:]}")
        x, k, scale, coef, bias = conv_s8_inputs(torch, (4, 64, 64, 48), 40,
                                                 gen, dev, str(dt)[6:])
        got = conv3x3_s8(x, pack_weights(k), scale, coef, bias)
        if got.device != dev or not torch.equal(raw_bits(torch, got), raw_bits(
                torch, conv3x3_s8_plain(x, k, scale, coef, bias))):
            raise AssertionError(f"conv_s8 on {dev} differs")
        checked.append(f"conv_s8/{str(dt)[6:]}")
    torch.cuda.synchronize(dev)
    checked.append("int32_probe")
    if torch.cuda.current_device() != 0:
        raise AssertionError("a kernel wrapper changed the current device")
    emit("device_guard", ok=True, gpus=gpus, device=str(dev),
         current_device=0, checked=checked,
         note=("one GPU: the kernels ran on it, the guard across devices is "
               "not exercised" if gpus == 1 else
               "kernels launched on the last GPU with GPU 0 current"))


def _flat_tree(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_tree(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def f32_ddp_step(torch, samples, mesh=None):
    """One f32 train_step (TF32 off, noise and dropout off) from the
    snapshot weights on the first DDP_BATCH_F32 fixture molecules
    (this rank's rows under a mesh). Returns a flat dict of numpy arrays:
    losses, gradients, running statistics."""
    import random

    import numpy as np

    from abcnet_tpu_torch.__main__ import DEFAULT_SNAPSHOT
    from abcnet_tpu_torch.data import pipeline
    from abcnet_tpu_torch.models.unet import OutConv
    from abcnet_tpu_torch.models.weights import load_snapshot, to_flax
    from abcnet_tpu_torch.parallel import shard_batch
    from abcnet_tpu_torch.train import trainer

    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    drop, OutConv.DROP = OutConv.DROP, 0.0
    try:
        model, _ = load_snapshot(DEFAULT_SNAPSHOT, "cuda", torch.float32)
        cfg = trainer.TrainConfig(dtype="float32", batch_size=DDP_BATCH_F32)
        state = trainer.create_state(cfg, model, mesh=mesh)
        rng = random.Random(0)
        host = pipeline.collate([pipeline.sample_to_example(s, rng,
                                                            train=False)
                                 for s in samples[:DDP_BATCH_F32]])
        if mesh is not None:
            host = shard_batch(host, mesh)
        _, total, losses, _ = trainer.train_step(
            state, trainer.to_device(host, state.device), rng=0, amount=0.0,
            with_metrics=False)
        out = {"loss/total": np.float64(float(total))}
        out.update({f"loss/{k}": np.float64(float(v))
                    for k, v in losses.items()})
        grads = to_flax({n: p.grad for n, p in model.named_parameters()})[0]
        out.update({f"grad/{k}": v for k, v in _flat_tree(grads).items()})
        out.update({f"stat/{k}": v for k, v in
                    _flat_tree(to_flax(model.state_dict())[1]).items()})
    finally:
        OutConv.DROP = drop
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32
    return out


def ddp_worker(out_path, backend):
    """One rank of the ddp_train phase (started by phase_ddp_train with
    RANK, WORLD_SIZE, LOCAL_RANK and MASTER_* in its environment)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    sys.path.insert(0, HERE)
    from abcnet_tpu_torch.parallel import init_distributed, make_mesh
    from abcnet_tpu_torch.train import trainer

    rank = int(os.environ["RANK"])
    torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
    if backend == "gloo":
        dist.init_process_group("gloo", rank=rank,
                                world_size=int(os.environ["WORLD_SIZE"]))
        mesh = make_mesh(device="cuda")
    else:
        mesh = init_distributed("cuda")
    assets = os.path.join(HERE, "abcnet_tpu_torch", "assets")
    fixture = dict(np.load(os.path.join(assets, "smoke_step43100.npz")))
    labels = dict(np.load(os.path.join(assets, "train_step43100.npz")))
    samples = fixture_samples(fixture, labels)
    out = f32_ddp_step(torch, samples, mesh)
    torch.cuda.empty_cache()

    cfg = trainer.TrainConfig(batch_size=DDP_BATCH_BF16, epochs=DDP_STEPS,
                              eval_every=10 ** 9, seed=0)
    state = trainer.create_state(cfg, mesh=mesh)
    totals, times = [], []
    step_fn = trainer.train_step

    def timed_step(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = step_fn(*a, **kw)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        totals.append(float(res[1]))
        return res

    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    trainer.train_step = timed_step
    t0 = time.perf_counter()
    try:
        trainer.fit(cfg, samples, None, state=state, verbose=False)
    finally:
        trainer.train_step = step_fn
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    checksum = sum(float(p.double().sum()) for p in state.model.parameters())
    out.update({
        "bf16/totals": np.asarray(totals), "bf16/step_ms": np.asarray(times),
        "bf16/fit_wall_s": np.float64(wall),
        "bf16/peak_mem_gib": np.float64(torch.cuda.max_memory_allocated()
                                        / 2 ** 30),
        "bf16/param_checksum": np.float64(checksum),
        "bf16/local_batch": np.int64(DDP_BATCH_BF16 // mesh.world),
        **{f"launches/{k}": np.int64(v) for k, v in launches.items()}})
    np.savez(out_path, **out)
    dist.barrier()
    dist.destroy_process_group()


def phase_ddp_train(torch, samples):
    import socket
    import tempfile

    import numpy as np

    gpus = torch.cuda.device_count()
    backend = "nccl" if gpus >= 2 else "gloo"
    ref = f32_ddp_step(torch, samples)
    torch.cuda.empty_cache()
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    with tempfile.TemporaryDirectory() as tmp:
        procs = []
        for rank in range(2):
            env = {**os.environ, "RANK": str(rank), "WORLD_SIZE": "2",
                   "LOCAL_RANK": str(rank if gpus >= 2 else 0),
                   "MASTER_ADDR": "localhost", "MASTER_PORT": str(port)}
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--ddp-worker",
                 os.path.join(tmp, f"rank{rank}.npz"), backend],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=600)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for p, log in zip(procs, logs):
            if p.returncode != 0:
                raise AssertionError(f"a ddp rank failed:\n{log[-4000:]}")
        r0, r1 = (dict(np.load(os.path.join(tmp, f"rank{r}.npz")))
                  for r in range(2))

    loss_rel = {k[5:]: abs(float(r0[k]) - float(ref[k])) /
                max(abs(float(ref[k])), 1e-6)
                for k in ref if k.startswith("loss/")}
    grads = [k for k in ref if k.startswith("grad/")]
    norms = {k: float(np.linalg.norm(ref[k])) for k in grads}
    top = max(norms.values())
    leaf = {k[5:]: float(np.linalg.norm(r0[k] - ref[k])) / norms[k]
            for k in grads if norms[k] > 1e-3 * top}
    tree = float(np.sqrt(sum(float(np.sum((r0[k] - ref[k]) ** 2))
                             for k in grads))
                 / np.sqrt(sum(n * n for n in norms.values())))
    stats = [k for k in ref if k.startswith("stat/")]
    stat_err = max(float(np.max(np.abs(r0[k] - ref[k])
                                / (np.abs(ref[k]) + 1e-3))) for k in stats)
    ranks_equal = all(np.array_equal(r0[k], r1[k]) for k in stats + grads) \
        and float(r0["bf16/param_checksum"]) == float(r1["bf16/param_checksum"])
    totals = r0["bf16/totals"].tolist()
    finite = bool(np.all(np.isfinite(r0["bf16/totals"])))
    ok = (max(loss_rel.values()) <= DDP_LOSS_REL and
          max(leaf.values()) <= DDP_GRAD_LEAF and tree <= DDP_GRAD_TREE and
          stat_err <= DDP_STAT_REL and ranks_equal and finite and
          len(totals) == DDP_STEPS and
          int(r0["launches/unpack_noise"]) >= DDP_STEPS and
          int(r0["launches/bn_act_eval"]) == EVAL_BN["dense"] * (
              int(r0["launches/unpack_noise"]) - DDP_STEPS))
    per_rank = [{"peak_mem_gib": float(r["bf16/peak_mem_gib"]),
                 "step_ms_median_2_to_10": float(np.median(
                     r["bf16/step_ms"][1:])),
                 "step_ms": r["bf16/step_ms"].tolist(),
                 "fit_wall_s": float(r["bf16/fit_wall_s"]),
                 "local_batch": int(r["bf16/local_batch"]),
                 "launches": {k[9:]: int(v) for k, v in r.items()
                              if k.startswith("launches/")}}
                for r in (r0, r1)]
    emit("ddp_train", ok=ok, ranks=2, gpus=gpus, backend=backend,
         f32_global_batch=DDP_BATCH_F32, loss_rel_err=loss_rel,
         grad_leaf_rel_err_max=max(leaf.values()),
         grad_leaf_worst=max(leaf, key=leaf.get), grad_tree_rel_err=tree,
         running_stats_rel_err_max=stat_err,
         ranks_bit_equal=ranks_equal,
         gate=f"losses <= {DDP_LOSS_REL}, leaves <= {DDP_GRAD_LEAF}, tree <= "
              f"{DDP_GRAD_TREE}, stats <= {DDP_STAT_REL} relative; ranks "
              "bit-equal; bf16 totals finite; bn_act_eval "
              f"{EVAL_BN['dense']} a metrics step",
         bf16_global_batch=DDP_BATCH_BF16, bf16_steps=DDP_STEPS,
         bf16_totals=totals, per_rank=per_rank,
         note=("both ranks share one card over gloo: a check of the "
               "algorithm, not a speed figure" if backend == "gloo" else
               "NCCL, one GPU per rank"))
    if not ok:
        raise AssertionError("data-parallel training differs from one "
                             "process")
    return {k: int(v) for k, v in per_rank[0]["launches"].items()}


def phase_mesh_serving(torch, fixture, bf16_model):
    """make_infer_pipeline over every visible GPU (on a one-GPU machine:
    MESH_BLOCKS row blocks on that GPU). Gate: peak dicts bit-equal to
    the unsharded pipeline run on each row block alone (the per-device
    shapes), and SMILES agreeing with the unsharded run of the whole
    batch. Against that whole-batch run the peaks are reported, not
    gated bit for bit: cuDNN picks its conv algorithm by batch size, so
    the trunk of a 16-row block may differ from that of 64 rows in the
    last bits (`trunk_max_abs_diff_vs_whole_batch`)."""
    import numpy as np

    from abcnet_tpu_torch.__main__ import img2smiles_loop
    from abcnet_tpu_torch.data.pipeline import pack_images
    from abcnet_tpu_torch.infer.decode import (DENSE_HEADS_SPARSE_MODE,
                                               make_infer_pipeline)
    from abcnet_tpu_torch.ops.unpack import unpack_bits
    from abcnet_tpu_torch.parallel import Mesh, make_mesh

    gpus = torch.cuda.device_count()
    mesh = make_mesh(device="cuda") if gpus > 1 else \
        Mesh((torch.device("cuda", 0),) * MESH_BLOCKS)
    n = len(mesh.devices)
    images = fixture["images"]
    whole = make_infer_pipeline(bf16_model, "cuda")
    want = whole(images)
    parts = [whole(block) for block in np.split(images, n)]
    blockwise = {k: np.concatenate([p[k] for p in parts]) for k in want}
    masks = unpack_bits(torch.from_numpy(pack_images(images)).cuda())[..., None]
    with torch.no_grad():
        def trunk(x):
            heads, feats = bf16_model(x, dense_heads=DENSE_HEADS_SPARSE_MODE,
                                      return_features=True)
            return [feats] + [heads[k] for k in sorted(heads)]
        ref = trunk(masks)
        blocks = [trunk(m) for m in masks.chunk(n)]
        trunk_diff = max(float((torch.cat(b) - r).abs().max())
                         for r, b in zip(ref, zip(*blocks)))
    run = make_infer_pipeline(bf16_model, "cuda", mesh=mesh)
    reset_launches()
    got = run(images)
    torch.cuda.synchronize()
    launches = read_launches()
    equal = sorted(got) == sorted(blockwise) and all(
        np.array_equal(got[k], blockwise[k]) for k in blockwise)
    vs_whole = {k: int(np.sum(got[k] != want[k])) for k in want}
    float_diff = max(float(np.max(np.abs(got[k].astype(np.float64)
                                         - want[k])))
                     for k in want if want[k].dtype.kind == "f")
    smiles = img2smiles_loop(run, list(images), BATCH, log_every=0)
    smiles_whole = img2smiles_loop(whole, list(images), BATCH, log_every=0)
    agree = sum(a == b for a, b in zip(smiles, smiles_whole))
    ok = equal and agree >= BATCH - MESH_SMILES_SLACK and \
        launches == serving_launches(n)
    emit("mesh_serving", ok=ok, gpus=gpus, devices=[str(d) for d in
                                                    mesh.devices],
         batch=BATCH, peaks_equal_blockwise=equal,
         entries_differing_vs_whole_batch=vs_whole,
         float_max_abs_diff_vs_whole_batch=float_diff,
         trunk_max_abs_diff_vs_whole_batch=trunk_diff,
         smiles_agree_with_whole_batch=agree, launches_per_batch=launches,
         gate=f"peak dicts equal to the unsharded pipeline on each row block; "
              f"SMILES of >= {BATCH - MESH_SMILES_SLACK}/{BATCH} equal to the "
              "whole-batch run; one unpack and one NMS launch per device per "
              f"batch, {EVAL_BN['sparse']} bn_act_eval",
         note=f"{gpus} GPUs" if gpus > 1 else
         f"one GPU: {MESH_BLOCKS} row blocks on it")
    if not ok:
        raise AssertionError("mesh serving differs from the unsharded run")
    return launches


def multiproc_worker(out_path, backend):
    """One rank of the multiproc_serving phase (started by
    phase_multiproc_serving with RANK, WORLD_SIZE, LOCAL_RANK and MASTER_*
    in its environment): the snapshot in bf16 (rank 1 moves MOVED_STAT
    first), make_infer_pipeline on the rank's mesh, the rank's rows of the
    fixture batch (`local_rows`) through the CLI's serving loop with the
    rank's own assembly pool."""
    import numpy as np
    import torch
    import torch.distributed as dist

    sys.path.insert(0, HERE)
    from abcnet_tpu_torch.__main__ import DEFAULT_SNAPSHOT, img2smiles_loop
    from abcnet_tpu_torch.infer.assemble import (assemble_batch,
                                                 make_assembly_pool)
    from abcnet_tpu_torch.infer.decode import make_infer_pipeline
    from abcnet_tpu_torch.models.weights import load_snapshot
    from abcnet_tpu_torch.parallel import (init_distributed, local_rows,
                                           make_mesh)

    rank = int(os.environ["RANK"])
    torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
    if backend == "gloo":
        dist.init_process_group("gloo", rank=rank,
                                world_size=int(os.environ["WORLD_SIZE"]))
        mesh = make_mesh(device="cuda")
    else:
        mesh = init_distributed("cuda")
    model, _ = load_snapshot(DEFAULT_SNAPSHOT, "cuda", torch.bfloat16)
    if mesh.rank:
        with torch.no_grad():
            model.state_dict()[MOVED_STAT].add_(0.25)
    run = make_infer_pipeline(model, "cuda", mesh=mesh)
    checksum = sum(float(t.double().sum())
                   for t in model.state_dict().values())
    fixture = np.load(os.path.join(HERE, "abcnet_tpu_torch", "assets",
                                   "smoke_step43100.npz"))
    images = fixture["images"][local_rows(len(fixture["images"]), mesh)]
    served = []
    pool = make_assembly_pool(MULTIPROC_POOL)
    try:
        def assemble(peaks):
            served.append(peaks)
            return assemble_batch(peaks, pool=pool)

        torch.cuda.synchronize()
        reset_launches()
        smiles = img2smiles_loop(run, list(images), len(images),
                                 log_every=0, assemble=assemble)
        torch.cuda.synchronize()
        launches = read_launches()
    finally:
        pool.close()
        pool.join()
    np.savez(out_path, **{f"peaks/{k}": v for k, v in served[0].items()},
             smiles=np.array([p or "" for p in smiles]),
             **{f"launches/{k}": np.int64(v) for k, v in launches.items()},
             batches=np.int64(len(served)), checksum=np.float64(checksum),
             moved=model.state_dict()[MOVED_STAT].float().cpu().numpy(),
             rows=np.int64(len(images)), device=str(mesh.device))
    dist.barrier()
    dist.destroy_process_group()


def phase_multiproc_serving(torch, fixture, bf16_model, bf16_preds):
    """Two ranks of a process group, each serving its own rows through
    make_infer_pipeline(mesh=the rank's mesh) (NCCL on two GPUs, or both
    ranks on the one card over gloo). Gates: each rank's peak dict
    bit-equal to this process's unsharded pipeline on the same row block;
    the SMILES of both ranks against the whole-batch serving run; one
    unpack and one NMS launch per rank per batch; both ranks hold rank 0's
    weights (equal checksums, rank 1's moved statistic restored)."""
    import socket
    import tempfile

    import numpy as np

    from abcnet_tpu_torch.infer.decode import make_infer_pipeline

    gpus = torch.cuda.device_count()
    backend = "nccl" if gpus >= MULTIPROC_RANKS else "gloo"
    images = fixture["images"]
    whole = make_infer_pipeline(bf16_model, "cuda")
    blocks = [whole(b) for b in np.split(images, MULTIPROC_RANKS)]
    snap_stat = bf16_model.state_dict()[MOVED_STAT].float().cpu().numpy()
    torch.cuda.synchronize()
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        procs = []
        for rank in range(MULTIPROC_RANKS):
            env = {**os.environ, "RANK": str(rank),
                   "WORLD_SIZE": str(MULTIPROC_RANKS),
                   "LOCAL_RANK": str(rank if backend == "nccl" else 0),
                   "MASTER_ADDR": "localhost", "MASTER_PORT": str(port)}
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__),
                 "--multiproc-worker", os.path.join(tmp, f"rank{rank}.npz"),
                 backend],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=600)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for p, log in zip(procs, logs):
            if p.returncode != 0:
                raise AssertionError(f"a serving rank failed:\n{log[-4000:]}")
        ranks = [dict(np.load(os.path.join(tmp, f"rank{r}.npz")))
                 for r in range(MULTIPROC_RANKS)]
    wall = time.perf_counter() - t0
    per_rank, equal, launches_ok = [], [], []
    for r, (got, want) in enumerate(zip(ranks, blocks)):
        peaks = {k[6:]: v for k, v in got.items() if k.startswith("peaks/")}
        same = sorted(peaks) == sorted(want) and all(
            peaks[k].dtype == want[k].dtype
            and np.array_equal(peaks[k], want[k]) for k in want)
        launches = {k[9:]: int(v) for k, v in got.items()
                    if k.startswith("launches/")}
        n_batches = int(got["batches"])
        equal.append(same)
        launches_ok.append(n_batches == 1 and
                           launches == serving_launches(1))
        per_rank.append({"device": str(got["device"]),
                         "rows": int(got["rows"]), "batches": n_batches,
                         "peaks_equal_blockwise": same,
                         "launches": launches,
                         "param_checksum": float(got["checksum"])})
    smiles = [s for got in ranks for s in got["smiles"].tolist()]
    agree = sum(a == b for a, b in zip(smiles, bf16_preds))
    replicated = all(np.array_equal(got["moved"], snap_stat)
                     for got in ranks) and \
        len({float(got["checksum"]) for got in ranks}) == 1
    ok = (all(equal) and all(launches_ok) and replicated
          and len(smiles) == len(images)
          and agree >= len(images) - MESH_SMILES_SLACK)
    emit("multiproc_serving", ok=ok, ranks=MULTIPROC_RANKS, gpus=gpus,
         backend=backend, global_batch=len(images),
         assembly_pool_per_rank=MULTIPROC_POOL, per_rank=per_rank,
         smiles_agree_with_whole_batch=agree,
         replicated_rank0_weights=replicated, wall_s=wall,
         gate="each rank's peak dict bit-equal to the unsharded pipeline on "
              "its row block; SMILES of >= "
              f"{len(images) - MESH_SMILES_SLACK}/{len(images)} equal to the "
              "whole-batch run; one unpack and one NMS launch per rank per "
              f"batch, {EVAL_BN['sparse']} bn_act_eval; both ranks hold rank "
              "0's weights",
         note="both ranks share one card over gloo" if backend == "gloo"
         else "NCCL, one GPU per rank")
    if not ok:
        raise AssertionError("multi-process serving differs from the "
                             "unsharded run")
    return {f"multiproc_serving_rank{r}": p["launches"]
            for r, p in enumerate(per_rank)}


def _train_variant(torch, trainer, model, batch, steps, rng0=0):
    """`steps` train_steps of `model` (bf16, batch 64) on one resident
    batch. Returns (state, totals, first step's losses, ms per step,
    peak GiB)."""
    cfg = trainer.TrainConfig(batch_size=BATCH)
    state = trainer.create_state(cfg, model=model)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    totals, times, first = [], [], None
    for i in range(steps):
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        _, total, losses, _ = trainer.train_step(state, batch, rng0 + i,
                                                 with_metrics=False)
        ev[1].record()
        torch.cuda.synchronize()
        times.append(ev[0].elapsed_time(ev[1]))
        totals.append(float(total))
        if first is None:
            first = {k: float(v) for k, v in losses.items()}
    return (state, totals, first, times,
            torch.cuda.max_memory_allocated() / 2 ** 30)


def _fused_bank_eval(torch, fused_tree, fixture):
    """The fused head bank's eval forward (bf16, the 64 fixture masks)
    through bn_act_eval's kernel against the same forward through
    bn_act_eval_plain (the name models.unet calls patched): (row, launches
    of the kernel's forward)."""
    from abcnet_tpu_torch.data.pipeline import pack_images
    from abcnet_tpu_torch.models import UNet, unet
    from abcnet_tpu_torch.models.weights import from_flax
    from abcnet_tpu_torch.ops import bn_act
    from abcnet_tpu_torch.ops.unpack import unpack_bits

    model = UNet(dtype=torch.bfloat16, fused_head_bank=True)
    model.load_state_dict(from_flax(fused_tree["params"],
                                    fused_tree["batch_stats"]))
    model = model.to("cuda").eval()
    masks = unpack_bits(torch.from_numpy(pack_images(fixture["images"]))
                        .cuda(), torch.bfloat16)[..., None]
    with torch.no_grad():
        reset_launches()
        got = model(masks)
        torch.cuda.synchronize()
        launches = read_launches()
        unet.bn_act_eval = bn_act.bn_act_eval_plain
        try:
            want = model(masks)
        finally:
            unet.bn_act_eval = bn_act.bn_act_eval
    equal = all(torch.equal(got[k], want[k]) for k in want)
    row = {"heads_equal_to_plain": equal, "launches": launches,
           "ok": equal and launches["bn_act_eval"] == EVAL_BN["fused_bank"]}
    del model, masks, got, want
    torch.cuda.empty_cache()
    return row, launches


def phase_variants(torch, fixture, samples):
    import random

    import numpy as np

    from abcnet_tpu_torch.__main__ import img2smiles_loop
    from abcnet_tpu_torch.data import pipeline
    from abcnet_tpu_torch.infer.decode import make_infer_pipeline
    from abcnet_tpu_torch.models import UNet, UNetCBAM, UNetS2D
    from abcnet_tpu_torch.models.fuse_heads import fuse_head_variables
    from abcnet_tpu_torch.models.unet import OutConv
    from abcnet_tpu_torch.models.weights import from_flax, to_flax
    from abcnet_tpu_torch.train import trainer

    rng = random.Random(2)
    batch = trainer.to_device(pipeline.collate(
        [pipeline.sample_to_example(s, rng, train=True) for s in samples]),
        "cuda")
    bf16 = torch.bfloat16

    def seeded(make):
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            return make()

    rows, launches, ok = {}, {}, True
    for name, make in (("s2d", lambda: UNetS2D(dtype=bf16)),
                       ("cbam", lambda: UNetCBAM(dtype=bf16))):
        model = seeded(make)
        reset_launches()
        state, totals, _, times, peak = _train_variant(
            torch, trainer, model, batch, VARIANT_STEPS)
        launches[f"{name}_train"] = read_launches()
        fell = all(np.isfinite(totals)) and totals[-1] < totals[0]
        rows[name] = {"params": sum(p.numel() for p in model.parameters()),
                      "totals": totals, "loss_fell": fell,
                      "step_ms_median_2_on": float(np.median(times[1:])),
                      "step_ms": times, "peak_mem_gib": peak,
                      "train_launches": launches[f"{name}_train"]}
        ok = ok and fell and \
            launches[f"{name}_train"]["unpack_noise"] == VARIANT_STEPS and \
            launches[f"{name}_train"]["bn_act_eval"] == 0 and \
            launches[f"{name}_train"]["cbam_gate"] == 0 and \
            launches[f"{name}_train"]["stem_conv"] == 0
        if name == "s2d":
            reset_launches()
            preds = img2smiles_loop(make_infer_pipeline(model.eval(), "cuda"),
                                    list(fixture["images"]), BATCH,
                                    log_every=0)
            torch.cuda.synchronize()
            launches["s2d_serving"] = read_launches()
            served = launches["s2d_serving"] == serving_launches(
                1, model="s2d_sparse") and len(preds) == BATCH
            rows[name]["served"] = len(preds)
            rows[name]["serving_launches"] = launches["s2d_serving"]
            ok = ok and served
        del state, model
        torch.cuda.empty_cache()

    # Production UNet, its fused head bank and remat on the same weights:
    # a first step with dropout off (the fused bank draws one mask over
    # 1024 channels, the heads eight over 128: other masks), then steps
    # with dropout for the time and memory.
    plain = seeded(lambda: UNet(dtype=bf16))
    params, stats = to_flax(plain.state_dict())
    fused_tree = fuse_head_variables({"params": params, "batch_stats": stats})
    makers = {
        "plain": lambda: plain,
        "fused_head_bank": lambda: UNet(dtype=bf16, fused_head_bank=True),
        "remat_blocks": lambda: UNet(dtype=bf16,
                                     remat_blocks=UNet.BLOCKS + ("heads",)),
    }
    rows["fused_head_bank_eval"], launches["fused_bank_eval"] = \
        _fused_bank_eval(torch, fused_tree, fixture)
    ok = ok and rows["fused_head_bank_eval"]["ok"]
    firsts = {}
    for name, make in makers.items():
        model = make()
        if name == "fused_head_bank":
            model.load_state_dict(from_flax(fused_tree["params"],
                                            fused_tree["batch_stats"]))
        elif name == "remat_blocks":
            model.load_state_dict(from_flax(params, stats))
        drop, OutConv.DROP = OutConv.DROP, 0.0
        try:
            state, first_total, first, _, _ = _train_variant(
                torch, trainer, model, batch, 1, rng0=100)
        finally:
            OutConv.DROP = drop
        firsts[name] = (first_total[0], first)
        del state
        model = make()
        if name == "fused_head_bank":
            model.load_state_dict(from_flax(fused_tree["params"],
                                            fused_tree["batch_stats"]))
        elif name == "remat_blocks":
            model.load_state_dict(from_flax(params, stats))
        state, totals, _, times, peak = _train_variant(
            torch, trainer, model, batch, VARIANT_STEPS)
        rows[name] = {"first_step_total_dropout_off": firsts[name][0],
                      "totals": totals,
                      "step_ms_median_2_on": float(np.median(times[1:])),
                      "step_ms": times, "peak_mem_gib": peak}
        del state, model
        torch.cuda.empty_cache()
    base = firsts["plain"][1]
    for name, tol in (("fused_head_bank", FUSED_LOSS_REL),
                      ("remat_blocks", 0.0)):
        rel = {k: abs(v - base[k]) / max(abs(base[k]), 1e-6)
               for k, v in firsts[name][1].items()}
        rows[name]["first_step_loss_rel_err_vs_plain"] = rel
        ok = ok and max(rel.values()) <= tol
    emit("variants", ok=ok, batch=BATCH, dtype="bfloat16", size=512,
         steps=VARIANT_STEPS, rows=rows,
         gate=f"S2D and CBAM finite with the loss falling, one noise launch "
              f"a step, no bn_act_eval, cbam_gate or stem_conv; S2D serves "
              f"with "
              f"one unpack and one "
              f"NMS launch and {EVAL_BN['s2d_sparse']} bn_act_eval; the fused "
              f"bank's eval forward through the kernel bit-equal to "
              f"bn_act_eval_plain, {EVAL_BN['fused_bank']} launches; "
              f"first-step losses: remat equal, fused within "
              f"{FUSED_LOSS_REL} relative",
         note="5 train_steps on one resident batch of the 64 fixture "
              "molecules, noise on, seeded init; ms: CUDA events, median of "
              "steps 2-5")
    if not ok:
        raise AssertionError("a model variant failed its gates")
    return launches


def s8_plain_over_packed(x, w, scale, coef, bias, act="relu",
                         out_dtype=None):
    """conv3x3_s8's call over conv3x3_s8_plain (the packed weights
    unpacked): patched into infer.quant, it serves the int8 backbone
    through the chain the kernel replaced."""
    import torch

    from abcnet_tpu_torch.ops.conv_s8 import conv3x3_s8_plain, unpack_weights
    return conv3x3_s8_plain(x, unpack_weights(w, x.shape[-1]), scale, coef,
                            bias, act, out_dtype or torch.bfloat16)


def conv_s8_sites(torch, bundle, packed, carry):
    """Line conv_s8_sites: each of the 28 sites on the activations the
    fixture gives it (one forward_quant of the 64 masks, the kernel's
    calls recorded): the kernel against conv3x3_s8_plain bit for bit, its
    ms, the bound, the plain chain's ms, and torch._int_mm's ms on the
    site's im2col matrix built beforehand (the library GEMM alone, over
    conv_int8's chunks, operands padded as int_mm pads them); how `x.float()
    / s` rounds on the card (a multiply by the f32 reciprocal, as the
    kernel does, or a true division) and how many quantized inputs a true
    division would change. Returns (row totals, per-site list)."""
    import torch.nn.functional as F

    from abcnet_tpu_torch.infer import quant
    from abcnet_tpu_torch.ops import conv_s8

    calls = []

    def recording(*args):
        calls.append(args)
        return conv_s8.conv3x3_s8(*args)

    quant.conv3x3_s8 = recording
    try:
        with torch.no_grad():
            quant.forward_quant(bundle, carry, packed=packed)
    finally:
        quant.conv3x3_s8 = conv_s8.conv3x3_s8
    layers = {key: layer for key, _, layer in quant.conv_sites(bundle)}
    keys = [key for key, _, _ in quant.conv_sites(bundle)]
    if [tuple(c[0].shape[1:]) for c in calls] != [
            (h, h, ci) for _, h, ci, _ in CONV_S8_SITES] or len(keys) != 28:
        raise AssertionError("forward_quant's conv_s8 calls are not the 28 "
                             "sites of CONV_S8_SITES")
    sites, rounding = [], {"reciprocal": 0, "true_division": 0,
                           "true_division_changes_q": 0, "inputs": 0}
    for key, (x, w, scale, coef, bias, act, out) in zip(keys, calls):
        kq = layers[key][0]
        got = conv_s8.conv3x3_s8(x, w, scale, coef, bias, act, out)
        want = conv_s8.conv3x3_s8_plain(x, kq, scale, coef, bias, act, out)
        equal = bool(torch.equal(raw_bits(torch, got), raw_bits(torch, want)))
        q = x.float() / scale
        s_dev = torch.tensor(scale, dtype=torch.float32, device=x.device)
        rounding["reciprocal"] += bool(torch.equal(
            q, x.float() * conv_s8.reciprocal(scale)))
        rounding["true_division"] += bool(torch.equal(q, x.float() / s_dev))
        rounding["true_division_changes_q"] += int((conv_s8.q8(x, scale) != (
            torch.clamp(torch.round(x.float() / s_dev), -127, 127)
            .to(torch.int8))).sum())
        rounding["inputs"] += x.numel()
        # the library GEMM alone on the site's pre-built im2col chunks
        b, h, _, ci = x.shape
        xq = conv_s8.q8(x, scale)
        wmat = kq.reshape(9 * ci, -1)
        pk, pn = -wmat.shape[0] % 8, -wmat.shape[1] % 8
        wmat = F.pad(wmat, (0, pn, 0, pk)).contiguous()
        per = max(1, conv_s8.IM2COL_CHUNK // (h * h * 9 * ci))
        mats = [F.pad(conv_s8.im2col(xq[i:i + per], 3, 3), (0, pk))
                .contiguous() for i in range(0, b, per)]
        ms = device_ms(torch, lambda: conv_s8.conv3x3_s8(
            x, w, scale, coef, bias, act, out))
        plain_ms = device_ms(torch, lambda: conv_s8.conv3x3_s8_plain(
            x, kq, scale, coef, bias, act, out))
        int_mm_ms = device_ms(torch, lambda: [torch._int_mm(a, wmat)
                                              for a in mats])
        del mats
        t_bytes, t_ops = conv_s8_bound_ms(b, h, ci, wmat.shape[1] - pn,
                                          got.element_size())
        sites.append({"site": key, "shape": [b, h, h, ci, got.shape[-1]],
                      "act": act, "out": str(out)[6:], "equal": equal,
                      "ms": ms, "bound_ms": max(t_bytes, t_ops),
                      "bound_by": "bytes" if t_bytes >= t_ops
                      else "operations", "plain_ms": plain_ms,
                      "int_mm_ms": int_mm_ms})
        del got, want, q, xq
    torch.cuda.empty_cache()
    if not all(c["equal"] for c in sites):
        raise AssertionError("conv_s8 differs from its plain chain on the "
                             "fixture's activations")
    totals = {k: sum(c[k] for c in sites)
              for k in ("ms", "bound_ms", "plain_ms", "int_mm_ms")}
    bytes_ms = sum(conv_s8_bound_ms(*c["shape"][:2], *c["shape"][3:],
                                    4 if c["out"] == "float32" else 2)[0]
                   for c in sites)
    ops_ms = sum(conv_s8_bound_ms(*c["shape"][:2], *c["shape"][3:],
                                  4 if c["out"] == "float32" else 2)[1]
                 for c in sites)
    emit("conv_s8_sites", ok=True, sites=sites, totals=totals,
         bytes_ms=bytes_ms, operations_ms=ops_ms, rounding=rounding,
         note="medians of 25 CUDA-event timings at batch 64 on the fixture's "
              "activations; bound per site the larger of (read x, write out) "
              "over 3.35 TB/s and 2*pixels*C_out*9*C_in over 1,979 int8 "
              "TOPS; rounding: sites where x.float() / s equals the multiply "
              "by the f32 reciprocal, sites where it equals the true "
              "division, and the quantized inputs a true division would "
              "change, of `inputs`")
    return totals, sites


def phase_quant_serving(torch, fixture, bf16_model, bf16_preds):
    from abcnet_tpu_torch.__main__ import img2smiles_loop
    from abcnet_tpu_torch.data.pipeline import pack_images
    from abcnet_tpu_torch.eval.scoring import score_pairs
    from abcnet_tpu_torch.infer import quant
    from abcnet_tpu_torch.infer.decode import (DENSE_HEADS_SPARSE_MODE,
                                               make_infer_pipeline)
    from abcnet_tpu_torch.ops import conv_s8
    from abcnet_tpu_torch.ops.unpack import unpack_bits

    images = fixture["images"]
    bits = torch.from_numpy(pack_images(images)).cuda()
    masks = unpack_bits(bits, torch.float32)[..., None]
    t0 = time.perf_counter()
    bundle = quant.prepare_quant(bf16_model, masks[:32])
    torch.cuda.synchronize()
    prep_s = time.perf_counter() - t0
    run = make_infer_pipeline(bf16_model, "cuda", quant=bundle)
    reset_launches()
    preds = [p or "" for p in img2smiles_loop(run, list(images), BATCH,
                                              log_every=0)]
    torch.cuda.synchronize()
    launches = read_launches()
    truth = fixture["truth"].tolist()
    q_rep = score_pairs(truth, [p or None for p in preds])
    b_rep = score_pairs(truth, [p or None for p in bf16_preds])
    agree = sum(p == b for p, b in zip(preds, bf16_preds))

    # The same serving through the plain int8 backbone (conv3x3_s8_plain at
    # every site, the routing before the kernel): peak dicts and SMILES.
    peaks = run(images)
    quant.conv3x3_s8 = s8_plain_over_packed
    try:
        plain_run = make_infer_pipeline(bf16_model, "cuda", quant=bundle)
        plain_peaks = plain_run(images)
        plain_preds = [p or "" for p in img2smiles_loop(
            plain_run, list(images), BATCH, log_every=0)]
    finally:
        quant.conv3x3_s8 = conv_s8.conv3x3_s8
    peaks_equal = _peaks_equal(plain_peaks, peaks)
    plain_agree = sum(p == q for p, q in zip(preds, plain_preds))

    carry = masks.to(torch.bfloat16)
    packed = quant.pack_bundle(bundle)
    with torch.no_grad():
        int8_ms = device_ms(torch, lambda: quant.forward_quant(
            bundle, carry, packed=packed), reps=5)
        bf16_ms = device_ms(torch, lambda: bf16_model(
            carry, dense_heads=DENSE_HEADS_SPARSE_MODE,
            return_features=True), reps=5)
        quant.conv3x3_s8 = s8_plain_over_packed
        try:
            plain_backbone_ms = device_ms(torch, lambda: quant.forward_quant(
                bundle, carry, packed=packed), reps=5)
        finally:
            quant.conv3x3_s8 = conv_s8.conv3x3_s8
    totals, sites = conv_s8_sites(torch, bundle, packed, carry)

    # int32 accumulators against a float64 convolution of the same int8
    # tensors on the card: exact, as the sums stay far below 2^53.
    gen = torch.Generator(device="cuda").manual_seed(5)
    exact = {}
    for site, layer, shape in (("up1.0", bundle["up1"]["dc"][0][0],
                                (BATCH, 32, 32, 512)),
                               ("inc1.1", bundle["inc1"][1][0],
                                (4, 512, 512, 16)),
                               ("up1.t", bundle["up1"]["t"][0],
                                (BATCH, 16, 16, 512))):
        xq = torch.randint(-127, 128, shape, generator=gen, device="cuda",
                           dtype=torch.int8)
        x64 = xq.double().permute(0, 3, 1, 2)
        if site.endswith(".t"):
            got = quant.convt_int8(xq, layer)
            w = torch.flip(layer.double(), (0, 1)).permute(2, 3, 0, 1)
            want = torch.nn.functional.conv_transpose2d(x64, w, stride=2)
        else:
            got = quant.conv_int8(xq, layer)
            want = torch.nn.functional.conv2d(
                x64, layer.double().permute(3, 2, 0, 1), padding=1)
        want = want.permute(0, 2, 3, 1)
        exact[site] = {"k": int(layer.shape[0] * layer.shape[1]
                                * layer.shape[2]),
                       "max_abs_acc": int(got.abs().max()),
                       "equal": bool(torch.equal(got.double(), want))}
    ok = (all(e["equal"] for e in exact.values()) and
          q_rep.exact_match >= b_rep.exact_match - QUANT_EXACT_SLACK and
          peaks_equal and plain_agree == len(images) and
          launches == {**serving_launches(1), "bn_act_eval": 0,
                       "conv_s8": len(CONV_S8_SITES)})
    emit("quant_serving", ok=ok, n=len(truth), calibration_images=32,
         prepare_s=prep_s, int8_exact=q_rep.exact_match,
         bf16_exact=b_rep.exact_match, agree_with_bf16=agree,
         int8=str(q_rep), bf16=str(b_rep), launches=launches,
         peaks_equal_plain_int8=peaks_equal,
         smiles_equal_plain_int8=plain_agree,
         int8_backbone_ms=int8_ms, bf16_trunk_ms=bf16_ms,
         int8_plain_backbone_ms=plain_backbone_ms,
         conv_s8_sites_ms=totals["ms"], int32_vs_float64_conv=exact,
         gate=f"int8 exact >= bf16 exact - {QUANT_EXACT_SLACK:.4f}; peak "
              "dicts bit-equal to the plain int8 backbone's and its SMILES "
              f"{len(images)}/{len(images)}; int32 accumulators equal to a "
              "float64 conv; one unpack and one NMS launch, no BatchNorm "
              f"kernel (the int8 backbone folds them), {len(CONV_S8_SITES)} "
              "conv_s8 launches a batch",
         note="backbone ms: forward_quant through conv_s8, through "
              "conv3x3_s8_plain, and the bf16 UNet trunk + heatmap heads on "
              "the same 64 masks, median of 5 CUDA-event timings")
    if not ok:
        raise AssertionError("int8 serving below its gates")
    return launches, conv_s8_row(launches, totals, sites)


def conv_s8_row(launches, totals, sites):
    """The kernels-line row of conv_s8: the 28 sites of a batch of 64 on
    the fixture's activations (line conv_s8_sites), times and bounds
    summed over the sites."""
    by_site = {c["site"]: c for c in sites}
    bytes_sites = sum(c["bound_by"] == "bytes" for c in sites)
    return {
        "name": "conv_s8", "route": "cuda",
        "source": "abcnet_tpu_torch/csrc/conv_s8.cu",
        "replaces": "abcnet_tpu/infer/quant.py:199-204 (XLA's s8 x s8 -> "
                    "s32 convolution with the quantize and dequantize fused "
                    "around it; no Pallas counterpart)",
        "launches": launches["conv_s8"], "ms": totals["ms"],
        "plain_ms": totals["plain_ms"],
        "bound_ms": totals["bound_ms"],
        "bound_by": "bytes" if bytes_sites * 2 > len(sites)
        else "operations",
        "library_ms": None, "operations_type": "int8",
        "int_mm_ms": totals["int_mm_ms"],
        "inc1.1_ms": by_site["inc1.1"]["ms"],
        "dconv1.0_ms": by_site["dconv1.0"]["ms"],
        "shape": f"the 28 3x3 sites of forward_quant at batch {BATCH} "
                 "(CONV_S8_SITES), ms and bounds summed over them, "
                 f"{bytes_sites} sites bound by bytes; launches counted over "
                 "the quant_serving phase",
        "library": "none: PyTorch has no int8 convolution on CUDA; "
                   "int_mm_ms is torch._int_mm alone on the sites' "
                   "pre-built im2col matrices, the product without the "
                   "im2col, quantize or epilogue"}


# ---------------------------------------------------------------------------
# Slice 5: the generator, the n=256 evaluation, the CLI loop
# ---------------------------------------------------------------------------

def _sha(b):
    import hashlib

    import numpy as np
    return np.frombuffer(hashlib.sha256(b).digest(), np.uint8)


def _sample_digests(s):
    """(image, atoms, bonds, smiles) sha256 digests of a Sample (of b"" for
    None), as tests/test_torch_gen_fixture.py makes them."""
    import numpy as np
    if s is None:
        return [_sha(b"")] * 4
    return [_sha(np.ascontiguousarray(s.image).tobytes()),
            _sha(s.atoms_string.encode()), _sha(s.bonds_string.encode()),
            _sha(s.smiles.encode())]


def _digest_check(generate_sample, z):
    """The port's streams and corpus against gen_digests.npz: per stream,
    samples whose labels and SMILES are equal, images equal, attempts and
    the rng state after the stream; per corpus entry the same."""
    import random

    import numpy as np

    fields = ("image", "atoms", "bonds", "smiles")
    n = z["image"].shape[1]
    streams = []
    for i, (mode, engine, seed) in enumerate(zip(
            z["modes"].tolist(), z["engines"].tolist(), z["seeds"].tolist())):
        rng = random.Random(seed)
        got, attempts = [], 0
        while len(got) < n:
            s = generate_sample(rng, mode=mode, engine=engine)
            attempts += 1
            if s is not None:
                got.append(_sample_digests(s))
        eq = {f: sum(np.array_equal(g[j], z[f][i, k])
                     for k, g in enumerate(got))
              for j, f in enumerate(fields)}
        streams.append({
            "mode": mode, "engine": engine, "seed": seed, "n": n,
            "labels_smiles_equal": min(eq["atoms"], eq["bonds"],
                                       eq["smiles"]),
            "images_equal": eq["image"],
            "attempts_equal": attempts == int(z["attempts"][i]),
            "rng_equal": bool(np.array_equal(
                _sha(repr(rng.getstate()).encode()), z["rng"][i]))})
    rng = random.Random(31)                       # CORPUS_SEED of the fixture
    found = [generate_sample(rng, smiles=smi) for smi in z["corpus"].tolist()]
    corpus = {"n": len(found),
              "truth_equal": sum((s.smiles if s else "") == t for s, t in
                                 zip(found, z["corpus_truth"].tolist()))}
    for j, f in enumerate(fields):
        corpus[f"{f}_equal"] = sum(
            np.array_equal(_sample_digests(s)[j], z[f"corpus_{f}"][k])
            for k, s in enumerate(found))
    return streams, corpus


def _examples_check():
    """generate_examples over a spawn pool on the card's host against the
    serial concatenation of its chunks (_gen_chunk(seed + 7919·w, ...),
    every image, label array and SMILES) and against the JAX package's
    list for the same arguments (assets/examples_digests.npz: labels and
    SMILES gated, images counted as engine A's drawings are); the rate of
    the pool and of one thread."""
    import numpy as np

    from abcnet_tpu_torch.data.pipeline import _gen_chunk, generate_examples

    z = np.load(os.path.join(HERE, "abcnet_tpu_torch", "assets",
                             "examples_digests.npz"))
    n, seed, procs = int(z["n"]), int(z["seed"]), int(z["processes"])
    mode, train = str(z["mode"]), bool(z["train"])
    t0 = time.perf_counter()
    pooled = generate_examples(n, seed, mode, train, processes=procs)
    pool_s = time.perf_counter() - t0
    chunk = -(-n // procs)
    t0 = time.perf_counter()
    serial = [e for w in range(procs) if w * chunk < n for e in _gen_chunk(
        seed + 7919 * w, min(chunk, n - w * chunk), mode, train)]
    serial_s = time.perf_counter() - t0
    equal = len(pooled) == len(serial) == n and all(
        np.array_equal(a.image_u8, b.image_u8) and a.smiles == b.smiles
        and sorted(a.labels) == sorted(b.labels) and all(
            a.labels[k].dtype == b.labels[k].dtype
            and np.array_equal(a.labels[k], b.labels[k]) for k in b.labels)
        for a, b in zip(pooled, serial))

    def labels_bytes(labels):
        return b"".join(k.encode() + str(v.dtype).encode() +
                        str(v.shape).encode() +
                        np.ascontiguousarray(v).tobytes()
                        for k, v in sorted(labels.items()))

    vs_jax = {
        "labels_equal": sum(np.array_equal(_sha(labels_bytes(e.labels)), d)
                            for e, d in zip(pooled, z["labels"])),
        "smiles_equal": sum(e.smiles == str(m)
                            for e, m in zip(pooled, z["smiles"])),
        "images_bit_equal": sum(
            np.array_equal(_sha(np.ascontiguousarray(e.image_u8).tobytes()),
                           d) for e, d in zip(pooled, z["image"]))}
    # the rate of a larger list over the default pool (cpu_count - 2)
    t0 = time.perf_counter()
    big = generate_examples(EXAMPLES_BIG_N, seed, mode, train)
    big_s = time.perf_counter() - t0
    ok = equal and vs_jax["labels_equal"] == vs_jax["smiles_equal"] == n \
        and len(big) == EXAMPLES_BIG_N
    return ok, {"n": n, "seed": seed, "mode": mode, "train": train,
                "processes": procs, "pool_equal_to_chunks": equal,
                "vs_jax_digests": vs_jax, "pool_s": pool_s,
                "one_thread_s": serial_s,
                "pool_samples_per_s": n / pool_s,
                "one_thread_samples_per_s": n / serial_s,
                "default_pool": {"n": EXAMPLES_BIG_N,
                                 "processes": max(1, (os.cpu_count() or 4)
                                                  - 2),
                                 "s": big_s,
                                 "samples_per_s": EXAMPLES_BIG_N / big_s}}


def phase_generator(torch):
    """The port's generator on the card's host (no GPU work): the two
    held-out pools of final_eval against the truths of the TPU's results
    CSV, the fixture molecules' labels and drawings, the digest fixture of
    every (mode, engine) stream and the corpus mode; the generation rate."""
    import csv

    import numpy as np
    import PIL
    from PIL import features

    from abcnet_tpu_torch.data.generate import (generate_sample,
                                                generate_samples)
    from abcnet_tpu_torch.eval.final_eval import POOLS

    assets = os.path.join(HERE, "abcnet_tpu_torch", "assets")
    fixture = np.load(os.path.join(assets, "smoke_step43100.npz"))
    labels = np.load(os.path.join(assets, "train_step43100.npz"))
    t0 = time.perf_counter()
    pools = {mode: generate_samples(GEN_POOL_N, seed, mode)
             for mode, seed in POOLS}
    gen_s = time.perf_counter() - t0
    with open(os.path.join(HERE, "logs", "final_eval_step43100.csv"),
              newline="") as f:
        rows = list(csv.DictReader(f))
    # the CSV holds the rdkit pool in rows 0-255, the indigo pool after it
    truths_equal = sum(s.smiles == rows[256 * j + i]["smiles"]
                       for j, (mode, _) in enumerate(POOLS)
                       for i, s in enumerate(pools[mode]))
    n_pooled = sum(len(p) for p in pools.values())
    first = [s for mode, _ in POOLS for s in pools[mode][:32]]
    labels_equal = sum(
        s.atoms_string == str(a) and s.bonds_string == str(b)
        and s.smiles == str(m) for s, a, b, m in zip(
            first, labels["atoms_string"], labels["bonds_string"],
            labels["smiles"]))
    shares = [float(np.mean(s.image != img))
              for s, img in zip(first, fixture["images"])]
    z = np.load(os.path.join(assets, "gen_digests.npz"))
    t0 = time.perf_counter()
    streams, corpus = _digest_check(generate_sample, z)
    digest_s = time.perf_counter() - t0
    n_digest = sum(s["n"] for s in streams) + corpus["n"]
    b_equal = all(s["images_equal"] == s["n"] for s in streams
                  if s["engine"] == "b")
    labels_all = all(s["labels_smiles_equal"] == s["n"] and s["attempts_equal"]
                     and s["rng_equal"] for s in streams) and \
        corpus["truth_equal"] == corpus["n"] == corpus["atoms_equal"] \
        == corpus["bonds_equal"] == corpus["smiles_equal"]
    examples_ok, examples = _examples_check()
    ok = (truths_equal == n_pooled == 2 * GEN_POOL_N
          and labels_equal == len(first) and max(shares) < PIXEL_SHARE_MAX
          and b_equal and labels_all and examples_ok)
    emit("generator", ok=ok, pools={m: len(p) for m, p in pools.items()},
         truths_equal_tpu_csv=truths_equal, csv_rows=len(rows),
         fixture_labels_smiles_equal=labels_equal, fixture_n=len(first),
         fixture_images_bit_equal=sum(x == 0 for x in shares),
         fixture_max_differing_pixel_share=max(shares),
         pillow=PIL.__version__, freetype=features.version("freetype2"),
         digest_streams=streams, digest_corpus=corpus,
         engine_b_images_bit_equal=b_equal,
         samples_per_s=(n_pooled + n_digest) / (gen_s + digest_s),
         pools_s=gen_s, digest_s=digest_s, generate_examples=examples,
         gate=f"truths {2 * GEN_POOL_N}/{2 * GEN_POOL_N} equal to "
              "logs/final_eval_step43100.csv; fixture labels and SMILES "
              f"64/64; every fixture image differs in < {PIXEL_SHARE_MAX} "
              "of its pixels; every stream's and corpus entry's labels, "
              "SMILES, attempts and rng state equal to the digests; engine "
              "b images bit-equal; generate_examples over a spawn pool "
              "equal to the serial concatenation of its chunks, its labels "
              "and SMILES equal to the JAX package's list "
              "(assets/examples_digests.npz)",
         note="one host thread of the card's machine; samples_per_s over "
              "the pools and the digest streams; generate_examples: "
              "examples (train augmentation and labels included) per "
              "second with the pool, its spawn included, and on one thread")
    if not ok:
        raise AssertionError("the port's generator differs from the JAX "
                             "package's data")
    return pools


def phase_final_eval(torch, pools):
    """eval.final_eval in bf16 on the snapshot: per lineage the heatmap
    metric suite through trainer.eval_step at batch 16, then the serving
    loop at batch 16 with the sub-cell and the integer-cell assembler;
    overall scores and the row-by-row agreement with the TPU's
    smiles_pred of logs/final_eval_step43100.csv."""
    import csv

    from abcnet_tpu_torch.__main__ import DEFAULT_SNAPSHOT
    from abcnet_tpu_torch.eval import final_eval as fe
    from abcnet_tpu_torch.eval.scoring import score_pairs
    from abcnet_tpu_torch.models.weights import load_snapshot

    def report(r):
        return {"exact": r.exact_match,
                "exact_canonical": r.exact_match_canonical,
                "exact_isomeric": r.exact_match_isomeric,
                "dice": r.tanimoto_like, "decode_rate": r.decode_rate,
                "n": r.n}

    model, step = load_snapshot(DEFAULT_SNAPSHOT, "cuda", torch.bfloat16)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    results = fe.evaluate(model, pools=pools, verbose=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    per_lineage = {mode: {"heatmap": r.heatmap, "e2e": report(r.e2e),
                          "e2e_int_cell": report(r.e2e_int),
                          "serve_s": r.serve_s}
                   for mode, r in results.items()}
    truths, preds, preds_int = fe.overall(results)
    allrep, allrep_int = score_pairs(truths, preds), \
        score_pairs(truths, preds_int)
    with open(os.path.join(HERE, "logs", "final_eval_step43100.csv"),
              newline="") as f:
        rows = list(csv.DictReader(f))
    # the TPU's answer for each served row: rdkit in CSV rows 0-255, indigo
    # after them
    tpu = [rows[256 * j + i]["smiles_pred"]
           for j, res in enumerate(results.values())
           for i in range(len(res.truths))]
    agree = sum((p or "") == t for p, t in zip(preds, tpu))
    # every lineage's pool is a whole number of batches: each batch is
    # unpacked once for the heatmap metrics and once for serving, and its
    # two heatmaps go through one NMS launch
    n_batches = len(truths) // fe.EVAL_BATCH
    ok = (allrep.exact_match >= FINAL_EVAL_TPU_EXACT - FINAL_EVAL_SLACK
          and allrep.decode_rate >= FINAL_EVAL_DECODE_MIN
          and launches == serving_launches(n_batches, n_batches))
    emit("final_eval", ok=ok, snapshot_step=step, dtype="bfloat16",
         batch=fe.EVAL_BATCH, per_lineage=per_lineage,
         overall=report(allrep), overall_int_cell=report(allrep_int),
         agree_with_tpu_smiles_pred=agree, n=len(truths),
         tpu_reference={"exact": FINAL_EVAL_TPU_EXACT, "rdkit": 0.8906,
                        "indigo": 0.7852, "decode_rate": 1.0,
                        "source": "logs/final_eval_r5e.log"},
         batches=n_batches, launches=launches, wall_s=wall,
         gate=f"overall exact >= {FINAL_EVAL_TPU_EXACT} - {FINAL_EVAL_SLACK} "
              f"(the TPU's); decode rate >= {FINAL_EVAL_DECODE_MIN}; per "
              "batch of 16 one unpack launch for the heatmap metrics, and "
              "one unpack and one NMS launch for serving; bn_act_eval "
              f"{EVAL_BN['dense']} a metrics batch and {EVAL_BN['sparse']} a "
              "serving batch",
         mismatched_vs_tpu=[{"row": i, "port": p, "tpu": t} for i, (p, t)
                            in enumerate(zip(preds, tpu)) if (p or "") != t])
    if not ok:
        raise AssertionError("the n=256 evaluation is below its gates")
    buckets = _failure_buckets(truths, preds, allrep, launches)
    emit("final_eval_failure_buckets", **buckets)
    if not all(buckets["gates"].values()):
        raise AssertionError("the failure buckets failed their gates")
    return launches


def _failure_buckets(truths, preds, report, launches):
    """eval.classify_results and eval.failure_taxonomy through their
    main(argv): on the run's answers, written by write_results_csv to a
    temporary file (the buckets sum to n, `ok` equals score_pairs'
    isomeric hits on the same pairs, the taxonomy's lineages hold every
    struct miss), and on logs/final_eval_step43100.csv (the printouts'
    digests equal FAILURE_BUCKET_DIGESTS); no kernel is launched."""
    import hashlib
    import tempfile

    from abcnet_tpu_torch.eval import classify_results as cr
    from abcnet_tpu_torch.eval import failure_taxonomy as ft
    from abcnet_tpu_torch.eval.scoring import write_results_csv

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "final_eval.csv")
        write_results_csv(path, truths, preds)
        (buckets, _, n), text, cls_s = _entry(cr.main, [path])
        lineages, tax_text, tax_s = _entry(ft.main, [path])
    digests, committed_s = {}, {}
    for name, main_fn in (("classify_results", cr.main),
                          ("failure_taxonomy", ft.main)):
        _, out, committed_s[name] = _entry(main_fn, [os.path.join(
            HERE, "logs", "final_eval_step43100.csv")])
        digests[name] = hashlib.sha256(out.encode()).hexdigest()
    isomeric_hits = round(report.exact_match_isomeric * report.n)
    struct = {lin: rec["n"] for lin, rec in lineages.items()}
    return {
        "n": n, "buckets": buckets, "bucket_sum": sum(buckets.values()),
        "isomeric_hits": isomeric_hits, "struct_by_lineage": struct,
        "primary_by_lineage": {lin: dict(rec["primary"])
                               for lin, rec in lineages.items()},
        "digests": digests, "printout": text, "taxonomy_printout": tax_text,
        "seconds": {"classify_results": cls_s, "failure_taxonomy": tax_s,
                    "committed_csv": committed_s},
        "gates": {
            "buckets_sum_to_n": sum(buckets.values()) == n == len(truths),
            "ok_is_the_isomeric_hits": buckets.get("ok", 0) == isomeric_hits,
            "taxonomy_holds_every_struct_miss":
                sum(struct.values()) == buckets.get("struct", 0),
            "no_launch": read_launches() == launches,
            "committed_csv_printouts_are_the_scripts":
                digests == FAILURE_BUCKET_DIGESTS,
        },
    }


def _cli(argv):
    """abcnet_tpu_torch's main(argv) with its standard output captured."""
    import contextlib
    import io

    from abcnet_tpu_torch.__main__ import main as cli_main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli_main(argv)
    return buf.getvalue()


def _entry(main_fn, argv):
    """(what main_fn(argv) returned or exited with, its standard output,
    seconds)."""
    import contextlib
    import io

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        try:
            out = main_fn(argv)
        except SystemExit as e:
            out = e.code
    return out, buf.getvalue(), time.perf_counter() - t0


def _peaks_equal(want, got):
    import numpy as np
    return sorted(want) == sorted(got) and all(
        want[k].dtype == got[k].dtype and np.array_equal(want[k], got[k])
        for k in want)


def _score_fields(line):
    """{field: value} of a printed ScoreReport line."""
    return {k: float(v) for k, v in (t.split("=") for t in line.split())}


def serve_and_score_checkpoint(torch, ds, ck, tmp, module, times, by_path):
    """img2smiles --ckpt CK and test-acc --ckpt CK on the gen set `ds`
    through main(), the serving pipeline's host peak dicts and test-acc's
    counts recorded on the way, against the same two paths on `module`,
    the model fit left in memory. Launches counted under
    img2smiles_ckpt and test_acc_ckpt."""
    import random

    import numpy as np

    from abcnet_tpu_torch import __main__ as cli
    from abcnet_tpu_torch.data import pipeline
    from abcnet_tpu_torch.infer import decode

    served, counted = [], []
    make, totals = decode.make_infer_pipeline, cli.per_class_totals

    def recording_pipeline(*a, **kw):
        run = make(*a, **kw)
        fetch = run.fetch

        def fetch_and_keep(handle):
            served.append(fetch(handle))
            return served[-1]
        run.fetch = fetch_and_keep
        return run

    def recording_totals(*a, **kw):
        counted.append(totals(*a, **kw))
        return counted[-1]

    decode.make_infer_pipeline = recording_pipeline
    cli.per_class_totals = recording_totals
    try:
        reset_launches()
        t0 = time.perf_counter()
        serve_out = _cli(["img2smiles", "--data", ds, "--ckpt", ck,
                          "--out", os.path.join(tmp, "results_ck.csv")])
        torch.cuda.synchronize()
        times["img2smiles_ckpt"] = time.perf_counter() - t0
        by_path["img2smiles_ckpt"] = read_launches()
        reset_launches()
        t0 = time.perf_counter()
        test_acc_out = _cli(["test-acc", "--data", ds, "--ckpt", ck])
        torch.cuda.synchronize()
        times["test_acc_ckpt"] = time.perf_counter() - t0
        by_path["test_acc_ckpt"] = read_launches()
    finally:
        decode.make_infer_pipeline, cli.per_class_totals = make, totals
    first = serve_out.strip().splitlines()[0]
    printed = int(first.rsplit("(step ", 1)[1].rstrip(")"))
    images, _ = pipeline.load_image_csv(os.path.join(ds, "dataset.csv"))
    batch = 64                                # img2smiles' default -b
    n_serve = -(-len(images) // batch)
    run = make(module, "cuda")
    want = [run(np.stack(images[i:i + batch]))
            for i in range(0, len(images), batch)]
    peaks_equal = len(served) == len(want) and all(
        _peaks_equal(w, g) for g, w in zip(served, want))
    rng = random.Random(0)
    examples = [pipeline.sample_to_example(s, rng, train=False) for s in
                pipeline.load_csv_dataset(os.path.join(ds, "dataset.csv"))]
    batch_acc = 16                            # test-acc's default -b
    want_counts = totals(module, examples, batch_acc)
    counts_equal = len(counted) == 1 and sorted(counted[0]) == \
        sorted(want_counts) and all(
            torch.equal(a, b) for g in want_counts
            for a, b in zip(counted[0][g], want_counts[g]))
    n_acc = len(examples) // batch_acc
    launches_ok = (by_path["img2smiles_ckpt"] == serving_launches(n_serve)
                   and by_path["test_acc_ckpt"] == serving_launches(0, n_acc))
    return {"ok": peaks_equal and counts_equal and launches_ok,
            "weights_line": first, "printed_step": printed,
            "serving_batches": n_serve, "peaks_equal_in_memory": peaks_equal,
            "test_acc_batches": n_acc, "counts_equal_in_memory": counts_equal,
            "score": _score_fields(serve_out.strip().splitlines()[-1]),
            "test_acc_report_lines": len(test_acc_out.strip().splitlines())}


def phase_cli_loop(torch):
    """gen -> train --synthetic -> img2smiles -> test-acc -> cal-acc (truths
    as SMILES and as InChI) through the port's main() in a temporary
    directory; then test-acc's counting in f32 on fixture rows 0-15 against
    the JAX package's counts (assets/test_acc_step43100.npz)."""
    import csv
    import random
    import tempfile

    import numpy as np

    from abcnet_tpu_torch.__main__ import DEFAULT_SNAPSHOT, per_class_totals
    from abcnet_tpu_torch.chem.inchi import smiles_to_inchi
    from abcnet_tpu_torch.data import pipeline
    from abcnet_tpu_torch.data.generate import Sample
    from abcnet_tpu_torch.models.weights import load_snapshot
    from abcnet_tpu_torch.train import trainer

    by_path, times = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        ds = os.path.join(tmp, "ds")
        t0 = time.perf_counter()
        _cli(["gen", "--out", ds, "-n", "64", "--engine", "mix",
              "--seed", "0"])
        times["gen"] = time.perf_counter() - t0
        with open(os.path.join(ds, "dataset.csv"), newline="") as f:
            n_gen = sum(1 for _ in csv.DictReader(f))

        # train --synthetic: every step's losses kept (fit calls the
        # module's train_step), the noise kernel's launches counted, the
        # state that fit returns kept
        totals, terms, noisy, fitted = [], [], [0], []
        step_fn, metrics_fn = trainer.train_step, trainer.train_metrics_step
        fit_fn = trainer.fit

        def recording_step(*a, **kw):
            out = step_fn(*a, **kw)
            totals.append(float(out[1]))
            terms.append({k: float(v) for k, v in out[2].items()})
            noisy[0] += 1
            return out

        def counting_metrics(*a, **kw):
            noisy[0] += 1
            return metrics_fn(*a, **kw)

        def keeping_fit(*a, **kw):
            fitted.append(fit_fn(*a, **kw))
            return fitted[-1]

        ck = os.path.join(tmp, "ck")
        trainer.train_step, trainer.train_metrics_step, trainer.fit = \
            recording_step, counting_metrics, keeping_fit
        reset_launches()
        t0 = time.perf_counter()
        try:
            train_out = _cli(["train", "--synthetic", "256", "-b", "64",
                              "--epochs", "1", "--ckpt", ck])
        finally:
            trainer.train_step, trainer.train_metrics_step, trainer.fit = \
                step_fn, metrics_fn, fit_fn
        torch.cuda.synchronize()
        times["train_synthetic"] = time.perf_counter() - t0
        by_path["gen_train_synthetic"] = read_launches()
        ckpts = sorted(os.listdir(ck)) if os.path.isdir(ck) else []
        finite = bool(totals) and all(
            np.isfinite(t) for t in totals) and all(
            np.isfinite(v) for d in terms for v in d.values())

        results = os.path.join(tmp, "results.csv")
        reset_launches()
        t0 = time.perf_counter()
        serve_out = _cli(["img2smiles", "--data", ds, "--out", results])
        torch.cuda.synchronize()
        times["img2smiles"] = time.perf_counter() - t0
        by_path["img2smiles_gen"] = read_launches()
        serve_score = _score_fields(serve_out.strip().splitlines()[-1])

        reset_launches()
        t0 = time.perf_counter()
        test_acc_out = _cli(["test-acc", "--data", ds])
        torch.cuda.synchronize()
        times["test_acc"] = time.perf_counter() - t0
        by_path["test_acc"] = read_launches()

        trained = fitted[0]
        ckpt = serve_and_score_checkpoint(torch, ds, ck, tmp, trained.model,
                                          times, by_path)
        ckpt["fit_step"] = trained.step
        del fitted, trained
        torch.cuda.empty_cache()

        inchi_csv = os.path.join(tmp, "results_inchi.csv")
        with open(results, newline="") as f:
            rows = list(csv.DictReader(f))
        with open(inchi_csv, "w", newline="") as f:
            w = csv.writer(f, lineterminator="\n")
            w.writerow(["", "InChI", "smiles_pred"])
            for r in rows:
                w.writerow([r[""], smiles_to_inchi(r["smiles"]),
                            r["smiles_pred"]])
        t0 = time.perf_counter()
        cal = _score_fields(_cli(["cal-acc", results]).strip())
        cal_inchi = _score_fields(_cli(["cal-acc", inchi_csv]).strip())
        times["cal_acc_both"] = time.perf_counter() - t0

    # test-acc's counting in f32, TF32 off, on fixture rows 0-15
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    assets = os.path.join(HERE, "abcnet_tpu_torch", "assets")
    fixture = np.load(os.path.join(assets, "smoke_step43100.npz"))
    labels = np.load(os.path.join(assets, "train_step43100.npz"))
    want = np.load(os.path.join(assets, "test_acc_step43100.npz"))
    rows16 = int(want["rows"])
    rng = random.Random(0)
    examples = [pipeline.sample_to_example(
        Sample(fixture["images"][i], str(labels["atoms_string"][i]),
               str(labels["bonds_string"][i]), str(labels["smiles"][i])),
        rng, train=False) for i in range(rows16)]
    model, _ = load_snapshot(DEFAULT_SNAPSHOT, "cuda", torch.float32)
    got = {k: torch.stack(v).numpy() for k, v in per_class_totals(
        model, examples, int(want["batch"])).items()}
    count_diff = {g: int(np.abs(got[g] - want[f"counts_{g}"]).max())
                  for g in want["groups"].tolist()}
    count_ok = all(
        (np.abs(got[g] - want[f"counts_{g}"])
         <= np.maximum(TESTACC_ABS, TESTACC_REL * want[f"counts_{g}"])).all()
        for g in want["groups"].tolist())

    steps = len(totals)
    trained_n = by_path["gen_train_synthetic"]
    noise = trained_n["unpack_noise"]
    # a dense eval forward a metrics step and an evaluation batch (each
    # unpacks once); sparse serving batches of 64, test-acc batches of 16
    launches_ok = (
        trained_n["bn_act_eval"] == EVAL_BN["dense"] * (
            noisy[0] - steps + trained_n["unpack_bits"])
        and by_path["img2smiles_gen"] == serving_launches(-(-n_gen // 64))
        and by_path["test_acc"] == serving_launches(0, n_gen // 16))
    same_metrics = ("exact_canonical", "decode_rate", "n", "decoded")
    ok = (n_gen == 64 and finite and steps > 0 and noise == noisy[0]
          and launches_ok
          and bool(ckpts) and "exact" in serve_score
          and "== atom_type ==" in test_acc_out and count_ok
          and all(cal[k] == cal_inchi[k] for k in same_metrics)
          and cal == serve_score and ckpt["ok"]
          and ckpt["printed_step"] == ckpt["fit_step"] == steps)
    emit("cli_loop", ok=ok, gen_n=n_gen,
         train={"steps": steps, "noisy_forward_passes": noisy[0],
                "totals": totals, "finite": finite, "checkpoints": ckpts,
                "first_line": train_out.strip().splitlines()[0]
                if train_out.strip() else ""},
         img2smiles=serve_score, cal_acc_smiles=cal, cal_acc_inchi=cal_inchi,
         trained_checkpoint=ckpt,
         test_acc_report_lines=len(test_acc_out.strip().splitlines()),
         test_acc_f32_rows=rows16, test_acc_f32_counts=
         {g: v.tolist() for g, v in got.items()},
         test_acc_f32_max_count_diff_vs_jax=count_diff,
         launches_by_path=by_path, times_s=times,
         gate="gen wrote 64; finite losses; unpack_noise launches == noisy "
              "forward passes; a checkpoint; img2smiles scored, cal-acc of "
              "its CSV prints its score; the InChI truths give the same "
              "exact_canonical, decode rate, n and decoded (the InChI reader "
              "drops stereo layers, so the stereo-aware exact, "
              "exact_isomeric and dice are reported only); the f32 counts "
              f"within max({TESTACC_ABS}, {TESTACC_REL} x count) of the JAX "
              "package's; img2smiles and test-acc --ckpt of the checkpoint "
              "directory load the step fit ended at, their peak dicts and "
              "counts equal to the module fit left in memory, bit for bit, "
              "one unpack and one NMS launch per serving batch, one unpack "
              "per test-acc batch; bn_act_eval "
              f"{EVAL_BN['sparse']} a serving batch, {EVAL_BN['dense']} a "
              "test-acc batch, a metrics step and an evaluation batch of "
              "train, and no train-mode bn_act outside train")
    if not ok:
        raise AssertionError("the CLI loop failed its gates")
    return by_path


def _bench_cli(argv):
    """`python -m abcnet_tpu_torch bench ARGV` through the CLI's main() in
    this process: (exit code, record, seconds)."""
    from abcnet_tpu_torch.__main__ import main as cli_main

    code, text, seconds = _entry(cli_main, ["bench", *argv])
    return code or 0, json.loads(text.strip().splitlines()[-1]), seconds


def phase_bench(torch):
    """The `bench` sub-command: `bench` (sparse, then its train steps at
    the default --train-batch) and `bench --dense --skip-train` through
    the CLI's main(), then the bench's train steps alone, launch counts
    set to 0 before each and read after it; the records gated; the
    bench's serving program on the clean-carry batch of buffer 0 against
    make_infer_pipeline on its images, with the weights the records
    name."""
    import math

    from abcnet_tpu_torch import bench
    from abcnet_tpu_torch.__main__ import DEFAULT_SNAPSHOT
    from abcnet_tpu_torch.data.pipeline import pack_images
    from abcnet_tpu_torch.infer.decode import (make_infer_pipeline,
                                               sparse_heads)
    from abcnet_tpu_torch.models import UNet

    times = {}
    calls = min(bench.WARMUP, bench.N_BUFFERS) + 3 * bench.ITERS + 3
    records, by_path, gates = {}, {}, {}
    for mode, argv in (("sparse", []), ("dense", ["--dense",
                                                  "--skip-train"])):
        torch.cuda.empty_cache()
        reset_launches()
        code, rec, times[mode] = _bench_cli(argv)
        n = read_launches()
        records[mode] = rec
        train = mode == "sparse"
        rates = ["value", "sync_ips", "e2e_smiles_ips"] + (
            ["train_step_ips"] if train else [])
        gates[mode] = {
            "exit_0_no_error": code == 0 and "error" not in rec,
            "rates_finite_positive": all(
                isinstance(rec.get(k), (int, float))
                and math.isfinite(rec[k]) and rec[k] > 0 for k in rates),
            "implied_tflops_le_peak": 0 < rec.get("implied_tflops", -1)
            <= bench.H100_PEAK_TFLOPS,
            "launches": n["unpack_bits"] == n["nms_topk"] == calls
            and n["unpack_noise"] == (bench.TRAIN_STEPS if train else 0)
            and n["bn_act_eval"] == EVAL_BN[mode] * calls,
            "weights_default_snapshot":
                (rec.get("weights") or {}).get("path") == DEFAULT_SNAPSHOT,
        }
        if train:
            gates[mode]["train_batch_default"] = \
                rec.get("train_batch") == BENCH_TRAIN_BATCH
            gates[mode]["train_peak"] = (rec.get("train_peak_gib") or 1e9) \
                <= BENCH_PEAK_GIB[BENCH_TRAIN_BATCH]
            gates[mode]["bn_act_launches"] = \
                n["bn_act"] == train_bn_launches(UNet(), bench.TRAIN_STEPS)
        by_path[f"bench_{mode}"] = dict(n)
        emit("bench_record", mode=mode, exit_code=code, record=rec,
             launches=n, serving_calls=calls)

    # The train steps alone, so that their path's counts are read apart
    # from serving's: at the default batch and at BATCH, each peak gated.
    for train_batch, path in ((BENCH_TRAIN_BATCH, "bench_train"),
                              (BATCH, f"bench_train_{BATCH}")):
        torch.cuda.empty_cache()
        reset_launches()
        t0 = time.perf_counter()
        step_s, peak = bench.train_bench(train_batch, "cuda",
                                         torch.bfloat16)
        times[path] = time.perf_counter() - t0
        n = read_launches()
        by_path[path] = dict(n)
        gates[path] = {
            "launches": n["unpack_bits"] == n["nms_topk"] == 0
            and n["unpack_noise"] == bench.TRAIN_STEPS
            and n["bn_act"] == train_bn_launches(UNet(), bench.TRAIN_STEPS)
            and n["bn_act_eval"] == 0,
            "step_finite_positive": math.isfinite(step_s) and step_s > 0,
            "peak": peak <= BENCH_PEAK_GIB[train_batch],
        }
        emit("bench_train", train_batch=train_batch,
             train_step_ms=step_s * 1e3, train_peak_gib=peak,
             peak_limit_gib=BENCH_PEAK_GIB[train_batch], launches=n)

    # The clean-carry batch of buffer 0 is the served program's answer.
    t0 = time.perf_counter()
    dev = torch.device("cuda")
    model, _ = bench.load_model(DEFAULT_SNAPSHOT, dev)
    images = bench.real_batch_images(9000, BATCH)
    bits = torch.from_numpy(pack_images(images, 0.6)).to(dev)
    zero = torch.zeros((), dtype=torch.uint8, device=dev)
    served = {}
    for mode in ("sparse", "dense"):
        heads = sparse_heads(model, model.dtype) if mode == "sparse" \
            else None
        got, _ = bench.serve_step(model, heads, bits, zero)
        got = {k: v.cpu().numpy() for k, v in got.items()}
        want = make_infer_pipeline(model, dev, sparse=mode == "sparse")(
            images)
        served[mode] = _peaks_equal(want, got)
    times["served_check"] = time.perf_counter() - t0
    del model
    torch.cuda.empty_cache()

    ok = all(all(g.values()) for g in gates.values()) and all(
        served.values())
    emit("bench", ok=ok, gates=gates,
         clean_batch_equals_make_infer_pipeline=served,
         launches_by_path=by_path, times_s=times,
         gate="exit 0 and no error; value, sync_ips, e2e_smiles_ips (and "
              "train_step_ips) finite and > 0; 0 < implied_tflops <= "
              f"{bench.H100_PEAK_TFLOPS}; one unpack and one NMS launch per "
              f"call of the serving program ({calls}), one noise launch per "
              f"train step ({bench.TRAIN_STEPS}) and four bn_act launches "
              f"a BatchNorm a train step in the sparse record and in the "
              f"train steps alone; bn_act_eval {EVAL_BN['sparse']} (sparse) "
              f"or {EVAL_BN['dense']} (dense) a serving call and none in "
              f"the train steps alone; the default train batch "
              f"{BENCH_TRAIN_BATCH}; train peaks <= {BENCH_PEAK_GIB} GiB "
              f"by batch; the records' weights the default "
              "snapshot; the clean-carry peak dict of buffer 0 bit-equal "
              "to make_infer_pipeline on its images, sparse and dense")
    if not ok:
        raise AssertionError("the bench phase failed its gates")
    return by_path


# ---------------------------------------------------------------------------
# Slice 8: the evaluation suite (decode ceiling, robustness sweep,
# cross-engine transfer, end-to-end overfit check)
# ---------------------------------------------------------------------------

def _tpu_degraded_table():
    """{variant: [exact, exact_noniso, dice, decode]} of the TPU's sweep at
    step 37500 (logs/degraded_r5d.log)."""
    from abcnet_tpu_torch.eval.degraded_bench import VARIANTS

    names = {name for name, _, _ in VARIANTS}
    out = {}
    with open(os.path.join(HERE, "logs", "degraded_r5d.log")) as f:
        for line in f:
            t = line.split()
            if t and t[0] in names:
                out[t[0]] = [float(x) for x in t[1:5]]
    return out


def _eval_decode_ceiling(torch, by_path):
    from abcnet_tpu_torch.eval import decode_ceiling as dc

    n_mode, seed0 = int(CEILING_ARGS[0]), int(CEILING_ARGS[1])
    torch.cuda.synchronize()
    reset_launches()
    res, text, secs = _entry(dc.main, list(CEILING_ARGS))
    torch.cuda.synchronize()
    n = read_launches()
    by_path["decode_ceiling"] = n
    t0 = time.perf_counter()
    cpu = dc.ceiling(CEILING_CPU_N, seed0, device="cpu", verbose=False)
    cpu_s = time.perf_counter() - t0
    same, agree = {}, {}
    for m in dc.MODES:
        last = cpu[m].outcomes[-1][0]
        card = res[m].outcomes[:CEILING_CPU_N]
        same[m] = ([o[:2] for o in card] == [o[:2] for o in cpu[m].outcomes]
                   and [f for f in res[m].fails if f[0] <= last]
                   == cpu[m].fails)
        agree[m] = sum(a == b for a, b in zip(card, cpu[m].outcomes))
    printed = "".join(line + "\n" for m in dc.MODES
                      for line in res[m].lines())
    gates = {
        "ok_per_mode": all(res[m].made == n_mode and res[m].buckets.get(
            "ok", 0) >= CEILING_MIN_OK for m in dc.MODES),
        "launches": n["nms_topk"] == len(dc.MODES) * n_mode
        and n["unpack_bits"] == n["unpack_noise"] == n["bn_act_eval"] == 0,
        "equal_to_cpu_run": all(same.values()),
        "printed_the_result": text == printed,
    }
    emit("eval_decode_ceiling", argv=list(CEILING_ARGS),
         per_mode={m: {"made": r.made, "buckets": r.buckets,
                       "fails": r.fails} for m, r in res.items()},
         output=text, launches=n, seconds=secs,
         cpu_run={"n_per_mode": CEILING_CPU_N, "seconds": cpu_s,
                  "buckets": {m: r.buckets for m, r in cpu.items()},
                  "outcomes_equal_to_card": agree},
         tpu_reference={"rdkit": "150/150", "indigo": "150/150",
                        "source": "logs/decode_ceiling_r2.log"},
         gates=gates)
    return gates, secs + cpu_s


def _eval_degraded(torch, by_path):
    import numpy as np

    from abcnet_tpu_torch.__main__ import DEFAULT_SNAPSHOT
    from abcnet_tpu_torch.data.generate import generate_samples
    from abcnet_tpu_torch.eval import degraded_bench as db
    from abcnet_tpu_torch.infer.decode import make_infer_pipeline
    from abcnet_tpu_torch.models.weights import load_weights

    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    reset_launches()
    rows, text, secs = _entry(db.main, [str(DEGRADED_N)])
    torch.cuda.synchronize()
    n = read_launches()
    by_path["degraded_bench"] = n
    by_name = {r.name: r for r in rows}
    # The first batch of each variant, served by make_infer_pipeline at the
    # variant's threshold called directly: the entry point adds nothing.
    t0 = time.perf_counter()
    model, _ = load_weights(DEFAULT_SNAPSHOT, "cuda", torch.bfloat16)
    first = generate_samples(db.BATCH, 0)
    runs = {thr: make_infer_pipeline(model, "cuda", threshold=thr)
            for thr in {t for _, _, t in db.VARIANTS}}
    direct = {name: _peaks_equal(
        runs[thr](np.stack([fn(s.image) for s in first])),
        by_name[name].first_peaks) for name, fn, thr in db.VARIANTS}
    direct_s = time.perf_counter() - t0
    del model, runs
    tpu = _tpu_degraded_table()
    table = {r.name: {"threshold": r.threshold,
                      "port": [r.report.exact_match,
                               r.report.exact_match_canonical,
                               r.report.tanimoto_like, r.report.decode_rate],
                      "tpu_step37500": tpu.get(r.name),
                      "seconds": r.seconds} for r in rows}
    clean = by_name["clean"].report
    batches = DEGRADED_N // db.BATCH
    gates = {
        "variants": [r.name for r in rows] == [v[0] for v in db.VARIANTS],
        "clean_decode": clean.decode_rate >= DEGRADED_DECODE_MIN,
        "clean_exact": clean.exact_match
        >= DEGRADED_TPU_CLEAN_EXACT - EVAL_NEAR_TIE,
        "threshold_applied": by_name["gray_scan_thr0.2"].report.exact_match
        > by_name["gray_scan_thr0.6_control"].report.exact_match,
        "launches": n["unpack_bits"] == n["nms_topk"]
        == len(db.VARIANTS) * batches and n["unpack_noise"] == 0
        and n["bn_act_eval"] == EVAL_BN["sparse"] * n["nms_topk"],
        "first_batch_equals_make_infer_pipeline": all(direct.values()),
    }
    emit("eval_degraded_bench", argv=[str(DEGRADED_N)], columns=[
        "exact", "exact_noniso", "dice", "decode"], table=table,
         output=text, launches=n, seconds=secs,
         direct_check={"equal": direct, "seconds": direct_s},
         tpu_reference="logs/degraded_r5d.log (step 37500, n=128)",
         gates=gates)
    return gates, secs + direct_s


def _eval_cross_engine(torch, by_path):
    from abcnet_tpu_torch.eval import cross_engine_eval as ce

    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    reset_launches()
    res, text, secs = _entry(ce.main, [str(CROSS_N)])
    torch.cuda.synchronize()
    n = read_launches()
    by_path["cross_engine"] = n
    a = res["a"].report
    gates = {
        "pools_aligned": res["a"].truths == res["b"].truths
        and len(res["a"].truths) == CROSS_N,
        "eval_on_a_exact": a.exact_match
        >= CROSS_TPU_EXACT["a"] - EVAL_NEAR_TIE,
        "eval_on_a_decode": a.decode_rate >= CROSS_DECODE_MIN,
        "launches": n["unpack_bits"] == n["nms_topk"]
        == len(ce.ENGINES) * CROSS_N // ce.EVAL_BATCH
        and n["unpack_noise"] == 0
        and n["bn_act_eval"] == EVAL_BN["sparse"] * n["nms_topk"],
    }
    emit("eval_cross_engine", argv=[str(CROSS_N)],
         per_engine={e: {"exact": r.report.exact_match,
                         "exact_canonical": r.report.exact_match_canonical,
                         "exact_isomeric": r.report.exact_match_isomeric,
                         "dice": r.report.tanimoto_like,
                         "decode_rate": r.report.decode_rate,
                         "seconds": r.seconds} for e, r in res.items()},
         tpu_reference={"exact": CROSS_TPU_EXACT, "step": 37500,
                        "source": "logs/cross_engine_r5d.log"},
         output=text, launches=n, seconds=secs, gates=gates)
    return gates, secs


def _eval_e2e_overfit(torch, by_path):
    import math
    import re

    from abcnet_tpu_torch.eval import e2e_overfit as eo

    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    reset_launches()
    code, text, secs = _entry(eo.main, list(E2E_ARGS))
    torch.cuda.synchronize()
    n = read_launches()
    by_path["e2e_overfit"] = n
    lines = text.splitlines()
    logged = [(int(m[1]), float(m[2])) for m in (
        re.match(r"epoch \d+ step (\d+) loss (\S+)", x) for x in lines) if m]
    trained = next(re.match(r"trained (\d+) steps in (\S+)s \((\S+) img/s\)",
                            x) for x in lines if x.startswith("trained "))
    steps = int(trained[1])
    e2e = _score_fields(next(x for x in lines if x.startswith("E2E: "))[5:])
    examples = int(E2E_ARGS[0])
    want_steps = int(E2E_ARGS[1]) * (examples // eo.BATCH)
    decode_batches = len(eo.decode_rows(examples))
    losses = [v for _, v in logged]
    gates = {
        "steps": steps == want_steps,
        "loss_finite_and_falls": bool(losses) and all(
            math.isfinite(v) for v in losses) and losses[-1] < losses[0],
        "exit_code_follows_printed_exact":
            code == (0 if e2e["exact"] > 0 else 1)
            and (lines[-1] == "E2E SLICE OK") == (code == 0),
        # train_step(with_metrics=True) reads its metrics from the step's
        # own forward: no second noise launch in a metrics step
        "launches": n["unpack_noise"] == steps
        and n["unpack_bits"] == n["nms_topk"] == decode_batches
        and n["bn_act_eval"] == EVAL_BN["sparse"] * decode_batches,
    }
    emit("eval_e2e_overfit", argv=list(E2E_ARGS), exit_code=code,
         steps=steps, train_s=float(trained[2]),
         img_per_s=float(trained[3]), logged_losses=logged, e2e=e2e,
         noise_launches_in_metrics_steps=n["unpack_noise"] - steps,
         output=text, launches=n, seconds=secs, gates=gates)
    return gates, secs


def phase_eval_suite(torch):
    """The README's evaluation entry points through main(argv), launch
    counts set to 0 before each and read after it: eval.decode_ceiling
    150 1000 (the card's buckets and failures against the port's CPU run
    on the first seeds), eval.degraded_bench 128 (every variant's first
    batch against make_infer_pipeline at its threshold), eval.
    cross_engine_eval 128 and eval.e2e_overfit 64 75."""
    by_path, gates, times = {}, {}, {}
    for name, fn in (("decode_ceiling", _eval_decode_ceiling),
                     ("degraded_bench", _eval_degraded),
                     ("cross_engine", _eval_cross_engine),
                     ("e2e_overfit", _eval_e2e_overfit)):
        gates[name], times[name] = fn(torch, by_path)
    torch.cuda.empty_cache()
    ok = all(all(g.values()) for g in gates.values())
    emit("eval_suite", ok=ok, gates=gates, launches_by_path=by_path,
         seconds=times,
         gate=f"decode_ceiling >= {CEILING_MIN_OK}/{CEILING_ARGS[0]} ok a "
              f"mode, one NMS launch a sample, buckets and failures equal "
              f"to the port's CPU run on the first {CEILING_CPU_N} samples "
              f"a mode; degraded_bench clean decode >= {DEGRADED_DECODE_MIN}"
              f" and exact >= {DEGRADED_TPU_CLEAN_EXACT} - 8/128, gray scan "
              "at 0.2 above its 0.6 control, one unpack and one NMS launch a "
              "batch, each variant's first batch bit-equal to "
              "make_infer_pipeline; cross_engine pools aligned, eval-on-a "
              f"exact >= {CROSS_TPU_EXACT['a']} - 8/128 and decode >= "
              f"{CROSS_DECODE_MIN}, one unpack and one NMS launch a batch; "
              "e2e_overfit loss finite and falling, exit code 0 iff the "
              "printed exact > 0, one noise launch a step, one unpack and "
              "one NMS launch a decode batch; bn_act_eval "
              f"{EVAL_BN['sparse']} a serving batch, none in the ceiling")
    if not ok:
        raise AssertionError("the evaluation suite failed its gates")
    return by_path


# ---------------------------------------------------------------------------
# Slice 9: the production training recipe
# ---------------------------------------------------------------------------

def _counted(torch, by_path, path, main_fn, argv):
    """main_fn(argv) through _entry with the launch counts set to 0 just
    before and read just after (under `path`), and the peak memory of the
    run: (returned, output, seconds, launches, peak GiB)."""
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    out, text, secs = _entry(main_fn, argv)
    torch.cuda.synchronize()
    by_path[path] = read_launches()
    return (out, text, secs, by_path[path],
            torch.cuda.max_memory_allocated() / 2 ** 30)


def _recipe_pool(torch, tmp, by_path):
    """build_pool_r5 at RECIPE_TRAIN_N against assets/pool_r5_digests.npz
    (the JAX script's 256 eval rows and first 256 train rows)."""
    import numpy as np
    import PIL
    from PIL import features

    from abcnet_tpu_torch.data.pipeline import pack_images
    from abcnet_tpu_torch.train import build_pool_r5 as bp

    path = os.path.join(tmp, "pool_r5.npz")
    res, text, secs, n, _ = _counted(torch, by_path, "pool_r5", bp.main,
                                     [path, str(RECIPE_TRAIN_N)])
    z = np.load(os.path.join(HERE, "abcnet_tpu_torch", "assets",
                             "pool_r5_digests.npz"))
    m = len(z["smiles"])
    rows = res.samples[:m]
    equal = {
        "smiles": sum(s.smiles == t for s, t in zip(rows,
                                                    z["smiles"].tolist())),
        "atoms": sum(np.array_equal(_sha(s.atoms_string.encode()), d)
                     for s, d in zip(rows, z["atoms"])),
        "bonds": sum(np.array_equal(_sha(s.bonds_string.encode()), d)
                     for s, d in zip(rows, z["bonds"])),
        "lineage": sum(a == b for a, b in zip(res.modes, z["modes"].tolist())),
        "engine": sum(a == b for a, b in zip(res.engines,
                                             z["engines"].tolist())),
    }
    same = [np.array_equal(_sha(np.ascontiguousarray(s.image).tobytes()), d)
            for s, d in zip(rows, z["image"])]
    engines = z["engines"].tolist()
    images = {e: {"rows": engines.count(e),
                  "bit_equal": sum(ok for ok, x in zip(same, engines)
                                   if x == e)} for e in ("a", "b")}
    masks = pack_images(np.stack([s.image for s in rows[:len(z["masks"])]]))
    share = np.unpackbits(masks ^ z["masks"][:len(masks)], axis=-1).reshape(
        len(masks), -1).mean(axis=1)
    gates = {
        "rows": len(res.samples) == bp.EVAL_N + RECIPE_TRAIN_N,
        "labels_smiles_lineage_engine": all(v == m for v in equal.values()),
        "engine_b_images_bit_equal":
            images["b"]["bit_equal"] == images["b"]["rows"] > 0,
        "engine_a_mask_pixels": float(share.max()) <= PIXEL_SHARE_MAX,
        "no_launches": not any(n.values()),
    }
    emit("recipe_pool_r5", argv=[path, str(RECIPE_TRAIN_N)],
         rows=len(res.samples), fixture_rows=m, equal=equal, images=images,
         mask_rows=len(masks), mask_pixel_share=share.tolist(),
         samples_per_s=res.samples_per_s, generate_s=res.seconds,
         pillow=PIL.__version__, freetype=features.version("freetype2"),
         output=text, launches=n, seconds=secs, gates=gates)
    return path, gates, secs


def _recipe_reference(torch, pool):
    """The committed snapshot's own numbers on the pool's eval split:
    recipe.run_eval (EVAL's metrics) and the split served at batch 16 and
    scored (FINAL's report)."""
    import numpy as np

    from abcnet_tpu_torch.data.pool import load_pool
    from abcnet_tpu_torch.eval.scoring import score_pairs
    from abcnet_tpu_torch.infer.assemble import assemble_batch
    from abcnet_tpu_torch.infer.decode import make_infer_pipeline
    from abcnet_tpu_torch.models.weights import load_weights
    from abcnet_tpu_torch.train import build_pool_r5 as bp
    from abcnet_tpu_torch.train import recipe, trainer

    t0 = time.perf_counter()
    model, step = load_weights(recipe.DEFAULT_SNAPSHOT, "cuda",
                               torch.bfloat16)
    eval_samples, train_samples, eval_examples, _ = recipe.split_pool(
        load_pool(pool), bp.EVAL_N)
    state = trainer.create_state(trainer.TrainConfig(), model=model)
    metrics = recipe.run_eval(state, eval_examples, log=lambda line: None)
    run = make_infer_pipeline(model, "cuda")
    preds = []
    for i in range(0, len(eval_samples), recipe.EVAL_BATCH):
        preds.extend(assemble_batch(run(np.stack(
            [s.image for s in eval_samples[i:i + recipe.EVAL_BATCH]]))))
    report = score_pairs([s.smiles for s in eval_samples], preds)
    ref = {"step": step, "eval": metrics, "final": report,
           "seconds": time.perf_counter() - t0}
    del state
    return model, train_samples, ref


def _recipe_train_r5(torch, tmp, pool, fixture, by_path):
    """train_r5 for RECIPE_TRAIN_S from a seeded init: the schedule, the
    loss, EVAL, the checkpoint, the float16 snapshot against the rule and
    served beside the weights the run ended with, the commit."""
    import math
    import shutil

    import numpy as np

    from abcnet_tpu_torch.infer.assemble import assemble_batch
    from abcnet_tpu_torch.infer.decode import make_infer_pipeline
    from abcnet_tpu_torch.models import UNet
    from abcnet_tpu_torch.models.weights import (f16_is_exact, load_snapshot,
                                                 load_weights, to_flax)
    from abcnet_tpu_torch.train import build_pool_r5 as bp
    from abcnet_tpu_torch.train import recipe
    from abcnet_tpu_torch.train import train_r5 as tr

    ck = os.path.join(tmp, "weights_torch")
    snap_dir = os.path.join(tmp, "snapshots")
    os.makedirs(snap_dir)
    git = shutil.which("git")
    if git:      # a repository of its own, so that the commit can land
        for args in (["init", "-q"], ["config", "user.name", "chip smoke"],
                     ["config", "user.email", "smoke@localhost"],
                     ["config", "commit.gpgsign", "false"]):
            subprocess.run([git, "-C", snap_dir, *args], check=True,
                           capture_output=True, timeout=60)
    snap = os.path.join(snap_dir, "r5_torch_latest.npz")
    argv = [repr(time.time() + RECIPE_TRAIN_S), repr(RECIPE_TRAIN_S / 3600),
            pool, "--ckpt-dir", ck, "--snapshot", snap]
    res, text, secs, n, peak = _counted(torch, by_path, "train_r5", tr.main,
                                        argv)
    lines = text.splitlines()
    evals = [x for x in lines if x.startswith("EVAL ")]
    eval_keys = [t.split("=")[0] for t in evals[-1].split()[1:]] \
        if evals else []

    # The weights the run ended with are its checkpoint's (written at the
    # snapshot's step); the snapshot against the storage rule on them, and
    # the fixture served by both.
    t0 = time.perf_counter()
    mem, mem_step = load_weights(ck, "cuda", torch.bfloat16)
    snap_model, snap_step = load_snapshot(snap, "cuda", torch.bfloat16)
    params, stats = to_flax(mem.state_dict())
    flat = _flat_tree({"params": params, "batch_stats": stats})
    rule = {k: np.float16 if k.startswith("params/") and f16_is_exact(v)
            else np.float32 for k, v in flat.items()}
    z = np.load(snap)
    stored_as_rule = sorted(rule) == sorted(
        f for f in z.files if f != "__step__") and all(
        z[k].dtype == rule[k] and np.array_equal(z[k], v.astype(rule[k]))
        for k, v in flat.items())
    images = np.stack(list(fixture["images"]))
    peaks_mem = make_infer_pipeline(mem, "cuda")(images)
    peaks_snap = make_infer_pipeline(snap_model, "cuda")(images)
    smi_mem = assemble_batch(peaks_mem)
    smi_snap = assemble_batch(peaks_snap)
    smiles_equal = sum(a == b for a, b in zip(smi_mem, smi_snap))
    check_s = time.perf_counter() - t0
    del mem, snap_model

    last_loss = float(res.last_loss)
    eval_batches = bp.EVAL_N // recipe.EVAL_BATCH
    gates = {
        "lr_order": [x.split()[2] for x in lines if x.startswith("lr -> ")]
        == ["0.00025", "2.5e-05", "1e-05"],
        "loss_finite": math.isfinite(last_loss) and all(
            math.isfinite(v) for _, v in res.logged),
        "eval_line_keys": bool(evals) and eval_keys == sorted(
            res.evals[-1][1]) and {"atom_target_precision",
                                   "bond_target_precision",
                                   "bond_omega_precision",
                                   "bond_rhos_mae"} <= set(eval_keys),
        "run_complete": lines[-1] == "RUN COMPLETE",
        "checkpoint": os.listdir(ck) == [f"step_{res.step:08d}.pt"]
        and mem_step == res.step,
        "snapshot_follows_the_rule": stored_as_rule
        and snap_step == res.step and int(z["__step__"]) == res.step,
        "commit_attempt_logged": any(x.startswith(
            ("[snapshot] commit step", "[snapshot] git attempt"))
            for x in lines),
        "launches": n["unpack_noise"] == res.steps + res.metrics_steps
        and n["unpack_bits"] == eval_batches * len(res.evals)
        and n["nms_topk"] == 0
        and n["bn_act"] == train_bn_launches(UNet(), res.steps)
        and n["bn_act_eval"] == EVAL_BN["dense"] * (
            res.metrics_steps + n["unpack_bits"]),
    }
    dtypes = [str(z[k].dtype) for k in z.files if k.startswith("params/")]
    emit("recipe_train_r5", argv=argv, steps=res.steps,
         metrics_steps=res.metrics_steps, lr_changes=res.lr_changes,
         logged_losses=res.logged, last_loss=last_loss,
         eval=res.evals[-1][1] if res.evals else None,
         snapshot={"bytes": os.path.getsize(snap),
                   "params_f16": dtypes.count("float16"),
                   "params_f32": dtypes.count("float32"),
                   "f16": [k for k in z.files if z[k].dtype == np.float16],
                   "smiles_equal": smiles_equal, "of": len(images),
                   "peaks_bit_equal": _peaks_equal(peaks_mem, peaks_snap),
                   "note": "not gated: BatchNorm consumes its scale and "
                           "bias in f32 in both packages, so an f16-stored "
                           "BatchNorm array moves the logits, and this "
                           "run's 75-s model puts its peaks near the "
                           "threshold; recipe_finetune_robust holds the "
                           "served SMILES on trained weights"},
         git=git, commit_lines=[x for x in lines if x.startswith(
             "[snapshot] ")], step_wall_ms_median=float(np.median(
                 res.step_wall_s)) * 1e3 if res.step_wall_s else None,
         peak_gib=peak, check_s=check_s, output=text, launches=n,
         seconds=secs, gates=gates)
    return gates, secs + check_s


def _recipe_checkpoint_start(torch, tmp):
    """recipe.finetune_state on the card at batch 128 from train_r5's
    checkpoint directory, the output directory empty: the step and every
    optimizer-state tensor equal to the step_*.pt file's, not a resume,
    no kernel launched; the state is freed before the fine-tunes."""
    from abcnet_tpu_torch.train import finetune_robust as fr
    from abcnet_tpu_torch.train import recipe, trainer

    ck = os.path.join(tmp, "weights_torch")
    cfg = trainer.TrainConfig(batch_size=FT_BATCH, lr=fr.LR, amount=0.2,
                              device="cuda", dtype="bfloat16")
    reset_launches()
    t0 = time.perf_counter()
    state, resumed = recipe.finetune_state(
        cfg, ck, os.path.join(tmp, "checkpoint_start_out"),
        log=lambda line: None)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    n = read_launches()
    path = trainer.checkpoint_path(ck)
    saved = torch.load(path, map_location="cpu", weights_only=True)
    want = saved["optimizer"]["state"]
    got = state.optimizer.state_dict()["state"]
    unequal = [f"{i}.{k}" for i in want for k in want[i]
               if i not in got or k not in got[i]
               or not torch.equal(got[i][k].cpu(), want[i][k])]
    gates = {
        "step": state.step == saved["step"],
        "optimizer_state_bit_equal": bool(want) and sorted(got) ==
        sorted(want) and not unequal,
        "not_resumed": not resumed,
        "remat": state.model.remat_blocks == frozenset(),
        "no_launch": not any(n.values()),
    }
    emit("recipe_checkpoint_start", checkpoint=os.path.basename(path),
         step=state.step, checkpoint_step=saved["step"], resumed=resumed,
         optimizer_tensors=sum(len(v) for v in want.values()),
         unequal=unequal[:10], launches=n, seconds=secs, gates=gates)
    del state, saved, got
    torch.cuda.empty_cache()
    return gates, secs


def _recipe_finetune_common(torch, res, text, n, peak, out_dir, extra_unpack,
                            extra_nms):
    """The gates both fine-tunes share."""
    import math

    from abcnet_tpu_torch.models import UNet
    from abcnet_tpu_torch.train import build_pool_r5 as bp
    from abcnet_tpu_torch.train import recipe

    lines = text.splitlines()
    card = torch.cuda.get_device_properties(0).total_memory / 2 ** 30
    return {
        "batch": res.batch == FT_BATCH,
        "lr_drop": any(x == "lr -> 1e-05" for x in lines)
        and res.lr_changes[-1][1] == 1e-5,
        "loss_finite": math.isfinite(float(res.last_loss)),
        "checkpoint": os.listdir(out_dir) == [f"step_{res.step:08d}.pt"],
        "peak_under_the_card": peak < card,
        "launches": n["unpack_noise"] == res.steps + res.metrics_steps
        and n["unpack_bits"] == bp.EVAL_N // recipe.EVAL_BATCH
        * len(res.evals) + extra_unpack and n["nms_topk"] == extra_nms
        and n["bn_act"] == train_bn_launches(UNet(), res.steps)
        # dense a metrics step and an EVAL batch, sparse a serving batch
        and n["bn_act_eval"] == EVAL_BN["dense"] * (
            res.metrics_steps + n["unpack_bits"] - extra_unpack)
        + EVAL_BN["sparse"] * extra_nms,
    }


def _recipe_robust(torch, tmp, pool, fixture, ref, by_path):
    """finetune_robust for about RECIPE_FT_S from the committed snapshot,
    with a 64-row engine-B pool, at batch 128 with the plain step; then the
    float16 snapshot of the weights it trained, serving the fixture."""
    import numpy as np

    from abcnet_tpu_torch.train import finetune_robust as fr

    out = os.path.join(tmp, "weights_torch_robust")
    argv = [repr(time.time() + RECIPE_FT_S), pool,
            os.path.join(tmp, "pool_b.npz"), out]
    res, text, secs, n, peak = _counted(torch, by_path, "finetune_robust",
                                        fr.main, argv)
    gates = _recipe_finetune_common(torch, res, text, n, peak, out, 0, 0)
    ap = res.evals[-1][1]["atom_target_precision"]
    ref_ap = ref["eval"]["atom_target_precision"]
    gates["eval_atom_precision"] = ap >= ref_ap - RECIPE_SLACK
    gates["b_pool_64"] = "pool cached: 64 samples" in text
    snapshot = _f16_snapshot_serves(torch, out, fixture, tmp)
    gates["f16_snapshot_serves_the_smiles"] = \
        snapshot["smiles_equal"] >= snapshot["of"] - MESH_SMILES_SLACK
    emit("recipe_finetune_robust", argv=argv, start_step=res.start_step,
         steps=res.steps, metrics_steps=res.metrics_steps,
         batch=res.batch,
         lr_changes=res.lr_changes, last_loss=float(res.last_loss),
         eval_atom_target_precision=ap, snapshot_atom_target_precision=ref_ap,
         eval=res.evals[-1][1], peak_gib=peak, f16_snapshot=snapshot,
         step_wall_ms_median=float(np.median(res.step_wall_s)) * 1e3
         if res.step_wall_s else None, output=text, launches=n,
         seconds=secs, gates=gates)
    return gates, secs + snapshot["seconds"]


def _f16_snapshot_serves(torch, ckpt_dir, fixture, tmp):
    """save_snapshot_f16 of the trained weights in `ckpt_dir`, the fixture
    served by both: SMILES equal, peak dicts bit-equal or not."""
    import numpy as np

    from abcnet_tpu_torch.infer.assemble import assemble_batch
    from abcnet_tpu_torch.infer.decode import make_infer_pipeline
    from abcnet_tpu_torch.models.weights import (load_snapshot, load_weights,
                                                 save_snapshot_f16)

    t0 = time.perf_counter()
    mem, step = load_weights(ckpt_dir, "cuda", torch.bfloat16)
    path = os.path.join(tmp, "trained_f16.npz")
    save_snapshot_f16(mem, path, step, log=lambda line: None)
    snap, _ = load_snapshot(path, "cuda", torch.bfloat16)
    z = np.load(path)
    images = np.stack(list(fixture["images"]))
    want = make_infer_pipeline(mem, "cuda")(images)
    got = make_infer_pipeline(snap, "cuda")(images)
    equal = sum(a == b for a, b in zip(assemble_batch(want),
                                       assemble_batch(got)))
    return {"step": step, "bytes": os.path.getsize(path),
            "f16": [k for k in z.files if z[k].dtype == np.float16],
            "smiles_equal": equal, "of": len(images),
            "peaks_bit_equal": _peaks_equal(want, got),
            "seconds": time.perf_counter() - t0}


def _recipe_hard(torch, tmp, pool, model, train_samples, ref, by_path):
    """mine_hard over the train split, held to the phase's own count of
    misses, then finetune_hard reading its cache for about RECIPE_FT_S at
    batch 128, FINAL against the snapshot's own report."""
    import numpy as np

    from abcnet_tpu_torch.infer.assemble import assemble_batch
    from abcnet_tpu_torch.infer.decode import make_infer_pipeline
    from abcnet_tpu_torch.train import finetune_hard as fh
    from abcnet_tpu_torch.train import recipe

    cache_dir = os.path.join(tmp, "cache")
    cache = fh.cache_path(cache_dir, ref["step"])
    mined_lines = []
    idx, _, mine_s, n_mine, _ = _counted(
        torch, by_path, "finetune_hard_mine",
        lambda argv: fh.mine_hard(model, train_samples, cache, "cuda",
                                  mined_lines.append), None)
    t0 = time.perf_counter()
    run = make_infer_pipeline(model, "cuda")
    misses = []
    for i in range(0, len(train_samples) - fh.MINE_BATCH + 1, fh.MINE_BATCH):
        chunk = train_samples[i:i + fh.MINE_BATCH]
        preds = assemble_batch(run(np.stack([s.image for s in chunk])))
        misses.extend(i + j for j, (s, p) in enumerate(zip(chunk, preds))
                      if not fh._same_mol(p, s.smiles))
    own_s = time.perf_counter() - t0
    mine_batches = len(train_samples) // fh.MINE_BATCH

    out = os.path.join(tmp, "weights_torch_hard")   # not train_r5's
    argv = [repr(time.time() + RECIPE_FT_S), pool, "--out", out,
            "--cache-dir", cache_dir]
    res, text, secs, n, peak = _counted(torch, by_path, "finetune_hard",
                                        fh.main, argv)
    final_batches = -(-fh.EVAL_N // recipe.EVAL_BATCH)
    gates = _recipe_finetune_common(torch, res, text, n, peak, out,
                                    final_batches, final_batches)
    gates.update({
        "mined_equals_own_count": idx.tolist() == misses,
        "mine_launches": n_mine["unpack_bits"] == n_mine["nms_topk"]
        == mine_batches and n_mine["unpack_noise"] == 0
        and n_mine["bn_act_eval"] == EVAL_BN["sparse"] * mine_batches,
        "cache_read_again": f"mined cache: {len(idx)} hard examples"
        in text.splitlines() and np.array_equal(res.hard_idx, idx),
        "final_decode": res.final.decode_rate >= FINAL_EVAL_DECODE_MIN,
        "final_exact": res.final.exact_match
        >= ref["final"].exact_match - RECIPE_SLACK,
    })
    emit("recipe_finetune_hard", argv=argv, start_step=res.start_step,
         mined=len(idx), of=len(train_samples), mine_lines=mined_lines,
         mine_s=mine_s, own_count_s=own_s, launches_mine=n_mine,
         hard_rows_a_batch=max(1, int(FT_BATCH * fh.HARD_FRAC)),
         steps=res.steps, metrics_steps=res.metrics_steps,
         lr_changes=res.lr_changes, last_loss=float(res.last_loss),
         final=str(res.final), snapshot_final=str(ref["final"]),
         eval=res.evals[-1][1], peak_gib=peak,
         step_wall_ms_median=float(np.median(res.step_wall_s)) * 1e3
         if res.step_wall_s else None, output=text, launches=n,
         seconds=secs, gates=gates)
    return gates, mine_s + own_s + secs


def phase_recipe(torch, fixture):
    """The production training recipe through its four entry points, in a
    temporary directory, each path's launches read from its own run
    (`pool_r5`, `train_r5`, `finetune_robust`, `finetune_hard_mine`,
    `finetune_hard`): build_pool_r5 against the digest fixture, train_r5
    from a seeded init, then the committed snapshot's own EVAL and FINAL
    numbers on the eval split, finetune_robust and finetune_hard from it
    at batch 128 with the plain step (no remat)."""
    import tempfile

    by_path, gates, times = {}, {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        pool, gates["pool_r5"], times["pool_r5"] = _recipe_pool(
            torch, tmp, by_path)
        gates["train_r5"], times["train_r5"] = _recipe_train_r5(
            torch, tmp, pool, fixture, by_path)
        gates["checkpoint_start"], times["checkpoint_start"] = \
            _recipe_checkpoint_start(torch, tmp)
        model, train_samples, ref = _recipe_reference(torch, pool)
        times["snapshot_reference"] = ref["seconds"]
        gates["finetune_robust"], times["finetune_robust"] = _recipe_robust(
            torch, tmp, pool, fixture, ref, by_path)
        gates["finetune_hard"], times["finetune_hard"] = _recipe_hard(
            torch, tmp, pool, model, train_samples, ref, by_path)
        del model
    torch.cuda.empty_cache()
    ok = all(all(g.values()) for g in gates.values())
    emit("recipe", ok=ok, gates=gates, launches_by_path=by_path,
         seconds=times, snapshot_reference={
             "step": ref["step"], "eval": ref["eval"],
             "final": str(ref["final"])},
         gate=f"pool rows, labels, SMILES, lineage and engine equal to the "
              f"digest fixture, engine B images bit-equal, engine A masks "
              f"within {PIXEL_SHARE_MAX} of pixels, no launch; train_r5: "
              f"the three LRs in order, loss finite, EVAL keys, checkpoint, "
              f"snapshot stored by the f16 rule, commit logged, one noise "
              f"launch a train and a metrics step, one unpack an EVAL batch; "
              f"the fine-tunes' state from train_r5's checkpoint directory "
              f"with its step and optimizer state bit-equal, no launch; "
              f"fine-tunes at batch {FT_BATCH} under the card's memory, LR "
              f"to 1e-5, checkpoint; robust EVAL atom precision >= the "
              f"snapshot's - {RECIPE_SLACK}, its weights' f16 snapshot "
              f"serving their SMILES (>= 64 - {MESH_SMILES_SLACK}); hard: "
              f"mined set = the phase's "
              f"own misses, one unpack and one NMS launch a mining batch, "
              f"the cache read again, FINAL decode >= "
              f"{FINAL_EVAL_DECODE_MIN} and exact >= the snapshot's - "
              f"{RECIPE_SLACK}; bn_act_eval {EVAL_BN['dense']} a metrics "
              f"step and an EVAL batch, {EVAL_BN['sparse']} a mining or "
              f"FINAL batch")
    if not ok:
        raise AssertionError("the training recipe failed its gates")
    return by_path


def main(argv):
    t_start = time.time()
    if argv[:1] == ["--ddp-worker"]:
        ddp_worker(*argv[1:3])
        return 0
    if argv[:1] == ["--multiproc-worker"]:
        multiproc_worker(*argv[1:3])
        return 0
    only = None
    if argv[:1] == ["--phases"]:
        only = set(argv[1].split(","))
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        import numpy as np

        import abcnet_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the abcnet_tpu_torch package is missing beside "
              f"this script ({e})", file=sys.stderr)
        return 2
    assets = os.path.join(HERE, "abcnet_tpu_torch", "assets")
    phase = "environment"

    def want(name):
        return only is None or name in only

    try:
        fixture = dict(np.load(os.path.join(assets, "smoke_step43100.npz")))
        labels = dict(np.load(os.path.join(assets, "train_step43100.npz")))
        samples = fixture_samples(fixture, labels)
        phase_environment(torch)
        by_path = {}
        if want("device_guard"):
            phase = "device_guard"
            phase_device_guard(torch)
        if want("kernels"):
            phase = "kernels_vs_plain"
            errs, maps = phase_kernels(torch, fixture)
        if only is None:
            phase = "serving_f32"
            phase_f32(torch, fixture)
        phase = "serving_bf16"
        model, launches, bf16_preds = phase_bf16(torch, fixture)
        by_path["img2smiles_bf16"] = dict(launches)
        if want("cbam_gate"):
            phase = "cbam_gate"
            by_path["cbam_serving"], cbam_row = phase_cbam_gate(torch,
                                                                fixture)
        if want("stem_conv"):
            phase = "stem_conv"
            stem_row = phase_stem_conv(torch, fixture)
            stem_row["launches"] = by_path.get("cbam_serving",
                                               {}).get("stem_conv")
        if want("dcn"):
            phase = "dcn"
            dcn_row = phase_dcn(torch, fixture)
        if only is None:
            phase = "train_f32"
            phase_train_f32(torch, samples, labels)
            phase = "train_bf16"
            state, train_launches = phase_train_bf16(torch, fixture,
                                                     samples)
            launches["unpack_noise"] = train_launches["unpack_noise"]
            launches["bn_act"] = train_launches["bn_act"]
            by_path["fit_bf16"] = dict(train_launches)
            phase = "kernel_times"
            kernels = phase_times(torch, fixture, maps, launches, errs,
                                  cbam_row, stem_row)
            del maps
            phase = "conv_bias_fold"
            phase_conv_bias_fold(torch, samples, state)
            del state
            torch.cuda.empty_cache()
        if want("bn_act_step"):
            phase = "bn_act_step"
            by_path["bn_act_step"] = phase_bn_act_step(torch, samples)
        if want("mesh_serving"):
            phase = "mesh_serving"
            by_path["mesh_serving"] = phase_mesh_serving(torch, fixture,
                                                         model)
        if want("multiproc_serving"):
            phase = "multiproc_serving"
            by_path.update(phase_multiproc_serving(torch, fixture, model,
                                                   bf16_preds))
        if want("quant_serving"):
            phase = "quant_serving"
            by_path["int8_serving"], s8_row = phase_quant_serving(
                torch, fixture, model, bf16_preds)
        del model
        torch.cuda.empty_cache()
        if want("variants"):
            phase = "variants"
            by_path.update(phase_variants(torch, fixture, samples))
        if want("ddp_train"):
            phase = "ddp_train"
            torch.cuda.empty_cache()
            by_path["ddp_fit_rank0"] = phase_ddp_train(torch, samples)
        if want("generator") or want("final_eval"):
            phase = "generator"
            pools = phase_generator(torch)
        if want("final_eval"):
            phase = "final_eval"
            torch.cuda.empty_cache()
            by_path["final_eval"] = phase_final_eval(torch, pools)
            del pools
        if want("cli_loop"):
            phase = "cli_loop"
            torch.cuda.empty_cache()
            by_path.update(phase_cli_loop(torch))
        if want("bench"):
            phase = "bench"
            torch.cuda.empty_cache()
            by_path.update(phase_bench(torch))
        if want("eval_suite"):
            phase = "eval_suite"
            torch.cuda.empty_cache()
            by_path.update(phase_eval_suite(torch))
        if want("recipe"):
            phase = "recipe"
            torch.cuda.empty_cache()
            by_path.update(phase_recipe(torch, fixture))
    except Exception as e:  # noqa: BLE001 — report the phase, then fail
        import traceback
        traceback.print_exc()
        emit(phase, ok=False, error=f"{type(e).__name__}: {e}")
        return 1
    if only is not None:
        print(json.dumps({"launches_by_path": by_path}), flush=True)
        print("chip_smoke: --phases ran a subset; no result line",
              file=sys.stderr)
        return 4
    kernels.append({**s8_row, "max_abs_err": errs["conv_s8"]})
    kernels.append(dcn_row)
    for k in kernels:
        k["launches_by_path"] = {path: n.get(k["name"], 0)
                                 for path, n in by_path.items()}
    emit("script", ok=True, seconds=time.time() - t_start, limit_s=1200)
    print(smi_line(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
