#!/usr/bin/env python3
"""Smoke run of jaeger_tpu_torch on one NVIDIA GPU (Hopper, sm_90a).

Run from the root of a checkout on a machine with CUDA:

    python3 chip_smoke.py            # every phase; exits 0 when all pass
    python3 chip_smoke.py --quick    # phases 1-3b only (build, kernel checks)
    python3 chip_smoke.py --profile  # also: device time by kernel (torch
                                     # profiler) of each flagship forward
    python3 chip_smoke.py --sweep    # also: the kernels under other
                                     # launch plans and with fewer taps,
                                     # the backward wrappers' host time
    python3 chip_smoke.py --backward # phases 1, 2 and 3b only (the
                                     # backward kernels)
    python3 chip_smoke.py --host     # phases 1, 2 and 7 only (the host
                                     # pipeline and the predict stages)
    python3 chip_smoke.py --templates  # phases 1, 2 and 8 only (the
                                       # layer-zoo templates)
    python3 chip_smoke.py --hyena     # phases 1, 2 and 9 only (the Hyena
                                      # template and MaskedBiLSTM)
    python3 chip_smoke.py --int8-zoo  # phases 1, 2 and 10 only (int8 for
                                      # the layer-zoo templates, the
                                      # ragged route, ensembles)
    python3 chip_smoke.py --legacy    # phases 1, 2 and 11 only (the
                                      # kernels' route, the ragged
                                      # route's stride, the legacy models)
    python3 chip_smoke.py --commands  # phases 1, 2 and 12 only (health,
                                      # the model registry, taxonomy,
                                      # utils optimize-data)
    python3 chip_smoke.py --ragged    # phases 1, 2 and the ragged route's
                                      # kernel checks and times of phases
                                      # 10 and 11, then its cycles a tile
                                      # by phase (a probe build)
    python3 chip_smoke.py --pretrain  # phases 1, 2 and 13 only (the
                                      # projection pretraining and the
                                      # reliability-data generator)
    python3 chip_smoke.py --multi     # phases 1, 2 and 14 only (hosts,
                                      # meshes, process groups)
    python3 chip_smoke.py --convert   # phases 1, 2 and 15 only (the
                                      # exported torch.export programs)
    python3 chip_smoke.py --f32       # phases 1, 2 (the three conv
                                      # sources), the f32 parts of 3 and
                                      # 3b and phase 6's f32 steps only;
                                      # with --sweep, the f32 kernels
                                      # under other launch plans
    python3 chip_smoke.py --domain    # phases 1, 2 (the three conv
                                      # sources), 16 and 11's route
                                      # cases; with --sweep, the new
                                      # routes under other launch plans
    python3 chip_smoke.py --adamw     # phases 1, 2 (fused_adamw alone)
                                      # and 6d only (the fused AdamW
                                      # update against the per-leaf one)

Phases, each of which fails the run:

1. device: torch version, the card's name and power limit (nvidia-smi);
2. build: nvcc builds csrc/fused_conv_block.cu, csrc/int8_conv.cu,
   csrc/fused_conv_wgrad.cu, csrc/conv_epilogue_bwd.cu and
   csrc/fused_adamw.cu for sm_90a, one
   nvcc per source, started together; ptxas' registers, stack and spills
   of each instance of the wgmma kernels, the f32 kernels (conv_f32_ring,
   wgrad_f32_ring, wgrad_f32_taps), int8_ragged and conv_epilogue_bwd;
3. each kernel against its plain version on the card. fused_conv_block:
   the Pallas kernel's test cases, each extension, the demo and flagship
   shapes, and the bf16 kernel's edges (L = 1, 63, 65; N = 1; C = 16, 64,
   256; k = 1, 7; in_mask runs across tile edges and the halo; out_mask
   with residual; every activation) at 2e-4 in f32, 5e-2 in bf16; kernel,
   plain and library (F.conv1d + the same epilogue) times at the flagship
   shape (batch 2048: N = 12288, L = 500, C = 128, k = 5) in the conv1,
   conv2 and bias-only forms, each with its bound and share of it. The
   f32 forms (TF32 off throughout), route f32_ring: its edges against
   the plain version at 2e-4, the same bits run to run (L 1 / 127 / 129 /
   600, N 1, C 16 / 48 / 64 / 256, k 1 / 3 / 4 / 7 / 9, and past 9 taps k
   11 / 21 / 23 / 31 at C 16 / 64 / 128 and k 13 at C 256, where the
   weights are resident in tap blocks or streamed; in_mask runs across
   its 32-row units and the halo, out_mask with residual, the data
   gradient's form, every activation); at the flagship shape the conv1,
   conv2 and bias-only forms against the plain version, each timed beside
   the plain, the library (F.conv1d + the epilogue, TF32 off) and the
   bound at the card's f32 peak; the model form against the plain version
   in float64 (below 1e-5 of the scale); then the kernel table's further
   f32 shapes (L 500): the forward at N 12288, C 128, k 11 (the three
   forms) and bias-only at N 1536, k 31, the data gradient at N 1536, k
   11, and conv_wgrad at N 1536, k 5, C 16 / 48 / 96 with a random
   in_mask, each against its plain version and timed the same way.
   int8_conv: the plan of the main path's shapes names the wgmma route;
   the requant form equal to its plain version at the Pallas parity case,
   the Pallas chip shape (N = 12288, L = 500, C = 128, k = 5, dilation 3)
   and the wgmma kernel's edges (L 1 / 63 / 65, N 1, C 32 / 64 / 256,
   C_in != C_out, k 1 / 3 / 7) and an mma-route shape; the dequant form at
   each extension, the demo and flagship shapes, dilation 3 in SAME and
   VALID, the same edges, in_mask runs across tile edges and the halo,
   out_mask with residual and every activation (2e-4 in f32, which takes
   the mma route, 5e-2 in bf16); kernel, plain and library (k
   ``torch._int_mm`` GEMMs on shifted copies + the epilogue in torch)
   times of the requant form at the Pallas shape and of the dequant form
   at the flagship shape (conv1, conv2 and bias-only forms). All times
   with CUDA events, each with its bound;
3b. the fused conv's backward: conv_wgrad (one tile first; L 1 / 63 / 64
   / 65 / 500, C 64 / 128 / 256, k 3 / 5, in_mask none, random and runs
   across tile edges and the halo), conv_epilogue_bwd (every activation
   with and without residual, out mask and DYT, f32 and bf16, C 16 / 48 /
   128 / 256, ragged row counts) and the flipped-weight data gradient
   against their plain versions at the train shape (N = 1536, L = 500, C =
   128, k = 5) in bf16 and at small shapes, both kernels the same bits run
   to run; bf16 outputs within 2 ulps + 1e-4 of the scale, f32 within 2e-4
   (conv_wgrad 1e-3 in bf16); FusedConvBlockFn's whole backward at the
   train shape within 2 ulps + 5e-3 of the scale; kernel, plain, library
   and bound times, and each kernel's host microseconds a call. The f32
   forms: conv_wgrad's route fma_ring against its plain version at 2e-4
   (the train shape, C 16 / 32 / 48 / 64 / 80 / 96 / 112 / 128 / 144 /
   256, k 1 / 3 / 5 / 7 / 9 / 11, L 1 / 31 / 33 / 65, N 1, in_mask none,
   random and runs), the same bits run to run; at the train shape the
   data gradient, conv_wgrad and conv_epilogue_bwd's conv2 form, each
   beside its plain version, the library (TF32 off) and the bound at the
   card's f32 peak;
4. the flagship (128 channels, 1505 nt crop, 6 classes; seeded weights,
   bf16) through the port's InferenceEngine at batch 2048, on windows
   that select the dense, the bounded-cut and the split (dense + masked
   bucket) programs: six kernel launches per forward, the forward
   matching the same forward on the plain versions (5e-2), windows/s of
   the engine and of the forward alone, and the host's planning time.
   Then the same for the flagship's full_int8 bundle, calibrated on the
   card by the port's ``quantize_bundle``: six int8_conv launches and no
   fused_conv_block launch per forward;
5. the main path: the port's ``predict`` CLI with the flagship bundle and
   with the bundled demo model on jaeger_tpu/data/test/test_contigs.fasta,
   then ``predict --int8`` and ``--int8 auto`` with the flagship's int8
   bundle and with a demo int8 bundle made by ``utils quantize`` (kernel
   launch counts reset just before each, read just after); the TSV rows
   are checked, the demo's against a CPU float32 run (float and int8);
6. training: one f32 step of a narrow flagship template (C 16, C 96, and
   C 128 with k 11 residual convs; its convs take only the f32 routes
   f32_ring and fma_ring, launches by route read) on the card against
   the CPU in each program (dense, bounded, masked);
   ``train_fragment_core`` with the flagship template at full width
   (batch 256, bf16) on synthetic CSVs from a seed, 30 classifier and 4
   reliability steps through all three programs (launch counts reset just
   before, read just after; losses finite and falling; 18 / 6 / 6
   launches per dense step); each program's steady-state step time and
   device time; then ``predict`` and ``predict --int8`` on the bundle and
   the int8 bundle it wrote;
6d. the fused AdamW update (``csrc/fused_adamw.cu``, ``Optimizer.apply``)
   against the per-leaf update (``Optimizer.update``, the adds,
   ``global_norm``) on the card, on the flagship's 49 leaves (one leaf
   table) and the axial template's 85 (two tables): 5 steps from the same
   seeded parameters, the leaves under the first scope frozen (zero
   gradients, still decayed), a ``set_learning_rate`` after the second
   step; bitwise equal where no leaf's norm reaches ``clipnorm``, within 4
   ulps of each leaf's largest magnitude where every large leaf is
   clipped, the gradient norm within 1e-6 relative, the same bits on a
   second run; at the flagship's leaves the kernels' device time beside
   their byte bound, the host microseconds of one fused update and the
   per-leaf update's wall time, and the stream synchronizations each
   makes under ``torch.cuda.set_sync_debug_mode("warn")`` (the fused one
   none);
7. host pipeline and full predict: the port's native host library must
   be live and its own (``build/jaeger_tpu_torch/libjaeger_host-*.so``);
   on a seeded synthetic assembly (750 contigs of 5-75 kb, 30 Mb, with
   N runs, low-complexity tracts and a tandem tract) the host windowing
   rate at 1, 4 and all workers (native) and on its first 25 contigs
   (pure Python, whose windows must equal the native ones); the
   terminal-repeat scan's seconds; ``predict`` with the flagship bundle
   (``--fsize 1505 --batch 2048``, default stages) end to end: wall
   seconds and windows/s (launch counts reset just before, read just
   after), the same with ``--no-termini``, the engine's host ms per batch
   for pack, upload and plan (its ``engine/*`` spans, recorded under
   ``spans.recording()``) against the forward's ms, the card's busy
   share of the inference loop from a ``--profile`` run's trace, and a
   cProfile top 10 of the host in a ``--no-termini`` run;
   then ``--mask-tandem``, ``--prophage`` (its region equal to a CPU
   float32 run's), ``--refine`` (a seeded ``*_refine.yaml`` beside the
   bundle) and ``--profile`` on a small FASTA, each checked for its files
   and for fused_conv_block launches;
8. the layer-zoo templates: fused_conv_block (bias-only with in_mask, the
   DYT forms), conv_wgrad, the data gradient, conv_epilogue_bwd and
   FusedConvBlockFn's whole backward against their plain versions at the
   cross-frame and axial templates' residual-conv shape (N = 1536, L =
   165, C = 64, k = 3, bf16) with phase 3 and 3b's tolerances, and their
   kernel, plain, library and bound times there; then the
   variable-length, dvf, cross-frame and axial templates at their own
   widths, each ``train_fragment_core`` at batch 256 in bf16 on seeded
   synthetic data (phase 6's writer; NPZ tokens for the variable-length
   template) for 5 classifier and, with a reliability head, 2 reliability
   steps, then ``run_core`` on the test contigs in bf16, in f32 and in
   f32 on the CPU (rows and labels checked, the card's f32 scores within
   0.01 of the CPU's; kernel launch counts reset just before the
   templates' runs, read just after); each template's steady-state train
   step per program with its launches per step (8 / 4 fused_conv_block /
   conv_wgrad per dense cross-frame step, 4 / 2 axial) and its forward at
   batch 2048; then a narrow f32 model with every zoo layer no template
   uses (positional embeddings, multi-scale conv, masked layer norm,
   transformer encoder, local attention, parallel branches, gated pooling,
   ``nmd_plus_signals``): forward and one train step on the card against
   the CPU;
9. the Hyena template (``train_config/hyena_fullcontig.yaml``, dim 32,
   crop 666 codons, 6 classes): ``train_fragment_core`` at batch 64 in
   bf16 on seeded CSVs of 2003 nt rows (phase 6's writer, its N-run rows
   moved to the front) for 10 classifier steps, dense and masked programs
   (kernel launch counts reset just before, read just after: the template
   has no conv, so none); ``run_core`` with ``--fsize 2003 --stride 2003``
   in bf16, in f32 and in f32 on the CPU (rows equal, the card's f32
   labels equal to the CPU's and its scores within 0.01); each program's
   steady-state step (host ms, device ms, busy share) and the forward at
   batch 2048, dense and masked; the causal convolution's direct, blocked
   and scan routes (D 32; L 666, 2048 and 8192 codons) against the f32
   FFT on the card, the scan's backward too, with their times and the bf16
   dispatch's choice of route; ``MaskedBiLSTM`` on the card against the
   CPU in f32 at the legacy LSTMModel's widths and timed at its shape
   (128 windows, C 128, U 128, 681 steps, the last state), and phase 8's
   zoo model with a BiLSTM layer on the card against the CPU.

10. int8 for the layer-zoo templates and ensembles: int8_conv's ragged
   route (C_in or C_out not a multiple of 16) against its plain versions:
   the requant form equal at C_in 4 / C_out 20 (k 10), C_in 24 / C_out 40
   (k 3, dilation 3), an aligned C_in with a ragged C_out, a C_out that 4
   does not divide (one epilogue channel a thread) and a C_in whose taps
   take several stages; the dequant form at the dvf conv's shape (N 2048,
   L 500, C_in 4, C_out 500, k 10, VALID) in bf16 with in_mask and in f32
   with out_mask, C_in 24 / C_out 40 with DYT and a residual in bf16 and
   f32, the tile's edges, C_out 30 and every activation (phase 3's
   tolerances); kernel, plain, library (im2col + ``torch._int_mm``) and
   bound times at the dvf shape in the form its model runs. Then the dvf,
   cross-frame and axial bundles that phase 8 trained (``--int8-zoo``
   trains them as phase 8 does), each with the ``int8/`` bundle ``train``
   wrote: ``predict --int8`` and ``--int8 auto`` in bf16, ``--int8`` in
   f32 on the card and on the CPU, the float model in bf16 (launch counts
   reset just before, read just after: int8_conv by every int8 run, its
   ragged route by the dvf's; the card's int8 f32 scores within 0.01 of
   the CPU's), and each template's dense forward at batch 2048, int8 and
   float; then an ensemble of the cross-frame and axial bundles written
   by ``utils combine-models`` for mv, sum and mean: its window outputs on
   the card against the members' own card outputs combined in numpy,
   ``predict`` with it, and its forward at batch 2048.
11. the kernels' route, the ragged route's stride and the legacy models:
   for each residual-conv shape one of the fused kernel's plans refused
   (C 40 in bf16, C 192 in f32, bf16 training at k 7 and at C 96,
   training at an even k) a seeded model's forward on the card against
   the CPU's, ``predict`` (fused_conv_block launched for every residual
   conv, on the route ``conv_plan`` names: wgmma_stream for C 40,
   f32_ring for f32 C 192) and two train steps (fused_conv_block,
   conv_wgrad and conv_epilogue_bwd launched for f32 C 192, which
   ``check_wgrad_shape`` takes; no hand-kernel launch for the others),
   with the forward and step timed; int8_conv's ragged route at strides 2
   to 4 against its plain versions (requant equal, dequant within phase
   3's tolerances) and its kernel, plain, library (strided im2col +
   ``torch._int_mm``) and bound times at a strided flagship-width conv1
   (N 12288, L 500, C 128, k 5, stride 2); ``predict --int8`` on a
   full_int8 bundle with a ``strides: 2`` block (calibrated on the card,
   counts reset just before, read just after: the ragged route launched),
   the card's f32 scores within 0.01 of the CPU's; ``predict -m default``
   and ``predict-legacy`` (the shipped default bundle) on the card with
   TSVs byte-identical to ``--device cpu`` runs, the WRes forward on the
   card against the CPU, and its windows/s at batch 128 and 1024.
12. the commands: ``python -m jaeger_tpu_torch.cli health`` in its own
   process exits 0 with the card's name on its device line; phase 5's
   flagship bundle goes through ``register-models`` into a temporary
   registry, ``list-models --config`` lists it, and ``predict -m <its
   name> --config <registry>`` (counts reset just before, read just after:
   fused_conv_block launched) writes the TSV of ``predict -m <its path>``
   byte for byte; ``taxonomy build`` on phase 7's seeded assembly (750
   contigs, 30 Mb) with a seeded taxdump (75 species, 15 genera, 3
   families) and ``taxonomy predict`` on a query of 100 contigs of
   another seed plus the first 50 reference contigs, at the flagship's
   width in bf16, batch 2048, ``--fsize 1505`` (counts reset just before
   each command, read just after: fused_conv_block six launches a
   forward, int8_conv none), with build and predict windows/s and the
   search's ms; the same in f32, where every self-query window's first
   neighbour is itself (score at least 1 - 1e-5); both commands in f32
   on the card and with ``--cpu`` on the first 6 reference and query
   contigs at batch 64: taxid, rank, name, lineage and n_windows equal,
   mean_knn_similarity within 1e-4, the neighbour lists equal wherever
   neighbouring scores are more than 1e-5 apart; ``utils optimize-data``
   on phase 6's seeded CSVs, and one ``train`` step of the flagship
   template on the NPZ it wrote.
13. the projection pretraining and reliability-data generation: (a) one
   f32 projection step of a narrow template with a projection head on
   the card against the CPU (the ArcFace loss and every gradient,
   ``class_weights`` included, within 1e-4 of the leaf's scale); (b)
   ``train_fragment_core`` on the flagship template at full width with a
   projection head added (dense 128 relu, dense 64, margin 0.5, scale 30;
   no template ships one), batch 256, bf16, ``self_supervised_pretraining``
   and ``generate_reliability`` on seeded CSVs with N runs: 2 x 10
   projection steps, 10 classifier steps, reliability data generated from
   a 4,096-row raw CSV (batch 512, multiplier 1.0), 4 reliability steps
   (launch counts reset just before each stage, read just after: 18 / 6 /
   6 a projection step, 6 fused_conv_block a generator forward); the
   ArcFace loss finite and falling; the projection step's steady state
   (host clock, profiler) and the generator's raw rows/s with its host and
   device shares; ``predict`` on the bundle, which carries the projection
   leaves; (c) the generator on the card against the CPU with the f32
   model on 128 raw rows at batch 64, thresholds at quantiles of the card's
   confidences: reliability CSVs byte-identical save rows within 1e-4 of a
   threshold (counted), the predictions CSV within 1e-4.

14. several devices and processes on the one card (no scaling is
   measured; repeated devices and groups run every new path with the hand
   kernels in it): ``predict --num-hosts 2 --host-id 0|1`` as two CLI
   worker processes at once (``chip_smoke.py --cli-worker``), the merged
   rows against one host; the engine and ``run_core`` on
   ``DeviceMesh(("cuda:0",) * 2)`` against one device; the flagship
   template's dense step (bf16, global batch 256) without a group, in a
   one-rank NCCL group and in a two-rank gloo group on cuda:0 (each in
   fresh ``--train-worker`` processes; step ms and launches per rank), the
   two-rank f32 step against the one-rank one; ``--seq-shard`` on two
   cuda:0 devices; the row-sharded k-NN search at widths 1, 2 and 4 at
   phase 12's size. ``phase_multi`` has the tolerances.

15. the converters: ``utils convert-graph`` through the CLI exports phase
   5's seeded flagship bundle (crop 1505 nt, full width) in f32 and bf16
   at batch 96 and 2048, each export timed; a fresh process that cannot
   import the port, the JAX package or JAX (TF32 off) loads every
   program, runs it on the card after ``move_to_device_pass`` on the
   windows of ``test_contigs.fasta`` padded to the batch (the f32 one at
   96 also on the CPU) and times the programs at 2048 with CUDA events.
   The engine's forward of the same windows on the card (the full masked
   program, the hand kernels; launch counts reset just before, read just
   after: 6 fused_conv_block a forward) is the reference: f32 outputs
   within 2e-4 of each output's scale on the real windows, as is the
   program on the CPU; bf16 outputs within 5e-2 of each output's scale
   (phase 4's plain-against-kernel rule), class scores (the prediction's
   softmax) within 0.01 of the CPU's f32 ones, and the argmax equal to
   the engine's on every window whose two top logits are more than twice
   that tolerance apart. The
   port's forward at 2048 is timed beside the programs' and must be the
   faster in each precision; the f32 forwards' convs must take route
   f32_ring. The programs hold the kernels' plain versions, so they are
   slower by design.
16. fused_conv_block on the shapes its resident bf16 layout and its f32
   ring refused before its plan covered the Pallas kernel's whole domain
   (any C, any k): routes wgmma_stream (bf16: C 1, 5, 8, 24, 37, 40, 100,
   200, 1000, 1024; k 1 to 200, even k; L 1, 127, 129; TMA copies with
   the weights multicast to a cluster of 2 and 2-byte loads; resident and
   streamed weights; tile counts of a column block odd and below the
   cluster's CTAs) and f32_ring_pad / f32_ring (C 5, 24, 37, 40, 144, 192,
   200, 512; C 1990 and 2048, whose weights stream in channel groups), each
   case in the conv1 (DYT + gelu with in_mask), conv2 (+ residual),
   bias-only and model forms against the plain version (2e-4 / 5e-2 of the
   scale); kernel, plain, library (TF32 off) and bound times of the three
   forms at the table's shapes (L 500: bf16 C 200 k 5, C 40 k 3, C 37 k 3
   at N 12288, C 1024 k 5, C 128 k 61 at N 1536; f32 C 40 k 3, C 192 k
   3, C 512 k 5 at N 1536); then the domain's main path: a seeded
   flagship with 200 channels through ``predict`` in bf16 at batch 2048
   (counts reset just before, read just after: six wgmma_stream launches a
   forward) and in f32 on the card and on the CPU on the last three test
   contigs (scores within 0.01; f32 on f32_ring_pad), and through the
   engine at batch 2048 in the dense, bounded and split programs (six
   launches a forward, the forward within 5e-2 of its plain version,
   windows/s).

The second-to-last line is the kernels JSON (each kernel also with its
numbers at the templates' shape and its launches on phase 8's, phase 9's,
phase 10's, phase 11's, phase 12's, phase 13's, phase 14's and phase 15's
paths;
int8_conv with its ragged route's numbers at the dvf shape and at the
stride shape; the f32 forms of fused_conv_block and conv_wgrad as entries
of their own, with their launches by route on phase 15's f32 forwards and
phase 6's C 128 f32 steps; fused_conv_block's routes wgmma_stream and
f32_ring_pad as entries of their own, with their launches in the C 200
flagship's bf16 and f32 ``predict``), the last
``{"ok": true, ...}``.
The script imports nothing of JAX or of jaeger_tpu.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import csv
import json
import math
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
FASTA = ROOT / "jaeger_tpu" / "data" / "test" / "test_contigs.fasta"

F32_TOL = 2e-4
BF16_TOL = 5e-2
#: the backward kernels in bf16 against their plain versions on the same
#: inputs, as (tol of the scale, bf16 ulps): both sum in f32 and round once,
#: so a bf16 output may land one ulp apart (2 allowed); the 1e-4 floor
#: covers f32 noise where the value is near zero (1 - t^2 at a saturated
#: tanh, act'(s) near its zero), and it bounds the f32 sums (dW, db, ddyt)
BF16_KERNEL_TOL = (1e-4, 2)
#: the whole backward: where the kernel's and the plain version's tanh
#: round du to neighbouring bf16 values, dW, db and dx move by x * ulp(du)
#: and w * ulp(du); 5e-3 of the scale holds that
BF16_BACKWARD_TOL = (5e-3, 2)
#: the H100 SXM's dense bf16 tensor-core peak and HBM rate
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_INT8_OPS = 1979e12
HBM_BYTES_PER_S = 3.35e12


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean milliseconds per call of ``fn`` on the current stream."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_us(fn, calls: int = 100, repeats: int = 5) -> float:
    """Host microseconds per call of ``fn`` over ``calls`` calls that do not
    wait for the card (the launch cost a step's host thread pays), starting
    on an idle card after a warm-up: the median of ``repeats`` such runs
    (the host clock of a shared machine spreads)."""
    import torch

    fn()
    runs = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        runs.append((time.perf_counter() - t0) / calls * 1e6)
    torch.cuda.synchronize()
    return sorted(runs)[repeats // 2]


# --- phase 1 ---------------------------------------------------------------

def phase_device() -> str:
    import torch

    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    return card


# --- phase 2 ---------------------------------------------------------------

KERNEL_SOURCES = ("fused_conv_block", "int8_conv", "fused_conv_wgrad",
                  "conv_epilogue_bwd", "fused_adamw")


def phase_build(sources=KERNEL_SOURCES, later=()):
    """One nvcc per source, all started together. The sources in
    ``later`` go on building while the caller runs phases that need none
    of them: the returned callable waits for them (every build is reported
    once all are done)."""
    from concurrent.futures import ThreadPoolExecutor

    from jaeger_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    pool = ThreadPoolExecutor(len(sources))
    builds = {name: pool.submit(cuda_build.load, name,
                                extra_flags=("-Xptxas", "-v"))
              for name in sources}
    for name in sources:
        if name not in later:
            builds[name].result()
    print(f"build: {', '.join(n for n in sources if n not in later)} ready "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)

    def join() -> None:
        for name in sources:
            builds[name].result()
        pool.shutdown()
        for name in sources:
            print(f"build: {name} (nvcc "
                  f"{cuda_build.build_seconds.get(name, 0.0):.1f} s)")
        print(f"build: all kernels ready in "
              f"{time.perf_counter() - t0:.1f} s")
        for name, kernel in (("fused_conv_block", "conv_bf16_wgmma"),
                             ("fused_conv_block", "conv_bf16_stream"),
                             ("fused_conv_block", "conv_f32_ring"),
                             ("int8_conv", "int8_wgmma"),
                             ("int8_conv", "int8_ragged"),
                             ("int8_conv", "int8_ragged_staged"),
                             ("fused_conv_wgrad", "wgrad_bf16"),
                             ("fused_conv_wgrad", "wgrad_f32_ring"),
                             ("fused_conv_wgrad", "wgrad_f32_taps"),
                             ("conv_epilogue_bwd", "conv_epilogue_bwd"),
                             ("fused_adamw", "adamw_sumsq"),
                             ("fused_adamw", "adamw_update")):
            for line in ptxas_summary(cuda_build.build_logs.get(name, ""),
                                      kernel):
                print(f"ptxas: {line}")

    if not later:
        join()
    return join


def ptxas_summary(log: str, kernel: str) -> list[str]:
    """Registers, shared memory and spills that ``-Xptxas -v`` reported for
    each instance of ``kernel`` (a C++ name, matched as the mangled name's
    length-prefixed identifier, so ``int8_ragged`` leaves out
    ``int8_ragged_staged``) in ``log``."""
    out, entry = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1] if "'" in line else line
            entry = name if f"{len(kernel)}{kernel}" in name else None
        elif entry is not None and ("Used" in line or "spill" in line):
            out.append(f"{kernel}<{_template_args(entry.rsplit(kernel, 1)[1])}>"
                       f": {line.split(':', 1)[-1].strip()}")
    return out


def _template_args(mangled: str) -> str:
    """'bf16, 128, 64' from the Itanium mangling of a kernel's template
    arguments (``I13__nv_bfloat16Li128ELi64EEEv...``, ``IaLi16ELi32E...``,
    ``IfLi4ELb1EEEv...``: int and bool arguments)."""
    args = mangled.split("EEv", 1)[0] + "E"
    types = {"a": "int8", "13__nv_bfloat16": "bf16", "f": "f32"}
    m = re.match(r"I(a|f|13__nv_bfloat16)?", args)
    head = [types[m.group(1)]] if m and m.group(1) else []
    return ", ".join(head + re.findall(r"L[ib](\d+)E", args))


# --- phase 3 ---------------------------------------------------------------

def _conv_inputs(gen, n, length, c, k, dtype, device):
    import torch

    x = torch.randn(n, length, c, generator=gen).to(device, dtype)
    w = (torch.randn(k, c, c, generator=gen) * 0.05).to(device)
    bias = torch.randn(c, generator=gen).to(device)
    dyt = torch.stack([torch.full((c,), 0.5), torch.randn(c, generator=gen),
                       torch.randn(c, generator=gen)]).to(device)
    return x, w, bias, dyt


def _extension_args(gen, x, case, device):
    """Keyword arguments of one extension case for (x: (N, L, C))."""
    import torch

    n, length, c = x.shape
    kw = {}
    if case in ("bias_then_dyt", "in_mask", "out_mask", "residual", "all",
                "model", "in_mask_runs", "out_mask_residual"):
        kw.update(use_dyt=True, bias_then_dyt=True)
    if case in ("in_mask", "all", "model"):
        kw["in_mask"] = (torch.rand(n, length, generator=gen) > 0.2).to(device)
    if case == "in_mask_runs":
        # masked runs across the 64-row tile edges and into the halo at
        # both ends of each row
        m = torch.ones(n, length, dtype=torch.bool)
        for lo, hi in ((0, 3), (60, 69), (125, 131), (length - 3, length)):
            m[:, max(lo, 0):min(hi, length)] = False
        kw["in_mask"] = m.to(device)
    if case in ("out_mask", "all", "model", "out_mask_residual"):
        kw["out_mask"] = (torch.rand(n, length, generator=gen) > 0.2).to(device)
    if case in ("residual", "all", "model", "out_mask_residual"):
        kw["residual"] = torch.randn(n, length, c, generator=gen).to(
            device, x.dtype)
    return kw


def library_conv_block(x, w, bias, dyt, act, residual=None):
    """Yardstick only: cuDNN's conv plus the same epilogue in torch ops."""
    import torch
    import torch.nn.functional as F

    k = w.shape[0]
    pad_l = (k - 1) // 2
    y = F.conv1d(F.pad(x.transpose(1, 2), (pad_l, k - 1 - pad_l)),
                 w.to(x.dtype).permute(2, 1, 0), bias.to(x.dtype))
    y = y.transpose(1, 2)
    if dyt is not None:
        y = torch.tanh(y * dyt[0].to(x.dtype)) * dyt[1].to(x.dtype) + dyt[
            2].to(x.dtype)
    if residual is not None:
        y = y + residual
    if act == "none":
        return y
    return F.gelu(y, approximate="tanh" if act == "gelu_tanh" else "none")


def phase_kernel(card: str) -> dict:
    import torch

    from jaeger_tpu_torch.ops import fused_conv

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(1234)
    f32, bf16 = torch.float32, torch.bfloat16
    # (name, n, length, c, k, dtype, act, extension case)
    cases = [
        ("pallas_bias_k3", 8, 300, 128, 3, f32, "none", "bias"),
        ("pallas_bias_k5", 8, 300, 128, 5, f32, "none", "bias"),
        ("pallas_bias_k7", 8, 300, 128, 7, f32, "none", "bias"),
        ("pallas_dyt_gelu", 8, 256, 128, 5, f32, "gelu", "dyt"),
        ("pallas_ragged_relu", 10, 333, 128, 5, f32, "relu", "bias"),
        ("pallas_bf16", 8, 256, 128, 5, bf16, "none", "bias"),
    ]
    for dt, act in ((f32, "gelu"), (bf16, "gelu_tanh")):
        for ext in ("bias_then_dyt", "in_mask", "out_mask", "residual",
                    "all"):
            cases.append((f"{ext}_{str(dt)[6:]}", 6, 300, 128, 5, dt, act,
                          ext))
    cases += [
        ("demo_shape_bf16", 96 * 6, 165, 32, 3, bf16, "none", "in_mask"),
        ("flagship_shape_bf16", 6 * 256, 500, 128, 5, bf16, "gelu_tanh",
         "model"),
        ("flagship_shape_f32", 6 * 32, 500, 128, 5, f32, "gelu", "model"),
        # the bf16 kernel's edges: 64-row tiles, the TMA halo, the plan's
        # chunk widths (C 16 / 32 / 64) and column blocks (CB < C at C 256
        # and at C 128 with k 7)
        ("edge_L1", 4, 1, 128, 5, bf16, "gelu_tanh", "model"),
        ("edge_L63", 3, 63, 128, 5, bf16, "gelu_tanh", "model"),
        ("edge_L65", 3, 65, 128, 5, bf16, "gelu_tanh", "model"),
        ("edge_N1", 1, 500, 128, 5, bf16, "gelu_tanh", "model"),
        ("edge_C16", 6, 300, 16, 3, bf16, "gelu_tanh", "all"),
        ("edge_C64_k3", 6, 300, 64, 3, bf16, "gelu_tanh", "model"),
        ("edge_C256_k5", 6, 300, 256, 5, bf16, "gelu_tanh", "model"),
        ("edge_C128_k7", 6, 300, 128, 7, bf16, "gelu_tanh", "model"),
        ("edge_k1", 6, 300, 128, 1, bf16, "gelu_tanh", "model"),
        ("edge_in_mask_runs", 6, 300, 128, 5, bf16, "gelu_tanh",
         "in_mask_runs"),
        ("edge_out_mask_residual", 6, 300, 128, 5, bf16, "gelu_tanh",
         "out_mask_residual"),
        ("edge_act_tanh", 6, 130, 128, 3, bf16, "tanh", "all"),
        ("edge_act_gelu_erf", 6, 130, 128, 3, bf16, "gelu", "all"),
        ("edge_act_relu", 6, 130, 128, 3, bf16, "relu", "bias"),
    ]
    worst = 0.0
    for name, n, length, c, k, dt, act, ext in cases:
        x, w, bias, dyt = _conv_inputs(gen, n, length, c, k, dt, dev)
        if ext == "bias":
            kw = dict(bias=bias)
        elif ext == "dyt":
            kw = dict(bias=bias, dyt=dyt, use_dyt=True)
        elif ext == "in_mask" and dt == bf16 and c == 32:
            kw = dict(bias=bias, in_mask=(torch.rand(n, length, generator=gen)
                                          > 0.1).to(dev))
        else:
            kw = dict(bias=bias, dyt=dyt, **_extension_args(gen, x, ext, dev))
        before = fused_conv.launches
        out = fused_conv.fused_conv_block(x, w, act=act, **kw)
        torch.cuda.synchronize()
        check(fused_conv.launches == before + 1, f"{name}: kernel not launched")
        ref = fused_conv.reference_conv_block(x, w, act=act, **kw)
        check(out.dtype == x.dtype and out.shape == x.shape,
              f"{name}: output {out.dtype} {tuple(out.shape)}")
        err = (out.float() - ref.float()).abs()
        tol = F32_TOL if dt == f32 else BF16_TOL
        bad = (err > tol + tol * ref.float().abs()).sum().item()
        max_err = err.max().item()
        print(f"kernel {name}: max_abs_err {max_err:.3e} (tol {tol}) "
              f"{'ok' if bad == 0 and math.isfinite(max_err) else 'FAIL'}")
        check(bad == 0 and math.isfinite(max_err),
              f"{name}: {bad} elements beyond tolerance")
        if "out_mask" in kw and "residual" not in kw:
            check(bool((out[~kw["out_mask"]] == 0).all()),
                  f"{name}: out_mask positions not zero")
        if name == "flagship_shape_bf16":
            worst = max_err
        del x, w, out, ref, err

    # timings at the flagship batch: N = 6 * 2048 rows of 500 positions
    n, length, c, k = 6 * 2048, 500, 128, 5
    x, w, bias, dyt = _conv_inputs(gen, n, length, c, k, bf16, dev)
    res = torch.randn(n, length, c, generator=gen).to(dev, bf16)
    dyt_kw = dict(bias=bias, dyt=dyt, use_dyt=True, bias_then_dyt=True)
    forms = {
        # conv1 of a residual block in the dense program
        "conv1": (dyt_kw, "gelu_tanh"),
        # conv2: the shortcut add rides the epilogue
        "conv2": (dict(dyt_kw, residual=res), "gelu_tanh"),
        # the products and a bias add only: conv1 minus this is the cost of
        # the DYT + gelu_tanh epilogue
        "bias_only": (dict(bias=bias), "none"),
    }
    times = {}
    launches_before = fused_conv.launches
    for form, (kw, act) in forms.items():
        kern = cuda_ms(lambda: fused_conv.fused_conv_block(
            x, w, act=act, **kw), iters=20)
        plain = cuda_ms(lambda: fused_conv.reference_conv_block(
            x, w, act=act, **kw), iters=3, warmup=1)
        lib = cuda_ms(lambda: library_conv_block(
            x, w, bias, kw.get("dyt"), act, kw.get("residual")))
        flops = 2.0 * n * length * c * c * k
        nbytes = (2 * n * length * c * (3 if "residual" in kw else 2)
                  + 2 * k * c * c + 4 * c * (4 if "dyt" in kw else 1))
        t_ops = flops / PEAK_BF16_FLOPS * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        bound = max(t_ops, t_bytes)
        times[form] = dict(ms=kern, plain_ms=plain, library_ms=lib,
                           bound_ms=bound, bound_share=bound / kern,
                           bound_by="operations" if t_ops >= t_bytes
                           else "bytes", flops=flops, bytes=nbytes)
        print(f"timing {form} N={n} L={length} C={c} k={k} bf16 on {card}: "
              f"kernel {kern:.3f} ms, plain {plain:.3f} ms, library "
              f"{lib:.3f} ms, bound {bound:.3f} ms "
              f"({times[form]['bound_by']}: {flops:.3e} FLOP, "
              f"{nbytes / 1e9:.3f} GB), {bound / kern:.1%} of the bound, "
              f"{flops / kern / 1e9:.1f} TFLOP/s")
    fused_conv.launches = launches_before  # timing launches are not the path
    return {"max_abs_err": worst, **times["conv1"], "conv2": times["conv2"],
            "bias_only": times["bias_only"]}


def phase_sweep(card: str) -> None:
    """``--sweep``: the bf16 kernel at the flagship shape (bias-only and
    conv1 forms) under other launch plans of the same layout (column block,
    ring stages) and with fewer taps (k = 1, 3: the same bytes, 1/5 and 3/5
    of the products), to tell the ring's latency from the tensor cores."""
    import torch

    from jaeger_tpu_torch.ops import fused_conv

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(99)
    n, length, c = 6 * 2048, 500, 128
    launches_before = fused_conv.launches
    for k in (5, 3, 1):
        x, w, bias, dyt = _conv_inputs(gen, n, length, c, k, torch.bfloat16,
                                       dev)
        w = w.to(torch.bfloat16)  # _launch takes the checked operands
        plans = [fused_conv.conv_plan(c, k)]
        if k == 5:
            plans += [dict(cb=cb, kw=64, stages=st,
                           smem=fused_conv.plan_bytes(c, k, cb, 64, st))
                      for cb, st in ((128, 2), (64, 2), (64, 3), (64, 4),
                                     (32, 4))]
        for plan in plans:
            for form, args in (("bias_only", (bias, None, "none")),
                               ("conv1", (bias, dyt, "gelu_tanh"))):
                ms = cuda_ms(lambda: fused_conv._launch(
                    x, w, *args, None, None, None, plan), iters=20)
                bound = 2.0 * n * length * c * c * k / PEAK_BF16_FLOPS * 1e3
                print(f"sweep k={k} cb={plan['cb']} stages={plan['stages']} "
                      f"{form} on {card}: {ms:.3f} ms "
                      f"(products at the bf16 peak {bound:.3f} ms)")
        del x, w
    fused_conv.launches = launches_before


# --- phase 3, f32: the f32 forms of fused_conv_block ------------------------

def _route_counts() -> dict:
    """Launches by ``kernel:route`` of fused_conv_block and conv_wgrad."""
    from jaeger_tpu_torch.ops import fused_conv
    from jaeger_tpu_torch.ops import fused_conv_grad as fg

    out = {f"fused_conv_block:{r}": n
           for r, n in fused_conv.route_launches.items()}
    out.update({f"conv_wgrad:{r}": n
                for r, n in fg.wgrad_route_launches.items()})
    return out


#: the inference shape: batch 2048 of the flagship, six frames
FLAG_N, FLAG_L, FLAG_C, FLAG_K = 6 * 2048, 500, 128, 5
#: the f32 kernel against the plain version in float64 at the flagship
#: shape, relative to the output's scale: f32 FMAs give about 1e-6, TF32
#: products (10 mantissa bits) about 1e-3
F64_TOL = 1e-5


def tf32_off() -> None:
    """Full f32 in cuDNN and cuBLAS, asserted: the f32 yardsticks (cuDNN
    runs f32 convolutions in TF32 by default)."""
    import torch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    check(not torch.backends.cudnn.allow_tf32
          and not torch.backends.cuda.matmul.allow_tf32, "TF32 is on")


def _bound(flops: float, nbytes: float, peak: float) -> tuple[float, str]:
    """(ms, what sets it): the larger of operations / peak and bytes / the
    HBM rate."""
    t_ops = flops / peak * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def _print_timing(what: str, t: dict, card: str) -> None:
    print(f"timing {what} on {card}: kernel {t['ms']:.3f} ms [{t['route']}]"
          f", plain {t['plain_ms']:.3f} ms, library "
          f"{t['library_ms']:.3f} ms (TF32 off), bound {t['bound_ms']:.3f} ms "
          f"({t['bound_by']}: {t['flops']:.3e} FLOP, "
          f"{t['bytes'] / 1e9:.3f} GB), {t['bound_ms'] / t['ms']:.1%} of the "
          f"bound")


def reference_conv_block_f64(x, w, bias=None, dyt=None, act="none", *,
                             in_mask=None, out_mask=None, residual=None):
    """The plain version in float64 throughout (bias, then DYT when dyt is
    given): the f32 kernel's accuracy yardstick."""
    import torch
    import torch.nn.functional as F

    length = x.shape[1]
    k = w.shape[0]
    pad_l = (k - 1) // 2
    xd = x.double()
    if in_mask is not None:
        xd = xd * in_mask[..., None]
    xd = F.pad(xd, (0, 0, pad_l, k - 1 - pad_l))
    wd = w.double()
    y = xd[:, 0:length] @ wd[0]
    for j in range(1, k):
        y = y + xd[:, j:j + length] @ wd[j]
    if bias is not None:
        y = y + bias.double()
    if dyt is not None:
        d = dyt.double()
        y = torch.tanh(y * d[0]) * d[1] + d[2]
    if out_mask is not None:
        y = y * out_mask[..., None]
    if residual is not None:
        y = y + residual.double()
    if act == "gelu":
        return F.gelu(y)
    check(act == "none", f"reference_conv_block_f64: act {act}")
    return y


def _f32_runs_mask(n: int, length: int, device):
    """in_mask with masked runs across the f32 kernels' 32-row units and
    ring stages and into the halo at both ends of each row (runs longer
    than a tap window too)."""
    import torch

    m = torch.ones(n, length, dtype=torch.bool)
    for lo, hi in ((0, 3), (29, 35), (60, 69), (120, 161), (250, 262),
                   (509, 515), (length - 3, length)):
        m[:, max(lo, 0):min(hi, length)] = False
    return m.to(device)


def phase_f32_kernel(card: str) -> dict:
    """The f32 forms of fused_conv_block (route f32_ring): its edges
    against the plain version at F32_TOL, the same bits run to run (L 1,
    127, 129 and 600; N 1; C 16, 48, 64, 256; k 1, 3, 4, 7, 9; past 9 taps
    k 11, 21, 23 (weights resident, in tap blocks) and 31 (streamed) at C
    16, 64 and 128 and k 13 at C 256 (streamed); in_mask runs across the
    units and the halo; out_mask with residual; every activation; the
    data gradient's form); then at the flagship shape (N 12288, L 500, C
    128, k 5) conv1 (bias, DYT, gelu), conv2 (+ residual) and bias-only
    against the plain version, timed beside the plain version, the
    library yardstick with TF32 off and the bound at the card's f32 peak;
    then the model form (in and out masks, residual) against the plain
    version in float64."""
    import torch

    from jaeger_tpu_torch.ops import fused_conv

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(4321)
    f32 = torch.float32
    launches_before = fused_conv.launches, dict(fused_conv.route_launches)
    tf32_off()
    # (name, n, length, c, k, act, extension case, route)
    cases = [("f32_L1", 4, 1, 128, 5, "gelu", "model", "f32_ring"),
             ("f32_L127", 3, 127, 128, 5, "gelu", "model", "f32_ring"),
             ("f32_L129", 3, 129, 128, 5, "gelu", "model", "f32_ring"),
             ("f32_L600", 3, 600, 128, 5, "gelu", "model", "f32_ring"),
             ("f32_N1", 1, 500, 128, 5, "gelu", "model", "f32_ring"),
             ("f32_C16_k3", 6, 300, 16, 3, "gelu", "all", "f32_ring"),
             ("f32_C48_k4", 6, 300, 48, 4, "gelu", "all", "f32_ring"),
             ("f32_C64_k3", 6, 300, 64, 3, "gelu", "model", "f32_ring"),
             ("f32_C256_k5", 6, 300, 256, 5, "gelu", "model", "f32_ring"),
             ("f32_k1", 6, 300, 128, 1, "gelu", "model", "f32_ring"),
             ("f32_k4", 6, 300, 128, 4, "gelu", "model", "f32_ring"),
             ("f32_k7", 6, 300, 128, 7, "gelu", "model", "f32_ring"),
             ("f32_k9", 6, 300, 128, 9, "gelu", "model", "f32_ring"),
             ("f32_in_mask_runs", 6, 600, 128, 5, "gelu", "runs",
              "f32_ring"),
             ("f32_out_mask_residual", 6, 300, 128, 5, "gelu",
              "out_mask_residual", "f32_ring"),
             ("f32_dgrad_form", 6, 300, 128, 5, "none", "out_mask",
              "f32_ring")]
    cases += [(f"f32_act_{act}", 6, 300, 128, 3, act, "all", "f32_ring")
              for act in ("none", "relu", "tanh", "gelu", "gelu_tanh")]
    # past the register window's 9 taps: tap blocks over resident weights
    # (k 11, 21, 23), streamed weights (C 128 k 31, C 256 k 13)
    cases += [(f"f32_C{c}_k{k}", 6, 300, c, k, "gelu", "model", "f32_ring")
              for c in (16, 64, 128) for k in (11, 21, 23, 31)]
    cases += [("f32_C256_k13", 6, 300, 256, 13, "gelu", "model", "f32_ring"),
              ("f32_k11_in_mask_runs", 6, 600, 128, 11, "gelu", "runs",
               "f32_ring"),
              ("f32_k31_in_mask_runs", 5, 600, 128, 31, "gelu", "runs",
               "f32_ring"),
              ("f32_k21_out_mask_residual", 6, 300, 128, 21, "gelu",
               "out_mask_residual", "f32_ring"),
              ("f32_k11_dgrad_form", 6, 300, 128, 11, "none", "out_mask",
               "f32_ring"),
              ("f32_k31_dgrad_form", 6, 300, 128, 31, "none", "out_mask",
               "f32_ring"),
              ("f32_k13_L1", 4, 1, 256, 13, "gelu", "model", "f32_ring"),
              ("f32_k31_N1", 1, 500, 128, 31, "gelu", "model", "f32_ring")]
    cases += [(f"f32_k11_act_{act}", 6, 300, 64, 11, act, "all", "f32_ring")
              for act in ("none", "relu", "tanh", "gelu", "gelu_tanh")]
    worst = 0.0
    for name, n, length, c, k, act, ext, route in cases:
        x, w, bias, dyt = _conv_inputs(gen, n, length, c, k, f32, dev)
        if ext == "runs":
            kw = dict(bias=bias, dyt=dyt, use_dyt=True, bias_then_dyt=True,
                      in_mask=_f32_runs_mask(n, length, dev))
        elif ext == "out_mask":  # the data gradient's form: no bias
            kw = dict(out_mask=(torch.rand(n, length, generator=gen)
                                > 0.2).to(dev))
        else:
            kw = dict(bias=bias, dyt=dyt, **_extension_args(gen, x, ext, dev))
        plan = fused_conv.conv_plan(c, k, f32)
        check(plan["route"] == route, f"{name}: plan {plan}")
        before = fused_conv.route_launches[route]
        out = fused_conv.fused_conv_block(x, w, act=act, **kw)
        torch.cuda.synchronize()
        check(fused_conv.route_launches[route] == before + 1,
              f"{name}: route {route} not launched")
        check(torch.equal(fused_conv.fused_conv_block(x, w, act=act, **kw),
                          out), f"{name}: not the same bits run to run")
        ref = fused_conv.reference_conv_block(x, w, act=act, **kw)
        err = (out - ref).abs()
        bad = (err > F32_TOL + F32_TOL * ref.abs()).sum().item()
        max_err = err.max().item()
        print(f"kernel {name} N={n} L={length} C={c} k={k} {act} [{route} "
              f"cb={plan['cb']} taps={plan['taps']} stages="
              f"{plan['stages']}]: max_abs_err "
              f"{max_err:.3e} (tol {F32_TOL}) "
              f"{'ok' if bad == 0 and math.isfinite(max_err) else 'FAIL'}")
        check(bad == 0 and math.isfinite(max_err),
              f"{name}: {bad} elements beyond tolerance")
        if "out_mask" in kw and "residual" not in kw:
            check(bool((out[~kw["out_mask"]] == 0).all()),
                  f"{name}: out_mask positions not zero")
        worst = max(worst, max_err)
        del x, w, out, ref, err

    n, length, c, k = FLAG_N, FLAG_L, FLAG_C, FLAG_K
    x, w, bias, dyt = _conv_inputs(gen, n, length, c, k, f32, dev)
    res = torch.randn(n, length, c, generator=gen).to(dev)
    plan = fused_conv.conv_plan(c, k, f32)
    forms = {"conv1": ((bias, dyt), "gelu", None),
             "conv2": ((bias, dyt), "gelu", res),
             "bias_only": ((bias, None), "none", None)}
    flops = 2.0 * n * length * c * c * k
    times = {}
    for form, ((b, d), act, r) in forms.items():
        ref = fused_conv.reference_conv_block(
            x, w, b, d, act, d is not None, bias_then_dyt=d is not None,
            residual=r)
        out = fused_conv._launch(x, w, b, d, act, None, None, r, plan)
        err = (out - ref).abs()
        bad = (err > F32_TOL + F32_TOL * ref.abs()).sum().item()
        max_err = err.max().item()
        print(f"kernel f32 flagship {form} [{plan['route']}]: max_abs_err "
              f"{max_err:.3e} (tol {F32_TOL}) "
              f"{'ok' if bad == 0 and math.isfinite(max_err) else 'FAIL'}")
        check(bad == 0 and math.isfinite(max_err),
              f"f32 flagship {form}: {bad} elements beyond tolerance")
        worst = max(worst, max_err)
        del out, err, ref
        ms = cuda_ms(lambda: fused_conv._launch(
            x, w, b, d, act, None, None, r, plan), iters=20, warmup=1)
        plain = cuda_ms(lambda: fused_conv.reference_conv_block(
            x, w, b, d, act, d is not None, bias_then_dyt=d is not None,
            residual=r), iters=3, warmup=1)
        tf32_off()
        lib = cuda_ms(lambda: library_conv_block(x, w, b, d, act, r),
                      iters=5, warmup=1)
        nbytes = (4 * n * length * c * (3 if r is not None else 2)
                  + 4 * k * c * c + 4 * c * (4 if d is not None else 1))
        bound, by = _bound(flops, nbytes, PEAK_F32_FLOPS)
        times[form] = dict(ms=ms, route=plan["route"],
                           plain_ms=plain, library_ms=lib, bound_ms=bound,
                           bound_by=by, flops=flops, bytes=nbytes)
        _print_timing(f"f32 {form} N={n} L={length} C={c} k={k}",
                      times[form], card)
    # the model form against float64, row chunks of the full-shape output
    kw = dict(bias=bias, dyt=dyt, use_dyt=True, bias_then_dyt=True,
              in_mask=(torch.rand(n, length, generator=gen) > 0.2).to(dev),
              out_mask=(torch.rand(n, length, generator=gen) > 0.2).to(dev),
              residual=res)
    out = fused_conv.fused_conv_block(x, w, act="gelu", **kw)
    torch.cuda.synchronize()
    err = scale = 0.0
    for lo in range(0, n, 1024):
        sl = slice(lo, lo + 1024)
        ref = reference_conv_block_f64(
            x[sl], w, bias, dyt, "gelu", in_mask=kw["in_mask"][sl],
            out_mask=kw["out_mask"][sl], residual=res[sl])
        err = max(err, (out[sl].double() - ref).abs().max().item())
        scale = max(scale, ref.abs().max().item())
        del ref
    rel = err / scale
    print(f"kernel f32 flagship model form [{plan['route']}] against "
          f"float64: "
          f"max_abs_err {err:.3e}, scale {scale:.3e}, {rel:.2e} of the scale "
          f"(tol {F64_TOL}) {'ok' if rel < F64_TOL else 'FAIL'}")
    check(rel < F64_TOL, f"f32 kernel {rel:.2e} of the scale from float64")
    # checks and timings are not the main path
    fused_conv.launches = launches_before[0]
    fused_conv.route_launches.clear()
    fused_conv.route_launches.update(launches_before[1])
    del x, w, res, out
    return {"max_abs_err": worst, "f64_rel_err": rel,
            "f64_max_abs_err": err, **times["conv1"],
            "conv2": times["conv2"], "bias_only": times["bias_only"]}


def phase_f32_train_kernel(card: str) -> dict:
    """The f32 backward kernels: conv_wgrad's f32 ring route against its
    plain version at F32_TOL (the train shape; C 64 / 128 / 256 and the
    block widths of other C, 16 / 32 / 48 / 80 / 96 / 112 / 144, whose
    CTAs take several taps at 16, 32, 48; k 1 / 3 / 5 / 7 / 9 / 11; L 1,
    31, 33 and 65; in_mask none, random and in runs across its ring
    stages; N 1), the same bits run to run; then at the train shape (N
    1536, L 500, C 128, k 5) the data gradient (fused_conv_block with the
    flipped weights and out_mask), conv_wgrad and the conv2 form of
    conv_epilogue_bwd, each beside its plain version, the library
    yardstick with TF32 off and the bound at the card's f32 peak."""
    import torch

    from jaeger_tpu_torch.ops import fused_conv
    from jaeger_tpu_torch.ops import fused_conv_grad as fg

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(8642)
    f32 = torch.float32
    n, length, c, k = TRAIN_N, TRAIN_L, TRAIN_C, TRAIN_K
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    saved = (dict(fg.launches), fused_conv.launches,
             dict(fused_conv.route_launches), dict(fg.wgrad_route_launches))
    tf32_off()
    worst = 0.0
    for name, cn, cl, cc, ck, mk in [
            ("f32_train_shape", n, length, c, k, "random"),
            ("f32_C64_k3", 6, 300, 64, 3, "runs"),
            ("f32_C256_k5", 6, 300, 256, 5, "random"),
            ("f32_k1", 6, 300, 128, 1, "none"),
            ("f32_k7_runs", 6, 300, 128, 7, "runs"),
            ("f32_L1", 4, 1, 128, 5, "none"),
            ("f32_L31", 3, 31, 128, 5, "random"),
            ("f32_L33", 3, 33, 128, 3, "runs"),
            ("f32_L65_N1", 1, 65, 128, 5, "random"),
            # the block widths of C % 64 != 0 (several taps a CTA at 16,
            # 32, 48: tap blocks of near equal size)
            ("f32_C16_k5", 6, 300, 16, 5, "random"),
            ("f32_C16_k11_runs", 6, 300, 16, 11, "runs"),
            ("f32_C16_k1_L1", 4, 1, 16, 1, "none"),
            ("f32_C32_k5_runs", 6, 300, 32, 5, "runs"),
            ("f32_C32_k9", 6, 300, 32, 9, "random"),
            ("f32_C32_L31", 3, 31, 32, 3, "none"),
            ("f32_C48_k5", 6, 300, 48, 5, "random"),
            ("f32_C48_k3_L33", 3, 33, 48, 3, "runs"),
            ("f32_C48_k11_N1", 1, 65, 48, 11, "random"),
            ("f32_C80_k3", 6, 300, 80, 3, "runs"),
            ("f32_C80_k1_L65", 3, 65, 80, 1, "random"),
            ("f32_C96_k5", 6, 300, 96, 5, "random"),
            ("f32_C96_k9_runs", 6, 300, 96, 9, "runs"),
            ("f32_C96_L1", 4, 1, 96, 5, "none"),
            ("f32_C112_k5", 6, 300, 112, 5, "random"),
            ("f32_C112_k11_L31", 3, 31, 112, 11, "runs"),
            ("f32_C144_k3", 6, 300, 144, 3, "random"),
            ("f32_C144_k5_L65_N1", 1, 65, 144, 5, "runs")]:
        xx = torch.randn(cn, cl, cc, generator=gen).to(dev)
        dd = (torch.randn(cn, cl, cc, generator=gen) * 0.1).to(dev)
        if mk == "runs":
            mm = _f32_runs_mask(cn, cl, dev)
        elif mk == "random":
            mm = (torch.rand(cn, cl, generator=gen) > 0.2).to(dev)
        else:
            mm = None
        plan = fg.wgrad_plan(cn, cl, cc, ck, f32, sms)
        check(plan["route"] == "fma_ring", f"conv_wgrad {name}: plan {plan}")
        before = fg.wgrad_route_launches["fma_ring"]
        dw, db = fg.conv_wgrad(xx, dd, mm, ck)
        torch.cuda.synchronize()
        check(fg.wgrad_route_launches["fma_ring"] == before + 1,
              f"conv_wgrad {name}: route fma_ring not launched")
        again = fg.conv_wgrad(xx, dd, mm, ck)
        check(torch.equal(again[0], dw) and torch.equal(again[1], db),
              f"conv_wgrad {name}: not the same bits run to run")
        rdw, rdb = fg.reference_conv_wgrad(xx, dd, mm, ck)
        worst = max(worst, _check_close(
            f"conv_wgrad {name} N={cn} L={cl} C={cc} k={ck} float32 "
            f"mask={mk} [fma_ring groups={plan['groups']}x{plan['group']} "
            f"block={plan['co_block']}]", {"dW": (dw, rdw), "db": (db, rdb)},
            F32_TOL))
        del xx, dd, dw, db, rdw, rdb, again

    x = torch.randn(n, length, c, generator=gen).to(dev)
    du = (torch.randn(n, length, c, generator=gen) * 0.1).to(dev)
    w = (torch.randn(k, c, c, generator=gen) * 0.05).to(dev)
    im = (torch.rand(n, length, generator=gen) > 0.2).to(dev)
    x_ncl = x.transpose(1, 2).contiguous()
    du_ncl = du.transpose(1, 2).contiguous()
    flops = 2.0 * n * length * c * c * k
    times = {}

    # the data gradient
    wf = fg.flipped_weights(w)
    plan = fused_conv.conv_plan(c, k, f32)
    ref = fused_conv.reference_conv_block(du, wf, out_mask=im)
    err = _check_close(f"dgrad f32 train shape [{plan['route']}]", {"dx": (
        fused_conv._launch(du, wf, None, None, "none", None, im, None,
                           plan), ref)}, F32_TOL)
    del ref
    nbytes = 4 * 2 * n * length * c + 4 * k * c * c + n * length
    bound, by = _bound(flops, nbytes, PEAK_F32_FLOPS)
    times["dgrad"] = dict(
        ms=cuda_ms(lambda: fused_conv._launch(
            du, wf, None, None, "none", None, im, None, plan), iters=20),
        route=plan["route"],
        plain_ms=cuda_ms(lambda: fused_conv.reference_conv_block(
            du, wf, out_mask=im), iters=3, warmup=1),
        library_ms=cuda_ms(lambda: torch.nn.grad.conv1d_input(
            (n, c, length), w.permute(2, 1, 0), du_ncl,
            padding=(k - 1) // 2), iters=10),
        bound_ms=bound, bound_by=by, flops=flops, bytes=nbytes,
        max_abs_err=err)

    # conv_wgrad (checked at this shape above)
    plan = fg.wgrad_plan(n, length, c, k, f32, sms)
    nbytes = 4 * 2 * n * length * c + n * length + 4 * (k * c * c + c)
    bound, by = _bound(flops, nbytes, PEAK_F32_FLOPS)
    times["conv_wgrad"] = dict(
        ms=cuda_ms(lambda: fg.conv_wgrad(x, du, im, k), iters=20, warmup=1),
        route=plan["route"],
        plain_ms=cuda_ms(lambda: fg.reference_conv_wgrad(x, du, im, k),
                         iters=3, warmup=1),
        library_ms=cuda_ms(lambda: torch.nn.grad.conv1d_weight(
            x_ncl, (c, c, k), du_ncl, padding=(k - 1) // 2), iters=10),
        bound_ms=bound, bound_by=by, flops=flops, bytes=nbytes, plan=plan)
    del x_ncl, du_ncl

    # conv_epilogue_bwd, conv2 form: dy, u, r, out_mask in; du, dr out
    dy = torch.randn(n, length, c, generator=gen).to(dev)
    r = torch.randn(n, length, c, generator=gen).to(dev)
    dyt = torch.stack([torch.full((c,), 0.7), torch.randn(c, generator=gen),
                       torch.randn(c, generator=gen)]).to(dev)
    lib = library_epilogue_bwd(dy, x, r, im, dyt)
    nbytes = 5 * 4 * n * length * c + n * length + 4 * 6 * c
    bound, by = _bound(0.0, nbytes, PEAK_F32_FLOPS)
    times["conv_epilogue_bwd"] = dict(
        ms=cuda_ms(lambda: fg.conv_epilogue_bwd(dy, x, r, im, dyt,
                                                "gelu_tanh"), iters=20),
        route="cuda", plain_ms=cuda_ms(
            lambda: fg.reference_conv_epilogue_bwd(dy, x, r, im, dyt,
                                                   "gelu_tanh"),
            iters=3, warmup=1),
        library_ms=cuda_ms(lib, iters=10), bound_ms=bound, bound_by=by,
        flops=0.0, bytes=nbytes)
    del lib
    # checks and timings are not the main path
    fg.launches.update(saved[0])
    fused_conv.launches = saved[1]
    for counter, before in ((fused_conv.route_launches, saved[2]),
                            (fg.wgrad_route_launches, saved[3])):
        counter.clear()
        counter.update(before)
    times["conv_wgrad"]["max_abs_err"] = worst
    for key, t in times.items():
        _print_timing(f"f32 {key} N={n} L={length} C={c} k={k}", t, card)
    return times


#: the f32 kernel table's further shapes: (name, op, N, C, k); L 500
F32_SHAPES = (("fwd_k11", "forward", FLAG_N, 128, 11),
              ("fwd_k31", "forward", 6 * 256, 128, 31),
              ("dgrad_k11", "dgrad", 6 * 256, 128, 11),
              ("wgrad_C16", "wgrad", 6 * 256, 16, 5),
              ("wgrad_C48", "wgrad", 6 * 256, 48, 5),
              ("wgrad_C96", "wgrad", 6 * 256, 96, 5))


def phase_f32_shapes(card: str) -> dict:
    """The f32 kernels at the kernel table's further shapes, L 500, TF32
    off: the forward at N 12288, C 128, k 11 (conv1, conv2 and bias-only
    forms) and bias-only at N 1536, k 31 (weights too large to stay
    resident), the data gradient at N 1536, C 128, k 11, and conv_wgrad
    with a random in_mask at N 1536, k 5, C 16 / 48 / 96; each held
    against its plain version at F32_TOL (conv_wgrad also the same bits
    run to run) and timed beside the plain version, the library call and
    the bound at the card's f32 peak."""
    import torch

    from jaeger_tpu_torch.ops import fused_conv
    from jaeger_tpu_torch.ops import fused_conv_grad as fg

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(1818)
    f32 = torch.float32
    length = FLAG_L
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    saved = (dict(fg.launches), fused_conv.launches,
             dict(fused_conv.route_launches), dict(fg.wgrad_route_launches))
    tf32_off()
    out = {}

    def close(name, got, ref):
        err = (got - ref).abs()
        bad = (err > F32_TOL + F32_TOL * ref.abs()).sum().item()
        max_err = err.max().item()
        ok = bad == 0 and math.isfinite(max_err)
        print(f"kernel f32 {name}: max_abs_err {max_err:.3e} (tol {F32_TOL}) "
              f"{'ok' if ok else 'FAIL'}")
        check(ok, f"f32 {name}: {bad} elements beyond tolerance")
        return max_err

    for name, op, n, c, k in F32_SHAPES:
        flops = 2.0 * n * length * c * c * k
        if op == "forward":
            x, w, bias, dyt = _conv_inputs(gen, n, length, c, k, f32, dev)
            res = (torch.randn(n, length, c, generator=gen).to(dev)
                   if k == 11 else None)
            plan = fused_conv.conv_plan(c, k, f32)
            forms = {"bias_only": ((bias, None), "none", None)}
            if res is not None:
                forms = {"conv1": ((bias, dyt), "gelu", None),
                         "conv2": ((bias, dyt), "gelu", res), **forms}
            for form, ((b, d), act, r) in forms.items():
                kw = dict(use_dyt=d is not None, bias_then_dyt=d is not None,
                          residual=r)
                ref = fused_conv.reference_conv_block(x, w, b, d, act, **kw)
                err = close(f"{name} {form} N={n} C={c} k={k} "
                            f"[{plan['route']}]",
                            fused_conv.fused_conv_block(x, w, b, d, act, **kw),
                            ref)
                del ref
                nbytes = (4 * n * length * c * (3 if r is not None else 2)
                          + 4 * k * c * c + 4 * c * (4 if d is not None else 1))
                bound, by = _bound(flops, nbytes, PEAK_F32_FLOPS)
                t = dict(
                    ms=cuda_ms(lambda: fused_conv.fused_conv_block(
                        x, w, b, d, act, **kw), iters=5, warmup=1),
                    route=plan["route"], plan=plan,
                    plain_ms=cuda_ms(lambda: fused_conv.reference_conv_block(
                        x, w, b, d, act, **kw), iters=2, warmup=1),
                    library_ms=cuda_ms(lambda: library_conv_block(
                        x, w, b, d, act, r), iters=3, warmup=1),
                    bound_ms=bound, bound_by=by, flops=flops, bytes=nbytes,
                    max_abs_err=err)
                out[f"{name}_{form}"] = t
                _print_timing(f"f32 {name} {form} N={n} L={length} C={c} "
                              f"k={k}", t, card)
            del x, w, res
        elif op == "dgrad":
            du = (torch.randn(n, length, c, generator=gen) * 0.1).to(dev)
            w = (torch.randn(k, c, c, generator=gen) * 0.05).to(dev)
            im = (torch.rand(n, length, generator=gen) > 0.2).to(dev)
            wf = fg.flipped_weights(w)
            plan = fused_conv.conv_plan(c, k, f32)
            ref = fused_conv.reference_conv_block(du, wf, out_mask=im)
            err = close(f"{name} N={n} C={c} k={k} [{plan['route']}]",
                        fused_conv.fused_conv_block(du, wf, out_mask=im), ref)
            del ref
            du_ncl = du.transpose(1, 2).contiguous()
            nbytes = 4 * 2 * n * length * c + 4 * k * c * c + n * length
            bound, by = _bound(flops, nbytes, PEAK_F32_FLOPS)
            t = dict(
                ms=cuda_ms(lambda: fused_conv.fused_conv_block(
                    du, wf, out_mask=im), iters=10),
                route=plan["route"], plan=plan,
                plain_ms=cuda_ms(lambda: fused_conv.reference_conv_block(
                    du, wf, out_mask=im), iters=3, warmup=1),
                library_ms=cuda_ms(lambda: torch.nn.grad.conv1d_input(
                    (n, c, length), w.permute(2, 1, 0), du_ncl,
                    padding=(k - 1) // 2), iters=5),
                bound_ms=bound, bound_by=by, flops=flops, bytes=nbytes,
                max_abs_err=err)
            out[name] = t
            _print_timing(f"f32 {name} N={n} L={length} C={c} k={k}", t,
                          card)
            del du, w, wf, im, du_ncl
        else:
            x = torch.randn(n, length, c, generator=gen).to(dev)
            du = (torch.randn(n, length, c, generator=gen) * 0.1).to(dev)
            im = (torch.rand(n, length, generator=gen) > 0.2).to(dev)
            plan = fg.wgrad_plan(n, length, c, k, f32, sms)
            dw, db = fg.conv_wgrad(x, du, im, k)
            again = fg.conv_wgrad(x, du, im, k)
            check(torch.equal(again[0], dw) and torch.equal(again[1], db),
                  f"conv_wgrad {name}: not the same bits run to run")
            rdw, rdb = fg.reference_conv_wgrad(x, du, im, k)
            err = _check_close(
                f"conv_wgrad f32 {name} N={n} C={c} k={k} mask=random "
                f"[{plan['route']} groups={plan['groups']}x{plan['group']} "
                f"block={plan['co_block']}]",
                {"dW": (dw, rdw), "db": (db, rdb)}, F32_TOL)
            del dw, db, again, rdw, rdb
            x_ncl = x.transpose(1, 2).contiguous()
            du_ncl = du.transpose(1, 2).contiguous()
            nbytes = 4 * 2 * n * length * c + n * length + 4 * (k * c * c + c)
            bound, by = _bound(flops, nbytes, PEAK_F32_FLOPS)
            t = dict(
                ms=cuda_ms(lambda: fg.conv_wgrad(x, du, im, k), iters=10,
                           warmup=1),
                route=plan["route"], plan=plan,
                plain_ms=cuda_ms(lambda: fg.reference_conv_wgrad(
                    x, du, im, k), iters=3, warmup=1),
                library_ms=cuda_ms(lambda: torch.nn.grad.conv1d_weight(
                    x_ncl, (c, c, k), du_ncl, padding=(k - 1) // 2),
                    iters=10),
                bound_ms=bound, bound_by=by, flops=flops, bytes=nbytes,
                max_abs_err=err)
            out[name] = t
            _print_timing(f"f32 {name} N={n} L={length} C={c} k={k}", t,
                          card)
            del x, du, im, x_ncl, du_ncl
    # checks and timings are not the main path
    fg.launches.update(saved[0])
    fused_conv.launches = saved[1]
    for counter, before in ((fused_conv.route_launches, saved[2]),
                            (fg.wgrad_route_launches, saved[3])):
        counter.clear()
        counter.update(before)
    return out


def phase_f32_sweep(card: str) -> None:
    """``--f32 --sweep``: the f32 ring kernels under other launch plans:
    the forward's column block and ring stages (bias-only form at the
    flagship shape) and with fewer taps (k 1, 3: 1/5 and 3/5 of the
    products over the same bytes); past 9 taps (bias-only, N 1536, C 128,
    k 11 / 23 / 31) every resident and streamed plan that fits;
    conv_wgrad's ring stages and fewer row shares at the train shape and
    at C 96 / 48 / 16."""
    import torch

    from jaeger_tpu_torch.ops import fused_conv
    from jaeger_tpu_torch.ops import fused_conv_grad as fg

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(77)
    f32 = torch.float32
    saved = (fused_conv.launches, dict(fused_conv.route_launches),
             dict(fg.launches), dict(fg.wgrad_route_launches))
    n, length, c = FLAG_N, FLAG_L, FLAG_C
    for k in (5, 3, 1):
        x, w, bias, _ = _conv_inputs(gen, n, length, c, k, f32, dev)
        for cb in ((64, 32, 16) if k == 5 else (64,)):
            for stages in (4, 3, 2):
                smem = fused_conv.f32_plan_bytes(c, k, cb, stages)
                if smem > fused_conv.SMEM_LIMIT:
                    continue
                plan = dict(route="f32_ring", cb=cb, kw=0,
                            tile=fused_conv.F32_TILE, taps=k, stages=stages,
                            smem=smem)
                ms = cuda_ms(lambda: fused_conv._launch(
                    x, w, bias, None, "none", None, None, None, plan),
                    iters=10)
                bound = 2.0 * n * length * c * c * k / PEAK_F32_FLOPS * 1e3
                print(f"sweep f32 k={k} cb={cb} stages={stages} bias_only on "
                      f"{card}: {ms:.3f} ms (products at the f32 peak "
                      f"{bound:.3f} ms, {bound / ms:.1%})")
        del x, w
    n = TRAIN_N
    for k in (11, 23, 31):
        x, w, bias, _ = _conv_inputs(gen, n, length, c, k, f32, dev)
        plans = [(cb, k, st) for cb in (64, 32, 16) for st in (4, 3, 2)]
        plans += [(cb, taps, 2) for cb in (64, 32, 16)
                  for taps in range(1, min(k - 1, 9) + 1)
                  if fused_conv.f32_tap_blocks(k, taps)[1] == taps]
        for cb, taps, stages in plans:
            smem = fused_conv.f32_plan_bytes(c, k, cb, stages, taps)
            if smem > fused_conv.SMEM_LIMIT:
                continue
            plan = dict(route="f32_ring", cb=cb, kw=0,
                        tile=fused_conv.F32_TILE, taps=taps, stages=stages,
                        smem=smem)
            ms = cuda_ms(lambda: fused_conv._launch(
                x, w, bias, None, "none", None, None, None, plan), iters=5)
            bound = 2.0 * n * length * c * c * k / PEAK_F32_FLOPS * 1e3
            print(f"sweep f32 N={n} k={k} cb={cb} taps={taps} "
                  f"stages={stages} bias_only on {card}: {ms:.3f} ms "
                  f"({bound / ms:.1%} of the products at the f32 peak)")
        del x, w
    n, length, c, k = TRAIN_N, TRAIN_L, TRAIN_C, TRAIN_K
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for c in (c, 96, 48, 16):
        x = torch.randn(n, length, c, generator=gen).to(dev)
        du = torch.randn(n, length, c, generator=gen).to(dev)
        im = (torch.rand(n, length, generator=gen) > 0.2).to(dev)
        for stages in (2, 3, 4):
            plan = fg.wgrad_plan(n, length, c, k, f32, sms, stages)
            for mname, m in (("none", None), ("random", im)):
                ms = cuda_ms(lambda: fg.conv_wgrad(x, du, m, k, plan=plan),
                             iters=10)
                print(f"sweep f32 conv_wgrad C={c} stages={stages} "
                      f"in_mask={mname} on {card}: {ms:.3f} ms")
        # fewer row shares: a shorter second pass, fewer CTAs
        plan = fg.wgrad_plan(n, length, c, k, f32, sms)
        for div in (2, 4, 8):
            groups = max(1, plan["groups"] // div)
            p2 = dict(plan, groups=groups, ctas=groups * plan["group"])
            ms = cuda_ms(lambda: fg.conv_wgrad(x, du, im, k, plan=p2),
                         iters=10)
            print(f"sweep f32 conv_wgrad C={c} groups={groups} "
                  f"in_mask=random on {card}: {ms:.3f} ms")
        del x, du, im
    fused_conv.launches = saved[0]
    fg.launches.update(saved[2])
    for counter, before in ((fused_conv.route_launches, saved[1]),
                            (fg.wgrad_route_launches, saved[3])):
        counter.clear()
        counter.update(before)


def shifted_copies(q, k: int, dilation: int):
    """(k, N * L, C): the SAME-padded int8 input (N, L, C) shifted by each
    tap, as contiguous copies."""
    import torch
    import torch.nn.functional as F

    n, length, c = q.shape
    span = dilation * (k - 1)
    qp = F.pad(q, (0, 0, span // 2, span - span // 2))
    return torch.stack([qp[:, j * dilation:j * dilation + length]
                        for j in range(k)]).view(k, n * length, c)


def library_int8_conv(shifted, w):
    """Yardstick only: k cuBLASLt int8 GEMMs (``torch._int_mm``) on
    shifted copies; int32 sums (N * L, C_out)."""
    import torch

    acc = None
    for j in range(w.shape[0]):
        y = torch._int_mm(shifted[j], w[j])
        acc = y if acc is None else acc.add_(y)
    return acc


def _int8_dequant_inputs(gen, n, length, c_in, c_out, k, dtype, device):
    """x, w (int8), inv_act, dq, bias, dyt with the calibrated scales'
    shapes: act_scale = absmax / 127, per-channel w_scale."""
    import torch

    x = torch.randn(n, length, c_in, generator=gen).to(device, dtype)
    w = torch.randint(-127, 128, (k, c_in, c_out), generator=gen,
                      dtype=torch.int8).to(device)
    act_scale = x.float().abs().max() / 127.0
    w_scale = (torch.rand(c_out, generator=gen) * 0.002 + 1e-4).to(device)
    dq = w_scale * act_scale
    inv_act = (1.0 / act_scale).reshape(1)
    bias = torch.randn(c_out, generator=gen).to(device)
    dyt = torch.stack([torch.full((c_out,), 0.5),
                       torch.randn(c_out, generator=gen),
                       torch.randn(c_out, generator=gen)]).to(device)
    return x, w, inv_act, dq, bias, dyt


def _int8_ext_args(gen, ext, n, length, l_out, c_out, dt, dyt, device):
    """Keyword arguments of one int8 dequant extension case."""
    import torch

    kw = {}
    if ext in ("bias_then_dyt", "out_mask", "residual", "all", "model",
               "in_mask_runs", "out_mask_residual"):
        kw.update(dyt=dyt, use_dyt=True, bias_then_dyt=True)
    if ext in ("in_mask", "all", "model"):
        kw["in_mask"] = (torch.rand(n, length, generator=gen) > 0.2).to(device)
    if ext == "in_mask_runs":
        # masked runs across the 64-row tile edges and into the halo at
        # both ends of each row
        m = torch.ones(n, length, dtype=torch.bool)
        for lo, hi in ((0, 3), (60, 69), (125, 131), (length - 3, length)):
            m[:, max(lo, 0):min(hi, length)] = False
        kw["in_mask"] = m.to(device)
    if ext in ("out_mask", "all", "model", "out_mask_residual"):
        kw["out_mask"] = (torch.rand(n, l_out, generator=gen) > 0.2).to(device)
    if ext in ("residual", "all", "model", "out_mask_residual"):
        kw["residual"] = torch.randn(n, l_out, c_out, generator=gen).to(
            device, dt)
    return kw


def _misaligned(t):
    """``t``'s values in a contiguous view one element past the start of
    a larger buffer (so its base is not 16-byte aligned)."""
    import torch

    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    return view


def _plan_tag(plan: dict) -> str:
    ragged = (f" wgs={plan['wgs']} ring={plan['ring']}"
              if plan["route"] == "ragged" else "")
    return (f"{plan['route']} cb={plan['cb']} kw={plan['kw']} "
            f"stages={plan['stages']}{ragged} smem={plan['smem']}")


def phase_int8_kernel(card: str) -> dict:
    """int8_conv against its plain versions: the requant form equal, the
    dequant form within F32_TOL / BF16_TOL, on both routes of the plan;
    then times."""
    import torch

    from jaeger_tpu_torch.ops import int8_conv

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(4321)
    f32, bf16, i8 = torch.float32, torch.bfloat16, torch.int8

    # the main path's shapes take the wgmma route
    for shape in ((128, 128, 5, 1, "same", bf16), (32, 32, 3, 1, "same", bf16),
                  (128, 128, 5, 3, "same", i8)):
        plan = int8_conv.int8_plan(*shape)
        print(f"int8 plan {shape[:5]} {str(shape[5])[6:]}: {_plan_tag(plan)}")
        check(plan["route"] == "wgmma", f"int8 plan {shape}: {plan}")

    # requant: the Pallas parity case and the Pallas chip shape, then the
    # wgmma kernel's edges (L 1 / 63 / 65, N 1, C 32 / 64 / 256, C_in !=
    # C_out, k 1 / 3 / 7, CB < C_out) and a C_in = 16 shape on the mma
    # route; all equal
    scale = torch.full((1,), 1.0 / 64.0, device=dev)
    # (name, n, length, c_in, c_out, k, dilation, x range)
    requant_cases = [
        ("pallas_parity", 8, 500, 128, 128, 5, 3, 40),
        ("pallas_chip_shape", 12288, 500, 128, 128, 5, 3, 64),
        ("edge_L1", 4, 1, 128, 128, 5, 3, 64),
        ("edge_L63", 3, 63, 128, 128, 5, 3, 64),
        ("edge_L65", 3, 65, 128, 128, 5, 3, 64),
        ("edge_N1", 1, 500, 128, 128, 5, 3, 64),
        ("edge_C32_k3", 6, 300, 32, 32, 3, 1, 64),
        ("edge_C64_k3", 6, 300, 64, 64, 3, 1, 64),
        ("edge_C256_k5", 6, 300, 256, 256, 5, 1, 64),
        ("edge_C64_to_128", 6, 300, 64, 128, 5, 1, 64),
        ("edge_C128_to_48", 6, 300, 128, 48, 3, 3, 64),
        ("edge_k1", 6, 300, 128, 128, 1, 1, 64),
        ("edge_k3", 6, 300, 128, 128, 3, 1, 64),
        ("edge_k7", 6, 300, 128, 128, 7, 1, 64),
        ("mma_C16", 6, 300, 16, 32, 3, 3, 64),
    ]
    for name, n, length, c_in, c_out, k, dil, hi in requant_cases:
        x = torch.randint(-hi, hi, (n, length, c_in), generator=gen,
                          dtype=i8).to(dev)
        w = torch.randint(-8, 8, (k, c_in, c_out), generator=gen,
                          dtype=i8).to(dev)
        plan = int8_conv.int8_plan(c_in, c_out, k, dil, "same", i8)
        before = int8_conv.launches
        out = int8_conv.int8_conv_requant(x, w, scale, dilation=dil)
        torch.cuda.synchronize()
        check(int8_conv.launches == before + 1, f"{name}: kernel not launched")
        ref = int8_conv.reference_int8_conv_requant(x, w, scale, dilation=dil)
        diff = (out.int() - ref.int()).abs().max().item()
        print(f"int8 requant {name} N={n} L={length} C={c_in}->{c_out} k={k} "
              f"d={dil} [{_plan_tag(plan)}]: max |diff| {diff} "
              f"{'ok' if diff == 0 else 'FAIL'}")
        check(out.dtype == i8 and out.shape == ref.shape and diff == 0,
              f"{name}: requant differs from the plain version by {diff}")
        if name == "pallas_chip_shape":
            requant_x, requant_w = x, w
        del x, w, out, ref

    # dequant: each extension, the demo shape, the flagship shape,
    # dilation, then the wgmma kernel's edges in bf16 and f32 cases on the
    # mma route
    # (name, n, length, c_in, c_out, k, dilation, padding, dtype, act, ext)
    cases = []
    for dt, act in ((f32, "gelu"), (bf16, "gelu_tanh")):
        for ext in ("bias", "bias_then_dyt", "in_mask", "out_mask",
                    "residual", "all"):
            cases.append((f"{ext}_{str(dt)[6:]}", 6, 300, 128, 128, 5, 1,
                          "same", dt, act, ext))
    cases += [
        ("demo_shape_bf16", 96 * 6, 165, 32, 32, 3, 1, "same", bf16, "none",
         "in_mask"),
        ("flagship_shape_bf16", 6 * 256, 500, 128, 128, 5, 1, "same", bf16,
         "gelu_tanh", "model"),
        ("flagship_shape_f32", 6 * 32, 500, 128, 128, 5, 1, "same", f32,
         "gelu", "model"),
        ("dilation3_same_f32", 12, 62, 16, 32, 3, 3, "same", f32, "gelu",
         "in_mask"),
        ("dilation3_valid_bf16", 12, 62, 32, 48, 5, 3, "valid", bf16, "relu",
         "bias"),
        ("dilation3_flagship_bf16", 6 * 64, 500, 128, 128, 5, 3, "same", bf16,
         "none", "bias"),
        # the wgmma kernel's edges: 64-row tiles, the TMA halo, the s8
        # chunk widths (C_in 32 / 64 / 128 / 256: 32-, 64- and 128-byte
        # swizzles) and column blocks (CB < C_out), dilation in both
        # paddings, every activation
        ("edge_L1", 4, 1, 128, 128, 5, 1, "same", bf16, "gelu_tanh", "model"),
        ("edge_L63", 3, 63, 128, 128, 5, 1, "same", bf16, "gelu_tanh",
         "model"),
        ("edge_L65", 3, 65, 128, 128, 5, 1, "same", bf16, "gelu_tanh",
         "model"),
        ("edge_N1", 1, 500, 128, 128, 5, 1, "same", bf16, "gelu_tanh",
         "model"),
        ("edge_C32_k3", 6, 300, 32, 32, 3, 1, "same", bf16, "gelu_tanh",
         "all"),
        ("edge_C64_k3", 6, 300, 64, 64, 3, 1, "same", bf16, "gelu_tanh",
         "model"),
        ("edge_C256_k5", 6, 300, 256, 256, 5, 1, "same", bf16, "gelu_tanh",
         "model"),
        ("edge_C64_to_128", 6, 300, 64, 128, 5, 1, "same", bf16, "gelu_tanh",
         "all"),
        ("edge_C128_to_64", 6, 300, 128, 64, 5, 1, "same", bf16, "gelu_tanh",
         "all"),
        ("edge_k1", 6, 300, 128, 128, 1, 1, "same", bf16, "gelu_tanh",
         "model"),
        ("edge_k3", 6, 300, 128, 128, 3, 1, "same", bf16, "gelu_tanh",
         "model"),
        ("edge_k7", 6, 300, 128, 128, 7, 1, "same", bf16, "gelu_tanh",
         "model"),
        ("edge_d3_same", 6, 300, 128, 128, 5, 3, "same", bf16, "gelu_tanh",
         "model"),
        ("edge_d3_valid", 6, 300, 128, 128, 5, 3, "valid", bf16, "gelu_tanh",
         "all"),
        ("edge_in_mask_runs", 6, 300, 128, 128, 5, 1, "same", bf16,
         "gelu_tanh", "in_mask_runs"),
        ("edge_in_mask_runs_d3", 6, 300, 64, 64, 5, 3, "same", bf16,
         "gelu_tanh", "in_mask_runs"),
        ("edge_out_mask_residual", 6, 300, 128, 128, 5, 1, "same", bf16,
         "gelu_tanh", "out_mask_residual"),
        ("edge_act_none", 6, 130, 128, 128, 3, 1, "same", bf16, "none",
         "all"),
        ("edge_act_tanh", 6, 130, 128, 128, 3, 1, "same", bf16, "tanh",
         "all"),
        ("edge_act_gelu_erf", 6, 130, 128, 128, 3, 1, "same", bf16, "gelu",
         "all"),
        ("edge_act_relu", 6, 130, 128, 128, 3, 1, "same", bf16, "relu",
         "bias"),
        ("mma_f32_L65", 3, 65, 128, 128, 5, 1, "same", f32, "gelu_tanh",
         "model"),
        ("mma_f32_d3_valid", 6, 300, 64, 64, 5, 3, "valid", f32, "gelu",
         "all"),
        ("mma_C16_bf16", 6, 300, 16, 32, 3, 1, "same", bf16, "gelu_tanh",
         "model"),
    ]
    worst = 0.0
    for name, n, length, c_in, c_out, k, dil, pad, dt, act, ext in cases:
        x, w, inv_act, dq, bias, dyt = _int8_dequant_inputs(
            gen, n, length, c_in, c_out, k, dt, dev)
        l_out = int8_conv.conv_geometry(length, k, dil, pad)[0]
        kw = dict(bias=bias, dilation=dil, padding=pad, act=act)
        kw.update(_int8_ext_args(gen, ext, n, length, l_out, c_out, dt, dyt,
                                 dev))
        plan = int8_conv.int8_plan(c_in, c_out, k, dil, pad, dt)
        before = int8_conv.launches
        out = int8_conv.int8_conv_dequant(x, w, inv_act, dq, **kw)
        torch.cuda.synchronize()
        check(int8_conv.launches == before + 1, f"{name}: kernel not launched")
        ref = int8_conv.reference_int8_conv_dequant(x, w, inv_act, dq, **kw)
        check(out.dtype == dt and out.shape == ref.shape,
              f"{name}: output {out.dtype} {tuple(out.shape)}")
        err = (out.float() - ref.float()).abs()
        tol = F32_TOL if dt == f32 else BF16_TOL
        bad = (err > tol + tol * ref.float().abs()).sum().item()
        max_err = err.max().item()
        print(f"int8 dequant {name} [{_plan_tag(plan)}]: max_abs_err "
              f"{max_err:.3e} (tol {tol}) "
              f"{'ok' if bad == 0 and math.isfinite(max_err) else 'FAIL'}")
        check(bad == 0 and math.isfinite(max_err),
              f"{name}: {bad} elements beyond tolerance")
        if "out_mask" in kw and "residual" not in kw:
            check(bool((out[~kw["out_mask"]] == 0).all()),
                  f"{name}: out_mask positions not zero")
        if name == "flagship_shape_bf16":
            worst = max_err
        del x, w, out, ref, err

    times = {}
    # requant at the Pallas chip shape
    x, w = requant_x, requant_w
    n, length, c = x.shape
    k, dil = w.shape[0], 3
    shifted = shifted_copies(x, k, dil)       # made before timing

    def lib_requant():
        acc = library_int8_conv(shifted, w)
        return torch.clamp(torch.round(acc.float() * scale), -127,
                           127).to(i8)

    check(torch.equal(lib_requant().view(x.shape),
                      int8_conv.int8_conv_requant(x, w, scale, dil)),
          "requant library yardstick differs from the kernel")
    launches_before = int8_conv.launches
    ops = 2.0 * n * length * c * c * k
    nbytes = 2 * n * length * c + k * c * c + 4
    t_ops = ops / PEAK_INT8_OPS * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    times["requant"] = dict(
        ms=cuda_ms(lambda: int8_conv.int8_conv_requant(x, w, scale, dil),
                   iters=20),
        plain_ms=cuda_ms(lambda: int8_conv.reference_int8_conv_requant(
            x, w, scale, dil), iters=2, warmup=1),
        library_ms=cuda_ms(lib_requant, iters=5),
        bound_ms=max(t_ops, t_bytes),
        bound_by="operations" if t_ops >= t_bytes else "bytes")
    del x, w, shifted, requant_x, requant_w

    # dequant at the flagship shape, bf16: conv1 and conv2 forms, and the
    # products with a bias add only (conv1 minus this is the cost of the
    # DYT + gelu_tanh epilogue)
    n, length, c, k = 6 * 2048, 500, 128, 5
    x, w, inv_act, dq, bias, dyt = _int8_dequant_inputs(
        gen, n, length, c, c, k, bf16, dev)
    res = torch.randn(n, length, c, generator=gen).to(dev, bf16)
    dyt_kw = dict(bias=bias, dyt=dyt, use_dyt=True, bias_then_dyt=True)
    forms = {
        "conv1": (dyt_kw, "gelu_tanh"),
        "conv2": (dict(dyt_kw, residual=res), "gelu_tanh"),
        "bias_only": (dict(bias=bias), "none"),
    }

    def lib_dequant(kw, act):
        q = int8_conv.quantize_activation(x, inv_act).to(i8)
        acc = library_int8_conv(shifted_copies(q, k, 1), w)
        y = acc.view(n, length, -1).float() * dq + bias
        if "dyt" in kw:
            y = torch.tanh(y * dyt[0]) * dyt[1] + dyt[2]
        if "residual" in kw:
            y = y + kw["residual"].float()
        if act == "gelu_tanh":
            y = torch.nn.functional.gelu(y, approximate="tanh")
        return y.to(bf16)

    for form, (kw, act) in forms.items():
        ops = 2.0 * n * length * c * c * k
        nbytes = (2 * n * length * c * (3 if "residual" in kw else 2)
                  + k * c * c + 4 * (6 if "dyt" in kw else 3) * c + 4)
        t_ops = ops / PEAK_INT8_OPS * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        times[form] = dict(
            ms=cuda_ms(lambda: int8_conv.int8_conv_dequant(
                x, w, inv_act, dq, act=act, **kw), iters=20),
            plain_ms=cuda_ms(lambda: int8_conv.reference_int8_conv_dequant(
                x, w, inv_act, dq, act=act, **kw), iters=2, warmup=1),
            library_ms=cuda_ms(lambda: lib_dequant(kw, act), iters=3,
                               warmup=1),
            bound_ms=max(t_ops, t_bytes),
            bound_by="operations" if t_ops >= t_bytes else "bytes")
    int8_conv.launches = launches_before  # timing launches are not the path
    for form, shape in (("requant", "N=12288 L=500 C=128 k=5 d=3 int8"),
                        ("conv1", "N=12288 L=500 C=128 k=5 bf16"),
                        ("conv2", "N=12288 L=500 C=128 k=5 bf16 +residual"),
                        ("bias_only", "N=12288 L=500 C=128 k=5 bf16 bias")):
        t = times[form]
        t["bound_share"] = t["bound_ms"] / t["ms"]
        print(f"timing int8 {form} {shape} on {card}: kernel {t['ms']:.3f} "
              f"ms, plain {t['plain_ms']:.3f} ms, library "
              f"{t['library_ms']:.3f} ms, bound {t['bound_ms']:.3f} ms "
              f"({t['bound_by']}), {t['bound_share']:.1%} of the bound, "
              f"{2.0 * 12288 * 500 * 128 * 128 * 5 / t['ms'] / 1e9:.1f} TOP/s")
    return {"max_abs_err": worst, **times["conv1"],
            "conv2": times["conv2"], "bias_only": times["bias_only"],
            "requant": times["requant"]}


def phase_int8_sweep(card: str) -> None:
    """``--sweep``: int8_conv's wgmma route under other launch plans
    (ring stages, column block) at the flagship dequant shape (bias-only
    and conv1 forms) and the Pallas requant shape, and with fewer taps
    (k = 1, 3: the same bytes, 1/5 and 3/5 of the products)."""
    import torch

    from jaeger_tpu_torch.ops import int8_conv

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(98)
    bf16, i8 = torch.bfloat16, torch.int8
    n, length, c = 6 * 2048, 500, 128
    launches_before = int8_conv.launches
    for k in (5, 3, 1):
        x, w, inv_act, dq, bias, dyt = _int8_dequant_inputs(
            gen, n, length, c, c, k, bf16, dev)
        inv_act = inv_act.reshape(1)
        out = torch.empty_like(x)
        base = int8_conv.int8_plan(c, c, k, 1, "same", bf16)
        plans = [base]
        if k == 5:
            plans += [dict(base, cb=cb, stages=st,
                           smem=int8_conv.wgmma_plan_bytes(
                               c, k, 1, cb, base["kw"], st, bf16))
                      for cb, st in ((128, 2), (128, 3), (128, 5), (64, 4),
                                     (32, 4))]
        for plan in plans:
            if plan["smem"] > int8_conv.SMEM_LIMIT:
                continue
            for form, args in (("bias_only", (bias, None, "none")),
                               ("conv1", (bias, dyt, "gelu_tanh"))):
                b, d, act = args
                ms = cuda_ms(lambda: int8_conv._launch(
                    x, w, dq, inv_act, b, d, None, None, None, out, 1,
                    (k - 1) // 2, act, plan), iters=20)
                bound = 2.0 * n * length * c * c * k / PEAK_INT8_OPS * 1e3
                print(f"sweep int8 dequant k={k} [{_plan_tag(plan)}] {form} "
                      f"on {card}: {ms:.3f} ms (products at the int8 peak "
                      f"{bound:.3f} ms)")
        del x, w, out
    x = torch.randint(-64, 64, (n, length, c), generator=gen, dtype=i8).to(dev)
    scale = torch.full((1,), 1.0 / 64.0, device=dev)
    out = torch.empty_like(x)
    for k, dil in ((5, 3), (5, 1), (3, 1), (1, 1)):
        w = torch.randint(-8, 8, (k, c, c), generator=gen, dtype=i8).to(dev)
        base = int8_conv.int8_plan(c, c, k, dil, "same", i8)
        plans = [(base["cb"], base["stages"])]
        if (k, dil) == (5, 3):
            plans += [(128, 2), (128, 6), (64, 4)]
        for cb, st in plans:
            plan = dict(base, cb=cb, stages=st,
                        smem=int8_conv.wgmma_plan_bytes(
                            c, k, dil, cb, base["kw"], st, i8))
            if plan["smem"] > int8_conv.SMEM_LIMIT:
                continue
            ms = cuda_ms(lambda: int8_conv._launch(
                x, w, scale, None, None, None, None, None, None, out, dil,
                dil * (k - 1) // 2, "none", plan), iters=20)
            bound = 2.0 * n * length * c * c * k / PEAK_INT8_OPS * 1e3
            print(f"sweep int8 requant k={k} d={dil} [{_plan_tag(plan)}] on "
                  f"{card}: {ms:.3f} ms (products at the int8 peak "
                  f"{bound:.3f} ms)")
    int8_conv.launches = launches_before


# --- phase 3b: the fused conv's backward kernels ----------------------------

#: the train shape: batch 256 of the flagship template, six frames
TRAIN_N, TRAIN_L, TRAIN_C, TRAIN_K = 6 * 256, 500, 128, 5


def _scale_err(out, ref) -> tuple[float, float]:
    """(max |out - ref|, max |ref|) in f32."""
    return ((out.float() - ref.float()).abs().max().item(),
            ref.float().abs().max().item())


def _bf16_ulp(v):
    """One bf16 ulp (8 significant bits) at each ``|v|`` (f32)."""
    import torch

    e = torch.frexp(v.abs().clamp_min(2.0 ** -126))[1]
    return torch.exp2((e - 8).float())


def _check_close(name: str, pairs: dict, tol: float, ulps: int = 0) -> float:
    """Every output within ``tol`` of its plain version, relative to the
    plain output's scale (sums over up to N * L rows: elementwise relative
    tolerances do not apply to the near-zero ones). With ``ulps``, a bf16
    output is held element by element: within ``ulps`` bf16 ulps of the
    larger of the two values, plus ``tol`` of the scale. Returns the worst
    absolute error."""
    import torch

    worst = 0.0
    parts = []
    for key, (out, ref) in pairs.items():
        if ref is None:
            check(out is None, f"{name}: {key} expected None")
            continue
        err, scale = _scale_err(out, ref)
        limit = tol * max(scale, 1e-6)
        if ulps and out.dtype == torch.bfloat16:
            o, r = out.float(), ref.float()
            d = (o - r).abs()
            unit = _bf16_ulp(torch.maximum(o.abs(), r.abs()))
            excess = (d - ulps * unit).max().item()
            del o, r, d, unit
            ok = math.isfinite(err) and excess <= limit
            parts.append(f"{key} {err:.2e}/{scale:.2e} (beyond {ulps} ulps: "
                         f"{max(excess, 0.0) / max(scale, 1e-6):.1e} of scale)")
            check(ok, f"{name}: {key} {excess:.3e} beyond {ulps} bf16 ulps "
                  f"+ {tol} x {scale:.3e}")
        else:
            ok = math.isfinite(err) and err <= limit
            parts.append(f"{key} {err:.2e}/{scale:.2e}")
            check(ok, f"{name}: {key} err {err:.3e} beyond {tol} x "
                  f"{scale:.3e}")
        worst = max(worst, err)
    rule = f"{ulps} bf16 ulps + " if ulps else ""
    print(f"train kernel {name}: " + ", ".join(parts) + f" (tol {rule}{tol} "
          f"of scale) ok")
    return worst


def library_epilogue_bwd(dy, u, residual, out_mask, dyt):
    """Yardstick only: the same epilogue in torch ops and autograd's
    backward of it (the graph is built once, the backward timed)."""
    import torch
    import torch.nn.functional as F

    u = u.detach().requires_grad_()
    r = residual.detach().requires_grad_()
    d = dyt.detach().requires_grad_()
    y = torch.tanh(u * d[0].to(u.dtype)) * d[1].to(u.dtype) + d[2].to(u.dtype)
    y = torch.where(out_mask[..., None], y, torch.zeros((), dtype=y.dtype,
                                                        device=y.device))
    y = F.gelu(y + r, approximate="tanh")
    return lambda: torch.autograd.grad(y, (u, r, d), dy, retain_graph=True)


def phase_train_kernel(card: str) -> dict:
    """conv_wgrad, conv_epilogue_bwd and the flipped-weight data gradient
    against their plain versions (bf16 at the train shape, f32 and bf16 at
    small shapes, every form), FusedConvBlockFn's whole backward against
    the plain backward, then each kernel's time with its plain version's,
    the library yardstick's and its bound at the train shape."""
    import torch

    from jaeger_tpu_torch.ops import fused_conv
    from jaeger_tpu_torch.ops import fused_conv_grad as fg

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(2468)
    f32, bf16 = torch.float32, torch.bfloat16
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    worst = {"conv_wgrad": 0.0, "conv_epilogue_bwd": 0.0, "dgrad": 0.0}

    def masks(n, length, kind):
        if kind == "none":
            return None
        if kind == "runs":
            m = torch.ones(n, length, dtype=torch.bool)
            for lo, hi in ((0, 3), (60, 69), (125, 131), (length - 3, length)):
                m[:, max(lo, 0):min(hi, length)] = False
            return m.to(dev)
        return (torch.rand(n, length, generator=gen) > 0.2).to(dev)

    # conv_wgrad: (name, n, length, c, k, dtype, in_mask kind); one tile
    # first (the MN-major B descriptor and the ring on the smallest case)
    for name, n, length, c, k, dt, mk in [
            ("one_tile", 1, 64, 128, 5, bf16, "none"),
            ("one_tile_masked", 1, 64, 128, 5, bf16, "random"),
            ("one_tile_C64_k3", 1, 64, 64, 3, bf16, "none"),
            ("train_shape_bf16", TRAIN_N, TRAIN_L, TRAIN_C, TRAIN_K, bf16,
             "random"),
            ("dense_bf16", 64, 500, 128, 5, bf16, "none"),
            ("f32_C128_k5", 6, 300, 128, 5, f32, "random"),
            ("f32_C16_k3", 12, 100, 16, 3, f32, "runs"),
            ("edge_L1", 4, 1, 128, 5, bf16, "none"),
            ("edge_L63", 3, 63, 128, 5, bf16, "random"),
            ("edge_L65", 3, 65, 128, 5, bf16, "runs"),
            ("edge_C64_k3", 6, 300, 64, 3, bf16, "random"),
            ("edge_C256_k5", 6, 300, 256, 5, bf16, "random"),
            ("edge_L64_k3_runs", 3, 64, 128, 3, bf16, "runs"),
            ("edge_L500_k3", 4, 500, 128, 3, bf16, "random"),
            ("edge_C64_k5_runs", 6, 300, 64, 5, bf16, "runs"),
            ("edge_C256_k3", 6, 300, 256, 3, bf16, "none"),
            ("edge_runs_C128_k5", 6, 300, 128, 5, bf16, "runs")]:
        x = torch.randn(n, length, c, generator=gen).to(dev, dt)
        du = (torch.randn(n, length, c, generator=gen) * 0.1).to(dev, dt)
        im = masks(n, length, mk)
        before = fg.launches["conv_wgrad"]
        dw, db = fg.conv_wgrad(x, du, im, k)
        torch.cuda.synchronize()
        check(fg.launches["conv_wgrad"] == before + 1,
              f"conv_wgrad {name}: kernel not launched")
        rdw, rdb = fg.reference_conv_wgrad(x, du, im, k)
        plan = fg.wgrad_plan(n, length, c, k, dt, sms)
        again = fg.conv_wgrad(x, du, im, k)
        check(torch.equal(again[0], dw) and torch.equal(again[1], db),
              f"conv_wgrad {name}: not the same bits run to run")
        worst["conv_wgrad"] = max(worst["conv_wgrad"], _check_close(
            f"conv_wgrad {name} N={n} L={length} C={c} k={k} "
            f"{str(dt)[6:]} mask={mk} [{plan['route']} groups="
            f"{plan['groups']}x{plan['group']} co_block={plan['co_block']}]",
            {"dW": (dw, rdw), "db": (db, rdb)},
            F32_TOL if dt == f32 else 1e-3))
        del x, du, dw, db, rdw, rdb

    # conv_epilogue_bwd: (name, n, length, c, dtype, act, residual, out
    # mask, DYT): the train shapes, then every activation with and without
    # each of residual, out mask and DYT in both types, at C 16 / 48 / 128 /
    # 256 and row counts that are no multiple of a chunk or of the stages
    epi_cases = [
        ("conv1_train_bf16", TRAIN_N, TRAIN_L, TRAIN_C, bf16, "gelu_tanh",
         False, True, True),
        ("conv2_train_bf16", TRAIN_N, TRAIN_L, TRAIN_C, bf16, "gelu_tanh",
         True, True, True),
        ("conv2_f32_gelu", 6, 300, 128, f32, "gelu", True, True, True),
        ("conv1_f32_relu", 6, 300, 128, f32, "relu", False, True, True),
        ("conv1_f32_tanh", 6, 300, 48, f32, "tanh", False, True, True),
        ("conv2_f32_none", 6, 300, 16, f32, "none", True, True, True),
        ("bias_f32_outmask", 6, 300, 32, f32, "gelu", False, True, False)]
    shapes = ((3, 37, 16), (5, 61, 48), (7, 113, 128), (2, 499, 256))
    i = 0
    for dt in (f32, bf16):
        for act in ("none", "relu", "tanh", "gelu", "gelu_tanh"):
            for has_r in (False, True):
                for has_om in (False, True):
                    for has_dyt in (False, True):
                        n, length, c = shapes[i % len(shapes)]
                        i += 1
                        epi_cases.append((
                            f"form_{str(dt)[6:]}_{act}_r{int(has_r)}"
                            f"_om{int(has_om)}_dyt{int(has_dyt)}", n, length,
                            c, dt, act, has_r, has_om, has_dyt))
    for name, n, length, c, dt, act, has_r, has_om, has_dyt in epi_cases:
        dy = torch.randn(n, length, c, generator=gen).to(dev, dt)
        u = torch.randn(n, length, c, generator=gen).to(dev, dt)
        r = (torch.randn(n, length, c, generator=gen).to(dev, dt)
             if has_r else None)
        om = masks(n, length, "random") if has_om else None
        dyt = None if not has_dyt else torch.stack([
            torch.full((c,), 0.7), torch.randn(c, generator=gen),
            torch.randn(c, generator=gen)]).to(dev)
        before = fg.launches["conv_epilogue_bwd"]
        du, dr, dd = fg.conv_epilogue_bwd(dy, u, r, om, dyt, act)
        torch.cuda.synchronize()
        check(fg.launches["conv_epilogue_bwd"] == before + 1,
              f"conv_epilogue_bwd {name}: kernel not launched")
        again = fg.conv_epilogue_bwd(dy, u, r, om, dyt, act)
        check(all(a is None and b is None or torch.equal(a, b)
                  for a, b in zip(again, (du, dr, dd))),
              f"conv_epilogue_bwd {name}: not the same bits run to run")
        rdu, rdr, rdd = fg.reference_conv_epilogue_bwd(dy, u, r, om, dyt, act)
        plan = fg.epilogue_plan(n * length, c, dt, has_r, sms)
        worst["conv_epilogue_bwd"] = max(
            worst["conv_epilogue_bwd"], _check_close(
                f"conv_epilogue_bwd {name} N={n} L={length} C={c} {act} "
                f"[R={plan['rows_per_chunk']} ctas={plan['ctas']}]",
                {"du": (du, rdu), "dr": (dr, rdr if r is not None else None),
                 "ddyt": (dd, rdd)},
                *((F32_TOL,) if dt == f32 else BF16_KERNEL_TOL)))
        del dy, u, r, du, dr, rdu, rdr, again

    # the data gradient: fused_conv_block with the flipped weights, against
    # its plain version and against autograd of the plain conv
    for name, n, length, c, k, dt, mk in [
            ("train_shape_bf16", TRAIN_N, TRAIN_L, TRAIN_C, TRAIN_K, bf16,
             "random"),
            ("f32_C128_k5", 6, 300, 128, 5, f32, "runs"),
            ("f32_C16_k3", 12, 100, 16, 3, f32, "random"),
            ("bf16_C32_k3", 6, 300, 32, 3, bf16, "random")]:
        du = torch.randn(n, length, c, generator=gen).to(dev, dt)
        w = (torch.randn(k, c, c, generator=gen) * 0.05).to(dev, dt)
        im = masks(n, length, mk)
        before = fused_conv.launches
        dx = fused_conv.fused_conv_block(du, fg.flipped_weights(w),
                                         out_mask=im)
        torch.cuda.synchronize()
        check(fused_conv.launches == before + 1,
              f"dgrad {name}: kernel not launched")
        ref = fused_conv.reference_conv_block(du, fg.flipped_weights(w),
                                              out_mask=im)
        pairs = {"dx": (dx, ref)}
        if dt == f32:
            xv = torch.zeros(n, length, c, device=dev, requires_grad=True)
            y = fused_conv.reference_conv_block(xv, w, in_mask=im)
            pairs["dx_vs_autograd"] = (
                dx, torch.autograd.grad(y, xv, du)[0])
        worst["dgrad"] = max(worst["dgrad"], _check_close(
            f"dgrad {name} N={n} L={length} C={c} k={k} {str(dt)[6:]}",
            pairs, *((F32_TOL,) if dt == f32 else BF16_KERNEL_TOL)))
        del du, w, dx, ref

    # FusedConvBlockFn's whole backward against the plain backward
    n, length, c, k = TRAIN_N, TRAIN_L, TRAIN_C, TRAIN_K
    x = torch.randn(n, length, c, generator=gen).to(dev, bf16)
    w = (torch.randn(k, c, c, generator=gen) * 0.05).to(dev)
    b = torch.randn(c, generator=gen).to(dev)
    dyt = torch.stack([torch.full((c,), 0.7), torch.randn(c, generator=gen),
                       torch.randn(c, generator=gen)]).to(dev)
    r = torch.randn(n, length, c, generator=gen).to(dev, bf16)
    im, om = masks(n, length, "random"), masks(n, length, "random")
    dy = torch.randn(n, length, c, generator=gen).to(dev, bf16)
    for form, kw in (("conv1", dict(dyt=dyt, act="gelu_tanh",
                                    bias_then_dyt=True, in_mask=im,
                                    out_mask=om)),
                     ("conv2", dict(dyt=dyt, act="gelu_tanh",
                                    bias_then_dyt=True, in_mask=im,
                                    out_mask=om, residual=r)),
                     ("bias_only", dict(in_mask=im))):
        got = fg.conv_block_backward(dy, x, w, b, **kw)
        ref = fg.reference_conv_block_backward(dy, x, w, b, **kw)
        _check_close(f"FusedConvBlockFn backward {form} train shape bf16",
                     dict(zip(("dx", "dW", "db", "ddyt", "dr"),
                              zip(got, ref))), *BF16_BACKWARD_TOL)

    # times at the train shape (bf16), each with its bound
    du = (torch.randn(n, length, c, generator=gen) * 0.1).to(dev, bf16)
    wb = w.to(bf16)
    launches_before = dict(fg.launches), fused_conv.launches
    times = {}
    flops = 2.0 * n * length * c * c * k
    # conv_wgrad: x and du in, dW and db out
    x_ncl = x.transpose(1, 2).contiguous()
    du_ncl = du.transpose(1, 2).contiguous()
    nbytes = 2 * 2 * n * length * c + n * length + 4 * (k * c * c + c)
    times["conv_wgrad"] = dict(
        ms=cuda_ms(lambda: fg.conv_wgrad(x, du, im, k), iters=20),
        plain_ms=cuda_ms(lambda: fg.reference_conv_wgrad(x, du, im, k),
                         iters=3, warmup=1),
        library_ms=cuda_ms(lambda: torch.nn.grad.conv1d_weight(
            x_ncl, (c, c, k), du_ncl, padding=(k - 1) // 2), iters=10),
        host_us=host_us(lambda: fg.conv_wgrad(x, du, im, k)),
        flops=flops, bytes=nbytes, plan=fg.wgrad_plan(n, length, c, k, bf16,
                                                      sms))
    del x_ncl
    # conv_epilogue_bwd, conv2 form: dy, u, r, out_mask in; du, dr out
    u = torch.randn(n, length, c, generator=gen).to(dev, bf16)
    lib = library_epilogue_bwd(dy, u, r, om, dyt)
    nbytes = 5 * 2 * n * length * c + n * length + 2 * 12 * c
    times["conv_epilogue_bwd"] = dict(
        ms=cuda_ms(lambda: fg.conv_epilogue_bwd(dy, u, r, om, dyt,
                                                "gelu_tanh"), iters=20),
        plain_ms=cuda_ms(lambda: fg.reference_conv_epilogue_bwd(
            dy, u, r, om, dyt, "gelu_tanh"), iters=3, warmup=1),
        library_ms=cuda_ms(lib, iters=10), flops=0.0, bytes=nbytes,
        host_us=host_us(lambda: fg.conv_epilogue_bwd(dy, u, r, om, dyt,
                                                     "gelu_tanh")),
        plan=fg.epilogue_plan(n * length, c, bf16, True, sms))
    nbytes1 = 3 * 2 * n * length * c + n * length + 2 * 12 * c
    conv1_ms = cuda_ms(lambda: fg.conv_epilogue_bwd(dy, u, None, om, dyt,
                                                    "gelu_tanh"), iters=20)
    del lib
    # the data gradient: du in, dx out, flipped weights
    wf = fg.flipped_weights(wb)
    nbytes = 2 * 2 * n * length * c + 2 * k * c * c + n * length
    times["dgrad"] = dict(
        ms=cuda_ms(lambda: fused_conv.fused_conv_block(du, wf, out_mask=im),
                   iters=20),
        plain_ms=cuda_ms(lambda: fused_conv.reference_conv_block(
            du, wf, out_mask=im), iters=3, warmup=1),
        library_ms=cuda_ms(lambda: torch.nn.grad.conv1d_input(
            (n, c, length), wb.permute(2, 1, 0), du_ncl,
            padding=(k - 1) // 2), iters=10),
        flops=flops, bytes=nbytes)
    fg.launches.update(launches_before[0])
    fused_conv.launches = launches_before[1]
    for key, t in times.items():
        t_ops = t["flops"] / PEAK_BF16_FLOPS * 1e3
        t_bytes = t["bytes"] / HBM_BYTES_PER_S * 1e3
        t.update(bound_ms=max(t_ops, t_bytes), max_abs_err=worst[key],
                 bound_by="operations" if t_ops >= t_bytes else "bytes")
        t["bound_share"] = t["bound_ms"] / t["ms"]
        print(f"timing {key} N={n} L={length} C={c} k={k} bf16 on {card}: "
              f"kernel {t['ms']:.3f} ms, plain {t['plain_ms']:.3f} ms, "
              f"library {t['library_ms']:.3f} ms, bound {t['bound_ms']:.3f} "
              f"ms ({t['bound_by']}: {t['flops']:.3e} FLOP, "
              f"{t['bytes'] / 1e9:.3f} GB), {t['bound_share']:.1%} of the "
              f"bound" + (f"; host {t['host_us']:.1f} us a call"
                          if "host_us" in t else ""))
    times["conv_epilogue_bwd"]["conv1_ms"] = conv1_ms
    times["conv_epilogue_bwd"]["conv1_bound_ms"] = (
        nbytes1 / HBM_BYTES_PER_S * 1e3)
    print(f"timing conv_epilogue_bwd conv1 form on {card}: {conv1_ms:.3f} ms, "
          f"bound {nbytes1 / HBM_BYTES_PER_S * 1e3:.3f} ms (bytes)")
    return times


def phase_train_sweep(card: str) -> None:
    """``--sweep``: conv_wgrad under other ring depths, with and without
    in_mask, and conv_epilogue_bwd with and without the out mask, at the
    train shape; then where each wrapper's host time goes (cProfile over
    100 calls that do not wait for the card)."""
    import cProfile
    import io
    import pstats

    import torch

    from jaeger_tpu_torch.ops import fused_conv_grad as fg

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(97)
    n, length, c, k = TRAIN_N, TRAIN_L, TRAIN_C, TRAIN_K
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    saved = dict(fg.launches)
    x = torch.randn(n, length, c, generator=gen).to(dev, torch.bfloat16)
    du = (torch.randn(n, length, c, generator=gen) * 0.1).to(
        dev, torch.bfloat16)
    im = (torch.rand(n, length, generator=gen) > 0.2).to(dev)
    for stages in (2, 3, 4):
        plan = fg.wgrad_plan(n, length, c, k, torch.bfloat16, sms, stages)
        for mname, m in (("none", None), ("random", im)):
            ms = cuda_ms(lambda: fg.conv_wgrad(x, du, m, k, plan=plan),
                         iters=20)
            print(f"sweep conv_wgrad stages={stages} in_mask={mname} on "
                  f"{card}: {ms:.3f} ms")
    dy, u, r = x, du, torch.randn(n, length, c, generator=gen).to(
        dev, torch.bfloat16)
    dyt = torch.stack([torch.full((c,), 0.7), torch.randn(c, generator=gen),
                       torch.randn(c, generator=gen)]).to(dev)
    for form, res in (("conv2", r), ("conv1", None)):
        for mname, m in (("none", None), ("random", im)):
            ms = cuda_ms(lambda: fg.conv_epilogue_bwd(dy, u, res, m, dyt,
                                                      "gelu_tanh"), iters=20)
            print(f"sweep conv_epilogue_bwd {form} out_mask={mname} on "
                  f"{card}: {ms:.3f} ms")
    # what a plain read/write stream reaches on this card, as a yardstick
    # for the epilogue's bytes: copy (1 read, 1 write) and add (2, 1)
    out = torch.empty_like(dy)
    for name, fn, nbytes in (
            ("copy_", lambda: out.copy_(dy), 2 * dy.numel() * 2),
            ("add", lambda: torch.add(dy, u, out=out), 3 * dy.numel() * 2)):
        ms = cuda_ms(fn, iters=20)
        print(f"sweep stream {name} {nbytes / 1e9:.3f} GB on {card}: "
              f"{ms:.3f} ms, {nbytes / ms / 1e9:.2f} TB/s")
    del out
    print_device_profile(lambda: [fg.conv_wgrad(x, du, im, k)
                                  for _ in range(10)], "conv_wgrad x10", top=3)
    print_device_profile(lambda: [fg.conv_epilogue_bwd(
        dy, u, r, im, dyt, "gelu_tanh") for _ in range(10)],
        "conv_epilogue_bwd conv2 x10", top=3)
    for name, fn in (
            ("conv_wgrad", lambda: fg.conv_wgrad(x, du, im, k)),
            ("conv_epilogue_bwd", lambda: fg.conv_epilogue_bwd(
                dy, u, r, im, dyt, "gelu_tanh"))):
        fn()
        torch.cuda.synchronize()
        prof = cProfile.Profile()
        prof.enable()
        for _ in range(100):
            fn()
        prof.disable()
        torch.cuda.synchronize()
        out = io.StringIO()
        pstats.Stats(prof, stream=out).sort_stats("tottime").print_stats(10)
        print(f"sweep host profile of {name} (100 calls):")
        print("\n".join(line for line in out.getvalue().splitlines()
                        if line.strip())[:3000])
    fg.launches.update(saved)


# --- phase 6: training --------------------------------------------------------

TEMPLATE = ROOT / "train_config" / "fragment_6class_1500bp.yaml"


def narrow_train_config(filters: int = 16,
                        kernel_size: int | None = None) -> dict:
    """The flagship training template cut to C = ``filters`` (16), a
    40-codon crop and narrow heads (phase 6a's card-vs-CPU step), its
    residual blocks' convs at ``kernel_size`` taps where given."""
    from jaeger_tpu_torch.utils.config import load_model_config

    cfg = load_model_config(TEMPLATE)
    m = cfg["model"]
    m["embedding"]["embedding_size"] = 8
    m["string_processor"]["crop_size"] = 40
    for layer in m["representation_learner"]["hidden_layers"]:
        if "filters" in (layer.get("config") or {}):
            layer["config"]["filters"] = filters
        if kernel_size and layer["name"] == "residual_block":
            layer["config"]["kernel_size"] = kernel_size
    m["reliability_model"]["hidden_layers"][0]["config"]["units"] = 8
    return cfg


def _train_batch(rng, crop: int, program: str, n: int, n_classes: int):
    import numpy as np

    bases = rng.integers(0, 4, size=(n, crop)).astype(np.uint8)
    lengths = np.full(n, crop, np.int32)
    if program == "bounded":
        bases[np.arange(n), rng.integers(20, crop - 20, size=n)] = 4
    elif program == "masked":
        bases[0, 20:60] = 4
        lengths[1] = crop // 2
    labels = np.zeros((n, n_classes), np.float32)
    labels[np.arange(n), rng.integers(0, n_classes, size=n)] = 1.0
    return {"bases": bases, "lengths": lengths, "labels": labels}


def phase_train_step_f32(filters: int = 16,
                         kernel_size: int | None = None) -> dict:
    """One f32 train step of the narrow template (``filters`` channels: 16,
    96 and 128, the flagship's width, there with its residual convs at
    ``kernel_size`` 11) on the card against the
    same step on the CPU, in each program (dense, bounded, masked): the
    loss within 1e-5, every gradient leaf within 1e-4 of its scale (a leaf
    below 1e-4 of the largest gradient is rounding noise around an exact
    zero and is held at 1e-4 of the largest), the batch statistics within
    1e-5 of their scale, and the parameters after the AdamW step within
    2e-3 of the update where the gradient is clearly nonzero (|g| > 1e-4
    and > 1e-3 of the leaf's largest; Adam's first step is close to
    lr * sign(g)) and within 2 lr everywhere. TF32 is off for cuDNN and
    cuBLAS (the entry conv and the dense heads). The card's step must
    launch every backward kernel, and its convs take only the f32 routes
    f32_ring and fma_ring, each at least once."""
    import copy

    import numpy as np
    import torch

    from jaeger_tpu_torch.models.artifacts import init_params, load_state
    from jaeger_tpu_torch.models.builder import build_model
    from jaeger_tpu_torch.ops import fused_conv
    from jaeger_tpu_torch.ops import fused_conv_grad as fg
    from jaeger_tpu_torch.train import loop
    from jaeger_tpu_torch.train.optimizers import make_optimizer

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = narrow_train_config(filters, kernel_size)
    label = f"C {filters}" + (f" k {kernel_size}" if kernel_size else "")
    tcfg = cfg["training"]
    lr = float(tcfg["optimizer_params"]["learning_rate"])
    rng = np.random.default_rng(17)
    worst = {}
    routes = collections.Counter()
    launched = collections.Counter()
    for program in ("dense", "bounded", "masked"):
        runs = {}
        batch = None
        for dev in ("cuda", "cpu"):
            model = build_model(copy.deepcopy(cfg))
            load_state(model, init_params(cfg, torch.Generator().manual_seed(
                5)))
            init = {k: v.detach().clone() for k, v in
                    loop.flax_params(model).items()}
            model.to(dev)
            if batch is None:
                batch = _train_batch(rng, model.crop_nt, program, 8, 6)
                if program == "masked" and kernel_size:
                    # wider convs' bounded cuts clear a half-length row's
                    # tail: a shorter row keeps the batch on the masked
                    # program
                    batch["lengths"][1] = model.crop_nt // 8
            tx = make_optimizer(tcfg["optimizer"], tcfg["optimizer_params"])
            state = loop.TrainState.create(model, tx)
            step = loop.make_dispatching_train_step(
                model, loop.StepConfig(
                    loss_name=tcfg["loss_classifier"],
                    loss_params=tcfg["loss_params_classifier"],
                    heads=("prediction",)), dev)
            before = (dict(fg.launches), fused_conv.launches,
                      _route_counts())
            state, metrics = step(state, batch)
            if dev == "cuda":
                torch.cuda.synchronize()
                added = {k: fg.launches[k] - before[0][k] for k in fg.launches}
                added["fused_conv_block"] = fused_conv.launches - before[1]
                check(all(v > 0 for v in added.values()),
                      f"f32 step {program}: launches {added}")
                launched.update(added)
                routes.update(_route_counts())
                routes.subtract(before[2])
            check(step.program_counts == {program: 1},
                  f"f32 step {program}: ran {step.program_counts}")
            runs[dev] = dict(
                loss=float(metrics["loss"]),
                grads={k: v.float().cpu() for k, v in state.grads.items()},
                stats={k: v.cpu() for k, v in model.state_dict().items()
                       if "moving" in k},
                params={k: v.detach().cpu() for k, v in
                        loop.flax_params(model).items()})
        gpu, cpu = runs["cuda"], runs["cpu"]
        check(abs(gpu["loss"] - cpu["loss"]) <= 1e-5 * max(abs(cpu["loss"]),
                                                            1.0),
              f"f32 step {program}: loss {gpu['loss']} vs {cpu['loss']}")
        overall = max(float(g.abs().max()) for g in cpu["grads"].values())
        g_err = 0.0
        for k, g in cpu["grads"].items():
            scale = max(float(g.abs().max()), 1e-12)
            if scale < 1e-4 * overall:
                scale = overall
            e = float((gpu["grads"][k] - g).abs().max()) / scale
            check(e <= 1e-4, f"f32 step {program}: grad {k} rel err {e:.2e}")
            g_err = max(g_err, e)
        for k, s in cpu["stats"].items():
            e = float((gpu["stats"][k] - s).abs().max())
            check(e <= 1e-5 * max(float(s.abs().max()), 1e-6),
                  f"f32 step {program}: {k} err {e:.2e}")
        for k, p in cpu["params"].items():
            g = cpu["grads"][k].abs()
            big = (g > 1e-4) & (g > 1e-3 * float(g.max()))
            du_gpu, du_cpu = gpu["params"][k] - init[k], p - init[k]
            diff = (du_gpu - du_cpu).abs()
            check(bool((diff <= 2 * lr + 1e-7).all()),
                  f"f32 step {program}: {k} update beyond 2 lr")
            check(bool((diff[big] <= 2e-3 * du_cpu[big].abs() + 1e-7).all()),
                  f"f32 step {program}: {k} update beyond 2e-3")
        worst[program] = g_err
        print(f"train step f32 {program} (narrow template, {label}, card "
              f"vs CPU): loss {gpu['loss']:.6f} vs {cpu['loss']:.6f}, worst "
              f"grad err {g_err:.2e} of its scale (tol 1e-4) ok")
    routes = {k: v for k, v in routes.items() if v}
    print(f"train step f32 {label}: launches by route {routes}, by kernel "
          f"{dict(launched)}")
    check(set(routes) == {"fused_conv_block:f32_ring", "conv_wgrad:fma_ring"},
          f"f32 step {label}: routes {routes}")
    return dict(worst, routes=routes, launches=dict(launched))


#: phase 6's f32 steps: (filters, residual-conv taps or None)
F32_STEPS = {"C16": (16, None), "C96": (96, None), "C128_k11": (128, 11)}


def phase_train_steps_f32() -> dict:
    """``phase_train_step_f32`` on each of ``F32_STEPS``: the narrow
    template at C 16 and C 96 (conv_wgrad's blocks of other widths than
    64 and 128) and at the flagship's C 128 with k 11 residual convs
    (fused_conv_block's tap blocks)."""
    return {name: phase_train_step_f32(c, k)
            for name, (c, k) in F32_STEPS.items()}


def write_train_data(root: Path, seed: int, crop_nt: int,
                     n_classes: int = 6, n_rows: int = 8192) -> dict:
    """Synthetic ``label,sequence`` CSVs for a template, made from
    ``seed``: ``n_classes`` classes whose GC content differs (0.2 up in
    steps of 0.12), so the loss can fall. The training file holds a block
    of 16 rows with one interior N each (rows 2048-2063) and a block of 8
    with long N runs or short lengths (rows 3072-3079) amid full-length
    clean rows. Each epoch streams the file from its start through a
    1024-row shuffle buffer, so of an epoch's ten batches of 256 the first
    four take the dense program, the next ones (the first block in the
    buffer) the bounded one and the last two (the second block too) the
    masked one. The reliability files hold ID rows (label 1, the classes'
    composition) and OOD rows (label 0, uniform bases). At the flagship's
    1505 nt crop the runs sit where they always did (the same numbers from
    the same seed)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    acgt = np.array(list("ACGT"))

    def seq(label, length):
        gc = 0.2 + 0.12 * label
        p = [(1 - gc) / 2, gc / 2, gc / 2, (1 - gc) / 2]
        return "".join(acgt[rng.choice(4, size=length, p=p)])

    def write(path, rows):
        path.write_text("".join(f"{lab},{s}\n" for lab, s in rows))
        return str(path)

    length = crop_nt + 95
    edge = min(300, crop_nt // 5)
    run_at, run = min(400, crop_nt // 3), min(300, crop_nt // 5)
    short = min(900, crop_nt * 3 // 5)
    train = []
    for i in range(n_rows):
        lab = int(rng.integers(0, n_classes))
        s = seq(lab, length)
        if 2048 <= i < 2064:        # one N: a short invalid run
            j = int(rng.integers(edge, crop_nt - edge))
            s = s[:j] + "N" + s[j + 1:]
        elif 3072 <= i < 3080:      # long N runs or short rows
            s = (s[:run_at] + "N" * run + s[run_at + run:] if i % 2
                 else s[:short])
        train.append((lab, s))
    val = [(int(lab), seq(int(lab), length))
           for lab in rng.integers(0, n_classes, size=512)]
    rel = [(1, seq(int(rng.integers(0, n_classes)), length)) if i % 2 else
           (0, "".join(acgt[rng.integers(0, 4, size=length)]))
           for i in range(2048)]
    return {"train": write(root / "train.csv", train),
            "val": write(root / "val.csv", val),
            "rel_train": write(root / "rel_train.csv", rel[:1536]),
            "rel_val": write(root / "rel_val.csv", rel[1536:])}


def flagship_train_config(root: Path, data: dict) -> Path:
    """The template with the synthetic data, 3 epochs x 10 classifier steps
    (30), 1 x 4 reliability steps, 2 validation steps and a 1024-row
    shuffle buffer; the model, batch 256, bf16, the optimizer, losses and
    callbacks as the template has them."""
    import yaml

    from jaeger_tpu_torch.utils.config import load_model_config

    cfg = load_model_config(TEMPLATE)
    t = cfg["training"]
    cfg["model"]["string_processor"]["buffer_size"] = 1024
    t.update(classifier_epochs=3, classifier_train_steps=10,
             classifier_validation_steps=2, reliability_epochs=1,
             reliability_train_steps=4, reliability_validation_steps=2)
    classes = ["bacteria", "phage", "eukarya", "archaea", "virus", "plasmid"]
    t["fragment_classifier_data"] = {
        "train": [{"class": classes, "path": [data["train"]],
                   "label": list(range(6))}],
        "validation": [{"class": classes, "path": [data["val"]],
                        "label": list(range(6))}]}
    t["fragment_reliability_data"] = {
        "train": [{"class": ["ood", "id"], "path": [data["rel_train"]],
                   "label": [0, 1]}],
        "validation": [{"class": ["ood", "id"], "path": [data["rel_val"]],
                        "label": [0, 1]}]}
    path = root / "flagship_train.yaml"
    path.write_text(yaml.safe_dump(cfg, sort_keys=False))
    return path


def phase_train_flagship(tmp: Path, card: str) -> dict:
    """The main path of this slice: ``train_fragment_core`` with the
    flagship template at full width (batch 256, bf16) on synthetic data:
    about 30 classifier steps and 4 reliability steps, then the export
    and the int8 bundle. Checks finite, falling losses, all three
    programs, the kernels' launches per dense step, the bundle and its
    int8 bundle; prints steps/s and windows/s per program and the peak
    device memory."""
    import torch

    from jaeger_tpu_torch.commands.train import train_fragment_core
    from jaeger_tpu_torch.models.artifacts import load_model
    from jaeger_tpu_torch.ops import fused_adamw as fa
    from jaeger_tpu_torch.ops import fused_conv
    from jaeger_tpu_torch.ops import fused_conv_grad as fg
    from jaeger_tpu_torch.utils.config import load_model_config

    crop_nt = 1505
    t0 = time.perf_counter()
    data = write_train_data(tmp, seed=20261016, crop_nt=crop_nt)
    cfg_path = flagship_train_config(tmp, data)
    data_s = time.perf_counter() - t0
    out = tmp / "trained"
    torch.cuda.reset_peak_memory_stats()
    # the main path: counts reset just before, read just after
    fused_conv.launches = 0
    for k in fg.launches:
        fg.launches[k] = 0
    fa.launches["fused_adamw"] = 0
    t0 = time.perf_counter()
    results = train_fragment_core(str(cfg_path), str(out))
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = dict(fg.launches, fused_conv_block=fused_conv.launches,
                    fused_adamw=fa.launches["fused_adamw"])
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    hist = results["history"]
    cls = hist["classifier"]
    losses = [h["loss"] for h in cls]
    check(len(cls) == 3 and all(math.isfinite(v) for v in losses),
          f"classifier history {losses}")
    check(losses[-1] < losses[0], f"classifier loss did not fall: {losses}")
    rel = [h["loss"] for h in hist.get("reliability", [])]
    check(len(rel) == 1 and all(math.isfinite(v) for v in rel),
          f"reliability history {rel}")
    progs = results["programs"]["classifier"]
    check(set(progs) == {"dense", "bounded", "masked"}
          and sum(progs.values()) == 30, f"classifier programs {progs}")
    check(all(v > 0 for v in launches.values()), f"launches {launches}")
    # every update of the flagship's 49 leaves: one launch pair
    check(launches["fused_adamw"] % 2 == 0 and launches["fused_adamw"]
          >= 2 * sum(progs.values()), f"fused AdamW launches {launches}")
    for f in ("params.msgpack", "project.yaml", "classes.yaml",
              "history.csv", "checkpoints/classifier/checkpoints.json",
              "int8/params_int8.msgpack"):
        check((out / f).exists(), f"train wrote no {f}")
    check(results.get("int8_path") == str(out / "int8"),
          "train did not write the int8 bundle")
    model8, _, _ = load_model(out / "int8", dtype=torch.bfloat16)
    n8 = sum(1 for m in model8.modules() if getattr(m, "int8", False))
    check(n8 >= 6, f"int8 bundle: {n8} int8 convs")

    # launches of one dense step, counted alone; steady-state step times
    per_step, steady = _step_rates(out, load_model_config(cfg_path), card)
    check(per_step == {"fused_conv_block": 18, "conv_wgrad": 6,
                       "conv_epilogue_bwd": 6},
          f"launches per dense step {per_step}")
    print(f"train flagship template (batch 256, bf16) on {card}: "
          f"{train_s:.1f} s in all (data {data_s:.1f} s), classifier losses "
          + " ".join(f"{v:.4f}" for v in losses)
          + f", reliability loss {rel[0]:.4f}, threshold "
          f"{results.get('reliability_threshold')}, peak device memory "
          f"{peak_gb:.2f} GB, main-path launches {launches}")
    print(f"train programs {progs}; launches per dense step: {per_step}")
    return dict(launches=launches, per_step=per_step, programs=progs,
                steady=steady, losses=losses, peak_gb=peak_gb,
                train_s=train_s, bundle=out)


#: the conv kernels of a train step, by the name the profiler gives them
CONV_KERNELS = ("conv_bf16_wgmma", "wgrad_bf16", "reduce_splits",
                "conv_epilogue_bwd", "reduce_parts")


def _step_rates(bundle: Path, cfg: dict, card: str) -> tuple[dict, dict]:
    """Kernel launches of one dense classifier step of the trained model
    (batch 256, bf16), and each program's steady-state step time (warm,
    then 10 steps that do not wait for the card, on the host clock between
    two synchronizes) beside the host's time for choosing the program
    (``dense_window_batch`` and ``bounded_mask_levels`` on the batch, as
    the dispatcher runs them, overlapped with the previous step's device
    work), and the dense step's device time by kernel and the conv
    kernels' share of it."""
    import numpy as np
    import torch

    from jaeger_tpu_torch.models.artifacts import load_model
    from jaeger_tpu_torch.models.builder import mask_cut_plan
    from jaeger_tpu_torch.ops import fused_conv
    from jaeger_tpu_torch.ops import fused_conv_grad as fg
    from jaeger_tpu_torch.ops.encode import (bounded_mask_levels,
                                             dense_window_batch)
    from jaeger_tpu_torch.train import loop
    from jaeger_tpu_torch.train.optimizers import make_optimizer

    model, _, _ = load_model(bundle, dtype=torch.bfloat16)
    plans = mask_cut_plan(model.config["representation_learner"])
    t = cfg["training"]
    state = loop.TrainState.create(model, make_optimizer(
        t["optimizer"], t["optimizer_params"]))
    step = loop.make_dispatching_train_step(model, loop.StepConfig(
        loss_name=t["loss_classifier"],
        loss_params=t["loss_params_classifier"], heads=("prediction",)),
        "cuda")
    rng = np.random.default_rng(3)
    batches = {p: _train_batch(rng, model.crop_nt, p, 256, 6)
               for p in ("dense", "bounded", "masked")}
    saved = dict(fg.launches), fused_conv.launches
    steady = {}
    for program, batch in batches.items():
        state, _ = step(state, batch)            # warm
        before = dict(fg.launches), fused_conv.launches
        state, _ = step(state, batch)
        if program == "dense":
            got = {k: fg.launches[k] - before[0][k] for k in fg.launches}
            got["fused_conv_block"] = fused_conv.launches - before[1]
        reps = 10
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            state, _ = step(state, batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / reps * 1e3
        t0 = time.perf_counter()
        if not dense_window_batch(batch["bases"], batch["lengths"],
                                  model.crop_nt, model.masking_enabled):
            bounded_mask_levels(batch["bases"], batch["lengths"],
                                model.crop_nt, model.masking_enabled, plans)
        plan_ms = (time.perf_counter() - t0) * 1e3
        # the host's whole share of one step on an idle card: plan, upload
        # and launches, until the call returns (median of 3)
        host = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, _ = step(state, batch)
            host.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        host_ms = sorted(host)[1]
        steady[program] = dict(step_ms=ms, steps_per_s=1e3 / ms,
                               windows_per_s=256 / ms * 1e3,
                               host_plan_ms=plan_ms, host_step_ms=host_ms)
        print(f"train {program} step (batch 256, bf16) on {card}: "
              f"{ms:.2f} ms, {1e3 / ms:.2f} steps/s, {256 / ms * 1e3:.0f} "
              f"windows/s; host {host_ms:.1f} ms a step, of it the plan "
              f"{plan_ms:.1f} ms")
    check(set(step.program_counts) == set(batches),
          f"steady-state programs {step.program_counts}")
    for program, batch in batches.items():
        by_kernel = print_device_profile(lambda: step(state, batch),
                                         f"train {program} step",
                                         top=14 if program == "dense" else 4)
        device_ms = sum(by_kernel.values())
        conv_ms = sum(v for k, v in by_kernel.items()
                      if any(c in k for c in CONV_KERNELS))
        st = steady[program]
        st.update(device_ms=device_ms, conv_kernels_ms=conv_ms,
                  conv_share=conv_ms / device_ms,
                  device_busy=device_ms / st["step_ms"])
        print(f"train {program} step: {device_ms:.2f} ms of device time "
              f"({st['device_busy']:.1%} of the steady step), {conv_ms:.2f} "
              f"ms ({conv_ms / device_ms:.1%}) in the conv kernels (forward, "
              f"recomputed u, data gradient, conv_wgrad, conv_epilogue_bwd)")
    fg.launches.update(saved[0])
    fused_conv.launches = saved[1]
    return got, steady


def phase_train_predict(tmp: Path, bundle: Path) -> dict:
    """``predict`` and ``predict --int8`` with the bundle ``train`` wrote
    (its ``int8`` bundle beside it) on the test contigs."""
    from jaeger_tpu_torch import cli
    from jaeger_tpu_torch.ops import fused_conv, int8_conv

    labels = ["bacteria", "phage", "eukarya", "archaea", "virus", "plasmid"]
    counts = {}
    for name, extra in (("trained", []), ("trained_int8", ["--int8"])):
        f0, i0 = fused_conv.launches, int8_conv.launches
        cli.main(["predict", "-i", str(FASTA), "-o", str(tmp / name), "-m",
                  str(bundle), "--fsize", "1505", "--batch", "256"] + extra)
        counts[name] = (fused_conv.launches - f0, int8_conv.launches - i0)
        _check_tsv(_read_tsv(tmp / name / "test_contigs_default_jaeger.tsv"),
                   labels, f"predict {name}")
    check(counts["trained"][0] > 0 and counts["trained_int8"][1] > 0
          and counts["trained_int8"][0] == 0,
          f"predict on the trained bundle: launches {counts}")
    print(f"predict with the trained bundle: fused_conv_block launches "
          f"{counts['trained'][0]}; --int8: int8_conv launches "
          f"{counts['trained_int8'][1]}")
    return counts


# --- phase 6d --------------------------------------------------------------

#: steps of each fused AdamW check; the learning rate is set after the
#: second
ADAMW_STEPS = 5
#: leaf norms of the checks' gradients: below the clip norm (1.0) and
#: above it
ADAMW_NORMS = {"unclipped": 0.5, "clipped": 4.0}


def _adamw_shapes(name: str) -> dict:
    """The parameter shapes of the flagship or of a template, by flax path."""
    from jaeger_tpu_torch.models.builder import build_model
    from jaeger_tpu_torch.models.flagship import flagship_config
    from jaeger_tpu_torch.train.loop import flax_params
    from jaeger_tpu_torch.utils.config import load_model_config

    cfg = (flagship_config() if name == "flagship" else
           load_model_config(ROOT / "train_config" / ZOO_TEMPLATES[name]))
    return {k: tuple(p.shape) for k, p in flax_params(build_model(cfg)).items()}


def _adamw_grads(gen, shapes: dict, norm: float,
                 frozen: str | None = None) -> list:
    """ADAMW_STEPS gradient dicts on the card: each leaf scaled to ``norm``,
    the leaves under ``frozen`` zero (as the train step gives them)."""
    import torch

    steps = []
    for _ in range(ADAMW_STEPS):
        g = {}
        for k, s in shapes.items():
            x = torch.randn(s, generator=gen, device="cuda")
            g[k] = (torch.zeros_like(x) if frozen and k.startswith(frozen)
                    else x * (norm / x.norm()))
        steps.append(g)
    return steps


def _adamw_run(tx, params: dict, grads: list, fused: bool):
    """ADAMW_STEPS updates of a copy of ``params``: ``apply`` (the fused
    kernels) or the per-leaf update. Returns (params, state, norms)."""
    from jaeger_tpu_torch.train import optimizers as topt

    p = {k: v.clone() for k, v in params.items()}
    state, norms = tx.init(p), []
    for i, g in enumerate(grads):
        if fused:
            state, n = tx.apply(p, g, state)
        else:
            updates, state = tx.update(g, state, p)
            for k in p:
                p[k].add_(updates[k])
            n = topt.global_norm(g)
        norms.append(n)
        if i == 1:
            state = topt.set_learning_rate(state, 5e-4)
    return p, state, norms


def _scale_ulps(a, b) -> float:
    """Largest |a - b| in ulps of b's largest magnitude."""
    import numpy as np

    scale = float(b.abs().max())
    diff = float((a - b).abs().max())
    return diff / float(np.spacing(np.float32(scale))) if scale else diff


def _syncs(fn) -> int:
    """Stream synchronizations ``fn()`` makes (warnings under
    ``torch.cuda.set_sync_debug_mode("warn")``)."""
    import warnings

    import torch

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    # (the mode's own first warning, "Synchronization debug mode is a
    # prototype feature ...", is not a sync)
    where = collections.Counter(
        f"{Path(w.filename).name}:{w.lineno}" for w in seen
        if "called a synchronizing CUDA operation" in str(w.message))
    if where:
        print(f"stream syncs by line: {dict(where.most_common(5))}")
    return sum(where.values())


def phase_fused_adamw(card: str) -> dict:
    """6d: the fused AdamW update against the per-leaf update on the card
    (see the module docstring)."""
    import torch

    from jaeger_tpu_torch.ops import fused_adamw as fa
    from jaeger_tpu_torch.train import optimizers as topt

    tx = topt.make_optimizer("adamw", {"learning_rate": 1e-3,
                                       "weight_decay": 1e-4, "clipnorm": 1.0})
    out = {}
    for name in ("flagship", "axial"):
        shapes = _adamw_shapes(name)
        keys = topt.flax_order(shapes)
        frozen = keys[0].split("/")[0] + "/"
        gen = torch.Generator(device="cuda").manual_seed(20261019)
        params = {k: torch.randn(s, generator=gen, device="cuda") * 0.05
                  for k, s in shapes.items()}
        check(tx.fuses(params), f"{name}: the fused path is not taken")
        sizes = [math.prod(shapes[k]) for k in keys]
        tables = len(fa.leaf_groups(sizes))
        res = dict(leaves=len(keys), params=sum(sizes), tables=tables,
                   frozen=frozen)
        for case, norm in ADAMW_NORMS.items():
            grads = _adamw_grads(gen, shapes, norm, frozen)
            before = fa.launches["fused_adamw"]
            pf, sf, nf = _adamw_run(tx, params, grads, True)
            torch.cuda.synchronize()
            check(fa.launches["fused_adamw"] - before
                  == 2 * tables * ADAMW_STEPS,
                  f"{name}: {fa.launches['fused_adamw'] - before} launches")
            pp, sp, n_plain = _adamw_run(tx, params, grads, False)
            again = _adamw_run(tx, params, grads, True)
            torch.cuda.synchronize()
            rel = max(abs(float(a) / float(b) - 1)
                      for a, b in zip(nf, n_plain))
            same = all(torch.equal(again[0][k], pf[k])
                       and torch.equal(again[1]["mu"][k], sf["mu"][k])
                       and torch.equal(again[1]["nu"][k], sf["nu"][k])
                       for k in keys) and all(
                torch.equal(a, b) for a, b in zip(again[2], nf))
            ulps = {part: max(_scale_ulps(got[k], want[k]) for k in keys)
                    for part, got, want in (("p", pf, pp),
                                            ("mu", sf["mu"], sp["mu"]),
                                            ("nu", sf["nu"], sp["nu"]))}
            bitwise = all(torch.equal(pf[k], pp[k])
                          and torch.equal(sf["mu"][k], sp["mu"][k])
                          and torch.equal(sf["nu"][k], sp["nu"][k])
                          for k in keys)
            res[case] = dict(bitwise=bitwise, scale_ulps=ulps,
                             grad_norm_rel=rel, same_bits_twice=same)
            print(f"fused AdamW {name} ({len(keys)} leaves, {tables} "
                  f"table(s), {res['params']} parameters, {case}): bitwise "
                  f"{bitwise}, ulps of the leaf scale {ulps}, grad_norm "
                  f"{rel:.2e} relative, same bits twice {same}", flush=True)
            check(int(sf["count"]) == ADAMW_STEPS
                  and sf["count"].device.type == "cpu",
                  f"{name}: count {sf['count']}")
            check(list(sf["mu"]) == list(shapes) and list(sf["nu"])
                  == list(shapes), f"{name}: moment keys changed")
            check(rel <= 1e-6, f"{name} {case}: grad_norm off by {rel:.2e}")
            check(same, f"{name} {case}: two runs differ")
            if case == "unclipped":
                check(bitwise, f"{name} unclipped: not bitwise ({ulps})")
            else:
                check(max(ulps.values()) <= 4,
                      f"{name} clipped: {ulps} ulps of the leaf scale")
        out[name] = res

    # the flagship's leaves: device time, host time, syncs
    shapes = _adamw_shapes("flagship")
    gen = torch.Generator(device="cuda").manual_seed(7)
    params = {k: torch.randn(s, generator=gen, device="cuda") * 0.05
              for k, s in shapes.items()}
    grads = _adamw_grads(gen, shapes, ADAMW_NORMS["unclipped"])[0]
    state = tx.init(params)

    def fused():
        tx.apply(params, grads, state)

    def plain():
        updates, _ = tx.update(grads, state, params)
        for k in params:
            params[k].add_(updates[k])
        topt.global_norm(grads)

    n = sum(math.prod(s) for s in shapes.values())
    bound_ms = 28 * n / HBM_BYTES_PER_S * 1e3
    reps = 20
    by_kernel = print_device_profile(
        lambda: [fused() for _ in range(reps)], "fused AdamW x20", top=4)
    kernel_ms = sum(v for k, v in by_kernel.items() if "adamw_" in k) / reps
    fused_host_us = host_us(fused, calls=50)
    plain_ms = cuda_ms(plain, iters=10)
    plain_host_us = host_us(plain, calls=10)
    fused_syncs, plain_syncs = _syncs(fused), _syncs(plain)
    check(fused_syncs == 0, f"the fused update synchronized {fused_syncs} x")
    timing = dict(kernel_ms=kernel_ms, bound_ms=bound_ms,
                  bound_share=bound_ms / kernel_ms if kernel_ms else None,
                  fused_host_us=fused_host_us, plain_ms=plain_ms,
                  plain_host_us=plain_host_us, fused_syncs=fused_syncs,
                  plain_syncs=plain_syncs, params=n)
    print(f"fused AdamW at the flagship's {len(shapes)} leaves ({n} "
          f"parameters) on {card}: kernels {kernel_ms * 1e3:.1f} us a step "
          f"(bound {bound_ms * 1e3:.1f} us, bytes), host {fused_host_us:.0f} "
          f"us a call; per-leaf update {plain_ms:.2f} ms a step, host "
          f"{plain_host_us:.0f} us; stream syncs: fused {fused_syncs}, "
          f"per-leaf {plain_syncs}")
    out["timing"] = timing
    return out


# --- phase 4 ---------------------------------------------------------------

@contextlib.contextmanager
def plain_kernels():
    """Run the model's convs on the kernels' plain versions instead."""
    from jaeger_tpu_torch.models import layers
    from jaeger_tpu_torch.ops import fused_conv, int8_conv

    saved = layers.fused_conv_block, layers.int8_conv_dequant
    layers.fused_conv_block = fused_conv.reference_conv_block
    layers.int8_conv_dequant = int8_conv.reference_int8_conv_dequant
    try:
        yield
    finally:
        layers.fused_conv_block, layers.int8_conv_dequant = saved


def _windows(rng, kind: str, n: int, crop: int):
    import numpy as np

    bases = rng.integers(0, 4, size=(n, crop)).astype(np.uint8)
    lengths = np.full(n, crop, np.int32)
    if kind == "bounded":
        # one interior N in every row: a 1-codon invalid run, cleared by
        # the first residual block (too many rows for the split bucket)
        cols = rng.integers(30, crop - 30, size=n)
        bases[np.arange(n), cols] = 4
    elif kind == "split":
        # 100 rows (<= bs/16) with long N runs or short lengths
        for i in range(0, 100):
            if i % 2:
                bases[i, 200:400] = 4
            else:
                lengths[i] = 900
                bases[i, 900:] = 4
    return bases, lengths


def print_device_profile(fn, label: str, top: int = 8) -> dict:
    """Device time by kernel name over one call of ``fn``, printed; returns
    milliseconds by kernel name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = sorted(prof.key_averages(), key=lambda e: e.self_device_time_total,
                    reverse=True)
    total = sum(e.self_device_time_total for e in events)
    print(f"profile {label}: {total / 1e3:.2f} ms device time in "
          f"{sum(e.count for e in events)} kernels")
    for e in events[:top]:
        share = e.self_device_time_total / max(total, 1e-9)
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms {share:6.1%} "
              f"x{e.count:<4d} {e.key[:100]}")
    return {e.key: e.self_device_time_total / 1e3 for e in events}


def _drive_flagship(model, label: str, per_forward: dict,
                    profile: bool) -> dict:
    """The flagship ``model`` through the engine at batch 2048 on windows
    that select the dense, the bounded and the split programs: kernel
    launches per forward (``per_forward``: launches of each kernel module
    per forward), the forward against the same forward on the plain
    versions (5e-2 of scale), windows/s and the host's planning time."""
    import numpy as np
    import torch

    from jaeger_tpu_torch.infer.engine import InferenceEngine

    bs = 2048
    eng = InferenceEngine(model, batch_size=bs, device="cuda")
    crop = model.crop_nt
    rng = np.random.default_rng(7)
    expect = {"dense": {(bs, "dense")}, "bounded": None,
              "split": {(bs, "dense"), (bs // 16, "masked")}}
    rates = {}
    for kind in ("dense", "bounded", "split"):
        bases, lengths = _windows(rng, kind, bs, crop)
        t0 = time.perf_counter()
        dense, split, cut = eng._plan_batch(bases, lengths, bs)
        plan_ms = (time.perf_counter() - t0) * 1e3
        eng.program_counts.clear()
        before = {mod: mod.launches for mod in per_forward}
        out = eng.predict_windows(bases, lengths)
        torch.cuda.synchronize()
        forwards = sum(eng.program_counts.values())
        ran = set(eng.program_counts)
        if kind == "bounded":
            check(cut is not None and split is None and not dense,
                  f"bounded windows planned as {(dense, split, cut)}")
            expect["bounded"] = {(bs, ("bounded", cut))}
        check(ran == expect[kind], f"{label} {kind}: programs {ran}")
        added = {mod: mod.launches - before[mod] for mod in per_forward}
        for mod, n in per_forward.items():
            check(added[mod] == n * forwards,
                  f"{label} {kind}: {added[mod]} {mod.__name__} launches "
                  f"for {forwards} forwards, expected {n} each")
        for k, v in out.items():
            check(bool(np.isfinite(v).all()) and v.shape[0] == bs,
                  f"{label} {kind}: output {k} {v.shape} not finite")
        # the same forward on the plain versions, on the card
        tb = torch.from_numpy(bases).cuda()
        tl = torch.from_numpy(lengths).cuda()
        prog = dict(assume_dense=dense, mask_layers=None if dense else cut)
        if split is not None:
            prog = dict(assume_dense=False, mask_layers=None)
        with torch.inference_mode():
            a = model(tb, tl, **prog)
            with plain_kernels():
                b = model(tb, tl, **prog)
        errs = {k: (a[k].float() - b[k].float()).abs().max().item()
                for k in a}
        for k in a:
            scale = b[k].float().abs().max().item()
            check(errs[k] <= BF16_TOL * max(scale, 1e-3),
                  f"{label} {kind}: {k} kernel vs plain {errs[k]:.3e} "
                  f"(scale {scale:.3e})")
        # windows/s: the engine (host planning, packing, copies) and the
        # model forward alone
        reps = 5
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            eng.predict_windows(bases, lengths)
        torch.cuda.synchronize()
        eng_rate = reps * bs / (time.perf_counter() - t0)
        with torch.inference_mode():
            fwd_ms = cuda_ms(lambda: model(tb, tl, **prog), iters=5)
            if profile:
                print_device_profile(lambda: model(tb, tl, **prog),
                                     f"{label} {kind} forward")
        rates[kind] = dict(engine_windows_per_s=eng_rate,
                           forward_ms=fwd_ms,
                           forward_windows_per_s=bs / fwd_ms * 1e3,
                           host_plan_ms=plan_ms)
        launched = ", ".join(f"{n} {m.__name__.rsplit('.', 1)[-1]}"
                             for m, n in added.items())
        print(f"{label} {kind}: programs {sorted(map(str, ran))}, "
              f"{launched} launches / {forwards} forwards, kernel vs plain "
              + " ".join(f"{k} {v:.2e}" for k, v in errs.items())
              + f"; engine {eng_rate:.0f} windows/s, forward "
              f"{fwd_ms:.2f} ms ({bs / fwd_ms * 1e3:.0f} windows/s), host "
              f"plan {plan_ms:.1f} ms")
        del tb, tl, a, b
    return rates


def phase_flagship(profile: bool = False) -> dict:
    import torch

    from jaeger_tpu_torch.models.artifacts import init_params, load_state
    from jaeger_tpu_torch.models.builder import build_model
    from jaeger_tpu_torch.models.flagship import flagship_config
    from jaeger_tpu_torch.ops import fused_conv, int8_conv

    cfg = flagship_config()
    model = build_model(cfg, dtype=torch.bfloat16)
    load_state(model, init_params(cfg, torch.Generator().manual_seed(42)))
    return _drive_flagship(model, "flagship", {fused_conv: 6, int8_conv: 0},
                           profile)


def phase_int8_flagship(bundle: Path, profile: bool = False) -> dict:
    """Calibrate the seeded flagship bundle with the port's
    ``quantize_bundle(mode="full_int8")`` on the card (written beside it
    as ``<bundle>_int8``, where ``predict --int8`` finds it), then drive
    its int8 forward: six int8_conv launches and no fused_conv_block
    launch per forward."""
    import torch

    from jaeger_tpu_torch.models.artifacts import load_model
    from jaeger_tpu_torch.models.conversion import (int8_conv_count,
                                                    quantize_bundle)
    from jaeger_tpu_torch.ops import fused_conv, int8_conv

    t0 = time.perf_counter()
    stats = quantize_bundle(bundle, f"{bundle}_int8", mode="full_int8")
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t0
    check(stats["int8_exec_convs"] == 6,
          f"flagship full_int8: {stats['int8_exec_convs']} int8 convs")
    model, _, _ = load_model(f"{bundle}_int8", dtype=torch.bfloat16)
    check(int8_conv_count(model) == 6, "flagship int8 model: not 6 convs")
    print(f"quantize flagship full_int8 on the card: {stats} in "
          f"{quant_s:.1f} s")
    rates = _drive_flagship(model, "flagship int8",
                            {int8_conv: 6, fused_conv: 0}, profile)
    rates["quantize_s"] = quant_s
    return rates


# --- phase 5 ---------------------------------------------------------------

def _read_tsv(path: Path) -> list[dict]:
    with open(path, newline="") as fh:
        return list(csv.DictReader(fh, delimiter="\t"))


def _check_tsv(rows: list[dict], labels: list[str], what: str,
               n: int = 9) -> None:
    check(len(rows) == n, f"{what}: {len(rows)} rows, expected {n}")
    for r in rows:
        check(r["prediction"] in labels, f"{what}: label {r['prediction']}")
        for lab in labels:
            check(math.isfinite(float(r[f"{lab}_score"])),
                  f"{what}: {lab}_score not finite")


def flagship_bundle(tmp: Path) -> Path:
    """The seeded flagship (random weights, seed 42) as a bundle."""
    import torch

    from jaeger_tpu_torch.models.artifacts import init_params, save_model
    from jaeger_tpu_torch.models.flagship import flagship_config

    cfg = flagship_config()
    return save_model(init_params(cfg, torch.Generator().manual_seed(42)),
                      cfg, tmp / "flagship_bundle")


def _max_score_diff(rows: list[dict], ref: list[dict], labels) -> float:
    by_id = {r["contig_id"]: r for r in ref}
    return max(abs(float(r[f"{lab}_score"])
                   - float(by_id[r["contig_id"]][f"{lab}_score"]))
               for r in rows for lab in labels)


def phase_predict(tmp: Path, bundle: Path) -> int:
    from jaeger_tpu_torch import cli
    from jaeger_tpu_torch.models.flagship import _CLASSES
    from jaeger_tpu_torch.ops import fused_conv

    # the main path: counts reset just before, read just after
    fused_conv.launches = 0
    t0 = time.perf_counter()
    cli.main(["predict", "-i", str(FASTA), "-o", str(tmp / "flagship"),
              "-m", str(bundle), "--fsize", "1505", "--batch", "2048"])
    dt = time.perf_counter() - t0
    launches = fused_conv.launches
    check(launches > 0 and launches % 6 == 0,
          f"flagship predict: {launches} kernel launches")
    rows = _read_tsv(tmp / "flagship" / "test_contigs_default_jaeger.tsv")
    _check_tsv(rows, _CLASSES, "flagship predict")
    print(f"predict flagship (bf16, batch 2048): {len(rows)} contigs in "
          f"{dt:.2f} s, {launches} kernel launches")

    # the bundled demo model: GPU bf16, GPU f32 and CPU f32
    demo_labels = ["chromosome", "phage", "plasmid"]
    before = fused_conv.launches
    runs = {}
    for name, extra in (("gpu_bf16", []),
                        ("gpu_f32", ["--precision", "float32"]),
                        ("cpu_f32", ["--precision", "float32", "--device",
                                     "cpu"])):
        cli.main(["predict", "-i", str(FASTA), "-o", str(tmp / name)]
                 + extra)
        runs[name] = _read_tsv(tmp / name / "test_contigs_default_jaeger.tsv")
        _check_tsv(runs[name], demo_labels, f"demo predict {name}")
    check(fused_conv.launches > before, "demo predict launched no kernel")
    ref = {r["contig_id"]: r for r in runs["cpu_f32"]}
    for name in ("gpu_f32", "gpu_bf16"):
        tol = 0.01 if name == "gpu_f32" else 0.15
        worst = _max_score_diff(runs[name], runs["cpu_f32"], demo_labels)
        check(worst <= tol, f"demo {name} vs cpu_f32: score diff {worst}")
        same = sum(r["prediction"] == ref[r["contig_id"]]["prediction"]
                   for r in runs[name])
        print(f"predict demo {name}: {len(runs[name])} contigs, max score "
              f"diff vs CPU f32 {worst:.3f} (tol {tol}), {same}/9 calls "
              f"equal")
    return launches


def phase_int8_predict(tmp: Path, bundle: Path) -> int:
    """``predict --int8`` and ``--int8 auto`` with the flagship's int8
    bundle (phase 4 wrote it beside the bundle) and with a full_int8
    bundle of the demo made by ``utils quantize`` on the card."""
    import shutil

    from jaeger_tpu_torch import cli
    from jaeger_tpu_torch.commands.predict import BUNDLED_DEMO_MODEL
    from jaeger_tpu_torch.models.flagship import _CLASSES
    from jaeger_tpu_torch.ops import fused_conv, int8_conv

    # the main path: counts reset just before, read just after
    fused_conv.launches = 0
    int8_conv.launches = 0
    t0 = time.perf_counter()
    cli.main(["predict", "-i", str(FASTA), "-o", str(tmp / "flagship_int8"),
              "-m", str(bundle), "--fsize", "1505", "--batch", "2048",
              "--int8"])
    dt_full = time.perf_counter() - t0
    full8 = int8_conv.launches
    check(full8 > 0 and full8 % 6 == 0 and fused_conv.launches == 0,
          f"flagship predict --int8: {full8} int8_conv and "
          f"{fused_conv.launches} fused_conv_block launches")
    t0 = time.perf_counter()
    cli.main(["predict", "-i", str(FASTA), "-o", str(tmp / "flagship_auto"),
              "-m", str(bundle), "--fsize", "1505", "--batch", "2048",
              "--int8", "auto"])
    dt_auto = time.perf_counter() - t0
    launches = int8_conv.launches
    auto8, auto_f = launches - full8, fused_conv.launches
    check(auto8 > 0 and auto8 % 6 == 0 and auto_f % 6 == 0,
          f"flagship predict --int8 auto: {auto8} int8_conv and {auto_f} "
          f"fused_conv_block launches")
    for name in ("flagship_int8", "flagship_auto"):
        _check_tsv(_read_tsv(tmp / name / "test_contigs_default_jaeger.tsv"),
                   _CLASSES, f"predict {name}")
    print(f"predict flagship --int8 (bf16, batch 2048): {dt_full:.2f} s, "
          f"{full8} int8_conv launches; --int8 auto: {dt_auto:.2f} s, "
          f"{auto8} int8_conv + {auto_f} fused_conv_block launches")

    # the demo: utils quantize on the card, then --int8 on GPU and CPU
    demo_labels = ["chromosome", "phage", "plasmid"]
    demo = tmp / "demo"
    shutil.copytree(BUNDLED_DEMO_MODEL, demo)
    cli.main(["utils", "quantize", "-m", str(demo), "-o", f"{demo}_int8",
              "--mode", "full_int8"])
    runs = {}
    for name, extra in (("demo_int8_gpu_f32", ["--precision", "float32"]),
                        ("demo_int8_cpu_f32", ["--precision", "float32",
                                               "--device", "cpu"]),
                        ("demo_auto_gpu_bf16", ["--int8", "auto"])):
        flag = [] if "--int8" in extra else ["--int8"]
        cli.main(["predict", "-i", str(FASTA), "-o", str(tmp / name), "-m",
                  str(demo)] + flag + extra)
        runs[name] = _read_tsv(tmp / name / "test_contigs_default_jaeger.tsv")
        _check_tsv(runs[name], demo_labels, f"predict {name}")
    worst = _max_score_diff(runs["demo_int8_gpu_f32"],
                            runs["demo_int8_cpu_f32"], demo_labels)
    check(worst <= 0.01, f"demo --int8 GPU f32 vs CPU f32: score diff "
                         f"{worst}")
    print(f"predict demo --int8 GPU f32: max score diff vs CPU f32 "
          f"{worst:.4f} (tol 0.01); --int8 auto GPU bf16 ran")
    return launches


# --- phase 7: host pipeline and full predict ---------------------------------

#: the synthetic assembly of phase 7: 750 contigs of 5-75 kb (30 Mb), cut
#: from 1,000 (40 Mb) to keep the phase near a minute; the terminal-repeat
#: scan, which every default run repeats, takes most of it
BIG_CONTIGS = 750
#: the pure-Python windowing subset: the same file's first 25 contigs (1 Mb)
PY_CONTIGS = 25
TANDEM = b"GATTACAGGC" * 30


def write_synthetic_fasta(path: Path, n_contigs: int, seed: int = 17) -> int:
    """A seeded assembly from numpy, lines of 80 nt: contigs of 5-75 kb
    (the length mix of a metagenome's contigs past a few kb);
    every 7th holds an N run of 10-300 nt (the split and bounded
    programs), every 5th a 40-80 nt low-complexity tract (DUST masks it),
    contig 3 a 300 nt tandem tract. The first contigs of a shorter file
    are those of a longer one. Returns the bases written."""
    import numpy as np

    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    units = (b"A", b"CA", b"CAG", b"TTAGGG")
    total = 0
    with open(path, "wb") as fh:
        for i in range(n_contigs):
            n = int(rng.integers(5_000, 75_001))
            seq = acgt[rng.integers(0, 4, size=n)]
            if i % 7 == 1:
                at, w = int(rng.integers(0, n - 300)), int(rng.integers(10, 301))
                seq[at: at + w] = ord("N")
            if i % 5 == 2:
                unit = units[i % 4]
                at, w = int(rng.integers(0, n - 80)), int(rng.integers(40, 81))
                seq[at: at + w] = np.frombuffer(
                    (unit * (w // len(unit) + 1))[:w], np.uint8)
            if i == 3:
                seq[1000: 1000 + len(TANDEM)] = np.frombuffer(TANDEM, np.uint8)
            k = n // 80
            body = np.hstack([seq[: k * 80].reshape(k, 80),
                              np.full((k, 1), ord("\n"), np.uint8)])
            fh.write(b">ctg_%d len=%d\n" % (i, n))
            fh.write(body.tobytes())
            if n % 80:
                fh.write(seq[k * 80:].tobytes() + b"\n")
            total += n
    return total


def _windows_per_s(path: Path, workers: int) -> tuple[float, list]:
    """The port's ``window_batches`` as ``predict`` calls it at the
    flagship's 1505 nt (stride 1500, DUST on): windows/s, batches."""
    from jaeger_tpu_torch.seqops.windows import window_batches

    t0 = time.perf_counter()
    batches = list(window_batches(str(path), fragsize=1505, stride=1500,
                                  min_len=1505, workers=workers))
    dt = time.perf_counter() - t0
    return sum(len(b) for b in batches) / dt, batches


def device_busy_share(trace: Path) -> tuple[float, float, int]:
    """From a ``predict --profile`` Chrome trace: the share of the
    ``predict.inference`` range during which a kernel, copy or memset ran
    on the card, the kernels' share alone, and the kernel count."""
    events = json.loads(trace.read_text())["traceEvents"]
    rng_ev = [e for e in events if e.get("name") == "predict.inference"
              and e.get("cat") == "user_annotation"]
    check(len(rng_ev) == 1, f"{trace}: {len(rng_ev)} predict.inference "
                            f"ranges")
    lo = float(rng_ev[0]["ts"])
    hi = lo + float(rng_ev[0]["dur"])

    def union(cats) -> tuple[float, int]:
        spans = sorted((max(float(e["ts"]), lo),
                        min(float(e["ts"]) + float(e.get("dur", 0)), hi))
                       for e in events if e.get("cat") in cats
                       and e.get("ph") == "X")
        busy, end, n = 0.0, lo, 0
        for a, b in spans:
            if b <= a:
                continue
            n += 1
            if a > end:
                busy += b - a
                end = b
            elif b > end:
                busy += b - end
                end = b
        return busy, n

    busy, _ = union({"kernel", "gpu_memcpy", "gpu_memset"})
    kern, n_kernels = union({"kernel"})
    return busy / (hi - lo), kern / (hi - lo), n_kernels


def _cprofile_top(fn, top: int = 10) -> str:
    """``fn()`` under cProfile; the ``top`` functions by own time. From
    Python 3.12 cProfile records every thread, so a worker pool's calls
    sum over its threads."""
    import cProfile
    import io
    import pstats

    prof = cProfile.Profile()
    prof.enable()
    try:
        fn()
    finally:
        prof.disable()
    out = io.StringIO()
    pstats.Stats(prof, stream=out).sort_stats("tottime").print_stats(top)
    lines = out.getvalue().splitlines()
    start = next(i for i, ln in enumerate(lines) if "ncalls" in ln)
    return "\n".join(lines[start: start + top + 1])


def _stages_fasta(path: Path) -> None:
    """A small FASTA for the four stages: a 105 kb host contig holding the
    first test contig (the prophage stage's region), the third test
    contig, a contig with the tandem tract, a 3 kb contig."""
    import numpy as np

    from jaeger_tpu_torch.seqops.fasta import read_fasta

    recs = list(read_fasta(str(FASTA)))
    rng = np.random.default_rng(5)

    def dna(n):
        return "".join(rng.choice(list("ACGT"), size=n))

    host = dna(30_000) + recs[0][1] + dna(30_000)
    tandem = dna(2000) + TANDEM.decode() + dna(2000)
    path.write_text(f">host,1\n{host}\n>{recs[2][0]}\n{recs[2][1]}\n"
                    f">tandem\n{tandem}\n>short\n{dna(3000)}\n")


def _stage_runs(tmp: Path, bundle: Path) -> dict:
    """``--mask-tandem``, ``--prophage``, ``--refine`` and ``--profile`` on
    a small FASTA (``--plot-type none``: the card's machine may lack
    matplotlib), each checked for its files; the fused-conv launch count
    is reset before and read after each run."""
    import numpy as np

    from jaeger_tpu_torch import cli
    from jaeger_tpu_torch.ops import fused_conv
    from jaeger_tpu_torch.postprocess import refinement
    from jaeger_tpu_torch.seqops.fasta import read_fasta

    fasta = tmp / "stages.fasta"
    _stages_fasta(fasta)
    flag = ["-m", str(bundle), "--fsize", "1505", "--batch", "2048"]
    launches = {}

    def run(name, args):
        fused_conv.launches = 0
        t0 = time.perf_counter()
        cli.main(["predict", "-i", str(fasta), "-o", str(tmp / name),
                  *args])
        launches[name] = fused_conv.launches
        print(f"stage {name}: {time.perf_counter() - t0:.2f} s, "
              f"{launches[name]} fused_conv_block launches")
        return tmp / name

    out = run("mask_tandem", [*flag, "--mask-tandem"])
    masked = dict(read_fasta(str(out / "stages_tandem_masked.fasta")))
    check(set(masked["tandem"][2050:2250]) == {"N"}
          and "N" not in masked["tandem"][:1900],
          "--mask-tandem: the tandem tract is not masked")
    check((out / "stages_default_jaeger.tsv").exists(),
          "--mask-tandem wrote no TSV")

    # the demo model's phage track reaches 0.3 in the host contig's phage
    # insert; the region must equal a CPU float32 run's
    pro_args = ["--fsize", "500", "--stride", "500", "-p", "--lc", "20000",
                "-s", "0.3", "--plot-type", "none", "--precision",
                "float32"]
    out = run("prophage", pro_args)
    cpu = run("prophage_cpu", [*pro_args, "--device", "cpu"])
    rep = "stages_prophages/prophages_jaeger.tsv"
    rows, ref = _read_tsv(out / rep), _read_tsv(cpu / rep)
    regions = [(r["contig_id"], r["raw_start"], r["raw_end"]) for r in rows]
    check(len(rows) >= 1 and regions == [
        (r["contig_id"], r["raw_start"], r["raw_end"]) for r in ref],
        f"--prophage: regions {regions} on the card, "
        f"{[(r['contig_id'], r['raw_start'], r['raw_end']) for r in ref]} "
        f"on the CPU")
    check((out / "stages_prophages" / "plots").is_dir(),
          "--prophage wrote no plots directory")

    # the seeded flagship's logits lie within 0.01 of 0 and its windows'
    # top-two margins near 0.002: taus that pass most windows, not all
    taus_rng = np.random.default_rng(23)
    taus = {k: {"logit": float(taus_rng.uniform(-3.0, -2.0)),
                "margin": float(taus_rng.uniform(0.0, 0.0015)), "n": 100}
            for k in refinement.CLASSES}
    refinement.save_refinement(
        taus, bundle / "jaeger_tpu_flagship_refine.yaml",
        jaeger_model="jaeger_tpu_flagship", quantile=0.05)
    out = run("refine", [*flag, "--refine"])
    rows = _read_tsv(out / "stages_default_jaeger.tsv")
    check(all(c in rows[0] for c in ("contig_call", "contig_top_logit",
                                     "contig_margin", "n_windows_used")),
          f"--refine: no refined columns in {sorted(rows[0])}")
    calls = sum(bool(r["contig_call"]) for r in rows)
    check(calls >= 1, "--refine: no contig got a refined call")
    (bundle / "jaeger_tpu_flagship_refine.yaml").unlink()

    out = run("profile", [*flag, "--profile"])
    busy, _, n_k = device_busy_share(out / "profile" / "predict_trace.json")
    check(n_k > 0, "--profile: no kernel in the trace")
    for name in ("mask_tandem", "prophage", "refine", "profile"):
        check(launches[name] > 0, f"stage {name}: no fused_conv_block "
                                  f"launch")
    print(f"stages: --mask-tandem masked the tract; --prophage "
          f"{len(regions)} region(s) equal to the CPU's; --refine "
          f"{calls}/{len(rows)} contigs called; --profile {n_k} kernels "
          f"in the trace")
    return launches


def phase_host_pipeline(tmp: Path, bundle: Path, card: str) -> dict:
    """Phase 7: the native host pipeline at scale and ``predict`` complete
    (see the module docstring)."""
    import os

    import numpy as np
    import torch

    from jaeger_tpu_torch import cli, native
    from jaeger_tpu_torch.infer.engine import InferenceEngine
    from jaeger_tpu_torch.models.artifacts import load_model
    from jaeger_tpu_torch.ops import fused_conv
    from jaeger_tpu_torch.postprocess.termini import scan_for_terminal_repeats
    from jaeger_tpu_torch.utils import spans

    check(os.environ.get("JAEGER_TPU_TORCH_NATIVE", "1") != "0",
          "JAEGER_TPU_TORCH_NATIVE=0 switches the native pipeline off")
    check(native.available(), "the port's native host library is not live")
    lib = native.library_path()
    check(lib is not None and (ROOT / "build") in lib.resolve().parents,
          f"the native library {lib} is not the port's own under build/")
    print(f"native host library: {lib.relative_to(ROOT)}")

    big, small = tmp / "assembly.fasta", tmp / "subset.fasta"
    t0 = time.perf_counter()
    n_bases = write_synthetic_fasta(big, BIG_CONTIGS)
    n_small = write_synthetic_fasta(small, PY_CONTIGS)
    print(f"synthetic assembly: {BIG_CONTIGS} contigs, {n_bases / 1e6:.1f} "
          f"Mb ({time.perf_counter() - t0:.1f} s to write); subset "
          f"{PY_CONTIGS} contigs, {n_small / 1e6:.2f} Mb")

    res = {"card": card, "assembly_mb": n_bases / 1e6, "native": {}}
    n_cpu = os.cpu_count() or 1
    for w in sorted({1, 4, n_cpu}):
        rate, batches = _windows_per_s(big, w)
        res["native"][w] = rate
        print(f"host windowing, native, {w} workers: {rate:.0f} windows/s")
    n_windows = sum(len(b) for b in batches)
    first = batches[0]
    del batches
    nat_small = _windows_per_s(small, 4)[1]
    os.environ["JAEGER_TPU_TORCH_NATIVE"] = "0"
    try:
        res["python"], py_small = _windows_per_s(small, 4)
    finally:
        del os.environ["JAEGER_TPU_TORCH_NATIVE"]
    fields = ("bases", "length", "contig", "start", "contig_end", "ordinal",
              "seqlen", "g", "c", "a", "t", "gc_skew")
    check(len(py_small) == len(nat_small) and all(
        np.array_equal(getattr(a, f), getattr(b, f))
        and a.headers == b.headers
        for a, b in zip(py_small, nat_small) for f in fields),
        "native and Python windows differ on the subset")
    print(f"host windowing, pure Python, 4 workers: {res['python']:.0f} "
          f"windows/s on the {n_small / 1e6:.2f} Mb subset (equal to the "
          f"native windows)")

    t0 = time.perf_counter()
    repeats = scan_for_terminal_repeats(str(big), fsize=1505, workers=4)
    res["scan_s"] = time.perf_counter() - t0
    print(f"terminal-repeat scan, native, 4 workers: {res['scan_s']:.2f} s "
          f"for {len(repeats)} contigs")

    # the forward of the engine's first batch of this file, on the card
    model, _, _ = load_model(bundle, dtype=torch.bfloat16, device="cuda")
    eng = InferenceEngine(model, batch_size=2048, device="cuda")
    b, ln = first.bases[:2048], first.length[:2048]
    dense, split, cut = eng._plan_batch(b, ln, b.shape[0])
    if split is not None:
        # the base forward of a split batch, as the engine runs it
        _, _, b, ln = eng._gather_masked(b, ln, *split)
        dense = cut is None
    prog = dict(assume_dense=dense, mask_layers=None if dense else cut)
    tb, tl = torch.from_numpy(b).cuda(), torch.from_numpy(ln).cuda()
    with torch.inference_mode():
        res["forward_ms"] = cuda_ms(lambda: model(tb, tl, **prog), iters=5)
    del model, eng, tb, tl

    # predict end to end, default stages: counts reset just before, read
    # just after
    args = ["-m", str(bundle), "--fsize", "1505", "--batch", "2048"]
    fused_conv.launches = 0
    spans.reset()
    with spans.recording():
        t0 = time.perf_counter()
        cli.main(["predict", "-i", str(big), "-o", str(tmp / "scale"),
                  *args])
        res["predict_s"] = time.perf_counter() - t0
    engine = spans.totals()["spans"]
    res["launches"] = fused_conv.launches
    check(res["launches"] > 0 and res["launches"] % 6 == 0,
          f"predict at scale: {res['launches']} fused_conv_block launches")
    rows = _read_tsv(tmp / "scale" / "assembly_default_jaeger.tsv")
    check(len(rows) >= 0.9 * BIG_CONTIGS and all(
        math.isfinite(float(r["phage_score"])) for r in rows),
        f"predict at scale: {len(rows)} rows")
    res["windows_per_s"] = n_windows / res["predict_s"]
    n_batches = engine["engine/plan"]["count"]
    t0 = time.perf_counter()
    cli.main(["predict", "-i", str(big), "-o", str(tmp / "scale_no_termini"),
              *args, "--no-termini"])
    res["no_termini_s"] = time.perf_counter() - t0
    host = {k: engine[f"engine/{k}"]["seconds"] * 1e3 / max(n_batches, 1)
            for k in ("pack", "upload", "plan")}
    res["host_ms_per_batch"] = host
    print(f"predict at scale: {n_windows} windows of {BIG_CONTIGS} contigs "
          f"in {res['predict_s']:.2f} s = {res['windows_per_s']:.0f} "
          f"windows/s (the dense engine: 22916 windows/s, PERF.md), "
          f"{res['launches']} fused_conv_block launches, {len(rows)} rows; "
          f"with --no-termini {res['no_termini_s']:.2f} s = "
          f"{n_windows / res['no_termini_s']:.0f} windows/s")
    print(f"engine host time per batch of 2048 ({n_batches} batches): pack "
          f"{host['pack']:.2f} ms, upload {host['upload']:.2f} ms, plan "
          f"{host['plan']:.2f} ms, against a {res['forward_ms']:.2f} ms "
          f"forward of this file's first batch")

    t0 = time.perf_counter()
    cli.main(["predict", "-i", str(big), "-o", str(tmp / "scale_profile"),
              *args, "--profile"])
    res["profiled_predict_s"] = time.perf_counter() - t0
    busy, kern, n_k = device_busy_share(
        tmp / "scale_profile" / "profile" / "predict_trace.json")
    res["device_busy"], res["kernel_busy"] = busy, kern
    print(f"predict --profile at scale: {res['profiled_predict_s']:.2f} s; "
          f"the card busy {busy:.1%} of the inference loop (kernels "
          f"{kern:.1%}, {n_k} kernels)")
    # the scan's own profile is one native call; what is left besides it
    top = _cprofile_top(lambda: cli.main(
        ["predict", "-i", str(big), "-o", str(tmp / "scale_cprofile"),
         *args, "--no-termini"]))
    print("predict --no-termini at scale, cProfile (every thread), top 10 "
          "by own time:\n" + top)

    res["stage_launches"] = _stage_runs(tmp, bundle)
    return res


# --- phase 8: the layer-zoo templates -----------------------------------------

#: the four templates of this phase (``train_config/``), in the order run
ZOO_TEMPLATES = {
    "variable_length": "fragment_6class_variable_length.yaml",
    "dvf": "fragment_3class_500bp_dvf.yaml",
    "crossframe": "fragment_3class_500bp_crossframe.yaml",
    "axial": "fragment_3class_500bp_axial.yaml",
}
#: the residual convs of the cross-frame and axial templates at batch 256:
#: six frames of 165 codons, 64 channels, k 3
ZOO_N, ZOO_L, ZOO_C, ZOO_K = 6 * 256, 165, 64, 3


def _timed(t: dict, card: str, what: str) -> dict:
    """Fill in a timing record's bound (from its FLOP and bytes) and print
    it."""
    t_ops = t["flops"] / PEAK_BF16_FLOPS * 1e3
    t_bytes = t["bytes"] / HBM_BYTES_PER_S * 1e3
    t.update(bound_ms=max(t_ops, t_bytes),
             bound_by="operations" if t_ops >= t_bytes else "bytes")
    t["bound_share"] = t["bound_ms"] / t["ms"]
    print(f"timing {what} on {card}: kernel {t['ms']:.3f} ms, plain "
          f"{t['plain_ms']:.3f} ms, library {t['library_ms']:.3f} ms, bound "
          f"{t['bound_ms']:.3f} ms ({t['bound_by']}: {t['flops']:.3e} FLOP, "
          f"{t['bytes'] / 1e9:.3f} GB), {t['bound_share']:.1%} of the bound")
    return t


def phase_templates_kernel(card: str) -> dict:
    """The hand kernels at the templates' residual-conv shape (N = 1536, L
    = 165, C = 64, k = 3, bf16) against their plain versions, with phase 3
    and 3b's tolerances: ``fused_conv_block`` in the bias-only form the
    templates run (masked BN after it), with in_mask, and in the DYT forms;
    ``conv_wgrad``; the flipped-weight data gradient; ``conv_epilogue_bwd``
    (which the bias-only form does not launch) in its conv1 and conv2
    forms; FusedConvBlockFn's whole backward. Then kernel, plain, library
    and bound times of each at that shape."""
    import torch

    from jaeger_tpu_torch.ops import fused_conv
    from jaeger_tpu_torch.ops import fused_conv_grad as fg

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(8642)
    bf16 = torch.bfloat16
    n, length, c, k = ZOO_N, ZOO_L, ZOO_C, ZOO_K
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    saved = dict(fg.launches), fused_conv.launches
    x, w, bias, dyt = _conv_inputs(gen, n, length, c, k, bf16, dev)
    im = (torch.rand(n, length, generator=gen) > 0.2).to(dev)
    om = (torch.rand(n, length, generator=gen) > 0.2).to(dev)
    r = torch.randn(n, length, c, generator=gen).to(dev, bf16)
    plan = fused_conv.conv_plan(c, k)
    worst = {}
    for form, kw, act in (
            ("bias_only_in_mask", dict(bias=bias, in_mask=im), "none"),
            ("bias_only", dict(bias=bias), "none"),
            ("conv1_dyt", dict(bias=bias, dyt=dyt, use_dyt=True,
                               bias_then_dyt=True, in_mask=im, out_mask=om),
             "gelu_tanh"),
            ("conv2_dyt", dict(bias=bias, dyt=dyt, use_dyt=True,
                               bias_then_dyt=True, in_mask=im, out_mask=om,
                               residual=r), "gelu_tanh")):
        before = fused_conv.launches
        out = fused_conv.fused_conv_block(x, w, act=act, **kw)
        torch.cuda.synchronize()
        check(fused_conv.launches == before + 1,
              f"templates fused_conv_block {form}: kernel not launched")
        ref = fused_conv.reference_conv_block(x, w, act=act, **kw)
        err = (out.float() - ref.float()).abs()
        bad = (err > BF16_TOL + BF16_TOL * ref.float().abs()).sum().item()
        worst[form] = err.max().item()
        check(bad == 0 and math.isfinite(worst[form]),
              f"templates fused_conv_block {form}: {bad} elements beyond "
              f"tolerance")
        print(f"kernel templates {form} N={n} L={length} C={c} k={k} bf16 "
              f"[cb={plan['cb']} kw={plan['kw']} stages={plan['stages']}]: "
              f"max_abs_err {worst[form]:.3e} (tol {BF16_TOL}) ok")
        del out, ref, err
    du = (torch.randn(n, length, c, generator=gen) * 0.1).to(dev, bf16)
    wplan = fg.wgrad_plan(n, length, c, k, bf16, sms)
    dw, db = fg.conv_wgrad(x, du, im, k)
    again = fg.conv_wgrad(x, du, im, k)
    check(torch.equal(again[0], dw) and torch.equal(again[1], db),
          "templates conv_wgrad: not the same bits run to run")
    rdw, rdb = fg.reference_conv_wgrad(x, du, im, k)
    worst["conv_wgrad"] = _check_close(
        f"conv_wgrad templates shape N={n} L={length} C={c} k={k} bf16 "
        f"[groups={wplan['groups']}x{wplan['group']} co_block="
        f"{wplan['co_block']}]", {"dW": (dw, rdw), "db": (db, rdb)}, 1e-3)
    wb = w.to(bf16)
    wf = fg.flipped_weights(wb)
    dx = fused_conv.fused_conv_block(du, wf, out_mask=im)
    worst["dgrad"] = _check_close(
        f"dgrad templates shape N={n} L={length} C={c} k={k} bf16",
        {"dx": (dx, fused_conv.reference_conv_block(du, wf, out_mask=im))},
        *BF16_KERNEL_TOL)
    u = torch.randn(n, length, c, generator=gen).to(dev, bf16)
    dy = torch.randn(n, length, c, generator=gen).to(dev, bf16)
    worst["conv_epilogue_bwd"] = 0.0
    for form, res in (("conv1", None), ("conv2", r)):
        got = fg.conv_epilogue_bwd(dy, u, res, om, dyt, "gelu_tanh")
        ref = fg.reference_conv_epilogue_bwd(dy, u, res, om, dyt,
                                             "gelu_tanh")
        worst["conv_epilogue_bwd"] = max(worst["conv_epilogue_bwd"],
                                         _check_close(
            f"conv_epilogue_bwd templates shape {form} N={n} L={length} "
            f"C={c} bf16", {"du": (got[0], ref[0]),
                            "dr": (got[1], ref[1] if res is not None
                                   else None),
                            "ddyt": (got[2], ref[2])}, *BF16_KERNEL_TOL))
    for form, kw in (("bias_only", dict(in_mask=im)),
                     ("conv2", dict(dyt=dyt, act="gelu_tanh",
                                    bias_then_dyt=True, in_mask=im,
                                    out_mask=om, residual=r))):
        got = fg.conv_block_backward(dy, x, w, bias, **kw)
        ref = fg.reference_conv_block_backward(dy, x, w, bias, **kw)
        _check_close(f"FusedConvBlockFn backward {form} templates shape bf16",
                     dict(zip(("dx", "dW", "db", "ddyt", "dr"),
                              zip(got, ref))), *BF16_BACKWARD_TOL)

    # times at the templates' shape, each with its bound
    flops = 2.0 * n * length * c * c * k
    x_ncl = x.transpose(1, 2).contiguous()
    du_ncl = du.transpose(1, 2).contiguous()
    times = {}
    times["fused_conv_block"] = _timed(dict(
        ms=cuda_ms(lambda: fused_conv.fused_conv_block(
            x, w, bias, in_mask=im), iters=20),
        plain_ms=cuda_ms(lambda: fused_conv.reference_conv_block(
            x, w, bias, in_mask=im), iters=3, warmup=1),
        library_ms=cuda_ms(lambda: library_conv_block(
            x, w, bias, None, "none"), iters=20),
        flops=flops, bytes=2 * 2 * n * length * c + 2 * k * c * c + 4 * c
        + n * length, max_abs_err=worst["bias_only_in_mask"]),
        card, f"fused_conv_block bias-only in_mask N={n} L={length} C={c} "
        f"k={k} bf16")
    times["conv_wgrad"] = _timed(dict(
        ms=cuda_ms(lambda: fg.conv_wgrad(x, du, im, k), iters=20),
        plain_ms=cuda_ms(lambda: fg.reference_conv_wgrad(x, du, im, k),
                         iters=3, warmup=1),
        library_ms=cuda_ms(lambda: torch.nn.grad.conv1d_weight(
            x_ncl, (c, c, k), du_ncl, padding=(k - 1) // 2), iters=20),
        flops=flops, bytes=2 * 2 * n * length * c + n * length
        + 4 * (k * c * c + c), max_abs_err=worst["conv_wgrad"]),
        card, f"conv_wgrad N={n} L={length} C={c} k={k} bf16")
    times["dgrad"] = _timed(dict(
        ms=cuda_ms(lambda: fused_conv.fused_conv_block(du, wf, out_mask=im),
                   iters=20),
        plain_ms=cuda_ms(lambda: fused_conv.reference_conv_block(
            du, wf, out_mask=im), iters=3, warmup=1),
        library_ms=cuda_ms(lambda: torch.nn.grad.conv1d_input(
            (n, c, length), wb.permute(2, 1, 0), du_ncl,
            padding=(k - 1) // 2), iters=20),
        flops=flops, bytes=2 * 2 * n * length * c + 2 * k * c * c
        + n * length, max_abs_err=worst["dgrad"]),
        card, f"dgrad N={n} L={length} C={c} k={k} bf16")
    lib = library_epilogue_bwd(dy, u, r, om, dyt)
    times["conv_epilogue_bwd"] = _timed(dict(
        ms=cuda_ms(lambda: fg.conv_epilogue_bwd(dy, u, r, om, dyt,
                                                "gelu_tanh"), iters=20),
        plain_ms=cuda_ms(lambda: fg.reference_conv_epilogue_bwd(
            dy, u, r, om, dyt, "gelu_tanh"), iters=3, warmup=1),
        library_ms=cuda_ms(lib, iters=10), flops=0.0,
        bytes=5 * 2 * n * length * c + n * length + 2 * 12 * c,
        max_abs_err=worst["conv_epilogue_bwd"]),
        card, f"conv_epilogue_bwd conv2 form N={n} L={length} C={c} bf16")
    fg.launches.update(saved[0])
    fused_conv.launches = saved[1]
    return times


def zoo_config() -> dict:
    """A narrow f32 model with every layer of the zoo that no template
    uses: positional embeddings, a multi-scale conv, masked layer norm, an
    NMD tap, a transformer encoder, local attention, parallel branches,
    gated pooling and reliability mode ``nmd_plus_signals`` (the same
    model as tests/test_torch_layers_zoo.py's)."""
    branch_a = [{"name": "masked_conv1d", "config": {
        "filters": 16, "kernel_size": 3, "padding": "same"}},
        {"name": "nmd"}]
    branch_b = [{"name": "layernorm"},
                {"name": "dense", "config": {"units": 16}}]
    attn = {"embed_dim": 16, "feed_forward_dim": 24, "dropout_rate": 0.0}
    return {"model": {
        "classifier_out_dim": 3,
        "embedding": {"use_embedding_layer": True, "input_type": "translated",
                      "embedding_size": 16,
                      "use_positional_embeddings": True},
        "string_processor": {"crop_size": 30, "codon": "CODON"},
        "representation_learner": {"hidden_layers": [
            {"name": "multi_scale_conv", "config": {"branches": [
                {"filters": 8, "kernel_size": 3},
                {"filters": 8, "kernel_size": 5}]}},
            {"name": "masked_layernorm"},
            {"name": "nmd"},
            {"name": "transformer_encoder",
             "config": dict(attn, num_heads=2)},
            {"name": "local_attention",
             "config": dict(attn, num_heads=4, window_size=5)},
            {"name": "parallel_branches", "config": {
                "merge": "concat", "branches": [
                    {"hidden_layers": branch_a},
                    {"hidden_layers": branch_b}]}},
            {"name": "gelu"}], "pooling": "gatedframe"},
        "reliability_model": {"mode": "nmd_plus_signals", "hidden_layers": [
            {"name": "dense", "config": {"units": 4}}, {"name": "gelu"},
            {"name": "dense", "config": {"units": 1}}]},
        "classifier": {"hidden_layers": [
            {"name": "dense", "config": {"units": 3}}]},
    }, "training": {"optimizer": "adam",
                    "optimizer_params": {"learning_rate": 1e-3},
                    "loss_classifier": "categorical_crossentropy",
                    "loss_params_classifier": {"from_logits": True}}}


def phase_zoo_f32(cfg: dict | None = None, label: str = "zoo") -> dict:
    """The zoo model (``zoo_config``, or ``cfg``; seeded weights) in f32 on
    the card against the CPU, as phase 6a: the eval forward in the masked
    and dense
    programs (every output within 1e-5 of its scale), then one classifier
    step (the loss within 1e-5, every gradient leaf within 1e-4 of its
    scale; a leaf below 1e-4 of the largest gradient is rounding noise
    around an exact zero and held at the largest; the gate bias, a sum
    over frames that cancels to a few percent of its terms, at the gate
    kernel's scale; the NMD moving means within 1e-5). TF32 off."""
    import copy

    import numpy as np
    import torch

    from jaeger_tpu_torch.models.artifacts import init_params, load_state
    from jaeger_tpu_torch.models.builder import build_model
    from jaeger_tpu_torch.train import loop
    from jaeger_tpu_torch.train.optimizers import make_optimizer

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = cfg or zoo_config()
    t = cfg["training"]
    rng = np.random.default_rng(23)
    runs = {}
    for dev in ("cuda", "cpu"):
        model = build_model(copy.deepcopy(cfg))
        load_state(model, init_params(cfg, torch.Generator().manual_seed(9)))
        model.to(dev)
        crop = model.crop_nt
        if not runs:
            batch = _train_batch(rng, crop, "masked", 8, 3)
        outs = {}
        with torch.inference_mode():
            for prog in ("masked", "dense"):
                out = model(torch.from_numpy(batch["bases"]).to(dev),
                            torch.from_numpy(batch["lengths"]).to(dev),
                            assume_dense=prog == "dense")
                outs[prog] = {k: v.float().cpu() for k, v in out.items()}
        state = loop.TrainState.create(model, make_optimizer(
            t["optimizer"], t["optimizer_params"]))
        step = loop.make_train_step(model, loop.StepConfig(
            loss_name=t["loss_classifier"],
            loss_params=t["loss_params_classifier"]))
        state, metrics = step(state, loop.to_device(batch, dev))
        runs[dev] = dict(outs=outs, loss=float(metrics["loss"]),
                         grads={k: v.float().cpu()
                                for k, v in state.grads.items()},
                         stats={k: v.cpu() for k, v in
                                model.state_dict().items() if "moving" in k})
    gpu, cpu = runs["cuda"], runs["cpu"]
    f_err = 0.0
    for prog, outs in cpu["outs"].items():
        check(set(gpu["outs"][prog]) == set(outs) == {
            "embedding", "nmd", "gate", "prediction", "reliability"},
            f"{label} f32 {prog}: outputs {sorted(gpu['outs'][prog])}")
        for k, v in outs.items():
            e = float((gpu["outs"][prog][k] - v).abs().max()) / max(
                float(v.abs().max()), 1e-6)
            check(e <= 1e-5,
                  f"{label} f32 {prog} forward: {k} rel err {e:.2e}")
            f_err = max(f_err, e)
    check(abs(gpu["loss"] - cpu["loss"]) <= 1e-5 * max(abs(cpu["loss"]), 1.0),
          f"{label} f32 step: loss {gpu['loss']} vs {cpu['loss']}")
    overall = max(float(g.abs().max()) for g in cpu["grads"].values())
    gate = "rep/global_gatedframepool/gate"
    like = {f"{gate}/bias": f"{gate}/kernel"}
    g_err = 0.0
    for k, g in cpu["grads"].items():
        scale = max(float(cpu["grads"][like.get(k, k)].abs().max()), 1e-12)
        if scale < 1e-4 * overall:
            scale = overall
        e = float((gpu["grads"][k] - g).abs().max()) / scale
        check(e <= 1e-4, f"{label} f32 step: grad {k} rel err {e:.2e}")
        g_err = max(g_err, e)
    for k, s in cpu["stats"].items():
        e = float((gpu["stats"][k] - s).abs().max())
        check(e <= 1e-5 * max(float(s.abs().max()), 1e-6),
              f"{label} f32 step: {k} err {e:.2e}")
    print(f"{label} model f32 (card vs CPU): forward worst rel err "
          f"{f_err:.2e} (tol 1e-5), step loss {gpu['loss']:.6f} vs "
          f"{cpu['loss']:.6f}, "
          f"worst grad err {g_err:.2e} of its scale (tol 1e-4) ok")
    return dict(forward_err=f_err, grad_err=g_err)


def write_template_data(root: Path, name: str, cfg: dict) -> dict:
    """Phase 6's writer at the template's crop and classes (2048 training
    rows). The variable-length template trains on NPZ records: its
    training and validation rows are encoded by the port's
    ``encode_frames`` into (N, 6, 500) int32 tokens with ``labels``, the
    format ``train/data.py::load_npz_dataset`` reads; its reliability files
    stay CSVs."""
    import numpy as np
    import torch

    from jaeger_tpu_torch.models.builder import build_model
    from jaeger_tpu_torch.ops.encode import encode_frames
    from jaeger_tpu_torch.seqops.windows import encode_ascii

    model = build_model(cfg)
    crop = model.crop_nt
    root.mkdir(parents=True, exist_ok=True)
    data = write_train_data(root, seed=20261017, crop_nt=crop,
                            n_classes=int(cfg["model"]["classifier_out_dim"]),
                            n_rows=2048)
    if name != "variable_length":
        return data
    for split in ("train", "val"):
        rows = [line.split(",", 1) for line in
                Path(data[split]).read_text().splitlines()]
        bases = np.full((len(rows), crop), 4, np.uint8)
        lengths = np.zeros(len(rows), np.int32)
        for i, (_, s) in enumerate(rows):
            ids = encode_ascii(s[:crop])
            bases[i, :ids.shape[0]] = ids
            lengths[i] = ids.shape[0]
        tokens = encode_frames(torch.from_numpy(bases),
                               torch.from_numpy(lengths), crop)
        path = root / f"{split}.npz"
        np.savez(path, translated=tokens.numpy().astype(np.int32),
                 labels=np.array([int(lab) for lab, _ in rows], np.int64))
        data[split] = str(path)
    return data


def template_train_config(root: Path, name: str, data: dict) -> Path:
    """The template at its own widths, with the synthetic data: batch 256,
    bf16, 5 classifier steps (1 epoch) and, where the template has a
    reliability head, 2 reliability steps; 1 validation step each; the
    model, optimizer, losses and callbacks as the template has them."""
    import yaml

    from jaeger_tpu_torch.utils.config import load_model_config

    cfg = load_model_config(ROOT / "train_config" / ZOO_TEMPLATES[name])
    m, t = cfg["model"], cfg["training"]
    m["string_processor"]["buffer_size"] = 1024
    t.update(batch_size=256, mixed_precision="bfloat16", classifier_epochs=1,
             classifier_train_steps=5, classifier_validation_steps=1)
    classes = [e["class"] for e in m["class_label_map"]]
    labels = [int(e["label"]) for e in m["class_label_map"]]
    t["fragment_classifier_data"] = {
        "train": [{"class": classes, "path": [data["train"]],
                   "label": labels}],
        "validation": [{"class": classes, "path": [data["val"]],
                        "label": labels}]}
    if m.get("reliability_model"):
        t.update(reliability_epochs=1, reliability_train_steps=2,
                 reliability_validation_steps=1)
        t["fragment_reliability_data"] = {
            "train": [{"class": ["ood", "id"], "path": [data["rel_train"]],
                       "label": [0, 1]}],
            "validation": [{"class": ["ood", "id"],
                            "path": [data["rel_val"]], "label": [0, 1]}]}
    path = root / f"{name}_train.yaml"
    path.write_text(yaml.safe_dump(cfg, sort_keys=False))
    return path


def _template_rates(name: str, bundle: Path, cfg: dict, n_classes: int,
                    card: str) -> dict:
    """Steady-state train steps of the trained template per program
    (batch 256, bf16; warm, then 5 steps that do not wait for the card, on
    the host clock between two synchronizes) with each program's kernel
    launches per step, and the eval forward at batch 2048 (CUDA events)
    in the dense and masked programs; the device time by kernel of one
    dense step and one dense forward (torch profiler) and its share of the
    step or forward (the card's busy share)."""
    import numpy as np
    import torch

    from jaeger_tpu_torch.models.artifacts import load_model
    from jaeger_tpu_torch.models.builder import mask_cut_plan
    from jaeger_tpu_torch.ops import fused_conv
    from jaeger_tpu_torch.ops import fused_conv_grad as fg
    from jaeger_tpu_torch.train import loop
    from jaeger_tpu_torch.train.optimizers import make_optimizer

    model, _, _ = load_model(bundle, dtype=torch.bfloat16)
    t = cfg["training"]
    state = loop.TrainState.create(model, make_optimizer(
        t["optimizer"], t["optimizer_params"]))
    step = loop.make_dispatching_train_step(model, loop.StepConfig(
        loss_name=t["loss_classifier"],
        loss_params=t["loss_params_classifier"], heads=("prediction",)),
        "cuda")
    rng = np.random.default_rng(3)
    gen = torch.Generator(device="cuda").manual_seed(3)   # dropout
    programs = ["dense", "masked"]
    if mask_cut_plan(model.config["representation_learner"]):
        programs.insert(1, "bounded")
    saved = dict(fg.launches), fused_conv.launches
    rates = {}
    for program in programs:
        batch = _train_batch(rng, model.crop_nt, program, 256, n_classes)
        state, _ = step(state, batch, gen)               # warm
        before = dict(fg.launches), fused_conv.launches
        state, _ = step(state, batch, gen)
        torch.cuda.synchronize()
        per_step = {k: fg.launches[k] - before[0][k] for k in fg.launches}
        per_step["fused_conv_block"] = fused_conv.launches - before[1]
        reps = 5
        t0 = time.perf_counter()
        for _ in range(reps):
            state, _ = step(state, batch, gen)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / reps * 1e3
        rates[program] = dict(step_ms=ms, windows_per_s=256 / ms * 1e3,
                              launches_per_step=per_step)
        if program == "dense":
            dev_ms = sum(print_device_profile(
                lambda: step(state, batch, gen),
                f"template {name} train dense step", top=6).values())
            rates[program].update(device_ms=dev_ms,
                                  device_busy=dev_ms / ms)
    check(set(step.program_counts) == set(programs),
          f"template steady-state programs {step.program_counts}")
    bs = 2048
    bases = torch.from_numpy(rng.integers(0, 4, size=(
        bs, model.crop_nt)).astype(np.uint8)).cuda()
    lengths = torch.full((bs,), model.crop_nt, dtype=torch.int32,
                         device="cuda")
    with torch.inference_mode():
        for program in ("dense", "masked"):
            ms = cuda_ms(lambda: model(bases, lengths,
                                       assume_dense=program == "dense"),
                         iters=5, warmup=1)
            rates[f"forward_{program}"] = dict(
                ms=ms, windows_per_s=bs / ms * 1e3)
        dev_ms = sum(print_device_profile(
            lambda: model(bases, lengths, assume_dense=True),
            f"template {name} forward dense (batch {bs})", top=6).values())
        rates["forward_dense"].update(device_ms=dev_ms,
                                      device_busy=dev_ms
                                      / rates["forward_dense"]["ms"])
    fg.launches.update(saved[0])
    fused_conv.launches = saved[1]
    return rates


def phase_templates(tmp: Path, card: str) -> dict:
    """This slice's main path: for each template (``ZOO_TEMPLATES``) at its
    own widths, ``train_fragment_core`` at batch 256 in bf16 on synthetic
    data (5 classifier steps, 2 reliability steps where the template has
    a reliability head), then ``run_core`` (``predict``) with the bundle
    on the test contigs at the model's crop, in bf16 and in f32 on the card
    and in f32 on the CPU: the TSV's rows and labels, the card's f32 scores
    within 0.01 of the CPU's. Kernel launch counts are reset just before
    the four templates' train and predict runs and read just after. Then
    each template's steady-state step per program, kernel launches per
    step and forward rate (``_template_rates``)."""
    import torch

    from jaeger_tpu_torch.commands.predict import run_core
    from jaeger_tpu_torch.commands.train import train_fragment_core
    from jaeger_tpu_torch.models.builder import build_model
    from jaeger_tpu_torch.ops import fused_conv, int8_conv
    from jaeger_tpu_torch.ops import fused_conv_grad as fg
    from jaeger_tpu_torch.utils.config import load_model_config

    prepared = {}
    t0 = time.perf_counter()
    for name, file in ZOO_TEMPLATES.items():
        root = tmp / f"template_{name}"
        data = write_template_data(
            root, name, load_model_config(ROOT / "train_config" / file))
        prepared[name] = template_train_config(root, name, data)
    data_s = time.perf_counter() - t0
    # the main path: counts reset just before, read just after
    fused_conv.launches = 0
    int8_conv.launches = 0
    for k in fg.launches:
        fg.launches[k] = 0
    results = {}
    for name, cfg_path in prepared.items():
        cfg = load_model_config(cfg_path)
        labels = [e["class"] for e in cfg["model"]["class_label_map"]]
        out = cfg_path.parent / "run"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = train_fragment_core(str(cfg_path), str(out))
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        cls = [h["loss"] for h in res["history"]["classifier"]]
        rel = [h["loss"] for h in res["history"].get("reliability", [])]
        check(len(cls) == 1 and all(math.isfinite(v) for v in cls + rel),
              f"template {name}: losses {cls} {rel}")
        check(bool(rel) == bool(cfg["model"].get("reliability_model")),
              f"template {name}: reliability history {rel}")
        for f in ("params.msgpack", "project.yaml", "classes.yaml",
                  "history.csv", "checkpoints/classifier/checkpoints.json"):
            check((out / f).exists(), f"template {name}: train wrote no {f}")
        crop = build_model(cfg).crop_nt
        tsv = {}
        t0 = time.perf_counter()
        for run, extra in (("gpu_bf16", {}),
                           ("gpu_f32", dict(precision="float32")),
                           ("cpu_f32", dict(precision="float32",
                                            device="cpu"))):
            path = run_core(str(FASTA), str(cfg_path.parent / run), str(out),
                            fsize=crop, stride=crop, batch=256, **extra)
            tsv[run] = _read_tsv(path)
            _check_tsv(tsv[run], labels, f"template {name} predict {run}")
        predict_s = time.perf_counter() - t0
        diff = _max_score_diff(tsv["gpu_f32"], tsv["cpu_f32"], labels)
        check(diff <= 0.01, f"template {name}: card f32 scores differ from "
              f"the CPU's by {diff}")
        results[name] = dict(train_s=train_s, predict_s=predict_s,
                             classifier_loss=cls[0],
                             reliability_loss=rel[0] if rel else None,
                             programs=res["programs"]["classifier"],
                             score_diff_f32=diff, bundle=out,
                             int8_bundle=res.get("int8_path") is not None)
        print(f"template {name} (batch 256, bf16) on {card}: train "
              f"{train_s:.1f} s ({res['params']} parameters, classifier "
              f"loss {cls[0]:.4f}"
              + (f", reliability loss {rel[0]:.4f}" if rel else "")
              + f", programs {res['programs']['classifier']}, int8 bundle "
              f"{'written' if results[name]['int8_bundle'] else 'refused'})"
              f"; predict bf16 / f32 / CPU f32 {predict_s:.1f} s, 9 contigs, "
              f"card f32 vs CPU f32 max score diff {diff:.2e} (tol 0.01)")
    launches = dict(fg.launches, fused_conv_block=fused_conv.launches,
                    int8_conv=int8_conv.launches)
    check(launches["fused_conv_block"] > 0 and launches["conv_wgrad"] > 0,
          f"templates: launches {launches}")
    print(f"templates main path (data {data_s:.1f} s): kernel launches "
          f"{launches}")
    for name, r in results.items():
        cfg = load_model_config(prepared[name])
        r["rates"] = _template_rates(
            name, r["bundle"], cfg, int(cfg["model"]["classifier_out_dim"]),
            card)
        for prog, v in r["rates"].items():
            busy = (f", device {v['device_ms']:.2f} ms "
                    f"({v['device_busy']:.1%} busy)" if "device_ms" in v
                    else "")
            if prog.startswith("forward"):
                print(f"template {name} {prog} (batch 2048, bf16): "
                      f"{v['ms']:.2f} ms, {v['windows_per_s']:.0f} windows/s"
                      + busy)
            else:
                print(f"template {name} train {prog} step (batch 256, bf16): "
                      f"{v['step_ms']:.2f} ms, {v['windows_per_s']:.0f} "
                      f"windows/s, launches a step {v['launches_per_step']}"
                      + busy)
    # the residual convs of the attention templates run the kernels in
    # training: 2 fused_conv_block launches (forward, data gradient) and
    # one conv_wgrad per conv; the bias-only form launches no epilogue
    for name, convs in (("crossframe", 4), ("axial", 2)):
        got = results[name]["rates"]["dense"]["launches_per_step"]
        check(got == {"conv_wgrad": convs, "conv_epilogue_bwd": 0,
                      "fused_conv_block": 2 * convs},
              f"template {name}: launches per dense step {got}")
    bundles = {name: r.pop("bundle") for name, r in results.items()}
    return dict(launches=launches, templates=results, bundles=bundles)


# --- phase 9: the Hyena template and MaskedBiLSTM -----------------------------

#: the causal convolution's routes held on the card: (route, length in
#: codons) with D = 32 channels as the template; the direct route at the
#: template's 666 codons, the blocked and scan routes past the direct (1024)
#: and blocked (4096) caps
HYENA_ROUTES = (("direct", 666), ("blocked", 2048), ("scan", 8192))
#: the legacy LSTMModel's recurrent shape: 128 windows of 2048 nt (six
#: frames of 681 codons), 128 channels in, 128 units a direction
LSTM_WINDOWS, LSTM_L, LSTM_C, LSTM_U = 128, 681, 128, 128


def phase_hyena_routes(card: str) -> dict:
    """The causal convolution's routes on the card in f32 against the FFT
    route on the same inputs (``u`` (64 rows, 32, L), a decaying filter):
    each route's output within 1e-4 of the FFT's scale, the scan's ``du``
    and ``dh`` against autograd through the FFT within 1e-4; the bf16
    dispatch at each length takes that route (its output equal to the
    route's on the same bf16-rounded input). Times with CUDA events: the
    route, the FFT, and for the scan its forward and backward; the direct
    route also at the template's train shape (384 rows) with its bound
    (f32 operations at 67 TFLOP/s: the full L x L product)."""
    import torch

    from jaeger_tpu_torch.models import layers

    fns = {"direct": layers._causal_toeplitz_convolve,
           "blocked": layers._causal_block_toeplitz_convolve,
           "scan": layers._causal_chunked_scan_convolve}
    gen = torch.Generator(device="cuda").manual_seed(29)
    out = {}
    d = 32
    for route, length in HYENA_ROUTES:
        rows = 384 if route == "direct" else 64
        u = torch.randn(rows, d, length, device="cuda", generator=gen)
        t = torch.arange(length, device="cuda", dtype=torch.float32)
        h = torch.randn(d, length, device="cuda", generator=gen) * torch.exp(
            -t / (length / 8))
        fn = fns[route]
        with torch.no_grad():
            ref = layers.causal_fft_convolve(u, h)
            got = fn(u, h)
            err = float((got - ref).abs().max() / ref.abs().max())
            check(err <= 1e-4, f"hyena {route} route vs FFT: rel err {err}")
            ub = u.to(torch.bfloat16)
            check(torch.equal(layers.causal_fft_convolve(ub, h),
                              fn(ub.float(), h).to(torch.bfloat16)),
                  f"hyena bf16 dispatch at L {length} is not the {route} "
                  f"route")
            ms = cuda_ms(lambda: fn(u, h), iters=5, warmup=1)
            fft_ms = cuda_ms(lambda: layers.causal_fft_convolve(u, h),
                             iters=5, warmup=1)
        rec = dict(length=length, rows=rows, max_rel_err=err, ms=ms,
                   fft_ms=fft_ms)
        line = (f"hyena {route} route (rows {rows}, D {d}, L {length}, f32) "
                f"on {card}: {ms:.3f} ms, FFT {fft_ms:.3f} ms, rel err vs "
                f"FFT {err:.2e} (tol 1e-4)")
        if route == "direct":
            flops = 2.0 * rows * d * length * length
            rec.update(flops=flops, bound_ms=flops / PEAK_F32_FLOPS * 1e3,
                       bound_by="operations")
            line += (f", bound {rec['bound_ms']:.3f} ms (operations, "
                     f"{flops:.3e} FLOP at 67 TFLOP/s), "
                     f"{rec['bound_ms'] / ms:.1%} of it")
        if route == "scan":
            g = torch.randn(u.shape, device="cuda", generator=gen)
            grads = {}
            for name, f in (("scan", fn),
                            ("fft", layers.causal_fft_convolve)):
                ur = u.clone().requires_grad_(True)
                hr = h.clone().requires_grad_(True)
                f(ur, hr).backward(g)
                grads[name] = (ur.grad, hr.grad)
            for i, which in enumerate(("du", "dh")):
                e = float((grads["scan"][i] - grads["fft"][i]).abs().max()
                          / grads["fft"][i].abs().max())
                check(e <= 1e-4, f"hyena scan {which} vs FFT: rel err {e}")
                rec[f"{which}_rel_err"] = e
            ur = u.clone().requires_grad_(True)
            hr = h.clone().requires_grad_(True)
            rec["forward_backward_ms"] = cuda_ms(
                lambda: fn(ur, hr).backward(g), iters=3, warmup=1)
            line += (f"; du / dh vs FFT {rec['du_rel_err']:.2e} / "
                     f"{rec['dh_rel_err']:.2e}, forward + backward "
                     f"{rec['forward_backward_ms']:.3f} ms")
        print(line)
        out[route] = rec
    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 turned on: the Toeplitz products must run in full f32")
    return out


def hyena_train_config(root: Path, data: dict) -> Path:
    """``train_config/hyena_fullcontig.yaml`` at its own widths with the
    synthetic data: batch 64, bf16, 10 classifier steps (1 epoch), 1
    validation step, a 256-row shuffle buffer."""
    import yaml

    from jaeger_tpu_torch.utils.config import load_model_config

    cfg = load_model_config(ROOT / "train_config" / "hyena_fullcontig.yaml")
    m, t = cfg["model"], cfg["training"]
    m["string_processor"]["buffer_size"] = 256
    t.update(batch_size=64, mixed_precision="bfloat16", classifier_epochs=1,
             classifier_train_steps=10, classifier_validation_steps=1)
    classes = [e["class"] for e in m["class_label_map"]]
    labels = [int(e["label"]) for e in m["class_label_map"]]
    t["fragment_classifier_data"] = {
        split: [{"class": classes, "path": [data[key]], "label": labels}]
        for split, key in (("train", "train"), ("validation", "val"))}
    path = root / "hyena_train.yaml"
    path.write_text(yaml.safe_dump(cfg, sort_keys=False))
    return path


def write_hyena_data(root: Path, crop_nt: int) -> dict:
    """Phase 6's writer at the template's 2003 nt crop and 6 classes, its
    24 rows with an interior N, a long N run or a short length moved to
    rows 320-343 of 1024, so that the first batches of 64 are clean (the
    dense program) and later ones hold N runs (the masked program)."""
    root.mkdir(parents=True, exist_ok=True)
    data = write_train_data(root, seed=20261017, crop_nt=crop_nt,
                            n_classes=6, n_rows=4096)
    rows = Path(data["train"]).read_text().splitlines(keepends=True)
    runs = rows[2048:2064] + rows[3072:3080]
    clean = rows[:1000]
    Path(data["train"]).write_text("".join(clean[:320] + runs + clean[320:]))
    return data


def _hyena_rates(bundle: Path, cfg: dict, card: str) -> dict:
    """The trained template's steady-state classifier step per program
    (batch 64, bf16; warm, then 5 steps on the host clock between two
    synchronizes), the host's share of one step on an idle card (median of
    3) and the device time of one step (torch profiler) with its busy
    share; then the eval forward at batch 2048 in the dense and masked
    programs (CUDA events; 12,288 frames of 666 codons) with the device
    time of one forward."""
    import numpy as np
    import torch

    from jaeger_tpu_torch.models.artifacts import load_model
    from jaeger_tpu_torch.train import loop
    from jaeger_tpu_torch.train.optimizers import make_optimizer

    model, _, _ = load_model(bundle, dtype=torch.bfloat16)
    t = cfg["training"]
    state = loop.TrainState.create(model, make_optimizer(
        t["optimizer"], t["optimizer_params"]))
    step = loop.make_dispatching_train_step(model, loop.StepConfig(
        loss_name=t["loss_classifier"],
        loss_params=t["loss_params_classifier"], heads=("prediction",)),
        "cuda")
    rng = np.random.default_rng(5)
    gen = torch.Generator(device="cuda").manual_seed(5)     # dropout
    bs = int(t["batch_size"])
    rates = {}
    for program in ("dense", "masked"):
        batch = _train_batch(rng, model.crop_nt, program, bs, 6)
        state, _ = step(state, batch, gen)               # warm
        reps = 5
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            state, _ = step(state, batch, gen)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / reps * 1e3
        host = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, _ = step(state, batch, gen)
            host.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        dev_ms = sum(print_device_profile(
            lambda: step(state, batch, gen),
            f"hyena train {program} step (batch {bs})", top=6).values())
        rates[program] = dict(step_ms=ms, windows_per_s=bs / ms * 1e3,
                              host_step_ms=sorted(host)[1], device_ms=dev_ms,
                              device_busy=dev_ms / ms)
    check(set(step.program_counts) == {"dense", "masked"},
          f"hyena steady-state programs {step.program_counts}")
    n = 2048
    bases = torch.from_numpy(rng.integers(0, 4, size=(
        n, model.crop_nt)).astype(np.uint8)).cuda()
    lengths = torch.full((n,), model.crop_nt, dtype=torch.int32,
                         device="cuda")
    with torch.inference_mode():
        for program in ("dense", "masked"):
            fwd = (lambda: model(bases, lengths,
                                 assume_dense=program == "dense"))
            ms = cuda_ms(fwd, iters=3, warmup=1)
            dev_ms = sum(print_device_profile(
                fwd, f"hyena forward {program} (batch {n})", top=6).values())
            rates[f"forward_{program}"] = dict(
                ms=ms, windows_per_s=n / ms * 1e3, device_ms=dev_ms,
                device_busy=dev_ms / ms)
    for prog, v in rates.items():
        if prog.startswith("forward"):
            print(f"hyena {prog} (batch {n}, bf16) on {card}: {v['ms']:.2f} "
                  f"ms, {v['windows_per_s']:.0f} windows/s, device "
                  f"{v['device_ms']:.2f} ms ({v['device_busy']:.1%} busy)")
        else:
            print(f"hyena train {prog} step (batch {bs}, bf16) on {card}: "
                  f"{v['step_ms']:.2f} ms, {v['windows_per_s']:.0f} "
                  f"windows/s, host {v['host_step_ms']:.1f} ms a step, "
                  f"device {v['device_ms']:.2f} ms ({v['device_busy']:.1%} "
                  f"busy)")
    return rates


def phase_hyena(tmp: Path, card: str) -> dict:
    """This slice's main path: ``train_fragment_core`` on the Hyena
    template at its own widths (batch 64, bf16, 10 classifier steps on
    seeded CSVs with N runs, so the dense and masked programs), then
    ``run_core`` with the bundle at ``--fsize 2003 --stride 2003`` in bf16
    and in f32 on the card and in f32 on the CPU: the TSV's rows and
    labels, the card's f32 scores within 0.01 of the CPU's. Kernel launch
    counts are reset just before and read just after (the template has no
    conv, so none of the hand kernels runs). Then the steady-state steps
    and forwards (``_hyena_rates``)."""
    import torch

    from jaeger_tpu_torch.commands.predict import run_core
    from jaeger_tpu_torch.commands.train import train_fragment_core
    from jaeger_tpu_torch.ops import fused_conv, int8_conv
    from jaeger_tpu_torch.ops import fused_conv_grad as fg
    from jaeger_tpu_torch.utils.config import load_model_config

    root = tmp / "template_hyena"
    t0 = time.perf_counter()
    data = write_hyena_data(root, crop_nt=2003)
    cfg_path = hyena_train_config(root, data)
    data_s = time.perf_counter() - t0
    cfg = load_model_config(cfg_path)
    labels = [e["class"] for e in cfg["model"]["class_label_map"]]
    out = root / "run"
    # the main path: counts reset just before, read just after
    fused_conv.launches = 0
    int8_conv.launches = 0
    for k in fg.launches:
        fg.launches[k] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = train_fragment_core(str(cfg_path), str(out))
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    cls = [h["loss"] for h in res["history"]["classifier"]]
    check(len(cls) == 1 and math.isfinite(cls[0]),
          f"hyena template: classifier losses {cls}")
    programs = res["programs"]["classifier"]
    check(set(programs) == {"dense", "masked"},
          f"hyena template: programs {programs}")
    for f in ("params.msgpack", "project.yaml", "classes.yaml",
              "history.csv", "checkpoints/classifier/checkpoints.json",
              "int8/params_int8.msgpack"):
        check((out / f).exists(), f"hyena template: train wrote no {f}")
    tsv = {}
    t0 = time.perf_counter()
    for run, extra in (("gpu_bf16", {}),
                       ("gpu_f32", dict(precision="float32")),
                       ("cpu_f32", dict(precision="float32",
                                        device="cpu"))):
        path = run_core(str(FASTA), str(root / run), str(out), fsize=2003,
                        stride=2003, batch=256, **extra)
        tsv[run] = _read_tsv(path)
        _check_tsv(tsv[run], labels, f"hyena template predict {run}")
    predict_s = time.perf_counter() - t0
    launches = dict(fg.launches, fused_conv_block=fused_conv.launches,
                    int8_conv=int8_conv.launches)
    check(not any(launches.values()),
          f"hyena template: hand-kernel launches {launches} (no conv)")
    ids = [r["contig_id"] for r in tsv["cpu_f32"]]
    for run in ("gpu_bf16", "gpu_f32"):
        check([r["contig_id"] for r in tsv[run]] == ids,
              f"hyena template: {run} rows differ from the CPU's")
    check([r["prediction"] for r in tsv["gpu_f32"]]
          == [r["prediction"] for r in tsv["cpu_f32"]],
          "hyena template: card f32 labels differ from the CPU's")
    diff = _max_score_diff(tsv["gpu_f32"], tsv["cpu_f32"], labels)
    check(diff <= 0.01, f"hyena template: card f32 scores differ from the "
          f"CPU's by {diff}")
    print(f"hyena template (batch 64, bf16) on {card}: data {data_s:.1f} s, "
          f"train {train_s:.1f} s ({res['params']} parameters, classifier "
          f"loss {cls[0]:.4f}, programs {programs}, int8 bundle with "
          f"0 int8 convs); predict --fsize 2003 bf16 / f32 / CPU f32 "
          f"{predict_s:.1f} s, 9 contigs, card f32 vs CPU f32 max score "
          f"diff {diff:.2e} (tol 0.01); hand-kernel launches {launches}")
    rates = _hyena_rates(out, cfg, card)
    return dict(train_s=train_s, predict_s=predict_s, classifier_loss=cls[0],
                programs=programs, score_diff_f32=diff, launches=launches,
                rates=rates)


def bilstm_zoo_config() -> dict:
    """The zoo model of phase 8 with a ``masked_bilstm`` layer (8 units a
    direction) after its local attention."""
    cfg = zoo_config()
    cfg["model"]["representation_learner"]["hidden_layers"].insert(
        5, {"name": "masked_bilstm", "config": {"units": 8}})
    return cfg


def phase_bilstm(card: str) -> dict:
    """``MaskedBiLSTM`` on the card against the CPU in f32 at the legacy
    LSTMModel's widths (C 128, U 128, 681 steps, ``return_sequences=False``,
    masked runs inside rows; 8 windows, so that the CPU's run stays short):
    within 1e-5 of the scale; then its time on the card at the legacy
    shape (128 windows, six frames each), f32 and bf16, CUDA events, and
    the host's time to launch it."""
    import torch

    from jaeger_tpu_torch.models.artifacts import load_state
    from jaeger_tpu_torch.models.layers import MaskedBiLSTM

    gen = torch.Generator().manual_seed(31)
    mods = {dt: MaskedBiLSTM(LSTM_C, LSTM_U, return_sequences=False,
                             dtype=dt)
            for dt in (torch.float32, torch.bfloat16)}
    state = {k: torch.randn(v.shape, generator=gen) * 0.1
             for k, v in mods[torch.float32].state_dict().items()}
    for m in mods.values():
        load_state(m, state)
    mod = mods[torch.float32]

    def inputs(windows, device):
        g = torch.Generator().manual_seed(37)
        x = torch.randn(windows, 6, LSTM_L, LSTM_C, generator=g)
        mask = torch.ones(windows, 6, LSTM_L, dtype=torch.bool)
        mask[:, :, 300:340] = False
        mask[0, 1, 500:] = False
        return x.to(device), mask.to(device)

    with torch.inference_mode():
        x, mask = inputs(8, "cpu")
        want = mod(x, mask)[0]
        got = mod.to("cuda")(x.cuda(), mask.cuda())[0].cpu()
        err = float((got - want).abs().max() / want.abs().max())
        check(err <= 1e-5, f"MaskedBiLSTM card vs CPU: rel err {err}")
        x, mask = inputs(LSTM_WINDOWS, "cuda")
        times = {}
        for dt, m in mods.items():
            m.to("cuda")
            times[str(dt).split(".")[1]] = cuda_ms(lambda: m(x, mask),
                                                   iters=3, warmup=1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mod(x, mask)
        host_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
    print(f"MaskedBiLSTM (legacy shape: {LSTM_WINDOWS} windows x 6 frames, "
          f"L {LSTM_L}, C {LSTM_C}, U {LSTM_U}, last state) on {card}: "
          f"card vs CPU f32 rel err {err:.2e} (tol 1e-5, 8 windows); "
          f"f32 {times['float32']:.2f} ms, bf16 {times['bfloat16']:.2f} ms "
          f"a forward ({times['float32'] / LSTM_L * 1e3:.1f} us a step in "
          f"f32), host {host_ms:.2f} ms to launch one")
    return dict(card_vs_cpu_err=err, ms=times, host_ms=host_ms)


# --- phase 10: int8 for the layer-zoo templates, and ensembles ----------------

#: the dvf template's conv (train_config/fragment_3class_500bp_dvf.yaml:
#: one-hot nucleotides, 500 filters, k 10, VALID), one strand of a forward at
#: batch 2048: the ragged route of int8_conv
DVF_N, DVF_L, DVF_CIN, DVF_COUT, DVF_K = 2048, 500, 4, 500, 10


def library_ragged_conv(x, w, inv_act, dq, bias, k: int):
    """Yardstick only, the dvf conv's function in library calls: quantize,
    im2col of the VALID taps with the contraction padded to a multiple of 8
    and C_out to a multiple of 8 (``torch._int_mm``'s shapes: 40 -> 48, 500
    -> 504 at the dvf shape), one cuBLASLt int8 GEMM, the dequant and bias
    in torch; bf16 out."""
    import torch
    import torch.nn.functional as F

    from jaeger_tpu_torch.ops import int8_conv

    n, length, c_in = x.shape
    c_out = w.shape[2]
    l_out = length - (k - 1)
    kk, kp = k * c_in, -(-k * c_in // 8) * 8
    cop = -(-c_out // 8) * 8
    q = int8_conv.quantize_activation(x, inv_act).to(torch.int8)
    cols = torch.cat([q[:, j:j + l_out] for j in range(k)], dim=-1)
    cols = F.pad(cols, (0, kp - kk)).view(n * l_out, kp)
    wm = F.pad(w.reshape(kk, c_out), (0, cop - c_out, 0, kp - kk))
    acc = torch._int_mm(cols, wm)[:, :c_out]
    return (acc.float() * dq + bias).to(x.dtype).view(n, l_out, c_out)


def phase_ragged_kernel(card: str) -> dict:
    """int8_conv's ragged route (C_in or C_out not a multiple of 16) against
    its plain versions: the requant form equal, the dequant form within
    F32_TOL / BF16_TOL (phase 3's tolerances); then kernel, plain, library
    and bound times at the dvf conv's shape in the form its model runs
    (bias, no mask, no activation: the ReLU is a layer of its own)."""
    import torch

    from jaeger_tpu_torch.ops import int8_conv

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(1010)
    f32, bf16, i8 = torch.float32, torch.bfloat16, torch.int8
    plan = int8_conv.int8_plan(DVF_CIN, DVF_COUT, DVF_K, 1, "valid", bf16)
    print(f"int8 plan dvf conv (4, 500, 10, 1, valid) bf16: "
          f"{_plan_tag(plan)}")
    check(plan["route"] == "ragged", f"dvf plan {plan}")

    # requant: C_in 4 / C_out 20 (k 10, SAME), the edges of the 64-row tile,
    # an aligned C_in with a ragged C_out, a stage of fewer taps than k
    scale = torch.full((1,), 1.0 / 64.0, device=dev)
    # (name, n, length, c_in, c_out, k, dilation)
    for name, n, length, c_in, c_out, k, dil in (
            ("C4_to_20_k10", 64, 300, 4, 20, 10, 1),
            ("C4_to_20_L1", 4, 1, 4, 20, 10, 1),
            ("C4_to_20_L65", 3, 65, 4, 20, 10, 1),
            ("C24_to_40_d3", 16, 300, 24, 40, 3, 3),
            ("C16_to_20", 16, 130, 16, 20, 5, 1),
            ("C12_to_30_vec1", 16, 130, 12, 30, 3, 1),
            ("C1000_to_60_stages", 4, 200, 1000, 60, 10, 1)):
        x = torch.randint(-64, 64, (n, length, c_in), generator=gen,
                          dtype=i8).to(dev)
        w = torch.randint(-8, 8, (k, c_in, c_out), generator=gen,
                          dtype=i8).to(dev)
        plan = int8_conv.int8_plan(c_in, c_out, k, dil, "same", i8)
        check(plan["route"] == "ragged", f"requant {name}: plan {plan}")
        before = int8_conv.launches
        out = int8_conv.int8_conv_requant(x, w, scale, dilation=dil)
        torch.cuda.synchronize()
        check(int8_conv.launches == before + 1, f"{name}: kernel not launched")
        ref = int8_conv.reference_int8_conv_requant(x, w, scale, dilation=dil)
        diff = (out.int() - ref.int()).abs().max().item()
        print(f"int8 ragged requant {name} N={n} L={length} C={c_in}->{c_out} "
              f"k={k} d={dil} [{_plan_tag(plan)}]: max |diff| {diff} "
              f"{'ok' if diff == 0 else 'FAIL'}")
        check(out.dtype == i8 and out.shape == ref.shape and diff == 0,
              f"ragged {name}: requant differs from the plain version by "
              f"{diff}")

    # dequant: the dvf shape in bf16 with in_mask and in f32 with out_mask;
    # C_in 24 / C_out 40, k 3, SAME, dilation 3 with DYT and a residual;
    # the tile's edges, every activation
    # (name, n, length, c_in, c_out, k, dilation, padding, dtype, act, ext)
    cases = [
        ("dvf_bf16_in_mask", DVF_N, DVF_L, DVF_CIN, DVF_COUT, DVF_K, 1,
         "valid", bf16, "relu", "in_mask"),
        ("dvf_f32_out_mask", DVF_N, DVF_L, DVF_CIN, DVF_COUT, DVF_K, 1,
         "valid", f32, "relu", "out_mask"),
        ("C24_to_40_d3_bf16", 64, 300, 24, 40, 3, 3, "same", bf16,
         "gelu_tanh", "all"),
        ("C24_to_40_d3_f32", 64, 300, 24, 40, 3, 3, "same", f32, "gelu",
         "all"),
        ("C4_to_500_L1_same", 4, 1, 4, 500, 10, 1, "same", bf16, "none",
         "model"),
        ("C4_to_500_L74_valid", 3, 74, 4, 500, 10, 1, "valid", bf16, "tanh",
         "in_mask_runs"),
        ("C4_to_20_L65", 3, 65, 4, 20, 10, 1, "same", f32, "gelu_tanh",
         "out_mask_residual"),
        ("C16_to_20_relu", 6, 130, 16, 20, 3, 1, "same", bf16, "relu",
         "bias"),
        # C_out % 4 != 0: one channel a thread in the epilogue
        ("C12_to_30_vec1_bf16", 6, 130, 12, 30, 3, 1, "same", bf16,
         "gelu_tanh", "model"),
        ("C12_to_30_vec1_f32", 6, 130, 12, 30, 3, 3, "valid", f32, "gelu",
         "all"),
        ("C1000_to_60_stages", 4, 200, 1000, 60, 10, 1, "same", bf16,
         "gelu_tanh", "model"),
    ]
    worst = 0.0
    for name, n, length, c_in, c_out, k, dil, pad, dt, act, ext in cases:
        x, w, inv_act, dq, bias, dyt = _int8_dequant_inputs(
            gen, n, length, c_in, c_out, k, dt, dev)
        l_out = int8_conv.conv_geometry(length, k, dil, pad)[0]
        kw = dict(bias=bias, dilation=dil, padding=pad, act=act)
        kw.update(_int8_ext_args(gen, ext, n, length, l_out, c_out, dt, dyt,
                                 dev))
        plan = int8_conv.int8_plan(c_in, c_out, k, dil, pad, dt)
        check(plan["route"] == "ragged", f"dequant {name}: plan {plan}")
        before = int8_conv.launches
        out = int8_conv.int8_conv_dequant(x, w, inv_act, dq, **kw)
        torch.cuda.synchronize()
        check(int8_conv.launches == before + 1, f"{name}: kernel not launched")
        ref = int8_conv.reference_int8_conv_dequant(x, w, inv_act, dq, **kw)
        check(out.dtype == dt and out.shape == ref.shape,
              f"{name}: output {out.dtype} {tuple(out.shape)}")
        err = (out.float() - ref.float()).abs()
        tol = F32_TOL if dt == f32 else BF16_TOL
        bad = (err > tol + tol * ref.float().abs()).sum().item()
        max_err = err.max().item()
        print(f"int8 ragged dequant {name} [{_plan_tag(plan)}]: max_abs_err "
              f"{max_err:.3e} (tol {tol}) "
              f"{'ok' if bad == 0 and math.isfinite(max_err) else 'FAIL'}")
        check(bad == 0 and math.isfinite(max_err),
              f"ragged {name}: {bad} elements beyond tolerance")
        if "out_mask" in kw and "residual" not in kw:
            check(bool((out[~kw["out_mask"]] == 0).all()),
                  f"{name}: out_mask positions not zero")
        if name.startswith("dvf"):
            worst = max(worst, max_err)
        del x, w, out, ref, err

    # x and in_mask contiguous views whose base is not 16-byte aligned (the
    # route takes any alignment): the copies take the aligned span around
    # a tile's rows, x's 4-channel groups are read one element at a time
    for name, n, length, c_in, c_out, k, pad, dt, act, ext in (
            ("C4_to_500_misaligned_bf16", 8, 200, 4, 500, 10, "valid", bf16,
             "relu", "in_mask"),
            ("C12_to_30_misaligned_f32", 6, 130, 12, 30, 3, "same", f32,
             "gelu", "model")):
        x, w, inv_act, dq, bias, dyt = _int8_dequant_inputs(
            gen, n, length, c_in, c_out, k, dt, dev)
        l_out = int8_conv.conv_geometry(length, k, 1, pad)[0]
        kw = dict(bias=bias, padding=pad, act=act)
        kw.update(_int8_ext_args(gen, ext, n, length, l_out, c_out, dt, dyt,
                                 dev))
        x = _misaligned(x)
        kw["in_mask"] = _misaligned(kw["in_mask"])
        check(x.data_ptr() % 16 != 0 and kw["in_mask"].data_ptr() % 16 != 0,
              f"{name}: views aligned")
        plan = int8_conv.int8_plan(c_in, c_out, k, 1, pad, dt)
        check(plan["route"] == "ragged", f"dequant {name}: plan {plan}")
        before = int8_conv.launches
        out = int8_conv.int8_conv_dequant(x, w, inv_act, dq, **kw)
        torch.cuda.synchronize()
        check(int8_conv.launches == before + 1, f"{name}: kernel not launched")
        ref = int8_conv.reference_int8_conv_dequant(x, w, inv_act, dq, **kw)
        err = (out.float() - ref.float()).abs()
        tol = F32_TOL if dt == f32 else BF16_TOL
        bad = (err > tol + tol * ref.float().abs()).sum().item()
        max_err = err.max().item()
        print(f"int8 ragged dequant {name} x at {x.data_ptr() % 16} mod 16 "
              f"[{_plan_tag(plan)}]: max_abs_err {max_err:.3e} (tol {tol}) "
              f"{'ok' if bad == 0 and math.isfinite(max_err) else 'FAIL'}")
        check(out.shape == ref.shape and bad == 0 and math.isfinite(max_err),
              f"ragged {name}: {bad} elements beyond tolerance")
        del x, w, out, ref, err

    # times at the dvf shape in the form the dvf model runs
    x, w, inv_act, dq, bias, _ = _int8_dequant_inputs(
        gen, DVF_N, DVF_L, DVF_CIN, DVF_COUT, DVF_K, bf16, dev)
    l_out = DVF_L - (DVF_K - 1)

    def kernel():
        return int8_conv.int8_conv_dequant(x, w, inv_act, dq, bias,
                                           padding="valid")

    lib_out = library_ragged_conv(x, w, inv_act, dq, bias, DVF_K)
    lib_err = (lib_out.float() - kernel().float()).abs().max().item()
    check(lib_err <= BF16_TOL * (1 + lib_out.float().abs().max().item()),
          f"dvf library yardstick differs from the kernel by {lib_err}")
    launches_before = int8_conv.launches
    # each input read once (bf16 x, s8 w, f32 dq and bias), the bf16 output
    # written once
    ops = 2.0 * DVF_N * l_out * DVF_COUT * DVF_K * DVF_CIN
    nbytes = (2 * DVF_N * DVF_L * DVF_CIN + DVF_K * DVF_CIN * DVF_COUT
              + 8 * DVF_COUT + 2 * DVF_N * l_out * DVF_COUT)
    t_ops = ops / PEAK_INT8_OPS * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    bound_by = "operations" if t_ops >= t_bytes else "bytes"
    t = dict(ms=cuda_ms(kernel, iters=20),
             plain_ms=cuda_ms(lambda: int8_conv.reference_int8_conv_dequant(
                 x, w, inv_act, dq, bias, padding="valid"), iters=2,
                 warmup=1),
             library_ms=cuda_ms(lambda: library_ragged_conv(
                 x, w, inv_act, dq, bias, DVF_K), iters=5),
             library="torch._int_mm (im2col)", bound_ms=max(t_ops, t_bytes),
             bound_by=bound_by,
             max_abs_err=worst,
             shape=f"N={DVF_N} L={DVF_L} C={DVF_CIN}->{DVF_COUT} k={DVF_K} "
                   f"VALID bf16 bias")
    int8_conv.launches = launches_before  # timing launches are not the path
    t["bound_share"] = t["bound_ms"] / t["ms"]
    print(f"timing int8 ragged dvf conv {t['shape']} on {card}: kernel "
          f"{t['ms']:.3f} ms, plain {t['plain_ms']:.3f} ms, library "
          f"{t['library_ms']:.3f} ms ({t['library']}), bound "
          f"{t['bound_ms']:.3f} ms ({bound_by}), {t['bound_share']:.1%} of "
          f"the bound, "
          f"{DVF_N * l_out * DVF_COUT * 2 / t['ms'] / 1e6:.1f} GB/s of "
          f"output")
    return t



#: the templates whose int8 bundles phase 10 predicts with, and the two of
#: them (3 classes, 500 nt each) phase 10 makes an ensemble of
INT8_ZOO = ("dvf", "crossframe", "axial")
ENSEMBLE_MEMBERS = ("crossframe", "axial")


def train_zoo_bundles(tmp: Path, names) -> dict:
    """``--int8-zoo`` alone: the templates trained as phase 8 trains them
    (its data writer and config: batch 256, bf16, 5 classifier steps),
    each bundle with the ``int8/`` bundle ``train`` calibrates."""
    from jaeger_tpu_torch.commands.train import train_fragment_core
    from jaeger_tpu_torch.utils.config import load_model_config

    bundles = {}
    for name in names:
        root = tmp / f"template_{name}"
        data = write_template_data(root, name, load_model_config(
            ROOT / "train_config" / ZOO_TEMPLATES[name]))
        cfg_path = template_train_config(root, name, data)
        train_fragment_core(str(cfg_path), str(root / "run"))
        bundles[name] = root / "run"
    return bundles


def phase_int8_zoo(tmp: Path, card: str, bundles: dict) -> dict:
    """The dvf, cross-frame and axial bundles of phase 8 carry ``int8/``:
    ``run_core`` with ``int8="full"`` and ``"auto"`` in bf16, ``"full"`` in
    f32 on the card and on the CPU, and the float model in bf16, on the
    test contigs at the crop (kernel launch counts reset just before, read
    just after: int8_conv launched by every int8 run, the ragged route by
    the dvf's, no int8_conv launch by the float runs). The card's int8 f32
    scores within 0.01 of the CPU's (``phase_int8_predict``'s check); the
    int8 bf16 scores against the float bf16 ones printed. Then each
    template's dense forward at batch 2048 in bf16, int8 and float
    (CUDA events)."""
    import numpy as np
    import torch

    from jaeger_tpu_torch.commands.predict import run_core
    from jaeger_tpu_torch.models.artifacts import load_model
    from jaeger_tpu_torch.models.conversion import int8_conv_count
    from jaeger_tpu_torch.ops import fused_conv, int8_conv
    from jaeger_tpu_torch.utils.config import load_model_config

    runs = (("int8_bf16", dict(int8="full")),
            ("auto_bf16", dict(int8="auto")),
            ("int8_f32", dict(int8="full", precision="float32")),
            ("int8_cpu_f32", dict(int8="full", precision="float32",
                                  device="cpu")),
            ("float_bf16", {}))
    results = {}
    # the main path: counts reset just before, read just after
    fused_conv.launches = 0
    int8_conv.launches = 0
    int8_conv.route_launches.clear()
    t0 = time.perf_counter()
    for name in INT8_ZOO:
        bundle = Path(bundles[name])
        check((bundle / "int8" / "params_int8.msgpack").exists(),
              f"template {name}: train wrote no int8/ bundle")
        cfg = load_model_config(bundle / "project.yaml")
        labels = [e["class"] for e in cfg["model"]["class_label_map"]]
        crop = load_model(bundle, device="cpu")[0].crop_nt
        tsv, launched = {}, {}
        for run, extra in runs:
            before = int8_conv.launches
            path = run_core(str(FASTA), str(tmp / f"int8_zoo_{name}_{run}"),
                            str(bundle), fsize=crop, stride=crop, batch=256,
                            **extra)
            launched[run] = int8_conv.launches - before
            tsv[run] = _read_tsv(path)
            _check_tsv(tsv[run], labels, f"template {name} predict {run}")
        check(all(launched[r] > 0 for r in ("int8_bf16", "auto_bf16",
                                            "int8_f32"))
              and launched["float_bf16"] == launched["int8_cpu_f32"] == 0,
              f"template {name}: int8_conv launches by run {launched}")
        diff = _max_score_diff(tsv["int8_f32"], tsv["int8_cpu_f32"], labels)
        check(diff <= 0.01, f"template {name} --int8: card f32 scores differ "
              f"from the CPU's by {diff}")
        vs_float = _max_score_diff(tsv["int8_bf16"], tsv["float_bf16"],
                                   labels)
        ref = {r["contig_id"]: r["prediction"] for r in tsv["float_bf16"]}
        same = sum(r["prediction"] == ref[r["contig_id"]]
                   for r in tsv["int8_bf16"])
        results[name] = dict(launches=launched, score_diff_f32=diff,
                             int8_vs_float_bf16=vs_float, calls_equal=same)
        print(f"template {name} predict --int8 / --int8 auto / --int8 f32 "
              f"on {card}: int8_conv launches {launched}; card f32 vs CPU f32 "
              f"max score diff {diff:.2e} (tol 0.01); int8 vs float bf16 max "
              f"score diff {vs_float:.4f}, {same}/9 calls equal")
    launches = dict(int8_conv=int8_conv.launches,
                    ragged=int8_conv.route_launches["ragged"],
                    wgmma=int8_conv.route_launches["wgmma"],
                    mma=int8_conv.route_launches["mma"],
                    fused_conv_block=fused_conv.launches)
    check(launches["ragged"] > 0 and launches["wgmma"] > 0,
          f"int8 zoo: launches {launches}")
    print(f"int8 zoo main path ({time.perf_counter() - t0:.1f} s): kernel "
          f"launches {launches}")

    bs = 2048
    rng = np.random.default_rng(10)
    for name in INT8_ZOO:
        bundle = Path(bundles[name])
        models = {"float": load_model(bundle, dtype=torch.bfloat16)[0],
                  "int8": load_model(bundle / "int8",
                                     dtype=torch.bfloat16)[0]}
        check(int8_conv_count(models["int8"]) > 0,
              f"template {name}: the int8 bundle has no int8 conv")
        crop = models["float"].crop_nt
        bases = torch.from_numpy(rng.integers(0, 4, size=(bs, crop)).astype(
            np.uint8)).cuda()
        lengths = torch.full((bs,), crop, dtype=torch.int32, device="cuda")
        rates = {}
        with torch.inference_mode():
            for kind, model in models.items():
                ms = cuda_ms(lambda: model(bases, lengths, assume_dense=True),
                             iters=5, warmup=1)
                rates[kind] = dict(ms=ms, windows_per_s=bs / ms * 1e3)
        results[name]["forward_dense"] = rates
        print(f"template {name} forward dense (batch {bs}, bf16) on {card}: "
              f"int8 {rates['int8']['ms']:.2f} ms "
              f"({rates['int8']['windows_per_s']:.0f} windows/s), float "
              f"{rates['float']['ms']:.2f} ms "
              f"({rates['float']['windows_per_s']:.0f} windows/s), "
              f"{int8_conv_count(models['int8'])} int8 convs")
    return dict(launches=launches, templates=results)


def _combine_numpy(outs: list, method: str) -> dict:
    """The members' outputs combined as ``models/ensemble.py`` (and JAX's)
    combines them, in numpy."""
    import numpy as np

    keys = set(outs[0])
    for o in outs[1:]:
        keys &= set(o)
    stacks = {k: np.stack([o[k] for o in outs]).astype(np.float32)
              for k in keys}
    if method == "sum":
        return {k: s.sum(0) for k, s in stacks.items()}
    result = {k: s.sum(0) * np.float32(1.0 / len(outs))
              for k, s in stacks.items()}
    if method == "mean":
        return result
    preds = stacks["prediction"]
    n_classes = preds.shape[-1]
    votes = np.eye(n_classes, dtype=np.int64)[preds.argmax(-1)].sum(0)
    majority = np.eye(n_classes, dtype=np.float32)[votes.argmax(-1)][None]
    masked = preds * majority
    counts = (masked != 0).astype(np.float32).sum(0)
    result["prediction"] = masked.sum(0) / np.maximum(counts, 1.0)
    return result


def phase_ensemble(tmp: Path, card: str, bundles: dict) -> dict:
    """An ensemble of the cross-frame and axial bundles (3 classes, 500 nt
    each), written by ``utils combine-models`` for mv, sum and mean: its
    window outputs on the card in f32 (``InferenceEngine``, the test
    contigs' windows at the crop) against its members' own card outputs
    combined in numpy (1e-5 of each output's scale), then ``predict`` with
    the ensemble bundle on the card (bf16; rows and labels checked); the
    ensemble's dense forward at batch 2048 in bf16 (CUDA events)."""
    import numpy as np
    import torch

    from jaeger_tpu_torch import cli
    from jaeger_tpu_torch.commands.predict import run_core
    from jaeger_tpu_torch.infer.engine import InferenceEngine
    from jaeger_tpu_torch.models.artifacts import load_model
    from jaeger_tpu_torch.models.ensemble import load_ensemble
    from jaeger_tpu_torch.seqops.windows import window_batches
    from jaeger_tpu_torch.utils.config import load_model_config

    members = [str(bundles[n]) for n in ENSEMBLE_MEMBERS]
    cfg = load_model_config(Path(members[0]) / "project.yaml")
    labels = [e["class"] for e in cfg["model"]["class_label_map"]]
    crop = max(load_model(m, device="cpu")[0].crop_nt for m in members)
    batches = list(window_batches(str(FASTA), fragsize=crop, stride=crop,
                                  min_len=crop, workers=1))
    bases = np.concatenate([b.bases for b in batches])
    lengths = np.concatenate([b.length for b in batches])
    outs = [InferenceEngine(load_model(m)[0], batch_size=256)
            .predict_windows(bases, lengths) for m in members]
    results = {}
    for method in ("mv", "sum", "mean"):
        ens_dir = tmp / f"ensemble_{method}"
        cli.main(["utils", "combine-models", "-i", members[0], "-i",
                  members[1], "-o", str(ens_dir), "-c", method])
        model = load_ensemble(ens_dir)[0]
        got = InferenceEngine(model, batch_size=256).predict_windows(
            bases, lengths)
        want = _combine_numpy(outs, method)
        check(set(got) == set(want),
              f"ensemble {method}: keys {set(got)} vs {set(want)}")
        err = max(float(np.abs(got[k] - want[k]).max()
                        / max(float(np.abs(want[k]).max()), 1e-6))
                  for k in want)
        check(err <= 1e-5, f"ensemble {method}: card outputs differ from the "
              f"members' combined in numpy by {err} of the scale")
        t0 = time.perf_counter()
        path = run_core(str(FASTA), str(tmp / f"ensemble_predict_{method}"),
                        str(ens_dir), fsize=crop, stride=crop, batch=256)
        predict_s = time.perf_counter() - t0
        rows = _read_tsv(path)
        _check_tsv(rows, labels, f"ensemble {method} predict")
        results[method] = dict(err_vs_numpy=err, predict_s=predict_s)
        print(f"ensemble {method} of {'+'.join(ENSEMBLE_MEMBERS)} on {card}: "
              f"{bases.shape[0]} windows f32 vs the members' outputs "
              f"combined in numpy {err:.2e} of the scale (tol 1e-5); predict "
              f"bf16 {predict_s:.1f} s, {len(rows)} contigs")
    bs = 2048
    model = load_ensemble(tmp / "ensemble_mean", dtype=torch.bfloat16)[0]
    rng = np.random.default_rng(11)
    xb = torch.from_numpy(rng.integers(0, 4, size=(bs, crop)).astype(
        np.uint8)).cuda()
    xl = torch.full((bs,), crop, dtype=torch.int32, device="cuda")
    with torch.inference_mode():
        ms = cuda_ms(lambda: model(xb, xl, assume_dense=True), iters=5,
                     warmup=1)
    results["forward_dense"] = dict(ms=ms, windows_per_s=bs / ms * 1e3)
    print(f"ensemble forward dense (batch {bs}, bf16, mean) on {card}: "
          f"{ms:.2f} ms, {bs / ms * 1e3:.0f} windows/s")
    return results


# --- phase 11: the route's faults, the strided ragged route, legacy ----------

#: the shapes that one of the fused kernel's plans refused (ROADMAP queue
#: 3, F1): (name, C, k, dtype, predict's route, whether training takes the
#: kernel); each runs predict (conv_plan takes every shape since it covers
#: the Pallas kernel's whole domain: C 40 on wgmma_stream, f32 C 192 on
#: f32_ring) and two train steps (which take the kernel only where
#: check_wgrad_shape takes the shape too: f32 C 192 alone)
ROUTE_CASES = (
    ("C40_bf16", 40, 3, "bfloat16", "wgmma_stream", False),
    ("C192_f32", 192, 3, "float32", "f32_ring", True),
    ("k7_bf16_train", 128, 7, "bfloat16", "wgmma", False),
    ("C96_bf16_train", 96, 3, "bfloat16", "wgmma", False),
    ("k4_even_train", 64, 4, "bfloat16", "wgmma", False),
)


def route_config(c: int, k: int, strides: int = 1,
                 norm_type: str | None = None) -> dict:
    """A fragment model with one residual stack of two blocks of C
    channels and k taps (the first strided by ``strides``; the blocks'
    norms ``norm_type``, batch norm by default) behind a k5 entry conv of C
    channels and masked batch norm: 3 classes, a 500 nt (165 codon) crop,
    the demo's heads."""
    block = {"block_size": 2, "filters": c, "kernel_size": k,
             "strides": strides}
    if norm_type is not None:
        block["norm_type"] = norm_type
    return {"model": {
        "name": f"route_c{c}_k{k}_s{strides}",
        "classifier_out_dim": 3,
        "class_label_map": [{"class": n, "label": i} for i, n in
                            enumerate(["chromosome", "phage", "plasmid"])],
        "embedding": {"use_embedding_layer": True,
                      "input_type": "translated", "embedding_size": 32},
        "string_processor": {"crop_size": 165},
        "representation_learner": {"hidden_layers": [
            {"name": "masked_conv1d",
             "config": {"filters": c, "kernel_size": 5}},
            {"name": "masked_batchnorm", "config": {}},
            {"name": "gelu"},
            {"name": "residual_block", "config": block},
            {"name": "masked_batchnorm", "config": {}},
            {"name": "gelu"}], "pooling": "average"},
        "classifier": {"hidden_layers": [
            {"name": "dense", "config": {"units": 3, "dtype": "float32"}}]},
    }, "training": {
        "optimizer": "adam", "optimizer_params": {"learning_rate": 0.003},
        "loss_classifier": "categorical_crossentropy",
        "loss_params_classifier": {"from_logits": True}}}


def phase_route(tmp: Path, card: str) -> dict:
    """Each shape of ``ROUTE_CASES`` (seeded weights, DYT residual
    blocks): the forward on the card against the same model on the CPU
    (masked windows; F32_TOL of the scale in f32, BF16_TOL in bf16),
    ``run_core`` on the test contigs at
    ``--fsize 500`` (fused_conv_block launched on the case's route for
    every residual conv), two train steps on the card (finite losses;
    fused_conv_block, conv_wgrad and conv_epilogue_bwd launched where
    check_wgrad_shape takes the shape, f32 C 192, else none of the three),
    and the dense forward and a train step at batch 2048 / 256 timed (CUDA
    events)."""
    import copy

    import numpy as np
    import torch

    from jaeger_tpu_torch.commands.predict import run_core
    from jaeger_tpu_torch.models.artifacts import (init_params, load_state,
                                                   save_model)
    from jaeger_tpu_torch.models.builder import build_model
    from jaeger_tpu_torch.models.layers import ResidualBlock
    from jaeger_tpu_torch.ops import fused_conv
    from jaeger_tpu_torch.ops import fused_conv_grad as fg
    from jaeger_tpu_torch.train import loop
    from jaeger_tpu_torch.train.optimizers import make_optimizer

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    labels = ["chromosome", "phage", "plasmid"]
    results = {}
    predict_launches = 0
    for i, (name, c, k, precision, route, trains) in enumerate(ROUTE_CASES):
        dt = getattr(torch, precision)
        # the flagship's DYT blocks: a fused block's training backward
        # runs conv_epilogue_bwd
        cfg = route_config(c, k, norm_type="masked_dyt")
        state = init_params(cfg, torch.Generator().manual_seed(110 + i))
        bundle = save_model(state, cfg, tmp / f"route_{name}")
        models = {}
        for dev in ("cuda", "cpu"):
            m = build_model(copy.deepcopy(cfg), dtype=dt)
            load_state(m, state)
            models[dev] = m.to(dev).eval()
        blocks = [m for m in models["cuda"].modules()
                  if isinstance(m, ResidualBlock)]
        fused = [b.conv1.fused(dt, False) for b in blocks]
        fused_train = [b.conv1.fused(dt, True) for b in blocks]
        check(all(fused) and all(f == trains for f in fused_train),
              f"route {name}: fused in predict {fused}, in training "
              f"{fused_train}")
        rng = np.random.default_rng(120 + i)
        crop = models["cpu"].crop_nt
        batch = _train_batch(rng, crop, "masked", 64, 3)
        outs = {}
        with torch.inference_mode():
            for dev, m in models.items():
                out = m(torch.from_numpy(batch["bases"]).to(dev),
                        torch.from_numpy(batch["lengths"]).to(dev))
                outs[dev] = out["prediction"].float().cpu()
        ref = outs["cpu"]
        err = float((outs["cuda"] - ref).abs().max())
        tol = (F32_TOL if dt == torch.float32 else BF16_TOL) * max(
            float(ref.abs().max()), 1.0)
        check(math.isfinite(err) and err <= tol,
              f"route {name}: card forward differs from the CPU's by {err}")

        before = fused_conv.launches, fused_conv.route_launches[route]
        t0 = time.perf_counter()
        table = run_core(str(FASTA), str(tmp / f"route_{name}_predict"),
                         str(bundle), fsize=500, stride=500, batch=256,
                         precision=precision)
        predict_s = time.perf_counter() - t0
        launched = fused_conv.launches - before[0]
        predict_launches += launched
        _check_tsv(_read_tsv(table), labels, f"route {name} predict")
        check(launched > 0 and launched % 4 == 0 and
              fused_conv.route_launches[route] - before[1] == launched,
              f"route {name}: predict launched fused_conv_block {launched} "
              f"times, {fused_conv.route_launches[route] - before[1]} on "
              f"route {route}")

        m = build_model(copy.deepcopy(cfg), dtype=dt)
        load_state(m, state)
        m.to("cuda")
        tcfg = cfg["training"]
        tstate = loop.TrainState.create(m, make_optimizer(
            tcfg["optimizer"], tcfg["optimizer_params"]))
        step = loop.make_dispatching_train_step(m, loop.StepConfig(
            loss_name=tcfg["loss_classifier"],
            loss_params=tcfg["loss_params_classifier"],
            heads=("prediction",)), "cuda")
        before = (dict(fg.launches), fused_conv.launches)
        losses = []
        for s in range(2):
            tstate, metrics = step(tstate, _train_batch(
                rng, crop, ("masked", "dense")[s], 64, 3))
            losses.append(float(metrics["loss"]))
        torch.cuda.synchronize()
        train_by = dict(fused_conv_block=fused_conv.launches - before[1],
                        **{n: fg.launches[n] - before[0][n]
                           for n in fg.launches})
        train_launches = sum(train_by.values())
        check(all(math.isfinite(v) for v in losses) and
              (all(v > 0 for v in train_by.values()) if trains
               else train_launches == 0),
              f"route {name}: train losses {losses}, kernel launches "
              f"{train_by}")

        bs = 2048
        bases = torch.from_numpy(rng.integers(0, 4, size=(bs, crop)).astype(
            np.uint8)).cuda()
        lengths = torch.full((bs,), crop, dtype=torch.int32, device="cuda")
        with torch.inference_mode():
            fwd_ms = cuda_ms(lambda: models["cuda"](bases, lengths,
                                                    assume_dense=True),
                             iters=5, warmup=1)
        tb = _train_batch(rng, crop, "dense", 256, 3)
        held = [tstate]

        def one_step():
            held[0], _ = step(held[0], tb)

        step_ms = cuda_ms(one_step, iters=3, warmup=1)
        results[name] = dict(C=c, k=k, dtype=precision, predict_fused=fused,
                             route=route, forward_max_abs_err=err,
                             predict_launches=launched,
                             train_launches=train_by,
                             predict_s=predict_s, train_losses=losses,
                             forward_ms_b2048=fwd_ms,
                             windows_per_s=bs / fwd_ms * 1e3,
                             train_step_ms_b256=step_ms)
        print(f"route {name} (C {c}, k {k}, {precision}) on {card}: "
              f"residual convs fused in predict {fused}, in training "
              f"{fused_train}; card vs CPU forward max_abs_err {err:.2e} "
              f"(tol {tol:.2e}); predict {predict_s:.2f} s with {launched} "
              f"fused_conv_block launches on route {route}; train losses "
              f"{losses[0]:.4f}, {losses[1]:.4f} with kernel launches "
              f"{train_by}; "
              f"dense forward at batch {bs} {fwd_ms:.2f} ms "
              f"({bs / fwd_ms * 1e3:.0f} windows/s), train step at batch "
              f"256 {step_ms:.2f} ms")
    return dict(cases=results, predict_launches=predict_launches)


#: the stride shape: a strided residual conv1 at the flagship's widths
#: (batch 2048: N 12288, L 500, C 128 -> 128, k 5, SAME, stride 2), bf16
STRIDE_N, STRIDE_L, STRIDE_C, STRIDE_K, STRIDE_S = 12288, 500, 128, 5, 2


def library_strided_conv(x, w, inv_act, dq, bias, stride: int):
    """Yardstick only, the strided dequant conv in library calls: quantize,
    an im2col of the SAME taps at the stride, one cuBLASLt int8 GEMM
    (``torch._int_mm``), the dequant and bias in torch."""
    import torch
    import torch.nn.functional as F

    from jaeger_tpu_torch.ops import int8_conv

    n, length, c_in = x.shape
    k, _, c_out = w.shape
    l_out, pad_l, pad_r = int8_conv.conv_geometry(length, k, 1, "same",
                                                  stride)
    q = int8_conv.quantize_activation(x, inv_act).to(torch.int8)
    q = F.pad(q, (0, 0, pad_l, pad_r))
    span = (l_out - 1) * stride + 1
    cols = torch.cat([q[:, j:j + span:stride] for j in range(k)], dim=-1)
    acc = torch._int_mm(cols.reshape(n * l_out, k * c_in),
                        w.reshape(k * c_in, c_out))
    return (acc.float() * dq + bias).to(x.dtype).view(n, l_out, c_out)


def phase_ragged_stride(card: str) -> dict:
    """int8_conv's ragged route at a stride above 1 against its plain
    versions: the requant form equal, the dequant form within F32_TOL /
    BF16_TOL (phase 3's tolerances), at the strided residual block's
    convs (k 3 / 5 and the 1x1 bypass), ragged channel counts, dilation,
    VALID, the tile's edges and the masks; then kernel, plain, library and
    bound times at the stride shape."""
    import torch

    from jaeger_tpu_torch.ops import int8_conv

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(1111)
    f32, bf16, i8 = torch.float32, torch.bfloat16, torch.int8
    scale = torch.full((1,), 1.0 / 64.0, device=dev)
    # (name, n, length, c_in, c_out, k, dilation, stride)
    for name, n, length, c_in, c_out, k, dil, s in (
            ("C16_to_24_k3_s2", 16, 300, 16, 24, 3, 1, 2),
            ("C128_to_128_k5_s2", 32, 500, 128, 128, 5, 1, 2),
            ("C128_to_128_k1_s2", 32, 500, 128, 128, 1, 1, 2),
            ("C4_to_20_k10_s3", 16, 301, 4, 20, 10, 1, 3),
            ("C24_to_40_d3_s2", 16, 300, 24, 40, 3, 3, 2),
            ("C32_to_32_L1_s2", 4, 1, 32, 32, 3, 1, 2),
            ("C32_to_32_L129_s2", 3, 129, 32, 32, 3, 1, 2),
            ("C32_to_32_L257_s4", 3, 257, 32, 32, 5, 1, 4)):
        x = torch.randint(-64, 64, (n, length, c_in), generator=gen,
                          dtype=i8).to(dev)
        w = torch.randint(-8, 8, (k, c_in, c_out), generator=gen,
                          dtype=i8).to(dev)
        plan = int8_conv.int8_plan(c_in, c_out, k, dil, "same", i8, s)
        check(plan["route"] == "ragged", f"stride {name}: plan {plan}")
        before = int8_conv.launches
        out = int8_conv.int8_conv_requant(x, w, scale, dilation=dil,
                                          stride=s)
        torch.cuda.synchronize()
        check(int8_conv.launches == before + 1, f"{name}: kernel not launched")
        ref = int8_conv.reference_int8_conv_requant(x, w, scale, dilation=dil,
                                                    stride=s)
        diff = (out.int() - ref.int()).abs().max().item()
        print(f"int8 ragged stride requant {name} N={n} L={length} "
              f"C={c_in}->{c_out} k={k} d={dil} s={s} [{_plan_tag(plan)}]: "
              f"max |diff| {diff} {'ok' if diff == 0 else 'FAIL'}")
        check(out.dtype == i8 and out.shape == ref.shape and diff == 0,
              f"ragged stride {name}: requant differs from the plain "
              f"version by {diff}")

    # (name, n, length, c_in, c_out, k, dilation, stride, padding, dtype,
    #  act, ext)
    cases = [
        ("conv1_bf16_in_mask", 64, 500, 128, 128, 5, 1, 2, "same", bf16,
         "gelu_tanh", "in_mask"),
        ("conv1_bf16_dyt_residual", 64, 500, 128, 128, 3, 1, 2, "same", bf16,
         "gelu_tanh", "all"),
        ("bypass_bf16", 64, 500, 128, 128, 1, 1, 2, "same", bf16, "none",
         "model"),
        ("conv1_f32_out_mask", 16, 300, 48, 64, 3, 1, 2, "same", f32, "gelu",
         "out_mask_residual"),
        ("C24_to_40_d3_s3_f32", 16, 300, 24, 40, 3, 3, 3, "same", f32, "relu",
         "all"),
        ("C12_to_30_valid_s2", 6, 131, 12, 30, 4, 1, 2, "valid", bf16,
         "tanh", "in_mask_runs"),
        ("C16_L1_s2", 4, 1, 16, 16, 3, 1, 2, "same", bf16, "none", "bias"),
        ("C16_L65_s2", 3, 65, 16, 16, 3, 1, 2, "same", f32, "gelu_tanh",
         "all"),
        # f32 at C 128: the one-warpgroup layouts (wgs 1) that phase 11's
        # strided predict at float32 launches, conv1 with masks, DYT and a
        # residual (the general epilogue) and bias-only (the plain one),
        # and the 1x1 bypass
        ("conv1_f32_model", 16, 500, 128, 128, 5, 1, 2, "same", f32, "gelu",
         "model"),
        ("conv1_f32_in_mask", 16, 500, 128, 128, 5, 1, 2, "same", f32,
         "gelu_tanh", "in_mask"),
        ("bypass_f32", 16, 500, 128, 128, 1, 1, 2, "same", f32, "none",
         "bias"),
    ]
    worst = 0.0
    for name, n, length, c_in, c_out, k, dil, s, pad, dt, act, ext in cases:
        x, w, inv_act, dq, bias, dyt = _int8_dequant_inputs(
            gen, n, length, c_in, c_out, k, dt, dev)
        l_out = int8_conv.conv_geometry(length, k, dil, pad, s)[0]
        kw = dict(bias=bias, dilation=dil, padding=pad, act=act, stride=s)
        ext_kw = _int8_ext_args(gen, ext, n, length, l_out, c_out, dt, dyt,
                                dev)
        kw.update(ext_kw)
        plan = int8_conv.int8_plan(c_in, c_out, k, dil, pad, dt, s)
        check(plan["route"] == "ragged", f"dequant {name}: plan {plan}")
        if dt == f32 and c_in == 128:
            check(plan["wgs"] == 1, f"{name}: plan {plan}, not one warpgroup")
        before = int8_conv.launches
        out = int8_conv.int8_conv_dequant(x, w, inv_act, dq, **kw)
        torch.cuda.synchronize()
        check(int8_conv.launches == before + 1, f"{name}: kernel not launched")
        ref = int8_conv.reference_int8_conv_dequant(x, w, inv_act, dq, **kw)
        check(out.dtype == dt and out.shape == ref.shape,
              f"{name}: output {out.dtype} {tuple(out.shape)}")
        err = (out.float() - ref.float()).abs()
        tol = F32_TOL if dt == f32 else BF16_TOL
        bad = (err > tol + tol * ref.float().abs()).sum().item()
        max_err = err.max().item()
        print(f"int8 ragged stride dequant {name} s={s} [{_plan_tag(plan)}]: "
              f"max_abs_err {max_err:.3e} (tol {tol}) "
              f"{'ok' if bad == 0 and math.isfinite(max_err) else 'FAIL'}")
        check(bad == 0 and math.isfinite(max_err),
              f"ragged stride {name}: {bad} elements beyond tolerance")
        if name.startswith("conv1_bf16"):
            worst = max(worst, max_err)
        del x, w, out, ref, err

    # times at the stride shape: the conv1 form with a bias, bf16
    n, length, c, k, s = STRIDE_N, STRIDE_L, STRIDE_C, STRIDE_K, STRIDE_S
    x, w, inv_act, dq, bias, _ = _int8_dequant_inputs(gen, n, length, c, c,
                                                      k, bf16, dev)
    l_out = int8_conv.conv_geometry(length, k, 1, "same", s)[0]

    def kernel():
        return int8_conv.int8_conv_dequant(x, w, inv_act, dq, bias, stride=s)

    lib_out = library_strided_conv(x, w, inv_act, dq, bias, s)
    lib_err = (lib_out.float() - kernel().float()).abs().max().item()
    check(lib_err <= BF16_TOL * (1 + lib_out.float().abs().max().item()),
          f"stride library yardstick differs from the kernel by {lib_err}")
    launches_before = int8_conv.launches
    routes_before = dict(int8_conv.route_launches)
    # each input read once (bf16 x, s8 w, f32 dq and bias), the bf16 output
    # written once
    ops = 2.0 * n * l_out * c * k * c
    nbytes = 2 * n * length * c + k * c * c + 8 * c + 2 * n * l_out * c
    t_ops = ops / PEAK_INT8_OPS * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    plan = int8_conv.int8_plan(c, c, k, 1, "same", bf16, s)
    t = dict(ms=cuda_ms(kernel, iters=10),
             plain_ms=cuda_ms(lambda: int8_conv.reference_int8_conv_dequant(
                 x, w, inv_act, dq, bias, stride=s), iters=2, warmup=1),
             library_ms=cuda_ms(lambda: library_strided_conv(
                 x, w, inv_act, dq, bias, s), iters=5),
             library="torch._int_mm (strided im2col)",
             bound_ms=max(t_ops, t_bytes),
             bound_by="operations" if t_ops >= t_bytes else "bytes",
             max_abs_err=worst, plan=_plan_tag(plan),
             shape=f"N={n} L={length} C={c}->{c} k={k} SAME stride {s} "
                   f"bf16 bias")
    # timing launches are not the path
    int8_conv.launches = launches_before
    int8_conv.route_launches.clear()
    int8_conv.route_launches.update(routes_before)
    t["bound_share"] = t["bound_ms"] / t["ms"]
    print(f"timing int8 ragged stride conv {t['shape']} [{t['plan']}] on "
          f"{card}: kernel {t['ms']:.3f} ms, plain {t['plain_ms']:.3f} ms, "
          f"library {t['library_ms']:.3f} ms ({t['library']}), bound "
          f"{t['bound_ms']:.3f} ms ({t['bound_by']}), "
          f"{t['bound_share']:.1%} of the bound")
    return t


#: what the probes of each ragged kernel (``--ragged``) time, in order: the
#: staged kernel (weights restaged when a column block's taps do not fit)
#: and the resident one
RAGGED_PHASES = {
    "staged": ("CTA sync in", "x load", "weights + tile wait", "products",
               "s32 through shared", "epilogue"),
    "resident": ("x wait", "quantize", "products", "epilogue", "store"),
}


def build_ragged_probes():
    """``csrc/int8_conv.cu`` built with ``-DJT_RAGGED_CYCLES`` beside the
    plain build: the ragged kernels' clock64 probes."""
    from jaeger_tpu_torch.ops import cuda_build

    return cuda_build.load("int8_conv", extra_flags=("-DJT_RAGGED_CYCLES",))


def phase_ragged_cycles(card: str, lib) -> dict:
    """Cycles a tile by phase of the ragged route at the dvf and the stride
    shapes (the forms phases 10 and 11 time): the probe build launched
    through the same wrapper, three launches each; one thread of every CTA
    (of the staged kernel) or of every warpgroup (of the resident kernel,
    whose two warpgroups take tiles in turn) sums the clock64 cycles of
    each phase over its tiles. The probes' launches are not counted."""
    import ctypes

    import torch

    from jaeger_tpu_torch.ops import int8_conv

    fn = lib.jt_int8_conv
    fn.restype = ctypes.c_int
    fn.argtypes = int8_conv.ARGTYPES
    read = lib.jt_int8_ragged_cycles
    read.restype = ctypes.c_int
    read.argtypes = [ctypes.c_void_p]
    sums = (ctypes.c_ulonglong * 8)()
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(1313)
    bf16 = torch.bfloat16
    shapes = (("dvf", DVF_N, DVF_L, DVF_CIN, DVF_COUT, DVF_K, 1, "valid"),
              ("stride", STRIDE_N, STRIDE_L, STRIDE_C, STRIDE_C, STRIDE_K,
               STRIDE_S, "same"))
    saved = int8_conv._lib
    launches = int8_conv.launches
    routes = dict(int8_conv.route_launches)
    result = {}
    int8_conv._lib = lambda: fn
    try:
        for name, n, length, c_in, c_out, k, s, pad in shapes:
            x, w, inv_act, dq, bias, _ = _int8_dequant_inputs(
                gen, n, length, c_in, c_out, k, bf16, dev)

            def run():
                return int8_conv.int8_conv_dequant(x, w, inv_act, dq, bias,
                                                   padding=pad, stride=s)

            ref = run()
            torch.cuda.synchronize()
            check(read(sums) == 0, "ragged cycle probes: no probe build")
            ms = cuda_ms(run, iters=3, warmup=0)
            check(read(sums) == 0, "ragged cycle probes: read failed")
            check(torch.equal(run(), ref), f"{name}: probe runs differ")
            v = [int(c) for c in sums]
            tiles, probes = v[6], v[7]
            check(tiles > 0 and probes > 0, f"{name}: no probe counts")
            plan = int8_conv.int8_plan(c_in, c_out, k, 1, pad, bf16, s)
            kind = "resident" if plan["ring"] else "staged"
            per_tile = {ph: v[i] / tiles
                        for i, ph in enumerate(RAGGED_PHASES[kind])}
            probe_cycles = sum(v[:6]) / probes
            result[name] = dict(kernel=kind, plan=_plan_tag(plan),
                                cycles_per_tile=per_tile,
                                tiles_per_probe=tiles / probes,
                                probes=probes // 3,
                                probe_cycles_per_launch=probe_cycles,
                                ms_with_probes=ms,
                                implied_ghz=probe_cycles / (ms * 1e6))
            print(f"ragged cycles {name} [{kind}: {_plan_tag(plan)}] on "
                  f"{card}: {probes // 3} probes (CTAs or warpgroups), "
                  f"{tiles / probes:.1f} tiles each, a tile "
                  + ", ".join(f"{ph} {c:.0f}" for ph, c in per_tile.items())
                  + f" cycles; {ms:.3f} ms with the probes "
                  f"({probe_cycles / (ms * 1e6):.2f} GHz implied)")
            del x, w, ref
    finally:
        int8_conv._lib = saved
        int8_conv.launches = launches
        int8_conv.route_launches.clear()
        int8_conv.route_launches.update(routes)
    return result


def phase_int8_strided_predict(tmp: Path, card: str) -> dict:
    """A model whose residual stack opens with a ``strides: 2`` block (C
    128, k 5; seeded weights), its full_int8 bundle calibrated on the card
    by ``utils quantize``, then ``predict --int8`` on the test contigs in
    bf16 and f32 on the card and in f32 on the CPU (counts reset just
    before, read just after: int8_conv's ragged route launched by the
    strided convs); the card's f32 scores within 0.01 of the CPU's."""
    import torch

    from jaeger_tpu_torch import cli
    from jaeger_tpu_torch.models.artifacts import init_params, save_model
    from jaeger_tpu_torch.ops import int8_conv

    cfg = route_config(128, 5, strides=2)
    bundle = save_model(init_params(cfg, torch.Generator().manual_seed(130)),
                        cfg, tmp / "strided")
    cli.main(["utils", "quantize", "-m", str(bundle), "-o",
              str(tmp / "strided_int8"), "--mode", "full_int8"])
    labels = ["chromosome", "phage", "plasmid"]
    runs = {}
    # the main path: counts reset just before, read just after
    int8_conv.launches = 0
    int8_conv.route_launches.clear()
    t0 = time.perf_counter()
    for name, extra in (("bf16", []), ("f32", ["--precision", "float32"])):
        cli.main(["predict", "-i", str(FASTA), "-o", str(tmp / f"s_{name}"),
                  "-m", str(bundle), "--int8", "--fsize", "500", "--stride",
                  "500"] + extra)
        runs[name] = _read_tsv(tmp / f"s_{name}" /
                               "test_contigs_default_jaeger.tsv")
    dt = time.perf_counter() - t0
    launches = dict(int8_conv=int8_conv.launches,
                    **{r: int8_conv.route_launches[r]
                       for r in ("ragged", "wgmma", "mma")})
    check(launches["ragged"] > 0,
          f"strided predict --int8: launches {launches}")
    cli.main(["predict", "-i", str(FASTA), "-o", str(tmp / "s_cpu"), "-m",
              str(bundle), "--int8", "--fsize", "500", "--stride", "500",
              "--precision", "float32", "--device", "cpu"])
    runs["cpu_f32"] = _read_tsv(tmp / "s_cpu" /
                                "test_contigs_default_jaeger.tsv")
    for name, rows in runs.items():
        _check_tsv(rows, labels, f"strided predict --int8 {name}")
    diff = _max_score_diff(runs["f32"], runs["cpu_f32"], labels)
    check(diff <= 0.01, f"strided --int8: card f32 scores differ from the "
          f"CPU's by {diff}")
    print(f"predict --int8 strided bundle (C 128, k 5, stride 2) on {card}: "
          f"bf16 and f32 in {dt:.2f} s, kernel launches {launches}; card f32 "
          f"vs CPU f32 max score diff {diff:.2e} (tol 0.01)")
    return dict(launches=launches, score_diff_f32=diff, seconds=dt)


def _tsv_row_diffs(got: Path, want: Path) -> list[str]:
    """The rows of two TSVs that differ, each with both values."""
    a = got.read_text().splitlines()
    b = want.read_text().splitlines()
    out = [f"line count {len(a)} vs {len(b)}"] if len(a) != len(b) else []
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            out.append(f"line {i}: card {x!r} / cpu {y!r}")
    return out


def phase_legacy(tmp: Path, card: str) -> dict:
    """The legacy ``default`` model (the shipped bundle): ``predict -m
    default`` and ``predict-legacy`` on the test contigs on the card, each
    TSV byte-identical to the same command's with ``--device cpu`` (else
    the rows that differ are printed with both values and the phase
    fails); the WRes forward's logits and embeddings on the card against
    the CPU's on the test contigs' first 128 windows (F32_TOL of the
    scale); the forward's windows/s at batch 128 and 1024 (CUDA events,
    tokens encoded beforehand) and the wall time of each command."""
    import numpy as np
    import torch

    from jaeger_tpu_torch import cli
    from jaeger_tpu_torch.commands.predict_legacy import (DEFAULT_MODEL_DIR,
                                                          load_legacy_model)
    from jaeger_tpu_torch.ops import fused_conv, int8_conv
    from jaeger_tpu_torch.seqops.windows import window_batches

    fused_conv.launches = 0
    int8_conv.launches = 0
    commands = {
        "predict": ["predict", "-i", str(FASTA), "-m", "default"],
        "predict-legacy": ["predict-legacy", "-i", str(FASTA)],
    }
    results = {}
    for name, args in commands.items():
        walls = {}
        for dev in ("cuda", "cpu"):
            out = tmp / f"legacy_{name}_{dev}"
            t0 = time.perf_counter()
            cli.main(args + ["-o", str(out), "--device", dev])
            walls[dev] = time.perf_counter() - t0
        diffs = []
        for tsv in ("test_contigs_default_jaeger.tsv",
                    "test_contigs_default_phages_jaeger.tsv"):
            diffs += _tsv_row_diffs(tmp / f"legacy_{name}_cuda" / tsv,
                                    tmp / f"legacy_{name}_cpu" / tsv)
        for d in diffs:
            print(f"legacy {name}: {d}")
        check(not diffs, f"legacy {name}: card TSVs differ from the CPU's")
        rows = _read_tsv(tmp / f"legacy_{name}_cuda" /
                         "test_contigs_default_jaeger.tsv")
        check(len(rows) == 9, f"legacy {name}: {len(rows)} rows")
        results[name] = dict(wall_s_card=walls["cuda"],
                             wall_s_cpu=walls["cpu"])
        print(f"legacy {name} -m default on {card}: TSVs byte-identical to "
              f"--device cpu; wall {walls['cuda']:.2f} s on the card, "
              f"{walls['cpu']:.2f} s on the CPU")
    check(fused_conv.launches == 0 and int8_conv.launches == 0,
          "the legacy path launched a hand kernel")

    models = {dev: load_legacy_model(DEFAULT_MODEL_DIR, device=dev)
              for dev in ("cuda", "cpu")}
    encode = models["cpu"][1]
    wb = next(window_batches(str(FASTA), fragsize=2048, stride=2048))
    b, ln = wb.bases[:128], wb.length[:128]
    outs = {}
    with torch.inference_mode():
        for dev, (m, _) in models.items():
            toks = encode(torch.from_numpy(b).to(dev),
                          torch.from_numpy(ln).to(dev), 2048)
            o = m(toks)
            outs[dev] = {k: o[k].float().cpu() for k in ("output",
                                                         "embedding")}
    errs = {}
    for k, ref in outs["cpu"].items():
        errs[k] = float((outs["cuda"][k] - ref).abs().max())
        tol = F32_TOL * max(float(ref.abs().max()), 1.0)
        check(errs[k] <= tol, f"legacy WRes {k}: card differs from the CPU "
              f"by {errs[k]} (tol {tol})")
    rates = {}
    rng = np.random.default_rng(140)
    model = models["cuda"][0]
    with torch.inference_mode():
        for bs in (128, 1024):
            bases = torch.from_numpy(rng.integers(0, 4, size=(bs, 2048))
                                     .astype(np.uint8)).cuda()
            lengths = torch.full((bs,), 2048, dtype=torch.int32,
                                 device="cuda")
            toks = encode(bases, lengths, 2048)
            ms = cuda_ms(lambda: model(toks), iters=5 if bs > 128 else 20,
                         warmup=1)
            rates[bs] = dict(ms=ms, windows_per_s=bs / ms * 1e3)
    print(f"legacy WRes forward on {card}: card vs CPU max_abs_err logits "
          f"{errs['output']:.2e}, embeddings {errs['embedding']:.2e} "
          f"(tol {F32_TOL} of the scale); f32 at fsize 2048: batch 128 "
          f"{rates[128]['ms']:.2f} ms ({rates[128]['windows_per_s']:.0f} "
          f"windows/s), batch 1024 {rates[1024]['ms']:.2f} ms "
          f"({rates[1024]['windows_per_s']:.0f} windows/s)")
    return dict(commands=results, max_abs_err=errs,
                forward={str(k): v for k, v in rates.items()})


# --- phase 12: health, the model registry, taxonomy, the data commands ------

#: phase 12's taxonomy: phase 7's assembly is the reference set; the query
#: is 100 contigs of another seed, renamed, then the reference's first 50;
#: the card is held against the CPU on the first 6 contigs of each
TAX_QUERY_NEW = 100
TAX_QUERY_SELF = 50
TAX_CPU_CONTIGS = 6
#: the batch of that comparison (the CPU computes every row of a padded
#: batch: 185 windows at batch 2048 took as long as 2,048)
TAX_CPU_BATCH = 64
TAX_SPECIES, TAX_GENERA, TAX_FAMILIES = 75, 15, 3
TAX_K = 5


def _cli_out(argv) -> str:
    """The port's CLI in this process -> what it printed (echoed too)."""
    import io

    from jaeger_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main([str(a) for a in argv])
    sys.stdout.write(buf.getvalue())
    return buf.getvalue()


def _fasta_records(path: Path) -> list[bytes]:
    """The records of a FASTA, each with its header line."""
    data = path.read_bytes()
    return [b">" + r.rstrip(b"\n") + b"\n" for r in data[1:].split(b"\n>")]


def write_taxdump(root: Path, n_contigs: int, seed: int = 31) -> tuple:
    """A seeded taxdump over the contigs ``ctg_<i>``: 3 families, 15
    genera (genus g in family g % 3), 75 species (species s in genus
    s % 15), each contig given a species drawn from ``seed``. Returns
    (acc2taxid TSV, taxdump directory)."""
    import numpy as np

    dump = root / "taxdump"
    dump.mkdir(parents=True)
    nodes = ["1\t|\t1\t|\tno rank\t|"]
    names = ["1\t|\troot\t|\t\t|\tscientific name\t|"]

    def node(taxid, parent, rank, name):
        nodes.append(f"{taxid}\t|\t{parent}\t|\t{rank}\t|")
        names.append(f"{taxid}\t|\t{name}\t|\t\t|\tscientific name\t|")

    for f in range(TAX_FAMILIES):
        node(10 + f, 1, "family", f"Family{f}")
    for g in range(TAX_GENERA):
        node(100 + g, 10 + g % TAX_FAMILIES, "genus", f"Genus{g}")
    for s in range(TAX_SPECIES):
        node(1000 + s, 100 + s % TAX_GENERA, "species", f"Genus{s % TAX_GENERA} "
             f"species{s}")
    (dump / "nodes.dmp").write_text("\n".join(nodes) + "\n")
    (dump / "names.dmp").write_text("\n".join(names) + "\n")
    species = np.random.default_rng(seed).integers(0, TAX_SPECIES,
                                                    size=n_contigs)
    acc = root / "acc2taxid.tsv"
    acc.write_text("".join(f"ctg_{i}\t{1000 + int(s)}\n"
                           for i, s in enumerate(species)))
    return acc, dump


@contextlib.contextmanager
def capture_search(store: list):
    """Record every ``CosineIndex.search`` a command makes: the index, the
    queries, the device, the mesh (None on one card) and what the search
    returned."""
    from jaeger_tpu_torch.commands import taxonomy

    real = taxonomy.CosineIndex.search

    def spy(self, queries, k=5, device=None, mesh=None):
        scores, idx = real(self, queries, k=k, device=device, mesh=mesh)
        store.append(dict(index=self, queries=queries, device=device,
                          mesh=mesh, scores=scores, idx=idx))
        return scores, idx

    taxonomy.CosineIndex.search = spy
    try:
        yield store
    finally:
        taxonomy.CosineIndex.search = real


def _taxonomy_run(tax: Path, bundle: Path, ref: Path, acc: Path, dump: Path,
                  query: Path, tag: str, extra: list,
                  batch: int = 2048) -> dict:
    """``taxonomy build`` then ``taxonomy predict`` through the CLI at
    ``batch``, each with the kernel counts reset just before and read just
    after."""
    import torch

    from jaeger_tpu_torch.ops import fused_conv, int8_conv

    common = ["-m", bundle, "--fsize", "1505", "--batch", str(batch),
              *extra]
    out = {}
    for step in ("build", "predict"):
        fused_conv.launches = int8_conv.launches = 0
        captured: list = []
        t0 = time.perf_counter()
        if step == "build":
            _cli_out(["taxonomy", "build", "-i", ref, "-a", acc, "-t", dump,
                      "-o", tax / f"db_{tag}", *common])
        else:
            with capture_search(captured):
                _cli_out(["taxonomy", "predict", "-d", tax / f"db_{tag}",
                          "-i", query, "-o", tax / f"{tag}.tsv", *common])
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        out[f"{step}_s"] = time.perf_counter() - t0
        out[f"{step}_launches"] = fused_conv.launches
        out[f"{step}_int8_launches"] = int8_conv.launches
        if step == "predict":
            check(len(captured) == 1, f"taxonomy {tag}: {len(captured)} "
                                      f"searches")
            out["search"] = captured[0]
    out["index_windows"] = json.loads(
        (tax / f"db_{tag}" / "taxdb.json").read_text())["windows"]
    out["rows"] = _read_tsv(tax / f"{tag}.tsv")
    out["query_windows"] = sum(int(r["n_windows"]) for r in out["rows"])
    return out


def _check_launches(run: dict, tag: str, on_card: bool) -> None:
    for step in ("build", "predict"):
        n = run[f"{step}_launches"]
        ok = n > 0 and n % 6 == 0 if on_card else n == 0
        check(ok and run[f"{step}_int8_launches"] == 0,
              f"taxonomy {step} {tag}: {n} fused_conv_block and "
              f"{run[f'{step}_int8_launches']} int8_conv launches")


def phase_commands(tmp: Path, card: str, bundle: Path) -> dict:
    """``health``, the model registry, ``taxonomy build|predict`` at the
    flagship's width and ``utils optimize-data`` feeding ``train``."""
    import os

    import numpy as np
    import torch
    import yaml

    from jaeger_tpu_torch.commands.train import train_fragment_core
    from jaeger_tpu_torch.ops import fused_conv
    from jaeger_tpu_torch.utils.config import load_model_config

    res: dict = {}
    # 1. health on the card, in its own process
    proc = subprocess.run(
        [sys.executable, "-m", "jaeger_tpu_torch.cli", "health"], cwd=ROOT,
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, JAEGER_TPU_HOME=str(tmp / "home")))
    lines = [ln.strip() for ln in proc.stdout.splitlines()]
    device = [ln for ln in lines if ln.startswith("device   :")]
    check(proc.returncode == 0 and lines and lines[-1] == "health: OK",
          f"health exited {proc.returncode}: {proc.stdout[-3000:]}"
          f"{proc.stderr[-3000:]}")
    check(device and torch.cuda.get_device_name(0) in device[0],
          f"health's device line {device}")
    print(f"health on the card: OK ({device[0]})")

    # 2. the registry: a registered name predicts as its path does
    reg = tmp / "registry.json"
    _cli_out(["register-models", "-p", bundle, "-c", reg])
    name = load_model_config(bundle / "project.yaml")["model"]["name"]
    listed = _cli_out(["list-models", "--config", reg])
    check(listed.startswith(f"{name}\t"), f"list-models: {listed!r}")
    common = ["-i", FASTA, "--fsize", "1505", "--batch", "2048"]
    fused_conv.launches = 0
    _cli_out(["predict", "-o", tmp / "by_name", "-m", name, "--config", reg,
              *common])
    res["registry_launches"] = fused_conv.launches
    check(res["registry_launches"] > 0 and res["registry_launches"] % 6 == 0,
          f"predict -m {name}: {res['registry_launches']} launches")
    _cli_out(["predict", "-o", tmp / "by_path", "-m", bundle, *common])
    tsv = "test_contigs_default_jaeger.tsv"
    check((tmp / "by_name" / tsv).read_bytes()
          == (tmp / "by_path" / tsv).read_bytes(),
          "predict -m <registered name> differs from -m <path>")
    print(f"registry: predict -m {name} --config <registry> byte-identical "
          f"to -m <path>, {res['registry_launches']} fused_conv_block "
          f"launches")

    # 3. taxonomy at the flagship's width
    tax = tmp / "taxonomy"
    tax.mkdir()
    ref = tax / "reference.fasta"
    ref_bases = write_synthetic_fasta(ref, BIG_CONTIGS)
    recs = _fasta_records(ref)
    write_synthetic_fasta(tax / "new.fasta", TAX_QUERY_NEW, seed=29)
    new = [r.replace(b">ctg_", b">qry_", 1)
           for r in _fasta_records(tax / "new.fasta")]
    query = tax / "query.fasta"
    query.write_bytes(b"".join(new + recs[:TAX_QUERY_SELF]))
    acc, dump = write_taxdump(tax, len(recs))
    bf = _taxonomy_run(tax, bundle, ref, acc, dump, query, "bf16", [])
    _check_launches(bf, "bf16", True)
    check(len(bf["rows"]) == TAX_QUERY_NEW + TAX_QUERY_SELF,
          f"taxonomy predict: {len(bf['rows'])} rows")
    check(all(math.isfinite(float(r["mean_knn_similarity"]))
              for r in bf["rows"]), "taxonomy predict: a similarity is not "
                                    "finite")
    s = bf["search"]
    q = np.asarray(s["queries"])
    s["index"].search(q, TAX_K, device=s["device"])
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        s["index"].search(q, TAX_K, device=s["device"])
        times.append((time.perf_counter() - t0) * 1e3)
    search_ms = sorted(times)[2]
    res["taxonomy"] = dict(
        reference_bases=ref_bases, index_windows=bf["index_windows"],
        query_windows=bf["query_windows"],
        build_windows_per_s=bf["index_windows"] / bf["build_s"],
        predict_windows_per_s=bf["query_windows"] / bf["predict_s"],
        build_s=bf["build_s"], predict_s=bf["predict_s"],
        search_ms=search_ms, search_shape=[int(q.shape[0]),
                                           bf["index_windows"], TAX_K],
        build_launches=bf["build_launches"],
        predict_launches=bf["predict_launches"])
    print(f"taxonomy build (bf16, batch 2048) on {card}: {bf['index_windows']}"
          f" windows of {ref_bases / 1e6:.1f} Mb in {bf['build_s']:.2f} s = "
          f"{res['taxonomy']['build_windows_per_s']:,.0f} windows/s, "
          f"{bf['build_launches']} fused_conv_block launches; predict: "
          f"{bf['query_windows']} windows in {bf['predict_s']:.2f} s = "
          f"{res['taxonomy']['predict_windows_per_s']:,.0f} windows/s, "
          f"{bf['predict_launches']} launches; search {search_ms:.2f} ms "
          f"for {q.shape[0]} queries x {bf['index_windows']} index rows, "
          f"k {TAX_K} (host clock, median of 5, with the copies)")

    # f32: every self-query window finds itself first
    f32 = _taxonomy_run(tax, bundle, ref, acc, dump, query, "f32",
                        ["--precision", "float32"])
    _check_launches(f32, "f32", True)
    n_self = sum(int(r["n_windows"]) for r in f32["rows"]
                 if r["contig_id"].startswith("ctg_"))
    scores, idx = f32["search"]["scores"], f32["search"]["idx"]
    self_s, self_i = scores[-n_self:], idx[-n_self:]
    hits = int((self_i[:, 0] == np.arange(n_self)).sum())
    check(hits == n_self and float(self_s[:, 0].min()) >= 1 - 1e-5,
          f"f32 self queries: {hits}/{n_self} find themselves first, "
          f"lowest top score {self_s[:, 0].min()}")
    res["taxonomy"]["f32_self_windows"] = n_self
    print(f"taxonomy f32: all {n_self} self-query windows find themselves "
          f"first (lowest score {self_s[:, 0].min():.7f}); build "
          f"{f32['index_windows'] / f32['build_s']:,.0f} windows/s")

    # f32 on the card against the CPU, on the first contigs of each set
    (tax / "ref_cpu.fasta").write_bytes(b"".join(recs[:TAX_CPU_CONTIGS]))
    (tax / "q_cpu.fasta").write_bytes(b"".join(new[:TAX_CPU_CONTIGS]))
    runs = {}
    for tag, extra in (("card_f32", []), ("cpu_f32", ["--cpu"])):
        runs[tag] = _taxonomy_run(tax, bundle, tax / "ref_cpu.fasta", acc,
                                  dump, tax / "q_cpu.fasta", tag,
                                  ["--precision", "float32", *extra],
                                  batch=TAX_CPU_BATCH)
        _check_launches(runs[tag], tag, tag == "card_f32")
        sr = runs[tag]["search"]
        # one neighbour more, to see the gap after the k-th
        runs[tag]["s6"], runs[tag]["i6"] = sr["index"].search(
            sr["queries"], TAX_K + 1, device=sr["device"])
    card_rows, cpu_rows = runs["card_f32"]["rows"], runs["cpu_f32"]["rows"]
    check(len(card_rows) == len(cpu_rows) == TAX_CPU_CONTIGS,
          f"card / CPU rows {len(card_rows)} / {len(cpu_rows)}")
    worst = 0.0
    for a, b in zip(card_rows, cpu_rows):
        for key in ("contig_id", "taxid", "rank", "name", "lineage",
                    "n_windows"):
            check(a[key] == b[key], f"taxonomy card vs CPU: {key} "
                                    f"{a[key]!r} != {b[key]!r}")
        worst = max(worst, abs(float(a["mean_knn_similarity"])
                               - float(b["mean_knn_similarity"])))
    check(worst <= 1e-4, f"mean_knn_similarity card vs CPU: {worst}")
    s6, i6 = runs["card_f32"]["s6"], runs["card_f32"]["i6"]
    c6 = runs["cpu_f32"]["i6"]
    gaps = np.abs(np.diff(s6, axis=1))              # (n, k): p to p+1
    before = np.concatenate([np.full((len(s6), 1), np.inf), gaps], axis=1)
    clear = np.minimum(before[:, :TAX_K], gaps[:, :TAX_K]) > 1e-5
    same = (i6[:, :TAX_K] == c6[:, :TAX_K])
    check(bool(same[clear].all()), f"neighbour lists card vs CPU: "
                                   f"{int((~same & clear).sum())} differ")
    score_diff = float(np.abs(s6[:, :TAX_K]
                              - runs["cpu_f32"]["s6"][:, :TAX_K])[clear].max())
    res["taxonomy"].update(cpu_windows=runs["card_f32"]["query_windows"],
                           cpu_max_similarity_diff=worst,
                           cpu_max_score_diff=score_diff,
                           cpu_neighbours_compared=int(clear.sum()),
                           cpu_neighbours_tied=int((~clear).sum()),
                           cpu_s=runs["cpu_f32"]["build_s"]
                           + runs["cpu_f32"]["predict_s"])
    print(f"taxonomy f32 card vs CPU ({TAX_CPU_CONTIGS} + {TAX_CPU_CONTIGS} "
          f"contigs, {runs['card_f32']['query_windows']} query windows): "
          f"taxid, rank, name, lineage, n_windows equal; similarity within "
          f"{worst:.2e} (TSV), neighbour scores within {score_diff:.2e}; "
          f"{int(clear.sum())} neighbours equal, "
          f"{int((~clear).sum())} within 1e-5 of a neighbour not compared; "
          f"CPU {res['taxonomy']['cpu_s']:.1f} s")
    res["launches"] = (res["registry_launches"] + bf["build_launches"]
                       + bf["predict_launches"] + f32["build_launches"]
                       + f32["predict_launches"]
                       + runs["card_f32"]["build_launches"]
                       + runs["card_f32"]["predict_launches"])

    # 4. utils optimize-data feeds train
    opt = tmp / "optimize"
    opt.mkdir()
    data = write_train_data(opt, seed=20261018, crop_nt=1505, n_rows=1024)
    npz = {}
    t0 = time.perf_counter()
    for split in ("train", "val"):
        npz[split] = opt / f"{split}.npz"
        _cli_out(["utils", "optimize-data", "-i", data[split], "-o",
                  npz[split], "--crop-size", "1505", "--num-classes", "6"])
    opt_s = time.perf_counter() - t0
    cfg = load_model_config(TEMPLATE)
    cfg["model"]["string_processor"]["data_format"] = "numpy"
    tcfg = cfg["training"]
    tcfg.update(classifier_epochs=1, classifier_train_steps=1,
                classifier_validation_steps=1, reliability_epochs=0)
    classes = ["bacteria", "phage", "eukarya", "archaea", "virus", "plasmid"]
    tcfg["fragment_classifier_data"] = {
        split: [{"class": classes, "path": [str(npz[key])],
                 "label": list(range(6))}]
        for split, key in (("train", "train"), ("validation", "val"))}
    cfg_path = opt / "train.yaml"
    cfg_path.write_text(yaml.safe_dump(cfg, sort_keys=False))
    results = train_fragment_core(str(cfg_path), str(opt / "run"))
    losses = [h["loss"] for h in results["history"]["classifier"]]
    check(len(losses) == 1 and math.isfinite(losses[0]),
          f"train on optimize-data's NPZ: losses {losses}")
    check((opt / "run" / "params.msgpack").exists(),
          "train on optimize-data's NPZ wrote no bundle")
    res["optimize_data_s"] = opt_s
    print(f"utils optimize-data: 1024 + 512 rows in {opt_s:.2f} s; train "
          f"took a step on its NPZ (loss {losses[0]:.4f})")
    return res


# --- phase 13: the projection pretraining and reliability-data generation --

#: the projection head phase 13 adds to the flagship template (no template
#: in the repo ships one): dense 128 relu, then dense 64, margin 0.5, scale 30
PROJECTION_HEAD = {"margin": 0.5, "scale": 30.0, "hidden_layers": [
    {"name": "dense", "config": {"units": 128, "activation": "relu"}},
    {"name": "dense", "config": {"units": 64}}]}
#: rows of the raw CSV the generator classifies inside ``train``, and of the
#: one it classifies on the card and on the CPU
RELGEN_ROWS, RELGEN_CHECK_ROWS = 4096, 128
#: the first of them: rows 1984-2111 hold the block with interior Ns
RELGEN_CHECK_START = 1984
#: the batch of the card / CPU generator runs (the CPU computes every row
#: of a padded batch)
RELGEN_CHECK_BATCH = 64
PROJECTION_EPOCHS, PROJECTION_STEPS = 2, 10


def _kernel_counts() -> dict:
    from jaeger_tpu_torch.ops import fused_conv, int8_conv
    from jaeger_tpu_torch.ops import fused_conv_grad as fg

    return dict(fg.launches, fused_conv_block=fused_conv.launches,
                int8_conv=int8_conv.launches)


def _reset_kernel_counts() -> None:
    from jaeger_tpu_torch.ops import fused_conv, int8_conv
    from jaeger_tpu_torch.ops import fused_conv_grad as fg

    fused_conv.launches = 0
    int8_conv.launches = 0
    for k in fg.launches:
        fg.launches[k] = 0
    fused_conv.route_launches.clear()
    fg.wgrad_route_launches.clear()


def pretrain_narrow_config() -> dict:
    """Phase 6a's narrow template with a narrow projection head (dense 16
    relu, then dense 8)."""
    cfg = narrow_train_config()
    cfg["model"]["projection"] = {"margin": 0.5, "scale": 30.0,
                                  "hidden_layers": [
        {"name": "dense", "config": {"units": 16, "activation": "relu"}},
        {"name": "dense", "config": {"units": 8}}]}
    return cfg


def phase_pretrain_step_f32() -> float:
    """13a. One f32 projection step of the narrow template on the card
    against the same step on the CPU: the same seeded weights, ArcFace
    ``class_weights`` and masked batch; the ArcFace loss within 1e-4 and
    every gradient leaf, ``arcface/class_weights`` included, within 1e-4
    of its scale (a leaf below 1e-4 of the largest gradient is held at
    1e-4 of the largest, as phase 6a does). TF32 is off. The card's step
    must launch every backward kernel."""
    import copy

    import numpy as np
    import torch

    from jaeger_tpu_torch.commands.train import (make_projection_step,
                                                 projection_params)
    from jaeger_tpu_torch.models.artifacts import init_params, load_state
    from jaeger_tpu_torch.models.builder import build_model
    from jaeger_tpu_torch.train.loop import to_device
    from jaeger_tpu_torch.train.losses import ArcFaceLoss
    from jaeger_tpu_torch.train.optimizers import make_optimizer

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = pretrain_narrow_config()
    tcfg = cfg["training"]
    rng = np.random.default_rng(29)
    batch = None
    runs = {}
    for dev in ("cuda", "cpu"):
        model = build_model(copy.deepcopy(cfg))
        load_state(model, init_params(cfg, torch.Generator().manual_seed(5)))
        model.to(dev).train()
        if batch is None:
            batch = _train_batch(rng, model.crop_nt, "masked", 8, 6)
        arcface = ArcFaceLoss(6, 8, margin=0.5, scale=30.0,
                              generator=torch.Generator().manual_seed(6))
        arcface.to(dev)
        tx = make_optimizer(tcfg["optimizer"], tcfg["optimizer_params"])
        opt_state = tx.init({k: p.detach() for k, p in
                             projection_params(model, arcface).items()})
        step = make_projection_step(model, arcface, tx,
                                    tuple(model.regularizer_specs()))
        before = _kernel_counts()
        _, loss = step(opt_state, to_device(batch, dev))
        if dev == "cuda":
            torch.cuda.synchronize()
            added = {k: v - before[k] for k, v in _kernel_counts().items()
                     if k != "int8_conv"}
            check(all(v > 0 for v in added.values()),
                  f"f32 projection step: launches {added}")
        runs[dev] = dict(loss=float(loss), grads={
            k: v.float().cpu() for k, v in step.grads.items()})
    gpu, cpu = runs["cuda"], runs["cpu"]
    check(math.isfinite(cpu["loss"]) and abs(gpu["loss"] - cpu["loss"])
          <= 1e-4 * max(abs(cpu["loss"]), 1.0),
          f"f32 projection step: loss {gpu['loss']} vs {cpu['loss']}")
    check("arcface/class_weights" in cpu["grads"],
          "f32 projection step: no ArcFace gradient")
    overall = max(float(g.abs().max()) for g in cpu["grads"].values())
    worst = 0.0
    for k, g in cpu["grads"].items():
        scale = max(float(g.abs().max()), 1e-12)
        if scale < 1e-4 * overall:
            scale = overall
        e = float((gpu["grads"][k] - g).abs().max()) / scale
        check(e <= 1e-4, f"f32 projection step: grad {k} rel err {e:.2e}")
        worst = max(worst, e)
    print(f"projection step f32 (narrow template, card vs CPU): ArcFace "
          f"loss {gpu['loss']:.6f} vs {cpu['loss']:.6f}, worst grad err "
          f"{worst:.2e} of its scale over {len(cpu['grads'])} leaves "
          f"(tol 1e-4) ok")
    return worst


def pretrain_train_config(root: Path, data: dict, raw: str) -> Path:
    """The flagship template with ``PROJECTION_HEAD``, 2 x 10 projection
    steps, 1 x 10 classifier steps, 1 x 4 reliability steps on generated
    data (the raw CSV ``raw``, inference batch 512, multiplier 1.0,
    thresholds 0: every real row and every synthetic row kept, so the
    generated data has a known size), 2 validation steps and a 1024-row
    shuffle buffer; the model, batch 256, bf16, the optimizer, losses and
    callbacks as the template has them."""
    import copy

    import yaml

    from jaeger_tpu_torch.utils.config import load_model_config

    cfg = load_model_config(TEMPLATE)
    t = cfg["training"]
    cfg["model"]["string_processor"]["buffer_size"] = 1024
    cfg["model"]["projection"] = copy.deepcopy(PROJECTION_HEAD)
    t.update(projection_epochs=PROJECTION_EPOCHS,
             classifier_epochs=1, classifier_train_steps=PROJECTION_STEPS,
             classifier_validation_steps=2, reliability_epochs=1,
             reliability_train_steps=4, reliability_validation_steps=2)
    classes = ["bacteria", "phage", "eukarya", "archaea", "virus", "plasmid"]
    t["fragment_classifier_data"] = {
        "train": [{"class": classes, "path": [data["train"]],
                   "label": list(range(6))}],
        "validation": [{"class": classes, "path": [data["val"]],
                        "label": list(range(6))}]}
    t.pop("fragment_reliability_data", None)
    t["reliability_data_generation"] = {
        "raw_csv_paths": {"train": raw}, "inference_batch_size": 512,
        "synthetic_ood_multiplier": 1.0, "id_threshold": 0.0,
        "synthetic_ood_threshold": 0.0}
    path = root / "pretrain_train.yaml"
    path.write_text(yaml.safe_dump(cfg, sort_keys=False))
    return path


@contextlib.contextmanager
def _patched(patches: dict):
    """Module attributes replaced for the block: ``{(module, name): fn}``."""
    saved = {key: getattr(*key) for key in patches}
    for (mod, name), fn in patches.items():
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for (mod, name), fn in saved.items():
            setattr(mod, name, fn)


def phase_pretrain_flagship(tmp: Path, card: str) -> dict:
    """13b. ``train_fragment_core`` with the flagship template at full width
    (``pretrain_train_config``: batch 256, bf16) with
    ``self_supervised_pretraining`` and ``generate_reliability`` on seeded
    synthetic CSVs with N runs: 2 x 10 projection steps, 10 classifier
    steps, reliability data generated from a 4,096-row raw CSV, 4
    reliability steps, the export. The kernel launch counts are set to 0
    just before each stage (``_train_projection``, ``_run_branch``,
    ``_generate_reliability``) and read just after: the projection stage
    launches 18 / 6 / 6 (``fused_conv_block`` / ``conv_wgrad`` /
    ``conv_epilogue_bwd``) a step, as a dense classifier step does, and the
    generator 6 ``fused_conv_block`` a forward and no backward kernel. The
    ArcFace loss is finite and falls; the bundle carries the projection
    leaves. Then the projection step's steady state and the generator's
    rate, and ``predict`` on the bundle."""
    import numpy as np
    import torch

    import jaeger_tpu_torch.commands.train as train_cmd
    import jaeger_tpu_torch.dataops.reliability_generator as relgen
    from jaeger_tpu_torch import cli
    from jaeger_tpu_torch.models.artifacts import read_flax_msgpack

    crop_nt = 1505
    root = tmp / "pretrain"
    (root / "raw").mkdir(parents=True)
    t0 = time.perf_counter()
    data = write_train_data(root, seed=20261017, crop_nt=crop_nt)
    raw = write_train_data(root / "raw", seed=20261018, crop_nt=crop_nt,
                           n_rows=RELGEN_ROWS)["train"]
    cfg_path = pretrain_train_config(root, data, raw)
    data_s = time.perf_counter() - t0

    stages: dict = {}
    forwards: list = []
    host: dict = {"synthetic_s": 0.0, "classify_s": 0.0}

    def staged(name_of, fn):
        def run(*a, **kw):
            name = name_of(a)
            _reset_kernel_counts()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            stages[name] = dict(launches=_kernel_counts(),
                                s=time.perf_counter() - t0)
            return out
        return run

    def timed(key, fn, count=False):
        def run(*a, **kw):
            if count:
                rows, bs = a[1], kw.get("batch_size", a[3] if len(a) > 3
                                        else 512)
                forwards.append(-(-len(rows) // bs))
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            host[key] += time.perf_counter() - t0
            return out
        return run

    out = root / "trained"
    torch.cuda.reset_peak_memory_stats()
    with _patched({
            (train_cmd, "_train_projection"): staged(
                lambda a: "projection", train_cmd._train_projection),
            (train_cmd, "_run_branch"): staged(
                lambda a: a[0], train_cmd._run_branch),
            (train_cmd, "_generate_reliability"): staged(
                lambda a: "generation", train_cmd._generate_reliability),
            (relgen, "_predict_csv_rows"): timed(
                "classify_s", relgen._predict_csv_rows, count=True),
            (relgen, "generate_synthetic_sequences"): timed(
                "synthetic_s", relgen.generate_synthetic_sequences)}):
        t0 = time.perf_counter()
        results = train_cmd.train_fragment_core(
            str(cfg_path), str(out), self_supervised_pretraining=True,
            generate_reliability=True)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(set(stages) == {"projection", "classifier", "generation",
                          "reliability"}, f"stages run: {sorted(stages)}")
    hist = results["history"]
    proj = [h["loss"] for h in hist.get("projection", [])]
    check(len(proj) == PROJECTION_EPOCHS
          and all(math.isfinite(v) for v in proj),
          f"projection history {proj}")
    check(proj[-1] < proj[0], f"ArcFace loss did not fall: {proj}")
    for branch in ("classifier", "reliability"):
        losses = [h["loss"] for h in hist.get(branch, [])]
        check(len(losses) == 1 and math.isfinite(losses[0]),
              f"{branch} history {losses}")
    steps = PROJECTION_EPOCHS * PROJECTION_STEPS
    want = {"fused_conv_block": 18 * steps, "conv_wgrad": 6 * steps,
            "conv_epilogue_bwd": 6 * steps, "int8_conv": 0}
    check(stages["projection"]["launches"] == want,
          f"projection stage launches {stages['projection']['launches']}, "
          f"expected {want} (18 / 6 / 6 a step)")
    n_fwd = sum(forwards)
    gen = stages["generation"]["launches"]
    check(n_fwd > 0 and gen == {"fused_conv_block": 6 * n_fwd,
                                "conv_wgrad": 0, "conv_epilogue_bwd": 0,
                                "int8_conv": 0},
          f"generation launches {gen} for {n_fwd} forwards")
    gen_dir = out / "reliability_data"
    n_rel = sum(len((gen_dir / f).read_text().splitlines())
                for f in ("reliability_train.csv", "reliability_val.csv"))
    check(n_rel == 2 * RELGEN_ROWS,
          f"generated {n_rel} reliability rows, expected {2 * RELGEN_ROWS}")
    tree = read_flax_msgpack(out / "params.msgpack")
    check(set(tree["params"].get("projection", {})) == {"dense_0",
                                                        "dense_1"},
          "the bundle has no projection leaves")
    check((out / "checkpoints" / "projection" / "converged.json").exists(),
          "no projection convergence marker")
    gen_s = stages["generation"]["s"]
    print(f"pretrain flagship template (batch 256, bf16) on {card}: "
          f"{train_s:.1f} s in all (data {data_s:.1f} s), ArcFace losses "
          + " ".join(f"{v:.4f}" for v in proj)
          + f", classifier loss {hist['classifier'][0]['loss']:.4f}, "
          f"reliability loss {hist['reliability'][0]['loss']:.4f}, peak "
          f"device memory {peak_gb:.2f} GB")
    for name, st in stages.items():
        print(f"  stage {name}: {st['s']:.2f} s, launches {st['launches']}")
    print(f"  generation in train: {RELGEN_ROWS} raw rows in {gen_s:.2f} s "
          f"({RELGEN_ROWS / gen_s:.0f} rows/s), {n_fwd} forwards of 512; "
          f"host: synthetic sequences {host['synthetic_s']:.2f} s, "
          f"classification {host['classify_s']:.2f} s")
    res = dict(stages=stages, projection_losses=proj, train_s=train_s,
               peak_gb=peak_gb, generation_forwards=n_fwd,
               generation_in_train_s=gen_s, relgen_host=dict(host))
    res.update(_pretrain_rates(out, cfg_path, raw, root, card))

    _reset_kernel_counts()
    cli.main(["predict", "-i", str(FASTA), "-o", str(root / "predict"),
              "-m", str(out), "--fsize", "1505", "--batch", "256"])
    res["predict_launches"] = _kernel_counts()["fused_conv_block"]
    labels = ["bacteria", "phage", "eukarya", "archaea", "virus", "plasmid"]
    tsv = root / "predict" / "test_contigs_default_jaeger.tsv"
    _check_tsv(_read_tsv(tsv), labels, "predict on the pretrained bundle")
    check(res["predict_launches"] > 0,
          "predict on the pretrained bundle launched no fused_conv_block")
    print(f"predict with the pretrained bundle (projection leaves loaded): "
          f"fused_conv_block launches {res['predict_launches']}")
    res["bundle"] = out
    res["raw"] = raw
    return res


def _pretrain_rates(bundle: Path, cfg_path: Path, raw: str, root: Path,
                    card: str) -> dict:
    """The projection step's steady state on the trained bundle (batch 256,
    bf16, clean windows: warm, then 10 steps that do not wait for the card,
    on the host clock between two synchronizes; the host's share of one
    step on an idle card, the median of 3; device ms from the profiler),
    and the generator's rate on the raw CSV with the bf16 model (wall
    seconds on the host clock, then device ms from a profiled second
    run)."""
    import numpy as np
    import torch

    from jaeger_tpu_torch.commands.train import (make_projection_step,
                                                 projection_params)
    from jaeger_tpu_torch.dataops.reliability_generator import \
        generate_reliability_data
    from jaeger_tpu_torch.models.artifacts import load_model
    from jaeger_tpu_torch.train.loop import to_device
    from jaeger_tpu_torch.train.losses import ArcFaceLoss
    from jaeger_tpu_torch.train.optimizers import make_optimizer
    from jaeger_tpu_torch.utils.config import load_model_config

    t = load_model_config(cfg_path)["training"]
    model, _, _ = load_model(bundle, dtype=torch.bfloat16)
    model.train()
    arcface = ArcFaceLoss(6, 64, generator=torch.Generator().manual_seed(1))
    arcface.to("cuda")
    tx = make_optimizer(t["optimizer"], t["optimizer_params"])
    opt_state = tx.init({k: p.detach() for k, p in
                         projection_params(model, arcface).items()})
    step = make_projection_step(model, arcface, tx,
                                tuple(model.regularizer_specs()))
    batch = _train_batch(np.random.default_rng(3), model.crop_nt, "dense",
                         256, 6)
    for _ in range(2):                                   # warm
        opt_state, _ = step(opt_state, to_device(batch, "cuda"))
    reps = 10
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        opt_state, loss = step(opt_state, to_device(batch, "cuda"))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / reps * 1e3
    host = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        opt_state, loss = step(opt_state, to_device(batch, "cuda"))
        host.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    host_ms = sorted(host)[1]
    holder = {"opt": opt_state}

    def one():
        holder["opt"], _ = step(holder["opt"], to_device(batch, "cuda"))

    by_kernel = print_device_profile(one, "projection step", top=10)
    device_ms = sum(by_kernel.values())
    conv_ms = sum(v for k, v in by_kernel.items()
                  if any(c in k for c in CONV_KERNELS))
    check(math.isfinite(float(loss)), "steady projection loss not finite")
    print(f"projection step (batch 256, bf16) on {card}: {ms:.2f} ms, "
          f"{256 / ms * 1e3:.0f} windows/s; host {host_ms:.1f} ms a step; "
          f"device {device_ms:.2f} ms ({device_ms / ms:.1%} busy), "
          f"{conv_ms:.2f} ms in the conv kernels")
    step_rates = dict(step_ms=ms, windows_per_s=256 / ms * 1e3,
                      host_step_ms=host_ms, device_ms=device_ms,
                      device_busy=device_ms / ms, conv_kernels_ms=conv_ms)

    model.eval()
    kw = dict(id_threshold=0.0, synthetic_ood_threshold=0.0,
              synthetic_ood_multiplier=1.0, batch_size=512)
    t0 = time.perf_counter()
    generate_reliability_data(model, raw, str(root / "relgen_timed"),
                              model.crop_nt, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    by_kernel = print_device_profile(
        lambda: generate_reliability_data(
            model, raw, str(root / "relgen_profiled"), model.crop_nt, **kw),
        "reliability generator", top=6)
    gen_device_ms = sum(by_kernel.values())
    gen = dict(rows=RELGEN_ROWS, wall_s=wall, rows_per_s=RELGEN_ROWS / wall,
               device_ms=gen_device_ms,
               device_share=gen_device_ms / 1e3 / wall,
               host_share=1 - gen_device_ms / 1e3 / wall)
    print(f"reliability generator (bf16, batch 512) on {card}: "
          f"{RELGEN_ROWS} raw rows + {RELGEN_ROWS} synthetic in {wall:.2f} s, "
          f"{gen['rows_per_s']:.0f} raw rows/s; device {gen_device_ms:.1f} ms "
          f"({gen['device_share']:.1%}), host {gen['host_share']:.1%}")
    return dict(projection_step=step_rates, generator=gen)


def phase_pretrain(tmp: Path, card: str) -> dict:
    """Phase 13: 13a, 13b, 13c in turn."""
    t0 = time.perf_counter()
    step_f32 = phase_pretrain_step_f32()
    res = phase_pretrain_flagship(tmp, card)
    res["card_vs_cpu"] = phase_relgen_card_vs_cpu(tmp, res.pop("bundle"),
                                                  res.pop("raw"))
    res["step_f32_worst_grad_err"] = step_f32
    res["phase_s"] = time.perf_counter() - t0
    print(f"phase 13 done in {res['phase_s']:.0f} s")
    return res


def phase_relgen_card_vs_cpu(tmp: Path, bundle: Path, raw: str) -> dict:
    """13c. The generator on the card against the CPU: the trained bundle in
    f32 (TF32 off), a raw CSV of ``RELGEN_CHECK_ROWS`` rows of the 4,096
    (rows 1984-2111: 16 of them with an interior N), batch 64, multiplier
    1.0, the id threshold at the median of the card's confidences on the
    real rows and the synthetic threshold at their lower quartile, so that
    both split the rows. ``reliability_train.csv`` and ``reliability_val.csv``
    byte-identical to a ``device="cpu"`` run unless a row's CPU confidence
    lies within 1e-4 of its threshold or its top two probabilities within
    1e-4 of each other (counted and printed; then every row whose
    decision differs must be such a row); the ``_preds.csv`` rows equal in
    ids and labels, logits and probabilities within 1e-4 (of the scale
    where above 1)."""
    import numpy as np
    import torch

    import jaeger_tpu_torch.dataops.reliability_generator as relgen
    from jaeger_tpu_torch.models.artifacts import load_model

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    root = tmp / "relgen_check"
    root.mkdir()
    lines = Path(raw).read_text().splitlines(keepends=True)
    small = root / "raw_small.csv"
    picked = lines[RELGEN_CHECK_START:RELGEN_CHECK_START + RELGEN_CHECK_ROWS]
    small.write_text("".join(picked))
    rows = [(int(a), b) for a, b in (ln.strip().split(",") for ln in picked)]
    gpu_model, _, _ = load_model(bundle)
    cpu_model, _, _ = load_model(bundle, device="cpu")
    crop = gpu_model.crop_nt
    _, confs = relgen._predict_csv_rows(gpu_model, rows, crop, 512)
    id_thr = float(np.quantile(confs, 0.5))
    syn_thr = float(np.quantile(confs, 0.25))
    kw = dict(id_threshold=id_thr, synthetic_ood_threshold=syn_thr,
              synthetic_ood_multiplier=1.0, batch_size=RELGEN_CHECK_BATCH,
              seed=7)
    seen: dict = {}
    orig = relgen._predict_csv_rows

    def capture(model, rows_, crop_nt, batch_size=512, return_logits=False):
        out = orig(model, rows_, crop_nt, batch_size, return_logits)
        key = "cuda" if next(model.parameters()).is_cuda else "cpu"
        seen.setdefault(key, []).append(out)
        return out

    t0 = time.perf_counter()
    with _patched({(relgen, "_predict_csv_rows"): capture}):
        relgen.generate_reliability_data(gpu_model, str(small),
                                         str(root / "cuda"), crop, **kw)
        relgen.generate_reliability_data(cpu_model, str(small),
                                         str(root / "cpu"), crop, **kw)
    both_s = time.perf_counter() - t0
    check(len(seen["cuda"]) == len(seen["cpu"]) == 2,
          f"generator calls: {[(k, len(v)) for k, v in seen.items()]}")
    near, flips = 0, 0
    # the real rows (ID when confident and right, OOD when confident and
    # wrong), then the synthetic rows (kept when confident)
    for real, g, c in zip((True, False), seen["cuda"], seen["cpu"]):
        thr = id_thr if real else syn_thr
        at = np.abs(c[1] - thr) <= 1e-4
        differ = (g[1] >= thr) != (c[1] >= thr)
        if real:
            probs = np.sort(c[3], axis=1)
            at |= probs[:, -1] - probs[:, -2] <= 1e-4
            differ |= g[0] != c[0]
        check(not (differ & ~at).any(),
              f"generator card vs CPU: {int((differ & ~at).sum())} "
              f"decisions differ away from a threshold")
        near += int(at.sum())
        flips += int(differ.sum())
    same = {}
    for name in ("reliability_train.csv", "reliability_val.csv"):
        same[name] = ((root / "cuda" / name).read_bytes()
                      == (root / "cpu" / name).read_bytes())
    if near == 0:
        check(all(same.values()), f"generator card vs CPU: files {same}")
    want = (root / "cpu" / "raw_small_preds.csv").read_text().splitlines()
    got = (root / "cuda" / "raw_small_preds.csv").read_text().splitlines()
    check(got[0] == want[0] and len(got) == len(want),
          "generator card vs CPU: preds CSV shape")
    w = np.array([r.split(",") for r in want[1:]])
    g = np.array([r.split(",") for r in got[1:]])
    check((w[:, :2] == g[:, :2]).all(), "preds CSV ids and labels differ")
    wv, gv = w[:, 2:].astype(float), g[:, 2:].astype(float)
    err = float(np.abs(gv - wv).max())
    check(err <= 1e-4 * max(1.0, float(np.abs(wv).max())),
          f"preds CSV logits/probs differ by {err:.2e}")
    n_rows = sum(len((root / "cuda" / f).read_text().splitlines())
                 for f in same)
    print(f"generator card vs CPU (f32, {RELGEN_CHECK_ROWS} raw rows, id "
          f"threshold {id_thr:.4f}, synthetic {syn_thr:.4f}): {n_rows} "
          f"reliability rows, files identical {same}, rows within 1e-4 of a "
          f"threshold or a tie {near}, decisions that differ {flips}, preds "
          f"max abs diff {err:.2e} (tol 1e-4); both runs {both_s:.1f} s")
    return dict(identical=same, near_threshold_rows=near, flips=flips,
                preds_max_abs_err=err, rows=n_rows)


# ---------------------------------------------------------------------------
# Phase 14: several devices and processes (one card: repeated devices,
# one-rank and two-rank groups; no scaling is measured)
# ---------------------------------------------------------------------------

#: phase 12's search: query windows x index rows, k; the flagship's
#: embedding width
SHARD_Q, SHARD_N, SHARD_K, SHARD_D = 3968, 19753, 5, 128
#: timed train steps a rank runs after two warm ones
MULTI_STEPS = 10
#: the Hyena model of the JAX package's own --seq-shard test
#: (tests/test_hyena_seq_cli.py): crop 83 codons, so the length pads
SEQ_HYENA_CFG = {
    "model": {
        "name": "hyena_seq", "seed": 3, "classifier_out_dim": 3,
        "class_label_map": [{"class": "chromosome", "label": 0},
                            {"class": "phage", "label": 1},
                            {"class": "plasmid", "label": 2}],
        "embedding": {"use_embedding_layer": True,
                      "input_type": "translated", "embedding_size": 16},
        "string_processor": {"crop_size": 83, "seq_onehot": False},
        "representation_learner": {
            "hidden_layers": [
                {"name": "masked_conv1d",
                 "config": {"filters": 16, "kernel_size": 3,
                            "padding": "same"}},
                {"name": "gelu"},
                {"name": "hyena_block",
                 "config": {"dim": 16, "order": 2, "filter_hidden": 8,
                            "filter_layers": 2, "dropout": 0.0}},
            ],
            "pooling": "average",
        },
        "classifier": {"hidden_layers": [{"name": "dense",
                                          "config": {"units": 3}}]},
    },
    "training": {},
}


def _worker_result(text: str) -> dict:
    """The ``WORKER {json}`` line a worker process printed."""
    for line in text.splitlines():
        if line.startswith("WORKER "):
            return json.loads(line[len("WORKER "):])
    raise SmokeFailure(f"a worker printed no result:\n{text[-3000:]}")


def _run_workers(argvs: list, timeout: float = 300) -> tuple[list, float]:
    """Start every worker at once (``chip_smoke.py --cli-worker`` or
    ``--train-worker``), wait for all with a timeout; their results and
    the wall seconds until the last ended. Every worker is stopped before
    this returns."""
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"),
                               *a], cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for a in argvs]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    except subprocess.TimeoutExpired as e:
        raise SmokeFailure(f"a worker ran past {timeout} s: {e.cmd}") from e
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    wall = time.perf_counter() - t0
    for a, p, out in zip(argvs, procs, outs):
        check(p.returncode == 0,
              f"worker {a[:2]} exited {p.returncode}:\n{out[-3000:]}")
    return [_worker_result(o) for o in outs], wall


def cli_worker(argv: list[str]) -> int:
    """``--cli-worker <cli args>``: one CLI command in this process, then
    ``WORKER {seconds, fused_conv_block and int8_conv launches}``."""
    import torch

    sys.path.insert(0, str(ROOT))
    from jaeger_tpu_torch import cli
    from jaeger_tpu_torch.ops import fused_conv, int8_conv

    fused_conv.launches = int8_conv.launches = 0
    t0 = time.perf_counter()
    cli.main(argv)
    torch.cuda.synchronize()
    print("WORKER " + json.dumps({"s": time.perf_counter() - t0,
                                  "fused_conv_block": fused_conv.launches,
                                  "int8_conv": int8_conv.launches}))
    return 0


def _multi_train(world: int, rank: int, f32_out: str | None,
                 device: str = "cuda:0", template: Path = TEMPLATE) -> dict:
    """The flagship template at full width (bf16, seeded weights) in this
    process's share of a dense global batch of 256: two warm steps, then
    ``MULTI_STEPS`` on the host clock between two synchronizes, the
    hand kernels' launches counted over them; then one f32 step on a
    global batch of 64 from the same weights. The bf16 parameters before
    and after the steps, and the f32 step's parameters and gradients, go to
    ``f32_out``."""
    import numpy as np
    import torch

    from jaeger_tpu_torch.models.artifacts import init_params, load_state
    from jaeger_tpu_torch.models.builder import build_model
    from jaeger_tpu_torch.ops import fused_conv, int8_conv
    from jaeger_tpu_torch.ops import fused_conv_grad as fg
    from jaeger_tpu_torch.parallel import multihost as mh
    from jaeger_tpu_torch.train import loop
    from jaeger_tpu_torch.train.optimizers import make_optimizer
    from jaeger_tpu_torch.utils.config import load_model_config

    cfg = load_model_config(template)
    t = cfg["training"]
    dev = torch.device(device)
    batcher = mh.GlobalBatcher() if world else None

    def make(dtype):
        model = build_model(cfg, dtype=dtype)
        load_state(model, init_params(cfg, torch.Generator().manual_seed(42)))
        model.to(dev)
        state = loop.TrainState.create(model, make_optimizer(
            t["optimizer"], t["optimizer_params"]))
        step = loop.make_dispatching_train_step(model, loop.StepConfig(
            loss_name=t["loss_classifier"],
            loss_params=t["loss_params_classifier"], heads=("prediction",)),
            dev, global_batcher=batcher)
        return model, state, step

    def params(model):
        return {k: p.detach().float().cpu()
                for k, p in loop.flax_params(model).items()}

    gen = torch.Generator(device=dev).manual_seed(42)
    model, state, step = make(torch.bfloat16)
    bf16_init = params(model)
    batch = _train_batch(np.random.default_rng(14), model.crop_nt, "dense",
                         256, 6)
    for _ in range(2):
        state, metrics = step(state, batch, gen)
    _sync(dev)
    fused_conv.launches = int8_conv.launches = 0
    for k in fg.launches:
        fg.launches[k] = 0
    t0 = time.perf_counter()
    for _ in range(MULTI_STEPS):
        state, metrics = step(state, batch, gen)
    _sync(dev)
    step_ms = (time.perf_counter() - t0) / MULTI_STEPS * 1e3
    launches = dict(fg.launches, fused_conv_block=fused_conv.launches,
                    int8_conv=int8_conv.launches)
    loss = float(metrics["loss"])
    bf16_final = params(model)
    del model, state, step
    model32, state32, step32 = make(torch.float32)
    b32 = _train_batch(np.random.default_rng(15), model32.crop_nt, "dense",
                       64, 6)
    state32, m32 = step32(state32, b32, gen)
    if f32_out:
        torch.save({"params": params(model32),
                    "grads": {k: g.cpu() for k, g in state32.grads.items()},
                    "loss": float(m32["loss"]), "bf16_init": bf16_init,
                    "bf16_final": bf16_final}, f32_out)
    peak = (torch.cuda.max_memory_allocated() / 1e9 if dev.type == "cuda"
            else None)
    return dict(world=world, rank=rank, step_ms=step_ms, launches=launches,
                loss=loss, f32_loss=float(m32["loss"]), peak_gb=peak)


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def train_worker(argv: list[str]) -> int:
    """``--train-worker <rank> <world> <backend> <port> <f32 out>``: join
    the group on ``cuda:0`` (the process group's timeout bounds every
    collective; world 0: no group), run :func:`_multi_train`, print
    ``WORKER {json}``."""
    import torch

    sys.path.insert(0, str(ROOT))
    from jaeger_tpu_torch.parallel import multihost as mh

    rank, world, backend, port, out = (int(argv[0]), int(argv[1]), argv[2],
                                       argv[3], argv[4])
    torch.cuda.set_device(0)
    if world:
        mh.initialize_distributed(f"127.0.0.1:{port}", world, rank,
                                  backend=backend, device="cuda:0",
                                  timeout_s=240)
    try:
        res = _multi_train(world, rank, out if rank == 0 else None)
    finally:
        mh.shutdown_distributed()
    print("WORKER " + json.dumps(dict(res, backend=backend)))
    return 0


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _sorted_rows(path: Path) -> tuple:
    head, *rows = path.read_bytes().split(b"\n")
    return head, sorted(rows)


def _rank_shape_kernels() -> dict:
    """The hand kernels at one rank's share of phase 14's two-rank steps,
    against their plain versions with phase 3 and 3b's tolerances: bf16 at
    128 windows (N = 6 * 128 rows) and f32 at 32 windows (N = 6 * 32), L
    500, C 128, k 5. ``fused_conv_block`` in the flagship's conv2 form, the
    flipped-weight data gradient, ``conv_wgrad``, ``conv_epilogue_bwd``
    (conv1 and conv2 forms) and FusedConvBlockFn's whole backward. The
    launch counts are put back: these are not the path's launches."""
    import torch

    from jaeger_tpu_torch.ops import fused_conv
    from jaeger_tpu_torch.ops import fused_conv_grad as fg

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(1415)
    saved = dict(fg.launches), fused_conv.launches
    worst = {}
    for windows, dt in ((128, torch.bfloat16), (32, torch.float32)):
        n, length, c, k = 6 * windows, TRAIN_L, TRAIN_C, TRAIN_K
        bf16 = dt == torch.bfloat16
        act = "gelu_tanh" if bf16 else "gelu"       # the model's forms
        tol = BF16_KERNEL_TOL if bf16 else (F32_TOL,)
        label = f"rank shape N={n} L={length} C={c} k={k} {str(dt)[6:]}"
        x, w, bias, dyt = _conv_inputs(gen, n, length, c, k, dt, dev)
        kw = dict(bias=bias, dyt=dyt, **_extension_args(gen, x, "model", dev))
        im, om, r = kw["in_mask"], kw["out_mask"], kw["residual"]
        before = dict(fg.launches), fused_conv.launches
        out = fused_conv.fused_conv_block(x, w, act=act, **kw)
        ref = fused_conv.reference_conv_block(x, w, act=act, **kw)
        err = (out.float() - ref.float()).abs()
        etol = BF16_TOL if bf16 else F32_TOL
        bad = int((err > etol + etol * ref.float().abs()).sum())
        worst[f"fused_conv_block_{str(dt)[6:]}"] = float(err.max())
        check(bad == 0 and math.isfinite(float(err.max())),
              f"fused_conv_block {label}: {bad} elements beyond tolerance")
        print(f"kernel fused_conv_block conv2 form {label}: max_abs_err "
              f"{float(err.max()):.3e} (tol {etol}) ok")
        du = (torch.randn(n, length, c, generator=gen) * 0.1).to(dev, dt)
        wf = fg.flipped_weights(w.to(dt))
        dx = fused_conv.fused_conv_block(du, wf, out_mask=im)
        _check_close(f"dgrad {label}", {"dx": (
            dx, fused_conv.reference_conv_block(du, wf, out_mask=im))}, *tol)
        dw, db = fg.conv_wgrad(x, du, im, k)
        rdw, rdb = fg.reference_conv_wgrad(x, du, im, k)
        _check_close(f"conv_wgrad {label}", {"dW": (dw, rdw), "db": (db, rdb)},
                     1e-3 if bf16 else F32_TOL)
        u = torch.randn(n, length, c, generator=gen).to(dev, dt)
        for form, res in (("conv1", None), ("conv2", r)):
            got = fg.conv_epilogue_bwd(du, u, res, om, dyt, act)
            want = fg.reference_conv_epilogue_bwd(du, u, res, om, dyt,
                                                  act)
            _check_close(f"conv_epilogue_bwd {form} {label}",
                         {"du": (got[0], want[0]),
                          "dr": (got[1], want[1] if res is not None
                                 else None),
                          "ddyt": (got[2], want[2])}, *tol)
        torch.cuda.synchronize()
        check(fused_conv.launches == before[1] + 2
              and fg.launches["conv_wgrad"] == before[0]["conv_wgrad"] + 1
              and fg.launches["conv_epilogue_bwd"]
              == before[0]["conv_epilogue_bwd"] + 2,
              f"{label}: a kernel was not launched")
        dy = torch.randn(n, length, c, generator=gen).to(dev, dt)
        bkw = dict(dyt=dyt, act=act, bias_then_dyt=True, in_mask=im,
                   out_mask=om, residual=r)
        got = fg.conv_block_backward(dy, x, w, bias, **bkw)
        want = fg.reference_conv_block_backward(dy, x, w, bias, **bkw)
        _check_close(f"FusedConvBlockFn backward conv2 {label}",
                     dict(zip(("dx", "dW", "db", "ddyt", "dr"),
                              zip(got, want))),
                     *(BF16_BACKWARD_TOL if bf16 else (F32_TOL,)))
        del x, out, ref, err, du, dx, u, dy, got, want
    fg.launches.update(saved[0])
    fused_conv.launches = saved[1]
    return worst


def phase_multi(tmp: Path, card: str, bundle: Path) -> dict:
    """Phase 14: the multi-device paths on one card. (a) ``predict
    --num-hosts 2 --host-id 0|1`` as two CLI processes at once on the
    test contigs with the flagship bundle in f32, then one host's process
    alone: the merged TSV's rows byte-identical to one host's (the merge
    lists host 0's contigs first, as JAX's does), the hosts' command
    seconds against the one host's; (b) the
    engine and ``run_core`` on ``DeviceMesh(("cuda:0",) * 2)`` against
    ``("cuda:0",)``: f32 outputs within 1e-5 of the scale on dense and
    split batches, the TSV identical; (c) the flagship template at full
    width in bf16: the step without a group, in a one-rank
    NCCL group and in a two-rank gloo group on cuda:0 (each rank half the
    global 256 rows), step ms and the hand kernels' launches per rank; the
    two-rank bf16 run against the one-rank one after its 12 steps: the
    last loss within 1e-2 relative and the parameters' distance under 5 %
    of the distance they moved; the two-rank f32 step's gradients within
    1e-4 of the one-rank step's scale and its parameters within 1e-4
    wherever the gradient exceeds 1e-6 (Adam's first step is about lr *
    sign(g): a gradient of rounding noise may flip it), all within 2 lr;
    then the hand kernels at one rank's shapes against their plain
    versions (:func:`_rank_shape_kernels`); (d) ``run_core`` with
    ``seq_mesh=DeviceMesh(("cuda:0",) * 2, "seq")`` on the seeded Hyena
    model of JAX's --seq-shard test: the TSV identical to width 1; (e)
    the row-sharded search at phase 12's size (3,968 x 19,753, k 5) at
    widths 1, 2 and 4 against the one-device search: scores within 1e-6,
    indices equal wherever neighbouring scores are more than 1e-6 apart.
    Launches of the hand kernels on (a), (b) and (c)'s ranks are this
    phase's main path (counts reset just before each, read just after).
    No int8 bundle runs here, so ``int8_conv``'s count reads 0."""
    import numpy as np
    import torch

    from jaeger_tpu_torch import native
    from jaeger_tpu_torch.commands.predict import run_core
    from jaeger_tpu_torch.commands.taxonomy import CosineIndex
    from jaeger_tpu_torch.infer.engine import InferenceEngine
    from jaeger_tpu_torch.models.artifacts import (init_params, load_model,
                                                   save_model)
    from jaeger_tpu_torch.ops import fused_conv, int8_conv
    from jaeger_tpu_torch.parallel.mesh import DeviceMesh
    from jaeger_tpu_torch.utils.config import load_model_config

    res: dict = {}
    root = tmp / "multi"
    root.mkdir()
    tsv = "test_contigs_default_jaeger.tsv"
    common = ["-i", str(FASTA), "-m", str(bundle), "--precision", "float32",
              "--fsize", "1505", "--stride", "1505", "--workers", "2"]

    # (a) two host processes at once, then one host in a process alone;
    # the native host library is built first, so no worker times a g++
    check(native.available(), "the native host library did not build")
    hosts, wall = _run_workers(
        [["--cli-worker", "predict", "-o", str(root / "hosts"), *common,
          "--num-hosts", "2", "--host-id", str(h)] for h in range(2)])
    (one,), one_wall = _run_workers(
        [["--cli-worker", "predict", "-o", str(root / "one"), *common]])
    one_s, one_launches = one["s"], one["fused_conv_block"]
    check(not list((root / "hosts").glob("*.shard*")),
          "multi-host predict left shards")
    check(_sorted_rows(root / "hosts" / tsv) == _sorted_rows(root / "one"
                                                             / tsv),
          "multi-host predict: the merged rows differ from one host's")
    host_launches = [h["fused_conv_block"] for h in hosts]
    check(all(n > 0 for n in host_launches),
          f"multi-host predict launches {host_launches}")
    cli_int8 = sum(h["int8_conv"] for h in (*hosts, one))
    res["hosts"] = dict(host_s=[h["s"] for h in hosts], wall_s=wall,
                        one_host_s=one_s, one_host_wall_s=one_wall,
                        launches=host_launches,
                        one_host_launches=one_launches,
                        int8_conv_launches=cli_int8)
    print(f"predict --num-hosts 2 (f32, test contigs) on {card}: the "
          "hosts' commands " + " / ".join(f"{h['s']:.2f}" for h in hosts)
          + f" s, {wall:.2f} s wall with process start; one host "
          f"{one_s:.2f} s, {one_wall:.2f} s wall; merged rows "
          f"byte-identical; launches {host_launches} (one host "
          f"{one_launches})")

    # (b) the engine on a repeated-device data mesh
    model, _, _ = load_model(bundle)
    rng = np.random.default_rng(140)
    crop = model.crop_nt
    bases = rng.integers(0, 4, size=(700, crop)).astype(np.uint8)
    lengths = np.full(700, crop, np.int32)
    bases[[5, 300, 650], [100, 700, 1200]] = 4          # split batches
    mesh2 = DeviceMesh(("cuda:0",) * 2)
    fused_conv.launches = int8_conv.launches = 0
    got = InferenceEngine(model, batch_size=256, mesh=mesh2
                          ).predict_windows(bases, lengths)
    run_core(str(FASTA), str(root / "mesh"), str(bundle), fsize=1505,
             stride=1505, precision="float32", workers=2, mesh=mesh2)
    torch.cuda.synchronize()
    mesh_launches, mesh_int8 = fused_conv.launches, int8_conv.launches
    want = InferenceEngine(model, batch_size=256,
                           mesh=DeviceMesh(("cuda:0",))
                           ).predict_windows(bases, lengths)
    err = max(float(np.abs(got[k] - want[k]).max())
              / max(float(np.abs(want[k]).max()), 1e-6) for k in want)
    check(err <= 1e-5, f"engine on two cuda:0 devices: {err:.2e} of the "
                       f"scale from one")
    check((root / "mesh" / tsv).read_bytes() == (root / "one" / tsv)
          .read_bytes(), "run_core on the mesh: the TSV differs")
    check(mesh_launches > 0, "the mesh path launched no fused_conv_block")
    res["engine_mesh"] = dict(max_err=err, launches=mesh_launches,
                              int8_conv_launches=mesh_int8)
    print(f"engine on ('cuda:0',) * 2 against ('cuda:0',), f32: worst "
          f"{err:.2e} of the scale (tol 1e-5); run_core TSV identical; "
          f"{mesh_launches} fused_conv_block launches")
    del model

    # (c) training, each in a fresh process: no group (the reference),
    # one-rank NCCL, two-rank gloo
    torch.cuda.empty_cache()
    runs = {}
    for name, world, backend in (("none", 0, "none"), ("nccl1", 1, "nccl"),
                                 ("gloo2", 2, "gloo")):
        port = str(_free_port())
        runs[name], _ = _run_workers(
            [["--train-worker", str(r), str(world), backend, port,
              str(root / f"f32_{name}.pt")] for r in range(max(world, 1))],
            timeout=400)
    for name, rs in runs.items():
        for r in rs:
            check(math.isfinite(r["loss"]), f"{name} rank {r['rank']} loss")
            check(r["launches"] == {"fused_conv_block": 18 * MULTI_STEPS,
                                    "conv_wgrad": 6 * MULTI_STEPS,
                                    "conv_epilogue_bwd": 6 * MULTI_STEPS,
                                    "int8_conv": 0},
                  f"{name} rank {r['rank']} launches {r['launches']}")
    check(runs["gloo2"][0]["loss"] == runs["gloo2"][1]["loss"],
          "the two ranks report different losses")
    f32_one = torch.load(root / "f32_nccl1.pt")
    f32_two = torch.load(root / "f32_gloo2.pt")
    # bf16: the two-rank run against the one-rank run after 12 steps
    loss_one, loss_two = runs["nccl1"][0]["loss"], runs["gloo2"][0]["loss"]
    bf16_loss_err = abs(loss_two - loss_one) / abs(loss_one)
    check(bf16_loss_err <= 1e-2, f"two-rank bf16 loss {loss_two} against "
                                 f"one rank's {loss_one}")
    moved = apart = 0.0
    for k, p0 in f32_one["bf16_init"].items():
        moved += float((f32_one["bf16_final"][k] - p0).square().sum())
        apart += float((f32_two["bf16_final"][k]
                        - f32_one["bf16_final"][k]).square().sum())
    bf16_param_ratio = math.sqrt(apart / moved)
    check(moved > 0 and bf16_param_ratio <= 0.05,
          f"two-rank bf16 parameters {bf16_param_ratio:.2e} of the distance "
          f"moved from one rank's")
    lr = float(load_model_config(TEMPLATE)["training"]["optimizer_params"]
               ["learning_rate"])
    g_err = p_err = 0.0
    for k, g in f32_one["grads"].items():
        scale = max(float(g.abs().max()), 1e-12)
        g_err = max(g_err,
                    float((f32_two["grads"][k] - g).abs().max()) / scale)
        d = (f32_two["params"][k] - f32_one["params"][k]).abs()
        check(float(d.max()) <= 2 * lr + 1e-7, f"f32 params {k} beyond 2 lr")
        live = g.abs() > 1e-6
        if bool(live.any()):
            p_err = max(p_err, float(d[live].max()))
    check(g_err <= 1e-4, f"two-rank f32 gradients {g_err:.2e} of the scale")
    check(p_err <= 1e-4, f"two-rank f32 parameters {p_err:.2e} apart")
    res["train"] = {name: [dict(r) for r in rs] for name, rs in runs.items()}
    res["train"].update(f32_grad_err=g_err, f32_param_err=p_err,
                        f32_loss_one_rank=f32_one["loss"],
                        f32_loss_two_ranks=f32_two["loss"],
                        bf16_loss_rel_err=bf16_loss_err,
                        bf16_param_ratio=bf16_param_ratio)
    for name, rs in runs.items():
        print(f"train flagship dense step (batch 256 global, bf16) {name} on "
              f"{card}: " + ", ".join(f"rank {r['rank']} {r['step_ms']:.2f} "
                                      f"ms, launches {r['launches']}"
                                      for r in rs))
    print(f"two-rank f32 step against one rank: gradients {g_err:.2e} of "
          f"the scale, parameters {p_err:.2e} apart (tol 1e-4); bf16 after "
          f"{MULTI_STEPS + 2} steps: loss {loss_two:.6f} against "
          f"{loss_one:.6f} "
          f"({bf16_loss_err:.1e} relative, tol 1e-2), parameters "
          f"{bf16_param_ratio:.2e} of the distance moved apart (tol 5e-2)")
    res["rank_shape_kernels"] = _rank_shape_kernels()

    # (d) the sequence ring on two cuda:0 devices
    hy = root / "hyena"
    hy_cfg = copy.deepcopy(SEQ_HYENA_CFG)
    save_model(init_params(hy_cfg, torch.Generator().manual_seed(3)),
               hy_cfg, hy / "model")
    rng = np.random.default_rng(11)
    with (hy / "contigs.fasta").open("w") as fh:
        for i, ln in enumerate([900, 720, 505, 300]):
            fh.write(f">hy_contig_{i}\n"
                     + "".join(rng.choice(list("ACGT"), size=ln)) + "\n")
    kw = dict(fsize=300, stride=300, min_len=300, batch=16,
              precision="float32", scan_termini=False)
    w1 = run_core(str(hy / "contigs.fasta"), str(hy / "w1"), str(hy / "model"),
                  **kw).read_bytes()
    w2 = run_core(str(hy / "contigs.fasta"), str(hy / "w2"), str(hy / "model"),
                  seq_mesh=DeviceMesh(("cuda:0",) * 2, "seq"), **kw
                  ).read_bytes()
    check(w1.count(b"\n") == 5, "seq-shard predict: rows")
    check(w2 == w1, "--seq-shard on two cuda:0 devices: the TSV differs "
                    "from width 1")
    res["seq_shard"] = dict(tsv_identical=True)
    print("run_core --seq-shard on ('cuda:0',) * 2 (f32): TSV identical to "
          "width 1")

    # (e) the row-sharded search at phase 12's size
    rng = np.random.default_rng(12)
    index = CosineIndex(rng.normal(size=(SHARD_N, SHARD_D)).astype(
        np.float32), np.arange(1, SHARD_N + 1))
    q = rng.normal(size=(SHARD_Q, SHARD_D)).astype(np.float32)
    q[:50] = index.embeddings[:50]
    ref_s, ref_i = index.search(q, SHARD_K + 1, device="cuda")
    search = {}
    for width in (1, 2, 4):
        mesh = DeviceMesh(("cuda:0",) * width)
        index.search(q, SHARD_K, mesh=mesh)
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            s, i = index.search(q, SHARD_K, mesh=mesh)
            times.append((time.perf_counter() - t0) * 1e3)
        s_err = float(np.abs(s - ref_s[:, :SHARD_K]).max())
        gaps = np.abs(np.diff(ref_s, axis=1)) > 1e-6       # (Q, K)
        # position j is decided where it is apart from both neighbours
        decided = gaps[:, :SHARD_K].copy()
        decided[:, 1:] &= gaps[:, :SHARD_K - 1]
        bad = int(((i != ref_i[:, :SHARD_K]) & decided).sum())
        check(s_err <= 1e-6, f"sharded search width {width}: scores "
                             f"{s_err:.2e} apart")
        check(bad == 0, f"sharded search width {width}: {bad} decided "
                        f"neighbours differ")
        check(bool((i[:50, 0] == np.arange(50)).all()),
              f"sharded search width {width}: a self-query is not first")
        search[width] = dict(ms=sorted(times)[2], max_score_err=s_err)
        print(f"sharded search width {width} on ('cuda:0',) * {width}: "
              f"{sorted(times)[2]:.2f} ms for {SHARD_Q} x {SHARD_N}, k "
              f"{SHARD_K} (host clock, median of 5, with the copies); "
              f"scores {s_err:.1e} from one device")
    res["search"] = search
    res["launches"] = {
        "int8_conv": cli_int8 + mesh_int8 + sum(
            r["launches"]["int8_conv"]
            for name in ("nccl1", "gloo2") for r in runs[name]),
        "fused_conv_block": sum(host_launches) + one_launches
        + mesh_launches + sum(
            r["launches"]["fused_conv_block"]
            for name in ("nccl1", "gloo2") for r in runs[name]),
        "conv_wgrad": sum(r["launches"]["conv_wgrad"]
                          for name in ("nccl1", "gloo2") for r in runs[name]),
        "conv_epilogue_bwd": sum(r["launches"]["conv_epilogue_bwd"]
                                 for name in ("nccl1", "gloo2")
                                 for r in runs[name])}
    return res


# --- phase 15: the converters ---------------------------------------------------

#: the batches phase 15 exports the flagship at: JAX's default and the
#: engine's
CONVERT_BATCHES = (96, 2048)
#: a program's bf16 class scores against the CPU's f32 ones (the card rule
#: of PERF.md §2)
SCORE_TOL = 0.01

#: runs the exported programs in a process that cannot import the port,
#: the JAX package or JAX, with TF32 off as ``resolve_device`` sets it:
#: each on the CPU where asked, then on the card after
#: ``move_to_device_pass``, timed with CUDA events where asked
GRAPH_RUNNER = r"""
import json, sys
for m in ("jaeger_tpu_torch", "jaeger_tpu", "jax", "jaxlib", "flax"):
    sys.modules[m] = None
import numpy as np
import torch
from torch.export.passes import move_to_device_pass

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
result = {}
for item in json.load(open(sys.argv[1])):
    ep = torch.export.load(item["program"])
    z = np.load(item["inputs"])
    bases = torch.from_numpy(z["bases"])
    lengths = torch.from_numpy(z["lengths"])
    out = {}
    with torch.no_grad():
        if item["cpu"]:
            got = ep.module()(bases, lengths)
            out.update({"cpu_" + k: v.numpy() for k, v in got.items()})
        fwd = move_to_device_pass(ep, "cuda").module()
        b, l = bases.cuda(), lengths.cuda()
        got = fwd(b, l)
        out.update({k: v.cpu().numpy() for k, v in got.items()})
        ms = None
        if item["time"]:
            for _ in range(2):
                fwd(b, l)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            for _ in range(5):
                fwd(b, l)
            end.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(end) / 5
    np.savez(item["out"], **out)
    result[item["name"]] = {"ms": ms,
                            "dtypes": sorted({str(v.dtype) for v in got.values()})}
    del ep, fwd, got
    torch.cuda.empty_cache()
print("RESULT " + json.dumps(result))
"""


def _contig_windows(crop: int):
    """The windows of ``test_contigs.fasta`` at the crop, as ``predict``
    cuts them: (bases, lengths)."""
    import numpy as np

    from jaeger_tpu_torch.seqops.windows import window_batches

    batches = list(window_batches(str(FASTA), fragsize=crop, stride=crop))
    return (np.concatenate([b.bases for b in batches]),
            np.concatenate([b.length for b in batches]))


def _padded(bases, lengths, batch: int):
    """The first ``batch`` windows, padded with empty all-N rows as the
    engine pads a batch: (bases, lengths, real rows)."""
    import numpy as np

    n = min(len(bases), batch)
    b = np.full((batch, bases.shape[1]), 4, np.uint8)
    b[:n] = bases[:n]
    ln = np.zeros(batch, np.int32)
    ln[:n] = lengths[:n]
    return b, ln, n


def _softmax(x):
    import numpy as np

    e = np.exp(x - x.max(axis=-1, keepdims=True))
    return e / e.sum(axis=-1, keepdims=True)


def phase_convert(tmp: Path, card: str, bundle: Path) -> dict:
    """``utils convert-graph`` on the flagship bundle and its programs run
    without the port, against the engine's forward (the module docstring,
    phase 15)."""
    import numpy as np
    import torch

    from jaeger_tpu_torch import cli
    from jaeger_tpu_torch.infer.engine import InferenceEngine
    from jaeger_tpu_torch.models.artifacts import load_model

    t_phase = time.perf_counter()
    out = tmp / "graphs"
    out.mkdir()
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    models = {p: load_model(bundle, dtype=dt)[0] for p, dt in dtypes.items()}
    windows, wlengths = _contig_windows(models["float32"].crop_nt)
    inputs = {}
    for batch in CONVERT_BATCHES:
        b, ln, n = _padded(windows, wlengths, batch)
        path = out / f"windows_b{batch}.npz"
        np.savez(path, bases=b, lengths=ln)
        inputs[batch] = (b, ln, n, path)
    spec, export_s, sizes = [], {}, {}
    for precision in dtypes:
        for batch in CONVERT_BATCHES:
            name = f"{precision}_b{batch}"
            program = out / f"flagship_{name}.pt2"
            t0 = time.perf_counter()
            cli.main(["utils", "convert-graph", "-m", str(bundle), "-o",
                      str(program), "--precision", precision, "--batch",
                      str(batch)])
            export_s[name] = time.perf_counter() - t0
            sizes[name] = program.stat().st_size
            spec.append({"name": name, "program": str(program),
                         "inputs": str(inputs[batch][3]),
                         "out": str(out / f"out_{name}.npz"),
                         "cpu": name == "float32_b96",
                         "time": batch == max(CONVERT_BATCHES)})
    (out / "spec.json").write_text(json.dumps(spec))
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", GRAPH_RUNNER,
                           str(out / "spec.json")], cwd=out,
                          capture_output=True, text=True, timeout=600)
    runner_s = time.perf_counter() - t0
    check(proc.returncode == 0 and "RESULT " in proc.stdout,
          f"convert-graph programs: {proc.stderr[-3000:]}")
    ran = json.loads(proc.stdout.split("RESULT ", 1)[1])
    for name, r in ran.items():
        check(r["dtypes"] == ["torch.float32"],
              f"program {name}: outputs {r['dtypes']}, not float32")

    # the engine's forward of the same windows on the card: counts reset
    # just before, read just after
    _reset_kernel_counts()
    want = {}
    for precision, model in models.items():
        for batch in CONVERT_BATCHES:
            b, ln, _, _ = inputs[batch]
            eng = InferenceEngine(model, batch_size=batch, device="cuda")
            with torch.inference_mode():
                got = eng._forward(b, ln)
            want[f"{precision}_b{batch}"] = {
                k: v.cpu().numpy() for k, v in got.items()}
    torch.cuda.synchronize()
    launches = _kernel_counts()
    routes = _route_counts()
    forwards = len(dtypes) * len(CONVERT_BATCHES)
    check(launches["fused_conv_block"] == 6 * forwards
          and launches["int8_conv"] == 0,
          f"phase 15 engine forwards: launches {launches}")
    # each f32 forward's six convs on the f32 ring route, bf16's on wgmma
    per = 6 * len(CONVERT_BATCHES)
    check(routes == {"fused_conv_block:f32_ring": per,
                     "fused_conv_block:wgmma": per},
          f"phase 15 engine forwards: routes {routes}")

    report = {}
    cpu_ref = dict(np.load(out / "out_float32_b96.npz"))
    for name, eng_out in want.items():
        precision, batch = name.split("_b")
        batch = int(batch)
        n = inputs[batch][2]
        got = dict(np.load(out / f"out_{name}.npz"))
        check(set(eng_out) <= set(got),
              f"program {name}: outputs {sorted(got)}")
        for k in eng_out:
            check(got[k].shape == eng_out[k].shape
                  and bool(np.isfinite(got[k]).all()),
                  f"program {name}: {k} {got[k].shape} not finite")
        errs = {}
        if precision == "float32":
            for k, v in eng_out.items():
                scale = max(float(np.abs(v[:n]).max()), 1e-6)
                errs[k] = float(np.abs(got[k][:n] - v[:n]).max()) / scale
                check(errs[k] <= F32_TOL,
                      f"program {name}: {k} {errs[k]:.2e} of the scale "
                      f"from the engine's forward")
            if "cpu_prediction" in got:
                for k, v in eng_out.items():
                    scale = max(float(np.abs(v[:n]).max()), 1e-6)
                    e = float(np.abs(got["cpu_" + k][:n] - v[:n]).max())
                    errs["cpu_" + k] = e / scale
                    check(e <= F32_TOL * scale,
                          f"program {name} on the CPU: {k} {e / scale:.2e} "
                          f"of the scale from the engine's forward")
        else:
            # the plain versions against the hand kernels, as phase 4
            for k, v in eng_out.items():
                scale = max(float(np.abs(v[:n]).max()), 1e-3)
                errs[k] = float(np.abs(got[k][:n] - v[:n]).max()) / scale
                check(errs[k] <= BF16_TOL,
                      f"program {name}: {k} {errs[k]:.2e} of the scale "
                      f"from the engine's forward")
            rows = min(n, cpu_ref["cpu_prediction"].shape[0])
            ref = _softmax(cpu_ref["cpu_prediction"][:rows].astype(
                np.float64))
            prob = _softmax(got["prediction"][:rows].astype(np.float64))
            errs["scores"] = float(np.abs(prob - ref).max())
            check(errs["scores"] <= SCORE_TOL,
                  f"program {name}: class scores {errs['scores']:.4f} from "
                  f"the CPU's f32 ones")
            # the argmax on every window whose two top logits lie further
            # apart than the two forwards may (BF16_TOL of the scale each)
            logits = eng_out["prediction"][:n]
            top2 = np.sort(logits, axis=-1)[:, -2:]
            clear = (top2[:, 1] - top2[:, 0]) > (
                2 * BF16_TOL * float(np.abs(logits).max()))
            same = got["prediction"][:n].argmax(-1) == logits.argmax(-1)
            check(bool(same[clear].all()),
                  f"program {name}: argmax differs from the engine's on "
                  f"{int((~same & clear).sum())} clear windows")
            errs["argmax_equal"] = int(same.sum())
            errs["clear_windows"] = int(clear.sum())
        report[name] = dict(errs=errs, export_s=export_s[name],
                            bytes=sizes[name], real_rows=n)

    # the programs' forward at the largest batch beside the port's
    big = max(CONVERT_BATCHES)
    b, ln, _, _ = inputs[big]
    tb, tl = torch.from_numpy(b).cuda(), torch.from_numpy(ln).cuda()
    times = {}
    for precision, model in models.items():
        with torch.inference_mode():
            port_ms = cuda_ms(lambda: model(tb, tl), iters=5)
        prog_ms = ran[f"{precision}_b{big}"]["ms"]
        times[precision] = dict(program_ms=prog_ms, port_ms=port_ms,
                                ratio=prog_ms / port_ms)
        # the hand kernels against the plain versions the program holds
        check(port_ms < prog_ms,
              f"{precision} forward at {big}: the port {port_ms:.2f} ms, "
              f"the exported program {prog_ms:.2f} ms")
        print(f"convert-graph flagship {precision}: program forward at "
              f"{big} {prog_ms:.2f} ms, the port's {port_ms:.2f} ms "
              f"({prog_ms / port_ms:.2f} x); export "
              + ", ".join(f"b{bt} {export_s[f'{precision}_b{bt}']:.1f} s"
                          for bt in CONVERT_BATCHES) + f" ({card})")
    for name, r in report.items():
        print(f"convert-graph {name}: {r['real_rows']} windows, "
              + " ".join(f"{k} {v:.2e}" if isinstance(v, float)
                         else f"{k} {v}" for k, v in r["errs"].items()))
    del tb, tl, models
    phase_s = time.perf_counter() - t_phase
    print(f"phase 15: {launches['fused_conv_block']} fused_conv_block "
          f"launches in {forwards} engine forwards; the programs' process "
          f"took {runner_s:.1f} s, the phase {phase_s:.1f} s")
    return dict(programs=report, times=times, runner_s=runner_s,
                phase_s=phase_s, launches=launches, routes=routes)


# --- phase 16: fused_conv_block on the whole domain of its Pallas kernel ----

#: correctness cases of the routes that take the shapes the resident bf16
#: kernel and the f32 ring refused before (wgmma_stream, f32_ring_pad and
#: f32_ring past its old shape rule): (name, N, L, C, k, dtype); each runs
#: in the three forms of phase 3 (conv1: DYT + gelu with in_mask, conv2:
#: with the residual, bias-only) and the model form (every extension)
DOMAIN_CASES = (
    # bf16 wgmma_stream: TMA copies (C % 8 == 0), 2-byte loads (C % 8
    # != 0), column widths 16 to 256, column blocks cut at C, resident and
    # streamed weights, tap blocks (k past a TMA box's rows), even k, the
    # 128-row tile's edges; the cluster's edges (C 200: 2 CTAs a cluster):
    # tile counts not a multiple of 2 (N 3 x 3 tiles) and fewer tiles than
    # CTAs (N 1 x 1 tile); C 1024's four column blocks of 1 tile, k 61 on
    # 3 tiles
    ("C200_k5", 6, 300, 200, 5, "bfloat16"),
    ("C200_L1", 4, 1, 200, 5, "bfloat16"),
    ("C200_L127", 3, 127, 200, 5, "bfloat16"),
    ("C200_L129_N1", 1, 129, 200, 5, "bfloat16"),
    ("C200_odd_tiles", 3, 300, 200, 5, "bfloat16"),
    ("C200_one_tile", 1, 100, 200, 5, "bfloat16"),
    ("C1024_one_tile", 1, 100, 1024, 5, "bfloat16"),
    ("C128_k61_odd", 1, 300, 128, 61, "bfloat16"),
    ("C200_k200", 2, 300, 200, 200, "bfloat16"),
    ("C40_k3", 6, 300, 40, 3, "bfloat16"),
    ("C40_k4", 6, 300, 40, 4, "bfloat16"),
    ("C37_k3", 6, 300, 37, 3, "bfloat16"),
    ("C24_k3", 6, 300, 24, 3, "bfloat16"),
    ("C8_k3", 6, 300, 8, 3, "bfloat16"),
    ("C5_k2", 6, 300, 5, 2, "bfloat16"),
    ("C1_k1", 4, 200, 1, 1, "bfloat16"),
    ("C100_k3", 6, 300, 100, 3, "bfloat16"),
    ("C1000_k5", 3, 200, 1000, 5, "bfloat16"),
    ("C1024_k5", 3, 200, 1024, 5, "bfloat16"),
    ("C128_k57", 4, 300, 128, 57, "bfloat16"),
    ("C128_k61", 4, 300, 128, 61, "bfloat16"),
    ("C37_k129", 3, 300, 37, 129, "bfloat16"),
    # f32: channels padded to 16 (C % 4 == 0 by 16-byte, else 4-byte
    # copies), resident / tap blocks / streamed weights, channel groups
    ("f32_C40_k3", 6, 300, 40, 3, "float32"),
    ("f32_C37_k3", 6, 300, 37, 3, "float32"),
    ("f32_C24_k5", 6, 300, 24, 5, "float32"),
    ("f32_C200_k5", 6, 300, 200, 5, "float32"),
    ("f32_C37_k11", 4, 300, 37, 11, "float32"),
    ("f32_C40_k4", 6, 300, 40, 4, "float32"),
    ("f32_C5_k1", 4, 200, 5, 1, "float32"),
    ("f32_C144_k3", 6, 300, 144, 3, "float32"),
    ("f32_C192_k3", 6, 300, 192, 3, "float32"),
    ("f32_C512_k5", 3, 300, 512, 5, "float32"),
    ("f32_C2048_k3", 2, 100, 2048, 3, "float32"),
    ("f32_C1990_k4", 2, 100, 1990, 4, "float32"),
)

#: the timed shapes (L 500): (name, N, C, k, dtype)
DOMAIN_TIMED = (
    ("bf16_C200_k5", 12288, 200, 5, "bfloat16"),
    ("bf16_C40_k3", 12288, 40, 3, "bfloat16"),
    ("bf16_C37_k3", 12288, 37, 3, "bfloat16"),
    ("bf16_C1024_k5", 1536, 1024, 5, "bfloat16"),
    ("bf16_C128_k61", 1536, 128, 61, "bfloat16"),
    ("f32_C40_k3", 1536, 40, 3, "float32"),
    ("f32_C192_k3", 1536, 192, 3, "float32"),
    ("f32_C512_k5", 1536, 512, 5, "float32"),
)


def _domain_forms(gen, x, bias, dyt, dev):
    """The forms of phase 3 for x: conv1, conv2, bias-only, and the model
    form with every extension; (kwargs, activation) each. ``gen`` is a
    generator on the CPU or on ``dev``."""
    import torch

    n, length, c = x.shape
    bf16 = x.dtype == torch.bfloat16
    gelu = "gelu_tanh" if bf16 else "gelu"
    dyt_kw = dict(bias=bias, dyt=dyt, use_dyt=True, bias_then_dyt=True)
    at = dict(generator=gen, device=gen.device)
    mask = (torch.rand(n, length, **at) > 0.2).to(dev)
    res = torch.randn(n, length, c, **at).to(dev, x.dtype)
    if gen.device.type != "cpu":
        return {"conv1": (dict(dyt_kw, in_mask=mask), gelu),
                "conv2": (dict(dyt_kw, residual=res), gelu),
                "bias_only": (dict(bias=bias), "none")}
    return {
        "conv1": (dict(dyt_kw, in_mask=mask), gelu),
        "conv2": (dict(dyt_kw, residual=res), gelu),
        "bias_only": (dict(bias=bias), "none"),
        "model": (dict(dyt_kw, **_extension_args(gen, x, "model", dev)),
                  gelu),
    }


def phase_domain(card: str) -> dict:
    """fused_conv_block on the shapes its resident bf16 route and its
    f32 ring took no plan for before (``DOMAIN_CASES``): each case in the
    three forms of phase 3 and the model form against the plain version
    (F32_TOL of the scale in f32, BF16_TOL in bf16, on the route its plan
    names); then the kernel table's new shapes (``DOMAIN_TIMED``, L 500)
    in the three forms, kernel, plain and library (cuDNN + the epilogue,
    TF32 off) timed with CUDA events beside the bound."""
    import torch

    from jaeger_tpu_torch.ops import fused_conv

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(1919)
    tf32_off()
    saved = fused_conv.launches, dict(fused_conv.route_launches)
    worst = {}
    for name, n, length, c, k, precision in DOMAIN_CASES:
        dt = getattr(torch, precision)
        route = fused_conv.conv_plan(c, k, dt).get("route", "wgmma")
        check(route != "wgmma", f"domain {name}: on the resident route")
        x, w, bias, dyt = _conv_inputs(gen, n, length, c, k, dt, dev)
        tol = F32_TOL if dt == torch.float32 else BF16_TOL
        errs = []
        for form, (kw, act) in _domain_forms(gen, x, bias, dyt, dev).items():
            before = fused_conv.route_launches[route]
            out = fused_conv.fused_conv_block(x, w, act=act, **kw)
            torch.cuda.synchronize()
            check(fused_conv.route_launches[route] == before + 1,
                  f"domain {name} {form}: route {route} not launched")
            ref = fused_conv.reference_conv_block(x, w, act=act, **kw)
            check(out.dtype == x.dtype and out.shape == x.shape,
                  f"domain {name} {form}: output {out.dtype} "
                  f"{tuple(out.shape)}")
            err = (out.float() - ref.float()).abs()
            scale = max(ref.float().abs().max().item(), 1.0)
            max_err = err.max().item()
            check(math.isfinite(max_err) and max_err <= tol * scale,
                  f"domain {name} {form}: max_abs_err {max_err:.3e} beyond "
                  f"{tol} of the scale {scale:.3e}")
            if "out_mask" in kw and "residual" not in kw:
                check(bool((out[~kw["out_mask"]] == 0).all()),
                      f"domain {name} {form}: out_mask positions not zero")
            errs.append(max_err / scale)
        worst[name] = max(errs)
        print(f"domain {name} ({precision}, N {n}, L {length}, C {c}, k {k},"
              f" route {route}): max error / scale {worst[name]:.3e} over "
              f"conv1, conv2, bias-only, model (tol {tol}) ok")
        del x, w, out, ref, err

    times = {}
    # the timed inputs are drawn on the card (N 12288 x 500 x 200 values
    # take seconds on the host)
    dgen = torch.Generator(device=dev).manual_seed(1920)
    for name, n, c, k, precision in DOMAIN_TIMED:
        dt = getattr(torch, precision)
        length = FLAG_L
        plan = fused_conv.conv_plan(c, k, dt)
        x = torch.randn(n, length, c, generator=dgen, device=dev).to(dt)
        w = torch.randn(k, c, c, generator=dgen, device=dev) * 0.05
        bias = torch.randn(c, generator=dgen, device=dev)
        dyt = torch.stack([torch.full((c,), 0.5, device=dev),
                           torch.randn(c, generator=dgen, device=dev),
                           torch.randn(c, generator=dgen, device=dev)])
        forms = _domain_forms(dgen, x, bias, dyt, dev)
        size = x.element_size()
        peak = PEAK_BF16_FLOPS if dt == torch.bfloat16 else PEAK_F32_FLOPS
        big = n * length * c * c * k > 4e11
        out = {}
        for form in ("conv1", "conv2", "bias_only"):
            kw, act = forms[form]
            got = fused_conv.fused_conv_block(x, w, act=act, **kw)
            ref = fused_conv.reference_conv_block(x, w, act=act, **kw)
            scale = max(ref.float().abs().max().item(), 1.0)
            err = (got.float() - ref.float()).abs().max().item()
            tol = F32_TOL if dt == torch.float32 else BF16_TOL
            check(math.isfinite(err) and err <= tol * scale,
                  f"domain timed {name} {form}: max_abs_err {err:.3e}")
            del got, ref
            kern = cuda_ms(lambda: fused_conv.fused_conv_block(
                x, w, act=act, **kw), iters=5 if big else 20)
            plain = cuda_ms(lambda: fused_conv.reference_conv_block(
                x, w, act=act, **kw), iters=1 if big else 2, warmup=1)
            lib = cuda_ms(lambda: library_conv_block(
                x, w, bias, kw.get("dyt"), act, kw.get("residual")),
                iters=5 if big else 10)
            flops = 2.0 * n * length * c * c * k
            nbytes = (size * n * length * c * (3 if "residual" in kw else 2)
                      + size * k * c * c + 4 * c * (4 if "dyt" in kw else 1)
                      + (n * length if "in_mask" in kw else 0))
            bound, by = _bound(flops, nbytes, peak)
            out[form] = dict(ms=kern, plain_ms=plain, library_ms=lib,
                             bound_ms=bound, bound_by=by, flops=flops,
                             bytes=nbytes, max_abs_err=err,
                             route=plan.get("route", "wgmma"))
            _print_timing(f"domain {name} {form} N={n} L={length} C={c} "
                          f"k={k} {precision}", out[form], card)
        times[name] = dict(out["bias_only"], plan=plan, conv1=out["conv1"],
                           conv2=out["conv2"])
        del x, w, forms
        torch.cuda.empty_cache()
    # checks and timings are not the path's launches
    fused_conv.launches = saved[0]
    fused_conv.route_launches.clear()
    fused_conv.route_launches.update(saved[1])
    return dict(cases=worst, times=times)


#: the domain's main path: the flagship with this many channels (k 7 entry
#: conv, DYT + NMD, three k 5 DYT residual blocks, crop 1505 nt)
DOMAIN_FILTERS = 200


def flagship_config_filters(filters: int) -> dict:
    """The flagship config with ``filters`` channels in place of 128."""
    from jaeger_tpu_torch.models.flagship import flagship_config

    cfg = flagship_config()
    for layer in cfg["model"]["representation_learner"]["hidden_layers"]:
        if layer.get("config", {}).get("filters") == 128:
            layer["config"]["filters"] = filters
    return cfg


def phase_flagship_c200(tmp: Path, card: str) -> dict:
    """The domain's main path: a seeded flagship with 200 channels, whose
    six residual convs a forward take route ``wgmma_stream`` in bf16 and
    ``f32_ring_pad`` in f32. ``predict`` on the test contigs at batch 2048
    in bf16 (counts reset just before, read just after: every
    fused_conv_block launch on wgmma_stream, six a forward), in f32 on the
    card and on the CPU on the last three of them (scores within 0.01;
    the CPU's f32 forward of all nine takes about 20 s), then the engine
    on windows of the flagship's batch (``_drive_flagship``: six launches
    a forward in each program, the forward against its plain version,
    windows/s)."""
    import torch

    from jaeger_tpu_torch import cli
    from jaeger_tpu_torch.models.artifacts import (init_params, load_state,
                                                   save_model)
    from jaeger_tpu_torch.models.builder import build_model
    from jaeger_tpu_torch.models.flagship import _CLASSES
    from jaeger_tpu_torch.ops import fused_conv, int8_conv

    cfg = flagship_config_filters(DOMAIN_FILTERS)
    state = init_params(cfg, torch.Generator().manual_seed(42))
    bundle = save_model(state, cfg, tmp / "flagship_c200_bundle")
    few = tmp / "test_contigs_last3.fasta"
    few.write_bytes(b"".join(_fasta_records(FASTA)[-3:]))
    runs, counts = {}, {}
    for name, fasta, extra in (
            ("gpu_bf16", FASTA, ["--batch", "2048"]),
            ("gpu_f32", few, ["--precision", "float32"]),
            ("cpu_f32", few, ["--precision", "float32", "--device", "cpu"])):
        out = tmp / f"flagship_c200_{name}"
        # the main path: counts reset just before, read just after
        fused_conv.launches = 0
        fused_conv.route_launches.clear()
        t0 = time.perf_counter()
        cli.main(["predict", "-i", str(fasta), "-o", str(out), "-m",
                  str(bundle), "--fsize", "1505"] + extra)
        wall = time.perf_counter() - t0
        counts[name] = dict(fused_conv.route_launches,
                            launches=fused_conv.launches, wall_s=wall)
        runs[name] = _read_tsv(out / f"{fasta.stem}_default_jaeger.tsv")
        _check_tsv(runs[name], _CLASSES, f"flagship C200 predict {name}",
                   9 if fasta == FASTA else 3)
    bf16, f32 = counts["gpu_bf16"], counts["gpu_f32"]
    check(bf16["launches"] > 0 and bf16["launches"] % 6 == 0
          and bf16.get("wgmma_stream") == bf16["launches"],
          f"flagship C200 bf16 predict: launches {bf16}")
    check(f32["launches"] > 0 and f32["launches"] % 6 == 0
          and f32.get("f32_ring_pad") == f32["launches"],
          f"flagship C200 f32 predict: launches {f32}")
    check(counts["cpu_f32"]["launches"] == 0,
          f"flagship C200 CPU predict launched {counts['cpu_f32']}")
    diff = _max_score_diff(runs["gpu_f32"], runs["cpu_f32"], _CLASSES)
    check(diff <= 0.01, f"flagship C200 f32: card vs CPU score diff {diff}")
    bf16_diff = _max_score_diff(
        [r for r in runs["gpu_bf16"]
         if r["contig_id"] in {q["contig_id"] for q in runs["cpu_f32"]}],
        runs["cpu_f32"], _CLASSES)
    print(f"flagship C200 predict on {card}: bf16 {bf16['launches']} "
          f"launches (wgmma_stream {bf16.get('wgmma_stream')}) in "
          f"{bf16['wall_s']:.2f} s; f32 {f32['launches']} launches "
          f"(f32_ring_pad {f32.get('f32_ring_pad')}), scores within "
          f"{diff:.2e} of the CPU's (tol 0.01; bf16 {bf16_diff:.3f})")
    model = build_model(cfg, dtype=torch.bfloat16)
    load_state(model, state)
    before = dict(fused_conv.route_launches)
    rates = _drive_flagship(model, "flagship C200",
                            {fused_conv: 6, int8_conv: 0}, False)
    check(fused_conv.route_launches["wgmma_stream"]
          - before.get("wgmma_stream", 0) > 0,
          "flagship C200 engine: no wgmma_stream launch")
    return dict(predict=counts, f32_score_diff=diff,
                bf16_score_diff=bf16_diff, rates=rates,
                launches=bf16["launches"], f32_launches=f32["launches"])


def _stream_variants(c: int, k: int) -> list[dict]:
    """``wgmma_stream`` plans for (C, k) beside ``conv_plan``'s: cluster
    sizes 1, 2 and 4 (streamed weights copied by TMA), other x / weight
    ring depths, resident weights against streamed ones, and another
    column width (C 200 in one block of 256, C 1024 in eight of 128); each
    valid for the C entry (it recomputes the layout)."""
    from jaeger_tpu_torch.ops import fused_conv

    base = fused_conv.conv_plan(c, k)
    steps = k * -(-c // fused_conv.STREAM_KW)
    out = [base]

    def add(**kw):
        v = dict(base, **kw)
        resident = v["wstages"] >= steps
        if resident or c % 8:
            v["cluster"] = 1
        v["smem"] = fused_conv.stream_plan_bytes(v["cb"], v["taps"],
                                                 v["stages"], v["wstages"])
        if v["smem"] <= fused_conv.SMEM_LIMIT and v not in out:
            out.append(v)

    def most_wstages(cb, stages):
        return max(w for w in range(1, 9) if fused_conv.stream_plan_bytes(
            cb, base["taps"], stages, w) <= fused_conv.SMEM_LIMIT)

    if base["wstages"] < steps:
        for cluster in (1, 2, 4):
            add(cluster=cluster)
        for stages in (2, 4):
            add(stages=stages,
                wstages=min(most_wstages(base["cb"], stages), 8))
        add(wstages=3)
    else:
        for stages in (2, 3):
            add(stages=stages)
        for cluster in (1, 2):
            add(stages=2, wstages=2, cluster=cluster)
    if c > 128:
        cb = 256 if c <= 256 else 128
        add(cb=cb, stages=2, wstages=min(most_wstages(cb, 2), 8))
    return out


def phase_domain_sweep(card: str) -> None:
    """``--domain --sweep``: the new routes under other launch plans, the
    bias-only form at L 500: ``wgmma_stream`` at C 200 k 5 and C 40 k 3 (N
    12288), C 1024 k 5 and C 128 k 61 (N 1536) under
    :func:`_stream_variants` (each held against the plain version once,
    5e-2 of the scale); the f32 forward at C 512 k 5 (N 1536) resident at
    CB 16 and streamed in blocks of 1 to 3 taps."""
    import torch

    from jaeger_tpu_torch.ops import fused_conv

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(2020)
    tf32_off()
    saved = fused_conv.launches, dict(fused_conv.route_launches)
    length = FLAG_L
    dgen = torch.Generator(device=dev).manual_seed(2021)
    for n, c, k in ((12288, 200, 5), (12288, 40, 3), (1536, 1024, 5),
                    (1536, 128, 61)):
        x = torch.randn(n, length, c, generator=dgen, device=dev).to(
            torch.bfloat16)
        w = (torch.randn(k, c, c, generator=dgen, device=dev) * 0.05).to(
            torch.bfloat16)
        bias = torch.randn(c, generator=dgen, device=dev)
        ref = fused_conv.reference_conv_block(x, w, bias)
        scale = max(ref.float().abs().max().item(), 1.0)
        bound = 2.0 * n * length * c * c * k / PEAK_BF16_FLOPS * 1e3
        for plan in _stream_variants(c, k):
            got = fused_conv._launch(x, w, bias, None, "none", None, None,
                                     None, plan)
            err = (got.float() - ref.float()).abs().max().item()
            check(math.isfinite(err) and err <= BF16_TOL * scale,
                  f"sweep wgmma_stream C={c} k={k} {plan}: max_abs_err "
                  f"{err:.3e}")
            del got
            ms = cuda_ms(lambda: fused_conv._launch(
                x, w, bias, None, "none", None, None, None, plan), iters=5)
            print(f"sweep wgmma_stream N={n} C={c} k={k} cb={plan['cb']} "
                  f"taps={plan['taps']} stages={plan['stages']} "
                  f"wstages={plan['wstages']} cluster={plan['cluster']} "
                  f"bias_only on {card}: {ms:.3f} ms ({bound / ms:.1%} of "
                  f"the bound {bound:.3f} ms)", flush=True)
        del x, w, ref
        torch.cuda.empty_cache()
    n, c, k = 1536, 512, 5
    x, w, bias, _ = _conv_inputs(gen, n, length, c, k, torch.float32, dev)
    bound = 2.0 * n * length * c * c * k / PEAK_F32_FLOPS * 1e3
    for cb, taps, stages in ((16, 5, 2), (32, 1, 2), (16, 1, 2), (16, 2, 2),
                             (16, 3, 2), (64, 1, 2)):
        smem = fused_conv.f32_plan_bytes(c, k, cb, stages, taps)
        if smem > fused_conv.SMEM_LIMIT:
            continue
        plan = dict(route="f32_ring", cb=cb, kw=0, tile=fused_conv.F32_TILE,
                    taps=taps, stages=stages, smem=smem)
        ms = cuda_ms(lambda: fused_conv._launch(
            x, w, bias, None, "none", None, None, None, plan), iters=3)
        print(f"sweep f32 N={n} C={c} k={k} cb={cb} taps={taps} "
              f"stages={stages} bias_only on {card}: {ms:.3f} ms "
              f"({bound / ms:.1%} of the bound {bound:.3f} ms)")
    del x, w
    fused_conv.launches = saved[0]
    fused_conv.route_launches.clear()
    fused_conv.route_launches.update(saved[1])


#: the flags that run one part of the script in place of the full run
PART_FLAGS = ("--domain", "--f32", "--backward", "--host", "--hyena",
              "--int8-zoo", "--legacy", "--commands", "--ragged", "--multi",
              "--convert", "--pretrain", "--templates", "--adamw")
#: wall seconds of each phase of the full run, by name
PHASE_SECONDS: dict[str, float] = {}


def timed(name: str, fn, *args):
    """``fn(*args)``; its wall seconds printed and kept in
    :data:`PHASE_SECONDS` under ``name``."""
    t0 = time.perf_counter()
    out = fn(*args)
    PHASE_SECONDS[name] = time.perf_counter() - t0
    print(f"phase {name}: {PHASE_SECONDS[name]:.1f} s", flush=True)
    return out


def main(argv: list[str]) -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not (ROOT / "jaeger_tpu_torch").is_dir() or not FASTA.exists():
        print("chip_smoke: run it from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    if argv[:1] == ["--cli-worker"]:
        return cli_worker(argv[1:])
    if argv[:1] == ["--train-worker"]:
        return train_worker(argv[1:])
    quick = "--quick" in argv
    t_start = time.perf_counter()
    try:
        card = phase_device()
        mode = next((a for a in argv if a in PART_FLAGS), None)
        if mode in ("--f32", "--domain"):
            phase_build(("fused_conv_block", "fused_conv_wgrad",
                         "conv_epilogue_bwd"))
        elif mode == "--adamw":
            phase_build(("fused_adamw",))
        elif mode:
            phase_build()
        else:
            # the full run: int8_conv, the longest build, goes on while
            # the phases that need none of it run
            join_build = phase_build(later=("int8_conv",))
        if "--adamw" in argv:
            adamw = phase_fused_adamw(card)
            print(json.dumps({"fused_adamw": adamw}, default=str))
            print(f"adamw run done in {time.perf_counter() - t_start:.0f} s")
            return 0
        if "--domain" in argv:
            domain = phase_domain(card)
            if "--sweep" in argv:
                phase_domain_sweep(card)
            with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
                route = phase_route(Path(tmp), card)
                c200 = phase_flagship_c200(Path(tmp), card)
            print(json.dumps({"domain": domain, "route": route,
                              "flagship_c200": c200}, default=str))
            print(f"domain run done in "
                  f"{time.perf_counter() - t_start:.0f} s")
            return 0
        if "--f32" in argv:
            f32 = dict(forward=phase_f32_kernel(card),
                       backward=phase_f32_train_kernel(card),
                       shapes=phase_f32_shapes(card),
                       steps=phase_train_steps_f32())
            if "--sweep" in argv:
                phase_f32_sweep(card)
            print(json.dumps({"f32": f32}, default=str))
            print(f"f32 run done in {time.perf_counter() - t_start:.0f} s")
            return 0
        if "--backward" in argv:
            phase_train_kernel(card)
            phase_f32_train_kernel(card)
            if "--sweep" in argv:
                phase_train_sweep(card)
            print(f"backward run done in {time.perf_counter() - t_start:.0f} s")
            return 0
        if "--host" in argv:
            with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
                host = phase_host_pipeline(
                    Path(tmp), flagship_bundle(Path(tmp)), card)
            print(json.dumps({"host_pipeline": host}))
            print(f"host run done in {time.perf_counter() - t_start:.0f} s")
            return 0
        if "--hyena" in argv:
            with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
                hyena = phase_hyena(Path(tmp), card)
            hyena.update(routes=phase_hyena_routes(card),
                         bilstm=phase_bilstm(card),
                         bilstm_zoo_f32=phase_zoo_f32(bilstm_zoo_config(),
                                                      "bilstm zoo"))
            print(json.dumps({"hyena": hyena}))
            print(f"hyena run done in {time.perf_counter() - t_start:.0f} s")
            return 0
        if "--int8-zoo" in argv:
            ragged = phase_ragged_kernel(card)
            with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
                bundles = train_zoo_bundles(Path(tmp), INT8_ZOO)
                zoo8 = phase_int8_zoo(Path(tmp), card, bundles)
                ens = phase_ensemble(Path(tmp), card, bundles)
            print(json.dumps({"ragged_route": ragged, "int8_zoo": zoo8,
                              "ensemble": ens}))
            print(f"int8 zoo run done in "
                  f"{time.perf_counter() - t_start:.0f} s")
            return 0
        if "--legacy" in argv:
            with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
                route = phase_route(Path(tmp), card)
                stride = phase_ragged_stride(card)
                strided = phase_int8_strided_predict(Path(tmp), card)
                legacy = phase_legacy(Path(tmp), card)
            print(json.dumps({"route": route, "ragged_stride": stride,
                              "int8_strided_predict": strided,
                              "legacy": legacy}))
            print(f"legacy run done in "
                  f"{time.perf_counter() - t_start:.0f} s")
            return 0
        if "--commands" in argv:
            with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
                commands = phase_commands(Path(tmp), card,
                                          flagship_bundle(Path(tmp)))
            print(json.dumps({"commands": commands}))
            print(f"commands run done in "
                  f"{time.perf_counter() - t_start:.0f} s")
            return 0
        if "--ragged" in argv:
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(1) as pool:
                probes = pool.submit(build_ragged_probes)
                ragged = phase_ragged_kernel(card)
                stride = phase_ragged_stride(card)
                cycles = phase_ragged_cycles(card, probes.result())
            print(json.dumps({"ragged_route": ragged, "ragged_stride": stride,
                              "ragged_cycles": cycles}))
            print(f"ragged run done in "
                  f"{time.perf_counter() - t_start:.0f} s")
            return 0
        if "--multi" in argv:
            with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
                multi = phase_multi(Path(tmp), card,
                                    flagship_bundle(Path(tmp)))
            print(json.dumps({"multi": multi}))
            print(f"multi run done in "
                  f"{time.perf_counter() - t_start:.0f} s")
            return 0
        if "--convert" in argv:
            with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
                convert = phase_convert(Path(tmp), card,
                                        flagship_bundle(Path(tmp)))
            print(json.dumps({"convert": convert}))
            print(f"convert run done in "
                  f"{time.perf_counter() - t_start:.0f} s")
            return 0
        if "--pretrain" in argv:
            with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
                pretrain = phase_pretrain(Path(tmp), card)
            print(json.dumps({"pretrain": pretrain}))
            print(f"pretrain run done in "
                  f"{time.perf_counter() - t_start:.0f} s")
            return 0
        if "--templates" in argv:
            kern_zoo = phase_templates_kernel(card)
            with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
                zoo = phase_templates(Path(tmp), card)
                zoo.pop("bundles")
            zoo_f32 = phase_zoo_f32()
            print(json.dumps({"templates": zoo, "templates_kernels": kern_zoo,
                              "zoo_f32": zoo_f32}))
            print(f"templates run done in "
                  f"{time.perf_counter() - t_start:.0f} s")
            return 0
        # the phases that need no int8_conv run while its nvcc goes on
        kern = timed("kernel", phase_kernel, card)
        kern_f32 = timed("f32_kernel", phase_f32_kernel, card)
        kern_train = timed("train_kernel", phase_train_kernel, card)
        kern_f32_train = timed("f32_train_kernel", phase_f32_train_kernel,
                               card)
        kern_f32_shapes = timed("f32_shapes", phase_f32_shapes, card)
        domain = timed("domain", phase_domain, card)
        timed("build_int8_conv", join_build)
        kern8 = timed("int8_kernel", phase_int8_kernel, card)
        if "--sweep" in argv:
            phase_sweep(card)
            phase_int8_sweep(card)
            phase_train_sweep(card)
            phase_domain_sweep(card)
        if quick:
            print(f"quick run done in {time.perf_counter() - t_start:.0f} s")
            return 0
        profile = "--profile" in argv
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            rates = timed("flagship", phase_flagship, profile)
            bundle = timed("flagship_bundle", flagship_bundle, Path(tmp))
            rates8 = timed("int8_flagship", phase_int8_flagship, bundle,
                           profile)
            launches = timed("predict", phase_predict, Path(tmp), bundle)
            launches8 = timed("int8_predict", phase_int8_predict, Path(tmp),
                              bundle)
            steps_f32 = timed("train_steps_f32", phase_train_steps_f32)
            train = timed("train_flagship", phase_train_flagship, Path(tmp),
                          card)
            timed("train_predict", phase_train_predict, Path(tmp),
                  train["bundle"])
            adamw = timed("fused_adamw", phase_fused_adamw, card)
            host = timed("host_pipeline", phase_host_pipeline, Path(tmp),
                         bundle, card)
            kern_zoo = timed("templates_kernel", phase_templates_kernel, card)
            zoo = timed("templates", phase_templates, Path(tmp), card)
            zoo_f32 = timed("zoo_f32", phase_zoo_f32)
            hyena = timed("hyena", phase_hyena, Path(tmp), card)
            hyena.update(routes=timed("hyena_routes", phase_hyena_routes,
                                      card),
                         bilstm=timed("bilstm", phase_bilstm, card),
                         bilstm_zoo_f32=timed(
                             "bilstm_zoo_f32", phase_zoo_f32,
                             bilstm_zoo_config(), "bilstm zoo"))
            ragged = timed("ragged_kernel", phase_ragged_kernel, card)
            bundles = zoo.pop("bundles")
            zoo8 = timed("int8_zoo", phase_int8_zoo, Path(tmp), card, bundles)
            ens = timed("ensemble", phase_ensemble, Path(tmp), card, bundles)
            route = timed("route", phase_route, Path(tmp), card)
            stride = timed("ragged_stride", phase_ragged_stride, card)
            strided = timed("int8_strided_predict",
                            phase_int8_strided_predict, Path(tmp), card)
            legacy = timed("legacy", phase_legacy, Path(tmp), card)
            commands = timed("commands", phase_commands, Path(tmp), card,
                             bundle)
            pretrain = timed("pretrain", phase_pretrain, Path(tmp), card)
            multi = timed("multi", phase_multi, Path(tmp), card, bundle)
            convert = timed("convert", phase_convert, Path(tmp), card, bundle)
            c200 = timed("flagship_c200", phase_flagship_c200, Path(tmp),
                         card)
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        return 1
    summary = {"card": card, "flagship_windows_per_s": rates,
               "flagship_int8_windows_per_s": rates8,
               "fused_conv_conv2_form": kern["conv2"],
               "fused_conv_bias_only_form": kern["bias_only"],
               "fused_conv_data_gradient": kern_train["dgrad"],
               "int8_conv_conv2_form": kern8["conv2"],
               "int8_conv_bias_only_form": kern8["bias_only"],
               "int8_conv_requant_pallas_shape": kern8["requant"],
               "train_steps_f32": steps_f32,
               "fused_conv_f32_shapes": kern_f32_shapes,
               "fused_conv_f32": kern_f32,
               "f32_backward": kern_f32_train,
               "train_flagship": {k: v for k, v in train.items()
                                  if k != "bundle"},
               "fused_adamw": adamw,
               "conv_epilogue_bwd_conv1_form": {
                   k: kern_train["conv_epilogue_bwd"][k]
                   for k in ("conv1_ms", "conv1_bound_ms")},
               "conv_wgrad_plan": kern_train["conv_wgrad"]["plan"],
               "host_pipeline": host, "templates": zoo,
               "templates_kernels": kern_zoo, "zoo_f32": zoo_f32,
               "hyena": hyena, "int8_zoo": zoo8, "ensemble": ens,
               "route": route, "int8_strided_predict": strided,
               "legacy": legacy, "commands": commands,
               "pretrain": pretrain, "multi": multi, "convert": convert,
               "domain": domain, "flagship_c200": c200,
               "phase_seconds": PHASE_SECONDS}
    print(json.dumps(summary, default=str))
    print(f"all phases passed in {time.perf_counter() - t_start:.0f} s")
    print(card)

    def entry(name, route, source, replaces, n, k, **extra):
        return {"name": name, "route": route, "source": source,
                "replaces": replaces, "launches": n,
                "max_abs_err": k["max_abs_err"], "ms": k["ms"],
                "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
                "bound_by": k["bound_by"], "library_ms": k["library_ms"],
                "bound_share": k["bound_ms"] / k["ms"], **extra}

    tl = train["launches"]
    f32_routes = {name: st["routes"] for name, st in steps_f32.items()}
    pl = pretrain["stages"]["projection"]["launches"]
    zl = zoo["launches"]
    hl = hyena["launches"]
    ml = multi["launches"]

    def at_templates(key, n):
        """The kernel at the templates' residual-conv shape: launches on
        phase 8's path and this run's numbers at that shape."""
        return dict({k: kern_zoo[key][k] for k in (
            "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
            "max_abs_err")}, launches=n, shape=zoo_shape)

    zoo_shape = f"N={ZOO_N} L={ZOO_L} C={ZOO_C} k={ZOO_K} bf16"
    from jaeger_tpu_torch.ops import fused_conv

    print(json.dumps({"kernels": [
        # predict's main path; train launches it for the forward, the
        # recomputed DYT input and the data gradient; the templates' path
        # for the attention templates' residual convs (bias-only forward
        # and the data gradient)
        entry("fused_conv_block", "cuda",
              "jaeger_tpu_torch/csrc/fused_conv_block.cu",
              "jaeger_tpu/ops/pallas_conv.py:70", launches, kern,
              train_launches=tl["fused_conv_block"],
              predict_at_scale_launches=host["launches"],
              templates=at_templates("fused_conv_block",
                                     zl["fused_conv_block"]),
              templates_dgrad=at_templates("dgrad", zl["fused_conv_block"]),
              hyena_launches=hl["fused_conv_block"],
              route_predict_launches=route["predict_launches"],
              commands_launches=commands["launches"],
              pretrain_launches=pl["fused_conv_block"],
              relgen_launches=pretrain["stages"]["generation"]["launches"][
                  "fused_conv_block"],
              multi_launches=ml["fused_conv_block"],
              convert_launches=convert["launches"]["fused_conv_block"]),
        entry("int8_conv", "cuda", "jaeger_tpu_torch/csrc/int8_conv.cu",
              "experiments/pallas_int8_conv.py:67", launches8, kern8,
              templates_launches=zl["int8_conv"],
              hyena_launches=hl["int8_conv"],
              int8_zoo_launches=zoo8["launches"]["int8_conv"],
              ragged_route=dict(ragged,
                                launches=zoo8["launches"]["ragged"]),
              ragged_stride=dict(stride,
                                 launches=strided["launches"]["ragged"]),
              multi_launches=ml["int8_conv"],
              convert_launches=convert["launches"]["int8_conv"]),
        # train's main path: the backward of the fused conv block
        entry("conv_wgrad", "cuda",
              "jaeger_tpu_torch/csrc/fused_conv_wgrad.cu",
              "jaeger_tpu/ops/pallas_conv.py:70", tl["conv_wgrad"],
              kern_train["conv_wgrad"],
              host_us=kern_train["conv_wgrad"]["host_us"],
              templates=at_templates("conv_wgrad", zl["conv_wgrad"]),
              hyena_launches=hl["conv_wgrad"],
              pretrain_launches=pl["conv_wgrad"],
              multi_launches=ml["conv_wgrad"]),
        # the f32 forms (other kernel functions of the same sources): the
        # forward and the data gradient on route f32_ring, its launches in
        # phase 15's f32 engine forwards and by route in phase 6's f32
        # steps; the table's further shapes (k 11, k 31, C 16 / 48 / 96)
        entry("fused_conv_block_f32", "cuda",
              "jaeger_tpu_torch/csrc/fused_conv_block.cu",
              "jaeger_tpu/ops/pallas_conv.py:70",
              convert["routes"]["fused_conv_block:f32_ring"], kern_f32,
              kernel="conv_f32_ring", form="conv1",
              conv2=kern_f32["conv2"], bias_only=kern_f32["bias_only"],
              dgrad=kern_f32_train["dgrad"],
              f64_rel_err=kern_f32["f64_rel_err"],
              shapes={k: v for k, v in kern_f32_shapes.items()
                      if not k.startswith("wgrad")},
              convert_routes=convert["routes"],
              train_f32_routes=f32_routes),
        entry("conv_wgrad_f32", "cuda",
              "jaeger_tpu_torch/csrc/fused_conv_wgrad.cu",
              "jaeger_tpu/ops/pallas_conv.py:70",
              sum(r["conv_wgrad:fma_ring"] for r in f32_routes.values()),
              kern_f32_train["conv_wgrad"], kernel="wgrad_f32_ring",
              shapes={k: v for k, v in kern_f32_shapes.items()
                      if k.startswith("wgrad")},
              train_f32_routes=f32_routes),
        entry("conv_epilogue_bwd", "cuda",
              "jaeger_tpu_torch/csrc/conv_epilogue_bwd.cu",
              "jaeger_tpu/ops/pallas_conv.py:70", tl["conv_epilogue_bwd"],
              kern_train["conv_epilogue_bwd"],
              f32=dict(kern_f32_train["conv_epilogue_bwd"], launches=sum(
                  st["launches"]["conv_epilogue_bwd"]
                  for st in steps_f32.values())),
              host_us=kern_train["conv_epilogue_bwd"]["host_us"],
              templates=at_templates("conv_epilogue_bwd",
                                     zl["conv_epilogue_bwd"]),
              hyena_launches=hl["conv_epilogue_bwd"],
              pretrain_launches=pl["conv_epilogue_bwd"],
              multi_launches=ml["conv_epilogue_bwd"]),
        # the shapes the resident layouts cannot hold (phase 16): route
        # wgmma_stream at the C 200 flagship's residual conv (conv1 form),
        # its launches in that flagship's bf16 predict; route
        # f32_ring_pad at C 40 (conv1 form), its launches in that
        # flagship's f32 predict; every timed shape and form beside them
        entry("fused_conv_block_stream", "cuda",
              "jaeger_tpu_torch/csrc/fused_conv_block.cu",
              "jaeger_tpu/ops/pallas_conv.py:70", c200["launches"],
              domain["times"]["bf16_C200_k5"]["conv1"],
              kernel="conv_bf16_stream<CB>", form="conv1",
              instances=[f"conv_bf16_stream<{cb}>"
                         for cb in fused_conv.STREAM_WIDTHS],
              shape="N=12288 L=500 C=200 k=5 bf16",
              flagship_c200_rates=c200["rates"],
              route_predict_launches=sum(
                  v["predict_launches"] for v in route["cases"].values()
                  if v["route"] == "wgmma_stream"),
              shapes={k: v for k, v in domain["times"].items()
                      if k.startswith("bf16")},
              cases=domain["cases"]),
        entry("fused_conv_block_f32_pad", "cuda",
              "jaeger_tpu_torch/csrc/fused_conv_block.cu",
              "jaeger_tpu/ops/pallas_conv.py:70", c200["f32_launches"],
              domain["times"]["f32_C40_k3"]["conv1"],
              kernel="conv_f32_ring<CB, TAPS, true>", form="conv1",
              shape="N=1536 L=500 C=40 k=3 f32",
              shapes={k: v for k, v in domain["times"].items()
                      if k.startswith("f32")}),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
