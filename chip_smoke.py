"""Drive the PyTorch port (``tpuhar_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py                # every phase
    python3 chip_smoke.py --phase 30     # phases 1 and 2, then the phases named
    python3 chip_smoke.py --phase 21,22  # (comma-separated) and those they read

With ``--phase`` the script runs the card's and the build's phases 1 and 2, the phases
named and every phase whose results they read (``PHASE_NEEDS``: 22 reads 21's dataset),
and prints the same last line. Each phase holds its own paths to their exact launch
counts; the check that every kernel was launched by some main path runs only when all
phases run. The kernels line lists every kernel with the launches this run counted, and
with phase 3's checks and times where phase 3 ran.

Phases; any failed check raises and the exit code is non-zero:

1. the card (``nvidia-smi``) and the torch and CUDA versions;
2. the kernel build from ``tpuhar_torch/csrc/`` (nvcc, sm_90a, one process per
   source), timed;
3. each hand kernel against its plain PyTorch version on the card, at the shapes the
   main paths give it, with both times (CUDA events, after warm-up), the time of one
   PyTorch call that computes the same function where there is one, and the bound (the
   least time the card could take: bytes over 3.35 TB/s or operations over the peak
   rate of their type): the featurizer (its time a CUDA graph's per launch, the
   wrapper's host time per call apart, at batch 8, 256 and 8192: a few microseconds of
   device work, which events around eager calls would measure as the host's pace),
   the bf16 conv (beside ``F.conv2d``) and its f32 form (split-TF32 products) at the dry
   run's shapes and at full width at batch 256 (against its plain version in float64 on
   the first 64 frames, beside ``F.conv2d`` in f32 with TF32 off and, for reference, on,
   and its bound at the split products' rate and at the FFMA rate), the int8
   stem's byte-map preflight, the uint8 stem GEMM (beside ``torch._int_mm`` on the
   mapped codes) and the int8 conv (both bit for bit; the int8 conv beside
   ``torch._int_mm`` on its im2col matrix and beside the bf16 conv's time, with their
   ratio), the int8 GEMM (the stem kernel without its byte map, bit for bit at the int8
   towers' shapes with f32 and int8 out, beside ``torch._int_mm``, the ViT's four
   products timed again at batch 64) and the int8 conv with ResNet-18's explicit
   ``(1, 1)`` at stride 2, flash attention (beside ``F.scaled_dot_product_attention``,
   with its TFLOP/s);
4. the flagship bf16 fusion forward at full width (``entry.build_forward``) answering
   three batch-8 requests, with each kernel's launch count in that run;
5. the same parameters in f32 on the CPU (plain paths) at batch 2, against the card;
6. the int8-resident serving forward at full width (``entry.build_int8_forward``,
   calibrated and recalibrated on the card) answering three batch-8 requests, with the
   launch counts of that run (the counts are reset after the build); the baseline int8
   forward answering one;
7. the same quantized tree and logit map on the CPU's plain paths at batch 2, against
   the card: the int8 tower's features and the logits;
8. the ``videomae_base`` ViT forward at full width and depth (``entry.build_forward(
   vit_config())``, its attention through the flash kernel) answering three batch-8
   requests of raw NHWC clips, with the launch counts of that run;
9. the same ViT parameters in f32 on the CPU (plain paths) at batch 1, against the card;
10. step time, inferences/s and peak memory: bf16 and ViT at batch 8 and 256,
    int8-resident at 8 and 256, the baseline int8 forward at 256;
11. the int8 tree the card serves against the one the CPU builds from the same
    parameters and clips (every site's ``x_scale`` and ``w_q``, exactly);
12. the flash-attention backward kernels (dK/dV and dQ) against autograd through the
    plain attention on the card, with the forward's log-sum-exp, at the pretraining
    shapes, the ragged tiny ones and the dK/dV kernel's block boundaries, dK/dV bit for
    bit across two calls, with their times beside the plain backward, the backward of
    ``F.scaled_dot_product_attention`` and the bound; and the training forward (the
    log-sum-exp and the f32 output stored) beside SDPA's forward at batch 16;
13. cross-modal SigLIP pretraining of ``videomae_base`` at full width and depth
    (``entry.build_pretrain_task(pretrain_config())``): ``CrossModalTrainer.fit`` over one
    epoch of four seeded batches of 16 and one validation batch, with its launch counts
    (12 flash forwards a forward, 12 launches of each backward kernel a train step),
    finite losses, every parameter moved, and a checkpoint written and restored;
14. the same first step at batch 4 against the plain path on the card (f32, attention
    without flash, TF32 off), beside the bf16 step with the plain attention: the loss,
    the SigLIP scalars' gradients and the whole gradient; and each of the step's flash
    backwards against the plain f32 backward on its own operands;
15. the train step's time at batch 16, samples/s and peak memory;
16. the serving engine (``serving.InferenceEngine``) at full width: the bf16 flagship and
    its int8-resident form at batch sizes 8 and 256, the ``videomae_base`` ViT with
    ``fast_attention=True`` at 8 and 64, each size one CUDA graph. The launches each graph
    holds (counted at capture: a replay calls no wrapper) against the eager forward's;
    ``predict`` at 8 against the eager program of phases 4, 6 and 8 on the same padded
    inputs and ``predict_stream`` over four batches against ``predict``, bit for bit; at
    each size the replay's time on device-resident inputs beside the eager step's,
    ``predict``'s split into host prep, upload, replay and readback, ``predict_stream``'s
    time a batch, ``benchmark_engine`` and ``latency_summary``;
17. the classification stage at full width: the flagship's IMU classifier
    (``entry.classify_config()``: d=128, 4 layers, 91 tokens, 32 classes) at batch 64,
    three linear-probe then three finetune steps through ``ClassificationTrainer.fit``
    (the probe leaves the encoder bit for bit, every head parameter moves); the fusion
    classifier on ``videomae_base`` with the flash kernels at batch 16 through ``fit``
    (12 flash forwards with the LSE and 12 launches of each backward kernel a step, 12
    forwards an eval batch), its first step at batch 4 against the plain f32 path on the
    card as phase 14 holds pretraining's, its ``last`` checkpoint served through
    ``InferenceEngine.from_checkpoint`` bit for bit against an engine of the trained
    variables; the video-only classifier's two steps with the same launches; each
    program's step time, samples/s and peak memory;
18. the other towers and IMU encoders at full width (224², 16 frames): cross-modal
    pretraining with the ``tpu_cnn`` tower through ``CrossModalTrainer.fit`` at batch 16
    (every parameter and BatchNorm statistic moves; the validation forward serves the
    tower through the fused conv kernel), its first step at batch 4 against the plain
    f32 step on the card, and the trained tower's eval forward through the fused conv
    kernel (4 launches) against ``conv3x3_bn_act_reference`` on the same variables; the
    fusion classifier with ResNet-18 and with MobileNetV2 through
    ``ClassificationTrainer.fit`` at batch 16, each ``last`` checkpoint served by
    ``InferenceEngine.from_checkpoint`` through a CUDA graph at batch 8, the replay bit
    for bit against the eager program; the ``videomae_base`` pretraining step with
    ``remat_video`` against the same step without it (24 flash forwards, 12 of each
    backward kernel; the loss and every gradient; peak memory of both); the IMU
    classifier's finetune with the 1-D CNN and with the STFT encoder at batch 64, each
    served IMU-only at 8 and 256 (the featurizer once a graph); each program's step
    time, samples/s and peak memory;
19. the int8 towers at full width (224², 16 frames): the int8 ``videomae_base`` ViT
    (phase 8's configuration and weights) served by ``InferenceEngine(quantize_calib_
    clips=...)`` at 8 and 64 (a graph holds one featurizer, one stem and 48 int8 GEMM
    launches), its build split into the CPU calibration and the recalibration on the
    card, its eager tower at 8 and 64 and its eager program at 8 bit for bit against the
    same with the kernels' plain versions in their place, its tokens correlated with the
    f32 mirror; the int8 ResNet-18 (``pretrain_config()`` with ``resnet18``, random
    weights), baseline and resident engines at 8 (one featurizer, 4 int8 GEMM and 16
    int8 conv launches a graph), each likewise against its plain-kernel program, and the
    resident-vs-baseline logit drift; each replay bit for bit with the eager program,
    with its time, inf/s and peak memory;
20. the evaluate stage at full width: weights I/O, zero-shot, leave-one-out with the
    fusion classifier, the parallel few-shot harness, ``Evaluator`` and calibration, on
    their cores and then over manifests written here;
21. the pipeline from raw files: a synthetic dataset (4 classes, 224² mp4v video) through
    the port's command line in process (``cli.main``, ``--mode all`` then ``--mode serve``)
    at ``pretrain_config()``'s full width, every artifact checked and each stage's kernel
    launches held to what it runs, each stage's wall time and the served windows/s; the
    preprocessor's window-scope route on the card against the CPU and its device route
    against the host route;
22. data parallel over a mesh and the loader backends, on phase 21's dataset and frame
    banks: the card's machine probed (``jpeglib.h``, the native decoder's build, whether
    grain is installed, the CPU count); a 16-frame 224² clip's decode timed with OpenCV,
    the native decoder and the process pool; three loaders (the default ``BatchLoader``,
    ``BatchLoader(decode_processes=2)`` reading with ``backend="native"``, and
    ``GrainBatchLoader(workers=2)``) giving equal batches; then in process an NCCL group
    of one and ``create_mesh()``: two ``videomae_base`` pretraining steps at batch 16
    through ``CrossModalTrainer(mesh=)`` from the pool loader's batches (24 flash
    forwards, 24 of each backward kernel), the trained parameters bit for bit those of
    the same two steps without a mesh from the default loader's; the flagship bf16
    ``InferenceEngine(mesh=)`` at batch 8 (one featurizer and 4 fused convs a graph), its
    ``predict`` and ``predict_stream`` bit for bit the engine's without a mesh;
23. tensor parallel on the card: two spawned processes on cuda:0 over a gloo group (NCCL
    refuses two ranks on one device), mesh ``(1, 2)``: phase 22's two ``videomae_base``
    pretraining steps at batch 16 through ``CrossModalTrainer(mesh=)`` with the ViT's 12
    heads split 6 + 6 and the flagship IMU encoder's 8 split 4 + 4 (24 flash forwards and
    24 of each backward kernel a rank, at ``(16, 6, 1568, 64)``), each step's time and
    the time in gloo's all-reduces; the losses and the ``last`` checkpoint (whole
    tensors) against phase 22's steps without a mesh; the flagship IMU classifier's TP
    checkpoint served by ``InferenceEngine.from_checkpoint`` against an engine of the same
    steps without a mesh; the bf16 flagship ``InferenceEngine(mesh=)`` bit for bit the
    engine's without one (one featurizer and 4 fused convs a graph); the flash kernels
    against their plain versions at a rank's shape;
24. the centered int8 wire and the validation workflows: the stem on ``center_u8`` codes
    (through the int8 GEMM kernel) against the uint8 wire of the same pixels and the plain
    version, bit for bit over every byte value at ``(4096·196, 768) -> 256`` int8 out,
    both forms timed in turns; the int8-resident flagship ``InferenceEngine(int8_wire=
    "centered")`` at 8 and 256 against the uint8 engine, bit for bit on a replay and
    eagerly, with the launches a replay holds and both engines' replay and ``predict``
    times in turns; then ``bench_accuracy`` (``tpu_cnn`` and ResNet-18 at 224², 16
    frames, 3 classes, one epoch, held-out classes 0 and 1), ``validate_int8_ood`` on
    each tower's checkpoints (per class the f32 and int8 AUROCs, their gaps and the
    largest logit gap between the paths), ``rescore_ood_hard`` on the same checkpoints and
    ``article_workflow --quick`` (in a second process started with the phase), each JSON
    under ``outputs/torch/`` parsed and held to the JAX script's keys and finite numbers,
    with each workflow's kernel launches;
25. the research probes and debug scripts, each through its module's ``run``: (a)
    ``measure_resident_drift`` at 3 seeds, the int8 ResNet-18 at 32² (the int8 conv down
    to 1² maps, 16-row products), each engine's graph (one featurizer, 4 ``int8_gemm``,
    16 ``conv3x3_i8``), its replay bit for bit with its eager program and that with its
    plain-kernel program, each seed's correlation and drift against the CPU's; (b)
    ``debug_ckpt_data_match`` on phase 24's ``tpu_cnn`` checkpoint (4 fused convs a
    forward), its confusion matrix against the CPU's; (c) on a hard fixture of their own,
    ``debug_pretrain_parity`` (4 steps; the card's f32 arms against ``cpu_f32``, and the
    TF32 arm's gap), ``debug_pretrain_loop``, ``probe_pretrain_collapse``,
    ``probe_imu_hard_lr`` and ``probe_coupling_strength`` at strength 8, none launching a
    hand kernel; every JSON held to the JAX script's keys and finite numbers;
26. the timing and decomposition scripts, each through its module's ``run`` at full
    width (cut in batch, iterations, one trial, fixture size and ``--min-windows``, each
    cut printed): ``bench_train``, ``bench_preprocess``, ``bench_loader``,
    ``bench_serving_stream`` in bf16 and ``--int8`` on phase 24's fixture (its
    ``predict_stream`` logits equal its ``predict`` logits), ``perf_decompose``,
    ``perf_nonvideo``, ``perf_quant``, ``perf_int8_stages`` (its prefix 5 bit for bit
    with ``quant_tpucnn_forward_resident``, with the kernels and with their plain
    versions), ``perf_vit_stages``, ``perf_sweep``, ``perf_tpucnn_variants``,
    ``perf_trace`` and ``generate_tables --demo``; each dict held to its keys, each
    number finite or null, with each hand kernel's launches per script; the floors of
    ``utils/roofline`` against phase 3's bounds of the int8 conv and the stem;
27. ``entry.dryrun_multichip(4)`` (``__graft_entry__.dryrun_multichip``'s twin): four
    spawned ranks on cuda:0 over gloo, the ``(2, 2)`` and then the ``(4, 1)`` mesh, each
    a fully sharded fusion train step at the tiny sizes and the ``tpu_cnn`` bf16 and
    int8 engines over the mesh (the featurizer, the bf16 conv at 2² and 1² maps, the
    uint8 stem, the int8 conv and the f32 conv), the int8 logits against an engine's
    without a mesh within 1e-5, each mesh's loss and gap and the launches summed over the
    ranks;
28. the f32 flagship at full width (``entry.flagship_config("float32")`` under
    ``full_f32()``): ``build_forward`` and ``InferenceEngine``'s graphs at batch 8 and 256,
    each forward 1 featurizer, 4 f32 fused convs and no bf16 one, its logits, MSP, energy
    and embeddings within 1e-4 of the same program with the fused convs on their plain
    version, the replay and eager ms of both programs, and the int8-resident build of the
    same configuration (its recalibration's f32 conv launches and seconds);
29. the f32 ViT with flash at full width (``entry.vit_config("float32")``, videomae_base:
    12 blocks, d = 768, 1568 tokens, 224², 16 frames; seed 0) under ``full_f32()``:
    ``build_forward`` and ``InferenceEngine(fast_attention=True)``'s graphs at batch 8 and
    64, each forward 1 featurizer, 12 launches of the f32 flash forward and none of the
    bf16 one, its logits, MSP, energy and embeddings within 1e-4 of the same program with
    flash off (plain f32 attention), the replay and eager ms of both; then f32
    pretraining (``pretrain_config()`` with ``compute_dtype="float32"``, under
    ``precision_scope("float32")``): 3 steps at batch 16 with 12 launches of each f32 flash
    kernel a step, their ms, samples/s and peak memory, and 3 steps at batch 8 with flash
    on, and with flash off in f32 and in float64, from the same parameters, batches and
    generator: each flash step's loss within 1e-5 of the float64 step's, relative, its
    gradient norm within 1e-4.
30. the port's last two parameters, at full width: (a) ``featurize_windows(
    already_physical=True)`` on ``raw_to_physical`` of seeded raw counts at 8, 256 and
    8192 windows of (250, 6) f32 equals the default path on the counts bit for bit, and
    the fused kernel on the physical windows with ``racc = rgyro = 1.0`` is within 1e-5
    of it; (b) phase 17's fusion classifier (``videomae_base``, bf16 with f32 masters,
    batch 16, 224², 16 frames, the IMU windows through the fused featurizer): the video
    tokens of ``video_encoder(video, train=True)`` (12 flash forwards with the LSE)
    through ``forward_cast(..., method="fuse_with_tokens", train=True, generator=g)``
    against ``forward(train=True)`` from the same state and generator seed: the logits,
    the fused embedding, the moved statistics and the cross-entropy gradient of every
    IMU-encoder, fusion and head parameter bit for bit; another seed gives other logits;
    the default call equals the eval ``_fuse`` and the eval forward; the forward +
    backward of ``fuse_with_tokens(train=True)`` timed at 16.

Phases 3 and 12 hold the f32 forms of the flash kernels (full f32: the forward, dQ and
dK/dV in split-TF32 wgmma) against their plain versions in float64, within 1e-5 of the
largest element, at the bf16 forms' shapes and the f32 kernels' block edges, and print
each one's registers, spills and shared memory (``_ext.kernel_attributes``) beside its
time.

The line before the last is a JSON object with one entry per kernel; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device the script fails at once.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import importlib.util
import json
import os
import shutil
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from tpuhar_torch import _ext
from tpuhar_torch.bridge import init_params, load_variables, variables_to_numpy
from tpuhar_torch.config import PathConfig
from tpuhar_torch.entry import (
    build_classification_task,
    build_forward,
    build_fusion_task,
    build_int8_forward,
    build_pretrain_task,
    build_video_task,
    classify_config,
    dryrun_multichip,
    flagship_config,
    launch_counters,
    pretrain_config,
    vit_config,
)
from tpuhar_torch.eval.calibration import apply_temperature, expected_calibration_error, fit_temperature
from tpuhar_torch.eval.evaluator import Evaluator, train_classifier
from tpuhar_torch.eval.fewshot_parallel import fewshot_cell, fewshot_rows, init_run_trees, run_parallel_fewshot
from tpuhar_torch.eval.metrics import metrics_from_confusion
from tpuhar_torch.eval.zeroshot import class_prototypes, run_zero_shot, zero_shot_metrics
from tpuhar_torch.losses import cross_entropy_loss
from tpuhar_torch.models import convert
from tpuhar_torch.models.crossmodal import CrossModalModel, FusionClassifier, VideoClassifier
from tpuhar_torch.models import video as video_models
from tpuhar_torch.models.video import VIT_CONFIGS, VideoEncoder
from tpuhar_torch.ops.conv3x3 import (
    conv3x3_bn_act,
    conv3x3_bn_act_f32,
    conv3x3_bn_act_reference,
    conv3x3_i8,
    conv3x3_i8_reference,
)
from tpuhar_torch.ood import KNOWN_SCORES, OODEvaluator, full_f32
from tpuhar_torch.ops import attention as attention_module
from tpuhar_torch.ops import flash_lean as flash_lean_module
from tpuhar_torch.ops.featurize import featurize_windows, raw_to_physical
from tpuhar_torch.ops.flash_lean import (
    flash_lean,
    flash_lean_backward,
    flash_lean_backward_reference,
    flash_lean_bwd_dkv,
    flash_lean_bwd_dq,
    flash_lean_reference,
    flash_lean_with_stats,
)
from tpuhar_torch.ops.fused_window import featurize_windows_auto
from tpuhar_torch.ops import quant as quant_module
from tpuhar_torch.ops import quant_vit as quant_vit_module
from tpuhar_torch.ops.quant import quant_tpucnn_forward_resident, tree_to
from tpuhar_torch.ops.quant_vit import quant_vit_forward, vit_forward_f32
from tpuhar_torch.ops.stem import (
    center_u8,
    int8_gemm,
    int8_gemm_reference,
    stem_gemm_u8,
    stem_gemm_u8_reference,
    to_patch_major,
    verify_byte_map,
)
from tpuhar_torch.ops.video import normalize_clip
from tpuhar_torch.serving import InferenceEngine, benchmark_engine
from tpuhar_torch.serving_quant import build_quantized_tree, quantized_forward
from tpuhar_torch.train.checkpoint import restore_checkpoint
from tpuhar_torch.train.loop import ClassificationTrainer, CrossModalTrainer
from tpuhar_torch.profile_step import device_profile, median_ms
from tpuhar_torch.time_fused_window import graph_ms, host_ms
from tpuhar_torch.train.steps import contrastive_loss_fn, precision_scope
from tpuhar_torch.utils.profiling import StepProfiler
from tpuhar_torch.utils.roofline import PEAK_OPS_PER_S, bound

FEATURIZE_ATOL = 1e-5  # f32 in and out; only the order of the mean/var sums differs
FEATURIZE_BATCHES = (8, 256, 8192)  # latency, throughput, and 98 MB a call: past the L2
CONV_RTOL = 2e-2  # bf16 out: |kernel - plain| / max |plain|
COSINE_MIN = 0.99  # bf16 on the card against f32 on the CPU, same parameters
# the int8 tower on the card against the CPU's plain path on the same tree: the int8
# codes are equal, only the f32 sum order of the pooled mean differs
FEATURE_RTOL, FEATURE_ATOL = 1e-5, 1e-6
# (frames, S, C, C_out, residual, relu): the four convs of the bf16 tower (each stage's
# first without residual, its second with) at batch 8 and 256 clips of 16 frames, and 3
# frames at both widths, whose last 128-row tile is ragged (M = 3·49 = 147 and 3·196 =
# 588), also without residual and ReLU
CONV_SHAPES = [
    (128, 14, 256, 256, False, True), (128, 14, 256, 256, True, True),
    (128, 7, 512, 512, False, True), (128, 7, 512, 512, True, True),
    (4096, 14, 256, 256, False, True), (4096, 14, 256, 256, True, True),
    (4096, 7, 512, 512, False, True), (4096, 7, 512, 512, True, True),
    (3, 7, 512, 512, True, True), (3, 14, 256, 256, True, True),
    (3, 7, 512, 512, False, False), (3, 14, 256, 256, False, False),
]
CONV_TIMED_SHAPE = (4096, 14, 256, 256, True, True)  # the s0 second conv at batch 256
# the f32 form (the f32 flagship of phase 28, and the dry run's int8 engine, which
# recalibrates against its f32 tower): the tower's four convs at the dry run's 8 frames a
# rank (2² maps at 256 channels, 1² at 512) and a single engine's 16, and at full width at
# batch 256 (4096 frames of 14² and 7²); |kernel - plain in float64| / max |plain|, on the
# first CONV_F32_CHECK_FRAMES frames (frames do not interact)
CONV_F32_SHAPES = [(8, 2, 256, 256, False, True), (8, 2, 256, 256, True, True),
                   (8, 1, 512, 512, False, True), (16, 1, 512, 512, True, True),
                   (4096, 14, 256, 256, False, True), (4096, 14, 256, 256, True, True),
                   (4096, 7, 512, 512, False, True), (4096, 7, 512, 512, True, True)]
CONV_F32_TIMED_SHAPES = [(8, 2, 256, 256, True, True), *CONV_F32_SHAPES[4:]]
CONV_F32_LINE_SHAPE = (4096, 14, 256, 256, True, True)  # the kernels line's entry
CONV_F32_CHECK_FRAMES = 64
CONV_F32_RTOL = 1e-5
# the uint8 stem: (frames, int8 out) at batch 8 and 256, and a ragged M = 3·196
STEM_SHAPES = [(128, False), (128, True), (4096, False), (4096, True), (3, True)]
STEM_TIMED_SHAPE = (4096, True)  # the int8-resident stem at batch 256
# the int8 conv: (frames, S, C, C_out, stride, residual, int8 out), the five convs of
# the int8-resident tower at batch 8 and 256, and a ragged 3-frame 7² shape
CONV_I8_CONVS = [
    (14, 256, 256, 1, False, True),  # s0 block a
    (14, 256, 256, 1, True, True),  # s0 block b
    (14, 256, 512, 2, False, True),  # down1
    (7, 512, 512, 1, False, True),  # s1 block a
    (7, 512, 512, 1, True, False),  # s1 block b, f32 out for the pooled mean
]
CONV_I8_SHAPES = [(n, *c) for n in (128, 4096) for c in CONV_I8_CONVS] + [(3, 7, 512, 512, 1, True, True)]
CONV_I8_TIMED_SHAPE = (4096, 14, 256, 256, 1, True, True)
PLAIN_ITERS_4096 = 2  # the float64 plain versions at 4096 frames are slow
# phase 19, the int8 towers. The int8 GEMM (the stem kernel without its byte map):
# (what, M, K, N, ReLU) at the int8 ViT's four products at batch 8 (8 clips of 1568
# tokens) and ResNet-18's at batch 8 (128 frames): the 7×7 stem on its im2col rows (K 147
# padded to 192: a partial 128-byte chunk; 64 outputs, a quarter of a tile) and the
# first downsample; a ragged M; each with f32 and int8 out
INT8_GEMM_SHAPES = [
    ("vit qkv", 12544, 768, 2304, False), ("vit out", 12544, 768, 768, False),
    ("vit mlp_in", 12544, 768, 3072, False), ("vit mlp_out", 12544, 3072, 768, False),
    ("resnet18 stem", 128 * 112 * 112, 192, 64, True), ("resnet18 downsample", 128 * 28 * 28, 64, 128, False),
    ("ragged", 1000, 768, 2304, False),
]
INT8_GEMM_TIMED = "vit qkv"  # the kernels line's shape: the ViT's widest product at batch 8
INT8_VIT_BATCH64_M = 64 * 1568  # the ViT's four products timed again at batch 64
# the int8 conv with explicit (1, 1) padding at stride 2 (ResNet-18's layer1_0 conv1 at
# batch 8), int8 and f32 out
CONV_I8_PAD_SHAPE = (128, 56, 64, 128)
INT8_VIT_SIZES, INT8_RESNET_SIZES = [8, 64], [8]
# flash attention, bf16 out: |kernel - plain| / max |plain|; the online rescale reorders
# the sums and each tile's P rounds to bf16 against another running max
FLASH_RTOL = 1e-2
# (B, H, N): videomae_base at batch 8 and 1 (14 key tiles of 112, 8.17 query tiles of
# 192), N below one key tile (a tiny ViT stream, a ragged N), whole key tiles (224) and
# whole query tiles (384)
FLASH_SHAPES = [(8, 12, 1568), (1, 12, 1568), (2, 3, 32), (2, 3, 100), (2, 3, 224), (2, 3, 384)]
FLASH_TIMED_SHAPE = (8, 12, 1568)
# the flash backward, bf16 out: each of dq, dk, dv against autograd through the plain
# attention, |kernel - plain| / max |plain|: P and dS round to bf16 before their products
# (as on the TPU) and the plain version's gradients round to bf16 once; the log-sum-exp
# of the forward against torch.logsumexp in f32, absolute (ex2.approx)
FLASH_BWD_RTOL = 2e-2
LSE_ATOL = 1e-3
# (B, H, N): videomae_base at the pretraining batch 16, at 8, at 1 and on 3 heads, the
# ragged tiny shapes of the forward's cases, and the boundaries of the 128-row blocks
# and 64-row tiles of both backward kernels (dK/dV: key blocks, query tiles; dQ: query
# blocks, key tiles; 129: a block of one row, whose second consumer has none, and a last
# tile of one row)
FLASH_BWD_SHAPES = (
    [(16, 12, 1568), (8, 12, 1568), (1, 12, 1568), (2, 3, 1568)]
    + [s for s in FLASH_SHAPES if s[2] < 1568]
    + [(2, 3, n) for n in (64, 127, 128, 129, 200)]
)
FLASH_BWD_TIMED_SHAPE = (16, 12, 1568)
SM_SCALE = 0.125  # 1/sqrt(64)
# the flash kernels' f32 forms (full f32), at the bf16 forms' shapes: the output, dq,
# dk and dv each against the plain version in float64 on the same f32 operands, |kernel -
# plain| / max |plain|, and the log-sum-exp absolute: the same f32 function, its sums in
# another order
FLASH_F32_RTOL = 1e-5
# and the f32 backward kernels' edges beyond those (both hold 128 rows a block, 64 a
# consumer, and walk the other side's rows in stages of 64, each product over a stage's
# rows in two halves of 32): the halves (31, 33), the second block (255, 257), a block of
# two rows whose second consumer has none (2; at N = 1 dq and dk are 0: one key); and the
# dQ kernel's ring of two key-row parts, whose second part is first used by a stage of
# one key row while the second consumer holds one query row (65)
FLASH_F32_DKV_SHAPES = [(2, 3, n) for n in (2, 31, 33, 65, 255, 257)]
FLASH_F32_LSE_ATOL = 1e-5
# the f32 forward's own edges beyond FLASH_SHAPES (it holds 128 query rows a block, 64 a
# consumer, and walks the key rows in stages of 64 through a ring of two parts; P V takes a
# stage's key rows 16 at a time): a block of two rows whose second consumer has none (2);
# a stage cut mid-way (31, 33); one stage, then the ring's second slot first used by one
# key row (64, 65); one block, then a block of one row (127, 128, 129); a second block
# (255, 257)
FLASH_F32_FWD_EDGES = [(2, 3, n) for n in (2, 31, 33, 64, 65, 127, 128, 129, 255, 257)]
# pretraining: one epoch of four batches of 16 (and one validation batch), the depth
# cut to one epoch from the configuration's ten
PRETRAIN_BATCH, PRETRAIN_TRAIN_BATCHES, PRETRAIN_EPOCHS = 16, 4, 1
PRETRAIN_TIMED_STEPS = 5
# the first step on the card (bf16, flash kernels) against the plain path on the card
# (f32, attention without flash, TF32 off), batch 4, the same parameters, batch and
# dropout masks:
# - the loss, relative;
# - the SigLIP scalars' gradients, sums over the B² pairs: the bias's Σ g_ij, the
#   temperature's e^t·Σ g_ij·s_ij (g_ij = ∂loss/∂logit_ij, s_ij the cosine of pair ij),
#   held to 5e-3 of Σ|g_ij| and e^t·Σ|g_ij|, the most their terms can weigh (|s_ij| ≤ 1).
#   Relative to its own value the temperature's is ill-conditioned at init, where every
#   s_ij is near 0 (~0.03): bf16's ~1e-3 error in the cosines moved it by 6%;
# - the whole gradient, as one vector, by cosine: at least 0.8, a bound on its direction
#   only. At init and batch 4 the step's gradients are ill-conditioned: the train-mode
#   BatchNorm of the projection heads over 4 rows leaves them as small differences that
#   any bf16 rounding moves, so no bf16 form of the step lands near f32 (on an H100 the
#   same bf16 step with the plain attention, no hand kernel, had whole-gradient cosine
#   0.943, 251 of its 260 leaves below 0.99, the lowest at 0.57; the JAX package's own
#   bf16 step against its f32 step on the CPU, videomae_tiny, has 72 of 140 leaves below
#   0.99 and one at 0.77). That yardstick's cosines and the card's, leaf by leaf, are
#   printed, not held. The precision of the hand kernels is held by the next check, on the
#   step's own operands;
# - each of the step's flash backwards against the plain backward in f32 on that layer's
#   own q, k, v and dO, relative as in the kernel phase. In f32: the plain backward in
#   bf16 rounds dP to bf16 before dS = P∘(dP − di), and where attention is near uniform,
#   as at init, dP − di is a small difference: it was 0.6-8.7% off the f32 backward on
#   these operands, where the kernels keep dP in f32.
# Leaves whose plain gradient RMS is below 1e-4 of the largest leaf's (a bias a
# BatchNorm follows, the key bias of an attention: 0 in exact arithmetic) hold only
# rounding noise and are listed, not compared.
PRETRAIN_CHECK_BATCH = 4
PRETRAIN_LOSS_RTOL = 2e-2
SCALAR_GRAD_RTOL = 5e-3
WHOLE_COSINE_MIN = 0.8
GRAD_NOISE_FLOOR = 1e-4
# the classification stage: the IMU classifier's probe and finetune take three steps of
# its train_batch_size (64) each, the fusion and video classifiers on videomae_base two
# of batch 16 (the pretraining batch); the depth cut from train_epochs' 100 epochs of a
# dataset to these steps. The fusion classifier's first step is held against the plain
# f32 path at batch 4, with phase 14's tolerances
CLASSIFY_IMU_STEPS, CLASSIFY_IMU_TIMED_STEPS = 3, 5
CLASSIFY_BATCH, CLASSIFY_STEPS, CLASSIFY_TIMED_STEPS = 16, 2, 3
CLASSIFY_CHECK_BATCH = 4
# phase 18, the towers: tpu_cnn pretraining over one epoch of three batches of 16; the
# fusion classifier with ResNet-18 and MobileNetV2, two steps of 16, served at 8; the
# videomae_base remat step at 16; the trained tpu_cnn at eval on 4 clips (its 4 fused
# convs a forward); the IMU classifier's encoders served IMU-only at 8 and 256
TOWER_BATCH, TOWER_PRETRAIN_BATCHES, TOWER_CLASSIFY_STEPS, TOWER_TIMED_STEPS = 16, 3, 2, 3
TOWER_ENGINE_BATCH, TOWER_EVAL_CLIPS, TPU_CNN_FUSED_CONVS = 8, 4, 4
REMAT_BATCH = 16
# the remat step against the step without it: the same kernels on the same operands,
# recomputed, so the loss and every gradient are expected bit for bit; a difference of
# more than this share of a leaf's largest element fails
REMAT_RTOL = 1e-3
IMU_ENGINE_SIZES = [8, 256]
# phase 20, the evaluate stage: 32 classes (the configuration's); the graft's eval forward
# at batch 2; the zero-shot prototypes from 2 clips a class at batch 16 (4 batches), each
# held by cosine to the same prototypes with the plain attention (both bf16: only the
# attention's sum order and P's rounding differ); leave-one-out of the first and the
# last class with the fusion classifier, one epoch of two batches of 16 (the depth cut
# from train_epochs' 100 epochs of a dataset), its train step timed and profiled; the
# few-shot grid at k = 10 with 5 runs (few_shot_samples [10, 20, 50, 100] cut to [10],
# 100 epochs to 2), windows a class: 12 to train, 4 to fit and 4 to test; each batched
# run within 5 points of balanced accuracy (the JAX package's per-cell bound between its
# two harnesses) of the same run trained alone
EVAL_CLASSES, GRAFT_BATCH, CLIP_SHAPE = 32, 2, (16, 224, 224)  # CLIP_SHAPE: frames, height, width
EVAL_PATTERN = 4.0
ZEROSHOT_CLIPS_PER_CLASS, ZEROSHOT_BATCH, ZEROSHOT_COSINE_MIN = 2, 16, COSINE_MIN
LOO_CLASSES, LOO_BATCH, LOO_STEPS, LOO_TIMED_STEPS, LOO_PROFILED_STEPS = (0, 31), 16, 2, 3, 3
FEWSHOT_RUNS, FEWSHOT_K, FEWSHOT_EPOCHS, FEWSHOT_ROW_ATOL = 5, 10, 2, 5.0
FEWSHOT_WINDOWS = {"train": 12, "val": 4, "test": 4}
# phase 21, the pipeline from raw files: a synthetic dataset (4 classes, 4 samples a class
# in each split, 224² video at 25 fps, seed 0) through `python -m tpuhar_torch`'s main in
# process, `--mode all` then `--mode serve` (IMU-only, batch 64), with pretrain_config()
# (videomae_base at full width and depth, flash on, batch 16) cut to 4 classes, one epoch
# of pretraining and of each classifier, the few-shot grid at k = 2 with 2 runs and the
# leave-one-out of class 0. The device route of the preprocessor on the card against the
# host route (numpy and scipy) at the JAX package's own tolerance between the two
# (tests/test_manifest_preprocess.py:122); the window-scope route on the card against the
# same on the CPU at the featurizer's
PIPELINE_CLASSES, PIPELINE_SAMPLES, PIPELINE_VIDEO, PIPELINE_SERVE_BATCH = 4, 4, (224, 224), 64
PREPROCESS_DEVICE_ATOL = 2e-4
PIPELINE_STAGES = ("run_preprocessing", "run_pretraining", "run_zeroshot", "run_classification", "run_evaluation",
                   "run_ood", "generate_final_report", "run_serving")
PIPELINE_ARTIFACTS = (
    "results/classification_comparison.csv", "results/test_logits_linear_probe.npy",
    "results/test_logits_finetune.npy", "results/fewshot_results_raw.csv", "results/fewshot_results_agg.csv",
    "results/fewshot_table3.csv", "results/zeroshot_results.json", "results/ood_results.csv",
    "results/ood_results_agg.csv", "results/final_report.json", "results/table3_fewshot.csv",
    "results/serving_predictions_test.csv", "checkpoints/cross_modal/best_model.pt",
    "checkpoints/final_model_params.pt", "checkpoints/classifier_finetune/best_model.pt",
    "preprocessed/preprocessing_stats.json", "preprocessed/data_fingerprint.json",
)
PIPELINE_PLOTS = ("results/pretraining_curves.png", "results/confusion_linear_probe.png",
                  "results/confusion_finetune.png")
# phase 22, the mesh and the loader backends: the pretraining steps (phase 21's train
# split of 48 windows gives three batches of 16), the clips a decoder is timed on, the
# engine's size and the requests it answers
MESH_STEPS, MESH_DECODE_CLIPS, MESH_ENGINE_BATCH, MESH_REQUESTS = 2, 16, 8, (8, 5)
# phase 23, tensor parallel on the card: two processes on cuda:0 over a gloo group (NCCL
# refuses two ranks on one device), mesh (1, 2): phase 22's two pretraining steps of 16 on
# its batches and parameters (videomae_base's 12 heads split 6 + 6 a rank, the flagship IMU
# encoder's 8 split 4 + 4, both MLPs halved), the flagship IMU classifier's finetune, two
# steps of 64, whose checkpoint the engine serves, and the bf16 flagship engine at 8. The
# flash kernels against their plain versions at a rank's shape
TP_SIZE, TP_IMU_STEPS, TP_IMU_BATCH, TP_FLASH_SHAPE = 2, 2, 64, (16, 6, 1568)
# the TP steps against phase 22's two steps without a mesh (both bf16 on the card, the same
# batches and dropout masks; the row-parallel products are summed in f32 and rounded once,
# the one-device GEMM accumulates in f32 and rounds once, in another order):
# - each step's loss within PRETRAIN_LOSS_RTOL, relative;
# - each parameter after the two AdamW steps: AdamW's first steps move an element by about
#   ±lr whatever its gradient's size, so an element whose gradient the other sum order
#   rounds to the other sign moves the other way. Every element within Adam's bound on two
#   moves apart (2.01·Σlr, plus 4 ulps of its value), and at least TP_TIGHT_SHARE of all
#   elements within TP_TIGHT·Σlr;
# - the BatchNorm running statistics within TP_STATS_RTOL of each leaf's largest;
# - the IMU classifier's checkpoint served by InferenceEngine.from_checkpoint against an
#   engine of the same two steps without a mesh: logits and embeddings by cosine, COSINE_MIN
TP_TIGHT, TP_TIGHT_SHARE, TP_STATS_RTOL = 0.25, 0.9, 2e-2
# phase 24, the centered int8 wire: the stem at the int8-resident engine's batch 256
# ((4096·196, 768) -> 256, int8 out) on center_u8 codes and on the uint8 wire of the same
# pixels, bit for bit, each timed CENTERED_TURNS times in turns; the int8-resident engine
# on each wire at CENTERED_ENGINE_SIZES, bit for bit
CENTERED_FRAMES, CENTERED_TURNS, CENTERED_ENGINE_SIZES = 4096, 2, [8, 256]
# and the validation workflows at full width (224², 16 frames) on a small fixture: the
# hard fixture's 3 classes, 2 sequences a class and split, one epoch, held-out classes 0
# and 1; article_workflow --quick in a second process from the phase's start
WORKFLOW_TOWERS, WORKFLOW_LOO = ("tpu_cnn", "resnet18"), "0,1"
WORKFLOW_ARGS = ["--classes", "3", "--samples", "2", "--epochs", "1", "--loo-classes", WORKFLOW_LOO]
ARTICLE_TIMEOUT_S = 420
# phase 25, the research probes and debug scripts, on phase 24's outputs and a fixture of
# their own. measure_resident_drift at DRIFT_SEEDS seeds on the card and on the CPU: per
# seed the correlation within DRIFT_CORR_ATOL of the CPU's and the relative drift within
# DRIFT_REL_RTOL of it plus DRIFT_REL_ATOL (both build the same quantized tree on the CPU
# and the int8 codes agree; the float parts differ by f32 rounding, and a stem code that
# rounding flips moves the drift a little). debug_ckpt_data_match on phase 24's tpu_cnn
# checkpoints over CKPT_ROWS test rows on the card and on the CPU, in bf16 both: a row
# may be predicted otherwise only where the CPU's top two logits lie within
# CKPT_FLIP_RTOL of the row's largest |logit| (two bf16 roundings). One hard fixture of
# PROBE_SAMPLES sequences a class and split for the parity probe (PARITY_STEPS steps:
# cuda_f32ctx and cuda_highest within PARITY_LOSS_ATOL of cpu_f32 at each step and the
# initial gradient norm within PARITY_GRAD_RTOL; the same f32 function, sums in another
# order), the loop, the collapse and learning-rate probes; the coupling sweep at strength 8
# on its own pool of COUPLING_SAMPLES sequences a class (one batch of 64 a split)
DRIFT_SEEDS, DRIFT_CORR_ATOL, DRIFT_REL_RTOL, DRIFT_REL_ATOL = 3, 1e-3, 0.1, 2e-3
CKPT_ROWS, CKPT_FLIP_RTOL = 32, 2**-7
PROBE_SAMPLES, PARITY_STEPS, PARITY_LOSS_ATOL, PARITY_GRAD_RTOL = 2, 4, 1e-3, 1e-3
COUPLING_SAMPLES = 1
# phase 26, the timing and decomposition scripts at full width; the cuts are in batch,
# iterations and trials (one each), the fixtures and --min-windows
SCRIPT_TRIALS = 1
BENCH_TRAIN_BATCH, BENCH_TRAIN_STEPS = 16, 3  # of 32 and 10
LOADER_FIXTURE = dict(num_classes=2, samples_per_class=2, seq_len=600)  # of 8 x 6 x 1500
STREAM_ARGS = ["--batch", "16", "--min-windows", "64"]  # of 64 and 512
STREAM_FIXTURE = (2, 2, 600)  # where phase 24's bench_accuracy fixture is gone; of (6, 8, 1500)
SCRIPT_BATCH = 64  # perf_decompose, perf_nonvideo, perf_quant, perf_tpucnn_variants and perf_trace, of 256
SCRIPT_ITERS = 5  # of 10-20
INT8_STAGE_FRAMES, INT8_CHECK_FRAMES = 1024, 64  # of 4096; prefix 5 against the plain kernels at 64
VIT_STAGE_BATCH, VIT_STAGE_ITERS = 16, 4  # of 64 and 12
SWEEP_VARIANTS = ("resnet18:64", "videomae_small:32")  # of resnet18:512, videomae_small:256
FLOOR_RTOL = 1e-5  # phase 3's stem bound also counts the 2 KB of its scale and bias
DRYRUN_RANKS = 4  # phase 27: entry.dryrun_multichip's ranks, all on cuda:0
# phase 28, the f32 flagship at full width: entry.flagship_config("float32") (224², 16
# frames, the tpu_cnn tower with its fused convs) under full_f32(), eager and through
# the engine at these batch sizes; each output held to the same program with the fused
# convs on their plain version (F.conv2d in f32, TF32 off) within F32_FLAGSHIP_RTOL of its
# largest: the same f32 function, its sums in another order through four convs
F32_FLAGSHIP_SIZES = [8, 256]
F32_FLAGSHIP_RTOL = 1e-4
F32_FLAGSHIP_FORWARD = {"fused_window": 1, "conv3x3_bn_act_f32": 4, "conv3x3_bn_act": 0}  # launches a forward
# phase 29, the f32 ViT with flash: served at ENGINE_SIZES["engine_vit"] against the same
# program with flash off within F32_FLAGSHIP_RTOL (the same f32 function, its attention's
# sums in another order), each program timed over F32_VIT_TIMING_ITERS calls a size (cut
# from ENGINE_TIMING_ITERS: an f32 forward at 64 takes most of a second); pretraining
# F32_VIT_STEPS steps at PRETRAIN_BATCH, and the same steps at F32_VIT_CHECK_BATCH (where
# the materialized scores fit) with flash on, and with flash off in f32 and in float64:
# each flash step's loss within F32_VIT_LOSS_RTOL of the float64 step's, relative, its
# gradient norm (before the clip) within F32_VIT_GRAD_RTOL. The float64 steps are the
# arbiter because the f32 flash-off steps are not exact enough to be one (at batch 8 the
# f32 flash-off program's second gradient norm lands 6.2e-4 from the float64 step's on an
# H100); the f32 pair's gaps are printed beside. Batch 8 and not 4: at init the video
# projection head's BatchNorm over four nearly equal rows amplifies a last-bit difference
# in the video features some 10^4-fold, so at 4 the first gradient norm of any f32
# program, even with its attention computed in float64 and rounded to f32, lands 1.6e-5 to
# 7e-4 from the float64 step's depending on the rounding alone (3.6e-4 for that rounded
# forward); at 8 that forward lands within 3.2e-6 at every step, and a forward whose O is
# off by 1e-3 fails by 8.4e-4
F32_VIT_TIMING_ITERS = {8: 5, 64: 2}
F32_VIT_STEPS, F32_VIT_CHECK_BATCH = 3, 8
F32_VIT_LOSS_RTOL, F32_VIT_GRAD_RTOL = 1e-5, 1e-4
# the serving engine: each engine's registered batch sizes, and the iterations of its
# timings at each size (cut to keep the run short; the widths are the full ones)
ENGINE_SIZES = {"engine_bf16": [8, 256], "engine_int8_resident": [8, 256], "engine_vit": [8, 64]}
ENGINE_TIMING_ITERS = {8: 20, 64: 3, 256: 3}
ENGINE_BENCH_ITERS = {8: 10, 64: 2, 256: 2}  # benchmark_engine: predicts after its first
STREAM_SIZES = (8, 5, 8, 3)  # predict_stream's four batches, held to predict
STREAM_TIMED_BATCHES = 4  # predict_stream timed at each registered size
# phase 30, the last two parameters: the featurizer on physical windows at
# FEATURIZE_BATCHES; fuse_with_tokens(train=True) at phase 17's width, batch 16, timed in
# FUSE_TOKENS_TRIALS trials of FUSE_TOKENS_ITERS steps after a warm-up
FUSE_TOKENS_BATCH, FUSE_TOKENS_SEED = 16, 900
FUSE_TOKENS_TRIALS, FUSE_TOKENS_ITERS = 5, 5

# each hand kernel: its source and the TPU kernel it replaces (phase 3 adds its check,
# times and bound; the main paths their launches)
KERNELS = {
    "fused_window": {"name": "fused_window", "route": "cuda", "source": "tpuhar_torch/csrc/fused_window.cu",
                     "replaces": "tpuhar/ops/fused_window.py:93"},
    "conv3x3_bn_act": {"name": "conv3x3_bn_act", "route": "cuda", "source": "tpuhar_torch/csrc/conv3x3.cu",
                       "replaces": "tpuhar/ops/conv3x3.py:142"},
    "conv3x3_bn_act_f32": {"name": "conv3x3_bn_act_f32", "route": "cuda",
                           "source": "tpuhar_torch/csrc/conv3x3_f32.cu", "replaces": "tpuhar/ops/conv3x3.py:142"},
    "stem_gemm_u8": {"name": "stem_gemm_u8", "route": "cuda", "source": "tpuhar_torch/csrc/stem_u8.cu",
                     "replaces": "tpuhar/ops/stem.py:254"},
    "conv3x3_i8": {"name": "conv3x3_i8", "route": "cuda", "source": "tpuhar_torch/csrc/conv3x3_i8.cu",
                   "replaces": "tpuhar/ops/conv3x3.py:142"},
    "int8_gemm": {"name": "int8_gemm", "route": "cuda", "source": "tpuhar_torch/csrc/stem_u8.cu",
                  "replaces": "tpuhar/ops/stem.py:254",
                  "also_replaces": "tpuhar/ops/quant.py:65 (int8_dense, an XLA int8 product) and the 1x1 and 7x7 "
                                   "tpuhar/ops/quant.py:44 int8_conv of the int8 ResNet-18"},
    "flash_lean": {"name": "flash_lean", "route": "cuda", "source": "tpuhar_torch/csrc/flash_attn.cu",
                   "replaces": "tpuhar/ops/flash_lean.py:89", "also_replaces": "tpuhar/ops/attention.py:72"},
    "flash_bwd_dkv": {"name": "flash_bwd_dkv", "route": "cuda", "source": "tpuhar_torch/csrc/flash_attn_bwd.cu",
                      "replaces": "jax/experimental/pallas/ops/tpu/flash_attention.py:941 (_flash_attention_bwd_dkv) "
                                  "through tpuhar/ops/attention.py:72"},
    "flash_bwd_dq": {"name": "flash_bwd_dq", "route": "cuda", "source": "tpuhar_torch/csrc/flash_attn_bwd.cu",
                     "replaces": "jax/experimental/pallas/ops/tpu/flash_attention.py:1287 (_flash_attention_bwd_dq) "
                                 "through tpuhar/ops/attention.py:72"},
    "flash_lean_f32": {"name": "flash_lean_f32", "route": "cuda", "source": "tpuhar_torch/csrc/flash_attn_f32.cu",
                       "replaces": "tpuhar/ops/flash_lean.py:89", "also_replaces": "tpuhar/ops/attention.py:72"},
    "flash_bwd_dkv_f32": {"name": "flash_bwd_dkv_f32", "route": "cuda",
                          "source": "tpuhar_torch/csrc/flash_attn_bwd_f32.cu",
                          "replaces": "jax/experimental/pallas/ops/tpu/flash_attention.py:941 "
                                      "(_flash_attention_bwd_dkv) through tpuhar/ops/attention.py:72"},
    "flash_bwd_dq_f32": {"name": "flash_bwd_dq_f32", "route": "cuda",
                         "source": "tpuhar_torch/csrc/flash_attn_bwd_f32.cu",
                         "replaces": "jax/experimental/pallas/ops/tpu/flash_attention.py:1287 "
                                     "(_flash_attention_bwd_dq) through tpuhar/ops/attention.py:72"},
}
LAST_PHASE = 30
# a phase and the phases whose results it reads (``--phase`` runs them too)
PHASE_NEEDS = {5: {4}, 6: {4}, 7: {6}, 9: {8}, 10: {4, 6, 8}, 11: {6}, 14: {13}, 15: {13}, 16: {4, 6, 8},
               22: {21}, 23: {22}, 25: {24}, 26: {24}}


def require_cuda() -> None:
    """Fail unless a CUDA device is present: the script never falls back to the CPU."""
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device; torch.cuda.is_available() is False")


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean ms per call of ``fn`` on the current stream, after ``warmup`` calls."""
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


def check_featurizer(rng) -> dict:
    """The featurizer against its plain version at the serving shape, then at batch 8,
    256 and 8192 its device time a launch (a CUDA graph of 100 launches replayed between
    two events: no host in the way) apart from its wrapper's host time a call (a host
    clock around 1000 calls)."""
    raw = torch.from_numpy(rng.normal(0, 8000, (256, 250, 6)).astype(np.float32)).cuda()
    cases = [
        {}, {"kernel_size": 1}, {"kernel_size": 4}, {"normalize": False},
        {"kernel_size": 1, "normalize": False, "racc": 100.0, "rgyro": 2.0},
        {"racc": 100.0, "rgyro": 2.0},
    ]
    worst = 0.0
    for kw in cases:
        err = (featurize_windows_auto(raw, **kw) - featurize_windows(raw, **kw)).abs().max().item()
        print(f"[kernel] fused_window (256, 250, 6) {kw or 'default'}: max abs diff {err:.3e}")
        if not err <= FEATURIZE_ATOL:
            raise AssertionError(f"fused_window {kw}: max abs diff {err} > {FEATURIZE_ATOL}")
        worst = max(worst, err)
    raws = {b: torch.from_numpy(rng.normal(0, 8000, (b, 250, 6)).astype(np.float32)).cuda()
            for b in FEATURIZE_BATCHES if b != 256}
    raws[256] = raw
    device_ms, host = {}, {}
    for b in FEATURIZE_BATCHES:
        x = raws[b]
        err = (featurize_windows_auto(x) - featurize_windows(x)).abs().max().item()
        if not err <= FEATURIZE_ATOL:
            raise AssertionError(f"fused_window ({b}, 250, 6): max abs diff {err} > {FEATURIZE_ATOL}")
        worst = max(worst, err)
        device_ms[b] = graph_ms(lambda: featurize_windows_auto(x))
        host[b] = host_ms(lambda: featurize_windows_auto(x))
        # f32 in and out; ~20 f32 operations per sample: unit scale, the median-of-5's
        # compare-exchanges, the mean and variance sums, the z-score
        b_bound = bound(2 * x.numel() * 4, {"f32": 20 * x.numel()})
        print(f"[kernel] fused_window ({b}, 250, 6): max abs diff {err:.3e}; device {device_ms[b] * 1e3:.3f} us "
              f"a launch (CUDA graph), wrapper host {host[b] * 1e3:.3f} us a call, bound "
              f"{b_bound['bound_ms'] * 1e3:.3f} us ({b_bound['bound_by']})")
    plain_ms = cuda_ms(lambda: featurize_windows(raw), 200)
    b = bound(2 * raw.numel() * 4, {"f32": 20 * raw.numel()})
    print(f"[kernel] fused_window (256, 250, 6): kernel {device_ms[256]:.4f} ms, plain {plain_ms:.4f} ms, "
          f"bound {b['bound_ms']:.4f} ms ({b['bound_by']})")
    return {"max_abs_err": worst, "ms": device_ms[256], "plain_ms": plain_ms, "library_ms": None, **b,
            "host_ms": host[256], "shape": "(256, 250, 6) f32",
            "device_ms_by_batch": device_ms, "host_ms_by_batch": host}


def check_conv3x3() -> dict:
    gen = torch.Generator(device="cuda").manual_seed(0)
    worst_abs = worst_rel = 0.0
    timed = None
    for n, s, c, c_out, has_res, relu in CONV_SHAPES:
        def randn(*shape, scale=1.0):
            return torch.randn(shape, generator=gen, device="cuda") * scale

        x = torch.relu(randn(n, s, s, c)).to(torch.bfloat16)
        kernel = randn(3, 3, c, c_out, scale=(9 * c) ** -0.5).to(torch.bfloat16)
        scale = torch.rand(c_out, generator=gen, device="cuda") + 0.5
        bias = randn(c_out, scale=0.1)
        res = randn(n, s, s, c_out).to(torch.bfloat16) if has_res else None
        got = conv3x3_bn_act(x, kernel, scale, bias, residual=res, relu=relu)
        want = conv3x3_bn_act_reference(x, kernel, scale, bias, res, relu)
        err = (got.float() - want.float()).abs().max().item()
        rel = err / want.float().abs().max().item()
        ms = cuda_ms(lambda: conv3x3_bn_act(x, kernel, scale, bias, residual=res, relu=relu), 20)
        plain_ms = cuda_ms(lambda: conv3x3_bn_act_reference(x, kernel, scale, bias, res, relu), 20)
        tflops = 2 * n * s * s * 9 * c * c_out / ms / 1e9
        name = f"({n}, {s}, {s}, {c})->{c_out} residual={has_res} relu={relu}"
        print(
            f"[kernel] conv3x3 {name}: max abs diff {err:.3e}, rel {rel:.3e}; "
            f"kernel {ms:.4f} ms ({tflops:.1f} TFLOP/s), plain {plain_ms:.4f} ms"
        )
        if not rel <= CONV_RTOL:
            raise AssertionError(f"conv3x3 {name}: relative diff {rel} > {CONV_RTOL}")
        worst_abs, worst_rel = max(worst_abs, err), max(worst_rel, rel)
        if (n, s, c, c_out, has_res, relu) == CONV_TIMED_SHAPE:
            # cuDNN's conv on the same NHWC input, without the BN, residual and ReLU
            xc, wc = x.permute(0, 3, 1, 2), kernel.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
            library_ms = cuda_ms(lambda: F.conv2d(xc, wc, padding=1), 20)
            b = bound((x.numel() + kernel.numel() + 2 * res.numel()) * 2, {"bf16": 2 * n * s * s * 9 * c * c_out})
            print(f"[kernel] conv3x3 {name}: F.conv2d {library_ms:.4f} ms, bound {b['bound_ms']:.4f} ms ({b['bound_by']})")
            timed = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, **b}
    return {"max_abs_err": worst_abs, "max_rel_err": worst_rel, **timed,
            "shape": "(4096, 14, 14, 256)->256 bf16 + residual"}


def check_conv3x3_f32() -> dict:
    """The f32 form of the fused conv against its plain version in float64 (on the first
    CONV_F32_CHECK_FRAMES frames) at the dry run's shapes and at full width, timed with
    its plain version, ``F.conv2d`` in f32 with TF32 off (the same conv, without the BN,
    residual and ReLU) and, for reference only, with TF32 on, beside its bound at the
    split products' rate (three TF32 products an f32 one) and at the FFMA rate."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    worst_abs = worst_rel = 0.0
    by_shape, line = {}, None
    for n, s, c, c_out, has_res, relu in CONV_F32_SHAPES:
        x = torch.relu(torch.randn((n, s, s, c), generator=gen, device="cuda"))
        kernel = torch.randn((3, 3, c, c_out), generator=gen, device="cuda") * (9 * c) ** -0.5
        scale = torch.rand(c_out, generator=gen, device="cuda") + 0.5
        bias = torch.randn(c_out, generator=gen, device="cuda") * 0.1
        res = torch.randn((n, s, s, c_out), generator=gen, device="cuda") if has_res else None
        got = conv3x3_bn_act_f32(x, kernel, scale, bias, residual=res, relu=relu)
        k = min(n, CONV_F32_CHECK_FRAMES)
        want = conv3x3_bn_act_reference(x[:k].double(), kernel.double(), scale, bias,
                                         None if res is None else res[:k].double(), relu)
        err = (got[:k].double() - want).abs().max().item()
        rel = err / want.abs().max().item()
        del got, want
        name = f"({n}, {s}, {s}, {c})->{c_out} residual={has_res} relu={relu}"
        print(f"[kernel] conv3x3 f32 {name}: max abs diff {err:.3e}, rel {rel:.3e} against float64 on the first "
              f"{k} frames")
        if not rel <= CONV_F32_RTOL:
            raise AssertionError(f"conv3x3 f32 {name}: relative diff {rel} > {CONV_F32_RTOL}")
        worst_abs, worst_rel = max(worst_abs, err), max(worst_rel, rel)
        if (n, s, c, c_out, has_res, relu) not in CONV_F32_TIMED_SHAPES:
            continue
        iters = 10 if n >= 4096 else 50
        ms = cuda_ms(lambda: conv3x3_bn_act_f32(x, kernel, scale, bias, residual=res, relu=relu), iters)
        plain_ms = cuda_ms(lambda: conv3x3_bn_act_reference(x, kernel, scale, bias, res, relu), iters)
        xc, wc = x.permute(0, 3, 1, 2), kernel.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        library_ms = cuda_ms(lambda: F.conv2d(xc, wc, padding=1), iters)
        torch.backends.cudnn.allow_tf32 = True
        try:
            tf32_ms = cuda_ms(lambda: F.conv2d(xc, wc, padding=1), iters)
        finally:
            torch.backends.cudnn.allow_tf32 = False
        flops = 2 * n * s * s * 9 * c * c_out
        moved = (x.numel() + kernel.numel() + (2 if has_res else 1) * n * s * s * c_out) * 4
        b, ffma = bound(moved, {"tf32x3": flops}), bound(moved, {"f32": flops})
        print(f"[kernel] conv3x3 f32 {name}: kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s of f32 work, "
              f"{b['bound_ms'] / ms:.1%} of its bound), plain {plain_ms:.4f} ms, F.conv2d f32 {library_ms:.4f} ms, "
              f"F.conv2d TF32 {tf32_ms:.4f} ms (reference only: three decimal digits); bound {b['bound_ms']:.4f} ms "
              f"({b['bound_by']}: the split products at {PEAK_OPS_PER_S['tf32x3'] / 1e12:.0f} TFLOP/s of f32 work, "
              f"three TF32 products an f32 one), {ffma['bound_ms']:.4f} ms at the FFMA rate "
              f"({PEAK_OPS_PER_S['f32'] / 1e12:.0f} TFLOP/s)")
        by_shape[name] = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, "library_tf32_ms": tf32_ms,
                          **b, "ffma_bound_ms": ffma["bound_ms"], "max_rel_err": rel}
        if (n, s, c, c_out, has_res, relu) == CONV_F32_LINE_SHAPE:
            line = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, **b,
                    "library_tf32_ms": tf32_ms, "ffma_bound_ms": ffma["bound_ms"]}
        del x, res, xc
        torch.cuda.empty_cache()
    return {"max_abs_err": worst_abs, "max_rel_err": worst_rel, **line,
            "shape": "(4096, 14, 14, 256)->256 f32 + residual", "by_shape": by_shape}


def _plain_ms(fn, frames: int) -> float:
    return cuda_ms(fn, PLAIN_ITERS_4096, warmup=1) if frames >= 4096 else cuda_ms(fn, 5)


def check_stem_u8() -> dict:
    """The uint8 stem kernel against its plain version, bit for bit."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    timed, worst = None, 0.0
    for frames, int8_out in STEM_SHAPES:
        col = torch.randint(0, 256, (frames, 14, 14, 768), generator=gen, device="cuda", dtype=torch.uint8)
        col[0, :2] = 0  # pure-black pixels: the clip corner of the byte map
        w = torch.randint(-127, 128, (256, 768), generator=gen, device="cuda", dtype=torch.int8)  # (C0, K)
        scale = torch.rand(256, generator=gen, device="cuda") * 1e-5
        bias = torch.randn(256, generator=gen, device="cuda") * 0.5
        kw = {"out_scale": 0.05 if int8_out else None}
        got = stem_gemm_u8(col, w, scale, bias, **kw)
        want = stem_gemm_u8_reference(col, w, scale, bias, **kw)
        mismatches = (got != want).sum().item()
        err = (got.float() - want.float()).abs().max().item()
        ms = cuda_ms(lambda: stem_gemm_u8(col, w, scale, bias, **kw), 20)
        plain_ms = _plain_ms(lambda: stem_gemm_u8_reference(col, w, scale, bias, **kw), frames)
        gbps = col.numel() / ms / 1e6
        name = f"({frames}·196, 768)->256 {'int8' if int8_out else 'f32'} out"
        print(
            f"[kernel] stem_u8 {name}: {mismatches} mismatches, max abs diff {err:.3e}; "
            f"kernel {ms:.4f} ms ({gbps:.0f} GB/s of pixels), plain (float64) {plain_ms:.4f} ms"
        )
        if mismatches:
            raise AssertionError(f"stem_u8 {name}: {mismatches} elements differ from the plain version")
        worst = max(worst, err)
        if (frames, int8_out) == STEM_TIMED_SHAPE:
            b = bound(col.numel() + w.numel() + got.numel() * got.element_size() + 8 * 256,
                      {"int8": 2 * col.numel() * 256})
            # one PyTorch call for the kernel's product alone, on the byte-mapped int8
            # codes and the (K, C0) weights made beforehand: no byte map, no scale and
            # bias, no ReLU, no requant, and an int32 result four times the kernel's int8
            # output
            codes = torch.bitwise_xor(torch.clamp(col, min=1), 0x80).view(torch.int8).reshape(-1, 768)
            library_ms, note = int_mm_ms(codes, w.T.contiguous(), "the mapped codes")
            print(f"[kernel] stem_u8 {name}: bound {b['bound_ms']:.4f} ms ({b['bound_by']}); "
                  + (note if library_ms is None else f"{note}: {library_ms:.4f} ms"))
            timed = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, "library_note": note, **b}
    return {"max_abs_err": worst, **timed, "shape": "(4096·196, 768) u8 -> 256 int8"}


def int_mm_ms(a: torch.Tensor, b: torch.Tensor, what: str):
    """(ms, note) of one ``torch._int_mm(a, b)``: a yardstick only, so a refusal is
    recorded in the note, not raised, and the time is None."""
    note = f"torch._int_mm on {what}: the product only, int32 out"
    try:
        return cuda_ms(lambda: torch._int_mm(a, b), 20), note
    except RuntimeError as err:
        return None, f"torch._int_mm refused {tuple(a.shape)} x {tuple(b.shape)}: {err}"


def im2col_nhwc(x: torch.Tensor, stride: int = 1, pad: int = 1) -> torch.Tensor:
    """(N, S, S, C) → (N·So·So, 9·C) for a 3×3 conv padded ``pad`` on each side at
    ``stride`` (by default SAME at stride 1), K in the packed weights' order
    (dy·3 + dx)·C + c."""
    n, s, _, c = x.shape
    so = (s + 2 * pad - 3) // stride + 1
    xp = torch.zeros((n, s + 2 * pad, s + 2 * pad, c), dtype=x.dtype, device=x.device)
    xp[:, pad:pad + s, pad:pad + s] = x
    taps = [xp[:, dy:dy + stride * (so - 1) + 1:stride, dx:dx + stride * (so - 1) + 1:stride]
            for dy in range(3) for dx in range(3)]
    return torch.cat(taps, dim=-1).reshape(-1, 9 * c)


def check_conv3x3_i8() -> dict:
    """The int8 conv kernel against its plain version, bit for bit, and beside the
    bf16 conv kernel at the same stride-1 shapes."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    timed, worst = None, 0.0
    for n, s, c, c_out, stride, has_res, int8_out in CONV_I8_SHAPES:
        so = -(-s // stride)
        x = torch.randint(0, 128, (n, s, s, c), generator=gen, device="cuda", dtype=torch.int8)
        w = torch.randint(-127, 128, (c_out, 9 * c), generator=gen, device="cuda", dtype=torch.int8)
        scale = torch.rand(c_out, generator=gen, device="cuda") * 1e-5
        bias = torch.randn(c_out, generator=gen, device="cuda") * 0.1
        res = torch.randint(0, 128, (n, so, so, c_out), generator=gen, device="cuda", dtype=torch.int8) if has_res else None
        kw = {"stride": stride, "residual": res, "res_scale": 0.01 if has_res else None,
              "out_scale": 0.02 if int8_out else None}
        got = conv3x3_i8(x, w, scale, bias, **kw)
        want = conv3x3_i8_reference(x, w, scale, bias, **kw)
        mismatches = (got != want).sum().item()
        err = (got.float() - want.float()).abs().max().item()
        ms = cuda_ms(lambda: conv3x3_i8(x, w, scale, bias, **kw), 10)
        plain_ms = _plain_ms(lambda: conv3x3_i8_reference(x, w, scale, bias, **kw), n)
        tops = 2 * n * so * so * 9 * c * c_out / ms / 1e9
        bf16_ms = None
        if stride == 1:
            xb, wb = x.to(torch.bfloat16), w.T.reshape(3, 3, c, c_out).to(torch.bfloat16).contiguous()
            rb = None if res is None else res.to(torch.bfloat16)
            bf16_ms = cuda_ms(lambda: conv3x3_bn_act(xb, wb, scale, bias, residual=rb), 10)
        name = f"({n}, {s}, {s}, {c})->{c_out} stride {stride} residual={has_res} {'int8' if int8_out else 'f32'} out"
        print(
            f"[kernel] conv3x3_i8 {name}: {mismatches} mismatches, max abs diff {err:.3e}; kernel {ms:.4f} ms "
            f"({tops:.1f} TOP/s), plain (float64) {plain_ms:.4f} ms, bf16 kernel "
            + ("n/a (stride 1 only)" if bf16_ms is None else f"{bf16_ms:.4f} ms")
        )
        if mismatches:
            raise AssertionError(f"conv3x3_i8 {name}: {mismatches} elements differ from the plain version")
        worst = max(worst, err)
        if (n, s, c, c_out, stride, has_res, int8_out) == CONV_I8_TIMED_SHAPE:
            b = bound(x.numel() + w.numel() + res.numel() + got.numel() + 8 * c_out,
                      {"int8": 2 * n * so * so * 9 * c * c_out})
            # PyTorch has no int8 conv on CUDA: the yardstick is the conv's product alone,
            # on the im2col matrix made beforehand (no gather, no epilogue)
            cols = im2col_nhwc(x)
            library_ms, note = int_mm_ms(cols, w.T.contiguous(), f"the im2col matrix {tuple(cols.shape)}")
            del cols
            print(f"[kernel] conv3x3_i8 {name}: bound {b['bound_ms']:.4f} ms ({b['bound_by']}); "
                  + (note if library_ms is None else f"{note}: {library_ms:.4f} ms"))
            print(f"[kernel] conv3x3_i8 {name}: int8 kernel / bf16 kernel = {ms / bf16_ms:.3f} "
                  f"({ms:.4f} / {bf16_ms:.4f} ms)")
            timed = {"ms": ms, "plain_ms": plain_ms, "bf16_ms": bf16_ms, "library_ms": library_ms,
                     "library_note": note, **b}
    return {"max_abs_err": worst, **timed, "shape": "(4096, 14, 14, 256)->256 int8 + residual"}


def check_int8_gemm() -> dict:
    """The int8 GEMM kernel against its plain version, bit for bit, at the int8 towers'
    shapes with f32 and int8 out; each shape's serving form timed beside
    ``torch._int_mm``'s product alone and the bound, and the ViT's four products again
    at batch 64."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    timed, worst, rows = None, 0.0, {}

    def case(m, k, n):
        # full-range codes: at K = 3072 |acc| reaches 4.9e7 > 2^24, where the convert rounds
        x = torch.randint(-127, 128, (m, k), generator=gen, device="cuda", dtype=torch.int8)
        w = torch.randint(-127, 128, (n, k), generator=gen, device="cuda", dtype=torch.int8)
        scale = torch.rand(n, generator=gen, device="cuda") * 1e-6
        bias = torch.randn(n, generator=gen, device="cuda") * 0.5
        return x, w, scale, bias

    def timing(x, w, scale, bias, kw):
        m, k, n = x.shape[0], x.shape[1], w.shape[0]
        ms = cuda_ms(lambda: int8_gemm(x, w, scale, bias, **kw), 20)
        out_bytes = m * n * (1 if kw.get("out_scale") else 4)
        b = bound(x.numel() + w.numel() + out_bytes + 8 * n, {"int8": 2 * m * k * n})
        library_ms, note = int_mm_ms(x, w.T.contiguous(), f"({m}, {k}) x ({k}, {n})")
        return ms, b, library_ms, note

    for what, m, k, n, relu in INT8_GEMM_SHAPES:
        x, w, scale, bias = case(m, k, n)
        if what == "resnet18 stem":
            x[:, 147:] = 0  # the im2col rows' zero columns past 7·7·3
            w[:, 147:] = 0
        for out_scale in (None, 0.05):
            kw = {"relu": relu, "out_scale": out_scale}
            got = int8_gemm(x, w, scale, bias, **kw)
            want = int8_gemm_reference(x, w, scale, bias, **kw)
            mismatches = (got != want).sum().item()
            err = (got.float() - want.float()).abs().max().item()
            name = f"{what} ({m}, {k})->{n} relu={relu} {'int8' if out_scale else 'f32'} out"
            if mismatches:
                raise AssertionError(f"int8_gemm {name}: {mismatches} elements differ from the plain version")
            worst = max(worst, err)
            serving = out_scale is None if what != "resnet18 stem" else out_scale is not None
            if not serving:
                print(f"[kernel] int8_gemm {name}: 0 mismatches")
                continue
            ms, b, library_ms, note = timing(x, w, scale, bias, kw)
            plain_ms = cuda_ms(lambda: int8_gemm_reference(x, w, scale, bias, **kw), 3, warmup=1)
            print(f"[kernel] int8_gemm {name}: 0 mismatches; kernel {ms:.4f} ms "
                  f"({2 * m * k * n / ms / 1e9:.1f} TOP/s), plain (float64) {plain_ms:.4f} ms, "
                  + (note if library_ms is None else f"{note} {library_ms:.4f} ms")
                  + f", bound {b['bound_ms']:.4f} ms ({b['bound_by']})")
            rows[what] = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, **b}
            if what == INT8_GEMM_TIMED:
                timed = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, "library_note": note, **b}
        del x, w, got, want
    total = {"ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0}
    for what, _, k, n, _ in INT8_GEMM_SHAPES[:4]:  # the ViT's four products at batch 64
        x, w, scale, bias = case(INT8_VIT_BATCH64_M, k, n)
        ms, b, library_ms, note = timing(x, w, scale, bias, {})
        print(f"[kernel] int8_gemm {what} at batch 64 ({INT8_VIT_BATCH64_M}, {k})->{n} f32 out: kernel {ms:.4f} ms, "
              + (note if library_ms is None else f"{note} {library_ms:.4f} ms")
              + f", bound {b['bound_ms']:.4f} ms ({b['bound_by']})")
        rows[f"{what} batch 64"] = {"ms": ms, "library_ms": library_ms, **b}
        total["ms"] += ms
        total["bound_ms"] += b["bound_ms"]
        total["library_ms"] += library_ms or float("nan")
        del x, w
    print(f"[kernel] int8_gemm the ViT's 48 products a forward at batch 64: kernel {12 * total['ms']:.3f} ms, "
          f"torch._int_mm {12 * total['library_ms']:.3f} ms, bound {12 * total['bound_ms']:.3f} ms")
    torch.cuda.empty_cache()
    return {"max_abs_err": worst, **timed, "shape": "(12544, 768) -> 2304 int8 x int8, f32 out (the ViT's qkv at "
            "batch 8)", "by_shape": rows}


def check_conv3x3_i8_padding() -> dict:
    """The int8 conv with ResNet-18's explicit ``(1, 1)`` at stride 2 (SAME would pad
    (0, 1) on the even plane) against its plain version, bit for bit, int8 and f32 out;
    the int8 form timed beside ``torch._int_mm`` on its im2col matrix and the bound."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    n, s, c, c_out = CONV_I8_PAD_SHAPE
    so = s // 2
    x = torch.randint(0, 128, (n, s, s, c), generator=gen, device="cuda", dtype=torch.int8)
    w = torch.randint(-127, 128, (c_out, 9 * c), generator=gen, device="cuda", dtype=torch.int8)
    scale = torch.rand(c_out, generator=gen, device="cuda") * 1e-5
    bias = torch.randn(c_out, generator=gen, device="cuda") * 0.1
    pads = [(1, 1), (1, 1)]
    timed = None
    for out_scale in (0.02, None):
        kw = {"stride": 2, "padding": pads, "relu": True, "out_scale": out_scale}
        got = conv3x3_i8(x, w, scale, bias, **kw)
        want = conv3x3_i8_reference(x, w, scale, bias, **kw)
        mismatches = (got != want).sum().item()
        same = conv3x3_i8(x, w, scale, bias, **{**kw, "padding": "SAME"})
        name = f"({n}, {s}, {s}, {c})->{c_out} stride 2 padding (1, 1) {'int8' if out_scale else 'f32'} out"
        if mismatches or torch.equal(same, got):
            raise AssertionError(f"conv3x3_i8 {name}: {mismatches} elements differ from the plain version "
                                 f"(SAME {'equal' if torch.equal(same, got) else 'differs'})")
        if out_scale is None:
            print(f"[kernel] conv3x3_i8 {name}: 0 mismatches")
            continue
        ms = cuda_ms(lambda: conv3x3_i8(x, w, scale, bias, **kw), 20)
        plain_ms = cuda_ms(lambda: conv3x3_i8_reference(x, w, scale, bias, **kw), 3, warmup=1)
        b = bound(x.numel() + w.numel() + got.numel() + 8 * c_out, {"int8": 2 * n * so * so * 9 * c * c_out})
        cols = im2col_nhwc(x, stride=2)
        library_ms, note = int_mm_ms(cols, w.T.contiguous(), f"the im2col matrix {tuple(cols.shape)}")
        del cols
        print(f"[kernel] conv3x3_i8 {name}: 0 mismatches (SAME, padding (0, 1), differs); kernel {ms:.4f} ms, plain "
              f"(float64) {plain_ms:.4f} ms, " + (note if library_ms is None else f"{note} {library_ms:.4f} ms")
              + f", bound {b['bound_ms']:.4f} ms ({b['bound_by']})")
        timed = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, **b, "shape": name}
    return timed


def check_flash() -> dict:
    """The flash kernel against its plain version on (B, H, N, 64) bf16 views of
    (B, N, H·64) projections, as the ViT's attention hands them over."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    timed, worst_abs, worst_rel = None, 0.0, 0.0
    for B, H, N in FLASH_SHAPES:
        q, k, v = (
            torch.randn((B, N, H, 64), generator=gen, device="cuda").to(torch.bfloat16).transpose(1, 2)
            for _ in range(3)
        )
        got = flash_lean(q, k, v)
        want = flash_lean_reference(q, k, v)
        err = (got.float() - want.float()).abs().max().item()
        rel = err / want.float().abs().max().item()
        print(f"[kernel] flash_lean ({B}, {H}, {N}, 64) bf16: max abs diff {err:.3e}, rel {rel:.3e}")
        if not rel <= FLASH_RTOL:
            raise AssertionError(f"flash_lean ({B}, {H}, {N}, 64): relative diff {rel} > {FLASH_RTOL}")
        worst_abs, worst_rel = max(worst_abs, err), max(worst_rel, rel)
        if (B, H, N) == FLASH_TIMED_SHAPE:
            ms = cuda_ms(lambda: flash_lean(q, k, v), 50)
            plain_ms = cuda_ms(lambda: flash_lean_reference(q, k, v), 5)
            library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v), 50)
            scores = B * H * N * N
            # 2 products of 2·N·N·64 per (batch, head) on the tensor cores; 5 f32
            # operations per score (scale, max, subtract, exponential, sum)
            b = bound(4 * q.numel() * 2, {"bf16": 4 * scores * 64, "f32": 5 * scores})
            print(
                f"[kernel] flash_lean ({B}, {H}, {N}, 64): kernel {ms:.4f} ms "
                f"({4 * scores * 64 / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.4f} ms, "
                f"F.scaled_dot_product_attention {library_ms:.4f} ms, bound {b['bound_ms']:.4f} ms ({b['bound_by']})"
            )
            timed = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, **b}
    return {"max_abs_err": worst_abs, "max_rel_err": worst_rel, **timed, "shape": "(8, 12, 1568, 64) bf16"}


def check_flash_backward() -> dict:
    """The dK/dV and dQ kernels (and the forward's log-sum-exp they read) against
    autograd through the plain attention, on (B, H, N, 64) bf16 views of (B, N, H·64)
    buffers, as the ViT's attention hands them over; at the pretraining shape, dq and
    ``di`` and dk and dv bit for bit across two calls (no atomics) and the times."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = {"dkv": [0.0, 0.0], "dq": [0.0, 0.0]}
    timed = None
    for B, H, N in FLASH_BWD_SHAPES + FLASH_F32_DKV_SHAPES:
        q, k, v, dout = (
            torch.randn((B, N, H, 64), generator=gen, device="cuda").to(torch.bfloat16).transpose(1, 2)
            for _ in range(4)
        )
        out, lse, out_f32 = flash_lean_with_stats(q, k, v, SM_SCALE)
        lse_err = (lse - torch.logsumexp((q.float() @ k.float().mT) * SM_SCALE, dim=-1)).abs().max().item()
        if not torch.equal(out_f32.to(torch.bfloat16), out):
            raise AssertionError(f"flash forward ({B}, {H}, {N}): the f32 output does not round to the bf16 one")
        got = dict(zip(("dq", "dk", "dv"), flash_lean_backward(q, k, v, out_f32, dout, lse, SM_SCALE)))
        want = dict(zip(("dq", "dk", "dv"), flash_lean_backward_reference(q, k, v, dout, SM_SCALE)))
        errs = {}
        for name in got:
            err = (got[name].float() - want[name].float()).abs().max().item()
            errs[name] = (err, err / want[name].float().abs().max().item())
        print(f"[kernel] flash backward ({B}, {H}, {N}, 64) bf16: lse max abs diff {lse_err:.3e}; "
              + ", ".join(f"{n} max abs diff {e:.3e} rel {r:.3e}" for n, (e, r) in errs.items()))
        if not lse_err <= LSE_ATOL:
            raise AssertionError(f"flash lse ({B}, {H}, {N}): max abs diff {lse_err} > {LSE_ATOL}")
        for name, (err, rel) in errs.items():
            if not rel <= FLASH_BWD_RTOL:
                raise AssertionError(f"flash backward {name} ({B}, {H}, {N}): relative diff {rel} > {FLASH_BWD_RTOL}")
            w = worst["dq" if name == "dq" else "dkv"]
            w[0], w[1] = max(w[0], err), max(w[1], rel)
        del got, want
        if (B, H, N) == FLASH_BWD_TIMED_SHAPE:
            first, again = (flash_lean_bwd_dq(q, k, v, out_f32, dout, lse, SM_SCALE) for _ in range(2))
            if not all(torch.equal(a, b) for a, b in zip(first, again)):
                raise AssertionError("flash dQ: two calls on the same operands differ (dq or di)")
            di = first[1]
            first, again = (flash_lean_bwd_dkv(q, k, v, dout, lse, di, SM_SCALE) for _ in range(2))
            if not all(torch.equal(a, b) for a, b in zip(first, again)):
                raise AssertionError("flash dK/dV: two calls on the same operands differ")
            del first, again
            dkv_ms = cuda_ms(lambda: flash_lean_bwd_dkv(q, k, v, dout, lse, di, SM_SCALE), 20)
            dq_ms = cuda_ms(lambda: flash_lean_bwd_dq(q, k, v, out_f32, dout, lse, SM_SCALE), 20)
            plain_ms = cuda_ms(lambda: flash_lean_backward_reference(q, k, v, dout, SM_SCALE), 3, warmup=1)
            # one PyTorch call: the backward of SDPA alone, its graph kept from one forward
            leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
            o = F.scaled_dot_product_attention(*leaves)
            library_ms = cuda_ms(lambda: torch.autograd.grad(o, leaves, dout, retain_graph=True), 20)
            del o, leaves
            product = 2 * B * H * N * N * 64  # one (N, N, 64) product per (batch, head)
            tensor = q.numel() * 2  # bytes of one (B, H, N, 64) bf16 tensor
            stat = lse.numel() * 4  # bytes of lse or di
            # the whole backward (q, k, v, dO, the f32 o and lse in; dq, dk, dv out): S and
            # dP once, then dV, dK and dQ. Each kernel alone: S, dP, dV, dK (q, k, v, dO, lse
            # and di in; dk, dv out) and S, dP, dQ and di (q, k, v, dO, the f32 o and lse in;
            # dq, di out)
            b_fn = bound(9 * tensor + stat, {"bf16": 5 * product})
            b_dkv = bound(6 * tensor + 2 * stat, {"bf16": 4 * product})
            b_dq = bound(7 * tensor + 2 * stat, {"bf16": 3 * product})
            print(
                f"[kernel] flash backward ({B}, {H}, {N}, 64): dK/dV kernel {dkv_ms:.4f} ms "
                f"({4 * product / dkv_ms / 1e9:.1f} TFLOP/s, bound {b_dkv['bound_ms']:.4f} ms), dQ kernel "
                f"{dq_ms:.4f} ms ({3 * product / dq_ms / 1e9:.1f} TFLOP/s, bound {b_dq['bound_ms']:.4f} ms, "
                f"di included); together {dkv_ms + dq_ms:.4f} ms against the function's bound "
                f"{b_fn['bound_ms']:.4f} ms ({b_fn['bound_by']}); plain backward {plain_ms:.4f} ms; "
                f"SDPA backward {library_ms:.4f} ms"
            )
            # the training forward at the same shape (the LSE and the f32 O stored too)
            # beside one PyTorch call for the attention, SDPA's forward
            fwd_ms = cuda_ms(lambda: flash_lean_with_stats(q, k, v, SM_SCALE), 20)
            fwd_library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v), 20)
            scores = B * H * N * N
            b_fwd = bound(6 * tensor + stat, {"bf16": 4 * scores * 64, "f32": 5 * scores})
            print(f"[kernel] flash forward with stats ({B}, {H}, {N}, 64): kernel {fwd_ms:.4f} ms, "
                  f"F.scaled_dot_product_attention {fwd_library_ms:.4f} ms, bound {b_fwd['bound_ms']:.4f} ms "
                  f"({b_fwd['bound_by']})")
            timed = {
                "dkv": {"ms": dkv_ms, **b_dkv},
                "dq": {"ms": dq_ms, **b_dq},
                "common": {"plain_ms": plain_ms, "library_ms": library_ms,
                           "function_bound_ms": b_fn["bound_ms"], "shape": f"{FLASH_BWD_TIMED_SHAPE + (64,)} bf16"},
                "train_forward": {"train_forward_shape": f"{FLASH_BWD_TIMED_SHAPE + (64,)} bf16",
                                  "train_forward_ms": fwd_ms, "train_forward_library_ms": fwd_library_ms,
                                  "train_forward_bound_ms": b_fwd["bound_ms"]},
            }
    out = {
        name: {"max_abs_err": worst[name][0], "max_rel_err": worst[name][1], **timed[name], **timed["common"]}
        for name in ("dkv", "dq")
    }
    out["train_forward"] = timed["train_forward"]
    return out


def f32_projections(gen, B: int, H: int, N: int, n: int = 3) -> list:
    """``n`` (B, H, N, 64) f32 views of (B, N, H·64) buffers, as the ViT's attention hands
    them over."""
    return [torch.randn((B, N, H, 64), generator=gen, device="cuda").transpose(1, 2) for _ in range(n)]


def ffma_ms(flops: float) -> float:
    """``flops`` of f32 work at the card's FFMA rate, in ms."""
    return flops / PEAK_OPS_PER_S["f32"] * 1e3


def kernel_attributes(name: str) -> dict:
    """``_ext.kernel_attributes(name)``, printed: the registers and spills a later change
    would move show in the card's own run."""
    attrs = _ext.kernel_attributes(name)
    print(f"[kernel] {name} attributes: {attrs['registers']} registers a thread, {attrs['local_bytes']} bytes of "
          f"local memory (spills) a thread, {attrs['static_shared_bytes']} bytes of static and "
          f"{attrs['max_dynamic_shared_bytes']} of dynamic shared memory")
    return attrs


def check_flash_f32() -> dict:
    """The f32 forward kernel against its plain version in float64 on f32 views of (B, N,
    H·64) projections at the bf16 form's shapes and FLASH_F32_FWD_EDGES; at (8, 12, 1568)
    bit for bit across two calls, with and without the LSE, its time beside the plain
    version's (in f32), SDPA's in f32 with TF32 off and the bound (three TF32 products an
    f32 one, and at the FFMA rate), and its compiled attributes."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    timed, worst_abs, worst_rel = None, 0.0, 0.0
    for B, H, N in FLASH_SHAPES + FLASH_F32_FWD_EDGES:
        q, k, v = f32_projections(gen, B, H, N)
        got = flash_lean(q, k, v)
        if got.dtype != torch.float32:
            raise AssertionError(f"flash_lean f32 ({B}, {H}, {N}): output {got.dtype}")
        want = flash_lean_reference(q.double(), k.double(), v.double())
        err = (got.double() - want).abs().max().item()
        rel = err / want.abs().max().item()
        print(f"[kernel] flash_lean ({B}, {H}, {N}, 64) f32: against float64 max abs diff {err:.3e}, rel {rel:.3e}")
        if not rel <= FLASH_F32_RTOL:
            raise AssertionError(f"flash_lean f32 ({B}, {H}, {N}, 64): relative diff {rel} > {FLASH_F32_RTOL}")
        worst_abs, worst_rel = max(worst_abs, err), max(worst_rel, rel)
        del want
        if (B, H, N) == FLASH_TIMED_SHAPE:
            (out, lse, _), (out2, lse2, _) = (flash_lean_with_stats(q, k, v, SM_SCALE) for _ in range(2))
            if not (torch.equal(got, flash_lean(q, k, v)) and torch.equal(out, got) and torch.equal(out, out2)
                    and torch.equal(lse, lse2)):
                raise AssertionError("flash_lean f32: two calls, or the calls with and without the LSE, differ")
            del out, lse, out2, lse2
            ms = cuda_ms(lambda: flash_lean(q, k, v), 20)
            plain_ms = cuda_ms(lambda: flash_lean_reference(q, k, v), 5)
            library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v), 20)
            scores = B * H * N * N
            # 2 products of 2·N·N·64 per (batch, head) of f32 work; 5 f32 operations per
            # score (scale, max, subtract, exponential, sum)
            b = bound(4 * q.numel() * 4, {"tf32x3": 4 * scores * 64, "f32": 5 * scores})
            ffma = ffma_ms(4 * scores * 64)
            print(
                f"[kernel] flash_lean ({B}, {H}, {N}, 64) f32: kernel {ms:.4f} ms "
                f"({4 * scores * 64 / ms / 1e9:.1f} TFLOP/s), plain (f32) {plain_ms:.4f} ms, "
                f"F.scaled_dot_product_attention (f32, TF32 off) {library_ms:.4f} ms, bound {b['bound_ms']:.4f} ms "
                f"({b['bound_by']}; {ffma:.4f} ms at the FFMA rate)"
            )
            timed = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, **b, "ffma_bound_ms": ffma,
                     "attributes": kernel_attributes("flash_attn_f32")}
    return {"max_abs_err": worst_abs, "max_rel_err": worst_rel, **timed, "shape": "(8, 12, 1568, 64) f32"}


def check_flash_backward_f32() -> dict:
    """The f32 forward's log-sum-exp and the f32 dQ and dK/dV kernels against the plain
    backward in float64 on f32 views of (B, N, H·64) buffers at the bf16 forms' shapes and
    FLASH_F32_DKV_SHAPES; at the pretraining shape, both kernels bit for bit across two calls and the times
    (the plain backward's in f32, SDPA's f32 backward with TF32 off, the bounds), and the
    training forward's."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = {"dkv": [0.0, 0.0], "dq": [0.0, 0.0]}
    timed = None
    for B, H, N in FLASH_BWD_SHAPES + FLASH_F32_DKV_SHAPES:
        q, k, v, dout = f32_projections(gen, B, H, N, 4)
        out, lse, out_f32 = flash_lean_with_stats(q, k, v, SM_SCALE)
        if out_f32 is not out:
            raise AssertionError("flash forward f32: the f32 output is not the output")
        lse_err = (lse.double() - torch.logsumexp((q.double() @ k.double().mT) * SM_SCALE, dim=-1)).abs().max().item()
        got = dict(zip(("dq", "dk", "dv"), flash_lean_backward(q, k, v, out_f32, dout, lse, SM_SCALE)))
        want = dict(zip(("dq", "dk", "dv"), flash_lean_backward_reference(
            q.double(), k.double(), v.double(), dout.double(), SM_SCALE)))
        errs = {}
        for name in got:
            if got[name].dtype != torch.float32:
                raise AssertionError(f"flash backward f32 {name}: {got[name].dtype}")
            err = (got[name].double() - want[name]).abs().max().item()
            errs[name] = (err, err / want[name].abs().max().item())
        print(f"[kernel] flash backward ({B}, {H}, {N}, 64) f32 against float64: lse max abs diff {lse_err:.3e}; "
              + ", ".join(f"{n} max abs diff {e:.3e} rel {r:.3e}" for n, (e, r) in errs.items()))
        if not lse_err <= FLASH_F32_LSE_ATOL:
            raise AssertionError(f"flash lse f32 ({B}, {H}, {N}): max abs diff {lse_err} > {FLASH_F32_LSE_ATOL}")
        for name, (err, rel) in errs.items():
            if not rel <= FLASH_F32_RTOL:
                raise AssertionError(f"flash backward f32 {name} ({B}, {H}, {N}): relative diff {rel} > "
                                     f"{FLASH_F32_RTOL}")
            w = worst["dq" if name == "dq" else "dkv"]
            w[0], w[1] = max(w[0], err), max(w[1], rel)
        del got, want
        if (B, H, N) == FLASH_BWD_TIMED_SHAPE:
            first, again = (flash_lean_bwd_dq(q, k, v, out_f32, dout, lse, SM_SCALE) for _ in range(2))
            if not all(torch.equal(a, b) for a, b in zip(first, again)):
                raise AssertionError("flash dQ f32: two calls on the same operands differ (dq or di)")
            di = first[1]
            first, again = (flash_lean_bwd_dkv(q, k, v, dout, lse, di, SM_SCALE) for _ in range(2))
            if not all(torch.equal(a, b) for a, b in zip(first, again)):
                raise AssertionError("flash dK/dV f32: two calls on the same operands differ")
            del first, again
            dkv_ms = cuda_ms(lambda: flash_lean_bwd_dkv(q, k, v, dout, lse, di, SM_SCALE), 10)
            dq_ms = cuda_ms(lambda: flash_lean_bwd_dq(q, k, v, out_f32, dout, lse, SM_SCALE), 10)
            plain_ms = cuda_ms(lambda: flash_lean_backward_reference(q, k, v, dout, SM_SCALE), 3, warmup=1)
            leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
            o = F.scaled_dot_product_attention(*leaves)
            library_ms = cuda_ms(lambda: torch.autograd.grad(o, leaves, dout, retain_graph=True), 10)
            del o, leaves
            product = 2 * B * H * N * N * 64
            tensor = q.numel() * 4  # bytes of one (B, H, N, 64) f32 tensor
            stat = lse.numel() * 4
            # the whole backward (q, k, v, dO, O and lse in; dq, dk, dv out): S and dP once,
            # then dV, dK and dQ. dK/dV: q, k, v, dO, lse and di in, dk and dv out; dQ: q, k,
            # v, O, dO and lse in, dq and di out
            b_fn = bound(8 * tensor + stat, {"tf32x3": 5 * product})
            b_dkv = bound(6 * tensor + 2 * stat, {"tf32x3": 4 * product})
            b_dq = bound(6 * tensor + 2 * stat, {"tf32x3": 3 * product})
            print(
                f"[kernel] flash backward ({B}, {H}, {N}, 64) f32: dK/dV kernel {dkv_ms:.4f} ms "
                f"({4 * product / dkv_ms / 1e9:.1f} TFLOP/s, bound {b_dkv['bound_ms']:.4f} ms, "
                f"{ffma_ms(4 * product):.4f} at the FFMA rate), dQ kernel {dq_ms:.4f} ms "
                f"({3 * product / dq_ms / 1e9:.1f} TFLOP/s, bound {b_dq['bound_ms']:.4f} ms, "
                f"{ffma_ms(3 * product):.4f} at the FFMA rate, di included); together {dkv_ms + dq_ms:.4f} ms "
                f"against the function's bound {b_fn['bound_ms']:.4f} ms ({b_fn['bound_by']}); plain backward (f32) "
                f"{plain_ms:.4f} ms; SDPA backward (f32, TF32 off) {library_ms:.4f} ms"
            )
            fwd_ms = cuda_ms(lambda: flash_lean_with_stats(q, k, v, SM_SCALE), 10)
            fwd_library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v), 10)
            scores = B * H * N * N
            b_fwd = bound(4 * tensor + stat, {"tf32x3": 4 * scores * 64, "f32": 5 * scores})
            print(f"[kernel] flash forward with stats ({B}, {H}, {N}, 64) f32: kernel {fwd_ms:.4f} ms, "
                  f"F.scaled_dot_product_attention (f32, TF32 off) {fwd_library_ms:.4f} ms, bound "
                  f"{b_fwd['bound_ms']:.4f} ms ({b_fwd['bound_by']}; {ffma_ms(4 * scores * 64):.4f} at the FFMA rate)")
            timed = {
                "dkv": {"ms": dkv_ms, **b_dkv, "ffma_bound_ms": ffma_ms(4 * product),
                        "attributes": kernel_attributes("flash_bwd_dkv_f32")},
                "dq": {"ms": dq_ms, **b_dq, "ffma_bound_ms": ffma_ms(3 * product),
                       "attributes": kernel_attributes("flash_bwd_dq_f32")},
                "common": {"plain_ms": plain_ms, "library_ms": library_ms,
                           "function_bound_ms": b_fn["bound_ms"], "shape": f"{FLASH_BWD_TIMED_SHAPE + (64,)} f32"},
                "train_forward": {"train_forward_shape": f"{FLASH_BWD_TIMED_SHAPE + (64,)} f32",
                                  "train_forward_ms": fwd_ms, "train_forward_library_ms": fwd_library_ms,
                                  "train_forward_bound_ms": b_fwd["bound_ms"],
                                  "train_forward_attributes": kernel_attributes("flash_attn_f32_stats")},
            }
    out = {
        name: {"max_abs_err": worst[name][0], "max_rel_err": worst[name][1], **timed[name], **timed["common"]}
        for name in ("dkv", "dq")
    }
    out["train_forward"] = timed["train_forward"]
    return out


def check_int8_tree_device(served: dict, params) -> None:
    """The quantized tower that ``entry.build_int8_forward(device="cuda")`` serves
    against the one the CPU builds (as the JAX package calibrates) from the same
    parameters and calibration clips (``build_int8_forward``'s default: 2 clips of noise
    from seed 0): every site's ``x_scale`` and ``w_q`` equal."""
    cfg = flagship_config()
    d = cfg.data
    H, W = d.video_resize
    clips = (np.random.default_rng(0).random((2, d.video_frames_per_window, H, W, 3)) * 255).astype(np.uint8)
    trees = {"cuda": served, "cpu": build_quantized_tree(params, clips, device="cpu")}

    def leaves(tree, path=()):
        if isinstance(tree, dict):
            for key, value in tree.items():
                yield from leaves(value, path + (str(key),))
        elif isinstance(tree, (list, tuple)):
            for i, value in enumerate(tree):
                yield from leaves(value, path + (str(i),))
        elif path and path[-1] in ("x_scale", "w_q"):
            yield "/".join(path), tree

    card, host = dict(leaves(trees["cuda"])), dict(leaves(trees["cpu"]))
    if card.keys() != host.keys() or not card:
        raise AssertionError(f"int8 trees differ in their sites: {sorted(card.keys() ^ host.keys())}")
    differ = [name for name in card if not torch.equal(torch.as_tensor(card[name]).cpu(), torch.as_tensor(host[name]))]
    n_scales = sum(name.endswith("x_scale") for name in card)
    print(f"[int8 tree] served on the card vs built on the CPU: {n_scales} x_scale and {len(card) - n_scales} w_q leaves, "
          f"{len(differ)} differ{': ' + ', '.join(differ) if differ else ''}")
    if differ:
        raise AssertionError(f"the card's int8 tree differs from the CPU's at {differ}")


def pretrain_batches(cfg, n: int, batch: int, seed: int) -> list:
    """Seeded training batches on the card: featurized IMU windows ``(B, 6, 250)`` from
    raw counts and uint8 NHWC clips."""
    d = cfg.data
    H, W = d.video_resize
    gen = torch.Generator(device="cuda").manual_seed(seed)
    batches = []
    for _ in range(n):
        raw = torch.randn((batch, d.imu_window_size, d.imu_channels), generator=gen, device="cuda") * 8000.0
        imu = featurize_windows_auto(raw, kernel_size=d.median_filter_kernel, normalize=d.normalize_imu,
                                     racc=d.Racc, rgyro=d.Rgyro)
        video = torch.randint(0, 256, (batch, d.video_frames_per_window, H, W, 3), generator=gen,
                              device="cuda", dtype=torch.uint8)
        batches.append({"imu": imu, "video": video})
    return batches


def first_step_grads(cfg, params, batch: dict, seed: int):
    """The loss, every parameter's gradient (f32, by name) of one training forward and
    backward from ``params`` on ``batch`` (dropout from a card generator of ``seed``),
    and for each SigLIP scalar the most its per-pair terms can weigh: Σ|∂loss/∂logit_ij|
    for the bias, e^t times that for the temperature."""
    task = build_pretrain_task(cfg, device="cuda", params=params, steps_per_epoch=1)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    loss_fn = contrastive_loss_fn(cfg)
    with precision_scope(cfg.training.pretrain_matmul_precision):
        out = task.model.forward_cast(batch["imu"], normalize_clip(batch["video"]), train=True, generator=gen)
        loss = loss_fn(out)
        loss.backward()
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p)).detach().float()
             for n, p in task.model.named_parameters()}
    # one copy of the bias per pair: the gradient of each copy is ∂loss/∂logit_ij
    B = out["imu_proj"].shape[0]
    detached = {k: v.detach() for k, v in out.items()}
    pairs = detached["logit_bias"].expand(B, B).clone().requires_grad_(True)
    per_pair, = torch.autograd.grad(loss_fn({**detached, "logit_bias": pairs}), pairs)
    weight = per_pair.abs().sum().item()
    scales = {"bias": weight, "temperature": detached["logit_scale"].exp().item() * weight}
    return loss.item(), grads, scales


def gradient_agreement(grads: dict, grads_ref: dict, skip) -> tuple:
    """(cosine of the whole gradients as one vector, the three lowest leaf cosines, how many
    leaves are below 0.99), over the leaves not in ``skip``."""
    names = [n for n in grads_ref if n not in skip]
    whole = cosine(torch.cat([grads[n].flatten() for n in names]), torch.cat([grads_ref[n].flatten() for n in names]))
    leaves = sorted((cosine(grads[n], grads_ref[n]), n) for n in names)
    return whole, leaves[:3], sum(c < 0.99 for c, _ in leaves)


@contextlib.contextmanager
def in_situ_flash_backwards():
    """Hold every flash backward run inside the scope against the plain backward in f32
    on that layer's own q, k, v and dO: yields two lists that fill with, per backward, the
    kernels' largest relative difference and the plain bf16 backward's."""
    in_situ, plain_bf16 = [], []
    original = flash_lean_module.flash_lean_backward

    def rel(got, want):
        return max((g.float() - w).abs().max().item() / w.abs().max().item() for g, w in zip(got, want))

    def checked_backward(q, k, v, out_f32, dout, lse, sm_scale):
        got = original(q, k, v, out_f32, dout, lse, sm_scale)
        want = flash_lean_backward_reference(q.float(), k.float(), v.float(), dout.float(), sm_scale)
        in_situ.append(rel(got, want))
        plain_bf16.append(rel(flash_lean_backward_reference(q, k, v, dout, sm_scale), want))
        return got

    flash_lean_module.flash_lean_backward = checked_backward
    try:
        yield in_situ, plain_bf16
    finally:
        flash_lean_module.flash_lean_backward = original


def check_first_step(cfg_card, params, batch: dict, tag: str = "pretrain check") -> None:
    """The card's first step (bf16, the flash kernels where the tower is a ViT) against
    the plain path on the card (f32, attention without flash, TF32 off) on the same
    parameters, batch and dropout; for a ViT beside the same bf16 step with the plain
    attention (no hand kernel) as the yardstick of what bf16 itself moves, and each flash
    backward of the card's step against the plain f32 backward on that layer's own q, k,
    v and dO. A CNN tower trains through cuDNN: the card step and the yardstick are one."""
    vit = cfg_card.model.video_backbone in VIT_CONFIGS
    cfg_plain = copy.deepcopy(cfg_card)
    cfg_plain.model.compute_dtype = "float32"
    cfg_plain.model.use_flash_attention = False
    cfg_bf16_plain = copy.deepcopy(cfg_card)
    cfg_bf16_plain.model.use_flash_attention = False
    with in_situ_flash_backwards() as (in_situ, plain_bf16):
        loss, grads, _ = first_step_grads(cfg_card, params, batch, seed=7)
    torch.cuda.empty_cache()
    if vit:
        loss_bf16, grads_bf16, _ = first_step_grads(cfg_bf16_plain, params, batch, seed=7)
    else:
        loss_bf16, grads_bf16 = loss, grads
    torch.cuda.empty_cache()
    loss_ref, grads_ref, scales = first_step_grads(cfg_plain, params, batch, seed=7)
    depth = VIT_CONFIGS[cfg_card.model.video_backbone][0] if vit else 0
    if vit:
        print(f"[{tag}] the card step's {len(in_situ)} flash backwards against the plain f32 backward "
              f"on their own operands: relative diffs {', '.join(f'{r:.2e}' for r in in_situ)}; the plain bf16 "
              f"backward's: {', '.join(f'{r:.2e}' for r in plain_bf16)}")
    if len(in_situ) != depth or not max(in_situ, default=0.0) <= FLASH_BWD_RTOL:
        raise AssertionError(f"in-situ flash backward: {in_situ} (expected {depth} within {FLASH_BWD_RTOL})")
    rel = abs(loss - loss_ref) / abs(loss_ref)
    print(f"[{tag}] batch {batch['imu'].shape[0]} loss: card bf16 {loss:.6f}"
          + (f", bf16 with the plain attention {loss_bf16:.6f}" if vit else "")
          + f", plain f32 {loss_ref:.6f}, rel {rel:.3e}")
    if not rel <= PRETRAIN_LOSS_RTOL:
        raise AssertionError(f"pretrain first-step loss: relative diff {rel} > {PRETRAIN_LOSS_RTOL}")
    for name, weight in scales.items():
        g, g_ref = grads[name].item(), grads_ref[name].item()
        r = abs(g - g_ref) / weight
        print(f"[{tag}] grad {name}: card {g:.6e}, plain {g_ref:.6e}, diff over the most its terms "
              f"can weigh ({weight:.6e}) {r:.3e}")
        if not r <= SCALAR_GRAD_RTOL:
            raise AssertionError(f"grad {name}: diff {r} of its terms' weight > {SCALAR_GRAD_RTOL}")
    rms = {n: g.norm().item() / g.numel() ** 0.5 for n, g in grads_ref.items()}
    floor = GRAD_NOISE_FLOOR * max(rms.values())
    noise = [n for n in grads_ref if n not in scales and rms[n] <= floor]
    skip = set(noise) | set(scales)
    whole, lowest, below = gradient_agreement(grads, grads_ref, skip)
    whole_bf16, lowest_bf16, below_bf16 = gradient_agreement(grads_bf16, grads_ref, skip)
    rows = (("card bf16 (flash kernels)", (whole, lowest, below)),
            ("bf16 with the plain attention", (whole_bf16, lowest_bf16, below_bf16)))
    for what, (w, low, n) in rows if vit else (("card bf16", rows[0][1]),):
        print(f"[{tag}] {what} vs plain f32: whole-gradient cosine {w:.6f}; {n} of "
              f"{len(grads_ref) - len(skip)} leaves below 0.99, the lowest "
              + ", ".join(f"{c:.4f} ({name})" for c, name in low))
    if vit:
        between = gradient_agreement(grads, grads_bf16, skip)[0]
        print(f"[{tag}] card bf16 vs bf16 with the plain attention: whole-gradient cosine {between:.6f}")
    print(f"[{tag}] {len(noise)} leaves at the rounding floor (RMS <= {floor:.3e}), not compared: "
          + ", ".join(noise))
    if not whole >= WHOLE_COSINE_MIN:
        raise AssertionError(f"whole-gradient cosine {whole} < {WHOLE_COSINE_MIN}")


def classify_batches(cfg, n: int, batch: int, seed: int, *, video: bool) -> list:
    """Seeded classification batches on the card: featurized IMU windows from raw counts,
    uint8 NHWC clips where ``video``, labels over the configuration's classes, and
    ``n_valid``."""
    d = cfg.data
    H, W = d.video_resize
    gen = torch.Generator(device="cuda").manual_seed(seed)
    batches = []
    for _ in range(n):
        raw = torch.randn((batch, d.imu_window_size, d.imu_channels), generator=gen, device="cuda") * 8000.0
        b = {"imu": featurize_windows_auto(raw, kernel_size=d.median_filter_kernel, normalize=d.normalize_imu,
                                           racc=d.Racc, rgyro=d.Rgyro),
             "label": torch.randint(0, cfg.model.num_classes, (batch,), generator=gen, device="cuda"),
             "n_valid": batch}
        if video:
            b["video"] = torch.randint(0, 256, (batch, d.video_frames_per_window, H, W, 3), generator=gen,
                                       device="cuda", dtype=torch.uint8)
        batches.append(b)
    return batches


def classifier_step_grads(cfg, params, batch: dict, seed: int):
    """The cross-entropy and every parameter's gradient (f32, by name) of one training
    forward and backward of the fusion classifier from ``params`` on ``batch`` (dropout
    from a card generator of ``seed``)."""
    task = build_fusion_task(cfg, device="cuda", params=params, steps_per_epoch=1)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    with precision_scope(cfg.training.pretrain_matmul_precision):
        logits, _ = task.model.forward_cast(batch["imu"], normalize_clip(batch["video"]), train=True, generator=gen)
        loss = cross_entropy_loss(logits, batch["label"])
        loss.backward()
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p)).detach().float()
             for n, p in task.model.named_parameters()}
    return loss.item(), grads


def check_first_classifier_step(cfg_card, params, batch: dict) -> None:
    """The fusion classifier's first step on the card (bf16, the flash kernels) against
    the plain path on the card (f32, attention without flash, TF32 off) on the same
    parameters, batch and dropout: the loss and the whole gradient, as phase 14 holds the
    pretraining step; and each flash backward of the card's step against the plain f32
    backward on that layer's own operands."""
    cfg_plain = copy.deepcopy(cfg_card)
    cfg_plain.model.compute_dtype = "float32"
    cfg_plain.model.use_flash_attention = False
    with in_situ_flash_backwards() as (in_situ, plain_bf16):
        loss, grads = classifier_step_grads(cfg_card, params, batch, seed=7)
    torch.cuda.empty_cache()
    loss_ref, grads_ref = classifier_step_grads(cfg_plain, params, batch, seed=7)
    depth = VIT_CONFIGS[cfg_card.model.video_backbone][0]
    print(f"[classify check] the card step's {len(in_situ)} flash backwards against the plain f32 backward "
          f"on their own operands: relative diffs {', '.join(f'{r:.2e}' for r in in_situ)}; the plain bf16 "
          f"backward's: {', '.join(f'{r:.2e}' for r in plain_bf16)}")
    if len(in_situ) != depth or not max(in_situ) <= FLASH_BWD_RTOL:
        raise AssertionError(f"in-situ flash backward: {in_situ} (expected {depth} within {FLASH_BWD_RTOL})")
    rel = abs(loss - loss_ref) / abs(loss_ref)
    print(f"[classify check] fusion batch {batch['imu'].shape[0]} loss: card bf16 {loss:.6f}, plain f32 "
          f"{loss_ref:.6f}, rel {rel:.3e}")
    if not rel <= PRETRAIN_LOSS_RTOL:
        raise AssertionError(f"fusion first-step loss: relative diff {rel} > {PRETRAIN_LOSS_RTOL}")
    rms = {n: g.norm().item() / g.numel() ** 0.5 for n, g in grads_ref.items()}
    floor = GRAD_NOISE_FLOOR * max(rms.values())
    noise = [n for n in grads_ref if rms[n] <= floor]
    whole, lowest, below = gradient_agreement(grads, grads_ref, set(noise))
    print(f"[classify check] card bf16 (flash kernels) vs plain f32: whole-gradient cosine {whole:.6f}; {below} of "
          f"{len(grads_ref) - len(noise)} leaves below 0.99, the lowest "
          + ", ".join(f"{c:.4f} ({name})" for c, name in lowest))
    print(f"[classify check] {len(noise)} leaves at the rounding floor (RMS <= {floor:.3e}), not compared: "
          + ", ".join(noise))
    if not whole >= WHOLE_COSINE_MIN:
        raise AssertionError(f"fusion whole-gradient cosine {whole} < {WHOLE_COSINE_MIN}")


def time_train_step(task, batches: list, generator, steps: int, what: str, smi: str) -> None:
    """``steps`` train steps on ``batches`` in turn: ms a step, samples/s and peak memory
    (beside what was allocated before the steps: the earlier phases' programs and the
    batches)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    for i in range(steps):
        task.train_step(task.state, batches[i % len(batches)], generator)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / steps * 1e3
    batch = batches[0]["imu"].shape[0]
    print(f"[timing] {what} train step batch {batch}: {step_ms:.3f} ms, {batch / step_ms * 1e3:.1f} samples/s, "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, {held / 2**30:.2f} GiB of it held "
          f"before the steps ({smi})")


def moved(model, before: dict, prefix: str = "") -> tuple:
    """(names of the parameters under ``prefix`` that moved, those that did not)."""
    names = [n for n in before if n.startswith(prefix)]
    still = [n for n in names if torch.equal(dict(model.named_parameters())[n], before[n])]
    return [n for n in names if n not in still], still


def request(seed: int, batch: int):
    """Seeded raw IMU counts and a uint8 clip, made patch-major on the host."""
    rng = np.random.default_rng(seed)
    imu = rng.normal(0, 8000.0, (batch, 250, 6)).astype(np.float32)
    clip = rng.integers(0, 256, (batch, 16, 224, 224, 3), dtype=np.uint8)
    return torch.from_numpy(imu), torch.from_numpy(to_patch_major(clip))


def vit_request(seed: int, batch: int):
    """Seeded raw IMU counts and a uint8 NHWC clip, as the ViT consumes them."""
    rng = np.random.default_rng(seed)
    imu = rng.normal(0, 8000.0, (batch, 250, 6)).astype(np.float32)
    return torch.from_numpy(imu), torch.from_numpy(rng.integers(0, 256, (batch, 16, 224, 224, 3), dtype=np.uint8))


def engine_request(seed: int, n: int, cfg):
    """Seeded raw IMU counts and a uint8 NHWC clip, as a user hands them to the engine."""
    rng = np.random.default_rng(seed)
    d = cfg.data
    H, W = d.video_resize
    imu = rng.normal(0, 8000.0, (n, d.imu_window_size, d.imu_channels)).astype(np.float32)
    return imu, rng.integers(0, 256, (n, d.video_frames_per_window, H, W, 3), dtype=np.uint8)


def bitwise_equal(got: dict, want: dict, what: str) -> None:
    """Fail unless every output of ``want`` equals ``got``'s bit for bit, naming the
    first that does not with its largest difference."""
    for key, value in want.items():
        if not np.array_equal(got[key], value):
            diff = np.abs(got[key].astype(np.float64) - np.asarray(value, np.float64)).max()
            raise AssertionError(f"{what}: {key} differs by up to {diff:.3e}")


def check_engine(path: str, engine, eager, expected: dict, counters: dict, kernels: dict, smi: str) -> None:
    """Warm up and capture ``engine`` with every launch count set to 0 before and read
    after; hold its graphs' launches to ``expected`` (one eager forward's), its
    ``predict`` at 8 to ``eager`` on the same padded inputs and ``predict_stream`` to
    ``predict``, bit for bit; then time each registered size."""
    for counter in counters.values():
        counter.launches = 0
    t0 = time.perf_counter()
    engine.warmup()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    counts = {name: counter.launches for name, counter in counters.items()}
    print(f"[{path}] warmup: an eager call and a capture at each of {engine.batch_sizes} in {warm_s:.1f} s; "
          f"launches {counts}; launches a replay {engine.graph_launches}")
    for b, launches in engine.graph_launches.items():
        for name, n in expected.items():
            if launches.get(name, 0) != n:
                raise AssertionError(f"{path} batch {b}: the graph holds {launches.get(name, 0)} {name} launches, "
                                     f"the eager forward {n}")
    for name, n in counts.items():  # each size: one eager call, one capture
        if n != 2 * len(engine.batch_sizes) * expected.get(name, 0):
            raise AssertionError(f"{path}: warmup launched {name} {n} times")
        kernels[name].setdefault("launches_by_path", {})[path] = engine.graph_launches[8].get(name, 0)

    cfg = engine.config
    imu, clip = engine_request(400, 8, cfg)
    got = engine.predict(imu, clip)
    args = [torch.from_numpy(a).cuda() for a in engine._pad_to(imu, clip, 8)]
    want = {k: v.cpu().numpy() for k, v in eager(*args).items()}
    bitwise_equal(got, want, f"{path} predict at 8 vs the eager program")
    if not np.array_equal(got["preds"], want["logits"].argmax(-1)) or got["preds"].dtype != np.int32:
        raise AssertionError(f"{path}: preds are not the int32 argmax of the logits")
    batches = [engine_request(410 + i, n, cfg) for i, n in enumerate(STREAM_SIZES)]
    outs = list(engine.predict_stream(iter(batches)))
    if len(outs) != len(batches):
        raise AssertionError(f"{path}: predict_stream gave {len(outs)} outputs for {len(batches)} batches")
    for i, (out, batch) in enumerate(zip(outs, batches)):
        bitwise_equal(out, engine.predict(*batch), f"{path} predict_stream batch {i} vs predict")
    print(f"[{path}] predict at 8 equals the eager program bit for bit ({', '.join(want)}; preds its argmax); "
          f"predict_stream over {len(batches)} batches of {STREAM_SIZES} equals predict bit for bit")

    for b in engine.batch_sizes:
        iters = ENGINE_TIMING_ITERS[b]
        inputs = engine._graphs[b].inputs
        replay_ms = cuda_ms(lambda: engine._replay(b), iters)
        eager_ms = cuda_ms(lambda: eager(*inputs), iters)
        imu, clip = engine_request(420, b, cfg)
        split = np.zeros(4)
        for _ in range(iters):
            t = [time.perf_counter()]
            args = engine._pad_to(imu, clip, b)
            t.append(time.perf_counter())
            engine._upload(b, args)
            torch.cuda.synchronize()
            t.append(time.perf_counter())
            engine._replay(b)
            torch.cuda.synchronize()
            t.append(time.perf_counter())
            engine._readback(b)
            t.append(time.perf_counter())
            split += np.diff(t) * 1e3
        prep, upload, replay, readback = split / iters
        stream = [(imu, clip)] * STREAM_TIMED_BATCHES
        for _ in range(2):  # the first pass allocates the pinned buffers, which PyTorch then caches
            t0 = time.perf_counter()
            for _ in engine.predict_stream(stream):
                pass
            stream_ms = (time.perf_counter() - t0) / len(stream) * 1e3
        engine.profiler = StepProfiler()  # benchmark_engine's percentiles: its own calls only
        bench = benchmark_engine(engine, b, ENGINE_BENCH_ITERS[b])
        print(f"[{path}] batch {b}: graph replay {replay_ms:.3f} ms vs eager step {eager_ms:.3f} ms on "
              f"device-resident inputs ({eager_ms / replay_ms:.2f}x); predict split: host prep {prep:.3f} ms, "
              f"upload {upload:.3f} ms, replay {replay:.3f} ms, readback {readback:.3f} ms ({iters} calls); "
              f"predict_stream {stream_ms:.3f} ms a batch over {len(stream)} batches (depth 2) ({smi})")
        print(f"[{path}] batch {b}: benchmark_engine ({ENGINE_BENCH_ITERS[b]} iterations) "
              f"{json.dumps({k: round(v, 3) for k, v in bench.items()})}; latency_summary "
              f"{json.dumps({k: round(v, 3) for k, v in engine.latency_summary().items()})} ({smi})")


def cosine(a: torch.Tensor, b: torch.Tensor) -> float:
    return torch.nn.functional.cosine_similarity(a.flatten().double(), b.flatten().double(), dim=0).item()


def drive_counted(counters: dict, kernels: dict, path: str, run, expected: dict):
    """``run()`` with every launch count set to 0 just before and read just after; the
    counts go to ``kernels[name]["launches_by_path"][path]``; fail unless each kernel of
    ``expected`` launched as often. Returns ``(run's result, counts, seconds)``."""
    for counter in counters.values():
        counter.launches = 0
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = {name: counter.launches for name, counter in counters.items()}
    for name, n in counts.items():
        kernels[name].setdefault("launches_by_path", {})[path] = n
    wrong = {name: (counts[name], n) for name, n in expected.items() if counts[name] != n}
    if wrong:
        raise AssertionError(f"{path}: launches (counted, expected) {wrong}")
    return out, counts, seconds


def run_classification_stage(counters: dict, kernels: dict, smi: str) -> None:
    """Phase 17: the classification stage at full width. The IMU classifier's linear probe
    then finetune through ``ClassificationTrainer.fit``; the fusion classifier on
    ``videomae_base`` through ``fit`` (checkpoints written), its first step against the
    plain f32 path and its checkpoint served through ``InferenceEngine.from_checkpoint``;
    the video-only classifier's train steps. Every launch count is set to 0 just before
    each path and read just after it."""
    save_root = Path(__file__).resolve().parent / "tpuhar_torch" / "_build" / "chip_smoke_classify"
    shutil.rmtree(save_root, ignore_errors=True)
    gen = torch.Generator(device="cuda").manual_seed(0)

    # the IMU classifier of the flagship at batch 64: three probe steps, then three
    # finetune steps from the probe's weights
    cfg_imu = classify_config()
    cfg_imu.training.train_epochs = 1
    cfg_imu.paths = PathConfig(base_output=save_root)
    batch = cfg_imu.training.train_batch_size
    imu_train = classify_batches(cfg_imu, CLASSIFY_IMU_STEPS, batch, seed=600, video=False)
    imu_val = classify_batches(cfg_imu, 1, batch, seed=601, video=False)
    trained = None
    for mode in ("linear_probe", "finetune"):
        task = build_classification_task(cfg_imu, mode, device="cuda", params=trained, steps_per_epoch=CLASSIFY_IMU_STEPS)
        before = {n: p.detach().clone() for n, p in task.model.named_parameters()}
        trainer = ClassificationTrainer(cfg_imu, task.state, task.train_step, task.eval_step,
                                        save_root / f"imu_{mode}", gen, mode)
        _, counts, fit_s = drive_counted(counters, kernels, f"classify_imu_{mode}",
                                         lambda: trainer.fit(imu_train, imu_val), dict.fromkeys(counters, 0))
        history = trainer.history
        head_moved, head_still = moved(task.model, before, "classifier.")
        enc_moved, enc_still = moved(task.model, before, "imu_encoder.")
        print(f"[classify imu {mode}] fit: {CLASSIFY_IMU_STEPS} steps of batch {batch} and 1 validation batch in "
              f"{fit_s:.1f} s; train {history['train'][0]}, val loss {history['val'][0]['loss']:.6f}, balanced "
              f"accuracy {history['val'][0]['balanced_accuracy']:.2f}%; {len(head_moved)} of "
              f"{len(head_moved) + len(head_still)} head and {len(enc_moved)} of {len(enc_moved) + len(enc_still)} "
              f"encoder parameters moved; launches {counts}")
        losses = [history["train"][0]["loss"], history["val"][0]["loss"]]
        if not np.all(np.isfinite(losses)) or task.state.optimizer.count != CLASSIFY_IMU_STEPS:
            raise AssertionError(f"imu {mode}: losses {losses}, {task.state.optimizer.count} steps")
        if head_still:
            raise AssertionError(f"imu {mode}: head parameters did not move: {head_still}")
        if mode == "linear_probe" and enc_moved:
            raise AssertionError(f"imu probe: encoder parameters moved: {enc_moved}")
        if mode == "finetune" and not enc_moved:
            raise AssertionError("imu finetune: no encoder parameter moved")
        if mode == "linear_probe":
            print(f"[classify imu linear_probe] the encoder's {len(enc_still)} parameters are bit for bit as before")
        trained = variables_to_numpy(task.model)
        time_train_step(task, imu_train, gen, CLASSIFY_IMU_TIMED_STEPS, f"imu {mode}", smi)
        del task, trainer, before
    torch.cuda.empty_cache()

    # the fusion and video classifiers on videomae_base with the flash kernels, batch 16
    cfg_cls = pretrain_config()
    cfg_cls.training.train_epochs = 1
    cfg_cls.paths = PathConfig(base_output=save_root)
    depth = VIT_CONFIGS[cfg_cls.model.video_backbone][0]
    cls_train = classify_batches(cfg_cls, CLASSIFY_STEPS, CLASSIFY_BATCH, seed=700, video=True)
    cls_val = classify_batches(cfg_cls, 1, CLASSIFY_BATCH, seed=701, video=True)
    t0 = time.perf_counter()
    params_fusion = init_params(cfg_cls, torch.Generator().manual_seed(0), FusionClassifier)
    fusion = build_fusion_task(cfg_cls, device="cuda", params=params_fusion, steps_per_epoch=CLASSIFY_STEPS)
    print(f"[classify fusion] videomae_base fusion classifier built (weights drawn on the host, f32 masters on "
          f"the card): {time.perf_counter() - t0:.1f} s")
    before = {n: p.detach().clone() for n, p in fusion.model.named_parameters()}
    trainer = ClassificationTrainer(cfg_cls, fusion.state, fusion.train_step, fusion.eval_step,
                                    save_root / "fusion", gen, "finetune")
    no_other = dict.fromkeys(counters, 0)
    _, counts, fit_s = drive_counted(counters, kernels, "classify_fusion", lambda: trainer.fit(cls_train, cls_val), {
        **no_other, "flash_lean": depth * (CLASSIFY_STEPS + 1),  # each train and eval forward
        "flash_bwd_dkv": depth * CLASSIFY_STEPS, "flash_bwd_dq": depth * CLASSIFY_STEPS})
    history = trainer.history
    head_moved, head_still = moved(fusion.model, before, "classifier.")
    all_moved, all_still = moved(fusion.model, before)
    print(f"[classify fusion] fit: {CLASSIFY_STEPS} steps of batch {CLASSIFY_BATCH} and 1 validation batch in "
          f"{fit_s:.1f} s (first steps included); train {history['train'][0]}, val loss "
          f"{history['val'][0]['loss']:.6f}; {len(all_moved)} of {len(before)} parameters moved; launches {counts} "
          f"({depth} flash forwards with the LSE and {depth} of each backward kernel a step)")
    if not np.all(np.isfinite([history["train"][0]["loss"], history["val"][0]["loss"]])) or head_still:
        raise AssertionError(f"fusion: history {history}, head parameters still {head_still}")
    del before
    trained = variables_to_numpy(fusion.model)
    # the checkpoint served: an engine restored from 'last' against one of the variables
    t0 = time.perf_counter()
    served = InferenceEngine.from_checkpoint(cfg_cls, save_root / "fusion" / "last", device="cuda", batch_sizes=[8])
    build_s = time.perf_counter() - t0
    reference = InferenceEngine(cfg_cls, trained, device="cuda", batch_sizes=[8])
    imu_raw, clip = engine_request(800, 8, cfg_cls)
    got, want = served.predict(imu_raw, clip), reference.predict(imu_raw, clip)
    bitwise_equal(got, want, "fusion from_checkpoint predict at 8 vs an engine of the trained variables")
    if got["logits"].shape != (8, cfg_cls.model.num_classes) or not np.isfinite(got["logits"]).all():
        raise AssertionError(f"fusion from_checkpoint: logits {got['logits'].shape} not finite")
    print(f"[classify fusion] InferenceEngine.from_checkpoint('last') built in {build_s:.1f} s; predict at 8 equals "
          f"an engine of the trained variables bit for bit ({', '.join(want)})")
    del served, reference, trained
    torch.cuda.empty_cache()
    time_train_step(fusion, cls_train, gen, CLASSIFY_TIMED_STEPS, "fusion videomae_base", smi)
    del fusion, trainer
    torch.cuda.empty_cache()
    small = {key: t[:CLASSIFY_CHECK_BATCH] for key, t in cls_train[0].items() if key != "n_valid"}
    check_first_classifier_step(cfg_cls, params_fusion, small)
    del params_fusion, small
    torch.cuda.empty_cache()

    params_video = init_params(cfg_cls, torch.Generator().manual_seed(0), VideoClassifier)
    video = build_video_task(cfg_cls, device="cuda", params=params_video, steps_per_epoch=CLASSIFY_STEPS)
    before = {n: p.detach().clone() for n, p in video.model.named_parameters()}

    def video_steps():
        return [video.train_step(video.state, b, gen)[1]["loss"] for b in cls_train]

    losses, counts, steps_s = drive_counted(counters, kernels, "classify_video", video_steps, {
        **no_other, "flash_lean": depth * CLASSIFY_STEPS,
        "flash_bwd_dkv": depth * CLASSIFY_STEPS, "flash_bwd_dq": depth * CLASSIFY_STEPS})
    losses = torch.stack(losses).tolist()
    head_moved, head_still = moved(video.model, before, "classifier.")
    print(f"[classify video] {CLASSIFY_STEPS} train steps of batch {CLASSIFY_BATCH} in {steps_s:.1f} s (first "
          f"steps included): losses {losses}; launches {counts}")
    if not np.all(np.isfinite(losses)) or head_still:
        raise AssertionError(f"video: losses {losses}, head parameters still {head_still}")
    del before
    time_train_step(video, cls_train, gen, CLASSIFY_TIMED_STEPS, "video videomae_base", smi)
    del video, params_video, cls_train, cls_val
    torch.cuda.empty_cache()
    shutil.rmtree(save_root, ignore_errors=True)


@contextlib.contextmanager
def plain_fused_convs():
    """The towers' fused conv calls go to ``conv3x3_bn_act_reference`` inside the scope."""
    original = video_models.conv3x3_bn_act
    video_models.conv3x3_bn_act = conv3x3_bn_act_reference
    try:
        yield
    finally:
        video_models.conv3x3_bn_act = original


def check_graph_replay(path: str, engine, requests: list, counters: dict, kernels: dict, expected: dict) -> None:
    """Capture ``engine``'s graphs with the counts set to 0 (each graph must hold
    ``expected``); then each request's ``predict`` against the eager program on the same
    padded inputs, bit for bit."""
    _, counts, warm_s = drive_counted(counters, kernels, path, engine.warmup, {
        name: 2 * len(engine.batch_sizes) * expected.get(name, 0) for name in counters})  # an eager call and a capture
    for b, launches in engine.graph_launches.items():
        if {k: v for k, v in launches.items() if v} != {k: v for k, v in expected.items() if v}:
            raise AssertionError(f"{path} batch {b}: the graph holds {launches}, expected {expected}")
    for args in requests:
        got = engine.predict(*args)
        n, b = args[0].shape[0], engine._padded_size(args[0].shape[0])
        padded = [torch.from_numpy(a).cuda() for a in engine._pad_to(args[0], args[1] if len(args) > 1 else None, b)]
        want = {k: v.cpu().numpy()[:n] for k, v in engine._forward(*padded).items()}
        bitwise_equal(got, want, f"{path} predict at {args[0].shape[0]} (graph of {b}) vs the eager program")
        if not np.isfinite(got["logits"]).all():
            raise AssertionError(f"{path}: logits not finite")
    print(f"[{path}] {len(engine.batch_sizes)} graph(s) captured in {warm_s:.1f} s, launches a replay "
          f"{engine.graph_launches}; predict on {[a[0].shape[0] for a in requests]} rows equals the eager "
          f"program bit for bit")


def run_towers_stage(counters: dict, kernels: dict, smi: str, params_vit_pt) -> None:
    """Phase 18: the towers and IMU encoders that train and serve besides the ViT.
    ``tpu_cnn`` pretraining through ``fit`` and its trained tower served through the fused
    conv kernel; the fusion classifier with ResNet-18 and with MobileNetV2 trained and
    served from its checkpoint through CUDA graphs; ``videomae_base`` pretraining with
    ``remat_video`` against the same step without it; the IMU classifier's finetune with
    the 1-D CNN and with the STFT encoder, served IMU-only at 8 and 256."""
    save_root = Path(__file__).resolve().parent / "tpuhar_torch" / "_build" / "chip_smoke_towers"
    shutil.rmtree(save_root, ignore_errors=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    none = dict.fromkeys(counters, 0)

    # -- tpu_cnn pretraining: fit, the first step against f32, the fused eval --------
    cfg = pretrain_config()
    cfg.model.video_backbone = "tpu_cnn"
    cfg.training.pretrain_epochs = 1
    params = init_params(cfg, torch.Generator().manual_seed(0), CrossModalModel)
    task = build_pretrain_task(cfg, device="cuda", params=params, steps_per_epoch=TOWER_PRETRAIN_BATCHES)
    train = pretrain_batches(cfg, TOWER_PRETRAIN_BATCHES, TOWER_BATCH, seed=900)
    val = pretrain_batches(cfg, 1, TOWER_BATCH, seed=901)
    initial = {n: p.detach().clone() for n, p in task.model.named_parameters()}
    initial_stats = {n: b.detach().clone() for n, b in task.model.named_buffers()}
    trainer = CrossModalTrainer(cfg, task.state, task.train_step, task.eval_step, save_root / "tpu_cnn",
                                generator=gen)
    fused = TPU_CNN_FUSED_CONVS * len(val)  # the validation forward serves the tower through the kernel
    _, counts, fit_s = drive_counted(counters, kernels, "tower_tpu_cnn_pretrain", lambda: trainer.fit(train, val),
                                     {**none, "conv3x3_bn_act": fused})
    losses = trainer.history["train"] + trainer.history["val"]
    still = [n for n, p in task.model.named_parameters() if torch.equal(p, initial[n])]
    stats_still = [n for n, b in task.model.named_buffers() if torch.equal(b, initial_stats[n])]
    print(f"[tower tpu_cnn] pretraining fit: {TOWER_PRETRAIN_BATCHES} steps of batch {TOWER_BATCH} and "
          f"{len(val)} validation batch in {fit_s:.1f} s (first steps included): losses {losses}; "
          f"{len(initial) - len(still)} of {len(initial)} parameters and {len(initial_stats) - len(stats_still)} of "
          f"{len(initial_stats)} BatchNorm statistics moved; launches {counts}")
    if not np.all(np.isfinite(losses)) or still or stats_still:
        raise AssertionError(f"tpu_cnn pretraining: losses {losses}, still {still}, statistics still {stats_still}")
    del initial, initial_stats
    time_train_step(task, train, gen, TOWER_TIMED_STEPS, "tpu_cnn pretrain", smi)
    trained = variables_to_numpy(task.model)
    check_first_step(cfg, params, {k: t[:PRETRAIN_CHECK_BATCH] for k, t in train[0].items()}, "tpu_cnn check")

    # the trained tower at eval: both stage convs of each block through the fused kernel
    sub = {col: tree["video_encoder"] for col, tree in trained.items()}
    tower = load_variables(VideoEncoder("tpu_cnn", cfg.model.video_d_model, dtype=torch.bfloat16), sub).cuda().eval()
    clip = normalize_clip(val[0]["video"][:TOWER_EVAL_CLIPS])
    with torch.inference_mode():
        (emb, tokens), counts, _ = drive_counted(counters, kernels, "tower_tpu_cnn_eval", lambda: tower(clip),
                                                 {**none, "conv3x3_bn_act": TPU_CNN_FUSED_CONVS})
        with plain_fused_convs():
            emb_ref, tokens_ref = tower(clip)
    rel = ((tokens.float() - tokens_ref.float()).abs().max() / tokens_ref.float().abs().max()).item()
    print(f"[tower tpu_cnn] the trained tower's eval forward on {TOWER_EVAL_CLIPS} clips: "
          f"{counts['conv3x3_bn_act']} fused conv launches (BN folded from the moved running statistics); tokens "
          f"against conv3x3_bn_act_reference on the same variables: max diff {rel:.3e} of the largest")
    if not rel <= CONV_RTOL or not torch.isfinite(emb).all():
        raise AssertionError(f"trained tpu_cnn eval: {rel} > {CONV_RTOL}")
    del task, trainer, tower, train, val, trained, params
    torch.cuda.empty_cache()

    # -- the fusion classifier with ResNet-18 and MobileNetV2 ------------------------
    for backbone in ("resnet18", "mobilenet_v2"):
        cfg = pretrain_config()
        cfg.model.video_backbone = backbone
        cfg.training.train_epochs = 1
        cfg.paths = PathConfig(base_output=save_root)
        train = classify_batches(cfg, TOWER_CLASSIFY_STEPS, TOWER_BATCH, seed=910, video=True)
        val = classify_batches(cfg, 1, TOWER_BATCH, seed=911, video=True)
        params = init_params(cfg, torch.Generator().manual_seed(0), FusionClassifier)
        task = build_fusion_task(cfg, device="cuda", params=params, steps_per_epoch=TOWER_CLASSIFY_STEPS)
        before = {n: p.detach().clone() for n, p in task.model.named_parameters()}
        trainer = ClassificationTrainer(cfg, task.state, task.train_step, task.eval_step,
                                        save_root / backbone, gen, "finetune")
        _, counts, fit_s = drive_counted(counters, kernels, f"tower_{backbone}_fusion",
                                         lambda: trainer.fit(train, val), none)
        history = trainer.history
        all_moved, all_still = moved(task.model, before)
        print(f"[tower {backbone}] fusion classifier fit: {TOWER_CLASSIFY_STEPS} steps of batch {TOWER_BATCH} and "
              f"1 validation batch in {fit_s:.1f} s (first steps included); train {history['train'][0]}, val loss "
              f"{history['val'][0]['loss']:.6f}; {len(all_moved)} of {len(before)} parameters moved; launches {counts}")
        if not np.all(np.isfinite([history["train"][0]["loss"], history["val"][0]["loss"]])) or all_still:
            raise AssertionError(f"{backbone} fusion: history {history}, still {all_still}")
        del before
        time_train_step(task, train, gen, TOWER_TIMED_STEPS, f"fusion {backbone}", smi)
        del task, trainer
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        engine = InferenceEngine.from_checkpoint(cfg, save_root / backbone / "last", device="cuda",
                                                 batch_sizes=[TOWER_ENGINE_BATCH])
        print(f"[tower {backbone}] InferenceEngine.from_checkpoint('last') built in {time.perf_counter() - t0:.1f} s")
        requests = [engine_request(920, TOWER_ENGINE_BATCH, cfg), engine_request(921, 5, cfg)]
        check_graph_replay(f"engine_{backbone}", engine, requests, counters, kernels, {"fused_window": 1})
        inputs = engine._graphs[TOWER_ENGINE_BATCH].inputs
        torch.cuda.reset_peak_memory_stats()
        replay_ms = cuda_ms(lambda: engine._replay(TOWER_ENGINE_BATCH), 20)
        eager_ms = cuda_ms(lambda: engine._forward(*inputs), 20)
        print(f"[timing] engine_{backbone} batch {TOWER_ENGINE_BATCH}: graph replay {replay_ms:.3f} ms, eager "
              f"{eager_ms:.3f} ms, {TOWER_ENGINE_BATCH / replay_ms * 1e3:.1f} inf/s, peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({smi})")
        del engine, params, train, val
        torch.cuda.empty_cache()

    # -- videomae_base pretraining with remat_video against the same step without ----
    cfg_pt = pretrain_config()
    depth = VIT_CONFIGS[cfg_pt.model.video_backbone][0]
    batch = pretrain_batches(cfg_pt, 1, REMAT_BATCH, seed=930)[0]
    steps = {}
    for remat in (False, True):
        cfg = copy.deepcopy(cfg_pt)
        cfg.model.remat_video = remat
        task = build_pretrain_task(cfg, device="cuda", params=params_vit_pt, steps_per_epoch=1)

        def step():
            with precision_scope(cfg.training.pretrain_matmul_precision):
                out = task.model.forward_cast(batch["imu"], normalize_clip(batch["video"]), train=True,
                                              generator=torch.Generator(device="cuda").manual_seed(5))
                loss = contrastive_loss_fn(cfg)(out)
                loss.backward()
            return loss.detach()

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        path = "remat_videomae_base" if remat else "no_remat_videomae_base"
        loss, counts, step_s = drive_counted(counters, kernels, path, step, {
            **none, "flash_lean": depth * (2 if remat else 1), "flash_bwd_dkv": depth, "flash_bwd_dq": depth})
        peak = torch.cuda.max_memory_allocated()
        grads = {n: p.grad.detach().clone() for n, p in task.model.named_parameters() if p.grad is not None}
        steps[remat] = (loss, grads)
        print(f"[remat] videomae_base pretraining step, remat_video={remat}, batch {REMAT_BATCH}: loss "
              f"{loss.item():.6f} in {step_s * 1e3:.1f} ms (first step); launches {counts}; peak memory "
              f"{peak / 2**30:.2f} GiB, {(peak - held) / 2**30:.2f} GiB above the {held / 2**30:.2f} GiB held before "
              f"the step ({smi})")
        time_train_step(task, [batch], gen, TOWER_TIMED_STEPS, f"pretrain videomae_base remat_video={remat}", smi)
        del task
        torch.cuda.empty_cache()
    (loss, grads), (loss_r, grads_r) = steps[False], steps[True]
    if grads.keys() != grads_r.keys():
        raise AssertionError("remat: the two steps' gradients have different leaves")
    differ = [n for n in grads if not torch.equal(grads[n], grads_r[n])]
    worst = max(((((grads[n] - grads_r[n]).abs().max() / grads[n].abs().max()).item(), n) for n in differ),
                default=(0.0, ""))
    same_loss = "equal bit for bit" if torch.equal(loss, loss_r) else f"differs by {abs(loss - loss_r).item():.3e}"
    print(f"[remat] with remat_video against without: loss {same_loss}; {len(grads) - len(differ)} of {len(grads)} "
          f"gradient leaves equal bit for bit"
          + (f", the largest difference {worst[0]:.3e} of its leaf's largest element ({worst[1]})" if differ else ""))
    if abs((loss - loss_r) / loss).item() > REMAT_RTOL or worst[0] > REMAT_RTOL:
        raise AssertionError(f"remat step differs: loss {loss.item()} vs {loss_r.item()}, gradients {worst}")
    del steps, grads, grads_r, batch
    torch.cuda.empty_cache()

    # -- the IMU classifier's finetune with the 1-D CNN and the STFT encoder ---------
    for encoder in ("cnn", "stft"):
        cfg = classify_config()
        if encoder == "cnn":
            cfg.model.imu_encoder = "cnn"
        else:
            cfg.data.imu_featurizer = "stft"
        cfg.training.train_epochs = 1
        cfg.paths = PathConfig(base_output=save_root)
        batch = cfg.training.train_batch_size
        train = classify_batches(cfg, CLASSIFY_IMU_STEPS, batch, seed=940, video=False)
        val = classify_batches(cfg, 1, batch, seed=941, video=False)
        task = build_classification_task(cfg, "finetune", device="cuda", steps_per_epoch=CLASSIFY_IMU_STEPS)
        before = {n: p.detach().clone() for n, p in task.model.named_parameters()}
        trainer = ClassificationTrainer(cfg, task.state, task.train_step, task.eval_step,
                                        save_root / f"imu_{encoder}", gen, "finetune")
        _, counts, fit_s = drive_counted(counters, kernels, f"imu_{encoder}_finetune",
                                         lambda: trainer.fit(train, val), none)
        history = trainer.history
        all_moved, all_still = moved(task.model, before)
        print(f"[imu {encoder}] finetune fit: {CLASSIFY_IMU_STEPS} steps of batch {batch} and 1 validation batch in "
              f"{fit_s:.1f} s; train {history['train'][0]}, val loss {history['val'][0]['loss']:.6f}; "
              f"{len(all_moved)} of {len(before)} parameters moved; launches {counts}")
        if not np.all(np.isfinite([history["train"][0]["loss"], history["val"][0]["loss"]])) or all_still:
            raise AssertionError(f"imu {encoder}: history {history}, still {all_still}")
        time_train_step(task, train, gen, CLASSIFY_IMU_TIMED_STEPS, f"imu {encoder} finetune", smi)
        engine = InferenceEngine(cfg, variables_to_numpy(task.model), imu_only=True, batch_sizes=IMU_ENGINE_SIZES,
                                 device="cuda")
        rng = np.random.default_rng(950)
        requests = [(rng.normal(0, 8000.0, (n, cfg.data.imu_window_size, cfg.data.imu_channels)).astype(np.float32),)
                    for n in (8, 3, 256, 100)]
        check_graph_replay(f"engine_imu_{encoder}", engine, requests, counters, kernels, {"fused_window": 1})
        for b in IMU_ENGINE_SIZES:
            replay_ms = cuda_ms(lambda: engine._replay(b), 20)
            print(f"[timing] engine_imu_{encoder} batch {b}: graph replay {replay_ms:.3f} ms, "
                  f"{b / replay_ms * 1e3:.1f} inf/s ({smi})")
        del task, trainer, engine, before
        torch.cuda.empty_cache()
    shutil.rmtree(save_root, ignore_errors=True)


@contextlib.contextmanager
def plain_int8_kernels():
    """The int8 towers' kernel calls go to the kernels' plain versions inside the scope."""
    swaps = [(quant_module, "int8_gemm", int8_gemm_reference), (quant_module, "conv3x3_i8", conv3x3_i8_reference),
             (quant_module, "stem_gemm_u8", stem_gemm_u8_reference), (quant_vit_module, "int8_gemm", int8_gemm_reference),
             (quant_vit_module, "stem_gemm_u8", stem_gemm_u8_reference)]
    saved = [(module, name, getattr(module, name)) for module, name, _ in swaps]
    try:
        for module, name, plain in swaps:
            setattr(module, name, plain)
        yield
    finally:
        for module, name, original in saved:
            setattr(module, name, original)


def equal_to_plain_kernels(what: str, run) -> None:
    """Fail unless ``run()`` gives, bit for bit, what it gives with the int8 kernels'
    plain versions in their place (every other op the same, on the same device)."""
    got = run()
    with plain_int8_kernels():
        want = run()
    pairs = got.items() if isinstance(got, dict) else [("out", got)]
    want = want if isinstance(want, dict) else {"out": want}
    for key, value in pairs:
        if not torch.equal(value, want[key]):
            diff = (value.double() - want[key].double()).abs().max().item()
            raise AssertionError(f"{what}: {key} differs from the plain-kernel program by up to {diff:.3e}")
    print(f"[{what}] equals the same program with int8_gemm, stem_gemm_u8 and conv3x3_i8 replaced by their plain "
          f"versions, bit for bit ({', '.join(k for k, _ in pairs)})")


def time_engine(path: str, engine, smi: str) -> dict:
    """Replay ms and inf/s of each registered size on the graph's inputs, and the peak
    memory of one eager forward there above what was allocated before it (a replay
    allocates nothing: its buffers lie in the graphs' pool)."""
    out = {}
    for b in engine.batch_sizes:
        ms = cuda_ms(lambda: engine._replay(b), ENGINE_TIMING_ITERS[b])
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        engine._forward(*engine._graphs[b].inputs)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - held
        out[b] = ms
        print(f"[timing] {path} batch {b}: graph replay {ms:.3f} ms, {b / ms * 1e3:.1f} inf/s; an eager forward's "
              f"peak memory {peak / 2**30:.2f} GiB above the {held / 2**30:.2f} GiB held ({smi})")
    return out


def run_int8_towers_stage(counters: dict, kernels: dict, smi: str, cfg_vit, params_vit) -> None:
    """Phase 19: the int8 towers at full width. The int8 ``videomae_base`` ViT
    (``cfg_vit``, ``params_vit``: phase 8's) served by ``InferenceEngine`` at 8 and 64,
    its tower bit for bit against the plain-kernel program at both and correlated with
    the f32 mirror; the int8 ResNet-18 (``pretrain_config`` with ``resnet18``, random
    weights), baseline and resident engines at 8."""
    none = dict.fromkeys(counters, 0)
    H, W = cfg_vit.data.video_resize
    calib = (np.random.default_rng(0).random((2, cfg_vit.data.video_frames_per_window, H, W, 3)) * 255).astype(np.uint8)
    depth = VIT_CONFIGS[cfg_vit.model.video_backbone][0]

    # -- the int8 videomae_base ViT ----------------------------------------------------
    t0 = time.perf_counter()
    engine = InferenceEngine(cfg_vit, params_vit, quantize_calib_clips=calib, batch_sizes=INT8_VIT_SIZES, device="cuda")
    build = engine.quantized_forward.build_seconds
    print(f"[int8 vit] engine built in {time.perf_counter() - t0:.1f} s: calibration and quantization on the CPU "
          f"{build['calibration']:.1f} s, logit recalibration on the card {build['recalibration']:.1f} s")
    q = engine.quantized_forward.quantized_tree
    gen = torch.Generator(device="cuda").manual_seed(19)
    vit_launches = {**none, "stem_gemm_u8": 1, "int8_gemm": 4 * depth}
    for b in INT8_VIT_SIZES:
        clip = torch.randint(0, 256, (b, 16, H, W, 3), generator=gen, device="cuda", dtype=torch.uint8)
        tokens, counts, secs = drive_counted(counters, kernels, f"int8_vit_tower_{b}", lambda: quant_vit_forward(q, clip),
                                             vit_launches)
        print(f"[int8 vit] eager tower at batch {b}: tokens {tuple(tokens.shape)} in {secs * 1e3:.1f} ms (first call); "
              f"launches {counts}")
        if not torch.isfinite(tokens).all():
            raise AssertionError(f"int8 vit tokens at {b} are not finite")
        equal_to_plain_kernels(f"int8 vit tower batch {b}", lambda: quant_vit_forward(q, clip))
        if b == INT8_VIT_SIZES[0]:
            ref = vit_forward_f32(params_vit["params"]["video_encoder"]["vit"], normalize_clip(clip))
            corr = np.corrcoef(tokens.double().flatten().cpu().numpy(), ref.double().flatten().cpu().numpy())[0, 1]
            rel = ((tokens - ref).abs().mean() / ref.abs().mean()).item()
            print(f"[int8 vit] tokens against vit_forward_f32 on the card at batch {b}: correlation {corr:.6f}, mean "
                  f"drift {rel:.4f} (random weights, no floor at full width)")
            del ref
        del tokens, clip
    torch.cuda.empty_cache()
    expected = {"fused_window": 1, "stem_gemm_u8": 1, "int8_gemm": 4 * depth}
    requests = [engine_request(1900, 8, cfg_vit), engine_request(1901, 5, cfg_vit), engine_request(1902, 64, cfg_vit)]
    check_graph_replay("engine_int8_vit", engine, requests, counters, kernels, expected)
    args = [torch.from_numpy(a).cuda() for a in engine._pad_to(*requests[0], 8)]
    equal_to_plain_kernels("engine_int8_vit eager program at 8", lambda: engine._forward(*args))
    time_engine("engine_int8_vit", engine, smi)
    del engine, q, args, requests
    torch.cuda.empty_cache()

    # -- the int8 ResNet-18, baseline and resident --------------------------------------
    cfg = pretrain_config()
    cfg.model.video_backbone = "resnet18"
    params = init_params(cfg, torch.Generator().manual_seed(0), FusionClassifier)
    requests = [engine_request(1910, 8, cfg), engine_request(1911, 5, cfg)]
    logits = {}
    for resident in (False, True):
        path = f"engine_int8_resnet18{'_resident' if resident else ''}"
        t0 = time.perf_counter()
        engine = InferenceEngine(cfg, params, quantize_calib_clips=calib, quantize_resident=resident,
                                 batch_sizes=INT8_RESNET_SIZES, device="cuda")
        build = engine.quantized_forward.build_seconds
        print(f"[{path}] built in {time.perf_counter() - t0:.1f} s: calibration {build['calibration']:.1f} s, "
              f"recalibration {build['recalibration']:.1f} s")
        check_graph_replay(path, engine, requests, counters, kernels,
                           {"fused_window": 1, "int8_gemm": 4, "conv3x3_i8": 16})
        args = [torch.from_numpy(a).cuda() for a in engine._pad_to(*requests[0], 8)]
        equal_to_plain_kernels(f"{path} eager program at 8", lambda: engine._forward(*args))
        time_engine(path, engine, smi)
        logits[resident] = engine.predict(*requests[0])["logits"].astype(np.float64)
        del engine, args
        torch.cuda.empty_cache()
    base, res = logits[False], logits[True]
    spread = np.sqrt(np.mean((base - base.mean()) ** 2))
    drift = np.sqrt(np.mean((res - base) ** 2)) / max(spread, 1e-12)
    corr = np.corrcoef(res.ravel(), base.ravel())[0, 1]
    print(f"[int8 resnet18] resident against baseline logits at 8: relative RMS drift {drift:.4f}, correlation "
          f"{corr:.6f}, max abs diff {np.abs(res - base).max():.4e}")
    if not np.isfinite(res).all() or not corr > 0.99:
        raise AssertionError(f"int8 resnet18: resident logits drift from the baseline's: correlation {corr}")


@contextlib.contextmanager
def plain_attention():
    """The ViT's flash attention calls go to ``flash_lean_reference`` inside the scope."""
    original = attention_module.flash_lean
    attention_module.flash_lean = flash_lean_reference
    try:
        yield
    finally:
        attention_module.flash_lean = original


def tree_equal(got: dict, want: dict, what: str) -> int:
    """Fail unless two nested dicts of arrays have the same leaves, bit for bit; returns
    the number of leaves."""
    flat = lambda t, p="": ([(f"{p}/{k}", v) for k, v in t.items() if not isinstance(v, dict)]  # noqa: E731
                            + [x for k, v in t.items() if isinstance(v, dict) for x in flat(v, f"{p}/{k}")])
    a, b = dict(flat(got)), dict(flat(want))
    if a.keys() != b.keys():
        raise AssertionError(f"{what}: leaves differ: {sorted(a.keys() ^ b.keys())[:5]}")
    bad = [k for k in a if not np.array_equal(np.asarray(a[k]), np.asarray(b[k]))]
    if bad:
        raise AssertionError(f"{what}: {len(bad)} leaves differ, first {bad[:3]}")
    return len(a)


def eval_windows(per_class: int, seed: int):
    """IMU windows of ``EVAL_CLASSES`` classes, ``per_class`` each: unit noise plus a fixed
    pattern of their class at ``EVAL_PATTERN`` times its scale (learnable within the cut
    epochs, so that the runs' predictions spread over the classes), and their labels."""
    patterns = np.random.default_rng(2024).standard_normal((EVAL_CLASSES, 6, 250)).astype(np.float32)
    labels = np.repeat(np.arange(EVAL_CLASSES), per_class).astype(np.int32)
    windows = np.random.default_rng(seed).standard_normal((len(labels), 6, 250)).astype(np.float32)
    return windows + EVAL_PATTERN * patterns[labels], labels


def window_batches(windows: np.ndarray, labels: np.ndarray, batch: int, *, clips: bool = False, seed: int = 0) -> list:
    """Zero-padded batches on the card (``imu``, ``label``, ``n_valid``; with ``clips`` a
    seeded uint8 clip of ``CLIP_SHAPE`` a row)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    out = []
    for start in range(0, len(labels), batch):
        n = min(batch, len(labels) - start)
        imu, lab = np.zeros((batch, 6, 250), np.float32), np.zeros((batch,), np.int64)
        imu[:n], lab[:n] = windows[start:start + n], labels[start:start + n]
        b = {"imu": torch.from_numpy(imu).cuda(), "label": torch.from_numpy(lab).cuda(), "n_valid": n}
        if clips:
            b["video"] = torch.randint(0, 256, (batch, *CLIP_SHAPE, 3), generator=gen, device="cuda", dtype=torch.uint8)
        out.append(b)
    return out


def sample_runs(labels: np.ndarray, k: int, runs: int):
    """Each run's k rows of each class (seeded ``run + 42``) and their labels, ``(R, n)``:
    the few-shot core's input where no DataFrame is at hand."""
    idx = np.stack([np.concatenate([np.random.default_rng(run + 42).choice(np.flatnonzero(labels == c), k, replace=False)
                                    for c in range(EVAL_CLASSES)]) for run in range(runs)])
    return idx, labels[idx]


def check_weights_io(counters: dict, kernels: dict, params_vit, save_root: Path) -> None:
    """Phase 20, weights I/O: phase 8's ``videomae_base`` ViT exported to the HF layout,
    saved as ``.pt``, loaded and converted back bit for bit; the fusion classifier built
    with ``model.video_weights_path`` against the same model loaded from the tree: the
    grafted leaves and the eval forward (12 flash launches) bit for bit; the ResNet-18
    and MobileNetV2 round trips."""
    cfg = vit_config()
    depth, _, heads = VIT_CONFIGS[cfg.model.video_backbone]
    vit = params_vit["params"]["video_encoder"]["vit"]
    path = save_root / "videomae_base.pt"
    t0 = time.perf_counter()
    convert.save_state_dict(convert.export_videomae_state_dict(vit, depth, heads), path)
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded = convert.load_state_dict(path)
    load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    converted = convert.convert_video_backbone(loaded, cfg)
    convert_s = time.perf_counter() - t0
    n = tree_equal(converted, vit, "videomae_base export → .pt → load → convert")
    print(f"[weights] videomae_base: export and save {export_s:.2f} s ({path.stat().st_size / 2**20:.0f} MiB, "
          f"{len(loaded)} tensors), load_state_dict {load_s:.2f} s, convert_video_backbone {convert_s:.2f} s; "
          f"{n} leaves bit for bit")

    base = init_params(cfg, torch.Generator().manual_seed(1), FusionClassifier)
    direct_tree = {**base, "params": {**base["params"], "video_encoder": {**base["params"]["video_encoder"], "vit": vit}}}
    graft_cfg = copy.deepcopy(cfg)
    graft_cfg.model.video_pretrained, graft_cfg.model.video_weights_path = True, str(path)
    t0 = time.perf_counter()
    grafted = build_fusion_task(graft_cfg, device="cuda", params=base, steps_per_epoch=1)
    graft_s = time.perf_counter() - t0
    tree_equal(variables_to_numpy(grafted.model)["params"]["video_encoder"]["vit"], vit, "grafted ViT")
    direct = build_fusion_task(cfg, device="cuda", params=direct_tree, steps_per_epoch=1)
    w, lab = eval_windows(1, 2000)
    batch = window_batches(w[:GRAFT_BATCH], lab[:GRAFT_BATCH], GRAFT_BATCH, clips=True, seed=2000)[0]
    got, counts, fwd_s = drive_counted(counters, kernels, "evaluate_graft", lambda: grafted.eval_step(grafted.state, batch),
                                       {**dict.fromkeys(counters, 0), "flash_lean": depth})
    want = direct.eval_step(direct.state, batch)
    for key in ("logits", "embeddings", "preds"):
        if not torch.equal(got[key], want[key]):
            raise AssertionError(f"grafted videomae_base: {key} differs from the directly loaded model")
    print(f"[weights] build_fusion_task with video_weights_path (load, convert, graft, f32 masters on the card) "
          f"{graft_s:.1f} s; the grafted ViT's leaves and its eval forward at batch {GRAFT_BATCH} equal the model "
          f"loaded from the tree bit for bit (logits, embeddings, preds); launches {counts}")
    del grafted, direct, base, direct_tree, converted, loaded
    torch.cuda.empty_cache()

    for backbone in ("resnet18", "mobilenet_v2"):
        cfg_cnn = pretrain_config()
        cfg_cnn.model.video_backbone = backbone
        tree = init_params(cfg_cnn, torch.Generator().manual_seed(2), CrossModalModel)
        encoder = {"params": tree["params"]["video_encoder"], "batch_stats": tree["batch_stats"]["video_encoder"]}
        cnn_path = save_root / f"{backbone}.pth"
        t0 = time.perf_counter()
        convert.save_state_dict(convert.export_video_backbone(encoder, cfg_cnn), cnn_path)
        params, stats = convert.convert_video_backbone(convert.load_state_dict(cnn_path), cfg_cnn)
        n = tree_equal(params, encoder["params"]["backbone"], backbone) + tree_equal(
            stats, encoder["batch_stats"]["backbone"], f"{backbone} statistics")
        print(f"[weights] {backbone}: export, save, load and convert {time.perf_counter() - t0:.2f} s; {n} leaves "
              f"bit for bit")


def run_zero_shot_check(counters: dict, kernels: dict, smi: str, params_pt) -> object:
    """Phase 20, zero-shot: ``pretrain_config()``'s ``videomae_base`` ``CrossModalModel``
    (phase 13's weights) makes the prototypes of 32 classes from 2 clips each at batch 16
    (12 flash launches a batch), each held by cosine to the same computation with the
    plain attention; then nearest-prototype classification of IMU windows. Returns the
    task, for the DataFrame entries."""
    cfg = pretrain_config()
    depth = VIT_CONFIGS[cfg.model.video_backbone][0]
    task = build_pretrain_task(cfg, device="cuda", params=params_pt, steps_per_epoch=1)
    labels = np.random.default_rng(3000).permutation(np.repeat(np.arange(EVAL_CLASSES), ZEROSHOT_CLIPS_PER_CLASS))
    clips = window_batches(np.zeros((len(labels), 6, 250), np.float32), labels, ZEROSHOT_BATCH, clips=True, seed=3000)
    imu = window_batches(*eval_windows(4, 3001), cfg.training.train_batch_size)

    def run():
        t0 = time.perf_counter()
        protos = class_prototypes(task, clips, cfg)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        metrics = zero_shot_metrics(task, protos, imu, cfg)
        return protos, metrics, t1 - t0, time.perf_counter() - t1

    (protos, metrics, proto_s, imu_s), counts, _ = drive_counted(
        counters, kernels, "evaluate_zeroshot", run, {**dict.fromkeys(counters, 0), "flash_lean": depth * len(clips)})
    with plain_attention():
        plain = class_prototypes(task, clips, cfg)
    cos = (protos.double() * plain.double()).sum(dim=1) / (protos.double().norm(dim=1) * plain.double().norm(dim=1))
    print(f"[zeroshot] prototypes of {EVAL_CLASSES} classes from {len(labels)} clips at batch {ZEROSHOT_BATCH}: "
          f"{proto_s:.2f} s; {imu[0]['imu'].shape[0] * len(imu)} IMU windows classified in {imu_s:.2f} s; balanced "
          f"accuracy {metrics['balanced_accuracy']:.2f}% (random weights); launches {counts}; per-class cosine to the "
          f"plain attention's prototypes: min {cos.min().item():.6f}, mean {cos.mean().item():.6f} ({smi})")
    if not (torch.isfinite(protos).all() and cos.min().item() >= ZEROSHOT_COSINE_MIN):
        raise AssertionError(f"zero-shot prototypes: cosine to the plain attention's {cos.min().item()}")
    return task


def run_loo_check(counters: dict, kernels: dict, smi: str, save_root: Path) -> None:
    """Phase 20, leave-one-out: two held-out classes with ``pretrain_config()``'s
    ``videomae_base`` fusion classifier through ``OODEvaluator.held_out_rows``: one epoch
    of two batches of 16 (12/12/12 flash launches a step), a validation batch, then the
    ID-test, OOD and ID-train evaluations and the five scores' rows; then one train
    step's device profile (busy share)."""
    cfg = pretrain_config()
    cfg.training.train_epochs = 1
    cfg.paths = PathConfig(base_output=save_root)
    cfg.ood.scores = list(KNOWN_SCORES)
    depth = VIT_CONFIGS[cfg.model.video_backbone][0]
    ev = OODEvaluator(cfg, device="cuda")
    for i, c in enumerate(LOO_CLASSES):
        loo = copy.deepcopy(cfg)
        loo.model.num_classes = EVAL_CLASSES - 1
        w, lab = eval_windows(3, 4000 + i)
        keep = lab != c
        remap = np.cumsum(np.arange(EVAL_CLASSES) != c) - 1  # the ID classes renumbered 0..30
        order = np.random.default_rng(4000 + i).permutation(int(keep.sum()))
        w_id, lab_id = w[keep][order], remap[lab[keep]][order].astype(np.int32)
        n = LOO_STEPS * LOO_BATCH
        train = window_batches(w_id[:n], lab_id[:n], LOO_BATCH, clips=True, seed=4100 + i)
        val = window_batches(w_id[n:n + LOO_BATCH], lab_id[n:n + LOO_BATCH], LOO_BATCH, clips=True, seed=4200 + i)
        id_test = window_batches(w_id[n + LOO_BATCH:n + 2 * LOO_BATCH], lab_id[n + LOO_BATCH:n + 2 * LOO_BATCH],
                                 LOO_BATCH, clips=True, seed=4300 + i)
        ood = window_batches(w[~keep], lab[~keep], LOO_BATCH, clips=True, seed=4400 + i)  # labels c, unmapped
        evals = len(val) + len(id_test) + len(ood) + len(train)
        rows, counts, class_s = drive_counted(
            counters, kernels, f"evaluate_loo_fusion_{c}",
            lambda: ev.held_out_rows(c, loo, "fusion", len(train), train, val, id_test, ood, train, verbose=False),
            {**dict.fromkeys(counters, 0), "flash_lean": depth * (len(train) + evals),
             "flash_bwd_dkv": depth * len(train), "flash_bwd_dq": depth * len(train)})
        print(f"[loo fusion] held-out class {c}: build, {len(train)} steps of batch {LOO_BATCH}, validation and "
              f"{len(id_test) + len(ood) + len(train)} evaluation batches in {class_s:.1f} s; launches {counts}; "
              + ", ".join(f"{r['score']} AUROC {r['auroc']:.3f} FPR95 {r['fpr_at_95tpr']:.3f}" for r in rows)
              + f" (random weights; {smi})")
        if [r["score"] for r in rows] != list(KNOWN_SCORES) or not all(0.0 <= r["auroc"] <= 1.0 for r in rows):
            raise AssertionError(f"loo class {c}: rows {rows}")
    # the LOO fusion step's device time and busy share
    task = build_fusion_task(loo, device="cuda", params=init_params(loo, torch.Generator().manual_seed(5), FusionClassifier),
                             steps_per_epoch=LOO_STEPS)
    dropout = torch.Generator(device="cuda").manual_seed(0)
    step = lambda b: task.train_step(task.state, b, dropout)  # noqa: E731
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(LOO_TIMED_STEPS):
        step(train[0])
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / LOO_TIMED_STEPS * 1e3
    prof = device_profile(step, (train[0],), LOO_PROFILED_STEPS)
    print(f"[timing] loo fusion videomae_base train step batch {LOO_BATCH}: {step_ms:.3f} ms "
          f"({LOO_BATCH / step_ms * 1e3:.1f} samples/s); device {prof['device_ms']:.3f} ms a step in "
          f"{prof['ops']:.0f} ops, busy {100 * prof['busy']:.1f}% ({LOO_PROFILED_STEPS} profiled steps; {smi})")
    del task
    torch.cuda.empty_cache()


def run_fewshot_check(counters: dict, kernels: dict, smi: str) -> None:
    """Phase 20, the parallel few-shot harness at ``classify_config()``'s IMU classifier:
    32 classes, R = 5 runs, k = 10, both modes, cut to 2 epochs, through ``fewshot_rows``
    (no hand kernel runs: the IMU classifier's layers are PyTorch's); then each cell's
    batched runs against the five runs trained one after the other through the same code
    (dropout off), per run, with both times."""
    cfg = classify_config()
    cfg.training.train_epochs = FEWSHOT_EPOCHS
    cfg.eval.few_shot_samples, cfg.eval.few_shot_runs = [FEWSHOT_K], FEWSHOT_RUNS
    train_w, train_l = eval_windows(FEWSHOT_WINDOWS["train"], 5000)
    fit_w, fit_l = eval_windows(FEWSHOT_WINDOWS["val"], 5001)
    test_w, test_l = eval_windows(FEWSHOT_WINDOWS["test"], 5002)
    idx, lab = sample_runs(train_l, FEWSHOT_K, FEWSHOT_RUNS)
    data = (train_w, {FEWSHOT_K: (idx, lab)}, fit_w, fit_l, test_w, test_l)
    rows, counts, grid_s = drive_counted(
        counters, kernels, "evaluate_fewshot",
        lambda: fewshot_rows(cfg, None, *data, device="cuda", generator=torch.Generator().manual_seed(0),
                             log=lambda line: print(f"[fewshot] {line}")),
        dict.fromkeys(counters, 0))
    print(f"[fewshot] the grid (k={FEWSHOT_K}, R={FEWSHOT_RUNS}, {len(cfg.eval.eval_modes)} modes, {FEWSHOT_EPOCHS} "
          f"epochs of {idx.shape[1] // 32} steps of batch 32) in {grid_s:.1f} s, {len(rows)} rows; no hand kernel "
          f"launched ({counts})")
    if len(rows) != FEWSHOT_RUNS * len(cfg.eval.eval_modes):
        raise AssertionError(f"few-shot rows: {len(rows)}")
    cfg0 = copy.deepcopy(cfg)
    cfg0.model.imu_dropout = cfg0.model.classifier_dropout = 0.0
    for mode in cfg.eval.eval_modes:
        trees = init_run_trees(cfg0, mode, None, FEWSHOT_RUNS, torch.Generator().manual_seed(1))
        evals = (fit_w, fit_l, test_w, test_l)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        together = fewshot_cell(cfg0, mode, trees, train_w, idx, lab, *evals, device="cuda",
                                generator=torch.Generator(device="cuda"))
        batched_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        alone = [fewshot_cell(cfg0, mode, trees[r:r + 1], train_w, idx[r:r + 1], lab[r:r + 1], *evals, device="cuda",
                              generator=torch.Generator(device="cuda"), run_ids=[r])[0] for r in range(FEWSHOT_RUNS)]
        sequential_s = time.perf_counter() - t0
        bal = [(metrics_from_confusion(together[r])["balanced_accuracy"], metrics_from_confusion(alone[r])["balanced_accuracy"])
               for r in range(FEWSHOT_RUNS)]
        moved = [int(np.abs(together[r] - alone[r]).sum()) // 2 for r in range(FEWSHOT_RUNS)]
        worst = max(abs(a - b) for a, b in bal)
        print(f"[fewshot {mode}] batched {FEWSHOT_RUNS} runs {batched_s:.2f} s, the same runs one after the other "
              f"{sequential_s:.2f} s ({sequential_s / batched_s:.2f}x); balanced accuracy per run (batched, alone): "
              + ", ".join(f"({a:.2f}, {b:.2f})" for a, b in bal)
              + f"; test windows predicted otherwise per run {moved} of {len(test_l)}; largest difference {worst:.2f} "
              f"points (bound {FEWSHOT_ROW_ATOL}; {smi})")
        if not worst <= FEWSHOT_ROW_ATOL:
            raise AssertionError(f"few-shot {mode}: batched runs differ from the runs alone by {worst} points")


def run_evaluator_check(counters: dict, kernels: dict, smi: str, save_root: Path) -> None:
    """Phase 20, ``Evaluator.evaluate`` and calibration on ``classify_config()``'s IMU
    classifier finetuned (``train_classifier``, one epoch of batch 64): the test
    batches' metrics and ECE, the temperature fitted on the validation batches and the
    ECE after it."""
    cfg = classify_config()
    cfg.training.train_epochs = 1
    cfg.paths = PathConfig(base_output=save_root)
    batch = cfg.training.train_batch_size
    train = window_batches(*eval_windows(FEWSHOT_WINDOWS["train"], 6000), batch)
    val = window_batches(*eval_windows(FEWSHOT_WINDOWS["val"], 6001), batch)
    test = window_batches(*eval_windows(FEWSHOT_WINDOWS["test"], 6002), batch)
    task, _ = train_classifier(cfg, "finetune", len(train), train, val, save_root / "evaluate",
                               generator=torch.Generator().manual_seed(0), device="cuda")
    evaluator = Evaluator(task, cfg)
    out, counts, eval_s = drive_counted(counters, kernels, "evaluate_imu", lambda: evaluator.evaluate(test),
                                        dict.fromkeys(counters, 0))
    _, val_labels, val_logits, _ = evaluator.predict(val)
    t0 = time.perf_counter()
    temperature = fit_temperature(torch.from_numpy(val_logits).cuda(), torch.from_numpy(val_labels).cuda())
    fit_s = time.perf_counter() - t0
    after = expected_calibration_error(apply_temperature(torch.from_numpy(out["logits"]).cuda(), temperature),
                                       out["labels"])
    m, cal = out["metrics"], out["calibration"]
    print(f"[evaluate] finetuned IMU classifier ({len(train)} steps of batch {batch}) on {len(out['labels'])} test "
          f"windows in {eval_s:.2f} s: accuracy {m['accuracy']:.2f}%, balanced {m['balanced_accuracy']:.2f}%, macro "
          f"F1 {m['f1_macro']:.2f}%; ECE {cal['ece']:.4f} (MCE {cal['mce']:.4f}); temperature {temperature:.4f} fitted on "
          f"{len(val_labels)} validation windows in {fit_s:.2f} s, ECE after {after['ece']:.4f}; launches {counts} ({smi})")
    if len(out["labels"]) != 4 * EVAL_CLASSES or not np.isfinite(out["logits"]).all() or not np.isfinite(temperature):
        raise AssertionError(f"evaluate: {len(out['labels'])} rows, temperature {temperature}")


def write_manifests(save_root: Path, with_clips: bool):
    """The evaluate stage's data as a user's preprocessed tree: the IMU manifest (splits
    ``train``/``val``/``test``, windows banks only) and, with ``with_clips``, the clip
    manifest (splits ``clip_*``, 2, 1 and 1 windows a class, with JPEG frame banks of
    ``CLIP_SHAPE``). Returns ``(imu {split: DataFrame}, clip {split: DataFrame})``."""
    import pandas as pd

    pre = save_root / "preprocessed"
    pre.mkdir(parents=True, exist_ok=True)

    def split(name, per_class, seed):
        windows, labels = eval_windows(per_class, seed)
        np.save(pre / f"{name}_windows.npy", np.ascontiguousarray(windows.transpose(0, 2, 1)))
        return pd.DataFrame({"split": name, "label": labels, "class_name": [f"c{c:02d}" for c in labels],
                             "bank_idx": np.arange(len(labels)), "video_exists": True,
                             "video_path": [f"video/{name}_{i}.mp4" for i in range(len(labels))], "start_frame": 0})

    imu = {s: split(s, FEWSHOT_WINDOWS[s], 7000 + i) for i, s in enumerate(("train", "val", "test"))}
    clip = {}
    if with_clips:
        import cv2

        T, H, W = CLIP_SHAPE
        ramp = np.linspace(0, 96, W, dtype=np.float32)
        for i, (s, per_class) in enumerate((("clip_train", 2), ("clip_val", 1), ("clip_test", 1))):
            clip[s] = split(s, per_class, 7100 + i)
            table = np.zeros((len(clip[s]), T, 2), np.int64)
            offset = 0
            with open(pre / f"{s}_frames.bin", "wb") as f:
                for row, label in enumerate(clip[s]["label"]):
                    for j in range(T):  # a smooth frame: the class's tint over a moving ramp
                        frame = np.empty((H, W, 3), np.uint8)
                        frame[:] = (np.add.outer(ramp[:H], np.roll(ramp, 14 * j)) / 2 + 4 * label)[..., None].astype(np.uint8)
                        ok, buf = cv2.imencode(".jpg", frame, [cv2.IMWRITE_JPEG_QUALITY, 90])
                        f.write(buf.tobytes())
                        table[row, j] = (offset, len(buf))
                        offset += len(buf)
            np.save(pre / f"{s}_frame_index.npy", table)
            (pre / f"{s}_frame_index.meta.json").write_text(json.dumps({"bank_format_version": 2}))
    return imu, clip


def run_dataframe_entries(counters: dict, kernels: dict, smi: str, zeroshot_task, save_root: Path) -> None:
    """Phase 20 over manifests, where pandas imports (and, for clips, OpenCV): the
    parallel few-shot grid (``run_parallel_fewshot``, its window banks), and with clips
    ``run_zero_shot`` and one held-out class of ``run_loo_experiments(model_kind=
    "fusion")`` (``BatchLoader``s decoding the JPEG frame banks, ``Evaluator``)."""
    try:
        import pandas  # noqa: F401
    except ImportError:
        print("[evaluate manifests] pandas does not import here: the DataFrame entries were not driven (the cores above were)")
        return
    try:
        import cv2  # noqa: F401
        with_clips = True
    except ImportError:
        with_clips = False
    t0 = time.perf_counter()
    imu, clip = write_manifests(save_root, with_clips)
    print(f"[evaluate manifests] pandas {pandas.__version__}; OpenCV {'imports' if with_clips else 'does not import'}; "
          f"manifests written in {time.perf_counter() - t0:.1f} s ({sum(map(len, imu.values()))} IMU windows, "
          f"{sum(map(len, clip.values()))} clips in JPEG frame banks)")
    cfg = classify_config()
    cfg.paths = PathConfig(base_output=save_root)
    cfg.training.train_epochs = FEWSHOT_EPOCHS
    cfg.eval.few_shot_samples, cfg.eval.few_shot_runs = [FEWSHOT_K], FEWSHOT_RUNS
    df, counts, grid_s = drive_counted(
        counters, kernels, "evaluate_fewshot_manifest",
        lambda: run_parallel_fewshot(cfg, None, imu["train"], imu["test"], imu["val"], device="cuda", verbose=False),
        dict.fromkeys(counters, 0))
    print(f"[evaluate manifests] run_parallel_fewshot: {len(df)} rows in {grid_s:.1f} s; finetune balanced accuracy "
          f"per run {[round(v, 2) for v in df[df['mode'] == 'finetune']['balanced_accuracy']]}")
    if len(df) != FEWSHOT_RUNS * len(cfg.eval.eval_modes):
        raise AssertionError(f"run_parallel_fewshot: {len(df)} rows")
    if not with_clips:
        print("[evaluate manifests] OpenCV does not import here: run_zero_shot and the fusion leave-one-out over "
              "manifests were not driven")
        return
    cfg_pt = pretrain_config()
    cfg_pt.paths = PathConfig(base_output=save_root)
    depth = VIT_CONFIGS[cfg_pt.model.video_backbone][0]
    clip_batches = -(-len(clip["clip_train"]) // cfg_pt.training.pretrain_batch_size)
    out, counts, zs_s = drive_counted(
        counters, kernels, "evaluate_zeroshot_manifest",
        lambda: run_zero_shot(zeroshot_task, clip["clip_train"], clip["clip_test"], cfg_pt,
                              save_path=save_root / "zeroshot_results.json"),
        {**dict.fromkeys(counters, 0), "flash_lean": depth * clip_batches})
    print(f"[evaluate manifests] run_zero_shot over the frame banks in {zs_s:.1f} s: "
          f"{json.loads((save_root / 'zeroshot_results.json').read_text())['video_prototype_zeroshot']['balanced_accuracy']:.2f}% "
          f"balanced accuracy; launches {counts}")
    cfg_pt.training.train_epochs, cfg_pt.training.train_batch_size = 1, LOO_BATCH
    held_out = 0
    n_id = {s: int((clip[s]["label"] != held_out).sum()) for s in clip}
    steps = n_id["clip_train"] // LOO_BATCH
    n_ood = int((clip["clip_test"]["label"] == held_out).sum())
    evals = sum(-(-n // LOO_BATCH) for n in (n_id["clip_val"], n_id["clip_test"], n_ood, n_id["clip_train"]))
    rows, counts, loo_s = drive_counted(
        counters, kernels, "evaluate_loo_manifest",
        lambda: OODEvaluator(cfg_pt, device="cuda").run_loo_experiments(
            clip["clip_train"], clip["clip_val"], clip["clip_test"], classes=[held_out], verbose=False, model_kind="fusion"),
        {**dict.fromkeys(counters, 0), "flash_lean": depth * (steps + evals), "flash_bwd_dkv": depth * steps,
         "flash_bwd_dq": depth * steps})
    print(f"[evaluate manifests] run_loo_experiments(model_kind='fusion') over the frame banks, class {held_out}: "
          f"{len(rows)} rows in {loo_s:.1f} s; launches {counts}")


def run_evaluate_stage(counters: dict, kernels: dict, smi: str, params_vit, params_pt) -> None:
    """Phase 20: the evaluate stage at full width (weights I/O, zero-shot, leave-one-out
    with the fusion classifier, the parallel few-shot harness, ``Evaluator`` and
    calibration), on the cores; then, where pandas imports, the DataFrame entries over
    manifests written here."""
    save_root = Path(__file__).resolve().parent / "tpuhar_torch" / "_build" / "chip_smoke_evaluate"
    shutil.rmtree(save_root, ignore_errors=True)
    save_root.mkdir(parents=True)
    check_weights_io(counters, kernels, params_vit, save_root)
    zeroshot_task = run_zero_shot_check(counters, kernels, smi, params_pt)
    run_loo_check(counters, kernels, smi, save_root)
    run_fewshot_check(counters, kernels, smi)
    run_evaluator_check(counters, kernels, smi, save_root)
    run_dataframe_entries(counters, kernels, smi, zeroshot_task, save_root)
    del zeroshot_task
    torch.cuda.empty_cache()
    shutil.rmtree(save_root, ignore_errors=True)


def pipeline_configs(cfg, root: Path, **data):
    """``cfg`` writing under ``root`` with the given ``data`` fields, frames not cached."""
    cfg = copy.deepcopy(cfg)
    cfg.paths = PathConfig(base_input=cfg.paths.base_input, base_output=root)
    cfg.data.extract_frames = False
    for key, value in data.items():
        setattr(cfg.data, key, value)
    return cfg


def run_pipeline_stage(counters: dict, kernels: dict, smi: str):
    """Phase 21: the pipeline from raw files through the port's command line (``cli.main``
    in process): ``--mode all`` (preprocess → pretrain → zeroshot → classify → evaluate →
    ood → report) and ``--mode serve`` on the card. Every artifact is checked, the PNGs
    left unwritten where matplotlib is missing are listed, and each stage's kernel
    launches are held to what it runs: the flash forward, dK/dV and dQ 12 times a
    pretraining step (the forward also 12 times a validation batch), the flash forward 12
    times a zero-shot prototype batch, the featurizer once in serving's eager warm-up and
    once in its graph (replayed once a batch), and nothing else. Then the preprocessor in
    situ: its window-scope route on the card (the fused featurizer) against the same on
    the CPU, and the CLI's device route against the host route."""
    import pandas as pd

    from tpuhar_torch import cli
    from tpuhar_torch.data.preprocess import Preprocessor
    from tpuhar_torch.data.synthetic import generate_synthetic_dataset

    root = Path(__file__).resolve().parent / "tpuhar_torch" / "_build" / "chip_smoke_pipeline"
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    generate_synthetic_dataset(root / "data", num_classes=PIPELINE_CLASSES, samples_per_class=PIPELINE_SAMPLES,
                               video_size=PIPELINE_VIDEO, fps=25.0, seed=0)
    print(f"[pipeline] synthetic dataset: {PIPELINE_CLASSES} classes x {PIPELINE_SAMPLES} samples x 3 splits, "
          f"{PIPELINE_VIDEO[0]}x{PIPELINE_VIDEO[1]} mp4v video at 25 fps, in {time.perf_counter() - t0:.1f} s")
    cfg = pretrain_config()
    cfg.paths = PathConfig(base_input=root / "data", base_output=root / "out")
    cfg.model.num_classes = PIPELINE_CLASSES
    cfg.training.pretrain_epochs = cfg.training.train_epochs = 1
    cfg.eval.few_shot_samples, cfg.eval.few_shot_runs = [2], 2
    cfg.ood.leave_out_classes = [0]
    config_path = root / "config.json"
    cfg.save(config_path)

    stages = {}  # stage → (launches, seconds)
    originals = {name: getattr(cli.Pipeline, name) for name in PIPELINE_STAGES}

    def counted(name, fn):
        def run(self, *args, **kwargs):
            before = {k: c.launches for k, c in counters.items()}
            t = time.perf_counter()
            try:
                return fn(self, *args, **kwargs)
            finally:
                torch.cuda.synchronize()
                stages[name] = ({k: c.launches - before[k] for k, c in counters.items()}, time.perf_counter() - t)
        return run

    for name, fn in originals.items():
        setattr(cli.Pipeline, name, counted(name, fn))
    try:
        for path, mode in (("pipeline_all", ["--mode", "all"]),
                           ("pipeline_serve", ["--mode", "serve", "--serve-batch", str(PIPELINE_SERVE_BATCH)])):
            pipe, counts, seconds = drive_counted(
                counters, kernels, path, lambda: cli.main(["--config", str(config_path), "--device", "cuda", *mode]), {})
            print(f"[pipeline] python -m tpuhar_torch {' '.join(mode)} --device cuda: {seconds:.1f} s; launches {counts}")
    finally:
        for name, fn in originals.items():
            setattr(cli.Pipeline, name, fn)

    out = root / "out"
    missing = [a for a in PIPELINE_ARTIFACTS if not (out / a).exists()]
    if missing:
        raise AssertionError(f"pipeline: artifacts not written: {missing}")
    try:
        import matplotlib  # noqa: F401
        plots_expected = True
    except ImportError:
        plots_expected = False
    unwritten = [p for p in PIPELINE_PLOTS if not (out / p).exists()]
    print(f"[pipeline] every artifact written; PNGs not written (matplotlib "
          f"{'imports' if plots_expected else 'is not installed'}): {unwritten}")
    if plots_expected and unwritten:
        raise AssertionError(f"pipeline: matplotlib imports but {unwritten} were not written")

    meta = {s: pd.read_csv(out / "preprocessed" / f"{s}_metadata.csv") for s in ("train", "val", "test")}
    bs, depth = cfg.training.pretrain_batch_size, VIT_CONFIGS[cfg.model.video_backbone][0]
    steps = len(meta["train"]) // bs * cfg.training.pretrain_epochs
    val_batches, proto_batches = -(-len(meta["val"]) // bs), -(-len(meta["train"]) // bs)
    serve = pipe.serving_stats
    graph = serve["graph_launches"]
    zero = dict.fromkeys(counters, 0)
    expected = {name: zero for name in PIPELINE_STAGES}
    expected["run_pretraining"] = {**zero, "flash_lean": depth * (steps + val_batches),
                                   "flash_bwd_dkv": depth * steps, "flash_bwd_dq": depth * steps}
    expected["run_zeroshot"] = {**zero, "flash_lean": depth * proto_batches}
    expected["run_serving"] = {**zero, "fused_window": 1 + graph.get("fused_window", 0)}
    if steps < 1 or graph.get("fused_window") != 1 or serve["batches"] != -(-len(meta["test"]) // PIPELINE_SERVE_BATCH):
        raise AssertionError(f"pipeline: {steps} pretraining steps, serving {serve}")
    for name in PIPELINE_STAGES:
        counts, seconds = stages[name]
        launched = {k: n for k, n in counts.items() if n}
        print(f"[pipeline] stage {name}: {seconds:.2f} s, launches {launched or 'none'} ({smi})")
        if counts != expected[name]:
            raise AssertionError(f"pipeline {name}: launches {counts}, expected {expected[name]}")
    print(f"[pipeline] {len(meta['train'])}/{len(meta['val'])}/{len(meta['test'])} train/val/test windows; pretraining "
          f"{steps} steps of {bs} and {val_batches} validation batch(es), {proto_batches} zero-shot prototype batches; "
          f"serving {serve['windows']} windows in {serve['batches']} batch(es) of {PIPELINE_SERVE_BATCH} replayed, "
          f"{serve['windows'] / serve['seconds']:.1f} windows/s ({serve['seconds']:.3f} s; {smi})")

    report = json.loads((out / "results" / "final_report.json").read_text())
    served = pd.read_csv(out / "results" / "serving_predictions_test.csv")
    logits = np.load(out / "results" / "test_logits_finetune.npy")
    zeroshot = json.loads((out / "results" / "zeroshot_results.json").read_text())["video_prototype_zeroshot"]
    if (not {"classification", "few_shot", "ood", "pretraining_history"} <= set(report)
            or len(served) != len(meta["test"]) or not served["pred"].between(0, PIPELINE_CLASSES - 1).all()
            or not np.isfinite(served[["msp", "energy"]].to_numpy()).all()
            or logits.shape != (len(meta["test"]), PIPELINE_CLASSES) or not np.isfinite(logits).all()
            or not np.isfinite(report["pretraining_history"]["train"]).all()):
        raise AssertionError(f"pipeline: report keys {sorted(report)}, {len(served)} served, logits {logits.shape}")
    print(f"[pipeline] final_report.json: pretraining loss {report['pretraining_history']}, finetune balanced "
          f"accuracy {report['classification']['finetune']['balanced_accuracy']:.2f}, zero-shot "
          f"{zeroshot['balanced_accuracy']:.2f}; serving accuracy "
          f"{float((served['pred'] == served['label']).mean()) * 100:.2f}%")

    # the window-scope route: the fused featurizer on the card against its plain version on the CPU
    n_windows = len(meta["test"])
    on_card, on_cpu = (pipeline_configs(cfg, root / name, zscore_scope="window") for name in ("window_cuda", "window_cpu"))
    _, counts, seconds = drive_counted(
        counters, kernels, "pipeline_preprocess_window",
        lambda: Preprocessor(on_card, device="cuda").preprocess_split("test"),
        {**zero, "fused_window": -(-n_windows // 1024)})
    Preprocessor(on_cpu, device="cpu").preprocess_split("test")
    got, want = (np.load(Path(c.paths.preprocessed_dir) / "test_windows.npy") for c in (on_card, on_cpu))
    err = float(np.abs(got - want).max())
    print(f"[pipeline] Preprocessor(zscore_scope='window') on the card vs the CPU: {n_windows} windows in "
          f"{seconds:.2f} s, max abs diff {err:.3e} (limit {FEATURIZE_ATOL}); launches {counts}")
    if got.shape != want.shape or not err <= FEATURIZE_ATOL:
        raise AssertionError(f"window-scope preprocessor: {got.shape} vs {want.shape}, max abs diff {err}")
    # the CLI's device route on the card against the host route
    host = pipeline_configs(cfg, root / "host", featurize_backend="host")
    worst = 0.0
    for split in ("train", "val", "test"):
        Preprocessor(host, device="cpu").preprocess_split(split)
        got, want = (np.load(Path(c.paths.preprocessed_dir) / f"{split}_windows.npy") for c in (cfg, host))
        if got.shape != want.shape:
            raise AssertionError(f"device vs host route, {split}: {got.shape} vs {want.shape}")
        worst = max(worst, float(np.abs(got - want).max()))
    print(f"[pipeline] featurize_backend='device' on the card vs 'host': max abs diff {worst:.3e} "
          f"(limit {PREPROCESS_DEVICE_ATOL})")
    if not worst <= PREPROCESS_DEVICE_ATOL:
        raise AssertionError(f"device vs host route: max abs diff {worst}")
    del pipe
    torch.cuda.empty_cache()
    return cfg  # phase 22 reads its dataset and frame banks; main removes them after


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def run_mesh_stage(counters: dict, kernels: dict, smi: str, cfg) -> dict:
    """Phase 22: data parallel over a mesh and the loader backends, on the dataset and
    frame banks phase 21 wrote under ``cfg.paths`` (``pretrain_config()``'s 224², 16
    frames). The probes; the decode times (host clock); three loaders, equal batch for
    batch; then, in an NCCL group of one process, two pretraining steps through
    ``CrossModalTrainer(mesh=)`` bit for bit against the same steps without a mesh, and
    the flagship engine over the mesh bit for bit against the engine without one. At a
    world of one every all-reduce and all-gather is an identity: the comparisons hold
    the mesh paths to the one-device paths exactly. Returns the two steps without a
    mesh (losses, the model's state after them, the batches, the learning rates), which
    phase 23 holds its tensor-parallel steps to."""
    import pandas as pd
    import torch.distributed as dist

    from tpuhar_torch import native
    from tpuhar_torch.data.frames import FrameBankReader
    from tpuhar_torch.data.grain_loader import GrainBatchLoader
    from tpuhar_torch.data.loader import BatchLoader, to_device
    from tpuhar_torch.data.parallel_decode import ProcessDecodePool
    from tpuhar_torch.parallel.mesh import create_mesh

    t_phase = time.perf_counter()
    jpeg = subprocess.run(["cc", "-E", "-"], input="#include <jpeglib.h>\n", capture_output=True, text=True).returncode == 0
    built = native.decode_available()
    print(f"[mesh] host: os.cpu_count() = {os.cpu_count()}; jpeglib.h {'found' if jpeg else 'missing'} (cc -E); the "
          f"native decoder {'built' if built else 'did not build'}; grain "
          f"{'installed' if importlib.util.find_spec('grain') else 'not installed'} (never imported: it imports JAX)")
    pre = Path(cfg.paths.preprocessed_dir)
    bank = (str(pre / "train_frames.bin"), str(pre / "train_frame_index.npy"))
    reader = FrameBankReader(*bank)
    hw = tuple(cfg.data.video_resize)
    backend = "native" if built else "cv2"
    if not built:
        try:
            reader.read_clip(0, hw, backend="native")
        except RuntimeError as e:
            print(f"[mesh] backend='native' raises without the decoder, as it must: {e}")
        else:
            raise AssertionError("backend='native' decoded a clip without the native decoder")

    # a 16-frame 224² clip's decode: OpenCV, the native decoder, the process pool
    rows = [r for r in range(len(reader)) if reader.has_frames(r)][:MESH_DECODE_CLIPS]

    def per_clip(fn) -> float:
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) / len(rows) * 1e3

    clips = {"cv2": [reader.read_clip(r, hw, backend="cv2") for r in rows]}
    times = {"cv2": per_clip(lambda: [reader.read_clip(r, hw, backend="cv2") for r in rows])}
    if built:
        clips["native"] = [reader.read_clip(r, hw, backend="native") for r in rows]
        times["native"] = per_clip(lambda: [reader.read_clip(r, hw, backend="native") for r in rows])
    pool = ProcessDecodePool(2)
    try:
        specs = [{"kind": "bank", "i": i, "bin_path": bank[0], "idx_path": bank[1], "row": r, "resize_hw": hw,
                  "backend": backend} for i, r in enumerate(rows)]
        out = np.zeros((len(rows), cfg.data.video_frames_per_window, *hw, 3), np.uint8)
        t0 = time.perf_counter()
        pool.decode_batch(specs, out)  # the workers start: spawn, then import torch
        start_s = time.perf_counter() - t0
        times["pool of 2"] = per_clip(lambda: pool.decode_batch(specs, out))
    finally:
        pool.close()
    reader.close()
    if not np.array_equal(out, np.stack(clips[backend])):
        raise AssertionError("the pool's clips differ from the reader's")
    drift = max(int(np.abs(a.astype(np.int16) - b).max()) for a, b in zip(clips["cv2"], clips[backend]))
    print(f"[mesh] decode of a {cfg.data.video_frames_per_window}-frame {hw[0]}x{hw[1]} clip, ms a clip over {len(rows)} "
          f"clips: " + ", ".join(f"{k} {v:.3f}" for k, v in times.items())
          + f" (the pool's first batch, workers starting: {start_s:.2f} s)"
          + (f"; native vs cv2 max |diff| {drift}" if built else "") + " (host clock)")

    # three loaders over the train split, equal batch for batch
    df = pd.read_csv(pre / "train_metadata.csv")
    kw = dict(mode="cross_modal", batch_size=cfg.training.pretrain_batch_size)
    epochs, seconds = {}, {}
    pooled_loader = BatchLoader(df, cfg, decode_processes=2, frame_backend=backend, prefetch=0, **kw)
    for name, loader in (("default", BatchLoader(df, cfg, prefetch=0, **kw)), ("pool", pooled_loader),
                         ("grain", GrainBatchLoader(df, cfg, workers=2, **kw))):
        t0 = time.perf_counter()
        epochs[name] = list(loader)
        seconds[name] = time.perf_counter() - t0
    pooled_loader.close()
    for name in ("pool", "grain"):
        if len(epochs[name]) != len(epochs["default"]) or len(epochs["default"]) < MESH_STEPS:
            raise AssertionError(f"loader {name}: {len(epochs[name])} batches, default {len(epochs['default'])}")
        for i, (got, want) in enumerate(zip(epochs[name], epochs["default"])):
            if sorted(got) != sorted(want) or not all(np.array_equal(got[k], want[k]) for k in want):
                raise AssertionError(f"loader {name}: batch {i} differs from the default loader's")
    print(f"[mesh] {len(df)} windows: the default, pool (decode_processes=2, backend={backend!r}) and grain-role "
          f"(workers=2) loaders give equal batches ({len(epochs['default'])} of {kw['batch_size']}); an epoch "
          + ", ".join(f"{k} {v:.2f} s" for k, v in seconds.items()) + " (host clock, the workers' start included)")

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}", rank=0, world_size=1)
    try:
        mesh = create_mesh()
        print(f"[mesh] NCCL group of 1, mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))}")
        cfg_pt = pretrain_config()
        cfg_pt.paths = copy.deepcopy(cfg.paths)
        params = init_params(cfg_pt, torch.Generator().manual_seed(0), CrossModalModel)
        plain = build_pretrain_task(cfg_pt, device="cuda", params=params, steps_per_epoch=MESH_STEPS)
        gen = torch.Generator(device="cuda").manual_seed(0)
        plain_losses = [plain.train_step(plain.state, to_device(batch, "cuda"), gen)[1]["loss"].item()
                        for batch in epochs["default"][:MESH_STEPS]]
        want = {n: p.detach().clone() for n, p in plain.model.named_parameters()}
        # phase 23 holds the tensor-parallel steps to these two steps without a mesh
        reference = {"losses": plain_losses, "state": {n: t.detach().cpu() for n, t in plain.model.state_dict().items()},
                     "batches": epochs["default"][:MESH_STEPS], "lrs": [plain.state.optimizer.groups[0][1](i)
                                                                        for i in range(MESH_STEPS)]}
        del plain
        torch.cuda.empty_cache()
        task = build_pretrain_task(cfg_pt, device="cuda", params=params, steps_per_epoch=MESH_STEPS, mesh=mesh)
        trainer = CrossModalTrainer(cfg_pt, task.state, task.train_step, task.eval_step,
                                    Path(cfg.paths.checkpoints_dir) / "mesh_pretrain",
                                    generator=torch.Generator(device="cuda").manual_seed(0), mesh=mesh)
        batches = [to_device(b, "cuda") for b in epochs["pool"][:MESH_STEPS]]
        depth = VIT_CONFIGS[cfg_pt.model.video_backbone][0]
        expected = {**dict.fromkeys(counters, 0), "flash_lean": depth * MESH_STEPS,
                    "flash_bwd_dkv": depth * MESH_STEPS, "flash_bwd_dq": depth * MESH_STEPS}
        loss, counts, step_s = drive_counted(counters, kernels, "mesh_pretrain", lambda: trainer.train_epoch(batches),
                                             expected)
        differ = [n for n, p in task.model.named_parameters() if not torch.equal(p, want[n])]
        if differ or not np.isfinite(loss):
            raise AssertionError(f"mesh pretraining: loss {loss}, {len(differ)} parameters differ from the steps "
                                 f"without a mesh: {differ[:5]}")
        print(f"[mesh_pretrain] {MESH_STEPS} steps of {kw['batch_size']} through CrossModalTrainer(mesh=) from the pool "
              f"loader in {step_s:.2f} s (the first included), mean loss {loss:.6f}; all {len(want)} parameters equal "
              f"the steps without a mesh bit for bit; launches {counts} ({smi})")
        del task, trainer, want, batches
        torch.cuda.empty_cache()

        cfg_f = flagship_config()
        params_f = init_params(cfg_f, torch.Generator().manual_seed(0))
        engine = InferenceEngine(cfg_f, params_f, batch_sizes=[MESH_ENGINE_BATCH], mesh=mesh, device="cuda")
        requests = [engine_request(400 + i, n, cfg_f) for i, n in enumerate(MESH_REQUESTS)]
        check_graph_replay("engine_bf16_mesh", engine, requests, counters, kernels,
                           {"fused_window": 1, "conv3x3_bn_act": 4})
        single = InferenceEngine(cfg_f, params_f, batch_sizes=[MESH_ENGINE_BATCH], device="cuda")
        for args in requests:
            bitwise_equal(engine.predict(*args), single.predict(*args), f"engine_bf16_mesh at {args[0].shape[0]}")
        for args, got in zip(requests, engine.predict_stream(requests)):
            bitwise_equal(got, single.predict(*args), "engine_bf16_mesh predict_stream")
        print(f"[engine_bf16_mesh] predict on {list(MESH_REQUESTS)} rows and predict_stream equal the engine "
              f"without a mesh bit for bit")
        del engine, single
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    print(f"[mesh] phase 22: {time.perf_counter() - t_phase:.1f} s")
    return reference


def check_flash_at(shape, dtype=torch.bfloat16) -> dict:
    """The flash forward (with and without the stats) and both backward kernels against
    their plain versions at ``(B, H, N, 64)`` in ``dtype``, as phase 12 holds them: bf16
    against the plain version in the operands' type, f32 against it in float64."""
    B, H, N = shape
    gen = torch.Generator(device="cuda").manual_seed(1)
    q, k, v, dout = (torch.randn((B, N, H, 64), generator=gen, device="cuda").to(dtype).transpose(1, 2)
                     for _ in range(4))
    f32 = dtype == torch.float32
    plain = [t.double() for t in (q, k, v, dout)] if f32 else [q, k, v, dout]
    errs = {}
    want = flash_lean_reference(*plain[:3]).double()
    errs["flash_lean"] = (flash_lean(q, k, v).double() - want).abs().max().item() / want.abs().max().item()
    out, lse, out_f32 = flash_lean_with_stats(q, k, v, SM_SCALE)
    errs["flash_lean (stats)"] = (out.double() - want).abs().max().item() / want.abs().max().item()
    scores = (q.to(plain[0].dtype if f32 else torch.float32) @ k.to(plain[0].dtype if f32 else torch.float32).mT)
    lse_err = (lse.double() - torch.logsumexp(scores * SM_SCALE, dim=-1).double()).abs().max().item()
    del scores
    got = flash_lean_backward(q, k, v, out_f32, dout, lse, SM_SCALE)
    ref = flash_lean_backward_reference(*plain, SM_SCALE)
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        errs[f"flash backward {name}"] = (g.double() - r.double()).abs().max().item() / r.double().abs().max().item()
    print(f"[tp] flash kernels at a rank's shape {shape + (64,)} {'f32' if f32 else 'bf16'}: lse max abs diff "
          f"{lse_err:.3e}; relative " + ", ".join(f"{n} {e:.3e}" for n, e in errs.items()))
    limits = {n: FLASH_F32_RTOL if f32 else FLASH_BWD_RTOL if "backward" in n else FLASH_RTOL for n in errs}
    bad = {n: e for n, e in errs.items() if not e <= limits[n]}
    if bad or not lse_err <= (FLASH_F32_LSE_ATOL if f32 else LSE_ATOL):
        raise AssertionError(f"flash kernels at {shape} {dtype}: {bad}, lse {lse_err}")
    return errs


def tp_rank(rank: int, port: int, cfg_pt, cfg_cls, out_dir: str) -> None:
    """Rank ``rank`` of phase 23 on cuda:0, over a gloo group of two: phase 22's two
    pretraining steps through ``CrossModalTrainer(mesh=)`` on the ``(1, 2)`` mesh with the
    launches counted (each rank's flash kernels at 6 of the 12 heads), every call to
    ``torch.distributed.all_reduce`` timed (the card synchronized before and after), the
    ``last`` checkpoint; the IMU classifier's two finetune steps and its checkpoint; the
    bf16 flagship engine over the mesh, bit for bit the engine's without one. Writes
    ``rank{rank}.pt`` to ``out_dir``."""
    import torch.distributed as dist

    from tpuhar_torch.data.loader import to_device
    from tpuhar_torch.models.crossmodal import IMUClassifier
    from tpuhar_torch.ops.attention import FlashSelfAttention
    from tpuhar_torch.parallel.mesh import create_mesh
    from tpuhar_torch.train import checkpoint as ckpt

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out, counters = Path(out_dir), launch_counters()
    kernels = {name: {} for name in counters}
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank, world_size=TP_SIZE)
    try:
        mesh = create_mesh(model_axis_size=TP_SIZE)
        task = build_pretrain_task(cfg_pt, device="cuda", params=init_params(cfg_pt, torch.Generator().manual_seed(0),
                                                                             CrossModalModel),
                                   steps_per_epoch=MESH_STEPS, mesh=mesh)
        heads = sorted({m.num_heads for m in task.model.video_encoder.modules() if isinstance(m, FlashSelfAttention)})
        save_dir = Path(cfg_pt.paths.checkpoints_dir) / "tp_pretrain"
        trainer = CrossModalTrainer(cfg_pt, task.state, task.train_step, task.eval_step, save_dir,
                                    generator=torch.Generator(device="cuda").manual_seed(0), mesh=mesh)
        batches = [to_device(b, "cuda") for b in torch.load(out / "batches.pt", weights_only=False)]
        steps, all_reduce, collective = [], dist.all_reduce, {"s": 0.0, "calls": 0, "bytes": 0}

        def timed_step(state, batch, generator, step=trainer.train_step):
            t0 = time.perf_counter()
            state, metrics = step(state, batch, generator)
            torch.cuda.synchronize()
            steps.append((time.perf_counter() - t0, metrics["loss"].item()))
            return state, metrics

        def timed_all_reduce(tensor, *args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            done = all_reduce(tensor, *args, **kwargs)
            torch.cuda.synchronize()
            collective["s"] += time.perf_counter() - t0
            collective["calls"] += 1
            collective["bytes"] += tensor.numel() * tensor.element_size()
            return done

        trainer.train_step = timed_step
        depth = VIT_CONFIGS[cfg_pt.model.video_backbone][0]
        expected = {**dict.fromkeys(counters, 0), "flash_lean": depth * MESH_STEPS,
                    "flash_bwd_dkv": depth * MESH_STEPS, "flash_bwd_dq": depth * MESH_STEPS}
        dist.all_reduce = timed_all_reduce
        try:
            drive_counted(counters, kernels, "tp_pretrain", lambda: trainer.train_epoch(batches), expected)
        finally:
            dist.all_reduce = all_reduce
        memory = torch.cuda.max_memory_allocated() / 2**30
        t0 = time.perf_counter()
        ckpt.save_checkpoint(save_dir / "last", task.state, extra={"epoch": 0}, mesh=mesh)
        save_s = time.perf_counter() - t0
        print(f"[tp rank {rank}] heads a flash call {heads}; steps (s, loss) {steps}; all_reduce {collective}; "
              f"peak memory {memory:.2f} GiB; checkpoint gathered and written in {save_s:.2f} s", flush=True)
        del task, trainer, batches
        torch.cuda.empty_cache()

        cls_task = build_classification_task(cfg_cls, "finetune", device="cuda", steps_per_epoch=TP_IMU_STEPS,
                                             params=init_params(cfg_cls, torch.Generator().manual_seed(0),
                                                                IMUClassifier), mesh=mesh)
        cls_heads = sorted({m.num_heads for m in cls_task.model.modules() if hasattr(m, "head_dim")})
        ClassificationTrainer(cfg_cls, cls_task.state, cls_task.train_step, cls_task.eval_step,
                              Path(cfg_cls.paths.checkpoints_dir) / "tp_classifier",
                              torch.Generator(device="cuda").manual_seed(0), "finetune", mesh=mesh).train_epoch(
            classify_batches(cfg_cls, TP_IMU_STEPS, TP_IMU_BATCH, seed=700, video=False))
        ckpt.save_checkpoint(Path(cfg_cls.paths.checkpoints_dir) / "tp_classifier" / "last", cls_task.state,
                             extra={"epoch": 0}, mesh=mesh)
        del cls_task

        cfg_f = flagship_config()
        params_f = init_params(cfg_f, torch.Generator().manual_seed(0))
        engine = InferenceEngine(cfg_f, params_f, batch_sizes=[MESH_ENGINE_BATCH], mesh=mesh, device="cuda")
        requests = [engine_request(400 + i, n, cfg_f) for i, n in enumerate(MESH_REQUESTS)]
        check_graph_replay("tp_engine_bf16", engine, requests, counters, kernels,
                           {"fused_window": 1, "conv3x3_bn_act": 4})
        single = InferenceEngine(cfg_f, params_f, batch_sizes=[MESH_ENGINE_BATCH], device="cuda")
        for args in requests:
            bitwise_equal(engine.predict(*args), single.predict(*args), f"tp rank {rank} engine at {args[0].shape[0]}")
        torch.save({"steps": steps, "collective": collective, "memory_gib": memory, "save_s": save_s, "heads": heads,
                    "imu_heads": cls_heads, "launches": {n: k["launches_by_path"] for n, k in kernels.items()}},
                   out / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def run_tp_stage(counters: dict, kernels: dict, smi: str, cfg, reference: dict) -> None:
    """Phase 23: tensor parallel on the card. Two spawned processes on cuda:0 over gloo
    (``tp_rank``) on a ``(1, 2)`` mesh at full width: phase 22's two pretraining steps,
    their launches (each rank's flash kernels at ``TP_FLASH_SHAPE``), each step's time and
    the time spent in gloo's all-reduces; the loss and the gathered parameters of the
    ``last`` checkpoint against phase 22's steps without a mesh; the IMU classifier's TP
    checkpoint served by ``InferenceEngine.from_checkpoint`` against an engine of the
    same steps without a mesh; the mesh engine bit for bit (in each rank); the flash
    kernels at a rank's shape against their plain versions. A failure in either process
    fails the phase."""
    from tpuhar_torch.data.loader import to_device
    from tpuhar_torch.models.crossmodal import IMUClassifier

    t_phase = time.perf_counter()
    out = Path(cfg.paths.base_output) / "tp"
    out.mkdir(parents=True, exist_ok=True)
    torch.save(reference["batches"], out / "batches.pt")
    cfg_pt, cfg_cls = pretrain_config(), classify_config()
    cfg_pt.paths, cfg_cls.paths = copy.deepcopy(cfg.paths), copy.deepcopy(cfg.paths)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    torch.multiprocessing.start_processes(tp_rank, args=(free_port(), cfg_pt, cfg_cls, str(out)), nprocs=TP_SIZE,
                                          start_method="spawn")
    spawn_s = time.perf_counter() - t0
    ranks = [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(TP_SIZE)]
    for name in kernels:
        for path in ("tp_pretrain", "tp_engine_bf16"):
            kernels[name].setdefault("launches_by_path", {})[path] = sum(r["launches"][name][path] for r in ranks)
    print(f"[tp] {TP_SIZE} processes on cuda:0 over gloo, mesh (1, 2), in {spawn_s:.1f} s (start, build, steps, "
          f"checkpoints, engines); launches a rank {ranks[0]['launches']}; videomae_base heads a flash call "
          f"{[r['heads'] for r in ranks]}, the IMU encoders' {[r['imu_heads'] for r in ranks]}")
    if any(r["heads"] != [TP_FLASH_SHAPE[1]] for r in ranks):
        raise AssertionError(f"tp: the flash calls' heads {[r['heads'] for r in ranks]}, expected {TP_FLASH_SHAPE[1]}")
    for rank, r in enumerate(ranks):
        c = r["collective"]
        print(f"[tp_pretrain rank {rank}] steps of {PRETRAIN_BATCH}: "
              + ", ".join(f"{s:.3f} s" for s, _ in r["steps"])
              + f" (the first includes the first use); gloo all_reduce {c['s']:.3f} s in {c['calls']} calls, "
              f"{c['bytes'] / 1e9:.3f} GB; peak memory {r['memory_gib']:.2f} GiB; the checkpoint gathered and written "
              f"in {r['save_s']:.2f} s ({smi})")
    losses = [loss for _, loss in ranks[0]["steps"]]
    if any([loss for _, loss in r["steps"]] != losses for r in ranks):
        raise AssertionError(f"tp: the ranks' losses differ: {[r['steps'] for r in ranks]}")
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, reference["losses"])]
    print(f"[tp_pretrain] losses {losses} against phase 22's without a mesh {reference['losses']}: relative "
          + ", ".join(f"{r:.3e}" for r in rel))
    if not max(rel) <= PRETRAIN_LOSS_RTOL:
        raise AssertionError(f"tp_pretrain: loss relative diffs {rel} > {PRETRAIN_LOSS_RTOL}")

    # the checkpoint: whole tensors, the names and shapes of the state without a mesh
    payload = torch.load(Path(cfg_pt.paths.checkpoints_dir) / "tp_pretrain" / "last.pt", map_location="cpu",
                         weights_only=True)
    got, want = payload["model"], reference["state"]
    if {n: t.shape for n, t in got.items()} != {n: t.shape for n, t in want.items()}:
        raise AssertionError("tp_pretrain: the checkpoint's names or shapes differ from the state without a mesh")
    sum_lr = sum(reference["lrs"])
    tight, worst, stats = {}, 0.0, {}
    for name, w in want.items():
        diff = (got[name].double() - w.double()).abs()
        if name.endswith((".mean", ".var")):  # BatchNorm running statistics
            stats[name] = diff.max().item() / max(w.abs().max().item(), 1e-30)
            continue
        ulps = 4 * torch.finfo(torch.float32).eps * w.abs().double()
        if not bool((diff <= 2.01 * sum_lr + ulps).all()):
            raise AssertionError(f"tp_pretrain: {name} moved beyond Adam's bound: {diff.max().item()}")
        tight[name] = (int((diff <= TP_TIGHT * sum_lr).sum()), diff.numel())
        worst = max(worst, diff.max().item())
    total = sum(n for _, n in tight.values())
    share = sum(t for t, _ in tight.values()) / total
    lowest = sorted((t / n, name) for name, (t, n) in tight.items())[:5]
    print(f"[tp_pretrain] the checkpoint's {len(got)} tensors are whole; after {MESH_STEPS} steps (Σlr {sum_lr:.3e}) "
          f"{share:.4%} of {total} parameter elements within {TP_TIGHT}·Σlr of the steps without a mesh (the lowest "
          f"leaves: {', '.join(f'{name} {r:.2%}' for r, name in lowest)}), the largest difference {worst:.3e}; "
          f"BatchNorm statistics, relative to each leaf's largest: " + ", ".join(f"{n} {e:.3e}" for n, e in stats.items()))
    if share < TP_TIGHT_SHARE or not all(e <= TP_STATS_RTOL for e in stats.values()):
        raise AssertionError(f"tp_pretrain: {share} of the elements within {TP_TIGHT}·Σlr, statistics {stats}")

    # the IMU classifier: its TP checkpoint served, against the same steps without a mesh
    task = build_classification_task(cfg_cls, "finetune", device="cuda", steps_per_epoch=TP_IMU_STEPS,
                                     params=init_params(cfg_cls, torch.Generator().manual_seed(0), IMUClassifier))
    ClassificationTrainer(cfg_cls, task.state, task.train_step, task.eval_step, out / "one_classifier",
                          torch.Generator(device="cuda").manual_seed(0), "finetune").train_epoch(
        classify_batches(cfg_cls, TP_IMU_STEPS, TP_IMU_BATCH, seed=700, video=False))
    plain = InferenceEngine(cfg_cls, variables_to_numpy(task.model), imu_only=True, batch_sizes=[MESH_ENGINE_BATCH],
                            device="cuda")
    served = InferenceEngine.from_checkpoint(cfg_cls, Path(cfg_cls.paths.checkpoints_dir) / "tp_classifier" / "last",
                                             imu_only=True, batch_sizes=[MESH_ENGINE_BATCH], device="cuda")
    agree = []
    for i, n in enumerate(MESH_REQUESTS):
        imu = engine_request(500 + i, n, cfg_cls)[0]
        a, b = served.predict(imu), plain.predict(imu)
        for key in ("logits", "embeddings"):
            c = cosine(torch.from_numpy(a[key]), torch.from_numpy(b[key]))
            agree.append(c)
            if not c >= COSINE_MIN:
                raise AssertionError(f"tp_classifier: {key} cosine {c} < {COSINE_MIN}")
    print(f"[tp_classifier] the TP checkpoint (IMU heads {ranks[0]['imu_heads']} a rank) served by "
          f"InferenceEngine.from_checkpoint against an engine of the steps without a mesh: logits and embeddings "
          f"cosines {', '.join(f'{c:.6f}' for c in agree)}")
    del task, plain, served
    torch.cuda.empty_cache()
    print(f"[tp_engine_bf16] in each rank: one featurizer and 4 fused convs a graph; predict on {list(MESH_REQUESTS)} "
          f"rows equals the engine without a mesh bit for bit")
    check_flash_at(TP_FLASH_SHAPE)
    check_flash_at(TP_FLASH_SHAPE, torch.float32)
    print(f"[tp] phase 23: {time.perf_counter() - t_phase:.1f} s")

def check_centered_stem(smi: str) -> dict:
    """Phase 24 (a): the stem on the centered wire's int8 codes (``center_u8`` on the
    host, then ``stem_gemm_u8``'s int8 branch, the int8 GEMM kernel) against the uint8
    wire of the same pixels (the stem kernel's byte map) and against the plain version,
    bit for bit, at the int8-resident engine's batch 256 with int8 out and on every byte
    value; both forms timed ``CENTERED_TURNS`` times in turns."""
    gen = torch.Generator(device="cuda").manual_seed(24)
    col = torch.randint(0, 256, (CENTERED_FRAMES, 14, 14, 768), generator=gen, device="cuda", dtype=torch.uint8)
    col.view(-1, 768)[0] = torch.arange(256, device="cuda", dtype=torch.uint8).repeat(3)  # every byte value
    host = col.cpu().numpy()
    t0 = time.perf_counter()
    codes_host = center_u8(host)
    center_ms = (time.perf_counter() - t0) * 1e3
    codes = torch.from_numpy(codes_host).cuda()
    del host, codes_host
    if not torch.equal(codes, torch.clamp(col.to(torch.int16) - 128, -127, 127).to(torch.int8)):
        raise AssertionError("center_u8 is not clip(u8 - 128, -127, 127)")
    w = torch.randint(-127, 128, (256, 768), generator=gen, device="cuda", dtype=torch.int8)
    scale = torch.rand(256, generator=gen, device="cuda") * 1e-5
    bias = torch.randn(256, generator=gen, device="cuda") * 0.5
    checks = {}
    for what, rows, kw in (("int8 out", CENTERED_FRAMES, {"out_scale": 0.05}), ("f32 out", 128, {})):
        before = stem_gemm_u8.launches, int8_gemm.launches
        got = stem_gemm_u8(codes[:rows], w, scale, bias, **kw)
        if (stem_gemm_u8.launches, int8_gemm.launches) != (before[0], before[1] + 1):
            raise AssertionError("stem_gemm_u8 on int8 codes did not launch the int8 GEMM kernel once")
        u8 = stem_gemm_u8(col[:rows], w, scale, bias, **kw)
        plain = stem_gemm_u8_reference(codes[:rows], w, scale, bias, **kw)
        checks[what] = {"vs_u8_wire": int((got != u8).sum().item()), "vs_plain": int((got != plain).sum().item()),
                        "max_abs_err": float((got.float() - plain.float()).abs().max().item())}
        print(f"[centered] stem ({rows}·196, 768)->256 {what} on center_u8 codes: {checks[what]['vs_u8_wire']} "
              f"mismatches against the uint8 wire of the same pixels, {checks[what]['vs_plain']} against the "
              f"plain version (every byte value in the first row)")
        if checks[what]["vs_u8_wire"] or checks[what]["vs_plain"]:
            raise AssertionError(f"centered stem {what}: {checks[what]}")
        del got, u8, plain
    kw = {"out_scale": 0.05}
    turns = {"u8": [], "centered": []}
    for _ in range(CENTERED_TURNS):
        turns["u8"].append(cuda_ms(lambda: stem_gemm_u8(col, w, scale, bias, **kw), 20))
        turns["centered"].append(cuda_ms(lambda: stem_gemm_u8(codes, w, scale, bias, **kw), 20))
    plain_ms = _plain_ms(lambda: stem_gemm_u8_reference(codes, w, scale, bias, **kw), CENTERED_FRAMES)
    library_ms, note = int_mm_ms(codes.reshape(-1, 768), w.T.contiguous(), "the centered codes")
    b = bound(codes.numel() + w.numel() + codes.numel() // 768 * 256 + 8 * 256, {"int8": 2 * codes.numel() * 256})
    ms, u8_ms = float(np.mean(turns["centered"])), float(np.mean(turns["u8"]))
    print(f"[centered] stem (4096·196, 768)->256 int8 out, in turns {turns} ms: centered wire (int8 GEMM kernel) "
          f"{ms:.4f} ms, uint8 wire (stem kernel, byte map) {u8_ms:.4f} ms; plain {plain_ms:.4f} ms; bound "
          f"{b['bound_ms']:.4f} ms ({b['bound_by']}); " + (note if library_ms is None else f"{note}: {library_ms:.4f} ms")
          + f"; center_u8 on the host {center_ms:.1f} ms for {codes.numel() / 2**20:.0f} MiB ({smi})")
    del col, codes
    torch.cuda.empty_cache()
    return {"shape": "(4096·196, 768) int8 -> 256 int8", "ms": ms, "u8_wire_ms": u8_ms, "turns_ms": turns,
            "plain_ms": plain_ms, "library_ms": library_ms, "library_note": note, "host_center_ms": center_ms,
            "max_abs_err": max(c["max_abs_err"] for c in checks.values()), **b}


def check_centered_engines(counters: dict, kernels: dict, smi: str, cfg, params) -> dict:
    """Phase 24 (a): the int8-resident flagship engine on each wire at
    ``CENTERED_ENGINE_SIZES``, one CUDA graph a size: the launches each graph holds (the
    centered wire's stem through the int8 GEMM kernel), then at each size ``predict`` (a
    replay) and each engine's eager program on its own padded wire, the centered engine's
    against the uint8 engine's bit for bit; both engines' replay and ``predict`` timed in
    turns at 256."""
    H, W = cfg.data.video_resize
    calib = (np.random.default_rng(0).random((2, cfg.data.video_frames_per_window, H, W, 3)) * 255).astype(np.uint8)
    expected = {"u8": {"fused_window": 1, "stem_gemm_u8": 1, "conv3x3_i8": 5},
                "centered": {"fused_window": 1, "int8_gemm": 1, "conv3x3_i8": 5}}
    engines = {}
    for wire in ("u8", "centered"):
        t0 = time.perf_counter()
        engines[wire] = InferenceEngine(
            cfg, params, batch_sizes=CENTERED_ENGINE_SIZES, quantize_calib_clips=calib, quantize_resident=True,
            verify_byte_map=True, int8_wire=wire, device="cuda",
        )
        path = f"engine_int8_{wire}_wire"
        _, counts, warm_s = drive_counted(counters, kernels, path, engines[wire].warmup, {
            name: 2 * len(CENTERED_ENGINE_SIZES) * expected[wire].get(name, 0) for name in counters})
        for b, launches in engines[wire].graph_launches.items():
            if {k: v for k, v in launches.items() if v} != expected[wire]:
                raise AssertionError(f"{path} batch {b}: the graph holds {launches}, expected {expected[wire]}")
        for name in counters:  # a replay calls no wrapper: a path's count is what one replay holds
            kernels[name]["launches_by_path"][path] = engines[wire].graph_launches[8].get(name, 0)
        print(f"[centered] {path}: built in {time.perf_counter() - t0 - warm_s:.1f} s, graphs captured in "
              f"{warm_s:.1f} s; launches a replay {engines[wire].graph_launches[8]}")
    for b in CENTERED_ENGINE_SIZES:
        imu, clip = engine_request(500 + b, b, cfg)
        replay = {wire: e.predict(imu, clip) for wire, e in engines.items()}
        eager = {}
        for wire, e in engines.items():
            args = [torch.from_numpy(a).cuda() for a in e._pad_to(imu, clip, b)]
            if args[1].dtype != (torch.int8 if wire == "centered" else torch.uint8):
                raise AssertionError(f"{wire} engine ships {args[1].dtype}")
            eager[wire] = {k: v.cpu().numpy() for k, v in e._forward(*args).items()}
        bitwise_equal(replay["centered"], replay["u8"], f"centered vs uint8 engine, predict (replay) at {b}")
        bitwise_equal(eager["centered"], eager["u8"], f"centered vs uint8 engine, eager program at {b}")
        bitwise_equal(replay["centered"], eager["centered"], f"centered engine, replay vs eager at {b}")
        print(f"[centered] batch {b}: the centered engine equals the uint8 engine bit for bit on a replay and "
              f"eagerly ({', '.join(replay['u8'])})")
    b = CENTERED_ENGINE_SIZES[-1]
    imu, clip = engine_request(520, b, cfg)
    turns = {wire: {"replay_ms": [], "predict_ms": []} for wire in engines}
    for _ in range(CENTERED_TURNS):
        for wire, e in engines.items():
            turns[wire]["replay_ms"].append(cuda_ms(lambda: e._replay(b), ENGINE_TIMING_ITERS[b]))
            t0 = time.perf_counter()
            for _ in range(ENGINE_TIMING_ITERS[b]):
                e.predict(imu, clip)
            turns[wire]["predict_ms"].append((time.perf_counter() - t0) / ENGINE_TIMING_ITERS[b] * 1e3)
    print(f"[centered] batch {b} in turns (ms): {json.dumps(turns)}; predict includes the host's patch shuffle "
          f"(and the centering on the centered wire) and the upload ({smi})")
    out = {"engine_launches_per_replay": engines["centered"].graph_launches[8], "engine_turns_ms_at_256": turns}
    del engines
    torch.cuda.empty_cache()
    return out


_ARTICLE_CHILD = """
import json, sys
import tpuhar_torch.serving as serving
from tpuhar_torch.ops.flash_lean import flash_lean_bwd_dkv, flash_lean_bwd_dq
from tpuhar_torch.scripts import article_workflow
article_workflow.main(["--quick", "--out", sys.argv[1], "--workdir", sys.argv[2]])
counts = {**serving.kernel_launches(), "flash_bwd_dkv": flash_lean_bwd_dkv.launches, "flash_bwd_dq": flash_lean_bwd_dq.launches}
print(json.dumps({"launches": counts}))
"""


def finite_numbers(obj, what: str) -> int:
    """Fail unless every number in a JSON value is finite; returns how many there are."""
    if isinstance(obj, dict):
        return sum(finite_numbers(v, f"{what}.{k}") for k, v in obj.items())
    if isinstance(obj, list):
        return sum(finite_numbers(v, f"{what}[{i}]") for i, v in enumerate(obj))
    if isinstance(obj, (int, float)) and not isinstance(obj, bool):
        if not np.isfinite(obj):
            raise AssertionError(f"{what} is {obj}")
        return 1
    return 0


def run_workflows_stage(counters: dict, kernels: dict, smi: str) -> Path:
    """Phase 24 (b): the validation workflows of ``tpuhar_torch.scripts`` at full width
    on a small fixture: ``bench_accuracy`` → ``validate_int8_ood`` per tower →
    ``rescore_ood_hard``, in process with each one's kernel launches, and
    ``article_workflow --quick`` in a second process; every JSON under
    ``outputs/torch/`` parsed and held to the JAX script's keys and finite numbers, and
    ``docs/`` left as it was."""
    from tpuhar_torch.scripts import bench_accuracy, rescore_ood_hard, validate_int8_ood

    repo = Path(__file__).resolve().parent
    root = repo / "outputs" / "torch" / "chip_smoke"
    shutil.rmtree(root, ignore_errors=True)
    docs = sorted((str(p), p.stat().st_mtime_ns) for p in (repo / "docs").rglob("*")) if (repo / "docs").exists() else []
    t_phase = time.perf_counter()
    article = subprocess.Popen(
        [sys.executable, "-c", _ARTICLE_CHILD, str(root / "article_quick"), str(root / "article_quick_work")],
        cwd=repo, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    try:
        ba = root / "bench_accuracy"
        results, counts, seconds = drive_counted(counters, kernels, "workflow_bench_accuracy", lambda: bench_accuracy.main(
            ["--backbones", ",".join(WORKFLOW_TOWERS), *WORKFLOW_ARGS, "--out", str(ba)]), {})
        base = {"backbone", "params_m", "train_wall_s", "curve", "test_balanced_accuracy", "test_accuracy",
                "test_f1_macro", "ood_wall_s", "ood_id_accuracy"}
        base |= {f"{m}_{s}" for m in ("auroc", "fpr95") for s in ("msp", "energy", "mahalanobis")}
        saved = json.loads((ba / "results.json").read_text())
        if [r["backbone"] for r in saved] != list(WORKFLOW_TOWERS) or any(set(r) != base for r in saved):
            raise AssertionError(f"bench_accuracy results.json: {[sorted(r) for r in saved]}")
        n = finite_numbers(saved, "bench_accuracy")
        print(f"[workflows] bench_accuracy {WORKFLOW_TOWERS} at 224², 16 frames in {seconds:.1f} s: {n} finite "
              f"numbers; launches {counts}")
        for r in saved:
            print(f"[workflows] bench_accuracy {r['backbone']}: test bal_acc {r['test_balanced_accuracy']}, OOD AUROC "
                  f"msp {r['auroc_msp']} energy {r['auroc_energy']} mahalanobis {r['auroc_mahalanobis']}, train "
                  f"{r['train_wall_s']} s, leave-one-out {r['ood_wall_s']} s")
        if not counts["conv3x3_bn_act"]:
            raise AssertionError("bench_accuracy: the tpu_cnn eval forwards launched no fused conv")

        for tower in WORKFLOW_TOWERS:
            out = root / f"int8_ood_parity_{tower}.json"
            args = validate_int8_ood.parse_args(["--classes", WORKFLOW_LOO, "--tower", tower, "--root", str(ba),
                                                 "--out", str(out)])
            (rows, scores), counts, seconds = drive_counted(
                counters, kernels, f"workflow_validate_int8_ood_{tower}", lambda: validate_int8_ood.run(args), {})
            saved = json.loads(out.read_text())
            paths = ("f32", "int8", "int8res") + (("int8pm",) if tower == "tpu_cnn" else ())
            keys = {"held_out_class"} | {f"thrx_{s}" for s in ("msp", "energy", "mahalanobis")}
            keys |= {"pm_logit_maxdelta"} if tower == "tpu_cnn" else set()
            for p in paths + tuple(f"{q}r" for q in paths[1:]):
                keys |= {f"{p}_{m}_{s}" for m in ("auroc", "fpr95") for s in ("msp", "energy", "mahalanobis")}
                keys.add(f"{p}_id_acc")
            if saved != rows or [r["held_out_class"] for r in rows] != [0, 1] or any(set(r) != keys for r in rows):
                raise AssertionError(f"validate_int8_ood {tower}: {[sorted(set(r) ^ keys) for r in rows]}")
            finite_numbers(saved, f"validate_int8_ood {tower}")
            for r in rows:
                c = r["held_out_class"]
                tr_f, _, id_f, _, ood_f, _ = scores[c]["f32"]
                gaps = {p: max(float(np.abs(a - b).max()) for a, b in zip((tr_f, id_f, ood_f), scores[c][p][::2]))
                        for p in scores[c] if p != "f32"}
                auroc = {s: (r[f"f32_auroc_{s}"], r[f"int8r_auroc_{s}"], round(r[f"int8r_auroc_{s}"] - r[f"f32_auroc_{s}"], 4))
                         for s in ("msp", "energy", "mahalanobis")}
                print(f"[workflows] validate_int8_ood {tower} class {c}: AUROC (f32, int8r, gap) {auroc}; int8 raw "
                      f"{ {s: r[f'int8_auroc_{s}'] for s in ('msp', 'energy', 'mahalanobis')} }; id acc f32 "
                      f"{r['f32_id_acc']} int8r {r['int8r_id_acc']}; largest logit gap to f32 "
                      f"{ {p: round(g, 5) for p, g in gaps.items()} }"
                      + (f"; patch-major vs device shuffle {r['pm_logit_maxdelta']}" if tower == "tpu_cnn" else ""))
            if tower == "tpu_cnn" and any(r["pm_logit_maxdelta"] != 0.0 for r in rows):
                raise AssertionError("validate_int8_ood: the patch-major wire's logits differ from the device shuffle's")
            wanted = ("stem_gemm_u8", "conv3x3_i8", "conv3x3_bn_act") if tower == "tpu_cnn" else ("int8_gemm", "conv3x3_i8")
            if not all(counts[k] for k in wanted):
                raise AssertionError(f"validate_int8_ood {tower}: launches {counts}, expected {wanted} to move")
            print(f"[workflows] validate_int8_ood {tower} in {seconds:.1f} s; launches {counts}")

        out = root / "ood_rescore_hard.json"
        saved, counts, seconds = drive_counted(counters, kernels, "workflow_rescore_ood_hard", lambda: rescore_ood_hard.main(
            ["--root", str(ba), "--towers", ",".join(WORKFLOW_TOWERS), "--classes", WORKFLOW_LOO, "--out", str(out)]), {})
        names = rescore_ood_hard.SCORE_NAMES + rescore_ood_hard.CAL_NAMES
        keys = {"tower", "held_out_class", "temperature", "ece_id", "ece_id_cal", "wall_s"}
        keys |= {f"{m}_{s}" for m in ("auroc", "fpr95") for s in names}
        if (json.loads(out.read_text()) != saved or set(saved) != {"rows", "knn_k", "mean_by_tower"}
                or len(saved["rows"]) != 2 * len(WORKFLOW_TOWERS) or any(set(r) != keys for r in saved["rows"])):
            raise AssertionError(f"rescore_ood_hard: {sorted(saved)}")
        finite_numbers(saved, "rescore_ood_hard")
        print(f"[workflows] rescore_ood_hard in {seconds:.1f} s: mean AUROC by tower {json.dumps(saved['mean_by_tower'])}; "
              f"launches {counts}")

        stdout, _ = article.communicate(timeout=ARTICLE_TIMEOUT_S)
        if article.returncode != 0:
            raise AssertionError(f"article_workflow --quick exited {article.returncode}:\n{stdout[-4000:]}")
        child = json.loads(stdout.strip().splitlines()[-1])["launches"]
        for name, n in child.items():
            kernels[name].setdefault("launches_by_path", {})["workflow_article_quick"] = n
        saved = json.loads((root / "article_quick" / "article_workflow.json").read_text())
        keys = {"resolved_args", "resolved_training", "fixture", "pretrain", "budget", "full_data", "few_shot_cells",
                "few_shot_mean_delta", "platform"}
        if set(saved) != keys or saved["platform"] != "cuda" or len(saved["few_shot_cells"]) != 4:
            raise AssertionError(f"article_workflow: {sorted(saved)}, platform {saved.get('platform')}")
        finite_numbers({k: v for k, v in saved.items() if k != "resolved_args"}, "article_workflow")
        print(f"[workflows] article_workflow --quick (second process, started with the phase): pretrain "
              f"{saved['pretrain']['epochs_ran']} epochs, val retrieval {json.dumps(saved['pretrain']['val_retrieval'])}; "
              f"full data {json.dumps(saved['full_data'])}; few-shot mean delta {saved['few_shot_mean_delta']}; "
              f"launches {child}")
    finally:
        if article.poll() is None:
            article.kill()
            article.wait()
    after = sorted((str(p), p.stat().st_mtime_ns) for p in (repo / "docs").rglob("*")) if (repo / "docs").exists() else []
    if after != docs:
        raise AssertionError("the workflows wrote under docs/")
    print(f"[workflows] phase 24 (b): {time.perf_counter() - t_phase:.1f} s; every JSON under {root.relative_to(repo)}, "
          f"nothing under docs/ ({smi})")
    return root  # phase 25 reads bench_accuracy's checkpoints; main removes the tree after it


def check_resident_drift(counters: dict, kernels: dict, smi: str) -> dict:
    """Phase 25 (a): ``measure_resident_drift.run`` at ``DRIFT_SEEDS`` seeds on the card
    (the int8 ResNet-18 at 32², 4 frames: ``conv3x3_i8`` down to 1² maps and a stride-2
    conv from 2² to 1²). Each engine's graph holds one featurizer, 4 ``int8_gemm`` and 16
    ``conv3x3_i8`` launches; its replay equals its eager program and the eager program its
    plain-kernel program, bit for bit; per seed the correlation and drift against the same
    seeds on the CPU."""
    from tpuhar_torch import serving as serving_module
    from tpuhar_torch.scripts import measure_resident_drift

    engines = []

    class Recorded(InferenceEngine):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            engines.append(self)

    serving_module.InferenceEngine = Recorded
    try:
        card, counts, seconds = drive_counted(counters, kernels, "probe_resident_drift",
                                              lambda: measure_resident_drift.run(DRIFT_SEEDS, device="cuda"), {})
    finally:
        serving_module.InferenceEngine = InferenceEngine
    if len(engines) != 2 * DRIFT_SEEDS:
        raise AssertionError(f"measure_resident_drift built {len(engines)} engines, expected {2 * DRIFT_SEEDS}")
    batch = measure_resident_drift.BATCH
    graph = {"fused_window": 1, "int8_gemm": 4, "conv3x3_i8": 16}
    for i, engine in enumerate(engines):
        seed, what = i // 2, f"drift seed {i // 2} {'resident' if i % 2 else 'baseline'}"
        held = {k: v for k, v in engine.graph_launches[batch].items() if v}
        if held != graph:
            raise AssertionError(f"{what}: the graph holds {held}, expected {graph}")
        imu, video = measure_resident_drift.seed_inputs(seed)
        args = [torch.from_numpy(a).cuda() for a in engine._pad_to(imu, video, batch)]
        bitwise_equal(engine.predict(imu, video), {k: v.cpu().numpy() for k, v in engine._forward(*args).items()},
                      f"{what}: predict (the replay) vs the eager program")
        equal_to_plain_kernels(f"{what} eager program", lambda: engine._forward(*args))
    del engines
    torch.cuda.empty_cache()
    for name in ("fused_window", "int8_gemm", "conv3x3_i8"):
        if not counts[name]:
            raise AssertionError(f"measure_resident_drift: {name} never launched ({counts})")
    t0 = time.perf_counter()
    cpu = measure_resident_drift.run(DRIFT_SEEDS, device="cpu")
    cpu_s = time.perf_counter() - t0
    for got, want in zip(card["rows"], cpu["rows"]):
        corr_gap, rel_gap = abs(got["corr"] - want["corr"]), abs(got["rel_rms_drift"] - want["rel_rms_drift"])
        print(f"[probes] resident drift seed {got['seed']}: card corr {got['corr']:.6f} rel {got['rel_rms_drift']:.5f}, "
              f"CPU corr {want['corr']:.6f} rel {want['rel_rms_drift']:.5f}")
        if not (corr_gap <= DRIFT_CORR_ATOL and rel_gap <= DRIFT_REL_RTOL * want["rel_rms_drift"] + DRIFT_REL_ATOL):
            raise AssertionError(f"resident drift seed {got['seed']}: card {got} against the CPU's {want}")
    print(f"[probes] measure_resident_drift {DRIFT_SEEDS} seeds on the card in {seconds:.1f} s (6 engines built, "
          f"calibrated and captured), on the CPU in {cpu_s:.1f} s; card distribution corr {json.dumps(card['corr'])}, "
          f"rel RMS drift {json.dumps(card['rel_rms_drift'])}; launches {counts}; each graph {graph} ({smi})")
    return card


def check_ckpt_rescoring(counters: dict, kernels: dict, smi: str, bench_root: Path) -> None:
    """Phase 25 (b): ``debug_ckpt_data_match.run`` on phase 24's ``tpu_cnn`` checkpoint
    (``fusion_full/last``, 3 classes) over ``CKPT_ROWS`` test rows: 4 fused convs an eval
    forward; the confusion matrix against the CPU's on the same rows."""
    from tpuhar_torch.scripts import debug_ckpt_data_match

    run = lambda device: debug_ckpt_data_match.run(bench_root, "tpu_cnn", CKPT_ROWS, device=device, num_classes=3)  # noqa: E731
    card, counts, seconds = drive_counted(counters, kernels, "probe_ckpt_data_match", lambda: run("cuda"), {})
    forwards = -(-len(card["labels"]) // 16)
    if counts["conv3x3_bn_act"] != 4 * forwards or any(n for k, n in counts.items() if k != "conv3x3_bn_act"):
        raise AssertionError(f"debug_ckpt_data_match: launches {counts}, expected 4 fused convs in each of {forwards}")
    t0 = time.perf_counter()
    cpu = run("cpu")
    cpu_s = time.perf_counter() - t0
    if not np.array_equal(card["labels"], cpu["labels"]) or not np.isfinite(card["logits"]).all():
        raise AssertionError("debug_ckpt_data_match: the card and the CPU scored other rows")
    moved = np.flatnonzero(card["logits"].argmax(1) != cpu["logits"].argmax(1))
    top2 = np.sort(cpu["logits"], 1)[:, -2:]
    near = (top2[:, 1] - top2[:, 0]) <= CKPT_FLIP_RTOL * np.abs(cpu["logits"]).max(1)
    if not np.array_equal(card["confusion"], cpu["confusion"]) and not near[moved].all():
        raise AssertionError(f"debug_ckpt_data_match: rows {moved.tolist()} predicted otherwise on the card, some "
                             f"with the CPU's top two logits apart by more than bf16 rounding")
    diff = float(np.abs(card["logits"] - cpu["logits"]).max())
    print(f"[probes] debug_ckpt_data_match tpu_cnn (phase 24's fusion_full/last) on {len(card['labels'])} test rows: "
          f"accuracy {card['accuracy']:.2f}% on the card, {cpu['accuracy']:.2f}% on the CPU; training-time last epoch "
          f"{json.dumps(card['training_last_epoch'])}; confusion matrix "
          + ("equal to the CPU's" if np.array_equal(card["confusion"], cpu["confusion"]) else
             f"differs from the CPU's in rows {moved.tolist()}, each with its top two logits within bf16 rounding")
          + f" {card['confusion'].tolist()}; largest logit gap card - CPU {diff:.4e}; {seconds:.1f} s on the card, "
          f"{cpu_s:.1f} s on the CPU; launches {counts} ({smi})")


def probe_fixture(root: Path) -> Path:
    """The hard fixture (6 classes, ``PROBE_SAMPLES`` sequences a class and split,
    1500 samples, coupled) preprocessed once at the probes' configuration (``tiny_cnn``,
    4 frames of 32²) under ``root / "article_hard"``; ``root / "article_hard_r5" / "pool"``
    is the same tree, where the debug scripts look for an article run's pool."""
    from tpuhar_torch.cli import Pipeline
    from tpuhar_torch.data.synthetic import generate_synthetic_dataset, make_synthetic_config

    work = root / "article_hard"
    generate_synthetic_dataset(work / "data", num_classes=6, samples_per_class=PROBE_SAMPLES, seq_len=1500, seed=1000,
                               difficulty="hard", label_noise=0.0, cross_modal_coupling=True)
    cfg = make_synthetic_config(work / "data", work / "out", num_classes=6, video_backbone="tiny_cnn",
                                video_resize=(32, 32))
    cfg.data.video_frames_per_window = 4
    Pipeline(cfg, device="cuda").run_preprocessing()
    (root / "article_hard_r5").mkdir()
    (root / "article_hard_r5" / "pool").symlink_to(work.resolve(), target_is_directory=True)
    return work


def run_probes_stage(counters: dict, kernels: dict, smi: str, root: Path) -> None:
    """Phase 25: the research probes and debug scripts of ``tpuhar_torch.scripts`` on the
    card, under ``root`` (phase 24's tree, its ``bench_accuracy`` checkpoints read by (b)):
    (a) the resident drift, (b) the checkpoint rescoring, (c) the parity probe, the
    instrumented loop, the collapse and learning-rate probes and the coupling sweep on a
    fixture of their own, each JSON held to the JAX script's keys and finite numbers;
    the paths of (c) launch no hand kernel (``tiny_cnn``, an IMU encoder at Dh = 16)."""
    from tpuhar_torch.scripts import (
        debug_pretrain_loop,
        debug_pretrain_parity,
        probe_coupling_strength,
        probe_imu_hard_lr,
        probe_pretrain_collapse,
    )

    repo = Path(__file__).resolve().parent
    docs = sorted((str(p), p.stat().st_mtime_ns) for p in (repo / "docs").rglob("*")) if (repo / "docs").exists() else []
    t_phase = time.perf_counter()
    check_resident_drift(counters, kernels, smi)
    t_a = time.perf_counter() - t_phase
    check_ckpt_rescoring(counters, kernels, smi, root / "bench_accuracy")
    t_b = time.perf_counter() - t_phase - t_a

    fx = root / "probes"
    t0 = time.perf_counter()
    work = probe_fixture(fx)
    print(f"[probes] hard fixture (6 classes, {PROBE_SAMPLES} sequences a class and split) written and preprocessed in "
          f"{time.perf_counter() - t0:.1f} s")
    none = dict.fromkeys(counters, 0)

    parity, counts, seconds = drive_counted(counters, kernels, "probe_pretrain_parity", lambda: debug_pretrain_parity.run(
        PARITY_STEPS, fx / "article_hard_r5", device="cuda", out=fx / "docs" / "pretrain_parity.json"), none)
    arms = parity["arms"]
    wanted = {"cpu_f32", "cuda_default", "cuda_f32ctx", "cuda_highest", "cuda_pipe_faithful", "cuda_pipe_keys_cpuinit"}
    if set(parity) != {"bench", "steps", "arms"} or set(arms) != wanted or parity["steps"] != PARITY_STEPS:
        raise AssertionError(f"debug_pretrain_parity: {sorted(parity)}, arms {sorted(arms)}")
    for name, arm in arms.items():
        diag = "init_param_norm" if "pipe" in name else "grad_norm_step0"
        if set(arm) != {diag, "init_emb_std", "loss_first5", "loss_last5", "loss_final"} or len(arm["loss_first5"]) != PARITY_STEPS:
            raise AssertionError(f"debug_pretrain_parity {name}: {sorted(arm)}")
    finite_numbers(parity, "debug_pretrain_parity")
    ref = arms["cpu_f32"]
    gaps = {name: [round(a - b, 4) for a, b in zip(arm["loss_first5"], ref["loss_first5"])]
            for name, arm in arms.items() if name != "cpu_f32"}
    for name in ("cuda_f32ctx", "cuda_highest"):
        grad_gap = abs(arms[name]["grad_norm_step0"] - ref["grad_norm_step0"])
        if max(map(abs, gaps[name])) > PARITY_LOSS_ATOL or grad_gap > PARITY_GRAD_RTOL * ref["grad_norm_step0"]:
            raise AssertionError(f"debug_pretrain_parity: {name} left cpu_f32: loss gaps {gaps[name]}, gradient norm "
                                 f"{arms[name]['grad_norm_step0']} against {ref['grad_norm_step0']}")
    print(f"[probes] debug_pretrain_parity {PARITY_STEPS} steps in {seconds:.1f} s: cpu_f32 losses {ref['loss_first5']}, "
          f"gradient norm {ref['grad_norm_step0']}; each arm's loss gap to cpu_f32 {json.dumps(gaps)} (cuda_default: "
          f"TF32 convolutions); gradient norms "
          f"{ {n: a.get('grad_norm_step0', a.get('init_param_norm')) for n, a in arms.items()} }; launches none ({smi})")

    loop, _, seconds = drive_counted(counters, kernels, "probe_pretrain_loop",
                                     lambda: debug_pretrain_loop.run(fx / "article_hard_r5", device="cuda", epochs=1), none)
    if set(loop) != {"bench", "train", "val"} or len(loop["train"]) != 1 or len(loop["val"]) != 1:
        raise AssertionError(f"debug_pretrain_loop: {loop}")
    finite_numbers(loop, "debug_pretrain_loop")
    print(f"[probes] debug_pretrain_loop one epoch in {seconds:.1f} s: {json.dumps(loop)}; launches none")

    collapse, _, seconds = drive_counted(counters, kernels, "probe_pretrain_collapse", lambda: probe_pretrain_collapse.run(
        1, device="cuda", work=work, lrs=(2e-4,), out_root=fx / "probe_pt"), none)
    if set(collapse) != {"2e-04"} or set(collapse["2e-04"]) != {"perdim_std", "var_over_norm2", "sk_probe_heldout_bal"}:
        raise AssertionError(f"probe_pretrain_collapse: {collapse}")
    finite_numbers(collapse, "probe_pretrain_collapse")
    print(f"[probes] probe_pretrain_collapse lr 2e-4, one epoch, in {seconds:.1f} s: {json.dumps(collapse)}; launches none")

    lr, _, seconds = drive_counted(counters, kernels, "probe_imu_hard_lr", lambda: probe_imu_hard_lr.run(
        2, device="cuda", work=work, lrs=(1e-3,), out_root=fx / "probe_lr"), none)
    if set(lr) != {"finetune/1e-03"} or set(lr["finetune/1e-03"]) != {"train_acc_last5", "val_bal_last5", "test_bal"}:
        raise AssertionError(f"probe_imu_hard_lr: {lr}")
    finite_numbers(lr, "probe_imu_hard_lr")
    print(f"[probes] probe_imu_hard_lr lr 1e-3, two epochs, in {seconds:.1f} s: {json.dumps(lr)}; launches none")

    sweep, _, seconds = drive_counted(counters, kernels, "probe_coupling_strength", lambda: probe_coupling_strength.run(
        device="cuda", strengths=(8.0,), epochs=1, samples_per_class=COUPLING_SAMPLES, root=fx / "coupling_sweep",
        out=fx / "docs" / "coupling_strength.json"), none)
    keys = {"strength", "frames", "loss", "train_loss", "val_loss", "pairs", "retrieval_top1", "retrieval_top5", "chance",
            "emb_std_imu", "emb_std_video"}
    if (set(sweep) != {"bench", "epochs", "results"} or [r["loss"] for r in sweep["results"]] != ["siglip", "infonce"]
            or any(set(r) != keys for r in sweep["results"])):
        raise AssertionError(f"probe_coupling_strength: {sweep}")
    finite_numbers(sweep, "probe_coupling_strength")
    print(f"[probes] probe_coupling_strength strength 8, both losses, one epoch, in {seconds:.1f} s: "
          f"{json.dumps([{k: r[k] for k in ('loss', 'train_loss', 'val_loss', 'retrieval_top1', 'chance')} for r in sweep['results']])}"
          f"; launches none")
    for name in ("pretrain_parity.json", "coupling_strength.json"):
        if not (fx / "docs" / name).exists():
            raise AssertionError(f"{name} was not written under {fx / 'docs'}")
    after = sorted((str(p), p.stat().st_mtime_ns) for p in (repo / "docs").rglob("*")) if (repo / "docs").exists() else []
    if after != docs:
        raise AssertionError("the probes wrote under docs/")
    print(f"[probes] phase 25: {time.perf_counter() - t_phase:.1f} s ((a) {t_a:.1f}, (b) {t_b:.1f}, (c) "
          f"{time.perf_counter() - t_phase - t_a - t_b:.1f}); every JSON under {fx.relative_to(repo)} ({smi})")


def check_script_result(name: str, result, keys: set) -> int:
    """Fail unless ``result`` (a dict, or a list of dicts) has exactly ``keys``, every
    number in it is finite and, since every script here times at least one trial, no
    time or rate is null: the one null allowed is a ``util`` over a floor of 0 (the
    pool's). Returns how many numbers it holds."""
    rows = result if isinstance(result, list) else [result]
    if not rows or any(set(r) != keys for r in rows):
        raise AssertionError(f"{name}: keys {[sorted(r) for r in rows]}, expected {sorted(keys)}")

    def nulls(obj, path):
        if isinstance(obj, dict):
            return [p for k, v in obj.items() if k != "util" for p in nulls(v, f"{path}.{k}")]
        if isinstance(obj, list):
            return [p for i, v in enumerate(obj) for p in nulls(v, f"{path}[{i}]")]
        return [path] if obj is None else []

    missing = nulls(result, name)
    if missing:
        raise AssertionError(f"{name}: null at {missing} although {SCRIPT_TRIALS} trial(s) ran")
    return finite_numbers(result, name)


def check_int8_prefix(smi: str) -> None:
    """Phase 26: ``perf_int8_stages``' prefix 5 on ``INT8_CHECK_FRAMES`` patch-major
    frames is ``quant_tpucnn_forward_resident`` bit for bit, with the kernels and with
    their plain versions, and the kernels' program is the plain one's."""
    from tpuhar_torch.scripts import perf_int8_stages

    q = perf_int8_stages.build_tree("cuda")
    gen = torch.Generator(device="cuda").manual_seed(3)
    frames = torch.randint(0, 256, (INT8_CHECK_FRAMES, 14, 14, 768), generator=gen, device="cuda", dtype=torch.uint8)
    for what, scope in (("kernels", contextlib.nullcontext), ("plain versions", plain_int8_kernels)):
        with scope():
            got, want = perf_int8_stages.resident_prefix(q, frames, 5), quant_tpucnn_forward_resident(q, frames)
        if not torch.equal(got, want):
            raise AssertionError(f"perf_int8_stages prefix 5 ({what}) differs from quant_tpucnn_forward_resident by "
                                 f"{(got - want).abs().max().item():.3e}")
    equal_to_plain_kernels("perf_int8_stages prefix 5", lambda: perf_int8_stages.resident_prefix(q, frames, 5))
    print(f"[scripts] perf_int8_stages prefix 5 on {INT8_CHECK_FRAMES} frames is quant_tpucnn_forward_resident bit for "
          f"bit, with the kernels and with their plain versions ({smi})")


def check_floors(kernels: dict) -> None:
    """Phase 26: ``utils/roofline.analyze``'s resident floors at 4096 frames are phase
    3's bounds of the int8 conv (``s0b0a``) and the stem."""
    from tpuhar_torch.utils.roofline import analyze

    floors = {r["layer"]: r["floor_resident_ms"] for r in analyze(4096)}
    for layer, name in (("s0b0a", "conv3x3_i8"), ("stem", "stem_gemm_u8")):
        got, want = floors[layer], kernels[name]["bound_ms"]
        print(f"[scripts] roofline floor of {layer} at 4096 frames {got:.6f} ms, phase 3's {name} bound {want:.6f} ms")
        if round(got, 4) != round(want, 4) or abs(got - want) > FLOOR_RTOL * want:
            raise AssertionError(f"the roofline floor of {layer} {got} is not phase 3's {name} bound {want}")


def run_bench_scripts_stage(counters: dict, kernels: dict, smi: str, bench_root: Path) -> None:
    """Phase 26: the timing and decomposition scripts of ``tpuhar_torch.scripts``, each
    through its module's ``run`` on the card at full width (the cuts: batch, iterations,
    one trial, the fixtures, ``--min-windows``), with each hand kernel's launches per
    script. ``bench_serving_stream`` reads phase 24's ``bench_accuracy`` fixture under
    ``bench_root`` where it is there; its ``predict_stream`` logits equal its ``predict``
    logits. Every dict holds its keys, each number finite or null; the floors of
    ``utils/roofline`` are phase 3's bounds; prefix 5 of ``perf_int8_stages`` is the
    served int8 tower bit for bit."""
    from tpuhar_torch.scripts import (
        bench_loader,
        bench_preprocess,
        bench_serving_stream,
        bench_train,
        generate_tables,
        perf_decompose,
        perf_int8_stages,
        perf_nonvideo,
        perf_quant,
        perf_sweep,
        perf_tpucnn_variants,
        perf_trace,
        perf_vit_stages,
    )

    repo = Path(__file__).resolve().parent
    root = repo / "outputs" / "torch" / "chip_smoke_scripts"
    shutil.rmtree(root, ignore_errors=True)
    t_phase = time.perf_counter()
    print(f"[scripts] phase 26 cuts: one trial each; bench_train batch {BENCH_TRAIN_BATCH} ({BENCH_TRAIN_STEPS} steps); "
          f"bench_loader fixture {LOADER_FIXTURE}; bench_serving_stream {STREAM_ARGS} (fixture {STREAM_FIXTURE} where "
          f"phase 24's is gone); batch {SCRIPT_BATCH} and {SCRIPT_ITERS} steps for perf_decompose, perf_nonvideo, "
          f"perf_quant, perf_tpucnn_variants and perf_trace; perf_int8_stages {INT8_STAGE_FRAMES} frames; "
          f"perf_vit_stages batch {VIT_STAGE_BATCH} ({VIT_STAGE_ITERS} steps); perf_sweep {SWEEP_VARIANTS}; widths full")
    check_floors(kernels)
    check_int8_prefix(smi)
    trials = dict(trials=SCRIPT_TRIALS)
    flagship = dict(cpu=False, iters=SCRIPT_ITERS, **trials)
    stream_keys = {"bench", "tower", "int8", "batch", "depth", "windows", "host_feed_rate", "upload_rate", "upload_mb_s",
                   "chip_only_rate", "compute_rate_est", "sequential_rate", "stream_rate", "overlap_gain", "bound",
                   "platform"}
    streams = {}

    def serving_stream(extra):
        out = {}
        args = bench_serving_stream.parse_args([*STREAM_ARGS, "--root", str(root / "bench_serving_stream"),
                                                "--reuse-fixture", str(bench_root), *extra])
        result = bench_serving_stream.run(args, fixture_size=STREAM_FIXTURE, outputs=out, **trials)
        streams[tuple(extra)] = out
        return result

    plan = [
        ("bench_train", lambda: bench_train.run(BENCH_TRAIN_BATCH, steps=BENCH_TRAIN_STEPS, **trials),
         {"bench", "batch", "device", "steps"}, ()),
        ("bench_preprocess", lambda: bench_preprocess.run(**trials),
         {"bench", "sequences", "windows", "device", "host", "device_batched"}, ()),
        ("bench_loader", lambda: bench_loader.run(**LOADER_FIXTURE, **trials),
         {"bench", "windows", "device", "fixture", "imu_windows_per_s", "clips_per_s"}, ()),
        ("bench_serving_stream", lambda: serving_stream([]), stream_keys, ("fused_window", "conv3x3_bn_act")),
        ("bench_serving_stream_int8", lambda: serving_stream(["--int8"]), stream_keys,
         ("fused_window", "stem_gemm_u8", "conv3x3_i8")),
        ("perf_decompose", lambda: perf_decompose.run(SCRIPT_BATCH, **flagship), {"bench", "batch", "device", "ms"},
         ("fused_window", "conv3x3_bn_act")),
        ("perf_nonvideo", lambda: perf_nonvideo.run(SCRIPT_BATCH, **flagship), {"bench", "batch", "ms"},
         ("fused_window",)),
        ("perf_quant", lambda: perf_quant.run(SCRIPT_BATCH, **flagship),
         {"bench", "batch", "device", "bf16_ms", "int8_ms", "bf16_inf_per_s", "int8_inf_per_s", "speedup"},
         ("fused_window", "conv3x3_bn_act", "stem_gemm_u8", "conv3x3_i8")),
        ("perf_int8_stages", lambda: perf_int8_stages.run(INT8_STAGE_FRAMES, iters=SCRIPT_ITERS, **trials),
         {"bench", "frames_per_step", "cumulative_ms", "stages"}, ("stem_gemm_u8", "conv3x3_i8")),
        ("perf_vit_stages", lambda: perf_vit_stages.run(VIT_STAGE_BATCH, iters=VIT_STAGE_ITERS, **trials),
         {"bench", "batch", "device", "null_ms", "units_ms", "floors_ms", "model_est_ms", "model_floor_ms",
          "full_model_ms"}, ()),
        ("perf_sweep", lambda: perf_sweep.run(SWEEP_VARIANTS, iters=SCRIPT_ITERS, **trials),
         {"backbone", "batch", "throughput", "step_ms", "build_s"}, ("fused_window",)),
        ("perf_tpucnn_variants", lambda: perf_tpucnn_variants.run(batch=SCRIPT_BATCH, iters=SCRIPT_ITERS, **trials),
         {"widths", "backbone", "step_ms", "inf_per_s"}, ("fused_window", "conv3x3_bn_act")),
        ("perf_trace", lambda: perf_trace.run(batch=SCRIPT_BATCH, logdir=root / "perf_trace"),
         {"bench", "backbone", "batch", "steps", "trace", "device", "device_ms", "ops", "busy", "top"},
         ("fused_window", "conv3x3_bn_act")),
    ]
    timings = {}
    for name, run, keys, launched in plan:
        result, counts, seconds = drive_counted(counters, kernels, f"script_{name}", run, {})
        n = check_script_result(name, result, keys)
        missing = [k for k in launched if not counts[k]]
        if missing:
            raise AssertionError(f"{name}: {missing} never launched ({counts})")
        timings[name] = seconds
        shown = result
        if isinstance(result, dict) and "top" in result:  # the trace's five longest ops by name and time
            shown = {**result, "top": [(r["name"][:60], r["ms"], r["launches"]) for r in result["top"][:5]]}
        print(f"[scripts] {name} in {seconds:.1f} s, {n} finite numbers: {json.dumps(shown)}; launches "
              f"{ {k: v for k, v in counts.items() if v} } ({smi})")
    for extra, out in streams.items():
        if not out["stream"] or len(out["stream"]) != len(out["sequential"]) or not all(
                np.array_equal(a, b) for a, b in zip(out["stream"], out["sequential"])):
            raise AssertionError(f"bench_serving_stream {list(extra)}: predict_stream's logits differ from predict's")
        print(f"[scripts] bench_serving_stream {list(extra)}: predict_stream's logits equal predict's in each of "
              f"{len(out['stream'])} batches")
    trace = root / "perf_trace" / "trace.json"
    if not trace.exists() or trace.stat().st_size == 0:
        raise AssertionError(f"perf_trace wrote no trace at {trace}")
    tables, _, _ = drive_counted(counters, kernels, "script_generate_tables", lambda: generate_tables.main(
        ["--demo", "--results-dir", str(root / "tables")]), dict.fromkeys(counters, 0))
    csvs = sorted(p.name for p in (root / "tables").glob("demo_*.csv"))
    if csvs != sorted(f"demo_{t}.csv" for t in tables):
        raise AssertionError(f"generate_tables --demo wrote {csvs}")
    print(f"[scripts] generate_tables --demo: {csvs}")
    shutil.rmtree(root, ignore_errors=True)
    print(f"[scripts] phase 26: {time.perf_counter() - t_phase:.1f} s "
          f"({', '.join(f'{k} {v:.1f}' for k, v in timings.items())}) ({smi})")


def run_dryrun_stage(kernels: dict, smi: str) -> None:
    """Phase 27: ``entry.dryrun_multichip(DRYRUN_RANKS)`` on the card. The ranks share
    cuda:0 over gloo; each runs the ``(2, 2)`` mesh and then the pure-dp ``(4, 1)`` mesh:
    the fully sharded fusion train step at the tiny sizes in f32 (no hand kernel: the
    IMU arrives featurized, the ``videomae_tiny`` tower runs without flash), then the
    ``tpu_cnn`` bf16 engine (one featurizer and 4 fused convs a forward, at 2² and 1²
    maps) and the int8 engine (the featurizer, the uint8 stem, the int8 conv, and the f32
    conv in its recalibration's f32 forward), the int8 logits within 1e-5 of an engine's
    without a mesh. Each rank starts its counts
    at 0; each part's launches are summed over the ranks and the meshes. Fails if a
    kernel of the serve pass was not launched, or if the bf16 engine's count is not its
    eager warm-up's and its capture's."""
    t0 = time.perf_counter()
    ranks = dryrun_multichip(DRYRUN_RANKS)
    seconds = time.perf_counter() - t0
    parts = {"train": "dryrun_train", "bf16": "dryrun_bf16", "int8": "dryrun_int8"}
    totals = {path: dict.fromkeys(kernels, 0) for path in parts.values()}
    for r in ranks:
        if not r["device"].startswith("cuda"):
            raise AssertionError(f"dryrun rank {r['rank']} ran on {r['device']}")
        for m in r["meshes"]:
            for part, path in parts.items():
                for name, n in m["launches"][part].items():
                    totals[path][name] += n
            want = {**dict.fromkeys(kernels, 0), "fused_window": 2, "conv3x3_bn_act": 8}
            if m["launches"]["bf16"] != want:
                raise AssertionError(f"dryrun rank {r['rank']} mesh {m['mesh']}: bf16 engine launches "
                                     f"{m['launches']['bf16']}, expected {want}")
    for path, counts in totals.items():
        for name, n in counts.items():
            kernels[name].setdefault("launches_by_path", {})[path] = n
    needed = {"dryrun_bf16": ("fused_window", "conv3x3_bn_act"),
              "dryrun_int8": ("fused_window", "stem_gemm_u8", "conv3x3_i8", "conv3x3_bn_act_f32")}
    missing = [(path, name) for path, names in needed.items() for name in names if totals[path][name] <= 0]
    if missing:
        raise AssertionError(f"dryrun: kernels not launched {missing}")
    for i, m in enumerate(ranks[0]["meshes"]):
        gap = max(r["meshes"][i]["int8_gap"] for r in ranks)
        print(f"[dryrun] mesh {m['mesh']}: train loss {m['loss']:.6f} at batch {m['batch']} (every rank); int8 "
              f"sharded against one device's logits, largest gap over the ranks {gap:.3e}")
    print(f"[dryrun] phase 27: dryrun_multichip({DRYRUN_RANKS}) on cuda:0 over gloo in {seconds:.1f} s; launches "
          f"summed over ranks and meshes {json.dumps(totals)} ({smi})")


def run_f32_flagship_stage(counters: dict, kernels: dict, smi: str) -> dict:
    """Phase 28: the f32 flagship served at full width under ``full_f32()`` (the stem GEMM
    and ``down1`` in f32 too): ``build_forward`` eagerly and ``InferenceEngine``'s graphs at
    F32_FLAGSHIP_SIZES, each forward 1 featurizer, 4 f32 fused convs and no bf16 one;
    logits, MSP, energy and embeddings against the same program with the fused convs on
    their plain version, the replay and eager ms of both programs; then the int8-resident
    build of the same configuration (its logit recalibration runs the f32 tower). Every
    launch count is set to 0 just before each path and read just after it."""
    t_phase = time.perf_counter()
    cfg = flagship_config("float32")
    params = init_params(cfg, torch.Generator().manual_seed(0))
    forward = {**dict.fromkeys(counters, 0), **F32_FLAGSHIP_FORWARD}
    plain = {**forward, "conv3x3_bn_act_f32": 0}
    result = {}
    with full_f32():
        fn, _ = build_forward(cfg, F32_FLAGSHIP_SIZES[0], device="cuda", params=params)
        gen = torch.Generator(device="cuda").manual_seed(28)
        for b in F32_FLAGSHIP_SIZES:
            imu = torch.randn((b, 250, 6), generator=gen, device="cuda") * 8000.0
            video = torch.randint(0, 256, (b, 16, 14, 14, 768), generator=gen, device="cuda", dtype=torch.uint8)
            got, _, _ = drive_counted(counters, kernels, f"f32_eager_{b}", lambda: fn(imu, video), forward)
            with plain_fused_convs():
                want, _, _ = drive_counted(counters, kernels, f"f32_plain_{b}", lambda: fn(imu, video), plain)
            shapes = {"logits": (b, cfg.model.num_classes), "msp": (b,), "energy": (b,),
                      "embeddings": (b, 2 * cfg.model.imu_d_model)}
            gaps = {}
            for key, shape in shapes.items():
                if tuple(got[key].shape) != shape or not torch.isfinite(got[key]).all():
                    raise AssertionError(f"f32 flagship batch {b}: {key} {tuple(got[key].shape)} not finite {shape}")
                gaps[key] = ((got[key] - want[key]).abs().max() / want[key].abs().max()).item()
            print(f"[f32 flagship] batch {b}: eager forward with 1 featurizer, 4 f32 fused convs and no bf16 conv; "
                  f"against the plain-conv program, max |diff| / max |plain| {json.dumps(gaps)}")
            bad = {key: gap for key, gap in gaps.items() if not gap <= F32_FLAGSHIP_RTOL}
            if bad:
                raise AssertionError(f"f32 flagship batch {b}: outputs beyond {F32_FLAGSHIP_RTOL} of the plain-conv "
                                     f"program: {bad}")
            del got, want, imu, video

        timings = {}
        for path, scope, expected in (("engine_f32", contextlib.nullcontext, forward),
                                      ("engine_f32_plain", plain_fused_convs, plain)):
            with scope():
                engine = InferenceEngine(cfg, params, batch_sizes=F32_FLAGSHIP_SIZES, device="cuda")
                requests = [engine_request(280, F32_FLAGSHIP_SIZES[0], cfg),
                            engine_request(281, F32_FLAGSHIP_SIZES[0] + 1, cfg)]  # the graph of each size
                check_graph_replay(path, engine, requests, counters, kernels, expected)
                for b in engine.batch_sizes:
                    iters = ENGINE_TIMING_ITERS[b]
                    inputs = engine._graphs[b].inputs
                    replay_ms = cuda_ms(lambda: engine._replay(b), iters)
                    eager_ms = cuda_ms(lambda: engine._forward(*inputs), iters)
                    timings.setdefault(path, {})[b] = {"replay_ms": replay_ms, "eager_ms": eager_ms}
                    print(f"[{path}] batch {b}: graph replay {replay_ms:.3f} ms ({b / replay_ms * 1e3:.1f} inf/s), "
                          f"eager forward {eager_ms:.3f} ms on the graph's inputs ({smi})")
            del engine
            torch.cuda.empty_cache()
        result["timings"] = timings

        H, W = cfg.data.video_resize
        calib = (np.random.default_rng(0).random((2, cfg.data.video_frames_per_window, H, W, 3)) * 255).astype(np.uint8)
        fn8, counts, seconds = drive_counted(
            counters, kernels, "f32_int8_build",
            lambda: build_int8_forward(cfg, 8, device="cuda", params=params, calib_clips=calib, resident=True)[0],
            {"conv3x3_bn_act_f32": 4, "conv3x3_bn_act": 0})
        result["int8_build"] = {"seconds": seconds, **fn8.build_seconds, "conv3x3_bn_act_f32": counts["conv3x3_bn_act_f32"]}
        print(f"[f32 flagship] build_quantized_forward(resident=True) on the f32 configuration in {seconds:.1f} s "
              f"(calibration {fn8.build_seconds['calibration']:.1f} s on the CPU, recalibration "
              f"{fn8.build_seconds['recalibration']:.1f} s on the card); launches {counts}")
        del fn8
    result["seconds"] = time.perf_counter() - t_phase
    print(f"[f32 flagship] phase 28: {result['seconds']:.1f} s ({smi})")
    return result


def f32_vit_steps(cfg, params, batches: list, seed: int) -> tuple:
    """``(losses, gradient norms before the clip, ms a step)`` of ``cfg``'s train steps on
    ``batches`` in turn from ``params``, dropout and augmentation from a card generator of
    ``seed``."""
    task = build_pretrain_task(cfg, device="cuda", params=params, steps_per_epoch=len(batches))
    gen = torch.Generator(device="cuda").manual_seed(seed)
    losses, norms, step_ms = [], [], []
    for batch in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, metrics = task.train_step(task.state, batch, gen)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(metrics["loss"].item())
        grads = [p.grad for p in task.state.optimizer.params if p.grad is not None]
        norms.append(torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads))).item())
    del task
    torch.cuda.empty_cache()
    return losses, norms, step_ms


def run_f32_vit_stage(counters: dict, kernels: dict, smi: str) -> dict:
    """Phase 29: the f32 ViT with flash at full width. Served under ``full_f32()``:
    ``build_forward`` eagerly and ``InferenceEngine(fast_attention=True)``'s graphs at
    ``ENGINE_SIZES["engine_vit"]``, each forward 1 featurizer, 12 f32 flash launches and
    no bf16 one; logits, MSP, energy and embeddings against the same program with flash
    off (plain f32 attention); the replay and eager ms of both programs. Pretrained in
    f32 under ``precision_scope("float32")`` (the train step's own): F32_VIT_STEPS steps
    at PRETRAIN_BATCH with 12 launches of each f32 flash kernel a step, their ms, samples/s
    and peak memory; then the same steps at F32_VIT_CHECK_BATCH with flash on, and with
    flash off in f32 and in float64, from the same parameters, batches and generator,
    each flash step's loss and gradient norm held to the float64 step's. Every launch
    count is set to 0 just before each path and read just after it."""
    t_phase = time.perf_counter()
    cfg = vit_config("float32")
    cfg_plain = copy.deepcopy(cfg)
    cfg_plain.model.use_flash_attention = False
    depth = VIT_CONFIGS[cfg.model.video_backbone][0]
    params = init_params(cfg, torch.Generator().manual_seed(0))
    forward = {**dict.fromkeys(counters, 0), "fused_window": 1, "flash_lean_f32": depth}
    plain = {**forward, "flash_lean_f32": 0}
    sizes = ENGINE_SIZES["engine_vit"]
    result = {}
    with full_f32():
        fn, _ = build_forward(cfg, sizes[0], device="cuda", params=params)
        fn_plain, _ = build_forward(cfg_plain, sizes[0], device="cuda", params=params)
        gen = torch.Generator(device="cuda").manual_seed(29)
        d = cfg.data
        for b in sizes:
            imu = torch.randn((b, d.imu_window_size, d.imu_channels), generator=gen, device="cuda") * 8000.0
            video = torch.randint(0, 256, (b, d.video_frames_per_window, *d.video_resize, 3), generator=gen,
                                  device="cuda", dtype=torch.uint8)
            got, _, _ = drive_counted(counters, kernels, f"vit_f32_eager_{b}", lambda: fn(imu, video), forward)
            want, _, _ = drive_counted(counters, kernels, f"vit_f32_plain_{b}", lambda: fn_plain(imu, video), plain)
            shapes = {"logits": (b, cfg.model.num_classes), "msp": (b,), "energy": (b,),
                      "embeddings": (b, 2 * cfg.model.imu_d_model)}
            gaps = {}
            for key, shape in shapes.items():
                if tuple(got[key].shape) != shape or got[key].dtype != torch.float32 or not torch.isfinite(got[key]).all():
                    raise AssertionError(f"f32 ViT batch {b}: {key} {tuple(got[key].shape)} {got[key].dtype} not "
                                         f"finite f32 {shape}")
                gaps[key] = ((got[key] - want[key]).abs().max() / want[key].abs().max()).item()
            print(f"[f32 vit] batch {b}: eager forward with 1 featurizer, {depth} f32 flash launches and no bf16 one; "
                  f"against the flash-off program, max |diff| / max |plain| {json.dumps(gaps)}")
            bad = {key: gap for key, gap in gaps.items() if not gap <= F32_FLAGSHIP_RTOL}
            if bad:
                raise AssertionError(f"f32 ViT batch {b}: outputs beyond {F32_FLAGSHIP_RTOL} of the flash-off "
                                     f"program: {bad}")
            del got, want, imu, video
        del fn, fn_plain
        torch.cuda.empty_cache()

        timings = {}
        for path, c, expected in (("engine_vit_f32", cfg, forward), ("engine_vit_f32_plain", cfg_plain, plain)):
            engine = InferenceEngine(c, params, batch_sizes=sizes, fast_attention=c.model.use_flash_attention,
                                     device="cuda")
            requests = [engine_request(290, sizes[0], cfg), engine_request(291, sizes[0] + 1, cfg)]
            check_graph_replay(path, engine, requests, counters, kernels, expected)
            for b in engine.batch_sizes:
                iters = F32_VIT_TIMING_ITERS[b]
                inputs = engine._graphs[b].inputs
                replay_ms = cuda_ms(lambda: engine._replay(b), iters, warmup=1)
                eager_ms = cuda_ms(lambda: engine._forward(*inputs), iters, warmup=1)
                timings.setdefault(path, {})[b] = {"replay_ms": replay_ms, "eager_ms": eager_ms}
                print(f"[{path}] batch {b}: graph replay {replay_ms:.3f} ms ({b / replay_ms * 1e3:.1f} inf/s), "
                      f"eager forward {eager_ms:.3f} ms on the graph's inputs ({smi})")
            del engine
            torch.cuda.empty_cache()
        result["timings"] = timings

    cfg_pt = pretrain_config()
    cfg_pt.model.compute_dtype = "float32"
    if cfg_pt.training.pretrain_matmul_precision != "float32":
        raise AssertionError(f"pretraining precision {cfg_pt.training.pretrain_matmul_precision!r}, not float32")
    params_pt = init_params(cfg_pt, torch.Generator().manual_seed(0), CrossModalModel)
    batches = pretrain_batches(cfg_pt, F32_VIT_STEPS, PRETRAIN_BATCH, seed=292)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    per_step = {"flash_lean_f32": depth, "flash_bwd_dq_f32": depth, "flash_bwd_dkv_f32": depth}
    (losses, norms, step_ms), counts, seconds = drive_counted(
        counters, kernels, "vit_f32_pretrain", lambda: f32_vit_steps(cfg_pt, params_pt, batches, seed=29),
        {**dict.fromkeys(counters, 0), **{name: F32_VIT_STEPS * n for name, n in per_step.items()}})
    peak = torch.cuda.max_memory_allocated() / 2**30
    steady = float(np.mean(step_ms[1:]))
    if not np.all(np.isfinite(losses)):
        raise AssertionError(f"f32 pretraining: losses {losses}")
    print(f"[f32 vit pretrain] {F32_VIT_STEPS} steps of batch {PRETRAIN_BATCH} in f32 with flash: ms a step "
          f"{', '.join(f'{t:.1f}' for t in step_ms)} (the first builds and allocates); after the first "
          f"{steady:.3f} ms, {PRETRAIN_BATCH / steady * 1e3:.2f} samples/s; peak memory {peak:.2f} GiB; losses "
          f"{losses}; launches {counts} ({smi})")
    result["pretrain"] = {"step_ms": step_ms, "steady_ms": steady, "peak_gib": peak, "losses": losses}

    small = [{key: t[:F32_VIT_CHECK_BATCH] for key, t in batch.items()} for batch in batches]
    cfg_pt_plain = copy.deepcopy(cfg_pt)
    cfg_pt_plain.model.use_flash_attention = False
    cfg_pt_f64 = copy.deepcopy(cfg_pt_plain)
    cfg_pt_f64.model.compute_dtype = "float64"
    arms = {}
    for path, c, expected in (
        ("vit_f32_pretrain_check", cfg_pt, {name: F32_VIT_STEPS * n for name, n in per_step.items()}),
        ("vit_f32_pretrain_plain", cfg_pt_plain, {}),
        ("vit_f64_pretrain_plain", cfg_pt_f64, {}),
    ):
        (losses, norms, _), _, _ = drive_counted(counters, kernels, path, lambda: f32_vit_steps(c, params_pt, small, 30),
                                                 {**dict.fromkeys(counters, 0), **expected})
        arms[path] = (losses, norms)
    exact = arms["vit_f64_pretrain_plain"]
    gaps = {path: ([abs(a - b) / abs(b) for a, b in zip(losses, exact[0])],
                   [abs(a - b) / abs(b) for a, b in zip(norms, exact[1])])
            for path, (losses, norms) in arms.items() if path != "vit_f64_pretrain_plain"}
    pair = ([abs(a - b) / abs(b) for a, b in zip(arms["vit_f32_pretrain_check"][0], arms["vit_f32_pretrain_plain"][0])],
            [abs(a - b) / abs(b) for a, b in zip(arms["vit_f32_pretrain_check"][1], arms["vit_f32_pretrain_plain"][1])])
    fmt = lambda xs: ", ".join(f"{x:.3e}" for x in xs)  # noqa: E731
    print(f"[f32 vit pretrain] batch {F32_VIT_CHECK_BATCH}, {F32_VIT_STEPS} steps: losses / gradient norms with flash "
          f"(f32 kernels) {arms['vit_f32_pretrain_check']}, flash off in f32 {arms['vit_f32_pretrain_plain']}, flash "
          f"off in float64 {exact}")
    print(f"[f32 vit pretrain] relative to the float64 steps: with flash loss {fmt(gaps['vit_f32_pretrain_check'][0])}, "
          f"gradient norm {fmt(gaps['vit_f32_pretrain_check'][1])}; flash off in f32 loss "
          f"{fmt(gaps['vit_f32_pretrain_plain'][0])}, gradient norm {fmt(gaps['vit_f32_pretrain_plain'][1])}; "
          f"flash on against off, both f32: loss {fmt(pair[0])}, gradient norm {fmt(pair[1])}")
    loss_gaps, norm_gaps = gaps["vit_f32_pretrain_check"]
    if not max(loss_gaps) <= F32_VIT_LOSS_RTOL or not max(norm_gaps) <= F32_VIT_GRAD_RTOL:
        raise AssertionError(f"f32 pretraining with flash against the float64 steps: loss gaps {loss_gaps} (bound "
                             f"{F32_VIT_LOSS_RTOL}), gradient-norm gaps {norm_gaps} (bound {F32_VIT_GRAD_RTOL})")
    result["pretrain_check"] = {"against_float64": gaps, "flash_on_against_off_f32": pair}
    result["seconds"] = time.perf_counter() - t_phase
    print(f"[f32 vit] phase 29: {result['seconds']:.1f} s ({smi})")
    return result


def run_pretrain_stage(counters: dict, kernels: dict, smi: str, phases: set) -> dict:
    """Phases 13-15: cross-modal pretraining at full width and depth over one epoch
    (13), the train step's time (15) and its first step against the plain path (14),
    each where ``phases`` holds it. Returns the drawn parameters (phases 18 and 20 start
    from them)."""
    cfg_pt = pretrain_config()
    cfg_pt.training.pretrain_epochs = PRETRAIN_EPOCHS
    t0 = time.perf_counter()
    params_pt = init_params(cfg_pt, torch.Generator().manual_seed(0), CrossModalModel)
    task = build_pretrain_task(cfg_pt, device="cuda", params=params_pt, steps_per_epoch=PRETRAIN_TRAIN_BATCHES)
    print(f"[pretrain] videomae_base cross-modal model built (weights drawn on the host, f32 masters on the "
          f"card): {time.perf_counter() - t0:.1f} s")
    train_batches = pretrain_batches(cfg_pt, PRETRAIN_TRAIN_BATCHES, PRETRAIN_BATCH, seed=300)
    val_batches = pretrain_batches(cfg_pt, 1, PRETRAIN_BATCH, seed=301)
    initial = {n: p.detach().clone() for n, p in task.model.named_parameters()}
    save_dir = Path(__file__).resolve().parent / "tpuhar_torch" / "_build" / "chip_smoke_pretrain"
    shutil.rmtree(save_dir, ignore_errors=True)
    trainer = CrossModalTrainer(cfg_pt, task.state, task.train_step, task.eval_step, save_dir,
                                generator=torch.Generator(device="cuda").manual_seed(0))
    for counter in counters.values():
        counter.launches = 0
    t0 = time.perf_counter()
    trainer.fit(train_batches, val_batches)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    counts = {name: counter.launches for name, counter in counters.items()}
    for name, n in counts.items():
        kernels[name].setdefault("launches_by_path", {})["pretrain"] = n
    depth = VIT_CONFIGS[cfg_pt.model.video_backbone][0]
    forwards = PRETRAIN_TRAIN_BATCHES + len(val_batches)
    expected = {"flash_lean": depth * forwards, "flash_bwd_dkv": depth * PRETRAIN_TRAIN_BATCHES,
                "flash_bwd_dq": depth * PRETRAIN_TRAIN_BATCHES, "fused_window": 0, "conv3x3_bn_act": 0,
                "stem_gemm_u8": 0, "conv3x3_i8": 0}
    history = trainer.history
    print(f"[pretrain] fit: {PRETRAIN_TRAIN_BATCHES} train steps of batch {PRETRAIN_BATCH} and "
          f"{len(val_batches)} validation batch in {fit_s:.1f} s (first steps included); train loss "
          f"{history['train']}, val loss {history['val']}; launches {counts}")
    for name, n in expected.items():
        if counts[name] != n:
            raise AssertionError(f"pretrain: {name} launched {counts[name]} times, expected {n}")
    losses = history["train"] + history["val"]
    if len(losses) != 2 * PRETRAIN_EPOCHS or not np.all(np.isfinite(losses)):
        raise AssertionError(f"pretrain: losses {history}")
    still = [n for n, p in task.model.named_parameters() if torch.equal(p, initial[n])]
    if still:
        raise AssertionError(f"pretrain: {len(still)} parameters did not move: {still}")
    print(f"[pretrain] all {len(initial)} parameters moved; optimizer at step {task.state.optimizer.count}")
    del initial
    for name in ("last", "best_model"):
        for suffix in (".pt", ".json"):
            if not (save_dir / name).with_suffix(suffix).exists():
                raise AssertionError(f"pretrain: checkpoint {name}{suffix} was not written")
    restored = build_pretrain_task(cfg_pt, device="cuda", params=params_pt, steps_per_epoch=PRETRAIN_TRAIN_BATCHES)
    _, extra = restore_checkpoint(save_dir / "last", restored.state)
    trained = task.model.state_dict()
    differ = [n for n, t in restored.model.state_dict().items() if not torch.equal(t, trained[n])]
    if differ or restored.state.step != task.state.step or restored.state.optimizer.count != task.state.optimizer.count:
        raise AssertionError(f"pretrain: the restored checkpoint differs at {differ}")
    print(f"[pretrain] checkpoint 'last' (epoch {extra['epoch']}, best val loss {extra['best_val_loss']:.6f}) "
          f"restored: every parameter, buffer and the optimizer's step equal")
    del restored, trained
    shutil.rmtree(save_dir, ignore_errors=True)

    small = {key: t[:PRETRAIN_CHECK_BATCH] for key, t in train_batches[0].items()}
    if 15 in phases:
        gen_dropout = torch.Generator(device="cuda").manual_seed(1)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for i in range(PRETRAIN_TIMED_STEPS):
            task.train_step(task.state, train_batches[i % len(train_batches)], gen_dropout)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) / PRETRAIN_TIMED_STEPS * 1e3
        print(f"[timing] pretrain train step batch {PRETRAIN_BATCH}: {step_ms:.3f} ms, "
              f"{PRETRAIN_BATCH / step_ms * 1e3:.1f} samples/s, peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({smi})")
    del task, trainer, train_batches, val_batches
    torch.cuda.empty_cache()
    if 14 in phases:
        check_first_step(cfg_pt, params_pt, small)
    del small
    torch.cuda.empty_cache()
    return params_pt



def check_physical_windows(counters: dict, kernels: dict, smi: str) -> None:
    """Phase 30 (a): ``featurize_windows(already_physical=True)`` on windows already in g
    and deg/s (``raw_to_physical`` of seeded raw counts at each of ``FEATURIZE_BATCHES``)
    equals the default path on the raw counts bit for bit; the fused kernel on the same
    physical windows with ``racc = rgyro = 1.0`` (a multiply by exactly 1.0) within
    ``FEATURIZE_ATOL`` of it, its launches counted on the path ``physical_windows``."""
    d = pretrain_config().data
    kw = dict(kernel_size=d.median_filter_kernel, normalize=d.normalize_imu)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def run():
        errors = {}
        for batch in FEATURIZE_BATCHES:
            raw = torch.randn((batch, d.imu_window_size, d.imu_channels), generator=gen, device="cuda") * 8000.0
            phys = raw_to_physical(raw, d.Racc, d.Rgyro)
            plain = featurize_windows(phys, already_physical=True, **kw)
            default = featurize_windows(raw, racc=d.Racc, rgyro=d.Rgyro, **kw)
            if not torch.equal(plain, default):
                raise AssertionError(f"already_physical at {batch} windows differs from the default path by up to "
                                     f"{(plain - default).abs().max().item():.3e}")
            fused = featurize_windows_auto(phys, racc=1.0, rgyro=1.0, **kw)
            errors[batch] = (fused - plain).abs().max().item()
        return errors

    errors, counts, seconds = drive_counted(counters, kernels, "physical_windows", run, {
        **dict.fromkeys(counters, 0), "fused_window": len(FEATURIZE_BATCHES)})
    print(f"[physical windows] featurize_windows(already_physical=True) equals the default path on the raw counts "
          f"bit for bit at {', '.join(map(str, FEATURIZE_BATCHES))} windows of (250, 6) f32; the fused kernel with "
          f"racc = rgyro = 1.0 on the physical windows against it, max abs err "
          f"{', '.join(f'{e:.3e}' for e in errors.values())} (tolerance {FEATURIZE_ATOL}); {seconds:.2f} s; "
          f"launches {counts} ({smi})")
    if not max(errors.values()) <= FEATURIZE_ATOL:
        raise AssertionError(f"the fused kernel on physical windows: {errors} > {FEATURIZE_ATOL}")


def check_fuse_with_tokens(counters: dict, kernels: dict, smi: str) -> dict:
    """Phase 30 (b): ``FusionClassifier.fuse_with_tokens(train=True)`` at phase 17's width
    (``pretrain_config()``'s ``videomae_base`` fusion classifier through
    ``build_fusion_task``: bf16 with f32 masters, batch 16, 224², 16 frames, the IMU
    windows through the fused featurizer). The video tokens of ``video_encoder(video,
    train=True)`` (the flash forward with its LSE) go through ``forward_cast(...,
    method="fuse_with_tokens", train=True, generator=g)``; against ``forward(imu, video,
    train=True, generator=g')`` from the same state, ``g`` and ``g'`` seeded alike: the
    logits, the fused embedding, the moved statistics and the cross-entropy gradient of
    every IMU-encoder, fusion and head parameter bit for bit. Another seed gives other
    logits (dropout is live), and the default call equals the eval ``_fuse`` and the eval
    forward. Then the forward + backward of ``fuse_with_tokens(train=True)`` timed."""
    cfg = pretrain_config()
    depth = VIT_CONFIGS[cfg.model.video_backbone][0]
    precision = cfg.training.pretrain_matmul_precision
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator().manual_seed(0), FusionClassifier)
    model = build_fusion_task(cfg, device="cuda", params=params, steps_per_epoch=1).model
    del params
    print(f"[fuse tokens] {cfg.model.video_backbone} fusion classifier built (weights drawn on the host, f32 "
          f"masters on the card): {time.perf_counter() - t0:.1f} s")
    initial = {n: b.clone() for n, b in model.named_buffers()}
    compared = [n for n, _ in model.named_parameters() if not n.startswith("video_encoder.")]

    def train_pass(method: str, inputs: tuple, labels, seed: int) -> tuple:
        """One cross-entropy forward and backward through ``method`` from the initial
        statistics: (outputs, moved buffers, gradients of the compared parameters)."""
        model.zero_grad(set_to_none=True)
        with torch.no_grad():
            for n, b in model.named_buffers():
                b.copy_(initial[n])
        gen = torch.Generator(device="cuda").manual_seed(seed)
        with precision_scope(precision):
            logits, fused = model.forward_cast(*inputs, method=method, train=True, generator=gen)
            cross_entropy_loss(logits, labels).backward()
        grads = dict(model.named_parameters())
        return ({"logits": logits.detach().cpu(), "fused": fused.detach().cpu()},
                {n: b.cpu() for n, b in model.named_buffers()}, {n: grads[n].grad.cpu() for n in compared})

    def run():
        batch = classify_batches(cfg, 1, FUSE_TOKENS_BATCH, seed=FUSE_TOKENS_SEED, video=True)[0]
        imu, labels, video = batch["imu"], batch["label"], normalize_clip(batch["video"])
        with precision_scope(precision):
            tokens = model.forward_cast(video, method="video_encoder", train=True)[1].detach()
        whole = train_pass("forward", (imu, video), labels, FUSE_TOKENS_SEED)
        split = train_pass("fuse_with_tokens", (imu, tokens), labels, FUSE_TOKENS_SEED)
        other = train_pass("fuse_with_tokens", (imu, tokens), labels, FUSE_TOKENS_SEED + 1)[0]["logits"]
        with torch.no_grad(), precision_scope(precision):
            eval_tokens = model.forward_cast(video, method="video_encoder")[1]
            imu_tokens = model.forward_cast(imu, method="imu_encoder")[1]
            default = model.forward_cast(imu, eval_tokens, method="fuse_with_tokens")
            fuse = model.forward_cast(imu_tokens, eval_tokens, method="_fuse")
            forward = model.forward_cast(imu, video)
        return imu, labels, tokens, whole, split, other, default, fuse, forward

    (imu, labels, tokens, whole, split, other, default, fuse, forward), counts, seconds = drive_counted(
        counters, kernels, "fuse_with_tokens", run, {
            **dict.fromkeys(counters, 0), "fused_window": 1,
            "flash_lean": 4 * depth,  # the tokens, forward(train=True), then both eval tokens
            "flash_bwd_dkv": depth, "flash_bwd_dq": depth})
    head = [n for n in initial if n.startswith("classifier.")]
    moved_head = [n for n in head if not torch.equal(split[1][n], initial[n].cpu())]
    for got, want, what in zip(split, whole, ("outputs", "moved statistics", "gradients")):
        tree_equal(got, want, f"fuse_with_tokens(train=True) against forward(train=True), the {what}")
    if not head or moved_head != head:
        raise AssertionError(f"the head's statistics did not all move: {sorted(set(head) - set(moved_head))}")
    if torch.equal(other, split[0]["logits"]):
        raise AssertionError("fuse_with_tokens(train=True): two dropout seeds gave the same logits")
    for name, want in (("the eval _fuse", fuse), ("the eval forward", forward)):
        if not (torch.equal(default[0], want[0]) and torch.equal(default[1], want[1])):
            raise AssertionError(f"the default fuse_with_tokens differs from {name}")
    print(f"[fuse tokens] batch {FUSE_TOKENS_BATCH}, tokens {tuple(tokens.shape)} from video_encoder(train=True): "
          f"fuse_with_tokens(train=True) equals forward(train=True) bit for bit on the logits, the fused "
          f"embedding, all {len(initial)} buffers ({len(head)} of the head's statistics moved) and the gradients "
          f"of {len(compared)} IMU-encoder, fusion and head parameters; another seed moves the logits by up to "
          f"{(other - split[0]['logits']).abs().max().item():.3e}; the default call equals the eval _fuse and the "
          f"eval forward bit for bit; {seconds:.1f} s; launches {counts} ({smi})")
    del whole, split, other, default, fuse, forward

    def fuse_step(imu, tokens, labels, gen):
        model.zero_grad(set_to_none=True)
        with precision_scope(precision):
            logits, _ = model.forward_cast(imu, tokens, method="fuse_with_tokens", train=True, generator=gen)
            cross_entropy_loss(logits, labels).backward()

    gen = torch.Generator(device="cuda").manual_seed(FUSE_TOKENS_SEED)
    ms = median_ms(fuse_step, (imu, tokens, labels, gen), trials=FUSE_TOKENS_TRIALS, iters=FUSE_TOKENS_ITERS)
    print(f"[timing] fuse_with_tokens(train=True) forward + backward batch {FUSE_TOKENS_BATCH}: {ms:.3f} ms "
          f"(CUDA events after a warm-up, the median of {FUSE_TOKENS_TRIALS} trials of {FUSE_TOKENS_ITERS} "
          f"steps) ({smi})")
    del model
    torch.cuda.empty_cache()
    return {"fuse_train_ms": ms}


def run_fuse_tokens_stage(counters: dict, kernels: dict, smi: str) -> dict:
    """Phase 30: the port's last two parameters, ``featurize_windows(already_physical=)``
    and ``FusionClassifier.fuse_with_tokens(train=)``, on the card at full width."""
    t_phase = time.perf_counter()
    check_physical_windows(counters, kernels, smi)
    result = check_fuse_with_tokens(counters, kernels, smi)
    result["seconds"] = time.perf_counter() - t_phase
    print(f"[fuse tokens] phase 30: {result['seconds']:.1f} s ({smi})")
    return result


def selected_phases(argv) -> set:
    """The phases ``--phase N[,M...]`` names (all of them without it), with every phase
    they read results of (``PHASE_NEEDS``), and the card and build phases 1 and 2."""
    parser = argparse.ArgumentParser(description="Drive the PyTorch port on one NVIDIA GPU.")
    parser.add_argument("--phase", default=None,
                        help="comma-separated phases to run (1-%d); default all" % LAST_PHASE)
    args = parser.parse_args(argv)
    if args.phase is None:
        return set(range(1, LAST_PHASE + 1))
    parts = [p.strip() for p in args.phase.split(",") if p.strip()]
    wanted = {int(p) for p in parts if p.isdigit()}
    if not parts or not all(p.isdigit() for p in parts) or not wanted <= set(range(1, LAST_PHASE + 1)):
        parser.error(f"--phase takes numbers from 1 to {LAST_PHASE}, got {args.phase!r}")
    phases = {1, 2}
    while wanted:
        p = wanted.pop()
        phases.add(p)
        wanted |= PHASE_NEEDS.get(p, set()) - phases
    return phases


def main(argv=None) -> None:
    require_cuda()
    phases = selected_phases(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    if len(phases) < LAST_PHASE:
        print(f"[phases] {', '.join(map(str, sorted(phases)))} of 1-{LAST_PHASE}")

    t0 = time.perf_counter()
    _ext.library()
    print(f"[build] {_ext.library_path().name} from tpuhar_torch/csrc: {time.perf_counter() - t0:.1f} s")

    kernels = {name: dict(entry) for name, entry in KERNELS.items()}
    if 3 in phases:
        kernels["fused_window"].update(check_featurizer(np.random.default_rng(0)))
        kernels["conv3x3_bn_act"].update(check_conv3x3())
        kernels["conv3x3_bn_act_f32"].update(check_conv3x3_f32())
        verify_byte_map("cuda")
        print("[kernel] stem_u8 byte-map preflight: all 256 byte values exact")
        kernels["stem_gemm_u8"].update(check_stem_u8())
        kernels["conv3x3_i8"].update(check_conv3x3_i8())
        kernels["int8_gemm"].update(check_int8_gemm())
        kernels["conv3x3_i8"]["explicit_padding"] = check_conv3x3_i8_padding()
        kernels["flash_lean"].update(check_flash())
    if 12 in phases:
        bwd = check_flash_backward()
        kernels["flash_lean"].update(bwd["train_forward"])  # row 5a: #4's kernel with the LSE stored
        kernels["flash_bwd_dkv"].update(bwd["dkv"])
        kernels["flash_bwd_dq"].update(bwd["dq"])
    if 3 in phases:
        kernels["flash_lean_f32"].update(check_flash_f32())
    if 12 in phases:
        bwd32 = check_flash_backward_f32()
        kernels["flash_lean_f32"].update(bwd32["train_forward"])  # row 5a'': the same kernel with the LSE stored
        kernels["flash_bwd_dkv_f32"].update(bwd32["dkv"])
        kernels["flash_bwd_dq_f32"].update(bwd32["dq"])
    torch.cuda.empty_cache()
    counters = launch_counters()

    def drive(path: str, fn, requests, expected: dict, cfg) -> list:
        """Serve ``requests`` with every launch count set to 0 just before and read
        just after; fail unless the path launched each kernel as ``expected``."""
        for counter in counters.values():
            counter.launches = 0
        outs = [fn(*r) for r in requests]
        torch.cuda.synchronize()
        counts = {name: counter.launches for name, counter in counters.items()}
        for name, n in counts.items():
            kernels[name].setdefault("launches_by_path", {})[path] = n
        batch = requests[0][0].shape[0]
        shapes = {"logits": (batch, cfg.model.num_classes), "msp": (batch,), "energy": (batch,),
                  "embeddings": (batch, 2 * cfg.model.imu_d_model)}
        for i, out in enumerate(outs):
            for key, shape in shapes.items():
                if tuple(out[key].shape) != shape or not torch.isfinite(out[key]).all():
                    raise AssertionError(f"{path} request {i}: {key} {tuple(out[key].shape)} not finite {shape}")
        print(f"[{path}] {len(requests)} request(s) of batch {batch} answered; outputs {shapes}, all "
              f"finite; launches {counts}")
        for name, n in expected.items():
            if counts[name] != n:
                raise AssertionError(f"{path}: {name} launched {counts[name]} times, expected {n}")
        return outs

    cfg, cfg_vit = flagship_config(), vit_config()
    params = init_params(cfg, torch.Generator().manual_seed(0)) if phases & {4, 24} else None
    params_vit = params_pt = None
    if 4 in phases:
        fn, _ = build_forward(cfg, 8, device="cuda", params=params)
        requests = [tuple(t.cuda() for t in request(100 + i, 8)) for i in range(3)]
        outs = drive("bf16", fn, requests,
                     {"fused_window": 3, "conv3x3_bn_act": 12, "stem_gemm_u8": 0, "conv3x3_i8": 0, "flash_lean": 0},
                     cfg)
    if 5 in phases:
        ref_fn, _ = build_forward(flagship_config("float32"), 2, device="cpu", params=params)
        imu, video = requests[0]
        ref = ref_fn(imu[:2].cpu(), video[:2].cpu())
        for key in ("logits", "embeddings"):
            got = outs[0][key][:2].float().cpu()
            diff, cos = (got - ref[key]).abs().max().item(), cosine(got, ref[key])
            print(f"[cross-check] {key}: card bf16 vs CPU f32 max abs diff {diff:.4e}, cosine {cos:.6f}")
            if not cos >= COSINE_MIN:
                raise AssertionError(f"{key}: cosine {cos} < {COSINE_MIN}")

    if 6 in phases:
        t0 = time.perf_counter()
        fn8, _ = build_int8_forward(cfg, 8, device="cuda", params=params, resident=True)
        torch.cuda.synchronize()
        print(f"[int8] int8-resident forward built (calibration, quantization, logit recalibration "
              f"on the card): {time.perf_counter() - t0:.1f} s")
        outs8 = drive("int8_resident", fn8, requests,
                      {"fused_window": 3, "stem_gemm_u8": 3, "conv3x3_i8": 15, "conv3x3_bn_act": 0, "flash_lean": 0},
                      cfg)
        fn8_base, _ = build_int8_forward(cfg, 8, device="cuda", params=params, resident=False)
        drive("int8_baseline", fn8_base, requests[:1],
              {"fused_window": 1, "stem_gemm_u8": 1, "conv3x3_i8": 5, "conv3x3_bn_act": 0, "flash_lean": 0}, cfg)

    if 8 in phases:
        t0 = time.perf_counter()
        params_vit = init_params(cfg_vit, torch.Generator().manual_seed(0))
        fn_vit, _ = build_forward(cfg_vit, 8, device="cuda", params=params_vit)
        print(f"[vit] videomae_base forward built (weights drawn on the host, folded, loaded): "
              f"{time.perf_counter() - t0:.1f} s")
        requests_vit = [tuple(t.cuda() for t in vit_request(200 + i, 8)) for i in range(3)]
        outs_vit = drive("vit_bf16", fn_vit, requests_vit, {
            "flash_lean": 3 * VIT_CONFIGS[cfg_vit.model.video_backbone][0], "fused_window": 3,  # one per block
            "conv3x3_bn_act": 0, "stem_gemm_u8": 0, "conv3x3_i8": 0,
        }, cfg_vit)
    if 7 in phases:
        # the card's quantized tree and logit map on the CPU's plain paths, at batch 2
        imu, video = requests[0]
        q_cpu = tree_to(fn8.quantized_tree, "cpu")
        frames = video[:2].reshape(32, 14, 14, 768)
        feats = quant_tpucnn_forward_resident(fn8.quantized_tree, frames).cpu()
        feats_ref = quant_tpucnn_forward_resident(q_cpu, frames.cpu())
        diff = (feats - feats_ref).abs().max().item()
        print(f"[cross-check] int8 tower features: card kernels vs CPU plain max abs diff {diff:.4e} "
              f"(max |feature| {feats_ref.abs().max().item():.4e})")
        if not torch.allclose(feats, feats_ref, rtol=FEATURE_RTOL, atol=FEATURE_ATOL):
            raise AssertionError(f"int8 tower features differ beyond f32 sum order: {diff}")
        cfg32 = flagship_config("float32")
        ref8 = quantized_forward(
            cfg32, load_variables(FusionClassifier(cfg32), params).eval(), q_cpu,
            params["params"]["video_encoder"]["projection"], device="cpu",
            recalibration=fn8.recalibration, resident=True,
        )(imu[:2].cpu(), video[:2].cpu())
        for key in ("logits", "embeddings"):
            got = outs8[0][key][:2].float().cpu()
            diff, cos = (got - ref8[key]).abs().max().item(), cosine(got, ref8[key])
            print(f"[cross-check] int8 {key}: card (bf16 fusion) vs CPU (f32 fusion), same tree, "
                  f"max abs diff {diff:.4e}, cosine {cos:.6f}")
            if not cos >= COSINE_MIN:
                raise AssertionError(f"int8 {key}: cosine {cos} < {COSINE_MIN}")

    if 9 in phases:
        t0 = time.perf_counter()
        ref_vit, _ = build_forward(vit_config("float32"), 1, device="cpu", params=params_vit)
        imu, video = requests_vit[0]
        ref = ref_vit(imu[:1].cpu(), video[:1].cpu())
        print(f"[vit] f32 plain forward of one request on the CPU: {time.perf_counter() - t0:.1f} s")
        for key in ("logits", "embeddings"):
            got = outs_vit[0][key][:1].float().cpu()
            diff, cos = (got - ref[key]).abs().max().item(), cosine(got, ref[key])
            print(f"[cross-check] vit {key}: card bf16 vs CPU f32 max abs diff {diff:.4e}, cosine {cos:.6f}")
            if not cos >= COSINE_MIN:
                raise AssertionError(f"vit {key}: cosine {cos} < {COSINE_MIN}")

    if 11 in phases:
        check_int8_tree_device(fn8.quantized_tree, params)

    if 13 in phases:
        params_pt = run_pretrain_stage(counters, kernels, smi, phases)

    if 10 in phases:
        gen = torch.Generator(device="cuda").manual_seed(1)
        programs = {"bf16": fn, "int8_resident": fn8, "int8_baseline": fn8_base, "vit_bf16": fn_vit}
        for batch, names in ((8, ("bf16", "int8_resident", "vit_bf16")),
                             (256, ("bf16", "int8_resident", "int8_baseline", "vit_bf16"))):
            imu = torch.randn((batch, 250, 6), generator=gen, device="cuda") * 8000.0
            video = torch.randint(0, 256, (batch, 16, 14, 14, 768), generator=gen, device="cuda", dtype=torch.uint8)
            for name in names:
                clip = video.view(batch, 16, 224, 224, 3) if name == "vit_bf16" else video  # the same bytes, NHWC
                torch.cuda.reset_peak_memory_stats()
                ms = cuda_ms(lambda: programs[name](imu, clip), 20 if batch == 8 else 10)
                print(
                    f"[timing] {name} batch {batch}: step {ms:.3f} ms, {batch / ms * 1e3:.1f} inf/s, "
                    f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({smi})"
                )

    if 16 in phases:
        # the serving engine at full width: bf16, int8-resident and the ViT with flash
        H, W = cfg.data.video_resize
        calib = (np.random.default_rng(0).random((2, cfg.data.video_frames_per_window, H, W, 3)) * 255).astype(np.uint8)
        engines = {
            "engine_bf16": (dict(config=cfg, variables=params), fn,
                            {"fused_window": 1, "conv3x3_bn_act": 4}),
            "engine_int8_resident": (dict(config=cfg, variables=params, quantize_calib_clips=calib,
                                          quantize_resident=True, verify_byte_map=True), fn8,
                                     {"fused_window": 1, "stem_gemm_u8": 1, "conv3x3_i8": 5}),
            "engine_vit": (dict(config=cfg_vit, variables=params_vit, fast_attention=True), fn_vit,
                           {"fused_window": 1, "flash_lean": VIT_CONFIGS[cfg_vit.model.video_backbone][0]}),
        }
        for path, (kw, eager, expected) in engines.items():
            t0 = time.perf_counter()
            engine = InferenceEngine(batch_sizes=ENGINE_SIZES[path], device="cuda", **kw)
            print(f"[{path}] built in {time.perf_counter() - t0:.1f} s")
            check_engine(path, engine, eager, expected, counters, kernels, smi)
            del engine
            torch.cuda.empty_cache()
    if 17 in phases:
        run_classification_stage(counters, kernels, smi)
    if phases & {19, 20} and params_vit is None:
        params_vit = init_params(cfg_vit, torch.Generator().manual_seed(0))
    if phases & {18, 20} and params_pt is None:
        params_pt = init_params(pretrain_config(), torch.Generator().manual_seed(0), CrossModalModel)
    if 18 in phases:
        run_towers_stage(counters, kernels, smi, params_pt)
    if 19 in phases:
        run_int8_towers_stage(counters, kernels, smi, cfg_vit, params_vit)
    if 20 in phases:
        run_evaluate_stage(counters, kernels, smi, params_vit, params_pt)
    if 21 in phases:
        cfg_pipeline = run_pipeline_stage(counters, kernels, smi)
        try:
            if 22 in phases:
                reference = run_mesh_stage(counters, kernels, smi, cfg_pipeline)
            if 23 in phases:
                run_tp_stage(counters, kernels, smi, cfg_pipeline, reference)
        finally:
            shutil.rmtree(Path(cfg_pipeline.paths.base_output).parent, ignore_errors=True)
    if 24 in phases:
        t_phase = time.perf_counter()
        kernels["int8_gemm"]["centered_stem"] = {**check_centered_stem(smi),
                                                 **check_centered_engines(counters, kernels, smi, cfg, params)}
        print(f"[centered] phase 24 (a): {time.perf_counter() - t_phase:.1f} s")
        root = run_workflows_stage(counters, kernels, smi)
        print(f"[workflows] phase 24: {time.perf_counter() - t_phase:.1f} s")
        try:
            if 25 in phases:
                run_probes_stage(counters, kernels, smi, root)
            if 26 in phases:
                run_bench_scripts_stage(counters, kernels, smi, root / "bench_accuracy")
        finally:
            shutil.rmtree(root, ignore_errors=True)
    if 27 in phases:
        run_dryrun_stage(kernels, smi)
    if 28 in phases:
        kernels["conv3x3_bn_act_f32"]["f32_flagship"] = run_f32_flagship_stage(counters, kernels, smi)
    if 29 in phases:
        kernels["flash_lean_f32"]["f32_vit"] = run_f32_vit_stage(counters, kernels, smi)
    if 30 in phases:
        kernels["flash_lean"]["fuse_with_tokens"] = run_fuse_tokens_stage(counters, kernels, smi)
    for name, k in kernels.items():
        k["launches"] = sum(k.get("launches_by_path", {}).values())
        if len(phases) == LAST_PHASE and k["launches"] <= 0:
            raise AssertionError(f"no main path launched {name}")

    print(json.dumps({"kernels": list(kernels.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
