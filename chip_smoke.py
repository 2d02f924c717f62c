#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`rick_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each raising on failure:
  0. print the card (nvidia-smi name, power limit); exit non-zero without CUDA
  1. build the CUDA kernels of `rick_tpu_torch/csrc` (one nvcc per source, in
     parallel); print every kernel's registers and spills (ptxas), and the
     HGMMA (wgmma) count in the SASS of each of K4's 12 instantiations (4
     stages x 3 tiles) and of K6's 3 (tiles); K4 and K6 must not spill and
     their convs must run on the tensor cores
  2. per forward kernel: compare with its plain PyTorch version at every shape
     the 256px G/D forward gives it (batch 4, TF32 off), and time both: the
     kernel's device time (torch.profiler, `device_ms`) and CUDA events
     around 20 calls of its wrapper (`ms_with_host`, which at small shapes
     is the wrapper's host time), beside its bound (`tools/roofline.py`);
     K6 at the seven batch-100 shapes of the evaluation's chunk, also beside
     the route it replaced (`library_ms`: x * s, cuDNN's f32 conv, K3)
  3. the generation slice: seeded 256px G and D on the card, saved and loaded
     back as a rosinality {g, g_ema, d} checkpoint, then sample_images on 25
     fixed latents, a batch-100 random-noise generation and D on 16 of the
     images; K1, K4 and K6 must have launched in that run (G's stride-1
     StyledConvs take K6 under fast=True, so K3 f32 does not)
  4. the generation slice vs the plain path: the same weights on the CPU,
     where the port takes the plain versions; G (fixed latents, constant
     noise, and a mixing call) and D compared within 1e-3 * max|ref|
  5. generation img/s at batch 100 and D forward ms at batch 16
  6. the training kernels at every shape the 256px batch-2 phases give K2:
     K2 with and without its bias against its plain version, and the grads
     and double grads of `fused_bias_act` (K1/K2) and `modconv_epilogue`
     (K3/K2) against plain autograd of their plain versions; K2 timed
  7. the training slice: seeded 256px G and D, `init_train_state` on the
     card, `run_iteration` at i = 0, 1, 4, 16 (warmup with R1, a plain
     iteration, the path phase, R1 and path after warmup), a Fisher round on
     5 seeded latents and "real" images with its masks merged, and one more
     iteration (i = 32, every phase) under the masks; losses and params
     finite, pruned filters zero, frozen filters unchanged, Adam step counts
     equal to the active iterations, K1, K2 and K3 launched in that run
  8. the training slice vs the plain path: from the same state (phase 7's,
     copied to the CPU) and the same draws (made on the CPU), one run of each
     phase and a Fisher accumulation on the card and on the CPU, compared
  9. ms per phase at 256px batch 2, the recipe's mix per iteration, the
     seconds of a Fisher round, peak device memory
 10. K5, the stage ablation of K4: each stage (load, conv, blur, full) against
     its plain version, and the full stage bitwise against K4, at the
     ablation's three shapes at batch 4, on the ablation's own batch-100
     inputs, and at the three smaller upsample shapes at batch 100 (TF32
     off); then the ablation tool's run at batch 100 (its own entry point),
     whose launches are counted, and its table: each stage's ms, bound and
     share of bound, and K4 against `F.conv_transpose2d` alone
 11. the eval slice: seeded 256px g_ema, the seeded Inception with randomized
     batch-norm statistics, 5000 seeded uint8 "real" images; the recipe's
     Evaluator (5000 samples, gen_batch 100, real batch 25) and one
     compute_inception_score; FID finite, K4/K6/K1 launched 6/7/8 times per
     chunk and K3 (f32) not at all; the device Fréchet distance against scipy
     on the same statistics
 12. the eval slice vs the plain path: 8 fixed latents with constant noise
     through g_ema on the card (K4) and the CPU (plain chain), then the full
     299px Inception on each; mu/cov of a 16-image run on each
 13. fid5k_eval_s with TF32 off and on (torch's default for convolutions),
     split into generation and Inception; real-set extraction s; Inception
     img/s at batch 100; peak device memory
 14. the train CLI (`rick_tpu_torch.cli.train.main`, in this process) on a
     synthetic 256px record store (10 train and 1000 test images, PNG
     through the port's encoder) with the README recipe's flags at batch 2,
     depth cut: --iter 10 (iterations 0-20: Fisher rounds, FID@1000 at 0,
     10, 20, sample grids, a checkpoint at 15), then --iter 20
     --auto_resume, which must resume at 15 and run 15-30; stats.jsonl,
     best_fid.txt / best.pt, the PNGs, the .pt against the .state.npz
     (g_ema's images) and a bitwise re-save of 000030.state.npz are
     checked; K1-K4 must have launched; wall-clock, iterations, Fisher
     rounds, evaluations and peak device memory per run
 15. ADA at 256px, margin 224: (a) the augment on the card against the CPU
     (p = 1 matrices made on the CPU; the images and the image gradient;
     G = C = I, and a constant image kept); (b) a seeded state with augment
     and the adaptive p, started at p 0.5 with 254 predictions pooled,
     run_iteration at i = 0, 1, 4, 16: finite, p moved by exactly
     sign * ada_step * 256 by the first D phase and by nothing else, K1-K3
     launched; (c) the D and G phases with ADA on the card against the CPU
     from the same state and draws (matrices included), as phase 8; (d) ms
     of each phase at a fixed p = 0.5 beside phase 9's, of the augment
     alone, and of D and G without and with ADA alternated on one state;
     (e) the train CLI with --augment on phase 14's store (iterations
     0-10, FID@100), K1-K4 launched
 16. scoring: (a) VGG16 fc2 of 4 images and LPIPS of 4 pairs at 256px on
     the card against the CPU (TF32 off); (b) the recipe's Evaluator with
     compute_pr on phase 11's g_ema and real set (5000 samples, the real
     activations reused): one compute_inception_score(pr=True), P&R in
     [0, 1], K4/K6/K1 launched 6/7/8 times per chunk for each of FID and
     P&R, the device f64 distances and radii against numpy's on 500 rows,
     VGG16 img/s, the distances' seconds; (c) `cli.intra_lpips prepare` on
     phase 14's 10 training images and `compute` of its best.pt at the
     protocol's defaults (1000 samples, k 10, clusters of 50, batch 8):
     finite and > 0, K1/K4/K6 launched, the wall split into sampling,
     assignment and pairs; 50 of the samples scored also by rick_tpu's
     loops (VGG on both inputs of every LPIPS call): the labels equal, the
     values within 1e-5, both timed; (d) `cli.fid`, `cli.kid` and
     `cli.precision_recall` on two .npy sets of 1000 images
 17. bf16 (rick_tpu's `--bf16` and `Evaluator(gen_dtype=bf16)`: bf16 in G's
     conv1 and D's from-RGB conv only): (a) K1-bf16 at (2,128,256,256) and
     K3-bf16 at (2,512,4,4), noise batch 2 and 1, then at shapes that reach
     their other load paths and K3-bf16 at (4,128,256,256), against their
     plain versions and timed, each beside its launch floor (an empty
     kernel at its grid, `rick_empty_launch`); each output against the
     row-per-block kernel it replaced (bitwise equality printed; both timed
     in turns at the main-path and streaming shapes); the kernel wrappers'
     host time per call; their first grads against plain autograd; (b) a
     seeded bf16 state, run_iteration
     at i = 0, 1, 4, 16: finite, both bf16 instantiations and K1-K3
     launched; (c) the bf16 D and G phases on the card against the CPU, as
     phase 8, per tensor in norm within 1e-1; (d) D and G in f32 and bf16
     alternated on one state; (e) `Evaluator(gen_dtype=bf16)` on one chunk
     of 100 against phase 11's f32 one (launches, time, FID@100); (f) the
     train CLI with --bf16 on phase 14's store (iterations 0-10, FID@100)
 18. data-parallel over torch.distributed: (a) phase 14's first CLI run again
     under `torchrun --nproc_per_node 1` (NCCL, world 1): its metrics per
     iteration (phase 8's loss tolerance) and its checkpoint of step 15 per
     tensor in norm (phase 8's rule, the steps from the seeded state both
     start from) against phase 14's; (b) two ranks on the one card over
     gloo (asked for explicitly; NCCL refuses two ranks on one device),
     started here: iterations 0 and 16 from phase 7's state at global batch
     2, one image per rank, each held to one process on the card as phase 8
     holds the card to the CPU, the two ranks' states bitwise equal; a
     Fisher accumulation of 4 images sharded 2 per rank against the
     unsharded one; a sharded FID@1000 of phase 11's g_ema against one
     process's mu, cov and FID within 1e-3 (K4/K6/K1 6/7/8 per chunk); the
    draws of 120 samples at gen_batch 14, chunks of 15 per rank against 12
    in one process, each rank's rows bitwise one process's.
     Two ranks share one card here: a correctness run, not a multi-GPU speed
 19. JPEG inputs (no PIL on the card's machine): (a) every committed fixture
     (`tests/torch_fixtures/jpeg`) through `decode_jpeg`, the sha256 of its
     pixels equal to PIL's in the manifest; the decode time of a 512x512
     4:2:0 file and MP/s on the host running the script; (b)
     `cli.prepare_data` in process (--size 256, LANCZOS) on the ten
     512x512 "cat" JPEGs, the store's
     pixels equal to `rick_tpu.prepare_dataset`'s (the manifest's hash);
     (c) the train CLI with the AFHQ-Cat recipe's --fisher_quantile 85
     --prune_quantile 0.075 on that store, phase 14's test set for FID@100,
     iterations 0-10: losses and FIDs finite, K1-K4 launched (`cat_cli`),
     the Fisher round's G masks at the recipe's percentiles recomputed from
     its FIMs; (d) `cli.fid`'s folder loader on the ten JPEGs equal to the
     decoded fixtures through `train_transform`
 20. ADA's three warp lowerings, legacy/, BMP/TIFF/WebP inputs: (a) `gather`,
     `matmul` and `matmul_fir` (`RICK_ADA_WARP`) at 256px, margin 224, batch
     2 on eight transforms (four p = 1 draws, a rotation with a shift, a
     flip, two 0.28x zoom-outs): apply_affine and its image gradient on the
     card against the CPU's result of the same lowering (1e-5 of max|ref|),
     matmul against gather on the card outside the zoom-outs (1e-6), the
     matrix lowerings parting from gather in them; (b) per lowering the
     augment's ms forward at batch 4 and forward and backward at batch 2, its
     peak memory, and the D and G phases at p = 0.5 alternated over the three
     (median of 3 rounds of 5); (c) phase 15 (e)'s --augment CLI run under
     RICK_ADA_WARP=matmul_fir, K1-K4 launched (`ada_fir_cli`); (d)
     `rick_tpu_torch.legacy` on the card: spectral norm of a 512x512x3x3
     weight, the conditional norms of 256px activations, against the CPU;
     the samplers on a CUDA generator; a CheckpointIO round trip of phase 7's
     state, bitwise; (e) on the card's host (no PIL): every committed BMP,
     TIFF and WebP fixture (`tests/torch_fixtures/formats`) to the sha256 of
     PIL's pixels; the decode ms and MP/s of one 512x512 image per variant
     (BMP 24-bit and RLE8, TIFF none, PackBits, LZW and Deflate with the
     predictor, written on the host by `format_writers.timing_files` from a
     cat JPEG's pixels and held to them; WebP lossy and lossless fixtures);
     `cli.prepare_data` of the mixed folder, the store's pixels equal to
     `rick_tpu.prepare_dataset`'s
 21. the threaded batch decoder (`data/native.py`, host C++ `csrc/rickdata.cpp`
     over the port's own inflate, PNG and JPEG readers): (a) g++'s seconds
     for it; (b) on phase 14's stores (10 + 1000 PNGs at 256px), flips off,
     one `decode_batch` of each against `ImageDataset.get` one at a time:
     the levels bitwise, the floats rick_tpu's native normalization of them
     (px * float32(1 / 127.5) - 1, at most a float32 ulp from
     `train_transform`'s px / 127.5 - 1); at 128px bitwise the plain numpy
     transcription of rick_tpu's float resize (`native.process_one`) and
     within one level of the port's F.interpolate path; (c) images/s of one
     `decode_batch` over 1000 images at 1, 8 and os.cpu_count() threads
     (median of 3) against the one-at-a-time path, on the 1000 PNGs and on
     the ten cat JPEGs repeated to 1000 (512px to 256px), with the host's
     CPU count; (d) the train CLI with --n_sample_train 1000 on phase 14's
     store, iterations 0-10, FID@100: 786 MB decoded is over the 512 MiB
     staging limit, so the host stream runs and every batch is one
     `decode_batch` of 2; K1-K4 launched (`native_cli`), the wait in
     `next(train_loader)` and run_iteration's seconds beside phase 14's
     staged run

The line before the last is a JSON object with one entry per kernel; the last
line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import copy
import ctypes
import hashlib
import importlib.util
import io
import json
import math
import os
import queue
import re
import shutil
import socket
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from rick_tpu_torch.augment import apply_affine, augment, sample_affine, sample_color
from rick_tpu_torch.ckpt import load_checkpoint, load_state, save_state, train_state_from_jax, train_state_to_jax
from rick_tpu_torch.cli import fid as fid_cli
from rick_tpu_torch.cli import intra_lpips as intra_lpips_cli
from rick_tpu_torch.cli import kid as kid_cli
from rick_tpu_torch.cli import precision_recall as pr_cli
from rick_tpu_torch.cli import prepare_data as prepare_data_cli
from rick_tpu_torch.cli import train as train_cli
from rick_tpu_torch.ckpt.native import flatten as flatten_tree
from rick_tpu_torch.ckpt.native import unflatten as unflatten_tree
from rick_tpu_torch.data import (
    ImageDataset,
    NativeImageDataset,
    RecordStore,
    RecordStoreWriter,
    decode_image,
    decode_jpeg,
    decode_png,
    encode_png,
    train_transform,
)
from rick_tpu_torch.data import native as native_module
from rick_tpu_torch.dist import initialize_multihost, local_rows
from rick_tpu_torch.legacy import (
    CheckpointIO,
    cbatch_norm_apply,
    cinstance_norm_apply,
    get_ydist,
    get_zdist,
    spectral_norm_apply,
)
from rick_tpu_torch.metrics import (
    Evaluator,
    IntraLPIPS,
    calculate_frechet_distance,
    default_lin_weights,
    get_activations,
    inception_init_np,
    load_cluster_centers,
    lpips_distance,
    randomize_bn,
    vgg16_fc2_features,
    vgg16_from_params,
    vgg16_init,
)
from rick_tpu_torch.metrics import evaluator as evaluator_module
from rick_tpu_torch.metrics.evaluator import _stats_from_acts
from rick_tpu_torch.metrics.intra_lpips import reference_preprocess
from rick_tpu_torch.metrics.precision_recall import (
    compute_pairwise_distances,
    distances2radii,
    manifold_device,
    pairwise_distances_device,
    precision_and_recall_device,
    radii_device,
)
from rick_tpu_torch.nn import Discriminator, DiscriminatorConfig, Generator, GeneratorConfig
from rick_tpu_torch.ops import (
    STAGES,
    _build,
    bf16_launch_counts,
    convt_blur_act,
    convt_blur_act_ref,
    convt_blur_act_stage,
    fused_bias_act,
    fused_bias_act_bwd,
    fused_bias_act_bwd_ref,
    fused_bias_act_ref,
    launch_counts,
    modconv_act,
    modconv_act_ref,
    modconv_epilogue,
    modconv_epilogue_ref,
    reset_launch_counts,
)
from rick_tpu_torch.tools import bench_fused_ablate
# the card's published peaks (tools/roofline.py): bytes at 3.35 TB/s, CUDA-core
# operations at 67 TFLOP/s f32, and K4's and K5's conv at the route the kernel
# takes, 3xTF32 on the tensor cores (3 x its operations at 495 TFLOP/s); a
# kernel's bound is the largest of the three
from rick_tpu_torch.tools.roofline import (
    TF32_PASSES,
    bound,
    convt_ops,
    fused_bias_act_bytes,
    modconv_act_work,
    modconv_epilogue_bytes,
)
from rick_tpu_torch.train import (
    TrainConfig,
    accumulate_fims,
    fisher_round,
    init_train_state,
    merge_prune,
    run_iteration,
    sample_draws,
    sample_images,
)
from rick_tpu_torch.train import fisher as fisher_module
from rick_tpu_torch.train import steps
from rick_tpu_torch.train.adam import exp_avg_sq, step_counts
from rick_tpu_torch.train.masks import d_final, d_trainable, g_trainable
from rick_tpu_torch.train.state import trainable_params

DEV = "cuda"
SIZE = 256
B = 4  # batch of the forward per-kernel checks
GEN_BATCH = 100  # the evaluator's 256px generation batch
D_BATCH = 16
TRAIN_ITERS = (0, 1, 4, 16)  # then the Fisher round, then MASKED_ITER
MASKED_ITER = 32
N_FISHER = 5
SLICE_TOL = 1e-3  # generation slice vs plain: max|d| <= SLICE_TOL * max|ref|, TF32 off
# per-kernel: max|d| <= tol * max|ref|.  K1, K2 and K3 are elementwise (at most
# an FMA contraction apart); K4 and K6 sum 9*Cin products in another order than
# cuDNN.
KERNEL_TOL = {"fused_bias_act": 1e-6, "fused_bias_act_bwd": 1e-6, "modconv_epilogue": 1e-6, "convt_blur_act": 1e-4,
              "modconv_act": 1e-4, "fused_bias_act_bf16": 1e-6, "modconv_epilogue_bf16": 1e-6}
# autograd through the kernels vs plain autograd, relative to max|ref|: K2
# applies the slope before the gain where autograd of the plain version
# applies it after (an ulp), and the bias, demod, noise and noise-weight
# grads are sums of up to 8M such terms, which autograd of the plain chain
# reduces in another order: 1e-5
GRAD_TOL = 1e-5
# training slice, card vs CPU (TF32 off).  The two sum every conv in another
# order, and a pre-activation within rounding of the leaky-ReLU kink may take
# the other slope, which moves single gradient entries upstream of it; so the
# check is per tensor, in norm: |card - cpu| / |cpu| for Adam's second moment
# and the FIMs, relative error for the losses, and for the step each param
# took (p_after - p_before) |card - cpu| <= STEP_TOL |cpu| + STEP_ATOL * lr *
# sqrt(n): 1% of the step, or an RMS error of 0.1% of lr per entry, for the
# steps that are themselves near zero (R1's gradient of a bias, which moves
# D's input gradient only through the minibatch-stddev layer).  The losses:
# 1e-3, for the path penalty, which squares a gradient taken through all of G.
# Adam's v and the FIMs: 1e-2 (5e-3 on the gradient).  The one-element params
# (G's noise weights, D's final bias) are compared together, as one vector per
# model, at 5e-2 for their step, v and FIM: a noise weight's gradient is one
# sum over a whole layer that cancels to a small part of its terms, so alone
# it moves by percents with the rounding (tools/fim_spread.py: in a small
# noise weight's FIM, two card runs differ by up to 6.8e-3, card and CPU by
# up to 1.5e-2; one run's card and CPU differed by 6.7e-2), while the
# vector, as each tensor, is set by its large entries.
STEP_TOL, STEP_ATOL, V_TOL, FIM_TOL, LOSS_TOL, SCALAR_TOL = 1e-2, 1e-3, 1e-2, 1e-2, 1e-3, 5e-2
# the eval slice, as the README recipe's Evaluator runs it (`--n_sample_test
# 5000`, real batch max(batch, 25), gen_batch 100)
EVAL_N, REAL_BATCH = 5000, 25
# the f32 device Fréchet distance against scipy's f64 one on the same
# statistics, relative: the f32 eigendecompositions of two 2048-d
# covariances keep about five digits of traces of the distance's size (the
# CPU tests see ~1e-6 at full rank)
FD_TOL = 1e-3
# (Cin, Cout, H of the input): the upsample StyledConvs of 256px generation
# below the ablation's three shapes
SMALL_UP_SHAPES = ((512, 512, 4), (512, 512, 8), (512, 512, 16))
SOURCES = {
    "fused_bias_act": ("rick_tpu_torch/csrc/fused_bias_act.cu", "rick_tpu/ops/pallas_kernels.py:81"),
    "fused_bias_act_bwd": ("rick_tpu_torch/csrc/fused_bias_act.cu", "rick_tpu/ops/pallas_kernels.py:126"),
    "modconv_epilogue": ("rick_tpu_torch/csrc/modconv_epilogue.cu", "rick_tpu/ops/pallas_kernels.py:176"),
    "convt_blur_act": ("rick_tpu_torch/csrc/convt_blur_act.cu", "rick_tpu/ops/fused_upsample.py:257"),
    "modconv_act": ("rick_tpu_torch/csrc/modconv_act.cu",
                    "none: XLA's conv (rick_tpu/nn/blocks.py) + rick_tpu/ops/pallas_kernels.py:176, fused"),
}
K5_SOURCE = ("rick_tpu_torch/csrc/convt_blur_act.cu", "scripts/bench_fused_ablate.py:153")


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


ONE_ELEMENT = "one-element params"


def by_tensor(tensors: dict) -> dict:
    """{name: f64 CPU copy}, the one-element tensors stacked into one vector
    under ONE_ELEMENT (in the order given)."""
    out = {k: v.detach().double().cpu() for k, v in tensors.items() if v.numel() > 1}
    ones = [v.detach().double().cpu().reshape(1) for v in tensors.values() if v.numel() == 1]
    if ones:
        out[ONE_ELEMENT] = torch.cat(ones)
    return out


def tol(name: str, tensor_tol: float) -> float:
    """The tolerance of an entry of `by_tensor`: SCALAR_TOL (or the tensors'
    own, where that is larger) for the vector of one-element params."""
    return max(SCALAR_TOL, tensor_tol) if name == ONE_ELEMENT else tensor_tol


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20) -> float:
    """Mean device time of fn() over `iters` launches, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def queued_ms(fn, iters: int = 20) -> float:
    """Mean device time per call of fn by CUDA events, the launches queued
    behind a spin kernel (`torch.cuda._sleep`, ~10 ms) so that the host's
    enqueue time is hidden: the kernels' time back to back."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, kernel: str, iters: int = 20) -> float:
    """Mean device time of one launch of the CUDA kernel whose name holds
    `kernel` (fn launches it once a call), under torch.profiler over `iters`
    calls: the kernel's own time, the wrapper's host time left out.  The
    mean is over the launches the profiler recorded: now and then it delivers
    only some of a session's kernel records, or none, a few sessions in a
    row; a session with none is run again, up to ten times, and then the
    time is taken by `queued_ms` (printed as such)."""
    fn()
    torch.cuda.synchronize()
    for _ in range(10):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        records = [e for e in prof.key_averages() if kernel in e.key and e.device_time_total > 0]
        launches = sum(e.count for e in records)
        if launches:
            return sum(e.device_time_total for e in records) / launches / 1000.0
    ms = queued_ms(fn, iters)
    print(f"  ({kernel}: the profiler delivered no kernel records in 10 sessions; {ms:.5f} ms by CUDA events "
          "behind a spin kernel)", flush=True)
    return ms


def host_us(fn, calls: int = 200) -> float:
    """Host microseconds per call of fn, enqueue only: the host clock around
    `calls` calls with no synchronize inside (after one warm-up call)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def rel_err(got: torch.Tensor, ref: torch.Tensor):
    d = float((got.double() - ref.double()).abs().max())
    return d, d / max(float(ref.abs().max()), 1e-30)


def norm_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    """|got - ref| / |ref| in the Frobenius norm (0 when both are 0)."""
    d = float((got.double().cpu() - ref.double().cpu()).norm())
    r = float(ref.double().norm())
    return d / r if r > 0 else (0.0 if d == 0 else math.inf)


def case(name, label, kern, plain, nbytes, flops, tf32_flops=0, *, kernel: str, floor=None, library=None,
         **extra):
    """A kernel check: `flops` on the CUDA cores (f32), `tf32_flops` on the
    tensor cores (TF32), both as the bound counts them; `kernel` the CUDA
    kernel's name (or a part of it) as the profiler shows it; `floor` None or
    a call that launches the empty kernel with the case's grid (the launch
    floor the bound counts); `library` None or the library route the kernel
    is held to (`library_ms`, CUDA events)."""
    return dict(name=name, label=label, kern=kern, plain=plain, nbytes=nbytes, flops=flops, tf32_flops=tf32_flops,
                kernel=kernel, floor=floor, library=library, **extra)


def run_cases(cases) -> dict:
    """Check every case against its plain version and time both: the
    kernel's device time (torch.profiler), and by CUDA events around 20
    calls of the wrapper (`ms_with_host`: at small shapes that is the
    wrapper's host time); the bound by bytes and operations, and with the
    launch floor where the case gives one.  Per kernel, the largest error
    and the row of its costliest shape (by plain time)."""
    rows = []
    with torch.inference_mode():
        for c in cases:
            name, label = c["name"], c["label"]
            got, ref = c["kern"](), c["plain"]()
            torch.cuda.synchronize()
            require(got.shape == ref.shape, f"{name} {label}: shape {got.shape} != {ref.shape}")
            require(bool(torch.isfinite(got).all()), f"{name} {label}: non-finite output")
            abs_err, rel = rel_err(got, ref)
            ms = device_ms(c["kern"], c["kernel"])
            ms_with_host, plain_ms = cuda_ms(c["kern"]), cuda_ms(c["plain"])
            bound_ms, bound_by = bound(c["nbytes"], c["flops"], c["tf32_flops"])
            floor_ms = device_ms(c["floor"], "empty_kernel") if c["floor"] else None
            library_ms = cuda_ms(c["library"]) if c["library"] else None
            least_ms, least_by = bound(c["nbytes"], c["flops"], c["tf32_flops"], floor_ms or 0.0)
            floor = f" floor_ms={floor_ms:.5f}" if floor_ms is not None else ""
            library = f" library_ms={library_ms:.4f}" if library_ms is not None else ""
            print(f"  {name:21s} {label:44s} max_abs_err={abs_err:.3e} rel={rel:.3e} device_ms={ms:.5f} "
                  f"ms_with_host={ms_with_host:.4f} plain_ms={plain_ms:.4f}{library} bound_ms={bound_ms:.5f} "
                  f"({bound_by}){floor}; {least_ms / ms:.0%} of {least_ms:.5f} ({least_by})", flush=True)
            require(rel <= KERNEL_TOL[name], f"{name} {label}: rel err {rel:.3e} > {KERNEL_TOL[name]}")
            rows.append(dict(kernel=name, shape=label, max_abs_err=abs_err, ms=ms, ms_with_host=ms_with_host,
                             plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
                             launch_floor_ms=floor_ms, share=least_ms / ms))
            del got, ref
    per_kernel = {}
    for name in {r["kernel"] for r in rows}:
        mine = [r for r in rows if r["kernel"] == name]
        top = max(mine, key=lambda r: r["plain_ms"])
        per_kernel[name] = dict(top, max_abs_err=max(r["max_abs_err"] for r in mine))
    return per_kernel


# ---------------------------------------------------------------------------
# phase 2: the forward kernels at every shape of the 256px forward
# ---------------------------------------------------------------------------


def forward_cases(gen: torch.Generator):
    dev = DEV

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    def uniform(*shape):
        return torch.rand(shape, generator=gen, device=dev) + 0.5

    cases = []
    # K1: G style MLP / D head (B, 512); D ConvLayers (B, C, R, R)
    k1 = [(B, 512), (B, 128, 256, 256), (B, 256, 128, 128), (B, 512, 64, 64),
          (B, 512, 32, 32), (B, 512, 16, 16), (B, 512, 8, 8), (B, 512, 4, 4)]
    for shape in k1:
        x = randn(*shape)
        b = randn(shape[-1] if len(shape) == 2 else shape[1], scale=0.1)
        cases.append(case("fused_bias_act", str(shape), lambda x=x, b=b: fused_bias_act(x, b),
                          lambda x=x, b=b: fused_bias_act_ref(x, b), 4 * (2 * x.numel() + b.numel()), 3 * x.numel(),
                          kernel="fba_lastdim" if len(shape) == 2 else "fba_rows"))
    # K3: the 7 non-upsample StyledConvs, noise batch B (fresh) and 1 (buffers)
    for C, R in [(512, 4), (512, 8), (512, 16), (512, 32), (512, 64), (256, 128), (128, 256)]:
        out, demod, bias = randn(B, C, R, R), uniform(B, C), randn(C, scale=0.1)
        nw = torch.full((1,), 0.3, device=dev)
        for nb in (B, 1):
            a = (out, demod, randn(nb, 1, R, R), nw, bias)
            nbytes = 4 * (2 * out.numel() + demod.numel() + nb * R * R + C + 1)
            cases.append(case("modconv_epilogue", f"{(B, C, R, R)} noise batch {nb}",
                              lambda a=a: modconv_epilogue(*a), lambda a=a: modconv_epilogue_ref(*a),
                              nbytes, 6 * out.numel(), kernel="epi_rows"))
    # K4: the 6 upsample StyledConvs (input H, Cin -> Cout)
    for H, cin, cout in [(4, 512, 512), (8, 512, 512), (16, 512, 512), (32, 512, 512),
                         (64, 512, 256), (128, 256, 128)]:
        xs = randn(B, cin, H, H)
        w = randn(cout, cin, 3, 3, scale=1.0 / (cin * 9) ** 0.5)
        demod, bias = uniform(B, cout), randn(cout, scale=0.1)
        y_numel = B * cout * 4 * H * H
        # the separable blur's MACs (4 + 4 taps per output) and the epilogue
        # on the CUDA cores; the transposed conv's MACs as 3xTF32
        flops = 2 * 8 * y_numel + 4 * y_numel
        tf32_flops = TF32_PASSES * convt_ops(B, cin, cout, H)
        for nb in (B, 1):
            a = (xs, w, demod, randn(nb, 1, 2 * H, 2 * H, scale=0.1), bias)
            nbytes = 4 * (xs.numel() + w.numel() + demod.numel() + nb * 4 * H * H + cout + y_numel)
            cases.append(case("convt_blur_act", f"{(B, cin, H, H)}->{cout} noise batch {nb}",
                              lambda a=a: convt_blur_act(*a), lambda a=a: convt_blur_act_ref(*a), nbytes, flops,
                              tf32_flops, kernel="convt_blur_act_kernel"))
    return cases


# G's seven stride-1 StyledConvs at 256px: (C, H), C -> C
K6_SHAPES = ((512, 4), (512, 8), (512, 16), (512, 32), (512, 64), (256, 128), (128, 256))


def k6_cases(gen: torch.Generator):
    """K6 at the seven shapes of an evaluation's chunk (batch 100, fresh
    noise), beside the route it replaced: x * s, cuDNN's f32 conv, K3."""
    dev, cases = DEV, []
    for C, H in K6_SHAPES:
        x = torch.randn((GEN_BATCH, C, H, H), generator=gen, device=dev)
        s = torch.rand((GEN_BATCH, C), generator=gen, device=dev) + 0.5
        w = torch.randn((C, C, 3, 3), generator=gen, device=dev) / (9 * C) ** 0.5
        demod = torch.rand((GEN_BATCH, C), generator=gen, device=dev) + 0.5
        noise = torch.randn((GEN_BATCH, 1, H, H), generator=gen, device=dev)
        a = (x, s, w, demod, noise, torch.full((1,), 0.3, device=dev), torch.randn(C, generator=gen, device=dev) * 0.1)

        def library(a=a):
            x, s, w, demod, noise, nw, bias = a
            return modconv_epilogue(F.conv2d(x * s[:, :, None, None], w, padding=1), demod, noise, nw, bias)

        nbytes, flops, tf32_flops = modconv_act_work(GEN_BATCH, C, C, H, H, GEN_BATCH)
        cases.append(case("modconv_act", f"{(GEN_BATCH, C, H, H)}->{C} noise batch {GEN_BATCH}",
                          lambda a=a: modconv_act(*a), lambda a=a: modconv_act_ref(*a), nbytes, flops, tf32_flops,
                          kernel="modconv_act_kernel", library=library))
    return cases


# ---------------------------------------------------------------------------
# phases 3-5: the generation slice
# ---------------------------------------------------------------------------


@torch.no_grad()
def randomize_zero_params(module: torch.nn.Module, gen: torch.Generator) -> None:
    """Biases and noise weights start at zero: give them small random values
    so that the slice exercises the bias and noise paths."""
    for p in module.parameters():
        if not bool(p.any()):
            p.copy_(torch.randn(p.shape, generator=gen, device=p.device) * 0.1)


def build_and_reload(tmpdir: str):
    dev = DEV
    gen = torch.Generator(device=dev).manual_seed(0)
    g = Generator(SIZE, rng=gen, device=dev)
    d = Discriminator(SIZE, rng=gen, device=dev)
    randomize_zero_params(g, gen)
    randomize_zero_params(d, gen)
    g_ema = copy.deepcopy(g)
    path = str(Path(tmpdir) / "ckpt.pt")
    torch.save({"g": g.state_dict(), "g_ema": g_ema.state_dict(), "d": d.state_dict()}, path)

    gen2 = torch.Generator(device=dev).manual_seed(1)
    g2, g_ema2 = Generator(SIZE, rng=gen2, device=dev), Generator(SIZE, rng=gen2, device=dev)
    d2 = Discriminator(SIZE, rng=gen2, device=dev)
    load_checkpoint(path, dev, g=g2, g_ema=g_ema2, d=d2)
    for src, dst in ((g, g2), (g_ema, g_ema2), (d, d2)):
        a, b = src.state_dict(), dst.state_dict()
        require(a.keys() == b.keys(), "checkpoint round trip changed the keys")
        require(all(torch.equal(a[k], b[k]) for k in a), "checkpoint round trip changed a tensor")
    return g_ema2.eval(), d2.eval()


def run_slice(g_ema, d) -> dict:
    dev = DEV
    zgen = torch.Generator(device=dev).manual_seed(2)
    z25 = torch.randn((25, g_ema.cfg.style_dim), generator=zgen, device=dev)
    z100 = torch.randn((GEN_BATCH, g_ema.cfg.style_dim), generator=zgen, device=dev)
    torch.cuda.synchronize()
    reset_launch_counts()
    with torch.inference_mode():
        grid = sample_images(g_ema, z25)
        imgs, _ = g_ema([z100], rng=torch.Generator(device=dev).manual_seed(3), fast=True)
        score, feats = d(imgs[:D_BATCH])
    torch.cuda.synchronize()
    counts = launch_counts()
    print(f"  launches in the generation run: {counts}", flush=True)
    require(tuple(grid.shape) == (25, 3, SIZE, SIZE), f"sample grid shape {tuple(grid.shape)}")
    require(tuple(imgs.shape) == (GEN_BATCH, 3, SIZE, SIZE), f"images shape {tuple(imgs.shape)}")
    require(tuple(score.shape) == (D_BATCH, 1), f"D score shape {tuple(score.shape)}")
    for name, t in [("grid", grid), ("images", imgs), ("score", score)] + [(f"D feat {i}", f) for i, f in enumerate(feats)]:
        require(bool(torch.isfinite(t).all()), f"non-finite values in {name}")
    forward = ("fused_bias_act", "convt_blur_act", "modconv_act")
    require(all(counts[k] > 0 for k in forward), f"a forward kernel did not launch in generation: {counts}")
    require(counts["modconv_epilogue"] == 0, f"K3 (f32) launched in generation, where K6 takes its layers: {counts}")
    return counts


def slice_vs_plain(g_ema, d) -> None:
    """The same weights on the CPU, where every kernel wrapper takes its
    plain version; compared with the card's outputs on the same inputs."""
    g_cpu, d_cpu = copy.deepcopy(g_ema).cpu(), copy.deepcopy(d).cpu()
    zgen = torch.Generator().manual_seed(4)
    za = torch.randn((2, g_ema.cfg.style_dim), generator=zgen)
    zb = torch.randn((2, g_ema.cfg.style_dim), generator=zgen)
    worst = 0.0
    with torch.inference_mode():
        runs = {
            "fixed": lambda g, dev: g([za.to(dev)], return_feats=True, fast=True),
            "mixing inject_index=3": lambda g, dev: g([za.to(dev), zb.to(dev)], inject_index=3,
                                                     return_feats=True, fast=True),
        }
        for label, run in runs.items():
            img_c, feats_c = run(g_cpu, "cpu")
            img_g, feats_g = run(g_ema, DEV)
            pairs = [("image", img_g, img_c)] + [(f"feat {i}", a, b) for i, (a, b) in enumerate(zip(feats_g, feats_c))]
            if label == "fixed":
                s_c, df_c = d_cpu(img_c)
                s_g, df_g = d(img_c.to(DEV))
                pairs += [("D score", s_g, s_c)] + [(f"D feat {i}", a, b) for i, (a, b) in enumerate(zip(df_g, df_c))]
            for name, got, ref in pairs:
                _, rel = rel_err(got.cpu(), ref)
                worst = max(worst, rel)
                require(rel <= SLICE_TOL, f"slice vs plain, {label}, {name}: {rel:.3e} > {SLICE_TOL}")
            print(f"  {label}: {len(pairs)} tensors, worst max|d|/max|ref| = {worst:.3e}", flush=True)


def measure_generation(g_ema, d, card: str) -> None:
    dev = DEV
    zgen = torch.Generator(device=dev).manual_seed(5)
    z = torch.randn((GEN_BATCH, g_ema.cfg.style_dim), generator=zgen, device=dev)
    nrng = torch.Generator(device=dev).manual_seed(6)
    with torch.inference_mode():
        g_ema([z], rng=nrng, fast=True)
        torch.cuda.synchronize()
        iters = 3
        t0 = time.perf_counter()
        for _ in range(iters):
            imgs, _ = g_ema([z], rng=nrng, fast=True)
        torch.cuda.synchronize()
        gen_s = (time.perf_counter() - t0) / iters
        x = imgs[:D_BATCH].contiguous()
        d_ms = cuda_ms(lambda: d(x), iters=10)
    rate = GEN_BATCH / gen_s
    print(f"  generation 256px batch {GEN_BATCH}: {rate:.1f} img/s ({gen_s * 1e3:.1f} ms/batch) [{card}]")
    print(f"  D forward 256px batch {D_BATCH}: {d_ms:.2f} ms [{card}]", flush=True)


# ---------------------------------------------------------------------------
# phase 6: the training kernels at the 256px batch-2 training shapes
# ---------------------------------------------------------------------------

# K2's shapes in the 256px batch-2 phases: D's ConvLayers 256^2 .. 4^2 (also
# G's upsample-layer activations 8^2 .. 256^2), the style MLP and D head; the
# path phase and the Fisher round run batch 1
K2_SHAPES = [(2, 128, 256, 256), (2, 256, 128, 128), (2, 512, 64, 64), (2, 512, 32, 32), (2, 512, 16, 16),
             (2, 512, 8, 8), (2, 512, 4, 4), (2, 512), (1, 512), (1, 128, 256, 256)]
# K3's: the non-upsample StyledConvs, noise per sample
K3_SHAPES = [(2, 512, 4, 4), (2, 512, 8, 8), (2, 512, 16, 16), (2, 512, 32, 32), (2, 512, 64, 64),
             (2, 256, 128, 128), (2, 128, 256, 256)]


def k2_cases(gen: torch.Generator):
    cases = []
    for shape in K2_SHAPES:
        g = torch.randn(shape, generator=gen, device=DEV)
        y = torch.randn(shape, generator=gen, device=DEV)
        b = torch.randn(shape[-1] if len(shape) == 2 else shape[1], generator=gen, device=DEV)
        n = g.numel()
        cases.append(case("fused_bias_act_bwd", f"{shape}", lambda g=g, y=y: fused_bias_act_bwd(g, y),
                          lambda g=g, y=y: fused_bias_act_bwd_ref(g, y), 4 * 3 * n, 2 * n, kernel="fba_bwd"))
        cases.append(case("fused_bias_act_bwd", f"{shape} with bias", lambda g=g, y=y, b=b: fused_bias_act_bwd(g, y, b),
                          lambda g=g, y=y, b=b: fused_bias_act_bwd_ref(g, y, b), 4 * (3 * n + b.numel()), 3 * n,
                          kernel="fba_bwd"))
    return cases


def grads_and_double_grads(f, args, gen):
    """First grads of <f(args), w> and the grads of <first grads, u> with
    respect to w and args (zeros where none flows)."""
    y = f(*args)
    w = torch.randn(y.shape, generator=gen, device=y.device).requires_grad_(True)
    first = torch.autograd.grad(y, args, w, create_graph=True)
    us = [torch.randn(g.shape, generator=gen, device=y.device) for g in first]
    second = torch.autograd.grad(sum((g * u).sum() for g, u in zip(first, us)), (w,) + tuple(args), allow_unused=True)
    return [g.detach() for g in first] + [torch.zeros_like(a) if g is None else g.detach()
                                          for g, a in zip(second, (w,) + tuple(args))]


def check_autograd(name: str, label: str, f, f_ref, make_args, seed: int) -> float:
    """Grads and double grads through the kernels vs plain autograd of the
    plain version, on the same inputs and cotangents."""
    worst = 0.0
    got = grads_and_double_grads(f, make_args(), torch.Generator(device=DEV).manual_seed(seed))
    want = grads_and_double_grads(f_ref, make_args(), torch.Generator(device=DEV).manual_seed(seed))
    for i, (a, r) in enumerate(zip(got, want)):
        abs_err, rel = rel_err(a, r)
        require(bool(torch.isfinite(a).all()), f"{name} {label}: non-finite grad {i}")
        require(rel <= GRAD_TOL or abs_err == 0.0, f"{name} {label} grad {i}: rel err {rel:.3e} > {GRAD_TOL}")
        worst = max(worst, abs_err)
    return worst


def check_training_kernels() -> dict:
    gen = torch.Generator(device=DEV).manual_seed(77)
    per_kernel = run_cases(k2_cases(gen))
    errs = {"fused_bias_act": 0.0, "modconv_epilogue": 0.0}
    for shape in K2_SHAPES:
        c = shape[-1] if len(shape) == 2 else shape[1]

        def args(shape=shape, c=c):
            g = torch.Generator(device=DEV).manual_seed(hash(shape) % 2**31)
            return (torch.randn(shape, generator=g, device=DEV).requires_grad_(True),
                    torch.randn(c, generator=g, device=DEV).requires_grad_(True))

        errs["fused_bias_act"] = max(errs["fused_bias_act"], check_autograd(
            "fused_bias_act", str(shape), fused_bias_act, fused_bias_act_ref, args, 1))
    for shape in K3_SHAPES:
        bsz, c, r, _ = shape

        def args(shape=shape, bsz=bsz, c=c, r=r):
            g = torch.Generator(device=DEV).manual_seed(hash(shape) % 2**31)
            out = torch.randn(shape, generator=g, device=DEV)
            demod = torch.rand((bsz, c), generator=g, device=DEV) + 0.5
            noise = torch.randn((bsz, 1, r, r), generator=g, device=DEV)
            nw = torch.full((1,), 0.3, device=DEV)
            bias = torch.randn(c, generator=g, device=DEV) * 0.1
            # keep the pre-activation off the kink, where the kernel's FMA and
            # the plain chain could take the other slope
            pre = out * demod[:, :, None, None] + nw * noise + bias.reshape(1, -1, 1, 1)
            out = torch.where(pre.abs() < 1e-3, out + 2e-3 / demod[:, :, None, None], out)
            return tuple(a.requires_grad_(True) for a in (out, demod, noise, nw, bias))

        errs["modconv_epilogue"] = max(errs["modconv_epilogue"], check_autograd(
            "modconv_epilogue", str(shape), modconv_epilogue, modconv_epilogue_ref, args, 2))
    print(f"  grads and double grads vs plain autograd, max abs err: {errs}", flush=True)
    torch.cuda.synchronize()
    return {"fused_bias_act_bwd": per_kernel["fused_bias_act_bwd"], "autograd_err": errs}


# ---------------------------------------------------------------------------
# phases 7-9: the training slice
# ---------------------------------------------------------------------------


def expected_counts(iters, tcfg: TrainConfig) -> dict:
    """Adam steps per param group for the iterations `iters`, by rick_tpu's
    rules: D's final* step in every D and R1 phase, the rest of D only after
    warmup; G steps in the G phase after warmup and in every path phase."""
    final = rest = g = 0
    for i in iters:
        warm = i < tcfg.warmup_iter
        d_steps = 1 + (i % tcfg.d_reg_every == 0)
        final += d_steps
        rest += 0 if warm else d_steps
        g += (0 if warm else 1) + (i % tcfg.g_reg_every == 0 and not warm)
    return {"d_final": final, "d_rest": rest, "g": g}


def check_counts(state, iters, tcfg) -> None:
    want = expected_counts(iters, tcfg)
    got_g = step_counts(state.g_opt, trainable_params(state.g, g_trainable))
    got_d = step_counts(state.d_opt, trainable_params(state.d, d_trainable))
    require(set(got_g.values()) == {want["g"]}, f"G step counts {set(got_g.values())} != {want['g']}")
    for k, v in got_d.items():
        w = want["d_final"] if d_final(k) else want["d_rest"]
        require(v == w, f"D step count of {k}: {v} != {w}")


def filter_view(t: torch.Tensor) -> torch.Tensor:
    """Filters first: the 5-D modulated conv weight is (1, out, in, k, k)."""
    return t[0] if t.ndim == 5 else t


def train_slice(card: str):
    dev = DEV
    tcfg = TrainConfig(batch=2, augment=False, warmup_iter=1)
    wgen = torch.Generator(device=dev).manual_seed(10)
    g = Generator(SIZE, rng=wgen, device=dev)
    d = Discriminator(SIZE, rng=wgen, device=dev)
    randomize_zero_params(g, wgen)
    randomize_zero_params(d, wgen)
    state = init_train_state(GeneratorConfig(SIZE), DiscriminatorConfig(SIZE), tcfg, rng=wgen, device=dev, g=g, d=d)
    gen = torch.Generator(device=dev).manual_seed(11)

    def finite(label, metrics):
        for k, v in metrics.items():
            require(bool(torch.isfinite(v).all()), f"{label}: metric {k} is not finite")
        for name in ("g", "d", "g_ema", "d_ema"):
            for k, p in getattr(state, name).named_parameters():
                require(bool(torch.isfinite(p).all()), f"{label}: {name}.{k} is not finite")

    torch.cuda.synchronize()
    reset_launch_counts()
    for i in TRAIN_ITERS:
        real = torch.randn((tcfg.batch, 3, SIZE, SIZE), generator=gen, device=dev)
        m = run_iteration(state, tcfg, real, i, gen=gen)
        finite(f"iteration {i}", m)
        print(f"  i={i}: " + ", ".join(f"{k} {float(v):.4f}" for k, v in m.items()), flush=True)
    check_counts(state, TRAIN_ITERS, tcfg)

    noises = torch.randn((N_FISHER, tcfg.latent), generator=gen, device=dev)
    reals = torch.randn((N_FISHER, 3, SIZE, SIZE), generator=gen, device=dev)
    gf, gp, df, dp = fisher_round(state.g_ema, state.d_ema, noises, reals, batch=tcfg.batch,
                                  fisher_quantile=tcfg.fisher_quantile, prune_quantile=tcfg.prune_quantile, gen=gen)
    state.g_freeze, state.d_freeze = gf, df
    state.g_prune, state.d_prune = merge_prune(state.g_prune, gp), merge_prune(state.d_prune, dp)
    n_sel = {k: int(sum(float(v.sum()) for v in m.values())) for k, m in
             (("g_freeze", gf), ("g_prune", state.g_prune), ("d_freeze", df), ("d_prune", state.d_prune))}
    print(f"  Fisher round: filters selected {n_sel}", flush=True)
    require(all(v > 0 for v in n_sel.values()), f"a Fisher mask selected nothing: {n_sel}")

    before = {name: {k: p.detach().clone() for k, p in getattr(state, name).named_parameters()} for name in ("g", "d")}
    real = torch.randn((tcfg.batch, 3, SIZE, SIZE), generator=gen, device=dev)
    m = run_iteration(state, tcfg, real, MASKED_ITER, gen=gen)
    finite(f"masked iteration {MASKED_ITER}", m)
    torch.cuda.synchronize()
    counts = launch_counts()
    print(f"  i={MASKED_ITER} under the masks: " + ", ".join(f"{k} {float(v):.4f}" for k, v in m.items()))
    print(f"  launches in the training run: {counts}", flush=True)
    check_counts(state, TRAIN_ITERS + (MASKED_ITER,), tcfg)
    for name, freeze, prune in (("g", state.g_freeze, state.g_prune), ("d", state.d_freeze, state.d_prune)):
        params = dict(getattr(state, name).named_parameters())
        for k, pm in prune.items():
            sel = pm.bool()
            require(not bool(filter_view(params[k])[sel].any()), f"{name}.{k}: a pruned filter is not zero")
            frozen = freeze[k].bool() & ~sel
            require(torch.equal(filter_view(params[k])[frozen], filter_view(before[name][k])[frozen]),
                    f"{name}.{k}: a frozen filter moved")
    training = ("fused_bias_act", "fused_bias_act_bwd", "modconv_epilogue")
    require(all(counts[k] > 0 for k in training), f"a training kernel did not launch in training: {counts}")
    return state, tcfg, counts


def phase_runs(tcfg: TrainConfig, gcfg: GeneratorConfig, cpu_gen: torch.Generator, ada_p=None):
    """(name, draws made on the CPU, fn(state, draws, real) -> losses) for
    each phase, after warmup; with augment, the D and G draws carry their
    ADA matrices at p = ada_p."""
    d_draws = sample_draws(cpu_gen, gcfg, tcfg, tcfg.batch, ada_p=ada_p, ada_batch=2 * tcfg.batch)
    g_draws = sample_draws(cpu_gen, gcfg, tcfg, tcfg.batch, ada_p=ada_p, ada_batch=tcfg.batch)
    p_draws = sample_draws(cpu_gen, gcfg, tcfg, max(1, tcfg.batch // tcfg.path_batch_shrink), path=True)
    return [
        ("d", d_draws, lambda s, dr, real: [steps.d_phase(s, tcfg, real, dr, False)[0]["d"]]),
        ("r1", None, lambda s, dr, real: [steps.r1_phase(s, tcfg, real, False)]),
        ("g", g_draws, lambda s, dr, real: [steps.g_phase(s, tcfg, dr, False, do_ema=True)]),
        ("path", p_draws, lambda s, dr, real: list(steps.path_phase(s, tcfg, dr, False))),
    ]


def held_to(label, start, got, want, tcfg, models, trained, step_tol: float = STEP_TOL,
            v_tol: float = V_TOL) -> dict:
    """Phase 8's rule: for each of `models`, the step each param of `got`
    took from `start` against the step `want` took, per tensor in norm
    (`by_tensor`, STEP_ATOL for the steps that are themselves near zero),
    and Adam's second moment of `trained` ((model, predicate)) per tensor
    in norm.  Raises past the tolerances; returns the worst ratio to the
    allowance of each, with its tensor."""
    worst = {"step": (0.0, ""), "v": (0.0, "")}
    for model in models:
        begin = by_tensor(dict(getattr(start, model).named_parameters()))
        ref = by_tensor(dict(getattr(want, model).named_parameters()))
        cur = by_tensor(dict(getattr(got, model).named_parameters()))
        lr = tcfg.d_lr if model[0] == "d" else tcfg.g_lr
        lr = lr * (1.0 - tcfg.ema_accum) if model.endswith("_ema") else lr
        for k in begin:
            step_ref, step_got = ref[k] - begin[k], cur[k] - begin[k]
            diff, size = float((step_got - step_ref).norm()), float(step_ref.norm())
            allowed = tol(k, step_tol) * size + STEP_ATOL * lr * math.sqrt(step_ref.numel())
            worst["step"] = max(worst["step"], (diff / allowed, f"{model}.{k}"))
            require(diff <= allowed, f"{label}: the step of {model}.{k} differs by {diff:.3e} "
                                     f"(|step| {size:.3e}; allowed {allowed:.3e})")
    opt = trained[0] + "_opt"
    v_ref = by_tensor(exp_avg_sq(getattr(want, opt), trainable_params(getattr(want, trained[0]), trained[1])))
    v_got = by_tensor(exp_avg_sq(getattr(got, opt), trainable_params(getattr(got, trained[0]), trained[1])))
    for k in v_ref:
        e = norm_err(v_got[k], v_ref[k])
        worst["v"] = max(worst["v"], (e / tol(k, v_tol), k))
        require(e <= tol(k, v_tol), f"{label}: exp_avg_sq of {k} differs by {e:.3e}")
    return worst


def train_vs_plain(state, tcfg, phases=("d", "r1", "g", "path"), fims: bool = True, step_tol: float = STEP_TOL,
                   v_tol: float = V_TOL) -> dict:
    """From the same state and draws, each of `phases` on the card and on
    the CPU; then (`fims`) a Fisher accumulation on both.  With augment, the
    ADA state after each phase too.  Returns the CPU seconds."""
    gcfg = state.g.cfg
    base_cpu = copy.deepcopy(state).to("cpu")
    cpu_gen = torch.Generator().manual_seed(12)
    real = torch.randn((tcfg.batch, 3, SIZE, SIZE), generator=cpu_gen)
    cpu_s = {}
    for name, draws, run in phase_runs(tcfg, gcfg, cpu_gen, ada_p=base_cpu.ada_p):
        if name not in phases:
            continue
        on_cpu = copy.deepcopy(base_cpu)
        on_card = copy.deepcopy(base_cpu).to(DEV)
        t0 = time.perf_counter()
        want = run(on_cpu, draws, real)
        cpu_s[name] = time.perf_counter() - t0
        got = run(on_card, None if draws is None else draws.to(DEV), real.to(DEV))
        worst = {"loss": (0.0, ""), "step": (0.0, ""), "v": (0.0, "")}
        for a, b in zip(got, want):
            e = abs(float(a) - float(b)) / max(abs(float(b)), 1e-6)
            worst["loss"] = max(worst["loss"], (e, ""))
            require(e <= LOSS_TOL, f"{name} phase: loss {float(a)} vs {float(b)} ({e:.3e} > {LOSS_TOL})")
        trained = ("d", d_trainable) if name in ("d", "r1") else ("g", g_trainable)
        models = ("g", "g_ema", "d_ema") if name in ("g", "path") else ("d",)
        worst.update(held_to(f"{name} phase", base_cpu, on_card, on_cpu, tcfg, models, trained, step_tol, v_tol))
        ada = ""
        if tcfg.augment:
            for k in ("ada_p", "ada_stats", "r_t"):
                e = float((getattr(on_card, k).cpu() - getattr(on_cpu, k)).abs().max())
                require(e <= ADA_STATE_TOL, f"{name} phase: {k} {getattr(on_card, k)} vs {getattr(on_cpu, k)}")
            ada = f"; ada_p {float(base_cpu.ada_p)!r} -> card {float(on_card.ada_p)!r}, CPU {float(on_cpu.ada_p)!r}"
        print(f"  {name} phase: CPU {cpu_s[name]:.1f} s; loss relative error {worst['loss'][0]:.2e}; "
              f"worst error / allowed: step {worst['step'][0]:.2e} ({worst['step'][1]}), "
              f"exp_avg_sq {worst['v'][0]:.2e} ({worst['v'][1]}){ada}", flush=True)
        del on_cpu, on_card
    if not fims:
        return cpu_s

    noises = torch.randn((2, tcfg.latent), generator=cpu_gen)
    reals = torch.randn((2, 3, SIZE, SIZE), generator=cpu_gen)
    t0 = time.perf_counter()
    want = accumulate_fims(base_cpu.g_ema, base_cpu.d_ema, noises, reals, batch=tcfg.batch, const_noise=True)
    cpu_s["fims"] = time.perf_counter() - t0
    g_ema, d_ema = state.g_ema, state.d_ema
    got = accumulate_fims(g_ema, d_ema, noises.to(DEV), reals.to(DEV), batch=tcfg.batch, const_noise=True)
    worst = (0.0, "")
    for model, a, b in zip(("g_ema", "d_ema"), got, want):
        a, b = by_tensor(a), by_tensor(b)
        for k in b:
            e = norm_err(a[k], b[k])
            worst = max(worst, (e / tol(k, FIM_TOL), f"{model}.{k}"))
            require(e <= tol(k, FIM_TOL), f"FIM of {model}.{k} differs by {e:.3e}")
    print(f"  Fisher accumulation (2 images): CPU {cpu_s['fims']:.1f} s; worst error / allowed {worst[0]:.2e} "
          f"({worst[1]})", flush=True)
    return cpu_s


def measure_training(state, tcfg, card: str, fisher: bool = True) -> dict:
    """ms per phase (R1 on the D phase's reals: the augmented ones with
    augment) and the mix; with `fisher`, the Fisher round's seconds and the
    run's peak memory.  Returns the ms."""
    dev = DEV
    gcfg = state.g.cfg
    gen = torch.Generator(device=dev).manual_seed(13)
    real = torch.randn((tcfg.batch, 3, SIZE, SIZE), generator=gen, device=dev)
    path_batch = max(1, tcfg.batch // tcfg.path_batch_shrink)

    def draws(ada_batch):
        return sample_draws(gen, gcfg, tcfg, tcfg.batch, ada_p=state.ada_p, ada_batch=ada_batch)

    r1_real = steps.d_phase(state, tcfg, real, draws(2 * tcfg.batch), False)[1] if tcfg.augment else real
    runs = {
        "D": lambda: steps.d_phase(state, tcfg, real, draws(2 * tcfg.batch), False),
        "R1": lambda: steps.r1_phase(state, tcfg, r1_real, False),
        "G": lambda: steps.g_phase(state, tcfg, draws(tcfg.batch), False, do_ema=True),
        "path": lambda: steps.path_phase(state, tcfg, sample_draws(gen, gcfg, tcfg, path_batch, path=True), False),
    }
    ms = {k: cuda_ms(fn, iters=5) for k, fn in runs.items()}
    mix = ms["D"] + ms["G"] + ms["R1"] / tcfg.d_reg_every + ms["path"] / tcfg.g_reg_every
    for k, v in ms.items():
        print(f"  {k} phase 256px batch {tcfg.batch}: {v:.2f} ms [{card}]")
    print(f"  recipe mix per iteration (D + G + R1/{tcfg.d_reg_every} + path/{tcfg.g_reg_every}): "
          f"{mix:.2f} ms [{card}]")
    ms["mix"] = mix
    if not fisher:
        return ms
    noises = torch.randn((N_FISHER, tcfg.latent), generator=gen, device=dev)
    reals = torch.randn((N_FISHER, 3, SIZE, SIZE), generator=gen, device=dev)
    fisher = lambda: fisher_round(state.g_ema, state.d_ema, noises, reals, batch=tcfg.batch,  # noqa: E731
                                  fisher_quantile=tcfg.fisher_quantile, prune_quantile=tcfg.prune_quantile, gen=gen)
    fisher()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fisher()
    torch.cuda.synchronize()
    print(f"  Fisher round ({N_FISHER} images): {time.perf_counter() - t0:.3f} s [{card}]")
    print(f"  peak device memory of the run: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    return ms


# ---------------------------------------------------------------------------
# phase 10: K5, the stage ablation of K4
# ---------------------------------------------------------------------------


def check_k5() -> dict:
    """Each stage against its plain version, and full bitwise against K4: at
    the ablation's shapes at batch B, on the very inputs the ablation times
    at batch 100, and at the smaller upsample shapes of 256px generation at
    batch 100 (so K4 is checked at all six shapes the evaluation gives it);
    then the ablation with its launches counted.  Returns one JSON entry per
    stage."""
    errs = dict.fromkeys(STAGES, 0.0)
    checks = [(f"ablation shapes, batch {B}", B, bench_fused_ablate.SHAPES, 100),
              (f"ablation shapes and inputs, batch {bench_fused_ablate.BATCH}", bench_fused_ablate.BATCH,
               bench_fused_ablate.SHAPES, 0),
              (f"the other upsample shapes, batch {GEN_BATCH}", GEN_BATCH, SMALL_UP_SHAPES, 10)]
    for label, batch, shapes, seed in checks:
        got = bench_fused_ablate.verify(batch, shapes, DEV, seed=seed)
        torch.cuda.synchronize()
        errs = {k: max(v, got[k]) for k, v in errs.items()}
        print(f"  {label} {list(shapes)}: max abs err " + ", ".join(f"{k} {v:.3e}" for k, v in got.items())
              + "; full == K4 bitwise", flush=True)
    reset_launch_counts()
    rows = bench_fused_ablate.ablate()
    torch.cuda.synchronize()
    counts = dict(convt_blur_act_stage.launches)
    print(f"  launches in the ablation run: {counts}")
    require(all(v > 0 for v in counts.values()), f"a K5 stage did not launch in the ablation: {counts}")
    for r in rows:
        print("  " + bench_fused_ablate.format_row(r), flush=True)
        full, cudnn = r["ms"]["full"], r["conv_transpose2d_ms"]
        print(f"    K4 (full) {full:.3f} ms vs F.conv_transpose2d alone {cudnn:.3f} ms: "
              f"{'faster' if full < cudnn else 'SLOWER'}, {cudnn / full:.2f}x", flush=True)
    top = max(rows, key=lambda r: r["ms"]["full"])
    entries = []
    for st in STAGES:
        bound_ms, bound_by = bench_fused_ablate.stage_bound(st, top["batch"], top["cin"], top["cout"], top["h"])
        entries.append(dict(
            name=f"convt_blur_act_stage.{st}", route="cuda", source=K5_SOURCE[0], replaces=K5_SOURCE[1],
            launches=counts[st], max_abs_err=errs[st], ms=top["ms"][st], plain_ms=top["plain_ms"][st],
            bound_ms=bound_ms, bound_by=bound_by,
            library_ms=top["conv_transpose2d_ms"] if st == "conv" else None,
            shape=f"({top['batch']}, {top['cin']}, {top['h']}, {top['h']})->{top['cout']}", run="ablation",
            ms_by_shape={f"{r['cin']}->{r['cout']}@{r['h']}": r["ms"][st] for r in rows},
        ))
    return {"entries": entries, "rows": rows}


# ---------------------------------------------------------------------------
# phases 11-13: the eval slice
# ---------------------------------------------------------------------------


def build_eval():
    """Seeded 256px g_ema, the Inception params, 5000 seeded uint8 "real"
    images on the host (what the recipe's cache holds) and the Evaluator;
    returns them with the seconds of the real set's extraction."""
    gen = torch.Generator(device=DEV).manual_seed(20)
    g_ema = Generator(SIZE, rng=gen, device=DEV)
    randomize_zero_params(g_ema, gen)
    g_ema.eval()
    real = torch.randint(0, 256, (EVAL_N, 3, SIZE, SIZE), generator=gen, device=DEV, dtype=torch.uint8).cpu().numpy()
    # randomized batch-norm statistics: the init's identity ones would leave
    # batch norm untested
    incp = randomize_bn(inception_init_np(0), seed=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ev = Evaluator(g_ema.cfg, fid_real_samples=real, inception_nsamples=EVAL_N, batch_size=REAL_BATCH,
                   n_sample_store=25, inception_params=incp, gen_batch=GEN_BATCH, seed=0, device=DEV)
    torch.cuda.synchronize()
    return g_ema, ev, incp, real, time.perf_counter() - t0


def eval_slice(g_ema, ev) -> dict:
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    score = ev.compute_inception_score(g_ema)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    print(f"  FID@{EVAL_N} (seeded Inception, not a quality measure): {score['fid']:.6f}; {wall:.2f} s "
          f"(first call); launches {counts}", flush=True)
    require(math.isfinite(score["fid"]), f"FID is not finite: {score}")
    per_chunk = {"convt_blur_act": 6, "modconv_act": 7, "modconv_epilogue": 0, "fused_bias_act": 8}
    for name, k in per_chunk.items():
        require(counts[name] == k * ev.n_chunks, f"{name} launched {counts[name]} times, not {k} x {ev.n_chunks}")
    mu, cov = ev.last_stats
    t0 = time.perf_counter()
    fd_dev = ev.fid(mu, cov)
    dev_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    fd_scipy = calculate_frechet_distance(*ev.real_stats64(), mu.double().cpu().numpy(), cov.double().cpu().numpy())
    scipy_s = time.perf_counter() - t0
    rel = abs(fd_dev - fd_scipy) / max(abs(fd_scipy), 1e-30)
    print(f"  Fréchet distance: device f32 {fd_dev:.6f} ({dev_s:.3f} s), scipy f64 {fd_scipy:.6f} ({scipy_s:.1f} s "
          f"on the host), relative difference {rel:.3e} (tolerance {FD_TOL})", flush=True)
    require(rel <= FD_TOL, f"device Fréchet distance {fd_dev} vs scipy {fd_scipy}: {rel:.3e} > {FD_TOL}")
    return counts


def eval_vs_plain(g_ema, ev, incp) -> None:
    """8 fixed latents (constant noise) through g_ema and the full Inception on
    the card and on the CPU; then mu/cov of a 16-image run on each."""
    g_cpu = copy.deepcopy(g_ema).cpu()
    ev_cpu = Evaluator(g_ema.cfg, fid_real_samples=np.zeros((1, 3, SIZE, SIZE), np.uint8), inception_nsamples=16,
                       gen_batch=8, inception_params=incp, real_acts=ev._real_acts[:REAL_BATCH], device="cpu")
    z = torch.randn((16, g_ema.cfg.style_dim), generator=torch.Generator().manual_seed(21))
    t0 = time.perf_counter()
    with torch.inference_mode():
        img_c = g_cpu([z[:8]])[0]
        acts_c = ev_cpu.inception.pool3(img_c)
        img_g = g_ema([z[:8].to(DEV)], fast=True)[0]
        acts_g = ev.inception.pool3(img_g)
    mu_c, cov_c = _stats_from_acts(ev_cpu.activations(g_cpu, z))
    cpu_s = time.perf_counter() - t0
    mu_g, cov_g = _stats_from_acts(ev.activations(g_ema, z.to(DEV)))
    worst = 0.0
    for name, got, ref in [("images", img_g, img_c), ("activations", acts_g, acts_c), ("mu", mu_g, mu_c),
                           ("cov", cov_g, cov_c)]:
        _, rel = rel_err(got.cpu(), ref)
        worst = max(worst, rel)
        print(f"  {name}: max|d|/max|ref| = {rel:.3e}")
        require(rel <= SLICE_TOL, f"eval slice vs plain, {name}: {rel:.3e} > {SLICE_TOL}")
    print(f"  CPU side {cpu_s:.1f} s; worst {worst:.3e} (tolerance {SLICE_TOL})", flush=True)


def measure_eval(g_ema, ev, real, card: str) -> dict:
    """fid5k_eval_s (one compute_inception_score, host clock) with TF32 off
    and on for the convolutions; its split, measured as separate runs of
    the same work: generation alone (n_chunks batches of 100, fresh noise),
    Inception alone on one batch of 100 generated images (n_chunks times),
    the statistics and the device Fréchet distance; the real set's
    extraction; Inception img/s."""
    out = {}
    gen = torch.Generator(device=DEV).manual_seed(22)
    for tf32 in (False, True):
        torch.backends.cudnn.allow_tf32 = tf32
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        score = ev.compute_inception_score(g_ema)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        with torch.inference_mode():
            t0 = time.perf_counter()
            for _ in range(ev.n_chunks):
                z = torch.randn((ev.gen_batch, ev.latent), generator=gen, device=DEV)
                imgs, _ = g_ema([z], rng=gen, fast=True)
            torch.cuda.synchronize()
            gen_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            for _ in range(ev.n_chunks):
                acts = ev.inception.pool3(imgs)
            torch.cuda.synchronize()
            inc_s = time.perf_counter() - t0
        mu, cov = ev.last_stats
        t0 = time.perf_counter()
        ev.fid(mu, cov)
        fd_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        get_activations(real, REAL_BATCH, ev.inception)
        torch.cuda.synchronize()
        real_s = time.perf_counter() - t0
        key = "tf32" if tf32 else "f32"
        out[key] = dict(fid5k_eval_s=total, generation_s=gen_s, inception_s=inc_s, frechet_s=fd_s,
                        real_extraction_s=real_s, inception_img_per_s=ev.gen_batch * ev.n_chunks / inc_s,
                        fid=score["fid"])
        print(f"  TF32 {'on ' if tf32 else 'off'}: fid5k_eval_s {total:.3f} s = generation {gen_s:.3f} + Inception "
              f"{inc_s:.3f} + Fréchet {fd_s:.3f} (separate runs; sum {gen_s + inc_s + fd_s:.3f}); real-set "
              f"extraction ({EVAL_N} uint8, batch {REAL_BATCH}) {real_s:.3f} s; Inception 299px batch "
              f"{ev.gen_batch}: {out[key]['inception_img_per_s']:.1f} img/s; FID {score['fid']:.6f} [{card}]", flush=True)
        del acts, imgs
    torch.backends.cudnn.allow_tf32 = False
    return out


# ---------------------------------------------------------------------------
# phase 14: the train CLI
# ---------------------------------------------------------------------------

# the README recipe's flags at full width (256px, batch 2), depth cut to fit
# the script's time: the first run covers iterations 0-20, the second resumes
# at the checkpoint of 15 and runs 15-30
CLI_ITERS, CLI_RESUME_ITERS, CLI_CKPT_STEP = 10, 20, 15
CLI_FLAGS = [
    "--size", "256", "--batch", "2", "--n_sample_train", "10", "--num_fisher_img", "5", "--fisher_quantile", "40",
    "--prune_quantile", "0.1", "--allow_random_fisher_noise", "--eval_in_training", "--store_samples",
    "--store_checkpoints", "--warmup_iter", "4", "--fisher_freq", "8", "--eval_in_training_freq", "10",
    "--samples_freq", "10", "--checkpoints_freq", "15", "--n_sample_test", "1000",
]
CLI_EVAL_STEPS, CLI_N_TEST = (0, 10, 20, 30), 1000
CKPT_TOL = 1e-6  # g_ema of the .pt vs of the .state.npz, max|d| / max|ref|: the same weights


def write_synthetic_store(root: str, size: int, n_train: int, n_test: int, *, seed: int = 0) -> None:
    """Record stores of PNG blobs in the CLI's layout: smooth random images
    (random (size/8)^2 pixels scaled up bilinearly, as bench.py makes them
    with PIL), encoded by the port's PNG encoder."""
    rng = np.random.default_rng(seed)
    small_side = max(size // 8, 2)
    for split, n in (("_processed_train", n_train), ("_processed_test", n_test)):
        with RecordStoreWriter(os.path.join(root, split, "babies")) as w:
            for start in range(0, n, 100):
                small = rng.integers(0, 255, (min(100, n - start), 3, small_side, small_side), dtype=np.uint8)
                big = torch.nn.functional.interpolate(torch.from_numpy(small).float(), size=(size, size),
                                                      mode="bilinear", align_corners=False)
                for k, img in enumerate(big.round().clamp(0, 255).to(torch.uint8).permute(0, 2, 3, 1).numpy()):
                    w.put(start + k, encode_png(img, level=1))


def cli_flags(root: str) -> list:
    return ["--data_root", root, "--output_root", os.path.join(root, "out"), "--exp", "cli",
            "--sample_noise", os.path.join(root, "noise.pt"), "--fisher_noise_dir", os.path.join(root, "_noise")]


def grid_shape(n: int, nrow: int, size: int) -> tuple:
    rows = (n + nrow - 1) // nrow
    return rows * (size + 2) + 2, nrow * (size + 2) + 2, 3


def check_cli_runs(out: str, first: dict, second: dict, *, size: int, device, resume_step: int, last_step: int,
                   eval_steps, sample_steps, n_store: int = 25) -> dict:
    """The checks of a first run and its --auto_resume run (in `out`, the
    run's output_path); returns what they read."""
    ckpt = Path(out) / "checkpoints"
    require(first["start_iter"] == 0, f"the first run started at {first['start_iter']}")
    require(second["start_iter"] == resume_step, f"the second run resumed at {second['start_iter']}, not {resume_step}")
    recs = [json.loads(line) for line in (Path(out) / "stats.jsonl").read_text().splitlines()]
    losses = [r for r in recs if "d" in r]
    require(bool(losses), "stats.jsonl holds no losses")
    for r in losses:
        bad = [k for k, v in r.items() if not math.isfinite(v)]
        require(not bad, f"stats.jsonl step {r['step']}: {bad} not finite")
    fids = [(r["step"], r["fid"]) for r in recs if "fid" in r]
    require({s for s, _ in fids} == set(eval_steps), f"FID logged at {sorted({s for s, _ in fids})}, not {eval_steps}")
    require(all(math.isfinite(f) for _, f in fids), f"a FID is not finite: {fids}")
    best = float(np.loadtxt(ckpt / "best_fid.txt").reshape(-1)[0])
    require(best == min(f for _, f in fids), f"best_fid.txt {best} is not the lowest FID logged {fids}")
    require((ckpt / "best.pt").exists(), "no best.pt")
    pngs = {"real.png": grid_shape(10, 5, size)}
    pngs.update({f"samples/{i:06d}.png": grid_shape(n_store, int(n_store**0.5), size) for i in sample_steps})
    for name, shape in pngs.items():
        img = decode_png((Path(out) / name).read_bytes())
        require(img.shape == shape, f"{name}: {img.shape} != {shape}")

    # the .pt and the .state.npz of one step hold the same g_ema
    gcfg, dcfg = GeneratorConfig(size), DiscriminatorConfig(size)
    tcfg = TrainConfig(batch=2, augment=False)
    tree, manifest = load_state(str(ckpt / f"{resume_step:06d}.state.npz"))
    require(manifest["step"] == resume_step, f"manifest {manifest}")
    g_ema_npz = train_state_from_jax(gcfg, dcfg, tree, tcfg=tcfg, device=device).g_ema.eval()
    rng = torch.Generator(device=device).manual_seed(30)
    g_ema_pt = Generator(size, rng=rng, device=device).eval()
    load_checkpoint(str(ckpt / f"{resume_step:06d}.pt"), device, g_ema=g_ema_pt)
    z = torch.randn((4, gcfg.style_dim), generator=rng, device=device)
    with torch.inference_mode():
        ref, got = g_ema_npz([z], fast=True)[0], g_ema_pt([z], fast=True)[0]
    _, ckpt_rel = rel_err(got, ref)
    require(ckpt_rel <= CKPT_TOL, f"{resume_step:06d}.pt's g_ema vs the .state.npz's: {ckpt_rel:.3e} > {CKPT_TOL}")

    # loading the last .state.npz and saving it again gives the same arrays
    last = ckpt / f"{last_step:06d}.state.npz"
    tree, manifest = load_state(str(last))
    state = train_state_from_jax(gcfg, dcfg, tree, tcfg=tcfg, device=device)
    with tempfile.TemporaryDirectory() as tmp:
        again = os.path.join(tmp, last.name)
        save_state(again, train_state_to_jax(state), step=manifest.pop("step"), extra=manifest)
        with np.load(last) as a, np.load(again) as b:
            require(sorted(a.files) == sorted(b.files), f"{last.name} re-saved with other keys")
            differ = [k for k in a.files if a[k].dtype != b[k].dtype or not np.array_equal(a[k], b[k])]
            require(not differ, f"{last.name} re-saved with other arrays: {differ[:5]}")
            n_arrays = len(a.files)
    return dict(fids=fids, best_fid=best, ckpt_rel=ckpt_rel, n_arrays=n_arrays, pngs=len(pngs))


class SectionTimer:
    """Host seconds of the CLI's sections, each between two synchronizes:
    for the runs, the functions `cli/train.py` calls (and the Evaluator's
    construction, which extracts the real set, and its evaluation) are
    wrapped in place, and restored after.  The synchronizes take away the
    overlap of one section's enqueue with the last one's device work."""

    NAMES = ("run_iteration", "fisher_round", "sample_images", "Snapshot", "get_nsamples", "Evaluator")

    def __init__(self):
        self.seconds = {}

    def _wrap(self, name, fn):
        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            self.seconds.setdefault(name, []).append(time.perf_counter() - t0)
            return out
        return timed

    def __enter__(self):
        self._orig = {name: getattr(train_cli, name) for name in self.NAMES}
        for name, fn in self._orig.items():
            setattr(train_cli, name, self._wrap(name, fn))
        self._score = Evaluator.compute_inception_score
        Evaluator.compute_inception_score = self._wrap("evaluation", self._score)
        return self

    def __exit__(self, *exc):
        for name, fn in self._orig.items():
            setattr(train_cli, name, fn)
        Evaluator.compute_inception_score = self._score
        return False

    def take(self) -> dict:
        """{section: (count, total s)} since the last take."""
        out = {k: (len(v), sum(v)) for k, v in self.seconds.items()}
        self.seconds = {}
        return out


def cli_phase(card: str, root: str) -> tuple:
    """Phase 14, on a store it writes under `root`; returns the launches of
    the two runs, and the first run's metrics per iteration with a copy of
    its checkpoint of CLI_CKPT_STEP (the resumed run writes that step again),
    which phase 18 (a) is held to."""
    t0 = time.perf_counter()
    write_synthetic_store(root, SIZE, 10, CLI_N_TEST)
    print(f"  synthetic store: 10 train + {CLI_N_TEST} test PNGs at {SIZE}px in {time.perf_counter() - t0:.1f} s",
          flush=True)
    flags = cli_flags(root) + CLI_FLAGS
    runs = {}
    torch.cuda.synchronize()
    reset_launch_counts()
    with SectionTimer() as timer:
        for label, extra in (("first", ["--iter", str(CLI_ITERS)]),
                             ("resumed", ["--iter", str(CLI_RESUME_ITERS), "--auto_resume"])):
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            with recorded_metrics() as metrics:
                runs[label] = train_cli.main(flags + extra)
            torch.cuda.synchronize()
            runs[label].update(wall_s=time.perf_counter() - t0, peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                               sections=timer.take())
            if label == "first":
                n_iter, iter_s = runs[label]["sections"]["run_iteration"]
                first = {"metrics": [{k: float(v) for k, v in m.items()} for m in metrics],
                         "ckpt": os.path.join(root, f"first_{CLI_CKPT_STEP:06d}.state.npz"),
                         "iteration_s": iter_s / n_iter}
                shutil.copy(os.path.join(root, "out", "cli", "checkpoints", f"{CLI_CKPT_STEP:06d}.state.npz"),
                            first["ckpt"])
    counts = launch_counts()
    print(f"  launches in the two CLI runs: {counts}", flush=True)
    for label, r in runs.items():
        print(f"  CLI {label} run: iterations {r['start_iter']}-{r['start_iter'] + r['iterations'] - 1} "
              f"({r['iterations']}), {r['fisher_rounds']} Fisher rounds, {r['evaluations']} evaluations of "
              f"{CLI_N_TEST} samples; wall {r['wall_s']:.3f} s = before the loop {r['wall_s'] - r['seconds']:.3f} "
              f"+ loop and final writes {r['seconds']:.3f}; peak device memory {r['peak_gib']:.2f} GiB [{card}]",
              flush=True)
        in_loop = ("run_iteration", "fisher_round", "evaluation", "sample_images", "Snapshot")
        rest = r["seconds"] - sum(r["sections"].get(k, (0, 0.0))[1] for k in in_loop)
        print("    sections (synchronized): " + "; ".join(
            f"{k} {n} x {tot / n:.4f} = {tot:.3f} s" for k, (n, tot) in r["sections"].items())
            + f"; the rest of the loop and the final writes {rest:.3f} s", flush=True)
    got = check_cli_runs(os.path.join(root, "out", "cli"), runs["first"], runs["resumed"], size=SIZE, device=DEV,
                         resume_step=CLI_CKPT_STEP, last_step=CLI_RESUME_ITERS + 10, eval_steps=CLI_EVAL_STEPS,
                         sample_steps=CLI_EVAL_STEPS)
    print(f"  FID@{CLI_N_TEST} by step (seeded Inception): {got['fids']}; best_fid.txt {got['best_fid']:.6f}; "
          f"{CLI_CKPT_STEP:06d}.pt vs .state.npz g_ema {got['ckpt_rel']:.3e} of max|ref|; "
          f"{got['n_arrays']} arrays re-saved bitwise; {got['pngs']} PNGs decoded", flush=True)
    require(all(counts[k] > 0 for k in SOURCES), f"a kernel did not launch in the CLI runs: {counts}")
    return counts, first


@contextlib.contextmanager
def recorded_metrics():
    """The metrics (device tensors) of every `run_iteration` the train CLI
    calls inside the block, in order."""
    out, inner = [], train_cli.run_iteration

    def recording(*args, **kwargs):
        out.append(inner(*args, **kwargs))
        return out[-1]

    train_cli.run_iteration = recording
    yield out
    train_cli.run_iteration = inner


# ---------------------------------------------------------------------------
# phase 15: ADA in the training phases
# ---------------------------------------------------------------------------

ADA_MARGIN = 224  # the recipe's --ada_margin
# the augment on the card vs the CPU, images and the image gradient, of
# max|ref| (TF32 off): the same gather and coordinates, the FIR's convolutions
# summed in another order by cuDNN, the scatter-add's atomics in any order
ADA_TOL = 1e-5
# ada_p, ada_stats and r_t, card vs CPU: the same signs of the real scores,
# sums of at most 256 of +-1, one f32 step of p
ADA_STATE_TOL = 1e-6
ADA_START_P, ADA_START_STATS = 0.5, (0.0, 254.0)  # the D phase's 2 real scores make 256 > 255: p steps
ADA_CLI_FLAGS = [
    "--size", "256", "--batch", "2", "--n_sample_train", "10", "--num_fisher_img", "5", "--fisher_quantile", "40",
    "--prune_quantile", "0.1", "--allow_random_fisher_noise", "--eval_in_training", "--store_samples",
    "--warmup_iter", "4", "--fisher_freq", "8", "--eval_in_training_freq", "10", "--samples_freq", "10",
    "--n_sample_test", "100", "--iter", "0", "--augment", "--exp", "ada",
]


def augment_vs_cpu() -> float:
    """(a) The 256px augment at batch B, p = 1 matrices made on the CPU, on
    the card against the CPU: the images and the gradient of sum(out * w)
    with respect to the image; then G = C = I, on the card against the CPU,
    and on a constant image, which must come back (the sym6 pair's gain is 1).
    Returns the largest error relative to max|ref|."""
    gen = torch.Generator().manual_seed(40)
    img, w = torch.randn((B, 3, SIZE, SIZE), generator=gen), torch.randn((B, 3, SIZE, SIZE), generator=gen)
    one = torch.ones(())
    eye = (torch.eye(3).repeat(B, 1, 1), torch.eye(4).repeat(B, 1, 1))
    cases = {"p = 1": (sample_affine(gen, one, B, SIZE, SIZE), sample_color(gen, one, B)), "G = C = I": eye}
    worst = 0.0
    for label, transform in cases.items():
        outs = {}
        for dev in ("cpu", DEV):
            x = img.to(dev).requires_grad_(True)
            out, _ = augment(x, one.to(dev), margin=ADA_MARGIN, transform=tuple(m.to(dev) for m in transform))
            (grad,) = torch.autograd.grad((out * w.to(dev)).sum(), x)
            outs[dev] = (out.detach().cpu(), grad.cpu())
        for what, got, ref in zip(("images", "gradient"), outs[DEV], outs["cpu"]):
            _, rel = rel_err(got, ref)
            worst = max(worst, rel)
            print(f"  augment {label}, {what}: card vs CPU {rel:.3e} of max|ref|", flush=True)
            require(bool(torch.isfinite(got).all()) and rel <= ADA_TOL, f"augment {label} {what}: {rel:.3e}")
    flat = torch.full((B, 3, SIZE, SIZE), 0.75, device=DEV)
    with torch.no_grad():
        out, _ = augment(flat, one.to(DEV), margin=ADA_MARGIN, transform=tuple(m.to(DEV) for m in eye))
    _, rel = rel_err(out, flat)
    print(f"  augment G = C = I of a constant image: {rel:.3e} of it", flush=True)
    require(rel <= ADA_TOL, f"augment G = C = I does not keep a constant image: {rel:.3e}")
    return worst


def ada_state(tcfg: TrainConfig):
    """A seeded 256px training state on the card for `tcfg` (augment on)."""
    wgen = torch.Generator(device=DEV).manual_seed(20)
    g = Generator(SIZE, rng=wgen, device=DEV)
    d = Discriminator(SIZE, rng=wgen, device=DEV)
    randomize_zero_params(g, wgen)
    randomize_zero_params(d, wgen)
    return init_train_state(GeneratorConfig(SIZE), DiscriminatorConfig(SIZE), tcfg, rng=wgen, device=DEV, g=g, d=d)


def ada_train_slice():
    """(b) A seeded 256px state with augment and the adaptive p, at p 0.5
    with 254 predictions pooled; run_iteration at TRAIN_ITERS.  The first D
    phase makes the update fire: p must move by exactly sign * ada_step *
    256 there and nowhere else.  Returns (state, tcfg, launches)."""
    dev = DEV
    tcfg = TrainConfig(batch=2, augment=True, warmup_iter=1, ada_margin=ADA_MARGIN)
    state = ada_state(tcfg)
    state.ada_p = torch.full((), ADA_START_P, device=dev)
    state.ada_stats = torch.tensor(ADA_START_STATS, device=dev)
    gen = torch.Generator(device=dev).manual_seed(21)
    torch.cuda.synchronize()
    reset_launch_counts()
    ps = [ADA_START_P]
    for i in TRAIN_ITERS:
        real = torch.randn((tcfg.batch, 3, SIZE, SIZE), generator=gen, device=dev)
        m = run_iteration(state, tcfg, real, i, gen=gen)
        for k, v in m.items():
            require(bool(torch.isfinite(v).all()), f"ADA iteration {i}: metric {k} is not finite")
        ps.append(float(state.ada_p))
        print(f"  i={i}: " + ", ".join(f"{k} {float(v):.6f}" for k, v in m.items())
              + f", ada_stats {state.ada_stats.tolist()}", flush=True)
        if i == TRAIN_ITERS[0]:
            sign = 1.0 if float(m["r_t"]) > tcfg.ada_target else -1.0
            want = float(torch.tensor(ADA_START_P) + sign * tcfg.ada_step * 256.0)
            require(abs(ps[-1] - want) <= ADA_STATE_TOL and ps[-1] != ADA_START_P,
                    f"p after the update {ps[-1]!r}, not {want!r}")
    torch.cuda.synchronize()
    counts = launch_counts()
    require(ps[2:] == ps[1:-1], f"p moved without an update: {ps}")
    for name in ("g", "d", "g_ema", "d_ema"):
        for k, p in getattr(state, name).named_parameters():
            require(bool(torch.isfinite(p).all()), f"ADA run: {name}.{k} is not finite")
    check_counts(state, TRAIN_ITERS, tcfg)
    print(f"  p by iteration {ps} (ada_step {tcfg.ada_step:.3e}); launches in the ADA run: {counts}", flush=True)
    training = ("fused_bias_act", "fused_bias_act_bwd", "modconv_epilogue")
    require(all(counts[k] > 0 for k in training), f"a training kernel did not launch with ADA: {counts}")
    return state, tcfg, counts


def measure_augment(card: str) -> dict:
    """(d) The augment call alone at 256px, margin 224: forward at batch B
    (the D phase's reals and fakes), forward and backward at batch 2 (the G
    phase); CUDA events."""
    gen = torch.Generator(device=DEV).manual_seed(22)
    p = torch.full((), 0.5, device=DEV)
    x4 = torch.randn((B, 3, SIZE, SIZE), generator=gen, device=DEV)
    t4 = (sample_affine(gen, p, B, SIZE, SIZE), sample_color(gen, p, B))
    x2 = torch.randn((2, 3, SIZE, SIZE), generator=gen, device=DEV).requires_grad_(True)
    t2 = (sample_affine(gen, p, 2, SIZE, SIZE), sample_color(gen, p, 2))

    def fwd():
        with torch.no_grad():
            augment(x4, p, margin=ADA_MARGIN, transform=t4)

    def fwd_bwd():
        torch.autograd.grad(augment(x2, p, margin=ADA_MARGIN, transform=t2)[0].sum(), x2)

    ms = {"augment_fwd_b4": cuda_ms(fwd, iters=10), "augment_fwd_bwd_b2": cuda_ms(fwd_bwd, iters=10)}
    print(f"  augment forward, batch {B}: {ms['augment_fwd_b4']:.3f} ms; forward and backward, batch 2: "
          f"{ms['augment_fwd_bwd_b2']:.3f} ms [{card}]", flush=True)
    return ms


def ada_ab(state, card: str, rounds: int = 3) -> dict:
    """(d) The D and G phases without and with ADA (p = 0.5) on one state,
    alternated for `rounds` rounds of 5 calls each: the host-bound phases
    move by several ms between blocks of one call, so each side is the
    median of its rounds.  Returns {(phase, augment): ms}."""
    gen = torch.Generator(device=DEV).manual_seed(23)
    gcfg = state.g.cfg
    real = torch.randn((2, 3, SIZE, SIZE), generator=gen, device=DEV)
    cfgs = {aug: TrainConfig(batch=2, augment=aug, augment_p=0.5, warmup_iter=1, ada_margin=ADA_MARGIN)
            for aug in (False, True)}

    def run(phase, tcfg):
        n = 2 * tcfg.batch if phase == "D" else tcfg.batch
        draws = sample_draws(gen, gcfg, tcfg, tcfg.batch, ada_p=state.ada_p, ada_batch=n)
        if phase == "D":
            steps.d_phase(state, tcfg, real, draws, False)
        else:
            steps.g_phase(state, tcfg, draws, False, do_ema=True)

    runs = {}
    for _ in range(rounds):
        for aug, tcfg in cfgs.items():
            for phase in ("D", "G"):
                runs.setdefault((phase, aug), []).append(cuda_ms(lambda: run(phase, tcfg), iters=5))
    ms = {k: float(np.median(v)) for k, v in runs.items()}
    print("  D and G without / with ADA, alternated, median of " + f"{rounds} rounds of 5: " + "; ".join(
        f"{ph} {ms[(ph, False)]:.2f} / {ms[(ph, True)]:.2f} (rounds {[round(x, 2) for x in runs[(ph, False)]]} / "
        f"{[round(x, 2) for x in runs[(ph, True)]]})" for ph in ("D", "G")) + f" ms [{card}]", flush=True)
    return ms


def ada_cli_run(card: str, root: str, flags=None, label: str = "--augment") -> dict:
    """(e) The train CLI with --augment (adaptive p) on phase 14's store:
    iterations 0-10, FID@100 at 0 and 10, sample grids.  Returns its
    launches."""
    flags = ADA_CLI_FLAGS if flags is None else flags
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    r = train_cli.main(cli_flags(root) + flags)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    exp = flags[flags.index("--exp") + 1]
    recs = [json.loads(line) for line in (Path(root) / "out" / exp / "stats.jsonl").read_text().splitlines()]
    fids = [(rec["step"], rec["fid"]) for rec in recs if "fid" in rec]
    print(f"  CLI {label} run: iterations {r['iterations']}, {r['fisher_rounds']} Fisher rounds, {r['evaluations']} "
          f"evaluations of 100 samples, FID {fids}, logged p {[rec['ada_p'] for rec in recs if 'ada_p' in rec]}; "
          f"wall {wall:.3f} s [{card}]; launches {counts}", flush=True)
    require((r["iterations"], r["evaluations"]) == (11, 2), f"the CLI {label} run stopped early: {r}")
    require(all(math.isfinite(f) for _, f in fids), f"a FID is not finite: {fids}")
    require(all(counts[k] > 0 for k in SOURCES), f"a kernel did not launch in the CLI {label} run: {counts}")
    return counts


# ---------------------------------------------------------------------------
# phase 16: scoring (precision/recall, intra-LPIPS, the metric CLIs)
# ---------------------------------------------------------------------------

SCORE_B = 4  # (a): VGG16 fc2 of 4 images, LPIPS of 4 pairs, 256px
DIST_CHECK_N = 500  # (b): rows of the device f64 distances held to numpy's
VGG_TIMED_BATCHES = 10  # (b): batches of 100 in VGG16's img/s
# the device f64 distances and radii against numpy's on the same features,
# max|d| / max|ref|: two f64 GEMMs of 4096 terms summed in another order
DIST_TOL = 1e-12
# (c): samples scored both ways (taps once, and rick_tpu's loops, ~0.13 s a
# sample at 256px there): cut from the CLI's 1000 to keep phase 16 near 90 s
INTRA_REF_N = 50
INTRA_REF_TOL = 1e-5  # the two ways' values, relative: the same taps, batched otherwise
CLI_SET_N = 1000  # (d): images in each .npy set


def vgg_lpips_vs_cpu() -> float:
    """(a) VGG16 fc2 features and LPIPS (the default, seeded weights) on the
    card against the CPU on the same seeded images; returns the worst
    max|d| / max|ref|."""
    params = vgg16_init()
    gen = torch.Generator().manual_seed(30)
    x0, x1 = (torch.rand((SCORE_B, 3, SIZE, SIZE), generator=gen) * 2 - 1 for _ in range(2))
    lin = default_lin_weights()
    out = {}
    for dev in (DEV, "cpu"):
        vgg = vgg16_from_params(params, device=dev)
        with torch.inference_mode():
            out[dev] = (vgg16_fc2_features(vgg, x0.to(dev)).cpu(),
                        lpips_distance(x0.to(dev), x1.to(dev), vgg=vgg, lin_weights=lin).cpu())
    worst = 0.0
    for name, got, ref in zip(("fc2 features", "LPIPS"), out[DEV], out["cpu"]):
        _, rel = rel_err(got, ref)
        worst = max(worst, rel)
        print(f"  {name}: max|d|/max|ref| = {rel:.3e}", flush=True)
        require(rel <= SLICE_TOL, f"{name} card vs CPU: {rel:.3e} > {SLICE_TOL}")
    return worst


def pr_eval(g_ema, ev, incp, real, card: str) -> dict:
    """(b) The recipe's Evaluator with compute_pr on phase 11's g_ema and
    real set (its activations reused); one compute_inception_score(pr=True):
    P&R in [0, 1], K1/K3/K4 launched for both the FID's and P&R's 5000
    draws; the P&R side's seconds (VGG16 and the distances timed in the
    call); the device f64 distances and radii against numpy's on 500 rows;
    VGG16 img/s.  Returns the launches of the call."""
    ev_pr = Evaluator(g_ema.cfg, fid_real_samples=real, inception_nsamples=EVAL_N, batch_size=REAL_BATCH,
                      n_sample_store=25, inception_params=incp, gen_batch=GEN_BATCH, seed=0, device=DEV,
                      compute_pr=True, real_acts=ev._real_acts)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ev_pr.ipr.compute_manifold_ref(ev_pr.real)
    torch.cuda.synchronize()
    real_s = time.perf_counter() - t0
    reset_launch_counts()
    with Timed(Evaluator, "vgg_features") as t_vgg, \
            Timed(evaluator_module, "manifold_device", "precision_and_recall_device") as t_dist:
        t0 = time.perf_counter()
        score = ev_pr.compute_inception_score(g_ema, pr=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = launch_counts()
    pr_s = t_vgg.seconds["vgg_features"] + sum(t_dist.seconds.values())
    print(f"  compute_inception_score(pr=True), {EVAL_N} + {EVAL_N} draws: FID {score['fid']:.6f}, precision "
          f"{score['precision']:.4f}, recall {score['recall']:.4f} (seeded VGG16, not a quality measure); "
          f"{wall:.3f} s = FID side {wall - pr_s:.3f} + pr5k_s {pr_s:.3f} (generation + VGG16 fc2 "
          f"{t_vgg.seconds['vgg_features']:.3f}, f64 manifold, radii and both metrics on the device "
          f"{sum(t_dist.seconds.values()):.3f}); launches {counts} [{card}]", flush=True)
    require(0.0 <= score["precision"] <= 1.0 and 0.0 <= score["recall"] <= 1.0, f"P&R out of [0, 1]: {score}")
    require(math.isfinite(score["fid"]), f"FID is not finite: {score}")
    per_chunk = {"convt_blur_act": 6, "modconv_act": 7, "modconv_epilogue": 0, "fused_bias_act": 8}
    for name, k in per_chunk.items():
        require(counts[name] == 2 * k * ev_pr.n_chunks,
                f"{name} launched {counts[name]} times, not {k} x {ev_pr.n_chunks} for each of FID and P&R")

    # VGG16 alone on one generated batch, and numpy's distances (the plain version) on the host
    gen = torch.Generator(device=DEV).manual_seed(31)
    with torch.inference_mode():
        imgs, _ = g_ema([torch.randn((GEN_BATCH, ev_pr.latent), generator=gen, device=DEV)], rng=gen, fast=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(VGG_TIMED_BATCHES):
            vgg16_fc2_features(ev_pr.ipr.vgg, imgs)
        torch.cuda.synchronize()
    vgg_s = time.perf_counter() - t0
    ref = ev_pr.ipr.manifold_ref
    f_np = ref.features.cpu().numpy()
    t0 = time.perf_counter()
    distances2radii(compute_pairwise_distances(f_np), k=ev_pr.ipr.k)
    numpy_s = time.perf_counter() - t0
    print(f"  VGG16 fc2 alone (224px, batch {GEN_BATCH}, {VGG_TIMED_BATCHES} batches) "
          f"{GEN_BATCH * VGG_TIMED_BATCHES / vgg_s:.1f} img/s; numpy: one {EVAL_N}^2 matrix and its radii "
          f"{numpy_s:.3f} s on the host; the real manifold ({EVAL_N} uint8, batch {REAL_BATCH}) {real_s:.3f} s, "
          f"once [{card}]", flush=True)

    feats = ev_pr.vgg_features(g_ema, torch.randn((DIST_CHECK_N, ev_pr.latent), generator=gen, device=DEV), rng=gen)
    sub_r, sub_f = ref.features[:DIST_CHECK_N], feats
    d_np = compute_pairwise_distances(sub_r.cpu().numpy(), sub_f.cpu().numpy())
    _, d_rel = rel_err(pairwise_distances_device(sub_r, sub_f).cpu(), torch.from_numpy(d_np))
    r_np = distances2radii(compute_pairwise_distances(sub_r.cpu().numpy()), k=ev_pr.ipr.k)
    _, r_rel = rel_err(radii_device(pairwise_distances_device(sub_r), k=ev_pr.ipr.k).cpu(), torch.from_numpy(r_np))
    print(f"  device f64 vs numpy on {DIST_CHECK_N} rows: distances {d_rel:.3e}, radii {r_rel:.3e} of max|ref| "
          f"(tolerance {DIST_TOL})", flush=True)
    require(d_rel <= DIST_TOL and r_rel <= DIST_TOL, f"device distances {d_rel:.3e} / radii {r_rel:.3e} vs numpy")
    return counts


class Timed:
    """Host seconds spent in the named attributes of `owner`, each call
    between two synchronizes; the attributes are wrapped in place and
    restored after."""

    def __init__(self, owner, *names):
        self.owner, self.names, self.seconds = owner, names, {}

    def __enter__(self):
        self._orig = {name: getattr(self.owner, name) for name in self.names}
        for name, fn in self._orig.items():
            def timed(*args, _fn=fn, _name=name, **kwargs):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = _fn(*args, **kwargs)
                torch.cuda.synchronize()
                self.seconds[_name] = self.seconds.get(_name, 0.0) + time.perf_counter() - t0
                return out
            setattr(self.owner, name, timed)
        return self

    def __exit__(self, *exc):
        for name, fn in self._orig.items():
            setattr(self.owner, name, fn)


def run_cli(main, argv) -> tuple:
    """`main(argv)` in this process: its printed line and its seconds."""
    buf = io.StringIO()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        main(argv)
    torch.cuda.synchronize()
    return buf.getvalue().strip(), time.perf_counter() - t0


def numbers(line: str) -> list:
    """The decimal numbers (nan and inf too) in a CLI's printed line."""
    return [float(x) for x in re.findall(r"-?(?:\d+\.\d+(?:e[-+]?\d+)?|nan|inf)", line)]


def intra_lpips_rick_tpu_way(il, imgs, rng):
    """rick_tpu's IntraLPIPS loops on the card: VGG on both inputs of every
    LPIPS call (the center repeated to the chunk, then each chunk of
    pairs); returns (labels, value)."""
    def dist(a, b):
        return lpips_distance(a, b, vgg=il.vgg, lin_weights=il.lin).cpu().numpy()

    with torch.inference_mode():
        imgs = reference_preprocess(imgs, il.size)
        n, n_centers = imgs.shape[0], il.centers.shape[0]
        dists = np.zeros((n, n_centers))
        for k in range(n_centers):
            center = il.centers[k : k + 1].expand(il.batch, -1, -1, -1)
            for s in range(0, n, il.batch):
                chunk = imgs[s : s + il.batch]
                dists[s : s + chunk.shape[0], k] = dist(chunk, center[: chunk.shape[0]])
        labels = np.argmin(dists, axis=1)
        means = []
        for k in range(n_centers):
            members = np.where(labels == k)[0]
            if len(members) < 2:
                continue
            rng.shuffle(members)
            members = members[: il.cluster_size]
            pair_a, pair_b = (torch.from_numpy(members[p]).to(imgs.device) for p in np.triu_indices(len(members), 1))
            pairs = [dist(imgs[pair_a[s : s + il.batch]], imgs[pair_b[s : s + il.batch]])
                     for s in range(0, len(pair_a), il.batch)]
            means.append(float(np.concatenate(pairs).mean()))
    return labels, float(np.mean(means))


def intra_lpips_phase(root: str, card: str) -> dict:
    """(c) `cli.intra_lpips prepare` on phase 14's 10 training images, then
    `compute` of phase 14's best.pt at the protocol's defaults (1000
    samples, k 10, clusters of 50, batch 8): finite and > 0, K1/K3/K4
    launched; its wall split into sampling, the assignment and the rest of
    compute (the pairs); then INTRA_REF_N of those samples scored by the port and
    by rick_tpu's loops on the card: the labels equal, the values within
    INTRA_REF_TOL, both timed.  Returns the launches of `compute`."""
    store = os.path.join(root, "_processed_train", "babies")
    centers, best = os.path.join(root, "centers"), os.path.join(root, "out", "cli", "checkpoints", "best.pt")
    line, prep_s = run_cli(intra_lpips_cli.main, ["prepare", store, centers])
    print(f"  {line} ({prep_s:.3f} s)", flush=True)
    require(line.startswith("wrote 10 centers"), f"prepare: {line}")
    reset_launch_counts()
    with Timed(intra_lpips_cli, "sample_checkpoint") as t_cli, \
            Timed(IntraLPIPS, "_assign_pre", "compute") as t_il:
        line, wall = run_cli(intra_lpips_cli.main, ["compute", best, centers])
    counts = launch_counts()
    value = numbers(line)[0]
    sample_s, assign_s, compute_s = t_cli.seconds["sample_checkpoint"], t_il.seconds["_assign_pre"], t_il.seconds["compute"]
    print(f"  compute {best} (1000 samples, k 10, clusters of 50, batch 8): {line}; intra_lpips_s {wall:.3f} = "
          f"sampling {sample_s:.3f} + assignment {assign_s:.3f} + pairs (and the preprocess) {compute_s - assign_s:.3f} "
          f"+ the rest (VGG16 load, centers) {wall - sample_s - compute_s:.3f}; launches {counts} [{card}]", flush=True)
    require(math.isfinite(value) and value > 0, f"intra-LPIPS {line}")
    require(all(counts[k] > 0 for k in ("fused_bias_act", "convt_blur_act", "modconv_act")),
            f"a generation kernel did not launch in intra_lpips compute: {counts}")

    samples = intra_lpips_cli.sample_checkpoint(best, SIZE, INTRA_REF_N, 0, torch.device(DEV))
    il = IntraLPIPS(load_cluster_centers(centers, k=10, size=SIZE), device=DEV)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = il.compute(samples, rng=np.random.default_rng(0))
    torch.cuda.synchronize()
    taps_s = time.perf_counter() - t0
    labels = il.assign(samples)
    t0 = time.perf_counter()
    ref_labels, want = intra_lpips_rick_tpu_way(il, samples, np.random.default_rng(0))
    ref_s = time.perf_counter() - t0
    rel = abs(got - want) / abs(want)
    print(f"  {INTRA_REF_N} samples: taps once {got:.6f} in {taps_s:.3f} s, rick_tpu's loops {want:.6f} in "
          f"{ref_s:.3f} s; relative difference {rel:.3e} (tolerance {INTRA_REF_TOL}); cluster sizes "
          f"{np.bincount(labels, minlength=10).tolist()} [{card}]", flush=True)
    require(np.array_equal(labels, ref_labels), "the two ways' labels differ")
    require(rel <= INTRA_REF_TOL, f"intra-LPIPS two ways: {rel:.3e} > {INTRA_REF_TOL}")
    return counts


def metric_clis(g_ema, real, root: str, card: str) -> None:
    """(d) `cli.fid`, `cli.kid` and `cli.precision_recall` on two .npy sets
    of 1000 images: g_ema's (seeded draws) and phase 11's real set."""
    gen = torch.Generator(device=DEV).manual_seed(33)
    with torch.inference_mode():
        fake = torch.cat([g_ema([torch.randn((GEN_BATCH, g_ema.cfg.style_dim), generator=gen, device=DEV)],
                                rng=gen, fast=True)[0] for _ in range(CLI_SET_N // GEN_BATCH)]).cpu().numpy()
    a, b = os.path.join(root, "fake.npy"), os.path.join(root, "real.npy")
    np.save(a, fake)
    np.save(b, real[:CLI_SET_N].astype(np.float32) / 127.5 - 1.0)
    lines = {}
    for name, main, argv in (("fid", fid_cli.main, [b, a]), ("kid", kid_cli.main, [b, a]),
                             ("precision_recall", pr_cli.main, [b, a])):
        lines[name], secs = run_cli(main, argv)
        print(f"  {name} ({CLI_SET_N} + {CLI_SET_N}, default flags): {lines[name]}; {secs:.3f} s [{card}]", flush=True)
    nums = {k: numbers(v) for k, v in lines.items()}
    require(all(math.isfinite(x) for v in nums.values() for x in v), f"a metric CLI printed a non-finite value: {lines}")
    require(all(0.0 <= x <= 1.0 for x in nums["precision_recall"]), f"P&R CLI: {lines['precision_recall']}")


# ---------------------------------------------------------------------------
# phase 17: bf16 (train --bf16, Evaluator(gen_dtype=bf16))
# ---------------------------------------------------------------------------

BF16_SOURCES = {
    "fused_bias_act_bf16": ("rick_tpu_torch/csrc/fused_bias_act.cu", "rick_tpu/ops/pallas_kernels.py:81"),
    "modconv_epilogue_bf16": ("rick_tpu_torch/csrc/modconv_epilogue.cu", "rick_tpu/ops/pallas_kernels.py:176"),
}
BF16_STEP = 2.0**-8  # a bf16 ulp at 1, relative
BF16_KERNEL_TOL = KERNEL_TOL["fused_bias_act_bf16"]
# autograd through the bf16 instantiations vs plain autograd, first grads, of
# max|ref|.  K2 applies the slope before the gain, plain autograd after it:
# an f32 ulp, which the rounding to bf16 may carry to one bf16 step.  So
# K1's gx and K3's d_out one bf16 step, the f32 sums (gb, K3's bias) 1e-5,
# K3's bf16 sums over a layer (demod, noise) four steps, and the noise
# weight's, one sum that cancels to a small part of its terms, SCALAR_TOL
BF16_GRAD_TOL = {"fused_bias_act_bf16": (BF16_STEP, 1e-5),
                 "modconv_epilogue_bf16": (BF16_STEP, 4 * BF16_STEP, 4 * BF16_STEP, SCALAR_TOL, 1e-5)}
# the bf16 D and G phases, card vs CPU, per tensor in norm (step and Adam's
# v): tests/test_torch_bf16.py's rule against rick_tpu.  Fakes that differ
# by a rounding take another bf16 rounding in D's from-RGB layer, which moves
# D's bf16 gradients by a few percent (in f32: 1e-5)
BF16_TRAIN_TOL = 1e-1
BF16_EVAL_TOL = 5e-2  # bf16 vs f32 generation, activations of max|ref|: a bf16 conv1 (~2^-8) through G and Inception
BF16_CLI_FLAGS = ADA_CLI_FLAGS[:-3] + ["--bf16", "--exp", "bf16"]  # phase 15 (e)'s run, --bf16 for --augment


# the bf16 entry points' kernels as the profiler names them, and the
# row-per-block design each replaced (kept in csrc/ as their yardstick: the
# same arithmetic, so bitwise equal outputs are expected)
BF16_KERNELS = {"fused_bias_act_bf16": "fba_bf16_flat", "modconv_epilogue_bf16": "epi_bf16_flat"}
BF16_ROWS = {"fused_bias_act_bf16": ("rick_fused_bias_act_bf16_rows", "fba_rows"),
             "modconv_epilogue_bf16": ("rick_modconv_epilogue_bf16_rows", "epi_rows")}


def bf16_entry(name: str, args: tuple, rows: bool = False, dims=None) -> torch.Tensor:
    """One launch, not counted, of K1-bf16's or K3-bf16's entry point on the
    wrapper's inputs `args` (default slope and gain), or with `rows` of the
    row-per-block kernel it replaced; `dims` None or a ctypes int[3] that
    receives the flat kernel's grid x, grid y and threads.  Returns y."""
    lib, stream = _build.lib(), _build.stream_ptr(args[0].device)
    y = torch.empty_like(args[0], dtype=torch.float32)
    act = (0.2, math.sqrt(2.0), stream)
    if name == "fused_bias_act_bf16":
        x, b = args
        inner = 1 if x.ndim == 2 else math.prod(x.shape[2:])
        c_args = (x.data_ptr(), b.data_ptr(), y.data_ptr(), x.numel(), x.shape[-1] if x.ndim == 2 else x.shape[1],
                  inner) + act
    else:
        out, demod, noise, nw, bias = args
        bsz, c, h, w = out.shape
        c_args = (out.data_ptr(), demod.data_ptr(), noise.data_ptr(), nw.data_ptr(), bias.data_ptr(), y.data_ptr(),
                  bsz, c, h * w, int(noise.shape[0] == bsz)) + act
    entry = getattr(lib, BF16_ROWS[name][0] if rows else f"rick_{name}")
    _build.check(entry(*c_args) if rows else entry(*c_args, dims), name)
    return y


def bf16_case(name: str, label: str, args: tuple, turns: bool = False):
    """A case of K1-bf16 or K3-bf16 on `args`, with its launch floor: the
    empty kernel at the grid the entry point reports for these inputs;
    `turns`: time it against the row-per-block kernel in turns."""
    dims = (ctypes.c_int * 3)()
    bf16_entry(name, args, dims=dims)
    gx, gy, threads = dims
    floor = lambda: _build.lib().rick_empty_launch(gx, gy, threads, _build.stream_ptr(args[0].device))  # noqa: E731
    x = args[0]
    if name == "fused_bias_act_bf16":
        c = x.shape[-1] if x.ndim == 2 else x.shape[1]
        return case(name, label, lambda: fused_bias_act(*args), lambda: fused_bias_act_ref(*args),
                    fused_bias_act_bytes(x.numel(), c, 2), 3 * x.numel(), kernel=BF16_KERNELS[name], floor=floor,
                    args=args, turns=turns)
    bsz, c, h, w = x.shape
    return case(name, label, lambda: modconv_epilogue(*args), lambda: modconv_epilogue_ref(*args),
                modconv_epilogue_bytes(bsz, c, h * w, args[2].shape[0], 2), 6 * x.numel(), kernel=BF16_KERNELS[name],
                floor=floor, args=args, turns=turns)


def bf16_kernel_cases(gen: torch.Generator):
    """K1-bf16 at D's from-RGB activation of the 256px batch-2 bf16 phases
    and K3-bf16 at G's conv1 (noise batch 2, fresh, and 1, the buffers): the
    main-path shapes.  Then shapes that reach each of their other paths:
    8-byte loads (inner % 8 == 4), single elements (odd inner; a bf16 input
    2 bytes past a 16-byte boundary, a contiguous slice of a larger buffer;
    K1's 2-D (N, C) layout), and K3-bf16 at the streaming shape
    (4,128,256,256).  Returns (main, others)."""
    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=DEV) * scale

    def bf16(*shape, misaligned=False):
        if not misaligned:
            return randn(*shape).bfloat16()
        buf = randn(math.prod(shape) + 1).bfloat16()
        t = buf[1:].view(shape)
        require(t.data_ptr() % 16 == 2, f"the misaligned view starts at {t.data_ptr() % 16} past 16 bytes")
        return t

    def fba(shape, misaligned=False):
        return bf16(*shape, misaligned=misaligned), randn(shape[-1] if len(shape) == 2 else shape[1], scale=0.1)

    def epi(shape, nb, misaligned=False):
        bsz, c, h, w = shape
        return (bf16(*shape, misaligned=misaligned), (torch.rand((bsz, c), generator=gen, device=DEV) + 0.5).bfloat16(),
                bf16(nb, 1, h, w), torch.full((1,), 0.3, device=DEV).bfloat16(), randn(c, scale=0.1))

    k1, k3 = "fused_bias_act_bf16", "modconv_epilogue_bf16"
    main = [bf16_case(k1, str((2, 128, SIZE, SIZE)), fba((2, 128, SIZE, SIZE)), turns=True)]
    main += [bf16_case(k3, f"(2, 512, 4, 4) noise batch {nb}", epi((2, 512, 4, 4), nb), turns=True) for nb in (2, 1)]
    others = [bf16_case(k1, "(2, 3, 6, 6) 8-byte loads", fba((2, 3, 6, 6))),
              bf16_case(k1, "(3, 5, 7, 9) odd inner", fba((3, 5, 7, 9))),
              bf16_case(k1, "(2, 8, 16, 16) x 2 bytes past 16", fba((2, 8, 16, 16), misaligned=True)),
              bf16_case(k1, "(4, 32) 2-D", fba((4, 32))),
              bf16_case(k3, "(2, 6, 6, 6) noise batch 2 8-byte loads", epi((2, 6, 6, 6), 2)),
              bf16_case(k3, "(2, 3, 5, 7) noise batch 2 odd hw", epi((2, 3, 5, 7), 2)),
              bf16_case(k3, "(2, 3, 5, 7) noise batch 1 odd hw", epi((2, 3, 5, 7), 1)),
              bf16_case(k3, "(2, 512, 4, 4) noise batch 2 out 2 bytes past 16", epi((2, 512, 4, 4), 2, misaligned=True)),
              bf16_case(k3, f"(4, 128, {SIZE}, {SIZE}) noise batch 4", epi((4, 128, SIZE, SIZE), 4), turns=True)]
    return main, others


def bf16_against_rows(cases) -> dict:
    """Each case's output against the row-per-block kernel's on the same
    inputs (bitwise equality printed; the same arithmetic, so expected),
    and, at the main-path and streaming shapes, both kernels' device time
    in turns (rows, flat, flat, rows).  Returns {label: (None or (flat ms,
    rows ms), bitwise equal)}."""
    out = {}
    with torch.inference_mode():
        for c in cases:
            name, args = c["name"], c["args"]
            same = torch.equal(c["kern"](), bf16_entry(name, args, rows=True))
            times, turns = None, ""
            if c["turns"]:
                runs = {"rows": [], "flat": []}
                for turn in ("rows", "flat", "flat", "rows"):
                    if turn == "rows":
                        runs[turn].append(device_ms(lambda: bf16_entry(name, args, rows=True), BF16_ROWS[name][1]))
                    else:
                        runs[turn].append(device_ms(c["kern"], c["kernel"]))
                times = (float(np.mean(runs["flat"])), float(np.mean(runs["rows"])))
                turns = (f"; device ms flat {[round(t, 5) for t in runs['flat']]}, rows "
                         f"{[round(t, 5) for t in runs['rows']]} (in turns rows, flat, flat, rows)")
            print(f"  {name:21s} {c['label']:44s} bitwise equal to the row-per-block kernel: {same}{turns}", flush=True)
            out[c["label"]] = (times, same)
    return out


def wrapper_host_us() -> None:
    """The kernel wrappers' host microseconds per call (enqueue time, no
    synchronize inside 200 calls) at small main-path shapes."""
    gen = torch.Generator(device=DEV).manual_seed(89)
    x, b = torch.randn((2, 512, 4, 4), generator=gen, device=DEV), torch.randn(512, generator=gen, device=DEV)
    demod = torch.rand((2, 512), generator=gen, device=DEV) + 0.5
    noise, nw = torch.randn((2, 1, 4, 4), generator=gen, device=DEV), torch.ones(1, device=DEV)
    xb, epi16 = x.bfloat16(), tuple(t.bfloat16() for t in (x, demod, noise, nw))
    calls = {"fused_bias_act": lambda: fused_bias_act(x, b), "fused_bias_act_bf16": lambda: fused_bias_act(xb, b),
             "fused_bias_act_bwd": lambda: fused_bias_act_bwd(x, x, b),
             "modconv_epilogue": lambda: modconv_epilogue(x, demod, noise, nw, b),
             "modconv_epilogue_bf16": lambda: modconv_epilogue(*epi16, b)}
    with torch.inference_mode():
        us = {k: host_us(f) for k, f in calls.items()}
    print("  wrappers' host time per call at (2, 512, 4, 4), enqueue only (200 calls, no synchronize): "
          + ", ".join(f"{k} {v:.1f} us" for k, v in us.items()), flush=True)


def bf16_autograd() -> dict:
    """First grads through the bf16 instantiations against plain autograd of
    their plain versions, at their main-path shapes: dtypes, then values
    within BF16_GRAD_TOL.  Returns the largest abs error per kernel."""
    gen = torch.Generator(device=DEV).manual_seed(90)
    runs = {"fused_bias_act_bf16": [], "modconv_epilogue_bf16": []}
    x = torch.randn((2, 128, SIZE, SIZE), generator=gen, device=DEV).bfloat16()
    runs["fused_bias_act_bf16"].append((fused_bias_act, fused_bias_act_ref,
                                        (x, torch.randn(128, generator=gen, device=DEV) * 0.1)))
    for nb in (2, 1):
        a = (torch.randn((2, 512, 4, 4), generator=gen, device=DEV).bfloat16(),
             (torch.rand((2, 512), generator=gen, device=DEV) + 0.5).bfloat16(),
             torch.randn((nb, 1, 4, 4), generator=gen, device=DEV).bfloat16(),
             torch.full((1,), 0.3, device=DEV).bfloat16(), torch.randn(512, generator=gen, device=DEV) * 0.1)
        runs["modconv_epilogue_bf16"].append((modconv_epilogue, modconv_epilogue_ref, a))
    errs = {}
    for name, items in runs.items():
        errs[name] = 0.0
        for f, f_ref, args in items:
            grads = []
            for fn in (f, f_ref):
                leaves = [a.detach().requires_grad_(True) for a in args]
                y = fn(*leaves)
                w = torch.randn(y.shape, generator=torch.Generator(device=DEV).manual_seed(91), device=DEV)
                grads.append(torch.autograd.grad(y, leaves, w))
            for i, (got, want, a, t_) in enumerate(zip(*grads, args, BF16_GRAD_TOL[name])):
                require(got.dtype == want.dtype == a.dtype, f"{name} grad {i}: dtype {got.dtype}, {want.dtype}")
                abs_err, rel = rel_err(got, want)
                require(bool(torch.isfinite(got).all()) and rel <= t_, f"{name} grad {i}: rel err {rel:.3e} > {t_}")
                errs[name] = max(errs[name], abs_err)
    torch.cuda.synchronize()
    return errs


def bf16_counts() -> dict:
    return {**launch_counts(), **bf16_launch_counts()}


def bf16_train_slice():
    """(b) A seeded 256px state with bf16=True; run_iteration at TRAIN_ITERS:
    finite, both bf16 instantiations and K1-K3 launched.  Returns (state,
    tcfg, launches)."""
    tcfg = TrainConfig(batch=2, augment=False, warmup_iter=1, bf16=True)
    wgen = torch.Generator(device=DEV).manual_seed(30)
    g, d = Generator(SIZE, rng=wgen, device=DEV), Discriminator(SIZE, rng=wgen, device=DEV)
    randomize_zero_params(g, wgen)
    randomize_zero_params(d, wgen)
    state = init_train_state(GeneratorConfig(SIZE), DiscriminatorConfig(SIZE), tcfg, rng=wgen, device=DEV, g=g, d=d)
    gen = torch.Generator(device=DEV).manual_seed(31)
    torch.cuda.synchronize()
    reset_launch_counts()
    for i in TRAIN_ITERS:
        real = torch.randn((tcfg.batch, 3, SIZE, SIZE), generator=gen, device=DEV)
        m = run_iteration(state, tcfg, real, i, gen=gen)
        for k, v in m.items():
            require(bool(torch.isfinite(v).all()), f"bf16 iteration {i}: metric {k} is not finite")
        print(f"  i={i}: " + ", ".join(f"{k} {float(v):.4f}" for k, v in m.items()), flush=True)
    torch.cuda.synchronize()
    counts = bf16_counts()
    for name in ("g", "d", "g_ema", "d_ema"):
        for k, p in getattr(state, name).named_parameters():
            require(p.dtype == torch.float32 and bool(torch.isfinite(p).all()), f"bf16 run: {name}.{k}")
    check_counts(state, TRAIN_ITERS, tcfg)
    print(f"  launches in the bf16 training run: {counts}", flush=True)
    need = ("fused_bias_act", "fused_bias_act_bwd", "modconv_epilogue") + tuple(BF16_SOURCES)
    require(all(counts[k] > 0 for k in need), f"a kernel did not launch in the bf16 training run: {counts}")
    return state, tcfg, counts


def bf16_ab(state, card: str, rounds: int = 3) -> dict:
    """(d) The D and G phases in f32 and in bf16 on one state, alternated
    for `rounds` rounds of 5 calls each; the median of each side's rounds.
    Returns {(phase, bf16): ms}."""
    gen = torch.Generator(device=DEV).manual_seed(32)
    gcfg = state.g.cfg
    real = torch.randn((2, 3, SIZE, SIZE), generator=gen, device=DEV)
    cfgs = {bf16: TrainConfig(batch=2, augment=False, warmup_iter=1, bf16=bf16) for bf16 in (False, True)}

    def run(phase, tcfg):
        draws = sample_draws(gen, gcfg, tcfg, tcfg.batch)
        if phase == "D":
            steps.d_phase(state, tcfg, real, draws, False)
        else:
            steps.g_phase(state, tcfg, draws, False, do_ema=True)

    runs = {}
    for _ in range(rounds):
        for bf16, tcfg in cfgs.items():
            for phase in ("D", "G"):
                runs.setdefault((phase, bf16), []).append(cuda_ms(lambda: run(phase, tcfg), iters=5))
    ms = {k: float(np.median(v)) for k, v in runs.items()}
    print(f"  D and G in f32 / bf16, alternated, median of {rounds} rounds of 5: " + "; ".join(
        f"{ph} {ms[(ph, False)]:.2f} / {ms[(ph, True)]:.2f} ({ms[(ph, True)] / ms[(ph, False)] - 1:+.1%}; rounds "
        f"{[round(x, 2) for x in runs[(ph, False)]]} / {[round(x, 2) for x in runs[(ph, True)]]})"
        for ph in ("D", "G")) + f" ms [{card}]", flush=True)
    return ms


def bf16_eval(g_ema, ev, incp, card: str) -> dict:
    """(e) One chunk of GEN_BATCH through `Evaluator(gen_dtype=bf16)` (phase
    11's g_ema, real activations reused) against phase 11's f32 evaluator,
    fixed latents and constant noise: activations within BF16_EVAL_TOL of
    max|ref|; launches per chunk K4 6, K3 6 + K3-bf16 1 (conv1), K1 8; each
    side's chunk timed.  Returns the launches of one chunk."""
    ev16 = Evaluator(g_ema.cfg, fid_real_samples=np.zeros((1, 3, SIZE, SIZE), np.uint8), inception_nsamples=GEN_BATCH,
                     batch_size=REAL_BATCH, inception_params=incp, gen_batch=GEN_BATCH, gen_dtype=torch.bfloat16,
                     real_acts=ev._real_acts, seed=0, device=DEV)
    z = torch.randn((GEN_BATCH, g_ema.cfg.style_dim), generator=torch.Generator(device=DEV).manual_seed(33), device=DEV)
    torch.cuda.synchronize()
    reset_launch_counts()
    acts16 = ev16.activations(g_ema, z)
    torch.cuda.synchronize()
    counts = bf16_counts()
    acts32 = ev.activations(g_ema, z)
    _, rel = rel_err(acts16, acts32)
    nrel = norm_err(acts16, acts32)
    ms16, ms32 = (cuda_ms(lambda e=e: e.activations(g_ema, z), iters=3) for e in (ev16, ev))
    fid16 = ev16.compute_inception_score(g_ema)["fid"]
    print(f"  bf16 vs f32 generation, {GEN_BATCH} latents: activations {rel:.3e} of max|ref|, {nrel:.3e} in norm; "
          f"chunk {ms16:.2f} ms bf16 / {ms32:.2f} ms f32 [{card}]; FID@{GEN_BATCH} bf16 {fid16:.4f}; launches {counts}",
          flush=True)
    per_chunk = {"convt_blur_act": 6, "modconv_act": 6, "modconv_epilogue": 0, "modconv_epilogue_bf16": 1,
                 "fused_bias_act": 8, "fused_bias_act_bf16": 0}
    require(all(counts[k] == v for k, v in per_chunk.items()), f"bf16 chunk launches {counts}, not {per_chunk}")
    require(bool(torch.isfinite(acts16).all()) and rel <= BF16_EVAL_TOL and math.isfinite(fid16),
            f"bf16 generation: {rel:.3e} > {BF16_EVAL_TOL} or FID {fid16}")
    return counts


def bf16_cli_run(card: str, root: str) -> dict:
    """(f) The train CLI with --bf16 on phase 14's store: iterations 0-10,
    FID@100 at 0 and 10.  Returns its launches."""
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    r = train_cli.main(cli_flags(root) + BF16_CLI_FLAGS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = bf16_counts()
    out = Path(root) / "out" / "bf16"
    recs = [json.loads(line) for line in (out / "stats.jsonl").read_text().splitlines()]
    fids = [(rec["step"], rec["fid"]) for rec in recs if "fid" in rec]
    print(f"  CLI --bf16 run: iterations {r['iterations']}, {r['fisher_rounds']} Fisher rounds, {r['evaluations']} "
          f"evaluations of 100 samples, FID {fids}; wall {wall:.3f} s [{card}]; launches {counts}", flush=True)
    require((r["iterations"], r["evaluations"]) == (11, 2), f"the CLI --bf16 run stopped early: {r}")
    require(all(math.isfinite(f) for _, f in fids), f"a FID is not finite: {fids}")
    require("bf16 : True" in (out / "args.txt").read_text().splitlines(), "args.txt does not record --bf16")
    require(all(counts[k] > 0 for k in (*SOURCES, *BF16_SOURCES)), f"a kernel did not launch in the CLI --bf16 run: "
                                                                    f"{counts}")
    return counts


def bf16_phase(g_ema, ev, incp, root: str, card: str) -> tuple:
    """Phase 17.  Returns (per-kernel check rows, launches by run)."""
    print(f"  (a) K1-bf16 and K3-bf16 vs plain at the bf16 phases' shapes, then at shapes that reach their other "
          f"paths and K3-bf16 at (4,128,256,256), TF32 off, tolerance {BF16_KERNEL_TOL} * max|ref|; each against "
          "the row-per-block kernel it replaced; the wrappers' host time; first grads vs plain autograd", flush=True)
    main_cases, other_cases = bf16_kernel_cases(torch.Generator(device=DEV).manual_seed(88))
    per_kernel = run_cases(main_cases)
    run_cases(other_cases)
    vs_rows = bf16_against_rows(main_cases + other_cases)
    for name in BF16_SOURCES:
        k = per_kernel[name]
        times, k["bitwise_rows"] = vs_rows[k["shape"]]
        k["rows_ms"] = times[1]
    wrapper_host_us()
    grad_err = bf16_autograd()
    print(f"  grads vs plain autograd, max abs err: {grad_err}", flush=True)
    for name, err in grad_err.items():
        per_kernel[name]["max_abs_err"] = max(per_kernel[name]["max_abs_err"], err)
    print(f"  (b) training slice with bf16=True, iterations {TRAIN_ITERS}", flush=True)
    state, tcfg, train_counts = bf16_train_slice()
    print(f"  (c) the bf16 D and G phases vs plain (CPU), per tensor in norm within {BF16_TRAIN_TOL}", flush=True)
    train_vs_plain(state, tcfg, phases=("d", "g"), fims=False, step_tol=BF16_TRAIN_TOL, v_tol=BF16_TRAIN_TOL)
    print("  (d) timing: D and G in f32 and bf16 on one state", flush=True)
    bf16_ab(state, card)
    del state
    print(f"  (e) Evaluator(gen_dtype=bf16): one chunk of {GEN_BATCH} vs f32", flush=True)
    eval_counts = bf16_eval(g_ema, ev, incp, card)
    print("  (f) train CLI with --bf16: 256px batch 2, iterations 0-10, FID@100", flush=True)
    cli_counts = bf16_cli_run(card, root)
    return per_kernel, {"bf16_training": train_counts, "bf16_eval": eval_counts, "bf16_cli": cli_counts}


# ---------------------------------------------------------------------------
# phase 18: data-parallel runs over torch.distributed
# ---------------------------------------------------------------------------

DP_LABEL = "two ranks sharing one card: a correctness run, not a multi-GPU speed"
DP_ITERS = (0, 16)  # from phase 7's state: warmup with R1; every phase (the path batch of 1 whole on each rank)
DP_FISHER_N = 4  # images, 2 per rank
DP_EVAL_N = 1000
DP_EVAL_TOL = 1e-3  # sharded mu, cov (max|d| / max|ref|) and FID (relative) against one process
DP_DRAWS = (120, 14, 15, 12)  # samples, gen_batch: chunks of 15 per rank of 2, of 12 in one process


def state_digest(*trees) -> str:
    """sha256 of every tensor of the TrainStates and {name: tensor} dicts
    given, in order (bitwise equality across ranks)."""
    h = hashlib.sha256()
    for tree in trees:
        tensors = tree if isinstance(tree, dict) else {
            **{f"{m}.{k}": v for m in ("g", "d", "g_ema", "d_ema") for k, v in getattr(tree, m).state_dict().items()},
            **{f"{o}.{i}.{k}": v for o in ("g_opt", "d_opt") for i, st in enumerate(getattr(tree, o).state.values())
               for k, v in st.items()},
            **{k: getattr(tree, k) for k in ("mean_path_length", "ada_p", "ada_stats", "r_t")}}
        for k in sorted(tensors):
            h.update(k.encode())
            h.update(tensors[k].detach().cpu().contiguous().view(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def dp_cli_rank(out_json: str, flags: list) -> None:
    """Phase 18 (a), as the rank torchrun starts: the train CLI with
    `flags` and cuDNN's deterministic algorithms, its metrics per iteration
    and its launches written by rank 0 to `out_json`."""
    torch.backends.cudnn.deterministic = True
    torch.cuda.synchronize()
    reset_launch_counts()
    with recorded_metrics() as metrics:
        summary = train_cli.main(flags)
    torch.cuda.synchronize()
    if int(os.environ.get("RANK", "0")) == 0:
        with open(out_json, "w") as f:
            json.dump({"metrics": [{k: float(v) for k, v in m.items()} for m in metrics], "counts": bf16_counts(),
                       "summary": summary}, f)


def metric_errors(got: list, want: list) -> dict:
    """{metric: [relative error at each iteration]} of two runs' metrics."""
    return {k: [abs(a[k] - b[k]) / max(abs(b[k]), 1e-6) for a, b in zip(got, want)] for k in want[0]}


def dp_cli(root: str, first: dict, card: str) -> dict:
    """(a) Phase 14's first run (store and flags) under `torchrun
    --nproc_per_node 1` (NCCL, world 1), held to the same run in this
    process without a process group, both with cuDNN's deterministic
    algorithms: phase 14's own run is not repeatable on the card (cuDNN's
    default algorithms round otherwise from run to run, and the GAN and
    the Fisher cutlines amplify that to percents within 20 iterations; its
    distance to both is printed).  Its metrics per iteration at phase 8's
    loss tolerance, and its checkpoint of CLI_CKPT_STEP per tensor in norm
    by phase 8's rule for a step (from the seeded state both start from).
    Returns the torchrun run's launches."""
    flags = cli_flags(root) + CLI_FLAGS + ["--iter", str(CLI_ITERS), "--exp"]  # the last --exp is the run's
    torch.cuda.synchronize()
    torch.backends.cudnn.deterministic = True
    t0 = time.perf_counter()
    with recorded_metrics() as metrics:
        train_cli.main(flags + ["dp_ref"])
    torch.cuda.synchronize()
    ref_s = time.perf_counter() - t0
    torch.backends.cudnn.deterministic = False
    ref = [{k: float(v) for k, v in m.items()} for m in metrics]
    out_json = os.path.join(root, "dp_cli.json")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "1",
           os.path.abspath(__file__), "--dp-cli", out_json, *flags, "dp_cli"]
    t0 = time.perf_counter()
    subprocess.run(cmd, check=True, timeout=900)
    wall = time.perf_counter() - t0
    got = json.loads(Path(out_json).read_text())["metrics"]
    require(len(got) == len(ref) == len(first["metrics"]), "the runs ran other iterations")
    errs = metric_errors(got, ref)
    worst_m = max(max(v) for v in errs.values())
    diff_m = max(abs(a[k] - b[k]) for a, b in zip(got, ref) for k in b)
    require(worst_m <= LOSS_TOL, f"torchrun run vs one process: metrics part by {worst_m:.3e} > {LOSS_TOL}: {errs}")
    spread = metric_errors(ref, first["metrics"])
    gcfg, dcfg = GeneratorConfig(SIZE), DiscriminatorConfig(SIZE)
    tcfg = TrainConfig(batch=2, augment=False, warmup_iter=4)
    ckpt = f"{CLI_CKPT_STEP:06d}.state.npz"
    states = [train_state_from_jax(gcfg, dcfg, load_state(os.path.join(root, "out", run, "checkpoints", ckpt))[0],
                                   tcfg=tcfg, device=DEV) for run in ("dp_cli", "dp_ref")]
    wgen = torch.Generator(device=DEV).manual_seed(1)  # the CLI's init: --seed 1, no source checkpoint
    start = init_train_state(gcfg, dcfg, tcfg, rng=wgen, device=DEV, g=Generator(SIZE, rng=wgen, device=DEV),
                             d=Discriminator(SIZE, rng=wgen, device=DEV))
    wd = held_to("torchrun run", start, states[0], states[1], tcfg, ("d",), ("d", d_trainable))
    wg = held_to("torchrun run", start, states[0], states[1], tcfg, ("g", "g_ema", "d_ema"), ("g", g_trainable))
    diff_s = max(float((a - b).abs().max()) for m in ("g", "d", "g_ema", "d_ema")
                 for a, b in zip(*(getattr(st, m).state_dict().values() for st in states)))
    counts = json.loads(Path(out_json).read_text())["counts"]
    print(f"  (a) torchrun --nproc_per_node 1 (NCCL, world 1) vs one process, phase 14's first run, cuDNN "
          f"deterministic: {len(got)} iterations, metrics within {worst_m:.2e} relative (largest difference "
          f"{diff_m:.3e}); {ckpt}: largest difference {diff_s:.3e}, worst step error / allowed "
          f"{max(wd['step'], wg['step'])[0]:.2e}, exp_avg_sq {max(wd['v'], wg['v'])[0]:.2e}"
          + ("; bitwise equal" if diff_m == 0.0 and diff_s == 0.0 else "") + f"; {wall:.1f} s with the launch "
          f"({DP_LABEL}), the run in this process {ref_s:.1f} s [{card}]; launches {counts}", flush=True)
    print("  (a) phase 14's first run (cuDNN's default algorithms) against the deterministic one, relative, by "
          "iteration: " + "; ".join(f"{k} {' '.join(f'{e:.0e}' for e in v)}" for k, v in spread.items()
                                    if k in ("d", "g", "r1", "path")), flush=True)
    require(all(counts[k] > 0 for k in SOURCES), f"a kernel did not launch in the torchrun run: {counts}")
    return counts


def dp_rank(rank: int, world: int, port: int, files: dict, q) -> None:
    """Phase 18 (b): one of two ranks on the one card over gloo (asked for
    explicitly: NCCL refuses two ranks on one device)."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        group, dev = initialize_multihost(DEV, backend="gloo")
        q.put((rank, dp_work(rank, group, dev, files)))
        torch.distributed.destroy_process_group()
    except BaseException:  # noqa: BLE001 - the parent raises with it
        q.put((rank, traceback.format_exc()))


def dp_work(rank: int, group, dev, files: dict) -> dict:
    """The phases, the Fisher accumulation and the evaluation on 2 ranks;
    on rank 0 each also by one process on the card, and held to it."""
    gcfg, dcfg = GeneratorConfig(SIZE), DiscriminatorConfig(SIZE)
    tcfg = TrainConfig(batch=2, augment=False, warmup_iter=1)
    base = train_state_from_jax(gcfg, dcfg, load_state(files["state"])[0], tcfg=tcfg, device=dev)
    inputs = torch.load(files["inputs"], weights_only=False)
    real = inputs["real"].to(dev)
    out = {"metrics": [], "checks": []}
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    states = []
    for i, draws in inputs["cases"]:
        state = copy.deepcopy(base)
        m = run_iteration(state, tcfg, local_rows(real, group), i, draws={k: d.to(dev) for k, d in draws.items()},
                          group=group)
        out["metrics"].append({k: float(v) for k, v in m.items()})
        states.append(state)
    noises, reals = inputs["fisher"][0].to(dev), inputs["fisher"][1].to(dev)
    fims = accumulate_fims(base.g_ema, base.d_ema, noises, reals, batch=tcfg.batch, const_noise=True, group=group)
    torch.cuda.synchronize()
    out["phases_s"], out["phases_counts"] = time.perf_counter() - t0, bf16_counts()
    out["digest"] = state_digest(*states, fims[0], fims[1])
    if rank == 0:
        for (i, draws), state, m in zip(inputs["cases"], states, out["metrics"]):
            ref = copy.deepcopy(base)
            want = run_iteration(ref, tcfg, real, i, draws={k: d.to(dev) for k, d in draws.items()})
            loss = max(abs(m[k] - float(v)) / max(abs(float(v)), 1e-6) for k, v in want.items())
            require(loss <= LOSS_TOL, f"2 ranks, iteration {i}: metrics {m} vs {want}")
            wd = held_to(f"2 ranks, iteration {i}", base, state, ref, tcfg, ("d",), ("d", d_trainable))
            wg = held_to(f"2 ranks, iteration {i}", base, state, ref, tcfg, ("g", "g_ema", "d_ema"), ("g", g_trainable))
            out["checks"].append((i, loss, max(wd["step"], wg["step"]), max(wd["v"], wg["v"])))
            del ref
        want = accumulate_fims(base.g_ema, base.d_ema, noises, reals, batch=tcfg.batch, const_noise=True)
        worst = (0.0, "")
        for model, a, b in zip(("g_ema", "d_ema"), fims, want):
            a, b = by_tensor(a), by_tensor(b)
            for k in b:
                e = norm_err(a[k], b[k])
                worst = max(worst, (e / tol(k, FIM_TOL), f"{model}.{k}"))
                require(e <= tol(k, FIM_TOL), f"2 ranks: the sharded FIM of {model}.{k} differs by {e:.3e}")
        out["fims"] = worst
    del states, base, fims

    g_ema = Generator(SIZE, rng=torch.Generator(device=dev).manual_seed(0), device=dev).eval()
    g_ema.load_state_dict(torch.load(files["g_ema"]))
    kw = dict(fid_real_samples=np.zeros((1, 3, SIZE, SIZE), np.uint8), inception_nsamples=DP_EVAL_N,
              batch_size=REAL_BATCH, gen_batch=GEN_BATCH, real_acts=np.load(files["real_acts"]), seed=0, device=dev,
              inception_params=torch.load(files["incp"], weights_only=False))
    ev = Evaluator(g_ema.cfg, group=group, **kw)
    require(ev.group is not None and ev.n_chunks * ev.gen_batch * 2 == DP_EVAL_N,
            "the sharded evaluation was not taken")
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    out["fid"] = ev.compute_inception_score(g_ema)["fid"]
    torch.cuda.synchronize()
    out["eval_s"], out["eval_counts"] = time.perf_counter() - t0, bf16_counts()
    if rank == 0:
        one = Evaluator(g_ema.cfg, **kw)
        fid = one.compute_inception_score(g_ema)["fid"]
        errs = [rel_err(a, b)[1] for a, b in zip(ev.last_stats, one.last_stats)] + [abs(out["fid"] - fid) / abs(fid)]
        require(max(errs) <= DP_EVAL_TOL, f"2 ranks: the sharded evaluation's mu, cov, FID differ by {errs}")
        out["eval_errs"], out["fid_one"] = errs, fid

    # a chunk size that is not one process's: the draws alone, each rank's rows against one process's
    n, gen_batch, per_rank, whole = DP_DRAWS
    kw.update(inception_nsamples=n, gen_batch=gen_batch)
    evs = Evaluator(g_ema.cfg, group=group, **kw), Evaluator(g_ema.cfg, **kw)
    require((evs[0].gen_batch, evs[1].gen_batch) == (per_rank, whole), "the chunk sizes are not the ones planned")
    draws = []
    for e in evs:
        zs, noises = zip(*e._chunk_draws(g_ema, 0))
        draws.append([torch.cat(zs), *(torch.cat(ns) for ns in zip(*noises))])
    rows = slice(rank * n // 2, (rank + 1) * n // 2)
    require(len(draws[0]) == len(draws[1]) and all(torch.equal(a, b[rows]) for a, b in zip(*draws)),
            f"rank {rank}: the draws at chunks of {per_rank} are not one process's at chunks of {whole}")
    return out


def dp_ranks(files: dict, card: str) -> dict:
    """(b) Two ranks on the card over gloo, started here; returns the
    launches of their runs (both ranks): the phases and the Fisher
    accumulation, and the evaluation."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    ctx = torch.multiprocessing.get_context("spawn")
    q = ctx.Queue()
    torch.cuda.empty_cache()  # the ranks share the card with this process
    t0 = time.perf_counter()
    procs = [ctx.Process(target=dp_rank, args=(r, 2, port, files, q)) for r in range(2)]
    for p in procs:
        p.start()
    outs = {}
    while len(outs) < len(procs) and time.perf_counter() - t0 < 900:
        with contextlib.suppress(queue.Empty):
            r, o = q.get(timeout=1.0)
            outs[r] = o
        if len(outs) < len(procs) and any(p.exitcode not in (None, 0) for p in procs):
            break
    for p in procs:
        p.join(60)
        if p.is_alive():
            p.kill()
            p.join(10)
    wall = time.perf_counter() - t0
    require(len(outs) == len(procs), f"a rank ended without a result: exit codes {[p.exitcode for p in procs]}")
    for r, o in outs.items():
        require(isinstance(o, dict), f"rank {r} failed:\n{o}")
    a, b = outs[0], outs[1]
    require(a["digest"] == b["digest"], "the two ranks' states or FIMs differ")
    require(a["metrics"] == b["metrics"] and a["fid"] == b["fid"], "the two ranks returned other metrics or FIDs")
    for i, loss, step, v in a["checks"]:
        print(f"  (b) iteration {i}, global batch 2 (one image per rank) vs one process on the card: metrics within "
              f"{loss:.2e} relative; worst error / allowed: step {step[0]:.2e} ({step[1]}), exp_avg_sq {v[0]:.2e} "
              f"({v[1]}); the ranks' states bitwise equal", flush=True)
    print(f"  (b) sharded Fisher accumulation, {DP_FISHER_N} images, 2 per rank, vs one process: worst error / allowed "
          f"{a['fims'][0]:.2e} ({a['fims'][1]})", flush=True)
    print(f"  (b) sharded evaluation, {DP_EVAL_N} samples, {GEN_BATCH} per chunk: FID {a['fid']:.6f} vs one process "
          f"{a['fid_one']:.6f}; mu, cov, FID errors {['%.2e' % e for e in a['eval_errs']]} (tolerance {DP_EVAL_TOL})",
          flush=True)
    print(f"  (b) the draws of {DP_DRAWS[0]} samples at gen_batch {DP_DRAWS[1]}, chunks of {DP_DRAWS[2]} per rank "
          f"against {DP_DRAWS[3]} in one process: latents and noise of each rank's rows bitwise equal", flush=True)
    phases = {k: a["phases_counts"][k] + b["phases_counts"][k] for k in a["phases_counts"]}
    evals = {k: a["eval_counts"][k] + b["eval_counts"][k] for k in a["eval_counts"]}
    print(f"  (b) {wall:.1f} s in all, phases and Fisher {a['phases_s']:.2f} s, evaluation {a['eval_s']:.2f} s on "
          f"rank 0 ({DP_LABEL}) [{card}]; launches, both ranks: phases and Fisher {phases}, evaluation {evals}",
          flush=True)
    per_chunk = {"convt_blur_act": 6, "modconv_act": 7, "modconv_epilogue": 0, "fused_bias_act": 8}
    for name, k in per_chunk.items():
        require(evals[name] == k * DP_EVAL_N // GEN_BATCH, f"{name} launched {evals[name]} times in the evaluation")
    training = ("fused_bias_act", "fused_bias_act_bwd", "modconv_epilogue")
    require(all(phases[k] > 0 for k in training), f"a training kernel did not launch on the ranks: {phases}")
    return {"dp_phases": phases, "dp_eval": evals}


def dp_inputs(path: str) -> None:
    """The global real batch and draws of DP_ITERS, and the Fisher set, made
    on the CPU and saved for the ranks."""
    gen = torch.Generator().manual_seed(41)
    tcfg = TrainConfig(batch=2, augment=False, warmup_iter=1)
    gcfg = GeneratorConfig(SIZE)
    cases = [(i, {"d": sample_draws(gen, gcfg, tcfg, 2), "g": sample_draws(gen, gcfg, tcfg, 2),
                  "path": sample_draws(gen, gcfg, tcfg, 1, path=True)}) for i in DP_ITERS]
    torch.save({"real": torch.randn((2, 3, SIZE, SIZE), generator=gen), "cases": cases,
                "fisher": (torch.randn((DP_FISHER_N, tcfg.latent), generator=gen),
                           torch.randn((DP_FISHER_N, 3, SIZE, SIZE), generator=gen))}, path)

# ---------------------------------------------------------------------------
# phase 19: JPEG inputs and the AFHQ-Cat recipe through the CLI
# ---------------------------------------------------------------------------

# committed JPEGs (tests/torch_fixtures/make_jpeg_fixtures.py) and the sha256 of
# what PIL and rick_tpu made of them
JPEG_FIXTURES = Path(__file__).resolve().parent / "tests" / "torch_fixtures" / "jpeg"
CAT_PX = 512 * 512 / 1e6  # megapixels of one of the ten "cat" fixtures
# the AFHQ-Cat recipe (the reference README's second, `README.md:107-114`):
# phase 14's flags with the recipe's quantiles, iterations 0-10 and FID@100
# as phase 15 (e)
CAT_FISHER_Q, CAT_PRUNE_Q = 85, 0.075
CAT_CLI_FLAGS = [
    "--size", "256", "--batch", "2", "--n_sample_train", "10", "--num_fisher_img", "5", "--fisher_quantile",
    str(CAT_FISHER_Q), "--prune_quantile", str(CAT_PRUNE_Q), "--allow_random_fisher_noise", "--eval_in_training",
    "--store_samples", "--warmup_iter", "4", "--fisher_freq", "8", "--eval_in_training_freq", "10",
    "--samples_freq", "10", "--n_sample_test", "100", "--iter", "0", "--data_path", "cat", "--exp", "cat",
]


def store_sha256(path: str) -> str:
    """sha256 over the decoded pixels of every record of a store, in key order
    (the manifest's `cat_store`)."""
    store = RecordStore(path)
    h = hashlib.sha256()
    for i in range(len(store)):
        h.update(decode_png(store.get(i)).tobytes())
    store.close()
    return h.hexdigest()


def jpeg_fixtures(card: str) -> dict:
    """(a) Every fixture decoded, its pixels' sha256 against PIL's in the
    manifest; the decode time of the 512x512 files (the median of 5 rounds
    over the ten, per image) on the host running the script."""
    manifest = json.loads((JPEG_FIXTURES / "manifest.json").read_text())
    t0 = time.perf_counter()
    decode_jpeg((JPEG_FIXTURES / "modes" / "odd_1x1.jpg").read_bytes())  # builds csrc/jpeg_decode.cpp with g++
    build_s = time.perf_counter() - t0
    decoded = {}
    for rel, entry in manifest["files"].items():
        img = decode_jpeg((JPEG_FIXTURES / rel).read_bytes(), name=rel)
        digest = hashlib.sha256(img.tobytes()).hexdigest()
        require(list(img.shape) == entry["shape"] and digest == entry["sha256_pixels"],
                f"{rel}: decoded {img.shape} {digest[:16]}, PIL's {entry['shape']} {entry['sha256_pixels'][:16]}")
        decoded[rel] = img
    cats = [(JPEG_FIXTURES / rel).read_bytes() for rel in sorted(manifest["files"]) if rel.startswith("cat/")]
    rounds = []
    for _ in range(5):
        t0 = time.perf_counter()
        for blob in cats:
            decode_jpeg(blob)
        rounds.append((time.perf_counter() - t0) / len(cats))
    per_image = float(np.median(rounds))
    print(f"  {len(decoded)} fixtures decoded, every sha256 equal to PIL's; g++ build and first call {build_s:.2f} s; "
          f"512x512 4:2:0 q90: {per_image * 1e3:.3f} ms per image (median of 5 rounds of {len(cats)}; rounds "
          f"{min(rounds) * 1e3:.3f}-{max(rounds) * 1e3:.3f}), {CAT_PX / per_image:.1f} MP/s on the host [{card}]",
          flush=True)
    return dict(manifest=manifest, decoded=decoded, ms_per_image=per_image * 1e3, mp_per_s=CAT_PX / per_image)


@contextlib.contextmanager
def recorded_masks():
    """The FIMs and masks of every Fisher round inside the block, in order."""
    out, inner = [], fisher_module.masks_from_fims

    def recording(fim_g, fim_d, **kwargs):
        out.append((fim_g, fim_d, kwargs, inner(fim_g, fim_d, **kwargs)))
        return out[-1][-1]

    fisher_module.masks_from_fims = recording
    yield out
    fisher_module.masks_from_fims = inner


def check_cat_masks(rounds) -> str:
    """Each round's G masks against the recipe's percentiles recomputed in
    numpy from the round's FIMs: pruned the filters at or below the
    CAT_PRUNE_Q-th percentile of their group's scores, frozen those above
    the CAT_FISHER_Q-th (distinct scores; rick_tpu's groups: G conv filters,
    G FC input channels); D's shares printed."""
    lines = []
    for fim_g, fim_d, kwargs, (g_freeze, g_prune, d_freeze, d_prune) in rounds:
        require(kwargs == dict(fisher_quantile=CAT_FISHER_Q, prune_quantile=CAT_PRUNE_Q), f"quantiles {kwargs}")
        n = sum(1 for k in fim_g if k.startswith("convs.") and k.endswith(".conv.weight"))
        groups = {
            "G conv": ([fim_g[f"convs.{i}.conv.weight"][0].mean(dim=(1, 2, 3)) for i in range(n)],
                       [f"convs.{i}.conv.weight" for i in range(n)]),
            "G FC": ([(fim_g[f"convs.{i}.conv.modulation.weight"].mean(dim=1)
                       + fim_g[f"convs.{i}.conv.modulation.bias"]) / 2.0 for i in range(n)],
                     [f"convs.{i}.conv.modulation.bias" for i in range(n)]),
        }
        for label, (scores, keys) in groups.items():
            s = torch.cat(scores).double().cpu().numpy()
            pruned = sum(int(g_prune[k].sum()) for k in keys)
            frozen = sum(int(g_freeze[k].sum()) for k in keys)
            want_p = int((s <= np.quantile(s, CAT_PRUNE_Q / 100)).sum())
            want_f = int((s > np.quantile(s, CAT_FISHER_Q / 100)).sum())
            require((pruned, frozen) == (want_p, want_f),
                    f"{label}: pruned {pruned}, frozen {frozen} of {len(s)}; the percentiles give {want_p}, {want_f}")
            lines.append(f"{label} pruned {pruned} of {len(s)} ({pruned / len(s):.4%}), frozen {frozen} "
                         f"({frozen / len(s):.2%})")
        d_keys = [k for k in d_prune if k.endswith("weight")]  # a bias shares its conv's mask
        d_n = sum(int(d_prune[k].numel()) for k in d_keys)
        lines.append(f"D pruned {sum(int(d_prune[k].sum()) for k in d_keys)} and frozen "
                     f"{sum(int(d_freeze[k].sum()) for k in d_keys)} of {d_n} filters")
    return "; ".join(lines)


def cat_phase(card: str, root: str) -> dict:
    """Phase 19 on phase 14's store (its 1000 PNGs are the cat run's test
    set); returns the cat CLI run's launches."""
    t_phase = time.perf_counter()
    print("  (a) the committed JPEG fixtures against PIL's pixels", flush=True)
    fx = jpeg_fixtures(card)

    print("  (b) prepare_data on the ten 512x512 JPEGs: --size 256, LANCZOS, in process", flush=True)
    cat_root = os.path.join(root, "cat_root")
    train_store = os.path.join(cat_root, "_processed_train", "cat")
    t0 = time.perf_counter()
    prepare_data_cli.main(["--input_path", str(JPEG_FIXTURES / "cat"), "--output_path", train_store, "--size", "256",
                           "--n_worker", "1"])
    prep_s = time.perf_counter() - t0
    digest = store_sha256(train_store)
    want = fx["manifest"]["cat_store"]
    require(digest == want["sha256_pixels"], f"the store's pixels {digest[:16]} != rick_tpu's {want['sha256_pixels'][:16]}")
    print(f"  store of {want['n']} at 256px in {prep_s:.3f} s, its pixels' sha256 equal to rick_tpu.prepare_dataset's "
          f"[{card}]", flush=True)

    print(f"  (c) train CLI, the AFHQ-Cat recipe's quantiles ({CAT_FISHER_Q}, {CAT_PRUNE_Q}): 256px batch 2, "
          "iterations 0-10, FID@100 on phase 14's test set", flush=True)
    os.makedirs(os.path.join(cat_root, "_processed_test"))
    os.symlink(os.path.join(root, "_processed_test", "babies"), os.path.join(cat_root, "_processed_test", "cat"))
    flags = ["--data_root", cat_root, "--output_root", os.path.join(cat_root, "out"), "--sample_noise",
             os.path.join(root, "noise.pt"), "--fisher_noise_dir", os.path.join(root, "_noise")] + CAT_CLI_FLAGS
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    with recorded_masks() as rounds:
        r = train_cli.main(flags)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    recs = [json.loads(line) for line in (Path(cat_root) / "out" / "cat" / "stats.jsonl").read_text().splitlines()]
    losses = [rec for rec in recs if "d" in rec]
    fids = [(rec["step"], rec["fid"]) for rec in recs if "fid" in rec]
    require((r["iterations"], r["evaluations"], r["fisher_rounds"]) == (11, 2, 1) and len(rounds) == 1,
            f"the cat CLI run stopped early: {r}, {len(rounds)} mask rounds")
    require(losses and all(math.isfinite(v) for rec in losses for v in rec.values()), f"a loss is not finite: {losses}")
    require(all(math.isfinite(f) for _, f in fids) and len(fids) == 2, f"FID {fids}")
    require(all(counts[k] > 0 for k in SOURCES), f"a kernel did not launch in the cat CLI run: {counts}")
    masks = check_cat_masks(rounds)
    print(f"  cat CLI run: iterations {r['iterations']}, {r['fisher_rounds']} Fisher round, {r['evaluations']} "
          f"evaluations of 100 samples, FID {fids}; wall {wall:.3f} s [{card}]; launches {counts}", flush=True)
    print(f"  masks of the Fisher round at the recipe's percentiles: {masks}", flush=True)

    print("  (d) cli.fid's folder loader on the ten JPEGs", flush=True)
    imgs = fid_cli._load_images(str(JPEG_FIXTURES / "cat"), SIZE)
    rng = np.random.default_rng(0)
    want_imgs = np.stack([train_transform(fx["decoded"][rel], SIZE, rng, flip=False)
                          for rel in sorted(fx["decoded"]) if rel.startswith("cat/")])
    require(imgs.shape == (10, 3, SIZE, SIZE) and np.array_equal(imgs, want_imgs),
            f"cli.fid's folder loader: {imgs.shape}, not the decoded fixtures through train_transform")
    print(f"  {imgs.shape} equal to the decoded fixtures through train_transform; phase 19: "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return dict(counts=counts, wall_s=wall, ms_per_image=fx["ms_per_image"], mp_per_s=fx["mp_per_s"])


# ---------------------------------------------------------------------------
# phase 20: ADA's three warp lowerings, legacy/, BMP/TIFF/WebP inputs
# ---------------------------------------------------------------------------

LOWERINGS = ("gather", "matmul", "matmul_fir")
# each lowering, card vs CPU, images and the image gradient, of max|ref|
# (TF32 off): the same taps, the products and cuDNN's FIR summed in another
# order, the scatter-adds' atomics in any order
WARP_TOL = 1e-5
# matmul vs gather on the card outside the tail: the same taps and weights,
# rows then columns against columns then rows
WARP_PAIR_TOL = 1e-6
N_TAIL = 2  # the last transforms of `warp_transforms`, beyond the footprint
FIR_CLI_FLAGS = ADA_CLI_FLAGS[:-1] + ["ada_fir"]  # phase 15 (e)'s run under its own --exp
LEGACY_TOL = 1e-5  # legacy/ on the card vs the CPU, of max|ref|: sums of 4608 or 131072 terms in another order
FORMAT_FIXTURES = Path(__file__).resolve().parent / "tests" / "torch_fixtures" / "formats"


@contextlib.contextmanager
def warp_lowering(mode: str):
    """RICK_ADA_WARP = mode inside the block (the port reads it on every call)."""
    old = os.environ.get("RICK_ADA_WARP")
    os.environ["RICK_ADA_WARP"] = mode
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("RICK_ADA_WARP")
        else:
            os.environ["RICK_ADA_WARP"] = old


def warp_transforms() -> torch.Tensor:
    """(8, 3, 3) on the CPU, the cases of `tests/test_torch_warp.py` at
    256px: four p = 1 draws, a rotation by 0.3 with a shift, a flip, and the
    0.28x zoom-outs (one rotated by 0.7) beyond the footprint."""
    G = sample_affine(torch.Generator().manual_seed(50), torch.ones(()), 4, SIZE, SIZE)
    rot = torch.eye(3)
    c, s = math.cos(0.3), math.sin(0.3)
    rot[:2, :2] = torch.tensor([[c, -s], [s, c]])
    rot[0, 2] = 0.1
    flip = torch.diag(torch.tensor([-1.0, 1.0, 1.0]))
    tail = torch.diag(torch.tensor([0.28, 0.28, 1.0])).repeat(N_TAIL, 1, 1)
    c, s = math.cos(0.7), math.sin(0.7)
    tail[1, :2, :2] = 0.28 * torch.tensor([[c, -s], [s, c]])
    return torch.cat([G, rot[None], flip[None], tail])


def warp_lowerings_vs_cpu() -> float:
    """(a) Each lowering at 256px, margin 224, batch 2: apply_affine and the
    gradient of sum(out * w) in the image on the card against the CPU's
    result of the same lowering; matmul against gather on the card outside
    the tail; in the tail the matrix lowerings part from gather by O(1), as
    on the CPU.  Returns the worst card-vs-CPU error of max|ref|."""
    G = warp_transforms()
    gen = torch.Generator().manual_seed(51)
    img, w = torch.randn((len(G), 3, SIZE, SIZE), generator=gen), torch.randn((len(G), 3, SIZE, SIZE), generator=gen)
    outs, worst = {}, 0.0
    for mode in LOWERINGS:
        with warp_lowering(mode):
            for dev in ("cpu", DEV):
                parts = []
                for k in range(0, len(G), 2):
                    x = img[k : k + 2].to(dev).requires_grad_(True)
                    out = apply_affine(x, G[k : k + 2].to(dev), margin=ADA_MARGIN)
                    (grad,) = torch.autograd.grad((out * w[k : k + 2].to(dev)).sum(), x)
                    parts.append((out.detach().cpu(), grad.cpu()))
                outs[(mode, dev)] = tuple(torch.cat(t) for t in zip(*parts))
        for what, got, ref in zip(("images", "gradient"), outs[(mode, DEV)], outs[(mode, "cpu")]):
            _, rel = rel_err(got, ref)
            worst = max(worst, rel)
            print(f"  {mode}, {what}: card vs CPU {rel:.3e} of max|ref|", flush=True)
            require(bool(torch.isfinite(got).all()) and rel <= WARP_TOL, f"{mode} {what}: card vs CPU {rel:.3e}")
    for i, what in enumerate(("images", "gradient")):
        _, rel = rel_err(outs[("matmul", DEV)][i][:-N_TAIL], outs[("gather", DEV)][i][:-N_TAIL])
        print(f"  matmul vs gather on the card, {what}: {rel:.3e} of max|ref|", flush=True)
        require(rel <= WARP_PAIR_TOL, f"matmul vs gather on the card, {what}: {rel:.3e}")
    for mode in ("matmul", "matmul_fir"):
        _, rel = rel_err(outs[(mode, DEV)][0][-N_TAIL:], outs[("gather", DEV)][0][-N_TAIL:])
        print(f"  0.28x tail, {mode} vs gather on the card: {rel:.3e} of max|ref|", flush=True)
        require(rel > 0.1, f"the 0.28x tail: {mode} does not part from gather ({rel:.3e})")
    return worst


def lowering_costs(card: str) -> dict:
    """(b) Per lowering: the augment (affine and colour) forward at batch B,
    forward and backward at batch 2 (phase 15 (d)'s calls), CUDA events; the
    peak device memory of one forward and backward above what was allocated
    before it."""
    gen = torch.Generator(device=DEV).manual_seed(22)
    p = torch.full((), 0.5, device=DEV)
    x4 = torch.randn((B, 3, SIZE, SIZE), generator=gen, device=DEV)
    t4 = (sample_affine(gen, p, B, SIZE, SIZE), sample_color(gen, p, B))
    x2 = torch.randn((2, 3, SIZE, SIZE), generator=gen, device=DEV).requires_grad_(True)
    t2 = (sample_affine(gen, p, 2, SIZE, SIZE), sample_color(gen, p, 2))

    def fwd():
        with torch.no_grad():
            augment(x4, p, margin=ADA_MARGIN, transform=t4)

    def fwd_bwd():
        torch.autograd.grad(augment(x2, p, margin=ADA_MARGIN, transform=t2)[0].sum(), x2)

    costs = {}
    for mode in LOWERINGS:
        with warp_lowering(mode):
            c = {"fwd_b4_ms": cuda_ms(fwd, iters=10), "fwd_bwd_b2_ms": cuda_ms(fwd_bwd, iters=10)}
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            fwd_bwd()
            torch.cuda.synchronize()
            c["peak_fwd_bwd_b2_gib"] = (torch.cuda.max_memory_allocated() - base) / 2**30
        costs[mode] = c
        print(f"  {mode}: augment forward, batch {B}: {c['fwd_b4_ms']:.3f} ms; forward and backward, batch 2: "
              f"{c['fwd_bwd_b2_ms']:.3f} ms, peak {c['peak_fwd_bwd_b2_gib']:.3f} GiB above the inputs [{card}]",
              flush=True)
    return costs


def lowering_ab(card: str, rounds: int = 3) -> dict:
    """(b) The D and G phases at p = 0.5 under each lowering, alternated on
    one state for `rounds` rounds of 5 calls each, as phase 15 (d): each
    side is the median of its rounds.  Returns {(phase, lowering): ms}."""
    tcfg = TrainConfig(batch=2, augment=True, augment_p=0.5, warmup_iter=1, ada_margin=ADA_MARGIN)
    state = ada_state(tcfg)
    state.ada_p = torch.full((), 0.5, device=DEV)
    gen = torch.Generator(device=DEV).manual_seed(23)
    real = torch.randn((2, 3, SIZE, SIZE), generator=gen, device=DEV)

    def run(phase):
        n = 2 * tcfg.batch if phase == "D" else tcfg.batch
        draws = sample_draws(gen, state.g.cfg, tcfg, tcfg.batch, ada_p=state.ada_p, ada_batch=n)
        if phase == "D":
            steps.d_phase(state, tcfg, real, draws, False)
        else:
            steps.g_phase(state, tcfg, draws, False, do_ema=True)

    runs = {}
    for _ in range(rounds):
        for mode in LOWERINGS:
            with warp_lowering(mode):
                for phase in ("D", "G"):
                    runs.setdefault((phase, mode), []).append(cuda_ms(lambda: run(phase), iters=5))
    ms = {k: float(np.median(v)) for k, v in runs.items()}
    for phase in ("D", "G"):
        print(f"  {phase} phase at p = 0.5, median of {rounds} rounds of 5, alternated: " + "; ".join(
            f"{mode} {ms[(phase, mode)]:.2f} ms (rounds {[round(x, 2) for x in runs[(phase, mode)]]})"
            for mode in LOWERINGS) + f" [{card}]", flush=True)
    return ms


def legacy_on_card(state_path: str, card: str) -> float:
    """(d) legacy/ on the card: spectral norm of a D-sized weight
    (512x512x3x3, 1 and 5 power iterations), the conditional batch and
    instance norms of 256px activations, against the CPU; the samplers on a
    CUDA generator; a CheckpointIO round trip of phase 7's state, bitwise.
    Returns the worst card-vs-CPU error of max|ref|."""
    gen = torch.Generator().manual_seed(53)
    w, u = torch.randn((512, 512, 3, 3), generator=gen), torch.randn((512,), generator=gen)
    worst = 0.0
    for n_iter in (1, 5):
        got, want = spectral_norm_apply(w.to(DEV), u.to(DEV), n_iter=n_iter), spectral_norm_apply(w, u, n_iter=n_iter)
        for what, a, b in zip(("w / sigma", "u"), got, want):
            _, rel = rel_err(a.cpu(), b)
            worst = max(worst, rel)
            require(rel <= LEGACY_TOL, f"spectral_norm_apply n_iter {n_iter}, {what}: card vs CPU {rel:.3e}")
    x = torch.randn((2, 64, SIZE, SIZE), generator=gen) * 3.0 + 1.0
    gamma, beta = torch.randn((2, 64), generator=gen), torch.randn((2, 64), generator=gen)
    for fn in (cbatch_norm_apply, cinstance_norm_apply):
        _, rel = rel_err(fn(x.to(DEV), gamma.to(DEV), beta.to(DEV)).cpu(), fn(x, gamma, beta))
        worst = max(worst, rel)
        require(rel <= LEGACY_TOL, f"{fn.__name__}: card vs CPU {rel:.3e}")
    cgen = torch.Generator(device=DEV).manual_seed(54)
    z, y = get_zdist("gauss", 512)(cgen, 4096), get_ydist(10)(cgen, 4096)
    require(z.device.type == cgen.device.type and z.shape == (4096, 512) and abs(float(z.mean())) < 0.01 and abs(float(z.std()) - 1) < 0.01,
            f"get_zdist on the card: {z.shape}, mean {float(z.mean())}, std {float(z.std())}")
    require(y.device.type == cgen.device.type and int(y.min()) == 0 and int(y.max()) == 9, "get_ydist on the card")
    tree, _ = load_state(state_path)
    flat = {k: torch.from_numpy(np.array(v)) for k, v in flatten_tree(tree).items()}
    with tempfile.TemporaryDirectory() as tmp:
        cio = CheckpointIO(tmp)
        cio.register_modules(state=unflatten_tree({k: v.to(DEV) for k, v in flat.items()}))
        cio.save("phase7.npz", it=MASKED_ITER)
        back = CheckpointIO(tmp)
        back.register_modules(state=None)
        manifest = back.load("phase7.npz")
        got = {k: torch.from_numpy(np.array(v)) for k, v in flatten_tree(back.module_dict["state"]).items()}
    require(manifest["step"] == MASKED_ITER and got.keys() == flat.keys()
            and all(torch.equal(got[k], flat[k]) for k in flat), "the CheckpointIO round trip is not bitwise")
    print(f"  spectral / conditional norms card vs CPU worst {worst:.3e} of max|ref|; samplers on the card; "
          f"CheckpointIO round trip of phase 7's state ({len(flat)} tensors) bitwise [{card}]", flush=True)
    return worst


def format_writers():
    """`tests/torch_fixtures/format_writers.py`, loaded by its path (numpy
    and the standard library only: the card's host has no PIL)."""
    spec = importlib.util.spec_from_file_location("format_writers", FORMAT_FIXTURES.parent / "format_writers.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def format_fixtures(card: str, root: str) -> dict:
    """(e) Every committed BMP, TIFF and WebP fixture decoded on this host,
    its pixels' sha256 against PIL's in the manifest; the decode time of one
    512x512 image in each timed variant, the median of 5 rounds of 5, per
    image: the BMP and TIFF files written here by `timing_files` from the
    first cat JPEG's pixels (each held to the pixels it was written with,
    which a CPU test holds to PIL's) and the two 512x512 WebP fixtures;
    `cli.prepare_data` of the mixed folder against the hash of
    `rick_tpu.prepare_dataset`'s store.  Returns {variant: ms per image}."""
    manifest = json.loads((FORMAT_FIXTURES / "manifest.json").read_text())
    t0 = time.perf_counter()
    for rel in ("bmp/rle8.bmp", "tiff/rgb_tiles_lzw_predictor.tiff", "webp/lossy_7x9.webp"):
        decode_image((FORMAT_FIXTURES / rel).read_bytes())  # builds the g++ libraries
    build_s = time.perf_counter() - t0
    blobs = {rel: (FORMAT_FIXTURES / rel).read_bytes() for rel in manifest["files"]}
    for rel, entry in manifest["files"].items():
        img = decode_image(blobs[rel], name=rel)
        digest = hashlib.sha256(img.tobytes()).hexdigest()
        require(list(img.shape) == entry["shape"] and digest == entry["sha256_pixels"],
                f"{rel}: decoded {img.shape} {digest[:16]}, PIL's {entry['shape']} {entry['sha256_pixels'][:16]}")
    print(f"  {len(blobs)} fixtures decoded, every sha256 equal to PIL's; g++ builds {build_s:.2f} s", flush=True)
    rgb = decode_jpeg((JPEG_FIXTURES / "cat" / "00.jpg").read_bytes())
    timed = {}
    for variant, (blob, want) in format_writers().timing_files(rgb).items():
        require(np.array_equal(decode_image(blob, name=variant), want), f"{variant}: not the pixels written")
        timed[variant] = blob
    timed["WebP lossy q80"] = blobs["webp/lossy_512.webp"]
    timed["WebP lossless"] = blobs["webp/lossless_512.webp"]
    ms = {}
    for variant, blob in timed.items():
        rounds = []
        for _ in range(5):
            t0 = time.perf_counter()
            for _ in range(5):
                decode_image(blob)
            rounds.append((time.perf_counter() - t0) / 5 * 1e3)
        ms[variant] = float(np.median(rounds))
        print(f"    512x512 {variant}, {len(blob)} bytes: {ms[variant]:.3f} ms per image (median of 5 rounds of 5; "
              f"rounds {min(rounds):.3f}-{max(rounds):.3f}), {CAT_PX / ms[variant] * 1e3:.1f} MP/s on the host "
              f"[{card}]", flush=True)
    want = manifest["mixed_store"]
    store = os.path.join(root, "formats_store")
    prepare_data_cli.main(["--input_path", str(FORMAT_FIXTURES / "mixed"), "--output_path", store, "--size",
                           str(want["size"]), "--n_worker", "1"])
    digest = store_sha256(store)
    require(digest == want["sha256_pixels"], f"the mixed store's pixels {digest[:16]} != rick_tpu's "
                                             f"{want['sha256_pixels'][:16]}")
    print(f"  the mixed folder's store of {want['n']} at {want['size']}px equal to rick_tpu.prepare_dataset's "
          f"[{card}]", flush=True)
    return ms


def formats_phase(card: str, root: str, state_path: str) -> dict:
    """Phase 20; returns the --augment CLI run's launches under matmul_fir."""
    t_phase = time.perf_counter()
    print(f"  (a) the three warp lowerings on the card vs the CPU: {SIZE}px, margin {ADA_MARGIN}, batch 2, "
          f"tolerance {WARP_TOL} * max|ref|; matmul vs gather {WARP_PAIR_TOL}", flush=True)
    warp_err = warp_lowerings_vs_cpu()
    print("  (b) cost of each lowering", flush=True)
    lowering_costs(card)
    lowering_ab(card)
    print("  (c) train CLI with --augment under RICK_ADA_WARP=matmul_fir: 256px batch 2, iterations 0-10, FID@100",
          flush=True)
    with warp_lowering("matmul_fir"):
        counts = ada_cli_run(card, root, FIR_CLI_FLAGS, "--augment (matmul_fir)")
    print("  (d) legacy/ on the card", flush=True)
    legacy_err = legacy_on_card(state_path, card)
    print("  (e) BMP, TIFF and WebP inputs on the card's host", flush=True)
    format_fixtures(card, root)
    print(f"  phase 20: {time.perf_counter() - t_phase:.1f} s; lowerings card vs CPU worst {warp_err:.3e}, legacy "
          f"{legacy_err:.3e}", flush=True)
    return counts


# ---------------------------------------------------------------------------
# phase 21: the threaded batch decoder and the train CLI's host stream
# ---------------------------------------------------------------------------

NATIVE_SMALL = 128  # below the store's 256: the decoder's own resize runs
NATIVE_ROUNDS = 3
NATIVE_ULP = 2.0**-23  # a float32 ulp at 1: px * float32(1 / 127.5) - 1 against px / 127.5 - 1
NATIVE_JPEG_N = 1000  # the ten cat JPEGs (512x512), repeated
# phase 15 (e)'s run without --augment, with the 1000 test images as the
# training set: 1000 x 3 x 256^2 x 4 bytes = 786 MB, over the CLI's 512 MiB,
# so the run streams from the host thread through decode_batch
NATIVE_CLI_N = 1000
NATIVE_CLI_FLAGS = [
    "--size", "256", "--batch", "2", "--n_sample_train", str(NATIVE_CLI_N), "--num_fisher_img", "5",
    "--fisher_quantile", "40", "--prune_quantile", "0.1", "--allow_random_fisher_noise", "--eval_in_training",
    "--store_samples", "--warmup_iter", "4", "--fisher_freq", "8", "--eval_in_training_freq", "10",
    "--samples_freq", "10", "--n_sample_test", "100", "--iter", "0", "--exp", "native",
]


def levels(x: np.ndarray) -> np.ndarray:
    """[-1, 1] floats of either normalization -> the uint8 levels."""
    return np.rint((x.astype(np.float64) + 1.0) * 127.5).astype(np.uint8)


def native_parity(root: str, card: str) -> dict:
    """(b) Phase 14's two stores (10 + 1000 PNGs at 256px), flips off: one
    `decode_batch` of each against `ImageDataset.get` one at a time (the
    levels bitwise; the floats equal to rick_tpu's normalization of them,
    within an ulp of `train_transform`'s), and at NATIVE_SMALL against the
    plain numpy transcription of rick_tpu's float resize (bitwise) and the
    port's F.interpolate path (within one level).  Returns the seconds of
    the one-at-a-time path on the 1000."""
    worst_ulp, worst_small, n, one_s = 0.0, 0.0, 0, 0.0
    for split in ("_processed_train", "_processed_test"):
        path = os.path.join(root, split, "babies")
        ds = ImageDataset(path, SIZE, flip=False)
        t0 = time.perf_counter()
        py = np.stack([ds.get(i, None) for i in range(len(ds))])
        one_s = time.perf_counter() - t0
        got = NativeImageDataset(path, SIZE, flip=False).decode_batch(np.arange(len(ds)), None)
        lv = levels(py)
        require(np.array_equal(levels(got), lv), f"{split}: decode_batch's levels are not ImageDataset.get's")
        require(np.array_equal(got, lv.astype(np.float32) * native_module._NORM - np.float32(1)),
                f"{split}: decode_batch is not px * float32(1 / 127.5) - 1 of ImageDataset.get's levels")
        worst_ulp = max(worst_ulp, float(np.abs(got - py).max()))
        small = NativeImageDataset(path, NATIVE_SMALL, flip=False).decode_batch(np.arange(len(ds)), None)
        imgs = lv.transpose(0, 2, 3, 1)  # the decoded images: the store is at 256, no crop, no flip
        plain = np.stack([native_module.process_one(im, NATIVE_SMALL, False) for im in imgs])
        require(np.array_equal(small, plain), f"{split}: decode_batch at {NATIVE_SMALL} is not the numpy "
                                              "transcription of rick_tpu's float resize")
        interp = np.stack([train_transform(im, NATIVE_SMALL, None, flip=False) for im in imgs])
        worst_small = max(worst_small, float(np.abs(small - interp).max()))
        n += len(ds)
    require(worst_ulp <= NATIVE_ULP, f"decode_batch against ImageDataset.get: {worst_ulp:.3e} > {NATIVE_ULP:.3e}")
    require(worst_small <= 1 / 127.5 + 1e-6, f"at {NATIVE_SMALL}, against F.interpolate: {worst_small:.3e} > 1 level")
    print(f"  (b) {n} PNGs at {SIZE}px: decode_batch's levels bitwise ImageDataset.get's, its floats rick_tpu's "
          f"normalization of them, {worst_ulp:.3e} from train_transform's (<= one float32 ulp); at "
          f"{NATIVE_SMALL}px bitwise the numpy transcription of rick_tpu's float resize, {worst_small:.3e} "
          f"({worst_small * 127.5:.2f} levels) from the port's F.interpolate path [{card}]", flush=True)
    return dict(one_at_a_time_s=one_s)


def native_rates(root: str, card: str, png_one_s: float) -> dict:
    """(c) Images/s of `decode_batch` (one call over the whole set, the
    median of NATIVE_ROUNDS) at 1, 8 and os.cpu_count() threads against the
    one-at-a-time path (`ImageDataset.get`, one pass): the 1000 PNGs at
    256px (no resize), and the ten 512x512 cat JPEGs repeated to 1000,
    decoded to 256px (each path's resize runs)."""
    cats = sorted((JPEG_FIXTURES / "cat").glob("*.jpg"))
    jpeg_store = os.path.join(root, "native_cat")
    with RecordStoreWriter(jpeg_store) as w:
        for k in range(NATIVE_JPEG_N):
            w.append(cats[k % len(cats)].read_bytes())
    ds = ImageDataset(jpeg_store, SIZE, flip=False)
    t0 = time.perf_counter()
    for i in range(len(ds)):
        ds.get(i, None)
    jpeg_one_s = time.perf_counter() - t0
    threads = sorted({1, 8, os.cpu_count() or 1})
    rates = {}
    for label, path, one_s in (("PNG 256px", os.path.join(root, "_processed_test", "babies"), png_one_s),
                               ("JPEG 512px -> 256px", jpeg_store, jpeg_one_s)):
        n = len(NativeImageDataset(path, SIZE))
        line = [f"one at a time {n / one_s:.1f}"]
        for t in threads:
            nds = NativeImageDataset(path, SIZE, flip=False, n_threads=t)
            rounds = []
            for _ in range(NATIVE_ROUNDS):
                t0 = time.perf_counter()
                nds.decode_batch(np.arange(n), None)
                rounds.append(time.perf_counter() - t0)
            rates[label, t] = n / float(np.median(rounds))
            line.append(f"{t} thread{'s' * (t > 1)} {rates[label, t]:.1f} (rounds {n / max(rounds):.1f}-"
                        f"{n / min(rounds):.1f})")
        rates[label, "one"] = n / one_s
        print(f"  (c) {label}, {n} images, images/s: " + "; ".join(line) + f"; host CPUs {os.cpu_count()} "
              f"[host of {card}]", flush=True)
    return rates


@contextlib.contextmanager
def recorded_streams():
    """Which stream the train CLI opens inside the block, the seconds each
    `next` on it waits (host clock), and every `decode_batch` call (batch
    size, host seconds)."""
    rec = {"streams": [], "next_s": [], "decode_batch": []}
    orig = {name: getattr(train_cli, name) for name in ("data_stream", "device_data_stream")}
    inner_decode = NativeImageDataset.decode_batch

    class Timed:
        def __init__(self, inner):
            self.inner = inner

        def __iter__(self):
            return self

        def __next__(self):
            t0 = time.perf_counter()
            out = next(self.inner)
            rec["next_s"].append(time.perf_counter() - t0)
            return out

        def close(self):
            self.inner.close()

    def opening(name):
        def open_stream(*args, **kwargs):
            rec["streams"].append(name)
            return Timed(orig[name](*args, **kwargs))
        return open_stream

    def decode_batch(self, idx, rng):
        t0 = time.perf_counter()
        out = inner_decode(self, idx, rng)
        rec["decode_batch"].append((len(out), time.perf_counter() - t0))
        return out

    for name in orig:
        setattr(train_cli, name, opening(name))
    NativeImageDataset.decode_batch = decode_batch
    yield rec
    for name, fn in orig.items():
        setattr(train_cli, name, fn)
    NativeImageDataset.decode_batch = inner_decode


def native_cli_run(root: str, card: str, staged_iteration_s: float) -> dict:
    """(d) The train CLI with --n_sample_train NATIVE_CLI_N on phase 14's
    store (iterations 0-10, FID@100): the training set is a
    NativeImageDataset too large to stage, so every batch comes from the
    host thread's decode_batch; K1-K4 launched, losses and FIDs finite.
    Returns its launches."""
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    with SectionTimer() as timer, recorded_streams() as rec:
        r = train_cli.main(cli_flags(root) + NATIVE_CLI_FLAGS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    recs = [json.loads(line) for line in (Path(root) / "out" / "native" / "stats.jsonl").read_text().splitlines()]
    losses = [rec_ for rec_ in recs if "d" in rec_]
    fids = [(rec_["step"], rec_["fid"]) for rec_ in recs if "fid" in rec_]
    require((r["iterations"], r["evaluations"]) == (11, 2), f"the host-stream CLI run stopped early: {r}")
    require(rec["streams"] == ["data_stream"], f"the CLI opened {rec['streams']}, not the host stream")
    batches = [n for n, _ in rec["decode_batch"] if n == 2]  # the rest are get's (get_nsamples' real grid)
    require(len(batches) >= r["iterations"] and {n for n, _ in rec["decode_batch"]} <= {1, 2},
            f"decode_batch calls {[n for n, _ in rec['decode_batch']][:20]}: not one batch of 2 per iteration")
    require(losses and all(math.isfinite(v) for rec_ in losses for v in rec_.values()), "a loss is not finite")
    require(len(fids) == 2 and all(math.isfinite(f) for _, f in fids), f"FID {fids}")
    require(all(counts[k] > 0 for k in SOURCES), f"a kernel did not launch in the host-stream CLI run: {counts}")
    n_iter, iter_s = timer.take()["run_iteration"]
    decode_ms = 1e3 * float(np.mean([s for n, s in rec["decode_batch"] if n == 2]))
    print(f"  (d) CLI --n_sample_train {NATIVE_CLI_N} ({NATIVE_CLI_N * 3 * SIZE * SIZE * 4 / 1e6:.0f} MB decoded, "
          f"over the 512 MiB staging limit): the host stream, {len(batches)} decode_batch calls of 2 images, "
          f"{decode_ms:.3f} ms each on the producer thread; next(train_loader) {1e3 * np.mean(rec['next_s']):.3f} ms "
          f"mean, {1e3 * max(rec['next_s']):.3f} ms worst over {len(rec['next_s'])}; run_iteration "
          f"{iter_s / n_iter:.4f} s mean over {n_iter} against {staged_iteration_s:.4f} s in phase 14's staged first "
          f"run; FID {fids}; wall {wall:.3f} s [{card}]; launches {counts}", flush=True)
    return counts


def native_phase(card: str, root: str, staged_iteration_s: float) -> dict:
    """Phase 21 on phase 14's store; returns the host-stream CLI run's
    launches."""
    t_phase = time.perf_counter()
    require(native_module.native_available(), f"rickdata.cpp does not build: {native_module.build_error()}")
    gxx = _build.host_build_seconds.get("rickdata.cpp")  # phase 14's first CLI run built it
    print(f"  (a) rickdata.cpp: g++ {gxx:.2f} s at its build in this process" if gxx is not None else
          "  (a) rickdata.cpp: a build found on disk", flush=True)
    parity = native_parity(root, card)
    native_rates(root, card, parity["one_at_a_time_s"])
    counts = native_cli_run(root, card, staged_iteration_s)
    print(f"  phase 21: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return counts


def main() -> int:
    card = card_line()
    print(card, flush=True)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs a GPU", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t_start = time.perf_counter()

    print("[1] build", flush=True)
    t0 = time.perf_counter()
    _build.lib()
    print(f"  nvcc build {_build.build_seconds:.1f} s, load {time.perf_counter() - t0:.1f} s total", flush=True)
    report = _build.ptxas_report()
    for fn in report:
        print(f"  ptxas: {fn['name']}: {fn['registers']} registers, {fn['spill_stores']} bytes spill stores, "
              f"{fn['spill_loads']} bytes spill loads", flush=True)
    k4 = [fn for fn in report if "convt_blur_act_kernel" in fn["name"]]
    require(len(k4) == 12, f"expected 12 instantiations of K4's kernel (4 stages x 3 tiles), ptxas shows {len(k4)}")
    spilled = [fn["name"] for fn in k4 if fn["spill_stores"] or fn["spill_loads"]]
    require(not spilled, f"K4's kernel spills registers in {spilled}")
    # K4's conv runs on the tensor cores: HGMMA (wgmma) in every stage that computes it
    hgmma = {k: v for k, v in _build.sass_counts("HGMMA").items() if "convt_blur_act_kernel" in k}
    print(f"  SASS HGMMA per K4 instantiation: {hgmma}", flush=True)
    no_mma = [k for k, v in hgmma.items() if not v and "kernel<0," not in k and "kernelILi0E" not in k]
    require(len(hgmma) == 12 and not no_mma, f"K4's conv has no HGMMA in {no_mma or hgmma}")
    k6 = [fn for fn in report if "modconv_act_kernel" in fn["name"]]
    spilled = [fn["name"] for fn in k6 if fn["spill_stores"] or fn["spill_loads"]]
    require(len(k6) == 3 and not spilled, f"K6's kernel: {len(k6)} instantiations (3 tiles), spills in {spilled}")
    hgmma = {k: v for k, v in _build.sass_counts("HGMMA").items() if "modconv_act_kernel" in k}
    print(f"  SASS HGMMA per K6 instantiation: {hgmma}", flush=True)
    require(len(hgmma) == 3 and all(hgmma.values()), f"K6's conv has no HGMMA in {hgmma}")

    print(f"[2] forward kernels vs plain, batch {B} (K6 at batch {GEN_BATCH}), TF32 off", flush=True)
    per_kernel = run_cases(forward_cases(torch.Generator(device=DEV).manual_seed(1234)))
    per_kernel.update(run_cases(k6_cases(torch.Generator(device=DEV).manual_seed(1235))))

    print("[3] generation slice: 256px G/D, checkpoint round trip, sample grid, batch-100 generation, D", flush=True)
    with tempfile.TemporaryDirectory() as tmpdir:
        g_ema, d = build_and_reload(tmpdir)
    gen_counts = run_slice(g_ema, d)

    print(f"[4] generation slice vs plain (CPU), tolerance {SLICE_TOL} * max|ref|", flush=True)
    slice_vs_plain(g_ema, d)

    print("[5] generation timing", flush=True)
    measure_generation(g_ema, d, card)
    del g_ema, d

    print(f"[6] training kernels vs plain at the 256px batch-2 shapes, TF32 off, tolerance {GRAD_TOL} * max|ref|",
          flush=True)
    trained = check_training_kernels()
    per_kernel["fused_bias_act_bwd"] = trained["fused_bias_act_bwd"]
    for name, err in trained["autograd_err"].items():
        per_kernel[name]["max_abs_err"] = max(per_kernel[name]["max_abs_err"], err)

    print(f"[7] training slice: 256px, batch 2, iterations {TRAIN_ITERS}, Fisher round, iteration {MASKED_ITER} "
          "under the masks", flush=True)
    torch.cuda.reset_peak_memory_stats()
    state, tcfg, train_counts = train_slice(card)
    dp_dir = tempfile.mkdtemp(prefix="chip_smoke_dp_")  # phase 18's inputs
    dp_files = {k: os.path.join(dp_dir, f) for k, f in (("state", "phase7.state.npz"), ("inputs", "inputs.pt"),
                                                          ("g_ema", "g_ema.pt"), ("incp", "incp.pt"),
                                                          ("real_acts", "real_acts.npy"))}
    save_state(dp_files["state"], train_state_to_jax(state), step=MASKED_ITER)

    print("[8] training slice vs plain (CPU) at 256px: each phase and a Fisher accumulation", flush=True)
    cpu_s = train_vs_plain(state, tcfg)
    print(f"  CPU seconds of the four phases: {sum(v for k, v in cpu_s.items() if k != 'fims'):.1f}", flush=True)

    print("[9] training timing", flush=True)
    plain_ms = measure_training(state, tcfg, card)
    del state

    print(f"[10] K5: K4 cut after each stage, vs plain at batch {B} (TF32 off), then the ablation at batch "
          f"{bench_fused_ablate.BATCH}", flush=True)
    k5 = check_k5()

    print(f"[11] eval slice: 256px g_ema, FID@{EVAL_N} at gen_batch {GEN_BATCH}, seeded Inception", flush=True)
    torch.cuda.reset_peak_memory_stats()
    g_ema, ev, incp, real, real_s = build_eval()
    print(f"  real set: {EVAL_N} uint8 images, activations in {real_s:.2f} s (first call)", flush=True)
    eval_counts = eval_slice(g_ema, ev)
    print(f"  peak device memory of the eval: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)

    print(f"[12] eval slice vs plain (CPU), tolerance {SLICE_TOL} * max|ref|", flush=True)
    eval_vs_plain(g_ema, ev, incp)

    print("[13] eval timing", flush=True)
    measure_eval(g_ema, ev, real, card)
    print(f"  peak device memory of the eval phases: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)

    with tempfile.TemporaryDirectory() as root:
        print(f"[14] train CLI: 256px batch 2, --iter {CLI_ITERS}, then --iter {CLI_RESUME_ITERS} --auto_resume",
              flush=True)
        cli_counts, cli_first = cli_phase(card, root)

        print(f"[15] ADA: 256px, margin {ADA_MARGIN}", flush=True)
        t_ada = time.perf_counter()
        print(f"  (a) the augment on the card vs the CPU, batch {B}, tolerance {ADA_TOL} * max|ref|", flush=True)
        augment_err = augment_vs_cpu()
        print(f"  (b) training slice with augment, adaptive p from {ADA_START_P}, iterations {TRAIN_ITERS}",
              flush=True)
        torch.cuda.reset_peak_memory_stats()
        state, tcfg, ada_counts = ada_train_slice()
        print("  (c) the D and G phases with ADA vs plain (CPU), update firing", flush=True)
        state.ada_stats = torch.tensor(ADA_START_STATS, device=DEV)
        train_vs_plain(state, tcfg, phases=("d", "g"), fims=False)
        print("  (d) timing at a fixed p = 0.5", flush=True)
        fixed = TrainConfig(batch=2, augment=True, augment_p=0.5, warmup_iter=1, ada_margin=ADA_MARGIN)
        state.ada_p = torch.full((), 0.5, device=DEV)
        ada_ms = measure_training(state, fixed, card, fisher=False)
        ada_ms.update(measure_augment(card))
        ada_ab(state, card)
        del state
        print("  ms, 256px batch 2, without / with ADA (p = 0.5): " + "; ".join(
            f"{k} {plain_ms[k]:.2f} / {ada_ms[k]:.2f}" for k in ("D", "R1", "G", "path", "mix"))
            + f" [{card}]; peak device memory with ADA {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
              flush=True)
        print("  (e) train CLI with --augment: 256px batch 2, iterations 0-10, FID@100", flush=True)
        ada_cli_counts = ada_cli_run(card, root)
        print(f"  phase 15: {time.perf_counter() - t_ada:.1f} s; augment card vs CPU worst {augment_err:.3e}",
              flush=True)

        print("[16] scoring: VGG16 and LPIPS, precision/recall in the Evaluator, intra-LPIPS of best.pt, the "
              "metric CLIs", flush=True)
        t_score = time.perf_counter()
        print(f"  (a) VGG16 fc2 ({SCORE_B} images) and LPIPS ({SCORE_B} pairs), {SIZE}px, vs the CPU, tolerance "
              f"{SLICE_TOL} * max|ref|", flush=True)
        vgg_err = vgg_lpips_vs_cpu()
        print(f"  (b) precision/recall in the Evaluator: {EVAL_N} samples, phase 11's g_ema and real set", flush=True)
        torch.cuda.reset_peak_memory_stats()
        pr_counts = pr_eval(g_ema, ev, incp, real, card)
        print(f"  peak device memory of (b): {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
        print("  (c) intra_lpips prepare and compute on phase 14's store and best.pt", flush=True)
        torch.cuda.reset_peak_memory_stats()
        intra_counts = intra_lpips_phase(root, card)
        print(f"  peak device memory of (c): {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
        print(f"  (d) fid, kid and precision_recall CLIs on two .npy sets of {CLI_SET_N}", flush=True)
        metric_clis(g_ema, real, root, card)
        score_counts = {k: pr_counts[k] + intra_counts[k] for k in pr_counts}
        print(f"  phase 16: {time.perf_counter() - t_score:.1f} s; VGG16/LPIPS card vs CPU worst {vgg_err:.3e}; "
              f"launches in the scoring runs (b) + (c) {score_counts}", flush=True)

        print("[17] bf16: K1-bf16 and K3-bf16, the bf16 training phases, Evaluator(gen_dtype=bf16), train --bf16",
              flush=True)
        t_bf16 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        bf16_kernels, bf16_runs = bf16_phase(g_ema, ev, incp, root, card)
        print(f"  phase 17: {time.perf_counter() - t_bf16:.1f} s; peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
        torch.save(g_ema.state_dict(), dp_files["g_ema"])
        torch.save(incp, dp_files["incp"])
        np.save(dp_files["real_acts"], ev._real_acts)
        dp_inputs(dp_files["inputs"])
        del g_ema, ev, real

        print(f"[18] data-parallel over torch.distributed: (a) the train CLI under torchrun (NCCL, world 1) vs phase "
              f"14; (b) two ranks on the one card over gloo: iterations {DP_ITERS} from phase 7's state, a sharded "
              f"Fisher accumulation, a sharded FID@{DP_EVAL_N}", flush=True)
        t_dp = time.perf_counter()
        dp_runs = {"dp_cli": dp_cli(root, cli_first, card)}
        dp_runs.update(dp_ranks(dp_files, card))
        print(f"  phase 18: {time.perf_counter() - t_dp:.1f} s ({DP_LABEL})", flush=True)

        print("[19] JPEG inputs: the fixtures against PIL's pixels, prepare_data on ten 512x512 JPEGs, the AFHQ-Cat "
              "recipe's train CLI on that store, cli.fid's folder loader", flush=True)
        cat = cat_phase(card, root)

        print("[20] ADA's warp lowerings (gather, matmul, matmul_fir) on the card, the --augment CLI under matmul_fir, "
              "legacy/, BMP/TIFF/WebP inputs", flush=True)
        fir_cli_counts = formats_phase(card, root, dp_files["state"])
        shutil.rmtree(dp_dir)

        print("[21] the threaded batch decoder (data/native.py): its build, pixels against the one-at-a-time path "
              "and rick_tpu's float resize, images/s by threads, the train CLI's host stream through it",
              flush=True)
        native_cli_counts = native_phase(card, root, cli_first["iteration_s"])
    print(f"  chip_smoke total {time.perf_counter() - t_start:.1f} s", flush=True)

    kernels = []
    for name, (source, replaces) in SOURCES.items():
        k = per_kernel[name]
        by_run = {"generation": gen_counts[name], "training": train_counts[name], "eval": eval_counts[name],
                  "cli": cli_counts[name], "ada": ada_counts[name], "ada_cli": ada_cli_counts[name],
                  "score": score_counts[name], **{run: counts[name] for run, counts in dp_runs.items()},
                  "cat_cli": cat["counts"][name], "ada_fir_cli": fir_cli_counts[name],
                  "native_cli": native_cli_counts[name]}
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces, launches=sum(by_run.values()),
            max_abs_err=k["max_abs_err"], ms=k["ms"], plain_ms=k["plain_ms"], bound_ms=k["bound_ms"],
            bound_by=k["bound_by"], library_ms=k.get("library_ms"), shape=k["shape"], launches_by_run=by_run,
            ms_with_host=k["ms_with_host"],
        ))
    kernels += k5["entries"]
    for name, (source, replaces) in BF16_SOURCES.items():
        k = bf16_kernels[name]
        by_run = {run: counts[name] for run, counts in {**bf16_runs, **dp_runs}.items()}
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces, launches=sum(by_run.values()),
            max_abs_err=k["max_abs_err"], ms=k["ms"], plain_ms=k["plain_ms"], bound_ms=k["bound_ms"],
            bound_by=k["bound_by"], library_ms=None, shape=k["shape"], launches_by_run=by_run,
            ms_with_host=k["ms_with_host"], launch_floor_ms=k["launch_floor_ms"], share_with_floor=k["share"],
            rows_ms=k["rows_ms"], bitwise_rows=k["bitwise_rows"],
        ))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp-cli"]:  # phase 18 (a): a rank that torchrun starts
        dp_cli_rank(sys.argv[2], sys.argv[3:])
        sys.exit(0)
    sys.exit(main())
