#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
GPU: the quickest proof that the port builds, is right, and runs its main
path on the card.

    python3 chip_smoke.py

Phases, each ending in ``torch.cuda.synchronize()`` so a fault shows where
it happened; any failure ends the run with a non-zero exit code:
  1. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (one nvcc
     per library, sm_90a, all started together) and print the build time
     and the card's name and power limit;
  2. hold each kernel against its plain PyTorch version on the card at the
     main path's shapes (a [20, 4671, 256] f32 commit stack for the fused
     and secure commit kernels, the [20*4096, 256] dense1_w leaf for the
     per-leaf ones, 20 clients' dense1_w for the FedProx update, the
     full-width Jamba prefill's [1, 128, 16384, 16] chunk and a strided
     batch-2 chunk view for the selective scan and its backward, the
     backward also with a zero g_hl and with none), each with its extra
     cases (the fused accumulate at other slot counts and block widths;
     the fused accumulate and the plain commit at the async buffer's
     [8, 4671, 256] under the async phase's staleness, and the fused
     accumulate at the char-LM's [8, 12681, 256]; the hierarchy's tier-2
     commit, one slot per facility: the fused accumulate at [4, 4671,
     256], [2, ...] and [1, ...] and the secure commit at K=4; the plain
     commit at K=1
     and K=64 past its staged slots, without quantize,
     without top-k, at 4 bits, with a zero-weight slot, ties and zero rows,
     other block widths and half-way quotients; the top-k at k=1 and
     k=block, ties across the k-th value with all-zero rows, subnormals, one
     exponent, other block widths and the small leaves as the main path
     pads them; the secure commit past its register path, with
     non-cancelling coefficients (also through a row table that places
     each row at its own block-row of a bucket twice as long, as a
     share's rows of a cut leaf are placed), random coefficients under
     asymmetric seeds, at 4
     bits, with a noise operand and with a zero-weight slot), and the secure
     commit's mask-word fold against its plain version; the scan and its
     backward under ``vmap`` (2 clients folded into the batch of the
     [1, 128, 16384, 16] chunk) bit for bit against unvmapped calls; and
     time kernel,
     plain version and library call with CUDA events, each per call (median
     of 30 after 3 warm-up launches) and the kernel and library call also
     over 30 back-to-back launches; then the commit kernels past their old
     slot limits, bit for bit against their plain versions and timed over
     a few calls: fused_accum and plain_commit at K=12289 (past the 12288
     slot weights staged in shared memory) over 8 block-rows, secure_commit
     at K=1025 (past the 1024 thresholds kept in shared memory) and K=4096
     under the upper-triangle coefficients;
  3. hold rounds on the card against the CPU from the same params, batches
     and compression draws, to 1e-4 (8 clients, 2 local steps, batch 16;
     one straggler cut): for each launcher configuration, the
     secure float-mask round and the fused FedProx update, the clients'
     deltas, the commit from the same deltas (the kernels against their
     plain versions in place), and the whole round where the commit has no
     compression; and whole sequential and pod_sequential rounds (TF32 is
     off for convolutions and matmuls, so the card computes in full float32
     as the CPU does); then paper-charlm at full width (4 clients, 2 local
     steps, batch 16 of 64 tokens): its deltas, its uncompressed, q8 +
     top-k and secure q8 + top-k commits from the same deltas, and its
     uncompressed round;
  4. drive the main path, ``repro_torch.launch.train.main`` on cuda at the
     full CIFAR CNN width (60-client pool, 20 clients per round, 5 local
     steps, batch 16, 3 rounds, client lr 0.01), once for each launcher
     configuration that reaches a commit kernel, and one Orchestrator run
     built as the launcher builds it with the fused FedProx update, with
     the launch counts set to 0 just before each run and read just after;
     the same with ``--dataset shakespeare`` at full paper-charlm width;
     a checkpointed CIFAR run cut after 2 rounds and resumed to 3 on the
     card and, from the same checkpoint, on the CPU; and ``python -m
     repro_torch.worker --once`` on the card (its process started before
     the resumed runs, beside them) against the CPU worker;
  5. the async path (``async_path``): (a) the async buffer commit on the
     card against the CPU from the same full-width CIFAR params and K=8
     deltas, staleness [0, 1, 2, 3, 0, 5, 1, 20], the exponent 0.5 and the
     adaptive controller's first alpha, for the default, q8 + top-k
     (deterministic and stochastic, the same generator draws), secure q8 +
     top-k and chunked (4 of 8) commits and two partial buffers, to 1e-4,
     and the secure commits' slot weights ``w_eff`` card against CPU,
     bitwise;
     (b) ``train.run`` with ``--mode async`` on cuda at full CIFAR width
     (60-client pool, 16 in flight, buffer 8, 5 local steps, batch 16, 6
     commits) for the default, q8 + top-k, secure q8 + top-k, chunked,
     adaptive-exponent-with-timeout and batched-engine configurations,
     each run's launches counted from 0 and held against its commits, every
     commit's wall time and phase_wall printed; then the char-LM at full
     paper-charlm width (3 commits); (c) a checkpointed async run cut
     after 4 commits and resumed to 6 on the card and, from a copy, on the
     CPU, and against the card's uninterrupted run;
  6. the fleet path (``fleet_path``), at full CIFAR width: (a) ``--engine
     window``, uncompressed and secure q8 + top-k, against ``--engine
     batched`` (equal events and log host fields; params within 1e-5,
     and under compression, where top-k and rounding flips add up, the
     gap printed),
     each commit's phase_wall printed, its host syncs held at 1, its
     launches at one commit kernel a commit, and the busy share over 2
     warm commits; (b) ``--engine auto`` at a 300-client pool, which must
     pick the window engine; (c) a 100,000-client ``make_mega_fleet``
     cohort fleet over a ``VirtualFederatedDataset``, window against
     batched, with the wall time a commit; (d) a window run on the card
     against the CPU, to 1e-4; (e) the hierarchy, ``--facilities 4
     --local-rounds 2 --rounds 3`` (15 clients a facility): sync/sync,
     async/async with ``--inter-buffer 2``, and sync/sync secure q8 +
     top-k, launches held at the facilities' rounds or commits plus the
     tier-2 commits, with the wall time an epoch and the tier-2 commit
     step's; (f) a 2-facility hierarchy (8 clients a round) on the card
     against the CPU, to 1e-4, and a checkpointed async/async hierarchy
     cut after 2 of 3 tier-2 commits and resumed on the card, bit for bit
     against the card's uninterrupted run;
  7. serve an LM (``lm_serve``): (a) the reduced Jamba, Llama-3.2-Vision
     and MusicGen on the card against the CPU (f32: prefill logits, every
     decode-state leaf, the VLM's cross K/V cache included, 4 decode steps,
     to 1e-4); then Jamba-1.5-Large at every published width, cut to 8
     layers and 8 experts (below), in bf16 through
     ``repro_torch.launch.serve.run``: a 2032-token prompt and 16 greedy
     decode steps, the selective scan's launches counted exactly, decoding
     held against teacher-forced prefill, the peak memory and one profiler
     pass of the prefill; (b) Llama-3.2-Vision-90B at every published
     width cut to 30 layers (below): a 2032-token prompt with (2, 1601,
     8192) image patches and 16 greedy decode steps, and (c)
     MusicGen-medium whole: a [2, 500, 4] prompt and 16 greedy decode
     steps, each with the prefill wall, the time per token, the peak
     memory, the time one read of the weights takes and decoding against
     teacher-forced prefill (printed), no kernel launched, one profiler
     pass of the prefill and the VLM's cross layers' share of it; then the
     serving command line (reduced, on cuda) through ``serve.main`` for
     Jamba, the VLM and the audio family;
  8. train the LMs (``lm_train``) through ``build_fl_round_step``, every
     round rematerialising each layer group (``LM.loss_fn``): (a) the
     reduced Jamba (f32; Mamba + MLP, attention + MoE) in parallel and
     sequential rounds, the reduced Qwen3-MoE and the reduced xLSTM in
     parallel rounds, each on the card against the CPU (4 clients, 2
     local steps, batch 2 of 64 tokens: deltas, then the default, q8 +
     top-k and secure q8 + top-k commits from the same deltas, and the
     uncompressed round), to 1e-4, with the launches of training and of
     each commit exact, and so the reduced Llama-3.2-Vision (parallel and
     sequential, each client's patches in its batch) and the reduced
     MusicGen (parallel, 4 codebooks); (b) Jamba-1.5-Large at every published width in
     bf16, cut to 2 layers and 2 experts (below): 2 sequential rounds of
     2 clients, 2 local steps, batch 1 of 1024 tokens, with the round
     wall, the peak memory and the scan's and its backward's launches
     (8 chunks x steps x clients a round, the scan twice: forward and
     recompute) exact; (c) xlstm-125m whole in
     bf16: a parallel round of 4 clients, 1 local step, batch 4 of 128
     tokens, with the round wall, the peak memory and the sLSTM's share
     of a local step; then serving a 512-token prompt at batch 2 and 16
     greedy decode steps through ``serve.run``, decoding held against
     teacher-forced prefill in float32 on the same weights (the bf16 gap
     printed); (d) MusicGen-medium whole in bf16: 2 parallel rounds of 2
     clients, 2 local steps, batch 2 of 512 frames x 4 codebooks, with
     the round wall, the peak memory (beside the 55.02 GB of the same
     round before the remat), the finite loss and one fused_accum a round; (e)
     Llama-3.2-Vision-90B at every published width cut to one [attn,
     cross] group (3,812,663,296 params, bf16): 2 sequential rounds of 2
     clients, 2 local steps, batch 1 of 1024 tokens with (1, 1601, 8192)
     patches, with the round wall, the peak memory and the finite loss (a
     round that does not fit is reported with its peak and the failed
     allocation);
  9. the mesh layer on one card (``mesh``): (a) a default CIFAR CNN round
     at full width (20 clients, 2 local steps, batch 16) and a reduced
     Jamba round under the 1x1 ``make_test_mesh()`` with
     ``client_spmd_axes="data"``, each bit for bit against the same round
     with no mesh (deterministic algorithms on), after the parallel round
     without ``client_spmd_axes`` is refused as in the reference; (b)
     ``python -m repro_torch.launch.dryrun`` for a dense, an MoE and a
     hybrid arch over every input shape on both production meshes, one
     line a tag (each tag's ``collective_bytes`` checked: the reference's
     kinds, a cross-pod entry on every multi-pod train tag and none on a
     single-pod tag), on the meta device, one process an arch with no card
     visible, started after ``round_parity`` so that it runs beside the
     card's phases (it needs no card and can allocate nothing there);
 10. the round across processes (``spmd``): (a), with a ``model`` axis of 1,
     four gloo ranks sharing the card (NCCL takes one rank a GPU) on a
     pod 2 x data 2 mesh run the full-width CIFAR round (20 clients, 2
     local steps, batch 16) in the parallel (clients over pod and data),
     sequential (each client's batch over data) and pod_sequential (2 pods
     over pod, the batch over data) modes: each rank's deltas within 1e-5
     of the same round's with no mesh here, the round's params too, the
     parallel round (the main path) launching fused_accum once a rank,
     counted alone; the
     default, q8 + top-k and secure q8 commits of this process's deltas,
     each rank on its share, bit for bit; the secure async buffer commit
     bit for bit; the reduced Jamba's sequential round (its params cut
     over data at rest and gathered a layer at a time: FSDP), its scan and
     backward launched exactly on each rank's batch share, the loss
     within 1e-3 and the params within 1e-4 of no mesh (its MoE routes
     each rank's tokens; the bounds from readings, SPMD_JAMBA_TOL); every
     commit kernel's entry point, whole and client-split, bit for bit;
     the params bit for bit across ranks throughout, and each rank's
     launches exact: first a sequential round under cuDNN's and cuBLAS's
     default algorithms, where the round's gradient mean keeps the pods
     (which repeat the work) equal, then the comparisons with no mesh
     under the deterministic ones (the default ones' rounding at a rank's
     half batch is beyond 1e-5); (b)
     MusicGen-medium whole in bf16, one
     sequential round of 2 clients x 1 step, batch 2 x 512 frames x 4
     codebooks split over two ranks sharing the card, against the same
     round with no mesh (loss within 5e-3, params within 3e-2), the
     params and a FedAdam state's bytes on each rank the dry run's (cut
     over data: FSDP), every rank reducing each gradient leaf (a leaf cut
     over data in its gather's backward, once a layer) and the loss at
     every local step of every client, with each rank's peak, the round's
     wall and its gradient reductions' and weight gathers' time; (c)
     the CIFAR parallel round as a one-rank NCCL group, bit for bit
     against no mesh under deterministic algorithms (its process beside
     the spawn of (a), (g) and (h)); (d) eight gloo ranks
     on the reference test's pod 2 x data 2 x model 2 mesh, the params
     held at rest as their sanitised specs cut them (over data and model:
     their bytes and a FedAdam state's the dry run's), run the reduced
     granite (sequential, pod_sequential), Qwen3-MoE (sequential), xLSTM
     (parallel, sequential) and Jamba (parallel: the scan and its backward
     on the rank's channels, the experts over model) rounds, each in the
     reference test's stochastic q8 against the same round with no mesh
     (loss within 5e-3, params within 3e-2) and uncompressed with the
     fused FedProx update within 1e-5 of the same round with ``model``
     dropped (its params cut over data alone; deterministic algorithms),
     the shares bit for bit on the ranks that hold them; on the first
     case's round deltas (a 2-slot stack of the delta and half of it) the
     q8 + top-k and secure q8 + top-k commits on the shares
     (``model_commit``), each bit for bit the gathered composition, the
     leaves it gathered printed; the main path's parallel CIFAR round
     against no
     mesh, launching fused_accum once a rank; every commit kernel's entry
     point with ``model`` among the fusion axes bit for bit; (e)
     granite-3-2b whole (bf16, 40 layers, every published width), one
     sequential round of 1 client x 2 steps x batch 1 x 1024 tokens with
     no mesh, then on data 1 x model 2, two ranks sharing the card: each
     rank's param bytes equal to the dry run's, its round peak held
     against no mesh's (GRANITE_PEAK_RATIO), the loss and the params
     against no mesh (5e-3, 3e-2), the collectives' time printed; (f)
     serving on a ``model`` axis through ``serve.run`` under the mesh:
     (i) eight gloo ranks on pod 2 x data 2 x model 2 serve the reduced
     zoo in f32 (granite and its 16-head variant, gemma, starcoder2 with a
     window of 8, Qwen3-MoE, Jamba, xLSTM, the VLM, MusicGen; batch 4, a
     12-token prompt, 4 decode steps fed given tokens), each rank's
     logits within 1e-5 of the same run with no mesh on the card and its
     greedy tokens equal on every rank; (ii) the lm_serve Jamba cut
     (every published width, 8 layers, 8 experts) on data 1 x model 2,
     each rank drawing the leaves whole in turn and keeping its share:
     its param and decode-state bytes equal to the dry run's, prefill of
     496 tokens and 8 decode steps fed the no-mesh run's greedy tokens,
     the logits within SERVE_DECODE_TOL of no mesh's in each row up to
     its first flipped MoE routing, at most SERVE_FLIP_SHARE of the
     routings flipped, and within the bound at every step when routed as
     no mesh routed (argmax agreement printed); the same cut with 2
     experts, each token sent to both (no routing choice), within the
     bound at every step; 28 scan launches a rank on its 8192 of 16384
     channels, prefill s, decode ms a token and each rank's peak printed;
     then the scan at a rank's chunk [1, 128, 8192, 16] bit for bit
     against its plain version and timed beside its bound; (g) FSDP over
     data: granite-3-2b whole, one sequential round of 2 clients x 1
     step x batch 2 x 1024 tokens with no mesh, then on data 2 x model 2,
     four ranks sharing the card, each layer's weights gathered over data
     just before it runs: each rank's param and FedAdam state bytes equal
     to the dry run's, the loss and the params against no mesh (5e-3,
     3e-2), the shares bit for bit on the ranks that hold them, each
     rank's collective bytes by kind equal to the dry run's count of the
     same round on its rank (``dryrun.count_collectives``), its memory
     analysis (``launch.memory.count_memory`` over the step: argument,
     output, temp and alias bytes and the peak) equal to the dry run's
     (``dryrun.count_memory``) and the allocator's peak over the step
     within MEMORY_TOL of the dry peak, each rank's
     peak, the collectives' time and gloo's GB/s printed; then, on a 2-slot
     stack of each rank's delta shares, the q8 + top-k and secure q8 +
     top-k commits on the shares, the ranks in two turns over data: the
     leaves gathered (``unembed`` alone), each commit's wall and the
     rank's commit peak, every other leaf bit for bit the commit with no
     mesh on the shares, beside the reckoned bytes of the gathered form;
     (h) (f) (ii)'s cut
     with no routing choice served on data 2 x model 2 (2 decode steps),
     one row of the batch a data rank, fed the no-mesh run's tokens: its
     param and decode-state bytes the dry run's, its collective bytes by
     kind the dry run's count of the same ``serve.run``
     (``dryrun.serve_collectives``), its memory analysis the dry run's
     (``dryrun.serve_memory``) and the allocator's peak within
     MEMORY_TOL of the dry peak, the experts' F held cut over data
     and, in decode, their partial sums added over data once a MoE layer
     a step, the logits within SERVE_DECODE_TOL of no mesh's at every
     step, 28 scans a rank on 8192 channels, each rank's peak, prefill s
     and decode ms a token printed.
The last lines are the kernels' JSON record, the nvidia-smi line, and
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import dataclasses
import functools
import gc
import io
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import worker  # noqa: E402
from repro_torch.checkpoint import load_pytree, save_pytree  # noqa: E402
from repro_torch.configs import (INPUT_SHAPES, InputShape,  # noqa: E402
                                  get_config, reduced)
from repro_torch.core import (AdaptiveStalenessController,  # noqa: E402
                              CompressionConfig, FLConfig,
                              build_buffer_commit_step,
                              build_chunked_commit_steps, build_fl_round_step)
from repro_torch.core import secure_agg as sec  # noqa: E402
from repro_torch.core.pipeline import (block_aligned,  # noqa: E402
                                       build_update_pipeline, cuts_over,
                                       cuts_share, cuts_whole)
from repro_torch.core.round import ParallelRound  # noqa: E402
from repro_torch.kernels import launches, ref  # noqa: E402
from repro_torch.kernels.fedprox_update import fedprox_update_flat  # noqa: E402
from repro_torch.kernels.fused_accum import fused_accum_blocks  # noqa: E402
from repro_torch.kernels.fused_quant_mask import (  # noqa: E402
    fold_mask_words, plain_commit_blocks, secure_commit_blocks)
from repro_torch.kernels.quantize import quantize_dequant_blocks  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels.selective_scan import (  # noqa: E402
    selective_scan_chunk_blocks, selective_scan_chunk_bwd_blocks)
from repro_torch.kernels.topk_sparsify import topk_sparsify_blocks  # noqa: E402
from repro_torch.launch import dryrun, memory, serve, train  # noqa: E402
from repro_torch.launch import specs as sp  # noqa: E402
from repro_torch.models import (build_model, param_count,  # noqa: E402
                                token_shape)
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models import sharding as shd  # noqa: E402
from repro_torch.models import xlstm as xlstm_mod  # noqa: E402
from repro_torch.data import VirtualFederatedDataset  # noqa: E402
from repro_torch.models.cnn import CIFAR_CNN, CNN  # noqa: E402
from repro_torch.optim import get_client_optimizer, get_server_optimizer  # noqa: E402
from repro_torch.orchestrator import (BatchedAsyncOrchestrator,  # noqa: E402
                                      EventWindowOrchestrator,
                                      make_mega_fleet)
from repro_torch.pytree import flat_dict, nest  # noqa: E402

CSRC = "src/repro_torch/kernels/csrc/"
F32_PEAK = 67e12          # H100 SXM f32 outside the tensor cores, FLOP/s
# H100 SXM 32-bit integer operations/s: 4 warp schedulers per SM, each
# dispatching one 32-thread instruction per clock (Hopper architecture white
# paper), x 132 SMs x 1.98 GHz (the boost clock behind F32_PEAK).  Integer
# work splits over two pipes: the ALU (the white paper's 64 INT32 lanes per
# SM) and the FMA-heavy pipe, which runs IMAD and IMUL (Nsight Compute
# Kernel Profiling Guide, "Pipelines": the ALU executes integer
# instructions "excluding IMAD and IMUL"), so dispatch is the ceiling.
INT32_PEAK = 4 * 32 * 132 * 1.98e9
K_SLOTS, BUCKET_ROWS, BLOCK = 20, 4671, 256   # the CIFAR CNN's commit bucket
# fused_accum against its plain version, (rtol, atol): the kernel and the
# plain version may sum the slots in different orders
FUSED_ACCUM_TOL = (1e-5, 1e-6)
LEAF_ROWS = 20 * 4096                          # dense1_w, 20 slots
DENSE1_W = 4096 * 256                          # dense1_w params per client
TOPK_K = CompressionConfig(quantize_bits=8, topk_frac=0.1).topk_k   # 26
# integer operations per PRF mask word of the secure commit, idx*G computed
# once per element: the seed add, three shift-xor pairs, two multiplies and
# the coefficient multiply-add
OPS_PER_MASK_WORD = 10
# integer operations per element of an exact top-k with a scale: |x|, its
# share of the selection (one comparison), the keep test and the row max
SELECT_INT_OPS = 4

# Client lr 0.01: at the launcher's default of 0.08 local training on the
# synthetic CIFAR task diverges in round 0 in the JAX reference as in the
# port (mean round-0 loss ~66 in `python -m repro.launch.train` with the
# q8_topk_deterministic flags), and how far it runs before overflowing
# depends on the random init, so a finiteness check there would test the
# init, not the port.
MAIN_ARGS = ["--device", "cuda", "--dataset", "cifar10", "--clients-pool",
             "60", "--clients-per-round", "20", "--local-steps", "5",
             "--batch-size", "16", "--rounds", "3", "--lr", "0.01"]
# The launcher configurations of the main path, the kernels each reaches,
# and its launches in a 3-round run (one commit per round; the per-leaf
# kernels run once per leaf, 8 leaves).
CONFIGS = {
    "default": ([], {"fused_accum": 3}),
    "q8_topk_deterministic": (
        ["--quantize-bits", "8", "--topk-frac", "0.1",
         "--no-stochastic-rounding"], {"plain_commit": 3}),
    "q8_topk_stochastic": (
        ["--quantize-bits", "8", "--topk-frac", "0.1"],
        {"topk_sparsify": 24, "fused_accum": 3}),
    "dropout_q8_deterministic": (
        ["--fed-dropout", "0.1", "--quantize-bits", "8",
         "--no-stochastic-rounding"], {"quantize": 24, "fused_accum": 3}),
    "secure_q8_topk_deterministic": (
        ["--secure-agg", "--quantize-bits", "8", "--topk-frac", "0.1",
         "--no-stochastic-rounding"], {"secure_commit": 3}),
    "secure_q8_stochastic": (
        ["--secure-agg", "--quantize-bits", "8"], {"secure_commit": 3}),
}
# The Orchestrator run with the fused FedProx update (--algo fedprox): one
# launch per leaf per local step (8 leaves x 5 steps x 3 rounds) and the
# default commit's fused accumulate.
FUSED_UPDATE_ARGS = ["--algo", "fedprox"]
FUSED_UPDATE_EXPECT = {"fedprox_update": 120, "fused_accum": 3}
# The resumed run of check_resume: its one round's default commit.
RESUME_EXPECT = {"fused_accum": 1}
# Phase 3 cases beyond the launcher configurations: (launcher flags,
# FLConfig changes, n_pods, the kernels the card's round must launch).
PARITY_EXTRA = {
    "secure_float": (["--secure-agg"], {}, 1, set()),
    "fedprox_fused_update": (FUSED_UPDATE_ARGS, {"use_fused_update": True}, 1,
                             {"fedprox_update", "fused_accum"}),
    "sequential_fused_update": (
        FUSED_UPDATE_ARGS, {"use_fused_update": True,
                            "client_exec": "sequential"}, 1,
        {"fedprox_update"}),
    "pod_sequential": ([], {"client_exec": "pod_sequential"}, 2,
                       {"fused_accum"}),
}

# The char-LM's main path: the launcher with --dataset shakespeare and the
# CNN runs' pool, clients per round, local steps, batch, rounds and lr, at
# paper-charlm's full width (4 layers, d_model 256, 4 heads, d_ff 1024,
# vocab 128 padded to 256, f32: 3,246,336 params in 11 leaves).  Each
# configuration's launches in 3 rounds: one commit per round, the per-leaf
# kernels once per leaf (11), the FedProx update once per leaf per local
# step (11 x 5 x 3).
LM_ARGS = [a if a != "cifar10" else "shakespeare" for a in MAIN_ARGS]
LM_PARAMS, LM_LEAVES = 3_246_336, 11
LM_BUCKET_ROWS = 12681            # its 11 leaves blocked by 256, one bucket
LM_CONFIGS = {
    "lm_default": ([], {"fused_accum": 3}),
    "lm_q8_topk_deterministic": (
        ["--quantize-bits", "8", "--topk-frac", "0.1",
         "--no-stochastic-rounding"], {"plain_commit": 3}),
    "lm_q8_topk_stochastic": (
        ["--quantize-bits", "8", "--topk-frac", "0.1"],
        {"topk_sparsify": 3 * LM_LEAVES, "fused_accum": 3}),
    "lm_secure_q8_topk_deterministic": (
        ["--secure-agg", "--quantize-bits", "8", "--topk-frac", "0.1",
         "--no-stochastic-rounding"], {"secure_commit": 3}),
}
LM_FUSED_UPDATE_EXPECT = {"fedprox_update": 3 * 5 * LM_LEAVES,
                          "fused_accum": 3}
# Phase 3's char-LM commits (launcher flags, the kernel the card's commit
# must launch).
LM_PARITY = {
    "lm_default": ([], "fused_accum"),
    "lm_q8_topk_deterministic": (LM_CONFIGS["lm_q8_topk_deterministic"][0],
                                 "plain_commit"),
    "lm_secure_q8_topk_deterministic": (
        LM_CONFIGS["lm_secure_q8_topk_deterministic"][0], "secure_commit"),
}
# The commit kernels past their old slot limits (phase 2), as (kernel, K,
# block-rows, the secure commit's coefficients): fused_accum and
# plain_commit past the 12288 slot weights fused_accum stages in shared
# memory; secure_commit past its old 1024 slots, under the upper-triangle
# coefficients (K(K-1)/2 mask words that do not cancel) on one block-row,
# and under the main path's cancelling ones (no mask word left) over
# several, so that each block-row's thresholds have their own place.
SLOT_LIMIT_CASES = (("fused_accum", 12289, 8, None),
                    ("plain_commit", 12289, 8, None),
                    ("secure_commit", 1025, 1, "triu"),
                    ("secure_commit", 1025, 8, "cancel"),
                    ("secure_commit", 4096, 1, "triu"))

# The async path (phase async_path).  A commit buffer of K=8 updates with a
# spread of staleness (the last one 20 commits stale, the default
# max_staleness) and the launcher's default exponent; the launcher's async
# runs at full CIFAR CNN width: the 60-client pool, 16 clients in flight,
# 5 local steps of batch 16, 6 commits (--rounds counts commits), client lr
# 0.01 as in MAIN_ARGS.
ASYNC_K, ASYNC_EXPONENT = 8, 0.5
ASYNC_STALENESS = [0, 1, 2, 3, 0, 5, 1, 20]
ASYNC_ARGS = ["--device", "cuda", "--dataset", "cifar10", "--mode", "async",
              "--clients-pool", "60", "--buffer-k", "8",
              "--max-concurrency", "16", "--local-steps", "5",
              "--batch-size", "16", "--rounds", "6", "--lr", "0.01"]
LM_ASYNC_ARGS = [a if a != "cifar10" else "shakespeare" for a in ASYNC_ARGS]
# the char-LM's async run makes 3 commits (6 before the script neared its
# time limit: ~2.7 s a commit on an H100)
LM_ASYNC_COMMITS = 3
# The async launcher configurations and each one's launches per commit: a
# full buffer under --commit-chunk 4 is two chunks; the adaptive run's
# --commit-timeout T comes from the default run's attempt times, and each
# of its commits, timeout or not, launches the kernel once.
ASYNC_CONFIGS = {
    "async_default": ([], {"fused_accum": 1}),
    "async_q8_topk_deterministic": (CONFIGS["q8_topk_deterministic"][0],
                                    {"plain_commit": 1}),
    "async_secure_q8_topk_deterministic": (
        CONFIGS["secure_q8_topk_deterministic"][0], {"secure_commit": 1}),
    "async_commit_chunk_4": (["--commit-chunk", "4"], {"fused_accum": 2}),
    "async_adaptive_timeout": (["--staleness-exp", "adaptive"],
                               {"fused_accum": 1}),
    "async_batched": (["--engine", "batched"], {"fused_accum": 1}),
}
# Part (a), the commit on the card against the CPU: launcher flags, the
# card's launches, and the live slots (a timeout commit pads the rest).
# q8_topk_stochastic runs topk_sparsify once per leaf (8) before the
# accumulate.
ASYNC_PARITY = {
    "default": ([], {"fused_accum": 1}, ASYNC_K),
    "default, 6 of 8 slots live": ([], {"fused_accum": 1}, 6),
    "q8_topk_deterministic": (CONFIGS["q8_topk_deterministic"][0],
                              {"plain_commit": 1}, ASYNC_K),
    "q8_topk_stochastic": (CONFIGS["q8_topk_stochastic"][0],
                           {"topk_sparsify": 8, "fused_accum": 1}, ASYNC_K),
    "secure_q8_topk_deterministic": (
        CONFIGS["secure_q8_topk_deterministic"][0], {"secure_commit": 1},
        ASYNC_K),
    "secure_q8_topk_deterministic, 6 of 8 slots live": (
        CONFIGS["secure_q8_topk_deterministic"][0], {"secure_commit": 1}, 6),
    "commit_chunk_4": (["--commit-chunk", "4"], {"fused_accum": 2}, ASYNC_K),
}

# The fleet phase (fleet_path), at full CIFAR CNN width.  (a) The window
# engine against the batched one, uncompressed and secure q8 + top-k, one
# commit kernel a commit; (b) --engine auto at a 300-client pool, which
# picks the window engine; (c) a 100,000-client cohort fleet
# (make_mega_fleet over a VirtualFederatedDataset of the 60 CIFAR shards),
# window against batched; (d) one window run on the card against the CPU.
# Each configuration: flags, launches a commit, and the params tolerance
# against the batched engine.  The window engine trains only the buffered
# updates at a commit, so its buckets hold other clients than the batched
# engine's, and on the card the deltas differ in float32 rounding (a
# stacked lane's result depends on the bucket's lane count there, by up to
# 6e-8 in a CIFAR CNN client's delta, ``chip_compare.py --paths``; on the
# CPU it does not, and the tests hold the engines bit for bit).  An uncompressed commit is
# continuous in them: 1e-5.  Under top-k and rounding such a difference
# turns into another kept entry or grid point, and later commits train
# on it, so six compressed commits differ by what those flips add up to
# (7.8e-5 and 2.0e-4 in two runs on an H100): by the "discontinuous
# commits" rule of ROADMAP.md the compressed run's params gap is printed,
# not held (None), while its events, log host fields and launches are;
# its commit is held against the CPU from the same deltas by async_path.
WINDOW_ARGS = ASYNC_ARGS + ["--engine", "window"]
WINDOW_CONFIGS = {
    "window_default": ([], {"fused_accum": 1}, 1e-5),
    "window_secure_q8_topk_deterministic": (
        CONFIGS["secure_q8_topk_deterministic"][0], {"secure_commit": 1},
        None),
}
AUTO_POOL, MEGA_CLIENTS = 300, 100_000
# (e) The hierarchy: 4 facilities of 15 clients from the 60-client pool, 2
# local rounds (or commits) an epoch, 3 tier-2 commits; under the sync
# tier 2 each epoch is one round or commit of every facility, and each
# tier-2 commit takes one slot per facility.  Launches per commit kernel:
# every facility round or commit plus every tier-2 commit.
N_FACILITIES, LOCAL_ROUNDS, T2_COMMITS = 4, 2, 3
# (f)'s 2-facility run on the card against the CPU trains 8 clients a round
# (the main path's 20 before the script neared its time limit: the CPU's
# side took most of the part)
HIER_CPU_CLIENTS = 8
HIER_FLAGS = ["--facilities", str(N_FACILITIES), "--local-rounds",
              str(LOCAL_ROUNDS), "--rounds", str(T2_COMMITS)]
HIER_CONFIGS = {
    "hier_sync_sync": (MAIN_ARGS, [], "fused_accum"),
    "hier_async_async": (ASYNC_ARGS, ["--inter-facility-mode", "async",
                                      "--inter-buffer", "2"], "fused_accum"),
    "hier_sync_sync_secure_q8_topk_deterministic": (
        MAIN_ARGS, CONFIGS["secure_q8_topk_deterministic"][0],
        "secure_commit"),
}

# The LM serving phase.  Jamba-1.5-Large (arXiv:2403.19887) keeps every
# published width (d_model 8192, 64 heads over 8 kv heads, d_ff and
# d_expert 24576, vocab 65536, Mamba d_state 16, expand 2, chunk 128) and is
# cut in two ways to fit one 80 GB card in bf16: depth 72 -> 8, one whole
# period of its block pattern (7 Mamba slots and 1 attention slot, MoE in
# slots 1, 3, 5, 7), and experts 16 -> 8, top-2 kept: a smaller router,
# so the whole cut fits one card with no mesh (the `spmd` phase's (f)
# serves it split over model 2 too).  25,910,730,752 parameters, 51.8 GB
# in bf16.
JAMBA = "jamba-1.5-large-398b"
JAMBA_PARAMS = 25_910_730_752
# 2032 = 15 x 128 + 112 prompt tokens exercise the scan's remainder chunk;
# with 16 decode steps s_max is 2048, so the teacher-forced prefill of all
# 2048 tokens stays on attend_full (attention.attend's threshold).  Batch 2:
# the prefill's transients (a and b of a Mamba layer, [B, 2032, 16384, 16]
# f32 each) grow with the batch, and at batch 2 the peak stays under 72 GB
# (PERF.md); the scan then takes chunk views strided across batch rows.
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 2, 2032, 16
SCAN_SHAPE = (1, 128, 16384, 16)     # the full-width prefill's scan chunk
# Decoding against teacher-forced prefill in bf16, as max |diff| over the
# largest |logit|.  The two paths round at different places (prefill's
# matrix products against decode's matrix-vector products, a causal
# convolution summed term by term against one over a window, one attention
# over the sequence against one over a cache), and bf16 keeps 8
# significant bits: at the largest logits (~4) one ulp is 2^-6 to 2^-5, or
# 0.4-0.8% of the scale, and the gap sums such roundings over 8 layers.
# tests/test_torch_lm.py holds the reduced Jamba in bf16 on the CPU to the
# same bound, and the same comparison in float32 to 1e-4: the bound is
# about bf16 rounding, while a wrong cache or state moves the logits by
# their whole scale.  The cut Llama-3.2-Vision (30 layers, the 1601-patch
# cross cache) and MusicGen-medium (48 layers) are held to it too, with
# the same argmax at each position held.
SERVE_DECODE_TOL = 5e-2

# The LM training phase (lm_train), through build_fl_round_step.  (a) The
# reduced LMs in f32, on the card against the CPU from the same params and
# tokens (check_lm_round_parity): the reduced Jamba (layer 0 Mamba + MLP,
# layer 1 attention + MoE; 64 tokens are 4 scan chunks of 16) in both
# client modes, the reduced Qwen3-MoE in parallel mode (its sort-based
# dispatch under vmap), the reduced xLSTM in parallel mode.
LM_TRAIN_PARITY = ((JAMBA, ("parallel", "sequential")),
                   ("qwen3-moe-235b-a22b", ("parallel",)),
                   ("xlstm-125m", ("parallel",)),
                   ("llama-3.2-vision-90b", ("parallel", "sequential")),
                   ("musicgen-medium", ("parallel",)))
# (b) Jamba-1.5-Large at every published width in its published bf16,
# cut as reduced() cuts the interleave: depth 72 -> 2 with attn_every
# 8 -> 2 and the MoE every 2nd layer (layer 0 the Mamba mixer at d_inner
# 16384, d_state 16, dt_rank 512 with the dense SwiGLU, layer 1 attention
# with 64/8 heads with the MoE), experts 16 -> 2 with top-2 kept:
# 3,457,064,960 params.  Sequential rounds: the f32 running sum, one
# client's params, gradients and delta beside the global params.  1024
# tokens are 8 scan chunks of 128.
JAMBA_TRAIN_PARAMS = 3_457_064_960
JAMBA_TRAIN = dict(rounds=2, C=2, H=2, B=1, S=1024)
JAMBA_TRAIN_CUTS = ("depth 72 -> 2 (attn_every 8 -> 2: [mamba + mlp, attn + "
                    "moe])", "experts 16 -> 2 (top-2 kept)")
# (c) xLSTM-125M (arXiv:2405.04517) whole: 12 blocks, d_model 768, 4
# heads, vocab 50304, bf16, 162,402,096 params; parallel rounds, then
# serving a 512-token prompt at batch 2 with 16 greedy decode steps.
XLSTM = "xlstm-125m"
XLSTM_PARAMS = 162_402_096
# one round of one local step on 128-token sequences (two mLSTM chunks):
# the sLSTM's loop over time is host-bound (0.907 of a local step on an
# H100), and the script's time limit is shared
XLSTM_TRAIN = dict(rounds=1, C=4, H=1, B=4, S=128)
XLSTM_SERVE = dict(batch=2, prompt_len=512, gen=16)
# xLSTM decoding against teacher-forced prefill, held in float32 on the
# bf16 model's weights.  The two paths differ in the last position's form
# (an mLSTM recurrent step against a chunk of one) and, through the GEMMs'
# shapes, in rounding everywhere; 12 recurrent blocks amplify that: in
# float32 the gap is 1.1e-5 on the CPU (7.3e-6 in the reference), while
# in bf16 one-ulp differences grow through the blocks: at this width both
# packages' gaps on the CPU spread over 0.04-0.49 of the logit scale (the
# port's at most 0.340 over 13 inits, tests/test_torch_xlstm_bf16.py).  A
# wrong state moves the logits by their whole scale.  The bf16 gap is held
# to XLSTM_BF16_DECODE_TOL, the port's largest on the CPU: on the card
# with the bf16 GEMMs' split reductions in bf16 (PyTorch's default, which
# main turns off) a decode step and the prefill round apart by 0.19-0.94.
XLSTM_DECODE_TOL = 1e-3
XLSTM_BF16_DECODE_TOL = 0.35

# The VLM and the audio family.  lm_serve (a) holds their reduced LMs
# (the VLM's [attn + mlp, cross + mlp] over 16 patches, the audio LM's 4
# codebooks) on the card against the CPU, as the reduced Jamba.
LM_SERVE_PARITY = (JAMBA, "llama-3.2-vision-90b", "musicgen-medium")
# (b) Llama-3.2-Vision-90B (the config's source: hf:meta-llama/Llama-3.2-
# 11B-Vision, scaled to 90B) at every published width: d_model 8192, 64
# heads / 8 KV of head_dim 128, d_ff 28672, vocab 128256, 1601 image
# patches, rope theta 5e5, bf16.  Cut to one 80 GB card in depth only:
# 27,770,986,496 params, 55.5 GB in bf16.  Batch 2, a 2032-token prompt
# and (2, 1601, 8192) patches, 16 greedy decode steps.  lm_train (e)
# trains its smallest cut that keeps the pattern at every published width:
# one [attn, cross] group (cross_attn_every 5 -> 2, as reduced() cuts it),
# 3,812,663,296 params, in 2 sequential rounds of 2 clients, 2 local
# steps, batch 1 of 1024 tokens with (1, 1601, 8192) patches.
VLM = "llama-3.2-vision-90b"
VLM_SERVE_LAYERS = 30
VLM_SERVE_PARAMS = 27_770_986_496
VLM_SERVE_CUTS = ("depth 100 -> 30 (six whole periods of [attn + mlp x 4, "
                  "cross + mlp]: the share of cross layers kept)",)
VLM_SERVE = dict(batch=2, prompt_len=2032, gen=16)
VLM_TRAIN_PARAMS = 3_812_663_296
VLM_TRAIN = dict(rounds=2, C=2, H=2, B=1, S=1024)
VLM_TRAIN_CUTS = ("depth 100 -> 2 (cross_attn_every 5 -> 2: one [attn + "
                  "mlp, cross + mlp] group)",)
# (c) and lm_train (b): MusicGen-medium (arXiv:2306.05284) whole: 48
# layers, d_model 1536, 24 heads (MHA), d_ff 6144, 4 codebooks of 2048,
# bf16, 1,384,269,312 params.  Serving: batch 2, a 500-frame prompt (10 s
# at EnCodec's 50 Hz) of [2, 500, 4] tokens, 16 greedy decode steps of
# [2, 4] tokens.  Training: 2 parallel rounds of 2 clients, 2 local steps,
# batch 2 x 512 frames x 4 codebooks, the default commit (one fused_accum
# a round).
AUDIO = "musicgen-medium"
AUDIO_PARAMS = 1_384_269_312
AUDIO_SERVE = dict(batch=2, prompt_len=500, gen=16)
AUDIO_TRAIN = dict(rounds=2, C=2, H=2, B=2, S=512)
# MusicGen-medium's parallel round peak without the per-group remat, on an
# H100 80GB HBM3 at 700 W (measured before the remat existed).  Under the
# remat the round's peak lies in the commit, which packs the clients'
# deltas into an f32 stack, not in local training.  So lm_train (d) also
# measures local training alone, with and without the remat, and holds
# the remat's peak below the other.
AUDIO_PEAK_NO_REMAT = 55.02e9

# The mesh phase: the 1x1 test mesh's rounds (a default CIFAR CNN round at
# full width and a reduced-Jamba round, each bit for bit against the same
# round with no mesh), then the dry run of a dense, an MoE and a hybrid
# arch over every input shape on both production meshes (the whole grid
# takes minutes on the host: PERF.md).
MESH_ROUND = dict(C=20, H=2, B=16)
MESH_LM_ROUND = dict(C=4, H=2, B=2, S=64)
DRYRUN_ARCHS = ("granite-3-2b", "qwen3-moe-235b-a22b", JAMBA)

# The CIFAR CNN's leaves other than dense1_w as the per-leaf kernels see
# them, 20 clients blocked by 256 (last dim zero-padded): name, rows, live
# lanes.  q8_topk_stochastic runs topk_sparsify once on each per round.
SMALL_LEAVES = (("conv0_w", 540, 32), ("conv0_b", 20, 32),
                ("conv1_w", 5760, 64), ("conv1_b", 20, 64),
                ("dense1_b", 20, 256), ("dense2_w", 5120, 10),
                ("dense2_b", 20, 10))

SOURCES = {"fused_accum": "commit_kernels.cu",
           "plain_commit": "commit_kernels.cu",
           "quantize": "commit_kernels.cu",
           "topk_sparsify": "commit_kernels.cu",
           "secure_commit": "secure_commit.cu",
           "fedprox_update": "fedprox_update.cu",
           "selective_scan": "selective_scan.cu",
           "selective_scan_bwd": "selective_scan.cu"}


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


# The parts of the phases whose wall seconds main prints (``part NAME: S
# s``), so that a run shows where the script's time limit goes
TIMED_PARTS = (
    "check_round_parity", "check_lm_round_parity", "drive_configs",
    "check_resume", "check_worker", "check_async_commit_parity",
    "drive_async", "check_async_resume", "drive_window", "check_auto",
    "check_mega", "check_window_card_cpu", "drive_hier", "check_hier_resume",
    "check_lm_parity", "serve_full_width", "serve_family", "serve_cli",
    "train_jamba_full_width", "xlstm_whole", "slstm_share",
    "train_audio_whole", "train_vlm_full_width", "mesh_rounds_1x1",
    "finish_dry_run", "spmd_reference", "model_reference", "spmd_nccl",
    "granite_no_mesh", "serve_no_mesh", "time_rank_chunk")


def time_parts(names=TIMED_PARTS) -> None:
    """Wrap each of the module's functions ``names`` so that a call prints
    its wall seconds."""
    for name in names:
        fn = globals()[name]

        @functools.wraps(fn)
        def timed(*args, _fn=fn, _name=name, **kw):
            t0 = time.perf_counter()
            try:
                return _fn(*args, **kw)
            finally:
                print(f"part {_name}: {time.perf_counter() - t0:.1f} s",
                      flush=True)

        globals()[name] = timed


def memory_rate(name: str) -> float:
    """HBM bytes/s of the card, from its name (NVIDIA data sheets)."""
    if "H200" in name:
        return 4.8e12
    if "H100" in name and "PCIe" in name:
        return 2.0e12
    if "H100" in name and "NVL" in name:
        return 3.9e12
    return 3.35e12                     # H100 SXM


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(out.returncode == 0 and out.stdout.strip(),
          f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def mask_words(seeds, coef) -> int:
    """PRF mask words per output element that the secure commit's data
    needs.  A word depends only on its seed, so entries sharing a seed (both
    slots of a pair, under symmetric seeds) need one word with their
    coefficients summed, and a seed whose coefficients sum to 0 mod 2^32
    needs none."""
    s = seeds.flatten().cpu().to(torch.int64)
    c = coef.flatten().cpu().to(torch.int64)
    uniq, inv = torch.unique(s, return_inverse=True)
    total = torch.zeros(len(uniq), dtype=torch.int64).index_add_(0, inv, c)
    return int(((total & 0xFFFFFFFF) != 0).sum())


def bound(nbytes, ops, int_ops, rate):
    """The least time in ms and what bounds it: bytes over the memory rate,
    or f32 and integer operations over their peaks."""
    bytes_s = nbytes / rate
    ops_s = max(ops / F32_PEAK, int_ops / INT32_PEAK)
    return (max(bytes_s, ops_s) * 1e3,
            "bytes" if bytes_s >= ops_s else "operations")


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def time_ms(fn, reps=30, warmup=3) -> float:
    """Median device time of one call, from CUDA events around each call."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def time_ms_queued(fn, reps=30, warmup=3) -> float:
    """Device time of one call from one pair of CUDA events around ``reps``
    back-to-back calls: while the host enqueues faster than the card runs,
    the host's launch latency, which ``time_ms`` counts once per call,
    falls out."""
    for _ in range(warmup):
        fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


# ---------------------------------------------------------------- phase 1
def build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    _build.build_all()
    for name in _build.LIBRARIES:
        _build.library(name)
    seconds = time.perf_counter() - t0
    print(f"build: {seconds:.2f} s (nvcc {_build.BUILD_SECONDS})")
    for name in _build.LIBRARIES:
        report = ptxas_report(_build.BUILD_LOG.get(name, ""))
        print(f"  {name}: ptxas: {report}")
    return seconds


def kernel_name(mangled: str) -> str:
    """A kernel's name and integer template argument from its mangled
    name: ``_ZN<n>_GLOBAL__N_<file>20secure_commit_kernelILi2EE...`` ->
    ``secure_commit_kernel<2>`` (the last name of a nested name)."""
    if not mangled.startswith("_Z"):
        return mangled
    rest, names = mangled[3:] if mangled.startswith("_ZN") else mangled[2:], []
    while size := re.match(r"\d+", rest):
        n = int(size.group())
        names.append(rest[size.end():size.end() + n])
        rest = rest[size.end() + n:]
    if not names:
        return mangled
    arg = re.match(r"ILi(\d+)E", rest)
    return names[-1] + (f"<{arg.group(1)}>" if arg else "")


def ptxas_report(log: str) -> str:
    """Each entry function's registers, and its spills where it has any,
    from nvcc's ``-Xptxas -v`` output."""
    out, fn = [], "?"
    for line in log.splitlines():
        if "Compiling entry function" in line:
            fn = kernel_name(line.split("'")[1])
        elif "spill" in line and " 0 bytes spill stores" not in line:
            out.append(f"{fn} spills ({line.strip()})")
        elif "Used" in line and "registers" in line:
            out.append(f"{fn} {line.split('Used')[1].split(',')[0].strip()}")
    return "; ".join(out) or "(already built)"


# ---------------------------------------------------------------- phase 2
def assert_quantized_close(got, want, step, what):
    """Equal up to float32 noise, or at most one quantization step on rare
    half-way rounding flips (tests/test_kernels.py's contract)."""
    diff = (got - want).abs()
    close = diff <= 1e-5 * want.abs() + 1e-6
    check(bool((close | (diff <= step * 1.001)).all()),
          f"{what}: differs from its plain version by more than one step")
    check(close.float().mean().item() >= 0.99,
          f"{what}: too many rounding flips")


def parts(x):
    return x if isinstance(x, tuple) else (x,)


def secure_pairs(k_slots, seed, device, out=(3,)):
    """The main path's pair seeds and cancelling coefficients for
    ``k_slots`` slots with the slots ``out`` cut, and the participation."""
    ids = torch.arange(k_slots, dtype=torch.int32)
    part = torch.ones(k_slots)
    part[list(out)] = 0.0
    return (sec.pair_seeds(sec.commit_key(seed), ids).to(device),
            sec.pair_coef_int(ids, part).to(device), part.to(device))


def exact_one(name):
    """A compare that holds a kernel's outputs equal to its plain
    version's."""
    return lambda g, p: check(
        all(torch.equal(x, y) for x, y in zip(parts(g), parts(p))),
        f"{name}: differs from its plain version")


def kernel_specs(device, k_slots=K_SLOTS, rows=BUCKET_ROWS,
                 leaf_rows=LEAF_ROWS, block=BLOCK, leaf_params=DENSE1_W,
                 scan_shape=SCAN_SHAPE, seed=0):
    """Inputs made from a seed at the main path's shapes, and for each
    kernel: its wrapper, its plain version, the library call computing the
    same function (or None), extra cases (label, kernel, plain, bytes,
    f32 operations, integer operations) held and timed beside the main one,
    the bytes it must move, the f32 operations it does and the integer
    operations its data needs."""
    exact = exact_one
    gen = torch.Generator(device=device).manual_seed(seed)
    xb = torch.randn(k_slots, rows, block, generator=gen, device=device) * 0.01
    w = torch.rand(k_slots, generator=gen, device=device) * 1.5 + 0.5
    s = torch.zeros(k_slots, device=device)       # a sync commit: no staleness
    leaf = torch.randn(leaf_rows, block, generator=gen, device=device) * 0.01
    n_stack, n_out, n_leaf = xb.numel(), rows * block, leaf.numel()
    w_eff = ref.slot_weights(w, s, 0.0)
    step_commit = (w_eff.max() * xb.abs().max() / 127).item()

    def accum_case(K, shape_rows, shape_block):
        """The fused accumulate on a [K, shape_rows, shape_block] stack."""
        x = torch.randn(K, shape_rows, shape_block, generator=gen,
                        device=device) * 0.01
        wk = torch.rand(K, generator=gen, device=device) * 1.5 + 0.5
        sk = torch.rand(K, generator=gen, device=device) * 4.0   # staleness
        return (f"K={K}, block {shape_block}",
                lambda: fused_accum_blocks(x, wk, sk, 0.5),
                lambda: ref.fused_accum_ref(x, wk[:, None], sk[:, None], 0.5),
                4 * (x.numel() + 2 * K + shape_rows * shape_block),
                2 * x.numel(), 0)

    # secure commit: one straggler out, as on the main path; the reference
    # coefficients cancel, the upper triangle alone does not
    seeds, coef, part = secure_pairs(k_slots, seed, device)
    upper = torch.triu(torch.ones(k_slots, k_slots, dtype=torch.int32),
                       1).to(device)
    w_sec = (w * part).contiguous()

    def secure_case(label, x, wv, sd, c, *, bits=8, k=TOPK_K, noise=None,
                    table=None):
        """(label, kernel, plain, bytes, f32 operations, integer operations)
        of the secure commit on the stack ``x`` (``table``: its rows'
        global block-rows)."""
        K, R, B = x.shape
        nbytes = (4 * (x.numel() * (1 if noise is None else 2) + K + R * B)
                  + 8 * K * K + (0 if table is None else 4 * R))
        return (label,
                lambda: secure_commit_blocks(x, wv, sd, c, 0, bits=bits, k=k,
                                             noise=noise, rows=table),
                lambda: ref.fused_secure_commit_ref(x, wv[:, None], sd, c, 0,
                                                    bits, k=k, noise=noise,
                                                    rows=table),
                nbytes, 7 * x.numel(),
                SELECT_INT_OPS * x.numel()
                + OPS_PER_MASK_WORD * R * B * mask_words(sd, c))

    def secure_extras():
        """The secure commit's extra cases, each bit for bit."""
        k64 = 64
        x64 = torch.randn(k64, rows, block, generator=gen, device=device) * 0.01
        s64, c64, p64 = secure_pairs(k64, seed + 1, device, out=(3, 40))
        w64 = (torch.rand(k64, generator=gen, device=device) + 0.5) * p64
        asym = torch.randint(0, 2 ** 32, (k_slots, k_slots), generator=gen,
                             device=device, dtype=torch.int64)
        rand_coef = torch.randint(-1, 2, (k_slots, k_slots), generator=gen,
                                  device=device, dtype=torch.int32)
        noise = torch.rand(xb.shape, generator=gen, device=device)
        _, c_all, _ = secure_pairs(k_slots, seed, device, out=())
        w_zero = w.clone()
        w_zero[0] = 0.0
        # few distinct magnitudes (ties across the k-th largest) and rows
        # that are zero in every slot (a zero scale)
        ties = torch.round(xb * 200) / 200
        ties[:, :8] = 0.0
        # a share's rows of a bucket twice as long, in no affine order,
        # from a generator of their own
        table = torch.randperm(2 * rows, generator=torch.Generator(
            device=device).manual_seed(seed + 2), device=device)[:rows]
        return [
            secure_case("upper-triangle coefficients", xb, w_sec, seeds,
                        upper),
            secure_case("upper-triangle coefficients, a row table of "
                        f"{rows} of {2 * rows} rows", xb, w_sec, seeds,
                        upper, table=table),
            secure_case(f"K={k64}, past the register path", x64, w64, s64,
                        c64),
            secure_case("random coefficients, asymmetric seeds", xb, w_sec,
                        asym, rand_coef),
            secure_case("4 bits", xb, w_sec, seeds, coef, bits=4),
            secure_case("k=0 with a noise operand", xb, w_sec, seeds, coef,
                        k=0, noise=noise),
            secure_case("a zero-weight slot that still masks", xb, w_zero,
                        seeds, c_all),
            secure_case("ties and zero rows", ties, w_sec, seeds, coef)]
    # plain_commit and topk_sparsify: their extra cases draw from a
    # generator of their own, so every other case keeps its inputs
    g2 = torch.Generator(device=device).manual_seed(seed + 1)

    def plain_case(label, x, wv, *, bits=8, k=TOPK_K, exact=False, sk=None,
                   alpha=0.0):
        """The plain commit on the stack ``x`` (staleness ``sk``, exponent
        ``alpha``), by assert_quantized_close (or torch.equal where
        ``exact``)."""
        K, R, B = x.shape
        sk = torch.zeros(K, device=device) if sk is None else sk
        q = 2 ** (bits - 1) - 1 if bits else 1
        step = (ref.slot_weights(wv, sk, alpha).max() * x.abs().max()
                / q).item()
        compare = (exact_one("plain_commit") if exact else
                   lambda g, p: assert_quantized_close(
                       g, p, step, f"plain_commit ({label})"))
        return (label,
                lambda: plain_commit_blocks(x, wv, sk, alpha, bits=bits,
                                            k=k),
                lambda: ref.fused_plain_commit_ref(
                    x, wv[:, None], sk[:, None], alpha, bits, k=k),
                4 * (x.numel() + 2 * K + R * B), 7 * x.numel(),
                SELECT_INT_OPS * x.numel(), compare)

    def half_way(R, B):
        """One slot whose entries' quotients by their row's scale (row max
        / 127, not a power of two) lie on half-integers or one ulp off: the
        quantize's reciprocal product must fall back to the division there
        and agree with it exactly."""
        m = torch.rand(1, R, 1, generator=g2, device=device) * 0.1 + 0.9
        scale = m / torch.full_like(m, 127.0)
        n = torch.randint(-127, 127, (1, R, B), generator=g2, device=device)
        x = (n.float() + 0.5) * scale
        nudge = torch.randint(0, 3, x.shape, generator=g2, device=device)
        x = torch.where(nudge == 1, torch.nextafter(x, x * 2), x)
        x = torch.where(nudge == 2, torch.nextafter(x, torch.zeros_like(x)),
                        x)
        x[..., :1] = m
        return x

    def plain_extras():
        x1 = torch.randn(1, rows, block, generator=g2, device=device) * 0.01
        x64 = torch.randn(64, rows, block, generator=g2,
                          device=device) * 0.01
        w64 = torch.rand(64, generator=g2, device=device) * 1.5 + 0.5
        w_zero = w.clone()
        w_zero[0] = 0.0
        ties = torch.round(xb * 200) / 200
        ties[:, :8] = 0.0
        one = torch.ones(1, device=device)
        cases = [
            plain_case("K=1", x1, one[:1] * 1.25),
            plain_case("K=64, past the staged slots (32 at block 256)",
                       x64, w64),
            plain_case("bits=0 with top-k", xb, w, bits=0),
            plain_case("k=0 with 8 bits", xb, w, k=0),
            plain_case("k=0, bits=0: staging and the slot sum alone", xb, w,
                       bits=0, k=0),
            plain_case("4 bits", xb, w, bits=4),
            plain_case("a zero-weight slot", xb, w_zero),
            plain_case("ties and zero rows", ties, w),
            plain_case("half-way quotients, K=1", half_way(rows, block), one,
                       k=0, exact=True)]
        for b in (128, 1024):
            xr = torch.randn(k_slots, -(-rows * block // b), b, generator=g2,
                             device=device) * 0.01
            cases.append(plain_case(f"block {b}", xr, w,
                                    k=math.ceil(0.1 * b)))
        return cases

    def topk_case(label, x, k):
        return (label, lambda: topk_sparsify_blocks(x, k),
                lambda: ref.topk_blocks(x, k), 4 * 2 * x.numel(), 0,
                3 * x.numel())

    def padded_leaf(R, live):
        x = torch.zeros(R, block, device=device)
        x[:, :live] = torch.randn(R, live, generator=g2,
                                  device=device) * 0.01
        return x

    def topk_extras():
        ties = torch.round(leaf * 200) / 200
        ties[::7] = 0.0                                   # all-zero rows
        cases = [topk_case("k=1", leaf, 1),
                 topk_case(f"k={block}", leaf, block),
                 topk_case("ties across the k-th value, all-zero rows",
                           ties, TOPK_K),
                 topk_case("subnormals", leaf * 1e-36, TOPK_K),
                 topk_case("one exponent", torch.sign(leaf)
                           * (1.0 + leaf.abs() * 30), TOPK_K)]
        for b in (128, 512, 1024):
            cases.append(topk_case(f"block {b}", leaf.reshape(-1, b),
                                   math.ceil(0.1 * b)))
        for name, R, live in SMALL_LEAVES:
            R = max(1, leaf_rows * R // LEAF_ROWS)
            cases.append(topk_case(f"{name} [{R}, {block}], {live} live "
                                   "lanes", padded_leaf(R, live), TOPK_K))
        return cases

    # the char-LM's commit bucket, from a generator of its own
    g3 = torch.Generator(device=device).manual_seed(seed + 2)
    lm_rows = max(1, LM_BUCKET_ROWS * rows // BUCKET_ROWS)
    xlm = torch.randn(k_slots, lm_rows, block, generator=g3,
                      device=device) * 0.01
    lm_label = f"the char-LM's bucket [{k_slots}, {lm_rows}, {block}]"
    # the async commit buffer: the first K=8 slots of the main stack and of
    # the char-LM's bucket, discounted by the async phase's staleness
    ka = min(ASYNC_K, k_slots)
    x_async, xlm_async, w_async = xb[:ka], xlm[:ka], w[:ka]
    s_async = torch.tensor(ASYNC_STALENESS[:ka], dtype=torch.float32,
                           device=device)

    # the one PyTorch call computing the fused accumulate at a shape: an
    # einsum over the discounted slot weights, keyed by the case's label
    accum_library = {}

    def async_accum(label, x):
        label = (f"{label} [{ka}, {x.shape[1]}, {block}], staleness "
                 f"{ASYNC_STALENESS[:ka]}, exponent {ASYNC_EXPONENT}")
        w_lib = ref.slot_weights(w_async, s_async, ASYNC_EXPONENT)
        accum_library[label] = lambda: torch.einsum("k,krb->rb", w_lib, x)
        return (label,
                lambda: fused_accum_blocks(x, w_async, s_async,
                                           ASYNC_EXPONENT),
                lambda: ref.fused_accum_ref(x, w_async[:, None],
                                            s_async[:, None], ASYNC_EXPONENT),
                4 * (x.numel() + 2 * ka + x.shape[1] * block),
                2 * x.numel(), 0)

    # the hierarchy's tier-2 commit: one slot per facility delta, the
    # first slots of the main stack; 4 facilities under the sync tier 2
    # (staleness 0), and the async tier 2's --inter-buffer 1 (the default)
    # and 2 at a staleness of one tier-2 commit
    def tier2_accum(K, stale):
        sk = torch.full((K,), float(stale), device=device)
        x, wk = xb[:K], w[:K]
        label = (f"the tier-2 commit [{K}, {rows}, {block}], staleness "
                 f"{stale}, exponent {ASYNC_EXPONENT}")
        w_lib = ref.slot_weights(wk, sk, ASYNC_EXPONENT)
        accum_library[label] = lambda: torch.einsum("k,krb->rb", w_lib, x)
        return (label,
                lambda: fused_accum_blocks(x, wk, sk, ASYNC_EXPONENT),
                lambda: ref.fused_accum_ref(x, wk[:, None], sk[:, None],
                                            ASYNC_EXPONENT),
                4 * (x.numel() + 2 * K + rows * block), 2 * x.numel(), 0)

    kt = min(N_FACILITIES, k_slots)
    t2_seeds, t2_coef, t2_part = secure_pairs(kt, seed, device, out=())
    t2_secure = secure_case(
        f"the tier-2 commit of {kt} facilities [{kt}, {rows}, {block}]",
        xb[:kt], (w[:kt] * t2_part).contiguous(), t2_seeds, t2_coef)

    # FedProx update: 20 clients' copies of dense1_w against the global one
    wc = torch.randn(k_slots, leaf_params, generator=gen, device=device)
    gc = torch.randn(k_slots, leaf_params, generator=gen, device=device)
    w0 = torch.randn(leaf_params, generator=gen, device=device)
    n_clients = wc.numel()
    # selective scan: decays in (0.3, 1) as exp(dt * A) gives them; the
    # main-path chunk, and a chunk view of a batch-2 sequence (strided
    # across batch rows, as the Mamba block hands it over)
    B, L, D, N = scan_shape
    sa = torch.rand(scan_shape, generator=gen, device=device) * 0.7 + 0.3
    sb = torch.randn(scan_shape, generator=gen, device=device) * 0.1
    sh0 = torch.randn((B, D, N), generator=gen, device=device)
    wa = torch.rand((2, 2 * L, D, N), generator=gen, device=device) * 0.7 + 0.3
    wb = torch.randn((2, 2 * L, D, N), generator=gen, device=device) * 0.1
    wh0 = torch.randn((2, D, N), generator=gen, device=device)
    va, vb = wa[:, L:], wb[:, L:]
    scan_bytes = lambda b: 4 * (3 * b * L * D * N + 2 * b * D * N)
    # the scan's backward at the same chunk, from the forward's states and
    # random cotangents of hs and h_last; the strided batch-2 chunk view;
    # and no gradient of the last state, as a zero g_hl and as none (the
    # last chunk of a training sequence)
    shs = ref.selective_scan_chunk_ref(sa, sb, sh0)[0]
    sg = torch.randn(scan_shape, generator=gen, device=device)
    sgl = torch.randn((B, D, N), generator=gen, device=device)
    whs = torch.randn((2, 2 * L, D, N), generator=gen, device=device)
    wg = torch.randn((2, 2 * L, D, N), generator=gen, device=device)
    wgl = torch.randn((2, D, N), generator=gen, device=device)
    vhs, vg = whs[:, L:], wg[:, L:]
    zgl = torch.zeros_like(sgl)
    # a, hs and g_hs read, ga and gb written, per element; h0 read, gh0
    # written and g_hl read per lane
    bwd_bytes = lambda b, lanes=3: 4 * (5 * b * L * D * N + lanes * b * D * N)

    def bwd_case(label, args, b, lanes=3):
        return (label, lambda: selective_scan_chunk_bwd_blocks(*args),
                lambda: ref.selective_scan_chunk_bwd_ref(*args),
                bwd_bytes(b, lanes), 3 * b * L * D * N, 0)
    main_secure = secure_case("main", xb, w_sec, seeds, coef)

    return {
        "fused_accum": dict(
            replaces="src/repro/kernels/fused_accum.py:33",
            kernel=lambda: fused_accum_blocks(xb, w, s, 0.0),
            plain=lambda: ref.fused_accum_ref(xb, w[:, None], s[:, None], 0.0),
            library=lambda: torch.einsum("k,krb->rb", w_eff, xb),
            extra=[accum_case(K, rows, block) for K in (1, 3, 64)]
            + [accum_case(k_slots, -(-rows * block // b), b)
               for b in (128, 1024)]
            + [(lm_label, lambda: fused_accum_blocks(xlm, w, s, 0.0),
                lambda: ref.fused_accum_ref(xlm, w[:, None], s[:, None],
                                            0.0),
                4 * (xlm.numel() + 2 * k_slots + lm_rows * block),
                2 * xlm.numel(), 0),
               async_accum("the async buffer", x_async),
               async_accum("the char-LM's async buffer", xlm_async),
               tier2_accum(kt, 0), tier2_accum(1, 1), tier2_accum(2, 1)],
            extra_library=accum_library,
            compare=lambda g, p: check(
                torch.allclose(g, p, rtol=FUSED_ACCUM_TOL[0],
                               atol=FUSED_ACCUM_TOL[1]),
                "fused_accum: differs from its plain version"),
            bytes=4 * (n_stack + 2 * k_slots + n_out),
            ops=2 * n_stack),
        "plain_commit": dict(
            replaces="src/repro/kernels/fused_quant_mask.py:154",
            kernel=lambda: plain_commit_blocks(xb, w, s, 0.0, bits=8,
                                               k=TOPK_K),
            plain=lambda: ref.fused_plain_commit_ref(
                xb, w[:, None], s[:, None], 0.0, 8, k=TOPK_K),
            library=None,
            extra=plain_extras() + [
                plain_case(lm_label, xlm, w),
                plain_case(f"the async buffer [{ka}, {rows}, {block}], "
                           f"staleness {ASYNC_STALENESS[:ka]}, exponent "
                           f"{ASYNC_EXPONENT}", x_async, w_async,
                           sk=s_async, alpha=ASYNC_EXPONENT)],
            compare=lambda g, p: assert_quantized_close(
                g, p, step_commit, "plain_commit"),
            bytes=4 * (n_stack + 2 * k_slots + n_out),
            # per element: divide, round, two clamps, multiply and the
            # weighted multiply-add in f32; the select's integer work
            ops=7 * n_stack, int_ops=SELECT_INT_OPS * n_stack),
        "quantize": dict(
            replaces="src/repro/kernels/quantize.py:32",
            kernel=lambda: quantize_dequant_blocks(leaf, 8),
            plain=lambda: ref.quantize_blocks(leaf, 8),
            library=None,
            compare=lambda g, p: assert_quantized_close(
                g, p, (leaf.abs().max() / 127).item(), "quantize"),
            bytes=4 * 2 * n_leaf,
            ops=7 * n_leaf),
        "topk_sparsify": dict(
            replaces="src/repro/kernels/topk_sparsify.py:46",
            kernel=lambda: topk_sparsify_blocks(leaf, TOPK_K),
            plain=lambda: ref.topk_blocks(leaf, TOPK_K),
            library=None,
            extra=topk_extras(),
            compare=lambda g, p: check(
                torch.equal(g, p), "topk_sparsify: threshold differs from "
                                   "the sort threshold"),
            bytes=4 * 2 * n_leaf,
            # per element: |x|, its share of the selection (one comparison)
            # and the keep test, in integers
            ops=0, int_ops=3 * n_leaf),
        "secure_commit": dict(
            replaces="src/repro/kernels/fused_quant_mask.py:179",
            kernel=main_secure[1],
            plain=main_secure[2],
            library=None,
            extra=secure_extras() + [secure_case(lm_label, xlm, w_sec, seeds,
                                                 coef), t2_secure],
            compare=exact("secure_commit"),
            # the top-k select, weighting, quantize and rounding as in
            # plain_commit; the PRF words this data needs per output element
            # (none where every pair's coefficients cancel)
            bytes=main_secure[3], ops=main_secure[4],
            int_ops=main_secure[5]),
        "fedprox_update": dict(
            replaces="src/repro/kernels/fedprox_update.py:29",
            kernel=lambda: fedprox_update_flat(wc, gc, w0, 0.01, 0.02),
            plain=lambda: ref.fedprox_update_ref(wc, gc, w0[None], 0.01,
                                                 0.02),
            library=None,
            compare=exact("fedprox_update"),
            bytes=4 * (3 * n_clients + leaf_params),
            ops=5 * n_clients),
        "selective_scan": dict(
            replaces="src/repro/kernels/selective_scan.py:37",
            kernel=lambda: selective_scan_chunk_blocks(sa, sb, sh0),
            plain=lambda: ref.selective_scan_chunk_ref(sa, sb, sh0),
            library=None,
            extra=[("strided batch-2 chunk view",
                    lambda: selective_scan_chunk_blocks(va, vb, wh0),
                    lambda: ref.selective_scan_chunk_ref(va, vb, wh0),
                    scan_bytes(2), 2 * va.numel(), 0)],
            compare=exact("selective_scan"),
            # a and b read, hs written, h0 read and h_last written once;
            # one multiply and one add per element
            bytes=scan_bytes(B),
            ops=2 * sa.numel()),
        "selective_scan_bwd": dict(
            replaces="src/repro/kernels/ops.py:476",
            kernel=lambda: selective_scan_chunk_bwd_blocks(sa, shs, sh0, sg,
                                                           sgl),
            plain=lambda: ref.selective_scan_chunk_bwd_ref(sa, shs, sh0, sg,
                                                           sgl),
            library=None,
            extra=[bwd_case("strided batch-2 chunk view",
                            (va, vhs, wh0, vg, wgl), 2),
                   bwd_case("g_hl = 0", (sa, shs, sh0, sg, zgl), B),
                   bwd_case("no g_hl", (sa, shs, sh0, sg, None), B, 2)],
            compare=exact("selective_scan_bwd"),
            # the reverse recurrence's multiply and add, and ga's multiply
            bytes=bwd_bytes(B),
            ops=3 * sa.numel()),
    }


def check_fold(device="cuda", k_slots=K_SLOTS, seed=0):
    """The secure commit's prologue, which folds the [K, K] pair seeds and
    coefficients into the mask words that do not cancel, run alone on the
    card against ``ref.fold_mask_words``: the same words (as multisets) and
    the same mask total over the first rows, bit for bit; the main path's
    coefficients fold to no word, the upper triangle to K(K-1)/2."""
    exact = exact_one
    gen = torch.Generator(device=device).manual_seed(seed)
    seeds, coef, _ = secure_pairs(k_slots, seed, device)
    upper = torch.triu(torch.ones_like(coef), 1)
    shared = seeds.clone()               # two pairs that share one seed
    shared[0, 1] = shared[1, 0] = shared[2, 3] = shared[3, 2] = 12345
    n_pairs = k_slots * (k_slots - 1) // 2
    cases = {
        "main": (seeds, coef, 0),
        "upper": (seeds, upper, n_pairs),
        "upper, two pairs share a seed": (shared, upper, n_pairs),
        "random, asymmetric seeds": (
            torch.randint(0, 2 ** 32, seeds.shape, generator=gen,
                          device=device, dtype=torch.int64),
            torch.randint(-1, 2, coef.shape, generator=gen, device=device,
                          dtype=torch.int32), None)}
    idx = torch.arange(4 * BLOCK, dtype=torch.int64).reshape(4, BLOCK)
    for label, (sd, c, expect) in cases.items():
        got = [t.cpu() for t in fold_mask_words(sd, c)]
        want = ref.fold_mask_words(sd.cpu(), c.cpu())
        same = sorted(zip(*(t.tolist() for t in got))) == sorted(
            zip(*(t.tolist() for t in want)))
        check(same and torch.equal(ref.mask_total_u32(*got, idx),
                                   ref.mask_total_u32(*want, idx)),
              f"secure_fold ({label}): differs from its plain version")
        check(expect is None or len(got[0]) == expect,
              f"secure_fold ({label}): {len(got[0])} words, expected {expect}")
        print(f"secure_fold ({label}): {len(got[0])} words, equal to its "
              f"plain version")


def exact_slots(K, R, device, seed):
    """A [K, R, 256] stack, weights and staleness on which any slot order
    sums exactly, so a kernel equals its plain version bit for bit: every
    row holds integers over 128 with one entry at 127/128 (a quantize scale
    of exactly 1/128, q = the integer), the discounted weights are 1, 1/2
    or 1/4 (w in {1/2, 1}, s in {0, 1}, exponent 1), and every partial sum
    is a multiple of 2^-9 below 2^14, inside float32's 24 bits."""
    g = torch.Generator(device=device).manual_seed(seed)
    n = torch.randint(-127, 128, (K, R, BLOCK), generator=g, device=device)
    n[..., 0] = 127
    x = n.float() / 128
    w = torch.randint(1, 3, (K,), generator=g, device=device).float() / 2
    s = torch.randint(0, 2, (K,), generator=g, device=device).float()
    return x, w, s


def check_slot_limits(device="cuda", cases=SLOT_LIMIT_CASES, seed=5):
    """The commit kernels past their old slot limits, each held bit for bit
    (max_abs_err 0) against its plain version and timed (a few calls: the
    secure cases' mask words make each call long)."""
    timed = torch.device(device).type == "cuda"
    rate = memory_rate(torch.cuda.get_device_name(0) if timed else "")
    out = {}
    for kname, K, rows, coefs in cases:
        if kname == "secure_commit":
            g = torch.Generator(device=device).manual_seed(seed + K)
            x = torch.randn(K, rows, BLOCK, generator=g, device=device) * 0.01
            wv = torch.rand(K, generator=g, device=device) + 0.5
            if coefs == "triu":
                sd = sec.pair_seeds(sec.commit_key(seed), torch.arange(
                    K, dtype=torch.int32)).to(device)
                c = torch.triu(torch.ones(K, K, dtype=torch.int32),
                               1).to(device)
            else:
                sd, c, _ = secure_pairs(K, seed, device)
            kernel = lambda: secure_commit_blocks(x, wv, sd, c, 0, bits=8,
                                                  k=TOPK_K)
            plain = lambda: ref.fused_secure_commit_ref(x, wv[:, None], sd, c,
                                                        0, 8, k=TOPK_K)
            nbytes = 4 * (x.numel() + K + rows * BLOCK) + 8 * K * K
            ops = 7 * x.numel()
            int_ops = (SELECT_INT_OPS * x.numel()
                       + OPS_PER_MASK_WORD * rows * BLOCK
                       * mask_words(sd, c))
        else:
            x, wv, sv = exact_slots(K, rows, device, seed)
            if kname == "fused_accum":
                kernel = lambda: fused_accum_blocks(x, wv, sv, 1.0)
                plain = lambda: ref.fused_accum_ref(x, wv[:, None],
                                                    sv[:, None], 1.0)
                ops, int_ops = 2 * x.numel(), 0
            else:
                kernel = lambda: plain_commit_blocks(x, wv, sv, 1.0, bits=8,
                                                     k=TOPK_K)
                plain = lambda: ref.fused_plain_commit_ref(
                    x, wv[:, None], sv[:, None], 1.0, 8, k=TOPK_K)
                ops, int_ops = 7 * x.numel(), SELECT_INT_OPS * x.numel()
            nbytes = 4 * (x.numel() + 2 * K + rows * BLOCK)
        got, want = kernel(), plain()
        sync(device)
        err = (got - want).abs().max().item()
        check(torch.equal(got, want), f"{kname} at K={K}: differs from its "
                                      f"plain version by {err:.3g}")
        del got, want
        row = dict(K=K, rows=rows, max_abs_err=err)
        if coefs:
            row["coefficients"] = coefs
        row["bound_ms"], row["bound_by"] = bound(nbytes, ops, int_ops, rate)
        if timed:
            row["ms"] = time_ms(kernel, reps=3, warmup=1)
            row["queued_ms"] = time_ms_queued(kernel, reps=3, warmup=0)
        print(f"kernel {kname} past its old slot limit: "
              + " ".join(f"{k}={v}" for k, v in row.items()))
        out[f"{kname} K={K} rows={rows}"] = row
        del x
    sync(device)
    return out


def check_scan_vmap(device="cuda", scan_shape=SCAN_SHAPE, C=2, seed=2):
    """The scan and its backward under ``vmap`` as the parallel round runs
    them, C clients folded into the batch dim by the vmap rules of
    ``kernels/ops.py``: the forward's states, and the gradients of a, b
    and h0 under ``vmap(grad)``, bit for bit against C unvmapped calls."""
    from torch.func import grad, vmap
    gen = torch.Generator(device=device).manual_seed(seed)
    B, L, D, N = scan_shape
    a = torch.rand((C, *scan_shape), generator=gen, device=device) * 0.7 + 0.3
    b = torch.randn((C, *scan_shape), generator=gen, device=device) * 0.1
    h0 = torch.randn((C, B, D, N), generator=gen, device=device)
    w = torch.randn(scan_shape, generator=gen, device=device)
    wl = torch.randn((B, D, N), generator=gen, device=device)

    def loss(a, b, h0):
        hs, hl = kops.selective_scan_chunk(a, b, h0)
        return (hs * w).sum() + (hl * wl).sum()

    g = grad(loss, argnums=(0, 1, 2))
    got = vmap(kops.selective_scan_chunk)(a, b, h0) + vmap(g)(a, b, h0)
    each = [kops.selective_scan_chunk(a[c], b[c], h0[c]) + g(a[c], b[c],
                                                             h0[c])
            for c in range(C)]
    sync(device)
    for i, name in enumerate(("hs", "h_last", "ga", "gb", "gh0")):
        check(torch.equal(got[i], torch.stack([x[i] for x in each])),
              f"selective scan under vmap: {name} differs from {C} "
              f"unvmapped calls")
    print(f"selective scan under vmap, {C} clients folded into the batch of "
          f"{list(scan_shape)}: forward and vmap(grad) equal to {C} "
          f"unvmapped calls")


def check_kernels(device="cuda", **shapes):
    """Phase 2: each kernel against its plain version, and on the card its
    times; the scan pair under vmap; the secure fold and the commit kernels
    past their old slot limits."""
    timed = torch.device(device).type == "cuda"
    rate = memory_rate(torch.cuda.get_device_name(0) if timed else "")
    check_fold(device, shapes.get("k_slots", K_SLOTS))
    check_scan_vmap(device, shapes.get("scan_shape", SCAN_SHAPE))
    check_slot_limits(device, **({} if timed else dict(
        cases=tuple((kname, K, 1, coefs)
                    for kname, K, _, coefs in SLOT_LIMIT_CASES
                    if K < 4096))))
    rows = {}
    for kname, spec in kernel_specs(device, **shapes).items():
        for label, kernel, plain, nbytes, ops, int_ops, *compare in spec.get(
                "extra", []):
            g, p = kernel(), plain()
            sync(device)
            (compare[0] if compare else spec["compare"])(g, p)
            del g, p
            extra_ms, extra_by = bound(nbytes, ops, int_ops, rate)
            lib = spec.get("extra_library", {}).get(label)
            print(f"kernel {kname} ({label}): equal to its plain version "
                  + (f"ms={time_ms(kernel)} queued_ms={time_ms_queued(kernel)} "
                     if timed else "")
                  + (f"library_ms={time_ms(lib)} "
                     f"library_queued_ms={time_ms_queued(lib)} "
                     if timed and lib else "")
                  + f"bound_ms={extra_ms} bound_by={extra_by}")
        got = spec["kernel"]()
        want = spec["plain"]()
        sync(device)
        spec["compare"](got, want)
        err = max((g - p).abs().max().item()
                  for g, p in zip(parts(got), parts(want)))
        row = dict(name=kname, route="cuda", source=CSRC + SOURCES[kname],
                   replaces=spec["replaces"], max_abs_err=err)
        row["bound_ms"], row["bound_by"] = bound(
            spec["bytes"], spec["ops"], spec.get("int_ops", 0), rate)
        if timed:
            row["ms"] = time_ms(spec["kernel"])
            row["queued_ms"] = time_ms_queued(spec["kernel"])
            row["plain_ms"] = time_ms(spec["plain"])
            lib = spec["library"]
            row["library_ms"] = time_ms(lib) if lib else None
            row["library_queued_ms"] = time_ms_queued(lib) if lib else None
        rows[kname] = row
        print(f"kernel {kname}: max_abs_err={err:.3g} "
              + " ".join(f"{k}={row[k]}" for k in
                         ("ms", "queued_ms", "plain_ms", "library_ms",
                          "library_queued_ms", "bound_ms", "bound_by")
                         if k in row))
        del got, want
    sync(device)
    return rows


# ---------------------------------------------------------------- phase 3
def round_inputs(C, H, B, seed=0):
    rng = np.random.default_rng(seed)
    batches = {
        "image": rng.normal(size=(C, H, B) + CIFAR_CNN.in_shape
                            ).astype(np.float32),
        "label": rng.integers(0, CIFAR_CNN.num_classes, (C, H, B)
                              ).astype(np.int32)}
    weights = rng.uniform(100, 400, C).astype(np.float32)
    mask = np.ones(C, np.float32)
    mask[3] = 0.0                               # one straggler cut
    return batches, weights, mask


def parity_cases():
    """Phase 3's cases: name -> (the launcher's FLConfig, FLConfig changes,
    n_pods, the kernels the card's round must launch)."""
    cases = {}
    for cname, (flags, expect) in CONFIGS.items():
        cases[cname] = (flags, {}, 1, set(expect))
    cases.update(PARITY_EXTRA)
    out = {}
    for cname, (flags, changes, n_pods, kernels) in cases.items():
        fl = train.fl_config(train.build_parser().parse_args(MAIN_ARGS
                                                             + flags))
        out[cname] = (fl, changes, n_pods, kernels)
    return out


def check_round_parity(device="cuda", C=8, H=2, B=16, tol=1e-4):
    """Phase 3: rounds on the card against the CPU.

    Local training is continuous in its inputs: the clients' deltas from the
    card and from the CPU must agree to ``tol``.  The commit is not: top-k
    and rounding can flip on a difference of one ulp in a delta, so the
    parallel commit (kernels, normalise, server step) runs on the card and
    on the CPU from the card's deltas, and the new params must agree to
    ``tol``.  The whole round, card against CPU, must agree to ``tol`` where
    the commit has no compression; the sequential modes, whose commit
    streams through training, are held as whole rounds without compression.
    Compression draws and commit keys come from CPU generators with one
    seed on both sides, so stochastic rounding, federated dropout and the
    integer mask stream draw the same numbers there.  The card's round must
    launch exactly the case's kernels."""
    model = CNN(CIFAR_CNN)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    b, w, m = round_inputs(C, H, B)
    worst = {}

    def on(dev, tree):
        return {k: torch.as_tensor(v).to(dev) for k, v in tree.items()}

    def gap(a, c):
        return max((a[k].cpu() - c[k].cpu()).abs().max().item() for k in a)

    def whole_round(step, dev):
        return step(on(dev, params), (), on(dev, b),
                    torch.from_numpy(w).to(dev), torch.from_numpy(m).to(dev),
                    torch.Generator().manual_seed(7))[0]

    for cname, (fl, changes, n_pods, kernels) in parity_cases().items():
        fl = dataclasses.replace(fl, num_clients=C, local_steps=H, **changes)
        step = build_fl_round_step(model.loss_fn, get_client_optimizer("sgd"),
                                   get_server_optimizer("fedavg"), fl,
                                   n_pods=n_pods)
        launches.reset()
        err = {}
        if isinstance(step, ParallelRound):
            trained = {dev: step.train_clients(on(dev, params), on(dev, b))
                       for dev in (device, "cpu")}
            sync(device)
            d_card, l_card = trained[device]
            commits = {}
            for dev in (device, "cpu"):
                new, _, met = step.commit(
                    on(dev, params), (), on(dev, d_card), l_card.to(dev),
                    torch.from_numpy(w).to(dev), torch.from_numpy(m).to(dev),
                    torch.Generator().manual_seed(7))
                sync(dev)
                check(math.isfinite(float(met["client_loss"])),
                      f"{cname}: non-finite loss on {dev}")
                commits[dev] = new
            err = {"deltas": gap(d_card, trained["cpu"][0]),
                   "commit": gap(commits[device], commits["cpu"])}
        launched = set(launches.KERNEL_LAUNCHES)
        if not fl.compression.enabled:
            rounds = {dev: whole_round(step, dev) for dev in (device, "cpu")}
            sync(device)
            launched |= set(launches.KERNEL_LAUNCHES)
            err["round"] = gap(rounds[device], rounds["cpu"])
        check(launched == kernels,
              f"{cname}: the card launched {sorted(launched)}, expected the "
              f"kernels {sorted(kernels)}")
        worst[cname] = err
        print(f"round parity {cname}: max |card - cpu| = {err}")
        for part, e in err.items():
            check(e <= tol, f"{cname}: {part} on the card differs from the "
                            f"CPU by {e:.3g} > {tol}")
    launches.reset()
    return worst


def scan_chunks(model, S: int) -> int:
    """The selective scan's calls in one pass over S tokens: one per chunk
    (the remainder included) per Mamba layer."""
    if model.cfg.mamba is None:
        return 0
    n_mamba = model.n_groups * sum(s.mixer == "mamba" for s in model.pattern)
    return n_mamba * math.ceil(S / model.cfg.mamba.chunk)


def train_launches(model, mode, C, H, S) -> dict:
    """The kernels local training launches: per chunk per Mamba layer per
    local step, the scan twice (the forward, and the recompute of the
    per-group remat) and its backward once, for all C clients at once
    (parallel: vmap folds the clients into the scan's batch) or for each
    client in turn (sequential)."""
    n = scan_chunks(model, S) * H * (C if mode == "sequential" else 1)
    return {"selective_scan": 2 * n, "selective_scan_bwd": n} if n else {}


def commit_launches(mode, kernel, n_leaves, C) -> dict:
    """The kernels one commit launches: the parallel commit one bucketed
    commit kernel; the sequential commit compresses each client's delta
    leaf by leaf (top-k, then the deterministic quantize), masking in
    float where secure, and folds it with no kernel."""
    if mode == "parallel":
        return {kernel: 1}
    if kernel == "fused_accum":
        return {}
    return {"topk_sparsify": n_leaves * C, "quantize": n_leaves * C}


def lm_inputs(cfg, lead, S, seed):
    """numpy int32 tokens ``token_shape(cfg, *lead, S)`` drawn from
    ``seed`` and, for the VLM, patches [*lead, n_patches, D] (float32, from
    ``seed + 1000``), else None."""
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab, token_shape(cfg, *lead, S)).astype(np.int32)
    patches = None
    if cfg.cross_attn_every:
        patches = np.random.default_rng(seed + 1000).normal(
            size=(*lead, cfg.n_patches, cfg.d_model)).astype(np.float32)
    return toks, patches


def lm_batches(cfg, lead, S, seed):
    """numpy tokens and targets [*lead, S] ([*lead, S, n_cb] with
    codebooks), the targets one position on, from the S + 1 tokens of
    ``lm_inputs``, with its patches for the VLM."""
    toks, patches = lm_inputs(cfg, lead, S + 1, seed)
    seq = len(lead)
    batch = {"tokens": toks.take(np.arange(S), axis=seq),
             "targets": toks.take(np.arange(1, S + 1), axis=seq)}
    if patches is not None:
        batch["patches"] = patches
    return batch


def round_batches(cfg, rounds, C, H, B, S, seed, device):
    """``lm_batches`` for ``rounds`` rounds of [C, H, B, S], drawn at once
    and moved to ``device``; returns round r's batch as a function of r."""
    drawn = {k: torch.from_numpy(v).to(device) for k, v in
             lm_batches(cfg, (rounds, C, H, B), S, seed).items()}
    return lambda r: {k: v[r] for k, v in drawn.items()}


def check_lm_round_parity(device="cuda", C=8, H=2, B=16, S=64, tol=1e-4,
                          rel_tol=1e-3, cfg=None, n_params=LM_PARAMS,
                          n_leaves=LM_LEAVES, modes=("parallel",)):
    """Phase 3 for the char-LM at full width, and phase lm_train's reduced
    LMs: the clients' deltas from local training on the card and on the
    CPU, from the same params (drawn on the CPU) and tokens, agree to
    ``tol``, the card launching exactly the kernels of ``train_launches``;
    then each LM commit (LM_PARITY) runs on the card and on the CPU from
    the card's deltas, and the new params agree to ``tol`` (the
    "discontinuous commits" rule), the card's commit launching exactly the
    kernels of ``commit_launches``; and the uncompressed round, each device
    from its own deltas, agrees to ``tol``.  Each client mode of ``modes``
    runs this: parallel through ``ParallelRound.train_clients`` and
    ``commit``, sequential through ``SequentialRound.local_train`` for each
    client and ``commit`` over their deltas.  The changes are small (lr
    0.01), so each gap is also held to ``rel_tol`` of the largest change on
    the CPU (the deltas, or the new params minus the params), which must
    not be 0: a commit that left the params as they were, or moved them
    wrongly, fails."""
    model = build_model(cfg or get_config("paper-charlm"))
    params = flat_dict(model.init(torch.Generator().manual_seed(0)))
    n = sum(v.numel() for v in params.values())
    check(n_params is None or n == n_params and len(params) == n_leaves,
          f"lm round parity: {n} params in {len(params)} leaves")
    batches = lm_batches(model.cfg, (C, H, B), S, 0)
    _, w, m = round_inputs(C, 1, 1)

    def on(dev, tree):
        return {k: torch.as_tensor(v).to(dev) for k, v in tree.items()}

    def gap(a, c):
        return max((a[k].cpu() - c[k].cpu()).abs().max().item() for k in a)

    def change(new):
        return max((new[k].cpu() - params[k]).abs().max().item()
                   for k in params)

    devs = (device, "cpu")
    errs, sizes = {}, {}
    for mode in modes:
        steps = {}
        for cname, (flags, kernel) in LM_PARITY.items():
            fl = train.fl_config(train.build_parser().parse_args(LM_ARGS
                                                                 + flags))
            steps[cname] = build_fl_round_step(
                model.loss_fn, get_client_optimizer("sgd"),
                get_server_optimizer("fedavg"),
                dataclasses.replace(fl, num_clients=C, local_steps=H,
                                    client_exec=mode))
        first = steps["lm_default"]

        def train_clients(dev):
            if mode == "parallel":
                return first.train_clients(on(dev, params), on(dev, batches))
            out = [first.local_train(on(dev, params), on(dev, {
                k: v[c] for k, v in batches.items()})) for c in range(C)]
            return ({k: torch.stack([d[k] for d, _ in out])
                     for k in params}, torch.stack([l for _, l in out]))

        launches.reset()
        trained = {dev: train_clients(dev) for dev in devs}
        sync(device)
        counts = dict(launches.KERNEL_LAUNCHES)
        expect = train_launches(model, mode, C, H, S)
        check(counts == expect, f"lm round parity ({mode}): local training "
                                f"launched {counts}, expected {expect}")
        d_cpu = trained["cpu"][0]
        errs[f"{mode} deltas"] = gap(trained[device][0], d_cpu)
        sizes[f"{mode} deltas"] = max(v.abs().max().item()
                                      for v in d_cpu.values())

        def commit(cname, dev, deltas, losses):
            args = (on(dev, params), ())
            if mode == "parallel":
                args += (on(dev, deltas), losses.to(dev))
            else:
                args += (((on(dev, {k: d[c] for k, d in deltas.items()}),
                           losses[c].to(dev)) for c in range(C)),)
            new, _, met = steps[cname].commit(
                *args, torch.from_numpy(w).to(dev),
                torch.from_numpy(m).to(dev), torch.Generator().manual_seed(7))
            sync(dev)
            check(math.isfinite(float(met["client_loss"])),
                  f"lm round parity {cname}: non-finite loss on {dev}")
            return new

        d_card, l_card = trained[device]
        for cname, (_, kernel) in LM_PARITY.items():
            launches.reset()
            card = commit(cname, device, d_card, l_card)
            counts = dict(launches.KERNEL_LAUNCHES)
            expect = commit_launches(mode, kernel, len(params), C)
            check(counts == expect, f"lm round parity {mode} {cname}: the "
                                    f"card's commit launched {counts}, "
                                    f"expected {expect}")
            cpu = commit(cname, "cpu", d_card, l_card)
            errs[f"{mode} {cname}"] = gap(card, cpu)
            sizes[f"{mode} {cname}"] = change(cpu)
        cpu = commit("lm_default", "cpu", *trained["cpu"])
        errs[f"{mode} round lm_default"] = gap(
            commit("lm_default", device, *trained[device]), cpu)
        sizes[f"{mode} round lm_default"] = change(cpu)
    launches.reset()
    print(f"lm round parity ({model.cfg.name}, {n} params, C={C}, H={H}, "
          f"B={B}, S={S}): max |card - cpu| = {errs}; largest change on the "
          f"CPU = {sizes}")
    for part, e in errs.items():
        check(e <= tol, f"lm round parity: {part} on the card differs from "
                        f"the CPU by {e:.3g} > {tol}")
        check(0 < sizes[part] and e <= rel_tol * sizes[part],
              f"lm round parity: {part} on the card differs from the CPU by "
              f"{e:.3g}, against a largest change of {sizes[part]:.3g}")
    return errs


def round_parity():
    """Phase 3: the CNN's rounds, then the char-LM's (4 clients: its CPU
    side is most of the part)."""
    return {"cnn": check_round_parity(), "lm": check_lm_round_parity(C=4)}


# ---------------------------------------------------------------- phase 4
def check_run(cname, summary, counts, expect, wall):
    losses = summary["client_loss"]
    check(len(losses) == 3 and all(math.isfinite(x) for x in losses),
          f"{cname}: losses {losses}")
    if summary["dataset"] == "shakespeare":
        # the char-LM has no accuracy: no eval fn, as in the reference, so
        # the eval metric stays NaN
        check(summary["final_eval"] is None
              or math.isnan(summary["final_eval"]),
              f"{cname}: final eval {summary['final_eval']}")
    else:
        check(summary["final_eval"] is not None
              and 0.0 <= summary["final_eval"] <= 1.0,
              f"{cname}: final eval {summary['final_eval']}")
    check(counts == expect, f"{cname}: launches {counts}, expected {expect}")
    print(f"main path {cname}: launches={counts} round_wall_s="
          f"{[round(x, 4) for x in summary['round_wall_s']]} "
          f"final_eval={summary['final_eval']} wall={wall:.1f}s")


def add_counts(totals, counts):
    for k, n in counts.items():
        totals[k] = totals.get(k, 0) + n


def drive_configs(base_args, configs, fused_expect):
    """The launcher on the card once per configuration, then an
    Orchestrator built as the launcher builds it, with the fused FedProx
    update; each run's launches counted from 0."""
    totals = {}
    for cname, (flags, expect) in configs.items():
        launches.reset()
        t0 = time.perf_counter()
        summary = train.main(base_args + flags)
        torch.cuda.synchronize()
        counts = dict(launches.KERNEL_LAUNCHES)
        check_run(cname, summary, counts, expect, time.perf_counter() - t0)
        add_counts(totals, counts)
    args = train.build_parser().parse_args(base_args + FUSED_UPDATE_ARGS)
    orch, params = train.build_run(args, dataclasses.replace(
        train.fl_config(args), use_fused_update=True))
    launches.reset()
    t0 = time.perf_counter()
    orch.run(params, args.rounds, verbose=True)
    torch.cuda.synchronize()
    counts = dict(launches.KERNEL_LAUNCHES)
    prefix = "lm_" if args.dataset == "shakespeare" else ""
    check_run(f"{prefix}fedprox_fused_update", train.summarize(args, orch),
              counts, fused_expect, time.perf_counter() - t0)
    add_counts(totals, counts)
    return totals


def check_resume(tmp, base_args=MAIN_ARGS, tol=1e-4):
    """A checkpointed run on the card (``--checkpoint-every 1``) cut one
    round short, then ``--resume`` for the last round on the card and, from
    a copy of the same checkpoint, on the CPU: the final params agree to
    ``tol``, and the card's resumed run launches the default commit's
    fused accumulate once, counted from 0 just before it."""
    ckpt = tmp / "ckpt"
    argv = base_args + ["--checkpoint-dir", str(ckpt), "--checkpoint-every",
                        "1"]
    args = train.build_parser().parse_args(argv)

    def with_args(**changes):
        return argparse.Namespace(**{**vars(args), **changes})

    train.run(with_args(rounds=args.rounds - 1))
    shutil.copytree(ckpt, tmp / "ckpt_cpu")
    launches.reset()
    _, card, _ = train.run(with_args(resume=True))
    torch.cuda.synchronize()
    counts = dict(launches.KERNEL_LAUNCHES)
    saved = sorted(d.name for d in ckpt.iterdir() if d.is_dir())
    _, cpu, _ = train.run(with_args(resume=True, device="cpu",
                                    checkpoint_dir=str(tmp / "ckpt_cpu")))
    err = max((card[k].cpu() - cpu[k]).abs().max().item() for k in card)
    print(f"checkpoint and resume ({args.dataset}, {args.rounds - 1} rounds, "
          f"then --resume to {args.rounds}): checkpoints {saved}; final "
          f"params max |card - cpu| = {err:.3g}; launches {counts}")
    check(saved == [f"round_{r:06d}" for r in range(args.rounds)],
          f"resume: checkpoints {saved}")
    check(err <= tol, f"resume: the card's resumed run differs from the "
                      f"CPU's by {err:.3g} > {tol}")
    check(counts == RESUME_EXPECT, f"resume: the card's resumed run launched "
                                   f"{counts}, expected {RESUME_EXPECT}")


def start_worker(tmp, client=3) -> dict:
    """Start ``python -m repro_torch.worker --once`` on the card for one
    client from a global model file under ``tmp`` (its process's start is
    most of its time, so it runs beside other work); ``check_worker``
    reads it.  The worker's process runs with NVIDIA_TF32_OVERRIDE=0, so
    its cuDNN convolutions compute in float32, as this process's do with
    TF32 turned off."""
    params = CNN(CIFAR_CNN).init(torch.Generator().manual_seed(0))
    dirs = {dev: tmp / f"worker_{dev}" for dev in ("cuda", "cpu")}
    for d in dirs.values():
        d.mkdir()
        save_pytree(d / "global_round_0000.bin", params)
    argv = ["--client-id", str(client), "--once", "--timeout-s", "120"]
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.worker", "--device", "cuda",
         "--workdir", str(dirs["cuda"])] + argv,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                 NVIDIA_TF32_OVERRIDE="0"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return dict(proc=proc, params=params, dirs=dirs, argv=argv,
                client=client, t0=time.perf_counter())


def check_worker(job, tol=1e-4):
    """``start_worker``'s process on the card, and the same worker in this
    process on the CPU, from one global model file: their update files
    agree to ``tol``."""
    params, dirs, argv, client = (job[k] for k in ("params", "dirs", "argv",
                                                   "client"))
    stdout, stderr = job["proc"].communicate(timeout=300)
    wall = time.perf_counter() - job["t0"]
    rc = job["proc"].returncode
    check(rc == 0, f"worker on the card: exit {rc}: {stderr[-2000:]}")
    worker.main(["--device", "cpu", "--workdir", str(dirs["cpu"])] + argv)
    stem = f"update_0000_client_{client:03d}"
    got = load_pytree(dirs["cuda"] / f"{stem}.bin", params)
    want = load_pytree(dirs["cpu"] / f"{stem}.bin", params)
    err = max((got[k] - want[k]).abs().max().item() for k in want)
    meta = [json.loads((d / f"{stem}.json").read_text())
            for d in dirs.values()]
    print(f"worker --once on the card (done within {wall:.1f} s of its "
          f"start, beside the resumed runs): {stdout.strip()}; update max "
          f"|card - cpu| = {err:.3g}; "
          f"metadata {meta}")
    check(err <= tol and meta[0]["data_size"] == meta[1]["data_size"],
          f"worker: the card's update differs from the CPU's by {err:.3g}")


def drive_main_path():
    """Phase 4: the main path at full CIFAR CNN width, then at full
    paper-charlm width (--dataset shakespeare), then a checkpointed CIFAR
    run resumed on the card and on the CPU, and the worker."""
    totals = drive_configs(MAIN_ARGS, CONFIGS, FUSED_UPDATE_EXPECT)
    add_counts(totals, drive_configs(LM_ARGS, LM_CONFIGS,
                                     LM_FUSED_UPDATE_EXPECT))
    with tempfile.TemporaryDirectory() as tmp:
        job = start_worker(Path(tmp))
        try:
            check_resume(Path(tmp))
            check_worker(job)
        finally:
            job["proc"].kill()          # nothing once it has exited
    return totals


# ------------------------------------------------------------ async path
def async_commit(fl, async_cfg, params, deltas, w, s, losses, m, alpha,
                 generator):
    """One async buffer commit of the launcher's configuration: the
    single-shot step, or the chunked steps when ``--commit-chunk`` is below
    the buffer (each chunk padded to C, ids arange(C), as the orchestrator
    stacks them)."""
    server = get_server_optimizer("fedavg")
    C = async_cfg.commit_chunk
    if not 0 < C < len(w):
        step = build_buffer_commit_step(server, fl, async_cfg)
        return step(params, (), deltas, w, s, losses, m,
                    torch.arange(len(w), dtype=torch.int32), alpha,
                    generator)[0]
    acc_step, fin_step = build_chunked_commit_steps(server, fl, async_cfg)
    acc = {k: torch.zeros_like(p) for k, p in params.items()}
    wsum = torch.zeros((), device=w.device)
    for lo in range(0, len(w), C):
        part = slice(lo, lo + C)
        acc, wsum = acc_step(acc, wsum, {k: d[part] for k, d in deltas.items()},
                             w[part], s[part], losses[part], m[part],
                             torch.arange(C, dtype=torch.int32), alpha,
                             generator)
    return fin_step(params, (), acc, wsum)[0]


def check_async_commit_parity(device="cuda", k=ASYNC_K, tol=1e-4, seed=3):
    """Part (a): the async buffer commit on the card against the CPU from
    the same full-width CIFAR params and deltas, staleness ASYNC_STALENESS
    and the exponents 0.5 and the adaptive controller's first alpha, each
    configuration of ASYNC_PARITY with its compression draws and mask key
    from CPU generators of one seed on both sides.  The new params agree to
    ``tol``, the compressed commits also to the quantize contract, and the
    card launches exactly the configuration's kernels."""
    model = CNN(CIFAR_CNN)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(seed)
    deltas = {n: torch.from_numpy((rng.normal(size=(k,) + tuple(p.shape))
                                   * 0.01).astype(np.float32))
              for n, p in params.items()}
    weights = torch.from_numpy(rng.uniform(100, 400, k).astype(np.float32))
    losses = torch.from_numpy(rng.uniform(0.5, 2.5, k).astype(np.float32))
    stal = torch.tensor(ASYNC_STALENESS[:k], dtype=torch.float32)
    alphas = {"0.5": ASYNC_EXPONENT,
              "adaptive": AdaptiveStalenessController().update(
                  ASYNC_STALENESS[:k], 1.0)}
    worst = {}
    for cname, (flags, expect, live) in ASYNC_PARITY.items():
        args = train.build_parser().parse_args(ASYNC_ARGS + flags)
        fl, acfg = train.fl_config(args), train.async_config(args)
        live = min(live, k)
        m = (torch.arange(k) < live).float()
        w = weights * m
        d = {n: v * m.reshape((-1,) + (1,) * (v.ndim - 1))
             for n, v in deltas.items()}
        for aname, alpha in alphas.items():
            new = {}
            for dev in (device, "cpu"):
                on = lambda t: t.to(dev)                   # noqa: E731
                launches.reset()
                new[dev] = async_commit(
                    fl, acfg, {n: on(p) for n, p in params.items()},
                    {n: on(v) for n, v in d.items()}, on(w), on(stal),
                    on(losses), on(m), alpha,
                    torch.Generator().manual_seed(7))
                sync(dev)
                if dev == device:
                    counts = dict(launches.KERNEL_LAUNCHES)
            label = f"async commit parity {cname}, exponent {aname}"
            check(torch.device(device).type != "cuda" or counts == expect,
                  f"{label}: the card launched {counts}, expected {expect}")
            err = max((new[device][n].cpu() - new["cpu"][n]).abs().max()
                      .item() for n in params)
            if fl.compression.enabled:
                w_eff = ref.slot_weights(w, stal, alpha)
                for n in params:
                    step = (w_eff.max() * d[n].abs().max() / 127
                            / w.sum()).item()
                    assert_quantized_close(new[device][n].cpu(),
                                           new["cpu"][n], step,
                                           f"{label} ({n})")
            print(f"{label}: max |card - cpu| = {err:.3g}; launches {counts}")
            check(err <= tol, f"{label}: the card differs from the CPU by "
                              f"{err:.3g} > {tol}")
            worst[f"{cname}, {aname}"] = err
            if fl.secure_agg:
                compare_slot_weights(label, fl, w, m, losses, stal, alpha,
                                     device)
    launches.reset()
    return worst


def compare_slot_weights(label, fl, w, m, losses, stal, alpha, device):
    """The secure commit's discounted slot weights ``w_eff`` (the
    pipeline's ``client_weights``: each device's own ``pow``) computed on
    the card and on the CPU from the same inputs, compared bitwise: the
    slots whose weights differ and by how many float32 steps."""
    pipe = build_update_pipeline(fl)
    got = {dev: pipe.client_weights(w.to(dev), m.to(dev), losses.to(dev),
                                    stal.to(dev), alpha)[0].cpu()
           for dev in (device, "cpu")}
    a, b = got[device], got["cpu"]
    steps = (a.view(torch.int32).long() - b.view(torch.int32).long()).abs()
    diff = [int(i) for i in torch.nonzero(a != b).flatten()]
    print(f"{label}: w_eff card against CPU bitwise: {len(diff)} of "
          f"{len(a)} slots differ (slots {diff}, staleness "
          f"{[float(stal[i]) for i in diff]}), by at most "
          f"{int(steps.max())} float32 steps")


def attempt_times(orch):
    """Sim-seconds from dispatch to arrival of each update a run without
    faults processed: the first ``max_concurrency`` dispatches go out at
    time 0 and every processed event dispatches the next one at its own
    time, so dispatch seq j >= concurrency left at the (j - concurrency)-th
    event's time."""
    c = min(orch.async_cfg.max_concurrency, len(orch.fleet))
    starts = [0.0] * c + [e[0] for e in orch.events_processed]
    return [t - starts[seq] for t, seq, _, failed, _ in orch.events_processed
            if not failed]


def check_async_run(cname, summary, orch, counts, expect, wall, commits=6):
    losses = summary["client_loss"]
    check(summary["commits"] == len(losses) == commits
          and all(math.isfinite(x) for x in losses),
          f"{cname}: commits {summary['commits']}, losses {losses}")
    if summary["dataset"] == "shakespeare":
        check(summary["final_eval"] is None
              or math.isnan(summary["final_eval"]),
              f"{cname}: final eval {summary['final_eval']}")
    else:
        check(0.0 <= summary["final_eval"] <= 1.0,
              f"{cname}: final eval {summary['final_eval']}")
    check(counts == expect, f"{cname}: launches {counts}, expected {expect}")
    print(f"main path {cname}: launches={counts} commits={summary['commits']} "
          f"timeout_commits={summary['timeout_commits']} "
          f"updates_applied={summary['updates_applied']} "
          f"final_eval={summary['final_eval']} wall={wall:.1f}s")
    for log in orch.logs:
        pw = log.phase_wall
        print(f"  commit {log.commit}: wall_s="
              f"{sum(v for k, v in pw.items() if k != 'host_syncs'):.6f} "
              f"n_updates={log.n_updates} timeout={log.timeout_commit} "
              f"alpha={log.staleness_alpha:.4f} phase_wall={pw}")


def busy_share(orch, params, server_state, n=2):
    """Device busy share of ``n`` more commits of a warm async run: their
    kernels' device time under ``torch.profiler`` over the host wall time
    of ``n`` commits run before them unprofiled.  Printed only; it gates
    nothing, and its launches come after the run's count was read."""
    from torch.profiler import ProfilerActivity, profile
    t0 = time.perf_counter()
    params, server_state = orch.run(params, orch.version + n,
                                    server_state=server_state)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        orch.run(params, orch.version + n, server_state=server_state)
        torch.cuda.synchronize()
    device_us = sum(e.self_device_time_total for e in prof.key_averages()
                    if str(e.device_type).endswith("CUDA"))
    print(f"  {n} warm commits: {wall_s * 1e3:.3f} ms of wall, "
          f"{device_us / 1e3:.3f} ms of device time (busy share "
          f"{device_us / 1e6 / wall_s:.3f})")


def drive_async(base_args, configs, profiled=("async_default",
                                              "async_batched")):
    """The async launcher on the card once per configuration, its launches
    counted from 0 just before the run and read just after, and held
    against the commits times each configuration's launches per commit.
    The adaptive run's commit timeout is a quarter of the default run's
    median attempt time, so that partial buffers really time out.  The
    ``profiled`` runs then print their device busy share."""
    totals, timeout = {}, None
    for cname, (flags, per_commit) in configs.items():
        if cname == "async_adaptive_timeout":
            flags = flags + ["--commit-timeout", str(timeout)]
        args = train.build_parser().parse_args(base_args + flags)
        launches.reset()
        t0 = time.perf_counter()
        orch, params, server_state = train.run(args)
        sync(args.device)
        wall = time.perf_counter() - t0
        counts = dict(launches.KERNEL_LAUNCHES)
        summary = train.summarize(args, orch)
        expect = {kn: n * summary["commits"] for kn, n in per_commit.items()}
        check_async_run(cname, summary, orch, counts, expect, wall,
                        commits=args.rounds)
        add_counts(totals, counts)
        if cname == "async_default":
            times = attempt_times(orch)
            timeout = statistics.median(times) / 4
            print(f"  attempt times (sim s): median "
                  f"{statistics.median(times):.4f} over {len(times)} updates;"
                  f" the adaptive run's --commit-timeout {timeout:.6f}")
        if cname in profiled and torch.device(args.device).type == "cuda":
            busy_share(orch, params, server_state)
        if cname == "async_adaptive_timeout":
            check(summary["timeout_commits"] > 0,
                  f"{cname}: no commit timed out at T={timeout}")
    return totals


def check_async_resume(tmp, base_args=ASYNC_ARGS, cut=4, tol=1e-4):
    """Part (c): a checkpointed async run on the card cut after ``cut``
    commits, then --resume to the full count on the card and, from a copy
    of the same checkpoint, on the CPU: equal processed events and params
    to ``tol``.  The card's resumed run is also held against its
    uninterrupted run, with torch.use_deterministic_algorithms on: bit for
    bit where every op of the path has a deterministic implementation (no
    warning), else to 1e-5.  The resumed run launches one fused accumulate
    per commit it makes."""
    ckpt = tmp / "async_ckpt"
    args = train.build_parser().parse_args(
        base_args + ["--checkpoint-dir", str(ckpt), "--checkpoint-every",
                     "1"])

    def with_args(**changes):
        return argparse.Namespace(**{**vars(args), **changes})

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            straight, p_straight, _ = train.run(with_args(checkpoint_dir=""))
            train.run(with_args(rounds=cut))
            shutil.copytree(ckpt, tmp / "async_ckpt_cpu")
            launches.reset()
            resumed, card, _ = train.run(with_args(resume=True))
            sync(args.device)
            counts = dict(launches.KERNEL_LAUNCHES)
    finally:
        torch.use_deterministic_algorithms(False)
    nondet = sorted({str(w.message).split("\n")[0] for w in caught
                     if "deterministic" in str(w.message)})
    on_cpu, cpu, _ = train.run(with_args(
        resume=True, device="cpu", checkpoint_dir=str(tmp / "async_ckpt_cpu")))
    err_cpu = max((card[k].cpu() - cpu[k]).abs().max().item() for k in card)
    err_straight = max((card[k] - p_straight[k]).abs().max().item()
                       for k in card)
    bitwise = all(torch.equal(card[k], p_straight[k]) for k in card)
    expect = {"fused_accum": args.rounds - cut}
    print(f"async checkpoint and resume ({args.dataset}, {cut} commits, then "
          f"--resume to {args.rounds}): resumed card vs CPU max |diff| = "
          f"{err_cpu:.3g}; resumed card vs uninterrupted card max |diff| = "
          f"{err_straight:.3g} (bit for bit: {bitwise}); deterministic "
          f"algorithms warned: {nondet or 'none'}; launches {counts}")
    check(resumed.events_processed == on_cpu.events_processed
          == straight.events_processed,
          "async resume: the processed events differ")
    check(err_cpu <= tol, f"async resume: the card's resumed run differs "
                          f"from the CPU's by {err_cpu:.3g} > {tol}")
    check(bitwise if not nondet else err_straight <= 1e-5,
          f"async resume: the card's resumed run differs from its "
          f"uninterrupted run by {err_straight:.3g}")
    check(counts == expect, f"async resume: launches {counts}, expected "
                            f"{expect}")
    return counts


def async_path():
    """Phase async_path: (a) the commit, card against CPU; (b) the async
    launcher on the card, each configuration at full CIFAR width, then the
    char-LM at full paper-charlm width; (c) checkpoint and resume."""
    check_async_commit_parity()
    totals = drive_async(ASYNC_ARGS, ASYNC_CONFIGS)
    add_counts(totals, drive_async(
        LM_ASYNC_ARGS + ["--rounds", str(LM_ASYNC_COMMITS)],
        {"lm_async_default": ASYNC_CONFIGS["async_default"]}))
    with tempfile.TemporaryDirectory() as tmp:
        add_counts(totals, check_async_resume(Path(tmp)))
    return totals


# ------------------------------------------------------------ fleet_path
def host_log(log) -> dict:
    """A CommitLog's host fields: everything but the float results of the
    device math and the wall-clock profile, NaN made comparable."""
    d = dataclasses.asdict(log)
    for k in ("client_loss", "delta_norm", "staleness_alpha", "eval_metric",
              "phase_wall"):
        d.pop(k)
    return d


def params_gap(a, b) -> float:
    return max((a[k].cpu() - b[k].cpu()).abs().max().item() for k in a)


def same_run(label, orch, ref_orch, p, p_ref, tol):
    """Equal processed events, comm ledger and log host fields; params
    within ``tol`` (not held where None).  Returns the params gap."""
    gap = params_gap(p, p_ref)
    check(orch.events_processed == ref_orch.events_processed,
          f"{label}: the processed events differ")
    check(orch.comm.records == ref_orch.comm.records,
          f"{label}: the comm ledgers differ")
    check([host_log(l) for l in orch.logs]
          == [host_log(l) for l in ref_orch.logs],
          f"{label}: the commit logs' host fields differ")
    check(tol is None or gap <= tol,
          f"{label}: params differ by {gap:.3g} > {tol}")
    return gap


def check_window_syncs(cname, orch):
    """One host read a commit: every commit of the run (no eval before the
    10th) read the card once."""
    syncs = [l.phase_wall["host_syncs"] for l in orch.logs]
    check(syncs == [1] * len(syncs), f"{cname}: host syncs {syncs}")


def drive_window(base_args=WINDOW_ARGS, configs=WINDOW_CONFIGS):
    """(a) The window engine on the card once per configuration, its
    launches counted from 0, against the batched engine's run of the same
    flags: equal events and log host fields, params within the
    configuration's tolerance; each commit's phase_wall and host syncs
    printed and the syncs held at 1; the default run's busy share over 2
    warm commits."""
    totals = {}
    for cname, (flags, per_commit, tol) in configs.items():
        args = train.build_parser().parse_args(base_args + flags)
        launches.reset()
        t0 = time.perf_counter()
        orch, params, server_state = train.run(args)
        sync(args.device)
        wall = time.perf_counter() - t0
        counts = dict(launches.KERNEL_LAUNCHES)
        summary = train.summarize(args, orch)
        check(summary["engine"] == "window", f"{cname}: {summary['engine']}")
        expect = {kn: n * summary["commits"] for kn, n in per_commit.items()}
        check_async_run(cname, summary, orch, counts, expect, wall)
        check_window_syncs(cname, orch)
        add_counts(totals, counts)
        batched_args = train.build_parser().parse_args(
            base_args + flags + ["--engine", "batched"])
        launches.reset()
        t0 = time.perf_counter()
        b_orch, b_params, _ = train.run(batched_args)
        sync(args.device)
        b_wall = time.perf_counter() - t0
        add_counts(totals, dict(launches.KERNEL_LAUNCHES))
        gap = same_run(f"{cname} against --engine batched", orch, b_orch,
                       params, b_params, tol)
        print(f"  against --engine batched ({b_wall:.1f}s, host syncs "
              f"{[l.phase_wall['host_syncs'] for l in b_orch.logs]}): equal "
              f"events and log host fields, params max |diff| = {gap:.3g}")
        if cname == "window_default" and \
                torch.device(args.device).type == "cuda":
            busy_share(orch, params, server_state)
    return totals


def tee_stdout(fn):
    """(fn's result, what it printed), its output printed as well."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn()
    print(buf.getvalue(), end="")
    return out, buf.getvalue()


def check_auto(base_args=ASYNC_ARGS, pool=AUTO_POOL):
    """(b) --engine auto at a 300-client pool: the reference's crossover
    picks the window engine, which runs 6 commits at one read each."""
    args = train.build_parser().parse_args(
        base_args + ["--clients-pool", str(pool), "--engine", "auto"])
    launches.reset()
    t0 = time.perf_counter()
    (orch, _, _), out = tee_stdout(lambda: train.run(args))
    sync(args.device)
    counts = dict(launches.KERNEL_LAUNCHES)
    summary = train.summarize(args, orch)
    check(f"--engine auto: {pool} clients -> window" in out,
          "auto: the launcher did not pick the window engine")
    check(isinstance(orch, EventWindowOrchestrator), "auto: not a window run")
    check_async_run(f"auto_{pool}", summary, orch, counts,
                    {"fused_accum": summary["commits"]},
                    time.perf_counter() - t0)
    check_window_syncs(f"auto_{pool}", orch)
    return counts


def mega_orch(cls, device, n_clients=MEGA_CLIENTS, seed=0, **kw):
    """An async run over a ``make_mega_fleet`` cohort fleet of
    ``n_clients`` clients, its data a ``VirtualFederatedDataset`` over the
    launcher's 60 CIFAR shards, with the launcher's async flags."""
    args = train.build_parser().parse_args(ASYNC_ARGS)
    fed, model, params, _ = train.build_task(args.dataset, args.clients_pool,
                                             seed, device)
    orch = cls(
        fleet=make_mega_fleet(n_clients, seed=seed),
        fed_data=VirtualFederatedDataset(fed.data, fed.client_indices,
                                         seed=seed, n_virtual=n_clients),
        loss_fn=model.loss_fn, fl=train.fl_config(args),
        async_cfg=train.async_config(args), batch_size=args.batch_size,
        flops_per_client_round=3e12, seed=seed, device=device, **kw)
    return orch, params, args.rounds


def check_mega(device="cuda", n_clients=MEGA_CLIENTS):
    """(c) The 100,000-client cohort fleet, window against batched: equal
    events and log host fields, params within 1e-5, one fused accumulate a
    commit; the host wall time a commit of each."""
    totals, runs = {}, {}
    for name, cls in (("batched", BatchedAsyncOrchestrator),
                      ("window", EventWindowOrchestrator)):
        orch, params, n = mega_orch(cls, device, n_clients)
        launches.reset()
        t0 = time.perf_counter()
        p, _ = orch.run(params, n)
        sync(device)
        wall = time.perf_counter() - t0
        counts = dict(launches.KERNEL_LAUNCHES)
        add_counts(totals, counts)
        check(counts == {"fused_accum": n} or device == "cpu",
              f"mega {name}: launches {counts}")
        per_commit = [sum(v for k, v in l.phase_wall.items()
                          if k != "host_syncs") for l in orch.logs]
        print(f"mega fleet, {n_clients} clients, {name} engine: {n} commits "
              f"in {wall:.2f}s; wall s a commit {[round(x, 4) for x in per_commit]}; "
              f"host syncs {[l.phase_wall['host_syncs'] for l in orch.logs]}; "
              f"{len(orch.fleet.live)} clients dispatched; launches {counts}")
        runs[name] = (orch, p)
    gap = same_run("mega window against batched", runs["window"][0],
                   runs["batched"][0], runs["window"][1], runs["batched"][1],
                   1e-5)
    check_window_syncs("mega window", runs["window"][0])
    print(f"  window against batched: equal events and log host fields, "
          f"params max |diff| = {gap:.3g}")
    return totals


def check_window_card_cpu(base_args=WINDOW_ARGS, tol=1e-4):
    """(d) One window run on the card and on the CPU from the same seeds:
    equal events, params within ``tol``."""
    args = train.build_parser().parse_args(base_args)
    launches.reset()
    card, p_card, _ = train.run(args)
    sync(args.device)
    counts = dict(launches.KERNEL_LAUNCHES)
    t0 = time.perf_counter()
    cpu, p_cpu, _ = train.run(argparse.Namespace(**{**vars(args),
                                                    "device": "cpu"}))
    gap = same_run("window card against CPU", card, cpu, p_card, p_cpu, tol)
    print(f"window engine, card against CPU ({len(card.logs)} commits; the "
          f"CPU run {time.perf_counter() - t0:.1f}s): equal events and log "
          f"host fields, params max |diff| = {gap:.3g}")
    return counts


def timed_commit_step(hier, times):
    """Wrap the tier-2 commit step so each call's wall time, between two
    syncs, lands in ``times``."""
    step = hier._commit_step

    def timed(*a):
        sync(hier.device)
        t0 = time.perf_counter()
        out = step(*a)
        sync(hier.device)
        times.append(time.perf_counter() - t0)
        return out

    hier._commit_step = timed


def run_hier(args):
    """A hierarchical launcher run epoch by epoch (one tier-2 commit each):
    (hierarchy, params, server state, wall s an epoch, tier-2 step s)."""
    hier, params = train.build_run(args)
    params, server_state, _ = train.restore(args, hier, params)
    walls, t2 = [], []
    timed_commit_step(hier, t2)
    while hier.version < args.rounds:
        t0 = time.perf_counter()
        params, server_state = hier.run(params, hier.version + 1,
                                        server_state=server_state)
        sync(args.device)
        walls.append(time.perf_counter() - t0)
    return hier, params, server_state, walls, t2


def drive_hier(configs=HIER_CONFIGS):
    """(e) The hierarchy on the card in each form: 3 tier-2 commits, finite
    losses and an accuracy, launches held exactly at the facilities'
    rounds or commits plus the tier-2 commits; the wall time an epoch and
    the tier-2 commit step's."""
    totals = {}
    for cname, (base, flags, kname) in configs.items():
        args = train.build_parser().parse_args(base + flags + HIER_FLAGS)
        launches.reset()
        t0 = time.perf_counter()
        hier, _, _, walls, t2 = run_hier(args)
        wall = time.perf_counter() - t0
        counts = dict(launches.KERNEL_LAUNCHES)
        summary = train.summarize(args, hier)
        tier1 = sum(len(f.orch.logs) for f in hier.facilities)
        epochs = (T2_COMMITS * N_FACILITIES if args.inter_facility_mode
                  == "sync" else N_FACILITIES + T2_COMMITS * args.inter_buffer)
        check(tier1 == epochs * LOCAL_ROUNDS,
              f"{cname}: {tier1} facility rounds or commits, expected "
              f"{epochs} epochs x {LOCAL_ROUNDS}")
        expect = {kname: tier1 + hier.version}
        check(summary["commits"] == T2_COMMITS
              and all(math.isfinite(x) for x in summary["client_loss"])
              and 0.0 <= summary["final_eval"] <= 1.0,
              f"{cname}: summary {summary}")
        check(counts == expect, f"{cname}: launches {counts}, expected "
                                f"{expect}")
        add_counts(totals, counts)
        print(f"main path {cname}: launches={counts} (facility rounds or "
              f"commits {tier1} + tier-2 commits {hier.version}) "
              f"epoch wall_s={[round(x, 4) for x in walls]} tier-2 commit "
              f"step s={[round(x, 6) for x in t2]} "
              f"virtual_time_s={summary['virtual_time_s']:.3f} "
              f"inter_facility_bytes={summary['inter_facility_bytes']} "
              f"final_eval={summary['final_eval']} wall={wall:.1f}s")
    return totals


def check_hier_resume(tmp, tol=1e-4):
    """(f) A 2-facility hierarchy on the card against the CPU (params
    within ``tol``, equal tier-2 and facility logs' host fields); then a
    checkpointed async/async hierarchy cut after 2 of 3 tier-2 commits and
    resumed on the card, bit for bit against the card's uninterrupted run
    under deterministic algorithms (or within 1e-5 if an op warned)."""
    args = train.build_parser().parse_args(
        MAIN_ARGS + ["--facilities", "2", "--local-rounds", "1", "--rounds",
                     "2", "--clients-per-round", str(HIER_CPU_CLIENTS)])
    launches.reset()
    card, p_card, _ = train.run(args)
    sync(args.device)
    totals = dict(launches.KERNEL_LAUNCHES)
    cpu, p_cpu, _ = train.run(argparse.Namespace(**{**vars(args),
                                                    "device": "cpu"}))
    gap = params_gap(p_card, p_cpu)
    check([host_log(l) for l in card.logs] == [host_log(l) for l in cpu.logs]
          and all([dataclasses.asdict(l)["selected"] for l in a.orch.logs]
                  == [dataclasses.asdict(l)["selected"] for l in b.orch.logs]
                  for a, b in zip(card.facilities, cpu.facilities)),
          "hier card against CPU: the logs differ")
    check(gap <= tol, f"hier card against CPU: params differ by {gap:.3g}")
    print(f"hierarchy, 2 facilities of {HIER_CPU_CLIENTS} clients a round, "
          f"card against CPU: equal tier-2 and "
          f"facility host logs, params max |diff| = {gap:.3g}")

    base, flags, _ = HIER_CONFIGS["hier_async_async"]
    ckpt = tmp / "hier_ckpt"
    args = train.build_parser().parse_args(
        base + flags + HIER_FLAGS + ["--checkpoint-dir", str(ckpt),
                                     "--checkpoint-every", "1"])

    def with_args(**changes):
        return argparse.Namespace(**{**vars(args), **changes})

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            straight, p_straight, _ = train.run(with_args(checkpoint_dir=""))
            train.run(with_args(rounds=T2_COMMITS - 1))
            launches.reset()
            (resumed, p_resumed, _), out = tee_stdout(
                lambda: train.run(with_args(resume=True)))
            sync(args.device)
            add_counts(totals, dict(launches.KERNEL_LAUNCHES))
    finally:
        torch.use_deterministic_algorithms(False)
    nondet = sorted({str(w.message).split("\n")[0] for w in caught
                     if "deterministic" in str(w.message)})
    bitwise = all(torch.equal(p_resumed[k], p_straight[k])
                  for k in p_straight)
    err = params_gap(p_resumed, p_straight)
    check("resumed hierarchical run at commit 2" in out,
          "hier resume: the launcher did not resume at commit 2")
    check([host_log(l) for l in resumed.logs]
          == [host_log(l) for l in straight.logs]
          and all(a.orch.events_processed == b.orch.events_processed
                  for a, b in zip(resumed.facilities, straight.facilities)),
          "hier resume: the resumed run's logs or events differ")
    check(bitwise if not nondet else err <= 1e-5,
          f"hier resume: differs from the uninterrupted run by {err:.3g}")
    print(f"hierarchy checkpoint and resume (async/async, cut after 2 of "
          f"{T2_COMMITS}): resumed card vs uninterrupted card max |diff| = "
          f"{err:.3g} (bit for bit: {bitwise}); deterministic algorithms "
          f"warned: {nondet or 'none'}")
    return totals


def fleet_path():
    """Phase fleet_path: (a) the window engine against the batched one;
    (b) --engine auto at 300 clients; (c) the 100,000-client cohort fleet;
    (d) the window engine card against CPU; (e) the hierarchy in three
    forms; (f) hierarchy parity and resume."""
    totals = drive_window()
    add_counts(totals, check_auto())
    add_counts(totals, check_mega())
    add_counts(totals, check_window_card_cpu())
    add_counts(totals, drive_hier())
    with tempfile.TemporaryDirectory() as tmp:
        add_counts(totals, check_hier_resume(Path(tmp)))
    return totals


# ---------------------------------------------------------------- phase 5
def rel_gap(got, want) -> float:
    """max |got - want| / max |want|, in float32 on the CPU."""
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    return ((got - want).abs().max()
            / want.abs().max().clamp_min(1e-30)).item()


def state_gap(state, want) -> float:
    return max(rel_gap(state[k][n], want[k][n]) for k in want
               for n in want[k])


def check_lm_parity(device="cuda", arch=JAMBA, B=2, S0=37, T=4, tol=1e-4):
    """The reduced LM of ``arch`` (f32) on the card against the CPU, from
    the same params (drawn on the CPU), tokens and, for the VLM, patches:
    prefill logits and every decode-state leaf (the VLM's cross K/V cache
    included), then T decode steps' logits and states, each to ``tol``
    relative.  For the reduced Jamba S0 = 37 at chunk 16 scans two whole
    chunks and a remainder; the card must launch the scan once per chunk
    (the other families launch no kernel)."""
    model = build_model(reduced(get_config(arch)))
    params = model.init(torch.Generator().manual_seed(0))

    def on(tree, dev):
        return {k: on(v, dev) if isinstance(v, dict) else v.to(dev)
                for k, v in tree.items()}

    cfg = model.cfg
    toks, patches = lm_inputs(cfg, (B,), S0 + T, 0)
    toks = torch.from_numpy(toks)
    extra = {} if patches is None else {"patches": torch.from_numpy(patches)}
    devs = (device, "cpu")
    p = {dev: on(params, dev) for dev in devs}
    launches.reset()
    gaps = {}
    with torch.inference_mode():
        out = {dev: model.prefill(p[dev], {"tokens": toks[:, :S0].to(dev),
                                           **on(extra, dev)}, S0 + T)
               for dev in devs}
        for i in range(T + 1):
            name = "prefill" if i == 0 else f"decode{i - 1}"
            gaps[name] = (rel_gap(out[device][0], out["cpu"][0]),
                          state_gap(out[device][1], out["cpu"][1]))
            if i < T:
                out = {dev: model.decode_step(p[dev], out[dev][1],
                                              toks[:, S0 + i].to(dev),
                                              S0 + i) for dev in devs}
    sync(device)
    counts = dict(launches.KERNEL_LAUNCHES)
    print(f"lm parity ({cfg.name}, f32, B={B}, prompt {S0}, {T} decode "
          f"steps): max |card - cpu| / max |cpu| (logits, state) = {gaps}; "
          f"launches {counts}")
    n_scan = scan_chunks(model, S0)
    check(counts == ({"selective_scan": n_scan} if n_scan else {}),
          f"lm parity {cfg.name}: launches {counts}")
    worst = max(max(g) for g in gaps.values())
    check(worst <= tol, f"lm parity {cfg.name}: card differs from the CPU "
                        f"by {worst:.3g} > {tol}")
    launches.reset()
    return worst


def jamba_cut():
    """Jamba-1.5-Large at every published width, 8 layers (published 72)
    and 8 experts (published 16): see JAMBA above."""
    cfg = get_config(JAMBA)
    return cfg.replace(n_layers=8,
                       moe=dataclasses.replace(cfg.moe, num_experts=8))


def profile_prefill(model, params, batch, s_max):
    """One warm prefill of ``batch`` timed on the host clock, then one
    profiler pass of it: the top 10 device kernels by time, the selective
    scan's share and the device's busy share of the warm wall time.
    Printed only; it gates nothing."""
    from torch.profiler import ProfilerActivity, profile
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.prefill(params, batch, s_max)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    with torch.inference_mode(), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        model.prefill(params, batch, s_max)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA")]
    total = sum(e.self_device_time_total for e in kernels)
    if not total:
        print("profile: no device time recorded")
        return
    scan = sum(e.self_device_time_total for e in kernels
               if "selective_scan" in e.key)
    print(f"profile of one prefill: {len(kernels)} kernels, device time "
          f"{total / 1e3:.3f} ms against {wall_s * 1e3:.3f} ms of warm "
          f"unprofiled wall time (busy share {total / 1e6 / wall_s:.3f}); "
          f"selective_scan {scan / 1e3:.3f} ms, share {scan / total:.4f}")
    for e in sorted(kernels, key=lambda e: e.self_device_time_total,
                    reverse=True)[:10]:
        print(f"  {e.self_device_time_total / 1e3:10.3f} ms "
              f"{e.self_device_time_total / total:7.2%} x{e.count:<5d} "
              f"{e.key[:110]}")


def count_drops(fn):
    """Run ``fn()`` and count, per MoE layer, the token assignments that
    the capacity limit dropped.  A diagnostic: each count reads the device,
    so timed runs do not use it."""
    drops, orig = [], moe_mod._dispatch_indices

    def dispatch(eid, gate, e_lo, e_n, capacity):
        tok_idx, gates = orig(eid, gate, e_lo, e_n, capacity)
        drops.append(eid.numel() - int((gates != 0).sum()))
        return tok_idx, gates

    moe_mod._dispatch_indices = dispatch
    try:
        fn()
    finally:
        moe_mod._dispatch_indices = orig
    return drops


@contextlib.contextmanager
def recorded_routes():
    """Every MoE routing's expert ids [T, top_k], copied on their device
    (no host read, so timed runs may use it), while the block runs."""
    routes, orig = [], moe_mod._route

    def route(x2d, router, cfg):
        out = orig(x2d, router, cfg)
        with memory.uncharged():        # the record's, not the run's
            routes.append(out[0].detach().clone())
        return out

    moe_mod._route = route
    try:
        yield routes
    finally:
        moe_mod._route = orig


@contextlib.contextmanager
def forced_routes(want):
    """Every MoE routing sent to the experts another run recorded
    (``recorded_routes``), call by call in order; the gates are this run's
    own router probabilities at those experts, normalised as ``_route``
    normalises its top-k.  Where the two runs choose alike it changes
    nothing."""
    it, orig = iter(want), moe_mod._route

    def route(x2d, router, cfg):
        _, _, aux = orig(x2d, router, cfg)
        eid = next(it).to(x2d.device)
        probs = torch.softmax(x2d.to(torch.float32)
                              @ router.to(torch.float32), dim=-1)
        gate = probs.gather(-1, eid)
        gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
        return eid, gate.to(x2d.dtype), aux

    moe_mod._route = route
    try:
        yield
    finally:
        moe_mod._route = orig


def route_flips(routes, want, per_step, B, first=0) -> list:
    """Per step (prefill, then each decode step), per batch row: the tokens
    whose set of experts differs between two runs' routings, summed over
    the step's ``per_step`` MoE layers (a call's tokens are its ``B`` rows
    in order; a call that holds fewer, a prefill of a rank's rows from
    ``first`` on, is held against those rows of ``want``)."""
    flips = []
    for a, b in zip(routes, want):
        rows = a.shape[0] * B // b.shape[0]
        lo = first if rows < B else 0
        b = b.view(B, -1, b.shape[-1])[lo:lo + rows].reshape(a.shape)
        f = (torch.sort(a.cpu(), -1).values != torch.sort(b, -1).values
             ).any(-1).view(rows, -1).sum(-1)
        flips.append(torch.cat([torch.zeros(lo, dtype=f.dtype), f,
                                torch.zeros(B - lo - rows, dtype=f.dtype)]))
    return [torch.stack(flips[i:i + per_step]).sum(0).tolist()
            for i in range(0, len(flips), per_step)]


def serve_full_width(device="cuda", cfg=None, batch=SERVE_BATCH,
                     prompt_len=SERVE_PROMPT, gen=SERVE_GEN,
                     n_params=JAMBA_PARAMS, tol=SERVE_DECODE_TOL):
    """The cut Jamba in bf16 through ``serve.run``: a ``prompt_len``-token
    prompt and ``gen`` greedy decode steps, with the scan's launches
    counted exactly, the wall times and the peak memory; decoding held
    against teacher-forced prefill at the first and the last decoded
    positions; one profiler pass of the prefill."""
    cfg = cfg or jamba_cut()
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    model, params = serve.build(cfg, device, seed=0)
    sync(device)
    n = param_count(params)
    print(f"lm serve: {cfg.name} cut to {cfg.n_layers} layers, "
          f"{cfg.moe.num_experts} experts: {n} params in {cfg.dtype}, built "
          f"in {time.perf_counter() - t0:.1f} s")
    check(n == n_params, f"lm serve: {n} params, expected {n_params}")
    g = torch.Generator(device).manual_seed(1)
    prompt = torch.randint(0, cfg.vocab, (batch, prompt_len), generator=g,
                           device=device)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    launches.reset()
    res = serve.run(model, params, prompt, gen, 0.0, g)
    counts = dict(launches.KERNEL_LAUNCHES)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    print(f"lm serve: batch {batch}, prompt {prompt_len}, {gen} greedy "
          f"steps: prefill_s={res.prefill_s:.4f} decode_s={res.decode_s:.4f} "
          f"({res.decode_s / gen * 1e3:.2f} ms/token) "
          f"max_memory_allocated={peak} ({peak / 1e9:.2f} GB) "
          f"launches={counts}")
    check(all(lg.shape == (batch, cfg.vocab) and bool(torch.isfinite(lg).all())
              for lg in res.logits), "lm serve: non-finite or misshapen logits")
    check(res.ids.shape == (batch, gen)
          and ((res.ids >= 0) & (res.ids < cfg.vocab)).all(),
          f"lm serve: generated ids {res.ids}")
    # one launch per chunk per Mamba layer in the prefill, none in decode
    expect = {"selective_scan": scan_chunks(model, prompt_len)}
    check(counts == expect, f"lm serve: launches {counts}, expected {expect}")
    with torch.inference_mode():
        drops = count_drops(lambda: model.prefill(
            params, {"tokens": prompt}, prompt_len + gen))
    print(f"lm serve: MoE assignments dropped by the capacity limit "
          f"(capacity_factor {cfg.moe.capacity_factor}) per MoE layer of the "
          f"{prompt_len}-token prefill: {drops} of "
          f"{batch * prompt_len * cfg.moe.top_k} each")
    # Decoding equals teacher-forced prefill only where prefill drops no
    # assignment: a decode step routes one token, which always fits, while
    # a prefill drops the latest tokens of an expert beyond its capacity.
    # So the comparison serves the same params with each expert's capacity
    # at the token count (capacity_factor = experts / top_k), where nothing
    # is dropped by construction.
    nd = build_model(cfg.replace(moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k)))
    res = serve.run(nd, params, prompt, gen, 0.0, g)
    tokens = torch.cat([prompt, torch.from_numpy(res.ids).to(device)], dim=1)
    gaps = {}
    with torch.inference_mode():
        for t in (0, gen - 1):
            want, _ = nd.prefill(
                params, {"tokens": tokens[:, :prompt_len + t + 1]},
                prompt_len + gen)
            gaps[prompt_len + t + 1] = rel_gap(res.logits[t + 1], want)
            same = bool((res.logits[t + 1].argmax(-1) == want.argmax(-1))
                        .all())
            print(f"lm serve: decode step {t} against the teacher-forced "
                  f"prefill of {prompt_len + t + 1} tokens (no drops): "
                  f"max |diff| / max |logit| = "
                  f"{gaps[prompt_len + t + 1]:.4g}, same argmax: {same}")
    check(max(gaps.values()) <= tol,
          f"lm serve: decoding differs from prefill by {gaps} > {tol}")
    del res, tokens, want
    if cuda:
        profile_prefill(model, params, {"tokens": prompt}, prompt_len + gen)
    del model, nd, params
    return counts


def serve_cli(arch=JAMBA):
    """The serving command line, the reduced LM of ``arch`` on cuda,
    through ``serve.main``: for Jamba one scan launch per prefill chunk,
    for the other families none."""
    argv = ["--arch", arch, "--temperature", "0"]
    args = serve.build_parser().parse_args(argv)
    launches.reset()
    res = serve.main(argv)
    torch.cuda.synchronize()
    counts = dict(launches.KERNEL_LAUNCHES)
    cfg = reduced(get_config(arch))
    n_scan = scan_chunks(build_model(cfg), args.prompt_len)
    expect = {"selective_scan": n_scan} if n_scan else {}
    check(counts == expect, f"serve CLI {arch}: launches {counts}, expected "
                            f"{expect}")
    check(res.ids.shape == token_shape(cfg, args.batch, args.gen),
          f"serve CLI {arch}: {res.ids}")
    print(f"serve CLI {arch}: launches={counts}")
    return counts


def cross_share(model, params, batch, s_max):
    """The cross-attention slots' share of one prefill's device time: CUDA
    events around each ``_cross`` call and around the whole prefill, read
    after one sync.  Printed only."""
    spans, orig = [], model._cross

    def timed(*a, **kw):
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        out = orig(*a, **kw)
        ev[1].record()
        spans.append(ev)
        return out

    whole = (torch.cuda.Event(enable_timing=True),
             torch.cuda.Event(enable_timing=True))
    model._cross = timed
    try:
        with torch.inference_mode():
            whole[0].record()
            model.prefill(params, batch, s_max)
            whole[1].record()
        torch.cuda.synchronize()
    finally:
        del model._cross
    total = whole[0].elapsed_time(whole[1])
    cross = sum(a.elapsed_time(b) for a, b in spans)
    print(f"lm serve: the {len(spans)} cross-attention slots (q, the "
          f"patches' K and V, attention, wo) take {cross:.3f} ms of a "
          f"{total:.3f} ms prefill on the device clock: share "
          f"{cross / total:.4f}")
    return cross / total


def serve_family(label, cfg, n_params, cuts, batch, prompt_len, gen,
                 device="cuda", seed=3):
    """A full-width LM in its published dtype through ``serve.run``: random
    weights from ``seed``, a ``prompt_len`` prompt (one stream per
    codebook for the audio family) and, for the VLM, patches drawn in the
    model dtype; ``gen`` greedy decode steps.  Prints the prefill wall, the
    time per token, the peak memory, the time one read of the weights
    takes at the card's memory rate, and decoding against teacher-forced
    prefill, held to SERVE_DECODE_TOL with the same argmax.  None of the
    port's kernels lies on this path: every launch count must stay 0."""
    free_cache(device)
    t0 = time.perf_counter()
    model, params = serve.build(cfg, device, seed=0)
    sync(device)
    n = param_count(params)
    nbytes = sum(v.numel() * v.element_size()
                 for v in flat_dict(params).values())
    print(f"lm serve {label}: {cfg.name} ({cfg.source}) at every published "
          f"width, {'; '.join(cuts)}: {n} params in {cfg.dtype} "
          f"({nbytes / 1e9:.2f} GB), built in {time.perf_counter() - t0:.1f}"
          f" s")
    check(n_params is None or n == n_params,
          f"lm serve {label}: {n} params, expected {n_params}")
    prompt, patches = serve.draw_inputs(
        cfg, batch, prompt_len, torch.Generator(device).manual_seed(seed),
        model.dtype)
    launches.reset()
    gaps, same = serve_decode_gaps(f"{label} ({cfg.dtype})", model, params,
                                   prompt, gen, patches)
    counts = dict(launches.KERNEL_LAUNCHES)
    check(not counts, f"lm serve {label}: launched {counts}")
    check(max(gaps.values()) <= SERVE_DECODE_TOL and all(same.values()),
          f"lm serve {label}: decoding differs from prefill by {gaps} "
          f"(> {SERVE_DECODE_TOL}) or in argmax {same}")
    if torch.device(device).type == "cuda":
        rate = memory_rate(torch.cuda.get_device_name(0))
        print(f"lm serve {label}: one read of the {nbytes / 1e9:.2f} GB of "
              f"weights takes {nbytes / rate * 1e3:.2f} ms at "
              f"{rate / 1e12:.2f} TB/s")
        extra = {} if patches is None else {"patches": patches}
        s_max = prompt_len + gen
        if cfg.cross_attn_every:
            cross_share(model, params, {"tokens": prompt, **extra}, s_max)
        profile_prefill(model, params, {"tokens": prompt, **extra}, s_max)
    del model, params, prompt, patches
    free_cache(device)
    return counts


def vlm_serve_cut():
    """Llama-3.2-Vision-90B at every published width, cut in depth only
    (VLM_SERVE_CUTS)."""
    return get_config(VLM).replace(n_layers=VLM_SERVE_LAYERS)


def lm_serve():
    """Phase lm_serve: (a) the reduced LMs on the card against the CPU;
    the cut Jamba, the cut Llama-3.2-Vision and MusicGen-medium whole at
    full width; the command line for each of the three families."""
    for arch in LM_SERVE_PARITY:
        check_lm_parity(arch=arch)
    totals = dict(serve_full_width())
    serve_family("vlm", vlm_serve_cut(), VLM_SERVE_PARAMS, VLM_SERVE_CUTS,
                 **VLM_SERVE)
    serve_family("audio", get_config(AUDIO), AUDIO_PARAMS, ("whole",),
                 **AUDIO_SERVE)
    for arch in (JAMBA, VLM, AUDIO):
        add_counts(totals, serve_cli(arch))
    return totals

# ---------------------------------------------------------------- lm_train
def free_cache(device):
    if torch.device(device).type == "cuda":
        gc.collect()
        # cuBLAS's workspace (32 MiB, CUBLAS_WORKSPACE_CONFIG) comes from
        # the caching allocator and can pin a segment of GBs that a large
        # product split; it is made again at the next product
        clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
        if clear is not None:
            torch.cuda.synchronize(device)
            clear()
        torch.cuda.empty_cache()


def jamba_train_cut():
    """Jamba-1.5-Large at every published width, cut to 2 layers and 2
    experts (JAMBA_TRAIN_CUTS)."""
    cfg = get_config(JAMBA)
    return cfg.replace(n_layers=2, attn_every=2,
                       moe=dataclasses.replace(cfg.moe, num_experts=2))


def lm_rounds(label, model, params, fl, batches, device, rounds, tokens,
              kept=None):
    """``rounds`` rounds of ``fl`` through ``build_fl_round_step`` from
    ``params`` (flat), each timed on the host clock to a sync, with the
    peak memory over all of them and the launches, counted from 0.
    ``batches(r)`` gives round r's [C, H, B, S] tokens and targets.  Each
    round must give a finite loss and params, a nonzero delta norm, and
    the rounds must move the params.  With ``kept`` (a dict; parallel
    rounds only) the last round's stacked client deltas are kept there
    under "deltas", for the caller to hold the commit on them."""
    start = params
    step = build_fl_round_step(model.loss_fn, get_client_optimizer("sgd"),
                               get_server_optimizer("fedavg"), fl)
    if kept is not None:
        train_clients = step.train_clients

        def keep_last(p, b):
            out = train_clients(p, b)
            if len(walls) == rounds - 1:
                kept["deltas"] = out[0]
            return out
        step.train_clients = keep_last
    C = fl.num_clients
    w = torch.ones(C, device=device)
    m = torch.ones(C, device=device)
    gen = torch.Generator().manual_seed(7)
    cuda = torch.device(device).type == "cuda"
    sync(device)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    launches.reset()
    walls = []
    for r in range(rounds):
        t0 = time.perf_counter()
        params, _, met = step(params, (), batches(r), w, m, gen)
        loss = float(met["client_loss"])          # a read, then a sync
        sync(device)
        walls.append(time.perf_counter() - t0)
        norm = float(met["delta_norm"])
        print(f"lm train {label}: round {r} round_wall_s={walls[-1]:.4f} "
              f"client_loss={loss:.6f} delta_norm={norm:.6g}")
        check(math.isfinite(loss) and all(
            bool(torch.isfinite(v).all()) for v in params.values()),
            f"lm train {label}: non-finite loss or params in round {r}")
        check(norm > 0, f"lm train {label}: round {r} committed a zero delta")
    counts = dict(launches.KERNEL_LAUNCHES)
    moved = sum(not torch.equal(params[k], start[k]) for k in params)
    print(f"lm train {label}: {moved} of {len(params)} leaves moved")
    check(moved > 0, f"lm train {label}: the rounds left the params as they "
                     f"were")
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    print(f"lm train {label}: {rounds} rounds of {C} clients ({fl.client_exec}"
          f", {fl.local_steps} local steps, {tokens}), round walls {walls}, "
          f"max_memory_allocated={peak} ({peak / 1e9:.2f} GB), "
          f"launches={counts}")
    return params, counts, peak


def train_jamba_full_width(device="cuda", cfg=None,
                           n_params=JAMBA_TRAIN_PARAMS, **shape):
    """(b): the cut Jamba in bf16 through sequential rounds, with every
    scan chunk's forward and backward on the card."""
    sh = {**JAMBA_TRAIN, **shape}
    cfg = cfg or jamba_train_cut()
    free_cache(device)
    t0 = time.perf_counter()
    model, params = serve.build(cfg, device, seed=0)
    params = flat_dict(params)
    n = sum(v.numel() for v in params.values())
    print(f"lm train: {cfg.name} at every published width in {cfg.dtype}, "
          f"cut: {'; '.join(JAMBA_TRAIN_CUTS)}: {n} params, built in "
          f"{time.perf_counter() - t0:.1f} s")
    check(n == n_params, f"lm train: {n} params, expected {n_params}")
    C, H, B, S = sh["C"], sh["H"], sh["B"], sh["S"]
    fl = FLConfig(num_clients=C, local_steps=H, client_lr=0.01,
                  client_exec="sequential")
    batches = round_batches(cfg, sh["rounds"], C, H, B, S, 1, device)
    params, counts, _ = lm_rounds("jamba", model, params, fl, batches,
                                  device, sh["rounds"],
                                  f"batch {B} of {S} tokens")
    expect = {k: n * sh["rounds"] for k, n in
              train_launches(model, "sequential", C, H, S).items()}
    check(counts == expect, f"lm train jamba: launches {counts}, expected "
                            f"{expect}")
    del model, params, batches
    free_cache(device)
    return counts


def slstm_share(model, params, batch, device, reps=1):
    """The sLSTM's share of a local step: the host seconds of one
    ``vmap(grad_and_value)`` step of the whole loss over the stacked
    clients, against those of the model's sLSTM mixers alone under the
    same transform on inputs of the same shape, each mixer rematerialised
    as the loss's layer groups are (each to a sync, the fastest of
    ``reps``)."""
    from torch.func import grad_and_value, vmap
    from repro_torch.models.transformer import _GroupRemat
    cfg = model.cfg
    C, _, B, S = batch["tokens"].shape
    stacked = {k: v.expand((C, *v.shape)) for k, v in params.items()}
    names = [k for k in params if "/slstm/" in k]
    x = torch.randn((C, B, S, cfg.d_model), device=device).to(model.dtype)

    def mixer(x, aux, positions, patches, leaves, keys):
        out, _ = xlstm_mod.slstm_apply(dict(zip(keys, leaves)), x,
                                       n_heads=cfg.n_heads)
        return out, aux.view_as(aux)       # an output, not the input itself

    def mixers(p, x):
        total = torch.zeros((), device=x.device)
        for g in range(model.n_groups):
            for k in {n.rsplit("/", 1)[0] for n in names}:
                own = [n for n in names if n.startswith(k + "/")]
                keys = [n.rsplit("/", 1)[1] for n in own]
                out, _ = _GroupRemat.apply(
                    lambda *a, keys=keys: mixer(*a, keys=keys), x,
                    total, None, None, *(p[n][g] for n in own))
                total = total + out.float().sum()
        return total

    def best(fn):
        times = []
        for _ in range(reps):
            sync(device)
            t0 = time.perf_counter()
            fn()
            sync(device)
            times.append(time.perf_counter() - t0)
        return min(times)

    whole = best(lambda: vmap(grad_and_value(model.loss_fn, has_aux=True))(
        stacked, {k: v[:, 0] for k, v in batch.items()}))
    alone = best(lambda: vmap(grad_and_value(mixers))(
        {n: stacked[n] for n in names}, x))
    n_slstm = model.n_groups * sum(s.mixer == "slstm" for s in model.pattern)
    print(f"lm train xlstm: one local step under vmap(grad_and_value) "
          f"{whole:.3f} s, its {n_slstm} sLSTM mixers alone {alone:.3f} s: "
          f"the sLSTM's share of a local step, and so of the round, "
          f"{alone / whole:.3f}")
    return alone / whole


def serve_decode_gaps(label, model, params, prompt, gen, patches=None):
    """``serve.run`` greedy (with the VLM's ``patches``), with the peak
    memory of its prefill and decode steps, then decoding against
    teacher-forced prefill at the first and the last decoded positions:
    max |diff| / max |logit| and whether the argmax agrees everywhere, each
    by position."""
    g = torch.Generator(prompt.device).manual_seed(1)
    cuda = prompt.device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    res = serve.run(model, params, prompt, gen, 0.0, g, patches)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    B, S0, cb = prompt.shape[0], prompt.shape[1], tuple(prompt.shape[2:])
    print(f"lm serve {label}: batch {B}, prompt {tuple(prompt.shape[1:])}, "
          f"{gen} greedy steps: prefill_s={res.prefill_s:.4f} "
          f"decode_s={res.decode_s:.4f} ({res.decode_s / gen * 1e3:.2f} "
          f"ms/token) max_memory_allocated={peak} ({peak / 1e9:.2f} GB)")
    check(all(lg.shape == (B, *cb, model.cfg.vocab)
              and bool(torch.isfinite(lg).all()) for lg in res.logits),
          f"lm serve {label}: non-finite or misshapen logits")
    check(res.ids.shape == (B, gen, *cb), f"lm serve {label}: ids {res.ids}")
    tokens = torch.cat([prompt, torch.from_numpy(res.ids).to(prompt.device)],
                       dim=1)
    extra = {} if patches is None else {"patches": patches}
    gaps, same = {}, {}
    with torch.inference_mode():
        for t in (0, gen - 1):
            n = S0 + t + 1
            want, _ = model.prefill(params, {"tokens": tokens[:, :n],
                                             **extra}, S0 + gen)
            gaps[n] = rel_gap(res.logits[t + 1], want)
            same[n] = bool((res.logits[t + 1].argmax(-1) == want.argmax(-1))
                           .all())
            print(f"lm serve {label}: decode step {t} against the "
                  f"teacher-forced prefill of {n} tokens: max |diff| / max "
                  f"|logit| = {gaps[n]:.4g}, same argmax: {same[n]}")
    return gaps, same


def xlstm_whole(device="cuda", cfg=None, n_params=XLSTM_PARAMS, train=None,
                serve_shape=None):
    """(c): xlstm-125m whole in bf16: parallel rounds with the sLSTM's
    share of a local step, then serving through ``serve.run``."""
    sh = {**XLSTM_TRAIN, **(train or {})}
    sv = {**XLSTM_SERVE, **(serve_shape or {})}
    cfg = cfg or get_config(XLSTM)
    free_cache(device)
    model, nested = serve.build(cfg, device, seed=0)
    params = flat_dict(nested)
    n = sum(v.numel() for v in params.values())
    print(f"lm train: {cfg.name} whole ({cfg.n_layers} blocks, d_model "
          f"{cfg.d_model}, {cfg.dtype}): {n} params")
    check(n == n_params, f"lm train: {n} params, expected {n_params}")
    C, H, B, S = sh["C"], sh["H"], sh["B"], sh["S"]
    fl = FLConfig(num_clients=C, local_steps=H, client_lr=0.01)
    batches = round_batches(cfg, sh["rounds"], C, H, B, S, 2, device)
    _, counts, _ = lm_rounds("xlstm", model, params, fl, batches, device,
                             sh["rounds"], f"batch {B} of {S} tokens")
    check(counts == {"fused_accum": sh["rounds"]},
          f"lm train xlstm: launches {counts}")
    slstm_share(model, params, batches(0), device)
    prompt = torch.randint(0, cfg.vocab, (sv["batch"], sv["prompt_len"]),
                           generator=torch.Generator(device).manual_seed(3),
                           device=device)
    launches.reset()
    gaps, _ = serve_decode_gaps(f"xlstm ({cfg.dtype})", model, nested,
                                prompt, sv["gen"])
    check(max(gaps.values()) <= XLSTM_BF16_DECODE_TOL,
          f"lm serve xlstm: bf16 decoding differs from prefill by {gaps} > "
          f"{XLSTM_BF16_DECODE_TOL}")
    # The tight comparison runs in float32 on the same weights (see
    # XLSTM_DECODE_TOL).
    f32 = build_model(cfg.replace(dtype="float32"))
    wide = nest({k: v.float() for k, v in flat_dict(nested).items()})
    gaps, _ = serve_decode_gaps("xlstm (float32)", f32, wide, prompt,
                                sv["gen"])
    check(max(gaps.values()) <= XLSTM_DECODE_TOL,
          f"lm serve xlstm: decoding differs from prefill by {gaps} > "
          f"{XLSTM_DECODE_TOL}")
    check(not launches.KERNEL_LAUNCHES, "lm serve xlstm: launched "
                                        f"{dict(launches.KERNEL_LAUNCHES)}")
    del f32, wide
    del model, nested, params, batches
    free_cache(device)
    return counts


def local_train_peak(model, params, fl, batch, device, remat: bool) -> int:
    """The peak memory of one parallel local training (the round's
    ``train_clients``, its deltas then dropped) with or without the
    per-group remat (``LM._backbone``'s ``remat``)."""
    step = build_fl_round_step(model.loss_fn, get_client_optimizer("sgd"),
                               get_server_optimizer("fedavg"), fl)
    model._backbone = functools.partial(type(model)._backbone, model,
                                        remat=remat)
    cuda = torch.device(device).type == "cuda"
    try:
        free_cache(device)
        sync(device)
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        out = step.train_clients(params, batch)
        sync(device)
        del out
        return torch.cuda.max_memory_allocated() if cuda else 0
    finally:
        del model._backbone


def train_audio_whole(device="cuda", cfg=None, n_params=AUDIO_PARAMS,
                      tol=FUSED_ACCUM_TOL, **shape):
    """lm_train (d): MusicGen-medium whole in bf16 through parallel rounds
    of the default commit, one fused_accum a round.  Then the last round's
    commit is held at its own size: its [C, R, 256] stack, rebuilt from the
    clients' kept deltas with ``pack_blocks`` as the commit packs them,
    through ``fused_accum_blocks`` against ``ref.fused_accum_ref`` at phase
    2's tolerance (rtol, atol)."""
    sh = {**AUDIO_TRAIN, **shape}
    cfg = cfg or get_config(AUDIO)
    free_cache(device)
    model, nested = serve.build(cfg, device, seed=0)
    params = flat_dict(nested)
    del nested
    n = sum(v.numel() for v in params.values())
    print(f"lm train: {cfg.name} whole ({cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_codebooks} codebooks of {cfg.vocab}, "
          f"{cfg.dtype}): {n} params")
    check(n_params is None or n == n_params,
          f"lm train audio: {n} params, expected {n_params}")
    C, H, B, S = sh["C"], sh["H"], sh["B"], sh["S"]
    fl = FLConfig(num_clients=C, local_steps=H, client_lr=0.01)
    batches = round_batches(cfg, sh["rounds"], C, H, B, S, 4, device)
    kept = {}
    _, counts, peak = lm_rounds(
        "audio", model, params, fl, batches, device, sh["rounds"],
        f"batch {B} of {S} frames x {cfg.n_codebooks} codebooks", kept=kept)
    check(counts == {"fused_accum": sh["rounds"]},
          f"lm train audio: launches {counts}")
    print(f"lm train audio: the round's peak under the per-group remat "
          f"{peak / 1e9:.2f} GB against {AUDIO_PEAK_NO_REMAT / 1e9:.2f} GB "
          f"without it (before the remat)")
    train_peaks = {remat: local_train_peak(model, params, fl, batches(0),
                                           device, remat)
                   for remat in (True, False)}
    print(f"lm train audio: local training alone (one train_clients call), "
          f"max_memory_allocated with the per-group remat "
          f"{train_peaks[True]} ({train_peaks[True] / 1e9:.2f} GB), without "
          f"{train_peaks[False]} ({train_peaks[False] / 1e9:.2f} GB)")
    check(not torch.device(device).type == "cuda"
          or train_peaks[True] < train_peaks[False],
          f"lm train audio: local training peaks at {train_peaks} bytes, "
          f"no lower with the remat")
    del model, params, batches
    deltas = kept.pop("deltas")
    xb, _, _ = kops.pack_blocks(list(deltas.values()), BLOCK)
    del deltas
    free_cache(device)
    # the round's slot vectors: unit weights, no staleness, exponent 0
    w = torch.ones(C, device=device)
    s = torch.zeros(C, device=device)
    got = fused_accum_blocks(xb, w, s, 0.0)
    want = ref.fused_accum_ref(xb, w[:, None], s[:, None], 0.0)
    err = (got - want).abs().max().item()
    ok = torch.allclose(got, want, rtol=tol[0], atol=tol[1])
    print(f"lm train audio: the last round's commit, fused_accum on its "
          f"{list(xb.shape)} f32 stack ({xb.numel()} elements) against its "
          f"plain version: max |diff| = {err:.3g}, max |sum| = "
          f"{want.abs().max().item():.3g}, within (rtol, atol) {tol}: {ok}")
    check(ok, f"lm train audio: fused_accum differs from its plain version "
              f"on the round's stack by {err:.3g}")
    launches.reset()
    del xb, got, want
    free_cache(device)
    return counts


def vlm_train_cut():
    """Llama-3.2-Vision-90B at every published width, cut to one [attn,
    cross] group (VLM_TRAIN_CUTS)."""
    return get_config(VLM).replace(n_layers=2, cross_attn_every=2)


def train_vlm_full_width(device="cuda", cfg=None, n_params=VLM_TRAIN_PARAMS,
                         **shape):
    """lm_train (e): the VLM's [attn, cross] cut in bf16 through sequential
    rounds of the default commit (no kernel: the sequential commit folds
    each client with no launch).  The round fits on one 80 GB card
    (PERF.md), so running out of memory fails the phase."""

    sh = {**VLM_TRAIN, **shape}
    cfg = cfg or vlm_train_cut()
    free_cache(device)
    model, params = serve.build(cfg, device, seed=0)
    params = flat_dict(params)
    n = sum(v.numel() for v in params.values())
    print(f"lm train: {cfg.name} at every published width in {cfg.dtype}, "
          f"cut: {'; '.join(VLM_TRAIN_CUTS)}: {n} params")
    check(n_params is None or n == n_params,
          f"lm train vlm: {n} params, expected {n_params}")
    C, H, B, S = sh["C"], sh["H"], sh["B"], sh["S"]
    fl = FLConfig(num_clients=C, local_steps=H, client_lr=0.01,
                  client_exec="sequential")
    batches = round_batches(cfg, sh["rounds"], C, H, B, S, 5, device)
    _, counts, _ = lm_rounds(
        "vlm", model, params, fl, batches, device, sh["rounds"],
        f"batch {B} of {S} tokens with ({B}, {cfg.n_patches}, "
        f"{cfg.d_model}) patches")
    check(counts == {}, f"lm train vlm: launches {counts}")
    del model, params, batches
    free_cache(device)
    return counts


def lm_train():
    """Phase lm_train: (a) the reduced LMs' rounds on the card against
    the CPU; (b) the cut Jamba at full width; (c) xlstm-125m whole; (d)
    MusicGen-medium whole; (e) the VLM's [attn, cross] cut at full
    width.  Every round rematerialises each layer group."""
    for arch, modes in LM_TRAIN_PARITY:
        check_lm_round_parity(C=4, H=1, B=2, S=64, cfg=reduced(
            get_config(arch)), n_params=None, modes=modes)
    totals = dict(train_jamba_full_width())
    add_counts(totals, xlstm_whole())
    add_counts(totals, train_audio_whole())
    add_counts(totals, train_vlm_full_width())
    return totals


def mesh_rounds(label, loss_fn, params, fl, batches, w, m, mesh, device):
    """One round with no mesh, then the same under ``mesh`` with
    ``client_spmd_axes="data"`` (after the round refuses to build without
    them), each under deterministic algorithms (the card's scatter-adds
    otherwise sum in no fixed order); the new params and metrics must be
    equal, bit for bit.  Returns the meshed round's launches."""
    opt, server = get_client_optimizer("sgd"), get_server_optimizer("fedavg")

    def run(axes):
        step = build_fl_round_step(loss_fn, opt, server, fl,
                                   client_spmd_axes=axes)
        launches.reset()
        out = step(params, (), batches, w, m, torch.Generator().manual_seed(2))
        sync(device)
        return out, dict(launches.KERNEL_LAUNCHES)

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        (plain, _, pm), _ = run(None)
        with shd.use_mesh(mesh):
            try:
                build_fl_round_step(loss_fn, opt, server, fl)
                refused = False
            except ValueError as e:
                refused = "client_spmd_axes" in str(e)
            check(refused, f"mesh {label}: a parallel round under the mesh "
                           f"without client_spmd_axes was not refused")
            (meshed, _, mm), counts = run("data")
    finally:
        torch.use_deterministic_algorithms(False)
    same = all(torch.equal(meshed[k], plain[k]) for k in plain) and all(
        torch.equal(mm[k], pm[k]) for k in pm)
    print(f"mesh {label}: a round under the {mesh.shape} mesh against the "
          f"same round with no mesh: bit for bit {same}; client_loss "
          f"{float(mm['client_loss']):.6f}; launches {counts}")
    check(same, f"mesh {label}: the meshed round differs from the plain one")
    return counts


def start_dry_run(archs=DRYRUN_ARCHS) -> dict:
    """The dry run of ``archs`` (every shape, both production meshes, on
    the meta device) started in background processes, one an arch and
    shape (a train or prefill tag counts its memory at up to four layer
    groups, and the host has the cores), at the lowest priority and one
    thread each, so that the script's own work comes first: it needs no
    card, and each process runs with none visible
    (``CUDA_VISIBLE_DEVICES`` empty), so it can allocate nothing there.
    Each arch's processes write their JSON records to a directory of its
    own, each its output to a file.  Returns the job for
    ``finish_dry_run``."""
    out = tempfile.mkdtemp(prefix="chip_smoke_dryrun_")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1",
               MKL_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src")] + [p for p in (
                       os.environ.get("PYTHONPATH"),) if p]))
    procs = {}
    for arch in archs:
        for shape in INPUT_SHAPES:
            with open(os.path.join(out, f"{arch}__{shape}.log"), "w") as log:
                procs[arch, shape] = subprocess.Popen(
                    [sys.executable, "-m", "repro_torch.launch.dryrun",
                     "--arch", arch, "--shape", shape, "--mesh", "both",
                     "--out", os.path.join(out, arch)], env=env, stdout=log,
                    stderr=subprocess.STDOUT)
                os.setpriority(os.PRIO_PROCESS, procs[arch, shape].pid, 19)
    return dict(procs=procs, archs=archs, out=out, t0=time.perf_counter(),
                started=time.time())


def stop_dry_run(job) -> None:
    """Stop the job's processes that still run and remove its files."""
    if not job:
        return
    for p in job["procs"].values():
        if p.poll() is None:
            p.kill()
            p.wait()
    shutil.rmtree(job["out"], ignore_errors=True)


def collective_keys_ok(rec) -> bool:
    """Whether a dry-run record's ``collective_bytes`` is a dict of ints
    under the reference's kinds (each with or without ``/cross_pod``),
    with a cross-pod entry on a multi-pod train tag (its commit sums over
    ``pod``) and none on a single-pod tag."""
    counts = rec["collective_bytes"]
    kinds = {k.removesuffix("/cross_pod") for k in counts}
    cross = any(k.endswith("/cross_pod") for k in counts)
    train = INPUT_SHAPES[rec["shape"]].kind == "train"
    return (isinstance(counts, dict) and bool(counts)
            and all(isinstance(v, int) and v > 0 for v in counts.values())
            and kinds <= set(dryrun.COLLECTIVE_OPS)
            and (cross if rec["mesh"] == "multi" and train
                 else rec["mesh"] == "multi" or not cross))


# the reference's memory_analysis keys (its compiled step's), less the
# generated code's size, which the port writes as a note
MEMORY_KEYS = ("argument_size_in_bytes", "output_size_in_bytes",
               "temp_size_in_bytes", "alias_size_in_bytes")


def memory_keys_ok(rec) -> bool:
    """Whether a dry-run record's ``memory_analysis`` has the reference's
    four keys as ints, positive where they must be, and its note."""
    ma = rec["memory_analysis"]
    return (all(isinstance(ma[k], int) for k in MEMORY_KEYS)
            and ma["argument_size_in_bytes"] > 0
            and ma["output_size_in_bytes"] > 0
            and ma["temp_size_in_bytes"] > 0
            and "generated_code_size_in_bytes" in ma["note"])


def finish_dry_run(job, timeout_s: float = 600.0) -> None:
    """Wait for ``start_dry_run``'s processes; print each one's lines and
    check that every tag of each arch wrote a record with flops, its
    collectives' bytes by kind (``collective_keys_ok``) and its memory
    analysis (``memory_keys_ok``), or was skipped."""
    t0 = time.perf_counter()
    rcs = {}
    for (arch, shape), p in job["procs"].items():
        rcs.setdefault(arch, []).append(p.wait(timeout=timeout_s))
        print(Path(job["out"], f"{arch}__{shape}.log").read_text(), end="")
    for arch in job["archs"]:
        recs = [json.loads(f.read_text())
                for f in sorted(Path(job["out"], arch).glob("*.json"))]
        check(set(rcs[arch]) == {0} and len(recs) == 2 * len(INPUT_SHAPES)
              and all("skipped" in r or r["cost_analysis"]["flops"] > 0
                      and collective_keys_ok(r) and memory_keys_ok(r)
                      for r in recs),
              f"mesh: dry run of {arch}: exits {rcs[arch]}, records {recs}")
        print(f"mesh: dry run of {arch}, each tag's collective GB a device "
              f"(cross-pod), argument + temp GB a device: " + ", ".join(
                  f"{r['tag']} {dryrun.total_gb(r['collective_bytes']):.2f} "
                  f"({dryrun.total_gb(r['collective_bytes'], True):.2f}), "
                  + "{argument_size_in_bytes:.3g} + {temp_size_in_bytes:.3g}"
                  .format(**{k: v / 1e9 for k, v in
                             r["memory_analysis"].items() if k != "note"})
                  for r in recs if "skipped" not in r))
    ended = max((f.stat().st_mtime for f in Path(job["out"]).rglob("*")),
                default=job["started"])
    print(f"mesh: the dry run of {', '.join(job['archs'])} over every "
          f"shape and both meshes, one process an arch and shape with no "
          f"card visible, at the lowest priority: its last output "
          f"{ended - job['started']:.1f} s after its start (the start of "
          f"round_parity), joined after "
          f"{time.perf_counter() - job['t0']:.1f} s, "
          f"{time.perf_counter() - t0:.1f} s of it waited for here")


def mesh_phase(device="cuda", cnn_round=MESH_ROUND, dry=None):
    """Phase mesh: (a) the CNN's and the reduced Jamba's rounds under the
    1x1 test mesh, each against the same round with no mesh; (b) the dry
    run of DRYRUN_ARCHS, every shape, both production meshes, on the meta
    device: ``dry``, the job ``start_dry_run`` began at the start of
    ``round_parity``, or one started here."""
    job = dry or start_dry_run()
    try:
        totals = mesh_rounds_1x1(device, cnn_round)
        finish_dry_run(job)
    finally:
        stop_dry_run(job)
    return totals


def mesh_rounds_1x1(device, cnn_round) -> dict:
    """Phase mesh (a): the CNN's and the reduced Jamba's rounds under the
    1x1 test mesh, each against the same round with no mesh."""
    from repro_torch.launch.mesh import make_test_mesh
    cuda = torch.device(device).type == "cuda"
    mesh = make_test_mesh(device=torch.device(device).type)
    check(mesh.shape == {"data": 1, "model": 1} and mesh.devices == (
        f"{torch.device(device).type}:0",), f"mesh: the test mesh is {mesh}")
    C, H, B = cnn_round["C"], cnn_round["H"], cnn_round["B"]
    batches, w, m = round_inputs(C, H, B)
    on = lambda a: torch.from_numpy(a).to(device)        # noqa: E731
    fl = dataclasses.replace(train.fl_config(train.build_parser().parse_args(
        MAIN_ARGS)), num_clients=C, local_steps=H)
    model = CNN(CIFAR_CNN)
    params = model.init(torch.Generator().manual_seed(0), device=device)
    totals = mesh_rounds("cnn default", model.loss_fn, params, fl,
                         {k: on(v) for k, v in batches.items()}, on(w),
                         on(m), mesh, device)
    check(not cuda or totals == {"fused_accum": 1},
          f"mesh cnn: launches {totals}")
    cfg = reduced(get_config(JAMBA))
    C, H, B, S = (MESH_LM_ROUND[k] for k in "CHBS")
    lm = build_model(cfg)
    lparams = {k: v.to(device) for k, v in flat_dict(lm.init(
        torch.Generator().manual_seed(0))).items()}
    lfl = FLConfig(num_clients=C, local_steps=H, client_lr=0.05)
    counts = mesh_rounds(
        "reduced jamba", lm.loss_fn, lparams, lfl,
        {k: on(v) for k, v in lm_batches(cfg, (C, H, B), S, 3).items()},
        torch.ones(C, device=device), torch.ones(C, device=device), mesh,
        device)
    expect = {**train_launches(lm, "parallel", C, H, S), "fused_accum": 1}
    check(not cuda or counts == expect, f"mesh jamba: launches {counts}, "
                                        f"expected {expect}")
    add_counts(totals, counts)
    return totals


# ---------------------------------------------------------------- spmd
# The round across processes on the mesh axes (launch/spmd.py,
# launch/mesh.py; (a)-(c) a model axis of 1, (d)-(e) of 2).  One H100
# holds every rank, so the ranks share it over gloo, which stages each
# collective through the host: the phase checks the ranks' results and
# memory, and measures no collective's speed.
SPMD_SIZES = (2, 2, 1)                    # pod x data x model, 4 ranks
# the main path's round (20 clients of batch 16), 2 local steps of its 5: the
# script's time limit is shared
SPMD_ROUND = dict(C=20, H=2, B=16)
SPMD_MODES = (("parallel", ("pod", "data")), ("sequential", None),
              ("pod_sequential", ("pod",)))
SPMD_COMMITS = ("default", "q8_topk_deterministic", "secure_q8_stochastic")
SPMD_ASYNC = "secure_q8_topk_deterministic"
SPMD_DELTA_TOL = 1e-5
SPMD_JAMBA = dict(C=4, H=2, B=2, S=64)
# the reduced Jamba's sharded round against the unsharded one (its MoE
# routes each rank's tokens with the local capacity and enters its aux loss
# per shard): the loss and the params.  Readings of this round
# (chip_compare.py --spmd on an H100): the sound split 1.62e-05 and
# 1.07e-06; the ranks' mean doubled 6.71 and 2.53e-03; their sum in place
# of the mean 20.1 and 7.71e-03
SPMD_JAMBA_TOL = (1e-3, 1e-4)
# (b) against the unsharded round: tests/test_mesh_small.py's bounds for a
# sharded round, the loss and the params
SPMD_SHARDED_TOL = (5e-3, 3e-2)
# (g) and (h): the allocator's peak over a rank's step against the dry
# run's (temp plus the outputs the step allocated); the share covers what
# no dispatched op returns: cuBLAS's workspaces, the few 512-byte blocks
# of torch.tensor constants, an op's own temporaries
MEMORY_TOL = 0.05
# (b): MusicGen-medium whole, sequential, 1 client x 1 step, batch 2 x
# 512 frames x 4 codebooks split over data 2, one round: one client of one
# local step, since each step gathers the weights' data shares over gloo
# twice (forward and recompute) and the script's time limit is shared; (g)
# commits two clients on data shares
AUDIO_SPMD = dict(C=1, H=1, B=2, S=512)
AUDIO_SPMD_SIZES, AUDIO_SPMD_AXES = (2, 1), ("data", "model")
SPMD_LIMIT_BYTES = 76e9                   # what both ranks may hold


# the main path: one rank's launches in the parallel default round
SPMD_MAIN_LAUNCHES = {"fused_accum": 1}

# (d): the reference test's (2, 2, 2) mesh with tensor, expert and head
# parallelism over `model` inside every client, the params held at rest as
# their sanitised specs cut them (launch.specs.shard_params): 8 gloo ranks
# sharing the card
MODEL_SIZES = (2, 2, 2)
# tests/test_mesh_small.py's round (C=4, H=2, B=2, S=16), one local step
# of its two: the script's time limit is shared
MODEL_SHAPE = dict(C=4, H=1, B=2, S=16)
MODEL_CASES = (("granite-3-2b", "sequential"),
               ("granite-3-2b", "pod_sequential"),
               ("qwen3-moe-235b-a22b", "sequential"),
               ("xlstm-125m", "parallel"), ("xlstm-125m", "sequential"),
               (JAMBA, "parallel"))
MODEL_AXES = {"parallel": ("pod", "data"), "pod_sequential": ("pod",),
              "sequential": None}
# the uncompressed f32 round split over model against the same round with
# model dropped (the same batch split, every layer whole)
MODEL_OWN_TOL = 1e-5
# (e): granite-3-2b whole (bf16, every published width, 40 layers), one
# sequential round of 1 client x 2 steps x batch 1 x 1024 tokens (one client:
# the collectives over gloo take most of the round, and the script's time
# limit is shared), on data 1 x model 2; a rank's round peak over the
# no-mesh round's at most
GRANITE = "granite-3-2b"
GRANITE_MODEL = dict(C=1, H=2, B=1, S=1024)
GRANITE_MODEL_SIZES, GRANITE_MODEL_AXES = (1, 2), ("data", "model")
GRANITE_PEAK_RATIO = 0.75
# (f): serving on a `model` axis through serve.run under the mesh.  (i) The
# reduced zoo in f32 on eight gloo ranks of the (2, 2, 2) mesh, batch 4 (a
# process's share 1), a 12-token prompt and 4 decode steps fed given
# tokens; each rank's logits, gathered whole, against the same run with no
# mesh here, as max |diff| over the largest |logit|.  The reduced MoE
# configs (4 experts, top 2, capacity factor 2) drop nothing under the
# local count of prefill or the gathered count of decode.
SERVE_ZOO = (("granite", "granite-3-2b", {}),
             ("granite 16 heads", "granite-3-2b",
              dict(n_heads=16, kv_heads=4, head_dim=16)),
             ("gemma", "gemma-2b", {}),
             ("starcoder2 window 8", "starcoder2-7b",
              dict(sliding_window=8)),
             ("qwen3-moe", "qwen3-moe-235b-a22b", {}), ("jamba", JAMBA, {}),
             ("xlstm", XLSTM, {}), ("vlm", VLM, {}), ("musicgen", AUDIO, {}))
SERVE_ZOO_SIZES = MODEL_SIZES
SERVE_ZOO_SHAPE = dict(batch=4, prompt_len=12, gen=4)
SERVE_SPLIT_TOL = 1e-5
# (ii): the lm_serve Jamba cut (every published width, 8 layers, 8
# experts) on data 1 x model 2, two ranks sharing the card, fed the no-mesh
# run's greedy tokens.  The split's partial sums round otherwise than one
# product, and at a near-tie of two router probabilities that flips a
# token's expert, which moves its logits by their scale (an H100 run routed
# 702 of 4 x 4064 prefill choices and 1 of 4 x 2 at the second decode step
# otherwise, and the served logits came 0.025-0.058 and, at that step, 0.24
# from no mesh's).  A flip moves the later tokens of its row too (the
# Mamba state and the cache carry it), so the served run's logits are held
# to SERVE_DECODE_TOL in each row up to its first flip, and at most
# SERVE_FLIP_SHARE of its routings may flip: a router on wrong inputs would
# agree with no mesh's top 2 of 8 by chance, 1 time in 28.  The gap left
# without flips is held twice: the same run with every token sent to the
# experts the no-mesh run chose (forced_routes), and the cut with 2
# experts, each token sent to both (SERVE_NO_CHOICE), which serves the
# real path with no choice to flip.
SERVE_FLIP_SHARE = 0.25
SERVE_NO_CHOICE = "2 experts, top 2 of 2: no routing choice"
SERVE_MODEL_SIZES, SERVE_MODEL_AXES = (1, 2), ("data", "model")
# (f) (ii) serves a 496-token prompt (3 x 128 + 112: the scan's remainder
# chunk kept) and 8 decode steps (lm_serve's 2032 and 16 before the script
# neared its time limit on the slower hosts: prefill through gloo took 6-7 s
# a run of three)
SERVE_MODEL = dict(batch=SERVE_BATCH, prompt_len=496, gen=8)
# (g): FSDP over data: granite-3-2b whole, one sequential round of
# 2 clients x 1 step x batch 2 x 1024 tokens (batch 2, so that data splits
# it) on data 2 x model 2, four ranks sharing the card, each layer's
# weights gathered over data just before it runs, held to (e)'s
# SPMD_SHARDED_TOL of the same round with no mesh (2 steps before the
# script neared its limit on the slower hosts: each gloo-staged step
# takes ~40 s there)
GRANITE_FSDP = dict(C=2, H=1, B=2, S=1024)
FSDP_SIZES, FSDP_AXES = (2, 2), ("data", "model")
# (h): the SERVE_NO_CHOICE cut served on data 2 x model 2, one row of the
# batch a data rank, fed the no-mesh run's tokens: its decode's MoE sums
# the partial products of its expert F shares over data, and its logits
# are held to SERVE_DECODE_TOL of no mesh's at every step; (f) (ii)'s
# prompt and 2 decode steps (each takes ~7 s through gloo)
SERVE_FSDP = dict(SERVE_MODEL, gen=2)


def spmd_launches_expected(n_leaves=8, C=SPMD_ROUND["C"]) -> dict:
    """One rank's launches over (a)'s CIFAR rounds and commits: parallel,
    the default round (fused_accum, SPMD_MAIN_LAUNCHES) and the three
    commits of the same deltas (fused_accum, plain_commit, secure_commit);
    sequential, the q8
    + top-k commit's per-client top-k and quantize, each leaf's rows split
    over the ranks (the other two launch nothing: no compression, and
    stochastic rounding with float masks); pod_sequential, fused_accum in
    the default round and in two commits, and the q8 + top-k commit's
    compress of the rank's pod sum, leaf by leaf; the secure async buffer
    commit."""
    return {"fused_accum": 2 + 3, "plain_commit": 1, "secure_commit": 1 + 1,
            "topk_sparsify": n_leaves * C + n_leaves,
            "quantize": n_leaves * C + n_leaves}


def spmd_fl(cname, mode, C, H):
    args = train.build_parser().parse_args(MAIN_ARGS + CONFIGS[cname][0])
    return dataclasses.replace(train.fl_config(args), num_clients=C,
                               local_steps=H, client_exec=mode)


def spmd_step(model, cname, mode, axes, C, H):
    return build_fl_round_step(model.loss_fn, get_client_optimizer("sgd"),
                               get_server_optimizer("fedavg"),
                               spmd_fl(cname, mode, C, H), n_pods=2,
                               client_spmd_axes=axes)


def recording(local_train, kept):
    """``local_train`` that also keeps each client's (delta, loss)."""
    def run(params, batch):
        out = local_train(params, batch)
        kept.append(out)
        return out
    return run


def replaying(updates):
    """A ``local_train`` that hands back ``updates`` in turn."""
    it = iter(updates)
    return lambda params, batch: next(it)


def spmd_gen():
    return torch.Generator().manual_seed(5)


def cpu_tree(t):
    return {k: v.detach().cpu() for k, v in t.items()}


def spmd_kernel_calls(deltas, w, m, slot_axes=()):
    """Every commit kernel's entry point on the parallel round's deltas
    (this process's share of the clients where ``slot_axes`` splits them):
    {label: per-leaf results}."""
    leaves = [shd.local_share(deltas[k], slot_axes) for k in sorted(deltas)]
    ids = torch.arange(len(w), dtype=torch.int32)
    seeds = sec.pair_seeds(sec.commit_key(11), ids).to(w.device)
    coef = sec.pair_coef_int(ids, m).to(w.device)
    s = torch.zeros_like(w)
    out = {
        "fused_accum": kops.fused_accum_tree(leaves, w, s, 0.0,
                                             slot_axes=slot_axes),
        "plain_commit": kops.fused_plain_commit_tree(
            leaves, w, s, 0.0, bits=8, k=TOPK_K, slot_axes=slot_axes),
        "secure_commit": kops.fused_secure_commit_tree(
            leaves, w * m, seeds, coef, bits=8, k=TOPK_K,
            slot_axes=slot_axes),
        "secure_commit, stochastic rounding": kops.fused_secure_commit_tree(
            leaves, w * m, seeds, coef, bits=8, slot_axes=slot_axes,
            noise_generator=spmd_gen()),
    }
    if not slot_axes:
        out["quantize"] = [kops.quantize_dequant(deltas["dense1_w"])]
        out["topk_sparsify"] = [kops.topk_sparsify(deltas["dense1_w"],
                                                   k=TOPK_K)]
    return {k: [x.detach().cpu() for x in v] for k, v in out.items()}


def spmd_reference(device, sizes=SPMD_ROUND, jamba=SPMD_JAMBA):
    """(a)'s references, each with no mesh in this process on ``device``:
    the CIFAR rounds of every mode (the clients' deltas kept) and their
    commits of the same deltas in every configuration of SPMD_COMMITS,
    the secure async buffer commit, the reduced Jamba's sequential round
    and every commit kernel's entry point on the parallel deltas."""
    C, H, B = sizes["C"], sizes["H"], sizes["B"]
    nb, w, m = round_inputs(C, H, B)
    on = lambda a: torch.from_numpy(a).to(device)        # noqa: E731
    batches, w, m = {k: on(v) for k, v in nb.items()}, on(w), on(m)
    model = CNN(CIFAR_CNN)
    params = model.init(torch.Generator().manual_seed(0), device=device)
    ref_out = {"params": cpu_tree(params), "batches": cpu_tree(batches),
               "w": w.cpu(), "m": m.cpu(), "rounds": {}, "sizes": sizes,
               "jamba_sizes": jamba}
    for mode, axes in SPMD_MODES:
        step = spmd_step(model, "default", mode, None, C, H)
        commits = {}
        if mode == "parallel":
            deltas, losses = step.train_clients(params, batches)
            for cname in SPMD_COMMITS:
                commits[cname] = spmd_step(model, cname, mode, None, C, H
                                           ).commit(params, (), deltas,
                                                    losses, w, m,
                                                    spmd_gen())[0]
            kept = {"deltas": cpu_tree(deltas), "losses": losses.cpu()}
            ref_out["kernels"] = spmd_kernel_calls(deltas, w, m)
        else:
            updates = []
            step.local_train = recording(step.local_train, updates)
            step(params, (), batches, w, m, spmd_gen())
            for cname in SPMD_COMMITS:
                st = spmd_step(model, cname, mode, None, C, H)
                if mode == "sequential":
                    commits[cname] = st.commit(params, (), iter(updates), w,
                                               m, spmd_gen())[0]
                else:
                    st.local_train = replaying(updates)
                    commits[cname] = st(params, (), batches, w, m,
                                        spmd_gen())[0]
            kept = {"updates": [(cpu_tree(d), loss.cpu())
                                for d, loss in updates]}
        ref_out["rounds"][mode] = dict(kept, commits={
            k: cpu_tree(v) for k, v in commits.items()})
    # the secure async buffer commit of K=8 deltas, as async_path draws them
    args = train.build_parser().parse_args(ASYNC_ARGS
                                           + CONFIGS[SPMD_ASYNC][0])
    rng = np.random.default_rng(3)
    k = ASYNC_K
    a_in = {"deltas": {n: torch.from_numpy((rng.normal(size=(k,) + tuple(
        p.shape)) * 0.01).astype(np.float32)) for n, p in params.items()},
        "w": torch.from_numpy(rng.uniform(100, 400, k).astype(np.float32)),
        "losses": torch.from_numpy(rng.uniform(0.5, 2.5, k).astype(
            np.float32)),
        "s": torch.tensor(ASYNC_STALENESS[:k], dtype=torch.float32)}
    a_in["m"] = torch.ones(k)
    a_in["m"][2] = 0.0
    ref_out["async"] = dict(a_in, new=cpu_tree(spmd_async_commit(
        args, params, a_in, device)))
    # the reduced Jamba, sequential
    cfg = reduced(get_config(JAMBA))
    lm = build_model(cfg)
    lparams = {k: v.to(device) for k, v in flat_dict(lm.init(
        torch.Generator().manual_seed(0))).items()}
    jb = lm_batches(cfg, (jamba["C"], jamba["H"], jamba["B"]), jamba["S"], 3)
    new, loss = spmd_jamba_round(lm, lparams, jb, jamba["C"], jamba["H"],
                                 device)
    ref_out["jamba"] = {"params": cpu_tree(lparams), "batches": jb,
                        "new": cpu_tree(new), "loss": loss}
    sync(device)
    return ref_out


def spmd_async_commit(args, params, a_in, device):
    on = lambda t: t.to(device)                           # noqa: E731
    fl, acfg = train.fl_config(args), train.async_config(args)
    step = build_buffer_commit_step(get_server_optimizer("fedavg"), fl,
                                    acfg)
    k = len(a_in["w"])
    return step(params, (), {n: on(v) for n, v in a_in["deltas"].items()},
                on(a_in["w"]), on(a_in["s"]), on(a_in["losses"]),
                on(a_in["m"]), torch.arange(k, dtype=torch.int32),
                ASYNC_EXPONENT, torch.Generator().manual_seed(7))[0]


def spmd_jamba_round(lm, params, batches_np, C, H, device):
    """The reduced Jamba's sequential round on the rank's shares of the
    whole ``params`` (cut over data: FSDP; the whole params off a mesh):
    (the new params gathered whole, the loss)."""
    fl = FLConfig(num_clients=C, local_steps=H, client_lr=0.05,
                  client_exec="sequential")
    step = build_fl_round_step(lm.loss_fn, get_client_optimizer("sgd"),
                               get_server_optimizer("fedavg"), fl)
    specs = lm.logical_specs
    new, _, met = step(sp.shard_params(params, specs), (),
                       {k: torch.from_numpy(v).to(device)
                        for k, v in batches_np.items()},
                       torch.ones(C, device=device),
                       torch.ones(C, device=device),
                       torch.Generator().manual_seed(2))
    return (sp.gather_params(new, specs, lm.param_specs()),
            float(met["client_loss"]))


def spmd_rank_setup():
    """A rank's numerics as this script's: TF32 off, bf16 reductions in
    float32.  cuDNN's and cuBLAS's default algorithms stay on: that ranks
    repeating the same work (the pods of a sequential round) end with the
    same bits is the round's to keep, not the algorithms'."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def deterministic_algorithms():
    """cuDNN's and cuBLAS's deterministic algorithms from here on, for a
    comparison with a round run elsewhere, which ``spmd_phase`` runs under
    them too: with the ranks under the default ones the batch-split CIFAR
    rounds' deltas came 2.69e-05 from the no-mesh round's on an H100, and
    with the ranks under these but the no-mesh round under the default
    ones a pod_sequential rank's came 1.18e-05 to 2.16e-05 from it on some
    machines (5.96e-08 to 1.43e-06 with both under these), beyond
    SPMD_DELTA_TOL, which is there to measure the split, not the
    algorithms cuDNN picks."""
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    warnings.filterwarnings("ignore", message=".*deterministic.*")


@dataclasses.dataclass(frozen=True)
class Ranks:
    """What one part of the spmd phase asks of a spawn of ranks:
    ``fn(mesh, *args)`` on every rank of a mesh of ``sizes`` over
    ``axes``."""
    label: str
    fn: object
    args: tuple
    sizes: tuple
    axes: tuple = ("pod", "data", "model")
    timeout_s: float = 900.0


def chain_rank(mesh, parts, inits):
    """On one rank, each (fn, args, sizes, axes) of ``parts`` in turn: the
    first on ``mesh``, each later one on a mesh of its own over the same
    processes (its rendezvous ``inits[i]``) where its layout differs.
    Between two parts the rank lets go of the first one's memory and of
    deterministic algorithms.  Returns each part's result (on the CPU)
    and the seconds it took."""
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import spmd
    outs, walls = [], []
    for i, (fn, args, sizes, axes) in enumerate(parts):
        if i:
            torch.use_deterministic_algorithms(False)
            torch.backends.cudnn.deterministic = False
            free_cache(mesh.device)
            if (tuple(sizes), tuple(axes)) != (mesh.sizes, mesh.axis_names):
                torch.distributed.barrier()
                mesh_mod.close_mesh()
                mesh = mesh_mod.init_mesh(
                    init_method=inits[i], rank=mesh.rank,
                    world_size=mesh.size, sizes=tuple(sizes),
                    axes=tuple(axes), device=mesh.device.split(":")[0])
        t0 = time.perf_counter()
        with shd.use_mesh(mesh):
            outs.append(spmd._to_cpu(fn(mesh, *args)))
        walls.append(time.perf_counter() - t0)
    return outs, walls


def spawn_together(kind, *parts) -> list:
    """Run ``parts`` with one spawn of ranks for all of them: each part is
    a generator that does its work here up to ``yield Ranks(...)``, is
    sent its ranks' results (one a rank) and returns its launches.  Each
    spawn pays its ranks' start (importing torch, joining their groups)
    before any work; a switch of mesh inside one costs a rendezvous.
    Every part asks for the same number of ranks."""
    from repro_torch.launch import spmd
    asks = [next(p) for p in parts]
    world = math.prod(asks[0].sizes)
    check(all(math.prod(a.sizes) == world for a in asks),
          f"spmd: one spawn for {[(a.label, a.sizes) for a in asks]}")
    t0 = time.perf_counter()
    per_rank = spmd.run(
        chain_rank, ([(a.fn, a.args, a.sizes, a.axes) for a in asks],
                     [spmd.free_tcp_init() for _ in asks]),
        sizes=asks[0].sizes, axes=asks[0].axes, device=kind,
        all_ranks=True, timeout_s=sum(a.timeout_s for a in asks),
        threads=None)
    walls = [[round(w[i], 1) for _, w in per_rank] for i in range(len(asks))]
    print(f"spmd: one spawn of {world} ranks for "
          f"{', '.join(a.label for a in asks)}: "
          f"{time.perf_counter() - t0:.1f} s; each part's seconds on the "
          f"ranks {walls}")
    results = []
    for i, part in enumerate(parts):
        try:
            part.send([outs[i] for outs, _ in per_rank])
        except StopIteration as done:
            results.append(done.value)
        else:
            raise RuntimeError(f"spmd: {asks[i].label} asked twice")
    return results


def max_gap(got: dict, want: dict) -> float:
    return max(float((got[k].float() - want[k].to(got[k].device).float())
                     .abs().max()) for k in want)


def same_bits(got: dict, want: dict) -> bool:
    return all(torch.equal(got[k], want[k].to(got[k].device)) for k in want)


def replicas_equal(tree) -> bool:
    return all(len(set(v)) == 1 for v in
               shd.replica_checksums(tree).values())


def shares_agree(tree, cuts) -> bool:
    """Every leaf of ``tree`` (the rank's shares) bit for bit the same on
    the ranks that hold the same share of it: its checksums gathered over
    the mesh axes that do not cut it."""
    mesh, groups = shd.get_mesh(), {}
    for k, v in tree.items():
        axes = tuple(a for a in mesh.axis_names if a not in cuts.get(k, {}))
        groups.setdefault(axes, {})[k] = v
    return all(len(set(v)) == 1 for axes, sub in groups.items()
               for v in shd.replica_checksums(sub, axes).values())


# The commits that (d) and (g) run on a rank's delta shares
# (``pipeline.model_commit``): each leaf a share but those whose blocks
# straddle one, which the commit gathers whole; on a 2-slot stack, the
# round's delta and half of it, as the buffer commit would take them.
SHARE_COMMITS = ("q8_topk_deterministic", "secure_q8_topk_deterministic")
SHARE_SLOTS = 2


def share_stack(params, new) -> dict:
    """The 2-slot stack of the round's delta shares: the delta and half of
    it, in the params' dtype."""
    out = {}
    for k in new:
        d = new[k] - params[k]
        out[k] = torch.stack([d, 0.5 * d])
    return out


def share_commit_stage(cname, device):
    """The buffer commit of CONFIGS[cname]'s launcher config on a 2-slot
    stack: unit weights, no staleness, the spmd generator's draws."""
    args = train.build_parser().parse_args(MAIN_ARGS + CONFIGS[cname][0])
    pipe = build_update_pipeline(dataclasses.replace(
        train.fl_config(args), num_clients=SHARE_SLOTS))
    ones = torch.ones(SHARE_SLOTS, device=device)
    return pipe, lambda t: pipe.combine(t, ones, ones, torch.zeros_like(ones),
                                        spmd_gen())


def share_commit(cname, stack, cuts, device) -> tuple:
    """CONFIGS[cname]'s commit on the rank's shares ``stack`` through
    ``model_commit``: (the summed shares, the leaves it gathered whole,
    its wall s, its peak bytes above what was allocated before it)."""
    pipe, stage = share_commit_stage(cname, device)
    cuda = torch.device(device).type == "cuda"
    sync(device)
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
        before = torch.cuda.memory_allocated(device)
    t0 = time.perf_counter()
    with shd.count_commit_gathers() as names:
        out = pipe.model_commit(stage, stack, cuts)[0]
    sync(device)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device) - before if cuda else 0
    return out, list(names), wall, peak


def rest_bytes(model, params, record) -> dict:
    """The rank's param bytes and a FedAdam server state's of its shares
    (made on ``meta``: m and v in float32), each beside the dry run's on
    the mesh record ``record``: {"params": (held, dry), "state": (held,
    dry)}."""
    metas = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
             for k, v in flat_dict(params).items()}
    state = get_server_optimizer("fedadam").init(metas)
    whole = flat_dict(model.param_specs())
    logical = sp.flat_logical(model.logical_specs)
    f32 = {k: torch.empty(v.shape, dtype=torch.float32, device="meta")
           for k, v in whole.items()}
    return {"params": (sp.param_bytes(metas), dryrun.per_device_bytes(
                whole, logical, record)),
            "state": (sp.param_bytes(state["m"]) + sp.param_bytes(
                state["v"]), 2 * dryrun.per_device_bytes(f32, logical,
                                                          record))}


def mesh_record(mesh):
    """The mesh of processes ``mesh`` as a record, for the dry run."""
    return shd.Mesh(mesh.axis_names, mesh.sizes, tuple(range(mesh.size)))


def spmd_rank_main(mesh, ref_path):
    """(a) on one rank: the sequential CIFAR round under the default
    algorithms, its params bit for bit across ranks; then, under the
    deterministic ones, each CIFAR round of SPMD_MODES under the mesh, its
    deltas against the reference's, its commits of the reference's deltas
    bit for bit, the params bit for bit across ranks; the async commit;
    the reduced Jamba; then every commit kernel's entry point, whole and
    client-split, bit for bit.  Returns (checks, walls, launches)."""
    spmd_rank_setup()
    dev, lead = mesh.device, mesh.rank == 0
    ref_in = torch.load(ref_path, weights_only=False)
    on = lambda t: t.to(dev)                              # noqa: E731
    tree = lambda t: {k: on(v) for k, v in t.items()}     # noqa: E731
    params, batches = tree(ref_in["params"]), tree(ref_in["batches"])
    w, m = on(ref_in["w"]), on(ref_in["m"])
    C, H = ref_in["sizes"]["C"], ref_in["sizes"]["H"]
    jamba = ref_in["jamba_sizes"]
    model = CNN(CIFAR_CNN)
    checks, walls = [], {}

    def note(label, ok, detail=""):
        checks.append((label, bool(ok), detail))
        if lead:
            print(f"spmd (a) rank 0: {label}: {'ok' if ok else 'FAILED'} "
                  f"{detail}", flush=True)

    # the round's own invariant under the default algorithms: the pods of
    # a sequential round repeat the same work, and its gradient mean over
    # pod hands them the same bits
    new = spmd_step(model, "default", "sequential", None, C, H)(
        params, (), batches, w, m, spmd_gen())[0]
    note("sequential round under the default algorithms: params bit for "
         "bit across ranks", replicas_equal(new))
    deterministic_algorithms()
    counts = {}
    for mode, axes in SPMD_MODES:
        want = ref_in["rounds"][mode]
        step = spmd_step(model, "default", mode, axes, C, H)
        sync(dev)
        launches.reset()
        t0 = time.perf_counter()
        if mode == "parallel":
            # the main path: its launches counted alone
            share = step.client_share
            deltas, losses = step.train_clients(
                params, {k: share(v) for k, v in batches.items()})
            new = step.commit(params, (), deltas, losses, share(w), share(m),
                              spmd_gen())[0]
            main = dict(launches.KERNEL_LAUNCHES)
            note("parallel round (the main path): its own launches",
                 dev.startswith("cpu") or main == SPMD_MAIN_LAUNCHES,
                 f"launches {main}, expected {SPMD_MAIN_LAUNCHES}")
            gap = max_gap(deltas, {k: share(v) for k, v in
                                   want["deltas"].items()})
        else:
            mine = []
            step.local_train = recording(step.local_train, mine)
            new = step(params, (), batches, w, m, spmd_gen())[0]
            first = 0
            if mode == "pod_sequential":
                first = shd.shard_index(axes) * (C // shd.shard_count(axes))
            gap = max(max_gap(d, want["updates"][first + i][0])
                      for i, (d, _) in enumerate(mine))
        sync(dev)
        walls[mode] = time.perf_counter() - t0
        note(f"{mode} round: the deltas against the no-mesh round's",
             gap <= SPMD_DELTA_TOL, f"max |diff| {gap:.3g}")
        note(f"{mode} round: the params against the no-mesh round's",
             max_gap(new, want["commits"]["default"]) <= SPMD_DELTA_TOL,
             f"max |diff| {max_gap(new, want['commits']['default']):.3g}, "
             f"round_wall_s={walls[mode]:.4f}")
        note(f"{mode} round: params bit for bit across ranks",
             replicas_equal(new))
        for cname in SPMD_COMMITS:
            st = spmd_step(model, cname, mode, axes, C, H)
            if mode == "parallel":
                share = st.client_share
                out = st.commit(params, (), {k: share(on(v)) for k, v in
                                             want["deltas"].items()},
                                share(on(want["losses"])), share(w), share(m),
                                spmd_gen())[0]
            elif mode == "sequential":
                out = st.commit(params, (), ((tree(d), on(loss)) for d, loss
                                             in want["updates"]), w, m,
                                spmd_gen())[0]
            else:
                n = C // shd.shard_count(axes)
                first = shd.shard_index(axes) * n
                st.local_train = replaying(
                    (tree(d), on(loss))
                    for d, loss in want["updates"][first:first + n])
                out = st(params, (), batches, w, m, spmd_gen())[0]
            note(f"{mode} commit {cname} of the no-mesh deltas: bit for bit",
                 same_bits(out, want["commits"][cname]))
            note(f"{mode} commit {cname}: params bit for bit across ranks",
                 replicas_equal(out))
        add_counts(counts, launches.KERNEL_LAUNCHES)
        launches.reset()
    # the secure async buffer commit: K slots whole, rows split
    a_in = ref_in["async"]
    args = train.build_parser().parse_args(ASYNC_ARGS
                                           + CONFIGS[SPMD_ASYNC][0])
    out = spmd_async_commit(args, params, a_in, dev)
    note("secure async buffer commit: bit for bit",
         same_bits(out, a_in["new"]))
    note("secure async buffer commit: params bit for bit across ranks",
         replicas_equal(out))
    add_counts(counts, launches.KERNEL_LAUNCHES)
    # the reduced Jamba, sequential, each client's batch over data
    cfg = reduced(get_config(JAMBA))
    lm = build_model(cfg)
    jz = ref_in["jamba"]
    launches.reset()
    sync(dev)
    t0 = time.perf_counter()
    new, loss = spmd_jamba_round(lm, tree(jz["params"]), jz["batches"],
                                 jamba["C"], jamba["H"], dev)
    sync(dev)
    walls["reduced jamba"] = time.perf_counter() - t0
    jcounts = dict(launches.KERNEL_LAUNCHES)
    gap = max_gap(new, jz["new"])
    note("reduced jamba sequential round against no mesh",
         abs(loss - jz["loss"]) < SPMD_JAMBA_TOL[0]
         and gap < SPMD_JAMBA_TOL[1],
         f"loss {loss:.6f} against {jz['loss']:.6f}, params max |diff| "
         f"{gap:.3g}, round_wall_s={walls['reduced jamba']:.4f}")
    note("reduced jamba: params bit for bit across ranks",
         replicas_equal(new))
    expect = train_launches(lm, "sequential", jamba["C"], jamba["H"],
                            jamba["S"])
    note("reduced jamba: the scan and its backward on the rank's share",
         dev.startswith("cpu") or jcounts == expect,
         f"launches {jcounts}, expected {expect}")
    add_counts(counts, jcounts)
    # every commit kernel on this rank's rows, whole and client-split
    par = ref_in["rounds"]["parallel"]["deltas"]
    for axes in ((), ("pod", "data")):
        got = spmd_kernel_calls(tree(par), w, m, axes)
        for label, leaves in got.items():
            ok = all(torch.equal(g, x) for g, x in
                     zip(leaves, ref_in["kernels"][label]))
            slots = f"split over {axes}" if axes else "whole"
            note(f"kernel {label}, slots {slots}: this rank's rows and the "
                 f"gathered result bit for bit", ok)
    launches.reset()
    return checks, walls, counts


def audio_spmd_rank(mesh, ref_path, reference_loss, cfg, sh_):
    """(b) on one rank: MusicGen-medium drawn leaf by leaf, its share over
    data kept (FSDP), its bytes and a FedAdam state's against the dry
    run's; the sequential round, each client's batch split over data, the
    gradient reductions timed; then the new params against the no-mesh
    round's."""
    spmd_rank_setup()
    dev = mesh.device
    model, nested = serve.build(cfg, dev, seed=0, shard=True)
    params = flat_dict(nested)
    del nested
    sizes = rest_bytes(model, params, mesh_record(mesh))
    cuts = model.leaf_cuts()
    fl = FLConfig(num_clients=sh_["C"], local_steps=sh_["H"], client_lr=0.01,
                  client_exec="sequential")
    batches = round_batches(cfg, 1, sh_["C"], sh_["H"], sh_["B"], sh_["S"],
                            4, dev)(0)
    step = build_fl_round_step(model.loss_fn, get_client_optimizer("sgd"),
                               get_server_optimizer("fedavg"), fl)
    # each local step of each client reduces over data every gradient leaf
    # held whole there and the loss, and every share of a leaf cut there
    # in its gather's backward (a layer's leaf once a layer); the delta's
    # norm sums the cut leaves' squares once: the split ran where this
    # many reductions did
    per_step = 1 + sum(
        1 if shd.DATA not in cuts.get(k, {}) else
        model.n_groups if k.startswith("layers/") else 1 for k in params)
    expect_red = sh_["H"] * sh_["C"] * per_step + 1
    cuda = dev.startswith("cuda")
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    sync(dev)
    t0 = time.perf_counter()
    with shd.timed_collectives() as stats:
        new, _, met = step(params, (), batches, torch.ones(sh_["C"],
                                                           device=dev),
                           torch.ones(sh_["C"], device=dev),
                           torch.Generator().manual_seed(7))
        loss = float(met["client_loss"])
        sync(dev)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    red = (float(stats["seconds"]["psum"]), int(stats["calls"]["psum"]))
    gathers = (float(stats["seconds"]["all_gather"]),
               int(stats["calls"]["all_gather"]))
    del params, batches
    same = shares_agree(new, cuts)
    finite = math.isfinite(loss) and all(bool(torch.isfinite(v).all())
                                         for v in new.values())
    print(f"spmd (b) rank {mesh.rank}: MusicGen-medium sequential round "
          f"round_wall_s={wall:.4f} client_loss={loss:.6f} "
          f"max_memory_allocated={peak} ({peak / 1e9:.2f} GB), gradient "
          f"reductions {red[1]} (expected {expect_red}) taking "
          f"{red[0]:.4f} s, weight gathers {gathers[1]} taking "
          f"{gathers[0]:.4f} s; param bytes {sizes['params'][0]} (dry run "
          f"{sizes['params'][1]}), a FedAdam state's {sizes['state'][0]} "
          f"(dry run {sizes['state'][1]})", flush=True)
    want = sp.shard_params(torch.load(ref_path, mmap=True,
                                      weights_only=False),
                           model.logical_specs)
    gap = max(float((new[k].float() - want[k].to(dev).float()).abs()
                    .max()) for k in want)
    return dict(loss=loss, wall=wall, peak=peak, reduction_s=red[0],
                reductions=red[1], expected_reductions=expect_red,
                replicas_equal=same, finite=finite, sizes=sizes,
                gap=gap, loss_gap=abs(loss - reference_loss))


def nccl_rank(mesh, ref_path):
    """(c) the one-rank NCCL group: NCCL's collectives on the card, then
    the full-width CIFAR parallel round under the 1x1x1 mesh, bit for bit
    against the no-mesh round (both under deterministic algorithms)."""
    import torch.distributed as dist
    spmd_rank_setup()
    deterministic_algorithms()
    dev = mesh.device
    x = torch.arange(4.0, device=dev)
    dist.all_reduce(x)
    parts = [torch.empty_like(x)]
    dist.all_gather(parts, x)
    y = torch.empty_like(x)
    dist.all_to_all_single(y, x)
    coll = bool(torch.equal(x, torch.arange(4.0, device=dev))
                and torch.equal(parts[0], x) and torch.equal(y, x))
    ref_in = torch.load(ref_path, weights_only=False)
    tree = lambda t: {k: v.to(dev) for k, v in t.items()}  # noqa: E731
    model = CNN(CIFAR_CNN)
    step = spmd_step(model, "default", "parallel", ("pod", "data"),
                     ref_in["sizes"]["C"], ref_in["sizes"]["H"])
    launches.reset()
    new, _, _ = step(tree(ref_in["params"]), (), tree(ref_in["batches"]),
                     ref_in["w"].to(dev), ref_in["m"].to(dev), spmd_gen())
    counts = dict(launches.KERNEL_LAUNCHES)
    return dict(collectives=coll, same=same_bits(new, ref_in["nccl_new"]),
                gap=max_gap(new, ref_in["nccl_new"]), launches=counts)


def spmd_phase(device="cuda", sizes=SPMD_ROUND, jamba=SPMD_JAMBA,
               audio_cfg=None, audio_shape=AUDIO_SPMD, granite_cfg=None,
               granite_shape=GRANITE_MODEL, serve_cfg=None,
               serve_shape=SERVE_MODEL, fsdp_shape=GRANITE_FSDP,
               fsdp_serve_shape=SERVE_FSDP):
    """Phase spmd: (a) four gloo ranks sharing the card on a pod 2 x data
    2 x model 1 mesh run the CIFAR rounds, the async commit, the reduced
    Jamba and every commit kernel against the same work with no mesh here;
    (b) MusicGen-medium's sequential round on two ranks, its batch split
    over data; (c) the CIFAR round as a one-rank NCCL group; (d) eight
    ranks on the pod 2 x data 2 x model 2 mesh run the reduced LMs'
    rounds split over model, the main path's CIFAR round and every commit
    kernel with model among the fusion axes; (e) granite-3-2b whole over
    model 2; (f) serving over model: the reduced zoo on the (2, 2, 2)
    mesh and the Jamba cut on data 1 x model 2; (g) granite-3-2b whole
    over data 2 x model 2 (FSDP); (h) the Jamba cut with no routing
    choice served on data 2 x model 2."""
    kind = torch.device(device).type
    totals = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "reference.pt")
        t0 = time.perf_counter()
        # every no-mesh reference under the deterministic algorithms the
        # ranks compare under: (a)'s, (d)'s, and (c)'s parallel default
        # round
        torch.use_deterministic_algorithms(True, warn_only=True)
        torch.backends.cudnn.deterministic = True
        try:
            ref_out = spmd_reference(device, sizes, jamba)
            ref_out["model_cases"] = model_reference(device)
            model = CNN(CIFAR_CNN)
            on = lambda t: {k: v.to(device) for k, v in t.items()}  # noqa
            ref_out["nccl_new"] = cpu_tree(spmd_step(
                model, "default", "parallel", None, sizes["C"],
                sizes["H"])(on(ref_out["params"]), (),
                                 on(ref_out["batches"]),
                                 ref_out["w"].to(device),
                                 ref_out["m"].to(device), spmd_gen())[0])
        finally:
            torch.use_deterministic_algorithms(False)
            torch.backends.cudnn.deterministic = False
        torch.save(ref_out, path)
        del ref_out
        free_cache(device)
        print(f"spmd: the no-mesh references took "
              f"{time.perf_counter() - t0:.1f} s")
        # one spawn for each count of ranks (spawn_together); (c)'s one
        # process runs beside the spawn of four (its start, not its round,
        # is most of its time)
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            nccl = pool.submit(spmd_nccl, path, kind)
            for t in spawn_together(kind, spmd_federated(path, kind, sizes,
                                                         jamba),
                                    spmd_fsdp(device, kind, granite_cfg,
                                              fsdp_shape, serve_cfg,
                                              fsdp_serve_shape)):
                add_counts(totals, t)
            add_counts(totals, nccl.result())
        for t in spawn_together(kind, spmd_model(path, kind),
                                serve_zoo(device, kind)):
            add_counts(totals, t)
    for t in spawn_together(kind,
                            spmd_audio(device, kind, audio_cfg, audio_shape),
                            spmd_granite(device, kind, granite_cfg,
                                         granite_shape),
                            serve_jamba_model(device, kind, serve_cfg,
                                              serve_shape)):
        add_counts(totals, t)
    return totals


def spmd_federated(path, kind, sizes, jamba):
    """(a): four gloo ranks on a pod 2 x data 2 x model 1 mesh against the
    no-mesh references at ``path``."""
    per_rank = yield Ranks("(a)", spmd_rank_main, (path,), SPMD_SIZES)
    totals = {}
    for rank, (checks, walls, counts) in enumerate(per_rank):
        failed = [c for c in checks if not c[1]]
        print(f"spmd (a) rank {rank}: {len(checks) - len(failed)} of "
              f"{len(checks)} checks passed; walls {walls}; launches "
              f"{counts}")
        for label, _, detail in failed:
            print(f"spmd (a) rank {rank}: FAILED {label} {detail}")
        check(not failed, f"spmd (a) rank {rank}: {failed[0][0]} "
                          f"{failed[0][2]}" if failed else "")
        lm = build_model(reduced(get_config(JAMBA)))
        expect = dict(spmd_launches_expected(C=sizes["C"]))
        add_counts(expect, train_launches(
            lm, "sequential", jamba["C"], jamba["H"], jamba["S"]))
        check(kind != "cuda" or counts == expect,
              f"spmd (a) rank {rank}: launches {counts}, expected "
              f"{expect}")
        add_counts(totals, counts)
    print(f"spmd (a): 4 ranks; launches over the ranks {totals}")
    return totals


def spmd_nccl(path, kind):
    from repro_torch.launch import spmd
    t0 = time.perf_counter()
    out = spmd.run(nccl_rank, (path,), sizes=(1, 1, 1), device=kind,
                   backend="nccl" if kind == "cuda" else "gloo",
                   timeout_s=300, threads=None)
    print(f"spmd (c): one {'nccl' if kind == 'cuda' else 'gloo'} rank: "
          f"collectives right {out['collectives']}; the CIFAR parallel "
          f"round bit for bit against no mesh {out['same']} (max |diff| "
          f"{out['gap']:.3g}); launches {out['launches']}; "
          f"{time.perf_counter() - t0:.1f} s")
    check(out["collectives"], "spmd (c): NCCL's collectives are wrong")
    check(out["same"], f"spmd (c): the one-rank round differs from no mesh "
                       f"by {out['gap']:.3g}")
    return out["launches"]


def spmd_audio(device, kind, cfg=None, shape=AUDIO_SPMD):
    """(b): MusicGen-medium's sequential round with no mesh here, then on
    two ranks sharing the card."""
    cfg = cfg or get_config(AUDIO)
    C, H, B, S = (shape[k] for k in "CHBS")
    n = param_bytes(cfg)
    # per rank: params, a client's params, gradients and delta in the
    # model's dtype (four copies), the f32 sum and the f32 contribution
    # beside it, the reduced gradients' copy; activations of its batch
    # share under the per-group remat come on top
    reckon = 4 * n + 2 * (2 * n) + n
    halve = 2 * reckon > SPMD_LIMIT_BYTES
    print(f"spmd (b): reckoned per rank before activations "
          f"{reckon / 1e9:.1f} GB; both ranks {2 * reckon / 1e9:.1f} GB of "
          f"the {SPMD_LIMIT_BYTES / 1e9:.0f} GB allowed: "
          + ("halving the frames" if halve else "the published batch"))
    if halve:
        S //= 2
    free_cache(device)
    model, nested = serve.build(cfg, device, seed=0)
    params = flat_dict(nested)
    del nested
    fl = FLConfig(num_clients=C, local_steps=H, client_lr=0.01,
                  client_exec="sequential")
    batches = round_batches(cfg, 1, C, H, B, S, 4, device)(0)
    step = build_fl_round_step(model.loss_fn, get_client_optimizer("sgd"),
                               get_server_optimizer("fedavg"), fl)
    if kind == "cuda":
        torch.cuda.reset_peak_memory_stats()
    sync(device)
    t0 = time.perf_counter()
    new, _, met = step(params, (), batches, torch.ones(C, device=device),
                       torch.ones(C, device=device),
                       torch.Generator().manual_seed(7))
    loss = float(met["client_loss"])
    sync(device)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if kind == "cuda" else 0
    print(f"spmd (b): MusicGen-medium sequential round with no mesh "
          f"round_wall_s={wall:.4f} client_loss={loss:.6f} "
          f"max_memory_allocated={peak} ({peak / 1e9:.2f} GB)")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "audio.pt")
        torch.save(cpu_tree(new), path)
        del model, params, batches, new, step
        free_cache(device)
        out = yield Ranks("(b)", audio_spmd_rank,
                          (path, loss, cfg, dict(shape, S=S)),
                          AUDIO_SPMD_SIZES, AUDIO_SPMD_AXES)
    lead = dict(out[0], gap=max(o["gap"] for o in out))
    print(f"spmd (b): 2 ranks; loss {lead['loss']:.6f} against "
          f"{loss:.6f}; params max "
          f"|diff| {lead['gap']:.3g}; (held, dry-run) bytes of the params "
          f"and a FedAdam state {[o['sizes'] for o in out]}; per-rank peaks "
          f"{[round(o['peak'] / 1e9, 2) for o in out]} GB; round walls "
          f"{[round(o['wall'], 4) for o in out]} s; gradient reductions "
          f"{[o['reductions'] for o in out]} taking "
          f"{[round(o['reduction_s'], 4) for o in out]} s")
    check(all(o["finite"] for o in out), "spmd (b): a non-finite loss or "
                                         "params")
    check(all(o["replicas_equal"] for o in out),
          "spmd (b): params differ between the ranks that hold a share")
    check(all(v[0] == v[1] for o in out for v in o["sizes"].values()),
          f"spmd (b): (held, dry-run) bytes {[o['sizes'] for o in out]}")
    check(all(o["reductions"] == o["expected_reductions"] for o in out),
          f"spmd (b): gradient reductions {[o['reductions'] for o in out]}, "
          f"expected {out[0]['expected_reductions']} on every rank (is the "
          f"batch split?)")
    check(lead["loss_gap"] < SPMD_SHARDED_TOL[0]
          and lead["gap"] < SPMD_SHARDED_TOL[1],
          f"spmd (b): against no mesh, loss {lead['loss_gap']:.3g}, params "
          f"{lead['gap']:.3g}")
    return {}


def model_fl(mode, compressed: bool):
    """(d)'s round: the reference test's (stochastic q8, FedProx 0.01), or
    uncompressed with the fused FedProx update kernel."""
    return FLConfig(num_clients=MODEL_SHAPE["C"],
                    local_steps=MODEL_SHAPE["H"], client_lr=0.05,
                    fedprox_mu=0.01, client_exec=mode,
                    compression=CompressionConfig(
                        quantize_bits=8 if compressed else 0),
                    use_fused_update=not compressed)


def model_round(lm, params, batches, mode, compressed, axes):
    C = MODEL_SHAPE["C"]
    dev = next(iter(params.values())).device
    step = build_fl_round_step(lm.loss_fn, get_client_optimizer("sgd"),
                               get_server_optimizer("fedavg"),
                               model_fl(mode, compressed), n_pods=2,
                               client_spmd_axes=axes)
    new, _, met = step(params, (), batches, torch.ones(C, device=dev),
                       torch.ones(C, device=dev),
                       torch.Generator().manual_seed(3))
    return new, float(met["client_loss"])


def model_reference(device):
    """(d)'s references with no mesh here on ``device``: each case's
    stochastic q8 round, from the reduced arch's params (seed 0)."""
    out, s = {}, MODEL_SHAPE
    for arch, mode in MODEL_CASES:
        cfg = reduced(get_config(arch))
        lm = build_model(cfg)
        params = {k: v.to(device) for k, v in flat_dict(lm.init(
            torch.Generator().manual_seed(0))).items()}
        nb = lm_batches(cfg, (s["C"], s["H"], s["B"]), s["S"], 1)
        new, loss = model_round(lm, params, {
            k: torch.from_numpy(v).to(device) for k, v in nb.items()}, mode,
            True, None)
        out[(arch, mode)] = {"params": cpu_tree(params), "batches": nb,
                             "new": cpu_tree(new), "loss": loss}
    return out


def model_rank_main(mesh, ref_path):
    """(d) on one rank of the (2, 2, 2) mesh, under deterministic
    algorithms: each reduced case's q8 round against no mesh, its
    uncompressed round against the same round with model dropped, the
    shares bit for bit across the ranks that hold them; the main path's
    parallel CIFAR round against no mesh; every commit kernel with model
    among the fusion axes bit for bit.  Returns (checks, walls, launches
    of the split rounds, launches per case)."""
    spmd_rank_setup()
    deterministic_algorithms()
    dev, lead = mesh.device, mesh.rank == 0
    ref_in = torch.load(ref_path, weights_only=False)
    on = lambda t: t.to(dev)                              # noqa: E731
    tree = lambda t: {k: on(v) for k, v in t.items()}     # noqa: E731
    checks, walls, counts, per_case = [], {}, {}, {}

    def note(label, ok, detail=""):
        checks.append((label, bool(ok), detail))
        if lead:
            print(f"spmd (d) rank 0: {label}: {'ok' if ok else 'FAILED'} "
                  f"{detail}", flush=True)

    s = MODEL_SHAPE
    record = mesh_record(mesh)
    for (arch, mode), want in ref_in["model_cases"].items():
        lm = build_model(reduced(get_config(arch)))
        specs = lm.logical_specs
        cuts = lm.leaf_cuts()
        whole = tree(want["params"])
        local = sp.shard_params(whole, specs)
        sizes = rest_bytes(lm, local, record)
        note(f"{arch} {mode}: the rank's param and FedAdam state bytes "
             f"against the dry run's", all(a == b for a, b in sizes.values()),
             f"(held, dry run) {sizes}")
        batches = {k: on(torch.from_numpy(v)) for k, v in
                   want["batches"].items()}
        axes, label = MODEL_AXES[mode], f"{arch} {mode}"
        launches.reset()
        sync(dev)
        t0 = time.perf_counter()
        new, loss = model_round(lm, local, batches, mode, True, axes)
        sync(dev)
        walls[label] = time.perf_counter() - t0
        gap = max_gap(new, sp.shard_params(tree(want["new"]), specs))
        note(f"{label}: q8 round against no mesh",
             abs(loss - want["loss"]) < SPMD_SHARDED_TOL[0]
             and gap < SPMD_SHARDED_TOL[1],
             f"loss {loss:.6f} against {want['loss']:.6f}, params max "
             f"|diff| {gap:.3g}, round_wall_s={walls[label]:.4f}")
        note(f"{label}: q8 round's shares bit for bit across ranks",
             shares_agree(new, cuts))
        new_u, loss_u = model_round(lm, local, batches, mode, False, axes)
        per_case[label] = dict(launches.KERNEL_LAUNCHES)
        add_counts(counts, per_case[label])
        # the same round with model dropped: the params cut over data
        # alone, every layer whole over model
        over_data = cuts_over(cuts, (shd.DATA,))
        with shd.exclude_axes(shd.MODEL):
            new_x, loss_x = model_round(
                lm, cuts_share(whole, over_data), batches, mode, False, axes)
        launches.reset()
        gap = max_gap(cuts_whole(new_u, over_data), cuts_share(
            cuts_whole(new_x, over_data), cuts_over(cuts, (shd.MODEL,))))
        note(f"{label}: uncompressed round against model dropped",
             abs(loss_u - loss_x) <= MODEL_OWN_TOL and gap <= MODEL_OWN_TOL,
             f"loss {loss_u:.7f} against {loss_x:.7f}, params max |diff| "
             f"{gap:.3g}")
        note(f"{label}: uncompressed shares bit for bit across ranks",
             shares_agree(new_u, cuts))
        if (arch, mode) == MODEL_CASES[0]:
            share_commit_checks(note, label, share_stack(local, new_u), cuts,
                                dev)
            launches.reset()
        if arch == JAMBA:
            expect = train_launches(lm, mode, s["C"], s["H"], s["S"])
            got = {k: per_case[label].get(k, 0) // 2 for k in expect}
            note(f"{label}: the scan and its backward on the rank's "
                 f"channels in each round", dev.startswith("cpu")
                 or got == expect,
                 f"launches {per_case[label]}, expected {expect} a round")
    # the main path's parallel CIFAR round: clients over pod x data, the
    # CNN whole on the model ranks, the commit's rows over all three axes
    params, batches = tree(ref_in["params"]), tree(ref_in["batches"])
    w, m = on(ref_in["w"]), on(ref_in["m"])
    C, H = ref_in["sizes"]["C"], ref_in["sizes"]["H"]
    step = spmd_step(CNN(CIFAR_CNN), "default", "parallel", ("pod", "data"),
                     C, H)
    launches.reset()
    sync(dev)
    t0 = time.perf_counter()
    new = step(params, (), batches, w, m, spmd_gen())[0]
    sync(dev)
    walls["cifar parallel"] = time.perf_counter() - t0
    main = dict(launches.KERNEL_LAUNCHES)
    add_counts(counts, main)
    per_case["cifar parallel"] = main
    gap = max_gap(new, ref_in["rounds"]["parallel"]["commits"]["default"])
    note("parallel CIFAR round (the main path) against no mesh",
         gap <= SPMD_DELTA_TOL, f"max |diff| {gap:.3g}, round_wall_s="
                                f"{walls['cifar parallel']:.4f}")
    note("parallel CIFAR round: its own launches",
         dev.startswith("cpu") or main == SPMD_MAIN_LAUNCHES,
         f"launches {main}, expected {SPMD_MAIN_LAUNCHES}")
    note("parallel CIFAR round: params bit for bit across ranks",
         replicas_equal(new))
    # every commit kernel on this rank's rows of pod x data x model
    par = ref_in["rounds"]["parallel"]["deltas"]
    launches.reset()
    for axes in ((), ("pod", "data")):
        got = spmd_kernel_calls(tree(par), w, m, axes)
        for label, leaves in got.items():
            ok = all(torch.equal(g, x) for g, x in
                     zip(leaves, ref_in["kernels"][label]))
            slots = f"split over {axes}" if axes else "whole"
            note(f"kernel {label}, slots {slots}, fusion axes "
                 f"{shd.fusion_axes()}: bit for bit", ok)
    per_case["commit kernels"] = dict(launches.KERNEL_LAUNCHES)
    launches.reset()
    return checks, walls, counts, per_case


def share_commit_checks(note, label, stack, cuts, dev) -> None:
    """(d): SHARE_COMMITS on the rank's 2-slot stack of a round's delta
    shares, each bit for bit the gathered composition (the cut leaves
    gathered whole, every axis a fusion axis, the result cut back), the
    leaves it gathered printed."""
    live = cuts_over(cuts, [a for a in (shd.DATA, shd.MODEL)
                            if shd.axis_live(a)])
    for cname in SHARE_COMMITS:
        got, names, wall, _ = share_commit(cname, stack, cuts, dev)
        _, stage = share_commit_stage(cname, dev)
        want = cuts_share(stage(cuts_whole(stack, live, 1))[0], live)
        note(f"{label}: {cname} commit on the delta shares against the "
             f"gathered composition, bit for bit", same_bits(got, want),
             f"gathered {len(names)} of {len(live)} cut leaves {names}, "
             f"commit_wall_s={wall:.4f}")


def spmd_model(path, kind):
    """(d): the (2, 2, 2) mesh's ranks on the card."""
    per_rank = yield Ranks("(d)", model_rank_main, (path,), MODEL_SIZES)
    totals = {}
    for rank, (checks, walls, counts, per_case) in enumerate(per_rank):
        failed = [c for c in checks if not c[1]]
        print(f"spmd (d) rank {rank}: {len(checks) - len(failed)} of "
              f"{len(checks)} checks passed; walls "
              f"{ {k: round(v, 4) for k, v in walls.items()} }; launches "
              f"{per_case}")
        for label, _, detail in failed:
            print(f"spmd (d) rank {rank}: FAILED {label} {detail}")
        check(not failed, f"spmd (d) rank {rank}: {failed[0][0]} "
                          f"{failed[0][2]}" if failed else "")
        add_counts(totals, counts)
    print(f"spmd (d): 8 ranks on a pod 2 x data 2 x model 2 mesh; the "
          f"split rounds' launches over the ranks {totals}")
    return totals


def granite_model_rank(mesh, ref_path, cfg, sh_):
    """(e) on one rank of data 1 x model 2: granite-3-2b drawn whole,
    held as its share, its bytes against the dry run's; the sequential
    round with the collectives timed; its share against no mesh's."""
    spmd_rank_setup()
    dev = mesh.device
    model, nested = serve.build(cfg, dev, seed=0)
    specs = model.logical_specs
    params = sp.shard_params(flat_dict(nested), specs)
    del nested
    free_cache(dev)
    held = sp.param_bytes(params)
    dry = dryrun.per_device_bytes(model.param_specs(), specs, shd.Mesh(
        GRANITE_MODEL_AXES, GRANITE_MODEL_SIZES, tuple(range(2))))
    C, H, B, S = (sh_[k] for k in "CHBS")
    batches = round_batches(cfg, 1, C, H, B, S, 4, dev)(0)
    step = build_fl_round_step(model.loss_fn, get_client_optimizer("sgd"),
                               get_server_optimizer("fedavg"), FLConfig(
                                   num_clients=C, local_steps=H,
                                   client_lr=0.01, client_exec="sequential"))
    cuda = dev.startswith("cuda")
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    sync(dev)
    t0 = time.perf_counter()
    with shd.timed_collectives() as stats:
        new, _, met = step(params, (), batches, torch.ones(C, device=dev),
                           torch.ones(C, device=dev),
                           torch.Generator().manual_seed(7))
        loss = float(met["client_loss"])
        sync(dev)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    want = sp.shard_params(torch.load(ref_path, mmap=True,
                                      weights_only=False), specs)
    gap = max(float((new[k].float() - want[k].to(dev).float()).abs().max())
              for k in want)
    finite = math.isfinite(loss) and all(bool(torch.isfinite(v).all())
                                         for v in new.values())
    coll = {k: (round(float(stats["seconds"][k]), 4),
                int(stats["calls"][k])) for k in stats["calls"]}
    print(f"spmd (e) rank {mesh.rank}: {GRANITE} over model 2: holds "
          f"{held} param bytes (dry run {dry}); round_wall_s={wall:.4f} "
          f"client_loss={loss:.6f} max_memory_allocated={peak} "
          f"({peak / 1e9:.2f} GB); collectives (s, calls) {coll}",
          flush=True)
    return dict(held=held, dry=dry, loss=loss, wall=wall, peak=peak,
                gap=gap, finite=finite, collectives=coll)


def spmd_granite(device, kind, cfg=None, shape=GRANITE_MODEL):
    """(e): granite-3-2b's sequential round with no mesh here, then on
    data 1 x model 2, two ranks sharing the card."""
    cfg = cfg or get_config(GRANITE)
    C, H, B, S = (shape[k] for k in "CHBS")
    free_cache(device)
    model, nested = serve.build(cfg, device, seed=0)
    params = flat_dict(nested)
    del nested
    batches = round_batches(cfg, 1, C, H, B, S, 4, device)(0)
    step = build_fl_round_step(model.loss_fn, get_client_optimizer("sgd"),
                               get_server_optimizer("fedavg"), FLConfig(
                                   num_clients=C, local_steps=H,
                                   client_lr=0.01, client_exec="sequential"))
    if kind == "cuda":
        torch.cuda.reset_peak_memory_stats()
    sync(device)
    t0 = time.perf_counter()
    new, _, met = step(params, (), batches, torch.ones(C, device=device),
                       torch.ones(C, device=device),
                       torch.Generator().manual_seed(7))
    loss = float(met["client_loss"])
    sync(device)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if kind == "cuda" else 0
    n = sp.param_bytes(params)
    print(f"spmd (e): {GRANITE} whole ({n} param bytes) sequential round "
          f"with no mesh round_wall_s={wall:.4f} client_loss={loss:.6f} "
          f"max_memory_allocated={peak} ({peak / 1e9:.2f} GB)")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "granite.pt")
        torch.save(cpu_tree(new), path)
        del model, params, batches, new, step
        free_cache(device)
        out = yield Ranks("(e)", granite_model_rank, (path, cfg, shape),
                          GRANITE_MODEL_SIZES, GRANITE_MODEL_AXES)
    ratios = [o["peak"] / peak if peak else 0.0 for o in out]
    print(f"spmd (e): 2 ranks; losses "
          f"{[round(o['loss'], 6) for o in out]} against "
          f"{loss:.6f}; params max |diff| {[o['gap'] for o in out]}; rank "
          f"peaks {[o['peak'] for o in out]} against no mesh's {peak} "
          f"(ratios {[round(r, 4) for r in ratios]}); param bytes "
          f"{[o['held'] for o in out]} against the dry run's "
          f"{[o['dry'] for o in out]} and whole {n}; round walls "
          f"{[round(o['wall'], 4) for o in out]} s")
    check(all(o["finite"] for o in out), "spmd (e): a non-finite loss or "
                                         "params")
    check(all(o["held"] == o["dry"] for o in out),
          f"spmd (e): param bytes {[o['held'] for o in out]} against the "
          f"dry run's {[o['dry'] for o in out]}")
    check(all(abs(o["loss"] - loss) < SPMD_SHARDED_TOL[0]
              and o["gap"] < SPMD_SHARDED_TOL[1] for o in out),
          f"spmd (e): against no mesh, losses "
          f"{[o['loss'] for o in out]} ({loss}), params "
          f"{[o['gap'] for o in out]}")
    check(kind != "cuda" or all(r <= GRANITE_PEAK_RATIO for r in ratios),
          f"spmd (e): rank peaks over no mesh's {ratios}, above "
          f"{GRANITE_PEAK_RATIO}")
    return {}


def granite_fsdp_rank(mesh, ref_path, cfg, sh_):
    """(g) on one rank of data 2 x model 2: granite-3-2b drawn leaf by
    leaf, its share over data and model kept, its bytes and a FedAdam
    state's against the dry run's; the sequential round, each client's
    batch split over data and each layer's weights gathered over data
    just before it runs, the collectives timed; its share against no
    mesh's and its replicas'."""
    spmd_rank_setup()
    dev = mesh.device
    model, nested = serve.build(cfg, dev, seed=0, shard=True)
    specs = model.logical_specs
    params = flat_dict(nested)
    del nested
    free_cache(dev)
    sizes = rest_bytes(model, params, mesh_record(mesh))
    cuts = model.leaf_cuts()
    C, H, B, S = (sh_[k] for k in "CHBS")
    batches = round_batches(cfg, 1, C, H, B, S, 4, dev)(0)
    fl = FLConfig(num_clients=C, local_steps=H, client_lr=0.01,
                  client_exec="sequential")
    step = build_fl_round_step(model.loss_fn, get_client_optimizer("sgd"),
                               get_server_optimizer("fedavg"), fl)
    cuda = dev.startswith("cuda")
    args = (params, (), batches, torch.ones(C, device=dev),
            torch.ones(C, device=dev))
    sync(dev)
    before = torch.cuda.memory_allocated(dev) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    with shd.timed_collectives() as stats, \
            shd.count_collectives() as moved, \
            memory.count_memory(torch.device(dev).type) as mem:
        out = step(*args, torch.Generator().manual_seed(7))
        new, _, met = out
        loss = float(met["client_loss"])
        sync(dev)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    dry_moved, dry_mem = dryrun.count_step(
        cfg, InputShape("spmd (g)", S, C * B, "train"), mesh, fl=fl)
    moved = (dict(moved), dry_moved, float(sum(stats["seconds"].values())),
             "of collectives")
    held = (mem.analysis(args, out), dry_mem,
            peak - before if cuda else None)
    del out, args
    stack = share_stack(params, new)
    del params, batches
    want = sp.shard_params(torch.load(ref_path, mmap=True,
                                      weights_only=False), specs)
    gap = max(float((new[k].float() - want[k].to(dev).float()).abs().max())
              for k in want)
    finite = math.isfinite(loss) and all(bool(torch.isfinite(v).all())
                                         for v in new.values())
    same = shares_agree(new, cuts)
    coll = {k: (round(float(stats["seconds"][k]), 4),
                int(stats["calls"][k])) for k in stats["calls"]}
    print(f"spmd (g) rank {mesh.rank} {mesh.coords}: {GRANITE} over data 2 "
          f"x model 2: param bytes {sizes['params'][0]} (dry run "
          f"{sizes['params'][1]}), a FedAdam state's {sizes['state'][0]} "
          f"(dry run {sizes['state'][1]}); round_wall_s={wall:.4f} "
          f"client_loss={loss:.6f} max_memory_allocated={peak} "
          f"({peak / 1e9:.2f} GB); collectives (s, calls) {coll}; "
          f"{moved_line(moved)}; {memory_line(held)}", flush=True)
    del want
    commits = fsdp_share_commits(mesh, stack, cuts, dev)
    return dict(sizes=sizes, loss=loss, wall=wall, peak=peak, gap=gap,
                finite=finite, same=same, collectives=coll, commits=commits,
                moved=moved, memory=held)


def memory_line(held) -> str:
    """A rank's (live memory analysis, the dry run's of the same step, the
    allocator's peak over the step above what was allocated before it, or
    None off the card) as a line."""
    live, dry, alloc = held
    return (f"memory analysis {live} (dry run {dry})"
            + ("" if alloc is None else
               f"; max_memory_allocated over the step {alloc} against the "
               f"dry peak {dry['peak_size_in_bytes']}: "
               f"{alloc / dry['peak_size_in_bytes']:.4f}"))


def memory_ok(held) -> bool:
    """(a) the live count equals the dry one in all four numbers and the
    peak; (b) on the card the allocator's peak over the step lies within
    MEMORY_TOL of the dry peak (temp plus the outputs it allocated)."""
    live, dry, alloc = held
    return live == dry and (alloc is None or abs(
        alloc - dry["peak_size_in_bytes"]) <= MEMORY_TOL
        * dry["peak_size_in_bytes"])


def moved_line(moved) -> str:
    """A rank's (live bytes by kind, the dry run's count of the same
    step, the seconds they took, what those seconds are) as a line: the
    bytes, and gloo's rate over them."""
    live, dry, seconds, what = moved
    total = sum(live.values())
    return (f"collective bytes {live} (dry run {dry}): {total / 1e9:.3f} GB "
            f"in {seconds:.2f} s {what}, "
            f"{total / 1e9 / max(seconds, 1e-9):.3f} GB/s")


def fsdp_share_commits(mesh, stack, cuts, dev) -> dict:
    """(g)'s SHARE_COMMITS on the rank's 2-slot stack of granite's delta
    shares, one after the other, with each commit's wall and its peak
    above what the rank held before; each leaf that the commit did not
    gather held bit for bit against the same commit with the mesh dropped
    on the shares taken as whole leaves (exact where no block straddles a
    shard).  The ranks take turns, so that the card holds fewer ranks'
    commits at once: the ranks of a turn differ along the axes that cut
    a straddling leaf's last dim (its gather runs over them; at
    granite-3-2b's widths ``unembed``'s over model: two turns of two)."""
    import torch.distributed as dist
    pipe, _ = share_commit_stage(SHARE_COMMITS[0], dev)
    block = pipe.cfg.compression.block
    together = {a for k, c in cuts.items()
                if not block_aligned(stack[k].shape[1:], c, block)
                for a, d in c.items() if d == stack[k].ndim - 2}
    turn_axes = tuple(a for a in mesh.axis_names if a not in together)
    out = {}
    for turn in range(shd.shard_count(turn_axes)):
        if shd.shard_index(turn_axes) == turn:
            for cname in SHARE_COMMITS:
                got, names, wall, peak = share_commit(cname, stack, cuts, dev)
                _, stage = share_commit_stage(cname, dev)
                with shd.use_mesh(None):
                    alone = stage(stack)[0]
                kept = [k for k in got if k not in names]
                out[cname] = dict(
                    names=names, wall=wall, peak=peak, kept=len(kept),
                    same=all(torch.equal(got[k], alone[k]) for k in kept))
                print(f"spmd (g) rank {mesh.rank} {mesh.coords}: {cname} "
                      f"commit of {SHARE_SLOTS} slots on the delta shares: "
                      f"gathered {names}, the {len(kept)} other leaves bit "
                      f"for bit the commit with no mesh on the shares: "
                      f"{out[cname]['same']}; commit_wall_s={wall:.4f} "
                      f"commit_peak_bytes={peak} ({peak / 1e9:.2f} GB)",
                      flush=True)
                del got, alone
                free_cache(dev)
        dist.barrier()
    return out


def fsdp_ranks(mesh, granite, served):
    """(g) then (h) on one rank of data 2 x model 2, in one spawn:
    ``granite_fsdp_rank`` of ``granite`` (reference path, config, shape),
    its memory freed, then ``jamba_model_rank`` of ``served`` (reference
    path, config, shape).  Returns (g's result, h's)."""
    g = granite_fsdp_rank(mesh, *granite)
    free_cache(mesh.device)
    path, cfg, shape = served
    h = jamba_model_ranks(mesh, [(path, cfg)], shape, "spmd (h)", False,
                          count=True)[0]
    return g, h


def granite_no_mesh(cfg, device, kind, shape, path) -> tuple:
    """(g)'s sequential round with no mesh here, its new params saved to
    ``path`` for the ranks: (loss, peak, param bytes)."""
    C, H, B, S = (shape[k] for k in "CHBS")
    free_cache(device)
    model, nested = serve.build(cfg, device, seed=0)
    params = flat_dict(nested)
    del nested
    batches = round_batches(cfg, 1, C, H, B, S, 4, device)(0)
    step = build_fl_round_step(model.loss_fn, get_client_optimizer("sgd"),
                               get_server_optimizer("fedavg"), FLConfig(
                                   num_clients=C, local_steps=H,
                                   client_lr=0.01, client_exec="sequential"))
    if kind == "cuda":
        torch.cuda.reset_peak_memory_stats()
    sync(device)
    t0 = time.perf_counter()
    new, _, met = step(params, (), batches, torch.ones(C, device=device),
                       torch.ones(C, device=device),
                       torch.Generator().manual_seed(7))
    loss = float(met["client_loss"])
    sync(device)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if kind == "cuda" else 0
    n = sp.param_bytes(params)
    print(f"spmd (g): {GRANITE} whole ({n} param bytes) sequential round of "
          f"batch {B} x {S} with no mesh round_wall_s={wall:.4f} "
          f"client_loss={loss:.6f} max_memory_allocated={peak} "
          f"({peak / 1e9:.2f} GB)")
    torch.save(cpu_tree(new), path)
    del model, params, batches, new, step
    free_cache(device)
    return loss, peak, n


def straddling(cfg, sizes, axes) -> list:
    """The leaves of ``cfg``'s params cut at rest on a ``sizes`` mesh of
    ``axes`` whose blocks straddle a shard at SHARE_COMMITS' block: the
    leaves their commits gather."""
    model = build_model(cfg)
    shapes = {k: tuple(v.shape) for k, v in
              flat_dict(model.param_specs()).items()}
    record = shd.Mesh(tuple(axes), tuple(sizes),
                      tuple(range(math.prod(sizes))))
    block = share_commit_stage(SHARE_COMMITS[0], "cpu")[0].cfg.compression \
        .block
    out = []
    for k, c in sp.leaf_cuts(shapes, model.logical_specs, record).items():
        share = list(shapes[k])
        for a, d in c.items():
            share[d] //= record.shape[a]
        if not block_aligned(share, c, block):
            out.append(k)
    return sorted(out)


def check_granite_fsdp(out, loss, peak, n, item, expect) -> None:
    """(g)'s checks over its ranks' results (``n`` the whole params'
    bytes, ``item`` the bytes of an element, ``expect`` the leaves whose
    blocks straddle a shard)."""
    peaks = [o["peak"] for o in out]
    print(f"spmd (g): losses {[round(o['loss'], 6) for o in out]} against "
          f"{loss:.6f}; params max |diff| {[o['gap'] for o in out]}; rank "
          f"peaks {peaks} ({sum(peaks) / 1e9:.2f} GB together) against no "
          f"mesh's {peak}; (held, dry-run) bytes of the params and a FedAdam "
          f"state {[o['sizes'] for o in out]}, whole {n}; round walls "
          f"{[round(o['wall'], 4) for o in out]} s")
    check(all(o["finite"] for o in out), "spmd (g): a non-finite loss or "
                                         "params")
    check(all(v[0] == v[1] for o in out for v in o["sizes"].values()),
          f"spmd (g): (held, dry-run) bytes {[o['sizes'] for o in out]}")
    check(all(o["moved"][0] == o["moved"][1] for o in out),
          f"spmd (g): the ranks' collective bytes against the dry run's "
          f"{[o['moved'][:2] for o in out]}")
    check(all(memory_ok(o["memory"]) for o in out),
          f"spmd (g): the ranks' memory against the dry run's "
          f"{[o['memory'] for o in out]}")
    check(all(o["same"] for o in out),
          "spmd (g): params differ between the ranks that hold a share")
    check(all(abs(o["loss"] - loss) < SPMD_SHARDED_TOL[0]
              and o["gap"] < SPMD_SHARDED_TOL[1] for o in out),
          f"spmd (g): against no mesh, losses "
          f"{[o['loss'] for o in out]} ({loss}), params "
          f"{[o['gap'] for o in out]}")
    # the parent's gathered form: each slot's delta gathered whole in the
    # params' dtype, its f32 pack, and the f32 sum
    whole = n // item
    gathered = SHARE_SLOTS * whole * (item + 4) + 4 * whole
    for cname in SHARE_COMMITS:
        got = [o["commits"][cname] for o in out]
        print(f"spmd (g): {cname} on the delta shares: gathered leaves "
              f"{[g['names'] for g in got]}; commit walls "
              f"{[round(g['wall'], 4) for g in got]} s; rank commit peaks "
              f"{[g['peak'] for g in got]} bytes, against the "
              f"{gathered} ({gathered / 1e9:.2f} GB) a rank of the gathered "
              f"form (reckoned: {SHARE_SLOTS} slots of {whole} elements "
              f"gathered, packed as f32 and summed)")
        check(all(sorted(g["names"]) == expect for g in got),
              f"spmd (g): {cname} gathered {[g['names'] for g in got]}, "
              f"not {expect}")
        check(all(g["same"] for g in got),
              f"spmd (g): {cname}: a leaf that no block straddles differs "
              f"from the commit with no mesh on the shares")


def spmd_fsdp(device, kind, granite_cfg=None, granite_shape=GRANITE_FSDP,
              serve_cfg=None, serve_shape=SERVE_FSDP) -> dict:
    """(g) and (h), FSDP over data on data 2 x model 2, four ranks sharing
    the card in one spawn: granite-3-2b's sequential round and the
    SERVE_NO_CHOICE Jamba cut served, each first with no mesh here."""
    granite_cfg = granite_cfg or get_config(GRANITE)
    cfg = no_choice_cut(serve_cfg or jamba_cut())
    cfg_all = build_model(cfg)
    with tempfile.TemporaryDirectory() as tmp:
        paths = [os.path.join(tmp, f) for f in ("granite.pt", "served.pt")]
        loss, peak, n = granite_no_mesh(granite_cfg, device, kind,
                                        granite_shape, paths[0])
        serve_no_mesh(cfg, device, kind, serve_shape, paths[1])
        # the ranks' draws map and unmap pages (expandable segments), as
        # in (f) (ii)
        prev = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
        os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
        try:
            out = yield Ranks("(g) and (h)", fsdp_ranks,
                              ((paths[0], granite_cfg, granite_shape),
                               (paths[1], cfg, serve_shape)),
                              FSDP_SIZES, FSDP_AXES)
        finally:
            if prev is None:
                del os.environ["PYTORCH_CUDA_ALLOC_CONF"]
            else:
                os.environ["PYTORCH_CUDA_ALLOC_CONF"] = prev
    expect = straddling(granite_cfg, FSDP_SIZES, FSDP_AXES)
    # at granite-3-2b's widths: unembed alone, its 49408 columns in two
    # shares of 96.5 blocks
    check(granite_cfg != get_config(GRANITE) or expect == ["unembed"],
          f"spmd (g): granite-3-2b's straddling leaves {expect}")
    check_granite_fsdp([g for g, _ in out], loss, peak, n, torch.finfo(
        getattr(torch, granite_cfg.dtype)).bits // 8, expect)
    n_moe = sum(s.ffn == "moe" for s in cfg_all.pattern)
    di = cfg.mamba.expand * cfg.d_model // FSDP_SIZES[1]
    return check_served_fsdp(cfg, [h for _, h in out], serve_shape,
                             scan_chunks(cfg_all, serve_shape["prompt_len"]),
                             n_moe, di, kind == "cuda")


def zoo_config(arch, changes):
    return reduced(get_config(arch)).replace(**changes)


def serve_forced(cfg, device, shape, shard):
    """``serve.run`` of ``cfg`` (seed-0 params drawn on ``device``; with
    ``shard`` each rank keeps its share) on a seeded prompt, its decode
    steps fed given tokens: the logits on the CPU, and the tokens a greedy
    run would draw from them."""
    B, S0, T = (shape[k] for k in ("batch", "prompt_len", "gen"))
    model, params = serve.build(cfg, device, seed=0, shard=shard)
    toks, patches = lm_inputs(cfg, (B,), S0 + T, 3)
    res = serve.run(model, params, toks[:, :S0], T, 0.0,
                    torch.Generator(device), patches, forced=toks[:, S0:])
    logits = [lg.float().cpu() for lg in res.logits]
    return logits, torch.stack([lg.argmax(-1) for lg in logits])


def serve_zoo_rank(mesh, ref_path, shape):
    """(f) (i) on one rank: every zoo case served on its shares, its logits
    against no mesh's, the greedy tokens' checksums across the ranks."""
    spmd_rank_setup()
    ref = torch.load(ref_path, weights_only=False)
    out = {}
    for label, arch, changes in SERVE_ZOO:
        launches.reset()
        logits, toks = serve_forced(zoo_config(arch, changes), mesh.device,
                                    shape, True)
        sync(mesh.device)
        counts = dict(launches.KERNEL_LAUNCHES)
        gap = max(rel_gap(g, w) for g, w in zip(logits, ref[label]))
        sums = shd.replica_checksums({"tokens": toks})["tokens"]
        out[label] = dict(gap=gap, same=len(set(sums)) == 1, launches=counts,
                          finite=all(bool(torch.isfinite(g).all())
                                     for g in logits))
    launches.reset()
    return out


def serve_zoo(device, kind, sizes=SERVE_ZOO_SIZES, shape=SERVE_ZOO_SHAPE):
    """(f) (i): the reduced zoo with no mesh here, then on the ranks of a
    ``sizes`` mesh."""
    ref = {label: serve_forced(zoo_config(arch, changes), device, shape,
                               False)[0]
           for label, arch, changes in SERVE_ZOO}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "serve_zoo.pt")
        torch.save(ref, path)
        del ref
        out = yield Ranks("(f) (i)", serve_zoo_rank, (path, shape), sizes,
                          timeout_s=600)
    n_scan = scan_chunks(build_model(reduced(get_config(JAMBA))),
                         shape["prompt_len"])
    totals = {}
    for label, _, _ in SERVE_ZOO:
        gaps = [o[label]["gap"] for o in out]
        print(f"spmd (f) (i) {label}: prefill and {shape['gen']} decode "
              f"steps on {len(out)} ranks, max |diff| / max |logit| against "
              f"no mesh per rank {[float(f'{g:.3g}') for g in gaps]}; "
              f"greedy tokens "
              f"equal across ranks {all(o[label]['same'] for o in out)}; "
              f"launches {[o[label]['launches'] for o in out]}")
        check(all(o[label]["finite"] for o in out),
              f"spmd (f) (i) {label}: non-finite logits")
        check(max(gaps) <= SERVE_SPLIT_TOL,
              f"spmd (f) (i) {label}: {max(gaps):.3g} from no mesh")
        check(all(o[label]["same"] for o in out),
              f"spmd (f) (i) {label}: the ranks draw different tokens")
        expect = {"selective_scan": n_scan} if label == "jamba" else {}
        check(kind != "cuda" or all(o[label]["launches"] == expect
                                    for o in out),
              f"spmd (f) (i) {label}: launches "
              f"{[o[label]['launches'] for o in out]}, expected {expect}")
        for o in out:
            add_counts(totals, o[label]["launches"])
    print(f"spmd (f) (i): {len(SERVE_ZOO)} families on a {sizes} mesh")
    return totals


def no_choice_cut(cfg):
    """``cfg`` with 2 experts, each token sent to both (SERVE_NO_CHOICE)."""
    return cfg.replace(moe=dataclasses.replace(cfg.moe, num_experts=2))


def jamba_model_ranks(mesh, runs, shape, label="spmd (f) (ii)",
                      routed_first=True, count=False):
    """(f) (ii) on one rank of data 1 x model 2, or (h) on one of data 2
    x model 2: ``jamba_model_rank`` for each (reference file, config) of
    ``runs``, with ``routed_first`` the first also routed as the no-mesh
    run routed, and with ``count`` each run's collective bytes beside the
    dry run's; each run's params freed before the next."""
    spmd_rank_setup()
    outs = []
    for i, (path, cfg) in enumerate(runs):
        outs.append(jamba_model_rank(mesh, path, cfg, shape, label,
                                     routed_alike=routed_first and i == 0,
                                     count=count))
        free_cache(mesh.device)
    return outs


def jamba_model_rank(mesh, ref_path, cfg, shape, label, routed_alike,
                     count=False):
    """One cut on one rank: drawn leaf by leaf, only the rank's share kept
    (the ranks in turn, so that one whole leaf is drawn at a time on the
    card), its bytes against the dry run's; then ``serve.run`` fed the
    no-mesh run's tokens, the scan's calls and channels, the routings and
    the MoE's sums of F partials over data recorded (with ``count``, its
    collectives' bytes beside the dry run's count of the same run); with
    ``routed_alike`` the run again with every token sent to the experts
    the no-mesh run chose."""
    dev = mesh.device
    ref = torch.load(ref_path, weights_only=False)
    t0 = time.perf_counter()
    cuda = dev.startswith("cuda")

    def show_memory(when):
        if cuda:
            print(f"{label} rank {mesh.rank} {when}: memory_allocated "
                  f"{torch.cuda.memory_allocated(dev)} reserved "
                  f"{torch.cuda.memory_reserved(dev)}; the card's free and "
                  f"total bytes {torch.cuda.mem_get_info(dev)}", flush=True)

    for turn in range(mesh.size):
        if mesh.rank == turn:
            show_memory(f"before its draw of {cfg.moe.num_experts} experts")
            model, params = serve.build(cfg, dev, seed=0, shard=True)
            sync(dev)
            free_cache(dev)
            show_memory("after its draw")
        torch.distributed.barrier()
    build_s = time.perf_counter() - t0
    B, S0, T = (shape[k] for k in ("batch", "prompt_len", "gen"))
    record = mesh_record(mesh)
    with shd.use_mesh(None):
        whole_state = model.init_decode_state(B, S0 + T, device="meta")
    dry = (dryrun.per_device_bytes(model.param_specs(), model.logical_specs,
                                   record),
           dryrun.per_device_bytes(whole_state, model.state_logical_specs(
               B, S0 + T), record))
    channels, orig = [], kops.selective_scan_chunk
    partials, reduce = [], shd.reduce_from_data

    def scan(a, b, h0):
        channels.append(a.shape[2])
        return orig(a, b, h0)

    def summed(x):
        if shd.data_live():
            partials.append(x.shape)
        return reduce(x)

    # the prompt and the given tokens on the card before the run, as the
    # dry run takes them (arguments, not the run's own copies)
    prompt, forced = (torch.as_tensor(ref[k]).to(dev, torch.long)
                      for k in ("prompt", "ids"))
    sync(dev)
    before = torch.cuda.memory_allocated(dev) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    launches.reset()
    kops.selective_scan_chunk, shd.reduce_from_data = scan, summed
    try:
        with recorded_routes() as routes, shd.count_collectives() as moved, \
                memory.count_memory(torch.device(dev).type) as mem:
            res = serve.run(model, params, prompt, T, 0.0,
                            torch.Generator(dev), forced=forced)
    finally:
        kops.selective_scan_chunk, shd.reduce_from_data = orig, reduce
    sync(dev)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    if count:
        # the collectives are not timed one by one (a synchronise around
        # each would serialise the decode's gathers with its compute): the
        # rate is over the served wall, a lower bound on gloo's (with no
        # mesh a token takes 19-29 ms of the seconds it takes here)
        moved = (dict(moved), dryrun.serve_collectives(cfg, mesh, B, S0, T),
                 res.prefill_s + res.decode_s, "of prefill and decode")
        held_memory = (mem.analysis((params, prompt, forced),
                                    (res.logits, res.state)),
                       dryrun.serve_memory(cfg, mesh, B, S0, T),
                       peak - before if cuda else None)
    del prompt, forced
    counts = dict(launches.KERNEL_LAUNCHES)
    launches.reset()
    held = (sp.param_bytes(params), sum(
        v.numel() * v.element_size() for leaves in res.state.values()
        for v in leaves.values()))

    def row_gaps(g, w):
        g, w = g.detach().float().cpu(), w.float()
        return ((g - w).abs().flatten(1).amax(1)
                / w.abs().max().clamp_min(1e-30)).tolist()

    f_cut = [v.shape[-1] for k, v in flat_dict(params).items()
             if k.endswith("moe/w1")]
    out = dict(held=held, dry=dry, counts=counts, peak=peak,
               partials=len(partials), f_cut=sorted(set(f_cut)),
               build_s=build_s, prefill_s=res.prefill_s,
               decode_ms=res.decode_s / T * 1e3,
               channels=sorted(set(channels)), n_scans=len(channels),
               gaps=[rel_gap(g, w) for g, w in zip(res.logits,
                                                   ref["logits"])],
               row_gaps=[row_gaps(g, w) for g, w in zip(res.logits,
                                                        ref["logits"])],
               agree=[float((g.cpu().argmax(-1) == w.argmax(-1)).float()
                            .mean())
                      for g, w in zip(res.logits, ref["logits"])],
               routings=sum(r.shape[0] for r in routes),
               flips=route_flips(routes, ref["routes"],
                                 len(ref["routes"]) // (T + 1), B,
                                 first=shd.shard_index(
                                     shd.batch_split_axes()) * B
                                 // shd.shard_count(shd.batch_split_axes())),
               moved=moved if count else None,
               memory=held_memory if count else None)
    finite = all(bool(torch.isfinite(g).all()) for g in res.logits)
    del res, routes
    if routed_alike:
        # the gap left is the split's rounding alone
        with forced_routes(ref["routes"]):
            same = serve.run(model, params, ref["prompt"], T, 0.0,
                             torch.Generator(dev), forced=ref["ids"])
        out["routed"] = [rel_gap(g, w) for g, w in zip(same.logits,
                                                        ref["logits"])]
        finite = finite and all(bool(torch.isfinite(g).all())
                                for g in same.logits)
    out["finite"] = finite
    print(f"{label} rank {mesh.rank}: {cfg.name} cut, "
          f"{cfg.moe.num_experts} experts, over {mesh.shape}: "
          f"the experts' F held {out['f_cut']} of {cfg.moe.d_expert}, the "
          f"F partials summed over data {len(partials)} times; "
          f"param bytes {held[0]} (dry run {dry[0]}), decode-state bytes "
          f"{held[1]} (dry run {dry[1]}); built in {build_s:.1f} s with "
          f"the other rank's turn; prefill_s={out['prefill_s']:.4f} decode "
          f"{out['decode_ms']:.2f} ms/token max_memory_allocated={peak} "
          f"({peak / 1e9:.2f} GB); scan calls {len(channels)} on "
          f"{out['channels']} channels; launches {counts}"
          + (f"; {moved_line(moved)}; {memory_line(held_memory)}"
             if count else ""), flush=True)
    return out


def serve_no_mesh(cfg, device, kind, shape, path):
    """The cut served greedily with no mesh here; its prompt, tokens,
    logits and routings saved to ``path`` for the ranks."""
    B, S0, T = (shape[k] for k in ("batch", "prompt_len", "gen"))
    free_cache(device)
    t0 = time.perf_counter()
    model, params = serve.build(cfg, device, seed=0)
    g = torch.Generator(device).manual_seed(1)
    prompt = torch.randint(0, cfg.vocab, (B, S0), generator=g, device=device)
    cuda = kind == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    with recorded_routes() as routes:
        res = serve.run(model, params, prompt, T, 0.0, g)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    print(f"spmd (f) (ii): {cfg.name} cut to {cfg.n_layers} layers, "
          f"{cfg.moe.num_experts} experts, with no mesh: "
          f"prefill_s={res.prefill_s:.4f} decode "
          f"{res.decode_s / T * 1e3:.2f} ms/token max_memory_allocated="
          f"{peak} ({peak / 1e9:.2f} GB); {time.perf_counter() - t0:.1f} s "
          f"with the build")
    torch.save({"prompt": prompt.cpu(), "ids": res.ids,
                "logits": [lg.cpu() for lg in res.logits],
                "routes": [r.cpu() for r in routes]}, path)
    del model, params, res, prompt, routes
    free_cache(device)


def serve_jamba_model(device, kind, cfg=None, shape=SERVE_MODEL):
    """(f) (ii): the Jamba cut, and the cut with no routing choice
    (SERVE_NO_CHOICE), each served greedily with no mesh here, then on
    data 1 x model 2 fed the same tokens; and the scan at a rank's chunk,
    timed against its plain version and its bound."""
    cfg = cfg or jamba_cut()
    cfgs = (cfg, no_choice_cut(cfg))
    B, S0, T = (shape[k] for k in ("batch", "prompt_len", "gen"))
    cuda = kind == "cuda"
    with tempfile.TemporaryDirectory() as tmp:
        paths = [os.path.join(tmp, f"jamba_served_{i}.pt")
                 for i in range(len(cfgs))]
        for c, path in zip(cfgs, paths):
            serve_no_mesh(c, device, kind, shape, path)
        if cuda:
            print(f"spmd (f) (ii): this process holds "
                  f"{torch.cuda.memory_allocated()} bytes allocated, "
                  f"{torch.cuda.memory_reserved()} reserved before the "
                  f"spawn; the card's free and total bytes "
                  f"{torch.cuda.mem_get_info()}")
        # the ranks' allocator maps and unmaps pages (expandable segments):
        # a whole leaf freed after its share is cut leaves no segment that a
        # share pins, so each rank holds about its share when the other
        # draws
        prev = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
        os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
        try:
            outs = yield Ranks("(f) (ii)", jamba_model_ranks,
                               (list(zip(paths, cfgs)), shape),
                               SERVE_MODEL_SIZES, SERVE_MODEL_AXES)
        finally:
            if prev is None:
                del os.environ["PYTORCH_CUDA_ALLOC_CONF"]
            else:
                os.environ["PYTORCH_CUDA_ALLOC_CONF"] = prev
    n_scan = scan_chunks(build_model(cfg), S0)
    n_moe = sum(s.ffn == "moe" for s in build_model(cfg).pattern)
    di = cfg.mamba.expand * cfg.d_model // SERVE_MODEL_SIZES[1]
    totals = {}
    for j, c in enumerate(cfgs):
        out = [o[j] for o in outs]
        label = (f"spmd (f) (ii) {c.moe.num_experts} experts" if j == 0
                 else f"spmd (f) (ii) {SERVE_NO_CHOICE}")

        def worst(key):
            return [round(max(o[key][i] for o in out), 5)
                    for i in range(T + 1)]

        agree = [min(o["agree"][i] for o in out) for i in range(T + 1)]
        peaks = [o["peak"] for o in out]
        flips = out[0]["flips"]
        # a row's steps up to its first flip: no flip reaches them
        held = [(i, b) for i in range(T + 1) for b in range(B)
                if sum(f[b] for f in flips[:i + 1]) == 0]
        share = sum(map(sum, flips)) / out[0]["routings"]
        print(f"{label}: max |diff| / max |logit| against no mesh, prefill "
              f"and each decode step, worst rank {worst('gaps')}; argmax "
              f"agreement {agree}; tokens routed to other experts than "
              f"with no mesh (over the {n_moe} MoE layers; prefill, then "
              f"each step; per row) {flips}, {share:.4f} of "
              f"{out[0]['routings']} routings; held before any flip of "
              f"their row: {len(held)} of {(T + 1) * B} (step, row)s"
              + (f"; with every token routed as with no mesh "
                 f"{worst('routed')}" if j == 0 else "")
              + f"; rank peaks {peaks} ({sum(peaks) / 1e9:.2f} GB "
                f"together)")
        for o in out:
            check(o["finite"], f"{label}: non-finite logits")
            check(o["held"] == o["dry"], f"{label}: (param, state) bytes "
                                         f"{o['held']} against the dry "
                                         f"run's {o['dry']}")
            over = [(i, b, o["row_gaps"][i][b]) for i, b in held
                    if o["row_gaps"][i][b] > SERVE_DECODE_TOL]
            check(not over, f"{label}: (step, row, gap) over "
                            f"{SERVE_DECODE_TOL} with no flip before: "
                            f"{over}")
            check(share <= SERVE_FLIP_SHARE,
                  f"{label}: {share:.4f} of the routings flipped")
            if j == 0:
                check(max(o["routed"]) <= SERVE_DECODE_TOL,
                      f"{label}: {max(o['routed']):.4g} from no mesh, "
                      f"routed alike")
            else:
                check(share == 0 and max(o["gaps"]) <= SERVE_DECODE_TOL,
                      f"{label}: {max(o['gaps']):.4g} from no mesh with "
                      f"{share} of the routings flipped")
            check(o["n_scans"] == n_scan and o["channels"] == [di],
                  f"{label}: {o['n_scans']} scan calls on {o['channels']} "
                  f"channels, expected {n_scan} on [{di}]")
            check(not cuda or o["counts"] == {"selective_scan": n_scan},
                  f"{label}: launches {o['counts']}, expected {n_scan} "
                  f"scans")
            add_counts(totals, o["counts"])
    if cuda:
        time_rank_chunk(cfg, device)
    return totals


def check_served_fsdp(cfg, out, shape, n_scan, n_moe, di, cuda) -> dict:
    """(h)'s checks over its ranks' results: the bytes and the memory the
    dry run's (``memory_ok``), the experts' F held cut over data and its
    partials summed over data once a MoE layer a decode step, the logits
    within SERVE_DECODE_TOL of no mesh's at every step with no routing
    flipped, the scans on the rank's channels.  Returns the launches
    summed over the ranks."""
    T = shape["gen"]
    label = f"spmd (h) {SERVE_NO_CHOICE} on data 2 x model 2"
    worst = [round(max(o["gaps"][i] for o in out), 5) for i in range(T + 1)]
    # a rank's prefill routes its own rows only: flips and routings are
    # summed over every rank's
    flips = sum(sum(map(sum, o["flips"])) for o in out)
    routings = sum(o["routings"] for o in out)
    peaks = [o["peak"] for o in out]
    print(f"{label}: max |diff| / max |logit| against no mesh, prefill and "
          f"each decode step, worst rank {worst}; argmax agreement "
          f"{[min(o['agree'][i] for o in out) for i in range(T + 1)]}; "
          f"routings flipped {flips} of {routings} (all ranks'); the F "
          f"partials summed over data {[o['partials'] for o in out]} times "
          f"a rank (expected {n_moe * T}); the experts' F held "
          f"{[o['f_cut'] for o in out]} of {cfg.moe.d_expert}; prefill_s "
          f"{[round(o['prefill_s'], 4) for o in out]}, decode ms/token "
          f"{[round(o['decode_ms'], 2) for o in out]}; rank peaks {peaks} "
          f"({sum(peaks) / 1e9:.2f} GB together)")
    totals = {}
    for o in out:
        check(o["finite"], f"{label}: non-finite logits")
        check(o["held"] == o["dry"], f"{label}: (param, state) bytes "
                                     f"{o['held']} against the dry run's "
                                     f"{o['dry']}")
        check(o["moved"][0] == o["moved"][1],
              f"{label}: the collective bytes {o['moved'][0]} against the "
              f"dry run's {o['moved'][1]}")
        check(memory_ok(o["memory"]),
              f"{label}: the memory {o['memory']} against the dry run's")
        check(o["f_cut"] == [cfg.moe.d_expert // FSDP_SIZES[0]]
              and o["partials"] == n_moe * T,
              f"{label}: the experts' F {o['f_cut']}, F partials summed "
              f"{o['partials']} times, expected {n_moe * T}")
        check(flips == 0 and max(o["gaps"]) <= SERVE_DECODE_TOL,
              f"{label}: {max(o['gaps']):.4g} from no mesh with {flips} "
              f"routings flipped")
        check(o["n_scans"] == n_scan and o["channels"] == [di],
              f"{label}: {o['n_scans']} scan calls on {o['channels']} "
              f"channels, expected {n_scan} on [{di}]")
        check(not cuda or o["counts"] == {"selective_scan": n_scan},
              f"{label}: launches {o['counts']}, expected {n_scan} scans")
        add_counts(totals, o["counts"])
    return totals


def time_rank_chunk(cfg, device, seed=4):
    """The scan at a rank's prefill chunk of the cut over model 2 ([1,
    chunk, d_inner / 2, d_state] f32): bit for bit against its plain
    version, then timed (kernel, queued, plain) beside its byte bound."""
    L, N = cfg.mamba.chunk, cfg.mamba.d_state
    D = cfg.mamba.expand * cfg.d_model // SERVE_MODEL_SIZES[1]
    gen = torch.Generator(device).manual_seed(seed)
    a = torch.rand((1, L, D, N), generator=gen, device=device) * 0.7 + 0.3
    b = torch.randn((1, L, D, N), generator=gen, device=device) * 0.1
    h0 = torch.randn((1, D, N), generator=gen, device=device)
    got = selective_scan_chunk_blocks(a, b, h0)
    want = ref.selective_scan_chunk_ref(a, b, h0)
    same = all(torch.equal(x, y) for x, y in zip(got, want))
    ms = time_ms(lambda: selective_scan_chunk_blocks(a, b, h0))
    queued = time_ms_queued(lambda: selective_scan_chunk_blocks(a, b, h0))
    plain = time_ms(lambda: ref.selective_scan_chunk_ref(a, b, h0))
    bound_ms, by = bound(4 * (3 * L * D * N + 2 * D * N), 2 * a.numel(), 0,
                         memory_rate(torch.cuda.get_device_name(0)))
    print(f"spmd (f) (ii): selective_scan at a rank's chunk [1, {L}, {D}, "
          f"{N}]: bit for bit against its plain version {same}; kernel "
          f"{ms:.4f} ms, queued {queued:.4f} ms ({bound_ms / queued:.0%} of "
          f"the bound), plain {plain:.4f} ms, bound {bound_ms:.4f} ms by "
          f"{by}")
    check(same, "spmd (f) (ii): the scan at a rank's chunk differs from its "
                "plain version")


def param_bytes(cfg) -> int:
    """The params' bytes in the config's dtype, from the meta tree."""
    return sum(v.numel() * v.element_size() for v in
               flat_dict(build_model(cfg).param_specs()).values())


def main() -> int:
    # cuBLAS reads its workspace setting when the first handle is made; a
    # fixed one lets check_async_resume run under deterministic algorithms
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    print("TF32 off for cuDNN convolutions and CUDA matmuls: the card "
          "computes in float32 as the CPU does; bf16 matmuls reduce in "
          "float32, as the launchers set them (train.resolve_device)")
    t_start = time.perf_counter()
    time_parts()
    dry = {}
    try:
        smi = nvidia_smi()
        print(f"nvidia-smi: {smi}")
        print(f"torch {torch.__version__} cuda {torch.version.cuda} "
              f"device {torch.cuda.get_device_name(0)}")
        phases = {}
        for phase, run in (("build", build), ("kernels", check_kernels),
                           ("round_parity", round_parity),
                           ("main_path", drive_main_path),
                           ("async_path", async_path),
                           ("fleet_path", fleet_path),
                           ("lm_serve", lm_serve), ("lm_train", lm_train),
                           ("mesh", lambda: mesh_phase(dry=dry.pop("job"))),
                           ("spmd", spmd_phase)):
            if phase == "round_parity":
                # the dry run needs no card: its processes, at the lowest
                # priority, run from here (a phase that prints no time)
                # until the mesh phase joins them
                dry["job"] = start_dry_run()
            t0 = time.perf_counter()
            phases[phase] = run()
            print(f"phase {phase}: {time.perf_counter() - t0:.1f} s")
        rows, totals = phases["kernels"], dict(phases["main_path"])
        add_counts(totals, phases["async_path"])
        add_counts(totals, phases["fleet_path"])
        add_counts(totals, phases["lm_serve"])
        add_counts(totals, phases["lm_train"])
        add_counts(totals, phases["mesh"])
        add_counts(totals, phases["spmd"])
        for kname, row in rows.items():
            row["launches"] = totals.get(kname, 0)
            check(row["launches"] > 0, f"{kname}: no launch on the main path")
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        stop_dry_run(dry.get("job"))
    print(f"total: {time.perf_counter() - t_start:.1f} s")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "queued_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "library_queued_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys}
                                  for r in rows.values()]}))
    print(f"nvidia-smi: {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
