#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--seed N] [--against DIR]

Phases, each failing loudly with a non-zero exit:

1. the card's name and power limit (``nvidia-smi``), then the build of the
   hand-written kernels from ``src/repro_torch/kernels/csrc`` (nvcc, sm_90a),
   and from its ``-Xptxas -v`` log the registers and spills of every
   instantiation (printed for K1, K2 and K4 at f64, N1 = 5 and 9, for K5
   at N1 = 3 and 9, and for every run-time-order kernel);
2. every kernel against its plain PyTorch version on the card, orders 1-8,
   f32 and f64 (tolerances at TOL_F64 / TOL_F32 below): K2 (``act_jet``) for
   tanh/sigmoid/sin at ragged and serving shapes; K1 (``jet_dense``) for
   None/tanh/sigmoid/sin at the served layer shapes (2->32, 32->32, 32->1)
   and a ragged one; K3 (``jet_rms_norm``) at the served (n+1, 16384, 32)
   and a ragged (n+1, 37, 24); K4 (``jet_flash_attention``) at the served
   (n+1, 8192, 2, 2, 16) x wo (2, 16, 32), a ragged multi-block
   (n+1, 3, 4, 70, 8) x (4, 8, 20) and a wide-head (n+1, 2, 4, 37, 96) x
   (4, 96, 48) (the long-T kernel at a wide head), each under the none,
   causal and ("local", 2) masks; then the tilings' edges, orders 0, 4 and
   8: K1 at DENSE_EDGE_SHAPES (ragged rows, din 1 and 2, dout 1, width
   128, a ragged 4-column register tile) for every activation and None,
   K4 at T in 1, 2, 3, 70 and 1024, Dh 1, 16 and 128, every mask including
   local windows 1 and 5, and at the largest head count the wrapper admits;
   2c. K5 (``jet_attention_scores``) at the reference's test shapes (B, T, D)
   (5, 3, 4), (19, 2, 8), (3, 1, 1), the memory comparison's (4, 64, 8) and
   (4, 256, 8) and a ragged (2, 70, 16), plus the softmax's row-sum
   invariant (rows sum to 1 at order 0, to 0 above); then its edges,
   orders 0, 4 and 8, T in 1, 2, 3, 31, 33, 70 x D in 1, 16, 64, f32 and
   f64, whose geometries run the whole-row and the ring staging and a key split of 1 and of several warps, and the largest head
   dim the wrapper admits at f64 order 8 (one more is refused);
   2d. K5's path: the rows of the reference's
   ``benchmarks/memory_scaling.py::_attention_rows`` through the public ops
   (order 2, B 2, H 2, Dh 8, Dm 16, f32, T in 64/256/1024), launch counts
   zeroed before and read after: the peak of ``max_memory_allocated``
   above the inputs must grow with T^2 for K5 and no faster than T for K4;
   plus the score op's backward;
   2e. the run-time-order kernels (csrc/jet_runtime.cu): K1-K5 at orders
   9, 10, 12 and 16, f64 (within TOL_SCALED of a conditioning scale, the
   same computation with the absolute value of every term: ``abs_sum``)
   and f32, at the served shapes and a ragged one each; on bfloat16 at
   the served shapes, orders 1, 4 and 10, within BF16_ULPS of the float32
   plain version (K1 and K2 at f32/f64 bit for bit); the largest order each
   wrapper admits at its served
   shape and the refusal, naming the bytes, one order past it (K4 at head
   dims 160 and 256 is in phase 2's edges, with the largest head dim
   admitted at f64 order 8 and the refusal of the next); then the run-time
   K3 and K4 where their geometries split (RT_RMS_CHECKS, RT_FLASH_CHECKS:
   16-byte vectors, ragged and unaligned rows; short T at the trunk's
   grid(10) launch under every mask, T 1, 3, 4, head dims 160 and 256; long
   T 70 and 1024) at the same gates; and the run-time K5 at its edges (T 1,
   2, 3, 31, 33, 70 x D 1, 16, 64, f64 at orders 10, 12, 16, f32 at 10,
   bfloat16 at 2 and 10; the whole-row and ring stagings, key splits of 1
   and more, the smallest block at D 128 and at the largest D admitted,
   all asserted) with its row sums;
3. the served main paths, each with the launch counters zeroed just before
   it and read just after:
   a. a ``DerivativeServer`` on the ``pinn-pde`` DenseMLP (d_in 2, width 32,
      depth 3, d_out 1, tanh, float64, random weights from ``--seed``) under
      engine ``ntp/cuda``, plus the same weights as a module graph with
      standalone Activation leaves (the K2 launch), both answering
      concurrent ``grid(order=4)``, ``cross((0,0,1,1))`` and ``cross((0,1))``
      requests of 5..512 rows; 4 K1 launches per engine call (and 3 K2 per
      call of the unfused graph);
   b. a server on the ``pinn-pde`` Transformer trunk (d_in 2, width 32,
      depth 3, 2 heads, mlp_ratio 2, tanh, no mask, float64, random weights
      from ``--seed``) under ``ntp/cuda``, answering the same requests; 16
      K1, 7 K3 and 3 K4 launches per engine call and no K2;
   c, d. servers on the ``pinn-pde`` ResidualMLP and FourierFeatureMLP
      (d_in 2, width 32, depth 3, d_out 1, tanh; 16 features, scale 1.0),
      ``grid(4)`` and ``cross((0,0,1,1))``, 5 and 4 K1 launches per call;
   e. the DenseMLP at ``grid(10)`` (N1 = 11, the run-time-order K1);
   f. the trunk at ``grid(10)``: 16 K1, 7 K3 and 3 K4 launches per engine
      call and nothing else, every one through csrc/jet_runtime.cu's
      launchers (``LauncherCounts``);
   every table is held against the eager ``ntp`` engine on the card and
   against nested autodiff (the trunk's and 3c-d's at the 5- and 37-row
   sizes only; not 3e's or 3f's order 10); the trunk's grid tables relative
   to a conditioning scale (``readout_scale``), its cross tables relative
   to the polarization terms;
   g. the Taylor-mode oracle: the tables of 3a (the DenseMLP's ``grid(4)``
      and ``cross((0,0,1,1))``), 3e and 3f at 512 rows under ``ntp/cuda``
      held against the engine ``"jet"`` (``core/taylor.py``, Taylor mode
      through the torch operations, independent of ``core/jet.py``) on
      the card within TOL_ORACLE, with both calls' times; the order-10
      tables' only check besides eager ``ntp``;
4. times from CUDA events after warm-up at the 512-row serving shapes: each
   kernel's device time (the host's enqueue kept off the clock, see
   ``device_time_ms``) and host dispatch time, its plain version, the
   nearest library call (the GEMM part of K1; for K3/K4 the order-0
   function alone), the bound from bytes and operations, and per request
   kind each server's p50/p99 for ``ntp/cuda`` and eager ``ntp`` beside the
   engine call's device time (also the DenseMLP's and the trunk's
   ``grid(10)``, phases 3e and 3f: the eager engine's device time from
   graph replays); K5 at (4, 256, 8) and (4, 1024, 8), orders 2
   and 8 (f64), and at the memory rows' (4, 1024, 8) order 2 (f32), beside
   its plain version and softmax(scale q_0 k_0^T); K1 also
   at the trunk's (5, 16384, 32), K4 at the memory comparison's row
   (order 2, T 1024, f32); and a ``torch.profiler`` trace of the trunk's
   ``cross((0,0,1,1))`` engine call at 512 rows over CUDA-graph replays,
   device time split by kernel;
5. Burgers training (``pinn.trainer.train``) on pinn-mlp (3 x 24 tanh,
   f64) at 512 domain + 128 origin points, k = 1, 3 (a u-jet of order 8:
   the top of the templates) and 4 (order 10: the run-time-order K1),
   Adam then L-BFGS under
   ``ntp/cuda`` and eager ``ntp`` from the same init and draws, counters
   zeroed before and read after each run: losses and lambda agree at every
   logged step (TOL_TRAIN), 9 K1 launches per loss evaluation, lambda moves
   toward 1/(2k) at k = 1; times per Adam step (wall, CUDA events, profiler
   device-busy split into the kernels and the eager rest) and per L-BFGS
   iteration for ``ntp/cuda``, ``ntp`` and a few ``autodiff`` steps;
6. operator training (``train_operator``): Navier-Stokes on the pinn-pde
   DenseMLP (16 K1 per step), ResidualMLP (20) and FourierFeatureMLP (16),
   and heat on the pinn-pde Transformer trunk (16 K1, 7 K3, 3 K4 per
   step), n_domain 1024, under ``ntp/cuda`` and eager ``ntp``: losses
   agree, launches asserted, time per step;
   6b. data parallel on the one card (``repro_torch.parallel``): NCCL at
   world size 1 in this process, ``train_operator(data_parallel=1)`` on
   Navier-Stokes (DenseMLP) and heat (trunk), 5 Adam steps and 2 L-BFGS
   iterations on the sharded objective, bit for bit with the run without
   a mesh and with its launches; then two spawned gloo ranks sharing the
   card (``file://`` init): the DenseMLP's and the trunk's
   ``cross((0,0,1,1))`` and ``grid(10)`` at 512 rows through
   ``ShardedEngine(NTPEngine("cuda"))`` against the single-process call
   (bit for bit: ``repro_torch.tree.bit_equal``, which compares integer
   views, so -0.0 and +0.0 differ), each rank's counters showing its
   K1 (and the trunk's K3 and K4) per sharded call, a table holding -0.0
   entries gathered by ``gather_rows`` (gloo on CUDA tensors: an integer
   sum) at f64, f32 and bf16, a
   ``DerivativeServer(mesh=)`` across the ranks, and Navier-Stokes trained
   on both ranks with ``grad_compression`` None (against the
   single-process run within TOL_TRAIN), ``"int8"`` and ``"topk:0.1"``
   (losses falling), times per Adam step beside the card's name and power
   limit (two processes on one card: not a scaling figure).  A rank that
   fails fails the run;
   6c. train -> checkpoint -> serve: heat on the pinn-pde DenseMLP
   (``train_operator``, ``ntp/cuda``), its parameters saved by
   ``repro_torch.ckpt.CheckpointManager`` (blocking) and its training
   state asynchronously while the next step runs, ``from_checkpoint`` into
   a fresh net serving ``grid(2)`` and ``cross((0,0,1,1))`` at 512 rows to
   four clients (against a direct call and nested autodiff), twice; the
   trunk's parameters and served ``grid(4)`` across a checkpoint; the
   ``Trainer`` uninterrupted, with one injected failure and preempted;
   ``examples/torch_serve_operator.py``; every identity ``bit_equal``,
   launches counted, save / restore / first-answer times and the served
   p50 printed;
   6d. the LM substrate's attention family (``repro_torch.models``,
   ``launch/``), within LM_PHASE_LIMIT_S, launch counters zeroed before and
   read after (it launches none of the port's kernels): (a) the six
   attention archs reduced, float32, the same parameters on the card and
   the CPU (logits within TOL_LM_CARD_CPU), prefill + decode against the
   full forward, blocked against full attention; qwen3-0.6b at its
   published widths (596 M parameters): (b) float32 prefill + decode
   against the full forward, (c) bfloat16 served by ``launch.serve.run``
   twice (the same tokens; prefill ms, decode ms a token), (d) float64
   ``jet_forward_dense`` at order 3 against nested ``torch.func.jvp``
   (TOL_LM_JET), (e) bfloat16 trained by ``launch.train.run`` with the
   order-3 penalty and without (finite losses, CE falling, ms a step, the
   penalty's share, peak memory);
   6e. the five other attention archs (LM_WIDE) at their published widths
   and depths, within LM_WIDE_LIMIT_S: each served at bfloat16 by
   ``launch.serve.run`` (tokens in range, prefill ms, decode ms a token)
   with prompts past the local windows, then prefill + decode against the
   full forward at float64 with the float32 islands lifted (TOL_LM_WIDE_F64)
   and at float32 against that result (gemma2-27b at 6 of 46 layers, llava
   at 16 of 32, whisper at 4 + 4 of 32 + 32 layers, its random stacks
   being chaotic: the phase measures it);
   6f. the LM path traced: one decode step of 6d (c) and one training step
   with the penalty of 6d (e), device-busy share and device ops;
   6g. the recurrent and MoE half (zamba2-2.7b, rwkv6-3b, mixtral-8x7b,
   llama4-maverick-400b-a17b), within LM_RM_LIMIT_S, launch counters
   zeroed before and read after (none of the port's kernels): (a) reduced,
   float32, card against CPU (logits, loss, aux, gradients), step-wise
   decode against the chunked forward, prefill + decode against the full
   forward; (b) bfloat16 served by ``launch.serve.run`` at published
   widths (the recurrent archs warmed step by step; mixtral at 16 of 32
   layers, llama4 at 2 of 48, for memory), prefill ms, decode ms a token,
   peak, the MoE dispatch buffers' share; (c) the same decode checks at
   float64 with the islands lifted (zamba2 at 24 of 54 layers, its random
   stack being chaotic: the phase measures it; mixtral at 4 layers, llama4
   at 2 with 16 experts, for memory) and the perturbation's reach; (d) zamba2
   trained at full width and depth by ``launch.train``'s step, and one
   training-mode loss + backward on mixtral at 2 layers (balance loss,
   tokens surviving the capacity drops);
   6h. the sharding half (``models/sharding_rules.py``, ``launch/mesh.py``,
   ``launch/sharding.py``, the elastic restore), within LM_SHARD_LIMIT_S,
   on a (1, 1) ("data", "model") mesh under NCCL at world size 1, launch
   counters zeroed before and read after (none of the port's kernels):
   (a) qwen3-0.6b trained at its published widths by
   ``build_train_step(fsdp=True, policy="tp")`` and by ``launch.train``'s
   step from one init, bit for bit (ms a step of each, the peaks); (b)
   rwkv6-3b decoded by ``build_serve_step`` against ``decode_step``, bit for
   bit (ms a token of each); (c) llama4 at 2 of 48 layers with 16 experts
   (expert-parallel specs), f64 with the islands lifted, by
   ``build_prefill_step`` against the unsharded forward (TOL_LM_SHARD_MOE);
   (d) a qwen3 parameter tree saved from the mesh and restored onto a 1-D
   mesh, bit for bit; (e) the production plan: per-rank bytes of every
   arch on both production meshes at every applicable shape;
   6i. the dry run and its roofline (``launch/dryrun.py``, ``op_static.py``,
   ``op_analysis.py``), within LM_DRYRUN_LIMIT_S: (a) the nine gate cells
   of ``launch/dryrun_gate.py`` (one per fault the sharded steps raised
   in before their repair, llama4's ``prefill_32k`` at 2 layers, and
   rwkv6's and mixtral's ``train_4k``, whose backward the torch versions
   reduced differently) at published widths on fake process groups of
   256 / 512 ranks and the card's torch, in five child processes
   (zamba2's cell, the prefill cells, each of the two backward cells, the
   rest; per-rank GiB, TFLOP, GB,
   collective GB by kind, the three terms and the bottleneck), each
   cell's dot FLOPs and collective bytes of each kind held within
   ``dryrun_gate.RTOL`` of the CPU's count, its GiB printed beside; (b) 6h
   (a)'s qwen3 step calibrating ``op_static`` and the roofline on the
   card: its FLOPs against ``torch.profiler``'s products (checkpoint's
   early stop off), the (1, 1) mesh's and the fake run's counts equal to
   the unsharded one, the step against its bound, the predicted peak
   against ``max_memory_allocated``; launch counters zeroed before and
   read after (none of the port's kernels);
7. K1 at the shapes the training phases launched it most (recorded while
   they ran), beside its plain version and bound; 7b. the run-time-order
   kernels timed: K1 at the Burgers k = 4 layers, K1-K5 at orders 10 and
   16 and on bfloat16 at the served shapes, K5 at RT_SCORES_TIMED (the
   tiled kernel asserted), K3 and K4 at the trunk's grid(10) launches, K1
   at every distinct shape the trunk's grid(10) call hands its launcher
   (recorded at the launcher), and K4 at long T, K1 beside its GEMM part
   alone (``torch.matmul``), K3-K5 beside the same function at order 0 in
   one library call (ORDER0_LIBRARY);
8. only with ``--against DIR`` (another checkout, e.g. the parent commit
   unpacked with ``git archive``): that checkout's K1-K5 against
   this tree's in turns (other, this, this, other) at the served shapes,
   K4 and K5 at the memory row, K5 at the phase-4 f64 shapes, the
   run-time-order K3 and K4 at phase 7b's shapes (RT_RMS_SHAPES,
   RT_FLASH_SHAPES), the run-time K5 at RT_SCORES_TIMED, the run-time K1 at
   the Burgers k = 4 layers and K1/K2
   at the served layer at orders 10 and 16 and on bfloat16 at order 4
   (RUNTIME_TURNS), the DenseMLP's ``grid(10)`` engine call with either
   tree's K1, the trunk's ``grid(10)`` engine call with either tree's K3
   and K4, and the phase-4 trace run with its K1 and K4 as well
   ("before");
9. a JSON line describing each of the five kernels, the ``nvidia-smi``
   line, and as the last line ``{"ok": true, "device": {...}}``.

Each phase prints its wall seconds.

Details go to ``chiprun_out/chip_smoke.json``.  The
script imports nothing of JAX: it needs PyTorch with CUDA and ``nvcc``.
"""

from __future__ import annotations

import argparse
import itertools
import json
import math
import re
import subprocess
import sys
import threading
import time
from dataclasses import dataclass
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM published peaks (NVIDIA data sheet): HBM 3.35 TB/s,
# float32 outside the tensor cores 67 TFLOP/s; float64 is bounded by the
# same 67 TFLOP/s (the FP64 tensor-core rate, the card's f64 peak).
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {"torch.float32": 67e12, "torch.float64": 67e12,
              "torch.bfloat16": 67e12}   # bf16 is computed in float32 on FMAs

DEVICE = "cuda"

# Kernel vs plain version on the same inputs, relative to each order's
# max |plain|.  f64: 1e-12 at every order.  f32: 1e-5 (what
# tests/test_parity.py uses between ntp and ntp/pallas) through order 4;
# above it the jet's own float32 conditioning dominates (two f32 versions
# that round in another order drift apart by ~1e-5 at order 7), so there
# the kernel must stay within F32_DRIFT times the plain version's own
# float32 error against the float64 plain result on the same inputs.
TOL_F64 = 1e-12
TOL_F32 = 1e-5
F32_EXACT_ORDERS = 4
F32_DRIFT = 4.0
TOL_SERVED = 1e-12     # served ntp/cuda vs eager ntp, relative per table slice
TOL_AUTODIFF = 1e-9    # vs nested autodiff: that tower's own rounding
# Above the templates' orders (N1 >= 10) the plain versions' own rounding
# grows with the terms they sum (one ulp of s moves the sigmoid's F_8 by
# ~4.5e-12), so a float64 kernel is held to its plain version within
# TOL_SCALED times a conditioning scale: per order plane, the largest
# magnitude of the same computation with the absolute value of every term
# (abs_sum below; polarization_scale is the same construction for the
# cross tables).  float32 keeps its drift rule (holds), bfloat16 is held to
# the float32 plain version on the same inputs within BF16_ULPS units of
# bfloat16 rounding (8 significant bits) of each plane's largest value.
TOL_SCALED = 1e-12
BF16_ULPS = 2
HIGH_ORDERS = (9, 10, 12, 16)
# The trunk's cross tables are held relative to the size of the terms the
# polarization identity sums (see polarization_scale), not to the table's
# own max: with the init's zero embedding bias, RMSNorm of a token x_t * w
# is near-singular at x_t = 0, directional 4th derivatives there reach
# ~1e10 while the mixed partial stays ~1e4, and every engine alike (eager
# against autodiff too) loses those digits to cancellation.

TRUNK = dict(d_in=2, width=32, depth=3, d_out=1, n_heads=2, mlp_ratio=2,
             activation="tanh", mask=None)
TRUNK_PER_CALL = {"jet_dense": 16, "act_jet": 0, "jet_rms_norm": 7,
                  "jet_flash_attention": 3}
TRUNK_AUTODIFF_SIZES = (5, 37)
FLASH_MASKS = (None, "causal", ("local", 2))
# the pinn-pde residual and Fourier-feature networks (reference defaults:
# 16 features, scale 1.0), served with grid(4) and cross((0,0,1,1)); K1
# launches per engine call: the input layer, one per block and the readout
# (residual), the trunk MLP's layers (fourier)
PDE_NETS = {"residual": (dict(d_in=2, width=32, depth=3, d_out=1), 5),
            "fourier": (dict(d_in=2, width=32, depth=3, d_out=1, n_features=16,
                             feature_scale=1.0), 4)}
PDE_REQUESTS = (("grid", 4), ("cross", (0, 0, 1, 1)))
PDE_AUTODIFF_SIZES = (5, 37)
DENSE_GRID_ORDER = 10   # the DenseMLP served past the templates (N1 = 11)
# the trunk served past the templates (phase 3f): every kernel of its engine
# call takes csrc/jet_runtime.cu, this many launches of each C launcher
TRUNK_GRID_ORDER = 10
TRUNK_RT_LAUNCHERS = {"jet_dense_rt_launch": 16, "jet_rms_norm_rt_launch": 7,
                      "jet_flash_attention_rt_launch": 3}
# the run-time-order K3 and K4 timed in phase 7b and in phase 8's turns
# beside the table shapes: the trunk's grid(10) launches (K3 (11, 2048, 32),
# K4 (11, 1024, 2, 2, 16) x (2, 16, 32)) and K4 at long T
RT_RMS_SHAPES = ((11, 2048, 32, "float64"), (11, 16384, 32, "float64"),
                 (17, 16384, 32, "float64"), (5, 16384, 32, "bfloat16"))
RT_FLASH_SHAPES = ((11, 1024, 2, 2, 16, 32, "float64"), (11, 8192, 2, 2, 16, 32, "float64"),
                   (17, 8192, 2, 2, 16, 32, "float64"), (5, 8192, 2, 2, 16, 32, "bfloat16"),
                   (11, 2, 2, 1024, 8, 16, "float64"))
# the run-time K5 timed in phase 7b and in phase 8's turns (N1, B, T, D,
# dtype): the memory comparison's (B*H, T, Dh) at orders 10 and 16, the
# memory rows' own launch (order 2) on bfloat16, and a one-wave T = 256;
# each must take the tiled kernel
RT_SCORES_TIMED = ((11, 4, 1024, 8, "float64"), (17, 4, 1024, 8, "float64"),
                   (3, 4, 1024, 8, "bfloat16"), (11, 4, 256, 8, "float64"))

# Edge shapes of phase 2 for the tiled kernels, orders 0, 4 and 8 (N1 1, 5,
# 9), f32 and f64.  K1 (rows, din, dout): rows that are no multiple of a
# tile, the input layer's din of 1 and 2, the readout's dout of 1, widths
# above 32, and a ragged shape on the 4-column register tiles (rows from
# 4224 up).  K4 (bsz, heads, t, dh, dm) at T in 1, 2, 3 (short-T kernel),
# 70 and 1024 (long-T kernel), Dh 1, 16 and 128, every mask; plus, at f64
# order 8, the most heads flash_geometry admits at Dh 128.
DENSE_EDGE_SHAPES = ((1, 2, 32), (77, 1, 32), (1000, 32, 1), (1000, 2, 24),
                     (1000, 128, 128), (4301, 32, 45))
EDGE_ORDERS = (0, 4, 8)
FLASH_EDGE_T = {1: 37, 2: 37, 3: 37, 70: 3, 1024: 1}       # T: batch rows
FLASH_EDGE_DH = ((1, 20), (16, 32), (128, 48), (160, 40), (256, 24))   # (Dh, Dm)
FLASH_EDGE_MASKS = (None, "causal", ("local", 1), ("local", 5))

# K5 (jet_attention_scores): the reference's test shapes (ragged T, T = 1,
# D = 1), the memory comparison's (B*H, T, Dh) and a ragged multi-warp T
SCORES_SHAPES = ((5, 3, 4), (19, 2, 8), (3, 1, 1), (4, 64, 8), (4, 256, 8),
                 (2, 70, 16))
# benchmarks/memory_scaling.py::_attention_rows at order 2, float32
MEMORY_T = (64, 256, 1024)
MEMORY = dict(order=2, bsz=2, heads=2, dh=8, dm=16)
# K5's edges (phase 2c, orders EDGE_ORDERS, f32 and f64, their own
# generator): T (batch rows) short, ragged around one 8-key tile and a
# 32-key stage, and ragged multi-stage; head dims 1, 16 (two 4-dim chunks
# a key, past a 16-byte copy) and 64.  Between them they take the whole-row
# and the ring staging, a key split of 1 and of several warps (asserted);
# plus the largest head dim the wrapper admits at f64 order 8.
SCORES_EDGE_T = {1: 5, 2: 5, 3: 5, 31: 3, 33: 3, 70: 2}
SCORES_EDGE_D = (1, 16, 64)
# K5 timed at the memory comparison's (B*H, T, Dh), f64; the kernels line
# reports the last shape at the first order.  Also the memory rows' own
# launch, f32 (order 2, (4, 1024, 8)).
SCORES_TIMED = ((4, 256, 8), (4, 1024, 8))
SCORES_TIMED_ORDERS = (2, 8)
SCORES_MEMORY_ROW = ((4, 1024, 8), 2)
# K1 shapes timed beside the served ones: every (n1, rows, din, dout, act)
# the training phases handed it, at most this many, the most launched first
TRAINING_SHAPES_TIMED = 8

# Training phases.  Burgers: pinn-mlp (3 x 24 tanh, d_in = d_out = 1, f64)
# at the paper's 512 domain + 128 origin points; k = 4 (u-jet order 10,
# N1 = 11: the run-time-order K1) with fewer steps, for the time limit, and
# no autodiff timing (its nested tower at order 10 takes minutes a step).
# Operators: pinn-pde.
BURGERS_KS = (1, 3, 4)
BURGERS_STEPS = {1: (30, 5), 3: (30, 5), 4: (10, 2)}      # k: (Adam, L-BFGS)
AUTODIFF_TIMED_KS = (1, 3)
# k = 4's steps launch ~14000 kernels each (the eager backward at order
# 10), and tracing them takes minutes of the time limit: its steps' times
# are wall and CUDA-event times, with no device-busy split; its forward
# alone (where the run-time K1 runs) is traced like every k's
PROFILED_KS = (1, 3)
OPERATOR_ADAM = 20
OPERATOR_RUNS = (
    ("navier-stokes", "dense", {}),
    ("heat", "transformer", {"n_heads": 2, "mlp_ratio": 2}),
    ("navier-stokes", "residual", {}),
    ("navier-stokes", "fourier", {}),
)
# K1 timed at the Burgers k = 4 layer shapes (N1, rows, din, dout)
BURGERS_K4_SHAPES = ((11, 512, 24, 24), (11, 128, 24, 24))
# the run-time-order K1 (and, at the served layer, K2) in phase 8's turns:
# (N1, rows, din, dout, dtype)
RUNTIME_TURNS = tuple((*shape, "float64") for shape in BURGERS_K4_SHAPES) + (
    (11, 8192, 32, 32, "float64"), (17, 8192, 32, 32, "float64"),
    (5, 8192, 32, 32, "bfloat16"))
# ntp/cuda vs eager ntp training from the same init and draws, relative per
# logged loss (and lambda): both run the reference's Adam, which rounds the
# float64 parameters through float32 each step, so one float32 rounding
# that the ~1e-13 gradient difference tips moves a parameter by 6e-8
# relative; L-BFGS carries what Adam left.
TOL_TRAIN = 1e-6
TIMED_STEPS = {"ntp/cuda": 10, "ntp": 10, "autodiff": 3}
# Phase 3g: the ntp/cuda tables of phases 3a, 3e and 3f at ORACLE_ROWS rows
# against the Taylor-mode oracle (engine "jet", core/taylor.py) on the
# card, relative per table slice (cross: to the polarization terms; the
# trunk's grid: to readout_scale).  The CPU rehearsal at these shapes
# (eager plain versions vs the oracle) read 3.2e-15, 7.9e-16 and 6.8e-16.
ORACLE_ROWS = 512
TOL_ORACLE = 1e-12
# Phase 6b: data parallel on the one card.  NCCL at world size 1 trains
# DP_RUNS (phase 6's Navier-Stokes on the DenseMLP and heat on the trunk,
# n_domain 1024) for DP_ADAM Adam steps and DP_LBFGS L-BFGS iterations;
# two gloo ranks sharing the card serve DP_ROWS rows through the sharded
# engine and the sharded server and train Navier-Stokes under each
# DP_COMPRESSIONS.  The pair must end within DP_TIMEOUT seconds.
DP_RUNS = OPERATOR_RUNS[:2]
DP_ADAM = 5
DP_LBFGS = 2
DP_ROWS = 512
DP_COMPRESSIONS = (None, "int8", "topk:0.1")
DP_TIMEOUT = 600
# phase 6c: heat on the pinn-pde DenseMLP trained, checkpointed and served
# at CKPT_ROWS rows by CKPT_CLIENTS clients; the Trainer checkpoints every
# CKPT_EVERY steps, fails once at CKPT_FAIL_AT, is preempted at
# CKPT_PREEMPT_AT; then the serve example at the pinn-pde DenseMLP's width
CKPT_OP = "heat"
CKPT_ROWS = 512
CKPT_CLIENTS = 4
CKPT_EVERY = 5
CKPT_FAIL_AT = 12
CKPT_PREEMPT_AT = 7
EXAMPLE_ARGV = ["--op", "heat", "--steps", "20", "--width", "32", "--depth", "3",
                "--clients", "4", "--points", "128"]

# phase 6d: the LM substrate's attention family (repro_torch.models, launch/)
LM_ARCHS = ("qwen3-0.6b", "granite-3-2b", "gemma3-4b", "gemma2-27b",
            "llava-next-mistral-7b", "whisper-large-v3")   # (a): reduced, float32
LM_FULL = "qwen3-0.6b"                 # (b)-(e): at its published widths
LM_B, LM_S = 2, 32                     # (a), (b): batch rows, tokens
TOL_LM_CARD_CPU = 1e-4                 # (a): card vs CPU logits, of the logit scale
LM_DECODE_RTOL, LM_DECODE_ATOL = 2e-2, 2e-4   # prefill + decode vs the full forward
LM_BLOCKED_RTOL, LM_BLOCKED_ATOL = 1e-4, 1e-5  # blocked vs full attention
LM_CHUNKS = (16, 32)                   # (a): query / key chunks of blocked_attention
LM_SERVE = dict(batch=4, prompt_len=32, gen=16)    # (c), bfloat16, greedy
LM_JET = dict(batch=1, tokens=16, order=3)         # (d), float64
TOL_LM_JET = 1e-9                      # (d): jet vs nested jvp, of each order's max
LM_TRAIN = dict(batch=2, seq=4096, steps=3, lr=1e-3, ntp_order=3)   # (e), bfloat16
LM_PHASE_LIMIT_S = 120.0

# phase 6e: the five other attention archs at their published widths.  Per
# arch: batch rows, prompt tokens (after llava's 2880 image tokens), tokens
# served, decoder layers of the decode check (None: all) and why they are
# cut.  The prompts outrun the local windows (gemma3 1024, gemma2 and llava
# 4096) so the local masks and the ring's eviction apply.  The check runs at
# float64 with the float32 islands lifted and at float32 on the same
# weights.  "memory": the float64 weights and S^2 scores must fit the card.
# "chaos": whisper's random stacks amplify a perturbation so far (the phase
# measures it, LM_PERTURB) that at 32 + 32 layers a 2^-50 change moves the
# logits O(1): float64 rounding alone parts the two paths; its check runs
# 4 encoder and 4 decoder layers on the 1500 frames.  Other random deep
# stacks amplify rounding too, so at full depth float32's two orders
# of summation part by more than the reference test's bound; the float32
# gate is the CPU tests' rule instead: the decode path within
# LM_WIDE_F32_FACTOR x the full forward's own error against the float64
# result.
LM_WIDE = {"granite-3-2b": (2, 1024, 8, None, ""),
           "gemma3-4b": (1, 2048, 8, None, ""),
           "gemma2-27b": (1, 5120, 8, 6, "memory"),
           "llava-next-mistral-7b": (1, 2240, 8, 16, "memory"),
           "whisper-large-v3": (2, 64, 8, 4, "chaos")}
LM_PERTURB = 2.0 ** -50                # relative change of the embedding table
TOL_LM_WIDE_F64 = 1e-9                 # lifted float64: decode vs full, of the logit scale
LM_WIDE_F32_FACTOR, LM_WIDE_F32_FLOOR = 4.0, 1e-5
LM_WIDE_LIMIT_S = 240.0

# phase 6g: the recurrent and MoE half of the LM substrate (models/gla.py,
# ssm.py, rwkv.py, moe.py, zamba2's shared block).  (a) reduced, the same
# parameters on the card and the CPU, at float64 and float32 (see
# lm_rm_reduced), then the reference tests' own checks on the card:
# step-wise decode against the chunked forward (LM_STEPWISE_BOUND on the
# logits) for the recurrent archs, prefill + decode against the full
# forward for the MoE ones.
LM_RM_ARCHS = ("zamba2-2.7b", "rwkv6-3b", "mixtral-8x7b", "llama4-maverick-400b-a17b")
LM_STEPWISE_BOUND = 5e-3
TOL_LM_RM_CARD_F64 = 1e-9     # (a): f64 card vs CPU, islands lifted, of each tensor's scale
# (b) served at bfloat16 by launch.serve.run at published widths: batch
# rows, prompt tokens (warmed step by step for the recurrent archs), tokens
# generated, layers (None: all) and why cut.  mixtral's prompt outruns its
# window (4096), so its local mask applies.
LM_RM_SERVE = {"zamba2-2.7b": (4, 64, 16, None, ""),
               "rwkv6-3b": (4, 64, 16, None, ""),
               "mixtral-8x7b": (1, 4608, 16, 16, "memory: its 32 layers are 93 GiB in bf16"),
               "llama4-maverick-400b-a17b": (1, 1024, 8, 2, "memory: one MoE layer of 128 "
                                                            "experts is 32 GB in bf16")}
# (c) float64 with the float32 islands lifted: batch rows, tokens, layers
# (None: all), experts (None: all) and why cut.  Step-wise decode against
# the chunked forward at every position (recurrent), prefill + decode
# against the full forward (MoE), within TOL_LM_RM_F64 of the logit scale.
# "chaos": zamba2's random stack amplifies a 2^-50 change of the table to
# 4.2e-10 of the logits at 54 layers (5.3e-12 at 24; H100 80GB HBM3, 700 W), and
# float64 rounding with it (1.8e-9 at 54 layers, 4.7e-11 at 24): its check
# runs 24 layers and the phase prints the reach at 54.
LM_RM_CHECK = {"zamba2-2.7b": (1, 64, 24, None, "chaos"),
               "rwkv6-3b": (1, 64, None, None, ""),
               "mixtral-8x7b": (1, 4608, 4, None, "memory: a layer is 11.6 GB in f64"),
               "llama4-maverick-400b-a17b": (1, 1024, 2, 16, "memory: 128 experts of a layer "
                                                             "are 129 GB in f64")}
TOL_LM_RM_F64 = 1e-9
# (d) training at bfloat16: launch.train's step on zamba2 at full width and
# depth, and one training-mode loss + backward on mixtral at 2 layers
LM_RM_TRAIN = dict(arch="zamba2-2.7b", batch=1, seq=2048, steps=2, lr=1e-4)
LM_MOE_TRAIN = dict(arch="mixtral-8x7b", layers=2, batch=1, seq=4096)
LM_RM_LIMIT_S = 240.0

# phase 6h: the LM substrate's sharding half (models/sharding_rules.py,
# launch/mesh.py, launch/sharding.py, runtime/pipeline.py, the elastic
# restore), on a (1, 1) ("data", "model") mesh under NCCL at world size 1
# (NCCL refuses two ranks on one card; gloo runs no all_gather on CUDA
# tensors): the builders' DTensor steps against the unsharded path.
# (a) qwen3-0.6b trained at its published widths, bf16, by
# build_train_step(fsdp=True, policy="tp") and by launch.train's step from
# one init and the same batches, bit for bit; (b) rwkv6-3b decoded by
# build_serve_step against decode_step from a fresh state, bf16, bit for
# bit; (c) llama4 at 2 of 48 layers with 16 of 128 experts (one MoE layer,
# expert-parallel specs), f64 with the islands lifted, build_prefill_step
# against forward_seq + logits within TOL_LM_SHARD_MOE of the logit scale
# (index_add_'s atomics rule out bit equality); (d) a qwen3 parameter tree
# saved from the (1, 1) mesh and restored onto a 1-D one, bit for bit;
# (e) the production plan: per-rank bytes of every arch on both production
# meshes at every applicable shape, from the bound specs alone.
LM_SHARD_TRAIN = dict(arch="qwen3-0.6b", batch=2, seq=1024, steps=2, lr=3e-4)
LM_SHARD_DECODE = dict(arch="rwkv6-3b", batch=4, tokens=16)
LM_SHARD_PREFILL = dict(arch="llama4-maverick-400b-a17b", batch=2, tokens=512, layers=2,
                        experts=16)
TOL_LM_SHARD_MOE = 1e-12
LM_SHARD_LIMIT_S = 180.0

# phase 6i: the dry run and its roofline (launch/dryrun.py, op_static.py,
# op_analysis.py).  (a) the dry run on the card's torch, in five child
# processes on a fake process group of 256 / 512 ranks, the production
# meshes on CUDA, fake tensors: the nine cells of launch/dryrun_gate.py,
# their counts held to the CPU's there (rwkv6's and mixtral's train_4k,
# 16-43 s each on an H100 host's CPU cores, a child each beside zamba2's,
# the longest there at 75-115 s); (b)
# the calibration on the card: 6h (a)'s qwen3 step, bf16,
# unsharded and on the (1, 1) NCCL mesh -- op_static's FLOPs against
# torch.profiler's count of the same products (mm, addmm, bmm, baddbmm,
# convolution; its total adds one FLOP an element of mul and add, which
# op_static, like the reference, leaves out) within LM_DRYRUN_FLOP_RTOL,
# with checkpoint's early stop off (it stops a recomputation inside a
# product the profiler has already counted),
# the sharded local count
# equal to the unsharded one, the measured step no faster than the
# roofline's bound, the predicted peak (arguments + the fake run's
# temporaries) within LM_DRYRUN_MEM_RTOL of max_memory_allocated.
LM_DRYRUN_FLOP_RTOL = 0.01
LM_DRYRUN_MEM_RTOL = 0.25
LM_DRYRUN_STEPS = 3
LM_DRYRUN_LIMIT_S = 180.0


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def rel_err(a, b, keep: int) -> float:
    """max |a - b| / max |b| over each slice of the leading ``keep`` axes,
    worst slice."""
    import torch
    a, b = a.double(), b.double()
    lead = tuple(b.shape[:keep])
    d = (a - b).abs().reshape(lead + (-1,)).amax(-1)
    s = b.abs().reshape(lead + (-1,)).amax(-1).clamp_min(1e-300)
    return float((d / s).max()) if d.numel() else 0.0


def device_time_ms(fn, reps: int, warmup: int = 3,
                   what: str = "") -> tuple[float, float]:
    """(device ms, host ms) per call of ``fn``.

    A spin kernel (``torch.cuda._sleep``) holds the device while the host
    enqueues ``reps`` calls, so the CUDA events around them bracket
    back-to-back device work with no host gaps: the device time excludes
    Python dispatch, which the host time (enqueue cost per call) reports.
    Keep ``reps`` x kernels-per-call well under the launch queue's depth."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    cycles = 20_000_000
    for _ in range(6):
        ts, t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        ts.record()
        torch.cuda._sleep(cycles)
        t0.record()
        h0 = time.perf_counter()
        for _ in range(reps):
            fn()
        host_ms = (time.perf_counter() - h0) * 1e3
        t1.record()
        torch.cuda.synchronize()
        spin_ms = ts.elapsed_time(t0)
        if spin_ms > 1.2 * host_ms:          # the queue filled before the spin ended
            return t0.elapsed_time(t1) / reps, host_ms / reps
        cycles = int(cycles * 2 * host_ms / max(spin_ms, 1e-3))
    raise SmokeFailure(f"timing {what or fn}: the spin kernel never outlasted "
                       f"the host's enqueue (last: spin {spin_ms:.3f} ms, host "
                       f"{host_ms:.3f} ms for {reps} calls)")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, timeout=60)
    require(out.returncode == 0, f"nvidia-smi failed: {out.stdout.strip()}")
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 1: registers, spills and shared memory per kernel instantiation
# ---------------------------------------------------------------------------

KERNEL_SYMBOLS = ("jet_dense_kernel", "act_jet_kernel", "jet_rms_norm_kernel",
                  "jet_flash_attention_short_kernel", "jet_flash_attention_long_kernel",
                  "jet_attention_scores_kernel", "jet_dense_rt_kernel", "act_jet_rt_kernel",
                  "jet_rms_norm_rt_kernel", "jet_flash_attention_rt_kernel",
                  "jet_flash_attention_rt_short_kernel", "jet_flash_attention_rt_long_kernel",
                  "jet_attention_scores_rt_kernel", "jet_attention_scores_rt_tiled_kernel")
DTYPE_MANGLED = {"d": "f64", "f": "f32", "13__nv_bfloat16": "bf16"}
ACT_NAMES = {0: "none", 1: "tanh", 2: "sigmoid", 3: "sin"}


def kernel_resources(build_log: str) -> list[dict]:
    """Per instantiation, from the ``-Xptxas -v`` lines of the build log:
    the kernel, its dtype and integer template arguments (decoded from the
    mangled name: N1 first; then the activation for K1/K2, the column tile
    TN for K1, the head dims per lane DPL for K4; for the run-time K1/K2
    only whether the table is staged in shared memory), registers, spill bytes
    and static shared memory (the kernels' tiles are dynamic shared memory,
    sized per launch: see ``flash_geometry`` and jet_dense.cu)."""
    out = []
    for entry in build_log.split("Compiling entry function '")[1:]:
        mangled = entry.split("'", 1)[0]
        name = next((k for k in KERNEL_SYMBOLS if k + "I" in mangled), None)
        m = name and re.search(re.escape(name) + r"I(d|f|13__nv_bfloat16)((?:L[ib]-?\d+E)*)E",
                               mangled)
        if not m:
            continue
        regs = re.search(r"Used (\d+) registers", entry)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", entry)
        smem = re.search(r"(\d+) bytes smem", entry)
        out.append({"kernel": name, "dtype": DTYPE_MANGLED[m.group(1)],
                    "template": [int(v) for v in re.findall(r"L[ib](-?\d+)E", m.group(2))],
                    "registers": int(regs.group(1)) if regs else None,
                    "spill_store_bytes": int(spill.group(1)) if spill else None,
                    "spill_load_bytes": int(spill.group(2)) if spill else None,
                    "static_smem_bytes": int(smem.group(1)) if smem else 0})
    return out


def print_resources(resources: list[dict]) -> None:
    """The f64 N1 = 5 and 9 instantiations of K1, K2 and K4 (the served and
    training orders), K5's at N1 = 3 and 9 (the timed orders; f64 scores
    on the tensor cores, f32 on FMAs), plus the worst spill of any
    instantiation."""
    for r in resources:
        n1 = r["template"][0] if r["template"] else None
        if "_rt_" in r["kernel"]:
            if r["kernel"] == "jet_rms_norm_rt_kernel":     # <S, V, Staged>
                vec, staged = r["template"]
                table = f" vec {vec}, rows {'staged' if staged else 'from device memory'}"
            else:
                table = {(): "", (0,): " table in device memory",
                         (1,): " table staged"}.get(tuple(r["template"]), f" {r['template']}")
            print(f"    {r['kernel']:36s} {r['dtype']} any N1{table}: registers "
                  f"{r['registers']}, spill {r['spill_store_bytes']}/"
                  f"{r['spill_load_bytes']} bytes")
            continue
        if r["kernel"] == "jet_attention_scores_kernel":
            if n1 not in (3, 9):
                continue
        elif r["dtype"] != "f64" or n1 not in (5, 9) or r["kernel"] == "jet_rms_norm_kernel":
            continue
        rest = r["template"][1:]
        if r["kernel"] in ("jet_dense_kernel", "act_jet_kernel"):
            rest = [ACT_NAMES.get(rest[0], rest[0])] + rest[1:]
        print(f"    {r['kernel']:34s} {r['dtype']} N1={n1} {str(rest):16s} registers "
              f"{r['registers']}, spill {r['spill_store_bytes']}/{r['spill_load_bytes']} "
              f"bytes")
    worst = max(resources, key=lambda r: r["spill_store_bytes"] or 0, default=None)
    if worst:
        print(f"    worst spill of all {len(resources)} instantiations: "
              f"{worst['spill_store_bytes']} bytes ({worst['kernel']} {worst['dtype']} "
              f"{worst['template']})")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def holds(got, want, plain, args, dt, n: int, what: str) -> float:
    """Check a kernel's output against its plain version (see TOL_*)."""
    import torch
    e = rel_err(got, want, 1)
    if dt == torch.float64:
        require(e <= TOL_F64, f"{what}: rel err {e:.3e} > {TOL_F64:.0e}")
    elif n <= F32_EXACT_ORDERS:
        require(e <= TOL_F32, f"{what}: rel err {e:.3e} > {TOL_F32:.0e}")
    elif e > TOL_F32:
        exact = plain(*(a.double() for a in args))
        e_kernel, e_plain = rel_err(got, exact, 1), rel_err(want, exact, 1)
        require(e_kernel <= F32_DRIFT * max(e_plain, TOL_F32),
                f"{what}: f32 error vs f64 {e_kernel:.3e}, the plain version's "
                f"{e_plain:.3e}; allowed {F32_DRIFT:g}x")
    return e


# ---------------------------------------------------------------------------
# conditioning scales: the same computation with the absolute value of
# every term
# ---------------------------------------------------------------------------

_ABS_SUM = {}


def _abs_sum_class():
    """A tensor subclass that carries, beside its value, ``mag``: the same
    computation with every term replaced by its absolute value.  Sums and
    differences add magnitudes, products multiply them, a quotient divides
    the numerator's by |denominator|, contractions (einsum, matmul, sum,
    mean) contract magnitudes, and a function's value enters as its own
    |value| (tanh, exp, sqrt, ...: its arguments are where its terms
    were); constants and plain tensors enter as |value|.  Any other
    floating-point op raises, so nothing passes unscaled."""
    if "cls" in _ABS_SUM:
        return _ABS_SUM["cls"]
    import torch

    linear = {"add", "__add__", "__radd__", "__iadd__", "sub", "__sub__", "__rsub__",
              "__isub__", "rsub"}
    products = {"mul", "__mul__", "__rmul__", "__imul__"}
    quotients = {"div", "__truediv__", "true_divide", "__itruediv__"}
    functions = {"exp", "tanh", "sin", "cos", "sqrt", "rsqrt", "log", "sigmoid", "pow",
                 "__pow__", "reciprocal", "full_like", "zeros_like", "ones_like",
                 "new_zeros", "new_ones", "new_full"}
    signs = {"neg", "__neg__", "abs", "positive"}
    same = {"reshape", "view", "movedim", "permute", "transpose", "expand", "repeat",
            "repeat_interleave", "contiguous", "clone", "squeeze", "unsqueeze", "flatten",
            "narrow", "select", "__getitem__", "index_select", "stack", "cat", "concat",
            "chunk", "split", "unbind", "broadcast_to", "to", "detach", "double", "float",
            "sum", "mean", "einsum", "matmul", "__matmul__", "mm", "bmm", "tensordot",
            "amax", "where", "expand_as", "reshape_as", "view_as", "__get__"}

    class AbsSum(torch.Tensor):
        @staticmethod
        def __new__(cls, value, mag=None):
            out = torch.Tensor._make_subclass(cls, value)
            out.mag = value.abs() if mag is None else mag
            return out

        @classmethod
        def __torch_function__(cls, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            name = getattr(func, "__name__", "")

            def val(a):
                if isinstance(a, AbsSum):
                    return a.as_subclass(torch.Tensor)
                if isinstance(a, (list, tuple)):
                    return type(a)(val(x) for x in a)
                return a

            def mag(a):
                if isinstance(a, AbsSum):
                    return a.mag
                if isinstance(a, torch.Tensor):
                    return a.abs() if a.is_floating_point() else a
                if isinstance(a, (list, tuple)):
                    return type(a)(mag(x) for x in a)
                if isinstance(a, (int, float)) and not isinstance(a, bool):
                    return abs(a)
                return a

            def floating(t):
                return isinstance(t, torch.Tensor) and t.is_floating_point()

            with torch._C.DisableTorchFunctionSubclass():
                if name == "__setitem__":
                    this, idx, v = args
                    val(this)[idx] = val(v)
                    this.mag[idx] = mag(v)
                    return None
                out = func(*val(args), **val(kwargs))
                if not (floating(out) or (isinstance(out, (tuple, list)) and out
                                          and all(floating(t) for t in out))):
                    return out
                if name in linear:
                    m = mag(args[0]) + mag(args[1])
                elif name in products:
                    m = mag(args[0]) * mag(args[1])
                elif name in quotients:
                    m = mag(args[0]) / mag(val(args[1]))
                elif name in ("__rtruediv__", "__rdiv__"):
                    m = mag(args[1]) / mag(val(args[0]))
                elif name in signs:
                    m = mag(args[0])
                elif name in functions:
                    m = out.abs()
                elif name in same:
                    m = func(*mag(args), **mag(kwargs))
                else:
                    raise SmokeFailure(f"abs_sum: no rule for {name}")
            if isinstance(out, (tuple, list)):
                return type(out)(AbsSum(o, mo) for o, mo in zip(out, m))
            return AbsSum(out, m)

    _ABS_SUM["cls"] = AbsSum
    return AbsSum


def abs_sum(fn, *args):
    """``fn(*args)`` computed with the absolute value of every term (see
    ``_abs_sum_class``), its floating-point tensor arguments taken as exact
    inputs: the magnitude that the rounding of any order of evaluation of
    ``fn`` is relative to."""
    import torch
    cls = _abs_sum_class()
    with torch.no_grad():
        out = fn(*(cls(a) if isinstance(a, torch.Tensor) and a.is_floating_point() else a
                   for a in args))
    return out.mag


def scaled_err(got, want, scale, keep: int = 1) -> float:
    """max |got - want| over each slice of the leading ``keep`` axes,
    relative to the largest ``scale`` in that slice; worst slice."""
    import torch
    d = (got.double() - want.double()).abs()
    lead = tuple(want.shape[:keep])
    num = d.reshape(lead + (-1,)).amax(-1)
    den = scale.double().reshape(lead + (-1,)).amax(-1).clamp_min(1e-300)
    return float((num / den).max()) if num.numel() else 0.0


def holds_high(got, plain, args, dt, n: int, what: str) -> float:
    """A kernel above the templates' orders against its plain version:
    float64 within TOL_SCALED of the abs-sum conditioning scale, float32
    by ``holds``.  Returns the gated error."""
    import torch
    want = plain(*args)
    if dt != torch.float64:
        return holds(got, want, plain, args, dt, n, what)
    e = scaled_err(got, want, abs_sum(plain, *args))
    require(e <= TOL_SCALED, f"{what}: error {e:.3e} of the conditioning scale > "
                             f"{TOL_SCALED:.0e}")
    return e


def bf16_ulps(got, want32) -> float:
    """max |got - want32| per order plane in units of bfloat16 rounding
    (2^(e - 7) for a plane whose largest |value| is in [2^e, 2^(e+1)))."""
    import torch
    d = (got.float() - want32.float()).abs().reshape(want32.shape[0], -1).amax(-1)
    top = want32.float().abs().reshape(want32.shape[0], -1).amax(-1).clamp_min(1e-30)
    ulp = torch.exp2(torch.floor(torch.log2(top)) - 7)
    return float((d / ulp).max())


def check_kernels(gen, report: dict) -> dict:
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.jet_dense import jet_dense_cuda
    from repro_torch.kernels.tanh_jet import act_jet_cuda

    worst = {"act_jet": 0.0, "jet_dense": 0.0}
    rows = []
    for dt in (torch.float32, torch.float64):
        tol = TOL_F32 if dt == torch.float32 else TOL_F64
        for act in ("tanh", "sigmoid", "sin"):
            for shape in ((37, 45), (8192, 32)):
                e_max = 0.0
                for n in range(1, 9):
                    x = 0.5 * torch.randn((n + 1,) + shape, generator=gen,
                                          device=DEVICE, dtype=dt)
                    got, want = act_jet_cuda(x, act), ref.act_jet_ref(x, act)
                    torch.cuda.synchronize()
                    e = holds(got, want, lambda c: ref.act_jet_ref(c, act), (x,),
                              dt, n, f"act_jet {act} {dt} order {n} {shape}")
                    e_max = max(e_max, e)
                    worst["act_jet"] = max(worst["act_jet"],
                                           float((got - want).abs().max()))
                rows.append(("act_jet", str(dt), act, shape, "1-8", e_max, tol))
        for act in (None, "tanh", "sigmoid", "sin"):
            for bsz, din, dout in ((8192, 2, 32), (8192, 32, 32), (8192, 32, 1),
                                   (77, 13, 45)):
                e_max = 0.0
                for n in (1, 4, 8):
                    x = 0.5 * torch.randn((n + 1, bsz, din), generator=gen,
                                          device=DEVICE, dtype=dt)
                    w = torch.randn((din, dout), generator=gen, device=DEVICE,
                                    dtype=dt) / din ** 0.5
                    b = 0.1 * torch.randn((dout,), generator=gen, device=DEVICE,
                                          dtype=dt)
                    got = jet_dense_cuda(x, w, b, act)
                    want = ref.jet_dense_ref(x, w, b, act)
                    torch.cuda.synchronize()
                    e = holds(got, want,
                              lambda c, ww, bb: ref.jet_dense_ref(c, ww, bb, act),
                              (x, w, b), dt, n, f"jet_dense {act} {dt} order {n} "
                                                f"({bsz},{din}->{dout})")
                    e_max = max(e_max, e)
                    worst["jet_dense"] = max(worst["jet_dense"],
                                             float((got - want).abs().max()))
                rows.append(("jet_dense", str(dt), str(act), (bsz, din, dout),
                             "1,4,8", e_max, tol))
    for r in rows:
        print(f"  {r[0]:9s} {r[1]:13s} {r[2]:7s} {str(r[3]):15s} orders {r[4]:5s} "
              f"max rel err {r[5]:.2e} (tol {r[6]:.0e})")
    report["kernel_checks"] = [dict(zip(("kernel", "dtype", "activation", "shape",
                                         "orders", "max_rel_err", "tol"), r))
                               for r in rows]
    return worst


def check_trunk_kernels(gen, report: dict, worst: dict) -> None:
    """K3 and K4 against their plain versions (see TOL_*)."""
    import torch
    from repro_torch.core.modules import attention_mask, normalize_attention_mask
    from repro_torch.kernels import ref
    from repro_torch.kernels.jet_attention import (jet_flash_attention_cuda,
                                                   jet_rms_norm_cuda)

    worst.update(jet_rms_norm=0.0, jet_flash_attention=0.0)
    rows = []

    def rms_plain(c, g):
        return ref.jet_rms_norm_ref(c, g, 1e-6)

    for dt in (torch.float32, torch.float64):
        tol = TOL_F32 if dt == torch.float32 else TOL_F64
        for bsz, width in ((16384, 32), (37, 24)):
            e_max = 0.0
            for n in range(1, 9):
                x = 0.5 * torch.randn((n + 1, bsz, width), generator=gen,
                                      device=DEVICE, dtype=dt)
                g = 1.0 + 0.2 * torch.randn((width,), generator=gen,
                                            device=DEVICE, dtype=dt)
                got, want = jet_rms_norm_cuda(x, g, 1e-6), rms_plain(x, g)
                torch.cuda.synchronize()
                e_max = max(e_max, holds(got, want, rms_plain, (x, g), dt, n,
                                         f"jet_rms_norm {dt} order {n} "
                                         f"({bsz}, {width})"))
                worst["jet_rms_norm"] = max(worst["jet_rms_norm"],
                                            float((got - want).abs().max()))
            rows.append(("jet_rms_norm", str(dt), "-", (bsz, width), "1-8",
                         e_max, tol))
        for bsz, heads, t, dh, dm in ((8192, 2, 2, 16, 32), (3, 4, 70, 8, 20),
                                      (2, 4, 37, 96, 48)):
            scale = dh ** -0.5
            for mask in FLASH_MASKS:
                kind, window = normalize_attention_mask(mask)
                dense = attention_mask(mask, t, DEVICE)

                def flash_plain(q, k, v, wo):
                    return ref.jet_flash_attention_ref(q, k, v, wo, scale, dense)

                e_max = 0.0
                for n in range(1, 9):
                    q, k, v = (0.5 * torch.randn((n + 1, bsz, heads, t, dh),
                                                 generator=gen, device=DEVICE,
                                                 dtype=dt) for _ in range(3))
                    wo = torch.randn((heads, dh, dm), generator=gen,
                                     device=DEVICE, dtype=dt) / (heads * dh) ** 0.5
                    got = jet_flash_attention_cuda(q, k, v, wo, scale, kind, window)
                    want = flash_plain(q, k, v, wo)
                    torch.cuda.synchronize()
                    e_max = max(e_max, holds(
                        got, want, flash_plain, (q, k, v, wo), dt, n,
                        f"jet_flash_attention {kind}{window or ''} {dt} order "
                        f"{n} ({bsz}, {heads}, {t}, {dh})->{dm}"))
                    worst["jet_flash_attention"] = max(
                        worst["jet_flash_attention"], float((got - want).abs().max()))
                rows.append(("jet_flash_attention", str(dt),
                             f"{kind}{window or ''}", (bsz, heads, t, dh, dm),
                             "1-8", e_max, tol))
    for r in rows:
        print(f"  {r[0]:19s} {r[1]:13s} {r[2]:7s} {str(r[3]):22s} orders {r[4]:5s} "
              f"max rel err {r[5]:.2e} (tol {r[6]:.0e})")
    report["kernel_checks"] += [dict(zip(("kernel", "dtype", "mask", "shape",
                                          "orders", "max_rel_err", "tol"), r))
                                for r in rows]


def check_edge_shapes(gen, report: dict, worst: dict) -> None:
    """Phase 2, the tilings' edges: K1 at DENSE_EDGE_SHAPES for every
    activation and None, K4 at FLASH_EDGE_T x FLASH_EDGE_DH x every mask
    and at the largest head count the wrapper admits, orders EDGE_ORDERS,
    f32 and f64, against the plain versions at the TOL_* gates (f32 sums
    over 1024 keys: the memory rows' rule, holds_f32_sum)."""
    import torch
    from repro_torch.core.modules import attention_mask, normalize_attention_mask
    from repro_torch.kernels import ref
    from repro_torch.kernels.jet_attention import (flash_smem_bytes,
                                                   jet_flash_attention_cuda, _SMEM_LIMIT)
    from repro_torch.kernels.jet_dense import jet_dense_cuda

    rows = []
    for dt in (torch.float32, torch.float64):
        tol = TOL_F32 if dt == torch.float32 else TOL_F64
        for act in (None, "tanh", "sigmoid", "sin"):
            for bsz, din, dout in DENSE_EDGE_SHAPES:
                e_max = 0.0
                for n in EDGE_ORDERS:
                    x = 0.5 * torch.randn((n + 1, bsz, din), generator=gen,
                                          device=DEVICE, dtype=dt)
                    w = torch.randn((din, dout), generator=gen, device=DEVICE,
                                    dtype=dt) / din ** 0.5
                    b = 0.1 * torch.randn((dout,), generator=gen, device=DEVICE, dtype=dt)
                    got = jet_dense_cuda(x, w, b, act)
                    want = ref.jet_dense_ref(x, w, b, act)
                    torch.cuda.synchronize()
                    e_max = max(e_max, holds(
                        got, want, lambda c, ww, bb: ref.jet_dense_ref(c, ww, bb, act),
                        (x, w, b), dt, n, f"jet_dense edge {act} {dt} order {n} "
                                          f"({bsz},{din}->{dout})"))
                    worst["jet_dense"] = max(worst["jet_dense"],
                                             float((got - want).abs().max()))
                rows.append(("jet_dense", str(dt), str(act), (bsz, din, dout), e_max, tol))

        shapes = [(bsz, 2, t, dh, dm, mask) for t, bsz in FLASH_EDGE_T.items()
                  for dh, dm in FLASH_EDGE_DH for mask in FLASH_EDGE_MASKS]
        orders = {shape: EDGE_ORDERS for shape in shapes}
        if dt == torch.float64:      # the head count and head dim at the shared-memory edge
            edge = max(h for h in range(1, 64)
                       if flash_smem_bytes(9, h, 70, 128, dt) <= _SMEM_LIMIT)
            orders[(1, edge, 70, 128, 4, None)] = (8,)
            dh_max = 128
            while flash_smem_bytes(9, 1, 70, dh_max + 1, dt, 4) <= _SMEM_LIMIT:
                dh_max += 1
            orders[(1, 1, 70, dh_max, 4, None)] = (8,)
            over = torch.zeros((9, 1, 1, 70, dh_max + 1), dtype=dt, device=DEVICE)
            try:
                jet_flash_attention_cuda(over, over, over, torch.zeros(
                    (1, dh_max + 1, 4), dtype=dt, device=DEVICE), 0.1)
                msg = None
            except ValueError as exc:
                msg = str(exc)
            require(msg is not None and "bytes of shared memory" in msg,
                    f"jet_flash_attention admitted head dim {dh_max + 1} at order 8 f64, "
                    f"past the largest that fits ({dh_max})")
            print(f"  edge jet_flash_attention: largest head dim admitted at f64 order 8 "
                  f"(T 70, Dm 4): {dh_max}; {dh_max + 1} refused: {msg}")
            report["flash_head_dim_edge"] = {"largest": dh_max, "refusal": msg}
        for (bsz, heads, t, dh, dm, mask), ns in orders.items():
            kind, window = normalize_attention_mask(mask)
            dense = attention_mask(mask, t, DEVICE)
            scale = dh ** -0.5

            def flash_plain(q, k, v, wo):
                return ref.jet_flash_attention_ref(q, k, v, wo, scale, dense)

            e_max = 0.0
            for n in ns:
                q, k, v = (0.5 * torch.randn((n + 1, bsz, heads, t, dh), generator=gen,
                                             device=DEVICE, dtype=dt) for _ in range(3))
                wo = torch.randn((heads, dh, dm), generator=gen, device=DEVICE,
                                 dtype=dt) / (heads * dh) ** 0.5
                got = jet_flash_attention_cuda(q, k, v, wo, scale, kind, window)
                torch.cuda.synchronize()
                what = (f"jet_flash_attention edge {kind}{window or ''} {dt} order {n} "
                        f"({bsz}, {heads}, {t}, {dh})->{dm}")
                if dt == torch.float32 and t >= 1024:
                    e = holds_f32_sum(got, flash_plain, (q, k, v, wo), what)
                else:
                    want = flash_plain(q, k, v, wo)
                    e = holds(got, want, flash_plain, (q, k, v, wo), dt, n, what)
                    worst["jet_flash_attention"] = max(
                        worst["jet_flash_attention"], float((got - want).abs().max()))
                e_max = max(e_max, e)
            rows.append(("jet_flash_attention", str(dt), f"{kind}{window or ''}",
                         (bsz, heads, t, dh, dm), e_max, tol))
    for r in rows:
        print(f"  edge {r[0]:19s} {r[1]:13s} {r[2]:7s} {str(r[3]):24s} max rel err "
              f"{r[4]:.2e} (tol {r[5]:.0e})")
    report["edge_checks"] = [dict(zip(("kernel", "dtype", "variant", "shape",
                                       "max_rel_err", "tol"), r)) for r in rows]


def _kernel_cases(gen, n: int, dt, served_only: bool = False) -> list:
    """(name, label, kernel call, plain version, args) for K1-K5 at order
    ``n``: K2 and K1 at the served DenseMLP layer (n+1, 8192, 32) and the
    Burgers net's (n+1, 512, 24) -> 24, K3 at the trunk's (n+1, 16384, 32),
    K4 at the served (n+1, 8192, 2, 2, 16) x (2, 16, 32) and a ragged
    multi-tile (n+1, 3, 4, 70, 8) x (4, 8, 20) causal, K5 at the memory
    comparison's (n+1, 4, 256, 8) and a ragged (n+1, 2, 70, 16);
    ``served_only`` keeps the first shape of each."""
    import torch
    from repro_torch.core.modules import attention_mask
    from repro_torch.kernels import ref
    from repro_torch.kernels.jet_attention import (jet_attention_scores_cuda,
                                                   jet_flash_attention_cuda,
                                                   jet_rms_norm_cuda)
    from repro_torch.kernels.jet_dense import jet_dense_cuda
    from repro_torch.kernels.tanh_jet import act_jet_cuda

    def rnd(*shape, scale=0.5):
        return (scale * torch.randn(shape, generator=gen, device=DEVICE,
                                    dtype=torch.float64)).to(dt)

    cases = []
    for rows, din, dout in ((8192, 32, 32), (512, 24, 24))[:1 if served_only else 2]:
        x, w, b = rnd(n + 1, rows, din), rnd(din, dout, scale=din ** -0.5), rnd(dout, scale=0.1)
        cases.append(("act_jet", f"({n + 1}, {rows}, {din}) tanh",
                      lambda x=x: act_jet_cuda(x, "tanh"),
                      lambda c: ref.act_jet_ref(c, "tanh"), (x,)))
        cases.append(("jet_dense", f"({n + 1}, {rows}, {din})x({din}, {dout}) tanh",
                      lambda x=x, w=w, b=b: jet_dense_cuda(x, w, b, "tanh"),
                      lambda c, ww, bb: ref.jet_dense_ref(c, ww, bb, "tanh"), (x, w, b)))
    x, g = rnd(n + 1, 16384, 32), 1 + rnd(32, scale=0.2)
    cases.append(("jet_rms_norm", f"({n + 1}, 16384, 32)",
                  lambda x=x, g=g: jet_rms_norm_cuda(x, g, 1e-6),
                  lambda c, gg: ref.jet_rms_norm_ref(c, gg, 1e-6), (x, g)))
    for bsz, heads, t, dh, dm, mask in ((8192, 2, 2, 16, 32, None),
                                        (3, 4, 70, 8, 20, "causal"))[:1 if served_only else 2]:
        q, k, v = (rnd(n + 1, bsz, heads, t, dh) for _ in range(3))
        wo = rnd(heads, dh, dm, scale=(heads * dh) ** -0.5)
        dense, scale = attention_mask(mask, t, DEVICE), dh ** -0.5
        cases.append(("jet_flash_attention",
                      f"({n + 1}, {bsz}, {heads}, {t}, {dh})x({heads}, {dh}, {dm}) {mask or 'none'}",
                      lambda q=q, k=k, v=v, wo=wo, mask=mask, scale=scale:
                      jet_flash_attention_cuda(q, k, v, wo, scale, mask or "none"),
                      lambda a, bb, c, d, dense=dense, scale=scale:
                      ref.jet_flash_attention_ref(a, bb, c, d, scale, dense), (q, k, v, wo)))
    for bsz, t, d in ((4, 256, 8), (2, 70, 16))[:1 if served_only else 2]:
        q, k = rnd(n + 1, bsz, t, d, scale=0.6), rnd(n + 1, bsz, t, d, scale=0.6)
        cases.append(("jet_attention_scores", f"({n + 1}, {bsz}, {t}, {d})",
                      lambda q=q, k=k, d=d: jet_attention_scores_cuda(q, k, d ** -0.5),
                      lambda a, bb, d=d: ref.jet_attention_scores_ref(a, bb, d ** -0.5),
                      (q, k)))
    return cases


def check_high_orders(gen, report: dict, worst: dict) -> None:
    """Phase 2, K1-K5 past the templates (csrc/jet_runtime.cu): orders
    HIGH_ORDERS at f64 (the TOL_SCALED gate) and f32 (``holds``) at the
    shapes of ``_kernel_cases``, K1 and K2 also bit for bit; then bfloat16
    at the served shapes, orders 1, 4 and 10, held to the f32 plain version
    within BF16_ULPS."""
    import torch
    from repro_torch.tree import bit_equal
    rows = []
    for dt in (torch.float64, torch.float32):
        for n in HIGH_ORDERS:
            for name, label, call, plain, args in _kernel_cases(gen, n, dt):
                got = call()
                torch.cuda.synchronize()
                e = holds_high(got, plain, args, dt, n, f"{name} {label} {dt} order {n}")
                want = plain(*args)
                diff = float((got - want).abs().max())
                worst[name] = max(worst[name], diff)
                # the dense epilogue rounds op by op as ref.py, the GEMM part
                # as the plain version's at these shapes: bit for bit
                require(name not in ("act_jet", "jet_dense") or bit_equal(got, want),
                        f"{name} {label} {dt} order {n}: differs from its plain version "
                        f"by {diff:.3e}, not bit for bit")
                rows.append((name, str(dt), n, label, e))
    for n in (1, 4, 10):
        for name, label, call, plain, args in _kernel_cases(gen, n, torch.bfloat16,
                                                            served_only=True):
            got = call()
            torch.cuda.synchronize()
            require(got.dtype == torch.bfloat16, f"{name} bf16 returned {got.dtype}")
            e = bf16_ulps(got, plain(*(a.float() for a in args)))
            require(e <= BF16_ULPS, f"{name} {label} bf16 order {n}: {e:.2f} bf16 ulps of "
                                    f"the plane max > {BF16_ULPS}")
            rows.append((name, "torch.bfloat16", n, label, e))
    for r in rows:
        unit = "bf16 ulps" if r[1] == "torch.bfloat16" else (
            "of the scale" if r[1] == "torch.float64" else "rel")
        print(f"  high/bf16 {r[0]:20s} {r[1]:14s} order {r[2]:2d} {r[3]:44s} err {r[4]:.2e} "
              f"{unit}")
    report["high_order_checks"] = [dict(zip(("kernel", "dtype", "order", "shape", "err"), r))
                                   for r in rows]


# Phase 2e, the run-time-order K3 and K4 where their geometries split:
# K4 (bsz, heads, T, Dh, Dm, masks) at short T (groups of lanes: the
# trunk's grid(10) launch, T 1, 3 and 4, head dims 160 and 256) and long T
# (key tiles: T 70 and 1024); K3 (rows, width, aligned) with 16-byte
# vectors, ragged widths (one element a lane) and an unaligned view
RT_FLASH_CHECKS = ((1024, 2, 2, 16, 32, FLASH_MASKS), (37, 2, 1, 16, 32, (None,)),
                   (37, 2, 3, 20, 7, FLASH_MASKS), (13, 2, 4, 8, 16, (("local", 1),)),
                   (5, 2, 2, 160, 40, (None,)), (3, 2, 2, 256, 24, ("causal",)),
                   (3, 4, 70, 8, 20, (("local", 5),)), (2, 2, 1024, 8, 16, (None, "causal")))
RT_FLASH_LONG_ORDERS = (9, 10)    # T = 1024: the plain version's T^2 planes
RT_RMS_CHECKS = ((2048, 32, True), (37, 24, True), (70, 33, True), (64, 32, False))


def flash_kernel_kind(geo) -> str:
    """Which K4 kernel a geometry runs (see ``FlashGeometry``)."""
    if not geo.runtime:
        return "template " + ("short" if geo.group else "long")
    return "short" if geo.group else "long" if geo.key_tile else "smallest block"


def check_runtime_attention(gen, report: dict, worst: dict) -> None:
    """Phase 2e: the run-time-order K3 and K4 at RT_RMS_CHECKS and
    RT_FLASH_CHECKS against their plain versions, at the existing gates:
    orders HIGH_ORDERS at f64 (TOL_SCALED of the abs-sum scale) and f32
    (``holds``; f32 over 1024 keys by ``holds_f32_sum``), T = 1024 at
    RT_FLASH_LONG_ORDERS only; bfloat16 at orders 1, 4 and 10 within
    BF16_ULPS of the f32 plain version.  The trunk's grid(10) launch must
    take the short-T kernel, T = 1024 the long-T one."""
    import torch
    from repro_torch.core.modules import attention_mask, normalize_attention_mask
    from repro_torch.kernels import jet_attention as ka
    from repro_torch.kernels import ref

    def rnd(*shape, dt, scale=0.5):
        return (scale * torch.randn(shape, generator=gen, device=DEVICE,
                                    dtype=torch.float64)).to(dt)

    def gate(got, plain, args, dt, n, what):
        torch.cuda.synchronize()
        if dt == torch.bfloat16:
            e = bf16_ulps(got, plain(*(a.float() for a in args)))
            require(e <= BF16_ULPS, f"{what}: {e:.2f} bf16 ulps of the plane max > {BF16_ULPS}")
            return e
        if dt == torch.float32 and args[0].shape[3:4] == (1024,):
            return holds_f32_sum(got, plain, args, what)
        return holds_high(got, plain, args, dt, n, what)

    rows = []
    dtypes = ((torch.float64, HIGH_ORDERS), (torch.float32, HIGH_ORDERS),
              (torch.bfloat16, (1, 4, 10)))
    for dt, orders in dtypes:
        for bsz, width, aligned in RT_RMS_CHECKS:
            e_max = 0.0
            for n in orders:
                flat = rnd((n + 1) * bsz * width + 1, dt=dt)    # unaligned: one element in
                x = (flat[:-1] if aligned else flat[1:]).view(n + 1, bsz, width)
                g = 1 + rnd(width, dt=dt, scale=0.2)
                geo = ka.rms_norm_geometry(n + 1, bsz, width, dt, aligned)
                got = ka.jet_rms_norm_cuda(x, g, 1e-6)
                e_max = max(e_max, gate(got, lambda c, gg: ref.jet_rms_norm_ref(c, gg, 1e-6),
                                        (x, g), dt, n, f"jet_rms_norm run-time {dt} order "
                                                       f"{n} ({bsz}, {width}) {geo}"))
            rows.append(("jet_rms_norm", str(dt), f"vec {geo.vec} group {geo.group}",
                         (bsz, width), orders, e_max))
        for bsz, heads, t, dh, dm, masks in RT_FLASH_CHECKS:
            for mask in masks:
                kind, window = normalize_attention_mask(mask)
                dense = attention_mask(mask, t, DEVICE)
                scale = dh ** -0.5

                def flash_plain(q, k, v, wo, dense=dense, scale=scale):
                    return ref.jet_flash_attention_ref(q, k, v, wo, scale, dense)

                e_max, ns = 0.0, orders
                if t >= 1024 and dt != torch.bfloat16:
                    ns = RT_FLASH_LONG_ORDERS
                for n in ns:
                    q, k, v = (rnd(n + 1, bsz, heads, t, dh, dt=dt) for _ in range(3))
                    wo = rnd(heads, dh, dm, dt=dt, scale=(heads * dh) ** -0.5)
                    geo = ka.flash_geometry(n + 1, heads, t, dh, dt, dm)
                    got = ka.jet_flash_attention_cuda(q, k, v, wo, scale, kind, window)
                    e_max = max(e_max, gate(got, flash_plain, (q, k, v, wo), dt, n,
                                            f"jet_flash_attention run-time {kind}{window or ''} "
                                            f"{dt} order {n} ({bsz}, {heads}, {t}, {dh})->{dm} "
                                            f"{geo}"))
                    worst["jet_flash_attention"] = max(worst["jet_flash_attention"], float(
                        (got.double() - flash_plain(q, k, v, wo).double()).abs().max()))
                kernel = flash_kernel_kind(geo)
                if (bsz, t, dh) == (1024, 2, 16) or t >= 1024:
                    require(kernel == ("short" if t <= 4 else "long"),
                            f"K4 ({bsz}, {heads}, {t}, {dh}) {dt} took the {kernel} kernel")
                rows.append(("jet_flash_attention", str(dt), f"{kernel} {kind}{window or ''}",
                             (bsz, heads, t, dh, dm), ns, e_max))
    for r in rows:
        unit = "bf16 ulps" if r[1] == "torch.bfloat16" else (
            "of the scale" if r[1] == "torch.float64" else "rel")
        print(f"  run-time {r[0]:19s} {r[1]:14s} {r[2]:22s} {str(r[3]):22s} orders "
              f"{str(r[4]):15s} err {r[5]:.2e} {unit}")
    report["runtime_attention_checks"] = [
        dict(zip(("kernel", "dtype", "variant", "shape", "orders", "err"), r)) for r in rows]


# Phase 2e, the run-time K5 (csrc/jet_runtime.cu) where its geometry splits:
# (B, T, D) at SCORES_EDGE_T x SCORES_EDGE_D take the tiled kernel (between
# them the whole row in one stage and a ring of two, a key split of 1 and
# of several warps: asserted), (2, 70, 128) the smallest block, and at
# order 10 f64 the largest head dim admitted (T 3, the smallest block) and
# one more, refused.  Orders: f64 RT_SCORES_F64_ORDERS, f32 10, bfloat16 2
# and 10.
RT_SCORES_F64_ORDERS = (10, 12, 16)
RT_SCORES_SMALLEST = ((2, 70, 128),)


def scores_kernel_kind(geo) -> str:
    """Which run-time K5 kernel a geometry runs (see ``ScoresGeometry``)."""
    if geo.smallest:
        return "smallest block"
    return "tiled " + ("whole row" if geo.whole else "ring")


def holds_row_sums_scaled(got, scale, what: str) -> float:
    """K5's row sums in f64 above the templates' orders: |sum_keys p_m -
    [m == 0]| within TOL_SCALED of the sum over the keys of p_m's abs-sum
    conditioning scale (the rounding of any order of evaluation of each
    p_m is relative to its scale, so the sum's is relative to their sum)."""
    sums = got.double().sum(-1)
    sums[0] -= 1.0
    mass = scale.double().sum(-1).clamp_min(1e-300)
    e = float((sums.abs() / mass).max())
    require(e <= TOL_SCALED, f"{what}: rows sum off by {e:.3e} of their scale > "
                             f"{TOL_SCALED:.0e}")
    return e


def check_runtime_scores(gen, report: dict, worst: dict) -> None:
    """Phase 2e: the run-time K5 against its plain version at the edges of
    its geometry (RT_SCORES_*), f64 within TOL_SCALED of the abs-sum scale
    (rows summing to 1 / 0 within TOL_SCALED of their scale), f32 by
    ``holds`` (row sums by ``holds_row_sums``), bfloat16 within BF16_ULPS of
    the f32 plain version (row sums within F32_DRIFT times those of the
    plain version rounded to bfloat16); the kernels and stagings asserted;
    the largest head dim admitted at order 10 f64 runs, one more is
    refused."""
    import torch
    from repro_torch.kernels import jet_attention as ka
    from repro_torch.kernels import ref

    f64, f32, bf16 = torch.float64, torch.float32, torch.bfloat16
    d_max = max(d for d in range(1, 4096)
                if ka.scores_runtime_geometry(11, 3, d, f64, 1).smem <= ka._SMEM_LIMIT)
    over = torch.zeros((11, 1, 3, d_max + 1), dtype=f64, device=DEVICE)
    try:
        ka.jet_attention_scores_cuda(over, over, 0.1)
        refused = False
    except ValueError:
        refused = True
    require(refused, f"run-time jet_attention_scores admitted head dim {d_max + 1} at order "
                     f"10 f64, past the largest that fits ({d_max})")
    edges = [(bsz, t, d) for t, bsz in SCORES_EDGE_T.items() for d in SCORES_EDGE_D]
    cases = [(f64, shape, RT_SCORES_F64_ORDERS) for shape in edges + list(RT_SCORES_SMALLEST)]
    cases += [(f64, (1, 3, d_max), (10,))]
    cases += [(f32, shape, (10,)) for shape in edges] + [(bf16, shape, (2, 10)) for shape in edges]
    rows, seen = [], set()
    for dt, (bsz, t, d), orders in cases:
        scale = d ** -0.5

        def plain(a, b, scale=scale):
            return ref.jet_attention_scores_ref(a, b, scale)

        e_max, rs_max, kinds = 0.0, 0.0, set()
        for n in orders:
            q, k = ((0.6 * torch.randn((n + 1, bsz, t, d), generator=gen, device=DEVICE,
                                       dtype=f64)).to(dt) for _ in range(2))
            geo = ka.scores_runtime_geometry(n + 1, t, d, dt, bsz)
            kinds.add(scores_kernel_kind(geo))
            seen.add((scores_kernel_kind(geo), geo.split > 1 and not geo.smallest))
            got = ka.jet_attention_scores_cuda(q, k, scale)
            torch.cuda.synchronize()
            what = f"jet_attention_scores run-time {dt} order {n} ({bsz}, {t}, {d}) {tuple(geo)}"
            if dt == bf16:
                want = plain(q.float(), k.float())
                e = bf16_ulps(got, want)
                require(e <= BF16_ULPS, f"{what}: {e:.2f} bf16 ulps of the plane max > "
                                        f"{BF16_ULPS}")
                rs, rs_plain = row_sum_dev(got), row_sum_dev(want.to(bf16))
                require(rs <= F32_DRIFT * max(rs_plain, TOL_F32),
                        f"{what}: rows sum off by {rs:.3e} of their mass, the plain version "
                        f"rounded to bfloat16 {rs_plain:.3e}")
            elif dt == f64:
                want = plain(q, k)
                sc = abs_sum(plain, q, k)
                e = scaled_err(got, want, sc)
                require(e <= TOL_SCALED, f"{what}: error {e:.3e} of the conditioning scale > "
                                         f"{TOL_SCALED:.0e}")
                rs = holds_row_sums_scaled(got, sc, what)
                worst["jet_attention_scores"] = max(worst["jet_attention_scores"],
                                                    float((got - want).abs().max()))
            else:
                want = plain(q, k)
                e = holds(got, want, plain, (q, k), dt, n, what)
                rs = holds_row_sums(got, want, dt, n, what)
            if t == 1:
                require(bool((got[0].float() == 1).all()) and bool((got[1:].float() == 0).all()),
                        f"{what}: one key's probabilities are not exactly (1, 0, ..., 0)")
            e_max, rs_max = max(e_max, e), max(rs_max, rs)
        rows.append((str(dt), (bsz, t, d), orders, "/".join(sorted(kinds)), e_max, rs_max))
    for kind in ("tiled whole row", "tiled ring", "smallest block"):
        require(any(k == kind for k, _ in seen), f"the run-time K5 checks ran no {kind}")
    for split in (True, False):
        require((("tiled whole row", split) in seen) or (("tiled ring", split) in seen),
                f"the run-time K5 checks ran no key split {'of several warps' if split else 'of 1'}")
    for r in rows:
        unit = "bf16 ulps" if r[0] == "torch.bfloat16" else (
            "of the scale" if r[0] == "torch.float64" else "rel")
        print(f"  run-time jet_attention_scores {r[0]:14s} {str(r[1]):14s} orders {str(r[2]):12s} "
              f"{r[3]:26s} err {r[4]:.2e} {unit}, row sums {r[5]:.2e}")
    print(f"  largest head dim admitted at order 10 f64: {d_max} (ran); {d_max + 1} refused")
    report["runtime_scores_checks"] = {
        "largest_head_dim_order10_f64": d_max,
        "cases": [dict(zip(("dtype", "shape", "orders", "kernels", "err", "row_sum_dev"), r))
                  for r in rows]}


def check_admitted_orders(gen, report: dict) -> None:
    """Phase 2, the largest order each wrapper admits at its served shape
    (float64), and the refusal one order past it, whose message names the
    bytes.  K3-K5 run at that order on a few rows: outputs finite, and
    their first 17 planes equal (TOL_SCALED of the scale) the same kernel's
    order-16 output on the same inputs' first 17 planes, which is exact
    math (order m of a jet reads inputs of orders <= m).  K1/K2 are not
    launched there: their epilogue reads the Faa di Bruno table of that
    order, whose term count grows as the partition numbers (p(453) ~ 1e20).
    Their smallest block (32 elements, or one row of 32 columns, the table
    in device memory) keeps 2 n1 words an element whatever the tile."""
    import re as _re

    import torch
    from repro_torch.kernels import jet_attention as ka
    from repro_torch.kernels import tanh_jet as k2
    from repro_torch.kernels.jet_attention import (jet_attention_scores_cuda,
                                                   jet_flash_attention_cuda,
                                                   jet_rms_norm_cuda)
    from repro_torch.kernels.jet_dense import jet_dense_cuda
    from repro_torch.kernels.tanh_jet import act_jet_cuda

    dt, out = torch.float64, {}

    def largest(fits) -> int:
        n1 = 17
        while fits(n1 + 1):
            n1 += 1
        return n1

    def refused(call, n1) -> str:
        try:
            call(n1)
        except ValueError as exc:
            msg = str(exc)
            require(_re.search(r"needs \d+ bytes of shared memory", msg) is not None,
                    f"refusal names no bytes: {msg}")
            return msg
        raise SmokeFailure(f"order {n1 - 1} was admitted, past the largest that fits")

    def rnd(*shape, scale=0.5):
        return scale * torch.randn(shape, generator=gen, device=DEVICE, dtype=dt)

    def stack(n1, *shape, scale=0.5):
        """Coefficient planes decaying as 10^-j, so that the jets of the
        rsqrt and exp recurrences stay finite at every order."""
        decay = torch.full((n1,), 0.1, dtype=dt, device=DEVICE).cumprod(0) * 10
        return rnd(n1, *shape, scale=scale) * decay.reshape((n1,) + (1,) * len(shape))

    limits = {
        "act_jet": largest(lambda n1: k2.act_jet_min_smem(n1, dt) <= k2.SMEM_LIMIT),
        "jet_dense": largest(lambda n1: k2.jet_dense_min_smem(n1, dt, 32) <= k2.SMEM_LIMIT),
        "jet_rms_norm": largest(lambda n1: ka.rms_norm_geometry(
            n1, 2, 32, dt).smem <= ka._SMEM_LIMIT),
        "jet_flash_attention": largest(lambda n1: ka.flash_smem_bytes(
            n1, 2, 2, 16, dt, 32) <= ka._SMEM_LIMIT),
        "jet_attention_scores": largest(lambda n1: ka.scores_runtime_geometry(
            n1, 16, 8, dt, 1).smem <= ka._SMEM_LIMIT)}
    calls = {
        "act_jet": lambda n1: act_jet_cuda(torch.zeros((n1, 1, 32), dtype=dt,
                                                       device=DEVICE), "tanh"),
        "jet_dense": lambda n1: jet_dense_cuda(
            torch.zeros((n1, 1, 32), dtype=dt, device=DEVICE),
            torch.zeros((32, 32), dtype=dt, device=DEVICE),
            torch.zeros((32,), dtype=dt, device=DEVICE), "tanh")}
    inputs = {
        "jet_rms_norm": lambda n1: (stack(n1, 2, 32), 1 + rnd(32, scale=0.2)),
        "jet_flash_attention": lambda n1: (*(stack(n1, 2, 2, 2, 16) for _ in range(3)),
                                           rnd(2, 16, 32, scale=32 ** -0.5)),
        "jet_attention_scores": lambda n1: (stack(n1, 1, 16, 8, scale=0.6),
                                            stack(n1, 1, 16, 8, scale=0.6))}
    kernels = {"jet_rms_norm": lambda x, g: jet_rms_norm_cuda(x, g, 1e-6),
               "jet_flash_attention": lambda q, k, v, wo: jet_flash_attention_cuda(
                   q, k, v, wo, 0.25),
               "jet_attention_scores": lambda q, k: jet_attention_scores_cuda(q, k, 8 ** -0.5)}
    for name, fn in kernels.items():
        calls[name] = lambda n1, name=name, fn=fn: fn(*inputs[name](n1))
    for name, n1 in limits.items():
        msg = refused(calls[name], n1 + 1)
        entry = {"largest_order": n1 - 1, "refusal": msg}
        if name in kernels:
            args = inputs[name](n1)
            top = kernels[name](*args)
            low = kernels[name](*(a[:17] if a.shape[0] == n1 else a for a in args))
            torch.cuda.synchronize()
            require(bool(torch.isfinite(top).all()), f"{name} at order {n1 - 1}: non-finite")
            e = scaled_err(top[:17], low, low.abs())
            require(e <= TOL_SCALED, f"{name} at order {n1 - 1}: its first 17 planes "
                                     f"differ from the order-16 launch by {e:.3e}")
            entry["first_17_planes_vs_order_16"] = e
        out[name] = entry
        print(f"  {name:20s} largest order admitted at the served shape, f64: {n1 - 1}"
              + (f" (ran; first 17 planes vs order 16: {entry['first_17_planes_vs_order_16']:.1e})"
                 if name in kernels else " (not launched: see PERF.md)")
              + f"; order {n1} refused: {msg}")
    report["admitted_orders"] = out


def row_sum_dev(p) -> float:
    """Worst |sum_keys p_m - [m == 0]| relative to the row's absolute mass
    sum_keys |p_m| (floored at 1): the softmax jet's rows sum to 1 at order
    0 and to 0 at every higher order."""
    import torch
    p = p.double()
    sums, mass = p.sum(-1), p.abs().sum(-1).clamp_min(1.0)
    sums[0] -= 1.0
    return float((sums.abs() / mass).max())


def holds_row_sums(got, want, dt, n: int, what: str) -> float:
    """K5's row-sum invariant (row_sum_dev) at the kernel gates: f64
    TOL_F64; f32 TOL_F32 through order F32_EXACT_ORDERS, above that within
    F32_DRIFT times the plain version's own deviation."""
    import torch
    rs, rs_plain = row_sum_dev(got), row_sum_dev(want)
    allowed = (TOL_F64 if dt == torch.float64 else TOL_F32 if n <= F32_EXACT_ORDERS
               else F32_DRIFT * max(rs_plain, TOL_F32))
    require(rs <= allowed, f"{what}: rows sum off by {rs:.3e} of their mass (plain "
                           f"{rs_plain:.3e}; allowed {allowed:.1e})")
    return rs


def check_scores_kernel(gen, report: dict, worst: dict) -> None:
    """Phase 2c: K5 against its plain version (TOL_* gates) and the row-sum
    invariant (f64: TOL_F64; f32: TOL_F32 through order F32_EXACT_ORDERS,
    above that within F32_DRIFT times the plain version's own deviation)."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.jet_attention import jet_attention_scores_cuda

    worst["jet_attention_scores"] = 0.0
    rows = []
    for dt in (torch.float32, torch.float64):
        tol = TOL_F32 if dt == torch.float32 else TOL_F64
        for bsz, t, d in SCORES_SHAPES:
            scale = d ** -0.5

            def plain(q, k):
                return ref.jet_attention_scores_ref(q, k, scale)

            e_max, rs_max = 0.0, 0.0
            for n in range(1, 9):
                q, k = (0.6 * torch.randn((n + 1, bsz, t, d), generator=gen,
                                          device=DEVICE, dtype=dt) for _ in range(2))
                got, want = jet_attention_scores_cuda(q, k, scale), plain(q, k)
                torch.cuda.synchronize()
                what = f"jet_attention_scores {dt} order {n} ({bsz}, {t}, {d})"
                e_max = max(e_max, holds(got, want, plain, (q, k), dt, n, what))
                worst["jet_attention_scores"] = max(
                    worst["jet_attention_scores"], float((got - want).abs().max()))
                rs_max = max(rs_max, holds_row_sums(got, want, dt, n, what))
            rows.append(("jet_attention_scores", str(dt), (bsz, t, d), "1-8", e_max,
                         rs_max, tol))
    for r in rows:
        print(f"  {r[0]:20s} {r[1]:13s} {str(r[2]):13s} orders {r[3]:4s} max rel err "
              f"{r[4]:.2e}, row sums {r[5]:.2e} (tol {r[6]:.0e})")
    report["kernel_checks"] += [dict(zip(("kernel", "dtype", "shape", "orders",
                                          "max_rel_err", "row_sum_dev", "tol"), r))
                                for r in rows]


def check_scores_edges(gen, report: dict, worst: dict) -> None:
    """Phase 2c, K5's edges: (B, T, D) at SCORES_EDGE_T x SCORES_EDGE_D,
    orders EDGE_ORDERS, f32 and f64, against the plain version and the row-sum invariant at the TOL_* gates;
    the geometries they ran must include the whole-row and the ring staging
    and a key split of 1 and of more.  Plus, at f64 order 8, the largest
    head dim the wrapper admits (T 70), and one more, which it refuses."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.jet_attention import (_SMEM_LIMIT, jet_attention_scores_cuda,
                                                   scores_geometry)

    rows, seen = [], set()
    shapes = [(bsz, t, d) for t, bsz in SCORES_EDGE_T.items() for d in SCORES_EDGE_D]
    for dt in (torch.float32, torch.float64):
        tol = TOL_F32 if dt == torch.float32 else TOL_F64
        cases = [(shape, EDGE_ORDERS) for shape in shapes]
        if dt == torch.float64:
            d_max = max(d for d in range(1, 512)
                        if scores_geometry(9, 70, d, dt, 1).smem <= _SMEM_LIMIT)
            cases.append(((1, 70, d_max), (8,)))
            over = torch.zeros((9, 1, 70, d_max + 1), dtype=dt, device=DEVICE)
            try:
                jet_attention_scores_cuda(over, over, 0.1)
                refused = False
            except ValueError:
                refused = True
            require(refused, f"jet_attention_scores admitted head dim {d_max + 1} at "
                             f"order 8 f64, past the largest that fits ({d_max})")
        for (bsz, t, d), orders in cases:
            scale = d ** -0.5

            def plain(q, k):
                return ref.jet_attention_scores_ref(q, k, scale)

            e_max, rs_max, geos_run = 0.0, 0.0, set()
            for n in orders:
                q, k = (0.6 * torch.randn((n + 1, bsz, t, d), generator=gen,
                                          device=DEVICE, dtype=dt) for _ in range(2))
                want = plain(q, k)
                geo = scores_geometry(n + 1, t, d, dt, bsz)
                seen.add((geo.whole, geo.split > 1))
                geos_run.add(tuple(geo[:4]))
                got = jet_attention_scores_cuda(q, k, scale)
                torch.cuda.synchronize()
                what = (f"jet_attention_scores edge {dt} order {n} ({bsz}, {t}, {d}) "
                        f"{tuple(geo[:4])}")
                e_max = max(e_max, holds(got, want, plain, (q, k), dt, n, what))
                worst["jet_attention_scores"] = max(
                    worst["jet_attention_scores"], float((got - want).abs().max()))
                rs_max = max(rs_max, holds_row_sums(got, want, dt, n, what))
            rows.append(("jet_attention_scores", str(dt), (bsz, t, d), orders, e_max, rs_max,
                         tol, sorted(geos_run)))
    for whole in (True, False):
        require(any(w == whole for w, _ in seen),
                f"the K5 edges ran no {'whole-row' if whole else 'ring'} staging")
    for split in (True, False):
        require(any(sp == split for _, sp in seen),
                f"the K5 edges ran no key split {'of several warps' if split else 'of 1'}")
    for r in rows:
        staging = "/".join(sorted({"ring" if g[3] > 1 else "whole row" for g in r[7]}))
        splits = sorted({g[1] for g in r[7]})
        print(f"  edge {r[0]:20s} {r[1]:13s} {str(r[2]):13s} orders {str(r[3]):9s} max rel "
              f"err {r[4]:.2e}, row sums {r[5]:.2e} (tol {r[6]:.0e}); {staging}, split "
              f"{splits}")
    report["edge_checks"] += [dict(zip(("kernel", "dtype", "shape", "orders", "max_rel_err",
                                        "row_sum_dev", "tol", "geometries"), r)) for r in rows]


def holds_f32_sum(got, plain, args, what: str) -> float:
    """A float32 kernel result whose sums run over up to 1024 keys, held
    against the plain version in float64 on the same inputs: within
    F32_DRIFT times the plain version's own float32 error (floored at
    TOL_F32).  Returns the kernel's error relative to the f64 result."""
    exact = plain(*(a.double() for a in args))
    e_kernel = rel_err(got, exact, 1)
    e_plain = rel_err(plain(*args), exact, 1)
    require(e_kernel <= F32_DRIFT * max(e_plain, TOL_F32),
            f"{what}: f32 error vs f64 {e_kernel:.3e}, the plain version's "
            f"{e_plain:.3e}; allowed {F32_DRIFT:g}x")
    return e_kernel


def peak_bytes(fn):
    """(peak of ``torch.cuda.max_memory_allocated`` above what was allocated
    before ``fn`` ran, inputs included; ``fn``'s result)."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base, out


def memory_rows(gen, report: dict) -> dict:
    """Phase 2d, K5's path: the rows of the reference's
    benchmarks/memory_scaling.py::_attention_rows on the card, through the
    public ops.  Order 2, B = 2, H = 2, Dh = 8, Dm = 16, f32: the
    materializing score jet (3, B*H, T, T) against the flash block, whose
    output is (3, B, T, Dm).  Also the score op's backward against the plain
    version's.  Launch counts are zeroed before and read after."""
    import torch
    from repro_torch.kernels import ops, ref

    n1 = MEMORY["order"] + 1
    bsz, heads, dh, dm = MEMORY["bsz"], MEMORY["heads"], MEMORY["dh"], MEMORY["dm"]
    scale = dh ** -0.5
    out = {"config": dict(MEMORY, dtype="torch.float32"), "rows": []}
    checks = {}
    ops.reset_launch_counts()
    for t in MEMORY_T:
        q, k, v = (torch.randn((n1, bsz, heads, t, dh), generator=gen, device=DEVICE,
                               dtype=torch.float32) for _ in range(3))
        wo = torch.randn((heads, dh, dm), generator=gen, device=DEVICE,
                         dtype=torch.float32)
        scores, p = peak_bytes(lambda: ops.jet_attention_scores(q, k, scale))
        flash, o = peak_bytes(lambda: ops.jet_flash_attention(q, k, v, wo, scale))
        flat = (q.reshape(n1, bsz * heads, t, dh), k.reshape(n1, bsz * heads, t, dh))
        checks[t] = (
            holds_f32_sum(p.reshape(n1, bsz * heads, t, t),
                          lambda a, b: ref.jet_attention_scores_ref(a, b, scale), flat,
                          f"memory row T={t}: jet_attention_scores"),
            holds_f32_sum(o, lambda *a: ref.jet_flash_attention_ref(*a, scale),
                          (q, k, v, wo), f"memory row T={t}: jet_flash_attention"))
        del p, o
        out["rows"].append({"T": t, "scores_peak_bytes": scores,
                            "flash_peak_bytes": flash, "rel_err_vs_f64": checks[t],
                            "scores_output_bytes": n1 * bsz * heads * t * t * 4,
                            "flash_output_bytes": n1 * bsz * t * dm * 4})
        print(f"  T={t:5d}: peak above inputs, jet_attention_scores {scores / 1e6:9.3f} MB, "
              f"jet_flash_attention {flash / 1e6:7.3f} MB; rel err vs f64 "
              f"{checks[t][0]:.2e} / {checks[t][1]:.2e}")
    # the op's backward (recompute through the plain version) on the card
    q, k = (torch.randn((n1, bsz, heads, 64, dh), generator=gen, device=DEVICE,
                        dtype=torch.float64, requires_grad=True) for _ in range(2))
    g = torch.randn((n1, bsz, heads, 64, 64), generator=gen, device=DEVICE,
                    dtype=torch.float64)
    got = torch.autograd.grad(ops.jet_attention_scores(q, k, scale), (q, k), g)
    want = torch.autograd.grad(
        ref.jet_attention_scores_ref(q.reshape(n1, -1, 64, dh),
                                     k.reshape(n1, -1, 64, dh), scale),
        (q, k), g.reshape(n1, -1, 64, 64))
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    e = max(rel_err(a, b, 0) for a, b in zip(got, want))
    require(e <= TOL_F64, f"jet_attention_scores backward vs plain: {e:.3e}")
    # one launch of each kernel per T, and the score op's forward under
    # autograd (its backward recomputes through the plain version)
    want_k5 = len(MEMORY_T) + 1
    print(f"  backward vs plain {e:.2e} (tol {TOL_F64:.0e}); launches {launches}")
    require(launches["jet_attention_scores"] == want_k5,
            f"jet_attention_scores launched {launches['jet_attention_scores']} "
            f"times, want {want_k5}")
    require(launches["jet_flash_attention"] == len(MEMORY_T)
            and launches["jet_dense"] == launches["jet_rms_norm"] == 0,
            f"memory phase launched {launches}")
    rows = out["rows"]
    t_ratio = MEMORY_T[-1] / MEMORY_T[0]
    s_growth = rows[-1]["scores_peak_bytes"] / rows[0]["scores_peak_bytes"]
    f_growth = rows[-1]["flash_peak_bytes"] / rows[0]["flash_peak_bytes"]
    print(f"  growth T {MEMORY_T[0]} -> {MEMORY_T[-1]} ({t_ratio:g}x): scores "
          f"{s_growth:.1f}x (T^2 = {t_ratio ** 2:g}x), flash {f_growth:.1f}x")
    require(s_growth >= 0.5 * t_ratio ** 2,
            f"the score jet's peak grew {s_growth:.1f}x, not with T^2")
    require(f_growth <= 2 * t_ratio,
            f"the flash block's peak grew {f_growth:.1f}x, faster than T")
    out.update(scores_growth=s_growth, flash_growth=f_growth, launches=launches,
               backward_rel_err=e)
    report["memory_rows"] = out
    return launches


# ---------------------------------------------------------------------------
# phase 3: the served main path
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ModuleNet:
    """A network given as a bare module graph (the DenseMLP's layers with
    their activations as standalone Activation leaves)."""

    graph: object
    d_in: int
    d_out: int
    activation: str = "tanh"

    def apply(self, params, x):
        return self.graph.apply(params, x)

    def jet_apply(self, params, jet, *, impl="torch"):
        return self.graph.jet_apply(params, jet, impl=impl)


def unfused(net, params):
    from repro_torch.core.modules import Activation, Dense, Sequential
    mods, ps = [], []
    layers = [(params.w_in, params.b_in)] + [
        (params.w_hidden[i], params.b_hidden[i])
        for i in range(params.w_hidden.shape[0])]
    for w, b in layers:
        mods += [Dense(w.shape[0], w.shape[1], None), Activation(net.activation)]
        ps += [(w, b), ()]
    mods.append(Dense(net.width, net.d_out, None))
    ps.append((params.w_out, params.b_out))
    return ModuleNet(Sequential(tuple(mods)), net.d_in, net.d_out), tuple(ps)


REQUESTS = (("grid", 4), ("cross", (0, 0, 1, 1)), ("cross", (0, 1)))
SIZES = (5, 37, 200, 512)


def serve_concurrently(servers: dict, xs: dict, jobs: list):
    """Three client threads per server submit ``jobs`` (kind, request, rows)
    on inputs ``xs`` at once.  The launch counters are zeroed just before
    and read just after; the servers are closed on the way out.  Returns
    (tables keyed (server name, *job), launch counts, server metrics)."""
    import torch
    from repro_torch.kernels import ops

    results, errors = {}, []

    def client(name, server, part):
        try:
            futs = [(job, server.submit(xs[job[2]], **(
                {"order": job[1]} if job[0] == "grid" else {"axes": job[1]})))
                for job in part]
            for job, f in futs:
                results[(name,) + job] = f.result(timeout=600).table
        except Exception as exc:                      # noqa: BLE001
            errors.append(f"{name} {exc!r}")          # re-raised below

    ops.reset_launch_counts()
    try:
        threads = [threading.Thread(target=client, args=(name, srv, jobs[i::3]))
                   for name, srv in servers.items() for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        torch.cuda.synchronize()
        launches = ops.launch_counts()
        metrics = {name: srv.metrics() for name, srv in servers.items()}
    finally:
        for srv in servers.values():
            srv.close()
    require(not any(t.is_alive() for t in threads), "a client thread hung")
    require(not errors, f"served requests failed: {errors}")
    require(len(results) == len(servers) * len(jobs), "missing served results")
    return results, launches, metrics


def serve_main_path(net, params, gen, report: dict) -> dict:
    import torch
    from repro_torch.core.engines import DerivativeEngine
    from repro_torch.serving import DerivativeServer

    mnet, mparams = unfused(net, params)
    eager, autodiff = (DerivativeEngine.from_spec(s) for s in ("ntp", "autodiff"))
    xs = {n: torch.rand((n, net.d_in), generator=gen, device=DEVICE,
                        dtype=torch.float64) * 2 - 1 for n in SIZES}
    jobs = [(kind, req, n) for kind, req in REQUESTS for n in SIZES]
    results, launches, metrics = serve_concurrently(
        {"ntp/cuda": DerivativeServer(net, params, "ntp/cuda"),
         "ntp/cuda unfused": DerivativeServer(mnet, mparams, "ntp/cuda")},
        xs, jobs)

    batches = {name: m["batches"] for name, m in metrics.items()}
    want_k1 = 4 * batches["ntp/cuda"] + 4 * batches["ntp/cuda unfused"]
    want_k2 = 3 * batches["ntp/cuda unfused"]
    print(f"  launches in the served run: {launches}; engine calls (batches): "
          f"{batches}; expected jet_dense {want_k1}, act_jet {want_k2}")
    require(launches["jet_dense"] == want_k1,
            f"jet_dense launched {launches['jet_dense']} times, want {want_k1}")
    require(launches["act_jet"] == want_k2,
            f"act_jet launched {launches['act_jet']} times, want {want_k2}")

    worst = {"served_vs_eager": 0.0, "served_vs_autodiff": 0.0,
             "unfused_vs_eager": 0.0}
    with torch.no_grad():
        for kind, req, n in jobs:
            x = xs[n]
            if kind == "grid":
                direct = eager.grid(net, params, x, req)
                keep = 2
            else:
                direct = eager.cross(net, params, x, req)
                keep = 0
            served = results[("ntp/cuda", kind, req, n)]
            other = results[("ntp/cuda unfused", kind, req, n)]
            require(served.shape == direct.shape and bool(torch.isfinite(served).all()),
                    f"served {kind} {req} N={n}: shape {tuple(served.shape)} "
                    f"want {tuple(direct.shape)}, or non-finite values")
            e = rel_err(served, direct, keep)
            e2 = rel_err(other, direct, keep)
            worst["served_vs_eager"] = max(worst["served_vs_eager"], e)
            worst["unfused_vs_eager"] = max(worst["unfused_vs_eager"], e2)
            require(e <= TOL_SERVED, f"served {kind} {req} N={n} vs eager: {e:.3e}")
            require(e2 <= TOL_SERVED, f"unfused {kind} {req} N={n} vs eager: {e2:.3e}")
    for kind, req, n in jobs:
        x = xs[n]
        ad = (autodiff.grid(net, params, x, req) if kind == "grid"
              else autodiff.cross(net, params, x, req))
        e = rel_err(results[("ntp/cuda", kind, req, n)], ad.detach(),
                    2 if kind == "grid" else 0)
        worst["served_vs_autodiff"] = max(worst["served_vs_autodiff"], e)
        require(e <= TOL_AUTODIFF, f"served {kind} {req} N={n} vs autodiff: {e:.3e}")
    print(f"  served tables: {len(jobs)} per server; worst rel err vs eager ntp "
          f"{worst['served_vs_eager']:.2e} (tol {TOL_SERVED:.0e}), unfused vs "
          f"eager {worst['unfused_vs_eager']:.2e}, vs autodiff "
          f"{worst['served_vs_autodiff']:.2e} (tol {TOL_AUTODIFF:.0e})")
    report["served"] = {"launches": launches, "batches": batches,
                        "worst_rel_err": worst, "metrics": metrics}
    return launches


def polarization_scale(engine, net, params, x, axes) -> float:
    """max over rows of (1/(2^m m!)) sum_eps |D^m_{v_eps} f|: the size of the
    terms the polarization identity in ``engine.cross`` sums, hence the
    scale of any engine's rounding error in that cross table."""
    import torch
    m, d, n = len(axes), x.shape[-1], x.shape[0]
    signs = torch.tensor(list(itertools.product((1.0, -1.0), repeat=m)),
                         dtype=x.dtype, device=x.device)
    dirs = torch.zeros((2 ** m, d), dtype=x.dtype, device=x.device)
    for k, a in enumerate(axes):
        dirs[:, a] += signs[:, k]
    with torch.no_grad():
        dm = engine.derivs(net, params, x.repeat(2 ** m, 1), m,
                           dirs.repeat_interleave(n, dim=0))[m]
    terms = dm.abs().reshape(2 ** m, n, -1).sum(0)
    return float(terms.max()) / (2 ** m * math.factorial(m))


def readout_scale(net, params, x, order: int):
    """The conditioning scale of the trunk's ``grid(order)`` table, built as
    ``polarization_scale`` is: the size of the terms the last combination
    sums.  Per axis, the eager jet is pushed to the input of the readout
    (the token pool, then the Dense head), which sums its terms; those run
    through ``abs_sum``, each taken as exact, and scale by m!.  Same shape
    as the table, (d_in, order+1, N, d_out)."""
    import torch
    from repro_torch.core import jet as J
    from repro_torch.core.modules import Sequential

    mods, ps = net._graph().modules, net._graph_params(params)
    readout = Sequential(tuple(mods[-2:]))
    eye = torch.eye(x.shape[-1], dtype=x.dtype, device=x.device)
    facts = torch.tensor([float(math.factorial(m)) for m in range(order + 1)],
                         dtype=x.dtype, device=x.device)
    out = []
    with torch.no_grad():
        for a in range(x.shape[-1]):
            jet = J.seed(x, eye[a].expand_as(x), order)
            for m, p in zip(mods[:-2], ps[:-2]):
                jet = m.jet_apply(p, jet, impl="torch")
            mag = abs_sum(lambda c: readout.jet_apply(tuple(ps[-2:]), J.Jet(c)).coeffs,
                          jet.coeffs)
            out.append(mag * facts.reshape((-1,) + (1,) * (mag.ndim - 1)))
    return torch.stack(out)


class LauncherCounts:
    """Counts the calls of each C launcher (``cuda_lib.launch``'s name)
    while installed: which kernel source a wrapper took; and the shapes
    the run-time K1 launcher received, (n1, rows, din, dout, activation
    code, dtype code): launches (``dense_shapes``)."""

    def __init__(self):
        self.counts: dict = {}
        self.dense_shapes: dict = {}
        self._lock = threading.Lock()

    def __enter__(self):
        from repro_torch.kernels import cuda_lib
        self._mod, self._fn = cuda_lib, cuda_lib.launch

        def counted(name, device, *args):
            self._fn(name, device, *args)
            with self._lock:
                self.counts[name] = self.counts.get(name, 0) + 1
                if name == "jet_dense_rt_launch":   # x, w, bias, out, bsz, din, dout, n1, act, dtype
                    key = (args[7], args[4], args[5], args[6], args[8], args[9])
                    self.dense_shapes[key] = self.dense_shapes.get(key, 0) + 1

        cuda_lib.launch = counted
        return self

    def __exit__(self, *exc):
        self._mod.launch = self._fn


def serve_trunk(net, params, gen, report: dict, requests=REQUESTS,
                autodiff_sizes=TRUNK_AUTODIFF_SIZES, label: str = "trunk",
                launchers: dict | None = None) -> dict:
    """Phase 3b (and 3f): the Transformer trunk served under ntp/cuda,
    ``requests`` at SIZES rows, launch counters zeroed just before and read
    just after: TRUNK_PER_CALL launches per engine call and nothing else;
    with ``launchers``, the C launchers those calls took, per engine call."""
    import torch
    from repro_torch.core.engines import DerivativeEngine
    from repro_torch.serving import DerivativeServer

    eager, autodiff = (DerivativeEngine.from_spec(s) for s in ("ntp", "autodiff"))
    xs = {n: torch.rand((n, net.d_in), generator=gen, device=DEVICE,
                        dtype=torch.float64) * 2 - 1 for n in SIZES}
    jobs = [(kind, req, n) for kind, req in requests for n in SIZES]
    with LauncherCounts() as took:
        results, launches, metrics = serve_concurrently(
            {label: DerivativeServer(net, params, "ntp/cuda")}, xs, jobs)
    metrics = metrics[label]

    batches = metrics["batches"]
    want = {name: per * batches for name, per in TRUNK_PER_CALL.items()}
    print(f"  launches in the served {label} run: {launches}; engine calls "
          f"(batches): {batches}; expected {want}; C launchers {took.counts}")
    for name, n in want.items():
        require(launches[name] == n,
                f"{name} launched {launches[name]} times in the {label} run, "
                f"want {n} ({TRUNK_PER_CALL[name]} per engine call)")
    require(sum(launches.values()) == sum(want.values()),
            f"{label}: launches {launches}, want {want} and nothing else")
    if launchers is not None:
        expect = {name: per * batches for name, per in launchers.items()}
        require(took.counts == expect, f"{label}: C launchers {took.counts}, want {expect}")

    worst = {"served_vs_eager": 0.0, "served_vs_autodiff": 0.0,
             "grid_vs_eager_of_table_max": 0.0, "cross_vs_eager_of_table_max": 0.0}
    by_request = {f"{kind}{req}": {"vs_eager": 0.0, "vs_autodiff": 0.0,
                                   "vs_eager_of_table_max": 0.0}
                  for kind, req in requests}
    for kind, req, n in jobs:
        mine = by_request[f"{kind}{req}"]
        x, served = xs[n], results[(label, kind, req, n)]
        with torch.no_grad():
            direct = (eager.grid(net, params, x, req) if kind == "grid"
                      else eager.cross(net, params, x, req))
        require(served.shape == direct.shape and bool(torch.isfinite(served).all()),
                f"served trunk {kind} {req} N={n}: shape {tuple(served.shape)} "
                f"want {tuple(direct.shape)}, or non-finite values")
        if kind == "grid":
            gscale = readout_scale(net, params, x, req)
            e = scaled_err(served, direct, gscale, keep=2)
            own = rel_err(served, direct, 2)
            worst["grid_vs_eager_of_table_max"] = max(worst["grid_vs_eager_of_table_max"], own)
        else:
            scale = polarization_scale(eager, net, params, x, req)
            e = float((served - direct).abs().max()) / scale
            own = rel_err(served, direct, 0)
            worst["cross_vs_eager_of_table_max"] = max(worst["cross_vs_eager_of_table_max"], own)
        worst["served_vs_eager"] = max(worst["served_vs_eager"], e)
        mine["vs_eager"] = max(mine["vs_eager"], e)
        mine["vs_eager_of_table_max"] = max(mine["vs_eager_of_table_max"], own)
        require(e <= TOL_SERVED, f"served {label} {kind} {req} N={n} vs eager: {e:.3e}")
        if n in autodiff_sizes:
            ad = (autodiff.grid(net, params, x, req) if kind == "grid"
                  else autodiff.cross(net, params, x, req)).detach()
            e = rel_err(served, ad, 2) if kind == "grid" else \
                float((served - ad).abs().max()) / scale
            worst["served_vs_autodiff"] = max(worst["served_vs_autodiff"], e)
            mine["vs_autodiff"] = max(mine["vs_autodiff"], e)
            require(e <= TOL_AUTODIFF,
                    f"served trunk {kind} {req} N={n} vs autodiff: {e:.3e}")
    print(f"  served {label} tables: {len(jobs)}; worst err vs eager ntp "
          f"{worst['served_vs_eager']:.2e} (tol {TOL_SERVED:.0e}; grid tables relative "
          f"to the readout's terms, {worst['grid_vs_eager_of_table_max']:.2e} of the "
          f"table's own max; cross tables relative to the polarization terms, "
          f"{worst['cross_vs_eager_of_table_max']:.2e} of the table's own max), vs autodiff "
          + (f"at N in {autodiff_sizes} {worst['served_vs_autodiff']:.2e} (tol "
             f"{TOL_AUTODIFF:.0e})" if autodiff_sizes else "not run (order-10 towers)"))
    for key, w in by_request.items():
        print(f"    {key}: vs eager {w['vs_eager']:.2e} ({w['vs_eager_of_table_max']:.2e} of "
              f"the table's max), vs autodiff {w['vs_autodiff']:.2e}")
    report["served_trunk" if label == "trunk" else f"served_{label}"] = {
        "launches": launches, "batches": batches, "launchers": took.counts,
        "worst_rel_err": worst, "by_request": by_request, "metrics": metrics}
    return launches


def serve_network(label: str, net, params, requests, per_call: int, autodiff_sizes,
                  gen, report: dict) -> dict:
    """Phase 3c-e: ``net`` served under ntp/cuda, ``requests`` at SIZES
    rows, launch counters zeroed just before and read just after: only K1,
    ``per_call`` launches per engine call.  Every table against eager
    ``ntp`` (grid: TOL_SERVED per table slice; cross: relative to the
    polarization terms) and, at ``autodiff_sizes`` rows, against nested
    autodiff (TOL_AUTODIFF)."""
    import torch
    from repro_torch.core.engines import DerivativeEngine
    from repro_torch.serving import DerivativeServer

    eager, autodiff = (DerivativeEngine.from_spec(s) for s in ("ntp", "autodiff"))
    xs = {n: torch.rand((n, net.d_in), generator=gen, device=DEVICE,
                        dtype=torch.float64) * 2 - 1 for n in SIZES}
    jobs = [(kind, req, n) for kind, req in requests for n in SIZES]
    results, launches, metrics = serve_concurrently(
        {label: DerivativeServer(net, params, "ntp/cuda")}, xs, jobs)
    batches = metrics[label]["batches"]
    want = per_call * batches
    print(f"  launches in the served {label} run: {launches}; engine calls (batches): "
          f"{batches}; expected jet_dense {want}")
    require(launches["jet_dense"] == want and sum(launches.values()) == want,
            f"{label}: launches {launches}, want jet_dense {want} ({per_call} per engine "
            f"call) and nothing else")
    worst = {"served_vs_eager": 0.0, "served_vs_autodiff": 0.0}
    for kind, req, n in jobs:
        x, served = xs[n], results[(label, kind, req, n)]
        fn = eager.grid if kind == "grid" else eager.cross
        with torch.no_grad():
            direct = fn(net, params, x, req)
        require(served.shape == direct.shape and bool(torch.isfinite(served).all()),
                f"served {label} {kind} {req} N={n}: shape {tuple(served.shape)} want "
                f"{tuple(direct.shape)}, or non-finite values")
        if kind == "grid":
            e = rel_err(served, direct, 2)
        else:
            scale = polarization_scale(eager, net, params, x, req)
            e = float((served - direct).abs().max()) / scale
        worst["served_vs_eager"] = max(worst["served_vs_eager"], e)
        require(e <= TOL_SERVED, f"served {label} {kind} {req} N={n} vs eager: {e:.3e}")
        if n in autodiff_sizes:
            ad = (autodiff.grid if kind == "grid" else autodiff.cross)(
                net, params, x, req).detach()
            e = rel_err(served, ad, 2) if kind == "grid" else \
                float((served - ad).abs().max()) / scale
            worst["served_vs_autodiff"] = max(worst["served_vs_autodiff"], e)
            require(e <= TOL_AUTODIFF, f"served {label} {kind} {req} N={n} vs autodiff: "
                                       f"{e:.3e}")
    print(f"  served {label} tables: {len(jobs)}; worst err vs eager ntp "
          f"{worst['served_vs_eager']:.2e} (tol {TOL_SERVED:.0e}; cross relative to the "
          f"polarization terms)" + (f", vs autodiff at N in {autodiff_sizes} "
                                   f"{worst['served_vs_autodiff']:.2e} (tol "
                                   f"{TOL_AUTODIFF:.0e})" if autodiff_sizes else
                                   ", vs autodiff: not run (order 10 towers)"))
    report[f"served_{label}"] = {"launches": launches, "batches": batches,
                                 "worst_rel_err": worst, "metrics": metrics[label]}
    return launches


# ---------------------------------------------------------------------------
# phase 4: times
# ---------------------------------------------------------------------------

def bound_ms(nbytes: int, flops: int, dtype: str) -> tuple[float, str]:
    tb, tf = nbytes / PEAK_BYTES_S, flops / PEAK_FLOPS[dtype]
    return 1e3 * max(tb, tf), ("bytes" if tb >= tf else "operations")


def kernel_cost(name: str, args, n1: int, act: str | None = "tanh") -> tuple[int, int]:
    """(bytes, operations) of one launch of kernel ``name`` on ``args``:
    each input read once, the output written once.  Operations: K1 the
    stacked GEMM, the bias and (with ``act``) the epilogue; K2 the
    epilogue (``flop_estimate``); K3 the mean-square convolution, rsqrt
    recurrence and normalizing product; K4 per (query, key) pair the score
    convolution's N1 (N1+1)/2 D-dot-products and the exp and division
    recurrences, the value contraction and the projection (no mask: every
    query keeps all keys); K5 the score convolution and recurrences."""
    from repro_torch.kernels.bell_tables import flop_estimate
    item = args[0].element_size()
    if name == "act_jet":
        (x,) = args
        return 2 * x.numel() * item, flop_estimate(n1 - 1, x.shape[1], x.shape[2])
    if name == "jet_dense":
        x, w, b = args
        rows, din, dout = x.shape[1], w.shape[0], w.shape[1]
        return ((x.numel() + w.numel() + b.numel() + n1 * rows * dout) * item,
                2 * n1 * rows * din * dout + rows * dout
                + (flop_estimate(n1 - 1, rows, dout) if act else 0))
    if name == "jet_rms_norm":
        x, g = args
        rows, width = x.shape[1], x.shape[2]
        return ((2 * x.numel() + g.numel()) * item,
                rows * width * (2 * n1 * (n1 + 1) + n1) + rows * n1 * n1)
    if name == "jet_flash_attention":
        q, k, v, wo = args
        rows, heads, t, dh = q.shape[1:]
        dm = wo.shape[-1]
        pairs = rows * heads * t * t
        return ((3 * q.numel() + wo.numel() + n1 * rows * t * dm) * item,
                pairs * (2 * n1 * (n1 + 1) * dh + 2 * n1 * n1)
                + rows * heads * t * n1 * n1 * dh + rows * t * n1 * 2 * heads * dh * dm)
    q, k = args
    bsz, t, d = q.shape[1:]
    return ((2 * q.numel() + n1 * bsz * t * t) * item,
            bsz * t * t * (n1 * (n1 + 1) * d + 2 * n1 * n1))


def time_kernels(net, params, gen, report: dict) -> dict:
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.jet_dense import jet_dense_cuda
    from repro_torch.kernels.tanh_jet import act_jet_cuda

    n1, width = 5, net.width                 # order 4, the served requests
    out = {}
    # the DenseMLP's grid(4) and cross((0,0,1,1)) at 512 rows, and the
    # trunk's cross at 512 rows (two tokens a row)
    for label, rows in (("grid512", 2 * 512), ("cross512", 16 * 512),
                        ("trunk_cross512", 2 * 16 * 512)):
        x = 0.5 * torch.randn((n1, rows, width), generator=gen, device=DEVICE,
                              dtype=torch.float64)
        w, b = params.w_hidden[0], params.b_hidden[0]
        k1, k1_host = device_time_ms(lambda: jet_dense_cuda(x, w, b, "tanh"), 100)
        k1_plain, _ = device_time_ms(lambda: ref.jet_dense_ref(x, w, b, "tanh"), 3)
        xf = x.reshape(n1 * rows, width)
        gemm, _ = device_time_ms(lambda: torch.matmul(xf, w), 100)
        # where K1's time goes: the same launch without the epilogue, and a
        # copy of the stack (its bytes, no arithmetic)
        linear, _ = device_time_ms(lambda: jet_dense_cuda(x, w, b, None), 100)
        copy, _ = device_time_ms(lambda: x.clone(), 100)
        k2, k2_host = device_time_ms(lambda: act_jet_cuda(x, "tanh"), 100)
        k2_plain, _ = device_time_ms(lambda: ref.act_jet_ref(x, "tanh"), 3)
        k1_bytes, k1_flops = kernel_cost("jet_dense", (x, w, b), n1)
        k2_bytes, k2_flops = kernel_cost("act_jet", (x,), n1)
        k1_bound = bound_ms(k1_bytes, k1_flops, str(x.dtype))
        k2_bound = bound_ms(k2_bytes, k2_flops, str(x.dtype))
        err1 = float((jet_dense_cuda(x, w, b, "tanh")
                      - ref.jet_dense_ref(x, w, b, "tanh")).abs().max())
        err2 = float((act_jet_cuda(x, "tanh") - ref.act_jet_ref(x, "tanh")).abs().max())
        out[label] = {
            "shape": [n1, rows, width], "dtype": str(x.dtype),
            "jet_dense": {"ms": k1, "host_ms": k1_host, "plain_ms": k1_plain,
                          "gemm_only_ms": gemm, "no_epilogue_ms": linear,
                          "stack_copy_ms": copy,
                          "bound_ms": k1_bound[0], "bound_by": k1_bound[1],
                          "bytes": k1_bytes, "flops": k1_flops, "max_abs_err": err1},
            "act_jet": {"ms": k2, "host_ms": k2_host, "plain_ms": k2_plain,
                        "bound_ms": k2_bound[0],
                        "bound_by": k2_bound[1], "bytes": k2_bytes,
                        "flops": k2_flops, "max_abs_err": err2},
        }
        print(f"  {label} hidden layer (5, {rows}, 32)x(32, 32) f64 tanh: "
              f"jet_dense {k1 * 1e3:.2f} us (without the epilogue {linear * 1e3:.2f} us; "
              f"a copy of the stack {copy * 1e3:.2f} us; plain {k1_plain * 1e3:.2f} us, "
              f"GEMM part alone {gemm * 1e3:.2f} us, bound {k1_bound[0] * 1e3:.2f} us "
              f"by {k1_bound[1]}; host dispatch {k1_host * 1e3:.2f} us); act_jet "
              f"{k2 * 1e3:.2f} us (plain {k2_plain * 1e3:.2f} us, bound "
              f"{k2_bound[0] * 1e3:.2f} us by {k2_bound[1]}; host dispatch "
              f"{k2_host * 1e3:.2f} us)")
    report["kernel_times"] = out
    return out


def time_server(net, params, gen, report: dict, requests=REQUESTS[:2]) -> dict:
    """Per request kind at the 512 bucket: the server's latency (one client,
    no flush window) beside the device time of the bare engine call, whose
    ratio is the device's busy share of a request.  The eager engine's
    grid(10) enqueues more kernels than the launch queue holds, so its
    device time comes from graph replays (no host enqueue time then)."""
    import torch
    from repro_torch.core.engines import DerivativeEngine
    from repro_torch.serving import DerivativeServer

    x = torch.rand((512, net.d_in), generator=gen, device=DEVICE,
                   dtype=torch.float64) * 2 - 1
    out = report.setdefault("server_latency", {})
    for spec in ("ntp/cuda", "ntp"):
        engine = DerivativeEngine.from_spec(spec)
        for kind, req in requests:
            fn = engine.grid if kind == "grid" else engine.cross
            with torch.no_grad():
                if spec == "ntp" and kind == "grid" and req > 4:
                    dev_ms, host_ms = graph_time_ms(lambda: fn(net, params, x, req), 3), None
                else:
                    dev_ms, host_ms = device_time_ms(lambda: fn(net, params, x, req),
                                                     3 if spec == "ntp/cuda" else 1)
            with DerivativeServer(net, params, spec, flush_window_s=0.0) as srv:
                call = (lambda: srv.grid(x, req)) if kind == "grid" else \
                    (lambda: srv.cross(x, req))
                for _ in range(10):
                    call()
                srv.latency = type(srv.latency)()
                t0 = time.perf_counter()
                for _ in range(100):
                    call()
                wall = time.perf_counter() - t0
                lat = srv.latency.snapshot()
            key = f"{spec} {kind}{req} N=512"
            busy = dev_ms * 1e3 / lat["p50_us"]
            out[key] = {"p50_us": lat["p50_us"], "p99_us": lat["p99_us"],
                        "mean_us": lat["mean_us"], "requests_per_s": 100 / wall,
                        "engine_device_us": dev_ms * 1e3,
                        "engine_host_us": None if host_ms is None else host_ms * 1e3,
                        "device_busy_share": busy}
            host = "not measured (graph replay)" if host_ms is None else \
                f"{host_ms * 1e3:.1f} us"
            print(f"  server {key}: p50 {lat['p50_us']:.1f} us, p99 "
                  f"{lat['p99_us']:.1f} us, {100 / wall:.1f} requests/s (one client); "
                  f"engine call: device {dev_ms * 1e3:.1f} us, host enqueue {host}; "
                  f"device busy {100 * busy:.1f}% of p50")
    return out


def graph_time_ms(fn, reps: int = 20) -> float:
    """Device ms per call of ``fn``, from replays of one CUDA graph of it.

    The graph holds every kernel the call launches, so the replays run them
    back to back with no host in between.  Used for calls that enqueue
    more kernels than the launch queue holds, which defeat the spin of
    ``device_time_ms``: the plain versions of K3/K4 and the trunk's engine
    calls (the eager one runs ~2000 small kernels)."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    for _ in range(reps):
        graph.replay()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def event_time_ms(fn, reps: int = 20) -> float:
    """Median device ms of single calls of ``fn``, each bracketed by CUDA
    events after a synchronize.  For a call that synchronizes the host
    itself (f64 ``scaled_dot_product_attention`` does), which neither
    ``device_time_ms`` nor a CUDA graph can take; device idle inside the
    call counts, so this is an upper bound on its device time."""
    import torch
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        t0.record()
        fn()
        t1.record()
        torch.cuda.synchronize()
        times.append(t0.elapsed_time(t1))
    return sorted(times)[reps // 2]


def time_trunk_kernels(gen, report: dict) -> dict:
    """K3 and K4 at the cross-512 serving shapes of the trunk (16 directions
    x 512 rows x 2 tokens), beside their plain versions, the order-0
    library calls and their bounds."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.jet_attention import (jet_flash_attention_cuda,
                                                   jet_rms_norm_cuda)

    n1, rows, width, heads = 5, 16 * 512, TRUNK["width"], TRUNK["n_heads"]
    dh, t, dt = width // heads, TRUNK["d_in"], torch.float64
    out = {}

    x = 0.5 * torch.randn((n1, rows * t, width), generator=gen, device=DEVICE,
                          dtype=dt)
    g = 1.0 + 0.2 * torch.randn((width,), generator=gen, device=DEVICE, dtype=dt)
    ms, host = device_time_ms(lambda: jet_rms_norm_cuda(x, g, 1e-6), 100,
                              what="jet_rms_norm")
    plain = graph_time_ms(lambda: ref.jet_rms_norm_ref(x, g, 1e-6))
    lib, _ = device_time_ms(lambda: F.rms_norm(x[0], (width,), g, 1e-6), 100,
                            what="F.rms_norm")
    nbytes, flops = kernel_cost("jet_rms_norm", (x, g), n1)
    bound = bound_ms(nbytes, flops, str(dt))
    err = float((jet_rms_norm_cuda(x, g, 1e-6) - ref.jet_rms_norm_ref(x, g, 1e-6))
                .abs().max())
    out["jet_rms_norm"] = {
        "shape": list(x.shape), "dtype": str(dt), "ms": ms, "host_ms": host,
        "plain_ms": plain, "library_order0_ms": lib,
        "library_order0_call": "torch.nn.functional.rms_norm on c_0",
        "bound_ms": bound[0], "bound_by": bound[1], "bytes": nbytes,
        "flops": flops, "max_abs_err": err}

    q, k, v = (0.5 * torch.randn((n1, rows, heads, t, dh), generator=gen,
                                 device=DEVICE, dtype=dt) for _ in range(3))
    wo = torch.randn((heads, dh, width), generator=gen, device=DEVICE,
                     dtype=dt) / width ** 0.5
    scale = dh ** -0.5

    def library_order0():
        o = F.scaled_dot_product_attention(q[0], k[0], v[0], scale=scale)
        return o.transpose(1, 2).reshape(rows, t, heads * dh) @ wo.reshape(-1, width)

    ms, host = device_time_ms(
        lambda: jet_flash_attention_cuda(q, k, v, wo, scale), 100,
        what="jet_flash_attention")
    plain = graph_time_ms(lambda: ref.jet_flash_attention_ref(q, k, v, wo, scale))
    lib = event_time_ms(library_order0)
    nbytes, flops = kernel_cost("jet_flash_attention", (q, k, v, wo), n1)
    bound = bound_ms(nbytes, flops, str(dt))
    err = float((jet_flash_attention_cuda(q, k, v, wo, scale)
                 - ref.jet_flash_attention_ref(q, k, v, wo, scale)).abs().max())
    out["jet_flash_attention"] = {
        "shape": list(q.shape), "wo": list(wo.shape), "dtype": str(dt),
        "ms": ms, "host_ms": host, "plain_ms": plain, "library_order0_ms": lib,
        "library_order0_call": "scaled_dot_product_attention on c_0, then @ wo "
                               "(events around single calls: it synchronizes)",
        "bound_ms": bound[0], "bound_by": bound[1], "bytes": nbytes,
        "flops": flops, "max_abs_err": err}
    # the memory comparison's largest row (order 2, B 2, H 2, T 1024, Dh 8,
    # Dm 16, f32): the long-T kernel
    n1m, bm, hm, tm, dhm, dmm = (MEMORY["order"] + 1, MEMORY["bsz"], MEMORY["heads"],
                                 MEMORY_T[-1], MEMORY["dh"], MEMORY["dm"])
    qm, km, vm = (torch.randn((n1m, bm, hm, tm, dhm), generator=gen, device=DEVICE,
                              dtype=torch.float32) for _ in range(3))
    wm = torch.randn((hm, dhm, dmm), generator=gen, device=DEVICE, dtype=torch.float32)
    sm = dhm ** -0.5
    ms, host = device_time_ms(lambda: jet_flash_attention_cuda(qm, km, vm, wm, sm), 20,
                              what="jet_flash_attention memory row")
    plain = graph_time_ms(lambda: ref.jet_flash_attention_ref(qm, km, vm, wm, sm), reps=5)
    nbytes, flops = kernel_cost("jet_flash_attention", (qm, km, vm, wm), n1m)
    bound = bound_ms(nbytes, flops, "torch.float32")
    out["jet_flash_attention_memory_row"] = {
        "shape": list(qm.shape), "wo": list(wm.shape), "dtype": "torch.float32",
        "ms": ms, "host_ms": host, "plain_ms": plain, "bound_ms": bound[0],
        "bound_by": bound[1], "bytes": nbytes, "flops": flops}
    for name, r in out.items():
        if "library_order0_ms" not in r:
            print(f"  {name} {tuple(r['shape'])} f32: {r['ms'] * 1e3:.2f} us (plain "
                  f"{r['plain_ms'] * 1e3:.2f} us, bound {r['bound_ms'] * 1e3:.2f} us by "
                  f"{r['bound_by']}; host dispatch {r['host_ms'] * 1e3:.2f} us)")
            continue
        print(f"  {name} {tuple(r['shape'])} f64: {r['ms'] * 1e3:.2f} us (plain "
              f"{r['plain_ms'] * 1e3:.2f} us, order-0 library call "
              f"{r['library_order0_ms'] * 1e3:.2f} us, bound "
              f"{r['bound_ms'] * 1e3:.2f} us by {r['bound_by']}; host dispatch "
              f"{r['host_ms'] * 1e3:.2f} us)")
    report["trunk_kernel_times"] = out
    return out


def time_trunk_server(net, params, gen, report: dict, requests=REQUESTS[:2]) -> dict:
    """Per request kind at the 512 bucket: the trunk server's latency (one
    client, no flush window) beside the device time of the bare engine call
    (``graph_time_ms``), whose ratio is the device's busy share."""
    import torch
    from repro_torch.core.engines import DerivativeEngine
    from repro_torch.serving import DerivativeServer

    x = torch.rand((512, net.d_in), generator=gen, device=DEVICE,
                   dtype=torch.float64) * 2 - 1
    out = report.setdefault("trunk_server_latency", {})
    for spec in ("ntp/cuda", "ntp"):
        engine = DerivativeEngine.from_spec(spec)
        for kind, req in requests:
            fn = engine.grid if kind == "grid" else engine.cross
            with torch.no_grad():
                dev_ms = graph_time_ms(lambda: fn(net, params, x, req))
            with DerivativeServer(net, params, spec, flush_window_s=0.0) as srv:
                call = (lambda: srv.grid(x, req)) if kind == "grid" else \
                    (lambda: srv.cross(x, req))
                for _ in range(10):
                    call()
                srv.latency = type(srv.latency)()
                t0 = time.perf_counter()
                for _ in range(100):
                    call()
                wall = time.perf_counter() - t0
                lat = srv.latency.snapshot()
            key = f"{spec} {kind}{req} N=512"
            busy = dev_ms * 1e3 / lat["p50_us"]
            out[key] = {"p50_us": lat["p50_us"], "p99_us": lat["p99_us"],
                        "mean_us": lat["mean_us"], "requests_per_s": 100 / wall,
                        "engine_device_us": dev_ms * 1e3,
                        "device_busy_share": busy}
            print(f"  trunk server {key}: p50 {lat['p50_us']:.1f} us, p99 "
                  f"{lat['p99_us']:.1f} us, {100 / wall:.1f} requests/s (one "
                  f"client); engine call device {dev_ms * 1e3:.1f} us (graph "
                  f"replay); device busy {100 * busy:.1f}% of p50")
    return out


def scores_key(shape, order: int, dtype: str = "torch.float64") -> str:
    return f"{tuple(shape)} order {order}" + ("" if dtype == "torch.float64" else f" {dtype}")


def time_scores_kernel(gen, report: dict) -> dict:
    """K5 at the memory comparison's (B*H, T, Dh) = (4, 256, 8) and
    (4, 1024, 8), f64, orders 2 and 8, and at the memory rows' own launch
    (f32, order 2, (4, 1024, 8)): device time, host dispatch, the plain
    version (graph replay: it enqueues too many kernels for the spin), the
    order-0 library computation softmax(scale q_0 k_0^T) and the bound."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.jet_attention import jet_attention_scores_cuda

    out = {}
    cases = [(torch.float64, shape, order) for shape in SCORES_TIMED
             for order in SCORES_TIMED_ORDERS]
    cases.append((torch.float32,) + SCORES_MEMORY_ROW)
    for dt, (bsz, t, d), order in cases:
        scale = d ** -0.5
        n1 = order + 1
        q, k = (0.6 * torch.randn((n1, bsz, t, d), generator=gen, device=DEVICE,
                                  dtype=dt) for _ in range(2))
        ms, host = device_time_ms(lambda: jet_attention_scores_cuda(q, k, scale),
                                  20, what="jet_attention_scores")
        plain = graph_time_ms(lambda: ref.jet_attention_scores_ref(q, k, scale), reps=5)
        lib, _ = device_time_ms(
            lambda: torch.softmax(scale * q[0] @ k[0].transpose(-1, -2), dim=-1),
            20, what="order-0 softmax")
        nbytes, flops = kernel_cost("jet_attention_scores", (q, k), n1)
        bound = bound_ms(nbytes, flops, str(dt))
        got = jet_attention_scores_cuda(q, k, scale)
        want = ref.jet_attention_scores_ref(q, k, scale)
        err = float((got - want).abs().max())
        key = scores_key((bsz, t, d), order, str(dt))
        out[key] = {"shape": [n1, bsz, t, d], "dtype": str(dt), "ms": ms,
                    "host_ms": host, "plain_ms": plain, "library_order0_ms": lib,
                    "bound_ms": bound[0], "bound_by": bound[1], "bytes": nbytes,
                    "flops": flops, "max_abs_err": err}
        print(f"  jet_attention_scores {key}{' f64' if dt == torch.float64 else ''}: "
              f"{ms * 1e3:.2f} us (plain {plain * 1e3:.2f} us, order-0 softmax(q0 k0^T) "
              f"{lib * 1e3:.2f} us, bound {bound[0] * 1e3:.2f} us by {bound[1]}; host "
              f"dispatch {host * 1e3:.2f} us)")
    report["scores_kernel_times"] = out
    return out


def trace_trunk_call(net, params, gen, report: dict, other=None,
                     request=("cross", (0, 0, 1, 1))) -> dict:
    """Where the trunk's ``request`` at the 512 bucket spends its device
    time: ``torch.profiler`` over replays of one CUDA graph of the engine
    call, device time summed per kernel name (the port's kernels by
    symbol, the rest by PyTorch's kernel names).  With ``other`` (an
    earlier checkout's kernels, ``--against``) it traces the call with
    that checkout's K1, K3 and K4 first ("before"), then with this
    tree's."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.engines import DerivativeEngine
    from repro_torch.kernels import ops

    x = torch.rand((512, net.d_in), generator=gen, device=DEVICE,
                   dtype=torch.float64) * 2 - 1
    engine = DerivativeEngine.from_spec("ntp/cuda")
    kind, req = request
    call = engine.grid if kind == "grid" else engine.cross
    what = f"{kind}({req})" if kind == "grid" else f"{kind}({','.join(map(str, req))})"
    wrappers = ((ops._k1, "jet_dense", "jet_dense_cuda"),
                (ops._k34, "jet_attention", "jet_rms_norm_cuda"),
                (ops._k34, "jet_attention", "jet_flash_attention_cuda"))
    reps, out = 5, {}
    variants = [("after", None)]
    if other is not None:
        variants.insert(0, ("before", other))
    for label, kernels in variants:
        saved = [getattr(mod, name) for mod, _, name in wrappers]
        if kernels is not None:
            for mod, other_mod, name in wrappers:
                setattr(mod, name, getattr(kernels[other_mod], name))
        try:
            graph = torch.cuda.CUDAGraph()
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.no_grad(), torch.cuda.stream(side):
                for _ in range(3):
                    call(net, params, x, req)
            torch.cuda.current_stream().wait_stream(side)
            with torch.no_grad(), torch.cuda.graph(graph):
                call(net, params, x, req)
            graph.replay()
            torch.cuda.synchronize()
            source = "graph replays"
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    graph.replay()
                torch.cuda.synchronize()
            if not any(e.device_type == DeviceType.CUDA for e in prof.events()):
                source = "eager calls (the profiler saw no kernel of the replays)"
                with torch.no_grad(), profile(
                        activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    for _ in range(reps):
                        call(net, params, x, req)
                    torch.cuda.synchronize()
        finally:
            for (mod, _, name), fn in zip(wrappers, saved):
                setattr(mod, name, fn)
        by_name, launches = {}, {}
        for evt in prof.events():
            if evt.device_type != DeviceType.CUDA:
                continue
            mine = [n for n in KERNEL_NAMES if re.search(rf"\b{n}\w*_kernel\b", evt.name)]
            key = mine[0] if mine else evt.name
            by_name[key] = by_name.get(key, 0.0) + evt.time_range.elapsed_us() / reps
            launches[key] = launches.get(key, 0) + 1 / reps
        require(by_name, "the profiler recorded no device event in the graph replays")
        total = sum(by_name.values())
        ranked = sorted(by_name.items(), key=lambda kv: -kv[1])
        out[label] = {"device_us": total, "by_kernel_us": dict(ranked),
                      "launches": {k: launches[k] for k, _ in ranked}, "source": source}
        print(f"  trunk {what} N=512, {label}: {total:.1f} us of device time "
              f"per call in {sum(launches.values()):.0f} kernels (profiler over {source})")
        for name, us in ranked[:10]:
            print(f"    {us:9.1f} us  {launches[name]:5.0f} x  {name[:90]}")
    report[f"trunk_{kind}{req if kind == 'grid' else ''}_trace"] = out
    return out


def load_other_kernels(root: Path) -> dict:
    """The kernel modules of another checkout (``--against``: e.g. the
    parent commit unpacked with ``git archive``) under the package name
    ``other_kernels``; it builds its own sources into its own ``_build``."""
    import importlib
    import importlib.util
    pkg = Path(root).resolve() / "src" / "repro_torch" / "kernels"
    require((pkg / "csrc").is_dir(), f"--against {root}: no {pkg / 'csrc'}")
    spec = importlib.util.spec_from_file_location(
        "other_kernels", pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["other_kernels"] = mod
    spec.loader.exec_module(mod)
    return {name: importlib.import_module(f"other_kernels.{name}")
            for name in ("cuda_lib", "jet_dense", "tanh_jet", "jet_attention")}


def compare_turns(other: dict, gen, report: dict) -> dict:
    """The other checkout's K1-K5 against this tree's on the same inputs,
    device time in turns other, this, this, other (``device_time_ms``, 100
    calls each, 20 for the long ones, 5 for K4 at long T): K1, K2 and K4 at
    the served shapes, K3 at (5, 16384, 32), K4 and K5 at the memory row
    (f32), K5 at SCORES_TIMED x SCORES_TIMED_ORDERS (f64), the
    run-time-order K3 and K4 at RT_RMS_SHAPES and RT_FLASH_SHAPES, K5 at
    RT_SCORES_TIMED, K1 and K2 at RUNTIME_TURNS.  Outputs held to each other at TOL_F64 (f64), 4
    TOL_F32 (the f32 sums over 1024 keys) or BF16_ULPS (bfloat16)."""
    import torch
    from repro_torch.kernels.jet_attention import (jet_attention_scores_cuda,
                                                   jet_flash_attention_cuda, jet_rms_norm_cuda)
    from repro_torch.kernels.jet_dense import jet_dense_cuda
    from repro_torch.kernels.tanh_jet import act_jet_cuda

    other["cuda_lib"].library()
    dt, out = torch.float64, {}
    cases = []
    for rows in (1024, 8192, 16384):
        x = 0.5 * torch.randn((5, rows, 32), generator=gen, device=DEVICE, dtype=dt)
        w = torch.randn((32, 32), generator=gen, device=DEVICE, dtype=dt) / 32 ** 0.5
        b = 0.1 * torch.randn((32,), generator=gen, device=DEVICE, dtype=dt)
        cases.append((f"jet_dense (5, {rows}, 32)x(32, 32) tanh",
                      lambda x=x, w=w, b=b: other["jet_dense"].jet_dense_cuda(x, w, b, "tanh"),
                      lambda x=x, w=w, b=b: jet_dense_cuda(x, w, b, "tanh")))
        if rows != 16384:
            cases.append((f"act_jet (5, {rows}, 32) tanh",
                          lambda x=x: other["tanh_jet"].act_jet_cuda(x, "tanh"),
                          lambda x=x: act_jet_cuda(x, "tanh")))
    q, k, v = (0.5 * torch.randn((5, 8192, 2, 2, 16), generator=gen, device=DEVICE,
                                 dtype=dt) for _ in range(3))
    wo = torch.randn((2, 16, 32), generator=gen, device=DEVICE, dtype=dt) / 32 ** 0.5
    cases.append(("jet_flash_attention (5, 8192, 2, 2, 16) x (2, 16, 32)",
                  lambda: other["jet_attention"].jet_flash_attention_cuda(q, k, v, wo, 0.25),
                  lambda: jet_flash_attention_cuda(q, k, v, wo, 0.25)))
    qm, km, vm = (torch.randn((3, 2, 2, 1024, 8), generator=gen, device=DEVICE,
                              dtype=torch.float32) for _ in range(3))
    wm = torch.randn((2, 8, 16), generator=gen, device=DEVICE, dtype=torch.float32)
    cases.append(("jet_flash_attention memory row (3, 2, 2, 1024, 8) x (2, 8, 16) f32",
                  lambda: other["jet_attention"].jet_flash_attention_cuda(
                      qm, km, vm, wm, 8 ** -0.5),
                  lambda: jet_flash_attention_cuda(qm, km, vm, wm, 8 ** -0.5)))
    scores = [(torch.float64, shape, order) for shape in SCORES_TIMED
              for order in SCORES_TIMED_ORDERS]
    scores.append((torch.float32,) + SCORES_MEMORY_ROW)
    for dt, (bsz, t, d), order in scores:
        qs, ks = (0.6 * torch.randn((order + 1, bsz, t, d), generator=gen, device=DEVICE,
                                    dtype=dt) for _ in range(2))
        label = "memory row " if dt == torch.float32 else ""
        cases.append((f"jet_attention_scores {label}{(order + 1, bsz, t, d)} "
                      f"{'f32' if dt == torch.float32 else 'f64'}",
                      lambda qs=qs, ks=ks, d=d: other["jet_attention"].jet_attention_scores_cuda(
                          qs, ks, d ** -0.5),
                      lambda qs=qs, ks=ks, d=d: jet_attention_scores_cuda(qs, ks, d ** -0.5)))
    # K3 at its templated served shape, then the run-time-order K3 and K4
    # at RT_RMS_SHAPES / RT_FLASH_SHAPES (phase 7b's)
    x, g = rt_rms_inputs(gen, 5, 16384, 32, torch.float64)
    cases.append(("jet_rms_norm (5, 16384, 32)",
                  lambda x=x, g=g: other["jet_attention"].jet_rms_norm_cuda(x, g, 1e-6),
                  lambda x=x, g=g: jet_rms_norm_cuda(x, g, 1e-6)))
    for n1, rows, width, dname in RT_RMS_SHAPES:
        x, g = rt_rms_inputs(gen, n1, rows, width, getattr(torch, dname))
        tag = "bf16" if dname == "bfloat16" else "f64"
        cases.append((f"jet_rms_norm run-time ({n1}, {rows}, {width}) {tag}",
                      lambda x=x, g=g: other["jet_attention"].jet_rms_norm_cuda(x, g, 1e-6),
                      lambda x=x, g=g: jet_rms_norm_cuda(x, g, 1e-6)))
    for shape in RT_FLASH_SHAPES:     # own names: the served K4 case above reads q, k, v, wo
        qr, kr, vr, wr = rt_flash_inputs(gen, *shape[:6], getattr(torch, shape[6]))
        scale, tag = shape[4] ** -0.5, "bf16" if shape[6] == "bfloat16" else "f64"
        cases.append((f"jet_flash_attention run-time {tuple(qr.shape)}x{tuple(wr.shape)} {tag}",
                      lambda q=qr, k=kr, v=vr, wo=wr, scale=scale: other["jet_attention"]
                      .jet_flash_attention_cuda(q, k, v, wo, scale),
                      lambda q=qr, k=kr, v=vr, wo=wr, scale=scale:
                      jet_flash_attention_cuda(q, k, v, wo, scale)))
    # the run-time K5 at RT_SCORES_TIMED (phase 7b's), the tiled kernel here
    for n1, bsz, t, d, dname in RT_SCORES_TIMED:
        rdt = getattr(torch, dname)
        qr, kr = ((0.6 * torch.randn((n1, bsz, t, d), generator=gen, device=DEVICE,
                                     dtype=torch.float64)).to(rdt) for _ in range(2))
        tag = "bf16" if rdt == torch.bfloat16 else "f64"
        cases.append((f"jet_attention_scores run-time ({n1}, {bsz}, {t}, {d}) {tag}",
                      lambda q=qr, k=kr, d=d: other["jet_attention"].jet_attention_scores_cuda(
                          q, k, d ** -0.5),
                      lambda q=qr, k=kr, d=d: jet_attention_scores_cuda(q, k, d ** -0.5)))
    # the run-time-order K1 and K2 (csrc/jet_runtime.cu) at the shapes of
    # phase 7b: K1 at the Burgers k = 4 layers, both at the served layer at
    # orders 10 and 16 and on bfloat16 at order 4
    for n1, rows, din, dout, rname in RUNTIME_TURNS:
        rdt = getattr(torch, rname)
        x = (0.5 * torch.randn((n1, rows, din), generator=gen, device=DEVICE,
                               dtype=torch.float64)).to(rdt)
        w = (torch.randn((din, dout), generator=gen, device=DEVICE,
                         dtype=torch.float64) / din ** 0.5).to(rdt)
        b = (0.1 * torch.randn((dout,), generator=gen, device=DEVICE,
                               dtype=torch.float64)).to(rdt)
        tag = "bf16" if rdt == torch.bfloat16 else "f64"
        cases.append((f"jet_dense run-time ({n1}, {rows}, {din})x({din}, {dout}) tanh {tag}",
                      lambda x=x, w=w, b=b: other["jet_dense"].jet_dense_cuda(x, w, b, "tanh"),
                      lambda x=x, w=w, b=b: jet_dense_cuda(x, w, b, "tanh")))
        if (rows, din) == (8192, 32):
            cases.append((f"act_jet run-time ({n1}, {rows}, {din}) tanh {tag}",
                          lambda x=x: other["tanh_jet"].act_jet_cuda(x, "tanh"),
                          lambda x=x: act_jet_cuda(x, "tanh")))
    for what, old, new in cases:
        got, want = new(), old()
        torch.cuda.synchronize()
        if what.endswith("bf16"):
            e = bf16_ulps(got, want)
            require(e <= BF16_ULPS, f"{what}: this tree vs the other checkout {e:.2f} bf16 "
                                    f"ulps of the plane max")
        else:
            e = rel_err(got, want, 1)
            tol = TOL_F64 if "f32" not in what else 4 * TOL_F32
            require(e <= tol, f"{what}: this tree vs the other checkout {e:.3e}")
        reps = 20 if any(w in what for w in ("memory", "scores", "run-time")) else 100
        if "1024, 8)x" in what:      # K4 at long T: milliseconds a call
            reps = 5
        turns = [device_time_ms(fn, reps, what=what)[0] for fn in (old, new, new, old)]
        out[what] = {"turns_ms": turns, "order": ["other", "this", "this", "other"],
                     "rel_err": e}
        print(f"  {what}: other {turns[0] * 1e3:.2f} / this {turns[1] * 1e3:.2f} / this "
              f"{turns[2] * 1e3:.2f} / other {turns[3] * 1e3:.2f} us (outputs agree to "
              f"{e:.1e})")
    report["turns"] = out
    return out


def engine_turns(other: dict, net, params, gen, report: dict) -> dict:
    """Phase 8: the served DenseMLP ``grid(DENSE_GRID_ORDER)`` engine call
    at 512 rows (four run-time K1 launches) with the other checkout's K1
    and with this tree's, device time in turns other, this, this, other;
    the tables held to each other at TOL_F64."""
    import torch
    from repro_torch.core.engines import DerivativeEngine
    from repro_torch.kernels import ops

    x = torch.rand((512, net.d_in), generator=gen, device=DEVICE,
                   dtype=torch.float64) * 2 - 1
    engine = DerivativeEngine.from_spec("ntp/cuda")

    def call(k1):
        def fn():
            saved = ops._k1.jet_dense_cuda
            ops._k1.jet_dense_cuda = k1
            try:
                with torch.no_grad():
                    return engine.grid(net, params, x, DENSE_GRID_ORDER)
            finally:
                ops._k1.jet_dense_cuda = saved
        return fn

    old, new = call(other["jet_dense"].jet_dense_cuda), call(ops._k1.jet_dense_cuda)
    e = rel_err(new(), old(), 2)
    require(e <= TOL_F64, f"grid({DENSE_GRID_ORDER}) engine call: this tree vs the other "
                          f"checkout {e:.3e}")
    turns = [device_time_ms(fn, 3, what="grid engine call")[0] for fn in (old, new, new, old)]
    what = f"DenseMLP grid({DENSE_GRID_ORDER}) engine call N=512"
    print(f"  {what}: other {turns[0] * 1e3:.2f} / this {turns[1] * 1e3:.2f} / this "
          f"{turns[2] * 1e3:.2f} / other {turns[3] * 1e3:.2f} us of device time (tables "
          f"agree to {e:.1e})")
    out = report.setdefault("turns", {})[what] = {
        "turns_ms": turns, "order": ["other", "this", "this", "other"], "rel_err": e}
    return out


def trunk_engine_turns(other: dict, net, params, gen, report: dict) -> dict:
    """Phase 8: the served trunk's ``grid(TRUNK_GRID_ORDER)`` engine call at
    512 rows (16 K1, 7 K3, 3 K4, all run-time-order) with the other
    checkout's K3 and K4 and with this tree's (K1 is this tree's in both),
    device time by graph replay in turns other, this, this, other; the
    tables held to each other at TOL_F64 relative to each slice's max."""
    import torch
    from repro_torch.core.engines import DerivativeEngine
    from repro_torch.kernels import ops

    x = torch.rand((512, net.d_in), generator=gen, device=DEVICE,
                   dtype=torch.float64) * 2 - 1
    engine = DerivativeEngine.from_spec("ntp/cuda")
    names = ("jet_rms_norm_cuda", "jet_flash_attention_cuda")

    def call(mod):
        def fn():
            saved = {n: getattr(ops._k34, n) for n in names}
            for n in names:
                setattr(ops._k34, n, getattr(mod, n))
            try:
                with torch.no_grad():
                    return engine.grid(net, params, x, TRUNK_GRID_ORDER)
            finally:
                for n, f in saved.items():
                    setattr(ops._k34, n, f)
        return fn

    old, new = call(other["jet_attention"]), call(ops._k34)
    e = rel_err(new(), old(), 2)
    require(e <= TOL_F64, f"trunk grid({TRUNK_GRID_ORDER}) engine call: this tree vs the "
                          f"other checkout {e:.3e}")
    turns = [graph_time_ms(fn) for fn in (old, new, new, old)]
    what = f"Transformer trunk grid({TRUNK_GRID_ORDER}) engine call N=512"
    print(f"  {what}: other {turns[0] * 1e3:.2f} / this {turns[1] * 1e3:.2f} / this "
          f"{turns[2] * 1e3:.2f} / other {turns[3] * 1e3:.2f} us of device time (graph "
          f"replay; tables agree to {e:.1e})")
    out = report.setdefault("turns", {})[what] = {
        "turns_ms": turns, "order": ["other", "this", "this", "other"], "rel_err": e}
    return out


class ShapeRecorder:
    """Counts the (n1, rows, din, dout, activation, dtype) of every K1
    launch while installed in place of ``ops``' reference to
    ``jet_dense_cuda``; used around the training runs."""

    def __init__(self):
        self.counts: dict = {}

    def __enter__(self):
        from repro_torch.kernels import ops
        self._mod, self._fn = ops._k1, ops._k1.jet_dense_cuda

        def recorded(coeffs, w, b, activation="tanh"):
            key = (*coeffs.shape, w.shape[1], activation, str(coeffs.dtype))
            self.counts[key] = self.counts.get(key, 0) + 1
            return self._fn(coeffs, w, b, activation)

        self._mod.jet_dense_cuda = recorded
        return self

    def __exit__(self, *exc):
        self._mod.jet_dense_cuda = self._fn


def time_training_shapes(counts: dict, gen, report: dict) -> dict:
    """Phase 7: K1 at the TRAINING_SHAPES_TIMED shapes the training phases
    launched most, beside its plain version and its bound."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.jet_dense import jet_dense_cuda

    out = {}
    ranked = sorted(counts.items(), key=lambda kv: -kv[1])[:TRAINING_SHAPES_TIMED]
    for (n1, rows, din, dout, act, dtype), launches in ranked:
        dt = getattr(torch, dtype.split(".")[-1])
        x = 0.5 * torch.randn((n1, rows, din), generator=gen, device=DEVICE, dtype=dt)
        w = torch.randn((din, dout), generator=gen, device=DEVICE, dtype=dt) / din ** 0.5
        b = 0.1 * torch.randn((dout,), generator=gen, device=DEVICE, dtype=dt)
        ms, host = device_time_ms(lambda: jet_dense_cuda(x, w, b, act), 100,
                                  what="jet_dense")
        # graph replay: at order 8 the plain version enqueues more kernels
        # than the launch queue holds
        plain = graph_time_ms(lambda: ref.jet_dense_ref(x, w, b, act), reps=5)
        nbytes, flops = kernel_cost("jet_dense", (x, w, b), n1, act)
        bound = bound_ms(nbytes, flops, str(dt))
        key = f"({n1}, {rows}, {din})x({din}, {dout}) {act} {dtype}"
        out[key] = {"launches_in_training": launches, "ms": ms, "host_ms": host,
                    "plain_ms": plain, "bound_ms": bound[0], "bound_by": bound[1],
                    "bytes": nbytes, "flops": flops}
        print(f"  jet_dense {key}: {ms * 1e3:.2f} us (plain {plain * 1e3:.2f} us, bound "
              f"{bound[0] * 1e3:.2f} us by {bound[1]}; host dispatch {host * 1e3:.2f} us); "
              f"{launches} launches in phases 5-6")
    report["training_shape_times"] = out
    return out


def trunk_k1_launches(net, params, gen) -> dict:
    """{(n1, rows, din, dout, activation code, dtype code): launches} of K1
    in one trunk ``grid(TRUNK_GRID_ORDER)`` engine call at 512 rows, as its
    C launcher received them; they must be TRUNK_RT_LAUNCHERS' count."""
    import torch
    from repro_torch.core.engines import DerivativeEngine

    x = torch.rand((512, net.d_in), generator=gen, device=DEVICE,
                   dtype=torch.float64) * 2 - 1
    engine = DerivativeEngine.from_spec("ntp/cuda")
    with LauncherCounts() as took, torch.no_grad():
        engine.grid(net, params, x, TRUNK_GRID_ORDER)
    torch.cuda.synchronize()
    want = TRUNK_RT_LAUNCHERS["jet_dense_rt_launch"]
    require(sum(took.dense_shapes.values()) == want,
            f"trunk grid({TRUNK_GRID_ORDER}) N=512: K1 launches {took.dense_shapes}, want {want}")
    return took.dense_shapes


def time_new_instantiations(gen, report: dict, trunk=None, trunk_params=None) -> dict:
    """Phase 7b: the run-time-order kernels (csrc/jet_runtime.cu), device
    time by CUDA events with the host off the clock and L2 warm
    (``device_time_ms``), beside the plain version (graph replay) and the
    bound: K1 at the Burgers k = 4 layer shapes (f64, tanh); K1-K4 at
    orders 10 and 16 at the served shapes of ``_kernel_cases``; each
    kernel on bfloat16 at its served order-4 shape; K5 at RT_SCORES_TIMED
    (the tiled kernel asserted); K3 and K4 at the trunk's grid(10) launches
    and K4 at long T; with ``trunk``, K1 at every distinct shape that the
    trunk's grid(10) engine call at 512 rows hands its launcher.  K3-K5
    beside their order-0 library call (ORDER0_LIBRARY), K1 beside its GEMM
    part."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.jet_attention import (jet_attention_scores_cuda,
                                                   jet_flash_attention_cuda, jet_rms_norm_cuda,
                                                   scores_runtime_geometry)
    from repro_torch.kernels.jet_dense import jet_dense_cuda
    from repro_torch.kernels.tanh_jet import DTYPE_CODES

    cases = []
    for n1, rows, din, dout in BURGERS_K4_SHAPES:
        x = 0.5 * torch.randn((n1, rows, din), generator=gen, device=DEVICE,
                              dtype=torch.float64)
        w = torch.randn((din, dout), generator=gen, device=DEVICE,
                        dtype=torch.float64) / din ** 0.5
        b = 0.1 * torch.randn((dout,), generator=gen, device=DEVICE, dtype=torch.float64)
        cases.append(("jet_dense", f"burgers k=4 ({n1}, {rows}, {din})x({din}, {dout}) tanh "
                                   f"torch.float64",
                      lambda x=x, w=w, b=b: jet_dense_cuda(x, w, b, "tanh"),
                      lambda c, ww, bb: ref.jet_dense_ref(c, ww, bb, "tanh"), (x, w, b)))
    for dt, orders in ((torch.float64, (10, 16)), (torch.bfloat16, (4,))):
        for n in orders:
            for name, label, call, plain, args in _kernel_cases(gen, n, dt, served_only=True):
                if name != "jet_attention_scores":
                    cases.append((name, f"{label} {dt}", call, plain, args))
    for n1, bsz, t, d, dname in RT_SCORES_TIMED:
        dt = getattr(torch, dname)
        geo = scores_runtime_geometry(n1, t, d, dt, bsz)
        require(not geo.smallest, f"K5 ({n1}, {bsz}, {t}, {d}) {dt} took the smallest block")
        q, k = ((0.6 * torch.randn((n1, bsz, t, d), generator=gen, device=DEVICE,
                                   dtype=torch.float64)).to(dt) for _ in range(2))
        cases.append(("jet_attention_scores",
                      f"({n1}, {bsz}, {t}, {d}) {dt} {scores_kernel_kind(geo)} {tuple(geo[:4])}",
                      lambda q=q, k=k, d=d: jet_attention_scores_cuda(q, k, d ** -0.5),
                      lambda a, bb, d=d: ref.jet_attention_scores_ref(a, bb, d ** -0.5),
                      (q, k)))
    # the trunk's grid(10) launches and K4 at long T (RT_RMS_SHAPES /
    # RT_FLASH_SHAPES beside the table shapes above)
    for n1, rows, width, dname in RT_RMS_SHAPES[:1]:
        x, g = rt_rms_inputs(gen, n1, rows, width, getattr(torch, dname))
        cases.append(("jet_rms_norm", f"trunk grid(10) ({n1}, {rows}, {width}) torch.{dname}",
                      lambda x=x, g=g: jet_rms_norm_cuda(x, g, 1e-6),
                      lambda c, gg: ref.jet_rms_norm_ref(c, gg, 1e-6), (x, g)))
    for shape in (RT_FLASH_SHAPES[0], RT_FLASH_SHAPES[-1]):
        q, k, v, wo = rt_flash_inputs(gen, *shape[:6], getattr(torch, shape[6]))
        scale = shape[4] ** -0.5
        what = "trunk grid(10)" if shape[3] <= 4 else "long T"
        cases.append(("jet_flash_attention",
                      f"{what} {tuple(q.shape)}x{tuple(wo.shape)} torch.{shape[6]}",
                      lambda q=q, k=k, v=v, wo=wo, scale=scale:
                      jet_flash_attention_cuda(q, k, v, wo, scale),
                      lambda a, bb, c, d, scale=scale:
                      ref.jet_flash_attention_ref(a, bb, c, d, scale), (q, k, v, wo)))
    if trunk is not None:
        codes = {code: dt for dt, code in DTYPE_CODES.items()}
        for (n1, rows, din, dout, act, dcode), launches in sorted(
                trunk_k1_launches(trunk, trunk_params, gen).items()):
            dt, act = codes[dcode], None if ACT_NAMES[act] == "none" else ACT_NAMES[act]
            x = 0.5 * torch.randn((n1, rows, din), generator=gen, device=DEVICE, dtype=dt)
            w = torch.randn((din, dout), generator=gen, device=DEVICE, dtype=dt) / din ** 0.5
            b = 0.1 * torch.randn((dout,), generator=gen, device=DEVICE, dtype=dt)
            cases.append(("jet_dense", f"trunk grid({TRUNK_GRID_ORDER}) ({n1}, {rows}, {din})x("
                                       f"{din}, {dout}) {act or 'none'} {dt}, {launches} a call",
                          lambda x=x, w=w, b=b, act=act: jet_dense_cuda(x, w, b, act),
                          lambda c, ww, bb, act=act: ref.jet_dense_ref(c, ww, bb, act),
                          (x, w, b), act))
    out = {}
    for name, label, call, plain, args, *act in cases:
        n1 = args[0].shape[0]
        ms, host = device_time_ms(call, 20, what=f"{name} {label}")
        plain_ms = graph_time_ms(lambda: plain(*args), reps=3)
        nbytes, flops = kernel_cost(name, args, n1, *act)
        dtype = str(args[0].dtype)
        bound = bound_ms(nbytes, flops, dtype)
        entry = out.setdefault(name, {})[label] = {
            "ms": ms, "host_ms": host, "plain_ms": plain_ms, "bound_ms": bound[0],
            "bound_by": bound[1], "bytes": nbytes, "flops": flops}
        extra = ""
        if name == "jet_dense":      # the GEMM part alone, one library call
            x, w = args[0].reshape(-1, args[0].shape[-1]), args[1]
            entry["gemm_only_ms"] = device_time_ms(lambda: torch.matmul(x, w), 20)[0]
            extra = f", GEMM part alone {entry['gemm_only_ms'] * 1e3:.2f} us"
        elif name in ORDER0_LIBRARY:  # the same function at order 0, one library call
            call0, timer, what = ORDER0_LIBRARY[name]
            entry["library_order0_ms"] = timer(lambda: call0(*args))
            entry["library_order0_call"] = what
            extra = f", order-0 library call {entry['library_order0_ms'] * 1e3:.2f} us"
        print(f"  {name} {label}: {ms * 1e3:.2f} us (plain {plain_ms * 1e3:.2f} us, bound "
              f"{bound[0] * 1e3:.2f} us by {bound[1]}{extra}; host dispatch "
              f"{host * 1e3:.2f} us)")
    report["runtime_kernel_times"] = out
    return out


def rt_rms_inputs(gen, n1: int, rows: int, width: int, dt):
    import torch
    x = (0.5 * torch.randn((n1, rows, width), generator=gen, device=DEVICE,
                           dtype=torch.float64)).to(dt)
    g = (1 + 0.2 * torch.randn((width,), generator=gen, device=DEVICE,
                               dtype=torch.float64)).to(dt)
    return x, g


def rt_flash_inputs(gen, n1: int, bsz: int, heads: int, t: int, dh: int, dm: int, dt):
    import torch
    q, k, v = ((0.5 * torch.randn((n1, bsz, heads, t, dh), generator=gen, device=DEVICE,
                                  dtype=torch.float64)).to(dt) for _ in range(3))
    wo = (torch.randn((heads, dh, dm), generator=gen, device=DEVICE, dtype=torch.float64)
          / (heads * dh) ** 0.5).to(dt)
    return q, k, v, wo


def _rms_order0(x, g):
    import torch.nn.functional as F
    return F.rms_norm(x[0], (x.shape[-1],), g, 1e-6)


def _flash_order0(q, k, v, wo):
    import torch.nn.functional as F
    bsz, heads, t, dh = q.shape[1:]
    o = F.scaled_dot_product_attention(q[0], k[0], v[0], scale=dh ** -0.5)
    return o.transpose(1, 2).reshape(bsz, t, heads * dh) @ wo.reshape(heads * dh, -1)


def _scores_order0(q, k):
    import torch
    return torch.softmax(q.shape[-1] ** -0.5 * q[0] @ k[0].transpose(-1, -2), dim=-1)


# K3-K5's order-0 yardsticks in phase 7b: the same function on c_0 in one
# library call, timed beside the kernel, never called by the port; f64
# scaled_dot_product_attention synchronizes, so it is timed by events
# around single calls (an upper bound)
ORDER0_LIBRARY = {
    "jet_rms_norm": (_rms_order0, lambda fn: device_time_ms(fn, 20)[0],
                     "torch.nn.functional.rms_norm on c_0"),
    "jet_flash_attention": (_flash_order0, lambda fn: event_time_ms(fn),
                            "scaled_dot_product_attention on c_0, then @ wo (events)"),
    "jet_attention_scores": (_scores_order0, lambda fn: device_time_ms(fn, 20)[0],
                             "torch.softmax(scale * q_0 @ k_0^T)"),
}


# ---------------------------------------------------------------------------
# phases 5-6: PINN training under autograd through the kernels
# ---------------------------------------------------------------------------

KERNEL_NAMES = ("jet_dense", "act_jet", "jet_rms_norm", "jet_flash_attention",
                "jet_attention_scores")


def profile_ms(fn, reps: int, host_ops: bool = True) -> dict | None:
    """Device busy ms per call of ``fn`` from ``torch.profiler``: the sum of
    the CUDA kernels' (and copies') device intervals, split into the port's
    own kernels (by their ``<name>_kernel`` symbol) and everything else
    (the eager ops: backward recomputes, Adam, small ops).  None when the
    profiler recorded no device event.  ``host_ops=False`` records the
    device activity alone (a step of ~10^5 eager ops then costs seconds to
    trace, not minutes)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host_ops else [])
    with profile(activities=activities) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    split = {name: 0.0 for name in KERNEL_NAMES}
    split["eager"] = 0.0
    n_events = 0
    for evt in prof.events():
        if evt.device_type != DeviceType.CUDA:
            continue
        us = evt.time_range.elapsed_us()
        n_events += 1
        mine = [name for name in KERNEL_NAMES
                if re.search(rf"\b{name}\w*_kernel\b", evt.name)]
        split[mine[0] if mine else "eager"] += us
    if not n_events:
        return None
    busy = sum(split.values())
    return {"busy_ms": busy / 1e3 / reps, "kernels_per_call": n_events / reps,
            "by_kernel_ms": {k: v / 1e3 / reps for k, v in split.items() if v}}


def kernel_ms(prof: dict) -> float:
    """Device ms of the port's own kernels in a ``profile_ms`` result."""
    return sum(v for name, v in prof["by_kernel_ms"].items() if name != "eager")


def time_steps(step, reps: int, profiled: bool = True) -> dict:
    """Per call of ``step``: wall ms (host clock to a synchronize), device
    ms by CUDA events around the same calls (the device's span, idle gaps
    included) and, from a separate profiled run, device busy ms."""
    import torch
    step()
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    h0 = time.perf_counter()
    t0.record()
    for _ in range(reps):
        step()
    t1.record()
    torch.cuda.synchronize()
    out = {"wall_ms": (time.perf_counter() - h0) * 1e3 / reps,
           "event_ms": t0.elapsed_time(t1) / reps, "reps": reps}
    if profiled:
        prof = profile_ms(step, min(reps, 3))
        out["profile"] = prof
        out["busy_share"] = prof["busy_ms"] / out["wall_ms"] if prof else None
    return out


def step_times(loss_fn, ps, batch, spec: str, lr: float, profiled: bool = True) -> dict:
    """Times of one Adam step of ``loss_fn`` from ``ps`` and of its forward
    alone (the loss under autograd, no backward): the rest of a step is the
    eager backward and the update.  ``profiled`` adds the device-busy
    split of the step (never for autodiff: its traces run to millions of
    events); the forward's is taken for every engine but autodiff."""
    import torch
    from repro_torch.optim import adam_init
    from repro_torch.pinn.trainer import adam_step
    from repro_torch.tree import leaves, unflatten

    state = {"ps": ps, "opt": adam_init(ps)}

    def step():
        state["ps"], state["opt"], _, _ = adam_step(loss_fn, state["ps"],
                                                     state["opt"], lr, *batch)

    def forward():
        ls = [leaf.detach().requires_grad_() for leaf in leaves(ps)]
        return loss_fn(unflatten(ps, ls), *batch)

    reps = TIMED_STEPS[spec]
    profiled = profiled and spec != "autodiff"
    out = {"adam_step": time_steps(step, reps, profiled),
           "forward": time_steps(forward, reps, spec != "autodiff")}
    torch.cuda.synchronize()
    return out


def _losses_agree(got, want, what: str) -> float:
    require(len(got) == len(want), f"{what}: {len(got)} logged losses vs {len(want)}")
    worst = 0.0
    for i, (a, b) in enumerate(zip(got, want)):
        require(math.isfinite(a) and math.isfinite(b), f"{what}: non-finite loss at {i}")
        e = abs(a - b) / max(abs(b), 1e-300)
        require(e <= TOL_TRAIN, f"{what}: entry {i} {a!r} vs {b!r} ({e:.2e})")
        worst = max(worst, e)
    return worst


def train_burgers(seed: int, report: dict) -> dict:
    """Phase 5: Burgers profiles k in BURGERS_KS on pinn-mlp (3 x 24 tanh,
    f64) at 512 domain + 128 origin points, BURGERS_STEPS Adam steps and
    L-BFGS iterations under ntp/cuda and eager ntp from the same init and
    draws; launch counts zeroed just before each ntp/cuda run and read just
    after, returned by path (k = 4, order 10, apart).  Then times per Adam
    step and per L-BFGS iteration for ntp/cuda, ntp and (a few steps, k in
    AUTODIFF_TIMED_KS) autodiff."""
    import dataclasses

    import torch
    from repro_torch.core.ntp import init_mlp
    from repro_torch.data.collocation import resample, uniform_grid
    from repro_torch.kernels import ops
    from repro_torch.optim import lbfgs
    from repro_torch.pinn.burgers import lambda_window
    from repro_torch.pinn.trainer import (PINNRunConfig, burgers_loss_fn, train,
                                          value_and_grad)

    out = {}
    total = {path: {name: 0 for name in KERNEL_NAMES}
             for path in ("burgers_training", "burgers_k4")}
    for k in BURGERS_KS:
        cfg = PINNRunConfig(k=k, adam_steps=BURGERS_STEPS[k][0],
                            lbfgs_steps=BURGERS_STEPS[k][1], log_every=1, seed=seed)
        runs = {}
        for spec in ("ntp/cuda", "ntp"):
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            res = train(dataclasses.replace(cfg, engine=spec), device=DEVICE)
            torch.cuda.synchronize()
            launches = ops.launch_counts()
            runs[spec] = (res, launches, time.perf_counter() - t0)
        res, launches, _ = runs["ntp/cuda"]
        eager = runs["ntp"][0]
        e_loss = _losses_agree(res.loss_history, eager.loss_history, f"burgers k={k} loss")
        e_lam = _losses_agree(res.lam_history, eager.lam_history, f"burgers k={k} lambda")
        evals = cfg.adam_steps + res.lbfgs_evals
        want = 3 * cfg.depth * evals          # 3 u-jets per evaluation, one K1 per hidden layer
        require(launches["jet_dense"] == want and sum(launches.values()) == want,
                f"burgers k={k}: launches {launches}, want jet_dense {want} "
                f"({3 * cfg.depth} per loss evaluation x {evals} evaluations)")
        require(sum(runs["ntp"][1].values()) == 0, f"eager ntp launched {runs['ntp'][1]}")
        lo, hi = lambda_window(k)
        lam0 = 0.5 * (lo + hi)            # lam_raw starts at 0: the window's midpoint
        require(lo < res.lam < hi, f"burgers k={k}: lambda {res.lam} left its window")
        toward = abs(res.lam - res.target_lam) < abs(lam0 - res.target_lam)
        if k == 1:
            require(toward, f"burgers k=1: lambda {lam0} -> {res.lam} did not move "
                            f"toward {res.target_lam}")
        for name in KERNEL_NAMES:
            total["burgers_k4" if k == 4 else "burgers_training"][name] += launches[name]
        lbfgs_iters = len(res.loss_history) - cfg.adam_steps - 1

        # times, from the same init and points as the run
        gen = torch.Generator().manual_seed(seed)
        params = init_mlp(gen, 1, cfg.width, cfg.depth, 1, torch.float64, DEVICE)
        ps = (params, torch.zeros((), dtype=torch.float64, device=DEVICE))
        batch = resample(gen, -cfg.domain, cfg.domain, cfg.n_domain, cfg.n_origin,
                         cfg.origin_radius, torch.float64, DEVICE)
        grid = (uniform_grid(-cfg.domain, cfg.domain, cfg.n_domain, torch.float64, DEVICE),
                uniform_grid(-cfg.origin_radius, cfg.origin_radius, cfg.n_origin,
                             torch.float64, DEVICE))
        times = {}
        for spec in ("ntp/cuda", "ntp") + (("autodiff",) if k in AUTODIFF_TIMED_KS else ()):
            loss_fn = burgers_loss_fn(dataclasses.replace(cfg, engine=spec))
            times[spec] = step_times(loss_fn, ps, batch, spec, cfg.adam_lr,
                                     k in PROFILED_KS)
            if spec != "autodiff":
                def vg(p, loss_fn=loss_fn):
                    (loss, _), grads = value_and_grad(loss_fn, p, *grid)
                    return loss, grads
                n_it = 3          # iterations per timed call: per-iteration numbers below
                li = time_steps(lambda: lbfgs(vg, ps, steps=n_it), 1, k in PROFILED_KS)
                li["wall_ms"] /= n_it
                li["event_ms"] /= n_it
                if li.get("profile"):
                    li["profile"]["busy_ms"] /= n_it
                    li["profile"]["kernels_per_call"] /= n_it
                    li["profile"]["by_kernel_ms"] = {
                        name: v / n_it for name, v in li["profile"]["by_kernel_ms"].items()}
                times[spec]["lbfgs_iteration"] = li
        ratio = (times["autodiff"]["adam_step"]["wall_ms"]
                 / times["ntp/cuda"]["adam_step"]["wall_ms"]) if "autodiff" in times else None
        out[f"k={k}"] = {
            "order": res.order, "lambda": res.lam, "lambda0": lam0,
            "target_lambda": res.target_lam, "lambda_moved_toward_target": toward,
            "lambda_history": res.lam_history, "loss_history": res.loss_history,
            "eager_loss_history": eager.loss_history, "worst_rel_loss": e_loss,
            "worst_rel_lambda": e_lam, "launches": launches, "loss_evaluations": evals,
            "lbfgs_iterations": lbfgs_iters, "lbfgs_evals": res.lbfgs_evals,
            "run_seconds": {s: r[2] for s, r in runs.items()},
            "adam_time_s": {s: r[0].adam_time_s for s, r in runs.items()},
            "lbfgs_time_s": {s: r[0].lbfgs_time_s for s, r in runs.items()},
            "times": times, "autodiff_over_ntp_cuda_step": ratio}
        print(f"  k={k} (order {res.order}, u-jet order {res.order + 1}): lambda "
              f"{lam0:.6f} -> {res.lam:.6f} (target {res.target_lam:.6f}, "
              f"{'toward' if toward else 'away from'} it); loss {res.loss_history[0]:.4e} -> "
              f"{res.loss_history[-1]:.4e}; ntp/cuda vs ntp: losses {e_loss:.2e}, lambda "
              f"{e_lam:.2e} (tol {TOL_TRAIN:.0e}); {launches['jet_dense']} jet_dense "
              f"launches = {3 * cfg.depth} x {evals} evaluations")
        for spec, tm in times.items():
            a = tm["adam_step"]
            line = (f"    {spec:8s} Adam step wall {a['wall_ms']:.2f} ms, events "
                    f"{a['event_ms']:.2f} ms")
            if a.get("profile"):
                f = tm["forward"]["profile"]
                line += (f", busy {a['profile']['busy_ms']:.2f} ms (forward "
                         f"{f['busy_ms']:.2f} ms of it, the port's kernels "
                         f"{kernel_ms(a['profile']):.3f} ms; wall forward "
                         f"{tm['forward']['wall_ms']:.2f} ms)")
            elif tm["forward"].get("profile"):
                f = tm["forward"]["profile"]
                line += (f"; forward busy {f['busy_ms']:.2f} ms (the port's kernels "
                         f"{kernel_ms(f):.3f} ms; wall {tm['forward']['wall_ms']:.2f} ms)")
            if "lbfgs_iteration" in tm:
                li = tm["lbfgs_iteration"]
                line += f"; L-BFGS iteration wall {li['wall_ms']:.2f} ms, events {li['event_ms']:.2f} ms"
            print(line)
        print("    autodiff / ntp/cuda per Adam step (wall): "
              + (f"{ratio:.1f}x" if ratio else "not measured (order-10 towers)"))
    report["burgers_training"] = out
    return total


def train_operators(seed: int, report: dict) -> dict:
    """Phase 6: OPERATOR_ADAM Adam steps of navier-stokes on the pinn-pde
    DenseMLP, ResidualMLP and FourierFeatureMLP and of heat on the pinn-pde
    Transformer trunk (n_domain 1024),
    under ntp/cuda and eager ntp from the same init and draws; launch counts
    zeroed just before each ntp/cuda run and read just after."""
    import dataclasses

    import torch
    from repro_torch.data.collocation import sample_box
    from repro_torch.kernels import ops
    from repro_torch.pinn.operators import get_operator
    from repro_torch.pinn.trainer import (OperatorRunConfig, make_operator_net,
                                          operator_loss_fn, train_operator)

    per_call = {"dense": {"jet_dense": 4},
                **{kind: {"jet_dense": n} for kind, (_, n) in PDE_NETS.items()},
                "transformer": {name: n for name, n in TRUNK_PER_CALL.items() if n}}
    out, total = {}, {name: 0 for name in KERNEL_NAMES}
    for op_name, network, net_kwargs in OPERATOR_RUNS:
        cfg = OperatorRunConfig(op=op_name, network=network, net_kwargs=net_kwargs,
                                width=32, depth=3, n_domain=1024,
                                adam_steps=OPERATOR_ADAM, log_every=1, seed=seed)
        op = get_operator(op_name)
        runs = {}
        for spec in ("ntp/cuda", "ntp"):
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            res = train_operator(dataclasses.replace(cfg, engine=spec), device=DEVICE)
            torch.cuda.synchronize()
            runs[spec] = (res, ops.launch_counts(), time.perf_counter() - t0)
        res, launches, _ = runs["ntp/cuda"]
        eager = runs["ntp"][0]
        e_loss = _losses_agree(res.loss_history, eager.loss_history,
                               f"{op_name}/{network} loss")
        e_l2 = abs(res.l2_error - eager.l2_error) / eager.l2_error
        require(e_l2 <= TOL_TRAIN, f"{op_name}/{network} l2 error {res.l2_error!r} vs "
                                   f"{eager.l2_error!r}")
        require(res.loss_history[-1] < res.loss_history[0],
                f"{op_name}/{network}: loss did not fall")
        engine_calls = 1 + len(op.mixed)              # one grid + one cross each
        want = {name: n * engine_calls * cfg.adam_steps
                for name, n in per_call[network].items()}
        got = {name: n for name, n in launches.items() if n}
        require(got == want, f"{op_name}/{network}: launches {launches}, want {want} "
                             f"({per_call[network]} per engine call x {engine_calls} "
                             f"calls x {cfg.adam_steps} steps)")
        require(sum(runs["ntp"][1].values()) == 0, f"eager ntp launched {runs['ntp'][1]}")
        for name in KERNEL_NAMES:
            total[name] += launches[name]

        net = make_operator_net(cfg)
        params = net.init(torch.Generator().manual_seed(seed), dtype=torch.float64,
                          device=DEVICE)
        pts = sample_box(torch.Generator().manual_seed(seed + 2), op.domain,
                         cfg.n_domain, torch.float64, DEVICE)
        times = {spec: step_times(operator_loss_fn(dataclasses.replace(cfg, engine=spec),
                                                   net, DEVICE),
                                  params, (pts,), spec, cfg.adam_lr)
                 for spec in ("ntp/cuda", "ntp")}
        key = f"{op_name}/{network}"
        out[key] = {"loss_history": res.loss_history,
                    "eager_loss_history": eager.loss_history, "worst_rel_loss": e_loss,
                    "l2_error": res.l2_error, "eager_l2_error": eager.l2_error,
                    "launches": launches, "launches_per_step": per_call[network],
                    "engine_calls_per_step": engine_calls,
                    "run_seconds": {s: r[2] for s, r in runs.items()},
                    "adam_time_s": {s: r[0].adam_time_s for s, r in runs.items()},
                    "times": times}
        print(f"  {key}: loss {res.loss_history[0]:.4e} -> {res.loss_history[-1]:.4e}, "
              f"l2 {res.l2_error:.4e}; ntp/cuda vs ntp: losses {e_loss:.2e}, l2 "
              f"{e_l2:.2e} (tol {TOL_TRAIN:.0e}); launches {got}")
        for spec, tm in times.items():
            a, f = tm["adam_step"], tm["forward"]
            line = (f"    {spec:8s} Adam step wall {a['wall_ms']:.2f} ms, events "
                    f"{a['event_ms']:.2f} ms; forward wall {f['wall_ms']:.2f} ms")
            if a.get("profile"):
                line += (f"; busy {a['profile']['busy_ms']:.2f} ms per step, forward "
                         f"{f['profile']['busy_ms']:.2f} ms, the port's kernels "
                         f"{kernel_ms(a['profile']):.3f} ms")
            print(line)
    report["operator_training"] = out
    return total


# ---------------------------------------------------------------------------
# phase 3g: the Taylor-mode oracle on the card
# ---------------------------------------------------------------------------

def check_oracle(net, params, trunk, trunk_params, gen, report: dict) -> dict:
    """Phase 3g: the tables of phases 3a (DenseMLP grid(4),
    cross((0,0,1,1))), 3e (DenseMLP grid(10)) and 3f (the trunk's grid(10))
    at ORACLE_ROWS rows under ntp/cuda, held against the "jet" engine
    (``core/taylor.py``: Taylor mode through the torch operations, which
    shares nothing with ``core/jet.py``) on the same inputs on the card:
    grid tables per table slice (the trunk's relative to ``readout_scale``),
    cross tables relative to the polarization terms, within TOL_ORACLE.
    The ntp/cuda calls' launches are counted; the oracle launches none.
    Times: CUDA events around single calls (``event_time_ms``)."""
    import torch
    from repro_torch.core.engines import JetEngine, NTPEngine
    from repro_torch.kernels import ops

    engine, oracle = NTPEngine("cuda"), JetEngine()
    x = torch.rand((ORACLE_ROWS, net.d_in), generator=gen, device=DEVICE,
                   dtype=torch.float64) * 2 - 1
    total, out = {name: 0 for name in KERNEL_NAMES}, {}
    for label, n_, p_, kind, req in (("dense grid(4)", net, params, "grid", 4),
                                     ("dense cross(0,0,1,1)", net, params, "cross",
                                      (0, 0, 1, 1)),
                                     (f"dense grid({DENSE_GRID_ORDER})", net, params, "grid",
                                      DENSE_GRID_ORDER),
                                     (f"trunk grid({TRUNK_GRID_ORDER})", trunk, trunk_params,
                                      "grid", TRUNK_GRID_ORDER)):
        def call(eng, n_=n_, p_=p_, kind=kind, req=req):
            with torch.no_grad():
                return (eng.grid if kind == "grid" else eng.cross)(n_, p_, x, req)

        ops.reset_launch_counts()
        table = call(engine)
        torch.cuda.synchronize()
        launches = ops.launch_counts()
        ops.reset_launch_counts()
        want = call(oracle)
        torch.cuda.synchronize()
        require(sum(ops.launch_counts().values()) == 0,
                f"oracle {label}: the jet engine launched {ops.launch_counts()}")
        require(table.shape == want.shape and bool(torch.isfinite(want).all()),
                f"oracle {label}: shape {tuple(want.shape)} vs {tuple(table.shape)}, or "
                f"non-finite values")
        if kind == "cross":
            e = float((table - want).abs().max()) / polarization_scale(
                NTPEngine(), n_, p_, x, req)
        elif n_ is trunk:
            e = scaled_err(table, want, readout_scale(n_, p_, x, req), keep=2)
        else:
            e = rel_err(table, want, 2)
        require(e <= TOL_ORACLE, f"ntp/cuda {label} vs the jet oracle: {e:.3e}")
        ms, oracle_ms = event_time_ms(lambda: call(engine), 10), event_time_ms(
            lambda: call(oracle), 3)
        for name in KERNEL_NAMES:
            total[name] += launches[name]
        out[label] = {"err": e, "ms": ms, "oracle_ms": oracle_ms,
                      "launches": {k: v for k, v in launches.items() if v}}
        print(f"  {label} at {ORACLE_ROWS} rows: ntp/cuda vs jet {e:.2e} (tol "
              f"{TOL_ORACLE:.0e}); ntp/cuda {ms:.3f} ms, jet oracle {oracle_ms:.3f} ms "
              f"(CUDA events, single calls); launches {out[label]['launches']}")
    report["oracle"] = out
    return total


# ---------------------------------------------------------------------------
# phase 6b: data parallel on the one card
# ---------------------------------------------------------------------------

def _dp_config(seed: int, op_name: str, network: str, net_kwargs: dict, **kw):
    from repro_torch.pinn.trainer import OperatorRunConfig
    kw = {"adam_steps": DP_ADAM, "lbfgs_steps": DP_LBFGS, **kw}
    return OperatorRunConfig(op=op_name, network=network, net_kwargs=net_kwargs, width=32,
                             depth=3, n_domain=1024, log_every=1, seed=seed,
                             engine="ntp/cuda", **kw)


def dp_nccl_one_rank(seed: int, report: dict) -> dict:
    """Phase 6b, part 1: NCCL at world size 1 (NCCL refuses two ranks on one
    device), in this process: ``train_operator(data_parallel=1)`` on
    DP_RUNS (DP_ADAM Adam steps, DP_LBFGS L-BFGS iterations on the sharded
    objective) against the same run without a mesh, bit for bit (every
    logged loss, every parameter), and with the same launches."""
    import dataclasses
    import tempfile

    import torch
    import torch.distributed as dist
    from repro_torch.kernels import ops
    from repro_torch.pinn.trainer import train_operator
    from repro_torch.tree import bit_equal

    import os
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")     # one host, no network
    tmp = tempfile.mkdtemp()
    dist.init_process_group("nccl", init_method=f"file://{Path(tmp) / 'init'}",
                            world_size=1, rank=0)
    out, total = {}, {name: 0 for name in KERNEL_NAMES}
    try:
        # NCCL makes its communicator at the first collective: do that off
        # the clock, so the timed steps carry only their own all-reduces
        dist.all_reduce(torch.zeros((1,), device=DEVICE))
        torch.cuda.synchronize()
        for op_name, network, net_kwargs in DP_RUNS:
            cfg = _dp_config(seed, op_name, network, net_kwargs)
            runs = {}
            for label, c in (("single", cfg), ("nccl", dataclasses.replace(
                    cfg, data_parallel=1))):
                ops.reset_launch_counts()
                res = train_operator(c, device=DEVICE)
                torch.cuda.synchronize()
                runs[label] = (res, ops.launch_counts())
            (one, c_one), (dp, c_dp) = runs["single"], runs["nccl"]
            key = f"{op_name}/{network}"
            require(dp.loss_history == one.loss_history,
                    f"{key}: NCCL world size 1 losses {dp.loss_history} vs {one.loss_history}")
            require(bit_equal(dp.params, one.params),
                    f"{key}: NCCL world size 1 parameters differ from the single run's")
            require(c_dp == c_one and c_dp["jet_dense"] > 0 and
                    (network != "transformer" or (c_dp["jet_rms_norm"] > 0 and
                                                  c_dp["jet_flash_attention"] > 0)),
                    f"{key}: launches {c_dp} under NCCL vs {c_one} without a mesh")
            for name in KERNEL_NAMES:
                total[name] += c_dp[name]
            out[key] = {"loss_history": dp.loss_history, "launches": c_dp,
                        "adam_step_ms": 1e3 * dp.adam_time_s / DP_ADAM,
                        "single_adam_step_ms": 1e3 * one.adam_time_s / DP_ADAM,
                        "lbfgs_s": dp.lbfgs_time_s, "single_lbfgs_s": one.lbfgs_time_s}
            print(f"  NCCL world size 1, {key}: {DP_ADAM} Adam + {DP_LBFGS} L-BFGS bit for "
                  f"bit with the run without a mesh; launches {c_dp}; Adam step "
                  f"{out[key]['adam_step_ms']:.2f} ms (without a mesh "
                  f"{out[key]['single_adam_step_ms']:.2f}), L-BFGS {dp.lbfgs_time_s:.2f} s "
                  f"({one.lbfgs_time_s:.2f})")
    finally:
        dist.destroy_process_group()
    report["data_parallel_nccl"] = out
    return total


def _dp_rank(rank: int, world: int, tmp: str, seed: int) -> None:
    """One of the two gloo ranks of phase 6b (a spawned process): see
    ``dp_rank_work``; its result goes to ``tmp/rank<r>.pt``."""
    import os
    sys.path.insert(0, str(SRC))
    import torch
    import torch.distributed as dist
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")     # both ranks on this host
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{Path(tmp) / 'init'}",
                            world_size=world, rank=rank)
    try:
        torch.save(dp_rank_work(rank, seed), Path(tmp) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def signed_zero_rows(rank: int, dt):
    """Rank ``rank``'s rows of phase 6b's gather check: -0.0 and +0.0
    beside values, each rank's different, on the card."""
    import torch
    return torch.tensor([[-0.0, 0.0, 1.0 + rank], [rank - 2.5, -0.0, -0.0]], dtype=dt,
                        device=DEVICE)


def dp_rank_work(rank: int, seed: int) -> dict:
    """What each gloo rank sharing the card does: the served cross((0,0,1,1))
    and grid(10) of the DenseMLP and the trunk at DP_ROWS rows through
    ``ShardedEngine(NTPEngine("cuda"))`` (launches counted around the
    sharded calls alone) against the single-process call; a
    ``DerivativeServer(mesh=)`` answering grid(4) and cross((0,0,1,1)) on
    rank 0; a table holding -0.0 entries gathered by ``gather_rows`` at
    f64, f32 and bf16; and ``train_operator(data_parallel=2)`` on
    Navier-Stokes for every DP_COMPRESSIONS."""
    import torch
    from repro_torch.core.engines import NTPEngine
    from repro_torch.core.network import DenseMLP, Transformer
    from repro_torch.kernels import cuda_lib, ops
    from repro_torch.parallel import DataMesh, ShardedEngine, gather_rows
    from repro_torch.pinn.trainer import train_operator
    from repro_torch.serving import DerivativeServer
    from repro_torch.tree import bit_equal

    cuda_lib.library()
    mesh = DataMesh()
    engine = NTPEngine("cuda")
    sharded = ShardedEngine(engine, mesh)
    net = DenseMLP(d_in=2, width=32, depth=3, d_out=1, activation="tanh")
    params = net.init(torch.Generator().manual_seed(seed), dtype=torch.float64)
    trunk = Transformer(**TRUNK)
    trunk_params = trunk.init(torch.Generator().manual_seed(seed), dtype=torch.float64)
    x = torch.rand((DP_ROWS, 2), generator=torch.Generator(device=DEVICE).manual_seed(
        seed + 10), device=DEVICE, dtype=torch.float64) * 2 - 1
    out = {"tables": {}, "launches": {name: 0 for name in KERNEL_NAMES}}
    for label, n_, p_, order in (("dense", net, params, DENSE_GRID_ORDER),
                                 ("trunk", trunk, trunk_params, TRUNK_GRID_ORDER)):
        for kind, req in (("cross", (0, 0, 1, 1)), ("grid", order)):
            with torch.no_grad():
                fn = (lambda e: e.grid(n_, p_, x, req)) if kind == "grid" else \
                    (lambda e: e.cross(n_, p_, x, req))
                single = fn(engine)
                torch.cuda.synchronize()
                ops.reset_launch_counts()
                got = fn(sharded)
                torch.cuda.synchronize()
                launches = ops.launch_counts()
            if kind == "cross":
                e = float((got - single).abs().max()) / polarization_scale(
                    NTPEngine(), n_, p_, x, req)
            elif n_ is trunk:
                e = scaled_err(got, single, readout_scale(n_, p_, x, req), keep=2)
            else:
                e = rel_err(got, single, 2)
            for name in KERNEL_NAMES:
                out["launches"][name] += launches[name]
            out["tables"][f"{label} {kind}{req}"] = {
                "err": e, "bit_identical": bit_equal(got, single),
                "finite": bool(torch.isfinite(got).all()), "launches": launches}

    # a table holding -0.0 entries through gather_rows: gloo on CUDA
    # tensors gathers by an integer sum, which keeps every bit pattern
    for dt in (torch.float64, torch.float32, torch.bfloat16):
        want = torch.cat([signed_zero_rows(r, dt) for r in range(mesh.size)])
        got = gather_rows(signed_zero_rows(rank, dt), 0, mesh)
        out["tables"][f"signed zeros {dt}"] = {
            "err": float((got - want).abs().max()), "bit_identical": bit_equal(got, want),
            "finite": bool(torch.isfinite(got).all())}

    with torch.no_grad():
        singles = {("grid", 4): engine.grid(net, params, x, 4),
                   ("cross", (0, 0, 1, 1)): engine.cross(net, params, x, (0, 0, 1, 1))}
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    srv = DerivativeServer(net, params, "ntp/cuda", buckets=(DP_ROWS,), mesh=mesh,
                           flush_window_s=0.0)
    try:
        if rank == 0:
            for (kind, req), single in singles.items():
                got = srv.grid(x, req, timeout=300) if kind == "grid" else \
                    srv.cross(x, req, timeout=300)
                out["tables"][f"server {kind}{req}"] = {
                    "err": rel_err(got, single, 2 if kind == "grid" else 0),
                    "bit_identical": bit_equal(got, single),
                    "finite": bool(torch.isfinite(got).all())}
            out["server_metrics"] = srv.metrics()
    finally:
        srv.close()
    out["server_launches"] = ops.launch_counts()
    for name in KERNEL_NAMES:
        out["launches"][name] += out["server_launches"][name]

    op_name, network, net_kwargs = DP_RUNS[0]
    # one untimed Adam step first: a fresh process's first backward pays
    # one-time set-up (~1 s a step over 5 steps on the H100) that is not
    # the step's
    train_operator(_dp_config(seed, op_name, network, net_kwargs, data_parallel=2,
                              adam_steps=1, lbfgs_steps=0), device=DEVICE)
    for comp in DP_COMPRESSIONS:
        ops.reset_launch_counts()
        # compression is an Adam-phase knob: the L-BFGS phase runs once
        res = train_operator(_dp_config(seed, op_name, network, net_kwargs, data_parallel=2,
                                        grad_compression=comp,
                                        lbfgs_steps=DP_LBFGS if comp is None else 0),
                             device=DEVICE)
        torch.cuda.synchronize()
        launches = ops.launch_counts()
        for name in KERNEL_NAMES:
            out["launches"][name] += launches[name]
        out[f"train/{comp}"] = {"loss_history": res.loss_history,
                                "adam_step_ms": 1e3 * res.adam_time_s / DP_ADAM,
                                "lbfgs_s": res.lbfgs_time_s, "launches": launches}
    return out


def dp_gloo_two_ranks(seed: int, report: dict, single_ns: list) -> dict:
    """Phase 6b, part 2: two gloo ranks sharing the card (spawned
    processes, ``file://`` init), each running ``dp_rank_work``.  A rank
    that fails, or a pair that outlives DP_TIMEOUT, fails the run.  Checks
    here: every sharded table bit-identical (``bit_equal``: dtype, shape,
    integer views) to the single-process one (a kernel's row arithmetic
    does not depend on the batch size; the error against phase 3's scales
    is printed), the gathered -0.0 table to the rows the ranks wrote, the
    launches each
    rank's counters show (per sharded engine call a DenseMLP 4 K1, the
    trunk 16 K1, 7 K3, 3 K4; the server 4 K1 a batch on each rank), the
    uncompressed run against the single-process run of part 1 within
    TOL_TRAIN, and the compressed runs' losses finite and falling."""
    import tempfile

    import torch
    import torch.multiprocessing as mp

    tmp = tempfile.mkdtemp()
    ctx = mp.start_processes(_dp_rank, args=(2, tmp, seed), nprocs=2, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + DP_TIMEOUT
    try:
        while not ctx.join(timeout=1.0):
            require(time.monotonic() < deadline,
                    f"the two data-parallel ranks outlived {DP_TIMEOUT} s")
    except mp.ProcessRaisedException as exc:
        raise SmokeFailure(f"a data-parallel rank failed: {exc}") from exc
    except mp.ProcessExitedException as exc:
        raise SmokeFailure(f"a data-parallel rank exited: {exc}") from exc
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    ranks = [torch.load(Path(tmp) / f"rank{r}.pt", weights_only=False) for r in range(2)]
    per_call = {"dense": {"jet_dense": 4}, "trunk": {name: n for name, n in
                                                     TRUNK_PER_CALL.items() if n}}
    for r, res in enumerate(ranks):
        for key, t in res["tables"].items():
            require(t["finite"] and t["bit_identical"],
                    f"rank {r}: sharded {key} differs from the single-process table: "
                    f"{t['err']:.3e}")
            if "launches" in t:
                want = per_call[key.split()[0]]
                got = {k: v for k, v in t["launches"].items() if v}
                require(got == want, f"rank {r}: sharded {key} launched {got}, want {want}")
        want = {"jet_dense": 4 * ranks[0]["server_metrics"]["batches"]}
        got = {k: v for k, v in res["server_launches"].items() if v}
        require(ranks[0]["server_metrics"]["batches"] == 2 and got == want,
                f"rank {r}: the sharded server launched {got}, want {want}")
        for comp in DP_COMPRESSIONS:
            hist = res[f"train/{comp}"]["loss_history"]
            require(all(math.isfinite(v) for v in hist) and hist[DP_ADAM - 1] < hist[0],
                    f"rank {r}: grad_compression {comp}: losses {hist}")
        _losses_agree(res["train/None"]["loss_history"], single_ns,
                      f"rank {r}: two gloo ranks vs one process")
        require(res["train/None"]["loss_history"] == ranks[0]["train/None"]["loss_history"],
                f"rank {r}: the ranks logged different losses")
    held = {key: [res["tables"][key] for res in ranks if key in res["tables"]]
            for key in ranks[0]["tables"]}          # the server's tables: rank 0's
    exact = {key: all(t["bit_identical"] for t in ts) for key, ts in held.items()}
    worst = {key: max(t["err"] for t in ts) for key, ts in held.items()}
    print(f"  two gloo ranks on one card: sharded vs single-process tables bit-identical: "
          f"{exact}; error {worst}")
    for r, res in enumerate(ranks):
        print(f"    rank {r} launches {res['launches']}; server {res['server_launches']}")
    smi = nvidia_smi_line()
    for comp in DP_COMPRESSIONS:
        t = ranks[0][f"train/{comp}"]
        print(f"    Navier-Stokes, 2 ranks, grad_compression {comp}: Adam step "
              f"{t['adam_step_ms']:.2f} ms (rank 0, wall; two processes on one card, "
              f"not a scaling figure), loss {t['loss_history'][0]:.4e} -> "
              f"{t['loss_history'][DP_ADAM - 1]:.4e} | {smi}")
    report["data_parallel_gloo"] = {"ranks": ranks, "bit_identical": exact, "worst": worst,
                                    "nvidia_smi": smi}
    return {f"dp_gloo_rank{r}": res["launches"] for r, res in enumerate(ranks)}


def data_parallel(seed: int, report: dict) -> dict:
    """Phase 6b: NCCL at world size 1, then two gloo ranks sharing the card."""
    totals = {"dp_nccl_ws1": dp_nccl_one_rank(seed, report)}
    single_ns = report["data_parallel_nccl"]["/".join(DP_RUNS[0][:2])]["loss_history"]
    totals.update(dp_gloo_two_ranks(seed, report, single_ns))
    return totals


# ---------------------------------------------------------------------------
# phase 6c: train -> checkpoint -> serve
# ---------------------------------------------------------------------------

def _fail_once(at: int):
    """A fail_injector for the Trainer that raises at step ``at``, once."""
    left = {at}

    def injector(step):
        if step in left:
            left.clear()
            raise RuntimeError(f"injected failure at step {step}")

    return injector


def _load_example(name: str):
    import importlib.util
    spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def train_checkpoint_serve(seed: int, report: dict) -> dict:
    """Phase 6c: the product's path on the card.  ``train_operator`` fits
    heat on the pinn-pde DenseMLP (d_in 2, 3 x 32 tanh, f64, n_domain
    1024, OPERATOR_ADAM Adam steps, ``ntp/cuda``); ``CheckpointManager``
    saves the parameters (blocking) and the training state (params, Adam)
    asynchronously while the next step runs; ``from_checkpoint`` restores
    the parameters into a fresh net and serves ``grid(op.order)`` and
    ``cross((0,0,1,1))`` at CKPT_ROWS rows from CKPT_CLIENTS clients,
    held to a direct ``NTPEngine("cuda")`` call (TOL_SERVED) and nested
    autodiff (TOL_AUTODIFF) at phase 3's scales; a second server on the
    checkpoint answers the same requests with the same bits.  The pinn-pde trunk's
    parameters round-trip and its served ``grid(4)`` after the restore
    equals the table before the save.  The ``Trainer`` runs the same step
    (``ckpt_every`` CKPT_EVERY) uninterrupted, with one failure at
    CKPT_FAIL_AT (one restart, the same final state) and preempted at
    CKPT_PREEMPT_AT (a checkpoint at the boundary); every identity is
    ``bit_equal``.  Then ``examples/torch_serve_operator.py`` runs on the
    card.  Launch counters are zeroed before each of these and read after:
    K1 on the DenseMLP's calls, K1, K3 and K4 on the trunk's."""
    import tempfile

    import torch
    from repro_torch.bridge import tree_map
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.core.engines import DerivativeEngine, NTPEngine
    from repro_torch.core.network import Transformer
    from repro_torch.data.collocation import sample_box
    from repro_torch.kernels import ops
    from repro_torch.optim import adam_init
    from repro_torch.pinn.operators import get_operator
    from repro_torch.pinn.trainer import (OperatorRunConfig, adam_step, make_operator_net,
                                          operator_loss_fn, train_operator)
    from repro_torch.runtime import Trainer, TrainerConfig
    from repro_torch.serving import DerivativeServer
    from repro_torch.tree import bit_equal

    root = Path(tempfile.mkdtemp())
    op = get_operator(CKPT_OP)
    cfg = OperatorRunConfig(op=CKPT_OP, network="dense", width=32, depth=3, n_domain=1024,
                            adam_steps=OPERATOR_ADAM, log_every=1, seed=seed,
                            engine="ntp/cuda")
    per_step = 4 * (1 + len(op.mixed))          # K1 per Adam step on the DenseMLP
    paths, out = {}, {}

    def ms_since(t0: float) -> float:
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0)

    def zeros_like(tree):
        return tree_map(lambda _, t: torch.zeros_like(t), tree)

    # train
    ops.reset_launch_counts()
    res = train_operator(cfg, device=DEVICE)
    torch.cuda.synchronize()
    paths["ckpt_train"] = ops.launch_counts()
    require(paths["ckpt_train"]["jet_dense"] == per_step * OPERATOR_ADAM,
            f"training launched {paths['ckpt_train']}, want jet_dense "
            f"{per_step * OPERATOR_ADAM}")
    require(res.loss_history[-1] < res.loss_history[0], f"heat: losses {res.loss_history}")
    net = res.net
    loss_fn = operator_loss_fn(cfg, net, DEVICE)

    def step_fn(state, pts):
        params, st = state
        params, st, loss, _ = adam_step(loss_fn, params, st, cfg.adam_lr, pts)
        return (params, st), loss

    def batch_fn(step):
        return sample_box(torch.Generator().manual_seed(seed + 100 + step), op.domain,
                          cfg.n_domain, torch.float64, DEVICE)

    # checkpoint: the parameters blocking, the training state asynchronously
    # while the next step runs
    serve_dir = str(root / "serve")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    CheckpointManager(serve_dir).save(OPERATOR_ADAM, res.params, blocking=True)
    out["save_blocking_ms"] = ms_since(t0)
    state = (res.params, adam_init(res.params))
    mgr = CheckpointManager(str(root / "state"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mgr.save(OPERATOR_ADAM, state, blocking=False)
    out["save_async_blocked_ms"] = 1e3 * (time.perf_counter() - t0)
    _, loss = step_fn(state, batch_fn(OPERATOR_ADAM))
    float(loss)
    t0 = time.perf_counter()
    mgr.wait()
    out["save_async_wait_after_step_ms"] = 1e3 * (time.perf_counter() - t0)
    like = zeros_like(state)
    t0 = time.perf_counter()
    back = mgr.restore(OPERATOR_ADAM, like)
    out["restore_ms"] = ms_since(t0)
    require(bit_equal(back, state), "the training state saved during a step restores "
                                    "with other bits than it had")

    # serve from the checkpoint into a fresh net
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 11)
    xs = {i: torch.rand((CKPT_ROWS, net.d_in), generator=gen, device=DEVICE,
                        dtype=torch.float64) * 2 - 1 for i in range(CKPT_CLIENTS)}
    requests = (("grid", op.order), ("cross", (0, 0, 1, 1)))
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    srv = DerivativeServer.from_checkpoint(serve_dir, make_operator_net(cfg),
                                           engine="ntp/cuda", dtype=torch.float64,
                                           buckets=(CKPT_ROWS,), flush_window_s=0.0)
    first = srv.grid(xs[0], op.order, timeout=300)
    out["from_checkpoint_to_first_answer_ms"] = ms_since(t0)
    first_launches = ops.launch_counts()
    require(bit_equal(srv.params, res.params),
            "from_checkpoint's parameters differ from the trained ones")
    results, launches, metrics = serve_concurrently(
        {"ckpt": srv}, xs, [(kind, req, i) for i in xs for kind, req in requests])
    batches = metrics["ckpt"]["batches"]
    require(launches["jet_dense"] == 4 * (batches - 1) > 0,
            f"the served run launched {launches}, want jet_dense 4 x {batches - 1} batches")
    paths["ckpt_serve_dense"] = {k: launches[k] + first_launches[k] for k in KERNEL_NAMES}
    direct, autodiff = NTPEngine("cuda"), DerivativeEngine.from_spec("autodiff")
    worst = {"direct": 0.0, "autodiff": 0.0}
    with torch.no_grad():
        for (_, kind, req, i), table in results.items():
            call = (lambda e: e.grid(net, res.params, xs[i], req)) if kind == "grid" else \
                (lambda e: e.cross(net, res.params, xs[i], req))
            keep = 2 if kind == "grid" else 0
            e = rel_err(table, call(direct), keep)
            require(e <= TOL_SERVED, f"served {kind}{req} vs direct ntp/cuda: {e:.3e}")
            worst["direct"] = max(worst["direct"], e)
    for kind, req in requests:
        got = results[("ckpt", kind, req, 0)]
        want = (autodiff.grid(net, res.params, xs[0], req) if kind == "grid"
                else autodiff.cross(net, res.params, xs[0], req)).detach()
        e = rel_err(got, want, 2 if kind == "grid" else 0)
        require(e <= TOL_AUTODIFF, f"served {kind}{req} vs autodiff: {e:.3e}")
        worst["autodiff"] = max(worst["autodiff"], e)
    require(bit_equal(first, results[("ckpt", "grid", op.order, 0)]),
            "the first answer and a later one on the same rows differ")
    # the same requests again from a second server on the checkpoint: the
    # process has paid its one-time costs; the tables must not move
    again, _, metrics2 = serve_concurrently(
        {"ckpt": DerivativeServer.from_checkpoint(serve_dir, make_operator_net(cfg),
                                                  engine="ntp/cuda", dtype=torch.float64,
                                                  buckets=(CKPT_ROWS,), flush_window_s=0.0)},
        xs, [(kind, req, i) for i in xs for kind, req in requests])
    require(all(bit_equal(again[key], table) for key, table in results.items()),
            "a second server on the checkpoint answers with other bits")
    lat, lat2 = metrics["ckpt"]["latency"], metrics2["ckpt"]["latency"]
    wait, wait2 = metrics["ckpt"]["queue_wait"], metrics2["ckpt"]["queue_wait"]

    # the trunk: parameters and a served table across the checkpoint
    trunk = Transformer(**TRUNK)
    tp = trunk.init(torch.Generator().manual_seed(seed), dtype=torch.float64)
    with DerivativeServer(trunk, tp, "ntp/cuda", buckets=(CKPT_ROWS,),
                          flush_window_s=0.0) as s:
        before = s.grid(xs[0], 4, timeout=300)
    trunk_dir = str(root / "trunk")
    CheckpointManager(trunk_dir).save(1, tp, blocking=True)
    with DerivativeServer.from_checkpoint(trunk_dir, Transformer(**TRUNK), engine="ntp/cuda",
                                          buckets=(CKPT_ROWS,), flush_window_s=0.0) as s:
        require(bit_equal(s.params, tp), "the trunk's restored parameters differ")
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        after = s.grid(xs[0], 4, timeout=300)
        torch.cuda.synchronize()
        paths["ckpt_serve_trunk"] = ops.launch_counts()
    want = {name: n for name, n in TRUNK_PER_CALL.items() if n}
    require({k: v for k, v in paths["ckpt_serve_trunk"].items() if v} == want,
            f"the restored trunk's grid(4) launched {paths['ckpt_serve_trunk']}, want {want}")
    require(bit_equal(after, before), "the trunk's served grid(4) after the restore differs "
                                      "from the table before the save")

    # the Trainer: uninterrupted, one injected failure, preempted
    p0 = net.init(torch.Generator().manual_seed(seed), dtype=torch.float64, device=DEVICE)
    start = (p0, adam_init(p0))
    runs = {}
    for label, injector in (("uninterrupted", None), ("one failure", _fail_once(CKPT_FAIL_AT))):
        tcfg = TrainerConfig(total_steps=OPERATOR_ADAM, ckpt_every=CKPT_EVERY,
                             ckpt_dir=str(root / label.replace(" ", "_")))
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        final, rep = Trainer(tcfg, step_fn, batch_fn).run(start, fail_injector=injector)
        wall = ms_since(t0)
        runs[label] = (final, rep, ops.launch_counts(), wall)
        require(runs[label][2]["jet_dense"] == per_step * rep.steps_run,
                f"Trainer {label}: launches {runs[label][2]}, want jet_dense "
                f"{per_step} x {rep.steps_run} steps")
        paths[f"ckpt_trainer_{label.replace(' ', '_')}"] = runs[label][2]
    (clean, rep0, _, _), (failed, rep1, _, _) = runs["uninterrupted"], runs["one failure"]
    require(rep0.restarts == 0 and rep1.restarts == 1,
            f"restarts {rep0.restarts} uninterrupted, {rep1.restarts} with one failure")
    require(rep1.steps_run == OPERATOR_ADAM + CKPT_FAIL_AT % CKPT_EVERY,
            f"{rep1.steps_run} steps with one failure")
    require(bit_equal(failed, clean), "the Trainer's state after a failure and a restart "
                                      "differs from the uninterrupted run's")
    calls = {"n": 0}
    tcfg = TrainerConfig(total_steps=OPERATOR_ADAM, ckpt_every=CKPT_EVERY,
                         ckpt_dir=str(root / "preempted"))

    def preempting_batch(step):
        calls["n"] += 1
        if calls["n"] == CKPT_PREEMPT_AT:
            tr.request_preempt()
        return batch_fn(step)

    tr = Trainer(tcfg, step_fn, preempting_batch)
    ops.reset_launch_counts()
    held, rep2 = tr.run(start)
    paths["ckpt_trainer_preempted"] = ops.launch_counts()
    require(rep2.preempted and tr.ckpt.latest_step() == CKPT_PREEMPT_AT,
            f"preempted: {rep2.preempted}, latest checkpoint {tr.ckpt.latest_step()}")
    require(bit_equal(tr.ckpt.restore(CKPT_PREEMPT_AT, zeros_like(held)), held),
            "the preemption checkpoint differs from the state at the boundary")

    # the example, on the card
    ex = _load_example("torch_serve_operator")
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    ran = ex.main(EXAMPLE_ARGV + ["--ckpt-dir", str(root / "example")])
    example_s = ms_since(t0) / 1e3
    paths["serve_operator_example"] = ops.launch_counts()
    require(paths["serve_operator_example"]["jet_dense"] > 0,
            f"the example launched {paths['serve_operator_example']}")
    for spec in ex.SPECS:
        scale = max(float(t.abs().max()) for t in ran[spec]["tables"])
        require(ran[spec]["worst"] <= TOL_SERVED * scale,
                f"example, engine {spec}: served vs direct {ran[spec]['worst']:.3e}")

    smi = nvidia_smi_line()
    out.update(worst_rel_err=worst, served_latency=lat, served_queue_wait=wait,
               second_server_latency=lat2, second_server_queue_wait=wait2,
               served_batches=batches - 1,
               example_seconds=example_s, launches=paths, nvidia_smi=smi,
               trainer={label: {"restarts": r[1].restarts, "steps_run": r[1].steps_run,
                                "wall_ms": r[3], "losses": r[1].losses}
                        for label, r in runs.items()})
    print(f"  trained heat on the DenseMLP: {OPERATOR_ADAM} Adam steps, loss "
          f"{res.loss_history[0]:.4e} -> {res.loss_history[-1]:.4e}, "
          f"{paths['ckpt_train']['jet_dense']} K1 launches")
    print(f"  save {out['save_blocking_ms']:.2f} ms blocking (params); async "
          f"{out['save_async_blocked_ms']:.2f} ms blocked (training state; the writer "
          f"outlived the next step by {out['save_async_wait_after_step_ms']:.2f} ms); "
          f"restore {out['restore_ms']:.2f} ms; from_checkpoint to first answer "
          f"{out['from_checkpoint_to_first_answer_ms']:.2f} ms | {smi}")
    print(f"  served from the checkpoint: {len(results)} requests in {batches - 1} batches "
          f"after the first answer, "
          f"p50 {lat['p50_us']:.0f} us, p99 {lat['p99_us']:.0f} us (queue wait p50 "
          f"{wait['p50_us']:.0f} us); a second server on the checkpoint, the same requests: "
          f"p50 {lat2['p50_us']:.0f} us, p99 {lat2['p99_us']:.0f} us (queue wait p50 "
          f"{wait2['p50_us']:.0f} us), bit-equal tables (host clock) | {smi}; "
          f"vs direct {worst['direct']:.2e} (tol {TOL_SERVED:.0e}), vs autodiff "
          f"{worst['autodiff']:.2e} (tol {TOL_AUTODIFF:.0e}); K1 {launches['jet_dense']}")
    print(f"  trunk: parameters and served grid(4) bit-equal across the checkpoint; "
          f"launches {want}")
    print(f"  Trainer: restarts {rep0.restarts} / {rep1.restarts} (one failure at step "
          f"{CKPT_FAIL_AT}), final state bit-equal to the uninterrupted run's; preempted at "
          f"{CKPT_PREEMPT_AT} with its checkpoint; wall {runs['uninterrupted'][3]:.1f} ms "
          f"for {OPERATOR_ADAM} steps")
    print(f"  examples/torch_serve_operator.py {' '.join(EXAMPLE_ARGV)}: {example_s:.1f} s")
    report["train_checkpoint_serve"] = out
    return paths


# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# phase 6d: the LM substrate's attention family
# ---------------------------------------------------------------------------

def _allclose(got, want, rtol: float, atol: float) -> float:
    """The worst |got - want| / (atol + rtol |want|): at most 1 where
    ``torch.allclose(got, want, rtol, atol)`` holds."""
    got, want = got.double(), want.double()
    return float(((got - want).abs() / (atol + rtol * want.abs())).max())


def nested_jvp(f, n: int):
    """t -> (f(t), f'(t), ..., f^(n)(t)) for a scalar t, by n nested
    ``torch.func.jvp`` (each level carries the orders below it as outputs,
    so one evaluation gives them all)."""
    import torch

    if n == 0:
        return lambda t: (f(t),)
    lower = nested_jvp(f, n - 1)

    def g(t):
        primals, tangents = torch.func.jvp(lower, (t,), (torch.ones_like(t),))
        return primals + (tangents[-1],)

    return g


def _lm_decode_and_full(params, cfg, batch):
    """(logits of prefilling S-1 tokens and decoding the last, the full
    forward's last logits)."""
    import torch
    from repro_torch.models import decode_step, prefill

    s = batch["tokens"].shape[1]
    pre = dict(batch, tokens=batch["tokens"][:, :s - 1])
    want = _lm_last_logits(params, cfg, batch)
    with torch.no_grad():
        _, st = prefill(params, cfg, pre, pad_to=s + cfg.vlm_image_tokens)
        got, _ = decode_step(params, cfg, batch["tokens"][:, s - 1:], st)
    return got, want


def _lm_last_logits(params, cfg, batch):
    import torch
    from repro_torch.models import forward_seq
    from repro_torch.models.layers import logits

    with torch.no_grad():
        x = forward_seq(params, cfg, batch)[0][:, -1:]
        return logits(params["embed"], x, cfg)[:, 0]


def _lm_sensitivity(params, cfg, batch, want) -> float:
    """How far a LM_PERTURB relative change of the embedding table moves
    the full forward's last logits ``want``, of their scale."""
    table = params["embed"]["table"]
    moved = _lm_last_logits(dict(params, embed=dict(params["embed"],
                                                    table=table * (1 + LM_PERTURB))),
                            cfg, batch)
    return float((moved - want).abs().max() / want.abs().max())


def _lm_prefill_decode(params, cfg, batch) -> float:
    """Prefill S-1 tokens, decode the last, against the full forward's last
    logits (the reference test's bound, as a fraction of it)."""
    return _allclose(*_lm_decode_and_full(params, cfg, batch), LM_DECODE_RTOL, LM_DECODE_ATOL)


class _Wide:
    """A module proxy whose ``float32`` is float64."""

    def __init__(self, module, wide):
        self._module, self.float32 = module, wide

    def __getattr__(self, name):
        return getattr(self._module, name)


def lifted_islands():
    """A context in which the LM modules' float32 islands (RMS norm's mean
    square, RoPE's angles, attention scores, the GLA recurrence and its
    state, the MoE router) compute in float64, as the
    CPU tests lift them (``tests/_torch_lm.py``): a float64 model then
    computes in float64 throughout."""
    import contextlib
    from unittest import mock

    import torch
    from repro_torch.models import attention, gla, layers, moe, rwkv, ssm, transformer

    stack = contextlib.ExitStack()
    for mod in (layers, attention, transformer, gla, ssm, rwkv, moe):
        stack.enter_context(mock.patch.object(mod, "torch", _Wide(torch, torch.float64)))
    return stack


def lm_reduced_archs(seed: int, out: dict) -> None:
    """(a) The six attention archs reduced, float32, the same parameters on
    the card and on the CPU: the card's logits of the whole sequence
    within TOL_LM_CARD_CPU of the CPU port's (of the logit scale); prefill
    of S-1 tokens and one decode step against the card's full forward;
    ``blocked_attention`` (chunks LM_CHUNKS) against ``full_attention`` on
    the first layer, whose pattern picks the local or the global branch."""
    import torch
    from repro_torch.bridge import to_device
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeCfg
    from repro_torch.data.tokens import synthetic_batch
    from repro_torch.models import attention, forward_seq, init_model
    from repro_torch.models.layers import logits
    from repro_torch.models.transformer import _pattern_at, stack_layers

    for arch in LM_ARCHS:
        cfg = get_arch(arch).reduced()
        cpu_params = init_model(cfg, seed, device="cpu")
        cpu_batch = synthetic_batch(cfg, ShapeCfg("lm", LM_S + cfg.vlm_image_tokens, LM_B,
                                                  "prefill"), 0, device="cpu")
        params, batch = to_device(cpu_params, DEVICE), to_device(cpu_batch, DEVICE)
        with torch.no_grad():
            lg = {name: logits(p["embed"], forward_seq(p, cfg, b)[0], cfg).cpu()
                  for name, p, b in (("card", params, batch), ("cpu", cpu_params, cpu_batch))}
        card_cpu = rel_err(lg["card"], lg["cpu"], 0)
        require(card_cpu <= TOL_LM_CARD_CPU,
                f"LM {arch}: card logits {card_cpu:.3e} from the CPU port's")
        decode = _lm_prefill_decode(params, cfg, batch)
        require(decode <= 1.0, f"LM {arch}: prefill + decode {decode:.3f} of the bound "
                               f"(rtol {LM_DECODE_RTOL}, atol {LM_DECODE_ATOL})")
        j, lp = next(stack_layers(params["stack"], cfg))
        window = cfg.window if _pattern_at(cfg, j) == "local" else None
        x = torch.randn((2, 64, cfg.d_model), generator=torch.Generator().manual_seed(seed)
                        ).to(DEVICE)
        with torch.no_grad():
            blocked, _ = attention.blocked_attention(lp["attn"], cfg, x, window=window,
                                                     q_chunk=LM_CHUNKS[0],
                                                     kv_chunk=LM_CHUNKS[1])
            full, _ = attention.full_attention(lp["attn"], cfg, x, causal=True, window=window)
        branch = "local" if window is not None and window + LM_CHUNKS[0] < 64 else "global"
        blocked_err = _allclose(blocked, full, LM_BLOCKED_RTOL, LM_BLOCKED_ATOL)
        require(blocked_err <= 1.0, f"LM {arch}: blocked ({branch}) vs full attention "
                                    f"{blocked_err:.3f} of the bound")
        out[arch] = {"card_vs_cpu": card_cpu, "decode_of_bound": decode,
                     "blocked_branch": branch, "blocked_of_bound": blocked_err}
        print(f"    (a) {arch} reduced f32: card vs CPU logits {card_cpu:.2e}; prefill + "
              f"decode {decode:.3f} of the bound; blocked ({branch}) vs full "
              f"{blocked_err:.3f} of the bound")


def lm_full_width(seed: int, report: dict) -> dict:
    """Phase 6d: the LM substrate's attention family on the card (ported
    models, serve and train launchers, the jet regularizer), launch counters
    zeroed before and read after: the path launches none of the port's
    kernels (the reference's LM path reaches no Pallas kernel).
    (a) ``lm_reduced_archs``;
    (b) qwen3-0.6b at its published widths (28 layers, d_model 1024, vocab
        151936), float32: prefill + decode against the full forward, B 2,
        S 32;
    (c) the same at bfloat16, its published dtype, served through
        ``launch.serve.run`` (B 4, prompt 32, greedy, 16 tokens) twice, the
        same tokens both times, prefill ms and decode ms a token;
    (d) the same at float64: ``jet_forward_dense`` at order 3 (B 1, 16
        tokens) against nested ``torch.func.jvp`` of ``dense_primal``,
        within TOL_LM_JET of each order's max;
    (e) the same at bfloat16 trained by ``launch.train.run`` with the
        order-3 penalty (B 2, S 4096, 3 steps, no checkpoint inside the run),
        and without it: every CE and penalty finite and >= 0, the last CE
        below the first, ms a step, the penalty's share, peak memory.
    Phase 6f traces a step of (c) and of (e)."""
    import dataclasses
    import tempfile

    import torch
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeCfg
    from repro_torch.core import jet as J
    from repro_torch.data.tokens import synthetic_batch
    from repro_torch.kernels import ops
    from repro_torch.launch import serve, train
    from repro_torch.launch.ntp_reg import REG_TOKENS, dense_primal, jet_forward_dense
    from repro_torch.models import init_model
    from repro_torch.models.layers import embed
    from repro_torch.tree import num_params

    t_phase = time.perf_counter()
    out: dict = {"reduced": {}}
    smi = nvidia_smi_line()
    ops.reset_launch_counts()
    lm_reduced_archs(seed, out["reduced"])
    base = get_arch(LM_FULL)

    # (b) float32 at full width
    cfg = dataclasses.replace(base, dtype="float32")
    params = init_model(cfg, seed, device=DEVICE)
    out["n_params"] = num_params(params)
    batch = synthetic_batch(cfg, ShapeCfg("lm", LM_S, LM_B, "prefill"), 0, device=DEVICE)
    decode = _lm_prefill_decode(params, cfg, batch)
    require(decode <= 1.0, f"LM {LM_FULL} full width f32: prefill + decode {decode:.3f} "
                           f"of the bound")
    out["full_f32_decode_of_bound"] = decode
    print(f"    (b) {LM_FULL} at full width ({cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"vocab {cfg.vocab}, {out['n_params']} parameters) f32: prefill + decode "
          f"{decode:.3f} of the bound (B {LM_B}, S {LM_S}); cut: f32, not the published "
          f"bf16 (a bf16 check is no tighter than 'finite' against an f32 reference)")
    del params
    torch.cuda.empty_cache()

    # (c) bfloat16 serving, twice
    params = init_model(base, seed, device=DEVICE)
    runs = [serve.run(base, LM_SERVE["batch"], LM_SERVE["prompt_len"], LM_SERVE["gen"],
                      params=params, device=DEVICE) for _ in range(2)]
    require(torch.equal(runs[0]["tokens"], runs[1]["tokens"]),
            f"LM serve: two runs gave different tokens")
    require(runs[0]["tokens"].shape == (LM_SERVE["batch"], LM_SERVE["gen"])
            and int(runs[0]["tokens"].min()) >= 0
            and int(runs[0]["tokens"].max()) < base.vocab, "LM serve: tokens out of range")
    out["serve"] = {f"run{i}": {k: r[k] for k in ("prefill_ms", "decode_ms", "ms_per_token")}
                    for i, r in enumerate(runs)}
    print(f"    (c) {LM_FULL} bf16 served (B {LM_SERVE['batch']}, prompt "
          f"{LM_SERVE['prompt_len']}, greedy, {LM_SERVE['gen']} tokens): the same tokens "
          f"twice; prefill {runs[1]['prefill_ms']:.2f} ms, decode "
          f"{runs[1]['ms_per_token']:.2f} ms/token (first run {runs[0]['prefill_ms']:.2f} / "
          f"{runs[0]['ms_per_token']:.2f}) | {smi}")
    del params
    torch.cuda.empty_cache()

    # (d) the jet at float64 against nested forward-mode autodiff
    cfg = dataclasses.replace(base, dtype="float64")
    params = init_model(cfg, seed, device=DEVICE)
    toks = synthetic_batch(cfg, ShapeCfg("jet", LM_JET["tokens"], LM_JET["batch"], "train"),
                           0, device=DEVICE)["tokens"]
    n = LM_JET["order"]
    with torch.no_grad():
        x0 = embed(params["embed"], toks, cfg)
        v = torch.randn(x0.shape, generator=torch.Generator().manual_seed(seed),
                        dtype=x0.dtype).to(DEVICE) * (x0.shape[-1] ** -0.5)
        t0 = time.perf_counter()
        jet = J.derivatives(jet_forward_dense(params, cfg, toks, n, direction=v))
        torch.cuda.synchronize()
        jet_ms = 1e3 * (time.perf_counter() - t0)
        t0 = time.perf_counter()
        want = nested_jvp(lambda t: dense_primal(params, cfg, x0 + t * v), n)(
            torch.zeros((), dtype=torch.float64, device=DEVICE))
        torch.cuda.synchronize()
        oracle_ms = 1e3 * (time.perf_counter() - t0)
        errs = [rel_err(jet[k], want[k], 0) for k in range(n + 1)]
    require(max(errs) <= TOL_LM_JET, f"LM jet vs nested jvp: {errs} (TOL_LM_JET {TOL_LM_JET})")
    out["jet"] = {"errors_by_order": errs, "jet_ms": jet_ms, "oracle_ms": oracle_ms}
    print(f"    (d) jet_forward_dense order {n} f64 (B {LM_JET['batch']}, "
          f"{LM_JET['tokens']} tokens) vs nested jvp: {' '.join(f'{e:.1e}' for e in errs)} "
          f"by order; {jet_ms:.1f} ms, the oracle {oracle_ms:.1f} ms")
    del params, jet
    torch.cuda.empty_cache()

    # (e) Sobolev training at bfloat16, with and without the penalty
    t_e = time.perf_counter()
    out["a_to_d_seconds"] = t_e - t_phase
    shape = ShapeCfg("lm_train", LM_TRAIN["seq"], LM_TRAIN["batch"], "train")
    out["train"] = {}
    for order in (LM_TRAIN["ntp_order"], 0):
        torch.cuda.reset_peak_memory_stats()
        res = train.run(base, shape, LM_TRAIN["steps"], LM_TRAIN["lr"], ntp_order=order,
                        ckpt_dir=tempfile.mkdtemp(), ckpt_every=LM_TRAIN["steps"] + 1,
                        device=DEVICE, seed=seed)
        peak = torch.cuda.max_memory_allocated()
        ce, smooth = res["ce"], res["smooth"]
        require(len(ce) == LM_TRAIN["steps"] and res["report"].restarts == 0,
                f"LM train order {order}: {len(ce)} steps, {res['report'].restarts} restarts")
        require(all(math.isfinite(c) and c >= 0 for c in ce + smooth),
                f"LM train order {order}: CE {ce}, penalty {smooth}")
        require(ce[-1] < ce[0], f"LM train order {order}: CE {ce[0]:.4f} -> {ce[-1]:.4f}")
        if order:
            require(all(s > 0 for s in smooth), f"LM train: penalty {smooth}")
        steady = sorted(res["step_ms"][1:])[len(res["step_ms"][1:]) // 2]
        out["train"][f"ntp_order{order}"] = {
            "ce": ce, "smooth": smooth, "step_ms": res["step_ms"], "median_step_ms": steady,
            "peak_bytes": peak}
        del res
        torch.cuda.empty_cache()
    with_p, without = (out["train"][f"ntp_order{o}"] for o in (LM_TRAIN["ntp_order"], 0))
    share = 1.0 - without["median_step_ms"] / with_p["median_step_ms"]
    out["train"]["penalty_share"] = share
    print(f"    (e) {LM_FULL} bf16 trained (B {LM_TRAIN['batch']}, S {LM_TRAIN['seq']}, "
          f"{LM_TRAIN['steps']} steps, lr {LM_TRAIN['lr']}): with the order-"
          f"{LM_TRAIN['ntp_order']} penalty CE {with_p['ce'][0]:.4f} -> "
          f"{with_p['ce'][-1]:.4f}, penalty {with_p['smooth'][0]:.3e} -> "
          f"{with_p['smooth'][-1]:.3e}, {with_p['median_step_ms']:.1f} ms/step (median after "
          f"the first), peak {with_p['peak_bytes'] / 2**30:.2f} GiB; without it "
          f"{without['median_step_ms']:.1f} ms/step, peak "
          f"{without['peak_bytes'] / 2**30:.2f} GiB: the penalty is {100 * share:.1f}% of "
          f"a step at S {LM_TRAIN['seq']} (the penalty rides {REG_TOKENS} tokens whatever "
          f"S) | {smi}")
    out["e_seconds"] = time.perf_counter() - t_e
    print(f"    (a)-(d) took {out['a_to_d_seconds']:.1f} s, (e) {out['e_seconds']:.1f} s")
    print(f"    cuts: (e) B {LM_TRAIN['batch']} x S {LM_TRAIN['seq']}, not train_4k's B 256 "
          f"(sharded across cards in the reference; on one card the phase's "
          f"{LM_PHASE_LIMIT_S:.0f} s bounds the steps); (b) f32, not bf16")

    launches = ops.launch_counts()
    require(not any(launches.values()), f"LM path launched the port's kernels: {launches}")
    seconds = time.perf_counter() - t_phase
    out.update(launches=launches, seconds=seconds, nvidia_smi=smi)
    report["lm"] = out
    require(seconds <= LM_PHASE_LIMIT_S,
            f"LM phase took {seconds:.1f} s (limit {LM_PHASE_LIMIT_S:.0f} s)")
    return {"lm": launches}


def _trace_line(t: dict) -> str:
    prof = t["profile"]
    events = f", CUDA events {t['event_ms']:.2f} ms" if "event_ms" in t else ""
    if prof is None:
        return f"wall {t['wall_ms']:.2f} ms{events}; device busy not measured (no device event)"
    return (f"wall {t['wall_ms']:.2f} ms{events}, device busy {prof['busy_ms']:.2f} ms "
            f"({100 * t['busy_share']:.1f}% of the wall) in "
            f"{prof['kernels_per_call']:.0f} device ops")


def lm_traces(seed: int, report: dict) -> dict:
    """Phase 6f: where a step of the LM path spends its wall, qwen3-0.6b at
    its published widths, bfloat16, launch counters zeroed before and read
    after: one decode step at 6d (c)'s shape (``time_steps``: wall, CUDA
    events, then a profiled run with its host ops), and one training step
    with the order-3 penalty at 6d (e)'s shape (the wall of an unprofiled
    step after a warm one, then ``profile_ms`` of the device activity
    alone).  Reads the device-busy share and the device ops a token or a
    step."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeCfg
    from repro_torch.data.tokens import synthetic_batch
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.models import decode_step, init_model, prefill
    from repro_torch.optim import adam_init

    t_phase = time.perf_counter()
    smi = nvidia_smi_line()
    ops.reset_launch_counts()
    base = get_arch(LM_FULL)
    params = init_model(base, seed, device=DEVICE)
    prompts = synthetic_batch(base, ShapeCfg("serve", LM_SERVE["prompt_len"], LM_SERVE["batch"],
                                             "prefill"), 0, device=DEVICE)
    out: dict = {}
    with torch.no_grad():
        lg, st = prefill(params, base, prompts, pad_to=LM_SERVE["prompt_len"] + LM_SERVE["gen"])
        tok = lg.argmax(-1)[:, None]
        out["decode"] = time_steps(lambda: decode_step(params, base, tok, st), 5)
    del st
    print(f"    decode step (B {LM_SERVE['batch']}, {LM_SERVE['prompt_len']} cached): "
          f"{_trace_line(out['decode'])}")
    shape = ShapeCfg("lm_train", LM_TRAIN["seq"], LM_TRAIN["batch"], "train")
    step = train.train_step(base, LM_TRAIN["lr"], LM_TRAIN["ntp_order"])
    opt, batch = adam_init(params), synthetic_batch(base, shape, 0, device=DEVICE)
    out["penalty_step"] = time_steps(lambda: step(params, opt, batch), 1, profiled=False)
    t_trace = time.perf_counter()
    prof = profile_ms(lambda: step(params, opt, batch), 1, host_ops=False)
    out["penalty_step"].update(
        profile=prof, trace_seconds=time.perf_counter() - t_trace,
        busy_share=prof["busy_ms"] / out["penalty_step"]["wall_ms"] if prof else None)
    print(f"    training step with the order-{LM_TRAIN['ntp_order']} penalty (B "
          f"{LM_TRAIN['batch']} x S {LM_TRAIN['seq']}): {_trace_line(out['penalty_step'])} "
          f"(device activity alone traced, in {out['penalty_step']['trace_seconds']:.1f} s)"
          f" | {smi}")
    del params, opt, batch
    torch.cuda.empty_cache()
    launches = ops.launch_counts()
    require(not any(launches.values()), f"LM path launched the port's kernels: {launches}")
    out.update(launches=launches, seconds=time.perf_counter() - t_phase, nvidia_smi=smi)
    report["lm_traces"] = out
    return {"lm_traces": launches}


def lm_wide_archs(seed: int, report: dict) -> dict:
    """Phase 6e: the five other attention archs of LM_WIDE at their
    published widths and depths, launch counters zeroed before and read
    after (none of the port's kernels).  Each is served at bfloat16, its
    published dtype, by ``launch.serve.run`` (greedy; the tokens in range,
    prefill ms and decode ms a token).  Then prefill of S-1 tokens and one
    decode step against the full forward's last logits, over the prompt's
    whole length, past the local window where the arch has one: at float64
    with the float32 islands lifted within TOL_LM_WIDE_F64 of the logit
    scale, and at float32 on the same weights no further from that float64
    result than LM_WIDE_F32_FACTOR x the float32 full forward.  The check
    runs LM_WIDE's layers (gemma2-27b 6 of 46, llava 16 of 32: their
    float64 weights and scores must fit the card; whisper 4 + 4 of 32 + 32,
    whose random stacks turn float64 rounding into an O(1) change at full
    depth: the phase prints how far a LM_PERTURB change of the embedding
    table moves the float64 logits at the check's depth and, for whisper,
    at full depth)."""
    import contextlib
    import dataclasses
    import gc

    import torch
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeCfg
    from repro_torch.data.tokens import synthetic_batch
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import init_model
    from repro_torch.tree import num_params

    t_phase = time.perf_counter()
    smi = nvidia_smi_line()
    out: dict = {}
    ops.reset_launch_counts()
    for arch, (bsz, prompt, gen, check_layers, why) in LM_WIDE.items():
        t_arch = time.perf_counter()
        cfg = get_arch(arch)
        seq = prompt + cfg.vlm_image_tokens
        local = "local" in cfg.attn_pattern
        require(not local or seq > cfg.window,
                f"LM {arch}: {seq} tokens do not outrun the window {cfg.window}")
        torch.cuda.reset_peak_memory_stats()
        params = init_model(cfg, seed, device=DEVICE)
        n = num_params(params)
        res = serve.run(cfg, bsz, seq, gen, params=params, device=DEVICE)
        toks = res["tokens"]
        require(toks.shape == (bsz, gen) and int(toks.min()) >= 0
                and int(toks.max()) < cfg.vocab, f"LM {arch} serve: tokens {toks.shape}")
        peak = torch.cuda.max_memory_allocated()
        times = {k: res[k] for k in ("prefill_ms", "decode_ms", "ms_per_token")}
        del params, res
        gc.collect()
        torch.cuda.empty_cache()
        # the same weights at float32 and at float64 (init draws in float32);
        # at float64 also how far the stack amplifies a tiny perturbation,
        # at full depth too where chaos cut the check
        layers = check_layers or cfg.n_layers
        res, sens = {}, {}
        runs = [("float32", layers), ("float64", layers)]
        if why == "chaos":
            runs.append(("float64", cfg.n_layers))
        for dt, depth in runs:
            c = dataclasses.replace(cfg, dtype=dt, n_layers=depth)
            if why == "chaos" and cfg.encoder is not None:
                c = dataclasses.replace(c, encoder=dataclasses.replace(
                    cfg.encoder, n_layers=min(depth, cfg.encoder.n_layers)))
            params = init_model(c, seed, device=DEVICE)
            batch = synthetic_batch(c, ShapeCfg("lm", seq, bsz, "prefill"), 0, device=DEVICE)
            with lifted_islands() if dt == "float64" else contextlib.nullcontext():
                if depth == layers:
                    res[dt] = [t.double() for t in _lm_decode_and_full(params, c, batch)]
                if dt == "float64":
                    want = res[dt][1] if depth == layers else _lm_last_logits(params, c, batch)
                    sens[depth] = _lm_sensitivity(params, c, batch, want)
            del params, batch
            gc.collect()
            torch.cuda.empty_cache()
        (d32, f32), (d64, f64) = res["float32"], res["float64"]
        scale = float(f64.abs().max())
        e64 = float((d64 - f64).abs().max()) / scale
        e_full, e_dec = (float((t - f64).abs().max()) / scale for t in (f32, d32))
        bound32 = max(LM_WIDE_F32_FLOOR, LM_WIDE_F32_FACTOR * e_full)
        ref_bound = _allclose(d32, f32, LM_DECODE_RTOL, LM_DECODE_ATOL)
        require(e64 <= TOL_LM_WIDE_F64, f"LM {arch}: float64 decode vs full forward {e64:.2e} "
                                        f"of the logit scale (TOL_LM_WIDE_F64 {TOL_LM_WIDE_F64})")
        require(e_dec <= bound32, f"LM {arch}: float32 decode {e_dec:.2e} from the float64 "
                                  f"result, the full forward {e_full:.2e}")
        seconds = time.perf_counter() - t_arch
        out[arch] = {"n_params": n, "batch": bsz, "prompt": prompt, "tokens": seq, "gen": gen,
                     **times, "check_layers": layers, "f64_decode_vs_full": e64,
                     "f32_full_vs_f64": e_full, "f32_decode_vs_f64": e_dec,
                     "f32_decode_vs_full_of_ref_bound": ref_bound,
                     "f64_perturbed_by_depth": sens, "cut": why,
                     "serve_peak_bytes": peak, "seconds": seconds}
        print(f"    {arch}: {cfg.n_layers} layers, d_model {cfg.d_model}, head_dim {cfg.hd}, "
              f"vocab {cfg.vocab}, {n} parameters; bf16 served B {bsz} x {seq} tokens"
              f"{f' ({cfg.vlm_image_tokens} image)' if cfg.vlm_image_tokens else ''}"
              f"{f', {cfg.encoder.seq} encoder frames' if cfg.encoder else ''}"
              f"{f', window {cfg.window}' if local else ''}, {gen} greedy: prefill "
              f"{out[arch]['prefill_ms']:.2f} ms, decode {out[arch]['ms_per_token']:.2f} "
              f"ms/token, peak {peak / 2**30:.2f} GiB; prefill + decode vs the full "
              f"forward at {layers} layers: f64 (islands lifted) {e64:.1e} of the logit "
              f"scale; f32 decode {e_dec:.2e} / full {e_full:.2e} from the f64 result "
              f"(f32 decode vs full {ref_bound:.2f} of the reference test's bound); a "
              f"2^-50 change of the table moves the f64 logits "
              f"{', '.join(f'{v:.1e} at {k} layers' for k, v in sens.items())}; "
              f"{seconds:.1f} s")
    launches = ops.launch_counts()
    require(not any(launches.values()), f"LM path launched the port's kernels: {launches}")
    seconds = time.perf_counter() - t_phase
    out = {"archs": out, "launches": launches, "seconds": seconds, "nvidia_smi": smi}
    cut = "; ".join(f"{a}'s decode check at {v['check_layers']} of {get_arch(a).n_layers} "
                    f"layers{' (encoder too)' if v['cut'] == 'chaos' and get_arch(a).encoder else ''}"
                    f" ({v['cut']})" for a, v in out["archs"].items() if v["cut"])
    print(f"    cuts: {cut or 'none'}; every arch at its published widths and, served, its "
          f"full depth | {smi}")
    report["lm_wide"] = out
    require(seconds <= LM_WIDE_LIMIT_S,
            f"LM wide phase took {seconds:.1f} s (limit {LM_WIDE_LIMIT_S:.0f} s)")
    return {"lm_wide": launches}


def _lm_stepwise(params, cfg, tokens):
    """Logits (B, S, V) of decoding ``tokens`` (B, S) one at a time from
    ``decode_state_specs`` at position 0 (a recurrent arch's serving)."""
    import torch
    from repro_torch.models import decode_state_specs, decode_step

    b, s = tokens.shape
    st = decode_state_specs(cfg, b, s, device=tokens.device)
    st["pos"] = torch.zeros((), dtype=torch.long, device=tokens.device)
    out = []
    with torch.no_grad():
        for t in range(s):
            lg, st = decode_step(params, cfg, tokens[:, t:t + 1], st)
            out.append(lg)
    return torch.stack(out, 1)


def _lm_all_logits(params, cfg, batch):
    import torch
    from repro_torch.models import forward_seq
    from repro_torch.models.layers import logits

    with torch.no_grad():
        return logits(params["embed"], forward_seq(params, cfg, batch)[0], cfg)


def _lm_loss_and_grads(params, cfg, batch):
    """(loss, aux, {leaf key: gradient}) of ``train_loss``."""
    import torch
    from repro_torch import bridge
    from repro_torch.models import train_loss

    flat = {k: v.detach().requires_grad_() for k, v in bridge.by_key(params).items()}
    loss, metrics = train_loss(bridge.tree_map(lambda k, _: flat[k], params), cfg, batch)
    grads = torch.autograd.grad(loss, list(flat.values()))
    return loss.detach(), metrics["aux"].detach(), dict(zip(flat, grads))


def _lm_outputs(params, cfg, batch) -> dict:
    """The whole sequence's logits, ``train_loss``, its aux, the whole
    gradient (every leaf, flattened and joined) and each gradient leaf by
    key, on the CPU."""
    import torch

    loss, aux, grads = _lm_loss_and_grads(params, cfg, batch)
    out = {"logits": _lm_all_logits(params, cfg, batch), "loss": loss, "aux": aux,
           "gradient": torch.cat([g.flatten() for g in grads.values()])}
    out.update({f"grad {k}": g for k, g in grads.items()})
    return {k: v.cpu() for k, v in out.items()}


def _lm_errs(got: dict, want: dict) -> dict:
    """Each tensor's max |got - want| / max |want| (0 where both are 0)."""
    return {k: (rel_err(got[k], w, 0) if float(w.abs().max()) else float(got[k].abs().max()))
            for k, w in want.items()}


def moe_buffer_bytes(cfg, n_tokens: int, training: bool, itemsize: int) -> int:
    """Bytes of one MoE layer's dispatch buffers for ``n_tokens``: the
    packed input, the gate/up product, its activation and the experts'
    output, each (groups, experts, capacity) rows of D, 2F, F and D."""
    from repro_torch.models import moe

    g, _, cap = moe.dispatch_geometry(cfg, n_tokens, training)
    return g * cfg.moe.n_experts * cap * (2 * cfg.d_model + 3 * cfg.d_ff) * itemsize


def lm_rm_reduced(seed: int, out: dict) -> None:
    """6g (a): the four archs reduced, the same parameters on the card and
    on the CPU: the logits of the whole sequence, ``train_loss``, its MoE
    aux and the gradient.  At float64 with the islands lifted the card's
    are the CPU's within TOL_LM_RM_CARD_F64 of each tensor's scale, every
    gradient leaf on its own.  At float32 both are held to that float64
    result (the CPU tests' float32 rule): the logits, loss, aux and whole
    gradient (of its largest entry) within TOL_LM_CARD_CPU, or within
    LM_WIDE_F32_FACTOR x the CPU port's own float32 error where that is
    larger (zamba2's random reduced stack leaves its gradient 3.5e-4 of
    float32 noise, a single leaf, ``a_log``, 9.1e-3 on the CPU and 3.7e-2
    on an H100 80GB HBM3 at 700 W).
    Then on the card the reference tests' checks: step-wise decode against
    the chunked forward at every position (LM_STEPWISE_BOUND) for the
    recurrent archs, prefill of S-1 tokens and one decode step against the
    full forward for the MoE ones."""
    import dataclasses

    import torch
    from repro_torch.bridge import to_device, tree_map
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeCfg
    from repro_torch.data.tokens import synthetic_batch
    from repro_torch.models import init_model

    for arch in LM_RM_ARCHS:
        cfg = get_arch(arch).reduced()
        cfg64 = dataclasses.replace(cfg, dtype="float64")
        cpu_params = init_model(cfg, seed, device="cpu")
        cpu64 = tree_map(lambda _, t: t.double(), cpu_params)
        cpu_batch = synthetic_batch(cfg, ShapeCfg("lm", LM_S, LM_B, "prefill"), 0, device="cpu")
        params, batch = to_device(cpu_params, DEVICE), to_device(cpu_batch, DEVICE)
        with lifted_islands():
            want = _lm_outputs(cpu64, cfg64, cpu_batch)
            e64 = _lm_errs(_lm_outputs(to_device(cpu64, DEVICE), cfg64, batch), want)
        e64.pop("gradient")
        whole = {k: want[k] for k in ("logits", "loss", "aux", "gradient")}
        e_card = _lm_errs(_lm_outputs(params, cfg, batch), whole)
        e_cpu = _lm_errs(_lm_outputs(cpu_params, cfg, cpu_batch), whole)
        bound32 = max(TOL_LM_CARD_CPU, LM_WIDE_F32_FACTOR * max(e_cpu.values()))
        worst64, worst32 = (max(e.items(), key=lambda kv: kv[1]) for e in (e64, e_card))
        require(worst64[1] <= TOL_LM_RM_CARD_F64,
                f"LM {arch}: f64 card vs CPU {worst64[0]} {worst64[1]:.2e}")
        require(worst32[1] <= bound32, f"LM {arch}: f32 card {worst32[0]} {worst32[1]:.2e} from "
                                       f"the f64 result (bound {bound32:.2e})")
        aux = float(want["aux"])
        require((aux > 0) == (cfg.moe is not None), f"LM {arch}: aux {aux}")
        if cfg.block_type == "attn":
            check = _lm_prefill_decode(params, cfg, batch)
            require(check <= 1.0, f"LM {arch}: prefill + decode {check:.3f} of the bound")
            what = f"prefill + decode {check:.3f} of the bound"
        else:
            logits = _lm_all_logits(params, cfg, batch)
            check = float((_lm_stepwise(params, cfg, batch["tokens"]) - logits).abs().max())
            require(check < LM_STEPWISE_BOUND,
                    f"LM {arch}: step-wise decode {check:.2e} from the chunked forward")
            what = f"step-wise decode {check:.1e} from the chunked forward (bound " \
                   f"{LM_STEPWISE_BOUND})"
        out[arch] = {"f64_card_vs_cpu": e64, "f32_card": e_card, "f32_cpu": e_cpu,
                     "f32_bound": bound32, "check": check, "aux": aux}
        print(f"    (a) {arch} reduced: f64 card vs CPU (logits, loss, aux, {len(e64) - 3} "
              f"gradient leaves) worst {worst64[1]:.1e} ({worst64[0]}); f32 from the f64 "
              f"result, card / CPU: logits {e_card['logits']:.1e} / {e_cpu['logits']:.1e}, "
              f"loss {e_card['loss']:.1e} / {e_cpu['loss']:.1e}, gradient "
              f"{e_card['gradient']:.1e} / {e_cpu['gradient']:.1e} (bound {bound32:.1e}); aux "
              f"{aux:.3f}; {what}")


def lm_rm_serve(seed: int, smi: str, out: dict) -> None:
    """6g (b): each arch at its published widths, bfloat16, served by
    ``launch.serve.run`` (greedy) at LM_RM_SERVE's shape and depth: tokens
    in range; prefill ms (the step-wise warm-up's for the recurrent archs),
    decode ms a token, the serving peak; for the recurrent archs one
    warm-up step traced (``time_steps``: wall, CUDA events, the profiler's
    device-busy share and device ops), for the MoE archs the bytes of one
    layer's dropless dispatch buffers at the prompt, beside the peak."""
    import dataclasses
    import gc

    import torch
    from repro_torch.configs import get_arch
    from repro_torch.launch import serve
    from repro_torch.models import decode_state_specs, decode_step, init_model
    from repro_torch.tree import num_params

    for arch, (bsz, prompt, gen, layers, why) in LM_RM_SERVE.items():
        t_arch = time.perf_counter()
        full = get_arch(arch)
        cfg = dataclasses.replace(full, n_layers=layers or full.n_layers)
        require(cfg.attn_pattern != ("local",) or prompt > cfg.window,
                f"LM {arch}: a prompt of {prompt} does not outrun the window {cfg.window}")
        torch.cuda.reset_peak_memory_stats()
        params = init_model(cfg, seed, device=DEVICE)
        n = num_params(params)
        res = serve.run(cfg, bsz, prompt, gen, params=params, device=DEVICE)
        peak = torch.cuda.max_memory_allocated()
        toks = res["tokens"]
        require(toks.shape == (bsz, gen) and int(toks.min()) >= 0
                and int(toks.max()) < cfg.vocab, f"LM {arch} serve: tokens {toks.shape}")
        row = {"n_params": n, "layers": cfg.n_layers, "of_layers": full.n_layers, "batch": bsz,
               "prompt": prompt, "gen": gen, "stepwise_warmup": cfg.block_type != "attn",
               **{k: res[k] for k in ("prefill_ms", "decode_ms", "ms_per_token")},
               "serve_peak_bytes": peak, "cut": why}
        buf = ""
        if row["stepwise_warmup"]:
            # where a warm-up step's wall goes: a decode step from a fresh
            # state costs what a warm one does
            st = decode_state_specs(cfg, bsz, prompt + gen, device=DEVICE)
            st["pos"] = torch.zeros((), dtype=torch.long, device=DEVICE)
            with torch.no_grad():
                row["step_trace"] = time_steps(
                    lambda: decode_step(params, cfg, toks[:, :1], st), 5)
            del st
            buf = f"; a warm-up step traced: {_trace_line(row['step_trace'])}"
        if cfg.moe is not None:
            row["dispatch_bytes"] = moe_buffer_bytes(cfg, bsz * prompt, False, 2)
            row["dispatch_share_of_peak"] = row["dispatch_bytes"] / peak
            buf = (f"; one MoE layer's dropless dispatch buffers at the prompt "
                   f"{row['dispatch_bytes'] / 2**30:.2f} GiB, "
                   f"{100 * row['dispatch_share_of_peak']:.1f}% of the peak")
        del params, res
        gc.collect()
        torch.cuda.empty_cache()
        row["seconds"] = time.perf_counter() - t_arch
        out[arch] = row
        print(f"    (b) {arch}: {cfg.n_layers} of {full.n_layers} layers, d_model {cfg.d_model}, "
              f"vocab {cfg.vocab}, {n} parameters; bf16 served B {bsz} x {prompt} tokens"
              f"{' (warmed step by step)' if row['stepwise_warmup'] else ''}, {gen} greedy: "
              f"prefill {row['prefill_ms']:.2f} ms, decode {row['ms_per_token']:.2f} ms/token, "
              f"peak {peak / 2**30:.2f} GiB{buf}{f'; cut ({why})' if why else ''}; "
              f"{row['seconds']:.1f} s | {smi}")


def lm_rm_check(seed: int, out: dict) -> None:
    """6g (c): at published widths, float64 with the float32 islands lifted
    (``lifted_islands``), LM_RM_CHECK's depth and experts: step-wise decode
    against the chunked forward at every position (recurrent archs), or
    prefill of S-1 tokens and one decode step against the full forward
    (MoE), within TOL_LM_RM_F64 of the logit scale; and how far a
    LM_PERTURB change of the embedding table moves the last logits at that
    depth (``_lm_sensitivity``: a random deep stack that amplifies it
    towards 1 would part the two paths by rounding alone)."""
    import dataclasses
    import gc

    import torch
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeCfg
    from repro_torch.data.tokens import synthetic_batch
    from repro_torch.models import init_model

    for arch, (bsz, tokens, layers, experts, why) in LM_RM_CHECK.items():
        t_arch = time.perf_counter()
        full = get_arch(arch)
        depths = [layers or full.n_layers] + ([full.n_layers] if why == "chaos" else [])
        sens = {}
        for depth in depths:
            cfg = dataclasses.replace(full, dtype="float64", n_layers=depth)
            if experts:
                cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                                       n_experts=experts))
            params = init_model(cfg, seed, device=DEVICE)
            batch = synthetic_batch(cfg, ShapeCfg("lm", tokens, bsz, "prefill"), 0,
                                    device=DEVICE)
            with lifted_islands():
                if depth != depths[0]:          # chaos: the perturbation's reach only
                    sens[depth] = _lm_sensitivity(params, cfg, batch,
                                                  _lm_last_logits(params, cfg, batch))
                elif cfg.block_type == "attn":
                    got, want = _lm_decode_and_full(params, cfg, batch)
                    what = "prefill + decode vs the full forward"
                    sens[depth] = _lm_sensitivity(params, cfg, batch, want)
                else:
                    want = _lm_all_logits(params, cfg, batch)
                    got = _lm_stepwise(params, cfg, batch["tokens"])
                    what = f"step-wise decode vs the chunked forward at all {tokens} positions"
                    sens[depth] = _lm_sensitivity(params, cfg, batch, want[:, -1])
                if depth == depths[0]:
                    err = float((got - want).abs().max() / want.abs().max())
                    del got, want
            del params, batch
            gc.collect()
            torch.cuda.empty_cache()
        seconds = time.perf_counter() - t_arch
        out[arch] = {"layers": depths[0], "experts": experts, "tokens": tokens,
                     "f64_err": err, "f64_perturbed_by_depth": sens, "cut": why,
                     "seconds": seconds}
        print(f"    (c) {arch} f64 (islands lifted) at {depths[0]} of {full.n_layers} layers"
              f"{f', {experts} of {full.moe.n_experts} experts' if experts else ''}, B {bsz} x "
              f"{tokens} tokens: {what} {err:.1e} of the logit scale (TOL_LM_RM_F64 "
              f"{TOL_LM_RM_F64}); a 2^-50 change of the table moves the logits "
              f"{', '.join(f'{v:.1e} at {k} layers' for k, v in sens.items())}"
              f"{f'; cut ({why})' if why else ''}; {seconds:.1f} s")
        require(err <= TOL_LM_RM_F64, f"LM {arch}: f64 {what} {err:.2e} of the logit scale")


def lm_rm_train(seed: int, smi: str, out: dict) -> None:
    """6g (d): ``launch.train``'s step (``train_step``: ``train_loss``,
    backward, Adam with clipping) on zamba2 at full width and depth,
    bfloat16, LM_RM_TRAIN's steps on one batch (finite losses, ms a step,
    peak); then one training-mode ``train_loss`` + backward on mixtral at
    its published widths, LM_MOE_TRAIN's depth and shape (finite loss and
    gradients, the balance loss above 0.5 a MoE layer, ms, peak), and its
    first MoE layer's training dispatch on normals of that shape (in the
    model's dtype):
    more than half the tokens survive the capacity drops (the reference
    tests' two claims)."""
    import dataclasses
    import gc

    import torch
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeCfg
    from repro_torch.data.tokens import synthetic_batch
    from repro_torch.launch import train
    from repro_torch.models import init_model, moe
    from repro_torch.models.transformer import stack_layers
    from repro_torch.optim import adam_init

    cfg = get_arch(LM_RM_TRAIN["arch"])
    shape = ShapeCfg("lm_train", LM_RM_TRAIN["seq"], LM_RM_TRAIN["batch"], "train")
    torch.cuda.reset_peak_memory_stats()
    params = init_model(cfg, seed, device=DEVICE)
    opt, batch = adam_init(params), synthetic_batch(cfg, shape, 0, device=DEVICE)
    step = train.train_step(cfg, LM_RM_TRAIN["lr"])
    losses, step_ms = [], []
    for _ in range(LM_RM_TRAIN["steps"]):
        t0 = time.perf_counter()
        params, opt, loss, _, _ = step(params, opt, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
    peak = torch.cuda.max_memory_allocated()
    require(all(math.isfinite(v) and v > 0 for v in losses), f"LM train {cfg.name}: {losses}")
    out["zamba2"] = {"losses": losses, "step_ms": step_ms, "peak_bytes": peak}
    print(f"    (d) {cfg.name} bf16 trained by launch.train's step at full width and depth "
          f"({cfg.n_layers} layers + the shared block), B {shape.global_batch} x S "
          f"{shape.seq_len}, lr {LM_RM_TRAIN['lr']}: loss {losses[0]:.4f} -> {losses[-1]:.4f}, "
          f"{' / '.join(f'{v:.0f}' for v in step_ms)} ms a step, peak {peak / 2**30:.2f} GiB "
          f"| {smi}")
    del params, opt, batch
    gc.collect()
    torch.cuda.empty_cache()

    full = get_arch(LM_MOE_TRAIN["arch"])
    cfg = dataclasses.replace(full, n_layers=LM_MOE_TRAIN["layers"])
    shape = ShapeCfg("moe_train", LM_MOE_TRAIN["seq"], LM_MOE_TRAIN["batch"], "train")
    torch.cuda.reset_peak_memory_stats()
    params = init_model(cfg, seed, device=DEVICE)
    batch = synthetic_batch(cfg, shape, 0, device=DEVICE)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, aux, grads = _lm_loss_and_grads(params, cfg, batch)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated()
    del grads
    n_moe = sum(1 for _, lp in stack_layers(params["stack"], cfg) if "moe" in lp)
    lp = next(lp for _, lp in stack_layers(params["stack"], cfg) if "moe" in lp)
    x = torch.randn((shape.global_batch, shape.seq_len, cfg.d_model),
                    generator=torch.Generator(device=DEVICE).manual_seed(seed), device=DEVICE,
                    dtype=torch.float32).to(params["final_norm"].dtype)
    with torch.no_grad():
        y, aux1 = moe.apply_moe(lp["moe"], cfg, x, training=True)
    kept = float(torch.any(y != 0, dim=-1).double().mean())
    _, n_loc, cap = moe.dispatch_geometry(cfg, shape.global_batch * shape.seq_len, True)
    require(math.isfinite(float(loss)) and float(aux) / n_moe > 0.5 and float(aux1) > 0.5,
            f"LM {cfg.name} training: loss {float(loss)}, aux {float(aux)} over {n_moe} MoE "
            f"layers, one layer's {float(aux1)}")
    require(kept > 0.5, f"LM {cfg.name}: {kept:.3f} of the tokens survive the capacity drops")
    out["mixtral"] = {"layers": cfg.n_layers, "loss": float(loss), "aux": float(aux),
                      "moe_layers": n_moe, "layer_aux": float(aux1), "tokens_kept": kept,
                      "capacity": cap, "tokens_a_group": n_loc, "ms": ms, "peak_bytes": peak}
    print(f"    (d) {cfg.name} bf16 at {cfg.n_layers} of {full.n_layers} layers, B "
          f"{shape.global_batch} x S {shape.seq_len}: train_loss + backward (training "
          f"dispatch, capacity {cap} of {n_loc} tokens a group) {ms:.0f} ms, loss "
          f"{float(loss):.4f}, aux {float(aux):.3f} over {n_moe} MoE layers; one layer on "
          f"normals: aux {float(aux1):.3f}, {100 * kept:.1f}% of the tokens kept; peak "
          f"{peak / 2**30:.2f} GiB | {smi}")
    del params, batch, x, y
    gc.collect()
    torch.cuda.empty_cache()


def lm_recurrent_moe(seed: int, report: dict) -> dict:
    """Phase 6g: the recurrent and MoE half of the LM substrate on the
    card, launch counters zeroed before and read after (the reference
    computes it in plain jnp: none of the port's kernels may launch):
    (a) ``lm_rm_reduced``, (b) ``lm_rm_serve``, (c) ``lm_rm_check``,
    (d) ``lm_rm_train``, within LM_RM_LIMIT_S."""
    import torch
    from repro_torch.kernels import ops

    t_phase = time.perf_counter()
    smi = nvidia_smi_line()
    out: dict = {"reduced": {}, "serve": {}, "check": {}, "train": {}}
    ops.reset_launch_counts()
    lm_rm_reduced(seed, out["reduced"])
    lm_rm_serve(seed, smi, out["serve"])
    lm_rm_check(seed, out["check"])
    lm_rm_train(seed, smi, out["train"])
    launches = ops.launch_counts()
    require(not any(launches.values()), f"LM path launched the port's kernels: {launches}")
    seconds = time.perf_counter() - t_phase
    out.update(launches=launches, seconds=seconds, nvidia_smi=smi)
    cuts = [f"{a} served at {v['layers']} of {v['of_layers']} layers ({v['cut']})"
            for a, v in out["serve"].items() if v["cut"]]
    cuts += [f"{a} checked at f64 at {v['layers']} layers"
             f"{', %d experts' % v['experts'] if v['experts'] else ''} ({v['cut']})"
             for a, v in out["check"].items() if v["cut"]]
    cuts.append(f"mixtral trained at {LM_MOE_TRAIN['layers']} layers (one loss + backward)")
    print(f"    cuts: {'; '.join(cuts)}; launches {launches}; {seconds:.1f} s | {smi}")
    report["lm_recurrent_moe"] = out
    require(seconds <= LM_RM_LIMIT_S,
            f"LM recurrent/MoE phase took {seconds:.1f} s (limit {LM_RM_LIMIT_S:.0f} s)")
    torch.cuda.empty_cache()
    return {"lm_recurrent_moe": launches}


def _full(tree):
    """Every DTensor leaf of ``tree`` as its full tensor (a check reads it;
    the model never does)."""
    from repro_torch.tree import leaves, unflatten
    return unflatten(tree, [leaf.full_tensor() if hasattr(leaf, "full_tensor") else leaf
                            for leaf in leaves(tree)])


def lm_shard_train(seed: int, mesh, smi: str, out: dict) -> None:
    """6h (a): LM_SHARD_TRAIN's arch at its published widths, bf16,
    ``build_train_step(fsdp=True, policy="tp")`` on ``mesh`` and
    ``launch.train``'s step from one ``init_model`` and the same batches:
    every loss and every parameter leaf bit for bit; ms a step of each (the
    DTensor dispatch's cost) and the peaks."""
    import gc

    import torch
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeCfg
    from repro_torch.data.tokens import synthetic_batch
    from repro_torch.launch import train
    from repro_torch.launch.sharding import build_train_step
    from repro_torch.models import init_model
    from repro_torch.optim import adam_init
    from repro_torch.tree import bit_equal

    c = LM_SHARD_TRAIN
    cfg = get_arch(c["arch"])
    shape = ShapeCfg("lm_shard", c["seq"], c["batch"], "train")
    params = init_model(cfg, seed, device=DEVICE)
    batches = [synthetic_batch(cfg, shape, i, device=DEVICE) for i in range(c["steps"])]
    built = build_train_step(cfg, mesh, shape, fsdp=True, policy="tp", lr=c["lr"])
    runs = {}
    for label, step in (("sharded", built.fn), ("plain", train.train_step(cfg, c["lr"]))):
        torch.cuda.reset_peak_memory_stats()
        p, o, losses, ms = params, adam_init(params), [], []
        for batch in batches:
            t0 = time.perf_counter()
            p, o, loss, *_ = step(p, o, batch)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(loss.full_tensor() if hasattr(loss, "full_tensor") else loss)
        runs[label] = (_full(p), torch.stack(losses), ms, torch.cuda.max_memory_allocated())
        del o
    (ps, ls, ms_s, peak_s), (pp, lp, ms_p, peak_p) = runs["sharded"], runs["plain"]
    require(bit_equal(ls, lp), f"6h (a): sharded losses {ls.tolist()} vs {lp.tolist()}")
    require(bit_equal(ps, pp), "6h (a): sharded parameters differ from launch.train's")
    out["train"] = {"arch": cfg.name, "losses": ls.tolist(), "sharded_step_ms": ms_s,
                    "plain_step_ms": ms_p, "sharded_peak_bytes": peak_s,
                    "plain_peak_bytes": peak_p, "rules": repr(built.rules)}
    print(f"    (a) {cfg.name} bf16 at its published widths, B {shape.global_batch} x S "
          f"{shape.seq_len}, {c['steps']} steps: build_train_step(fsdp, tp) bit for bit with "
          f"launch.train's step (losses {', '.join(f'{v:.4f}' for v in ls.tolist())}); ms a "
          f"step {' / '.join(f'{v:.0f}' for v in ms_s)} sharded, "
          f"{' / '.join(f'{v:.0f}' for v in ms_p)} plain; peak {peak_s / 2**30:.2f} / "
          f"{peak_p / 2**30:.2f} GiB | {smi}")
    del params, batches, runs, ps, pp
    gc.collect()
    torch.cuda.empty_cache()


def lm_shard_decode(seed: int, mesh, smi: str, out: dict) -> None:
    """6h (b): LM_SHARD_DECODE's arch at its published widths, bf16:
    ``build_serve_step`` decodes its tokens from a fresh state beside
    ``decode_step``; the logits of every step and every state leaf bit for
    bit; ms a token of each."""
    import gc

    import torch
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeCfg
    from repro_torch.data.tokens import synthetic_batch
    from repro_torch.launch.sharding import build_serve_step
    from repro_torch.models import decode_state_specs, decode_step, init_model
    from repro_torch.tree import bit_equal

    c = LM_SHARD_DECODE
    cfg = get_arch(c["arch"])
    shape = ShapeCfg("lm_shard", c["tokens"], c["batch"], "decode")
    params = init_model(cfg, seed, device=DEVICE)
    tokens = synthetic_batch(cfg, ShapeCfg("lm", c["tokens"], c["batch"], "prefill"), 0,
                             device=DEVICE)["tokens"]
    built = build_serve_step(cfg, mesh, shape)
    runs = {}
    for label, step in (("sharded", built.fn),
                        ("plain", lambda p, t, st: decode_step(p, cfg, t, st))):
        st = decode_state_specs(cfg, c["batch"], c["tokens"], device=DEVICE)
        logits, ms = [], []
        with torch.no_grad():
            for i in range(c["tokens"]):
                t0 = time.perf_counter()
                lg, st = step(params, tokens[:, i:i + 1], st)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
                logits.append(lg.full_tensor() if hasattr(lg, "full_tensor") else lg)
        runs[label] = (torch.stack(logits), _full(st), ms)
    (ls, ss, ms_s), (lp, sp, ms_p) = runs["sharded"], runs["plain"]
    require(bit_equal(ls, lp), "6h (b): sharded decode logits differ from decode_step's")
    require(bit_equal(ss, sp), "6h (b): sharded decode state differs from decode_step's")
    med_s, med_p = sorted(ms_s)[len(ms_s) // 2], sorted(ms_p)[len(ms_p) // 2]
    out["decode"] = {"arch": cfg.name, "sharded_token_ms": ms_s, "plain_token_ms": ms_p}
    print(f"    (b) {cfg.name} bf16 at its published widths, B {c['batch']}: "
          f"build_serve_step decodes {c['tokens']} tokens bit for bit with decode_step "
          f"(logits and every state leaf); ms a token (median) {med_s:.1f} sharded, "
          f"{med_p:.1f} plain | {smi}")
    del params, runs, ss, sp
    gc.collect()
    torch.cuda.empty_cache()


def lm_shard_prefill(seed: int, mesh, out: dict) -> None:
    """6h (c): LM_SHARD_PREFILL's arch at its published widths, its depth
    and experts cut for memory (one MoE layer: the expert-parallel specs
    apply), f64 with the islands lifted: ``build_prefill_step`` against
    ``forward_seq`` + ``logits`` within TOL_LM_SHARD_MOE of the logit
    scale."""
    import dataclasses
    import gc

    import torch
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeCfg
    from repro_torch.data.tokens import synthetic_batch
    from repro_torch.launch.sharding import build_prefill_step
    from repro_torch.models import init_model, moe

    c = LM_SHARD_PREFILL
    full = get_arch(c["arch"])
    cfg = dataclasses.replace(full, dtype="float64", n_layers=c["layers"],
                              moe=dataclasses.replace(full.moe, n_experts=c["experts"]))
    shape = ShapeCfg("lm_shard", c["tokens"], c["batch"], "prefill")
    params = init_model(cfg, seed, device=DEVICE)
    batch = synthetic_batch(cfg, shape, 0, device=DEVICE)
    built = build_prefill_step(cfg, mesh, shape)
    with lifted_islands():
        t0 = time.perf_counter()
        got = built.fn(params, batch).full_tensor()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        want = _lm_last_logits(params, cfg, batch)
        torch.cuda.synchronize()
        ms_plain = (time.perf_counter() - t0) * 1e3
    err = float((got - want).abs().max() / want.abs().max())
    out["prefill"] = {"arch": cfg.name, "layers": cfg.n_layers, "experts": c["experts"],
                      "expert_parallel": c["experts"] >= moe.EP_MIN_EXPERTS, "f64_err": err,
                      "sharded_ms": ms, "plain_ms": ms_plain}
    print(f"    (c) {cfg.name} f64 (islands lifted) at {cfg.n_layers} of {full.n_layers} "
          f"layers, {c['experts']} of {full.moe.n_experts} experts (expert parallel), B "
          f"{c['batch']} x {c['tokens']} tokens: build_prefill_step vs forward_seq + logits "
          f"{err:.1e} of the logit scale (TOL_LM_SHARD_MOE {TOL_LM_SHARD_MOE}); {ms:.0f} ms "
          f"sharded, {ms_plain:.0f} ms plain")
    require(err <= TOL_LM_SHARD_MOE, f"6h (c): prefill {err:.2e} of the logit scale")
    del params, batch, got, want
    gc.collect()
    torch.cuda.empty_cache()


def lm_shard_restore(seed: int, mesh, out: dict) -> None:
    """6h (d): a qwen3 parameter tree (bf16, published widths) placed on
    ``mesh`` by ``build_train_step``'s shardings (fsdp, tp), saved by the
    ``CheckpointManager`` from there, and restored with ``shardings=`` onto
    another mesh (1-D, "data") with the data-parallel policy's placements:
    every leaf bit for bit, on the target mesh and placements.  (On one rank
    every placement is ``Replicate()``: an axis of size 1 shards nothing;
    the gloo ranks of the CPU tests restore across placements.)"""
    import gc
    import tempfile

    import torch
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.configs import get_arch
    from repro_torch.launch.sharding import (bind_param_shardings, distribute_params,
                                             make_rules)
    from repro_torch.models import init_model, param_specs
    from repro_torch.tree import bit_equal, leaves
    from torch.distributed.device_mesh import init_device_mesh

    cfg = get_arch(LM_SHARD_TRAIN["arch"])
    params = init_model(cfg, seed, device=DEVICE)
    meta = init_model(cfg, abstract=True)
    flat = init_device_mesh(DEVICE, (1,), mesh_dim_names=("data",))
    src = bind_param_shardings(mesh, param_specs(cfg), meta,
                               make_rules(mesh, fsdp=True, policy="tp"))
    dst = bind_param_shardings(flat, param_specs(cfg), meta,
                               make_rules(flat, fsdp=False, policy="dp"))
    placed = distribute_params(params, src)
    ckpt = CheckpointManager(tempfile.mkdtemp())
    t0 = time.perf_counter()
    ckpt.save(0, placed)
    t_save = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = ckpt.restore(0, placed, shardings=dst)
    t_restore = time.perf_counter() - t0
    require(all(b.device_mesh is flat and tuple(b.placements) == s.placements
                for b, s in _placed_pairs(back, dst)),
            "6h (d): restored leaves are not on the target mesh and placements")
    require(bit_equal(_full(back), params), "6h (d): restored parameters differ")
    out["restore"] = {"leaves": len(leaves(back)), "save_s": t_save, "restore_s": t_restore}
    print(f"    (d) {cfg.name} bf16 parameters ({len(leaves(back))} leaves) saved from the "
          f"(1, 1) mesh's (fsdp, tp) placements and restored onto a 1-D mesh with the (dp) "
          f"placements: bit for bit; save {t_save:.2f} s, restore {t_restore:.2f} s")
    del params, placed, back
    gc.collect()
    torch.cuda.empty_cache()


def _placed_pairs(tree, shardings) -> list:
    """(leaf, ``Sharding``) pairs of a tree and its shardings."""
    from repro_torch.launch.sharding import zip_map

    pairs = []
    zip_map(lambda t, s: pairs.append((t, s)), tree, shardings)
    return pairs


def lm_shard_plan(out: dict) -> None:
    """6h (e): every arch on both production meshes at every applicable
    shape, per-rank bytes of the parameters (plus Adam's m and v for
    training) and of the decode state, from the bound specs on meta
    tensors (``launch.dryrun.shard_plan``)."""
    from repro_torch.launch.dryrun import shard_plan

    out["plan"] = shard_plan(out=lambda line: print(f"    (e) {line}"))


def lm_sharding(seed: int, report: dict) -> dict:
    """Phase 6h: the LM substrate's sharding half on the card, under NCCL at
    world size 1 on a (1, 1) ("data", "model") mesh, launch counters zeroed
    before and read after (none of the port's kernels may launch): (a)
    ``lm_shard_train``, (b) ``lm_shard_decode``, (c) ``lm_shard_prefill``,
    (d) ``lm_shard_restore``, (e) ``lm_shard_plan``, within
    LM_SHARD_LIMIT_S."""
    import os
    import tempfile

    import torch
    import torch.distributed as dist
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_debug_mesh

    t_phase = time.perf_counter()
    smi = nvidia_smi_line()
    out: dict = {}
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")     # one host, no network
    dist.init_process_group("nccl", init_method=f"file://{Path(tempfile.mkdtemp()) / 'init'}",
                            world_size=1, rank=0)
    try:
        mesh = make_debug_mesh(1, 1, DEVICE)
        ops.reset_launch_counts()
        lm_shard_train(seed, mesh, smi, out)
        lm_shard_decode(seed, mesh, smi, out)
        lm_shard_prefill(seed, mesh, out)
        lm_shard_restore(seed, mesh, out)
        launches = ops.launch_counts()
    finally:
        dist.destroy_process_group()
    lm_shard_plan(out)
    require(not any(launches.values()), f"LM sharding launched the port's kernels: {launches}")
    seconds = time.perf_counter() - t_phase
    out.update(launches=launches, seconds=seconds, nvidia_smi=smi,
               torch=torch.__version__)
    print(f"    launches {launches}; {seconds:.1f} s | {smi}")
    report["lm_sharding"] = out
    require(seconds <= LM_SHARD_LIMIT_S,
            f"LM sharding phase took {seconds:.1f} s (limit {LM_SHARD_LIMIT_S:.0f} s)")
    return {"lm_sharding": launches}


DRYRUN_CHILD = """
import json, sys
from repro_torch.launch import dryrun
for arch, shape, mesh, layers in json.loads(sys.argv[1]):
    rec = dryrun.run_cell(arch, shape, mesh, device=sys.argv[2], layers=layers, verbose=False)
    print("CELL " + json.dumps(dict(rec, cut=layers)), flush=True)
"""


def dryrun_cells() -> tuple:
    """6i (a)'s cells: the gate's."""
    from repro_torch.launch import dryrun_gate
    return tuple(dryrun_gate.CELLS)


def lm_dryrun_cells() -> list:
    """6i (a): start the cells in five child processes (zamba2's cell, the
    longest, alone in one; the prefill cells in another; rwkv6's and
    mixtral's training cells one each); returns the processes."""
    import os
    env = dict(os.environ, PYTHONPATH=str(SRC))
    cells = dryrun_cells()
    alone = [c for c in cells if c[0] == "zamba2-2.7b"
             or (c[1] == "train_4k" and c[0] in ("rwkv6-3b", "mixtral-8x7b"))]
    prefill = [c for c in cells if c not in alone and c[1] == "prefill_32k"]
    parts = ([c for c in cells if c not in alone and c not in prefill], prefill,
             *([c] for c in alone))
    return [subprocess.Popen([sys.executable, "-c", DRYRUN_CHILD, json.dumps(part), DEVICE],
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                             env=env) for part in parts if part]


def lm_dryrun_read(procs: list, out: dict) -> None:
    """6i (a): every cell's record from the children; each must have run to
    its end."""
    recs = []
    for proc in procs:
        stdout, stderr = proc.communicate(timeout=LM_DRYRUN_LIMIT_S)
        require(proc.returncode == 0, f"6i (a): a dry-run child exited {proc.returncode}: "
                                      f"{stderr[-3000:]}")
        recs += [json.loads(line[5:]) for line in stdout.splitlines()
                 if line.startswith("CELL ")]
    from repro_torch.launch import dryrun_gate
    cells = dryrun_cells()
    require(len(recs) == len(cells), f"6i (a): {len(recs)} of {len(cells)} cells came back")
    differ = []
    for rec in recs:
        require("error" not in rec and rec["hlo_gflops"] > 0,
                f"6i (a): {rec.get('arch')} {rec.get('shape')}: {rec.get('error')}")
        key = (rec["arch"], rec["shape"], rec["mesh"], rec["cut"])
        want = dryrun_gate.CELLS.get(key)
        rec["cpu"] = want
        rec["differences"] = ([] if want is None else dryrun_gate.differences(rec, want))
        differ += [f"{' '.join(map(str, key))}: {d}" for d in rec["differences"]]
        print(f"    (a) {rec['arch']} {rec['shape']} {rec['mesh']} ({rec['layers']} layers, "
              f"{rec['n_chips']} ranks, {rec['device']}, torch {rec['torch']}): "
              f"{rec['per_device_mem_gb']:.2f} GiB a rank, {rec['hlo_gflops'] / 1e3:.3f} TFLOP, "
              f"{rec['hlo_gbytes']:.2f} GB, collectives GB {rec['collectives']}; terms "
              f"c/m/x {rec['compute_s']:.4f} / {rec['memory_s']:.4f} / "
              f"{rec['collective_s']:.4f} s -> {rec['bottleneck']} ({rec['run_s']} s)")
        if rec["cpu"] is not None:
            print(f"        against the CPU's count (torch 2.13): FLOPs {rec['flops']:.6e} / "
                  f"{rec['cpu']['flops']:.6e}, collective bytes {rec['collective_bytes']} / "
                  f"{rec['cpu']['collectives']}; GiB {rec['per_device_mem_gb']:.2f} / "
                  f"{rec['cpu']['gib']:.2f} (not held); "
                  f"{'equal' if not rec['differences'] else 'DIFFERENT'} within "
                  f"{dryrun_gate.RTOL:.0%}")
    out["cells"] = recs
    require(not differ, "6i (a): the card's counts differ from the CPU's: " + "; ".join(differ))


def _profiler_flops(step, args) -> tuple[float, dict]:
    """All the FLOPs that ``torch.profiler(with_flops=True)`` counts over
    one call of ``step``, and {op: [calls, FLOPs]} of the products among
    them."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 with_flops=True) as prof:
        step(*args)
        torch.cuda.synchronize()
    events = prof.key_averages()
    dots = ("aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm", "aten::convolution")
    return (float(sum(e.flops for e in events)),
            {e.key: [e.count, float(e.flops)] for e in events if e.key in dots})


def _op_flops(counter) -> dict:
    """{op: [calls, FLOPs]} of the products an ``OpCounter`` saw."""
    out: dict = {}
    for name, flops, *_, n in counter.log():
        if flops:
            calls, total = out.get(name, [0, 0.0])
            out[name] = [calls + n, total + flops * n]
    return out


def lm_dryrun_calibrate(seed: int, mesh, smi: str, out: dict) -> None:
    """6i (b): LM_SHARD_TRAIN's qwen3 step, bf16, on the card: unsharded
    (``launch.train``'s step; timed, profiled, counted by ``op_static`` on
    the card and on fake tensors) and through ``build_train_step`` on the
    (1, 1) mesh (counted)."""
    import gc

    import torch
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeCfg
    from repro_torch.data.tokens import synthetic_batch
    from repro_torch.launch import dryrun, op_analysis, op_static, train
    from repro_torch.launch.sharding import build_train_step
    from repro_torch.models import init_model
    from repro_torch.optim import adam_init
    from repro_torch.tree import leaves, tree_map
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.checkpoint import set_checkpoint_early_stop

    c = LM_SHARD_TRAIN
    cfg = get_arch(c["arch"])
    shape = ShapeCfg("lm_shard", c["seq"], c["batch"], "train")
    params = init_model(cfg, seed, device=DEVICE)
    opt = adam_init(params)
    batch = synthetic_batch(cfg, shape, 0, device=DEVICE)
    step = train.train_step(cfg, c["lr"])
    args = (params, opt, batch)
    step(*args)                                   # warm
    torch.cuda.synchronize()
    arg_bytes = sum(t.numel() * t.element_size() for t in leaves(args))
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ms = []
    for _ in range(LM_DRYRUN_STEPS):
        t0 = time.perf_counter()
        step(*args)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    # the products compared with checkpoint's early stop off: it ends a
    # group's recomputation by raising inside one product's autograd
    # wrapper, after the profiler has counted that product and before it
    # runs (the default run's counts are kept beside)
    with set_checkpoint_early_stop(False):
        prof_all, prof_ops = _profiler_flops(step, args)
        with op_static.OpCounter() as real_counter:
            step(*args)
    prof_dots = sum(f for _, f in prof_ops.values())
    full = real_counter.totals
    default_prof = _profiler_flops(step, args)[1]
    with op_static.OpCounter() as default_counter:
        step(*args)
    real = default_counter.totals
    mode = FakeTensorMode(allow_non_fake_inputs=True)
    with mode:
        fake = tuple(tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype, device=t.device),
                              a) for a in args)
    with mode, op_static.OpCounter() as counter:
        step(*fake)
    predicted = arg_bytes + counter.peak_bytes
    built = build_train_step(cfg, mesh, shape, fsdp=True, policy="tp", lr=c["lr"])
    built.fn(*args)                               # DTensor's propagation, once
    _, sharded = op_static.analyze(built.fn, *args, mesh=mesh)
    step_s = sorted(ms)[len(ms) // 2] / 1e3
    rl = dryrun.roofline(cfg.name, shape, "1x1", cfg, real, {"data": 1, "model": 1}, predicted)
    model = op_analysis.model_flops(cfg, shape, 1)
    flop_err = abs(full.flops - prof_dots) / prof_dots
    mem_err = abs(predicted - peak) / peak
    share = rl.bound_s / step_s
    out["calibration"] = {
        "arch": cfg.name, "batch": shape.global_batch, "seq": shape.seq_len,
        "step_ms": ms, "op_static_flops": real.flops, "op_static_flops_no_early_stop": full.flops,
        "profiler_flops": prof_all,
        "profiler_dot_flops": prof_dots, "flop_rel_err": flop_err,
        "profiler_products": prof_ops, "op_static_products": _op_flops(real_counter),
        "early_stop_profiler_products": default_prof,
        "early_stop_op_static_products": _op_flops(default_counter),
        "sharded_flops": sharded.flops, "fake_flops": counter.totals.flops,
        "op_static_bytes": real.bytes, "argument_bytes": arg_bytes,
        "temp_bytes": counter.peak_bytes, "predicted_peak": predicted,
        "max_memory_allocated": peak, "mem_rel_err": mem_err,
        "roofline": rl.asdict(), "bound_s": rl.bound_s, "share": share,
        "achieved_tflops": real.flops / step_s / 1e12, "model_flops": model,
        "mfu": model / (step_s * op_analysis.PEAK_FLOPS["bfloat16"]), "nvidia_smi": smi}
    print(f"    (b) {cfg.name} bf16 B {shape.global_batch} x S {shape.seq_len}, checkpoint's "
          f"early stop off: op_static {full.flops:.6e} FLOPs, the profiler's products "
          f"{prof_dots:.6e} ({flop_err:.2e} apart, LM_DRYRUN_FLOP_RTOL {LM_DRYRUN_FLOP_RTOL}), "
          f"all its ops {prof_all:.6e} (mul / add at one FLOP an element); the default run: "
          f"op_static {real.flops:.6e}, the profiler's products "
          f"{sum(f for _, f in default_prof.values()):.6e} (it counts the product each "
          f"recomputation stops in); fake tensors {counter.totals.flops:.6e}; (1, 1) mesh "
          f"{sharded.flops:.6e}")
    print(f"        step {step_s * 1e3:.1f} ms (median of {ms}), roofline c/m {rl.compute_s * 1e3:.2f}"
          f" / {rl.memory_s * 1e3:.2f} ms -> {rl.bottleneck}, {share:.1%} of the step; "
          f"{real.flops / step_s / 1e12:.1f} TFLOP/s achieved, model FLOPs / (step x 989 "
          f"TFLOP/s) {out['calibration']['mfu']:.2%} | {smi}")
    print(f"        peak: predicted {predicted / 2**30:.2f} GiB (arguments "
          f"{arg_bytes / 2**30:.2f} + temporaries {counter.peak_bytes / 2**30:.2f}), "
          f"max_memory_allocated {peak / 2**30:.2f} GiB ({mem_err:.1%} apart, "
          f"LM_DRYRUN_MEM_RTOL {LM_DRYRUN_MEM_RTOL:.0%})")
    require(flop_err <= LM_DRYRUN_FLOP_RTOL,
            f"6i (b): op_static {full.flops} against the profiler's {prof_dots}")
    require(sharded.flops == real.flops and counter.totals.flops == real.flops,
            f"6i (b): sharded {sharded.flops}, fake {counter.totals.flops}, "
            f"unsharded {real.flops}")
    require(share <= 1.0, f"6i (b): the bound {rl.bound_s} s exceeds the step {step_s} s")
    require(mem_err <= LM_DRYRUN_MEM_RTOL,
            f"6i (b): predicted peak {predicted} against {peak}")
    del params, opt, batch, args, fake, built
    gc.collect()
    torch.cuda.empty_cache()


def lm_dryrun(seed: int, report: dict) -> dict:
    """Phase 6i: the dry run's cells on the card's torch (five children,
    fake process groups) while the main process calibrates op_static and
    the roofline on the card (NCCL at world size 1, a (1, 1) mesh); launch
    counters zeroed before and read after (none of the port's kernels),
    within LM_DRYRUN_LIMIT_S."""
    import os
    import tempfile

    import torch
    import torch.distributed as dist
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_debug_mesh

    t_phase = time.perf_counter()
    smi = nvidia_smi_line()
    out: dict = {}
    report["lm_dryrun"] = out        # filled as the phase goes: kept if it fails
    procs = lm_dryrun_cells()
    try:
        os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
        dist.init_process_group("nccl", init_method=f"file://{Path(tempfile.mkdtemp()) / 'init'}",
                                world_size=1, rank=0)
        failed = None
        try:
            mesh = make_debug_mesh(1, 1, DEVICE)
            ops.reset_launch_counts()
            try:
                lm_dryrun_calibrate(seed, mesh, smi, out)
            except SmokeFailure as e:      # (a)'s cells are read all the same
                failed = e
            launches = ops.launch_counts()
        finally:
            dist.destroy_process_group()
        lm_dryrun_read(procs, out)
        if failed is not None:
            raise failed
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    require(not any(launches.values()), f"the dry run launched the port's kernels: {launches}")
    seconds = time.perf_counter() - t_phase
    out.update(launches=launches, seconds=seconds, nvidia_smi=smi, torch=torch.__version__)
    print(f"    launches {launches}; {seconds:.1f} s | {smi}")
    require(seconds <= LM_DRYRUN_LIMIT_S,
            f"the dry-run phase took {seconds:.1f} s (limit {LM_DRYRUN_LIMIT_S:.0f} s)")
    return {"lm_dryrun": launches}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the weights, inputs and queries")
    ap.add_argument("--against", type=Path, default=None, metavar="DIR",
                    help="another checkout of the repository (e.g. the parent commit "
                         "unpacked with git archive): time its K1, K2, K4 and K5 in turns "
                         "with this tree's and trace the trunk's cross call with its "
                         "kernels too (phase 8)")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs the GPU",
              file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: no src/repro_torch next to {__file__}; run it from "
              "a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.core.network import DenseMLP, Transformer, make_network
    from repro_torch.kernels import cuda_lib

    report: dict = {"seed": args.seed}
    t_start = time.perf_counter()
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    print(f"[1] device: {kind} | nvidia-smi: {smi} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    cuda_lib.library()
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", cuda_lib.LIBRARY.build_log)]
    spills = [int(s) for s in re.findall(r"(\d+) bytes spill stores",
                                         cuda_lib.LIBRARY.build_log)]
    print(f"    kernels built in {cuda_lib.LIBRARY.build_seconds:.1f} s; "
          f"{len(regs)} instantiations, registers max {max(regs, default=0)}, "
          f"spill stores max {max(spills, default=0)} bytes")
    resources = kernel_resources(cuda_lib.LIBRARY.build_log)
    print_resources(resources)
    report.update(device=kind, nvidia_smi=smi, build_seconds=cuda_lib.LIBRARY.build_seconds,
                  max_registers=max(regs, default=0), max_spill_bytes=max(spills, default=0),
                  kernel_resources=resources)

    seconds = report["phase_seconds"] = {}
    clock = [time.perf_counter(), None]

    def phase(name: str, title: str) -> None:
        """Close the running phase (print and keep its wall seconds) and
        open ``name``."""
        now = time.perf_counter()
        if clock[1] is not None:
            seconds[clock[1]] = now - clock[0]
            print(f"    ({clock[1]}: {now - clock[0]:.1f} s)")
        clock[:] = [now, name]
        if name:
            print(f"[{name}] {title}")

    seconds["1"] = time.perf_counter() - t_start
    gen = torch.Generator(device=DEVICE).manual_seed(args.seed)
    phase("2", "kernels against their plain versions")
    worst = check_kernels(gen, report)
    check_trunk_kernels(gen, report, worst)
    # the edge checks draw from their own generator: the later phases keep
    # the inputs of the runs before them
    check_edge_shapes(torch.Generator(device=DEVICE).manual_seed(args.seed + 1), report,
                      worst)
    phase("2c", "K5 jet_attention_scores against its plain version")
    check_scores_kernel(gen, report, worst)
    # like phase 2's edges, from their own generator
    check_scores_edges(torch.Generator(device=DEVICE).manual_seed(args.seed + 2), report,
                       worst)
    phase("2d", "K5's path: the memory rows of memory_scaling._attention_rows "
                "(order 2, B 2, H 2, Dh 8, Dm 16, f32) through the public ops")
    memory_launches = memory_rows(gen, report)
    phase("2e", f"K1-K5 past the templates (orders {HIGH_ORDERS}, f64 and f32), on bfloat16, "
                f"and the largest order each admits")
    # from their own generator, like the edges: the later phases keep their inputs
    check_high_orders(torch.Generator(device=DEVICE).manual_seed(args.seed + 3), report,
                      worst)
    check_runtime_attention(torch.Generator(device=DEVICE).manual_seed(args.seed + 7), report,
                            worst)
    check_runtime_scores(torch.Generator(device=DEVICE).manual_seed(args.seed + 8), report,
                         worst)
    check_admitted_orders(torch.Generator(device=DEVICE).manual_seed(args.seed + 3), report)

    net = DenseMLP(d_in=2, width=32, depth=3, d_out=1, activation="tanh")
    params = net.init(torch.Generator().manual_seed(args.seed), dtype=torch.float64)
    phase("3a", "served main path: pinn-pde DenseMLP(2, 32, 3, 1, tanh) f64, ntp/cuda")
    launches = serve_main_path(net, params, gen, report)
    trunk = Transformer(**TRUNK)
    trunk_params = trunk.init(torch.Generator().manual_seed(args.seed),
                              dtype=torch.float64)
    phase("3b", "served main path: pinn-pde Transformer(2, 32, 3, 1, 2 heads, "
                "mlp_ratio 2, tanh) f64, ntp/cuda")
    trunk_launches = serve_trunk(trunk, trunk_params, gen, report)
    new_paths, gen3 = {}, torch.Generator(device=DEVICE).manual_seed(args.seed + 4)
    for label, (kwargs, per_call) in PDE_NETS.items():
        pde_net = make_network(label, activation="tanh", **kwargs)
        phase(f"3{'c' if label == 'residual' else 'd'}",
              f"served: pinn-pde {type(pde_net).__name__}({kwargs}) f64, ntp/cuda")
        pde_params = pde_net.init(torch.Generator().manual_seed(args.seed),
                                  dtype=torch.float64)
        new_paths[f"{label}_mlp"] = serve_network(label, pde_net, pde_params, PDE_REQUESTS,
                                                  per_call, PDE_AUTODIFF_SIZES, gen3, report)
    phase("3e", f"served: pinn-pde DenseMLP grid({DENSE_GRID_ORDER}) f64, ntp/cuda (N1 = "
                f"{DENSE_GRID_ORDER + 1}: the run-time-order K1)")
    new_paths["dense_grid10"] = serve_network("dense_grid10", net, params,
                                              (("grid", DENSE_GRID_ORDER),), 4, (), gen3,
                                              report)
    phase("3f", f"served: pinn-pde Transformer grid({TRUNK_GRID_ORDER}) f64, ntp/cuda (N1 = "
                f"{TRUNK_GRID_ORDER + 1}: the run-time-order K1, K3 and K4)")
    new_paths["trunk_grid10"] = serve_trunk(
        trunk, trunk_params, torch.Generator(device=DEVICE).manual_seed(args.seed + 6), report,
        (("grid", TRUNK_GRID_ORDER),), (), "trunk_grid10", TRUNK_RT_LAUNCHERS)
    phase("3g", f"the Taylor-mode oracle (engine \"jet\") on the card against the ntp/cuda "
                f"tables of 3a, 3e and 3f at {ORACLE_ROWS} rows")
    # from its own generator: the later phases keep their inputs
    new_paths["oracle_check"] = check_oracle(
        net, params, trunk, trunk_params,
        torch.Generator(device=DEVICE).manual_seed(args.seed + 9), report)

    phase("4", "times (CUDA events, warm L2, back-to-back device work)")
    times = time_kernels(net, params, gen, report)
    time_server(net, params, gen, report)
    # the DenseMLP served past the templates (phase 3e's request)
    time_server(net, params, gen, report, (("grid", DENSE_GRID_ORDER),))
    trunk_times = time_trunk_kernels(gen, report)
    time_trunk_server(trunk, trunk_params, gen, report)
    # the trunk served past the templates (phase 3f's request)
    time_trunk_server(trunk, trunk_params, gen, report, (("grid", TRUNK_GRID_ORDER),))
    scores_times = time_scores_kernel(gen, report)
    other = load_other_kernels(args.against) if args.against else None
    trace_trunk_call(trunk, trunk_params, gen, report, other)
    trace_trunk_call(trunk, trunk_params, gen, report, other, ("grid", TRUNK_GRID_ORDER))

    phase("5", f"Burgers training, pinn-mlp (3 x 24 tanh) f64, 512 + 128 points, "
               f"k: (Adam, L-BFGS) {BURGERS_STEPS}, ntp/cuda vs ntp")
    with ShapeRecorder() as shapes:
        burgers_launches = train_burgers(args.seed, report)
        phase("6", f"operator training, pinn-pde, n_domain 1024: {OPERATOR_ADAM} Adam "
                   f"steps, ntp/cuda vs ntp")
        operator_launches = train_operators(args.seed, report)
    phase("6b", f"data parallel on one card: NCCL at world size 1 ({DP_ADAM} Adam + "
                f"{DP_LBFGS} L-BFGS, bit for bit), then two gloo ranks sharing the card")
    new_paths.update(data_parallel(args.seed, report))
    phase("6c", f"train -> checkpoint -> serve: heat on the pinn-pde DenseMLP, the trunk's "
                f"checkpoint, the Trainer (ckpt_every {CKPT_EVERY}, one failure, preemption), "
                f"examples/torch_serve_operator.py")
    new_paths.update(train_checkpoint_serve(args.seed, report))
    phase("6d", f"the LM substrate: six attention archs reduced (card vs CPU, prefill + "
                f"decode, blocked attention), {LM_FULL} at full width: f32 decode, bf16 "
                f"serving, the f64 jet regularizer, bf16 Sobolev training")
    new_paths.update(lm_full_width(args.seed, report))
    phase("6e", "the LM substrate's five other attention archs at their published widths: "
                "bf16 served, prefill + decode against the full forward at f64 and f32")
    new_paths.update(lm_wide_archs(args.seed, report))
    phase("6f", f"the LM path traced: a decode step and a training step with the penalty, "
                f"{LM_FULL} bf16")
    new_paths.update(lm_traces(args.seed, report))
    phase("6g", "the LM substrate's recurrent and MoE half (zamba2, rwkv6, mixtral, llama4): "
                "reduced card vs CPU, bf16 served at published widths, f64 decode checks, "
                "bf16 training")
    new_paths.update(lm_recurrent_moe(args.seed, report))
    phase("6h", "the LM substrate's sharding half on a (1, 1) mesh under NCCL: qwen3 "
                "trained, rwkv6 decoded and llama4 prefilled by the step builders against "
                "the unsharded path, an elastic restore, the production plan")
    new_paths.update(lm_sharding(args.seed, report))
    phase("6i", "the dry run and its roofline: the repaired fault cells on fake production "
                "meshes (torch on the card), op_static and the roofline calibrated on qwen3's "
                "step")
    new_paths.update(lm_dryrun(args.seed, report))
    phase("7", "K1 jet_dense at the shapes the training phases launched it")
    training_times = time_training_shapes(shapes.counts, gen, report)
    phase("7b", "the run-time-order kernels: K1 at the Burgers k = 4 shapes, K1-K5 at "
                "orders 10 and 16 and on bfloat16")
    runtime_times = time_new_instantiations(
        torch.Generator(device=DEVICE).manual_seed(args.seed + 5), report, trunk, trunk_params)
    if other is not None:
        phase("8", f"K1-K5 of {args.against} (other) against this tree's, in turns, and "
                   f"the engine calls of phases 3e and 3f")
        compare_turns(other, gen, report)
        engine_turns(other, net, params, gen, report)
        trunk_engine_turns(other, trunk, trunk_params, gen, report)
    phase("", "")

    paths = {"dense_mlp": launches, "transformer": trunk_launches,
             "scores_memory": memory_launches, **burgers_launches,
             "operator_training": operator_launches, **new_paths}

    def by_path(name):
        return {path: counts[name] for path, counts in paths.items()}

    t = times["cross512"]
    other_shapes = {
        "jet_dense": dict(
            {f"{label} ({', '.join(map(str, times[label]['shape']))})x(32, 32) tanh "
             f"torch.float64": {f: times[label]["jet_dense"][f]
                                for f in ("ms", "plain_ms", "bound_ms", "bound_by")}
             for label in ("grid512", "trunk_cross512")},
            **{key: {f: v[f] for f in ("ms", "plain_ms", "bound_ms", "bound_by",
                                       "launches_in_training")}
               for key, v in training_times.items()}),
        "act_jet": {f"grid512 ({', '.join(map(str, times['grid512']['shape']))}) tanh "
                    f"torch.float64": {f: times["grid512"]["act_jet"][f]
                                       for f in ("ms", "plain_ms", "bound_ms", "bound_by")}},
        "jet_flash_attention": {
            "memory row (3, 2, 2, 1024, 8)x(2, 8, 16) torch.float32": {
                f: trunk_times["jet_flash_attention_memory_row"][f]
                for f in ("ms", "plain_ms", "bound_ms", "bound_by")}},
        "jet_rms_norm": {}}
    kernels = []
    for name, source, replaces in (
            ("jet_dense", "src/repro_torch/kernels/csrc/jet_dense.cu",
             "src/repro/kernels/jet_dense.py:82"),
            ("act_jet", "src/repro_torch/kernels/csrc/act_jet.cu",
             "src/repro/kernels/tanh_jet.py:96")):
        k = t[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(by_path(name).values()),
            "launches_by_path": by_path(name),
            "max_abs_err": max(worst[name], k["max_abs_err"]),
            "ms": k["ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"], "library_ms": None,
            "gemm_only_ms": k.get("gemm_only_ms"), "host_ms": k["host_ms"],
            "shape": t["shape"], "dtype": t["dtype"], "other_shapes": other_shapes[name]})
    for name, source, replaces in (
            ("jet_rms_norm", "src/repro_torch/kernels/csrc/jet_rms_norm.cu",
             "src/repro/kernels/jet_attention.py:393"),
            ("jet_flash_attention",
             "src/repro_torch/kernels/csrc/jet_flash_attention.cu",
             "src/repro/kernels/jet_attention.py:315")):
        k = trunk_times[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(by_path(name).values()),
            "launches_by_path": by_path(name),
            "max_abs_err": max(worst[name], k["max_abs_err"]),
            "ms": k["ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"], "library_ms": None,
            "library_order0_ms": k["library_order0_ms"],
            "library_order0_call": k["library_order0_call"],
            "host_ms": k["host_ms"], "shape": k["shape"], "dtype": k["dtype"],
            "other_shapes": other_shapes[name]})
    k = scores_times[scores_key(SCORES_TIMED[-1], SCORES_TIMED_ORDERS[0])]
    kernels.append({
        "name": "jet_attention_scores", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/jet_attention_scores.cu",
        "replaces": "src/repro/kernels/jet_attention.py:118",
        "launches": sum(by_path("jet_attention_scores").values()),
        "launches_by_path": by_path("jet_attention_scores"),
        "max_abs_err": max(worst["jet_attention_scores"], k["max_abs_err"]),
        "ms": k["ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
        "bound_by": k["bound_by"], "library_ms": None,
        "library_order0_ms": k["library_order0_ms"],
        "library_order0_call": "torch.softmax(scale * q_0 @ k_0^T) on c_0",
        "host_ms": k["host_ms"], "shape": k["shape"], "dtype": k["dtype"],
        "other_shapes": {key: {f: v[f] for f in ("ms", "plain_ms", "bound_ms",
                                                  "bound_by", "library_order0_ms")}
                         for key, v in scores_times.items()}})
    for k in kernels:      # the run-time-order kernel of each (phase 7b)
        k["runtime_shapes"] = {label: {f: v[f] for f in ("ms", "plain_ms", "bound_ms",
                                                          "bound_by", "gemm_only_ms",
                                                          "library_order0_ms")
                                       if f in v}
                               for label, v in runtime_times.get(k["name"], {}).items()}
    report["kernels"] = kernels
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1, default=str))

    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke: FAIL: {exc}", file=sys.stderr)
        sys.exit(1)
