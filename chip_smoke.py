#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check what it computes.

    python3 chip_smoke.py

Run from the root of the repository on a machine with a CUDA card and
nvcc. Phases, in order; any failure exits non-zero and nothing falls
back (a mesh run whose losses miss is reported at once and fails the
run after the kernels line, so the phases after it still run):

1. device: the card as ``nvidia-smi`` reports it (name, power limit);
2. build: every kernel of ``kubernetes_tpu_torch/csrc`` with nvcc;
   node: the node layer on every card. The NVML probe and the runtime
   hook built with g++; the probe's cards (name, UUID, memory) against a
   ``torch.cuda`` probe and this process's; the GPU device plugin
   advertising that many chips, served on a socket and read back with
   the port's client (``ListAndWatch``, ``AdmitPod``, ``InitContainer``)
   where ``grpc`` imports, else a line that says why not; then for each
   GPU the hook's device nodes on ``/dev`` and the vector-add payload
   (``python -m kubernetes_tpu_torch.workloads.vector_add``) under that
   GPU's ``InitContainer`` env: it must launch K1 and see the GPU of
   that UUID as its ``cuda:0``. The probe, the plugin's start and each
   payload run are timed by the wall clock;
3. vector_add: the kernel against plain ``x + y``, bit for bit, in f32
   and bf16 at lengths around its 16-byte vectors and their ragged tail
   (1 to 2^26) and on views at odd offsets (``x[1:]`` with ``y[1:]``
   and with ``y[2:]``); then at n = 2^16 and 2^26 in both dtypes, timed
   beside ``torch.add``: device time by CUDA events, in turns, and
   ``host_us``, the host time per call over back-to-back calls read
   before the closing synchronize;
4. host_path: the host cost of each piece of a K1 launch at the payload
   size (the checks, the allocation, the stream, the ctypes call with
   and without a launch) beside ``torch.add``'s;
5. flash_attn: the causal bf16 instances (the LM's), forward and
   backward, at the listed shapes (ragged tails, the edges of the
   kernels' tiles and TMA boxes at every head dim 16 to 128, many heads
   and a batch, the trainer's default LM, the main path's shapes): o and
   lse against plain attention, each gradient under a drift gate against
   an f32 backward, each launch counted; timed at the main shapes and the
   trainer's D-16 shape beside PyTorch's SDPA pinned to each backend
   that takes the inputs (flash, cuDNN, efficient) as a yardstick, with
   the wrapper's ``host_us``;
6. ring_kernels: the same for the non-causal instances with f32
   outputs (the ring's blocks before their queries) at every head dim
   and T at the tile and TMA edges (1 to 1000), timed at the 600M LM's
   t8k blocks at sp = 2 and 4 (B1 H16 T4096 and T2048, D128) beside SDPA
   with ``is_causal=False``;
   causal_f32: the same for the causal instances with f32 outputs (the
   ring's diagonal blocks) at B1 H16 T4096 D128, timed;
   head_dims: every instance (causal or not, bf16 or f32 out), forward
   and backward, at head dims that are no tile's width (8, 24, 25, 40,
   48, 80, 96, 112, 136, 144, 200, 250; 25 and 250 through the padded
   copy), at the W-256 tile's 256 and over it (264, 272, 384, 512: the
   wide kernels of ``csrc/flash_attn_wide.cu``), T 1, 127, 129, 257,
   under the same tolerances and drift gate, each launch counted; the
   wide kernels' f32 instances at head dims 136, 200, 256 and T 127,
   1000 under the f32 rule of attn_f32; f64, f16 and mixed dtypes at
   head dim 272 raise ``TypeError``; the padded copy of D 25 timed
   against D 32; then Phi-3-mini's attention (B4 H32 T2048 D96,
   causal), GPT-J-6B's (B4 H16 T2048 D256, causal) and the wide
   kernels' (B4 H16 T2048 at D272 in bf16 and D256 in f32, causal)
   gated and timed beside SDPA, the bounds at the true head dim;
   attn_f32: the f32 instances (q, k, v, dO in f32), forward and
   backward, causal and not, at head dims 16, 24, 48, 96, 128 and T 127,
   1000, each output against an f64 plain version within 1/256 of the
   bf16 instance's deviation on the bf16 rounding of the same inputs,
   each launch counted; f64, f16 and mixed dtypes raise ``TypeError``;
   then the 600M LM's attention in
   f32 (B4 H16 T2048 D128, causal) and its t8k ring block (B1 H16 T4096,
   non-causal) gated the same way and timed beside SDPA with TF32 off,
   bound at the TF32 tensor rate;
   ring_loopback: the 600M LM's attention at t8k (B1 H16 T8192 D128)
   split into sp = 2 and 4 blocks, and the same shape at head dim 96
   split in two, forward and backward through the ring's block code and
   f32 merge on one card, counted (sp(sp+1)/2 launches each way,
   sp(sp-1)/2 non-causal); o, lse, dq, dk, dv under the drift gate
   against f32 attention of the whole sequence; the whole ring's time
   and each rank's share;
   ring_loopback_f32: the same t8k attention in f32 at sp = 2 and 4
   through the f32 instances, and at head dim 256 at sp = 2 through the
   wide kernels' f32 instances, counted, each output against f64
   attention of the whole sequence within 1/256 of the bf16 ring's
   deviation;
7. entry: the tiny entry-point forward (the reference's default
   attention, the ring, at sp = 1) on the card against the CPU;
   mnist: the MNIST payload (plain PyTorch ops) on the card, 40 Adam
   steps: held-out accuracy over 0.85 and within 1e-2 of the CPU's run
   of the same seed;
   dryrun: ``entry.dryrun_multichip`` on every card and, with three
   cards or more, on the first three (head dim 48; each rank a process
   over NCCL): one dense step over ``default_axis_sizes(n)`` and one MoE
   step, every rank counted, the losses finite, positive and the same on
   every rank; dryrun_odd: the dense configs of 3, 6, 9, 15 and 17
   devices (head dims 48, 24, 144, 240 and 272, the last on the wide
   kernels) at a 1-device layout on the card, one counted step each
   within 1e-3 of the CPU's;
8. main path (serving): the payload ``smoke_test`` and the 600M-config
   LM forward (d_model 2048, 8 layers, 16 heads of 128, d_ff 8192, vocab
   32768, bf16 params, random weights from a seed) at the t2k and t8k
   cases, with every launch counter set to 0 just before and read just
   after; then its logits against the plain-attention forward and an
   f32 forward, and its time, tokens/s and MFU;
9. train (training path): the 600M train step (forward, backward through
   both attention kernels under remat, AdamW against an f32 master) at
   t2k and t8k, then the train bench's ring cases (t512, t1k, and t2k
   with f32 params) at sp = 1, every counter set to 0 just before one
   step and read just after; its time, tokens/s, MFU and peak memory,
   and the loss over 10 steps, which must fall;
10. train_grads: at full width but 2 layers (t2k), every gradient of the
   kernel path against an f32 plain-attention step, no further from it
   than the plain bf16 step's gradients are; then the f32 kernel path
   (f32 params and compute, the ring at sp = 1): its logits and every
   gradient within 1/256 of the bf16 kernel path's largest deviation
   from that f32 step;
11. train_loop: ``lm.train`` on the card at the entry config with
   checkpoints every 2 steps, 4 steps then a resume to 6, the marker and
   the metrics report;
   lm_f32: the 600M LM in f32 params and compute (TF32 off), B4 T2048:
   the forward with the default ring (sp = 1) and with ``"flash"``, each
   counted (8 f32 launches) and its loss within 1e-4 of plain f32
   attention's; 3 train steps through the ring, counted (16 forward and 8
   backward f32 launches a step), step 1 within 1e-4 of the plain f32
   step, every step within 1e-4 of the same steps with plain attention
   in f64, or within twice the plain f32 steps' distance from them where
   that is more (``f32_steps_rule``); the same steps with one-pass TF32
   attention must fail that rule (its power); forward and step ms,
   tokens/s, MFU against the bf16 peak, peak memory;
   phi3: the LM at Phi-3-mini's published widths (d_model 3072, 32 heads
   of 96, d_ff 8192, vocab 32064; random weights from a seed): the
   forward at 32 layers, bf16 params, B4 T2048, counted, its logits
   under the drift gate against the plain and f32 forwards, its ms,
   tokens/s, MFU and peak memory; at 16 layers (the depth cut) every
   gradient under the drift gate, then 3 train steps (f32 master,
   AdamW), the first counted, the loss falling, step ms, tokens/s, MFU
   and peak memory;
   gptj: the same at GPT-J-6B's published widths (d_model 4096, 16
   heads of 256, d_ff 16384, vocab 50400) in the reference LM's block:
   the forward at 28 layers, the gradients and 3 train steps at 6 (the
   depth cut), on the kernels' W-256 instances;
   gptj_f32: the same widths in f32 params and compute (TF32 off), head
   dim 256 on the wide kernels' f32 instances: the forward at 28 layers,
   counted (one wide f32 launch a layer), its loss within 1e-4 of plain
   f32 attention's; 3 train steps at 6 layers, counted, under
   ``f32_steps_rule`` against plain f32 and f64 attention; forward and
   step ms, tokens/s, MFU against the bf16 peak, peak memory;
12. trainer (the TrainJob worker payload): ``trainer.main()`` in this
   process as a one-rank gang, ``MODEL=lm`` at the 600M width and depth
   (f32 params, as the reference trainer's), B4 T2048, 3 steps, every
   counter set to 0 just before and read just after (16 forward and 8
   backward attention launches a step); its loss against a direct
   ``lm.train`` call, its attempt record, and its step time, tokens/s,
   MFU (from the metrics report of its last step) and peak memory;
13. trainer_group: ``lm.train`` at full width, 2 layers, t2k, 6 steps,
   without a process group and under a world-1 NCCL group on a store of
   its own (the gradient all-reduce through NCCL on CUDA tensors): the
   same loss at every step, and the step times of both;
14. trainer_resume: two ``python -m kubernetes_tpu_torch.workloads.
   trainer`` processes at full width, 2 layers, on one checkpoint dir
   (4 steps saving every 2, then to 6): the attempt records, the marker
   and the ``TRAINER DONE`` lines; then the time of one save and one
   resume of that state in this process;
   trainer_default_lm: ``trainer.main()`` under the env that the
   reference controller writes into a TrainJob pod, ``MODEL=lm`` and no
   ``LM_*`` (a 32-wide LM of 2 heads, head dim 16, 2 layers), B4 T16, 4
   steps through the flash kernels, every counter set to 0 just before
   and read just after; its loss must fall and follow, step by step, the
   same trainer with plain attention (``LM_ATTN=local``);
   trainer_lm_d96: the same with ``LM_D_MODEL=192 LM_HEADS=2`` (head dim
   96), counted, its loss within 1e-3 of ``lm.train``'s in-process at
   every step, the plain-attention trainer's beside it;
15. demo: ``python -m kubernetes_tpu_torch.workloads.distributed_demo``
   on the card, 6 steps, and its exact final value;
16. trainer_dp2: with two cards or more, two rank processes over NCCL,
   one card each, at full width, 2 layers, 6 steps: each step's loss the
   same on both ranks and within 5e-2 of the world-1 run's, and their
   step times; with one card, a line that says it was not run;
   lm_sp: with two cards or more, the 600M LM (bf16 params, f32 master,
   the ring) sequence-parallel over NCCL, one rank process per card:
   sp = 2 at full depth, B1 T8192, 3 steps; with four cards also sp = 4
   and dp = 2 x sp = 2 at 2 layers. Every rank counted (rank i launches
   i + 1 blocks a ring call, i of them non-causal); the losses the same
   on every rank and held by the mesh gate (``mesh_gate``): the bf16
   mesh within 1e-3 relative of one card's bf16 step at step 1; an f32
   witness (the mesh in f32 with the ring's plain version) within 1e-4
   of one card's f32 steps at every step; after step 1 the bf16 mesh no
   further from one card's f32 step than twice the larger distance from
   it of one card's two bf16 paths (the flash kernels, plain attention);
   beside the gate, the mesh's f32 steps through the real ring (the f32
   instances), counted, within 2e-5 of one card's f32 steps through the
   kernels at steps 1 and 2 (the same attention arithmetic, so the
   reading sees the layout alone) and at every step within
   ``f32_steps_rule`` (lm_f32's rule) against one card's plain f32 and
   f64 steps; step ms,
   tokens/s, MFU and peak memory per card; each rank's attention time
   and one K/V rotation's, and how much of the rotations the kernels
   hide. With one card, a line that says it was
   not run: ring_loopback has held the ring's arithmetic on that card;
   lm_fsdp_tp: with two cards or more, the 600M LM at full width and
   depth, B4 T2048, params sharded over fsdp and heads and FFN columns
   over tp: fsdp = 2 and tp = 2; with four cards also fsdp = 2 x tp = 2
   and sp = 2 x tp = 2. Every rank counted; the losses under the mesh
   gate and the f32 steps through the ring beside it, as lm_sp's; step
   ms, tokens/s and MFU per card, peak memory per card and
   each rank's collectives per layer (the fsdp gather, the tp pair's
   all-reduces). With one card, a line that says it was not run;
   moe (the MoE, ``workloads/moe.py``, on one card): the reference's
   ``MoEConfig()`` at B4 T512 (head dim 32), its forward counted and
   held layer by layer (``perf/gates.moe_layer_gate``: each layer given
   the same input in the flash, plain bf16 and f32 paths; the drift gate
   on the tokens whose routing agrees in all three, at most 1% of tokens
   with another top-k set) against the plain paths on the CPU, its loss
   within 1e-2 of the CPU's; then the 600M bench widths with 4 experts,
   top-2 (f32 params, bf16 compute) at B4 T2048: the forward counted
   (8 launches), timed and gated layer by layer on the card, its loss
   within 1e-2 of the plain-attention forward's; 5 train steps on one
   batch, the first counted (16 forward and 8 backward launches), the
   loss falling; step ms, tokens/s, the einsums' FLOPs and TFLOP/s, peak
   memory;
   moe_f32: ``MoEConfig()`` in f32 compute (head dim 32) at B4 T512: the
   forward counted (one f32 launch a layer), each layer's output and
   attention through the f32 instances within 1/256 of the bf16 kernel
   path's deviation from plain f32 attention (the layer gate), the loss
   and one counted step's loss within 1e-4 of plain f32 attention's;
   then the 600M-width MoE (head dim 128) in f32 at B4 T2048, 3 train
   steps through the kernels, counted, against the same steps with
   plain f32 and f64 attention: within ``f32_steps_rule`` and within
   1e-4 of plain f32 at every step;
   moe_ep: with two cards or more, that MoE expert-parallel over NCCL,
   one rank process per card: ep = 2 at full depth; with four cards also
   ep = 2 x sp = 2, dp = 2 x ep = 2 and ep = 2 x tp = 2 at 2 layers.
   Every rank counted; the losses the same on every rank and under the
   mesh gate, the f32 steps through the ring beside it, as lm_sp's. Step
   ms and peak memory per card, each rank's exchange
   time per layer and the f32 steps' seconds. With one card, a line that
   says it was not run;
17. vector_add_device_us: ``device_us`` of K1 and of ``torch.add`` at
   the timed cases, from ``torch.profiler`` (CUPTI) kernel events; then
   f32_passes_device_us: the same events' mean time of each kernel that
   the f32 forward and backward launch at B4 H16 T2048 D128 causal, the
   operands' pre-pass apart from the attention kernels; last, so that
   nothing is timed after the profiler ran;
18. a ``kernels`` line, then the card line, then the last line
   ``{"ok": true, "device": {...}}``.

Every subprocess is waited on with a timeout and killed at it.
"""
from __future__ import annotations

import asyncio
import contextlib
import ctypes
import dataclasses
import importlib.util
import json
import math
import os
import re
import shutil
import socket
import subprocess
import sys
import tempfile
import time
import types

import torch
import torch.nn.functional as F

from torch import distributed as dist
from torch.autograd import DeviceType
from torch.nn.attention import SDPBackend, sdpa_kernel
from torch.profiler import ProfilerActivity, profile

from kubernetes_tpu_torch import native
from kubernetes_tpu_torch.deviceplugin import gpu_plugin
from kubernetes_tpu_torch.kernels import build
from kubernetes_tpu_torch.node import runtimehook
from kubernetes_tpu_torch.perf import chip_bench
from kubernetes_tpu_torch.perf.gates import (F32_LOSS_RTOL, F32_RULE,
                                             attention_f64, attention_tf32,
                                             drift, f32_rule, f32_steps_rule,
                                             moe_layer_gate, plain64)
from kubernetes_tpu_torch.perf.launch_cost import host_us
from kubernetes_tpu_torch.entry import (dryrun_config, dryrun_inputs,
                                         dryrun_multichip, entry)
from kubernetes_tpu_torch.preemption import read_marker
from kubernetes_tpu_torch.workloads import checkpoint as ckpt
from kubernetes_tpu_torch.workloads import collectives
from kubernetes_tpu_torch.workloads import flash_attention as fa
from kubernetes_tpu_torch.workloads import lm
from kubernetes_tpu_torch.workloads import metrics_reporter
from kubernetes_tpu_torch.workloads import mnist
from kubernetes_tpu_torch.workloads import moe
from kubernetes_tpu_torch.workloads import rendezvous
from kubernetes_tpu_torch.workloads import ring_attention as ra
from kubernetes_tpu_torch.workloads import sharding
from kubernetes_tpu_torch.workloads import trainer
from kubernetes_tpu_torch.workloads import vector_add as va
from kubernetes_tpu_torch.workloads.ring_attention import (
    reference_attention_with_lse)

#: Flash-attention shapes (B, H, T, D): ragged tails and every head dim;
#: T at the edges of the kernels' 64- and 128-row tiles and 64-row TMA
#: boxes at every head dim; many heads and a batch (the grid's y and z
#: axes); then the main path's shapes (the t2k and t8k cases at 16
#: heads), which are also timed.
MAIN_FLASH_SHAPES = [(4, 16, 2048, 128), (1, 16, 8192, 128)]
#: The trainer's default LM (B4 T16, 2 heads of 16): what a TrainJob
#: with no ``LM_*`` env sends the kernels; also timed.
D16_FLASH_SHAPE = (4, 2, 16, 16)
TIMED_FLASH_SHAPES = MAIN_FLASH_SHAPES + [D16_FLASH_SHAPE]
FLASH_SHAPES = ([(2, 4, 65, 32), (1, 2, 1000, 64), (2, 4, 1000, 16)]
                + [(1, 2, t, d) for d in (16, 32, 64, 128)
                   for t in (1, 127, 128, 129, 255, 257)]
                + [(8, 32, 129, 64), (8, 32, 129, 16), D16_FLASH_SHAPE]
                + MAIN_FLASH_SHAPES)
#: SDPA backends timed as the attention kernels' yardstick, each pinned
#: with ``sdpa_kernel``; ``library_ms`` is the fastest that runs.
SDPA_BACKENDS = {"flash": SDPBackend.FLASH_ATTENTION,
                 "cudnn": SDPBackend.CUDNN_ATTENTION,
                 "efficient": SDPBackend.EFFICIENT_ATTENTION}
MAIN_CASES = ("lm-600m-t2k-flash", "lm-600m-t8k-flash")
#: The train bench's ring cases, which the train phase runs at sp = 1.
RING_CASES = ("lm-600m-t512", "lm-600m-t1k", "lm-600m-t2k")
#: The non-causal instances (the ring's blocks before their queries): T
#: at the tile and TMA edges at every head dim, then the 600M LM's t8k
#: blocks at sp = 2 and sp = 4, which are also timed.
RING_TIMED_SHAPES = [(1, 16, 4096, 128), (1, 16, 2048, 128)]
RING_SHAPES = ([(1, 2, t, d) for d in (16, 32, 64, 128)
                for t in (1, 100, 127, 128, 129, 1000)]
               + RING_TIMED_SHAPES)
#: The causal instances with f32 outputs (the ring's diagonal blocks),
#: timed at the t8k block at sp = 2.
CAUSAL_F32_SHAPE = RING_TIMED_SHAPES[0]
#: The loopback ring: the 600M LM's attention at t8k, split sp ways; then
#: the same shape at Phi-3-mini's head dim 96, split in two.
LOOPBACK_SHAPE = (1, 16, 8192, 128)
LOOPBACK_SPS = (2, 4)
LOOPBACK_D96_SHAPE = (1, 16, 8192, 96)
#: The f32 loopback ring at GPT-J-6B's head dim, 256, split in two: the
#: wide kernels' f32 instances, causal and not.
LOOPBACK_F32_D256_SHAPE = (1, 16, 8192, 256)
#: Head dims that are no tile's width (8 to 250; 25 and 250 not
#: multiples of 8, so through the padded copy), the W-256 tile's own 256,
#: and bf16 head dims over it (264, 272, 384, 512: the wide kernels), at
#: T over the tile and TMA edges: every instance of both kernels against
#: its plain version.
HEAD_DIMS = (8, 24, 25, 40, 48, 80, 96, 112, 136, 144, 200, 250, 256, 264,
             272, 384, 512)
HEAD_DIM_TS = (1, 127, 129, 257)
#: f32 head dims over one f32 tile (128): the wide kernels' f32
#: instances, at ATTN_F32_TS, under the f32 rule.
F32_WIDE_HEAD_DIMS = (136, 200, 256)
#: A head dim only the wide kernels take, where the dtypes they refuse
#: are tried.
WIDE_REFUSAL_HEAD_DIM = 272
#: The wide kernels timed: bf16 at the dryrun's 272 and f32 at GPT-J-6B's
#: 256, both at GPT-J-6B's attention shape otherwise (B4 H16 T2048); and
#: bf16 at 512, the deepest column-group plan timed (two groups of 4
#: boxes in every kernel).
WIDE_ATTN_SHAPE = (4, 16, 2048, 272)
WIDE_F32_ATTN_SHAPE = (4, 16, 2048, 256)
WIDE_512_ATTN_SHAPE = (4, 16, 2048, 512)
#: Phi-3-mini's attention at its serving and training shape (B4 T2048,
#: 32 heads of 96): the kernels line's D-96 rows.
PHI3_ATTN_SHAPE = (4, 32, 2048, 96)
#: Phi-3-mini's published widths (microsoft/Phi-3-mini-4k-instruct,
#: config.json: hidden_size 3072, 32 attention and 32 KV heads,
#: intermediate_size 8192, vocab_size 32064, 32 layers, rope_theta 10000,
#: SwiGLU, RMSNorm), inheriting the reference LM's tied unembed and RoPE
#: on interleaved pairs; served at full depth and trained at
#: PHI3_TRAIN_LAYERS.
PHI3 = dict(vocab=32064, d_model=3072, n_layers=32, n_heads=32, d_ff=8192)
PHI3_TRAIN_LAYERS = 16
#: The published-width phases (phi3, gptj): served and trained at
#: PUBLISHED_BATCH (B, T), PUBLISHED_STEPS train steps on one batch.
PUBLISHED_BATCH = (4, 2048)
PUBLISHED_STEPS = 3
#: GPT-J-6B's attention at its serving and training shape (B4 T2048, 16
#: heads of 256): the kernels line's D-256 rows.
GPTJ_ATTN_SHAPE = (4, 16, 2048, 256)
#: GPT-J-6B's published widths (EleutherAI/gpt-j-6b, config.json: n_embd
#: 4096, n_head 16, n_layer 28, n_inner null so 4 x 4096, vocab_size
#: 50400, n_positions 2048) in the reference LM's block: RMSNorm, SwiGLU,
#: tied unembed, RoPE on interleaved pairs over the whole head (not
#: GPT-J's rotary_dim 64, parallel residual, GELU and untied head).
#: Served at full depth, trained at GPTJ_TRAIN_LAYERS (the f32 master
#: and AdamW moments of its 1.82 G params take ~22 GB).
GPTJ = dict(vocab=50400, d_model=4096, n_layers=28, n_heads=16, d_ff=16384)
GPTJ_TRAIN_LAYERS = 6
#: Device counts with an odd factor whose dense dryrun config steps on
#: one card at a 1-device layout: head dim 48 at 3, 24 at 6, 144 at 9,
#: 240 at 15 and 272 at 17, the wide kernels' (dp = n alone, d_model 32 n
#: over 2 heads).
DRYRUN_ODD = (3, 6, 9, 15, 17)
#: Train steps of each lm_sp run.
LM_SP_STEPS = 3
#: The f32 ring reading (:func:`f32_ring_reading`) holds a mesh's first
#: RING_F32_STEPS f32 steps within RING_F32_RTOL relative of one card's
#: f32 steps through the kernels. The bound lies between the readings of
#: sound meshes at those steps (at most 6.5e-6 on four H100s) and of a
#: ring that rounds each block's lse to bf16 (6.9e-5 at sp 4, step 2).
#: Later steps carry f32's own rounding through AdamW (one card's f32
#: paths spread 1.3-2.3e-4 at step 3 of lm_sp's sp 2), so there the
#: reading holds the mesh to ``f32_steps_rule`` alone.
RING_F32_STEPS, RING_F32_RTOL = 2, 2e-5
#: o against the plain version: both round o to bf16 and the kernel also
#: rounds P to bf16 for the tensor cores, so allow two bf16 steps of |o|
#: (2^-6) plus an absolute 1e-2 for outputs near 0.
O_ATOL, O_RTOL = 1e-2, 2 ** -6
#: lse is f32 in both; only the order of the sums differs.
LSE_ATOL = 1e-3
#: f32 arithmetic outside the tensor cores, H100 SXM (the vector add).
F32_FLOPS = 67e12
#: Dense TF32 on the tensor cores, H100 SXM (NVIDIA's data sheet): the
#: bound of the f32 attention instances, the rate a user who asks for f32
#: attention would otherwise get from the tensor cores.
TF32_FLOPS = 494.7e12
#: attn_f32: every f32 instance at these head dims and T (not multiples
#: of the tiles), then at ATTN_F32_TIMED, gated and timed: the 600M LM's
#: t2k attention in f32 (causal) and its t8k ring block at sp = 2
#: (non-causal).
ATTN_F32_DIMS = (16, 24, 48, 96, 128)
ATTN_F32_TS = (127, 1000)
ATTN_F32_TIMED = (((4, 16, 2048, 128), True), ((1, 16, 4096, 128), False))
#: Calls of each f32 entry point that :func:`profile_f32_passes` traces.
F32_PASS_CALLS = 10
#: K1 checked bit for bit at (n, x offset, y offset): lengths around one
#: 16-byte vector and its ragged tail, the payload's 2^16 and its
#: neighbours, 2^20 + 3, 2^26; then views at an odd offset, also at two
#: different offsets, which no vector fits. Each in f32 and bf16.
VA_EXACT = ([(n, 0, 0) for n in (1, 3, 4, 5, 1000, 65535, 65536, 65537,
                                 (1 << 20) + 3, 1 << 26)]
            + [(n, xo, yo) for n in (65537, (1 << 20) + 3)
               for xo, yo in ((1, 1), (1, 2))])
#: K1 timed beside torch.add: the payload's n and a size that streams
#: from device memory, in both dtypes; the main path's case first.
VA_TIMED = [(n, dtype) for n in (1 << 16, 1 << 26)
            for dtype in (torch.float32, torch.bfloat16)]
#: Back-to-back calls over which a host time per call is read; for the
#: attention kernels, few enough that their queued work never fills the
#: queue of launches and holds the host back.
HOST_CALLS = 10_000
ATTN_HOST_CALLS = 20
#: Train steps whose loss must fall, on one fixed batch (as the train
#: bench runs); the steps after the first TRAIN_WARM are timed.
TRAIN_STEPS = 10
TRAIN_WARM = 3
#: The trainer's model-size env at the main path's 600M width; the
#: trainer phases run it at full depth or at 2 layers, B4 T2048.
TRAINER_ENV = {"MODEL": "lm", "LM_VOCAB": "32768", "LM_D_MODEL": "2048",
               "LM_LAYERS": "8", "LM_HEADS": "16", "LM_D_FF": "8192",
               "BATCH": "4", "SEQ": "2048"}
#: Steps of the trainer phase.
TRAINER_STEPS = 3
#: Steps of each trainer_group run (five timed after the first) and of
#: the two-card run, which is held against it.
GROUP_STEPS = 6
#: The MoE phase: the reference's MoEConfig() at MOE_SMALL_BATCH (B, T),
#: then ``chip_bench.MOE_WIDTHS`` (the 600M bench widths with
#: MoEConfig's expert defaults) at MOE_BATCH, MOE_STEPS steps on one
#: batch, the steps after the first MOE_WARM timed.
MOE_SMALL_BATCH = (4, 512)
MOE_BATCH = chip_bench.MOE_BATCH
MOE_STEPS = 5
MOE_WARM = 2
#: The whole-forward loss of the kernel path against the plain bf16
#: forward's, relative.
MOE_LOSS_RTOL = 1e-2
#: Train steps of each moe_ep run.
MOE_EP_STEPS = 3
#: Steps of the MNIST payload on the card, and the accuracy it must pass.
MNIST_STEPS = 40
MNIST_ACCURACY = 0.85
#: Seconds any subprocess may take before it is killed and the run fails.
SUBPROCESS_TIMEOUT = 600


def say(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def timed(kernel, plain, libraries: dict, iters: int,
          plain_iters: int = 3, rounds: int = 1) -> dict:
    """Device times of ``kernel`` and of each library call, in turns
    (kernel, libraries, libraries in reverse, kernel), ``rounds`` times,
    each reported as the mean of its runs; ``plain`` timed once after.
    Where the host sets the time, more and shorter rounds keep a drift of
    its clock out of the comparison."""
    k_runs, lib_runs = [], {n: [] for n in libraries}
    for _ in range(rounds):
        k_runs.append(time_ms(kernel, iters))
        for n, f in libraries.items():
            lib_runs[n].append(time_ms(f, iters))
        for n, f in reversed(libraries.items()):
            lib_runs[n].append(time_ms(f, iters))
        k_runs.append(time_ms(kernel, iters))
    lib = {n: sum(r) / len(r) for n, r in lib_runs.items()}
    best = min(lib, key=lib.get) if lib else None
    return {"ms": sum(k_runs) / len(k_runs), "ms_runs": k_runs,
            "plain_ms": time_ms(plain, plain_iters, 1),
            "library_ms": lib[best] if best else None,
            "library": best, "library_ms_by_name": lib,
            "library_runs": lib_runs}


def add_bound(row: dict, flops: float, nbytes: float, name: str,
              peak_ops: float | None = None) -> dict:
    """``bound_ms`` and ``bound_by`` of the work, and the row's
    ``share_of_bound`` (bound over its time) and ``ratio_to_library``
    (its time over the fastest library call's)."""
    row["bound_ms"], row["bound_by"] = bound_ms(flops, nbytes, name, peak_ops)
    row["share_of_bound"] = row["bound_ms"] / row["ms"]
    row["ratio_to_library"] = (row["ms"] / row["library_ms"]
                               if row["library_ms"] else None)
    return row


def sdpa_forwards(q, k, v, causal: bool = True) -> dict:
    """{backend: SDPA forward pinned to it} for each backend that takes
    these inputs."""
    fns = {}
    for name, backend in SDPA_BACKENDS.items():
        def fn(backend=backend):
            with sdpa_kernel(backend):
                return F.scaled_dot_product_attention(q, k, v,
                                                      is_causal=causal)
        try:
            fn()
        except RuntimeError:
            continue
        fns[name] = fn
    return fns


def sdpa_backwards(q, k, v, do, causal: bool = True) -> dict:
    """{backend: SDPA backward of a forward pinned to it} for each
    backend that takes these inputs."""
    fns = {}
    for name, backend in SDPA_BACKENDS.items():
        qs, ks, vs = (x.detach().requires_grad_() for x in (q, k, v))
        try:
            with sdpa_kernel(backend):
                out = F.scaled_dot_product_attention(qs, ks, vs,
                                                     is_causal=causal)
            torch.autograd.grad(out, (qs, ks, vs), do, retain_graph=True)
        except RuntimeError:
            continue
        fns[name] = (lambda out=out, leaves=(qs, ks, vs): torch.autograd.grad(
            out, leaves, do, retain_graph=True))
    return fns


def bound_ms(flops: float, nbytes: float, name: str,
             peak_ops: float | None = None) -> tuple[float, str]:
    """Least time for the work on this card: the larger of operations
    over the peak rate for their type (bf16 tensor cores unless
    ``peak_ops`` is given) and bytes over the memory rate."""
    t_ops = flops / (peak_ops or chip_bench.peak_flops_for(name)[0])
    t_bytes = nbytes / chip_bench.peak_bytes_for(name)[0]
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def _same_uuid(a: str, b: str) -> bool:
    """NVML writes ``GPU-<uuid>``; compare without the prefix."""
    return a.lower().removeprefix("gpu-") == b.lower().removeprefix("gpu-")


def check_node() -> dict:
    """The node layer on this host: every card enumerated by NVML and
    advertised by the device plugin, and the vector-add payload run on
    each under the env that the plugin gives a container of that GPU.
    Returns the payloads' K1 launches."""
    t0 = time.perf_counter()
    native.build("gpu_hook")
    probe_cmd = gpu_plugin.nvml_probe_command()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    probe = gpu_plugin.run_probe(probe_cmd, 60)
    probe_s = time.perf_counter() - t0
    if not (probe and probe.get("gpu") and probe.get("source") == "nvml_probe"):
        raise AssertionError(f"node: the NVML probe answered {probe}")
    t0 = time.perf_counter()
    torch_probe = gpu_plugin.run_probe(gpu_plugin.torch_probe_command(), 120)
    torch_probe_s = time.perf_counter() - t0
    devices = probe["devices"]
    n = len(devices)
    mine = [str(torch.cuda.get_device_properties(i).uuid)
            for i in range(torch.cuda.device_count())]
    if not (torch_probe and torch_probe.get("gpu")
            and len(torch_probe["devices"]) == n == len(mine)
            and all(_same_uuid(d["uuid"], t["uuid"])
                    for d, t in zip(devices, torch_probe["devices"]))
            and sorted(d["uuid"].lower().removeprefix("gpu-")
                       for d in devices) == sorted(mine)):
        raise AssertionError(f"node: NVML's cards {devices} are not torch's "
                             f"{torch_probe} / {mine}")
    cards = [{k: d.get(k) for k in ("index", "kind", "uuid", "minor_number",
                                    "memory")} for d in devices]

    t0 = time.perf_counter()
    plugin = gpu_plugin.GpuDevicePlugin(probe=probe, slice_id="smoke")
    chips = [c.id for c in plugin._topology.chips]
    if chips != [f"gpu-{i}" for i in range(n)] \
            or plugin._topology.mesh_shape != [n, 1, 1]:
        raise AssertionError(f"node: the plugin advertises {chips}, mesh "
                             f"{plugin._topology.mesh_shape}")
    envs = {c: plugin.container_env([c]) for c in chips}
    served = {"skipped": "grpc does not import"}
    if importlib.util.find_spec("grpc") is not None:
        from kubernetes_tpu_torch.deviceplugin.service import (
            DevicePluginClient)
        with tempfile.TemporaryDirectory(prefix="g") as tmp:
            plugin.serve(os.path.join(tmp, "gpu.sock"))
            plugin_start_s = time.perf_counter() - t0
            client = DevicePluginClient(plugin.socket_path)
            try:
                update = next(iter(client.list_and_watch()))
                admit = client.admit_pod("default", "smoke", "u", chips)
                inits = {c: dict(client.init_container(
                    "default", "smoke", "u", "main", [c]).envs)
                    for c in chips}
            finally:
                client.close()
                plugin.stop()
        if [c.id for c in update.chips] != chips or not admit.allowed \
                or inits != envs:
            raise AssertionError(f"node: over gRPC {update}, {admit}, "
                                 f"{inits}")
        served = {"list_and_watch_chips": len(update.chips),
                  "admit_allowed": admit.allowed, "init_container": "ok"}
    else:
        plugin_start_s = time.perf_counter() - t0
    say("node_plugin", chips=len(chips), chip_type=plugin._topology.chip_type,
        served=served)

    # The hook as a node agent runs it, strict: each GPU's node is
    # /dev/nvidia<NVML's minor number>, a character device of NVIDIA's
    # major 195 with that minor, and not the node its index
    # would name.
    hook = runtimehook.GpuRuntimeHook(allow_missing_devices=False)
    pod = types.SimpleNamespace(metadata=types.SimpleNamespace(annotations={}))
    container = types.SimpleNamespace(image="cuda-vector-add",
                                      tpu_requests=["gpu"])
    runs, launches = [], 0
    for i, chip in enumerate(chips):
        minor = devices[i]["minor_number"]
        node = f"/dev/nvidia{minor}"
        env, devs = asyncio.run(hook.run(pod, container, [chip]))
        want = runtimehook.discover([chip], {chip: minor}, "/dev",
                                    allow_missing=False)
        rdev = os.stat(node).st_rdev
        if devs != want or not {node, "/dev/nvidiactl"} <= set(devs) \
                or (i != minor and f"/dev/nvidia{i}" in devs) \
                or (os.major(rdev), os.minor(rdev)) != (195, minor) \
                or env != {"GPU_RUNTIME_HOOK": "native"}:
            raise AssertionError(f"node: hook for {chip} (minor {minor}): "
                                 f"{devs}, {env}, rdev {os.major(rdev)}:"
                                 f"{os.minor(rdev)}")
        t0 = time.perf_counter()
        proc = run_module("kubernetes_tpu_torch.workloads.vector_add",
                          envs[chip])
        wall = time.perf_counter() - t0
        try:
            report = json.loads(proc.stdout.strip().splitlines()[-1])
        except (IndexError, json.JSONDecodeError):
            report = {}
        if proc.returncode != 0 or not report.get("ok") \
                or report.get("platform") != "cuda" \
                or report.get("index") != 0 or report.get("launches", 0) < 1 \
                or not _same_uuid(report.get("uuid", ""),
                                  devices[i]["uuid"]):
            raise AssertionError(f"node: payload on {chip}: exit "
                                 f"{proc.returncode}, {report}: "
                                 f"{_tail(proc)}")
        launches += report["launches"]
        runs.append({"chip": chip, "minor_number": minor, "devices": devs,
                     "wall_s": wall,
                     "sees_its_uuid_as_cuda0": True,
                     "launches": report["launches"]})
    say("node", ok=True, cards=cards, count=n, build_s=build_s,
        nvml_probe_s=probe_s, torch_probe_s=torch_probe_s,
        plugin_start_s=plugin_start_s, payloads=runs)
    return causal_only(vector_add=launches)


def check_vector_add(gen, name: str) -> list[dict]:
    """K1 against plain ``x + y``, bit for bit, at VA_EXACT (lengths and
    offset views); then timed at each VA_TIMED case beside ``torch.add``:
    device time by CUDA events in turns, and host time per call
    (``host_us``) in turns. Returns the timed rows, the main path's
    (2^16 f32) first; ``device_us`` is added by :func:`profile_vector_add`
    at the end of the run."""
    exact = []
    for dtype in (torch.float32, torch.bfloat16):
        for n, x_off, y_off in VA_EXACT:
            x = torch.randn(n + x_off, generator=gen, device="cuda").to(dtype)
            y = torch.randn(n + y_off, generator=gen, device="cuda").to(dtype)
            x, y = x[x_off:], y[y_off:]
            before = va.launches
            out = va.vector_add(x, y)
            torch.cuda.synchronize()
            if va.launches != before + 1:
                raise AssertionError("vector_add did not count its launch")
            if not torch.equal(out, va.vector_add_plain(x, y)):
                raise AssertionError(f"vector_add mismatch at n={n} {dtype} "
                                     f"offsets {x_off}, {y_off}")
            exact.append([n, x_off, y_off, _dtype_name(dtype)])
    results = []
    for n, dtype in VA_TIMED:
        x = torch.randn(n, generator=gen, device="cuda").to(dtype)
        y = torch.randn(n, generator=gen, device="cuda").to(dtype)
        err = float((va.vector_add(x, y).float()
                     - va.vector_add_plain(x, y).float()).abs().max())
        if err != 0.0:
            raise AssertionError(f"vector_add mismatch at n={n} {dtype}")
        row = {"n": n, "dtype": _dtype_name(dtype), "max_abs_err": err}
        # At 2^16 the host sets both times (some 10 us a call against ~1
        # us of device work), so they are taken in many short turns. At
        # 2^26, few enough host calls that the queue of launches never
        # fills and holds the host back.
        small = n <= 1 << 16
        iters, rounds = (200, 10) if small else (50, 1)
        calls, host_rounds = (HOST_CALLS, 4) if small else (200, 1)
        kernel = lambda: va.vector_add(x, y)  # noqa: E731
        library = lambda: torch.add(x, y)  # noqa: E731
        row.update(timed(kernel, lambda: va.vector_add_plain(x, y),
                         {"torch.add": library}, iters, iters, rounds))
        add_bound(row, n, 3 * n * x.element_size(), name, F32_FLOPS)
        k_runs, l_runs = [], []
        for _ in range(host_rounds):
            k_runs.append(host_us(kernel, calls))
            l_runs += [host_us(library, calls), host_us(library, calls)]
            k_runs.append(host_us(kernel, calls))
        row.update(host_us=sum(k_runs) / len(k_runs), host_us_runs=k_runs,
                   library_host_us=sum(l_runs) / len(l_runs),
                   library_host_us_runs=l_runs, host_calls=calls)
        results.append(row)
        del x, y
    say("vector_add", ok=True, exact=exact, results=results)
    return results


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def device_us(fn, calls: int) -> tuple[float, int, list[str]]:
    """Device time per call of ``fn``, which launches one kernel a call:
    the mean duration of the kernel events that a ``torch.profiler``
    (CUPTI) trace of ``calls`` calls shows; also how many it shows and
    their names. CUPTI may miss an event at the edge of the window, so
    the trace must show one kernel name and between one and ``calls``
    events, not exactly ``calls``."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    names = sorted({e.name[:100] for e in kernels})
    if not 1 <= len(kernels) <= calls or len(names) != 1:
        raise AssertionError(f"{len(kernels)} kernel events of {names} "
                             f"for {calls} calls of one kernel")
    total = sum(e.time_range.elapsed_us() for e in kernels)
    return total / len(kernels), len(kernels), names


def profile_vector_add(rows: list[dict]) -> None:
    """``device_us`` of K1 and of ``torch.add`` at each timed row's case,
    from kernel events. Run last: the profiler is the only one in the
    run, so no other phase is timed after it."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    for row in rows:
        n, dtype = row["n"], getattr(torch, row["dtype"])
        x = torch.randn(n, generator=gen, device="cuda").to(dtype)
        y = torch.randn(n, generator=gen, device="cuda").to(dtype)
        calls = 200 if n <= 1 << 16 else 20
        for prefix, fn in (("", lambda: va.vector_add(x, y)),
                           ("library_", lambda: torch.add(x, y))):
            us, seen, names = device_us(fn, calls)
            row[f"{prefix}device_us"] = us
            row[f"{prefix}device_kernel"] = names[0]
            row[f"{prefix}device_events"] = seen
        del x, y
    say("vector_add_device_us", results=[
        {k: row[k] for k in ("n", "dtype", "device_us", "library_device_us",
                             "device_kernel", "library_device_kernel",
                             "device_events", "library_device_events")}
        for row in rows])


def profile_f32_passes() -> None:
    """The device time of each kernel that one f32 attention call
    launches, by kernel name, from ``torch.profiler`` (CUPTI) kernel
    events over F32_PASS_CALLS calls: the pre-pass that writes the fp16
    parts of the operands and each slice's largest |x| apart from the
    attention kernels, forward and backward, at ATTN_F32_TIMED's causal
    t2k shape. Run after :func:`profile_vector_add`, last."""
    shape, causal = ATTN_F32_TIMED[0]
    gen = torch.Generator(device="cuda").manual_seed(3)
    q, k, v, do = (torch.randn(shape, generator=gen, device="cuda")
                   for _ in range(4))
    o, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
    rows = {}
    for name, fn in (
            ("fwd", lambda: fa.flash_attention_fwd(q, k, v, causal=causal)),
            ("bwd", lambda: fa.flash_attention_bwd(q, k, v, o, lse, do,
                                                   causal=causal))):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(F32_PASS_CALLS):
                fn()
            torch.cuda.synchronize()
        us = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                us.setdefault(e.name[:100], []).append(
                    e.time_range.elapsed_us())
        rows[name] = {kernel: {"events": len(t), "mean_us": sum(t) / len(t),
                               "us_per_call": sum(t) / F32_PASS_CALLS}
                      for kernel, t in us.items()}
    say("f32_passes_device_us", shape=list(shape), causal=causal,
        calls=F32_PASS_CALLS, kernels=rows)
    del q, k, v, do, o, lse
    torch.cuda.empty_cache()


def check_host_path() -> None:
    """What a K1 launch costs the host at the payload size, piece by
    piece, by the host clock over HOST_CALLS calls of each piece, every
    piece twice (in order, then in reverse); ``lambda`` is the empty
    call that each number includes."""
    n = 1 << 16
    x, y = (torch.randn(n, device="cuda") for _ in range(2))
    out, x0, y0 = torch.empty_like(x), x[:0], y[:0]
    dev = x.get_device()
    kernel = va.KERNELS[torch.float32]
    stream = build.current_stream(dev)
    xp, yp, op = x.data_ptr(), y.data_ptr(), out.data_ptr()
    pieces = {
        "lambda": lambda: None,
        "torch.add": lambda: torch.add(x, y),
        "vector_add": lambda: va.vector_add(x, y),
        "vector_add_at_n0": lambda: va.vector_add(x0, y0),
        "empty_like": lambda: torch.empty_like(x),
        "data_ptr": lambda: x.data_ptr(),
        "raw_stream": lambda: build.current_stream(dev),
        "stream_object": lambda: torch.cuda.current_stream(dev).cuda_stream,
        "ctypes_call_at_n0": lambda: kernel.launch(xp, yp, op, 0, dev,
                                                   stream),
        "ctypes_call_and_launch": lambda: kernel.launch(xp, yp, op, n, dev,
                                                        stream),
    }
    first = {k: host_us(f, HOST_CALLS) for k, f in pieces.items()}
    second = {k: host_us(f, HOST_CALLS) for k, f in reversed(pieces.items())}
    if not torch.equal(out, x + y):
        raise AssertionError("the bare launch wrote a wrong sum")
    say("host_path", n=n, calls=HOST_CALLS,
        us={k: (first[k] + second[k]) / 2 for k in pieces},
        us_runs={k: [first[k], second[k]] for k in pieces})


def rank_backward(q, held, o, lse, do, i: int, n: int):
    """Rank ``i``'s share of a ring's backward without the rotations:
    its blocks' launches (``held``: the (k, v) it holds after s
    rotations) and the f32 sums of their gradients."""
    acc = [None, None, None]
    for s, (k, v) in enumerate(held):
        part = ra.block_backward(q, k, v, o, lse, do, i, (i - s) % n)
        acc = [ra.accumulate(a, g) for a, g in zip(acc, part or (None,) * 3)]
    return acc


def check_ring_loopback(gen, shape: tuple, sps: tuple) -> dict:
    """Attention at ``shape`` (bf16) split into each of ``sps`` blocks,
    forward and backward through the ring's block code and merge on one
    card (``ring_attention.loopback_*``), counted: sp(sp+1)/2 launches
    each way, sp(sp-1)/2 of them non-causal. o, lse, dq, dk and dv
    against f32 attention of the whole sequence, no further from it than
    the plain bf16 path (2x its largest, 1.5x its mean deviation). Times
    the whole loopback and each rank's share. Returns the launches."""
    b, h, t, d = shape
    x32 = [torch.randn(shape, generator=gen, device="cuda")
           for _ in range(4)]
    q, k, v, do = (x.to(torch.bfloat16) for x in x32)
    o32, lse32 = reference_attention_with_lse(*x32[:3])
    exact = {"o": o32, "lse": lse32, **dict(zip(
        ("dq", "dk", "dv"),
        fa.flash_attention_bwd_plain(*x32[:3], o32, lse32, x32[3])))}
    del x32, o32, lse32
    o_p, lse_p = reference_attention_with_lse(q, k, v)
    plain = {"o": o_p, "lse": lse_p, **dict(zip(
        ("dq", "dk", "dv"),
        fa.flash_attention_bwd_plain(q, k, v, o_p, lse_p, do)))}
    del o_p, lse_p
    torch.cuda.empty_cache()
    total = dict.fromkeys(counters(), 0)
    runs = []
    for sp in sps:
        qs, ks, vs, dos = ([blk.contiguous() for blk in x.chunk(sp, dim=2)]
                           for x in (q, k, v, do))
        torch.cuda.synchronize()
        zero_counters()
        out = ra.loopback_forward(qs, ks, vs)
        os_, lses = [o for o, _ in out], [lse for _, lse in out]
        grads = ra.loopback_backward(qs, ks, vs, os_, lses, dos)
        torch.cuda.synchronize()
        launches = counters()
        n = sp * (sp + 1) // 2
        want = {**dict.fromkeys(launches, 0), "flash_attn_fwd": sp,
                "flash_attn_bwd": sp, "flash_attn_fwd_non_causal": n - sp,
                "flash_attn_bwd_non_causal": n - sp}
        if launches != want:
            raise AssertionError(f"ring_loopback sp={sp}: launches "
                                 f"{launches}, want {want}")
        for key, count in launches.items():
            total[key] += count
        got = {"o": torch.cat(os_, dim=2), "lse": torch.cat(lses, dim=2),
               **{g: torch.cat([r[i] for r in grads], dim=2)
                  for i, g in enumerate(("dq", "dk", "dv"))}}
        del out, grads
        rows = {}
        for key, val in got.items():
            rows[key] = drift(val, plain[key], exact[key].float())
            if not (rows[key]["ok"] and bool(torch.isfinite(val).all())):
                raise AssertionError(f"ring_loopback sp={sp} {key} drifts: "
                                     f"{rows[key]}")
        del got
        fwd_ms = time_ms(lambda: ra.loopback_forward(qs, ks, vs), 5)
        bwd_ms = time_ms(lambda: ra.loopback_backward(qs, ks, vs, os_, lses,
                                                      dos), 5)
        shares = []
        for i in range(sp):
            held = [(ks[(i - s) % sp], vs[(i - s) % sp]) for s in range(sp)]
            shares.append({
                "rank": i,
                "forward_ms": time_ms(
                    lambda: ra.rank_forward(qs[i], held, i, sp), 5),
                "backward_ms": time_ms(
                    lambda: rank_backward(qs[i], held, os_[i], lses[i],
                                          dos[i], i, sp), 5)})
        runs.append({"sp": sp, "block": [b, h, t // sp, d],
                     "launches": launches, "forward_ms": fwd_ms,
                     "backward_ms": bwd_ms, "per_rank": shares, **rows})
        del qs, ks, vs, dos, os_, lses
        torch.cuda.empty_cache()
    say("ring_loopback", ok=True, shape=list(shape), runs=runs)
    del plain, exact
    torch.cuda.empty_cache()
    return total


def loopback(qs, ks, vs, dos) -> dict:
    """The ring's forward and backward over every rank's blocks in one
    process (``ring_attention.loopback_*``), each output whole again:
    o, lse, dq, dk, dv."""
    out = ra.loopback_forward(qs, ks, vs)
    os_, lses = [o for o, _ in out], [lse for _, lse in out]
    grads = ra.loopback_backward(qs, ks, vs, os_, lses, dos)
    return {"o": torch.cat(os_, dim=2), "lse": torch.cat(lses, dim=2),
            **{g: torch.cat([r[i] for r in grads], dim=2)
               for i, g in enumerate(("dq", "dk", "dv"))}}


def check_ring_loopback_f32(gen, shape: tuple, sps: tuple) -> dict:
    """The ring's block arithmetic in f32 on one card: attention at
    ``shape`` (f32) split into each of ``sps`` blocks, forward and
    backward through ``ring_attention.loopback_*``, counted (sp(sp+1)/2
    f32 launches each way, sp(sp-1)/2 of them non-causal); o, lse, dq,
    dk, dv against f64 attention of the whole sequence under
    ``gates.f32_rule``, the bf16 ring on the bf16 rounding of the same
    inputs its yardstick. Times the f32 loopback. Returns the
    launches."""
    x32 = [torch.randn(shape, generator=gen, device="cuda")
           for _ in range(4)]
    exact = plain64(*x32)
    total = dict.fromkeys(counters(), 0)
    runs = []
    for sp in sps:
        blocks = [[blk.contiguous() for blk in x.chunk(sp, dim=2)]
                  for x in x32]
        torch.cuda.synchronize()
        zero_counters()
        got = loopback(*blocks)
        torch.cuda.synchronize()
        launches = counters()
        n = sp * (sp + 1) // 2
        w = wide_infix(x32[0])
        want = causal_only(**{f"flash_attn_fwd{w}_f32": sp,
                              f"flash_attn_bwd{w}_f32": sp,
                              f"flash_attn_fwd{w}_f32_non_causal": n - sp,
                              f"flash_attn_bwd{w}_f32_non_causal": n - sp})
        if launches != want:
            raise AssertionError(f"ring_loopback_f32 sp={sp}: launches "
                                 f"{launches}, want {want}")
        for key, count in launches.items():
            total[key] += count
        bf16 = loopback(*([b.to(torch.bfloat16) for b in bl]
                          for bl in blocks))
        rule = f32_rule(got, bf16, exact)
        del got, bf16
        if not rule.pop("ok"):
            raise AssertionError(f"ring_loopback_f32 sp={sp}: {rule}")
        runs.append({"sp": sp, "block": [shape[0], shape[1],
                                         shape[2] // sp, shape[3]],
                     "launches": launches,
                     "ms": time_ms(lambda: loopback(*blocks), 3), **rule})
        del blocks
        torch.cuda.empty_cache()
    say("ring_loopback_f32", ok=True, shape=list(shape), rule="each output's "
        f"largest deviation from f64 <= {F32_RULE} of the bf16 ring's on the "
        "bf16 rounding of the same inputs", runs=runs)
    del exact, x32
    torch.cuda.empty_cache()
    return total

def wide_infix(q: torch.Tensor) -> str:
    """``"_wide"`` in the instance names of a launch on ``q``'s head dim
    and dtype where one tile of the fused kernels does not hold it (the
    wide kernels), else ``""``."""
    return "" if fa.one_tile(q.shape[-1], q.dtype) else "_wide"


def gate_instance(x32: list, causal: bool, out_dtype) -> tuple[dict, dict]:
    """One launch of each kernel's instance (causal or not, bf16 or f32
    out) on the bf16 rounding of ``x32`` ([q, k, v, do], f32), counted,
    against the plain versions: ``o`` and ``lse`` to the forward's
    tolerances, each gradient under the drift gate against the f32
    backward at the unrounded inputs (at T = 1, dq and dk within O_ATOL,
    as in :func:`check_flash_bwd`). Returns the forward and backward
    rows; raises on a miss."""
    q, k, v, do = (x.to(torch.bfloat16) for x in x32)
    suffix = wide_infix(q) + ("" if causal else "_non_causal")
    before = counters()
    o, lse = fa.flash_attention_fwd(q, k, v, causal, out_dtype)
    got = fa.flash_attention_bwd(q, k, v, o.to(q.dtype), lse, do, causal,
                                 out_dtype)
    torch.cuda.synchronize()
    after = counters()
    counted = {key: after[key] - before[key] for key in after}
    if counted != causal_only(**{f"flash_attn_fwd{suffix}": 1,
                                 f"flash_attn_bwd{suffix}": 1}):
        raise AssertionError(f"launches counted {counted}")
    what = {"shape": list(q.shape), "causal": causal,
            "out_dtype": _dtype_name(out_dtype)}
    o_ref, lse_ref = reference_attention_with_lse(q, k, v, causal, out_dtype)
    err = (o.float() - o_ref.float()).abs()
    lse_err = float((lse - lse_ref).abs().max())
    bad = int((err > O_ATOL + O_RTOL * o_ref.float().abs()).sum())
    row = {**what, "max_abs_err": float(err.max()),
           "lse_max_abs_err": lse_err, "o_outside_tol": bad}
    if bad or not lse_err <= LSE_ATOL or o.shape != q.shape \
            or not bool(torch.isfinite(o).all()):
        raise AssertionError(f"flash_attn_fwd disagrees: {row}")
    del o_ref, lse_ref, err
    o = o.to(q.dtype)
    plain = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, causal,
                                         out_dtype)
    o32, lse32 = reference_attention_with_lse(*x32[:3], causal)
    exact = fa.flash_attention_bwd_plain(*x32[:3], o32, lse32, x32[3],
                                         causal)
    del o32, lse32
    brow = {**what, "max_abs_err": max(float((g.float() - p.float())
                                             .abs().max())
                                       for g, p in zip(got, plain))}
    for gname, g, p, e in zip(("dq", "dk", "dv"), got, plain, exact):
        brow[gname] = drift(g, p, e)
        if gname in ("dq", "dk") and q.shape[2] == 1:
            brow[gname]["ok"] = brow[gname]["max_abs_vs_f32"] <= O_ATOL
        if not (brow[gname]["ok"] and g.shape == q.shape
                and bool(torch.isfinite(g).all())):
            raise AssertionError(f"flash_attn_bwd {gname} drifts: {brow}")
    return row, brow


def _ratio(row: dict) -> float:
    """A drift row's largest deviation over the plain version's."""
    plain = row["plain_max_abs_vs_f32"]
    return row["max_abs_vs_f32"] / plain if plain else 0.0


def time_instance(row: dict, brow: dict, x32: list, causal: bool, out_dtype,
                  name: str, dtype=torch.bfloat16,
                  peak_ops: float | None = None) -> None:
    """Times the instance's forward and backward (from its forward's o
    and lse) at ``x32`` in ``dtype`` (its bf16 rounding by default)
    beside SDPA of the same causality, into ``row`` and ``brow``: ms
    (CUDA events, in turns with each library call), plain_ms, library_ms,
    the bound at these shapes (q, k, v, dO in ``dtype``; o, dq, dk, dv in
    ``out_dtype``; lse f32; operations over ``peak_ops``, default the
    bf16 peak), host_us and TFLOP/s."""
    q, k, v, do = (x.to(dtype) for x in x32)
    b, h, t, d = q.shape
    o, lse = fa.flash_attention_fwd(q, k, v, causal, out_dtype)
    o = o.to(q.dtype)
    n, out = b * h * t * d, torch.finfo(out_dtype).bits // 8
    size = torch.finfo(dtype).bits // 8
    flops = 4.0 * b * h * d * t * ((t + 1) / 2 if causal else t)

    def kernel():
        return fa.flash_attention_fwd(q, k, v, causal, out_dtype)

    def kernel_bwd():
        return fa.flash_attention_bwd(q, k, v, o, lse, do, causal, out_dtype)
    row.update(timed(kernel, lambda: reference_attention_with_lse(
        q, k, v, causal, out_dtype), sdpa_forwards(q, k, v, causal), 20))
    add_bound(row, flops, 3 * n * size + n * out + b * h * t * 4, name,
              peak_ops)
    row["host_us"] = host_us(kernel, ATTN_HOST_CALLS)
    row["tflops"] = flops / (row["ms"] * 1e-3) / 1e12
    brow.update(timed(kernel_bwd, lambda: fa.flash_attention_bwd_plain(
        q, k, v, o, lse, do, causal, out_dtype),
        sdpa_backwards(q, k, v, do, causal), 20))
    add_bound(brow, 2.5 * flops, 5 * n * size + 3 * n * out + b * h * t * 4,
              name, peak_ops)
    brow["host_us"] = host_us(kernel_bwd, ATTN_HOST_CALLS)
    brow["tflops"] = 2.5 * flops / (brow["ms"] * 1e-3) / 1e12


#: The wide kernels' own plan function (``flash_attn_wide_plan``): kernel
#: (0 forward, 1 dK/dV, 2 dQ), f32, D -> groups, boxes, resident, slice
#: and group stages, shared-memory bytes.
WIDE_PLAN_C = build.Kernel("flash_attn_wide", "flash_attn_wide_plan",
                           (ctypes.c_int,) * 3 + (ctypes.c_void_p,))


def wide_plan_row(d: int, dtype) -> dict:
    """``fa.wide_plan`` at head dim ``d``, each kernel's part checked
    against the plan the library launches by; raises where they
    differ."""
    plan = fa.wide_plan(d, dtype)
    out = (ctypes.c_int * 6)()
    for i, kernel in enumerate(("forward", "dkdv", "dq")):
        rc = WIDE_PLAN_C.launch(i, int(dtype is torch.float32), d,
                                ctypes.addressof(out))
        p = plan[kernel]
        want = [p["groups"], p["boxes"], int(p["resident"]),
                p["slice_stages"], p["group_stages"], p["smem_bytes"]]
        if rc or list(out) != want:
            raise AssertionError(f"wide plan of {kernel} at D {d} {dtype}: "
                                 f"library {list(out)} (rc {rc}), "
                                 f"wide_plan {want}")
    return plan


def wide_build_report(log: str) -> dict:
    """Each wide-kernel instance's registers (at launch; the consumer
    warpgroups run at 240 by setmaxnreg), stack and spill bytes from the
    ``-Xptxas -v`` log of ``flash_attn_wide.cu``, by its kernel and
    template arguments (operand parts, widest boxes a warpgroup owns)."""
    out, current = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '\S*?\d(wide_[a-z]+_kernel)"
                      r"I(\w*?)EEv", line)
        if m:
            # Template arguments: <parts, boxes>, or the delta kernel's
            # input type (t: bf16 bits, f: f32).
            args = re.findall(r"Li(\d+)E", m.group(2) + "E")
            kind = {"t": "bf16", "f": "f32"}.get(m.group(2), m.group(2))
            current = f"{m.group(1)}<{','.join(args) or kind}>"
            out[current] = {}
            continue
        if current is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            out[current].update(stack_bytes=int(m.group(1)),
                                spill_store_bytes=int(m.group(2)),
                                spill_load_bytes=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[current]["registers"] = int(m.group(1))
            current = None
    return out


def check_instances(gen, name: str, phase: str, shapes: list,
                    timed_shapes: list, causal: bool,
                    out_dtype) -> tuple[list, list]:
    """Both kernels' instance (causal or not, bf16 or f32 out) at each of
    ``shapes`` under :func:`gate_instance`, timed at ``timed_shapes`` by
    :func:`time_instance`; says ``phase`` with every forward and backward
    row. Returns the timed forward and backward rows, in
    ``timed_shapes``' order."""
    fwd, bwd = {}, {}
    for shape in shapes:
        x32 = [torch.randn(shape, generator=gen, device="cuda")
               for _ in range(4)]
        row, brow = gate_instance(x32, causal, out_dtype)
        if shape in timed_shapes:
            time_instance(row, brow, x32, causal, out_dtype, name)
        del x32
        torch.cuda.empty_cache()
        fwd[shape], bwd[shape] = row, brow
    say(phase, ok=True, o_atol=O_ATOL, o_rtol=O_RTOL, lse_atol=LSE_ATOL,
        forward=list(fwd.values()), backward=list(bwd.values()))
    return ([fwd[shape] for shape in timed_shapes],
            [bwd[shape] for shape in timed_shapes])


def check_head_dims(gen, name: str) -> dict:
    """The kernels at head dims that are no tile's width, at the W-256
    tile's and over it (the wide kernels): every instance (causal or
    not, bf16 or f32 out), forward and backward, at HEAD_DIMS x
    HEAD_DIM_TS under :func:`gate_instance`; the wide kernels' f32
    instances at F32_WIDE_HEAD_DIMS x ATTN_F32_TS under
    :func:`gate_f32`; f64, f16 and mixed dtypes at
    WIDE_REFUSAL_HEAD_DIM raise ``TypeError`` and launch nothing; the
    padded copy of head dim 25 timed against the D-32 launch it pads to;
    then Phi-3-mini's, GPT-J-6B's and the wide bf16 attention
    (PHI3_ATTN_SHAPE, GPTJ_ATTN_SHAPE, WIDE_ATTN_SHAPE; causal, bf16) and
    the wide f32 attention (WIDE_F32_ATTN_SHAPE, causal, bound at the
    TF32 rate) gated and timed beside SDPA, the bounds at the true head
    dim. Returns ``{shape: (forward row, backward row)}`` of the timed
    shapes, the f32 one keyed by its shape and ``"f32"``."""
    cases = []
    for d in HEAD_DIMS:
        for t in HEAD_DIM_TS:
            for causal in (True, False):
                for out_dtype in (torch.bfloat16, torch.float32):
                    x32 = [torch.randn((1, 2, t, d), generator=gen,
                                       device="cuda") for _ in range(4)]
                    row, brow = gate_instance(x32, causal, out_dtype)
                    # d, t, causal, out, o and lse errors, and each
                    # gradient's largest deviation over the plain one's.
                    cases.append([d, t, causal, row["out_dtype"],
                                  row["max_abs_err"], row["lse_max_abs_err"],
                                  *(_ratio(brow[g]) for g in ("dq", "dk",
                                                              "dv"))])
    f32_cases = []
    for d in F32_WIDE_HEAD_DIMS:
        for t in ATTN_F32_TS:
            for causal in (True, False):
                x32 = [torch.randn((1, 2, t, d), generator=gen,
                                   device="cuda") for _ in range(4)]
                row, brow = gate_f32(x32, causal)
                f32_cases.append([d, t, causal,
                                  *(row[key]["ratio"] for key in ("o", "lse")),
                                  *(brow[key]["ratio"]
                                    for key in ("dq", "dk", "dv"))])
    refused = {}
    before = counters()
    x = torch.zeros((1, 2, 8, WIDE_REFUSAL_HEAD_DIM), device="cuda")
    for what, args in (("f64", (x.double(),) * 3), ("f16", (x.half(),) * 3),
                       ("f32 q, bf16 k v", (x, x.bfloat16(), x.bfloat16()))):
        try:
            fa.flash_attention_fwd(*args)
        except TypeError as err:
            refused[what] = str(err)
        else:
            raise AssertionError(f"{what} at head dim "
                                 f"{WIDE_REFUSAL_HEAD_DIM} launched")
    if counters() != before:
        raise AssertionError("a refused input counted a launch")
    padded = {}
    for d in (25, 32):
        shape = PHI3_ATTN_SHAPE[:3] + (d,)
        q, k, v, do = (torch.randn(shape, generator=gen, device="cuda")
                       .to(torch.bfloat16) for _ in range(4))
        o, lse = fa.flash_attention_fwd(q, k, v)
        padded[d] = {
            "forward_ms": time_ms(lambda: fa.flash_attention_fwd(q, k, v),
                                  20),
            "backward_ms": time_ms(
                lambda: fa.flash_attention_bwd(q, k, v, o, lse, do), 20)}
        if d == 25:
            padded[d]["copy_ms"] = time_ms(lambda: [
                F.pad(x, (0, 7)) for x in (q, k, v, o, do)], 20)
        del q, k, v, do, o, lse
    torch.cuda.empty_cache()

    rows = {}
    for shape in (PHI3_ATTN_SHAPE, GPTJ_ATTN_SHAPE, WIDE_ATTN_SHAPE,
                  WIDE_512_ATTN_SHAPE):
        x32 = [torch.randn(shape, generator=gen, device="cuda")
               for _ in range(4)]
        rows[shape] = gate_instance(x32, True, torch.bfloat16)
        time_instance(*rows[shape], x32, True, torch.bfloat16, name)
        del x32
        torch.cuda.empty_cache()
    x32 = [torch.randn(WIDE_F32_ATTN_SHAPE, generator=gen, device="cuda")
           for _ in range(4)]
    wide_f32 = gate_f32(x32, True)
    time_instance(*wide_f32, x32, True, torch.float32, name, torch.float32,
                  TF32_FLOPS)
    wide_f32[0]["bound_rate"] = wide_f32[1]["bound_rate"] = "tf32"
    rows[WIDE_F32_ATTN_SHAPE + ("f32",)] = wide_f32
    # Each wide row beside the column-group plan it ran.
    for shape, dtype in ((WIDE_ATTN_SHAPE, torch.bfloat16),
                         (WIDE_512_ATTN_SHAPE, torch.bfloat16),
                         (WIDE_F32_ATTN_SHAPE + ("f32",), torch.float32)):
        plan = wide_plan_row(shape[3], dtype)
        rows[shape][0]["wide_plan"] = plan["forward"]
        rows[shape][1]["wide_plan"] = {k: plan[k] for k in (
            "dkdv", "dq", "backward")}
    del x32
    torch.cuda.empty_cache()
    say("head_dims", ok=True, head_dims=list(HEAD_DIMS),
        ts=list(HEAD_DIM_TS), o_atol=O_ATOL, o_rtol=O_RTOL,
        lse_atol=LSE_ATOL,
        cases_fields=["d", "t", "causal", "out_dtype", "o_max_abs_err",
                      "lse_max_abs_err", "dq_max_dev_over_plain",
                      "dk_max_dev_over_plain", "dv_max_dev_over_plain"],
        cases=cases, f32_head_dims=list(F32_WIDE_HEAD_DIMS),
        f32_ts=list(ATTN_F32_TS), f32_rule=f"each output's largest "
        f"deviation from f64 <= {F32_RULE} of the bf16 instance's",
        f32_cases_fields=["d", "t", "causal", "o_ratio", "lse_ratio",
                          "dq_ratio", "dk_ratio", "dv_ratio"],
        f32_cases=f32_cases, refused=refused,
        padded_d25_vs_d32={f"d{d}": v for d, v in padded.items()},
        phi3_forward=rows[PHI3_ATTN_SHAPE][0],
        phi3_backward=rows[PHI3_ATTN_SHAPE][1],
        gptj_forward=rows[GPTJ_ATTN_SHAPE][0],
        gptj_backward=rows[GPTJ_ATTN_SHAPE][1],
        wide_forward=rows[WIDE_ATTN_SHAPE][0],
        wide_backward=rows[WIDE_ATTN_SHAPE][1],
        wide_512_forward=rows[WIDE_512_ATTN_SHAPE][0],
        wide_512_backward=rows[WIDE_512_ATTN_SHAPE][1],
        wide_f32_forward=wide_f32[0], wide_f32_backward=wide_f32[1])
    return rows


def attention_run(q, k, v, do, causal: bool, out_dtype=None) -> dict:
    """One forward and one backward launch (the backward from the
    forward's o in ``q.dtype``): o, lse, dq, dk, dv."""
    o, lse = fa.flash_attention_fwd(q, k, v, causal, out_dtype)
    grads = fa.flash_attention_bwd(q, k, v, o.to(q.dtype), lse, do, causal,
                                   out_dtype)
    return {"o": o, "lse": lse, **dict(zip(("dq", "dk", "dv"), grads))}


def gate_f32(x32: list, causal: bool) -> tuple[dict, dict]:
    """One launch of the f32 instance (causal or not) forward and
    backward on ``x32`` ([q, k, v, do], f32), counted, and of the bf16
    instance (f32 out) on its bf16 rounding, each against
    ``gates.plain64`` of ``x32`` under ``gates.f32_rule``. Returns the
    forward and backward rows (``max_abs_err``: the largest deviation
    from f64); raises on a miss."""
    suffix = "" if causal else "_non_causal"
    wide = wide_infix(x32[0])
    before = counters()
    got = attention_run(*x32, causal)
    torch.cuda.synchronize()
    after = counters()
    counted = {key: after[key] - before[key] for key in after}
    if counted != causal_only(**{f"flash_attn_fwd{wide}_f32{suffix}": 1,
                                 f"flash_attn_bwd{wide}_f32{suffix}": 1}):
        raise AssertionError(f"f32 launches counted {counted}")
    outputs = [(g.dtype, tuple(g.shape)) for g in got.values()]
    if any(dt != torch.float32 or shape != x32[0].shape[:len(shape)]
           for dt, shape in outputs):
        raise AssertionError(f"f32 outputs: {outputs}")
    bf16 = attention_run(*(x.to(torch.bfloat16) for x in x32), causal,
                         torch.float32)
    rule = f32_rule(got, bf16, plain64(*x32, causal))
    what = {"shape": list(x32[0].shape), "causal": causal, "dtype": "f32"}
    row = {**what, "max_abs_err": rule["o"]["max_abs_vs_exact"],
           "lse_max_abs_err": rule["lse"]["max_abs_vs_exact"],
           "o": rule["o"], "lse": rule["lse"]}
    brow = {**what, "max_abs_err": max(rule[g]["max_abs_vs_exact"]
                                       for g in ("dq", "dk", "dv")),
            **{g: rule[g] for g in ("dq", "dk", "dv")}}
    if not rule["ok"]:
        raise AssertionError(f"f32 instance breaks the rule: {rule}")
    return row, brow


def check_attn_f32(gen, name: str) -> list:
    """The f32 instances (q, k, v, dO in f32; head dims up to 128):
    forward and backward, causal and not, at ATTN_F32_DIMS x ATTN_F32_TS
    under :func:`gate_f32` (each output within F32_RULE, 1/256, of the
    bf16 instance's deviation from f64); f64, f16 and mixed dtypes raise
    ``TypeError``, none counting a launch (wider f32 head dims take the
    wide kernels: :func:`check_head_dims`); then
    ATTN_F32_TIMED gated and timed (:func:`time_instance` in f32, bound
    at TF32_FLOPS, SDPA with TF32 off as the yardstick). Returns
    ``[(shape, causal, forward row, backward row)]`` of the timed ones."""
    cases = []
    for d in ATTN_F32_DIMS:
        for t in ATTN_F32_TS:
            for causal in (True, False):
                x32 = [torch.randn((1, 2, t, d), generator=gen,
                                   device="cuda") for _ in range(4)]
                row, brow = gate_f32(x32, causal)
                cases.append([d, t, causal,
                              *(row[key]["ratio"] for key in ("o", "lse")),
                              *(brow[key]["ratio"]
                                for key in ("dq", "dk", "dv"))])
    refused = {}
    before = counters()
    x = torch.zeros((1, 2, 8, 32), device="cuda")
    for what, args, error in (
            ("f64", (x.double(),) * 3, TypeError),
            ("f16", (x.half(),) * 3, TypeError),
            ("f32 q, bf16 k v", (x, x.bfloat16(), x.bfloat16()), TypeError)):
        try:
            fa.flash_attention_fwd(*args)
        except error as err:
            refused[what] = str(err)
        else:
            raise AssertionError(f"{what} launched")
    try:
        fa.flash_attention_bwd(x, x, x, x,
                               torch.zeros((1, 2, 8), device="cuda"),
                               x.double())
    except TypeError as err:
        refused["backward, f32 with f64 dO"] = str(err)
    else:
        raise AssertionError("the backward took f64 dO")
    if counters() != before:
        raise AssertionError("a refused input counted a launch")
    timed = []
    for shape, causal in ATTN_F32_TIMED:
        x32 = [torch.randn(shape, generator=gen, device="cuda")
               for _ in range(4)]
        row, brow = gate_f32(x32, causal)
        time_instance(row, brow, x32, causal, torch.float32, name,
                      torch.float32, TF32_FLOPS)
        row["bound_rate"] = brow["bound_rate"] = "tf32"
        timed.append((shape, causal, row, brow))
        del x32
        torch.cuda.empty_cache()
    say("attn_f32", ok=True, rule=f"each output's largest deviation from "
        f"f64 <= {F32_RULE} of the bf16 instance's (f32 out) on the bf16 "
        "rounding of the same inputs", head_dims=list(ATTN_F32_DIMS),
        ts=list(ATTN_F32_TS),
        cases_fields=["d", "t", "causal", "o_ratio", "lse_ratio",
                      "dq_ratio", "dk_ratio", "dv_ratio"],
        cases=cases, worst_ratio=max(max(c[3:]) for c in cases),
        refused=refused,
        timed=[{"forward": row, "backward": brow}
               for _, _, row, brow in timed])
    return timed


def check_entry() -> None:
    """The tiny entry-point forward on the card (the reference's default
    attention, the ring: one causal launch a layer on one device)
    against the CPU's plain path, at the reference tests' bf16 bound
    (5e-2)."""
    fn, (params, _) = entry()
    tokens = torch.randint(0, 256, (2, 64), device="cuda",
                           generator=torch.Generator("cuda").manual_seed(3))
    got = fn(params, tokens).cpu()
    cpu_params = {k: ({kk: vv.cpu() for kk, vv in v.items()}
                      if isinstance(v, dict) else v.cpu())
                  for k, v in params.items()}
    cfg = lm.LMConfig(vocab=256, d_model=128, n_layers=2, n_heads=4,
                      d_ff=512)
    want = lm.make_forward(cfg, "cpu")(cpu_params, tokens.cpu())
    err = float((got - want).abs().max())
    if not (got.shape == (2, 64, 256) and err < 5e-2):
        raise AssertionError(f"entry forward on the card: {got.shape}, {err}")
    say("entry", ok=True, shape=list(got.shape), max_abs_err_vs_cpu=err)


def check_mnist() -> None:
    """The MNIST payload (``workloads/mnist.py``; plain PyTorch ops, no
    kernel of the port) on the card: MNIST_STEPS Adam steps, held-out
    accuracy over MNIST_ACCURACY, and within 1e-2 of the CPU's run of the
    same seed (the same data and initial weights, drawn on the host)."""
    t0 = time.perf_counter()
    acc = mnist.train(steps=MNIST_STEPS, device="cuda")
    seconds = time.perf_counter() - t0
    cpu = mnist.train(steps=MNIST_STEPS, device="cpu")
    if not (acc > MNIST_ACCURACY and abs(acc - cpu) <= 1e-2):
        raise AssertionError(f"mnist: accuracy {acc} on the card, {cpu} on "
                             "the CPU")
    say("mnist", ok=True, steps=MNIST_STEPS, accuracy=acc, cpu_accuracy=cpu,
        seconds=seconds)


def check_dryrun() -> dict:
    """``entry.dryrun_multichip`` on every card of this host and, with
    three cards or more, on the first three (head dim 48): each at n
    cards :func:`check_dryrun_on`. Returns the launches over all
    ranks."""
    cards = torch.cuda.device_count()
    total = dict.fromkeys(counters(), 0)
    for n in sorted({cards, 3} if cards >= 3 else {cards}):
        for key, count in check_dryrun_on(n).items():
            total[key] += count
    return total


def check_dryrun_on(n: int) -> dict:
    """``entry.dryrun_multichip(n)`` (each rank a process over NCCL, on
    the first n cards): one dense train step over
    ``default_axis_sizes(n)`` and one MoE step, counted on every rank. A
    dense step makes 2 x layers ring forwards and layers ring backwards
    at each rank's H / tp heads, the MoE's 2 x its layers and its layers;
    the rank at sp index i launches i + 1 blocks a ring call, i of them
    non-causal. Returns the launches over all ranks."""
    run = dryrun_config(n)
    t0 = time.perf_counter()
    ranks = dryrun_multichip(n)
    seconds = time.perf_counter() - t0
    total = dict.fromkeys(counters(), 0)
    layers, moe_layers = run.cfg.n_layers, run.moe_cfg.n_layers
    for out in ranks:
        i, j = out["coordinate"]["sp"], out["moe_coordinate"]["sp"]
        want = causal_only(
            flash_attn_fwd=2 * (layers + moe_layers),
            flash_attn_bwd=layers + moe_layers,
            flash_attn_fwd_non_causal=2 * (layers * i + moe_layers * j),
            flash_attn_bwd_non_causal=layers * i + moe_layers * j)
        got = causal_only(**out["launches"])
        if got != want:
            raise AssertionError(f"dryrun rank {out['rank']}: launches "
                                 f"{got}, want {want}")
        for key, count in got.items():
            total[key] += count
    losses = {out["loss"] for out in ranks}
    moe_losses = {out["moe_loss"] for out in ranks}
    if len(losses) != 1 or len(moe_losses) != 1:
        raise AssertionError(f"dryrun: ranks disagree: {ranks}")
    say("dryrun", ok=True, devices=n, sizes=run.sizes,
        moe_sizes=run.moe_sizes, head_dim=run.cfg.head_dim,
        loss=losses.pop(), moe_loss=moe_losses.pop(), seconds=seconds,
        ranks=[{k: out[k] for k in ("rank", "coordinate", "moe_coordinate",
                                    "launches")} for out in ranks])
    return total


def check_dryrun_odd() -> dict:
    """The dense dryrun configs of DRYRUN_ODD device counts at a 1-device
    layout on the card: one train step from the dryrun's params and
    batch (drawn on the host), the ring at sp 1 through the kernels at
    head dims 48, 24, 144, 240 and 272 (the wide kernels at 17), counted
    (2 x layers forward and layers backward causal launches); its loss
    within 1e-3 relative of the same step's on the CPU. Returns the
    launches."""
    total = dict.fromkeys(counters(), 0)
    rows = []
    for n in DRYRUN_ODD:
        run = dryrun_config(n)
        inputs = dryrun_inputs(run, "cpu")
        losses = {}
        for device in ("cpu", "cuda"):
            # A copy each: the step updates its params in place.
            params = lm._tree_map(lambda x: x.to(device, copy=True),
                                  inputs["params"])
            step = lm.make_train_step(run.cfg, device=device)
            opt_state = lm.init_opt_state(params, run.cfg)
            batch = inputs["batch"].to(device)
            zero_counters()
            losses[device] = float(step(params, opt_state, batch)[2])
        launches = counters()
        w = "" if fa.one_tile(run.cfg.head_dim) else "_wide"
        want = causal_only(**{f"flash_attn_fwd{w}": 2 * run.cfg.n_layers,
                              f"flash_attn_bwd{w}": run.cfg.n_layers})
        rel = abs(losses["cuda"] - losses["cpu"]) / abs(losses["cpu"])
        row = {"n": n, "head_dim": run.cfg.head_dim, "batch": run.batch,
               "seq": run.seq, "loss": losses["cuda"],
               "cpu_loss": losses["cpu"], "rel": rel, "launches": launches}
        if launches != want or not rel <= 1e-3:
            raise AssertionError(f"dryrun_odd: {row}, want {want}")
        for key, count in launches.items():
            total[key] += count
        rows.append(row)
    say("dryrun_odd", ok=True, layout="1 device", runs=rows)
    return total


def counters() -> dict:
    """Launches by kernel instance: the attention kernels' bf16 and f32,
    causal and non-causal instances apart."""
    return {"vector_add": va.launches, **fa.counts()}


def zero_counters() -> None:
    va.launches = 0
    fa.zero_counts()


def causal_only(**launches) -> dict:
    """A full counters() dict: ``launches``, every other instance 0."""
    return {**dict.fromkeys(counters(), 0), **launches}


def check_train(base: lm.LMConfig, cases, peak: float, known: bool) -> dict:
    """The training path: one counted step per case (at the case's
    attention and param dtype: the ring cases at sp = 1, one causal
    launch a layer), then the loss over TRAIN_STEPS steps on one batch
    and the time of the steps after the first TRAIN_WARM. Returns the
    launches of the counted steps."""
    total = dict.fromkeys(counters(), 0)
    want = causal_only(flash_attn_fwd=2 * base.n_layers,
                       flash_attn_bwd=base.n_layers)
    for case in cases:
        cfg = dataclasses.replace(
            base, attn_impl=case.attn_impl,
            param_dtype=getattr(torch, case.param_dtype))
        params, opt_state = lm.init_train_state(
            torch.Generator("cuda").manual_seed(0), cfg)
        step = lm.make_train_step(cfg)
        batch = lm.synthetic_batch(torch.Generator("cuda").manual_seed(1),
                                   cfg, case.batch, case.seq)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counters()
        params, opt_state, loss = step(params, opt_state, batch)
        torch.cuda.synchronize()
        launches = counters()
        if launches != want:
            raise AssertionError(f"{case.name}: launches per train step "
                                 f"{launches}, want {want}")
        for key, n in launches.items():
            total[key] += n
        losses = [loss]
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        for i in range(1, TRAIN_STEPS):
            if i == TRAIN_WARM:
                start.record()
            params, opt_state, loss = step(params, opt_state, batch)
            losses.append(loss)
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / (TRAIN_STEPS - TRAIN_WARM)
        losses = [float(x) for x in losses]
        if not (all(map(math.isfinite, losses)) and losses[-1] < losses[0]):
            raise AssertionError(f"{case.name}: loss does not fall: {losses}")
        ntok = case.batch * case.seq
        flops = chip_bench.train_flops_per_token(case) * ntok
        say("train", case=case.name, batch=case.batch, seq=case.seq,
            attn_impl=case.attn_impl, param_dtype=case.param_dtype,
            launches_per_step=launches, step_ms=ms,
            tokens_per_s=ntok / (ms * 1e-3),
            mfu=flops / (ms * 1e-3) / peak, peak_known=known,
            train_bound_ms=flops / peak * 1e3,
            peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
            losses=losses)
        del params, opt_state, step, batch, loss
        torch.cuda.empty_cache()
    return total


def check_train_grads(base: lm.LMConfig) -> None:
    """Every gradient of the kernel path, at full width but 2 layers and
    the t2k shape, against an f32 plain-attention step, under the same
    rule as the forward's logits: within 2x the largest and 1.5x the
    mean deviation of the plain bf16 step's gradients. Then the f32
    kernel path (f32 params and compute, the default ring at sp = 1: the
    kernels' f32 instances): its logits and every gradient no further
    from the f32 plain-attention step's than F32_RULE of the bf16 kernel
    path's largest deviation."""
    cfg = dataclasses.replace(base, n_layers=2)
    case = chip_bench.case(MAIN_CASES[0])
    params = lm.init_params(torch.Generator("cuda").manual_seed(0), cfg)
    batch = lm.synthetic_batch(torch.Generator("cuda").manual_seed(1), cfg,
                               case.batch, case.seq)
    loss_k, grads_k = lm.loss_and_grads(params, batch, cfg)
    loss_p, grads_p = lm.loss_and_grads(
        params, batch, dataclasses.replace(cfg, attn_impl="local"))
    cfg32 = dataclasses.replace(cfg, attn_impl="local",
                                param_dtype=torch.float32,
                                compute_dtype=torch.float32)
    params32 = lm._tree_map(lambda p: p.float(), params)
    loss_32, grads_32 = lm.loss_and_grads(params32, batch, cfg32)
    rows = {}
    for path, g_k, g_p, g_32 in zip(_paths(grads_k), lm._leaves(grads_k),
                                    lm._leaves(grads_p),
                                    lm._leaves(grads_32)):
        rows[path] = drift(g_k, g_p, g_32)
        if not (rows[path]["ok"] and bool(torch.isfinite(g_k).all())):
            raise AssertionError(f"gradient {path} drifts: {rows[path]}")
    del grads_p
    ring32 = dataclasses.replace(cfg32, attn_impl="ring")
    loss_f, grads_f = lm.loss_and_grads(params32, batch, ring32)
    tokens = batch[:, :-1]
    logits = {"kernel": lm.make_forward(cfg)(params, tokens),
              "f32_kernel": lm.make_forward(ring32)(params32, tokens),
              "f32": lm.make_forward(cfg32)(params32, tokens)}
    f32_rows = {"logits": logits["f32_kernel"], **dict(zip(
        _paths(grads_f), lm._leaves(grads_f)))}
    bf16_rows = {"logits": logits["kernel"], **dict(zip(
        _paths(grads_k), lm._leaves(grads_k)))}
    exact_rows = {"logits": logits["f32"], **dict(zip(
        _paths(grads_32), lm._leaves(grads_32)))}
    f32_kernels = f32_rule(f32_rows, bf16_rows, exact_rows)
    if not f32_kernels.pop("ok"):
        raise AssertionError(f"f32 kernel path: {f32_kernels}")
    say("train_grads", ok=True, n_layers=cfg.n_layers, case=case.name,
        loss=float(loss_k), plain_loss=float(loss_p), f32_loss=float(loss_32),
        grads=rows, f32_kernel_loss=float(loss_f),
        f32_kernel_rule=f"largest deviation from the f32 plain-attention "
        f"step <= {F32_RULE} of the bf16 kernel path's",
        f32_kernel_worst=max(r["ratio"] for r in f32_kernels.values()),
        f32_kernels=f32_kernels)
    del grads_k, grads_32, grads_f, logits, f32_rows, bf16_rows, exact_rows
    torch.cuda.empty_cache()


def check_lm_f32(peak: float, known: bool) -> dict:
    """The 600M LM in f32 (``lm_f32(lm_sp_cfg(8))``: f32 params and
    compute, the default ring at sp = 1) at PUBLISHED_BATCH on one card,
    through the kernels' f32 instances. The forward counted (one causal
    f32 launch a layer) and its loss within F32_LOSS_RTOL of the same
    forward with ``attn_impl="local"``; the forward once with ``"flash"``,
    counted, held the same way; then LM_SP_STEPS train steps
    (:func:`timed_steps`, counted: 2 x layers f32 forward and layers f32
    backward launches a step) against the same steps with plain f32
    attention (``attn_impl="local"``) and with plain attention in f64
    (``gates.attention_f64``) under :func:`f32_steps_rule`; the rule's
    power: the same steps with one-pass TF32 attention
    (``gates.attention_tf32``) must fail it. Forward ms, step ms,
    tokens/s, MFU against the bf16 peak, peak memory. Returns the
    launches of the counted runs."""
    cfg = lm_f32(lm_sp_cfg(8))
    b, t = PUBLISHED_BATCH
    case = chip_bench.BenchCase("lm-600m-f32-t2k", cfg.d_model, cfg.n_layers,
                                cfg.n_heads, cfg.d_ff, cfg.vocab, b, t)
    params = lm.init_params(torch.Generator("cuda").manual_seed(0), cfg)
    batch = lm.synthetic_batch(torch.Generator("cuda").manual_seed(1), cfg,
                               b, t)
    tokens = batch[:, :-1]
    total = dict.fromkeys(counters(), 0)
    losses, forward_ms = {}, {}
    for impl in ("ring", "flash", "local"):
        c = dataclasses.replace(cfg, attn_impl=impl)
        forward = lm.make_forward(c)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counters()
        logits = forward(params, tokens)
        torch.cuda.synchronize()
        launches = counters()
        want = causal_only(flash_attn_fwd_f32=0 if impl == "local"
                           else cfg.n_layers)
        if launches != want or logits.shape != (b, t, cfg.vocab) or \
                not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"lm_f32 {impl} forward: "
                                 f"{tuple(logits.shape)}, launches "
                                 f"{launches}, want {want}")
        for key, count in launches.items():
            total[key] += count
        del logits
        if impl == "ring":
            fwd_peak = torch.cuda.max_memory_allocated() / 1e9
        with torch.inference_mode():
            losses[impl] = float(lm.loss_fn(params, batch, c))
        forward_ms[impl] = time_ms(lambda: forward(params, tokens), 3, 1)
        torch.cuda.empty_cache()
    rel = {impl: abs(losses[impl] - losses["local"]) / abs(losses["local"])
           for impl in ("ring", "flash")}
    if not all(r <= F32_LOSS_RTOL for r in rel.values()):
        raise AssertionError(f"lm_f32 forward losses {losses}")
    del params
    torch.cuda.empty_cache()
    steps = {impl: timed_steps(dataclasses.replace(cfg, attn_impl=impl), b,
                               t) for impl in ("ring", "local")}
    for name, attention in (("f64", attention_f64),
                            ("tf32", attention_tf32)):
        steps[name] = timed_steps(cfg, b, t, attention=attention)
        torch.cuda.empty_cache()
    layers = cfg.n_layers * LM_SP_STEPS
    want = causal_only(flash_attn_fwd_f32=2 * layers,
                       flash_attn_bwd_f32=layers)
    ring, local = steps["ring"], steps["local"]
    rule, control = (f32_steps_rule(steps[p]["losses"], local["losses"],
                                    steps["f64"]["losses"])
                     for p in ("ring", "tf32"))
    if ring["launches"] != want or not rule["ok"] or control["ok"]:
        raise AssertionError(f"lm_f32 steps: {rule}, one-pass TF32 "
                             f"control {control} (must fail), launches "
                             f"{ring['launches']}, want {want}")
    for key, count in ring["launches"].items():
        total[key] += count
    ntok = b * t
    fwd_flops = chip_bench.forward_flops_per_token(case) * ntok
    train_flops = chip_bench.train_flops_per_token(case) * ntok
    ms = {impl: sum(out["step_ms"][1:]) / (LM_SP_STEPS - 1)
          for impl, out in steps.items()}
    say("lm_f32", ok=True, batch=b, seq=t, n_layers=cfg.n_layers,
        d_model=cfg.d_model, n_heads=cfg.n_heads, head_dim=cfg.head_dim,
        d_ff=cfg.d_ff, vocab=cfg.vocab, param_dtype="f32",
        compute_dtype="f32", tf32=torch.backends.cuda.matmul.allow_tf32,
        forward_losses=losses, forward_rel=rel, forward_ms=forward_ms,
        forward_tokens_per_s=ntok / (forward_ms["ring"] * 1e-3),
        forward_mfu=fwd_flops / (forward_ms["ring"] * 1e-3) / peak,
        forward_peak_memory_gb=fwd_peak,
        losses=ring["losses"], local_losses=local["losses"],
        f64_attention_losses=steps["f64"]["losses"], step_rule=rule,
        tf32_attention_losses=steps["tf32"]["losses"],
        tf32_control_rule=control,
        launches_per_3_steps=ring["launches"],
        step_ms=ms["ring"], local_step_ms=ms["local"],
        step_timed=f"steps 2-{LM_SP_STEPS}, host clock to each loss's read",
        tokens_per_s=ntok / (ms["ring"] * 1e-3),
        mfu=train_flops / (ms["ring"] * 1e-3) / peak,
        mfu_peak="dense bf16 tensor-core peak", peak_known=known,
        peak_memory_gb=ring["peak_memory_gb"],
        local_peak_memory_gb=local["peak_memory_gb"])
    return total


def _paths(tree, prefix="") -> list[str]:
    if isinstance(tree, dict):
        return [p for key, val in tree.items()
                for p in _paths(val, f"{prefix}{key}.")]
    return [prefix[:-1]]


def check_train_loop() -> None:
    """``lm.train`` on the card at the entry config: 4 steps with a
    checkpoint every 2, then a new incarnation that resumes at 4 and
    ends at 6, publishing markers and a metrics report."""
    cfg = lm.LMConfig(vocab=256, d_model=128, n_layers=2, n_heads=4,
                      d_ff=512, attn_impl="flash")
    old = os.environ.get("KTPU_SANDBOX")
    with tempfile.TemporaryDirectory() as tmp:
        ckpt_dir = os.path.join(tmp, "job")
        os.environ["KTPU_SANDBOX"] = tmp
        try:
            first = lm.train(cfg, steps=4, batch=2, seq=64, ckpt_dir=ckpt_dir,
                             checkpoint_every=2, publish_marker=True)
            second = lm.train(cfg, steps=6, batch=2, seq=64,
                              ckpt_dir=ckpt_dir, checkpoint_every=2,
                              publish_marker=True)
        finally:
            if old is None:
                os.environ.pop("KTPU_SANDBOX", None)
            else:
                os.environ["KTPU_SANDBOX"] = old
        marker = read_marker(ckpt_dir)
        report = metrics_reporter.read_report(tmp)
    if not (first["resumed_from"] == 0 and second["resumed_from"] == 4
            and second["final_step"] == 6 and marker == 5 and report
            and report.get("step") == 5 and report.get("hbm_used_bytes")):
        raise AssertionError(f"train loop: {first} {second} marker={marker} "
                             f"report={report}")
    say("train_loop", ok=True, first=first, second=second, marker=marker,
        report=report)


@contextlib.contextmanager
def environ(values: dict):
    """``os.environ`` with ``values`` set (None removes a name), put back
    as it was after."""
    old = {k: os.environ.get(k) for k in values}
    try:
        for k, v in values.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def gang_of_one(**values) -> dict:
    """A one-rank gang's env for the trainer on the card, ``values`` on
    top; None removes a name."""
    return {"TPU_WORKER_ID": "0",
            "TPU_WORKER_HOSTNAMES": "smoke-0.smoke-workers.default",
            "KTPU_TRAINER_PLATFORM": None, "KTPU_DEMO_PLATFORM": None,
            "KTPU_CHECKPOINT_DIR": None, "KTPU_PREEMPT": None,
            "KTPU_PREEMPT_FILE": None, "KTPU_SANDBOX": None,
            "STEP_DELAY": None, **values}


def trainer_cfg(n_layers: int) -> lm.LMConfig:
    """The config the trainer builds from TRAINER_ENV at ``n_layers``
    on the card: f32 params, bf16 compute, the flash kernels."""
    return lm.LMConfig(vocab=32768, d_model=2048, n_layers=n_layers,
                       n_heads=16, d_ff=8192, attn_impl="flash")


def run_module(module: str, env: dict) -> subprocess.CompletedProcess:
    """``python -m module`` from the repository root with this process's
    env and ``env`` on top; killed at SUBPROCESS_TIMEOUT."""
    child = dict(os.environ)
    for k, v in env.items():
        if v is None:
            child.pop(k, None)
        else:
            child[k] = v
    return subprocess.run([sys.executable, "-m", module], env=child,
                          cwd=os.path.dirname(os.path.abspath(__file__)),
                          capture_output=True, text=True,
                          timeout=SUBPROCESS_TIMEOUT)


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _tail(proc: subprocess.CompletedProcess) -> str:
    return (proc.stdout + proc.stderr)[-3000:]


def check_trainer(peak: float, known: bool) -> dict:
    """The TrainJob worker payload at the 600M width and depth:
    ``trainer.main()`` as a one-rank gang, counted. Returns its
    launches."""
    cfg = trainer_cfg(8)
    batch, seq = int(TRAINER_ENV["BATCH"]), int(TRAINER_ENV["SEQ"])
    case = chip_bench.BenchCase("trainer", cfg.d_model, cfg.n_layers,
                                cfg.n_heads, cfg.d_ff, cfg.vocab, batch, seq)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt_dir = os.path.join(tmp, "job")
        env = gang_of_one(**TRAINER_ENV, TOTAL_STEPS=str(TRAINER_STEPS),
                          CHECKPOINT_EVERY="0", CKPT_DIR=ckpt_dir,
                          KTPU_SANDBOX=tmp)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with environ(env):
            zero_counters()
            rc = trainer.main()
            torch.cuda.synchronize()
            launches = counters()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        report = metrics_reporter.read_report(tmp)
        with open(os.path.join(ckpt_dir, "attempt-rank0-start0.json")) as f:
            record = json.load(f)
        torch.cuda.empty_cache()
        direct = timed_train(cfg, None, os.path.join(tmp, "direct"),
                             TRAINER_STEPS)
    torch.cuda.empty_cache()
    events_ms = f32_step_ms(cfg, batch, seq)
    want = causal_only(flash_attn_fwd=2 * cfg.n_layers * TRAINER_STEPS,
                       flash_attn_bwd=cfg.n_layers * TRAINER_STEPS)
    if rc != 0 or launches != want:
        raise AssertionError(f"trainer: rc {rc}, launches {launches}, "
                             f"want {want}")
    got = {k: record[k] for k in ("resumed_from", "final_step", "steps_run")}
    if got != {"resumed_from": 0, "final_step": TRAINER_STEPS,
               "steps_run": TRAINER_STEPS}:
        raise AssertionError(f"trainer: attempt record {record}")
    loss = record["loss"]
    if not (math.isfinite(loss)
            and abs(loss - direct["loss"]) <= 1e-3 * abs(direct["loss"])):
        raise AssertionError(f"trainer: loss {loss} against lm.train's "
                             f"{direct['loss']}")
    if not (report and report.get("step") == TRAINER_STEPS - 1):
        raise AssertionError(f"trainer: metrics report {report}")
    ms = report["step_time_ms"]
    ntok = batch * seq
    flops = chip_bench.train_flops_per_token(case) * ntok
    say("trainer", batch=batch, seq=seq, n_layers=cfg.n_layers,
        param_dtype="float32", steps=TRAINER_STEPS,
        launches_per_step={k: n // TRAINER_STEPS for k, n in launches.items()},
        launches=launches, loss=loss, direct_train_loss=direct["loss"],
        attempt_record=got, step_ms=ms, step_timed="last step, by the "
        "metrics report (host clock, to the loss's sync)",
        tokens_per_s=ntok / (ms * 1e-3), mfu=flops / (ms * 1e-3) / peak,
        peak_known=known, peak_memory_gb=peak_gb,
        direct_train_step_ms=direct["step_ms"],
        f32_step_events_ms=events_ms,
        f32_step_events_mfu=flops / (events_ms * 1e-3) / peak)
    return launches


def f32_step_ms(cfg: lm.LMConfig, batch: int, seq: int) -> float:
    """The trainer's step (f32 params) without its loop: back-to-back
    steps on one batch, timed by CUDA events after TRAIN_WARM steps, as
    the ``train`` phase times the bf16 step."""
    params, opt_state = lm.init_train_state(
        torch.Generator("cuda").manual_seed(0), cfg)
    step = lm.make_train_step(cfg)
    tokens = lm.synthetic_batch(torch.Generator("cuda").manual_seed(1), cfg,
                                batch, seq)
    for _ in range(TRAIN_WARM):
        params, opt_state, _ = step(params, opt_state, tokens)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(TRAIN_STEPS - TRAIN_WARM):
        params, opt_state, _ = step(params, opt_state, tokens)
    end.record()
    end.synchronize()
    del params, opt_state, step
    torch.cuda.empty_cache()
    return start.elapsed_time(end) / (TRAIN_STEPS - TRAIN_WARM)


@contextlib.contextmanager
def step_losses():
    """The loss of every step that ``lm.train`` runs inside the block, in
    order: ``lm.make_train_step`` is wrapped to record them."""
    losses, make = [], lm.make_train_step

    def recording(*args, **kwargs):
        step = make(*args, **kwargs)

        def run(params, opt_state, batch):
            params, opt_state, loss = step(params, opt_state, batch)
            losses.append(float(loss))
            return params, opt_state, loss
        return run
    lm.make_train_step = recording
    try:
        yield losses
    finally:
        lm.make_train_step = make


def timed_train(cfg: lm.LMConfig, group, ckpt_dir: str, steps: int) -> dict:
    """``lm.train`` for ``steps`` steps at B4 T2048 with no saves; its
    result with ``losses``, the loss of each step, and ``step_ms``, the
    host time of each step after the first, each ended by a synchronize
    in the step callback."""
    ends = []

    def mark(_step):
        torch.cuda.synchronize()
        ends.append(time.perf_counter())
    with step_losses() as losses:
        out = lm.train(cfg, steps=steps, batch=int(TRAINER_ENV["BATCH"]),
                       seq=int(TRAINER_ENV["SEQ"]), ckpt_dir=ckpt_dir,
                       checkpoint_every=0, step_callback=mark, group=group)
    return {**out, "losses": losses,
            "step_ms": [(b - a) * 1e3 for a, b in zip(ends, ends[1:])]}


def losses_agree(got: list, want: list, rtol: float) -> bool:
    """As many finite step losses as ``want``, each within ``rtol`` of
    it, relative."""
    return len(got) == len(want) and all(
        math.isfinite(g) and abs(g - w) <= rtol * abs(w)
        for g, w in zip(got, want))


def check_trainer_group() -> list:
    """``lm.train`` at full width, 2 layers, without a group and under a
    world-1 NCCL group (its gradient all-reduce, preemption verdict and
    barriers through NCCL on CUDA tensors): every step's loss within 1e-3
    relative. Returns the group run's losses."""
    cfg = trainer_cfg(2)
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        runs["no_group"] = timed_train(cfg, None, os.path.join(tmp, "a"),
                                       GROUP_STEPS)
        torch.cuda.empty_cache()
        rendezvous.init_process_group("127.0.0.1", free_port(), 0, 1, "nccl",
                                      timeout=120.0, bind_ip="127.0.0.1")
        try:
            runs["nccl_world_1"] = timed_train(cfg, dist.group.WORLD,
                                               os.path.join(tmp, "b"),
                                               GROUP_STEPS)
        finally:
            dist.destroy_process_group()
    torch.cuda.empty_cache()
    want, got = runs["no_group"]["losses"], runs["nccl_world_1"]["losses"]
    if len(want) != GROUP_STEPS or not losses_agree(got, want, 1e-3):
        raise AssertionError(f"trainer_group: losses {runs}")
    say("trainer_group", ok=True, n_layers=cfg.n_layers, steps=GROUP_STEPS,
        runs=runs, mean_step_ms={n: sum(r["step_ms"]) / len(r["step_ms"])
                                 for n, r in runs.items()})
    return got


def check_trainer_resume() -> None:
    """Two trainer processes at full width, 2 layers, on one checkpoint
    dir: 4 steps with a save every 2, then a resume to 6. Then one save
    and one resume of that state (2 layers, f32 params and AdamW), timed
    in this process."""
    env = gang_of_one(**{**TRAINER_ENV, "LM_LAYERS": "2"},
                      CHECKPOINT_EVERY="2")
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        ckpt_dir = os.path.join(tmp, "job")
        for total in (4, 6):
            t0 = time.perf_counter()
            proc = run_module("kubernetes_tpu_torch.workloads.trainer",
                              {**env, "CKPT_DIR": ckpt_dir,
                               "TOTAL_STEPS": str(total)})
            wall = time.perf_counter() - t0
            done = [ln for ln in proc.stdout.splitlines()
                    if ln.startswith("TRAINER DONE rank=0 ")]
            if proc.returncode != 0 or len(done) != 1:
                raise AssertionError(f"trainer_resume: exit {proc.returncode}"
                                     f", {done}: {_tail(proc)}")
            runs.append({"total_steps": total, "wall_s": wall,
                         "done": done[0]})
        records = []
        for start in (0, 4):
            with open(os.path.join(
                    ckpt_dir, f"attempt-rank0-start{start}.json")) as f:
                rec = json.load(f)
            records.append({k: rec[k] for k in
                            ("resumed_from", "final_step", "steps_run")})
        marker = read_marker(ckpt_dir)
        free_gb = shutil.disk_usage(tmp).free / 1e9
    if records != [{"resumed_from": 0, "final_step": 4, "steps_run": 4},
                   {"resumed_from": 4, "final_step": 6, "steps_run": 2}] \
            or marker != 5:
        raise AssertionError(f"trainer_resume: {records}, marker {marker}")

    cfg = trainer_cfg(2)

    def init():
        params, opt_state = lm.init_train_state(
            torch.Generator("cuda").manual_seed(0), cfg)
        return {"params": params, "opt_state": opt_state}
    with tempfile.TemporaryDirectory() as tmp:
        state = init()
        nbytes = sum(x.numel() * x.element_size()
                     for x in lm._leaves(state["params"])
                     + lm._leaves(state["opt_state"]["mu"])
                     + lm._leaves(state["opt_state"]["nu"]))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ckpt.save(0, state, tmp)
        save_s = time.perf_counter() - t0
        want = state["params"]["embed"].clone()
        del state
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        restored, start = ckpt.resume_or_init(tmp, init)
        torch.cuda.synchronize()
        resume_s = time.perf_counter() - t0
        if start != 1 or not torch.equal(restored["params"]["embed"], want):
            raise AssertionError("trainer_resume: the timed resume")
        del restored, want
    torch.cuda.empty_cache()
    say("trainer_resume", ok=True, runs=runs, records=records, marker=marker,
        disk_free_gb_after_runs=free_gb, state_gb=nbytes / 1e9,
        save_s=save_s, resume_s=resume_s)


#: The LM env names the reference controller leaves unset, so that the
#: trainer takes its defaults.
LM_ENV_NAMES = ("LM_VOCAB", "LM_D_MODEL", "LM_LAYERS", "LM_HEADS",
                "LM_D_FF", "LM_ATTN", "BATCH", "SEQ")
#: Steps of the trainer_default_lm phase.
DEFAULT_LM_STEPS = 4


def trainer_lm_runs(tmp: str, **lm_env) -> tuple[dict, lm.LMConfig]:
    """``trainer.main()`` as a gang of one under a TrainJob's env as the
    reference controller writes it, MODEL=lm and no ``LM_*`` but
    ``lm_env``, DEFAULT_LM_STEPS steps, through the flash kernels and
    with plain attention (``LM_ATTN=local``), each counted: ``{attn:
    {rc, losses, launches, attn_impl}}`` and the flash run's config."""
    runs, cfgs = {}, {}
    for attn in ("flash", "local"):
        env = gang_of_one(MODEL="lm", TOTAL_STEPS=str(DEFAULT_LM_STEPS),
                          CHECKPOINT_EVERY="0",
                          CKPT_DIR=os.path.join(tmp, attn), KTPU_SANDBOX=tmp,
                          **{**dict.fromkeys(LM_ENV_NAMES), **lm_env})
        if attn == "local":
            env["LM_ATTN"] = "local"
        with environ(env):
            cfgs[attn] = trainer.lm_config(torch.device("cuda"))
            with step_losses() as losses:
                zero_counters()
                rc = trainer.main()
                torch.cuda.synchronize()
                launches = counters()
        runs[attn] = {"rc": rc, "losses": losses, "launches": launches,
                      "attn_impl": cfgs[attn].attn_impl}
    return runs, cfgs["flash"]


def check_trainer_default_lm() -> dict:
    """A TrainJob's env as the reference controller writes it: MODEL=lm
    and no ``LM_*``, so head dim 16, through the flash kernels,
    counted; its loss must fall and stay within 1e-3 relative of the
    same trainer's with plain attention at every step, as in
    :func:`check_trainer_group` (bf16 rounds at other places in the
    two). Returns its launches."""
    with tempfile.TemporaryDirectory() as tmp:
        runs, cfg = trainer_lm_runs(tmp)
    flash, local = runs["flash"], runs["local"]
    want = causal_only(flash_attn_fwd=2 * cfg.n_layers * DEFAULT_LM_STEPS,
                       flash_attn_bwd=cfg.n_layers * DEFAULT_LM_STEPS)
    losses = flash["losses"]
    if flash["rc"] != 0 or flash["launches"] != want or cfg.head_dim != 16 \
            or len(losses) != DEFAULT_LM_STEPS or not losses[-1] < losses[0] \
            or not losses_agree(losses, local["losses"], 1e-3):
        raise AssertionError(f"trainer_default_lm: {runs}, want {want}, "
                             f"head dim {cfg.head_dim}")
    say("trainer_default_lm", ok=True, head_dim=cfg.head_dim,
        n_layers=cfg.n_layers, n_heads=cfg.n_heads, d_model=cfg.d_model,
        steps=DEFAULT_LM_STEPS, launches=flash["launches"],
        launches_per_step={k: v // DEFAULT_LM_STEPS
                           for k, v in flash["launches"].items()},
        losses=losses, plain_attention_losses=local["losses"])
    return flash["launches"]


def check_trainer_lm_d96() -> dict:
    """The TrainJob env at head dim 96 (``LM_D_MODEL=192 LM_HEADS=2``, the
    other ``LM_*`` the trainer's defaults): ``trainer.main()`` through the
    flash kernels, counted; its loss within 1e-3 relative of
    ``lm.train``'s in this process on the same config, batch and steps at
    every step, as :func:`check_trainer` holds the 600M trainer. Its
    losses beside the plain-attention trainer's are a reading of bf16
    rounding (the kernels at head dim 96 are held by ``head_dims`` and
    ``phi3``). Returns its launches."""
    with tempfile.TemporaryDirectory() as tmp:
        runs, cfg = trainer_lm_runs(tmp, LM_D_MODEL="192", LM_HEADS="2")
        with step_losses() as direct:
            lm.train(cfg, steps=DEFAULT_LM_STEPS, batch=4, seq=16,
                     ckpt_dir=os.path.join(tmp, "direct"),
                     checkpoint_every=0)
    flash, local = runs["flash"], runs["local"]
    want = causal_only(flash_attn_fwd=2 * cfg.n_layers * DEFAULT_LM_STEPS,
                       flash_attn_bwd=cfg.n_layers * DEFAULT_LM_STEPS)
    losses = flash["losses"]
    if flash["rc"] != 0 or flash["launches"] != want or cfg.head_dim != 96 \
            or not losses_agree(losses, direct, 1e-3):
        raise AssertionError(f"trainer_lm_d96: {runs}, lm.train {direct}, "
                             f"want {want}, head dim {cfg.head_dim}")
    say("trainer_lm_d96", ok=True, head_dim=cfg.head_dim,
        n_layers=cfg.n_layers, n_heads=cfg.n_heads, d_model=cfg.d_model,
        steps=DEFAULT_LM_STEPS, launches=flash["launches"], losses=losses,
        direct_train_losses=direct,
        plain_attention_losses=local["losses"],
        plain_attention_rel=[abs(g - w) / abs(w) for g, w in
                             zip(losses, local["losses"])])
    return flash["launches"]


def check_demo() -> None:
    """The counting demo on the card as a one-rank gang: the exact final
    value of 6 steps, sum(1 + s)."""
    total = 6
    proc = run_module("kubernetes_tpu_torch.workloads.distributed_demo",
                      gang_of_one(MODEL=None, TOTAL_STEPS=str(total),
                                  CKPT_DIR=None))
    want = float(sum(1 + s for s in range(total)))
    done = [ln for ln in proc.stdout.splitlines() if ln.startswith("DONE ")]
    if proc.returncode != 0 or done != [f"DONE rank=0 start=0 final={want}"]:
        raise AssertionError(f"demo: exit {proc.returncode}, {done}, want "
                             f"{want}: {_tail(proc)}")
    say("demo", ok=True, final=want, line=done[0])


#: One rank of the two-card data-parallel run: NCCL on the card that
#: CUDA_VISIBLE_DEVICES gives it, ``timed_train`` of this script at full
#: width, 2 layers; its result as the last line.
DP2_RANK = r"""
import json, os, torch
from torch import distributed as dist
import chip_smoke
from kubernetes_tpu_torch.workloads import rendezvous
torch.cuda.set_device(0)
rendezvous.init_process_group("127.0.0.1", int(os.environ["RANK_PORT"]),
                              int(os.environ["RANK_INDEX"]), 2, "nccl",
                              timeout=300.0, bind_ip="127.0.0.1")
out = chip_smoke.timed_train(chip_smoke.trainer_cfg(2), dist.group.WORLD,
                             os.environ["DP2_CKPT"], chip_smoke.GROUP_STEPS)
dist.destroy_process_group()
print(json.dumps(out))
"""


def check_trainer_dp2(world_1_losses: list) -> None:
    """Two ranks over NCCL, one card each, on the global batch of the
    world-1 run: every step's loss the same on both ranks and within
    5e-2 relative of the world-1 run's; their step times. Not run with
    one card."""
    if torch.cuda.device_count() < 2:
        say("trainer_dp2", skipped="one card")
        return
    with tempfile.TemporaryDirectory() as tmp:
        outs = run_ranks(DP2_RANK, 2, {"DP2_CKPT": tmp}, "trainer_dp2")
    losses = [o["losses"] for o in outs]
    if losses[0] != losses[1] or not losses_agree(losses[0], world_1_losses,
                                                  5e-2):
        raise AssertionError(f"trainer_dp2: losses {losses}, world 1 "
                             f"{world_1_losses}")
    say("trainer_dp2", ok=True, losses=losses[0],
        world_1_losses=world_1_losses,
        step_ms=[o["step_ms"] for o in outs])


def lm_sp_cfg(n_layers: int) -> lm.LMConfig:
    """The 600M LM at ``chip_bench``'s widths, bf16 params with an f32
    master, the reference's default attention (the ring)."""
    return lm.LMConfig(vocab=32768, d_model=2048, n_layers=n_layers,
                       n_heads=16, d_ff=8192, param_dtype=torch.bfloat16)


def timed_steps(cfg: lm.LMConfig, batch: int, seq: int, mesh=None,
                device="cuda", attention=None) -> dict:
    """LM_SP_STEPS train steps from the params of seed 0 (each rank its
    blocks, ``lm.init_sharded``) on the global batch of seed 1, with
    ``attention`` (default ``cfg.attn_impl``'s), every counter set to 0
    just before and read just after: each step's loss (read at once, so
    the host clock between reads is the step time), the host time until
    the step returns (its enqueue: where it is close to the step time,
    the host sets the pace), the peak memory and the steps' seconds."""
    params, opt_state = lm.init_sharded(
        torch.Generator(device).manual_seed(0), cfg, mesh)
    tokens = lm.synthetic_batch(torch.Generator(device).manual_seed(1), cfg,
                                batch, seq, device)
    step = lm.make_train_step(cfg, device=device, mesh=mesh,
                              attention=attention)
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    losses, ends, host_ms = [], [time.perf_counter()], []
    zero_counters()
    for _ in range(LM_SP_STEPS):
        params, opt_state, loss = step(params, opt_state, tokens)
        host_ms.append((time.perf_counter() - ends[-1]) * 1e3)
        losses.append(float(loss))
        ends.append(time.perf_counter())
    launches = counters()
    return {"losses": losses, "launches": launches,
            "step_ms": [(b - a) * 1e3 for a, b in zip(ends, ends[1:])],
            "host_ms": host_ms, "seconds": ends[-1] - ends[0],
            "peak_memory_gb": (torch.cuda.max_memory_allocated() / 1e9
                               if device == "cuda" else None)}


def lm_f32(cfg: lm.LMConfig) -> lm.LMConfig:
    """``cfg`` with f32 params and compute: the witness of a mesh run."""
    return dataclasses.replace(cfg, param_dtype=torch.float32,
                               compute_dtype=torch.float32)


def ring_overlap(mesh, block: tuple, device="cuda") -> dict:
    """On this rank of ``mesh``'s sp ring, at one layer's [B, H, Tl, D]
    bf16 block: the time of one K/V rotation alone, of the rank's blocks
    forward and backward without a rotation (its attention time), and of
    the ring forward and backward; ``hidden_share`` is how much of the
    ring's sp - 1 rotations the kernels hide (1 when the ring costs no
    more than its blocks); ``ring_forward_host_ms`` the host's time per
    ring forward, back to back."""
    ring = ra.ring_of(mesh)
    gen = torch.Generator(device).manual_seed(2 + ring.index)
    q, k, v, do = (torch.randn(block, generator=gen, device=device)
                   .to(torch.bfloat16) for _ in range(4))
    o, lse = ra.ring_forward(q, k, v, ring)
    i, n = ring.index, ring.size
    held = [(k, v)] * n  # this rank's own block in place of each
    row = {
        "rotation_ms": time_ms(
            lambda: ra.received(ra.rotate(ring, (k, v), (0, 1))), 10),
        "blocks_forward_ms": time_ms(
            lambda: ra.rank_forward(q, held, i, n), 10),
        "ring_forward_ms": time_ms(lambda: ra.ring_forward(q, k, v, ring),
                                   10),
        "blocks_backward_ms": time_ms(
            lambda: rank_backward(q, held, o, lse, do, i, n), 10),
        "ring_backward_ms": time_ms(
            lambda: ra.ring_backward(q, k, v, o, lse, do, ring), 10),
        "ring_forward_host_ms": host_us(
            lambda: ra.ring_forward(q, k, v, ring), ATTN_HOST_CALLS) / 1e3}
    exposed = row["ring_forward_ms"] - row["blocks_forward_ms"]
    row["hidden_share"] = 1 - exposed / ((n - 1) * row["rotation_ms"])
    return row


def mesh_witness(cfg: lm.LMConfig, run: dict, mesh, device="cuda") -> dict:
    """The witness of a mesh run: the same LM_SP_STEPS steps in f32
    (params and compute) with the ring's plain version
    (``ring_attention.gathered_attention``, which never enters the ring);
    its losses and seconds."""
    ring = ra.ring_of(mesh)
    out = timed_steps(lm_f32(cfg), run["batch"], run["seq"], mesh, device,
                      lambda q, k, v: ra.gathered_attention(q, k, v, ring))
    torch.cuda.empty_cache()
    return {"f32_losses": out["losses"], "f32_seconds": out["seconds"]}


def mesh_f32_ring(steps, cfg, run: dict, mesh, device="cuda") -> dict:
    """A mesh run's f32 reading through the real ring: ``steps``
    (:func:`timed_steps` or :func:`moe_steps`) of ``cfg`` in f32 over
    ``mesh`` with the default attention, the ring of the kernels' f32
    instances; its losses, launches and seconds."""
    out = steps(cfg, run["batch"], run["seq"], mesh, device)
    torch.cuda.empty_cache()
    return {"f32_ring_losses": out["losses"],
            "f32_ring_launches": out["launches"],
            "f32_ring_seconds": out["seconds"]}


def f32_ring_reading(ranks: list, one: dict, layers: int) -> dict:
    """The f32 reading through the real ring (:func:`mesh_f32_ring`) of
    every rank of a mesh run, each counted: ``layers`` (layers x steps)
    gives 2 x layers causal f32 forward launches and layers backward, and
    the rank at sp index i i times those non-causal. ``one`` holds one
    card's f32 steps of the same config and batch: ``f32_kernels``
    (through the kernels' f32 instances, the mesh's own attention
    arithmetic), ``f32`` (plain f32 attention) and ``f64`` (plain
    attention in f64). ``ok`` needs the losses the same on every rank,
    within RING_F32_RTOL relative of ``f32_kernels`` at the first
    RING_F32_STEPS steps (so the reading sees the layout alone: a block,
    a merge, a sum), and within :func:`f32_steps_rule` of ``f32`` and
    ``f64`` at every step, the rule ``lm_f32`` holds one card's kernel
    path to. The distance from ``f32`` is reported beside. Raises on a
    wrong count. Returns the losses, their distances, the bound of each
    step held to ``f32_kernels`` (None where the rule alone holds), the
    rule's reading, the slowest rank's seconds and ``ok``."""
    for out in ranks:
        i = out["coordinate"]["sp"]
        want = causal_only(flash_attn_fwd_f32=2 * layers,
                           flash_attn_bwd_f32=layers,
                           flash_attn_fwd_f32_non_causal=2 * layers * i,
                           flash_attn_bwd_f32_non_causal=layers * i)
        if out["f32_ring_launches"] != want:
            raise AssertionError(f"rank {out['rank']}: f32 ring launches "
                                 f"{out['f32_ring_launches']}, want {want}")
    losses = ranks[0]["f32_ring_losses"]

    def rel(a, b):
        return [abs(g - w) / abs(w) for g, w in zip(a, b)]
    kernels = one["f32_kernels"]["losses"]
    bound = [RING_F32_RTOL if s < RING_F32_STEPS else None
             for s in range(len(kernels))]
    rule = f32_steps_rule(losses, one["f32"]["losses"], one["f64"]["losses"])
    ok = (len(losses) == len(kernels) and all(map(math.isfinite, losses))
          and all(b is None or r <= b
                  for r, b in zip(rel(losses, kernels), bound))
          and rule["ok"]
          and all(out["f32_ring_losses"] == losses for out in ranks))
    return {"losses": losses, "rel": rel(losses, kernels), "bound": bound,
            "reference": "one card's f32 steps through the kernels",
            "rel_to_plain_f32": rel(losses, one["f32"]["losses"]),
            "steps_rule": rule, "ok": ok,
            "seconds": max(out["f32_ring_seconds"] for out in ranks)}


def lm_sp_rank(run: dict, device="cuda") -> dict:
    """One rank of an lm_sp run (``run``: dp, sp, n_layers, batch, seq)
    in a process group of ``dp * sp`` ranks: LM_SP_STEPS train steps over
    a dp x sp mesh, their f32 witness (:func:`mesh_witness`), the f32
    steps through the ring (:func:`mesh_f32_ring`), then
    :func:`ring_overlap` at one layer's block."""
    cfg = lm_sp_cfg(run["n_layers"])
    mesh = sharding.make_mesh(device_type=device, dp=run["dp"],
                              sp=run["sp"])
    out = timed_steps(cfg, run["batch"], run["seq"], mesh, device)
    torch.cuda.empty_cache()
    out.update(mesh_witness(cfg, run, mesh, device))
    out.update(mesh_f32_ring(timed_steps, lm_f32(cfg), run, mesh, device))
    block = (run["batch"] // run["dp"], cfg.n_heads,
             run["seq"] // run["sp"], cfg.head_dim)
    return {"rank": dist.get_rank(), "coordinate": dict(zip(
        mesh.mesh_dim_names, mesh.get_coordinate())), **out,
        **ring_overlap(mesh, block, device)}


#: One rank of a mesh run: NCCL on the card that CUDA_VISIBLE_DEVICES
#: gives it, in a group of RANK_WORLD ranks, the function RANK_FN of this
#: script (``lm_sp_rank``, ``lm_fsdp_tp_rank``, ``moe_ep_rank``) on the
#: run RANK_RUN; its result as the last line.
MESH_RANK = r"""
import json, os, torch
from torch import distributed as dist
import chip_smoke
from kubernetes_tpu_torch.workloads import rendezvous
torch.cuda.set_device(0)
rendezvous.init_process_group("127.0.0.1", int(os.environ["RANK_PORT"]),
                              int(os.environ["RANK_INDEX"]),
                              int(os.environ["RANK_WORLD"]), "nccl",
                              timeout=300.0, bind_ip="127.0.0.1")
out = getattr(chip_smoke, os.environ["RANK_FN"])(
    json.loads(os.environ["RANK_RUN"]))
dist.destroy_process_group()
print(json.dumps(out))
"""


def run_ranks(script: str, world: int, env: dict, what: str) -> list:
    """``script`` as ``world`` rank processes, one card each, waited on
    with a timeout and killed at it; each one's last line as JSON."""
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", script],
        cwd=os.path.dirname(os.path.abspath(__file__)),
        env={**os.environ, **env, "CUDA_VISIBLE_DEVICES": str(r),
             "RANK_INDEX": str(r), "RANK_PORT": str(port)},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]
    outs = []
    try:
        for proc in procs:
            out, err = proc.communicate(timeout=SUBPROCESS_TIMEOUT)
            if proc.returncode != 0:
                raise AssertionError(f"{what}: exit {proc.returncode}: "
                                     f"{err[-3000:]}")
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    return outs


def run_mesh(fn: str, run: dict, world: int) -> list:
    """:data:`MESH_RANK` of ``fn`` on ``run`` as ``world`` rank
    processes, one card each; each one's result."""
    return run_ranks(MESH_RANK, world, {
        "RANK_FN": fn, "RANK_RUN": json.dumps(run),
        "RANK_WORLD": str(world)}, f"{fn} {run['name']}")


def lm_sp_runs(cards: int) -> list:
    """The lm_sp runs a host of ``cards`` takes: sp = 2 at full depth,
    B1 T8192; with four cards, also sp = 4 and dp = 2 x sp = 2 at 2
    layers (dp = 2 on a global batch of 2)."""
    runs = [dict(name="sp2", dp=1, sp=2, n_layers=8, batch=1, seq=8192)]
    if cards >= 4:
        runs += [dict(name="sp4", dp=1, sp=4, n_layers=2, batch=1, seq=8192),
                 dict(name="dp2sp2", dp=2, sp=2, n_layers=2, batch=2,
                      seq=8192)]
    return runs


def mesh_gate(mesh: dict, one: dict) -> dict:
    """The gate of one mesh run of lm_sp, lm_fsdp_tp or moe_ep, on its
    losses by step. ``mesh`` holds the mesh's ``bf16`` steps (through the
    kernels) and its ``f32`` witness; ``one`` one card's steps of the
    same config and batch in three paths: ``bf16`` (the flash kernels),
    ``plain`` (plain attention in their place, bf16) and ``f32`` (plain
    attention, f32 compute).

    - Step 1: the bf16 mesh within 1e-3 relative of one card's bf16 step.
    - Every step: the witness within 1e-4 relative of one card's f32
      step, where a fault of the layout (a block, a gather, a sum, a
      route) shows.
    - After step 1, the floored drift rule: the bf16 mesh no further from
      one card's f32 step than twice ``scale``, the larger distance from
      it of one card's two bf16 paths, which differ only in rounding. One
      path alone can land near f32 by chance and give no floor; two
      rarely both do.

    Returns the numbers and ``ok``."""
    bf, f, one_f = mesh["bf16"], mesh["f32"], one["f32"]
    n = len(one_f)
    row = {"step1_rel": abs(bf[0] - one["bf16"][0]) / abs(one["bf16"][0]),
           "f32_rel": [abs(g - w) / abs(w) for g, w in zip(f, one_f)],
           "bf16_from_f32": [abs(g - w) for g, w in zip(bf, one_f)],
           "one_card_from_f32": {p: [abs(g - w) for g, w in zip(one[p],
                                                                one_f)]
                                 for p in ("bf16", "plain")}}
    row["scale"] = [max(row["one_card_from_f32"][p][s]
                        for p in ("bf16", "plain")) for s in range(n)]
    row["drift_share"] = [m / (2 * s) if s else math.inf
                          for m, s in zip(row["bf16_from_f32"],
                                          row["scale"])][1:]
    row["ok"] = (
        len(bf) == len(f) == n == len(one["bf16"]) == len(one["plain"])
        and all(map(math.isfinite, bf + f))
        and row["step1_rel"] <= 1e-3
        and all(r <= 1e-4 for r in row["f32_rel"])
        and all(m <= 2 * s for m, s in zip(row["bf16_from_f32"][1:],
                                           row["scale"][1:])))
    return row


def lm_one_card(cfg: lm.LMConfig, batch: int, seq: int) -> dict:
    """One card's LM_SP_STEPS steps of ``cfg`` on the global batch in the
    three paths :func:`mesh_gate` reads (``bf16``, ``plain``, ``f32``)
    and in f32 through the kernels (``f32_kernels``) and with plain
    attention in f64 (``f64``), which :func:`f32_ring_reading` holds the
    mesh's f32 steps against, each :func:`timed_steps`' result."""
    paths = {"bf16": (dataclasses.replace(cfg, attn_impl="flash"), None),
             "plain": (dataclasses.replace(cfg, attn_impl="local"), None),
             "f32": (dataclasses.replace(lm_f32(cfg), attn_impl="local"),
                     None),
             "f32_kernels": (lm_f32(cfg), None),
             "f64": (lm_f32(cfg), attention_f64)}
    out = {}
    for name, (path, attention) in paths.items():
        out[name] = timed_steps(path, batch, seq, attention=attention)
        torch.cuda.empty_cache()
    return out


def check_lm_mesh(phase: str, runs: list, rank_fn: str, rank_keys: tuple,
                  peak: float, known: bool, failed: list) -> dict:
    """The LM (``lm_sp_cfg``: bf16 params with an f32 master, the ring)
    over NCCL in each of ``runs`` (the four axis sizes, n_layers, batch,
    seq), rank processes of ``rank_fn``, counted on every rank: 2 x
    layers ring forwards and layers ring backwards a step, the rank at
    sp index i launching i + 1 blocks each (i of them non-causal). Its
    losses the same on every rank and held by :func:`mesh_gate` against
    one card's steps of the same config and batch (seeds 0 and 1,
    :func:`lm_one_card`); beside it the f32 steps through the real ring,
    counted, within RING_F32_RTOL of one card's f32 steps through the
    kernels at the first RING_F32_STEPS steps and within
    :func:`f32_steps_rule` at every step (:func:`f32_ring_reading`).
    Step ms,
    tokens/s and MFU per card against one card's, peak memory per card,
    the witness's seconds and each rank's ``rank_keys``. A run whose losses miss is reported and added to
    ``failed``, which fails the smoke after its last phase; a wrong
    launch count raises at once. Returns the launches over all ranks."""
    total = dict.fromkeys(counters(), 0)
    ones = {}
    for run in runs:
        cfg = lm_sp_cfg(run["n_layers"])
        key = (run["n_layers"], run["batch"], run["seq"])
        if key not in ones:
            ones[key] = lm_one_card(cfg, run["batch"], run["seq"])
        one = ones[key]
        world = math.prod(run.get(a, 1) for a in sharding.AXES)
        ranks = run_mesh(rank_fn, run, world)
        for out in ranks:
            i, layers = out["coordinate"]["sp"], cfg.n_layers * LM_SP_STEPS
            want = causal_only(
                flash_attn_fwd=2 * layers, flash_attn_bwd=layers,
                flash_attn_fwd_non_causal=2 * layers * i,
                flash_attn_bwd_non_causal=layers * i)
            if out["launches"] != want:
                raise AssertionError(f"{phase} {run['name']} rank "
                                     f"{out['rank']}: launches "
                                     f"{out['launches']}, want {want}")
            for k, count in out["launches"].items():
                total[k] += count
        losses = {"bf16": ranks[0]["losses"], "f32": ranks[0]["f32_losses"]}
        gate = mesh_gate(losses, {p: one[p]["losses"] for p in one})
        ring = f32_ring_reading(ranks, one, cfg.n_layers * LM_SP_STEPS)
        for out in ranks:
            for k, count in out["f32_ring_launches"].items():
                total[k] += count
        ok = gate["ok"] and ring["ok"] and all(
            out["losses"] == losses["bf16"]
            and out["f32_losses"] == losses["f32"] for out in ranks)
        if not ok:
            failed.append(f"{phase} {run['name']}: {losses}, gate {gate}, "
                          f"f32 ring {ring}")
        ms = max(sum(out["step_ms"][1:]) / (LM_SP_STEPS - 1)
                 for out in ranks)
        one_ms = sum(one["bf16"]["step_ms"][1:]) / (LM_SP_STEPS - 1)
        ntok = run["batch"] * run["seq"]
        case = chip_bench.BenchCase(run["name"], cfg.d_model, cfg.n_layers,
                                    cfg.n_heads, cfg.d_ff, cfg.vocab,
                                    run["batch"], run["seq"])
        flops = chip_bench.train_flops_per_token(case) * ntok
        say(phase, ok=ok, **run, cards=world, losses=losses["bf16"],
            f32_losses=losses["f32"],
            one_card_losses={p: one[p]["losses"] for p in one}, gate=gate,
            f32_ring=ring,
            f32_seconds=max(out["f32_seconds"] for out in ranks),
            one_card_f32_seconds=one["f32"]["seconds"],
            one_card_host_ms=one["bf16"]["host_ms"],
            step_ms=ms, one_card_step_ms=one_ms,
            step_timed="steps 2-3, host clock to each loss's read, slowest "
            "rank", tokens_per_s_per_card=ntok / (ms * 1e-3) / world,
            one_card_tokens_per_s=ntok / (one_ms * 1e-3),
            mfu_per_card=flops / (ms * 1e-3) / world / peak,
            one_card_mfu=flops / (one_ms * 1e-3) / peak, peak_known=known,
            one_card_peak_memory_gb=one["bf16"]["peak_memory_gb"],
            ranks=[{k: out[k] for k in (
                "rank", "coordinate", "step_ms", "host_ms", "peak_memory_gb",
                "launches", *rank_keys)} for out in ranks])
        torch.cuda.empty_cache()
    return total


def check_lm_sp(peak: float, known: bool, failed: list) -> dict:
    """With two cards or more, the 600M LM sequence-parallel over NCCL
    (:func:`lm_sp_runs`, rank processes of :func:`lm_sp_rank`) under
    :func:`check_lm_mesh`, with each rank's attention and K/V rotation
    times (a run that misses goes to ``failed``). With one card, a line
    that says it was not run. Returns the launches over all ranks."""
    if torch.cuda.device_count() < 2:
        say("lm_sp", skipped="one card")
        return dict.fromkeys(counters(), 0)
    return check_lm_mesh(
        "lm_sp", lm_sp_runs(torch.cuda.device_count()), "lm_sp_rank",
        ("rotation_ms", "blocks_forward_ms", "ring_forward_ms",
         "ring_forward_host_ms", "blocks_backward_ms", "ring_backward_ms",
         "hidden_share"), peak, known, failed)


def lm_fsdp_tp_runs(cards: int) -> list:
    """The lm_fsdp_tp runs a host of ``cards`` takes, each the 600M LM at
    full width and depth, B4 T2048: fsdp = 2 and tp = 2; with four cards
    also fsdp = 2 x tp = 2 and ``default_axis_sizes(4)`` (sp = 2 x tp =
    2)."""
    one = dict(dp=1, fsdp=1, sp=1, tp=1, n_layers=8, batch=4, seq=2048)
    runs = [dict(one, name="fsdp2", fsdp=2), dict(one, name="tp2", tp=2)]
    if cards >= 4:
        runs += [dict(one, name="fsdp2tp2", fsdp=2, tp=2),
                 dict(one, name="sp2tp2", **sharding.default_axis_sizes(4))]
    return runs


def layer_collectives_ms(cfg: lm.LMConfig, mesh, params: dict, rows: int,
                         positions: int, device="cuda") -> dict:
    """The collectives of one layer's forward on this rank, by CUDA
    events: the fsdp all-gather of its sharded weights (``params``' layer
    0), and the tp pair's two f32 all-reduces of a [rows, positions,
    d_model] activation (the attention's and the FFN's partial sums);
    None for an axis of one rank."""
    lay = lm.layout(cfg, mesh)
    row = {"fsdp_gather_ms": None, "fsdp_gather_bytes": None,
           "tp_allreduce_ms": None, "tp_allreduce_bytes": None}
    if lay.fsdp is not None:
        weights = [(params["layers"][k][0], d)
                   for k, d in lm._FSDP_DIMS.items() if d is not None]
        row["fsdp_gather_ms"] = time_ms(lambda: [
            collectives.all_gather(w, lay.fsdp, d) for w, d in weights], 10)
        row["fsdp_gather_bytes"] = sharding.mesh_sizes(mesh)["fsdp"] * sum(
            w.numel() * w.element_size() for w, _ in weights)
    if lay.tp is not None:
        x = torch.randn((rows, positions, cfg.d_model), device=device,
                        generator=torch.Generator(device).manual_seed(3))
        row["tp_allreduce_ms"] = time_ms(
            lambda: [collectives.all_reduce(x, (lay.tp,)) for _ in range(2)],
            10)
        row["tp_allreduce_bytes"] = 2 * x.numel() * x.element_size()
    return row


def lm_fsdp_tp_rank(run: dict, device="cuda") -> dict:
    """One rank of an lm_fsdp_tp run (``run``: the four axis sizes,
    n_layers, batch, seq): LM_SP_STEPS bf16 train steps over the mesh
    through the kernels (:func:`timed_steps`, counted; each rank its
    blocks of params, master and AdamW state), their f32 witness
    (:func:`mesh_witness`), the f32 steps through the ring
    (:func:`mesh_f32_ring`), then :func:`layer_collectives_ms`."""
    cfg = lm_sp_cfg(run["n_layers"])
    sizes = {a: run[a] for a in sharding.AXES}
    mesh = sharding.make_mesh(device_type=device, **sizes)
    out = timed_steps(cfg, run["batch"], run["seq"], mesh, device)
    torch.cuda.empty_cache()
    out.update(mesh_witness(cfg, run, mesh, device))
    out.update(mesh_f32_ring(timed_steps, lm_f32(cfg), run, mesh, device))
    params, _ = lm.init_sharded(torch.Generator(device).manual_seed(0),
                                dataclasses.replace(cfg, n_layers=1), mesh)
    out.update(layer_collectives_ms(
        cfg, mesh, params, run["batch"] // (sizes["dp"] * sizes["fsdp"]),
        run["seq"] // sizes["sp"], device))
    return {"rank": dist.get_rank(), "coordinate": dict(zip(
        mesh.mesh_dim_names, mesh.get_coordinate())), **out}


def check_lm_fsdp_tp(peak: float, known: bool, failed: list) -> dict:
    """With two cards or more, the 600M LM with params sharded over fsdp
    and heads and FFN columns over tp, over NCCL (:func:`lm_fsdp_tp_runs`,
    rank processes of :func:`lm_fsdp_tp_rank`) under
    :func:`check_lm_mesh`, with each rank's collectives per layer (a run
    that misses goes to ``failed``). With one card, a line that says it
    was not run. Returns the launches over all ranks."""
    if torch.cuda.device_count() < 2:
        say("lm_fsdp_tp", skipped="one card")
        return dict.fromkeys(counters(), 0)
    return check_lm_mesh(
        "lm_fsdp_tp", lm_fsdp_tp_runs(torch.cuda.device_count()),
        "lm_fsdp_tp_rank", ("fsdp_gather_ms", "fsdp_gather_bytes",
                            "tp_allreduce_ms", "tp_allreduce_bytes"),
        peak, known, failed)


def moe_cfg(n_layers: int) -> moe.MoEConfig:
    """The full-width MoE: the 600M bench widths with ``MoEConfig``'s own
    expert defaults (4 experts, top-2, capacity factor 1.25), f32 params,
    bf16 compute."""
    return moe.MoEConfig(n_layers=n_layers, **chip_bench.MOE_WIDTHS)


def moe_gate(params, tokens, cfg, what: str, **kwargs) -> list[dict]:
    """:func:`moe_layer_gate` on the card, raising when a layer fails."""
    rows = moe_layer_gate(params, tokens, cfg, **kwargs)
    for row in rows:
        if not row["ok"]:
            raise AssertionError(f"moe {what}: layer gate fails: {row}")
    return rows


def moe_losses_agree(got: float, plain: float, what: str) -> None:
    if not (math.isfinite(got) and abs(got - plain)
            <= MOE_LOSS_RTOL * abs(plain)):
        raise AssertionError(f"moe {what}: loss {got} against the plain "
                             f"bf16 forward's {plain}")


def check_moe(peak: float, known: bool) -> dict:
    """The MoE on one card. (a) ``MoEConfig()`` at B4 T512: the forward
    through the flash kernels (head dim 32), counted, under the layer
    gate against the plain bf16 and f32 paths on the CPU, and its loss
    against the CPU's plain forward. (b) :func:`moe_cfg` at full depth,
    B4 T2048: the forward counted (n_layers launches), timed, gated layer
    by layer against the plain bf16 and f32 paths on the card, its loss
    against the plain bf16 forward's; then MOE_STEPS train steps on one
    batch, the first counted (2 x n_layers forward and n_layers backward
    launches under remat), the loss falling, steps 3-5 timed by CUDA
    events, and the peak memory. Rates of both: MFU from the model's
    FLOPs and the executed matmul rate (``chip_bench.moe_flops``).
    Returns the launches of the counted runs."""
    total = dict.fromkeys(counters(), 0)

    def counted(fn, want: dict, what: str):
        torch.cuda.synchronize()
        zero_counters()
        out = fn()
        torch.cuda.synchronize()
        launches = counters()
        if launches != want:
            raise AssertionError(f"moe {what}: launches {launches}, want "
                                 f"{want}")
        for key, n in launches.items():
            total[key] += n
        return out

    small = moe.MoEConfig()
    params = moe.init_params(torch.Generator("cuda").manual_seed(0), small)
    batch = moe.synthetic_batch(torch.Generator("cuda").manual_seed(1), small,
                                *MOE_SMALL_BATCH)
    cpu = lm._tree_map(lambda p: p.cpu(), params)
    logits, aux = counted(lambda: moe.make_forward(small)(params,
                                                          batch[:, :-1]),
                          causal_only(flash_attn_fwd=small.n_layers),
                          "MoEConfig() forward")
    gate = moe_gate(params, batch[:, :-1], small, "MoEConfig()",
                    plain_params=cpu)
    with torch.inference_mode():
        loss = float(moe.loss_fn(params, batch, small))
        plain_loss = float(moe.loss_fn(cpu, batch.cpu(), small))
    moe_losses_agree(loss, plain_loss, "MoEConfig()")
    say("moe", config="MoEConfig()", ok=True, batch=MOE_SMALL_BATCH[0],
        seq=MOE_SMALL_BATCH[1], head_dim=small.head_dim,
        shape=list(logits.shape), aux=float(aux), loss=loss,
        plain_cpu_loss=plain_loss, layer_gate=gate)
    del params, cpu, logits

    cfg = moe_cfg(8)
    b, t = MOE_BATCH
    params = moe.init_params(torch.Generator("cuda").manual_seed(0), cfg)
    batch = moe.synthetic_batch(torch.Generator("cuda").manual_seed(1), cfg,
                                b, t)
    tokens = batch[:, :-1]
    forward = moe.make_forward(cfg)
    logits, aux = counted(lambda: forward(params, tokens),
                          causal_only(flash_attn_fwd=cfg.n_layers),
                          "full-width forward")
    if logits.shape != (b, t, cfg.vocab) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"moe logits {tuple(logits.shape)}, finite="
                             f"{bool(torch.isfinite(logits).all())}")
    del logits
    torch.cuda.empty_cache()
    flops = chip_bench.moe_flops(cfg, b, t)
    fwd_ms = time_ms(lambda: forward(params, tokens), 3)
    with torch.inference_mode():
        plain_ms = time_ms(lambda: moe.forward(
            params, tokens, cfg, attention=ra.reference_attention), 1, 1)
    gate = moe_gate(params, tokens, cfg, "full width",
                    plain_attention=ra.reference_attention)
    with torch.inference_mode():
        loss = float(moe.loss_fn(params, batch, cfg))
        plain_loss = float(moe.loss_fn(params, batch, cfg,
                                       attention=ra.reference_attention))
    moe_losses_agree(loss, plain_loss, "full width")
    torch.cuda.empty_cache()

    opt_state = moe.make_optimizer().init(params)
    step = moe.make_train_step(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params, opt_state, first = counted(
        lambda: step(params, opt_state, batch),
        causal_only(flash_attn_fwd=2 * cfg.n_layers,
                    flash_attn_bwd=cfg.n_layers), "train step")
    losses = [first]
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for i in range(1, MOE_STEPS):
        if i == MOE_WARM:
            start.record()
        params, opt_state, loss_i = step(params, opt_state, batch)
        losses.append(loss_i)
    end.record()
    end.synchronize()
    step_ms = start.elapsed_time(end) / (MOE_STEPS - MOE_WARM)
    losses = [float(x) for x in losses]
    if not (all(map(math.isfinite, losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"moe: loss does not fall: {losses}")
    ntok = b * t
    say("moe", config="600M widths, 4 experts, top-2", ok=True, batch=b,
        seq=t, n_layers=cfg.n_layers, head_dim=cfg.head_dim,
        params=sum(p.numel() for p in lm._leaves(params)),
        capacity=flops["capacity"], aux=float(aux), loss=loss,
        plain_attention_loss=plain_loss, layer_gate=gate,
        launches_per_forward=cfg.n_layers,
        launches_per_step={"flash_attn_fwd": 2 * cfg.n_layers,
                           "flash_attn_bwd": cfg.n_layers},
        forward_ms=fwd_ms, plain_attention_forward_ms=plain_ms,
        forward_tokens_per_s=ntok / (fwd_ms * 1e-3),
        forward_executed_flops=flops["executed"],
        forward_model_flops=flops["model"],
        executed_flops_per_layer=flops["executed_per_layer"],
        model_flops_per_layer=flops["model_per_layer"],
        unembed_flops=flops["unembed"],
        forward_exec_tflops=flops["executed"] / (fwd_ms * 1e-3) / 1e12,
        forward_exec_share_of_peak=flops["executed"] / (fwd_ms * 1e-3)
        / peak,
        forward_mfu=flops["model"] / (fwd_ms * 1e-3) / peak,
        step_ms=step_ms, step_timed=f"steps {MOE_WARM + 1}-{MOE_STEPS}, "
        "CUDA events", tokens_per_s=ntok / (step_ms * 1e-3),
        step_executed_flops=3 * flops["executed"],
        step_executed_flops_with_remat=4 * flops["executed"],
        step_model_flops=3 * flops["model"],
        step_exec_tflops=3 * flops["executed"] / (step_ms * 1e-3) / 1e12,
        step_exec_share_of_peak=3 * flops["executed"] / (step_ms * 1e-3)
        / peak,
        mfu=3 * flops["model"] / (step_ms * 1e-3) / peak,
        peak_known=known,
        peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
        losses=losses)
    del params, opt_state, step, batch
    torch.cuda.empty_cache()
    return total


def check_moe_f32() -> dict:
    """``MoEConfig()`` (head dim 32: the W-32 f32 instances) in f32
    compute at MOE_SMALL_BATCH on one card, through the kernels' f32
    instances. The forward counted (one causal f32 launch a layer); each
    layer under :func:`moe_gate` with its f32-kernel path (the layer's
    output and its attention's within F32_RULE of the bf16 kernel path's
    deviation from plain f32 attention); the loss within F32_LOSS_RTOL of
    plain f32 attention's; one train step counted (2 x layers forward and
    layers backward f32 launches), its loss within F32_LOSS_RTOL of the
    same step with plain f32 attention. Then the MoE at
    ``chip_bench.MOE_WIDTHS`` (head dim 128) in f32 at MOE_BATCH:
    MOE_EP_STEPS train steps through the kernels, counted, against the
    same steps with plain f32 and with f64 attention under
    :func:`f32_steps_rule`, and every step within F32_LOSS_RTOL of plain
    f32. Returns the launches."""
    small = moe.MoEConfig()
    cfg = f32(small)
    b, t = MOE_SMALL_BATCH
    batch = moe.synthetic_batch(torch.Generator("cuda").manual_seed(1), cfg,
                                b, t)
    tokens = batch[:, :-1]
    params = moe.init_params(torch.Generator("cuda").manual_seed(0), cfg)
    total = dict.fromkeys(counters(), 0)
    torch.cuda.synchronize()
    zero_counters()
    logits, aux = moe.make_forward(cfg)(params, tokens)
    torch.cuda.synchronize()
    launches = counters()
    want = causal_only(flash_attn_fwd_f32=cfg.n_layers)
    if launches != want or logits.shape != (b, t, cfg.vocab) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"moe_f32 forward: {tuple(logits.shape)}, "
                             f"launches {launches}, want {want}")
    for key, count in launches.items():
        total[key] += count
    gate = moe_gate(params, tokens, small, "MoEConfig() f32",
                    plain_attention=ra.reference_attention, f32_kernels=True)
    with torch.inference_mode():
        loss = float(moe.loss_fn(params, batch, cfg))
        plain_loss = float(moe.loss_fn(params, batch, cfg,
                                       attention=ra.reference_attention))
    steps = {}
    for name, attention in (("kernels", None),
                            ("plain", ra.reference_attention)):
        p = moe.init_params(torch.Generator("cuda").manual_seed(0), cfg)
        step = moe.make_train_step(cfg, attention=attention)
        torch.cuda.synchronize()
        zero_counters()
        _, _, step_loss = step(p, moe.make_optimizer().init(p), batch)
        steps[name] = float(step_loss)
        torch.cuda.synchronize()
        if name == "kernels":
            launches = counters()
            want = causal_only(flash_attn_fwd_f32=2 * cfg.n_layers,
                               flash_attn_bwd_f32=cfg.n_layers)
            if launches != want:
                raise AssertionError(f"moe_f32 step: launches {launches}, "
                                     f"want {want}")
            for key, count in launches.items():
                total[key] += count
    rel = {"forward": abs(loss - plain_loss) / abs(plain_loss),
           "step": abs(steps["kernels"] - steps["plain"])
           / abs(steps["plain"])}
    logits_shape, aux = logits.shape, float(aux)
    if not all(math.isfinite(x) and r <= F32_LOSS_RTOL
               for x, r in ((loss, rel["forward"]),
                            (steps["kernels"], rel["step"]))):
        raise AssertionError(f"moe_f32 losses: forward {loss} against "
                             f"{plain_loss}, step {steps}")
    del params, logits
    torch.cuda.empty_cache()

    # The full-width MoE (head dim 128) in f32, whose train steps
    # amplify the attention's rounding: MOE_EP_STEPS steps through the
    # kernels beside plain f32 and f64 attention, from the same params
    # and batch.
    full = f32(moe_cfg(8))
    fb, ft = MOE_BATCH
    paths = {}
    for name, attention in (("kernels", None),
                            ("plain", ra.reference_attention),
                            ("f64", attention_f64)):
        paths[name] = moe_steps(full, fb, ft, attention=attention)
        torch.cuda.empty_cache()
    layers = full.n_layers * MOE_EP_STEPS
    kern = paths["kernels"]
    want = causal_only(flash_attn_fwd_f32=2 * layers,
                       flash_attn_bwd_f32=layers)
    rule = f32_steps_rule(kern["losses"], paths["plain"]["losses"],
                          paths["f64"]["losses"])
    if kern["launches"] != want or not rule["ok"] or \
            not all(r <= F32_LOSS_RTOL for r in rule["kernels_vs_plain"]):
        raise AssertionError(f"moe_f32 full width: {rule} (each step within "
                             f"{F32_LOSS_RTOL} of plain f32 too), launches "
                             f"{kern['launches']}, want {want}")
    for key, count in kern["launches"].items():
        total[key] += count
    say("moe_f32", config="MoEConfig(), compute_dtype f32", ok=True, batch=b,
        seq=t, head_dim=cfg.head_dim, shape=list(logits_shape),
        aux=aux, loss=loss, plain_f32_loss=plain_loss,
        step_losses=steps, rel=rel, layer_gate=gate,
        full_width={"config": "chip_bench.MOE_WIDTHS, compute_dtype f32",
                    "batch": fb, "seq": ft, "n_layers": full.n_layers,
                    "head_dim": full.head_dim, "launches": kern["launches"],
                    "losses": {p: paths[p]["losses"] for p in paths},
                    "step_rule": rule,
                    "rule": f"f32_steps_rule, and every step within "
                    f"{F32_LOSS_RTOL} of plain f32",
                    "step_ms": {p: paths[p]["step_ms"] for p in paths}})
    return total

def moe_steps(cfg: moe.MoEConfig, batch: int, seq: int, mesh=None,
              device="cuda", attention=None) -> dict:
    """MOE_EP_STEPS train steps from the params of seed 0 (each rank its
    shards) on the global batch of seed 1, with ``attention`` (default
    the ring through the kernels), every counter set to 0 just before and
    read just after: each step's loss, read at once (the host clock
    between reads is the step time), the peak memory and the wall
    seconds of the steps."""
    params, opt_state = moe.init_train_state(
        torch.Generator(device).manual_seed(0), cfg, mesh=mesh)
    tokens = moe.synthetic_batch(torch.Generator(device).manual_seed(1), cfg,
                                 batch, seq, device)
    step = moe.make_train_step(cfg, mesh, device=device, attention=attention)
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    losses, ends = [], [time.perf_counter()]
    zero_counters()
    for _ in range(MOE_EP_STEPS):
        params, opt_state, loss = step(params, opt_state, tokens)
        losses.append(float(loss))
        ends.append(time.perf_counter())
    launches = counters()
    return {"losses": losses, "launches": launches,
            "step_ms": [(b - a) * 1e3 for a, b in zip(ends, ends[1:])],
            "seconds": ends[-1] - ends[0],
            "peak_memory_gb": (torch.cuda.max_memory_allocated() / 1e9
                               if device == "cuda" else None)}


def f32(cfg: moe.MoEConfig) -> moe.MoEConfig:
    """``cfg`` in f32 compute: the witness of an ep run."""
    return dataclasses.replace(cfg, compute_dtype=torch.float32)


def moe_ep_rank(run: dict, device="cuda") -> dict:
    """One rank of a moe_ep run (``run``: dp, ep, sp, tp, n_layers,
    batch, seq) in a process group of ``dp * ep * sp * tp`` ranks:
    MOE_EP_STEPS bf16 train steps over the mesh through the kernels
    (counted), the same steps in f32 with the ring's plain version
    (``ring_attention.gathered_attention``, the witness), the f32 steps
    through the ring (:func:`mesh_f32_ring`), then the time of one
    layer's expert exchange (to the experts and back, on bf16 [E, C, d]
    buffers) by CUDA events."""
    cfg = moe_cfg(run["n_layers"])
    mesh = moe.make_moe_mesh(device_type=device, dp=run["dp"], ep=run["ep"],
                             sp=run["sp"], tp=run["tp"])
    out = moe_steps(cfg, run["batch"], run["seq"], mesh, device)
    torch.cuda.empty_cache()
    ring = ra.ring_of(mesh)
    witness = moe_steps(f32(cfg), run["batch"], run["seq"], mesh, device,
                        lambda q, k, v: ra.gathered_attention(q, k, v, ring))
    torch.cuda.empty_cache()
    out.update(mesh_f32_ring(moe_steps, f32(cfg), run, mesh, device))
    em = moe.expert_mesh(mesh)
    c = chip_bench.moe_flops(cfg, run["batch"], run["seq"])["capacity"]
    buf = torch.randn((cfg.n_experts, c, cfg.d_model), device=device,
                      generator=torch.Generator(device).manual_seed(2)).to(
                          cfg.compute_dtype)
    exchange_ms = time_ms(
        lambda: moe.from_experts(moe.to_experts(buf, em), em), 10)
    return {"rank": dist.get_rank(), "coordinate": dict(zip(
        mesh.mesh_dim_names, mesh.get_coordinate())), **out,
        "f32_losses": witness["losses"], "f32_seconds": witness["seconds"],
        "exchange_ms": exchange_ms,
        "exchange_bytes": buf.numel() * buf.element_size()}


def moe_ep_runs(cards: int) -> list:
    """The moe_ep runs a host of ``cards`` takes: ep = 2 at full depth,
    B4 T2048; with four cards also ep = 2 x sp = 2, dp = 2 x ep = 2 and
    ep = 2 x tp = 2 at 2 layers."""
    one = dict(dp=1, ep=2, sp=1, tp=1, batch=4, seq=2048)
    runs = [dict(one, name="ep2", n_layers=8)]
    if cards >= 4:
        runs += [dict(one, name="ep2sp2", sp=2, n_layers=2),
                 dict(one, name="dp2ep2", dp=2, n_layers=2),
                 dict(one, name="ep2tp2", tp=2, n_layers=2)]
    return runs


def check_published(name: str, widths: dict, train_layers: int,
                    peak: float, known: bool) -> dict:
    """The LM at a published model's widths (``widths``: PHI3, head dim
    96 on the kernels' W-128 instances with columns 96-127 zero; GPTJ,
    head dim 256 on the W-256 instances), random weights from a seed,
    through the entry points a user calls. Serving: ``lm.make_forward`` at
    full depth, bf16 params, PUBLISHED_BATCH, counted (one causal launch a
    layer); its logits no further from the f32 forward than the plain
    bf16 forward is (``perf/gates.drift``); forward ms, tokens/s, MFU,
    peak memory. Training at ``train_layers`` (the depth cut): every
    gradient of the kernel path under the same rule against an f32
    plain-attention step, then ``lm.make_train_step`` (f32 master, AdamW)
    for PUBLISHED_STEPS steps on one batch, the first counted (2 x layers
    forward and layers backward launches), the loss falling; step ms,
    tokens/s, MFU, peak memory. Says ``<name>_forward`` and
    ``<name>_train``; returns the launches of the counted forward and
    step."""
    b, t = PUBLISHED_BATCH
    cfg = lm.LMConfig(**widths, param_dtype=torch.bfloat16,
                      attn_impl="flash")
    case = chip_bench.BenchCase(f"{name}-t2k", cfg.d_model, cfg.n_layers,
                                cfg.n_heads, cfg.d_ff, cfg.vocab, b, t)
    params = lm.init_params(torch.Generator("cuda").manual_seed(0), cfg)
    tokens = lm.synthetic_batch(torch.Generator("cuda").manual_seed(1), cfg,
                                b, t)[:, :-1]
    forward = lm.make_forward(cfg)
    local = lm.make_forward(dataclasses.replace(cfg, attn_impl="local"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counters()
    logits = forward(params, tokens)
    torch.cuda.synchronize()
    fwd_launches = counters()
    fwd_peak = torch.cuda.max_memory_allocated() / 1e9
    if fwd_launches != causal_only(flash_attn_fwd=cfg.n_layers) \
            or logits.shape != (b, t, cfg.vocab) \
            or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{name} forward: {tuple(logits.shape)}, "
                             f"launches {fwd_launches}")
    plain = local(params, tokens)
    exact = lm.make_forward(dataclasses.replace(
        cfg, attn_impl="local", compute_dtype=torch.float32))(params, tokens)
    errs = {"max_abs_vs_plain": float((logits - plain).abs().max()),
            **drift(logits, plain, exact)}
    del plain, exact, logits
    if not errs.pop("ok"):
        raise AssertionError(f"{name} forward drifts: {errs}")
    ms = time_ms(lambda: forward(params, tokens), 5)
    plain_ms = time_ms(lambda: local(params, tokens), 2, 1)
    ntok = b * t
    flops = chip_bench.forward_flops_per_token(case) * ntok
    say(f"{name}_forward", ok=True, batch=b, seq=t, **widths,
        head_dim=cfg.head_dim, params=chip_bench.matmul_params(case),
        flash_launches=fwd_launches["flash_attn_fwd"], forward_ms=ms,
        plain_attention_forward_ms=plain_ms,
        tokens_per_s=ntok / (ms * 1e-3), mfu=flops / (ms * 1e-3) / peak,
        peak_known=known, forward_bound_ms=flops / peak * 1e3,
        peak_memory_gb=fwd_peak, **errs)
    del params, forward, local
    torch.cuda.empty_cache()

    cfg = dataclasses.replace(cfg, n_layers=train_layers)
    case = dataclasses.replace(case, n_layers=train_layers)
    params = lm.init_params(torch.Generator("cuda").manual_seed(0), cfg)
    batch = lm.synthetic_batch(torch.Generator("cuda").manual_seed(1), cfg,
                               b, t)
    grads = {"kernel": lm.loss_and_grads(params, batch, cfg)[1],
             "plain": lm.loss_and_grads(params, batch, dataclasses.replace(
                 cfg, attn_impl="local"))[1]}
    params = lm._tree_map(lambda p: p.float(), params)
    grads["f32"] = lm.loss_and_grads(params, batch, dataclasses.replace(
        cfg, attn_impl="local", param_dtype=torch.float32,
        compute_dtype=torch.float32))[1]
    del params
    worst = {}
    for path, g_k, g_p, g_32 in zip(
            _paths(grads["kernel"]), *(lm._leaves(grads[p])
                                       for p in ("kernel", "plain", "f32"))):
        row = drift(g_k, g_p, g_32)
        if not (row["ok"] and bool(torch.isfinite(g_k).all())):
            raise AssertionError(f"{name} gradient {path} drifts: {row}")
        worst[path] = _ratio(row)
    del grads
    torch.cuda.empty_cache()
    params, opt_state = lm.init_train_state(
        torch.Generator("cuda").manual_seed(0), cfg)
    step = lm.make_train_step(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counters()
    params, opt_state, loss = step(params, opt_state, batch)
    torch.cuda.synchronize()
    train_launches = counters()
    want = causal_only(flash_attn_fwd=2 * cfg.n_layers,
                       flash_attn_bwd=cfg.n_layers)
    if train_launches != want:
        raise AssertionError(f"{name} train step launches {train_launches}, "
                             f"want {want}")
    losses = [loss]
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(1, PUBLISHED_STEPS):
        params, opt_state, loss = step(params, opt_state, batch)
        losses.append(loss)
    end.record()
    end.synchronize()
    step_ms = start.elapsed_time(end) / (PUBLISHED_STEPS - 1)
    losses = [float(x) for x in losses]
    if not (all(map(math.isfinite, losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"{name}: loss does not fall: {losses}")
    flops = chip_bench.train_flops_per_token(case) * ntok
    say(f"{name}_train", ok=True, batch=b, seq=t,
        **dict(widths, n_layers=cfg.n_layers),
        cut=f"depth {widths['n_layers']} -> {cfg.n_layers}",
        params=chip_bench.matmul_params(case),
        launches_per_step=train_launches, losses=losses, step_ms=step_ms,
        step_timed=f"steps 2-{PUBLISHED_STEPS}, CUDA events",
        tokens_per_s=ntok / (step_ms * 1e-3),
        mfu=flops / (step_ms * 1e-3) / peak, peak_known=known,
        train_bound_ms=flops / peak * 1e3,
        peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
        grads_max_dev_over_plain=max(worst.values()),
        grads_worst_leaf=max(worst, key=worst.get))
    del params, opt_state, step, batch
    torch.cuda.empty_cache()
    return {k: fwd_launches[k] + train_launches[k] for k in fwd_launches}


def check_gptj_f32(peak: float, known: bool) -> dict:
    """The LM at GPT-J-6B's widths (GPTJ, head dim 256) in f32 params and
    compute at PUBLISHED_BATCH on one card, through the wide kernels' f32
    instances (an f32 head dim of 256 is wider than one f32 tile).
    Serving: ``lm.make_forward`` at full depth, counted (one wide f32
    causal launch a layer), its loss within F32_LOSS_RTOL of the same
    forward with ``attn_impl="local"``. Training at GPTJ_TRAIN_LAYERS:
    LM_SP_STEPS train steps (:func:`timed_steps`, counted: 2 x layers
    wide f32 forward and layers backward launches) against the same steps
    with plain f32 attention and with plain attention in f64 under
    :func:`f32_steps_rule`. Forward and step ms, tokens/s, MFU against
    the bf16 peak, peak memory. Returns the launches of the counted
    runs."""
    b, t = PUBLISHED_BATCH
    cfg = lm.LMConfig(**GPTJ, param_dtype=torch.float32,
                      compute_dtype=torch.float32)
    case = chip_bench.BenchCase("gptj-f32-t2k", cfg.d_model, cfg.n_layers,
                                cfg.n_heads, cfg.d_ff, cfg.vocab, b, t)
    params = lm.init_params(torch.Generator("cuda").manual_seed(0), cfg)
    batch = lm.synthetic_batch(torch.Generator("cuda").manual_seed(1), cfg,
                               b, t)
    tokens = batch[:, :-1]
    forward = lm.make_forward(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counters()
    logits = forward(params, tokens)
    torch.cuda.synchronize()
    fwd_launches = counters()
    fwd_peak = torch.cuda.max_memory_allocated() / 1e9
    want = causal_only(flash_attn_fwd_wide_f32=cfg.n_layers)
    if fwd_launches != want or logits.shape != (b, t, cfg.vocab) \
            or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"gptj_f32 forward: {tuple(logits.shape)}, "
                             f"launches {fwd_launches}, want {want}")
    del logits
    with torch.inference_mode():
        losses = {impl: float(lm.loss_fn(params, batch, dataclasses.replace(
            cfg, attn_impl=impl))) for impl in ("ring", "local")}
    rel = abs(losses["ring"] - losses["local"]) / abs(losses["local"])
    if not rel <= F32_LOSS_RTOL:
        raise AssertionError(f"gptj_f32 forward losses {losses}")
    ms = time_ms(lambda: forward(params, tokens), 3, 1)
    ntok = b * t
    flops = chip_bench.forward_flops_per_token(case) * ntok
    say("gptj_f32_forward", ok=True, batch=b, seq=t, **GPTJ,
        head_dim=cfg.head_dim, param_dtype="f32", compute_dtype="f32",
        tf32=torch.backends.cuda.matmul.allow_tf32,
        params=chip_bench.matmul_params(case), launches=fwd_launches,
        losses=losses, rel=rel, forward_ms=ms,
        tokens_per_s=ntok / (ms * 1e-3), mfu=flops / (ms * 1e-3) / peak,
        mfu_peak="dense bf16 tensor-core peak", peak_known=known,
        peak_memory_gb=fwd_peak)
    del params, forward
    torch.cuda.empty_cache()

    cfg = dataclasses.replace(cfg, n_layers=GPTJ_TRAIN_LAYERS)
    case = dataclasses.replace(case, n_layers=cfg.n_layers)
    steps = {"kernels": timed_steps(cfg, b, t)}
    torch.cuda.empty_cache()
    for name, attention in (("plain", None), ("f64", attention_f64)):
        steps[name] = timed_steps(
            dataclasses.replace(cfg, attn_impl="local") if name == "plain"
            else cfg, b, t, attention=attention)
        torch.cuda.empty_cache()
    layers = cfg.n_layers * LM_SP_STEPS
    want = causal_only(flash_attn_fwd_wide_f32=2 * layers,
                       flash_attn_bwd_wide_f32=layers)
    kern = steps["kernels"]
    rule = f32_steps_rule(kern["losses"], steps["plain"]["losses"],
                          steps["f64"]["losses"])
    if kern["launches"] != want or not rule["ok"]:
        raise AssertionError(f"gptj_f32 steps: {rule}, launches "
                             f"{kern['launches']}, want {want}")
    step_ms = sum(kern["step_ms"][1:]) / (LM_SP_STEPS - 1)
    flops = chip_bench.train_flops_per_token(case) * ntok
    say("gptj_f32_train", ok=True, batch=b, seq=t,
        **dict(GPTJ, n_layers=cfg.n_layers),
        cut=f"depth {GPTJ['n_layers']} -> {cfg.n_layers}",
        params=chip_bench.matmul_params(case),
        launches_per_3_steps=kern["launches"], losses=kern["losses"],
        local_losses=steps["plain"]["losses"],
        f64_attention_losses=steps["f64"]["losses"], step_rule=rule,
        step_ms=step_ms,
        step_timed=f"steps 2-{LM_SP_STEPS}, host clock to each loss's read",
        local_step_ms=sum(steps["plain"]["step_ms"][1:]) / (LM_SP_STEPS - 1),
        tokens_per_s=ntok / (step_ms * 1e-3),
        mfu=flops / (step_ms * 1e-3) / peak, peak_known=known,
        peak_memory_gb=kern["peak_memory_gb"],
        local_peak_memory_gb=steps["plain"]["peak_memory_gb"])
    return {k: fwd_launches[k] + kern["launches"][k] for k in fwd_launches}


def check_moe_ep(peak: float, known: bool, failed: list) -> dict:
    """With two cards or more, the full-width MoE expert-parallel over
    NCCL (:func:`moe_ep_runs`, rank processes of :func:`moe_ep_rank`),
    counted on every rank: a bf16 step makes 2 x layers ring forwards and
    layers ring backwards, the rank at sp index i launching i + 1 blocks
    each (i of them non-causal). Its losses the same on every rank and
    held by :func:`mesh_gate` against one card's steps (seeds 0 and 1)
    through the kernels, with plain attention in bf16 and with plain
    attention in f32 (and in f64, for the f32 reading); beside it the f32
    steps through the real ring, counted, within RING_F32_RTOL of one
    card's f32 steps through the kernels at the first RING_F32_STEPS
    steps and within :func:`f32_steps_rule` at every step
    (:func:`f32_ring_reading`). Step ms and tokens/s per card,
    peak memory per card, each rank's exchange time per layer, and the
    seconds of the f32 steps. A run whose losses miss is reported and
    added to ``failed``; a wrong launch count raises at once. With one
    card, a line that says it was not run. Returns the launches over all
    ranks."""
    total = dict.fromkeys(counters(), 0)
    cards = torch.cuda.device_count()
    if cards < 2:
        say("moe_ep", skipped="one card")
        return total
    ones = {}
    for run in moe_ep_runs(cards):
        cfg = moe_cfg(run["n_layers"])
        if run["n_layers"] not in ones:
            ones[run["n_layers"]] = {}
            for path, c, attention in (
                    ("bf16", cfg, None),
                    ("plain", cfg, ra.reference_attention),
                    ("f32", f32(cfg), ra.reference_attention),
                    ("f32_kernels", f32(cfg), None),
                    ("f64", f32(cfg), attention_f64)):
                ones[run["n_layers"]][path] = moe_steps(
                    c, run["batch"], run["seq"], attention=attention)
                torch.cuda.empty_cache()
        paths = ones[run["n_layers"]]
        one, exact = paths["bf16"], paths["f32"]
        world = run["dp"] * run["ep"] * run["sp"] * run["tp"]
        ranks = run_mesh("moe_ep_rank", run, world)
        for out in ranks:
            i, layers = out["coordinate"]["sp"], cfg.n_layers * MOE_EP_STEPS
            want = causal_only(
                flash_attn_fwd=2 * layers, flash_attn_bwd=layers,
                flash_attn_fwd_non_causal=2 * layers * i,
                flash_attn_bwd_non_causal=layers * i)
            if out["launches"] != want:
                raise AssertionError(f"moe_ep {run['name']} rank "
                                     f"{out['rank']}: launches "
                                     f"{out['launches']}, want {want}")
            for key, count in out["launches"].items():
                total[key] += count
        losses = {"bf16": ranks[0]["losses"], "f32": ranks[0]["f32_losses"]}
        gate = mesh_gate(losses, {p: paths[p]["losses"] for p in paths})
        ring = f32_ring_reading(ranks, paths, cfg.n_layers * MOE_EP_STEPS)
        for out in ranks:
            for key, count in out["f32_ring_launches"].items():
                total[key] += count
        ok = gate["ok"] and ring["ok"] and all(
            out["losses"] == losses["bf16"]
            and out["f32_losses"] == losses["f32"] for out in ranks)
        if not ok:
            failed.append(f"moe_ep {run['name']}: {losses}, gate {gate}, "
                          f"f32 ring {ring}")
        ms = max(sum(out["step_ms"][1:]) / (MOE_EP_STEPS - 1)
                 for out in ranks)
        one_ms = sum(one["step_ms"][1:]) / (MOE_EP_STEPS - 1)
        ntok = run["batch"] * run["seq"]
        flops = chip_bench.moe_flops(cfg, run["batch"], run["seq"])
        model, executed = 3 * flops["model"], 3 * flops["executed"]
        say("moe_ep", ok=ok, **run, cards=world, losses=losses["bf16"],
            f32_losses=losses["f32"],
            one_card_losses={p: paths[p]["losses"] for p in paths},
            gate=gate, f32_ring=ring,
            f32_seconds=max(out["f32_seconds"] for out in ranks),
            one_card_f32_seconds=exact["seconds"],
            step_ms=ms, one_card_step_ms=one_ms,
            step_timed=f"steps 2-{MOE_EP_STEPS}, host clock to each loss's "
            "read, slowest rank",
            tokens_per_s_per_card=ntok / (ms * 1e-3) / world,
            one_card_tokens_per_s=ntok / (one_ms * 1e-3),
            mfu_per_card=model / (ms * 1e-3) / world / peak,
            one_card_mfu=model / (one_ms * 1e-3) / peak,
            exec_share_of_peak_per_card=executed / (ms * 1e-3) / world
            / peak,
            one_card_exec_share_of_peak=executed / (one_ms * 1e-3) / peak,
            peak_known=known,
            one_card_peak_memory_gb=one["peak_memory_gb"],
            ranks=[{k: out[k] for k in (
                "rank", "coordinate", "step_ms", "peak_memory_gb",
                "launches", "exchange_ms", "exchange_bytes", "f32_seconds")}
                for out in ranks])
        torch.cuda.empty_cache()
    return total


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    name = torch.cuda.get_device_name(0)
    peak, known = chip_bench.peak_flops_for(name)
    # A reference states its f32 precision: full f32, no TF32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say("device", name=name, nvidia_smi=smi, count=torch.cuda.device_count(),
        torch=torch.__version__, cuda=torch.version.cuda,
        peak_bf16_tflops=peak / 1e12, peak_known=known)

    t0 = time.perf_counter()
    logs = build.build()
    ptxas = {src: [ln.strip() for ln in log.splitlines()
                   if any(w in ln for w in ("entry function", "registers",
                                            "spill"))]
             for src, log in logs.items()}
    spills = [ln for lines in ptxas.values() for ln in lines
              if re.search(r"[1-9][0-9]* bytes spill", ln)]
    wide_build = wide_build_report(logs["flash_attn_wide"])
    # The dynamic shared memory of each wide kernel at the timed head
    # dims, from the plan the library launches by.
    wide_smem = {f"{'f32' if dtype is torch.float32 else 'bf16'} D{d}": {
        k: v["smem_bytes"] for k, v in wide_plan_row(d, dtype).items()
        if "smem_bytes" in v}
        for d, dtype in ((WIDE_ATTN_SHAPE[3], torch.bfloat16),
                         (WIDE_512_ATTN_SHAPE[3], torch.bfloat16),
                         (WIDE_F32_ATTN_SHAPE[3], torch.float32))}
    say("build", ok=True, seconds=time.perf_counter() - t0, spills=spills,
        ptxas=ptxas, wide_instances=wide_build, wide_smem_bytes=wide_smem)

    node_launches = check_node()

    gen = torch.Generator(device="cuda").manual_seed(0)
    va_rows = check_vector_add(gen, name)
    check_host_path()
    # Each instance against its plain versions: causal bf16 (the LM's),
    # non-causal f32-out (the ring's blocks before their queries), causal
    # f32-out (the ring's diagonal blocks); each timed at its main shapes.
    fa_rows, bwd_rows = check_instances(
        gen, name, "flash_attn", FLASH_SHAPES, TIMED_FLASH_SHAPES, True,
        torch.bfloat16)
    ring_fwd_rows, ring_bwd_rows = check_instances(
        gen, name, "ring_kernels", RING_SHAPES, RING_TIMED_SHAPES, False,
        torch.float32)
    causal_f32_rows = check_instances(
        gen, name, "causal_f32", [CAUSAL_F32_SHAPE], [CAUSAL_F32_SHAPE], True,
        torch.float32)
    # Every instance at head dims that are no tile's width and at the
    # W-256 tile's; Phi-3-mini's and GPT-J-6B's attention timed.
    head_dim_rows = check_head_dims(gen, name)
    # The f32 instances (head dims up to 128) against an f64 plain
    # version; the 600M LM's f32 attention and ring block timed.
    f32_rows = check_attn_f32(gen, name)
    # The ring's block arithmetic at t8k on one card, at head dims 128
    # and 96, counted inside.
    loopback_launches = check_ring_loopback(gen, LOOPBACK_SHAPE,
                                            LOOPBACK_SPS)
    for key, count in check_ring_loopback(gen, LOOPBACK_D96_SHAPE,
                                          (2,)).items():
        loopback_launches[key] += count
    loopback_f32_launches = check_ring_loopback_f32(gen, LOOPBACK_SHAPE,
                                                    LOOPBACK_SPS)
    for key, count in check_ring_loopback_f32(gen, LOOPBACK_F32_D256_SHAPE,
                                              (2,)).items():
        loopback_f32_launches[key] += count
    check_entry()
    check_mnist()
    # dryrun_multichip on every card (and on three of them), then the
    # odd-factor configs on one card, counted inside.
    dryrun_launches = check_dryrun()
    for key, count in check_dryrun_odd().items():
        dryrun_launches[key] += count

    # The main path, counted: every counter to 0 just before, read after.
    cases = [chip_bench.case(c) for c in MAIN_CASES]
    base = lm.LMConfig(vocab=32768, d_model=2048, n_layers=8, n_heads=16,
                       d_ff=8192, param_dtype=torch.bfloat16,
                       attn_impl="flash")
    params = lm.init_params(torch.Generator("cuda").manual_seed(0), base)
    batches = [lm.synthetic_batch(torch.Generator("cuda").manual_seed(1), base,
                                  c.batch, c.seq)[:, :-1] for c in cases]
    torch.cuda.synchronize()
    forward = lm.make_forward(base)
    zero_counters()
    report = va.smoke_test()
    logits, per_forward = [], []
    for tokens in batches:
        before = fa.counts()["flash_attn_fwd"]
        logits.append(forward(params, tokens))
        per_forward.append(fa.counts()["flash_attn_fwd"] - before)
    torch.cuda.synchronize()
    launches = counters()
    if not report["ok"] or launches["vector_add"] != 1 \
            or launches["flash_attn_bwd"] != 0:
        raise AssertionError(f"payload smoke test: {report}, {launches}")
    if per_forward != [base.n_layers] * len(cases):
        raise AssertionError(f"flash launches per forward: {per_forward}")

    local = lm.make_forward(dataclasses.replace(base, attn_impl="local"))
    exact = lm.make_forward(dataclasses.replace(
        base, attn_impl="local", compute_dtype=torch.float32))
    for case, tokens, out in zip(cases, batches, logits):
        if out.shape != (case.batch, case.seq, base.vocab) or \
                not bool(torch.isfinite(out).all()):
            raise AssertionError(f"{case.name}: logits {tuple(out.shape)}, "
                                 f"finite={bool(torch.isfinite(out).all())}")
        plain = local(params, tokens)
        ref32 = exact(params, tokens)
        # The kernel's forward must be as close to the f32 forward as the
        # plain bf16 forward is.
        errs = {"max_abs_vs_plain": float((out - plain).abs().max()),
                **drift(out, plain, ref32)}
        del plain, ref32
        if not errs.pop("ok"):
            raise AssertionError(f"{case.name}: flash forward drifts: {errs}")
        ms = time_ms(lambda: forward(params, tokens), 10)
        plain_ms = time_ms(lambda: local(params, tokens), 3, 1)
        ntok = case.batch * case.seq
        flops = chip_bench.forward_flops_per_token(case) * ntok
        say("main_path", case=case.name, batch=case.batch, seq=case.seq,
            shape=list(out.shape), flash_launches=per_forward[0],
            forward_ms=ms, plain_attention_forward_ms=plain_ms,
            tokens_per_s=ntok / (ms * 1e-3),
            mfu=flops / (ms * 1e-3) / peak, peak_known=known,
            forward_bound_ms=flops / peak * 1e3, **errs)
        torch.cuda.empty_cache()
    say("main_path_counts", launches=launches, payload=report)
    del params, logits
    torch.cuda.empty_cache()

    # The training path, counted per step inside check_train; the train
    # bench's ring cases run at sp = 1.
    train_launches = check_train(
        base, cases + [chip_bench.case(c) for c in RING_CASES], peak, known)
    check_train_grads(base)
    check_train_loop()
    # The 600M LM in f32 compute through the f32 instances, counted inside.
    lm_f32_launches = check_lm_f32(peak, known)
    # The LM at Phi-3-mini's widths (head dim 96) and at GPT-J-6B's (head
    # dim 256), counted inside.
    phi3_launches = check_published("phi3", PHI3, PHI3_TRAIN_LAYERS, peak,
                                    known)
    gptj_launches = check_published("gptj", GPTJ, GPTJ_TRAIN_LAYERS, peak,
                                    known)
    # The LM at GPT-J-6B's widths in f32: head dim 256 on the wide
    # kernels' f32 instances, counted inside.
    gptj_f32_launches = check_gptj_f32(peak, known)

    # The TrainJob worker payload, counted inside check_trainer; then the
    # trainer's group, resume and demo paths and, with two cards, dp.
    trainer_launches = check_trainer(peak, known)
    default_lm_launches = check_trainer_default_lm()
    trainer_d96_launches = check_trainer_lm_d96()
    world_1_losses = check_trainer_group()
    check_trainer_resume()
    check_demo()
    check_trainer_dp2(world_1_losses)
    # Sequence parallelism, then fsdp and tp, over NCCL, counted on
    # every rank inside. A mesh run whose losses miss fails the smoke
    # after the kernels line, so every later phase still runs.
    mesh_failed = []
    lm_sp_launches = check_lm_sp(peak, known, mesh_failed)
    lm_fsdp_tp_launches = check_lm_fsdp_tp(peak, known, mesh_failed)
    # The MoE on one card and, with two cards or more, expert-parallel
    # over NCCL; each counted inside.
    moe_launches = check_moe(peak, known)
    moe_f32_launches = check_moe_f32()
    moe_ep_launches = check_moe_ep(peak, known, mesh_failed)
    by_path = {k: {"node": node_launches[k], "forward": launches[k],
                   "train": train_launches[k], "trainer": trainer_launches[k],
                   "trainer_default_lm": default_lm_launches[k],
                   "trainer_lm_d96": trainer_d96_launches[k],
                   "phi3": phi3_launches[k], "gptj": gptj_launches[k],
                   "gptj_f32": gptj_f32_launches[k],
                   "ring_loopback": loopback_launches[k],
                   "ring_loopback_f32": loopback_f32_launches[k],
                   "dryrun": dryrun_launches[k],
                   "lm_f32": lm_f32_launches[k],
                   "lm_sp": lm_sp_launches[k],
                   "lm_fsdp_tp": lm_fsdp_tp_launches[k],
                   "moe": moe_launches[k], "moe_f32": moe_f32_launches[k],
                   "moe_ep": moe_ep_launches[k]}
               for k in launches}

    # Last of all: the profiled phases (K1's device_us, then the f32
    # entry points' kernels one by one).
    profile_vector_add(va_rows)
    profile_f32_passes()

    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "library", "ratio_to_library", "share_of_bound",
            "host_us")
    va_keys = keys + ("library_host_us", "device_us", "library_device_us")
    kernels = [
        {"name": "vector_add", "route": "cuda",
         "source": "kubernetes_tpu_torch/csrc/vector_add.cu",
         "replaces": "kubernetes_tpu/workloads/vector_add.py:17-26",
         "at": f"n={row['n']} {row['dtype']}", **{k: row[k] for k in va_keys}}
        for row in va_rows]
    for shape, fa_row, bwd_row in zip(TIMED_FLASH_SHAPES, fa_rows, bwd_rows):
        at = "B{} H{} T{} D{} bf16".format(*shape)
        kernels += [
            {"name": "flash_attn_fwd", "route": "cuda",
             "source": "kubernetes_tpu_torch/csrc/flash_attn_fwd.cu",
             "replaces": "kubernetes_tpu/workloads/lm.py:163-239",
             "at": at, **{k: fa_row[k] for k in keys}},
            {"name": "flash_attn_bwd", "route": "cuda",
             "source": "kubernetes_tpu_torch/csrc/flash_attn_bwd.cu",
             "replaces": "kubernetes_tpu/workloads/lm.py:193-197, 232-236",
             "at": at, **{k: bwd_row[k] for k in keys}}]
    # The non-causal instances of the same kernels: the ring's blocks
    # before their queries.
    for shape, fa_row, bwd_row in zip(RING_TIMED_SHAPES, ring_fwd_rows,
                                      ring_bwd_rows):
        at = "B{} H{} T{} D{} bf16 in, f32 out, non-causal".format(*shape)
        kernels += [
            {"name": "flash_attn_fwd_non_causal", "route": "cuda",
             "source": "kubernetes_tpu_torch/csrc/flash_attn_fwd.cu",
             "replaces": "kubernetes_tpu/workloads/lm.py:163-239",
             "at": at, **{k: fa_row[k] for k in keys}},
            {"name": "flash_attn_bwd_non_causal", "route": "cuda",
             "source": "kubernetes_tpu_torch/csrc/flash_attn_bwd.cu",
             "replaces": "kubernetes_tpu/workloads/lm.py:193-197, 232-236",
             "at": at, **{k: bwd_row[k] for k in keys}}]
    # Phi-3-mini's attention: head dim 96 on the W-128 instances;
    # GPT-J-6B's: head dim 256 on the W-256 instances.
    for shape, model in ((PHI3_ATTN_SHAPE, "Phi-3-mini"),
                         (GPTJ_ATTN_SHAPE, "GPT-J-6B")):
        at = "B{} H{} T{} D{} bf16, causal".format(*shape) + f" ({model})"
        fa_row, bwd_row = head_dim_rows[shape]
        kernels += [
            {"name": "flash_attn_fwd", "route": "cuda",
             "source": "kubernetes_tpu_torch/csrc/flash_attn_fwd.cu",
             "replaces": "kubernetes_tpu/workloads/lm.py:163-239",
             "at": at, **{k: fa_row[k] for k in keys}},
            {"name": "flash_attn_bwd", "route": "cuda",
             "source": "kubernetes_tpu_torch/csrc/flash_attn_bwd.cu",
             "replaces": "kubernetes_tpu/workloads/lm.py:193-197, 232-236",
             "at": at, **{k: bwd_row[k] for k in keys}}]
    # The wide kernels (head dims over one tile): bf16 at head dim 272,
    # f32 at 256 (bound at the TF32 rate).
    for shape, suffix, extra in (
            (WIDE_ATTN_SHAPE, "", {}), (WIDE_512_ATTN_SHAPE, "", {}),
            (WIDE_F32_ATTN_SHAPE + ("f32",), "_f32", {"bound_rate": "tf32"})):
        at = "B{} H{} T{} D{} ".format(*shape[:4]) + (
            "f32" if suffix else "bf16") + ", causal"
        fa_row, bwd_row = head_dim_rows[shape]
        kernels += [
            {"name": f"flash_attn_fwd_wide{suffix}", "route": "cuda",
             "source": "kubernetes_tpu_torch/csrc/flash_attn_wide.cu",
             "replaces": "kubernetes_tpu/workloads/lm.py:163-239",
             "at": at, **extra, **{k: fa_row[k] for k in keys},
             "wide_plan": fa_row["wide_plan"]},
            {"name": f"flash_attn_bwd_wide{suffix}", "route": "cuda",
             "source": "kubernetes_tpu_torch/csrc/flash_attn_wide.cu",
             "replaces": "kubernetes_tpu/workloads/lm.py:193-197, 232-236",
             "at": at, **extra, **{k: bwd_row[k] for k in keys},
             "wide_plan": bwd_row["wide_plan"]}]
    # The causal instances with f32 outputs: the ring's diagonal blocks.
    at = "B{} H{} T{} D{} bf16 in, f32 out, causal".format(*CAUSAL_F32_SHAPE)
    kernels += [
        {"name": "flash_attn_fwd", "route": "cuda",
         "source": "kubernetes_tpu_torch/csrc/flash_attn_fwd.cu",
         "replaces": "kubernetes_tpu/workloads/lm.py:163-239",
         "at": at, **{k: causal_f32_rows[0][0][k] for k in keys}},
        {"name": "flash_attn_bwd", "route": "cuda",
         "source": "kubernetes_tpu_torch/csrc/flash_attn_bwd.cu",
         "replaces": "kubernetes_tpu/workloads/lm.py:193-197, 232-236",
         "at": at, **{k: causal_f32_rows[1][0][k] for k in keys}}]
    # The f32 instances (q, k, v in f32), bound at the TF32 rate.
    for shape, causal, fa_row, bwd_row in f32_rows:
        suffix = "" if causal else "_non_causal"
        at = "B{} H{} T{} D{} f32, ".format(*shape) + (
            "causal" if causal else "non-causal")
        kernels += [
            {"name": f"flash_attn_fwd_f32{suffix}", "route": "cuda",
             "source": "kubernetes_tpu_torch/csrc/flash_attn_fwd.cu",
             "replaces": "kubernetes_tpu/workloads/lm.py:163-239",
             "at": at, "bound_rate": "tf32",
             **{k: fa_row[k] for k in keys}},
            {"name": f"flash_attn_bwd_f32{suffix}", "route": "cuda",
             "source": "kubernetes_tpu_torch/csrc/flash_attn_bwd.cu",
             "replaces": "kubernetes_tpu/workloads/lm.py:193-197, 232-236",
             "at": at, "bound_rate": "tf32",
             **{k: bwd_row[k] for k in keys}}]
    for kern in kernels:
        kern["launches"] = sum(by_path[kern["name"]].values())
        kern["launches_by_path"] = by_path[kern["name"]]
    if not all(kern["launches"] > 0 for kern in kernels):
        raise AssertionError(f"a kernel of the main path never ran: {by_path}")
    for kern in kernels:
        if not all(math.isfinite(kern[k])
                   for k in ("ms", "plain_ms", "bound_ms", "host_us")):
            raise AssertionError(f"bad timing: {kern}")
    print(json.dumps({"kernels": kernels}))
    if mesh_failed:
        raise AssertionError(f"mesh runs missed: {mesh_failed}")
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
